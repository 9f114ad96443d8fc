"""The port's GPU wavefront checker against the JAX engine, on the CPU.

Both engines run the same model at the same geometry; the port runs its
plain-torch twins (``device="cpu"``), the JAX engine runs on the CPU
backend.  Their ``save_snapshot`` npz files must agree bit for bit on the
committed row log, parents and eventually-bits, and the counts, depth,
discovered fingerprints, discovery names and discovery paths must be equal.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import stateright_tpu as jax_pkg  # noqa: E402
import stateright_tpu_torch as port_pkg  # noqa: E402
from stateright_tpu.models.twophase import TwoPhaseSys as JaxTwoPhaseSys  # noqa: E402
from stateright_tpu.parallel.compiled import CompiledModel as JaxCompiledModel  # noqa: E402
from stateright_tpu_torch.models.twophase import TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.parallel.compiled import CompiledModel  # noqa: E402
from stateright_tpu_torch.parallel import wavefront  # noqa: E402
from stateright_tpu_torch.parallel.wavefront import carry_from_snapshot  # noqa: E402

GOLDEN = {3: (288, 1146, 11), 4: (1568, 8258, 14), 5: (8832, 58146, 17)}
GEOMETRY = dict(capacity=1 << 14, max_frontier=1 << 9)

_JAX_RUNS = {}


def _jax_run(rm, tmp_path_factory, builder=lambda b: b, **kw):
    """One JAX engine run per configuration per test module, with its
    snapshot's logs."""
    key = (rm, builder.__name__, tuple(sorted(kw.items())))
    if key not in _JAX_RUNS:
        checker = builder(JaxTwoPhaseSys(rm_count=rm).checker()).spawn_tpu(**kw).join()
        path = tmp_path_factory.mktemp("jax") / "run.npz"
        checker.save_snapshot(str(path))
        _JAX_RUNS[key] = (checker, _logs(path))
    return _JAX_RUNS[key]


def _logs(path, w=2):
    with np.load(path) as snap:
        tail = int(snap["tail"])
        return {
            "rows": snap["rows"][: tail * w].copy(),
            "parent": snap["parent"][:tail].copy(),
            "ebits": snap["ebits"][:tail].copy(),
            "tail": tail,
        }


def _port_logs(checker, tmp_path, name="port.npz", w=2):
    path = tmp_path / name
    checker.save_snapshot(str(path))
    return _logs(path, w)


class _Jumper:
    """A counter that climbs 0..6, or jumps from 2 to a dead end at 100:
    the dead end is a terminal state that never reached six, so the
    eventually property gets a counterexample and the ebits are live."""

    def init_states(self):
        return [0]

    def actions(self, s, out):
        if s < 6:
            out.append("inc")
        if s == 2:
            out.append("jump")

    def next_state(self, s, action):
        return s + 1 if action == "inc" else 100

    def _properties(self, pkg):
        return [
            pkg.Property.always("bounded", lambda _m, s: s <= 100),
            pkg.Property.eventually("reaches six", lambda _m, s: s == 6),
            pkg.Property.sometimes("jumped", lambda _m, s: s == 100),
        ]


class JaxJumper(_Jumper, jax_pkg.Model):
    def properties(self):
        return self._properties(jax_pkg)

    def compiled(self):
        model = self

        class Compiled(JaxCompiledModel):
            state_width, max_actions = 1, 2

            def __init__(self):
                self.model = model

            def encode(self, s):
                return np.array([s], np.uint32)

            def decode(self, words):
                return int(words[0])

            def step(self, state):
                x = state[0]
                nexts = jnp.stack([x + 1, jnp.uint32(100)])[:, None]
                return nexts, jnp.stack([x < 6, x == 2])

            def property_conds(self, state):
                x = state[0]
                return jnp.stack([x <= 100, x == 6, x == 100])

        return Compiled()


class PortJumper(_Jumper, port_pkg.Model):
    def properties(self):
        return self._properties(port_pkg)

    def compiled(self):
        model = self

        class Compiled(CompiledModel):
            state_width, max_actions = 1, 2

            def __init__(self):
                self.model = model

            def encode(self, s):
                return np.array([s], np.uint32)

            def decode(self, words):
                return int(words[0])

            def step(self, states):
                x = states[:, 0]
                nexts = torch.stack([x + 1, torch.full_like(x, 100)], 1)
                return nexts[:, :, None], torch.stack([x < 6, x == 2], 1)

            def property_conds(self, states):
                x = states[:, 0]
                return torch.stack([x <= 100, x == 6, x == 100], 1)

        return Compiled()


def _assert_same_run(jax_checker, jax_logs, port, port_logs):
    assert (port.unique_state_count(), port.state_count(), port.max_depth()) == (
        jax_checker.unique_state_count(),
        jax_checker.state_count(),
        jax_checker.max_depth(),
    )
    assert port_logs["tail"] == jax_logs["tail"]
    for k in ("rows", "parent", "ebits"):
        assert np.array_equal(port_logs[k], jax_logs[k]), k
    assert np.array_equal(
        port.discovered_fingerprints(), jax_checker.discovered_fingerprints()
    )
    jd, pd = jax_checker.discoveries(), port.discoveries()
    assert sorted(pd) == sorted(jd)
    for name in jd:
        assert pd[name].into_actions() == jd[name].into_actions()
        assert pd[name].encode(port.model()) == jd[name].encode(jax_checker.model())


@pytest.mark.parametrize("rm", [3, 4, 5])
def test_engine_matches_jax(rm, tmp_path, tmp_path_factory):
    jax_checker, jax_logs = _jax_run(rm, tmp_path_factory, **GEOMETRY)
    port = TwoPhaseSys(rm_count=rm).checker().spawn_gpu(device="cpu", **GEOMETRY).join()
    assert (port.unique_state_count(), port.state_count(), port.max_depth()) == GOLDEN[rm]
    _assert_same_run(jax_checker, jax_logs, port, _port_logs(port, tmp_path))
    port.assert_properties()


def test_eventually_bits_and_counterexample_match_jax(tmp_path, tmp_path_factory):
    """A model with an eventually property: the ebits in the log are live,
    and the dead end's eventually counterexample (found at a terminal
    state) has the same path in both engines."""
    jax_checker = JaxJumper().checker().spawn_tpu(capacity=1 << 6, max_frontier=1 << 2).join()
    path = tmp_path_factory.mktemp("jax") / "jumper.npz"
    jax_checker.save_snapshot(str(path))
    jax_logs = _logs(path, w=1)
    port = PortJumper().checker().spawn_gpu(
        device="cpu", capacity=1 << 6, max_frontier=1 << 2
    ).join()
    assert sorted(port.discoveries()) == ["jumped", "reaches six"]
    assert port.discoveries()["reaches six"].into_actions() == ["inc", "inc", "jump"]
    assert jax_logs["ebits"].any()
    _assert_same_run(jax_checker, jax_logs, port, _port_logs(port, tmp_path, w=1))


def test_growth_of_table_log_and_buffer_keeps_logs_bit_equal(tmp_path, tmp_path_factory):
    """A tiny table and log and a chunk of 2,048 states on 2pc rm=6 at the
    default dedup_factor: the run trips flag 1 (table), 2 (log) and 4
    (compaction buffer, past its 16K floor), falls back to the sorted
    dedup path at the first flag 4 (``sortless=0``, new states appended in
    sorted-key order from then on), expands levels wider than a chunk,
    grows in place each time -- and writes the log the JAX engine writes
    at the same arguments."""
    geometry = dict(capacity=1 << 8, log_capacity=1 << 7, max_frontier=1 << 11)
    jax_checker, jax_logs = _jax_run(6, tmp_path_factory, **geometry)
    port = TwoPhaseSys(rm_count=6).checker().spawn_gpu(device="cpu", **geometry).join()
    seen = 0
    for flags in port._grow_flags:
        seen |= flags
    assert seen == 1 | 2 | 4
    assert any("sortless=0" in note for note in port._grow_notes)
    assert not port._sortless and port._dedup_factor == 1
    assert port.waves() - len(port._grow_flags) > port.max_depth()
    assert port.unique_state_count() == 50_816
    _assert_same_run(jax_checker, jax_logs, port, _port_logs(port, tmp_path))


def test_growth_refused_at_the_table_ceiling(monkeypatch):
    monkeypatch.setattr(wavefront, "_MAX_TABLE_CAPACITY", 1 << 8)
    port = TwoPhaseSys(rm_count=4).checker().spawn_gpu(
        device="cpu", capacity=1 << 8, max_frontier=1 << 4
    )
    with pytest.raises(RuntimeError, match="table overfull"):
        port.join()


def test_target_max_depth_matches_jax(tmp_path, tmp_path_factory):
    def depth7(b):
        return b.target_max_depth(7)

    jax_checker, jax_logs = _jax_run(
        4, tmp_path_factory, depth7, capacity=1 << 12, max_frontier=1 << 4
    )
    port = depth7(TwoPhaseSys(rm_count=4).checker()).spawn_gpu(
        device="cpu", capacity=1 << 12, max_frontier=1 << 4
    ).join()
    assert port.max_depth() == 7 and port.unique_state_count() < 1568
    _assert_same_run(jax_checker, jax_logs, port, _port_logs(port, tmp_path))


def test_resume_from_jax_snapshot_finishes_like_a_straight_jax_run(
    tmp_path, tmp_path_factory
):
    """The run state carried across: a JAX run stopped by
    target_state_count(3000), resumed by the port, ends where an
    uninterrupted JAX run ends."""
    geometry = dict(capacity=1 << 15, max_frontier=1 << 7)
    partial = (
        JaxTwoPhaseSys(rm_count=5).checker().target_state_count(3000)
        .spawn_tpu(**geometry).join()
    )
    assert partial.unique_state_count() < 8832
    snap = tmp_path / "jax_partial.npz"
    partial.save_snapshot(str(snap))

    with np.load(snap) as arrays:
        carry = carry_from_snapshot({k: arrays[k] for k in arrays.files})
        assert carry.tail == int(arrays["tail"])
        assert carry.table.capacity == 1 << 15
        khi, klo = carry.table.planes()
        assert np.array_equal(khi, arrays["key_hi"])
        assert np.array_equal(klo, arrays["key_lo"])
        assert carry.rows.dtype == torch.int32

    resumed = TwoPhaseSys(rm_count=5).checker().spawn_gpu(
        device="cpu", resume_from=str(snap), **geometry
    ).join()
    straight, straight_logs = _jax_run(5, tmp_path_factory, **GEOMETRY)
    _assert_same_run(straight, straight_logs, resumed, _port_logs(resumed, tmp_path))
    resumed.assert_properties()
