"""The port's raft against the JAX package, on the CPU.

Exact equality everywhere: the actor layer's successors (Deliver,
Timeout, Crash and Recover, action by action) and host fingerprints over
the 1,390 states within four actions of the start; the codec's words and
``decode(encode(s))`` on that prefix; the twin of K11 (the fused step and
conds) against ``jax.vmap(step)`` and ``property_conds`` on every lane of
the prefix, of hazard rows made from it and of fuzzed rows, with the
overflow flag; the port's CPU engine against the JAX CPU engine on
``raft check`` to depth 6 (4,933 / 13,840) -- row log, parents, ebits,
discovered fingerprints and the re-executed ``Election Liveness`` path --
and a JAX snapshot of the depth-5 run resumed by the port to depth 6.
The JAX programs are compiled once per module.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stateright_tpu.models.raft import RaftModelCfg as JRaftModelCfg  # noqa: E402
from stateright_tpu.models.raft_compiled import RaftCompiled as JRaftCompiled  # noqa: E402
from stateright_tpu.ops.fingerprint import fingerprint as jfingerprint  # noqa: E402
from stateright_tpu_torch.actor import (  # noqa: E402
    Id, Network, Out, Timeout, is_no_op_with_timer,
)
from stateright_tpu_torch.models import raft_compiled as rc  # noqa: E402
from stateright_tpu_torch.models.raft import (  # noqa: E402
    ELECTION_TIMEOUT, LEADER, REPLICATION_TIMEOUT, RaftModelCfg,
)
from stateright_tpu_torch.ops.fingerprint import fingerprint  # noqa: E402
from stateright_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32  # noqa: E402

from .test_torch_device import raft_fuzz_rows, raft_hazard_rows  # noqa: E402

GEOMETRY = dict(capacity=1 << 15, max_frontier=1 << 8)
_CACHE = {}


def _once(key, make):
    if key not in _CACHE:
        _CACHE[key] = make()
    return _CACHE[key]


def _bfs(model, fp, depth=4):
    """Host BFS to ``depth`` actions: the states in BFS order, and per
    state its actions' reprs with each successor's fingerprint (None for
    no successor)."""
    seen = {}
    frontier = list(model.init_states())
    states = list(frontier)
    for s in frontier:
        seen[fp(s)] = s
    steps = []
    for _ in range(depth):
        nxt = []
        for s in frontier:
            actions = []
            model.actions(s, actions)
            succ = []
            for a in actions:
                ns = model.next_state(s, a)
                succ.append((repr(a), None if ns is None else fp(ns)))
                if ns is not None and fp(ns) not in seen:
                    seen[fp(ns)] = ns
                    nxt.append(ns)
            steps.append((fp(s), succ))
        states.extend(nxt)
        frontier = nxt
    return states, steps


def _port_prefix():
    return _once("port_bfs", lambda: _bfs(RaftModelCfg(3).into_model(), fingerprint))


def _prefix_rows():
    cm = RaftModelCfg(3).into_model().compiled()
    return _once("rows", lambda: np.stack([cm.encode(s) for s in _port_prefix()[0]]))


def _jax_step(rows):
    """``jax.vmap(step)`` and ``jax.vmap(property_conds)`` of ``rows``,
    padded to one batch size: (nexts, valid, flag, conds)."""
    cm = JRaftCompiled(JRaftModelCfg(3).into_model())
    fn = _once("jit", lambda: jax.jit(
        jax.vmap(lambda s: cm.step(s) + (cm.property_conds(s),))
    ))
    batch = 8192
    out = []
    for lo in range(0, rows.shape[0], batch):
        chunk = rows[lo : lo + batch]
        pad = np.zeros((batch - chunk.shape[0], rows.shape[1]), np.uint32)
        res = fn(jnp.asarray(np.concatenate([chunk, pad])))
        out.append([np.asarray(t)[: chunk.shape[0]] for t in res])
    return [np.concatenate(parts) for parts in zip(*out)]


# --- the actor layer and the host model -----------------------------------------


def test_actor_layer_matches_jax_host_model():
    """The 1,390 states within four actions of the start: every state's
    actions, in order, and each successor's host fingerprint (or no
    successor) are the JAX model's -- Timeout, Crash and Recover
    included."""
    states, steps = _port_prefix()
    assert len(states) == 1_390
    _jstates, jsteps = _bfs(JRaftModelCfg(3).into_model(), jfingerprint)
    assert steps == jsteps
    kinds = {r.split("(")[0] for _fp, succ in steps for r, _ns in succ}
    assert kinds == {"Deliver", "Timeout", "Crash", "Recover"}


def test_is_no_op_with_timer():
    """Only a handler that returns no state and renews the fired timer, and
    nothing else, is a no-op; a leader's ignored election timeout emits
    nothing, so it is a successor that consumes the timer."""
    renew = Out()
    renew.set_timer(ELECTION_TIMEOUT)
    assert is_no_op_with_timer(None, renew, ELECTION_TIMEOUT)
    assert not is_no_op_with_timer(None, renew, REPLICATION_TIMEOUT)
    assert not is_no_op_with_timer(object(), renew, ELECTION_TIMEOUT)
    assert not is_no_op_with_timer(None, Out(), ELECTION_TIMEOUT)
    more = Out()
    more.set_timer(ELECTION_TIMEOUT)
    more.send(Id(1), "x")
    assert not is_no_op_with_timer(None, more, ELECTION_TIMEOUT)
    model = RaftModelCfg(3).into_model()
    state, i = next((s, i) for s in _port_prefix()[0]
                    for i, a in enumerate(s.actor_states)
                    if a.current_role == LEADER)
    timers = list(state.timers_set)
    timers[i] = timers[i] | {ELECTION_TIMEOUT}
    state = dataclasses.replace(state, timers_set=tuple(timers))
    after = model.next_state(state, Timeout(Id(i), ELECTION_TIMEOUT))
    assert after.actor_states == state.actor_states
    assert after.network == state.network
    assert after.timers_set[i] == timers[i] - {ELECTION_TIMEOUT}


# --- the codec -----------------------------------------------------------------


def test_codec_matches_jax_on_the_prefix():
    """``encode`` gives the JAX words, and ``decode(encode(s))``
    fingerprints as ``s``, on every state of the prefix."""
    pm, jm = RaftModelCfg(3).into_model(), JRaftModelCfg(3).into_model()
    pcm, jcm = pm.compiled(), JRaftCompiled(jm)
    assert (pcm.state_width, pcm.max_actions, pcm.fp_words) == (
        jcm.state_width, jcm.max_actions, jcm.fp_words,
    ) == (rc.W, rc.A, rc.NONFP0)
    assert pcm.cache_key() == jcm.cache_key()
    assert np.array_equal(pcm.init_packed(), jcm.init_packed())
    for s, row in zip(_port_prefix()[0], _prefix_rows()):
        assert np.array_equal(row, jcm.encode(jcm.decode(row)))
        assert fingerprint(pcm.decode(row)) == fingerprint(s)
        assert jfingerprint(jcm.decode(row)) == fingerprint(s)


def test_codec_refuses_what_the_slice_does_not_port():
    with pytest.raises(ValueError, match="server_count=3"):
        RaftModelCfg(server_count=5).into_model().compiled()
    with pytest.raises(ValueError, match="max_crashes <= 1"):
        RaftModelCfg(3, max_crashes=2).into_model().compiled()
    with pytest.raises(ValueError, match="unordered_nonduplicating"):
        RaftModelCfg(3, network=Network.new_ordered()).into_model().compiled()


# --- the K11 twin ----------------------------------------------------------------


@pytest.mark.parametrize("rows_of", ["prefix", "hazard", "fuzz"])
def test_k11_twin_matches_jax(rows_of):
    """Every lane, valid or not, of the prefix, of hazard rows made from it
    (prefix_len 0 against full logs, delivered messages and buffers at
    their caps, terms at TERM_CAP, every node crashed, 24 slots with runs
    of equal codes) and of fuzzed rows: the successor words, validity,
    the overflow flag a state and the conds.  No prefix state flags; the
    hazard and fuzzed rows do."""
    rows = _prefix_rows()
    if rows_of == "hazard":
        rows = raft_hazard_rows(rows)
    elif rows_of == "fuzz":
        rows = raft_fuzz_rows(np.random.default_rng(17), 3_000)
    j_nexts, j_valid, j_flag, j_conds = _jax_step(rows)
    t = from_numpy_u32(rows, "cpu")
    nexts, valid, flags = rc.raft_lanes_plain(t, 1)
    assert np.array_equal(to_numpy_u32(nexts), j_nexts)
    assert np.array_equal(valid.numpy(), j_valid)
    assert np.array_equal((flags & valid).any(dim=1).numpy(), j_flag)
    assert np.array_equal(rc.raft_conds_plain(t).numpy(), j_conds)
    assert bool(rc.raft_step_plain(t, 1)[3]) == bool(j_flag.any())
    assert bool(j_flag.any()) == (rows_of != "prefix")


# --- the engine ----------------------------------------------------------------


def _logs(checker, path):
    checker.save_snapshot(str(path))
    with np.load(path) as snap:
        tail = int(snap["tail"])
        return {
            "rows": snap["rows"][: tail * rc.W].copy(),
            "parent": snap["parent"][:tail].copy(),
            "ebits": snap["ebits"][:tail].copy(),
        }


def _jax_run(tmp_path_factory, depth):
    def run():
        checker = JRaftModelCfg(3).into_model().checker().target_max_depth(
            depth).spawn_tpu(**GEOMETRY).join()
        path = tmp_path_factory.mktemp("jax") / "run.npz"
        return checker, _logs(checker, path), path

    return _once(("run", depth), run)


def _assert_same_run(jax_run, port, tmp_path):
    jax_checker, jax_logs, _path = jax_run
    port_logs = _logs(port, tmp_path / "port.npz")
    assert (port.unique_state_count(), port.state_count(), port.max_depth()) == (
        jax_checker.unique_state_count(), jax_checker.state_count(),
        jax_checker.max_depth(),
    )
    for k in ("rows", "parent", "ebits"):
        assert np.array_equal(port_logs[k], jax_logs[k]), k
    assert np.array_equal(
        port.discovered_fingerprints(), jax_checker.discovered_fingerprints()
    )
    jd, pd = jax_checker.discoveries(), port.discoveries()
    assert sorted(pd) == sorted(jd)
    for name in jd:
        assert [repr(a) for a in pd[name].into_actions()] == [
            repr(a) for a in jd[name].into_actions()
        ]
        assert [fingerprint(s) for s in pd[name].into_states()] == [
            jfingerprint(s) for s in jd[name].into_states()
        ]


def test_engine_matches_jax_at_depth_6(tmp_path, tmp_path_factory):
    """``spawn_gpu(device="cpu")`` against JAX ``spawn_tpu`` at
    ``target_max_depth(6)``: 4,933 / 13,840 / 6, the logs bit for bit
    (the trailing delivered/buffer words of each representative
    included), the discovered fingerprints and the ``Election Liveness``
    path, re-executed."""
    port = RaftModelCfg(3).into_model().checker().target_max_depth(6).spawn_gpu(
        device="cpu", **GEOMETRY).join()
    assert (port.unique_state_count(), port.state_count(), port.max_depth()) == (
        4_933, 13_840, 6,
    )
    assert sorted(port.discoveries()) == ["Election Liveness"]
    _assert_same_run(_jax_run(tmp_path_factory, 6), port, tmp_path)
    last = port.discoveries()["Election Liveness"].last_state()
    assert any(a.current_role == LEADER for a in last.actor_states)


def test_jax_snapshot_resumes_in_the_port(tmp_path, tmp_path_factory):
    """A JAX run to depth 5, resumed by the port to depth 6, ends where the
    JAX run to depth 6 ends."""
    partial = _jax_run(tmp_path_factory, 5)
    assert partial[0].unique_state_count() == 1_390
    resumed = RaftModelCfg(3).into_model().checker().target_max_depth(6).spawn_gpu(
        device="cpu", resume_from=str(partial[2]), **GEOMETRY).join()
    _assert_same_run(_jax_run(tmp_path_factory, 6), resumed, tmp_path)


@pytest.mark.slow
def test_jax_raft_check_count_is_the_cards():
    """The JAX engine's own ``raft check`` (depth 12) at the card run's
    arguments and ``dedup_factor=1``: 12,630,223 unique / 38,569,420
    states, the count ``chip_smoke.py`` phase 20 and
    ``test_cuda_raft_check_golden`` pin the port to.  A full-size run
    (about three minutes and 7.5 GB on a CPU), so out of the tier."""
    checker = JRaftModelCfg(server_count=3).into_model().checker().target_max_depth(
        12).spawn_tpu(
        capacity=1 << 25, log_capacity=14_000_000, max_frontier=1 << 16,
        dedup_factor=1, device=jax.devices("cpu")[0],
    ).join()
    assert (checker.unique_state_count(), checker.state_count(),
            checker.max_depth()) == (12_630_223, 38_569_420, 12)
    assert sorted(checker.discoveries()) == [
        "Election Liveness", "Election Safety", "Log Liveness",
    ]
