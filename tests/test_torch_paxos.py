"""The port's paxos slice against the JAX package, on the CPU.

Bit-equal throughout: the codec's words and host fingerprints, the twins
of K5 (lane validity), K7 (successor build), K6 (conds, with the
linearizability DP) and K8 (wave verdicts) against the JAX functions on
the same inputs, and the port's CPU engine against the JAX CPU engine on
``paxos check 2`` (16,668), ``check 3`` to depth 11 (21,838), ``check 4``
to depth 7 (1,308), ``check 6`` to depth 6 (1,227) and the ``never
decided`` variant (row log, parents, ebits, counts, discoveries, paths),
plus JAX snapshots resumed by the port.  From C = 4 the layout has 64
slots and a 3-bit proposal field, which moves every server-record field
after it.  The JAX programs are compiled once per module.
"""

import random

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stateright_tpu.actor import Envelope as JEnvelope  # noqa: E402
from stateright_tpu.actor import Id as JId  # noqa: E402
from stateright_tpu.actor import Network as JNetwork  # noqa: E402
from stateright_tpu.actor.register import Get as JGet  # noqa: E402
from stateright_tpu.actor.register import Internal as JInternal  # noqa: E402
from stateright_tpu.actor.register import Put as JPut  # noqa: E402
from stateright_tpu.core.has_discoveries import HasDiscoveries as JHasDiscoveries  # noqa: E402
from stateright_tpu.core.model import Expectation as JExpectation  # noqa: E402
from stateright_tpu.core.model import Property as JProperty  # noqa: E402
from stateright_tpu.models import paxos as jpaxos  # noqa: E402
from stateright_tpu.models.paxos_compiled import PaxosCompiled as JPaxosCompiled  # noqa: E402
from stateright_tpu.parallel.wave_common import wave_eval as jax_wave_eval  # noqa: E402
from stateright_tpu_torch.actor import Network  # noqa: E402
from stateright_tpu_torch.core.has_discoveries import HasDiscoveries  # noqa: E402
from stateright_tpu_torch.core.model import Expectation, Property  # noqa: E402
from stateright_tpu_torch.models import paxos_compiled as pc  # noqa: E402
from stateright_tpu_torch.models.paxos import PaxosModelCfg  # noqa: E402
from stateright_tpu_torch.models.register_compiled_common import (  # noqa: E402
    device_linearizable_plain,
)
from stateright_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32, u32  # noqa: E402
from stateright_tpu_torch.parallel.wave_common import NO_ID, prop_kinds, wave_eval  # noqa: E402

from .test_paxos_compiled import enumerate_reachable, paxos_model  # noqa: E402
from .test_paxos_tpu import _lin_cases, lane_fn_for  # noqa: E402

GEOMETRY = dict(capacity=1 << 16, max_frontier=1 << 12)
_CACHE = {}


def _once(key, make):
    if key not in _CACHE:
        _CACHE[key] = make()
    return _CACHE[key]


def _port_model(c, never_decided=False):
    return PaxosModelCfg(
        c, 3, Network.new_unordered_nonduplicating(), never_decided=never_decided
    ).into_model()


def _jax_model(c, never_decided=False):
    return jpaxos.PaxosModelCfg(
        c, 3, JNetwork.new_unordered_nonduplicating(), never_decided=never_decided
    ).into_model()


def _jax_lanes(c, rows):
    """The JAX ``_deliver_lane`` over every slot of ``rows`` (uint32[N, W]):
    (nexts [N, M, W], valid [N, M], flags [N, M])."""
    cm = JPaxosCompiled(paxos_model(c))
    fn = _once(("lanes", c), lambda: lane_fn_for(cm))
    return tuple(np.asarray(x) for x in fn(jnp.asarray(rows)))


def _port_lanes(c, rows):
    """K5's and K7's twins over every slot of ``rows``: (nexts, valid,
    flags) shaped as :func:`_jax_lanes`'s."""
    t = from_numpy_u32(rows, "cpu")
    valid = pc.paxos_step_valid_plain(t, c).numpy()
    f, m = valid.shape
    lanes = torch.arange(f * m, dtype=torch.int32)
    nexts, flags = pc.paxos_step_lane_plain(t, lanes, f * m, c)
    return to_numpy_u32(nexts).reshape(f, m, -1), valid, flags.numpy().reshape(f, m)


def _assert_lanes_equal(c, rows):
    j_nexts, j_valid, j_flags = _jax_lanes(c, rows)
    p_nexts, p_valid, p_flags = _port_lanes(c, rows)
    assert np.array_equal(p_valid, j_valid)
    assert np.array_equal(p_flags, j_flags)
    # Every lane's words, valid or not: the twin computes what JAX does.
    assert np.array_equal(p_nexts, j_nexts)
    return j_valid, j_flags


# --- codec --------------------------------------------------------------------


def test_codec_matches_jax_over_c1_reachable():
    """Both packages' host models reach the same 265 states (equal host
    fingerprints); the port encodes each to the JAX words, and decoding
    those words gives back a state with the same fingerprint."""
    jax_reach = enumerate_reachable(paxos_model(1))
    port_model = _port_model(1)
    port_reach = {}
    frontier = port_model.init_states()
    for s in frontier:
        port_reach[port_model.fingerprint(s)] = s
    while frontier:
        nxt = []
        for s in frontier:
            for ns in port_model.next_states(s):
                fp = port_model.fingerprint(ns)
                if fp not in port_reach:
                    port_reach[fp] = ns
                    nxt.append(ns)
        frontier = nxt
    assert len(jax_reach) == 265
    assert sorted(port_reach) == sorted(jax_reach)
    jcm, pcm = JPaxosCompiled(paxos_model(1)), port_model.compiled()
    assert np.array_equal(pcm.init_packed(), jcm.init_packed())
    for fp, js in jax_reach.items():
        words = jcm.encode(js)
        assert np.array_equal(pcm.encode(port_reach[fp]), words)
        assert port_model.fingerprint(pcm.decode(words)) == fp


def test_codec_refuses_what_the_slice_does_not_port():
    with pytest.raises(ValueError, match="1 to 7 clients"):
        _port_model(8).compiled()
    model = PaxosModelCfg(
        2, 3, Network.new_unordered_nonduplicating(), max_round=16
    ).into_model()
    with pytest.raises(ValueError, match="outside 0..15"):
        model.compiled()


# --- K5 / K7 twins against _deliver_lane ----------------------------------------


def test_step_twins_match_jax_over_c1_reachable():
    jcm = JPaxosCompiled(paxos_model(1))
    rows = np.stack([jcm.encode(s) for s in enumerate_reachable(paxos_model(1)).values()])
    valid, flags = _assert_lanes_equal(1, rows.astype(np.uint32))
    assert valid.any() and not flags.any()


def test_step_twins_match_jax_over_c3_bfs_prefix(tmp_path_factory):
    """The c=3-only paths (32 slots, 2-slot snapshots, the third client)
    over the states to depth 7 -- the prefix of
    test_step_differential_bounded_c3, 1,969 states, here the first
    positions of the JAX engine's BFS log -- and K5's twin against the JAX
    ``step_valid`` as well."""
    rows = _jax_c3_depth11(tmp_path_factory)[1]["rows2d"]
    prefix = rows[:1969]
    valid, flags = _assert_lanes_equal(3, prefix)
    assert valid.sum() > 0 and not flags.any()
    jcm = JPaxosCompiled(paxos_model(3))
    j_valid = np.asarray(jax.jit(jax.vmap(jcm.step_valid))(jnp.asarray(prefix)))
    assert np.array_equal(pc.paxos_step_valid_plain(from_numpy_u32(prefix, "cpu"), 3).numpy(), j_valid)


def _overflow_row(jcm):
    """test_paxos_tpu.py::test_step_flag_overflow_is_loud's state: a Put
    whose two Prepares cannot fit in the full slot section."""
    state = np.zeros(jcm.state_width, np.uint32)
    codes = [jcm._env_code(JEnvelope(JId(3), JId(0), JPut(3, "A")))]
    for r in range(2, 16):
        for src in range(3):
            for dst in range(3):
                if src != dst and len(codes) < jcm.m:
                    codes.append(jcm._env_code(JEnvelope(
                        JId(src), JId(dst), JInternal(jpaxos.Prepare((r, JId(src))))
                    )))
    for k, code in enumerate(sorted(codes)):
        state[jcm._NET0 + k] = code
    return state


def _hazard_rows(c):
    """Hand-made rows for the u32 hazards, each on a flagged branch:

    - a Get to a decided server whose accepted code is 0: ``(0 - 1) % c``
      wraps (0xFFFFFFFF % c = 1, 0, 3, 0, 3, 3 for c = 2..7);
    - a Prepared that completes a majority with no proposal anywhere:
      ``pd_prop - 1`` wraps in the accepted code and the Accept payload;
    - an Accepted that completes a majority with no proposal: ``prop - 1``
      wraps in the Decided payload and the PutOk address, whose code
      lands at or above 2**31, so the slot re-sort must be unsigned;
    - a duplicated envelope (only its first slot is a lane) and the empty
      slots (``code - 1`` wraps on every one of them)."""
    jcm = JPaxosCompiled(paxos_model(c))
    S = 3

    def server(ballot, prepares=(), accepts=frozenset(), decided=False):
        return jpaxos.PaxosState(
            ballot=ballot, proposal=None, prepares=tuple(prepares),
            accepts=accepts, accepted=None, is_decided=decided,
        )

    def row(servers, envs):
        r = np.zeros(jcm.state_width, np.uint32)
        for i, s in enumerate(servers):
            bits = jcm._encode_server(s)
            r[2 * i], r[2 * i + 1] = bits & 0xFFFFFFFF, bits >> 32
        r[2 * S] = 0x6 | (0x6 << 4) | (0x6 << 8)  # clients awaiting a get
        codes = sorted(jcm._env_code(e) for e in envs)
        r[jcm._NET0 : jcm._NET0 + len(codes)] = codes
        return r

    idle = server((0, JId(0)))
    b0, b1 = (1, JId(0)), (1, JId(1))
    rows = [
        row([idle, server((0, JId(0)), decided=True), idle],
            [JEnvelope(JId(3), JId(1), JGet(6))]),
        row([idle, server(b1, prepares=[(JId(1), None)]), idle],
            [JEnvelope(JId(0), JId(1), JInternal(jpaxos.Prepared(b1, None)))]),
        row([server(b0, accepts=frozenset([JId(0)])), idle, idle],
            [JEnvelope(JId(2), JId(0), JInternal(jpaxos.Accepted(b0)))] * 2),
    ]
    return np.stack(rows).astype(np.uint32)


@pytest.mark.parametrize("c", [2, 3, 4, 5, 6, 7])
def test_step_twins_match_jax_on_overflow_and_wraparound_rows(c):
    jcm = JPaxosCompiled(paxos_model(c))
    rows = np.concatenate([_overflow_row(jcm)[None], _hazard_rows(c)])
    valid, flags = _assert_lanes_equal(c, rows)
    # Every hand-made lane 0 is valid and flagged; the duplicate's second
    # slot is no lane.
    assert valid[:, 0].all() and flags[:, 0].all()
    assert not valid[3, 1]
    nexts, _v, _f = _port_lanes(c, rows)
    get_v = int(nexts[1, 0, jcm._NET0]) - 1 & 0x3FFF  # the GetOk's value code
    assert get_v == 1 + (0xFFFFFFFF % c)
    putok = nexts[3, 0, jcm._NET0 : jcm._NET0 + jcm.m]
    assert (putok >= 1 << 31).any()  # sorted last, as unsigned


# --- K6 twin against device_linearizable and property_conds ----------------------


@pytest.mark.parametrize("c,limit", [(2, None), (3, 1200)])
def test_linearizable_twin_matches_jax(c, limit):
    """The exhaustive c=2 tester-state set and a c=3 sample, violations
    included: the twin equals the JAX DP, and both the host tester."""
    cm, cases = _lin_cases(c, rng=random.Random(7), limit=limit)
    rows = np.stack([s for s, _ in cases])
    want = np.array([w for _, w in cases])
    got = device_linearizable_plain(pc._codec(c), u32(from_numpy_u32(rows, "cpu"))).numpy()
    jfn = jax.jit(jax.vmap(cm._device_linearizable))
    assert np.array_equal(got, np.asarray(jfn(jnp.asarray(rows))))
    assert np.array_equal(got, want)
    assert (~want).sum() > 0


def test_conds_twin_matches_jax_property_conds(tmp_path_factory):
    """The three conds of the ``never decided`` model over the c=3 BFS log
    to depth 11: linearizable, value chosen, never decided."""
    rows = _jax_c3_depth11(tmp_path_factory)[1]["rows2d"]
    jcm = JPaxosCompiled(_jax_model(3, never_decided=True))
    want = np.asarray(jax.jit(jax.vmap(jcm.property_conds))(jnp.asarray(rows)))
    got = pc.paxos_conds_plain(from_numpy_u32(rows, "cpu"), 3, True).numpy()
    assert np.array_equal(got, want)
    assert want[:, 1].any() and not want[:, 2].all()


# --- K8 twin against wave_eval ----------------------------------------------------


class _BitsModel:
    """A JAX compiled-model stand-in whose conds and validity are the bits
    of the state's two words, so ``wave_eval`` runs on chosen inputs."""

    def __init__(self, p, a):
        self.p, self.a = p, a

    def property_conds(self, state):
        return ((state[0] >> jnp.arange(self.p, dtype=jnp.uint32)) & 1) == 1

    def step(self, state):
        valid = ((state[1] >> jnp.arange(self.a, dtype=jnp.uint32)) & 1) == 1
        return jnp.zeros((self.a, 1), jnp.uint32), valid

    def boundary(self, state):
        return None


@pytest.mark.parametrize("discovered", [0b0000, 0b0101, 0b1111])
def test_wave_eval_twin_matches_jax(discovered):
    kinds = [JExpectation.ALWAYS, JExpectation.EVENTUALLY, JExpectation.SOMETIMES,
             JExpectation.EVENTUALLY]
    props = [JProperty(k, f"p{i}", None) for i, k in enumerate(kinds)]
    ev_indices = [1, 3]
    rng = np.random.default_rng(31 + discovered)
    f, p, a = 700, 4, 9
    conds = rng.random((f, p)) < [0.98, 0.3, 0.01, 0.5]
    valid = rng.random((f, a)) < 0.15
    eb = rng.integers(0, 4, f).astype(np.uint32)
    start = 12_345
    rows = np.stack([
        (conds * (1 << np.arange(p))).sum(1), (valid * (1 << np.arange(a))).sum(1)
    ], 1).astype(np.uint32)
    disc_in = np.array(
        [start if (discovered >> q) & 1 else NO_ID for q in range(p)], np.uint32
    )
    fn = _once(("wave_eval",), lambda: jax.jit(
        lambda rows, ids, eb, disc: jax_wave_eval(
            _BitsModel(p, a), props, ev_indices, rows, jnp.ones((f,), bool),
            ids, eb, disc,
        )
    ))
    j_disc, j_eb, _n, j_valid, _g, _fl = fn(
        jnp.asarray(rows), start + jnp.arange(f, dtype=jnp.uint32),
        jnp.asarray(eb), jnp.asarray(disc_in),
    )
    port_kinds = prop_kinds(
        [Property(Expectation[k.name], f"p{i}", None) for i, k in enumerate(kinds)]
    )
    p_valid, p_eb, cands = wave_eval(
        torch.from_numpy(conds), torch.from_numpy(valid),
        from_numpy_u32(eb, "cpu"), start, port_kinds, discovered,
    )
    assert np.array_equal(p_valid.numpy(), np.asarray(j_valid))
    assert np.array_equal(to_numpy_u32(p_eb), np.asarray(j_eb))
    # JAX folds first-writer-wins into the incoming vector; the port's
    # engine does that fold on the host.
    folded = [int(d) if d != NO_ID else int(x) for d, x in zip(disc_in, cands)]
    assert folded == [int(d) for d in np.asarray(j_disc)]
    assert any(int(x) != NO_ID for x in cands)


# --- the engine -----------------------------------------------------------------


def _logs(checker, path, w):
    checker.save_snapshot(str(path))
    with np.load(path) as snap:
        tail = int(snap["tail"])
        rows = snap["rows"][: tail * w].copy()
        return {
            "rows": rows, "rows2d": rows.reshape(tail, w),
            "parent": snap["parent"][:tail].copy(),
            "ebits": snap["ebits"][:tail].copy(), "tail": tail,
        }


def _jax_run(tmp_path_factory, name, model, builder=lambda b: b, geometry=GEOMETRY):
    def run():
        checker = builder(model.checker()).spawn_tpu(**geometry).join()
        path = tmp_path_factory.mktemp("jax") / f"{name}.npz"
        w = JPaxosCompiled(model).state_width
        return checker, _logs(checker, path, w), path

    return _once(("run", name), run)


def _jax_c3_depth11(tmp_path_factory):
    return _jax_run(
        tmp_path_factory, "c3d11", paxos_model(3), lambda b: b.target_max_depth(11)
    )


def _assert_same_run(jax_run, port, tmp_path, w):
    jax_checker, jax_logs, _path = jax_run
    port_logs = _logs(port, tmp_path / "port.npz", w)
    assert (port.unique_state_count(), port.state_count(), port.max_depth()) == (
        jax_checker.unique_state_count(), jax_checker.state_count(),
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
        # Same fingerprint chain, and the same actions (each package's own
        # Deliver class, equal field for field).
        assert pd[name].encode(port.model()) == jd[name].encode(jax_checker.model())
        assert [repr(a) for a in pd[name].into_actions()] == [
            repr(a) for a in jd[name].into_actions()
        ]


def test_engine_matches_jax_on_paxos_check_2(tmp_path, tmp_path_factory):
    jax_run = _jax_run(tmp_path_factory, "c2", paxos_model(2))
    port = _port_model(2).checker().spawn_gpu(device="cpu", **GEOMETRY).join()
    assert (port.unique_state_count(), port.state_count(), port.max_depth()) == (
        16_668, 32_971, 21
    )
    assert sorted(port.discoveries()) == ["value chosen"]
    _assert_same_run(jax_run, port, tmp_path, pc.state_width(2))
    port.assert_properties()


def test_engine_matches_jax_on_paxos_check_3_to_depth_11(tmp_path, tmp_path_factory):
    port = (
        _port_model(3).checker().target_max_depth(11)
        .spawn_gpu(device="cpu", **GEOMETRY).join()
    )
    assert port.unique_state_count() == 21_838  # test_cross_engine_pin.py
    _assert_same_run(_jax_c3_depth11(tmp_path_factory), port, tmp_path, pc.state_width(3))


def test_never_decided_counterexample_and_jax_snapshot_resume(tmp_path, tmp_path_factory):
    """The violating variant under ANY_FAILURES: both engines stop at the
    same counterexample, whose re-executed path ends in a decided server.
    Then the port resumes the JAX snapshot of that stopped run (the JAX
    npz format, same engine key) and runs on to the end."""
    jax_run = _jax_run(
        tmp_path_factory, "c2nd", _jax_model(2, never_decided=True),
        lambda b: b.finish_when(JHasDiscoveries.ANY_FAILURES),
    )
    port = (
        _port_model(2, never_decided=True).checker()
        .finish_when(HasDiscoveries.ANY_FAILURES)
        .spawn_gpu(device="cpu", **GEOMETRY).join()
    )
    assert "never decided" in port.discoveries()
    final = port.discoveries()["never decided"].last_state()
    assert any(getattr(a, "is_decided", False) for a in final.actor_states)
    _assert_same_run(jax_run, port, tmp_path, pc.state_width(2))

    # Resumed without finish_when, the run expands every state (the
    # "linearizable" property is never discovered, so every state is still
    # awaited): its log must be the plain check-2 log of the JAX engine.
    resumed = _port_model(2, never_decided=True).checker().spawn_gpu(
        device="cpu", resume_from=str(jax_run[2]), **GEOMETRY
    ).join()
    plain, plain_logs, _path = _jax_run(tmp_path_factory, "c2", paxos_model(2))
    assert (resumed.unique_state_count(), resumed.state_count()) == (
        plain.unique_state_count(), plain.state_count()
    )
    logs = _logs(resumed, tmp_path / "resumed.npz", pc.state_width(2))
    for k in ("rows", "parent", "ebits"):
        assert np.array_equal(logs[k], plain_logs[k]), k
    assert sorted(resumed.discoveries()) == ["never decided", "value chosen"]


# --- C = 4..7: 64 slots, a 3-bit proposal field ---------------------------------


# Small chunks: the JAX engine evaluates a whole chunk each wave, padding
# included, and the DP at C = 6 is 896 words a state.
GEOMETRY_WIDE = dict(capacity=1 << 14, max_frontier=1 << 7)
# Depth, unique states and states of each prefix run.
_PREFIX = {4: (7, 1_308, 2_125), 6: (6, 1_227, 2_003)}


def _jax_prefix(tmp_path_factory, c):
    """The JAX engine's run of ``paxos check c`` to its prefix depth."""
    depth = _PREFIX[c][0]
    return _jax_run(
        tmp_path_factory, f"c{c}d{depth}", paxos_model(c),
        lambda b: b.target_max_depth(depth), GEOMETRY_WIDE,
    )


def _host_prefix(c, depth):
    """The JAX host model's states to ``depth`` (BFS, first discovery)."""
    model = paxos_model(c)
    seen = {model.fingerprint(s): s for s in model.init_states()}
    frontier = list(seen.values())
    for _ in range(depth):
        nxt = []
        for st in frontier:
            actions = []
            model.actions(st, actions)
            for a in actions:
                ns = model.next_state(st, a)
                if ns is not None and model.fingerprint(ns) not in seen:
                    seen[model.fingerprint(ns)] = ns
                    nxt.append(ns)
        frontier = nxt
    return seen


@pytest.mark.parametrize("c", [4, 5, 6, 7])
def test_codec_round_trip_c4_to_c7(c):
    """Init states and a host BFS prefix: the port encodes each state to
    the JAX words, and decoding them gives back a state with the JAX
    state's fingerprint, which encodes to the same words."""
    jcm = JPaxosCompiled(paxos_model(c))
    model = _port_model(c)
    pcm = model.compiled()
    assert (pcm.m, pcm.state_width, pcm.pb) == (jcm.m, jcm.state_width, jcm.pb) == (
        64, 7 + 64 + c, 3
    )
    assert np.array_equal(pcm.init_packed(), jcm.init_packed())
    for fp, js in _host_prefix(c, 3).items():
        words = jcm.encode(js)
        st = pcm.decode(words)
        assert model.fingerprint(st) == fp
        assert np.array_equal(pcm.encode(st), words)


@pytest.mark.parametrize("c", [4, 6])
def test_engine_matches_jax_past_three_clients(c, tmp_path, tmp_path_factory):
    """``paxos check 4`` to depth 7 and ``check 6`` to depth 6: the port's
    CPU engine against the JAX engine, bit for bit; every logged row
    decodes and re-encodes to itself."""
    depth, unique, states = _PREFIX[c]
    jax_run = _jax_prefix(tmp_path_factory, c)
    port = (
        _port_model(c).checker().target_max_depth(depth)
        .spawn_gpu(device="cpu", **GEOMETRY_WIDE).join()
    )
    assert (port.unique_state_count(), port.state_count()) == (unique, states)
    _assert_same_run(jax_run, port, tmp_path, pc.state_width(c))
    pcm = port.model().compiled()
    for row in jax_run[1]["rows2d"]:
        assert np.array_equal(pcm.encode(pcm.decode(row)), row)


@pytest.mark.parametrize("c", [4, 6])
def test_twins_match_jax_past_three_clients(c, tmp_path_factory):
    """K5, K7 and K6's twins on every lane of the BFS prefix of the JAX
    run: against ``_deliver_lane``, and K5's against ``step_valid`` and
    K6's against ``property_conds`` of the ``never decided`` model (one
    JAX program for both)."""
    rows = _jax_prefix(tmp_path_factory, c)[1]["rows2d"]
    valid, flags = _assert_lanes_equal(c, rows)
    assert valid.sum() > 0 and not flags.any()
    jcm = JPaxosCompiled(_jax_model(c, never_decided=True))
    t = from_numpy_u32(rows, "cpu")
    j_valid, want = (np.asarray(x) for x in jax.jit(lambda r: (
        jax.vmap(jcm.step_valid)(r), jax.vmap(jcm.property_conds)(r)
    ))(jnp.asarray(rows)))
    assert np.array_equal(pc.paxos_step_valid_plain(t, c).numpy(), j_valid)
    assert np.array_equal(pc.paxos_conds_plain(t, c, True).numpy(), want)
    assert want[:, 0].all() and not want[:, 2].all()


def test_jax_snapshot_of_paxos_check_4_resumes_in_the_port(tmp_path, tmp_path_factory):
    """The JAX snapshot of ``paxos check 4`` stopped at depth 7, resumed
    by the port one level deeper, ends where the port's straight run to
    depth 8 ends: the same logs, counts and fingerprints."""
    depth = _PREFIX[4][0] + 1
    snap = _jax_prefix(tmp_path_factory, 4)[2]
    resumed = _port_model(4).checker().target_max_depth(depth).spawn_gpu(
        device="cpu", resume_from=str(snap), **GEOMETRY_WIDE
    ).join()
    straight = _port_model(4).checker().target_max_depth(depth).spawn_gpu(
        device="cpu", **GEOMETRY_WIDE
    ).join()
    assert resumed.unique_state_count() > _PREFIX[4][1]
    w = pc.state_width(4)
    _assert_same_run((straight, _logs(straight, tmp_path / "s.npz", w), None),
                     resumed, tmp_path, w)


# --- the ballot-bounded model: single-phase through K14's twin -------------------


def _bounded(pkg_cfg, net, c, max_round):
    return pkg_cfg(c, 3, net, max_round=max_round).into_model()


def test_bounded_step_twin_matches_jax_step_and_boundary(tmp_path_factory):
    """K14's twin against the JAX ``step`` and ``boundary`` of c=2 at
    ``max_round=1``: every lane's words, the validity ANDed with the
    successor's boundary, and the overflow flag -- over the JAX engine's
    whole log and the overflow and wrap-around rows."""
    jm = _bounded(jpaxos.PaxosModelCfg, JNetwork.new_unordered_nonduplicating(), 2, 1)
    jcm = JPaxosCompiled(jm)
    rows = _jax_run(tmp_path_factory, "c2r1", jm)[1]["rows2d"]
    rows = np.concatenate([rows, _hazard_rows(2)]).astype(np.uint32)

    def jax_step(x):
        nexts, valid, flag = jax.vmap(jcm.step)(x)
        inside = jax.vmap(jax.vmap(jcm.boundary))(nexts)
        return nexts, valid & inside, flag

    j_nexts, j_valid, j_flag = (np.asarray(x) for x in jax.jit(jax_step)(jnp.asarray(rows)))
    p_nexts, p_valid, p_flag = pc.paxos_step_plain(from_numpy_u32(rows, "cpu"), 2, 1)
    assert np.array_equal(to_numpy_u32(p_nexts), j_nexts)
    assert np.array_equal(p_valid.numpy(), j_valid)
    assert bool(p_flag) == bool(j_flag.any())
    # The boundary drops lanes the unbounded step keeps.
    assert (pc.paxos_step_valid_plain(from_numpy_u32(rows, "cpu"), 2).numpy() & ~j_valid).any()


def test_engine_matches_jax_on_bounded_paxos(tmp_path, tmp_path_factory):
    """c=2 at ``max_round=1``: single-phase in both engines (1,834 unique /
    3,535 states / depth 18), the logs bit-equal; at ``max_round=0`` the
    single init state."""
    from stateright_tpu.parallel.wave_common import two_phase_capable as j_two_phase
    from stateright_tpu_torch.parallel.compiled import two_phase_capable

    jm = _bounded(jpaxos.PaxosModelCfg, JNetwork.new_unordered_nonduplicating(), 2, 1)
    pm = _bounded(PaxosModelCfg, Network.new_unordered_nonduplicating(), 2, 1)
    assert not two_phase_capable(pm.compiled()) and not j_two_phase(JPaxosCompiled(jm))
    assert two_phase_capable(_port_model(2).compiled())
    port = pm.checker().spawn_gpu(device="cpu", **GEOMETRY).join()
    assert (port.unique_state_count(), port.state_count(), port.max_depth()) == (
        1_834, 3_535, 18)
    _assert_same_run(_jax_run(tmp_path_factory, "c2r1", jm), port, tmp_path,
                     pc.state_width(2))
    zero = _bounded(PaxosModelCfg, Network.new_unordered_nonduplicating(), 2, 0)
    one = zero.checker().spawn_gpu(device="cpu", **GEOMETRY).join()
    assert (one.unique_state_count(), one.state_count(), one.max_depth()) == (1, 1, 1)
