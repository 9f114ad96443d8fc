"""The port's ABD quorum register against the JAX package, on the CPU.

Bit-equal throughout, on both fabrics: the codec's words and host
fingerprints over the whole reachable sets of 1 and 2 clients (13, 544
and, ordered, 620 states); the twin of K10 (the fused step and conds,
with the linearizability DP at the tester offset) against the JAX lanes
``_deliver_lane`` / ``_deliver_lane_ordered``, their flags and
``property_conds`` on every lane of those sets, of the ``skip_ack``
cluster's, of 3 clients ordered to depth 12, of duplicated in-flight
sends and of hand-made and fuzzed rows (empty heads and slots, full
queues, clocks at their cap); and the port's CPU engine against the JAX
CPU engine on ``linearizable-register check 2`` (544 / 875 / 25), its
ordered twin (620 / 883 / 25), the ``skip_ack`` counterexample (28 / 35
/ 6) and ``check 3 ordered`` to depth 12 (509 / 866) -- row log,
parents, ebits, counts, discoveries, re-executed paths -- plus a JAX
snapshot resumed by the port.  Exact equality everywhere.  The JAX
programs are compiled once per module.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stateright_tpu.actor import Network as JNetwork  # noqa: E402
from stateright_tpu.models.abd import AbdModelCfg as JAbdModelCfg  # noqa: E402
from stateright_tpu.models.abd_compiled import AbdCompiled as JAbdCompiled  # noqa: E402
from stateright_tpu_torch.actor import Deliver, Network  # noqa: E402
from stateright_tpu_torch.models import abd_compiled as ac  # noqa: E402
from stateright_tpu_torch.models.abd import AbdModelCfg  # noqa: E402
from stateright_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32  # noqa: E402

from .test_torch_device import abd_fuzz_rows  # noqa: E402

GEOMETRY = dict(capacity=1 << 13, max_frontier=1 << 8)
# (clients, ordered, fault) of each configuration the tests run.
C1 = (1, False, None)
C2 = (2, False, None)
C2O = (2, True, None)
SKIP = (2, False, "skip_ack")
SKIP_O = (2, True, "skip_ack")
C3O = (3, True, None)
_CACHE = {}


def _once(key, make):
    if key not in _CACHE:
        _CACHE[key] = make()
    return _CACHE[key]


def _port_model(cfg):
    c, ordered, fault = cfg
    net = Network.new_ordered() if ordered else Network.new_unordered_nonduplicating()
    return AbdModelCfg(c, 2, net, fault=fault).into_model()


def _jax_model(cfg):
    c, ordered, fault = cfg
    net = JNetwork.new_ordered() if ordered else JNetwork.new_unordered_nonduplicating()
    return JAbdModelCfg(c, 2, net, fault=fault).into_model()


def _port_rows(cfg, depth=0):
    """Every state the port's CPU engine reaches (to ``depth``), as
    uint32[N, W] rows in BFS order."""
    def run():
        checker = _port_model(cfg).checker().target_max_depth(depth).spawn_gpu(
            device="cpu", **GEOMETRY
        ).join()
        w = ac.state_width(cfg[0], cfg[1])
        return to_numpy_u32(checker._carry.rows[: checker._carry.tail * w].view(-1, w))

    return _once(("rows", cfg, depth), run)


# Rows a JAX lane call takes, padded with empty rows: one compile a model.
_BATCH = 4096


def _jax_lanes(cfg, rows):
    """The JAX lanes of ``rows``: (nexts [N, A, W], valid [N, A], flags
    [N, A]), and the JAX ``property_conds`` [N, 2]."""
    cm = JAbdCompiled(_jax_model(cfg))
    lane = cm._deliver_lane_ordered if cm.ordered else cm._deliver_lane

    def both(st):
        ks = jnp.arange(cm.max_actions, dtype=jnp.uint32)
        return jax.vmap(lambda k: lane(st, k))(ks) + (cm.property_conds(st),)

    fn = _once(("lanes", cfg), lambda: jax.jit(jax.vmap(both)))
    n = rows.shape[0]
    assert n <= _BATCH
    x = jnp.asarray(np.concatenate([rows, np.zeros((_BATCH - n, rows.shape[1]), np.uint32)]))
    return tuple(np.asarray(t)[:n] for t in fn(x))


def _assert_twin_matches_jax(cfg, rows):
    """The K10 twin equals JAX on every lane of ``rows``, valid or not:
    words, validity and flags; and the conds.  Returns the JAX flags."""
    c, ordered, fault = cfg
    j_nexts, j_valid, j_flags, j_conds = _jax_lanes(cfg, rows)
    t = from_numpy_u32(rows, "cpu")
    nexts, valid, flags = ac.abd_lanes_plain(t, c, ordered, fault == "skip_ack")
    assert np.array_equal(to_numpy_u32(nexts), j_nexts)
    assert np.array_equal(valid.numpy(), j_valid)
    assert np.array_equal(flags.numpy(), j_flags)
    assert np.array_equal(ac.abd_conds_plain(t, c, ordered).numpy(), j_conds)
    step = ac.abd_step_plain(t, c, ordered, fault == "skip_ack")
    assert bool(step[3]) == bool(j_flags.any())
    return j_flags


# --- the codec ---------------------------------------------------------------------


@pytest.mark.parametrize("cfg,golden", [(C1, 13), (C2, 544), (C2O, 620)])
def test_codec_matches_jax_over_the_reachable_set(cfg, golden):
    """Every reachable state: the port decodes the words to a state of the
    JAX state's host fingerprint, encodes it back to the same words, and
    ``decode(encode(s)) == s``."""
    rows = _port_rows(cfg)
    assert rows.shape[0] == golden
    pm, jm = _port_model(cfg), _jax_model(cfg)
    pcm, jcm = pm.compiled(), JAbdCompiled(jm)
    assert (pcm.state_width, pcm.max_actions) == (jcm.state_width, jcm.max_actions)
    assert np.array_equal(pcm.init_packed(), jcm.init_packed())
    for row in rows:
        st = pcm.decode(row)
        assert pm.fingerprint(st) == jm.fingerprint(jcm.decode(row))
        assert np.array_equal(pcm.encode(st), row)
        assert pcm.decode(pcm.encode(st)) == st


def test_codec_refuses_what_the_slice_does_not_port():
    with pytest.raises(ValueError, match="1 to 3 clients"):
        _port_model((4, False, None)).compiled()
    with pytest.raises(ValueError, match="server_count=2"):
        AbdModelCfg(2, 3, Network.new_ordered()).into_model().compiled()
    with pytest.raises(ValueError, match="unordered_nonduplicating and ordered"):
        AbdModelCfg(2, 2, Network.new_unordered_duplicating()).into_model().compiled()


# --- the K10 twin ----------------------------------------------------------------


def _hazard_rows(cfg, rows, rng):
    """Rows on the branches the reachable set never takes: every seq field
    of the server records at the clock's cap (a write's next clock passes
    MAX_CLOCK), the network filled up with a code that sorts last (on
    the ordered fabric a reply then finds its peer queue full), ordered
    peer queues with an empty head before a queued message, a network of
    nothing but empty words (every code wraps), and fuzzed rows."""
    c, ordered, _fault = cfg
    m = ac.net_words(c, ordered)
    net = slice(3, 3 + m)
    out = []
    capped = rows.copy()
    seqs = np.uint32(0xF | (0xF << 12) | (0xF << 19))  # own, responses
    capped[:, 0] = (capped[:, 0] & ~seqs) | np.uint32(15 | (15 << 12) | (14 << 19))
    capped[:, 1] = (capped[:, 1] & ~seqs) | np.uint32(14 | (15 << 12) | (14 << 19))
    out.append(capped)
    full = rows.copy()
    last = np.uint32(1 + ((7 << 18) | (15 << 14) | 0x3FFF))  # sorts last
    if ordered:
        for _src, _dst, depth, off in ac.fifo_pairs(c):
            if depth == 3:
                queue = full[:, 3 + off : 3 + off + 3]
                queue[queue == 0] = last
        holes = rows.copy()
        for _src, _dst, depth, off in ac.fifo_pairs(c):
            if depth == 3:
                holes[:, 3 + off + 1] = holes[:, 3 + off]
                holes[:, 3 + off] = 0
        out.append(holes)
    else:
        slots = full[:, net]
        slots[slots == 0] = last
    out.append(full)
    empty = rows.copy()
    empty[:, net] = 0
    out.append(empty)
    out.append(abd_fuzz_rows(rng, 256, c, ordered))
    return np.concatenate(out)


@pytest.mark.parametrize("cfg", [C1, C2, C2O, SKIP, SKIP_O, C3O])
def test_k10_twin_matches_jax(cfg):
    """Every lane of every reachable state (3 clients: to depth 12), then
    of the hazard rows: words, validity, lane flags and conds.  No
    reachable lane flags, the hazard rows do; only the skip_ack cluster's
    space holds non-linearizable histories."""
    rows = _port_rows(cfg, depth=12 if cfg[0] == 3 else 0)
    hazards = _hazard_rows(cfg, rows, np.random.default_rng(11 + cfg[0]))
    flags = _assert_twin_matches_jax(cfg, np.concatenate([rows, hazards]))
    assert not flags[: len(rows)].any()
    assert flags[len(rows) :].any()  # the flagged branches are reached
    lin = ac.abd_conds_plain(from_numpy_u32(rows, "cpu"), cfg[0], cfg[1])[:, 0]
    assert bool((~lin).any()) == (cfg[2] == "skip_ack")


def test_duplicate_inflight_sends_match_jax_and_the_host():
    """Synthetic count-2 envelopes (no protocol reaches one): each in-flight
    envelope of every reachable 2-client state doubled in turn.  The port's
    codec gives JAX's words and repeats the code; the twin equals JAX on
    every lane; only the first slot of a run of equal codes is a lane,
    and its successor is the host model's."""
    pm = _port_model(C2)
    pcm, jcm = pm.compiled(), JAbdCompiled(_jax_model(C2))
    states = []
    for row in _port_rows(C2):
        st = pcm.decode(row)
        counts = dict(st.network.counts)
        if len(counts) + 1 > pcm.m:
            continue
        for env in sorted(counts, key=pcm._env_code):
            doubled = dict(counts)
            doubled[env] = 2
            states.append(dataclasses.replace(st, network=dataclasses.replace(
                st.network, counts=frozenset(doubled.items()))))
    assert states
    rows = np.stack([pcm.encode(s) for s in states])
    for s, row in zip(states, rows):
        assert pcm.decode(row) == s
        assert np.array_equal(jcm.encode(jcm.decode(row)), row)
    _assert_twin_matches_jax(C2, rows)
    nexts, valid, _flags = ac.abd_lanes_plain(from_numpy_u32(rows, "cpu"), 2, False, False)
    nexts = to_numpy_u32(nexts)
    for i, s in enumerate(states):
        host = {}
        for env in s.network.iter_deliverable():
            ns = pm.next_state(s, Deliver(env.src, env.dst, env.msg))
            host[pcm._env_code(env)] = None if ns is None else pcm.encode(ns)
        seen = set()
        for k in range(pcm.m):
            code = int(rows[i, 3 + k])
            if code == 0 or code in seen:
                assert not valid[i, k]
                continue
            seen.add(code)
            assert bool(valid[i, k]) == (host[code] is not None)
            if host[code] is not None:
                assert np.array_equal(nexts[i, k], host[code])


# --- the engine -----------------------------------------------------------------


def _logs(checker, path, w):
    checker.save_snapshot(str(path))
    with np.load(path) as snap:
        tail = int(snap["tail"])
        return {
            "rows": snap["rows"][: tail * w].copy(),
            "parent": snap["parent"][:tail].copy(),
            "ebits": snap["ebits"][:tail].copy(),
        }


def _with_targets(depth=0, states=0):
    def build(b):
        if depth:
            b = b.target_max_depth(depth)
        if states:
            b = b.target_state_count(states)
        return b

    return build


def _jax_run(tmp_path_factory, cfg, depth=0, states=0):
    def run():
        checker = _with_targets(depth, states)(_jax_model(cfg).checker()).spawn_tpu(
            **GEOMETRY
        ).join()
        path = tmp_path_factory.mktemp("jax") / "run.npz"
        return checker, _logs(checker, path, ac.state_width(cfg[0], cfg[1])), path

    return _once(("run", cfg, depth, states), run)


def _assert_same_run(jax_run, port, tmp_path, cfg):
    jax_checker, jax_logs, _path = jax_run
    port_logs = _logs(port, tmp_path / "port.npz", ac.state_width(cfg[0], cfg[1]))
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
        assert pd[name].encode(port.model()) == jd[name].encode(jax_checker.model())
        assert [repr(a) for a in pd[name].into_actions()] == [
            repr(a) for a in jd[name].into_actions()
        ]


@pytest.mark.parametrize("cfg,depth,golden,found", [
    (C2, 0, (544, 875, 25), ["value chosen"]),
    (C2O, 0, (620, 883, 25), ["value chosen"]),
    (SKIP, 0, (28, 35, 6), ["linearizable", "value chosen"]),
    (C3O, 12, (509, 866, 12), []),
])
def test_engine_matches_jax(cfg, depth, golden, found, tmp_path, tmp_path_factory):
    """``spawn_gpu(device="cpu")`` against JAX ``spawn_tpu`` on the same
    model: the goldens, the logs bit for bit, and the discoveries' paths;
    the skip_ack cluster's ``linearizable`` path ends in a history with no
    linearization."""
    port = _with_targets(depth)(_port_model(cfg).checker()).spawn_gpu(
        device="cpu", **GEOMETRY
    ).join()
    assert (port.unique_state_count(), port.state_count(), port.max_depth()) == golden
    assert sorted(port.discoveries()) == found
    _assert_same_run(_jax_run(tmp_path_factory, cfg, depth), port, tmp_path, cfg)
    if "linearizable" in found:
        path = port.discoveries()["linearizable"]
        assert path.last_state().history.serialized_history() is None


def test_jax_snapshot_resumes_in_the_port(tmp_path, tmp_path_factory):
    """A JAX run of the ordered 2-client model cut by
    ``target_state_count``, resumed by the port, ends where the
    uninterrupted JAX run ends."""
    partial = _jax_run(tmp_path_factory, C2O, states=300)
    assert partial[0].unique_state_count() < 620
    resumed = _port_model(C2O).checker().spawn_gpu(
        device="cpu", resume_from=str(partial[2]), **GEOMETRY
    ).join()
    _assert_same_run(_jax_run(tmp_path_factory, C2O), resumed, tmp_path, C2O)
