"""The port's LWW-register CRDT (``SelectRandom``) against the JAX
package, on the CPU.

The host actor model (random choices, ``SelectRandom`` successors, host
fingerprints) over the states within depth 3 (2 nodes: 706) and 2 (3
nodes); the codec's words and its round trip; K16's twin against the JAX
``LwwCompiled.step``/``property_conds`` on every lane of those states and
of fuzzed rows, the encoding flags included; a crafted state with the 12
slots in flight that flags on SetValue in both packages; and the engine
bit-equal to the JAX engine at 2 nodes to depth 5 and 3 nodes to depth 4
(1,890), row log, parents, ebits, counts and fingerprints.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stateright_tpu.models.lww_compiled import LwwCompiled as JCompiled  # noqa: E402
from stateright_tpu.models.lww_register import build_model as jbuild  # noqa: E402
from stateright_tpu.ops.fingerprint import fingerprint as jfingerprint  # noqa: E402
from stateright_tpu_torch.actor import SelectRandom  # noqa: E402
from stateright_tpu_torch.models import lww_compiled as lc  # noqa: E402
from stateright_tpu_torch.models.lww_register import (  # noqa: E402
    LwwActorState, LwwRegister, build_model,
)
from stateright_tpu_torch.ops.fingerprint import fingerprint  # noqa: E402
from stateright_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32  # noqa: E402

_PREFIX = {}


def _prefix(n, depth):
    """Both host models' states within ``depth`` actions, BFS-walked in
    lockstep: a list of (JAX state, port state) pairs.  Asserts on the
    way that each pair's actions, their renderings and successors agree
    (equal host fingerprints and random choices)."""
    key = (n, depth)
    if key in _PREFIX:
        return _PREFIX[key]
    jm, pm = jbuild(n), build_model(n)
    pairs = list(zip(jm.init_states(), pm.init_states()))
    seen = {jfingerprint(j) for j, _ in pairs}
    frontier = list(pairs)
    selects = 0
    for _ in range(depth):
        nxt = []
        for js, ps in frontier:
            assert jfingerprint(js) == fingerprint(ps)
            assert repr(js.random_choices) == repr(ps.random_choices)
            ja, pa = [], []
            jm.actions(js, ja)
            pm.actions(ps, pa)
            assert [repr(a) for a in pa] == [repr(a) for a in ja]
            assert [pm.format_action(a) for a in pa] == [jm.format_action(a) for a in ja]
            selects += sum(isinstance(a, SelectRandom) for a in pa)
            for a, b in zip(ja, pa):
                jn, pn = jm.next_state(js, a), pm.next_state(ps, b)
                assert (jn is None) == (pn is None)
                if pn is None:
                    continue
                assert fingerprint(pn) == jfingerprint(jn)
                if jfingerprint(jn) not in seen:
                    seen.add(jfingerprint(jn))
                    nxt.append((jn, pn))
        pairs.extend(nxt)
        frontier = nxt
    assert selects > 0
    _PREFIX[key] = pairs
    return pairs


@pytest.mark.parametrize("n,depth,count", [(2, 3, 706), (3, 2, 187)])
def test_host_model_matches_jax(n, depth, count):
    assert len(_prefix(n, depth)) == count


def test_selectrandom_consumes_and_repopulates_the_menu():
    pm = build_model(2)
    (init,) = pm.init_states()
    acts = []
    pm.actions(init, acts)
    assert len(acts) == 10 and all(isinstance(a, SelectRandom) for a in acts)
    nxt = pm.next_state(init, acts[0])  # node 0 sets "A" and broadcasts
    assert nxt.actor_states[0].register == LwwRegister("A", 1000, 0)
    assert len(nxt.network) == 2
    assert nxt.random_choices == init.random_choices
    skewed = pm.next_state(init, acts[3])  # node 0's clock to 1001
    assert skewed.actor_states[0] == LwwActorState(None, 1001, 1000)
    assert skewed.random_choices[0][0][1][3].time == 1002


@pytest.mark.parametrize("n,depth", [(2, 3), (3, 2)])
def test_codec_matches_jax(n, depth):
    pairs = _prefix(n, depth)
    jcm, pcm = JCompiled(jbuild(n)), build_model(n).compiled()
    assert (pcm.state_width, pcm.max_actions) == (jcm.state_width, jcm.max_actions)
    assert np.array_equal(pcm.init_packed(), jcm.init_packed())
    for js, ps in pairs:
        words = jcm.encode(js)
        assert np.array_equal(pcm.encode(ps), words)
        assert fingerprint(pcm.decode(words)) == fingerprint(ps)


def _jax_step(jcm, rows):
    nexts, valid, flags = (
        np.asarray(x) for x in jax.jit(jax.vmap(jcm.step))(jnp.asarray(rows)))
    conds = np.asarray(jax.jit(jax.vmap(jcm.property_conds))(jnp.asarray(rows)))
    return nexts, valid, flags, conds


def _assert_twin_is_jax(n, rows):
    jcm = JCompiled(jbuild(n))
    j_nexts, j_valid, j_flags, j_conds = _jax_step(jcm, rows)
    p_nexts, p_valid, p_flags, p_conds = lc.lww_step_plain(from_numpy_u32(rows, "cpu"), n)
    assert np.array_equal(to_numpy_u32(p_nexts), j_nexts)  # every lane
    assert np.array_equal(p_valid.numpy(), j_valid)
    assert np.array_equal(p_flags.numpy(), j_flags)
    assert np.array_equal(p_conds.numpy(), j_conds)
    return j_valid, j_flags


@pytest.mark.parametrize("n,depth", [(2, 3), (3, 2)])
def test_step_twin_matches_jax_on_reachable_rows(n, depth):
    jcm = JCompiled(jbuild(n))
    rows = np.stack([jcm.encode(j) for j, _ in _prefix(n, depth)]).astype(np.uint32)
    valid, flags = _assert_twin_is_jax(n, rows)
    assert valid[:, : lc.NET_SLOTS].any() and not flags.any()


@pytest.mark.parametrize("n", [1, 2, 3])
def test_step_twin_matches_jax_on_fuzzed_rows(n):
    """Words of every bit pattern; small words with trailing empty slots
    (the merge and the sort's empties); sorted slots with duplicate runs
    (one Deliver per distinct envelope); clocks at 0 and 63."""
    rng = np.random.default_rng(n)
    w = n + lc.NET_SLOTS
    raw = rng.integers(0, 1 << 32, size=(300, w), dtype=np.uint32)
    small = rng.integers(0, 1 << 15, size=(300, w), dtype=np.uint32)
    small[:, n + 5:] = 0
    runs = np.sort(rng.integers(1, 1 << 14, size=(300, lc.NET_SLOTS)), axis=1)
    runs[:, :3] = runs[:, 3:4]
    nodes = rng.integers(0, 1 << 23, size=(300, n))
    nodes[:100] |= 63 << 11
    nodes[100:200] &= ~(63 << 11)
    rows = np.concatenate([raw, small, np.concatenate([nodes, runs], 1)]).astype(np.uint32)
    _valid, flags = _assert_twin_is_jax(n, rows)
    assert flags.any() and not flags.all()


def test_full_network_flags_on_setvalue():
    """Six SetValues of node 0 put 12 envelopes in flight (each is sent to
    both nodes): the state packs, and a further SetValue's broadcast has
    no slot left, which flags in both packages; only the SetValue lanes
    flag."""
    from stateright_tpu.actor import Id as JId
    from stateright_tpu.actor.model import SelectRandom as JSelectRandom
    from stateright_tpu.models.lww_register import SetValue as JSetValue
    from stateright_tpu_torch.actor import Id
    from stateright_tpu_torch.models.lww_register import SetValue

    jm, pm = jbuild(2), build_model(2)
    (js,), (ps,) = jm.init_states(), pm.init_states()
    for _ in range(6):
        js = jm.next_state(js, JSelectRandom(JId(0), "node_action", JSetValue("A")))
        ps = pm.next_state(ps, SelectRandom(Id(0), "node_action", SetValue("A")))
    assert len(ps.network) == 12 and fingerprint(ps) == jfingerprint(js)
    jcm, pcm = JCompiled(jm), pm.compiled()
    rows = np.stack([pcm.encode(ps)]).astype(np.uint32)
    assert np.array_equal(rows[0], jcm.encode(js))
    _valid, flags = _assert_twin_is_jax(2, rows)
    assert flags.all()
    lanes = lc.lww_lanes_plain(from_numpy_u32(rows, "cpu"), 2)[2].numpy()[0]
    set_value = [lc.NET_SLOTS + 5 * i + c for i in range(2) for c in range(3)]
    assert lanes[set_value].all() and lanes.sum() == len(set_value)


def _logs(checker, path, w):
    checker.save_snapshot(str(path))
    with np.load(path) as snap:
        tail = int(snap["tail"])
        return [snap[k][: tail * m].copy() for k, m in
                (("rows", w), ("parent", 1), ("ebits", 1))]


@pytest.mark.parametrize("n,depth,golden", [(2, 5, (4_835, 9_287, 5)), (3, 4, (1_890, 3_427, 4))])
def test_engine_matches_jax(n, depth, golden, tmp_path):
    geometry = dict(capacity=1 << 16, max_frontier=1 << 10)
    jck = jbuild(n).checker().target_max_depth(depth).spawn_tpu(
        device=jax.devices("cpu")[0], **geometry).join()
    port = build_model(n).checker().target_max_depth(depth).spawn_gpu(
        device="cpu", **geometry).join()
    got = (port.unique_state_count(), port.state_count(), port.max_depth())
    assert got == (jck.unique_state_count(), jck.state_count(), jck.max_depth()) == golden
    w = n + lc.NET_SLOTS
    for a, b in zip(_logs(port, tmp_path / "p.npz", w), _logs(jck, tmp_path / "j.npz", w)):
        assert np.array_equal(a, b)
    assert np.array_equal(port.discovered_fingerprints(), jck.discovered_fingerprints())
    assert port.discoveries() == {} and jck.discoveries() == {}


def test_codec_refuses_what_it_cannot_pack():
    with pytest.raises(ValueError, match="1 to 3 nodes"):
        build_model(4).compiled()
    with pytest.raises(ValueError, match="lossless"):
        build_model(2).lossy_network_(True).compiled()
