"""The port's ping-pong slice against the JAX package, on the CPU.

The unordered duplicating network and the lossy actor model (Drop lanes),
the packed codec, K13's twin (step, boundary and conds in one) and the
single-phase engine with its device boundary, each bit-equal to the JAX
package: successors and host fingerprints, packed words, every lane's
words and validity, and the engine's row log, parents, ebits, counts,
discoveries and paths at ``max_nat`` 1-3 lossy (14, 62, 254 states:
4**(n+1) - 2) and 5 lossless (11).  The lossy ``max_nat`` 5 golden (4,094)
is the JAX package's ``slow`` test and runs on the card.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stateright_tpu.models.ping_pong import PingPongCfg as JPingPongCfg  # noqa: E402
from stateright_tpu.models.ping_pong_compiled import PingPongCompiled as JCompiled  # noqa: E402
from stateright_tpu.ops.fingerprint import fingerprint as jfingerprint  # noqa: E402
from stateright_tpu_torch.actor import Drop, Envelope, Id, Network  # noqa: E402
from stateright_tpu_torch.models import ping_pong_compiled as ppc  # noqa: E402
from stateright_tpu_torch.models.ping_pong import Ping, PingPongCfg, Pong  # noqa: E402
from stateright_tpu_torch.ops.fingerprint import fingerprint  # noqa: E402
from stateright_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32  # noqa: E402
from stateright_tpu_torch.parallel.compiled import two_phase_capable  # noqa: E402

GEOMETRY = dict(capacity=1 << 13, max_frontier=1 << 11)


def _models(max_nat, lossy):
    return (
        JPingPongCfg(False, max_nat).into_model().lossy_network_(lossy),
        PingPongCfg(False, max_nat).into_model().lossy_network_(lossy),
    )


def _reach(model, fp):
    """Host BFS within the boundary: fingerprint -> state."""
    frontier = [s for s in model.init_states() if model.within_boundary(s)]
    seen = {fp(s): s for s in frontier}
    while frontier:
        nxt = []
        for s in frontier:
            for ns in model.next_states(s):
                if model.within_boundary(ns) and fp(ns) not in seen:
                    seen[fp(ns)] = ns
                    nxt.append(ns)
        frontier = nxt
    return seen


def test_duplicating_network_matches_jax():
    from stateright_tpu.actor import Envelope as JEnvelope
    from stateright_tpu.actor import Id as JId
    from stateright_tpu.actor import Network as JNetwork
    from stateright_tpu.models.ping_pong import Ping as JPing

    envs = [Envelope(Id(0), Id(1), Ping(v)) for v in (2, 0, 1, 0)]
    jenvs = [JEnvelope(JId(0), JId(1), JPing(v)) for v in (2, 0, 1, 0)]
    net = Network.new_unordered_duplicating(envs)
    jnet = JNetwork.new_unordered_duplicating(jenvs)
    assert len(net) == len(jnet) == 3
    assert fingerprint(net) == jfingerprint(jnet)
    # Delivery keeps the envelope and sets the marker; a drop removes it.
    got, want = net.on_deliver(envs[1]), jnet.on_deliver(jenvs[1])
    assert got.last_msg == envs[1] and len(got) == 3
    assert fingerprint(got) == jfingerprint(want)
    assert fingerprint(got.on_drop(envs[0])) == jfingerprint(want.on_drop(jenvs[0]))
    assert [fingerprint(e) for e in got.iter_deliverable()] == [
        jfingerprint(e) for e in want.iter_deliverable()]
    marked = Network.new_unordered_duplicating_with_last_msg(envs[:2], envs[0])
    assert fingerprint(marked) == jfingerprint(
        JNetwork.new_unordered_duplicating_with_last_msg(jenvs[:2], jenvs[0]))
    assert Network.from_name("unordered_duplicating").kind == "unordered_duplicating"
    with pytest.raises(ValueError, match="unable to parse"):
        Network.from_name("lossy")


@pytest.mark.parametrize("max_nat,lossy", [(2, True), (3, False)])
def test_host_model_and_codec_match_jax(max_nat, lossy):
    """Both host models reach the same states (equal fingerprints), each
    state's actions and successors agree, and the port's codec writes the
    JAX words and reads them back."""
    jm, pm = _models(max_nat, lossy)
    jreach, preach = _reach(jm, jfingerprint), _reach(pm, fingerprint)
    assert sorted(jreach) == sorted(preach)
    jcm, pcm = JCompiled(jm), pm.compiled()
    assert np.array_equal(pcm.init_packed(), jcm.init_packed())
    drops = 0
    for fp, js in jreach.items():
        ps = preach[fp]
        jacts, pacts = [], []
        jm.actions(js, jacts)
        pm.actions(ps, pacts)
        assert [repr(a) for a in pacts] == [repr(a) for a in jacts]
        drops += sum(isinstance(a, Drop) for a in pacts)
        for ja, pa in zip(jacts, pacts):
            jn, pn = jm.next_state(js, ja), pm.next_state(ps, pa)
            assert (jn is None) == (pn is None)
            if pn is not None:
                assert fingerprint(pn) == jfingerprint(jn)
        words = jcm.encode(js)
        assert np.array_equal(pcm.encode(ps), words)
        assert fingerprint(pcm.decode(words)) == fp
    assert (drops > 0) == lossy


def _rows(max_nat, lossy, seed):
    """Reachable rows (every one up to ``max_nat`` 4; past it the space is
    millions of states, so rows of in-range counters and random envelope
    sets instead), hazard rows (counters at 15, every envelope and the
    widest marker set) and fuzzed rows over the whole two words."""
    jm, _pm = _models(max_nat, lossy)
    jcm = JCompiled(jm)
    rng = np.random.default_rng(seed)
    if max_nat <= 4:
        reach = np.stack([jcm.encode(s) for s in _reach(jm, jfingerprint).values()])
    else:
        c = rng.integers(0, max_nat + 1, size=(2000, 2))
        env = rng.integers(0, 1 << jcm.e, size=2000)
        last = rng.integers(0, jcm.e + 1, size=2000)
        bits = c[:, 0] | (c[:, 1] << 4) | (env << 8) | (last << jcm.last_shift)
        reach = np.stack([bits & 0xFFFFFFFF, bits >> 32], axis=1)
    full = (1 << (8 + jcm.e)) - 1 | (0x1F << jcm.last_shift)
    hazard = np.array([
        [0xFF, 0], [full & 0xFFFFFFFF, full >> 32], [0xFFFFFFFF, 0xFFFFFFFF],
        [0, 0], [(max_nat + 1) | ((max_nat + 1) << 4), 0],
    ], np.uint32)
    fuzz = rng.integers(0, 1 << 32, size=(500, 2), dtype=np.uint32)
    return np.concatenate([reach, hazard, fuzz]).astype(np.uint32), jcm


@pytest.mark.parametrize("max_nat,lossy", [(1, True), (4, True), (13, True), (5, False)])
def test_step_twin_matches_jax(max_nat, lossy):
    rows, jcm = _rows(max_nat, lossy, max_nat)

    def jax_step(x):
        nexts, valid = jax.vmap(jcm.step)(x)
        inside = jax.vmap(jax.vmap(jcm.boundary))(nexts)
        return nexts, valid, valid & inside, jax.vmap(jcm.property_conds)(x)

    j_nexts, j_raw, j_valid, j_conds = (
        np.asarray(x) for x in jax.jit(jax_step)(jnp.asarray(rows)))
    t = from_numpy_u32(rows, "cpu")
    p_nexts, p_valid, p_conds = ppc.ping_pong_step_plain(t, max_nat, lossy)
    assert np.array_equal(to_numpy_u32(p_nexts), j_nexts)  # every lane
    assert np.array_equal(p_valid.numpy(), j_valid)
    assert np.array_equal(p_conds.numpy(), j_conds)
    pcm = _models(max_nat, lossy)[1].compiled()
    assert np.array_equal(pcm.step(t)[1].numpy(), j_raw)
    assert np.array_equal(pcm.boundary(t).numpy(), np.asarray(jax.vmap(jcm.boundary)(rows)))
    assert (j_raw & ~j_valid).any() and j_valid.any()


def _logs(checker, path):
    checker.save_snapshot(str(path))
    with np.load(path) as snap:
        tail = int(snap["tail"])
        return {
            "rows": snap["rows"][: 2 * tail].copy(),
            "parent": snap["parent"][:tail].copy(),
            "ebits": snap["ebits"][:tail].copy(),
        }


@pytest.mark.parametrize("max_nat,lossy,golden,geometry", [
    (1, True, 14, GEOMETRY), (2, True, 62, GEOMETRY), (3, True, 254, GEOMETRY),
    (5, False, 11, GEOMETRY),
    # 4,096 states a chunk: a flag 4 at depth 17 falls back to the sorted
    # path, which appends in sorted-key order from then on.
    (6, True, 16_382, dict(capacity=1 << 16, max_frontier=1 << 12)),
])
def test_engine_matches_jax(max_nat, lossy, golden, geometry, tmp_path):
    jm, pm = _models(max_nat, lossy)
    jck = jm.checker().spawn_tpu(
        device=jax.devices("cpu")[0], compiled=JCompiled(jm), **geometry).join()
    port = pm.checker().spawn_gpu(device="cpu", **geometry).join()
    assert ("sortless=0" in port._grow_notes) == (max_nat == 6)
    assert not two_phase_capable(pm.compiled())
    got = (port.unique_state_count(), port.state_count(), port.max_depth())
    assert got == (jck.unique_state_count(), jck.state_count(), jck.max_depth())
    assert got[0] == golden
    if lossy:
        n = max_nat
        assert got == (4 ** (n + 1) - 2, n * 4 ** (n + 1) + 4 ** n + 1, 4 * n + 2)
    a, b = _logs(port, tmp_path / "p.npz"), _logs(jck, tmp_path / "j.npz")
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert np.array_equal(port.discovered_fingerprints(), jck.discovered_fingerprints())
    jd, pd = jck.discoveries(), port.discoveries()
    assert sorted(pd) == sorted(jd)
    want = ["can reach max", "must exceed max"] + (["must reach max"] if lossy else [])
    assert sorted(pd) == sorted(want)
    for name in jd:
        assert pd[name].encode(port.model()) == jd[name].encode(jck.model())
        assert [repr(x) for x in pd[name].into_actions()] == [
            repr(x) for x in jd[name].into_actions()]


def test_codec_refuses_what_it_cannot_pack():
    with pytest.raises(ValueError, match="max_nat <= 13"):
        PingPongCfg(False, 14).into_model().compiled()
    with pytest.raises(ValueError, match="maintains_history=False"):
        PingPongCfg(True, 3).into_model().compiled()
    model = PingPongCfg(False, 3).into_model().init_network_(Network.new_ordered())
    with pytest.raises(ValueError, match="unordered_duplicating"):
        model.compiled()
    env = Envelope(Id(1), Id(0), Pong(0))
    assert Drop(env).envelope == env
