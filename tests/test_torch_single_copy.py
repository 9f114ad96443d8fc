"""The port's single-copy register against the JAX package, on the CPU.

Bit-equal throughout: the codec's words and host fingerprints, the twin of
K9 (the fused step and conds, with the linearizability DP) against the
JAX ``_deliver_lane`` and ``property_conds`` on every lane, and the port's
CPU engine against the JAX CPU engine on 2 clients / 1 server (93 unique
states), 2 clients / 2 servers (the reachable ``linearizable``
counterexample, its path replayed on the host) and 3 clients / 1 server
(4,243 / 6,778 / depth 13) -- row log, parents, ebits, counts,
discoveries, paths -- plus a JAX snapshot resumed by the port.  The JAX
programs are compiled once per module.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stateright_tpu.actor import Network as JNetwork  # noqa: E402
from stateright_tpu.core.has_discoveries import HasDiscoveries as JHasDiscoveries  # noqa: E402
from stateright_tpu.models.single_copy_compiled import (  # noqa: E402
    SingleCopyCompiled as JSingleCopyCompiled,
)
from stateright_tpu.models.single_copy_register import (  # noqa: E402
    SingleCopyModelCfg as JSingleCopyModelCfg,
)
from stateright_tpu_torch.actor import Network  # noqa: E402
from stateright_tpu_torch.core.has_discoveries import HasDiscoveries  # noqa: E402
from stateright_tpu_torch.models import single_copy_compiled as scc  # noqa: E402
from stateright_tpu_torch.models.single_copy_register import (  # noqa: E402
    SingleCopyModelCfg,
)
from stateright_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32  # noqa: E402

GEOMETRY = dict(capacity=1 << 14, max_frontier=1 << 8)
# A policy no run matches: the run goes on until nothing is awaited.
NEVER = ["__not_a_property__"]
_CACHE = {}


def _once(key, make):
    if key not in _CACHE:
        _CACHE[key] = make()
    return _CACHE[key]


def _port_model(c, s):
    return SingleCopyModelCfg(c, s, Network.new_unordered_nonduplicating()).into_model()


def _jax_model(c, s):
    return JSingleCopyModelCfg(c, s, JNetwork.new_unordered_nonduplicating()).into_model()


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


def _jax_run(tmp_path_factory, c, s, builder=lambda b: b, name=None):
    name = name or f"c{c}s{s}"

    def run():
        checker = builder(_jax_model(c, s).checker()).spawn_tpu(**GEOMETRY).join()
        path = tmp_path_factory.mktemp("jax") / f"{name}.npz"
        return checker, _logs(checker, path, scc.state_width(c)), path

    return _once(("run", name), run)


def _jax_violation(tmp_path_factory):
    return _jax_run(
        tmp_path_factory, 2, 2,
        lambda b: b.finish_when(JHasDiscoveries.all_of(NEVER)),
    )


def _assert_same_run(jax_run, port, tmp_path, w):
    jax_checker, jax_logs, _path = jax_run
    port_logs = _logs(port, tmp_path / "port.npz", w)
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


# --- codec and the K9 twin ---------------------------------------------------------


@pytest.mark.parametrize("c,s", [(2, 2), (3, 1)])
def test_codec_and_k9_twin_match_jax(c, s, tmp_path_factory):
    """Every state the JAX engine logged (the 2-server run stops at its
    counterexample; the 3-client run is the whole space): the port decodes
    the JAX words to a state of the same host fingerprint, which it
    encodes back to the words; the K9 twin equals the JAX
    ``_deliver_lane`` on every lane and ``property_conds`` on every
    state."""
    run = _jax_violation(tmp_path_factory) if s == 2 else _jax_run(tmp_path_factory, c, s)
    rows = run[1]["rows2d"]
    jcm = JSingleCopyCompiled(_jax_model(c, s))
    model = _port_model(c, s)
    pcm = model.compiled()
    assert np.array_equal(pcm.init_packed(), jcm.init_packed())
    for row in rows[:200]:
        st = pcm.decode(row)
        assert model.fingerprint(st) == jcm.model.fingerprint(jcm.decode(row))
        assert np.array_equal(pcm.encode(st), row)
    lane_fn = jax.jit(jax.vmap(lambda st: jax.vmap(lambda k: jcm._deliver_lane(st, k))(
        jnp.arange(jcm.m, dtype=jnp.uint32))))
    j_nexts, j_valid, j_flags = (np.asarray(x) for x in lane_fn(jnp.asarray(rows)))
    j_conds = np.asarray(jax.jit(jax.vmap(jcm.property_conds))(jnp.asarray(rows)))
    nexts, valid, conds, flag = scc.single_copy_step_plain(
        from_numpy_u32(rows, "cpu"), s, c
    )
    assert np.array_equal(to_numpy_u32(nexts), j_nexts)
    assert np.array_equal(valid.numpy(), j_valid)
    assert np.array_equal(conds.numpy(), j_conds)
    assert bool(flag) == bool(j_flags.any()) is False
    assert j_conds[:, 1].any()
    assert (~j_conds[:, 0]).any() == (s == 2)


# --- the engine -----------------------------------------------------------------


def test_engine_matches_jax_one_server(tmp_path, tmp_path_factory):
    """2 clients / 1 server: 93 unique states (single-copy-register.rs),
    linearizable throughout."""
    port = _port_model(2, 1).checker().spawn_gpu(device="cpu", **GEOMETRY).join()
    assert port.unique_state_count() == 93
    assert sorted(port.discoveries()) == ["value chosen"]
    _assert_same_run(_jax_run(tmp_path_factory, 2, 1), port, tmp_path, scc.state_width(2))
    port.assert_properties()


def test_engine_matches_jax_three_clients(tmp_path, tmp_path_factory):
    port = _port_model(3, 1).checker().spawn_gpu(device="cpu", **GEOMETRY).join()
    assert (port.unique_state_count(), port.state_count(), port.max_depth()) == (
        4_243, 6_778, 13
    )
    _assert_same_run(_jax_run(tmp_path_factory, 3, 1), port, tmp_path, scc.state_width(3))


def test_two_servers_linearizable_counterexample(tmp_path, tmp_path_factory):
    """2 clients / 2 servers: the DP finds the reachable violation; both
    engines stop at the same states once nothing is awaited, and the
    re-executed path ends in a history with no linearization."""
    port = (
        _port_model(2, 2).checker().finish_when(HasDiscoveries.all_of(NEVER))
        .spawn_gpu(device="cpu", **GEOMETRY).join()
    )
    assert sorted(port.discoveries()) == ["linearizable", "value chosen"]
    assert port.unique_state_count() < 62  # the full space
    path = port.discoveries()["linearizable"]
    assert path.last_state().history.serialized_history() is None
    _assert_same_run(_jax_violation(tmp_path_factory), port, tmp_path, scc.state_width(2))


def test_jax_snapshot_resumes_in_the_port(tmp_path, tmp_path_factory):
    """A JAX run of 2 clients / 1 server cut by ``target_state_count``,
    resumed by the port, ends where the uninterrupted JAX run ends."""
    partial = _jax_run(
        tmp_path_factory, 2, 1, lambda b: b.target_state_count(40), name="cut"
    )
    assert partial[0].unique_state_count() < 93
    resumed = _port_model(2, 1).checker().spawn_gpu(
        device="cpu", resume_from=str(partial[2]), **GEOMETRY
    ).join()
    _assert_same_run(_jax_run(tmp_path_factory, 2, 1), resumed, tmp_path,
                     scc.state_width(2))
