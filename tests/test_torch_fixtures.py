"""The port's trap-counter fixture against the JAX package, on the CPU.

K17's twin against ``TrapCounterCompiled.step``/``property_conds``; the
eventually pipeline (the JAX package's ``test_eventually_parity_with_host``
and ``test_eventually_satisfied_at_terminal_not_reported``): the engine's
row log, parents, ebits, counts, discoveries and paths equal the JAX
engine's; and the identity canonicalization: under ``symmetry_fn(lambda s:
s)`` the run equals the plain run.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stateright_tpu.models.fixtures import TrapCounter as JTrapCounter  # noqa: E402
from stateright_tpu_torch.models.fixtures import (  # noqa: E402
    TrapCounter, trap_step_plain,
)
from stateright_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32  # noqa: E402
from stateright_tpu_torch.parallel.canon import make_canon  # noqa: E402

GEOMETRY = dict(capacity=1 << 10, max_frontier=1 << 4)


@pytest.mark.parametrize("limit,trap_at", [(5, 2), (5, 10**6), (0xFFFFFFFE, 7)])
def test_step_twin_matches_jax(limit, trap_at):
    jcm = JTrapCounter(limit, trap_at).compiled()
    rng = np.random.default_rng(limit & 0xFF)
    rows = np.concatenate([
        np.arange(12), [limit, trap_at & 0xFFFFFFFF, limit + 1, 0xFFFFFFFF],
        rng.integers(0, 1 << 32, 200),
    ]).astype(np.uint32).reshape(-1, 1)
    nexts, valid = (np.asarray(x) for x in jax.jit(jax.vmap(jcm.step))(jnp.asarray(rows)))
    conds = np.asarray(jax.jit(jax.vmap(jcm.property_conds))(jnp.asarray(rows)))
    p_nexts, p_valid, p_conds = trap_step_plain(
        from_numpy_u32(rows, "cpu"), limit, trap_at, limit + 1)
    assert np.array_equal(to_numpy_u32(p_nexts), nexts)
    assert np.array_equal(p_valid.numpy(), valid)
    assert np.array_equal(p_conds.numpy(), conds)


def _logs(checker, path):
    checker.save_snapshot(str(path))
    with np.load(path) as snap:
        tail = int(snap["tail"])
        return [snap[k][:tail].copy() for k in ("rows", "parent", "ebits")]


@pytest.mark.parametrize("trap_at,found", [
    (2, ["reaches limit", "trapped"]), (10**6, []),
])
def test_eventually_pipeline_matches_jax(trap_at, found, tmp_path):
    """"reaches one" holds on every path; "reaches limit" fails through
    the trap's dead end, whose path ends in the trap state; without the
    trap every path ends at the limit, which satisfies it there."""
    jck = JTrapCounter(trap_at=trap_at).checker().spawn_tpu(
        device=jax.devices("cpu")[0], **GEOMETRY).join()
    model = TrapCounter(trap_at=trap_at)
    port = model.checker().spawn_gpu(device="cpu", **GEOMETRY).join()
    got = (port.unique_state_count(), port.state_count(), port.max_depth())
    assert got == (jck.unique_state_count(), jck.state_count(), jck.max_depth())
    for a, b in zip(_logs(port, tmp_path / "p.npz"), _logs(jck, tmp_path / "j.npz")):
        assert np.array_equal(a, b)
    assert np.array_equal(port.discovered_fingerprints(), jck.discovered_fingerprints())
    assert sorted(port.discoveries()) == sorted(jck.discoveries()) == found
    for name, path in jck.discoveries().items():
        assert port.discoveries()[name].into_states() == path.into_states()
    if found:
        assert port.discoveries()["reaches limit"].last_state() == model.trap_state


def test_identity_canon_changes_nothing(tmp_path):
    model = TrapCounter()
    assert make_canon(model.compiled()) is not None
    sym = model.checker().symmetry_fn(lambda s: s).spawn_gpu(device="cpu", **GEOMETRY).join()
    plain = model.checker().spawn_gpu(device="cpu", **GEOMETRY).join()
    jsym = JTrapCounter().checker().symmetry_fn(lambda s: s).spawn_tpu(
        device=jax.devices("cpu")[0], **GEOMETRY).join()
    for ck in (plain, jsym):
        assert (sym.unique_state_count(), sym.state_count(), sym.max_depth()) == (
            ck.unique_state_count(), ck.state_count(), ck.max_depth())
        assert sorted(sym.discoveries()) == sorted(ck.discoveries())
    for a, b in zip(_logs(sym, tmp_path / "s.npz"), _logs(plain, tmp_path / "p.npz")):
        assert np.array_equal(a, b)
    assert np.array_equal(sym.discovered_fingerprints(), jsym.discovered_fingerprints())
    assert sym.discoveries()["reaches limit"].last_state() == model.trap_state
