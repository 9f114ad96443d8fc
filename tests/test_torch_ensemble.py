"""The port's chaos-ensemble engine against the JAX package, on the CPU.

- ``run_ensemble(replay=False)`` equals the JAX engine's result (failing
  members, states walked, shrink steps, repro) and journal events at 64
  members with ``tests/test_ensemble.py``'s chaos spec, and with a
  partition window;
- the fate and partition twins equal the JAX package's
  ``device_fault_fate`` and the host ``fault_fate_u32`` /
  ``Partition.cuts`` (``tests/test_ensemble_fate.py``'s sweeps), and K19's
  twin equals the JAX ``FateLaneHook.apply``'s masked lanes;
- the host replay is not ported: ``replay=True`` raises exactly where a
  JAX replay would start, and a healthy run with ``replay=True`` returns;
- the schedule, spec and journal copies behave as the JAX package's.
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stateright_tpu.ensemble import engine as jengine  # noqa: E402
from stateright_tpu.ensemble.fate import device_fault_fate as jfate  # noqa: E402
from stateright_tpu.ensemble.schedule import derive_schedule as jderive  # noqa: E402
from stateright_tpu.runtime.chaos import ChaosSpec as JChaosSpec  # noqa: E402
from stateright_tpu.runtime.chaos import Partition as JPartition  # noqa: E402
from stateright_tpu.runtime.chaos import fault_fate_u32 as jfault_fate_u32  # noqa: E402
from stateright_tpu_torch import ensemble  # noqa: E402
from stateright_tpu_torch.ensemble import engine, fate  # noqa: E402
from stateright_tpu_torch.ensemble.schedule import EnsembleSchedule, derive_schedule  # noqa: E402
from stateright_tpu_torch.ops.u32 import from_numpy_u32  # noqa: E402
from stateright_tpu_torch.runtime.chaos import ChaosSpec, _link_rng_seed, fault_fate_u32  # noqa: E402
from stateright_tpu_torch.runtime.journal import read_journal  # noqa: E402

_CHAOS = (
    '{"default": {"drop": 0.15, "reorder": 0.1, "duplicate": 0.05,'
    ' "delay": [0.0, 0.002]}}'
)
_PARTITIONED = (
    '{"default": {"drop": 0.05, "reorder": 0.05}, "partitions": '
    '[{"at": 0.1, "heal": 0.5, "groups": [[0], [1, 2, 3]]}]}'
)
_TIMING = ("elapsed_sec", "schedules_per_sec", "ttff_sec")


def _same(port, jax_result):
    p, j = port.to_dict(), jax_result.to_dict()
    for k in _TIMING:
        assert (p.pop(k) is None) == (j.pop(k) is None)
    assert p == j


def _events(path):
    out = []
    for e in read_journal(str(path)):
        e = dict(e)
        e.pop("t")
        for k in ("elapsed_sec", "schedules_per_sec", "ttff_sec"):
            e.pop(k, None)
        out.append(e)
    return out


@pytest.mark.parametrize("chaos", [_CHAOS, _PARTITIONED], ids=["skip_ack", "partitioned"])
def test_run_ensemble_matches_jax(chaos, tmp_path):
    kw = dict(members=64, seed=3, steps=48, fault="skip_ack", chaos=chaos, shrink=True,
              replay=False)
    want = jengine.run_ensemble(journal=str(tmp_path / "jax.jsonl"), **kw)
    got = engine.run_ensemble(device="cpu", journal=str(tmp_path / "port.jsonl"), **kw)
    _same(got, want)
    assert _events(tmp_path / "port.jsonl") == _events(tmp_path / "jax.jsonl")
    assert got.failing and got.repro is not None and got.shrink_steps > 0
    assert got.repro["steps"] <= 48
    assert all(f["property"] == "linearizable" for f in got.failing)
    rebuilt = EnsembleSchedule.from_repro(got.repro)
    assert rebuilt.to_repro() == {k: got.repro[k] for k in rebuilt.to_repro()}


def test_replay_raises_only_where_a_replay_would_start(tmp_path):
    """A failing sweep sweeps, shrinks and journals, then raises where the
    JAX engine starts its host replay; a healthy run returns."""
    journal = tmp_path / "j.jsonl"
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        engine.run_ensemble(members=64, seed=3, steps=48, fault="skip_ack",
                            chaos=_CHAOS, journal=str(journal), device="cpu")
    kinds = [e["event"] for e in read_journal(str(journal))]
    assert kinds[0] == "ensemble_start" and "ensemble_sweep" in kinds
    assert "ensemble_shrink" in kinds and "ensemble_repro" not in kinds
    healthy = engine.run_ensemble(members=64, seed=7, steps=48, fault=None,
                                  chaos='{"default": {"drop": 0.1}}', replay=True,
                                  device="cpu")
    assert healthy.failing == [] and healthy.confirmed == [] and healthy.repro is None


def test_run_ensemble_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")  # pragma: no cover
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.run_ensemble(members=4, steps=4, replay=False)


# --- the fate function --------------------------------------------------------


def test_fate_twin_matches_the_host_function():
    """``test_ensemble_fate.py``'s sweep of (seed, link, n, k)."""
    ns = list(range(40)) + [1000, 65535, 1 << 20, (1 << 29) - 1]
    for seed in (0, 1, 42, 0xDEADBEEF, (1 << 63) + 12345):
        for src, dst in ((0, 1), (1, 0), (2, 1), (255, 254)):
            link_seed = _link_rng_seed(seed, src, dst)
            hi, lo = fate.link_seed_limbs(seed, src, dst)
            assert (hi << 32) | lo == link_seed
            for k in range(4):
                got = fate.device_fault_fate(hi, lo, torch.tensor(ns), k)
                assert got.tolist() == [fault_fate_u32(link_seed, n, k) for n in ns]
                assert got.tolist() == [jfault_fate_u32(link_seed, n, k) for n in ns]


def test_fate_twin_matches_jax_past_the_host_domain():
    """Where ``4n + k + 1`` wraps u32 the twin is still JAX's function."""
    rng = np.random.default_rng(4)
    hi, lo = (rng.integers(0, 1 << 32, 2000).astype(np.uint32) for _ in range(2))
    n = rng.integers(0, 1 << 32, 2000).astype(np.uint32)
    k = rng.integers(0, 4, 2000).astype(np.uint32)
    want = np.asarray(jfate(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(n), jnp.asarray(k)))
    got = fate.device_fault_fate(*(from_numpy_u32(x, "cpu") for x in (hi, lo, n, k)))
    assert (got.numpy() == want).all()


def test_partition_twin_matches_host_cuts():
    layouts = [
        (frozenset([0, 1]), frozenset([2])),
        (frozenset([0]), frozenset([1]), frozenset([2, 3])),
        (frozenset([0, 2]),),
    ]
    for groups in layouts:
        group_of = {node: gi for gi, g in enumerate(groups) for node in g}
        for at, heal in [(0, None), (2, 5), (3, 3), (1, 8)]:
            p = JPartition(at=float(at), heal=None if heal is None else float(heal),
                           groups=groups)
            for src in range(5):
                for dst in range(5):
                    steps = torch.arange(10)
                    got = fate.partition_cuts(group_of.get(src, -1), group_of.get(dst, -1),
                                              steps, at, -1 if heal is None else heal)
                    want = [p.cuts(src, dst, elapsed=float(s)) for s in range(10)]
                    assert got.tolist() == want


def test_fate_mask_twin_matches_the_jax_hook():
    """K19's twin against ``FateLaneHook.apply``: blocked lanes are those
    the JAX hook masks (its valid-in all True) and those past the
    horizon, on the ABD lanes of 64 members' schedules at fuzzed
    counters and steps."""
    from stateright_tpu_torch.models.abd_compiled import AbdCompiled

    cm = AbdCompiled(engine._abd_model(2, "skip_ack"))
    spec = ChaosSpec.from_json(_PARTITIONED)
    scheds = [derive_schedule(3, m, spec, 48) for m in range(64)]
    params_np = engine._member_params(cm.pairs, scheds)
    params = engine.params_on(params_np, "cpu")
    hook = jengine.FateLaneHook(len(cm.pairs))
    jparams = {k: jnp.asarray(v) for k, v in params_np.items()}
    rng = np.random.default_rng(6)
    ctr = rng.integers(0, 200, (64, len(cm.pairs))).astype(np.uint32)
    valid = jnp.ones((len(cm.pairs),), jnp.bool_)
    for t in (0, 7, 30, 47, 48, 60):
        jv = jax.vmap(lambda c, p: hook.apply(t, None, valid, c, p)[0])(
            jnp.asarray(ctr), jparams)
        got = fate.fate_mask(t, from_numpy_u32(ctr, "cpu"), params)
        assert (got.numpy() == ~np.asarray(jv)).all(), t


# --- the host copies ------------------------------------------------------------


def test_schedules_and_specs_match_the_jax_copies():
    for chaos in (_CHAOS, _PARTITIONED):
        for m in (0, 11, 63):
            a = derive_schedule(3, m, ChaosSpec.from_json(chaos), 48)
            b = jderive(3, m, JChaosSpec.from_json(chaos), 48)
            assert a.to_repro() == b.to_repro()
    spec = ChaosSpec.from_json(_PARTITIONED)
    assert spec.to_dict() == JChaosSpec.from_json(_PARTITIONED).to_dict()
    assert json.loads(json.dumps(spec.to_dict())) == spec.to_dict()
    with pytest.raises(ValueError):
        ChaosSpec.from_json('{"drop": 2}')


def test_package_exports_the_jax_names_less_the_replay():
    from stateright_tpu import ensemble as jensemble

    assert sorted(ensemble.__all__) == sorted(set(jensemble.__all__) - {"replay_repro"})
    for name in ensemble.__all__:
        assert getattr(ensemble, name) is not None
    assert fate.rate_threshold(0.1) == (429496730, False)
    assert fate.rate_threshold(1.0) == (0, True)
