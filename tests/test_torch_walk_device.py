"""K18 (the device walk) and K19 (the ensemble's fate mask) on the card.

Imports no JAX (the machine with the card has none): every kernel is held
to its plain-torch twin on CUDA tensors -- whole walk batches (2pc, the
trap counter's eventually pass, LWW with flagged walkers, lossy ping-pong
with its boundary, the ABD ensemble with its fault hook), K19 on fuzzed
parameters and counters, the per-state step flags of K9-K11 and K14, and
the entry points' goldens (the JAX engine's rounds).  Skipped without a
card: ``python -m pytest -m cuda tests/test_torch_walk_device.py -q``.
"""

import numpy as np
import pytest
import torch

from stateright_tpu_torch.ensemble import engine, fate
from stateright_tpu_torch.ensemble.schedule import derive_schedule
from stateright_tpu_torch.ops import prng
from stateright_tpu_torch.ops.u32 import from_numpy_u32
from stateright_tpu_torch.parallel import simulation_gpu as sg
from stateright_tpu_torch.runtime.chaos import ChaosSpec

pytestmark = pytest.mark.cuda

_PARTITIONED = (
    '{"default": {"drop": 0.15, "reorder": 0.1}, "partitions": '
    '[{"at": 0.1, "heal": 0.5, "groups": [[0], [1, 2, 3]]}]}'
)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _model(name):
    if name == "2pc":
        from stateright_tpu_torch.models.twophase import TwoPhaseSys

        return TwoPhaseSys(rm_count=6), 48
    if name == "trap":
        from stateright_tpu_torch.models.fixtures import TrapCounter

        return TrapCounter(limit=5, trap_at=2), 32
    if name == "lww":
        from stateright_tpu_torch.models.lww_register import build_model

        return build_model(2), 8
    from stateright_tpu_torch.models.ping_pong import PingPongCfg

    return PingPongCfg(False, 5).into_model().lossy_network_(True), 48


def _batch(walk, keys, params=None):
    return [x.cpu() for x in walk(keys, params)]


@pytest.mark.parametrize("name", ["2pc", "trap", "lww", "pingpong"])
def test_walk_batch_equals_the_twins(card, name):
    from stateright_tpu_torch.parallel.compiled import compiled_model_for

    model, t = _model(name)
    cm = compiled_model_for(model)
    keys = sg.walker_keys(prng.fold_in(prng.prng_key(5), 0), 0, 4096, card)
    assert torch.equal(keys.cpu(), sg.walker_keys_plain(prng.fold_in(prng.prng_key(5), 0), 0, 4096))
    got = _batch(sg.build_walk(cm, model.properties(), t), keys)
    want = _batch(sg.build_walk(cm, model.properties(), t, plain=True), keys)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[2].sum()) > 4096
    if name == "lww":
        assert got[4].any() and not got[4].all()


def test_ensemble_walk_equals_the_twins(card):
    from stateright_tpu_torch.models.abd_compiled import AbdCompiled

    model = engine._abd_model(2, "skip_ack")
    cm = AbdCompiled(model)
    spec = ChaosSpec.from_json(_PARTITIONED)
    scheds = [derive_schedule(3, m, spec, 48) for m in range(2048)]
    params = engine.params_on(engine._member_params(cm.pairs, scheds), card)
    keys = sg.walker_keys(prng.prng_key(3), 0, 2048, card)
    hook = engine.FateLaneHook(len(cm.pairs))
    got = _batch(sg.build_walk(cm, model.properties(), 48, fault_hook=hook), keys, params)
    want = _batch(sg.build_walk(cm, model.properties(), 48, fault_hook=hook, plain=True),
                  keys, params)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_fate_mask_equals_its_twin_on_fuzzed_lanes(card):
    rng = np.random.default_rng(5)
    k, lanes = 4096, 12
    params = {}
    for name in ("link_hi", "link_lo", "drop_thr", "reorder_thr"):
        params[name] = from_numpy_u32(rng.integers(0, 1 << 32, (k, lanes)), card)
    for name in ("drop_always", "reorder_always"):
        params[name] = torch.from_numpy(rng.random((k, lanes)) < 0.05).to(card)
    for name in ("src_group", "dst_group"):
        params[name] = torch.from_numpy(rng.integers(-1, 3, (k, lanes)).astype(np.int32)).to(card)
    params["part_at"] = torch.from_numpy(rng.integers(0, 10, k).astype(np.int32)).to(card)
    params["part_heal"] = torch.from_numpy(rng.integers(-1, 20, k).astype(np.int32)).to(card)
    params["horizon"] = torch.from_numpy(rng.integers(0, 20, k).astype(np.int32)).to(card)
    ctr = from_numpy_u32(rng.integers(0, 1 << 32, (k, lanes)), card)
    for t in (0, 5, 12, 25):
        assert torch.equal(fate.fate_mask(t, ctr, params).cpu(),
                           fate.fate_mask_plain(t, ctr, params).cpu())


def test_step_flags_per_state_equal_the_twins(card):
    """K9-K11 write a flag byte a state and K14's lanes reduce per state:
    each equals its twin's per-state flag, on rows that flag and rows
    that do not."""
    from stateright_tpu_torch.models import abd_compiled as ac
    from stateright_tpu_torch.models import raft_compiled as rc

    from .test_torch_device import abd_fuzz_rows, raft_fuzz_rows

    rows = from_numpy_u32(abd_fuzz_rows(np.random.default_rng(3), 4096, 2, True), card)
    got = ac.abd_step(rows, 2, True, True, flag_rows=True)
    want = ac.abd_step_plain(rows, 2, True, True, flag_rows=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[3].any() and not got[3].all()
    rows = from_numpy_u32(raft_fuzz_rows(np.random.default_rng(17), 2000), card)
    got = rc.raft_step(rows, 1, flag_rows=True)
    want = rc.raft_step_plain(rows, 1, flag_rows=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[3].any() and not got[3].all()


def test_entry_points_give_the_jax_rounds(card):
    from stateright_tpu_torch.models.twophase import TwoPhaseSys

    c = TwoPhaseSys(rm_count=10).checker().target_state_count(1).spawn_gpu_simulation(
        seed=3, walkers=4096, max_trace_len=64).join()
    assert (c.state_count(), c.max_depth(), sorted(c.discoveries())) == (
        44_108, 23, ["abort agreement"])
    r = engine.run_ensemble(members=1024, seed=7, steps=48, fault="skip_ack",
                            chaos='{"default": {"drop": 0.1}}', replay=False)
    assert (r.states_walked, len(r.failing), r.shrink_steps) == (8_943, 939, 2)
    assert (r.repro["member"], r.repro["steps"]) == (2, 5)
