"""The port on the card, and what needs no JAX at all.

This file imports neither ``jax`` nor ``stateright_tpu``, so it runs on
the machine with the card, where JAX is not installed:

    python -m pytest -m cuda tests/test_torch_device.py

The ``cuda`` tests hold each hand-written kernel against its plain-torch
twin on the same tensors on the card, and the engine's card run against
its CPU run.  They decide inside the test whether a card is present, so
every worker collects the same tests; here they skip.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from stateright_tpu_torch.models.twophase import TwoPhaseSys
from stateright_tpu_torch.models.twophase_compiled import (
    twophase_step, twophase_step_plain,
)
from stateright_tpu_torch.ops.device_fp import device_fp64, device_fp64_plain
from stateright_tpu_torch.ops.u32 import from_numpy_u32
from stateright_tpu_torch.parallel.hashset import (
    HashSet, insert_batch_claim, insert_batch_claim_plain, keys_equal,
)
from stateright_tpu_torch.parallel.wave_common import compact, compact_plain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRY = dict(capacity=1 << 14, max_frontier=1 << 9)


def _t(a, device):
    return from_numpy_u32(a, device)


def _random_rows(rng, n, count):
    """Encodable packed 2pc rows: every field in range."""
    rm = rng.integers(0, 4, size=(count, n), dtype=np.uint64)
    w0 = (rm << (2 * np.arange(n, dtype=np.uint64))).sum(1)
    w0 |= rng.integers(0, 3, size=count, dtype=np.uint64) << np.uint64(24)
    w1 = rng.integers(0, 1 << (2 * n + 2), size=count, dtype=np.uint64)
    return np.stack([w0, w1], 1).astype(np.uint32)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import stateright_tpu_torch\n"
        "from stateright_tpu_torch.models.twophase import TwoPhaseSys\n"
        "c = TwoPhaseSys(rm_count=3).checker().spawn_gpu(device='cpu').join()\n"
        "assert c.unique_state_count() == 288\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'stateright_tpu' or m.startswith('stateright_tpu.'))\n"
        "assert not bad, bad\n"
        "print('isolated')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "isolated"


def test_spawn_gpu_defaults_to_the_card():
    """No device means CUDA: with no card the spawn raises instead of
    carrying on on the CPU; with one, rm=3 runs there."""
    builder = TwoPhaseSys(rm_count=3).checker()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            builder.spawn_gpu()
        return
    assert builder.spawn_gpu().join().unique_state_count() == 288


def test_port_snapshot_resumes_in_the_port(tmp_path):
    """save_snapshot -> resume_from round trip inside the port: a run cut
    by target_state_count(3000) and resumed ends bit-equal to a straight
    run (the JAX-snapshot direction is in test_torch_engine.py)."""
    model = TwoPhaseSys(rm_count=5)
    geometry = dict(device="cpu", capacity=1 << 15, max_frontier=1 << 7)
    partial = model.checker().target_state_count(3000).spawn_gpu(**geometry).join()
    assert 3000 <= partial.state_count() < 58146
    snap = tmp_path / "partial.npz"
    partial.save_snapshot(str(snap))
    resumed = model.checker().spawn_gpu(resume_from=str(snap), **geometry).join()
    straight = model.checker().spawn_gpu(**geometry).join()
    assert (resumed.unique_state_count(), resumed.state_count(), resumed.max_depth()) == (
        straight.unique_state_count(), straight.state_count(), straight.max_depth()
    )
    for a, b in zip(_logs(resumed, tmp_path / "r.npz"), _logs(straight, tmp_path / "s.npz")):
        assert np.array_equal(a, b)
    assert sorted(resumed.discoveries()) == sorted(straight.discoveries())


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _logs(checker, path):
    checker.save_snapshot(str(path))
    with np.load(path) as snap:
        tail = int(snap["tail"])
        return [snap[k][: tail * w].copy() for k, w in
                (("rows", 2), ("parent", 1), ("ebits", 1))]


@pytest.mark.cuda
def test_cuda_engine_matches_cpu_run(tmp_path):
    _card()
    model = TwoPhaseSys(rm_count=5)
    gpu = model.checker().spawn_gpu(device="cuda", **GEOMETRY).join()
    cpu = model.checker().spawn_gpu(device="cpu", **GEOMETRY).join()
    assert (gpu.unique_state_count(), gpu.state_count(), gpu.max_depth()) == (
        8832, 58146, 17
    )
    g, c = _logs(gpu, tmp_path / "gpu.npz"), _logs(cpu, tmp_path / "cpu.npz")
    for a, b in zip(g, c):
        assert np.array_equal(a, b)
    assert np.array_equal(gpu.discovered_fingerprints(), cpu.discovered_fingerprints())
    gpu.assert_properties()


@pytest.mark.cuda
def test_cuda_device_fp64_matches_twin():
    dev = _card()
    rng = np.random.default_rng(21)
    for width in (1, 2, 5, 42):
        words = _t(
            rng.integers(0, 2**32, size=(70_000, width), dtype=np.uint32), dev
        )
        for k, p in zip(device_fp64(words), device_fp64_plain(words)):
            assert torch.equal(k, p)


@pytest.mark.cuda
def test_cuda_twophase_step_matches_twin():
    dev = _card()
    rng = np.random.default_rng(22)
    for n in (3, 10, 12):
        rows = _t(_random_rows(rng, n, 50_000), dev)
        for k, p in zip(twophase_step(rows, n), twophase_step_plain(rows, n)):
            assert torch.equal(k, p)


@pytest.mark.cuda
def test_cuda_compact_matches_twin():
    dev = _card()
    rng = np.random.default_rng(23)
    for b in (1, 2047, 2048, 2049, 1_000_003):
        mask = torch.from_numpy(rng.random(b) < 0.4).to(dev)
        n_valid = int(mask.sum())
        for size in {max(n_valid - 1, 0), n_valid, n_valid + 1, b}:
            k_out, k_count = compact(mask, size)
            p_out, p_count = compact_plain(mask, size)
            assert torch.equal(k_out, p_out)
            assert int(k_count) == int(p_count) == n_valid


@pytest.mark.cuda
def test_cuda_insert_batch_claim_matches_twin():
    dev = _card()
    rng = np.random.default_rng(24)
    cap = 1 << 20
    k_table = HashSet.empty(cap, dev)
    p_keys = torch.zeros(cap, dtype=torch.int64, device=dev)
    for _ in range(4):
        keys = rng.integers(1, 2**40, size=300_000, dtype=np.uint64)
        dup = rng.random(300_000) < 0.5
        keys[dup] = rng.integers(1, 2**16, size=int(dup.sum()), dtype=np.uint64)
        hi = _t((keys >> np.uint64(32)).astype(np.uint32), dev)
        lo = _t((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32), dev)
        active = torch.from_numpy(rng.random(300_000) < 0.7).to(dev)
        k_new, k_ok = insert_batch_claim(k_table, hi, lo, active)
        p_new, p_ok = insert_batch_claim_plain(p_keys, hi, lo, active)
        assert torch.equal(k_new, p_new) and bool(k_ok) and bool(p_ok)
        assert keys_equal(k_table, HashSet(p_keys))
