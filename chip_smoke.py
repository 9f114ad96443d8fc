#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; any failure exits non-zero:

1. build: compile the four CUDA kernels of ``stateright_tpu_torch/csrc``
   with ``nvcc`` for ``sm_90a`` (one compiler process each, all started
   together) and print the card's name and power limit;
2. per kernel, at the shapes the ``2pc check 10`` main path gives it
   (F = 2**20 states, A = 52 actions, a 2**27-slot table, seeded inputs with
   duplicate and pre-present keys): hold the kernel against its plain-torch
   twin on the same tensors on the card -- bit-equal, these are integer
   functions -- and time kernel, twin and, where one torch call computes
   the same function, that call (CUDA events, after warm-up);
3. ``2pc check 5`` through ``spawn_gpu()``: 8,832 unique / 58,146 states /
   depth 17, its row log, parents and ebits bit-equal to the port's own CPU
   run, every kernel launched;
4. ``2pc check 10`` through ``spawn_gpu()``: 61,515,776 unique at depth 32,
   every kernel launched, the discoveries' paths re-executed on the host;
5. one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last the
   ``{"ok": true, "device": {...}}`` line.

It imports neither ``jax`` nor ``stateright_tpu``, and exits non-zero with
no result line where no CUDA device is visible or the port's package is not
beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
F = 1 << 20  # states per wave at rm=10 (max_frontier)
RM = 10
CAPACITY = 1 << 27
LOG_CAPACITY = 1 << 26  # >= 61,515,776 positions
HBM_BYTES_PER_SEC = 3.35e12  # H100 SXM, NVIDIA data sheet
GOLDEN_RM5 = (8_832, 58_146, 17)
GOLDEN_RM10 = (61_515_776, 32)
SEED = 20261017

KERNELS = (
    # name, source, the JAX function it replaces
    ("device_fp64", "stateright_tpu_torch/csrc/device_fp.cu",
     "stateright_tpu/ops/device_fp.py:52"),
    ("twophase_step", "stateright_tpu_torch/csrc/twophase_step.cu",
     "stateright_tpu/models/twophase_compiled.py:95"),
    ("compact", "stateright_tpu_torch/csrc/compact.cu",
     "stateright_tpu/parallel/wave_common.py:267"),
    ("insert_batch_claim", "stateright_tpu_torch/csrc/hashset.cu",
     "stateright_tpu/parallel/hashset.py:365"),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(torch, fn, reps: int, setup=None) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` runs after two warm-up
    runs; ``setup`` runs before each, outside the timed window."""
    for _ in range(2):
        if setup is not None:
            setup()
        fn()
    total = 0.0
    for _ in range(reps):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def max_abs_err(torch, pairs) -> int:
    """Largest absolute difference over pairs of integer tensors."""
    err = 0
    for a, b in pairs:
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def random_states(torch, gen, f: int, n: int):
    """Packed 2pc rows with every field in range: RM states 0..3, the TM
    state 0..2, random prepared and message bits."""
    from stateright_tpu_torch.ops.u32 import i32

    dev = gen.device
    rm = torch.randint(0, 4, (f, n), generator=gen, device=dev, dtype=torch.int64)
    w0 = (rm << (2 * torch.arange(n, device=dev))).sum(1)
    w0 = w0 | (torch.randint(0, 3, (f,), generator=gen, device=dev) << 24)
    w1 = torch.randint(0, 1 << (2 * n + 2), (f,), generator=gen, device=dev)
    return torch.stack([i32(w0), i32(w1)], dim=1).contiguous()


def probe_bytes(torch, keys, hi, lo, active) -> int:
    """Bytes of table slots the active lanes of an insert probe: from each
    lane's home slot up to the slot that holds its key after the call, 8
    bytes a slot."""
    from stateright_tpu_torch.ops.device_fp import fp64_of
    from stateright_tpu_torch.parallel.hashset import home_slot

    cap = keys.shape[0]
    lane = torch.nonzero(active).flatten()
    key = fp64_of(hi[lane], lo[lane])
    slot = home_slot(hi[lane], lo[lane], cap)
    probes = 0
    while lane.numel():
        probes += lane.numel()
        undone = keys[slot] != key
        key, slot = key[undone], (slot[undone] + 1) & (cap - 1)
        lane = lane[undone]
    return 8 * probes


def phase_kernels(torch):
    """Each kernel against its twin at main-path shapes; returns rows of
    the kernels line keyed by kernel name (launches filled in later)."""
    from stateright_tpu_torch.models.twophase_compiled import (
        twophase_step, twophase_step_plain,
    )
    from stateright_tpu_torch.ops.device_fp import device_fp64, device_fp64_plain
    from stateright_tpu_torch.ops.u32 import i32
    from stateright_tpu_torch.parallel.hashset import (
        HashSet, insert_batch_claim, insert_batch_claim_plain, keys_equal,
        unique_buffer_size,
    )
    from stateright_tpu_torch.parallel.wave_common import compact, compact_plain

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    a = 2 + 5 * RM
    rows = {}

    def row(name, err, ms, plain_ms, nbytes, library_ms=None):
        rows[name] = dict(
            name=name, route="cuda", max_abs_err=err, bit_equal=err == 0,
            ms=ms, kernel_ms=ms, plain_ms=plain_ms,
            bound_ms=nbytes / HBM_BYTES_PER_SEC * 1e3, bound_by="bytes",
            library_ms=library_ms,
        )
        log(f"  {name}: max_abs_err={err} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={rows[name]['bound_ms']:.4f} "
            f"library_ms={library_ms}")
        if err:
            raise AssertionError(f"{name} disagrees with its plain twin")

    # K2 at F states.
    states = random_states(torch, gen, F, RM)
    k2 = twophase_step(states, RM)
    p2 = twophase_step_plain(states, RM)
    torch.cuda.synchronize()
    row("twophase_step", max_abs_err(torch, zip(k2, p2)),
        time_ms(torch, lambda: twophase_step(states, RM), 10),
        time_ms(torch, lambda: twophase_step_plain(states, RM), 2),
        F * 8 + F * a * (8 + 1) + F * 3)
    nexts, valid, _conds = k2
    del p2

    # K1 on the F*A successor rows.
    flat = nexts.view(F * a, 2)
    k1 = device_fp64(flat)
    p1 = device_fp64_plain(flat)
    torch.cuda.synchronize()
    row("device_fp64", max_abs_err(torch, zip(k1, p1)),
        time_ms(torch, lambda: device_fp64(flat), 10),
        time_ms(torch, lambda: device_fp64_plain(flat), 2),
        flat.shape[0] * (8 + 8))
    del k1, p1

    # K3 on the F*A validity lanes into the dd=1 buffer the main path uses.
    mask = valid.view(-1)
    size = unique_buffer_size(F * a, 1)
    k3 = compact(mask, size)
    p3 = compact_plain(mask, size)
    lanes = torch.arange(mask.shape[0], dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    row("compact", max_abs_err(torch, zip(k3, p3)),
        time_ms(torch, lambda: compact(mask, size), 10),
        time_ms(torch, lambda: compact_plain(mask, size), 2),
        mask.shape[0] + size * 4 + 8,
        library_ms=time_ms(torch, lambda: lanes[mask], 10))
    log(f"  compact: {int(k3[1])} of {mask.shape[0]} lanes valid")
    del p3, lanes

    # K4: a 2**27-slot table prefilled with a quarter of its slots' worth of
    # keys, then a main-path-sized batch (one lane per candidate) whose
    # active ~30% draw from a pool twice the prefill: duplicates within the
    # batch and keys already present.
    n = F * a
    pool = torch.randint(
        -(1 << 62), 1 << 62, (CAPACITY // 2,), generator=gen, device=dev
    ) * 2 + 1  # odd: never the empty key 0
    pool_hi, pool_lo = i32(pool >> 32), i32(pool)
    base = HashSet.empty(CAPACITY, dev)
    pre = CAPACITY // 4
    insert_batch_claim(
        base, pool_hi[:pre].contiguous(), pool_lo[:pre].contiguous(),
        torch.ones((pre,), dtype=torch.bool, device=dev),
    )
    pick = torch.randint(0, CAPACITY // 2, (n,), generator=gen, device=dev)
    b_hi, b_lo = pool_hi[pick].contiguous(), pool_lo[pick].contiguous()
    active = torch.rand((n,), generator=gen, device=dev) < 0.3
    saved = base.keys.clone()
    k_table = base
    k_new, k_ok = insert_batch_claim(k_table, b_hi, b_lo, active)
    p_keys = saved.clone()
    p_new, p_ok = insert_batch_claim_plain(p_keys, b_hi, b_lo, active)
    torch.cuda.synchronize()
    same_set = keys_equal(k_table, HashSet(p_keys))
    err = max_abs_err(torch, [(k_new, p_new), (k_ok, p_ok)]) + (0 if same_set else 1)
    # Every lane's active byte read and new byte written; the key words of
    # the active lanes only (the kernel skips the rest); each probed slot
    # once; each new key written once.
    n_active = int(active.sum())
    nbytes = (
        n * (1 + 1)
        + n_active * (4 + 4)
        + probe_bytes(torch, k_table.keys, b_hi, b_lo, active)
        + 8 * int(k_new.sum())
    )
    log(f"  insert_batch_claim: {n_active} active lanes, "
        f"{int(k_new.sum())} new, load after {k_table.load_factor():.4f}")
    del p_keys

    def restore():
        k_table.keys.copy_(saved)

    row("insert_batch_claim", err,
        time_ms(torch, lambda: insert_batch_claim(k_table, b_hi, b_lo, active),
                10, setup=restore),
        time_ms(torch, lambda: insert_batch_claim_plain(
            k_table.keys, b_hi, b_lo, active), 2, setup=restore),
        nbytes)
    return rows


def reset_launches():
    for fn in launch_counted():
        fn.launches = 0


def launch_counted():
    from stateright_tpu_torch.models.twophase_compiled import twophase_step
    from stateright_tpu_torch.ops.device_fp import device_fp64
    from stateright_tpu_torch.parallel.hashset import insert_batch_claim
    from stateright_tpu_torch.parallel.wave_common import compact

    return (device_fp64, twophase_step, compact, insert_batch_claim)


def read_launches():
    counts = {fn.__name__: fn.launches for fn in launch_counted()}
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return counts


def snapshot_logs(checker, tmpdir, tag):
    import numpy as np

    path = os.path.join(tmpdir, f"{tag}.npz")
    checker.save_snapshot(path)
    with np.load(path) as snap:
        tail = int(snap["tail"])
        return {
            "rows": snap["rows"][: 2 * tail].copy(),
            "parent": snap["parent"][:tail].copy(),
            "ebits": snap["ebits"][:tail].copy(),
        }


def phase_rm5(torch):
    from stateright_tpu_torch.models.twophase import TwoPhaseSys

    kw = dict(capacity=1 << 14, max_frontier=1 << 9)
    reset_launches()
    gpu = TwoPhaseSys(rm_count=5).checker().spawn_gpu(**kw).join()
    launches = read_launches()
    cpu = TwoPhaseSys(rm_count=5).checker().spawn_gpu(device="cpu", **kw).join()
    got = (gpu.unique_state_count(), gpu.state_count(), gpu.max_depth())
    log(f"  rm=5 on the card: unique={got[0]} states={got[1]} depth={got[2]} "
        f"launches={launches}")
    if got != GOLDEN_RM5:
        raise AssertionError(f"rm=5 counts {got} != {GOLDEN_RM5}")
    with tempfile.TemporaryDirectory() as tmp:
        g, c = snapshot_logs(gpu, tmp, "gpu"), snapshot_logs(cpu, tmp, "cpu")
    for k in g:
        if g[k].shape != c[k].shape or not (g[k] == c[k]).all():
            raise AssertionError(f"rm=5 {k} differs between card and CPU runs")
    if sorted(gpu.discoveries()) != sorted(cpu.discoveries()):
        raise AssertionError("rm=5 discoveries differ between card and CPU")
    if not (gpu.discovered_fingerprints() == cpu.discovered_fingerprints()).all():
        raise AssertionError("rm=5 fingerprints differ between card and CPU")
    gpu.assert_properties()
    log("  rm=5: row log, parents and ebits bit-equal to the CPU run")


def run_rm10(torch):
    """``2pc check 10`` through ``spawn_gpu()`` at the slice's geometry,
    held to its goldens; returns the joined checker and its wall seconds.
    ``gpu_profile.py`` times and traces this same run."""
    from stateright_tpu_torch.models.twophase import TwoPhaseSys

    torch.cuda.synchronize()
    t0 = time.monotonic()
    checker = TwoPhaseSys(rm_count=RM).checker().spawn_gpu(
        capacity=CAPACITY, log_capacity=LOG_CAPACITY, max_frontier=F,
        dedup_factor=1,
    ).join()
    elapsed = time.monotonic() - t0
    got = (checker.unique_state_count(), checker.max_depth())
    if got != GOLDEN_RM10:
        raise AssertionError(f"rm=10 {got} != {GOLDEN_RM10}")
    return checker, elapsed


def phase_rm10(torch, gpu):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    checker, elapsed = run_rm10(torch)
    launches = read_launches()
    unique, depth = checker.unique_state_count(), checker.max_depth()
    peak = torch.cuda.max_memory_allocated()
    log(f"  rm=10: unique={unique} states={checker.state_count()} "
        f"depth={depth} waves={checker.waves()} elapsed_s={elapsed:.3f} "
        f"unique_per_s={unique / elapsed:.1f} peak_bytes={peak} "
        f"load={checker.table_load_factor():.4f} card={gpu!r}")
    log(f"  rm=10 launches: {launches}")
    checker.assert_properties()
    paths = {k: len(p) - 1 for k, p in checker.discoveries().items()}
    log(f"  rm=10 discoveries re-executed: {paths}")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "stateright_tpu_torch")):
        print("chip_smoke: run from a checkout (stateright_tpu_torch/ is "
              "missing beside the script)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from stateright_tpu_torch.ops import cuda as kcuda

    t_start = time.monotonic()
    log("phase 1: build")
    t0 = time.monotonic()
    secs = kcuda.build()
    log(f"  built {sorted(secs)} in {time.monotonic() - t0:.1f}s "
        f"(per source: {', '.join(f'{k}={v:.1f}s' for k, v in secs.items())})")
    gpu = gpu_line()
    log(f"  card: {gpu}")
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    log("phase 2: kernels against their plain twins at main-path shapes")
    rows = phase_kernels(torch)
    torch.cuda.empty_cache()

    log("phase 3: 2pc check 5 on the card")
    phase_rm5(torch)

    log("phase 4: 2pc check 10 on the card")
    launches = phase_rm10(torch, gpu)

    log(f"all phases passed in {time.monotonic() - t_start:.1f}s")
    kernels = []
    for name, source, replaces in KERNELS:
        r = rows[name]
        kernels.append(dict(
            name=name, route=r["route"], source=source, replaces=replaces,
            launches=launches[name], max_abs_err=r["max_abs_err"],
            bit_equal=r["bit_equal"], ms=r["ms"], kernel_ms=r["kernel_ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
        ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
