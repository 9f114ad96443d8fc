#!/usr/bin/env python3
"""Where a host-bound sharded check spends its host time on one H100.

    python3 host_profile.py [--tree DIR] [--label NAME] [--no-profile]
                            [--out FILE]

Builds the port's kernels from the checkout at DIR (default: this one),
then on the card: K12's host issue time a call (2,000 calls of each entry
of ``prededup`` on a 106,496-lane batch with 27,000 active lanes, sh-rm10's
sender width, timed without a sync and then drained), one run of
``chip_smoke.py``'s sh-rm10 (``2pc check 10`` on four shards of the card)
under ``cProfile`` (its functions by own and by cumulative time; skipped
with ``--no-profile``), and one plain timed run.  Unlike ``gpu_profile.py``
it runs no ``torch.profiler``, whose post-processing of a 7,537-wave run
takes minutes, so parent and change can alternate in one call.  Prints
its lines, and writes them to FILE too with ``--out``.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--label", default="run")
    ap.add_argument("--no-profile", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("host_profile: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    import chip_smoke
    from stateright_tpu_torch.models.twophase import TwoPhaseSys
    from stateright_tpu_torch.ops import cuda
    from stateright_tpu_torch.parallel import hashset as hs

    cuda.build()
    out = open(args.out, "w") if args.out else None

    def say(*a):
        print(*a, flush=True)
        if out is not None:
            print(*a, file=out, flush=True)

    say(args.label, "tree", os.path.abspath(args.tree), chip_smoke.gpu_line())
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(3)
    n, m = 106_496, 27_000
    hi = torch.randint(-2**31, 2**31 - 1, (n,), generator=g, dtype=torch.int32).to(dev)
    lo = torch.randint(-2**31, 2**31 - 1, (n,), generator=g, dtype=torch.int32).to(dev)
    act = torch.arange(n, device=dev) < m
    cnt = torch.tensor(m, device=dev)
    entries = [("prededup(mask)", lambda: hs.prededup(hi, lo, act, 1))]
    if hasattr(hs, "prededup_prefix"):  # the parent tree has no prefix entry
        entries.append(("prededup_prefix", lambda: hs.prededup_prefix(hi, lo, cnt, 1)))
    for name, fn in entries:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        k = 2000
        t0 = time.perf_counter()
        for _ in range(k):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        say(f"{name}: host issue {1e3 * (t1 - t0) / k:.4f} ms a call, "
            f"issue+drain {1e3 * (t2 - t0) / k:.4f} ms a call")

    def run():
        torch.cuda.synchronize()
        t0 = time.monotonic()
        ck = TwoPhaseSys(rm_count=chip_smoke.RM).checker().spawn_gpu_sharded(
            mesh=chip_smoke.sharded_mesh(), **chip_smoke.SH_RM10).join()
        torch.cuda.synchronize()
        return ck, time.monotonic() - t0

    if not args.no_profile:
        prof = cProfile.Profile()
        prof.enable()
        ck, sec = run()
        prof.disable()
        say(f"profiled run {sec:.3f} s, unique {ck.unique_state_count()}, "
            f"waves {ck.accounting()['waves']}")
        for key, count in (("tottime", 35), ("cumulative", 45)):
            s = io.StringIO()
            pstats.Stats(prof, stream=s).sort_stats(key).print_stats(count)
            say(s.getvalue())
        del ck
        torch.cuda.empty_cache()
    ck, sec = run()
    say(f"timed run {sec:.3f} s, unique {ck.unique_state_count()}, "
        f"waves {ck.accounting()['waves']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
