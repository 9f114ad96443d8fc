#!/usr/bin/env python3
"""Where the time of a full check goes on one H100.

    python3 gpu_profile.py [--model rm10|paxos3|paxos6|sc4|abd2|abd3o|raft|
                                    pp13|pp11s|paxos3b|raft10s|sym12|
                                    lww2d7|sh-rm10|sh-paxos3|sim-rm10|
                                    sim-raft|ens-abd|
                                    tiered-paxos3|tiered-raft[,...]]
                           [--runs N] [--trace-dir DIR] [--tree DIR]

Builds the port's kernels, runs one of ``chip_smoke.py``'s full checks
through ``spawn_gpu()`` at its geometry, held to its goldens --
``run_rm10`` (``2pc check 10``, phase 4), ``run_paxos3`` (``paxos check
3``, phase 6), ``run_paxos6`` (``paxos check 6``, phase 10) or ``run_sc4``
(``single-copy-register check 4``, phase 13), ``run_abd2``
(``linearizable-register check 2``, phase 15), ``run_abd3o``
(``linearizable-register check 3 ordered``, phase 17), ``run_raft``
(``raft check``, depth 12, phase 20), ``run_pp13`` (lossy ping-pong at
``max_nat`` 13, phase 22), ``run_pp11s`` (lossy ping-pong at ``max_nat`` 11
through the sorted fallback, phase 23), ``run_paxos3b`` (``paxos check
3`` at ``max_round=3``, single-phase, phase 25), ``run_raft10s`` (raft to
depth 10 through the sorted fallback, phase 26), ``run_sym12`` (``2pc
check-sym 12``, phase 27) or ``run_lww`` (the LWW register, 2 nodes to
depth 7, phase 29) -- or ``sh-rm10`` (``2pc check 10`` on four shards of
the card, ``spawn_gpu_sharded``, phase 53) or ``sh-paxos3`` (``paxos check
3`` on four shards, phase 52, where K26's card time is least hidden) --
or one of the device walk's:
``sim-rm10`` (2pc rm=10
through ``spawn_gpu_simulation``, one round of 2**18 walkers at T = 64),
``sim-raft`` (raft at depth 12, 2**16 walkers a round to 10M states,
``run_sim_raft_wide``, phase 32) or ``ens-abd`` (``run_ensemble`` over
2**16 ABD members, phase 33), whose rate is states walked per second --
or one of the tiered checker's: ``tiered-paxos3`` (``paxos check 3``
under a 2 MB budget, ``run_tiered_paxos3``, phase 34) or ``tiered-raft``
(``raft check`` under 64 MB, ``run_tiered_raft``, phase 37), for which the
host's cold filter (windowing, chunk copies, K20's launches and the fresh
count's readback: the ``cold_probe_sec_total`` metric), the copies by
direction (host to card, card to host, on the card) and K20's kernels
are shown apart; for ``sh-rm10`` and ``sh-paxos3`` the profiled run's
waves, retries, grows and host seconds by span -- ``--runs`` times
untraced (wall seconds of each, then median and spread), and once more
under ``torch.profiler``: device time and calls per kernel name, the card's busy
share of the traced run's wall time, and, with ``--trace-dir``, a Chrome
trace written there.  The traced run pays the
profiler's overhead; the untraced runs are the measurement.  A search's
line also carries its stats readbacks and the waves it ran (one readback a
wave for a checker with no fused quantum).  ``--model`` takes a
comma-separated list, run in turn in one process; ``--tree`` profiles the
checkout at DIR (its ``chip_smoke.py`` and package) instead of this one,
so two commits compare on one card in one call.  Prints one JSON line per
model, then one JSON line of them all last.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def run_sim_rm10_wide(torch):
    """2pc rm=10 through ``spawn_gpu_simulation``: one round of 2**18
    walkers at T = 64, seed 3."""
    import time

    import chip_smoke
    from stateright_tpu_torch.models.twophase import TwoPhaseSys

    torch.cuda.synchronize()
    t0 = time.monotonic()
    checker = TwoPhaseSys(rm_count=chip_smoke.RM).checker().target_state_count(1) \
        .spawn_gpu_simulation(seed=3, walkers=chip_smoke.SIM_RM10_WIDE,
                              max_trace_len=64).join()
    return checker, time.monotonic() - t0


def run_sh_rm10(torch):
    """``2pc check 10`` on four shards of the card (phase 53)."""
    import chip_smoke
    from stateright_tpu_torch.models.twophase import TwoPhaseSys

    _launches, checker, elapsed = chip_smoke.run_sharded(
        torch, chip_smoke.gpu_line(), "sh-rm10",
        TwoPhaseSys(rm_count=chip_smoke.RM).checker,
        dict(mesh=chip_smoke.sharded_mesh(), **chip_smoke.SH_RM10),
        chip_smoke.GOLDEN_RM10)
    return checker, elapsed


def run_sh_paxos3(torch):
    """``paxos check 3`` on four shards of the card (phase 52)."""
    import chip_smoke

    _launches, checker, elapsed = chip_smoke.run_sharded(
        torch, chip_smoke.gpu_line(), "sh-paxos3",
        chip_smoke.paxos_model(3).checker,
        dict(mesh=chip_smoke.sharded_mesh(), **chip_smoke.SH_PAXOS3),
        chip_smoke.GOLDEN_PAXOS3)
    return checker, elapsed


def is_search(run) -> bool:
    """A search (single-card or sharded), not a walk or an ensemble."""
    return hasattr(run, "waves") or hasattr(run, "accounting")


def count_of(run) -> int:
    """The states a run checked: unique states of a search, states walked
    by a walk or an ensemble."""
    if hasattr(run, "states_walked"):
        return run.states_walked
    if is_search(run):
        return run.unique_state_count()
    return run.state_count()


def calls_of(run) -> str:
    if hasattr(run, "accounting"):
        return f"{run.accounting()['waves']} waves"
    if hasattr(run, "waves"):
        return f"{run.waves()} waves"
    if hasattr(run, "rounds"):
        return f"{run.rounds()} rounds"
    return f"{run.dispatches} sweep"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="rm10")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--tree", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("gpu_profile: no CUDA device is visible", file=sys.stderr)
        return 2
    root = os.path.abspath(args.tree) if args.tree else HERE
    sys.path.insert(0, root)
    import chip_smoke
    from stateright_tpu_torch.ops import cuda

    cuda.build()
    card = chip_smoke.gpu_line()
    results = []
    for model in args.model.split(","):
        results.append(profile_model(torch, chip_smoke, model, args, card, root))
    print(json.dumps(results), flush=True)
    return 0


MODELS = ("rm10", "paxos3", "paxos6", "sc4", "abd2", "abd3o", "raft", "pp13",
          "pp11s", "paxos3b", "raft10s", "sym12", "lww2d7", "sh-rm10",
          "sh-paxos3", "sim-rm10", "sim-raft",
          "ens-abd", "tiered-paxos3", "tiered-raft")


def profile_model(torch, chip_smoke, model, args, card, root) -> dict:
    """One model's warm runs and profiled run; prints its lines and
    returns its JSON record."""
    if model not in MODELS:
        raise SystemExit(f"gpu_profile: unknown model {model!r}")
    run = {
        "rm10": chip_smoke.run_rm10,
        "paxos3": chip_smoke.run_paxos3,
        "paxos6": chip_smoke.run_paxos6,
        "sc4": chip_smoke.run_sc4,
        "abd2": chip_smoke.run_abd2,
        "abd3o": chip_smoke.run_abd3o,
        "raft": chip_smoke.run_raft,
        "pp13": chip_smoke.run_pp13,
        "pp11s": chip_smoke.run_pp11s,
        "paxos3b": chip_smoke.run_paxos3b,
        "raft10s": chip_smoke.run_raft10s,
        "sym12": chip_smoke.run_sym12,
        "lww2d7": chip_smoke.run_lww,
        "sh-rm10": run_sh_rm10,
        "sh-paxos3": run_sh_paxos3,
        "sim-rm10": run_sim_rm10_wide,
        "sim-raft": chip_smoke.run_sim_raft_wide,
        "ens-abd": lambda torch: chip_smoke.run_ens(torch, chip_smoke.ENS_WIDE),
        "tiered-paxos3": chip_smoke.run_tiered_paxos3,
        "tiered-raft": chip_smoke.run_tiered_raft,
    }[model]
    print(f"card: {card}; model {model}; tree {root}", flush=True)

    unique = count_of(run(torch)[0])  # warm-up: library loads, pools
    times = []
    for i in range(args.runs):
        checker, elapsed = run(torch)
        times.append(elapsed)
        print(f"run {i}: {elapsed:.4f} s, {calls_of(checker)}, "
              f"{unique / elapsed:.1f} {'unique' if is_search(checker) else 'walked'} "
              "states/s", flush=True)
    q = statistics.quantiles(times, n=4) if len(times) > 1 else [times[0]] * 3

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _checker, traced_s = run(torch)
    trace = None
    if args.trace_dir is not None:
        os.makedirs(args.trace_dir, exist_ok=True)
        trace = os.path.join(args.trace_dir, f"{model}_trace.json")
        prof.export_chrome_trace(trace)
    # Device-side events only (kernels, copies, fills): the CPU ops that
    # launched them report the same time again.  One stream, so the sum
    # is the busy time.
    by_name, calls_by_name = {}, {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + evt.self_device_time_total / 1e3
            calls_by_name[evt.key] = calls_by_name.get(evt.key, 0) + evt.count
    busy_ms = sum(by_name.values())
    median = statistics.median(times)
    print(f"traced run: {traced_s:.4f} s wall, device busy {busy_ms:.1f} ms; "
          f"busy share {busy_ms / 1e3 / median:.3f} of the untraced median "
          f"{median:.4f} s; trace {trace}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:25]
    for name, ms in top:
        print(f"  {ms:9.2f} ms  {calls_by_name[name]:8d} calls  "
              f"{ms / calls_by_name[name]:.5f} ms each  {name[:100]}")
    tiered = {}
    if model.startswith("tiered-"):
        m = _checker.metrics()
        tiered = {
            "spills": m.get("spills", 0),
            "cold_probe_passes": m.get("cold_probe_passes_total", 0),
            "cold_filter_host_s": m.get("cold_probe_sec_total", 0.0),
            # Copies by direction (the profiler's "Memcpy HtoD (...)"
            # names): HtoD carries the cold chunks, DtoH the readbacks and
            # the spills' segment fingerprints, DtoD copies on the card.
            **{f"{d.lower()}_copy_ms": sum(v for k, v in by_name.items()
                                           if k.startswith("Memcpy " + d))
               for d in ("HtoD", "DtoH", "DtoD")},
            "k20_ms": sum(v for k, v in by_name.items()
                          if "query_kernel" in k or "probe_kernel" in k),
            "max_frontier": m["max_frontier"],
        }
        print(f"tiered: {tiered}")
    sharded = {}
    if hasattr(_checker, "accounting"):
        # What sets a sharded run's host time: its waves, the retries and
        # grows that re-run waves, and the untraced loop's host spans
        # (seconds summed over the run, the density tuners' ``retune``
        # among them) -- of the profiled run.
        acc = _checker.accounting()
        m = _checker.metrics()
        sharded = {
            **{k: acc[k] for k in ("waves", "sort_lanes", "step_lanes",
                                   "sort_retries", "step_retries",
                                   "bucket_retries")},
            "grows": m.get("grows", 0),
            "overflow_retries": m.get("overflow_retries", 0),
            "host_sec_total": m.get("host_sec_total", 0.0),
            "host_span_sec": {
                k[len("host_"):-len("_sec")]: h["sum"]
                for k, h in m["histograms"].items()
                if k.startswith("host_") and k.endswith("_sec")
            },
        }
        print(f"sharded: {sharded}")
    calls = {}
    if hasattr(_checker, "waves"):
        waves = getattr(_checker, "_waves_run", None)
        calls = {
            "waves_run": _checker.waves() if waves is None else waves,
            "readbacks": getattr(_checker, "_readbacks", _checker.waves()),
        }
    record = {
        "card": card,
        "tree": root,
        "model": model,
        **calls,
        "runs_s": times,
        "median_s": median,
        "quartiles_s": [q[0], q[2]],
        ("unique_per_s_median" if is_search(_checker)
         else "walked_per_s_median"): unique / median,
        "traced_s": traced_s,
        "device_busy_ms": busy_ms,
        "device_busy_share_of_median": busy_ms / 1e3 / median,
        "device_ms_by_kernel": dict(top),
        "device_calls_by_kernel": {name: calls_by_name[name] for name, _ in top},
        **({"tiered": tiered} if tiered else {}),
        **({"sharded": sharded} if sharded else {}),
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    sys.exit(main())
