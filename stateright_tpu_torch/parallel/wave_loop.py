"""The host wave loop: run a wave, publish its counts, grow on overflow,
stop when the search is done.

The counterpart of the quantum loop of ``stateright_tpu/parallel/
wave_loop.py`` (``FusedWaveLoop``, ``loop_should_break``) and its
``fingerprints_of_rows``.  The JAX loop runs up to ``waves_per_call`` waves
inside one device program between stats readbacks; this port reads one
small stats tensor back per wave, and checks before each wave what the JAX
program checks in its loop condition.  The flag-4 rules of the sort-rung
ladder and the sorted fallback are ported below (without their journal
lines), and so are the wall deadline of a builder ``timeout`` and a
``request_stop``; the step-rung ladder, the density tuner, vitals, the
journal, the knob cache and checkpoint cadence are not.

The engine adapter (the checker) provides:

- ``_wl_can_wave() -> bool`` -- the JAX loop condition: the level is not
  drained, the next level is within ``target_max_depth`` and the device
  mirror of ``finish_when`` does not match yet;
- ``_wl_wave() -> int`` -- run one wave; it commits iff the returned
  overflow flags are 0, and leaves the carry exactly as it was otherwise;
- ``_wl_publish()`` -- copy the carry's counts to the checker surface;
- ``_wl_grow(flags)`` -- grow the tripped buffers in place and rebuild the
  table from the committed log (raises when a knob cannot grow);
- ``_wl_remaining() / _wl_depth()``, ``stop_requested()`` and the checker
  attributes ``_options``, ``_properties``, ``_state_count`` and
  ``_discovery_slots``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..ops.device_fp import device_fp64

# 1 = table overfull (probe failure or past 50% load), 2 = row log full,
# 4 = compaction buffer overflow: all grow in place.  8 = the model's
# packed encoding overflowed, which no growth can fix.
RETRYABLE_FLAGS = 1 | 2 | 4

# The sort-geometry rung ladder (JAX ``wave_loop.py:93-166``): a rung is a
# power-of-two compaction width below the worst-case buffer U; a wave whose
# valid lanes exceed it raises the non-committing flag 4 and the host
# climbs one rung (x2, capped at U).
SORT_RUNG_MIN = 256


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def clamp_rung(requested: int, min_rung: int) -> int:
    """A requested rung normalized onto the ladder: the next power of two,
    floored at ``min_rung``."""
    return max(min_rung, _pow2_ceil(max(1, int(requested))))


def clamp_sort_lanes(requested: int) -> int:
    return clamp_rung(requested, SORT_RUNG_MIN)


def next_rung(cur: int, full: int, min_rung: int) -> Optional[int]:
    """The next rung up (doubling, capped at ``full``), or None when the
    rung already spans the full buffer."""
    if cur >= full:
        return None
    return min(max(min_rung, cur * 2), full)


def next_sort_lanes(cur: int, u_sz: int) -> Optional[int]:
    return next_rung(cur, u_sz, SORT_RUNG_MIN)


def climb_sort_rung(eng, full: int) -> Optional[str]:
    """Flag 4 at a rung below the full buffer: climb one rung toward
    ``full`` and return the grow note; None when the rung already spans
    the full buffer.  (The JAX helper also records the evidence its
    density tuner reads; the tuner is not ported.)"""
    nxt = next_sort_lanes(eng._sort_width(), full)
    if nxt is None:
        return None
    eng._sort_lanes = nxt
    return f"sort_lanes={nxt}"


def fall_back_to_sort(eng) -> str:
    """The sortless -> sorted fallback: the flagged wave committed nothing,
    so its re-run on the sorted path is exact."""
    eng._sortless = False
    return "sortless=0"


def reset_sort_rung_to_full(eng) -> None:
    """After a full-buffer flag 4 relaxed ``dedup_factor``: the rung
    resets to the new full width."""
    eng._sort_lanes = None


def relax_dedup_geometry(chunk, dedup_factor, lanes_of, lane_cap,
                         chunk_label: str, chunk_floor: int = 2048):
    """The dedup-overflow growth rule: straight to the always-safe
    ``dedup_factor=1``, halving the chunk while ``lanes_of(chunk, 1)``
    exceeds ``lane_cap``.  Returns ``(dedup_factor, chunk, note)``, or
    None when already at 1 or even the floor chunk does not fit."""
    if dedup_factor <= 1:
        return None
    notes = ["dedup_factor=1"]
    c = chunk
    while c > chunk_floor and lanes_of(c, 1) > lane_cap:
        c //= 2
        notes.append(f"{chunk_label}={c}")
    if lanes_of(c, 1) > lane_cap:
        return None
    return 1, c, "; ".join(notes)


def past_deadline_or_stopped(eng, deadline: Optional[float]) -> bool:
    """The wall ``deadline`` (monotonic seconds) has passed, or a stop was
    requested."""
    if deadline is not None and time.monotonic() >= deadline:
        return True
    return eng.stop_requested()


def loop_should_break(eng, remaining: int, depth: int,
                      deadline: Optional[float] = None) -> bool:
    """The termination test after every committed wave: level drained /
    target depth / finish_when / target_state_count / wall deadline /
    stop request, in the JAX loop's order."""
    opts = eng._options
    if remaining == 0:
        return True
    if (
        opts._target_max_depth is not None
        and depth + 1 >= opts._target_max_depth
    ):
        return True
    if opts._finish_when.matches(
        frozenset(eng._discovery_slots), eng._properties
    ):
        return True
    if (
        opts._target_state_count is not None
        and opts._target_state_count <= eng._state_count
    ):
        return True
    return past_deadline_or_stopped(eng, deadline)


class WaveLoop:
    """The per-wave host loop, engine-agnostic.  An overflowing wave never
    commits, so growth re-runs the same chunk with no work lost."""

    def __init__(self, eng):
        self.eng = eng

    def run(self, deadline: Optional[float] = None) -> int:
        """Run to the end of the search, or to the wall ``deadline``
        (monotonic seconds) or a stop request; returns the number of waves
        run (re-runs after growth included)."""
        eng = self.eng
        waves = 0
        eng._wl_publish()
        while eng._wl_can_wave():
            flags = eng._wl_wave()
            waves += 1
            if flags:
                fatal = flags & ~RETRYABLE_FLAGS
                if fatal:
                    raise RuntimeError(eng._wl_overflow_message(fatal))
                # A run past its budget (or asked to stop) keeps its
                # partial result rather than grow.  The flagged wave
                # committed nothing, but its aborted insert may have
                # written keys into the table: erase them first, or a
                # resumed snapshot would treat the wave's states as
                # visited and drop their subtrees.
                if past_deadline_or_stopped(eng, deadline):
                    eng._wl_abort_cleanup()
                    break
                eng._wl_grow(flags)
                continue
            eng._wl_publish()
            if loop_should_break(eng, eng._wl_remaining(), eng._wl_depth(),
                                 deadline):
                break
        return waves


def fingerprints_of_rows(rows: torch.Tensor) -> np.ndarray:
    """Sorted uint64 fingerprints of packed rows (``int32[n, W]`` on any
    device, or the engine's identity view of them, ``GpuChecker._identity``)
    -- the identity behind ``discovered_fingerprints()``, computed by the
    same K1 fingerprint the engine dedups on."""
    hi, lo = device_fp64(rows)
    hi = hi.to("cpu").numpy().view(np.uint32).astype(np.uint64)
    lo = lo.to("cpu").numpy().view(np.uint32).astype(np.uint64)
    fps = (hi << np.uint64(32)) | lo
    return np.sort(fps)
