"""The host wave loop: run a wave, publish its counts, grow on overflow,
stop when the search is done.

The counterpart of the quantum loop of ``stateright_tpu/parallel/
wave_loop.py`` (``FusedWaveLoop``, ``loop_should_break``) and its
``fingerprints_of_rows``.  The JAX loop runs up to ``waves_per_call`` waves
inside one device program between stats readbacks; this port reads one
small stats tensor back per wave, and checks before each wave what the JAX
program checks in its loop condition.  Rung ladders, vitals, the journal,
the knob cache and checkpoint cadence are not ported.

The engine adapter (the checker) provides:

- ``_wl_can_wave() -> bool`` -- the JAX loop condition: the level is not
  drained, the next level is within ``target_max_depth`` and the device
  mirror of ``finish_when`` does not match yet;
- ``_wl_wave() -> int`` -- run one wave; it commits iff the returned
  overflow flags are 0, and leaves the carry exactly as it was otherwise;
- ``_wl_publish()`` -- copy the carry's counts to the checker surface;
- ``_wl_grow(flags)`` -- grow the tripped buffers in place and rebuild the
  table from the committed log (raises when a knob cannot grow);
- ``_wl_remaining() / _wl_depth()`` and the checker attributes
  ``_options``, ``_properties``, ``_state_count`` and
  ``_discovery_slots``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.device_fp import device_fp64

# 1 = table overfull (probe failure or past 50% load), 2 = row log full,
# 4 = compaction buffer overflow: all grow in place.  8 = the model's
# packed encoding overflowed, which no growth can fix.
RETRYABLE_FLAGS = 1 | 2 | 4


def loop_should_break(eng, remaining: int, depth: int) -> bool:
    """The termination test after every committed wave: level drained /
    target depth / finish_when / target_state_count, in the JAX loop's
    order."""
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
    return (
        opts._target_state_count is not None
        and opts._target_state_count <= eng._state_count
    )


class WaveLoop:
    """The per-wave host loop, engine-agnostic.  An overflowing wave never
    commits, so growth re-runs the same chunk with no work lost."""

    def __init__(self, eng):
        self.eng = eng

    def run(self) -> int:
        """Run to the end of the search; returns the number of waves run
        (re-runs after growth included)."""
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
                eng._wl_grow(flags)
                continue
            eng._wl_publish()
            if loop_should_break(eng, eng._wl_remaining(), eng._wl_depth()):
                break
        return waves


def fingerprints_of_rows(rows: torch.Tensor) -> np.ndarray:
    """Sorted uint64 fingerprints of packed rows (``int32[n, W]`` on any
    device, or its identity prefix ``rows[:, :fp_words]``) -- the identity
    behind ``discovered_fingerprints()``, computed by the same K1
    fingerprint the engine dedups on."""
    hi, lo = device_fp64(rows)
    hi = hi.to("cpu").numpy().view(np.uint32).astype(np.uint64)
    lo = lo.to("cpu").numpy().view(np.uint32).astype(np.uint64)
    fps = (hi << np.uint64(32)) | lo
    return np.sort(fps)
