"""Roofline accounting: per-device peaks and the bytes-touched model.

The counterpart of ``stateright_tpu/obs/roofline.py``.  The wave is
bandwidth-bound, not compute-bound: every phase is gathers, scatters,
block copies, a radix sort and hash probes over 32- and 64-bit words,
with a few integer operations a word.  So the roofline that matters is
the memory one -- ``hbm_util_frac`` is the fraction of the card's peak
memory bandwidth a traced wave achieved, ``modeled bytes / (measured
seconds x peak bytes a second)``.

The byte model is ANALYTIC, derived from the wave's shapes and from
counts its one readback already holds (``GpuChecker._traced_wave_bytes``
applies it phase by phase and names where it differs from the JAX
engine's).  Modeling choices, documented here because ``hbm_util_frac``
inherits them:

- the port's kernels touch what the wave's data needs, not whole
  fixed-width buffers as the JAX engine's programs do, so the model
  reads each phase as one function and counts its inputs read once and
  its outputs written once, at the wave's live counts (states expanded,
  valid lanes, new states) where a kernel works on those, and at the
  buffer width where it works on the whole buffer (K1 on the two-phase
  successor buffer, K3 and K12 on the compaction buffer).  Buffers a
  phase hands from one of its kernels to the next are not counted:
  consecutive passes over one buffer partly hit the 50 MB L2, and
  counting every kernel's inputs and outputs read above the card's peak
  on small waves (1.18 on a 2pc rm=10 wave on the H100);
- the sorted path's K12 is a one-sweep LSD radix sort
  (``csrc/prededup.cu``) over the lanes it sorts -- on the sorted path
  the ``n_valid`` active prefix of the buffer, not the whole buffer: an
  upfront pass reads each key once for every pass's histogram, then
  eight passes of 8 bits each read and write the 12-byte (key, lane)
  pair of each sorted lane once -- :func:`sort_bytes`.  The JAX engine
  charges a bitonic network of ``k(k+1)/2`` passes over three planes of
  the whole buffer for its XLA sort, which would read above the card's
  peak applied to K12;
- the insert's probes: K4 (``csrc/hashset.cu``) walks each active lane's
  probe chain on its own, so the model charges 8 bytes a slot it reads,
  from the count of slots the wave's lanes read (``probe_slots``, summed
  by K4 with a warp reduction and an ``atomicAdd`` into the wave's
  readback; the plain twin counts the slots its rounds read).  The wave
  record also carries ``probe_rounds``: on the CPU the twin's lockstep
  claim rounds, which equal the JAX engine's ``with_rounds`` count; on
  the card K4's longest probe chain (an ``atomicMax``), which can be
  lower, since a lane that loses a CAS costs it no extra step.  The JAX
  engine's :func:`probe_bytes` (every buffer lane charged every round)
  is kept for comparison; applied to K4 it would count bytes the card
  never moves;
- phase seconds come from ``torch.cuda.synchronize`` around each phase,
  so they include launch latency and the host's own work in the phase;
  a traced wave reads LOWER than the untraced wave achieves.  The
  breakdown's relative shape is the signal.

Peaks are NVIDIA's published per-card numbers keyed by
``torch.cuda.get_device_name``; the CPU, and any card not in the table,
falls back to a conservative estimate flagged ``estimated``, so a
utilization can never pass for a measured-hardware claim.
"""

from __future__ import annotations

from typing import Dict

import torch

# Published peak memory bandwidth of each card, bytes a second (NVIDIA's
# H100 data sheet).  Keys are matched as case-insensitive substrings of
# ``torch.cuda.get_device_name``, the longest key first, so "H100 NVL" and
# "H100 PCIe" are not read as the SXM part.
DEVICE_PEAKS: Dict[str, float] = {
    "H100 80GB HBM3": 3.35e12,  # SXM5: 3.35 TB/s
    "H100 PCIe": 2.0e12,        # 2.0 TB/s
    "H100 NVL": 3.9e12,         # 3.9 TB/s a card
}

# Fallback for the CPU and unknown cards: a conservative host-DRAM figure
# so the ratio stays meaningful in the CPU tests.
_FALLBACK_PEAK = 2.0e10  # 20 GB/s

# The sorted path's K12: 8 radix passes over a 12-byte (key, lane) pair.
SORT_PASSES = 8
SORT_PAIR_BYTES = 12


def peaks_for_device(device) -> Dict:
    """Peak table entry for a torch device: ``{"device_kind", "platform",
    "hbm_bytes_per_sec", "estimated"}``.  ``estimated`` is True whenever
    the card's name matched no entry (and always on the CPU)."""
    device = torch.device(device)
    platform = "gpu" if device.type == "cuda" else device.type
    kind = (
        torch.cuda.get_device_name(device) if device.type == "cuda" else ""
    )
    low = kind.lower()
    for key in sorted(DEVICE_PEAKS, key=len, reverse=True):
        if key.lower() in low:
            return {
                "device_kind": kind,
                "platform": platform,
                "hbm_bytes_per_sec": DEVICE_PEAKS[key],
                "estimated": False,
            }
    return {
        "device_kind": kind or platform or "unknown",
        "platform": platform,
        "hbm_bytes_per_sec": _FALLBACK_PEAK,
        "estimated": True,
    }


def hbm_util_frac(bytes_touched: float, seconds: float,
                  peak_bytes_per_sec: float) -> float:
    """Achieved fraction of peak memory bandwidth; 0.0 for degenerate
    inputs (a wave too fast to time reads as unknown-low, never
    infinite)."""
    if seconds <= 0 or peak_bytes_per_sec <= 0:
        return 0.0
    return float(bytes_touched) / (seconds * peak_bytes_per_sec)


def sort_bytes(lanes: int, passes: int = SORT_PASSES,
               pair_bytes: int = SORT_PAIR_BYTES) -> int:
    """Bytes K12 streams sorting ``lanes`` keys: the upfront histogram
    reads each 8-byte key once, then every pass reads and writes each
    (key, lane) pair once."""
    return lanes * (8 + 2 * passes * pair_bytes)


def probe_bytes(lanes: int, rounds: int, word_bytes: int = 4) -> int:
    """The JAX engine's probe model: ``rounds`` lockstep claim rounds over
    a ``lanes``-wide key buffer, each lane gathering both key planes,
    contending the claim plane and scattering its key words -- 6
    lane-words a round, every lane charged every round.  Kept for
    comparison with the JAX engine's records; the port charges
    :func:`slot_bytes` instead."""
    return 6 * max(0, rounds) * lanes * word_bytes


def slot_bytes(slots: int) -> int:
    """Bytes of ``slots`` table slots read by K4's probe chains (one
    64-bit key word each)."""
    return 8 * max(0, slots)


def copy_bytes(lanes: int, width: int, word_bytes: int = 4) -> int:
    """Read+write bytes of moving ``lanes`` rows of ``width`` 32-bit words
    (gathers and block appends both stream payload in and out)."""
    return 2 * lanes * width * word_bytes
