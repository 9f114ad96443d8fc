"""Per-wave phase-timed trace records for the wavefront engines.

The counterpart of ``stateright_tpu/obs/trace.py``.  With ``trace=True``
an engine times each phase of every wave (:class:`PhaseClock`: a
``torch.cuda.synchronize`` and a ``time.perf_counter`` at each phase
boundary) and hands the tracer one ``(phase -> seconds, phase -> bytes)``
record per committed wave.  The tracer:

- enriches the engine's journal ``wave`` event with ``wave_breakdown``
  (seconds per phase), ``bytes`` (modeled bytes touched per phase) and
  ``hbm_util_frac`` for that wave;
- accumulates run totals, reduced by :meth:`WaveTracer.summary` into the
  shape the JAX engine's ``trace_summary()`` has, ``bottleneck_phase``
  included.

Phase names are the JAX engine's, and the port's wave maps onto them:

====================  =======================================================
``step``              the model's step (or, two-phase, lane validity, the
                      valid lanes' compaction and their successors) and the
                      wave verdicts (K8) -- ``GpuChecker._wave_expand``
``canon``             canonicalization under symmetry (K15) and the
                      fingerprint (K1); single-phase waves then compact the
                      valid lanes' keys (K3) -- ``_wave_fingerprint``
``dedup``             the insert (K4, after K12 on the sorted path) and the
                      new lanes' compaction (K3) -- ``_wave_insert``
``cold_probe``        the tiered engine's merge-join against its cold runs
                      (host windowing, K20 passes) -- ``_wave_filter``
``append``            the new rows, parents and ebits at the log tail
                      (K25) -- ``_wave_commit``
``readback``          the wave's one scalar readback and, with a visitor,
                      the expanded states' transfer and the callbacks --
                      host time, excluded from the bandwidth figure
====================  =======================================================

``exchange`` is the sharded engine's: the owner bucketing (K26), the
slice copies into each owner's receive buffer and the owners' K1 --
``ShardedGpuChecker._run_traced``, which also charges the sender's K12 and
the owner's insert to ``dedup`` and the commit (K27) to ``append``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import torch

from .roofline import hbm_util_frac, peaks_for_device

# Canonical display order; engines may omit phases they don't have.
# ``cold_probe`` is the tiered engine's pre-commit merge-join against
# the evicted runs (host windowing + K20 passes).
PHASE_ORDER = (
    "step", "canon", "dedup", "exchange", "cold_probe", "append",
    "readback",
)

# Host-side phases: excluded from the bandwidth denominator (they are
# not device time) but included in wave wall time.  Public so a consumer
# picking a "bottleneck" phase can exclude the trace's own cost the same
# way.
HOST_PHASES = frozenset({"readback", "cold_probe"})


class WaveTracer:
    """Accumulates per-wave phase records into run totals.

    One engine host loop writes (``record_wave``); ``summary()`` may be
    called from any thread mid-run (``metrics()`` reads it), so both
    sides serialize on an internal lock.
    """

    def __init__(self, device, engine: str):
        self.engine = engine
        self.peaks = peaks_for_device(device)
        self.waves = 0
        self.phase_sec: Dict[str, float] = {}
        self.phase_bytes: Dict[str, int] = {}
        self._extra_totals: Dict[str, float] = {}
        self._lock = threading.Lock()

    def record_wave(
        self,
        phases: Dict[str, float],
        bytes_touched: Optional[Dict[str, int]] = None,
        **extra_counters: float,
    ) -> dict:
        """Fold one wave's record into the totals; returns the journal
        enrichment for that wave (``wave_breakdown`` / ``bytes`` /
        ``hbm_util_frac``).  ``extra_counters`` accumulate into the
        summary (the wave's ``probe_rounds`` and ``probe_slots``)."""
        bytes_touched = bytes_touched or {}
        with self._lock:
            self.waves += 1
            for name, sec in phases.items():
                self.phase_sec[name] = self.phase_sec.get(name, 0.0) + sec
            for name, b in bytes_touched.items():
                self.phase_bytes[name] = (
                    self.phase_bytes.get(name, 0) + int(b)
                )
            for name, v in extra_counters.items():
                self._extra_totals[name] = (
                    self._extra_totals.get(name, 0) + v
                )
        device_sec = sum(
            s for n, s in phases.items() if n not in HOST_PHASES
        )
        util = hbm_util_frac(
            sum(bytes_touched.values()), device_sec,
            self.peaks["hbm_bytes_per_sec"],
        )
        record = {
            "wave_breakdown": {
                n: round(phases[n], 6)
                for n in PHASE_ORDER if n in phases
            },
            "hbm_util_frac": round(util, 6),
        }
        if bytes_touched:
            record["bytes"] = {
                n: int(bytes_touched[n])
                for n in PHASE_ORDER if n in bytes_touched
            }
        record.update(
            {k: round(v, 6) if isinstance(v, float) else v
             for k, v in extra_counters.items()}
        )
        return record

    def summary(self) -> dict:
        """Run-total reduction: phase seconds (and each phase's fraction
        of traced wall time), modeled bytes, and the aggregate
        ``hbm_util_frac`` over device phases.  Safe to call from any
        thread mid-run (snapshots under the tracer lock)."""
        with self._lock:
            waves = self.waves
            phase_sec = dict(self.phase_sec)
            phase_bytes = dict(self.phase_bytes)
            extra = dict(self._extra_totals)
        total = sum(phase_sec.values())
        device_sec = sum(
            s for n, s in phase_sec.items() if n not in HOST_PHASES
        )
        out = {
            "engine": self.engine,
            "traced_waves": waves,
            "traced_sec": round(total, 4),
            "wave_breakdown": {
                n: round(phase_sec[n], 4)
                for n in PHASE_ORDER if n in phase_sec
            },
            "wave_breakdown_frac": {
                n: round(phase_sec[n] / total, 4)
                for n in PHASE_ORDER if n in phase_sec
            } if total > 0 else {},
            "bytes": {
                n: int(phase_bytes[n])
                for n in PHASE_ORDER if n in phase_bytes
            },
            "hbm_util_frac": round(
                hbm_util_frac(
                    sum(phase_bytes.values()), device_sec,
                    self.peaks["hbm_bytes_per_sec"],
                ), 6,
            ),
            "hbm_peak_bytes_per_sec": self.peaks["hbm_bytes_per_sec"],
            "hbm_peak_estimated": self.peaks["estimated"],
            "device_kind": self.peaks["device_kind"],
        }
        # The roofline verdict, named: the dominant DEVICE phase (host
        # readback is the trace instrumentation's own cost, excluded
        # like the bandwidth denominator above).
        device_phases = {
            n: s for n, s in phase_sec.items() if n not in HOST_PHASES
        }
        if device_phases:
            out["bottleneck_phase"] = max(
                device_phases, key=device_phases.get
            )
        out.update({
            k: round(v, 4) if isinstance(v, float) else v
            for k, v in extra.items()
        })
        return out


class PhaseClock:
    """The phase timer of one traced wave: :meth:`mark` waits for the
    queued work of the device -- or of each device of a list, a sharded
    mesh's cards -- (``torch.cuda.synchronize``, the counterpart of the
    JAX engine's ``block_until_ready``) and charges the seconds since the
    previous mark to the named phase, so the phases partition the wave's
    wall time.  A phase marked twice accumulates."""

    def __init__(self, device):
        devices = device if isinstance(device, (list, tuple)) else [device]
        self._devices = [
            d for d in map(torch.device, devices) if d.type == "cuda"
        ]
        self.phases: Dict[str, float] = {}
        self._last = time.perf_counter()

    def mark(self, phase: str) -> None:
        for d in self._devices:
            torch.cuda.synchronize(d)
        now = time.perf_counter()
        self.phases[phase] = self.phases.get(phase, 0.0) + now - self._last
        self._last = now


class NoClock:
    """The untraced wave's stand-in for :class:`PhaseClock`: no sync, no
    timing."""

    phases: Dict[str, float] = {}

    def mark(self, phase: str) -> None:
        pass


NO_CLOCK = NoClock()
