"""Host-tail spans and profiler ranges for the wave loop.

The counterpart of ``stateright_tpu/obs/timeline.py``'s span layer and
profiler hooks (``step_annotation``, ``phase_annotation``,
:class:`SpanRecorder`):

- :class:`SpanRecorder` -- the zero-new-readback span layer the host wave
  loop (``parallel/wave_loop.py``) threads through each wave's tail:
  every named section (``journal`` append, ``checkpoint`` write, tiered
  ``spill``, overflow ``grow``, the previous record's own ``flush``
  write) is timed with two ``time.monotonic()`` calls and journaled as
  ONE ``host_span`` event per wave plus per-phase ``host_<phase>_sec``
  histograms, so ``host_sec_total`` decomposes into named parts.  The
  engine reports in-wave host work (the ``readback``, the tiered engine's
  ``cold_probe`` filter) through the same record under ``call_spans``.
  No device traffic anywhere.
- profiler ranges -- :func:`set_profile` flips a process-wide switch;
  with it on, the loops wrap each wave in a ``wave_quantum`` range and
  each traced phase and host span in a range named like its journal
  phase, as ``torch.profiler.record_function`` ranges (and NVTX ranges
  through ``torch.cuda.nvtx`` when a card is present), so a
  ``torch.profiler`` trace lines up with the journal by name (the loop
  runs on the checker's own thread: a CPU profile sees its ranges with
  ``experimental_config=torch._C._profiler._ExperimentalConfig(
  profile_all_threads=True)``).  Off (the default), every hook is a
  no-op context.

The JAX package's Perfetto export of journals (``build_trace``,
``export_timeline``) is not ported here.
"""

from __future__ import annotations

import os
import socket
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional, Tuple

import torch

# The journal event one wave's host tail folds into.
SPAN_EVENT = "host_span"

# The host-tail spans (between waves: ``journal``, ``spill``, ``retune``
# -- the density tuners, in the fused loop and in every untraced per-wave
# loop that has them, the sharded one's among them -- ``checkpoint``,
# ``grow``, and the residual ``other`` and the previous record's own
# ``flush`` write) sum to the wave's ``host_sec`` gap, the gap LoopVitals
# accounts into ``host_sec_total``.  Spans measured
# INSIDE the wave (host-observed, part of the wave's call time, not the
# host tail): the readback and the tiered cold filter.
CALL_PHASES = ("readback", "cold_probe")


def default_worker() -> str:
    """The ``pid@host`` worker stamp."""
    return f"{os.getpid()}@{socket.gethostname()}"


# --- profiler hooks ---------------------------------------------------------

_profile_on = False


def set_profile(enabled: bool) -> None:
    """Process-wide profiler-range switch (the JAX package's
    ``set_xprof``): loops started after this wrap waves in a
    ``wave_quantum`` range and phases and host spans in ranges named like
    their journal phases."""
    global _profile_on
    _profile_on = bool(enabled)


def profile_enabled() -> bool:
    return _profile_on


@contextmanager
def _range(name: str):
    """A ``record_function`` range, mirrored as an NVTX range when a card
    is present."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def step_annotation(name: str = "wave_quantum"):
    """The range of one loop wave when profiling is on (every wave under
    one name, so the profiler sums them); a no-op context otherwise -- the
    loops call this unconditionally."""
    if not _profile_on:
        return nullcontext()
    return _range(name)


def phase_annotation(name: str):
    """A range named ``name`` when profiling is on: host spans and traced
    phases carry the SAME names into the profile as into the journal, so
    the two timelines align by string."""
    if not _profile_on:
        return nullcontext()
    return _range(str(name))


# --- the span layer ---------------------------------------------------------


class SpanRecorder:
    """Per-wave host-tail accounting for the host wave loop.

    The loop marks the tail start (:meth:`tail_start`, right after the
    device call returns), wraps each named tail section in
    :meth:`span`, and closes the quantum at the top of the next
    iteration (:meth:`quantum_start`) — the SAME boundary
    ``LoopVitals.call_started`` accounts into ``host_sec_total``, so
    the journaled decomposition and the counter agree by construction.
    The flush write itself (one journal line) lands in the NEXT
    record as the ``flush`` span, positioned at its true (earlier)
    monotonic time, so no tail microsecond goes unattributed.

    Every timestamp is host ``time.monotonic()``; there is no device
    traffic and no new readback.
    """

    def __init__(self, journal=None, metrics=None,
                 worker: Optional[str] = None):
        self._journal = journal
        self._metrics = metrics
        self._worker = worker or default_worker()
        self._tail_mark: Optional[float] = None
        self._spans: List[Tuple[str, float, float]] = []
        self._call_spans: List[Tuple[str, float, float]] = []
        self._quantum = 0
        self._profile = profile_enabled()

    @contextmanager
    def span(self, phase: str):
        """Time one named section; in-call phases (:data:`CALL_PHASES`)
        are kept apart from the tail decomposition."""
        ann = phase_annotation(f"host/{phase}") if self._profile else None
        if ann is not None:
            ann.__enter__()
        t0 = time.monotonic()
        try:
            yield
        finally:
            dur = time.monotonic() - t0
            if ann is not None:
                ann.__exit__(None, None, None)
            dest = (
                self._call_spans if phase in CALL_PHASES else self._spans
            )
            dest.append((phase, t0, dur))

    def step(self):
        """The per-quantum ``wave_quantum`` range (no-op unless profiling
        is on)."""
        self._quantum += 1
        if not self._profile:
            return nullcontext()
        return step_annotation()

    def collect(self, eng) -> None:
        """Fold in-call host spans the engine measured itself (the
        optional ``_wl_host_spans()`` hook: the wave's readback, and the
        tiered engine's cold filter, inside ``_wl_wave``)."""
        hook = getattr(eng, "_wl_host_spans", None)
        if hook is None:
            return
        for phase, t0, dur in hook() or ():
            dest = (
                self._call_spans if phase in CALL_PHASES else self._spans
            )
            dest.append((str(phase), float(t0), float(dur)))

    def tail_start(self, now: float) -> None:
        self._tail_mark = now

    def quantum_start(self, now: float) -> None:
        """Close the previous quantum's tail ``[tail_start, now)`` —
        called at the top of each loop iteration with the same
        timestamp handed to ``vitals.call_started``."""
        if self._tail_mark is not None:
            self._flush(now)

    def finish(self, now: float) -> float:
        """Close the final tail at loop exit; returns its seconds so
        the loop can fold them into ``host_sec_total``
        (``LoopVitals.record_host``) — the last tail has no next call
        to account it otherwise."""
        if self._tail_mark is None:
            return 0.0
        return self._flush(now)

    def _flush(self, now: float) -> float:
        tail = max(0.0, now - self._tail_mark)
        spans: Dict[str, List[float]] = {}
        for phase, t0, dur in self._spans:
            rel = t0 - self._tail_mark
            cur = spans.get(phase)
            if cur is None:
                spans[phase] = [rel, dur]
            else:
                cur[0] = min(cur[0], rel)
                cur[1] += dur
        in_tail = sum(v[1] for k, v in spans.items() if v[0] >= 0.0)
        other = max(0.0, tail - in_tail)
        spans["other"] = [max(0.0, tail - other), other]
        call_spans: Dict[str, List[float]] = {}
        for phase, t0, dur in self._call_spans:
            rel = t0 - self._tail_mark
            cur = call_spans.get(phase)
            if cur is None:
                call_spans[phase] = [rel, dur]
            else:
                cur[0] = min(cur[0], rel)
                cur[1] += dur
        t_flush0 = time.monotonic()
        if self._metrics is not None:
            from .metrics import LATENCY_BUCKETS

            for phase, (_rel, dur) in spans.items():
                self._metrics.observe(
                    f"host_{phase}_sec", dur, boundaries=LATENCY_BUCKETS
                )
            for phase, (_rel, dur) in call_spans.items():
                self._metrics.observe(
                    f"host_{phase}_sec", dur, boundaries=LATENCY_BUCKETS
                )
        if self._journal is not None:
            self._journal.append(
                SPAN_EVENT,
                quantum=self._quantum,
                worker=self._worker,
                mono=round(self._tail_mark, 6),
                host_sec=round(tail, 6),
                spans={
                    k: [round(v[0], 6), round(v[1], 6)]
                    for k, v in spans.items()
                },
                **(
                    {"call_spans": {
                        k: [round(v[0], 6), round(v[1], 6)]
                        for k, v in call_spans.items()
                    }} if call_spans else {}
                ),
            )
        flush_dur = time.monotonic() - t_flush0
        self._spans = [("flush", t_flush0, flush_dur)]
        self._call_spans = []
        self._tail_mark = None
        return tail
