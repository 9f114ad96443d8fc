"""The host wave loop: run a wave, publish its counts, grow on overflow,
stop when the search is done.

The counterpart of ``stateright_tpu/parallel/wave_loop.py``
(``FusedWaveLoop``, ``WaveView``, ``loop_should_break``, ``finalize_run``,
``log_grow``, ``CheckpointCadence``, ``LoopVitals``) and its
``fingerprints_of_rows``.  :class:`FusedWaveLoop` is the JAX fused loop:
the engine runs up to ``waves_per_call`` waves between two readbacks of
one stats tensor (the untraced single-card checker, ``parallel/fused.py``)
and the loop journals, tunes, checkpoints, grows and stops per quantum.
:class:`WaveLoop` reads one stats tensor back per wave and checks before
each wave what the JAX program checks in its loop condition: the traced
mode's loop (and the tiered checker's, whose JAX counterpart drives one
host wave per call).  Ported: the flag-4 rules of the
sort-rung ladder and the sorted fallback, the wall deadline of a builder
``timeout`` and a ``request_stop``, the optional after-commit rung (the
tiered engine's spill), the checkpoint cadence, the metrics the loop
writes (``waves``, ``table_occupancy``, ``grows``, ``overflow_retries``,
the always-on vitals and their histograms), the host spans
(``obs/timeline.py``), and the journal's ``geometry``, ``wave`` (with its
``density``), ``grow``, ``checkpoint``, ``host_span`` and ``engine_done``
events, all from scalars the wave's one readback already holds.

Traced mode (``spawn_gpu(trace=True)``, the JAX engine's
``_check_once_traced``) is a branch of the same loop, so growth, the
deadline and ``request_stop`` cannot drift between the two: the engine
times each phase of its wave itself and hands back the wave's record
(``_wl_trace_phases``, the ``wave_breakdown``/``bytes``/``hbm_util_frac``
fields of ``_wl_wave_extra``); the loop then accounts the wave's
``readback`` phase as host time instead of the gap between waves, runs no
host spans, and skips the mid-run checkpoint cadence, as the JAX traced
loop does.  An engine whose waves stand for the JAX device calls of
several waves each (the sharded engine) says where a call ends
(``_wl_call_waves``); the loop's vitals, the wave events' ``density`` and
the density tuners then go by calls, as the JAX ``FusedWaveLoop``'s do.
The density tuners (``maybe_retune_sort``, ``maybe_retune_step``) run
where an engine asks for them (``_wl_retune``: the sharded and
tiered-sharded engines; the traced sharded loop calls them itself) after
each committed call; the fused loop runs them after each committed
quantum, as the JAX fused loop does.  Not ported: the knob cache.  The
sharded engine's ladders are here: the exchange buckets' slack
(``exchange_bucket_lanes``, ``next_bucket_slack``, flag 32) and the step
rung (``climb_step_rung``, flag 128); an engine names the flags it can
grow in place through ``_wl_retryable_flags()`` (default 1, 2 and 4).

The engine adapter (the checker) provides:

- ``_wl_can_wave() -> bool`` -- the JAX loop condition: the level is not
  drained, the next level is within ``target_max_depth`` and the device
  mirror of ``finish_when`` does not match yet;
- ``_wl_wave() -> int`` -- run one wave; it commits iff the returned
  overflow flags are 0, and leaves the carry exactly as it was otherwise
  (apart from the table, which an aborted insert may have written);
- ``_wl_publish()`` -- copy the carry's counts to the checker surface;
- ``_wl_grow(flags)`` -- grow the tripped buffers in place and rebuild the
  table from the committed log (raises when a knob cannot grow);
- ``_wl_retryable_flags() -> int`` (optional) -- the flags ``_wl_grow``
  takes; any other flag raises ``_wl_overflow_message``;
- ``_wl_abort_cleanup()`` -- erase a flagged wave's table writes before a
  stop or deadline keeps the partial result;
- ``_wl_after_commit()`` (optional) -- called after every committed wave,
  before the checkpoint cadence, so the very next checkpoint holds what it
  changed;
- ``_wl_call_waves() -> int`` (optional) -- after a wave, the waves of
  the device call it ended, or 0 when the call goes on (default: every
  wave is a call of one wave); the vitals record one quantum a call;
- ``_wl_retune(density, remaining)`` (optional) -- called after the
  after-commit rung of every committed call with the call's measured
  valid density and its remaining level: the density tuners;
- ``_wl_occupancy() -> float``, ``_wl_wave_extra() -> dict`` (journal
  fields of a ``wave`` event), ``_wl_write_checkpoint() -> dict`` (extra
  fields of a ``checkpoint`` event), ``_wl_geometry() -> dict``,
  ``_wl_cand_lanes() -> int`` (the density's denominator),
  ``_wl_host_spans() -> list`` (in-wave host spans, drained) and
  ``_wl_trace_phases() -> dict | None`` (the last wave's phase seconds
  when it was traced and committed);
- ``_wl_remaining() / _wl_depth()``, ``stop_requested()`` and the checker
  attributes ``_options``, ``_properties``, ``_state_count``,
  ``_unique_count``, ``_max_depth``, ``_discovery_slots``, ``_journal``,
  ``_metrics``, ``_checkpoint_path``, ``_ckpt_every_waves`` and
  ``_ckpt_every_sec``.
"""

from __future__ import annotations

import logging
import time
from contextlib import nullcontext
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..obs.metrics import COUNT_BUCKETS, FRACTION_BUCKETS, LATENCY_BUCKETS
from ..obs.timeline import SpanRecorder, step_annotation
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

# The density tuner's sizing headroom over the measured per-wave valid
# peak, and the committed observations it waits for before a downshift
# (JAX ``wave_loop.py:93-106``).
SORT_RUNG_HEADROOM = 4.0
SORT_TUNE_MIN_QUANTA = 8

# The step-geometry rung ladder (JAX ``wave_loop.py:108-126``): a
# power-of-two chunk width below ``chunk_size``; a wave whose remaining
# level exceeds it raises the non-committing flag 128 and the host climbs
# one rung.
STEP_RUNG_MIN = 256
STEP_RUNG_HEADROOM = 4.0
STEP_TUNE_MIN_QUANTA = 8

# The sharded exchange's per-destination bucket (JAX ``wave_loop.py:
# 27-70``): ``slack`` percent of the even share of the compaction buffer,
# doubling on flag 32 until it spans the whole buffer.
BUCKET_SLACK_DEFAULT = 50
BUCKET_SLACK_MAX_RUNGS = 12


def exchange_bucket_lanes(u_sz: int, n: int, slack_pct: int) -> int:
    """Per-destination exchange bucket width in lanes: ``slack_pct``
    percent of the even share ``u_sz/n``, rounded up to a multiple of 128,
    floored at 8, capped at ``u_sz``; ``u_sz`` itself on a 1-shard mesh
    (no exchange) -- the JAX package's, lane for lane."""
    if n <= 1:
        return u_sz
    even = -(-u_sz // n)
    want = -(-even * max(int(slack_pct), 1) // 100)
    want = max(8, ((want + 127) // 128) * 128 if want > 8 else want)
    return min(u_sz, want)


def next_bucket_slack(u_sz: int, n: int, slack_pct: int) -> Optional[int]:
    """The next slack rung (doubling until the bucket widens), or None once
    the bucket spans the whole ``u_sz`` buffer, where it cannot overflow."""
    if exchange_bucket_lanes(u_sz, n, slack_pct) >= u_sz:
        return None
    grown = slack_pct * 2
    for _ in range(BUCKET_SLACK_MAX_RUNGS):
        if exchange_bucket_lanes(u_sz, n, grown) > exchange_bucket_lanes(
            u_sz, n, slack_pct
        ):
            return grown
        grown *= 2
    return None


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def clamp_rung(requested: int, min_rung: int) -> int:
    """A requested rung normalized onto the ladder: the next power of two,
    floored at ``min_rung``."""
    return max(min_rung, _pow2_ceil(max(1, int(requested))))


def clamp_sort_lanes(requested: int) -> int:
    return clamp_rung(requested, SORT_RUNG_MIN)


def clamp_step_lanes(requested: int) -> int:
    return clamp_rung(requested, STEP_RUNG_MIN)


def next_rung(cur: int, full: int, min_rung: int) -> Optional[int]:
    """The next rung up (doubling, capped at ``full``), or None when the
    rung already spans the full buffer."""
    if cur >= full:
        return None
    return min(max(min_rung, cur * 2), full)


def next_sort_lanes(cur: int, u_sz: int) -> Optional[int]:
    return next_rung(cur, u_sz, SORT_RUNG_MIN)


def next_step_lanes(cur: int, full: int) -> Optional[int]:
    return next_rung(cur, full, STEP_RUNG_MIN)


def downshift_rung(cur: int, full: int, floor: int, peak: float,
                   min_rung: int, headroom: float) -> Optional[int]:
    """The downshift both tuners share: the rung holding the measured
    ``peak`` at ``headroom`` times, at least ``floor`` (a rung this run
    climbed past) and ``min_rung``, at most ``full``; None unless it at
    least halves the current rung."""
    want = max(min_rung, int(floor), _pow2_ceil(max(1, int(peak * headroom) + 1)))
    want = min(want, full)
    if want * 2 <= cur:
        return want
    return None


def climb_step_rung(eng, full: int) -> Optional[str]:
    """Flag 128: climb the step rung one rung toward ``full`` (the chunk
    size), record the overflow-proven floor and peak the step tuner reads,
    and return the grow note; None at the full chunk, where the flag
    cannot fire."""
    cur = eng._step_width()
    nxt = next_step_lanes(cur, full)
    if nxt is None:
        return None
    eng._step_lanes = nxt
    eng._step_rung_floor = nxt
    eng._step_peak_frontier = max(getattr(eng, "_step_peak_frontier", 0.0), cur)
    return f"step_lanes={nxt}"


def climb_sort_rung(eng, full: int) -> Optional[str]:
    """Flag 4 at a rung below the full buffer: climb one rung toward
    ``full``, record the overflow-proven floor and peak the density tuner
    reads, and return the grow note; None when the rung already spans the
    full buffer."""
    cur = eng._sort_width()
    nxt = next_sort_lanes(cur, full)
    if nxt is None:
        return None
    eng._sort_lanes = nxt
    eng._sort_rung_floor = nxt
    eng._sort_peak_valid = max(getattr(eng, "_sort_peak_valid", 0.0), cur)
    return f"sort_lanes={nxt}"


# What each tuner reads and writes on the engine (JAX ``_SORT_NS`` and
# ``_STEP_NS``): the sort tuner's evidence is the valid density scaled to
# lanes, the step tuner's the remaining level.
_SORT_NS = dict(
    apply="_wl_apply_sort_rung", tune="_sort_tune",
    full="_wl_full_sort_lanes", width="_sort_width",
    quanta="_sort_quanta", peak="_sort_peak_valid",
    floor="_sort_rung_floor", min_rung=SORT_RUNG_MIN,
    headroom=SORT_RUNG_HEADROOM, min_quanta=SORT_TUNE_MIN_QUANTA,
    scale_by_full=True,
)
_STEP_NS = dict(
    apply="_wl_apply_step_rung", tune="_step_tune",
    full="_wl_full_step_lanes", width="_step_width",
    quanta="_step_quanta", peak="_step_peak_frontier",
    floor="_step_rung_floor", min_rung=STEP_RUNG_MIN,
    headroom=STEP_RUNG_HEADROOM, min_quanta=STEP_TUNE_MIN_QUANTA,
    scale_by_full=False,
)


def _maybe_retune(eng, measured, ns: dict) -> bool:
    """Fold one committed wave's measurement into the engine's peak and,
    once ``min_quanta`` waves are in, apply a downshift (JAX
    ``wave_loop.py:285-339``).  True exactly when the rung changed.  An
    explicit rung (``_sort_tune``/``_step_tune`` false) is never tuned."""
    apply = getattr(eng, ns["apply"], None)
    if apply is None or measured is None or not getattr(eng, ns["tune"], False):
        return False
    full = getattr(eng, ns["full"])()
    cur = getattr(eng, ns["width"])()
    setattr(eng, ns["quanta"], getattr(eng, ns["quanta"]) + 1)
    peak = measured * full if ns["scale_by_full"] else measured
    setattr(eng, ns["peak"], max(getattr(eng, ns["peak"]), peak))
    if getattr(eng, ns["quanta"]) < ns["min_quanta"]:
        return False
    want = downshift_rung(cur, full, getattr(eng, ns["floor"]),
                          getattr(eng, ns["peak"]), ns["min_rung"],
                          ns["headroom"])
    if want is None:
        return False
    apply(want)
    return True


def maybe_retune_sort(eng, density) -> bool:
    """The density -> sort-rung downshift after a committed wave."""
    return _maybe_retune(eng, density, _SORT_NS)


def maybe_retune_step(eng, remaining) -> bool:
    """The remaining level -> step-rung downshift after a committed wave."""
    return _maybe_retune(eng, remaining, _STEP_NS)


def fall_back_to_sort(eng) -> str:
    """The sortless -> sorted fallback: the flagged wave committed nothing,
    so its re-run on the sorted path is exact.  The geometry is
    re-journaled, as the JAX helper does."""
    eng._sortless = False
    if eng._journal:
        eng._journal.append("geometry", **eng._wl_geometry())
    return "sortless=0"


def reset_sort_rung_to_full(eng, old_full: int = 0) -> None:
    """After a full-buffer flag 4 relaxed ``dedup_factor``: the rung
    resets to the new full width, the tuner's evidence records that a
    wave held at least ``old_full`` valid lanes, and the geometry is
    re-journaled (the JAX helper's)."""
    eng._sort_lanes = None
    if old_full:
        eng._sort_peak_valid = max(getattr(eng, "_sort_peak_valid", 0.0),
                                   old_full)
    if eng._journal:
        eng._journal.append("geometry", **eng._wl_geometry())


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


class CheckpointCadence:
    """Mid-run checkpoint pacing: due every ``every_waves`` waves or
    ``every_sec`` seconds, whichever the engine was configured with."""

    def __init__(self, every_waves: Optional[int], every_sec: Optional[float]):
        self.every_waves = every_waves
        self.every_sec = every_sec
        self._waves = 0
        self._last = time.monotonic()

    def due(self, waves_increment: int) -> bool:
        self._waves += waves_increment
        if self.every_waves is not None and self._waves >= self.every_waves:
            return True
        return (
            self.every_sec is not None
            and time.monotonic() - self._last >= self.every_sec
        )

    def mark(self) -> None:
        self._waves = 0
        self._last = time.monotonic()


class LoopVitals:
    """Always-on loop vitals, the JAX package's: cheap per-wave counters
    and histograms recorded at the host-side boundary the loop already
    crosses, from scalars the wave's one readback holds -- never an extra
    device read.  One instance per engine run; writes land in the
    engine's :class:`~stateright_tpu_torch.obs.metrics.MetricsRegistry`:

    - ``wave_latency_sec`` histogram — per-wave wall latency (a fused
      quantum records its mean latency with weight ``waves_per_call``;
      the per-wave loop records each call the same way, one wave unless
      the engine groups its waves into calls);
    - ``waves_per_grow`` histogram — committed waves between
      overflow-triggered recoveries (how long a geometry survived
      before overflowing);
    - ``uniq_per_sec_ema`` / ``waves_per_sec_ema`` gauges — exponential
      moving averages over committed quanta (alpha 0.3: a few quanta of
      memory, mid-run readable from ``metrics()``);
    - ``host_sec_total`` counter — host-side loop time: the untraced
      loop accounts the gap between waves (journal/metrics/checkpoint/
      grow); traced waves report their measured ``readback`` phase via
      :meth:`record_host` instead.  Either way, the time-in-host
      complement of the wave time;
    - ``overflow_retries`` counter — every overflow-flagged wave that
      was recovered and re-run.  The separate ``grows`` counter
      (:func:`log_grow`) counts only ACTUAL geometry changes: a
      recovery that re-runs without growing (the tiered engine's
      spill-instead-of-grow) moves ``overflow_retries`` but not
      ``grows``;
    - ``valid_density_ema`` gauge + ``valid_density`` histogram — the
      measured per-wave VALID-candidate count as a fraction of the
      worst-case compaction/dedup ``U`` buffer (``cand_lanes``).  The
      numerator is the quantum's ``state_count`` delta divided by its
      wave count: ``state_count`` advances by exactly the
      boundary-passing valid successors each committed wave
      (the wave's ``generated``), so the density needs NO extra
      readback.
      Bounded at 1.0 by construction: the flag-4 overflow criterion
      fires on the SAME valid-lane count (hashset.compact_valid — "a
      stricter criterion than distinct keys"), so a committed wave's
      numerator can never exceed its ``U`` buffer.  This is the number
      the JAX engine's dedup-geometry tuner sizes against;
    - ``table_load_factor`` histogram (``load_factor``) — the hot-table
      load trajectory, one observation per committed quantum (the gauge
      form already rides ``table_occupancy``).
    """

    EMA_ALPHA = 0.3

    def __init__(self, registry, initial_unique: Optional[int] = None,
                 initial_states: Optional[int] = None):
        self._reg = registry
        self._latency_buckets = LATENCY_BUCKETS
        self._count_buckets = COUNT_BUCKETS
        self._fraction_buckets = FRACTION_BUCKETS
        self._uniq_ema: Optional[float] = None
        self._wave_ema: Optional[float] = None
        self._density_ema: Optional[float] = None
        self.last_density: Optional[float] = None
        # Baseline for the first quantum's uniq/s delta: the unique
        # count already committed before the loop starts (init seeding,
        # or a resumed snapshot's count — which must not read as "found
        # this call").  None = unknown; the first quantum then only
        # primes the baseline.  ``initial_states`` is the same baseline
        # for the density's generated-successors delta.
        self._last_unique = initial_unique
        self._last_states = initial_states
        self._waves_since_grow = 0
        self._host_mark: Optional[float] = None
        self._reg.inc("host_sec_total", 0.0)  # key exists from wave 0

    def call_started(self, now: float) -> None:
        """Account the host-side gap since the previous call ended
        (journal/metrics/checkpoint/grow work) as host time; the first
        call has no gap yet."""
        if self._host_mark is not None:
            self._reg.inc(
                "host_sec_total", max(0.0, now - self._host_mark)
            )

    def call_ended(self, now: float) -> None:
        self._host_mark = now

    def record_host(self, sec: float) -> None:
        """Directly account host-side seconds — the traced loops' path:
        their per-wave timers already isolate the host ``readback``
        phase inside the wave, so they report it here instead of the
        fused loop's between-calls gap."""
        self._reg.inc("host_sec_total", max(0.0, sec))

    def record_quantum(
        self, call_sec: float, waves: int, unique: int, committed: bool,
        states: Optional[int] = None, cand_lanes: Optional[int] = None,
        occupancy: Optional[float] = None,
    ) -> None:
        """Fold one device-call quantum into the vitals.  Aborted
        (flagged) quanta count latency but not rates: their unique delta
        is zero by construction and would drag the EMA to the floor.
        ``states``/``cand_lanes`` feed the density telemetry (see the
        class docstring), ``occupancy`` the load-factor trajectory."""
        waves = max(1, int(waves))
        self._reg.observe(
            "wave_latency_sec", call_sec / waves, count=waves,
            boundaries=self._latency_buckets,
        )
        self.last_density = None  # stale density must not journal on abort
        if not committed:
            return
        if occupancy is not None:
            self._reg.observe(
                "load_factor", occupancy,
                boundaries=self._fraction_buckets,
            )
        if states is not None and cand_lanes:
            if self._last_states is not None:
                density = (
                    max(0, states - self._last_states) / waves / cand_lanes
                )
                self.last_density = density
                self._density_ema = (
                    density if self._density_ema is None
                    else self._density_ema
                    + self.EMA_ALPHA * (density - self._density_ema)
                )
                self._reg.observe(
                    "valid_density", density, count=waves,
                    boundaries=self._fraction_buckets,
                )
                self._reg.update(
                    valid_density_ema=round(self._density_ema, 6),
                )
            self._last_states = states
        self._waves_since_grow += waves
        if call_sec > 0:
            wave_rate = waves / call_sec
            if self._last_unique is not None:
                uniq_rate = max(0, unique - self._last_unique) / call_sec
                self._uniq_ema = (
                    uniq_rate if self._uniq_ema is None
                    else self._uniq_ema
                    + self.EMA_ALPHA * (uniq_rate - self._uniq_ema)
                )
            self._wave_ema = (
                wave_rate if self._wave_ema is None
                else self._wave_ema
                + self.EMA_ALPHA * (wave_rate - self._wave_ema)
            )
            self._reg.update(
                waves_per_sec_ema=round(self._wave_ema, 4),
                **(
                    {"uniq_per_sec_ema": round(self._uniq_ema, 2)}
                    if self._uniq_ema is not None else {}
                ),
            )
        self._last_unique = unique

    def record_overflow_recovery(self) -> None:
        self._reg.inc("overflow_retries", 1)
        self._reg.observe(
            "waves_per_grow", max(1, self._waves_since_grow),
            boundaries=self._count_buckets,
        )
        self._waves_since_grow = 0


def journal_geometry(eng) -> None:
    """One ``geometry`` journal event at loop start: the engine's live
    geometry knobs (``_wl_geometry()``)."""
    if eng._journal:
        eng._journal.append("geometry", **eng._wl_geometry())


def log_grow(eng, flags: int, grown: str, unique: int, depth: int) -> None:
    """A growth's warning line, ``grow`` journal event and ``grows``
    metric.  The tiered engine's spill-instead-of-grow comes through here
    too, as in the JAX engine."""
    eng._metrics.inc("grows", 1)
    logging.getLogger(eng.__class__.__module__).warning(
        "auto-tune: overflow flags=%d; growing in place (%s) at "
        "unique=%d depth=%d", flags, grown, unique, depth,
    )
    if eng._journal:
        eng._journal.append(
            "grow", flags=flags, grown=grown, unique=unique, depth=depth
        )


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
        traced = eng._tracer is not None
        cadence = CheckpointCadence(eng._ckpt_every_waves, eng._ckpt_every_sec)
        journal_geometry(eng)
        after_commit = getattr(eng, "_wl_after_commit", None)
        retune = getattr(eng, "_wl_retune", None)
        call_waves = getattr(eng, "_wl_call_waves", lambda: 1)
        retryable = getattr(eng, "_wl_retryable_flags", lambda: RETRYABLE_FLAGS)()
        waves = 0
        eng._wl_publish()
        vitals = LoopVitals(eng._metrics, initial_unique=eng._unique_count,
                            initial_states=eng._state_count)
        # The untraced loop decomposes its host tail into named spans (one
        # ``host_span`` event a wave); a traced wave times its own phases.
        spans = None if traced else SpanRecorder(eng._journal, eng._metrics)

        def span(name):
            return nullcontext() if spans is None else spans.span(name)

        in_call_sec = 0.0  # the waves of the call so far
        while eng._wl_can_wave():
            t_call = time.monotonic()
            if spans is not None:
                spans.quantum_start(t_call)
                vitals.call_started(t_call)
            with step_annotation() if spans is None else spans.step():
                flags = eng._wl_wave()
            t_done = time.monotonic()
            call_sec = t_done - t_call
            phases = eng._wl_trace_phases()
            if phases is not None:
                # A traced wave's call time is its phases' span, as in the
                # JAX traced loop: the phases partition it.
                call_sec = sum(phases.values())
            waves += 1
            if spans is None:
                eng._wl_host_spans()  # a traced wave times them as phases
            else:
                spans.collect(eng)
                vitals.call_ended(t_done)
                spans.tail_start(t_done)
            if not flags:
                eng._wl_publish()
            occupancy = eng._wl_occupancy()
            ended = call_waves()
            in_call_sec += call_sec
            if ended:
                vitals.record_quantum(
                    in_call_sec, ended, eng._unique_count,
                    committed=not flags, states=eng._state_count,
                    cand_lanes=eng._wl_cand_lanes(), occupancy=occupancy,
                )
                in_call_sec = 0.0
            density = vitals.last_density if ended else None
            if phases is not None:
                vitals.record_host(phases.get("readback", 0.0))
            eng._metrics.update(waves=waves,
                                table_occupancy=round(occupancy, 6),
                                last_call_sec=round(call_sec, 6))
            eng._metrics.inc("device_call_sec_total", call_sec)
            eng._metrics.inc("device_calls", 1)
            if eng._journal:
                with span("journal"):
                    eng._journal.append(
                        "wave", waves=waves, remaining=eng._wl_remaining(),
                        unique=eng._unique_count, states=eng._state_count,
                        depth=eng._wl_depth(), flags=flags,
                        call_sec=round(call_sec, 6 if traced else 4),
                        mono=round(t_call, 6),
                        occupancy=round(occupancy, 6),
                        **(
                            {"density": round(density, 6)}
                            if density is not None else {}
                        ),
                        **eng._wl_wave_extra(),
                    )
            if not flags:
                # The spill rung, at the committed boundary, so the
                # cadence below persists the post-spill state.
                if after_commit is not None:
                    with span("spill"):
                        after_commit()
                if retune is not None and ended:
                    with span("retune"):
                        retune(density, eng._wl_remaining())
                if (
                    not traced and eng._checkpoint_path is not None
                    and cadence.due(1)
                ):
                    with span("checkpoint"):
                        t_ck = time.monotonic()
                        extra = eng._wl_write_checkpoint()
                        cadence.mark()
                        if eng._journal:
                            eng._journal.append(
                                "checkpoint", path=eng._checkpoint_path,
                                unique=eng._unique_count,
                                depth=eng._wl_depth(),
                                write_sec=round(time.monotonic() - t_ck, 4),
                                **extra,
                            )
                if loop_should_break(eng, eng._wl_remaining(), eng._wl_depth(),
                                     deadline):
                    break
                continue
            fatal = flags & ~retryable
            if fatal:
                raise RuntimeError(eng._wl_overflow_message(fatal))
            # A run past its budget (or asked to stop) keeps its partial
            # result rather than grow.  The flagged wave committed
            # nothing, but its aborted insert may have written keys into
            # the table: erase them first, or a resumed snapshot would
            # treat the wave's states as visited and drop their subtrees.
            if past_deadline_or_stopped(eng, deadline):
                eng._wl_abort_cleanup()
                break
            with span("grow"):
                eng._wl_grow(flags)
            vitals.record_overflow_recovery()
        if spans is not None:
            # The last tail has no next wave to account it.
            vitals.record_host(spans.finish(time.monotonic()))
        return waves


class WaveView(NamedTuple):
    """What one quantum's readback says (the JAX ``WaveView``): everything
    the fused loop journals, checkpoints, grows and stops on."""

    waves_this_call: int  # counted as the JAX loop counts: waves_per_call
    remaining: int  # states left in the current level
    depth: int
    flags: int
    unique: int
    states: int
    occupancy: float  # the table's load
    discoveries: tuple  # ((property name, position), ...)
    extra: dict  # the wave event's engine fields (the tail)


class FusedWaveLoop:
    """The fused host loop (the JAX ``FusedWaveLoop``,
    ``stateright_tpu/parallel/wave_loop.py:628-807``): one engine call runs
    a quantum of up to ``waves_per_call`` waves on the card, one readback
    decodes it into a :class:`WaveView`, and the host journals it (one
    ``wave`` event a quantum, JAX's fields), runs the density tuners after
    a committed quantum, keeps the checkpoint cadence in quanta, grows on
    a flagged quantum (whose flagged wave committed nothing) and stops on
    :func:`loop_should_break`.  The engine adapter provides
    ``_wl_call()``, ``_wl_view() -> WaveView``, ``_wl_publish()``,
    ``_wl_grow(flags)``, ``_wl_retryable_flags()``,
    ``_wl_overflow_message(flags)``, ``_wl_abort_cleanup()``,
    ``_wl_write_checkpoint()`` and ``_wl_cand_lanes()``, and the tuners'
    hooks (``_wl_apply_sort_rung``, ``_wl_apply_step_rung``)."""

    def __init__(self, eng):
        self.eng = eng

    def run(self, deadline: Optional[float] = None) -> int:
        """Run to the end of the search, or to the wall ``deadline`` or a
        stop request; returns the waves counted (``waves_per_call`` a
        quantum, re-runs after growth included)."""
        eng = self.eng
        cadence = CheckpointCadence(eng._ckpt_every_waves, eng._ckpt_every_sec)
        eng._wl_publish()
        vitals = LoopVitals(eng._metrics, initial_unique=eng._unique_count,
                            initial_states=eng._state_count)
        spans = SpanRecorder(eng._journal, eng._metrics)
        journal_geometry(eng)
        waves_total = 0
        while True:
            spans.quantum_start(time.monotonic())
            t_call = time.monotonic()
            vitals.call_started(t_call)
            with spans.step():
                eng._wl_call()
            with spans.span("readback"):
                view = eng._wl_view()
            spans.collect(eng)
            t_done = time.monotonic()
            call_sec = t_done - t_call
            vitals.call_ended(t_done)
            spans.tail_start(t_done)
            vitals.record_quantum(
                call_sec, view.waves_this_call, view.unique,
                committed=view.flags == 0, states=view.states,
                cand_lanes=eng._wl_cand_lanes(), occupancy=view.occupancy,
            )
            waves_total += view.waves_this_call
            eng._wl_publish()
            if eng._journal:
                with spans.span("journal"):
                    eng._journal.append(
                        "wave", waves=waves_total, remaining=view.remaining,
                        unique=view.unique, states=view.states,
                        depth=view.depth, flags=view.flags,
                        call_sec=round(call_sec, 4), mono=round(t_call, 6),
                        occupancy=round(view.occupancy, 6),
                        **(
                            {"density": round(vitals.last_density, 6)}
                            if vitals.last_density is not None else {}
                        ),
                        **view.extra,
                    )
            eng._metrics.update(waves=waves_total,
                                table_occupancy=round(view.occupancy, 6),
                                last_call_sec=round(call_sec, 6))
            eng._metrics.inc("device_call_sec_total", call_sec)
            eng._metrics.inc("device_calls", 1)
            if view.flags == 0:
                with spans.span("retune"):
                    maybe_retune_sort(eng, vitals.last_density)
                    # remaining == 0: the run is about to stop.
                    maybe_retune_step(eng, view.remaining or None)
            if (
                eng._checkpoint_path is not None and view.flags == 0
                and cadence.due(view.waves_this_call)
            ):
                with spans.span("checkpoint"):
                    t_ck = time.monotonic()
                    extra = eng._wl_write_checkpoint()
                    cadence.mark()
                    if eng._journal:
                        eng._journal.append(
                            "checkpoint", path=eng._checkpoint_path,
                            unique=view.unique, depth=view.depth,
                            write_sec=round(time.monotonic() - t_ck, 4),
                            **extra,
                        )
            if view.flags:
                fatal = view.flags & ~eng._wl_retryable_flags()
                if fatal:
                    raise RuntimeError(eng._wl_overflow_message(fatal))
                # A run past its budget (or asked to stop) keeps its
                # partial result; the flagged wave's aborted insert may
                # have written keys, which the cleanup erases.
                if past_deadline_or_stopped(eng, deadline):
                    eng._wl_abort_cleanup()
                    break
                with spans.span("grow"):
                    eng._wl_grow(view.flags)
                vitals.record_overflow_recovery()
                continue
            if loop_should_break(eng, view.remaining, view.depth, deadline):
                break
        vitals.record_host(spans.finish(time.monotonic()))
        return waves_total


def finalize_run(eng) -> None:
    """The run's tail: the completion checkpoint (a run with a
    ``checkpoint_path`` always ends with a resumable snapshot) and the
    ``engine_done`` journal event."""
    if eng._checkpoint_path is not None:
        eng._write_snapshot(eng._checkpoint_path)
        if eng._journal:
            eng._journal.append(
                "checkpoint", path=eng._checkpoint_path,
                unique=eng._unique_count, depth=eng._max_depth, final=True,
            )
    if eng._journal:
        eng._journal.append(
            "engine_done", unique=eng._unique_count,
            states=eng._state_count, depth=eng._max_depth,
        )


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
