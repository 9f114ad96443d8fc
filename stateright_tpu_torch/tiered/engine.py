"""The tiered out-of-core wavefront checker: a hot table on the card, cold
runs in host RAM (or on disk).

The counterpart of ``stateright_tpu/tiered/engine.py`` (``TieredTpuChecker``,
``capacity_for_budget``).  It runs the same wavefront BFS as
:class:`~stateright_tpu_torch.parallel.wavefront.GpuChecker` under a fixed
device budget: the card's hash table is the *hot tier*, and once the
entries inserted since the last spill reach ``spill_threshold`` of its
slots, the fingerprints of every state committed since then are evicted to
the host :class:`~stateright_tpu_torch.tiered.cold_store.ColdStore` as one
sorted immutable run and the hot table is emptied.

Each wave runs the in-HBM pipeline -- step, fingerprint, the hot-table
insert -- plus one stage between the readback and the append: the keys the
hot tier reports new are merge-joined against the cold tier (K20,
``tiered/cold_join.py``).  The wave's unsigned minimum and maximum new key
ride its one readback; the host prunes each run to the window between them
(``np.searchsorted``) and streams the window through the card
``cold_chunk`` keys a pass, padded with the all-ones key.  A key found cold
is a duplicate: its row is not appended, so positions, parents, depths and
the discovery set are those of an unconstrained run.  The hot table keeps
cold-hit keys, so repeats of an evicted state are answered there until the
next spill drops them (they are in an earlier run already).

Overflow flag 1 (the hot table past half full) SPILLS instead of growing:
the budget is a hard cap.  Flags 2 and 4 grow as in the base engine.  The
row log is not budgeted: it holds every state's row, as the base engine's
does.  ``spill`` and ``cold_probe`` journal events carry the JAX engine's
fields and accounting; snapshots carry the whole cold store under the key
suffix ``+tiered-v1``, so either package resumes the other's tiered
snapshot.  ``trace=True`` times the base engine's phases plus the cold
filter, as the host-classed ``cold_probe`` phase.
"""

from __future__ import annotations

import math
import time
from typing import List, Optional

import numpy as np
import torch

from ..ops.device_fp import fp64_of
from ..parallel.wave_common import compact
from ..parallel.wavefront import GpuChecker, Wave
from .cold_join import cold_probe, cold_query, cold_windows, load_chunk
from .cold_store import ColdStore

# What one hot-table slot costs on the card: one 16-byte {key, tag} slot,
# the 64-bit key word beside K4's 64-bit election tag (csrc/hashset.cu).
# The JAX engine's slot is 12 bytes (8 key bytes and a transient 4-byte
# claim plane), so at some budgets the two packages size different
# tables: 0.875 MB gives 65,536 slots there and 32,768 here.  The
# discovery set does not depend on the budget.
_BYTES_PER_SLOT = 16
_MIN_CAPACITY = 256
_M64 = (1 << 64) - 1


def capacity_for_budget(memory_budget_mb: float) -> int:
    """The largest power-of-two hot-table capacity whose bytes on the card
    (16 a slot: key word and election tag) fit ``memory_budget_mb``.
    Fractional budgets are allowed; one too small for the 256-slot minimum
    table raises rather than round up past the cap."""
    if not math.isfinite(float(memory_budget_mb)) or memory_budget_mb <= 0:
        raise ValueError("memory_budget_mb must be a positive finite size")
    slots = int(float(memory_budget_mb) * (1 << 20)) // _BYTES_PER_SLOT
    if slots < _MIN_CAPACITY:
        raise ValueError(
            f"memory_budget_mb={memory_budget_mb} cannot hold the "
            f"{_MIN_CAPACITY}-slot minimum hot table "
            f"({_MIN_CAPACITY * _BYTES_PER_SLOT} bytes = "
            f"{_MIN_CAPACITY * _BYTES_PER_SLOT / (1 << 20):.4f} MB)"
        )
    return 1 << (slots.bit_length() - 1)


class TieredGpuChecker(GpuChecker):
    """Budget-bounded wavefront checker behind the standard surface."""

    engine_name = "gpu-tiered"
    spawn_name = "spawn_gpu_tiered()"
    # One wave a call, as the JAX tiered engine drives its loop: the cold
    # filter runs on the host between a wave's readback and its append.
    _fused = False

    def __init__(
        self,
        options,
        memory_budget_mb: Optional[float] = None,
        spill_threshold: float = 0.45,
        cold_chunk: int = 1 << 15,
        cold_max_runs: int = 8,
        cold_dir: Optional[str] = None,
        **kwargs,
    ):
        """``memory_budget_mb`` bounds the HOT fingerprint table on the
        card; given, it derives ``capacity`` (:func:`capacity_for_budget`)
        over any explicit one (pass ``capacity`` alone to force an exact
        table).  The row log keeps the base engine's ``log_capacity`` and
        growth.  ``spill_threshold``: the hot load at which a committed wave
        triggers eviction, in (0, 0.5] (the insert flags the table overfull
        past half).  ``cold_chunk``: keys a cold-probe pass streams (a power
        of two; ``8 * cold_chunk`` bytes).  ``cold_max_runs``: the run
        count past which the cold store merges its runs.  ``cold_dir``:
        keep the runs on disk there, memory-mapped.  Every other keyword is
        :class:`GpuChecker`'s; with ``trace=True`` each traced wave's
        breakdown gains ``cold_probe``, the cold filter's host-classed
        seconds (the whole filter: windowing, K20 passes and the fresh
        lanes' compaction).  Visitors are refused, as in the JAX
        engine."""
        if options._visitor is not None:
            raise ValueError(
                "spawn_gpu_tiered() does not support visitors (they "
                "require the traced readback path); use spawn_gpu for "
                "visitor-instrumented runs"
            )
        if not 0.0 < float(spill_threshold) <= 0.5:
            raise ValueError(
                "spill_threshold must be in (0, 0.5]: the insert flags "
                "the table overfull beyond 50% load"
            )
        if cold_chunk < 2 or cold_chunk & (cold_chunk - 1):
            raise ValueError("cold_chunk must be a power of two >= 2")
        if memory_budget_mb is not None:
            kwargs["capacity"] = capacity_for_budget(memory_budget_mb)
        # Every tiered attribute lands before the base constructor, which
        # starts the run thread as its last statement.
        self._memory_budget_mb = (
            None if memory_budget_mb is None else float(memory_budget_mb)
        )
        self._spill_threshold = float(spill_threshold)
        self._cold_chunk = int(cold_chunk)
        self._cold = ColdStore(spill_dir=cold_dir, max_runs=cold_max_runs)
        self._hot_entries = 0  # hot-table entries since the last spill
        self._spill_tail = 0  # log positions below this are in the cold tier
        self._cold_last: Optional[dict] = None  # the last wave's cold pass
        self._wave_hot = 0  # the filtered wave's hot-new count
        self._chunk_buf: Optional[torch.Tensor] = None
        super().__init__(options, **kwargs)

    # --- budget -------------------------------------------------------------

    def _grow_knob(self, flag: int) -> Optional[str]:
        """Flag 1 never grows the table: the budget is a hard cap, and the
        loop spills instead (:meth:`_grow_knobs`).  So a seed-time overflow
        (the init states alone overfill the table) is an error."""
        if flag == 1:
            return None
        return super()._grow_knob(flag)

    def _seed(self):
        carry = super()._seed()
        self._hot_entries = carry.unique_count
        self._spill_tail = 0
        return carry

    # --- the tiered wave ----------------------------------------------------

    def _wl_wave(self) -> int:
        self._cold_last = None
        return super()._wl_wave()

    def _wave_extra_stats(self, wave: Wave):
        """With cold runs present, K20's query: the new keys' unsigned
        minimum and maximum join the wave's one readback."""
        if not self._cold.run_count:
            return []
        return [cold_query(wave.hi, wave.lo, wave.u_origin, wave.is_new)]

    # Flag 2 waits for the cold filter and tests the fresh count.
    _filters_new_lanes = True
    # A traced wave times the cold filter as its own, host-classed phase.
    _filter_phase = "cold_probe"

    def _table_entries(self) -> int:
        """Flag 1 counts the hot table's entries since the last spill, not
        the unique states."""
        return self._hot_entries

    def _wave_filter(self, wave: Wave) -> None:
        """The cold filter, when the wave has new keys and cold runs exist."""
        self._wave_hot = wave.n_new
        if wave.n_new and self._cold.run_count:
            t0 = time.monotonic()
            self._cold_last = self._cold_filter(wave)
            # Host wall time of the filter: windowing, chunk copies, K20's
            # launches and the fresh count's readback.
            sec = time.monotonic() - t0
            self._metrics.inc("cold_probe_sec_total", sec)
            self._host_spans.append(("cold_probe", t0, sec))

    def _cold_filter(self, wave: Wave) -> dict:
        """Merge-join the wave's hot-new keys against every cold run: the
        host prunes each run to the window between the new keys' minimum
        and maximum, and the window streams through K20 ``cold_chunk`` keys
        a pass.  Leaves the fresh lanes' compaction in ``wave.sel`` and
        their count in ``wave.n_new``; returns the pass accounting."""
        lo_key, hi_key = (x & _M64 for x in wave.extra[:2])
        chunk = self._cold_chunk
        if self._chunk_buf is None or self._chunk_buf.shape[0] != chunk:
            self._chunk_buf = torch.empty((chunk,), dtype=torch.int64,
                                          device=self._device)
        buf = self._chunk_buf
        passes = runs_touched = window_entries = 0
        for run, a, b in cold_windows(self._cold.runs, lo_key, hi_key):
            runs_touched += 1
            window_entries += b - a
            for off in range(a, b, chunk):
                load_chunk(buf, np.asarray(run[off:off + chunk]))
                cold_probe(wave.hi, wave.lo, wave.u_origin, wave.is_new, buf)
                passes += 1
        wave.sel, n_fresh = compact(wave.is_new, wave.is_new.shape[0])
        n_hot = wave.n_new
        wave.n_new = int(n_fresh)
        return {
            "passes": passes,
            "bytes": passes * chunk * 8,
            "runs_touched": runs_touched,
            "window_entries": window_entries,
            "new": n_hot,
            "hits": n_hot - wave.n_new,
        }

    def _wave_commit(self, wave: Wave) -> None:
        super()._wave_commit(wave)
        self._hot_entries += self._wave_hot
        cold = self._cold_last
        if cold is not None:
            c = self._carry
            if self._journal:
                self._journal.append(
                    "cold_probe", depth=c.depth, unique=c.unique_count, **cold
                )
            self._metrics.inc("cold_probe_passes_total", cold["passes"])
            self._metrics.inc("cold_probe_bytes_total", cold["bytes"])
            self._metrics.inc("cold_hits_total", cold["hits"])

    # --- spill and recovery -------------------------------------------------

    def _wl_after_commit(self) -> None:
        """The eviction trigger after a committed wave, on the host's exact
        count of hot entries; a spill reads the table's measured load once
        for its journal event and the ``hot_load_factor`` metric."""
        if self._hot_entries / self._capacity >= self._spill_threshold:
            lf = self._carry.table.load_factor()
            self._metrics.update(hot_load_factor=round(lf, 6))
            self._spill("threshold", lf)

    def _segment_fingerprints(self, start: int, end: int) -> np.ndarray:
        """The uint64 identity fingerprints of log positions ``[start,
        end)`` (K1, after K15 under symmetry), in log order."""
        if end <= start:
            return np.zeros((0,), np.uint64)
        keys = [
            fp64_of(hi, lo)
            for hi, lo in self._identity_fingerprints(self._carry.rows, start, end)
        ]
        return torch.cat(keys).to("cpu").numpy().view(np.uint64)

    def _spill(self, reason: str, load_factor: float) -> None:
        """Evict the hot tier: the fingerprints of log positions
        ``[spill_tail, tail)`` become one sorted cold run (from the log, so
        keys an aborted insert wrote never reach the cold tier), the hot
        table empties and the watermark advances.  Cold-hit cache entries
        are dropped: they are in an earlier run already."""
        c = self._carry
        start, end = self._spill_tail, c.tail
        t0 = time.monotonic()
        fps = self._segment_fingerprints(start, end)
        self._cold.add_run(fps)
        self._hot_entries = 0
        self._spill_tail = end
        c.table.keys.zero_()
        if self._journal:
            self._journal.append(
                "spill", reason=reason, entries=int(fps.shape[0]),
                bytes=int(fps.nbytes), start=start, end=end,
                load_factor=round(float(load_factor), 6),
                cold_runs=self._cold.run_count,
                cold_entries=self._cold.entries,
                spill_sec=round(time.monotonic() - t0, 4),
            )
        self._metrics.inc("spills", 1)
        self._metrics.inc("spill_bytes_total", int(fps.nbytes))
        self._metrics.update(
            cold_runs=self._cold.run_count,
            cold_entries=self._cold.entries,
            cold_bytes=self._cold.nbytes,
        )

    def _grow_knobs(self, flags: int, qcap: int) -> List[str]:
        """Flags 2 and 4 grow as in the base engine; flag 1 spills (the
        budget pins the capacity), or, with the hot table already empty,
        halves ``max_frontier`` (down to 8) until one wave's new keys fit.
        Flag 1 recovers whatever ``auto_tune`` says, as in JAX."""
        notes = super()._grow_knobs(flags & ~1, qcap)
        if flags & 1:
            if self._hot_entries:
                notes.append(f"spill (budget pins capacity={self._capacity})")
            else:
                if self._max_frontier <= 8:
                    raise RuntimeError(self._wl_overflow_message(flags))
                self._max_frontier //= 2
                notes.append(f"max_frontier={self._max_frontier}")
        return notes

    def _grow_refused(self, flags: int, bit: int) -> str:
        return self._wl_overflow_message(flags)

    def _reset_table(self, flags: int) -> None:
        """A flag-1 recovery with hot entries spills, which empties the hot
        table; any other reset rehashes the committed ``[spill_tail,
        tail)`` segment.  Either way no aborted wave's key, and no cold-hit
        entry, survives."""
        if flags & 1 and self._hot_entries:
            self._spill("overflow", self._hot_entries / self._capacity)
            return
        c = self._carry
        c.table = self._rehash(c.rows, c.tail, self._spill_tail)
        self._hot_entries = c.tail - self._spill_tail

    def _wl_overflow_message(self, flags: int) -> str:
        if flags & 8:
            return super()._wl_overflow_message(flags)
        return f"tiered engine overflow flags={flags}"

    def _wl_occupancy(self) -> float:
        return self._hot_entries / self._capacity

    def _wl_wave_extra(self) -> dict:
        out = {
            "tail": self._carry.tail,
            "hot_entries": self._hot_entries,
            "cold_runs": self._cold.run_count,
        }
        if self._cold_last is not None:
            out["cold_passes"] = self._cold_last["passes"]
            out["cold_bytes"] = self._cold_last["bytes"]
        out.update(self._trace_record or {})
        return out

    # --- snapshots ----------------------------------------------------------

    def _check_snapshot(self, arrays) -> None:
        if "tiered_spill_tail" not in arrays:
            raise ValueError(
                "snapshot was not written by the tiered engine (no "
                "persisted cold tier); resume it with spawn_gpu, or re-run "
                "the tiered check to produce a tiered snapshot"
            )
        if self._memory_budget_mb is not None and (
            capacity_for_budget(self._memory_budget_mb) != int(arrays["capacity"])
        ):
            raise ValueError(
                f"resume memory_budget_mb={self._memory_budget_mb} implies a "
                f"{capacity_for_budget(self._memory_budget_mb)}-slot hot "
                f"table, but the snapshot was written at "
                f"capacity={int(arrays['capacity'])}; resume with the "
                "snapshot's original budget (or with capacity alone to adopt "
                "its geometry)"
            )
        super()._check_snapshot(arrays)

    def _restore_extra(self, arrays) -> dict:
        self._spill_tail = int(arrays["tiered_spill_tail"])
        self._hot_entries = int(arrays["tiered_hot_entries"])
        self._cold = ColdStore.from_arrays(
            np.asarray(arrays["tiered_cold_fps"]),
            np.asarray(arrays["tiered_cold_lens"]),
            spill_dir=self._cold.spill_dir, max_runs=self._cold.max_runs,
        )
        return {
            "cold_runs": self._cold.run_count,
            "cold_entries": self._cold.entries,
            "spill_tail": self._spill_tail,
        }

    def _snapshot_key(self) -> str:
        # Tiered snapshots do not resume in the in-HBM engine (the hot
        # table holds only the states since the last spill), nor the
        # reverse.
        return super()._snapshot_key() + "+tiered-v1"

    def _snapshot_extra(self) -> dict:
        """The cold store's runs (concatenated, with each run's length, so a
        resume restores the exact run shape), the spill watermark and the
        hot-entry count."""
        cold_fps, cold_lens = self._cold.to_arrays()
        return {
            "tiered_cold_fps": cold_fps,
            "tiered_cold_lens": cold_lens,
            "tiered_spill_tail": self._spill_tail,
            "tiered_hot_entries": self._hot_entries,
        }

    def _wl_write_checkpoint(self) -> dict:
        super()._wl_write_checkpoint()
        return {
            "tail": self._carry.tail,
            "cold_runs": self._cold.run_count,
            "cold_entries": self._cold.entries,
        }

    # --- surface ------------------------------------------------------------

    def tuned_kwargs(self) -> dict:
        """The base engine's right-sized kwargs with ``capacity`` pinned at
        this run's budgeted table (twice the unique count would un-tier the
        workload)."""
        out = super().tuned_kwargs()
        out["capacity"] = self._capacity
        return out

    def _wl_geometry(self) -> dict:
        out = super()._wl_geometry()
        out["spill_threshold"] = self._spill_threshold
        if self._memory_budget_mb is not None:
            out["memory_budget_mb"] = self._memory_budget_mb
        return out

    def metrics(self) -> dict:
        out = super().metrics()
        out.update(
            spill_threshold=self._spill_threshold,
            cold_chunk=self._cold_chunk,
            cold_runs=self._cold.run_count,
            cold_entries=self._cold.entries,
            cold_bytes=self._cold.nbytes,
            hot_entries=self._hot_entries,
            spill_tail=self._spill_tail,
        )
        if self._memory_budget_mb is not None:
            out["memory_budget_mb"] = self._memory_budget_mb
        return out
