"""Tiered x sharded: exact checking over a mesh under a per-shard budget.

The counterpart of ``stateright_tpu/tiered/sharded_engine.py``
(``TieredShardedTpuChecker``).  It composes the sharded checker
(:class:`~stateright_tpu_torch.parallel.sharded.ShardedGpuChecker`: every
fingerprint has one owner shard, successors are exchanged each wave) with
the tiered one (:class:`~stateright_tpu_torch.tiered.engine.
TieredGpuChecker`: a hot table bounded by ``memory_budget_mb``, evicted
partitions as sorted cold runs on the host).  The composition is
owner-local: shard ``d``'s cold runs hold only keys shard ``d`` owns, so
the cold filter of a wave needs no cross-shard lookup, like the hot
insert.  Each shard has its own :class:`ColdStore` (under
``cold_dir/shard_<d>/`` when disk-backed), spill watermark and budgeted hot
table.

Unlike the sharded checker's slot-indexed store, a shard's log is the
BFS-ordered row log (the tiered layout), and global ids are positional,
``log_position * n_shards + shard``: they stay valid across spills, plane
rebuilds and log growth, and :mod:`.reshard` can translate them to another
mesh width.

A wave runs the sharded checker's phases -- ``step`` over the log slice
``[level_start, level_end)``, ``canon``, ``prededup``, ``exchange``,
``insert`` -- then one readback of every shard's flags and new-lane counts
(with K20's query of each owner that has cold runs), then the cold filter
on each such owner's card (K20 passes over its runs' windows, the port's
tiered route; the JAX engine asks ``ColdStore.contains`` on the host and
gets the same fresh masks), then the fresh-masked append (K28).  An
aborted wave leaves the logs and every counter as they were and marks the
hot planes dirty; recovery rebuilds them from the committed log segments.
Snapshots carry the JAX engine's ``ts_*`` arrays under its key suffix;
key planes are never persisted.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.device_fp import device_fp64, fp64_of
from ..ops.fingerprint import fp64_words
from ..ops.u32 import M32, from_numpy_u32, i32, to_numpy_u32
from ..parallel.exchange import gather_to, owner_mix_host_np, shard_log_append
from ..parallel.hashset import HashSet, insert_batch_claim
from ..parallel.sharded import (
    _R_BOVF, _R_DISC, _R_NEW, _R_OK, _R_REPS, _R_STEP, _R_VALID, NO_GID,
    ShardedGpuChecker, _Shard, resolve_mesh,
)
from ..parallel.wave_loop import (
    WaveLoop, finalize_run, fingerprints_of_rows, log_grow,
)
from .cold_join import cold_probe, cold_query, cold_windows, load_chunk
from .cold_store import ColdStore
from .engine import _M64, capacity_for_budget

# The snapshot key's suffix (the JAX engine's): a tiered-sharded snapshot
# resumes only here, and the reshard writes it.
TS_SUFFIX = "+tiered-sharded-v1"
# Keys a K20 pass streams (8 bytes each), the tiered checker's default.
COLD_CHUNK = 1 << 15


class TieredShardedGpuChecker(ShardedGpuChecker):
    """Sharded wavefront checker with budget-bounded per-shard hot tables
    and owner-local cold tiers."""

    engine_name = "gpu-tiered-sharded"
    spawn_name = "spawn_gpu_tiered_sharded()"

    def __init__(
        self,
        options,
        memory_budget_mb: Optional[float] = None,
        spill_threshold: float = 0.45,
        cold_max_runs: int = 8,
        cold_dir: Optional[str] = None,
        **kwargs,
    ):
        """``memory_budget_mb`` bounds EACH shard's hot table (16 bytes a
        slot, :func:`~.engine.capacity_for_budget`) and, when given,
        derives the per-shard capacity over any explicit ``capacity``.
        ``spill_threshold``, ``cold_max_runs`` and ``cold_dir`` keep the
        tiered checker's contracts; with ``cold_dir``, shard ``d`` spills
        under ``cold_dir/shard_<d>/``, so sibling stores never share a
        directory.  Every other keyword is :class:`ShardedGpuChecker`'s.
        ``trace=True`` is refused, as in the JAX engine: trace
        ``spawn_gpu_tiered`` or ``spawn_gpu_sharded`` instead."""
        if kwargs.get("trace"):
            raise ValueError(
                "spawn_gpu_tiered_sharded(trace=True) is not supported: "
                "the tiered-sharded loop is already host-driven per "
                "wave; run the roofline trace on spawn_gpu_tiered or "
                "spawn_gpu_sharded instead"
            )
        if not 0.0 < float(spill_threshold) <= 0.5:
            raise ValueError(
                "spill_threshold must be in (0, 0.5]: the insert flags "
                "the table overfull beyond 50% load"
            )
        mesh = resolve_mesh(kwargs.get("mesh"), self.spawn_name)
        kwargs["mesh"] = mesh
        n = len(mesh)
        # The budget derives the per-shard capacity; the base constructor
        # floors it at 1,024 slots, so the budgeted one is re-pinned when
        # the run starts.
        self._ts_cap_s: Optional[int] = None
        if memory_budget_mb is not None:
            self._ts_cap_s = capacity_for_budget(memory_budget_mb)
            kwargs["capacity"] = self._ts_cap_s * n
        self._memory_budget_mb = (
            None if memory_budget_mb is None else float(memory_budget_mb)
        )
        self._spill_threshold = float(spill_threshold)
        self._cold_max_runs = int(cold_max_runs)
        self._cold_dir = cold_dir
        self._colds = [self._cold_store(d) for d in range(n)]
        self._chunk_bufs: Dict[torch.device, torch.Tensor] = {}
        self._flag1_shards: List[bool] = [False] * n
        self._planes_dirty = False
        self._log_cap = 0  # per-shard row-log capacity (doubles on flag 2)
        self._pad = 0  # slice padding past it, minted at run start
        self._cold_last: Optional[dict] = None
        kwargs["waves_per_call"] = 1
        # The base constructor starts the run thread as its last statement.
        super().__init__(options, **kwargs)

    def _cold_store(self, d: int, fps=None, lens=None) -> ColdStore:
        spill_dir = (None if self._cold_dir is None
                     else os.path.join(self._cold_dir, f"shard_{d}"))
        if fps is None:
            return ColdStore(spill_dir=spill_dir, max_runs=self._cold_max_runs)
        return ColdStore.from_arrays(fps, lens, spill_dir=spill_dir,
                                     max_runs=self._cold_max_runs)

    # --- run ------------------------------------------------------------------

    def _run(self) -> None:
        try:
            timeout = self._options._timeout
            deadline = None if timeout is None else time.monotonic() + timeout
            if self._ts_cap_s is not None:
                self._cap_s = self._ts_cap_s
                self._slot_bits = max(1, self._cap_s.bit_length() - 1)
            if self._resume_from is not None:
                self._ts_resume()
            else:
                self._log_cap = self._cap_s
                self._pad = self._chunk
                if (self._log_cap + self._pad) * self._n >= 0xFFFFFFFF:
                    raise ValueError("capacity too large for 32-bit global ids")
                self._ts_seed()
            self._waves = WaveLoop(self).run(deadline)
            for dev in {d for d in self._mesh if d.type == "cuda"}:
                torch.cuda.synchronize(dev)
            self._accounting = self._build_accounting(self._waves)
            finalize_run(self)
        except BaseException as e:  # propagate at join, like the host engine
            self._errors.append(e)
        finally:
            self._done.set()

    def _new_log_shard(self, d: int, lp: int) -> _Shard:
        sh = _Shard(d, self._mesh[d])
        w, dev = self._compiled.state_width, sh.device
        sh.rows = torch.zeros((lp, w), dtype=torch.int32, device=dev)
        sh.parent = torch.full((lp,), -1, dtype=torch.int32, device=dev)
        sh.ebits = torch.zeros((lp,), dtype=torch.int32, device=dev)
        sh.cold = self._colds[d]
        sh.spill_tail = sh.hot = sh.spill_count = 0
        sh.disc = [NO_GID] * len(self._properties)
        return sh

    def _ts_seed(self) -> None:
        """The JAX ``_ts_seed``: canonical fingerprints and owner routing
        on the host, each shard's init states deduplicated in order, one
        upload, then a plane rebuild over the seeded prefix."""
        cm = self._compiled
        n = self._n
        init = cm.init_packed()
        if self._canon is not None:
            fp_rows = to_numpy_u32(self._canon(from_numpy_u32(init, "cpu")))
        else:
            fp_rows = init
        fps = np.array([fp64_words(row[: self._fp_words].tolist())
                        for row in fp_rows], np.uint64)
        owner = owner_mix_host_np(
            (fps >> np.uint64(32)).astype(np.uint32),
            (fps & np.uint64(M32)).astype(np.uint32),
        ).astype(np.int64) % n
        lp = self._log_cap + self._pad
        eb0 = (1 << len(self._ev_indices)) - 1
        eb0 = (eb0 ^ 0x80000000) - 0x80000000  # the int32 with its bits
        self._shards = []
        for d in range(n):
            seen, kept = set(), []
            for i in np.flatnonzero(owner == d):
                if int(fps[i]) not in seen:
                    seen.add(int(fps[i]))
                    kept.append(int(i))
            c = len(kept)
            if c * 2 > self._cap_s:
                raise RuntimeError(
                    "init-state seeding overflowed the budgeted per-shard "
                    f"fingerprint table (shard {d}: {c} distinct seeds vs "
                    f"capacity {self._cap_s}); raise memory_budget_mb (or "
                    "pass capacity=) past the init-state count"
                )
            sh = self._new_log_shard(d, lp)
            if c:
                sh.rows[:c] = from_numpy_u32(init[kept], sh.device)
                sh.ebits[:c] = eb0
            sh.tail = sh.level_end = sh.unique_l = sh.hot = c
            self._shards.append(sh)
        self._sc = init.shape[0]
        self._unique_g = sum(sh.tail for sh in self._shards)
        self._depth = 0
        self._rebuild_planes()
        with self._lock:
            self._state_count = self._sc
            self._unique_count = self._unique_g

    def _ts_resume(self) -> None:
        """Continue a tiered-sharded snapshot (either package's) on a mesh
        of its width: adopt its geometry, logs, watermarks and cold stores,
        and rebuild the hot planes from the committed segments."""
        n = self._n
        with np.load(self._resume_from, allow_pickle=False) as snap:
            arrays = {k: snap[k] for k in snap.files}
        if "ts_tails" not in arrays:
            raise ValueError(
                "snapshot was not written by the tiered-sharded engine "
                "(no per-shard tier state); resume it with the engine "
                "that wrote it, or convert a sharded snapshot with "
                "stateright_tpu_torch.tiered.reshard.reshard_snapshot"
            )
        if "n_shards" in arrays and int(arrays["n_shards"]) != n:
            m = int(arrays["n_shards"])
            raise ValueError(
                f"tiered-sharded snapshot was written on a {m}-shard mesh "
                f"and cannot resume on {n} shards directly: global state "
                "ids encode the owner shard; run the `reshard` verb "
                "(stateright_tpu_torch.tiered.reshard.reshard_snapshot) to "
                f"re-key it onto a {n}-shard mesh, or re-run on a "
                f"{m}-shard mesh"
            )
        if self._memory_budget_mb is not None and (
            capacity_for_budget(self._memory_budget_mb) != int(arrays["cap_s"])
        ):
            raise ValueError(
                f"resume memory_budget_mb={self._memory_budget_mb} implies a "
                f"{capacity_for_budget(self._memory_budget_mb)}-slot "
                "per-shard hot table, but the snapshot was written at "
                f"cap_s={int(arrays['cap_s'])}; resume with the snapshot's "
                "original budget (or with capacity kwargs alone to adopt "
                "its geometry)"
            )
        want, got = self._snapshot_key(), str(arrays["engine_key"])
        if got != want:
            raise ValueError(
                "snapshot does not match this tiered-sharded checker "
                f"configuration (snapshot {got}, expected {want})"
            )
        self._cap_s = int(arrays["cap_s"])
        self._slot_bits = max(1, self._cap_s.bit_length() - 1)
        self._chunk = int(arrays["chunk"])
        if "bucket_slack" in arrays:
            self._bucket_slack = int(arrays["bucket_slack"])
        if int(arrays.get("sort_lanes", 0)):
            self._sort_lanes = int(arrays["sort_lanes"])
            self._sort_tune = False
        if "sortless" in arrays:
            self._sortless = bool(int(arrays["sortless"]))
        if int(arrays.get("step_lanes", 0)):
            self._step_lanes = int(arrays["step_lanes"])
            self._step_tune = False
        self._log_cap = int(arrays["ts_log_cap"])
        w = self._compiled.state_width
        rows_h = np.asarray(arrays["rows"], np.uint32).reshape(n, -1, w)
        parent_h = np.asarray(arrays["parent"], np.uint32).reshape(n, -1)
        ebits_h = np.asarray(arrays["ebits"], np.uint32).reshape(n, -1)
        lp = rows_h.shape[1]
        # Every window slice fits past the log's end: pad >= chunk (a
        # resharded snapshot may carry a narrower pad).
        self._pad = max(lp - self._log_cap, self._chunk)
        lp = self._log_cap + self._pad
        if lp * n >= 0xFFFFFFFF:
            raise ValueError("capacity too large for 32-bit global ids")
        disc = np.asarray(arrays["disc"]).astype(np.uint32).reshape(n, -1)
        fps = np.asarray(arrays["ts_cold_fps"])
        lens = np.asarray(arrays["ts_cold_lens"], np.int64)
        runs_per = np.asarray(arrays["ts_cold_runs_per_shard"], np.int64)
        self._colds = []
        self._shards = []
        fp_off = len_off = 0
        for d in range(n):
            k = int(runs_per[d])
            d_lens = lens[len_off : len_off + k]
            cnt = int(d_lens.sum())
            self._colds.append(self._cold_store(d, fps[fp_off : fp_off + cnt],
                                                d_lens))
            fp_off += cnt
            len_off += k
            sh = self._new_log_shard(d, lp)
            old = rows_h.shape[1]
            sh.rows[:old] = from_numpy_u32(rows_h[d], sh.device)
            sh.parent[:old] = from_numpy_u32(parent_h[d], sh.device)
            sh.ebits[:old] = from_numpy_u32(ebits_h[d], sh.device)
            sh.level_start = int(arrays["ts_level_start"][d])
            sh.level_end = int(arrays["ts_level_end"][d])
            sh.tail = sh.unique_l = int(arrays["ts_tails"][d])
            sh.spill_tail = int(arrays["ts_spill_tails"][d])
            sh.cand = int(arrays["ts_cand"][d])
            sh.hot = sh.tail - sh.spill_tail
            sh.disc = [int(g) for g in disc[d]]
            self._shards.append(sh)
        self._depth = int(arrays["ts_depth"])
        self._unique_g = int(arrays["ts_unique"])
        self._sc = int(arrays["ts_states"])
        # Planes are never persisted: rebuilt from the committed logs, so
        # an aborted insert's keys never come back.
        self._rebuild_planes()
        with self._lock:
            self._state_count = self._sc
            self._unique_count = self._unique_g
            self._max_depth = self._depth
        self._fold_discoveries()
        if self._journal:
            self._journal.append(
                "resume", path=self._resume_from, unique=self._unique_g,
                states=self._sc, depth=self._depth,
                cold_runs=sum(c.run_count for c in self._colds),
                cold_entries=sum(c.entries for c in self._colds),
            )

    # --- the wave -------------------------------------------------------------

    def _chunk_states(self, sh: _Shard, count: int):
        """The next ``count`` states of the shard's level, from its row
        log; their global ids are ``position * n + shard``."""
        lo = sh.level_start
        pos = torch.arange(lo, lo + count, dtype=torch.int64, device=sh.device)
        gids = i32(pos * self._n + sh.index)
        return sh.rows[lo : lo + count], gids, sh.ebits[lo : lo + count]

    def _chunk_buf(self, dev: torch.device) -> torch.Tensor:
        buf = self._chunk_bufs.get(dev)
        if buf is None:
            buf = torch.empty((COLD_CHUNK,), dtype=torch.int64, device=dev)
            self._chunk_bufs[dev] = buf
        return buf

    def _wl_wave(self) -> int:
        """One wave (``sharded_engine.py:346-499``): the sharded phases to
        the insert, one readback of every shard's flags and new-lane
        counts (and K20's query where an owner has cold runs), the
        owner-local cold filter (K20), flag 2 on the fresh counts, then
        the fresh-masked append (K28) and the host commit.  Returns the
        flags; the wave committed iff they are 0."""
        self._cold_last = None
        shards = self._shards
        n = self._n
        f_eff = self._step_width()
        if f_eff < self._chunk and max(
            sh.level_end - sh.level_start for sh in shards
        ) > f_eff:
            # The step rung's clamp (flag 128) is host data: no dispatch.
            self._update_shard_metrics(None, None, None)
            return 128
        size, bkt = self._sort_width(), self._bucket_lanes()
        exp = [self._expand(sh, f_eff, size) for sh in shards]
        recvs, bovfs = self._phase_exchange(exp, bkt)
        ins = [self._phase_insert(sh, r, r.rv) for sh, r in zip(shards, recvs)]
        queries = []
        for sh, r, i in zip(shards, recvs, ins):
            if sh.cold.run_count:
                queries.append(cold_query(r.hi, r.lo, i.origin, i.is_new))
            else:
                queries.append(torch.zeros((2,), dtype=torch.int64,
                                           device=sh.device))
        got = self._wave_stats(exp, bovfs, ins,
                               [i.is_new.sum() for i in ins], queries)
        flags = 0
        if any(g[_R_VALID] > size for g in got):
            flags |= 4
        if any(g[_R_BOVF] for g in got):
            flags |= 32
        if any(g[_R_STEP] for g in got):
            flags |= 8
        new = [g[_R_NEW] for g in got]
        over = [not g[_R_OK] or (sh.hot + k) * 2 > self._cap_s
                for sh, g, k in zip(shards, got, new)]
        if any(over):
            flags |= 1
            self._flag1_shards = over
        fresh = list(new)
        cold = None
        if not flags and sum(new):
            cold = self._cold_filter(recvs, ins, got, new, fresh)
        if not flags and any(
            sh.tail + k > self._log_cap for sh, k in zip(shards, fresh)
        ):
            flags |= 2
        if flags:
            # The insert wrote this wave's keys into the hot planes: the
            # recovery rebuilds them from the committed logs.
            self._planes_dirty = True
            self._update_shard_metrics(None, None, None)
            return flags
        for sh, r, i in zip(shards, recvs, ins):
            shard_log_append(i.is_new, i.origin, r.rows, r.gid, r.eb,
                             sh.rows, sh.parent, sh.ebits, sh.tail)
        p = len(self._properties)
        for sh, ex, g, k, f in zip(shards, exp, got, new, fresh):
            sh.hot += k  # cold hits stay in the hot table as its cache
            sh.tail += f
            sh.unique_l = sh.tail
            sh.cand += g[_R_REPS]
            sh.level_start += ex.count
            for q, gid in enumerate(g[_R_DISC : _R_DISC + p]):
                if sh.disc[q] == NO_GID and gid != NO_GID:
                    sh.disc[q] = gid
        self._unique_g += sum(fresh)
        self._sc += sum(g[_R_VALID] for g in got)
        if self._wl_remaining() == 0:
            self._depth += 1
            for sh in shards:
                sh.level_end = sh.tail
        self._fold_discoveries()
        self._update_shard_metrics(None, None, None)
        if cold is not None:
            if self._journal:
                self._journal.append("cold_probe", depth=self._depth,
                                     unique=self._unique_g, **cold)
            self._metrics.inc("cold_probe_queries_total", cold["queried"])
            self._metrics.inc("cold_hits_total", cold["hits"])
        self._cold_last = cold
        return 0

    def _cold_filter(self, recvs, ins, got, new, fresh) -> Optional[dict]:
        """Each owner's new keys against ITS cold runs only: K20 passes on
        its card over each run's window between the new keys' minimum and
        maximum (from the readback), clearing the new bit of every key
        found cold.  Updates ``fresh`` (one more small readback where a
        pass ran) and returns the JAX ``cold_probe`` fields, or None where
        no owner with new keys has cold runs."""
        queried = touched = passes = 0
        probed = []
        for d, sh in enumerate(self._shards):
            if not new[d] or not sh.cold.run_count:
                continue
            queried += new[d]
            touched += 1
            lo_key, hi_key = got[d][-2] & _M64, got[d][-1] & _M64
            buf = self._chunk_buf(sh.device)
            ran = False
            for run, a, b in cold_windows(sh.cold.runs, lo_key, hi_key):
                for off in range(a, b, COLD_CHUNK):
                    load_chunk(buf, np.asarray(run[off : off + COLD_CHUNK]))
                    cold_probe(recvs[d].hi, recvs[d].lo, ins[d].origin,
                               ins[d].is_new, buf)
                    passes += 1
                    ran = True
            if ran:
                probed.append(d)
        if not touched:
            return None
        if probed:
            counts = gather_to(self._mesh[0],
                               [ins[d].is_new.sum() for d in probed]).tolist()
            for d, c in zip(probed, counts):
                fresh[d] = c
        self._metrics.inc("cold_probe_passes_total", passes)
        return {"queried": queried, "hits": sum(new) - sum(fresh),
                "shards": touched}

    # --- spill and recovery ---------------------------------------------------

    def _wl_after_commit(self) -> None:
        """Every shard past the spill threshold spills, in one pass at the
        committed boundary; the hot planes' measured load is read once."""
        over = [d for d, sh in enumerate(self._shards)
                if sh.hot / self._cap_s >= self._spill_threshold]
        if not over:
            return
        lf = sum(sh.table.load_factor() for sh in self._shards) / self._n
        self._metrics.update(hot_load_factor=round(lf, 6))
        self._spill(over, "threshold", clear_planes=True)

    def _segment_fps(self, sh: _Shard, start: int, end: int) -> np.ndarray:
        """The uint64 identity fingerprints of log positions ``[start,
        end)`` of a shard (K1, after K15 under symmetry), in log order."""
        parts = []
        step = max(self._pad, 1 << 20)
        for a in range(start, end, step):
            rows = sh.rows[a : min(end, a + step)]
            parts.append(fp64_of(*device_fp64(self._identity(rows))))
        if not parts:
            return np.zeros((0,), np.uint64)
        return torch.cat(parts).to("cpu").numpy().view(np.uint64)

    def _spill(self, shards: List[int], reason: str, clear_planes: bool) -> None:
        """Evict the chosen shards' hot tiers (``sharded_engine.py:
        577-661``): the fingerprints of each one's log segment
        ``[spill_tail, tail)`` -- from the log, so an aborted insert's keys
        never reach the cold tier -- become one sorted run in its own
        store, and its watermark advances; with ``clear_planes`` (the
        committed boundary) its planes are zeroed.  The overflow recovery
        passes False: its planes are rebuilt anyway."""
        t0 = time.monotonic()
        fps = {d: self._segment_fps(self._shards[d], self._shards[d].spill_tail,
                                    self._shards[d].tail) for d in shards}
        spill_sec = round(time.monotonic() - t0, 4)
        for d in shards:
            sh = self._shards[d]
            sh.cold.add_run(fps[d])
            sh.spill_count += 1
            if self._journal:
                self._journal.append(
                    "spill", shard=int(d), reason=reason,
                    entries=int(fps[d].shape[0]), bytes=int(fps[d].nbytes),
                    start=sh.spill_tail, end=sh.tail,
                    load_factor=round(sh.hot / self._cap_s, 6),
                    cold_runs=sh.cold.run_count,
                    cold_entries=sh.cold.entries, spill_sec=spill_sec,
                )
            self._metrics.inc("spills", 1)
            self._metrics.inc("spill_bytes_total", int(fps[d].nbytes))
            sh.spill_tail = sh.tail
            sh.hot = 0
            if clear_planes:
                sh.table.keys.zero_()
        self._metrics.update(
            cold_runs=sum(c.run_count for c in self._colds),
            cold_entries=sum(c.entries for c in self._colds),
            cold_bytes=sum(c.nbytes for c in self._colds),
        )

    def _rebuild_planes(self) -> None:
        """Fresh hot planes from the committed logs: every shard's
        ``[spill_tail, tail)`` re-inserted (K1, after K15 under symmetry,
        then K4) in the JAX engine's lockstep windows of ``pad`` rows."""
        seg = self._pad
        oks = []
        for sh in self._shards:
            sh.table = HashSet.empty(self._cap_s, sh.device)
        span = max(sh.tail - sh.spill_tail for sh in self._shards)
        for off in range(0, span, seg):
            for sh in self._shards:
                cnt = min(max(sh.tail - sh.spill_tail - off, 0), seg)
                if not cnt:
                    continue
                a = sh.spill_tail + off
                hi, lo = device_fp64(self._identity(sh.rows[a : a + cnt]))
                ones = torch.ones((cnt,), dtype=torch.bool, device=sh.device)
                oks.append(insert_batch_claim(sh.table, hi, lo, ones)[1])
        if oks and not all(gather_to(self._mesh[0], oks).tolist()):
            raise RuntimeError(
                "hot-table rebuild failed a probe bound below the 50% spill "
                "gate -- impossible by construction; please report"
            )
        for sh in self._shards:
            sh.hot = sh.tail - sh.spill_tail
        self._planes_dirty = False

    def _wl_grow(self, flags: int) -> None:
        """Recovery of an aborted wave (``sharded_engine.py:694-751``):
        flags 4, 32 and 128 through the sharded ladders; flag 1 spills the
        overfull shards (the budget pins their capacity), or halves the
        chunk where such a shard's table is already empty; flag 2 doubles
        the row logs (positional ids: nothing is re-keyed).  Dirty planes
        are rebuilt from the committed logs last."""
        base = flags & (4 | 32 | 128)
        if base and self._grow_knobs(base) is None:
            raise RuntimeError(self._wl_overflow_message(flags))
        notes = []
        if flags & 1:
            over = self._flag1_shards
            spill = [d for d, o in enumerate(over) if o and self._shards[d].hot]
            stuck = any(o and not self._shards[d].hot for d, o in enumerate(over))
            if spill:
                self._spill(spill, "overflow", clear_planes=False)
                notes.append(f"spill shards={spill} (budget pins per-shard "
                             f"capacity={self._cap_s})")
            if stuck:
                if self._chunk <= 8:
                    raise RuntimeError(self._wl_overflow_message(flags))
                self._chunk = max(8, self._chunk // 2)
                notes.append(f"chunk_size={self._chunk}")
        if flags & 2:
            new_cap = self._log_cap * 2
            if (new_cap + self._pad) * self._n >= 0xFFFFFFFF:
                raise RuntimeError(self._wl_overflow_message(flags))
            self._grow_log(new_cap)
            notes.append(f"log_capacity={new_cap}")
        if notes:
            log_grow(self, flags & 3, "; ".join(notes), self._unique_g,
                     self._depth)
        if self._planes_dirty:
            self._rebuild_planes()

    def _grow_log(self, new_cap: int) -> None:
        """Each shard's row log at ``new_cap`` positions (plus the pad),
        its parents past the old end at the no-parent id."""
        new_lp = new_cap + self._pad
        for sh in self._shards:
            old = sh.rows.shape[0]
            rows = torch.zeros((new_lp, sh.rows.shape[1]), dtype=torch.int32,
                               device=sh.device)
            parent = torch.full((new_lp,), -1, dtype=torch.int32,
                                device=sh.device)
            ebits = torch.zeros((new_lp,), dtype=torch.int32, device=sh.device)
            rows[:old], parent[:old], ebits[:old] = sh.rows, sh.parent, sh.ebits
            sh.rows, sh.parent, sh.ebits = rows, parent, ebits
        self._log_cap = new_cap

    def _wl_retryable_flags(self) -> int:
        # The budget spills instead of growing the table (1), and log
        # growth never re-keys (2): both recover here, unlike the
        # sharded checker.
        return 1 | 2 | 4 | 32 | 128

    def _wl_overflow_message(self, flags: int) -> str:
        if flags & 8:
            return super()._wl_overflow_message(flags)
        if flags & 1:
            return (
                "a single wave inserted more distinct new keys than a "
                f"shard's budgeted hot table holds (per-shard capacity "
                f"{self._cap_s}) even at the floor chunk; raise "
                "memory_budget_mb"
            )
        return f"tiered-sharded engine overflow flags={flags}"

    # --- loop surface -----------------------------------------------------------

    def _wl_call_waves(self) -> int:
        """Every wave is a device call of its own (the JAX engine runs at
        ``waves_per_call=1``), so the density tuners run after each
        committed wave."""
        return 1

    def _wl_occupancy(self) -> float:
        """The fullest shard's budgeted table: the binding constraint."""
        return max(sh.hot for sh in self._shards) / self._cap_s

    def _wl_wave_extra(self) -> dict:
        out = {
            "tail": sum(sh.tail for sh in self._shards),
            "hot_entries": max(sh.hot for sh in self._shards),
            "cold_runs": sum(c.run_count for c in self._colds),
        }
        if self._cold_last is not None:
            out["cold_queried"] = self._cold_last["queried"]
            out["cold_hits"] = self._cold_last["hits"]
        return out

    def _update_shard_metrics(self, frontier, unique_l, cand) -> None:
        """The sharded gauges over the log shards (frontier, tails,
        representatives sent), plus each shard's hot and cold entries and
        spills and the cold skew (``sharded_engine.py:536-553``)."""
        shards = self._shards
        super()._update_shard_metrics(
            [sh.level_end - sh.level_start for sh in shards],
            [sh.tail for sh in shards], [sh.cand for sh in shards],
        )
        cold = [c.entries for c in self._colds]
        self._metrics.update(
            shard_hot_entries={str(d): int(sh.hot) for d, sh in enumerate(shards)},
            shard_cold_entries={str(d): int(cold[d]) for d in range(self._n)},
            shard_spills={str(d): int(sh.spill_count)
                          for d, sh in enumerate(shards)},
            cold_skew_max_over_mean=self._skew(cold),
        )

    def _wl_geometry(self) -> dict:
        g = super()._wl_geometry()
        g.update(
            engine=self.engine_name,
            memory_budget_mb=self._memory_budget_mb,
            spill_threshold=self._spill_threshold,
            log_capacity=self._log_cap,
            waves_per_call=1,
        )
        return g

    def metrics(self) -> dict:
        out = super().metrics()
        out.update(
            engine=self.engine_name,
            memory_budget_mb=self._memory_budget_mb,
            spill_threshold=self._spill_threshold,
            cold_runs=sum(c.run_count for c in self._colds),
            cold_entries=sum(c.entries for c in self._colds),
            cold_bytes=sum(c.nbytes for c in self._colds),
        )
        return out

    # --- snapshots ----------------------------------------------------------------

    def _snapshot_key(self) -> str:
        return super()._snapshot_key() + TS_SUFFIX

    def _snapshot_arrays(self) -> Dict[str, np.ndarray]:
        """The JAX engine's tiered-sharded arrays: every shard's row log,
        parents and ebits end to end, the discovery ids, and the ``ts_*``
        tier state (watermarks, counters, each shard's cold runs)."""
        shards = self._shards
        fps, lens = [], []
        runs_per = np.zeros(self._n, np.int64)
        for d, c in enumerate(self._colds):
            f, ln = c.to_arrays()
            fps.append(f)
            lens.append(ln)
            runs_per[d] = ln.shape[0]

        def per(attr):
            return np.array([getattr(sh, attr) for sh in shards], np.int64)

        return {
            "rows": np.concatenate([to_numpy_u32(sh.rows) for sh in shards]),
            "parent": np.concatenate([to_numpy_u32(sh.parent) for sh in shards]),
            "ebits": np.concatenate([to_numpy_u32(sh.ebits) for sh in shards]),
            "disc": np.array([sh.disc for sh in shards], np.uint32).reshape(
                self._n, len(self._properties)),
            "ts_level_start": per("level_start"),
            "ts_level_end": per("level_end"),
            "ts_tails": per("tail"),
            "ts_spill_tails": per("spill_tail"),
            "ts_cand": per("cand"),
            "ts_depth": np.int64(self._depth),
            "ts_unique": np.int64(self._unique_g),
            "ts_states": np.uint64(self._sc),
            "ts_log_cap": np.int64(self._log_cap),
            "ts_cold_fps": (np.concatenate(fps) if fps
                            else np.zeros((0,), np.uint64)),
            "ts_cold_lens": (np.concatenate(lens) if lens
                             else np.zeros((0,), np.int64)),
            "ts_cold_runs_per_shard": runs_per,
        }

    def _wl_write_checkpoint(self) -> dict:
        self._write_snapshot(self._checkpoint_path)
        return {
            "tail": sum(sh.tail for sh in self._shards),
            "cold_runs": sum(c.run_count for c in self._colds),
            "cold_entries": sum(c.entries for c in self._colds),
        }

    # --- results --------------------------------------------------------------------

    def discovered_fingerprints(self) -> np.ndarray:
        """Sorted uint64 fingerprints of every discovered state (of its
        canonical row under symmetry): each shard's log prefix."""
        self.join()
        if not self._shards:
            raise RuntimeError("no run state to fingerprint")
        fps = [fingerprints_of_rows(self._identity(sh.rows[: sh.tail]))
               for sh in self._shards if sh.tail]
        return np.sort(np.concatenate(fps))

    def _gid_path(self, gid: int):
        """Walk the parent chain across shards from the positional global
        id ``gid`` (shard ``gid % n``, position ``gid // n``)."""
        from ..core.path import Path

        with self._lock:
            if self._tables_host is None:
                if not self._shards:
                    raise RuntimeError(
                        "no run state to reconstruct paths from (the checker "
                        "did not complete cleanly)"
                    )
                self._tables_host = (
                    [to_numpy_u32(sh.parent) for sh in self._shards],
                    [to_numpy_u32(sh.rows) for sh in self._shards],
                )
            parent, rows = self._tables_host
        n = self._n
        chain: List[int] = []
        g = gid
        while g != NO_GID:
            if len(chain) > self._unique_count:
                raise RuntimeError("parent chain does not end at an init state")
            chain.append(g)
            g = int(parent[g % n][g // n])
        chain.reverse()
        fps = [
            self._model.fingerprint(self._compiled.decode(rows[g % n][g // n]))
            for g in chain
        ]
        return Path.from_fingerprints(self._model, fps)
