"""The sharded wavefront checker: frontier and visited set split over shards.

The counterpart of ``stateright_tpu/parallel/sharded.py``
(``ShardedTpuChecker``, untraced): every fingerprint has one owner shard
(:func:`~.exchange.owner_mix` of the key modulo the mesh size), so an
owner's local insert IS the global dedup.  Each wave, every shard expands
a chunk of its own queue, pre-dedups its successors (K12; skipped on a
sortless 1-shard mesh), buckets the representatives by owner (K26), and
sends each owner its bucket; each owner fingerprints what it received
(K1), inserts it into its table (K4) and commits the new states at their
slots and its queue tail (K27).  Table entries hold *global ids* (shard <<
slot_bits | slot), so parent links cross shards.

One process and one host loop drive every shard, as one JAX program drives
its ``shard_map``: a shard's tensors live on its device (``mesh``, a list
of ``torch.device``s; repeats put several shards on one card, ``["cpu"] *
8`` is what the CPU tests pass), each kernel launches on its shard's card,
and the JAX collectives become:

- ``all_to_all``: owner ``d`` receives ``send[s][d]`` from every sender
  ``s``, shard 0's bucket first -- n * n slice copies (peer copies between
  cards, device copies on one);
- ``psum``: one readback of every shard's wave stats (a small stack on the
  first shard's device) and the mesh-wide decisions on the host.  The one
  decision needed inside a wave -- whether any shard's compaction buffer
  or bucket overflowed (flags 4, 32), which aborts EVERY shard's wave
  before any insert -- moves as one word a shard, copied to each owner,
  which gates the received validity with it; the step rung's flag 128 is
  known on the host before the wave.

Semantics are the JAX engine's, held bit for bit on the CPU
(``tests/test_torch_sharded.py``: key planes, stores, parents, ebits,
queues and stats at 1/2/4/8 shards): the exchange ranks a bucket's lanes
in lane order (JAX's stable ``argsort``), the owner's claim insert elects
the lowest receive lane, shards keep their own discovery vectors (a
shard's "awaiting discoveries" gate reads its own), and the host folds
them -- shard 0 first -- at the JAX loop's call boundaries, every
``waves_per_call`` waves or where its device loop would stop.  Only flags
4, 32 and 128 grow in place; a full table (1) or queue (2) is an error,
since a regrowth would change the global ids.

The wave is six per-shard phases, the cuts of the JAX engine's traced
programs (``_build_traced``, ``sharded.py:1165``): ``step`` (the model's
step and K8, and on two-phase waves K3 and the successor rows), ``canon``
(K15 and K1; single-phase waves then compact the valid keys, K3),
``prededup`` (K12), ``exchange`` (K26, the slice copies and the owners'
K1), ``insert`` (K4) and ``append`` (K27).  The untraced wave runs them
back to back with one readback; ``trace=True`` (:meth:`_run_traced`, the
JAX ``_check_traced``) syncs every card at each phase end, reads the
flag-4/32 gate on the host between the exchange and the insert, folds
discoveries every wave, and runs the density tuners of the sort and step
rungs after each committed wave, as the JAX traced loop does.  The
tiered-sharded engine (``tiered/sharded_engine.py``) reuses the same phase
functions.  The untraced loop runs the density tuners of the sort and
step rungs at the JAX call boundaries (:meth:`_wl_call_waves`,
:meth:`_wl_retune`).  Not ported here: the knob cache.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.checker import Checker
from ..core.model import Expectation
from ..core.path import Path
from ..obs.metrics import MetricsRegistry
from ..obs.roofline import slot_bytes, sort_bytes
from ..obs.trace import PhaseClock, WaveTracer
from ..ops.cuda import resolve_device
from ..ops.device_fp import device_fp64
from ..ops.fingerprint import fp64_words
from ..ops.u32 import M32, from_numpy_u32, i32, to_numpy_u32, u32
from ..runtime.journal import as_journal
from .canon import make_canon
from .compiled import CompiledModel, compiled_model_for, two_phase_capable
from .exchange import gather_to, owner_bucket, owner_mix_host, shard_commit
from .hashset import (
    HashSet, compact_valid, compact_valid_indices, insert_batch_claim,
    prededup, prededup_prefix, unique_buffer_size,
)
from .wave_common import (
    NO_ID, default_waves_per_call, make_finish_when_device, prop_kinds,
    wave_eval,
)
from .wave_loop import (
    BUCKET_SLACK_DEFAULT, SORT_RUNG_MIN, STEP_RUNG_MIN, LoopVitals, WaveLoop,
    clamp_sort_lanes, clamp_step_lanes, climb_sort_rung, climb_step_rung,
    exchange_bucket_lanes, finalize_run, fingerprints_of_rows,
    journal_geometry, log_grow, loop_should_break, maybe_retune_sort,
    maybe_retune_step, next_bucket_slack, relax_dedup_geometry,
    reset_sort_rung_to_full,
)
from .wavefront import max_safe_unique_lanes, wave_bytes

NO_GID = 0xFFFFFFFF

# A shard's row of the snapshot's stats table, the JAX engine's layout.
(
    S_LEVEL_START, S_LEVEL_END, S_TAIL, S_SC_LO, S_SC_HI, S_UNIQUE_G,
    S_UNIQUE_L, S_CAND_LO, S_CAND_HI, S_DEPTH, S_FLAGS, S_WAVES_LEFT,
) = range(12)
S_DISC = 12

# The per-shard wave stats read back together: new states, valid lanes,
# probe_ok, the step flag, bucket overflow, representatives sent, then a
# discovery candidate (global id) per property.
_R_NEW, _R_VALID, _R_OK, _R_STEP, _R_BOVF, _R_REPS, _R_DISC = range(7)


def resolve_mesh(mesh, what: str) -> List[torch.device]:
    """A spawn's ``mesh`` as concrete devices: one shard on each visible
    card by default (raising where there is none), else each entry
    resolved as ``spawn_gpu``'s ``device`` is; all of one kind."""
    if mesh is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what}: no CUDA device is available; pass mesh=['cpu'] * n "
                "to run the plain-torch twins on the CPU"
            )
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d, what) for d in mesh]
    if not devices:
        raise ValueError(f"{what}: the mesh holds no device")
    if len({d.type for d in devices}) > 1:
        raise ValueError(f"{what}: a mesh is all CPU or all CUDA devices")
    return devices


class _Shard:
    """One shard's device tables and the host scalars of its stats row."""

    def __init__(self, index: int, device: torch.device):
        self.index = index
        self.device = device
        self.table: Optional[HashSet] = None
        self.store = self.parent = self.ebits = self.queue = None
        self.level_start = self.level_end = self.tail = 0
        self.unique_l = 0
        self.cand = 0  # representatives sent to the exchange (64-bit)
        self.disc: List[int] = []  # per property: global id, or NO_GID


class _Expanded:
    """One shard's expansion in a wave, phase by phase: the chunk's
    candidates (``step``), their keys in the compaction buffer of ``size``
    lanes (``canon``), the representatives K26 (or the 1-shard commit)
    reads (``prededup``), and the wave stats the readback carries."""

    def __init__(self, count: int, size: int):
        self.count = count
        self.size = size
        self.valid = None  # single-phase: each candidate's validity
        self.v_hi = self.v_lo = self.v_orig = self.v_act = None
        self.u_hi = self.u_lo = self.u_valid = None
        self.rows = self.ridx = self.olane = None
        self.gids = self.eb = None
        self.n_valid = self.step_flag = self.cand_gid = None


class _Received:
    """An owner's receive buffer after the exchange: each lane's row,
    parent global id and eventually-bits, its K1 key and its validity."""

    def __init__(self, rows, gid, eb, hi, lo, rv):
        self.rows, self.gid, self.eb = rows, gid, eb
        self.hi, self.lo, self.rv = hi, lo, rv


class _Inserted:
    """An owner's insert: the new lanes, their slots, the sorted path's
    representative -> receive lane map (or None), probe_ok, and K4's probe
    figures on a traced wave."""

    def __init__(self, is_new, ok, slot, origin, probe):
        self.is_new, self.ok, self.slot = is_new, ok, slot
        self.origin, self.probe = origin, probe


class ShardedGpuChecker(Checker):
    """Wavefront checker over a mesh of shards (one host loop)."""

    engine_name = "gpu-sharded"
    spawn_name = "spawn_gpu_sharded()"

    def __init__(
        self,
        options,
        mesh=None,
        capacity: int = 1 << 20,
        chunk_size: int = 1 << 11,
        dedup_factor: int = 4,
        compiled: Optional[CompiledModel] = None,
        resume_from: Optional[str] = None,
        journal=None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every_waves: Optional[int] = None,
        checkpoint_every_sec: Optional[float] = None,
        trace: bool = False,
        bucket_slack: Optional[int] = None,
        sort_lanes: Optional[int] = None,
        sortless: Optional[bool] = None,
        step_lanes: Optional[int] = None,
        waves_per_call: Optional[int] = None,
    ):
        """The JAX ``spawn_tpu_sharded`` arguments (``sharded.py:138-217``
        documents each), with ``mesh`` a list of devices, one a shard
        (repeats allowed: ``["cuda:0"] * 4`` is four shards on one card).
        ``capacity`` is split into per-shard power-of-two tables;
        ``chunk_size`` is the states a shard expands a wave (clamped, as in
        JAX, while ``n`` compaction buffers exceed the lane band);
        ``bucket_slack`` the exchange bucket in percent of the even share
        (default 50, doubling on flag 32); ``sort_lanes``/``sortless``/
        ``step_lanes`` the dedup path and the two rungs; ``waves_per_call``
        the JAX loop's waves between host reads, at whose boundaries the
        shards' discoveries fold.  ``resume_from`` continues a snapshot of
        a mesh of the same size, from this engine or the JAX one.
        ``trace=True`` times every phase of every wave behind a sync of
        each card (:meth:`_run_traced`): journal ``wave`` events with the
        breakdown, modeled bytes, ``hbm_util_frac`` and the exchange's
        measured payload and occupancy, then :meth:`trace_summary`; it
        refuses ``resume_from``, as the JAX engine does."""
        super().__init__(options.model)
        if options._visitor is not None:
            raise ValueError("spawn_gpu_sharded() does not support visitors")
        self._trace = bool(trace)
        if self._trace and resume_from is not None:
            raise ValueError(
                "spawn_gpu_sharded(trace=True) does not support "
                "resume_from: tracing is a diagnostic mode; resume "
                "untraced and trace a fresh (bounded) run instead"
            )
        self._mesh = resolve_mesh(mesh, self.spawn_name)
        self._n = len(self._mesh)
        self._options = options
        self._compiled = compiled or compiled_model_for(options.model)
        self._canon = (
            make_canon(self._compiled)
            if options._symmetry is not None
            else None
        )
        if options._symmetry is not None and self._canon is None:
            raise ValueError(
                "spawn_gpu_sharded() with symmetry() requires the compiled "
                "model to declare a canonicalization, but "
                f"{type(self._compiled).__name__} defines neither "
                "canon_spec() nor canon_rows (parallel/canon.py)"
            )
        self._cap_s = 1 << max(capacity // self._n, 1 << 10).bit_length() - 1
        self._slot_bits = self._cap_s.bit_length() - 1
        if self._slot_bits + max(self._n - 1, 1).bit_length() >= 32:
            raise ValueError("capacity too large for 32-bit global ids")
        a = self._compiled.max_actions
        u_cap = max_safe_unique_lanes(self._compiled.state_width + 3)
        requested = chunk_size
        while (
            chunk_size > 2048
            and self._n * unique_buffer_size(chunk_size * a, dedup_factor) > u_cap
        ):
            chunk_size //= 2
        if self._n * unique_buffer_size(chunk_size * a, dedup_factor) > u_cap:
            raise ValueError(
                f"chunk geometry (chunk_size={chunk_size}, max_actions={a}, "
                f"dedup_factor={dedup_factor}) exceeds the compaction-buffer "
                "band even at the floor chunk; raise dedup_factor or use a "
                "narrower model"
            )
        if chunk_size != requested:
            logging.getLogger(__name__).warning(
                "spawn_gpu_sharded: chunk_size clamped to %d (max_actions=%d, "
                "dedup_factor=%d): the requested geometry exceeds the "
                "compaction-buffer band", chunk_size, a, dedup_factor,
            )
        self._chunk = chunk_size
        self._dedup_factor = dedup_factor
        self._bucket_slack = (
            BUCKET_SLACK_DEFAULT if bucket_slack is None else int(bucket_slack)
        )
        if self._bucket_slack < 1:
            raise ValueError("bucket_slack must be a positive percentage")
        self._bucket_retries = 0
        self._sort_lanes = (
            None if sort_lanes is None else clamp_sort_lanes(sort_lanes)
        )
        self._sort_tune = sort_lanes is None
        self._sort_retries = 0
        # The density tuners' evidence (the traced and tiered-sharded
        # loops run them, as the JAX engine's loops do).
        self._sort_rung_floor = SORT_RUNG_MIN
        self._sort_peak_valid = 0.0
        self._sort_quanta = 0
        self._step_rung_floor = STEP_RUNG_MIN
        self._step_peak_frontier = 0.0
        self._step_quanta = 0
        self._sortless = (
            (sort_lanes is None) if sortless is None else bool(sortless)
        )
        self._step_lanes = (
            None if step_lanes is None else clamp_step_lanes(step_lanes)
        )
        self._step_tune = step_lanes is None
        self._step_retries = 0
        if waves_per_call is None:
            waves_per_call = default_waves_per_call(options)
        elif int(waves_per_call) < 1:
            raise ValueError("waves_per_call must be >= 1")
        self._waves_per_call = int(waves_per_call)
        self._properties = self._model.properties()
        if len(self._properties) > 32:
            raise ValueError("at most 32 properties supported on device")
        self._ev_indices = [
            i for i, p in enumerate(self._properties)
            if p.expectation is Expectation.EVENTUALLY
        ]
        self._kinds = prop_kinds(self._properties)
        self._two_phase = two_phase_capable(self._compiled)
        self._fp_words = self._compiled.fp_words or self._compiled.state_width
        self._fw_matched = make_finish_when_device(
            options._finish_when, self._properties
        )
        # Discoveries as the host folds them (shard 0 first, at call ends);
        # the wave loop's finish_when test reads them under this name.
        self._discovery_gids: Dict[str, int] = {}
        self._discovery_slots = self._discovery_gids
        self._state_count = 0
        self._unique_count = 0
        self._max_depth = 0
        # The mesh-wide scalars of the stats rows.
        self._sc = 0
        self._unique_g = 0
        self._depth = 0
        self._waves_in_call = 0
        self._waves_left = 0
        self._waves = 0
        self._shards: List[_Shard] = []
        self._tables_host: Optional[tuple] = None
        self._discoveries_cache: Optional[Dict[str, Path]] = None
        self._accounting: dict = {}
        self._resume_from = resume_from
        self._metrics = MetricsRegistry()
        self._tracer = None
        self._host_spans: List[tuple] = []
        self._journal = as_journal(journal)
        self._checkpoint_path = checkpoint_path
        self._ckpt_every_waves = checkpoint_every_waves
        self._ckpt_every_sec = checkpoint_every_sec
        if (
            checkpoint_path is not None
            and checkpoint_every_waves is None
            and checkpoint_every_sec is None
        ):
            self._ckpt_every_sec = 30.0
        self._done = threading.Event()
        self._errors: List[BaseException] = []
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # --- geometry ----------------------------------------------------------

    def _step_width(self) -> int:
        """The live chunk: the step rung capped at ``chunk_size``."""
        if self._step_lanes is None:
            return self._chunk
        return min(self._step_lanes, self._chunk)

    def _u_sz(self) -> int:
        """The worst-case compaction buffer of a chunk at the live knobs."""
        return unique_buffer_size(
            self._step_width() * self._compiled.max_actions, self._dedup_factor
        )

    def _sort_width(self) -> int:
        """The live compaction width: the sort rung capped at U, or U."""
        full = self._u_sz()
        if self._sort_lanes is None:
            return full
        return min(self._sort_lanes, full)

    def _bucket_lanes(self) -> int:
        """The exchange's per-destination bucket at the live slack rung."""
        return exchange_bucket_lanes(
            self._sort_width(), self._n, self._bucket_slack
        )

    def _identity(self, rows: torch.Tensor) -> torch.Tensor:
        """What K1 hashes of packed rows: the identity prefix of each row,
        or of its canonical form under symmetry (which owners route by)."""
        if self._canon is not None:
            rows = self._canon(rows.contiguous())
        return rows[:, : self._fp_words]

    # --- run ---------------------------------------------------------------

    def _run(self) -> None:
        try:
            timeout = self._options._timeout
            deadline = None if timeout is None else time.monotonic() + timeout
            if self._resume_from is not None:
                self._resume()
            else:
                self._seed()
            if self._trace:
                self._waves = self._run_traced(deadline)
            else:
                self._waves = WaveLoop(self).run(deadline)
            self._end_call()
            for dev in {d for d in self._mesh if d.type == "cuda"}:
                torch.cuda.synchronize(dev)
            self._accounting = self._build_accounting(self._waves)
            if self._tracer is not None and self._journal:
                self._journal.append("trace_summary", **self._tracer.summary())
            finalize_run(self)
        except BaseException as e:  # propagate at join, like the host engine
            self._errors.append(e)
        finally:
            self._done.set()

    def _new_shard(self, d: int, queue_len: int) -> _Shard:
        sh = _Shard(d, self._mesh[d])
        w, dev = self._compiled.state_width, sh.device
        sh.table = HashSet.empty(self._cap_s, dev)
        sh.store = torch.zeros((self._cap_s, w), dtype=torch.int32, device=dev)
        sh.parent = torch.full((self._cap_s,), -1, dtype=torch.int32, device=dev)
        sh.ebits = torch.zeros((self._cap_s,), dtype=torch.int32, device=dev)
        sh.queue = torch.zeros((queue_len,), dtype=torch.int32, device=dev)
        sh.disc = [NO_GID] * len(self._properties)
        return sh

    def _seed(self) -> None:
        """Route the init states to their owners on the host (by the
        canonical fingerprint under symmetry), then insert each shard's
        (K1, K4) and commit them at queue positions 0.. (K27): the JAX
        ``_seed_initial`` and seed program.  One readback; a failed insert
        is the JAX engine's flag 16."""
        cm = self._compiled
        n = self._n
        init = cm.init_packed()
        n_init = init.shape[0]
        if self._canon is not None:
            fp_rows = to_numpy_u32(self._canon(from_numpy_u32(init, "cpu")))
        else:
            fp_rows = init
        fps = [fp64_words(row[: self._fp_words].tolist()) for row in fp_rows]
        owner = np.array(
            [owner_mix_host(fp >> 32, fp & M32) % n for fp in fps], np.int64
        )
        seed_w = max(int((owner == d).sum()) for d in range(n)) or 1
        eb0 = (1 << len(self._ev_indices)) - 1
        self._shards = []
        stats = []
        for d in range(n):
            sh = self._new_shard(d, self._cap_s + self._chunk)
            self._shards.append(sh)
            rows = from_numpy_u32(init[owner == d], sh.device)
            k = rows.shape[0]
            if k == 0:
                stats.append(torch.tensor([0, 1], device=sh.device))
                continue
            hi, lo = device_fp64(self._identity(rows))
            ones = torch.ones((k,), dtype=torch.bool, device=sh.device)
            is_new, ok, slot = insert_batch_claim(
                sh.table, hi, lo, ones, with_slots=True
            )
            gid = torch.full((k,), -1, dtype=torch.int32, device=sh.device)
            eb = torch.full((k,), (eb0 ^ 0x80000000) - 0x80000000,
                            dtype=torch.int32, device=sh.device)
            n_new = shard_commit(is_new, slot, None, rows, gid, eb, sh.store,
                                 sh.parent, sh.ebits, sh.queue, 0)
            stats.append(torch.stack([n_new, ok.long()]))
        got = gather_to(self._mesh[0], stats).tolist()
        for sh, (n_new, ok) in zip(self._shards, got):
            # The JAX seed inserts through its sorted insert at its default
            # dedup_factor: more distinct keys than that buffer is flag 16.
            if not ok or n_new > unique_buffer_size(seed_w, 4):
                raise RuntimeError(self._wl_overflow_message(16))
            sh.level_end = sh.tail = sh.unique_l = n_new
        self._sc = n_init
        self._unique_g = sum(sh.unique_l for sh in self._shards)
        self._state_count = n_init
        self._unique_count = len(set(fps))

    def _snapshot_key(self) -> str:
        """The JAX engine's sharded snapshot key, character for character:
        model identity and the mesh size, which global ids encode."""
        cm = self._compiled
        init_digest = hashlib.sha256(cm.init_packed().tobytes()).hexdigest()[:16]
        return repr(
            (
                "sharded-v1",
                type(cm).__qualname__,
                cm.state_width,
                cm.max_actions,
                tuple(p.name for p in self._properties),
                init_digest,
                self._n,
            )
            + (("sym",) if self._canon is not None else ())
        )

    def _resume(self) -> None:
        """Continue a sharded snapshot (either engine's npz) on a mesh of
        its size, adopting its per-shard geometry and rungs."""
        with np.load(self._resume_from, allow_pickle=False) as snap:
            arrays = {k: snap[k] for k in snap.files}
        if "n_shards" in arrays and int(arrays["n_shards"]) != self._n:
            m = int(arrays["n_shards"])
            raise ValueError(
                f"sharded snapshot was written on a {m}-shard mesh and cannot "
                f"resume on {self._n} shards directly: global state ids "
                "encode the owner shard, so the only valid direct-resume size "
                f"is {m} shards; to continue this run on a {self._n}-shard "
                "mesh, re-key the snapshot first with the `reshard` verb "
                "(stateright_tpu_torch.tiered.reshard.reshard_snapshot) and "
                "resume the converted snapshot with the tiered-sharded engine"
            )
        want, got = self._snapshot_key(), str(arrays["engine_key"])
        if got != want:
            raise ValueError(
                "snapshot does not match this sharded checker configuration "
                f"(snapshot {got}, expected {want})"
            )
        self._cap_s = int(arrays["cap_s"])
        self._slot_bits = self._cap_s.bit_length() - 1
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
        n, cap, w = self._n, self._cap_s, self._compiled.state_width
        stats = np.asarray(arrays["stats"], np.uint32).reshape(n, -1).astype(np.int64)
        queue = np.asarray(arrays["queue"], np.uint32).reshape(n, -1)
        self._shards = []
        for d in range(n):
            sh = _Shard(d, self._mesh[d])
            part = slice(d * cap, (d + 1) * cap)
            sh.table = HashSet.from_planes(
                arrays["key_hi"][part], arrays["key_lo"][part], sh.device
            )
            sh.store = from_numpy_u32(
                np.asarray(arrays["store"]).reshape(n * cap, w)[part], sh.device
            )
            sh.parent = from_numpy_u32(arrays["parent"][part], sh.device)
            sh.ebits = from_numpy_u32(arrays["ebits"][part], sh.device)
            sh.queue = from_numpy_u32(queue[d], sh.device)
            row = stats[d]
            sh.level_start, sh.level_end, sh.tail = (
                int(row[S_LEVEL_START]), int(row[S_LEVEL_END]), int(row[S_TAIL])
            )
            sh.unique_l = int(row[S_UNIQUE_L])
            sh.cand = (int(row[S_CAND_HI]) << 32) | int(row[S_CAND_LO])
            sh.disc = [int(g) for g in row[S_DISC:]]
            self._shards.append(sh)
        self._sc = (int(stats[0, S_SC_HI]) << 32) | int(stats[0, S_SC_LO])
        self._unique_g = int(stats[0, S_UNIQUE_G])
        self._depth = int(stats[0, S_DEPTH])
        with self._lock:
            self._state_count = self._sc
            self._unique_count = self._unique_g
            self._max_depth = self._depth
        self._fold_discoveries()
        if self._journal:
            self._journal.append(
                "resume", path=self._resume_from, unique=self._unique_count,
                states=self._state_count, depth=self._max_depth,
            )

    # --- the wave's phases ---------------------------------------------------

    def _chunk_states(self, sh: _Shard, count: int):
        """The next ``count`` states of a shard's level: their rows, global
        ids and eventually-bits (the slot queue's chunk here; the
        tiered-sharded engine reads its row log)."""
        chunk = sh.queue[sh.level_start : sh.level_start + count]
        idx = chunk.long()
        gids = i32(u32(chunk) | (sh.index << self._slot_bits))
        return sh.store[idx], gids, sh.ebits[idx]

    def _phase_step(self, sh: _Shard, f_eff: int, size: int) -> _Expanded:
        """``step``: the model's step and K8 on the next chunk of the
        shard's level; on two-phase waves also the valid lanes' compaction
        (K3) into the ``size``-lane buffer and their successor rows.  The
        discovery candidates come back as the chunk's global ids."""
        cm = self._compiled
        a, w = cm.max_actions, cm.state_width
        dev = sh.device
        ex = _Expanded(min(sh.level_end - sh.level_start, f_eff), size)
        count = ex.count
        p = len(self._properties)
        if count == 0:
            z32 = torch.zeros((0,), dtype=torch.int32, device=dev)
            ex.u_hi = ex.u_lo = ex.ridx = ex.olane = ex.gids = ex.eb = z32
            ex.v_hi = ex.v_lo = ex.v_orig = z32
            ex.u_valid = ex.v_act = torch.zeros((0,), dtype=torch.bool, device=dev)
            ex.rows = torch.zeros((0, w), dtype=torch.int32, device=dev)
            ex.n_valid = torch.zeros((), dtype=torch.int64, device=dev)
            ex.step_flag = torch.zeros((), dtype=torch.bool, device=dev)
            ex.cand_gid = torch.full((p,), NO_GID, dtype=torch.int64, device=dev)
            return ex
        states, ex.gids, eb_in = self._chunk_states(sh, count)
        discovered = sum(1 << q for q, g in enumerate(sh.disc) if g != NO_GID)
        if self._two_phase:
            valid, ex.eb, cands = wave_eval(
                cm.property_conds(states), cm.step_valid(states), eb_in, 0,
                self._kinds, discovered,
            )
            ex.v_orig, ex.v_act, ex.n_valid = compact_valid_indices(
                valid.view(-1), sort_lanes=size
            )
            ex.rows, lane_flags = cm.step_lane(states, ex.v_orig, ex.n_valid)
            ex.step_flag = lane_flags.any()
        else:
            nexts, valid, conds, ex.step_flag = cm.expand(states)
            valid, ex.eb, cands = wave_eval(
                conds, valid, eb_in, 0, self._kinds, discovered
            )
            ex.rows = nexts.view(count * a, w)
            ex.valid = valid.view(-1)
        if ex.step_flag is None:
            ex.step_flag = torch.zeros((), dtype=torch.bool, device=dev)
        lane = cands.clamp(0, count - 1)
        ex.cand_gid = torch.where(cands != NO_ID, u32(ex.gids)[lane], NO_GID)
        return ex

    def _phase_canon(self, ex: _Expanded) -> None:
        """``canon``: K1 (after K15 under symmetry) on the candidate rows;
        single-phase waves then compact the valid lanes' keys (K3)."""
        if ex.count == 0:
            return
        hi, lo = device_fp64(self._identity(ex.rows))
        if self._two_phase:
            ex.v_hi, ex.v_lo = hi, lo
            ex.ridx = torch.arange(ex.v_orig.shape[0], dtype=torch.int32,
                                   device=hi.device)
        else:
            ex.v_hi, ex.v_lo, ex.v_orig, ex.v_act, ex.n_valid = compact_valid(
                hi, lo, ex.valid, sort_lanes=ex.size
            )
            ex.ridx = ex.v_orig

    def _phase_prededup(self, ex: _Expanded) -> None:
        """``prededup``: K12's representatives, one lane a distinct key --
        which a sortless 1-shard mesh skips, its insert being the global
        dedup."""
        if ex.count == 0:
            return
        if self._sortless and self._n == 1:
            ex.u_hi, ex.u_lo, ex.u_valid = ex.v_hi, ex.v_lo, ex.v_act
            ex.olane = ex.v_orig
        else:
            # The buffer's active lanes are compact_valid's prefix.
            ex.u_hi, ex.u_lo, origin, ex.u_valid, _ = prededup_prefix(
                ex.v_hi, ex.v_lo, ex.n_valid, dedup_factor=1
            )
            origin = origin.long()
            ex.ridx, ex.olane = ex.ridx[origin], ex.v_orig[origin]

    def _expand(self, sh: _Shard, f_eff: int, size: int) -> _Expanded:
        """A shard's half of the wave before the exchange: ``step``,
        ``canon`` and ``prededup`` back to back."""
        ex = self._phase_step(sh, f_eff, size)
        self._phase_canon(ex)
        self._phase_prededup(ex)
        return ex

    def _phase_exchange(self, exp: List[_Expanded], bkt: int):
        """``exchange``: every sender's representatives bucketed by owner
        (K26), each owner's ``n * bkt``-lane receive buffer filled by slice
        copies (sender 0's bucket first), and K1 (after K15 under symmetry)
        on what it received.  A 1-shard mesh elides it: its
        representatives are its receive buffer.  Returns the owners'
        receive buffers and the senders' bucket-overflow words (int32)."""
        n = self._n
        a, w = self._compiled.max_actions, self._compiled.state_width
        if n == 1:
            ex = exp[0]
            parent = ex.olane.long() // a
            dev = ex.u_hi.device
            return [_Received(ex.rows[ex.ridx.long()], ex.gids[parent],
                              ex.eb[parent], ex.u_hi, ex.u_lo, ex.u_valid)], [
                torch.zeros((), dtype=torch.int32, device=dev)]
        sends, bovfs = [], []
        for ex in exp:
            send, _counts, bovf = owner_bucket(
                ex.u_hi, ex.u_lo, ex.u_valid, ex.rows, ex.ridx, ex.olane,
                a, ex.gids, ex.eb, n, bkt,
            )
            sends.append(send)
            bovfs.append(bovf)
        recvs = []
        for sh in self._shards:
            buf = torch.empty((n * bkt, w + 3), dtype=torch.int32,
                              device=sh.device)
            for s, send in enumerate(sends):
                buf[s * bkt : (s + 1) * bkt].copy_(send[sh.index])
            hi, lo = device_fp64(self._identity(buf[:, :w]))
            recvs.append(_Received(buf[:, :w], buf[:, w], buf[:, w + 1],
                                   hi, lo, buf[:, w + 2] != 0))
        return recvs, bovfs

    def _phase_insert(self, sh: _Shard, r: _Received, rv) -> _Inserted:
        """``insert``: the owner's claim insert of its received keys under
        the validity ``rv`` (K4, the lowest receive lane elected; on the
        sorted path K12's representatives first), with K4's probe figures
        on a traced wave."""
        origin = None
        rounds = self._tracer is not None
        if self._sortless:
            is_new, ok, *rest = insert_batch_claim(
                sh.table, r.hi, r.lo, rv, with_slots=True, with_rounds=rounds
            )
        else:
            p_hi, p_lo, origin, p_act, _ = prededup(r.hi, r.lo, rv,
                                                    dedup_factor=1)
            is_new, ok, *rest = insert_batch_claim(
                sh.table, p_hi, p_lo, p_act, with_slots=True,
                with_rounds=rounds,
            )
        probe = rest[0] if rounds else None
        return _Inserted(is_new, ok, rest[-1], origin, probe)

    def _phase_append(self, sh: _Shard, r: _Received, ins: _Inserted):
        """``append``: the new states at their slots and the shard's queue
        tail (K27); returns their count (a device scalar)."""
        return shard_commit(ins.is_new, ins.slot, ins.origin, r.rows, r.gid,
                            r.eb, sh.store, sh.parent, sh.ebits, sh.queue,
                            sh.tail)

    def _wave_stats(self, exp, bovfs, ins, n_new, extra=None) -> list:
        """Every shard's wave stats (the ``_R_*`` layout, then ``extra``
        words) in one readback."""
        stats = []
        for d, (ex, bovf, i, k) in enumerate(zip(exp, bovfs, ins, n_new)):
            dev = k.device
            stats.append(torch.cat([
                torch.stack([
                    k, ex.n_valid.to(dev), i.ok.long(), ex.step_flag.long(),
                    bovf.to(dev).long(), ex.u_valid.sum().to(dev),
                ]),
                ex.cand_gid.to(dev),
                *([] if extra is None else [extra[d].to(dev)]),
            ]))
        return gather_to(self._mesh[0], stats).tolist()

    def _wl_wave(self) -> int:
        """One wave on every shard: the six phases back to back, the
        mesh-wide commit gate moved to each owner as one word a sender
        (flags 4 and 32 abort EVERY shard's insert), then the one readback
        and the mesh-wide host decisions (``sharded.py:531-855``).  Returns
        the flags; the wave committed iff none of 4, 32 and 128 is set."""
        f_eff = self._step_width()
        size = self._sort_width()
        shards = self._shards
        # Flag 128 (the step rung clamped a shard's level) is known here.
        sovf = f_eff < self._chunk and any(
            sh.level_end - sh.level_start > f_eff for sh in shards
        )
        exp = [self._expand(sh, f_eff, size) for sh in shards]
        recvs, bovfs = self._phase_exchange(exp, self._bucket_lanes())
        aborts = [(ex.n_valid > size).to(torch.int32) | bovf.to(ex.n_valid.device)
                  for ex, bovf in zip(exp, bovfs)]
        ins, n_new = [], []
        for sh, r in zip(shards, recvs):
            commit = gather_to(sh.device, aborts).sum() == 0
            if sovf:
                commit = torch.zeros((), dtype=torch.bool, device=sh.device)
            ins.append(self._phase_insert(sh, r, r.rv & commit))
            n_new.append(self._phase_append(sh, r, ins[-1]))
        t_rb = time.monotonic()
        got = self._wave_stats(exp, bovfs, ins, n_new)
        self._host_spans.append(("readback", t_rb, time.monotonic() - t_rb))
        return self._wave_host(exp, got, size, sovf)

    # --- traced mode -----------------------------------------------------------

    def _card_groups(self) -> Dict[torch.device, List[int]]:
        """The shards of each device of the mesh."""
        groups: Dict[torch.device, List[int]] = {}
        for d, dev in enumerate(self._mesh):
            groups.setdefault(dev, []).append(d)
        return groups

    def _traced_wave_bytes(self, exp, recvs, ins, got, bkt: int) -> Dict[str, int]:
        """Modeled device bytes of one traced wave by phase, on the busiest
        card: each shard's bytes by the port's model, summed over the
        shards a card holds (their launches run one after another on it,
        so the phase's seconds are all of theirs), the largest card sum
        taken.  A sender's ``step`` and ``canon`` are
        :func:`~.wavefront.wave_bytes`'s; ``dedup`` is K12's radix passes
        with the representatives' keys in and origins out (none on a
        sortless 1-shard mesh), plus the owner's insert: the receive
        lanes' validity, the active keys and K4's slots read, the new
        keys, the new mask and each lane's slot written (K12 first on the
        sorted path);
        ``exchange`` is K26 (keys and validity, each representative's
        indices, row, gid and ebits read, the send buffer written), the
        slice copies into the owner's buffer (read and written) and the
        owner's K1 over its receive rows; ``append`` is K27 (the new mask,
        each new state's slot, origin, row, gid and ebits read, its row,
        parent, ebits and queue entry written).  0 on a 1-shard mesh's
        exchange, which is elided."""
        cm = self._compiled
        n, a, w = self._n, cm.max_actions, cm.state_width
        fpw = self._fp_words
        hashed = w if self._canon is not None else fpw
        per = []
        for d, (ex, r, i) in enumerate(zip(exp, recvs, ins)):
            row = got[d]
            u = ex.v_orig.shape[0]
            base = wave_bytes(
                count=ex.count, a=a, w=w, fpw=fpw, n_props=len(self._properties),
                u=u, n_valid=row[_R_VALID], n_inserted=0, n_new=0,
                probe_slots=0, two_phase=self._two_phase,
                sortless=True, symmetric=self._canon is not None,
            ) if ex.count else {"step": 0, "canon": 0}
            reps = row[_R_REPS]
            lanes = r.rv.shape[0]
            active = int(row[len(row) - 3])
            slots = int(row[len(row) - 1])
            new = row[_R_NEW]
            dedup = 0
            if not (self._sortless and n == 1) and u:
                # K12's prefix entry sorts the buffer's valid lanes.
                dedup += sort_bytes(min(row[_R_VALID], u)) + 13 * u
            dedup += lanes + 8 * active + slot_bytes(slots) + 8 * new + 5 * lanes
            if not self._sortless:
                # The owner's mask entry sorts every received lane.
                dedup += sort_bytes(lanes) + 13 * lanes
            exchange = 0
            if n > 1:
                exchange = (
                    u * (4 + 4 + 1) + reps * (4 + 4 + 4 * w + 8)
                    + n * bkt * (w + 3) * 4
                    + 2 * n * bkt * (w + 3) * 4
                    + lanes * (4 * hashed + 8)
                )
            idx_words = 1 if i.origin is None else 2
            append = lanes + new * (4 * idx_words + 2 * (4 * w + 8) + 4)
            per.append({"step": base["step"], "canon": base["canon"],
                        "dedup": dedup, "exchange": exchange,
                        "append": append})
        out = {}
        for k in ("step", "canon", "dedup", "exchange", "append"):
            out[k] = max(sum(per[d][k] for d in ds)
                         for ds in self._card_groups().values())
        return out

    def _run_traced(self, deadline: Optional[float]) -> int:
        """The ``trace=True`` host loop, the JAX ``_check_traced``
        (``sharded.py:1428-1783``): one wave an iteration, each phase
        ended by a sync of every card of the mesh; the step rung climbs on
        the host before dispatch; the flag-4/32 gate is read after the
        exchange and before the insert, so an overflowing wave inserts
        nothing and re-runs at the grown knob; a committed wave journals
        its breakdown, modeled bytes, ``hbm_util_frac`` and the exchange's
        payload bytes and occupancy, folds the shards' discoveries, and
        feeds the density tuners.  Flags 1, 2 and 8 raise.  Returns the
        committed waves."""
        n = self._n
        w = self._compiled.state_width
        shards = self._shards
        cards = [d for d in self._card_groups() if d.type == "cuda"]
        self._tracer = tracer = WaveTracer(self._mesh[0], f"{self.engine_name}-{n}")
        vitals = LoopVitals(self._metrics, initial_unique=self._unique_count,
                            initial_states=self._state_count)
        journal_geometry(self)
        waves = 0
        while self._wl_remaining() > 0:
            target = self._options._target_max_depth
            if target and self._depth >= target - 1:
                break
            f_eff = self._step_width()
            if f_eff < self._chunk and max(
                sh.level_end - sh.level_start for sh in shards
            ) > f_eff:
                # Flag 128 is host data here: climb before dispatching.
                if self._grow_knobs(128) is None:
                    raise RuntimeError(self._wl_overflow_message(128))
                vitals.record_overflow_recovery()
                continue
            size, bkt = self._sort_width(), self._bucket_lanes()
            t_call = time.monotonic()
            clock = PhaseClock(cards)
            exp = [self._phase_step(sh, f_eff, size) for sh in shards]
            clock.mark("step")
            for ex in exp:
                self._phase_canon(ex)
            clock.mark("canon")
            for ex in exp:
                self._phase_prededup(ex)
            clock.mark("dedup")
            recvs, bovfs = self._phase_exchange(exp, bkt)
            clock.mark("exchange")
            gate = gather_to(self._mesh[0], [
                torch.stack([(ex.n_valid > size).long(),
                             bovf.to(ex.n_valid.device).long()])
                for ex, bovf in zip(exp, bovfs)
            ]).tolist()
            retry = (4 if any(g[0] for g in gate) else 0) | (
                32 if any(g[1] for g in gate) else 0)
            if retry:
                # Nothing was inserted: grow the tripped knob and re-run.
                if self._grow_knobs(retry) is None:
                    raise RuntimeError(self._wl_overflow_message(retry))
                vitals.record_overflow_recovery()
                continue
            ins = [self._phase_insert(sh, r, r.rv) for sh, r in zip(shards, recvs)]
            clock.mark("dedup")
            n_new = [self._phase_append(sh, r, i)
                     for sh, r, i in zip(shards, recvs, ins)]
            clock.mark("append")
            extra = [torch.cat([r.rv.sum().view(1), i.probe])
                     for r, i in zip(recvs, ins)]
            got = self._wave_stats(exp, bovfs, ins, n_new, extra)
            clock.mark("readback")
            flags = self._wave_host(exp, [g[:-3] for g in got], size, False)
            self._end_call()
            if flags:
                raise RuntimeError(self._wl_overflow_message(flags))
            waves += 1
            self._wl_publish()
            phases = clock.phases
            call_sec = sum(phases.values())
            reps = sum(g[_R_REPS] for g in got)
            useful = reps * (w + 3) * 4 if n > 1 else 0
            occupancy_x = reps / (n * n * bkt) if n > 1 else 0.0
            rounds = max(int(g[-2]) for g in got)
            enrich = tracer.record_wave(
                phases, self._traced_wave_bytes(exp, recvs, ins, got, bkt),
                probe_rounds=rounds, probe_slots=sum(int(g[-1]) for g in got),
                exchange_payload_bytes=useful,
            )
            enrich["exchange_occupancy"] = round(occupancy_x, 6)
            occupancy = self._wl_occupancy()
            vitals.record_quantum(
                call_sec, 1, self._unique_count, committed=True,
                states=self._state_count, cand_lanes=self._wl_cand_lanes(),
                occupancy=occupancy,
            )
            vitals.record_host(phases["readback"])
            remaining = self._wl_remaining()
            if self._journal:
                self._journal.append(
                    "wave", waves=waves, remaining=remaining,
                    unique=self._unique_count, states=self._state_count,
                    depth=self._depth, flags=0, call_sec=round(call_sec, 6),
                    mono=round(t_call, 6), occupancy=round(occupancy, 6),
                    **(
                        {"density": round(vitals.last_density, 6)}
                        if vitals.last_density is not None else {}
                    ),
                    **enrich,
                )
            self._metrics.update(
                waves=waves, table_occupancy=round(occupancy, 6),
                last_call_sec=round(call_sec, 6),
                exchange_occupancy=round(occupancy_x, 6),
            )
            self._metrics.inc("device_call_sec_total", call_sec)
            self._metrics.inc("device_calls", 1)
            maybe_retune_sort(self, vitals.last_density)
            maybe_retune_step(self, max(
                sh.level_end - sh.level_start for sh in shards) or None)
            if loop_should_break(self, remaining, self._depth, deadline):
                break
        return waves

    def trace_summary(self) -> dict:
        """The finished traced run's roofline reduction: per-phase seconds
        (``step``, ``canon``, ``dedup``, ``exchange``, ``append``,
        ``readback``), modeled bytes, ``hbm_util_frac`` against the card's
        peak, ``bottleneck_phase`` and the measured exchange payload
        total.  Requires ``trace=True``."""
        self.join()
        if self._tracer is None:
            raise RuntimeError(
                f"trace_summary() requires {self.spawn_name[:-2]}(trace=True)"
            )
        return self._tracer.summary()

    # --- the density tuners' hooks (wave_loop.maybe_retune_*) ---------------

    def _wl_retune(self, density, remaining: int) -> None:
        """The untraced loop's density tuners, run where the JAX
        ``FusedWaveLoop`` runs them (``wave_loop.py:743-752``): after each
        committed device call (:meth:`_wl_call_waves`), with the call's
        valid density and the remaining level."""
        maybe_retune_sort(self, density)
        maybe_retune_step(self, remaining or None)

    def _wl_call_waves(self) -> int:
        """The waves of the JAX device call the last wave ended
        (:meth:`_end_call`), or 0 while that call goes on."""
        if self._waves_in_call:
            return 0
        return self._waves_per_call - self._waves_left

    def _wl_full_sort_lanes(self) -> int:
        """The per-shard worst-case width the sort rung is clamped to."""
        return self._u_sz()

    def _wl_apply_sort_rung(self, rung: int) -> None:
        self._sort_lanes = int(rung)
        self._sort_quanta = 0
        journal_geometry(self)

    def _wl_full_step_lanes(self) -> int:
        return self._chunk

    def _wl_apply_step_rung(self, rung: int) -> None:
        self._step_lanes = int(rung)
        self._step_quanta = 0
        journal_geometry(self)

    def _wave_host(self, exp, got, size: int, sovf: bool) -> int:
        """The wave's mesh-wide decisions from its one readback: the flags
        (``sharded.py:814-836``), then, when it committed, every shard's
        scalars, discoveries and the global level boundary."""
        shards = self._shards
        lovf = any(r[_R_VALID] > size for r in got)
        bovf = any(r[_R_BOVF] for r in got)
        commit = not (lovf or bovf or sovf)
        flags = 0
        if any(not r[_R_OK] for r in got) or any(
            (sh.unique_l + r[_R_NEW]) * 2 > self._cap_s
            for sh, r in zip(shards, got)
        ):
            flags |= 1
        if any(sh.tail + r[_R_NEW] > self._cap_s for sh, r in zip(shards, got)):
            flags |= 2
        flags |= (4 if lovf else 0) | (32 if bovf else 0) | (128 if sovf else 0)
        if any(r[_R_STEP] for r in got):
            flags |= 8
        if commit:
            for sh, ex, r in zip(shards, exp, got):
                sh.unique_l += r[_R_NEW]
                sh.tail += r[_R_NEW]
                sh.level_start += ex.count
                sh.cand += r[_R_REPS]
                for q, g in enumerate(r[_R_DISC:]):
                    if sh.disc[q] == NO_GID and g != NO_GID:
                        sh.disc[q] = g
            self._sc += sum(r[_R_VALID] for r in got)
            self._unique_g += sum(r[_R_NEW] for r in got)
            if self._wl_remaining() == 0:
                self._depth += 1
                for sh in shards:
                    sh.level_end = sh.tail
        frontier = [sh.level_end - sh.level_start for sh in shards]
        self._update_shard_metrics(
            frontier, [sh.unique_l for sh in shards], [sh.cand for sh in shards]
        )
        self._waves_in_call += 1
        if flags or self._waves_in_call >= self._waves_per_call or not self._wl_can_wave():
            self._end_call()
        return flags

    def _end_call(self) -> None:
        """The end of one JAX device call: its shards' discoveries fold
        into the checker's (first writer wins, shard 0 first), and its
        wave budget's remainder is the stats rows' ``waves_left``."""
        if not self._waves_in_call:
            return
        self._waves_left = self._waves_per_call - self._waves_in_call
        self._waves_in_call = 0
        self._fold_discoveries()

    def _fold_discoveries(self) -> None:
        with self._lock:
            for sh in self._shards:
                for q, prop in enumerate(self._properties):
                    if sh.disc[q] != NO_GID:
                        self._discovery_gids.setdefault(prop.name, sh.disc[q])

    # --- wave-loop adapter (wave_loop.py) ---------------------------------

    def _wl_remaining(self) -> int:
        return sum(sh.level_end - sh.level_start for sh in self._shards)

    def _wl_depth(self) -> int:
        return self._depth

    def _wl_can_wave(self) -> bool:
        """The JAX loop condition (``sharded.py:531-540``): work left on
        some shard, ``finish_when`` not yet met by the shards' discoveries,
        and the next level within ``target_max_depth``."""
        if self._wl_remaining() == 0:
            return False
        target = self._options._target_max_depth
        if target and self._depth >= target - 1:
            return False
        found = [
            any(sh.disc[q] != NO_GID for sh in self._shards)
            for q in range(len(self._properties))
        ]
        return not self._fw_matched(found)

    def _wl_publish(self) -> None:
        with self._lock:
            self._state_count = self._sc
            self._unique_count = self._unique_g
            self._max_depth = self._depth + (1 if self._wl_remaining() else 0)

    def _wl_occupancy(self) -> float:
        """The fullest shard's table load."""
        return max(sh.unique_l for sh in self._shards) / self._cap_s

    def _wl_wave_extra(self) -> dict:
        return {}

    def _wl_cand_lanes(self) -> int:
        """The density's denominator: every shard's worst-case buffer."""
        return self._n * self._u_sz()

    def _wl_host_spans(self) -> List[tuple]:
        spans, self._host_spans = self._host_spans, []
        return spans

    def _wl_trace_phases(self):
        return None

    def _wl_geometry(self) -> dict:
        return {
            "engine": self.engine_name,
            "shards": self._n,
            "capacity_per_shard": self._cap_s,
            "chunk_size": self._chunk,
            "dedup_factor": self._dedup_factor,
            "sortless": self._sortless,
            "sort_lanes": self._sort_width(),
            "step_lanes": self._step_width(),
            "bucket_slack": self._bucket_slack,
            "exchange_bucket_lanes": 0 if self._n == 1 else self._bucket_lanes(),
            "u_lanes": self._wl_cand_lanes(),
            "waves_per_call": self._waves_per_call,
        }

    def _wl_write_checkpoint(self) -> dict:
        self._write_snapshot(self._checkpoint_path)
        return {}

    def _wl_abort_cleanup(self) -> None:
        """Nothing to erase: an aborted wave inserted nothing (its received
        validity was gated off before the insert)."""

    def _wl_retryable_flags(self) -> int:
        # 4 (compaction), 32 (bucket), 128 (step rung): detected before any
        # insert, so the aborted wave committed nothing.  A table (1) or
        # queue (2) regrowth would change the global ids parent links and
        # snapshots hold, so those stay errors.
        return 4 | 32 | 128

    def _wl_overflow_message(self, flags: int) -> str:
        if flags & 16:
            return ("init-state seeding overflowed the insert buffers; "
                    "raise capacity or lower dedup_factor")
        if flags & 1:
            return (f"sharded fingerprint table overfull (per-shard capacity "
                    f"{self._cap_s}); raise capacity")
        if flags & 2:
            return ("a shard's frontier queue overflowed its backstop bound; "
                    "raise capacity")
        if flags & 8:
            return ("the model step kernel flagged an encoding-capacity "
                    "overflow (a successor exceeded the packed layout's "
                    "bounds); the compiled model's capacity assumptions do "
                    "not hold for this configuration")
        if flags & 4:
            return ("a shard's chunk had more VALID successor candidates than "
                    "its compaction/dedup buffers hold even at "
                    f"dedup_factor=1 (now {self._dedup_factor}); lower "
                    "chunk_size")
        if flags & 32:
            return ("the per-destination exchange bucket overflowed at the "
                    f"full-buffer rung (bucket_slack={self._bucket_slack}) -- "
                    "this cannot happen by construction; please report")
        if flags & 128:
            return ("the step-rung ladder clamped a wave at the full chunk "
                    "width -- impossible by construction; please report")
        return f"sharded engine overflow flags={flags}"

    def _grow_knobs(self, flags: int) -> Optional[str]:
        """The JAX ``_grow_knobs`` (``sharded.py:2238-2316``): flag 128
        climbs the step rung; flag 4 climbs the sort rung, or at the full
        buffer relaxes to ``dedup_factor=1`` (halving the chunk into the
        band); flag 32 climbs the bucket slack.  None where the tripped
        knob cannot grow."""
        notes = []
        if flags & 128:
            note = climb_step_rung(self, self._chunk)
            if note is None:
                return None
            self._step_retries += 1
            notes.append(note)
        if flags & 4:
            full = self._u_sz()
            note = climb_sort_rung(self, full)
            if note is not None:
                self._sort_retries += 1
                notes.append(note)
            else:
                a = self._compiled.max_actions
                relaxed = relax_dedup_geometry(
                    self._chunk, self._dedup_factor,
                    lambda c, dd: self._n * unique_buffer_size(c * a, dd),
                    max_safe_unique_lanes(self._compiled.state_width + 3),
                    chunk_label="chunk_size",
                )
                if relaxed is None:
                    return None
                self._dedup_factor, self._chunk, note = relaxed
                reset_sort_rung_to_full(self, full)
                if self._journal:
                    self._journal.append("geometry", **self._wl_geometry())
                notes.append(note)
        if flags & 32:
            nxt = next_bucket_slack(self._sort_width(), self._n, self._bucket_slack)
            if nxt is None:
                return None
            self._bucket_slack = nxt
            self._bucket_retries += 1
            notes.append(f"bucket_slack={nxt}")
        note = "; ".join(notes)
        log_grow(self, flags, note, self._unique_count, self._max_depth)
        return note

    def _wl_grow(self, flags: int) -> None:
        if self._grow_knobs(flags) is None:
            raise RuntimeError(self._wl_overflow_message(flags))

    # --- accounting and metrics ----------------------------------------------

    @staticmethod
    def _skew(arr) -> float:
        m = float(np.asarray(arr, np.float64).mean())
        return round(float(np.asarray(arr).max()) / m, 4) if m > 0 else 1.0

    def _update_shard_metrics(self, frontier, unique_l, cand) -> None:
        """Per-shard gauges and their max/mean skew, from the wave's
        readback (the JAX engine's, ``sharded.py:2135-2162``)."""
        w3 = (self._compiled.state_width + 3) * 4
        xbytes = [0 if self._n == 1 else int(c) * w3 for c in cand]
        self._metrics.update(
            shard_frontier={str(d): int(frontier[d]) for d in range(self._n)},
            shard_unique={str(d): int(unique_l[d]) for d in range(self._n)},
            shard_exchange_bytes={str(d): xbytes[d] for d in range(self._n)},
            frontier_skew_max_over_mean=self._skew(frontier),
            unique_skew_max_over_mean=self._skew(unique_l),
            exchange_skew_max_over_mean=self._skew(cand),
        )

    def _build_accounting(self, waves_total: int) -> dict:
        """The JAX engine's weak-scaling accounting (``sharded.py:
        2343-2413``): lockstep waves, the bucketed all-to-all payload at the
        final rung, its measured occupancy and the per-shard skew."""
        cm = self._compiled
        n = self._n
        u_sz = self._sort_width()
        bkt = self._bucket_lanes()
        cand_h = np.array([sh.cand for sh in self._shards], np.int64)
        uniq_h = np.array([sh.unique_l for sh in self._shards], np.int64)
        row_bytes = (cm.state_width + 3) * 4
        return {
            "shards": n,
            "waves": waves_total,
            "chunk_size": self._chunk,
            "exchange_lanes_per_shard": u_sz,
            "sort_lanes": u_sz,
            "sort_retries": self._sort_retries,
            "sortless": int(self._sortless),
            "step_lanes": self._step_width(),
            "step_retries": self._step_retries,
            "exchange_bucket_lanes": 0 if n == 1 else bkt,
            "bucket_slack": self._bucket_slack,
            "bucket_retries": self._bucket_retries,
            "exchange_elided": n == 1,
            "all_to_all_bytes_per_wave_per_shard": (
                0 if n == 1 else int(n * bkt * row_bytes)
            ),
            "all_to_all_bytes_total": (
                0 if n == 1 else int(waves_total * n * n * bkt * row_bytes)
            ),
            "candidates_sent_per_shard": cand_h.tolist(),
            "exchange_occupancy": (
                float(cand_h.sum() / (waves_total * n * n * bkt))
                if waves_total and n > 1 else 0.0
            ),
            "exchange_payload_bytes_total": (
                int(cand_h.sum() * row_bytes) if n > 1 else 0
            ),
            "unique_per_shard": uniq_h.tolist(),
            "unique_skew_max_over_mean": (
                float(uniq_h.max() / uniq_h.mean()) if uniq_h.sum() else 1.0
            ),
        }

    def accounting(self) -> dict:
        """Weak-scaling accounting of the finished run (the JAX engine's
        keys): lockstep waves, the all-to-all payload per wave and in all,
        its measured occupancy, and per-shard unique counts with their
        max/mean skew."""
        self.join()
        return dict(self._accounting)

    def metrics(self) -> dict:
        """Observability snapshot, the JAX engine's keys (``engine`` is
        ``"gpu-sharded"``); safe mid-run."""
        out = super().metrics()
        out.update(
            engine=self.engine_name,
            shards=self._n,
            trace=self._trace,
            capacity=self._cap_s * self._n,
            capacity_per_shard=self._cap_s,
            chunk_size=self._chunk,
            dedup_factor=self._dedup_factor,
            sortless=self._sortless,
            sort_lanes=self._sort_width(),
            sort_lanes_rung=self._sort_lanes or 0,
            step_lanes=self._step_width(),
            step_lanes_rung=self._step_lanes or 0,
            bucket_slack=self._bucket_slack,
            exchange_bucket_lanes=0 if self._n == 1 else self._bucket_lanes(),
        )
        snap = self._metrics.snapshot()
        out["table_load_factor"] = snap.get("table_occupancy", 0.0)
        out.update(snap)
        hists = self._metrics.snapshot_histograms()
        if hists:
            out["histograms"] = hists
        if self._accounting:
            out["accounting"] = dict(self._accounting)
        if self._tracer is not None:
            out["trace_summary"] = self._tracer.summary()
        return out

    # --- snapshots -----------------------------------------------------------

    def _stats_rows(self) -> np.ndarray:
        """The stats table, one row a shard, in the JAX layout (flags 0:
        only a committed state is persisted)."""
        rows = np.zeros((self._n, S_DISC + len(self._properties)), np.uint32)
        for d, sh in enumerate(self._shards):
            rows[d, :S_DISC] = [
                sh.level_start, sh.level_end, sh.tail, self._sc & M32,
                self._sc >> 32, self._unique_g, sh.unique_l, sh.cand & M32,
                sh.cand >> 32, self._depth, 0, self._waves_left & M32,
            ]
            rows[d, S_DISC:] = sh.disc
        return rows

    def _snapshot_arrays(self) -> Dict[str, np.ndarray]:
        """The run state as the JAX engine's npz arrays: every shard's key
        planes, store, parents, ebits and queue end to end, and the stats
        table."""
        planes = [sh.table.planes() for sh in self._shards]
        return {
            "key_hi": np.concatenate([p[0] for p in planes]),
            "key_lo": np.concatenate([p[1] for p in planes]),
            "store": np.concatenate([to_numpy_u32(sh.store) for sh in self._shards]),
            "parent": np.concatenate([to_numpy_u32(sh.parent) for sh in self._shards]),
            "ebits": np.concatenate([to_numpy_u32(sh.ebits) for sh in self._shards]),
            "queue": np.concatenate([to_numpy_u32(sh.queue) for sh in self._shards]),
            "stats": self._stats_rows(),
        }

    def _write_snapshot(self, path: str) -> None:
        """Atomic (write, then rename) persistence in ``save_snapshot``
        format, with the geometry and rungs a resume adopts."""
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as fh:
            np.savez_compressed(
                fh,
                engine_key=self._snapshot_key(),
                cap_s=self._cap_s,
                chunk=self._chunk,
                n_shards=self._n,
                bucket_slack=self._bucket_slack,
                sort_lanes=self._sort_lanes or 0,
                sortless=int(self._sortless),
                step_lanes=self._step_lanes or 0,
                **self._snapshot_arrays(),
            )
        os.replace(tmp, path)

    def save_snapshot(self, path: str) -> None:
        """Persist the full sharded run state (the JAX npz format) so a
        bounded run resumes through ``spawn_gpu_sharded(resume_from=path)``
        on a mesh of the same size."""
        self.join()
        if not self._shards:
            raise RuntimeError("no run state to snapshot")
        self._write_snapshot(path)

    def tuned_kwargs(self) -> dict:
        """Spawn kwargs at this run's final knobs (the JAX engine's rules:
        the sort rung only when pinned on the sorted path, the step rung
        only when pinned)."""
        self.join()
        return dict(
            capacity=self._cap_s * self._n,
            chunk_size=self._chunk,
            dedup_factor=self._dedup_factor,
            bucket_slack=self._bucket_slack,
            **(
                {"sort_lanes": self._sort_width()}
                if self._sort_lanes is not None and not self._sortless
                else {}
            ),
            sortless=int(self._sortless),
            **(
                {"step_lanes": self._step_width()}
                if self._step_lanes is not None else {}
            ),
        )

    # --- results ---------------------------------------------------------------

    def discovered_fingerprints(self) -> np.ndarray:
        """Sorted uint64 fingerprints of every discovered unique state (of
        its canonical row under symmetry): each shard's queue prefix."""
        self.join()
        if not self._shards:
            raise RuntimeError("no run state to fingerprint")
        fps = [
            fingerprints_of_rows(self._identity(
                sh.store[sh.queue[: sh.tail].long()]
            ))
            for sh in self._shards if sh.tail
        ]
        return np.sort(np.concatenate(fps))

    def state_count(self) -> int:
        return self._state_count

    def unique_state_count(self) -> int:
        return self._unique_count

    def max_depth(self) -> int:
        return self._max_depth

    def _gid_path(self, gid: int) -> Path:
        """Walk the parent chain across shards from global id ``gid`` (one
        host pull of the parents and stores), decode the rows and re-execute
        the host model along them."""
        with self._lock:
            if self._tables_host is None:
                if not self._shards:
                    raise RuntimeError(
                        "no run state to reconstruct paths from (the checker "
                        "did not complete cleanly)"
                    )
                self._tables_host = (
                    [to_numpy_u32(sh.parent) for sh in self._shards],
                    [to_numpy_u32(sh.store) for sh in self._shards],
                )
            parent, store = self._tables_host
        mask = self._cap_s - 1
        chain: List[int] = []
        g = gid
        while g != NO_GID:
            if len(chain) > self._unique_count:
                raise RuntimeError("parent chain does not end at an init state")
            chain.append(g)
            g = int(parent[g >> self._slot_bits][g & mask])
        chain.reverse()
        fps = [
            self._model.fingerprint(self._compiled.decode(
                store[g >> self._slot_bits][g & mask]
            ))
            for g in chain
        ]
        return Path.from_fingerprints(self._model, fps)

    def discoveries(self) -> Dict[str, Path]:
        self.join()
        if self._discoveries_cache is None:
            with self._lock:
                items = list(self._discovery_gids.items())
            self._discoveries_cache = {
                name: self._gid_path(g) for name, g in items
            }
        return dict(self._discoveries_cache)

    def handles(self) -> List[threading.Thread]:
        return [self._thread]

    def is_done(self) -> bool:
        return self._done.is_set()

    def join(self) -> "ShardedGpuChecker":
        self._thread.join()
        if self._errors:
            raise self._errors[0]
        return self
