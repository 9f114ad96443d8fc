"""The single-GPU wavefront checker.

The counterpart of ``stateright_tpu/parallel/wavefront.py`` (``TpuChecker``):
a wavefront BFS that expands a whole chunk of the frontier at once,
fingerprints every candidate successor, deduplicates them by a batched
insert-if-absent into a device-resident fingerprint table, and evaluates
property conditions as fused predicates over the wave.  The device work of
a wave runs in hand-written kernels -- the model's step and conds (K2 for
2pc; K5, K6 and K7 for paxos, K14 and K6 for ballot-bounded paxos; K9,
K10, K11, K13, K16 and K17 for the single-copy register, ABD, raft,
ping-pong, the LWW register and the trap counter), the wave verdicts
(K8), under symmetry the canonical form (K15), the fingerprint (K1),
stable compaction (K3), the claim insert (K4) and, on the sorted dedup
path, the key sort (K12) -- glued by a few torch tensor operations.

A model with the two-phase contract (``compiled.py``; paxos) is expanded
in two phases, as in the JAX engine: lane validity first (K5), the valid
lanes compacted (K3), and successors built (K7), fingerprinted (K1) and
inserted (K4) only for those -- about one lane in twenty for paxos.

States are identified by BFS position (the order of first discovery): the
row log is one flat ``int32`` buffer (the u32 words as bit-views), a level
is a contiguous range of positions, a chunk's read and the new states'
append are contiguous block copies, and only the hash table is indexed at
random.  The log, parents and eventually-bits are updated IN PLACE; the
JAX engine threads them through its loop as donated buffers.

Semantics are the JAX engine's, and the tests hold the port to it bit for
bit (row log, parents, ebits, counts, discoveries):

- properties are evaluated when a state is expanded; states beyond
  ``target_max_depth`` are counted but never expanded;
- ``state_count`` counts init states plus generated successors before
  dedup; ``unique_state_count`` counts table insertions;
- the representative of a key generated several times in one wave is its
  lowest candidate lane (state-major, action-minor); on the claim path
  new states take positions in the order of (parent position, action) of
  first generation, on the sorted path (after a full-buffer flag 4, or
  ``sortless=False``) in the order of their unsigned 64-bit fingerprints
  within each wave -- so there the chunk width is part of the result;
- a bounded model (one whose compiled form has a ``boundary``) drops each
  successor outside it from the wave's valid lanes before they are
  counted, and is expanded in one phase;
- eventually-bits travel with each state (the first inserter's bits win,
  the reference's documented join behaviour);
- a state's identity is its row's leading ``fp_words`` words (the whole
  row unless the compiled model says less): K1 hashes that prefix in
  place, while the row log, parents, conds and paths keep the whole row,
  whose trailing words ride along with the representative;
- under ``symmetry()`` the identity is that of the row's canonical form
  (K15, ``canon.py``): the seed, every wave, the rehash and
  ``discovered_fingerprints()`` hash canonical rows, while the row log,
  parents, property evaluation and paths keep the original rows;
- discoveries are first-writer-wins in wave order; paths are rebuilt by
  walking the parent chain, decoding rows and re-executing the host model.

An untraced run is the JAX engine's fused loop (``_build_run``): a
QUANTUM of up to ``waves_per_call`` waves runs behind one readback of one
stats tensor (the JAX stats layout, ``parallel/fused.py``), every scalar
of the carry and every per-wave decision -- flags, commit, the discovery
fold, the level roll, the loop condition -- on the card (K29, with the
device-count entries of K1, K4, K8 and K25); on the card the quantum is
one launch of a CUDA graph (the captured wave inside a WHILE node), on
the CPU a Python loop over the twins.  The host refreshes its scalar
carry from each readback.  An overflowing wave (flags 1/2/4/8/128)
commits nothing and ends the quantum, and growth rebuilds the table from
the committed log before the same chunk runs again.  Traced runs, a
visitor and the tiered checker keep the per-wave loop: a wave runs in
phases (expand, fingerprint, insert and compact, the readback, the commit
through K25), so an engine built on this one -- the tiered checker,
``tiered/engine.py`` -- folds values into the readback and filters the new
lanes between the readback and the append.  Around the loop sit the JAX
engine's surface: ``metrics()`` (with the vitals' histograms),
``tuned_kwargs()``, the journal, the checkpoint cadence, ``auto_tune``,
traced mode (``trace=True``: each phase timed and charged modeled bytes
against the card's peak, ``obs/``) and ``CheckerBuilder.visitor()``, fed
from the traced readback.
"""

from __future__ import annotations

import ast
import hashlib
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.checker import Checker
from ..core.model import Expectation
from ..core.path import Path
from ..obs.metrics import MetricsRegistry
from ..obs.roofline import slot_bytes, sort_bytes
from ..obs.trace import NO_CLOCK, PhaseClock, WaveTracer
from ..ops.cuda import resolve_device
from ..ops.device_fp import device_fp64, device_fp64_n
from ..ops.u32 import M32, from_numpy_u32, to_numpy_u32
from ..runtime.journal import as_journal
from .append import append_block, append_block_dev
from .canon import make_canon
from .compiled import CompiledModel, compiled_model_for, two_phase_capable
from .fused import (
    CTL_EPOCH, CTL_GO, CTL_WAVE_LO, CTL_WAVES_RUN, STAT_DEPTH, STAT_DISC,
    STAT_FLAGS, STAT_LEVEL_END, STAT_LEVEL_START, STAT_SC_HI, STAT_SC_LO,
    STAT_TAIL, STAT_UNIQUE, WhileGraph, ctl_index, stats_words,
    wave_ctl, wave_load,
)
from .hashset import (
    _EPOCH_MAX, HashSet, compact_valid, compact_valid_indices,
    insert_batch_claim, insert_batch_claim_dev, insert_batch_compact,
    unique_buffer_size,
)
from .wave_common import (
    NO_ID, compact, default_waves_per_call, finish_when_masks,
    make_finish_when_device, prop_kinds, wave_eval, wave_eval_dev,
)
from .wave_loop import (
    SORT_RUNG_MIN, STEP_RUNG_MIN, FusedWaveLoop, WaveLoop, WaveView,
    clamp_sort_lanes, clamp_step_lanes, climb_sort_rung, climb_step_rung,
    fall_back_to_sort, finalize_run, fingerprints_of_rows, log_grow,
    relax_dedup_geometry, reset_sort_rung_to_full,
)

# Growth bounds, sized for one 80 GB card: a table slot costs 16 bytes there
# (key word + election word), a row-log position 4 * state_width + 8.
_MAX_TABLE_CAPACITY = 1 << 30
_ROW_LOG_BYTE_BUDGET = 16 << 30
# Rows per insert when the table is rebuilt from the log after growth.
_REHASH_ROWS = 1 << 22
# The JAX engine's band on the compaction buffer (``wavefront.py:100``,
# validated on a TPU v5e): at most 425,984 lanes and 11,010,048 lane-words.
# The port applies it wherever flag 4 can fire, because there the chunk
# width decides which wave first overflows, and on the sorted path (which
# appends in sorted-key order within a wave) it decides the row log too:
# the band keeps the port's log the JAX engine's at the same arguments.
_MAX_UNIQUE_BUFFER = 425_984
_MAX_UNIQUE_LANE_WORDS = 11_010_048


def max_safe_unique_lanes(state_width: int) -> int:
    """The JAX engine's cap on the compaction buffer's lanes for a model of
    this state width."""
    return min(
        _MAX_UNIQUE_BUFFER, _MAX_UNIQUE_LANE_WORDS // max(state_width, 1)
    )


def snapshot_engine_key(cm, properties, symmetric: bool = False) -> str:
    """Compatibility key of engine snapshots -- the JAX package's
    ``snapshot_engine_key``, character for character, so the two engines
    resume each other's snapshots.  A symmetric run's table holds
    canonical fingerprints, so its key carries a ``"sym"`` suffix and
    neither kind of snapshot resumes as the other."""
    init_digest = hashlib.sha256(cm.init_packed().tobytes()).hexdigest()[:16]
    return repr(
        (
            "rowlog-v3",
            type(cm).__qualname__,
            cm.state_width,
            cm.max_actions,
            tuple(p.name for p in properties),
            init_digest,
        )
        + (("sym",) if symmetric else ())
    )


@dataclass
class Carry:
    """The whole run state: the device table and logs plus the host's copy
    of the scalars the JAX engine keeps in its stats vector (the fused
    loop refreshes them from each quantum's readback)."""

    table: HashSet
    rows: torch.Tensor  # int32[log_capacity * W], positions in BFS order
    parent: torch.Tensor  # int32[log_capacity], NO_ID (-1) for init states
    ebits: torch.Tensor  # int32[log_capacity], remaining eventually-bits
    level_start: int
    level_end: int
    tail: int
    state_count: int
    unique_count: int
    depth: int
    disc: List[int]  # per property: BFS position of its discovery, or NO_ID


def wave_bytes(*, count: int, a: int, w: int, fpw: int, n_props: int,
               u: int, n_valid: int, n_inserted: int, n_new: int,
               probe_slots: int, two_phase: bool, sortless: bool,
               symmetric: bool) -> Dict[str, int]:
    """Modeled device bytes of one traced wave, per phase: each phase read
    as one function of the wave's counts, its inputs read once and its
    outputs written once (what a phase hands its next kernel inside the
    phase is not counted: consecutive passes over one buffer partly hit
    L2, and a count of every kernel's inputs and outputs reads above the
    card's peak on the small waves).

    ``count`` states expanded, ``a`` actions, rows of ``w`` words hashed
    on their leading ``fpw`` (all ``w`` under symmetry, which K15 reads),
    ``n_props`` properties, a compaction buffer of ``u`` lanes (the
    wave's: ``min(U, count * a)`` for the full chunk's ``U``),
    ``n_valid`` valid candidates (the wave's ``generated``), ``n_inserted``
    keys the insert found new, ``n_new`` states appended, ``probe_slots``
    table slots the insert's lanes read (K4's figure, ``obs/roofline.py``).
    With ``b = count * a``:

    - ``step``: the states' rows and eventually-bits in, their
      eventually-bits and the discovery candidates out; single-phase, the
      ``b`` successor rows and their validity out; two-phase, the buffer's
      lane indices and active and flag bytes (``6u``) and the ``n_valid``
      successor rows out;
    - ``canon``: the hashed words of each candidate row in and its two key
      words out -- the whole ``u``-row buffer two-phase (K1 hashes it
      all, as the JAX program does), all ``b`` candidates single-phase,
      whose validity (``b``) is read too and whose valid keys come out
      compacted with their lane indices and active bytes (``13u``);
    - ``dedup``: the active bytes (``u``), the ``n_valid`` active lanes'
      keys and the ``probe_slots`` slots in (8 bytes each), the
      ``n_inserted`` new keys and K3's ``u``-lane compaction of the new
      mask out; the sorted path adds K12's passes over the ``n_valid``
      lanes it sorts (``sort_bytes``; the prefix entry sorts no more),
      its ``u`` representative flags, and the representatives' keys in
      and origins out (``12u``);
    - ``append``: K25, each new state's index words (2, 3 on the sorted
      path) and its parent's eventually-bits in, its row in and out, its
      parent and ebits out.

    Where it differs from the JAX engine's model
    (``stateright_tpu/parallel/wavefront.py:1687-1732``): the JAX programs
    stream whole fixed-width buffers (the chunk at ``max_frontier``, ``U``
    rows gathered or built, whole append blocks), so that model charges
    buffer widths; the port's kernels touch the wave's live counts and a
    buffer no wider than its chunk's candidates, and the model charges
    those.  The two agree on the two-phase ``canon`` term without
    symmetry (``4 fpw u + 8u``) on a full chunk.  The JAX ``dedup`` term
    charges every buffer lane every lockstep round (``probe_bytes``) and
    the sorted path a bitonic network of ``k(k+1)/2`` passes over three
    planes of the whole buffer; K4 walks only the active lanes' chains
    and K12 makes 8 radix passes over the active prefix, so the port
    charges the slots read and
    :func:`~stateright_tpu_torch.obs.roofline.sort_bytes` of ``n_valid``.  The JAX
    ``append`` term holds the new-mask compaction, which the port runs in
    ``dedup`` (its readback needs the count)."""
    b = count * a
    states = count * (4 * w + 8) + 8 * n_props
    if two_phase:
        step = states + 6 * u + n_valid * 4 * w
        hashed = u
    else:
        step = states + b * (4 * w + 1)
        hashed = b
    canon = hashed * (4 * (w if symmetric else fpw) + 8)
    if not two_phase:
        canon += b + 13 * u
    dedup = (
        u + 8 * n_valid + slot_bytes(probe_slots) + 8 * n_inserted
        + 4 * u
    )
    if not sortless:
        dedup += sort_bytes(min(n_valid, u)) + 13 * u
    index_words = 2 if sortless else 3
    append = n_new * (4 * index_words + 8 * w + 12)
    return {"step": step, "canon": canon, "dedup": dedup, "append": append}


def _sized(t: torch.Tensor, n: int, fill: int) -> torch.Tensor:
    """A copy of the 1-D ``t`` trimmed or padded with ``fill`` to ``n``."""
    out = torch.full((n,), fill, dtype=t.dtype, device=t.device)
    k = min(n, t.shape[0])
    out[:k] = t[:k]
    return out


def carry_from_snapshot(npz_arrays, device="cpu") -> Carry:
    """Carry a run state across from the JAX engine: turn the arrays of a
    ``TpuChecker.save_snapshot`` npz (``key_hi``, ``key_lo``, ``rows``,
    ``parent``, ``ebits``, the scalars, ``disc``, ``log_capacity``) into the
    port's tensors on ``device``.

    The table needs no rebuild: the port's 64-bit slot is the JAX package's
    ``(key_hi, key_lo)`` pair of the same slot, and both engines probe the
    same home slot linearly.  The logs are trimmed or padded to
    ``log_capacity`` positions (the JAX engine keeps an append pad past
    it).  The state width is read from the snapshot's ``engine_key``; the
    tiered engine's cold arrays ride beside these and are its own."""
    qcap = int(npz_arrays["log_capacity"])
    key = str(npz_arrays["engine_key"])
    # The key is a tuple's repr, with an engine's suffix after it
    # ("+tiered-v1") on a tiered snapshot.
    w = int(ast.literal_eval(key[: key.rindex(")") + 1])[2])
    rows = np.asarray(npz_arrays["rows"], np.uint32)
    table = HashSet.from_planes(npz_arrays["key_hi"], npz_arrays["key_lo"], device)
    sc = (int(npz_arrays["sc_hi"]) << 32) | int(npz_arrays["sc_lo"])
    return Carry(
        table=table,
        rows=_sized(from_numpy_u32(rows, device), qcap * w, 0),
        parent=_sized(from_numpy_u32(npz_arrays["parent"], device), qcap, -1),
        ebits=_sized(from_numpy_u32(npz_arrays["ebits"], device), qcap, 0),
        level_start=int(npz_arrays["level_start"]),
        level_end=int(npz_arrays["level_end"]),
        tail=int(npz_arrays["tail"]),
        state_count=sc,
        unique_count=int(npz_arrays["unique_count"]),
        depth=int(npz_arrays["depth"]),
        disc=[int(d) for d in np.asarray(npz_arrays["disc"], np.uint32)],
    )


def snapshot_arrays(
    carry: Carry, capacity: int, log_capacity: int
) -> Dict[str, np.ndarray]:
    """The inverse of :func:`carry_from_snapshot`: the JAX npz arrays."""
    key_hi, key_lo = carry.table.planes()
    u32 = np.uint32
    return {
        "capacity": np.int64(capacity),
        "log_capacity": np.int64(log_capacity),
        "key_hi": key_hi,
        "key_lo": key_lo,
        "rows": to_numpy_u32(carry.rows),
        "parent": to_numpy_u32(carry.parent),
        "ebits": to_numpy_u32(carry.ebits),
        "level_start": u32(carry.level_start),
        "level_end": u32(carry.level_end),
        "tail": u32(carry.tail),
        "sc_lo": u32(carry.state_count & M32),
        "sc_hi": u32(carry.state_count >> 32),
        "unique_count": u32(carry.unique_count),
        "depth": u32(carry.depth),
        "disc": np.asarray(carry.disc, u32),
    }


@dataclass
class Wave:
    """One wave in flight, filled phase by phase (:meth:`GpuChecker._wl_wave`):
    the expansion's buffers, the fingerprints, the insert's result, and the
    scalars of the wave's one readback.  ``extra`` holds what an engine
    folded into that readback (:meth:`GpuChecker._wave_extra_stats`)."""

    count: int  # states expanded
    lo_pos: int  # log position of the first
    size: int  # compaction buffer lanes
    eb: torch.Tensor = None  # int32[count] eventually-bits after the wave
    cands: torch.Tensor = None  # int64[P] discovery candidates
    cand_rows: torch.Tensor = None  # successor rows (two-phase: compacted)
    v_orig: torch.Tensor = None  # buffer lane -> original lane
    v_act: torch.Tensor = None  # filled buffer lanes
    n_valid: torch.Tensor = None  # int64 count of valid lanes
    step_flag: torch.Tensor = None  # the step kernel's overflow flag
    valid: torch.Tensor = None  # single-phase: the lanes' validity
    hi: torch.Tensor = None  # int32 key halves of the buffer lanes
    lo: torch.Tensor = None
    is_new: torch.Tensor = None  # bool: the lanes to append
    u_origin: Optional[torch.Tensor] = None  # sorted path: u lane -> buffer lane
    probe_ok: torch.Tensor = None
    dd_overflow: torch.Tensor = None
    sel: torch.Tensor = None  # K3's compaction of is_new
    n_new_d: torch.Tensor = None
    probe: Optional[torch.Tensor] = None  # traced: K4's probe figures
    # The readback's scalars.
    n_new: int = 0  # new lanes to append (after an engine's filter)
    n_inserted: int = 0  # keys the insert found new
    generated: int = 0
    ok: int = 1
    s_flag: int = 0
    dd_flag: int = 0
    probe_rounds: int = 0
    probe_slots: int = 0
    extra: tuple = ()
    cand_ids: tuple = ()


class GpuChecker(Checker):
    """Single-GPU wavefront checker behind the standard Checker surface."""

    engine_name = "gpu-wavefront"
    spawn_name = "spawn_gpu()"

    def __init__(
        self,
        options,
        capacity: int = 1 << 20,
        max_frontier: int = 1 << 15,  # per-chunk batch size, not a level cap
        dedup_factor: int = 8,
        device=None,
        compiled: Optional[CompiledModel] = None,
        resume_from: Optional[str] = None,
        log_capacity: Optional[int] = None,
        sort_lanes: Optional[int] = None,
        sortless: Optional[bool] = None,
        step_lanes: Optional[int] = None,
        waves_per_call: Optional[int] = None,
        auto_tune: bool = True,
        journal=None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every_waves: Optional[int] = None,
        checkpoint_every_sec: Optional[float] = None,
        trace: bool = False,
    ):
        """``capacity`` sizes the fingerprint table (slots; load is kept at
        or below 50%), ``log_capacity`` the row log (positions = unique
        states; defaults to ``capacity``), ``max_frontier`` the states one
        wave expands and ``dedup_factor`` the compaction buffer
        (``max(min(B, 16K), B / dedup_factor)`` lanes for B = max_frontier
        * max_actions candidates).  With ``auto_tune`` (the default) an
        overflow grows the tripped buffer in place: the table x16 (dragging
        a defaulted log), the log x2; a compaction-buffer overflow (flag 4)
        follows the JAX engine's rules in its order -- an explicit claim
        budget falls back to the sorted path, a rung below the full buffer
        climbs, the claim path at the full buffer falls back to the sorted
        path (``sortless=0``), and the sorted path relaxes to
        ``dedup_factor=1``, halving ``max_frontier`` while the buffer
        exceeds :func:`max_safe_unique_lanes`.  A buffer already at its
        ceiling, or any overflow with ``auto_tune=False``, raises instead.

        ``sortless`` selects the dedup path: the claim election (K4 over
        the compacted batch, new states appended in lane order) or the
        sorted fallback (K12 + K3 + K4, new states appended in sorted-key
        order within a wave); it defaults to ``sort_lanes is None``, as in
        the JAX engine.  ``sort_lanes`` pins the compaction width to a
        power-of-two rung below the full buffer; without it the density
        tuner downshifts the rung between committed quanta of the fused
        loop (``maybe_retune_sort``), as the JAX engine's does.
        ``step_lanes`` is the JAX step rung: a power-of-two chunk width
        below ``max_frontier``; a wave whose level outgrows it raises the
        non-committing flag 128 and the rung climbs (``climb_step_rung``);
        without it the frontier tuner downshifts between quanta
        (``maybe_retune_step``).  Wherever flag 4 can fire
        (``dedup_factor > 1``, a rung, or the sorted path) the spawn halves
        ``max_frontier`` until the buffer fits the JAX band, so which wave
        overflows -- and on the sorted path the row log -- is the JAX
        engine's at the same arguments; at ``dedup_factor=1`` on the claim
        path the caller's chunk stands (the log does not depend on it).

        ``waves_per_call``: the waves of one quantum of an untraced run --
        the JAX fused loop's, 256 by default and 1 where only the host can
        stop the run (a ``timeout``, ``target_state_count`` or a
        trivially-true ``finish_when``, ``default_waves_per_call``).  A
        quantum runs on the card behind one readback of the stats; on the
        card it is one launch of a CUDA graph (captured at first use and
        again after growth or a rung change, journaled as a ``compile``
        event), on the CPU a loop over the twins.  The journal's ``wave``
        event, the vitals, ``waves()`` and the checkpoint cadence count
        waves as the JAX loop does: ``waves_per_call`` a quantum.

        ``journal`` (a :class:`~stateright_tpu_torch.runtime.journal.
        Journal` or a path) streams the run's ``geometry``, ``wave``,
        ``grow``, ``resume``, ``checkpoint`` and ``engine_done`` events as
        JSON lines, the JAX engine's schema.  ``checkpoint_path`` enables
        mid-run snapshots (``save_snapshot`` format, atomic write and
        rename) every ``checkpoint_every_waves`` committed waves or
        ``checkpoint_every_sec`` seconds (default 30 when only the path is
        given), and a completion snapshot at the end; a stopped run
        resumes from it through ``resume_from``.

        ``trace``: time every phase of every wave (``step``, ``canon``,
        ``dedup``, ``readback``, ``append``; the tiered engine adds
        ``cold_probe``) with a ``torch.cuda.synchronize`` at each boundary,
        and charge each phase its modeled bytes against the card's peak
        bandwidth (``obs/roofline.py``, :meth:`_traced_wave_bytes`).
        Results are identical (same kernels, same commit order);
        throughput is not -- a traced wave pays a sync a phase and exists
        to say where the untraced run's time goes.  Each committed wave's
        journal ``wave`` event gains ``wave_breakdown``, ``bytes``,
        ``hbm_util_frac``, ``probe_rounds`` and ``probe_slots``; the run
        ends with a ``trace_summary`` event; ``metrics()`` and
        :meth:`trace_summary` carry the reduction (``bottleneck_phase``
        among it).  Traced runs grow, stop and time out through the same
        loop as untraced ones; like the JAX engine's they refuse
        ``resume_from`` and skip the mid-run checkpoint cadence (the
        completion checkpoint still lands).  Like the JAX traced loop, the
        traced loop runs no density tuner.  A builder
        ``visitor()`` forces ``trace`` on: each expanded state is visited
        once, as a single-state path, in BFS level order across waves and
        log order within a wave, from the traced readback.

        ``device`` defaults to ``cuda``; with no card present the spawn
        raises -- it never carries on on the CPU unless the caller asks for
        ``device="cpu"``.  ``resume_from`` continues a run from a snapshot
        of either engine (``save_snapshot``, JAX npz format), adopting its
        table and log geometry."""
        super().__init__(options.model)
        self._visitor = options._visitor
        # The visitor stream rides the traced readback.
        self._trace = bool(trace) or self._visitor is not None
        if self._trace and resume_from is not None:
            raise ValueError(
                f"{self.spawn_name[:-2]}(trace=True) does not support "
                "resume_from: tracing is a diagnostic mode; resume the run "
                "untraced and trace a fresh (bounded) run instead"
            )
        self._device = resolve_device(device, self.spawn_name)
        self._options = options
        self._compiled = compiled or compiled_model_for(options.model)
        # Symmetry: dedup on the fingerprint of the canonical row.  A model
        # with no canonicalization is refused here: exploring the full
        # space silently would report its counts as if they were reduced.
        self._canon = (
            make_canon(self._compiled)
            if options._symmetry is not None
            else None
        )
        if options._symmetry is not None and self._canon is None:
            raise ValueError(
                "spawn_gpu() with symmetry() requires the compiled model "
                f"to declare a canonicalization, but "
                f"{type(self._compiled).__name__} defines neither "
                "canon_spec() nor canon_rows (parallel/canon.py)"
            )
        if capacity & (capacity - 1):
            raise ValueError("capacity must be a power of two")
        self._capacity = capacity
        self._log_capacity = log_capacity or capacity
        # An explicit log_capacity is the caller's memory geometry: growth of
        # the table does not drag it along.
        self._log_capacity_explicit = log_capacity is not None
        self._max_frontier = max_frontier
        self._dedup_factor = dedup_factor
        # The sort-geometry rung, the dedup path and the step rung, with
        # their tuners' evidence, as the JAX engine sets them
        # (``wavefront.py:369-397``): an explicit rung is never tuned.
        self._sort_lanes = (
            None if sort_lanes is None else clamp_sort_lanes(sort_lanes)
        )
        self._sort_tune = sort_lanes is None
        self._sort_rung_floor = SORT_RUNG_MIN
        self._sort_peak_valid = 0.0
        self._sort_quanta = 0
        self._sortless = (
            (sort_lanes is None) if sortless is None else bool(sortless)
        )
        self._step_lanes = (
            None if step_lanes is None else clamp_step_lanes(step_lanes)
        )
        self._step_tune = step_lanes is None
        self._step_rung_floor = STEP_RUNG_MIN
        self._step_peak_frontier = 0.0
        self._step_quanta = 0
        self._waves_per_call = (
            default_waves_per_call(options) if waves_per_call is None
            else int(waves_per_call)
        )
        self._auto_tune = bool(auto_tune)
        self._resume_from = resume_from
        self._properties = self._model.properties()
        if len(self._properties) > 32:
            raise ValueError("at most 32 properties supported on device")
        self._ev_indices = [
            i
            for i, p in enumerate(self._properties)
            if p.expectation is Expectation.EVENTUALLY
        ]
        self._kinds = prop_kinds(self._properties)
        self._two_phase = two_phase_capable(self._compiled)
        if dedup_factor > 1 or sort_lanes is not None or not self._sortless:
            self._clamp_chunk()
        # State identity: the leading fp_words of a row (compiled.py).
        self._fp_words = self._compiled.fp_words or self._compiled.state_width
        self._fw_matched = make_finish_when_device(
            options._finish_when, self._properties
        )
        self._fw_masks = finish_when_masks(options._finish_when, self._properties)
        self._metrics = MetricsRegistry()
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
        self._final_load_factor: Optional[float] = None
        self._tracer: Optional[WaveTracer] = None  # built by _run when traced
        self._trace_phases: Optional[Dict[str, float]] = None
        self._trace_record: Optional[dict] = None
        self._host_spans: List[tuple] = []
        self._discovery_slots: Dict[str, int] = {}
        self._state_count = 0
        self._unique_count = 0
        self._max_depth = 0
        self._carry: Optional[Carry] = None
        # The fused loop's device stats (``parallel/fused.py``), its
        # captured quantum (one: growth, a rung change or a resume moves
        # the buffers it holds), that graph's key and memory pool, and its
        # counts: stats readbacks, waves run (not counted as the JAX loop
        # counts them).
        self._stats: Optional[torch.Tensor] = None
        self._graph: Optional[WhileGraph] = None
        self._graph_at: Optional[tuple] = None
        self._graph_pool = None
        self._quantum_graph: Optional[WhileGraph] = None
        self._quantum_eager = 0
        self._readbacks = 0
        self._waves_run = 0
        self._capture_sec: List[float] = []
        self._waves = 0
        self._grow_flags: List[int] = []  # overflow flags of each growth
        self._grow_notes: List[str] = []  # what each growth changed
        self._discoveries_cache: Optional[Dict[str, Path]] = None
        self._done = threading.Event()
        self._errors: List[BaseException] = []
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _clamp_chunk(self) -> None:
        """The JAX spawn clamp (``wavefront.py:400-430``): halve
        ``max_frontier`` (not below 2,048) while the worst-case buffer
        exceeds :func:`max_safe_unique_lanes`; refuse a geometry that the
        floor chunk cannot fit."""
        a = self._compiled.max_actions
        cap = max_safe_unique_lanes(self._compiled.state_width)
        requested = self._max_frontier
        while (
            self._max_frontier > 2048
            and unique_buffer_size(self._max_frontier * a, self._dedup_factor) > cap
        ):
            self._max_frontier //= 2
        if unique_buffer_size(self._max_frontier * a, self._dedup_factor) > cap:
            raise ValueError(
                f"chunk geometry (max_frontier={self._max_frontier}, "
                f"max_actions={a}, dedup_factor={self._dedup_factor}) exceeds "
                "the compaction-buffer band even at the floor chunk; raise "
                "dedup_factor"
            )
        if self._max_frontier != requested:
            logging.getLogger(__name__).warning(
                "spawn_gpu: max_frontier clamped to %d (max_actions=%d, "
                "dedup_factor=%d): the requested chunk geometry exceeds the "
                "compaction-buffer band", self._max_frontier, a,
                self._dedup_factor,
            )

    def _identity(self, rows: torch.Tensor) -> torch.Tensor:
        """What K1 hashes of packed rows ``int32[N, W]``: the identity
        prefix of each row, or of its canonical form under symmetry."""
        if self._canon is not None:
            rows = self._canon(rows)
        return rows[:, : self._fp_words]

    def _wl_full_sort_lanes(self) -> int:
        """The worst-case compaction buffer U of a full chunk at the live
        step rung (the JAX engine's)."""
        return unique_buffer_size(
            self._step_width() * self._compiled.max_actions, self._dedup_factor
        )

    def _step_width(self) -> int:
        """The live chunk width: the step rung capped at ``max_frontier``
        (growth may halve it), or ``max_frontier``."""
        if self._step_lanes is None:
            return self._max_frontier
        return min(self._step_lanes, self._max_frontier)

    def _wl_full_step_lanes(self) -> int:
        return self._max_frontier

    def _wl_apply_sort_rung(self, rung: int) -> None:
        """A density-tuner downshift (``maybe_retune_sort``): the new rung,
        fresh evidence, the geometry re-journaled; the next quantum
        captures its graph at the new width."""
        self._sort_lanes = int(rung)
        self._sort_quanta = 0
        if self._journal:
            self._journal.append("geometry", **self._wl_geometry())

    def _wl_apply_step_rung(self, rung: int) -> None:
        """A frontier-tuner downshift (``maybe_retune_step``), as
        :meth:`_wl_apply_sort_rung`."""
        self._step_lanes = int(rung)
        self._step_quanta = 0
        if self._journal:
            self._journal.append("geometry", **self._wl_geometry())

    def _sort_width(self) -> int:
        """The live compaction width: the rung capped at U, or U."""
        full = self._wl_full_sort_lanes()
        if self._sort_lanes is None:
            return full
        return min(self._sort_lanes, full)

    # --- run -------------------------------------------------------------

    def _run(self) -> None:
        try:
            timeout = self._options._timeout
            deadline = None if timeout is None else time.monotonic() + timeout
            if self._device.type == "cuda":
                torch.cuda.set_device(self._device)
            self._carry = (
                self._resume() if self._resume_from is not None else self._seed()
            )
            if self._trace:
                self._tracer = WaveTracer(self._device, self.engine_name)
            if self._trace or not self._fused:
                self._waves = WaveLoop(self).run(deadline)
            else:
                self._waves = FusedWaveLoop(self).run(deadline)
            if self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
            if self._tracer is not None and self._journal:
                self._journal.append("trace_summary", **self._tracer.summary())
            finalize_run(self)
        except BaseException as e:  # propagate at join, like the host engine
            self._errors.append(e)
        finally:
            self._drop_graph()
            self._quantum_graph = None
            self._done.set()

    def _seed(self) -> Carry:
        """Insert the init states (through K1 and K4, electing the lowest
        lane of equal init states, where the JAX engine uses its sorted
        insert) and write the unique ones to positions 0.. in lane order."""
        cm = self._compiled
        w = cm.state_width
        dev = self._device
        init = cm.init_packed()
        n_init = init.shape[0]
        if n_init > self._max_frontier:
            raise ValueError(
                f"{n_init} init states exceed the chunk size "
                f"({self._max_frontier}); raise spawn_gpu(max_frontier=...)"
            )
        init_t = from_numpy_u32(init, dev)
        hi, lo = device_fp64(self._identity(init_t))
        active = torch.ones((n_init,), dtype=torch.bool, device=dev)
        while True:
            table = HashSet.empty(self._capacity, dev)
            is_new, ok = insert_batch_claim(table, hi, lo, active)
            sel, fcount = compact(is_new, n_init)
            fcount, ok = (int(x) for x in torch.stack([fcount, ok.long()]).tolist())
            if ok:
                break
            grown = self._grow_knob(1) if self._auto_tune else None
            if grown is None:
                raise RuntimeError(
                    "init-state seeding overflowed the fingerprint table; "
                    "raise spawn_gpu(capacity=...)"
                )
            if self._journal:
                self._journal.append("grow", seed=True, flags=1, grown=grown)
        qcap = max(self._log_capacity, fcount)
        self._log_capacity = qcap
        rows = torch.zeros((qcap * w,), dtype=torch.int32, device=dev)
        rows[: fcount * w] = init_t[sel[:fcount].long()].reshape(-1)
        parent = torch.full((qcap,), -1, dtype=torch.int32, device=dev)
        ebits = torch.zeros((qcap,), dtype=torch.int32, device=dev)
        eb0 = (1 << len(self._ev_indices)) - 1
        ebits[:fcount] = (eb0 ^ 0x80000000) - 0x80000000  # as an int32 bit-view
        return Carry(
            table=table, rows=rows, parent=parent, ebits=ebits,
            level_start=0, level_end=fcount, tail=fcount,
            state_count=n_init, unique_count=fcount, depth=0,
            disc=[NO_ID] * len(self._properties),
        )

    def _check_snapshot(self, arrays) -> None:
        """Refuse a snapshot this checker cannot resume."""
        if "capacity" not in arrays:
            raise ValueError(
                "snapshot predates the rowlog-v3 format (no persisted "
                "geometry); re-run the original check"
            )
        got = str(arrays["engine_key"])
        want = self._snapshot_key()
        if got != want:
            raise ValueError(
                "snapshot does not match this checker configuration"
                f" (snapshot {got}, expected {want})"
            )

    def _resume(self) -> Carry:
        with np.load(self._resume_from, allow_pickle=False) as snap:
            arrays = {k: snap[k] for k in snap.files}
        self._check_snapshot(arrays)
        self._capacity = int(arrays["capacity"])
        self._log_capacity = int(arrays["log_capacity"])
        carry = carry_from_snapshot(arrays, self._device)
        for p, prop in enumerate(self._properties):
            if carry.disc[p] != NO_ID:
                self._discovery_slots[prop.name] = carry.disc[p]
        extra = self._restore_extra(arrays)
        if self._journal:
            self._journal.append(
                "resume", path=self._resume_from, unique=carry.unique_count,
                states=carry.state_count, depth=carry.depth, **extra,
            )
        return carry

    def _restore_extra(self, arrays) -> dict:
        """Restore what a subclass keeps beside the carry in a snapshot
        (:meth:`_snapshot_extra`); returns the ``resume`` event's extra
        journal fields."""
        return {}

    # --- wave-loop adapter (wave_loop.py) ---------------------------------

    def _wl_remaining(self) -> int:
        return self._carry.level_end - self._carry.level_start

    def _wl_depth(self) -> int:
        return self._carry.depth

    def _wl_publish(self) -> None:
        c = self._carry
        with self._lock:
            self._state_count = c.state_count
            self._unique_count = c.unique_count
            self._max_depth = c.depth + (1 if self._wl_remaining() else 0)
            for p, prop in enumerate(self._properties):
                if c.disc[p] != NO_ID:
                    self._discovery_slots.setdefault(prop.name, c.disc[p])

    def _wl_can_wave(self) -> bool:
        c = self._carry
        if c.level_start >= c.level_end:
            return False
        target = self._options._target_max_depth
        # States at the target depth are counted but not expanded (the
        # reference skips jobs with depth >= target at pop time).
        if target and c.depth >= target - 1:
            return False
        return not self._fw_matched([d != NO_ID for d in c.disc])

    def _wl_occupancy(self) -> float:
        """The table's load as the host tracks it (no device read)."""
        return self._carry.unique_count / self._capacity

    def _wl_wave_extra(self) -> dict:
        return {"tail": self._carry.tail, **(self._trace_record or {})}

    def _wl_cand_lanes(self) -> int:
        """The density telemetry's denominator: the worst-case buffer U of
        a full chunk (the JAX engine's ``_wl_cand_lanes``)."""
        return self._wl_full_sort_lanes()

    def _wl_host_spans(self) -> List[tuple]:
        """The host spans measured inside the last wave (``(phase, t0,
        seconds)``: its readback, an engine's filter), drained."""
        spans, self._host_spans = self._host_spans, []
        return spans

    def _wl_trace_phases(self) -> Optional[Dict[str, float]]:
        """The last wave's phase seconds, when it was traced and
        committed; None otherwise."""
        return self._trace_phases

    def _wl_geometry(self) -> dict:
        """The ``geometry`` journal event's payload: the live knobs."""
        return {
            "engine": self.engine_name,
            "capacity": self._capacity,
            "log_capacity": self._log_capacity,
            "max_frontier": self._max_frontier,
            "dedup_factor": self._dedup_factor,
            "sortless": self._sortless,
            "sort_lanes": self._sort_width(),
            "step_lanes": self._step_width(),
            "u_lanes": self._wl_full_sort_lanes(),
            "waves_per_call": self._waves_per_call,
        }

    def _wl_write_checkpoint(self) -> dict:
        self._write_snapshot(self._checkpoint_path)
        return {"tail": self._carry.tail}

    # --- the fused quantum (FusedWaveLoop's adapter) ---------------------

    # Whether an untraced run goes through the fused quantum; the tiered
    # checker keeps the per-wave loop (its JAX counterpart drives one host
    # wave per call).
    _fused = True

    def _stats_from_carry(self) -> torch.Tensor:
        """The device stats tensor (``parallel/fused.py``) written from the
        host carry: after the seed, or a resume."""
        c = self._carry
        p = len(self._properties)
        words = [0] * stats_words(p)
        words[STAT_LEVEL_START:STAT_FLAGS] = [
            c.level_start, c.level_end, c.tail, c.state_count & M32,
            c.state_count >> 32, c.unique_count, c.depth,
        ]
        words[STAT_DISC : STAT_DISC + p] = c.disc
        words[ctl_index(p, CTL_EPOCH)] = c.table.epoch
        signed = [((x & M32) ^ 0x80000000) - 0x80000000 for x in words]
        return torch.tensor(signed, dtype=torch.int32).to(self._device)

    def _ctl_args(self) -> dict:
        """The constants K29's ``wave_ctl`` closes a wave with."""
        return dict(
            waves=self._waves_per_call, f_eff=self._step_width(),
            f_full=self._max_frontier, cap=self._capacity,
            qcap=self._log_capacity, size=self._sort_width(),
            target=self._options._target_max_depth or 0,
            fw_masks=self._fw_masks,
        )

    def _ctl_word(self, word: int) -> torch.Tensor:
        i = ctl_index(len(self._properties), word)
        return self._stats[i : i + 1]

    def _fused_rows(self) -> int:
        """The rows a quantum's wave expands: the chunk (the step rung) on
        the card, whose captured wave has one width; on the CPU the
        level's live lanes of it, since the twins' cost follows the rows
        they are given.  The lanes past the level are inactive, so both
        widths write the same logs (``tests/test_torch_fused.py`` runs
        the CPU at the card's width)."""
        f = self._step_width()
        if self._device.type == "cuda":
            return f
        ls, le = (int(x) & M32 for x in self._stats[:2].tolist())
        return max(1, min(le - ls, f))

    def _fused_wave(self) -> None:
        """One wave of a quantum, every scalar on the card: K29's
        ``wave_load``, the model's step and conds, K8's device entry, the
        compaction (K3), K1 (after K15 under symmetry; two-phase through
        its counted entry), the insert (K4's device-epoch entry, after K12
        and K3 on the sorted path), K3 on the new mask, K29's
        ``wave_ctl`` and K25's device entry -- no host read, so the card
        can replay it as a graph.  The JAX ``wave_body``."""
        c = self._carry
        cm = self._compiled
        w, a = cm.state_width, cm.max_actions
        p = len(self._properties)
        stats = self._stats
        f = self._fused_rows()
        size = self._sort_width()
        states, eb_in, active = wave_load(c.rows, c.ebits, stats, f, w)
        if self._two_phase:
            valid, eb, cands = wave_eval_dev(
                cm.property_conds(states), cm.step_valid(states), eb_in,
                stats, active, self._kinds,
            )
            v_orig, v_act, n_valid = compact_valid_indices(
                valid.view(-1), sort_lanes=size
            )
            cand_rows, lane_flags = cm.step_lane(states, v_orig, n_valid)
            step_flag = lane_flags.any()
            hi, lo = device_fp64_n(self._identity(cand_rows), n_valid)
        else:
            nexts, valid, conds, step_flag = cm.expand(states)
            valid, eb, cands = wave_eval_dev(
                conds, valid, eb_in, stats, active, self._kinds
            )
            cand_rows = nexts.view(f * a, w)
            hi, lo = device_fp64(self._identity(cand_rows))
            hi, lo, v_orig, v_act, n_valid = compact_valid(
                hi, lo, valid.view(-1), sort_lanes=size
            )
        epoch = self._ctl_word(CTL_EPOCH)
        if self._sortless:
            is_new, probe_ok = insert_batch_claim_dev(
                c.table, hi, lo, v_act, epoch
            )
            u_origin = dd_flag = None
        else:
            # The buffer's active lanes are compact_valid's prefix.
            is_new, u_origin, _u_act, probe_ok, dd_flag = insert_batch_compact(
                c.table, hi, lo, n_valid, dedup_factor=1, epoch=epoch
            )
        sel, n_new = compact(is_new, is_new.shape[0])
        wave_ctl(
            stats, p, begin=False, n_new=n_new, n_valid=n_valid,
            probe_ok=probe_ok, step_flag=step_flag, dd_flag=dd_flag,
            cands=cands, **self._ctl_args(),
        )
        i = ctl_index(p, CTL_WAVE_LO)
        append_block_dev(
            c.rows, c.parent, c.ebits, sel, u_origin, v_orig, cand_rows, eb,
            stats[i : i + 3], a, self._two_phase,
        )

    def _go(self) -> bool:
        """K29's go word, read on the host."""
        return bool(int(self._ctl_word(CTL_GO).item()))

    def _graph_key(self) -> tuple:
        """The captured quantum's key: the JAX program key's knobs
        (``wavefront.py:881-917``) and the buffers the graph holds."""
        c = self._carry
        return (
            self._capacity, self._log_capacity, self._max_frontier,
            self._dedup_factor, self._sortless, self._sort_width(),
            self._step_width(), self._waves_per_call,
            self._options._target_max_depth or 0, self._fw_masks,
            c.table.slots.data_ptr(), c.table.ctl.data_ptr(),
            c.rows.data_ptr(), c.parent.data_ptr(), c.ebits.data_ptr(),
            self._stats.data_ptr(),
        )

    def _key_provenance(self) -> dict:
        """The knobs behind a captured quantum, for its ``compile`` event."""
        return {
            "model": type(self._compiled).__name__,
            "capacity": self._capacity,
            "log_capacity": self._log_capacity,
            "max_frontier": self._max_frontier,
            "dedup_factor": self._dedup_factor,
            "sortless": self._sortless,
            "sort_lanes": self._sort_width(),
            "step_lanes": self._step_width(),
            "waves_per_call": self._waves_per_call,
            "symmetry": self._canon is not None,
        }

    def _wl_call(self) -> None:
        """Run one quantum: K29 opens it on the card, then up to
        ``waves_per_call`` waves run while its go word holds -- the
        captured graph's one launch on the card (captured on the first
        quantum of a geometry, after that quantum's first wave ran
        eagerly, which loads every kernel the capture records), a loop
        over the twins on the CPU."""
        c = self._carry
        if self._stats is None:
            self._stats = self._stats_from_carry()
        table = c.table
        if self._device.type == "cuda":
            if table.epoch + self._waves_per_call + 1 >= _EPOCH_MAX:
                table.tags.zero_()
                table.epoch = 0
        self._ctl_word(CTL_EPOCH).fill_(table.epoch)
        wave_ctl(self._stats, len(self._properties), begin=True,
                 **self._ctl_args())
        self._quantum_graph = None
        self._quantum_eager = 0
        if self._device.type != "cuda":
            while self._go():
                self._fused_wave()
            return
        key = self._graph_key()
        if self._graph_at != key:
            self._drop_graph()
            # A capture syncs the card anyway; a quantum that cannot start
            # captures nothing.
            if not self._go():
                return
            self._fused_wave()
            self._quantum_eager = 1
            t0 = time.monotonic()
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            self._graph = WhileGraph(self._fused_wave, self._ctl_word(CTL_GO),
                                     pool=self._graph_pool)
            self._graph_at = key
            sec = time.monotonic() - t0
            self._capture_sec.append(sec)
            if self._journal:
                self._journal.append(
                    "compile", label=f"{type(self).__name__}.fused",
                    sec=round(sec, 4), cache_size=1,
                    provenance=self._key_provenance(),
                )
        self._graph.launch()
        self._quantum_graph = self._graph

    def _drop_graph(self) -> None:
        """Close the captured quantum (its key no longer holds)."""
        if self._graph is not None:
            self._graph.close()
        self._graph = self._graph_at = None

    def _wl_view(self) -> WaveView:
        """The quantum's one readback (the stats and K29's words in one
        copy), decoded; the host carry is refreshed from it."""
        p = len(self._properties)
        words = [int(x) & M32 for x in self._stats.tolist()]
        self._readbacks += 1
        ran = words[ctl_index(p, CTL_WAVES_RUN)]
        self._waves_run += ran
        if self._quantum_graph is not None:
            self._quantum_graph.count_waves(ran - self._quantum_eager)
            self._quantum_graph = None
        c = self._carry
        c.level_start, c.level_end, c.tail = (
            words[STAT_LEVEL_START], words[STAT_LEVEL_END], words[STAT_TAIL]
        )
        c.state_count = (words[STAT_SC_HI] << 32) | words[STAT_SC_LO]
        c.unique_count = words[STAT_UNIQUE]
        c.depth = words[STAT_DEPTH]
        c.disc = words[STAT_DISC : STAT_DISC + p]
        c.table.epoch = words[ctl_index(p, CTL_EPOCH)]
        return WaveView(
            waves_this_call=self._waves_per_call,
            remaining=c.level_end - c.level_start,
            depth=c.depth,
            flags=words[STAT_FLAGS],
            unique=c.unique_count,
            states=c.state_count,
            occupancy=c.unique_count / self._capacity,
            discoveries=tuple(
                (prop.name, c.disc[i])
                for i, prop in enumerate(self._properties)
                if c.disc[i] != NO_ID
            ),
            extra={"tail": c.tail},
        )

    # The phase an engine's _wave_filter is timed as in a traced wave (the
    # tiered engine's cold merge-join); the in-HBM engine has no filter.
    _filter_phase: Optional[str] = None

    def _wl_wave(self) -> int:
        """Expand one chunk of the current level, in phases: expand,
        fingerprint, insert and compact, the one readback, then (an engine
        may filter the new lanes here) the commit.  Returns the overflow
        flags; the carry changes only when they are 0.  A traced wave
        marks each phase's end on its :class:`PhaseClock` and, once
        committed, records its phase seconds and modeled bytes."""
        clock = PhaseClock(self._device) if self._tracer is not None else NO_CLOCK
        c = self._carry
        count = min(c.level_end - c.level_start, self._step_width())
        # The compaction buffer: the rung, or the worst case U of a FULL
        # chunk -- sized from max_frontier, as the JAX engine's padded
        # chunk is, so flag 4 fires where it fires there.
        wave = Wave(count=count, lo_pos=c.level_start, size=self._sort_width())
        self._trace_phases = self._trace_record = None
        self._wave_expand(wave)
        clock.mark("step")
        self._wave_fingerprint(wave)
        clock.mark("canon")
        self._wave_insert(wave)
        clock.mark("dedup")
        t_rb = time.monotonic()
        self._wave_readback(wave)
        flags = self._wave_flags(wave)
        if not flags and self._visitor is not None:
            self._visit(wave)
        self._host_spans.append(("readback", t_rb, time.monotonic() - t_rb))
        clock.mark("readback")
        if not flags:
            self._wave_filter(wave)
            if self._filter_phase is not None:
                clock.mark(self._filter_phase)
            if self._log_full(wave):
                flags = 2
        if flags:
            # Nothing commits.  The table may hold this wave's keys; growth
            # rebuilds it from the committed log, which erases them.
            return flags
        self._wave_commit(wave)
        clock.mark("append")
        if self._tracer is not None:
            self._trace_phases = clock.phases
            self._trace_record = self._tracer.record_wave(
                clock.phases, self._traced_wave_bytes(wave),
                probe_rounds=wave.probe_rounds, probe_slots=wave.probe_slots,
            )
        return 0

    def _visit(self, wave: Wave) -> None:
        """The visitor stream of a wave that commits: each expanded state,
        in log order, as a single-state path (the JAX engine's traced
        readback of the chunk)."""
        w = self._compiled.state_width
        lo = wave.lo_pos
        rows = to_numpy_u32(self._carry.rows[lo * w : (lo + wave.count) * w])
        for row in rows.reshape(wave.count, w):
            self._visitor.visit(
                self._model, Path([(self._compiled.decode(row), None)])
            )

    def _wave_expand(self, wave: Wave) -> None:
        """The model's step and the wave verdicts (K8).  The JAX version
        folds the discovery candidates into the discovery vector on device;
        here they come back per property and are folded first-writer-wins
        once the wave commits."""
        c = self._carry
        cm = self._compiled
        w, a = cm.state_width, cm.max_actions
        lo_pos, count = wave.lo_pos, wave.count
        states = c.rows[lo_pos * w : (lo_pos + count) * w].view(count, w)
        discovered = sum(1 << p for p, d in enumerate(c.disc) if d != NO_ID)
        eb_in = c.ebits[lo_pos : lo_pos + count]
        if self._two_phase:
            # Screen lane validity, compact the valid lanes, then build
            # successors only for them (K7, about 5% of the lanes for
            # paxos), to be fingerprinted instead of all F * A candidates.
            valid, wave.eb, wave.cands = wave_eval(
                cm.property_conds(states), cm.step_valid(states), eb_in,
                lo_pos, self._kinds, discovered,
            )
            wave.v_orig, wave.v_act, wave.n_valid = compact_valid_indices(
                valid.view(-1), sort_lanes=wave.size
            )
            wave.cand_rows, lane_flags = cm.step_lane(
                states, wave.v_orig, wave.n_valid
            )
            wave.step_flag = lane_flags.any()
        else:
            # The model's step applies its boundary to the lanes' validity
            # (compiled.py), before K8 counts them and tests for terminal
            # states.
            nexts, valid, conds, wave.step_flag = cm.expand(states)
            valid, wave.eb, wave.cands = wave_eval(
                conds, valid, eb_in, lo_pos, self._kinds, discovered,
            )
            wave.cand_rows = nexts.view(count * a, w)
            wave.valid = valid.view(-1)  # compacted with the keys
        if wave.step_flag is None:
            wave.step_flag = torch.zeros((), dtype=torch.bool, device=self._device)

    def _wave_fingerprint(self, wave: Wave) -> None:
        """K1 (after K15 under symmetry) on the candidates; single-phase
        waves then compact the valid lanes' keys into the buffer."""
        hi, lo = device_fp64(self._identity(wave.cand_rows))
        if self._two_phase:
            wave.hi, wave.lo = hi, lo
        else:
            wave.hi, wave.lo, wave.v_orig, wave.v_act, wave.n_valid = (
                compact_valid(hi, lo, wave.valid, sort_lanes=wave.size)
            )

    def _wave_insert(self, wave: Wave) -> None:
        """Insert the buffer's keys into the table and compact the new
        lanes (K3)."""
        c = self._carry
        # A traced wave asks K4 for its probe figures (the byte model's).
        rounds = self._tracer is not None
        if self._sortless:
            # The claim election: buffer lane j is its own representative
            # (u_origin is the identity), new states append in lane order.
            wave.is_new, wave.probe_ok, *probe = insert_batch_claim(
                c.table, wave.hi, wave.lo, wave.v_act, with_rounds=rounds
            )
            wave.dd_overflow = torch.zeros((), dtype=torch.bool,
                                           device=self._device)
        else:
            # The sorted fallback: one representative per key in sorted-key
            # order over the whole buffer, so new states append in that
            # order (JAX wave_body at dedup_factor=1).
            (wave.is_new, wave.u_origin, _u_act, wave.probe_ok,
             wave.dd_overflow, *probe) = insert_batch_compact(
                c.table, wave.hi, wave.lo, wave.n_valid, dedup_factor=1,
                with_rounds=rounds,
            )
        wave.probe = probe[0] if probe else None
        wave.sel, wave.n_new_d = compact(wave.is_new, wave.is_new.shape[0])

    def _wave_extra_stats(self, wave: Wave) -> List[torch.Tensor]:
        """Device values an engine folds into the wave's one readback
        (1-D int64 tensors); they land in ``wave.extra``."""
        return []

    def _wave_readback(self, wave: Wave) -> None:
        """The wave's one readback (with K4's probe figures on a traced
        wave)."""
        probe = [] if wave.probe is None else [wave.probe]
        extra = self._wave_extra_stats(wave)
        stats = torch.cat([
            torch.stack([
                wave.n_new_d, wave.n_valid, wave.probe_ok.long(),
                wave.step_flag.long(), wave.dd_overflow.long(),
            ]),
            *probe,
            *extra,
            wave.cands,
        ]).tolist()
        (wave.n_new, wave.generated, wave.ok, wave.s_flag,
         wave.dd_flag) = (int(x) for x in stats[:5])
        wave.n_inserted = wave.n_new
        at = 5
        if probe:
            wave.probe_rounds, wave.probe_slots = (int(x) for x in stats[5:7])
            at = 7
        n_extra = at + sum(t.numel() for t in extra)
        wave.extra = tuple(int(x) for x in stats[at:n_extra])
        wave.cand_ids = tuple(int(x) for x in stats[n_extra:])

    # An engine whose _wave_filter drops new lanes tests the row log after
    # the filter only, against the lanes it kept (the JAX tiered engine's
    # order); the in-HBM engine tests it with the other flags, as JAX's.
    _filters_new_lanes = False

    def _table_entries(self) -> int:
        """The keys the table holds, against which flag 1 tests a wave."""
        return self._carry.unique_count

    def _log_full(self, wave: Wave) -> bool:
        return self._carry.tail + wave.n_new > self._log_capacity

    def _wave_flags(self, wave: Wave) -> int:
        """The overflow flags of the read-back wave."""
        flags = 0
        if not wave.ok or (self._table_entries() + wave.n_new) * 2 > self._capacity:
            flags |= 1
        if not self._filters_new_lanes and self._log_full(wave):
            flags |= 2
        if wave.generated > wave.size or wave.dd_flag:
            flags |= 4
        if wave.s_flag:
            flags |= 8
        f_eff = self._step_width()
        if f_eff < self._max_frontier and self._wl_remaining() > f_eff:
            flags |= 128
        return flags

    def _wave_filter(self, wave: Wave) -> None:
        """A stage between the readback and the append of an unflagged
        wave, which may drop new lanes (``wave.sel``, ``wave.n_new``); the
        in-HBM engine has none."""

    def _wave_commit(self, wave: Wave) -> None:
        """Append the new representatives' rows, parents and ebits at the
        tail (K25, one launch) and advance the scalars."""
        c = self._carry
        n_new = wave.n_new
        # The representatives' buffer lanes go through u_origin on the
        # sorted path; two-phase rows are already compacted (buffer lane j
        # holds original lane v_orig[j]'s successor).
        append_block(
            c.rows, c.parent, c.ebits, wave.sel, wave.u_origin, wave.v_orig,
            wave.cand_rows, wave.eb, wave.lo_pos, c.tail, n_new,
            self._compiled.max_actions, self._two_phase,
        )
        c.tail += n_new
        c.unique_count += n_new
        c.state_count += wave.generated
        for p, cand in enumerate(wave.cand_ids):
            if c.disc[p] == NO_ID and cand != NO_ID:
                c.disc[p] = cand
        c.level_start += wave.count
        if c.level_start >= c.level_end:
            c.depth += 1
            c.level_end = c.tail

    def _traced_wave_bytes(self, wave: Wave) -> Dict[str, int]:
        """The committed wave's modeled bytes per phase (:func:`wave_bytes`
        documents the model and where it differs from the JAX engine's)."""
        cm = self._compiled
        return wave_bytes(
            count=wave.count, a=cm.max_actions, w=cm.state_width,
            fpw=self._fp_words, n_props=len(self._properties),
            u=wave.v_orig.shape[0], n_valid=wave.generated,
            n_inserted=wave.n_inserted, n_new=wave.n_new,
            probe_slots=wave.probe_slots, two_phase=self._two_phase,
            sortless=self._sortless, symmetric=self._canon is not None,
        )

    def _wl_overflow_message(self, flags: int) -> str:
        if flags & 8:
            return (
                "the model step kernel flagged an encoding-capacity "
                "overflow (a successor exceeded the packed layout's "
                "bounds); the compiled model's capacity assumptions "
                "do not hold for this configuration"
            )
        return f"wavefront engine overflow flags={flags}"

    def _wl_abort_cleanup(self) -> None:
        """Erase a flagged wave's table writes before a stop or deadline
        keeps the partial result: growth's rebuild without the growth."""
        self._reset_table(0)

    def _reset_table(self, flags: int) -> None:
        """Rebuild the table from the committed log prefix after a flagged
        wave (``flags``), erasing the keys its aborted insert wrote."""
        c = self._carry
        c.table = self._rehash(c.rows, c.tail)

    def _wl_retryable_flags(self) -> int:
        """1, 2 and 4 grow in place and 128 climbs the step rung; 8 (the
        encoding overflow) never retries."""
        return 1 | 2 | 4 | 128

    def _wl_grow(self, flags: int) -> None:
        """Grow the tripped buffers in place, then reset the table."""
        self._drop_graph()  # it holds the buffers that move
        qcap = self._log_capacity
        note = "; ".join(self._grow_knobs(flags, qcap))
        self._grow_flags.append(flags)
        self._grow_notes.append(note)
        c = self._carry
        log_grow(self, flags, note, c.unique_count, c.depth)
        self._resize_logs(qcap)
        self._reset_table(flags)

    def _grow_refused(self, flags: int, bit: int) -> str:
        """The error of a flagged wave whose knob ``bit`` cannot grow."""
        return {
            1: f"fingerprint table overfull (capacity {self._capacity}); "
               "raise spawn_gpu(capacity=...)",
            2: f"the state row log is full (log_capacity "
               f"{self._log_capacity}); raise spawn_gpu(log_capacity=...)",
            4: "a wave generated more valid successor candidates than the "
               "compaction buffer holds; lower spawn_gpu(dedup_factor=...) "
               f"(now {self._dedup_factor}; 1 with no sort_lanes is always "
               "safe)",
            128: "the step-rung ladder clamped a wave at the full chunk "
                 "width -- impossible by construction (the clamp flag "
                 "cannot fire at the top rung); please report",
        }[bit]

    def _grow_knobs(self, flags: int, qcap: int) -> List[str]:
        """Grow the knob of each tripped flag (1, 2, 4, 128, in that
        order); returns the notes, or raises where a knob cannot grow."""
        grown = []
        for bit in (1, 2, 4, 128):
            if not flags & bit:
                continue
            if bit == 2 and self._log_capacity > qcap:
                continue  # the table's growth already dragged the log
            note = self._grow_knob(bit) if self._auto_tune else None
            if note is None:
                raise RuntimeError(self._grow_refused(flags, bit))
            grown.append(note)
        return grown

    def _resize_logs(self, qcap: int) -> None:
        """Resize the row, parent and ebits logs from ``qcap`` positions to
        the live ``log_capacity``."""
        if self._log_capacity == qcap:
            return
        c = self._carry
        w = self._compiled.state_width
        c.rows = _sized(c.rows, self._log_capacity * w, 0)
        c.parent = _sized(c.parent, self._log_capacity, -1)
        c.ebits = _sized(c.ebits, self._log_capacity, 0)

    def _grow_knob(self, flag: int) -> Optional[str]:
        """Adjust the knob named by ``flag``; None if it cannot grow."""
        row_bytes = 4 * self._compiled.state_width + 8
        log_bound = max(self._log_capacity, _ROW_LOG_BYTE_BUDGET // row_bytes)
        if flag == 1:
            if self._capacity >= _MAX_TABLE_CAPACITY:
                return None
            self._capacity = min(self._capacity * 16, _MAX_TABLE_CAPACITY)
            if not self._log_capacity_explicit:
                self._log_capacity = min(
                    max(
                        self._log_capacity,
                        min(self._capacity // 2, self._log_capacity * 2),
                    ),
                    log_bound,
                )
            return f"capacity={self._capacity}"
        if flag == 2:
            if self._log_capacity >= log_bound:
                return None
            self._log_capacity = min(self._log_capacity * 2, log_bound)
            return f"log_capacity={self._log_capacity}"
        if flag == 128:
            # The step rung: the level outgrew the chunk rung; climb one
            # rung toward max_frontier (the climbed rung is the floor the
            # frontier tuner never revisits).
            return climb_step_rung(self, self._max_frontier)
        # Flag 4, in the JAX engine's order (wavefront.py:1096-1171).
        # An explicit claim budget (sortless with a pinned rung) falls back
        # to the sorted path rather than climbing.
        if self._sortless and not self._sort_tune:
            return fall_back_to_sort(self)
        # A rung below the full buffer climbs, on either path.
        full = self._wl_full_sort_lanes()
        note = climb_sort_rung(self, full)
        if note is not None:
            return note
        # The claim path at the full buffer falls back to the sorted path.
        if self._sortless:
            return fall_back_to_sort(self)
        # The sorted path relaxes to dedup_factor=1, halving the chunk
        # while the buffer exceeds the band.
        a = self._compiled.max_actions
        relaxed = relax_dedup_geometry(
            self._max_frontier, self._dedup_factor,
            lambda f, dd: unique_buffer_size(f * a, dd),
            max_safe_unique_lanes(self._compiled.state_width),
            chunk_label="max_frontier",
        )
        if relaxed is None:
            return None
        self._dedup_factor, self._max_frontier, note = relaxed
        reset_sort_rung_to_full(self, full)
        return note

    def _identity_fingerprints(self, rows: torch.Tensor, start: int, end: int):
        """K1 (after K15 under symmetry) on log positions ``[start, end)``
        in blocks of ``_REHASH_ROWS``: yields each block's ``(hi, lo)``."""
        w = self._compiled.state_width
        for pos in range(start, end, _REHASH_ROWS):
            n = min(_REHASH_ROWS, end - pos)
            block = rows[pos * w : (pos + n) * w].view(n, w)
            yield device_fp64(self._identity(block))

    def _rehash(self, rows: torch.Tensor, tail: int, start: int = 0) -> HashSet:
        """A fresh table of the current capacity holding the fingerprints
        of log positions ``[start, tail)`` (K1 + K4, every position a
        distinct state): the whole committed prefix after growth, the
        segment since the last spill for the tiered engine."""
        table = HashSet.empty(self._capacity, self._device)
        oks = []
        for hi, lo in self._identity_fingerprints(rows, start, tail):
            active = torch.ones(hi.shape, dtype=torch.bool, device=self._device)
            oks.append(insert_batch_claim(table, hi, lo, active)[1])
        if oks and not bool(torch.stack(oks).all()):
            raise RuntimeError(
                "rehash after auto-tune growth could not place every "
                "committed state; the grown table is still overfull"
            )
        return table

    # --- results -----------------------------------------------------------

    def _snapshot_key(self) -> str:
        return snapshot_engine_key(
            self._compiled, self._properties, self._canon is not None
        )

    def _snapshot_extra(self) -> dict:
        """Extra npz fields a subclass persists beside the carry."""
        return {}

    def _write_snapshot(self, path: str) -> None:
        """Persist the run state atomically (write, then rename)."""
        arrays = snapshot_arrays(self._carry, self._capacity, self._log_capacity)
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as fh:
            np.savez_compressed(
                fh, engine_key=self._snapshot_key(),
                **self._snapshot_extra(), **arrays,
            )
        os.replace(tmp, path)

    def save_snapshot(self, path: str) -> None:
        """Persist the full run state in the JAX engine's npz format, so
        either engine can resume it (``resume_from``)."""
        self.join()
        self._write_snapshot(path)

    def discovered_fingerprints(self) -> np.ndarray:
        """Sorted uint64 fingerprints of every discovered unique state:
        of its canonical row under symmetry (the logged original is
        whichever member of its orbit the traversal reached first)."""
        self.join()
        c = self._carry
        w = self._compiled.state_width
        rows = c.rows[: c.tail * w].view(c.tail, w)
        return fingerprints_of_rows(self._identity(rows))

    def state_count(self) -> int:
        return self._state_count

    def unique_state_count(self) -> int:
        return self._unique_count

    def max_depth(self) -> int:
        return self._max_depth

    def metrics(self) -> dict:
        """Observability snapshot, the JAX engine's keys where the port has
        a counterpart (``engine`` is ``"gpu-wavefront"``).  Safe mid-run:
        it reads the registry the host loop writes from scalars it already
        read back; a finished checker's first call reads the table's true
        load factor once and caches it."""
        out = super().metrics()
        out.update(
            engine=self.engine_name,
            device=str(self._device),
            trace=self._trace,
            capacity=self._capacity,
            log_capacity=self._log_capacity,
            max_frontier=self._max_frontier,
            dedup_factor=self._dedup_factor,
            sortless=self._sortless,
            sort_lanes=self._sort_width(),
            # The pinned rungs (0 = the full buffer, the tuner armed).
            sort_lanes_rung=self._sort_lanes or 0,
            step_lanes=self._step_width(),
            step_lanes_rung=self._step_lanes or 0,
            waves_per_call=self._waves_per_call,
        )
        snap = self._metrics.snapshot()
        out["table_load_factor"] = snap.get("table_occupancy", 0.0)
        if self._done.is_set() and self._carry is not None and not self._errors:
            if self._final_load_factor is None:
                self._final_load_factor = round(
                    self._carry.table.load_factor(), 6
                )
            out["table_load_factor"] = self._final_load_factor
        out.update(snap)
        # The vitals' histograms, one nested key as in the JAX engine.
        hists = self._metrics.snapshot_histograms()
        if hists:
            out["histograms"] = hists
        if self._tracer is not None:
            out["trace_summary"] = self._tracer.summary()
        return out

    def trace_summary(self) -> dict:
        """The finished traced run's roofline reduction: per-phase seconds
        (``wave_breakdown``), modeled bytes, ``hbm_util_frac`` against the
        card's peak and ``bottleneck_phase``.  Requires ``trace=True``."""
        self.join()
        if self._tracer is None:
            raise RuntimeError(
                f"trace_summary() requires {self.spawn_name[:-2]}(trace=True)"
            )
        return self._tracer.summary()

    def tuned_kwargs(self) -> dict:
        """Spawn kwargs right-sized to this run's final counts, so a fresh
        spawn of the same workload runs without growth: the table at least
        twice the unique count, the log the count plus slack, the chunk,
        dedup factor and dedup path the run ended with, the sort rung when
        one was pinned on the sorted path, and the step rung when one was
        pinned (the JAX engine's)."""
        self.join()
        u = max(1, self._unique_count)
        return dict(
            capacity=1 << max(10, (2 * u).bit_length()),
            log_capacity=u + max(64, u // 64),
            max_frontier=self._max_frontier,
            dedup_factor=self._dedup_factor,
            sortless=int(self._sortless),
            **(
                {"sort_lanes": self._sort_width()}
                if self._sort_lanes is not None and not self._sortless
                else {}
            ),
            **(
                {"step_lanes": self._step_width()}
                if self._step_lanes is not None else {}
            ),
        )

    def table_load_factor(self) -> float:
        """Occupied fraction of the finished run's fingerprint table."""
        self.join()
        return self._carry.table.load_factor()

    def waves(self) -> int:
        """Waves the finished run counted, as the JAX engine counts them
        (re-runs after growth included; ``waves_per_call`` a quantum of
        the fused loop)."""
        self.join()
        return self._waves

    def _slot_path(self, slot: int) -> Path:
        """Walk the parent chain from ``slot`` (one scalar read per step),
        gather its rows and re-execute the host model along them."""
        c = self._carry
        w = self._compiled.state_width
        chain = []
        s = slot
        while s != NO_ID:
            if len(chain) > c.tail:
                raise RuntimeError("parent chain does not end at an init state")
            chain.append(s)
            s = int(c.parent[s]) & M32
        chain.reverse()
        idx = torch.tensor(chain, dtype=torch.int64, device=self._device)
        rows = to_numpy_u32(c.rows.view(-1, w)[idx])
        fps = [
            self._model.fingerprint(self._compiled.decode(r)) for r in rows
        ]
        return Path.from_fingerprints(self._model, fps)

    def discoveries(self) -> Dict[str, Path]:
        self.join()
        if self._discoveries_cache is None:
            with self._lock:
                items = list(self._discovery_slots.items())
            self._discoveries_cache = {
                name: self._slot_path(slot) for name, slot in items
            }
        return dict(self._discoveries_cache)

    def handles(self) -> List[threading.Thread]:
        return [self._thread]

    def is_done(self) -> bool:
        return self._done.is_set()

    def join(self) -> "GpuChecker":
        self._thread.join()
        if self._errors:
            raise self._errors[0]
        return self
