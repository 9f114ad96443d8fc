"""Device-resident fingerprint hash set with batched insert-if-absent (K4).

The counterpart of ``stateright_tpu/parallel/hashset.py``: an
open-addressing table keyed by the 64-bit packed-state fingerprint, linear
probing from :func:`home_slot`, whole waves of candidate keys inserted at
once.  Empty slots are 0; fingerprints are never 0 (``ops/device_fp.py``).

Layout: one 16-byte slot per table entry, ``{key, tag}`` as an
``int64[capacity, 2]`` tensor (:attr:`HashSet.slots`).  The key word holds
the key's bits ``hi:lo`` -- :attr:`HashSet.keys` is that column, the JAX
package's ``key_hi``/``key_lo`` planes interleaved slot for slot, so a
table converts either way without a rebuild (:meth:`HashSet.from_planes`,
:meth:`HashSet.planes`): both engines probe from the same home slot, and
linear probing places a key anywhere along its probe run, whatever the
insertion order.  The tag word (:attr:`HashSet.tags`) carries the K4
kernel's per-call election tag (``csrc/hashset.cu``) in the key's own
sector; the twin never reads it.  Two int32 control words (``ctl``,
zero between calls) carry K4's fail flag and done count.

The insert is IN PLACE: :func:`insert_batch_claim` mutates the table it is
given (the JAX version returns a new one), so a wave holds one table, not
two.  Both dedup paths are ported: the sortless claim path (K4 alone), and
the sorted fallback -- :func:`prededup` (the K12 sort, ``csrc/prededup.cu``,
then K3; :func:`prededup_prefix` where the active lanes are a prefix)
electing one representative per key in sorted-key order, then K4 on the
representatives (:func:`insert_batch_compact`, :func:`insert_batch`).
The representatives are distinct keys, so which of two keys contending for
one empty slot wins it may differ from the JAX ``set`` scatter: on the
sorted path the two engines' tables hold the same key set, and every
result the engine reads (new, origin, counts) is the same.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops import cuda
from ..ops.device_fp import fp64_of
from ..ops.u32 import fmix32, i32, rotl, u32
from .wave_common import compact, compact_plain

_EPOCH_MAX = 0xFFFFFFFF
_I64_MAX = (1 << 63) - 1
_SIGN = -(1 << 63)  # XOR with it turns the signed int64 order unsigned


class HashSet:
    """The table's slots (key and election tag, 16 bytes a slot) and K4's
    control words; capacity is a power of two."""

    def __init__(self, keys: torch.Tensor):
        """A table holding ``keys`` (int64[capacity]: hi:lo, 0 = empty)."""
        self._adopt(torch.stack([keys, torch.zeros_like(keys)], 1))

    def _adopt(self, slots: torch.Tensor) -> None:
        cap = slots.shape[0]
        if cap & (cap - 1) or not 1 <= cap <= 1 << 31:
            raise ValueError("capacity must be a power of two <= 2**31")
        self.slots = slots  # int64[capacity, 2]: {key, tag}
        self.ctl = torch.zeros((2,), dtype=torch.int32, device=slots.device)
        self.epoch = 0  # the last insert call's election tag

    @classmethod
    def empty(cls, capacity: int, device) -> "HashSet":
        table = cls.__new__(cls)
        table._adopt(torch.zeros((capacity, 2), dtype=torch.int64, device=device))
        return table

    @classmethod
    def from_planes(cls, key_hi: np.ndarray, key_lo: np.ndarray, device) -> "HashSet":
        """Adopt the JAX package's two u32 planes (a snapshot's table)."""
        hi = torch.from_numpy(np.asarray(key_hi, np.uint32).view(np.int32).copy())
        lo = torch.from_numpy(np.asarray(key_lo, np.uint32).view(np.int32).copy())
        return cls(fp64_of(hi, lo).to(device))

    def planes(self) -> Tuple[np.ndarray, np.ndarray]:
        """The table as the JAX package's ``(key_hi, key_lo)`` u32 planes."""
        keys = self.keys.to("cpu")
        hi = i32(keys >> 32).numpy().view(np.uint32)
        lo = i32(keys).numpy().view(np.uint32)
        return hi, lo

    @property
    def keys(self) -> torch.Tensor:
        """The key words, int64[capacity] (hi:lo, 0 = empty): a view of the
        slots, so writing it writes the table."""
        return self.slots[:, 0]

    @property
    def tags(self) -> torch.Tensor:
        """K4's election tags, int64[capacity] (a view of the slots)."""
        return self.slots[:, 1]

    @property
    def capacity(self) -> int:
        return self.slots.shape[0]

    def load_factor(self) -> float:
        """Occupied-slot fraction, read from the key words."""
        return int((self.keys != 0).sum()) / self.capacity


def home_slot(hi: torch.Tensor, lo: torch.Tensor, capacity: int) -> torch.Tensor:
    """Initial probe slot of each key (int64), bit-identical to the JAX
    ``home_slot``: a second mix of the fingerprint, so table position is
    not correlated with the key planes."""
    return fmix32(u32(hi) ^ rotl(u32(lo), 16) ^ 0x7FEB352D) & (capacity - 1)


def unique_buffer_size(b: int, dedup_factor: int) -> int:
    """The compaction buffer width for a B-lane candidate batch:
    ``max(min(B, 16K), B/dedup_factor)``, as in the JAX package."""
    return max(min(b, 1 << 14), b // dedup_factor)


def _effective_buffer(b: int, dedup_factor: int, sort_lanes) -> int:
    """The working compaction width: the ``sort_lanes`` rung when given
    (clamped to the batch), else the worst case
    :func:`unique_buffer_size` -- as in the JAX package."""
    if sort_lanes is not None:
        return max(1, min(int(sort_lanes), b))
    return unique_buffer_size(b, dedup_factor)


def compact_valid_indices(valid: torch.Tensor, dedup_factor: int = 4,
                          sort_lanes=None):
    """Index half of :func:`compact_valid`: compact the valid LANE INDICES
    only -- two-phase expansion builds successor rows after compaction, so
    there are no keys to compact yet.  The buffer is
    ``_effective_buffer(B, dedup_factor, sort_lanes)`` lanes wide.
    Returns ``(v_orig, v_act, n_valid)``: ``v_orig`` int32 maps buffer
    lanes back to original ones (K3), ``v_act`` marks the filled buffer
    lanes, and ``n_valid`` is the int64 device count of valid lanes, in
    place of the JAX version's ``overflow`` flag, which is ``n_valid >
    size`` (exactly full at ``size``, tripped at ``size + 1``).  The engine
    sizes its buffer from ``max_frontier`` and passes it as ``sort_lanes``
    (a chunk may be shorter than ``max_frontier``)."""
    size = _effective_buffer(valid.shape[0], dedup_factor, sort_lanes)
    v_orig, n_valid = compact(valid, size)
    # Filled lanes hold strictly increasing lane indices and the rest 0, so
    # every lane but the first is active iff its index is nonzero -- no
    # buffer-sized arange.
    v_act = v_orig != 0
    v_act[0] = n_valid > 0
    return v_orig, v_act, n_valid


def compact_valid(hi, lo, valid, dedup_factor: int = 4, sort_lanes=None):
    """Compact a sparse-valid key batch into the buffer of
    :func:`compact_valid_indices`.

    Returns ``(v_hi, v_lo, v_orig, v_act, n_valid)``: the JAX
    ``compact_valid``'s buffers (inactive buffer lanes hold lane 0's key,
    which ``v_act`` masks), and in place of its ``overflow`` flag the
    valid-lane count it is taken from -- the criterion of
    :func:`compact_valid_indices`."""
    v_orig, v_act, n_valid = compact_valid_indices(valid, dedup_factor, sort_lanes)
    return (
        torch.index_select(hi, 0, v_orig), torch.index_select(lo, 0, v_orig),
        v_orig, v_act, n_valid,
    )


def prededup(hi, lo, active, dedup_factor: int = 4, sort_lanes=None):
    """Elect one representative per distinct key and compact them, in
    sorted-key order, into a ``_effective_buffer(B, dedup_factor,
    sort_lanes)``-lane buffer -- the JAX ``prededup``.

    ``hi``/``lo``: int32[B] key halves; ``active``: bool[B].  Returns
    ``(u_hi, u_lo, u_origin, u_active, overflow)``: the representatives'
    keys and original lanes (int32; 0 past the representatives),
    ``u_active`` marking the filled lanes, and ``overflow`` (a bool
    scalar tensor) when the DISTINCT-REPRESENTATIVE count exceeds the
    buffer -- exactly full at ``u``, tripped at ``u + 1``.  Keys order as
    unsigned 64-bit ``hi:lo``; the representative of a key is its lowest
    active lane; an inactive lane, and any all-ones key, is no
    representative.  On the card the sort is K12's mask entry
    (``csrc/prededup.cu``) and the compaction K3."""
    if hi.device.type == "cpu":
        return prededup_plain(hi, lo, active, dedup_factor, sort_lanes)
    u = _effective_buffer(hi.shape[0], dedup_factor, sort_lanes)
    return _compacted(_sorted_runs(hi, lo, active), u, compact)


prededup.launches = 0


def prededup_prefix(hi, lo, count, dedup_factor: int = 4, sort_lanes=None):
    """:func:`prededup` where the active lanes are the first ``count``
    (an int64 scalar tensor on the batch's device, read on the card and
    clamped to ``[0, B]``): the sorted path's case, whose mask is
    ``compact_valid``'s prefix of ``n_valid`` lanes.  The answer is
    :func:`prededup`'s over the mask ``arange(B) < count``; on the card
    K12's prefix entry sorts only those lanes, whatever ``B`` is, with no
    host read, so a captured graph replays it at every count."""
    n = hi.shape[0]
    if hi.device.type == "cpu":
        mask = torch.arange(n, device=hi.device) < count
        return prededup_plain(hi, lo, mask, dedup_factor, sort_lanes)
    u = _effective_buffer(n, dedup_factor, sort_lanes)
    return _compacted(_sorted_runs_prefix(hi, lo, count), u, compact)


prededup_prefix.launches = 0


def prededup_plain(hi, lo, active, dedup_factor: int = 4, sort_lanes=None):
    """Plain-torch twin of :func:`prededup`'s K12 + K3 (any device)."""
    u = _effective_buffer(hi.shape[0], dedup_factor, sort_lanes)
    return _compacted(_sorted_runs_plain(hi, lo, active), u, compact_plain)


def _compacted(runs, u: int, compactor):
    """The representatives of sorted ``runs`` compacted to ``u`` lanes.
    Only representatives' lanes of ``runs`` are read unmasked (K3 pads
    its indices with lane 0, whose reads ``u_active`` masks), so the
    prefix entry's unwritten tail never reaches the answer."""
    skey, slane, rep = runs
    idx, n_rep = compactor(rep, u)
    u_active = torch.arange(u, device=rep.device) < n_rep
    idx = idx.long()
    key = torch.where(u_active, skey[idx], 0)
    u_origin = torch.where(u_active, slane[idx], 0)
    return i32(key >> 32), i32(key), u_origin, u_active, n_rep > u


def _sorted_runs(hi, lo, active):
    """K12's mask entry: the stable unsigned sort of the batch's keys
    (inactive lanes as the all-ones key), returning ``(keys int64, lanes
    int32, rep bool)`` in sorted order, ``rep`` marking the first lane of
    each active key's run."""
    cuda.require(active, "active", torch.bool, 1, hi.device)
    if active.shape[0] != hi.shape[0]:
        raise ValueError("hi, lo and active differ in length")
    prededup.launches += 1
    return _radix_sort(hi, lo, active, None, "prededup")


def _sorted_runs_prefix(hi, lo, count):
    """K12's prefix entry: :func:`_sorted_runs` of the first ``count``
    lanes (a device int64 scalar, clamped to ``[0, B]``); keys and lanes
    past it are unwritten and ``rep`` is False there."""
    cuda.require(count.reshape(()), "count", torch.int64, 0, hi.device)
    prededup_prefix.launches += 1
    return _radix_sort(hi, lo, None, count, "prededup_prefix")


def _radix_sort(hi, lo, active, count, what: str):
    """One K12 launch sequence over ``hi``/``lo`` with the mask
    ``active`` or the device count ``count`` (the other None)."""
    dev = hi.device
    n = hi.shape[0]
    cuda.require(hi, "hi", torch.int32, 1, dev)
    cuda.require(lo, "lo", torch.int32, 1, dev)
    if lo.shape[0] != n:
        raise ValueError("hi and lo differ in length")
    if n >= 1 << 32:
        raise ValueError("at most 2**32 - 1 lanes per sort")
    keys = torch.empty((n,), dtype=torch.int64, device=dev)
    keys_tmp = torch.empty_like(keys)
    lanes = torch.empty((n,), dtype=torch.int32, device=dev)
    lanes_tmp = torch.empty_like(lanes)
    rep = torch.empty((n,), dtype=torch.bool, device=dev)
    size = cuda.host_function("prededup", "sr_prededup_scratch_bytes",
                              [cuda.I64], cuda.I64)(n)
    scratch = torch.empty((max(size, 1),), dtype=torch.uint8, device=dev)
    fn = cuda.function(
        "prededup", "sr_prededup_sort",
        [cuda.P, cuda.P, cuda.P, cuda.P, cuda.I64, cuda.P, cuda.P, cuda.P,
         cuda.P, cuda.P, cuda.P, cuda.P],
    )
    code = fn(
        cuda.ptr(hi), cuda.ptr(lo),
        cuda.P(None) if active is None else cuda.ptr(active),
        cuda.P(None) if count is None else cuda.ptr(count), n,
        cuda.ptr(keys), cuda.ptr(keys_tmp), cuda.ptr(lanes),
        cuda.ptr(lanes_tmp), cuda.ptr(scratch), cuda.ptr(rep), cuda.stream(hi),
    )
    cuda.check(code, "prededup", what)
    return keys, lanes, rep


def _sorted_runs_plain(hi, lo, active):
    """Plain-torch twin of K12 (any device): a stable sort of the
    sign-flipped key, which orders the int64 ``hi:lo`` words as unsigned.
    The prefix entry's twin is this over the mask ``arange(B) < count``."""
    key = torch.where(active, fp64_of(hi, lo), -1)
    order = torch.sort(key ^ _SIGN, stable=True).indices
    skey = key[order]
    prev = torch.cat([skey[:1] ^ 1, skey[:-1]])  # lane 0 has no predecessor
    rep = (skey != -1) & (skey != prev)
    return skey, order.to(torch.int32), rep


def insert_batch_claim(
    table: HashSet, hi: torch.Tensor, lo: torch.Tensor, active: torch.Tensor,
    with_rounds: bool = False, with_slots: bool = False,
):
    """Sortless insert-if-absent of a key batch, IN PLACE.

    ``hi``/``lo``: int32[B] fingerprint halves; ``active``: bool[B].
    Returns ``(new bool[B], probe_ok bool scalar)``: ``new`` marks exactly
    the LOWEST active lane of each key that was absent before the call --
    the representative the JAX ``insert_batch_claim`` elects, so parents,
    ebits and row-log order stay bit-identical to the JAX engine.
    ``probe_ok`` is False when some lane probed the whole table without
    finding its key or a free slot (a full table).

    ``with_rounds=True`` appends the insert's probe figures, an int64[2]
    device tensor (the traced wave's byte model reads them,
    ``obs/roofline.py``): ``[0]`` the twin's count of lockstep claim
    rounds -- the JAX ``with_rounds`` count -- or K4's longest probe
    chain in slots, and ``[1]`` the table slots the lanes read.

    ``with_slots=True`` appends each lane's slot, int32[B]: where its key
    lies after the call for an active lane (new or present), -1 for an
    inactive one -- the JAX ``insert_batch_claim``'s ``slot``, which the
    sharded engine's commit scatters rows to.  Slots of keys that
    contended for one empty slot are the twin's (lockstep rounds, lowest
    lane first) on the CPU; on the card each key lands somewhere on its
    probe run, so slot-indexed layouts hold the same states, maybe at
    other slots."""
    if hi.device.type == "cpu":
        new, ok, probe, slot = insert_batch_claim_plain(
            table.keys, hi, lo, active, with_rounds=True, with_slots=True
        )
        out = (new, ok) + ((probe,) if with_rounds else ())
        return out + ((slot,) if with_slots else ())
    if table.epoch >= _EPOCH_MAX:
        table.tags.zero_()
        table.epoch = 0
    table.epoch += 1
    insert_batch_claim.launches += 1
    is_new, ok, probe, slot = _claim(table, hi, lo, active, with_rounds,
                                     "sr_insert_claim", cuda.U32, table.epoch)
    out = (is_new, ok) + ((probe,) if with_rounds else ())
    return out + ((slot,) if with_slots else ())


insert_batch_claim.launches = 0


def insert_batch_claim_dev(table: HashSet, hi: torch.Tensor, lo: torch.Tensor,
                           active: torch.Tensor, epoch: torch.Tensor,
                           with_rounds: bool = False):
    """K4's device-epoch entry, for the fused wave loop: the answer of
    :func:`insert_batch_claim`, with the claim epoch a one-word int32
    tensor on the card (K29's epoch word) holding the last call's epoch,
    which the call tags its claims with plus one and advances on the card
    at its end, so a replayed graph tags every wave afresh.  The caller
    clears ``table.tags`` before the word wraps.  The twin advances the
    word too."""
    if hi.device.type == "cpu":
        epoch += 1
        return insert_batch_claim(table, hi, lo, active, with_rounds=with_rounds)
    cuda.require(epoch, "epoch", torch.int32, 1, hi.device)
    insert_batch_claim_dev.launches += 1
    is_new, ok, probe, _slot = _claim(table, hi, lo, active, with_rounds,
                                      "sr_insert_claim_dev", cuda.P,
                                      cuda.ptr(epoch))
    return (is_new, ok) + ((probe,) if with_rounds else ())


insert_batch_claim_dev.launches = 0


def _claim(table: HashSet, hi, lo, active, with_rounds: bool, symbol: str,
           epoch_type, epoch):
    """One K4 launch sequence through the entry ``symbol`` (its epoch
    argument a value or a device word): checks the inputs, makes the
    outputs and returns ``(is_new, probe_ok, probe or None, slot)``."""
    dev = hi.device
    n = hi.shape[0]
    cuda.require(table.slots, "table.slots", torch.int64, 2, dev)
    cuda.require(table.ctl, "table.ctl", torch.int32, 1, dev)
    cuda.require(hi, "hi", torch.int32, 1, dev)
    cuda.require(lo, "lo", torch.int32, 1, dev)
    cuda.require(active, "active", torch.bool, 1, dev)
    if lo.shape[0] != n or active.shape[0] != n:
        raise ValueError("hi, lo and active differ in length")
    if n >= 1 << 32:
        raise ValueError("at most 2**32 - 1 lanes per insert")
    slot = torch.empty((n,), dtype=torch.int32, device=dev)
    is_new = torch.empty((n,), dtype=torch.bool, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    probe = torch.zeros((2,), dtype=torch.int64, device=dev) if with_rounds else None
    fn = cuda.function(
        "hashset", symbol,
        [cuda.P, cuda.U64, cuda.P, cuda.P, cuda.P, cuda.I64, epoch_type,
         cuda.P, cuda.P, cuda.P, cuda.P, cuda.P],
    )
    code = fn(
        cuda.ptr(table.slots), table.capacity,
        cuda.ptr(hi), cuda.ptr(lo), cuda.ptr(active), n, epoch,
        cuda.ptr(slot), cuda.ptr(is_new), cuda.ptr(ok), cuda.ptr(table.ctl),
        cuda.P(None) if probe is None else cuda.ptr(probe),
        cuda.stream(table.slots),
    )
    cuda.check(code, "hashset", symbol)
    return is_new, ok, probe, slot


def insert_batch_claim_plain(
    keys: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor, active: torch.Tensor,
    with_rounds: bool = False, with_slots: bool = False,
):
    """Plain-torch twin of the K4 kernel (any device), IN PLACE on ``keys``:
    the JAX ``_probe_rounds(elect=True)`` round by round.  Each round every
    unresolved lane reads its slot; its key there -> done (a duplicate);
    empty -> the lanes that want the slot scatter-``amin`` their lane id
    into a claim plane, and the winner writes its key; another key -> probe
    on.  Equal keys move in lockstep, so each key's winner is its lowest
    lane, and a same-key loser finds the key on the next round.  With
    ``with_rounds`` it also returns ``[rounds, slots read]`` (int64[2]):
    its round count is the JAX ``_probe_rounds`` count (main and straggler
    rounds together: the straggler rounds continue the same lanes from
    the same slots), and a lane that re-reads its slot after a lost claim
    counts that read.  With ``with_slots`` it also returns each lane's
    slot (int32, -1 for an inactive or unplaced lane)."""
    cap = keys.shape[0]
    dev = keys.device
    n = hi.shape[0]
    key = fp64_of(hi, lo)
    new = torch.zeros((n,), dtype=torch.bool, device=dev)
    lane = torch.nonzero(active).flatten()
    slot = home_slot(hi[lane], lo[lane], cap)
    claim = torch.full((cap,), _I64_MAX, dtype=torch.int64, device=dev)
    slot_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    rounds = slots = 0
    while lane.numel() and rounds < 4 * cap:
        slots += lane.numel()
        cur = keys[slot]
        k = key[lane]
        present = cur == k
        empty = cur == 0
        claim.scatter_reduce_(0, slot[empty], lane[empty], "amin")
        won = empty & (claim[slot] == lane)
        keys[slot[won]] = k[won]
        new[lane[won]] = True
        undone = ~(present | won)
        slot_out[lane[~undone]] = i32(slot[~undone])
        advance = undone & ~empty
        slot = torch.where(advance, (slot + 1) & (cap - 1), slot)
        lane, slot = lane[undone], slot[undone]
        rounds += 1
    ok = torch.tensor(lane.numel() == 0, device=dev)
    out = (new, ok)
    if with_rounds:
        out += (torch.tensor([rounds, slots], dtype=torch.int64, device=dev),)
    return out + ((slot_out,) if with_slots else ())


def insert_batch_compact(table: HashSet, hi, lo, active,
                         dedup_factor: int = 4, sort_lanes=None,
                         with_rounds: bool = False, epoch=None):
    """Sorted insert-if-absent, IN PLACE, in the compact form: the JAX
    ``insert_batch_compact`` -- :func:`prededup`, then K4 on the
    representatives, which are distinct keys, so each absent one is new.
    ``active`` is the lanes' bool mask, or an int64 count scalar on the
    card: the active lanes are that many leading lanes, as
    ``compact_valid`` leaves them, and K12's prefix entry sorts only
    those (:func:`prededup_prefix`).

    Returns ``(u_new, u_origin, u_active, probe_ok, overflow)`` over the
    ``u``-lane buffer in sorted-key order: which representatives were
    absent, their original lanes, the filled lanes, False when some lane
    probed the whole table, and the distinct-key overflow of
    :func:`prededup`.  The JAX version also returns each key's slot; the
    engine never reads it, and on this path slots may differ (see the
    module docstring).  ``with_rounds=True`` appends K4's probe figures
    and ``epoch`` takes K4's device-epoch entry
    (:func:`insert_batch_claim_dev`)."""
    dedup = prededup if active.dtype == torch.bool else prededup_prefix
    u_hi, u_lo, u_origin, u_active, overflow = dedup(
        hi, lo, active, dedup_factor, sort_lanes
    )
    if epoch is None:
        u_new, probe_ok, *probe = insert_batch_claim(
            table, u_hi, u_lo, u_active, with_rounds=with_rounds
        )
    else:
        u_new, probe_ok, *probe = insert_batch_claim_dev(
            table, u_hi, u_lo, u_active, epoch, with_rounds=with_rounds
        )
    return (u_new, u_origin, u_active, probe_ok, overflow, *probe)


def insert_batch(table: HashSet, hi, lo, active, dedup_factor: int = 4):
    """Sorted insert-if-absent with per-input-lane results, IN PLACE: the
    JAX ``insert_batch``.  Returns ``(is_new bool[B], probe_ok,
    overflow)``: ``is_new`` marks the lowest lane of each key that was
    absent before the call."""
    b = hi.shape[0]
    u_new, u_origin, u_active, probe_ok, overflow = insert_batch_compact(
        table, hi, lo, active, dedup_factor
    )
    is_new = torch.zeros((b + 1,), dtype=torch.bool, device=hi.device)
    is_new[torch.where(u_active, u_origin.long(), b)] = u_new
    return is_new[:b], probe_ok, overflow


def keys_equal(a: HashSet, b: HashSet) -> bool:
    """Whether two tables hold the same key set (slots may differ)."""
    ka = torch.sort(a.keys[a.keys != 0]).values
    kb = torch.sort(b.keys[b.keys != 0]).values
    return ka.shape == kb.shape and bool((ka == kb).all())

