"""The sharded engine's owner routing (K26) and shard commit (K27).

The counterparts of ``stateright_tpu/parallel/sharded.py``'s owner mix
(``:97`` ``_owner_mix``, ``:106`` ``_owner_mix_host``, ``:117``
``_owner_mix_host_np``: the same constants and rotations, so host seeding
and device routing agree), its owner bucketing (``:683-727``) and its
commit scatters (``:789-806``, the seed's ``:1062-1068``).

:func:`owner_bucket` (K26, ``csrc/exchange.cu``) packs a shard's
representatives into one ``[n, bkt, W + 3]`` send buffer by owner shard,
each bucket in lane order (JAX's stable ``argsort``): the row, the parent's
global id, its eventually-bits and a validity word.  :func:`shard_commit`
(K27, ``csrc/shard_commit.cu``) writes the owner-side insert's new lanes
into the slot-indexed store, parents and eventually-bits and appends their
slots at the shard's queue tail, IN PLACE (the JAX engine threads donated
buffers).  :func:`shard_log_append` (K28, the same source's second entry)
is the tiered-sharded engine's commit (``stateright_tpu/tiered/
sharded_engine.py:289-302``): the fresh lanes' rows, parents and
eventually-bits at the tail of the shard's row log.  Each wrapper launches
its kernel on a CUDA tensor and runs its plain-torch twin (``*_plain``) on
a CPU one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import cuda
from ..ops.fingerprint import _fmix32
from ..ops.u32 import M32, fmix32, rotl, u32

OWNER_SALT = 0xA511E9B3


def owner_mix(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The owner mix of int32 key halves, as int64 words in ``[0, 2**32)``
    -- independent of the key planes and of the table's home slot."""
    return fmix32(u32(lo) ^ rotl(u32(hi), 7) ^ OWNER_SALT)


def owner_mix_host(hi: int, lo: int) -> int:
    """:func:`owner_mix` of one key on the host."""
    return _fmix32((lo ^ (((hi << 7) | (hi >> 25)) & M32) ^ OWNER_SALT) & M32)


def owner_mix_host_np(hi, lo) -> np.ndarray:
    """:func:`owner_mix` over uint32 numpy arrays."""
    hi = np.asarray(hi, np.uint32)
    lo = np.asarray(lo, np.uint32)
    h = lo ^ ((hi << np.uint32(7)) | (hi >> np.uint32(25))) ^ np.uint32(OWNER_SALT)
    h ^= h >> np.uint32(16)
    h = h * np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h = h * np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h


def owner_bucket(hi, lo, valid, rows, ridx, olane, a: int, gids, ebs,
                 n: int, bkt: int):
    """Bucket a shard's representatives by owner shard (K26).

    Lane ``i`` with ``valid[i]`` goes to shard ``owner_mix(hi[i], lo[i]) %
    n``, at the rank of its lane among that shard's lanes; its payload is
    ``rows[ridx[i]]``, then ``gids[olane[i] // a]``, ``ebs[olane[i] // a]``
    and 1.  ``hi``/``lo``/``ridx``/``olane`` int32[U], ``valid`` bool[U],
    ``rows`` int32[R, W] (each row's words contiguous; rows may lie further
    apart), ``gids``/``ebs`` int32 per state of the chunk.  Returns ``(send
    int32[n, bkt, W + 3], counts int64[n + 1], overflow)``: lanes ranked past
    ``bkt`` are dropped, ``counts[n]`` counts the invalid lanes, and
    ``overflow`` (an int32 scalar tensor) is 1 when a bucket holds more than
    ``bkt`` lanes -- JAX's flag-32 condition."""
    if hi.device.type == "cpu":
        return owner_bucket_plain(hi, lo, valid, rows, ridx, olane, a, gids,
                                  ebs, n, bkt)
    dev = hi.device
    u = hi.shape[0]
    for t, name in ((hi, "hi"), (lo, "lo"), (ridx, "ridx"), (olane, "olane"),
                    (gids, "gids"), (ebs, "ebs")):
        cuda.require(t, name, torch.int32, 1, dev)
    cuda.require(valid, "valid", torch.bool, 1, dev)
    if rows.dtype != torch.int32 or rows.dim() != 2 or rows.device != dev:
        raise ValueError(f"rows must be int32[R, W] on {dev}")
    w = rows.shape[1]
    if w > 1 and rows.stride(1) != 1:
        raise ValueError("each row's words must be contiguous")
    if not 1 <= n <= 1024 or bkt < 1 or a < 1:
        raise ValueError("need 1 <= n <= 1024, bkt >= 1 and a >= 1")
    if any(t.shape[0] != u for t in (lo, valid, ridx, olane)):
        raise ValueError("hi, lo, valid, ridx and olane differ in length")
    if u >= 1 << 31:
        raise ValueError("owner_bucket takes fewer than 2**31 lanes")
    send = torch.empty((n, bkt, w + 3), dtype=torch.int32, device=dev)
    counts = torch.empty((n + 1,), dtype=torch.int64, device=dev)
    overflow = torch.empty((), dtype=torch.int32, device=dev)
    launch = cuda.stream(send)
    scratch = _lookback_scratch(dev, launch,
                              3 + max(1, (u + 255) // 256) * n + 2 * u)
    fn = cuda.function(
        "exchange", "sr_owner_bucket",
        [cuda.P, cuda.P, cuda.P, cuda.I64, cuda.P, cuda.I64, cuda.I32, cuda.P,
         cuda.P, cuda.I32, cuda.P, cuda.P, cuda.U32, cuda.I64, cuda.P, cuda.P,
         cuda.P, cuda.P, cuda.P],
    )
    owner_bucket.launches += 1
    code = fn(
        cuda.ptr(hi), cuda.ptr(lo), cuda.ptr(valid), u, cuda.ptr(rows),
        rows.stride(0) if rows.shape[0] > 1 else w, w, cuda.ptr(ridx),
        cuda.ptr(olane), a, cuda.ptr(gids), cuda.ptr(ebs), n, bkt,
        cuda.ptr(send), cuda.ptr(counts), cuda.ptr(overflow), cuda.ptr(scratch),
        launch,
    )
    cuda.check(code, "exchange", "owner_bucket")
    return send, counts, overflow


owner_bucket.launches = 0

# K26's and K27's ticket and control words, look-back words and K26's
# representatives' list, kept per card and stream (the wrappers'
# signatures are the JAX calls', so nothing else could hold them): the
# kernels never clear the look-back words (each call's words carry its
# epoch, and both kernels draw their epochs from the one ticket word) and
# K26's last block out resets its control words, so a call allocates
# nothing beyond its outputs.  Calls on one stream run in order; the
# scratch is zeroed again before the 30-bit epoch could wrap.
_EPOCH_CALLS = 1 << 29
_SCRATCH: dict = {}


def _lookback_scratch(dev: torch.device, launch, words: int) -> torch.Tensor:
    key = (dev.index, launch.handle.value)
    held = _SCRATCH.get(key)
    if held is None or held[0].shape[0] < words or held[1] >= _EPOCH_CALLS:
        size = words if held is None else max(words, held[0].shape[0])
        held = [torch.zeros((size,), dtype=torch.int64, device=dev), 0]
        _SCRATCH[key] = held
    held[1] += 1
    return held[0]


def owner_bucket_plain(hi, lo, valid, rows, ridx, olane, a: int, gids, ebs,
                       n: int, bkt: int):
    """Plain-torch twin of K26 (any device): the JAX engine's stable argsort
    of the owner keys, the bucket counts and the drop-mode scatter."""
    dev = hi.device
    u = hi.shape[0]
    w = rows.shape[1]
    key = torch.where(valid, owner_mix(hi, lo) % n, n)
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=n + 1)
    offsets = torch.cumsum(counts, 0) - counts
    key_s = key[order]
    pos = torch.arange(u, device=dev) - offsets[key_s]
    keep = (key_s < n) & (pos < bkt)
    lanes = order[keep]
    parent = olane[lanes].long() // a
    send = torch.zeros((n, bkt, w + 3), dtype=torch.int32, device=dev)
    send[key_s[keep], pos[keep]] = torch.cat([
        rows[ridx[lanes].long()], gids[parent, None], ebs[parent, None],
        torch.ones((lanes.shape[0], 1), dtype=torch.int32, device=dev),
    ], 1)
    overflow = (counts[:n] > bkt).any().to(torch.int32)
    return send, counts, overflow


def shard_commit(is_new: torch.Tensor, slot: torch.Tensor,
                 origin: Optional[torch.Tensor], rows: torch.Tensor,
                 gid: torch.Tensor, eb: torch.Tensor, store: torch.Tensor,
                 parent: torch.Tensor, ebits: torch.Tensor,
                 queue: torch.Tensor, tail: int) -> torch.Tensor:
    """Commit the new lanes of an owner-side insert (K27), IN PLACE: for the
    j-th lane ``i`` with ``is_new[i]``, in lane order, with ``r =
    origin[i]`` (or ``i``): ``store[slot[i]] = rows[r]``, ``parent[slot[i]]
    = gid[r]``, ``ebits[slot[i]] = eb[r]`` and ``queue[tail + j] = slot[i]``
    (dropped past the queue's end).  ``is_new`` bool[L], ``slot``/``origin``
    int32[L]; ``rows`` int32[R, W], ``gid``/``eb`` int32[R] (views of the
    packed receive buffer may be strided); ``store`` int32[capacity, W],
    ``parent``/``ebits`` int32[capacity], ``queue`` int32[Q].  Returns the
    int64 count of new lanes (a device scalar)."""
    if is_new.device.type == "cpu":
        return shard_commit_plain(is_new, slot, origin, rows, gid, eb, store,
                                  parent, ebits, queue, tail)
    dev = is_new.device
    r = is_new.shape[0]
    cuda.require(is_new, "is_new", torch.bool, 1, dev)
    cuda.require(slot, "slot", torch.int32, 1, dev)
    if origin is not None:
        cuda.require(origin, "origin", torch.int32, 1, dev)
    for t, name in ((store, "store"), (parent, "parent"), (ebits, "ebits"),
                    (queue, "queue")):
        cuda.require(t, name, torch.int32, t.dim(), dev)
    for t, name, ndim in ((rows, "rows", 2), (gid, "gid", 1), (eb, "eb", 1)):
        if t.dtype != torch.int32 or t.dim() != ndim or t.device != dev:
            raise ValueError(f"{name} must be int32 {ndim}-D on {dev}")
    w = rows.shape[1]
    if store.dim() != 2 or store.shape[1] != w:
        raise ValueError(f"store must be int32[capacity, {w}]")
    if w > 1 and rows.stride(1) != 1:
        raise ValueError("each row's words must be contiguous")
    if r >= 1 << 31:
        raise ValueError("shard_commit takes fewer than 2**31 lanes")
    n_new = torch.empty((), dtype=torch.int64, device=dev)
    launch = cuda.stream(store)
    scratch = _lookback_scratch(dev, launch, 3 + max(1, (r + 255) // 256))
    fn = cuda.function(
        "shard_commit", "sr_shard_commit",
        [cuda.P, cuda.I64, cuda.P, cuda.P, cuda.P, cuda.I64, cuda.I32, cuda.P,
         cuda.I64, cuda.P, cuda.I64, cuda.P, cuda.P, cuda.P, cuda.P, cuda.I64,
         cuda.I64, cuda.P, cuda.P, cuda.P],
    )
    shard_commit.launches += 1
    code = fn(
        cuda.ptr(is_new), r, cuda.ptr(slot),
        cuda.P(None) if origin is None else cuda.ptr(origin), cuda.ptr(rows),
        rows.stride(0), w, cuda.ptr(gid), gid.stride(0), cuda.ptr(eb),
        eb.stride(0), cuda.ptr(store), cuda.ptr(parent), cuda.ptr(ebits),
        cuda.ptr(queue), queue.shape[0], tail, cuda.ptr(n_new),
        cuda.ptr(scratch), launch,
    )
    cuda.check(code, "shard_commit", "shard_commit")
    return n_new


shard_commit.launches = 0


def shard_commit_plain(is_new, slot, origin, rows, gid, eb, store, parent,
                       ebits, queue, tail: int) -> torch.Tensor:
    """Plain-torch twin of K27 (any device): the JAX engine's drop-mode
    scatters and the queue append through the cumsum of the new mask."""
    lanes = torch.nonzero(is_new).flatten()
    src = lanes if origin is None else origin[lanes].long()
    s = slot[lanes].long()
    store[s] = rows[src]
    parent[s] = gid[src]
    ebits[s] = eb[src]
    q = tail + torch.arange(lanes.shape[0], device=is_new.device)
    keep = q < queue.shape[0]
    queue[q[keep]] = slot[lanes][keep]
    return torch.tensor(lanes.shape[0], dtype=torch.int64, device=is_new.device)


def shard_log_append(fresh: torch.Tensor, origin: Optional[torch.Tensor],
                     rows: torch.Tensor, gid: torch.Tensor, eb: torch.Tensor,
                     log_rows: torch.Tensor, log_parent: torch.Tensor,
                     log_ebits: torch.Tensor, tail: int) -> torch.Tensor:
    """Append the fresh lanes of a tiered shard's insert to its row log
    (K28), IN PLACE: for the j-th lane ``i`` with ``fresh[i]``, in lane
    order, with ``r = origin[i]`` (or ``i``): ``log_rows[tail + j] =
    rows[r]``, ``log_parent[tail + j] = gid[r]``, ``log_ebits[tail + j] =
    eb[r]``, dropped past the log's end.  ``fresh`` bool[L], ``origin``
    int32[L]; ``rows`` int32[R, W], ``gid``/``eb`` int32[R] (views of the
    packed receive buffer may be strided); ``log_rows`` int32[N, W]
    (contiguous), ``log_parent``/``log_ebits`` int32[N].  Returns the int64
    count of fresh lanes (a device scalar)."""
    if fresh.device.type == "cpu":
        return shard_log_append_plain(fresh, origin, rows, gid, eb, log_rows,
                                      log_parent, log_ebits, tail)
    dev = fresh.device
    r = fresh.shape[0]
    cuda.require(fresh, "fresh", torch.bool, 1, dev)
    if origin is not None:
        cuda.require(origin, "origin", torch.int32, 1, dev)
        if origin.shape[0] != r:
            raise ValueError("fresh and origin differ in length")
    for t, name in ((log_parent, "log_parent"), (log_ebits, "log_ebits")):
        cuda.require(t, name, torch.int32, 1, dev)
    cuda.require(log_rows, "log_rows", torch.int32, 2, dev)
    for t, name, ndim in ((rows, "rows", 2), (gid, "gid", 1), (eb, "eb", 1)):
        if t.dtype != torch.int32 or t.dim() != ndim or t.device != dev:
            raise ValueError(f"{name} must be int32 {ndim}-D on {dev}")
    w = rows.shape[1]
    if log_rows.shape[1] != w:
        raise ValueError(f"log_rows must be int32[N, {w}]")
    if w > 1 and rows.stride(1) != 1:
        raise ValueError("each row's words must be contiguous")
    n = log_rows.shape[0]
    if log_parent.shape[0] < n or log_ebits.shape[0] < n or tail < 0:
        raise ValueError("the parent and ebits logs must span the row log")
    n_fresh = torch.empty((), dtype=torch.int64, device=dev)
    scratch = torch.empty((max(1, (r + 255) // 256),), dtype=torch.int64,
                          device=dev)
    fn = cuda.function(
        "shard_commit", "sr_shard_log_append",
        [cuda.P, cuda.I64, cuda.P, cuda.P, cuda.I64, cuda.I32, cuda.P,
         cuda.I64, cuda.P, cuda.I64, cuda.P, cuda.P, cuda.P, cuda.I64,
         cuda.I64, cuda.P, cuda.P, cuda.P],
    )
    shard_log_append.launches += 1
    code = fn(
        cuda.ptr(fresh), r,
        cuda.P(None) if origin is None else cuda.ptr(origin), cuda.ptr(rows),
        rows.stride(0), w, cuda.ptr(gid), gid.stride(0), cuda.ptr(eb),
        eb.stride(0), cuda.ptr(log_rows), cuda.ptr(log_parent),
        cuda.ptr(log_ebits), n, tail, cuda.ptr(n_fresh), cuda.ptr(scratch),
        cuda.stream(log_rows),
    )
    cuda.check(code, "shard_commit", "shard_log_append")
    return n_fresh


shard_log_append.launches = 0


def shard_log_append_plain(fresh, origin, rows, gid, eb, log_rows,
                           log_parent, log_ebits, tail: int) -> torch.Tensor:
    """Plain-torch twin of K28 (any device): the fresh lanes' indices
    (``nonzero``), their sources through ``origin``, and three row-indexed
    writes at the tail, past the log's end dropped -- the JAX engine's
    cumsum positions and drop-mode scatters."""
    lanes = torch.nonzero(fresh).flatten()
    src = lanes if origin is None else origin[lanes].long()
    pos = tail + torch.arange(lanes.shape[0], device=fresh.device)
    keep = pos < log_rows.shape[0]
    pos, src = pos[keep], src[keep]
    log_rows[pos] = rows[src]
    log_parent[pos] = gid[src]
    log_ebits[pos] = eb[src]
    return torch.tensor(lanes.shape[0], dtype=torch.int64, device=fresh.device)


def gather_to(device: torch.device, parts) -> torch.Tensor:
    """Stack same-shaped tensors of several shards on ``device`` (peer
    copies, queued behind their producers on each card; no host sync)."""
    return torch.stack([p.to(device, non_blocking=True) for p in parts])
