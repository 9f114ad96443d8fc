"""The cold merge-join of a tiered wave (K20, ``csrc/cold.cu``).

The counterpart of ``_tiered_programs`` in ``stateright_tpu/tiered/
engine.py``: :func:`cold_query` finds the unsigned 64-bit minimum and
maximum key of a wave's new lanes (the host prunes each cold run to the
window between them), and :func:`cold_probe` looks every new lane's key up
in one sorted, all-ones-padded chunk of that window and clears the lane's
new bit on a hit, in place -- after the last pass the mask is the JAX
engine's ``fresh = u_new & ~found``.

A lane's key is ``(hi[o], lo[o])`` with ``o = origin[lane]`` on the sorted
dedup path (the representative's buffer lane) or the lane itself on the
claim path (``origin=None``).  Keys order as unsigned 64-bit ``hi:lo``; the
plain twins order the sign-flipped int64 word, as K12's does.  On a CUDA
tensor each wrapper launches its kernel, on a CPU tensor it runs its twin.
:func:`cold_windows` and :func:`load_chunk` are the host side of a pass:
which keys of which run it streams, and how a chunk is padded.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import cuda
from ..ops.device_fp import fp64_of

_SIGN = -(1 << 63)  # XOR with it turns the signed int64 order unsigned
ALL_ONES = -1  # the pad key, as an int64 bit-view


def _check(hi, lo, origin, is_new) -> int:
    dev = hi.device
    n = is_new.shape[0]
    cuda.require(hi, "hi", torch.int32, 1, dev)
    cuda.require(lo, "lo", torch.int32, 1, dev)
    cuda.require(is_new, "is_new", torch.bool, 1, dev)
    if origin is not None:
        cuda.require(origin, "origin", torch.int32, 1, dev)
        if origin.shape[0] != n:
            raise ValueError("origin and is_new differ in length")
    elif hi.shape[0] != n:
        raise ValueError("without origin, hi and is_new differ in length")
    if lo.shape[0] != hi.shape[0]:
        raise ValueError("hi and lo differ in length")
    return n


def _origin_ptr(origin):
    return cuda.P(None) if origin is None else cuda.ptr(origin)


def cold_query(hi: torch.Tensor, lo: torch.Tensor,
               origin: Optional[torch.Tensor],
               is_new: torch.Tensor) -> torch.Tensor:
    """``int64[2]``: the bit patterns of the unsigned minimum and maximum
    key over the new lanes; ``(all-ones, 0)`` when no lane is new."""
    if hi.device.type == "cpu":
        return cold_query_plain(hi, lo, origin, is_new)
    n = _check(hi, lo, origin, is_new)
    minmax = torch.empty((2,), dtype=torch.int64, device=hi.device)
    fn = cuda.function(
        "cold", "sr_cold_query",
        [cuda.P, cuda.P, cuda.P, cuda.P, cuda.I64, cuda.P, cuda.P],
    )
    cold_query.launches += 1
    code = fn(cuda.ptr(hi), cuda.ptr(lo), _origin_ptr(origin),
              cuda.ptr(is_new), n, cuda.ptr(minmax), cuda.stream(hi))
    cuda.check(code, "cold", "cold_query")
    return minmax


cold_query.launches = 0


def _keys(hi, lo, origin):
    if origin is not None:
        o = origin.long()
        hi, lo = hi[o], lo[o]
    return fp64_of(hi, lo)


def cold_query_plain(hi, lo, origin, is_new) -> torch.Tensor:
    """Plain-torch twin of :func:`cold_query` (any device)."""
    k = _keys(hi, lo, origin)[is_new] ^ _SIGN
    if k.numel() == 0:
        return torch.tensor([ALL_ONES, 0], dtype=torch.int64, device=hi.device)
    return torch.stack([k.min(), k.max()]) ^ _SIGN


def cold_probe(hi: torch.Tensor, lo: torch.Tensor,
               origin: Optional[torch.Tensor], is_new: torch.Tensor,
               chunk: torch.Tensor) -> None:
    """Clear ``is_new`` IN PLACE at every new lane whose key is in
    ``chunk``: ``int64[C]`` keys sorted as unsigned, ``C`` a power of two,
    padded with the all-ones key."""
    if hi.device.type == "cpu":
        return cold_probe_plain(hi, lo, origin, is_new, chunk)
    n = _check(hi, lo, origin, is_new)
    c = chunk.shape[0]
    cuda.require(chunk, "chunk", torch.int64, 1, hi.device)
    if c < 1 or c & (c - 1):
        raise ValueError("the chunk length must be a power of two")
    fn = cuda.function(
        "cold", "sr_cold_probe",
        [cuda.P, cuda.P, cuda.P, cuda.P, cuda.I64, cuda.P, cuda.I64, cuda.P],
    )
    cold_probe.launches += 1
    code = fn(cuda.ptr(hi), cuda.ptr(lo), _origin_ptr(origin),
              cuda.ptr(is_new), n, cuda.ptr(chunk), c, cuda.stream(hi))
    cuda.check(code, "cold", "cold_probe")
    return None


cold_probe.launches = 0


def cold_probe_plain(hi, lo, origin, is_new, chunk) -> None:
    """Plain-torch twin of :func:`cold_probe` (any device): a lower bound
    by ``torch.searchsorted`` on the sign-flipped keys, capped at the last
    element, then an equality test."""
    q = _keys(hi, lo, origin)
    pos = torch.searchsorted(chunk ^ _SIGN, q ^ _SIGN)
    pos = pos.clamp(max=chunk.shape[0] - 1)
    is_new &= chunk[pos] != q
    return None


def cold_windows(runs: Sequence[np.ndarray], lo_key: int,
                 hi_key: int) -> Iterator[Tuple[np.ndarray, int, int]]:
    """Each sorted uint64 run pruned on the host to the window ``[a, b)``
    of keys between ``lo_key`` and ``hi_key`` (unsigned, inclusive), for
    the runs whose window is not empty -- the JAX engine's
    ``np.searchsorted`` pruning."""
    for run in runs:
        a = int(np.searchsorted(run, np.uint64(lo_key), side="left"))
        b = int(np.searchsorted(run, np.uint64(hi_key), side="right"))
        if a < b:
            yield run, a, b


def load_chunk(buf: torch.Tensor, seg: np.ndarray) -> None:
    """Copy the sorted uint64 keys ``seg`` (at most ``buf``'s length) into
    the int64 chunk ``buf`` and pad its tail with the all-ones key."""
    if not seg.flags.writeable:
        seg = seg.copy()  # a memory-mapped run is read-only
    n = seg.shape[0]
    buf[:n].copy_(torch.from_numpy(seg.view(np.int64)))
    if n < buf.shape[0]:
        buf[n:].fill_(ALL_ONES)
