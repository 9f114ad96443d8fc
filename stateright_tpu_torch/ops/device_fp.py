"""Device-side 64-bit fingerprinting over packed state rows (kernel K1).

The counterpart of ``stateright_tpu/ops/device_fp.py``: two murmur3-style
u32 lanes over the row's words, bit-identical to the host ``fp64_words``
(``ops/fingerprint.py``) including the remap of the two reserved values.
Rows are ``int32`` bit-views of the packed ``uint32`` words; the 64-bit
fingerprint comes back as an ``(hi, lo)`` pair of int32 bit-view planes.
A model whose identity is a row's leading ``fp_words`` words passes the
view ``rows[:, :fp_words]``: the kernel steps from row to row by the view's
row stride, so the prefix is hashed without a copy.

On a CUDA tensor :func:`device_fp64` launches ``csrc/device_fp.cu``; on a
CPU tensor it runs :func:`device_fp64_plain`, the plain-torch twin the CPU
tests and the chip smoke check hold the kernel against.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import cuda
from .fingerprint import SEED_HI, SEED_LO
from .u32 import M32, fmix32, i32, mix32, u32


def device_fp64(words: torch.Tensor, out=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fingerprint packed rows ``int32[N, W]`` -> ``(hi, lo)`` int32[N],
    never both zero, never both all-ones.  Bit-identical to
    ``fp64_words(row)`` for every row.  Each row's words must be
    contiguous; rows may lie further apart (a column prefix of a wider
    row log).  ``out``: an ``(hi, lo)`` pair of contiguous int32[N] tensors
    to write into (the gang wave's readback buffer) instead of new ones."""
    if words.device.type == "cpu":
        hi, lo = device_fp64_plain(words)
        if out is None:
            return hi, lo
        out[0].copy_(hi)
        out[1].copy_(lo)
        return out
    n, w, stride, hi, lo = _fp_args(words, out)
    fn = cuda.function(
        "device_fp", "sr_device_fp64",
        [cuda.P, cuda.I64, cuda.I32, cuda.I64, cuda.P, cuda.P, cuda.P],
    )
    device_fp64.launches += 1
    code = fn(cuda.ptr(words), n, w, stride, cuda.ptr(hi), cuda.ptr(lo),
              cuda.stream(hi))
    cuda.check(code, "device_fp", "device_fp64")
    return hi, lo


device_fp64.launches = 0


def device_fp64_n(words: torch.Tensor, count: torch.Tensor,
                  out=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's counted entry, for the fused wave loop: :func:`device_fp64` of
    rows ``[0, count)`` only, ``count`` an int64 scalar tensor on the rows'
    device read on the card (no host sync; the two-phase wave's buffer
    holds ``n_valid`` rows).  The rest of ``hi``/``lo`` is left as it was
    (unwritten, for new tensors)."""
    if words.device.type == "cpu":
        return device_fp64_n_plain(words, count, out)
    n, w, stride, hi, lo = _fp_args(words, out)
    cuda.require(count, "count", torch.int64, 0, words.device)
    fn = cuda.function(
        "device_fp", "sr_device_fp64_n",
        [cuda.P, cuda.I64, cuda.I32, cuda.I64, cuda.P, cuda.P, cuda.P, cuda.P],
    )
    device_fp64_n.launches += 1
    code = fn(cuda.ptr(words), n, w, stride, cuda.ptr(count), cuda.ptr(hi),
              cuda.ptr(lo), cuda.stream(hi))
    cuda.check(code, "device_fp", "device_fp64_n")
    return hi, lo


device_fp64_n.launches = 0


def _fp_args(words: torch.Tensor, out):
    """K1's launch arguments: ``(n, w, row stride, hi, lo)``, checked."""
    if words.dim() != 2 or words.dtype != torch.int32:
        raise ValueError(
            f"words must be int32[N, W], got {words.dtype} {tuple(words.shape)}"
        )
    n, w = words.shape
    stride = words.stride(0) if n > 1 else w
    if (w > 1 and words.stride(1) != 1) or stride < w:
        raise ValueError("each row's words must be contiguous, rows not overlapping")
    if out is None:
        hi = torch.empty((n,), dtype=torch.int32, device=words.device)
        lo = torch.empty((n,), dtype=torch.int32, device=words.device)
    else:
        hi, lo = out
        for t, name in ((hi, "hi"), (lo, "lo")):
            cuda.require(t, name, torch.int32, 1, words.device)
            if t.shape[0] != n:
                raise ValueError(f"{name} must hold {n} fingerprints")
    return n, w, stride, hi, lo


def device_fp64_plain(words: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of the K1 kernel (any device)."""
    if words.dim() != 2:
        raise ValueError(f"words must be 2-D, got shape {tuple(words.shape)}")
    n, w = words.shape
    x = u32(words)
    h1 = torch.full((n,), SEED_HI, dtype=torch.int64, device=words.device)
    h2 = torch.full((n,), SEED_LO, dtype=torch.int64, device=words.device)
    for k in range(w):
        h1 = mix32(h1, x[:, k])
        h2 = mix32(h2, x[:, k])
    h1 = fmix32(h1 ^ w)
    h2 = fmix32(h2 ^ ((w * 0x9E3779B1) & M32))
    h1, h2 = _remap_pair(h1, h2)
    return i32(h1), i32(h2)


def device_fp64_n_plain(words: torch.Tensor, count, out=None):
    """Plain-torch twin of K1's counted entry (any device): rows ``[0,
    count)`` hashed into ``out`` (or new zeroed planes); the rest kept."""
    n = words.shape[0]
    k = min(int(count), n)
    if out is None:
        out = (torch.zeros((n,), dtype=torch.int32, device=words.device),
               torch.zeros((n,), dtype=torch.int32, device=words.device))
    hi, lo = device_fp64_plain(words[:k])
    out[0][:k] = hi
    out[1][:k] = lo
    return out


def _remap_pair(h1: torch.Tensor, h2: torch.Tensor):
    """Steer (0, 0) to (0, 1) and all-ones to ...FFFE, bit-identically to
    the host ``fingerprint._remap_fp``.  Takes and returns int64 lanes in
    ``[0, 2**32)``."""
    both_zero = (h1 == 0) & (h2 == 0)
    h2 = torch.where(both_zero, torch.ones_like(h2), h2)
    both_ones = (h1 == M32) & (h2 == M32)
    return h1, torch.where(both_ones, torch.full_like(h2, M32 - 1), h2)


def fp64_of(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Pack an ``(hi, lo)`` int32 pair into one int64 per row whose bits are
    ``hi:lo`` (the hash table's key word)."""
    return hi.to(torch.int64) * (1 << 32) + u32(lo)

