"""Unsigned 32-bit word arithmetic for the plain-torch twins.

The JAX package computes in ``uint32``.  PyTorch's CPU ``uint32`` lacks
``+``, ``>>``, ``<`` and scatter-``amin``, and a silent fall back to signed
``int32`` mis-orders ``<`` and ``>>`` for words of 2**31 and up.  So the
port stores words as ``int32`` bit-views (the same bytes as the JAX planes)
and the twins compute on them carried in ``int64`` in ``[0, 2**32)``,
masking after every operation that can leave that range.  Products are
split so that no ``int64`` intermediate overflows.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit-view (or any integer tensor) -> int64 in [0, 2**32)."""
    return t.to(torch.int64) & M32


def i32(t: torch.Tensor) -> torch.Tensor:
    """int64 word values -> the int32 tensor with the same low 32 bits."""
    return (((t & M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def shl32(val: torch.Tensor, off: int) -> torch.Tensor:
    """``val << off`` in u32: the bits shifted past 31 are lost."""
    return (val & (M32 >> off)) << off


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a u32 constant c,
    without an intermediate past 2**49."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def mix32(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    k = mul32(w, 0xCC9E2D51)
    k = rotl(k, 15)
    k = mul32(k, 0x1B873593)
    h = h ^ k
    h = rotl(h, 13)
    return (mul32(h, 5) + 0xE6546B64) & M32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def from_numpy_u32(a, device) -> torch.Tensor:
    """A uint32 numpy array as an int32 bit-view tensor on ``device``."""
    arr = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """An int32 bit-view tensor as a uint32 numpy array on the host."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint32)
