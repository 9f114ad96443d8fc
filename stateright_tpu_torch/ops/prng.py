"""JAX's threefry random stream, bit for bit.

The device walkers (``parallel/simulation_gpu.py``) choose their lanes from
the same keys and draws as the JAX package's ``jax.random`` calls, so a
port walk equals a JAX walk state for state.  This module transcribes JAX
0.9.0's default PRNG with the two configuration values it runs under:

- ``jax_default_prng_impl = "threefry2x32"`` -- keys are two u32 words;
- ``jax_threefry_partitionable = True`` -- ``split`` and 32-bit random
  bits hash the two-word counter ``(0, i)`` and XOR the result's halves;

and ``jax_enable_x64 = False`` (so a seed keeps its low 32 bits).  The
functions, from ``jax/_src/prng.py`` and ``jax/_src/random.py``:

- :func:`threefry2x32`: the 20-round Threefry-2x32 hash (``prng.py:883``);
- :func:`prng_key`: ``jax.random.PRNGKey(seed)`` = ``(0, seed mod 2**32)``;
- :func:`fold_in`: ``threefry2x32(key, (0, data))``;
- :func:`split`: JAX's two-way split, ``threefry2x32(key, (0, i))`` for
  ``i = 0, 1``;
- :func:`randint`: ``jax.random.randint(key, (), 0, maxval)`` with dtype
  int32 -- two draws from the split key and JAX's modulus arithmetic.

Keys are ``int32[n, 2]`` tensors (u32 bit-views), one per row; the twins
compute in masked int64 (``u32.py``).  The card computes the same stream
in ``csrc/threefry.cuh``, the header the walk kernel includes.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from .u32 import M32, i32, rotl, u32

# The JAX configuration this stream equals; the CPU tests assert it.
JAX_VERSION = "0.9.0"
JAX_CONFIG = {
    "jax_default_prng_impl": "threefry2x32",
    "jax_threefry_partitionable": True,
    "jax_enable_x64": False,
}

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_I32_MAX = 0x7FFFFFFF


def threefry2x32(k0, k1, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter words ``(x0, x1)`` under the key
    ``(k0, k1)``; every argument and result is int64 in ``[0, 2**32)``
    (or a Python int), broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def _halves(keys: torch.Tensor):
    if keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys must be [n, 2], got {tuple(keys.shape)}")
    k = u32(keys)
    return k[:, 0], k[:, 1]


def _key(y0: torch.Tensor, y1: torch.Tensor) -> torch.Tensor:
    return torch.stack([i32(y0), i32(y1)], dim=1)


def prng_key(seed: Union[int, torch.Tensor], device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as ``int32[n, 2]`` (``n = 1`` for an
    int): the high word 0, the low word the seed's low 32 bits."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=device).reshape(-1)
    return _key(torch.zeros_like(s), s & M32)


def fold_in(keys: torch.Tensor, data: Union[int, torch.Tensor]) -> torch.Tensor:
    """``jax.random.fold_in`` row by row: ``data`` (an int or an integer
    tensor of n values, taken mod 2**32) hashed as the counter (0, data)."""
    k0, k1 = _halves(keys)
    d = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & M32
    return _key(*threefry2x32(k0, k1, torch.zeros_like(d), d))


def split(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.split(key)`` row by row: the pair (new key, subkey) --
    rows 0 and 1 of JAX's ``[2, 2]`` result."""
    k0, k1 = _halves(keys)
    zero = torch.zeros_like(k0)
    return (_key(*threefry2x32(k0, k1, zero, zero)),
            _key(*threefry2x32(k0, k1, zero, zero + 1)))


def _bits(keys: torch.Tensor) -> torch.Tensor:
    """32 random bits per row as int64 in ``[0, 2**32)``: JAX's 32-bit
    random bits, ``y0 ^ y1`` of ``threefry2x32(key, (0, 0))``."""
    k0, k1 = _halves(keys)
    zero = torch.zeros_like(k0)
    y0, y1 = threefry2x32(k0, k1, zero, zero)
    return y0 ^ y1


def randint(keys: torch.Tensor, maxval: Union[int, torch.Tensor]) -> torch.Tensor:
    """``jax.random.randint(key, (), 0, maxval)`` (dtype int32) row by row.

    ``maxval`` is an int or integer tensor in ``[0, 2**32)``, as JAX takes
    a uint32 bound: at most 0 gives 0 (span 1); above the int32 range it is
    clipped to 2**31 - 1 and the span grows by one, JAX's out-of-range
    case.  The span, the multiplier ``(2**16 mod span)**2 mod span`` and
    the offset are u32 arithmetic, wrapping as JAX's do."""
    n = keys.shape[0]
    mx = torch.as_tensor(maxval, dtype=torch.int64, device=keys.device)
    mx = mx.expand(n) if mx.dim() == 0 else mx
    out_of_range = mx > _I32_MAX
    mx = mx.clamp(max=_I32_MAX)
    span = torch.where(mx <= 0, torch.ones_like(mx), mx)
    span = torch.where(out_of_range, span + 1, span)
    k_hi, k_lo = split(keys)
    hi, lo = _bits(k_hi), _bits(k_lo)
    mult = 65536 % span
    mult = ((mult * mult) & M32) % span
    off = (((hi % span) * mult) & M32) + (lo % span)
    off = (off & M32) % span
    return off.to(torch.int32)
