"""The fault-fate function per lane, and the lane mask of a fault schedule.

The counterpart of ``stateright_tpu/ensemble/fate.py``.  The host fate of
the n-th datagram on a directed link is counter-mode splitmix64 at counter
``4n + k + 1`` over the link's 64-bit seed, top 32 bits kept
(``runtime.chaos.fault_fate_u32``).  :func:`device_fault_fate` is that
function in u32 limbs, transcribed from the JAX package's limb code in
masked int64 (``ops/u32.py``); :func:`partition_cuts` is ``Partition.cuts``
over step-indexed windows.  Both are the plain twins of device functions
inside K19 (``csrc/fate.cu``), which runs the splitmix in native 64-bit
words.  The counter is formed in u32, as JAX forms it, so kernel and twins
agree on every input; the host function agrees with them while
``4n + k + 1 < 2**32``.

:func:`fate_mask` (K19) gives, per member and FIFO lane, whether the lane
is blocked at walk step ``t``: cut by the member's partition window,
dropped or held by its fate at the lane's datagram counter, or past the
member's horizon.  The walk kernel (K18) then advances each deliverable
lane's counter and clears the blocked lanes (``ensemble/engine.py``).

:func:`rate_threshold` turns a host rate into the exact u32 compare
(``fate / 2**32 < rate`` iff ``fate < ceil(rate * 2**32)``, with an
``always`` flag for rates within 2**-32 of 1).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..ops import cuda
from ..ops.u32 import M32, u32
from ..runtime.chaos import (  # noqa: F401  (re-exported for callers)
    FATE_DELAY,
    FATE_DRAWS,
    FATE_DROP,
    FATE_DUPLICATE,
    FATE_REORDER,
    _link_rng_seed,
)

# splitmix64 constants, split into u32 limbs.
_GAMMA_HI, _GAMMA_LO = 0x9E3779B9, 0x7F4A7C15  # 0x9E3779B97F4A7C15
_MIX1_HI, _MIX1_LO = 0xBF58476D, 0x1CE4E5B9  # 0xBF58476D1CE4E5B9
_MIX2_HI, _MIX2_LO = 0x94D049BB, 0x133111EB  # 0x94D049BB133111EB

# The member parameters K19 reads, by name: per lane [K, L] and per member
# [K] (``engine._member_params``).
LANE_PARAMS = ("link_hi", "link_lo", "drop_thr", "drop_always",
               "reorder_thr", "reorder_always", "src_group", "dst_group")
MEMBER_PARAMS = ("part_at", "part_heal", "horizon")


def _mul32x32(a, b):
    """Full 32x32 -> 64 product of u32 values as a (hi, lo) pair, through
    16-bit halves (no int64 intermediate reaches 2**63)."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    t = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = (ll & 0xFFFF) | ((t & 0xFFFF) << 16)
    hi = (hh + (lh >> 16) + (hl >> 16) + (t >> 16)) & M32
    return hi, lo


def _mul_lo32(a, b):
    """``a * b mod 2**32`` for u32 values."""
    return _mul32x32(a, b)[1]


def _add64(a_hi, a_lo, b_hi, b_lo):
    lo = (a_lo + b_lo) & M32
    carry = (lo < a_lo).to(torch.int64) if isinstance(lo, torch.Tensor) else int(lo < a_lo)
    return (a_hi + b_hi + carry) & M32, lo


def _mul64_lo(a_hi, a_lo, b_hi, b_lo):
    """Low 64 bits of a 64x64 product (the hi limbs wrap, as mod 2**64)."""
    hi, lo = _mul32x32(a_lo, b_lo)
    hi = (hi + _mul_lo32(a_lo, b_hi) + _mul_lo32(a_hi, b_lo)) & M32
    return hi, lo


def _xorshr64(hi, lo, r: int):
    """``z ^ (z >> r)`` for 0 < r < 32 on a (hi, lo) pair."""
    return hi ^ (hi >> r), lo ^ (((lo >> r) | (hi << (32 - r))) & M32)


def device_fault_fate(seed_hi, seed_lo, n, k) -> torch.Tensor:
    """The fate word (u32 as int64) for draw ``k`` of datagram ``n`` on the
    link whose 64-bit seed is the ``(seed_hi, seed_lo)`` u32 pair.  Tensor
    arguments (int32 bit-views or int64) and ints broadcast; bit-identical
    to ``runtime.chaos.fault_fate_u32(link_seed, n, k)`` for
    ``4n + k + 1 < 2**32``."""
    as64 = (lambda x: u32(x) if isinstance(x, torch.Tensor) else torch.tensor(x & M32))
    seed_hi, seed_lo, n, k = (as64(x) for x in (seed_hi, seed_lo, n, k))
    c = (4 * n + k + 1) & M32
    d_hi, d_lo = _mul32x32(c, _GAMMA_LO)
    d_hi = (d_hi + _mul_lo32(c, _GAMMA_HI)) & M32
    z_hi, z_lo = _add64(seed_hi, seed_lo, d_hi, d_lo)
    z_hi, z_lo = _xorshr64(z_hi, z_lo, 30)
    z_hi, z_lo = _mul64_lo(z_hi, z_lo, _MIX1_HI, _MIX1_LO)
    z_hi, z_lo = _xorshr64(z_hi, z_lo, 27)
    z_hi, z_lo = _mul64_lo(z_hi, z_lo, _MIX2_HI, _MIX2_LO)
    z_hi, _ = _xorshr64(z_hi, z_lo, 31)
    return z_hi


def link_seed_limbs(seed: int, src: int, dst: int) -> Tuple[int, int]:
    """The host per-link seed (``runtime.chaos._link_rng_seed``) as the
    (hi, lo) u32 pair the fate function consumes."""
    s = _link_rng_seed(int(seed), src, dst)
    return (s >> 32) & M32, s & M32


def rate_threshold(rate: float) -> Tuple[int, bool]:
    """``(threshold, always)`` such that the host decision
    ``fate / 2**32 < rate`` equals ``always or fate < threshold`` for
    every u32 ``fate``; ``always`` covers rates within 2**-32 of 1.0, whose
    ceiling (2**32) does not fit a u32 threshold."""
    rate = float(rate)
    if not 0.0 <= rate <= 1.0 or math.isnan(rate):
        raise ValueError(f"fault rate must be in [0, 1]: {rate!r}")
    thr = math.ceil(rate * 4294967296.0)  # exact: power-of-two multiply
    if thr >= 1 << 32:
        return 0, True
    return int(thr), False


def partition_cuts(src_group, dst_group, step, at_step, heal_step) -> torch.Tensor:
    """``Partition.cuts`` with step-indexed windows: True where the window
    is active (``at_step <= step``, and ``step < heal_step`` unless
    ``heal_step < 0``, never healing) and src and dst sit in different
    groups (a group id < 0 is in no group).  int32 arguments broadcast."""
    t = (lambda x: x.to(torch.int64) if isinstance(x, torch.Tensor) else torch.tensor(int(x)))
    src_group, dst_group, step, at_step, heal_step = (
        t(x) for x in (src_group, dst_group, step, at_step, heal_step))
    active = (step >= at_step) & ((heal_step < 0) | (step < heal_step))
    return active & (src_group >= 0) & (dst_group >= 0) & (src_group != dst_group)


def fate_mask_plain(t: int, ctr: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Plain-torch twin of K19: ``bool[K, L]``, True where member k's lane
    l is blocked at step ``t`` -- its partition cut, its drop or reorder
    fate at datagram ``ctr[k, l]`` (int32 bit-views), or ``t`` past the
    member's horizon (the JAX ``FateLaneHook.apply``'s masked lanes and
    ``t < horizon``)."""
    p = params
    drop = device_fault_fate(p["link_hi"], p["link_lo"], ctr, FATE_DROP)
    reorder = device_fault_fate(p["link_hi"], p["link_lo"], ctr, FATE_REORDER)
    cut = partition_cuts(p["src_group"], p["dst_group"], t,
                         p["part_at"][:, None], p["part_heal"][:, None])
    masked = (
        cut
        | p["drop_always"] | (drop < u32(p["drop_thr"]))
        | p["reorder_always"] | (reorder < u32(p["reorder_thr"]))
    )
    return masked | ~(t < p["horizon"])[:, None]


def fate_mask(t: int, ctr: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The blocked lanes of every member at walk step ``t`` (K19): see
    :func:`fate_mask_plain`.  ``ctr`` is ``int32[K, L]``; the lane
    parameters are ``[K, L]`` and the member parameters ``[K]`` tensors on
    its device (u32 words as int32 bit-views, flags bool)."""
    if ctr.device.type == "cpu":
        return fate_mask_plain(t, ctr, params)
    dev = ctr.device
    cuda.require(ctr, "ctr", torch.int32, 2, dev)
    k, lanes = ctr.shape
    for name in LANE_PARAMS:
        x = params[name]
        cuda.require(x, name, x.dtype, 2, dev)
        if tuple(x.shape) != (k, lanes):
            raise ValueError(f"{name} must be [{k}, {lanes}], got {tuple(x.shape)}")
    for name in ("drop_always", "reorder_always"):
        if params[name].dtype != torch.bool:
            raise TypeError(f"{name} must be bool")
    for name in MEMBER_PARAMS:
        cuda.require(params[name], name, torch.int32, 1, dev)
        if params[name].shape[0] != k:
            raise ValueError(f"{name} must be [{k}]")
    blocked = torch.empty((k, lanes), dtype=torch.bool, device=dev)
    fn = cuda.function(
        "fate", "sr_fate_mask",
        [cuda.I32, cuda.I64, cuda.I32] + [cuda.P] * 13 + [cuda.P],
    )
    fate_mask.launches += 1
    p = params
    code = fn(
        int(t), k, lanes, cuda.ptr(ctr),
        *(cuda.ptr(p[name]) for name in LANE_PARAMS),
        *(cuda.ptr(p[name]) for name in MEMBER_PARAMS),
        cuda.ptr(blocked), cuda.stream(blocked),
    )
    cuda.check(code, "fate", "fate_mask")
    return blocked


fate_mask.launches = 0
