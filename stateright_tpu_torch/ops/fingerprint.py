"""Stable 64-bit state fingerprinting (host side).

A copy of the JAX package's ``ops/fingerprint.py`` minus its native
dispatch: a state is lowered to a canonical sequence of ``uint32`` words
(``canon_words``) and hashed by two independent murmur3-style 32-bit lanes
whose concatenation is the 64-bit fingerprint (``fp64_words``).  The device
version (``ops/device_fp.py``) computes the identical function over packed
rows, so the port's engine, its path reconstruction and the JAX package all
agree on every fingerprint.

Fingerprints are nonzero (reference: ``Fingerprint = NonZeroU64``,
src/lib.rs:341): zero marks an empty hash-table slot, and all-ones is
remapped too (``_remap_fp``).
"""

from __future__ import annotations

import dataclasses
import enum
import struct
from typing import Any, Iterable, List

M32 = 0xFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF

# Murmur3 scramble constants.
_C1 = 0xCC9E2D51
_C2 = 0x1B873593

# Arbitrary fixed lane seeds: the analog of the reference's fixed ahash keys
# (src/lib.rs:374-377), which make fingerprints stable across builds/runs.
SEED_HI = 0x9E3779B9
SEED_LO = 0x85EBCA6B


def _mix32(h: int, w: int) -> int:
    k = (w * _C1) & M32
    k = ((k << 15) | (k >> 17)) & M32
    k = (k * _C2) & M32
    h ^= k
    h = ((h << 13) | (h >> 19)) & M32
    h = (h * 5 + 0xE6546B64) & M32
    return h


def _fmix32(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    h ^= h >> 16
    return h


def fp64_words(words: Iterable[int]) -> int:
    """Hash a sequence of uint32 words to a nonzero 64-bit fingerprint."""
    h1 = SEED_HI
    h2 = SEED_LO
    n = 0
    for w in words:
        w &= M32
        h1 = _mix32(h1, w)
        h2 = _mix32(h2, w)
        n += 1
    h1 = _fmix32(h1 ^ n)
    h2 = _fmix32(h2 ^ (n * 0x9E3779B1 & M32))
    return _remap_fp((h1 << 32) | h2)


def _remap_fp(fp: int) -> int:
    """Steer the two reserved 64-bit values away from real fingerprints:
    zero marks empty hash-table slots, all-ones is reserved as the JAX
    package's inactive-lane sentinel.  Must stay bit-identical to the
    device remap (``device_fp._remap_pair`` and the K1 kernel)."""
    if fp == 0:
        return 1
    if fp == M64:
        return M64 - 1
    return fp


# --- Canonical encoding of host Python values to uint32 words ---------------

TAG_NONE = 0x4E4F4E45  # 'NONE'
TAG_BOOL = 0x424F4F4C  # 'BOOL'
TAG_INT = 0x494E5431
TAG_BIGINT = 0x494E5442
TAG_FLOAT = 0x464C5431
TAG_STR = 0x53545231
TAG_BYTES = 0x42595431
TAG_SEQ = 0x53455131
TAG_SET = 0x53455431
TAG_MAP = 0x4D415031
TAG_OBJ = 0x4F424A31

_type_digest_cache: dict = {}


def _type_digest(cls: type) -> int:
    d = _type_digest_cache.get(cls)
    if d is None:
        name = cls.__qualname__.encode()
        d = fp64_words(_bytes_to_words(name)) & M32
        _type_digest_cache[cls] = d
    return d


def _bytes_to_words(b: bytes) -> List[int]:
    out = [len(b)]
    pad = (-len(b)) % 4
    padded = b + b"\x00" * pad
    out.extend(struct.unpack("<%dI" % (len(padded) // 4), padded))
    return out


def canon_words(obj: Any, out: List[int]) -> None:
    """Append the canonical uint32-word encoding of ``obj`` to ``out``.

    Deterministic across processes (independent of PYTHONHASHSEED, dict
    order, or set order) — the analog of the reference's stable hasher.
    """
    if obj is None:
        out.append(TAG_NONE)
    elif obj is True:
        out.append(TAG_BOOL)
        out.append(1)
    elif obj is False:
        out.append(TAG_BOOL)
        out.append(0)
    elif type(obj) is int:
        if -0x8000000000000000 <= obj < 0x8000000000000000:
            u = obj & M64
            out.append(TAG_INT)
            out.append(u & M32)
            out.append((u >> 32) & M32)
        else:
            b = obj.to_bytes((obj.bit_length() + 15) // 8, "little", signed=True)
            out.append(TAG_BIGINT)
            out.extend(_bytes_to_words(b))
    elif type(obj) is str:
        out.append(TAG_STR)
        out.extend(_bytes_to_words(obj.encode()))
    elif type(obj) is bytes:
        out.append(TAG_BYTES)
        out.extend(_bytes_to_words(obj))
    elif type(obj) is float:
        out.append(TAG_FLOAT)
        (u,) = struct.unpack("<Q", struct.pack("<d", obj))
        out.append(u & M32)
        out.append((u >> 32) & M32)
    elif type(obj) is tuple or type(obj) is list:
        out.append(TAG_SEQ)
        out.append(len(obj))
        for item in obj:
            canon_words(item, out)
    elif type(obj) is frozenset or type(obj) is set:
        # Order-insensitive: sorted element digests (reference src/util.rs:137-159).
        out.append(TAG_SET)
        out.append(len(obj))
        for fp in sorted(fingerprint(e) for e in obj):
            out.append(fp & M32)
            out.append((fp >> 32) & M32)
    elif type(obj) is dict:
        out.append(TAG_MAP)
        out.append(len(obj))
        for fp in sorted(fingerprint((k, v)) for k, v in obj.items()):
            out.append(fp & M32)
            out.append((fp >> 32) & M32)
    else:
        cw = getattr(obj, "__canon_words__", None)
        if cw is not None:
            cw(out)
        elif isinstance(obj, enum.Enum):
            out.append(TAG_OBJ)
            out.append(_type_digest(type(obj)))
            canon_words(obj.name, out)
        elif dataclasses.is_dataclass(obj):
            out.append(TAG_OBJ)
            out.append(_type_digest(type(obj)))
            for f in dataclasses.fields(obj):
                canon_words(getattr(obj, f.name), out)
        elif isinstance(obj, int):  # int subclasses (e.g. actor Id)
            out.append(TAG_INT)
            u = int(obj) & M64
            out.append(u & M32)
            out.append((u >> 32) & M32)
        elif isinstance(obj, (tuple, list)):
            out.append(TAG_SEQ)
            out.append(len(obj))
            for item in obj:
                canon_words(item, out)
        elif isinstance(obj, str):
            out.append(TAG_STR)
            out.extend(_bytes_to_words(obj.encode()))
        else:
            raise TypeError(
                f"cannot canonically encode {type(obj).__name__!r}; "
                "define __canon_words__(self, out) or use hashable plain data"
            )


def _is_frozen_dataclass(obj: Any) -> bool:
    params = getattr(type(obj), "__dataclass_params__", None)
    return params is not None and params.frozen


def fingerprint(obj: Any) -> int:
    """Stable nonzero 64-bit fingerprint of a host state value.

    Reference: ``fingerprint`` in src/lib.rs:344-349.

    The digest is memoized on the instance, but only for *frozen* dataclass
    states: a mutable object could be ``copy.copy``'d and mutated, silently
    inheriting the parent's stale digest — an unsoundness (missed states),
    not just a perf bug.  Frozen instances can't take that path.
    """
    if _is_frozen_dataclass(obj):
        cached = getattr(obj, "_cached_fp", None)
        if cached is not None:
            return cached
        words: List[int] = []
        canon_words(obj, words)
        fp = fp64_words(words)
        try:
            object.__setattr__(obj, "_cached_fp", fp)
        except AttributeError:
            pass  # slots=True dataclass: no __dict__ to cache in
        return fp
    words = []
    canon_words(obj, words)
    return fp64_words(words)
