"""Symmetry canonicalization of packed rows (kernel K15).

The counterpart of ``stateright_tpu/parallel/canon.py``.  A packed state
row's symmetric *record block* -- one fixed-width record per symmetric
process -- is stably sorted by the records' non-Id fields in declaration
order, the permutation is applied to every per-record field, and Id-valued
fields (a field whose value is a record index) are remapped through it;
values ``>= n`` pass unchanged.  Under ``symmetry()`` the engine dedups on
the fingerprint of the canonical row while it logs the original (the
reference's ``representative``, src/checker/dfs.rs:309-334).

The spec is the whole record (every per-record field is a key), so the
canonical form is an orbit invariant and the counts do not depend on the
traversal: 2pc rm=5 reduces to its 314 orbits at any chunk width.  The
canonicalization only ever applies a genuine record permutation, so a
weaker spec costs reduction, never soundness.

:func:`canonicalize_rows` launches ``csrc/canon.cu`` on a CUDA tensor and
runs :func:`canonicalize_rows_plain`, its plain-torch twin, on a CPU
tensor.  Words are int32 bit-views of the packed uint32 words.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops import cuda
from ..ops.u32 import M32, i32, u32

# The kernel's compile-time caps (``csrc/canon.cu``): records, per-record
# fields and global Id fields.  2pc at its widest needs 12 and 3.
MAX_RECORDS = 16
MAX_FIELDS = 4
MAX_ID_FIELDS = 4


class CanonField(NamedTuple):
    """One per-record field of a symmetric record block.

    Record ``i``'s value lives at bits ``[shift + i*bit_stride, ... +
    width)`` of word ``word + i*word_stride``.  Bit-packed layouts use
    ``word_stride=0, bit_stride=width``; word-aligned ones ``bit_stride=0,
    word_stride=k``.  ``is_id`` marks a field whose value is a record
    index: it is no sort key and is remapped through the permutation;
    values ``>= n`` pass unchanged."""

    word: int
    shift: int
    width: int
    bit_stride: int
    word_stride: int
    is_id: bool


def field(
    word: int,
    shift: int,
    width: int,
    *,
    bit_stride: Optional[int] = None,
    word_stride: int = 0,
    is_id: bool = False,
) -> CanonField:
    """Build a :class:`CanonField`; ``bit_stride`` defaults to ``width``
    for bit-packed fields and to 0 when ``word_stride`` is given."""
    if bit_stride is None:
        bit_stride = 0 if word_stride else width
    return CanonField(word, shift, width, bit_stride, word_stride, is_id)


class CanonSpec(NamedTuple):
    """The canonicalization a compiled model declares through
    ``CompiledModel.canon_spec()``.

    ``n``: the number of symmetric records; ``fields``: the per-record
    fields, the non-Id ones the stable sort's key in declaration order
    (declare every per-record field); ``id_fields``: global locations
    holding a record index.  An empty spec (``n <= 1`` or no fields) is
    the identity."""

    n: int
    fields: Tuple[CanonField, ...] = ()
    id_fields: Tuple[CanonField, ...] = ()


def validate_spec(
    spec: CanonSpec, state_width: int, fp_words: Optional[int] = None
) -> None:
    """Refuse a malformed spec at spawn, before any wave runs: an
    out-of-range read would merge unrelated states.  Sort-key fields must
    lie inside the ``fp_words`` identity prefix (a key read past it would
    split states that plain dedup merges); Id fields may lie anywhere."""
    n = spec.n
    if n < 0:
        raise ValueError(f"canon_spec: n must be >= 0, got {n}")
    for f in spec.fields:
        if f.width <= 0 or f.width > 32:
            raise ValueError(f"canon_spec: field width out of range: {f}")
        last_word = f.word + max(n - 1, 0) * f.word_stride
        last_shift = f.shift + max(n - 1, 0) * f.bit_stride
        if f.word < 0 or last_word >= state_width:
            raise ValueError(
                f"canon_spec: field spans words outside the "
                f"{state_width}-word row: {f}"
            )
        if f.shift < 0 or last_shift + f.width > 32:
            raise ValueError(
                f"canon_spec: field bits exceed a 32-bit word "
                f"(n={n}): {f}"
            )
        if f.bit_stride and f.bit_stride < f.width:
            raise ValueError(
                f"canon_spec: records overlap (bit_stride < width): {f}"
            )
        if (
            fp_words is not None
            and fp_words < state_width
            and not f.is_id
            and last_word >= fp_words
        ):
            raise ValueError(
                f"canon_spec: sort-key field reads words beyond the "
                f"fp_words={fp_words} identity prefix; the permutation "
                f"would depend on non-identity data and split states "
                f"plain dedup merges: {f}"
            )
    for g in spec.id_fields:
        if g.width <= 0 or g.width > 32 or g.shift + g.width > 32:
            raise ValueError(f"canon_spec: id field bits out of range: {g}")
        if g.word < 0 or g.word >= state_width:
            raise ValueError(
                f"canon_spec: id field outside the {state_width}-word "
                f"row: {g}"
            )
        if (1 << g.width) < n:
            raise ValueError(
                f"canon_spec: id field too narrow to hold indices "
                f"0..{n - 1}: {g}"
            )


def is_identity(spec: CanonSpec) -> bool:
    """The empty spec: the canonical form is the row itself."""
    return spec.n <= 1 or not spec.fields


# --- the twin --------------------------------------------------------------


def _extract(x: torch.Tensor, f: CanonField, n: int) -> torch.Tensor:
    """Per-record values of one field: int64[B, n] from u32 words ``x``."""
    mask = (1 << f.width) - 1
    return torch.stack(
        [
            (x[:, f.word + i * f.word_stride] >> (f.shift + i * f.bit_stride))
            & mask
            for i in range(n)
        ],
        dim=1,
    )


def canonicalize_rows_plain(spec: CanonSpec, rows: torch.Tensor) -> torch.Tensor:
    """Plain-torch twin of K15 (any device): ``int32[B, W] -> int32[B,
    W]``, the JAX ``canonicalize`` row by row.  The stable sort is a
    stable ``torch.sort`` pass per key, last key first; keys are u32
    values carried in int64, so they order unsigned."""
    n = spec.n
    if is_identity(spec):
        return rows
    b = rows.shape[0]
    x = u32(rows)
    vals = [_extract(x, f, n) for f in spec.fields]
    iota = torch.arange(n, dtype=torch.int64, device=rows.device)
    order = iota.expand(b, n).contiguous()  # order[new] = old
    for f, v in reversed(list(zip(spec.fields, vals))):
        if f.is_id:
            continue
        _, idx = torch.sort(v.gather(1, order), dim=1, stable=True)
        order = order.gather(1, idx)
    mapping = torch.empty_like(order).scatter_(1, order, iota.expand(b, n))

    def remap_ids(pv):
        safe = pv.clamp(max=n - 1)
        return torch.where(pv < n, mapping.gather(1, safe), pv)

    out = x.clone()
    for f, v in zip(spec.fields, vals):
        pv = v.gather(1, order)  # new position i holds old record order[i]
        if f.is_id:
            pv = remap_ids(pv)
        if f.word_stride == 0:
            clear = 0
            bits = torch.zeros((b,), dtype=torch.int64, device=rows.device)
            for i in range(n):
                sh = f.shift + i * f.bit_stride
                clear |= ((1 << f.width) - 1) << sh
                bits = bits | (pv[:, i] << sh)
            out[:, f.word] = (out[:, f.word] & (~clear & M32)) | bits
        else:
            mask = ((1 << f.width) - 1) << f.shift
            for i in range(n):
                wi = f.word + i * f.word_stride
                out[:, wi] = (out[:, wi] & (~mask & M32)) | (pv[:, i] << f.shift)
    for g in spec.id_fields:
        mask = (1 << g.width) - 1
        val = (out[:, g.word] >> g.shift) & mask
        nv = remap_ids(val.unsqueeze(1)).squeeze(1)
        out[:, g.word] = (out[:, g.word] & (~(mask << g.shift) & M32)) | (
            nv << g.shift
        )
    return i32(out)


# --- the kernel's wrapper ----------------------------------------------------


def spec_words(spec: CanonSpec) -> list:
    """The spec as the kernel reads it: ``n``, the field count, the Id
    field count, then six words per field (``word, shift, width,
    bit_stride, word_stride, is_id``) and per Id field."""
    words = [spec.n, len(spec.fields), len(spec.id_fields)]
    for f in (*spec.fields, *spec.id_fields):
        words.extend([f.word, f.shift, f.width, f.bit_stride, f.word_stride,
                      int(f.is_id)])
    return words


def check_caps(spec: CanonSpec) -> None:
    """Refuse a spec past the kernel's compile-time caps."""
    if (
        spec.n > MAX_RECORDS
        or len(spec.fields) > MAX_FIELDS
        or len(spec.id_fields) > MAX_ID_FIELDS
    ):
        raise ValueError(
            f"canonicalize_rows: the kernel takes at most {MAX_RECORDS} "
            f"records, {MAX_FIELDS} fields and {MAX_ID_FIELDS} id fields; "
            f"got n={spec.n}, {len(spec.fields)} and {len(spec.id_fields)}"
        )


def canonicalize_rows(spec: CanonSpec, rows: torch.Tensor) -> torch.Tensor:
    """The canonical form of each packed row ``int32[B, W]`` (K15; see
    :func:`canonicalize_rows_plain`).  The empty spec returns ``rows``
    and launches nothing.  The spec is validated against the rows'
    width first: the kernel trusts every word index it is given."""
    if is_identity(spec):
        return rows
    validate_spec(spec, rows.shape[1])
    if rows.device.type != "cpu":
        check_caps(spec)
    return _canonicalize(spec, rows)


def _canonicalize(spec: CanonSpec, rows: torch.Tensor) -> torch.Tensor:
    """:func:`canonicalize_rows` for a spec already validated against the
    rows' width and the caps: the twin on a CPU tensor, else K15."""
    if rows.device.type == "cpu":
        return canonicalize_rows_plain(spec, rows)
    cuda.require(rows, "rows", torch.int32, 2, rows.device)
    b, w = rows.shape
    out = torch.empty_like(rows)
    words = spec_words(spec)
    arr = (cuda.I32 * len(words))(*words)
    fn = cuda.function(
        "canon", "sr_canonicalize",
        [cuda.P, cuda.I64, cuda.I32, cuda.P, cuda.I32, cuda.P, cuda.P],
    )
    canonicalize_rows.launches += 1
    code = fn(cuda.ptr(rows), b, w, arr, len(words), cuda.ptr(out),
              cuda.stream(out))
    cuda.check(code, "canon", "canonicalize_rows")
    return out


canonicalize_rows.launches = 0


def make_canon(cm):
    """Resolve a compiled model's canonicalization over row batches: its
    overridden ``canon_rows`` if it defines one, else K15 over its
    ``canon_spec()`` (the identity for an empty spec), else None -- the
    engine then refuses ``symmetry()`` loudly rather than report an
    unreduced run as reduced.  The spec is validated and held to the
    kernel's caps here, once, at spawn."""
    from .compiled import CompiledModel

    if type(cm).canon_rows is not CompiledModel.canon_rows:
        return cm.canon_rows
    spec = cm.canon_spec()
    if spec is None:
        return None
    validate_spec(spec, cm.state_width, fp_words=cm.fp_words)
    if is_identity(spec):
        return lambda rows: rows
    check_caps(spec)
    return functools.partial(_canonicalize, spec)
