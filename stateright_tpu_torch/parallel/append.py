"""The wave's append (K25, ``csrc/append.cu``).

The counterpart of the JAX engine's append (``stateright_tpu/parallel/
wavefront.py:1666`` ``t_append``, the same code as the fused loop's):
the new representatives of a committed wave -- their successor rows,
parents and eventually-bits -- land at the log tail, in the order K3
compacted the insert's new mask (on the sorted path, through the buffer
lanes of the representatives).  :func:`append_block` writes them in one
launch on a CUDA tensor, IN PLACE on the log, parent and ebits tensors
(the JAX engine returns updated buffers); :func:`append_block_plain` is
its plain-torch twin, which runs for CPU tensors.  Every commit of the
wavefront checker -- untraced, traced and tiered -- goes through here.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import cuda
from ..ops.u32 import i32


def append_block(rows: torch.Tensor, parent: torch.Tensor,
                 ebits: torch.Tensor, sel: torch.Tensor,
                 u_origin: Optional[torch.Tensor], v_orig: torch.Tensor,
                 cand_rows: torch.Tensor, eb: torch.Tensor, lo_pos: int,
                 tail: int, n_new: int, a: int, two_phase: bool) -> None:
    """Write the ``n_new`` new states of a wave at log positions ``tail ..``:

    - ``rows[(tail + j) * W ..]`` = ``cand_rows[lane]`` on two-phase waves
      (the successors are compacted), ``cand_rows[v_orig[lane]]`` on
      single-phase ones;
    - ``parent[tail + j]`` = ``lo_pos + v_orig[lane] // a``;
    - ``ebits[tail + j]`` = ``eb[v_orig[lane] // a]``;

    where ``lane = sel[j]``, or ``u_origin[sel[j]]`` on the sorted path.
    ``rows`` is the flat int32 log, ``cand_rows`` int32 ``[N, W]``,
    ``sel``/``u_origin``/``v_orig``/``eb``/``parent``/``ebits`` int32."""
    if rows.device.type == "cpu":
        append_block_plain(rows, parent, ebits, sel, u_origin, v_orig,
                           cand_rows, eb, lo_pos, tail, n_new, a, two_phase)
        return
    if n_new == 0:
        return  # nothing to launch
    dev = rows.device
    for t, name, ndim in (
        (rows, "rows", 1), (parent, "parent", 1), (ebits, "ebits", 1),
        (sel, "sel", 1), (v_orig, "v_orig", 1), (cand_rows, "cand_rows", 2),
        (eb, "eb", 1),
    ):
        cuda.require(t, name, torch.int32, ndim, dev)
    if u_origin is not None:
        cuda.require(u_origin, "u_origin", torch.int32, 1, dev)
    w = cand_rows.shape[1]
    if n_new < 0 or n_new > sel.shape[0]:
        raise ValueError(f"n_new={n_new} outside the {sel.shape[0]}-lane buffer")
    if (tail + n_new) * w > rows.shape[0] or tail + n_new > min(
        parent.shape[0], ebits.shape[0]
    ):
        raise ValueError("the append runs past the end of the log")
    if a < 1 or w < 1:
        raise ValueError("a and the row width must be positive")
    fn = cuda.function(
        "append", "sr_append_block",
        [cuda.P, cuda.P, cuda.P, cuda.P, cuda.P, cuda.P, cuda.P, cuda.P,
         cuda.I64, cuda.I64, cuda.I64, cuda.I32, cuda.I32, cuda.I32, cuda.P],
    )
    append_block.launches += 1
    code = fn(
        cuda.ptr(rows), cuda.ptr(parent), cuda.ptr(ebits), cuda.ptr(sel),
        cuda.P(None) if u_origin is None else cuda.ptr(u_origin),
        cuda.ptr(v_orig), cuda.ptr(cand_rows), cuda.ptr(eb), lo_pos, tail,
        n_new, a, w, int(two_phase), cuda.stream(rows),
    )
    cuda.check(code, "append", "append_block")


append_block.launches = 0


def append_block_plain(rows, parent, ebits, sel, u_origin, v_orig,
                       cand_rows, eb, lo_pos, tail, n_new, a,
                       two_phase) -> None:
    """Plain-torch twin of K25 (any device): the gathers, index casts and
    three slice writes the wave's commit ran before K25."""
    if not n_new:
        return
    w = cand_rows.shape[1]
    lanes = sel[:n_new].long()
    if u_origin is not None:
        lanes = u_origin[lanes].long()
    idxs = v_orig[lanes].long()
    src = idxs // a
    rows_new = cand_rows[lanes] if two_phase else cand_rows[idxs]
    rows[tail * w : (tail + n_new) * w] = rows_new.reshape(-1)
    parent[tail : tail + n_new] = i32(src + lo_pos)
    ebits[tail : tail + n_new] = eb[src]


def append_block_dev(rows: torch.Tensor, parent: torch.Tensor,
                     ebits: torch.Tensor, sel: torch.Tensor,
                     u_origin: Optional[torch.Tensor], v_orig: torch.Tensor,
                     cand_rows: torch.Tensor, eb: torch.Tensor,
                     wave: torch.Tensor, a: int, two_phase: bool) -> None:
    """K25's device-count entry, for the fused wave loop: :func:`append_block`
    with ``(lo_pos, tail, n_new)`` the three int32 words of ``wave`` (K29's
    record of the wave it closed: ``n_new`` is 0 for a wave that did not
    commit), read on the card."""
    if rows.device.type == "cpu":
        append_block_dev_plain(rows, parent, ebits, sel, u_origin, v_orig,
                               cand_rows, eb, wave, a, two_phase)
        return
    dev = rows.device
    for t, name, ndim in (
        (rows, "rows", 1), (parent, "parent", 1), (ebits, "ebits", 1),
        (sel, "sel", 1), (v_orig, "v_orig", 1), (cand_rows, "cand_rows", 2),
        (eb, "eb", 1), (wave, "wave", 1),
    ):
        cuda.require(t, name, torch.int32, ndim, dev)
    if u_origin is not None:
        cuda.require(u_origin, "u_origin", torch.int32, 1, dev)
    if wave.shape[0] < 3 or a < 1:
        raise ValueError("wave holds (lo_pos, tail, n_new); a must be positive")
    fn = cuda.function(
        "append", "sr_append_block_dev",
        [cuda.P, cuda.P, cuda.P, cuda.P, cuda.P, cuda.P, cuda.P, cuda.P,
         cuda.P, cuda.I64, cuda.I32, cuda.I32, cuda.I32, cuda.P],
    )
    append_block_dev.launches += 1
    code = fn(
        cuda.ptr(rows), cuda.ptr(parent), cuda.ptr(ebits), cuda.ptr(sel),
        cuda.P(None) if u_origin is None else cuda.ptr(u_origin),
        cuda.ptr(v_orig), cuda.ptr(cand_rows), cuda.ptr(eb), cuda.ptr(wave),
        sel.shape[0], a, cand_rows.shape[1], int(two_phase), cuda.stream(rows),
    )
    cuda.check(code, "append", "append_block_dev")


append_block_dev.launches = 0


def append_block_dev_plain(rows, parent, ebits, sel, u_origin, v_orig,
                           cand_rows, eb, wave, a, two_phase) -> None:
    """Plain-torch twin of K25's device-count entry (any device)."""
    lo_pos, tail, n_new = (int(x) & 0xFFFFFFFF for x in wave[:3].tolist())
    append_block_plain(rows, parent, ebits, sel, u_origin, v_orig, cand_rows,
                       eb, lo_pos, tail, n_new, a, two_phase)
