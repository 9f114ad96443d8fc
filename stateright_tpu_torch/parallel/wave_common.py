"""Wave evaluation and stream compaction (kernel K3).

The counterpart of ``stateright_tpu/parallel/wave_common.py``: property
evaluation at expansion time (the pop-time analog of src/checker/
bfs.rs:230-281), eventually-bit clearing, successor expansion and terminal
eventually-counterexample detection, plus the stable compaction every
later stage of a wave is built on.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..core.model import Expectation
from ..ops import cuda

NO_ID = 0xFFFFFFFF


def compact(mask: torch.Tensor, size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable stream compaction of lane indices: ``out[j]`` is the j-th set
    lane ``i`` of ``mask``, in lane order, for ``j < size``; the rest of
    ``out`` is zero and set lanes past ``size`` are dropped.  Returns
    ``(out int32[size], count)`` with ``count`` the int64 scalar tensor of
    ALL set lanes -- the caller's overflow test is ``count > size``
    (exactly full at ``count == size``).

    The JAX ``compact`` takes a values array; every call on the port's path
    compacts ``arange`` lanes, so the lane index is the value.  It returns
    only ``out``; the count comes free from the kernel's scan, so the port
    returns it instead of a second reduction."""
    if mask.device.type == "cpu":
        return compact_plain(mask, size)
    dev = mask.device
    cuda.require(mask, "mask", torch.bool, 1, dev)
    n = mask.shape[0]
    out = torch.zeros((size,), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int64, device=dev)
    scratch = torch.empty(((n + 2047) // 2048,), dtype=torch.int64, device=dev)
    fn = cuda.function(
        "compact", "sr_compact",
        [cuda.P, cuda.I64, cuda.P, cuda.I64, cuda.P, cuda.P, cuda.P],
    )
    compact.launches += 1
    code = fn(
        cuda.ptr(mask), n, cuda.ptr(out), size, cuda.ptr(scratch),
        cuda.ptr(count), cuda.stream(),
    )
    cuda.check(code, "compact", "compact")
    return out, count


compact.launches = 0


def compact_plain(
    mask: torch.Tensor, size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of the K3 kernel (any device): the JAX idiom of a
    cumsum and a scatter whose index ``size`` means "no write"."""
    n = mask.shape[0]
    lanes = torch.arange(n, dtype=torch.int32, device=mask.device)
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    idx = torch.where(mask, pos, torch.full_like(pos, size))
    buf = torch.zeros((size + 1,), dtype=torch.int32, device=mask.device)
    buf.scatter_(0, idx.clamp(max=size), lanes)
    if n == 0:
        return buf[:size].clone(), torch.zeros((), dtype=torch.int64, device=mask.device)
    return buf[:size].clone(), pos[-1] + 1


def make_finish_when_device(fw, props):
    """Mirror of ``HasDiscoveries.matches()`` checked before every wave, as
    the JAX loop checks it in its device loop condition: returns
    ``fn(found: Sequence[bool]) -> bool``.  Policies that match with zero
    discoveries return False here, so the first wave still runs (the host
    check after the wave then stops the run, as in the reference)."""
    n_props = len(props)
    fail_idx = [
        i for i, p in enumerate(props) if p.expectation.discovery_is_failure
    ]
    name_idx = {p.name: i for i, p in enumerate(props)}
    named = [name_idx[n] for n in sorted(fw._names) if n in name_idx]
    names_all_known = all(n in name_idx for n in fw._names)
    kind = fw._kind

    def matched(found: Sequence[bool]) -> bool:
        if kind == "all":
            return all(found) if n_props else False
        if kind == "any":
            return any(found) if n_props else False
        if kind == "any_failures":
            return any(found[i] for i in fail_idx) if fail_idx else False
        if kind == "all_failures":
            return all(found[i] for i in fail_idx) if fail_idx else False
        if kind == "all_of":
            if not names_all_known or not named:
                return False
            return all(found[i] for i in named)
        if kind == "any_of":
            return any(found[i] for i in named) if named else False
        raise ValueError(kind)

    return matched


class WaveEval(NamedTuple):
    disc_cand: torch.Tensor  # int64[P]: first hit's BFS position, NO_ID none
    eb: torch.Tensor  # int32[F]: eventually-bits after the state's own clears
    nexts: torch.Tensor  # int32[F, A, W] successor candidates
    valid: torch.Tensor  # bool[F, A]; its count is the generated count
    step_flag: Optional[torch.Tensor]  # bool scalar: encoding overflow


def wave_eval(cm, props, ev_indices: List[int], states: torch.Tensor,
              start_id: int, eb_in: torch.Tensor,
              discovered: Sequence[bool]) -> WaveEval:
    """One wave's expansion and property evaluation (everything but the
    dedup and the append).  ``states`` are the wave's F active rows, whose
    BFS positions are ``start_id + arange(F)``; ``discovered`` says which
    properties had a discovery when the wave started (a host list -- the
    engine keeps discoveries on the host).

    The JAX version folds candidates into the discovery vector on device;
    here the candidates come back per property and the engine folds them
    first-writer-wins once the wave commits.  The generated count the JAX
    version returns is the count of ``valid``, which the engine's
    compaction of ``valid`` yields anyway."""
    dev = states.device
    f = states.shape[0]
    nexts, valid, conds, step_flag = cm.expand(states)
    no_id = torch.tensor(NO_ID, dtype=torch.int64, device=dev)
    cands = [no_id] * len(props)

    def first_hit(hit):
        # argmax of a bool vector is its first True lane.
        idx = torch.argmax(hit.to(torch.uint8)).to(torch.int64) + start_id
        return torch.where(hit.any(), idx, no_id)

    # "Awaiting discoveries": the reference stops expanding a state when
    # every property already has a discovery and this state contributes
    # none (src/checker/bfs.rs:231-281), against the discoveries as of wave
    # start.
    awaiting = torch.zeros((f,), dtype=torch.bool, device=dev)
    for p, prop in enumerate(props):
        if prop.expectation is Expectation.ALWAYS:
            if not discovered[p]:
                awaiting |= conds[:, p]
            cands[p] = first_hit(~conds[:, p])
        elif prop.expectation is Expectation.SOMETIMES:
            if not discovered[p]:
                awaiting |= ~conds[:, p]
            cands[p] = first_hit(conds[:, p])
        elif not discovered[p]:  # EVENTUALLY: discovered only at trace ends
            awaiting[:] = True

    # Clear this state's own satisfied eventually bits.
    eb = eb_in
    for bit, p in enumerate(ev_indices):
        eb = eb & ~(conds[:, p].to(torch.int32) << bit)

    # With zero properties nothing is ever awaited and the reference
    # expands nothing at all -- the gate reproduces that too.
    valid = valid & awaiting[:, None]

    # Terminal states with leftover ebits -> eventually counterexamples
    # (src/checker/bfs.rs:326-333).
    if ev_indices:
        terminal = ~valid.any(dim=1)
        for bit, p in enumerate(ev_indices):
            cands[p] = first_hit(terminal & (((eb >> bit) & 1) == 1))

    return WaveEval(torch.stack(cands), eb, nexts, valid, step_flag)
