"""Wave evaluation (kernel K8) and stream compaction (kernel K3).

The counterpart of ``stateright_tpu/parallel/wave_common.py``: property
evaluation at expansion time (the pop-time analog of src/checker/
bfs.rs:230-281), eventually-bit clearing, successor expansion and terminal
eventually-counterexample detection, plus the stable compaction every
later stage of a wave is built on.  The engine runs the model's device
functions and :func:`wave_eval` (K8, ``csrc/wave_eval.cu``) turns their
conds and validity into the wave's verdicts.
"""

from __future__ import annotations

from typing import Sequence, Tuple

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
        cuda.ptr(count), cuda.stream(mask),
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


def finish_when_trivially_true(fw, props) -> bool:
    """Policies that match with zero discoveries (ALL with no properties,
    ALL_FAILURES with no failure property, ALL_OF nothing): only the host
    check after a wave stops those -- the JAX package's rule."""
    fail_props = [p for p in props if p.expectation.discovery_is_failure]
    return (
        (fw._kind == "all" and not props)
        or (fw._kind == "all_failures" and not fail_props)
        or (fw._kind == "all_of" and not fw._names)
    )


def default_waves_per_call(options) -> int:
    """The JAX engines' waves between two host checks: 1 where the host
    alone can stop the run (a wall ``timeout``, ``target_state_count``, a
    trivially-true ``finish_when``), else 256.  The port's sharded engine
    folds its shards' discoveries at these boundaries, as the JAX loop
    reads them back."""
    fine_grained = (
        options._timeout is not None
        or options._target_state_count is not None
        or finish_when_trivially_true(
            options._finish_when, options.model.properties()
        )
    )
    return 1 if fine_grained else 256


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


def finish_when_masks(fw, props) -> Tuple[int, int]:
    """The card's form of :func:`make_finish_when_device`: ``(all, any)``
    property bit masks such that the policy matches a found set ``found``
    (bit p for property p) exactly when ``all`` is nonzero and every bit of
    it is found, or some bit of ``any`` is -- for all six kinds and their
    empty-set cases (a policy that matches with zero discoveries gives
    ``(0, 0)``, as the mirror gives False)."""
    n_props = len(props)
    every = (1 << n_props) - 1
    fail = sum(
        1 << i for i, p in enumerate(props) if p.expectation.discovery_is_failure
    )
    name_idx = {p.name: i for i, p in enumerate(props)}
    named = sum(1 << name_idx[n] for n in fw._names if n in name_idx)
    kind = fw._kind
    if kind == "all":
        return every, 0
    if kind == "any":
        return 0, every
    if kind == "any_failures":
        return 0, fail
    if kind == "all_failures":
        return fail, 0
    if kind == "all_of":
        known = all(n in name_idx for n in fw._names)
        return (named if known else 0), 0
    if kind == "any_of":
        return 0, named
    raise ValueError(kind)


def prop_kinds(props) -> Tuple[int, int, int]:
    """``(always, sometimes, eventually)``: bit p set in the mask of
    property p's expectation."""
    masks = {e: 0 for e in Expectation}
    for p, prop in enumerate(props):
        masks[prop.expectation] |= 1 << p
    return (
        masks[Expectation.ALWAYS], masks[Expectation.SOMETIMES],
        masks[Expectation.EVENTUALLY],
    )


def wave_eval(conds: torch.Tensor, valid: torch.Tensor, eb: torch.Tensor,
              start_id: int, kinds: Tuple[int, int, int], discovered: int):
    """The wave's verdicts from its conds ``bool[F, P]`` and lane validity
    ``bool[F, A]`` (K8): returns ``(valid, eb, cands)`` -- validity gated by
    "awaiting discoveries" (IN PLACE on the card), the eventually-bits
    ``int32[F]`` with each state's satisfied bits cleared, and per property
    the first hit's BFS position (int64, NO_ID for none).  ``kinds`` is
    :func:`prop_kinds`; ``start_id`` is the wave's first position."""
    if conds.device.type == "cpu":
        return wave_eval_plain(conds, valid, eb, start_id, kinds, discovered)
    dev = conds.device
    cuda.require(conds, "conds", torch.bool, 2, dev)
    cuda.require(valid, "valid", torch.bool, 2, dev)
    cuda.require(eb, "eb", torch.int32, 1, dev)
    f, p = conds.shape
    if valid.shape[0] != f or eb.shape[0] != f:
        raise ValueError("conds, valid and eb differ in state count")
    if p > 32:
        raise ValueError("at most 32 properties supported on device")
    eb_out = torch.empty_like(eb)
    cands = torch.empty((p,), dtype=torch.int64, device=dev)
    fn = cuda.function(
        "wave_eval", "sr_wave_eval",
        [cuda.P, cuda.I64, cuda.I32, cuda.P, cuda.I32, cuda.P, cuda.P,
         cuda.I64, cuda.U32, cuda.U32, cuda.U32, cuda.U32, cuda.P, cuda.P],
    )
    wave_eval.launches += 1
    always, sometimes, eventually = kinds
    code = fn(
        cuda.ptr(conds), f, p, cuda.ptr(valid), valid.shape[1], cuda.ptr(eb),
        cuda.ptr(eb_out), start_id, always, sometimes, eventually,
        discovered, cuda.ptr(cands), cuda.stream(conds),
    )
    cuda.check(code, "wave_eval", "wave_eval")
    return valid, eb_out, cands


wave_eval.launches = 0


def wave_eval_plain(conds, valid, eb, start_id: int, kinds, discovered: int,
                    active=None):
    """Plain-torch twin of the K8 kernel (any device); ``active`` (bool[F],
    the device-count entry's) gates states out as :func:`wave_eval_dev`
    does."""
    always, sometimes, eventually = kinds
    f, p = conds.shape
    dev = conds.device
    no_id = torch.tensor(NO_ID, dtype=torch.int64, device=dev)
    cands = [no_id] * p
    live = (torch.ones((f,), dtype=torch.bool, device=dev)
            if active is None else active)

    def first_hit(hit):
        hit = hit & live
        # argmax of a bool vector is its first True lane.
        idx = torch.argmax(hit.to(torch.uint8)).to(torch.int64) + start_id
        return torch.where(hit.any(), idx, no_id)

    # "Awaiting discoveries": the reference stops expanding a state when
    # every property already has a discovery and this state contributes
    # none (src/checker/bfs.rs:231-281), against the discoveries as of wave
    # start.  With zero properties nothing is awaited and nothing expands.
    awaiting = torch.zeros((f,), dtype=torch.bool, device=dev)
    ev = []
    for q in range(p):
        undiscovered = not (discovered >> q) & 1
        if (always >> q) & 1:
            if undiscovered:
                awaiting |= conds[:, q]
            cands[q] = first_hit(~conds[:, q])
        elif (sometimes >> q) & 1:
            if undiscovered:
                awaiting |= ~conds[:, q]
            cands[q] = first_hit(conds[:, q])
        else:  # EVENTUALLY: discovered only at trace ends
            ev.append(q)
            if undiscovered:
                awaiting[:] = True

    # Clear this state's own satisfied eventually bits.
    for bit, q in enumerate(ev):
        eb = eb & ~(conds[:, q].to(torch.int32) << bit)
    valid = valid & (awaiting & live)[:, None]

    # Terminal states with leftover ebits -> eventually counterexamples
    # (src/checker/bfs.rs:326-333).
    if ev:
        terminal = ~valid.any(dim=1)
        for bit, q in enumerate(ev):
            cands[q] = first_hit(terminal & (((eb >> bit) & 1) == 1))
    stacked = (
        torch.stack(cands) if cands
        else torch.empty((0,), dtype=torch.int64, device=dev)
    )
    return valid, eb, stacked


def _stats_scalars(stats: torch.Tensor, p: int) -> Tuple[int, int]:
    """The wave's first position and discovered mask from a stats vector
    (``parallel/fused.py``): ``level_start`` and ``disc[P]``."""
    words = [int(x) & 0xFFFFFFFF for x in stats[: 8 + p].tolist()]
    return words[0], sum(1 << q for q in range(p) if words[8 + q] != NO_ID)


def wave_eval_dev(conds: torch.Tensor, valid: torch.Tensor, eb: torch.Tensor,
                  stats: torch.Tensor, active: torch.Tensor,
                  kinds: Tuple[int, int, int]):
    """K8's device-count entry, for the fused wave loop: :func:`wave_eval`
    with the first position and the discovered mask read on the card from
    ``stats`` (int32, the JAX stats layout: ``level_start`` at 0,
    ``disc[P]`` from 8) and the states whose ``active`` (bool[F]) is False
    gated out -- they await nothing and hit nothing, as the JAX
    ``wave_eval`` gates its padded chunk."""
    if conds.device.type == "cpu":
        return wave_eval_dev_plain(conds, valid, eb, stats, active, kinds)
    dev = conds.device
    cuda.require(conds, "conds", torch.bool, 2, dev)
    cuda.require(valid, "valid", torch.bool, 2, dev)
    cuda.require(eb, "eb", torch.int32, 1, dev)
    cuda.require(stats, "stats", torch.int32, 1, dev)
    cuda.require(active, "active", torch.bool, 1, dev)
    f, p = conds.shape
    if valid.shape[0] != f or eb.shape[0] != f or active.shape[0] != f:
        raise ValueError("conds, valid, eb and active differ in state count")
    if p > 32 or stats.shape[0] < 8 + p:
        raise ValueError("at most 32 properties, and stats must hold disc[P]")
    eb_out = torch.empty_like(eb)
    cands = torch.empty((p,), dtype=torch.int64, device=dev)
    fn = cuda.function(
        "wave_eval", "sr_wave_eval_dev",
        [cuda.P, cuda.I64, cuda.I32, cuda.P, cuda.I32, cuda.P, cuda.P,
         cuda.P, cuda.P, cuda.U32, cuda.U32, cuda.U32, cuda.P, cuda.P],
    )
    wave_eval_dev.launches += 1
    always, sometimes, eventually = kinds
    code = fn(
        cuda.ptr(conds), f, p, cuda.ptr(valid), valid.shape[1], cuda.ptr(eb),
        cuda.ptr(eb_out), cuda.ptr(stats), cuda.ptr(active), always,
        sometimes, eventually, cuda.ptr(cands), cuda.stream(conds),
    )
    cuda.check(code, "wave_eval", "wave_eval_dev")
    return valid, eb_out, cands


wave_eval_dev.launches = 0


def wave_eval_dev_plain(conds, valid, eb, stats, active, kinds):
    """Plain-torch twin of K8's device-count entry (any device)."""
    start, discovered = _stats_scalars(stats, conds.shape[1])
    return wave_eval_plain(conds, valid, eb, start, kinds, discovered,
                           active=active)
