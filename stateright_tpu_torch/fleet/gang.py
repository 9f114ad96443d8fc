"""Gang batching: K compatible small jobs in one device dispatch a wave.

The counterpart of ``stateright_tpu/fleet/gang.py``.  A fleet's small jobs
are mostly parameter sweeps of one workload -- grid walks at different
bounds, counters at different caps.  Run solo, each pays its own launches
and readback a wave for a frontier that fills a sliver of the card.  The
gang stacks K such jobs on a leading jobs axis and advances all of them one
BFS level with a fixed set of launches, whatever K is:

1. the family's gang kernel (``CompiledModel.gang_expand``: K21g for
   GridWalk, K24 for CapCounter) -- every job's successors, their validity
   under the job's boundary and the conds, each job's constants a row of a
   ``consts int32[K, C]`` input;
2. K23 (:func:`gang_eval`, ``csrc/gang.cu``) -- the awaiting gate, validity
   ANDed with the active lanes and the gate, each job's generated count and
   each property's first hitting lane;
3. K1 (``ops/device_fp.py``) on all ``K * F * A`` candidate rows;

then one readback of a single buffer.  The host then dedups each job's
candidates in lane order, as the JAX package's host code does.

Compatibility is the model's own declaration (``gang_key`` and the
``gang_*`` hooks, ``parallel/compiled.py``), and a job must be batchable as
well -- :func:`gang_eligibility`.  A member whose frontier or state count
outgrows the gang's geometry is ejected with a reason, for its caller to
run solo.

Each member's ``discovered_fingerprints()``, counts, depth, discoveries with
their re-executed paths, verdicts and ``violation`` equal the JAX gang's:
the wave is ``wave_eval``'s for families without EVENTUALLY properties,
over the same 64-bit fingerprints.  They equal a solo ``spawn_gpu`` run's
too, but in two cases where the JAX gang counts otherwise (``ROADMAP.md``
section C): a repeated init state counts once in ``state_count``, and a
member that finishes because every property has a witness leaves that
wave's level out of ``max_depth``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.checker import Checker
from ..core.model import Expectation
from ..core.path import Path
from ..ops import cuda
from ..ops.device_fp import device_fp64

# Engine kwargs that only shape solo geometry; the gang sets its own, so
# these are ignored -- any other (journal, resume_from, ...) changes what
# the job does and keeps it out of a gang.
_GEOMETRY_KWARGS = {
    "capacity", "log_capacity", "max_frontier", "chunk_size",
    "dedup_factor", "sort_lanes", "sortless", "bucket_slack",
}


def gang_eligibility(spec) -> Tuple[Optional[tuple], str]:
    """Whether one :class:`~stateright_tpu_torch.serve.jobs.JobSpec` may
    join a gang: ``(compat, reason)``.  ``compat`` is a hashable family key
    (equal keys may share a dispatch), or None with ``reason`` naming the
    first disqualifier.

    The requirements are what the gang wave implements: a single-card
    exhaustive search (engine ``gpu``), run to completion (``finish_when``
    absent or ``all``, no depth, count or time target), no symmetry (the
    gang fingerprints raw rows), no portfolio or store, and a model whose
    compiled form declares a gang family and has no EVENTUALLY property."""
    from ..serve.workloads import build_model

    if spec.engine != "gpu":
        return None, f"engine {spec.engine!r}"
    if spec.portfolio is not None:
        return None, "portfolio job"
    if spec.store:
        return None, "verification-store job"
    if spec.symmetry:
        return None, "symmetry"
    if spec.finish_when not in (None, "all"):
        return None, f"finish_when {spec.finish_when!r}"
    if spec.target_max_depth is not None:
        return None, "target_max_depth"
    if spec.target_state_count is not None:
        return None, "target_state_count"
    if spec.timeout is not None:
        return None, "timeout"
    extra = set(spec.engine_kwargs) - _GEOMETRY_KWARGS
    if extra:
        return None, f"engine_kwargs {sorted(extra)}"
    try:
        model, cli, n = build_model(spec.workload, spec.n, spec.network)
    except Exception as exc:
        return None, f"build failed: {exc}"
    if cli.target_max_depth is not None or \
            cli.gpu_target_max_depth is not None:
        return None, "workload depth target"
    compiled = getattr(model, "compiled", None)
    if compiled is None:
        return None, "no compiled form"
    cm = model.compiled()
    key = cm.gang_key()
    if key is None:
        return None, "model not gang-capable"
    props = model.properties()
    if any(p.expectation is Expectation.EVENTUALLY for p in props):
        return None, "eventually property"
    consts = np.asarray(cm.gang_constants(), np.uint32)
    compat = (key, spec.finish_when or "all", int(consts.shape[0]),
              tuple(p.name for p in props),
              tuple(p.expectation.name for p in props))
    return compat, ""


class GangMemberChecker(Checker):
    """The finished checker of one gang member: the surface
    ``checker_summary`` reads of a solo checker -- counts, discoveries as
    re-executed :class:`Path` objects, and the sorted 64-bit fingerprints of
    every committed state."""

    def __init__(self, model, state_count: int, unique: int, depth: int,
                 discoveries: Dict[str, Path], fingerprints: np.ndarray,
                 waves: int, gang_size: int):
        super().__init__(model)
        self._state_count = int(state_count)
        self._unique = int(unique)
        self._depth = int(depth)
        self._discoveries = dict(discoveries)
        self._fps = fingerprints
        self._waves = int(waves)
        self._gang_size = int(gang_size)

    def state_count(self) -> int:
        return self._state_count

    def unique_state_count(self) -> int:
        return self._unique

    def max_depth(self) -> int:
        return self._depth

    def discoveries(self) -> Dict[str, Path]:
        return dict(self._discoveries)

    def is_done(self) -> bool:
        return True

    def join(self) -> "Checker":
        return self

    def discovered_fingerprints(self) -> np.ndarray:
        """Sorted uint64 fingerprints of every committed state, those a solo
        ``spawn_gpu`` run's ``discovered_fingerprints()`` gives."""
        return self._fps.copy()

    def metrics(self) -> dict:
        m = super().metrics()
        m["engine"] = "gang-member"
        m["gang_waves"] = self._waves
        m["gang_size"] = self._gang_size
        return m


class _Member:
    """The host's traversal state of one gang lane."""

    def __init__(self, tag, model, cm, consts, n_props):
        self.tag = tag  # the caller's handle
        self.model = model
        self.cm = cm
        self.consts = consts
        self.frontier_rows: List[np.ndarray] = []
        self.frontier_fps: List[int] = []
        self.seen: set = set()
        self.parent: Dict[int, Optional[int]] = {}
        self.rowof: Dict[int, np.ndarray] = {}
        self.witness: List[Optional[int]] = [None] * n_props
        self.state_count = 0
        self.depth = 0
        self.done = False
        self.eject_reason: Optional[str] = None

    @property
    def alive(self) -> bool:
        return not self.done and self.eject_reason is None

    def path_to(self, fp: int) -> Path:
        """Re-execute the parent chain behind ``fp`` on the host model, as a
        solo run's discovery paths are."""
        chain: List[int] = []
        cur: Optional[int] = fp
        while cur is not None:
            chain.append(cur)
            cur = self.parent[cur]
        chain.reverse()
        return Path.from_fingerprints(
            self.model,
            [self.model.fingerprint(self.cm.decode(self.rowof[c]))
             for c in chain],
        )


def gang_eval_plain(conds: torch.Tensor, valid: torch.Tensor,
                    active: torch.Tensor, undisc: torch.Tensor, always: int):
    """Plain-torch twin of K23 (any device).  ``conds bool[K, F, P]``,
    ``valid bool[K, F, A]``, ``active bool[K, F]``, ``undisc bool[K, P]``
    and ``always`` (bit ``p`` set for an ALWAYS property; every other counts
    as SOMETIMES) -> ``(valid, generated int32[K], first int32[K, P])``:
    the validity ANDed with ``active`` and the awaiting gate (a state is
    awaited while an undiscovered ALWAYS cond holds or an undiscovered
    SOMETIMES cond fails on it), each job's count of valid lanes, and each
    property's lowest active lane whose cond fails (ALWAYS) or holds
    (SOMETIMES), -1 where none does."""
    k, f, p = conds.shape
    is_always = torch.tensor([bool((always >> q) & 1) for q in range(p)],
                             dtype=torch.bool, device=conds.device)
    open_ = undisc.unsqueeze(1)
    awaiting = ((open_ & conds & is_always) | (open_ & ~conds & ~is_always)).any(-1)
    gated = valid & (active & awaiting).unsqueeze(-1)
    generated = gated.sum(dim=(1, 2)).to(torch.int32)
    hit = active.unsqueeze(-1) & torch.where(is_always, ~conds, conds)
    lane = torch.arange(f, device=conds.device).view(1, f, 1)
    first = torch.where(hit, lane, f).amin(dim=1) if f else torch.full(
        (k, p), f, device=conds.device)
    first = torch.where(first == f, -1, first).to(torch.int32)
    return gated, generated, first


def gang_eval(conds: torch.Tensor, valid: torch.Tensor, active: torch.Tensor,
              undisc: torch.Tensor, always: int, out=None):
    """One gang wave's gate, counts and first hits (K23): see
    :func:`gang_eval_plain`.  On the card ``valid`` is gated IN PLACE.
    ``out`` is an optional ``(generated, first)`` to write into."""
    if conds.device.type == "cpu":
        gated, generated, first = gang_eval_plain(conds, valid, active, undisc,
                                                  always)
        valid.copy_(gated)
        if out is None:
            return valid, generated, first
        out[0].copy_(generated)
        out[1].copy_(first)
        return valid, out[0], out[1]
    dev = conds.device
    cuda.require(conds, "conds", torch.bool, 3, dev)
    cuda.require(valid, "valid", torch.bool, 3, dev)
    cuda.require(active, "active", torch.bool, 2, dev)
    cuda.require(undisc, "undisc", torch.bool, 2, dev)
    k, f, p = conds.shape
    a = valid.shape[2]
    if valid.shape[:2] != (k, f) or active.shape != (k, f) or \
            undisc.shape != (k, p):
        raise ValueError("conds, valid, active and undisc disagree on K, F or P")
    if p > 32:
        raise ValueError("at most 32 properties")
    if out is None:
        generated = torch.empty((k,), dtype=torch.int32, device=dev)
        first = torch.empty((k, p), dtype=torch.int32, device=dev)
    else:
        generated, first = out
        cuda.require(generated, "generated", torch.int32, 1, dev)
        cuda.require(first, "first", torch.int32, 2, dev)
        if generated.shape != (k,) or first.shape != (k, p):
            raise ValueError("generated must be [K] and first [K, P]")
    fn = cuda.function(
        "gang", "sr_gang_eval",
        [cuda.P, cuda.P, cuda.P, cuda.P, cuda.I64, cuda.I64, cuda.I32,
         cuda.I32, cuda.U32, cuda.P, cuda.P, cuda.P],
    )
    gang_eval.launches += 1
    code = fn(cuda.ptr(conds), cuda.ptr(valid), cuda.ptr(active),
              cuda.ptr(undisc), k, f, p, a, always, cuda.ptr(generated),
              cuda.ptr(first), cuda.stream(conds))
    cuda.check(code, "gang", "gang_eval")
    return valid, generated, first


gang_eval.launches = 0


def _arena(fields, device, pin: bool = False):
    """One byte buffer holding typed views ``{name: tensor}`` of ``fields``
    (``(name, dtype, shape)``, each section aligned to 4 bytes), so a wave
    moves its inputs up and its outputs down in one copy each."""
    offsets, size = [], 0
    for _name, dtype, shape in fields:
        n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        offsets.append((size, n))
        size += (n + 3) & ~3
    buf = torch.zeros((max(size, 4),), dtype=torch.uint8, device=device,
                      pin_memory=pin)
    views = {
        name: buf[off:off + n].view(dtype).view(shape)
        for (name, dtype, shape), (off, n) in zip(fields, offsets)
    }
    return buf, views


class _Wave:
    """The gang wave's buffers and its launches, for one family and one
    ``(K, F)``: the family's gang kernel, K23 and K1 write into one device
    buffer, which comes back in one copy."""

    def __init__(self, cm, K, F, P, consts: np.ndarray, always: int, device):
        A, W = cm.max_actions, cm.state_width
        self.cm, self.always, self.device = cm, always, device
        self.fpw = cm.fp_words or W
        self.shape = (K, F, A, W)
        on_card = device.type == "cuda"
        inputs = [("frontier", torch.int32, (K, F, W)),
                  ("active", torch.bool, (K, F)),
                  ("undisc", torch.bool, (K, P))]
        outputs = [("nexts", torch.int32, (K, F, A, W)),
                   ("hi", torch.int32, (K * F * A,)),
                   ("lo", torch.int32, (K * F * A,)),
                   ("generated", torch.int32, (K,)),
                   ("first", torch.int32, (K, P)),
                   ("valid", torch.bool, (K, F, A)),
                   ("conds", torch.bool, (K, F, P))]
        self.h_in, self.host_in = _arena(inputs, "cpu", pin=on_card)
        self.h_out, self.host_out = _arena(outputs, "cpu", pin=on_card)
        if on_card:
            self.d_in, self.dev_in = _arena(inputs, device)
            self.d_out, self.dev_out = _arena(outputs, device)
        else:
            self.d_in, self.dev_in = self.h_in, self.host_in
            self.d_out, self.dev_out = self.h_out, self.host_out
        self.consts = torch.from_numpy(consts.view(np.int32).copy()).to(device)

    def run(self):
        """One wave over what the caller wrote into ``host_in``; returns
        the outputs as numpy arrays over the host buffer."""
        K, F, A, W = self.shape
        i, o = self.dev_in, self.dev_out
        if self.d_in is not self.h_in:
            self.d_in.copy_(self.h_in, non_blocking=True)
        self.cm.gang_expand(i["frontier"], self.consts,
                            out=(o["nexts"], o["valid"], o["conds"]))
        gang_eval(o["conds"], o["valid"], i["active"], i["undisc"], self.always,
                  out=(o["generated"], o["first"]))
        device_fp64(o["nexts"].view(K * F * A, W)[:, :self.fpw],
                    out=(o["hi"], o["lo"]))
        if self.d_out is not self.h_out:
            self.h_out.copy_(self.d_out)
        return {name: t.numpy() for name, t in self.host_out.items()}


def _fp64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (hi.view(np.uint32).astype(np.uint64) << np.uint64(32)) | \
        lo.view(np.uint32).astype(np.uint64)


def run_gang(members_in: List[dict], journal=None,
             max_frontier: int = 256, max_states: int = 1 << 20,
             on_wave=None, device=None):
    """Run one gang to completion.

    ``members_in``: dicts with ``tag`` (an opaque handle), ``model``, ``cm``
    and ``consts`` (``cm.gang_constants()``), all of one
    :func:`gang_eligibility` family.  Returns ``(results, waves)``:
    ``results`` holds ``(tag, checker_or_None, eject_reason)`` in input
    order, a :class:`GangMemberChecker` for each completed member, None and
    the reason for each member ejected mid-run (its frontier or state count
    outgrew the gang; the caller runs it solo).  ``on_wave(wave_index,
    alive_tags)`` fires once a wave.  ``device`` defaults to ``cuda`` and
    raises where there is no card.

    ``journal`` is taken for the JAX signature's sake and receives nothing:
    the JAX gang journals a ``compile`` event when it traces its program,
    and the port builds its kernels once a process (``ops/cuda.py``) with no
    per-program compile, so -- like ``spawn_gpu`` -- it has none to
    journal."""
    del journal
    dev = cuda.resolve_device(device, "run_gang")
    first = members_in[0]
    cm = first["cm"]
    model = first["model"]
    props = model.properties()
    P = len(props)
    W = cm.state_width
    A = cm.max_actions
    C = int(np.asarray(first["consts"]).shape[0])
    F = int(max_frontier)
    always = sum(1 << p for p, prop in enumerate(props)
                 if prop.expectation is Expectation.ALWAYS)
    # K padded to a power of two: gangs of 5 and 8 launch the same shapes.
    K = 1
    while K < len(members_in):
        K *= 2

    members = [
        _Member(m["tag"], m["model"], m["cm"],
                np.asarray(m["consts"], np.uint32), P)
        for m in members_in
    ]

    # Seed each member's frontier with its unique init states in init order
    # (the solo row log's first-occurrence order), over K1's fingerprints in
    # row order: one launch for every member's init rows.
    inits = [[np.asarray(mem.cm.encode(s), np.uint32)
              for s in mem.model.init_states()] for mem in members]
    rows = np.stack([r for rs in inits for r in rs], axis=0)
    words = torch.from_numpy(rows.view(np.int32).copy()).to(dev)
    hi, lo = device_fp64(words[:, :cm.fp_words or W])
    fps = _fp64(hi.cpu().numpy(), lo.cpu().numpy())
    at = 0
    for mem, rs in zip(members, inits):
        for row in rs:
            fp = int(fps[at])
            at += 1
            if fp in mem.seen:
                continue
            mem.seen.add(fp)
            mem.parent[fp] = None
            mem.rowof[fp] = row
            mem.frontier_rows.append(row)
            mem.frontier_fps.append(fp)
        mem.state_count = len(mem.frontier_rows)
        # max_depth counts states on a path, not edges: the init level
        # alone is depth 1.
        mem.depth = 1 if mem.frontier_rows else 0
        if len(mem.frontier_rows) > F:
            mem.eject_reason = "init frontier exceeds gang geometry"

    consts_arr = np.zeros((K, C), np.uint32)
    for j, mem in enumerate(members):
        consts_arr[j] = mem.consts
    wave = _Wave(cm, K, F, P, consts_arr, always, dev)
    frontier = wave.host_in["frontier"].numpy()
    active = wave.host_in["active"].numpy()
    undisc = wave.host_in["undisc"].numpy()

    waves = 0
    while any(mem.alive and mem.frontier_rows for mem in members):
        frontier[:] = 0
        active[:] = False
        undisc[:] = False
        for j, mem in enumerate(members):
            if not (mem.alive and mem.frontier_rows):
                continue
            f = len(mem.frontier_rows)
            frontier[j, :f] = np.stack(mem.frontier_rows, axis=0).view(np.int32)
            active[j, :f] = True
            undisc[j] = [w is None for w in mem.witness]
        out = wave.run()
        nexts, valid = out["nexts"], out["valid"]
        generated, hits = out["generated"], out["first"]
        cand = _fp64(out["hi"], out["lo"]).reshape(K, F * A)
        waves += 1
        if on_wave is not None:
            on_wave(waves, [m.tag for m in members if m.alive])

        for j, mem in enumerate(members):
            if not (mem.alive and mem.frontier_rows):
                continue
            f = len(mem.frontier_rows)
            # Latch witnesses first-lane-wins, against the discoveries as
            # they stood when the wave started (wave_eval's order).
            for p in range(P):
                if mem.witness[p] is None and hits[j, p] >= 0:
                    mem.witness[p] = mem.frontier_fps[int(hits[j, p])]
            mem.state_count += int(generated[j])
            # Commit successors in candidate lane order (state-major,
            # action-minor) -- the solo row log's first-occurrence order --
            # deduped on the same 64-bit fingerprints.
            nxt_rows: List[np.ndarray] = []
            nxt_fps: List[int] = []
            for lane in np.flatnonzero(valid[j, :f].reshape(-1)):
                i, a = divmod(int(lane), A)
                fp = int(cand[j, lane])
                if fp in mem.seen:
                    continue
                mem.seen.add(fp)
                mem.parent[fp] = mem.frontier_fps[i]
                mem.rowof[fp] = nexts[j, i, a].view(np.uint32).copy()
                nxt_rows.append(mem.rowof[fp])
                nxt_fps.append(fp)
            # The finish check comes after the commit, as in the solo wave
            # loop: the matching wave's successors are in the set but never
            # expanded (finish_when "all", the only gang policy).
            if P and all(w is not None for w in mem.witness):
                mem.done = True
                mem.frontier_rows, mem.frontier_fps = [], []
                continue
            if len(nxt_rows) > F:
                mem.eject_reason = (
                    f"frontier overgrew gang geometry "
                    f"({len(nxt_rows)} > {F})"
                )
                continue
            if len(mem.seen) > max_states:
                mem.eject_reason = (
                    f"state budget overgrown ({len(mem.seen)} > "
                    f"{max_states})"
                )
                continue
            mem.frontier_rows, mem.frontier_fps = nxt_rows, nxt_fps
            if nxt_rows:
                mem.depth += 1
            else:
                mem.done = True

    results = []
    for mem in members:
        if mem.eject_reason is not None:
            results.append((mem.tag, None, mem.eject_reason))
            continue
        discoveries = {
            props[p].name: mem.path_to(mem.witness[p])
            for p in range(P)
            if mem.witness[p] is not None
        }
        fps_sorted = np.sort(
            np.fromiter(mem.seen, dtype=np.uint64, count=len(mem.seen))
        )
        checker = GangMemberChecker(
            mem.model, mem.state_count, len(mem.seen), mem.depth,
            discoveries, fps_sorted, waves, len(members),
        )
        results.append((mem.tag, checker, None))
    return results, waves
