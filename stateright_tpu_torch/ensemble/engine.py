"""The chaos-ensemble engine: K fault schedules swept in one batched walk.

The counterpart of ``stateright_tpu/ensemble/engine.py``.  One batch of the
device walk (``parallel/simulation_gpu.py``) runs ``members`` independent
fault schedules against the compiled ABD register on the ordered (FIFO)
fabric: member m walks with the key ``fold_in(PRNGKey(seed), m)`` and its
own schedule (``schedule.derive_schedule``), and :class:`FateLaneHook`
blocks the deliverable lanes that schedule drops, holds or cuts at each
step (K19, ``fate.py``).  Member parameters are dispatch inputs, so a
shrink candidate re-walks one member with no rebuild.

Device to host, in order:

1. a member fails on the card when its walk latches an ALWAYS property
   (for the register, the linearizability DP evaluated at every walked
   state);
2. the earliest-latching failing member is shrunk on the card: its horizon
   cut to the latch step, then each device kind's rates (drop, reorder)
   zeroed, every candidate re-walked and kept only while it still fails;
3. the shrunk schedule is the repro (``ensemble_repro`` in the journal),
   rebuilt from that payload alone by ``EnsembleSchedule.from_repro``.

The JAX engine then replays the member's seed through the host
``FaultyTransport`` + ``LiveAuditor`` stack to confirm it and to shrink the
kinds only the host can vouch for (duplicate, delay, partitions).  That
stack needs the UDP actor runtime, which the port does not have yet:
``replay=True`` raises ``NotImplementedError`` exactly where that replay
would start -- after the sweep and the shrink, and only when a failing
member exists.

Device fault semantics (the JAX engine's documented contract): a blocked
lane holds its head and consumes one fate index per step -- the device
image of an ordered-reliable link retransmitting a dropped or held
datagram.  Drop and reorder block; duplicate and delay never block and
exist on the card only as schedule parameters carried to a host replay.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import prng
from ..ops.u32 import from_numpy_u32, to_numpy_u32
from ..ops.cuda import resolve_device
from ..parallel.simulation_gpu import build_walk, walker_keys
from ..runtime.chaos import ChaosSpec
from ..runtime.journal import as_journal
from .fate import fate_mask, fate_mask_plain, link_seed_limbs, rate_threshold
from .schedule import EnsembleSchedule, derive_schedule

NO_STEP = 0xFFFFFFFF

# Shrink candidates verified on the card: the kinds that block lanes.
_DEVICE_KINDS = ("drop", "reorder")


class FateLaneHook:
    """The walk's fault hook: each member's lanes blocked by its fault
    schedule at step t, from its per-lane datagram counters (which K18
    advances: one attempt per deliverable lane per step)."""

    def __init__(self, n_lanes: int):
        self.n_lanes = n_lanes

    def apply(self, t: int, ctr: torch.Tensor, params: Dict[str, torch.Tensor],
              plain: bool = False) -> torch.Tensor:
        return (fate_mask_plain if plain else fate_mask)(t, ctr, params)


def _member_params(pairs, schedules: List[EnsembleSchedule]) -> Dict[str, np.ndarray]:
    """The dispatch-input parameter pack: one row per member, one column
    per FIFO lane (the compiled model's ``pairs``)."""
    n_lanes = len(pairs)
    k = len(schedules)
    out = {
        "link_hi": np.zeros((k, n_lanes), np.uint32),
        "link_lo": np.zeros((k, n_lanes), np.uint32),
        "drop_thr": np.zeros((k, n_lanes), np.uint32),
        "drop_always": np.zeros((k, n_lanes), np.bool_),
        "reorder_thr": np.zeros((k, n_lanes), np.uint32),
        "reorder_always": np.zeros((k, n_lanes), np.bool_),
        "src_group": np.full((k, n_lanes), -1, np.int32),
        "dst_group": np.full((k, n_lanes), -1, np.int32),
        "part_at": np.zeros((k,), np.int32),
        "part_heal": np.full((k,), -1, np.int32),
        "horizon": np.zeros((k,), np.int32),
    }
    for mi, sch in enumerate(schedules):
        group_of: Dict[int, int] = {}
        if sch.spec.partitions:
            for gi, g in enumerate(sch.spec.partitions[0].groups):
                for node in g:
                    group_of[node] = gi
        for li, (src, dst, _depth, _off) in enumerate(pairs):
            hi, lo = link_seed_limbs(sch.seed, src, dst)
            out["link_hi"][mi, li] = hi
            out["link_lo"][mi, li] = lo
            f = sch.spec.faults_for(src, dst)
            thr, always = rate_threshold(f.drop)
            out["drop_thr"][mi, li] = thr
            out["drop_always"][mi, li] = always
            thr, always = rate_threshold(f.reorder)
            out["reorder_thr"][mi, li] = thr
            out["reorder_always"][mi, li] = always
            out["src_group"][mi, li] = group_of.get(src, -1)
            out["dst_group"][mi, li] = group_of.get(dst, -1)
        out["part_at"][mi] = sch.partition_at
        out["part_heal"][mi] = sch.partition_heal
        out["horizon"][mi] = sch.steps
    return out


def _zero_kind(spec: ChaosSpec, kind: str) -> ChaosSpec:
    def z(f):
        if kind == "delay":
            return dataclasses.replace(f, delay=(0.0, 0.0))
        return dataclasses.replace(f, **{kind: 0.0})

    return ChaosSpec(
        default=z(spec.default),
        links=tuple((k, z(f)) for k, f in spec.links),
        partitions=spec.partitions,
    )


def _spec_is_meaningful(spec: ChaosSpec, kind: str) -> bool:
    """Is there anything to shrink for this kind?"""
    faults = [spec.default] + [f for _k, f in spec.links]
    if kind == "delay":
        return any(f.delay[1] > 0 for f in faults)
    return any(getattr(f, kind) > 0 for f in faults)


@dataclass
class EnsembleResult:
    """One ensemble run: the sweep, the failing members, and (when a
    failure was found) the shrunk repro.  ``confirmed`` stays empty: the
    host replay that fills it is not ported."""

    members: int
    steps: int
    seed: int
    workload: str
    fault: Optional[str]
    states_walked: int = 0
    elapsed_sec: float = 0.0
    schedules_per_sec: float = 0.0
    ttff_sec: Optional[float] = None  # time to first failing seed
    failing: List[dict] = field(default_factory=list)
    confirmed: List[dict] = field(default_factory=list)
    shrink_steps: int = 0
    repro: Optional[dict] = None
    dispatches: int = 1

    def to_dict(self) -> dict:
        return {
            "members": self.members,
            "steps": self.steps,
            "seed": self.seed,
            "workload": self.workload,
            "fault": self.fault,
            "states_walked": self.states_walked,
            "elapsed_sec": round(self.elapsed_sec, 3),
            "schedules_per_sec": round(self.schedules_per_sec, 1),
            "ttff_sec": self.ttff_sec,
            "failing": self.failing,
            "confirmed": self.confirmed,
            "shrink_steps": self.shrink_steps,
            "repro": self.repro,
            "dispatches": self.dispatches,
        }


def params_on(params_np: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The parameter pack as tensors on ``device``: u32 words as int32
    bit-views, flags bool, group ids and step windows int32."""
    out = {}
    for k, v in params_np.items():
        if v.dtype == np.uint32:
            out[k] = from_numpy_u32(v, device)
        else:
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out


def _abd_model(client_count: int, fault: Optional[str]):
    from ..actor import Network
    from ..models.abd import AbdModelCfg

    return AbdModelCfg(
        client_count=client_count,
        server_count=2,
        network=Network.new_ordered(),
        fault=fault,
    ).into_model()


def run_ensemble(
    *,
    members: int = 1024,
    seed: int = 0,
    chaos=None,
    steps: int = 64,
    fault: Optional[str] = None,
    client_count: int = 2,
    put_count: int = 1,
    journal=None,
    shrink: bool = True,
    replay: bool = True,
    max_journaled_failures: int = 32,
    device=None,
) -> EnsembleResult:
    """Sweep ``members`` independent fault schedules over the compiled ABD
    workload in one batched walk of ``steps`` steps, and shrink the best
    failing member on the card.  ``chaos`` is the base ChaosSpec (object,
    dict, or JSON string) each member's effective spec derives from;
    ``fault`` forwards to the replicas (``"skip_ack"`` is the
    known-violating workload).  ``device`` defaults to ``cuda`` and raises
    where there is no card.  ``replay=True`` (the JAX default) raises
    ``NotImplementedError`` once a failing member is found and shrunk: the
    host replay is not ported (module docstring)."""
    spec = chaos if isinstance(chaos, ChaosSpec) else ChaosSpec.from_json(chaos)
    dev = resolve_device(device, "run_ensemble()")
    journal = as_journal(journal)
    model = _abd_model(client_count, fault)
    from ..core.model import Expectation
    from ..models.abd_compiled import AbdCompiled

    cm = AbdCompiled(model)
    if not cm.ordered:
        raise ValueError("the ensemble engine needs the ordered FIFO fabric")
    props = model.properties()
    always_idx = [
        i for i, p in enumerate(props) if p.expectation is Expectation.ALWAYS
    ]

    schedules = [derive_schedule(seed, m, spec, steps) for m in range(members)]
    params = params_on(_member_params(cm.pairs, schedules), dev)

    result = EnsembleResult(
        members=members, steps=steps, seed=int(seed), workload="abd", fault=fault,
    )
    if journal is not None:
        journal.append(
            "ensemble_start",
            members=members, seed=int(seed), steps=steps,
            workload="abd", fault=fault, client_count=client_count,
            spec=spec.to_dict(),
        )

    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    walk = build_walk(cm, props, steps, fault_hook=FateLaneHook(len(cm.pairs)))
    base = prng.prng_key(int(seed))

    t0 = time.monotonic()
    keys = walker_keys(base, 0, members, dev)
    _trace, disc_dev, counted_dev, _appended, flag_dev = walk(keys, params)
    disc = to_numpy_u32(disc_dev)  # waits for the card: the sweep is done
    elapsed = time.monotonic() - t0
    counted = to_numpy_u32(counted_dev)
    if bool(flag_dev.any()):
        raise RuntimeError(
            "the model step kernel flagged an encoding-capacity "
            "overflow during an ensemble sweep"
        )

    result.states_walked = int(counted.sum(dtype=np.int64))
    result.elapsed_sec = elapsed
    result.schedules_per_sec = members / elapsed if elapsed > 0 else 0.0

    # Failing members: any ALWAYS-property latch.
    fail_step = np.full(members, NO_STEP, np.uint32)
    fail_prop = np.full(members, -1, np.int32)
    for p in always_idx:
        col = disc[:, p]
        better = col < fail_step
        fail_prop = np.where(better, p, fail_prop)
        fail_step = np.minimum(fail_step, col)
    failing_members = np.flatnonzero(fail_step != NO_STEP)
    if len(failing_members):
        result.ttff_sec = round(elapsed, 3)
    for mi in failing_members:
        entry = {
            "member": int(mi),
            "seed": schedules[mi].seed,
            "property": props[int(fail_prop[mi])].name,
            "step": int(fail_step[mi]),
        }
        result.failing.append(entry)
        if journal is not None and len(result.failing) <= max_journaled_failures:
            journal.append("ensemble_failing", **entry)
    if journal is not None:
        journal.append(
            "ensemble_sweep",
            members=members,
            failing=len(result.failing),
            states=result.states_walked,
            elapsed_sec=round(elapsed, 3),
            schedules_per_sec=round(result.schedules_per_sec, 1),
            ttff_sec=result.ttff_sec,
        )
    if not len(failing_members):
        return result

    # --- shrink the earliest-latching failing member ----------------------
    best = int(failing_members[np.argmin(fail_step[failing_members])])
    best_prop = props[int(fail_prop[best])].name
    sch = schedules[best]
    best_key = walker_keys(base, best, 1, dev)

    def verify(candidate: EnsembleSchedule) -> bool:
        """Re-walk ONE member on the card; True if it still fails."""
        row = params_on(_member_params(cm.pairs, [candidate]), dev)
        _t, d, _c, _a, f = walk(best_key, row)
        if bool(f[0]):
            return False
        d = to_numpy_u32(d)
        return any(int(d[0, p]) != NO_STEP for p in always_idx)

    if shrink:
        # 1. Horizon prefix: the latch step bounds the needed walk.
        cand = dataclasses.replace(sch, steps=int(fail_step[best]) + 1)
        ok = verify(cand)
        result.shrink_steps += 1
        if journal is not None:
            journal.append(
                "ensemble_shrink", member=best, candidate="prefix",
                steps=cand.steps, accepted=ok,
            )
        if ok:
            sch = cand
        # 2. Per-kind rate zeroing, verified on the card.
        for kind in _DEVICE_KINDS:
            if not _spec_is_meaningful(sch.spec, kind):
                continue
            cand = dataclasses.replace(sch, spec=_zero_kind(sch.spec, kind))
            ok = verify(cand)
            result.shrink_steps += 1
            if journal is not None:
                journal.append(
                    "ensemble_shrink", member=best, candidate=kind,
                    accepted=ok,
                )
            if ok:
                sch = cand

    if replay:
        raise NotImplementedError(
            "run_ensemble(replay=True): the host replay of a failing member "
            "(FaultyTransport + LiveAuditor over the UDP actor runtime) is not "
            "ported yet (ROADMAP A13); pass replay=False for the sweep and "
            "its device-verified shrink"
        )
    result.repro = {
        **sch.to_repro(),
        "workload": "abd",
        "fault": fault,
        "client_count": client_count,
        "put_count": put_count,
        "server_count": 2,
        "property": best_prop,
        "base_seed": int(seed),
    }
    if journal is not None:
        journal.append("ensemble_repro", **result.repro)
    return result
