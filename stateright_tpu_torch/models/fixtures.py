"""Fixture models: the trap counter (kernel K17), the engine's fixture for
eventually properties and the identity canonicalization; GridWalk (K21) and
the edited two-phase commit (K2c), the incremental store's fixtures for its
constant-widening and property-only modes (``incr/``); GridWalk's gang entry
(K21g) and the capped counter (K24), the gang wave's families
(``fleet/gang.py``).

The counterpart of ``TrapCounter`` and ``TrapCounterCompiled`` in
``stateright_tpu/models/fixtures.py``.  The states 0, 1, ..., ``limit``
count up, and at ``trap_at`` a second edge leads to the dead end
``trap_state = limit + 1``.  "reaches one" holds on every path (its bit
clears mid-path); "reaches limit" has a counterexample ending in the trap;
"trapped" is found there.  The states have no symmetric structure, so the
canonicalization is the identity: a run under ``symmetry()`` must equal
the plain run.

:func:`trap_step`, :func:`grid_walk`, :func:`grid_walk_gang`,
:func:`cap_counter` and :func:`cap_counter_gang` launch
``csrc/fixtures_step.cu`` on a CUDA tensor and run their ``*_plain`` twins on
a CPU tensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..core.model import Model, Property
from ..ops import cuda
from ..ops.u32 import M32, i32, u32
from ..parallel.compiled import CompiledModel, fused_conds, override_conds

N_PROPS = 3


class TrapCounter(Model):
    """0 -inc-> 1 -> ... -> limit, with a dead-end trap edge at ``trap_at``."""

    def __init__(self, limit=5, trap_at=2):
        self.limit = limit
        self.trap_at = trap_at
        self.trap_state = limit + 1

    def init_states(self):
        return [0]

    def actions(self, state, actions):
        if state < self.limit:
            actions.append("inc")
        if state == self.trap_at:
            actions.append("trap")

    def next_state(self, state, action):
        return state + 1 if action == "inc" else self.trap_state

    def properties(self):
        return [
            Property.eventually("reaches one", lambda _m, s: s >= 1),
            Property.eventually("reaches limit", lambda _m, s: s == self.limit),
            Property.sometimes("trapped", lambda _m, s: s == self.trap_state),
        ]

    def compiled(self):
        return TrapCounterCompiled(self)


class TrapCounterCompiled(CompiledModel):
    state_width = 1
    max_actions = 2

    def __init__(self, model: TrapCounter):
        for v in (model.limit, model.trap_at, model.trap_state):
            if not 0 <= v <= M32:
                raise ValueError("the trap counter packs its constants in u32 words")
        self.model = model

    def encode(self, state):
        return np.array([state], np.uint32)

    def decode(self, words):
        return int(words[0])

    def _consts(self):
        m = self.model
        return m.limit, m.trap_at, m.trap_state

    def step(self, states: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        nexts, valid, _conds = trap_step(states, *self._consts())
        return nexts, valid

    def property_conds(self, states: torch.Tensor) -> torch.Tensor:
        return trap_step(states, *self._consts())[2]

    def expand(self, states: torch.Tensor):
        nexts, valid, conds = trap_step(states, *self._consts())
        if not fused_conds(self, TrapCounterCompiled):
            conds = self.property_conds(states)
        return nexts, valid, conds, None

    def walk_step(self, states: torch.Tensor, plain: bool = False):
        nexts, valid, conds = (trap_step_plain if plain else trap_step)(
            states, *self._consts())
        if not fused_conds(self, TrapCounterCompiled):
            conds = override_conds(self, states, plain)
        return nexts, valid, conds, None

    def canon_spec(self):
        """No symmetric records: the empty spec, the identity."""
        from ..parallel.canon import CanonSpec

        return CanonSpec(n=0)

    def spec_constants(self):
        """The trap counter is no dataclass: its constants, declared, so
        its runs take part in the incremental store."""
        return {
            "limit": repr(self.model.limit),
            "trap_at": repr(self.model.trap_at),
        }



def cli_spec():
    """The workload spec of :class:`TrapCounter`: the smallest workload with
    a known violation and a compiled form ("reaches limit" has a
    counterexample ending in the trap)."""
    from ..cli import CliSpec

    return CliSpec(
        name="trap counter",
        # limit must clear trap_at=2, or the trap edge is unreachable and
        # the fixture stops violating.
        build=lambda n: TrapCounter(limit=max(n, 3)),
        default_n=5,
        n_meta="LIMIT",
        gpu=True,
        gpu_kwargs=dict(capacity=1 << 10, max_frontier=1 << 6),
    )

def trap_step_plain(states: torch.Tensor, limit: int, trap_at: int,
                    trap_state: int):
    """Plain-torch twin of K17 (any device): ``int32[F, 1] -> (nexts
    int32[F, 2, 1], valid bool[F, 2], conds bool[F, 3])`` -- the lanes
    ``n + 1`` (valid while ``n < limit``) and ``trap_state`` (valid at
    ``n == trap_at``); the conds "reaches one", "reaches limit",
    "trapped"."""
    n = u32(states[:, 0])
    nexts = torch.stack([(n + 1) & M32, torch.full_like(n, trap_state)], dim=1)
    valid = torch.stack([n < limit, n == trap_at], dim=1)
    conds = torch.stack([n >= 1, n == limit, n == trap_state], dim=1)
    return i32(nexts).unsqueeze(-1), valid, conds


def trap_step(states: torch.Tensor, limit: int, trap_at: int, trap_state: int):
    """Successors, validity and property conditions of packed trap-counter
    rows (K17): see :func:`trap_step_plain`."""
    if states.device.type == "cpu":
        return trap_step_plain(states, limit, trap_at, trap_state)
    dev = states.device
    cuda.require(states, "states", torch.int32, 2, dev)
    if states.shape[1] != 1:
        raise ValueError(f"states must be [F, 1], got {tuple(states.shape)}")
    f = states.shape[0]
    nexts = torch.empty((f, 2, 1), dtype=torch.int32, device=dev)
    valid = torch.empty((f, 2), dtype=torch.bool, device=dev)
    conds = torch.empty((f, N_PROPS), dtype=torch.bool, device=dev)
    fn = cuda.function(
        "fixtures_step", "sr_trap_step",
        [cuda.P, cuda.I64, cuda.U32, cuda.U32, cuda.U32, cuda.P, cuda.P,
         cuda.P, cuda.P],
    )
    trap_step.launches += 1
    code = fn(
        cuda.ptr(states), f, limit, trap_at, trap_state, cuda.ptr(nexts),
        cuda.ptr(valid), cuda.ptr(conds), cuda.stream(nexts),
    )
    cuda.check(code, "fixtures_step", "trap_step")
    return nexts, valid, conds


trap_step.launches = 0


@dataclass(frozen=True)
class GridWalk(Model):
    """Monotone walk on the grid ``[0, bound]**2``: the incremental store's
    constant-widening fixture.  The packed row (x and y in 16-bit lanes)
    and the candidate successors do not depend on ``bound``, which only
    prunes through the boundary, so raising it widens the reachable set
    (``spec_widens``).  ``(bound + 1)**2`` unique states at depth ``2 *
    bound``; "in bounds" never fails, so every completed run is exhaustive
    (the store's row-reuse witness)."""

    bound: int = 4

    def init_states(self):
        return [(0, 0)]

    def actions(self, state, actions):
        actions.append("right")
        actions.append("up")

    def next_state(self, state, action):
        x, y = state
        return (x + 1, y) if action == "right" else (x, y + 1)

    def within_boundary(self, state):
        x, y = state
        return x <= self.bound and y <= self.bound

    def properties(self):
        return [
            Property.always(
                "in bounds",
                lambda m, s: 0 <= s[0] <= m.bound and 0 <= s[1] <= m.bound,
            ),
            Property.sometimes(
                "reaches corner",
                lambda m, s: s[0] == m.bound and s[1] == m.bound,
            ),
        ]

    def compiled(self):
        return GridWalkCompiled(self)


class GridWalkCompiled(CompiledModel):
    state_width = 1
    max_actions = 2

    def __init__(self, model: GridWalk):
        if not 0 <= model.bound < (1 << 15):
            raise ValueError("GridWalk bound must fit a 16-bit lane")
        self.model = model

    def encode(self, state):
        x, y = state
        return np.array([x | (y << 16)], np.uint32)

    def decode(self, words):
        w = int(words[0])
        return (w & 0xFFFF, w >> 16)

    def step(self, states):
        """The two candidate successors, every lane valid (the boundary
        prunes them in :meth:`expand`)."""
        nexts, valid, _conds = grid_walk(states, self.model.bound)
        return nexts, torch.ones_like(valid)

    def boundary(self, states):
        return grid_box_plain(states, self.model.bound)

    def property_conds(self, states):
        return grid_walk(states, self.model.bound)[2]

    def expand(self, states):
        nexts, valid, conds = grid_walk(states, self.model.bound)
        if not fused_conds(self, GridWalkCompiled):
            conds = self.property_conds(states)
        return nexts, valid, conds, None

    def spec_widens(self, old_constants: dict) -> bool:
        """Raising ``bound`` only adds reachable states: every old state
        keeps its row, its candidate successors and its in-box successors,
        and the box admits a superset."""
        return self.widens_by(old_constants, "bound")

    # --- gang batching (fleet/gang.py): the codec does not depend on the
    # bound, so walks of every bound share one launch, the bound a job's
    # constant.

    def gang_key(self):
        return ("GridWalk", self.state_width, self.max_actions, 2)

    def gang_constants(self):
        return np.array([self.model.bound], np.uint32)

    def gang_step(self, states, consts):
        """The two candidate successors, every lane valid (the boundary
        prunes them)."""
        nexts, valid, _conds = grid_walk_gang(states, consts)
        return nexts, torch.ones_like(valid)

    def gang_boundary(self, states, consts):
        """K21g's "in bounds" cond of each row: the box test under its
        job's bound."""
        return grid_walk_gang(states, consts)[2][..., 0]

    def gang_property_conds(self, states, consts):
        return grid_walk_gang(states, consts)[2]

    def gang_expand(self, states, consts, out=None):
        if fused_conds(self, GridWalkCompiled, "gang_property_conds"):
            return grid_walk_gang(states, consts, out=out)
        nexts, valid, _conds = grid_walk_gang(states, consts)
        return _copy_out(out, (nexts, valid,
                               self.gang_property_conds(states, consts)))


def grid_box_plain(rows: torch.Tensor, bound: int) -> torch.Tensor:
    """``int32[N, 1] -> bool[N]``: x and y of each packed row within
    ``bound`` (the JAX ``GridWalkCompiled.boundary``)."""
    w = u32(rows[:, 0])
    return ((w & 0xFFFF) <= bound) & ((w >> 16) <= bound)


def grid_walk_plain(states: torch.Tensor, bound: int):
    """Plain-torch twin of K21 (any device): ``int32[F, 1] -> (nexts
    int32[F, 2, 1], valid bool[F, 2], conds bool[F, 2])`` -- the lanes
    ``w + 1`` and ``w + (1 << 16)`` (u32 wrap-around), each valid iff its
    successor is in the box, and the conds "in bounds", "reaches corner"."""
    w = u32(states[:, 0])
    nexts = torch.stack([(w + 1) & M32, (w + (1 << 16)) & M32], dim=1)
    valid = grid_box_plain(nexts.view(-1, 1), bound).view(-1, 2)
    x, y = w & 0xFFFF, w >> 16
    conds = torch.stack([(x <= bound) & (y <= bound), (x == bound) & (y == bound)],
                        dim=1)
    return i32(nexts).unsqueeze(-1), valid, conds


def grid_walk(states: torch.Tensor, bound: int):
    """Successors, in-box validity and property conditions of packed
    GridWalk rows (K21): see :func:`grid_walk_plain`."""
    if not 0 <= bound <= M32:
        raise ValueError("the grid bound is packed in a u32 word")
    if states.device.type == "cpu":
        return grid_walk_plain(states, bound)
    dev = states.device
    cuda.require(states, "states", torch.int32, 2, dev)
    if states.shape[1] != 1:
        raise ValueError(f"states must be [F, 1], got {tuple(states.shape)}")
    f = states.shape[0]
    nexts = torch.empty((f, 2, 1), dtype=torch.int32, device=dev)
    valid = torch.empty((f, 2), dtype=torch.bool, device=dev)
    conds = torch.empty((f, 2), dtype=torch.bool, device=dev)
    fn = cuda.function(
        "fixtures_step", "sr_grid_walk",
        [cuda.P, cuda.I64, cuda.U32, cuda.P, cuda.P, cuda.P, cuda.P],
    )
    grid_walk.launches += 1
    code = fn(cuda.ptr(states), f, bound, cuda.ptr(nexts), cuda.ptr(valid),
              cuda.ptr(conds), cuda.stream(nexts))
    cuda.check(code, "fixtures_step", "grid_walk")
    return nexts, valid, conds


grid_walk.launches = 0


def _outputs(out, shapes, device):
    """The ``(nexts, valid, conds)`` a kernel writes: ``out`` (the gang
    wave's readback buffer) checked against ``shapes``, or new tensors."""
    dtypes = (torch.int32, torch.bool, torch.bool)
    if out is None:
        return tuple(torch.empty(s, dtype=d, device=device)
                     for s, d in zip(shapes, dtypes))
    for t, s, d, name in zip(out, shapes, dtypes, ("nexts", "valid", "conds")):
        cuda.require(t, name, d, len(s), device)
        if tuple(t.shape) != s:
            raise ValueError(f"{name} must be {s}, got {tuple(t.shape)}")
    return tuple(out)


def _copy_out(out, got):
    """A twin's results, written into ``out`` where the caller gave one."""
    if out is None:
        return got
    for t, g in zip(out, got):
        t.copy_(g)
    return tuple(out)


def _gang_rows(states: torch.Tensor, consts: torch.Tensor, c: int):
    """Check a gang launch's inputs: ``int32[K, F, 1]`` rows and
    ``int32[K, c]`` constants on one device."""
    dev = states.device
    cuda.require(states, "states", torch.int32, 3, dev)
    cuda.require(consts, "consts", torch.int32, 2, dev)
    k, f, w = states.shape
    if w != 1 or tuple(consts.shape) != (k, c):
        raise ValueError(f"states must be [K, F, 1] and consts [K, {c}], got "
                         f"{tuple(states.shape)} and {tuple(consts.shape)}")
    return k, f


def grid_gang_box_plain(rows: torch.Tensor, consts: torch.Tensor) -> torch.Tensor:
    """``(int32[K, N, 1], int32[K, 1]) -> bool[K, N]``: each packed row within
    its job's bound (the JAX ``GridWalkCompiled.gang_boundary``)."""
    w = u32(rows[..., 0])
    b = u32(consts[:, :1])
    return ((w & 0xFFFF) <= b) & ((w >> 16) <= b)


def grid_walk_gang_plain(states: torch.Tensor, consts: torch.Tensor):
    """Plain-torch twin of K21g (any device): ``(int32[K, F, 1], int32[K, 1])
    -> (nexts int32[K, F, 2, 1], valid bool[K, F, 2], conds bool[K, F, 2])``
    -- K21's lanes, validity and conds for job ``j`` under the bound
    ``consts[j, 0]``."""
    k, f, _w = states.shape
    w = u32(states[..., 0])
    nexts = torch.stack([(w + 1) & M32, (w + (1 << 16)) & M32], dim=2)
    valid = grid_gang_box_plain(nexts.view(k, f * 2, 1), consts).view(k, f, 2)
    b = u32(consts[:, :1])
    x, y = w & 0xFFFF, w >> 16
    conds = torch.stack([(x <= b) & (y <= b), (x == b) & (y == b)], dim=2)
    return i32(nexts).unsqueeze(-1), valid, conds


def grid_walk_gang(states: torch.Tensor, consts: torch.Tensor, out=None):
    """K21 for a gang of walks in one launch (K21g): see
    :func:`grid_walk_gang_plain`.  ``out`` is an optional ``(nexts, valid,
    conds)`` to write into."""
    if states.device.type == "cpu":
        return _copy_out(out, grid_walk_gang_plain(states, consts))
    k, f = _gang_rows(states, consts, 1)
    nexts, valid, conds = _outputs(out, ((k, f, 2, 1), (k, f, 2), (k, f, 2)),
                                   states.device)
    fn = cuda.function(
        "fixtures_step", "sr_grid_walk_gang",
        [cuda.P, cuda.P, cuda.I64, cuda.I64, cuda.P, cuda.P, cuda.P, cuda.P],
    )
    grid_walk_gang.launches += 1
    code = fn(cuda.ptr(states), cuda.ptr(consts), k, f, cuda.ptr(nexts),
              cuda.ptr(valid), cuda.ptr(conds), cuda.stream(nexts))
    cuda.check(code, "fixtures_step", "grid_walk_gang")
    return nexts, valid, conds


grid_walk_gang.launches = 0


@dataclass(frozen=True)
class CapCounter(Model):
    """Counter 0 -> 1 -> ... -> ``limit`` with an ALWAYS cap property: the
    gang wave's violation fixture.  "within cap" fails exactly when ``limit >
    cap``, so one gang mixes violating and clean members, each with its own
    verdict.  "counts up" never fails, so every state stays awaited and a
    completed run is exhaustive whether or not the cap property was
    discovered: the gang's fingerprint parity with solo runs does not depend
    on when a discovery lands."""

    limit: int = 6
    cap: int = 10

    def init_states(self):
        return [0]

    def actions(self, state, actions):
        if state < self.limit:
            actions.append("inc")

    def next_state(self, state, action):
        return state + 1

    def properties(self):
        return [
            Property.always("counts up", lambda _m, s: s >= 0),
            Property.always("within cap", lambda m, s: s <= m.cap),
            Property.sometimes("reaches limit", lambda m, s: s == m.limit),
        ]

    def compiled(self):
        return CapCounterCompiled(self)


class CapCounterCompiled(CompiledModel):
    """K24: the solo entry carries ``step``, ``property_conds`` and
    ``expand``; the gang entry reads ``consts[j] = [limit, cap]``, so every
    capped counter shares one gang launch."""

    state_width = 1
    max_actions = 1

    def __init__(self, model: CapCounter):
        for v in (model.limit, model.cap):
            if not 0 <= v <= M32:
                raise ValueError("the capped counter packs its constants in u32 words")
        self.model = model

    def encode(self, state):
        return np.array([state], np.uint32)

    def decode(self, words):
        return int(words[0])

    def step(self, states):
        nexts, valid, _conds = cap_counter(states, self.model.limit, self.model.cap)
        return nexts, valid

    def property_conds(self, states):
        return cap_counter(states, self.model.limit, self.model.cap)[2]

    def expand(self, states):
        nexts, valid, conds = cap_counter(states, self.model.limit, self.model.cap)
        if not fused_conds(self, CapCounterCompiled):
            conds = self.property_conds(states)
        return nexts, valid, conds, None

    def walk_step(self, states, plain=False):
        nexts, valid, conds = (cap_counter_plain if plain else cap_counter)(
            states, self.model.limit, self.model.cap)
        if not fused_conds(self, CapCounterCompiled):
            conds = override_conds(self, states, plain)
        return nexts, valid, conds, None

    def gang_key(self):
        return ("CapCounter", self.state_width, self.max_actions, 3)

    def gang_constants(self):
        return np.array([self.model.limit, self.model.cap], np.uint32)

    def gang_step(self, states, consts):
        nexts, valid, _conds = cap_counter_gang(states, consts)
        return nexts, valid

    def gang_property_conds(self, states, consts):
        return cap_counter_gang(states, consts)[2]

    def gang_expand(self, states, consts, out=None):
        if fused_conds(self, CapCounterCompiled, "gang_property_conds"):
            return cap_counter_gang(states, consts, out=out)
        nexts, valid, _conds = cap_counter_gang(states, consts)
        return _copy_out(out, (nexts, valid,
                               self.gang_property_conds(states, consts)))


def _cap_lanes(n: torch.Tensor, limit, cap):
    """K24's lane, validity and conds of u32 counters ``n`` (int64) under
    ``limit`` and ``cap`` (ints, or int64 tensors broadcasting with ``n``)."""
    nexts = ((n + 1) & M32).unsqueeze(-1)
    valid = (n < limit).unsqueeze(-1)
    conds = torch.stack([torch.ones_like(n, dtype=torch.bool), n <= cap,
                         n == limit], dim=-1)
    return i32(nexts).unsqueeze(-1), valid, conds


def cap_counter_plain(states: torch.Tensor, limit: int, cap: int):
    """Plain-torch twin of K24's solo entry (any device): ``int32[F, 1] ->
    (nexts int32[F, 1, 1], valid bool[F, 1], conds bool[F, 3])`` -- the lane
    ``n + 1`` (u32 wrap-around), valid iff ``n < limit``, and the conds
    "counts up" (``n >= 0``, always true in u32), "within cap" (``n <=
    cap``), "reaches limit" (``n == limit``), every comparison unsigned."""
    return _cap_lanes(u32(states[:, 0]), limit, cap)


def cap_counter(states: torch.Tensor, limit: int, cap: int):
    """Successors, validity and property conditions of packed capped-counter
    rows (K24, solo): see :func:`cap_counter_plain`."""
    for v in (limit, cap):
        if not 0 <= v <= M32:
            raise ValueError("limit and cap are packed in u32 words")
    if states.device.type == "cpu":
        return cap_counter_plain(states, limit, cap)
    dev = states.device
    cuda.require(states, "states", torch.int32, 2, dev)
    if states.shape[1] != 1:
        raise ValueError(f"states must be [F, 1], got {tuple(states.shape)}")
    f = states.shape[0]
    nexts, valid, conds = _outputs(None, ((f, 1, 1), (f, 1), (f, 3)), dev)
    fn = cuda.function(
        "fixtures_step", "sr_cap_counter",
        [cuda.P, cuda.I64, cuda.U32, cuda.U32, cuda.P, cuda.P, cuda.P, cuda.P],
    )
    cap_counter.launches += 1
    code = fn(cuda.ptr(states), f, limit, cap, cuda.ptr(nexts), cuda.ptr(valid),
              cuda.ptr(conds), cuda.stream(nexts))
    cuda.check(code, "fixtures_step", "cap_counter")
    return nexts, valid, conds


cap_counter.launches = 0


def cap_counter_gang_plain(states: torch.Tensor, consts: torch.Tensor):
    """Plain-torch twin of K24's gang entry (any device): ``(int32[K, F, 1],
    int32[K, 2]) -> (nexts int32[K, F, 1, 1], valid bool[K, F, 1], conds
    bool[K, F, 3])``, job ``j`` under ``[limit, cap] = consts[j]``."""
    c = u32(consts)
    return _cap_lanes(u32(states[..., 0]), c[:, :1], c[:, 1:2])


def cap_counter_gang(states: torch.Tensor, consts: torch.Tensor, out=None):
    """K24 for a gang of counters in one launch: see
    :func:`cap_counter_gang_plain`.  ``out`` is an optional ``(nexts, valid,
    conds)`` to write into."""
    if states.device.type == "cpu":
        return _copy_out(out, cap_counter_gang_plain(states, consts))
    k, f = _gang_rows(states, consts, 2)
    nexts, valid, conds = _outputs(out, ((k, f, 1, 1), (k, f, 1), (k, f, 3)),
                                   states.device)
    fn = cuda.function(
        "fixtures_step", "sr_cap_counter_gang",
        [cuda.P, cuda.P, cuda.I64, cuda.I64, cuda.P, cuda.P, cuda.P, cuda.P],
    )
    cap_counter_gang.launches += 1
    code = fn(cuda.ptr(states), cuda.ptr(consts), k, f, cuda.ptr(nexts),
              cuda.ptr(valid), cuda.ptr(conds), cuda.stream(nexts))
    cuda.check(code, "fixtures_step", "cap_counter_gang")
    return nexts, valid, conds


cap_counter_gang.launches = 0


class TwoPhaseEdited:
    """The "one-line model edit" fixture of the incremental store's
    property-only mode: two-phase commit with the property "some rm
    prepared" appended.  The compiled subclass inherits ``encode`` and
    ``step`` and overrides only ``property_conds`` (K2c with the extra
    column), so codec and constants hash as the stock model's and only
    the properties component differs."""

    @staticmethod
    def build(rm_count: int) -> Model:
        from .twophase import PREPARED, TwoPhaseSys
        from .twophase_compiled import TwoPhaseCompiled, twophase_conds

        class _EditedCompiled(TwoPhaseCompiled):
            def property_conds(self, states):
                return twophase_conds(states, self.n, some_prepared=True)

        @dataclass(frozen=True)
        class _Edited(TwoPhaseSys):
            def properties(self):
                return TwoPhaseSys.properties(self) + [
                    Property.sometimes(
                        "some rm prepared",
                        lambda _m, s: any(r == PREPARED for r in s.rm_state),
                    ),
                ]

            def compiled(self):
                return _EditedCompiled(self)

        return _Edited(rm_count=rm_count)
