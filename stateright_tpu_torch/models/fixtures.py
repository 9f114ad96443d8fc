"""Fixture models: the trap counter (kernel K17), the engine's fixture for
eventually properties and the identity canonicalization; GridWalk (K21) and
the edited two-phase commit (K2c), the incremental store's fixtures for its
constant-widening and property-only modes (``incr/``).

The counterpart of ``TrapCounter`` and ``TrapCounterCompiled`` in
``stateright_tpu/models/fixtures.py``.  The states 0, 1, ..., ``limit``
count up, and at ``trap_at`` a second edge leads to the dead end
``trap_state = limit + 1``.  "reaches one" holds on every path (its bit
clears mid-path); "reaches limit" has a counterexample ending in the trap;
"trapped" is found there.  The states have no symmetric structure, so the
canonicalization is the identity: a run under ``symmetry()`` must equal
the plain run.

:func:`trap_step` and :func:`grid_walk` launch ``csrc/fixtures_step.cu`` on
a CUDA tensor and run their twins, :func:`trap_step_plain` and
:func:`grid_walk_plain`, on a CPU tensor.
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
        cuda.ptr(valid), cuda.ptr(conds), cuda.stream(),
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
              cuda.ptr(conds), cuda.stream())
    cuda.check(code, "fixtures_step", "grid_walk")
    return nexts, valid, conds


grid_walk.launches = 0


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
