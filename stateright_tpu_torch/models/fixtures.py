"""The trap counter: the engine's fixture for eventually properties and the
identity canonicalization (kernel K17).

The counterpart of ``TrapCounter`` and ``TrapCounterCompiled`` in
``stateright_tpu/models/fixtures.py``.  The states 0, 1, ..., ``limit``
count up, and at ``trap_at`` a second edge leads to the dead end
``trap_state = limit + 1``.  "reaches one" holds on every path (its bit
clears mid-path); "reaches limit" has a counterexample ending in the trap;
"trapped" is found there.  The states have no symmetric structure, so the
canonicalization is the identity: a run under ``symmetry()`` must equal
the plain run.

:func:`trap_step` launches ``csrc/fixtures_step.cu`` on a CUDA tensor and
runs :func:`trap_step_plain`, its twin, on a CPU tensor.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.model import Model, Property
from ..ops import cuda
from ..ops.u32 import M32, i32, u32
from ..parallel.compiled import CompiledModel

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
        return nexts, valid, conds, None

    def walk_step(self, states: torch.Tensor, plain: bool = False):
        nexts, valid, conds = (trap_step_plain if plain else trap_step)(
            states, *self._consts())
        return nexts, valid, conds, None

    def canon_spec(self):
        """No symmetric records: the empty spec, the identity."""
        from ..parallel.canon import CanonSpec

        return CanonSpec(n=0)


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
