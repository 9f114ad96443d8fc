"""Bit-packed device form of the two-phase-commit model (kernel K2).

The counterpart of ``stateright_tpu/models/twophase_compiled.py``, with the
same packing (W=2 uint32 words for up to 12 RMs):

- word0: RM states, 2 bits each at bit 2*i (WORKING/PREPARED/COMMITTED/
  ABORTED); TM state (2 bits) at bit 24.
- word1: tm_prepared bitmap at bits [0, N); the message set as N+2
  presence bits: ``Prepared(i)`` at bit N+i, ``Commit`` at bit 2N,
  ``Abort`` at bit 2N+1.

Action arity A = 2 + 5N, in the host enumeration order (TmCommit, TmAbort,
then per RM TmRcvPrepared / RmPrepare / RmChooseToAbort / RmRcvCommitMsg /
RmRcvAbortMsg).  2pc's ``next_state`` never returns None, so a lane is
valid iff its guard holds.

The step and the property conditions are one fused kernel (K2,
``csrc/twophase_step.cu``) on a CUDA tensor; :func:`twophase_step_plain` is
its plain-torch twin, run for CPU tensors.  The conditions alone are K2c
(:func:`twophase_conds`, the same source), which ``property_conds`` launches;
a subclass that overrides ``property_conds`` has its conditions taken from
that override in ``expand`` and ``walk_step`` too, and K2's fused ones only
where it does not.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops import cuda
from ..ops.u32 import M32, i32, u32
from ..parallel.compiled import CompiledModel, fused_conds, override_conds
from .twophase import (
    ABORTED,
    COMMITTED,
    MSG_ABORT,
    MSG_COMMIT,
    PREPARED,
    TM_ABORTED,
    TM_COMMITTED,
    TM_INIT,
    TwoPhaseState,
    TwoPhaseSys,
    WORKING,
    msg_prepared,
)

_TM_SHIFT = 24
N_PROPS = 3


def twophase_step(
    states: torch.Tensor, n: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All successors and the property conditions of packed 2pc states:
    ``int32[F, 2] -> (nexts int32[F, A, 2], valid bool[F, A],
    conds bool[F, 3])`` with A = 2 + 5n."""
    if not 1 <= n <= 12:
        raise ValueError("packed 2pc encoding supports 1 to 12 RMs")
    if states.device.type == "cpu":
        return twophase_step_plain(states, n)
    cuda.require(states, "states", torch.int32, 2, states.device)
    if states.shape[1] != 2:
        raise ValueError(f"states must be [F, 2], got {tuple(states.shape)}")
    f = states.shape[0]
    a = 2 + 5 * n
    dev = states.device
    nexts = torch.empty((f, a, 2), dtype=torch.int32, device=dev)
    valid = torch.empty((f, a), dtype=torch.bool, device=dev)
    conds = torch.empty((f, N_PROPS), dtype=torch.bool, device=dev)
    fn = cuda.function(
        "twophase_step", "sr_twophase_step",
        [cuda.P, cuda.I64, cuda.I32, cuda.P, cuda.P, cuda.P, cuda.P],
    )
    twophase_step.launches += 1
    code = fn(
        cuda.ptr(states), f, n, cuda.ptr(nexts), cuda.ptr(valid),
        cuda.ptr(conds), cuda.stream(nexts),
    )
    cuda.check(code, "twophase_step", "twophase_step")
    return nexts, valid, conds


twophase_step.launches = 0


def twophase_conds_plain(
    states: torch.Tensor, n: int, some_prepared: bool = False
) -> torch.Tensor:
    """Plain-torch twin of K2c (any device): ``int32[F, 2] -> bool[F, P]``,
    2pc's three conds (``twophase_step_plain``'s), with ``some_prepared``
    the column "some rm prepared" appended (P = 4)."""
    w0 = u32(states[:, 0])
    rs = torch.stack([(w0 >> (2 * rm)) & 3 for rm in range(n)], dim=1)
    conds = [
        (rs == ABORTED).all(1),
        (rs == COMMITTED).all(1),
        ~((rs == ABORTED).any(1) & (rs == COMMITTED).any(1)),
    ]
    if some_prepared:
        conds.append((rs == PREPARED).any(1))
    return torch.stack(conds, dim=1)


def twophase_conds(
    states: torch.Tensor, n: int, some_prepared: bool = False
) -> torch.Tensor:
    """The property conditions of packed 2pc states alone, no successors
    (K2c): see :func:`twophase_conds_plain`."""
    if not 1 <= n <= 12:
        raise ValueError("packed 2pc encoding supports 1 to 12 RMs")
    if states.device.type == "cpu":
        return twophase_conds_plain(states, n, some_prepared)
    cuda.require(states, "states", torch.int32, 2, states.device)
    if states.shape[1] != 2:
        raise ValueError(f"states must be [F, 2], got {tuple(states.shape)}")
    f = states.shape[0]
    conds = torch.empty((f, N_PROPS + int(some_prepared)), dtype=torch.bool,
                        device=states.device)
    fn = cuda.function(
        "twophase_step", "sr_twophase_conds",
        [cuda.P, cuda.I64, cuda.I32, cuda.I32, cuda.P, cuda.P],
    )
    twophase_conds.launches += 1
    code = fn(cuda.ptr(states), f, n, int(some_prepared), cuda.ptr(conds),
              cuda.stream(conds))
    cuda.check(code, "twophase_step", "twophase_conds")
    return conds


twophase_conds.launches = 0


def twophase_step_plain(
    states: torch.Tensor, n: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-torch twin of the K2 kernel (any device); guards and bit
    layout follow the JAX ``TwoPhaseCompiled.step`` / ``property_conds``."""
    w0 = u32(states[:, 0])
    w1 = u32(states[:, 1])
    tm_init = ((w0 >> _TM_SHIFT) & 3) == TM_INIT
    prepared_mask = (1 << n) - 1
    all_prepared = (w1 & prepared_mask) == prepared_mask
    commit_msg = ((w1 >> (2 * n)) & 1) == 1
    abort_msg = ((w1 >> (2 * n + 1)) & 1) == 1
    w0_tm_cleared = w0 & (~(3 << _TM_SHIFT) & M32)

    valids, nexts0, nexts1 = [], [], []

    def emit(valid, nw0, nw1):
        valids.append(valid)
        nexts0.append(nw0)
        nexts1.append(nw1)

    # TmCommit (examples/2pc.rs:100-102)
    emit(
        tm_init & all_prepared,
        w0_tm_cleared | (TM_COMMITTED << _TM_SHIFT),
        w1 | (1 << (2 * n)),
    )
    # TmAbort
    emit(tm_init, w0_tm_cleared | (TM_ABORTED << _TM_SHIFT), w1 | (1 << (2 * n + 1)))
    for rm in range(n):
        rm_working = ((w0 >> (2 * rm)) & 3) == WORKING
        prep_msg = ((w1 >> (n + rm)) & 1) == 1
        w0_rm_cleared = w0 & (~(3 << (2 * rm)) & M32)
        emit(tm_init & prep_msg, w0, w1 | (1 << rm))  # TmRcvPrepared(rm)
        emit(  # RmPrepare(rm)
            rm_working,
            w0_rm_cleared | (PREPARED << (2 * rm)),
            w1 | (1 << (n + rm)),
        )
        emit(rm_working, w0_rm_cleared | (ABORTED << (2 * rm)), w1)  # RmChooseToAbort
        emit(commit_msg, w0_rm_cleared | (COMMITTED << (2 * rm)), w1)  # RmRcvCommitMsg
        emit(abort_msg, w0_rm_cleared | (ABORTED << (2 * rm)), w1)  # RmRcvAbortMsg

    nexts = torch.stack(
        [torch.stack(nexts0, dim=1), torch.stack(nexts1, dim=1)], dim=-1
    )
    valid = torch.stack(valids, dim=1)

    committed = torch.zeros_like(tm_init)
    aborted = torch.zeros_like(tm_init)
    all_committed = torch.ones_like(tm_init)
    all_aborted = torch.ones_like(tm_init)
    for rm in range(n):
        rs = (w0 >> (2 * rm)) & 3
        committed = committed | (rs == COMMITTED)
        aborted = aborted | (rs == ABORTED)
        all_committed = all_committed & (rs == COMMITTED)
        all_aborted = all_aborted & (rs == ABORTED)
    # Order matches TwoPhaseSys.properties(): sometimes "abort agreement",
    # sometimes "commit agreement", always "consistent".
    conds = torch.stack([all_aborted, all_committed, ~(aborted & committed)], dim=1)
    return i32(nexts), valid, conds


class TwoPhaseCompiled(CompiledModel):
    state_width = 2

    def __init__(self, model: TwoPhaseSys):
        n = model.rm_count
        if n > 12:
            raise ValueError("packed 2pc encoding supports at most 12 RMs")
        self.model = model
        self.n = n
        self.max_actions = 2 + 5 * n

    # --- host side -----------------------------------------------------------

    def encode(self, s: TwoPhaseState) -> np.ndarray:
        n = self.n
        w0 = 0
        for i, rs in enumerate(s.rm_state):
            w0 |= rs << (2 * i)
        w0 |= s.tm_state << _TM_SHIFT
        w1 = 0
        for i, p in enumerate(s.tm_prepared):
            w1 |= int(p) << i
        for m in s.msgs:
            if m == MSG_COMMIT:
                w1 |= 1 << (2 * n)
            elif m == MSG_ABORT:
                w1 |= 1 << (2 * n + 1)
            else:  # ("prepared", rm)
                w1 |= 1 << (n + m[1])
        return np.array([w0, w1], dtype=np.uint32)

    def decode(self, words: Sequence[int]) -> TwoPhaseState:
        n = self.n
        w0, w1 = int(words[0]), int(words[1])
        rm_state = tuple((w0 >> (2 * i)) & 3 for i in range(n))
        tm_state = (w0 >> _TM_SHIFT) & 3
        tm_prepared = tuple(bool((w1 >> i) & 1) for i in range(n))
        msgs = set()
        for i in range(n):
            if (w1 >> (n + i)) & 1:
                msgs.add(msg_prepared(i))
        if (w1 >> (2 * n)) & 1:
            msgs.add(MSG_COMMIT)
        if (w1 >> (2 * n + 1)) & 1:
            msgs.add(MSG_ABORT)
        return TwoPhaseState(rm_state, tm_state, tm_prepared, frozenset(msgs))

    # --- device side ---------------------------------------------------------

    def step(self, states):
        nexts, valid, _conds = twophase_step(states, self.n)
        return nexts, valid

    def property_conds(self, states):
        return twophase_conds(states, self.n)

    def expand(self, states):
        nexts, valid, conds = twophase_step(states, self.n)
        if not fused_conds(self, TwoPhaseCompiled):
            conds = self.property_conds(states)
        return nexts, valid, conds, None

    def walk_step(self, states, plain=False):
        nexts, valid, conds = (twophase_step_plain if plain else twophase_step)(
            states, self.n)
        if not fused_conds(self, TwoPhaseCompiled):
            conds = override_conds(self, states, plain)
        return nexts, valid, conds, None

    def canon_spec(self):
        """An RM's record is three bit fields -- its state (word0, 2 bits
        at 2i), tm_prepared (word1, bit i) and its Prepared message (word1,
        bit n+i) -- so sorting whole records canonicalizes exactly the
        orbit; the TM state and the Commit/Abort bits are invariant under
        the permutation and stay."""
        from ..parallel.canon import CanonSpec, field

        n = self.n
        return CanonSpec(
            n=n,
            fields=(
                field(word=0, shift=0, width=2),  # rm_state
                field(word=1, shift=0, width=1),  # tm_prepared
                field(word=1, shift=n, width=1),  # Prepared(i) in msgs
            ),
        )
