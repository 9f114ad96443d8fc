"""Abstract two-phase commit, after Gray & Lamport's "Consensus on
Transaction Commit".

Reference: examples/2pc.rs — a direct ``Model`` (no actors) with a message
*set*; golden counts: 288 unique states at 3 RMs, 8,832 at 5 RMs, 665 at
5 RMs with symmetry reduction (examples/2pc.rs:151-170).

The state bit-packs into a few dozen bits (2 bits/RM + 2 bits TM + N
prepared bits + N+2 message bits) for the GPU engine, see
models/twophase_compiled.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import FrozenSet, Tuple

from ..core.model import Model, Property

# RM states (the reference's derived Ord: Working < Prepared < Committed <
# Aborted).
WORKING, PREPARED, COMMITTED, ABORTED = 0, 1, 2, 3
# TM states.
TM_INIT, TM_COMMITTED, TM_ABORTED = 0, 1, 2

# Messages: ("prepared", rm) | ("commit",) | ("abort",)
MSG_COMMIT = ("commit",)
MSG_ABORT = ("abort",)


def msg_prepared(rm: int) -> Tuple[str, int]:
    return ("prepared", rm)


@dataclass(frozen=True)
class TwoPhaseState:
    rm_state: Tuple[int, ...]
    tm_state: int
    tm_prepared: Tuple[bool, ...]
    msgs: FrozenSet[tuple]


@dataclass(frozen=True)
class TwoPhaseSys(Model):
    rm_count: int

    def init_states(self):
        return [
            TwoPhaseState(
                rm_state=(WORKING,) * self.rm_count,
                tm_state=TM_INIT,
                tm_prepared=(False,) * self.rm_count,
                msgs=frozenset(),
            )
        ]

    def actions(self, state, actions):
        # Reference: examples/2pc.rs:72-96 (same enumeration order).
        if state.tm_state == TM_INIT and all(state.tm_prepared):
            actions.append(("TmCommit",))
        if state.tm_state == TM_INIT:
            actions.append(("TmAbort",))
        for rm in range(self.rm_count):
            if state.tm_state == TM_INIT and msg_prepared(rm) in state.msgs:
                actions.append(("TmRcvPrepared", rm))
            if state.rm_state[rm] == WORKING:
                actions.append(("RmPrepare", rm))
            if state.rm_state[rm] == WORKING:
                actions.append(("RmChooseToAbort", rm))
            if MSG_COMMIT in state.msgs:
                actions.append(("RmRcvCommitMsg", rm))
            if MSG_ABORT in state.msgs:
                actions.append(("RmRcvAbortMsg", rm))

    def next_state(self, s, action):
        kind = action[0]
        rm_state, tm_state, tm_prepared, msgs = (
            s.rm_state,
            s.tm_state,
            s.tm_prepared,
            s.msgs,
        )
        if kind == "TmRcvPrepared":
            rm = action[1]
            tm_prepared = tm_prepared[:rm] + (True,) + tm_prepared[rm + 1 :]
        elif kind == "TmCommit":
            tm_state = TM_COMMITTED
            msgs = msgs | {MSG_COMMIT}
        elif kind == "TmAbort":
            tm_state = TM_ABORTED
            msgs = msgs | {MSG_ABORT}
        elif kind == "RmPrepare":
            rm = action[1]
            rm_state = rm_state[:rm] + (PREPARED,) + rm_state[rm + 1 :]
            msgs = msgs | {msg_prepared(rm)}
        elif kind == "RmChooseToAbort":
            rm = action[1]
            rm_state = rm_state[:rm] + (ABORTED,) + rm_state[rm + 1 :]
        elif kind == "RmRcvCommitMsg":
            rm = action[1]
            rm_state = rm_state[:rm] + (COMMITTED,) + rm_state[rm + 1 :]
        elif kind == "RmRcvAbortMsg":
            rm = action[1]
            rm_state = rm_state[:rm] + (ABORTED,) + rm_state[rm + 1 :]
        else:
            raise ValueError(action)
        return TwoPhaseState(rm_state, tm_state, tm_prepared, msgs)

    def compiled(self):
        """The packed device form the GPU engine checks."""
        from .twophase_compiled import TwoPhaseCompiled

        return TwoPhaseCompiled(self)

    def properties(self):
        return [
            Property.sometimes(
                "abort agreement",
                lambda _m, s: all(r == ABORTED for r in s.rm_state),
            ),
            Property.sometimes(
                "commit agreement",
                lambda _m, s: all(r == COMMITTED for r in s.rm_state),
            ),
            Property.always(
                "consistent",
                lambda _m, s: not (
                    ABORTED in s.rm_state and COMMITTED in s.rm_state
                ),
            ),
        ]


def cli_spec():
    """This module's workload spec (resolved by ``serve/workloads.py``)."""
    from ..cli import CliSpec

    return CliSpec(
        name="two-phase commit",
        build=lambda n: TwoPhaseSys(rm_count=n),
        default_n=3,
        n_meta="RM_COUNT",
        symmetry=True,
        gpu=True,
        gpu_kwargs=dict(capacity=1 << 20, max_frontier=1 << 13),
    )
