"""Last-write-wins register: a state-based CRDT driven by random choices.

The counterpart of ``stateright_tpu/models/lww_register.py`` (reference:
examples/lww-register.rs) without its CLI: each node nondeterministically
(``choose_random``) sets a value or skews its local clock, broadcasting
its register to every node, itself included; a receiver merges by
(timestamp, updater id).  "eventually consistent" is CRDT-style: the
registers must agree whenever the network is empty
(examples/lww-register.rs:166-182).  The reference checks it depth-bounded
(``target_max_depth(8)``); the packed codec (``lww_compiled.py``) flags
an overflow before that depth, as the JAX codec does.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional, Tuple

from ..actor import Actor, ActorModel, Id, Network, Out
from ..core.model import Expectation

VALUES = ("A", "B", "C")


@dataclass(frozen=True)
class LwwRegister:
    value: Any
    timestamp: int
    updater_id: int

    @staticmethod
    def merge(a: "LwwRegister", b: "LwwRegister") -> "LwwRegister":
        return a if (a.timestamp, a.updater_id) > (b.timestamp, b.updater_id) else b


@dataclass(frozen=True)
class SetValue:
    value: Any


@dataclass(frozen=True)
class SetTime:
    time: int


@dataclass(frozen=True)
class LwwActorState:
    register: Optional[LwwRegister]
    local_clock: int
    maximum_used_clock: int


class LwwActor(Actor):
    def __init__(self, peers: Tuple[Id, ...]):
        self.peers = tuple(peers)

    def name(self) -> str:
        return "LWW Node"

    def _populate_choices(self, o: Out, time: int) -> None:
        o.choose_random(
            "node_action",
            [SetValue(v) for v in VALUES]
            + [SetTime(time + 1), SetTime(max(time - 1, 0))],
        )

    def on_start(self, id: Id, storage, o: Out) -> LwwActorState:
        state = LwwActorState(
            register=None, local_clock=1000, maximum_used_clock=1000
        )
        self._populate_choices(o, state.local_clock)
        return state

    def on_random(self, id: Id, state: LwwActorState, random, o: Out):
        if isinstance(random, SetValue):
            if state.register is not None:
                # Clock values stay unique per node.
                clock_value = max(
                    state.local_clock, state.maximum_used_clock + 1
                )
                state = replace(
                    state,
                    register=LwwRegister(random.value, clock_value, int(id)),
                    maximum_used_clock=clock_value,
                )
            else:
                state = replace(
                    state,
                    register=LwwRegister(
                        random.value, state.local_clock, int(id)
                    ),
                )
            o.broadcast(self.peers, state.register)
        elif isinstance(random, SetTime):
            state = replace(state, local_clock=random.time)
        self._populate_choices(o, state.local_clock)
        return state

    def on_msg(self, id: Id, state: LwwActorState, src: Id, msg, o: Out):
        if state.register is not None:
            return replace(state, register=LwwRegister.merge(state.register, msg))
        return replace(state, register=msg)


def build_model(num_actors: int = 2) -> ActorModel:
    """examples/lww-register.rs:153-185, on the unordered nonduplicating
    network; every node's peers are all the nodes."""
    nodes = tuple(Id(i) for i in range(num_actors))

    def eventually_consistent(_m, state):
        if len(state.network) == 0:
            regs = [s.register for s in state.actor_states]
            return all(r == regs[0] for r in regs)
        return True

    model = ActorModel(cfg=None)
    model.add_actors(LwwActor(nodes) for _ in range(num_actors))

    def _compiled():
        from .lww_compiled import LwwCompiled

        return LwwCompiled(model)

    model.compiled = _compiled
    return model.init_network_(
        Network.new_unordered_nonduplicating()
    ).property(
        Expectation.ALWAYS, "eventually consistent", eventually_consistent
    )


def cli_spec():
    """This module's workload spec (resolved by ``serve/workloads.py``)."""
    from ..cli import CliSpec

    return CliSpec(
        name="LWW-register CRDT",
        build=lambda n: build_model(num_actors=n),
        default_n=2,
        n_meta="ACTOR_COUNT",
        # The reference's check bounds depth at 8
        # (examples/lww-register.rs:194-196); the device run bounds tighter
        # to fit its default table.
        target_max_depth=8,
        gpu=True,
        gpu_kwargs=dict(capacity=1 << 16, max_frontier=1 << 9),
        gpu_target_max_depth=6,
    )
