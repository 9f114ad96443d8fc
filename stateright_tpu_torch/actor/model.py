"""``ActorModel``: adapts an actor system to the ``Model`` interface.

The counterpart of ``stateright_tpu/actor/model.py`` (reference:
src/actor/model.rs, src/actor/model_state.rs) for the configurations the
port compiles: a lossless, crash-free, timer-free system on the unordered
nonduplicating or the ordered network, whose only action family is
``Deliver`` of each distinct deliverable envelope -- each channel head on
the ordered fabric (src/actor/model.rs:269-333).  A handler no-op is no
successor, except on the ordered fabric, where consuming the channel head
changes the state (src/actor/model.rs:364).  ``ActorModelState`` keeps
the JAX class's name and fields (timers, random choices, crash flags and
storages stay at their empty values), so states fingerprint the same in
both packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

from ..core.model import Model, Property
from .base import Actor, Out, SendCmd, is_no_op
from .ids import Id
from .network import Envelope, Network


@dataclass(frozen=True)
class Deliver:
    src: Id
    dst: Id
    msg: Any


@dataclass(frozen=True)
class ActorModelState:
    actor_states: Tuple[Any, ...]
    network: Network
    timers_set: Tuple[Any, ...]  # per actor: frozenset() (no timers)
    random_choices: Tuple[Any, ...]  # per actor: () (no random choices)
    crashed: Tuple[bool, ...]  # per actor: False (no crashes)
    history: Any
    actor_storages: Tuple[Any, ...]  # per actor: None (no storage)


class ActorModel(Model):
    """Reference: src/actor/model.rs:24-188 (builder) and the Model impl."""

    def __init__(self, cfg: Any = None, init_history: Any = None):
        self.actors: List[Actor] = []
        self.cfg = cfg
        self.init_history = init_history
        self.init_network = Network.new_unordered_nonduplicating()
        self._properties: List[Property] = []
        self._record_msg_in: Callable = lambda cfg, h, env: None
        self._record_msg_out: Callable = lambda cfg, h, env: None
        self._within_boundary: Callable = lambda cfg, state: True

    # --- fluent builder -----------------------------------------------------

    def add_actors(self, actors) -> "ActorModel":
        self.actors.extend(actors)
        return self

    def init_network_(self, network: Network) -> "ActorModel":
        self.init_network = network
        return self

    def property(self, expectation, name: str, condition) -> "ActorModel":
        self._properties.append(Property(expectation, name, condition))
        return self

    def record_msg_in(self, fn) -> "ActorModel":
        """fn(cfg, history, envelope) -> new history or None."""
        self._record_msg_in = fn
        return self

    def record_msg_out(self, fn) -> "ActorModel":
        self._record_msg_out = fn
        return self

    def within_boundary_(self, fn) -> "ActorModel":
        self._within_boundary = fn
        return self

    # --- Model impl ---------------------------------------------------------

    def properties(self) -> List[Property]:
        return list(self._properties)

    def within_boundary(self, state) -> bool:
        return self._within_boundary(self.cfg, state)

    def _sends(self, id: Id, out: Out, network: Network, history):
        """Apply a handler's sends (src/actor/model.rs:191-235): each is
        recorded into the history, then added to the network."""
        for c in out.commands:
            if not isinstance(c, SendCmd):
                raise TypeError(f"unsupported actor command {c!r}")
            env = Envelope(id, c.dst, c.msg)
            recorded = self._record_msg_out(self.cfg, history, env)
            if recorded is not None:
                history = recorded
            network = network.send(env)
        return network, history

    def init_states(self) -> List[ActorModelState]:
        n = len(self.actors)
        network, history = self.init_network, self.init_history
        actor_states = []
        for index, actor in enumerate(self.actors):
            out = Out()
            actor_states.append(actor.on_start(Id(index), None, out))
            network, history = self._sends(Id(index), out, network, history)
        return [ActorModelState(
            actor_states=tuple(actor_states),
            network=network,
            timers_set=(frozenset(),) * n,
            random_choices=((),) * n,
            crashed=(False,) * n,
            history=history,
            actor_storages=(None,) * n,
        )]

    def actions(self, state: ActorModelState, actions: List[Any]) -> None:
        for env in state.network.iter_deliverable():
            if int(env.dst) < len(self.actors):
                actions.append(Deliver(env.src, env.dst, env.msg))

    def next_state(
        self, last: ActorModelState, action: Deliver
    ) -> Optional[ActorModelState]:
        # Reference: src/actor/model.rs:335-380.
        index = int(action.dst)
        out = Out()
        next_actor_state = self.actors[index].on_msg(
            action.dst, last.actor_states[index], action.src, action.msg, out
        )
        if is_no_op(next_actor_state, out) and not self.init_network.is_ordered:
            return None
        env = Envelope(action.src, action.dst, action.msg)
        history = last.history
        recorded = self._record_msg_in(self.cfg, history, env)
        if recorded is not None:
            history = recorded
        actor_states = list(last.actor_states)
        if next_actor_state is not None:
            actor_states[index] = next_actor_state
        network, history = self._sends(
            action.dst, out, last.network.on_deliver(env), history
        )
        return ActorModelState(
            actor_states=tuple(actor_states),
            network=network,
            timers_set=last.timers_set,
            random_choices=last.random_choices,
            crashed=last.crashed,
            history=history,
            actor_storages=last.actor_storages,
        )

    def format_action(self, action) -> str:
        return f"{action.src!r} → {action.msg!r} → {action.dst!r}"
