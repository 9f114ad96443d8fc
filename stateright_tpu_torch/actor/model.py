"""``ActorModel``: adapts an actor system to the ``Model`` interface.

The counterpart of ``stateright_tpu/actor/model.py`` (reference:
src/actor/model.rs, src/actor/model_state.rs) for the configurations the
port compiles, on any of the three networks, lossy or not.  Its action
families, in the reference's enumeration order (src/actor/model.rs:
269-333): for each distinct deliverable envelope (each channel head on the
ordered fabric), its ``Drop`` when the network is lossy and its
``Deliver``; one ``Timeout`` per pending timer; ``Crash`` of each live
actor while fewer than ``max_crashes`` are down; ``Recover`` of each
crashed one; and a ``SelectRandom`` for each choice of each pending
random choice set.  A handler no-op is no successor, except on the ordered
fabric, where consuming the channel head changes the state
(src/actor/model.rs:364); a timeout whose handler only renews its timer
is none either, and any other fired timer is consumed.  A ``Drop``
changes only the network; a ``SelectRandom`` always makes a successor,
consuming its choice set before the handler's commands apply (the
handler may choose again), and a crash forgets the actor's sets.
``ActorModelState`` keeps the JAX class's name and fields and the JAX
encoding of random choices (per actor, a tuple of ``(key, choices)``
items sorted by key; storages stay None), so states fingerprint the same
in both packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

from ..core.model import Model, Property
from ..ops.fingerprint import fingerprint
from .base import (
    Actor, CancelTimerCmd, ChooseRandomCmd, Out, SendCmd, SetTimerCmd,
    is_no_op, is_no_op_with_timer,
)
from .ids import Id
from .network import Envelope, Network


@dataclass(frozen=True)
class Deliver:
    src: Id
    dst: Id
    msg: Any


@dataclass(frozen=True)
class Drop:
    envelope: Envelope


@dataclass(frozen=True)
class Timeout:
    id: Id
    timer: Any


@dataclass(frozen=True)
class Crash:
    id: Id


@dataclass(frozen=True)
class Recover:
    id: Id


@dataclass(frozen=True)
class SelectRandom:
    actor: Id
    key: str
    random: Any


@dataclass(frozen=True)
class ActorModelState:
    actor_states: Tuple[Any, ...]
    network: Network
    timers_set: Tuple[Any, ...]  # per actor: frozenset of pending timers
    random_choices: Tuple[Any, ...]  # per actor: ((key, choices), ...) by key
    crashed: Tuple[bool, ...]
    history: Any
    actor_storages: Tuple[Any, ...]  # per actor: None (no storage)


class ActorModel(Model):
    """Reference: src/actor/model.rs:24-188 (builder) and the Model impl."""

    def __init__(self, cfg: Any = None, init_history: Any = None):
        self.actors: List[Actor] = []
        self.cfg = cfg
        self.init_history = init_history
        self.init_network = Network.new_unordered_duplicating()
        self.lossy_network: bool = False
        self.max_crashes: int = 0
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

    def lossy_network_(self, lossy: bool) -> "ActorModel":
        self.lossy_network = lossy
        return self

    def max_crashes_(self, n: int) -> "ActorModel":
        self.max_crashes = n
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

    def _process_commands(self, id: Id, out: Out, network: Network, history,
                          timers: List[Any], randoms: List[Any]):
        """Apply a handler's commands (src/actor/model.rs:191-235): a send
        is recorded into the history, then added to the network; a timer
        or random-choice command updates the actor's entry of ``timers``
        or ``randoms`` in place.  Returns the new network and history."""
        index = int(id)
        for c in out.commands:
            if isinstance(c, SendCmd):
                env = Envelope(id, c.dst, c.msg)
                recorded = self._record_msg_out(self.cfg, history, env)
                if recorded is not None:
                    history = recorded
                network = network.send(env)
            elif isinstance(c, SetTimerCmd):
                timers[index] = timers[index] | {c.timer}
            elif isinstance(c, CancelTimerCmd):
                timers[index] = timers[index] - {c.timer}
            elif isinstance(c, ChooseRandomCmd):
                choices = dict(randoms[index])
                if c.choices:
                    choices[c.key] = tuple(c.choices)
                else:
                    choices.pop(c.key, None)
                randoms[index] = tuple(sorted(choices.items()))
            else:
                raise TypeError(f"unsupported actor command {c!r}")
        return network, history

    def init_states(self) -> List[ActorModelState]:
        n = len(self.actors)
        network, history = self.init_network, self.init_history
        timers = [frozenset()] * n
        randoms = [()] * n
        actor_states = []
        for index, actor in enumerate(self.actors):
            out = Out()
            actor_states.append(actor.on_start(Id(index), None, out))
            network, history = self._process_commands(
                Id(index), out, network, history, timers, randoms
            )
        return [ActorModelState(
            actor_states=tuple(actor_states),
            network=network,
            timers_set=tuple(timers),
            random_choices=tuple(randoms),
            crashed=(False,) * n,
            history=history,
            actor_storages=(None,) * n,
        )]

    def actions(self, state: ActorModelState, actions: List[Any]) -> None:
        # Reference: src/actor/model.rs:269-333 (same enumeration order).
        for env in state.network.iter_deliverable():
            if self.lossy_network:
                actions.append(Drop(env))
            if int(env.dst) < len(self.actors):
                actions.append(Deliver(env.src, env.dst, env.msg))
        for index, timers in enumerate(state.timers_set):
            for timer in sorted(timers, key=fingerprint):
                actions.append(Timeout(Id(index), timer))
        if sum(state.crashed) < self.max_crashes:
            for index, crashed in enumerate(state.crashed):
                if not crashed:
                    actions.append(Crash(Id(index)))
        for index, crashed in enumerate(state.crashed):
            if crashed:
                actions.append(Recover(Id(index)))
        for index, choices in enumerate(state.random_choices):
            for key, decision in choices:
                for choice in decision:
                    actions.append(SelectRandom(Id(index), key, choice))

    def next_state(
        self, last: ActorModelState, action: Any
    ) -> Optional[ActorModelState]:
        # Reference: src/actor/model.rs:335-457.
        if isinstance(action, Drop):
            return dataclasses.replace(
                last, network=last.network.on_drop(action.envelope)
            )
        if isinstance(action, Deliver):
            index = int(action.dst)
            if index >= len(last.actor_states) or last.crashed[index]:
                return None
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
            return self._successor(
                last, index, next_actor_state, out,
                last.network.on_deliver(env), history,
            )
        if isinstance(action, Timeout):
            index = int(action.id)
            out = Out()
            next_actor_state = self.actors[index].on_timeout(
                action.id, last.actor_states[index], action.timer, out
            )
            if is_no_op_with_timer(next_actor_state, out, action.timer):
                return None
            # The fired timer is consumed unless the handler sets it again.
            timers = list(last.timers_set)
            timers[index] = timers[index] - {action.timer}
            return self._successor(
                last, index, next_actor_state, out, last.network,
                last.history, timers,
            )
        if isinstance(action, Crash):
            index = int(action.id)
            timers = list(last.timers_set)
            timers[index] = frozenset()
            randoms = list(last.random_choices)
            randoms[index] = ()
            crashed = list(last.crashed)
            crashed[index] = True
            return dataclasses.replace(
                last, timers_set=tuple(timers), random_choices=tuple(randoms),
                crashed=tuple(crashed),
            )
        if isinstance(action, Recover):
            index = int(action.id)
            assert last.crashed[index]
            out = Out()
            state = self.actors[index].on_start(
                action.id, last.actor_storages[index], out
            )
            crashed = list(last.crashed)
            crashed[index] = False
            return dataclasses.replace(
                self._successor(last, index, state, out, last.network, last.history),
                crashed=tuple(crashed),
            )
        if isinstance(action, SelectRandom):
            index = int(action.actor)
            out = Out()
            next_actor_state = self.actors[index].on_random(
                action.actor, last.actor_states[index], action.random, out
            )
            # The chosen set is consumed; the handler may choose again.
            randoms = list(last.random_choices)
            randoms[index] = tuple(
                kv for kv in randoms[index] if kv[0] != action.key
            )
            return self._successor(
                last, index, next_actor_state, out, last.network,
                last.history, randoms=randoms,
            )
        raise TypeError(f"unknown action {action!r}")

    def _successor(self, last, index, next_actor_state, out, network, history,
                   timers=None, randoms=None) -> ActorModelState:
        """``last`` with actor ``index``'s state replaced (unless None) and
        the handler's commands applied."""
        actor_states = list(last.actor_states)
        if next_actor_state is not None:
            actor_states[index] = next_actor_state
        timers = list(last.timers_set if timers is None else timers)
        randoms = list(last.random_choices if randoms is None else randoms)
        network, history = self._process_commands(
            Id(index), out, network, history, timers, randoms
        )
        return ActorModelState(
            actor_states=tuple(actor_states),
            network=network,
            timers_set=tuple(timers),
            random_choices=tuple(randoms),
            crashed=last.crashed,
            history=history,
            actor_storages=last.actor_storages,
        )

    def format_action(self, action) -> str:
        if isinstance(action, Deliver):
            return f"{action.src!r} → {action.msg!r} → {action.dst!r}"
        if isinstance(action, SelectRandom):
            return f"{action.actor!r} select random {action.random!r}"
        return repr(action)
