"""Register test harness: a message interface for register-like actors plus
a scripted client, and hooks wiring Get/Put traffic into a consistency
tester's history.

A copy of ``stateright_tpu/actor/register.py`` (reference:
src/actor/register.rs); class names and fields are the JAX package's, so
states fingerprint the same in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from ..semantics.register import READ, WRITE_OK, ReadOk, WriteOp
from .base import Actor, Out
from .ids import Id


# --- the message protocol (reference: RegisterMsg, src/actor/register.rs:17-30)


@dataclass(frozen=True)
class Internal:
    """Wraps a message specific to the register system's internal protocol."""

    msg: Any


@dataclass(frozen=True)
class Put:
    request_id: int
    value: Any


@dataclass(frozen=True)
class Get:
    request_id: int


@dataclass(frozen=True)
class PutOk:
    request_id: int


@dataclass(frozen=True)
class GetOk:
    request_id: int
    value: Any


def record_invocations(_cfg, history, env) -> Optional[Any]:
    """Pass to ``ActorModel.record_msg_out``: records ``ReadOp`` upon ``Get``
    and ``WriteOp`` upon ``Put``.  Reference: src/actor/register.rs:38-60."""
    if isinstance(env.msg, Get):
        h = history.clone()
        try:
            h.on_invoke(env.src, READ)
        except ValueError:
            pass  # invalid histories poison the tester, matching reference
        return h
    if isinstance(env.msg, Put):
        h = history.clone()
        try:
            h.on_invoke(env.src, WriteOp(env.msg.value))
        except ValueError:
            pass
        return h
    return None


def record_returns(_cfg, history, env) -> Optional[Any]:
    """Pass to ``ActorModel.record_msg_in``: records ``ReadOk`` upon
    ``GetOk`` and ``WriteOk`` upon ``PutOk``.
    Reference: src/actor/register.rs:66-90."""
    if isinstance(env.msg, GetOk):
        h = history.clone()
        try:
            h.on_return(env.dst, ReadOk(env.msg.value))
        except ValueError:
            pass
        return h
    if isinstance(env.msg, PutOk):
        h = history.clone()
        try:
            h.on_return(env.dst, WRITE_OK)
        except ValueError:
            pass
        return h
    return None


# --- actors (reference: RegisterActor, src/actor/register.rs:93-277) --------


@dataclass(frozen=True)
class ClientState:
    awaiting: Optional[int]
    op_count: int


class RegisterClient(Actor):
    """A scripted client: ``put_count`` Puts (round-robining servers) then a
    final Get.  Servers must precede clients in the actor list so server ids
    are ``0..server_count``."""

    def __init__(self, put_count: int, server_count: int):
        self.put_count = put_count
        self.server_count = server_count

    def name(self) -> str:
        return "Client"

    def on_start(self, id: Id, storage, o: Out):
        index = int(id)
        if index < self.server_count:
            raise RuntimeError(
                "RegisterClient actors must be added to the model after servers."
            )
        if self.put_count == 0:
            return ClientState(awaiting=None, op_count=0)
        unique_request_id = 1 * index  # next will be 2 * index
        value = chr(ord("A") + (index - self.server_count))
        o.send(Id(index % self.server_count), Put(unique_request_id, value))
        return ClientState(awaiting=unique_request_id, op_count=1)

    def on_msg(self, id: Id, state, src: Id, msg, o: Out):
        if not isinstance(state, ClientState) or state.awaiting is None:
            return None
        index = int(id)
        if isinstance(msg, PutOk) and msg.request_id == state.awaiting:
            unique_request_id = (state.op_count + 1) * index
            if state.op_count < self.put_count:
                value = chr(ord("Z") - (index - self.server_count))
                o.send(
                    Id((index + state.op_count) % self.server_count),
                    Put(unique_request_id, value),
                )
            else:
                o.send(
                    Id((index + state.op_count) % self.server_count),
                    Get(unique_request_id),
                )
            return ClientState(awaiting=unique_request_id, op_count=state.op_count + 1)
        if isinstance(msg, GetOk) and msg.request_id == state.awaiting:
            return ClientState(awaiting=None, op_count=state.op_count + 1)
        return None


class RegisterServer(Actor):
    """Wraps a server actor under test (the reference's
    ``RegisterActor::Server``); delegates every event."""

    def __init__(self, server_actor: Actor):
        self.server_actor = server_actor

    def name(self) -> str:
        return self.server_actor.name() or "Server"

    def on_start(self, id, storage, o: Out):
        return self.server_actor.on_start(id, storage, o)

    def on_msg(self, id, state, src, msg, o: Out):
        return self.server_actor.on_msg(id, state, src, msg, o)

