"""The ``Actor`` abstraction and its command output.

The counterpart of ``stateright_tpu/actor/base.py`` (reference:
src/actor.rs) with the commands the port's actor models emit: a send, setting or
cancelling a timer, and a random choice set.  Handlers *return* the next
state, or
``None`` for "unchanged" (the reference's ``Cow::Borrowed``); a no-op is a
``None`` return with no commands, and a timeout whose handler only renews
its own timer is one too (:func:`is_no_op_with_timer`).  Storage saves
are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, List, Optional, Tuple

from .ids import Id


@dataclass(frozen=True)
class SendCmd:
    dst: Id
    msg: Any


@dataclass(frozen=True)
class SetTimerCmd:
    timer: Any
    duration: Tuple[float, float]  # seconds (lo, hi); irrelevant when checking


@dataclass(frozen=True)
class CancelTimerCmd:
    timer: Any


@dataclass(frozen=True)
class ChooseRandomCmd:
    key: str
    choices: Tuple[Any, ...]


def model_timeout() -> Tuple[float, float]:
    """Timeout durations are irrelevant for model checking
    (reference: src/actor/model.rs:79-81)."""
    return (0.0, 0.0)


def model_peers(self_ix: int, count: int) -> List[Id]:
    """Peer ids for actor ``self_ix`` out of ``count``
    (reference: src/actor/model.rs:85-90)."""
    return [Id(j) for j in range(count) if j != self_ix]


def majority(count: int) -> int:
    """Minimum size of a majority quorum (reference: src/actor.rs:634-638)."""
    return count // 2 + 1


class Out:
    """Collects the commands an actor handler emits.
    Reference: src/actor.rs:160-247."""

    __slots__ = ("commands",)

    def __init__(self):
        self.commands: List[Any] = []

    def send(self, recipient: Id, msg: Any) -> None:
        self.commands.append(SendCmd(Id(recipient), msg))

    def broadcast(self, recipients: Iterable[Id], msg: Any) -> None:
        for r in recipients:
            self.send(r, msg)

    def set_timer(self, timer: Any, duration: Tuple[float, float] = (0.0, 0.0)) -> None:
        self.commands.append(SetTimerCmd(timer, duration))

    def cancel_timer(self, timer: Any) -> None:
        self.commands.append(CancelTimerCmd(timer))

    def choose_random(self, key: str, choices: Iterable[Any]) -> None:
        """Record a nondeterministic choice set, a branch of the search
        tree; replaces an earlier set of the same key."""
        self.commands.append(ChooseRandomCmd(key, tuple(choices)))

    def __repr__(self) -> str:
        return f"Out({self.commands!r})"


def is_no_op(returned_state: Optional[Any], out: Out) -> bool:
    """True iff the handler neither updated state nor emitted commands.
    Reference: src/actor.rs:282-284."""
    return returned_state is None and not out.commands


def is_no_op_with_timer(returned_state: Optional[Any], out: Out, timer: Any) -> bool:
    """True iff the handler only renewed the same timer.
    Reference: src/actor.rs:289-299."""
    keep_timer = any(
        isinstance(c, SetTimerCmd) and c.timer == timer for c in out.commands
    )
    return returned_state is None and len(out.commands) == 1 and keep_timer


class Actor:
    """Event-driven actor.  Reference: the ``Actor`` trait,
    src/actor.rs:305-411.  ``on_msg``, ``on_timeout`` and ``on_random``
    return the next actor state, or ``None`` for no change."""

    def on_start(self, id: Id, storage: Optional[Any], o: Out) -> Any:
        raise NotImplementedError

    def on_msg(self, id: Id, state: Any, src: Id, msg: Any, o: Out) -> Optional[Any]:
        return None

    def on_timeout(self, id: Id, state: Any, timer: Any, o: Out) -> Optional[Any]:
        return None

    def on_random(self, id: Id, state: Any, random: Any, o: Out) -> Optional[Any]:
        return None

    def name(self) -> str:
        return ""
