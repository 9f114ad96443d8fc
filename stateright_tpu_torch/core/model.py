"""The central ``Model`` abstraction and ``Property`` declarations.

Reference: the ``Model`` trait (src/lib.rs:158-257), ``Property`` and
``Expectation`` (src/lib.rs:264-338).  Semantics are kept identical —
``next_state`` returning ``None`` means "the action does not change the
state", ``within_boundary`` prunes the state space, properties are named
``always`` / ``sometimes`` / ``eventually`` predicates over (model, state).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple


class Expectation(enum.Enum):
    """Whether a property is always, eventually, or sometimes true.

    Reference: src/lib.rs:320-338.
    """

    ALWAYS = "always"
    EVENTUALLY = "eventually"
    SOMETIMES = "sometimes"

    @property
    def discovery_is_failure(self) -> bool:
        return self is not Expectation.SOMETIMES


@dataclass(frozen=True)
class Property:
    """A named predicate over (model, state).

    Reference: src/lib.rs:264-317.
    """

    expectation: Expectation
    name: str
    condition: Callable[[Any, Any], bool]

    @staticmethod
    def always(name: str, condition: Callable[[Any, Any], bool]) -> "Property":
        return Property(Expectation.ALWAYS, name, condition)

    @staticmethod
    def eventually(name: str, condition: Callable[[Any, Any], bool]) -> "Property":
        """Note: per the reference semantics (src/lib.rs:286-290), `eventually`
        properties only work correctly on acyclic paths; a path ending in a
        cycle is not viewed as terminating, a documented false negative that
        this implementation intentionally reproduces."""
        return Property(Expectation.EVENTUALLY, name, condition)

    @staticmethod
    def sometimes(name: str, condition: Callable[[Any, Any], bool]) -> "Property":
        return Property(Expectation.SOMETIMES, name, condition)


class Model:
    """Implementations model a nondeterministic system's evolution.

    Reference: the ``Model`` trait, src/lib.rs:158-257.  States and actions
    are arbitrary hashable Python values; states must be canonically
    encodable (see ``stateright_tpu_torch.ops.fingerprint``).
    """

    def init_states(self) -> List[Any]:
        raise NotImplementedError

    def actions(self, state: Any, actions: List[Any]) -> None:
        raise NotImplementedError

    def next_state(self, last_state: Any, action: Any) -> Optional[Any]:
        raise NotImplementedError

    def properties(self) -> List[Property]:
        return []

    def within_boundary(self, state: Any) -> bool:
        return True

    def next_steps(self, last_state: Any) -> List[Tuple[Any, Any]]:
        actions: List[Any] = []
        self.actions(last_state, actions)
        steps = []
        for action in actions:
            state = self.next_state(last_state, action)
            if state is not None:
                steps.append((action, state))
        return steps

    def next_states(self, last_state: Any) -> List[Any]:
        return [s for (_a, s) in self.next_steps(last_state)]

    def get_property(self, name: str) -> Property:
        """Look up a property by name (the reference's ``Model::property``)."""
        for p in self.properties():
            if p.name == name:
                return p
        available = [p.name for p in self.properties()]
        raise KeyError(f"Unknown property. requested={name}, available={available}")

    def checker(self) -> "CheckerBuilder":
        from .checker import CheckerBuilder

        return CheckerBuilder(self)

    def fingerprint(self, state: Any) -> int:
        """Fingerprint a state (the host encoding every engine's paths and
        reports use)."""
        from ..ops.fingerprint import fingerprint

        return fingerprint(state)
