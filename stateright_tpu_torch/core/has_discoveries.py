"""Early-exit policies for checker runs.

Reference: src/has_discoveries.rs.
"""

from __future__ import annotations

from typing import FrozenSet, Iterable, Sequence

from .model import Property


class HasDiscoveries:
    """When to finish a checker run."""

    _kind: str
    _names: FrozenSet[str]

    def __init__(self, kind: str, names: Iterable[str] = ()):
        self._kind = kind
        self._names = frozenset(names)

    def matches(self, discoveries: FrozenSet[str], properties: Sequence[Property]) -> bool:
        k = self._kind
        if k == "all":
            return len(discoveries) == len(properties)
        if k == "any":
            return bool(discoveries)
        if k == "any_failures":
            return any(
                p.name in discoveries
                for p in properties
                if p.expectation.discovery_is_failure
            )
        if k == "all_failures":
            return all(
                p.name in discoveries
                for p in properties
                if p.expectation.discovery_is_failure
            )
        if k == "all_of":
            return self._names <= discoveries
        if k == "any_of":
            return bool(self._names & discoveries)
        raise ValueError(k)

    @staticmethod
    def all_of(names: Iterable[str]) -> "HasDiscoveries":
        return HasDiscoveries("all_of", names)

    @staticmethod
    def any_of(names: Iterable[str]) -> "HasDiscoveries":
        return HasDiscoveries("any_of", names)

    def __repr__(self) -> str:
        if self._names:
            return f"HasDiscoveries.{self._kind}({sorted(self._names)})"
        return f"HasDiscoveries.{self._kind.upper()}"


HasDiscoveries.ALL = HasDiscoveries("all")
HasDiscoveries.ANY = HasDiscoveries("any")
HasDiscoveries.ANY_FAILURES = HasDiscoveries("any_failures")
HasDiscoveries.ALL_FAILURES = HasDiscoveries("all_failures")
