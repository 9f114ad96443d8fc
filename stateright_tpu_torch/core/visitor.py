"""Checker visitors -- the primary test instrumentation.

A copy of ``stateright_tpu/core/visitor.py`` (reference:
src/checker/visitor.rs).  A visitor is applied to the ``Path`` of every
evaluated state; plain callables are accepted wherever a visitor is.  The
wavefront checker feeds it through its traced readback
(:meth:`CheckerBuilder.visitor` forces ``trace=True``): each expanded
state once, as a single-state path.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Set

from .path import Path


class CheckerVisitor:
    def visit(self, model, path: Path) -> None:
        raise NotImplementedError


class _FnVisitor(CheckerVisitor):
    def __init__(self, fn: Callable[[Path], None]):
        self._fn = fn

    def visit(self, model, path: Path) -> None:
        self._fn(path)


def as_visitor(v) -> CheckerVisitor:
    if isinstance(v, CheckerVisitor):
        return v
    if callable(v):
        return _FnVisitor(v)
    raise TypeError(f"not a visitor: {v!r}")


class PathRecorder(CheckerVisitor):
    """Records the set of visited paths.  Reference: src/checker/visitor.rs:47-73."""

    def __init__(self):
        self._lock = threading.Lock()
        self._paths: Set[Path] = set()

    def visit(self, model, path: Path) -> None:
        with self._lock:
            self._paths.add(path)

    @staticmethod
    def new_with_accessor():
        recorder = PathRecorder()

        def accessor() -> Set[Path]:
            with recorder._lock:
                return set(recorder._paths)

        return recorder, accessor


class StateRecorder(CheckerVisitor):
    """Records evaluated states in visit order.  Reference: src/checker/visitor.rs:87-111."""

    def __init__(self):
        self._lock = threading.Lock()
        self._states: List[Any] = []

    def visit(self, model, path: Path) -> None:
        with self._lock:
            self._states.append(path.last_state())

    @staticmethod
    def new_with_accessor():
        recorder = StateRecorder()

        def accessor() -> List[Any]:
            with recorder._lock:
                return list(recorder._states)

        return recorder, accessor
