"""Paths (traces / behaviors) through a model's state graph.

Reference: src/checker/path.rs.  A path is a sequence of (state, action)
pairs; it is reconstructed from a chain of fingerprints by re-executing the
model (the TLC technique).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple


class NondeterminismError(RuntimeError):
    """Raised when a fingerprint chain cannot be re-executed.

    Reference: the diagnostic panic in src/checker/path.rs:36-55,70-89.
    """


_NONDET_HINT = (
    "This usually happens when the model varies given the same inputs — "
    "e.g. it reads untracked external state (files, clocks, randomness) or "
    "iterates an unordered container nondeterministically."
)


class Path:
    """``state --action--> state ... --action--> state``.

    Reference: src/checker/path.rs:16.
    """

    __slots__ = ("_steps",)

    def __init__(self, steps: Sequence[Tuple[Any, Optional[Any]]]):
        self._steps = tuple(steps)

    @staticmethod
    def from_fingerprints(model, fingerprints: Sequence[int]) -> "Path":
        """Re-execute ``model`` along a fingerprint chain.

        Reference: src/checker/path.rs:20-97.
        """
        fps = list(fingerprints)
        if not fps:
            raise NondeterminismError("empty path is invalid")
        init_fp = fps[0]
        last_state = None
        for s in model.init_states():
            if model.fingerprint(s) == init_fp:
                last_state = s
                break
        if last_state is None:
            raise NondeterminismError(
                f"No init state has the expected fingerprint ({init_fp}). "
                + _NONDET_HINT
            )
        steps: List[Tuple[Any, Optional[Any]]] = []
        for i, next_fp in enumerate(fps[1:]):
            found = None
            for action, state in model.next_steps(last_state):
                if model.fingerprint(state) == next_fp:
                    found = (action, state)
                    break
            if found is None:
                raise NondeterminismError(
                    f"{i + 1} previous state(s) reconstructed, but no successor "
                    f"has the next fingerprint ({next_fp}). " + _NONDET_HINT
                )
            steps.append((last_state, found[0]))
            last_state = found[1]
        steps.append((last_state, None))
        return Path(steps)

    def last_state(self) -> Any:
        return self._steps[-1][0]

    def into_states(self) -> List[Any]:
        return [s for (s, _a) in self._steps]

    def into_actions(self) -> List[Any]:
        return [a for (_s, a) in self._steps if a is not None]

    def into_vec(self) -> List[Tuple[Any, Optional[Any]]]:
        return list(self._steps)

    def encode(self, model) -> str:
        """`/`-joined fingerprints (Explorer URLs, reports).
        Reference: src/checker/path.rs:189-198."""
        return "/".join(str(model.fingerprint(s)) for (s, _a) in self._steps)

    def __len__(self) -> int:
        return len(self._steps)

    def __iter__(self):
        return iter(self._steps)

    def __getitem__(self, i):
        return self._steps[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, Path) and self._steps == other._steps

    def __hash__(self) -> int:
        return hash(self._steps)

    def __repr__(self) -> str:
        return f"Path({list(self._steps)!r})"

    def __str__(self) -> str:
        # Reference Display impl: src/checker/path.rs:207-221.
        lines = [f"Path[{len(self._steps) - 1}]:"]
        for _state, action in self._steps:
            if action is not None:
                lines.append(f"- {action!r}")
        return "\n".join(lines) + "\n"
