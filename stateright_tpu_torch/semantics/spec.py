"""Sequential reference-object specifications.

Reference: the ``SequentialSpec`` trait, src/semantics.rs:73-98.
"""

from __future__ import annotations

from typing import Any, Iterable, Tuple


class SequentialSpec:
    """A sequential "reference object" against which concurrent histories are
    validated.  Implementations are small mutable objects with ``clone()``."""

    def invoke(self, op: Any) -> Any:
        """Apply ``op``, mutating self; returns the Ret value."""
        raise NotImplementedError

    def is_valid_step(self, op: Any, ret: Any) -> bool:
        """Whether invoking ``op`` may return ``ret`` (applying it if so)."""
        return self.invoke(op) == ret

    def is_valid_history(self, ops: Iterable[Tuple[Any, Any]]) -> bool:
        return all(self.is_valid_step(op, ret) for (op, ret) in ops)

    def clone(self) -> "SequentialSpec":
        raise NotImplementedError
