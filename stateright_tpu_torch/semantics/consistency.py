"""The linearizability tester.

The counterpart of ``stateright_tpu/semantics/consistency.py`` with only
what the register harness records into: ``LinearizabilityTester`` and its
``serialized_history()`` (reference: src/semantics/linearizability.rs).
It records per-thread operation histories and decides linearizability by
an exponential backtracking search for a valid interleaving against a
``SequentialSpec``; at each invocation it snapshots the index of the last
completed operation of every *other* thread, and an interleaving that
schedules an operation before such a prerequisite is pruned (real-time
order, src/semantics/linearizability.rs:102-129, 221-234).

The tester is model state (it lives in an ``ActorModel`` history), so it
is hashable, comparable, cheaply clonable and fingerprints exactly as the
JAX package's does (``__canon_words__``).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .spec import SequentialSpec


class LinearizabilityTester:
    """History entries are ``(last_completed, op, ret)`` and in-flight
    entries ``(last_completed, op)``, where ``last_completed`` maps every
    other thread (with completed ops at invocation time) to its last
    completed op index."""

    __slots__ = (
        "init_ref_obj", "history_by_thread", "in_flight_by_thread",
        "is_valid_history",
    )

    def __init__(self, init_ref_obj: SequentialSpec):
        self.init_ref_obj = init_ref_obj
        self.history_by_thread: Dict[Any, Tuple] = {}
        self.in_flight_by_thread: Dict[Any, Any] = {}
        self.is_valid_history = True

    def clone(self) -> "LinearizabilityTester":
        c = type(self)(self.init_ref_obj)
        c.history_by_thread = dict(self.history_by_thread)
        c.in_flight_by_thread = dict(self.in_flight_by_thread)
        c.is_valid_history = self.is_valid_history
        return c

    def _key(self):
        return (
            type(self).__name__,
            self.init_ref_obj,
            tuple(sorted(self.history_by_thread.items())),
            tuple(sorted(self.in_flight_by_thread.items())),
            self.is_valid_history,
        )

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __canon_words__(self, out: List[int]) -> None:
        from ..ops.fingerprint import canon_words

        canon_words(self._key(), out)

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(history={self.history_by_thread!r}, "
            f"in_flight={self.in_flight_by_thread!r}, valid={self.is_valid_history})"
        )

    def on_invoke(self, thread_id, op) -> "LinearizabilityTester":
        if not self.is_valid_history:
            raise ValueError("Earlier history was invalid.")
        if thread_id in self.in_flight_by_thread:
            self.is_valid_history = False
            raise ValueError(
                f"Thread already has an operation in flight. thread_id={thread_id!r}"
            )
        last_completed = tuple(
            sorted(
                (tid, len(h) - 1)
                for tid, h in self.history_by_thread.items()
                if tid != thread_id and h
            )
        )
        self.in_flight_by_thread[thread_id] = (last_completed, op)
        self.history_by_thread.setdefault(thread_id, ())
        return self

    def on_return(self, thread_id, ret) -> "LinearizabilityTester":
        if not self.is_valid_history:
            raise ValueError("Earlier history was invalid.")
        if thread_id not in self.in_flight_by_thread:
            self.is_valid_history = False
            raise ValueError(
                f"There is no in-flight invocation for this thread ID. "
                f"thread_id={thread_id!r}, unexpected_return={ret!r}"
            )
        last_completed, op = self.in_flight_by_thread.pop(thread_id)
        self.history_by_thread[thread_id] = self.history_by_thread.get(
            thread_id, ()
        ) + ((last_completed, op, ret),)
        return self

    def is_consistent(self) -> bool:
        return self.serialized_history() is not None

    def serialized_history(self) -> Optional[List[Tuple[Any, Any]]]:
        if not self.is_valid_history:
            return None
        remaining = {
            t: deque(enumerate(h)) for t, h in self.history_by_thread.items()
        }
        return _serialize_lin(
            [], self.init_ref_obj, remaining, dict(self.in_flight_by_thread)
        )


def _rt_violation(last_completed, remaining) -> bool:
    """An op may not be scheduled while a prerequisite (an op completed
    before this op's invocation) is still unconsumed."""
    for peer_id, min_peer_time in last_completed:
        ops = remaining.get(peer_id)
        if ops and ops[0][0] <= min_peer_time:
            return True
    return False


def _serialize_lin(valid, ref_obj, remaining, in_flight):
    if all(not h for h in remaining.values()):
        return valid
    for tid in sorted(remaining):
        h = remaining[tid]
        if not h:
            # No completed ops left; an in-flight op is optional.
            if tid not in in_flight:
                continue
            last_completed, op = in_flight[tid]
            if _rt_violation(last_completed, remaining):
                continue
            obj2 = ref_obj.clone()
            ret = obj2.invoke(op)
            nif = {k: v for k, v in in_flight.items() if k != tid}
            result = _serialize_lin(valid + [(op, ret)], obj2, remaining, nif)
        else:
            # The next completed op of this thread.
            _idx, (last_completed, op, ret) = h[0]
            nrem = dict(remaining)
            nh = deque(h)
            nh.popleft()
            nrem[tid] = nh
            if _rt_violation(last_completed, nrem):
                continue
            obj2 = ref_obj.clone()
            if not obj2.is_valid_step(op, ret):
                continue
            result = _serialize_lin(valid + [(op, ret)], obj2, nrem, in_flight)
        if result is not None:
            return result
    return None
