"""The unordered nonduplicating network: a multiset of envelopes.

The counterpart of ``stateright_tpu/actor/network.py`` (reference:
src/actor/network.rs) for the one fabric the port's models use:
``unordered_nonduplicating``, where delivery decrements an envelope's
count.  ``Network`` keeps the JAX class's name and fields, so a network
fingerprints the same in both packages; the other kinds' fields stay at
their empty defaults.  Iteration is sorted by (src, dst, message
fingerprint), so model re-execution is reproducible across processes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, FrozenSet, List, Optional, Tuple

from ..ops.fingerprint import fingerprint
from .ids import Id

UNORDERED_NONDUPLICATING = "unordered_nonduplicating"


@dataclass(frozen=True)
class Envelope:
    """Reference: src/actor/network.rs:25-29."""

    src: Id
    dst: Id
    msg: Any

    def _sort_key(self):
        return (int(self.src), int(self.dst), fingerprint(self.msg))


@dataclass(frozen=True)
class Network:
    kind: str
    envelopes: FrozenSet[Envelope] = frozenset()  # other kinds only
    last_msg: Optional[Envelope] = None  # other kinds only
    counts: FrozenSet[Tuple[Envelope, int]] = frozenset()
    flows: Tuple = ()  # other kinds only

    def __post_init__(self):
        if self.kind != UNORDERED_NONDUPLICATING:
            raise ValueError(
                f"the port models only the {UNORDERED_NONDUPLICATING} "
                f"network, not {self.kind!r}"
            )

    @staticmethod
    def new_unordered_nonduplicating(envelopes=()) -> "Network":
        n = Network(kind=UNORDERED_NONDUPLICATING)
        for e in envelopes:
            n = n.send(e)
        return n

    def __len__(self) -> int:
        return sum(c for (_e, c) in self.counts)

    def iter_deliverable(self) -> List[Envelope]:
        """Distinct deliverable envelopes.
        Reference: src/actor/network.rs:180-190."""
        return sorted((e for (e, _c) in self.counts), key=Envelope._sort_key)

    def send(self, env: Envelope) -> "Network":
        """Reference: src/actor/network.rs:203-217."""
        counts = dict(self.counts)
        counts[env] = counts.get(env, 0) + 1
        return Network(kind=self.kind, counts=frozenset(counts.items()))

    def on_deliver(self, env: Envelope) -> "Network":
        """Remove one copy.  Reference: src/actor/network.rs:229-242."""
        counts = dict(self.counts)
        if env not in counts:
            raise KeyError(f"envelope not found: {env!r}")
        if counts[env] == 1:
            del counts[env]
        else:
            counts[env] -= 1
        return Network(kind=self.kind, counts=frozenset(counts.items()))
