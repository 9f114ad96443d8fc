"""The three fabrics of the actor layer.

The counterpart of ``stateright_tpu/actor/network.py`` (reference:
src/actor/network.rs):

- ``unordered_duplicating``: a *set* of envelopes plus a last-delivered
  marker; delivery leaves the envelope in place (redelivery allowed), and
  the marker lets a redelivery that changes no actor state still change
  the state's fingerprint (src/actor/network.rs:52, 224-228);
- ``unordered_nonduplicating``: a *multiset* of envelopes; delivery
  decrements an envelope's count (src/actor/network.rs:55, 229-242);
- ``ordered``: a FIFO queue per directed (src, dst) pair; only channel
  heads are deliverable (src/actor/network.rs:67, 243-265).

``Network`` keeps the JAX class's name and fields, so a network
fingerprints the same in both packages; the fields of the kinds not in use
stay at their empty defaults.  Iteration is sorted by (src, dst, message
fingerprint), or by flow key on the ordered fabric, so model re-execution
is reproducible across processes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, FrozenSet, List, Optional, Tuple

from ..ops.fingerprint import fingerprint
from .ids import Id

UNORDERED_DUPLICATING = "unordered_duplicating"
UNORDERED_NONDUPLICATING = "unordered_nonduplicating"
ORDERED = "ordered"


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
    # unordered_duplicating: envelopes = frozenset[Envelope], last_msg
    # unordered_nonduplicating: counts = frozenset[(Envelope, int)]
    # ordered: flows = tuple[((src, dst), tuple[msg, ...]), ...] sorted by
    # key, with no empty flow
    envelopes: FrozenSet[Envelope] = frozenset()
    last_msg: Optional[Envelope] = None
    counts: FrozenSet[Tuple[Envelope, int]] = frozenset()
    flows: Tuple[Tuple[Tuple[Id, Id], Tuple[Any, ...]], ...] = ()

    def __post_init__(self):
        if self.kind not in (UNORDERED_DUPLICATING, UNORDERED_NONDUPLICATING, ORDERED):
            raise ValueError(f"unknown network kind {self.kind!r}")

    @staticmethod
    def new_unordered_duplicating(envelopes=()) -> "Network":
        n = Network(kind=UNORDERED_DUPLICATING)
        for e in envelopes:
            n = n.send(e)
        return n

    @staticmethod
    def new_unordered_duplicating_with_last_msg(envelopes, last_msg) -> "Network":
        n = Network.new_unordered_duplicating(envelopes)
        return Network(
            kind=UNORDERED_DUPLICATING, envelopes=n.envelopes, last_msg=last_msg
        )

    @staticmethod
    def new_unordered_nonduplicating(envelopes=()) -> "Network":
        n = Network(kind=UNORDERED_NONDUPLICATING)
        for e in envelopes:
            n = n.send(e)
        return n

    @staticmethod
    def new_ordered(envelopes=()) -> "Network":
        n = Network(kind=ORDERED)
        for e in envelopes:
            n = n.send(e)
        return n

    @staticmethod
    def names() -> List[str]:
        return [ORDERED, UNORDERED_DUPLICATING, UNORDERED_NONDUPLICATING]

    @staticmethod
    def from_name(name: str) -> "Network":
        """The network a name selects (reference src/actor/network.rs:318-331)."""
        if name == ORDERED:
            return Network.new_ordered()
        if name == UNORDERED_DUPLICATING:
            return Network.new_unordered_duplicating()
        if name == UNORDERED_NONDUPLICATING:
            return Network.new_unordered_nonduplicating()
        raise ValueError(f"unable to parse network name: {name}")

    @property
    def is_ordered(self) -> bool:
        return self.kind == ORDERED

    def __len__(self) -> int:
        if self.kind == UNORDERED_DUPLICATING:
            return len(self.envelopes)
        if self.kind == UNORDERED_NONDUPLICATING:
            return sum(c for (_e, c) in self.counts)
        return sum(len(msgs) for (_k, msgs) in self.flows)

    def iter_all(self) -> List[Envelope]:
        """Every envelope: multiset entries repeated, every queued ordered
        message.  Reference: src/actor/network.rs:169-177."""
        if self.kind == UNORDERED_DUPLICATING:
            return sorted(self.envelopes, key=Envelope._sort_key)
        if self.kind == UNORDERED_NONDUPLICATING:
            out = []
            for e, c in sorted(self.counts, key=lambda ec: ec[0]._sort_key()):
                out.extend([e] * c)
            return out
        return [
            Envelope(src, dst, m) for (src, dst), msgs in self.flows for m in msgs
        ]

    def iter_deliverable(self) -> List[Envelope]:
        """Distinct deliverable envelopes; on the ordered fabric, only the
        channel heads.  Reference: src/actor/network.rs:180-190."""
        if self.kind == UNORDERED_DUPLICATING:
            return sorted(self.envelopes, key=Envelope._sort_key)
        if self.kind == UNORDERED_NONDUPLICATING:
            return sorted((e for (e, _c) in self.counts), key=Envelope._sort_key)
        return [Envelope(src, dst, msgs[0]) for (src, dst), msgs in self.flows]

    def send(self, env: Envelope) -> "Network":
        """Reference: src/actor/network.rs:203-217."""
        if self.kind == UNORDERED_DUPLICATING:
            return Network(
                kind=self.kind, envelopes=self.envelopes | {env},
                last_msg=self.last_msg,
            )
        if self.kind == UNORDERED_NONDUPLICATING:
            counts = dict(self.counts)
            counts[env] = counts.get(env, 0) + 1
            return Network(kind=self.kind, counts=frozenset(counts.items()))
        flows = dict(self.flows)
        key = (env.src, env.dst)
        flows[key] = flows.get(key, ()) + (env.msg,)
        return Network(kind=self.kind, flows=tuple(sorted(flows.items())))

    def on_deliver(self, env: Envelope) -> "Network":
        """Reference: src/actor/network.rs:219-267."""
        if self.kind == UNORDERED_DUPLICATING:
            # The envelope stays; the marker remembers the delivery, so a
            # redelivery that changes no actor still changes the state.
            return Network(kind=self.kind, envelopes=self.envelopes, last_msg=env)
        if self.kind == UNORDERED_NONDUPLICATING:
            return self._remove_one(env)
        return self._remove_ordered(env)

    def on_drop(self, env: Envelope) -> "Network":
        """Reference: src/actor/network.rs:269-315."""
        if self.kind == UNORDERED_DUPLICATING:
            return Network(
                kind=self.kind, envelopes=self.envelopes - {env},
                last_msg=self.last_msg,
            )
        if self.kind == UNORDERED_NONDUPLICATING:
            return self._remove_one(env)
        return self._remove_ordered(env)

    def _remove_one(self, env: Envelope) -> "Network":
        counts = dict(self.counts)
        if env not in counts:
            raise KeyError(f"envelope not found: {env!r}")
        if counts[env] == 1:
            del counts[env]
        else:
            counts[env] -= 1
        return Network(kind=self.kind, counts=frozenset(counts.items()))

    def _remove_ordered(self, env: Envelope) -> "Network":
        flows = dict(self.flows)
        key = (env.src, env.dst)
        if key not in flows:
            raise KeyError(f"flow not found: src={env.src!r} dst={env.dst!r}")
        msgs = flows[key]
        try:
            i = msgs.index(env.msg)
        except ValueError:
            raise KeyError(f"message not found: {env.msg!r}") from None
        remaining = msgs[:i] + msgs[i + 1 :]
        if remaining:
            flows[key] = remaining
        else:
            del flows[key]  # canonical: no empty flows
        return Network(kind=self.kind, flows=tuple(sorted(flows.items())))
