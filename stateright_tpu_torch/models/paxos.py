"""Single Decree Paxos on the register harness, linearizability-checked.

A copy of ``stateright_tpu/models/paxos.py`` (reference: examples/paxos.rs)
without its CLI.  Goldens: 16,668 unique states at 2 clients / 3 servers on
a nonduplicating network; 1,194,428 at 3 clients, depth 28.  Its compiled
form (``models/paxos_compiled.py``) runs it through ``spawn_gpu()``.

    from stateright_tpu_torch.actor import Network
    from stateright_tpu_torch.models.paxos import PaxosModelCfg
    PaxosModelCfg(3, 3, Network.new_unordered_nonduplicating()) \
        .into_model().checker().spawn_gpu().join()
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, FrozenSet, Optional, Tuple

from ..actor import Actor, ActorModel, Id, Network, Out, majority, model_peers
from ..actor.register import (
    Get,
    GetOk,
    Internal,
    Put,
    PutOk,
    RegisterClient,
    RegisterServer,
    record_invocations,
    record_returns,
)
from ..core.model import Expectation
from ..semantics import LinearizabilityTester, Register

NULL_VALUE = "\x00"

# Ballot = (round, Id); Proposal = (request_id, requester Id, value)


@dataclass(frozen=True)
class Prepare:
    ballot: Tuple[int, Id]


@dataclass(frozen=True)
class Prepared:
    ballot: Tuple[int, Id]
    last_accepted: Optional[Tuple[Tuple[int, Id], Tuple[int, Id, Any]]]


@dataclass(frozen=True)
class Accept:
    ballot: Tuple[int, Id]
    proposal: Tuple[int, Id, Any]


@dataclass(frozen=True)
class Accepted:
    ballot: Tuple[int, Id]


@dataclass(frozen=True)
class Decided:
    ballot: Tuple[int, Id]
    proposal: Tuple[int, Id, Any]


@dataclass(frozen=True)
class PaxosState:
    # shared state
    ballot: Tuple[int, Id]
    # leader state
    proposal: Optional[Tuple[int, Id, Any]]
    prepares: Tuple[Tuple[Id, Optional[Tuple]], ...]  # sorted by id
    accepts: FrozenSet[Id]
    # acceptor state
    accepted: Optional[Tuple[Tuple[int, Id], Tuple[int, Id, Any]]]
    is_decided: bool


def _prepared_sort_key(last_accepted):
    """Rust's Option ordering: None < Some(inner)."""
    return (0,) if last_accepted is None else (1, last_accepted)


class PaxosActor(Actor):
    def __init__(self, peer_ids):
        self.peer_ids = list(peer_ids)

    def name(self) -> str:
        return "Paxos Server"

    def on_start(self, id, storage, o: Out):
        return PaxosState(
            ballot=(0, Id(0)),
            proposal=None,
            prepares=(),
            accepts=frozenset(),
            accepted=None,
            is_decided=False,
        )

    def on_msg(self, id, state: PaxosState, src, msg, o: Out):
        if state.is_decided:
            if isinstance(msg, Get):
                _b, (_req_id, _src, value) = state.accepted
                o.send(src, GetOk(msg.request_id, value))
            return None

        if isinstance(msg, Put) and state.proposal is None:
            ballot = (state.ballot[0] + 1, id)
            o.broadcast(self.peer_ids, Internal(Prepare(ballot)))
            return self._replace(
                state,
                proposal=(msg.request_id, src, msg.value),
                ballot=ballot,
                # Simulate Prepare+Prepared self-sends.
                prepares=((id, state.accepted),),
                accepts=frozenset(),
            )

        if isinstance(msg, Internal) and isinstance(msg.msg, Prepare):
            if state.ballot < msg.msg.ballot:
                o.send(
                    src,
                    Internal(Prepared(msg.msg.ballot, state.accepted)),
                )
                return self._replace(state, ballot=msg.msg.ballot)
            return None

        if isinstance(msg, Internal) and isinstance(msg.msg, Prepared):
            if msg.msg.ballot != state.ballot:
                return None
            prepares = dict(state.prepares)
            prepares[src] = msg.msg.last_accepted
            if len(prepares) == majority(len(self.peer_ids) + 1):
                best = max(prepares.values(), key=_prepared_sort_key)
                proposal = best[1] if best is not None else state.proposal
                ballot = state.ballot
                o.broadcast(self.peer_ids, Internal(Accept(ballot, proposal)))
                return self._replace(
                    state,
                    proposal=proposal,
                    prepares=tuple(sorted(prepares.items())),
                    # Simulate Accept+Accepted self-sends.
                    accepted=(ballot, proposal),
                    accepts=frozenset([id]),
                )
            return self._replace(state, prepares=tuple(sorted(prepares.items())))

        if isinstance(msg, Internal) and isinstance(msg.msg, Accept):
            if state.ballot <= msg.msg.ballot:
                o.send(src, Internal(Accepted(msg.msg.ballot)))
                return self._replace(
                    state,
                    ballot=msg.msg.ballot,
                    accepted=(msg.msg.ballot, msg.msg.proposal),
                )
            return None

        if isinstance(msg, Internal) and isinstance(msg.msg, Accepted):
            if msg.msg.ballot != state.ballot:
                return None
            accepts = state.accepts | {src}
            if len(accepts) == majority(len(self.peer_ids) + 1):
                proposal = state.proposal
                o.broadcast(
                    self.peer_ids, Internal(Decided(msg.msg.ballot, proposal))
                )
                request_id, requester_id, _ = proposal
                o.send(requester_id, PutOk(request_id))
                return self._replace(state, accepts=accepts, is_decided=True)
            return self._replace(state, accepts=accepts)

        if isinstance(msg, Internal) and isinstance(msg.msg, Decided):
            return self._replace(
                state,
                ballot=msg.msg.ballot,
                accepted=(msg.msg.ballot, msg.msg.proposal),
                is_decided=True,
            )

        return None

    @staticmethod
    def _replace(state: PaxosState, **changes) -> PaxosState:
        import dataclasses

        return dataclasses.replace(state, **changes)


@dataclass
class PaxosModelCfg:
    client_count: int
    server_count: int
    network: Network
    # Adds an (intentionally false) always-property "never decided" — the
    # property-violating variant BASELINE.md's time-to-first-violation
    # metric is measured on.
    never_decided: bool = False
    # Ballot-round boundary: states where any server's ballot round
    # exceeds this are pruned (None = bounded only by the packed
    # encoding's MAX_ROUND cap, paxos_compiled.py, whose single-phase
    # step then applies it on the device).
    max_round: Optional[int] = None

    def into_model(self) -> ActorModel:
        def value_chosen(_m, state):
            for env in state.network.iter_deliverable():
                if isinstance(env.msg, GetOk) and env.msg.value != NULL_VALUE:
                    return True
            return False

        model = ActorModel(
            cfg=self, init_history=LinearizabilityTester(Register(NULL_VALUE))
        )
        model.add_actors(
            RegisterServer(PaxosActor(model_peers(i, self.server_count)))
            for i in range(self.server_count)
        )
        model.add_actors(
            RegisterClient(put_count=1, server_count=self.server_count)
            for _ in range(self.client_count)
        )
        model = (
            model.init_network_(self.network)
            .property(
                Expectation.ALWAYS,
                "linearizable",
                lambda _m, s: s.history.serialized_history() is not None,
            )
            .property(Expectation.SOMETIMES, "value chosen", value_chosen)
            .record_msg_in(record_returns)
            .record_msg_out(record_invocations)
        )
        if self.never_decided:
            model.property(
                Expectation.ALWAYS,
                "never decided",
                lambda _m, s: not any(
                    getattr(a, "is_decided", False) for a in s.actor_states
                ),
            )
        if self.max_round is not None:
            # Host half of the round boundary (the device half is
            # PaxosCompiled.boundary).
            model.within_boundary_(
                lambda cfg, s: all(
                    a.ballot[0] <= cfg.max_round
                    for a in s.actor_states
                    if hasattr(a, "ballot")
                )
            )

        def _compiled():
            from .paxos_compiled import PaxosCompiled

            return PaxosCompiled(model)

        model.compiled = _compiled
        return model


def cli_spec():
    """This module's workload spec (resolved by ``serve/workloads.py``)."""
    from ..cli import CliSpec

    return CliSpec(
        name="Single Decree Paxos",
        build=lambda n, net: PaxosModelCfg(
            client_count=n, server_count=3, network=net
        ).into_model(),
        default_n=2,
        n_meta="CLIENT_COUNT",
        default_network="unordered_nonduplicating",
        gpu=True,
        gpu_kwargs=dict(capacity=1 << 23, max_frontier=1 << 13),
    )
