"""ABD quorum register (Attiya, Bar-Noy, Dolev -- "Sharing Memory Robustly
in Message-Passing Systems").

A copy of ``stateright_tpu/models/abd.py`` (reference:
examples/linearizable-register.rs) without its CLI, UDP spawn and chaos
audit.  Goldens at 2 servers: 544 unique states with 2 clients on the
unordered nonduplicating network (depth 25, the reference's
`linearizable-register check 2`), 620 on the ordered network, 35,009 with
3 clients unordered and 46,516 ordered (depth 37, `linearizable-register
check 3 ordered`).  Its compiled form (``models/abd_compiled.py``) runs it
through ``spawn_gpu()``:

    from stateright_tpu_torch.actor import Network
    from stateright_tpu_torch.models.abd import AbdModelCfg
    AbdModelCfg(3, 2, Network.new_ordered()).into_model() \\
        .checker().spawn_gpu().join()
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

# Seq = (logical clock, id)


@dataclass(frozen=True)
class Query:
    request_id: int


@dataclass(frozen=True)
class AckQuery:
    request_id: int
    seq: Tuple[int, Id]
    value: Any


@dataclass(frozen=True)
class Record:
    request_id: int
    seq: Tuple[int, Id]
    value: Any


@dataclass(frozen=True)
class AckRecord:
    request_id: int


@dataclass(frozen=True)
class Phase1:
    request_id: int
    requester_id: Id
    write: Optional[Any]
    responses: Tuple[Tuple[Id, Tuple[Tuple[int, Id], Any]], ...]  # sorted by id


@dataclass(frozen=True)
class Phase2:
    request_id: int
    requester_id: Id
    read: Optional[Any]
    acks: FrozenSet[Id]


@dataclass(frozen=True)
class AbdState:
    seq: Tuple[int, Id]
    val: Any
    phase: Optional[Any]


class AbdActor(Actor):
    """The ABD quorum register replica.

    ``fault="skip_ack"`` makes the replica acknowledge client operations
    at once from local state, skipping both quorum phases: the classic
    linearizability violation (a read on another replica misses a
    completed write), which the ``linearizable`` property discovers.
    """

    def __init__(self, peers, fault=None):
        self.peers = list(peers)
        if fault not in (None, "skip_ack"):
            raise ValueError(f"unknown AbdActor fault: {fault!r}")
        self.fault = fault

    def name(self) -> str:
        return "ABD Server"

    def on_start(self, id, storage, o: Out):
        return AbdState(seq=(0, id), val=NULL_VALUE, phase=None)

    def on_msg(self, id, state: AbdState, src, msg, o: Out):
        if self.fault == "skip_ack" and isinstance(msg, (Put, Get)):
            # Broken replica: answer from local state without consulting a
            # quorum (no Query/Record round, no acks awaited).
            if isinstance(msg, Put):
                o.send(src, PutOk(msg.request_id))
                return AbdState(
                    seq=(state.seq[0] + 1, id), val=msg.value, phase=state.phase
                )
            o.send(src, GetOk(msg.request_id, state.val))
            return None

        if isinstance(msg, (Put, Get)) and state.phase is None:
            write = msg.value if isinstance(msg, Put) else None
            o.broadcast(self.peers, Internal(Query(msg.request_id)))
            return AbdState(
                seq=state.seq,
                val=state.val,
                phase=Phase1(
                    request_id=msg.request_id,
                    requester_id=src,
                    write=write,
                    responses=((id, (state.seq, state.val)),),
                ),
            )

        if isinstance(msg, Internal) and isinstance(msg.msg, Query):
            o.send(src, Internal(AckQuery(msg.msg.request_id, state.seq, state.val)))
            return None

        if (
            isinstance(msg, Internal)
            and isinstance(msg.msg, AckQuery)
            and isinstance(state.phase, Phase1)
            and state.phase.request_id == msg.msg.request_id
        ):
            ph = state.phase
            responses = dict(ph.responses)
            responses[src] = (msg.msg.seq, msg.msg.value)
            if len(responses) == majority(len(self.peers) + 1):
                # Quorum reached; pick the max-sequencer response and move to
                # phase 2 (sequencers are distinct, so max is unambiguous).
                seq, val = max(responses.values(), key=lambda sv: sv[0])
                read = None
                if ph.write is not None:
                    seq = (seq[0] + 1, id)
                    val = ph.write
                else:
                    read = val
                o.broadcast(self.peers, Internal(Record(ph.request_id, seq, val)))
                # Self-send Record.
                new_seq, new_val = state.seq, state.val
                if seq > state.seq:
                    new_seq, new_val = seq, val
                # Self-send AckRecord.
                return AbdState(
                    seq=new_seq,
                    val=new_val,
                    phase=Phase2(
                        request_id=ph.request_id,
                        requester_id=ph.requester_id,
                        read=read,
                        acks=frozenset([id]),
                    ),
                )
            return AbdState(
                seq=state.seq,
                val=state.val,
                phase=Phase1(
                    request_id=ph.request_id,
                    requester_id=ph.requester_id,
                    write=ph.write,
                    responses=tuple(sorted(responses.items())),
                ),
            )

        if isinstance(msg, Internal) and isinstance(msg.msg, Record):
            o.send(src, Internal(AckRecord(msg.msg.request_id)))
            if msg.msg.seq > state.seq:
                return AbdState(seq=msg.msg.seq, val=msg.msg.value, phase=state.phase)
            return None

        if (
            isinstance(msg, Internal)
            and isinstance(msg.msg, AckRecord)
            and isinstance(state.phase, Phase2)
            and state.phase.request_id == msg.msg.request_id
            and src not in state.phase.acks
        ):
            ph = state.phase
            acks = ph.acks | {src}
            if len(acks) == majority(len(self.peers) + 1):
                if ph.read is not None:
                    o.send(ph.requester_id, GetOk(ph.request_id, ph.read))
                else:
                    o.send(ph.requester_id, PutOk(ph.request_id))
                return AbdState(seq=state.seq, val=state.val, phase=None)
            return AbdState(
                seq=state.seq,
                val=state.val,
                phase=Phase2(
                    request_id=ph.request_id,
                    requester_id=ph.requester_id,
                    read=ph.read,
                    acks=acks,
                ),
            )

        return None


@dataclass
class AbdModelCfg:
    """``fault`` forwards to every replica's :class:`AbdActor`;
    ``"skip_ack"`` builds the deliberately broken cluster, and the compiled
    codec mirrors the same fault on the card."""

    client_count: int
    server_count: int
    network: Network
    fault: Optional[str] = None

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
            RegisterServer(
                AbdActor(model_peers(i, self.server_count), fault=self.fault)
            )
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

        def _compiled():
            from .abd_compiled import AbdCompiled

            return AbdCompiled(model)

        model.compiled = _compiled
        return model


def cli_spec():
    """This module's workload spec (resolved by ``serve/workloads.py``)."""
    from ..cli import CliSpec

    return CliSpec(
        name="ABD linearizable register",
        build=lambda n, net: AbdModelCfg(
            client_count=n, server_count=2, network=net
        ).into_model(),
        default_n=2,
        n_meta="CLIENT_COUNT",
        default_network="unordered_nonduplicating",
        gpu=True,
        gpu_kwargs=dict(capacity=1 << 13, max_frontier=1 << 8),
        ensemble=True,
    )
