"""Raft election + log replication with crash/recover faults.

The counterpart of ``stateright_tpu/models/raft.py``, without its CLI.
Reference: examples/raft.rs — leader election, log replication with
truncation/repair, commit via quorum acks, buffered client broadcasts, and
``max_crashes((n-1)/2)``.  Properties: sometimes election/log liveness;
always election safety and state-machine safety
(examples/raft.rs:460-510).

The reference's manual ``Hash`` impl excludes ``delivered_messages`` and
``buffer`` from state identity (examples/raft.rs:39-56); this port mirrors
that via ``__canon_words__`` so exploration prunes the same way, and the
packed form (``raft_compiled.py``) fingerprints only the leading
``fp_words`` words of a row.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import FrozenSet, Optional, Tuple

from ..actor import Actor, ActorModel, Id, Network, Out, majority, model_timeout
from ..core.model import Expectation
from ..ops.fingerprint import canon_words

FOLLOWER, CANDIDATE, LEADER = 0, 1, 2

ELECTION_TIMEOUT = "ElectionTimeout"
REPLICATION_TIMEOUT = "ReplicationTimeout"


@dataclass(frozen=True)
class LogEntry:
    term: int
    payload: bytes


@dataclass(frozen=True)
class VoteRequest:
    cid: int
    cterm: int
    clog_length: int
    clog_term: int


@dataclass(frozen=True)
class VoteResponse:
    voter_id: int
    term: int
    granted: bool


@dataclass(frozen=True)
class LogRequest:
    leader_id: int
    term: int
    prefix_len: int
    prefix_term: int
    leader_commit: int
    suffix: Tuple[LogEntry, ...]


@dataclass(frozen=True)
class LogResponse:
    follower: int
    term: int
    ack: int
    success: bool


@dataclass(frozen=True)
class Broadcast:
    payload: bytes


@dataclass(frozen=True)
class NodeState:
    id: int
    current_term: int
    voted_for: Optional[int]
    log: Tuple[LogEntry, ...]
    commit_length: int
    current_role: int
    current_leader: Optional[int]
    votes_received: FrozenSet[int]
    sent_length: Tuple[int, ...]
    acked_length: Tuple[int, ...]
    delivered_messages: Tuple[bytes, ...]
    buffer: Tuple[bytes, ...]

    def __canon_words__(self, out) -> None:
        # Mirror the reference Hash: delivered_messages and buffer excluded
        # (examples/raft.rs:39-56); votes_received is a set, already
        # order-insensitive under the canonical set encoding.
        canon_words(
            (
                self.id,
                self.current_term,
                self.voted_for,
                self.log,
                self.commit_length,
                self.current_role,
                self.current_leader,
                self.votes_received,
                self.sent_length,
                self.acked_length,
            ),
            out,
        )

    @staticmethod
    def new(id: int, peers_len: int) -> "NodeState":
        return NodeState(
            id=id,
            current_term=0,
            voted_for=None,
            log=(),
            commit_length=0,
            current_role=FOLLOWER,
            current_leader=None,
            votes_received=frozenset(),
            sent_length=(0,) * peers_len,
            acked_length=(0,) * peers_len,
            delivered_messages=(),
            buffer=(),
        )


class RaftActor(Actor):
    def __init__(self, peer_count: int):
        self.peer_count = peer_count

    def name(self) -> str:
        return "Raft Server"

    def on_start(self, id: Id, storage, o: Out) -> NodeState:
        o.set_timer(ELECTION_TIMEOUT, model_timeout())
        o.set_timer(REPLICATION_TIMEOUT, model_timeout())
        # Broadcast a payload (the actor's own id) through itself.
        o.send(id, Broadcast(str(int(id)).encode()))
        return NodeState.new(int(id), self.peer_count)

    # --- message handling (examples/raft.rs:152-299) -------------------------

    def on_msg(self, id: Id, s: NodeState, src: Id, msg, o: Out):
        if isinstance(msg, VoteRequest):
            if msg.cterm > s.current_term:
                s = replace(
                    s,
                    current_term=msg.cterm,
                    current_role=FOLLOWER,
                    voted_for=None,
                )
            last_term = s.log[-1].term if s.log else 0
            log_ok = msg.clog_term > last_term or (
                msg.clog_term == last_term and msg.clog_length >= len(s.log)
            )
            granted = False
            if (
                msg.cterm == s.current_term
                and log_ok
                and (s.voted_for is None or s.voted_for == msg.cid)
            ):
                s = replace(s, voted_for=msg.cid)
                granted = True
            o.send(
                Id(msg.cid),
                VoteResponse(s.id, s.current_term, granted),
            )
            return s

        if isinstance(msg, VoteResponse):
            if (
                s.current_role == CANDIDATE
                and msg.term == s.current_term
                and msg.granted
            ):
                votes = s.votes_received | {msg.voter_id}
                s = replace(s, votes_received=votes)
                if len(votes) >= majority(self.peer_count):
                    s = replace(
                        s,
                        current_role=LEADER,
                        current_leader=s.id,
                    )
                    s = self._try_drain_buffer(s, o)
                    sent = list(s.sent_length)
                    acked = list(s.acked_length)
                    for i in range(self.peer_count):
                        if i == s.id:
                            continue
                        sent[i] = len(s.log)
                        acked[i] = 0
                    s = replace(
                        s, sent_length=tuple(sent), acked_length=tuple(acked)
                    )
                    self._handle_replicate_log(s, o)
                return s
            if msg.term > s.current_term:
                o.set_timer(ELECTION_TIMEOUT, model_timeout())
                return replace(
                    s,
                    current_term=msg.term,
                    current_role=FOLLOWER,
                    voted_for=None,
                )
            return None

        if isinstance(msg, LogRequest):
            if msg.term > s.current_term:
                s = replace(s, current_term=msg.term, voted_for=None)
                o.set_timer(ELECTION_TIMEOUT, model_timeout())
            if msg.term == s.current_term:
                s = replace(
                    s, current_role=FOLLOWER, current_leader=msg.leader_id
                )
                s = self._try_drain_buffer(s, o)
                o.set_timer(ELECTION_TIMEOUT, model_timeout())
            log_ok = len(s.log) >= msg.prefix_len and (
                msg.prefix_len == 0
                or s.log[msg.prefix_len - 1].term == msg.prefix_term
            )
            ack = 0
            success = False
            if msg.term == s.current_term and log_ok:
                s = self._append_entries(
                    s, msg.prefix_len, msg.leader_commit, msg.suffix
                )
                ack = msg.prefix_len + len(msg.suffix)
                success = True
            o.send(
                Id(msg.leader_id),
                LogResponse(s.id, s.current_term, ack, success),
            )
            return s

        if isinstance(msg, LogResponse):
            if msg.term == s.current_term and s.current_role == LEADER:
                if msg.success and msg.ack >= s.acked_length[msg.follower]:
                    sent = list(s.sent_length)
                    acked = list(s.acked_length)
                    sent[msg.follower] = msg.ack
                    acked[msg.follower] = msg.ack
                    s = replace(
                        s, sent_length=tuple(sent), acked_length=tuple(acked)
                    )
                    s = self._commit_log_entries(s)
                elif s.sent_length[msg.follower] > 0:
                    sent = list(s.sent_length)
                    sent[msg.follower] -= 1
                    s = replace(s, sent_length=tuple(sent))
                    self._replicate_log(s, s.id, msg.follower, o)
                return s
            if msg.term > s.current_term:
                o.set_timer(ELECTION_TIMEOUT, model_timeout())
                return replace(
                    s,
                    current_term=msg.term,
                    current_role=FOLLOWER,
                    voted_for=None,
                )
            return None

        if isinstance(msg, Broadcast):
            if s.current_role == LEADER:
                entry = LogEntry(s.current_term, msg.payload)
                log = s.log + (entry,)
                acked = list(s.acked_length)
                acked[s.id] = len(log)
                s = replace(s, log=log, acked_length=tuple(acked))
                self._handle_replicate_log(s, o)
                return s
            if s.current_leader is None:
                return replace(s, buffer=s.buffer + (msg.payload,))
            o.send(Id(s.current_leader), Broadcast(msg.payload))
            return None

        return None

    def on_timeout(self, id: Id, s: NodeState, timer, o: Out):
        if timer == ELECTION_TIMEOUT:
            if s.current_role == LEADER:
                return None
            s = replace(
                s,
                current_term=s.current_term + 1,
                voted_for=s.id,
                current_role=CANDIDATE,
                votes_received=frozenset([s.id]),
            )
            last_term = s.log[-1].term if s.log else 0
            msg = VoteRequest(s.id, s.current_term, len(s.log), last_term)
            for i in range(self.peer_count):
                if i != s.id:
                    o.send(Id(i), msg)
            return s
        if timer == REPLICATION_TIMEOUT:
            self._handle_replicate_log(s, o)
            return None
        return None

    # --- helpers (examples/raft.rs:345-443) ----------------------------------

    def _handle_replicate_log(self, s: NodeState, o: Out) -> None:
        if s.current_role != LEADER:
            return
        for i in range(self.peer_count):
            if i != s.id:
                self._replicate_log(s, s.id, i, o)

    def _replicate_log(self, s: NodeState, leader_id, follower_id, o: Out):
        prefix_len = s.sent_length[follower_id]
        suffix = s.log[prefix_len:]
        prefix_term = s.log[prefix_len - 1].term if prefix_len > 0 else 0
        o.send(
            Id(follower_id),
            LogRequest(
                leader_id,
                s.current_term,
                prefix_len,
                prefix_term,
                s.commit_length,
                suffix,
            ),
        )

    def _append_entries(self, s, prefix_len, leader_commit, suffix):
        log = s.log
        if suffix and len(log) > prefix_len:
            index = min(len(log), prefix_len + len(suffix)) - 1
            if log[index].term != suffix[index - prefix_len].term:
                log = log[:prefix_len]
        if prefix_len + len(suffix) > len(log):
            log = log + tuple(suffix[len(log) - prefix_len :])
        delivered = s.delivered_messages
        commit = s.commit_length
        if leader_commit > commit:
            delivered = delivered + tuple(
                log[i].payload for i in range(commit, leader_commit)
            )
            commit = leader_commit
        return replace(
            s, log=log, delivered_messages=delivered, commit_length=commit
        )

    def _commit_log_entries(self, s: NodeState) -> NodeState:
        min_acks = majority(self.peer_count)
        ready_max = 0
        for i in range(s.commit_length + 1, len(s.log) + 1):
            if sum(1 for a in s.acked_length if a >= i) >= min_acks:
                ready_max = i
        if ready_max > 0 and s.log[ready_max - 1].term == s.current_term:
            delivered = s.delivered_messages + tuple(
                s.log[i].payload for i in range(s.commit_length, ready_max)
            )
            return replace(
                s, delivered_messages=delivered, commit_length=ready_max
            )
        return s

    def _try_drain_buffer(self, s: NodeState, o: Out) -> NodeState:
        if s.current_role == LEADER and s.buffer:
            for payload in s.buffer:
                o.send(Id(s.id), Broadcast(payload))
            return replace(s, buffer=())
        return s


@dataclass
class RaftModelCfg:
    """examples/raft.rs:445-510; ``check`` defaults to
    ``target_max_depth(12)`` BFS on a nonduplicating network."""

    server_count: int = 3
    network: Network = None
    # Crash budget (None = the reference default, (n-1)//2).
    max_crashes: Optional[int] = None

    def into_model(self) -> ActorModel:
        network = (
            self.network
            if self.network is not None
            else Network.new_unordered_nonduplicating()
        )

        def election_safety(_m, state):
            leader_terms = set()
            for s in state.actor_states:
                if s.current_role == LEADER:
                    if s.current_term in leader_terms:
                        return False
                    leader_terms.add(s.current_term)
            return True

        def state_machine_safety(_m, state):
            longest = max(
                state.actor_states, key=lambda s: len(s.delivered_messages)
            )
            for s in state.actor_states:
                for a, b in zip(s.delivered_messages, longest.delivered_messages):
                    if a != b:
                        return False
            return True

        model = ActorModel(cfg=self)
        model.add_actors(
            RaftActor(self.server_count) for _ in range(self.server_count)
        )

        def _compiled():
            from .raft_compiled import RaftCompiled

            return RaftCompiled(model)

        model.compiled = _compiled
        model = (
            model.init_network_(network)
            .max_crashes_(
                (self.server_count - 1) // 2
                if self.max_crashes is None
                else self.max_crashes
            )
            .property(
                Expectation.SOMETIMES,
                "Election Liveness",
                lambda _m, s: any(
                    a.current_role == LEADER for a in s.actor_states
                ),
            )
            .property(
                Expectation.SOMETIMES,
                "Log Liveness",
                lambda _m, s: any(a.commit_length > 0 for a in s.actor_states),
            )
            .property(Expectation.ALWAYS, "Election Safety", election_safety)
            .property(
                Expectation.ALWAYS, "State Machine Safety", state_machine_safety
            )
        )
        return model


def cli_spec():
    """This module's workload spec (resolved by ``serve/workloads.py``)."""
    from ..cli import CliSpec

    return CliSpec(
        name="raft",
        build=lambda n, net: RaftModelCfg(
            server_count=n, network=net
        ).into_model(),
        default_n=3,
        n_meta="SERVER_COUNT",
        default_network="unordered_nonduplicating",
        target_max_depth=12,
        gpu=True,
        gpu_kwargs=dict(capacity=1 << 20, max_frontier=1 << 10),
        gpu_target_max_depth=9,
    )
