"""Bit-packed device form of raft (kernel K11).

The counterpart of ``stateright_tpu/models/raft_compiled.py``: three
servers under the reference's default ``raft check`` (examples/raft.rs)
-- Deliver over five message kinds with multiset counts above 1, two
timers a node, Crash/Recover under ``max_crashes(1)``, log truncation and
repair, quorum commits and buffered broadcasts.  Word layout (W = 58),
identical to the JAX codec's:

- words 0..5: three node records, 56 bits over a lo/hi u32 pair each --
  term (3), voted_for (2), role (2), leader (2), votes bitmap (3), commit
  (3), log_len (3), 4 log entries of term (3) + payload (2), sent_length
  3x3, acked_length 3x3;
- word 6: the timer bitmap (2 bits a node: election, replication) and the
  crashed bitmap (3 bits from bit 6);
- words 7..54: 24 sorted 2-word envelope codes, then zeros -- the
  nonduplicating multiset, a duplicate a repeated code;
- words 55..57: each node's delivered messages and buffer.  They are not
  part of the state's identity (``fp_words = 55``, examples/raft.rs:39-56):
  two rows that differ only there are one state, represented by the row
  inserted first.

Device function: :func:`raft_step` (K11, ``csrc/raft_step.cu``) is the JAX
``step`` -- 24 Deliver lanes (one a slot; only the first of a run of equal
codes is a lane), then per node its election timeout, replication
timeout, crash and recover lanes -- fused with ``property_conds``, on a
CUDA tensor; :func:`raft_step_plain` is its plain-torch twin, run for CPU
tensors.  The twin computes in int64 masked to 32 bits (``ops/u32.py``)
and reproduces the JAX code's u32 wrap-around: selects at wrapped indices
(``b - 1`` with ``b = 0``, ``idx - b``, ``commit + (j - dlen)``) return 0,
and field inserts are not masked to their width.  The engine expands it
in one phase, as it does 2pc.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from ..actor import Envelope, Id, Network
from ..actor.model import ActorModelState
from ..ops import cuda
from ..ops.u32 import M32, i32, u32
from ..parallel.compiled import CompiledModel, fused_conds, override_conds
from .raft import (
    Broadcast,
    CANDIDATE,
    ELECTION_TIMEOUT,
    FOLLOWER,
    LEADER,
    LogEntry,
    LogRequest,
    LogResponse,
    NodeState,
    REPLICATION_TIMEOUT,
    VoteRequest,
    VoteResponse,
)

N = 3  # servers (the reference's default check config)
TERM_CAP = 7  # 3 bits; depth-9 max observed is 4 — encode flags overflow
LOG_CAP = 4  # entries; depth-9 max observed is 2
BUF_CAP = 3
DELIV_CAP = 5
NET_SLOTS = 24  # depth-9 in-flight peak is 14; overflow flags loudly
SENDS = 5  # max messages one transition emits (leader election drain)

_T_VOTE_REQ, _T_VOTE_RESP, _T_LOG_REQ, _T_LOG_RESP, _T_BCAST = 1, 2, 3, 4, 5

# node-record field offsets (56 bits over a lo/hi u32 pair)
_F_TERM = (0, 3)
_F_VOTED = (3, 2)  # 0 none, 1+i
_F_ROLE = (5, 2)
_F_LEADER = (7, 2)  # 0 none, 1+i
_F_VOTES = 9  # +i, 1 bit each
_F_COMMIT = (12, 3)
_F_LOGLEN = (15, 3)
_LOG0 = 18  # + 5*e: term(3) + payload(2)
_F_SENT0 = 18 + 5 * LOG_CAP  # + 3*i
_F_ACKED0 = _F_SENT0 + 9  # + 3*i


class RaftCompiled(CompiledModel):
    """Codec and fused device step for ``RaftModelCfg.into_model()``."""

    step_flags = True

    def __init__(self, model):
        self.model = model
        cfg = model.cfg
        if cfg.server_count != N:
            raise ValueError("packed raft fixes server_count=3")
        if model.max_crashes > 1:
            raise ValueError(
                "packed raft supports max_crashes <= 1 (the reference "
                "default, (n-1)//2 for n=3)"
            )
        if model.init_network.kind != "unordered_nonduplicating":
            raise ValueError(
                "packed raft supports the unordered_nonduplicating network"
            )
        self.max_crashes = model.max_crashes
        self.m = NET_SLOTS
        self._NET0 = 2 * N + 1
        self._NONFP0 = self._NET0 + 2 * self.m
        self.state_width = self._NONFP0 + N
        self.fp_words = self._NONFP0
        # m deliver lanes + per-node election timeout, replication
        # timeout, crash, recover.
        self.max_actions = self.m + 4 * N

    def cache_key(self):
        return (type(self).__qualname__, self.max_crashes)

    def spec_constants(self):
        """The constants, declared (the wrapped actor model is no
        dataclass)."""
        return {
            "server_count": repr(N),
            "max_crashes": repr(self.max_crashes),
            "network": self.model.init_network.kind,
        }

    def spec_widens(self, old_constants: dict) -> bool:
        """Raising the crash budget only adds reachable states (Crash is
        gated on ``n_crashed < max_crashes``, Recover fires only from
        crashed states); the other constants must be unchanged."""
        return self.widens_by(old_constants, "max_crashes")

    # --- node record ----------------------------------------------------------

    @staticmethod
    def _encode_node(s: NodeState) -> int:
        if s.current_term > TERM_CAP:
            raise ValueError(f"term {s.current_term} exceeds TERM_CAP")
        if len(s.log) > LOG_CAP:
            raise ValueError(f"log length {len(s.log)} exceeds LOG_CAP")
        bits = s.current_term
        bits |= (0 if s.voted_for is None else 1 + s.voted_for) << _F_VOTED[0]
        bits |= s.current_role << _F_ROLE[0]
        bits |= (
            0 if s.current_leader is None else 1 + s.current_leader
        ) << _F_LEADER[0]
        for v in s.votes_received:
            bits |= 1 << (_F_VOTES + v)
        bits |= s.commit_length << _F_COMMIT[0]
        bits |= len(s.log) << _F_LOGLEN[0]
        for e, entry in enumerate(s.log):
            if entry.term > TERM_CAP:
                raise ValueError("log entry term exceeds TERM_CAP")
            payload = int(entry.payload)
            bits |= (entry.term | (payload << 3)) << (_LOG0 + 5 * e)
        for i in range(N):
            if s.sent_length[i] > LOG_CAP or s.acked_length[i] > LOG_CAP:
                raise ValueError("sent/acked length exceeds LOG_CAP")
            bits |= s.sent_length[i] << (_F_SENT0 + 3 * i)
            bits |= s.acked_length[i] << (_F_ACKED0 + 3 * i)
        return bits

    def _decode_node(self, bits: int, idx: int, nonfp: int) -> NodeState:
        log_len = (bits >> _F_LOGLEN[0]) & 7
        log = []
        for e in range(log_len):
            ent = (bits >> (_LOG0 + 5 * e)) & 0x1F
            log.append(LogEntry(ent & 7, str(ent >> 3).encode()))
        voted = (bits >> _F_VOTED[0]) & 3
        leader = (bits >> _F_LEADER[0]) & 3
        dlen = nonfp & 7
        delivered = tuple(
            str((nonfp >> (3 + 2 * j)) & 3).encode() for j in range(dlen)
        )
        blen = (nonfp >> 13) & 3
        buffer = tuple(
            str((nonfp >> (15 + 2 * j)) & 3).encode() for j in range(blen)
        )
        return NodeState(
            id=idx,
            current_term=bits & 7,
            voted_for=None if voted == 0 else voted - 1,
            log=tuple(log),
            commit_length=(bits >> _F_COMMIT[0]) & 7,
            current_role=(bits >> _F_ROLE[0]) & 3,
            current_leader=None if leader == 0 else leader - 1,
            votes_received=frozenset(
                v for v in range(N) if (bits >> (_F_VOTES + v)) & 1
            ),
            sent_length=tuple(
                (bits >> (_F_SENT0 + 3 * i)) & 7 for i in range(N)
            ),
            acked_length=tuple(
                (bits >> (_F_ACKED0 + 3 * i)) & 7 for i in range(N)
            ),
            delivered_messages=delivered,
            buffer=buffer,
        )

    def _encode_nonfp(self, s: NodeState) -> int:
        if len(s.delivered_messages) > DELIV_CAP:
            raise ValueError("delivered_messages exceeds DELIV_CAP")
        if len(s.buffer) > BUF_CAP:
            raise ValueError("buffer exceeds BUF_CAP")
        bits = len(s.delivered_messages)
        for j, p in enumerate(s.delivered_messages):
            bits |= int(p) << (3 + 2 * j)
        bits |= len(s.buffer) << 13
        for j, p in enumerate(s.buffer):
            bits |= int(p) << (15 + 2 * j)
        return bits

    # --- envelope codes (2 words) ---------------------------------------------

    def _env_code64(self, env: Envelope) -> Tuple[int, int]:
        """w0: tag(3) | src(2) | dst(2) | fields a/b/c/d/e (3 bits each at
        7/10/13/16/19); w1: LogRequest suffix entries (5 bits each)."""
        msg = env.msg
        src, dst = int(env.src), int(env.dst)
        w0 = src << 3 | dst << 5
        w1 = 0
        if isinstance(msg, VoteRequest):
            assert msg.cid == src
            if msg.cterm > TERM_CAP or msg.clog_term > TERM_CAP:
                raise ValueError("VoteRequest term exceeds TERM_CAP")
            w0 |= _T_VOTE_REQ | msg.cterm << 7 | msg.clog_length << 10
            w0 |= msg.clog_term << 13
        elif isinstance(msg, VoteResponse):
            assert msg.voter_id == src
            if msg.term > TERM_CAP:
                raise ValueError("VoteResponse term exceeds TERM_CAP")
            w0 |= _T_VOTE_RESP | msg.term << 7 | int(msg.granted) << 10
        elif isinstance(msg, LogRequest):
            assert msg.leader_id == src
            if msg.term > TERM_CAP or msg.prefix_term > TERM_CAP:
                raise ValueError("LogRequest term exceeds TERM_CAP")
            if len(msg.suffix) > LOG_CAP:
                raise ValueError("LogRequest suffix exceeds LOG_CAP")
            w0 |= _T_LOG_REQ | msg.term << 7 | msg.prefix_len << 10
            w0 |= msg.prefix_term << 13 | msg.leader_commit << 16
            w0 |= len(msg.suffix) << 19
            for e, entry in enumerate(msg.suffix):
                w1 |= (entry.term | (int(entry.payload) << 3)) << (5 * e)
        elif isinstance(msg, LogResponse):
            assert msg.follower == src
            if msg.term > TERM_CAP:
                raise ValueError("LogResponse term exceeds TERM_CAP")
            w0 |= _T_LOG_RESP | msg.term << 7 | msg.ack << 10
            w0 |= int(msg.success) << 13
        elif isinstance(msg, Broadcast):
            w0 |= _T_BCAST | int(msg.payload) << 7
        else:
            raise ValueError(f"unknown message {msg!r}")
        return w0, w1

    def _env_of64(self, w0: int, w1: int) -> Envelope:
        tag = w0 & 7
        src = (w0 >> 3) & 3
        dst = (w0 >> 5) & 3
        a = (w0 >> 7) & 7
        b = (w0 >> 10) & 7
        c = (w0 >> 13) & 7
        d = (w0 >> 16) & 7
        e = (w0 >> 19) & 7
        if tag == _T_VOTE_REQ:
            msg: Any = VoteRequest(src, a, b, c)
        elif tag == _T_VOTE_RESP:
            msg = VoteResponse(src, a, bool(b))
        elif tag == _T_LOG_REQ:
            suffix = tuple(
                LogEntry(
                    (w1 >> (5 * j)) & 7, str((w1 >> (5 * j + 3)) & 3).encode()
                )
                for j in range(e)
            )
            msg = LogRequest(src, a, b, c, d, suffix)
        elif tag == _T_LOG_RESP:
            msg = LogResponse(src, a, b, bool(c & 1))
        elif tag == _T_BCAST:
            msg = Broadcast(str(a & 3).encode())
        else:
            raise ValueError(f"bad envelope tag {tag}")
        return Envelope(Id(src), Id(dst), msg)

    # --- full state -----------------------------------------------------------

    def encode(self, st: ActorModelState) -> np.ndarray:
        words = np.zeros(self.state_width, dtype=np.uint32)
        for i in range(N):
            bits = self._encode_node(st.actor_states[i])
            words[2 * i] = bits & 0xFFFFFFFF
            words[2 * i + 1] = bits >> 32
        tbits = 0
        for i in range(N):
            if ELECTION_TIMEOUT in st.timers_set[i]:
                tbits |= 1 << (2 * i)
            if REPLICATION_TIMEOUT in st.timers_set[i]:
                tbits |= 1 << (2 * i + 1)
            if st.crashed[i]:
                tbits |= 1 << (2 * N + i)
        words[2 * N] = tbits
        codes: List[Tuple[int, int]] = []
        for env, count in st.network.counts:
            codes.extend([self._env_code64(env)] * count)
        if len(codes) > self.m:
            raise ValueError(
                f"{len(codes)} in-flight messages exceed {self.m} slots"
            )
        codes.sort()
        for k, (w0, w1) in enumerate(codes):
            words[self._NET0 + 2 * k] = w0
            words[self._NET0 + 2 * k + 1] = w1
        for i in range(N):
            words[self._NONFP0 + i] = self._encode_nonfp(st.actor_states[i])
        return words

    def decode(self, words: Sequence[int]) -> ActorModelState:
        nodes = tuple(
            self._decode_node(
                int(words[2 * i]) | (int(words[2 * i + 1]) << 32),
                i,
                int(words[self._NONFP0 + i]),
            )
            for i in range(N)
        )
        tbits = int(words[2 * N])
        timers = tuple(
            frozenset(
                ([ELECTION_TIMEOUT] if (tbits >> (2 * i)) & 1 else [])
                + ([REPLICATION_TIMEOUT] if (tbits >> (2 * i + 1)) & 1 else [])
            )
            for i in range(N)
        )
        crashed = tuple(bool((tbits >> (2 * N + i)) & 1) for i in range(N))
        counts: dict = {}
        for k in range(self.m):
            w0 = int(words[self._NET0 + 2 * k])
            w1 = int(words[self._NET0 + 2 * k + 1])
            if w0:
                env = self._env_of64(w0, w1)
                counts[env] = counts.get(env, 0) + 1
        network = Network(
            kind="unordered_nonduplicating", counts=frozenset(counts.items())
        )
        return ActorModelState(
            actor_states=nodes,
            network=network,
            timers_set=timers,
            random_choices=((),) * N,
            crashed=crashed,
            history=self.model.init_history,
            actor_storages=(None,) * N,
        )

    # --- device side ----------------------------------------------------------

    def step(self, states):
        nexts, valid, _conds, _flag = raft_step(states, self.max_crashes)
        return nexts, valid

    def property_conds(self, states):
        return raft_step(states, self.max_crashes)[2]

    def expand(self, states):
        nexts, valid, conds, flag = raft_step(states, self.max_crashes)
        if not fused_conds(self, RaftCompiled):
            conds = self.property_conds(states)
        return nexts, valid, conds, flag

    def walk_step(self, states, plain=False):
        fn = raft_step_plain if plain else raft_step
        nexts, valid, conds, flags = fn(states, self.max_crashes, flag_rows=True)
        if not fused_conds(self, RaftCompiled):
            conds = override_conds(self, states, plain)
        return nexts, valid, conds, flags


N_PROPS = 4  # Election Liveness, Log Liveness, Election Safety, State Machine Safety
NET0 = 2 * N + 1
NONFP0 = NET0 + 2 * NET_SLOTS
W = NONFP0 + N
A = NET_SLOTS + 4 * N


def fresh_nodes() -> List[int]:
    """The 56-bit record ``on_start`` gives node ``i`` (what Recover
    writes), from the host codec."""
    return [RaftCompiled._encode_node(NodeState.new(i, N)) for i in range(N)]


# --- the plain-torch twin ------------------------------------------------------
#
# Every function below mirrors its JAX namesake on u32 words carried in
# int64 in [0, 2**32): a lane is a tensor element, ``torch.where`` takes the
# place of ``jnp.where``.


def _shl(x, n):
    """u32 ``x << n`` (``n`` at most 31): the bits past 31 are lost."""
    return (x << n) & M32


def _ext(lo, hi, off: int, width: int):
    mask = (1 << width) - 1
    if off + width <= 32:
        return (lo >> off) & mask
    if off >= 32:
        return (hi >> (off - 32)) & mask
    return ((lo >> off) | _shl(hi, 32 - off)) & mask


def _ins(lo, hi, off: int, width: int, val):
    """Field (off, width) of the lo/hi pair replaced by ``val``, shifted in
    u32 and NOT masked to the width, as in JAX."""
    m = (1 << width) - 1
    if off + width <= 32:
        lo = (lo & (~(m << off) & M32)) | _shl(val, off)
    elif off >= 32:
        o = off - 32
        hi = (hi & (~(m << o) & M32)) | _shl(val, o)
    else:
        nlo = 32 - off
        lo = (lo & (~((m & ((1 << nlo) - 1)) << off) & M32)) | _shl(
            val & ((1 << nlo) - 1), off
        )
        hi = (hi & (~(m >> nlo) & M32)) | (val >> nlo)
    return lo, hi


def _fields(lo, hi):
    return dict(
        term=_ext(lo, hi, *_F_TERM),
        voted=_ext(lo, hi, *_F_VOTED),
        role=_ext(lo, hi, *_F_ROLE),
        leader=_ext(lo, hi, *_F_LEADER),
        votes=[_ext(lo, hi, _F_VOTES + v, 1) for v in range(N)],
        commit=_ext(lo, hi, *_F_COMMIT),
        loglen=_ext(lo, hi, *_F_LOGLEN),
        log=[_ext(lo, hi, _LOG0 + 5 * e, 5) for e in range(LOG_CAP)],
        sent=[_ext(lo, hi, _F_SENT0 + 3 * i, 3) for i in range(N)],
        acked=[_ext(lo, hi, _F_ACKED0 + 3 * i, 3) for i in range(N)],
    )


def _sel(entries, idx):
    """``entries[idx]``, 0 for an index outside the list (a wrapped u32
    index included)."""
    out = torch.zeros_like(idx)
    for e, w in enumerate(entries):
        out = torch.where(idx == e, w, out)
    return out


def _last_term(f):
    lt = _sel(f["log"], (f["loglen"] - 1) & M32) & 7
    return torch.where(f["loglen"] == 0, 0, lt)


def _peers(i):
    """The two peers of node ``i``, in ascending order."""
    return torch.where(i == 0, 1, 0), torch.where(i == 2, 1, 2)


def _mk_logreq(me, peer, f):
    """The replicate_log send (models/raft.py:308-322): LogRequest(me,
    term, sent[peer], the term of the entry before, commit,
    log[sent[peer]:]) as a (w0, w1) pair."""
    plen = _sel(f["sent"], peer)
    pterm = torch.where(plen == 0, 0, _sel(f["log"], (plen - 1) & M32) & 7)
    slen = (f["loglen"] - plen) & M32
    w0 = (
        _T_LOG_REQ | _shl(me, 3) | _shl(peer, 5) | _shl(f["term"], 7)
        | _shl(plen, 10) | _shl(pterm, 13) | _shl(f["commit"], 16)
        | _shl(slen, 19)
    )
    w1 = torch.zeros_like(w0)
    for j in range(LOG_CAP):
        w1 = w1 | torch.where(j < slen, _shl(_sel(f["log"], plen + j), 5 * j), 0)
    return w0, w1


def _tag_sel(tag, pairs, default):
    out = default
    for t, v in pairs:
        out = torch.where(tag == t, v, out)
    return out


def _deliver_lanes(st):
    """The JAX ``_deliver_lane`` for every slot k: ``st`` int64[F, W] ->
    a dict of [F, 24] tensors (the lane's node, its new record, delivered
    and buffer word and timer word, its sends, validity and flag)."""
    k = torch.arange(NET_SLOTS, device=st.device)[None, :]
    w0 = st[:, NET0:NONFP0:2]
    w1 = st[:, NET0 + 1:NONFP0:2]
    occupied = w0 != 0
    zero = torch.zeros_like(w0[:, :1])
    prev0 = torch.cat([zero, w0[:, :-1]], dim=1)
    prev1 = torch.cat([zero, w1[:, :-1]], dim=1)
    first = (k == 0) | (prev0 != w0) | (prev1 != w1)

    tag = w0 & 7
    src = (w0 >> 3) & 3
    dst = (w0 >> 5) & 3
    a = (w0 >> 7) & 7
    b = (w0 >> 10) & 7
    c = (w0 >> 13) & 7
    d = (w0 >> 16) & 7
    e = (w0 >> 19) & 7

    tbits = st[:, 2 * N : 2 * N + 1]
    dst_crashed = (tbits >> (2 * N + dst)) & 1
    lo = _sel([st[:, 2 * i : 2 * i + 1] for i in range(N)], dst)
    hi = _sel([st[:, 2 * i + 1 : 2 * i + 2] for i in range(N)], dst)
    f = _fields(lo, hi)
    nonfp = _sel([st[:, NONFP0 + i : NONFP0 + i + 1] for i in range(N)], dst)
    flag = torch.zeros_like(occupied)

    # ---- VoteRequest (models/raft.py:143-167) ----
    vr_newer = a > f["term"]
    vr_term = torch.where(vr_newer, a, f["term"])
    vr_role = torch.where(vr_newer, FOLLOWER, f["role"])
    vr_voted = torch.where(vr_newer, 0, f["voted"])
    last_term = _last_term(f)
    vr_log_ok = (c > last_term) | ((c == last_term) & (b >= f["loglen"]))
    vr_granted = (
        (a == vr_term) & vr_log_ok & ((vr_voted == 0) | (vr_voted == src + 1))
    )
    vr_voted2 = torch.where(vr_granted, src + 1, vr_voted)
    vr_lo, vr_hi = _ins(lo, hi, *_F_TERM, vr_term)
    vr_lo, vr_hi = _ins(vr_lo, vr_hi, *_F_ROLE, vr_role)
    vr_lo, vr_hi = _ins(vr_lo, vr_hi, *_F_VOTED, vr_voted2)
    vr_send0 = (
        _T_VOTE_RESP | _shl(dst, 3) | _shl(src, 5) | _shl(vr_term, 7)
        | _shl(vr_granted.long(), 10)
    )

    # ---- VoteResponse (models/raft.py:169-204) ----
    grant_path = (f["role"] == CANDIDATE) & (a == f["term"]) & (b == 1)
    votes2 = [torch.where(src == v, 1, f["votes"][v]) for v in range(N)]
    win = grant_path & (sum(votes2) >= 2)
    # Drain the buffer on becoming leader: each buffered payload is
    # re-broadcast to self (models/raft.py:183,358-363).
    blen = (nonfp >> 13) & 3
    resp_sends0 = [torch.zeros_like(w0) for _ in range(SENDS)]
    resp_sends1 = [torch.zeros_like(w0) for _ in range(SENDS)]
    for j in range(BUF_CAP):
        payload = (nonfp >> (15 + 2 * j)) & 3
        resp_sends0[j] = torch.where(
            win & (j < blen),
            _T_BCAST | _shl(dst, 3) | _shl(dst, 5) | _shl(payload, 7), 0,
        )
    nonfp_resp = torch.where(win, nonfp & ((1 << 13) - 1), nonfp)
    rs_lo, rs_hi = lo, hi
    for v in range(N):
        rs_lo, rs_hi = _ins(rs_lo, rs_hi, _F_VOTES + v, 1, votes2[v])
    w_lo, w_hi = _ins(rs_lo, rs_hi, *_F_ROLE, LEADER)
    w_lo, w_hi = _ins(w_lo, w_hi, *_F_LEADER, dst + 1)
    for i in range(N):
        is_peer = dst != i
        cur_sent = _ext(w_lo, w_hi, _F_SENT0 + 3 * i, 3)
        cur_acked = _ext(w_lo, w_hi, _F_ACKED0 + 3 * i, 3)
        w_lo, w_hi = _ins(w_lo, w_hi, _F_SENT0 + 3 * i, 3,
                          torch.where(is_peer, f["loglen"], cur_sent))
        w_lo, w_hi = _ins(w_lo, w_hi, _F_ACKED0 + 3 * i, 3,
                          torch.where(is_peer, 0, cur_acked))
    wf = _fields(w_lo, w_hi)
    p1, p2 = _peers(dst)
    lr1_w0, lr1_w1 = _mk_logreq(dst, p1, wf)
    lr2_w0, lr2_w1 = _mk_logreq(dst, p2, wf)
    resp_sends0[BUF_CAP] = torch.where(win, lr1_w0, 0)
    resp_sends1[BUF_CAP] = torch.where(win, lr1_w1, 0)
    resp_sends0[BUF_CAP + 1] = torch.where(win, lr2_w0, 0)
    resp_sends1[BUF_CAP + 1] = torch.where(win, lr2_w1, 0)
    vresp_lo = torch.where(win, w_lo, rs_lo)
    vresp_hi = torch.where(win, w_hi, rs_hi)
    # The stale-term path: step down, renew the election timer.
    vresp_stale = ~grant_path & (a > f["term"])
    st_lo, st_hi = _ins(lo, hi, *_F_TERM, a)
    st_lo, st_hi = _ins(st_lo, st_hi, *_F_ROLE, FOLLOWER)
    st_lo, st_hi = _ins(st_lo, st_hi, *_F_VOTED, 0)
    vresp_lo = torch.where(vresp_stale, st_lo, vresp_lo)
    vresp_hi = torch.where(vresp_stale, st_hi, vresp_hi)
    vresp_valid = grant_path | vresp_stale

    # ---- LogRequest (models/raft.py:206-232) ----
    lr_newer = a > f["term"]
    lr_term = torch.where(lr_newer, a, f["term"])
    lr_voted = torch.where(lr_newer, 0, f["voted"])
    lr_eq = a == lr_term
    lr_role = torch.where(lr_eq, FOLLOWER, f["role"])
    lr_leader = torch.where(lr_eq, src + 1, f["leader"])
    lr_set_e = lr_newer | lr_eq
    prefix_ok = (b == 0) | ((_sel(f["log"], (b - 1) & M32) & 7) == c)
    do_append = lr_eq & (f["loglen"] >= b) & prefix_ok
    # _append_entries (models/raft.py:324-341)
    suffix = [(w1 >> (5 * j)) & 0x1F for j in range(LOG_CAP)]
    idx = (torch.minimum(f["loglen"], b + e) - 1) & M32
    log_t = _sel(f["log"], idx) & 7
    suf_t = _sel(suffix, (idx - b) & M32) & 7
    truncate = (e > 0) & (f["loglen"] > b) & (log_t != suf_t)
    base_len = torch.where(truncate, b, f["loglen"])
    new_len = torch.maximum(base_len, b + e)
    flag = flag | (do_append & (new_len > LOG_CAP))
    new_log = []
    for p in range(LOG_CAP):
        from_suffix = (p >= base_len) & (p < new_len)
        sval = _sel(suffix, (p - b) & M32)
        new_log.append(torch.where(
            p < base_len, f["log"][p], torch.where(from_suffix, sval, 0)
        ))
    # Deliver the newly committed entries (leader_commit d > commit).
    adv = do_append & (d > f["commit"])
    new_commit = torch.where(adv, d, f["commit"])
    dlen = nonfp & 7
    new_dlen = dlen + torch.where(adv, (d - f["commit"]) & M32, 0)
    flag = flag | (new_dlen > DELIV_CAP)
    lr_nonfp = nonfp
    for j in range(DELIV_CAP):
        src_idx = (f["commit"] + j - dlen) & M32
        pay = (_sel(new_log, src_idx) >> 3) & 3
        put = adv & (j >= dlen) & (j < new_dlen)
        lr_nonfp = torch.where(
            put, (lr_nonfp & (~(3 << (3 + 2 * j)) & M32)) | _shl(pay, 3 + 2 * j),
            lr_nonfp,
        )
    lr_nonfp = torch.where(adv, (lr_nonfp & (~7 & M32)) | new_dlen, lr_nonfp)
    lrq_lo, lrq_hi = _ins(lo, hi, *_F_TERM, lr_term)
    lrq_lo, lrq_hi = _ins(lrq_lo, lrq_hi, *_F_VOTED, lr_voted)
    lrq_lo, lrq_hi = _ins(lrq_lo, lrq_hi, *_F_ROLE, lr_role)
    lrq_lo, lrq_hi = _ins(lrq_lo, lrq_hi, *_F_LEADER, lr_leader)
    app_lo, app_hi = _ins(lrq_lo, lrq_hi, *_F_LOGLEN, new_len)
    for p in range(LOG_CAP):
        app_lo, app_hi = _ins(app_lo, app_hi, _LOG0 + 5 * p, 5, new_log[p])
    app_lo, app_hi = _ins(app_lo, app_hi, *_F_COMMIT, new_commit)
    lrq_lo = torch.where(do_append, app_lo, lrq_lo)
    lrq_hi = torch.where(do_append, app_hi, lrq_hi)
    lrq_nonfp = torch.where(do_append, lr_nonfp, nonfp)
    lr_ack = torch.where(do_append, b + e, 0)
    lr_send0 = (
        _T_LOG_RESP | _shl(dst, 3) | _shl(src, 5) | _shl(lr_term, 7)
        | _shl(lr_ack, 10) | _shl(do_append.long(), 13)
    )

    # ---- LogResponse (models/raft.py:234-259) ----
    lead_path = (a == f["term"]) & (f["role"] == LEADER)
    acked_src = _sel(f["acked"], src)
    sent_src = _sel(f["sent"], src)
    upd = (c == 1) & (b >= acked_src)
    # The success path: sent[src] = acked[src] = ack, then the commit
    # scan (models/raft.py:343-356).
    up_lo, up_hi = lo, hi
    for i in range(N):
        sel = src == i
        up_lo, up_hi = _ins(up_lo, up_hi, _F_SENT0 + 3 * i, 3,
                            torch.where(sel, b, f["sent"][i]))
        up_lo, up_hi = _ins(up_lo, up_hi, _F_ACKED0 + 3 * i, 3,
                            torch.where(sel, b, f["acked"][i]))
    upf = _fields(up_lo, up_hi)
    ready_max = torch.zeros_like(w0)
    for i in range(1, LOG_CAP + 1):
        cnt = sum((upf["acked"][j] >= i).long() for j in range(N))
        ok = (i > f["commit"]) & (i <= f["loglen"]) & (cnt >= 2)
        ready_max = torch.where(ok, i, ready_max)
    rm_term = _sel(f["log"], (ready_max - 1) & M32) & 7
    do_commit = (ready_max > 0) & (rm_term == f["term"])
    new_dlen2 = dlen + torch.where(do_commit, (ready_max - f["commit"]) & M32, 0)
    flag = flag | (upd & (new_dlen2 > DELIV_CAP))
    lresp_nonfp = nonfp
    for j in range(DELIV_CAP):
        src_idx = (f["commit"] + j - dlen) & M32
        pay = (_sel(f["log"], src_idx) >> 3) & 3
        put = do_commit & (j >= dlen) & (j < new_dlen2)
        lresp_nonfp = torch.where(
            put,
            (lresp_nonfp & (~(3 << (3 + 2 * j)) & M32)) | _shl(pay, 3 + 2 * j),
            lresp_nonfp,
        )
    lresp_nonfp = torch.where(
        do_commit, (lresp_nonfp & (~7 & M32)) | new_dlen2, lresp_nonfp
    )
    up2_lo, up2_hi = _ins(up_lo, up_hi, *_F_COMMIT,
                          torch.where(do_commit, ready_max, f["commit"]))
    # The retry path: sent[src] -= 1, resend (models/raft.py:245-249).
    retry = ~upd & (sent_src > 0)
    rt_lo, rt_hi = lo, hi
    for i in range(N):
        rt_lo, rt_hi = _ins(rt_lo, rt_hi, _F_SENT0 + 3 * i, 3, torch.where(
            src == i, (sent_src - 1) & M32, f["sent"][i]))
    rt_w0, rt_w1 = _mk_logreq(dst, src, _fields(rt_lo, rt_hi))
    lresp_lo = torch.where(
        lead_path & upd, up2_lo, torch.where(lead_path & retry, rt_lo, lo))
    lresp_hi = torch.where(
        lead_path & upd, up2_hi, torch.where(lead_path & retry, rt_hi, hi))
    lresp_nonfp = torch.where(lead_path & upd, lresp_nonfp, nonfp)
    lresp_send0 = torch.where(lead_path & retry, rt_w0, 0)
    lresp_send1 = torch.where(lead_path & retry, rt_w1, 0)
    lresp_stale = ~lead_path & (a > f["term"])
    lresp_lo = torch.where(lresp_stale, st_lo, lresp_lo)
    lresp_hi = torch.where(lresp_stale, st_hi, lresp_hi)
    lresp_valid = lead_path | lresp_stale

    # ---- Broadcast (models/raft.py:261-273) ----
    bc_payload = a & 3
    is_leader = f["role"] == LEADER
    is_bcast = occupied & (tag == _T_BCAST)
    # A leader appends the entry, sets acked[me] = len and replicates.
    bc_len = f["loglen"] + 1
    flag = flag | (is_bcast & is_leader & (f["loglen"] >= LOG_CAP))
    bl_lo, bl_hi = _ins(lo, hi, *_F_LOGLEN, bc_len)
    new_entry = f["term"] | _shl(bc_payload, 3)
    for p in range(LOG_CAP):
        bl_lo, bl_hi = _ins(bl_lo, bl_hi, _LOG0 + 5 * p, 5,
                            torch.where(f["loglen"] == p, new_entry, f["log"][p]))
    for i in range(N):
        bl_lo, bl_hi = _ins(bl_lo, bl_hi, _F_ACKED0 + 3 * i, 3,
                            torch.where(dst == i, bc_len, f["acked"][i]))
    blf = _fields(bl_lo, bl_hi)
    bl1_w0, bl1_w1 = _mk_logreq(dst, p1, blf)
    bl2_w0, bl2_w1 = _mk_logreq(dst, p2, blf)
    # No leader known: buffer the payload.
    no_leader = f["leader"] == 0
    flag = flag | (is_bcast & ~is_leader & no_leader & (blen >= BUF_CAP))
    buf_nonfp = nonfp
    for j in range(BUF_CAP):
        buf_nonfp = torch.where(
            blen == j,
            (buf_nonfp & (~(3 << (15 + 2 * j)) & M32)) | _shl(bc_payload, 15 + 2 * j),
            buf_nonfp,
        )
    buf_nonfp = (buf_nonfp & (~(3 << 13) & M32)) | _shl(torch.clamp(blen + 1, max=3), 13)
    # A known leader: forward to it.
    fwd_w0 = (
        _T_BCAST | _shl(dst, 3) | _shl((f["leader"] - 1) & M32, 5)
        | _shl(bc_payload, 7)
    )
    bc_lo = torch.where(is_leader, bl_lo, lo)
    bc_hi = torch.where(is_leader, bl_hi, hi)
    bc_nonfp = torch.where(is_leader, nonfp, torch.where(no_leader, buf_nonfp, nonfp))

    # ---- select by tag ----
    tags = (_T_VOTE_REQ, _T_VOTE_RESP, _T_LOG_REQ, _T_LOG_RESP, _T_BCAST)
    new_lo = _tag_sel(tag, zip(tags, (vr_lo, vresp_lo, lrq_lo, lresp_lo, bc_lo)), lo)
    new_hi = _tag_sel(tag, zip(tags, (vr_hi, vresp_hi, lrq_hi, lresp_hi, bc_hi)), hi)
    new_nonfp = _tag_sel(tag, [
        (_T_LOG_REQ, lrq_nonfp), (_T_LOG_RESP, lresp_nonfp),
        (_T_VOTE_RESP, nonfp_resp), (_T_BCAST, bc_nonfp),
    ], nonfp)
    true = torch.ones_like(occupied)
    false = torch.zeros_like(occupied)
    valid = occupied & first & (dst_crashed == 0) & _tag_sel(tag, zip(
        tags, (true, vresp_valid, true, lresp_valid, true)), false)
    set_e = _tag_sel(tag, [
        (_T_VOTE_RESP, vresp_stale), (_T_LOG_REQ, lr_set_e),
        (_T_LOG_RESP, lresp_stale),
    ], false)
    zero = torch.zeros_like(w0)
    bc_sends0 = [
        torch.where(is_leader, bl1_w0, torch.where(no_leader, 0, fwd_w0)),
        torch.where(is_leader, bl2_w0, 0), zero, zero, zero,
    ]
    bc_sends1 = [
        torch.where(is_leader, bl1_w1, 0), torch.where(is_leader, bl2_w1, 0),
        zero, zero, zero,
    ]
    none = [zero] * (SENDS - 1)
    tag_sends0 = zip(tags, ([vr_send0] + none, resp_sends0, [lr_send0] + none,
                            [lresp_send0] + none, bc_sends0))
    tag_sends1 = zip(tags, ([zero] * SENDS, resp_sends1, [zero] * SENDS,
                            [lresp_send1] + none, bc_sends1))
    tag_sends0, tag_sends1 = list(tag_sends0), list(tag_sends1)
    sends0 = [_tag_sel(tag, [(t, s[j]) for t, s in tag_sends0], zero)
              for j in range(SENDS)]
    sends1 = [_tag_sel(tag, [(t, s[j]) for t, s in tag_sends1], zero)
              for j in range(SENDS)]
    # Timers: set the election timer of dst where the handler did.
    new_t = torch.where(set_e, tbits | _shl(1, 2 * dst), tbits)
    return dict(node=dst, lo=new_lo, hi=new_hi, nonfp=new_nonfp, tbits=new_t,
                remove=k.expand_as(w0), sends0=sends0, sends1=sends1,
                valid=valid, flag=flag, net_flag=true)


def _node_lanes(st, max_crashes: int):
    """The JAX ``_election_lane``, ``_replication_lane``, ``_crash_lane``
    and ``_recover_lane`` of each node: a dict of [F, 3, 4] tensors (node,
    lane kind) in the shape of :func:`_deliver_lanes`'."""
    f_ = st.shape[0]
    i = torch.arange(N, device=st.device)[None, :]
    tbits = st[:, 2 * N : 2 * N + 1]
    lo, hi = st[:, 0 : 2 * N : 2], st[:, 1 : 2 * N : 2]
    nonfp = st[:, NONFP0 : NONFP0 + N]
    f = _fields(lo, hi)
    zero = torch.zeros_like(lo)
    false = torch.zeros_like(lo, dtype=torch.bool)
    p1, p2 = _peers(i)

    # Election timeout: a fired timer is always consumed -- a LEADER
    # ignores it (models/raft.py:279-280) and still loses the timer; only
    # "re-set the same timer and nothing else" is a no-op.
    e_valid = ((tbits >> (2 * i)) & 1) == 1
    campaign = f["role"] != LEADER
    term2 = f["term"] + 1
    e_flag = e_valid & campaign & (term2 > TERM_CAP)
    n_lo, n_hi = _ins(lo, hi, *_F_TERM, term2)
    n_lo, n_hi = _ins(n_lo, n_hi, *_F_VOTED, i + 1)
    n_lo, n_hi = _ins(n_lo, n_hi, *_F_ROLE, CANDIDATE)
    for v in range(N):
        n_lo, n_hi = _ins(n_lo, n_hi, _F_VOTES + v, 1, (i == v).long())
    e_lo = torch.where(campaign, n_lo, lo)
    e_hi = torch.where(campaign, n_hi, hi)
    last_term = _last_term(f)
    e_sends0 = [
        torch.where(
            campaign,
            _T_VOTE_REQ | _shl(i, 3) | _shl(p, 5) | _shl(term2, 7)
            | _shl(f["loglen"], 10) | _shl(last_term, 13),
            0,
        )
        for p in (p1, p2)
    ] + [zero] * (SENDS - 2)
    e_t = tbits & (~_shl(1, 2 * i) & M32)

    # Replication timeout: consumed even when not leader.
    r_valid = ((tbits >> (2 * i + 1)) & 1) == 1
    is_leader = f["role"] == LEADER
    r_sends0, r_sends1 = [], []
    for p in (p1, p2):
        w0, w1 = _mk_logreq(i, p, f)
        r_sends0.append(torch.where(is_leader, w0, 0))
        r_sends1.append(torch.where(is_leader, w1, 0))
    r_sends0 += [zero] * (SENDS - 2)
    r_sends1 += [zero] * (SENDS - 2)
    r_t = tbits & (~_shl(1, 2 * i + 1) & M32)

    # Crash: the budget counts nodes down at the same time
    # (actor/model.py:264-268); recovery frees it.
    n_crashed = sum((tbits >> (2 * N + j)) & 1 for j in range(N))
    my_crashed = (tbits >> (2 * N + i)) & 1
    if max_crashes == 0:
        c_valid = false
    else:
        c_valid = (my_crashed == 0) & (n_crashed < max_crashes)
    c_t = (tbits & (~_shl(3, 2 * i) & M32)) | _shl(1, 2 * N + i)

    # Recover: on_start gives a fresh record, both timers and a Broadcast
    # of the node's own id to itself (models/raft.py:133-138).
    fresh = torch.tensor(fresh_nodes(), dtype=torch.int64, device=st.device)[None, :]
    v_valid = my_crashed == 1
    v_t = (tbits & (~_shl(1, 2 * N + i) & M32)) | _shl(3, 2 * i)
    v_send0 = _T_BCAST | _shl(i, 3) | _shl(i, 5) | _shl(i, 7)

    def kinds(*xs):
        return torch.stack([x.expand(f_, N) for x in xs], dim=2)

    zeros = [zero] * SENDS
    return dict(
        node=kinds(i, i, i, i),
        lo=kinds(e_lo, lo, lo, fresh & M32),
        hi=kinds(e_hi, hi, hi, fresh >> 32),
        nonfp=kinds(nonfp, nonfp, nonfp, zero),
        tbits=kinds(e_t, r_t, c_t, v_t),
        remove=kinds(*[zero + NET_SLOTS] * 4),
        sends0=[kinds(*xs) for xs in zip(e_sends0, r_sends0, zeros,
                                          [v_send0] + zeros[1:])],
        sends1=[kinds(*xs) for xs in zip(zeros, r_sends1, zeros, zeros)],
        valid=kinds(e_valid, r_valid, c_valid, v_valid),
        flag=kinds(e_flag, false, false, false),
        # A crash or recover lane's flag is 0, its merge cannot overflow.
        net_flag=kinds(~false, ~false, false, false),
    )


def _assemble(st, lanes):
    """The JAX ``_assemble`` of every lane: the lane's node record,
    delivered/buffer word and timer word replaced, slot ``remove`` taken
    out of the multiset, the sends merged in and the slots re-sorted
    (duplicates kept).  Returns ``(nexts int64[F, A, W], overflow
    bool[F, A])``."""
    f_ = st.shape[0]
    net = st[:, NET0:NONFP0]
    slots0 = net[:, None, 0::2].expand(f_, A, NET_SLOTS)
    slots1 = net[:, None, 1::2].expand(f_, A, NET_SLOTS)
    gone = lanes["remove"][..., None] == torch.arange(NET_SLOTS, device=st.device)
    cand0 = torch.cat([torch.where(gone, 0, slots0),
                       torch.stack(lanes["sends0"], dim=-1)], dim=-1)
    cand1 = torch.cat([torch.where(gone, 0, slots1),
                       torch.stack(lanes["sends1"], dim=-1)], dim=-1)
    empty = cand0 == 0
    cand0 = torch.where(empty, M32, cand0)
    cand1 = torch.where(empty, M32, cand1)
    # One int64 key a pair, in (w0, w1) order: equal keys are equal
    # words, so the order among them (JAX sorts stably) cannot show.
    key = torch.sort((cand0 - (1 << 31)) * (1 << 32) + cand1, dim=-1).values
    s0 = (key >> 32) + (1 << 31)
    s1 = key & M32
    overflow = (s0[..., NET_SLOTS:] != M32).any(dim=-1)
    hole = s0[..., :NET_SLOTS] == M32
    new0 = torch.where(hole, 0, s0[..., :NET_SLOTS])
    new1 = torch.where(hole, 0, s1[..., :NET_SLOTS])
    node = lanes["node"]
    head = []
    for i in range(N):
        head.append(torch.where(node == i, lanes["lo"], st[:, None, 2 * i]))
        head.append(torch.where(node == i, lanes["hi"], st[:, None, 2 * i + 1]))
    head.append(lanes["tbits"])
    tail = [torch.where(node == i, lanes["nonfp"], st[:, None, NONFP0 + i])
            for i in range(N)]
    nexts = torch.cat([
        torch.stack(head, dim=-1),
        torch.stack([new0, new1], dim=-1).reshape(f_, A, 2 * NET_SLOTS),
        torch.stack(tail, dim=-1),
    ], dim=-1)
    return nexts, overflow


def raft_lanes_plain(states: torch.Tensor, max_crashes: int):
    """Every lane of packed raft rows, as the JAX ``step`` builds them:
    ``int32[F, W] -> (nexts int32[F, A, W], valid bool[F, A], flags
    bool[F, A])``.  Every lane's words are the JAX lane's, valid or not; a
    lane's flag marks a term past ``TERM_CAP``, a log past ``LOG_CAP``,
    delivered messages past ``DELIV_CAP``, a buffer past ``BUF_CAP`` or
    more than 24 envelopes after the merge."""
    st = u32(states)
    f_ = st.shape[0]
    dl = _deliver_lanes(st)
    nl = _node_lanes(st, max_crashes)

    def flat(x):
        return x.reshape(f_, 4 * N)

    lanes = {
        key: (
            [torch.cat([d, flat(n)], dim=1) for d, n in zip(dl[key], nl[key])]
            if isinstance(dl[key], list)
            else torch.cat([dl[key], flat(nl[key])], dim=1)
        )
        for key in dl
    }
    nexts, overflow = _assemble(st, lanes)
    flags = lanes["flag"] | (overflow & lanes["net_flag"])
    return i32(nexts), lanes["valid"], flags


def raft_conds_plain(states: torch.Tensor) -> torch.Tensor:
    """The JAX ``property_conds``: ``int32[F, W] -> bool[F, 4]``, in the
    order of the model's properties."""
    st = u32(states)
    fs = [_fields(st[:, 2 * i], st[:, 2 * i + 1]) for i in range(N)]
    any_leader = torch.zeros_like(st[:, 0], dtype=torch.bool)
    any_commit = torch.zeros_like(any_leader)
    election_safe = torch.ones_like(any_leader)
    for i in range(N):
        any_leader = any_leader | (fs[i]["role"] == LEADER)
        any_commit = any_commit | (fs[i]["commit"] > 0)
        for j in range(i + 1, N):
            both = (fs[i]["role"] == LEADER) & (fs[j]["role"] == LEADER)
            election_safe = election_safe & ~(both & (fs[i]["term"] == fs[j]["term"]))
    sm_safe = torch.ones_like(any_leader)
    nonfp = [st[:, NONFP0 + i] for i in range(N)]
    for i in range(N):
        for j in range(i + 1, N):
            di, dj = nonfp[i] & 7, nonfp[j] & 7
            for p in range(DELIV_CAP):
                in_both = (p < di) & (p < dj)
                pi = (nonfp[i] >> (3 + 2 * p)) & 3
                pj = (nonfp[j] >> (3 + 2 * p)) & 3
                sm_safe = sm_safe & ~(in_both & (pi != pj))
    return torch.stack([any_leader, any_commit, election_safe, sm_safe], dim=1)


def raft_step_plain(
    states: torch.Tensor, max_crashes: int, flag_rows: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-torch twin of the K11 kernel: ``int32[F, W] -> (nexts
    int32[F, A, W], valid bool[F, A], conds bool[F, 4], flag bool[])`` --
    :func:`raft_lanes_plain` with the flags of its valid lanes OR-ed (the
    JAX ``step``'s ``any(flags & valid)``) and :func:`raft_conds_plain`.
    With ``flag_rows`` the flag is each state's, ``bool[F]``."""
    nexts, valid, flags = raft_lanes_plain(states, max_crashes)
    rows = (flags & valid).any(dim=1)
    return (nexts, valid, raft_conds_plain(states),
            rows if flag_rows else rows.any())


# --- the kernel's wrapper ----------------------------------------------------


def raft_step(states: torch.Tensor, max_crashes: int, flag_rows: bool = False):
    """Every lane's successor and the property conditions of packed raft
    rows, fused (K11): see :func:`raft_step_plain`.  The kernel takes rows
    whose slots hold the codec's sorted codes (nonzero codes first, in
    (w0, w1) order, then zero pairs), as every row the engine holds does:
    it merges the sends into them instead of sorting."""
    if states.device.type == "cpu":
        return raft_step_plain(states, max_crashes, flag_rows)
    if max_crashes not in (0, 1):
        raise ValueError(f"packed raft supports max_crashes <= 1, got {max_crashes}")
    dev = states.device
    cuda.require(states, "states", torch.int32, 2, dev)
    if states.shape[1] != W:
        raise ValueError(f"states must be [F, {W}], got {tuple(states.shape)}")
    f = states.shape[0]
    nexts = torch.empty((f, A, W), dtype=torch.int32, device=dev)
    valid = torch.empty((f, A), dtype=torch.bool, device=dev)
    conds = torch.empty((f, N_PROPS), dtype=torch.bool, device=dev)
    flags = torch.zeros((f,), dtype=torch.bool, device=dev)
    fresh = fresh_nodes()
    fn = cuda.function(
        "raft_step", "sr_raft_step",
        [cuda.P, cuda.I64, cuda.I32, cuda.U64, cuda.U64, cuda.U64, cuda.P,
         cuda.P, cuda.P, cuda.P, cuda.P],
    )
    raft_step.launches += 1
    code = fn(
        cuda.ptr(states), f, max_crashes, *fresh, cuda.ptr(nexts),
        cuda.ptr(valid), cuda.ptr(conds), cuda.ptr(flags), cuda.stream(nexts),
    )
    cuda.check(code, "raft_step", "raft_step")
    return nexts, valid, conds, flags if flag_rows else flags.any()


raft_step.launches = 0
