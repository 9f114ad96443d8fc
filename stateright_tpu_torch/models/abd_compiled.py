"""Bit-packed device form of the ABD quorum register (kernel K10).

The counterpart of ``stateright_tpu/models/abd_compiled.py``: the second
register-harness protocol with servers of real state, on both of the
reference's fabrics -- the unordered nonduplicating multiset (sorted
slots) and the ordered per-(src, dst) FIFO network (one word per queue
position, head-only delivery; src/actor/network.rs:60-68).  Word layout
(C <= 3 clients, S = 2 servers), identical to the JAX codec's:

- words 0..1: one 29-bit server record each -- seq code (4 bits: clock*S
  + id, whose numeric order is the (clock, id) order), value (2), phase
  kind (2: none, phase1, phase2), request code (3: client | is_get << 2;
  the requester and Phase1's write derive from it), per-server Phase1
  responses (presence 1 + seq 4 + value 2), Phase2's read value (2) and
  acks bitmap (2);
- word 2: the shared client word (``register_compiled_common.py``);
- words 3..3+m: the network -- unordered, m = 6 sorted nonzero envelope
  codes, then zeros; ordered, m = 4C + 6 words, a FIFO lane per directed
  pair that can carry traffic (:func:`fifo_pairs`), each message at its
  queue position;
- last C words: the tester words, from ``tst0 = 3 + m``.

Envelope code = 1 + (tag << 18 | addr << 14 | payload).

Device function: :func:`abd_step` (K10, ``csrc/abd_step.cu``) is the JAX
``step`` -- one Deliver lane per slot (unordered) or per FIFO pair
(ordered), its successor, validity and overflow flag -- fused with
``property_conds`` (linearizable, through the DP of
``csrc/register_lin.cuh`` at ``tst0``, and value chosen) on a CUDA tensor;
:func:`abd_step_plain` is its plain-torch twin, run for CPU tensors.  The
twin computes in int64 masked to 32 bits (``ops/u32.py``) and reproduces
the JAX code's u32 wrap-around: ``code - 1`` on an empty slot or head,
field inserts that are not masked to their width, and value codes such
as ``rid + 1``.  The engine expands it in one phase, as it does 2pc.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..actor import Envelope, Id, Network
from ..actor.model import ActorModelState
from ..actor.register import Get, GetOk, Internal, Put, PutOk
from ..ops import cuda
from ..ops.u32 import M32, i32, shl32, u32
from ..parallel.compiled import CompiledModel, fused_conds, override_conds
from ..semantics import LinearizabilityTester, Register
from .abd import (
    NULL_VALUE,
    AbdState,
    AckQuery,
    AckRecord,
    Phase1,
    Phase2,
    Query,
    Record,
)
from .register_compiled_common import (
    RegisterClientCodec,
    client_record,
    decode_slot_counts,
    device_linearizable_plain,
    getok_transition,
    putok_transition,
    resort_slots,
    tester_word,
)

S = 2  # servers (the golden configuration; majority = 2 = all)
MAX_CLIENTS = 3  # the widest the 29-bit server record carries
MAX_CLOCK = 7  # 4-bit seq code = clock*S + id
NET_SLOTS = 6  # unordered; the in-flight peak at C = 2 is 2
N_PROPS = 2  # linearizable, value chosen
_NET0 = S + 1

_T_PUT, _T_GET, _T_PUTOK, _T_GETOK = 0, 1, 2, 3
_T_QUERY, _T_ACKQUERY, _T_RECORD, _T_ACKRECORD = 4, 5, 6, 7

# server-record fields (offset, width) in one word
_F_SEQ = (0, 4)
_F_VAL = (4, 2)
_F_KIND = (6, 2)  # 0 none, 1 phase1, 2 phase2
_F_RID = (8, 3)  # client (2b) | is_get (1b)
_RESP0 = 11  # per server: presence 1b, seq 4b, value 2b (7 bits)
_F_READ = (25, 2)
_ACKS0 = 27  # +sid, 1 bit each


def fifo_pairs(c: int) -> List[Tuple[int, int, int, int]]:
    """The ordered fabric's FIFO lanes at ``c`` clients, as ``(src, dst,
    depth, offset)``: each client's put channel (to ci % S) and get
    channel (to (ci + 1) % S), every server -> client reply channel, and
    the server peer channels.  Client-adjacent channels hold at most one
    message (a client has one operation outstanding); a peer channel can
    stack a reply behind an own-phase message, so it is three deep, and
    the step flags an overflow."""
    pairs = []
    for ci in range(c):
        pairs.append((S + ci, ci % S, 1))
        pairs.append((S + ci, (S + ci + 1) % S, 1))
    for s in range(S):
        for ci in range(c):
            pairs.append((s, S + ci, 1))
    for s in range(S):
        pairs.append((s, (s + 1) % S, 3))
    out, off = [], 0
    for src, dst, depth in pairs:
        out.append((src, dst, depth, off))
        off += depth
    return out


def net_words(c: int, ordered: bool) -> int:
    """m: the network section's words (4C + 6 ordered)."""
    return 4 * c + 6 if ordered else NET_SLOTS


def lane_count(c: int, ordered: bool) -> int:
    """A: one Deliver lane per slot, or per FIFO pair (4C + 2)."""
    return len(fifo_pairs(c)) if ordered else NET_SLOTS


def state_width(c: int, ordered: bool) -> int:
    return _NET0 + net_words(c, ordered) + c


def _codec(c: int, ordered: bool) -> RegisterClientCodec:
    """The client/tester section's layout at ``c`` clients."""
    if not 1 <= c <= MAX_CLIENTS:
        raise ValueError(
            f"packed ABD supports 1 to {MAX_CLIENTS} clients (got {c}): the "
            f"29-bit server record holds no more"
        )
    return RegisterClientCodec(S, c, S, _NET0 + net_words(c, ordered))


class AbdCompiled(CompiledModel):
    """Codec and fused device step for ``AbdModelCfg.into_model()``."""

    def __init__(self, model):
        self.model = model
        cfg = model.cfg
        if cfg.server_count != S:
            raise ValueError("packed ABD fixes server_count=2")
        fault = getattr(cfg, "fault", None)
        if fault not in (None, "skip_ack"):
            raise ValueError(f"unknown AbdActor fault: {fault!r}")
        kind = model.init_network.kind
        if kind not in ("unordered_nonduplicating", "ordered"):
            raise ValueError(
                "packed ABD supports the unordered_nonduplicating and "
                "ordered networks"
            )
        self.c = cfg.client_count
        self.ordered = kind == "ordered"
        self.skip_ack = fault == "skip_ack"
        self.rc = _codec(self.c, self.ordered)
        self.pairs = fifo_pairs(self.c) if self.ordered else None
        self.m = net_words(self.c, self.ordered)
        self.max_actions = lane_count(self.c, self.ordered)
        self.state_width = state_width(self.c, self.ordered)
        self.values = self.rc.values

    # --- small-code helpers ---------------------------------------------------

    def _seq_code(self, seq: Tuple[int, Id]) -> int:
        clock, sid = seq
        if clock > MAX_CLOCK:
            raise ValueError(f"seq clock {clock} exceeds MAX_CLOCK")
        return clock * S + int(sid)

    def _seq_of(self, code: int) -> Tuple[int, Id]:
        return (code // S, Id(code % S))

    def _rid_code(self, request_id: int) -> int:
        """client (2b) | is_get (1b); Put req = S+ci, Get req = 2*(S+ci)."""
        for ci in range(self.c):
            if request_id == S + ci:
                return ci
            if request_id == 2 * (S + ci):
                return ci | 4
        raise ValueError(f"unknown request id {request_id}")

    def _rid_of(self, code: int) -> Tuple[int, int, bool]:
        """-> (request_id, client index, is_get)."""
        ci, is_get = code & 3, bool(code & 4)
        rid = 2 * (S + ci) if is_get else S + ci
        return rid, ci, is_get

    # --- server record --------------------------------------------------------

    def _encode_server(self, st: AbdState) -> int:
        rc = self.rc
        bits = self._seq_code(st.seq)
        bits |= rc.value_code(st.val, NULL_VALUE) << _F_VAL[0]
        ph = st.phase
        if isinstance(ph, Phase1):
            code = self._rid_code(ph.request_id)
            bits |= 1 << _F_KIND[0]
            bits |= code << _F_RID[0]
            assert int(ph.requester_id) == S + (code & 3)
            assert ph.write == (None if code & 4 else self.values[code & 3])
            for sid, (sq, v) in ph.responses:
                off = _RESP0 + 7 * int(sid)
                bits |= 1 << off
                bits |= self._seq_code(sq) << (off + 1)
                bits |= rc.value_code(v, NULL_VALUE) << (off + 5)
        elif isinstance(ph, Phase2):
            code = self._rid_code(ph.request_id)
            bits |= 2 << _F_KIND[0]
            bits |= code << _F_RID[0]
            assert int(ph.requester_id) == S + (code & 3)
            if code & 4:
                bits |= rc.value_code(ph.read, NULL_VALUE) << _F_READ[0]
            else:
                assert ph.read is None
            for sid in ph.acks:
                bits |= 1 << (_ACKS0 + int(sid))
        else:
            assert ph is None
        return bits

    def _decode_server(self, bits: int) -> AbdState:
        rc = self.rc
        seq = self._seq_of(bits & 0xF)
        val = rc.value_of((bits >> _F_VAL[0]) & 3, NULL_VALUE)
        kind = (bits >> _F_KIND[0]) & 3
        if kind == 0:
            return AbdState(seq=seq, val=val, phase=None)
        rid, ci, is_get = self._rid_of((bits >> _F_RID[0]) & 7)
        if kind == 1:
            responses = []
            for sid in range(S):
                off = _RESP0 + 7 * sid
                if (bits >> off) & 1:
                    responses.append((
                        Id(sid),
                        (
                            self._seq_of((bits >> (off + 1)) & 0xF),
                            rc.value_of((bits >> (off + 5)) & 3, NULL_VALUE),
                        ),
                    ))
            phase = Phase1(
                request_id=rid,
                requester_id=Id(S + ci),
                write=None if is_get else self.values[ci],
                responses=tuple(responses),
            )
        else:
            phase = Phase2(
                request_id=rid,
                requester_id=Id(S + ci),
                read=(
                    rc.value_of((bits >> _F_READ[0]) & 3, NULL_VALUE)
                    if is_get else None
                ),
                acks=frozenset(
                    Id(sid) for sid in range(S) if (bits >> (_ACKS0 + sid)) & 1
                ),
            )
        return AbdState(seq=seq, val=val, phase=phase)

    # --- envelope codes -------------------------------------------------------

    def _env_code(self, env: Envelope) -> int:
        rc = self.rc
        msg = env.msg
        src, dst = int(env.src), int(env.dst)
        if isinstance(msg, Put):
            ci = src - S
            assert msg == Put(S + ci, self.values[ci]) and dst == ci % S
            code = (_T_PUT, ci, 0)
        elif isinstance(msg, Get):
            ci = src - S
            assert msg.request_id == 2 * (S + ci) and dst == (S + ci + 1) % S
            code = (_T_GET, ci, 0)
        elif isinstance(msg, PutOk):
            ci = dst - S
            assert msg.request_id == S + ci
            code = (_T_PUTOK, src * 4 + ci, 0)
        elif isinstance(msg, GetOk):
            ci = dst - S
            assert msg.request_id == 2 * (S + ci)
            code = (_T_GETOK, src * 4 + ci, rc.value_code(msg.value, NULL_VALUE))
        elif isinstance(msg, Internal):
            inner = msg.msg
            addr = src * 4 + dst
            if isinstance(inner, Query):
                code = (_T_QUERY, addr, self._rid_code(inner.request_id))
            elif isinstance(inner, (AckQuery, Record)):
                code = (
                    _T_ACKQUERY if isinstance(inner, AckQuery) else _T_RECORD,
                    addr,
                    self._rid_code(inner.request_id)
                    | (self._seq_code(inner.seq) << 3)
                    | (rc.value_code(inner.value, NULL_VALUE) << 7),
                )
            elif isinstance(inner, AckRecord):
                code = (_T_ACKRECORD, addr, self._rid_code(inner.request_id))
            else:
                raise ValueError(f"unknown internal message {inner!r}")
        else:
            raise ValueError(f"unknown message {msg!r}")
        tag, addr, payload = code
        assert addr < 16 and payload < (1 << 14), (addr, payload)
        return 1 + ((tag << 18) | (addr << 14) | payload)

    def _env_of(self, code: int) -> Envelope:
        rc = self.rc
        code -= 1
        tag = code >> 18
        addr = (code >> 14) & 0xF
        payload = code & 0x3FFF
        if tag == _T_PUT:
            ci = addr
            return Envelope(Id(S + ci), Id(ci % S), Put(S + ci, self.values[ci]))
        if tag == _T_GET:
            ci = addr
            return Envelope(Id(S + ci), Id((S + ci + 1) % S), Get(2 * (S + ci)))
        if tag == _T_PUTOK:
            src, ci = addr // 4, addr % 4
            return Envelope(Id(src), Id(S + ci), PutOk(S + ci))
        if tag == _T_GETOK:
            src, ci = addr // 4, addr % 4
            return Envelope(
                Id(src), Id(S + ci),
                GetOk(2 * (S + ci), rc.value_of(payload, NULL_VALUE)),
            )
        src, dst = Id(addr // 4), Id(addr % 4)
        rid, _ci, _g = self._rid_of(payload & 7)
        if tag == _T_QUERY:
            return Envelope(src, dst, Internal(Query(rid)))
        if tag in (_T_ACKQUERY, _T_RECORD):
            cls = AckQuery if tag == _T_ACKQUERY else Record
            return Envelope(src, dst, Internal(cls(
                rid,
                self._seq_of((payload >> 3) & 0xF),
                rc.value_of((payload >> 7) & 3, NULL_VALUE),
            )))
        if tag == _T_ACKRECORD:
            return Envelope(src, dst, Internal(AckRecord(rid)))
        raise ValueError(f"bad envelope code {code}")

    # --- full state -----------------------------------------------------------

    def encode(self, st: ActorModelState) -> np.ndarray:
        words = np.zeros(self.state_width, dtype=np.uint32)
        for i in range(S):
            words[i] = self._encode_server(st.actor_states[i])
        words[S] = self.rc.encode_clients(st.actor_states)
        if self.ordered:
            index = {(src, dst): (depth, off) for src, dst, depth, off in self.pairs}
            for (src, dst), msgs in st.network.flows:
                key = (int(src), int(dst))
                if key not in index:
                    raise ValueError(f"no FIFO lane for flow {key}")
                depth, off = index[key]
                if len(msgs) > depth:
                    raise ValueError(
                        f"flow {key} holds {len(msgs)} messages; lane depth "
                        f"is {depth}"
                    )
                for j, msg in enumerate(msgs):
                    words[_NET0 + off + j] = self._env_code(Envelope(src, dst, msg))
        else:
            env_codes = []
            for env, count in sorted(
                st.network.counts, key=lambda ec: self._env_code(ec[0])
            ):
                # A duplicate in-flight send is a repeated code.
                env_codes.extend([self._env_code(env)] * count)
            if len(env_codes) > self.m:
                raise ValueError(
                    f"{len(env_codes)} in-flight envelopes exceed {self.m} slots"
                )
            for k, code in enumerate(env_codes):
                words[_NET0 + k] = code
        for i in range(self.c):
            words[self.rc.tst0 + i] = self.rc.encode_tester(st.history, i, NULL_VALUE)
        return words

    def decode(self, words: Sequence[int]) -> ActorModelState:
        servers = tuple(self._decode_server(int(words[i])) for i in range(S))
        clients = self.rc.decode_clients(int(words[S]))
        if self.ordered:
            flows = []
            for src, dst, depth, off in self.pairs:
                msgs = []
                for j in range(depth):
                    code = int(words[_NET0 + off + j])
                    if code:
                        env = self._env_of(code)
                        assert (int(env.src), int(env.dst)) == (src, dst)
                        msgs.append(env.msg)
                if msgs:
                    flows.append(((Id(src), Id(dst)), tuple(msgs)))
            network = Network(kind="ordered", flows=tuple(sorted(flows)))
        else:
            network = Network(
                kind="unordered_nonduplicating",
                counts=decode_slot_counts(words, _NET0, self.m, self._env_of),
            )
        tester = LinearizabilityTester(Register(NULL_VALUE))
        for i in range(self.c):
            self.rc.decode_tester_into(
                tester, int(words[self.rc.tst0 + i]), i, NULL_VALUE
            )
        n = S + self.c
        return ActorModelState(
            actor_states=servers + tuple(clients),
            network=network,
            timers_set=(frozenset(),) * n,
            random_choices=((),) * n,
            crashed=(False,) * n,
            history=tester,
            actor_storages=(None,) * n,
        )

    # --- device side ----------------------------------------------------------

    def step(self, states):
        nexts, valid, _conds, _flag = abd_step(
            states, self.c, self.ordered, self.skip_ack)
        return nexts, valid

    def property_conds(self, states):
        return abd_step(states, self.c, self.ordered, self.skip_ack)[2]

    def expand(self, states):
        nexts, valid, conds, flag = abd_step(
            states, self.c, self.ordered, self.skip_ack)
        if not fused_conds(self, AbdCompiled):
            conds = self.property_conds(states)
        return nexts, valid, conds, flag

    def walk_step(self, states, plain=False):
        fn = abd_step_plain if plain else abd_step
        nexts, valid, conds, flags = fn(
            states, self.c, self.ordered, self.skip_ack, flag_rows=True)
        if not fused_conds(self, AbdCompiled):
            conds = override_conds(self, states, plain)
        return nexts, valid, conds, flags


# --- the plain-torch twin ------------------------------------------------------


def _mk(tag: int, addr, payload):
    """The envelope code of (tag, addr, payload) in u32, unmasked fields
    spilling as they do there."""
    return (1 + ((tag << 18) | shl32(addr & M32, 14) | (payload & M32))) & M32


def _ext(bits, off: int, width: int):
    return (bits >> off) & ((1 << width) - 1)


def _ins(bits, off: int, width: int, val):
    """``bits`` with field (off, width) replaced by ``val`` -- shifted in
    u32 and NOT masked to the width, as in JAX: a wide value spills into
    the fields above."""
    keep = ~(((1 << width) - 1) << off) & M32
    v = shl32(val.long(), off) if isinstance(val, torch.Tensor) else (val << off) & M32
    return (bits & keep) | v


def _sel(tag, pairs, default):
    out = default
    for t, v in pairs.items():
        out = torch.where(tag == t, v, out)
    return out


def _handle(rc: RegisterClientCodec, skip_ack: bool, row, code, occupied):
    """The message handler of one envelope code a lane, mirroring
    ``AbdActor.on_msg`` and the register clients (the JAX ``_handle``):
    ``row`` int64[F, 1, W], ``code`` int64[F, A], ``occupied`` bool[F, A]
    -> ``(valid, dsrv, srv_new, cli_f, tw_f, s0, branch_flag, ci)``, each
    [F, A]; ``s0`` (the one send) is 0 on an invalid lane."""
    c = rc.c
    e = (code - 1) & M32
    tag = e >> 18
    addr = (e >> 14) & 0xF
    payload = e & 0x3FFF
    i_src = addr >> 2
    i_dst = addr & 3
    false = torch.zeros_like(occupied)

    # The destination server a tag: a client's put to ci % 2, its get to
    # (ci + 1) % 2, an internal message to its address.
    dsrv = torch.where(
        tag == _T_PUT, addr % S, torch.where(tag == _T_GET, (addr + 1) % S, i_dst)
    )
    rec = torch.where(dsrv == 0, row[..., 0], row[..., 1])
    seq = _ext(rec, *_F_SEQ)
    val = _ext(rec, *_F_VAL)
    kind = _ext(rec, *_F_KIND)
    rid = _ext(rec, *_F_RID)
    resp_p = [_ext(rec, _RESP0 + 7 * s, 1) for s in range(S)]
    resp_seq = [_ext(rec, _RESP0 + 7 * s + 1, 4) for s in range(S)]
    resp_val = [_ext(rec, _RESP0 + 7 * s + 5, 2) for s in range(S)]
    read_v = _ext(rec, *_F_READ)
    ack_b = [_ext(rec, _ACKS0 + s, 1) for s in range(S)]
    me = dsrv
    peer = (dsrv + 1) % S

    # Put / Get to an idle server: broadcast a Query, enter phase 1.
    pg_ci = addr
    pg_is_get = tag == _T_GET
    pg_guard = kind == 0
    pg_rid = pg_ci | torch.where(pg_is_get, 4, 0)
    prec = _ins(rec, *_F_KIND, 1)
    prec = _ins(prec, *_F_RID, pg_rid)
    for s in range(S):
        mine = me == s
        prec = _ins(prec, _RESP0 + 7 * s, 1, mine)
        prec = _ins(prec, _RESP0 + 7 * s + 1, 4, torch.where(mine, seq, 0))
        prec = _ins(prec, _RESP0 + 7 * s + 5, 2, torch.where(mine, val, 0))
    prec = _ins(prec, *_F_READ, 0)
    for s in range(S):
        prec = _ins(prec, _ACKS0 + s, 1, 0)
    pg_s0 = _mk(_T_QUERY, me * 4 + peer, pg_rid)
    pg_flag = false
    if skip_ack:
        # The broken replica answers at once from local state, whatever
        # its phase; a put bumps the clock.
        pg_guard = occupied
        new_clock = seq // S + 1
        put_rec = _ins(rec, *_F_SEQ, new_clock * S + me)
        put_rec = _ins(put_rec, *_F_VAL, pg_ci + 1)  # values[ci]'s code
        prec = torch.where(pg_is_get, rec, put_rec)
        pg_s0 = torch.where(
            pg_is_get,
            _mk(_T_GETOK, me * 4 + pg_ci, val),
            _mk(_T_PUTOK, me * 4 + pg_ci, torch.zeros_like(val)),
        )
        pg_flag = ~pg_is_get & (new_clock > MAX_CLOCK)

    # Query: answered with (seq, val), the state unchanged.
    q_s0 = _mk(_T_ACKQUERY, i_dst * 4 + i_src, payload | (seq << 3) | (val << 7))

    # AckQuery: record the response; with S = 2 the peer's completes the
    # quorum, whose max-seq response is written back (a write's with the
    # next clock) and broadcast as a Record.
    aq_rid = payload & 7
    aq_seq = (payload >> 3) & 0xF
    aq_val = (payload >> 7) & 3
    aq_guard = (kind == 1) & (aq_rid == rid)
    n_resp = [torch.where(i_src == s, 1, resp_p[s]) for s in range(S)]
    n_rseq = [torch.where(i_src == s, aq_seq, resp_seq[s]) for s in range(S)]
    n_rval = [torch.where(i_src == s, aq_val, resp_val[s]) for s in range(S)]
    aq_trigger = (n_resp[0] + n_resp[1]) == 2
    best_is_1 = (n_resp[1] == 1) & ((n_resp[0] == 0) | (n_rseq[1] > n_rseq[0]))
    max_seq = torch.where(best_is_1, n_rseq[1], n_rseq[0])
    max_val = torch.where(best_is_1, n_rval[1], n_rval[0])
    is_write = (rid & 4) == 0
    wclock = max_seq // S + 1
    aq_flag = aq_guard & aq_trigger & is_write & (wclock > MAX_CLOCK)
    rec_seq = torch.where(is_write, wclock * S + me, max_seq)
    rec_val = torch.where(is_write, rid + 1, max_val)  # values[ci]'s code
    adopt = rec_seq > seq
    arec = _ins(rec, *_F_SEQ, torch.where(adopt, rec_seq, seq))
    arec = _ins(arec, *_F_VAL, torch.where(adopt, rec_val, val))
    arec = _ins(arec, *_F_KIND, 2)
    arec = _ins(arec, *_F_READ, torch.where(is_write, 0, max_val))
    for s in range(S):
        arec = _ins(arec, _ACKS0 + s, 1, me == s)
        arec = _ins(arec, _RESP0 + 7 * s, 1, 0)
        arec = _ins(arec, _RESP0 + 7 * s + 1, 4, 0)
        arec = _ins(arec, _RESP0 + 7 * s + 5, 2, 0)
    nrec = rec
    for s in range(S):
        nrec = _ins(nrec, _RESP0 + 7 * s, 1, n_resp[s])
        nrec = _ins(nrec, _RESP0 + 7 * s + 1, 4, n_rseq[s])
        nrec = _ins(nrec, _RESP0 + 7 * s + 5, 2, n_rval[s])
    aq_rec = torch.where(aq_trigger, arec, nrec)
    aq_s0 = torch.where(
        aq_trigger,
        _mk(_T_RECORD, me * 4 + peer, rid | (rec_seq << 3) | (rec_val << 7)),
        0,
    )

    # Record: adopt a newer (seq, val), answer AckRecord.
    r_seq = (payload >> 3) & 0xF
    r_val = (payload >> 7) & 3
    r_adopt = r_seq > seq
    rrec = _ins(rec, *_F_SEQ, torch.where(r_adopt, r_seq, seq))
    rrec = _ins(rrec, *_F_VAL, torch.where(r_adopt, r_val, val))
    r_s0 = _mk(_T_ACKRECORD, i_dst * 4 + i_src, payload & 7)

    # AckRecord from a server not yet in the acks: on the quorum, reply to
    # the requester and clear the phase.
    ar_guard = (
        (kind == 2) & ((payload & 7) == rid)
        & (torch.where(i_src == 0, ack_b[0], ack_b[1]) == 0)
    )
    n_acks = [torch.where(i_src == s, 1, ack_b[s]) for s in range(S)]
    ar_trigger = (n_acks[0] + n_acks[1]) == 2
    ar_ci = rid & 3
    crec = _ins(rec, *_F_KIND, 0)
    crec = _ins(crec, *_F_RID, 0)
    crec = _ins(crec, *_F_READ, 0)
    for s in range(S):
        crec = _ins(crec, _ACKS0 + s, 1, 0)
    urec = rec
    for s in range(S):
        urec = _ins(urec, _ACKS0 + s, 1, n_acks[s])
    ar_rec = torch.where(ar_trigger, crec, urec)
    ar_s0 = torch.where(
        ar_trigger,
        torch.where(
            (rid & 4) != 0,
            _mk(_T_GETOK, me * 4 + ar_ci, read_v),
            _mk(_T_PUTOK, me * 4 + ar_ci, torch.zeros_like(read_v)),
        ),
        0,
    )

    # PutOk / GetOk to a client (the shared register-harness transitions).
    ci, cli, ckind, _opc = client_record(rc, row, i_dst)
    tw = tester_word(rc, row, ci)
    to_client = i_dst < c
    cli_putok, tw_putok = putok_transition(rc, row, ci, cli, tw)
    putok_s0 = _mk(_T_GET, ci, torch.zeros_like(ci))
    cli_getok, tw_getok = getok_transition(rc, ci, cli, tw, payload)

    valid = occupied & _sel(tag, {
        _T_PUT: pg_guard, _T_GET: pg_guard, _T_QUERY: occupied,
        _T_ACKQUERY: aq_guard, _T_RECORD: occupied, _T_ACKRECORD: ar_guard,
        _T_PUTOK: (ckind == 1) & to_client, _T_GETOK: (ckind == 2) & to_client,
    }, false)
    srv_new = _sel(tag, {
        _T_PUT: prec, _T_GET: prec, _T_ACKQUERY: aq_rec, _T_RECORD: rrec,
        _T_ACKRECORD: ar_rec,
    }, rec)
    cli_f = _sel(tag, {_T_PUTOK: cli_putok, _T_GETOK: cli_getok}, cli.expand_as(ci))
    tw_f = _sel(tag, {_T_PUTOK: tw_putok, _T_GETOK: tw_getok}, tw)
    s0 = _sel(tag, {
        _T_PUT: pg_s0, _T_GET: pg_s0, _T_QUERY: q_s0, _T_ACKQUERY: aq_s0,
        _T_RECORD: r_s0, _T_ACKRECORD: ar_s0, _T_PUTOK: putok_s0,
    }, torch.zeros_like(code))
    branch_flag = _sel(tag, {_T_ACKQUERY: aq_flag, _T_PUT: pg_flag}, false)
    s0 = torch.where(valid, s0, 0)
    return valid, dsrv, srv_new, cli_f, tw_f, s0, branch_flag, ci


def _route(c: int, s0):
    """The FIFO pair a send travels on, from its tag and address (a
    client's get channel leads to (ci + 1) % S), or ``len(fifo_pairs(c))``
    where none does."""
    pairs = fifo_pairs(c)
    es = (s0 - 1) & M32
    t_tag = es >> 18
    t_addr = (es >> 14) & 0xF
    srv_src, srv_dst = t_addr >> 2, t_addr & 3
    is_reply = (t_tag == _T_PUTOK) | (t_tag == _T_GETOK)
    is_get = t_tag == _T_GET
    t_src = torch.where(is_get, S + t_addr, srv_src)
    t_dst = torch.where(
        is_reply, S + srv_dst, torch.where(is_get, (t_addr + S + 1) % S, srv_dst)
    )
    t_pair = torch.full_like(s0, len(pairs))
    for idx, (src, dst, _depth, _off) in enumerate(pairs):
        t_pair = torch.where((t_src == src) & (t_dst == dst), idx, t_pair)
    return t_pair


def abd_lanes_plain(states: torch.Tensor, c: int, ordered: bool, skip_ack: bool):
    """Every Deliver lane of packed ABD rows, as the JAX ``_deliver_lane``
    or ``_deliver_lane_ordered`` builds it: ``int32[F, W] -> (nexts
    int32[F, A, W], valid bool[F, A], flags bool[F, A])``.  Every lane's
    words are the JAX lane's, valid or not; a lane's flag marks a send
    that does not fit (or, ordered, has no lane) or a clock past
    ``MAX_CLOCK``."""
    rc = _codec(c, ordered)
    m = net_words(c, ordered)
    st = u32(states)
    f = st.shape[0]
    row = st[:, None, :]  # per-state fields broadcast over the lanes
    net = st[:, _NET0 : _NET0 + m]
    if ordered:
        pairs = fifo_pairs(c)
        a = len(pairs)
        code = torch.stack([net[:, off] for _s, _d, _dp, off in pairs], dim=1)
        occupied = code != 0
        (hv, dsrv, srv_new, cli_f, tw_f, s0, branch_flag, ci) = _handle(
            rc, skip_ack, row, code, occupied
        )
        # A no-op delivery still consumes the head and is a successor: the
        # lane is valid whenever the head is occupied, with the handler's
        # effects masked out where its guard failed.
        valid = occupied
        srv_new = torch.where(
            hv, srv_new, torch.where(dsrv == 0, row[..., 0], row[..., 1])
        )
        cli_f = torch.where(hv, cli_f, row[..., S])
        tw_f = torch.where(hv, tw_f, tester_word(rc, row, ci))
        t_pair = _route(c, s0)
        has_send = s0 != 0
        k = torch.arange(a, device=st.device)[None, :]
        words = []
        overflow = torch.zeros_like(valid)
        for idx, (_src, _dst, depth, off) in enumerate(pairs):
            delivered = k == idx
            shifted = [
                torch.where(
                    delivered,
                    row[..., _NET0 + off + j + 1] if j + 1 < depth else 0,
                    row[..., _NET0 + off + j],
                ).expand(f, a)
                for j in range(depth)
            ]
            target = has_send & (t_pair == idx)
            ln = sum((w != 0).long() for w in shifted)
            shifted = [
                torch.where(target & (ln == j), s0, w) for j, w in enumerate(shifted)
            ]
            overflow = overflow | (target & (ln == depth))
            words.extend(shifted)
        new_net = torch.stack(words, dim=-1)
        flags = (branch_flag & hv) | overflow | (has_send & (t_pair == a))
    else:
        a = m
        k = torch.arange(m, device=st.device)[None, :]
        prev = torch.cat([torch.zeros_like(net[:, :1]), net[:, :-1]], dim=1)
        # Only the first slot of a run of equal codes is a lane.
        occupied = (net != 0) & ((k == 0) | (prev != net))
        (valid, dsrv, srv_new, cli_f, tw_f, s0, branch_flag, ci) = _handle(
            rc, skip_ack, row, net, occupied
        )
        new_net, overflow = resort_slots(
            net[:, None, :].expand(f, m, m).reshape(f * m, m),
            k.expand(f, m).reshape(f * m),
            s0.reshape(f * m, 1),
            valid.reshape(f * m),
        )
        new_net = new_net.view(f, m, m)
        flags = (branch_flag & valid) | overflow.view(f, m)
    head = [torch.where(dsrv == s, srv_new, row[..., s]) for s in range(S)]
    tail = [torch.where(ci == j, tw_f, row[..., rc.tst0 + j]) for j in range(c)]
    nexts = torch.cat(
        [torch.stack(head + [cli_f], dim=-1), new_net, torch.stack(tail, dim=-1)],
        dim=-1,
    )
    return i32(nexts), valid, flags


def abd_conds_plain(states: torch.Tensor, c: int, ordered: bool) -> torch.Tensor:
    """The JAX ``property_conds``: ``int32[F, W] -> bool[F, 2]``,
    linearizable (the DP at ``tst0``) and value chosen (a GetOk with a
    non-null value in any network word -- on the ordered fabric, queued
    behind a head too, as the JAX function reads them)."""
    rc = _codec(c, ordered)
    st = u32(states)
    net = st[:, _NET0 : _NET0 + net_words(c, ordered)]
    e = (net - 1) & M32
    getok = (net != 0) & ((e >> 18) == _T_GETOK)
    chosen = (getok & ((e & 0x3FFF) != 0)).any(dim=1)
    return torch.stack([device_linearizable_plain(rc, st), chosen], dim=1)


def abd_step_plain(
    states: torch.Tensor, c: int, ordered: bool, skip_ack: bool,
    flag_rows: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-torch twin of the K10 kernel: ``int32[F, W] -> (nexts
    int32[F, A, W], valid bool[F, A], conds bool[F, 2], flag bool[])`` --
    :func:`abd_lanes_plain` with its flags OR-ed (the JAX ``step``'s
    ``any``) and :func:`abd_conds_plain`.  With ``flag_rows`` the flag is
    each state's, ``bool[F]``: the per-state flag of the JAX ``step``."""
    nexts, valid, flags = abd_lanes_plain(states, c, ordered, skip_ack)
    rows = flags.any(dim=1)
    return (nexts, valid, abd_conds_plain(states, c, ordered),
            rows if flag_rows else rows.any())


# --- the kernel's wrapper ----------------------------------------------------


def abd_step(states: torch.Tensor, c: int, ordered: bool, skip_ack: bool,
             flag_rows: bool = False):
    """Every Deliver lane's successor and the property conditions of packed
    ABD rows, fused (K10): see :func:`abd_step_plain`."""
    if states.device.type == "cpu":
        return abd_step_plain(states, c, ordered, skip_ack, flag_rows)
    _codec(c, ordered)
    dev = states.device
    cuda.require(states, "states", torch.int32, 2, dev)
    w, a = state_width(c, ordered), lane_count(c, ordered)
    if states.shape[1] != w:
        raise ValueError(
            f"states must be [F, {w}] at c={c}, ordered={ordered}, got "
            f"{tuple(states.shape)}"
        )
    f = states.shape[0]
    nexts = torch.empty((f, a, w), dtype=torch.int32, device=dev)
    valid = torch.empty((f, a), dtype=torch.bool, device=dev)
    conds = torch.empty((f, N_PROPS), dtype=torch.bool, device=dev)
    flags = torch.empty((f,), dtype=torch.bool, device=dev)
    fn = cuda.function(
        "abd_step", "sr_abd_step",
        [cuda.P, cuda.I64, cuda.I32, cuda.I32, cuda.I32, cuda.P, cuda.P,
         cuda.P, cuda.P, cuda.P],
    )
    abd_step.launches += 1
    code = fn(
        cuda.ptr(states), f, c, int(ordered), int(skip_ack), cuda.ptr(nexts),
        cuda.ptr(valid), cuda.ptr(conds), cuda.ptr(flags), cuda.stream(nexts),
    )
    cuda.check(code, "abd_step", "abd_step")
    return nexts, valid, conds, flags if flag_rows else flags.any()


abd_step.launches = 0
