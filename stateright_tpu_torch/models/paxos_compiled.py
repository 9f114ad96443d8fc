"""Bit-packed device form of the paxos workload (kernels K5, K6, K7).

The counterpart of ``stateright_tpu/models/paxos_compiled.py``: an
injective packed encoding of the whole ``ActorModelState`` -- three
PaxosState server records, C scripted register clients, the
nonduplicating network as sorted envelope-code slots, and the
LinearizabilityTester history -- and the device functions of two-phase
expansion over it.  Word layout (C = 1..7 clients, S=3 servers, M = 16
slots for C <= 2, 32 for C = 3 and 64 from C = 4), identical to the JAX
codec's:

- words 0..5: three server records of 49 + PB bits, 2 words each: ballot
  code (6 bits, round*3 + leader) | proposal (PB = max(2, bit_length(C))
  bits) | 3 prepare entries (1 + 9 each) | 3 accept bits | accepted (9) |
  decided (1) -- the fields after the proposal sit a bit higher from
  C = 4 (:func:`paxos_fields`);
- word 6: client records, 4 bits each (awaiting kind 2b + op_count 2b);
- words 7..7+M: network slots -- sorted nonzero envelope codes, then
  zeros; a duplicate envelope is a repeated code;
- last C words: per-client tester records.

Device functions, each a hand-written CUDA kernel on a CUDA tensor and
its plain-torch twin on a CPU tensor:

- :func:`paxos_step_valid` (K5, ``csrc/paxos_valid.cu``): the validity of
  every Deliver lane (one per slot), without building successors -- the
  JAX ``step_valid``;
- :func:`paxos_step_lane` (K7, ``csrc/paxos_lane.cu``): the successor of
  each compacted valid lane, gathered from the wave's rows by its flat
  lane index -- the JAX ``step_lane``/``_deliver_lane`` plus the engine's
  parent-row gather;
- :func:`paxos_conds` (K6, ``csrc/paxos_conds.cu``): the property
  conditions -- linearizable (the DP of ``csrc/register_lin.cuh``), value
  chosen, and never decided when the model has it;
- :func:`paxos_step` (K14, ``csrc/paxos_step.cu``): the single-phase step
  of a model whose ``max_round`` is below the encoding's cap -- every
  lane's successor, its validity ANDed with the ballot-round boundary of
  the successor (the JAX ``step`` and ``boundary``), and the wave's
  encoding-overflow flag.  A bounded model is expanded in one phase (the
  boundary tests the successor, which the validity screen does not
  build); at the cap the model is unbounded and two-phase, as before.

The twins compute in int64 masked to 32 bits (``ops/u32.py``) and
reproduce the JAX code's u32 wrap-around: ``code - 1`` on an empty slot,
``(accepted - 1) % c`` at accepted 0, ``prop - 1`` on the flagged
branches, and the unsigned order of the slot re-sort, whose empty-slot
sentinel is ``0xFFFFFFFF``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..actor import Envelope, Id, Network
from ..actor.model import ActorModelState
from ..actor.register import Get, GetOk, Internal, Put, PutOk
from ..ops import cuda
from ..ops.u32 import M32, i32, shl32, u32
from ..parallel.compiled import CompiledModel
from ..semantics import LinearizabilityTester, Register
from .paxos import (
    Accept,
    Accepted,
    Decided,
    NULL_VALUE,
    PaxosState,
    Prepare,
    Prepared,
)
from .register_compiled_common import (
    RegisterClientCodec,
    client_record,
    decode_slot_counts,
    device_linearizable_plain,
    envelope_code,
    envelope_fields,
    getok_transition,
    putok_transition,
    resort_slots,
    tester_word,
)

S = 3  # servers (the golden configurations fix three)
MAX_ROUND = 15  # 4 bits of ballot round
MAX_CLIENTS = 7  # the register harness's cap (tester word, client nibbles)

# Message tags of envelope codes.
_T_PUT, _T_GET, _T_PUTOK, _T_GETOK = 0, 1, 2, 3
_T_PREPARE, _T_PREPARED, _T_ACCEPT, _T_ACCEPTED, _T_DECIDED = 4, 5, 6, 7, 8

# Accepted codes are 1 + ballot_code*C + proposal_idx <= 1 + 47*7 + 6 < 512.
_ACC_BITS = 9
_F_BALLOT = (0, 6)
_PW = 1 + _ACC_BITS  # one prepare entry: present bit + accepted code
_NET0 = 2 * S + 1
_CLI = 2 * S


class PaxosFields(NamedTuple):
    """Server-record fields after the ballot, (offset, width) over a
    record's (lo, hi) word pair, or the offset alone."""

    prop: Tuple[int, int]
    prep0: int  # first prepare entry
    accepts: int  # first accept bit
    accepted: Tuple[int, int]
    decided: Tuple[int, int]


def paxos_fields(c: int) -> PaxosFields:
    """The record fields at ``c`` clients: the proposal code (0..C) takes
    ``max(2, bit_length(C))`` bits, and every field after it moves with it
    (the JAX codec's ``pb``; ``csrc/paxos_common.cuh`` mirrors these)."""
    pb = max(2, c.bit_length())
    prep0 = 6 + pb
    accepts = prep0 + S * _PW
    accepted = (accepts + S, _ACC_BITS)
    return PaxosFields((6, pb), prep0, accepts, accepted,
                       (accepted[0] + _ACC_BITS, 1))


def slot_count(c: int) -> int:
    """In-flight envelope slots: 16 for C <= 2, 32 for C = 3, 64 above
    (the JAX codec's budget; an overflow is flagged, never silent)."""
    return 16 if c <= 2 else (32 if c == 3 else 64)


def state_width(c: int) -> int:
    return 2 * S + 1 + slot_count(c) + c


class PaxosCompiled(CompiledModel):
    """Codec and two-phase device functions for
    ``PaxosModelCfg.into_model()``."""

    def __init__(self, model):
        self.model = model
        cfg = model.cfg
        if cfg.server_count != S:
            raise ValueError("packed paxos fixes server_count=3")
        if not 1 <= cfg.client_count <= MAX_CLIENTS:
            raise ValueError(
                f"packed paxos supports 1 to {MAX_CLIENTS} clients "
                f"(got {cfg.client_count}): the register harness's tester "
                f"word holds no more"
            )
        self.max_round = MAX_ROUND if cfg.max_round is None else int(cfg.max_round)
        if not 0 <= self.max_round <= MAX_ROUND:
            raise ValueError(
                f"max_round {self.max_round} outside 0..{MAX_ROUND} (the "
                "packed ballot round has 4 bits)"
            )
        if model.init_network.kind != "unordered_nonduplicating":
            raise ValueError("packed paxos needs the unordered_nonduplicating network")
        self.c = cfg.client_count
        self.never_decided = bool(cfg.never_decided)
        self.m = slot_count(self.c)
        self.pb = paxos_fields(self.c).prop[1]  # proposal-code bits
        self.state_width = state_width(self.c)
        self.max_actions = self.m  # one Deliver lane per slot
        self.rc = _codec(self.c)
        self.values = self.rc.values  # client i's put value
        # Proposal space: client i's put is (req_id=S+i, requester=S+i, v_i).
        self.proposals = tuple(
            (S + i, Id(S + i), self.values[i]) for i in range(self.c)
        )

    # --- the incremental store's spec identity (incr/) ---------------------

    def spec_constants(self):
        """The constants, declared (the wrapped actor model is no
        dataclass).  ``max_round`` is normalized (None -> MAX_ROUND), so an
        explicit cap at the encoding's limit hashes as the unbounded
        default it behaves as."""
        cfg = self.model.cfg
        return {
            "client_count": repr(cfg.client_count),
            "server_count": repr(cfg.server_count),
            "network": self.model.init_network.kind,
            "never_decided": repr(bool(cfg.never_decided)),
            "max_round": repr(self.max_round),
        }

    def spec_widens(self, old_constants: dict) -> bool:
        """Raising ``max_round`` only adds reachable states: every in-bound
        state keeps its row and transitions and the boundary admits a
        superset.  Every other constant must be unchanged."""
        return self.widens_by(old_constants, "max_round")

    # --- small-code helpers --------------------------------------------------

    def _value_code(self, v) -> int:
        return self.rc.value_code(v, NULL_VALUE)

    def _value_of(self, code: int):
        return self.rc.value_of(code, NULL_VALUE)

    def _proposal_code(self, p) -> int:
        """0 = None, else 1+index."""
        return 0 if p is None else 1 + self.proposals.index(tuple(p))

    def _proposal_of(self, code: int):
        return None if code == 0 else self.proposals[code - 1]

    def _ballot_code(self, b) -> int:
        r, leader = b
        if r > MAX_ROUND:
            raise ValueError(f"ballot round {r} exceeds MAX_ROUND")
        return r * S + int(leader)

    def _ballot_of(self, code: int) -> Tuple[int, Id]:
        return (code // S, Id(code % S))

    def _accepted_code(self, acc) -> int:
        """Option<(ballot, proposal)> -> 0 or 1 + ballot*C + proposal_idx."""
        if acc is None:
            return 0
        ballot, proposal = acc
        code = 1 + self._ballot_code(ballot) * self.c + self.proposals.index(
            tuple(proposal)
        )
        assert code < (1 << _ACC_BITS), code
        return code

    def _accepted_of(self, code: int):
        if code == 0:
            return None
        code -= 1
        return (
            self._ballot_of(code // self.c),
            self.proposals[code % self.c],
        )

    # --- server record (49 + pb bits in a u64 chunk) -------------------------

    def _encode_server(self, s: PaxosState) -> int:
        bits = self._ballot_code(s.ballot)  # 6 bits (rounds 0..15 * 3)
        assert bits < 64
        off = 6
        bits |= self._proposal_code(s.proposal) << off
        off += self.pb
        prepares = dict(s.prepares)
        for sid in range(S):
            if Id(sid) in prepares:
                bits |= 1 << off
                bits |= self._accepted_code(prepares[Id(sid)]) << (off + 1)
            off += 1 + _ACC_BITS
        for sid in range(S):
            if Id(sid) in s.accepts:
                bits |= 1 << off
            off += 1
        bits |= self._accepted_code(s.accepted) << off
        off += _ACC_BITS
        bits |= int(s.is_decided) << off
        off += 1
        assert off <= 64, off
        return bits

    def _decode_server(self, bits: int) -> PaxosState:
        ballot = self._ballot_of(bits & 0x3F)
        off = 6
        proposal = self._proposal_of((bits >> off) & ((1 << self.pb) - 1))
        off += self.pb
        prepares = []
        for sid in range(S):
            if (bits >> off) & 1:
                acc = self._accepted_of(
                    (bits >> (off + 1)) & ((1 << _ACC_BITS) - 1)
                )
                prepares.append((Id(sid), acc))
            off += 1 + _ACC_BITS
        accepts = frozenset(
            Id(sid) for sid in range(S) if (bits >> (off + sid)) & 1
        )
        off += S
        accepted = self._accepted_of((bits >> off) & ((1 << _ACC_BITS) - 1))
        off += _ACC_BITS
        is_decided = bool((bits >> off) & 1)
        return PaxosState(
            ballot=ballot,
            proposal=proposal,
            prepares=tuple(prepares),
            accepts=accepts,
            accepted=accepted,
            is_decided=is_decided,
        )

    # --- envelope codes ------------------------------------------------------

    def _env_code(self, env: Envelope) -> int:
        """tag(4 at bit 19) | addr(5 at bit 14, base-8 src/dst or client
        idx) | payload(14); nonzero overall (slot value 0 means empty, so
        add 1 at the end).  Base-8 addressing and the 512 multiplier in
        Prepared cover client counts up to the harness cap of 7."""
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
            code = (_T_PUTOK, src * 8 + ci, 0)
        elif isinstance(msg, GetOk):
            ci = dst - S
            assert msg.request_id == 2 * (S + ci)
            code = (_T_GETOK, src * 8 + ci, self._value_code(msg.value))
        elif isinstance(msg, Internal):
            inner = msg.msg
            if isinstance(inner, Prepare):
                assert int(inner.ballot[1]) == src
                self._ballot_code(inner.ballot)  # round bounds check
                code = (_T_PREPARE, src * 8 + dst, inner.ballot[0])
            elif isinstance(inner, Prepared):
                assert int(inner.ballot[1]) == dst
                self._ballot_code(inner.ballot)
                code = (
                    _T_PREPARED,
                    src * 8 + dst,
                    inner.ballot[0] * 512 + self._accepted_code(inner.last_accepted),
                )
            elif isinstance(inner, Accept):
                assert int(inner.ballot[1]) == src
                self._ballot_code(inner.ballot)
                code = (
                    _T_ACCEPT,
                    src * 8 + dst,
                    inner.ballot[0] * 8
                    + (self._proposal_code(inner.proposal) - 1),
                )
            elif isinstance(inner, Accepted):
                assert int(inner.ballot[1]) == dst
                self._ballot_code(inner.ballot)
                code = (_T_ACCEPTED, src * 8 + dst, inner.ballot[0])
            elif isinstance(inner, Decided):
                code = (
                    _T_DECIDED,
                    src * 8 + dst,
                    (self._ballot_code(inner.ballot) * 8)
                    + (self._proposal_code(inner.proposal) - 1),
                )
            else:
                raise ValueError(f"unknown internal message {inner!r}")
        else:
            raise ValueError(f"unknown message {msg!r}")
        tag, addr, payload = code
        assert addr < 32 and payload < (1 << 14), (addr, payload)
        return 1 + ((tag << 19) | (addr << 14) | payload)

    def _env_of(self, code: int) -> Envelope:
        code -= 1
        tag = code >> 19
        addr = (code >> 14) & 0x1F
        payload = code & 0x3FFF
        if tag == _T_PUT:
            ci = addr
            return Envelope(
                Id(S + ci), Id(ci % S), Put(S + ci, self.values[ci])
            )
        if tag == _T_GET:
            ci = addr
            return Envelope(Id(S + ci), Id((S + ci + 1) % S), Get(2 * (S + ci)))
        if tag == _T_PUTOK:
            src, ci = addr // 8, addr % 8
            return Envelope(Id(src), Id(S + ci), PutOk(S + ci))
        if tag == _T_GETOK:
            src, ci = addr // 8, addr % 8
            return Envelope(
                Id(src), Id(S + ci), GetOk(2 * (S + ci), self._value_of(payload))
            )
        src, dst = addr // 8, addr % 8
        if tag == _T_PREPARE:
            return Envelope(
                Id(src), Id(dst), Internal(Prepare((payload, Id(src))))
            )
        if tag == _T_PREPARED:
            return Envelope(
                Id(src),
                Id(dst),
                Internal(
                    Prepared((payload // 512, Id(dst)), self._accepted_of(payload % 512))
                ),
            )
        if tag == _T_ACCEPT:
            return Envelope(
                Id(src),
                Id(dst),
                Internal(
                    Accept(
                        (payload // 8, Id(src)),
                        self.proposals[payload % 8],
                    )
                ),
            )
        if tag == _T_ACCEPTED:
            return Envelope(
                Id(src), Id(dst), Internal(Accepted((payload, Id(dst))))
            )
        if tag == _T_DECIDED:
            return Envelope(
                Id(src),
                Id(dst),
                Internal(
                    Decided(
                        self._ballot_of(payload // 8),
                        self.proposals[payload % 8],
                    )
                ),
            )
        raise ValueError(f"bad envelope code {code}")

    # --- tester record (shared with all register-harness models) -------------

    def _encode_tester(self, h: LinearizabilityTester, me: int) -> int:
        return self.rc.encode_tester(h, me, NULL_VALUE)

    def _decode_tester_into(self, h: LinearizabilityTester, bits: int, me: int):
        self.rc.decode_tester_into(h, bits, me, NULL_VALUE)

    # --- full state ----------------------------------------------------------

    def encode(self, st: ActorModelState) -> np.ndarray:
        words = np.zeros(self.state_width, dtype=np.uint32)
        for i in range(S):
            bits = self._encode_server(st.actor_states[i])
            words[2 * i] = bits & 0xFFFFFFFF
            words[2 * i + 1] = bits >> 32
        words[2 * S] = self.rc.encode_clients(st.actor_states)
        env_codes = []
        for env, count in sorted(
            st.network.counts, key=lambda ec: self._env_code(ec[0])
        ):
            # Multiset counts > 1 are repeated codes, like the raft codec
            # — a duplicate in-flight send is data, not an engine error.
            env_codes.extend([self._env_code(env)] * count)
        if len(env_codes) > self.m:
            raise ValueError(
                f"{len(env_codes)} in-flight envelopes exceed {self.m} slots"
            )
        for k, code in enumerate(env_codes):
            words[2 * S + 1 + k] = code
        for i in range(self.c):
            words[2 * S + 1 + self.m + i] = self._encode_tester(
                st.history, i
            )
        return words

    def decode(self, words: Sequence[int]) -> ActorModelState:
        servers = tuple(
            self._decode_server(int(words[2 * i]) | (int(words[2 * i + 1]) << 32))
            for i in range(S)
        )
        clients = self.rc.decode_clients(int(words[2 * S]))
        network = Network(
            kind="unordered_nonduplicating",
            counts=decode_slot_counts(words, 2 * S + 1, self.m, self._env_of),
        )
        tester = LinearizabilityTester(Register(NULL_VALUE))
        for i in range(self.c):
            self._decode_tester_into(
                tester, int(words[2 * S + 1 + self.m + i]), i
            )
        n = S + self.c
        return ActorModelState(
            actor_states=tuple(servers) + tuple(clients),
            network=network,
            timers_set=(frozenset(),) * n,
            random_choices=((),) * n,
            crashed=(False,) * n,
            history=tester,
            actor_storages=(None,) * n,
        )

    # --- device side ----------------------------------------------------------

    def step_valid(self, states: torch.Tensor) -> torch.Tensor:
        """Phase A of two-phase expansion: ``int32[F, W] -> bool[F, M]``."""
        return paxos_step_valid(states, self.c)

    def step_lane(self, states, v_orig, count):
        """Phase B: the successors of the compacted valid lanes."""
        return paxos_step_lane(states, v_orig, count, self.c)

    def property_conds(self, states: torch.Tensor) -> torch.Tensor:
        return paxos_conds(states, self.c, self.never_decided)

    def boundary(self, states: torch.Tensor):
        """The ``max_round`` ballot boundary, ``int32[N, W] -> bool[N]``;
        None at the encoding cap, where the model is unbounded."""
        if self.max_round >= MAX_ROUND:
            return None
        return paxos_boundary_plain(states, self.max_round)

    def expand(self, states: torch.Tensor):
        """The single-phase wave of a bounded model (K14, then K6); the
        engine runs an unbounded one in two phases instead."""
        nexts, valid, flag = paxos_step(states, self.c, self.max_round)
        return nexts, valid, self.property_conds(states), flag

    def walk_step(self, states: torch.Tensor, plain: bool = False):
        """The JAX ``step`` of every lane with no boundary (K14) and the
        conds (K6)."""
        if plain:
            nexts, valid, flags = paxos_step_plain(
                states, self.c, None, flag_rows=True)
            conds = paxos_conds_plain(states, self.c, self.never_decided)
            return nexts, valid, conds, flags
        nexts, valid, flags = paxos_step(states, self.c, None, flag_rows=True)
        return nexts, valid, self.property_conds(states), flags


# --- the twins' lane arithmetic (masked int64, the JAX code line by line) --


def _ext(lo, hi, off: int, width: int):
    """A static bit field of a (lo, hi) u32 pair."""
    mask = (1 << width) - 1
    if off + width <= 32:
        return (lo >> off) & mask
    if off >= 32:
        return (hi >> (off - 32)) & mask
    return ((lo >> off) | (hi << (32 - off))) & mask


def _ins(lo, hi, off: int, width: int, val):
    """Insert ``val`` into a (lo, hi) u32 pair exactly as the JAX ``_ins``
    does -- unmasked, so an over-wide value spills as it does there."""
    m = (1 << width) - 1
    if off + width <= 32:
        lo = (lo & (~(m << off) & M32)) | shl32(val, off)
    elif off >= 32:
        o = off - 32
        hi = (hi & (~(m << o) & M32)) | shl32(val, o)
    else:
        nlo = 32 - off
        lo = (lo & (~((m & ((1 << nlo) - 1)) << off) & M32)) | shl32(
            val & ((1 << nlo) - 1), off
        )
        hi = (hi & (~(m >> nlo) & M32)) | (val >> nlo)
    return lo, hi


def _server_of(st, dsrv):
    """The (lo, hi) words of server ``dsrv`` by a select over the three
    records (0, 0 for an out-of-range index, as in JAX)."""
    lo = torch.zeros_like(dsrv)
    hi = torch.zeros_like(dsrv)
    for s in range(S):
        lo = torch.where(dsrv == s, st[..., 2 * s], lo)
        hi = torch.where(dsrv == s, st[..., 2 * s + 1], hi)
    return lo, hi


def _lane_header(st, code, prev, k):
    """Shared head of K5 and K7: representative-slot occupancy, the
    envelope fields, the destination server's record and the guards."""
    # Only the first slot of a run of equal codes is a lane; later copies
    # of a duplicated send stay in flight.
    occupied = (code != 0) & ((k == 0) | (prev != code))
    tag, addr, payload, i_src, i_dst = envelope_fields(code)
    dsrv = torch.where(
        tag == _T_PUT, addr % 3, torch.where(tag == _T_GET, (addr + 1) % 3, i_dst)
    )
    lo, hi = _server_of(st, dsrv)
    return occupied, tag, addr, payload, i_src, i_dst, dsrv, lo, hi


def _guards(rc, st, tag, payload, i_src, i_dst, lo, hi):
    """Per-tag validity of a Deliver, before occupancy."""
    c = rc.c
    fd = paxos_fields(c)
    ballot = _ext(lo, hi, *_F_BALLOT)
    prop = _ext(lo, hi, *fd.prop)
    decided = _ext(lo, hi, *fd.decided)
    not_dec = decided == 0
    _ci, _cli, kind, _opc = client_record(rc, st, i_dst)
    to_client = i_dst < c
    guards = {
        _T_PUT: not_dec & (prop == 0),
        _T_GET: decided == 1,
        _T_PREPARE: not_dec & (ballot < payload * 3 + i_src),
        _T_PREPARED: not_dec & ((payload // 512) * 3 + i_dst == ballot),
        _T_ACCEPT: not_dec & (ballot <= (payload // 8) * 3 + i_src),
        _T_ACCEPTED: not_dec & (payload * 3 + i_dst == ballot),
        _T_DECIDED: not_dec,
        _T_PUTOK: (kind == 1) & to_client,
        _T_GETOK: (kind == 2) & to_client,
    }
    return _select(tag, guards, torch.zeros_like(not_dec))


def _select(tag, by_tag, default):
    out = default
    for t, v in by_tag.items():
        out = torch.where(tag == t, v, out)
    return out


def paxos_step_valid_plain(states: torch.Tensor, c: int) -> torch.Tensor:
    """Plain-torch twin of the K5 kernel: ``int32[F, W] -> bool[F, M]``,
    the JAX ``step_valid`` for every state and slot."""
    m = slot_count(c)
    rc = _codec(c)
    st = u32(states)[:, None, :]  # [F, 1, W]: per-state fields broadcast
    slots = st[:, 0, _NET0 : _NET0 + m]  # [F, M]
    prev = torch.cat([torch.zeros_like(slots[:, :1]), slots[:, :-1]], dim=1)
    k = torch.arange(m, dtype=torch.int64, device=states.device)[None, :]
    occupied, tag, _addr, payload, i_src, i_dst, _dsrv, lo, hi = _lane_header(
        st, slots, prev, k
    )
    return occupied & _guards(rc, st, tag, payload, i_src, i_dst, lo, hi)


def _deliver_lanes(rc, st, k):
    """The JAX ``_deliver_lane`` over a batch: ``st`` int64[N, W] parent
    rows, ``k`` int64[N] slot indices -> (int64[N, W] successor words,
    bool[N] valid, bool[N] flag)."""
    c = rc.c
    m = slot_count(c)
    slots = st[:, _NET0 : _NET0 + m]
    code = slots.gather(1, k[:, None])[:, 0]
    prev = slots.gather(1, (k - 1).clamp(min=0)[:, None])[:, 0]
    prev = torch.where(k == 0, 0, prev)
    occupied, tag, addr, payload, i_src, i_dst, dsrv, lo, hi = _lane_header(
        st, code, prev, k
    )
    valid = occupied & _guards(rc, st, tag, payload, i_src, i_dst, lo, hi)

    fd = paxos_fields(c)
    p0, pw = fd.prep0, _PW
    ballot = _ext(lo, hi, *_F_BALLOT)
    prop = _ext(lo, hi, *fd.prop)
    prep_p = [_ext(lo, hi, p0 + pw * s, 1) for s in range(S)]
    prep_a = [_ext(lo, hi, p0 + 1 + pw * s, _ACC_BITS) for s in range(S)]
    acc_bit = [_ext(lo, hi, fd.accepts + s, 1) for s in range(S)]
    accepted = _ext(lo, hi, *fd.accepted)
    decided = _ext(lo, hi, *fd.decided)
    not_dec = decided == 0
    p1 = (dsrv + 1) % 3
    p2 = (dsrv + 2) % 3
    zero = torch.zeros_like(code)

    # Put (models/paxos.py PaxosActor.on_msg).
    r_new = ballot // 3 + 1
    put_flag = not_dec & (prop == 0) & (r_new > MAX_ROUND)
    plo, phi = _ins(lo, hi, *_F_BALLOT, r_new * 3 + dsrv)
    plo, phi = _ins(plo, phi, *fd.prop, addr + 1)
    for s in range(S):
        self_entry = (dsrv == s).long()
        plo, phi = _ins(plo, phi, p0 + pw * s, 1, self_entry)
        plo, phi = _ins(
            plo, phi, p0 + 1 + pw * s, _ACC_BITS,
            torch.where(self_entry == 1, accepted, 0),
        )
        plo, phi = _ins(plo, phi, fd.accepts + s, 1, zero)
    put_s0 = envelope_code(_T_PREPARE, dsrv * 8 + p1, r_new)
    put_s1 = envelope_code(_T_PREPARE, dsrv * 8 + p2, r_new)

    # Get on a decided server: accepted 0 wraps (0xFFFFFFFF % c).
    get_flag = (decided == 1) & (accepted == 0)
    get_v = 1 + ((accepted - 1) & M32) % c
    get_s0 = envelope_code(_T_GETOK, dsrv * 8 + addr, get_v)

    # Prepare.
    prep_mb = payload * 3 + i_src
    qlo, qhi = _ins(lo, hi, *_F_BALLOT, prep_mb)
    prepare_s0 = envelope_code(_T_PREPARED, i_dst * 8 + i_src, payload * 512 + accepted)

    # Prepared.
    pd_mb = (payload // 512) * 3 + i_dst
    pd_acc = payload % 512
    prepared_guard = not_dec & (pd_mb == ballot)
    pd_p = [prep_p[s] | (i_src == s).long() for s in range(S)]
    pd_a = [torch.where(i_src == s, pd_acc, prep_a[s]) for s in range(S)]
    pd_trigger = (pd_p[0] + pd_p[1] + pd_p[2]) == 2  # majority(3)
    pd_best = zero
    for s in range(S):
        pd_best = torch.maximum(pd_best, torch.where(pd_p[s] == 1, pd_a[s], 0))
    pd_prop = torch.where(pd_best > 0, 1 + (pd_best - 1) % c, prop)
    pd_flag = prepared_guard & pd_trigger & (pd_prop == 0)
    rlo, rhi = lo, hi
    for s in range(S):
        rlo, rhi = _ins(rlo, rhi, p0 + pw * s, 1, pd_p[s])
        rlo, rhi = _ins(rlo, rhi, p0 + 1 + pw * s, _ACC_BITS, pd_a[s])
    # Majority: adopt the proposal, self-accept, broadcast Accept.
    tlo, thi = _ins(rlo, rhi, *fd.prop, pd_prop)
    tlo, thi = _ins(tlo, thi, *fd.accepted, (1 + ballot * c + pd_prop - 1) & M32)
    for s in range(S):
        tlo, thi = _ins(tlo, thi, fd.accepts + s, 1, (i_dst == s).long())
    rlo = torch.where(pd_trigger, tlo, rlo)
    rhi = torch.where(pd_trigger, thi, rhi)
    pd_payload = ((ballot // 3) * 8 + pd_prop - 1) & M32
    pd_s0 = torch.where(pd_trigger, envelope_code(_T_ACCEPT, i_dst * 8 + p1, pd_payload), 0)
    pd_s1 = torch.where(pd_trigger, envelope_code(_T_ACCEPT, i_dst * 8 + p2, pd_payload), 0)

    # Accept.
    ac_mb = (payload // 8) * 3 + i_src
    alo, ahi = _ins(lo, hi, *_F_BALLOT, ac_mb)
    alo, ahi = _ins(alo, ahi, *fd.accepted, 1 + ac_mb * c + payload % 8)
    accept_s0 = envelope_code(_T_ACCEPTED, i_dst * 8 + i_src, payload // 8)

    # Accepted.
    accepted_guard = not_dec & (payload * 3 + i_dst == ballot)
    ad_bits = [acc_bit[s] | (i_src == s).long() for s in range(S)]
    ad_trigger = (ad_bits[0] + ad_bits[1] + ad_bits[2]) == 2
    ad_flag = accepted_guard & ad_trigger & (prop == 0)
    blo, bhi = lo, hi
    for s in range(S):
        blo, bhi = _ins(blo, bhi, fd.accepts + s, 1, ad_bits[s])
    blo, bhi = _ins(blo, bhi, *fd.decided, ad_trigger.long())
    ad_payload = (ballot * 8 + prop - 1) & M32
    ad_s0 = torch.where(ad_trigger, envelope_code(_T_DECIDED, i_dst * 8 + p1, ad_payload), 0)
    ad_s1 = torch.where(ad_trigger, envelope_code(_T_DECIDED, i_dst * 8 + p2, ad_payload), 0)
    ad_s2 = torch.where(
        ad_trigger, envelope_code(_T_PUTOK, (i_dst * 8 + prop - 1) & M32, zero), 0
    )

    # Decided.
    dlo, dhi = _ins(lo, hi, *_F_BALLOT, payload // 8)
    dlo, dhi = _ins(dlo, dhi, *fd.accepted, 1 + (payload // 8) * c + payload % 8)
    dlo, dhi = _ins(dlo, dhi, *fd.decided, torch.ones_like(code))

    # PutOk / GetOk to a client (the shared register-harness transitions).
    ci, cli, _kind, _opc = client_record(rc, st, i_dst)
    tw = tester_word(rc, st, ci)
    cli_putok, tw_putok = putok_transition(rc, st, ci, cli, tw)
    putok_s0 = envelope_code(_T_GET, ci, zero)
    cli_getok, tw_getok = getok_transition(rc, ci, cli, tw, payload)

    srv_lo = _select(tag, {_T_PUT: plo, _T_PREPARE: qlo, _T_PREPARED: rlo,
                           _T_ACCEPT: alo, _T_ACCEPTED: blo, _T_DECIDED: dlo}, lo)
    srv_hi = _select(tag, {_T_PUT: phi, _T_PREPARE: qhi, _T_PREPARED: rhi,
                           _T_ACCEPT: ahi, _T_ACCEPTED: bhi, _T_DECIDED: dhi}, hi)
    cli_f = _select(tag, {_T_PUTOK: cli_putok, _T_GETOK: cli_getok}, cli)
    tw_f = _select(tag, {_T_PUTOK: tw_putok, _T_GETOK: tw_getok}, tw)
    s0 = _select(tag, {_T_PUT: put_s0, _T_GET: get_s0, _T_PREPARE: prepare_s0,
                       _T_PREPARED: pd_s0, _T_ACCEPT: accept_s0,
                       _T_ACCEPTED: ad_s0, _T_PUTOK: putok_s0}, zero)
    s1 = _select(tag, {_T_PUT: put_s1, _T_PREPARED: pd_s1, _T_ACCEPTED: ad_s1}, zero)
    s2 = _select(tag, {_T_ACCEPTED: ad_s2}, zero)
    branch_flag = _select(tag, {_T_PUT: put_flag, _T_GET: get_flag,
                                _T_PREPARED: pd_flag, _T_ACCEPTED: ad_flag},
                          torch.zeros_like(valid))
    # Invalid lanes contribute no phantom sends to the slot math.
    sends = torch.stack([s0, s1, s2], dim=1) * valid.long()[:, None]

    new_slots, slot_overflow = resort_slots(slots, k, sends, valid)
    flag = (branch_flag & valid) | slot_overflow

    head = []
    for s in range(S):
        head.append(torch.where(dsrv == s, srv_lo, st[:, 2 * s]))
        head.append(torch.where(dsrv == s, srv_hi, st[:, 2 * s + 1]))
    head.append(cli_f)
    tail = [torch.where(ci == j, tw_f, st[:, rc.tst0 + j]) for j in range(c)]
    nexts = torch.cat(
        [torch.stack(head, dim=1), new_slots, torch.stack(tail, dim=1)], dim=1
    )
    return nexts, valid, flag


def paxos_step_lane_plain(states, v_orig, count, c: int):
    """Plain-torch twin of the K7 kernel.  ``states`` int32[F, W] are the
    wave's rows, ``v_orig`` int32[U] compacted flat lane indices
    (state * M + slot), ``count`` the number of them that are real (a
    tensor or int).  Returns ``(nexts int32[U, W], flags bool[U])``: lane
    j's successor and its encoding-overflow flag; rows at j >= count are
    unspecified and their flags False."""
    m = slot_count(c)
    u = v_orig.shape[0]
    n = min(int(count), u)  # only the live lanes are built
    v = u32(v_orig[:n])
    nexts = torch.zeros((u, state_width(c)), dtype=torch.int32, device=v.device)
    flags = torch.zeros((u,), dtype=torch.bool, device=v.device)
    live_rows, _valid, live_flags = _deliver_lanes(
        _codec(c), u32(states)[v // m], v % m
    )
    nexts[:n] = i32(live_rows)
    flags[:n] = live_flags
    return nexts, flags


def paxos_boundary_plain(rows: torch.Tensor, max_round: int) -> torch.Tensor:
    """Every server's ballot round (its ballot code // 3) at most
    ``max_round``: ``int32[N, W] -> bool[N]``, the JAX ``boundary``."""
    inside = torch.ones(rows.shape[:1], dtype=torch.bool, device=rows.device)
    for s in range(S):
        inside &= (u32(rows[:, 2 * s]) & 0x3F) // 3 <= max_round
    return inside


def paxos_step_plain(states: torch.Tensor, c: int, max_round: Optional[int],
                     flag_rows: bool = False):
    """Plain-torch twin of the K14 kernel: ``int32[F, W] -> (nexts
    int32[F, M, W], valid bool[F, M], flag bool)`` -- the JAX ``step`` of
    every state (``_deliver_lane`` of each slot), each lane's validity
    ANDed with its successor's :func:`paxos_boundary_plain`, and the any
    of the lanes' encoding-overflow flags, taken before the boundary.
    ``max_round=None`` is the JAX ``step`` alone, with no boundary; with
    ``flag_rows`` the flag is each state's, ``bool[F]``."""
    m = slot_count(c)
    w = state_width(c)
    f = states.shape[0]
    k = torch.arange(m, dtype=torch.int64, device=states.device).repeat(f)
    rows, valid, flags = _deliver_lanes(
        _codec(c), u32(states).repeat_interleave(m, dim=0), k
    )
    nexts = i32(rows)
    if max_round is not None:
        valid = valid & paxos_boundary_plain(nexts, max_round)
    rows_flag = flags.view(f, m).any(dim=1)
    return (nexts.view(f, m, w), valid.view(f, m),
            rows_flag if flag_rows else rows_flag.any())


def paxos_conds_plain(states: torch.Tensor, c: int, never_decided: bool):
    """Plain-torch twin of the K6 kernel: ``int32[F, W] -> bool[F, P]`` in
    property order -- linearizable, value chosen, never decided (when the
    model has it)."""
    m = slot_count(c)
    fd = paxos_fields(c)
    st = u32(states)
    lin = device_linearizable_plain(_codec(c), st)
    # "value chosen": a GetOk with a non-null value in flight.
    slots = st[:, _NET0 : _NET0 + m]
    tag, _a, payload, _s, _d = envelope_fields(slots)
    chosen = ((slots != 0) & (tag == _T_GETOK) & (payload != 0)).any(dim=1)
    conds = [lin, chosen]
    if never_decided:
        decided_any = torch.zeros_like(lin)
        for s in range(S):
            decided_any |= _ext(st[:, 2 * s], st[:, 2 * s + 1], *fd.decided) == 1
        conds.append(~decided_any)
    return torch.stack(conds, dim=1)


def _codec(c: int) -> RegisterClientCodec:
    """The client/tester section's layout at ``c`` clients."""
    if not 1 <= c <= MAX_CLIENTS:
        raise ValueError(f"packed paxos supports 1 to {MAX_CLIENTS} clients")
    return RegisterClientCodec(S, c, _CLI, _NET0 + slot_count(c))


# --- the kernels' wrappers -------------------------------------------------


def _check_rows(states: torch.Tensor, c: int) -> None:
    _codec(c)
    cuda.require(states, "states", torch.int32, 2, states.device)
    if states.shape[1] != state_width(c):
        raise ValueError(
            f"states must be [F, {state_width(c)}] at c={c}, got "
            f"{tuple(states.shape)}"
        )


def paxos_step_valid(states: torch.Tensor, c: int) -> torch.Tensor:
    """Deliver-lane validity of packed paxos rows, ``int32[F, W] ->
    bool[F, M]`` (K5)."""
    if states.device.type == "cpu":
        return paxos_step_valid_plain(states, c)
    _check_rows(states, c)
    f = states.shape[0]
    valid = torch.empty((f, slot_count(c)), dtype=torch.bool, device=states.device)
    fn = cuda.function(
        "paxos_valid", "sr_paxos_step_valid",
        [cuda.P, cuda.I64, cuda.I32, cuda.P, cuda.P],
    )
    paxos_step_valid.launches += 1
    code = fn(cuda.ptr(states), f, c, cuda.ptr(valid), cuda.stream(valid))
    cuda.check(code, "paxos_valid", "paxos_step_valid")
    return valid


paxos_step_valid.launches = 0


def paxos_step_lane(states, v_orig, count, c: int):
    """Successors of compacted lanes (K7): see :func:`paxos_step_lane_plain`.
    On the card ``count`` is K3's int64 device count, read by the kernel
    itself -- no host sync."""
    if states.device.type == "cpu":
        return paxos_step_lane_plain(states, v_orig, count, c)
    _check_rows(states, c)
    dev = states.device
    cuda.require(v_orig, "v_orig", torch.int32, 1, dev)
    cuda.require(count, "count", torch.int64, 0, dev)
    u = v_orig.shape[0]
    nexts = torch.empty((u, state_width(c)), dtype=torch.int32, device=dev)
    flags = torch.empty((u,), dtype=torch.bool, device=dev)
    fn = cuda.function(
        "paxos_lane", "sr_paxos_step_lane",
        [cuda.P, cuda.I64, cuda.I32, cuda.P, cuda.I64, cuda.P, cuda.P,
         cuda.P, cuda.P],
    )
    paxos_step_lane.launches += 1
    code = fn(
        cuda.ptr(states), states.shape[0], c, cuda.ptr(v_orig), u,
        cuda.ptr(count), cuda.ptr(nexts), cuda.ptr(flags), cuda.stream(nexts),
    )
    cuda.check(code, "paxos_lane", "paxos_step_lane")
    return nexts, flags


paxos_step_lane.launches = 0


def paxos_conds(states: torch.Tensor, c: int, never_decided: bool) -> torch.Tensor:
    """Property conditions of packed paxos rows, ``int32[F, W] ->
    bool[F, P]`` (K6)."""
    if states.device.type == "cpu":
        return paxos_conds_plain(states, c, never_decided)
    _check_rows(states, c)
    f = states.shape[0]
    p = 3 if never_decided else 2
    conds = torch.empty((f, p), dtype=torch.bool, device=states.device)
    fn = cuda.function(
        "paxos_conds", "sr_paxos_conds",
        [cuda.P, cuda.I64, cuda.I32, cuda.I32, cuda.P, cuda.P],
    )
    paxos_conds.launches += 1
    code = fn(
        cuda.ptr(states), f, c, int(never_decided), cuda.ptr(conds),
        cuda.stream(conds),
    )
    cuda.check(code, "paxos_conds", "paxos_conds")
    return conds


paxos_conds.launches = 0


def paxos_step(states: torch.Tensor, c: int, max_round: Optional[int],
               flag_rows: bool = False):
    """The single-phase step of packed paxos rows under the ballot bound
    ``max_round`` (K14), or with no boundary at ``max_round=None``: see
    :func:`paxos_step_plain`."""
    if max_round is not None and not 0 <= max_round <= MAX_ROUND:
        raise ValueError(f"max_round {max_round} outside 0..{MAX_ROUND}")
    if states.device.type == "cpu":
        return paxos_step_plain(states, c, max_round, flag_rows)
    _check_rows(states, c)
    dev = states.device
    f, m = states.shape[0], slot_count(c)
    nexts = torch.empty((f, m, state_width(c)), dtype=torch.int32, device=dev)
    valid = torch.empty((f, m), dtype=torch.bool, device=dev)
    flags = torch.empty((f, m), dtype=torch.bool, device=dev)
    fn = cuda.function(
        "paxos_step", "sr_paxos_step",
        [cuda.P, cuda.I64, cuda.I32, cuda.U32, cuda.P, cuda.P, cuda.P, cuda.P],
    )
    paxos_step.launches += 1
    # No boundary: every round code // 3 is at most 0xFFFFFFFF.
    bound = 0xFFFFFFFF if max_round is None else max_round
    code = fn(
        cuda.ptr(states), f, c, bound, cuda.ptr(nexts), cuda.ptr(valid),
        cuda.ptr(flags), cuda.stream(nexts),
    )
    cuda.check(code, "paxos_step", "paxos_step")
    rows_flag = flags.any(dim=1)
    return nexts, valid, rows_flag if flag_rows else rows_flag.any()


paxos_step.launches = 0
