"""Bit-packed device form of the single-copy register (kernel K9).

The counterpart of ``stateright_tpu/models/single_copy_compiled.py``: the
*violation* workload of the linearizability DP.  With one server the
register is linearizable; with two, clients round-robin their Put and Get
to different servers, and the reachable space holds non-linearizable
histories, so the "linearizable" property discovers a counterexample.

Layout (C <= 7 clients, S <= 2 servers), identical to the JAX codec's:

- word 0: the server values, VB = max(2, bit_length(C)) bits each (0 =
  NULL, 1+i = client i's value);
- word 1: the shared client word (``register_compiled_common.py``);
- words 2..2+M: network slots, M = 4 for C <= 2 and 8 above (each client
  has at most one message in flight) -- sorted nonzero envelope codes,
  then zeros;
- last C words: the tester words.

Device functions: :func:`single_copy_step` (K9,
``csrc/single_copy_step.cu``) is the JAX ``step`` (one Deliver lane per
slot, its successor, validity and slot-overflow flag) fused with
``property_conds`` (linearizable, through the DP of
``csrc/register_lin.cuh``, and value chosen) on a CUDA tensor;
:func:`single_copy_step_plain` is its plain-torch twin, run for CPU
tensors.  The engine expands it in one phase, as it does 2pc.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..actor import Envelope, Id, Network
from ..actor.model import ActorModelState
from ..actor.register import Get, GetOk, Put, PutOk
from ..ops import cuda
from ..ops.u32 import M32, i32, u32
from ..parallel.compiled import CompiledModel, fused_conds, override_conds
from ..semantics import LinearizabilityTester, Register
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
from .single_copy_register import NULL_VALUE

MAX_SERVERS = 2
MAX_CLIENTS = 7
_T_PUT, _T_GET, _T_PUTOK, _T_GETOK = 0, 1, 2, 3
_NET0 = 2
N_PROPS = 2  # linearizable, value chosen


def slot_count(c: int) -> int:
    return 4 if c <= 2 else 8


def state_width(c: int) -> int:
    return 2 + slot_count(c) + c


def _codec(s: int, c: int) -> RegisterClientCodec:
    """The client/tester section's layout at ``s`` servers, ``c`` clients."""
    if not 1 <= s <= MAX_SERVERS or not 1 <= c <= MAX_CLIENTS:
        raise ValueError(
            f"packed single-copy supports 1 to {MAX_SERVERS} servers and "
            f"1 to {MAX_CLIENTS} clients (got {s} and {c})"
        )
    return RegisterClientCodec(s, c, 1, _NET0 + slot_count(c))


class SingleCopyCompiled(CompiledModel):
    """Codec and fused device step for ``SingleCopyModelCfg.into_model()``."""

    def __init__(self, model):
        self.model = model
        cfg = model.cfg
        if model.init_network.kind != "unordered_nonduplicating":
            raise ValueError(
                "packed single-copy needs the unordered_nonduplicating network"
            )
        self.s = cfg.server_count
        self.c = cfg.client_count
        self.rc = _codec(self.s, self.c)
        self.m = slot_count(self.c)
        self.state_width = state_width(self.c)
        self.max_actions = self.m  # one Deliver lane per slot
        self.vb = self.rc.vb  # server-value field width in word 0
        self.values = self.rc.values

    # --- envelope codes -------------------------------------------------------

    def _env_code(self, env: Envelope) -> int:
        s, rc = self.s, self.rc
        msg = env.msg
        src, dst = int(env.src), int(env.dst)
        if isinstance(msg, Put):
            ci = src - s
            assert msg == Put(s + ci, self.values[ci]) and dst == (s + ci) % s
            code = (_T_PUT, ci, 0)
        elif isinstance(msg, Get):
            ci = src - s
            assert msg.request_id == 2 * (s + ci) and dst == (s + ci + 1) % s
            code = (_T_GET, ci, 0)
        elif isinstance(msg, PutOk):
            ci = dst - s
            assert msg.request_id == s + ci
            code = (_T_PUTOK, src * 8 + ci, 0)
        elif isinstance(msg, GetOk):
            ci = dst - s
            assert msg.request_id == 2 * (s + ci)
            code = (_T_GETOK, src * 8 + ci, rc.value_code(msg.value, NULL_VALUE))
        else:
            raise ValueError(f"unknown message {msg!r}")
        tag, addr, payload = code
        assert addr < 32 and payload < (1 << 14)
        return 1 + ((tag << 19) | (addr << 14) | payload)

    def _env_of(self, code: int) -> Envelope:
        s, rc = self.s, self.rc
        code -= 1
        tag = code >> 19
        addr = (code >> 14) & 0x1F
        payload = code & 0x3FFF
        if tag == _T_PUT:
            ci = addr
            return Envelope(
                Id(s + ci), Id((s + ci) % s), Put(s + ci, self.values[ci])
            )
        if tag == _T_GET:
            ci = addr
            return Envelope(Id(s + ci), Id((s + ci + 1) % s), Get(2 * (s + ci)))
        if tag == _T_PUTOK:
            src, ci = addr // 8, addr % 8
            return Envelope(Id(src), Id(s + ci), PutOk(s + ci))
        if tag == _T_GETOK:
            src, ci = addr // 8, addr % 8
            return Envelope(
                Id(src), Id(s + ci),
                GetOk(2 * (s + ci), rc.value_of(payload, NULL_VALUE)),
            )
        raise ValueError(f"bad envelope code {code}")

    # --- full state -----------------------------------------------------------

    def encode(self, st: ActorModelState) -> np.ndarray:
        words = np.zeros(self.state_width, dtype=np.uint32)
        bits = 0
        for i in range(self.s):
            bits |= self.rc.value_code(st.actor_states[i], NULL_VALUE) << (
                self.vb * i
            )
        words[0] = bits
        words[1] = self.rc.encode_clients(st.actor_states)
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
            words[_NET0 + self.m + i] = self.rc.encode_tester(
                st.history, i, NULL_VALUE
            )
        return words

    def decode(self, words: Sequence[int]) -> ActorModelState:
        bits = int(words[0])
        servers = tuple(
            self.rc.value_of(
                (bits >> (self.vb * i)) & ((1 << self.vb) - 1), NULL_VALUE
            )
            for i in range(self.s)
        )
        clients = self.rc.decode_clients(int(words[1]))
        network = Network(
            kind="unordered_nonduplicating",
            counts=decode_slot_counts(words, _NET0, self.m, self._env_of),
        )
        tester = LinearizabilityTester(Register(NULL_VALUE))
        for i in range(self.c):
            self.rc.decode_tester_into(
                tester, int(words[_NET0 + self.m + i]), i, NULL_VALUE
            )
        n = self.s + self.c
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
        nexts, valid, _conds, _flag = single_copy_step(states, self.s, self.c)
        return nexts, valid

    def property_conds(self, states):
        return single_copy_step(states, self.s, self.c)[2]

    def expand(self, states):
        nexts, valid, conds, flag = single_copy_step(states, self.s, self.c)
        if not fused_conds(self, SingleCopyCompiled):
            conds = self.property_conds(states)
        return nexts, valid, conds, flag

    def walk_step(self, states, plain=False):
        fn = single_copy_step_plain if plain else single_copy_step
        nexts, valid, conds, flags = fn(states, self.s, self.c, flag_rows=True)
        if not fused_conds(self, SingleCopyCompiled):
            conds = override_conds(self, states, plain)
        return nexts, valid, conds, flags


def single_copy_step_plain(
    states: torch.Tensor, s: int, c: int, flag_rows: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-torch twin of the K9 kernel: ``int32[F, W] -> (nexts
    int32[F, M, W], valid bool[F, M], conds bool[F, 2], flag bool[])``.
    Every lane's words are the JAX ``_deliver_lane``'s, valid or not; the
    flag is the OR of the lanes' slot-overflow flags (the JAX ``step``'s
    ``any``), and the conds are the JAX ``property_conds``.  With
    ``flag_rows`` the flag is each state's, ``bool[F]``."""
    rc = _codec(s, c)
    m = slot_count(c)
    f = states.shape[0]
    st = u32(states)
    slots = st[:, _NET0 : _NET0 + m]
    prev = torch.cat([torch.zeros_like(slots[:, :1]), slots[:, :-1]], dim=1)
    k = torch.arange(m, dtype=torch.int64, device=states.device)[None, :]
    occupied = (slots != 0) & ((k == 0) | (prev != slots))
    tag, addr, payload, _i_src, i_dst = envelope_fields(slots)
    row = st[:, None, :]  # per-state fields broadcast over the lanes
    vb, vmask = rc.vb, (1 << rc.vb) - 1

    # Put goes to (s+ci) % s, Get to (s+ci+1) % s (actor/register.py).
    dsrv = torch.where(tag == _T_PUT, (addr + s) % s, (addr + s + 1) % s)
    srv_bits = row[..., 0]
    sh = vb * dsrv
    sval = (srv_bits >> sh) & vmask
    # Put: store the value, reply PutOk; Get: reply with the value.
    put_bits = (srv_bits & (~(vmask << sh) & M32)) | (((addr + 1) << sh) & M32)
    put_s0 = envelope_code(_T_PUTOK, dsrv * 8 + addr, torch.zeros_like(addr))
    get_s0 = envelope_code(_T_GETOK, dsrv * 8 + addr, sval)

    # PutOk / GetOk to a client (the shared register-harness transitions).
    ci, cli, kind, _opc = client_record(rc, row, i_dst)
    tw = tester_word(rc, row, ci)
    to_client = i_dst < c
    cli_putok, tw_putok = putok_transition(rc, row, ci, cli, tw)
    putok_s0 = envelope_code(_T_GET, ci, torch.zeros_like(ci))
    cli_getok, tw_getok = getok_transition(rc, ci, cli, tw, payload)

    def sel(pairs, default):
        out = default
        for t, v in pairs.items():
            out = torch.where(tag == t, v, out)
        return out

    true = torch.ones_like(occupied)
    valid = occupied & sel(
        {_T_PUT: true, _T_GET: true, _T_PUTOK: (kind == 1) & to_client,
         _T_GETOK: (kind == 2) & to_client},
        torch.zeros_like(occupied),
    )
    srv_f = sel({_T_PUT: put_bits}, srv_bits.expand_as(put_bits))
    cli_f = sel({_T_PUTOK: cli_putok, _T_GETOK: cli_getok}, cli.expand_as(ci))
    tw_f = sel({_T_PUTOK: tw_putok, _T_GETOK: tw_getok}, tw)
    s0 = sel({_T_PUT: put_s0, _T_GET: get_s0, _T_PUTOK: putok_s0},
             torch.zeros_like(addr))
    s0 = torch.where(valid, s0, 0)

    lanes = f * m
    new_slots, overflow = resort_slots(
        slots[:, None, :].expand(f, m, m).reshape(lanes, m),
        k.expand(f, m).reshape(lanes),
        s0.reshape(lanes, 1),
        valid.reshape(lanes),
    )
    tail = [
        torch.where(ci == j, tw_f, row[..., rc.tst0 + j]) for j in range(c)
    ]
    nexts = torch.cat(
        [srv_f[..., None], cli_f[..., None], new_slots.view(f, m, m),
         torch.stack(tail, dim=-1)],
        dim=-1,
    )

    lin = device_linearizable_plain(rc, st)
    chosen = ((slots != 0) & (tag == _T_GETOK) & (payload != 0)).any(dim=1)
    conds = torch.stack([lin, chosen], dim=1)
    rows = overflow.view(f, m).any(dim=1)
    return i32(nexts), valid, conds, rows if flag_rows else rows.any()


# --- the kernel's wrapper ----------------------------------------------------


def single_copy_step(states: torch.Tensor, s: int, c: int,
                     flag_rows: bool = False):
    """Every Deliver lane's successor and the property conditions of packed
    single-copy rows, fused (K9): see :func:`single_copy_step_plain`."""
    if states.device.type == "cpu":
        return single_copy_step_plain(states, s, c, flag_rows)
    _codec(s, c)
    dev = states.device
    cuda.require(states, "states", torch.int32, 2, dev)
    w, m = state_width(c), slot_count(c)
    if states.shape[1] != w:
        raise ValueError(
            f"states must be [F, {w}] at c={c}, got {tuple(states.shape)}"
        )
    f = states.shape[0]
    nexts = torch.empty((f, m, w), dtype=torch.int32, device=dev)
    valid = torch.empty((f, m), dtype=torch.bool, device=dev)
    conds = torch.empty((f, N_PROPS), dtype=torch.bool, device=dev)
    flags = torch.empty((f,), dtype=torch.bool, device=dev)
    fn = cuda.function(
        "single_copy_step", "sr_single_copy_step",
        [cuda.P, cuda.I64, cuda.I32, cuda.I32, cuda.P, cuda.P, cuda.P, cuda.P,
         cuda.P],
    )
    single_copy_step.launches += 1
    code = fn(
        cuda.ptr(states), f, s, c, cuda.ptr(nexts), cuda.ptr(valid),
        cuda.ptr(conds), cuda.ptr(flags), cuda.stream(nexts),
    )
    cuda.check(code, "single_copy_step", "single_copy_step")
    return nexts, valid, conds, flags if flag_rows else flags.any()


single_copy_step.launches = 0
