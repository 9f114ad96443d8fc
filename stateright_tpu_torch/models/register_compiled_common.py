"""Shared machinery of the register-harness workloads (host codec and the
linearizability DP's plain-torch twin).

The counterpart of ``stateright_tpu/models/register_compiled_common.py``.
Every model built on the register test harness (``actor/register.py``:
paxos, single-copy, and later ABD) shares the same client side:
scripted clients that Put once then Get (``RegisterClient(put_count=1)``),
a ``LinearizabilityTester`` history recorded through the Get/Put <->
GetOk/PutOk hooks, and therefore the same packed client/tester layout and
the same exact linearizability decision.

Layout owned here (C clients, S servers):

- one *client word* of 4-bit records: awaiting kind (0 none / 1 put /
  2 get) + op_count, per client;
- C *tester words*: phase (3b), write-invocation snapshot (2b per other
  client), read-invocation snapshot (same), read value -- an injective
  encoding of the ``LinearizabilityTester`` state for this client.

The device half is batched plain torch over masked-int64 words
(``ops/u32.py``): the envelope-code helpers, the slot re-sort,
:func:`client_record`, :func:`tester_word`, :func:`putok_transition` and
:func:`getok_transition` feed the paxos and single-copy step twins, and
:func:`device_linearizable_plain` is the twin of the Wing&Gong-style
subset-reachability DP that ``csrc/register_lin.cuh`` runs on the card
(K6, K9) at 1..7 clients.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..actor.ids import Id
from ..actor.register import ClientState
from ..ops.u32 import M32, shl32
from ..semantics.register import READ, ReadOk, WRITE_OK, WriteOp


def decode_slot_counts(words, net0: int, m: int, env_of):
    """Host decode of the slot section back to multiset (env, count)
    pairs, counting repeated codes.  Shared across the register codecs."""
    env_counts: dict = {}
    for k in range(m):
        code = int(words[net0 + k])
        if code:
            env = env_of(code)
            env_counts[env] = env_counts.get(env, 0) + 1
    return frozenset(env_counts.items())


class RegisterClientCodec:
    """Codec + device predicates for the harness's client/tester section.

    ``cli_word``: index of the packed client-record word; ``tst0``: index
    of the first tester word.  ``values[i]`` is client i's put value
    (actor/register.py:126).
    """

    def __init__(self, server_count: int, client_count: int, cli_word: int,
                 tst0: int):
        self.s = server_count
        self.c = client_count
        self.cli_word = cli_word
        self.tst0 = tst0
        self.lcb = 2 * (client_count - 1)
        # Value codes 0..C (0 = NULL): width derived, not hard-coded, so
        # bench-scale configs (paxos check 6, single-copy check 4 —
        # reference bench.sh:27-34) pack correctly.
        self.vb = max(2, client_count.bit_length())
        # Tester word: phase(3) + two snapshots(lcb each) + value(vb); the
        # client word holds 4 bits per client.  Both must fit one u32.
        if 3 + 2 * self.lcb + self.vb > 32 or 4 * client_count > 32:
            raise ValueError(
                f"register harness supports at most 7 clients "
                f"(got {client_count}: tester word needs "
                f"{3 + 2 * self.lcb + self.vb} bits)"
            )
        self.values = tuple(
            chr(ord("A") + i) for i in range(client_count)
        )

    # --- host side -----------------------------------------------------------

    def value_code(self, v, null_value) -> int:
        """0 = NULL, 1+i = client i's value."""
        if v == null_value:
            return 0
        return 1 + self.values.index(v)

    def value_of(self, code: int, null_value):
        return null_value if code == 0 else self.values[code - 1]

    def encode_clients(self, actor_states) -> int:
        bits = 0
        for i in range(self.c):
            cs: ClientState = actor_states[self.s + i]
            if cs.awaiting is None:
                kind = 0
            elif cs.awaiting == self.s + i:
                kind = 1  # awaiting the put
            else:
                assert cs.awaiting == 2 * (self.s + i)
                kind = 2  # awaiting the get
            assert cs.op_count <= 3
            bits |= (kind | (cs.op_count << 2)) << (4 * i)
        return bits

    def decode_clients(self, bits: int) -> List[ClientState]:
        out = []
        for i in range(self.c):
            nib = (bits >> (4 * i)) & 0xF
            kind, op_count = nib & 0x3, nib >> 2
            awaiting = {0: None, 1: self.s + i, 2: 2 * (self.s + i)}[kind]
            out.append(ClientState(awaiting=awaiting, op_count=op_count))
        return out

    def _lc_code(self, last_completed, me: int) -> int:
        """Snapshot tuple -> 2 bits per other client (0 absent, else idx+1)."""
        lc = dict(last_completed)
        bits = 0
        slot = 0
        for j in range(self.c):
            if j == me:
                continue
            v = lc.get(Id(self.s + j))
            bits |= (0 if v is None else v + 1) << (2 * slot)
            slot += 1
        return bits

    def _lc_of(self, bits: int, me: int):
        out = []
        slot = 0
        for j in range(self.c):
            if j == me:
                continue
            v = (bits >> (2 * slot)) & 0x3
            if v:
                out.append((Id(self.s + j), v - 1))
            slot += 1
        return tuple(sorted(out))

    def encode_tester(self, h, me: int, null_value) -> int:
        tid = Id(self.s + me)
        hist = h.history_by_thread.get(tid)
        inflight = h.in_flight_by_thread.get(tid)
        lcb = self.lcb
        if hist is None and inflight is None:
            return 0  # phase 0
        if inflight is not None and not hist:
            lc, op = inflight
            assert op == WriteOp(self.values[me])
            return 1 | (self._lc_code(lc, me) << 3)
        assert hist[0][1] == WriteOp(self.values[me]) and hist[0][2] == WRITE_OK
        lc_w = self._lc_code(hist[0][0], me)
        if len(hist) == 1 and inflight is None:
            return 2 | (lc_w << 3)
        if len(hist) == 1:
            lc, op = inflight
            assert op == READ
            return 3 | (lc_w << 3) | (self._lc_code(lc, me) << (3 + lcb))
        assert len(hist) == 2 and inflight is None and hist[1][1] == READ
        lc_r = self._lc_code(hist[1][0], me)
        vcode = self.value_code(hist[1][2].value, null_value)
        return 4 | (lc_w << 3) | (lc_r << (3 + lcb)) | (vcode << (3 + 2 * lcb))

    def decode_tester_into(self, h, bits: int, me: int, null_value) -> None:
        tid = Id(self.s + me)
        phase = bits & 0x7
        if phase == 0:
            return
        lcb = self.lcb
        lc_w = self._lc_of((bits >> 3) & ((1 << lcb) - 1), me)
        if phase == 1:
            h.in_flight_by_thread[tid] = (lc_w, WriteOp(self.values[me]))
            h.history_by_thread[tid] = ()
            return
        entry_w = (lc_w, WriteOp(self.values[me]), WRITE_OK)
        if phase == 2:
            h.history_by_thread[tid] = (entry_w,)
            return
        lc_r = self._lc_of((bits >> (3 + lcb)) & ((1 << lcb) - 1), me)
        if phase == 3:
            h.history_by_thread[tid] = (entry_w,)
            h.in_flight_by_thread[tid] = (lc_r, READ)
            return
        vcode = (bits >> (3 + 2 * lcb)) & ((1 << self.vb) - 1)
        h.history_by_thread[tid] = (
            entry_w,
            (lc_r, READ, ReadOk(self.value_of(vcode, null_value))),
        )

# --- device half: batched plain torch over masked-int64 words -------------
#
# ``st`` is a tensor of packed rows as int64 in [0, 2**32) with the word
# axis last; leading axes broadcast (a lane axis may be 1 for per-state
# fields).  The functions mirror the JAX package's per-state ones word for
# word, including its u32 wrap-around.


def envelope_fields(code):
    """``(tag, addr, payload, addr >> 3, addr & 7)`` of envelope codes
    ``1 + (tag << 19 | addr << 14 | payload)``; an empty slot (0) wraps
    to all-ones, as in u32."""
    e = (code - 1) & M32
    tag = e >> 19
    addr = (e >> 14) & 0x1F
    payload = e & 0x3FFF
    return tag, addr, payload, addr >> 3, addr & 7


def envelope_code(tag: int, addr, payload):
    """The envelope code of (tag, addr, payload) in u32, unmasked fields
    spilling as they do there."""
    return (1 + ((tag << 19) | shl32(addr & M32, 14) | (payload & M32))) & M32


def resort_slots(slots, k, sends, valid):
    """The slot section after delivering slot ``k`` of each row: ``slots``
    int64[N, M], ``k`` int64[N], ``sends`` int64[N, S] (0 = none),
    ``valid`` bool[N] -> (int64[N, M] new slots, bool[N] overflow).  Slot
    k is removed, the sends inserted, and the row re-sorted unsigned with
    empty slots as 0xFFFFFFFF (the masked int64 domain orders them last;
    an int32 sort would put them first); a valid lane whose sends do not
    fit overflows."""
    m = slots.shape[1]
    lane_sel = torch.arange(m, device=slots.device)[None, :] == k[:, None]
    cand = torch.cat([torch.where(lane_sel, 0, slots), sends], dim=1)
    cand = torch.where(cand == 0, M32, cand)
    cand = torch.sort(cand, dim=1).values
    overflow = valid & (cand[:, m:] != M32).any(dim=1)
    return torch.where(cand[:, :m] == M32, 0, cand[:, :m]), overflow


def client_record(rc: RegisterClientCodec, st: torch.Tensor, ci: torch.Tensor):
    """``(ci, cli, kind, op_count)`` of (clamped) client ``ci``; the clamped
    index is safe for the tester-word select."""
    ci = torch.clamp(ci, max=rc.c - 1)
    cli = st[..., rc.cli_word]
    nib = (cli >> (4 * ci)) & 0xF
    return ci, cli, nib & 3, nib >> 2


def tester_word(rc: RegisterClientCodec, st: torch.Tensor, ci: torch.Tensor):
    tw = torch.zeros_like(ci)
    for j in range(rc.c):
        tw = torch.where(ci == j, st[..., rc.tst0 + j], tw)
    return tw


def putok_transition(rc: RegisterClientCodec, st, ci, cli, tw):
    """Client ``ci`` receives its PutOk: nibble -> (get, 2); tester phase
    1 -> 3, snapshotting the other clients' completed counts at the Get
    invocation (consistency.py's ``on_invoke``)."""
    cli_new = (cli & (~(0xF << (4 * ci)) & M32)) | (10 << (4 * ci))
    phases = [st[..., rc.tst0 + j] & 7 for j in range(rc.c)]
    counts = [
        (phases[j] >= 2).long() + (phases[j] == 4).long() for j in range(rc.c)
    ]
    lc_r = torch.zeros_like(ci)
    for me in range(rc.c):
        bits = torch.zeros_like(counts[0])
        slot = 0
        for j in range(rc.c):
            if j == me:
                continue
            bits = bits | (counts[j] << (2 * slot))
            slot += 1
        lc_r = torch.where(ci == me, bits, lc_r)
    lc_w_old = (tw >> 3) & ((1 << rc.lcb) - 1)
    tw_new = 3 | (lc_w_old << 3) | (lc_r << (3 + rc.lcb))
    return cli_new, tw_new


def getok_transition(rc: RegisterClientCodec, ci, cli, tw, value_code):
    """Client ``ci`` receives its GetOk(value): nibble -> (done, 3); tester
    phase 3 -> 4 recording the read value (shifted in u32: a value code
    too wide for its field wraps off the word's top, as in JAX)."""
    cli_new = (cli & (~(0xF << (4 * ci)) & M32)) | (12 << (4 * ci))
    shift = 3 + 2 * rc.lcb
    tw_new = (tw & (M32 ^ 7)) | 4 | ((value_code & (M32 >> shift)) << shift)
    return cli_new, tw_new


def _has_masks(n_ops: int, nwords: int) -> np.ndarray:
    """HAS[b, w]: bit k of word w is set iff subset 32w+k contains op b
    (only real subsets get bits)."""
    nsub = 1 << n_ops
    has = np.zeros((n_ops, nwords), np.int64)
    for b in range(n_ops):
        for sub in range(nsub):
            if (sub >> b) & 1:
                has[b, sub // 32] |= 1 << (sub % 32)
    return has


def device_linearizable_plain(rc: RegisterClientCodec, st: torch.Tensor) -> torch.Tensor:
    """``int64[F, W] -> bool[F]``: the DP's verdict (see :func:`_dp`)."""
    return _dp(rc, st)[0]


def dp_work(rc: RegisterClientCodec, st: torch.Tensor) -> torch.Tensor:
    """The DP word updates the rows ``st`` need, ``int64[F]``: per state,
    the rounds that add a configuration (the kernel stops after the first
    that adds none) times its present operations times the NV x NW words
    -- what an operation bound of the kernel counts."""
    _lin, rounds, present = _dp(rc, st)
    nwords = max(1, (1 << (2 * rc.c)) // 32)
    return rounds * present * (rc.c + 1) * nwords


def _dp(rc: RegisterClientCodec, st: torch.Tensor):
    """Plain-torch twin of the linearizability DP (``csrc/register_lin.cuh``):
    ``st`` int64[F, W] -> (bool[F] verdicts, int64[F] rounds that added a
    configuration, int64[F] operations present in the history).

    The JAX ``RegisterClientCodec.device_linearizable`` word for word: a
    reachability DP over Wing&Gong-style configurations -- subsets of the
    2C register operations (op i = client i's write, op C+i its read)
    crossed with the register value -- bit-packed over u32 words (bit k
    of word w = subset 32w+k).  Appending op o maps subset ``sub^bit(o)``
    to ``sub``: an in-word shift by 2**o for o < 5, a word-level move for
    o >= 5.  An op is appendable iff its real-time prerequisites (from
    the tester's last-completed snapshots) are in the subset and, for a
    read, the register holds the value it returned.  The history is
    linearizable iff a configuration holding every completed op is
    reachable.  Shifts are of whole words, so they run in masked int64:
    an int32 ``>>`` would smear the sign bit."""
    c = rc.c
    n_ops = 2 * c
    nv = c + 1
    nwords = max(1, (1 << n_ops) // 32)
    lcb = rc.lcb
    f = st.shape[0]
    dev = st.device

    tw = [st[:, rc.tst0 + i] for i in range(c)]
    phase = [w & 7 for w in tw]
    lc_r = [(w >> (3 + lcb)) & ((1 << lcb) - 1) for w in tw]
    v_read = [(w >> (3 + 2 * lcb)) & ((1 << rc.vb) - 1) for w in tw]
    w_completed = [p >= 2 for p in phase]
    w_present = [p >= 1 for p in phase]
    r_present = [p == 4 for p in phase]  # completed reads

    # Real-time prerequisite masks.  A snapshot code about thread j
    # constrains only j's *completed* ops.
    zero = torch.zeros((f,), dtype=torch.int64, device=dev)
    pm = [zero] * c  # writes invoke at init: empty snapshot
    for i in range(c):
        mask = torch.full((f,), 1 << i, dtype=torch.int64, device=dev)
        slot = 0
        for j in range(c):
            if j == i:
                continue
            cj = (lc_r[i] >> (2 * slot)) & 3
            mask = mask | torch.where((cj >= 1) & w_completed[j], 1 << j, 0)
            mask = mask | torch.where((cj >= 2) & r_present[j], 1 << (c + j), 0)
            slot += 1
        pm.append(mask)
    present = w_present + r_present

    has = torch.from_numpy(_has_masks(n_ops, nwords)).to(dev)  # [n_ops, nwords]
    ones = torch.full((f, nwords), M32, dtype=torch.int64, device=dev)

    def superset_indicator(mask):
        """Packed indicator of {sub : mask ⊆ sub}: AND of HAS rows."""
        out = ones
        for b in range(n_ops):
            bit_set = ((mask >> b) & 1) == 1
            out = out & torch.where(bit_set[:, None], has[b][None, :], ones)
        return out

    gates = [
        torch.where(present[o][:, None], superset_indicator(pm[o]) & has[o], 0)
        for o in range(n_ops)
    ]
    v_arange = torch.arange(nv, dtype=torch.int64, device=dev)
    colmask = []  # [F, nv] of 0 / all-ones
    for o in range(n_ops):
        want = (
            torch.full((f, 1), 1 + o, dtype=torch.int64, device=dev) if o < c
            else v_read[o - c][:, None]
        )
        colmask.append(torch.where(v_arange[None, :] == want, M32, 0))

    def shift_src(dp, o):
        """dp's image of sub^bit(o) at the subsets holding bit o."""
        if o < 5:
            return ((dp << (1 << o)) & M32) & has[o]
        stride = 1 << (o - 5)
        r = dp.reshape(f, nv, nwords // (2 * stride), 2, stride)
        low = r[:, :, :, 0:1, :]
        return torch.cat([torch.zeros_like(low), low], dim=3).reshape(f, nv, nwords)

    def sweep(dp):
        for o in range(n_ops):
            shifted = shift_src(dp, o)
            if o < c:
                # Write: any source value reaches; the register becomes 1+o.
                any_v = shifted[:, 0]
                for v in range(1, nv):
                    any_v = any_v | shifted[:, v]
                add = any_v & gates[o]
                dp = dp | (add[:, None, :] & colmask[o][:, :, None])
            else:
                # Read: the register must already hold the returned value.
                dp = dp | (shifted & gates[o][:, None, :] & colmask[o][:, :, None])
        return dp

    dp = torch.zeros((f, nv, nwords), dtype=torch.int64, device=dev)
    dp[:, 0, 0] = 1
    # n_ops rounds of relaxation reach any appendable-op order.
    rounds = torch.zeros((f,), dtype=torch.int64, device=dev)
    for _ in range(n_ops):
        grown = sweep(dp)
        rounds += (grown != dp).flatten(1).any(dim=1).long()
        dp = grown

    req = zero
    for i in range(c):
        req = req | torch.where(w_completed[i], 1 << i, 0)
        req = req | torch.where(r_present[i], 1 << (c + i), 0)
    covers = superset_indicator(req)
    lin = ((dp & covers[:, None, :]) != 0).flatten(1).any(dim=1)
    return lin, rounds, sum(p.long() for p in present)
