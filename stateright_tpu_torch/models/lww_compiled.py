"""Bit-packed device form of the LWW-register CRDT (kernel K16).

The counterpart of ``stateright_tpu/models/lww_compiled.py``: the compiled
model of the actor layer's last action family, ``SelectRandom``
(src/actor/model.rs:320-333).  A node's random-choice menu is always
``_populate_choices(local_clock)`` (every ``on_random`` repopulates it and
``on_msg`` leaves the clock alone), so it needs no bits: its five lanes
follow from the packed clock, and ``decode`` rebuilds the menu.

Layout, as in the JAX codec (at most 3 nodes): one word per node --
register present (1), value (2), timestamp (6, offset-coded), updater (2),
local clock (6), maximum used clock (6) -- then 12 single-word envelope
codes (src 2 | dst 2 | value 2 | timestamp 6 | updater 2, plus 1 so 0 is
empty), sorted, a multiset by repetition.  Clocks are offset-coded
around the starting clock 1000 with a budget of 31 either way.  A step
that leaves the budget, or sends past the 12 slots, raises the encoding
flag; the engine then stops with the JAX engine's ``RuntimeError``.  That
happens before the reference's default depth 8 with 2 nodes, and at depth
6 with 3: the JAX package's limit, kept here.

Lanes: Deliver of each slot (valid once per distinct envelope: an
occupied slot that is the first of its equal run), then for each node its
five choices -- SetValue(A/B/C), SetTime(clock + 1), SetTime(clock - 1).
:func:`lww_step` launches ``csrc/lww_step.cu`` on a CUDA tensor; on a CPU
tensor it runs :func:`lww_step_plain`, its twin in masked int64.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..actor import Envelope, Id, Network
from ..actor.model import ActorModelState
from ..ops import cuda
from ..ops.u32 import M32, i32, u32
from ..parallel.compiled import CompiledModel, fused_conds, override_conds
from .lww_register import LwwActorState, LwwRegister, SetTime, SetValue, VALUES

CLOCK_BASE = 1000 - 31  # offset code 0..63 covers clocks 969..1032
NET_SLOTS = 12
N_CHOICES = 5  # SetValue(A/B/C), SetTime(+1), SetTime(-1)
MAX_NODES = 3


class LwwCompiled(CompiledModel):
    """Codec and device step of ``lww_register.build_model()``."""

    def __init__(self, model):
        self.model = model
        self.n = len(model.actors)
        if not 1 <= self.n <= MAX_NODES:
            raise ValueError(f"packed lww supports 1 to {MAX_NODES} nodes")
        if model.lossy_network or model.max_crashes:
            raise ValueError("packed lww supports lossless, crash-free runs")
        if model.init_network.kind != "unordered_nonduplicating":
            raise ValueError(
                "packed lww supports the unordered_nonduplicating network"
            )
        self.m = NET_SLOTS
        self.state_width = self.n + self.m
        self.max_actions = self.m + N_CHOICES * self.n

    # --- small codes -------------------------------------------------------

    @staticmethod
    def _clock_code(c: int) -> int:
        off = c - CLOCK_BASE
        if not 0 <= off < 64:
            raise ValueError(f"clock {c} outside the offset budget")
        return off

    @staticmethod
    def _val_code(v) -> int:
        return VALUES.index(v)

    def _encode_node(self, s: LwwActorState) -> int:
        bits = 0
        if s.register is not None:
            bits |= 1
            bits |= self._val_code(s.register.value) << 1
            bits |= self._clock_code(s.register.timestamp) << 3
            bits |= s.register.updater_id << 9
        bits |= self._clock_code(s.local_clock) << 11
        bits |= self._clock_code(s.maximum_used_clock) << 17
        return bits

    def _decode_node(self, bits: int) -> LwwActorState:
        reg = None
        if bits & 1:
            reg = LwwRegister(
                VALUES[(bits >> 1) & 3],
                CLOCK_BASE + ((bits >> 3) & 63),
                (bits >> 9) & 3,
            )
        return LwwActorState(
            register=reg,
            local_clock=CLOCK_BASE + ((bits >> 11) & 63),
            maximum_used_clock=CLOCK_BASE + ((bits >> 17) & 63),
        )

    def _env_code(self, env: Envelope) -> int:
        msg = env.msg
        assert isinstance(msg, LwwRegister), msg
        return 1 + (
            int(env.src)
            | (int(env.dst) << 2)
            | (self._val_code(msg.value) << 4)
            | (self._clock_code(msg.timestamp) << 6)
            | (msg.updater_id << 12)
        )

    def _env_of(self, code: int) -> Envelope:
        code -= 1
        return Envelope(
            Id(code & 3),
            Id((code >> 2) & 3),
            LwwRegister(
                VALUES[(code >> 4) & 3],
                CLOCK_BASE + ((code >> 6) & 63),
                (code >> 12) & 3,
            ),
        )

    # --- full state --------------------------------------------------------

    def _choices_for(self, clock: int) -> Tuple[Tuple[str, tuple], ...]:
        menu = tuple(
            [SetValue(v) for v in VALUES]
            + [SetTime(clock + 1), SetTime(max(clock - 1, 0))]
        )
        return (("node_action", menu),)

    def encode(self, st: ActorModelState) -> np.ndarray:
        words = np.zeros(self.state_width, dtype=np.uint32)
        for i in range(self.n):
            words[i] = self._encode_node(st.actor_states[i])
            # The menu must be the derivable one, or decode cannot
            # rebuild it.
            assert st.random_choices[i] == self._choices_for(
                st.actor_states[i].local_clock
            ), st.random_choices[i]
        # Duplicate envelopes are reachable (a register-less SetValue
        # stamps the local clock without bumping the maximum used one, so
        # an identical broadcast can be sent while the first is in
        # flight): the multiset is repeated sorted codes.
        codes: List[int] = []
        for env, count in st.network.counts:
            codes.extend([self._env_code(env)] * count)
        if len(codes) > self.m:
            raise ValueError(
                f"{len(codes)} in-flight envelopes exceed {self.m} slots"
            )
        codes.sort()
        for k, c in enumerate(codes):
            words[self.n + k] = c
        return words

    def decode(self, words: Sequence[int]) -> ActorModelState:
        nodes = tuple(self._decode_node(int(words[i])) for i in range(self.n))
        counts: dict = {}
        for k in range(self.m):
            code = int(words[self.n + k])
            if code:
                env = self._env_of(code)
                counts[env] = counts.get(env, 0) + 1
        network = Network(
            kind="unordered_nonduplicating", counts=frozenset(counts.items())
        )
        return ActorModelState(
            actor_states=nodes,
            network=network,
            timers_set=(frozenset(),) * self.n,
            random_choices=tuple(self._choices_for(s.local_clock) for s in nodes),
            crashed=(False,) * self.n,
            history=self.model.init_history,
            actor_storages=(None,) * self.n,
        )

    # --- device side -------------------------------------------------------

    def step(self, states: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        nexts, valid, _flags, _conds = lww_step(states, self.n)
        return nexts, valid

    def property_conds(self, states: torch.Tensor) -> torch.Tensor:
        return lww_step(states, self.n)[3]

    def expand(self, states: torch.Tensor):
        nexts, valid, flags, conds = lww_step(states, self.n)
        if not fused_conds(self, LwwCompiled):
            conds = self.property_conds(states)
        return nexts, valid, conds, flags.any()

    def walk_step(self, states: torch.Tensor, plain: bool = False):
        nexts, valid, flags, conds = (lww_step_plain if plain else lww_step)(
            states, self.n)
        if not fused_conds(self, LwwCompiled):
            conds = override_conds(self, states, plain)
        return nexts, valid, conds, flags


# --- the twin (masked int64 over the u32 words) --------------------------------


def _fields(word: torch.Tensor) -> dict:
    return dict(
        present=word & 1,
        val=(word >> 1) & 3,
        ts=(word >> 3) & 63,
        up=(word >> 9) & 3,
        clock=(word >> 11) & 63,
        max_used=(word >> 17) & 63,
    )


def _node_word(present, val, ts, up, clock, max_used) -> torch.Tensor:
    """The JAX ``_node_word``: fields OR-ed in unmasked, in u32."""
    return (
        present | (val << 1) | (ts << 3) | (up << 9) | (clock << 11)
        | (max_used << 17)
    ) & M32


def _sorted_slots(cand: torch.Tensor, m: int):
    """Empty (0) as all-ones, sorted ascending (unsigned), back to 0: the
    first ``m`` and whether anything was left past them."""
    cand = torch.where(cand == 0, M32, cand)
    cand = torch.sort(cand, dim=-1).values
    head = cand[..., :m]
    return torch.where(head == M32, 0, head), (cand[..., m:] != M32).any(-1)


def lww_lanes_plain(states: torch.Tensor, n: int):
    """Every lane of the JAX ``step`` over packed rows ``int32[F, n + 12]``:
    (int64[F, A, W] successors, bool[F, A] valid, bool[F, A] flags)."""
    m = NET_SLOTS
    x = u32(states)
    f_ = x.shape[0]
    node, slots = x[:, :n], x[:, n:]

    # Deliver(slot k), all k at once: [F, m].
    code = slots
    occupied = code != 0
    prev = torch.cat([torch.zeros_like(code[:, :1]), code[:, :-1]], dim=1)
    first = prev != code
    first[:, 0] = True
    e = (code - 1) & M32
    dst = (e >> 2) & 3
    mv, mt, mu = (e >> 4) & 3, (e >> 6) & 63, (e >> 12) & 3
    word = torch.zeros_like(code)
    for i in range(n):
        word = torch.where(dst == i, node[:, i : i + 1], word)
    f = _fields(word)
    a_wins = (f["present"] == 1) & (
        (f["ts"] > mt) | ((f["ts"] == mt) & (f["up"] > mu))
    )
    new_word = _node_word(
        1, torch.where(a_wins, f["val"], mv), torch.where(a_wins, f["ts"], mt),
        torch.where(a_wins, f["up"], mu), f["clock"], f["max_used"],
    )
    eye = torch.eye(m, dtype=torch.bool, device=states.device)
    d_slots, _ = _sorted_slots(
        torch.where(eye, 0, slots.unsqueeze(1).expand(f_, m, m)), m
    )
    d_head = torch.stack(
        [torch.where(dst == i, new_word, node[:, i : i + 1]) for i in range(n)],
        dim=-1,
    )
    nexts = [torch.cat([d_head, d_slots], dim=-1)]  # [F, m, W]
    valids = [occupied & first]
    flags = [torch.zeros_like(occupied)]

    # SelectRandom(node i, choice c).
    for i in range(n):
        f = _fields(node[:, i])
        has = f["present"] == 1
        for c in range(N_CHOICES):
            if c < 3:
                cv = torch.where(
                    has, torch.maximum(f["clock"], f["max_used"] + 1), f["clock"]
                )
                flag = cv > 63
                nw = _node_word(
                    1, c, cv, i, f["clock"], torch.where(has, cv, f["max_used"])
                )
                sends = torch.stack(
                    [(1 + (i | (p << 2) | (c << 4) | (cv << 6) | (i << 12))) & M32
                     for p in range(n)], dim=-1,
                )
                r_slots, overflow = _sorted_slots(torch.cat([slots, sends], -1), m)
                flag = flag | overflow
            else:
                if c == 4:  # SetTime(max(clock - 1, 0)): the offset floor
                    nclock = (f["clock"] - 1) & M32
                    flag = f["clock"] == 0
                else:  # SetTime(clock + 1)
                    nclock = f["clock"] + 1
                    flag = nclock > 63
                nw = _node_word(
                    f["present"], f["val"], f["ts"], f["up"], nclock, f["max_used"]
                )
                r_slots, _ = _sorted_slots(slots, m)
            head = [nw if j == i else node[:, j] for j in range(n)]
            nexts.append(torch.cat([torch.stack(head, -1), r_slots], -1).unsqueeze(1))
            valids.append(torch.ones((f_, 1), dtype=torch.bool, device=states.device))
            flags.append(flag.unsqueeze(1))
    return torch.cat(nexts, 1), torch.cat(valids, 1), torch.cat(flags, 1)


def lww_conds_plain(states: torch.Tensor, n: int) -> torch.Tensor:
    """The one ALWAYS condition, "eventually consistent": the network is
    not empty, or every register equals node 0's (no register on both
    sides agrees)."""
    x = u32(states)
    net_empty = (x[:, n:] == 0).all(dim=1)
    r0 = _fields(x[:, 0])
    agree = torch.ones_like(net_empty)
    for i in range(1, n):
        ri = _fields(x[:, i])
        same = (
            (ri["present"] == r0["present"]) & (ri["val"] == r0["val"])
            & (ri["ts"] == r0["ts"]) & (ri["up"] == r0["up"])
        )
        agree = agree & (same | ((ri["present"] == 0) & (r0["present"] == 0)))
    return (~net_empty | agree).unsqueeze(1)


def lww_step_plain(states: torch.Tensor, n: int):
    """Plain-torch twin of the K16 kernel (any device): ``int32[F, n + 12]
    -> (nexts int32[F, A, W], valid bool[F, A], flags bool[F], conds
    bool[F, 1])``; a state's flag is any of its valid lanes' encoding
    flags, as the JAX ``step`` returns it."""
    nexts, valid, flags = lww_lanes_plain(states, n)
    return i32(nexts), valid, (flags & valid).any(dim=1), lww_conds_plain(states, n)


# --- the kernel's wrapper ---------------------------------------------------------


def lww_step(states: torch.Tensor, n: int):
    """Successors, validity, per-state encoding flags and the property
    condition of packed LWW rows (K16): see :func:`lww_step_plain`."""
    if not 1 <= n <= MAX_NODES:
        raise ValueError(f"packed lww supports 1 to {MAX_NODES} nodes")
    if states.device.type == "cpu":
        return lww_step_plain(states, n)
    dev = states.device
    cuda.require(states, "states", torch.int32, 2, dev)
    w = n + NET_SLOTS
    if states.shape[1] != w:
        raise ValueError(f"states must be [F, {w}], got {tuple(states.shape)}")
    f = states.shape[0]
    a = NET_SLOTS + N_CHOICES * n
    nexts = torch.empty((f, a, w), dtype=torch.int32, device=dev)
    valid = torch.empty((f, a), dtype=torch.bool, device=dev)
    flags = torch.zeros((f,), dtype=torch.bool, device=dev)
    conds = torch.empty((f, 1), dtype=torch.bool, device=dev)
    fn = cuda.function(
        "lww_step", "sr_lww_step",
        [cuda.P, cuda.I64, cuda.I32, cuda.P, cuda.P, cuda.P, cuda.P, cuda.P],
    )
    lww_step.launches += 1
    code = fn(
        cuda.ptr(states), f, n, cuda.ptr(nexts), cuda.ptr(valid),
        cuda.ptr(flags), cuda.ptr(conds), cuda.stream(nexts),
    )
    cuda.check(code, "lww_step", "lww_step")
    return nexts, valid, flags, conds


lww_step.launches = 0
