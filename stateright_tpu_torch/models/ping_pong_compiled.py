"""Bit-packed device form of the ping-pong actor model (kernel K13).

The counterpart of ``stateright_tpu/models/ping_pong_compiled.py``: the
state embeds the unordered duplicating network -- a set of envelopes that
persist across deliveries plus the last-delivered marker -- and the
actions are the actor layer's Deliver and Drop families with unordered
no-op suppression.  Packing, as in the JAX codec (``maintains_history=
False``; the constant history, timers, crash flags and storages need no
bits), over the 64-bit word pair lo | hi << 32:

- bits 0-3: actor 0's counter; bits 4-7: actor 1's (a counter can reach
  ``max_nat + 1`` before the boundary drops the row);
- bits 8..8+E: the envelope bitmap, E = 2 (max_nat + 2): ``Ping(v)``
  (always 0 -> 1) at id v, ``Pong(v)`` (1 -> 0) at id (max_nat + 2) + v;
- the next 5 bits: the last-delivered marker, 0 for none, else 1 + id.

Lanes: Deliver(e) for every possible envelope, then Drop(e) for each when
the network is lossy, so A = 2E lossy and E lossless.  The model is
bounded (both counters at most ``max_nat``), so the engine expands it in
one phase, and :func:`ping_pong_step` (K13, ``csrc/ping_pong_step.cu``)
applies the boundary to each successor it builds; its twin,
:func:`ping_pong_step_plain`, applies it after the step, as the JAX
engine does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..actor import Envelope, Id, Network
from ..actor.model import ActorModelState
from ..ops import cuda
from ..ops.u32 import M32, i32, u32
from ..parallel.compiled import CompiledModel, fused_conds, override_conds
from .ping_pong import Ping, Pong

_C0_SHIFT, _C1_SHIFT, _ENV_SHIFT = 0, 4, 8
MAX_NAT = 13  # the widest counter and bitmap the two words hold
N_PROPS = 6


class PingPongCompiled(CompiledModel):
    state_width = 2

    def __init__(self, model):
        self.model = model
        cfg = model.cfg
        if cfg.maintains_history:
            raise ValueError(
                "packed ping_pong supports maintains_history=False (the "
                "golden configurations)"
            )
        if not 0 <= cfg.max_nat <= MAX_NAT:
            raise ValueError(f"packed ping_pong supports max_nat <= {MAX_NAT}")
        if model.init_network.kind != "unordered_duplicating":
            raise ValueError("packed ping_pong needs the unordered_duplicating network")
        self.max_nat = cfg.max_nat
        self.lossy = bool(model.lossy_network)
        self.e = envelope_count(self.max_nat)
        self.last_shift = _ENV_SHIFT + self.e
        self.max_actions = 2 * self.e if self.lossy else self.e

    # --- envelope numbering ----------------------------------------------------

    def _env_id(self, env: Envelope) -> int:
        if isinstance(env.msg, Ping):
            assert (int(env.src), int(env.dst)) == (0, 1)
            return env.msg.value
        assert (int(env.src), int(env.dst)) == (1, 0)
        return (self.max_nat + 2) + env.msg.value

    def _env_of(self, env_id: int) -> Envelope:
        half = self.max_nat + 2
        if env_id < half:
            return Envelope(Id(0), Id(1), Ping(env_id))
        return Envelope(Id(1), Id(0), Pong(env_id - half))

    # --- host side ---------------------------------------------------------------

    def encode(self, s: ActorModelState) -> np.ndarray:
        bits = int(s.actor_states[0]) << _C0_SHIFT
        bits |= int(s.actor_states[1]) << _C1_SHIFT
        for env in s.network.envelopes:
            bits |= 1 << (_ENV_SHIFT + self._env_id(env))
        last = s.network.last_msg
        bits |= ((1 + self._env_id(last)) if last is not None else 0) << self.last_shift
        return np.array([bits & M32, bits >> 32], dtype=np.uint32)

    def decode(self, words: Sequence[int]) -> ActorModelState:
        bits = int(words[0]) | (int(words[1]) << 32)
        envs = frozenset(
            self._env_of(e) for e in range(self.e) if (bits >> (_ENV_SHIFT + e)) & 1
        )
        last_code = (bits >> self.last_shift) & 0x1F
        if last_code:
            network = Network.new_unordered_duplicating_with_last_msg(
                envs, self._env_of(last_code - 1)
            )
        else:
            network = Network.new_unordered_duplicating(envs)
        return ActorModelState(
            actor_states=((bits >> _C0_SHIFT) & 0xF, (bits >> _C1_SHIFT) & 0xF),
            network=network,
            timers_set=(frozenset(), frozenset()),
            random_choices=((), ()),
            crashed=(False, False),
            history=(0, 0),
            actor_storages=(None, None),
        )

    # --- device side ---------------------------------------------------------------

    def step(self, states: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The JAX ``step``: every lane's successor and validity, before
        the boundary."""
        bits = _bits(states)
        nexts, valid = _lanes(bits, self.max_nat, self.lossy)
        return _words(nexts), valid

    def boundary(self, states: torch.Tensor) -> torch.Tensor:
        return _inside(_bits(states), self.max_nat)

    def property_conds(self, states: torch.Tensor) -> torch.Tensor:
        return ping_pong_step(states, self.max_nat, self.lossy, bounded=False)[2]

    def expand(self, states: torch.Tensor):
        nexts, valid, conds = ping_pong_step(states, self.max_nat, self.lossy)
        if not fused_conds(self, PingPongCompiled):
            conds = self.property_conds(states)
        return nexts, valid, conds, None

    def walk_step(self, states: torch.Tensor, plain: bool = False):
        nexts, valid, conds = (ping_pong_step_plain if plain else ping_pong_step)(
            states, self.max_nat, self.lossy, bounded=False)
        if not fused_conds(self, PingPongCompiled):
            conds = override_conds(self, states, plain)
        return nexts, valid, conds, None


def envelope_count(max_nat: int) -> int:
    """E: the possible envelopes, Ping(0..max_nat+1) and Pong(0..max_nat+1)."""
    return 2 * (max_nat + 2)


# --- the twin's arithmetic (int64 over the 64-bit word pair) --------------------


def _bits(states: torch.Tensor) -> torch.Tensor:
    """int32[..., 2] rows -> int64[...] of lo | hi << 32 (at most 44 bits
    are ever set)."""
    return u32(states[..., 0]) | (u32(states[..., 1]) << 32)


def _words(bits: torch.Tensor) -> torch.Tensor:
    return torch.stack([i32(bits), i32(bits >> 32)], dim=-1)


def _lanes(bits: torch.Tensor, max_nat: int, lossy: bool):
    """``bits`` int64[F] -> (int64[F, A] successors, bool[F, A] valid),
    the JAX ``step`` lane by lane: Deliver(e) then, lossy, Drop(e)."""
    half = max_nat + 2
    e_count = envelope_count(max_nat)
    last_shift = _ENV_SHIFT + e_count
    c0 = (bits >> _C0_SHIFT) & 0xF
    c1 = (bits >> _C1_SHIFT) & 0xF
    keep_last = ~(0x1F << last_shift)
    nexts, valids = [], []
    for e in range(e_count):
        present = ((bits >> (_ENV_SHIFT + e)) & 1) == 1
        if e < half:  # Ping(v): actor 1 counts up and answers Pong(v)
            v = e
            guard = c1 == v
            n = (bits & ~(0xF << _C1_SHIFT)) | ((c1 + 1) << _C1_SHIFT)
            n = n | (1 << (_ENV_SHIFT + half + v))
        else:  # Pong(v): actor 0 counts up and sends Ping(v + 1)
            v = e - half
            guard = c0 == v
            n = (bits & ~0xF) | (c0 + 1)
            n = n | (1 << (_ENV_SHIFT + v + 1))
        nexts.append((n & keep_last) | ((1 + e) << last_shift))
        valids.append(present & guard)
    if lossy:
        for e in range(e_count):
            nexts.append(bits & ~(1 << (_ENV_SHIFT + e)))
            valids.append(((bits >> (_ENV_SHIFT + e)) & 1) == 1)
    return torch.stack(nexts, dim=-1), torch.stack(valids, dim=-1)


def _inside(bits: torch.Tensor, max_nat: int) -> torch.Tensor:
    return (((bits >> _C0_SHIFT) & 0xF) <= max_nat) & (((bits >> _C1_SHIFT) & 0xF) <= max_nat)


def _conds(bits: torch.Tensor, max_nat: int) -> torch.Tensor:
    """The six properties in model order: delta within 1, can reach max,
    must reach max, must exceed max, #in <= #out, #out <= #in + 1 (the
    history is the constant (0, 0) when not maintained)."""
    c0 = (bits >> _C0_SHIFT) & 0xF
    c1 = (bits >> _C1_SHIFT) & 0xF
    at_max = (c0 == max_nat) | (c1 == max_nat)
    over_max = (c0 == max_nat + 1) | (c1 == max_nat + 1)
    true_ = torch.ones_like(at_max)
    return torch.stack(
        [(c0 - c1).abs() <= 1, at_max, at_max, over_max, true_, true_], dim=-1
    )


def ping_pong_step_plain(states: torch.Tensor, max_nat: int, lossy: bool,
                         bounded: bool = True):
    """Plain-torch twin of the K13 kernel (any device): ``int32[F, 2] ->
    (nexts int32[F, A, 2], valid bool[F, A], conds bool[F, 6])``, each
    lane's validity ANDed with its successor's boundary test (unless
    ``bounded`` is False: the JAX ``step`` alone)."""
    bits = _bits(states)
    nexts, valid = _lanes(bits, max_nat, lossy)
    if bounded:
        valid = valid & _inside(nexts, max_nat)
    return _words(nexts), valid, _conds(bits, max_nat)


# --- the kernel's wrapper ---------------------------------------------------------


def ping_pong_step(states: torch.Tensor, max_nat: int, lossy: bool,
                   bounded: bool = True):
    """Successors, boundary-gated validity and property conditions of
    packed ping-pong rows (K13): see :func:`ping_pong_step_plain`."""
    if not 0 <= max_nat <= MAX_NAT:
        raise ValueError(f"packed ping_pong supports max_nat <= {MAX_NAT}")
    if states.device.type == "cpu":
        return ping_pong_step_plain(states, max_nat, lossy, bounded)
    dev = states.device
    cuda.require(states, "states", torch.int32, 2, dev)
    if states.shape[1] != 2:
        raise ValueError(f"states must be [F, 2], got {tuple(states.shape)}")
    f = states.shape[0]
    a = envelope_count(max_nat) * (2 if lossy else 1)
    nexts = torch.empty((f, a, 2), dtype=torch.int32, device=dev)
    valid = torch.empty((f, a), dtype=torch.bool, device=dev)
    conds = torch.empty((f, N_PROPS), dtype=torch.bool, device=dev)
    fn = cuda.function(
        "ping_pong_step", "sr_ping_pong_step",
        [cuda.P, cuda.I64, cuda.I32, cuda.I32, cuda.I32, cuda.P, cuda.P,
         cuda.P, cuda.P],
    )
    ping_pong_step.launches += 1
    code = fn(
        cuda.ptr(states), f, max_nat, int(lossy), int(bounded), cuda.ptr(nexts),
        cuda.ptr(valid), cuda.ptr(conds), cuda.stream(nexts),
    )
    cuda.check(code, "ping_pong_step", "ping_pong_step")
    return nexts, valid, conds


ping_pong_step.launches = 0
