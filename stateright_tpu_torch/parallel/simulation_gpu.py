"""Stochastic checking on the card: batched random trace walks.

The counterpart of ``stateright_tpu/parallel/simulation_tpu.py``.  A batch
of walkers walks random traces in lockstep, each with its own JAX PRNG key
(``ops/prng.py``, the threefry stream bit for bit), fingerprint history
(for the per-trace cycle check), eventually-bits and discovery latches.
The JAX walk is one jitted ``fori_loop`` vmapped over keys; here the host
runs the loop over steps and each step is a few kernel launches over the
whole batch:

1. the model's ``boundary`` of the states the walkers stand on, if it has
   one;
2. K1 (``device_fp64``) on their identity prefix;
3. the model's ``walk_step`` (``compiled.py``): every lane's successor and
   validity with NO successor boundary, the property conds and each
   state's encoding-overflow flag;
4. in an ensemble, K19 (``ensemble/fate.py``): the lanes each member's
   fault schedule blocks at this step;
5. K18 (``csrc/walk.cu``): per walker, the cycle check against its
   history, the append, the counts, the ALWAYS/SOMETIMES latches and
   eventually-bits, the flag, the fault hook's counters, JAX's ``split`` +
   ``randint`` draw and the choice of the j-th valid lane.

K18 also has an entry that derives the walkers' keys (``fold_in`` of a
base key by walker index), one that draws each walker's init state (the
walk's first ``split`` + ``randint``), and one that runs the leftover
eventually check after the last step.  Every walker draws every step,
finished or not, as JAX's does, so the key stream never depends on the
path; the host stops early once every walker is done, which changes no
output.

Semantics mirrored from the JAX walk (and the host simulation engine):

- properties are evaluated at every counted state; an always-violation or
  sometimes-satisfaction latches the walker's first hit;
- a trace ends at a cycle (the repeated fingerprint joins the trace but is
  not counted), a boundary exit, or a terminal state (no valid lane);
- leftover eventually-bits at a trace that ended are counterexamples;
  traces cut by the depth bound skip that check;
- there is no global dedup: ``unique_state_count == state_count``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.checker import Checker
from ..core.model import Expectation
from ..core.path import Path
from ..ops import cuda, prng
from ..ops.device_fp import device_fp64, device_fp64_plain
from ..ops.u32 import M32, from_numpy_u32, i32, to_numpy_u32, u32
from .compiled import CompiledModel, compiled_model_for

NO_STEP = 0xFFFFFFFF
_NO_STEP_I32 = -1  # NO_STEP's int32 bit-view


# --- the property layout K18 reads --------------------------------------------


@dataclass(frozen=True)
class WalkProps:
    """The properties as K18 takes them: bit p of ``always``/``sometimes``
    marks property p's expectation; bit p of ``eventually`` marks an
    eventually property, whose eventually-bit is its rank among them."""

    count: int
    always: int
    sometimes: int
    eventually: int

    @staticmethod
    def of(properties) -> "WalkProps":
        if len(properties) > 32:
            raise ValueError("at most 32 properties supported on device")
        bits = {e: 0 for e in Expectation}
        for p, prop in enumerate(properties):
            bits[prop.expectation] |= 1 << p
        return WalkProps(
            len(properties), bits[Expectation.ALWAYS],
            bits[Expectation.SOMETIMES], bits[Expectation.EVENTUALLY],
        )

    def eventually_indices(self) -> List[int]:
        return [p for p in range(self.count) if (self.eventually >> p) & 1]


@dataclass
class WalkCarry:
    """A batch of B walkers' state across the steps of a T-step walk (u32
    words as int32 bit-views): the row each stands on, its fingerprint
    history ``[T, B]`` (step-major, so a step's reads coalesce), its trace
    ``[B, T, W]``, remaining eventually-bits, discovery indices, done,
    counts, the overflow flag, its key, and the fault hook's per-lane
    datagram counters (None without a hook)."""

    state: torch.Tensor
    hist_hi: torch.Tensor
    hist_lo: torch.Tensor
    trace: torch.Tensor
    ebits: torch.Tensor
    disc: torch.Tensor
    done: torch.Tensor
    counted: torch.Tensor
    appended: torch.Tensor
    flag: torch.Tensor
    key: torch.Tensor
    ctr: Optional[torch.Tensor] = None

    @staticmethod
    def empty(keys: torch.Tensor, t_max: int, width: int, props: WalkProps,
              lanes: Optional[int]) -> "WalkCarry":
        b, dev = keys.shape[0], keys.device
        n_ev = bin(props.eventually).count("1")

        def z(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return WalkCarry(
            state=z(b, width),
            hist_hi=z(t_max, b),
            hist_lo=z(t_max, b),
            trace=z(b, t_max, width),
            ebits=torch.full((b,), i32(torch.tensor((1 << n_ev) - 1)).item(),
                             dtype=torch.int32, device=dev),
            disc=torch.full((b, props.count), _NO_STEP_I32, dtype=torch.int32,
                            device=dev),
            done=z(b, dtype=torch.bool),
            counted=z(b),
            appended=z(b),
            flag=z(b, dtype=torch.bool),
            key=keys.clone(),
            ctr=None if lanes is None else z(b, lanes),
        )


# --- K18's entries and their plain twins ----------------------------------------


def _fn(symbol: str, argtypes):
    return cuda.function("walk", symbol, argtypes)


def _ptr_or_null(t: Optional[torch.Tensor]):
    return cuda.P(0) if t is None else cuda.ptr(t)


def walker_keys(base: torch.Tensor, w0: int, n: int, device) -> torch.Tensor:
    """``fold_in(base, w0 + b)`` for walkers b = 0..n-1 (the JAX
    checker's ``fold_in(round key, w)``): ``int32[n, 2]`` on ``device``.
    ``base`` is one key, ``int32[1, 2]`` on the CPU.  K18's keys entry on
    a CUDA device."""
    device = torch.device(device)
    if device.type == "cpu":
        return walker_keys_plain(base, w0, n, device)
    k0, k1 = (int(x) & M32 for x in base.reshape(-1).tolist())
    keys = torch.empty((n, 2), dtype=torch.int32, device=device)
    fn = _fn("sr_walk_keys", [cuda.U32, cuda.U32, cuda.U32, cuda.I64, cuda.P, cuda.P])
    walker_keys.launches += 1
    code = fn(k0, k1, w0 & M32, n, cuda.ptr(keys), cuda.stream(keys))
    cuda.check(code, "walk", "walker_keys")
    return keys


walker_keys.launches = 0


def walker_keys_plain(base: torch.Tensor, w0: int, n: int, device="cpu") -> torch.Tensor:
    """Plain-torch twin of K18's keys entry."""
    idx = torch.arange(w0, w0 + n, dtype=torch.int64, device=device)
    return prng.fold_in(base.to(device).expand(n, 2), idx)


def walk_init(carry: WalkCarry, init: torch.Tensor) -> None:
    """Each walker's first draw (K18's init entry): ``key, sub =
    split(key)`` and the init row ``init[randint(sub, n_init)]`` becomes
    the row it stands on."""
    if carry.key.device.type == "cpu":
        return walk_init_plain(carry, init)
    b, w = carry.state.shape
    fn = _fn("sr_walk_init", [cuda.I64, cuda.I32, cuda.I32, cuda.P, cuda.P, cuda.P, cuda.P])
    walk_init.launches += 1
    code = fn(b, init.shape[0], w, cuda.ptr(init), cuda.ptr(carry.key),
              cuda.ptr(carry.state), cuda.stream(carry.key))
    cuda.check(code, "walk", "walk_init")


walk_init.launches = 0


def walk_init_plain(carry: WalkCarry, init: torch.Tensor) -> None:
    """Plain-torch twin of K18's init entry (any device)."""
    key, sub = prng.split(carry.key)
    idx = prng.randint(sub, init.shape[0]).long()
    carry.key.copy_(key)
    carry.state.copy_(init[idx])


def walk_step(carry: WalkCarry, t: int, props: WalkProps, hi, lo,
              in_bound, nexts, valid, conds, flags, blocked=None) -> None:
    """One step of every walker (K18), in place on ``carry``: see the
    module docstring.  ``in_bound`` (``bool[B]``, or None for an unbounded
    model), ``flags`` (``bool[B]`` or None) and ``blocked`` (K19's
    ``bool[B, A]``, or None without a fault hook) are optional."""
    if carry.key.device.type == "cpu":
        return walk_step_plain(carry, t, props, hi, lo, in_bound, nexts,
                               valid, conds, flags, blocked)
    b, w = carry.state.shape
    t_max = carry.hist_hi.shape[0]
    a = valid.shape[1]
    dev = carry.state.device
    cuda.require(nexts, "nexts", torch.int32, 3, dev)
    cuda.require(valid, "valid", torch.bool, 2, dev)
    cuda.require(conds, "conds", torch.bool, 2, dev)
    if tuple(nexts.shape) != (b, a, w) or tuple(conds.shape) != (b, props.count):
        raise ValueError("walk_step: nexts, valid and conds do not fit the batch")
    for name, x in (("in_bound", in_bound), ("flags", flags)):
        if x is not None:
            cuda.require(x, name, torch.bool, 1, dev)
    if (blocked is None) != (carry.ctr is None):
        raise ValueError("walk_step: blocked lanes and counters come together")
    if blocked is not None:
        cuda.require(blocked, "blocked", torch.bool, 2, dev)
    fn = _fn("sr_walk_step", [
        cuda.I32, cuda.I32, cuda.I64, cuda.I32, cuda.I32, cuda.I32,
        cuda.U32, cuda.U32, cuda.U32,
    ] + [cuda.P] * 21)
    walk_step.launches += 1
    code = fn(
        t, t_max, b, w, a, props.count,
        props.always, props.sometimes, props.eventually,
        cuda.ptr(hi), cuda.ptr(lo), _ptr_or_null(in_bound), cuda.ptr(nexts),
        cuda.ptr(valid), cuda.ptr(conds), _ptr_or_null(flags),
        _ptr_or_null(blocked), _ptr_or_null(carry.ctr),
        cuda.ptr(carry.state), cuda.ptr(carry.hist_hi), cuda.ptr(carry.hist_lo),
        cuda.ptr(carry.trace), cuda.ptr(carry.ebits), cuda.ptr(carry.disc),
        cuda.ptr(carry.done), cuda.ptr(carry.counted), cuda.ptr(carry.appended),
        cuda.ptr(carry.flag), cuda.ptr(carry.key), cuda.stream(carry.key),
    )
    cuda.check(code, "walk", "walk_step")


walk_step.launches = 0


def walk_step_plain(carry: WalkCarry, t: int, props: WalkProps, hi, lo,
                    in_bound, nexts, valid, conds, flags, blocked=None) -> None:
    """Plain-torch twin of K18's step entry (any device): the JAX walk's
    loop body (``simulation_tpu.py:127-199``), batched."""
    c = carry
    b, t_max = c.state.shape[0], c.hist_hi.shape[0]
    dev = c.state.device
    rows = torch.arange(b, device=dev)
    active = ~c.done
    end_boundary = active & ~in_bound if in_bound is not None else torch.zeros_like(active)
    steps = torch.arange(t_max, device=dev)[:, None]
    seen = ((c.hist_hi == hi[None]) & (c.hist_lo == lo[None])
            & (steps < c.appended[None].long())).any(dim=0)
    do_append = active & ~end_boundary
    at = torch.nonzero(do_append).flatten()
    idx = c.appended[at].long()
    c.hist_hi[idx, at] = hi[at]
    c.hist_lo[idx, at] = lo[at]
    c.trace[at, idx] = c.state[at]
    c.appended += do_append.to(torch.int32)
    end_cycle = do_append & seen
    count_this = do_append & ~seen
    c.counted += count_this.to(torch.int32)
    here = c.appended - 1
    for p in range(props.count):
        if (props.always >> p) & 1:
            hit = count_this & ~conds[:, p]
        elif (props.sometimes >> p) & 1:
            hit = count_this & conds[:, p]
        else:
            continue
        latch = hit & (c.disc[:, p] == _NO_STEP_I32)
        c.disc[:, p] = torch.where(latch, here, c.disc[:, p])
    eb = u32(c.ebits)
    for bit, p in enumerate(props.eventually_indices()):
        eb = eb & ~((count_this & conds[:, p]).to(torch.int64) << bit)
    c.ebits.copy_(i32(eb))
    if flags is not None:
        c.flag |= flags & count_this
    lanes = valid & count_this[:, None]
    if blocked is not None:
        c.ctr += lanes.to(torch.int32)
        lanes = lanes & ~blocked
    v = lanes.sum(dim=1)
    terminal = count_this & (v == 0)
    key, sub = prng.split(c.key)
    j = prng.randint(sub, v.clamp(min=1)).long()
    hitlane = lanes.long().cumsum(dim=1) == (j + 1)[:, None]
    lane = hitlane.to(torch.int32).argmax(dim=1)
    advance = count_this & (v > 0)
    c.state.copy_(torch.where(advance[:, None], nexts[rows, lane], c.state))
    c.done |= end_boundary | end_cycle | terminal
    c.key.copy_(key)


def walk_finish(carry: WalkCarry, props: WalkProps) -> None:
    """The leftover-eventually pass after the last step (K18's finish
    entry): a walker whose trace ended with an eventually-bit still set
    latches that property at its last state; a trace cut by the depth
    bound (never done) is skipped."""
    if carry.key.device.type == "cpu":
        return walk_finish_plain(carry, props)
    b = carry.state.shape[0]
    fn = _fn("sr_walk_finish", [cuda.I64, cuda.I32, cuda.U32, cuda.P, cuda.P, cuda.P,
                                cuda.P, cuda.P])
    walk_finish.launches += 1
    code = fn(b, props.count, props.eventually, cuda.ptr(carry.done),
              cuda.ptr(carry.ebits), cuda.ptr(carry.appended),
              cuda.ptr(carry.disc), cuda.stream(carry.disc))
    cuda.check(code, "walk", "walk_finish")


walk_finish.launches = 0


def walk_finish_plain(carry: WalkCarry, props: WalkProps) -> None:
    """Plain-torch twin of K18's finish entry (any device)."""
    c = carry
    eb = u32(c.ebits)
    for bit, p in enumerate(props.eventually_indices()):
        left = c.done & (((eb >> bit) & 1) == 1)
        latch = left & (c.disc[:, p] == _NO_STEP_I32)
        c.disc[:, p] = torch.where(latch, c.appended - 1, c.disc[:, p])


# --- the walk ------------------------------------------------------------------


class Walk:
    """A bounded random-trace walk of a batch (the JAX ``build_walk``):
    ``walk(keys[, params]) -> (trace [B, T, W], disc [B, P], counted [B],
    appended [B], flag [B])`` on the keys' device, ``disc[b, p]`` the trace
    index of property p's first discovery (``NO_STEP``'s bit-view -1 if
    none) and ``flag`` the step's encoding-overflow alarm of a counted
    state.  With ``plain`` every kernel's twin runs instead (on any
    device), the card's walk's reference."""

    def __init__(self, compiled: CompiledModel, properties, t_max: int,
                 fault_hook=None, plain: bool = False):
        self.cm = compiled
        self.props = WalkProps.of(properties)
        self.t_max = int(t_max)
        self.hook = fault_hook
        self.plain = plain
        self.init = compiled.init_packed()
        probe = torch.zeros((1, compiled.state_width), dtype=torch.int32)
        self.has_boundary = compiled.boundary(probe) is not None
        self.fp_words = compiled.fp_words or compiled.state_width
        self.steps_run = 0  # steps of the last call (early exit included)

    def start(self, keys: torch.Tensor) -> WalkCarry:
        """The batch's carry after each walker's init draw."""
        lanes = None if self.hook is None else self.hook.n_lanes
        c = WalkCarry.empty(keys, self.t_max, self.cm.state_width, self.props, lanes)
        init = from_numpy_u32(self.init, keys.device)
        (walk_init_plain if self.plain else walk_init)(c, init)
        return c

    def step_inputs(self, c: WalkCarry, t: int, params=None) -> dict:
        """What K18's step ``t`` takes besides the carry: the boundary of
        the rows the walkers stand on, their fingerprints (K1), the model's
        ``walk_step`` and, with a hook, K19's blocked lanes."""
        cm, plain = self.cm, self.plain
        hi, lo = (device_fp64_plain if plain else device_fp64)(
            c.state[:, : self.fp_words])
        nexts, valid, conds, flags = cm.walk_step(c.state, plain=plain)
        return dict(
            in_bound=cm.boundary(c.state) if self.has_boundary else None,
            hi=hi, lo=lo, nexts=nexts, valid=valid, conds=conds, flags=flags,
            blocked=(None if self.hook is None
                     else self.hook.apply(t, c.ctr, params, plain=plain)),
        )

    def __call__(self, keys: torch.Tensor, params=None):
        c = self.start(keys)
        step = walk_step_plain if self.plain else walk_step
        t = 0
        while t < self.t_max:
            step(c, t, self.props, **self.step_inputs(c, t, params))
            t += 1
            # Nothing changes for a done walker but its key, which is not
            # returned: stop once all are done (a readback every 8 steps).
            if t % 8 == 0 and t < self.t_max and bool(c.done.all()):
                break
        self.steps_run = t
        (walk_finish_plain if self.plain else walk_finish)(c, self.props)
        return c.trace, c.disc, c.counted, c.appended, c.flag


def build_walk(compiled, properties, t_max: int, fault_hook=None, plain=False) -> Walk:
    """The batched walk of ``compiled`` (the JAX ``build_walk``, which the
    JAX callers vmap; this one takes the whole batch's keys)."""
    return Walk(compiled, properties, t_max, fault_hook, plain)


class GpuSimulationChecker(Checker):
    """Monte-carlo checker running ``walkers`` traces per device batch (the
    JAX ``TpuSimulationChecker``)."""

    def __init__(
        self,
        options,
        seed: int,
        walkers: int = 1024,
        max_trace_len: Optional[int] = None,
        device=None,
    ):
        super().__init__(options.model)
        if options._symmetry is not None:
            raise ValueError(
                "spawn_gpu_simulation() does not support symmetry reduction"
            )
        self._device = cuda.resolve_device(device, "spawn_gpu_simulation()")
        self._options = options
        self._seed = seed
        self._walkers = walkers
        # The walk is bounded; target_max_depth (if set) is exactly the
        # host's depth bound, otherwise a generous default.
        self._t = max_trace_len or options._target_max_depth or 256
        self._compiled = compiled_model_for(options.model)
        self._properties = self._model.properties()
        self._state_count = 0
        self._max_depth = 0
        self._rounds = 0
        self._discovery_fps: Dict[str, List[int]] = {}
        self._discoveries_cache: Optional[Dict[str, Path]] = None
        self._done = threading.Event()
        self._errors: List[BaseException] = []
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            if self._device.type == "cuda":
                torch.cuda.set_device(self._device)
            self._check()
        except BaseException as e:  # propagate at join, like the host engine
            self._errors.append(e)
        finally:
            self._done.set()

    def _check(self) -> None:
        opts = self._options
        props = self._properties
        deadline = (
            time.monotonic() + opts._timeout if opts._timeout is not None else None
        )
        walk = build_walk(self._compiled, props, self._t)
        base = prng.prng_key(self._seed)
        round_idx = 0
        while not self.stop_requested():
            keys = walker_keys(prng.fold_in(base, round_idx), 0, self._walkers,
                               self._device)
            trace, disc_d, counted_d, appended_d, flag_d = walk(keys)
            disc = to_numpy_u32(disc_d)
            counted = to_numpy_u32(counted_d)
            appended = to_numpy_u32(appended_d)
            if bool(flag_d.any()):
                raise RuntimeError(
                    "the model step kernel flagged an encoding-capacity "
                    "overflow during a simulated trace"
                )
            # Only a discovered walker's trace prefix is read back.
            with self._lock:
                self._state_count += int(counted.sum(dtype=np.int64))
                self._max_depth = max(self._max_depth, int(appended.max(initial=0)))
                for p, prop in enumerate(props):
                    if prop.name in self._discovery_fps:
                        continue
                    hits = np.flatnonzero(disc[:, p] != NO_STEP)
                    if len(hits):
                        wkr = int(hits[0])
                        end = int(disc[wkr, p]) + 1
                        row = to_numpy_u32(trace[wkr, :end])
                        self._discovery_fps[prop.name] = [
                            self._model.fingerprint(self._compiled.decode(row[i]))
                            for i in range(end)
                        ]
                self._rounds += 1
            round_idx += 1
            if opts._finish_when.matches(frozenset(self._discovery_fps), props):
                return
            if (
                opts._target_state_count is not None
                and opts._target_state_count <= self._state_count
            ):
                return
            if deadline is not None and time.monotonic() >= deadline:
                return

    # --- Checker surface -----------------------------------------------------

    def state_count(self) -> int:
        return self._state_count

    def unique_state_count(self) -> int:
        # No global visited set, matching the host simulation engine.
        return self._state_count

    def max_depth(self) -> int:
        return self._max_depth

    def rounds(self) -> int:
        """Batches walked so far."""
        return self._rounds

    def discovered_fingerprints_of(self, name: str) -> Optional[List[int]]:
        """The host fingerprints of the discovery trace of ``name``."""
        with self._lock:
            fps = self._discovery_fps.get(name)
        return None if fps is None else list(fps)

    def discoveries(self) -> Dict[str, Path]:
        self.join()
        if self._discoveries_cache is None:
            with self._lock:
                items = list(self._discovery_fps.items())
            self._discoveries_cache = {
                name: Path.from_fingerprints(self._model, fps) for name, fps in items
            }
        return dict(self._discoveries_cache)

    def handles(self) -> List[threading.Thread]:
        return [self._thread]

    def is_done(self) -> bool:
        return self._done.is_set()

    def join(self) -> "GpuSimulationChecker":
        self._thread.join()
        if self._errors:
            raise self._errors[0]
        return self
