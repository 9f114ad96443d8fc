"""The fused wave loop's control (K29, ``csrc/wave_ctl.cu``) and the CUDA
graph that runs a quantum of waves on the card.

The counterpart of the JAX engine's fused program (``stateright_tpu/
parallel/wavefront.py:493`` ``_build_run``): its carry, its chunk slice,
the tail of its ``wave_body`` and its ``wave_cond``, run by one
``lax.while_loop`` between two readbacks of one stats vector.  Here the
carry's scalars live in one int32 tensor on the card -- the JAX stats
layout (``STAT_*``, then ``disc[P]``) followed by K29's own words
(``CTL_*``: the quantum's waves left, the loop's go word, the waves run,
the closed wave's append record and K4's claim epoch) -- and two kernel
entries keep every per-wave decision on the card:

- :func:`wave_load` copies the wave's chunk of the row log and its
  eventually-bits into fixed ``[F, W]`` buffers, reading ``level_start``
  from the stats, and marks the lanes inside the level active; the lanes
  past it hold copies of the chunk's first row;
- :func:`wave_ctl` closes the wave (flags, commit, discovery fold,
  counters, level roll) and evaluates the loop condition into the go
  word; with ``begin`` it opens a quantum.

:class:`WhileGraph` captures one wave of the engine (``torch.cuda.CUDAGraph``
with ``keep_graph=True``) and wraps it in a CUDA WHILE conditional node
whose condition is the go word: one launch runs the quantum, and a
stopped quantum runs no further wave.  On the CPU the engine runs the same
wave in a Python loop over the twins, stopping where :func:`wave_ctl_plain`
says.  Each wrapper counts its launches; :class:`WhileGraph` moves the
counts its capture made into counts per wave the graph ran.
"""

from __future__ import annotations

import ctypes
import sys
from typing import Dict, List, Tuple

import torch

from ..ops import cuda
from ..ops.u32 import M32
from .wave_common import NO_ID

# The JAX stats layout (``stateright_tpu/parallel/wavefront.py:64-74``).
(
    STAT_LEVEL_START,
    STAT_LEVEL_END,
    STAT_TAIL,
    STAT_SC_LO,
    STAT_SC_HI,
    STAT_UNIQUE,
    STAT_DEPTH,
    STAT_FLAGS,
) = range(8)
STAT_DISC = 8  # disc[P] at [STAT_DISC : STAT_DISC + P]
# K29's words, after disc[P] (offsets from STAT_DISC + P).
(
    CTL_WAVES_LEFT,
    CTL_GO,
    CTL_WAVES_RUN,
    CTL_WAVE_LO,
    CTL_WAVE_TAIL,
    CTL_WAVE_NEW,
    CTL_EPOCH,
) = range(7)
CTL_WORDS = 7


def stats_words(p: int) -> int:
    """The stats tensor's length for ``p`` properties."""
    return STAT_DISC + p + CTL_WORDS


def ctl_index(p: int, word: int) -> int:
    """The index of K29's ``word`` in a stats tensor of ``p`` properties."""
    return STAT_DISC + p + word


def wave_load(rows: torch.Tensor, ebits: torch.Tensor, stats: torch.Tensor,
              f: int, w: int):
    """The wave's chunk: ``(states int32[f, w], eb int32[f], active
    bool[f])`` from the flat row log and the ebits log at the stats'
    ``level_start``; lanes past ``level_end`` are inactive copies of the
    chunk's first row (K29's ``wave_load``)."""
    if rows.device.type == "cpu":
        return wave_load_plain(rows, ebits, stats, f, w)
    dev = rows.device
    for t, name in ((rows, "rows"), (ebits, "ebits"), (stats, "stats")):
        cuda.require(t, name, torch.int32, 1, dev)
    if f < 1 or w < 1:
        raise ValueError("the chunk and the row width must be positive")
    states = torch.empty((f, w), dtype=torch.int32, device=dev)
    eb = torch.empty((f,), dtype=torch.int32, device=dev)
    active = torch.empty((f,), dtype=torch.bool, device=dev)
    fn = cuda.function(
        "wave_ctl", "sr_wave_load",
        [cuda.P, cuda.P, cuda.P, cuda.I64, cuda.I32, cuda.P, cuda.P, cuda.P,
         cuda.P],
    )
    wave_load.launches += 1
    code = fn(cuda.ptr(rows), cuda.ptr(ebits), cuda.ptr(stats), f, w,
              cuda.ptr(states), cuda.ptr(eb), cuda.ptr(active),
              cuda.stream(states))
    cuda.check(code, "wave_ctl", "wave_load")
    return states, eb, active


wave_load.launches = 0


def wave_load_plain(rows, ebits, stats, f: int, w: int):
    """Plain-torch twin of K29's ``wave_load`` (any device)."""
    ls, le = (int(x) & M32 for x in stats[:2].tolist())
    count = min(max(le - ls, 0), f)
    dev = rows.device
    active = torch.arange(f, device=dev) < count
    if not count:
        return (torch.zeros((f, w), dtype=torch.int32, device=dev),
                torch.zeros((f,), dtype=torch.int32, device=dev), active)
    src = torch.where(active, torch.arange(f, device=dev), 0) + ls
    states = rows.view(-1, w)[src]
    return states, ebits[src], active


def wave_ctl(stats: torch.Tensor, p: int, *, begin: bool, waves: int,
             f_eff: int, f_full: int, cap: int, qcap: int, size: int,
             target: int, fw_masks: Tuple[int, int], n_new=None,
             n_valid=None, probe_ok=None, step_flag=None, dd_flag=None,
             cands=None) -> None:
    """K29's ``wave_ctl`` on ``stats`` (int32, :func:`stats_words` long), IN
    PLACE.  With ``begin``: open a quantum of ``waves`` waves (flags 0, the
    go word the loop condition).  Otherwise close the wave whose K3 counts
    ``n_new``/``n_valid`` (int64 scalars), K4 ``probe_ok`` (bool scalar),
    step and sorted-path overflow flags (bool scalars, or None) and K8
    discovery candidates ``cands`` (int64[p]) are given -- the JAX
    ``wave_body`` tail and ``wave_cond`` (``wavefront.py:684-789``).
    ``fw_masks`` is :func:`~stateright_tpu_torch.parallel.wave_common.
    finish_when_masks`; ``target`` the target depth (0 for none); ``size``
    the compaction buffer (flag 4 past it); ``f_eff``/``f_full`` the step
    rung and the full chunk (flag 128); ``cap``/``qcap`` the table's and
    the log's capacities (flags 1 and 2)."""
    if stats.device.type == "cpu":
        wave_ctl_plain(stats, p, begin=begin, waves=waves, f_eff=f_eff,
                       f_full=f_full, cap=cap, qcap=qcap, size=size,
                       target=target, fw_masks=fw_masks, n_new=n_new,
                       n_valid=n_valid, probe_ok=probe_ok,
                       step_flag=step_flag, dd_flag=dd_flag, cands=cands)
        return
    dev = stats.device
    cuda.require(stats, "stats", torch.int32, 1, dev)
    if stats.shape[0] != stats_words(p) or not 0 <= p <= 32:
        raise ValueError(f"stats must hold {stats_words(p)} words for p={p}")
    ptrs = [None] * 6
    if not begin:
        cuda.require(n_new, "n_new", torch.int64, 0, dev)
        cuda.require(n_valid, "n_valid", torch.int64, 0, dev)
        cuda.require(probe_ok, "probe_ok", torch.bool, 0, dev)
        cuda.require(cands, "cands", torch.int64, 1, dev)
        for t, name in ((step_flag, "step_flag"), (dd_flag, "dd_flag")):
            if t is not None:
                cuda.require(t, name, torch.bool, 0, dev)
        ptrs = [cuda.ptr(n_new), cuda.ptr(n_valid), cuda.ptr(probe_ok),
                None if step_flag is None else cuda.ptr(step_flag),
                None if dd_flag is None else cuda.ptr(dd_flag),
                cuda.ptr(cands)]
    fn = cuda.function(
        "wave_ctl", "sr_wave_ctl",
        [cuda.P, cuda.I32, cuda.P, cuda.P, cuda.P, cuda.P, cuda.P, cuda.P,
         cuda.I64, cuda.I64, cuda.I64, cuda.I64, cuda.I64, cuda.I64,
         cuda.U32, cuda.U32, cuda.I32, cuda.I32, cuda.P],
    )
    wave_ctl.launches += 1
    code = fn(cuda.ptr(stats), p, *ptrs, f_eff, f_full, cap, qcap, size,
              target, fw_masks[0], fw_masks[1], waves, int(begin),
              cuda.stream(stats))
    cuda.check(code, "wave_ctl", "wave_ctl")


wave_ctl.launches = 0


def _loop_cond(s: List[int], ctl: int, p: int, target: int, fw_masks) -> bool:
    go = (s[STAT_LEVEL_START] < s[STAT_LEVEL_END]
          and s[ctl + CTL_WAVES_LEFT] > 0 and s[STAT_FLAGS] == 0)
    if target:
        go = go and s[STAT_DEPTH] < target - 1
    found = sum(1 << q for q in range(p) if s[STAT_DISC + q] != NO_ID)
    fw_all, fw_any = fw_masks
    matched = (fw_all != 0 and found & fw_all == fw_all) or found & fw_any != 0
    return go and not matched


def wave_ctl_plain(stats, p: int, *, begin: bool, waves: int, f_eff: int,
                   f_full: int, cap: int, qcap: int, size: int, target: int,
                   fw_masks, n_new=None, n_valid=None, probe_ok=None,
                   step_flag=None, dd_flag=None, cands=None) -> None:
    """Plain twin of K29's ``wave_ctl`` (any device): the same words,
    computed on the host from one read of the stats and the wave's
    counts, written back in one copy."""
    s = [int(x) & M32 for x in stats.tolist()]
    ctl = STAT_DISC + p
    s[ctl + CTL_WAVES_LEFT] = (s[ctl + CTL_WAVES_LEFT] ^ 0x80000000) - 0x80000000
    if begin:
        s[STAT_FLAGS] = 0
        s[ctl + CTL_WAVES_LEFT] = waves
        s[ctl + CTL_WAVES_RUN] = 0
        s[ctl + CTL_WAVE_NEW] = 0
    else:
        ls, le, tail, unique = (s[STAT_LEVEL_START], s[STAT_LEVEL_END],
                                s[STAT_TAIL], s[STAT_UNIQUE])
        new, generated = int(n_new), int(n_valid)
        flags = s[STAT_FLAGS]
        if not bool(probe_ok) or (unique + new) * 2 > cap:
            flags |= 1
        if tail + new > qcap:
            flags |= 2
        if generated > size or (dd_flag is not None and bool(dd_flag)):
            flags |= 4
        if step_flag is not None and bool(step_flag):
            flags |= 8
        if f_eff < f_full and le - ls > f_eff:
            flags |= 128
        commit = flags == 0
        count = min(max(le - ls, 0), f_eff) if commit else 0
        appended = new if commit else 0
        if commit:
            for q, c in enumerate(cands.tolist()):
                if s[STAT_DISC + q] == NO_ID and c != NO_ID:
                    s[STAT_DISC + q] = c & M32
            total = s[STAT_SC_LO] + generated
            s[STAT_SC_LO] = total & M32
            s[STAT_SC_HI] = (s[STAT_SC_HI] + (total >> 32)) & M32
            s[STAT_UNIQUE] = unique + appended
            s[STAT_TAIL] = tail + appended
            s[STAT_LEVEL_START] = ls + count
            if ls + count >= le:
                s[STAT_DEPTH] += 1
                s[STAT_LEVEL_END] = tail + appended
        s[STAT_FLAGS] = flags
        s[ctl + CTL_WAVE_LO] = ls
        s[ctl + CTL_WAVE_TAIL] = tail
        s[ctl + CTL_WAVE_NEW] = appended
        s[ctl + CTL_WAVES_LEFT] -= 1
        s[ctl + CTL_WAVES_RUN] += 1
    s[ctl + CTL_GO] = int(_loop_cond(s, ctl, p, target, fw_masks))
    out = torch.tensor([((x & M32) ^ 0x80000000) - 0x80000000 for x in s],
                       dtype=torch.int32)
    stats.copy_(out)


# --- the quantum's graph -------------------------------------------------


def cuda_versions() -> Tuple[int, int]:
    """The CUDA runtime's and the driver's versions (12090 is 12.9)."""
    fn = cuda.function("wave_ctl", "sr_cuda_versions",
                       [ctypes.POINTER(ctypes.c_int)] * 2).fn
    rt, drv = ctypes.c_int(), ctypes.c_int()
    code = fn(ctypes.byref(rt), ctypes.byref(drv))
    cuda.check(code, "wave_ctl", "cuda_versions")
    return rt.value, drv.value


def _launch_counters() -> List:
    """Every kernel wrapper of the package loaded so far: the functions
    with an integer ``launches`` count."""
    seen, out = set(), []
    for name, mod in list(sys.modules.items()):
        if mod is None or not name.startswith("stateright_tpu_torch."):
            continue
        for v in list(vars(mod).values()):
            if callable(v) and isinstance(getattr(v, "launches", None), int):
                if id(v) not in seen:
                    seen.add(id(v))
                    out.append(v)
    return out


class WhileGraph:
    """One quantum's executable graph on the card: the wave ``body``
    captured once (its kernels and the torch glue between them, on the
    buffers it was given), wrapped in a WHILE conditional node on K29's go
    word.  :meth:`launch` runs waves until the go word is 0.  The capture's
    own wrapper counts are taken back and kept as counts per wave, which
    :meth:`count_waves` adds for each wave a launch ran."""

    def __init__(self, body, go: torch.Tensor, pool=None):
        counters = _launch_counters()
        before = {id(fn): fn.launches for fn in counters}
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(self.graph, pool=pool,
                              capture_error_mode="thread_local"):
            body()
        self.per_wave: Dict[int, Tuple[object, int]] = {}
        for fn in counters:
            delta = fn.launches - before[id(fn)]
            if delta:
                self.per_wave[id(fn)] = (fn, delta)
                fn.launches -= delta  # captured, not run
        build = cuda.function(
            "wave_ctl", "sr_while_graph",
            [cuda.P, cuda.P, ctypes.POINTER(ctypes.c_void_p)],
        ).fn
        exe = ctypes.c_void_p()
        code = build(cuda.P(self.graph.raw_cuda_graph()), cuda.ptr(go),
                     ctypes.byref(exe))
        cuda.check(code, "wave_ctl", "the quantum's WHILE graph")
        self._exec = exe
        self._go = go

    def launch(self) -> None:
        """Run the quantum on the current stream (no sync)."""
        fn = cuda.function("wave_ctl", "sr_graph_launch", [cuda.P, cuda.P])
        code = fn(self._exec, cuda.stream(self._go))
        cuda.check(code, "wave_ctl", "the quantum's graph launch")

    def count_waves(self, waves: int) -> None:
        """Add the captured launches of ``waves`` waves to the counts."""
        for fn, delta in self.per_wave.values():
            fn.launches += delta * waves

    def close(self) -> None:
        if self._exec:
            destroy = cuda.function("wave_ctl", "sr_graph_destroy",
                                    [cuda.P]).fn
            destroy(self._exec)
            self._exec = ctypes.c_void_p()
        self.graph = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

