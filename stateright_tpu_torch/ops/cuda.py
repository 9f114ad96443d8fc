"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with :mod:`ctypes` --
seconds per source, where a PyTorch C++ extension takes minutes.  Libraries
land in ``stateright_tpu_torch/_build/`` (git-ignored) on first use and are
reused while they are newer than their source and the shared header.
:func:`build` compiles stale sources with one ``nvcc`` process each, all
started together.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()`` after its launches; :func:`check` raises on a nonzero
code.  A launch takes its stream from a tensor it writes (:func:`stream`)
and runs under that tensor's device (:func:`function`'s entries), so a
kernel of a shard on another card launches there, whatever the current
device.  Nothing here runs on import: the CPU tests import every module of the
package on a machine with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = (
    "device_fp", "twophase_step", "compact", "hashset",
    "paxos_valid", "paxos_lane", "paxos_conds", "wave_eval",
    "single_copy_step", "abd_step", "raft_step",
    "prededup", "ping_pong_step", "paxos_step",
    "canon", "lww_step", "fixtures_step",
    "walk", "fate", "cold", "recheck", "gang", "append",
    "exchange", "shard_commit", "wave_ctl",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

P = ctypes.c_void_p
I32 = ctypes.c_int
U32 = ctypes.c_uint32
I64 = ctypes.c_int64
U64 = ctypes.c_uint64

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[tuple, "_Entry"] = {}


class Stream:
    """A launch's stream: the current stream of a tensor's device, and that
    device, under which the launch runs."""

    def __init__(self, device: torch.device):
        self.device = device
        self.handle = P(torch.cuda.current_stream(device).cuda_stream)


class _Entry:
    """A C entry point whose last argument is a :class:`Stream`: the call
    runs under the stream's device, so the kernel launches on the card
    that holds its tensors, not on the current one."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        s = args[-1]
        if not isinstance(s, Stream):
            raise TypeError("a launch's last argument is cuda.stream(tensor)")
        if s.device.index == torch.cuda.current_device():
            return self.fn(*args[:-1], s.handle)
        with torch.cuda.device(s.device):
            return self.fn(*args[:-1], s.handle)


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``'s, or
    the one on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built on the "
            "machine with the card (set CUDA_HOME)"
        )
    return found


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    newest = max(
        p.stat().st_mtime
        for p in [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    )
    return lib.stat().st_mtime < newest


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every stale source among ``names``, one ``nvcc`` each, all
    started together.  Returns the wall seconds of each compile that ran;
    ``nvcc``'s output (with ``-Xptxas -v``'s register counts) is kept in
    ``_build/<name>.log``.  Raises with the compiler's output on failure,
    after stopping every compile it started."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    procs = {}
    try:
        for name in todo:
            tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
            cmd = [cc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
            procs[name] = (proc, time.monotonic(), tmp)
        secs = {}
        for name, (proc, t0, tmp) in procs.items():
            out, _ = proc.communicate()
            (BUILD_DIR / f"{name}.log").write_text(out)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu:\n{out}")
            os.replace(tmp, _lib_path(name))
            secs[name] = time.monotonic() - t0
        return secs
    finally:
        for proc, _t0, tmp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()


def function(lib_name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of ``lib<lib_name>.so`` (built on first
    use) with its argument types declared -- pointers and the stream as
    ``c_void_p``, so ctypes never cuts them to 32 bits -- called with a
    :func:`stream` last, under whose device it launches."""
    fn = _FUNCS.get((lib_name, symbol))
    if fn is not None:
        return fn
    fn = getattr(_library(lib_name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = I32
    entry = _FUNCS[(lib_name, symbol)] = _Entry(fn)
    return entry


def host_function(lib_name: str, symbol: str, argtypes, restype):
    """A C helper of ``lib<lib_name>.so`` that launches nothing (a size
    query), looked up once and called directly, with no stream."""
    fn = _FUNCS.get((lib_name, symbol))
    if fn is None:
        fn = getattr(_library(lib_name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _FUNCS[(lib_name, symbol)] = fn
    return fn


def _library(lib_name: str) -> ctypes.CDLL:
    """``lib<lib_name>.so``, built and loaded on first use."""
    lib = _LIBS.get(lib_name)
    if lib is None:
        build([lib_name])
        lib = ctypes.CDLL(str(_lib_path(lib_name)))
        lib.sr_error_string.argtypes = [I32]
        lib.sr_error_string.restype = ctypes.c_char_p
        _LIBS[lib_name] = lib
    return lib


def check(code: int, lib_name: str, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if code:
        msg = _LIBS[lib_name].sr_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def ptr(t: torch.Tensor) -> P:
    return P(t.data_ptr())


def stream(t: torch.Tensor) -> Stream:
    """The stream a launch on ``t``'s card runs on: that device's current
    stream (not the current device's)."""
    return Stream(t.device)


def resolve_device(device, what: str) -> torch.device:
    """An entry point's ``device`` (default ``cuda``) resolved to a
    concrete device; raises where it names CUDA and no card is present --
    nothing carries on on the CPU unless the caller asks for
    ``device="cpu"``."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what}: no CUDA device is available; pass device='cpu' to "
                "run the plain-torch twins on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
            device: torch.device) -> None:
    """Reject what a kernel does not take: wrong dtype, rank or device, or
    a non-contiguous layout."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
