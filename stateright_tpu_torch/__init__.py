"""stateright_tpu_torch -- the PyTorch/CUDA port of stateright_tpu.

The JAX package ``stateright_tpu`` checks models on a TPU; this package runs
the same wavefront checker on one NVIDIA H100, with its device work in
kernels written by hand for Hopper (``csrc/``), each beside a plain-torch
twin that runs for CPU tensors.  It imports neither ``jax`` nor anything
of ``stateright_tpu``.

    from stateright_tpu_torch.models.twophase import TwoPhaseSys
    TwoPhaseSys(rm_count=10).checker().spawn_gpu().join()

    from stateright_tpu_torch.actor import Network
    from stateright_tpu_torch.models.paxos import PaxosModelCfg
    PaxosModelCfg(3, 3, Network.new_unordered_nonduplicating()) \
        .into_model().checker().spawn_gpu().join()
"""

from .core.checker import Checker, CheckerBuilder
from .core.has_discoveries import HasDiscoveries
from .core.model import Expectation, Model, Property
from .core.path import NondeterminismError, Path
from .core.report import ReportData, ReportDiscovery, Reporter, WriteReporter
from .ops.fingerprint import fingerprint

__all__ = [
    "Checker",
    "CheckerBuilder",
    "Expectation",
    "HasDiscoveries",
    "Model",
    "NondeterminismError",
    "Path",
    "Property",
    "ReportData",
    "ReportDiscovery",
    "Reporter",
    "WriteReporter",
    "fingerprint",
]
