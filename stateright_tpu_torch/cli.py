"""The workload specs of the port's model modules.

The counterpart of ``CliSpec`` in ``stateright_tpu/cli.py``: each model
module with a ``cli_spec()`` names how its model is built from one integer
(and a network name, where it takes one), and the device geometry to start
from.  The workload registry (``serve/workloads.py``) resolves job specs
through it.  The fields that say ``tpu`` in the JAX package say ``gpu``
here, with the same values.  The port has no command-line verbs and no UDP
actor runtime yet, so the JAX spec's ``spawn`` and ``default_address``
fields are left out.
"""

from __future__ import annotations

from typing import Any, Callable, Optional


class CliSpec:
    def __init__(
        self,
        name: str,
        build: Callable[..., Any],  # build(n) or build(n, network) -> Model
        default_n: int,
        n_meta: str = "N",
        default_network: Optional[str] = None,
        symmetry: bool = False,
        gpu: bool = False,
        gpu_kwargs: Optional[dict] = None,
        target_max_depth: Optional[int] = None,
        gpu_target_max_depth: Optional[int] = None,
        ensemble: bool = False,
    ):
        self.name = name
        self.build = build
        self.default_n = default_n
        self.n_meta = n_meta
        self.default_network = default_network
        self.symmetry = symmetry
        self.gpu = gpu
        self.gpu_kwargs = gpu_kwargs or {}
        self.ensemble = ensemble
        self.target_max_depth = target_max_depth
        # The device run's depth bound, where the reference's default would
        # not fit one card (raft's 12 needs ~4·10^7 stored states).
        self.gpu_target_max_depth = gpu_target_max_depth
