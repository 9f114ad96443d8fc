"""The service's workload registry.

The counterpart of ``stateright_tpu/serve/workloads.py``.  Every model
module under ``stateright_tpu_torch.models`` with a module-level
``cli_spec()`` is a servable workload: the spec tells the service how to
build the model and the device geometry to start from.  The registry is a
fixed allowlist: a job names a workload, never a module path.
"""

from __future__ import annotations

import importlib
from typing import List, Optional, Tuple

# Model modules with a cli_spec(); fixtures is the known-violating
# TrapCounter workload, and grid_walk the gang-batchable family
# (fleet/gang.py).  The JAX registry also serves "increment", whose model
# the port does not have yet.
SERVABLE = (
    "twophase",
    "paxos",
    "abd",
    "raft",
    "ping_pong",
    "lww_register",
    "single_copy_register",
    "fixtures",
    "grid_walk",
)


def workload_names() -> List[str]:
    return list(SERVABLE)


def cli_spec_for(workload: str):
    """The workload's CliSpec; ``ValueError`` on an unknown name."""
    if workload not in SERVABLE:
        raise ValueError(
            f"unknown workload {workload!r} "
            f"(one of: {', '.join(SERVABLE)})"
        )
    module = importlib.import_module(f"..models.{workload}", __package__)
    return module.cli_spec()


def build_model(
    workload: str, n: Optional[int] = None, network: Optional[str] = None
) -> Tuple[object, object, int]:
    """Build the workload's model: ``(model, cli_spec, resolved_n)``.
    ``n`` defaults to the spec's default; ``network`` (a name of the actor
    network registry) is resolved as a CLI's NETWORK argument is -- an
    unknown name raises, never a silent default."""
    from ..actor.network import Network

    spec = cli_spec_for(workload)
    resolved_n = spec.default_n if n is None else int(n)
    if spec.default_network is None:
        if network is not None:
            raise ValueError(
                f"workload {workload!r} takes no network parameter"
            )
        return spec.build(resolved_n), spec, resolved_n
    net = Network.from_name(network or spec.default_network)
    return spec.build(resolved_n, net), spec, resolved_n


def ensemble_capable(workload: str) -> bool:
    """Whether the workload supports chaos-ensemble sweeps
    (``ensemble/engine.py``): its CliSpec opted in.  Unknown names raise,
    as in :func:`cli_spec_for`."""
    return bool(getattr(cli_spec_for(workload), "ensemble", False))


def ensemble_winning_seeds(
    workload: str,
    *,
    members: int = 256,
    seed: int = 0,
    chaos=None,
    steps: int = 48,
    fault: Optional[str] = None,
    limit: int = 4,
    device=None,
) -> List[int]:
    """A chaos sweep ahead of a portfolio: one ensemble dispatch, and up to
    ``limit`` seeds of its failing members.  ``[]`` for a workload without
    ensemble support, so a scheduler may call it unconditionally.
    ``device`` defaults to ``cuda``, as every entry point of the port."""
    if not ensemble_capable(workload):
        return []
    from ..ensemble import run_ensemble

    result = run_ensemble(
        members=members, seed=seed, chaos=chaos, steps=steps,
        fault=fault, shrink=False, replay=False, device=device,
    )
    return [f["seed"] for f in result.failing[:limit]]


def workload_label(workload: str, n: int, network: Optional[str],
                   symmetry: bool = False) -> str:
    """The knob-cache label of one served workload configuration."""
    parts = [f"serve:{workload}", str(n)]
    if network:
        parts.append(network)
    if symmetry:
        parts.append("sym")
    return ":".join(parts)
