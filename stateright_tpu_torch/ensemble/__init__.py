"""Chaos-ensemble engine: fault-schedule sweeps in one batched device walk.

The counterpart of ``stateright_tpu/ensemble/``: ``schedule`` derives each
member's fault schedule from one seed, ``fate`` is the fault-fate function
per lane (the twins of K19's device functions) and K19 itself, and
``engine`` sweeps the members through the device walk and shrinks the best
failing one.  The host replay (``replay_repro``) is not ported yet.

Submodule imports are lazy, as in the JAX package.
"""

_EXPORTS = {
    "device_fault_fate": "fate",
    "link_seed_limbs": "fate",
    "partition_cuts": "fate",
    "rate_threshold": "fate",
    "EnsembleSchedule": "schedule",
    "member_seed": "schedule",
    "EnsembleResult": "engine",
    "run_ensemble": "engine",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from importlib import import_module

    return getattr(import_module(f".{module}", __name__), name)
