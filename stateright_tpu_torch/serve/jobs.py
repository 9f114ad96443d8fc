"""Job specs of the checking service.

The counterpart of ``JobSpec`` in ``stateright_tpu/serve/jobs.py``: a job is
one check request, a registered workload (``serve/workloads.py``) plus
engine and configuration overrides.  The engine names are the JAX
package's, with ``gpu`` for its ``tpu`` and ``gpu_simulation`` for its
``tpu_simulation``.  The job lifecycle, the job store and the runner are
not ported yet.
"""

from __future__ import annotations

from typing import Optional

_ENGINES = (
    "gpu", "tiered", "sharded", "tiered-sharded", "bfs", "dfs",
    "simulation", "gpu_simulation",
)
_FINISH_WHEN = ("all", "any", "any_failures", "all_failures")


class JobSpec:
    """A validated check request (the ``POST /jobs`` body).

    Validation is loud and total: an unknown field, engine or finish_when
    is a ``ValueError`` when the job is submitted, never a dead job found
    later on a worker.
    """

    FIELDS = (
        "workload", "n", "network", "engine", "engine_kwargs", "symmetry",
        "target_max_depth", "target_state_count", "timeout", "finish_when",
        "seed", "threads", "priority", "portfolio", "use_knob_cache",
        "store",
    )

    def __init__(
        self,
        workload: str,
        n: Optional[int] = None,
        network: Optional[str] = None,
        engine: str = "gpu",
        engine_kwargs: Optional[dict] = None,
        symmetry: bool = False,
        target_max_depth: Optional[int] = None,
        target_state_count: Optional[int] = None,
        timeout: Optional[float] = None,
        finish_when: Optional[str] = None,
        seed: int = 0,
        threads: Optional[int] = None,
        priority: int = 0,
        portfolio: Optional[dict] = None,
        use_knob_cache: bool = True,
        store: bool = False,
    ):
        if not workload or not isinstance(workload, str):
            raise ValueError("workload must be a nonempty string")
        if engine not in _ENGINES:
            raise ValueError(
                f"unknown engine {engine!r} (one of {', '.join(_ENGINES)})"
            )
        if finish_when is not None and finish_when not in _FINISH_WHEN:
            raise ValueError(
                f"unknown finish_when {finish_when!r} "
                f"(one of {', '.join(_FINISH_WHEN)})"
            )
        if portfolio is not None:
            if not isinstance(portfolio, dict):
                raise ValueError("portfolio must be an object")
            unknown = set(portfolio) - {
                "size", "seed", "parallelism", "simulation",
            }
            if unknown:
                raise ValueError(
                    f"unknown portfolio field(s): {', '.join(sorted(unknown))}"
                )
            if int(portfolio.get("size", 0)) < 2:
                raise ValueError("portfolio.size must be >= 2")
        if engine_kwargs is not None and not isinstance(engine_kwargs, dict):
            raise ValueError("engine_kwargs must be an object")
        if engine_kwargs and engine in ("bfs", "dfs", "simulation"):
            # The host engines take no spawn kwargs; dropping them would let
            # a misplaced knob pass unreported.
            raise ValueError(
                f"engine {engine!r} takes no engine_kwargs "
                "(host-engine tuning is the threads field)"
            )
        if store:
            # The verification store journals single-card wavefront runs
            # (incr/): a portfolio's members explore property-dependently,
            # and other engines write no snapshot the store can keep.
            if engine != "gpu":
                raise ValueError(
                    "store requires engine 'gpu' (the verification "
                    "store journals single-card wavefront runs)"
                )
            if portfolio is not None:
                raise ValueError(
                    "store does not combine with portfolio jobs"
                )
        self.workload = workload
        self.n = None if n is None else int(n)
        self.network = network
        self.engine = engine
        self.engine_kwargs = dict(engine_kwargs or {})
        self.symmetry = bool(symmetry)
        self.target_max_depth = (
            None if target_max_depth is None else int(target_max_depth)
        )
        self.target_state_count = (
            None if target_state_count is None else int(target_state_count)
        )
        self.timeout = None if timeout is None else float(timeout)
        self.finish_when = finish_when
        self.seed = int(seed)
        self.threads = None if threads is None else int(threads)
        self.priority = int(priority)
        self.portfolio = None if portfolio is None else dict(portfolio)
        self.use_knob_cache = bool(use_knob_cache)
        self.store = bool(store)

    @classmethod
    def from_dict(cls, data: dict) -> "JobSpec":
        if not isinstance(data, dict):
            raise ValueError("job spec must be a JSON object")
        unknown = set(data) - set(cls.FIELDS)
        if unknown:
            raise ValueError(
                f"unknown job field(s): {', '.join(sorted(unknown))}"
            )
        if "workload" not in data:
            raise ValueError("job spec requires a workload")
        return cls(**data)

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.FIELDS}
