"""Checker surface and fluent builder.

Reference: src/checker.rs -- ``CheckerBuilder`` (fluent config + spawn) and
the ``Checker`` trait (counts, discoveries, join/report, assertion helpers).
The port's builder carries the options its GPU engines read and spawns
them with :meth:`CheckerBuilder.spawn_gpu`,
:meth:`CheckerBuilder.spawn_gpu_tiered`,
:meth:`CheckerBuilder.spawn_gpu_sharded` and
:meth:`CheckerBuilder.spawn_gpu_simulation`, the counterparts of the JAX
package's ``spawn_tpu``, ``spawn_tpu_tiered``, ``spawn_tpu_sharded`` and
``spawn_tpu_simulation``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from .has_discoveries import HasDiscoveries
from .model import Expectation, Model
from .path import Path
from .report import ReportData, ReportDiscovery, Reporter
from .visitor import as_visitor


class CheckerBuilder:
    def __init__(self, model: Model):
        self.model = model
        self._target_state_count: Optional[int] = None
        self._target_max_depth: Optional[int] = None
        self._finish_when: HasDiscoveries = HasDiscoveries.ALL
        self._symmetry = None
        self._timeout: Optional[float] = None
        self._visitor = None

    def symmetry(self) -> "CheckerBuilder":
        """Reduce by symmetry (src/checker.rs:222-227): ``spawn_gpu``
        dedups on the fingerprint of each row's canonical form (the
        compiled model's ``canon_spec()``/``canon_rows``) while it logs
        the original rows, and raises where the compiled model declares
        no canonicalization."""
        return self.symmetry_fn(lambda s: s.representative())

    def symmetry_fn(self, representative) -> "CheckerBuilder":
        """Reduce by symmetry with a host ``representative`` function;
        the GPU engine reads only whether one is set and canonicalizes on
        the card."""
        self._symmetry = representative
        return self

    def finish_when(self, has_discoveries: HasDiscoveries) -> "CheckerBuilder":
        self._finish_when = has_discoveries
        return self

    def target_state_count(self, count: int) -> "CheckerBuilder":
        self._target_state_count = count if count > 0 else None
        return self

    def target_max_depth(self, depth: int) -> "CheckerBuilder":
        self._target_max_depth = depth if depth > 0 else None
        return self

    def visitor(self, visitor) -> "CheckerBuilder":
        """Visit every expanded state (a :class:`~.visitor.CheckerVisitor`
        or a callable taking a ``Path``).  :meth:`spawn_gpu` feeds it at
        wave granularity through its traced readback, so a visitor forces
        ``trace=True``: each state the search expands is visited once, as
        a single-state path, in BFS level order across waves and log order
        within a wave.  :meth:`spawn_gpu_tiered` refuses a visitor, as the
        JAX engine's tiered spawn does."""
        self._visitor = as_visitor(visitor)
        return self

    def timeout(self, seconds: float) -> "CheckerBuilder":
        """Stop the check after ``seconds`` of wall time, keeping its
        counts and discoveries (checked between waves, or between walk
        batches)."""
        self._timeout = seconds
        return self

    def spawn_gpu(self, **kwargs) -> "Checker":
        """Spawn the single-GPU wavefront checker (parallel/wavefront.py):
        successor expansion, fingerprinting, frontier dedup and property
        evaluation run on the card in hand-written kernels.  ``device``
        defaults to ``cuda``; with no card present the spawn raises -- pass
        ``device="cpu"`` explicitly to run the plain-torch twins.  Under
        :meth:`symmetry` the table holds canonical fingerprints.  It takes
        the JAX ``spawn_tpu`` arguments (``capacity``, ``log_capacity``,
        ``max_frontier``, ``dedup_factor``, ``sort_lanes``, ``sortless``,
        ``step_lanes``, ``waves_per_call``, ``auto_tune``, the journal and
        checkpoint knobs, ``resume_from``) with their defaults and
        meanings.  An untraced run is the JAX fused loop: a quantum of up
        to ``waves_per_call`` waves (256 by default, 1 where only the host
        can stop the run) behind one readback of the stats, the loop's
        control on the card (K29, ``parallel/fused.py``), the quantum one
        launch of a CUDA graph on the card and a loop over the twins on
        the CPU; the step rung (``step_lanes``, flag 128) and the density
        tuners run between quanta.  ``trace=True`` times each phase of
        every wave and charges it modeled bytes against the card's peak
        bandwidth (``obs/``; ``trace_summary()``); a :meth:`visitor`
        forces it on.  Traced runs keep one readback a wave."""
        from ..parallel.wavefront import GpuChecker

        return GpuChecker(self, **kwargs)

    def spawn_gpu_tiered(self, **kwargs) -> "Checker":
        """Spawn the tiered out-of-core wavefront checker
        (tiered/engine.py): the same wavefront BFS as :meth:`spawn_gpu`
        under a fixed device budget (``memory_budget_mb``) -- the card's
        hash table is the hot tier, evicted fingerprints live in host RAM
        (or on disk, ``cold_dir=``) as sorted runs, and each wave's new
        keys are merge-joined against those runs on the card (K20) before
        it commits, so the discovery set is the in-HBM run's.  ``device``
        defaults to ``cuda`` and raises where there is no card."""
        from ..tiered.engine import TieredGpuChecker

        return TieredGpuChecker(self, **kwargs)

    def spawn_gpu_sharded(self, **kwargs) -> "Checker":
        """Spawn the sharded wavefront checker (parallel/sharded.py), the
        counterpart of the JAX package's ``spawn_tpu_sharded``: the
        frontier and the fingerprint table split over ``mesh`` (a list of
        devices, one a shard; repeats put several shards on one card) by
        fingerprint ownership, successors routed to their owner shard each
        wave (K26, the exchange) and committed there (K4, K27).  It takes
        the JAX spawn's arguments (``capacity``, ``chunk_size``,
        ``dedup_factor``, ``bucket_slack``, ``sort_lanes``, ``sortless``,
        ``step_lanes``, ``waves_per_call``, the journal and checkpoint
        knobs, ``resume_from`` on a mesh of the same size) and adds
        ``accounting()``.  ``mesh`` defaults to one shard on each visible
        card and raises where there is none; ``mesh=["cpu"] * n`` runs the
        plain-torch twins.  ``trace=True`` times each phase of every wave
        (``step``, ``canon``, ``dedup``, ``exchange``, ``append``,
        ``readback``) behind a sync of every card and adds
        ``trace_summary()``."""
        from ..parallel.sharded import ShardedGpuChecker

        return ShardedGpuChecker(self, **kwargs)

    def spawn_gpu_tiered_sharded(self, **kwargs) -> "Checker":
        """Spawn the tiered-sharded checker (tiered/sharded_engine.py), the
        counterpart of the JAX package's ``spawn_tpu_tiered_sharded``: the
        sharded wavefront of :meth:`spawn_gpu_sharded` with the tiered
        checker's cap applied per shard -- ``memory_budget_mb`` bounds each
        shard's hot table; evicted partitions live in shard-local cold
        stores, and each wave's new keys are merged against the owner's
        own runs (K20) before the fresh ones append to its row log (K28).
        Global ids are log positions (``position * n + shard``), so
        snapshots can be re-keyed onto another mesh width with
        :func:`stateright_tpu_torch.tiered.reshard.reshard_snapshot`.  It
        takes ``spawn_gpu_sharded``'s arguments -- ``mesh`` (a list of
        devices, repeats allowed; the default is one shard a visible card
        and raises where there is none) -- and ``memory_budget_mb``,
        ``spill_threshold``, ``cold_max_runs`` and ``cold_dir``;
        ``trace=True`` is refused."""
        from ..tiered.sharded_engine import TieredShardedGpuChecker

        return TieredShardedGpuChecker(self, **kwargs)

    def spawn_gpu_simulation(self, seed: int, walkers: int = 1024,
                             max_trace_len: Optional[int] = None,
                             device=None) -> "Checker":
        """Spawn the device Monte-carlo checker: a batch of ``walkers``
        random trace walks per round, up to ``max_trace_len`` steps each
        (default ``target_max_depth``, else 256), their lane choices JAX's
        threefry draws (parallel/simulation_gpu.py).  Runs until
        ``finish_when`` / ``target_state_count`` / ``timeout`` /
        :meth:`Checker.request_stop` stops it.  ``device`` defaults to
        ``cuda`` and raises where there is no card."""
        from ..parallel.simulation_gpu import GpuSimulationChecker

        return GpuSimulationChecker(self, seed, walkers=walkers,
                                    max_trace_len=max_trace_len, device=device)


def property_verdicts(checker):
    """Per-property verdict rows of a finished checker, and the first
    counterexample-classified discovery in the model's property order (the
    run's ``violation``): what the incremental store records of a run."""
    model = checker.model()
    discoveries = checker.discoveries()
    props = []
    violation = None
    for p in model.properties():
        found = p.name in discoveries
        classification = (
            checker.discovery_classification(p.name) if found else None
        )
        if found and classification == "counterexample" and violation is None:
            violation = p.name
        props.append({
            "name": p.name,
            "expectation": p.expectation.name,
            "discovered": found,
            "classification": classification,
        })
    return props, violation


class Checker:
    """Base checker surface.  Reference: the ``Checker`` trait,
    src/checker.rs:294-578."""

    def __init__(self, model: Model):
        self._model = model
        # Cooperative cancellation: request_stop() asks the engine to wind
        # down at its next host-side check, exactly like a timeout --
        # partial counts stand, is_done() becomes true, join() returns.
        self._stop_requested = threading.Event()

    # --- interface implemented by engines -----------------------------------

    def model(self) -> Model:
        return self._model

    def state_count(self) -> int:
        raise NotImplementedError

    def unique_state_count(self) -> int:
        raise NotImplementedError

    def max_depth(self) -> int:
        raise NotImplementedError

    def discoveries(self) -> Dict[str, Path]:
        raise NotImplementedError

    def handles(self) -> list:
        return []

    def is_done(self) -> bool:
        raise NotImplementedError

    def join(self) -> "Checker":
        for h in self.handles():
            h.join()
        return self

    def metrics(self) -> dict:
        """Observability snapshot: the counts every engine has (the
        device engines extend it).  Never blocks on a running checker."""
        return {
            "engine": type(self).__name__,
            "done": self.is_done(),
            "state_count": self.state_count(),
            "unique_state_count": self.unique_state_count(),
            "max_depth": self.max_depth(),
            "table_load_factor": 0.0,
        }

    def request_stop(self) -> None:
        """Ask a running check to stop early (never blocks): the engine
        finishes its current wave or walk batch, keeps every committed
        count and discovery, and completes like a timed-out run."""
        self._stop_requested.set()

    def stop_requested(self) -> bool:
        return self._stop_requested.is_set()

    # --- shared functionality -----------------------------------------------

    def discovery(self, name: str) -> Optional[Path]:
        return self.discoveries().get(name)

    def discovery_classification(self, name: str) -> str:
        prop = self._model.get_property(name)
        return "example" if prop.expectation is Expectation.SOMETIMES else "counterexample"

    def _report_data(self, start: float, done: bool) -> ReportData:
        return ReportData(
            total_states=self.state_count(),
            unique_states=self.unique_state_count(),
            max_depth=self.max_depth(),
            duration=time.monotonic() - start,
            done=done,
        )

    def join_and_report(self, reporter: Reporter) -> "Checker":
        """Join while reporting; final timing is accurate rather than rounded
        to the polling interval.  Reference: src/checker.rs:351-409."""
        start = time.monotonic()
        stop = threading.Event()

        def poll():
            while not stop.is_set() and not self.is_done():
                reporter.report_checking(self._report_data(start, done=False))
                stop.wait(reporter.delay())

        poller = threading.Thread(target=poll, daemon=True)
        poller.start()
        try:
            self.join()
        finally:
            stop.set()
            poller.join()
        reporter.report_checking(self._report_data(start, done=True))
        discoveries = {
            name: ReportDiscovery(path, self.discovery_classification(name))
            for name, path in self.discoveries().items()
        }
        reporter.report_discoveries(self._model, discoveries)
        return self

    # --- assertion helpers (src/checker.rs:468-577) -------------------------

    def assert_properties(self) -> None:
        for p in self._model.properties():
            if p.expectation is Expectation.SOMETIMES:
                self.assert_any_discovery(p.name)
            else:
                self.assert_no_discovery(p.name)

    def assert_any_discovery(self, name: str) -> Path:
        found = self.discovery(name)
        if found is not None:
            return found
        if not self.is_done():
            raise AssertionError(
                f'Discovery for "{name}" not found, but model checking is incomplete.'
            )
        raise AssertionError(f'Discovery for "{name}" not found.')

    def assert_no_discovery(self, name: str) -> None:
        found = self.discovery(name)
        if found is not None:
            raise AssertionError(
                f'Unexpected "{name}" {self.discovery_classification(name)} '
                f"{found}Last state: {found.last_state()!r}\n"
            )
        if not self.is_done():
            raise AssertionError(
                f'Discovery for "{name}" not found, but model checking is incomplete.'
            )
