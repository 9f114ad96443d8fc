"""A small thread-safe metrics registry: counters, gauges and histograms.

A copy of ``stateright_tpu/obs/metrics.py``'s ``MetricsRegistry``,
``Histogram``, bucket ladders and ``merge_histogram_snapshots``.  Every
wavefront checker carries one: the host wave loop writes it from scalars
it already read back, and ``GpuChecker.metrics()`` reads it, so a metrics
write is a few dict stores and a bisect, never a device sync.

Histograms are fixed-boundary (Prometheus classic style: cumulative ``le``
buckets plus ``sum``/``count``), and a snapshot carries p50/p95/p99
estimated by linear interpolation inside the owning bucket -- the JAX
package's shape (``boundaries``/``counts``/``sum``/``count``/``p50``/
``p95``/``p99``), so the two engines' ``metrics()["histograms"]`` read
alike.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, Optional, Sequence, Union

Number = Union[int, float]

# Shared boundary ladders (seconds / counts), the JAX package's: latency
# buckets from sub-millisecond waves up to two-minute device calls.
LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)
# Waves-between-growth-events ladder (powers of two, like the geometry).
COUNT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
# Fractions-of-a-buffer ladder (valid density vs the worst-case U
# buffer, hot-table load factor): log-spaced below 10%, where measured
# densities live, then coarse to 1.0.
FRACTION_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.2, 0.3, 0.4, 0.5, 0.75, 1.0,
)


class Histogram:
    """Fixed-boundary cumulative histogram with quantile readback.

    ``boundaries`` are the bucket upper bounds (ascending); one implicit
    ``+Inf`` bucket catches the tail.  Not self-locking: the owning
    :class:`MetricsRegistry` serializes access under its lock.
    """

    def __init__(self, boundaries: Sequence[float]):
        b = tuple(float(x) for x in boundaries)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(
                "histogram boundaries must be strictly ascending"
            )
        self.boundaries = b
        self.counts = [0] * (len(b) + 1)  # last = +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value: Number, count: int = 1) -> None:
        """Fold ``count`` observations of ``value`` (the weighted form
        lets the wave loop record one quantum as waves_per_call equal
        per-wave latencies with a single call)."""
        self.counts[bisect_left(self.boundaries, float(value))] += count
        self.sum += float(value) * count
        self.count += count

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0..1): find the bucket holding the
        rank, interpolate linearly inside it (Prometheus
        ``histogram_quantile`` semantics; the +Inf bucket reports its
        lower bound)."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if acc + c >= rank:
                lo = self.boundaries[i - 1] if i > 0 else 0.0
                if i >= len(self.boundaries):
                    return lo  # +Inf bucket: report its lower bound
                hi = self.boundaries[i]
                return lo + (hi - lo) * max(0.0, rank - acc) / c
            acc += c
        return self.boundaries[-1]

    def snapshot(self) -> dict:
        return {
            "boundaries": list(self.boundaries),
            "counts": list(self.counts),
            "sum": round(self.sum, 6),
            "count": self.count,
            "p50": round(self.quantile(0.50), 6),
            "p95": round(self.quantile(0.95), 6),
            "p99": round(self.quantile(0.99), 6),
        }

    @classmethod
    def from_snapshot(cls, snap: dict) -> "Histogram":
        """Rehydrate a histogram from its :meth:`snapshot` dict."""
        h = cls(snap["boundaries"])
        counts = list(snap.get("counts") or ())
        if len(counts) != len(h.counts):
            raise ValueError(
                "snapshot counts do not match boundaries "
                f"({len(counts)} buckets for {len(h.counts)} expected)"
            )
        h.counts = [int(c) for c in counts]
        h.sum = float(snap.get("sum", 0.0))
        h.count = int(snap.get("count", 0))
        return h

    def merge(self, snap: dict) -> None:
        """Bucket-wise addition of another histogram's snapshot.  Only
        identical boundary ladders merge — the ladders are module
        constants shared by every writer, so a mismatch means two
        incompatible schema versions, surfaced loudly rather than
        silently misbinned."""
        if tuple(float(b) for b in snap["boundaries"]) != self.boundaries:
            raise ValueError("histogram boundary ladders differ")
        counts = list(snap.get("counts") or ())
        if len(counts) != len(self.counts):
            raise ValueError("histogram bucket counts differ")
        for i, c in enumerate(counts):
            self.counts[i] += int(c)
        self.sum += float(snap.get("sum", 0.0))
        self.count += int(snap.get("count", 0))


def merge_histogram_snapshots(*snaps: Dict[str, dict]) -> Dict[str, dict]:
    """Merge several ``{name: histogram-snapshot}`` maps bucket-wise
    into one (quantiles recomputed from the summed buckets).
    Commutative and associative by construction (bucket addition is), so
    the merged view does not depend on the order of the maps."""
    merged: Dict[str, Histogram] = {}
    for snap_map in snaps:
        for name in sorted(snap_map or {}):
            snap = snap_map[name]
            if not isinstance(snap, dict) or "boundaries" not in snap:
                continue
            h = merged.get(name)
            if h is None:
                merged[name] = Histogram.from_snapshot(snap)
            else:
                h.merge(snap)
    return {n: h.snapshot() for n, h in merged.items()}


class MetricsRegistry:
    """Flat name -> value store with counter and gauge semantics.

    ``inc`` accumulates (counters: monotone over a run), ``set``
    overwrites (gauges: last-value-wins).  ``snapshot()`` returns a plain
    dict copy safe to serialize while writers keep running.
    """

    def __init__(self, **initial: Number):
        self._lock = threading.Lock()
        self._values: Dict[str, Number] = dict(initial)
        self._hists: Dict[str, Histogram] = {}

    def inc(self, name: str, delta: Number = 1) -> None:
        with self._lock:
            self._values[name] = self._values.get(name, 0) + delta

    def set(self, name: str, value: Number) -> None:
        with self._lock:
            self._values[name] = value

    def update(self, **values: Number) -> None:
        """Set several gauges under one lock acquisition (the per-wave
        hot path writes ~10 values)."""
        with self._lock:
            self._values.update(values)

    def get(self, name: str, default: Optional[Number] = None):
        with self._lock:
            return self._values.get(name, default)

    def observe(
        self,
        name: str,
        value: Number,
        count: int = 1,
        boundaries: Sequence[float] = LATENCY_BUCKETS,
    ) -> None:
        """Record ``value`` into the named histogram, creating it with
        ``boundaries`` on first use (later calls keep the original
        boundaries — one ladder per name for the life of the
        registry)."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(boundaries)
            h.observe(value, count)

    def snapshot(self) -> Dict[str, Number]:
        with self._lock:
            return dict(self._values)

    def snapshot_histograms(self) -> Dict[str, dict]:
        """Plain-dict copies of every histogram (the ``histograms`` key
        of ``GpuChecker.metrics()``)."""
        with self._lock:
            return {n: h.snapshot() for n, h in self._hists.items()}
