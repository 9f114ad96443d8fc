"""A small thread-safe metrics registry: counters and gauges.

A copy of the counter-and-gauge half of ``stateright_tpu/obs/metrics.py``'s
``MetricsRegistry`` (``inc``, ``set``, ``update``, ``get``, ``snapshot``).
Every wavefront checker carries one: the host wave loop writes it from
scalars it already read back, and ``GpuChecker.metrics()`` reads it, so a
metrics write is a few dict stores and never a device sync.  Histograms
and the always-on vitals are not ported.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Union

Number = Union[int, float]


class MetricsRegistry:
    """Flat name -> value store with counter and gauge semantics.

    ``inc`` accumulates (counters: monotone over a run), ``set``
    overwrites (gauges: last-value-wins).  ``snapshot()`` returns a plain
    dict copy safe to serialize while writers keep running.
    """

    def __init__(self, **initial: Number):
        self._lock = threading.Lock()
        self._values: Dict[str, Number] = dict(initial)

    def inc(self, name: str, delta: Number = 1) -> None:
        with self._lock:
            self._values[name] = self._values.get(name, 0) + delta

    def set(self, name: str, value: Number) -> None:
        with self._lock:
            self._values[name] = value

    def update(self, **values: Number) -> None:
        """Set several gauges under one lock acquisition."""
        with self._lock:
            self._values.update(values)

    def get(self, name: str, default: Optional[Number] = None):
        with self._lock:
            return self._values.get(name, default)

    def snapshot(self) -> Dict[str, Number]:
        with self._lock:
            return dict(self._values)
