"""Observability pieces the port's engines need.

- :mod:`.metrics` -- the metrics registry every checker carries:
  counters, gauges and fixed-boundary histograms (the loop vitals);
- :mod:`.trace` -- the traced wave's phase clock and the
  :class:`~.trace.WaveTracer` that reduces phase records into the journal's
  ``wave_breakdown``/``bytes``/``hbm_util_frac`` and ``trace_summary()``;
- :mod:`.roofline` -- the card's peak bandwidth table and the byte model;
- :mod:`.timeline` -- the host-tail spans (``host_span`` events and
  ``host_<phase>_sec`` histograms) and the ``torch.profiler``/NVTX ranges.
"""
