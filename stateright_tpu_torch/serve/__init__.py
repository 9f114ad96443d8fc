"""The checking service's job surface: what a job asks for (``jobs.py``),
the workloads it may name (``workloads.py``) and the result shape of a
finished checker (``portfolio.checker_summary``).

The counterpart of the parts of ``stateright_tpu/serve/`` that the gang
wave (``fleet/gang.py``) stands on; the job runner, the scheduler, the
portfolio race and the HTTP server are not ported yet.
"""
