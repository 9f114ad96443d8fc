"""Incremental re-checking on the card: a persistent, content-addressed
verification store that makes near-identical re-checks cheap.

The counterpart of ``stateright_tpu/incr/``.  A completed ``spawn_gpu``
run's reachable set, row log and verdict are keyed by per-component hashes
of the model spec (``spec_hash.py``) and kept in a directory store built on
the tiered engine's sorted-run format (``store.py``).  On resubmission
:func:`incremental_check` classifies the delta and takes the cheapest
sound path (``recheck.py``): the stored verdict for an identical spec, the
new properties over the stored row log (K22) for a property-only edit, a
resume seeded from the stored reachable set for a declared constant
widening, and a cold run, with the reason journaled, for anything else.
"""

from .recheck import incremental_check
from .spec_hash import SpecFingerprint
from .store import VerificationStore

__all__ = [
    "SpecFingerprint",
    "VerificationStore",
    "incremental_check",
]
