"""Tiered out-of-core checking: a budgeted hot table on the card, a cold
tier of sorted fingerprint runs in host RAM or on disk.

The counterpart of ``stateright_tpu/tiered/`` (one card): the device hash
table holds the hot working set under a fixed ``memory_budget_mb``, evicted
partitions live as sorted immutable runs in the host :class:`ColdStore`,
and each wave's new keys are merge-joined against the overlapping run
windows on the card (K20) before it commits -- the discovery set of an
unconstrained run, bit for bit.
"""

from .cold_store import ColdStore
from .engine import TieredGpuChecker, capacity_for_budget

__all__ = ["ColdStore", "TieredGpuChecker", "capacity_for_budget"]
