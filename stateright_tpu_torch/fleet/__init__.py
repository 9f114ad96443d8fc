"""Fleet serving: the gang wave (``gang.py``), K compatible small jobs in
one device dispatch a wave, each member's verdicts those of a solo run.

The counterpart of the gang half of ``stateright_tpu/fleet/``; its durable
job store, worker, placement and HTTP service are not ported yet.
"""

from .gang import GangMemberChecker, gang_eligibility, run_gang

__all__ = ["GangMemberChecker", "gang_eligibility", "run_gang"]
