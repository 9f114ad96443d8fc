"""Actor framework, the part that model checking needs: actors, their
send and timer commands, the duplicating, nonduplicating and ordered
networks and ``ActorModel`` with its Deliver, Drop, Timeout, Crash and
Recover actions.  The counterpart of ``stateright_tpu/actor`` (reference:
src/actor.rs) without the UDP runtime, random choices or storage."""

from .base import (
    Actor, CancelTimerCmd, Out, SendCmd, SetTimerCmd, is_no_op,
    is_no_op_with_timer, majority, model_peers, model_timeout,
)
from .ids import Id
from .model import (
    ActorModel, ActorModelState, Crash, Deliver, Drop, Recover, Timeout,
)
from .network import Envelope, Network

__all__ = [
    "Actor", "ActorModel", "ActorModelState", "CancelTimerCmd", "Crash",
    "Deliver", "Drop", "Envelope", "Id", "Network", "Out", "Recover", "SendCmd",
    "SetTimerCmd", "Timeout", "is_no_op", "is_no_op_with_timer", "majority",
    "model_peers", "model_timeout",
]
