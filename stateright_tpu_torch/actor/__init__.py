"""Actor framework, the part that model checking needs: actors, their
send, timer and random-choice commands, the duplicating, nonduplicating
and ordered networks and ``ActorModel`` with its Deliver, Drop, Timeout,
Crash, Recover and SelectRandom actions.  The counterpart of
``stateright_tpu/actor`` (reference: src/actor.rs) without the UDP
runtime or storage."""

from .base import (
    Actor, CancelTimerCmd, ChooseRandomCmd, Out, SendCmd, SetTimerCmd,
    is_no_op, is_no_op_with_timer, majority, model_peers, model_timeout,
)
from .ids import Id
from .model import (
    ActorModel, ActorModelState, Crash, Deliver, Drop, Recover, SelectRandom,
    Timeout,
)
from .network import Envelope, Network

__all__ = [
    "Actor", "ActorModel", "ActorModelState", "CancelTimerCmd",
    "ChooseRandomCmd", "Crash", "Deliver", "Drop", "Envelope", "Id", "Network",
    "Out", "Recover", "SelectRandom", "SendCmd", "SetTimerCmd", "Timeout", "is_no_op", "is_no_op_with_timer", "majority",
    "model_peers", "model_timeout",
]
