"""Actor framework, the part that model checking needs: actors, their
send commands, the nonduplicating network and ``ActorModel``.  The
counterpart of ``stateright_tpu/actor`` (reference: src/actor.rs)
without the UDP runtime, timers, crashes or lossy networks."""

from .base import Actor, Out, SendCmd, is_no_op, majority, model_peers
from .ids import Id
from .model import ActorModel, ActorModelState, Deliver
from .network import Envelope, Network

__all__ = [
    "Actor", "ActorModel", "ActorModelState", "Deliver", "Envelope", "Id",
    "Network", "Out", "SendCmd", "is_no_op", "majority", "model_peers",
]
