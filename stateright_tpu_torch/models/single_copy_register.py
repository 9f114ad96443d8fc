"""Unreplicated single-copy register -- linearizable iff one server.

A copy of ``stateright_tpu/models/single_copy_register.py`` (reference:
examples/single-copy-register.rs) without its CLI and UDP spawn.  Goldens:
93 unique states with 2 clients / 1 server on a nonduplicating network;
4,243 at 3 clients (depth 13); 400,233 at 4 clients (depth 17, the
reference's `single-copy-register check 4`).  With 2 servers the clients
round-robin their Put and Get to different servers and the history stops
being linearizable, so the "linearizable" property finds a counterexample.
Its compiled form (``models/single_copy_compiled.py``) runs it through
``spawn_gpu()``:

    from stateright_tpu_torch.actor import Network
    from stateright_tpu_torch.models.single_copy_register import (
        SingleCopyModelCfg,
    )
    SingleCopyModelCfg(4, 1, Network.new_unordered_nonduplicating()) \\
        .into_model().checker().spawn_gpu().join()
"""

from __future__ import annotations

from dataclasses import dataclass

from ..actor import Actor, ActorModel, Network, Out
from ..actor.register import (
    Get,
    GetOk,
    Put,
    PutOk,
    RegisterClient,
    RegisterServer,
    record_invocations,
    record_returns,
)
from ..core.model import Expectation
from ..semantics import LinearizabilityTester, Register

NULL_VALUE = "\x00"  # the analog of Rust's char::default()


class SingleCopyActor(Actor):
    def on_start(self, id, storage, o: Out):
        return NULL_VALUE

    def on_msg(self, id, state, src, msg, o: Out):
        if isinstance(msg, Put):
            o.send(src, PutOk(msg.request_id))
            return msg.value
        if isinstance(msg, Get):
            o.send(src, GetOk(msg.request_id, state))
            return None
        return None


@dataclass
class SingleCopyModelCfg:
    client_count: int
    server_count: int
    network: Network

    def into_model(self) -> ActorModel:
        def value_chosen(_m, state):
            for env in state.network.iter_deliverable():
                if isinstance(env.msg, GetOk) and env.msg.value != NULL_VALUE:
                    return True
            return False

        model = ActorModel(
            cfg=self, init_history=LinearizabilityTester(Register(NULL_VALUE))
        )
        model.add_actors(
            RegisterServer(SingleCopyActor()) for _ in range(self.server_count)
        )
        model.add_actors(
            RegisterClient(put_count=1, server_count=self.server_count)
            for _ in range(self.client_count)
        )
        model = (
            model.init_network_(self.network)
            .property(
                Expectation.ALWAYS,
                "linearizable",
                lambda _m, s: s.history.serialized_history() is not None,
            )
            .property(Expectation.SOMETIMES, "value chosen", value_chosen)
            .record_msg_in(record_returns)
            .record_msg_out(record_invocations)
        )

        def _compiled():
            from .single_copy_compiled import SingleCopyCompiled

            return SingleCopyCompiled(model)

        model.compiled = _compiled
        return model


def cli_spec():
    """This module's workload spec (resolved by ``serve/workloads.py``)."""
    from ..cli import CliSpec

    return CliSpec(
        name="single-copy register",
        build=lambda n, net: SingleCopyModelCfg(
            client_count=n, server_count=1, network=net
        ).into_model(),
        default_n=2,
        n_meta="CLIENT_COUNT",
        default_network="unordered_nonduplicating",
        gpu=True,
        gpu_kwargs=dict(capacity=1 << 12, max_frontier=1 << 7),
    )
