"""Ping-pong: the reference's own actor example.

The counterpart of ``stateright_tpu/models/ping_pong.py`` (reference:
src/actor/actor_test_util.rs): two actors count up by exchanging Ping and
Pong on the unordered duplicating network, under six properties that span
all three expectations.  Goldens (src/actor/model.rs:875,1055,1095): 14
unique states lossy at ``max_nat`` 1, 4,094 lossy at 5, 11 lossless at 5.
Its compiled form (``models/ping_pong_compiled.py``) runs it through
``spawn_gpu()``; set ``lossy_network_(...)`` before spawning.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..actor import Actor, ActorModel, Id, Network, Out
from ..core.model import Expectation


@dataclass(frozen=True)
class Ping:
    value: int


@dataclass(frozen=True)
class Pong:
    value: int


class PingPongActor(Actor):
    def __init__(self, serve_to: Optional[Id]):
        self.serve_to = serve_to

    def on_start(self, id, storage, o: Out):
        if self.serve_to is not None:
            o.send(self.serve_to, Ping(0))
        return 0

    def on_msg(self, id, state, src, msg, o: Out):
        if isinstance(msg, Pong) and state == msg.value:
            o.send(src, Ping(msg.value + 1))
            return state + 1
        if isinstance(msg, Ping) and state == msg.value:
            o.send(src, Pong(msg.value))
            return state + 1
        return None


@dataclass
class PingPongCfg:
    maintains_history: bool
    max_nat: int

    def into_model(self) -> ActorModel:
        def rec_in(cfg, history, _env):
            if cfg.maintains_history:
                i, o = history
                return (i + 1, o)
            return None

        def rec_out(cfg, history, _env):
            if cfg.maintains_history:
                i, o = history
                return (i, o + 1)
            return None

        model = (
            ActorModel(cfg=self, init_history=(0, 0))
            .add_actors([PingPongActor(serve_to=Id(1)), PingPongActor(serve_to=None)])
            .init_network_(Network.new_unordered_duplicating())
            .record_msg_in(rec_in)
            .record_msg_out(rec_out)
            .within_boundary_(
                lambda cfg, state: all(c <= cfg.max_nat for c in state.actor_states)
            )
            .property(
                Expectation.ALWAYS,
                "delta within 1",
                lambda _m, s: max(s.actor_states) - min(s.actor_states) <= 1,
            )
            .property(
                Expectation.SOMETIMES,
                "can reach max",
                lambda m, s: any(c == m.cfg.max_nat for c in s.actor_states),
            )
            .property(
                Expectation.EVENTUALLY,
                "must reach max",
                lambda m, s: any(c == m.cfg.max_nat for c in s.actor_states),
            )
            .property(
                Expectation.EVENTUALLY,
                "must exceed max",  # falsifiable due to the boundary
                lambda m, s: any(c == m.cfg.max_nat + 1 for c in s.actor_states),
            )
            .property(
                Expectation.ALWAYS,
                "#in <= #out",
                lambda _m, s: s.history[0] <= s.history[1],
            )
            .property(
                Expectation.EVENTUALLY,
                "#out <= #in + 1",
                lambda _m, s: s.history[1] <= s.history[0] + 1,
            )
        )

        def _compiled():
            from .ping_pong_compiled import PingPongCompiled

            return PingPongCompiled(model)

        model.compiled = _compiled
        return model


def cli_spec():
    """This module's workload spec (resolved by ``serve/workloads.py``)."""
    from ..cli import CliSpec

    return CliSpec(
        name="ping_pong",
        build=lambda n: PingPongCfg(
            maintains_history=False, max_nat=n
        ).into_model(),
        default_n=5,
        n_meta="MAX_NAT",
        gpu=True,
        gpu_kwargs=dict(capacity=1 << 16, max_frontier=1 << 10),
    )
