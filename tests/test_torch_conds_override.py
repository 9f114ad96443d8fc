"""A ``property_conds`` override reaches every path of the fused step kernels.

Raft, ABD, the single-copy register, the LWW CRDT and ping-pong expand
through kernels that write the conds beside the successors.  A subclass of
their compiled form that overrides ``property_conds`` (the pattern of the
edited two-phase commit) must be checked against its own conds by
``spawn_gpu``, the walk and the store, as the JAX engine checks it.  The
edit here appends one ALWAYS property, "at the init row", that fails at the
first state whose packed row differs from the init state's; both packages
get the same edit, and the port's ``spawn_gpu(device="cpu")`` must give the
JAX engine's counts, discoveries, paths and fingerprints.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stateright_tpu.actor import Network as JNetwork  # noqa: E402
from stateright_tpu.core.model import Expectation as JExpectation  # noqa: E402
from stateright_tpu.models.abd import AbdModelCfg as JAbdModelCfg  # noqa: E402
from stateright_tpu.models.lww_register import build_model as jlww_model  # noqa: E402
from stateright_tpu.models.ping_pong import PingPongCfg as JPingPongCfg  # noqa: E402
from stateright_tpu.models.ping_pong_compiled import (  # noqa: E402
    PingPongCompiled as JPingPongCompiled,
)
from stateright_tpu.models.raft import RaftModelCfg as JRaftModelCfg  # noqa: E402
from stateright_tpu.models.single_copy_register import (  # noqa: E402
    SingleCopyModelCfg as JSingleCopyModelCfg,
)
from stateright_tpu_torch.actor import Network  # noqa: E402
from stateright_tpu_torch.core.model import Expectation  # noqa: E402
from stateright_tpu_torch.models.abd import AbdModelCfg  # noqa: E402
from stateright_tpu_torch.models.abd_compiled import AbdCompiled  # noqa: E402
from stateright_tpu_torch.models.lww_compiled import LwwCompiled  # noqa: E402
from stateright_tpu_torch.models.lww_register import build_model as lww_model  # noqa: E402
from stateright_tpu_torch.models.ping_pong import PingPongCfg  # noqa: E402
from stateright_tpu_torch.models.ping_pong_compiled import PingPongCompiled  # noqa: E402
from stateright_tpu_torch.models.raft import RaftModelCfg  # noqa: E402
from stateright_tpu_torch.models.raft_compiled import RaftCompiled  # noqa: E402
from stateright_tpu_torch.models.single_copy_compiled import (  # noqa: E402
    SingleCopyCompiled,
)
from stateright_tpu_torch.models.single_copy_register import (  # noqa: E402
    SingleCopyModelCfg,
)
from stateright_tpu_torch.ops.u32 import from_numpy_u32  # noqa: E402
from stateright_tpu_torch.parallel.compiled import fused_conds  # noqa: E402

EDIT = "at the init row"
GEOMETRY = dict(capacity=1 << 12, max_frontier=1 << 8)

# name: (the port's stock model, the JAX package's, its compiled class in
# the port, target depth or None).
CASES = {
    "raft": (lambda: RaftModelCfg(server_count=3).into_model(),
             lambda: JRaftModelCfg(server_count=3).into_model(), RaftCompiled, 5),
    "abd": (lambda: AbdModelCfg(2, 2, Network.new_ordered()).into_model(),
            lambda: JAbdModelCfg(2, 2, JNetwork.new_ordered()).into_model(),
            AbdCompiled, None),
    "single_copy": (
        lambda: SingleCopyModelCfg(
            2, 1, Network.new_unordered_nonduplicating()).into_model(),
        lambda: JSingleCopyModelCfg(
            2, 1, JNetwork.new_unordered_nonduplicating()).into_model(),
        SingleCopyCompiled, None),
    "lww": (lambda: lww_model(2), lambda: jlww_model(2), LwwCompiled, 4),
    "ping_pong": (
        lambda: PingPongCfg(False, 3).into_model().lossy_network_(True),
        lambda: JPingPongCfg(False, 3).into_model().lossy_network_(True),
        PingPongCompiled, None),
}


def _edited(model, init_row, subclass_of):
    """``model`` with the edit: the host property and a compiled subclass
    whose ``property_conds`` appends its column (either package: torch rows
    ``int32[F, W]`` or one JAX ``uint32[W]`` state)."""
    cm_type = subclass_of or type(model.compiled())
    is_jax = subclass_of is not None

    class Edited(cm_type):
        def property_conds(self, states):
            conds = super().property_conds(states)
            if is_jax:
                same = jnp.all(states == jnp.asarray(init_row, jnp.uint32))
                return jnp.concatenate([conds, same[None]])
            same = (states == from_numpy_u32(init_row, states.device)).all(1)
            return torch.cat([conds, same[:, None]], dim=1)

    codec = model.compiled()

    def at_init(_m, s):
        return bool((np.asarray(codec.encode(s), np.uint32) == init_row).all())

    kind = JExpectation.ALWAYS if is_jax else Expectation.ALWAYS
    model.property(kind, EDIT, at_init)
    model.compiled = lambda: Edited(model)
    return model


def _jax_model(name):
    jm = CASES[name][1]()
    if name == "ping_pong":  # the JAX ping-pong model has no compiled() hook
        jm.compiled = lambda: JPingPongCompiled(jm)
    return jm


def _init_row(name):
    pm = CASES[name][0]()
    return pm.compiled().init_packed()[0].astype(np.uint32)


def _builder(model, depth):
    b = model.checker()
    return b.target_max_depth(depth) if depth else b


def _path_fps(model, path):
    return [int(model.fingerprint(s)) for s in path.into_states()]


@pytest.fixture(scope="module")
def jax_runs():
    """Each model's edited JAX run and its ``discovered_fingerprints()``,
    once per module.  The fingerprints are taken with JAX's
    ``device_fp64`` jitted: called op by op, as the checker calls it, it
    compiles every op anew for each row count.  The function is the
    same."""
    import stateright_tpu.ops.device_fp as jfp

    out = {}
    for name, (_port, _jax, _cls, depth) in CASES.items():
        row = _init_row(name)
        jm = _jax_model(name)
        jcls = type(jm.compiled())
        jm = _edited(jm, row, jcls)
        c = _builder(jm, depth).spawn_tpu(**GEOMETRY).join()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jfp, "device_fp64", jax.jit(jfp.device_fp64))
            out[name] = c, c.discovered_fingerprints()
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_edited_model_matches_jax(name, jax_runs):
    """The port's engine checks the override's conds: counts, discoveries,
    their paths and the fingerprint set equal the JAX engine's."""
    port_model, _jax, cls, depth = CASES[name]
    pm = _edited(port_model(), _init_row(name), None)
    assert not fused_conds(pm.compiled(), cls)
    ours = _builder(pm, depth).spawn_gpu(device="cpu", **GEOMETRY).join()
    theirs, their_fps = jax_runs[name]
    assert (ours.unique_state_count(), ours.state_count(), ours.max_depth()) == (
        theirs.unique_state_count(), theirs.state_count(), theirs.max_depth())
    assert EDIT in ours.discoveries()
    assert sorted(ours.discoveries()) == sorted(theirs.discoveries())
    for prop, path in theirs.discoveries().items():
        assert _path_fps(pm, ours.discoveries()[prop]) == _path_fps(pm, path), prop
    assert len(ours.discoveries()[EDIT]) == 2  # the init state, then a successor
    np.testing.assert_array_equal(ours.discovered_fingerprints(), their_fps)


@pytest.mark.parametrize("name", sorted(CASES))
def test_walk_and_expand_take_the_override(name):
    """``expand`` and ``walk_step`` (plain or not) return the override's
    conds on the edited model and the fused kernel's on the stock one."""
    port_model, _jax, cls, _depth = CASES[name]
    row = _init_row(name)
    stock = port_model().compiled()
    edited = _edited(port_model(), row, None).compiled()
    assert fused_conds(stock, cls) and not fused_conds(edited, cls)
    rows = from_numpy_u32(row[None], "cpu")
    want = edited.property_conds(rows)
    assert want.shape[1] == stock.property_conds(rows).shape[1] + 1
    assert bool(want[0, -1])
    for plain in (False, True):
        assert torch.equal(edited.walk_step(rows, plain=plain)[2], want)
        assert torch.equal(stock.walk_step(rows, plain=plain)[2],
                           stock.property_conds(rows))
    assert torch.equal(edited.expand(rows)[2], want)
    assert torch.equal(stock.expand(rows)[2], stock.property_conds(rows))


def _declared_single_copy():
    """The single-copy register with its constants declared, as a user's
    subclass would declare them: the store reuses only runs of models that
    declare them (the JAX package's models declare none for this one)."""
    model = CASES["single_copy"][0]()

    class Declared(SingleCopyCompiled):
        def spec_constants(self):
            return {"client_count": "2", "server_count": "1",
                    "network": self.model.init_network.kind}

    model.compiled = lambda: Declared(model)
    return model


def test_store_reeval_of_edited_model_agrees_with_a_cold_run(tmp_path):
    """The store's property-only re-eval of the edited single-copy register
    over the stock run's log gives what a cold run of the edited model
    gives: its counts, discoveries and paths."""
    from stateright_tpu_torch.incr import incremental_check

    kw = dict(device="cpu", **GEOMETRY)
    row = _init_row("single_copy")
    _c, info = incremental_check(_declared_single_copy().checker(),
                                 str(tmp_path), engine_kwargs=kw)
    assert info["mode"] == "cold"
    edited = _edited(_declared_single_copy(), row, None)
    got, info = incremental_check(edited.checker(), str(tmp_path),
                                  engine_kwargs=kw)
    assert info["mode"] == "property_only", info
    cold = _edited(_declared_single_copy(), row, None).checker() \
        .spawn_gpu(**kw).join()
    assert (got.unique_state_count(), got.state_count(), got.max_depth()) == (
        cold.unique_state_count(), cold.state_count(), cold.max_depth())
    assert sorted(got.discoveries()) == sorted(cold.discoveries())
    assert EDIT in got.discoveries()
    for prop, path in cold.discoveries().items():
        assert _path_fps(edited, got.discoveries()[prop]) == \
            _path_fps(edited, path), prop
