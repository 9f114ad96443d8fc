"""The port's device simulation checker against the JAX package, on the CPU.

- the walk: a batch's ``(trace, disc, counted, appended, flag)`` equals
  ``jax.jit(jax.vmap(build_walk(...)))`` on the same keys, for 2pc, the
  trap counter (eventually), lossy ping-pong (a boundary), ballot-bounded
  paxos (the boundary-free step), the single-copy register, ABD
  on both fabrics and LWW at a depth where walkers flag; raft under
  ``slow`` (its JAX walk takes about 20 s to compile);
- the step flag per state: each model's ``walk_step`` flag equals the JAX
  ``step``'s per-state flag, with flagged and clean rows in one batch; a
  flagged counted state raises with the JAX message, a flagged finished
  walker does not;
- the checker: ``spawn_gpu_simulation(device="cpu")`` gives the JAX
  checker's counts, depth, discovery names and fingerprints
  (``tests/test_tpu_simulation.py``'s runs), stops on
  ``target_state_count``, ``timeout`` and ``request_stop``, refuses
  symmetry, and raises with no card unless asked for the CPU; the wave
  engine stops on ``timeout`` and ``request_stop`` too.
"""

import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stateright_tpu.actor import Network as JNetwork  # noqa: E402
from stateright_tpu.core.has_discoveries import HasDiscoveries as JHasDiscoveries  # noqa: E402
from stateright_tpu.models import fixtures as jfix  # noqa: E402
from stateright_tpu.models import paxos as jpaxos  # noqa: E402
from stateright_tpu.models.abd import AbdModelCfg as JAbd  # noqa: E402
from stateright_tpu.models.lww_compiled import LwwCompiled as JLww  # noqa: E402
from stateright_tpu.models.lww_register import build_model as jlww  # noqa: E402
from stateright_tpu.models.ping_pong import PingPongCfg as JPingPong  # noqa: E402
from stateright_tpu.models.ping_pong_compiled import PingPongCompiled as JPingPongCompiled  # noqa: E402
from stateright_tpu.models.raft import RaftModelCfg as JRaft  # noqa: E402
from stateright_tpu.models.single_copy_register import SingleCopyModelCfg as JSingleCopy  # noqa: E402
from stateright_tpu.models.twophase import TwoPhaseSys as JTwoPhase  # noqa: E402
from stateright_tpu.parallel.compiled import compiled_model_for as jcompiled  # noqa: E402
from stateright_tpu.parallel.simulation_tpu import build_walk as jbuild_walk  # noqa: E402
from stateright_tpu_torch.actor import Network  # noqa: E402
from stateright_tpu_torch.core.has_discoveries import HasDiscoveries  # noqa: E402
from stateright_tpu_torch.models import fixtures  # noqa: E402
from stateright_tpu_torch.models.abd import AbdModelCfg  # noqa: E402
from stateright_tpu_torch.models.lww_register import build_model as lww  # noqa: E402
from stateright_tpu_torch.models.paxos import PaxosModelCfg  # noqa: E402
from stateright_tpu_torch.models.ping_pong import PingPongCfg  # noqa: E402
from stateright_tpu_torch.models.raft import RaftModelCfg  # noqa: E402
from stateright_tpu_torch.models.single_copy_register import SingleCopyModelCfg  # noqa: E402
from stateright_tpu_torch.models.twophase import TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.ops import prng  # noqa: E402
from stateright_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32  # noqa: E402
from stateright_tpu_torch.parallel import simulation_gpu as sg  # noqa: E402

from .test_torch_device import abd_fuzz_rows, lww_fuzz_rows, raft_fuzz_rows  # noqa: E402

_UNORDERED = "unordered"


def _net(pkg, kind):
    return pkg.new_ordered() if kind == "ordered" else pkg.new_unordered_nonduplicating()


def _pair(name):
    """(JAX model, JAX compiled, port model) of one configuration."""
    if name.startswith("2pc"):
        n = int(name[-1])
        jm, pm = JTwoPhase(rm_count=n), TwoPhaseSys(rm_count=n)
    elif name == "trap":
        jm, pm = jfix.TrapCounter(limit=5, trap_at=2), fixtures.TrapCounter(limit=5, trap_at=2)
    elif name == "pingpong":
        jm = JPingPong(False, 3).into_model().lossy_network_(True)
        return jm, JPingPongCompiled(jm), PingPongCfg(False, 3).into_model().lossy_network_(True)
    elif name.startswith("paxos"):
        bound = {"paxos-bounded": 1, "paxos": None}[name]
        kw = {} if bound is None else {"max_round": bound}
        jm = jpaxos.PaxosModelCfg(2, 3, _net(JNetwork, _UNORDERED), **kw).into_model()
        pm = PaxosModelCfg(2, 3, _net(Network, _UNORDERED), **kw).into_model()
    elif name == "single-copy":
        jm = JSingleCopy(2, 2, _net(JNetwork, _UNORDERED)).into_model()
        pm = SingleCopyModelCfg(2, 2, _net(Network, _UNORDERED)).into_model()
    elif name.startswith("abd"):
        kind, fault = ("ordered", "skip_ack") if name == "abd-ordered" else (_UNORDERED, None)
        jm = JAbd(2, 2, _net(JNetwork, kind), fault=fault).into_model()
        pm = AbdModelCfg(2, 2, _net(Network, kind), fault=fault).into_model()
    elif name == "lww":
        jm = jlww(2)
        return jm, JLww(jm), lww(2)
    elif name == "raft":
        jm, pm = JRaft(3).into_model(), RaftModelCfg(3).into_model()
    return jm, jcompiled(jm), pm


# (configuration, T, walkers, seed): LWW at T = 8 has walkers that flag.
WALKS = [
    ("2pc3", 64, 256, 3), ("2pc5", 48, 256, 3), ("trap", 32, 64, 1),
    ("pingpong", 32, 256, 3), ("paxos-bounded", 24, 128, 3),
    ("single-copy", 24, 128, 3), ("abd-unordered", 24, 128, 3),
    ("abd-ordered", 24, 128, 3), ("lww", 8, 512, 3),
]


@pytest.fixture(scope="module")
def jax_walks():
    """Each configuration's JAX walk batch, compiled and run once."""
    cache = {}

    def get(name, t, b, seed):
        if name not in cache:
            jm, jcm, _pm = _pair(name)
            walk = jax.jit(jax.vmap(jbuild_walk(jcm, jm.properties(), t)))
            base = jax.random.PRNGKey(seed)
            keys = jax.vmap(lambda w: jax.random.fold_in(jax.random.fold_in(base, 0), w))(
                np.arange(b))
            cache[name] = (np.asarray(keys), [np.asarray(x) for x in walk(keys)])
        return cache[name]

    return get


def _assert_walk_equal(name, t, b, seed, jax_walks):
    jkeys, jout = jax_walks(name, t, b, seed)
    _jm, _jcm, pm = _pair(name)
    keys = sg.walker_keys(prng.fold_in(prng.prng_key(seed), 0), 0, b, "cpu")
    assert (to_numpy_u32(keys) == jkeys).all()
    from stateright_tpu_torch.parallel.compiled import compiled_model_for

    out = sg.build_walk(compiled_model_for(pm), pm.properties(), t)(keys)
    for what, j, p in zip(("trace", "disc", "counted", "appended", "flag"), jout, out):
        got = to_numpy_u32(p) if p.dtype == torch.int32 else p.numpy()
        assert got.shape == j.shape and (got == j).all(), what
    return jout


@pytest.mark.parametrize("name,t,b,seed", WALKS, ids=[w[0] for w in WALKS])
def test_walk_batch_matches_jax(name, t, b, seed, jax_walks):
    jout = _assert_walk_equal(name, t, b, seed, jax_walks)
    assert jout[2].sum() > b  # the walkers walked
    if name == "lww":
        assert jout[4].any() and not jout[4].all()


@pytest.mark.slow
def test_raft_walk_batch_matches_jax(jax_walks):
    jout = _assert_walk_equal("raft", 12, 128, 3, jax_walks)
    assert jout[2].sum() > 128


# --- the step flag, per state ---------------------------------------------------


def _flag_rows(name):
    rng = np.random.default_rng(21)
    if name == "abd-ordered":
        return abd_fuzz_rows(rng, 2000, 2, True)
    if name == "lww":
        return lww_fuzz_rows(rng, 2, 600)
    if name == "raft":  # test_torch_raft.py's fuzzed rows
        return raft_fuzz_rows(np.random.default_rng(17), 3_000)
    if name == "paxos":
        from .test_torch_paxos import _hazard_rows, _overflow_row

        jm, jcm, _ = _pair("paxos")
        init = np.stack([jcm.encode(st) for st in jm.init_states()])
        return np.concatenate([_hazard_rows(2), _overflow_row(jcm)[None], init]).astype(np.uint32)
    jm, jcm, _ = _pair(name)
    return np.stack([jcm.encode(s) for s in jm.init_states()]).astype(np.uint32)


@pytest.mark.parametrize("name", ["abd-ordered", "lww", "paxos", "raft", "single-copy"])
def test_walk_step_flag_per_state_matches_jax(name):
    """Every model with ``step_flags``: ``walk_step``'s flag of each state
    is the JAX ``step``'s per-state flag -- flagged rows beside clean ones
    in one batch where the encoding can overflow at all (the single-copy
    register's one send a delivery always fits).  Raft's per-state flag is
    its lanes' ``any(flags & valid)``, which ``test_torch_raft.py`` holds to
    the JAX step's on these fuzzed rows; here it saves a 10 s compile."""
    _jm, jcm, pm = _pair(name)
    rows = _flag_rows(name)
    if name == "raft":
        from stateright_tpu_torch.models.raft_compiled import raft_lanes_plain

        _n, valid, lane_flags = raft_lanes_plain(from_numpy_u32(rows, "cpu"), 1)
        jflag = (lane_flags & valid).any(dim=1).numpy()
    else:
        _n, _v, jflag = (np.asarray(x) for x in jax.jit(jax.vmap(jcm.step))(jnp.asarray(rows)))
    from stateright_tpu_torch.parallel.compiled import compiled_model_for

    flags = compiled_model_for(pm).walk_step(from_numpy_u32(rows, "cpu"))[3]
    assert flags.shape == (rows.shape[0],)
    assert (flags.numpy() == jflag).all()
    if name != "single-copy":
        assert jflag.any() and not jflag.all()


def test_flagged_finished_walker_does_not_flag():
    """A finished walker still steps the row it stands on; that row's flag
    is not the walk's (JAX ORs ``sf & count_this``)."""
    pm = lww(2)
    cm = pm.compiled()
    props = sg.WalkProps.of(pm.properties())
    rows = from_numpy_u32(lww_fuzz_rows(np.random.default_rng(3), 2, 40), "cpu")
    nexts, valid, conds, flags = cm.walk_step(rows)
    assert flags.any()
    b = rows.shape[0]
    keys = prng.prng_key(torch.arange(b))
    carry = sg.WalkCarry.empty(keys, 4, cm.state_width, props, None)
    carry.state.copy_(rows)
    carry.done[: b // 2] = True
    hi, lo = torch.arange(b, dtype=torch.int32), torch.ones(b, dtype=torch.int32)
    sg.walk_step(carry, 0, props, hi, lo, None, nexts, valid, conds, flags)
    assert not carry.flag[: b // 2].any()
    assert torch.equal(carry.flag[b // 2:], flags[b // 2:])


def test_flagged_counted_state_raises_the_jax_message(jax_walks):
    _jkeys, jout = jax_walks("lww", 8, 512, 3)
    assert jout[4].any()  # the JAX checker raises on this batch
    checker = lww(2).checker().spawn_gpu_simulation(
        seed=3, walkers=512, max_trace_len=8, device="cpu")
    with pytest.raises(RuntimeError, match="flagged an encoding-capacity overflow "
                                           "during a simulated trace"):
        checker.join()


# --- the checker -----------------------------------------------------------------


def _fingerprints(checker, jax_checker):
    return ({k: checker.discovered_fingerprints_of(k) for k in checker.discoveries()},
            {k: jax_checker._discovery_fps[k] for k in jax_checker.discoveries()})


def test_checker_finds_the_jax_discoveries_2pc():
    """``test_simulation_finds_sometimes_discoveries``'s run on both
    engines: the same counts, depth, discovery names and fingerprints."""
    fw = ["abort agreement", "commit agreement"]
    jc = (JTwoPhase(rm_count=3).checker().finish_when(JHasDiscoveries.all_of(fw))
          .spawn_tpu_simulation(seed=3, walkers=512, max_trace_len=64).join())
    pc = (TwoPhaseSys(rm_count=3).checker().finish_when(HasDiscoveries.all_of(fw))
          .spawn_gpu_simulation(seed=3, walkers=512, max_trace_len=64, device="cpu")
          .join())
    assert (pc.state_count(), pc.max_depth()) == (jc.state_count(), jc.max_depth())
    assert sorted(pc.discoveries()) == sorted(jc.discoveries()) == fw
    got, want = _fingerprints(pc, jc)
    assert got == want
    assert pc.unique_state_count() == pc.state_count() > 0
    pc.assert_properties()
    assert all(rs == 2 for rs in pc.discoveries()["commit agreement"].last_state().rm_state)


def test_checker_finds_the_eventually_counterexample():
    jc = (jfix.TrapCounter(limit=5, trap_at=2).checker()
          .finish_when(JHasDiscoveries.any_of(["reaches limit"]))
          .spawn_tpu_simulation(seed=1, walkers=64, max_trace_len=32).join())
    model = fixtures.TrapCounter(limit=5, trap_at=2)
    pc = (model.checker().finish_when(HasDiscoveries.any_of(["reaches limit"]))
          .spawn_gpu_simulation(seed=1, walkers=64, max_trace_len=32, device="cpu").join())
    assert (pc.state_count(), pc.max_depth()) == (jc.state_count(), jc.max_depth())
    got, want = _fingerprints(pc, jc)
    assert got == want
    assert pc.discoveries()["reaches limit"].last_state() == model.trap_state


def test_checker_target_state_count_stops():
    pc = (TwoPhaseSys(rm_count=3).checker().target_state_count(2_000)
          .spawn_gpu_simulation(seed=9, walkers=128, max_trace_len=64, device="cpu").join())
    assert pc.state_count() >= 2_000 and pc.is_done()
    assert pc.rounds() >= 2


def test_checker_rejects_symmetry_and_needs_a_card():
    with pytest.raises(ValueError, match="symmetry"):
        TwoPhaseSys(rm_count=3).checker().symmetry().spawn_gpu_simulation(
            seed=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TwoPhaseSys(rm_count=3).checker().spawn_gpu_simulation(seed=0)


def _endless(builder):
    """A run no discovery can finish: finish_when waits for a property
    the model does not have."""
    return builder.finish_when(HasDiscoveries.all_of(["no such property"]))


def _wait_for(cond, what):
    deadline = time.monotonic() + 60
    while not cond():
        assert time.monotonic() < deadline, f"never {what}"
        time.sleep(0.005)


@pytest.mark.parametrize("how", ["timeout", "request_stop"])
def test_simulation_stops_on_timeout_and_request_stop(how):
    """The run keeps its rounds' counts and discoveries; without the stop
    it would walk forever."""
    builder = _endless(TwoPhaseSys(rm_count=3).checker())
    if how == "timeout":
        builder = builder.timeout(0.3)
    pc = builder.spawn_gpu_simulation(seed=3, walkers=64, max_trace_len=16, device="cpu")
    if how == "request_stop":
        _wait_for(lambda: pc.rounds() >= 1, "walked a round")
        pc.request_stop()
    pc.join()
    assert pc.is_done() and pc.stop_requested() == (how == "request_stop")
    assert pc.rounds() >= 1 and pc.state_count() >= 64
    assert "abort agreement" in pc.discoveries()


@pytest.mark.parametrize("how", ["timeout", "request_stop"])
def test_wave_engine_stops_on_timeout_and_request_stop(how):
    """``spawn_gpu`` keeps its committed counts and stops at the first
    wave past the deadline (the first wave at ``timeout(0)``) or the
    request; the full run is 8,832 unique states in hundreds of waves."""
    builder = TwoPhaseSys(rm_count=5).checker()
    if how == "timeout":
        builder = builder.timeout(0.0)
    pc = builder.spawn_gpu(device="cpu", capacity=1 << 14, max_frontier=1 << 4)
    if how == "request_stop":
        _wait_for(lambda: pc.state_count() > 1, "committed a wave")
        pc.request_stop()
    pc.join()
    assert pc.is_done()
    assert 0 < pc.unique_state_count() < 8_832
    if how == "timeout":
        assert pc.waves() == 1


def test_wave_engine_stop_on_a_flagged_wave_leaves_a_resumable_snapshot(tmp_path):
    """A deadline that lands on a flagged wave keeps the committed result
    and erases the wave's aborted table writes: here the first wave
    overflows a one-row log, so the snapshot's table holds the init
    state's key alone, and a run resumed from it reaches the full
    search's 8,832 unique / 58,146 states."""
    geometry = dict(capacity=1 << 14, max_frontier=1 << 4)
    pc = TwoPhaseSys(rm_count=5).checker().timeout(0.0).spawn_gpu(
        device="cpu", log_capacity=1, **geometry
    ).join()
    assert pc.waves() == 1 and pc.unique_state_count() == 1
    snap = tmp_path / "flagged.npz"
    pc.save_snapshot(str(snap))
    with np.load(snap) as arrays:
        keys = (arrays["key_hi"] != 0) | (arrays["key_lo"] != 0)
        assert int(keys.sum()) == int(arrays["tail"]) == 1
    resumed = TwoPhaseSys(rm_count=5).checker().spawn_gpu(
        device="cpu", resume_from=str(snap), **geometry
    ).join()
    assert resumed.unique_state_count() == 8_832
    assert resumed.state_count() == 58_146
