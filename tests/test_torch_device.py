"""The port on the card, and what needs no JAX at all.

This file imports neither ``jax`` nor ``stateright_tpu``, so it runs on
the machine with the card, where JAX is not installed:

    python -m pytest -m cuda tests/test_torch_device.py

The ``cuda`` tests hold each hand-written kernel against its plain-torch
twin on the same tensors on the card, and the engine's card run against
its CPU run.  They decide inside the test whether a card is present, so
every worker collects the same tests; here they skip.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from stateright_tpu_torch.actor import Envelope, Id, Network
from stateright_tpu_torch.actor.register import Get, Internal, Put
from stateright_tpu_torch.models import abd_compiled as ac
from stateright_tpu_torch.models import fixtures as fx
from stateright_tpu_torch.models import lww_compiled as lc
from stateright_tpu_torch.models import paxos as port_paxos
from stateright_tpu_torch.models import paxos_compiled as pc
from stateright_tpu_torch.models import ping_pong_compiled as ppc
from stateright_tpu_torch.models import raft_compiled as rc
from stateright_tpu_torch.models import single_copy_compiled as scc
from stateright_tpu_torch.models.abd import AbdModelCfg
from stateright_tpu_torch.models.lww_register import build_model as lww_model
from stateright_tpu_torch.models.paxos import PaxosModelCfg
from stateright_tpu_torch.models.ping_pong import PingPongCfg
from stateright_tpu_torch.models.raft import RaftModelCfg
from stateright_tpu_torch.models.single_copy_register import SingleCopyModelCfg
from stateright_tpu_torch.models.twophase import TwoPhaseSys
from stateright_tpu_torch.models.twophase_compiled import (
    twophase_step, twophase_step_plain,
)
from stateright_tpu_torch.ops.device_fp import device_fp64, device_fp64_plain
from stateright_tpu_torch.ops.u32 import from_numpy_u32
from stateright_tpu_torch.parallel.hashset import (
    HashSet, _sorted_runs_plain, _sorted_runs_prefix, insert_batch_claim,
    insert_batch_claim_plain, keys_equal, prededup, prededup_plain,
    prededup_prefix,
)
from stateright_tpu_torch.parallel import canon
from stateright_tpu_torch.parallel.wave_common import (
    compact, compact_plain, wave_eval, wave_eval_plain,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRY = dict(capacity=1 << 14, max_frontier=1 << 9)


def _t(a, device):
    return from_numpy_u32(a, device)


def _random_rows(rng, n, count):
    """Encodable packed 2pc rows: every field in range."""
    rm = rng.integers(0, 4, size=(count, n), dtype=np.uint64)
    w0 = (rm << (2 * np.arange(n, dtype=np.uint64))).sum(1)
    w0 |= rng.integers(0, 3, size=count, dtype=np.uint64) << np.uint64(24)
    w1 = rng.integers(0, 1 << (2 * n + 2), size=count, dtype=np.uint64)
    return np.stack([w0, w1], 1).astype(np.uint32)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import stateright_tpu_torch\n"
        "from stateright_tpu_torch.models.twophase import TwoPhaseSys\n"
        "c = TwoPhaseSys(rm_count=3).checker().spawn_gpu(device='cpu').join()\n"
        "assert c.unique_state_count() == 288\n"
        "from stateright_tpu_torch.actor import Network\n"
        "from stateright_tpu_torch.models.paxos import PaxosModelCfg\n"
        "m = PaxosModelCfg(1, 3, Network.new_unordered_nonduplicating()).into_model()\n"
        "c = m.checker().spawn_gpu(device='cpu', capacity=1 << 12,"
        " max_frontier=1 << 8).join()\n"
        "assert c.unique_state_count() == 265, c.unique_state_count()\n"
        "m = PaxosModelCfg(4, 3, Network.new_unordered_nonduplicating()).into_model()\n"
        "c = m.checker().target_max_depth(5).spawn_gpu(device='cpu',"
        " capacity=1 << 12, max_frontier=1 << 8).join()\n"
        "assert c.max_depth() == 5, c.max_depth()\n"
        "from stateright_tpu_torch.models.single_copy_register import"
        " SingleCopyModelCfg\n"
        "m = SingleCopyModelCfg(2, 1, Network.new_unordered_nonduplicating())"
        ".into_model()\n"
        "c = m.checker().spawn_gpu(device='cpu', capacity=1 << 10,"
        " max_frontier=1 << 6).join()\n"
        "assert c.unique_state_count() == 93, c.unique_state_count()\n"
        "from stateright_tpu_torch.models.abd import AbdModelCfg\n"
        "m = AbdModelCfg(2, 2, Network.new_ordered()).into_model()\n"
        "c = m.checker().spawn_gpu(device='cpu', capacity=1 << 12,"
        " max_frontier=1 << 8).join()\n"
        "assert c.unique_state_count() == 620, c.unique_state_count()\n"
        "from stateright_tpu_torch.models.raft import RaftModelCfg\n"
        "m = RaftModelCfg(server_count=3).into_model()\n"
        "c = m.checker().target_max_depth(4).spawn_gpu(device='cpu',"
        " capacity=1 << 12, max_frontier=1 << 8).join()\n"
        "assert c.unique_state_count() == 367, c.unique_state_count()\n"
        "from stateright_tpu_torch.models.ping_pong import PingPongCfg\n"
        "m = PingPongCfg(False, 6).into_model().lossy_network_(True)\n"
        "c = m.checker().spawn_gpu(device='cpu', capacity=1 << 16,"
        " max_frontier=1 << 12).join()\n"
        "assert c.unique_state_count() == 16382, c.unique_state_count()\n"
        "assert 'sortless=0' in c._grow_notes, c._grow_notes\n"
        "m = PaxosModelCfg(2, 3, Network.new_unordered_nonduplicating(),"
        " max_round=1).into_model()\n"
        "c = m.checker().spawn_gpu(device='cpu', capacity=1 << 12,"
        " max_frontier=1 << 8).join()\n"
        "assert c.unique_state_count() == 1834, c.unique_state_count()\n"
        "import stateright_tpu_torch.parallel.canon\n"
        "c = TwoPhaseSys(rm_count=3).checker().symmetry().spawn_gpu("
        "device='cpu').join()\n"
        "assert c.unique_state_count() == 80, c.unique_state_count()\n"
        "import stateright_tpu_torch.models.lww_compiled\n"
        "from stateright_tpu_torch.models.lww_register import build_model\n"
        "c = build_model(2).checker().target_max_depth(4).spawn_gpu("
        "device='cpu', capacity=1 << 12, max_frontier=1 << 8).join()\n"
        "assert c.unique_state_count() == 706, c.unique_state_count()\n"
        "from stateright_tpu_torch.models.fixtures import TrapCounter\n"
        "c = TrapCounter().checker().symmetry_fn(lambda s: s).spawn_gpu("
        "device='cpu', capacity=1 << 10, max_frontier=1 << 4).join()\n"
        "assert sorted(c.discoveries()) == ['reaches limit', 'trapped']\n"
        "import stateright_tpu_torch.parallel.simulation_gpu, stateright_tpu_torch.ensemble\n"
        "import stateright_tpu_torch.ops.prng, stateright_tpu_torch.runtime.journal\n"
        "c = TwoPhaseSys(rm_count=3).checker().target_state_count(1)"
        ".spawn_gpu_simulation(seed=3, walkers=64, max_trace_len=32, device='cpu').join()\n"
        "assert c.state_count() > 64, c.state_count()\n"
        "from stateright_tpu_torch.ensemble import run_ensemble\n"
        "r = run_ensemble(members=16, seed=7, steps=24, fault='skip_ack',"
        " chaos='{\"default\": {\"drop\": 0.1}}', replay=False, device='cpu')\n"
        "assert r.states_walked > 16 and r.failing, r.to_dict()\n"
        "import stateright_tpu_torch.tiered, stateright_tpu_torch.obs.metrics\n"
        "c = TwoPhaseSys(rm_count=3).checker().spawn_gpu_tiered(device='cpu',"
        " capacity=256, max_frontier=1 << 6).join()\n"
        "assert c.unique_state_count() == 288 and c.metrics()['spills'] >= 1\n"
        "import tempfile, stateright_tpu_torch.incr\n"
        "from stateright_tpu_torch.incr import incremental_check\n"
        "from stateright_tpu_torch.models.fixtures import GridWalk\n"
        "d = tempfile.mkdtemp()\n"
        "for b, mode in ((4, 'cold'), (7, 'constant_widening'), (7, 'identical')):\n"
        "    c, info = incremental_check(GridWalk(bound=b).checker(), d,"
        " engine_kwargs=dict(device='cpu', capacity=1 << 12, max_frontier=1 << 6))\n"
        "    assert info['mode'] == mode and c.unique_state_count() == (b + 1) ** 2\n"
        "from stateright_tpu_torch.fleet import gang_eligibility, run_gang\n"
        "from stateright_tpu_torch.serve import workloads\n"
        "from stateright_tpu_torch.serve.jobs import JobSpec\n"
        "ms = [GridWalk(bound=b) for b in (2, 3)]\n"
        "r, w = run_gang([{'tag': i, 'model': m, 'cm': m.compiled(), 'consts':"
        " m.compiled().gang_constants()} for i, m in enumerate(ms)], device='cpu')\n"
        "assert [c.unique_state_count() for _, c, _ in r] == [9, 16], r\n"
        "assert gang_eligibility(JobSpec.from_dict({'workload': 'grid_walk'}))[0]\n"
        "for name in workloads.workload_names():\n"
        "    workloads.build_model(name)\n"
        "c = TwoPhaseSys(rm_count=3).checker().visitor(lambda p: None).spawn_gpu("
        "device='cpu', capacity=1 << 12).join()\n"
        "assert c.trace_summary()['traced_waves'] == 11, c.trace_summary()\n"
        "import stateright_tpu_torch.parallel.sharded\n"
        "c = TwoPhaseSys(rm_count=3).checker().spawn_gpu_sharded("
        "mesh=['cpu'] * 2, capacity=1 << 13, chunk_size=1 << 6).join()\n"
        "assert c.unique_state_count() == 288, c.unique_state_count()\n"
        "import stateright_tpu_torch.tiered.sharded_engine\n"
        "import stateright_tpu_torch.tiered.reshard\n"
        "c = TwoPhaseSys(rm_count=3).checker().spawn_gpu_tiered_sharded("
        "mesh=['cpu'] * 2, memory_budget_mb=0.004).join()\n"
        "assert c.unique_state_count() == 288, c.unique_state_count()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'stateright_tpu' or m.startswith('stateright_tpu.'))\n"
        "assert not bad, bad\n"
        "print('isolated')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "isolated"


def test_every_kernel_source_is_in_the_parallel_build():
    """``ops/cuda.py`` ``SOURCES`` names every ``csrc/*.cu``: the up-front
    build compiles them all together, so no kernel is first compiled
    inside a timed run."""
    from stateright_tpu_torch.ops import cuda

    assert sorted(cuda.SOURCES) == sorted(p.stem for p in cuda.CSRC.glob("*.cu"))


def test_spawn_gpu_defaults_to_the_card():
    """No device means CUDA: with no card the spawn raises instead of
    carrying on on the CPU; with one, rm=3 runs there.  The sharded spawn
    with no mesh is one shard a visible card, and raises alike, as does
    the tiered-sharded spawn."""
    builder = TwoPhaseSys(rm_count=3).checker()
    spawns = (builder.spawn_gpu, builder.spawn_gpu_sharded,
              builder.spawn_gpu_tiered_sharded)
    if not torch.cuda.is_available():
        for spawn in spawns:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                spawn()
        return
    for spawn in spawns:
        assert spawn().join().unique_state_count() == 288


def test_port_snapshot_resumes_in_the_port(tmp_path):
    """save_snapshot -> resume_from round trip inside the port: a run cut
    by target_state_count(3000) and resumed ends bit-equal to a straight
    run (the JAX-snapshot direction is in test_torch_engine.py)."""
    model = TwoPhaseSys(rm_count=5)
    geometry = dict(device="cpu", capacity=1 << 15, max_frontier=1 << 7)
    partial = model.checker().target_state_count(3000).spawn_gpu(**geometry).join()
    assert 3000 <= partial.state_count() < 58146
    snap = tmp_path / "partial.npz"
    partial.save_snapshot(str(snap))
    resumed = model.checker().spawn_gpu(resume_from=str(snap), **geometry).join()
    straight = model.checker().spawn_gpu(**geometry).join()
    assert (resumed.unique_state_count(), resumed.state_count(), resumed.max_depth()) == (
        straight.unique_state_count(), straight.state_count(), straight.max_depth()
    )
    for a, b in zip(_logs(resumed, tmp_path / "r.npz"), _logs(straight, tmp_path / "s.npz")):
        assert np.array_equal(a, b)
    assert sorted(resumed.discoveries()) == sorted(straight.discoveries())


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _logs(checker, path, width=2):
    checker.save_snapshot(str(path))
    with np.load(path) as snap:
        tail = int(snap["tail"])
        return [snap[k][: tail * w].copy() for k, w in
                (("rows", width), ("parent", 1), ("ebits", 1))]


@pytest.mark.cuda
def test_cuda_engine_matches_cpu_run(tmp_path):
    _card()
    model = TwoPhaseSys(rm_count=5)
    gpu = model.checker().spawn_gpu(device="cuda", **GEOMETRY).join()
    cpu = model.checker().spawn_gpu(device="cpu", **GEOMETRY).join()
    assert (gpu.unique_state_count(), gpu.state_count(), gpu.max_depth()) == (
        8832, 58146, 17
    )
    g, c = _logs(gpu, tmp_path / "gpu.npz"), _logs(cpu, tmp_path / "cpu.npz")
    for a, b in zip(g, c):
        assert np.array_equal(a, b)
    assert np.array_equal(gpu.discovered_fingerprints(), cpu.discovered_fingerprints())
    gpu.assert_properties()


@pytest.mark.cuda
def test_cuda_device_fp64_matches_twin():
    dev = _card()
    rng = np.random.default_rng(21)
    for width in (1, 2, 5, 42):
        words = _t(
            rng.integers(0, 2**32, size=(70_000, width), dtype=np.uint32), dev
        )
        for k, p in zip(device_fp64(words), device_fp64_plain(words)):
            assert torch.equal(k, p)


@pytest.mark.cuda
def test_cuda_twophase_step_matches_twin():
    dev = _card()
    rng = np.random.default_rng(22)
    for n in (3, 10, 12):
        rows = _t(_random_rows(rng, n, 50_000), dev)
        for k, p in zip(twophase_step(rows, n), twophase_step_plain(rows, n)):
            assert torch.equal(k, p)


@pytest.mark.cuda
def test_cuda_compact_matches_twin():
    dev = _card()
    rng = np.random.default_rng(23)
    for b in (1, 2047, 2048, 2049, 1_000_003):
        mask = torch.from_numpy(rng.random(b) < 0.4).to(dev)
        n_valid = int(mask.sum())
        for size in {max(n_valid - 1, 0), n_valid, n_valid + 1, b}:
            k_out, k_count = compact(mask, size)
            p_out, p_count = compact_plain(mask, size)
            assert torch.equal(k_out, p_out)
            assert int(k_count) == int(p_count) == n_valid


@pytest.mark.cuda
@pytest.mark.parametrize("n", [300_000, 1, 4095, 4096, 4097])
def test_cuda_insert_batch_claim_matches_twin(n):
    """K4's host entry against its twin: the grid path (300,000 lanes, a
    tile and one) and the one-block path (up to a tile of 4,096 lanes),
    keys with hi >= 2**31, duplicates and keys present before."""
    dev = _card()
    rng = np.random.default_rng(24)
    cap = 1 << 20
    k_table = HashSet.empty(cap, dev)
    p_keys = torch.zeros(cap, dtype=torch.int64, device=dev)
    for _ in range(4):
        keys = rng.integers(1, 2**64, size=n, dtype=np.uint64)
        dup = rng.random(n) < 0.5
        keys[dup] = rng.integers(1, 2**16, size=int(dup.sum()), dtype=np.uint64)
        hi = _t((keys >> np.uint64(32)).astype(np.uint32), dev)
        lo = _t((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32), dev)
        active = torch.from_numpy(rng.random(n) < 0.7).to(dev)
        k_new, k_ok, slot = insert_batch_claim(k_table, hi, lo, active,
                                               with_slots=True)
        p_new, p_ok = insert_batch_claim_plain(p_keys, hi, lo, active)
        assert torch.equal(k_new, p_new) and bool(k_ok) and bool(p_ok)
        assert keys_equal(k_table, HashSet(p_keys))
        key = (hi.long() << 32) | (lo.long() & 0xFFFFFFFF)
        act = torch.nonzero(active).flatten()
        assert torch.equal(k_table.keys[slot[act].long()], key[act])
        assert bool((slot[~active] == -1).all())


def _paxos(c, never_decided=False):
    return PaxosModelCfg(
        c, 3, Network.new_unordered_nonduplicating(), never_decided=never_decided
    ).into_model()


def _paxos_rows(c, depth):
    """Reachable paxos rows from the port's CPU run to ``depth``, plus
    hand-made rows on the flagged, wrapping branches (the cases of
    test_torch_paxos.py::_hazard_rows) and a slot overflow."""
    model = _paxos(c)
    run = model.checker().target_max_depth(depth).spawn_gpu(
        device="cpu", capacity=1 << 17, max_frontier=1 << 13
    ).join()
    cm = model.compiled()
    w = cm.state_width
    rows = run._carry.rows[: run._carry.tail * w].view(-1, w)

    def server(ballot, prepares=(), accepts=frozenset(), decided=False):
        return port_paxos.PaxosState(
            ballot=ballot, proposal=None, prepares=tuple(prepares),
            accepts=accepts, accepted=None, is_decided=decided,
        )

    def row(servers, envs):
        r = np.zeros(w, np.uint32)
        for i, st in enumerate(servers):
            bits = cm._encode_server(st)
            r[2 * i], r[2 * i + 1] = bits & 0xFFFFFFFF, bits >> 32
        r[6] = 0x666
        codes = sorted(cm._env_code(e) for e in envs)[: cm.m]
        r[7 : 7 + len(codes)] = codes
        return r

    idle = server((0, Id(0)))
    b0, b1 = (1, Id(0)), (1, Id(1))
    prepares = [
        Envelope(Id(s), Id(d), Internal(port_paxos.Prepare((r, Id(s)))))
        for r in range(2, 16) for s in range(3) for d in range(3) if s != d
    ]
    hand = np.stack([
        row([idle, server((0, Id(0)), decided=True), idle],
            [Envelope(Id(3), Id(1), Get(6))]),
        row([idle, server(b1, prepares=[(Id(1), None)]), idle],
            [Envelope(Id(0), Id(1), Internal(port_paxos.Prepared(b1, None)))]),
        row([server(b0, accepts=frozenset([Id(0)])), idle, idle],
            [Envelope(Id(2), Id(0), Internal(port_paxos.Accepted(b0)))] * 2),
        row([idle, idle, idle], [Envelope(Id(3), Id(0), Put(3, "A"))] + prepares),
    ])
    return torch.cat([rows, from_numpy_u32(hand, "cpu")])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "c,depth", [(1, 30), (2, 30), (3, 9), (4, 5), (5, 4), (6, 4), (7, 3)]
)
def test_cuda_paxos_kernels_match_twins(c, depth):
    """K5, K7 (every lane, then a compacted buffer with a short count) and
    K6 against their twins, bit for bit, on reachable and hand-made rows."""
    dev = _card()
    rows = _paxos_rows(c, depth)
    card = rows.to(dev)
    valid = pc.paxos_step_valid(card, c)
    assert torch.equal(valid.cpu(), pc.paxos_step_valid_plain(rows, c))
    f, m = valid.shape
    lanes = torch.arange(f * m, dtype=torch.int32)
    k_next, k_flag = pc.paxos_step_lane(
        card, lanes.to(dev), torch.tensor(f * m, device=dev), c
    )
    p_next, p_flag = pc.paxos_step_lane_plain(rows, lanes, f * m, c)
    assert torch.equal(k_next.cpu(), p_next)
    assert torch.equal(k_flag.cpu(), p_flag)
    assert bool(p_flag[-4 * m :].any())  # the hand-made rows flag
    v_orig, n = compact(valid.view(-1), f * m)
    short = n - 1
    k_next, k_flag = pc.paxos_step_lane(card, v_orig, short, c)
    p_next, p_flag = pc.paxos_step_lane_plain(rows, v_orig.cpu(), int(short), c)
    live = int(short)
    assert torch.equal(k_next[:live].cpu(), p_next[:live])
    assert torch.equal(k_flag.cpu(), p_flag)
    for never_decided in (False, True):
        assert torch.equal(
            pc.paxos_conds(card, c, never_decided).cpu(),
            pc.paxos_conds_plain(rows, c, never_decided),
        )


@pytest.mark.cuda
def test_cuda_wave_eval_matches_twin():
    dev = _card()
    rng = np.random.default_rng(25)
    f, p, a = 100_003, 5, 32
    kinds = (0b00101, 0b00010, 0b11000)  # always, sometimes, eventually
    for discovered in (0, 0b00011, 0b11111):
        conds = torch.from_numpy(rng.random((f, p)) < [0.999, 0.01, 0.5, 0.3, 0.6])
        valid = torch.from_numpy(rng.random((f, a)) < 0.05)
        eb = torch.from_numpy(rng.integers(0, 4, f).astype(np.int32))
        want = wave_eval_plain(conds, valid, eb, 777, kinds, discovered)
        got = wave_eval(conds.to(dev), valid.to(dev), eb.to(dev), 777, kinds,
                        discovered)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_cuda_paxos_engine_matches_cpu_run(tmp_path):
    """``paxos check 2`` on the card: two-phase waves through K1 and K3-K8,
    its row log, parents and ebits bit-equal to the CPU run."""
    _card()
    geometry = dict(capacity=1 << 16, max_frontier=1 << 12)
    gpu = _paxos(2).checker().spawn_gpu(device="cuda", **geometry).join()
    cpu = _paxos(2).checker().spawn_gpu(device="cpu", **geometry).join()
    assert (gpu.unique_state_count(), gpu.state_count(), gpu.max_depth()) == (
        16_668, 32_971, 21
    )
    w = pc.state_width(2)
    g = _logs(gpu, tmp_path / "gpu.npz", w)
    c = _logs(cpu, tmp_path / "cpu.npz", w)
    for a, b in zip(g, c):
        assert np.array_equal(a, b)
    assert sorted(gpu.discoveries()) == ["value chosen"]
    gpu.assert_properties()


def _fuzz_rows(rng, n, width, net0, m, tags):
    """Random rows with a sorted slot section, as every encoded or stepped
    row has (nonzero codes ascending, then zeros): random words elsewhere,
    slots of random envelopes of the given tags, some empty, some
    repeated."""
    rows = rng.integers(0, 2**32, size=(n, width), dtype=np.uint64)
    tag = rng.integers(0, tags, size=(n, m), dtype=np.uint64)
    addr = rng.integers(0, 32, size=(n, m), dtype=np.uint64)
    payload = rng.integers(0, 1 << 14, size=(n, m), dtype=np.uint64)
    codes = 1 + ((tag << np.uint64(19)) | (addr << np.uint64(14)) | payload)
    codes[rng.random((n, m)) < 0.4] = 0
    dup = rng.random((n, m)) < 0.1
    codes[:, 1:][dup[:, 1:]] = codes[:, :-1][dup[:, 1:]]
    codes = np.where(codes == 0, np.uint64(2**32), codes)
    codes = np.sort(codes, axis=1)
    rows[:, net0 : net0 + m] = np.where(codes == 2**32, 0, codes)
    return rows.astype(np.uint32)


@pytest.mark.cuda
@pytest.mark.parametrize("c", range(1, 8))
def test_cuda_paxos_kernels_match_twins_on_fuzzed_rows(c):
    """K5, K6 (the DP at every client count) and K7 on random rows with
    sorted slots: every branch, guard and wrap-around the words reach.
    The twins run on the card too (plain torch)."""
    dev = _card()
    m, w = pc.slot_count(c), pc.state_width(c)
    card = from_numpy_u32(_fuzz_rows(np.random.default_rng(40 + c), 20_000, w, 7, m, 9), dev)
    assert torch.equal(pc.paxos_step_valid(card, c), pc.paxos_step_valid_plain(card, c))
    for never_decided in (False, True):
        assert torch.equal(
            pc.paxos_conds(card, c, never_decided),
            pc.paxos_conds_plain(card, c, never_decided),
        )
    f = card.shape[0]
    lanes = torch.arange(f * m, dtype=torch.int32, device=dev)
    k_next, k_flag = pc.paxos_step_lane(card, lanes, torch.tensor(f * m, device=dev), c)
    p_next, p_flag = pc.paxos_step_lane_plain(card, lanes, f * m, c)
    assert torch.equal(k_next, p_next)
    assert torch.equal(k_flag, p_flag)


def _single_copy(c, s):
    return SingleCopyModelCfg(c, s, Network.new_unordered_nonduplicating()).into_model()


@pytest.mark.cuda
@pytest.mark.parametrize("c,s", [(1, 1), (2, 1), (2, 2), (3, 1), (4, 1), (5, 1), (7, 2)])
def test_cuda_single_copy_step_matches_twin(c, s):
    """K9 against its twin (both on the card) on the rows of the port's
    CPU run to depth 6 and on fuzzed rows with sorted slots: successors,
    validity, conds and the overflow flag, bit for bit."""
    dev = _card()
    run = _single_copy(c, s).checker().target_max_depth(6).spawn_gpu(
        device="cpu", capacity=1 << 16, max_frontier=1 << 12
    ).join()
    w, m = scc.state_width(c), scc.slot_count(c)
    reached = run._carry.rows[: run._carry.tail * w].view(-1, w).to(dev)
    fuzz = from_numpy_u32(_fuzz_rows(np.random.default_rng(60 + c), 20_000, w, 2, m, 4), dev)
    for rows in (reached, fuzz):
        got = scc.single_copy_step(rows, s, c)
        want = scc.single_copy_step_plain(rows, s, c)
        for g, p in zip(got, want):
            assert torch.equal(g, p)


@pytest.mark.cuda
def test_cuda_single_copy_engine_matches_cpu_run(tmp_path):
    """2 clients / 2 servers (the counterexample) and 3 clients / 1 server
    on the card, bit-equal to the CPU runs."""
    _card()
    geometry = dict(capacity=1 << 14, max_frontier=1 << 8)
    for c, s in ((2, 2), (3, 1)):
        gpu = _single_copy(c, s).checker().spawn_gpu(device="cuda", **geometry).join()
        cpu = _single_copy(c, s).checker().spawn_gpu(device="cpu", **geometry).join()
        w = scc.state_width(c)
        for a, b in zip(_logs(gpu, tmp_path / "gpu.npz", w), _logs(cpu, tmp_path / "cpu.npz", w)):
            assert np.array_equal(a, b)
        assert sorted(gpu.discoveries()) == sorted(cpu.discoveries())
    assert "linearizable" in _single_copy(2, 2).checker().spawn_gpu(
        device="cuda", **geometry
    ).join().discoveries()


@pytest.mark.cuda
def test_cuda_paxos_check_6_golden():
    """``paxos check 6`` (bench.sh:28) on one card: 9,357,525 unique
    states at depth 28."""
    _card()
    checker = _paxos(6).checker().spawn_gpu(
        capacity=1 << 25, log_capacity=1 << 24, max_frontier=1 << 17,
        dedup_factor=4,
    ).join()
    assert (checker.unique_state_count(), checker.max_depth()) == (9_357_525, 28)
    assert sorted(checker.discoveries()) == ["value chosen"]


@pytest.mark.cuda
def test_cuda_single_copy_check_4_golden():
    """``single-copy-register check 4`` (bench.sh:29) on one card: 400,233
    unique states at depth 17."""
    _card()
    checker = _single_copy(4, 1).checker().spawn_gpu(
        capacity=1 << 21, max_frontier=1 << 14, dedup_factor=1,
    ).join()
    assert (checker.unique_state_count(), checker.max_depth()) == (400_233, 17)
    assert sorted(checker.discoveries()) == ["value chosen"]


def abd_fuzz_rows(rng, n, c, ordered):
    """Random packed ABD rows: random words, network words of random
    envelopes of the eight tags and one past them, some empty; the
    unordered slots sorted as every encoded row has them (nonzero codes
    ascending, then zeros), with some repeated."""
    w, m = ac.state_width(c, ordered), ac.net_words(c, ordered)
    rows = rng.integers(0, 2**32, size=(n, w), dtype=np.uint64)
    tag = rng.integers(0, 9, size=(n, m), dtype=np.uint64)
    addr = rng.integers(0, 16, size=(n, m), dtype=np.uint64)
    payload = rng.integers(0, 1 << 14, size=(n, m), dtype=np.uint64)
    codes = 1 + ((tag << np.uint64(18)) | (addr << np.uint64(14)) | payload)
    codes[rng.random((n, m)) < 0.4] = 0
    if not ordered:
        dup = rng.random((n, m)) < 0.1
        codes[:, 1:][dup[:, 1:]] = codes[:, :-1][dup[:, 1:]]
        codes = np.where(codes == 0, np.uint64(2**32), codes)
        codes = np.sort(codes, axis=1)
        codes = np.where(codes == 2**32, 0, codes)
    rows[:, 3 : 3 + m] = codes
    return rows.astype(np.uint32)


def _abd(c, ordered, fault=None):
    net = Network.new_ordered() if ordered else Network.new_unordered_nonduplicating()
    return AbdModelCfg(c, 2, net, fault=fault).into_model()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 2, 3])
@pytest.mark.parametrize("ordered", [False, True])
@pytest.mark.parametrize("fault", [None, "skip_ack"])
def test_cuda_abd_step_matches_twin(c, ordered, fault):
    """K10 against its twin (both on the card) on the rows of the port's
    CPU run to depth 10 and on fuzzed rows: successors, validity, conds
    and the overflow flag, bit for bit; the flag also a state at a time,
    on fuzzed rows that flag and rows that do not."""
    dev = _card()
    skip = fault == "skip_ack"
    run = _abd(c, ordered, fault).checker().target_max_depth(10).spawn_gpu(
        device="cpu", capacity=1 << 14, max_frontier=1 << 10
    ).join()
    w = ac.state_width(c, ordered)
    reached = run._carry.rows[: run._carry.tail * w].view(-1, w).to(dev)
    fuzz = from_numpy_u32(abd_fuzz_rows(np.random.default_rng(80 + c), 20_000, c, ordered), dev)
    for rows in (reached, fuzz):
        got = ac.abd_step(rows, c, ordered, skip)
        want = ac.abd_step_plain(rows, c, ordered, skip)
        for g, p in zip(got, want):
            assert torch.equal(g, p)
    flags = ac.abd_lanes_plain(fuzz, c, ordered, skip)[2].any(dim=1)
    flagged = torch.nonzero(flags).flatten()
    assert flagged.numel()
    picked = torch.cat([flagged[:32], torch.nonzero(~flags).flatten()[:32]])
    for i in picked.tolist():
        assert bool(ac.abd_step(fuzz[i : i + 1], c, ordered, skip)[3]) == bool(flags[i])


@pytest.mark.cuda
def test_cuda_abd_engine_matches_cpu_run(tmp_path):
    """2 clients on both fabrics on the card, bit-equal to the CPU runs
    (544 and 620 unique states), and the skip_ack counterexample."""
    _card()
    for ordered, golden in ((False, 544), (True, 620)):
        gpu = _abd(2, ordered).checker().spawn_gpu(device="cuda", **GEOMETRY).join()
        cpu = _abd(2, ordered).checker().spawn_gpu(device="cpu", **GEOMETRY).join()
        assert gpu.unique_state_count() == golden
        w = ac.state_width(2, ordered)
        for a, b in zip(_logs(gpu, tmp_path / "gpu.npz", w), _logs(cpu, tmp_path / "cpu.npz", w)):
            assert np.array_equal(a, b)
        assert sorted(gpu.discoveries()) == sorted(cpu.discoveries())
    bad = _abd(2, True, "skip_ack").checker().spawn_gpu(device="cuda", **GEOMETRY).join()
    path = bad.discoveries()["linearizable"]
    assert path.last_state().history.serialized_history() is None


@pytest.mark.cuda
@pytest.mark.parametrize("ordered,golden", [(False, 35_009), (True, 46_516)])
def test_cuda_abd_check_3_golden(ordered, golden):
    """``linearizable-register check 3`` on one card, on both fabrics
    (``check 3 ordered`` is bench.sh:33): the golden unique states at
    depth 37."""
    _card()
    checker = _abd(3, ordered).checker().spawn_gpu(
        capacity=1 << 17, max_frontier=1 << 13, dedup_factor=1,
    ).join()
    assert (checker.unique_state_count(), checker.max_depth()) == (golden, 37)
    assert sorted(checker.discoveries()) == ["value chosen"]


# --- raft (K11) ------------------------------------------------------------------


def _sorted_slots(rows):
    """``rows`` with each row's 24 envelope slots in the codec's order:
    nonzero codes ascending by (w0, w1), then zero pairs."""
    u = np.uint64
    rows = rows.astype(u)
    w0 = rows[:, rc.NET0 : rc.NONFP0 : 2]
    w1 = rows[:, rc.NET0 + 1 : rc.NONFP0 : 2]
    key = np.sort(np.where(w0 == 0, u(2**64 - 1), (w0 << u(32)) | w1), axis=1)
    empty = key == u(2**64 - 1)
    rows[:, rc.NET0 : rc.NONFP0 : 2] = np.where(empty, 0, key >> u(32))
    rows[:, rc.NET0 + 1 : rc.NONFP0 : 2] = np.where(empty, 0, key & u(0xFFFFFFFF))
    return rows.astype(np.uint32)


def raft_fuzz_rows(rng, n):
    """Random packed raft rows: random node records and delivered/buffer
    words, timer bits with a node crashed now and then, and up to 24
    envelopes of random fields and suffixes (tags 0..7, a few codes with
    stray high bits), some repeated, in the codec's slot order."""
    u = np.uint64
    m = rc.NET_SLOTS
    rows = rng.integers(0, 2**32, size=(n, rc.W), dtype=u)
    rows[:, 1 : 2 * rc.N : 2] &= u((1 << 24) - 1)
    crashed = (rng.random((n, rc.N)) < 0.15).astype(u) << (u(6) + np.arange(rc.N, dtype=u))
    rows[:, 2 * rc.N] = rng.integers(0, 64, size=n, dtype=u) | crashed.sum(1)
    tag = np.where(rng.random((n, m)) < 0.9, rng.integers(1, 6, size=(n, m)),
                   rng.integers(0, 8, size=(n, m))).astype(u)
    w0 = tag | (rng.integers(0, 1 << 20, size=(n, m), dtype=u) << u(3))
    stray = rng.random((n, m)) < 0.05
    w0[stray] |= rng.integers(1, 1 << 9, size=int(stray.sum()), dtype=u) << u(23)
    w1 = np.where(rng.random((n, m)) < 0.9, rng.integers(0, 1 << 20, size=(n, m), dtype=u),
                  rng.integers(0, 2**32, size=(n, m), dtype=u))
    count = rng.integers(0, m + 1, size=(n, 1))
    count[rng.random((n, 1)) < 0.2] = m
    dup = rng.random((n, m)) < 0.15
    w0[:, 1:][dup[:, 1:]] = w0[:, :-1][dup[:, 1:]]
    w1[:, 1:][dup[:, 1:]] = w1[:, :-1][dup[:, 1:]]
    keep = np.arange(m)[None, :] < count
    rows[:, rc.NET0 : rc.NONFP0 : 2] = np.where(keep, w0, 0)
    rows[:, rc.NET0 + 1 : rc.NONFP0 : 2] = np.where(keep, w1, 0)
    rows[:, rc.NONFP0 :] &= u((1 << 21) - 1)
    return _sorted_slots(rows)


def raft_hazard_rows(rows):
    """Rows on the branches a short run never takes, made from ``rows``
    (uint32[N, W]): every LogRequest's prefix_len at 0 against full logs;
    delivered messages at DELIV_CAP and full buffers; terms at TERM_CAP
    (an election's next term overflows); every node crashed; the network
    filled to 24 slots with runs of equal codes."""
    u = np.uint32
    out = []
    full = rows.copy()
    for i in range(rc.N):
        full[:, 2 * i] &= ~u(7 << rc._F_LOGLEN[0])
        full[:, 2 * i] |= u(rc.LOG_CAP << rc._F_LOGLEN[0]) | u(0b01011 << rc._LOG0)
    net = full[:, rc.NET0 : rc.NONFP0 : 2]
    net[(net & u(7)) == u(rc._T_LOG_REQ)] &= ~u(7 << 10)
    full[:, rc.NET0 : rc.NONFP0 : 2] = net
    out.append(full)
    deliv = rows.copy()
    nonfp = deliv[:, rc.NONFP0 :]
    deliv[:, rc.NONFP0 :] = (nonfp & ~u(7 | (3 << 13))) | u(rc.DELIV_CAP | (rc.BUF_CAP << 13))
    out.append(deliv)
    terms = rows.copy()
    terms[:, 0 : 2 * rc.N : 2] |= u(rc.TERM_CAP)
    out.append(terms)
    down = rows.copy()
    down[:, 2 * rc.N] |= u(7 << (2 * rc.N))
    out.append(down)
    packed = rows.copy()
    w0 = packed[:, rc.NET0 : rc.NONFP0 : 2]
    w1 = packed[:, rc.NET0 + 1 : rc.NONFP0 : 2]
    for j in range(1, rc.NET_SLOTS):
        empty = w0[:, j] == 0
        w0[empty, j] = w0[empty, j - 1]
        w1[empty, j] = w1[empty, j - 1]
    packed[:, rc.NET0 : rc.NONFP0 : 2] = w0
    packed[:, rc.NET0 + 1 : rc.NONFP0 : 2] = w1
    out.append(packed)
    return _sorted_slots(np.concatenate(out))


RAFT_GEOMETRY = dict(capacity=1 << 15, max_frontier=1 << 8)


def _raft(depth):
    return RaftModelCfg(server_count=3).into_model().checker().target_max_depth(depth)


def test_device_fp64_hashes_a_row_prefix_in_place():
    """A column prefix of wider rows (the identity prefix of a row log)
    fingerprints as the same words copied out: the twin on the CPU, the
    strided K1 where a card is present (test_cuda_device_fp64_prefix)."""
    rows = _t(raft_fuzz_rows(np.random.default_rng(31), 500), "cpu")
    for k, p in zip(device_fp64(rows[:, : rc.NONFP0]),
                    device_fp64_plain(rows[:, : rc.NONFP0].contiguous())):
        assert torch.equal(k, p)


@pytest.mark.cuda
def test_cuda_device_fp64_prefix_matches_twin():
    """The strided K1 on the identity prefix ``rows[:, :55]`` of 58-word
    rows (and on every other prefix width) against the twin on a copy."""
    dev = _card()
    rows = _t(raft_fuzz_rows(np.random.default_rng(32), 70_000), dev)
    for width in (1, 7, rc.NONFP0, rc.W):
        view = rows[:, :width]
        for k, p in zip(device_fp64(view), device_fp64_plain(view.contiguous())):
            assert torch.equal(k, p)


@pytest.mark.cuda
def test_cuda_raft_step_matches_twin():
    """K11 against its twin (both on the card) on the rows of the port's
    CPU run to depth 6, on hazard rows made from them and on fuzzed rows:
    successors, validity, conds and the overflow flag, bit for bit; the
    flag also a state at a time, on fuzzed rows that flag and rows that do
    not."""
    dev = _card()
    run = _raft(6).spawn_gpu(device="cpu", **RAFT_GEOMETRY).join()
    reached = run._carry.rows[: run._carry.tail * rc.W].view(-1, rc.W)
    hazard = raft_hazard_rows(reached.numpy().view(np.uint32))
    fuzz = _t(raft_fuzz_rows(np.random.default_rng(33), 20_000), dev)
    for rows in (reached.to(dev), _t(hazard, dev), fuzz):
        got = rc.raft_step(rows, 1)
        want = rc.raft_step_plain(rows, 1)
        for g, p in zip(got, want):
            assert torch.equal(g, p)
    nexts, valid, flags = rc.raft_lanes_plain(fuzz, 1)
    flags = (flags & valid).any(dim=1)
    flagged = torch.nonzero(flags).flatten()
    assert flagged.numel()
    picked = torch.cat([flagged[:32], torch.nonzero(~flags).flatten()[:32]])
    for i in picked.tolist():
        assert bool(rc.raft_step(fuzz[i : i + 1], 1)[3]) == bool(flags[i])


@pytest.mark.cuda
def test_cuda_raft_engine_matches_cpu_run(tmp_path):
    """``raft check`` to depth 6 on the card, bit-equal to the CPU run:
    4,933 unique / 13,840 states, row log, parents, ebits, fingerprints."""
    _card()
    gpu = _raft(6).spawn_gpu(device="cuda", **RAFT_GEOMETRY).join()
    cpu = _raft(6).spawn_gpu(device="cpu", **RAFT_GEOMETRY).join()
    assert (gpu.unique_state_count(), gpu.state_count(), gpu.max_depth()) == (
        4_933, 13_840, 6
    )
    g = _logs(gpu, tmp_path / "gpu.npz", rc.W)
    c = _logs(cpu, tmp_path / "cpu.npz", rc.W)
    for a, b in zip(g, c):
        assert np.array_equal(a, b)
    assert np.array_equal(gpu.discovered_fingerprints(), cpu.discovered_fingerprints())
    assert sorted(gpu.discoveries()) == ["Election Liveness"]


@pytest.mark.cuda
@pytest.mark.parametrize("dedup_factor,golden", [
    (1, (844_999, 2_525_995, 10)), (8, (844_936, 2_525_950, 10)),
])
def test_cuda_raft_depth_10_golden(dedup_factor, golden):
    """``raft check`` to depth 10 on one card, the JAX engine's counts at
    the same arguments: 844,999 / 2,525,995 on the claim path at
    ``dedup_factor=1``; 844,936 / 2,525,950 at the default, where a flag 4
    falls back to the sorted path and K12's representatives (raft's
    identity is partial) decide which rows stand for a state."""
    _card()
    checker = _raft(10).spawn_gpu(
        capacity=1 << 21, max_frontier=1 << 12, dedup_factor=dedup_factor,
    ).join()
    assert (checker.unique_state_count(), checker.state_count(),
            checker.max_depth()) == golden
    assert sorted(checker.discoveries()) == [
        "Election Liveness", "Election Safety", "Log Liveness",
    ]
    assert checker._sortless == (dedup_factor == 1)


@pytest.mark.cuda
def test_cuda_raft_check_golden():
    """The reference's default ``raft check`` on one card: 12,630,223
    unique / 38,569,420 states at depth 12, the JAX engine's own count at
    ``dedup_factor=1`` (its CPU run, recorded in PERF.md)."""
    _card()
    checker = _raft(12).spawn_gpu(
        capacity=1 << 25, log_capacity=14_000_000, max_frontier=1 << 16,
        dedup_factor=1,
    ).join()
    assert (checker.unique_state_count(), checker.state_count(),
            checker.max_depth()) == (12_630_223, 38_569_420, 12)


def prededup_batches(rng, dev):
    """Batches for K12: keys with hi >= 2**31 beside small ones, an active
    all-ones key, an all-duplicate batch, a batch with no active lane, and
    sizes that are no power of two, up to 2**22 lanes."""
    out = []
    for n, pool, p in ((1, 1, 1.0), (37, 5, 0.9), (4097, 4097, 0.5),
                       (100_003, 20_000, 0.8), ((1 << 22) - 3, 1 << 20, 0.6),
                       (5000, 1, 1.0), (6000, 100, 0.0)):
        keys = rng.integers(0, 1 << 63, size=pool, dtype=np.uint64)
        keys[: pool // 2] |= np.uint64(1 << 63)
        vals = keys[rng.integers(0, pool, size=n)]
        vals[n // 2] = np.uint64(0xFFFFFFFFFFFFFFFF)
        hi = (vals >> np.uint64(32)).astype(np.uint32)
        lo = vals.astype(np.uint32)
        active = torch.from_numpy(rng.random(n) < p).to(dev)
        out.append((_t(hi, dev), _t(lo, dev), active))
    return out


@pytest.mark.cuda
def test_cuda_prededup_matches_twin():
    """K12 + K3 against the twin (a stable torch sort of the sign-flipped
    key) on the card, at dedup_factor 1 and 4 and a 256-lane rung."""
    dev = _card()
    for hi, lo, active in prededup_batches(np.random.default_rng(41), dev):
        for dd, rung in ((1, None), (4, None), (1, 256)):
            got = prededup(hi, lo, active, dd, rung)
            want = prededup_plain(hi, lo, active, dd, rung)
            for g, w in zip(got, want):
                assert torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_prededup_prefix_matches_twin():
    """K12's prefix entry against the twin over the mask of the first
    ``count`` lanes on the card, at counts 0, 1, a third, one ending
    inside a tile, all and past all: the sort on the prefix (keys and
    lanes past it are left unwritten), ``rep`` on every lane, and the
    wrapper at dedup_factor 1 and 4 and a 256-lane rung."""
    dev = _card()
    for hi, lo, _active in prededup_batches(np.random.default_rng(43), dev):
        n = hi.shape[0]
        for m in sorted({0, 1, n // 3, min(n, 2048 + 777), n, n + 5}):
            count = torch.tensor(m, device=dev)
            mask = torch.arange(n, device=dev) < m
            keys, lanes, rep = _sorted_runs_prefix(hi, lo, count)
            want_keys, want_lanes, want_rep = _sorted_runs_plain(hi, lo, mask)
            k = min(m, n)
            assert torch.equal(keys[:k], want_keys[:k])
            assert torch.equal(lanes[:k], want_lanes[:k])
            assert torch.equal(rep, want_rep)
            for dd, rung in ((1, None), (4, None), (1, 256)):
                got = prededup_prefix(hi, lo, count, dd, rung)
                want = prededup_plain(hi, lo, mask, dd, rung)
                for g, w in zip(got, want):
                    assert torch.equal(g, w)


def ping_pong_rows(rng, n, max_nat):
    """Random ping-pong rows: counters in range and past it, random
    envelope sets and markers, and random words."""
    e = ppc.envelope_count(max_nat)
    c = rng.integers(0, 16, size=(n, 2))
    env = rng.integers(0, 1 << e, size=n, dtype=np.uint64)
    last = rng.integers(0, 32, size=n, dtype=np.uint64)
    bits = (c[:, 0] | (c[:, 1] << 4)).astype(np.uint64) | (env << np.uint64(8)) | (
        last << np.uint64(8 + e))
    rows = np.stack([bits & np.uint64(0xFFFFFFFF), bits >> np.uint64(32)], 1)
    rows[: n // 8] = rng.integers(0, 1 << 32, size=(n // 8, 2))
    return rows.astype(np.uint32)


@pytest.mark.cuda
@pytest.mark.parametrize("max_nat", [1, 5, 11, 13])
@pytest.mark.parametrize("lossy", [False, True])
def test_cuda_ping_pong_step_matches_twin(max_nat, lossy):
    """K13 against its twin on the card: every lane's successor, the
    boundary-gated validity and the conds."""
    dev = _card()
    rows = _t(ping_pong_rows(np.random.default_rng(max_nat), 50_000, max_nat), dev)
    for g, w in zip(ppc.ping_pong_step(rows, max_nat, lossy),
                    ppc.ping_pong_step_plain(rows, max_nat, lossy)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("c", range(1, 8))
def test_cuda_paxos_step_matches_twin(c):
    """K14 against its twin on the card, on fuzzed rows and on the rows of
    the port's bounded CPU run, at several ballot bounds."""
    dev = _card()
    m, w = pc.slot_count(c), pc.state_width(c)
    rng = np.random.default_rng(50 + c)
    rows = [_t(_fuzz_rows(rng, 3000, w, pc._NET0, m, 9), dev)]
    if c <= 2:
        run = PaxosModelCfg(c, 3, Network.new_unordered_nonduplicating(),
                            max_round=1).into_model().checker().spawn_gpu(
            device="cpu", capacity=1 << 13, max_frontier=1 << 8).join()
        rows.append(run._carry.rows[: run._carry.tail * w].view(-1, w).to(dev))
    for r in rows:
        for max_round in (0, 1, 3, 14):
            for g, p in zip(pc.paxos_step(r, c, max_round),
                            pc.paxos_step_plain(r, c, max_round)):
                assert torch.equal(g, p)


def _ping_pong(max_nat, lossy=True):
    return PingPongCfg(False, max_nat).into_model().lossy_network_(lossy).checker()


@pytest.mark.cuda
@pytest.mark.parametrize("max_nat,lossy,kw,golden", [
    (1, True, {}, (14, 21, 6)),
    (5, False, {}, (11, 11, 11)),
    (5, True, {}, (4_094, 21_505, 22)),
    (6, True, dict(max_frontier=1 << 12), (16_382, 102_401, 26)),
])
def test_cuda_ping_pong_engine_matches_cpu_run(max_nat, lossy, kw, golden, tmp_path):
    """The reference goldens on the card, bit-equal to the CPU runs; at
    ``max_nat`` 6 with 4,096 states a chunk the run falls back to the
    sorted path and still writes the CPU run's log."""
    _card()
    geo = dict(capacity=1 << 16, **kw)
    gpu = _ping_pong(max_nat, lossy).spawn_gpu(**geo).join()
    cpu = _ping_pong(max_nat, lossy).spawn_gpu(device="cpu", **geo).join()
    assert (gpu.unique_state_count(), gpu.state_count(), gpu.max_depth()) == golden
    for a, b in zip(_logs(gpu, tmp_path / "g.npz"), _logs(cpu, tmp_path / "c.npz")):
        assert np.array_equal(a, b)
    assert sorted(gpu.discoveries()) == sorted(cpu.discoveries())
    assert gpu._grow_notes == cpu._grow_notes
    assert ("sortless=0" in gpu._grow_notes) == bool(kw)


@pytest.mark.cuda
def test_cuda_ping_pong_goldens_at_size():
    """Lossy ``max_nat`` 13 on the claim path, past 2**32 generated
    states: the closed form's 268,435,454 unique / 3,556,769,793 states /
    depth 54 less three states the 64-bit fingerprint merges into logged
    ones and their 34 successors (``chip_smoke.py`` phase 22 finds them);
    and ``max_nat`` 11 at the default dedup_factor, where the full
    buffer's flag 4 falls back to the sorted path and then relaxes to
    ``dedup_factor=1`` at 8,192 states a chunk (16,777,214 / 188,743,681 /
    46)."""
    _card()
    big = _ping_pong(13).spawn_gpu(
        capacity=1 << 30, log_capacity=1 << 28, max_frontier=1 << 16,
        dedup_factor=1).join()
    assert (big.unique_state_count(), big.state_count(), big.max_depth()) == (
        268_435_451, 3_556_769_759, 54)
    del big
    torch.cuda.empty_cache()
    mid = _ping_pong(11).spawn_gpu(capacity=1 << 26, max_frontier=1 << 16).join()
    assert (mid.unique_state_count(), mid.state_count(), mid.max_depth()) == (
        16_777_214, 188_743_681, 46)
    assert mid._grow_notes[-2:] == [
        "sortless=0",
        "dedup_factor=1; max_frontier=32768; max_frontier=16384; max_frontier=8192",
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("c,max_round,golden", [
    (3, 3, (1_194_428, 2_420_477, 28)), (4, 2, (435_244, 867_663, 25)),
])
def test_cuda_bounded_paxos_golden(c, max_round, golden):
    """Bounded paxos on one card, single-phase through K14."""
    _card()
    checker = PaxosModelCfg(
        c, 3, Network.new_unordered_nonduplicating(), max_round=max_round
    ).into_model().checker().spawn_gpu(
        capacity=1 << 22, max_frontier=1 << 16, dedup_factor=1).join()
    assert (checker.unique_state_count(), checker.state_count(),
            checker.max_depth()) == golden
    assert sorted(checker.discoveries()) == ["value chosen"]


SYM_GOLDENS = {5: (314, 2_048, 17), 10: (3_300, 43_298, 32), 12: (6_656, 105_081, 38)}
SYM_GEOMETRY = dict(capacity=1 << 20, max_frontier=1 << 13)
F = canon.field
CANON_SPECS = [
    canon.CanonSpec(3, (F(0, 0, 8), F(1, 0, 2, is_id=True)), (F(2, 0, 4),)),
    canon.CanonSpec(4, (F(1, 0, 32, word_stride=2), F(2, 3, 5, word_stride=2),
                        F(0, 0, 3, is_id=True)), (F(0, 16, 3), F(9, 0, 8))),
    canon.CanonSpec(6, (F(0, 0, 32, word_stride=1), F(6, 0, 32, word_stride=1),
                        F(12, 0, 32, word_stride=1)), ()),
    canon.CanonSpec(16, (F(0, 0, 2), F(1, 0, 2), F(2, 0, 1, bit_stride=2),
                         F(3, 0, 4, word_stride=1, is_id=True)),
                    (F(19, 0, 5), F(19, 27, 5))),
    canon.CanonSpec(5, (F(0, 0, 3, is_id=True),), (F(1, 0, 3),)),
]


def canon_cases(rng, n_rows):
    """(spec, rows) pairs for K15: 2pc at rm=5 and rm=12 on words of every
    bit pattern, then synthetic specs -- a per-record and a global Id
    with sentinel values >= n, a word-aligned layout with a 32-bit key,
    keys past 64 bits, sixteen records, Id fields only -- on words of
    every bit pattern and on small words (many equal keys)."""
    out = []
    for rm in (5, 12):
        spec = TwoPhaseSys(rm_count=rm).compiled().canon_spec()
        out.append((spec, rng.integers(0, 1 << 32, size=(n_rows, 2), dtype=np.uint32)))
    for spec in CANON_SPECS:
        w = 1 + max([f.word + (spec.n - 1) * f.word_stride for f in spec.fields]
                    + [g.word for g in spec.id_fields])
        for high in (1 << 32, 20):
            out.append((spec, rng.integers(0, high, size=(n_rows, w),
                                           dtype=np.uint64).astype(np.uint32)))
    return out


@pytest.mark.cuda
def test_cuda_canonicalize_matches_twin():
    """K15 against its twin on the card, and idempotent there."""
    dev = _card()
    for spec, rows in canon_cases(np.random.default_rng(70), 100_000):
        r = _t(rows, dev)
        got = canon.canonicalize_rows(spec, r)
        assert torch.equal(got, canon.canonicalize_rows_plain(spec, r))
        assert torch.equal(canon.canonicalize_rows(spec, got), got)


def lww_fuzz_rows(rng, n, count):
    """LWW rows for K16: words of every bit pattern, small words with
    trailing empty slots, and sorted slots with duplicate runs beside
    node words whose clocks sit at 0 and 63."""
    w = n + lc.NET_SLOTS
    raw = rng.integers(0, 1 << 32, size=(count, w), dtype=np.uint32)
    small = rng.integers(0, 1 << 15, size=(count, w), dtype=np.uint32)
    small[:, n + 5:] = 0
    runs = np.sort(rng.integers(1, 1 << 14, size=(count, lc.NET_SLOTS)), axis=1)
    runs[:, :3] = runs[:, 3:4]
    nodes = rng.integers(0, 1 << 23, size=(count, n))
    nodes[: count // 3] |= 63 << 11
    nodes[count // 3 : 2 * count // 3] &= ~(63 << 11)
    return np.concatenate([raw, small, np.concatenate([nodes, runs], 1)]).astype(np.uint32)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3])
def test_cuda_lww_step_matches_twin(n):
    """K16 against its twin on the card: every lane's successor, the
    validity, the per-state flag and the condition, on fuzzed rows and on
    the rows of the port's CPU run."""
    dev = _card()
    rows = [_t(lww_fuzz_rows(np.random.default_rng(80 + n), n, 20_000), dev)]
    run = lww_model(n).checker().target_max_depth(4 if n < 3 else 3).spawn_gpu(
        device="cpu", capacity=1 << 16, max_frontier=1 << 10).join()
    w = n + lc.NET_SLOTS
    rows.append(run._carry.rows[: run._carry.tail * w].view(-1, w).to(dev))
    for r in rows:
        got, want = lc.lww_step(r, n), lc.lww_step_plain(r, n)
        for g, p in zip(got, want):
            assert torch.equal(g, p)


@pytest.mark.cuda
def test_cuda_trap_step_matches_twin():
    dev = _card()
    rng = np.random.default_rng(90)
    rows = _t(np.concatenate([np.arange(64), rng.integers(0, 1 << 32, 50_000),
                              [0xFFFFFFFF]]).astype(np.uint32).reshape(-1, 1), dev)
    for limit, trap_at in ((5, 2), (5, 10**6), (0xFFFFFFFE, 7)):
        args = (limit, trap_at, limit + 1)
        for g, p in zip(fx.trap_step(rows, *args), fx.trap_step_plain(rows, *args)):
            assert torch.equal(g, p)


@pytest.mark.cuda
def test_cuda_sym_engine_matches_cpu_run(tmp_path):
    """2pc rm=5 under symmetry on the card: 314 orbits at two chunk
    widths, the log bit-equal to the CPU run's."""
    _card()
    model = TwoPhaseSys(rm_count=5)
    gpu = model.checker().symmetry().spawn_gpu(**SYM_GEOMETRY).join()
    cpu = model.checker().symmetry().spawn_gpu(device="cpu", **SYM_GEOMETRY).join()
    assert (gpu.unique_state_count(), gpu.state_count(), gpu.max_depth()) == SYM_GOLDENS[5]
    for a, b in zip(_logs(gpu, tmp_path / "g.npz"), _logs(cpu, tmp_path / "c.npz")):
        assert np.array_equal(a, b)
    assert np.array_equal(gpu.discovered_fingerprints(), cpu.discovered_fingerprints())
    narrow = model.checker().symmetry().spawn_gpu(
        capacity=1 << 20, max_frontier=1 << 6).join()
    assert narrow.unique_state_count() == SYM_GOLDENS[5][0]


@pytest.mark.cuda
@pytest.mark.parametrize("rm", [10, 12])
def test_cuda_sym_goldens(rm):
    """``2pc check-sym`` at rm=10 and 12 (the codec's widest): the JAX
    engine's orbit counts and both agreement discoveries."""
    _card()
    checker = TwoPhaseSys(rm_count=rm).checker().symmetry().spawn_gpu(
        **SYM_GEOMETRY).join()
    assert (checker.unique_state_count(), checker.state_count(),
            checker.max_depth()) == SYM_GOLDENS[rm]
    assert sorted(checker.discoveries()) == ["abort agreement", "commit agreement"]


LWW_GEOMETRY = dict(capacity=1 << 22, max_frontier=1 << 14)


@pytest.mark.cuda
@pytest.mark.parametrize("n,depth,golden", [
    (2, 7, (189_031, 468_398, 7)), (3, 5, (17_364, 37_504, 5)),
])
def test_cuda_lww_goldens(n, depth, golden):
    """The deepest LWW runs the codec packs, at the JAX engine's counts,
    with no discovery."""
    _card()
    checker = lww_model(n).checker().target_max_depth(depth).spawn_gpu(
        **LWW_GEOMETRY).join()
    assert (checker.unique_state_count(), checker.state_count(),
            checker.max_depth()) == golden
    assert checker.discoveries() == {}


@pytest.mark.cuda
def test_cuda_lww_engine_matches_cpu_run_and_overflows_at_depth_8(tmp_path):
    """2 nodes to depth 6 on the card bit-equal to the CPU run (30,991 /
    68,295); to the reference's depth 8 the codec's flag stops the run
    with the JAX engine's error."""
    _card()
    w = 2 + lc.NET_SLOTS
    gpu = lww_model(2).checker().target_max_depth(6).spawn_gpu(**LWW_GEOMETRY).join()
    cpu = lww_model(2).checker().target_max_depth(6).spawn_gpu(
        device="cpu", **LWW_GEOMETRY).join()
    assert (gpu.unique_state_count(), gpu.state_count(), gpu.max_depth()) == (
        30_991, 68_295, 6)
    for a, b in zip(_logs(gpu, tmp_path / "g.npz", w), _logs(cpu, tmp_path / "c.npz", w)):
        assert np.array_equal(a, b)
    with pytest.raises(RuntimeError, match="encoding-capacity overflow"):
        lww_model(2).checker().target_max_depth(8).spawn_gpu(**LWW_GEOMETRY).join()


@pytest.mark.cuda
def test_cuda_trap_counter_on_the_card():
    """The eventually pipeline through K17: "reaches limit" fails in the
    trap, "trapped" is found; without the trap nothing is; under the
    identity canonicalization the run is the plain one."""
    _card()
    geo = dict(capacity=1 << 10, max_frontier=1 << 4)
    model = fx.TrapCounter()
    plain = model.checker().spawn_gpu(**geo).join()
    assert sorted(plain.discoveries()) == ["reaches limit", "trapped"]
    assert plain.discoveries()["reaches limit"].last_state() == model.trap_state
    sym = model.checker().symmetry_fn(lambda s: s).spawn_gpu(**geo).join()
    assert (sym.unique_state_count(), sym.state_count()) == (
        plain.unique_state_count(), plain.state_count())
    assert sorted(sym.discoveries()) == sorted(plain.discoveries())
    free = fx.TrapCounter(trap_at=10**6).checker().spawn_gpu(**geo).join()
    assert free.discoveries() == {}


@pytest.mark.cuda
def test_cuda_tiered_matches_cpu_run(tmp_path):
    """2pc rm=5 through the tiered checker at 512 slots (spills and cold
    probes through K20) on the card, bit-equal to its CPU run: logs, the
    journal's spill and cold-probe events and the snapshot's cold arrays."""
    from stateright_tpu_torch.runtime.journal import read_journal

    _card()
    geometry = dict(capacity=512, max_frontier=1 << 6)
    runs = []
    for dev in ("cuda", "cpu"):
        journal = tmp_path / f"{dev}.jsonl"
        c = TwoPhaseSys(rm_count=5).checker().spawn_gpu_tiered(
            device=dev, journal=str(journal), **geometry).join()
        events = [{k: v for k, v in e.items() if k not in ("t", "spill_sec")}
                  for e in read_journal(str(journal))
                  if e["event"] in ("spill", "cold_probe")]
        path = tmp_path / f"{dev}.npz"
        logs = _logs(c, path)
        with np.load(path) as snap:
            cold = [snap[k].copy() for k in sorted(snap.files)
                    if k.startswith("tiered_")]
        runs.append((c, events, logs, cold))
    (gpu, g_ev, g_logs, g_cold), (cpu, c_ev, c_logs, c_cold) = runs
    assert (gpu.unique_state_count(), gpu.state_count(), gpu.max_depth()) == (
        8832, 58146, 17
    )
    assert g_ev == c_ev and any(e["event"] == "cold_probe" for e in g_ev)
    for a, b in zip(g_logs + g_cold, c_logs + c_cold):
        assert np.array_equal(a, b)
    assert np.array_equal(gpu.discovered_fingerprints(), cpu.discovered_fingerprints())


@pytest.mark.cuda
def test_cuda_grid_walk_matches_twin():
    """K21 on packed words with x or y at 0xFFFF (the u32 wrap) and seeded
    ones, at bounds 0, 4 and 32,767."""
    dev = _card()
    rng = np.random.default_rng(21)
    words = np.concatenate([
        [0, 0xFFFF, 0xFFFF << 16, 0xFFFFFFFF, 4 | (4 << 16), 5, 5 << 16],
        rng.integers(0, 1 << 32, 100_000),
    ]).astype(np.uint32).reshape(-1, 1)
    rows = _t(words, dev)
    for bound in (0, 4, 32_767):
        for g, p in zip(fx.grid_walk(rows, bound), fx.grid_walk_plain(rows, bound)):
            assert torch.equal(g, p)


@pytest.mark.cuda
def test_cuda_twophase_conds_matches_twin():
    """K2c, with and without the edited model's column, at rm = 1..12."""
    from stateright_tpu_torch.models.twophase_compiled import (
        twophase_conds, twophase_conds_plain,
    )

    dev = _card()
    rng = np.random.default_rng(22)
    for n in range(1, 13):
        rows = _t(_random_rows(rng, n, 20_000), dev)
        for extra in (False, True):
            assert torch.equal(twophase_conds(rows, n, extra),
                               twophase_conds_plain(rows, n, extra))
        nexts, valid, conds = twophase_step(rows, n)
        assert torch.equal(conds, twophase_conds(rows, n))


@pytest.mark.cuda
def test_cuda_first_hits_matches_twin():
    """K22 on seeded conds: sparse and dense hits, no hit, a hit at row 0,
    hits only past ``n``, and a ragged last block."""
    from stateright_tpu_torch.incr.recheck import NO_SLOT, first_hits, first_hits_plain

    dev = _card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    for r, p, rate in ((1 << 20, 4, 1e-6), (1 << 20, 4, 0.5), (1000, 7, 0.01),
                       (257, 32, 0.0)):
        conds = torch.rand((r, p), generator=gen, device=dev) < rate
        always = sum(1 << q for q in range(0, p, 3))
        sometimes = sum(1 << q for q in range(1, p, 3))
        conds[:, 0] = True  # an always cond that holds
        for n, start in ((r, 0), (r // 2, 12_345), (r, (1 << 32) - 1 - r)):
            got = first_hits(conds, n, always, sometimes, start)
            assert torch.equal(got, first_hits_plain(conds, n, always, sometimes, start))
        conds[0, 1] = True
        assert int(first_hits(conds, r, always, sometimes, 7)[1]) == 7
        assert int(first_hits(conds, 0, always, sometimes, 0)[1]) == NO_SLOT


@pytest.mark.cuda
def test_cuda_first_hits_unaligned_conds():
    """K22 reads its rows 16 bytes a load after a byte-wise head: conds
    whose first byte lies 1 to 15 bytes past a 16-byte boundary, at
    chunk lengths shorter and longer than a load, equal to the twin."""
    from stateright_tpu_torch.incr.recheck import first_hits, first_hits_plain

    dev = _card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(29)
    r, p = 4099, 5
    for off in (1, 3, 8, 15):
        raw = torch.zeros((r * p + off,), dtype=torch.bool, device=dev)
        raw[off:] = torch.rand((r * p,), generator=gen, device=dev) < 0.01
        conds = raw[off:].view(r, p)
        assert conds.data_ptr() % 16 == off
        for n in (1, 3, 17, r):
            for always, sometimes in ((0b00101, 0b11010), (0, 0b11111)):
                got = first_hits(conds, n, always, sometimes, 11)
                assert torch.equal(got, first_hits_plain(conds, n, always,
                                                         sometimes, 11))


@pytest.mark.cuda
def test_cuda_property_only_recheck_rm5(tmp_path):
    """2pc rm=5 stored on the card, the edited model re-evaluated over its
    row log (K2c and K22, no wave), equal to a cold card run of the edited
    model in counts, discoveries and paths."""
    from stateright_tpu_torch.incr import incremental_check
    from stateright_tpu_torch.incr.recheck import first_hits
    from stateright_tpu_torch.models.twophase_compiled import twophase_conds
    from stateright_tpu_torch.runtime.journal import read_journal

    _card()
    store, journal = str(tmp_path / "store"), str(tmp_path / "j.jsonl")
    _, info = incremental_check(TwoPhaseSys(rm_count=5).checker(), store,
                                engine_kwargs=GEOMETRY, journal=journal)
    assert info["mode"] == "cold"
    waves = sum(e["event"] == "wave" for e in read_journal(journal))
    k2c, k22, k2 = twophase_conds.launches, first_hits.launches, twophase_step.launches
    edited = fx.TwoPhaseEdited.build(5)
    ck, info = incremental_check(edited.checker(), store, engine_kwargs=GEOMETRY,
                                 journal=journal)
    assert info["mode"] == "property_only"
    assert sum(e["event"] == "wave" for e in read_journal(journal)) == waves
    assert twophase_conds.launches > k2c and first_hits.launches > k22
    assert twophase_step.launches == k2
    ref = edited.checker().spawn_gpu(**GEOMETRY).join()
    assert (ck.unique_state_count(), ck.state_count(), ck.max_depth()) == (
        ref.unique_state_count(), ref.state_count(), ref.max_depth())
    assert sorted(ck.discoveries()) == sorted(ref.discoveries())
    for name, path in ref.discoveries().items():
        assert ck.discoveries()[name].into_states() == path.into_states(), name


@pytest.mark.cuda
def test_cuda_plain_walk_of_an_override_launches_nothing():
    """The plain walk of a model that overrides ``property_conds`` (the
    edited 2pc, a sliced trap counter) takes its conds from the override's
    twins: it launches no kernel, and it equals the card's walk."""
    from stateright_tpu_torch.models.twophase_compiled import twophase_conds

    dev = _card()
    rows = _t(_random_rows(np.random.default_rng(3), 5, 4096), dev)
    cm = fx.TwoPhaseEdited.build(5).compiled()
    before = (twophase_conds.launches, twophase_step.launches)
    plain = cm.walk_step(rows, plain=True)
    assert (twophase_conds.launches, twophase_step.launches) == before
    for k, p in zip(cm.walk_step(rows)[:3], plain[:3]):
        assert torch.equal(k, p)


@pytest.mark.cuda
def test_cuda_gang_kernels_match_twins():
    """K21g, K24 (solo and gang) and K23 against their twins on the card,
    on fuzzed rows, bounds and constants past 2**31, a padded batch."""
    from stateright_tpu_torch.fleet.gang import gang_eval, gang_eval_plain

    dev = _card()
    rng = np.random.default_rng(11)
    k, f = 8, 1000
    rows = rng.integers(0, 2**32, size=(k, f, 1), dtype=np.uint64).astype(np.uint32)
    rows[:, : f // 2, 0] &= 0x00FF_00FF
    bounds = np.array([[0], [4], [255], [32767], [100], [7], [0], [0]], np.uint32)
    caps = rng.integers(0, 2**32, size=(k, 2), dtype=np.uint64).astype(np.uint32)
    caps[:, 0] = rows[:, 3, 0]  # some state at its job's limit
    for kernel, plain, consts in (
        (fx.grid_walk_gang, fx.grid_walk_gang_plain, bounds),
        (fx.cap_counter_gang, fx.cap_counter_gang_plain, caps),
    ):
        s, c = _t(rows, dev), _t(consts, dev)
        for a, b in zip(kernel(s, c), plain(s.cpu(), c.cpu())):
            assert torch.equal(a.cpu(), b)
    flat = _t(rows.reshape(-1, 1), dev)
    for limit, cap in ((0, 0), (2**31, 2**31 + 1), (2**32 - 1, 5)):
        for a, b in zip(fx.cap_counter(flat, limit, cap),
                        fx.cap_counter_plain(flat.cpu(), limit, cap)):
            assert torch.equal(a.cpu(), b)
    _n, valid, conds = fx.grid_walk_gang_plain(_t(rows, "cpu"), _t(bounds, "cpu"))
    active = torch.from_numpy(
        np.arange(f)[None, :] < np.array([f, 999, 3, 500, 0, 0, 1, 0])[:, None])
    undisc = torch.from_numpy(rng.integers(0, 2, size=(k, 2)).astype(bool))
    want = gang_eval_plain(conds, valid.clone(), active, undisc, 0b01)
    got = gang_eval(conds.to(dev), valid.to(dev), active.to(dev),
                    undisc.to(dev), 0b01)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_cuda_gang_hooks_launch_their_kernels():
    """GridWalk's and CapCounter's gang hooks on the card: each one launch
    of K21g or K24 (no twin), equal to the twins on the CPU copy."""
    dev = _card()
    rng = np.random.default_rng(12)
    rows = rng.integers(0, 2**32, size=(4, 300, 1), dtype=np.uint64).astype(np.uint32)
    rows[:, :150, 0] &= 0x00FF_00FF
    for cm, kernel, plain, consts in (
        (fx.GridWalk(bound=0).compiled(), fx.grid_walk_gang,
         fx.grid_walk_gang_plain, np.array([[0], [4], [200], [65535]], np.uint32)),
        (fx.CapCounter().compiled(), fx.cap_counter_gang,
         fx.cap_counter_gang_plain,
         np.array([[3, 2], [2**31, 2**31 + 1], [7, 7], [0, 0]], np.uint32)),
    ):
        s, c = _t(rows, dev), _t(consts, dev)
        nexts, valid, conds = plain(s.cpu(), c.cpu())
        before = kernel.launches
        step = cm.gang_step(s, c)
        got_conds = cm.gang_property_conds(s, c)
        inside = cm.gang_boundary(s, c)
        expand = cm.gang_expand(s, c)
        assert kernel.launches - before == (4 if inside is not None else 3)
        assert torch.equal(step[0].cpu(), nexts)
        assert torch.equal(got_conds.cpu(), conds)
        for a, b in zip(expand, (nexts, valid, conds)):
            assert torch.equal(a.cpu(), b)
        if inside is None:
            assert torch.equal(step[1].cpu(), valid)
        else:
            assert bool(step[1].all())
            assert torch.equal(inside.cpu(), conds[..., 0])


@pytest.mark.cuda
def test_cuda_gang_matches_cpu_gang_in_fixed_launches():
    """A gang of 5 GridWalks on the card: each member bit-equal to the CPU
    gang's, and every wave one launch each of K21g, K23 and K1."""
    from stateright_tpu_torch.fleet import run_gang
    from stateright_tpu_torch.fleet.gang import gang_eval

    _card()
    models = [fx.GridWalk(bound=b) for b in (2, 3, 5, 6, 8)]
    members = [{"tag": i, "model": m, "cm": m.compiled(),
                "consts": m.compiled().gang_constants()}
               for i, m in enumerate(models)]
    counters = (fx.grid_walk_gang, gang_eval, device_fp64)
    before = [fn.launches for fn in counters]
    card, waves = run_gang(members)
    launched = [fn.launches - b for fn, b in zip(counters, before)]
    assert launched == [waves, waves, waves + 1]
    cpu, cpu_waves = run_gang(members, device="cpu")
    assert waves == cpu_waves
    for (_t1, a, _r1), (_t2, b, _r2) in zip(card, cpu):
        assert (a.unique_state_count(), a.state_count(), a.max_depth()) == (
            b.unique_state_count(), b.state_count(), b.max_depth())
        assert np.array_equal(a.discovered_fingerprints(),
                              b.discovered_fingerprints())
        assert sorted(a.discoveries()) == sorted(b.discoveries())


@pytest.mark.cuda
@pytest.mark.parametrize("two_phase,sorted_path", [
    (False, False), (True, False), (False, True),
])
def test_cuda_append_block_matches_twin(two_phase, sorted_path):
    """K25 against its twin on seeded commits: every row word, parent and
    ebits word bit-equal, nothing written past the new states."""
    from stateright_tpu_torch.parallel.append import append_block, append_block_plain

    dev = _card()
    rng = np.random.default_rng(31)
    for a, w, f, u in ((52, 2, 4096, 200_000), (64, 77, 512, 40_000)):
        n_rows = u if two_phase else f * a
        cand = _t(rng.integers(0, 2**32, size=(n_rows, w), dtype=np.uint32), dev)
        n_valid = u // 2
        v_orig = np.zeros(u, np.uint32)
        v_orig[:n_valid] = np.sort(rng.choice(f * a, n_valid, replace=False))
        new = torch.from_numpy(np.r_[rng.random(n_valid) < 0.5,
                                     np.zeros(u - n_valid, bool)]).to(dev)
        sel, count = compact(new, u)
        origin = (_t(rng.permutation(u).astype(np.uint32), dev)
                  if sorted_path else None)
        eb = _t(rng.integers(0, 2**32, size=f, dtype=np.uint32), dev)
        n, tail, cap = int(count), 1234, 1234 + u + 10
        outs = []
        for fn in (append_block, append_block_plain):
            logs = (torch.full((cap * w,), 7, dtype=torch.int32, device=dev),
                    torch.full((cap,), 7, dtype=torch.int32, device=dev),
                    torch.full((cap,), 7, dtype=torch.int32, device=dev))
            fn(*logs, sel, origin, _t(v_orig, dev), cand, eb, 99, tail, n, a,
               two_phase)
            outs.append(logs)
        torch.cuda.synchronize()
        for k, p in zip(*outs):
            assert torch.equal(k, p)
        assert bool((outs[0][0][(tail + n) * w:] == 7).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [20_000, 4097, 4096, 1])
def test_cuda_insert_reports_its_probe_figures(n):
    """K4's ``with_rounds`` figures: its longest chain and the slots its
    lanes read, counted again from where each lane's key landed -- on the
    grid path and on the one-block path."""
    from stateright_tpu_torch.parallel.hashset import home_slot

    dev = _card()
    rng = np.random.default_rng(32)
    cap = 1 << 16
    table = HashSet.empty(cap, dev)
    keys = rng.integers(1, 2**40, size=n, dtype=np.uint64)
    hi = _t((keys >> np.uint64(32)).astype(np.uint32), dev)
    lo = _t((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32), dev)
    active = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    active[0] = True
    new, ok, probe = insert_batch_claim(table, hi, lo, active, with_rounds=True)
    assert bool(ok)
    key = (hi.long() << 32) | (lo.long() & 0xFFFFFFFF)
    slot = home_slot(hi, lo, cap)
    landed = torch.zeros_like(slot)
    for _ in range(cap):  # each lane's distance to its key's slot
        here = table.keys[slot] == key
        if bool(here[active].all()):
            break
        landed = torch.where(here, landed, landed + 1)
        slot = torch.where(here, slot, (slot + 1) & (cap - 1))
    reads = landed[active] + 1
    assert probe.tolist() == [int(reads.max()), int(reads.sum())]


@pytest.mark.cuda
def test_cuda_traced_run_matches_untraced(tmp_path):
    """A traced card run writes the untraced run's logs; its journal's
    waves carry a breakdown against the card's (not estimated) peak, no
    phase above 1.05 of it, and the visitor sees each state once."""
    from stateright_tpu_torch.core.visitor import StateRecorder
    from stateright_tpu_torch.runtime.journal import read_journal

    _card()
    rec, states = StateRecorder.new_with_accessor()
    journal = str(tmp_path / "t.jsonl")
    model = TwoPhaseSys(rm_count=5)
    traced = model.checker().visitor(rec).spawn_gpu(
        device="cuda", journal=journal, **GEOMETRY).join()
    plain = model.checker().spawn_gpu(device="cuda", **GEOMETRY).join()
    for a, b in zip(_logs(traced, tmp_path / "t.npz"), _logs(plain, tmp_path / "p.npz")):
        assert np.array_equal(a, b)
    assert len({model.fingerprint(s) for s in states()}) == len(states()) == 8832
    summary = traced.trace_summary()
    assert not summary["hbm_peak_estimated"]
    # The 2**14-slot table grows once: that flagged wave is journaled
    # without a breakdown, and every committed wave with one.
    waves = [e for e in read_journal(journal)
             if e["event"] == "wave" and not e["flags"]]
    assert len(waves) == summary["traced_waves"]
    for w in waves:
        assert sum(w["wave_breakdown"].values()) >= 0.9 * w["call_sec"]
        assert w["hbm_util_frac"] <= 1.05


@pytest.mark.cuda
def test_cuda_owner_bucket_matches_twin():
    """K26 against its twin on seeded representatives: invalid lanes, row
    indices and parents through index maps, a strided row view, buckets
    under and over ``bkt`` at 2, 4 and 8 shards, and an empty shard; rows
    of 74 words and 1,024 owners."""
    from stateright_tpu_torch.parallel.exchange import (
        owner_bucket, owner_bucket_plain,
    )

    dev = _card()
    rng = np.random.default_rng(26)
    for n, u, bkt, w in ((2, 5_000, 2_432, 2), (4, 100_000, 13_312, 42),
                         (4, 100_000, 128, 5), (8, 3, 8, 3), (4, 0, 128, 2),
                         (4, 32_768, 4_096, 74), (1024, 50_000, 64, 74),
                         (1024, 300_000, 300, 7)):
        count = max(1, u // 3)
        rows = _t(rng.integers(0, 2**32, size=(u + 7, w + 3), dtype=np.uint32),
                  dev)[:, :w]
        args = (
            _t(rng.integers(0, 2**32, size=u, dtype=np.uint32), dev),
            _t(rng.integers(0, 2**32, size=u, dtype=np.uint32), dev),
            torch.from_numpy(rng.random(u) < 0.7).to(dev), rows,
            _t(rng.integers(0, u + 7, size=u, dtype=np.uint32), dev),
            _t(rng.integers(0, 3 * count, size=u, dtype=np.uint32), dev), 3,
            _t(rng.integers(0, 2**32, size=count, dtype=np.uint32), dev),
            _t(rng.integers(0, 2**32, size=count, dtype=np.uint32), dev), n, bkt,
        )
        for k, p in zip(owner_bucket(*args), owner_bucket_plain(*args)):
            assert torch.equal(k, p.to(k.dtype)), (n, u, bkt)


@pytest.mark.cuda
def test_cuda_cold_probe_matches_twin():
    """K20's probe against its twin: chunks of 1, 2, 8, 2**15 and 2**20
    keys, half of the real keys above 2**63, the rest the all-ones pad;
    queries from the chunk, at its first and last key, the pad key and
    fresh keys; with and without an origin map; an all-false, an all-true
    and a partial mask, one a view off a 16-byte boundary."""
    from stateright_tpu_torch.tiered.cold_join import cold_probe, cold_probe_plain

    dev = _card()
    rng = np.random.default_rng(20)
    ones = np.uint64(0xFFFFFFFFFFFFFFFF)
    for c, fill, n, p, use_origin, skew in (
        (1, 1, 100, 1.0, False, 0), (2, 1, 1_000, 0.5, True, 3),
        (8, 5, 7, 1.0, False, 1), (1 << 15, 20_000, 300_000, 0.2, False, 0),
        (1 << 15, 1 << 15, 50_000, 0.0, True, 0),
        (1 << 20, 700_000, 2_000_000, 0.2, True, 5),
    ):
        real = rng.integers(0, 1 << 63, size=fill, dtype=np.uint64)
        real[: fill // 2] |= np.uint64(1 << 63)
        real = np.sort(real)
        chunk = np.full(c, ones, np.uint64)
        chunk[:fill] = real
        m = n + 5
        q = np.concatenate([real, rng.integers(0, 2**64, size=m, dtype=np.uint64)])
        q = q[rng.integers(0, q.shape[0], size=m)]
        q[:3] = (real[0], real[-1], ones)
        hi = _t((q >> np.uint64(32)).astype(np.uint32), dev)
        lo = _t(q.astype(np.uint32), dev)
        origin = _t(rng.integers(0, m, size=n).astype(np.uint32), dev) if use_origin else None
        if not use_origin:
            hi, lo = hi[:n].contiguous(), lo[:n].contiguous()
        backing = torch.from_numpy(rng.random(n + skew) < p).to(dev)
        mask = backing[skew:]
        before = backing[:skew].clone()
        want = mask.clone()
        chunk_t = torch.from_numpy(chunk.view(np.int64)).to(dev)
        cold_probe_plain(hi, lo, origin, want, chunk_t)
        cold_probe(hi, lo, origin, mask, chunk_t)
        assert torch.equal(mask, want), (c, n, use_origin)
        assert torch.equal(backing[:skew], before)


@pytest.mark.cuda
def test_cuda_shard_log_append_matches_twin():
    """K28 against its twin: fresh lanes with and without an origin map,
    strided views of a packed receive buffer, rows of 2 and 42 words, a
    tail whose appends run past the log's end (dropped), no fresh lane."""
    from stateright_tpu_torch.parallel.exchange import (
        shard_log_append, shard_log_append_plain,
    )

    dev = _card()
    rng = np.random.default_rng(28)
    for r, w, lp, p_fresh, tail, origin in (
        (300_000, 2, 1 << 19, 0.3, 17, False), (50_000, 42, 1 << 16, 0.5, 0, True),
        (5_000, 3, 4_096, 0.9, 4_000, True), (10, 2, 64, 0.0, 3, False),
    ):
        recv = _t(rng.integers(0, 2**32, size=(r, w + 3), dtype=np.uint32), dev)
        fresh = torch.from_numpy(rng.random(r) < p_fresh).to(dev)
        org = _t(rng.permutation(r).astype(np.uint32), dev) if origin else None
        logs = [[_t(rng.integers(0, 2**32, size=shape, dtype=np.uint32), dev)
                 for shape in ((lp, w), (lp,), (lp,))]]
        logs.append([t.clone() for t in logs[0]])
        counts = [
            fn(fresh, org, recv[:, :w], recv[:, w], recv[:, w + 1], *log, tail)
            for fn, log in zip((shard_log_append, shard_log_append_plain), logs)
        ]
        assert int(counts[0]) == int(counts[1]) == int(fresh.sum())
        for k, p in zip(*logs):
            assert torch.equal(k, p), (r, w)


@pytest.mark.cuda
def test_cuda_shard_commit_matches_twin():
    """K27 against its twin: new lanes at distinct slots, with and without
    an origin map, strided views of a packed receive buffer, a queue that
    ends inside the batch, and no new lane at all."""
    from stateright_tpu_torch.parallel.exchange import (
        shard_commit, shard_commit_plain,
    )

    dev = _card()
    rng = np.random.default_rng(27)
    for r, w, cap, p_new, tail, origin in (
        (300_000, 2, 1 << 20, 0.3, 17, False), (50_000, 42, 1 << 17, 0.5, 0, True),
        (5_000, 3, 1 << 13, 0.9, (1 << 13) - 100, False), (10, 2, 64, 0.0, 3, False),
        # The 256-lane tile's edges: one lane, a tile, a tile and one.
        (1, 5, 64, 1.0, 0, True), (255, 1, 1 << 10, 0.5, 2, False),
        (256, 77, 1 << 10, 1.0, 0, True), (257, 2, 1 << 10, 1.0, 9, False),
        (513, 42, 1 << 11, 0.7, 1 << 11, True),
    ):
        recv = _t(rng.integers(0, 2**32, size=(r, w + 3), dtype=np.uint32), dev)
        is_new = torch.from_numpy(rng.random(r) < p_new).to(dev)
        slot = _t(rng.permutation(cap)[:r].astype(np.uint32), dev)
        org = _t(rng.permutation(r).astype(np.uint32), dev) if origin else None
        tables = [
            [_t(rng.integers(0, 2**32, size=shape, dtype=np.uint32), dev)
             for shape in ((cap, w), (cap,), (cap,), (cap + 64,))]
        ]
        tables.append([t.clone() for t in tables[0]])
        counts = [
            fn(is_new, slot, org, recv[:, :w], recv[:, w], recv[:, w + 1],
               *tabs, tail)
            for fn, tabs in zip((shard_commit, shard_commit_plain), tables)
        ]
        assert int(counts[0]) == int(counts[1]) == int(is_new.sum())
        for k, p in zip(*tables):
            assert torch.equal(k, p), (r, w)
