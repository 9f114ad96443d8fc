"""The port's tiered-sharded checker and resharding against the JAX package's.

``spawn_gpu_tiered_sharded(mesh=["cpu"] * n)`` (plain-torch twins, K20's
and K28's among them) and the JAX package's ``spawn_tpu_tiered_sharded`` on
conftest's 8-device virtual CPU mesh run 2pc rm=3 at equal per-shard
capacity: the port's 16-byte slot makes 0.004 MB the 256 slots JAX's
12-byte slot makes of 0.003 MB.  Counts, discoveries and their paths,
fingerprints, every shard's row log, parents and ebits up to its tail,
every ``ts_*`` array and the ``spill`` and ``cold_probe`` journal events
(less their times) must be equal: integers, tolerance zero.  K28's twin is
held against JAX's fresh-masked append, and the port's
``reshard_snapshot`` against JAX's on snapshots cut at the same wave.  The
remaining mesh widths and the resumes are held to the port's own
single-card engine, which the suite holds to JAX.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stateright_tpu.models.twophase import TwoPhaseSys as JaxTwoPhaseSys  # noqa: E402
from stateright_tpu.runtime.journal import read_journal as jax_read_journal  # noqa: E402
from stateright_tpu.tiered.reshard import reshard_snapshot as jax_reshard  # noqa: E402
from stateright_tpu_torch.models.twophase import TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32  # noqa: E402
from stateright_tpu_torch.parallel.exchange import (  # noqa: E402
    shard_log_append, shard_log_append_plain,
)
from stateright_tpu_torch.runtime.journal import read_journal  # noqa: E402
from stateright_tpu_torch.tiered import ColdStore  # noqa: E402
from stateright_tpu_torch.tiered.reshard import reshard_snapshot  # noqa: E402

JAX_MB = 0.003  # 256 slots a shard at the JAX package's 12 bytes a slot
PORT_MB = 0.004  # 256 slots a shard at the port's 16
TS = dict(chunk_size=1 << 5)
JAX_WIDTHS = (2, 4)
CUT = 150  # target_state_count of the resharded snapshots
TIMES = ("t", "spill_sec")


def _mesh(n):
    return jax.sharding.Mesh(np.array(jax.devices("cpu")[:n]), ("shards",))


def _port_ts(builder, n, **kw):
    kw.setdefault("memory_budget_mb", PORT_MB)
    for k, v in TS.items():
        kw.setdefault(k, v)
    return builder.spawn_gpu_tiered_sharded(mesh=["cpu"] * n, **kw).join()


def _jax_ts(builder, n, **kw):
    kw.setdefault("memory_budget_mb", JAX_MB)
    for k, v in TS.items():
        kw.setdefault(k, v)
    return builder.spawn_tpu_tiered_sharded(mesh=_mesh(n), **kw).join()


def _snapshot(checker, path):
    checker.save_snapshot(str(path))
    return _load(path)


def _load(path):
    with np.load(path) as snap:
        return {k: snap[k].copy() for k in snap.files}


def _events(events, kinds=("spill", "cold_probe")):
    return [{k: v for k, v in e.items() if k not in TIMES}
            for e in events if e["event"] in kinds]


def _path_fps(model, path):
    return [int(model.fingerprint(s)) for s in path.into_states()]


def _single_fps(model):
    return model.checker().spawn_gpu(
        device="cpu", capacity=1 << 13, max_frontier=1 << 6
    ).join()


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX engine's tiered-sharded 2pc rm=3 at 2 and 4 shards (checker,
    snapshot, journal), and its 4-shard tiered-sharded and sharded
    snapshots cut at ``CUT`` states with their JAX reshards onto 2."""
    d = tmp_path_factory.mktemp("jax_ts")
    runs = {}
    for n in JAX_WIDTHS:
        journal = str(d / f"j{n}.jsonl")
        ck = _jax_ts(JaxTwoPhaseSys(rm_count=3).checker(), n, journal=journal)
        runs[n] = (ck, _snapshot(ck, d / f"j{n}.npz"), jax_read_journal(journal))
    cuts = {}
    model = JaxTwoPhaseSys(rm_count=3)
    cut = _jax_ts(model.checker().target_state_count(CUT), 4)
    cut.save_snapshot(str(d / "cut_ts.npz"))
    cut = model.checker().target_state_count(CUT).spawn_tpu_sharded(
        mesh=_mesh(4), capacity=1 << 13, chunk_size=1 << 6).join()
    cut.save_snapshot(str(d / "cut_plain.npz"))
    for kind in ("ts", "plain"):
        jax_reshard(model, str(d / f"cut_{kind}.npz"), str(d / f"rs_{kind}.npz"), 2)
        cuts[kind] = (_load(d / f"cut_{kind}.npz"), _load(d / f"rs_{kind}.npz"))
    return runs, cuts


def _jax_append_shard():
    """``stateright_tpu/tiered/sharded_engine.py:289-302`` (one shard's
    block), lifted as it stands into a jitted function."""
    u = jnp.uint32

    @jax.jit
    def append(rows2d, parent1d, ebits1d, rw, rg, reb, r_origin, fr, tail):
        pos = tail + jnp.cumsum(fr) - u(1)
        idx = jnp.where(fr != u(0), pos, u(0xFFFFFFFF))
        rows2d = rows2d.at[idx].set(rw[r_origin], mode="drop")
        parent1d = parent1d.at[idx].set(rg[r_origin], mode="drop")
        ebits1d = ebits1d.at[idx].set(reb[r_origin], mode="drop")
        return rows2d, parent1d, ebits1d

    return append


def test_shard_log_append_twin_matches_jax():
    """K28's twin against JAX's fresh-masked append: seeded receive
    batches with holes in the fresh mask, a permuted origin, words past
    2**31, a tail near the log's end (lanes past it dropped), none fresh;
    and the wrapper runs the twin on CPU tensors."""
    rng = np.random.default_rng(28)
    append = _jax_append_shard()
    u = jnp.uint32
    for r, w, lp, p_fresh, tail in ((700, 4, 1 << 10, 0.4, 33),
                                    (300, 42, 512, 0.7, 400),
                                    (64, 2, 128, 0.0, 5)):
        fresh = rng.random(r) < p_fresh
        origin = rng.permutation(r).astype(np.uint32)
        rw = rng.integers(0, 2**32, size=(r, w), dtype=np.uint32)
        rg = rng.integers(0, 2**32, size=r, dtype=np.uint32)
        reb = rng.integers(0, 2**32, size=r, dtype=np.uint32)
        logs = (rng.integers(0, 2**32, size=(lp, w), dtype=np.uint32),
                rng.integers(0, 2**32, size=lp, dtype=np.uint32),
                rng.integers(0, 2**32, size=lp, dtype=np.uint32))
        want = append(*map(jnp.asarray, logs), jnp.asarray(rw), jnp.asarray(rg),
                      jnp.asarray(reb), jnp.asarray(origin),
                      jnp.asarray(fresh.astype(np.uint32)), u(tail))
        for fn in (shard_log_append_plain, shard_log_append):
            got = [from_numpy_u32(a, "cpu") for a in logs]
            n = fn(torch.from_numpy(fresh), from_numpy_u32(origin, "cpu"),
                   from_numpy_u32(rw, "cpu"), from_numpy_u32(rg, "cpu"),
                   from_numpy_u32(reb, "cpu"), *got, tail)
            assert int(n) == int(fresh.sum())
            for g, wnt in zip(got, want):
                assert np.array_equal(to_numpy_u32(g), np.asarray(wnt))


@pytest.mark.parametrize("n", JAX_WIDTHS)
def test_tiered_sharded_matches_jax(n, jax_runs, tmp_path):
    """2pc rm=3 at 256 slots a shard: the JAX engine's counts, depth,
    discoveries and paths, fingerprints, per-shard logs to their tails,
    ``ts_*`` arrays and ``spill``/``cold_probe`` events."""
    jck, jsnap, jevents = jax_runs[0][n]
    model = TwoPhaseSys(rm_count=3)
    journal = str(tmp_path / "p.jsonl")
    ck = _port_ts(model.checker(), n, journal=journal)
    assert ck._cap_s == jck._cap_s == 256
    assert (ck.unique_state_count(), ck.state_count(), ck.max_depth()) == (
        jck.unique_state_count(), jck.state_count(), jck.max_depth())
    assert ck.unique_state_count() == 288
    assert sorted(ck.discoveries()) == sorted(jck.discoveries())
    for name, path in jck.discoveries().items():
        assert _path_fps(model, ck.discoveries()[name]) == _path_fps(model, path)
    assert np.array_equal(ck.discovered_fingerprints(), jck.discovered_fingerprints())
    snap = _snapshot(ck, tmp_path / "p.npz")
    assert sorted(snap) == sorted(jsnap)
    for k in jsnap:
        if k.startswith("ts_") or k in ("disc", "cap_s", "chunk", "n_shards",
                                        "engine_key", "sort_lanes", "sortless",
                                        "step_lanes", "bucket_slack"):
            assert snap[k].dtype == jsnap[k].dtype and (snap[k] == jsnap[k]).all(), k
    w = model.compiled().state_width
    tails = jsnap["ts_tails"]
    for k, width in (("rows", w), ("parent", None), ("ebits", None)):
        got = snap[k].reshape(n, -1, *(() if width is None else (width,)))
        want = jsnap[k].reshape(n, -1, *(() if width is None else (width,)))
        for d in range(n):
            assert np.array_equal(got[d, : tails[d]], want[d, : tails[d]]), (k, d)
    events = read_journal(journal)
    assert _events(events) == _events(jevents)
    if n == 2:
        assert any(e["event"] == "spill" for e in events)
        assert any(e["event"] == "cold_probe" and e["hits"] for e in events)


@pytest.mark.parametrize("n", (1, 2, 4, 8))
def test_tiered_sharded_matches_single_card(n, tmp_path):
    """``test_tiered_sharded.py:129``'s gate: at 1/2/4/8 shards under the
    spill-forcing budget the counts, depth, discoveries and fingerprints
    are the single card's; spills carry their owner shard and the
    metrics count them."""
    model = TwoPhaseSys(rm_count=3)
    ref = _single_fps(model)
    journal = str(tmp_path / "ts.jsonl")
    ck = _port_ts(model.checker(), n, journal=journal)
    assert (ck.unique_state_count(), ck.state_count(), ck.max_depth()) == (
        ref.unique_state_count(), ref.state_count(), ref.max_depth())
    assert sorted(ck.discoveries()) == sorted(ref.discoveries())
    assert np.array_equal(ck.discovered_fingerprints(), ref.discovered_fingerprints())
    spills = [e for e in read_journal(journal) if e["event"] == "spill"]
    m = ck.metrics()
    assert all(0 <= e["shard"] < n for e in spills)
    assert len(spills) == m.get("spills", 0)
    if n <= 2:
        assert spills and m["cold_entries"] > 0
    assert m["engine"] == "gpu-tiered-sharded"
    assert set(m["shard_hot_entries"]) == {str(d) for d in range(n)}


def test_tiered_sharded_spawn_validation():
    """``test_tiered_sharded.py:99``: ``trace=True`` and a spill threshold
    past 0.5 are refused."""
    m = TwoPhaseSys(rm_count=3)
    with pytest.raises(ValueError, match="trace"):
        m.checker().spawn_gpu_tiered_sharded(mesh=["cpu"], trace=True)
    with pytest.raises(ValueError, match="spill_threshold"):
        m.checker().spawn_gpu_tiered_sharded(mesh=["cpu"], spill_threshold=0.9)


def test_sibling_spill_dirs_never_clobber_or_cross_adopt(tmp_path):
    """``test_tiered_sharded.py:70`` on the port's ``ColdStore``: sibling
    ``shard_<d>/`` stores merge and reopen only their own runs; and a
    disk-backed two-shard run spills into both siblings."""
    base = str(tmp_path / "cold")
    d0, d1 = os.path.join(base, "shard_0"), os.path.join(base, "shard_1")
    s0 = ColdStore(spill_dir=d0, max_runs=2)
    s1 = ColdStore(spill_dir=d1, max_runs=2)
    s0.add_run(np.asarray([2, 4], np.uint64))
    s1.add_run(np.asarray([3, 5], np.uint64))
    s0.add_run(np.asarray([6], np.uint64))
    s0.add_run(np.asarray([8], np.uint64))  # past max_runs: s0 merges
    assert s0.run_count == 1 and s0.entries == 4
    assert s1.run_count == 1 and s1.entries == 2
    assert s1.contains([3, 5, 2]).tolist() == [True, True, False]
    files0 = {os.path.join(d0, f) for f in os.listdir(d0)}
    files1 = {os.path.join(d1, f) for f in os.listdir(d1)}
    assert files0 and files1 and not files0 & files1
    r0 = ColdStore.open(d0, max_runs=2)
    r1 = ColdStore.open(d1, max_runs=2)
    assert r0.entries == 4 and r0.contains([2, 4, 6, 8]).all()
    assert not r0.contains([3, 5]).any()
    assert r1.entries == 2 and r1.contains([3, 5]).all()
    run_dir = str(tmp_path / "run")
    ck = _port_ts(TwoPhaseSys(rm_count=3).checker(), 2, cold_dir=run_dir)
    assert ck.unique_state_count() == 288
    assert sorted(os.listdir(run_dir)) == ["shard_0", "shard_1"]
    assert all(os.listdir(os.path.join(run_dir, s)) for s in ("shard_0", "shard_1"))


@pytest.mark.parametrize("kind", ("ts", "plain"))
def test_reshard_matches_jax(kind, jax_runs, tmp_path):
    """The port's snapshot cut at ``CUT`` states (4 shards; tiered-sharded
    or plain sharded) equals JAX's cut at the same wave, and the port's
    ``reshard_snapshot`` onto 2 shards equals JAX's, array for array."""
    jcut, jrs = jax_runs[1][kind]
    model = TwoPhaseSys(rm_count=3)
    builder = model.checker().target_state_count(CUT)
    if kind == "ts":
        cut = _port_ts(builder, 4)
    else:
        cut = builder.spawn_gpu_sharded(mesh=["cpu"] * 4, capacity=1 << 13,
                                        chunk_size=1 << 6).join()
    src = str(tmp_path / "cut.npz")
    cut.save_snapshot(src)
    got_cut = _load(src)
    for k in ("stats", "ts_tails", "ts_level_start", "ts_level_end",
              "ts_unique", "ts_states", "disc"):
        if k in jcut:
            assert np.array_equal(got_cut[k], jcut[k]), k
    out = str(tmp_path / "rs.npz")
    journal = str(tmp_path / "rs.jsonl")
    summary = reshard_snapshot(model, src, out, 2, journal=journal)
    assert (summary["old_shards"], summary["new_shards"]) == (4, 2)
    assert any(e["event"] == "reshard" for e in read_journal(journal))
    got = _load(out)
    assert sorted(got) == sorted(jrs)
    for k in jrs:
        assert got[k].dtype == jrs[k].dtype, k
        assert got[k].shape == jrs[k].shape and (got[k] == jrs[k]).all(), k


@pytest.mark.parametrize("n_from,n_to", ((4, 2), (2, 4)))
def test_reshard_resume_both_directions(n_from, n_to, tmp_path):
    """``test_tiered_sharded.py:216``: a mid-run checkpoint (depth 5)
    resharded n_from -> n_to resumes to the unconstrained counts,
    discoveries and fingerprints; resuming it on the old width fails with
    the message that names the reshard."""
    model = TwoPhaseSys(rm_count=3)
    ref = _single_fps(model)
    ck = str(tmp_path / "ck.npz")
    part = _port_ts(model.checker().target_max_depth(5), n_from,
                    checkpoint_path=ck, checkpoint_every_waves=1)
    assert part.max_depth() <= 5
    out = str(tmp_path / "rs.npz")
    summary = reshard_snapshot(model, ck, out, n_to)
    assert len(summary["tails"]) == n_to
    with pytest.raises(ValueError, match="reshard"):
        _port_ts(model.checker(), n_from, resume_from=out)
    res = _port_ts(model.checker(), n_to, resume_from=out)
    assert (res.unique_state_count(), res.state_count(), res.max_depth()) == (
        ref.unique_state_count(), ref.state_count(), ref.max_depth())
    assert sorted(res.discoveries()) == sorted(ref.discoveries())
    assert np.array_equal(res.discovered_fingerprints(), ref.discovered_fingerprints())


def test_plain_sharded_snapshot_resharded_into_tiered(tmp_path):
    """``test_tiered_sharded.py:274``: a plain sharded checkpoint (4
    shards, depth 6) resharded into a 2-shard tiered-sharded snapshot
    finishes with the unconstrained set."""
    model = TwoPhaseSys(rm_count=3)
    ref = _single_fps(model)
    ck = str(tmp_path / "plain.npz")
    model.checker().target_max_depth(6).spawn_gpu_sharded(
        mesh=["cpu"] * 4, capacity=1 << 14, chunk_size=1 << 6,
        checkpoint_path=ck, checkpoint_every_waves=1).join()
    out = str(tmp_path / "rs.npz")
    reshard_snapshot(model, ck, out, 2)
    res = model.checker().spawn_gpu_tiered_sharded(
        mesh=["cpu"] * 2, capacity=(1 << 12) * 2, chunk_size=1 << 6,
        resume_from=out).join()
    assert (res.unique_state_count(), res.state_count()) == (
        ref.unique_state_count(), ref.state_count())
    assert np.array_equal(res.discovered_fingerprints(), ref.discovered_fingerprints())
