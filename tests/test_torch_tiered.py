"""The port's tiered out-of-core checker against the JAX package's, on the
CPU.

``spawn_gpu_tiered(device="cpu")`` (plain-torch twins, K20's among them)
and the JAX package's ``spawn_tpu_tiered`` run the same model at the same
arguments: counts, discovered fingerprints, row log, parents, ebits, the
journal's ``spill`` and ``cold_probe`` events and the snapshots' cold
arrays must agree; the cold store, the budget mapping and K20's twins are
held against the JAX package's on seeded data.  The card's run against
its CPU run is in ``test_torch_device.py``, which imports no JAX.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stateright_tpu.models.twophase import TwoPhaseSys as JaxTwoPhaseSys  # noqa: E402
from stateright_tpu.runtime.journal import read_journal as jax_read_journal  # noqa: E402
from stateright_tpu.tiered import ColdStore as JaxColdStore  # noqa: E402
from stateright_tpu.tiered import capacity_for_budget as jax_capacity_for_budget  # noqa: E402
from stateright_tpu_torch.models.twophase import TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.parallel.hashset import insert_batch_claim  # noqa: E402
from stateright_tpu_torch.runtime.journal import read_journal  # noqa: E402
from stateright_tpu_torch.tiered import ColdStore, capacity_for_budget  # noqa: E402
from stateright_tpu_torch.tiered.cold_join import (  # noqa: E402
    cold_probe, cold_probe_plain, cold_query, cold_query_plain,
)

GEOMETRY = dict(capacity=512, max_frontier=1 << 6)
M64 = (1 << 64) - 1
# Journal fields that are times, not results.
TIMES = ("t", "spill_sec")
# metrics() keys whose values the two engines share on a tiered run (the
# JAX engine's others are its compile cache, vitals and timings).
SHARED_METRICS = (
    "done", "state_count", "unique_state_count", "max_depth",
    "table_load_factor", "capacity", "log_capacity", "max_frontier",
    "dedup_factor", "sortless", "sort_lanes", "sort_lanes_rung", "waves",
    "table_occupancy", "grows", "overflow_retries", "spills",
    "spill_bytes_total", "cold_runs", "cold_entries", "cold_bytes",
    "cold_probe_passes_total", "cold_probe_bytes_total", "cold_hits_total",
    "hot_load_factor", "spill_threshold", "cold_chunk", "hot_entries",
    "spill_tail",
)


def _events(path, read):
    return [
        {k: v for k, v in e.items() if k not in TIMES}
        for e in read(path) if e["event"] in ("spill", "cold_probe")
    ]


def _snapshot(checker, path):
    checker.save_snapshot(str(path))
    with np.load(path) as snap:
        tail = int(snap["tail"])
        return {
            "rows": snap["rows"][: 2 * tail].copy(),
            "parent": snap["parent"][:tail].copy(),
            "ebits": snap["ebits"][:tail].copy(),
            **{k: snap[k].copy() for k in snap.files if k.startswith("tiered_")},
        }


@pytest.fixture(scope="module")
def jax_rm4(tmp_path_factory):
    """One JAX tiered run of 2pc rm=4 at 512 slots: the checker, its
    journal events and its snapshot's logs and cold arrays."""
    d = tmp_path_factory.mktemp("jax_tiered")
    journal = str(d / "j.jsonl")
    t = JaxTwoPhaseSys(rm_count=4).checker().spawn_tpu_tiered(
        journal=journal, **GEOMETRY).join()
    return t, _events(journal, jax_read_journal), _snapshot(t, d / "t.npz")


@pytest.fixture(scope="module")
def port_rm4(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_tiered")
    journal = str(d / "j.jsonl")
    t = TwoPhaseSys(rm_count=4).checker().spawn_gpu_tiered(
        device="cpu", journal=journal, **GEOMETRY).join()
    return t, _events(journal, read_journal), _snapshot(t, d / "t.npz")


# --- the cold store ----------------------------------------------------------


def test_cold_store_runs_merge_and_membership_match_jax():
    rng = np.random.default_rng(9)
    port, ref = ColdStore(max_runs=3), JaxColdStore(max_runs=3)
    queries = rng.integers(0, 1 << 12, size=500, dtype=np.uint64)
    for size in (40, 0, 75, 12, 90, 33, 1):
        run = rng.integers(0, 1 << 12, size=size, dtype=np.uint64)
        run[: size // 4] |= np.uint64(1 << 63)  # keys past 2**63 sort last
        port.add_run(run)
        ref.add_run(run)
        assert port.run_count == ref.run_count
        assert (port.entries, port.nbytes) == (ref.entries, ref.nbytes)
        for a, b in zip(port.runs, ref.runs):
            assert np.array_equal(a, b)
        q = np.concatenate([queries, run])
        assert np.array_equal(port.contains(q), ref.contains(q))
    # A merge happened (7 spills, at most 3 runs), and the snapshot arrays
    # round-trip to the same run shape in both packages.
    fps, lens = port.to_arrays()
    jfps, jlens = ref.to_arrays()
    assert np.array_equal(fps, jfps) and np.array_equal(lens, jlens)
    back = ColdStore.from_arrays(jfps, jlens, max_runs=3)
    assert [len(r) for r in back.runs] == list(jlens)
    assert np.array_equal(back.contains(queries), ref.contains(queries))


def test_cold_store_disk_tier(tmp_path):
    d = str(tmp_path / "cold")
    s = ColdStore(spill_dir=d, max_runs=2)
    s.add_run(np.asarray([4, 2], np.uint64))
    s.add_run(np.asarray([8, 6], np.uint64))
    files = sorted(os.listdir(d))
    assert files == ["cold_run_1.npy", "cold_run_2.npy"]
    assert isinstance(s.runs[0], np.memmap)
    assert s.contains([2, 4, 6, 8, 10]).tolist() == [True, True, True, True, False]
    s.add_run(np.asarray([1], np.uint64))  # the merge rewrites the disk set
    assert s.run_count == 1 and os.listdir(d) == ["cold_run_4.npy"]
    assert s.contains([1, 2, 4, 6, 8]).all()
    # A restore into the same directory re-spills under fresh numbers and
    # drops the files it did not claim; the JAX store reads them back.
    fps, lens = s.to_arrays()
    back = ColdStore.from_arrays(fps, lens, spill_dir=d)
    assert os.listdir(d) == ["cold_run_5.npy"]
    ref = JaxColdStore.open(d)
    assert np.array_equal(ref.runs[0], back.runs[0])


def test_capacity_for_budget_counts_sixteen_bytes_a_slot():
    # Budgets where the packages agree (16 bytes a slot here, 12 there).
    for mb, slots in ((0.005, 256), (1.0, 1 << 16), (2, 1 << 17),
                      (16, 1 << 20), (64, 1 << 22)):
        assert capacity_for_budget(mb) == jax_capacity_for_budget(mb) == slots
    # Where they differ: 0.875 MB holds 65,536 12-byte slots but only
    # 57,344 16-byte ones, so the port's table is the next power down.
    assert jax_capacity_for_budget(0.875) == 1 << 16
    assert capacity_for_budget(0.875) == 1 << 15
    for bad in (0, -1, 1e-9, 0.0039, float("nan"), float("inf")):
        with pytest.raises(ValueError):
            capacity_for_budget(bad)


def test_budget_table_holds_sixteen_bytes_a_slot():
    """The hot table a budget derives is one 16-byte slot (key and K4's
    tag) a table entry: at 2 MB its slots tensor is the budget, 2**17
    slots, the slot count the JAX engine derives there."""
    t = TwoPhaseSys(rm_count=3).checker().spawn_gpu_tiered(
        device="cpu", memory_budget_mb=2, max_frontier=1 << 6).join()
    table = t._carry.table
    assert table.capacity == capacity_for_budget(2) == jax_capacity_for_budget(2) == 1 << 17
    assert table.slots.numel() * table.slots.element_size() == 2 << 20
    assert t.unique_state_count() == 288


# --- K20's twins against the JAX programs ------------------------------------


def _planes(keys):
    keys = np.asarray(keys, np.uint64)
    return (keys >> np.uint64(32)).astype(np.uint32), keys.astype(np.uint32)


def _torch_planes(keys):
    hi, lo = _planes(keys)
    return (torch.from_numpy(hi.view(np.int32).copy()),
            torch.from_numpy(lo.view(np.int32).copy()))


def test_cold_twins_match_the_jax_probe_and_query(jax_rm4):
    """The JAX test's adversarial data (duplicates, all-miss, all-hit,
    boundary keys, the near-sentinel key, the all-ones padding), plus keys
    of 2**63 and above, which sort last as unsigned words."""
    tp = jax_rm4[0]._tiered_programs()
    chunk = jax_rm4[0]._cold_chunk
    rng = np.random.default_rng(3)
    run = np.unique(np.concatenate([
        rng.integers(1, 1 << 48, size=chunk // 2, dtype=np.uint64),
        rng.integers(1, 1 << 48, size=chunk // 4, dtype=np.uint64)
        | np.uint64(1 << 63),
    ]))
    seg = np.concatenate([
        run, np.full(chunk - run.shape[0], np.uint64(M64)),
    ])
    queries = np.concatenate([
        rng.choice(run, 40),  # hits, some past 2**63
        rng.integers(1, 1 << 48, size=50, dtype=np.uint64),  # mostly misses
        rng.integers(1, 1 << 48, size=20, dtype=np.uint64) | np.uint64(1 << 63),
        run[:1], run[-1:],  # exact boundaries
        np.asarray([M64 - 1, 1 << 63, (1 << 63) - 1], np.uint64),
    ]).astype(np.uint64)
    q = np.zeros(1 << 14, np.uint64)  # a plausible buffer width
    q[: queries.shape[0]] = queries
    new = np.zeros(q.shape, bool)
    new[: queries.shape[0]] = True
    new[::7] = False  # lanes that are not new are never looked up

    q_hi, q_lo = _planes(q)
    c_hi, c_lo = _planes(seg)
    origin = np.arange(q.shape[0], dtype=np.uint32)
    jq = tp["query"](jnp.asarray(q_hi), jnp.asarray(q_lo), jnp.asarray(new),
                     jnp.asarray(origin))
    found = tp["probe"](jnp.zeros(q.shape, jnp.bool_), jq[0], jq[1],
                        jnp.asarray(c_hi), jnp.asarray(c_lo))
    want_fresh = np.asarray(tp["fresh"](jnp.asarray(new), found)[0])
    want_min = (int(jq[2]) << 32) | int(jq[3])
    want_max = (int(jq[4]) << 32) | int(jq[5])

    hi, lo = _torch_planes(q)
    is_new = torch.from_numpy(new.copy())
    minmax = cold_query(hi, lo, None, is_new)  # a CPU tensor: the twin
    assert [int(x) & M64 for x in minmax] == [want_min, want_max]
    cold_probe(hi, lo, None, is_new, torch.from_numpy(seg.view(np.int64).copy()))
    assert np.array_equal(is_new.numpy(), want_fresh)
    assert np.array_equal(is_new.numpy(), new & ~np.isin(q, run))

    # Through an origin map (the sorted path): lane j reads buffer lane
    # perm[j]; no new lane gives the (all-ones, 0) pair, as in JAX.
    perm = torch.from_numpy(rng.permutation(q.shape[0]).astype(np.int32))
    is_new = torch.from_numpy(new.copy())
    got = cold_query_plain(hi, lo, perm, is_new)
    keys = q[perm.numpy()][new]
    assert [int(x) & M64 for x in got] == [int(keys.min()), int(keys.max())]
    cold_probe_plain(hi, lo, perm, is_new,
                     torch.from_numpy(seg.view(np.int64).copy()))
    assert np.array_equal(is_new.numpy(), new & ~np.isin(q[perm.numpy()], run))
    none = torch.zeros(q.shape, dtype=torch.bool)
    assert [int(x) & M64 for x in cold_query_plain(hi, lo, None, none)] == [M64, 0]


# --- the acceptance pin: the port's tiered run is the JAX package's ----------


def test_tiered_matches_jax_with_forced_evictions(jax_rm4, port_rm4, tmp_path):
    """2pc rm=4's 1,568 states against a 512-slot hot table: counts, logs,
    fingerprints, the spill and cold-probe events and the snapshot's cold
    arrays equal to the JAX engine's, and the logs equal to the port's
    in-HBM run's."""
    jt, j_events, j_snap = jax_rm4
    t, events, snap = port_rm4
    assert (t.unique_state_count(), t.state_count(), t.max_depth()) == (
        jt.unique_state_count(), jt.state_count(), jt.max_depth()
    ) == (1568, 8258, 14)
    assert np.array_equal(t.discovered_fingerprints(), jt.discovered_fingerprints())
    assert sorted(t.discoveries()) == sorted(jt.discoveries())
    assert sorted(snap) == sorted(j_snap)
    for k in snap:
        assert np.array_equal(snap[k], j_snap[k]), k
    assert events == j_events
    plain = TwoPhaseSys(rm_count=4).checker().spawn_gpu(
        device="cpu", capacity=1 << 14, max_frontier=1 << 6).join()
    plain_snap = _snapshot(plain, tmp_path / "plain.npz")
    for k in ("rows", "parent", "ebits"):
        assert np.array_equal(snap[k], plain_snap[k]), k

    spills = [e for e in events if e["event"] == "spill"]
    probes = [e for e in events if e["event"] == "cold_probe"]
    assert len(spills) >= 2 and probes
    assert all(e["bytes"] == e["entries"] * 8 for e in spills)
    assert all(e["passes"] >= 1 and e["bytes"] > 0 for e in probes)
    assert sum(e["hits"] for e in probes) > 0
    assert [e["end"] for e in spills] == sorted(e["end"] for e in spills)

    m, jm = t.metrics(), jt.metrics()
    assert m["engine"] == "gpu-tiered" and jm["engine"] == "tpu-tiered"
    assert {k: m[k] for k in SHARED_METRICS} == {k: jm[k] for k in SHARED_METRICS}
    assert m["spills"] == len(spills)
    assert m["cold_entries"] > 0 and m["cold_runs"] >= 1
    assert m["cold_probe_bytes_total"] == sum(e["bytes"] for e in probes)
    assert 0.0 <= m["table_load_factor"] <= 0.5
    assert t.tuned_kwargs() == jt.tuned_kwargs()


def test_memory_budget_knob_derives_capacity(tmp_path):
    """The budget derives the table; with ``cold_dir`` the runs are
    memory-mapped files the probe passes read."""
    cold = tmp_path / "cold"
    t = TwoPhaseSys(rm_count=3).checker().spawn_gpu_tiered(
        device="cpu", memory_budget_mb=0.005, max_frontier=1 << 6,
        cold_dir=str(cold)).join()
    assert t.unique_state_count() == 288
    m = t.metrics()
    assert m["capacity"] == capacity_for_budget(0.005) == 256
    assert m["memory_budget_mb"] == 0.005 and m["spills"] >= 1
    assert m["cold_probe_passes_total"] >= 1
    assert len(os.listdir(cold)) == m["cold_runs"]
    # The budget is authoritative over a capacity riding along.
    t2 = TwoPhaseSys(rm_count=3).checker().spawn_gpu_tiered(
        device="cpu", memory_budget_mb=64, capacity=512,
        max_frontier=1 << 6).join()
    assert t2.metrics()["capacity"] == capacity_for_budget(64)
    assert t2.tuned_kwargs()["capacity"] == capacity_for_budget(64)


def test_tiered_symmetry_canonical_keys_through_tiers():
    """Spills evict canonical keys (K15 before K1): 2pc rm=4's 166 orbits."""
    ref = TwoPhaseSys(rm_count=4).checker().symmetry().spawn_gpu(
        device="cpu", capacity=1 << 14, max_frontier=1 << 6).join()
    t = TwoPhaseSys(rm_count=4).checker().symmetry().spawn_gpu_tiered(
        device="cpu", capacity=256, max_frontier=1 << 6).join()
    assert t.unique_state_count() == ref.unique_state_count() == 166
    assert t.metrics()["spills"] >= 1
    assert np.array_equal(t.discovered_fingerprints(), ref.discovered_fingerprints())


def test_tiered_sorted_dedup_path_keeps_the_in_hbm_log(tmp_path):
    """On the sorted fallback (``sortless=False``) the cold filter reads
    each representative's key through its origin lane; the log stays the
    in-HBM sorted run's."""
    t = TwoPhaseSys(rm_count=4).checker().spawn_gpu_tiered(
        device="cpu", sortless=False, **GEOMETRY).join()
    ref = TwoPhaseSys(rm_count=4).checker().spawn_gpu(
        device="cpu", sortless=False, capacity=1 << 14,
        max_frontier=1 << 6).join()
    m = t.metrics()
    assert m["spills"] >= 2 and m["cold_hits_total"] > 0
    a, b = _snapshot(t, tmp_path / "t.npz"), _snapshot(ref, tmp_path / "r.npz")
    for k in ("rows", "parent", "ebits"):
        assert np.array_equal(a[k], b[k]), k


def test_tiered_ebits_and_violations_match():
    """The trap counter's always and sometimes properties, and its
    eventually bits, through the tiers."""
    from stateright_tpu_torch.models.fixtures import TrapCounter

    ref = TrapCounter(50).checker().spawn_gpu(device="cpu", capacity=1 << 12).join()
    t = TrapCounter(50).checker().spawn_gpu_tiered(
        device="cpu", capacity=64, max_frontier=1 << 6).join()
    assert sorted(t.discoveries()) == sorted(ref.discoveries())
    for name, path in ref.discoveries().items():
        assert t.discoveries()[name].into_actions() == path.into_actions()
    assert t.metrics()["spills"] >= 1
    a, b = t._carry, ref._carry
    assert a.tail == b.tail and torch.equal(a.ebits[: a.tail], b.ebits[: b.tail])


# --- snapshots ----------------------------------------------------------------


def test_tiered_snapshots_cross_resume_with_jax(jax_rm4, port_rm4, tmp_path):
    """A JAX tiered snapshot cut mid-search finishes in the port, and the
    port's in the JAX engine, both to the straight run; completed
    snapshots resume as no-ops either way."""
    jt = jax_rm4[0]
    t = port_rm4[0]
    want = (1568, jt.state_count(), jt.max_depth())
    fps = jt.discovered_fingerprints()

    cut = JaxTwoPhaseSys(rm_count=4).checker().target_state_count(900) \
        .spawn_tpu_tiered(**GEOMETRY).join()
    assert 0 < cut.unique_state_count() < 1568 and cut.metrics()["cold_runs"] >= 1
    snap = str(tmp_path / "jax_cut.npz")
    cut.save_snapshot(snap)
    port = TwoPhaseSys(rm_count=4).checker().spawn_gpu_tiered(
        device="cpu", resume_from=snap, **GEOMETRY).join()
    assert (port.unique_state_count(), port.state_count(), port.max_depth()) == want
    assert np.array_equal(port.discovered_fingerprints(), fps)

    pcut = TwoPhaseSys(rm_count=4).checker().target_state_count(900) \
        .spawn_gpu_tiered(device="cpu", **GEOMETRY).join()
    assert pcut.unique_state_count() == cut.unique_state_count()
    psnap = str(tmp_path / "port_cut.npz")
    pcut.save_snapshot(psnap)
    back = JaxTwoPhaseSys(rm_count=4).checker().spawn_tpu_tiered(
        resume_from=psnap, **GEOMETRY).join()
    assert (back.unique_state_count(), back.state_count(), back.max_depth()) == want
    assert np.array_equal(back.discovered_fingerprints(), fps)

    done = str(tmp_path / "done.npz")
    t.save_snapshot(done)
    again = JaxTwoPhaseSys(rm_count=4).checker().spawn_tpu_tiered(
        resume_from=done, **GEOMETRY).join()
    assert (again.unique_state_count(), again.state_count(), again.max_depth()) == want
    jdone = str(tmp_path / "jdone.npz")
    jt.save_snapshot(jdone)
    again = TwoPhaseSys(rm_count=4).checker().spawn_gpu_tiered(
        device="cpu", resume_from=jdone, **GEOMETRY).join()
    assert (again.unique_state_count(), again.state_count(), again.max_depth()) == want


def test_tiered_and_plain_snapshots_refuse_each_other(tmp_path):
    geometry = dict(device="cpu", capacity=256, max_frontier=1 << 6)
    t = TwoPhaseSys(rm_count=3).checker().spawn_gpu_tiered(**geometry).join()
    snap_t = str(tmp_path / "t.npz")
    t.save_snapshot(snap_t)
    with pytest.raises(ValueError, match="does not match"):
        TwoPhaseSys(rm_count=3).checker().spawn_gpu(
            resume_from=snap_t, **geometry).join()
    p = TwoPhaseSys(rm_count=3).checker().spawn_gpu(**geometry).join()
    snap_p = str(tmp_path / "p.npz")
    p.save_snapshot(snap_p)
    with pytest.raises(ValueError, match="not written by the tiered"):
        TwoPhaseSys(rm_count=3).checker().spawn_gpu_tiered(
            resume_from=snap_p, **geometry).join()
    with pytest.raises(ValueError, match="memory_budget_mb"):
        TwoPhaseSys(rm_count=3).checker().spawn_gpu_tiered(
            device="cpu", memory_budget_mb=64, max_frontier=1 << 6,
            resume_from=snap_t).join()


def test_abort_cleanup_erases_uncommitted_table_keys():
    """A kept partial result on a flagged wave must not keep the aborted
    insert's keys: the cleanup rebuilds the hot table from the committed
    ``[spill_tail, tail)`` segment."""
    ck = TwoPhaseSys(rm_count=3).checker().spawn_gpu_tiered(
        device="cpu", capacity=256, max_frontier=1 << 6).join()
    table = ck._carry.table
    bogus = (torch.tensor([0xDEAD], dtype=torch.int32),
             torch.tensor([0xBEEF], dtype=torch.int32))
    new, ok = insert_batch_claim(table, *bogus, torch.ones((1,), dtype=torch.bool))
    assert bool(ok) and bool(new.all())
    polluted = table.load_factor()
    ck._wl_abort_cleanup()
    lf = ck._carry.table.load_factor()
    assert lf < polluted
    assert lf == (ck._carry.tail - ck._spill_tail) / ck._capacity
    assert not bool((ck._carry.table.keys == (0xDEAD << 32 | 0xBEEF)).any())


def test_tiered_spawn_validation():
    m = TwoPhaseSys(rm_count=3)
    with pytest.raises(ValueError, match="spill_threshold"):
        m.checker().spawn_gpu_tiered(device="cpu", capacity=256, spill_threshold=0.9)
    with pytest.raises(ValueError, match="cold_chunk"):
        m.checker().spawn_gpu_tiered(device="cpu", capacity=256, cold_chunk=100)
    with pytest.raises(ValueError, match="memory_budget_mb"):
        m.checker().spawn_gpu_tiered(device="cpu", memory_budget_mb=-1)
    # Traced mode is ported; like the JAX engine's it refuses a resume and
    # a visitor, with the JAX engine's messages.
    with pytest.raises(ValueError, match=r"trace=True\) does not support resume_from"):
        m.checker().spawn_gpu_tiered(device="cpu", capacity=256, trace=True,
                                     resume_from="never-read.npz")
    with pytest.raises(ValueError, match="does not support visitors"):
        m.checker().visitor(lambda path: None).spawn_gpu_tiered(
            device="cpu", capacity=256)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match=r"spawn_gpu_tiered\(\): no CUDA"):
            m.checker().spawn_gpu_tiered(capacity=256)



def test_tiered_trace_breaks_out_cold_probe(tmp_path):
    """The port's mirror of the JAX engine's ``test_tiered_trace_breaks_out_
    cold_probe``: a traced tiered run that spills gains the host-classed
    ``cold_probe`` phase in every traced wave's breakdown and still
    matches the in-HBM run."""
    journal = str(tmp_path / "trace.jsonl")
    ref = TwoPhaseSys(rm_count=3).checker().spawn_gpu(
        device="cpu", capacity=1 << 14, max_frontier=1 << 6).join()
    t = TwoPhaseSys(rm_count=3).checker().spawn_gpu_tiered(
        device="cpu", capacity=256, max_frontier=1 << 6, trace=True,
        journal=journal).join()
    assert t.unique_state_count() == ref.unique_state_count() == 288
    assert np.array_equal(t.discovered_fingerprints(),
                          ref.discovered_fingerprints())

    summary = t.trace_summary()
    assert summary["traced_waves"] > 0 and summary["engine"] == "gpu-tiered"
    assert "cold_probe" in summary["wave_breakdown"]
    assert t.metrics()["trace_summary"]["traced_waves"] == summary["traced_waves"]

    events = read_journal(journal)
    assert any(e["event"] == "spill" for e in events)
    assert any(e["event"] == "cold_probe" for e in events)
    waves = [e for e in events if e["event"] == "wave" and "wave_breakdown" in e]
    assert waves, "traced waves must journal their phase breakdown"
    assert all("cold_probe" in w["wave_breakdown"] for w in waves)
    assert len(waves) == sum(
        1 for e in events if e["event"] == "wave" and not e["flags"])
    assert [e["event"] for e in events][-2:] == ["trace_summary", "engine_done"]
