"""The port's sharded wavefront checker against the JAX package's, on the CPU.

``spawn_gpu_sharded(mesh=["cpu"] * n)`` (plain-torch twins, K26's and
K27's among them) and the JAX package's ``spawn_tpu_sharded`` on conftest's
8-device virtual CPU mesh run 2pc rm=3 at the same arguments: every
shard's key planes, store, parents, ebits, queue and stats row, the
counts, the accounting, the discovery names and their re-executed paths
must be bit-equal (integers: tolerance zero).  The owner mix, K26's twin
and K27's twin are held against the JAX expressions they replace on
seeded data.  The further JAX pins (``tests/test_tpu_sharded.py``,
``test_sortless.py``, ``test_tpu_symmetry.py``, ``test_metrics_schema.py``)
are mirrored against the port's single-card ``spawn_gpu(device="cpu")``,
which the suite already holds to the JAX engine.  The kernels against
their twins on the card are in ``test_torch_device.py``, which imports no
JAX.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stateright_tpu.models.twophase import TwoPhaseSys as JaxTwoPhaseSys  # noqa: E402
from stateright_tpu.parallel.sharded import (  # noqa: E402
    _owner_mix as jax_owner_mix,
)
from stateright_tpu.parallel.wave_loop import (  # noqa: E402
    exchange_bucket_lanes as jax_exchange_bucket_lanes,
    next_bucket_slack as jax_next_bucket_slack,
)
from stateright_tpu.runtime.journal import read_journal as jax_read_journal  # noqa: E402
from stateright_tpu_torch.models.fixtures import TrapCounter  # noqa: E402
from stateright_tpu_torch.models.twophase import TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32  # noqa: E402
from stateright_tpu_torch.parallel.exchange import (  # noqa: E402
    owner_bucket_plain, owner_mix, owner_mix_host,
    owner_mix_host_np, shard_commit, shard_commit_plain,
)
from stateright_tpu_torch.parallel.wave_loop import (  # noqa: E402
    STEP_RUNG_MIN, exchange_bucket_lanes, next_bucket_slack,
)
from stateright_tpu_torch.runtime.journal import read_journal  # noqa: E402

SMALL = dict(capacity=1 << 13, chunk_size=1 << 6)
MESHES = (1, 2, 4, 8)


def _mesh(n):
    devices = jax.devices("cpu")
    assert len(devices) >= n, f"need {n} CPU devices, have {len(devices)}"
    return jax.sharding.Mesh(np.array(devices[:n]), ("shards",))


def _port(builder, n, **kw):
    return builder.spawn_gpu_sharded(mesh=["cpu"] * n, **kw).join()


def _single(model, **kw):
    return model.checker().spawn_gpu(device="cpu", **kw).join()


def _path_fps(model, path):
    return [int(model.fingerprint(s)) for s in path.into_states()]


def _snapshot(checker, path):
    checker.save_snapshot(str(path))
    with np.load(path) as snap:
        return {k: snap[k].copy() for k in snap.files}


@pytest.fixture(scope="module")
def jax_rm3(tmp_path_factory):
    """The JAX engine's 2pc rm=3 at SMALL on 1/2/4/8 virtual devices:
    each run's checker, snapshot arrays and journal."""
    d = tmp_path_factory.mktemp("jax_sharded")
    runs = {}
    for n in MESHES:
        journal = str(d / f"j{n}.jsonl")
        ck = JaxTwoPhaseSys(rm_count=3).checker().spawn_tpu_sharded(
            mesh=_mesh(n), journal=journal, **SMALL).join()
        runs[n] = (ck, _snapshot(ck, d / f"j{n}.npz"), jax_read_journal(journal))
    return runs


def test_owner_mix_matches_jax():
    """Host, numpy and tensor owner mixes equal JAX's ``_owner_mix`` on
    4,096 seeded pairs, words past 2**31 among them."""
    rng = np.random.default_rng(11)
    hi = rng.integers(0, 2**32, size=4096, dtype=np.uint32)
    lo = rng.integers(0, 2**32, size=4096, dtype=np.uint32)
    hi[:4], lo[:4] = [0, 2**31, 2**32 - 1, 1], [2**32 - 1, 0, 2**31, 2**31 + 5]
    want = np.asarray(jax_owner_mix(jnp.asarray(hi), jnp.asarray(lo)))
    host = np.array([owner_mix_host(int(h), int(v)) for h, v in zip(hi, lo)],
                    np.uint32)
    assert np.array_equal(host, want)
    assert np.array_equal(owner_mix_host_np(hi, lo), want)
    got = owner_mix(from_numpy_u32(hi, "cpu"), from_numpy_u32(lo, "cpu"))
    assert np.array_equal(got.numpy().astype(np.uint32), want)


def test_bucket_ladder_matches_jax():
    for u_sz in (8, 100, 16_384, 106_496):
        for n in (1, 2, 3, 4, 8):
            for slack in (1, 7, 50, 100, 400):
                assert exchange_bucket_lanes(u_sz, n, slack) == \
                    jax_exchange_bucket_lanes(u_sz, n, slack)
                assert next_bucket_slack(u_sz, n, slack) == \
                    jax_next_bucket_slack(u_sz, n, slack)


def _jax_bucketing(n, bkt, w):
    """``stateright_tpu/parallel/sharded.py:685-727``, lifted as it stands
    (with ``commit`` true) into a jitted function."""
    u = jnp.uint32

    @jax.jit
    def bucket(u_hi, u_lo, u_valid, rows_u, gid_u, eb_u):
        u_sz = u_hi.shape[0]
        owner = jax_owner_mix(u_hi, u_lo) % u(n)
        key = jnp.where(u_valid, owner, u(n))
        order = jnp.argsort(key, stable=True)
        key_s = key[order]
        counts = jnp.stack(
            [jnp.sum((key == u(d)).astype(u)) for d in range(n + 1)]
        )
        overflow = jnp.any(counts[:n] > u(bkt))
        offsets = jnp.concatenate([jnp.zeros((1,), u), jnp.cumsum(counts)[:-1]])
        pos = jnp.arange(u_sz, dtype=u) - offsets[key_s]
        dst = jnp.where(key_s < n, key_s, u(n))
        payload = jnp.concatenate(
            [rows_u, gid_u[:, None], eb_u[:, None], u_valid.astype(u)[:, None]],
            axis=1,
        )
        send = jnp.zeros((n, bkt, w + 3), u)
        send = send.at[dst, pos].set(payload[order], mode="drop")
        return send, counts, overflow

    return bucket


def _bucket_inputs(rng, n, per_dest, invalid, w):
    """Representatives whose owners follow ``per_dest`` (lanes per owner),
    shuffled, with ``invalid`` inactive lanes among them."""
    hi = rng.integers(0, 2**32, size=64 * sum(per_dest), dtype=np.uint32)
    lo = rng.integers(0, 2**32, size=hi.shape[0], dtype=np.uint32)
    own = owner_mix_host_np(hi, lo) % n
    pick = np.concatenate([
        np.flatnonzero(own == d)[:k] for d, k in enumerate(per_dest)
    ] + [np.arange(invalid)])
    valid = np.arange(pick.shape[0]) < sum(per_dest)
    perm = rng.permutation(pick.shape[0])
    pick, valid = pick[perm], valid[perm]
    u_sz = pick.shape[0]
    rows = rng.integers(0, 2**32, size=(u_sz, w), dtype=np.uint32)
    gid = rng.integers(0, 2**32, size=u_sz, dtype=np.uint32)
    eb = rng.integers(0, 2**32, size=u_sz, dtype=np.uint32)
    return hi[pick], lo[pick], valid, rows, gid, eb


def _check_bucketing(rng, n, bkt, w, per_dest, invalid):
    """The twin against JAX's bucketing on :func:`_bucket_inputs`: send
    buffer, counts and overflow bit equal; returns the overflow bit."""
    hi, lo, valid, rows, gid, eb = _bucket_inputs(rng, n, per_dest, invalid, w)
    want = _jax_bucketing(n, bkt, w)(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid),
        jnp.asarray(rows), jnp.asarray(gid), jnp.asarray(eb),
    )
    lanes = torch.arange(hi.shape[0], dtype=torch.int32)
    send, counts, overflow = owner_bucket_plain(
        from_numpy_u32(hi, "cpu"), from_numpy_u32(lo, "cpu"),
        torch.from_numpy(valid), from_numpy_u32(rows, "cpu"), lanes, lanes,
        1, from_numpy_u32(gid, "cpu"), from_numpy_u32(eb, "cpu"), n, bkt,
    )
    assert np.array_equal(to_numpy_u32(send), np.asarray(want[0]))
    assert np.array_equal(counts.numpy(), np.asarray(want[1]))
    assert bool(overflow) == bool(want[2])
    return bool(overflow)


def test_owner_bucket_twin_matches_jax():
    """K26's twin against JAX's bucketing: seeded keys with invalid lanes
    and one destination past its bucket (flag 32); send buffer, counts and
    overflow bit equal."""
    rng = np.random.default_rng(26)
    for per_dest, expect_overflow in (((200, 90, 60, 100), True),
                                      ((100, 128, 7, 0), False)):
        assert _check_bucketing(rng, 4, 128, 3, per_dest, 300) == expect_overflow


@pytest.mark.parametrize("n, bkt, per_dest, invalid", [
    (8, 64, (40, 0, 0, 0, 0, 0, 0, 0), 5),  # every lane to one owner
    (4, 1, (3, 1, 0, 2), 4),                # one slot a bucket
    (4, 16, (0, 0, 0, 0), 0),               # no lane at all
], ids=["one-owner", "bkt1", "empty"])
def test_owner_bucket_twin_matches_jax_extremes(n, bkt, per_dest, invalid):
    """K26's twin against JAX's bucketing at the card fuzz's extremes: send
    buffer, counts and overflow bit equal."""
    rng = np.random.default_rng(126)
    overflow = _check_bucketing(rng, n, bkt, 2, per_dest, invalid)
    assert overflow == any(k > bkt for k in per_dest)


def test_shard_commit_twin_matches_jax():
    """K27's twin against ``sharded.py:789-806``: store, parent, ebits,
    queue and the new tail, on a seeded receive batch of new lanes at
    distinct slots, on both paths (identity origin and the sorted one)."""
    rng = np.random.default_rng(27)
    cap, w, r, tail = 1 << 10, 4, 700, 33
    qlen = cap + 64
    u = jnp.uint32
    for use_origin in (False, True):
        is_new = rng.random(r) < 0.4
        slot = rng.permutation(cap)[:r].astype(np.uint32)
        origin = rng.permutation(r).astype(np.uint32)
        rw = rng.integers(0, 2**32, size=(r, w), dtype=np.uint32)
        rg = rng.integers(0, 2**32, size=r, dtype=np.uint32)
        reb = rng.integers(0, 2**32, size=r, dtype=np.uint32)
        store0 = rng.integers(0, 2**32, size=(cap, w), dtype=np.uint32)
        parent0 = rng.integers(0, 2**32, size=cap, dtype=np.uint32)
        ebits0 = rng.integers(0, 2**32, size=cap, dtype=np.uint32)
        queue0 = rng.integers(0, 2**32, size=qlen, dtype=np.uint32)

        # The JAX lines, with rows_r = rw[r_origin] on the sorted path.
        o = jnp.asarray(origin) if use_origin else jnp.arange(r, dtype=u)
        r_new, r_slot = jnp.asarray(is_new), jnp.asarray(slot)
        sslot = jnp.where(r_new, r_slot, u(cap))
        store = jnp.asarray(store0).at[sslot].set(jnp.asarray(rw)[o], mode="drop")
        parent = jnp.asarray(parent0).at[sslot].set(jnp.asarray(rg)[o], mode="drop")
        ebits = jnp.asarray(ebits0).at[sslot].set(jnp.asarray(reb)[o], mode="drop")
        n_new = jnp.sum(r_new, dtype=u)
        qpos = u(tail) + jnp.cumsum(r_new.astype(u)) - 1
        qidx = jnp.where(r_new, qpos, u(0xFFFFFFFF))
        queue = jnp.asarray(queue0).at[qidx].set(r_slot, mode="drop")

        t = {k: from_numpy_u32(v, "cpu") for k, v in dict(
            store=store0, parent=parent0, ebits=ebits0, queue=queue0,
        ).items()}
        got = shard_commit_plain(
            torch.from_numpy(is_new), from_numpy_u32(slot, "cpu"),
            from_numpy_u32(origin, "cpu") if use_origin else None,
            from_numpy_u32(rw, "cpu"), from_numpy_u32(rg, "cpu"),
            from_numpy_u32(reb, "cpu"), t["store"], t["parent"], t["ebits"],
            t["queue"], tail,
        )
        assert int(got) == int(n_new)
        for k, want in (("store", store), ("parent", parent), ("ebits", ebits),
                        ("queue", queue)):
            assert np.array_equal(to_numpy_u32(t[k]), np.asarray(want)), k
        # The wrapper runs the twin on CPU tensors.
        t2 = {k: from_numpy_u32(v, "cpu") for k, v in dict(
            store=store0, parent=parent0, ebits=ebits0, queue=queue0,
        ).items()}
        shard_commit(
            torch.from_numpy(is_new), from_numpy_u32(slot, "cpu"),
            from_numpy_u32(origin, "cpu") if use_origin else None,
            from_numpy_u32(rw, "cpu"), from_numpy_u32(rg, "cpu"),
            from_numpy_u32(reb, "cpu"), t2["store"], t2["parent"],
            t2["ebits"], t2["queue"], tail,
        )
        assert all(torch.equal(t[k], t2[k]) for k in t)


@pytest.mark.parametrize("n", MESHES)
def test_per_shard_state_matches_jax(n, jax_rm3, tmp_path):
    """2pc rm=3 at 1/2/4/8 shards: every shard's key planes, store,
    parents, ebits, queue and stats row bit-equal to the JAX engine's at
    the same arguments (its journal shows no tuner rung change), with its
    counts, accounting, discovery names and paths."""
    jck, jsnap, jevents = jax_rm3[n]
    assert sum(e["event"] == "geometry" for e in jevents) == 1
    model = TwoPhaseSys(rm_count=3)
    ck = _port(model.checker(), n, **SMALL)
    snap = _snapshot(ck, tmp_path / "p.npz")
    assert sorted(snap) == sorted(jsnap)
    for k in jsnap:
        assert snap[k].shape == jsnap[k].shape and (snap[k] == jsnap[k]).all(), k
    assert (ck.unique_state_count(), ck.state_count(), ck.max_depth()) == (
        jck.unique_state_count(), jck.state_count(), jck.max_depth())
    assert ck.unique_state_count() == 288
    assert ck.accounting() == jck.accounting()
    assert sorted(ck.discoveries()) == sorted(jck.discoveries())
    for name, path in jck.discoveries().items():
        assert _path_fps(model, ck.discoveries()[name]) == _path_fps(model, path)


# The sorted path, where the JAX untraced loop's tuners downshift after
# their eighth committed call: 2pc rm=3 at one wave a call (the sort
# rung), and GridWalk at four waves a call, whose levels are narrow and
# many (the sort rung, then the step rung), so a retune after every wave,
# or a density over the wrong wave count, moves or changes its
# ``geometry`` events.
RETUNED = {
    "rm3-w1": (lambda pkg: pkg[0](rm_count=3),
               dict(capacity=1 << 14, chunk_size=1 << 8, waves_per_call=1,
                    sortless=False), 288),
    "grid-w4": (lambda pkg: pkg[1](bound=40),
                dict(capacity=1 << 13, chunk_size=1 << 11, waves_per_call=4,
                     sortless=False), 41 * 41),
}


def _geometry(events):
    """The ``geometry`` events, each with the unique and state counts of
    the last ``wave`` event before it: where in the run the rung moved
    (a JAX event a call, the port's a wave, so a call's last wave)."""
    out, last = [], None
    for e in events:
        if e["event"] == "wave":
            last = (e["unique"], e["states"])
        elif e["event"] == "geometry":
            out.append(({k: v for k, v in e.items() if k not in ("t", "engine")},
                        last))
    return out


def _by_key(snap, n):
    """Every shard's state with each slot named by the key it holds: on
    the sorted path a key may take another slot than in the JAX table
    (``parallel/hashset.py``), so the queue (the order states were
    found), each queued state's row, parent and ebits, and the stats rows
    (discoveries as keys) are compared by key."""
    cap = snap["key_hi"].shape[0] // n
    bits = cap.bit_length() - 1
    qlen = snap["queue"].shape[0] // n
    key = (snap["key_hi"].astype(np.uint64) << np.uint64(32)) | snap["key_lo"]

    def name(gid):
        gid = int(gid)
        if gid == 0xFFFFFFFF:
            return None
        return gid >> bits, int(key[(gid >> bits) * cap + (gid & (cap - 1))])

    stats = snap["stats"]
    shards = []
    for s in range(n):
        tail = int(stats[s, 2])
        states = [
            (int(key[s * cap + q]), snap["store"][s * cap + q].tolist(),
             name(snap["parent"][s * cap + q]), int(snap["ebits"][s * cap + q]))
            for q in snap["queue"][s * qlen: s * qlen + tail].tolist()
        ]
        shards.append((states, stats[s, :12].tolist(),
                       [name(g) for g in stats[s, 12:]]))
    return shards


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("case", sorted(RETUNED))
def test_untraced_tuners_retune_at_jax_call_ends(case, n, tmp_path):
    """The untraced loop's density tuners run where the JAX
    ``FusedWaveLoop`` runs them, after each committed call, with the
    call's density: on the sorted path, where JAX's journal shows a sort
    rung downshift (asserted first), the port gives the same ``geometry``
    events at the same points of the run, ``tuned_kwargs()`` (with the
    tuned ``sort_lanes``) and every shard's state, key by key, at 1/2/4/8
    shards."""
    from stateright_tpu.models.fixtures import GridWalk as JaxGridWalk
    from stateright_tpu_torch.models.fixtures import GridWalk

    model, kw, unique = RETUNED[case]
    jpath = str(tmp_path / "j.jsonl")
    jck = model((JaxTwoPhaseSys, JaxGridWalk)).checker().spawn_tpu_sharded(
        mesh=_mesh(n), journal=jpath, **kw).join()
    want = _geometry(jax_read_journal(jpath))
    assert any(g["sort_lanes"] < want[0][0]["sort_lanes"] for g, _ in want[1:])
    ppath = str(tmp_path / "p.jsonl")
    ck = _port(model((TwoPhaseSys, GridWalk)).checker(), n, journal=ppath, **kw)
    assert _geometry(read_journal(ppath)) == want
    assert ck.tuned_kwargs() == jck.tuned_kwargs()
    assert "sort_lanes" in ck.tuned_kwargs()
    snap = _snapshot(ck, tmp_path / "p.npz")
    jsnap = _snapshot(jck, tmp_path / "j.npz")
    assert sorted(snap) == sorted(jsnap)
    for k in jsnap:
        assert snap[k].shape == jsnap[k].shape, k
    assert _by_key(snap, n) == _by_key(jsnap, n)
    assert ck.unique_state_count() == jck.unique_state_count() == unique


def test_trap_counter_four_shards():
    """The eventually counterexample across shards
    (``test_tpu_sharded.py:39``): ``reaches limit`` ends in the trap."""
    model = TrapCounter()
    ck = _port(model.checker(), 4, capacity=1 << 13, chunk_size=1 << 4)
    single = _single(model, capacity=1 << 10, max_frontier=1 << 4)
    assert ck.unique_state_count() == single.unique_state_count()
    assert sorted(ck.discoveries()) == sorted(single.discoveries())
    assert ck.discoveries()["reaches limit"].last_state() == model.trap_state


def test_one_shard_mesh_elides_the_exchange():
    """``test_tpu_sharded.py:136``: the 1-shard mesh matches the single
    card and says in its accounting that nothing was exchanged."""
    model = TwoPhaseSys(rm_count=3)
    ck = _port(model.checker(), 1, **SMALL)
    single = _single(model, capacity=1 << 13, max_frontier=1 << 6)
    assert (ck.unique_state_count(), ck.state_count(), ck.max_depth()) == (
        single.unique_state_count(), single.state_count(), single.max_depth())
    assert sorted(ck.discoveries()) == sorted(single.discoveries())
    acc = ck.accounting()
    assert acc["exchange_elided"] is True
    assert acc["all_to_all_bytes_total"] == 0
    assert acc["exchange_occupancy"] == 0.0


@pytest.mark.parametrize("n", (2, 4))
def test_bucketed_accounting_identities(n):
    """``test_tpu_sharded.py:163``: the fingerprint set is the single
    card's and the byte totals follow the bucket geometry."""
    model = TwoPhaseSys(rm_count=3)
    fps = _single(model, capacity=1 << 13, max_frontier=1 << 6).discovered_fingerprints()
    ck = _port(model.checker(), n, **SMALL)
    assert np.array_equal(ck.discovered_fingerprints(), fps)
    acc = ck.accounting()
    w = model.compiled().state_width
    assert acc["all_to_all_bytes_per_wave_per_shard"] == (
        n * acc["exchange_bucket_lanes"] * (w + 3) * 4)
    assert acc["all_to_all_bytes_total"] == (
        acc["waves"] * n * acc["all_to_all_bytes_per_wave_per_shard"])
    assert acc["exchange_occupancy"] * acc["all_to_all_bytes_total"] == \
        pytest.approx(acc["exchange_payload_bytes_total"], rel=1e-9)


def test_forced_bucket_retry_four_shards(tmp_path):
    """``test_tpu_sharded.py:202`` (untraced): bucket_slack=1 overflows a
    bucket, the wave commits nothing, the slack ladder climbs (a ``grow``
    with flag 32) and the set is the single card's."""
    model = TwoPhaseSys(rm_count=4)
    fps = _single(model, capacity=1 << 14, max_frontier=1 << 7).discovered_fingerprints()
    journal = str(tmp_path / "bucket.jsonl")
    ck = _port(model.checker(), 4, capacity=1 << 14, chunk_size=1 << 7,
               bucket_slack=1, journal=journal)
    assert ck.unique_state_count() == 1568
    assert np.array_equal(ck.discovered_fingerprints(), fps)
    acc = ck.accounting()
    assert acc["bucket_retries"] >= 1 and acc["bucket_slack"] > 1
    grows = [e for e in read_journal(journal) if e["event"] == "grow"]
    assert grows and any(e["flags"] & 32 for e in grows)


@pytest.mark.parametrize("n", MESHES)
def test_sortless_sharded_matches_single_card(n):
    """``test_sortless.py:104``: the default (claim) path at every mesh
    size lands the single card's set; ``sortless=False`` lands it too."""
    model = TwoPhaseSys(rm_count=4)
    fps = _single(model, capacity=1 << 14, max_frontier=1 << 7).discovered_fingerprints()
    ck = _port(model.checker(), n, capacity=1 << 14, chunk_size=1 << 7)
    assert ck.unique_state_count() == 1568
    assert np.array_equal(ck.discovered_fingerprints(), fps)
    assert ck.accounting()["sortless"] == 1
    srt = _port(model.checker(), n, capacity=1 << 14, chunk_size=1 << 7,
                sortless=False)
    assert np.array_equal(srt.discovered_fingerprints(), fps)
    assert srt.accounting()["sortless"] == 0


def test_forced_tiny_step_rung_and_snapshot_persist_it(tmp_path):
    """``test_sortless.py:200, :226``: a tiny step rung clamps (flag 128,
    nothing commits) and climbs; a snapshot cut by ``target_state_count``
    carries the dedup path and the rung, which the resumed run adopts."""
    model = TwoPhaseSys(rm_count=4)
    fps = _single(model, capacity=1 << 14, max_frontier=1 << 7).discovered_fingerprints()
    journal = str(tmp_path / "step.jsonl")
    ck = _port(model.checker(), 2, capacity=1 << 14, chunk_size=1 << 9,
               step_lanes=STEP_RUNG_MIN, journal=journal)
    assert ck.unique_state_count() == 1568
    assert np.array_equal(ck.discovered_fingerprints(), fps)
    if ck.accounting()["step_retries"]:
        climbs = [e for e in read_journal(journal)
                  if e["event"] == "grow" and "step_lanes=" in e["grown"]]
        assert climbs and all(e["flags"] & 128 for e in climbs)
    snap = str(tmp_path / "snap.npz")
    cut = _port(model.checker().target_state_count(400), 2,
                capacity=1 << 14, chunk_size=1 << 7, step_lanes=STEP_RUNG_MIN)
    assert cut.unique_state_count() < 1568
    cut.save_snapshot(snap)
    resumed = _port(model.checker(), 2, capacity=1 << 14, chunk_size=1 << 7,
                    resume_from=snap)
    assert resumed.unique_state_count() == 1568
    assert np.array_equal(resumed.discovered_fingerprints(), fps)
    m = resumed.metrics()
    assert m["sortless"] is True and m["step_lanes_rung"] >= STEP_RUNG_MIN


def test_symmetric_2pc3_eight_shards():
    """``test_tpu_symmetry.py:317``: canonical fingerprints route owners,
    so eight shards reproduce the single card's 80 orbits."""
    model = TwoPhaseSys(rm_count=3)
    ck = _port(model.checker().symmetry(), 8, capacity=1 << 16, chunk_size=1 << 7)
    single = model.checker().symmetry().spawn_gpu(device="cpu").join()
    assert ck.unique_state_count() == single.unique_state_count() == 80
    assert sorted(ck.discoveries()) == sorted(single.discoveries())
    assert np.array_equal(ck.discovered_fingerprints(),
                          single.discovered_fingerprints())


def test_metrics_schema(jax_rm3):
    """``test_metrics_schema.py:137, :192``: the keys the JAX sharded
    engine shares with the port's single-card engine, and the sharded ones
    (per-shard gauges and skews, ``sortless``, ``step_lanes_rung``), with
    the JAX types; the density telemetry."""
    model = TwoPhaseSys(rm_count=3)
    m = _port(model.checker(), 2, **SMALL).metrics()
    jm = jax_rm3[2][0].metrics()
    sharded = (
        "shards", "capacity_per_shard", "chunk_size", "bucket_slack",
        "exchange_bucket_lanes", "sortless", "sort_lanes_rung", "step_lanes",
        "step_lanes_rung", "shard_unique", "shard_frontier",
        "shard_exchange_bytes", "unique_skew_max_over_mean",
        "frontier_skew_max_over_mean", "exchange_skew_max_over_mean",
    )
    single = set(_single(model, capacity=1 << 13).metrics())
    for key in sorted((set(jm) & single) | set(sharded)):
        if key in ("engine", "histograms"):
            continue
        assert key in m, key
        assert isinstance(m[key], type(jm[key])) or (
            isinstance(m[key], (int, float)) and isinstance(jm[key], (int, float))
            and not isinstance(m[key], bool)
        ), key
    assert m["engine"] == "gpu-sharded"
    assert set(m["shard_unique"]) == {"0", "1"}
    assert m["unique_state_count"] == 288 and m["table_load_factor"] > 0
    assert m["accounting"] == jm["accounting"]
    assert 0 < m["valid_density_ema"] <= 1.0
    assert m["histograms"]["valid_density"]["count"] > 0


def test_resume_on_another_mesh_size_fails(tmp_path):
    """Global ids encode the owner shard: a 4-shard snapshot refuses a
    2-shard mesh with the JAX engine's message, and resumes on four."""
    model = TwoPhaseSys(rm_count=3)
    snap = str(tmp_path / "s.npz")
    cut = _port(model.checker().target_state_count(100), 4, **SMALL)
    cut.save_snapshot(snap)
    with pytest.raises(ValueError, match="written on a 4-shard mesh and "
                                         "cannot resume on 2 shards"):
        _port(model.checker(), 2, resume_from=snap, **SMALL)
    assert _port(model.checker(), 4, resume_from=snap, **SMALL) \
        .unique_state_count() == 288


def test_trace_and_visitors_are_refused():
    """Visitors stay refused; ``trace=True`` is accepted (a fresh run; with
    ``resume_from`` it is refused, as in the JAX engine)."""
    ck = TwoPhaseSys(rm_count=3).checker().spawn_gpu_sharded(
        mesh=["cpu"], trace=True, **SMALL).join()
    assert ck.unique_state_count() == 288
    assert ck.trace_summary()["traced_waves"] == ck.accounting()["waves"]
    with pytest.raises(ValueError, match="resume_from"):
        TwoPhaseSys(rm_count=3).checker().spawn_gpu_sharded(
            mesh=["cpu"], trace=True, resume_from="unused.npz")
    with pytest.raises(ValueError, match="visitors"):
        TwoPhaseSys(rm_count=3).checker().visitor(lambda p: None) \
            .spawn_gpu_sharded(mesh=["cpu"])


TRACED = dict(capacity=1 << 14, chunk_size=1 << 8)  # test_obs.py:316


@pytest.fixture(scope="module")
def jax_traced(tmp_path_factory):
    """The JAX engine's traced 2pc rm=3 on 4 virtual devices at
    ``test_obs.py:316``'s arguments: its checker and journal."""
    journal = str(tmp_path_factory.mktemp("jax_traced") / "j.jsonl")
    ck = JaxTwoPhaseSys(rm_count=3).checker().spawn_tpu_sharded(
        mesh=_mesh(4), trace=True, journal=journal, **TRACED).join()
    return ck, jax_read_journal(journal)


def test_traced_sharded_matches_jax(jax_traced, tmp_path):
    """``test_obs.py:316`` against the JAX engine's traced run: counts,
    discoveries and fingerprints; the number of journal ``wave`` events
    and each one's ``exchange_payload_bytes`` and ``exchange_occupancy``
    (the density tuner's rung change included); the breakdown's keys; the
    totals against the accounting; and each wave's exchange bytes the
    port's model, summed over the card's shards."""
    jck, jevents = jax_traced
    model = TwoPhaseSys(rm_count=3)
    journal = str(tmp_path / "t.jsonl")
    ck = _port(model.checker(), 4, trace=True, journal=journal, **TRACED)
    assert (ck.unique_state_count(), ck.state_count(), ck.max_depth()) == (
        jck.unique_state_count(), jck.state_count(), jck.max_depth())
    assert sorted(ck.discoveries()) == sorted(jck.discoveries())
    assert np.array_equal(ck.discovered_fingerprints(), jck.discovered_fingerprints())
    events = read_journal(journal)
    waves = [e for e in events if e["event"] == "wave"]
    jwaves = [e for e in jevents if e["event"] == "wave"]
    assert len(waves) == len(jwaves) == ck.accounting()["waves"]
    for got, want in zip(waves, jwaves):
        for k in ("exchange_payload_bytes", "exchange_occupancy", "unique",
                  "states", "depth", "remaining", "probe_rounds"):
            assert got[k] == want[k], (k, got["waves"])
    assert [e["sort_lanes"] for e in events if e["event"] == "geometry"] == [
        e["sort_lanes"] for e in jevents if e["event"] == "geometry"]
    s = ck.trace_summary()
    assert set(s["wave_breakdown"]) == set(jck.trace_summary()["wave_breakdown"]) == {
        "step", "canon", "dedup", "exchange", "append", "readback"}
    assert sum(w["exchange_payload_bytes"] for w in waves) == \
        s["exchange_payload_bytes"] == ck.accounting()["exchange_payload_bytes_total"]
    assert ck.accounting() == jck.accounting()
    assert ck.metrics()["trace_summary"]["traced_waves"] == len(waves)
    assert [e["event"] for e in events][-2:] == ["trace_summary", "engine_done"]
    # The exchange term of the port's model, summed over the card's four
    # shards: K26 (9 bytes a buffer lane, 16 + 4W a representative, the
    # send buffer written), the slice copies read and written, K1 over
    # each owner's n * bkt receive rows.  Only the senders' buffer widths
    # are not in the journal: what is left is 9 bytes a lane of them.
    n, w = 4, model.compiled().state_width
    bkt = size = None
    for e in events:
        if e["event"] == "geometry":
            bkt, size = e["exchange_bucket_lanes"], e["sort_lanes"]
        if e["event"] != "wave":
            continue
        b = e["bytes"]
        assert set(b) == {"step", "canon", "dedup", "exchange", "append"}
        reps = e["exchange_payload_bytes"] // ((w + 3) * 4)
        known = reps * (16 + 4 * w) + n * (
            3 * n * bkt * (w + 3) * 4 + n * bkt * (4 * w + 8))
        rest = b["exchange"] - known
        assert rest % 9 == 0 and 0 <= rest <= 9 * n * size, e["waves"]
        assert 0 < e["hbm_util_frac"] and b["step"] > 0 and b["append"] > 0
    assert s["bytes"]["exchange"] == sum(e["bytes"]["exchange"] for e in waves)


def test_traced_one_shard_elides_the_exchange():
    """``test_obs.py:351``: the 1-shard traced run elides the exchange --
    its modeled bytes and payload are 0 -- and lands the single card's
    set."""
    model = TwoPhaseSys(rm_count=3)
    ck = _port(model.checker(), 1, trace=True, **TRACED)
    assert ck.unique_state_count() == 288
    s = ck.trace_summary()
    assert s["bytes"]["exchange"] == 0
    assert s["exchange_payload_bytes"] == 0
    assert ck.accounting()["exchange_elided"] is True
    single = _single(model, capacity=1 << 14, max_frontier=1 << 8)
    assert np.array_equal(ck.discovered_fingerprints(),
                          single.discovered_fingerprints())


def test_traced_forced_bucket_retry_four_shards():
    """``test_tpu_sharded.py:235-245``: traced, ``bucket_slack=1`` trips
    flag 32 before the insert, the wave re-runs at the next slack rung,
    and the set is the single card's."""
    model = TwoPhaseSys(rm_count=4)
    fps = _single(model, capacity=1 << 14, max_frontier=1 << 7).discovered_fingerprints()
    ck = _port(model.checker(), 4, capacity=1 << 14, chunk_size=1 << 7,
               bucket_slack=1, trace=True)
    assert ck.unique_state_count() == 1568
    assert np.array_equal(ck.discovered_fingerprints(), fps)
    assert ck.accounting()["bucket_retries"] >= 1
