"""The port's sorted dedup fallback against the JAX package, on the CPU.

``prededup`` (K12 + K3 on the card, its plain-torch twin here),
``insert_batch_compact``, ``insert_batch`` and ``compact_valid(_indices)``
with their ``sort_lanes`` rung against the JAX functions on seeded numpy
batches with the hazards of the sorted path: keys with hi >= 2**31 (an
unsigned order the int64 key word reverses), the all-ones key on an active
lane (JAX's sentinel, never a representative), all-duplicate batches,
batches with no active lane and sizes that are no power of two.  Then the
flag-4 rules of ``wave_loop.py`` and the spawn clamp against JAX's, and the
engine's fallback, bit-equal to the JAX engine at the same arguments.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stateright_tpu.models.twophase import TwoPhaseSys as JaxTwoPhaseSys  # noqa: E402
from stateright_tpu.parallel import hashset as jhs  # noqa: E402
from stateright_tpu.parallel import wave_loop as jwl  # noqa: E402
from stateright_tpu.parallel import wavefront as jwf  # noqa: E402
from stateright_tpu_torch.models.twophase import TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32  # noqa: E402
from stateright_tpu_torch.parallel import hashset as hs  # noqa: E402
from stateright_tpu_torch.parallel import wave_loop as wl  # noqa: E402
from stateright_tpu_torch.parallel import wavefront  # noqa: E402


def _t(a):
    return from_numpy_u32(a, "cpu")


def _split(vals):
    vals = np.asarray(vals, np.uint64)
    return (vals >> np.uint64(32)).astype(np.uint32), vals.astype(np.uint32)


def _batch(seed, b, pool, active_p=0.7, high=True, pool_seed=None):
    """``b`` keys drawn from a pool of ``pool`` distinct keys (duplicates;
    the pool made from ``pool_seed``, by default ``seed``), half of them
    with hi >= 2**31, one active all-ones key, and inactive lanes at
    ``1 - active_p``."""
    rng = np.random.default_rng(seed)
    keys = np.random.default_rng(
        seed if pool_seed is None else pool_seed
    ).integers(1, 1 << 63, size=pool, dtype=np.uint64)
    if high:
        keys[: pool // 2] |= np.uint64(1 << 63)
    vals = keys[rng.integers(0, pool, size=b)]
    vals[b // 3] = np.uint64(0xFFFFFFFFFFFFFFFF)
    active = rng.random(b) < active_p
    active[b // 3] = True
    return _split(vals), active


def _same_prededup(hi, lo, active, dd, sort_lanes=None):
    got = hs.prededup(_t(hi), _t(lo), torch.from_numpy(active), dd, sort_lanes)
    want = jhs.prededup(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(active), dd,
        sort_lanes=sort_lanes,
    )
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(to_numpy_u32(g), np.asarray(w))
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    assert bool(got[4]) == bool(want[4])
    return got


@pytest.mark.parametrize("b,pool,dd", [
    (1000, 300, 1), (4099, 4099, 2), (20_000, 5000, 4), (37, 1, 1),
])
def test_prededup_matches_jax(b, pool, dd):
    (hi, lo), active = _batch(b + pool, b, pool)
    got = _same_prededup(hi, lo, active, dd)
    n = int(got[3].sum())
    keys = (to_numpy_u32(got[0])[:n].astype(np.uint64) << np.uint64(32)) | to_numpy_u32(
        got[1])[:n].astype(np.uint64)
    assert np.all(keys[1:] > keys[:-1])  # strictly increasing, unsigned
    assert np.uint64(0xFFFFFFFFFFFFFFFF) not in keys


@pytest.mark.parametrize("count,dd", [
    (0, 1), (1, 1), (5000, 1), (2048 + 777, 1), (2048 + 777, 4), (6000, 1),
])
def test_prededup_prefix_matches_jax(count, dd):
    """K12's prefix entry (its twin here) sorts the first ``count`` lanes
    (clamped to the batch): JAX ``prededup`` over the mask of that
    prefix, bit for bit -- no lane, one lane, the whole batch, a count
    ending inside K12's 2,048-lane tile, one past the batch; keys with hi
    >= 2**31 and an active all-ones key inside the prefix."""
    b = 5000
    (hi, lo), _ = _batch(count + 17, b, 1500)
    active = np.arange(b) < count
    assert active[: min(count, b)].all() and not active[count:].any()
    want = jhs.prededup(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(active), dd)
    got = hs.prededup_prefix(_t(hi), _t(lo), torch.tensor(count), dd)
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(to_numpy_u32(g), np.asarray(w))
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    assert bool(got[4]) == bool(want[4])
    if count > b // 3:  # the all-ones lane is active and represents nothing
        assert hi[b // 3] == lo[b // 3] == 0xFFFFFFFF
        assert b // 3 not in got[2][: int(got[3].sum())].tolist()


def test_prededup_no_active_lane_and_all_duplicates():
    (hi, lo), _ = _batch(5, 513, 40)
    _same_prededup(hi, lo, np.zeros(513, bool), 1)
    same_hi = np.full(513, 0x80000001, np.uint32)
    same_lo = np.full(513, 7, np.uint32)
    active = np.ones(513, bool)
    active[:5] = False
    got = _same_prededup(same_hi, same_lo, active, 1)
    assert int(got[3].sum()) == 1 and int(got[2][0]) == 5


def test_prededup_overflow_boundary_exact_and_plus_one():
    """Exactly u distinct keys (each on several lanes) commit; u + 1 trip --
    the distinct-representative criterion of hashset.py:232."""
    b, dd = 1 << 15, 4
    u = hs.unique_buffer_size(b, dd)
    vals = np.repeat(np.arange(1, u + 1, dtype=np.uint64), b // u)
    active = np.ones(b, bool)
    assert not bool(_same_prededup(*_split(vals), active, dd)[4])
    vals[-1] = np.uint64(u + 1)
    assert bool(_same_prededup(*_split(vals), active, dd)[4])


def test_compact_valid_rung_boundary_matches_jax():
    """A rung shrinks both compactions; exactly full at the rung, tripped
    one past it, on valid lanes (not distinct keys)."""
    b, rung = 1 << 12, 256
    hi, lo = _split(np.ones(b, np.uint64))
    for extra in (0, 1):
        valid = np.arange(b) < rung + extra
        got = hs.compact_valid(_t(hi), _t(lo), torch.from_numpy(valid), 1, rung)
        want = jhs.compact_valid(
            jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), 1, sort_lanes=rung
        )
        assert got[0].shape[0] == rung == want[0].shape[0]
        for g, w in zip(got[:3], want[:3]):
            assert np.array_equal(to_numpy_u32(g), np.asarray(w))
        assert bool(got[4] > rung) == bool(want[4]) == bool(extra)
        i_orig, i_act, n_valid = hs.compact_valid_indices(
            torch.from_numpy(valid), 1, sort_lanes=rung
        )
        j_orig, j_act, j_n, j_ovf = jhs.compact_valid_indices(
            jnp.asarray(valid), 1, sort_lanes=rung
        )
        assert np.array_equal(to_numpy_u32(i_orig), np.asarray(j_orig))
        assert np.array_equal(i_act.numpy(), np.asarray(j_act))
        assert int(n_valid) == int(j_n)
        _same_prededup(hi, lo, valid, 1, sort_lanes=rung)


@pytest.mark.parametrize("dd,sort_lanes", [(1, None), (2, None), (1, 512)])
def test_insert_batch_compact_matches_jax(dd, sort_lanes):
    """Two batches into one table: keys already present from the first,
    in-batch duplicates, words past 2**31.  The same new representatives,
    origins, probe verdict and overflow, and the same key set."""
    cap = 1 << 12
    table = hs.HashSet.empty(cap, "cpu")
    jtable = jhs.make_hashset(cap)
    for seed, pool in ((1, 400), (2, 800)):
        # The second batch draws from a pool twice the first's: half its
        # keys are already present.
        (hi, lo), active = _batch(seed, 3000, pool, pool_seed=0)
        got = hs.insert_batch_compact(
            table, _t(hi), _t(lo), torch.from_numpy(active), dd, sort_lanes
        )
        jtable, _slot, *want = jhs.insert_batch_compact(
            jtable, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(active), dd,
            sort_lanes=sort_lanes,
        )
        assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
        assert np.array_equal(to_numpy_u32(got[1]), np.asarray(want[1]))
        assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
        assert [bool(x) for x in got[3:]] == [bool(x) for x in want[3:]]
        assert 0 < int(got[0].sum()) < int(got[2].sum()) or seed == 1
        jkeys = hs.HashSet.from_planes(np.asarray(jtable.key_hi), np.asarray(jtable.key_lo), "cpu")
        assert hs.keys_equal(table, jkeys)


def test_insert_batch_matches_jax():
    cap = 1 << 11
    (hi, lo), active = _batch(9, 1500, 200)
    table = hs.HashSet.empty(cap, "cpu")
    got = hs.insert_batch(table, _t(hi), _t(lo), torch.from_numpy(active), 1)
    _jt, _slot, is_new, ok, ovf = jhs.insert_batch(
        jhs.make_hashset(cap), jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(active), 1
    )
    assert np.array_equal(got[0].numpy(), np.asarray(is_new))
    assert bool(got[1]) == bool(ok) and bool(got[2]) == bool(ovf)


def test_flag4_rules_match_jax():
    for w in (1, 2, 42, 58, 77, 26_000):
        assert wavefront.max_safe_unique_lanes(w) == jwf.max_safe_unique_lanes(w)
    for req in (1, 255, 256, 257, 1000, 1 << 20):
        assert wl.clamp_sort_lanes(req) == jwl.clamp_sort_lanes(req)
    for cur, full in ((256, 1 << 14), (1 << 13, 1 << 14), (1 << 14, 1 << 14), (300, 1000)):
        assert wl.next_sort_lanes(cur, full) == jwl.next_sort_lanes(cur, full)
    for a, w, chunk, dd in ((52, 2, 1 << 16, 8), (32, 42, 1 << 16, 4), (36, 58, 1 << 12, 8),
                            (300, 2, 1 << 12, 8), (52, 2, 1 << 16, 1)):
        def lanes_of(c, d, a=a):
            return hs.unique_buffer_size(c * a, d)
        cap = wavefront.max_safe_unique_lanes(w)
        assert wl.relax_dedup_geometry(chunk, dd, lanes_of, cap, "max_frontier") == (
            jwl.relax_dedup_geometry(chunk, dd, lanes_of, cap, "max_frontier"))
    full = hs.unique_buffer_size((1 << 16) * 52, 8)
    relaxed = wl.relax_dedup_geometry(
        1 << 16, 8, lambda c, d: hs.unique_buffer_size(c * 52, d),
        wavefront.max_safe_unique_lanes(2), "max_frontier")
    assert full == 425_984 and relaxed == (
        1, 8192, "dedup_factor=1; max_frontier=32768; max_frontier=16384; max_frontier=8192")


def _logs(checker, path, w=2):
    checker.save_snapshot(str(path))
    with np.load(path) as snap:
        tail = int(snap["tail"])
        return {
            "rows": snap["rows"][: tail * w].copy(),
            "parent": snap["parent"][:tail].copy(),
            "ebits": snap["ebits"][:tail].copy(),
        }


def test_forced_fallback_to_sort_rung_mid_run_matches_jax(tmp_path):
    """``sortless=True`` with a pinned 256-lane rung: the first wave past
    the rung falls back to the sorted path (``sortless=0``), the rung then
    climbs -- and the row log is the JAX engine's at the same arguments
    (tests/test_sortless.py::test_forced_fallback_to_sort_rung_mid_run)."""
    kw = dict(capacity=1 << 14, max_frontier=1 << 9, sortless=True, sort_lanes=256)
    jck = JaxTwoPhaseSys(rm_count=4).checker().spawn_tpu(
        device=jax.devices("cpu")[0], **kw).join()
    port = TwoPhaseSys(rm_count=4).checker().spawn_gpu(device="cpu", **kw).join()
    assert port._grow_notes[0] == "sortless=0" and not port._sortless
    assert any(n.startswith("sort_lanes=") for n in port._grow_notes[1:])
    assert (port.unique_state_count(), port.state_count(), port.max_depth()) == (
        jck.unique_state_count(), jck.state_count(), jck.max_depth()) == (1568, 8258, 14)
    got, want = _logs(port, tmp_path / "p.npz"), _logs(jck, tmp_path / "j.npz")
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert np.array_equal(port.discovered_fingerprints(), jck.discovered_fingerprints())
    assert sorted(port.discoveries()) == sorted(jck.discoveries())


def test_dd1_claim_log_is_the_same_at_a_clamped_chunk(tmp_path, monkeypatch):
    """At dedup_factor=1 on the claim path the port keeps the caller's
    chunk: the log does not depend on it.  With the band cut to 65,536
    lanes, 2pc rm=6 at dd=8 is clamped from 8,192 states a chunk to 2,048;
    the dd=1 runs at both chunks write the same log."""
    monkeypatch.setattr(wavefront, "_MAX_UNIQUE_BUFFER", 1 << 16)
    geo = dict(capacity=1 << 17, max_frontier=1 << 13)
    clamped = TwoPhaseSys(rm_count=6).checker().spawn_gpu(device="cpu", **geo).join()
    assert clamped._max_frontier == 2048
    wide = TwoPhaseSys(rm_count=6).checker().spawn_gpu(
        device="cpu", dedup_factor=1, waves_per_call=1, **geo).join()
    narrow = TwoPhaseSys(rm_count=6).checker().spawn_gpu(
        device="cpu", dedup_factor=1, waves_per_call=1, capacity=1 << 17,
        max_frontier=2048).join()
    assert wide._max_frontier == 1 << 13 and narrow.waves() > wide.waves()
    a, b = _logs(wide, tmp_path / "w.npz"), _logs(narrow, tmp_path / "n.npz")
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert wide.unique_state_count() == 50_816
