"""The port's kernel modules against the JAX package.

On the CPU every wrapper runs its plain-torch twin, and the twins are held
bit for bit against the JAX functions on the same inputs, made with numpy
from a seed.  ``test_torch_device.py`` holds the CUDA kernels against the
twins on the card.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stateright_tpu.models.twophase import TwoPhaseSys as JaxTwoPhaseSys  # noqa: E402
from stateright_tpu.ops.device_fp import _remap_pair as jax_remap_pair  # noqa: E402
from stateright_tpu.ops.device_fp import device_fp64 as jax_device_fp64  # noqa: E402
from stateright_tpu.ops.fingerprint import M64, _remap_fp, fp64_words  # noqa: E402
from stateright_tpu.parallel import hashset as jax_hashset  # noqa: E402
from stateright_tpu.parallel.wave_common import compact as jax_compact  # noqa: E402
from stateright_tpu_torch.models.twophase import TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.ops import fingerprint as port_fingerprint  # noqa: E402
from stateright_tpu_torch.ops.device_fp import _remap_pair, device_fp64  # noqa: E402
from stateright_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32  # noqa: E402
from stateright_tpu_torch.parallel.hashset import (  # noqa: E402
    HashSet, compact_valid, insert_batch_claim, unique_buffer_size,
)
from stateright_tpu_torch.parallel.wave_common import compact  # noqa: E402


def _t(a):
    return from_numpy_u32(a, "cpu")


def _keys(hi, lo):
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        lo
    ).astype(np.uint64)


# --- K1: device_fp64 ---------------------------------------------------------


@pytest.mark.parametrize("width", [1, 2, 5, 42])
def test_device_fp64_matches_jax_and_host(width):
    rng = np.random.default_rng(100 + width)
    words = rng.integers(0, 2**32, size=(2000, width), dtype=np.uint32)
    words[0] = 0
    words[1] = 0xFFFFFFFF
    hi, lo = device_fp64(_t(words))
    jhi, jlo = jax_device_fp64(jnp.asarray(words))
    assert (to_numpy_u32(hi) == np.asarray(jhi)).all()
    assert (to_numpy_u32(lo) == np.asarray(jlo)).all()
    got = _keys(to_numpy_u32(hi), to_numpy_u32(lo))
    want = [fp64_words(r.tolist()) for r in words]
    assert got.tolist() == want
    # The port's host hash is the JAX package's, word for word.
    assert [port_fingerprint.fp64_words(r.tolist()) for r in words[:50]] == want[:50]


def test_reserved_fingerprints_remapped():
    """The cases of test_fingerprint.py::test_reserved_fingerprints_remapped,
    through the port's remap (int64 lanes) and the JAX one."""
    ones = 0xFFFFFFFF
    cases = [(0, 0), (ones, ones), (ones, 0), (0, ones), (7, 9)]
    h1 = torch.tensor([c[0] for c in cases], dtype=torch.int64)
    h2 = torch.tensor([c[1] for c in cases], dtype=torch.int64)
    r1, r2 = _remap_pair(h1, h2)
    got = [(int(a) << 32) | int(b) for a, b in zip(r1, r2)]
    want = [_remap_fp((c[0] << 32) | c[1]) for c in cases]
    assert got == want
    j1, j2 = jax_remap_pair(
        jnp.asarray(np.array([c[0] for c in cases], np.uint32)),
        jnp.asarray(np.array([c[1] for c in cases], np.uint32)),
    )
    assert got == [(int(a) << 32) | int(b) for a, b in zip(j1, j2)]
    assert port_fingerprint._remap_fp(0) == 1
    assert port_fingerprint._remap_fp(M64) == M64 - 1


# --- K3: compact / compact_valid ---------------------------------------------


def test_compact_matches_jax_at_and_past_the_buffer():
    rng = np.random.default_rng(7)
    b = 5000
    mask = rng.random(b) < 0.3
    n_valid = int(mask.sum())
    for size in (n_valid - 1, n_valid, n_valid + 1, 64, b):
        idx, count = compact(torch.from_numpy(mask), size)
        lanes = jax_compact(jnp.asarray(mask), jnp.arange(b, dtype=jnp.uint32), size)
        assert (to_numpy_u32(idx) == np.asarray(lanes)).all()
        assert int(count) == n_valid
    empty, count = compact(torch.zeros(0, dtype=torch.bool), 4)
    assert int(count) == 0 and empty.tolist() == [0, 0, 0, 0]


@pytest.mark.parametrize("extra", [0, 1])
def test_compact_valid_overflow_edge_matches_jax(extra):
    """The valid-lane criterion of hashset.py:206-217: exactly full at
    ``v_sz`` valid lanes, tripped at ``v_sz + 1``."""
    rng = np.random.default_rng(11 + extra)
    b, dd = 40_000, 4
    v_sz = unique_buffer_size(b, dd)
    assert v_sz == jax_hashset.unique_buffer_size(b, dd) == 1 << 14
    valid = np.zeros(b, bool)
    valid[rng.choice(b, v_sz + extra, replace=False)] = True
    hi = rng.integers(0, 2**32, size=b, dtype=np.uint32)
    lo = rng.integers(0, 2**32, size=b, dtype=np.uint32)
    got = compact_valid(_t(hi), _t(lo), torch.from_numpy(valid), dd)
    want = jax_hashset.compact_valid(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), dd
    )
    for g, w in zip(got[:3], want[:3]):
        assert (to_numpy_u32(g) == np.asarray(w)).all()
    assert (got[3].numpy() == np.asarray(want[3])).all()
    assert int(got[4]) == v_sz + extra
    assert bool(got[4] > v_sz) == bool(want[4]) == bool(extra)


# --- K4: insert_batch_claim --------------------------------------------------


def test_insert_batch_claim_matches_jax():
    """Batches with in-batch duplicates, keys already present from earlier
    batches and words past 2**31: the same new lanes, the same key set and
    the same probe_ok as the JAX claim insert."""
    rng = np.random.default_rng(3)
    cap = 1 << 12
    jt = jax_hashset.make_hashset(cap)
    pt = HashSet.empty(cap, "cpu")
    for _ in range(5):
        keys = rng.integers(1, 2**13, size=600, dtype=np.uint64)
        hi = (keys >> np.uint64(32)).astype(np.uint32)
        hi |= rng.integers(0, 2, size=600, dtype=np.uint32) << np.uint32(31)
        lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        active = rng.random(600) < 0.9
        jt, _slot, jnew, _origin, _act, jok, _ovf = jax_hashset.insert_batch_claim(
            jt, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(active)
        )
        new, ok = insert_batch_claim(pt, _t(hi), _t(lo), torch.from_numpy(active))
        assert (new.numpy() == np.asarray(jnew)).all()
        assert bool(ok) == bool(jok) is True
        jkeys = set(_keys(jt.key_hi, jt.key_lo).tolist()) - {0}
        khi, klo = pt.planes()
        assert set(_keys(khi, klo).tolist()) - {0} == jkeys
    # Keys sit on their own probe runs: the planes serve as a JAX table.
    round_trip = HashSet.from_planes(*pt.planes(), "cpu")
    assert torch.equal(round_trip.keys, pt.keys)


def test_slot_layout_round_trips_the_jax_planes():
    """One 16-byte ``{key, tag}`` slot a table entry: a JAX table's
    ``key_hi``/``key_lo`` planes adopted slot for slot into the key words
    (tags zero), given back bit-equal by ``planes()``; the key words are a
    view of the slots, and the port's inserts into the adopted table keep
    the JAX insert's key set and new lanes."""
    rng = np.random.default_rng(18)
    cap = 1 << 10
    jt = jax_hashset.make_hashset(cap)
    hi = rng.integers(0, 2**32, size=300, dtype=np.uint32)
    lo = rng.integers(1, 2**32, size=300, dtype=np.uint32)
    jt, *_ = jax_hashset.insert_batch_claim(
        jt, jnp.asarray(hi), jnp.asarray(lo), jnp.ones(300, bool))
    table = HashSet.from_planes(np.asarray(jt.key_hi), np.asarray(jt.key_lo), "cpu")
    assert table.slots.shape == (cap, 2) and table.slots.dtype == torch.int64
    assert table.slots.is_contiguous() and table.slots.element_size() * 2 == 16
    assert table.keys.data_ptr() == table.slots.data_ptr()
    assert not bool(table.tags.any())
    want = _keys(jt.key_hi, jt.key_lo).view(np.int64)
    assert np.array_equal(table.keys.numpy(), want)
    khi, klo = table.planes()
    assert np.array_equal(khi, np.asarray(jt.key_hi))
    assert np.array_equal(klo, np.asarray(jt.key_lo))
    # Writing the key view writes the table.
    table.keys[0] = 7
    assert int(table.slots[0, 0]) == 7 and table.capacity == cap
    table.keys[0] = int(want[0])
    # More keys, half of them present: the same answer as the JAX insert.
    more_hi = np.concatenate([hi[:50], rng.integers(0, 2**32, size=50, dtype=np.uint32)])
    more_lo = np.concatenate([lo[:50], rng.integers(1, 2**32, size=50, dtype=np.uint32)])
    jt, _slot, jnew, *_ = jax_hashset.insert_batch_claim(
        jt, jnp.asarray(more_hi), jnp.asarray(more_lo), jnp.ones(100, bool))
    new, ok = insert_batch_claim(table, _t(more_hi), _t(more_lo),
                                 torch.ones(100, dtype=torch.bool))
    assert bool(ok) and np.array_equal(new.numpy(), np.asarray(jnew))
    khi, klo = table.planes()
    assert set(_keys(khi, klo).tolist()) == set(_keys(jt.key_hi, jt.key_lo).tolist())


def test_insert_batch_claim_full_table_fails_probe_like_jax():
    rng = np.random.default_rng(5)
    hi = rng.integers(0, 2**32, size=24, dtype=np.uint32)
    lo = rng.integers(1, 2**32, size=24, dtype=np.uint32)
    active = np.ones(24, bool)
    *_, jok, _ = jax_hashset.insert_batch_claim(
        jax_hashset.make_hashset(16), jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(active),
    )
    _new, ok = insert_batch_claim(
        HashSet.empty(16, "cpu"), _t(hi), _t(lo), torch.from_numpy(active)
    )
    assert bool(ok) == bool(jok) is False


# --- K2: the 2pc step --------------------------------------------------------


def _reachable_rows(n):
    model = TwoPhaseSys(rm_count=n)
    cm = model.compiled()
    seen = set(model.init_states())
    frontier = list(seen)
    while frontier:
        nxt = []
        for s in frontier:
            for t in model.next_states(s):
                if t not in seen:
                    seen.add(t)
                    nxt.append(t)
        frontier = nxt
    return np.stack([cm.encode(s) for s in seen])


def _random_rows(rng, n, count):
    rm = rng.integers(0, 4, size=(count, n), dtype=np.uint64)
    w0 = (rm << (2 * np.arange(n, dtype=np.uint64))).sum(1)
    w0 |= rng.integers(0, 3, size=count, dtype=np.uint64) << np.uint64(24)
    w1 = rng.integers(0, 1 << (2 * n + 2), size=count, dtype=np.uint64)
    return np.stack([w0, w1], 1).astype(np.uint32)


@pytest.mark.parametrize("n", [3, 10])
def test_twophase_step_and_conds_match_jax(n):
    rows = (
        _reachable_rows(3) if n == 3
        else _random_rows(np.random.default_rng(9), 10, 4000)
    )
    if n == 3:
        assert rows.shape == (288, 2)
    jcm = JaxTwoPhaseSys(rm_count=n).compiled()
    jn, jv = jax.vmap(jcm.step)(jnp.asarray(rows))
    jc = jax.vmap(jcm.property_conds)(jnp.asarray(rows))
    cm = TwoPhaseSys(rm_count=n).compiled()
    nexts, valid, conds, flag = cm.expand(_t(rows))
    assert flag is None and cm.max_actions == 2 + 5 * n
    assert (to_numpy_u32(nexts) == np.asarray(jn)).all()
    assert (valid.numpy() == np.asarray(jv)).all()
    assert (conds.numpy() == np.asarray(jc)).all()
    assert torch.equal(cm.step(_t(rows))[0], nexts)
    assert torch.equal(cm.property_conds(_t(rows)), conds)
    # The packed codec is the JAX package's.
    for r in rows[:64]:
        assert (cm.encode(cm.decode(r)) == r).all()
        assert (jcm.encode(jcm.decode(r)) == r).all()
