"""The port's symmetry reduction against the JAX package, on the CPU.

K15's twin (``canonicalize_rows_plain``) against the JAX ``canonicalize``
(vmapped on the CPU backend) over the reachable 2pc rows at rm=3/4, over
seeded rows of every bit pattern at rm=5/12 and over synthetic specs (Id
remap, word stride, sentinels, a 32-bit key); ``validate_spec`` refuses
what the JAX one refuses; ``symmetry().spawn_gpu(device="cpu")`` on 2pc
rm=3/4/5 is bit-equal to the JAX engine's ``symmetry().spawn_tpu`` (80 /
166 / 314 orbits: row log, parents, ebits, counts, discoveries, paths and
canonical fingerprints); a model without a canonicalization is refused at
spawn; the snapshot key keeps symmetric and plain runs apart both ways;
and a JAX symmetric snapshot resumes in the port.
"""

from collections import deque

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stateright_tpu.models.twophase import TwoPhaseSys as JTwoPhaseSys  # noqa: E402
from stateright_tpu.parallel import canon as jcanon  # noqa: E402
from stateright_tpu_torch.actor import Network  # noqa: E402
from stateright_tpu_torch.models.paxos import PaxosModelCfg  # noqa: E402
from stateright_tpu_torch.models.twophase import TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32  # noqa: E402
from stateright_tpu_torch.parallel import canon  # noqa: E402
from stateright_tpu_torch.parallel.compiled import CompiledModel  # noqa: E402

CANON_GOLDEN = {3: 80, 4: 166, 5: 314}
GEOMETRY = dict(capacity=1 << 14, max_frontier=1 << 9)


def _jax_spec(spec):
    """The port's spec as the JAX package's (same fields, same order)."""
    def conv(f):
        return jcanon.CanonField(*f)

    return jcanon.CanonSpec(
        spec.n, tuple(conv(f) for f in spec.fields),
        tuple(conv(g) for g in spec.id_fields),
    )


def _jax_canon(spec, rows):
    js = _jax_spec(spec)
    return np.asarray(
        jax.jit(jax.vmap(lambda r: jcanon.canonicalize(js, r)))(jnp.asarray(rows))
    )


def _twin(spec, rows):
    return to_numpy_u32(canon.canonicalize_rows(spec, from_numpy_u32(rows, "cpu")))


def _reachable_rows(rm):
    model = TwoPhaseSys(rm_count=rm)
    cm = model.compiled()
    seen, q = set(), deque(model.init_states())
    while q:
        s = q.popleft()
        if s in seen:
            continue
        seen.add(s)
        q.extend(t for t in model.next_states(s) if t not in seen)
    return cm, np.stack([cm.encode(s) for s in seen]).astype(np.uint32)


@pytest.mark.parametrize("rm", [3, 4])
def test_twin_matches_jax_on_reachable_2pc_rows(rm):
    cm, rows = _reachable_rows(rm)
    spec = cm.canon_spec()
    assert _jax_spec(spec) == JTwoPhaseSys(rm_count=rm).compiled().canon_spec()
    got = _twin(spec, rows)
    assert np.array_equal(got, _jax_canon(spec, rows))
    assert np.array_equal(_twin(spec, got), got)  # idempotent
    assert len({tuple(r) for r in got.tolist()}) == CANON_GOLDEN[rm]


@pytest.mark.parametrize("rm", [5, 12])
def test_twin_matches_jax_on_seeded_rows(rm):
    """Words of every bit pattern, not only reachable ones."""
    rng = np.random.default_rng(rm)
    rows = rng.integers(0, 1 << 32, size=(4096, 2), dtype=np.uint32)
    rows[:8] = [0xFFFFFFFF, 0x80000000]
    spec = TwoPhaseSys(rm_count=rm).compiled().canon_spec()
    got = _twin(spec, rows)
    assert np.array_equal(got, _jax_canon(spec, rows))
    assert np.array_equal(_twin(spec, got), got)


F = canon.field
SYNTHETIC = {
    # Three 8-bit keys in word 0, a per-record 2-bit Id, a global Id.
    "id_remap": (canon.CanonSpec(
        3, (F(0, 0, 8), F(1, 0, 2, is_id=True)), (F(2, 0, 4),)), 3, 1 << 8),
    # Word-aligned records, a 32-bit key, an Id field, sentinel values.
    "word_stride": (canon.CanonSpec(
        4, (F(1, 0, 32, word_stride=2), F(2, 3, 5, word_stride=2),
            F(0, 0, 3, is_id=True)), (F(0, 16, 3), F(9, 0, 8))), 10, 1 << 32),
    # Keys past 64 bits in all: the two-word key.
    "wide_keys": (canon.CanonSpec(
        6, (F(0, 0, 32, word_stride=1), F(6, 0, 32, word_stride=1),
            F(12, 0, 32, word_stride=1)), ()), 18, 4),
    # Sixteen records, the kernel's cap, Id fields as wide as indices.
    "sixteen": (canon.CanonSpec(
        16, (F(0, 0, 2), F(1, 0, 2), F(2, 0, 1, bit_stride=2),
             F(3, 0, 4, word_stride=1, is_id=True)),
        (F(19, 0, 5), F(19, 27, 5))), 20, 20),
    # Only an Id field: the identity permutation, the ids unchanged.
    "ids_only": (canon.CanonSpec(
        5, (F(0, 0, 3, is_id=True),), (F(1, 0, 3),)), 2, 1 << 32),
}


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_twin_matches_jax_on_synthetic_specs(name):
    spec, width, high = SYNTHETIC[name]
    canon.validate_spec(spec, width)
    rng = np.random.default_rng(len(name))
    rows = rng.integers(0, high, size=(2048, width), dtype=np.uint64).astype(np.uint32)
    got = _twin(spec, rows)
    assert np.array_equal(got, _jax_canon(spec, rows))
    assert np.array_equal(_twin(spec, got), got)


def test_id_remap_and_sentinel():
    """Keys (30, 10, 20) sort to (10, 20, 30): old -> new is 0->2, 1->0,
    2->1; per-record and global ids follow it, and a global id >= n
    passes unchanged (the JAX package's own worked example)."""
    spec = SYNTHETIC["id_remap"][0]
    keys = 30 | (10 << 8) | (20 << 16)
    ids = 0 | (2 << 2) | (1 << 4)
    rows = np.array([[keys, ids, 2], [keys, ids, 9]], np.uint32)
    got = _twin(spec, rows)
    assert got[0].tolist() == [10 | (20 << 8) | (30 << 16), 1 | (0 << 2) | (2 << 4), 1]
    assert got[1][2] == 9


def test_empty_spec_is_the_identity():
    rows = torch.arange(8, dtype=torch.int32).view(8, 1)
    assert canon.canonicalize_rows(canon.CanonSpec(n=0), rows) is rows
    assert canon.canonicalize_rows(canon.CanonSpec(n=1, fields=(F(0, 0, 2),)), rows) is rows


MALFORMED = [
    (canon.CanonSpec(n=2, fields=(F(5, 0, 2),)), 2, None, "outside"),
    (canon.CanonSpec(n=12, fields=(F(0, 16, 2),)), 2, None, "exceed"),
    (canon.CanonSpec(n=5, id_fields=(F(0, 0, 2),)), 2, None, "too narrow"),
    (canon.CanonSpec(n=2, fields=(F(1, 0, 4),)), 2, 1, "identity prefix"),
    (canon.CanonSpec(n=2, fields=(F(0, 0, 4, bit_stride=2),)), 2, None, "overlap"),
    (canon.CanonSpec(n=2, fields=(F(0, 0, 33),)), 2, None, "width"),
    (canon.CanonSpec(n=-1), 2, None, "n must be"),
]


@pytest.mark.parametrize("case", range(len(MALFORMED)))
def test_validate_spec_refuses_what_jax_refuses(case):
    spec, width, fpw, match = MALFORMED[case]
    with pytest.raises(ValueError, match=match):
        canon.validate_spec(spec, width, fp_words=fpw)
    with pytest.raises(ValueError, match=match):
        jcanon.validate_spec(_jax_spec(spec), width, fp_words=fpw)


def test_validate_spec_accepts_what_jax_accepts():
    """Key fields past the identity prefix are fine when the whole row is
    the identity; Id fields past it are fine always."""
    for spec, fpw in (
        (canon.CanonSpec(n=2, fields=(F(1, 0, 4),)), None),
        (canon.CanonSpec(n=2, fields=(F(0, 0, 4),), id_fields=(F(1, 0, 4),)), 1),
    ):
        canon.validate_spec(spec, 2, fp_words=fpw)
        jcanon.validate_spec(_jax_spec(spec), 2, fp_words=fpw)


def test_make_canon_resolution_and_caps():
    assert canon.make_canon(TwoPhaseSys(rm_count=3).compiled()) is not None

    class NoCanon(CompiledModel):
        state_width = 1
        max_actions = 1

    assert canon.make_canon(NoCanon()) is None

    class Custom(CompiledModel):
        state_width = 1
        max_actions = 1

        def canon_rows(self, rows):
            return rows

    cm = Custom()
    assert canon.make_canon(cm) == cm.canon_rows
    with pytest.raises(ValueError, match="at most 16 records"):
        canon.check_caps(canon.CanonSpec(n=17, fields=(F(0, 0, 1),)))


def _logs(checker, path, w=2):
    checker.save_snapshot(str(path))
    with np.load(path) as snap:
        tail = int(snap["tail"])
        return [snap[k][: tail * m].copy() for k, m in
                (("rows", w), ("parent", 1), ("ebits", 1))]


@pytest.mark.parametrize("rm,max_frontier", [(3, 1 << 9), (4, 1 << 9), (5, 1 << 13), (5, 1 << 6)])
def test_sym_engine_matches_jax(rm, max_frontier, tmp_path):
    geometry = dict(capacity=1 << 14, max_frontier=max_frontier)
    jck = JTwoPhaseSys(rm_count=rm).checker().symmetry().spawn_tpu(
        device=jax.devices("cpu")[0], **geometry).join()
    port = TwoPhaseSys(rm_count=rm).checker().symmetry().spawn_gpu(
        device="cpu", **geometry).join()
    got = (port.unique_state_count(), port.state_count(), port.max_depth())
    assert got == (jck.unique_state_count(), jck.state_count(), jck.max_depth())
    assert got[0] == CANON_GOLDEN[rm]
    for a, b in zip(_logs(port, tmp_path / "p.npz"), _logs(jck, tmp_path / "j.npz")):
        assert np.array_equal(a, b)
    assert np.array_equal(port.discovered_fingerprints(), jck.discovered_fingerprints())
    jd, pd = jck.discoveries(), port.discoveries()
    assert sorted(pd) == sorted(jd) == ["abort agreement", "commit agreement"]
    for name in jd:
        assert [repr(x) for x in pd[name].into_actions()] == [
            repr(x) for x in jd[name].into_actions()]


def test_symmetry_needs_a_canonicalization():
    model = PaxosModelCfg(2, 3, Network.new_unordered_nonduplicating()).into_model()
    with pytest.raises(ValueError, match="canon"):
        model.checker().symmetry_fn(lambda s: s).spawn_gpu(device="cpu")


def test_sym_and_plain_snapshots_do_not_cross(tmp_path):
    model = TwoPhaseSys(rm_count=3)
    geometry = dict(device="cpu", **GEOMETRY)
    sym, plain = str(tmp_path / "sym.npz"), str(tmp_path / "plain.npz")
    model.checker().symmetry().spawn_gpu(**geometry).join().save_snapshot(sym)
    model.checker().spawn_gpu(**geometry).join().save_snapshot(plain)
    with pytest.raises(ValueError, match="snapshot does not match"):
        model.checker().spawn_gpu(resume_from=sym, **geometry).join()
    with pytest.raises(ValueError, match="snapshot does not match"):
        model.checker().symmetry().spawn_gpu(resume_from=plain, **geometry).join()
    resumed = model.checker().symmetry().spawn_gpu(resume_from=sym, **geometry).join()
    assert resumed.unique_state_count() == CANON_GOLDEN[3]


def test_jax_sym_snapshot_resumes_in_the_port(tmp_path):
    """A JAX symmetric run stopped by target_state_count, resumed by the
    port, ends where a straight JAX symmetric run ends."""
    geometry = dict(capacity=1 << 14, max_frontier=1 << 5)
    partial = JTwoPhaseSys(rm_count=5).checker().symmetry().target_state_count(
        600).spawn_tpu(device=jax.devices("cpu")[0], **geometry).join()
    assert partial.unique_state_count() < CANON_GOLDEN[5]
    snap = tmp_path / "jax_sym.npz"
    partial.save_snapshot(str(snap))
    resumed = TwoPhaseSys(rm_count=5).checker().symmetry().spawn_gpu(
        device="cpu", resume_from=str(snap), **geometry).join()
    straight = JTwoPhaseSys(rm_count=5).checker().symmetry().spawn_tpu(
        device=jax.devices("cpu")[0], **geometry).join()
    assert (resumed.unique_state_count(), resumed.state_count(), resumed.max_depth()) == (
        straight.unique_state_count(), straight.state_count(), straight.max_depth())
    for a, b in zip(_logs(resumed, tmp_path / "r.npz"), _logs(straight, tmp_path / "s.npz")):
        assert np.array_equal(a, b)
    assert sorted(resumed.discoveries()) == sorted(straight.discoveries())
