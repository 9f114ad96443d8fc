"""The port's incremental verification store against the JAX package's, on
the CPU.

``stateright_tpu_torch.incr.incremental_check`` (``device="cpu"``: the
kernels' plain-torch twins) and the JAX package's ``incremental_check``
take the same sequences of requests, each in its own store: the modes,
the reasons (entry ids aside), ``seeded_states``, the counts, the
discovery names and paths, the discovered fingerprints and the journal's
``incr_*`` events must agree.  K21, K2c and K22's twins are held against
the JAX functions on seeded inputs, and the port's spec hash against the
relations the store's modes hang on.  The JAX side of each sequence runs
once per module.  The card's runs are in ``test_torch_device.py``.
"""

import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
from dataclasses import dataclass

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import stateright_tpu.incr as jax_incr  # noqa: E402
import stateright_tpu.models.fixtures as jax_fx  # noqa: E402
from stateright_tpu.actor import Network as JaxNetwork  # noqa: E402
from stateright_tpu.models.paxos import PaxosModelCfg as JaxPaxosModelCfg  # noqa: E402
from stateright_tpu.models.twophase import TwoPhaseSys as JaxTwoPhaseSys  # noqa: E402
from stateright_tpu.runtime.journal import read_journal as jax_read_journal  # noqa: E402
import stateright_tpu_torch.incr as port_incr  # noqa: E402
from stateright_tpu_torch.incr import recheck, spec_hash  # noqa: E402
from stateright_tpu_torch.incr.spec_hash import SpecFingerprint, code_digest  # noqa: E402
from stateright_tpu_torch.incr.store import (  # noqa: E402
    CONSTANT_WIDENING, IDENTICAL, PROPERTY_ONLY, StoreEntry, VerificationStore,
)
import stateright_tpu_torch.models.fixtures as port_fx  # noqa: E402
from stateright_tpu_torch.actor import Network  # noqa: E402
from stateright_tpu_torch.models.paxos import PaxosModelCfg  # noqa: E402
from stateright_tpu_torch.models.raft import RaftModelCfg  # noqa: E402
from stateright_tpu_torch.models.twophase import TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.models.twophase_compiled import twophase_conds_plain  # noqa: E402
from stateright_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32  # noqa: E402
from stateright_tpu_torch.runtime.journal import read_journal  # noqa: E402
from stateright_tpu_torch.tiered.cold_store import ColdStore  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID_KW = dict(capacity=1 << 12, max_frontier=1 << 6)
TP_KW = dict(capacity=1 << 13, max_frontier=1 << 7)
TRAP_KW = dict(capacity=1 << 10, max_frontier=1 << 5)
PX_KW = dict(capacity=1 << 12, max_frontier=1 << 6)
# Journal fields that differ between the packages by construction: times,
# the content-addressed keys (each package hashes its own code) and the
# re-eval's chunk count (4,096 rows a chunk there, 2**20 here).
VOLATILE = ("t", "sec", "spec_key", "entry", "donor", "dispatches")
ENTRY_ID = re.compile(r"\b[0-9a-f]{24}\b")


# --- the two packages behind one interface ------------------------------------


class Pkg:
    """One package's models and entry points: ``jax`` or ``port``."""

    def __init__(self, name):
        self.name = name
        jx = name == "jax"
        self.fx = jax_fx if jx else port_fx
        self.TwoPhaseSys = JaxTwoPhaseSys if jx else TwoPhaseSys
        self.incr = jax_incr if jx else port_incr
        self.read_journal = jax_read_journal if jx else read_journal
        self.kw = {} if jx else {"device": "cpu"}
        self.Network = JaxNetwork if jx else Network
        self.PaxosModelCfg = JaxPaxosModelCfg if jx else PaxosModelCfg

    def spawn(self, builder, **kw):
        if self.name == "jax":
            return builder.spawn_tpu(**kw)
        return builder.spawn_gpu(device="cpu", **kw)

    def slice_conds(self, conds, sl):
        """A variant's conds: a slice of its parent's property vector."""
        return conds[sl] if self.name == "jax" else conds[:, sl].contiguous()


PKGS = {"jax": Pkg("jax"), "port": Pkg("port")}


def _variant(pkg, base, base_cm, props_fn, sl):
    """A ``base`` model with an edited property set, the device conds
    sliced to match: codec and constants as the parent's."""

    class _Compiled(base_cm):
        def property_conds(self, states):
            return pkg.slice_conds(base_cm.property_conds(self, states), sl)

    class _Variant(base):
        def properties(self):
            return props_fn(base, self)

        def compiled(self):
            return _Compiled(self)

    # GridWalk's constants are its dataclass fields.
    return dataclass(frozen=True)(_Variant) if base is pkg.fx.GridWalk else _Variant


def _opaque(pkg):
    """The trap counter with no stable constants declaration."""

    class Opaque(pkg.fx.TrapCounter):
        def compiled(self):
            cm = pkg.fx.TrapCounterCompiled(self)
            cm.spec_constants = lambda: None
            return cm

    return Opaque


def model_of(pkg, kind, *args):
    fx = pkg.fx
    if kind == "grid":
        return fx.GridWalk(bound=args[0])
    if kind == "2pc":
        return pkg.TwoPhaseSys(rm_count=args[0])
    if kind == "edited":
        return fx.TwoPhaseEdited.build(args[0])
    if kind == "trap":
        return fx.TrapCounter(limit=args[0])
    if kind == "trap-eventually-only":
        return _variant(pkg, fx.TrapCounter, fx.TrapCounterCompiled,
                        lambda b, m: b.properties(m)[:2], slice(0, 2))(limit=args[0])
    if kind == "opaque":
        return _opaque(pkg)(limit=args[0])
    if kind == "corner-only":
        return _variant(pkg, fx.GridWalk, fx.GridWalkCompiled,
                        lambda b, m: [b.properties(m)[1]], slice(1, 2))(bound=args[0])
    if kind == "bounds-only":
        return _variant(pkg, fx.GridWalk, fx.GridWalkCompiled,
                        lambda b, m: [b.properties(m)[0]], slice(0, 1))(bound=args[0])
    if kind == "paxos":
        c, max_round = args
        return pkg.PaxosModelCfg(
            client_count=c, server_count=3,
            network=pkg.Network.new_unordered_nonduplicating(),
            max_round=max_round,
        ).into_model()
    raise KeyError(kind)


def builder_of(pkg, step):
    b = model_of(pkg, *step["model"]).checker()
    if step.get("symmetry"):
        b = b.symmetry()
    if step.get("depth"):
        b = b.target_max_depth(step["depth"])
    if step.get("count"):
        b = b.target_state_count(step["count"])
    return b


def S(*model, kw=GRID_KW, **opts):
    """One request of a sequence: the model, the spawn geometry and the
    builder's options (``symmetry``, ``depth``, ``count``, ``reuse``;
    ``plain`` spawns without the store, as a reference run)."""
    return dict(model=model, kw=kw, **opts)


# Each sequence runs in a store of its own: the first test_incr.py's
# modes and its degradation matrix, request by request.
SEQUENCES = {
    # cold, the verdict cache, a geometry-only change, two widenings
    # chained (25 then 64 seeded), a narrowing, a bounds change, a partial
    # run refused by the completeness gate, and a cold reference at 8.
    "grid": [
        S("grid", 4), S("grid", 4),
        S("grid", 4, kw=dict(capacity=1 << 14, max_frontier=1 << 8)),
        S("grid", 7), S("grid", 8), S("grid", 3),
        S("grid", 4, depth=3), S("grid", 6, count=10),
        S("grid", 8, plain=True),
    ],
    # cold, property-only (no wave), the edited spec's own verdict hit, a
    # codec change in the family (rm=4), and the symmetry toggle.
    "twophase": [
        S("2pc", 3, kw=TP_KW), S("edited", 3, kw=TP_KW),
        S("edited", 3, kw=TP_KW), S("2pc", 4, kw=TP_KW),
        S("2pc", 3, kw=TP_KW, symmetry=True),
    ],
    # a stored violation served from the cache, an edit to EVENTUALLY-only
    # properties refused, and a model with no stable constants.
    "trap": [
        S("trap", 5, kw=TRAP_KW), S("trap", 5, kw=TRAP_KW),
        S("trap-eventually-only", 5, kw=TRAP_KW),
        S("opaque", 5, kw=TRAP_KW), S("opaque", 6, kw=TRAP_KW),
    ],
    # paxos c=1 bounded at round 0, widened to unbounded: 1 seeded, 265.
    "paxos": [S("paxos", 1, 0, kw=PX_KW), S("paxos", 1, None, kw=PX_KW)],
    # recording only, a newer sibling with no exhaustiveness witness, a
    # property-only re-check served by the older reusable entry, the
    # witness-less entry's own cache hit, and its widening refused.
    "relatives": [
        S("grid", 4, reuse=False), S("corner-only", 4, reuse=False),
        S("bounds-only", 4), S("corner-only", 4), S("corner-only", 6),
        S("grid", 4, reuse=False),
    ],
}


def _path_fps(model, path):
    return [int(model.fingerprint(s)) for s in path.into_states()]


def _events(pkg, journal):
    """The journal's ``incr_*`` events less what differs by construction,
    and its ``wave`` and ``resume`` counts."""
    out, waves, resumes = [], 0, 0
    for e in pkg.read_journal(journal):
        ev = e.get("event", "")
        waves += ev == "wave"
        resumes += ev == "resume"
        if not ev.startswith("incr_"):
            continue
        rec = {k: v for k, v in e.items() if k not in VOLATILE}
        rec["entry"] = e.get("entry") is not None
        if "reason" in rec:
            rec["reason"] = ENTRY_ID.sub("<entry>", rec["reason"])
        out.append(rec)
    return out, waves, resumes


def run_sequence(pkg, name, root):
    """Run ``SEQUENCES[name]`` through ``pkg`` in a fresh store under
    ``root``; one record a request."""
    store = os.path.join(root, f"{name}-{pkg.name}")
    journal = os.path.join(root, f"{name}-{pkg.name}.jsonl")
    records = []
    for step in SEQUENCES[name]:
        builder = builder_of(pkg, step)
        before = _events(pkg, journal) if os.path.exists(journal) else ([], 0, 0)
        if step.get("plain"):
            ck, info = pkg.spawn(builder, **step["kw"]).join(), {}
        else:
            ck, info = pkg.incr.incremental_check(
                builder, store, engine_kwargs=dict(step["kw"], **pkg.kw),
                journal=journal, reuse=step.get("reuse", True),
            )
        events, waves, resumes = _events(pkg, journal)
        model = builder.model
        records.append(dict(
            mode=info.get("mode"),
            reason=ENTRY_ID.sub("<entry>", info.get("reason", "")),
            entry=info.get("entry") is not None,
            seeded=info.get("seeded_states"),
            counts=(ck.unique_state_count(), ck.state_count(), ck.max_depth()),
            discoveries={n: _path_fps(model, p) for n, p in ck.discoveries().items()},
            classification={n: ck.discovery_classification(n)
                            for n in ck.discoveries()},
            fps=np.asarray(ck.discovered_fingerprints()),
            events=events[len(before[0]):],
            waved=waves > before[1],
            resumed=resumes - before[2],
            checker=ck,
        ))
    return dict(records=records, store=store, journal=journal)


def _runs_of(pkg, tmp_path_factory):
    root = str(tmp_path_factory.mktemp(f"{pkg.name}-stores"))
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = run_sequence(pkg, name, root)
        return cache[name]

    return get


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX side of each sequence, run on first use."""
    return _runs_of(PKGS["jax"], tmp_path_factory)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The port's side of each sequence, run on first use."""
    return _runs_of(PKGS["port"], tmp_path_factory)


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_sequence_matches_jax(name, jax_runs, port_runs):
    want = jax_runs(name)["records"]
    got = port_runs(name)["records"]
    for i, (g, w) in enumerate(zip(got, want)):
        where = f"{name} request {i} {SEQUENCES[name][i]['model']}"
        for key in ("mode", "reason", "entry", "seeded", "counts",
                    "discoveries", "classification", "events", "waved",
                    "resumed"):
            assert g[key] == w[key], (where, key, g[key], w[key])
        assert np.array_equal(g["fps"], w["fps"]), where
    assert len(got) == len(want)


def test_modes_reach_their_results(port_runs):
    """What the sequences must show, on the port's side: each mode where
    the first test_incr.py puts it, the widened runs bit-equal to a cold
    run, the property-only re-check with no wave and its paths a cold
    run's."""
    grid = port_runs("grid")["records"]
    modes = [r["mode"] for r in grid]
    assert modes == ["cold", IDENTICAL, IDENTICAL, CONSTANT_WIDENING,
                     CONSTANT_WIDENING, "cold", "cold", "cold", None]
    assert [grid[3]["seeded"], grid[4]["seeded"]] == [25, 64]
    assert grid[3]["counts"][0] == 64 and grid[4]["counts"][0] == 81
    assert grid[3]["resumed"] == 1 and not grid[1]["waved"]
    assert np.array_equal(grid[4]["fps"], grid[8]["fps"])
    assert "widening" in grid[5]["reason"] and "bounds" in grid[6]["reason"]
    assert grid[7]["counts"][0] < 49
    assert any(e["event"] == "incr_store_skipped" and "partial" in e["reason"]
               for e in grid[7]["events"])

    tp = port_runs("twophase")["records"]
    assert [r["mode"] for r in tp] == ["cold", PROPERTY_ONLY, IDENTICAL,
                                       "cold", "cold"]
    assert not tp[1]["waved"] and tp[1]["checker"].metrics()["engine"] == (
        "incr-verdict-cache")
    ref = TwoPhaseEdited_cold(3)
    assert tp[1]["counts"] == (ref.unique_state_count(), ref.state_count(),
                               ref.max_depth())
    model = port_fx.TwoPhaseEdited.build(3)
    assert tp[1]["discoveries"] == {
        n: _path_fps(model, p) for n, p in ref.discoveries().items()}
    assert "codec" in tp[3]["reason"] and "symmetry" in tp[4]["reason"]

    rel = port_runs("relatives")["records"]
    assert [r["mode"] for r in rel[2:5]] == [PROPERTY_ONLY, IDENTICAL, "cold"]
    assert rel[2]["discoveries"] == {}
    assert "not reusable" in rel[4]["reason"]
    assert "reuse disabled" in rel[5]["reason"]


def TwoPhaseEdited_cold(rm):
    return port_fx.TwoPhaseEdited.build(rm).checker().spawn_gpu(
        device="cpu", **TP_KW).join()


def test_verdict_cache_serves_violations(port_runs):
    """The port serves a stored violation from the cache, with its path,
    and refuses the EVENTUALLY-only edit and the opaque model."""
    trap = port_runs("trap")["records"]
    assert [r["mode"] for r in trap[:2]] == ["cold", IDENTICAL]
    assert not trap[1]["waved"] and trap[1]["checker"].metrics()["engine"] == (
        "incr-verdict-cache")
    assert trap[1]["classification"]["reaches limit"] == "counterexample"
    assert trap[1]["discoveries"] == trap[0]["discoveries"]
    assert trap[1]["discoveries"]["reaches limit"]
    assert "EVENTUALLY" in trap[2]["reason"]
    assert "spec_constants" in trap[4]["reason"]


@pytest.mark.parametrize("chunk", [7, 64, recheck.PROPEVAL_CHUNK])
def test_property_recheck_over_a_jax_snapshot(chunk, jax_runs, tmp_path):
    """The port's re-eval over the snapshot the JAX engine wrote for stock
    2pc rm=3 gives the slots (hence the paths) JAX's re-eval gave, at any
    chunk, journaling one dispatch a chunk ("consistent" never fails, so
    every chunk is read)."""
    runs = jax_runs("twophase")
    jspec = jax_incr.SpecFingerprint(JaxTwoPhaseSys(rm_count=3))
    jentry = jax_incr.VerificationStore(runs["store"]).lookup(jspec)
    assert jentry is not None and os.path.exists(jentry.snapshot_path)
    spec = SpecFingerprint(port_fx.TwoPhaseEdited.build(3))
    entry = StoreEntry(jentry.path, dict(jentry.record))
    journal = str(tmp_path / "j.jsonl")
    ck = recheck._property_recheck(spec, entry, port_incr_journal(journal),
                                   torch.device("cpu"), chunk=chunk)
    want = runs["records"][1]
    event, = [e for e in read_journal(journal)
              if e["event"] == "incr_property_recheck"]
    assert (event["rows"], event["dispatches"]) == (288, math.ceil(288 / chunk))
    assert want["mode"] == PROPERTY_ONLY
    assert {n: _path_fps(spec.model, p) for n, p in ck.discoveries().items()} == (
        want["discoveries"])
    assert ck.unique_state_count() == want["counts"][0]


def port_incr_journal(path):
    from stateright_tpu_torch.runtime.journal import as_journal

    return as_journal(path)


def test_cancel_stops_the_run_and_skips_the_store(tmp_path):
    cancel = threading.Event()
    cancel.set()
    spawned = []
    ck, info = port_incr.incremental_check(
        port_fx.GridWalk(bound=150).checker(), str(tmp_path / "s"),
        engine_kwargs=dict(GRID_KW, device="cpu"),
        journal=str(tmp_path / "j.jsonl"), cancel=cancel,
        on_spawn=spawned.append,
    )
    assert spawned == [ck] and ck.stop_requested()
    assert ck.unique_state_count() < 151 ** 2
    assert VerificationStore(str(tmp_path / "s")).entries() == []
    skipped = [e for e in read_journal(str(tmp_path / "j.jsonl"))
               if e["event"] == "incr_store_skipped"]
    assert skipped and "stopped" in skipped[-1]["reason"]


def test_classify_serves_from_the_index(tmp_path):
    """classify() parses no per-entry verdict.json on an index hit; the
    identical hit reads one; a missing index is rebuilt once."""
    store_dir = str(tmp_path / "s")
    for b in (4, 5):
        port_incr.incremental_check(
            port_fx.GridWalk(bound=b).checker(), store_dir,
            engine_kwargs=dict(GRID_KW, device="cpu"), reuse=False)
    store = VerificationStore(store_dir)
    assert store.classify(SpecFingerprint(port_fx.GridWalk(bound=6))).mode == (
        CONSTANT_WIDENING)
    assert store.verdict_reads == 0
    assert store.classify(SpecFingerprint(port_fx.GridWalk(bound=5))).mode == (
        IDENTICAL)
    assert store.verdict_reads == 1
    os.remove(os.path.join(store_dir, "index.json"))
    store2 = VerificationStore(store_dir)
    store2.classify(SpecFingerprint(port_fx.GridWalk(bound=6)))
    assert store2.verdict_reads == 2
    store3 = VerificationStore(store_dir)
    store3.classify(SpecFingerprint(port_fx.GridWalk(bound=6)))
    assert store3.verdict_reads == 0


# --- the kernels' twins against the JAX functions ------------------------------


def _vmap(fn, rows):
    return np.asarray(jax.jit(jax.vmap(fn))(jnp.asarray(rows)))


@pytest.mark.parametrize("bound", [0, 4, 32_767])
def test_grid_walk_twin_matches_jax(bound):
    """K21's twin: successors, their in-box validity (the JAX step's valid
    lanes ANDed with the boundary of each successor) and the conds."""
    rng = np.random.default_rng(bound)
    xy = np.array([(0, 0), (bound, bound), (0xFFFF, 0), (0, 0xFFFF),
                   (0xFFFF, 0xFFFF), (bound, 0xFFFF), (bound + 1, bound),
                   (bound, 0)], np.uint64)
    xy = np.concatenate([xy, rng.integers(0, 1 << 16, (200, 2), np.uint64)])
    rows = (xy[:, 0] | (xy[:, 1] << np.uint64(16))).astype(np.uint32)[:, None]
    jcm = jax_fx.GridWalk(bound=bound).compiled()
    nexts, valid = jax.jit(jax.vmap(jcm.step))(jnp.asarray(rows))
    nexts, valid = np.asarray(nexts), np.asarray(valid)
    inside = _vmap(jcm.boundary, nexts.reshape(-1, 1)).reshape(-1, 2)
    conds = _vmap(jcm.property_conds, rows)
    p_nexts, p_valid, p_conds = port_fx.grid_walk_plain(
        from_numpy_u32(rows, "cpu"), bound)
    assert np.array_equal(to_numpy_u32(p_nexts), nexts)
    assert np.array_equal(p_valid.numpy(), valid & inside)
    assert np.array_equal(p_conds.numpy(), conds)
    box = port_fx.grid_box_plain(from_numpy_u32(rows, "cpu"), bound)
    assert np.array_equal(box.numpy(), _vmap(jcm.boundary, rows))


def _random_rows(rng, n, count):
    """Encodable packed 2pc rows: every field in range."""
    rm = rng.integers(0, 4, size=(count, n), dtype=np.uint64)
    w0 = (rm << (2 * np.arange(n, dtype=np.uint64))).sum(1)
    w0 |= rng.integers(0, 3, size=count, dtype=np.uint64) << np.uint64(24)
    w1 = rng.integers(0, 1 << (2 * n + 2), size=count, dtype=np.uint64)
    return np.stack([w0, w1], 1).astype(np.uint32)


@pytest.mark.parametrize("rm", [3, 4, 5])
def test_twophase_conds_twin_matches_jax(rm):
    """K2c's twin: the stock conds and the edited model's four."""
    rows = _random_rows(np.random.default_rng(rm), rm, 500)
    rows = np.concatenate([rows, np.zeros((1, 2), np.uint32)])
    t = from_numpy_u32(rows, "cpu")
    stock = jax_fx.TwoPhaseEdited.build(rm).compiled()
    base = JaxTwoPhaseSys(rm_count=rm).compiled()
    assert np.array_equal(twophase_conds_plain(t, rm).numpy(),
                          _vmap(base.property_conds, rows))
    assert np.array_equal(twophase_conds_plain(t, rm, some_prepared=True).numpy(),
                          _vmap(stock.property_conds, rows))
    port = port_fx.TwoPhaseEdited.build(rm).compiled()
    assert np.array_equal(port.property_conds(t).numpy(),
                          _vmap(stock.property_conds, rows))
    # The edited model's wave takes its conds from the override.
    assert np.array_equal(port.expand(t)[2].numpy(),
                          _vmap(stock.property_conds, rows))


def _jax_scan(conds, n, kinds, off):
    """The JAX re-eval's scan of one chunk (incr/recheck.py:175-184)."""
    out = []
    for i, kind in enumerate(kinds):
        col = conds[:n, i]
        hit = ~col if kind == "always" else (col if kind == "sometimes" else
                                             np.zeros_like(col))
        idx = np.flatnonzero(hit)
        out.append(off + int(idx[0]) if idx.size else recheck.NO_SLOT)
    return out


@pytest.mark.parametrize("case", ["none", "padded-tail", "at-zero", "random"])
def test_first_hits_twin_matches_the_jax_scan(case):
    """K22's twin against the JAX scan: no hit, a hit only in the padded
    tail (rows past n), a hit at position 0, seeded conds."""
    rng = np.random.default_rng(len(case))
    kinds = ["always", "sometimes", "eventually", "sometimes", "always"]
    r, n, off = 64, 48, 4096
    conds = np.zeros((r, len(kinds)), bool)
    conds[:, 0] = conds[:, 4] = True  # always conds that hold
    if case == "padded-tail":
        conds[n:, 1] = True
        conds[n:, 0] = False
    elif case == "at-zero":
        conds[0, 1] = conds[0, 3] = True
        conds[0, 4] = False
    elif case == "random":
        conds = rng.random((r, len(kinds))) < 0.1
    always = sum(1 << i for i, k in enumerate(kinds) if k == "always")
    sometimes = sum(1 << i for i, k in enumerate(kinds) if k == "sometimes")
    got = recheck.first_hits(torch.from_numpy(conds), n, always, sometimes, off)
    assert got.tolist() == _jax_scan(conds, n, kinds, off)
    if case == "none":
        assert got.tolist() == [recheck.NO_SLOT] * len(kinds)


# --- the spec hash ---------------------------------------------------------------


def test_spec_components_distinguish_deltas():
    base = SpecFingerprint(port_fx.GridWalk(bound=4))
    widened = SpecFingerprint(port_fx.GridWalk(bound=6))
    assert base.spec_key != widened.spec_key
    assert base.family_key == widened.family_key
    assert base.components["codec"] == widened.components["codec"]
    assert base.components["properties"] == widened.components["properties"]
    assert base.components["constants"] != widened.components["constants"]

    edited = SpecFingerprint(port_fx.TwoPhaseEdited.build(3))
    stock = SpecFingerprint(TwoPhaseSys(rm_count=3))
    assert edited.components["codec"] == stock.components["codec"]
    assert edited.components["constants"] == stock.components["constants"]
    assert edited.components["properties"] != stock.components["properties"]

    small = SpecFingerprint(port_fx.GridWalk(bound=4),
                            engine_kwargs={"capacity": 1 << 10})
    big = SpecFingerprint(port_fx.GridWalk(bound=4),
                          engine_kwargs={"capacity": 1 << 20})
    assert small.spec_key == big.spec_key
    assert small.components["engine"] != big.components["engine"]

    sym = SpecFingerprint(TwoPhaseSys(rm_count=3), symmetry=True)
    assert sym.spec_key != stock.spec_key
    assert sym.components["symmetry"] != stock.components["symmetry"]
    # Never the JAX package's keys: its digests cover other code.
    assert stock.spec_key != jax_incr.SpecFingerprint(
        JaxTwoPhaseSys(rm_count=3)).spec_key
    # The snapshot key is the JAX engine's, character for character.
    assert stock.snapshot_key == jax_incr.SpecFingerprint(
        JaxTwoPhaseSys(rm_count=3)).snapshot_key


def _paxos(c, max_round=None):
    return model_of(PKGS["port"], "paxos", c, max_round)


def test_paxos_round_bound_spec_components():
    base = SpecFingerprint(_paxos(1, 0))
    wide = SpecFingerprint(_paxos(1))
    assert base.spec_key != wide.spec_key
    assert base.family_key == wide.family_key
    assert base.components["codec"] == wide.components["codec"]
    assert base.components["properties"] == wide.components["properties"]
    assert base.components["constants"] != wide.components["constants"]
    assert base.snapshot_key == wide.snapshot_key
    assert wide.compiled.spec_widens(base.constants)
    assert not base.compiled.spec_widens(wide.constants)
    assert not wide.compiled.spec_widens({"max_round": "0"})
    capped = SpecFingerprint(_paxos(1, 15))
    assert capped.components["constants"] == wide.components["constants"]
    probe = torch.zeros((1, wide.compiled.state_width), dtype=torch.int32)
    assert wide.compiled.boundary(probe) is None
    assert base.compiled.boundary(probe) is not None
    with pytest.raises(ValueError, match="max_round"):
        SpecFingerprint(_paxos(1, 16))


def test_raft_crash_budget_spec_components():
    frozen = SpecFingerprint(RaftModelCfg(server_count=3, max_crashes=0).into_model())
    stock = SpecFingerprint(RaftModelCfg(server_count=3).into_model())
    assert stock.constants["max_crashes"] == "1"  # (n - 1) // 2
    assert frozen.spec_key != stock.spec_key
    assert frozen.family_key == stock.family_key
    assert frozen.components["codec"] == stock.components["codec"]
    assert frozen.components["properties"] == stock.components["properties"]
    assert frozen.components["constants"] != stock.components["constants"]
    assert frozen.snapshot_key == stock.snapshot_key
    assert stock.compiled.spec_widens(frozen.constants)
    assert not frozen.compiled.spec_widens(stock.constants)
    assert not stock.compiled.spec_widens({"max_crashes": "0"})


def test_code_digest_sees_defaults_closures_and_helpers():
    def mk_default(k=5):
        def cond(_m, s, bound=k):
            return s <= bound

        return cond

    assert code_digest(mk_default(5)) == code_digest(mk_default(5))
    assert code_digest(mk_default(5)) != code_digest(mk_default(4))

    def mk_closure(k):
        return lambda _m, s: s <= k

    assert code_digest(mk_closure(5)) == code_digest(mk_closure(5))
    assert code_digest(mk_closure(5)) != code_digest(mk_closure(4))

    def make(delta):
        mod = {}
        exec(
            "def helper(s):\n"
            f"    return s + {delta}\n"
            "def cond(_m, s):\n"
            "    return helper(s) > 3\n",
            mod,
        )
        return mod["cond"]

    assert code_digest(make(1)) == code_digest(make(1))
    assert code_digest(make(1)) != code_digest(make(2))


def test_spec_hash_stable_across_processes():
    """Components, keys and a set literal's digest survive a fresh
    interpreter with another ``PYTHONHASHSEED``."""
    script = (
        "import json\n"
        "from stateright_tpu_torch.incr import SpecFingerprint\n"
        "from stateright_tpu_torch.incr.spec_hash import code_digest\n"
        "from stateright_tpu_torch.models.fixtures import GridWalk\n"
        "def set_cond(_m, s):\n"
        "    return s in {'a', 'b', 'c'}\n"
        "s = SpecFingerprint(GridWalk(bound=5))\n"
        "print(json.dumps({'components': s.components, 'spec_key': s.spec_key,"
        " 'family_key': s.family_key, 'snapshot_key': s.snapshot_key,"
        " 'set': code_digest(set_cond)}))\n"
    )

    def set_cond(_m, s):
        return s in {'a', 'b', 'c'}

    env = dict(os.environ, PYTHONHASHSEED="31337", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=env, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    here = SpecFingerprint(port_fx.GridWalk(bound=5))
    assert got["components"] == here.components
    assert (got["spec_key"], got["family_key"], got["snapshot_key"]) == (
        here.spec_key, here.family_key, here.snapshot_key)
    assert got["set"] == code_digest(set_cond)


def test_an_edited_kernel_source_changes_the_codec(tmp_path, monkeypatch):
    """The transition lives in ``csrc/``: an edit there must change the
    codec (and properties) components, or the store would serve a stale
    verdict; a byte-identical copy elsewhere changes nothing."""
    before = SpecFingerprint(TwoPhaseSys(rm_count=3))
    copy = tmp_path / "csrc"
    shutil.copytree(spec_hash.CSRC, copy)
    monkeypatch.setattr(spec_hash, "CSRC", copy)
    same = SpecFingerprint(TwoPhaseSys(rm_count=3))
    assert same.components == before.components
    src = copy / "twophase_step.cu"
    text = src.read_text()
    edited = text.replace("v = rm_working;", "v = rm_working && tm_init;", 1)
    assert edited != text
    src.write_text(edited)
    after = SpecFingerprint(TwoPhaseSys(rm_count=3))
    assert after.components["codec"] != before.components["codec"]
    assert after.components["properties"] != before.components["properties"]
    assert after.components["constants"] == before.components["constants"]
    assert after.spec_key != before.spec_key


def test_stock_and_edited_expand_route_their_conds():
    """2pc's stock conds come from K2's fused launch; an override of
    ``property_conds`` (the edited model, a sliced GridWalk or trap
    counter) is what the wave evaluates."""
    rows = from_numpy_u32(_random_rows(np.random.default_rng(1), 3, 64), "cpu")
    stock = TwoPhaseSys(rm_count=3).compiled()
    assert stock.expand(rows)[2].shape == (64, 3)
    edited = port_fx.TwoPhaseEdited.build(3).compiled()
    assert edited.expand(rows)[2].shape == (64, 4)
    assert torch.equal(edited.walk_step(rows, plain=True)[2],
                       edited.expand(rows)[2])
    corner = model_of(PKGS["port"], "corner-only", 4).compiled()
    grid_rows = from_numpy_u32(np.arange(8, dtype=np.uint32)[:, None], "cpu")
    assert corner.expand(grid_rows)[2].shape == (8, 1)


# --- the cold store's disk tier ------------------------------------------------


@pytest.mark.parametrize("case", ["no-clobber", "from-arrays", "open-close"])
def test_cold_store_lifecycle(case, tmp_path):
    d = str(tmp_path / "cold")
    a = ColdStore(spill_dir=d)
    a.add_run(np.array([1, 2, 3], np.uint64))
    if case == "no-clobber":
        first = sorted(os.listdir(d))
        ColdStore(spill_dir=d).add_run(np.array([7, 8], np.uint64))
        assert sorted(os.listdir(d)) > first
        np.testing.assert_array_equal(np.load(os.path.join(d, first[0])), [1, 2, 3])
    elif case == "from-arrays":
        a.add_run(np.array([9], np.uint64))
        fps, lens = a.to_arrays()
        a.close()
        b = ColdStore.from_arrays(fps, lens, spill_dir=d)
        assert (b.run_count, b.entries) == (2, 4)
        assert len([f for f in os.listdir(d) if f.endswith(".npy")]) == 2
        np.testing.assert_array_equal(b.contains(np.array([1, 9, 5], np.uint64)),
                                      [True, True, False])
    else:
        a.add_run(np.array([0], np.uint64))
        a.close()
        assert a.run_count == 0
        b = ColdStore.open(d)
        assert (b.run_count, b.entries) == (2, 4)
        np.testing.assert_array_equal(b.contains(np.array([3, 5], np.uint64)),
                                      [True, False])
        assert not [f for f in os.listdir(d) if f.endswith(".tmp")]

