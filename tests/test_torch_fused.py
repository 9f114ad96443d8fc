"""The fused wave loop (``spawn_gpu(waves_per_call=...)``) against the JAX
engine's, on the CPU.

The port's untraced ``spawn_gpu`` runs a quantum of up to
``waves_per_call`` waves behind one stats readback, with the loop's
control in K29 (``parallel/fused.py``); on the CPU the quantum is a loop
over the twins.  Each case runs the JAX ``spawn_tpu`` at the same
arguments and holds the port to it: the journals' ``wave`` events field for
field (less their timings), ``grow`` and ``geometry`` events, the final
counts, row log, parents, ebits, the table's key set and the discoveries.
Covered: ``waves_per_call`` 1, 4 and the default; a table growth (flag 1),
a ``finish_when`` stop and a ``target_max_depth`` stop inside a quantum;
an explicit ``step_lanes=256`` climbing the step rung (flag 128); the
density tuner at ``waves_per_call=1`` (the JAX pin,
``tests/test_sort_rung.py:125``); a checkpoint resumed through the
quantum.  Then K29's twins on seeded stats vectors, the device-count
twins of K1, K4, K8 and K25, and ``finish_when_masks`` against the JAX
``make_finish_when_device``.  The JAX runs are made once per module.
"""

import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stateright_tpu.core.has_discoveries import HasDiscoveries as JHasDiscoveries  # noqa: E402
from stateright_tpu.core.model import Property as JProperty  # noqa: E402
from stateright_tpu.models.twophase import TwoPhaseSys as JaxTwoPhaseSys  # noqa: E402
from stateright_tpu.parallel.wave_common import (  # noqa: E402
    make_finish_when_device as jax_make_finish_when_device,
)
from stateright_tpu.runtime.journal import read_journal as jax_read_journal  # noqa: E402
from stateright_tpu_torch.core.has_discoveries import HasDiscoveries  # noqa: E402
from stateright_tpu_torch.core.model import Property  # noqa: E402
from stateright_tpu_torch.models.twophase import TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.ops.device_fp import device_fp64_n, device_fp64_plain  # noqa: E402
from stateright_tpu_torch.parallel import fused  # noqa: E402
from stateright_tpu_torch.parallel.append import (  # noqa: E402
    append_block_dev, append_block_plain,
)
from stateright_tpu_torch.parallel.hashset import (  # noqa: E402
    HashSet, insert_batch_claim_dev, insert_batch_claim_plain,
)
from stateright_tpu_torch.parallel.wave_common import (  # noqa: E402
    NO_ID, finish_when_masks, wave_eval_dev, wave_eval_plain,
)
from stateright_tpu_torch.parallel.wavefront import GpuChecker  # noqa: E402
from stateright_tpu_torch.runtime.journal import read_journal  # noqa: E402

GEOMETRY = dict(capacity=1 << 14, max_frontier=1 << 9)
# A table of 256 slots grows (flag 1) inside a 4-wave quantum.
GROWING = dict(capacity=1 << 8, max_frontier=1 << 6)
# The wave event's fields both engines write (all but the timings).
WAVE_FIELDS = ("waves", "remaining", "unique", "states", "depth", "flags",
               "occupancy", "density", "tail")
GEOMETRY_FIELDS = ("capacity", "log_capacity", "max_frontier",
                   "dedup_factor", "sortless", "sort_lanes", "step_lanes",
                   "u_lanes", "waves_per_call")
EVENT_FIELDS = {
    "wave": WAVE_FIELDS,
    "grow": ("flags", "unique", "depth"),
    "geometry": GEOMETRY_FIELDS,
    "checkpoint": ("unique", "depth", "tail", "final"),
    "engine_done": ("unique", "states", "depth"),
}


def _events(path, read):
    return [
        (e["event"], {k: e.get(k) for k in EVENT_FIELDS[e["event"]]})
        for e in read(path) if e["event"] in EVENT_FIELDS
    ]


def _snapshot(checker, path):
    checker.save_snapshot(str(path))
    with np.load(path) as snap:
        tail = int(snap["tail"])
        keys = (snap["key_hi"].astype(np.uint64) << np.uint64(32)) | snap[
            "key_lo"].astype(np.uint64)
        return {
            "rows": snap["rows"][: 2 * tail].copy(),
            "parent": snap["parent"][:tail].copy(),
            "ebits": snap["ebits"][:tail].copy(),
            "keys": np.sort(keys[keys != 0]),
            "stats": [int(snap[k]) for k in (
                "level_start", "level_end", "tail", "sc_lo", "sc_hi",
                "unique_count", "depth")] + [int(d) for d in snap["disc"]],
        }


_RUNS = {}
# The CPU quantum's own width: the level's live lanes of the chunk.
_LIVE_ROWS = GpuChecker._fused_rows


@pytest.fixture(autouse=True)
def card_width(monkeypatch):
    """The port's quanta here expand the whole chunk, as the card's
    captured wave does, the lanes past the level inactive."""
    monkeypatch.setattr(GpuChecker, "_fused_rows", GpuChecker._step_width)


def _pair(tmp_path_factory, rm, builder=lambda b: b, **kw):
    """The JAX engine's and the port's run of 2pc at ``rm`` with the same
    builder and arguments (each once per module): ``(jax, port, jax
    snapshot, port snapshot, jax events, port events)``."""
    key = (rm, builder.__name__, tuple(sorted(kw.items())))
    if key not in _RUNS:
        d = tmp_path_factory.mktemp("fused")
        jt = builder(JaxTwoPhaseSys(rm_count=rm).checker()).spawn_tpu(
            journal=str(d / "jax.jsonl"), **kw).join()
        pt = builder(TwoPhaseSys(rm_count=rm).checker()).spawn_gpu(
            device="cpu", journal=str(d / "port.jsonl"), **kw).join()
        _RUNS[key] = (
            jt, pt, _snapshot(jt, d / "jax.npz"), _snapshot(pt, d / "port.npz"),
            _events(d / "jax.jsonl", jax_read_journal),
            _events(d / "port.jsonl", read_journal),
        )
    return _RUNS[key]


def _assert_same(run):
    jt, pt, js, ps, je, pe = run
    assert pe == je
    for k in js:
        assert np.array_equal(np.asarray(js[k]), np.asarray(ps[k])), k
    got = (pt.unique_state_count(), pt.state_count(), pt.max_depth())
    assert got == (jt.unique_state_count(), jt.state_count(), jt.max_depth())
    assert sorted(pt.discoveries()) == sorted(jt.discoveries())
    assert pt.waves() == jt.metrics()["waves"]
    assert pt.tuned_kwargs() == jt.tuned_kwargs()


@pytest.mark.parametrize("wpc", [1, 4, None])
def test_quantum_matches_jax_at_waves_per_call(tmp_path_factory, wpc):
    run = _pair(tmp_path_factory, 4, waves_per_call=wpc, **GEOMETRY)
    _assert_same(run)
    pt = run[1]
    # One readback a quantum: 14 levels of 2pc rm=4 in 1, 4 or 256 waves.
    waves_per_call = wpc or 256
    assert pt._readbacks == -(-pt._waves_run // waves_per_call)
    assert pt.metrics()["waves_per_call"] == waves_per_call


def test_growth_inside_a_quantum_matches_jax(tmp_path_factory):
    """Flag 1 falls on a middle wave of a 4-wave quantum: the quantum ends
    at the flagged wave's start, the table grows, the same chunk reruns."""
    run = _pair(tmp_path_factory, 4, waves_per_call=4, **GROWING)
    _assert_same(run)
    pt, events = run[1], run[5]
    grows = [e for k, e in events if k == "grow"]
    assert grows[0]["flags"] == 1  # then the explicit log grows (flag 2)
    waves = [e for k, e in events if k == "wave"]
    i = next(i for i, e in enumerate(waves) if e["flags"] & 1)
    # The flagged quantum committed waves before its flagged one (2pc
    # rm=4 has one init state).
    assert waves[i]["unique"] > (waves[i - 1]["unique"] if i else 1)
    assert waves[i]["depth"] > 0
    assert pt.unique_state_count() == 1568


def test_finish_when_stop_inside_a_quantum_matches_jax(tmp_path_factory):
    """finish_when(ANY) stops the quantum at the wave that found the first
    discovery, whatever wave of the quantum it is."""
    d = tmp_path_factory.mktemp("fw")
    jt = JaxTwoPhaseSys(rm_count=4).checker().finish_when(
        JHasDiscoveries.ANY).spawn_tpu(
        waves_per_call=4, journal=str(d / "j.jsonl"), **GEOMETRY).join()
    pt = TwoPhaseSys(rm_count=4).checker().finish_when(
        HasDiscoveries.ANY).spawn_gpu(
        device="cpu", waves_per_call=4, journal=str(d / "p.jsonl"),
        **GEOMETRY).join()
    pe, je = _events(d / "p.jsonl", read_journal), _events(d / "j.jsonl", jax_read_journal)
    assert pe == je
    assert sorted(pt.discoveries()) == sorted(jt.discoveries()) != []
    assert pt._waves_run % 4 != 0  # stopped inside a quantum
    assert _snapshot(pt, d / "p.npz")["stats"] == _snapshot(jt, d / "j.npz")["stats"]


def _depth7(b):
    return b.target_max_depth(7)


def test_target_depth_stop_inside_a_quantum_matches_jax(tmp_path_factory):
    run = _pair(tmp_path_factory, 4, builder=_depth7, **GEOMETRY)
    _assert_same(run)
    assert run[1].max_depth() == 7 and run[1]._readbacks == 1


def test_step_rung_climbs_like_jax(tmp_path_factory):
    """An explicit 256-state step rung on 2pc rm=5 (levels to ~1,600
    states): flag 128 climbs it wave by wave, as the JAX engine does."""
    run = _pair(tmp_path_factory, 5, step_lanes=256, capacity=1 << 15,
                max_frontier=1 << 11, waves_per_call=8)
    _assert_same(run)
    events = run[5]
    grows = [e for k, e in events if k == "grow"]
    assert grows and all(g["flags"] == 128 for g in grows)
    assert run[1].metrics()["step_lanes"] > 256


def test_density_tuner_downshifts_like_jax(tmp_path_factory):
    """The JAX pin (tests/test_sort_rung.py:125): a default run of 2pc
    rm=4 at 2**11 states a chunk, one wave a quantum, downshifts its sort
    rung once it has evidence -- at the same quantum, to the same rung."""
    run = _pair(tmp_path_factory, 4, capacity=1 << 14, max_frontier=1 << 11,
                waves_per_call=1)
    _assert_same(run)
    pt, events = run[1], run[5]
    geoms = [e for k, e in events if k == "geometry"]
    assert len(geoms) >= 2 and geoms[-1]["sort_lanes"] < geoms[0]["sort_lanes"]
    assert pt.metrics()["sort_lanes"] < pt._wl_cand_lanes()


def test_checkpoint_resumed_through_the_quantum(tmp_path):
    """A mid-run checkpoint (every 2 quanta of 2 waves) of a run cut at
    depth 9 resumes through the quantum -- in the port and in the JAX
    engine -- to the straight run's logs."""
    ck = str(tmp_path / "ck.npz")
    TwoPhaseSys(rm_count=4).checker().target_max_depth(9).spawn_gpu(
        device="cpu", waves_per_call=2, checkpoint_path=ck,
        checkpoint_every_waves=4, journal=str(tmp_path / "p.jsonl"),
        **GEOMETRY).join()
    events = _events(tmp_path / "p.jsonl", read_journal)
    assert [e["final"] for k, e in events if k == "checkpoint"][-1]
    straight = _snapshot(
        TwoPhaseSys(rm_count=4).checker().spawn_gpu(
            device="cpu", waves_per_call=2, **GEOMETRY).join(),
        tmp_path / "s.npz")
    port = TwoPhaseSys(rm_count=4).checker().spawn_gpu(
        device="cpu", waves_per_call=2, resume_from=ck, **GEOMETRY).join()
    back = JaxTwoPhaseSys(rm_count=4).checker().spawn_tpu(
        waves_per_call=2, resume_from=ck, **GEOMETRY).join()
    for name, c in (("port", port), ("jax", back)):
        snap = _snapshot(c, tmp_path / f"{name}.npz")
        for k in ("rows", "parent", "ebits", "keys", "stats"):
            assert np.array_equal(np.asarray(snap[k]), np.asarray(straight[k])), (name, k)


def test_cpu_full_width_quantum_equals_trimmed(monkeypatch):
    """The card's quantum expands the whole chunk, its lanes past the
    level inactive copies of the first row; the CPU's expands the level's
    live lanes.  Both write the same logs (2pc rm=4, 64 states a chunk)."""
    full = TwoPhaseSys(rm_count=4).checker().spawn_gpu(
        device="cpu", capacity=1 << 14, max_frontier=1 << 6).join()
    monkeypatch.setattr(GpuChecker, "_fused_rows", _LIVE_ROWS)
    trimmed = TwoPhaseSys(rm_count=4).checker().spawn_gpu(
        device="cpu", capacity=1 << 14, max_frontier=1 << 6).join()
    n = trimmed._carry.tail
    assert full._carry.tail == n == 1568
    for name in ("rows", "parent", "ebits"):
        a, b = getattr(trimmed._carry, name), getattr(full._carry, name)
        assert torch.equal(a[: n * 2] if name == "rows" else a[:n],
                           b[: n * 2] if name == "rows" else b[:n]), name
    assert full.state_count() == trimmed.state_count()


# --- K29's twins on seeded stats vectors ----------------------------------

P = 3
CTL = fused.STAT_DISC + P
ARGS = dict(waves=8, f_eff=64, f_full=64, cap=1 << 10, qcap=1 << 9,
            size=128, target=0, fw_masks=(0, 0))


def _stats(words, ctl=None):
    full = list(words) + [NO_ID] * (fused.STAT_DISC - len(words))
    full = full[: fused.STAT_DISC] + [NO_ID] * P + (ctl or [0] * fused.CTL_WORDS)
    return torch.tensor([((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000 for x in full],
                        dtype=torch.int32)


def _words(stats):
    return [int(x) & 0xFFFFFFFF for x in stats.tolist()]


def _close(stats, n_new=3, n_valid=10, ok=True, step=False, dd=False,
           cands=(NO_ID,) * P, **kw):
    args = dict(ARGS, **kw)
    fused.wave_ctl_plain(
        stats, P, begin=False, n_new=torch.tensor(n_new),
        n_valid=torch.tensor(n_valid), probe_ok=torch.tensor(ok),
        step_flag=torch.tensor(step), dd_flag=torch.tensor(dd),
        cands=torch.tensor(cands, dtype=torch.int64), **args)
    return _words(stats)


# level [5, 100), tail 200, 7 generated so far, 150 unique, depth 2.
BASE = [5, 100, 200, 7, 0, 150, 2, 0]


@pytest.mark.parametrize("flag,kw", [
    (1, dict(ok=False)),
    (1, dict(n_new=400)),  # (150 + 400) * 2 > 1,024
    (2, dict(n_new=313)),  # 200 + 313 > 512 (and flag 1: 463 * 2 <= 1,024)
    (4, dict(n_valid=129)),
    (4, dict(dd=True)),
    (8, dict(step=True)),
    (128, dict(f_eff=32)),  # 95 states left > a 32-state rung below 64
])
def test_wave_ctl_twin_flags_gate_the_commit(flag, kw):
    stats = _stats(BASE, [5, 1, 0, 0, 0, 0, 9])
    before = _words(stats)
    after = _close(stats, cands=(17, NO_ID, 40), **kw)
    assert after[fused.STAT_FLAGS] & flag
    # Nothing commits: the carry is exactly the flagged wave's start.
    assert after[:fused.STAT_FLAGS] == before[:fused.STAT_FLAGS]
    assert after[fused.STAT_DISC:CTL] == [NO_ID] * P
    assert after[CTL + fused.CTL_WAVE_NEW] == 0
    assert after[CTL + fused.CTL_GO] == 0  # the quantum stops
    assert after[CTL + fused.CTL_WAVES_RUN] == 1
    assert after[CTL + fused.CTL_WAVES_LEFT] == 4
    assert after[CTL + fused.CTL_EPOCH] == 9


def test_wave_ctl_twin_commits_folds_and_rolls_the_level():
    stats = _stats(BASE, [5, 1, 0, 0, 0, 0, 0])
    stats[fused.STAT_DISC + 2] = 3  # property 2 already discovered
    after = _close(stats, n_new=6, n_valid=10, cands=(17, NO_ID, 40))
    assert after[:fused.STAT_FLAGS + 1] == [69, 100, 206, 17, 0, 156, 2, 0]
    assert after[fused.STAT_DISC:CTL] == [17, NO_ID, 3]  # first writer wins
    assert after[CTL:CTL + 6] == [4, 1, 1, 5, 200, 6]
    after = _close(stats, n_new=2, n_valid=4)  # the level's last 31 states
    assert after[:fused.STAT_FLAGS + 1] == [100, 208, 208, 21, 0, 158, 3, 0]
    assert after[CTL + fused.CTL_WAVE_LO] == 69


def test_wave_ctl_twin_carries_sc_across_2_32():
    stats = _stats([5, 100, 200, 0xFFFFFFF0, 6, 150, 2, 0])
    after = _close(stats, n_valid=0x20)
    assert (after[fused.STAT_SC_LO], after[fused.STAT_SC_HI]) == (0x10, 7)


@pytest.mark.parametrize("case", ["drained", "waves", "depth", "fw", "go"])
def test_wave_ctl_twin_begin_evaluates_the_loop_condition(case):
    words = list(BASE)
    kw = {}
    if case == "drained":
        words[0] = 100
    if case == "depth":
        kw["target"] = 3  # depth 2 is the last expanded below target 3
    if case == "fw":
        kw["fw_masks"] = (0, 0b100)
    stats = _stats(words)
    if case == "fw":
        stats[fused.STAT_DISC + 2] = 8
    stats[fused.STAT_FLAGS] = 4  # a flagged quantum's word, cleared
    fused.wave_ctl_plain(stats, P, begin=True, **dict(
        ARGS, waves=0 if case == "waves" else 8, **kw))
    after = _words(stats)
    assert after[fused.STAT_FLAGS] == 0
    assert after[CTL + fused.CTL_GO] == (case == "go")


def test_wave_load_twin_copies_the_first_row_past_the_level():
    rows = torch.arange(40, dtype=torch.int32)  # 20 rows of 2 words
    ebits = torch.arange(20, dtype=torch.int32) * 10
    stats = _stats([4, 7, 20, 0, 0, 20, 0, 0])
    states, eb, active = fused.wave_load_plain(rows, ebits, stats, 5, 2)
    assert states.tolist() == [[8, 9], [10, 11], [12, 13], [8, 9], [8, 9]]
    assert eb.tolist() == [40, 50, 60, 40, 40]
    assert active.tolist() == [True, True, True, False, False]


# --- the device-count entries' twins ----------------------------------------


def test_device_count_twins_match_their_host_entries():
    rng = np.random.default_rng(15)
    rows = torch.from_numpy(rng.integers(-2**31, 2**31, (64, 3), dtype=np.int64)
                            .astype(np.int32))
    count = torch.tensor(23)
    hi, lo = device_fp64_n(rows, count)
    ph, pl = device_fp64_plain(rows[:23])
    assert torch.equal(hi[:23], ph) and torch.equal(lo[:23], pl)
    assert not hi[23:].any()

    # K8: the first position and the discovered mask from the stats, the
    # inactive states gated out.
    conds = torch.from_numpy(rng.random((16, 3)) < 0.5)
    valid = torch.from_numpy(rng.random((16, 4)) < 0.5)
    eb = torch.from_numpy(rng.integers(0, 2, 16).astype(np.int32))
    active = torch.arange(16) < 11
    kinds = (0b001, 0b010, 0b100)
    stats = _stats([30, 46, 50, 0, 0, 50, 3, 0])
    stats[fused.STAT_DISC + 1] = 7
    got = wave_eval_dev(conds, valid.clone(), eb, stats, active, kinds)
    want = wave_eval_plain(conds[:11], valid[:11].clone(), eb[:11], 30, kinds, 0b010)
    assert torch.equal(got[0][:11], want[0]) and not got[0][11:].any()
    assert torch.equal(got[1][:11], want[1]) and torch.equal(got[2], want[2])

    # K4: the device epoch advances; the answer is the host entry's.
    keys = rng.integers(1, 2**31, 32, dtype=np.int64)
    hi_k = torch.from_numpy((keys >> 16).astype(np.int32))
    lo_k = torch.from_numpy(keys.astype(np.int32))
    act = torch.from_numpy(rng.random(32) < 0.8)
    t1, t2 = HashSet.empty(64, "cpu"), HashSet.empty(64, "cpu")
    epoch = torch.tensor([41], dtype=torch.int32)
    new, ok = insert_batch_claim_dev(t1, hi_k, lo_k, act, epoch)
    want_new, want_ok = insert_batch_claim_plain(t2.keys, hi_k, lo_k, act)
    assert torch.equal(new, want_new) and bool(ok) == bool(want_ok)
    assert torch.equal(t1.keys, t2.keys) and int(epoch) == 42

    # K25: (lo_pos, tail, n_new) from K29's words; 0 appends nothing.
    w, a = 2, 4
    cand = torch.from_numpy(rng.integers(0, 99, (24, w)).astype(np.int32))
    sel = torch.tensor([1, 4, 6, 0, 0, 0], dtype=torch.int32)
    v_orig = torch.tensor([0, 3, 5, 9, 14, 17, 22, 23], dtype=torch.int32)
    ebw = torch.arange(6, dtype=torch.int32)
    for n_new in (3, 0):
        logs = [torch.zeros(20 * w, dtype=torch.int32), torch.zeros(20, dtype=torch.int32),
                torch.zeros(20, dtype=torch.int32)]
        want = [x.clone() for x in logs]
        append_block_dev(*logs, sel, None, v_orig, cand, ebw,
                         torch.tensor([7, 11, n_new], dtype=torch.int32), a, False)
        append_block_plain(*want, sel, None, v_orig, cand, ebw, 7, 11, n_new, a, False)
        assert all(torch.equal(x, y) for x, y in zip(logs, want))
        assert bool(logs[1].any()) == bool(n_new)


# --- finish_when on the card --------------------------------------------------

KINDS = ["all", "any", "any_failures", "all_failures", "all_of", "any_of"]


def _props(pkg_prop, expectations):
    make = {"A": pkg_prop.always, "S": pkg_prop.sometimes,
            "E": pkg_prop.eventually}
    return [make[e](f"p{i}", lambda _m, _s: True)
            for i, e in enumerate(expectations)]


CASES = [
    (kind, expectations, names)
    for kind in KINDS
    for expectations in ("ASE", "SSS", "")
    for names in (
        [("p0", "p2"), (), ("p1", "nope")] if kind.endswith("_of") else [()]
    )
]


@pytest.mark.parametrize("kind,expectations,names", CASES)
def test_finish_when_masks_match_jax(kind, expectations, names):
    fw, jfw = HasDiscoveries(kind, names), JHasDiscoveries(kind, names)
    props, jprops = _props(Property, expectations), _props(JProperty, expectations)
    fw_all, fw_any = finish_when_masks(fw, props)
    jax_matched = jax_make_finish_when_device(jfw, jprops)
    for found in itertools.product([False, True], repeat=len(props)):
        bits = sum(1 << i for i, f in enumerate(found) if f)
        ours = (fw_all != 0 and bits & fw_all == fw_all) or bits & fw_any != 0
        want = bool(jax_matched(jnp.asarray(found, dtype=bool)))
        assert ours == want, (kind, expectations, names, found)
