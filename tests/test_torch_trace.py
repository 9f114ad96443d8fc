"""The port's traced mode against the JAX engine's, on the CPU.

``spawn_gpu(trace=True, device="cpu")`` and the JAX package's
``spawn_tpu(trace=True)`` run the same model at the same arguments: counts,
row logs, parents, ebits, discoveries, ``discovered_fingerprints()``, the
visitor stream, each traced wave's ``probe_rounds`` and the journal's
schema (``wave_breakdown``, ``bytes``, ``hbm_util_frac``,
``trace_summary``) must agree.  The roofline table, the tracer, the
histograms, K4's round count and K25's twin are held against the JAX
package's on the same inputs.  The JAX runs are shared through module
fixtures.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stateright_tpu.actor import Network as JNetwork  # noqa: E402
from stateright_tpu.core.visitor import StateRecorder as JStateRecorder  # noqa: E402
from stateright_tpu.models import paxos as jpaxos  # noqa: E402
from stateright_tpu.models.fixtures import TrapCounter as JTrapCounter  # noqa: E402
from stateright_tpu.models.twophase import TwoPhaseSys as JTwoPhaseSys  # noqa: E402
from stateright_tpu.obs import metrics as jmetrics  # noqa: E402
from stateright_tpu.obs import roofline as jroofline  # noqa: E402
from stateright_tpu.obs.trace import WaveTracer as JWaveTracer  # noqa: E402
from stateright_tpu.parallel import hashset as jhashset  # noqa: E402
from stateright_tpu.runtime.journal import read_journal as jax_read_journal  # noqa: E402
from stateright_tpu_torch.actor import Network  # noqa: E402
from stateright_tpu_torch.core.visitor import StateRecorder  # noqa: E402
from stateright_tpu_torch.models.fixtures import TrapCounter  # noqa: E402
from stateright_tpu_torch.models.paxos import PaxosModelCfg  # noqa: E402
from stateright_tpu_torch.models.twophase import TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.obs import metrics, roofline  # noqa: E402
from stateright_tpu_torch.obs.trace import PHASE_ORDER, WaveTracer  # noqa: E402
from stateright_tpu_torch.parallel.append import append_block, append_block_plain  # noqa: E402
from stateright_tpu_torch.parallel.hashset import HashSet, insert_batch_claim  # noqa: E402
from stateright_tpu_torch.parallel.wave_common import compact  # noqa: E402
from stateright_tpu_torch.parallel.wavefront import wave_bytes  # noqa: E402
from stateright_tpu_torch.runtime.journal import read_journal  # noqa: E402

GEOMETRY = dict(capacity=1 << 14, max_frontier=1 << 9)
PAXOS_GEOMETRY = dict(capacity=1 << 14, max_frontier=1 << 4)
# The phases of an in-HBM traced wave.
PHASES = {"step", "canon", "dedup", "append", "readback"}
# Summary fields that name the device or its peak, not the run.
PEAK_FIELDS = ("engine", "device_kind", "hbm_peak_bytes_per_sec",
               "hbm_peak_estimated", "hbm_util_frac")


def _logs(checker, path):
    checker.save_snapshot(str(path))
    with np.load(path) as snap:
        tail = int(snap["tail"])
        w = snap["rows"].shape[0] // snap["parent"].shape[0]
        return (snap["rows"][: w * tail].copy(), snap["parent"][:tail].copy(),
                snap["ebits"][:tail].copy())


def _run_pair(tmp, name, jax_builder, port_builder, geometry, visitor=False):
    """One traced JAX run and one traced port run of the same model at
    ``geometry`` (with a StateRecorder each when ``visitor``): the
    checkers, their journals, logs and visit streams."""
    out = {}
    for side, builder, read, spawn in (
        ("jax", jax_builder, jax_read_journal, "spawn_tpu"),
        ("port", port_builder, read_journal, "spawn_gpu"),
    ):
        journal = str(tmp / f"{name}-{side}.jsonl")
        b = builder()
        rec = None
        if visitor:
            rec, states = (JStateRecorder if side == "jax" else StateRecorder).new_with_accessor()
            b = b.visitor(rec)
        kw = dict(geometry, trace=True, journal=journal)
        if side == "port":
            kw["device"] = "cpu"
        ck = getattr(b, spawn)(**kw).join()
        out[side] = dict(
            checker=ck, events=read(journal),
            logs=_logs(ck, tmp / f"{name}-{side}.npz"),
            visits=states() if visitor else None,
        )
    return out


@pytest.fixture(scope="module")
def rm3(tmp_path_factory):
    return _run_pair(
        tmp_path_factory.mktemp("rm3"), "rm3",
        lambda: JTwoPhaseSys(rm_count=3).checker(),
        lambda: TwoPhaseSys(rm_count=3).checker(), GEOMETRY, visitor=True,
    )


@pytest.fixture(scope="module")
def paxos1(tmp_path_factory):
    return _run_pair(
        tmp_path_factory.mktemp("paxos1"), "paxos1",
        lambda: jpaxos.PaxosModelCfg(
            1, 3, JNetwork.new_unordered_nonduplicating()).into_model().checker(),
        lambda: PaxosModelCfg(
            1, 3, Network.new_unordered_nonduplicating()).into_model().checker(),
        PAXOS_GEOMETRY,
    )


def _waves(events):
    return [e for e in events if e["event"] == "wave"]


def _same_run(pair):
    j, p = pair["jax"], pair["port"]
    jc, pc = j["checker"], p["checker"]
    assert (pc.unique_state_count(), pc.state_count(), pc.max_depth()) == (
        jc.unique_state_count(), jc.state_count(), jc.max_depth())
    for a, b in zip(p["logs"], j["logs"]):
        assert np.array_equal(a, b)
    assert np.array_equal(pc.discovered_fingerprints(), jc.discovered_fingerprints())
    assert sorted(pc.discoveries()) == sorted(jc.discoveries())
    for name, path in jc.discoveries().items():
        assert _fps(pc, pc.discoveries()[name].into_states()) == _fps(
            jc, path.into_states())


def _fps(checker, states):
    """Host fingerprints of ``states`` under ``checker``'s model (the two
    packages' state classes differ; their fingerprints agree)."""
    return [checker.model().fingerprint(s) for s in states]


def _traced_journal(events):
    """Every wave event of a traced in-HBM run is a committed traced wave
    whose breakdown covers its call time over exactly the five phases; the
    run ends with its summary."""
    waves = _waves(events)
    assert waves
    for w in waves:
        assert w["flags"] == 0
        assert set(w["wave_breakdown"]) == PHASES
        assert set(w["bytes"]) == PHASES - {"readback"}
        assert sum(w["wave_breakdown"].values()) >= 0.9 * w["call_sec"]
        assert 0 <= w["density"] <= 1.0 and w["hbm_util_frac"] >= 0
    kinds = [e["event"] for e in events]
    assert kinds[-2:] == ["trace_summary", "engine_done"]
    return waves


def test_roofline_peaks_and_models(monkeypatch):
    cpu = roofline.peaks_for_device("cpu")
    assert cpu["estimated"] and cpu["hbm_bytes_per_sec"] == 2.0e10
    assert cpu["device_kind"] == "cpu" and cpu["platform"] == "cpu"
    cards = {
        "NVIDIA H100 80GB HBM3": 3.35e12, "NVIDIA H100 PCIe": 2.0e12,
        "NVIDIA H100 NVL": 3.9e12, "NVIDIA A100-SXM4-80GB": None,
    }
    for name, peak in cards.items():
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None, n=name: n)
        got = roofline.peaks_for_device(torch.device("cuda", 0))
        assert got["device_kind"] == name and got["platform"] == "gpu"
        if peak is None:
            assert got["estimated"] and got["hbm_bytes_per_sec"] == 2.0e10
        else:
            assert not got["estimated"] and got["hbm_bytes_per_sec"] == peak
    # The kept JAX formulas; the port's radix sort and slot terms.
    for lanes, rounds in ((0, 3), (1000, 0), (12345, 7)):
        assert roofline.probe_bytes(lanes, rounds) == jroofline.probe_bytes(lanes, rounds)
        assert roofline.copy_bytes(lanes, 5) == jroofline.copy_bytes(lanes, 5)
    assert roofline.hbm_util_frac(1e9, 0.5, 2e9) == jroofline.hbm_util_frac(1e9, 0.5, 2e9)
    assert roofline.hbm_util_frac(1e9, 0.0, 2e9) == 0.0
    assert roofline.sort_bytes(1000) == (8 + 8 * 2 * 12) * 1000
    assert roofline.slot_bytes(10) == 80


def test_wave_tracer_matches_jax():
    records = [
        ({"step": 0.5, "canon": 0.25, "dedup": 1.0, "append": 0.125,
          "readback": 0.0625}, {"step": 4096, "canon": 1024, "dedup": 8192,
                                "append": 512}, {"probe_rounds": 3}),
        ({"step": 0.25, "canon": 0.5, "dedup": 0.5, "cold_probe": 0.75,
          "append": 0.25, "readback": 0.125}, {"step": 100, "canon": 200,
                                               "dedup": 300, "append": 400},
         {"probe_rounds": 2}),
    ]
    ours = WaveTracer("cpu", "gpu-wavefront")
    theirs = JWaveTracer(jax.devices("cpu")[0], "tpu-wavefront")
    for phases, nbytes, extra in records:
        a = ours.record_wave(phases, nbytes, **extra)
        b = theirs.record_wave(phases, nbytes, **extra)
        assert a == b
    a, b = ours.summary(), theirs.summary()
    assert a["bottleneck_phase"] == "dedup"
    assert {k: v for k, v in a.items() if k not in PEAK_FIELDS} == {
        k: v for k, v in b.items() if k not in PEAK_FIELDS}
    assert set(a) == set(b)
    assert PHASE_ORDER == ("step", "canon", "dedup", "exchange", "cold_probe",
                           "append", "readback")


def test_histograms_match_jax():
    rng = np.random.default_rng(7)
    values = rng.exponential(0.05, 200).tolist() + [0.0, 500.0]
    ours, theirs = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    for v in values:
        ours.observe("wave_latency_sec", v)
        theirs.observe("wave_latency_sec", v)
        ours.observe("valid_density", v / 100, count=3,
                     boundaries=metrics.FRACTION_BUCKETS)
        theirs.observe("valid_density", v / 100, count=3,
                       boundaries=jmetrics.FRACTION_BUCKETS)
    snap = ours.snapshot_histograms()
    assert snap == theirs.snapshot_histograms()
    assert metrics.merge_histogram_snapshots(snap, snap) == (
        jmetrics.merge_histogram_snapshots(snap, snap))
    with pytest.raises(ValueError, match="ascending"):
        metrics.Histogram([1, 1])
    assert (metrics.LATENCY_BUCKETS, metrics.COUNT_BUCKETS,
            metrics.FRACTION_BUCKETS) == (
        jmetrics.LATENCY_BUCKETS, jmetrics.COUNT_BUCKETS,
        jmetrics.FRACTION_BUCKETS)


def test_traced_2pc_matches_jax(rm3):
    """TwoPhaseSys(rm_count=3), 288 states: logs, counts, discoveries,
    fingerprints, the traced journal and each wave's probe rounds."""
    _same_run(rm3)
    pc, jc = rm3["port"]["checker"], rm3["jax"]["checker"]
    assert pc.unique_state_count() == 288
    waves = _traced_journal(rm3["port"]["events"])
    jwaves = _waves(rm3["jax"]["events"])
    assert len(waves) == len(jwaves)
    # (The density's denominator follows the JAX step rung, which its
    # tuner moves; the port has no tuner.)
    keys = ("waves", "remaining", "unique", "states", "depth", "tail",
            "occupancy", "probe_rounds")
    assert [{k: w[k] for k in keys} for w in waves] == [
        {k: w[k] for k in keys} for w in jwaves]
    summary = pc.trace_summary()
    assert set(summary) - {"probe_slots"} == set(jc.trace_summary())
    assert summary["traced_waves"] == len(waves)
    assert summary["probe_rounds"] == jc.trace_summary()["probe_rounds"]
    assert summary["engine"] == "gpu-wavefront"
    assert summary["hbm_peak_estimated"] and summary["device_kind"] == "cpu"
    assert summary["bottleneck_phase"] in PHASES - {"readback"}
    m = pc.metrics()
    assert m["trace"] and m["trace_summary"]["traced_waves"] == len(waves)
    last = rm3["port"]["events"][-2]
    assert last["event"] == "trace_summary" and last["traced_waves"] == len(waves)


def test_visitor_stream_matches_jax(rm3):
    """Each expanded state once, as JAX's stream, in level-monotone (here
    log) order."""
    ours = _fps(rm3["port"]["checker"], rm3["port"]["visits"])
    theirs = _fps(rm3["jax"]["checker"], rm3["jax"]["visits"])
    assert len(ours) == len(set(ours)) == len(theirs) == 288
    assert set(ours) == set(theirs)
    model = TwoPhaseSys(rm_count=3)
    rows = rm3["port"]["logs"][0].reshape(-1, 2)
    cm = model.compiled()
    assert ours == [model.fingerprint(cm.decode(r)) for r in rows]


def test_traced_paxos_two_phase_matches_jax(paxos1):
    """Paxos c=1 runs two-phase: the logs agree, and so does each wave's
    canon term (K1 hashes the whole buffer, as the JAX program does)."""
    _same_run(paxos1)
    pc = paxos1["port"]["checker"]
    assert pc._two_phase
    waves = _traced_journal(paxos1["port"]["events"])
    # Compare the waves the JAX engine ran before its tuner first moved a
    # rung (a second ``geometry`` event; its metrics() then show the
    # pinned rung): until then its buffer is the full U, the port's.
    jevents = paxos1["jax"]["events"]
    kinds = [e["event"] for e in jevents]
    geo = [i for i, k in enumerate(kinds) if k == "geometry"]
    assert jevents[geo[0]]["sort_lanes"] == pc._sort_width()
    full = _waves(jevents[: geo[1]] if len(geo) > 1 else jevents)
    if len(geo) > 1:
        jm = paxos1["jax"]["checker"].metrics()
        assert jm["sort_lanes_rung"] or jm["step_lanes_rung"]
    assert len(full) >= 8
    assert [w["probe_rounds"] for w in waves[: len(full)]] == [
        w["probe_rounds"] for w in full]
    # On a full chunk the port's buffer is the JAX program's U.
    chunks = _chunks(pc, waves)
    same = [i for i in range(len(full)) if chunks[i] == pc._max_frontier]
    assert len(same) >= 2
    assert [waves[i]["bytes"]["canon"] for i in same] == [
        full[i]["bytes"]["canon"] for i in same]


def _chunks(ck, waves):
    """Each traced wave's chunk (the states it expanded), from the level
    left before it; the first level is the unique init states."""
    left = ck._compiled.init_packed().shape[0]
    out = []
    for w in waves:
        out.append(min(left, ck._max_frontier))
        left = w["remaining"]
    return out


@pytest.mark.parametrize("pair", ["rm3", "paxos1"])
def test_wave_bytes_follow_the_port_formula(pair, request):
    """Every traced wave's bytes are :func:`wave_bytes` at that wave's
    counts, read back from the journal: the chunk from the level left
    before it, valid lanes from the states it added, new states from the
    tail it moved."""
    run = request.getfixturevalue(pair)
    ck = run["port"]["checker"]
    cm = ck._compiled
    waves = _waves(run["port"]["events"])
    init = cm.init_packed().shape[0]
    states, tail = init, init
    for w, count in zip(waves, _chunks(ck, waves)):
        n_new = w["tail"] - tail
        want = wave_bytes(
            count=count, a=cm.max_actions, w=cm.state_width,
            fpw=cm.fp_words or cm.state_width, n_props=len(ck._properties),
            u=min(ck._sort_width(), count * cm.max_actions),
            n_valid=w["states"] - states,
            n_inserted=n_new, n_new=n_new, probe_slots=w["probe_slots"],
            two_phase=ck._two_phase, sortless=ck._sortless, symmetric=False,
        )
        assert w["bytes"] == want
        states, tail = w["states"], w["tail"]


def test_traced_trap_counter_eventually_discoveries(tmp_path):
    geometry = dict(capacity=1 << 10, max_frontier=1 << 4)
    run = _run_pair(tmp_path, "trap", lambda: JTrapCounter(trap_at=2).checker(),
                    lambda: TrapCounter(trap_at=2).checker(), geometry)
    _same_run(run)
    assert sorted(run["port"]["checker"].discoveries()) == ["reaches limit", "trapped"]
    _traced_journal(run["port"]["events"])


def test_traced_auto_grow_visits_each_state_once(tmp_path):
    """A traced run from 256 slots grows; its flagged waves visit nothing,
    so each of the 288 states is visited once, and the result is the
    untraced run's."""
    rec, states = StateRecorder.new_with_accessor()
    journal = str(tmp_path / "grow.jsonl")
    ck = TwoPhaseSys(rm_count=3).checker().visitor(rec).spawn_gpu(
        device="cpu", capacity=1 << 8, max_frontier=1 << 6,
        journal=journal).join()
    plain = TwoPhaseSys(rm_count=3).checker().spawn_gpu(
        device="cpu", capacity=1 << 8, max_frontier=1 << 6).join()
    visits = states()
    assert len(visits) == len(set(visits)) == 288
    assert ck.metrics()["grows"] >= 1 and ck.metrics()["trace"]
    assert np.array_equal(ck.discovered_fingerprints(), plain.discovered_fingerprints())
    events = read_journal(journal)
    flagged = [w for w in _waves(events) if w["flags"]]
    assert flagged and all("wave_breakdown" not in w for w in flagged)
    assert "waves_per_grow" in ck.metrics()["histograms"]
    with pytest.raises(RuntimeError, match="fingerprint table overfull"):
        TwoPhaseSys(rm_count=3).checker().spawn_gpu(
            device="cpu", capacity=1 << 8, max_frontier=1 << 6, trace=True,
            auto_tune=False).join()


def test_trace_with_resume_raises_and_untraced_has_no_summary():
    with pytest.raises(ValueError, match=r"spawn_gpu\(trace=True\) does not support resume_from"):
        TwoPhaseSys(rm_count=3).checker().spawn_gpu(
            device="cpu", trace=True, resume_from="never-read.npz")
    ck = TwoPhaseSys(rm_count=3).checker().spawn_gpu(device="cpu", **GEOMETRY).join()
    assert not ck.metrics()["trace"] and "trace_summary" not in ck.metrics()
    with pytest.raises(RuntimeError, match="requires spawn_gpu"):
        ck.trace_summary()


def test_histogram_keys_match_jax(rm3, tmp_path):
    """The vitals' histogram keys, traced and untraced (both untraced
    loops also time their density tuners, ``host_retune_sec``)."""
    traced = rm3["port"]["checker"].metrics()["histograms"]
    assert set(traced) == set(rm3["jax"]["checker"].metrics()["histograms"])
    journal = str(tmp_path / "untraced.jsonl")
    ours = TwoPhaseSys(rm_count=3).checker().spawn_gpu(
        device="cpu", waves_per_call=1, journal=journal, **GEOMETRY).join().metrics()
    theirs = JTwoPhaseSys(rm_count=3).checker().spawn_tpu(
        waves_per_call=1, journal=str(tmp_path / "jax.jsonl"),
        **GEOMETRY).join().metrics()
    assert set(ours["histograms"]) == set(theirs["histograms"])
    for key in ("valid_density_ema", "uniq_per_sec_ema", "waves_per_sec_ema",
                "host_sec_total"):
        assert key in ours and key in theirs
    waves = _waves(read_journal(journal))
    assert waves and all(0 < w["density"] <= 1.0 for w in waves)
    spans = [e for e in read_journal(journal) if e["event"] == "host_span"]
    assert len(spans) == len(waves)
    assert all("readback" in s["call_spans"] for s in spans)


def test_probe_rounds_match_jax_with_rounds():
    """K4's twin counts the JAX claim rounds, main and straggler rounds
    together, on a batch wider than the 16K-lane straggler buffer."""
    rng = np.random.default_rng(11)
    cap, n = 1 << 17, 40_000
    pool = rng.integers(1, 1 << 63, size=n // 2, dtype=np.uint64)
    pre = pool[: 30_000]
    keys = rng.choice(pool, size=n)
    active = rng.random(n) < 0.8
    hi, lo = (keys >> np.uint64(32)).astype(np.uint32), keys.astype(np.uint32)
    pre_hi, pre_lo = (pre >> np.uint64(32)).astype(np.uint32), pre.astype(np.uint32)
    table = HashSet.empty(cap, "cpu")
    t = lambda a: torch.from_numpy(a.view(np.int32).copy())  # noqa: E731
    insert_batch_claim(table, t(pre_hi), t(pre_lo), torch.ones(len(pre), dtype=torch.bool))
    jt = jhashset.make_hashset(cap)
    jt = jhashset.insert_batch_claim(jt, jnp.asarray(pre_hi), jnp.asarray(pre_lo),
                                     jnp.ones(len(pre), bool))[0]
    new, ok, probe = insert_batch_claim(table, t(hi), t(lo), torch.from_numpy(active),
                                        with_rounds=True)
    out = jhashset.insert_batch_claim(jt, jnp.asarray(hi), jnp.asarray(lo),
                                      jnp.asarray(active), with_rounds=True)
    assert bool(ok) and bool(out[5])
    assert np.array_equal(new.numpy(), np.asarray(out[2]))
    assert int(probe[0]) == int(out[-1]) > 1
    assert int(probe[1]) >= int(active.sum())


@pytest.mark.parametrize("path", ["claim", "two_phase", "sorted"])
def test_append_twin_matches_jax_t_append(rm3, path):
    """K25's twin against the JAX traced ``append`` program on one wave's
    seeded inputs, put into the port's layout: single-phase waves keep all
    B candidate rows and index them through ``v_orig``; the JAX program
    takes the buffer's rows already gathered."""
    jc = rm3["jax"]["checker"]
    t_append = jc._build_traced()["append"]
    cm = jc._compiled
    w, a = cm.state_width, cm.max_actions
    f = jc._max_frontier
    u = jc._sort_width()
    pad = jc._block_pad()
    rng = np.random.default_rng({"claim": 1, "two_phase": 2, "sorted": 3}[path])
    b = f * a
    nexts = rng.integers(0, 1 << 32, size=(b, w), dtype=np.uint32)
    n_valid = u // 3
    v_orig = np.zeros(u, np.uint32)
    v_orig[:n_valid] = np.sort(rng.choice(b, size=n_valid, replace=False))
    u_new = np.zeros(u, bool)
    u_new[:n_valid] = rng.random(n_valid) < 0.6
    u_origin = (np.arange(u, dtype=np.uint32) if path != "sorted"
                else rng.permutation(u).astype(np.uint32))
    eb = rng.integers(0, 1 << 32, size=f, dtype=np.uint32)
    qcap, level_start, tail = 4096, 300, 1000
    rows0 = rng.integers(0, 1 << 32, size=(qcap + pad) * w, dtype=np.uint32)
    parent0 = rng.integers(0, 1 << 32, size=qcap + pad, dtype=np.uint32)
    ebits0 = rng.integers(0, 1 << 32, size=qcap + pad, dtype=np.uint32)
    gathered = nexts[v_orig]
    rows, parent, ebits = (np.asarray(x) for x in t_append(
        jnp.asarray(rows0), jnp.asarray(parent0), jnp.asarray(ebits0),
        jnp.asarray(gathered), jnp.asarray(v_orig // np.uint32(a)),
        jnp.asarray(eb), jnp.asarray(u_new), jnp.asarray(u_origin),
        jnp.uint32(level_start), jnp.uint32(tail)))
    n_new = int(u_new.sum())

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x).view(np.int32).copy())

    p_rows, p_parent, p_ebits = t(rows0), t(parent0), t(ebits0)
    sel, count = compact(torch.from_numpy(u_new), u)
    assert int(count) == n_new
    two_phase = path == "two_phase"
    append_block(p_rows, p_parent, p_ebits, sel,
                 None if path != "sorted" else t(u_origin), t(v_orig),
                 t(gathered if two_phase else nexts).view(-1, w), t(eb),
                 level_start, tail, n_new, a, two_phase)
    end = tail + n_new
    for got, want, width in ((p_rows, rows, w), (p_parent, parent, 1),
                             (p_ebits, ebits, 1)):
        got = got.numpy().view(np.uint32)
        assert np.array_equal(got[: end * width], want[: end * width])
    # The twin writes nothing past the new states.
    assert np.array_equal(p_rows.numpy().view(np.uint32)[end * w:], rows0[end * w:])
    # The wrapper runs the twin for CPU tensors.
    q_rows, q_parent, q_ebits = t(rows0), t(parent0), t(ebits0)
    append_block_plain(q_rows, q_parent, q_ebits, sel,
                       None if path != "sorted" else t(u_origin), t(v_orig),
                       t(gathered if two_phase else nexts).view(-1, w), t(eb),
                       level_start, tail, n_new, a, two_phase)
    assert torch.equal(q_rows, p_rows) and torch.equal(q_parent, p_parent)


def test_profile_ranges_name_waves_and_host_spans(tmp_path):
    """With ``set_profile(True)`` each wave runs in a ``wave_quantum``
    range and each host-tail span in a ``host/<phase>`` range of the torch
    profiler (the JAX package's xprof names); off (the default) the hooks
    add no range."""
    from stateright_tpu_torch.obs import timeline

    def names(profile):
        timeline.set_profile(profile)
        try:
            # The loop runs on the checker's own thread.
            with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU],
                experimental_config=torch._C._profiler._ExperimentalConfig(
                    profile_all_threads=True),
            ) as prof:
                TwoPhaseSys(rm_count=3).checker().spawn_gpu(
                    device="cpu", journal=str(tmp_path / f"{profile}.jsonl"),
                    **GEOMETRY).join()
        finally:
            timeline.set_profile(False)
        return {e.key for e in prof.key_averages()}

    ranges = {"wave_quantum", "host/journal"}
    assert ranges <= names(True)
    assert not ranges & names(False)
