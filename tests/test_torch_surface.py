"""The engine surface of ``spawn_gpu`` against the JAX engine's, on the CPU:
``metrics()``, ``tuned_kwargs()``, ``auto_tune=False``, the journal and
the checkpoint cadence.

The JAX engine runs at ``waves_per_call=1``, one wave a device call, so its
wave counts and its cadence (counted in calls) are the port's, which reads
back once a wave.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from stateright_tpu.models.twophase import TwoPhaseSys as JaxTwoPhaseSys  # noqa: E402
from stateright_tpu.runtime.journal import read_journal as jax_read_journal  # noqa: E402
from stateright_tpu_torch.models.twophase import TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.runtime.journal import read_journal  # noqa: E402

# A geometry that grows: the table (flag 1) and the explicit log (flag 2).
GROWING = dict(capacity=1 << 8, log_capacity=1 << 7, max_frontier=1 << 6)
# metrics() keys both engines report with the same value on one run.
SHARED_METRICS = (
    "done", "state_count", "unique_state_count", "max_depth",
    "table_load_factor", "capacity", "log_capacity", "max_frontier",
    "dedup_factor", "sortless", "sort_lanes", "sort_lanes_rung", "waves",
    "table_occupancy", "grows", "overflow_retries",
)
# Fields of the journal events both engines write with the same values.
EVENT_FIELDS = {
    "grow": ("flags", "unique", "depth"),
    "wave": ("waves", "remaining", "unique", "states", "depth", "flags",
             "occupancy", "tail"),
    "checkpoint": ("unique", "depth", "tail", "final"),
    "engine_done": ("unique", "states", "depth"),
}


def _events(path, read):
    return [
        (e["event"], {k: e.get(k) for k in EVENT_FIELDS[e["event"]]})
        for e in read(path) if e["event"] in EVENT_FIELDS
    ]


def test_metrics_tuned_kwargs_and_journal_match_jax(tmp_path):
    jt = JaxTwoPhaseSys(rm_count=4).checker().spawn_tpu(
        waves_per_call=1, journal=str(tmp_path / "jax.jsonl"), **GROWING).join()
    t = TwoPhaseSys(rm_count=4).checker().spawn_gpu(
        device="cpu", waves_per_call=1, journal=str(tmp_path / "port.jsonl"),
        **GROWING).join()
    m, jm = t.metrics(), jt.metrics()
    assert (m["engine"], jm["engine"]) == ("gpu-wavefront", "tpu-wavefront")
    assert {k: m[k] for k in SHARED_METRICS} == {k: jm[k] for k in SHARED_METRICS}
    assert m["grows"] >= 2 and m["unique_state_count"] == 1568
    assert t.tuned_kwargs() == jt.tuned_kwargs()
    ours = _events(tmp_path / "port.jsonl", read_journal)
    assert ours == _events(tmp_path / "jax.jsonl", jax_read_journal)
    assert [k for k, _ in ours].count("grow") == m["grows"]
    geometry = [e for e in read_journal(tmp_path / "port.jsonl")
                if e["event"] == "geometry"]
    assert len(geometry) == 1 and geometry[0]["capacity"] == GROWING["capacity"]


def test_metrics_are_readable_mid_run_and_count_the_run():
    t = TwoPhaseSys(rm_count=3).checker().spawn_gpu(device="cpu")
    early = t.metrics()  # never blocks on the running checker
    assert early["engine"] == "gpu-wavefront" and "state_count" in early
    t.join()
    m = t.metrics()
    assert m["done"] and (m["unique_state_count"], m["max_depth"]) == (288, 11)
    assert m["waves"] == t.waves()
    assert m["table_load_factor"] == round(t.table_load_factor(), 6)


def test_auto_tune_off_raises_at_the_first_overflow():
    with pytest.raises(RuntimeError, match="fingerprint table overfull"):
        JaxTwoPhaseSys(rm_count=4).checker().spawn_tpu(
            auto_tune=False, **GROWING).join()
    with pytest.raises(RuntimeError, match="fingerprint table overfull"):
        TwoPhaseSys(rm_count=4).checker().spawn_gpu(
            device="cpu", auto_tune=False, **GROWING).join()
    # The tiered engine spills on flag 1 whatever auto_tune says; its row
    # log (defaulted to the 512-slot capacity) overflows and raises.
    tiered = dict(capacity=512, max_frontier=1 << 6, auto_tune=False)
    with pytest.raises(RuntimeError, match="tiered engine overflow flags=2"):
        JaxTwoPhaseSys(rm_count=4).checker().spawn_tpu_tiered(**tiered).join()
    with pytest.raises(RuntimeError, match="tiered engine overflow flags=2"):
        TwoPhaseSys(rm_count=4).checker().spawn_gpu_tiered(
            device="cpu", **tiered).join()


def test_checkpoint_cadence_journals_and_resumes_in_both_engines(tmp_path):
    """A checkpoint every 3 committed waves plus the completion one, the
    JAX engine's at the same waves; the checkpoint of a run stopped by
    ``target_state_count`` finishes in either engine to the straight run."""
    geometry = dict(capacity=1 << 14, max_frontier=1 << 6)
    ck, jck = str(tmp_path / "ck.npz"), str(tmp_path / "jck.npz")
    cut = TwoPhaseSys(rm_count=4).checker().target_state_count(4000).spawn_gpu(
        device="cpu", checkpoint_path=ck, checkpoint_every_waves=3,
        journal=str(tmp_path / "port.jsonl"), **geometry).join()
    JaxTwoPhaseSys(rm_count=4).checker().target_state_count(4000).spawn_tpu(
        waves_per_call=1, checkpoint_path=jck, checkpoint_every_waves=3,
        journal=str(tmp_path / "jax.jsonl"), **geometry).join()
    ours = _events(tmp_path / "port.jsonl", read_journal)
    assert ours == _events(tmp_path / "jax.jsonl", jax_read_journal)
    committed = sum(1 for k, e in ours if k == "wave" and not e["flags"])
    checkpoints = [e for k, e in ours if k == "checkpoint"]
    assert len(checkpoints) == committed // 3 + 1
    assert checkpoints[-1]["final"] and not checkpoints[0]["final"]
    assert checkpoints[-1]["unique"] == cut.unique_state_count() < 1568

    straight = TwoPhaseSys(rm_count=4).checker().spawn_gpu(
        device="cpu", **geometry).join()
    want = (1568, straight.state_count(), straight.max_depth())
    fps = straight.discovered_fingerprints()
    port = TwoPhaseSys(rm_count=4).checker().spawn_gpu(
        device="cpu", resume_from=ck, **geometry).join()
    back = JaxTwoPhaseSys(rm_count=4).checker().spawn_tpu(
        resume_from=ck, **geometry).join()
    for c in (port, back):
        assert (c.unique_state_count(), c.state_count(), c.max_depth()) == want
        assert np.array_equal(c.discovered_fingerprints(), fps)
