"""The four re-check modes behind one call: ``incremental_check``.

The counterpart of ``stateright_tpu/incr/recheck.py``.  Given a configured
:class:`~..core.checker.CheckerBuilder` and a store directory, classify the
spec delta against the store and run the cheapest sound path
(``incr/store.py`` documents the modes and the soundness gates):

- identical spec: the stored verdict, with no kernel launched;
- property-only change: the new properties over the stored row log on the
  card -- the model's conds kernel, then K22 (:func:`first_hits`) -- with
  no exploration wave;
- constant widening: ``spawn_gpu`` resumed from the stored snapshot made
  level 0, so only the newly admitted region explores;
- anything else: a plain ``spawn_gpu`` run, recorded.

Every decision journals the JAX package's ``incr_*`` events with its
fields (``incr_classified``, ``incr_verdict_hit``,
``incr_property_recheck``, ``incr_seeded``, ``incr_stored``,
``incr_store_skipped``).  The verdict cache and the property re-eval return
:class:`StoredVerdictChecker` over the stored data, with the full reporting
surface (counts, discoveries with re-executed paths, assert helpers).

:func:`first_hits` launches ``csrc/recheck.cu`` on a CUDA tensor and runs
:func:`first_hits_plain`, its twin, on a CPU tensor.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.checker import Checker
from ..core.model import Expectation
from ..core.path import Path
from ..ops import cuda
from ..ops.u32 import from_numpy_u32
from .spec_hash import SpecFingerprint
from .store import (
    COLD, CONSTANT_WIDENING, IDENTICAL, PROPERTY_ONLY, StoreEntry,
    VerificationStore,
)

NO_SLOT = 0xFFFFFFFF

# Rows per chunk of the property re-eval: the conds kernel and K22 run once
# a chunk, and the slots are read back once a chunk, to stop as soon as
# every property has one.  The slots do not depend on the chunk.
PROPEVAL_CHUNK = 1 << 20


def first_hits_plain(conds: torch.Tensor, n: int, always: int,
                     sometimes: int, start: int) -> torch.Tensor:
    """Plain-torch twin of K22 (any device): for each property ``p`` of
    ``conds`` (``bool[R, P]``, rows ``[0, n)`` counted), the lowest position
    ``start + s`` whose cond fails (bit ``p`` of ``always``) or holds (bit
    ``p`` of ``sometimes``); ``NO_SLOT`` where none does.  ``int64[P]``."""
    dev = conds.device
    p = conds.shape[1]
    if n == 0:
        return torch.full((p,), NO_SLOT, dtype=torch.int64, device=dev)
    bits = torch.tensor([1 << q for q in range(p)], dtype=torch.int64, device=dev)
    c = conds[:n]
    hit = (((always & bits) != 0) & ~c) | (((sometimes & bits) != 0) & c)
    pos = torch.arange(start, start + n, dtype=torch.int64, device=dev)
    none = torch.full((), NO_SLOT, dtype=torch.int64, device=dev)
    return torch.where(hit, pos.unsqueeze(1), none).min(dim=0).values


def first_hits(conds: torch.Tensor, n: int, always: int, sometimes: int,
               start: int) -> torch.Tensor:
    """The first triggering position of each property over a chunk of
    conds (K22): see :func:`first_hits_plain`."""
    if not 0 <= n <= conds.shape[0]:
        raise ValueError(f"n={n} outside the chunk's {conds.shape[0]} rows")
    if start < 0 or start + n > NO_SLOT:
        raise ValueError("positions must stay below NO_SLOT (2**32 - 1)")
    if conds.device.type == "cpu":
        return first_hits_plain(conds, n, always, sometimes, start)
    dev = conds.device
    cuda.require(conds, "conds", torch.bool, 2, dev)
    p = conds.shape[1]
    if p > 32:
        raise ValueError("at most 32 properties")
    slots = torch.full((p,), NO_SLOT, dtype=torch.int64, device=dev)
    if n == 0 or p == 0:
        return slots
    fn = cuda.function(
        "recheck", "sr_first_hits",
        [cuda.P, cuda.I64, cuda.I32, cuda.U32, cuda.U32, cuda.I64, cuda.P,
         cuda.P],
    )
    first_hits.launches += 1
    code = fn(cuda.ptr(conds), n, p, always, sometimes, start,
              cuda.ptr(slots), cuda.stream(conds))
    cuda.check(code, "recheck", "first_hits")
    return slots


first_hits.launches = 0


class StoredVerdictChecker(Checker):
    """A completed verdict served from the store.  Counts and verdicts come
    from the verdict record; discovery paths re-execute the host model
    along the stored fingerprint chains on first access (host work, no
    device at all)."""

    def __init__(self, model, entry: StoreEntry,
                 recheck_mode: str = IDENTICAL,
                 discoveries: Optional[Dict[str, Path]] = None):
        super().__init__(model)
        self._entry = entry
        self._summary = entry.summary
        self._recheck_mode = recheck_mode
        self._paths = discoveries
        self._lock = threading.Lock()

    def state_count(self) -> int:
        return int(self._summary.get("state_count", 0))

    def unique_state_count(self) -> int:
        return int(self._summary.get("unique_state_count", 0))

    def max_depth(self) -> int:
        return int(self._summary.get("max_depth", 0))

    def discoveries(self) -> Dict[str, Path]:
        with self._lock:
            if self._paths is None:
                self._paths = {
                    name: Path.from_fingerprints(self._model, d["fingerprints"])
                    for name, d in self._summary.get("discoveries", {}).items()
                }
            return dict(self._paths)

    def discovered_fingerprints(self) -> np.ndarray:
        """The stored reachable set (the entry's sorted runs on disk)."""
        return self._entry.fingerprints()

    def is_done(self) -> bool:
        return True

    def join(self) -> "StoredVerdictChecker":
        return self

    def metrics(self) -> dict:
        out = super().metrics()
        out.update(
            engine="incr-verdict-cache",
            recheck_mode=self._recheck_mode,
            store_entry=self._entry.entry_id,
        )
        return out


def _walk_parent_chain(model, cm, rows: np.ndarray, parents: np.ndarray,
                       slot: int) -> Path:
    """The path to ``slot`` over the stored logs: BFS positions only ever
    point at earlier ones, so the chain is a backward scan of two host
    arrays."""
    chain = []
    s = int(slot)
    while s != NO_SLOT and len(chain) <= parents.shape[0]:
        chain.append(s)
        s = int(parents[s])
    chain.reverse()
    fps = [model.fingerprint(cm.decode(rows[i])) for i in chain]
    return Path.from_fingerprints(model, fps)


def _property_recheck(spec: SpecFingerprint, entry: StoreEntry, journal,
                      device, chunk: int = PROPEVAL_CHUNK
                      ) -> StoredVerdictChecker:
    """Mode (b): the new property set over the stored row log.  Per chunk
    of ``chunk`` rows, the model's ``property_conds`` (its conds kernel)
    and K22 give each pending ALWAYS or SOMETIMES property's lowest
    triggering position; the slots are read back once a chunk.  The engine
    evaluates properties as it expands positions in order and keeps the
    first hit, so a cold run's discovery of such a property is exactly
    that lowest position."""
    t0 = time.monotonic()
    cm = spec.compiled
    model = spec.model
    props = model.properties()
    w = cm.state_width
    with np.load(entry.snapshot_path, allow_pickle=False) as snap:
        tail = int(snap["tail"])
        rows = np.asarray(snap["rows"], np.uint32)[: tail * w].reshape(tail, w)
        parents = np.asarray(snap["parent"], np.uint32)[:tail]

    pending = {
        i: p for i, p in enumerate(props)
        if p.expectation is not Expectation.EVENTUALLY
    }
    slots: Dict[str, int] = {}
    dispatches = 0
    rows_d = from_numpy_u32(rows, device) if pending else None
    for off in range(0, tail, chunk):
        if not pending:
            break
        n = min(chunk, tail - off)
        conds = cm.property_conds(rows_d[off:off + n])
        always = sum(1 << i for i, p in pending.items()
                     if p.expectation is Expectation.ALWAYS)
        sometimes = sum(1 << i for i, p in pending.items()
                        if p.expectation is Expectation.SOMETIMES)
        hits = first_hits(conds, n, always, sometimes, off).tolist()
        dispatches += 1
        for i in list(pending):
            if hits[i] != NO_SLOT:
                slots[pending.pop(i).name] = int(hits[i])
    del rows_d

    paths = {
        name: _walk_parent_chain(model, cm, rows, parents, slot)
        for name, slot in slots.items()
    }
    sec = time.monotonic() - t0
    if journal is not None:
        journal.append(
            "incr_property_recheck",
            entry=entry.entry_id,
            rows=tail,
            dispatches=dispatches,
            discoveries=sorted(slots),
            sec=round(sec, 4),
        )
    # The re-check rides the stored counts (the reachable set is
    # property-independent for rows-reusable entries) with the fresh
    # discovery paths; the derived verdict record is built by the store's
    # one summary builder (record_derived).
    synthetic = StoreEntry(entry.path, dict(entry.record))
    synthetic.record["summary"] = {
        "state_count": entry.summary.get("state_count", 0),
        "unique_state_count": entry.summary.get("unique_state_count", 0),
        "max_depth": entry.summary.get("max_depth", 0),
    }
    return StoredVerdictChecker(
        model, synthetic, recheck_mode=PROPERTY_ONLY, discoveries=paths,
    )


def _seeded_snapshot(entry: StoreEntry, out_path: str) -> int:
    """Mode (c)'s snapshot: the stored completed snapshot with the whole
    reachable set made level 0 of a resumed run (level_start 0, level_end
    tail, depth 0, discoveries cleared), the row log, parents and table
    carried over verbatim.  The resumed engine re-expands every stored
    state: successors inside the old set dedup against the carried table,
    and only the newly admitted region explores.  Returns the seeded state
    count."""
    with np.load(entry.snapshot_path, allow_pickle=False) as snap:
        data = {k: snap[k] for k in snap.files}
    tail = int(data["tail"])
    data["level_start"] = np.uint32(0)
    data["level_end"] = np.uint32(tail)
    data["depth"] = np.uint32(0)
    data["disc"] = np.full_like(np.asarray(data["disc"]), NO_SLOT)
    tmp = f"{out_path}.tmp"
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, **data)
    os.replace(tmp, out_path)
    return tail


def _join_cancellable(checker, cancel, poll_interval: float = 0.05):
    """Join an engine run while honouring a cooperative cancel event: the
    engine winds down at its next host-side check (``request_stop``), the
    store's completeness gate refuses the partial verdict, and the caller
    sees ``stop_requested()``."""
    if cancel is None:
        return checker.join()
    while not checker.is_done():
        if cancel.is_set():
            checker.request_stop()
        time.sleep(poll_interval)
    return checker.join()


def incremental_check(
    builder,
    store_dir: str,
    engine_kwargs: Optional[dict] = None,
    journal=None,
    reuse: bool = True,
    cancel=None,
    on_spawn=None,
) -> Tuple[Checker, dict]:
    """Run one verification request through the store.

    ``builder`` is a configured CheckerBuilder (model, symmetry, bounds);
    ``engine_kwargs`` are the ``spawn_gpu`` knobs a cold or seeded run
    spawns with -- ``device`` among them (default the card; ``"cpu"`` runs
    the kernels' twins), which the property re-eval runs on too.
    ``reuse=False`` records without reusing; every request records.
    ``cancel`` (a ``threading.Event``) makes the cold
    and seeded runs cooperatively cancellable: the partial verdict is
    refused by the store's completeness gate.  ``on_spawn`` (a callable
    taking the checker) fires right after a cold or seeded run spawns.
    Returns ``(checker, info)``, the checker joined; ``info`` carries
    ``mode`` / ``reason`` / ``spec_key`` / ``entry`` / ``sec`` (and
    ``seeded_states`` after a widening)."""
    from ..ops.cuda import resolve_device
    from ..runtime.journal import as_journal

    engine_kwargs = dict(engine_kwargs or {})
    # The store owns journal and resume routing.
    for reserved in ("journal", "resume_from"):
        engine_kwargs.pop(reserved, None)
    journal = as_journal(journal)
    store = VerificationStore(store_dir, journal=journal)
    t0 = time.monotonic()
    spec = SpecFingerprint.of_builder(
        builder, engine="gpu", engine_kwargs=engine_kwargs,
    )
    delta = store.classify(spec) if reuse else None
    mode = delta.mode if delta is not None else COLD
    reason = (
        delta.reason if delta is not None
        else "store recording only (reuse disabled)"
    )
    entry = delta.entry if delta is not None else None
    if journal is not None:
        journal.append(
            "incr_classified",
            mode=mode,
            reason=reason,
            spec_key=spec.spec_key,
            entry=entry.entry_id if entry is not None else None,
            model=spec.model_label,
        )

    info = {
        "mode": mode,
        "reason": reason,
        "spec_key": spec.spec_key,
        "entry": entry.entry_id if entry is not None else None,
    }

    if mode == IDENTICAL:
        checker = StoredVerdictChecker(builder.model, entry)
        if journal is not None:
            journal.append(
                "incr_verdict_hit",
                entry=entry.entry_id,
                violation=entry.summary.get("violation"),
                unique=entry.summary.get("unique_state_count"),
            )
        info["sec"] = round(time.monotonic() - t0, 4)
        return checker, info

    if mode == PROPERTY_ONLY:
        device = resolve_device(engine_kwargs.get("device"),
                                "incremental_check()")
        checker = _property_recheck(spec, entry, journal, device)
        info["sec"] = round(time.monotonic() - t0, 4)
        store.record_derived(
            spec, checker, entry, engine_kwargs=engine_kwargs,
            elapsed_sec=info["sec"],
        )
        return checker, info

    if mode == CONSTANT_WIDENING:
        seed_path = os.path.join(
            store.store_dir,
            f"seed-{os.getpid()}-{threading.get_ident()}-"
            f"{spec.spec_key[:8]}.npz",
        )
        seeded_states = _seeded_snapshot(entry, seed_path)
        if journal is not None:
            journal.append(
                "incr_seeded",
                entry=entry.entry_id,
                seeded_states=seeded_states,
            )
        try:
            checker = builder.spawn_gpu(
                resume_from=seed_path, journal=journal, **engine_kwargs
            )
            if on_spawn is not None:
                on_spawn(checker)
            _join_cancellable(checker, cancel)
        finally:
            try:
                os.remove(seed_path)
            except OSError:
                pass
        info["seeded_states"] = seeded_states
        info["sec"] = round(time.monotonic() - t0, 4)
        store.record(
            spec, checker, engine_kwargs=engine_kwargs,
            recheck_mode=CONSTANT_WIDENING,
            elapsed_sec=info["sec"], seeded=True,
        )
        return checker, info

    # Cold: the ordinary engine run, journaled into the store.
    checker = builder.spawn_gpu(journal=journal, **engine_kwargs)
    if on_spawn is not None:
        on_spawn(checker)
    _join_cancellable(checker, cancel)
    info["sec"] = round(time.monotonic() - t0, 4)
    store.record(
        spec, checker, engine_kwargs=engine_kwargs,
        recheck_mode=COLD, elapsed_sec=info["sec"],
    )
    return checker, info
