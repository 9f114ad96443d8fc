"""The persistent verification store: entries, classification, journaling.

The counterpart of ``stateright_tpu/incr/store.py``, with the same layout
and record schema, holding the port's runs (engine ``"gpu"``, the port's
``HASH_VERSION``: a store is never shared with the JAX package).

Layout (one directory per store, safe to rsync/commit as an artifact)::

    <store_dir>/
      journal.jsonl                 # incr_* events (+ engine events when
                                    #   the CLI routes runs through here)
      index.json                    # entry index: every verdict record
                                    #   sans summary + freshness stats;
                                    #   rebuilt on any mismatch, so
                                    #   classify() never re-parses
                                    #   per-entry records as stores grow
      entries/<spec_key[:24]>/
        verdict.json                # the verdict record (see below)
        snapshot.npz                # engine snapshot: row log + parents +
                                    #   fingerprint table (rows-reusable
                                    #   entries only)
        cold/cold_run_*.npy         # the reachable set as ColdStore
                                    #   sorted uint64 runs (tiered/
                                    #   cold_store.py's format)

The snapshot is the JAX engine's npz format (``GpuChecker.save_snapshot``):
a seeded re-check resumes from it through ``spawn_gpu(resume_from=...)``.

The verdict record carries the per-component spec hashes
(incr/spec_hash.py), the raw constants (so ``spec_widens`` can compare
data, not digests), counts, per-property verdicts with counterexample
fingerprint chains, and the ROW-REUSE eligibility flag.

Row-reuse eligibility is the store's soundness gate: the property-only
and constant-widening modes treat the stored row log as *the complete
reachable set, independent of the property set* -- which holds exactly
when (a) the run drained its frontier with no stop/timeout/target
truncation and no depth bound, and (b) at least one property ended
UNDISCOVERED.  (b) is the exhaustiveness witness: the engines stop
expanding a state once every property has a discovery and the state
contributes none (K8's awaiting gate, ``parallel/wave_common.py``,
mirroring src/checker/bfs.rs:231-281), so a run whose every property
discovered may have pruned -- but a property undiscovered at the end was
undiscovered at every wave start, kept every state awaited, and forced
the full reachable set out.  Entries failing the gate still serve the
O(1) verdict cache; the reuse modes degrade loudly past them.

Writes are crash-safe by ordering: ``snapshot.npz`` and the cold runs
land first, ``verdict.json`` last via atomic write + rename -- an entry
without a verdict record does not exist to readers.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List, NamedTuple, Optional

import numpy as np

from ..tiered.cold_store import ColdStore
from .spec_hash import HASH_VERSION, SpecFingerprint

STORE_FORMAT = 1
# The entry index: one JSON file beside the entries holding every verdict
# record MINUS its summary block, plus a per-entry [mtime_ns, size]
# freshness token.  classify() scales with this file instead of re-parsing
# every verdict.json as stores grow; any mismatch with the live directory
# (names or stats) rebuilds it.
INDEX_FILE = "index.json"

# Classification modes, in preference order.
IDENTICAL = "identical"
PROPERTY_ONLY = "property_only"
CONSTANT_WIDENING = "constant_widening"
COLD = "cold"


# Serializes entry writes within this process (callers may run store jobs
# on several threads; the remove-artifacts/rewrite sequence of two writers
# hitting one spec's entry dir must not interleave).  ACROSS processes the
# last whole-entry writer wins -- every entry is independently
# re-derivable, and the verdict-last write order keeps a torn loser
# invisible rather than wrong.
_WRITE_LOCK = threading.Lock()


class Delta(NamedTuple):
    """One classification decision: the chosen mode, the donor entry
    (None for cold), and the human-readable reason journaled with it."""

    mode: str
    entry: Optional["StoreEntry"]
    reason: str


class StoreEntry:
    """One persisted run: the parsed verdict record + file handles.

    Entries served from the store's ``index.json`` carry the record
    WITHOUT its (large) ``summary`` block; ``loader`` lazily fetches
    the full ``verdict.json`` on first ``summary`` access, so the
    classification family scan never parses per-entry records while
    the one chosen donor still reads exactly one file."""

    def __init__(self, path: str, record: dict, loader=None):
        self.path = path  # entry directory
        self.record = record
        self._loader = loader  # lazy full-record fetch (index-backed)

    @property
    def entry_id(self) -> str:
        return os.path.basename(self.path)

    @property
    def components(self) -> dict:
        return self.record.get("components", {})

    @property
    def rows_reusable(self) -> bool:
        return bool(self.record.get("rows_reusable"))

    @property
    def snapshot_path(self) -> str:
        return os.path.join(self.path, "snapshot.npz")

    @property
    def summary(self) -> dict:
        if "summary" not in self.record and self._loader is not None:
            full = self._loader(self.path)
            self._loader = None
            if full is not None:
                self.record = full
        return self.record.get("summary", {})

    def fingerprints(self) -> np.ndarray:
        """The stored reachable set, sorted uint64 -- read back through
        the ColdStore run files, no device involved."""
        cold = ColdStore.open(os.path.join(self.path, "cold"))
        if not cold.runs:
            return np.zeros((0,), np.uint64)
        out = np.sort(np.concatenate([np.asarray(r) for r in cold.runs]))
        cold.close()
        return out


def _atomic_write_json(path: str, data: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(data, fh, indent=2, sort_keys=True)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _summarize(checker, model) -> dict:
    """Counts + per-property verdicts + discovery fingerprint chains --
    everything a cache hit needs to reconstruct the report and the
    counterexample paths (Path.from_fingerprints re-executes the host
    model over the chain; O(depth) host work, no device).  The
    verdict/violation rows come from the shared
    core/checker.property_verdicts, so a stored record and a serve job
    result can never disagree about the same run; only the
    fingerprint-chain encoding is local."""
    from ..core.checker import property_verdicts

    discoveries = checker.discoveries()
    props, violation = property_verdicts(checker)
    disc_out = {}
    for name, path in discoveries.items():
        disc_out[name] = {
            "classification": checker.discovery_classification(name),
            "fingerprints": [
                int(model.fingerprint(s)) for s in path.into_states()
            ],
        }
    return {
        "state_count": checker.state_count(),
        "unique_state_count": checker.unique_state_count(),
        "max_depth": checker.max_depth(),
        "properties": props,
        "discoveries": disc_out,
        "violation": violation,
    }


class VerificationStore:
    """Directory-backed store of completed verification runs."""

    def __init__(self, store_dir: str, journal=None):
        from ..runtime.journal import as_journal

        self.store_dir = os.path.abspath(store_dir)
        self.entries_dir = os.path.join(self.store_dir, "entries")
        os.makedirs(self.entries_dir, exist_ok=True)
        self.journal = as_journal(journal)
        # Per-entry verdict.json parses this instance performed -- the
        # observable evidence that classification scales with the INDEX,
        # not the store: on an index hit, classify() parses zero per-entry
        # records; only the chosen donor's lazy summary load (and the
        # exact-match lookup) read one file each.
        self.verdict_reads = 0

    # -- read surface ----------------------------------------------------------

    def _read_verdict(self, entry_dir: str) -> Optional[dict]:
        """Parse one entry's verdict.json (None on torn/missing --
        invisible by design); the ONE place per-entry records are read,
        so ``verdict_reads`` counts every such parse."""
        try:
            with open(
                os.path.join(entry_dir, "verdict.json"),
                "r", encoding="utf-8",
            ) as fh:
                record = json.load(fh)
        except (OSError, json.JSONDecodeError):
            return None
        self.verdict_reads += 1
        return record

    def _index_path(self) -> str:
        return os.path.join(self.store_dir, INDEX_FILE)

    def _verdict_stat(self, entry_dir: str):
        """Cheap freshness token for one entry's verdict.json: [mtime_ns,
        size] (None when absent) -- an os.stat, never a parse."""
        try:
            st = os.stat(os.path.join(entry_dir, "verdict.json"))
            return [st.st_mtime_ns, st.st_size]
        except OSError:
            return None

    def _load_index(self) -> dict:
        """The entry index ``{entry_id: {"record": slim, "stat": ...}}``
        (``index.json``; ``record`` is the verdict record WITHOUT its
        ``summary`` block, None for torn entries), validated against
        the live directory -- name set plus per-entry verdict.json
        stats, all via listdir/os.stat with zero JSON parses -- and
        REBUILT on any mismatch (missing/stale/foreign-writer index).
        This is what keeps :meth:`classify`'s family scan O(index)
        instead of O(store) as stores grow."""
        names = sorted(
            n for n in os.listdir(self.entries_dir)
            if os.path.isdir(os.path.join(self.entries_dir, n))
        )
        try:
            with open(self._index_path(), "r", encoding="utf-8") as fh:
                data = json.load(fh)
        except (OSError, json.JSONDecodeError):
            data = None
        if (
            isinstance(data, dict)
            and data.get("format") == STORE_FORMAT
            and data.get("hash_version") == HASH_VERSION
            and isinstance(data.get("entries"), dict)
        ):
            ent = data["entries"]
            if sorted(ent) == names and all(
                isinstance(v, dict)
                and v.get("stat") == self._verdict_stat(
                    os.path.join(self.entries_dir, n)
                )
                for n, v in ent.items()
            ):
                return ent
        return self._rebuild_index(names)

    def _rebuild_index(self, names: List[str]) -> dict:
        """Scan every verdict.json once and persist the index (atomic
        write + rename, like every store artifact).  Torn entries are
        indexed with ``record: None`` so their presence alone does not
        force a rebuild on every read."""
        ent = {}
        for name in names:
            path = os.path.join(self.entries_dir, name)
            record = self._read_verdict(path)
            slim = (
                None if record is None
                else {k: v for k, v in record.items() if k != "summary"}
            )
            ent[name] = {"record": slim, "stat": self._verdict_stat(path)}
        _atomic_write_json(self._index_path(), {
            "format": STORE_FORMAT,
            "hash_version": HASH_VERSION,
            "entries": ent,
        })
        return ent

    def _index_update(self, entry_dir: str, record: dict) -> None:
        """Incrementally fold one just-written entry into the index
        (called under the write lock).  A concurrent foreign writer may
        race the whole-file write; the stat validation in
        :meth:`_load_index` turns any lost update into a rebuild, never
        a stale read."""
        try:
            with open(self._index_path(), "r", encoding="utf-8") as fh:
                data = json.load(fh)
        except (OSError, json.JSONDecodeError):
            data = None
        if not (
            isinstance(data, dict)
            and data.get("format") == STORE_FORMAT
            and data.get("hash_version") == HASH_VERSION
            and isinstance(data.get("entries"), dict)
        ):
            data = {
                "format": STORE_FORMAT,
                "hash_version": HASH_VERSION,
                "entries": {},
            }
        data["entries"][os.path.basename(entry_dir)] = {
            "record": {
                k: v for k, v in record.items() if k != "summary"
            },
            "stat": self._verdict_stat(entry_dir),
        }
        _atomic_write_json(self._index_path(), data)

    def entries(self) -> List[StoreEntry]:
        out = []
        idx = self._load_index()
        for name in sorted(idx):
            record = (idx[name] or {}).get("record")
            if not isinstance(record, dict):
                continue  # torn/in-progress entry: invisible by design
            if record.get("format") != STORE_FORMAT:
                continue
            if record.get("hash_version") != HASH_VERSION:
                continue
            out.append(StoreEntry(
                os.path.join(self.entries_dir, name), record,
                loader=self._read_verdict,
            ))
        return out

    def lookup(self, spec: SpecFingerprint) -> Optional[StoreEntry]:
        """O(1) exact-match read: entry directories are content-
        addressed by ``spec_key[:24]``, so the identical-hit path reads
        exactly one verdict record -- it must not scale with store size."""
        path = os.path.join(self.entries_dir, spec.spec_key[:24])
        record = self._read_verdict(path)
        if record is None:
            return None
        if (
            record.get("format") != STORE_FORMAT
            or record.get("hash_version") != HASH_VERSION
            or record.get("spec_key") != spec.spec_key
        ):
            return None
        return StoreEntry(path, record)

    # -- classification --------------------------------------------------------

    def classify(self, spec: SpecFingerprint) -> Delta:
        """Pick the cheapest sound path for ``spec`` against the stored
        entries: identical > property-only > constant-widening > cold.
        Every refusal carries the reason (the loud half of "degrade
        loudly"); the caller journals it."""
        # Refused BEFORE the exact-match check: without declared
        # constants, two differently-parameterized instances of the
        # same model class can hash alike (the transition constants
        # live outside the bytecode), and an "exact" hit could serve
        # the wrong verdict.
        if spec.constants is None:
            return Delta(
                COLD, None,
                f"{spec.model_label} declares no stable spec_constants() "
                "(parallel/compiled.py); near-identical reuse would risk "
                "matching differently-parameterized models",
            )

        exact = self.lookup(spec)
        if exact is not None:
            return Delta(IDENTICAL, exact, "spec unchanged")
        entries = self.entries()

        family = [
            e for e in entries
            if e.record.get("family_key") == spec.family_key
        ]
        # Relatives are tried NEWEST-FIRST until one passes the reuse
        # gate: a recent sibling whose rows are ineligible (e.g. a
        # derived entry with no exhaustiveness witness) must not shadow
        # an older entry that can serve the re-check.  A refused
        # property-only candidate FALLS THROUGH to the widening
        # candidates (the next-cheapest sound mode), and only when
        # every relative refused does the submission go cold -- with
        # the first (most-preferred) refusal as the reason.
        refusals = []
        prop_only = self._newest_first([
            e for e in family
            if e.components.get("constants")
            == spec.components["constants"]
        ])
        for entry in prop_only:
            reason = self._reuse_refusal(spec, entry)
            if reason is None:
                return Delta(
                    PROPERTY_ONLY, entry,
                    "only the property component changed; re-evaluating "
                    "the new properties over the stored row log",
                )
            refusals.append((entry, reason))

        widen = self._newest_first([
            e for e in family
            if e.components.get("properties")
            == spec.components["properties"]
        ])
        for entry in widen:
            reason = self._widen_refusal(spec, entry)
            if reason is None:
                return Delta(
                    CONSTANT_WIDENING, entry,
                    "constants changed by a declared monotone widening; "
                    "seeding the frontier from the stored reachable set",
                )
            refusals.append((entry, reason))
        if refusals:
            entry, reason = refusals[0]
            return Delta(COLD, entry, reason)

        if family:
            return Delta(
                COLD, self._newest(family),
                "constants AND properties both changed vs every stored "
                "relative; no sound reuse path",
            )
        return Delta(COLD, self._nearest(spec, entries), self._cold_reason(
            spec, entries
        ))

    @staticmethod
    def _newest(entries: List[StoreEntry]) -> StoreEntry:
        return max(entries, key=lambda e: e.record.get("created_at", 0))

    @staticmethod
    def _newest_first(entries: List[StoreEntry]) -> List[StoreEntry]:
        return sorted(
            entries, key=lambda e: e.record.get("created_at", 0),
            reverse=True,
        )

    def _reuse_refusal(self, spec: SpecFingerprint,
                       entry: StoreEntry) -> Optional[str]:
        """Why the stored row log cannot back a property-only re-eval
        of ``spec`` (None = it can)."""
        if not entry.rows_reusable:
            return (
                "stored entry's row log is not reusable "
                f"({entry.record.get('rows_reason', 'unknown')})"
            )
        if spec.has_eventually:
            return (
                "the new property set contains EVENTUALLY properties, "
                "whose verdicts depend on path structure (eventually-bit "
                "propagation), not per-state predicates over the row log"
            )
        if not os.path.exists(entry.snapshot_path):
            return "stored entry is missing its snapshot.npz"
        return None

    def _widen_refusal(self, spec: SpecFingerprint,
                       entry: StoreEntry) -> Optional[str]:
        refusal = self._reuse_refusal(spec, entry)
        if refusal is not None:
            return refusal
        old_constants = entry.record.get("constants")
        if not isinstance(old_constants, dict):
            return "stored entry carries no constants data"
        if not spec.compiled.spec_widens(old_constants):
            return (
                "constants changed but the model does not declare the "
                "change a monotone widening (CompiledModel.spec_widens); "
                "a narrowing — or any unclassified constant edit — must "
                "re-explore from scratch"
            )
        if entry.record.get("snapshot_key") != spec.snapshot_key:
            return (
                "the stored snapshot's engine key does not match this "
                "spec (init states or packed layout shifted with the "
                "constant); seeding would corrupt the run"
            )
        return None

    def _nearest(self, spec: SpecFingerprint,
                 entries: List[StoreEntry]) -> Optional[StoreEntry]:
        """The entry sharing the most components -- diagnostics only."""
        def score(e):
            return sum(
                1 for k, v in spec.components.items()
                if k != "engine" and e.components.get(k) == v
            )

        scored = [e for e in entries if score(e) > 0]
        return max(scored, key=score) if scored else None

    def _cold_reason(self, spec: SpecFingerprint,
                     entries: List[StoreEntry]) -> str:
        if not entries:
            return "empty store (first run of this spec is the cold baseline)"
        near = self._nearest(spec, entries)
        if near is None:
            return "no stored entry shares any spec component"
        changed = sorted(
            k for k, v in spec.components.items()
            if k != "engine" and near.components.get(k) != v
        )
        return (
            f"changed component(s) vs nearest entry {near.entry_id}: "
            + ", ".join(changed)
        )

    # -- write surface ---------------------------------------------------------

    def record(self, spec: SpecFingerprint, checker, *,
               engine_kwargs: Optional[dict] = None,
               recheck_mode: str = COLD,
               elapsed_sec: Optional[float] = None,
               seeded: bool = False) -> Optional[StoreEntry]:
        """Journal one COMPLETED run into the store.  Returns the entry,
        or None when the run is not storable (error'd / partial -- the
        skip is journaled, never silent)."""
        model = spec.model
        if spec.constants is None:
            # The classify() refusal's storage-side twin: an entry
            # whose spec key cannot distinguish constants must never
            # exist to be matched.
            self._log(
                "incr_store_skipped", spec_key=spec.spec_key,
                reason=(
                    f"{spec.model_label} declares no stable "
                    "spec_constants(); entry would be ambiguous"
                ),
            )
            return None
        try:
            checker.join()
        except Exception as exc:  # journal, don't store (KeyboardInterrupt
            # and friends still propagate -- shutdown is not ours to eat)
            self._log("incr_store_skipped", spec_key=spec.spec_key,
                      reason=f"run failed: {type(exc).__name__}: {exc}"[:300])
            return None
        complete, why = self._verdict_complete(spec, checker)
        if not complete:
            self._log("incr_store_skipped", spec_key=spec.spec_key,
                      reason=why)
            return None
        reusable, rows_reason = self._rows_reusable(spec, checker, seeded)
        fps = checker.discovered_fingerprints()
        summary = _summarize(checker, model)
        entry_dir = os.path.join(
            self.entries_dir, spec.spec_key[:24]
        )
        with _WRITE_LOCK:
            os.makedirs(entry_dir, exist_ok=True)
            # Overwrite-in-place of a re-recorded spec: drop the old
            # verdict first so a reader never pairs the new snapshot
            # with the old record, then lay the artifacts down,
            # verdict last.
            verdict_path = os.path.join(entry_dir, "verdict.json")
            try:
                os.remove(verdict_path)
            except OSError:
                pass
            cold_dir = os.path.join(entry_dir, "cold")
            if os.path.isdir(cold_dir):
                for f in os.listdir(cold_dir):
                    try:
                        os.remove(os.path.join(cold_dir, f))
                    except OSError:
                        pass
            cold = ColdStore(spill_dir=cold_dir)
            cold.add_run(fps)
            cold.close()
            snapshot_path = os.path.join(entry_dir, "snapshot.npz")
            if reusable:
                checker.save_snapshot(snapshot_path)
            else:
                try:
                    os.remove(snapshot_path)
                except OSError:
                    pass
            return self._write_record(
                spec, entry_dir,
                summary=summary,
                engine_kwargs=engine_kwargs,
                recheck_mode=recheck_mode,
                seeded=seeded,
                rows_reusable=reusable,
                rows_reason=rows_reason,
                cold_entries=int(fps.shape[0]),
                elapsed_sec=elapsed_sec,
            )

    def record_derived(self, spec: SpecFingerprint, checker,
                       donor: StoreEntry, *,
                       engine_kwargs: Optional[dict] = None,
                       elapsed_sec: Optional[float] = None,
                       ) -> StoreEntry:
        """Persist a property-re-eval verdict as a first-class entry so
        the NEXT identical submission of the edited spec is an O(1)
        verdict hit.  The row artifacts are the DONOR's (same
        codec+constants ⇒ same reachable set): the snapshot and cold
        runs are hard-linked (copied on filesystems without links)
        rather than re-journaled from a device that was never touched.
        Verdict completeness needs no gate here: the re-eval covered
        the donor's complete row log by construction."""
        import shutil

        summary = _summarize(checker, spec.model)
        entry_dir = os.path.join(self.entries_dir, spec.spec_key[:24])

        def link_or_copy(src, dst):
            if os.path.abspath(src) == os.path.abspath(dst):
                return
            try:
                os.remove(dst)
            except OSError:
                pass
            try:
                os.link(src, dst)
            except OSError:
                shutil.copyfile(src, dst)

        with _WRITE_LOCK:
            os.makedirs(entry_dir, exist_ok=True)
            try:
                os.remove(os.path.join(entry_dir, "verdict.json"))
            except OSError:
                pass
            if os.path.exists(donor.snapshot_path):
                link_or_copy(
                    donor.snapshot_path,
                    os.path.join(entry_dir, "snapshot.npz"),
                )
            donor_cold = os.path.join(donor.path, "cold")
            cold_dir = os.path.join(entry_dir, "cold")
            if os.path.isdir(donor_cold) and os.path.abspath(
                donor_cold
            ) != os.path.abspath(cold_dir):
                os.makedirs(cold_dir, exist_ok=True)
                for f in os.listdir(cold_dir):
                    try:
                        os.remove(os.path.join(cold_dir, f))
                    except OSError:
                        pass
                for f in sorted(os.listdir(donor_cold)):
                    link_or_copy(
                        os.path.join(donor_cold, f),
                        os.path.join(cold_dir, f),
                    )
            return self._write_record(
                spec, entry_dir,
                summary=summary,
                engine_kwargs=engine_kwargs,
                recheck_mode=PROPERTY_ONLY,
                seeded=bool(donor.record.get("seeded")),
                rows_reusable=(
                    donor.rows_reusable and not spec.has_eventually
                ),
                rows_reason=(
                    f"rows inherited from donor entry {donor.entry_id} "
                    f"({donor.record.get('rows_reason', '')})"
                ),
                cold_entries=int(donor.record.get("cold_entries", 0)),
                elapsed_sec=elapsed_sec,
                donor=donor.entry_id,
            )

    def _write_record(self, spec: SpecFingerprint, entry_dir: str, *,
                      summary: dict, engine_kwargs: Optional[dict],
                      recheck_mode: str, seeded: bool,
                      rows_reusable: bool, rows_reason: str,
                      cold_entries: int,
                      elapsed_sec: Optional[float],
                      donor: Optional[str] = None) -> StoreEntry:
        """The ONE place the verdict-record schema exists -- cold,
        seeded, and derived entries all land through here."""
        record = {
            "format": STORE_FORMAT,
            "hash_version": HASH_VERSION,
            "created_at": time.time(),
            "spec_key": spec.spec_key,
            "family_key": spec.family_key,
            "components": spec.components,
            "constants": spec.constants,
            "model": spec.model_label,
            "property_names": spec.property_names,
            "expectations": spec.expectations,
            "snapshot_key": spec.snapshot_key,
            "engine": {
                "name": spec.engine, "kwargs": engine_kwargs or {},
            },
            "recheck_mode": recheck_mode,
            "seeded": bool(seeded),
            "rows_reusable": bool(rows_reusable),
            "rows_reason": rows_reason,
            "cold_entries": int(cold_entries),
            "elapsed_sec": elapsed_sec,
            "summary": summary,
        }
        _atomic_write_json(os.path.join(entry_dir, "verdict.json"), record)
        self._index_update(entry_dir, record)
        entry = StoreEntry(entry_dir, record)
        self._log(
            "incr_stored",
            spec_key=spec.spec_key,
            entry=entry.entry_id,
            unique=summary.get("unique_state_count"),
            rows_reusable=bool(rows_reusable),
            cold_entries=int(cold_entries),
            seeded=bool(seeded),
            **({"donor": donor} if donor else {}),
        )
        return entry

    def _verdict_complete(self, spec: SpecFingerprint, checker):
        """May this run's VERDICT enter the cache at all?  A truncated
        run (wall timeout, cooperative stop, target_state_count) has a
        partial verdict -- its "no violation found" claims cover only
        the explored prefix, and the truncating knob (timeout in
        particular) is deliberately NOT part of the spec hash, so a
        stored partial verdict would later serve as "identical" for an
        untruncated resubmission.  Complete means one of: the frontier
        drained; every property has a discovery (a finish_when early
        exit then asserts nothing negative); or the run hit exactly its
        hashed depth bound."""
        if checker.stop_requested():
            return False, (
                "run was cooperatively stopped; the verdict is partial"
            )
        carry = getattr(checker, "_carry", None)
        if carry is None:
            return False, "no run state to certify"
        remaining = carry.level_end - carry.level_start
        if remaining == 0:
            return True, ""
        if not (set(spec.property_names) - set(checker.discoveries())):
            # Every property discovered: the verdict makes only
            # positive claims, each backed by a concrete path.
            return True, ""
        if (
            spec.target_max_depth
            and not spec.target_state_count
            and carry.depth + 1 >= int(spec.target_max_depth)
        ):
            return True, ""  # complete w.r.t. the HASHED depth bound
        return False, (
            "frontier not drained (timeout/target/finish_when exit); a "
            "partial verdict must not enter the cache"
        )

    def _rows_reusable(self, spec: SpecFingerprint, checker,
                       seeded: bool):
        """The soundness gate (module docstring): complete, untruncated,
        unbounded, with an undiscovered-property exhaustiveness
        witness."""
        from ..parallel.wavefront import GpuChecker

        if type(checker) is not GpuChecker:
            return False, (
                f"engine {type(checker).__name__} does not journal a "
                "reusable snapshot (spawn_gpu runs only)"
            )
        if checker.stop_requested():
            return False, "run was cooperatively stopped (partial)"
        if spec.target_max_depth:
            return False, (
                "depth-bounded runs evaluate nothing past the target "
                "depth; the row log is complete only w.r.t. the bound"
            )
        if spec.target_state_count:
            return False, "target_state_count bounds truncate exploration"
        carry = getattr(checker, "_carry", None)
        if carry is None:
            return False, "no run state to snapshot"
        if carry.level_start < carry.level_end:
            return False, (
                "frontier not drained (timeout/finish_when exit); the "
                "row log is a prefix, not the reachable set"
            )
        discovered = set(checker.discoveries())
        if not (set(spec.property_names) - discovered):
            return False, (
                "every property discovered: the awaiting gate may have "
                "pruned expansion (no exhaustiveness witness)"
            )
        return True, "complete exhaustive run" + (
            " (seeded re-check)" if seeded else ""
        )

    def _log(self, event: str, **fields) -> None:
        if self.journal is not None:
            self.journal.append(event, **fields)
