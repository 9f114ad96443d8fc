"""Host-side cold tier: evicted fingerprint partitions as sorted runs.

A copy of ``stateright_tpu/tiered/cold_store.py``'s ``ColdStore`` (numpy
only).  The TLC lineage (Yu, Manolios and Lamport) keeps the fingerprint
set on disk as sorted immutable runs and merge-joins candidate batches
against them; this is the same structure one level up -- host RAM first,
disk optionally under it -- holding the partitions the tiered engine
evicts when its device hash table crosses the memory budget
(``tiered/engine.py``).

Each spill adds one immutable run: a sorted ``uint64`` fingerprint array
(8 bytes a state).  Runs may overlap (the hot tier caches cold-duplicate
keys, and those ride along on the next spill); membership is "present in
ANY run", so overlap costs probe passes, never correctness.  When the run
count passes ``max_runs`` the store compacts every run into one
deduplicated array -- the classic LSM merge.

With ``spill_dir`` set, runs live on disk as ``cold_run_<n>.npy`` files
opened back memory-mapped, so the host RSS holds only the pages the
merge-join windows touch.  The engine's snapshot embeds the whole store
(:meth:`ColdStore.to_arrays`), so a stopped run resumes with its tiers
intact.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import numpy as np

_RUN_FILE = re.compile(r"^cold_run_(\d+)\.npy$")


class ColdStore:
    """Sorted immutable uint64 fingerprint runs with LSM-style merging."""

    def __init__(self, spill_dir: Optional[str] = None, max_runs: int = 8):
        if max_runs < 1:
            raise ValueError("max_runs must be >= 1")
        self._runs: List[np.ndarray] = []
        self._paths: List[Optional[str]] = []  # disk backing, when spilled
        self.spill_dir = spill_dir
        self.max_runs = max_runs
        # Monotonic file-name counter (never reused).  Seeded PAST any
        # run files already in ``spill_dir``: a fresh store (or a
        # ``from_arrays`` resume) pointed at a directory a previous
        # process spilled into must never overwrite a prior run's
        # ``.npy`` — a half-overwritten file is exactly the torn-run
        # state the disk tier promises not to have.
        self._seq = self._scan_seq(spill_dir)

    @staticmethod
    def _scan_seq(spill_dir: Optional[str]) -> int:
        if spill_dir is None or not os.path.isdir(spill_dir):
            return 0
        seqs = [
            int(m.group(1))
            for m in (_RUN_FILE.match(f) for f in os.listdir(spill_dir))
            if m
        ]
        return max(seqs, default=0)

    # -- read surface ---------------------------------------------------------

    @property
    def runs(self) -> List[np.ndarray]:
        return list(self._runs)

    @property
    def run_count(self) -> int:
        return len(self._runs)

    @property
    def entries(self) -> int:
        """Total stored fingerprints, overlap included."""
        return int(sum(r.shape[0] for r in self._runs))

    @property
    def nbytes(self) -> int:
        return self.entries * 8

    def contains(self, fps) -> np.ndarray:
        """Host-side membership of a uint64 fingerprint batch: the
        reference the device merge-join (K20, ``tiered/cold_join.py``) is
        held against."""
        fps = np.asarray(fps, dtype=np.uint64)
        hit = np.zeros(fps.shape, dtype=bool)
        for run in self._runs:
            idx = np.searchsorted(run, fps)
            in_range = idx < run.shape[0]
            safe = np.minimum(idx, max(run.shape[0] - 1, 0))
            if run.shape[0]:
                hit |= in_range & (np.asarray(run)[safe] == fps)
        return hit

    # -- write surface --------------------------------------------------------

    def add_run(self, fps: np.ndarray) -> None:
        """Add one spill's fingerprints as a new immutable run (sorted
        here; the caller's segment readback arrives in row-log order).
        Empty spills are dropped.  Past ``max_runs`` the store merges
        everything into one deduplicated run."""
        fps = np.sort(np.asarray(fps, dtype=np.uint64))
        if fps.shape[0] == 0:
            return
        self._append(fps)
        if len(self._runs) > self.max_runs:
            self.merge()

    def merge(self) -> None:
        """Compact every run into one sorted, deduplicated run: the JAX
        store's ``np.unique``, as a sort and a neighbour test (``np.unique``
        of a million uint64 keys took 0.5-0.7 s of host time on the H100's
        host, its hash path, where the sort takes tens of milliseconds)."""
        if not self._runs:
            return
        merged = np.sort(np.concatenate([np.asarray(r) for r in self._runs]))
        if merged.shape[0] > 1:
            merged = merged[np.concatenate(([True], merged[1:] != merged[:-1]))]
        self._drop_files()
        self._runs = []
        self._paths = []
        self._append(merged)

    def _append(self, fps: np.ndarray) -> None:
        if self.spill_dir is not None:
            os.makedirs(self.spill_dir, exist_ok=True)
            self._seq += 1
            path = os.path.join(self.spill_dir, f"cold_run_{self._seq}.npy")
            # Torn-run proofing: write + fsync a temp file, then rename
            # it into place.  A process killed mid-spill leaves either
            # the complete old state or a stray ``.tmp`` (ignored by the
            # name scan), never a half-written run a resume would mmap.
            tmp = f"{path}.tmp"
            with open(tmp, "wb") as fh:
                np.save(fh, fps)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
            # Reopen memory-mapped: the RAM copy is released and probe
            # windows fault in only the pages they touch.
            self._runs.append(np.load(path, mmap_mode="r"))
            self._paths.append(path)
        else:
            self._runs.append(fps)
            self._paths.append(None)

    def close(self) -> None:
        """Release every memory map (the run FILES stay on disk); a
        long-lived process holding many finished stores would otherwise
        pin a descriptor and address mapping per run.  The store is empty
        afterwards; reopen the directory with :meth:`open`."""
        self._runs = []
        self._paths = []

    @classmethod
    def open(
        cls, spill_dir: str, max_runs: int = 8
    ) -> "ColdStore":
        """Open a directory of previously spilled runs (memory-mapped,
        in spill order) WITHOUT rewriting them -- the read-only reopen
        path, e.g. to inspect a tiered run's disk tier."""
        store = cls(spill_dir=spill_dir, max_runs=max_runs)
        if not os.path.isdir(spill_dir):
            return store
        named = sorted(
            (int(m.group(1)), f)
            for m, f in (
                (_RUN_FILE.match(f), f) for f in os.listdir(spill_dir)
            )
            if m
        )
        for _seq, fname in named:
            path = os.path.join(spill_dir, fname)
            store._runs.append(np.load(path, mmap_mode="r"))
            store._paths.append(path)
        return store

    def _drop_files(self) -> None:
        # Unlinking while a memory map still references the file is fine
        # on POSIX (the map keeps the inode alive); best effort elsewhere.
        for path in self._paths:
            if path is None:
                continue
            try:
                os.remove(path)
            except OSError:
                pass

    # -- snapshot round trip (the checkpoint.npz container) -------------------

    def to_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(concatenated_fps, run_lengths)`` for embedding in the
        engine's snapshot npz — runs stay distinct so a resume restores
        the exact tier shape (and probe-pass accounting) it left."""
        if not self._runs:
            return (
                np.zeros((0,), np.uint64), np.zeros((0,), np.int64),
            )
        return (
            np.concatenate([np.asarray(r) for r in self._runs]),
            np.asarray([r.shape[0] for r in self._runs], np.int64),
        )

    @classmethod
    def from_arrays(
        cls, fps: np.ndarray, lens: np.ndarray,
        spill_dir: Optional[str] = None, max_runs: int = 8,
        clean_stale: bool = True,
    ) -> "ColdStore":
        """Rebuild a store from its snapshot arrays.  With ``spill_dir``
        set, the restored runs are re-spilled under fresh sequence
        numbers (the counter scans past existing files, so a prior
        process's runs are never clobbered) and — with ``clean_stale``
        (default) — run files the restore did NOT claim are unlinked:
        the snapshot is authoritative, and leaving the dead process's
        duplicates behind would leak one directory's worth of disk per
        crash-resume cycle."""
        store = cls(spill_dir=spill_dir, max_runs=max_runs)
        off = 0
        for n in np.asarray(lens, np.int64):
            n = int(n)
            store._append(np.asarray(fps[off:off + n], np.uint64))
            off += n
        if clean_stale and spill_dir is not None and os.path.isdir(spill_dir):
            claimed = {
                os.path.basename(p) for p in store._paths if p is not None
            }
            for fname in os.listdir(spill_dir):
                if _RUN_FILE.match(fname) and fname not in claimed:
                    try:
                        os.remove(os.path.join(spill_dir, fname))
                    except OSError:
                        pass
        return store
