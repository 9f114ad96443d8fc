"""Append-only JSON-lines journal.

A copy of ``stateright_tpu/runtime/journal.py``'s ``Journal``,
``as_journal`` and ``read_journal``: one event per line, each written with
a single ``os.write`` on an ``O_APPEND`` descriptor so concurrent writers
interleave at line granularity, optional rotation past ``max_bytes``, and
a ``clock_sync`` header (paired wall and monotonic clocks) opening each
segment.  Every event carries ``t`` (unix wall time) and ``event`` (a
tag); the chaos-ensemble engine journals ``ensemble_start``,
``ensemble_failing``, ``ensemble_sweep``, ``ensemble_shrink`` and
``ensemble_repro``.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Dict, List, Optional

# The once-per-segment header pairing wall and monotonic clocks (plus
# the writer's pid@host stamp) — the alignment anchor obs/timeline.py
# uses to merge multi-process journals onto one wall-clock axis.
CLOCK_SYNC_EVENT = "clock_sync"


class Journal:
    """Appends events to a JSONL file; safe to share a path across
    processes (each instance holds its own ``O_APPEND`` descriptor) and
    to share one instance across threads (the chaos transport's actor and
    delay-timer threads — and the checking service's concurrent jobs
    (serve/scheduler.py) — all append through a single journal).

    Line atomicity is the contract concurrent writers rely on: each
    event is one ``os.write`` of the whole encoded line on an
    ``O_APPEND`` descriptor, so the kernel's atomic append (offset
    lookup + write under the inode lock) lands every line contiguously
    at the true end of file — a buffered ``TextIOWrapper`` could split
    one line across several syscalls and interleave torn halves from
    two writers (pinned by tests/test_runtime.py's interleaved-writer
    test).

    Rotation (``max_bytes``): a persistent service daemon
    (serve/server.py) journals every job forever, so an unrotated file
    grows without bound.  With ``max_bytes`` set, an append that would
    push the current segment past the cap first rolls the file over:
    ``journal.jsonl`` -> ``journal.jsonl.1`` (older segments shift to
    ``.2..max_segments``; the oldest falls off), each shift one atomic
    ``os.rename``, all under the instance lock, and the append then
    lands in a fresh segment — a record is never split across segments.
    :func:`read_journal` merges segments oldest-first, so readers see
    one continuous event stream.  Rotation is per-instance: run
    directories where the child, supervisor, and engine share one path
    through separate instances keep the default ``max_bytes=None``
    (no rotation, exactly the old behavior)."""

    def __init__(self, path: str, max_bytes: Optional[int] = None,
                 max_segments: int = 8, fsync: bool = False):
        """``fsync=True`` follows every append with an ``os.fsync`` —
        the durability discipline the fleet store (fleet/store.py)
        relies on: a ``kill -9`` immediately after ``append`` returns
        must not lose the event, because the fleet journal IS the job
        store's source of truth.  Default off: run/serve telemetry
        journals value throughput over power-loss durability."""
        self.path = str(path)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        if max_bytes is not None and max_bytes <= 0:
            raise ValueError("max_bytes must be positive (or None)")
        self.max_bytes = max_bytes
        self.max_segments = max(1, int(max_segments))
        self.fsync = bool(fsync)
        self._fd: Optional[int] = None
        self._lock = threading.Lock()
        self._synced = False  # this instance has stamped a clock_sync

    def _sync_line(self) -> bytes:
        """One encoded ``clock_sync`` header line: the wall/monotonic
        pair is read back-to-back so the offset between the two clocks
        is captured to within a few microseconds."""
        host = socket.gethostname()
        rec = {
            "t": time.time(),
            "event": CLOCK_SYNC_EVENT,
            "mono": time.monotonic(),
            "pid": os.getpid(),
            "host": host,
            "worker": f"{os.getpid()}@{host}",
        }
        return (json.dumps(rec, sort_keys=True) + "\n").encode("utf-8")

    def _rollover(self) -> None:
        """Shift segments up and move the live file to ``.1`` (caller
        holds the lock; the live fd is closed first so the next append
        reopens a fresh segment at the canonical path)."""
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None
        oldest = f"{self.path}.{self.max_segments}"
        if os.path.exists(oldest):
            os.unlink(oldest)
        for k in range(self.max_segments - 1, 0, -1):
            seg = f"{self.path}.{k}"
            if os.path.exists(seg):
                os.rename(seg, f"{self.path}.{k + 1}")
        if os.path.exists(self.path):
            os.rename(self.path, f"{self.path}.1")

    def append(self, event: str, **fields) -> dict:
        record = {"t": time.time(), "event": event}
        record.update(fields)
        line = (json.dumps(record, sort_keys=True, default=str) + "\n").encode(
            "utf-8"
        )
        with self._lock:
            if self._fd is None:
                self._fd = os.open(
                    self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644
                )
            if event == CLOCK_SYNC_EVENT:
                self._synced = True  # the caller IS the header
            sync = b"" if self._synced else self._sync_line()
            if self.max_bytes is not None:
                size = os.fstat(self._fd).st_size
                if size > 0 and size + len(sync) + len(line) > self.max_bytes:
                    self._rollover()
                    self._fd = os.open(
                        self.path,
                        os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644,
                    )
                    # Every fresh segment re-anchors the clocks, so a
                    # reader holding any single segment can align it.
                    if event != CLOCK_SYNC_EVENT:
                        sync = self._sync_line()
            if sync:
                os.write(self._fd, sync)
                self._synced = True
            os.write(self._fd, line)
            if self.fsync:
                os.fsync(self._fd)
        return record

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def as_journal(journal) -> Optional[Journal]:
    """Engine-kwarg coercion: accept a :class:`Journal`, a path, or None."""
    if journal is None or isinstance(journal, Journal):
        return journal
    return Journal(str(journal))


def _segment_paths(path: str) -> List[str]:
    """Rotated segments oldest-first (``.N`` .. ``.1``), then the live
    file — one continuous stream for readers."""
    segs = []
    k = 1
    while os.path.exists(f"{path}.{k}"):
        segs.append(f"{path}.{k}")
        k += 1
    segs.reverse()
    segs.append(path)
    return segs


def read_journal(path: str, include_sync: bool = False) -> List[Dict]:
    """Parse a journal file into a list of event dicts, merging rotated
    segments (oldest first) when present.  Tolerates a torn trailing
    line (a writer killed mid-``write``); see
    :func:`read_journal_stats` for the skip count.

    ``clock_sync`` headers are filtered out by default — they are
    per-segment clock plumbing, not run telemetry, and every existing
    consumer indexes events positionally (``events[0]``) or asserts
    exact event sequences.  Pass ``include_sync=True`` (or use
    :func:`read_clock_syncs`) to see them."""
    return read_journal_stats(path, include_sync=include_sync)[0]


def read_journal_stats(path: str, include_sync: bool = False):
    """Like :func:`read_journal`, but also returns how many lines were
    SKIPPED as torn/garbled (undecodable JSON, or a truncation that
    still parses but is not an event object — ``{"t": 17`` torn after
    the value decodes as the integer 17).  Consumers that summarize a
    crashed run's journal (obs/report.py, the ``watch`` verb) surface
    the count as a warning instead of silently absorbing — or worse,
    crashing on — the torn tail.

    A rollover landing BETWEEN the segment listing and the reads would
    silently skip the segment whose name shifted, so the read is
    re-attempted until the segment list is stable across it (bounded;
    one pass on a quiet journal — rotation happens at most once per
    ``max_bytes`` of appends, so two consecutive passes racing distinct
    rollovers is already pathological)."""
    events: List[Dict] = []
    skipped = 0
    for _ in range(3):
        segs = _segment_paths(str(path))
        events = []
        skipped = 0
        for seg in segs:
            try:
                with open(seg, "r", encoding="utf-8") as fh:
                    for line in fh:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            rec = json.loads(line)
                        except json.JSONDecodeError:
                            skipped += 1  # torn tail from a killed writer
                            continue
                        if not isinstance(rec, dict):
                            skipped += 1  # truncation that still parses
                            continue
                        if (not include_sync
                                and rec.get("event") == CLOCK_SYNC_EVENT):
                            continue  # per-segment clock plumbing
                        events.append(rec)
            except FileNotFoundError:
                continue  # racing a rollover; the re-check below catches it
        if _segment_paths(str(path)) == segs:
            break
    return events, skipped
