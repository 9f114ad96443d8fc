"""Resharding: re-key a sharded snapshot onto a mesh of another width.

The counterpart of ``stateright_tpu/tiered/reshard.py``.  Sharded global
ids encode the owner shard, so a snapshot written on an n-shard mesh
cannot resume on m != n shards: every parent and discovery id would name
the wrong row.  :func:`reshard_snapshot` is the offline translation.  It
reads a snapshot of either sharded engine of the port (or of the JAX
package: the formats are the same) -- the slot-indexed store of
``spawn_gpu_sharded`` or the positional row log of
``spawn_gpu_tiered_sharded`` -- routes every row to its owner under the new
width with the engines' owner mix (:func:`~stateright_tpu_torch.parallel.
exchange.owner_mix_host_np` of the identity fingerprint, canonical under
symmetry), and writes a tiered-sharded snapshot for the new width:

- each new shard's log keeps BFS segment order (visited rows, then the
  current frontier, then the next level as far as it got; within a
  segment old shards in index order, old log order within a shard), so a
  resume continues the level structure the old run was in;
- parent ids and per-shard discovery ids are remapped through the full
  old-id -> new-id table;
- the hot tier restarts empty: every row's fingerprint goes into one
  sorted cold run of its new shard.

It runs on the host: numpy, K1's twin (and K15's under symmetry) on CPU
tensors, so a snapshot can be resharded on any machine.  Resume the output
with ``spawn_gpu_tiered_sharded(mesh=[...] * new_shards,
resume_from=...)``.
"""

from __future__ import annotations

import ast
import os

import numpy as np

from ..ops.device_fp import device_fp64, fp64_of
from ..ops.u32 import M32, from_numpy_u32
from ..parallel.canon import make_canon
from ..parallel.compiled import compiled_model_for
from ..parallel.exchange import owner_mix_host_np
from ..parallel.sharded import (
    NO_GID, S_CAND_HI, S_CAND_LO, S_DEPTH, S_DISC, S_LEVEL_END, S_LEVEL_START,
    S_SC_HI, S_SC_LO, S_TAIL, S_UNIQUE_G,
)
from ..runtime.journal import Journal
from .sharded_engine import TS_SUFFIX


def _rekey_engine_key(old_key: str, new_shards: int) -> str:
    """The snapshot's engine key with its mesh width (element 6 of the
    key tuple) replaced, and the tiered-sharded suffix."""
    base = old_key[: -len(TS_SUFFIX)] if old_key.endswith(TS_SUFFIX) else old_key
    parts = list(ast.literal_eval(base))
    parts[6] = new_shards
    return repr(tuple(parts)) + TS_SUFFIX


def _identity_fps(cm, rows: np.ndarray, canon) -> np.ndarray:
    """The uint64 identity fingerprints of packed uint32 rows, in row
    order: K1's twin on the leading ``fp_words`` of each row, or of its
    canonical form under symmetry."""
    t = from_numpy_u32(np.ascontiguousarray(rows), "cpu")
    if canon is not None:
        t = canon(t)
    t = t[:, : cm.fp_words or cm.state_width]
    return fp64_of(*device_fp64(t)).numpy().view(np.uint64)


def _segments_from_plain(snap, cm):
    """Per old shard: its rows, parent ids and ebits in BFS (queue) order
    with the level bounds, from a ``spawn_gpu_sharded`` snapshot; and an
    old-id decoder (``shard << slot_bits | slot`` -> shard, position)."""
    n = int(snap["n_shards"])
    cap_s = int(snap["cap_s"])
    slot_bits = cap_s.bit_length() - 1
    w = cm.state_width
    store = np.asarray(snap["store"]).reshape(n, cap_s, w)
    parent = np.asarray(snap["parent"]).reshape(n, cap_s)
    ebits = np.asarray(snap["ebits"]).reshape(n, cap_s)
    queue = np.asarray(snap["queue"]).reshape(n, -1)
    stats = np.asarray(snap["stats"]).astype(np.int64).reshape(n, -1)
    shards = []
    inv = np.zeros((n, cap_s), np.int64)  # slot -> log position
    for d in range(n):
        tail = int(stats[d, S_TAIL])
        slots = queue[d, :tail].astype(np.int64)
        inv[d, slots] = np.arange(tail)
        shards.append({
            "rows": store[d, slots], "parent": parent[d, slots],
            "ebits": ebits[d, slots],
            "level_start": int(stats[d, S_LEVEL_START]),
            "level_end": int(stats[d, S_LEVEL_END]), "tail": tail,
        })

    def decode(g):
        d = g >> slot_bits
        return d, int(inv[d, g & (cap_s - 1)])

    meta = {
        "n": n,
        "depth": int(stats[0, S_DEPTH]),
        "unique": int(stats[0, S_UNIQUE_G]),
        "states": (int(stats[0, S_SC_HI]) << 32) | int(stats[0, S_SC_LO]),
        "cand": int(((stats[:, S_CAND_HI] << 32) | stats[:, S_CAND_LO]).sum()),
        "disc": stats[:, S_DISC:].astype(np.uint32),
    }
    return shards, decode, meta


def _segments_from_tiered(snap, cm):
    """The same from a ``spawn_gpu_tiered_sharded`` snapshot (positional
    ids ``position * n + shard``, rows already in BFS order)."""
    n = int(snap["n_shards"])
    w = cm.state_width
    rows = np.asarray(snap["rows"]).reshape(n, -1, w)
    parent = np.asarray(snap["parent"]).reshape(n, -1)
    ebits = np.asarray(snap["ebits"]).reshape(n, -1)
    starts = np.asarray(snap["ts_level_start"], np.int64)
    ends = np.asarray(snap["ts_level_end"], np.int64)
    tails = np.asarray(snap["ts_tails"], np.int64)
    shards = []
    for d in range(n):
        tail = int(tails[d])
        shards.append({
            "rows": rows[d, :tail], "parent": parent[d, :tail],
            "ebits": ebits[d, :tail], "level_start": int(starts[d]),
            "level_end": int(ends[d]), "tail": tail,
        })

    def decode(g):
        return g % n, g // n

    meta = {
        "n": n,
        "depth": int(snap["ts_depth"]),
        "unique": int(snap["ts_unique"]),
        "states": int(snap["ts_states"]),
        "cand": int(np.asarray(snap["ts_cand"], np.int64).sum()),
        "disc": np.asarray(snap["disc"]).astype(np.uint32),
    }
    return shards, decode, meta


def reshard_snapshot(model, in_path: str, out_path: str, new_shards: int,
                     compiled=None, journal=None) -> dict:
    """Re-key the sharded snapshot at ``in_path`` onto a ``new_shards``
    mesh, writing a tiered-sharded snapshot at ``out_path``.

    ``model`` is the checked system: its compiled form gives the identity
    fingerprints and, under symmetry, the canonicalization, as the engines
    derive them.  Returns a summary (the new shards' tails, log capacity
    and engine key, the counters) and, given ``journal`` (a path or an
    open journal), appends one ``reshard`` event to it."""
    if new_shards < 1:
        raise ValueError("new_shards must be >= 1")
    cm = compiled if compiled is not None else compiled_model_for(model)
    with np.load(in_path, allow_pickle=False) as npz:
        snap = {k: npz[k] for k in npz.files}
    required = {"engine_key", "n_shards", "cap_s", "chunk"}
    if not required.issubset(snap):
        raise ValueError(
            f"{in_path} is not a sharded engine snapshot (missing "
            f"{sorted(required - set(snap))})"
        )
    key_str = str(snap["engine_key"])
    key_tuple = ast.literal_eval(
        key_str[: -len(TS_SUFFIX)] if key_str.endswith(TS_SUFFIX) else key_str
    )
    canon = None
    if "sym" in key_tuple[7:]:
        canon = make_canon(cm)
        if canon is None:
            raise ValueError(
                "snapshot was written with symmetry canonicalization but "
                f"{type(cm).__name__} declares no canonicalization"
            )
    if "ts_tails" in snap:
        old, decode, meta = _segments_from_tiered(snap, cm)
    else:
        old, decode, meta = _segments_from_plain(snap, cm)
    n, m, w = meta["n"], int(new_shards), cm.state_width

    fps_all, owners = [], []
    for seg in old:
        fps = (_identity_fps(cm, seg["rows"], canon) if seg["tail"]
               else np.zeros((0,), np.uint64))
        fps_all.append(fps)
        owners.append(owner_mix_host_np(
            (fps >> np.uint64(32)).astype(np.uint32),
            (fps & np.uint64(M32)).astype(np.uint32),
        ).astype(np.int64) % m)

    # New logs in BFS segment order: visited, frontier, next level.
    new_pos = [np.zeros(seg["tail"], np.int64) for seg in old]
    counts = np.zeros(m, np.int64)
    bounds = np.zeros((m, 2), np.int64)  # (level_start, level_end)
    for bound, lo_key, hi_key in ((None, None, "level_start"),
                                  (0, "level_start", "level_end"),
                                  (1, "level_end", "tail")):
        if bound is not None:
            bounds[:, bound] = counts
        for d, seg in enumerate(old):
            lo = 0 if lo_key is None else seg[lo_key]
            for p in range(lo, seg[hi_key]):
                e = int(owners[d][p])
                new_pos[d][p] = counts[e]
                counts[e] += 1

    tails = counts
    max_tail = int(tails.max()) if m else 0
    log_cap = 1 << max(max_tail, 1).bit_length()  # at least 2x headroom
    chunk = int(snap["chunk"])
    lp = log_cap + chunk
    if lp * m >= 0xFFFFFFFF:
        raise ValueError(
            f"resharding onto {m} shards needs {lp * m} global ids, past the "
            "32-bit id space; use fewer, larger shards"
        )

    def remap(g: int) -> int:
        if g == NO_GID:
            return NO_GID
        d, p = decode(g)
        return int(new_pos[d][p]) * m + int(owners[d][p])

    rows_new = np.zeros((m, lp, w), np.uint32)
    parent_new = np.full((m, lp), NO_GID, np.uint32)
    ebits_new = np.zeros((m, lp), np.uint32)
    cold = [[] for _ in range(m)]
    for d, seg in enumerate(old):
        if not seg["tail"]:
            continue
        e, p = owners[d], new_pos[d]
        rows_new[e, p] = seg["rows"]
        ebits_new[e, p] = seg["ebits"]
        parent_new[e, p] = np.array(
            [remap(int(g)) for g in np.asarray(seg["parent"], np.uint32)],
            np.uint32,
        )
        for j in range(m):
            sel = e == j
            if sel.any():
                cold[j].append(fps_all[d][sel])

    n_props = meta["disc"].shape[1]
    disc = np.full((m, n_props), NO_GID, np.uint32)
    for d in range(n):
        for q in range(n_props):
            g = int(meta["disc"][d, q])
            if g == NO_GID:
                continue
            g2 = remap(g)
            if disc[g2 % m, q] == NO_GID:
                disc[g2 % m, q] = g2

    # The whole log goes cold: one sorted run per new shard, the hot tier
    # empty (spill tail = tail).
    runs_per = np.zeros(m, np.int64)
    flat_fps, flat_lens = [], []
    for j in range(m):
        if cold[j]:
            fps = np.sort(np.concatenate(cold[j]))
            flat_fps.append(fps)
            flat_lens.append(fps.size)
            runs_per[j] = 1
    out = {
        "engine_key": _rekey_engine_key(key_str, m),
        "n_shards": np.int64(m),
        "cap_s": np.int64(int(snap["cap_s"])),
        "chunk": np.int64(chunk),
        "rows": rows_new.reshape(m * lp, w),
        "parent": parent_new.reshape(m * lp),
        "ebits": ebits_new.reshape(m * lp),
        "disc": disc,
        "ts_level_start": bounds[:, 0],
        "ts_level_end": bounds[:, 1],
        "ts_tails": tails,
        "ts_spill_tails": tails.copy(),
        # Representatives sent are known in total only: spread evenly.
        "ts_cand": np.full(m, meta["cand"] // m, np.int64)
        + (np.arange(m) < meta["cand"] % m),
        "ts_depth": np.int64(meta["depth"]),
        "ts_unique": np.int64(meta["unique"]),
        "ts_states": np.uint64(meta["states"]),
        "ts_log_cap": np.int64(log_cap),
        "ts_cold_fps": (np.concatenate(flat_fps) if flat_fps
                        else np.zeros((0,), np.uint64)),
        "ts_cold_lens": np.asarray(flat_lens, np.int64),
        "ts_cold_runs_per_shard": runs_per,
        "ts_spill_counts": np.zeros(m, np.int64),
    }
    for k in ("bucket_slack", "sort_lanes", "sortless", "step_lanes"):
        if k in snap:
            out[k] = np.asarray(snap[k])
    tmp = f"{out_path}.tmp"
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, **out)
    os.replace(tmp, out_path)
    summary = {
        "in_path": in_path, "out_path": out_path, "old_shards": n,
        "new_shards": m, "unique": meta["unique"], "depth": meta["depth"],
        "tails": tails.tolist(), "log_capacity": log_cap,
        "engine_key": out["engine_key"],
    }
    if journal is not None:
        event = {k: v for k, v in summary.items() if k != "engine_key"}
        if isinstance(journal, (str, os.PathLike)):
            j = Journal(os.fspath(journal))
            try:
                j.append("reshard", **event)
            finally:
                j.close()
        else:
            journal.append("reshard", **event)
    return summary

