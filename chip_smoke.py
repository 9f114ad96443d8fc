#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA H100.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; any failure exits non-zero:

1. build: compile the twenty-six CUDA sources of ``stateright_tpu_torch/csrc``
   with ``nvcc`` for ``sm_90a`` (one compiler process each, all started
   together), log each kernel entry that ``ptxas -v`` gave a stack frame
   or spills, and print the card's name, power limit and SM clock;
2. the kernels of the ``2pc check 10`` path (K1-K4, K8) against their
   plain-torch twins at the shapes that path gives them (F = 2**20
   states, A = 52 actions, a 2**27-slot table, seeded inputs with
   duplicate and pre-present keys) -- bit-equal, these are integer
   functions -- timing kernel, twin and, where one torch call computes the
   same function, that call (CUDA events, after warm-up);
3. ``2pc check 5`` through ``spawn_gpu()``: 8,832 unique / 58,146 states /
   depth 17, its row log, parents and ebits bit-equal to the port's own CPU
   run;
4. ``2pc check 10`` through ``spawn_gpu()``: 61,515,776 unique at depth 32,
   K1-K4 and K8 launched, the discoveries' paths re-executed on the host;
5. ``paxos check 2`` through ``spawn_gpu()``: 16,668 unique / 32,971
   states / depth 21, bit-equal to the port's CPU run;
6. ``paxos check 3`` through ``spawn_gpu()`` (two-phase expansion, at
   ``dedup_factor=1``): the golden 1,194,428 unique at depth 28, K1 and
   K3-K8 launched, the discoveries re-executed on the host;
7. the kernels of the ``paxos check 3`` path (K1, K3-K8) against their
   twins on one real wave of that run, replayed from the card's own row
   log -- the first wave of its widest level, against a table rebuilt as
   it stood then -- bit-equal, timed like phase 2; the replayed wave must
   append exactly the rows, parents and ebits the run appended;
8. ``paxos check 3`` with the ``never decided`` property under
   ANY_FAILURES: the counterexample found, replayed on the host, and the
   time to it;
9. ``paxos check 6`` to depth 6 through ``spawn_gpu()`` (64 slots, the
   DP a warp a state): 1,227 unique, bit-equal to the port's CPU run;
10. ``paxos check 6`` (bench.sh:28) through ``spawn_gpu()`` (at
    ``dedup_factor=1``): the golden 9,357,525 unique at depth 28, K1 and
    K3-K8 launched, ``value chosen`` re-executed on the host;
11. the ``paxos check 6`` path's kernels against their twins on one real
    wave of that run, as phase 7 does for ``check 3``;
12. the single-copy register: 3 clients / 1 server (4,243 / 6,778 /
    depth 13) bit-equal to the port's CPU run, and 2 clients / 2 servers,
    whose ``linearizable`` counterexample the card finds and the host
    replays;
13. ``single-copy-register check 4`` (bench.sh:29) through ``spawn_gpu()``
    (single-phase waves through K9): the golden 400,233 unique at depth
    17, K1, K3, K4, K8 and K9 launched;
14. the ``single-copy-register check 4`` path's kernels (K1, K3, K4, K8,
    K9) against their twins on one real wave of that run, replayed as in
    phase 7; the wave must append what the run appended;
15. the ABD quorum register on both fabrics (K10): ``linearizable-register
    check 2`` (544 / 875 / depth 25) and its ordered twin (620 / 883 /
    depth 25) bit-equal to the port's CPU runs, and the ``skip_ack``
    cluster's ``linearizable`` counterexample on both fabrics, replayed
    on the host, with the time to it;
16. ``linearizable-register check 3`` on the unordered fabric through
    ``spawn_gpu()``: the golden 35,009 unique at depth 37;
17. ``linearizable-register check 3 ordered`` (bench.sh:33) through
    ``spawn_gpu()`` (single-phase waves through K10): the golden 46,516
    unique at depth 37, K1, K3, K4, K8 and K10 launched;
18. the ``check 3 ordered`` path's kernels (K1, K3, K4, K8, K10) against
    their twins on one real wave of that run, replayed as in phase 7; the
    wave must append what the run appended;
19. raft (K11: Deliver, Timeout, Crash and Recover lanes; the state's
    identity its row's first 55 of 58 words): ``raft check`` to depth 6
    (4,933 / 13,840) bit-equal to the port's CPU run, and to depth 10
    (844,999 / 2,525,995, the JAX engine's count on its claim path at
    this geometry) at two chunk sizes, bit-equal to each other;
20. the reference's default ``raft check`` (``target_max_depth(12)``)
    through ``spawn_gpu()``: 12,630,223 unique / 38,569,420 states at
    depth 12, the JAX engine's own count at ``dedup_factor=1`` (its CPU
    run, PERF.md), discoveries ``Election Liveness``,
    ``Log Liveness`` and ``Election Safety`` (its path re-executed on the
    host ends in two leaders of one term) and not ``State Machine
    Safety``, K1, K3, K4, K8 and K11 launched; the same run at a quarter
    of the chunk size gives the same counts and logs;
21. the ``raft check`` path's kernels (K1 on the 55-word identity prefix,
    K3, K4, K8, K11) against their twins on one real wave of that run,
    replayed as in phase 7; the wave must append what the run appended;
22. lossy ping-pong at ``max_nat`` 13 (K13, the duplicating network's
    Deliver and Drop lanes, the device boundary) through ``spawn_gpu()``
    on the claim path at the widest geometry the codec allows:
    268,435,454 unique / 3,556,769,793 states (past 2**32) / depth 54,
    the three discoveries; then its kernels against their twins on one
    real wave of that run, replayed as in phase 7;
23. lossy ping-pong at ``max_nat`` 11 at the default ``dedup_factor``:
    the full buffer's flag 4 falls back to the sorted dedup path
    (``sortless=0``, K12) and then relaxes to ``dedup_factor=1`` at 8,192
    states a chunk, as the JAX engine's rules do at these arguments;
    16,777,214 / 188,743,681 / depth 46; then its kernels, K12 among them,
    against their twins on one real wave of its sorted path (K12's sort
    alone and in its wrapper, its prefix and mask entries, beside
    ``torch.sort`` of the buffer and of the prefix), and
    K12 on fuzzed batches (hi >= 2**31, the all-ones key, all
    duplicates, no active lane, sizes up to 2**22 that are no power of
    two; the prefix entry at six counts each);
24. the reference's ping-pong goldens (14 lossy at ``max_nat`` 1, 11
    lossless at 5, 4,094 lossy at 5) and lossy ``max_nat`` 6 at 4,096
    states a chunk, which falls back to the sorted path, each bit-equal
    to the port's CPU run;
25. bounded paxos, single-phase through K14: ``paxos check 3`` at
    ``max_round=3`` (1,194,428 / 2,420,477 / depth 28, its row log held
    against the two-phase run's of phase 6), its kernels against their
    twins on one real wave, c=4 at ``max_round=2`` (435,244 / 867,663 /
    depth 25) and c=2 at ``max_round=1`` bit-equal to the CPU run;
26. raft to depth 10 at the default ``dedup_factor`` (the sorted path
    under a partial identity: 844,936 / 2,525,950, the JAX engine's
    count), its kernels, K12 among them, against their twins on one real
    wave of its sorted path, and raft to depth 7, the shallowest depth
    past the fallback, bit-equal to the CPU run;
27. ``2pc check-sym 12`` through ``spawn_gpu()`` under ``symmetry()``
    (K15 canonicalizes every candidate row before K1 hashes it): 6,656
    orbits / 105,081 states / depth 38 with both agreement discoveries,
    their paths re-executed on the host; rm=10 3,300 / 43,298 / 32 and
    rm=5 314 / 2,048 / 17, each bit-equal to the port's CPU run, and rm=5
    314 again at 64 states a chunk;
28. K15 against its twin on seeded rm=12 rows of every bit pattern (F =
    2**20 states x A = 62 lanes), idempotent, and on synthetic specs (Id
    fields with sentinels >= n, a word-aligned layout with a 32-bit key,
    keys past 64 bits, sixteen records); then the sym12 path's other
    kernels against their twins on one real wave, replayed as in phase 7;
29. the LWW-register CRDT (K16, SelectRandom): 2 nodes to depth 7
    (189,031 / 468,398), 3 nodes to depth 5 (17,364 / 37,504), 2 nodes
    to depth 6 (30,991 / 68,295) bit-equal to the CPU run, all at the
    default ``dedup_factor`` with no discovery; to the reference's depth
    8 the codec's flag stops the run with the JAX engine's error; then
    the depth-7 path's kernels, K16 and K12 among them, against their
    twins on one real wave;
30. the trap counter (K17): ``reaches limit`` (ending in the trap) and
    ``trapped`` discovered, nothing without the trap, the same run under
    the identity canonicalization, and its kernels against their twins;
31. the device walk (K18, ``spawn_gpu_simulation``): 2pc rm=10, one round
    of 4,096 walkers at T = 64, seed 3 -- 44,108 states, depth 23,
    ``abort agreement`` (the JAX engine's round), its path re-executed on
    the host; a 2**18-walker round bit-equal (trace, discoveries, counts,
    lengths, flags) to the same walk through every kernel's twin on the
    card; the path's kernels (K18's four entries, K1, K2) against their
    twins on one real step;
32. raft at depth 12 through ``spawn_gpu_simulation``: 4,096 walkers,
    seed 3 -- 48,439 states, depth 12, ``Election Liveness`` and ``Log
    Liveness``; 2**16 walkers a round to 10M states with no ``State
    Machine Safety`` discovery (the exhaustive check to depth 12 has
    none) and every discovery's path re-executed on the host to where it
    is found (``Election Safety``'s, which phase 20 finds too, ends in two
    leaders of one term); a 2**16-walker round bit-equal to its twins';
    the path's kernels (K18, K1, K11) on one real step;
33. the ABD ``skip_ack`` chaos ensemble (K19 masks each member's lanes):
    ``run_ensemble(replay=False)`` at 1,024 members, seed 7 -- 8,943
    states walked, 939 failing members, two shrink steps, repro member 2
    with 5 steps (the JAX engine's sweep) -- the repro member's trace
    re-executed on the host model to a non-linearizable state; 2**16
    members bit-equal to the twins' sweep; the path's kernels (K18, K19,
    K1, K10) on one real step;
34. ``paxos check 3`` through ``spawn_gpu_tiered()`` at phase 6's
    arguments under a 2 MB budget (a 2**17-slot hot table, K20 merging
    each wave's new keys against the cold runs): 1,194,428 at depth 28,
    its row log, parents, ebits and fingerprints equal to phase 6's,
    spills and cold probes journaled, and K20's two entries against
    their twins on the run's largest cold wave, replayed from its captured
    inputs (bit-equal, leaving the fresh mask the run went on with), timed
    beside ``torch.searchsorted``;
35. a mid-run checkpoint of that tiered run, written by the
    ``checkpoint_every_waves`` cadence once the cold tier holds two runs,
    resumed by a fresh ``spawn_gpu_tiered(resume_from=...)`` to phase 6's
    counts and fingerprints;
36. ``2pc check 5`` tiered at 512 slots and 64 states a chunk on the card
    and on the CPU: logs, the journal's ``spill`` and ``cold_probe``
    events (less their times) and the snapshot's cold arrays bit-equal;
37. ``raft check`` through ``spawn_gpu_tiered()`` at phase 20's arguments
    under a 64 MB budget (2**22 slots, 8 MB probe passes): 12,630,223 /
    38,569,420 / depth 12, at least four spills, fingerprints equal to
    phase 20's, ``Election Safety``'s path re-executed, the peak device
    memory beside phase 20's, and K20 on its largest cold wave as in
    phase 34;
38. the incremental store (``incremental_check``): GridWalk at bound 511
    cold and stored (262,144 states), widened to 1,023 by a resume seeded
    from the stored set (K21 launched; 1,048,576 states, fingerprints and
    discoveries equal to a cold bound-1,023 run's), and the same
    request again served from the verdict cache with no kernel launched;
39. 2pc rm=9 cold and stored, then ``TwoPhaseEdited.build(9)``: the
    property-only re-check over the stored row log through K2c and K22,
    with no ``wave`` event and no exploration kernel launched, its counts,
    discoveries and paths equal to a cold card run of the edited model;
40. ``paxos check 3`` at ``max_round=1`` cold and stored, then the
    unbounded check seeded from it: phase 6's 1,194,428 states and
    fingerprints, bit for bit (each of phases 38-40 prints the cold run's,
    the store write's and the re-check's seconds);
41. K21, K2c and K22 against their twins on those paths' inputs (a chunk of
    the widened GridWalk's log, the first 2**20 rows of the rm=9 log and
    their conds), bit-equal, timed, K22 beside ``torch.argmax``;
42. gang-grid: eight GridWalks at bounds 248-255 through ``run_gang`` at
    the gang worker's width (K = 8, F = 256; the widest diagonal holds 256
    states), every wave one launch each of K21g, K23 and K1; each member's
    counts, verdicts, discovery paths and fingerprints equal its solo
    ``spawn_gpu`` run on the card; the gang's waves and wall seconds beside
    the members' solo seconds;
43. gang-cap: eight CapCounters with mixed verdicts (JAX's four, limits to
    1,000, a cap past 2**31) through K24's gang entry, the ``violation``
    list exact, each member equal to its solo run (K24's solo entry);
44. a gang of 5 GridWalks, padded to K = 8: the same launches a wave, each
    member equal to its solo run;
45. the eject case: GridWalk(2) and GridWalk(12) at F = 8 -- the second
    ejected with the JAX package's reason, the first equal to the CPU
    gang's;
46. raft to depth 6 with an edited ``property_conds`` (an appended ALWAYS
    property, "at the init row") bit-equal to the port's CPU run, the
    override's discovery found: the fused step kernel (K11) carries the
    override's conds;
47. K21g, K23, K24 (both entries) and K1 against their twins on the widest
    real wave of gang-grid and gang-cap, bit-equal, timed, K23 beside
    ``torch.argmax`` over the precomputed hit columns;
48. traced mode (``trace=True``): ``2pc check 10`` at full width, its
    counts, row log, parents, ebits and fingerprints equal to phase 4's
    untraced run; its summary (breakdown, modeled bytes,
    ``hbm_util_frac``, ``bottleneck_phase``) printed against the card's
    peak, which must not be the estimated fallback; no wave and no phase
    above 1.05 of the peak, every wave's breakdown at least 0.9 of its
    call time (the share of the waves' wall span the phases cover is
    printed); K25 (the append) against its twin and the torch glue it
    replaced on the run's widest commit (the claim path), bit-equal to
    what the run appended;
49. traced ``paxos check 3``: the same checks against phase 6's run, K25
    on its widest commit (the two-phase path);
50. traced tiered ``paxos check 3`` under phase 34's budget: the same
    checks against phase 6's fingerprints, ``cold_probe`` in every traced
    wave's breakdown;
51. a visitor on ``2pc check 5``: 8,832 visits, one a state;
52. ``paxos check 3`` through ``spawn_gpu_sharded(mesh=["cuda:0"] * 4)``
    (four shards of the card: K12 and K26 on every sender, the exchange's
    slice copies, K1, K4 and K27 on every owner): the golden 1,194,428 at
    depth 28, fingerprints equal to phase 6's, the accounting (waves,
    all-to-all bytes, occupancy, skew) printed;
53. ``2pc check 10`` on four shards (2**26 slots a shard): 61,515,776 at
    depth 32, fingerprints equal to phase 4's, the peak device memory;
54. ``paxos check 3`` on a 1-shard mesh: the exchange elided, K26 and K12
    never launched, phase 6's fingerprints;
55. the paxos C = 2 pin of ``test_tpu_sharded.py:247``: 16,668 at 1/2/4/8
    shards, each set the single-card run's; at 8 shards at most 250 MB of
    all-to-all bytes and an occupancy of at least 0.02; ``bucket_slack=1``
    at 2 shards retries at least once;
56. ``2pc check-sym 12`` on four shards: 6,656 orbits, K15 launched;
57. a mid-run checkpoint of phase 52's run (cut at depth 15) resumed on
    four shards to phase 6's counts and fingerprints, and refused on two
    with the JAX engine's message;
58. K26, K27, K1, K4 and K12 (and K15 on sh-sym12) against their twins on
    the widest waves of phases 52, 53 and 56, captured from the runs: K12
    and K26 on the sender with the most lanes, K1, K4 (into the owner's
    table as it stood) and K27 (replayed into fresh tables, equal to what
    the run wrote) on the owner that committed the most; K26 timed beside
    ``torch.sort(stable=True)`` of its owner keys;
59. tr-sh-paxos3: ``paxos check 3`` through ``spawn_gpu_sharded(mesh=
    ["cuda:0"] * 4, trace=True)`` (each phase of each wave ended by a sync
    of the card): 1,194,428 at depth 28, phase 6's fingerprints, the
    traced summary's checks (no wave or phase above 1.05 of the peak), the
    journal's summed ``exchange_payload_bytes`` equal to the accounting's,
    and the measured breakdown printed;
60. tr-sh1-paxos3: the same on a 1-shard mesh: 0 exchange bytes and
    payload, phase 6's fingerprints;
61. ts-paxos3: ``paxos check 3`` through ``spawn_gpu_tiered_sharded(mesh=
    ["cuda:0"] * 4, memory_budget_mb=2)`` (131,072 slots a shard; K20
    filters each owner's new keys against its own cold runs, K28 appends
    the fresh ones): 1,194,428 at depth 28, phase 6's fingerprints, every
    shard spilled, cold hits; spills, cold entries, peak memory and
    seconds printed;
62. ts-sym12: ``2pc check-sym 12`` tiered-sharded on four shards at 0.016
    MB (1,024 slots a shard): 6,656 orbits, spills, K15 launched;
63. ts-reshard: ts-paxos3 cut at depth 15 and resharded on the host 4 -> 2
    and 4 -> 8 (``reshard_snapshot``), each resumed on that many shards to
    phase 6's counts and fingerprints; a plain sh-paxos3 checkpoint
    resharded into a 2-shard tiered one resumes to them too; the 4-shard
    tiered snapshot resumed on 2 shards without a reshard fails with the
    JAX engine's message;
64. K28 against its twin on ts-paxos3's and ts-sym12's widest appends
    (captured inputs, bit-equal to each other and to the run's log, timed
    beside the torch glue it replaced); K20, K1 and K4 on ts-paxos3's
    largest cold filter and widest owner insert; K15 on ts-sym12's; K26,
    K27, K1, K4 and K12 on tr-sh-paxos3's widest waves;
65. the fused quantum (K29): ``2pc check 10`` and ``paxos check 3`` at
    the default ``waves_per_call`` (256) and at 1, the same logs and
    fingerprints either way, the quantum's readbacks fewer; each one's warm
    seconds, readbacks, graph captures and (one profiled run) the card's
    idle share printed beside the per-wave loop's seconds of earlier PRs;
66. ``2pc check 10`` from a 2**20-slot table: flag 1 falls inside a
    quantum (the quantum committed waves before it), the table grows and
    the run ends at phase 4's fingerprints;
67. ``2pc check 10`` under ``finish_when(ANY)``: the quantum stops inside
    itself at the first discovery, with the discovery ids and counts of the
    one-wave-a-call run;
68. ``2pc check 5`` (18 waves) in one 256-wave quantum against one of 18:
    warm medians of five, the 256 run within 1.3x -- stopped waves cost
    nothing;
69. K29's ``wave_load`` and ``wave_ctl`` and the device-count entries of
    K8, K4, K1 (two-phase) and K25 against their twins on the replayed
    widest waves of ``2pc check 10`` and ``paxos check 3`` at the card's
    full chunk, bit-equal, timed, with bounds, appending what the runs
    appended;
70. ``paxos check 2`` on four shards on the sorted path
    (``sortless=False``): the senders' dedup through K12's prefix entry,
    the owners' insert through its mask entry, the single card's
    fingerprints, and K12's mask entry against its twin on the widest
    owner batch;
71. K26 (``owner_bucket``), K20's probe, K4 (both entries) and K27
    (``shard_commit``) against their twins on fuzzed inputs
    (:func:`phase_bucket_fuzz`, :func:`phase_cold_probe_fuzz`,
    :func:`phase_insert_fuzz`, :func:`phase_commit_fuzz`): bit-equal at 1
    to 1,024 owners and 0 to 2**20 - 3 lanes, rows of 1 to 80 words, every
    lane to one owner, buckets full and one over; chunks of 1 to 2**20
    keys, keys at and above 2**63, queries at a chunk's ends, all-false and
    all-true masks, with and without ``origin``; K4 at 1 to 2**20 lanes
    around its one-block tile, one key in 1 to 1,000 lanes, keys present
    before, a full table, a replayed CUDA graph of the device entry and
    the epoch's wrap; K27 with no, every or only last-tile lanes new, a
    queue that overflows, rows of 1 and 77 words, strided or contiguous
    ``gid``/``eb``; each entry's operations on the card per call counted
    as the nodes of a captured graph and logged (K4: one on its one-block
    path, two above; K27: one);
72. one ``{"kernels": [...]}`` line -- a row per kernel and path, its
    launches, times and bound all from that path's run and shapes (K20's
    probe rows also the time turning through the wave's chunks) -- the
    ``nvidia-smi`` line, and last the ``{"ok": true, "device": {...}}``
    line.

Every untraced ``spawn_gpu`` run of phases 3-47 and 52-69 goes through the
fused quantum (``parallel/fused.py``): up to ``waves_per_call`` waves on the
card behind one readback, one launch of a captured CUDA graph; a kernel's
launches inside the graph count once a wave the quantum ran.  Phase 23
holds K25 on the replayed sorted-path wave's commit (the run's commits are
inside its quanta), and its grow notes are checked less the density
tuners' rung climbs.

Phase 23 also holds K25 against its twin on the run's widest sorted-path
commit, and every replayed insert (phases 2, 7, 11, 14, 18, 21-23, 25-30)
logs K4's probe figures (its longest chain and the slots it read) beside
its twin's lockstep rounds and slots.

The launch counts of each path are set to 0 just before it and read just
after; a kernel of the path launched no time fails the run.  The script
imports neither ``jax`` nor ``stateright_tpu``, uses one card (the first
visible one), and exits non-zero with no result line where no CUDA device
is visible or the port's package is not beside it.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import fields
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
F = 1 << 20  # states per wave at rm=10 (max_frontier)
RM = 10
CAPACITY = 1 << 27
LOG_CAPACITY = 1 << 26  # >= 61,515,776 positions
HBM_BYTES_PER_SEC = 3.35e12  # H100 SXM, NVIDIA data sheet
GOLDEN_RM5 = (8_832, 58_146, 17)
GOLDEN_RM10 = (61_515_776, 32)
GOLDEN_PAXOS2 = (16_668, 32_971, 21)
GOLDEN_PAXOS3 = (1_194_428, 28)
GOLDEN_PAXOS6 = (9_357_525, 28)
GOLDEN_PAXOS6_D6 = (1_227, 2_003, 6)
GOLDEN_SC3 = (4_243, 6_778, 13)
GOLDEN_SC4 = (400_233, 17)
GOLDEN_ABD2 = (544, 875, 25)
GOLDEN_ABD2O = (620, 883, 25)
GOLDEN_ABD3 = (35_009, 37)
GOLDEN_ABD3O = (46_516, 37)
GOLDEN_RAFT_D6 = (4_933, 13_840, 6)
GOLDEN_RAFT_D10 = (844_999, 2_525_995, 10)
# The JAX engine's raft check at dedup_factor=1 (its CPU run, PERF.md).
GOLDEN_RAFT = (12_630_223, 38_569_420, 12)
RAFT_FOUND = ["Election Liveness", "Election Safety", "Log Liveness"]
# Lossy ping-pong: unique 4**(n+1) - 2, states n * 4**(n+1) + 4**n + 1,
# depth 4n + 2 (the JAX engine's counts through n = 11).
GOLDEN_PP13 = (268_435_454, 3_556_769_793, 54)
GOLDEN_PP11 = (16_777_214, 188_743_681, 46)
PP_FOUND = ["can reach max", "must exceed max", "must reach max"]
# What the JAX engine's growth writes at PP11S_GEOMETRY, every note of the
# run: the claim path's full buffer (425,984 lanes) falls back to the
# sorted path, whose overflow relaxes to dedup_factor=1, halving the chunk
# to the band.  No climb of a rung the density tuners cut (a sort_lanes=
# or step_lanes= note) follows on this run.
PP11S_NOTES = [
    "sortless=0",
    "dedup_factor=1; max_frontier=32768; max_frontier=16384; max_frontier=8192",
]
GOLDEN_PAXOS3B = (1_194_428, 2_420_477, 28)
GOLDEN_PAXOS4B = (435_244, 867_663, 25)
GOLDEN_PAXOS2B = (1_834, 3_535, 18)
GOLDEN_RAFT10S = (844_936, 2_525_950, 10)
GOLDEN_RAFT7S = (17_317, 50_269, 7)
# paxos check 3: 1,194,428 states fill a 2**22-slot table to 0.28 and a
# 2**21-position log to 0.57; a wave expands 2**16 states (2**21 lanes) into
# a buffer as wide as the candidates.  (At dedup_factor=4 the JAX band,
# 262,144 lanes at 42 words, would halve the chunk; the run never
# overflows, so at 1 it writes the same log at the full chunk.)
PAXOS3_GEOMETRY = dict(
    capacity=1 << 22, log_capacity=1 << 21, max_frontier=1 << 16,
    dedup_factor=1,
)
# paxos check 6: 9,357,525 states fill a 2**25-slot table to 0.28 and a
# 2**24-position log (5.2 GB of rows) to 0.56; a wave expands 2**17 states
# (2**23 lanes, 64 a state) into a buffer as wide as the candidates (at
# dedup_factor=4 the band, 142,987 lanes at 77 words, would cut the chunk
# to 8,192 states).
PAXOS6_GEOMETRY = dict(
    capacity=1 << 25, log_capacity=1 << 24, max_frontier=1 << 17,
    dedup_factor=1,
)
# single-copy-register check 4: 400,233 states in a 2**21-slot table (load
# 0.19); a wave expands 2**16 states (2**19 lanes, 8 a state) into a
# buffer as wide as the candidates.
SC4_GEOMETRY = dict(capacity=1 << 21, max_frontier=1 << 16, dedup_factor=1)
# linearizable-register check 3 (both fabrics): under 47K states in a
# 2**17-slot table (load 0.35); a wave expands up to 2**13 states, the
# widest level in one wave, into a buffer as wide as the candidates.
ABD3_GEOMETRY = dict(capacity=1 << 17, max_frontier=1 << 13, dedup_factor=1)
# raft to depth 10: the geometry of the JAX CPU run it is held to.
RAFT_D10_GEOMETRY = dict(capacity=1 << 21, max_frontier=1 << 12, dedup_factor=1)
# raft check: about 12.6M states in a 2**25-slot table (load about 0.38)
# and a 14M-position log (240 bytes a position with parent and ebits:
# 3.4 GB); a wave expands 2**16 states into 2**16 * 36 candidate rows of
# 232 bytes (547 MB), a buffer as wide as the candidates.
RAFT_GEOMETRY = dict(
    capacity=1 << 25, log_capacity=14_000_000, max_frontier=1 << 16,
    dedup_factor=1,
)
# Lossy ping-pong at max_nat 13, the codec's widest: 268M states in the
# port's largest table (2**30 slots, load 0.25; 16 GB of key and election
# planes) and a 2**28-position log (4.3 GB with parents and ebits); a wave
# expands 2**16 states into 3.9M candidate lanes, a buffer as wide.
PP13_GEOMETRY = dict(
    capacity=1 << 30, log_capacity=1 << 28, max_frontier=1 << 16,
    dedup_factor=1,
)
# Lossy ping-pong at max_nat 11 at the default dedup_factor (8): 16.8M
# states in a 2**26-slot table (load 0.25); the 425,984-lane buffer
# overflows mid-run and the sorted path takes over.
PP11S_GEOMETRY = dict(capacity=1 << 26, max_frontier=1 << 16)
# Bounded paxos check 3: the two-phase run's geometry, single-phase.
PAXOS3B_GEOMETRY = dict(capacity=1 << 22, max_frontier=1 << 16, dedup_factor=1)
# raft to depth 10 at the default dedup_factor: the sorted path.
RAFT10S_GEOMETRY = dict(capacity=1 << 21, max_frontier=1 << 12)
# 2pc under symmetry: the JAX engine's orbit counts at this geometry.
SYM_GEOMETRY = dict(capacity=1 << 20, max_frontier=1 << 13)
GOLDEN_SYM = {5: (314, 2_048, 17), 10: (3_300, 43_298, 32),
              12: (6_656, 105_081, 38)}
SYM_FOUND = ["abort agreement", "commit agreement"]
# LWW at the default dedup_factor (its waves fall back to the sorted path).
LWW_GEOMETRY = dict(capacity=1 << 22, max_frontier=1 << 14)
GOLDEN_LWW2D7 = (189_031, 468_398, 7)
GOLDEN_LWW3D5 = (17_364, 37_504, 5)
GOLDEN_LWW2D6 = (30_991, 68_295, 6)
TRAP_GEOMETRY = dict(capacity=1 << 10, max_frontier=1 << 4)
# The device walk's goldens: the JAX engine's spawn_tpu_simulation on the
# CPU (JAX 0.9.0) at these arguments, one round each.
GOLDEN_SIM_RM10 = (44_108, 23, ["abort agreement"])
GOLDEN_SIM_RAFT = (48_439, 12, ["Election Liveness", "Log Liveness"])
SIM_WALKERS = 4_096
SIM_RM10_WIDE = 1 << 18  # walkers of the rm=10 batch held to its twins
SIM_RAFT_WIDE = 1 << 16  # walkers a round of the long raft run
SIM_RAFT_TARGET = 10_000_000
# The exhaustive raft check to depth 12 finds Election Safety's
# counterexample (phase 20) and no State Machine Safety one, so a walk
# bounded at depth 12 may find the first and can never find the second.
RAFT_NEVER = "State Machine Safety"
# The chaos ensemble: tests/test_ensemble.py's sweep (JAX engine, CPU).
ENS_ARGS = dict(seed=7, steps=48, fault="skip_ack",
                chaos='{"default": {"drop": 0.1}}', shrink=True, replay=False)
GOLDEN_ENS = dict(members=1_024, states_walked=8_943, failing=939,
                  shrink_steps=2, repro_member=2, repro_steps=5)
ENS_WIDE = 1 << 16
# Integer operations of one Threefry-2x32 hash: 20 rounds of add, rotate
# (one funnel shift by a constant) and xor, and six key injections of one
# add to each counter word (the round constant joins the same three-input
# add).
THREEFRY_OPS = 20 * 3 + 6 * 2
# Hashes of a walker's draw (``split`` and ``randint``): the split's two
# rows, then randint's own split and its two 32-bit draws.
DRAW_HASHES = 2 + 2 + 2
SEED = 20261017
# The tiered checker: phase 6's and phase 20's spawn arguments under a
# budget.  2 MB is a 2**17-slot hot table for paxos check 3 (about twenty
# spills of its 1.2M states), 64 MB a 2**22-slot table for raft check
# (16 bytes a slot on the card, tiered/engine.py), with 8 MB probe passes.
TIERED_PAXOS3_ARGS = dict(PAXOS3_GEOMETRY, memory_budget_mb=2)
TIERED_RAFT_ARGS = dict(RAFT_GEOMETRY, memory_budget_mb=64, cold_chunk=1 << 20)
TIERED_RM5_ARGS = dict(capacity=512, max_frontier=1 << 6)
# Integer operations of one step of K20's search: the address add, the
# 64-bit compare (two words) and the select of the next position.
COLD_STEP_OPS = 4

# The incremental store (phases 38-41).  GridWalk: (bound + 1)**2 states;
# bound 1,023's widest level is 1,024 states, its seed level 262,144 (16
# waves of 2**14).  2pc rm=9: about 10.4M states (rm=8 gives 1,745,408 on
# the CPU, each RM multiplies by about 5.9) in a 2**25-slot table and a
# 2**24-position log, 2**20 states a wave as at rm=10.  paxos check 3 at
# max_round=1 seeds the unbounded re-check, which must reach phase 6's set.
GRID_BOUNDS = (511, 1023)
GRID_GEOMETRY = dict(capacity=1 << 22, max_frontier=1 << 14, dedup_factor=1)
RM9 = 9
RM9_GEOMETRY = dict(capacity=1 << 25, log_capacity=1 << 24, max_frontier=F,
                    dedup_factor=1)
PAXOS3_SEED_ROUND = 1
# Gang batching at the gang worker's defaults (stateright_tpu/fleet/
# worker.py:54-56: gang_max 8, gang_frontier 256).  GridWalk's widest
# diagonal at bound 255 holds 256 states, so bounds 248-255 just fit F; the
# capped counters mix JAX's four (tests/test_fleet.py:230) with limits up to
# 1,000 and a cap past 2**31.  Solo runs for comparison at a geometry that
# holds 65,536 states.
GANG_F = 256
GANG_GRID_BOUNDS = tuple(range(248, 256))
GANG_CAP_PARAMS = ((4, 10), (12, 8), (6, 6), (9, 20), (1000, 999),
                   (1000, 2**31 + 7), (700, 700), (0, 0))
GANG_CAP_VIOLATIONS = [None, "within cap", None, None, "within cap", None,
                       None, None]
GANG_OF_5 = (100, 37, 64, 3, 200)
GANG_SOLO = dict(capacity=1 << 17, max_frontier=1 << 8)
GOLDEN_EDITED_RAFT_D6 = (4_933, 13_840, 6)  # the stock model's counts

KERNELS = {
    # name: (source, the JAX function it replaces)
    "device_fp64": ("stateright_tpu_torch/csrc/device_fp.cu",
                    "stateright_tpu/ops/device_fp.py:52"),
    "twophase_step": ("stateright_tpu_torch/csrc/twophase_step.cu",
                      "stateright_tpu/models/twophase_compiled.py:95"),
    "compact": ("stateright_tpu_torch/csrc/compact.cu",
                "stateright_tpu/parallel/wave_common.py:267"),
    "insert_batch_claim": ("stateright_tpu_torch/csrc/hashset.cu",
                           "stateright_tpu/parallel/hashset.py:365"),
    "paxos_step_valid": ("stateright_tpu_torch/csrc/paxos_valid.cu",
                         "stateright_tpu/models/paxos_compiled.py:549"),
    "paxos_conds": ("stateright_tpu_torch/csrc/paxos_conds.cu",
                    "stateright_tpu/models/paxos_compiled.py:919"),
    "paxos_step_lane": ("stateright_tpu_torch/csrc/paxos_lane.cu",
                        "stateright_tpu/models/paxos_compiled.py:625"),
    "wave_eval": ("stateright_tpu_torch/csrc/wave_eval.cu",
                  "stateright_tpu/parallel/wave_common.py:282"),
    "single_copy_step": ("stateright_tpu_torch/csrc/single_copy_step.cu",
                         "stateright_tpu/models/single_copy_compiled.py:202"),
    "abd_step": ("stateright_tpu_torch/csrc/abd_step.cu",
                 "stateright_tpu/models/abd_compiled.py:465"),
    "raft_step": ("stateright_tpu_torch/csrc/raft_step.cu",
                  "stateright_tpu/models/raft_compiled.py:418"),
    "prededup": ("stateright_tpu_torch/csrc/prededup.cu",
                 "stateright_tpu/parallel/hashset.py:232"),
    # K12's prefix entry: the sorted path's buffers, whose active lanes are
    # compact_valid's prefix of n_valid lanes.
    "prededup_prefix": ("stateright_tpu_torch/csrc/prededup.cu",
                        "stateright_tpu/parallel/hashset.py:232"),
    "ping_pong_step": ("stateright_tpu_torch/csrc/ping_pong_step.cu",
                       "stateright_tpu/models/ping_pong_compiled.py:138"),
    "paxos_step": ("stateright_tpu_torch/csrc/paxos_step.cu",
                   "stateright_tpu/models/paxos_compiled.py:541"),
    "canonicalize_rows": ("stateright_tpu_torch/csrc/canon.cu",
                          "stateright_tpu/parallel/canon.py:182"),
    "lww_step": ("stateright_tpu_torch/csrc/lww_step.cu",
                 "stateright_tpu/models/lww_compiled.py:195"),
    "trap_step": ("stateright_tpu_torch/csrc/fixtures_step.cu",
                  "stateright_tpu/models/fixtures.py:201"),
    # K18's four entries: the walkers' keys, the init draw, a step and the
    # leftover-eventually pass.
    "walker_keys": ("stateright_tpu_torch/csrc/walk.cu",
                    "stateright_tpu/parallel/simulation_tpu.py:324"),
    "walk_init": ("stateright_tpu_torch/csrc/walk.cu",
                  "stateright_tpu/parallel/simulation_tpu.py:106"),
    "walk_step": ("stateright_tpu_torch/csrc/walk.cu",
                  "stateright_tpu/parallel/simulation_tpu.py:49"),
    "walk_finish": ("stateright_tpu_torch/csrc/walk.cu",
                    "stateright_tpu/parallel/simulation_tpu.py:230"),
    "fate_mask": ("stateright_tpu_torch/csrc/fate.cu",
                  "stateright_tpu/ensemble/engine.py:80"),
    # K20's two entries: the new keys' minimum and maximum, and a pass of
    # the merge-join (with fresh_of, engine.py:265, folded in).
    "cold_query": ("stateright_tpu_torch/csrc/cold.cu",
                   "stateright_tpu/tiered/engine.py:223"),
    "cold_probe": ("stateright_tpu_torch/csrc/cold.cu",
                   "stateright_tpu/tiered/engine.py:245"),
    "grid_walk": ("stateright_tpu_torch/csrc/fixtures_step.cu",
                  "stateright_tpu/models/fixtures.py:337"),
    "twophase_conds": ("stateright_tpu_torch/csrc/twophase_step.cu",
                       "stateright_tpu/models/fixtures.py:518"),
    "first_hits": ("stateright_tpu_torch/csrc/recheck.cu",
                   "stateright_tpu/incr/recheck.py:153"),
    "grid_walk_gang": ("stateright_tpu_torch/csrc/fixtures_step.cu",
                       "stateright_tpu/models/fixtures.py:386"),
    "cap_counter": ("stateright_tpu_torch/csrc/fixtures_step.cu",
                    "stateright_tpu/models/fixtures.py:456"),
    "cap_counter_gang": ("stateright_tpu_torch/csrc/fixtures_step.cu",
                         "stateright_tpu/models/fixtures.py:484"),
    "gang_eval": ("stateright_tpu_torch/csrc/gang.cu",
                  "stateright_tpu/fleet/gang.py:216"),
    "append_block": ("stateright_tpu_torch/csrc/append.cu",
                     "stateright_tpu/parallel/wavefront.py:1666"),
    "owner_bucket": ("stateright_tpu_torch/csrc/exchange.cu",
                     "stateright_tpu/parallel/sharded.py:683"),
    "shard_commit": ("stateright_tpu_torch/csrc/shard_commit.cu",
                     "stateright_tpu/parallel/sharded.py:789"),
    "shard_log_append": ("stateright_tpu_torch/csrc/shard_commit.cu",
                         "stateright_tpu/tiered/sharded_engine.py:289"),
    # K29: the fused loop's chunk load and its control (the carry, the
    # wave_body tail, wave_cond) -- the JAX run()'s while_loop.
    "wave_load": ("stateright_tpu_torch/csrc/wave_ctl.cu",
                  "stateright_tpu/parallel/wavefront.py:614"),
    "wave_ctl": ("stateright_tpu_torch/csrc/wave_ctl.cu",
                 "stateright_tpu/parallel/wavefront.py:493"),
    # The device-count entries of K8, K4, K1 and K25 the fused wave runs.
    "wave_eval_dev": ("stateright_tpu_torch/csrc/wave_eval.cu",
                      "stateright_tpu/parallel/wave_common.py:282"),
    "insert_batch_claim_dev": ("stateright_tpu_torch/csrc/hashset.cu",
                               "stateright_tpu/parallel/hashset.py:365"),
    "device_fp64_n": ("stateright_tpu_torch/csrc/device_fp.cu",
                      "stateright_tpu/ops/device_fp.py:52"),
    "append_block_dev": ("stateright_tpu_torch/csrc/append.cu",
                         "stateright_tpu/parallel/wavefront.py:744"),
}
# The fused quantum's entries (K29 and the device-count entries of K8, K4
# and K25), which every untraced spawn_gpu run launches; the per-wave
# loop's host entries of K8, K4 and K25 (traced and tiered runs).
FUSED_ENTRIES = ("wave_load", "wave_ctl", "wave_eval_dev",
                 "insert_batch_claim_dev", "append_block_dev")
HOST_ENTRIES = ("wave_eval", "insert_batch_claim", "append_block")
# The kernels each path must launch; the kernels line has a row for each.
# An untraced run's rows are the entries it launches, measured on one of
# its waves (the single-phase waves hash through K1's whole-buffer entry,
# the two-phase ones through its counted entry); the host entries'
# measurements at rm10's and paxos3's shapes are the traced runs' rows.
PATH_KERNELS = {
    "rm10": ("device_fp64", "twophase_step", "compact") + FUSED_ENTRIES,
    "paxos3": ("compact", "paxos_step_valid", "paxos_conds",
               "paxos_step_lane", "device_fp64_n") + FUSED_ENTRIES,
    "paxos6": ("compact", "paxos_step_valid", "paxos_conds",
               "paxos_step_lane", "wave_eval_dev", "insert_batch_claim_dev",
               "device_fp64_n"),
    "sc4": ("device_fp64", "single_copy_step", "compact",
            "insert_batch_claim_dev", "wave_eval_dev"),
    "abd3o": ("device_fp64", "abd_step", "compact", "insert_batch_claim_dev",
              "wave_eval_dev"),
    "raft": ("device_fp64", "raft_step", "compact", "insert_batch_claim_dev",
             "wave_eval_dev"),
    "pp13": ("device_fp64", "ping_pong_step", "compact",
             "insert_batch_claim_dev", "wave_eval_dev"),
    "pp11s": ("device_fp64", "ping_pong_step", "compact",
              "insert_batch_claim_dev", "wave_eval_dev", "prededup_prefix",
              "append_block_dev"),
    "paxos3b": ("device_fp64", "compact", "insert_batch_claim_dev",
                "paxos_step", "paxos_conds", "wave_eval_dev"),
    "raft10s": ("device_fp64", "raft_step", "compact",
                "insert_batch_claim_dev", "wave_eval_dev", "prededup_prefix"),
    "sym12": ("device_fp64", "twophase_step", "canonicalize_rows", "compact",
              "insert_batch_claim_dev", "wave_eval_dev"),
    "lww": ("device_fp64", "lww_step", "compact", "insert_batch_claim_dev",
            "wave_eval_dev", "prededup_prefix"),
    "trap": ("device_fp64", "trap_step", "compact", "insert_batch_claim_dev",
             "wave_eval_dev"),
    # The traced runs of rm10 and paxos3 keep the per-wave loop: the host
    # entries of K8, K4 and K25 (and K1's whole-buffer entry two-phase).
    "tr-rm10": HOST_ENTRIES,
    "tr-paxos3": ("device_fp64",) + HOST_ENTRIES,
    "sim-rm10": ("device_fp64", "twophase_step", "walker_keys", "walk_init",
                 "walk_step", "walk_finish"),
    "sim-raft": ("device_fp64", "raft_step", "walker_keys", "walk_init",
                 "walk_step", "walk_finish"),
    "ens-abd": ("device_fp64", "abd_step", "walker_keys", "walk_init",
                "walk_step", "walk_finish", "fate_mask"),
    # The tiered paths: K20 has its rows here; the in-HBM kernels they
    # launch too (ALSO_LAUNCHED) have theirs on the in-HBM paths.
    "tiered-paxos3": ("cold_query", "cold_probe"),
    "tiered-raft": ("cold_query", "cold_probe"),
    # The incremental store's re-checks: GridWalk widened (K21 with K1, K3,
    # K4, K8), the 2pc property-only re-eval (K2c and K22, no wave) and
    # paxos check 3 widened (the paxos3 path's kernels).
    "incr-grid": ("grid_walk",),
    "incr-2pc": ("twophase_conds", "first_hits"),
    "incr-paxos3": (),
    # The gang waves: the family's gang kernel, K23 and K1, nothing else;
    # cap-solo is gang-cap's members run solo through K24's solo entry.
    "gang-grid": ("grid_walk_gang", "gang_eval", "device_fp64"),
    "gang-cap": ("cap_counter_gang", "gang_eval", "device_fp64"),
    "cap-solo": ("cap_counter",),
    # The sharded paths on four shards of the card: K26 and K27, and K1, K4
    # and K12 as the sharded wave runs them (K12's prefix entry on every
    # sender, K1 and K4 on every owner's receive buffer); K15 under
    # symmetry.  sh-paxos2s is the sorted path, whose owners insert
    # through K12's mask entry (the received validity is no prefix).
    "sh-paxos3": ("owner_bucket", "shard_commit", "device_fp64",
                  "insert_batch_claim", "prededup_prefix"),
    "sh-rm10": ("owner_bucket", "shard_commit", "device_fp64",
                "insert_batch_claim", "prededup_prefix"),
    "sh-sym12": ("owner_bucket", "shard_commit", "device_fp64",
                 "insert_batch_claim", "prededup_prefix", "canonicalize_rows"),
    "sh-paxos2s": ("prededup",),
    # Traced on four shards: K26 and K27 as the traced phases run them.
    "tr-sh-paxos3": ("owner_bucket", "shard_commit"),
    # Tiered-sharded on four shards: K28 appends (no K27), K20 filters, the
    # owners' K1 and K4 (and the plane rebuilds'); K15 under symmetry.
    "ts-paxos3": ("shard_log_append", "cold_query", "cold_probe",
                  "device_fp64", "insert_batch_claim"),
    "ts-sym12": ("shard_log_append", "canonicalize_rows"),
}
# The per-wave path's kernels besides the host entries.
PER_WAVE_2PC = ("device_fp64", "twophase_step", "compact")
PER_WAVE_PAXOS = ("device_fp64", "compact", "paxos_step_valid", "paxos_conds",
                  "paxos_step_lane")
ALSO_LAUNCHED = {
    # The untraced runs' K29 and K25 entries with no row on their path.
    **{path: ("wave_load", "wave_ctl", "append_block_dev")
       for path in ("paxos6", "sc4", "abd3o", "raft", "pp13", "paxos3b",
                    "raft10s", "sym12", "lww", "trap")},
    "pp11s": ("wave_load", "wave_ctl"),
    "tr-rm10": PER_WAVE_2PC,
    "tr-paxos3": PER_WAVE_PAXOS,
    # The tiered checker keeps the per-wave loop: no K29, the host entries.
    "tiered-paxos3": PER_WAVE_PAXOS + HOST_ENTRIES,
    "tiered-raft": ("device_fp64", "raft_step", "compact", "insert_batch_claim",
                    "wave_eval"),
    "incr-grid": ("device_fp64", "compact") + FUSED_ENTRIES,
    "incr-paxos3": PATH_KERNELS["paxos3"],
    "cap-solo": ("device_fp64", "compact") + FUSED_ENTRIES,
    "sh-paxos3": ("compact", "paxos_step_valid", "paxos_conds",
                  "paxos_step_lane", "wave_eval"),
    "sh-rm10": ("twophase_step", "compact", "wave_eval"),
    "sh-sym12": ("twophase_step", "compact", "wave_eval"),
    "sh-paxos2s": ("prededup_prefix", "owner_bucket", "shard_commit",
                   "device_fp64", "insert_batch_claim", "compact",
                   "paxos_step_valid", "paxos_conds", "paxos_step_lane",
                   "wave_eval"),
    "tr-sh-paxos3": ("device_fp64", "insert_batch_claim", "prededup_prefix",
                     "compact", "paxos_step_valid", "paxos_conds",
                     "paxos_step_lane", "wave_eval"),
    "ts-paxos3": ("owner_bucket", "prededup_prefix", "compact",
                  "paxos_step_valid", "paxos_conds", "paxos_step_lane",
                  "wave_eval"),
    "ts-sym12": ("owner_bucket", "device_fp64", "insert_batch_claim",
                 "prededup_prefix", "twophase_step", "compact", "wave_eval",
                 "cold_query", "cold_probe"),
}


T0 = time.monotonic()


def log(msg: str) -> None:
    if msg.startswith("phase "):
        msg += f" [t={time.monotonic() - T0:.1f}s]"
    print(msg, flush=True)


def use_one_card() -> str:
    """Make only the first visible card visible to this process (before
    torch is imported), so the run uses one card and
    ``torch.cuda.device_count()`` says so; returns its ``nvidia-smi``
    index or UUID."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0].strip()
    os.environ["CUDA_VISIBLE_DEVICES"] = visible
    return visible


def nvidia_smi(query: str, fmt: str = "csv,noheader") -> str:
    """One ``nvidia-smi --query-gpu`` line of the card the run uses."""
    card = os.environ.get("CUDA_VISIBLE_DEVICES", "0")
    out = subprocess.run(
        ["nvidia-smi", "-i", card, f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def gpu_line() -> str:
    """``name, power.limit`` of the card the run uses."""
    return nvidia_smi("name,power.limit")


def int32_rate() -> float:
    """The card's 32-bit integer issue rate in operations a second, derived
    (not a data-sheet figure): 132 SMs x 64 INT32 lanes x the maximum SM
    clock ``nvidia-smi`` reports."""
    mhz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits"))
    return 132 * 64 * mhz * 1e6


def ptxas_frames(build_dir) -> dict:
    """Each kernel entry's local-memory use as ``ptxas -v`` reported it in
    ``_build/<source>.log``: ``{entry: (stack frame, spill stores, spill
    loads)}`` in bytes."""
    import re

    frames = {}
    for log_path in sorted(build_dir.glob("*.log")):
        entry = None
        for line in log_path.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m and entry:
                frames[entry] = tuple(int(x) for x in m.groups())
    return frames


# Cycles of the spin queued ahead of each timed call (about 1 ms at the
# H100's clock): the host queues the call while the card spins, so the
# window holds the call's device time and not its launch overhead.
SPIN_CYCLES = 2_000_000


def time_ms(torch, fn, reps: int, setup=None) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` runs after two warm-up
    runs; ``setup`` runs before each, outside the timed window.  Each run is
    queued behind a spin on the card; a twin that waits on the card inside
    ``fn`` still counts its host time."""
    for _ in range(2):
        if setup is not None:
            setup()
        fn()
    total = 0.0
    for _ in range(reps):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def max_abs_err(torch, pairs) -> int:
    """Largest absolute difference over pairs of integer tensors."""
    err = 0
    for a, b in pairs:
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def random_states(torch, gen, f: int, n: int):
    """Packed 2pc rows with every field in range: RM states 0..3, the TM
    state 0..2, random prepared and message bits."""
    from stateright_tpu_torch.ops.u32 import i32

    dev = gen.device
    rm = torch.randint(0, 4, (f, n), generator=gen, device=dev, dtype=torch.int64)
    w0 = (rm << (2 * torch.arange(n, device=dev))).sum(1)
    w0 = w0 | (torch.randint(0, 3, (f,), generator=gen, device=dev) << 24)
    w1 = torch.randint(0, 1 << (2 * n + 2), (f,), generator=gen, device=dev)
    return torch.stack([i32(w0), i32(w1)], dim=1).contiguous()


def probe_bytes(torch, keys, hi, lo, active) -> int:
    """Bytes of table slots the active lanes of an insert probe: from each
    lane's home slot up to the slot that holds its key after the call, 8
    bytes a slot."""
    from stateright_tpu_torch.ops.device_fp import fp64_of
    from stateright_tpu_torch.parallel.hashset import home_slot

    cap = keys.shape[0]
    lane = torch.nonzero(active).flatten()
    key = fp64_of(hi[lane], lo[lane])
    slot = home_slot(hi[lane], lo[lane], cap)
    probes = 0
    while lane.numel():
        probes += lane.numel()
        undone = keys[slot] != key
        key, slot = key[undone], (slot[undone] + 1) & (cap - 1)
        lane = lane[undone]
    return 8 * probes


def phase_kernels(torch, rows):
    """The ``2pc check 10`` path's kernels against their twins at that
    path's shapes; adds their rows of the kernels line to ``rows``
    (launches filled in later): the host entries of K4 and K8 as the
    traced run's rows (the untraced run's device-count entries are held
    in :func:`phase_fused_kernels`)."""
    from stateright_tpu_torch.models.twophase import TwoPhaseSys
    from stateright_tpu_torch.models.twophase_compiled import (
        twophase_step, twophase_step_plain,
    )
    from stateright_tpu_torch.ops.device_fp import device_fp64, device_fp64_plain
    from stateright_tpu_torch.ops.u32 import i32
    from stateright_tpu_torch.parallel.hashset import (
        HashSet, insert_batch_claim, unique_buffer_size,
    )
    from stateright_tpu_torch.parallel.wave_common import (
        prop_kinds, wave_eval, wave_eval_plain,
    )

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    a = 2 + 5 * RM

    row = kernel_row(rows, "rm10")
    host_row = kernel_row(rows, "tr-rm10")

    # K2 at F states.
    states = random_states(torch, gen, F, RM)
    k2 = twophase_step(states, RM)
    p2 = twophase_step_plain(states, RM)
    torch.cuda.synchronize()
    row("twophase_step", max_abs_err(torch, zip(k2, p2)),
        time_ms(torch, lambda: twophase_step(states, RM), 10),
        time_ms(torch, lambda: twophase_step_plain(states, RM), 2),
        F * 8 + F * a * (8 + 1) + F * 3)
    nexts, valid, conds = k2
    del p2

    # K1 on the F*A successor rows.
    flat = nexts.view(F * a, 2)
    k1 = device_fp64(flat)
    p1 = device_fp64_plain(flat)
    torch.cuda.synchronize()
    row("device_fp64", max_abs_err(torch, zip(k1, p1)),
        time_ms(torch, lambda: device_fp64(flat), 10),
        time_ms(torch, lambda: device_fp64_plain(flat), 2),
        flat.shape[0] * (8 + 8))
    del k1, p1

    # K3 on the F*A validity lanes into the dd=1 buffer the main path uses.
    mask = valid.view(-1)
    err, ms, plain_ms, library_ms, nbytes, _out = measure_compact(
        torch, mask, unique_buffer_size(F * a, 1))
    row("compact", err, ms, plain_ms, nbytes, library_ms=library_ms)
    log(f"  compact: {int(mask.sum())} of {mask.shape[0]} lanes valid")

    # K4: a 2**27-slot table prefilled with a quarter of its slots' worth of
    # keys, then a main-path-sized batch (one lane per candidate) whose
    # active ~30% draw from a pool twice the prefill: duplicates within the
    # batch and keys already present.
    n = F * a
    pool = torch.randint(
        -(1 << 62), 1 << 62, (CAPACITY // 2,), generator=gen, device=dev
    ) * 2 + 1  # odd: never the empty key 0
    pool_hi, pool_lo = i32(pool >> 32), i32(pool)
    base = HashSet.empty(CAPACITY, dev)
    pre = CAPACITY // 4
    insert_batch_claim(
        base, pool_hi[:pre].contiguous(), pool_lo[:pre].contiguous(),
        torch.ones((pre,), dtype=torch.bool, device=dev),
    )
    pick = torch.randint(0, CAPACITY // 2, (n,), generator=gen, device=dev)
    b_hi, b_lo = pool_hi[pick].contiguous(), pool_lo[pick].contiguous()
    active = torch.rand((n,), generator=gen, device=dev) < 0.3
    check_insert(torch, host_row, base, b_hi, b_lo, active)
    del base, pool, b_hi, b_lo, active

    # K8 on K2's conds and validity with 2pc's property kinds (no
    # eventually property, so the eventually-bits stay 0), nothing
    # discovered yet.  K8 gates its valid input in place: each call gets a
    # fresh copy.
    kinds = prop_kinds(TwoPhaseSys(rm_count=RM).properties())
    eb = torch.zeros((F,), dtype=torch.int32, device=dev)
    gated = valid.clone()

    def fresh():
        gated.copy_(valid)

    k8 = wave_eval(conds, gated, eb, 0, kinds, 0)
    p8 = wave_eval_plain(conds, valid.clone(), eb, 0, kinds, 0)
    torch.cuda.synchronize()
    n_props = conds.shape[1]
    host_row("wave_eval", max_abs_err(torch, zip(k8, p8)),
             time_ms(torch, lambda: wave_eval(conds, gated, eb, 0, kinds, 0),
                     10, setup=fresh),
             time_ms(torch, lambda: wave_eval_plain(conds, valid, eb, 0, kinds,
                                                    0), 2),
             F * n_props + 2 * F * a + 2 * F * 4 + n_props * 8)
    log(f"  wave_eval: candidates {k8[2].tolist()}")


def kernel_row(rows, path):
    """A recorder of ``path``'s kernels-line rows into ``rows``, keyed by
    (kernel, path) (with ``path`` None: logged, not recorded, for an entry
    the path does not launch); raises on a kernel that disagrees with its
    twin.  A row's bound is the larger of its bytes over the memory rate
    and its INT32 operations over :func:`int32_rate`."""
    ops_per_sec = int32_rate()

    def row(name, err, ms, plain_ms, nbytes, library_ms=None, ops=0,
            rotating_ms=None):
        bytes_ms = nbytes / HBM_BYTES_PER_SEC * 1e3
        ops_ms = ops / ops_per_sec * 1e3
        r = dict(
            name=name, path=path, route="cuda", max_abs_err=err,
            bit_equal=err == 0, ms=ms, plain_ms=plain_ms,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="operations" if ops_ms > bytes_ms else "bytes",
            library_ms=library_ms,
        )
        if rotating_ms is not None:
            r["rotating_ms"] = rotating_ms
        if path is not None:
            rows[name, path] = r
        log(f"  {name} [{path or 'checked'}]: max_abs_err={err} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}: bytes={nbytes} -> {bytes_ms:.4f} ms, "
            f"int32 ops={ops} -> {ops_ms:.4f} ms) library_ms={library_ms}"
            + ("" if rotating_ms is None else
               f" rotating_ms={rotating_ms:.4f} (a new chunk each call)"))
        if err:
            raise AssertionError(f"{name} disagrees with its plain twin")

    return row


def launch_counted():
    from stateright_tpu_torch.models.abd_compiled import abd_step
    from stateright_tpu_torch.models.fixtures import trap_step
    from stateright_tpu_torch.models.lww_compiled import lww_step
    from stateright_tpu_torch.models.paxos_compiled import (
        paxos_conds, paxos_step, paxos_step_lane, paxos_step_valid,
    )
    from stateright_tpu_torch.models.ping_pong_compiled import ping_pong_step
    from stateright_tpu_torch.models.raft_compiled import raft_step
    from stateright_tpu_torch.models.single_copy_compiled import single_copy_step
    from stateright_tpu_torch.models.twophase_compiled import twophase_step
    from stateright_tpu_torch.ops.device_fp import device_fp64
    from stateright_tpu_torch.parallel.canon import canonicalize_rows
    from stateright_tpu_torch.parallel.hashset import (
        insert_batch_claim, prededup, prededup_prefix,
    )
    from stateright_tpu_torch.parallel.wave_common import compact, wave_eval
    from stateright_tpu_torch.ensemble.fate import fate_mask
    from stateright_tpu_torch.parallel.simulation_gpu import (
        walk_finish, walk_init, walk_step, walker_keys,
    )
    from stateright_tpu_torch.tiered.cold_join import cold_probe, cold_query
    from stateright_tpu_torch.models.fixtures import grid_walk
    from stateright_tpu_torch.models.twophase_compiled import twophase_conds
    from stateright_tpu_torch.incr.recheck import first_hits
    from stateright_tpu_torch.models.fixtures import (
        cap_counter, cap_counter_gang, grid_walk_gang,
    )
    from stateright_tpu_torch.fleet.gang import gang_eval
    from stateright_tpu_torch.parallel.append import append_block
    from stateright_tpu_torch.parallel.exchange import (
        owner_bucket, shard_commit, shard_log_append,
    )
    from stateright_tpu_torch.parallel.fused import wave_ctl, wave_load
    from stateright_tpu_torch.ops.device_fp import device_fp64_n
    from stateright_tpu_torch.parallel.append import append_block_dev
    from stateright_tpu_torch.parallel.hashset import insert_batch_claim_dev
    from stateright_tpu_torch.parallel.wave_common import wave_eval_dev

    return (wave_load, wave_ctl, wave_eval_dev, insert_batch_claim_dev,
            device_fp64_n, append_block_dev, shard_log_append, owner_bucket, shard_commit, append_block, device_fp64, twophase_step, compact, insert_batch_claim,
            paxos_step_valid, paxos_conds, paxos_step_lane, wave_eval,
            single_copy_step, abd_step, raft_step, prededup, prededup_prefix,
            ping_pong_step,
            paxos_step, canonicalize_rows, lww_step, trap_step,
            walker_keys, walk_init, walk_step, walk_finish, fate_mask,
            cold_query, cold_probe, grid_walk, twophase_conds, first_hits,
            grid_walk_gang, cap_counter, cap_counter_gang, gang_eval)


def reset_launches():
    for fn in launch_counted():
        fn.launches = 0


def read_launches(path):
    """The launch counts since the last reset; raises if a kernel of
    ``path`` was launched no time."""
    counts = {fn.__name__: fn.launches for fn in launch_counted()}
    wanted = PATH_KERNELS[path] + ALSO_LAUNCHED.get(path, ())
    missing = [k for k in wanted if counts[k] == 0]
    if missing:
        raise AssertionError(
            f"kernels never launched on the {path} path: {missing}"
        )
    return counts


def snapshot_logs(checker, tmpdir, tag, width):
    import numpy as np

    path = os.path.join(tmpdir, f"{tag}.npz")
    checker.save_snapshot(path)
    with np.load(path) as snap:
        tail = int(snap["tail"])
        return {
            "rows": snap["rows"][: width * tail].copy(),
            "parent": snap["parent"][:tail].copy(),
            "ebits": snap["ebits"][:tail].copy(),
        }


def assert_same_as_cpu(gpu, cpu, what, width):
    """The card's run against the port's CPU run: logs, fingerprints and
    discoveries bit-equal."""
    with tempfile.TemporaryDirectory() as tmp:
        g = snapshot_logs(gpu, tmp, "gpu", width)
        c = snapshot_logs(cpu, tmp, "cpu", width)
    for k in g:
        if g[k].shape != c[k].shape or not (g[k] == c[k]).all():
            raise AssertionError(f"{what} {k} differs between card and CPU runs")
    if sorted(gpu.discoveries()) != sorted(cpu.discoveries()):
        raise AssertionError(f"{what} discoveries differ between card and CPU")
    if not (gpu.discovered_fingerprints() == cpu.discovered_fingerprints()).all():
        raise AssertionError(f"{what} fingerprints differ between card and CPU")


def card_and_cpu(what, builder, golden, width, **kw):
    """Run ``builder()`` (a fresh checker builder) on the card and on the
    CPU at ``kw``: the card's (unique, states, depth) must be ``golden``
    and its logs, fingerprints and discoveries the CPU run's.  Returns the
    card's checker."""
    gpu = builder().spawn_gpu(**kw).join()
    cpu = builder().spawn_gpu(device="cpu", **kw).join()
    got = (gpu.unique_state_count(), gpu.state_count(), gpu.max_depth())
    log(f"  {what} on the card: unique={got[0]} states={got[1]} "
        f"depth={got[2]} waves={gpu.waves()}")
    if got != golden:
        raise AssertionError(f"{what} counts {got} != {golden}")
    assert_same_as_cpu(gpu, cpu, what, width)
    log(f"  {what}: row log, parents and ebits bit-equal to the CPU run")
    return gpu


def phase_rm5(torch):
    from stateright_tpu_torch.models.twophase import TwoPhaseSys

    reset_launches()
    gpu = card_and_cpu("rm=5", TwoPhaseSys(rm_count=5).checker, GOLDEN_RM5, 2,
                       capacity=1 << 14, max_frontier=1 << 9)
    log(f"  rm=5 launches: {read_launches('rm10')}")
    gpu.assert_properties()


def run_rm10(torch):
    """``2pc check 10`` through ``spawn_gpu()`` at the slice's geometry,
    held to its goldens; returns the joined checker and its wall seconds.
    ``gpu_profile.py`` times and traces this same run."""
    from stateright_tpu_torch.models.twophase import TwoPhaseSys

    torch.cuda.synchronize()
    t0 = time.monotonic()
    checker = TwoPhaseSys(rm_count=RM).checker().spawn_gpu(
        capacity=CAPACITY, log_capacity=LOG_CAPACITY, max_frontier=F,
        dedup_factor=1,
    ).join()
    elapsed = time.monotonic() - t0
    got = (checker.unique_state_count(), checker.max_depth())
    if got != GOLDEN_RM10:
        raise AssertionError(f"rm=10 {got} != {GOLDEN_RM10}")
    return checker, elapsed


def paxos_model(c, never_decided=False):
    from stateright_tpu_torch.actor import Network
    from stateright_tpu_torch.models.paxos import PaxosModelCfg

    return PaxosModelCfg(
        c, 3, Network.new_unordered_nonduplicating(), never_decided=never_decided
    ).into_model()


def phase_paxos2(torch):
    from stateright_tpu_torch.models.paxos_compiled import state_width

    card_and_cpu("paxos check 2", paxos_model(2).checker, GOLDEN_PAXOS2,
                 state_width(2), capacity=1 << 16,
                 max_frontier=1 << 12).assert_properties()


def run_paxos3(torch):
    """``paxos check 3`` through ``spawn_gpu()`` at ``PAXOS3_GEOMETRY``,
    held to its golden; returns the joined checker and its wall seconds.
    ``gpu_profile.py --model paxos3`` times and traces this same run."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    checker = paxos_model(3).checker().spawn_gpu(**PAXOS3_GEOMETRY).join()
    elapsed = time.monotonic() - t0
    got = (checker.unique_state_count(), checker.max_depth())
    if got != GOLDEN_PAXOS3:
        raise AssertionError(f"paxos check 3 {got} != {GOLDEN_PAXOS3}")
    return checker, elapsed


def replay_wave(torch, checker, geometry, with_level_end=False):
    """One real wave of a card run at ``geometry``: the first chunk of its
    widest expanded level.  Returns its rows, start position,
    eventually-bits, discovered mask, the run's table as it stood when the
    wave ran (every state of the levels before, rebuilt from the log, the
    canonical rows' fingerprints under symmetry), and the positions the
    run appended from that wave; with ``with_level_end`` also the level's
    end (the tail when the wave ran)."""
    from stateright_tpu_torch.ops.device_fp import device_fp64
    from stateright_tpu_torch.parallel.hashset import HashSet, insert_batch_claim
    from stateright_tpu_torch.parallel.wave_common import NO_ID

    carry = checker._carry
    w = checker._compiled.state_width
    f = geometry["max_frontier"]
    parent = carry.parent[: carry.tail].long()
    # BFS depth of every position: the log is in level order.
    depth = torch.zeros_like(parent)
    has_parent = parent >= 0
    for _ in range(checker.max_depth() + 1):
        depth = torch.where(has_parent, depth[parent.clamp(min=0)] + 1, 0)
    sizes = torch.bincount(depth)
    # The widest level the run expanded (one cut by target_max_depth
    # leaves its last level unexpanded).
    widest = int(sizes[: carry.depth].argmax())
    start = int(sizes[:widest].sum())
    level_end = start + int(sizes[widest])
    n = min(f, level_end - start)
    states = carry.rows[start * w : (start + n) * w].view(n, w)
    # When the level's first chunk ran, the table held exactly the states
    # of the levels before it and of this one: positions [0, level_end).
    table = HashSet.empty(geometry["capacity"], states.device)
    logged = carry.rows[: level_end * w].view(level_end, w)
    hi, lo = device_fp64(checker._identity(logged))
    insert_batch_claim(table, hi, lo,
                       torch.ones((level_end,), dtype=torch.bool,
                                  device=states.device))
    discovered = sum(
        1 << p for p, d in enumerate(carry.disc) if d != NO_ID and d < start
    )
    from_wave = (parent >= start) & (parent < start + n)
    appended = torch.nonzero(from_wave).flatten()
    log(f"  replayed wave: level {widest} of {int(sizes[widest])} states, "
        f"log positions {start}..{start + n}, table of {level_end} states, "
        f"discovered mask {discovered}, {appended.numel()} states appended")
    out = (states, start, carry.ebits[start : start + n], discovered, table,
           appended)
    return out + (level_end,) if with_level_end else out


def phase_paxos_kernels(torch, checker, rows, path, geometry, host_path=None):
    """A paxos path's kernels against their twins on one real wave of its
    run (:func:`replay_wave`), each called as the engine calls it -- the
    untraced run's device-count entries of K8, K1 and K4 (rows of
    ``path``) and the per-wave loop's host entries (rows of ``host_path``,
    the traced run's; checked only without one); the replayed wave must
    append what the run appended."""
    from stateright_tpu_torch.models.paxos_compiled import (
        _codec, paxos_conds, paxos_conds_plain, paxos_step_lane,
        paxos_step_lane_plain, paxos_step_valid, paxos_step_valid_plain,
    )
    from stateright_tpu_torch.models.register_compiled_common import dp_work
    from stateright_tpu_torch.ops.device_fp import device_fp64, device_fp64_plain
    from stateright_tpu_torch.ops.u32 import u32
    from stateright_tpu_torch.parallel.hashset import (
        compact_valid_indices, unique_buffer_size,
    )
    from stateright_tpu_torch.parallel.wave_common import (
        prop_kinds, wave_eval, wave_eval_plain,
    )

    row = kernel_row(rows, path)
    host_row = kernel_row(rows, host_path)
    cm = checker._compiled
    c, w, m = cm.c, cm.state_width, cm.m
    carry = checker._carry
    states, start, eb, discovered, table, appended = replay_wave(
        torch, checker, geometry)
    f = states.shape[0]

    k5 = paxos_step_valid(states, c)
    p5 = paxos_step_valid_plain(states, c)
    torch.cuda.synchronize()
    row("paxos_step_valid", max_abs_err(torch, [(k5, p5)]),
        time_ms(torch, lambda: paxos_step_valid(states, c), 10),
        time_ms(torch, lambda: paxos_step_valid_plain(states, c), 2),
        f * w * 4 + f * m)
    log(f"  paxos_step_valid: {int(k5.sum())} of {f * m} lanes valid")

    k6 = paxos_conds(states, c, cm.never_decided)
    p6 = paxos_conds_plain(states, c, cm.never_decided)
    torch.cuda.synchronize()
    n_props = k6.shape[1]
    # The DP's word updates these states need (rounds to the fixpoint x
    # operations present x NV x NW), one INT32 operation each.
    dp_ops = int(dp_work(_codec(c), u32(states)).sum())
    row("paxos_conds", max_abs_err(torch, [(k6, p6)]),
        time_ms(torch, lambda: paxos_conds(states, c, cm.never_decided), 10),
        time_ms(torch, lambda: paxos_conds_plain(states, c, cm.never_decided), 2),
        f * w * 4 + f * n_props, ops=dp_ops)

    # K8 gates its valid input in place: each call gets a fresh copy.
    kinds = prop_kinds(checker._properties)
    valid = k5.clone()

    def fresh():
        valid.copy_(k5)

    k8 = wave_eval(k6, valid, eb, start, kinds, discovered)
    p8 = wave_eval_plain(k6, k5.clone(), eb, start, kinds, discovered)
    torch.cuda.synchronize()
    host_row("wave_eval", max_abs_err(torch, zip(k8, p8)),
             time_ms(torch, lambda: wave_eval(k6, valid, eb, start, kinds,
                                              discovered), 10, setup=fresh),
             time_ms(torch, lambda: wave_eval_plain(k6, k5, eb, start, kinds,
                                                    discovered), 2),
             f * n_props + 2 * f * m + 2 * f * 4 + n_props * 8)
    log(f"  wave_eval: candidates {k8[2].tolist()}")
    stats = replay_stats(torch, n_props, start, discovered, states.device)
    active = torch.ones((f,), dtype=torch.bool, device=states.device)
    k8d = check_wave_eval_dev(torch, row, k6, k5, eb, stats, active, kinds)
    if not all(torch.equal(x, y) for x, y in zip(k8, k8d)):
        raise AssertionError("K8's device entry disagrees with its host entry")

    # K3 runs twice a wave: on the F * M lane validity (through
    # compact_valid_indices), then on the U-lane "new" mask after K4.  Its
    # row is the mean of the two calls, as its launches count both.
    size = unique_buffer_size(geometry["max_frontier"] * m,
                              geometry["dedup_factor"])
    gated = k8[0].view(-1)
    v_orig, v_act, n_valid = compact_valid_indices(gated, sort_lanes=size)
    size = v_orig.shape[0]  # the buffer of this wave (a short chunk's is narrower)
    n = int(n_valid)
    if n > size:
        raise AssertionError(f"{n} valid lanes overflow the {size}-lane buffer")
    k3_valid = measure_compact(torch, gated, size)
    if k3_valid[0] or not (k3_valid[5] == v_orig).all():
        raise AssertionError("compact_valid_indices disagrees with its twin")

    k_rows, k_flags = paxos_step_lane(states, v_orig, n_valid, c)
    p_rows, p_flags = paxos_step_lane_plain(states, v_orig, n_valid, c)
    torch.cuda.synchronize()
    parents = int(torch.unique(v_orig[:n].long() // m).numel())
    row("paxos_step_lane",
        max_abs_err(torch, [(k_rows[:n], p_rows[:n]), (k_flags, p_flags)]),
        time_ms(torch, lambda: paxos_step_lane(states, v_orig, n_valid, c), 10),
        time_ms(torch, lambda: paxos_step_lane_plain(states, v_orig, n_valid, c), 2),
        n * 4 + parents * w * 4 + 8 + n * w * 4 + size)
    log(f"  paxos_step_lane: {n} lanes of a {size}-lane buffer, "
        f"{parents} parent rows, {int(k_flags.sum())} flagged")
    del p_rows, p_flags

    # K1 on the whole U-row successor buffer, as the per-wave loop hashes
    # it, and on its n_valid rows, as the fused wave does.
    k1 = device_fp64(k_rows)
    p1 = device_fp64_plain(k_rows)
    torch.cuda.synchronize()
    host_row("device_fp64", max_abs_err(torch, zip(k1, p1)),
             time_ms(torch, lambda: device_fp64(k_rows), 10),
             time_ms(torch, lambda: device_fp64_plain(k_rows), 2),
             size * (w * 4 + 8))
    hi, lo = k1
    k1n = check_fp_n(torch, row, k_rows, n_valid)
    if not (torch.equal(k1n[0][:n], hi[:n]) and torch.equal(k1n[1][:n], lo[:n])):
        raise AssertionError("K1's counted entry disagrees with its whole-buffer entry")

    # K4 into the table as it stood when the wave ran: the device-epoch
    # entry (which leaves the table as it was), then the host entry.
    k_new_d, _ok = check_insert_dev(torch, row, table, hi, lo, v_act)
    k_new = check_insert(torch, host_row, table, hi, lo, v_act)
    if not torch.equal(k_new, k_new_d):
        raise AssertionError("K4's device-epoch entry disagrees with its host entry")
    n_new = int(k_new.sum())

    k3_new = measure_compact(torch, k_new, size)
    sel = k3_new[5]
    (e1, t1, q1, l1, b1, _), (e2, t2, q2, l2, b2, _) = k3_valid, k3_new
    log(f"  compact on the validity: {t1:.4f} ms (bound "
        f"{b1 / HBM_BYTES_PER_SEC * 1e3:.4f}); on the new mask: {t2:.4f} ms "
        f"(bound {b2 / HBM_BYTES_PER_SEC * 1e3:.4f})")
    row("compact", e1 + e2, (t1 + t2) / 2, (q1 + q2) / 2, (b1 + b2) / 2,
        library_ms=(l1 + l2) / 2)

    lanes = sel[:n_new].long()
    check_appends(torch, carry, appended, k_rows[lanes], v_orig[lanes].long(),
                  m, start, k8[1])


def check_appends(torch, carry, appended, rows_new, idxs, m, start, eb):
    """The replayed wave appends exactly what the run appended at the log
    positions ``appended``: the new rows, in order, with parents ``start +
    idxs // m`` and the parents' eventually-bits ``eb``."""
    w = rows_new.shape[1]
    at = torch.arange(appended.numel(), device=appended.device)
    if rows_new.shape[0] != appended.numel() or not (
        (appended == appended[0] + at).all()
        and (rows_new == carry.rows.view(-1, w)[appended]).all()
        and (carry.parent[appended].long() == start + idxs // m).all()
        and (carry.ebits[appended] == eb[idxs // m]).all()
    ):
        raise AssertionError("the replayed wave does not append what the run did")
    log(f"  the replayed wave appends the run's {appended.numel()} rows, "
        f"parents and ebits")


def check_insert(torch, row, table, hi, lo, active):
    """K4 into ``table`` against its twin on a copy, timed from the same
    table contents each call; records its row and returns the kernel's
    new-key mask."""
    from stateright_tpu_torch.parallel.hashset import (
        HashSet, insert_batch_claim, insert_batch_claim_plain, keys_equal,
    )

    saved = table.keys.clone()
    k_new, k_ok = insert_batch_claim(table, hi, lo, active)
    p_keys = saved.clone()
    p_new, p_ok = insert_batch_claim_plain(p_keys, hi, lo, active)
    torch.cuda.synchronize()
    same_set = keys_equal(table, HashSet(p_keys))
    err = max_abs_err(torch, [(k_new, p_new), (k_ok, p_ok)]) + (0 if same_set else 1)
    del p_keys
    # Every lane's active byte read and new byte written; the key words of
    # the active lanes only (the kernel skips the rest); each probed slot
    # once; each new key written once.
    n_active, n_new = int(active.sum()), int(k_new.sum())
    nbytes = (
        active.shape[0] * (1 + 1) + n_active * (4 + 4)
        + probe_bytes(torch, table.keys, hi, lo, active) + 8 * n_new
    )
    log(f"  insert_batch_claim: {n_active} active lanes, {n_new} new, "
        f"load after {table.load_factor():.4f}")

    def restore():
        table.keys.copy_(saved)

    row("insert_batch_claim", err,
        time_ms(torch, lambda: insert_batch_claim(table, hi, lo, active), 10,
                setup=restore),
        time_ms(torch, lambda: insert_batch_claim_plain(table.keys, hi, lo, active),
                2, setup=restore),
        nbytes)
    # The traced wave's probe figures on the same batch: K4's longest chain
    # and slots read, beside the twin's lockstep rounds and slots.
    restore()
    _new, _ok, p_probe = insert_batch_claim_plain(table.keys, hi, lo, active,
                                                  with_rounds=True)
    restore()
    _new, _ok, k_probe = insert_batch_claim(table, hi, lo, active, with_rounds=True)
    (chain, k_slots), (rounds, p_slots) = k_probe.tolist(), p_probe.tolist()
    log(f"  insert_batch_claim probe figures: K4 longest chain {chain} slots, "
        f"{k_slots} slots read; twin {rounds} lockstep rounds, {p_slots} "
        "slots read")
    if n_active and not (1 <= chain and n_active <= k_slots):
        raise AssertionError("K4's probe figures do not count its probes")
    return k_new


def replay_stats(torch, p, start, discovered, dev):
    """A stats vector (``parallel/fused.py``) for a replayed wave that K8's
    device entry reads: ``level_start`` at ``start``, ``disc[q]`` set for
    each bit of ``discovered``."""
    from stateright_tpu_torch.parallel import fused
    from stateright_tpu_torch.parallel.wave_common import NO_ID

    disc = [0 if discovered >> q & 1 else NO_ID for q in range(p)]
    words = [start] + [0] * (fused.STAT_DISC - 1) + disc
    words += [0] * fused.CTL_WORDS
    return torch.tensor([((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
                         for x in words], dtype=torch.int32, device=dev)


def check_wave_eval_dev(torch, row, conds, valid, eb, stats, active, kinds):
    """K8's device-count entry against its twin on a wave's conds,
    validity, eventually-bits, stats and active mask, timed on a fresh
    copy of the validity each call (it gates it in place); records its
    row and returns the kernel's outputs."""
    from stateright_tpu_torch.parallel.wave_common import (
        wave_eval_dev, wave_eval_dev_plain,
    )

    f, p = conds.shape
    a = valid.shape[1]
    gated = valid.clone()

    def fresh():
        gated.copy_(valid)

    k8 = wave_eval_dev(conds, gated, eb, stats, active, kinds)
    p8 = wave_eval_dev_plain(conds, valid.clone(), eb, stats, active, kinds)
    torch.cuda.synchronize()
    out = tuple(t.clone() for t in k8)
    row("wave_eval_dev", max_abs_err(torch, zip(k8, p8)),
        time_ms(torch, lambda: wave_eval_dev(conds, gated, eb, stats, active,
                                             kinds), 10, setup=fresh),
        time_ms(torch, lambda: wave_eval_dev_plain(conds, valid, eb, stats,
                                                   active, kinds), 2),
        f * p + 2 * f * a + 2 * f * 4 + p * 8 + f + (8 + p) * 4)
    return out


def check_insert_dev(torch, row, table, hi, lo, active):
    """K4's device-epoch entry into ``table`` against its twin on a copy,
    timed from the same table contents each call (the epoch word advancing
    on the card); records its row, leaves the table as it found it, and
    returns the kernel's new-key mask and ``probe_ok``."""
    from stateright_tpu_torch.parallel.hashset import (
        HashSet, insert_batch_claim_dev, insert_batch_claim_plain, keys_equal,
    )

    epoch = torch.tensor([7], dtype=torch.int32, device=hi.device)
    saved = table.keys.clone()
    k_new, k_ok = insert_batch_claim_dev(table, hi, lo, active, epoch)
    p_keys = saved.clone()
    p_new, p_ok = insert_batch_claim_plain(p_keys, hi, lo, active)
    torch.cuda.synchronize()
    err = max_abs_err(torch, [(k_new, p_new), (k_ok, p_ok)])
    err += 0 if keys_equal(table, HashSet(p_keys)) else 1
    err += 0 if int(epoch) == 8 else 1
    del p_keys
    # As K4's host entry (check_insert), and the epoch word read and
    # written.
    n_active, n_new = int(active.sum()), int(k_new.sum())
    nbytes = (active.shape[0] * 2 + n_active * 8
              + probe_bytes(torch, table.keys, hi, lo, active) + 8 * n_new + 8)

    def restore():
        table.keys.copy_(saved)

    row("insert_batch_claim_dev", err,
        time_ms(torch, lambda: insert_batch_claim_dev(table, hi, lo, active,
                                                      epoch), 10, setup=restore),
        time_ms(torch, lambda: insert_batch_claim_plain(table.keys, hi, lo, active),
                2, setup=restore),
        nbytes)
    restore()
    log(f"  insert_batch_claim_dev: {n_active} active lanes, {n_new} new")
    return k_new, k_ok


def check_fp_n(torch, row, ident, n_valid):
    """K1's counted entry against its twin on the first ``n_valid`` rows
    of ``ident``; records its row and returns its ``(hi, lo)``."""
    from stateright_tpu_torch.ops.device_fp import device_fp64_n, device_fp64_n_plain

    nv, fpw = int(n_valid), ident.shape[1]
    k1 = device_fp64_n(ident, n_valid)
    p1 = device_fp64_n_plain(ident, n_valid)
    torch.cuda.synchronize()
    row("device_fp64_n", max_abs_err(torch, [(k1[0][:nv], p1[0][:nv]),
                                             (k1[1][:nv], p1[1][:nv])]),
        time_ms(torch, lambda: device_fp64_n(ident, n_valid), 10),
        time_ms(torch, lambda: device_fp64_n_plain(ident, n_valid), 2),
        nv * (4 * fpw + 8) + 8)
    log(f"  device_fp64_n: {nv} of the {ident.shape[0]}-row buffer")
    return k1


class AppendCapture:
    """While entered, keeps the inputs of the wave commit (K25) with the
    most new states among those ``want`` accepts (the last such), and where
    the run put them: K3's compaction of the new mask, the sorted path's
    origin, the buffer's candidate lanes, the candidate rows, the wave's
    eventually-bits, its first log position, the tail and the count."""

    def __init__(self, want=lambda wave: True):
        self.want = want
        self.wave = None

    def __enter__(self):
        from stateright_tpu_torch.parallel.wavefront import GpuChecker

        orig = self._orig = GpuChecker._wave_commit
        cap = self

        def capturing(eng, wave):
            if wave.n_new and cap.want(wave) and (
                cap.wave is None or wave.n_new >= cap.wave["n_new"]
            ):
                cap.wave = dict(
                    sel=wave.sel.clone(),
                    origin=None if wave.u_origin is None else wave.u_origin.clone(),
                    v_orig=wave.v_orig.clone(), cand_rows=wave.cand_rows.clone(),
                    eb=wave.eb.clone(), lo_pos=wave.lo_pos, tail=eng._carry.tail,
                    n_new=wave.n_new, a=eng._compiled.max_actions,
                    two_phase=eng._two_phase,
                )
            return orig(eng, wave)

        GpuChecker._wave_commit = capturing
        return self

    def __exit__(self, *exc):
        from stateright_tpu_torch.parallel.wavefront import GpuChecker

        GpuChecker._wave_commit = self._orig


def phase_append_kernel(torch, rows, path, checker, cap, dev_path=None):
    """K25 against its twin on the captured commit (:class:`AppendCapture`,
    or a replayed wave's, :func:`phase_single_phase_kernels`),
    both writing a scratch block, bit-equal to each other and to what the
    run appended at that tail; timed beside the twin and beside the torch
    glue it replaced (the lane gathers, ``index_select`` into the block,
    the parents' cast and the ebits' ``index_select``).  Bound: each new
    state's index words read once (2, or 3 through the sorted path's
    origin), its row read and written once, its parent and ebits written
    and its parent's eventually-bits read once.  The row is ``path``'s
    (checked only with ``path`` None); with ``dev_path``, K25's
    device-count entry is held and timed the same way, as its row."""
    from stateright_tpu_torch.parallel.append import (
        append_block, append_block_dev, append_block_dev_plain,
        append_block_plain,
    )

    wv = cap.wave
    if wv is None:
        raise AssertionError(f"{path}: no commit was captured")
    n, a, two_phase = wv["n_new"], wv["a"], wv["two_phase"]
    sel, origin, v_orig = wv["sel"], wv["origin"], wv["v_orig"]
    cand_rows, eb, lo_pos = wv["cand_rows"], wv["eb"], wv["lo_pos"]
    w = cand_rows.shape[1]
    dev = cand_rows.device

    def block():
        return (torch.zeros((n * w,), dtype=torch.int32, device=dev),
                torch.zeros((n,), dtype=torch.int32, device=dev),
                torch.zeros((n,), dtype=torch.int32, device=dev))

    args = (sel, origin, v_orig, cand_rows, eb, lo_pos, 0, n, a, two_phase)
    k, p, g = block(), block(), block()
    append_block(*k, *args)
    append_block_plain(*p, *args)

    def glue():
        lanes = sel[:n].long()
        if origin is not None:
            lanes = origin[lanes].long()
        idx = v_orig[lanes].long()
        src = idx // a
        torch.index_select(cand_rows, 0, lanes if two_phase else idx,
                           out=g[0].view(n, w))
        g[1].copy_(src + lo_pos)
        torch.index_select(eb, 0, src, out=g[2])

    glue()
    torch.cuda.synchronize()
    c, t = checker._carry, wv["tail"]
    ran = (c.rows[t * w : (t + n) * w], c.parent[t : t + n], c.ebits[t : t + n])
    if not all(torch.equal(x, y) for x, y in zip(k, ran)):
        raise AssertionError(f"{path}: K25 does not write what the run appended")
    err = max_abs_err(torch, list(zip(k, p)) + list(zip(k, g)))
    log(f"  append_block [{path}]: the widest commit, {n} new states of "
        f"{w} words at tail {t} ({'two-phase' if two_phase else 'single-phase'}"
        f"{', sorted path' if origin is not None else ''}), bit-equal to the "
        "twin, the glue and the run's log")
    row = kernel_row(rows, path)
    nbytes = n * (4 * (2 if origin is None else 3) + 8 * w + 12)
    row("append_block", err,
        time_ms(torch, lambda: append_block(*k, *args), 10),
        time_ms(torch, lambda: append_block_plain(*p, *args), 10),
        nbytes, library_ms=time_ms(torch, glue, 10))
    if dev_path is None:
        return
    # The device-count entry: (lo_pos, tail, n_new) from a record on the
    # card, as K29 writes it, into a scratch block at tail 0.
    rec = torch.tensor([lo_pos, 0, n], dtype=torch.int32, device=dev)
    dargs = (sel, origin, v_orig, cand_rows, eb, rec, a, two_phase)
    kd, pd = block(), block()
    append_block_dev(*kd, *dargs)
    append_block_dev_plain(*pd, *dargs)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(kd, ran)):
        raise AssertionError(f"{dev_path}: K25's device entry does not write "
                             "what the run appended")
    kernel_row(rows, dev_path)(
        "append_block_dev", max_abs_err(torch, zip(kd, pd)),
        time_ms(torch, lambda: append_block_dev(*kd, *dargs), 10),
        time_ms(torch, lambda: append_block_dev_plain(*pd, *dargs), 10),
        nbytes + 12, library_ms=time_ms(torch, glue, 10))


def device_fps(torch, checker):
    """The run's identity fingerprints as a sorted int64 tensor on the card
    (the set behind ``discovered_fingerprints()``, without the host copy)."""
    from stateright_tpu_torch.ops.device_fp import device_fp64, fp64_of

    c = checker._carry
    w = checker._compiled.state_width
    hi, lo = device_fp64(checker._identity(c.rows[: c.tail * w].view(c.tail, w)))
    return torch.sort(fp64_of(hi, lo)).values


def traced_checks(what, checker, journal):
    """A traced run's summary, printed; fails on the estimated peak, on any
    wave or phase above 1.05 of the peak and on a wave whose breakdown
    covers under 0.9 of its call time.  Also prints the share of the
    traced waves' wall span (their journal ``mono`` stamps) the phases
    cover: the rest is the loop's host work between waves."""
    from stateright_tpu_torch.runtime.journal import read_journal

    s = checker.trace_summary()
    log(f"  {what} trace_summary: {json.dumps(s)}")
    if s["hbm_peak_estimated"]:
        raise AssertionError(f"{what}: the peak is the estimated fallback "
                             f"({s['device_kind']!r})")
    peak = s["hbm_peak_bytes_per_sec"]
    waves = [e for e in read_journal(journal)
             if e["event"] == "wave" and "wave_breakdown" in e]
    if len(waves) != s["traced_waves"] or not waves:
        raise AssertionError(f"{what}: {len(waves)} traced wave events for "
                             f"{s['traced_waves']} traced waves")
    worst = (0.0, None)
    for w in waves:
        bd = w["wave_breakdown"]
        if sum(bd.values()) < 0.9 * w["call_sec"]:
            raise AssertionError(f"{what}: wave {w['waves']}'s breakdown covers "
                                 f"{sum(bd.values())} of {w['call_sec']} s")
        utils = {"wave": w["hbm_util_frac"]}
        utils.update({ph: b / (bd[ph] * peak) for ph, b in w["bytes"].items()
                      if bd.get(ph)})
        for ph, u in utils.items():
            if u > worst[0]:
                worst = (u, f"wave {w['waves']} {ph}")
    total = {ph: s["bytes"][ph] / (s["wave_breakdown"][ph] * peak)
             for ph in s["bytes"] if s["wave_breakdown"].get(ph)}
    span = waves[-1]["mono"] - waves[0]["mono"] + waves[-1]["call_sec"]
    cover = sum(w["call_sec"] for w in waves) / span
    log(f"  {what}: {len(waves)} traced waves; run hbm_util_frac by phase "
        f"{ {k: round(v, 4) for k, v in total.items()} }; the highest of any "
        f"wave or phase {worst[0]:.4f} ({worst[1]}); phases cover {cover:.4f} "
        f"of the traced waves' wall span")
    if worst[0] > 1.05 or max(total.values(), default=0) > 1.05:
        raise AssertionError(f"{what}: hbm_util_frac {worst[0]} above 1.05")
    return s


def same_logs(torch, what, got, want):
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{what}: row log, parents or ebits differ from "
                             "the untraced run's")


def phase_traced_rm10(torch, gpu, rows, want_counts, want_logs, want_fps):
    """Traced ``2pc check 10`` at phase 4's geometry: phase 4's counts, logs
    and fingerprints, the summary's checks, K25 on its widest commit."""
    from stateright_tpu_torch.models.twophase import TwoPhaseSys

    with tempfile.TemporaryDirectory() as tmp, AppendCapture() as cap:
        journal = os.path.join(tmp, "rm10.jsonl")

        def run(torch):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            checker = TwoPhaseSys(rm_count=RM).checker().spawn_gpu(
                capacity=CAPACITY, log_capacity=LOG_CAPACITY, max_frontier=F,
                dedup_factor=1, trace=True, journal=journal,
            ).join()
            return checker, time.monotonic() - t0

        launches, checker = run_full(torch, gpu, "tr-rm10", run)
        traced_checks("traced 2pc check 10", checker, journal)
    got = (checker.unique_state_count(), checker.state_count(), checker.max_depth())
    if got != want_counts:
        raise AssertionError(f"traced rm=10 counts {got} != untraced {want_counts}")
    same_logs(torch, "traced rm=10", card_logs(checker), want_logs)
    if not torch.equal(device_fps(torch, checker), want_fps):
        raise AssertionError("traced rm=10 fingerprints differ from the untraced run's")
    log("  traced 2pc check 10: counts, row log, parents, ebits and "
        "fingerprints equal to phase 4's untraced run")
    phase_append_kernel(torch, rows, "tr-rm10", checker, cap)
    return launches


def phase_traced_paxos3(torch, gpu, rows, want_counts, want_logs, want_fps):
    """Traced ``paxos check 3`` at phase 6's geometry, held to phase 6's run;
    K25 on its widest commit (two-phase)."""
    with tempfile.TemporaryDirectory() as tmp, AppendCapture() as cap:
        journal = os.path.join(tmp, "paxos3.jsonl")

        def run(torch):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            checker = paxos_model(3).checker().spawn_gpu(
                trace=True, journal=journal, **PAXOS3_GEOMETRY).join()
            return checker, time.monotonic() - t0

        launches, checker = run_full(torch, gpu, "tr-paxos3", run)
        traced_checks("traced paxos check 3", checker, journal)
    got = (checker.unique_state_count(), checker.state_count(), checker.max_depth())
    if got != want_counts:
        raise AssertionError(f"traced paxos3 counts {got} != untraced {want_counts}")
    same_logs(torch, "traced paxos3", card_logs(checker), want_logs)
    if not (checker.discovered_fingerprints() == want_fps).all():
        raise AssertionError("traced paxos3 fingerprints differ from the untraced run's")
    log("  traced paxos check 3: counts, row log, parents, ebits and "
        "fingerprints equal to phase 6's untraced run")
    phase_append_kernel(torch, rows, "tr-paxos3", checker, cap)
    return launches


def phase_traced_tiered_paxos3(torch, gpu, want_counts, want_fps):
    """Traced tiered ``paxos check 3`` under phase 34's budget: phase 6's
    counts and fingerprints, ``cold_probe`` in every traced wave."""
    from stateright_tpu_torch.runtime.journal import read_journal

    with tempfile.TemporaryDirectory() as tmp:
        journal = os.path.join(tmp, "tiered.jsonl")
        _launches, checker = run_full(
            torch, gpu, "tiered-paxos3",
            lambda t: run_tiered_paxos3(t, journal=journal, trace=True))
        s = traced_checks("traced tiered paxos check 3", checker, journal)
        waves = [e for e in read_journal(journal)
                 if e["event"] == "wave" and "wave_breakdown" in e]
        spills = sum(1 for e in read_journal(journal) if e["event"] == "spill")
    if not all("cold_probe" in w["wave_breakdown"] for w in waves) or not spills:
        raise AssertionError("traced tiered paxos3: a traced wave has no "
                             "cold_probe phase, or nothing spilled")
    got = (checker.unique_state_count(), checker.state_count(), checker.max_depth())
    if got != want_counts or not (checker.discovered_fingerprints() == want_fps).all():
        raise AssertionError("traced tiered paxos3 differs from the in-HBM run")
    log(f"  traced tiered paxos check 3: {spills} spills, cold_probe "
        f"{s['wave_breakdown']['cold_probe']} s over {len(waves)} waves; counts "
        "and fingerprints equal to phase 6's")


def phase_visitor_rm5(torch):
    """A visitor on ``2pc check 5``: each of its 8,832 states visited once
    (the traced readback of every expanded chunk)."""
    from stateright_tpu_torch.core.visitor import StateRecorder
    from stateright_tpu_torch.models.twophase import TwoPhaseSys

    model = TwoPhaseSys(rm_count=5)
    rec, states = StateRecorder.new_with_accessor()
    t0 = time.monotonic()
    checker = model.checker().visitor(rec).spawn_gpu(
        capacity=1 << 14, max_frontier=1 << 9).join()
    elapsed = time.monotonic() - t0
    fps = {model.fingerprint(s) for s in states()}
    if len(states()) != len(fps) or len(fps) != GOLDEN_RM5[0] or not (
        checker.metrics()["trace"]
    ):
        raise AssertionError(f"visitor: {len(states())} visits of {len(fps)} "
                             f"states, not {GOLDEN_RM5[0]} once each")
    log(f"  visitor on 2pc check 5: {len(fps)} states visited once each in "
        f"{elapsed:.3f} s (traced: {checker.trace_summary()['traced_waves']} waves)")


def measure_compact(torch, mask, size):
    """K3 on ``mask`` into ``size`` lanes against its twin: returns
    ``(max_abs_err, ms, plain_ms, library_ms, bytes, out)``; the bytes are
    the mask read once, the lanes and the count written once."""
    from stateright_tpu_torch.parallel.wave_common import compact, compact_plain

    k = compact(mask, size)
    p = compact_plain(mask, size)
    lanes = torch.arange(mask.shape[0], dtype=torch.int32, device=mask.device)
    torch.cuda.synchronize()
    return (
        max_abs_err(torch, zip(k, p)),
        time_ms(torch, lambda: compact(mask, size), 10),
        time_ms(torch, lambda: compact_plain(mask, size), 2),
        time_ms(torch, lambda: lanes[mask], 10),
        mask.shape[0] + size * 4 + 8,
        k[0],
    )


def phase_never_decided(torch):
    """The time-to-first-violation run: ``never decided`` fails, the run
    stops at the first wave that finds it, and the path replays."""
    from stateright_tpu_torch.core.has_discoveries import HasDiscoveries

    torch.cuda.synchronize()
    t0 = time.monotonic()
    checker = (
        paxos_model(3, never_decided=True).checker()
        .finish_when(HasDiscoveries.ANY_FAILURES)
        .spawn_gpu(**PAXOS3_GEOMETRY).join()
    )
    elapsed = time.monotonic() - t0
    path = checker.discoveries().get("never decided")
    if path is None:
        raise AssertionError("never decided: no counterexample found")
    last = path.last_state()
    if not any(getattr(a, "is_decided", False) for a in last.actor_states):
        raise AssertionError("never decided: the replayed path ends undecided")
    log(f"  never decided: counterexample of {len(path) - 1} steps replayed; "
        f"time_to_violation_s={elapsed:.3f} unique={checker.unique_state_count()} "
        f"depth={checker.max_depth()} waves={checker.waves()}")


def phase_paxos6_prefix(torch):
    """``paxos check 6`` to depth 6 on the card, bit-equal to the CPU run."""
    from stateright_tpu_torch.models.paxos_compiled import state_width

    card_and_cpu("paxos check 6 to depth 6",
                 lambda: paxos_model(6).checker().target_max_depth(6),
                 GOLDEN_PAXOS6_D6, state_width(6), capacity=1 << 14,
                 max_frontier=1 << 7)


def run_paxos6(torch):
    """``paxos check 6`` through ``spawn_gpu()`` at ``PAXOS6_GEOMETRY``,
    held to its golden; returns the joined checker and its wall seconds.
    ``gpu_profile.py --model paxos6`` times and traces this same run."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    checker = paxos_model(6).checker().spawn_gpu(**PAXOS6_GEOMETRY).join()
    elapsed = time.monotonic() - t0
    got = (checker.unique_state_count(), checker.max_depth())
    if got != GOLDEN_PAXOS6:
        raise AssertionError(f"paxos check 6 {got} != {GOLDEN_PAXOS6}")
    return checker, elapsed


def run_full(torch, gpu, path, run, properties_hold=True):
    """One full check through ``run`` with the launch counts of ``path``
    read around it; logs its counts, time and memory, holds the model's
    properties (unless ``properties_hold`` is False: ``run`` checks the
    discoveries itself), re-executes the discoveries on the host, and
    returns ``(launches, checker)``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    checker, elapsed = run(torch)
    launches = read_launches(path)
    unique, depth = checker.unique_state_count(), checker.max_depth()
    peak = torch.cuda.max_memory_allocated()
    log(f"  {path}: unique={unique} states={checker.state_count()} "
        f"depth={depth} waves={checker.waves()} growths={checker._grow_flags} "
        f"elapsed_s={elapsed:.3f} unique_per_s={unique / elapsed:.1f} "
        f"peak_bytes={peak} load={checker.table_load_factor():.4f} card={gpu!r}")
    log(f"  {path} launches: {launches}")
    if properties_hold:
        checker.assert_properties()
    paths = {k: len(p) - 1 for k, p in checker.discoveries().items()}
    log(f"  {path} discoveries re-executed: {paths}")
    return launches, checker


def single_copy_model(c, s):
    from stateright_tpu_torch.actor import Network
    from stateright_tpu_torch.models.single_copy_register import SingleCopyModelCfg

    return SingleCopyModelCfg(c, s, Network.new_unordered_nonduplicating()).into_model()


def phase_single_copy(torch):
    """3 clients / 1 server bit-equal to the CPU run; 2 clients / 2
    servers: the card finds the ``linearizable`` counterexample and the
    host replays it to a history with no linearization."""
    from stateright_tpu_torch.models.single_copy_compiled import state_width

    kw = dict(capacity=1 << 14, max_frontier=1 << 8)
    card_and_cpu("single-copy 3 clients", single_copy_model(3, 1).checker,
                 GOLDEN_SC3, state_width(3), **kw).assert_properties()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    bad = single_copy_model(2, 2).checker().spawn_gpu(**kw).join()
    elapsed = time.monotonic() - t0
    path = bad.discoveries().get("linearizable")
    if path is None:
        raise AssertionError("single-copy 2 servers: no linearizable counterexample")
    if path.last_state().history.serialized_history() is not None:
        raise AssertionError("single-copy 2 servers: the replayed history linearizes")
    log(f"  single-copy 2 servers: linearizable counterexample of "
        f"{len(path) - 1} steps replayed, time_to_violation_s={elapsed:.3f} "
        f"unique={bad.unique_state_count()} depth={bad.max_depth()}")


def run_sc4(torch):
    """``single-copy-register check 4`` through ``spawn_gpu()`` at
    ``SC4_GEOMETRY``, held to its golden; returns the joined checker and its
    wall seconds.  ``gpu_profile.py --model sc4`` times this same run."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    checker = single_copy_model(4, 1).checker().spawn_gpu(**SC4_GEOMETRY).join()
    elapsed = time.monotonic() - t0
    got = (checker.unique_state_count(), checker.max_depth())
    if got != GOLDEN_SC4:
        raise AssertionError(f"single-copy check 4 {got} != {GOLDEN_SC4}")
    return checker, elapsed


def phase_sc4_kernels(torch, checker, rows):
    """The ``single-copy-register check 4`` path's kernels against their
    twins on one real wave of its run (:func:`phase_single_phase_kernels`)."""
    from stateright_tpu_torch.models.single_copy_compiled import (
        _codec, single_copy_step, single_copy_step_plain,
    )

    cm = checker._compiled
    phase_single_phase_kernels(
        torch, checker, rows, "sc4", SC4_GEOMETRY, "single_copy_step",
        lambda states: single_copy_step(states, cm.s, cm.c),
        lambda states: single_copy_step_plain(states, cm.s, cm.c),
        _codec(cm.s, cm.c))


def phase_abd3o_kernels(torch, checker, rows):
    """The ``linearizable-register check 3 ordered`` path's kernels against
    their twins on one real wave of its run
    (:func:`phase_single_phase_kernels`)."""
    from stateright_tpu_torch.models.abd_compiled import (
        _codec, abd_step, abd_step_plain,
    )

    cm = checker._compiled
    args = (cm.c, cm.ordered, cm.skip_ack)
    phase_single_phase_kernels(
        torch, checker, rows, "abd3o", ABD3_GEOMETRY, "abd_step",
        lambda states: abd_step(states, *args),
        lambda states: abd_step_plain(states, *args),
        _codec(cm.c, cm.ordered))


def phase_single_phase_kernels(torch, checker, rows, path, geometry, name,
                               step, step_plain, codec, conds=None):
    """A single-phase path's kernels -- its model's step ``name``
    (``step``, twin ``step_plain``), K8, K1, K3 and K4, and K12 where the
    run ended on the sorted path -- against their twins on one real wave
    of its run (:func:`replay_wave`), called as the single-phase wave
    calls them (K1 on each row's identity prefix; K8 and K4 through the
    device-count entries the untraced run launches, and held to their
    host entries); the wave must append what the run did.  ``step`` returns ``(nexts, valid, conds, flag)``,
    or with ``conds`` -- ``(name, fn, plain)`` of a separate conds kernel
    -- ``(nexts, valid, flag)``.  Under a symmetry with a non-empty spec,
    K15 is held to its twin on the wave's candidate rows.  The step's operation count is the DP's
    (``codec``'s tester words; no codec, no DP: bound by bytes), charged
    to the conds kernel when there is one.  ``geometry`` is the chunk and
    ``dedup_factor`` the run ended at."""
    from stateright_tpu_torch.models.register_compiled_common import dp_work
    from stateright_tpu_torch.ops.device_fp import device_fp64, device_fp64_plain
    from stateright_tpu_torch.ops.u32 import u32
    from stateright_tpu_torch.parallel.canon import (
        canonicalize_rows, canonicalize_rows_plain, is_identity,
    )
    from stateright_tpu_torch.parallel.hashset import (
        compact_valid, unique_buffer_size,
    )
    from stateright_tpu_torch.parallel.wave_common import (
        prop_kinds, wave_eval, wave_eval_plain,
    )

    row = kernel_row(rows, path)
    checked = kernel_row(rows, None)  # the host entries the run does not launch
    cm = checker._compiled
    w, m = cm.state_width, cm.max_actions
    carry = checker._carry
    states, start, eb, discovered, table, appended = replay_wave(
        torch, checker, geometry)
    f = states.shape[0]

    k_step = step(states)
    p_step = step_plain(states)
    torch.cuda.synchronize()
    dp_ops = 0 if codec is None else int(dp_work(codec, u32(states)).sum())
    if conds is None:
        nexts, valid, cond_t = k_step[:3]
    else:
        nexts, valid = k_step[:2]
        c_name, c_fn, c_plain = conds
        cond_t = c_fn(states)
        p_cond = c_plain(states)
        torch.cuda.synchronize()
        row(c_name, max_abs_err(torch, [(cond_t, p_cond)]),
            time_ms(torch, lambda: c_fn(states), 10),
            time_ms(torch, lambda: c_plain(states), 2),
            f * w * 4 + cond_t.numel(), ops=dp_ops)
        dp_ops = 0
    n_props = cond_t.shape[1]
    row(name, max_abs_err(torch, zip(k_step, p_step)),
        time_ms(torch, lambda: step(states), 10),
        time_ms(torch, lambda: step_plain(states), 2),
        f * w * 4 + f * m * (w * 4 + 1) + (f * n_props if conds is None else 1),
        ops=dp_ops)
    del p_step
    log(f"  {name}: {int(valid.sum())} of {f * m} lanes valid")

    kinds = prop_kinds(checker._properties)
    gated = valid.clone()

    def fresh():
        gated.copy_(valid)

    k8 = wave_eval(cond_t, gated, eb, start, kinds, discovered)
    p8 = wave_eval_plain(cond_t, valid.clone(), eb, start, kinds, discovered)
    torch.cuda.synchronize()
    checked("wave_eval", max_abs_err(torch, zip(k8, p8)),
            time_ms(torch, lambda: wave_eval(cond_t, gated, eb, start, kinds,
                                             discovered), 10, setup=fresh),
            time_ms(torch, lambda: wave_eval_plain(cond_t, valid, eb, start,
                                                   kinds, discovered), 2),
            f * n_props + 2 * f * m + 2 * f * 4 + n_props * 8)
    stats = replay_stats(torch, n_props, start, discovered, states.device)
    active = torch.ones((f,), dtype=torch.bool, device=states.device)
    k8d = check_wave_eval_dev(torch, row, cond_t, valid, eb, stats, active, kinds)
    if not all(torch.equal(x, y) for x, y in zip(k8, k8d)):
        raise AssertionError("K8's device entry disagrees with its host entry")

    # K1 on every candidate row's identity prefix, as the single-phase
    # wave hashes them (in place: the prefix is a strided view; of the
    # canonical rows, through K15, under symmetry).
    cand_rows = nexts.view(f * m, w)
    spec = cm.canon_spec() if checker._canon is not None else None
    if spec is not None and not is_identity(spec):
        # K15 reads and writes each candidate row once: bound by bytes.
        k15 = canonicalize_rows(spec, cand_rows)
        p15 = canonicalize_rows_plain(spec, cand_rows)
        torch.cuda.synchronize()
        row("canonicalize_rows", max_abs_err(torch, [(k15, p15)]),
            time_ms(torch, lambda: canonicalize_rows(spec, cand_rows), 10),
            time_ms(torch, lambda: canonicalize_rows_plain(spec, cand_rows), 2),
            2 * f * m * w * 4)
        log(f"  canonicalize_rows: {f * m} candidate rows of the wave")
        del k15, p15
    ident = checker._identity(cand_rows)
    fpw = ident.shape[1]
    k1 = device_fp64(ident)
    p1 = device_fp64_plain(ident)
    torch.cuda.synchronize()
    row("device_fp64", max_abs_err(torch, zip(k1, p1)),
        time_ms(torch, lambda: device_fp64(ident), 10),
        time_ms(torch, lambda: device_fp64_plain(ident), 2),
        f * m * (fpw * 4 + 8))

    size = unique_buffer_size(geometry["max_frontier"] * m,
                              geometry["dedup_factor"])
    lane_valid = k8[0].view(-1)
    v_hi, v_lo, v_orig, v_act, _n_valid = compact_valid(
        *k1, lane_valid, sort_lanes=size)
    size = v_orig.shape[0]  # the buffer of this wave
    k3_valid = measure_compact(torch, lane_valid, size)
    if k3_valid[0] or not (k3_valid[5] == v_orig).all():
        raise AssertionError("compact_valid disagrees with its twin")
    if checker._sortless:
        k_new_d, _ok = check_insert_dev(torch, row, table, v_hi, v_lo, v_act)
        k_new = check_insert(torch, checked, table, v_hi, v_lo, v_act)
        origin = None
    else:
        # The sorted path: K12's prefix entry (+ K3) elects each key's
        # lowest lane in sorted-key order, then K4 inserts the
        # representatives.
        got = check_prededup(torch, row, checked, path, v_hi, v_lo,
                             count=_n_valid)
        u_hi, u_lo, origin, u_act, _ovf = got
        k_new_d, _ok = check_insert_dev(torch, row, table, u_hi, u_lo, u_act)
        k_new = check_insert(torch, checked, table, u_hi, u_lo, u_act)
    if not torch.equal(k_new, k_new_d):
        raise AssertionError("K4's device-epoch entry disagrees with its host entry")
    n_new = int(k_new.sum())
    k3_new = measure_compact(torch, k_new, k_new.shape[0])
    (e1, t1, q1, l1, b1, _), (e2, t2, q2, l2, b2, sel) = k3_valid, k3_new
    row("compact", e1 + e2, (t1 + t2) / 2, (q1 + q2) / 2, (b1 + b2) / 2,
        library_ms=(l1 + l2) / 2)

    lanes = sel[:n_new].long()
    if origin is not None:
        lanes = origin[lanes].long()
    idxs = v_orig[lanes].long()
    check_appends(torch, carry, appended, cand_rows[idxs], idxs, m, start, k8[1])
    # The replayed wave's commit, as K25 takes it (phase_append_kernel).
    return dict(sel=sel, origin=origin, v_orig=v_orig, cand_rows=cand_rows,
                eb=k8[1], lo_pos=start,
                tail=int(appended[0]) if n_new else carry.tail, n_new=n_new,
                a=m, two_phase=False)


def abd_model(c, ordered, fault=None):
    from stateright_tpu_torch.actor import Network
    from stateright_tpu_torch.models.abd import AbdModelCfg

    net = Network.new_ordered() if ordered else Network.new_unordered_nonduplicating()
    return AbdModelCfg(c, 2, net, fault=fault).into_model()


def phase_abd2(torch):
    """``linearizable-register check 2`` and its ordered twin bit-equal to
    the CPU runs; the skip_ack cluster's ``linearizable`` counterexample
    on both fabrics, replayed on the host to a history with no
    linearization."""
    from stateright_tpu_torch.models.abd_compiled import state_width

    kw = dict(capacity=1 << 13, max_frontier=1 << 8)
    for ordered, golden in ((False, GOLDEN_ABD2), (True, GOLDEN_ABD2O)):
        what = f"abd check 2{' ordered' if ordered else ''}"
        card_and_cpu(what, abd_model(2, ordered).checker, golden,
                     state_width(2, ordered), **kw).assert_properties()
    for ordered in (False, True):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        bad = abd_model(2, ordered, "skip_ack").checker().spawn_gpu(**kw).join()
        elapsed = time.monotonic() - t0
        path = bad.discoveries().get("linearizable")
        if path is None:
            raise AssertionError("abd skip_ack: no linearizable counterexample")
        if path.last_state().history.serialized_history() is not None:
            raise AssertionError("abd skip_ack: the replayed history linearizes")
        log(f"  abd skip_ack (ordered={ordered}): linearizable counterexample "
            f"of {len(path) - 1} steps replayed, time_to_violation_s="
            f"{elapsed:.3f} unique={bad.unique_state_count()} "
            f"states={bad.state_count()} depth={bad.max_depth()}")


def run_abd(torch, ordered, golden):
    """``linearizable-register check 3`` (``ordered``: ``check 3 ordered``)
    through ``spawn_gpu()`` at ``ABD3_GEOMETRY``, held to ``golden``;
    returns the joined checker and its wall seconds."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    checker = abd_model(3, ordered).checker().spawn_gpu(**ABD3_GEOMETRY).join()
    elapsed = time.monotonic() - t0
    got = (checker.unique_state_count(), checker.max_depth())
    if got != golden:
        raise AssertionError(f"abd check 3 ordered={ordered} {got} != {golden}")
    return checker, elapsed


def run_abd2(torch):
    """``linearizable-register check 2`` through ``spawn_gpu()``, held to
    its golden; ``gpu_profile.py --model abd2`` times this run."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    checker = abd_model(2, False).checker().spawn_gpu(
        capacity=1 << 13, max_frontier=1 << 8).join()
    elapsed = time.monotonic() - t0
    got = (checker.unique_state_count(), checker.state_count(), checker.max_depth())
    if got != GOLDEN_ABD2:
        raise AssertionError(f"abd check 2 {got} != {GOLDEN_ABD2}")
    return checker, elapsed


def run_abd3o(torch):
    """``gpu_profile.py --model abd3o`` times this run."""
    return run_abd(torch, True, GOLDEN_ABD3O)


def raft_model():
    from stateright_tpu_torch.models.raft import RaftModelCfg

    return RaftModelCfg(server_count=3).into_model()


def phase_raft_prefix(torch):
    """``raft check`` to depth 6 bit-equal to the port's CPU run; to depth
    10 at the JAX run's geometry and at a quarter of its chunk size, both
    at the golden and bit-equal to each other (the representative of a
    state is its first generator in BFS order, whatever the chunking)."""
    from stateright_tpu_torch.models.raft_compiled import W

    card_and_cpu("raft to depth 6", lambda: raft_model().checker().target_max_depth(6),
                 GOLDEN_RAFT_D6, W, capacity=1 << 15, max_frontier=1 << 8)
    runs = []
    for f in (RAFT_D10_GEOMETRY["max_frontier"], RAFT_D10_GEOMETRY["max_frontier"] // 4):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        checker = raft_model().checker().target_max_depth(10).spawn_gpu(
            **dict(RAFT_D10_GEOMETRY, max_frontier=f)).join()
        elapsed = time.monotonic() - t0
        got = (checker.unique_state_count(), checker.state_count(), checker.max_depth())
        log(f"  raft to depth 10 (max_frontier={f}): unique={got[0]} "
            f"states={got[1]} depth={got[2]} waves={checker.waves()} "
            f"elapsed_s={elapsed:.3f} discoveries={sorted(checker.discoveries())}")
        if got != GOLDEN_RAFT_D10:
            raise AssertionError(f"raft to depth 10 {got} != {GOLDEN_RAFT_D10}")
        if sorted(checker.discoveries()) != RAFT_FOUND:
            raise AssertionError(f"raft to depth 10 found {sorted(checker.discoveries())}")
        runs.append(checker)
    with tempfile.TemporaryDirectory() as tmp:
        a, b = (snapshot_logs(c, tmp, f"d10_{i}", W) for i, c in enumerate(runs))
    for k in a:
        if not (a[k] == b[k]).all():
            raise AssertionError(f"raft to depth 10: {k} differs between chunk sizes")
    log("  raft to depth 10: row log, parents and ebits equal at both chunk sizes")


def run_raft(torch):
    """The reference's default ``raft check`` (``target_max_depth(12)``)
    through ``spawn_gpu()`` at ``RAFT_GEOMETRY``, held to the JAX engine's
    count and discovery set; returns the joined checker and its wall
    seconds.  ``gpu_profile.py --model raft`` times and traces this same
    run."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    checker = raft_model().checker().target_max_depth(12).spawn_gpu(
        **RAFT_GEOMETRY).join()
    elapsed = time.monotonic() - t0
    got = (checker.unique_state_count(), checker.state_count(), checker.max_depth())
    if got != GOLDEN_RAFT:
        raise AssertionError(f"raft check {got} != {GOLDEN_RAFT}")
    if sorted(checker.discoveries()) != RAFT_FOUND:
        raise AssertionError(f"raft check found {sorted(checker.discoveries())}")
    return checker, elapsed


def phase_raft_other_chunking(torch, checker):
    """``raft check`` again at a quarter of the chunk size: the same
    counts, and the same row log, parents and eventually-bits (compared
    on the card)."""
    other = raft_model().checker().target_max_depth(12).spawn_gpu(**dict(
        RAFT_GEOMETRY, max_frontier=RAFT_GEOMETRY["max_frontier"] // 4)).join()
    a, b = checker._carry, other._carry
    w = checker._compiled.state_width
    got = (other.unique_state_count(), other.state_count(), other.max_depth())
    want = (checker.unique_state_count(), checker.state_count(), checker.max_depth())
    if got != want or a.tail != b.tail or not (
        torch.equal(a.rows[: a.tail * w], b.rows[: b.tail * w])
        and torch.equal(a.parent[: a.tail], b.parent[: b.tail])
        and torch.equal(a.ebits[: a.tail], b.ebits[: b.tail])
    ):
        raise AssertionError(f"raft check at max_frontier/4: {got} != {want} "
                             "or its logs differ")
    log(f"  raft check at max_frontier={RAFT_GEOMETRY['max_frontier'] // 4}: "
        f"unique={got[0]} states={got[1]} depth={got[2]} waves={other.waves()}, "
        f"row log, parents and ebits equal")


def phase_raft_election_safety(checker):
    """The ``Election Safety`` counterexample, re-executed on the host,
    ends in two leaders of one term (a crash and recover let a node vote
    twice: the reference's actor persists nothing)."""
    from stateright_tpu_torch.models.raft import LEADER

    path = checker.discoveries()["Election Safety"]
    leaders = [a.current_term for a in path.last_state().actor_states
               if a.current_role == LEADER]
    if len(leaders) == len(set(leaders)):
        raise AssertionError("Election Safety: the replayed path ends safe")
    log(f"  Election Safety: counterexample of {len(path) - 1} steps replayed, "
        f"leaders' terms {leaders}, actions "
        f"{[type(a).__name__ for a in path.into_actions()]}")


def phase_raft_kernels(torch, checker, rows):
    """The ``raft check`` path's kernels against their twins on one real
    wave of its run (:func:`phase_single_phase_kernels`)."""
    from stateright_tpu_torch.models.raft_compiled import raft_step, raft_step_plain

    crashes = checker._compiled.max_crashes
    phase_single_phase_kernels(
        torch, checker, rows, "raft", RAFT_GEOMETRY, "raft_step",
        lambda states: raft_step(states, crashes),
        lambda states: raft_step_plain(states, crashes), None)


def ping_pong_model(max_nat, lossy=True):
    from stateright_tpu_torch.models.ping_pong import PingPongCfg

    return PingPongCfg(False, max_nat).into_model().lossy_network_(lossy)


def run_ping_pong(torch, max_nat, geometry, golden=None):
    """Lossy ping-pong at ``max_nat`` through ``spawn_gpu()`` at
    ``geometry``, held to ``golden`` (when given) and the three
    discoveries; returns the joined checker and its wall seconds."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    checker = ping_pong_model(max_nat).checker().spawn_gpu(**geometry).join()
    elapsed = time.monotonic() - t0
    got = (checker.unique_state_count(), checker.state_count(), checker.max_depth())
    if golden is not None and got != golden:
        raise AssertionError(f"ping-pong max_nat {max_nat} {got} != {golden}")
    if sorted(checker.discoveries()) != PP_FOUND:
        raise AssertionError(f"ping-pong found {sorted(checker.discoveries())}")
    return checker, elapsed


def run_pp13(torch):
    """Lossy ping-pong at ``max_nat`` 13 on the claim path, held to the
    closed form by :func:`phase_pp13_collisions` (the 64-bit fingerprint
    merges a few of its states); ``gpu_profile.py --model pp13`` times and
    traces this same run."""
    return run_ping_pong(torch, 13, PP13_GEOMETRY)


def phase_pp13_collisions(torch, checker):
    """The pp13 run against the closed form.  Every valid successor of
    every logged state is fingerprinted (K13, K1) and looked up among the
    log's fingerprints: each must be there (the search is complete), and
    a successor whose words differ from the logged row of its fingerprint
    is a state the 64-bit fingerprint merged into another.  The run must
    be the closed form less exactly those states: unique by their number,
    states by their valid successors, the same depth."""
    from stateright_tpu_torch.models.ping_pong_compiled import ping_pong_step
    from stateright_tpu_torch.ops.device_fp import device_fp64, fp64_of

    cm = checker._compiled
    carry = checker._carry
    n = carry.tail
    rows = carry.rows[: 2 * n].view(n, 2)
    skey, perm = torch.sort(fp64_of(*device_fp64(rows)))
    if (skey[1:] == skey[:-1]).any():
        raise AssertionError("pp13: two logged rows share a fingerprint")
    lost = []
    for start in range(0, n, 1 << 20):
        chunk = rows[start : start + (1 << 20)]
        nexts, valid, _conds = ping_pong_step(chunk, cm.max_nat, cm.lossy)
        cand = nexts.view(-1, 2)[valid.view(-1)]
        key = fp64_of(*device_fp64(cand))
        pos = torch.searchsorted(skey, key).clamp(max=n - 1)
        if not (skey[pos] == key).all():
            raise AssertionError("pp13: a successor's fingerprint is not in the log")
        differs = (rows[perm[pos]] != cand).any(dim=1)
        lost.append(cand[differs])
    lost = torch.unique(torch.cat(lost), dim=0)
    _nexts, lost_valid, _conds = ping_pong_step(lost, cm.max_nat, cm.lossy)
    got = (checker.unique_state_count(), checker.state_count(), checker.max_depth())
    want = (GOLDEN_PP13[0] - lost.shape[0],
            GOLDEN_PP13[1] - int(lost_valid.sum()), GOLDEN_PP13[2])
    log(f"  pp13 against the closed form {GOLDEN_PP13}: {lost.shape[0]} states "
        f"merged by a fingerprint collision with a logged state "
        f"({[[hex(int(x) & 0xFFFFFFFF) for x in r] for r in lost.tolist()]}), "
        f"{int(lost_valid.sum())} valid successors of theirs; run {got}, "
        f"closed form less those {want}")
    if got != want:
        raise AssertionError(f"pp13 {got} != the closed form less the merged states {want}")


def run_pp11s(torch):
    """Lossy ping-pong at ``max_nat`` 11 at the default ``dedup_factor``,
    through the sorted fallback, with the JAX rules' grow notes;
    ``gpu_profile.py --model pp11s`` times and traces this same run."""
    checker, elapsed = run_ping_pong(torch, 11, PP11S_GEOMETRY, GOLDEN_PP11)
    if checker._grow_notes != PP11S_NOTES:
        raise AssertionError(f"ping-pong max_nat 11 grew {checker._grow_notes}")
    return checker, elapsed


def final_geometry(checker, geometry):
    """``geometry`` with the chunk and ``dedup_factor`` the run ended at."""
    return dict(geometry, max_frontier=checker._max_frontier,
                dedup_factor=checker._dedup_factor)


def phase_ping_pong_kernels(torch, checker, rows, path, geometry):
    """A ping-pong path's kernels against their twins on one real wave of
    its run (:func:`phase_single_phase_kernels`); returns that wave's
    commit, as K25 takes it."""
    from stateright_tpu_torch.models.ping_pong_compiled import (
        ping_pong_step, ping_pong_step_plain,
    )

    cm = checker._compiled
    return phase_single_phase_kernels(
        torch, checker, rows, path, final_geometry(checker, geometry),
        "ping_pong_step",
        lambda states: ping_pong_step(states, cm.max_nat, cm.lossy),
        lambda states: ping_pong_step_plain(states, cm.max_nat, cm.lossy), None)


def phase_ping_pong_goldens(torch):
    """The reference's goldens and a run that falls back to the sorted
    path, each bit-equal to the port's CPU run."""
    for max_nat, lossy, kw, golden in (
        (1, True, {}, (14, 21, 6)),
        (5, False, {}, (11, 11, 11)),
        (5, True, {}, (4_094, 21_505, 22)),
        (6, True, dict(max_frontier=1 << 12), (16_382, 102_401, 26)),
    ):
        what = f"ping-pong max_nat {max_nat} {'lossy' if lossy else 'lossless'}"
        gpu = card_and_cpu(what, ping_pong_model(max_nat, lossy).checker, golden,
                           2, capacity=1 << 16, **kw)
        if ("sortless=0" in gpu._grow_notes) != bool(kw):
            raise AssertionError(f"{what} grew {gpu._grow_notes}")
        log(f"  {what}: discoveries {sorted(gpu.discoveries())}, growths "
            f"{gpu._grow_notes}")


def check_prededup(torch, row, checked, path, v_hi, v_lo, count=None,
                   active=None):
    """K12 on one replayed batch against its twin: timed alone (the sort,
    ``_sorted_runs*``) and inside the whole wrapper (K12, K3 and the
    gathers), beside ``torch.sort(stable=True)`` of the whole buffer and
    of the active prefix.  With ``count`` (the batch's active lanes are
    that prefix, as on the sorted path) the path's row is the prefix
    entry's, and the mask entry is checked and timed on the same batch
    (``checked``); with ``active`` alone the row is the mask entry's.
    Bytes: each input read once (the keys, and the mask or the count),
    each output written once (the sorted keys and lanes, rep).  Returns
    the wrapper's answer."""
    from stateright_tpu_torch.parallel.hashset import (
        _sorted_runs, _sorted_runs_plain, _sorted_runs_prefix,
        prededup, prededup_plain, prededup_prefix,
    )

    size = v_hi.shape[0]
    if count is not None:
        m = min(int(count), size)
        active = torch.arange(size, device=v_hi.device) < m
    else:
        m = int(active.sum())
    skey = torch.where(
        active, v_hi.long() * (1 << 32) + (v_lo.long() & 0xFFFFFFFF), -1
    ) ^ (-(1 << 63))
    head = skey[:m]
    whole_ms = time_ms(torch, lambda: torch.sort(skey, stable=True), 10)
    want_runs = _sorted_runs_plain(v_hi, v_lo, active)
    want = prededup_plain(v_hi, v_lo, active, 1)
    plain_ms = time_ms(torch, lambda: _sorted_runs_plain(v_hi, v_lo, active), 2)
    got_runs = _sorted_runs(v_hi, v_lo, active)
    got = prededup(v_hi, v_lo, active, 1)
    torch.cuda.synchronize()
    n_rep = int(want[3].sum())
    (row if count is None else checked)(
        "prededup",
        max_abs_err(torch, zip(got_runs, want_runs)) +
        max_abs_err(torch, zip(got, want)),
        time_ms(torch, lambda: _sorted_runs(v_hi, v_lo, active), 10),
        plain_ms, size * (4 + 4 + 1) + size * (8 + 4 + 1),
        library_ms=whole_ms)
    log(f"  prededup [{path}]: {m} active lanes of {size}, {n_rep} distinct "
        f"keys; the mask entry's wrapper (K12, K3, gathers) "
        f"{time_ms(torch, lambda: prededup(v_hi, v_lo, active, 1), 10):.4f} "
        f"ms; torch.sort(stable=True) of the whole buffer {whole_ms:.4f} ms")
    if count is None:
        return got
    prefix_ms = time_ms(torch, lambda: torch.sort(head, stable=True), 10)
    got_runs = _sorted_runs_prefix(v_hi, v_lo, count)
    got = prededup_prefix(v_hi, v_lo, count, 1)
    torch.cuda.synchronize()
    # The prefix entry leaves keys and lanes past the count unwritten.
    row("prededup_prefix",
        max_abs_err(torch, zip((got_runs[0][:m], got_runs[1][:m], got_runs[2]),
                               (want_runs[0][:m], want_runs[1][:m], want_runs[2])))
        + max_abs_err(torch, zip(got, want)),
        time_ms(torch, lambda: _sorted_runs_prefix(v_hi, v_lo, count), 10),
        plain_ms, m * (4 + 4) + 8 + m * (8 + 4) + size,
        library_ms=prefix_ms)
    log(f"  prededup_prefix [{path}]: the wrapper (K12, K3, gathers) "
        f"{time_ms(torch, lambda: prededup_prefix(v_hi, v_lo, count, 1), 10):.4f} "
        f"ms; torch.sort(stable=True) of the {m}-lane prefix {prefix_ms:.4f} ms")
    return got


def phase_prededup_fuzz(torch):
    """K12 (+ K3) against its twin on fuzzed batches: keys with hi >= 2**31
    beside small ones, an active all-ones key (never a representative),
    an all-duplicate batch, a batch with no active lane, and sizes that
    are no power of two, up to 2**22 lanes; at dedup_factor 1 and 4 and a
    256-lane rung; the mask entry on the batch's mask, the prefix entry
    at counts 0, 1, a third, one ending inside a tile, all and past
    all."""
    import numpy as np

    from stateright_tpu_torch.ops.u32 import from_numpy_u32
    from stateright_tpu_torch.parallel.hashset import (
        _sorted_runs_plain, _sorted_runs_prefix, prededup, prededup_plain,
        prededup_prefix,
    )

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    for n, pool, p in ((1, 1, 1.0), (37, 5, 0.9), (4097, 4097, 0.5),
                       (100_003, 20_000, 0.8), ((1 << 22) - 3, 1 << 20, 0.6),
                       (5000, 1, 1.0), (6000, 100, 0.0)):
        keys = rng.integers(0, 1 << 63, size=pool, dtype=np.uint64)
        keys[: pool // 2] |= np.uint64(1 << 63)
        vals = keys[rng.integers(0, pool, size=n)]
        vals[n // 2] = np.uint64(0xFFFFFFFFFFFFFFFF)
        hi = from_numpy_u32((vals >> np.uint64(32)).astype(np.uint32), dev)
        lo = from_numpy_u32(vals.astype(np.uint32), dev)
        active = torch.from_numpy(rng.random(n) < p).to(dev)
        for dd, rung in ((1, None), (4, None), (1, 256)):
            got = prededup(hi, lo, active, dd, rung)
            want = prededup_plain(hi, lo, active, dd, rung)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"prededup disagrees with its twin at n={n}, "
                                     f"dedup_factor={dd}, sort_lanes={rung}")
        counts = sorted({0, 1, n // 3, min(n, 2048 + 777), n, n + 5})
        for m in counts:
            count = torch.tensor(m, device=dev)
            mask = torch.arange(n, device=dev) < m
            runs = _sorted_runs_prefix(hi, lo, count)
            want_runs = _sorted_runs_plain(hi, lo, mask)
            k = min(m, n)
            if not (torch.equal(runs[0][:k], want_runs[0][:k])
                    and torch.equal(runs[1][:k], want_runs[1][:k])
                    and torch.equal(runs[2], want_runs[2])):
                raise AssertionError(f"K12's prefix entry disagrees with its "
                                     f"twin at n={n}, count={m}")
            for dd, rung in ((1, None), (4, None), (1, 256)):
                got = prededup_prefix(hi, lo, count, dd, rung)
                want = prededup_plain(hi, lo, mask, dd, rung)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(
                        f"prededup_prefix disagrees with its twin at n={n}, "
                        f"count={m}, dedup_factor={dd}, sort_lanes={rung}")
        log(f"  prededup: {n} lanes, {int(active.sum())} active, equal to the "
            f"twin at three geometries; the prefix entry at counts {counts}")


def phase_bucket_fuzz(torch):
    """K26 against its twin, bit-equal (send buffer, counts, overflow), on
    fuzzed representatives: 1 to 1,024 owners; 0, 1, a tile less and more
    one, the tile-size switches, 32,768, 106,496 and 2**20 - 3 lanes; rows
    of 1, 7, 74 and 80 words, strided views of wider rows reached through
    a row index; buckets with room to spare, exactly full (the largest
    bucket's size) and one short of it (the overflow bit, a lane dropped);
    and every lane to one owner."""
    import numpy as np

    from stateright_tpu_torch.ops.u32 import from_numpy_u32
    from stateright_tpu_torch.parallel.exchange import (
        owner_bucket, owner_bucket_plain, owner_mix_host_np,
    )

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED + 26)

    def u32(x):
        return from_numpy_u32(np.asarray(x, np.uint32), dev)

    def keys(u, n, one_owner):
        hi = rng.integers(0, 2**32, size=u, dtype=np.uint32)
        lo = rng.integers(0, 2**32, size=u, dtype=np.uint32)
        if one_owner and u:
            # Draw until u keys land on owner 0.
            hs, ls = [], []
            while sum(h.shape[0] for h in hs) < u:
                h = rng.integers(0, 2**32, size=4 * u * n, dtype=np.uint32)
                l = rng.integers(0, 2**32, size=h.shape[0], dtype=np.uint32)
                at = owner_mix_host_np(h, l) % n == 0
                hs.append(h[at])
                ls.append(l[at])
            hi, lo = np.concatenate(hs)[:u], np.concatenate(ls)[:u]
        return hi, lo

    cases = []
    sizes = (0, 1, 255, 257, 511, 67_584, 67_585, 135_168, 135_169, 32_768,
             106_496, (1 << 20) - 3)
    widths = (1, 7, 74, 80)
    for i, n in enumerate((1, 2, 3, 4, 8, 64, 1024)):
        for j, u in enumerate(sizes):
            if n == 1024 and u > 106_496:
                continue  # a 418 MB buffer: 2**20 lanes run at n <= 64
            cases.append((n, u, widths[(i + j) % 4], (i + j) % 3, False))
    cases += [(8, 32_768, 74, 0, True), (4, 106_496, 7, 1, True),
              (2, 257, 1, 2, True), (1024, 4_096, 80, 1, True)]
    t0 = time.monotonic()
    for n, u, w, mode, one_owner in cases:
        hi, lo = keys(u, n, one_owner)
        valid = torch.from_numpy(rng.random(u) < (1.0, 0.7, 0.3)[mode]).to(dev)
        r = u + 3
        wide = u32(rng.integers(0, 2**32, size=(r, w + 5), dtype=np.uint32))
        rows = wide[:, :w]  # a strided view: rows lie w + 5 words apart
        a = 3
        states = max(1, (u + a - 1) // a)
        args = [u32(hi), u32(lo), valid, rows,
                u32(rng.integers(0, r, size=u)),
                u32(rng.integers(0, states * a, size=u)), a,
                u32(rng.integers(0, 2**32, size=states, dtype=np.uint32)),
                u32(rng.integers(0, 2**32, size=states, dtype=np.uint32)), n]
        # Room to spare, then exactly the largest bucket, then one short.
        counts = owner_bucket_plain(*args, 1)[1]
        top = int(counts[:n].max()) if n else 0
        bkts = sorted({max(1, (u + n - 1) // n + u // (4 * n) + 1), max(1, top),
                       max(1, top - 1)})
        for bkt in bkts:
            got = owner_bucket(*args, bkt)
            want = owner_bucket_plain(*args, bkt)
            torch.cuda.synchronize()
            if not all(torch.equal(g, p.to(g.dtype)) for g, p in zip(got, want)):
                raise AssertionError(
                    f"owner_bucket disagrees with its twin at n={n}, u={u}, "
                    f"w={w}, bkt={bkt}, one_owner={one_owner}")
        del args, wide, rows, valid, got, want
    log(f"  owner_bucket: {len(cases)} fuzzed batches at up to three bucket "
        f"sizes each, bit-equal to the twin ({time.monotonic() - t0:.1f}s)")


def phase_cold_probe_fuzz(torch):
    """K20's probe against its twin, bit-equal (the mask it leaves), on
    fuzzed chunks of 1, 2, 8, 4,096, 8,192, 16,384, 2**15 and 2**20 keys,
    part of them above 2**63 and the rest padded with the all-ones key;
    queries drawn from the chunk, at its first and last key, the pad key
    and fresh keys; all-false, all-true and partial masks, one of them a
    view that starts off a 16-byte boundary; with and without ``origin``."""
    import numpy as np

    from stateright_tpu_torch.ops.u32 import from_numpy_u32
    from stateright_tpu_torch.tiered.cold_join import cold_probe, cold_probe_plain

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED + 20)
    ones = np.uint64(0xFFFFFFFFFFFFFFFF)
    t0 = time.monotonic()
    cases = 0
    for c in (1, 2, 8, 4096, 8192, 16384, 1 << 15, 1 << 20):
        for fill in sorted({c, max(1, c // 3), max(0, c - 1)}):
            real = rng.integers(0, 1 << 63, size=fill, dtype=np.uint64)
            real[: fill // 2] |= np.uint64(1 << 63)
            real = np.sort(real)
            chunk = np.full(c, ones, np.uint64)
            chunk[:fill] = real
            chunk_t = torch.from_numpy(chunk.view(np.int64)).to(dev)
            for n, p, use_origin, skew in ((1, 1.0, False, 0), (37, 0.5, True, 3),
                                           (100_003, 0.2, False, 5),
                                           ((1 << 21) + 5, 0.2, True, 0),
                                           (50_000, 0.0, False, 0),
                                           (50_000, 1.0, True, 7)):
                m = n + 11
                pool = [real, rng.integers(0, 2**64, size=max(1, m // 2),
                                           dtype=np.uint64)]
                q = np.concatenate(pool)[rng.integers(
                    0, fill + max(1, m // 2), size=m)]
                if fill:
                    q[:2] = (real[0], real[-1])
                q[2 % m] = ones
                hi = from_numpy_u32((q >> np.uint64(32)).astype(np.uint32), dev)
                lo = from_numpy_u32(q.astype(np.uint32), dev)
                origin = (from_numpy_u32(rng.integers(0, m, size=n).astype(np.uint32),
                                         dev) if use_origin else None)
                if not use_origin:
                    hi, lo = hi[:n].contiguous(), lo[:n].contiguous()
                backing = torch.from_numpy(rng.random(n + skew) < p).to(dev)
                mask = backing[skew:]  # skew bytes past a 16-byte boundary
                before = backing[:skew].clone()
                want = mask.clone()
                cold_probe_plain(hi, lo, origin, want, chunk_t)
                cold_probe(hi, lo, origin, mask, chunk_t)
                torch.cuda.synchronize()
                if not torch.equal(mask, want) or not torch.equal(backing[:skew],
                                                                  before):
                    raise AssertionError(
                        f"cold_probe disagrees with its twin at C={c}, "
                        f"fill={fill}, n={n}, origin={use_origin}, skew={skew}")
                cases += 1
    log(f"  cold_probe: {cases} fuzzed passes bit-equal to the twin "
        f"({time.monotonic() - t0:.1f}s)")


def launches_per_call(torch, fn) -> int:
    """The operations one call of ``fn`` puts on the card (kernels, fills
    and copies): the nodes of a CUDA graph that captures the call, counted
    by ``libcuda``'s ``cuGraphGetNodes``.  A call on the capture stream
    first makes what a wrapper keeps per stream (K26's and K27's scratch)
    before the capture; the captured call never runs."""
    import ctypes

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
        fn()
    libcuda = ctypes.CDLL("libcuda.so.1")
    libcuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_size_t)]
    nodes = ctypes.c_size_t(0)
    code = libcuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                                   ctypes.byref(nodes))
    if code:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {code}")
    return nodes.value


# K4's one-block path takes buffers of at most this many lanes.
INSERT_TILE = 4096


def phase_insert_fuzz(torch):
    """K4's host and device-epoch entries against the twin, bit-equal
    (the new mask, ``probe_ok``, the key set; with ``with_slots`` each
    active lane's slot holds its key): 1, a tile less one, a tile, a tile
    and one, and 2**20 lanes; keys with hi >= 2**31; one key in 1, 2 and
    1,000 lanes; keys present before the call; a full table (``probe_ok``
    false); a CUDA graph of the device entry replayed over four waves,
    each tagged with a fresh epoch; the epoch at its wrap on both entries.
    Logs each entry's operations on the card per call."""
    import numpy as np

    from stateright_tpu_torch.ops.u32 import from_numpy_u32
    from stateright_tpu_torch.parallel.hashset import (
        _EPOCH_MAX, HashSet, insert_batch_claim, insert_batch_claim_dev,
        insert_batch_claim_plain, keys_equal,
    )

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED + 4)
    t0 = time.monotonic()

    def halves(keys):
        keys = np.asarray(keys, np.uint64)
        return (from_numpy_u32((keys >> np.uint64(32)).astype(np.uint32), dev),
                from_numpy_u32(keys.astype(np.uint32), dev))

    def fresh_keys(m):
        keys = rng.integers(1, 2**64, size=m, dtype=np.uint64)
        keys[: m // 2] |= np.uint64(1 << 63)  # hi >= 2**31
        return keys

    def table_with(cap, present):
        """A card table and its twin's key plane, holding ``present``."""
        p_keys = torch.zeros((cap,), dtype=torch.int64, device=dev)
        if len(present):
            hi, lo = halves(present)
            insert_batch_claim_plain(p_keys, hi, lo, torch.ones(
                (len(present),), dtype=torch.bool, device=dev))
        return HashSet(p_keys.clone()), p_keys

    def check(what, table, p_keys, keys, active, entry, epoch=None):
        hi, lo = halves(keys)
        if entry == "host":
            new, ok, slot = insert_batch_claim(table, hi, lo, active,
                                               with_slots=True)
        else:
            new, ok = insert_batch_claim_dev(table, hi, lo, active, epoch)
            slot = None
        p_new, p_ok = insert_batch_claim_plain(p_keys, hi, lo, active)
        torch.cuda.synchronize()
        good = (torch.equal(new, p_new) and bool(ok) == bool(p_ok)
                and keys_equal(table, HashSet(p_keys)))
        if slot is not None and bool(p_ok):
            act = torch.nonzero(active).flatten()
            key = (hi.long() << 32) | (lo.long() & 0xFFFFFFFF)
            good = good and torch.equal(table.keys[slot[act].long()], key[act])
        if not good:
            raise AssertionError(f"insert_batch_claim ({entry}) disagrees with "
                                 f"its twin: {what}")
        return bool(p_ok)

    cases = 0
    for n in (1, INSERT_TILE - 1, INSERT_TILE, INSERT_TILE + 1, 1 << 20):
        # Room for every key the five calls bring: which keys a filling
        # table takes depends on the order the claims land in.
        cap = 1 << max(12, (8 * n).bit_length())
        for entry in ("host", "dev"):
            present = fresh_keys(cap // 8)
            table, p_keys = table_with(cap, present)
            epoch = torch.tensor([41], dtype=torch.int32, device=dev)
            # Random keys: a third present before the call, the rest from a
            # pool half the batch (duplicates within the batch).
            pool = fresh_keys(max(1, n // 2))
            keys = np.where(rng.random(n) < 1 / 3,
                            present[rng.integers(0, len(present), size=n)],
                            pool[rng.integers(0, len(pool), size=n)])
            active = torch.from_numpy(rng.random(n) < 0.7).to(dev)
            check(f"n={n}, random", table, p_keys, keys, active, entry, epoch)
            # One key in 1, 2 and 1,000 lanes (as many as the batch holds),
            # the rest fresh; every lane active.
            for copies in (1, 2, 1000):
                keys = fresh_keys(n)
                lanes = rng.permutation(n)[: min(copies, n)]
                keys[lanes] = fresh_keys(1)[0]
                check(f"n={n}, one key in {len(lanes)} lanes", table, p_keys,
                      keys, torch.ones((n,), dtype=torch.bool, device=dev),
                      entry, epoch)
            cases += 4
            if entry == "dev" and int(epoch) != 45:
                raise AssertionError("the device entry did not advance its "
                                     f"epoch once a call: {int(epoch)}")
    # A full table: every absent key probes the whole table.
    for entry in ("host", "dev"):
        for n in (5, INSERT_TILE + 7):
            present = fresh_keys(64)
            table, p_keys = table_with(64, present)
            keys = np.concatenate([present[rng.integers(0, 64, size=n // 2)],
                                   fresh_keys(n - n // 2)])
            ok = check(f"full table, n={n}", table, p_keys, keys,
                       torch.ones((n,), dtype=torch.bool, device=dev), entry,
                       torch.tensor([3], dtype=torch.int32, device=dev))
            if ok:
                raise AssertionError("a full table left probe_ok true")
            cases += 1
    # The epoch at its wrap: the host entry clears the tags past
    # _EPOCH_MAX; the fused loop clears them and the word before it.
    for entry in ("host", "dev"):
        table, p_keys = table_with(1 << 15, fresh_keys(1 << 11))
        # The word holds _EPOCH_MAX - 1 (int32 -2): the call tags with
        # _EPOCH_MAX.
        epoch = torch.tensor([-2], dtype=torch.int32, device=dev)
        table.epoch = _EPOCH_MAX - 1
        for step in range(3):
            keys = fresh_keys(INSERT_TILE + 9)
            keys[1::3] = keys[::3][: len(keys[1::3])]  # pairs of one key
            check(f"wrap step {step}", table, p_keys, keys, torch.ones(
                (len(keys),), dtype=torch.bool, device=dev), entry, epoch)
            if entry == "dev":
                word = int(epoch) & 0xFFFFFFFF
                if word != (_EPOCH_MAX if step == 0 else step):
                    raise AssertionError(f"the epoch word reads {word} at step {step}")
                if step == 0:  # the caller's clear at the wrap
                    table.tags.zero_()
                    epoch.zero_()
            cases += 1
        if entry == "host" and table.epoch != 2:
            raise AssertionError(f"the host entry's epoch is {table.epoch} after the wrap")
    # A CUDA graph of the device entry, replayed wave after wave.
    for n in (300, INSERT_TILE + 300):
        table, p_keys = table_with(1 << 16, fresh_keys(1 << 12))
        epoch = torch.tensor([9], dtype=torch.int32, device=dev)
        hi, lo = halves(fresh_keys(n))
        act = torch.ones((n,), dtype=torch.bool, device=dev)
        p_new, _ = insert_batch_claim_plain(p_keys, hi, lo, act)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # loads the kernel before the capture
            new, _ok = insert_batch_claim_dev(table, hi, lo, act, epoch)
        torch.cuda.current_stream().wait_stream(side)
        if not torch.equal(new, p_new):
            raise AssertionError("insert_batch_claim_dev disagrees before the capture")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            g_new, g_ok = insert_batch_claim_dev(table, hi, lo, act, epoch)
        for wave in range(4):
            keys = fresh_keys(n)
            keys[: n // 4] = keys[n // 4 : n // 2]  # duplicates in the wave
            w_hi, w_lo = halves(keys)
            hi.copy_(w_hi)
            lo.copy_(w_lo)
            act.copy_(torch.from_numpy(rng.random(n) < 0.8).to(dev))
            graph.replay()
            p_new, p_ok = insert_batch_claim_plain(p_keys, hi, lo, act)
            torch.cuda.synchronize()
            if not (torch.equal(g_new, p_new) and bool(g_ok) == bool(p_ok)
                    and keys_equal(table, HashSet(p_keys))
                    and int(epoch) == 11 + wave):
                raise AssertionError(
                    f"the replayed device entry disagrees at wave {wave} "
                    f"(n={n}, epoch {int(epoch)})")
            cases += 1
        del graph
    # Operations on the card per call, each entry on each path.
    table = HashSet.empty(1 << 16, dev)
    epoch = torch.zeros((1,), dtype=torch.int32, device=dev)
    per_call = {}
    for n in (INSERT_TILE, INSERT_TILE + 1):
        hi, lo = halves(fresh_keys(n))
        act = torch.ones((n,), dtype=torch.bool, device=dev)
        path = "one block" if n <= INSERT_TILE else "grid"
        per_call["insert_batch_claim", path] = launches_per_call(
            torch, lambda: insert_batch_claim(table, hi, lo, act))
        per_call["insert_batch_claim_dev", path] = launches_per_call(
            torch, lambda: insert_batch_claim_dev(table, hi, lo, act, epoch))
    for (name, path), k in per_call.items():
        log(f"  {name} [{path}]: {k} operation(s) on the card a call")
    design = {"one block": 1, "grid": 2}
    if any(k != design[path] for (_name, path), k in per_call.items()):
        raise AssertionError(f"K4 launches other than its design: {per_call}")
    log(f"  insert_batch_claim: {cases} fuzzed calls bit-equal to the twin "
        f"({time.monotonic() - t0:.1f}s)")


def phase_commit_fuzz(torch):
    """K27 against its twin, bit-equal (store, parent, ebits, queue and
    n_new): no new lane, every lane new, new lanes only in the last tile;
    a queue that ends inside the batch; rows of 1 word and of the widest
    model row the script drives (paxos check 6's); with and without
    ``origin``; ``gid``/``eb`` strided views of a packed receive buffer
    and contiguous ones.  Logs its operations on the card per call."""
    import numpy as np

    from stateright_tpu_torch.ops.u32 import from_numpy_u32
    from stateright_tpu_torch.parallel.exchange import (
        shard_commit, shard_commit_plain,
    )

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED + 27)
    widest = max(m.compiled().state_width for m in (
        paxos_model(6), raft_model(), abd_model(3, True),
        single_copy_model(4, 1), lww_model(3)))
    t0 = time.monotonic()

    def u32(x):
        return from_numpy_u32(np.asarray(x, np.uint32), dev)

    cases = []
    for w in (1, widest):
        for r, pattern in ((5_000, "none"), (5_000, "all"), (7 * 256 + 100, "last"),
                           (1, "all"), (256, "all"), (257, "last"),
                           (40_000, "random"), (300_000, "random")):
            for overflow, origin, strided in ((False, False, True),
                                              (True, True, False),
                                              (False, True, True)):
                cases.append((w, r, pattern, overflow, origin, strided))
    last = None
    for w, r, pattern, overflow, use_origin, strided in cases:
        cap = 1 << max(10, r.bit_length() + 1)
        if pattern == "none":
            mask = np.zeros(r, bool)
        elif pattern == "all":
            mask = np.ones(r, bool)
        elif pattern == "last":
            mask = np.zeros(r, bool)
            mask[(r - 1) // 256 * 256 :] = rng.random(r - (r - 1) // 256 * 256) < 0.6
        else:
            mask = rng.random(r) < 0.3
        n_new = int(mask.sum())
        is_new = torch.from_numpy(mask).to(dev)
        slot = u32(rng.permutation(cap)[:r])
        origin = u32(rng.permutation(r)) if use_origin else None
        recv = u32(rng.integers(0, 2**32, size=(r, w + 3), dtype=np.uint32))
        rows = recv[:, :w]
        gid, eb = recv[:, w], recv[:, w + 1]
        if not strided:
            gid, eb = gid.contiguous(), eb.contiguous()
        tail = int(rng.integers(0, 100))
        qlen = tail + n_new // 2 if overflow else cap + 64
        tables = [[u32(rng.integers(0, 2**32, size=shape, dtype=np.uint32))
                   for shape in ((cap, w), (cap,), (cap,), (qlen,))]]
        tables.append([t.clone() for t in tables[0]])
        counts = [fn(is_new, slot, origin, rows, gid, eb, *tabs, tail)
                  for fn, tabs in zip((shard_commit, shard_commit_plain), tables)]
        torch.cuda.synchronize()
        if not (int(counts[0]) == int(counts[1]) == n_new
                and all(torch.equal(k, q) for k, q in zip(*tables))):
            raise AssertionError(
                f"shard_commit disagrees with its twin at w={w}, r={r}, "
                f"{pattern}, overflow={overflow}, origin={use_origin}, "
                f"strided={strided}")
        last = (is_new, slot, origin, rows, gid, eb, tables[0], tail)
    is_new, slot, origin, rows, gid, eb, tabs, tail = last
    per_call = launches_per_call(torch, lambda: shard_commit(
        is_new, slot, origin, rows, gid, eb, *tabs, tail))
    log(f"  shard_commit: {per_call} operation(s) on the card a call")
    if per_call != 1:
        raise AssertionError(f"K27 put {per_call} operations on the card a call")
    log(f"  shard_commit: {len(cases)} fuzzed commits bit-equal to the twin, "
        f"rows of 1 and {widest} words ({time.monotonic() - t0:.1f}s)")


def bounded_paxos_model(c, max_round):
    from stateright_tpu_torch.actor import Network
    from stateright_tpu_torch.models.paxos import PaxosModelCfg

    return PaxosModelCfg(
        c, 3, Network.new_unordered_nonduplicating(), max_round=max_round
    ).into_model()


def run_paxos3b(torch):
    """``paxos check 3`` at ``max_round=3``, single-phase through K14;
    ``gpu_profile.py --model paxos3b`` times and traces this same run."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    checker = bounded_paxos_model(3, 3).checker().spawn_gpu(**PAXOS3B_GEOMETRY).join()
    elapsed = time.monotonic() - t0
    got = (checker.unique_state_count(), checker.state_count(), checker.max_depth())
    if got != GOLDEN_PAXOS3B:
        raise AssertionError(f"bounded paxos check 3 {got} != {GOLDEN_PAXOS3B}")
    return checker, elapsed


def card_logs(checker):
    """The run's row log, parents and ebits, copied on the card."""
    c = checker._carry
    w = checker._compiled.state_width
    return (c.rows[: c.tail * w].clone(), c.parent[: c.tail].clone(),
            c.ebits[: c.tail].clone())


def phase_bounded_paxos(torch, checker, rows, two_phase_logs):
    """The bounded run's log against the two-phase run's, its kernels
    against their twins on one real wave, c=4 at ``max_round=2`` and c=2
    at ``max_round=1`` against the CPU run."""
    from stateright_tpu_torch.models.paxos_compiled import (
        _codec, paxos_conds, paxos_conds_plain, paxos_step, paxos_step_plain,
        state_width,
    )

    same = all(torch.equal(a, b) for a, b in zip(card_logs(checker), two_phase_logs))
    log(f"  bounded paxos check 3: row log, parents and ebits "
        f"{'equal to' if same else 'DIFFER from'} the two-phase run's")
    if not same:
        raise AssertionError("bounded paxos check 3 logs differ from the two-phase run's")
    phase_single_phase_kernels(
        torch, checker, rows, "paxos3b", PAXOS3B_GEOMETRY, "paxos_step",
        lambda states: paxos_step(states, 3, 3),
        lambda states: paxos_step_plain(states, 3, 3), _codec(3),
        conds=("paxos_conds", lambda states: paxos_conds(states, 3, False),
               lambda states: paxos_conds_plain(states, 3, False)))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    four = bounded_paxos_model(4, 2).checker().spawn_gpu(**PAXOS3B_GEOMETRY).join()
    elapsed = time.monotonic() - t0
    got = (four.unique_state_count(), four.state_count(), four.max_depth())
    log(f"  bounded paxos c=4 max_round=2: unique={got[0]} states={got[1]} "
        f"depth={got[2]} waves={four.waves()} elapsed_s={elapsed:.3f}")
    if got != GOLDEN_PAXOS4B:
        raise AssertionError(f"bounded paxos c=4 {got} != {GOLDEN_PAXOS4B}")
    four.assert_properties()
    card_and_cpu("bounded paxos c=2 max_round=1",
                 bounded_paxos_model(2, 1).checker, GOLDEN_PAXOS2B,
                 state_width(2), capacity=1 << 13, max_frontier=1 << 8
                 ).assert_properties()


def run_raft10s(torch):
    """raft to depth 10 at the default ``dedup_factor``: the sorted path
    under raft's partial identity, at the JAX engine's count."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    checker = raft_model().checker().target_max_depth(10).spawn_gpu(
        **RAFT10S_GEOMETRY).join()
    elapsed = time.monotonic() - t0
    got = (checker.unique_state_count(), checker.state_count(), checker.max_depth())
    if got != GOLDEN_RAFT10S or "sortless=0" not in checker._grow_notes:
        raise AssertionError(f"raft to depth 10 at the default dedup_factor "
                             f"{got} != {GOLDEN_RAFT10S} (growths "
                             f"{checker._grow_notes})")
    if sorted(checker.discoveries()) != RAFT_FOUND:
        raise AssertionError(f"raft to depth 10 found {sorted(checker.discoveries())}")
    return checker, elapsed


def phase_raft_sorted(torch, checker, rows):
    """raft to depth 10 on the sorted path: its kernels against their
    twins on one real wave; raft to depth 7, the shallowest run past the
    fallback, bit-equal to the CPU run."""
    from stateright_tpu_torch.models.raft_compiled import (
        W, raft_step, raft_step_plain,
    )

    crashes = checker._compiled.max_crashes
    phase_single_phase_kernels(
        torch, checker, rows, "raft10s", final_geometry(checker, RAFT10S_GEOMETRY),
        "raft_step", lambda states: raft_step(states, crashes),
        lambda states: raft_step_plain(states, crashes), None)
    gpu = card_and_cpu("raft to depth 7 (sorted path)",
                       lambda: raft_model().checker().target_max_depth(7),
                       GOLDEN_RAFT7S, W, **RAFT10S_GEOMETRY)
    if "sortless=0" not in gpu._grow_notes:
        raise AssertionError(f"raft to depth 7 grew {gpu._grow_notes}")


def run_sym12(torch):
    """``2pc check-sym 12`` through ``spawn_gpu()`` under ``symmetry()``,
    held to the JAX engine's orbit count; ``gpu_profile.py --model sym12``
    times and traces this same run."""
    from stateright_tpu_torch.models.twophase import TwoPhaseSys

    torch.cuda.synchronize()
    t0 = time.monotonic()
    checker = TwoPhaseSys(rm_count=12).checker().symmetry().spawn_gpu(
        **SYM_GEOMETRY).join()
    elapsed = time.monotonic() - t0
    got = (checker.unique_state_count(), checker.state_count(), checker.max_depth())
    if got != GOLDEN_SYM[12] or sorted(checker.discoveries()) != SYM_FOUND:
        raise AssertionError(f"2pc check-sym 12 {got} {sorted(checker.discoveries())}")
    return checker, elapsed


def phase_sym_smaller(torch):
    """rm=5 and rm=10 under symmetry bit-equal to the CPU run; rm=5 at 64
    states a chunk (the orbit count does not depend on the traversal)."""
    from stateright_tpu_torch.models.twophase import TwoPhaseSys

    for rm in (5, 10):
        gpu = card_and_cpu(f"2pc check-sym {rm}",
                           lambda: TwoPhaseSys(rm_count=rm).checker().symmetry(),
                           GOLDEN_SYM[rm], 2, **SYM_GEOMETRY)
        if sorted(gpu.discoveries()) != SYM_FOUND:
            raise AssertionError(f"check-sym {rm} found {sorted(gpu.discoveries())}")
        paths = {k: len(p) - 1 for k, p in gpu.discoveries().items()}
        log(f"  check-sym {rm} discoveries re-executed: {paths}")
    narrow = TwoPhaseSys(rm_count=5).checker().symmetry().spawn_gpu(
        capacity=1 << 20, max_frontier=1 << 6).join()
    log(f"  check-sym 5 at 64 states a chunk: unique={narrow.unique_state_count()} "
        f"waves={narrow.waves()}")
    if narrow.unique_state_count() != GOLDEN_SYM[5][0]:
        raise AssertionError("check-sym 5 depends on the chunk width")


def canon_synthetic_specs():
    from stateright_tpu_torch.parallel.canon import CanonSpec, field as F

    return [
        CanonSpec(3, (F(0, 0, 8), F(1, 0, 2, is_id=True)), (F(2, 0, 4),)),
        CanonSpec(4, (F(1, 0, 32, word_stride=2), F(2, 3, 5, word_stride=2),
                      F(0, 0, 3, is_id=True)), (F(0, 16, 3), F(9, 0, 8))),
        CanonSpec(6, (F(0, 0, 32, word_stride=1), F(6, 0, 32, word_stride=1),
                      F(12, 0, 32, word_stride=1)), ()),
        CanonSpec(16, (F(0, 0, 2), F(1, 0, 2), F(2, 0, 1, bit_stride=2),
                       F(3, 0, 4, word_stride=1, is_id=True)),
                  (F(19, 0, 5), F(19, 27, 5))),
    ]


def phase_canon_kernel(torch):
    """K15 against its twin at size: seeded rm=12 rows at the rm=10
    kernels' scale (F = 2**20 states x A = 62 lanes, words of every bit
    pattern), idempotent; then synthetic specs on fuzzed rows.  Its time
    goes to the log; the kernels line times K15 on the sym12 path's own
    wave (:func:`phase_single_phase_kernels`).  The twin runs in chunks of
    2**22 rows (its int64 temporaries of 65M rows would not fit beside the
    rest)."""
    from stateright_tpu_torch.models.twophase import TwoPhaseSys
    from stateright_tpu_torch.parallel.canon import (
        canonicalize_rows, canonicalize_rows_plain,
    )

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 12)
    spec = TwoPhaseSys(rm_count=12).compiled().canon_spec()
    b = F * (2 + 5 * 12)
    x = torch.randint(-(1 << 31), 1 << 31, (b, 2), generator=gen, device=dev,
                      dtype=torch.int32)
    k = canonicalize_rows(spec, x)
    err = max_abs_err(torch, [
        (k[i : i + (1 << 22)], canonicalize_rows_plain(spec, x[i : i + (1 << 22)]))
        for i in range(0, b, 1 << 22)])
    if err:
        raise AssertionError("K15 disagrees with its twin on the seeded rows")
    if not torch.equal(canonicalize_rows(spec, k), k):
        raise AssertionError("K15 is not idempotent on the seeded rows")
    ms = time_ms(torch, lambda: canonicalize_rows(spec, x), 10)
    nbytes = 2 * b * 2 * 4
    moved = int((k != x).any(dim=1).sum())
    log(f"  canonicalize_rows [seeded, not on the path]: {b} rm=12 rows, "
        f"{moved} of them permuted, bit-equal to the twin and idempotent; "
        f"kernel_ms={ms:.4f} bound_ms={nbytes / HBM_BYTES_PER_SEC * 1e3:.4f} "
        f"(bytes={nbytes})")
    del x, k
    rng_gen = torch.Generator(device=dev)
    rng_gen.manual_seed(SEED + 13)
    for sp in canon_synthetic_specs():
        w = 1 + max([f.word + (sp.n - 1) * f.word_stride for f in sp.fields]
                    + [g.word for g in sp.id_fields])
        for low, high in ((-(1 << 31), 1 << 31), (0, 20)):
            r = torch.randint(low, high, (1 << 20, w), generator=rng_gen,
                              device=dev, dtype=torch.int32)
            got = canonicalize_rows(sp, r)
            if not (torch.equal(got, canonicalize_rows_plain(sp, r))
                    and torch.equal(canonicalize_rows(sp, got), got)):
                raise AssertionError(f"K15 disagrees with its twin on {sp}")
    torch.cuda.synchronize()
    log(f"  canonicalize_rows: {len(canon_synthetic_specs())} synthetic specs "
        "bit-equal to the twin and idempotent on 2**20 fuzzed rows each")


def phase_sym12_kernels(torch, checker, rows):
    """The sym12 path's kernels against their twins on one real wave
    (:func:`phase_single_phase_kernels`; K15 on its candidate rows, K1 on
    the K15 rows)."""
    from stateright_tpu_torch.models.twophase_compiled import (
        twophase_step, twophase_step_plain,
    )

    phase_single_phase_kernels(
        torch, checker, rows, "sym12", final_geometry(checker, SYM_GEOMETRY),
        "twophase_step", lambda states: twophase_step(states, 12),
        lambda states: twophase_step_plain(states, 12), None)


def lww_model(n):
    from stateright_tpu_torch.models.lww_register import build_model

    return build_model(n)


def run_lww(torch, n=2, depth=7, golden=GOLDEN_LWW2D7):
    """LWW with ``n`` nodes to ``depth`` through ``spawn_gpu()`` at the
    default ``dedup_factor``, held to ``golden`` with no discovery;
    ``gpu_profile.py --model lww2d7`` times and traces the default."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    checker = lww_model(n).checker().target_max_depth(depth).spawn_gpu(
        **LWW_GEOMETRY).join()
    elapsed = time.monotonic() - t0
    got = (checker.unique_state_count(), checker.state_count(), checker.max_depth())
    if got != golden or checker.discoveries():
        raise AssertionError(f"lww {n} nodes depth {depth}: {got}, found "
                             f"{sorted(checker.discoveries())}")
    return checker, elapsed


def phase_lww(torch, checker, rows):
    """3 nodes to depth 5; 2 nodes to depth 6 against the CPU run; the
    overflow at depth 8; then the depth-7 path's kernels against their
    twins on one real wave."""
    from stateright_tpu_torch.models.lww_compiled import (
        NET_SLOTS, lww_step, lww_step_plain,
    )

    three, elapsed = run_lww(torch, 3, 5, GOLDEN_LWW3D5)
    log(f"  lww 3 nodes depth 5: unique={three.unique_state_count()} "
        f"states={three.state_count()} waves={three.waves()} growths "
        f"{three._grow_notes} elapsed_s={elapsed:.3f}")
    card_and_cpu("lww 2 nodes depth 6",
                 lambda: lww_model(2).checker().target_max_depth(6),
                 GOLDEN_LWW2D6, 2 + NET_SLOTS, **LWW_GEOMETRY)
    try:
        lww_model(2).checker().target_max_depth(8).spawn_gpu(**LWW_GEOMETRY).join()
    except RuntimeError as e:
        if "encoding-capacity overflow" not in str(e):
            raise
        log(f"  lww 2 nodes depth 8 stops as the JAX engine does: {e}")
    else:
        raise AssertionError("lww 2 nodes depth 8 did not flag the codec's overflow")

    def reorder(out):  # (nexts, valid, flags, conds) -> conds before flags
        return out[0], out[1], out[3], out[2]

    phase_single_phase_kernels(
        torch, checker, rows, "lww", final_geometry(checker, LWW_GEOMETRY),
        "lww_step", lambda states: reorder(lww_step(states, 2)),
        lambda states: reorder(lww_step_plain(states, 2)), None)


def run_trap(torch, trap_at=2, symmetric=False):
    from stateright_tpu_torch.models.fixtures import TrapCounter

    torch.cuda.synchronize()
    t0 = time.monotonic()
    builder = TrapCounter(trap_at=trap_at).checker()
    if symmetric:
        builder = builder.symmetry_fn(lambda s: s)
    checker = builder.spawn_gpu(**TRAP_GEOMETRY).join()
    return checker, time.monotonic() - t0


def phase_trap(torch, checker, rows):
    """The trap counter's discoveries, its run without the trap and under
    the identity canonicalization, and its kernels against their twins."""
    from stateright_tpu_torch.models.fixtures import trap_step, trap_step_plain

    found = sorted(checker.discoveries())
    last = checker.discoveries()["reaches limit"].last_state() if found else None
    log(f"  trap: found {found}, reaches limit's path ends in {last}")
    if found != ["reaches limit", "trapped"] or last != 6:
        raise AssertionError("trap counter: wrong discoveries")
    free, _ = run_trap(torch, trap_at=10**6)
    if free.discoveries():
        raise AssertionError(f"trap counter without the trap found {sorted(free.discoveries())}")
    sym, _ = run_trap(torch, symmetric=True)
    same = ((sym.unique_state_count(), sym.state_count(), sorted(sym.discoveries()))
            == (checker.unique_state_count(), checker.state_count(), found))
    log(f"  trap under the identity canonicalization: "
        f"{'the plain run' if same else 'DIFFERS from the plain run'}")
    if not same:
        raise AssertionError("trap counter: symmetry_fn(identity) changed the run")
    phase_single_phase_kernels(
        torch, checker, rows, "trap", final_geometry(checker, TRAP_GEOMETRY),
        "trap_step", lambda states: trap_step(states, 5, 2, 6),
        lambda states: trap_step_plain(states, 5, 2, 6), None)


# --- the device walk and the chaos ensemble ------------------------------------


def run_sim_rm10(torch):
    """``2pc`` rm=10 through ``spawn_gpu_simulation()``: one round of 4,096
    walkers at T = 64, seed 3, held to the JAX engine's round."""
    from stateright_tpu_torch.models.twophase import TwoPhaseSys

    torch.cuda.synchronize()
    t0 = time.monotonic()
    checker = TwoPhaseSys(rm_count=RM).checker().target_state_count(1) \
        .spawn_gpu_simulation(seed=3, walkers=SIM_WALKERS, max_trace_len=64).join()
    elapsed = time.monotonic() - t0
    check_sim("sim-rm10", checker, GOLDEN_SIM_RM10)
    return checker, elapsed


def run_sim_raft(torch):
    """The reference's raft at ``target_max_depth(12)`` through
    ``spawn_gpu_simulation()``: one round of 4,096 walkers, seed 3."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    checker = raft_model().checker().target_max_depth(12).target_state_count(1) \
        .spawn_gpu_simulation(seed=3, walkers=SIM_WALKERS).join()
    elapsed = time.monotonic() - t0
    check_sim("sim-raft", checker, GOLDEN_SIM_RAFT)
    return checker, elapsed


def run_sim_raft_wide(torch):
    """Raft at depth 12, 2**16 walkers a round until 10M states: no State
    Machine Safety discovery (none exists within depth 12), and every
    discovery's path re-executed on the host to where it is found."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    checker = raft_model().checker().target_max_depth(12) \
        .target_state_count(SIM_RAFT_TARGET) \
        .spawn_gpu_simulation(seed=3, walkers=SIM_RAFT_WIDE).join()
    elapsed = time.monotonic() - t0
    found = sorted(checker.discoveries())
    if checker.state_count() < SIM_RAFT_TARGET or RAFT_NEVER in found:
        raise AssertionError(f"raft walk: {checker.state_count()} states, found {found}")
    check_paths("sim-raft 10M", checker.model(), checker.discoveries())
    return checker, elapsed


def run_ens(torch, members=GOLDEN_ENS["members"]):
    """The ABD ``skip_ack`` ensemble (``tests/test_ensemble.py``'s sweep)
    through ``run_ensemble(replay=False)``."""
    from stateright_tpu_torch.ensemble import run_ensemble

    torch.cuda.synchronize()
    t0 = time.monotonic()
    result = run_ensemble(members=members, **ENS_ARGS)
    return result, time.monotonic() - t0


def check_sim(path, checker, golden):
    """A simulation round held to its JAX golden; its discovery paths
    re-executed on the host model."""
    states, depth, found = golden
    got = (checker.state_count(), checker.max_depth(), sorted(checker.discoveries()))
    if got != (states, depth, found):
        raise AssertionError(f"{path}: {got} != {golden}")
    check_paths(path, checker.model(), checker.discoveries())


def check_paths(what, model, discoveries):
    """Each discovery's path (already re-executed on the host model by
    ``Path.from_fingerprints``) ends where its property is discovered: a
    SOMETIMES condition holding, an ALWAYS one failing."""
    for name, path_ in discoveries.items():
        prop = model.get_property(name)
        holds = prop.condition(model, path_.last_state())
        if prop.expectation.name != "EVENTUALLY" and holds != (
                prop.expectation.name == "SOMETIMES"):
            raise AssertionError(f"{what}: {name}'s path does not end in its discovery")
    log(f"  {what}: {len(discoveries)} discovery paths re-executed on the host: "
        f"{', '.join(f'{k} ({len(v) - 1} steps)' for k, v in discoveries.items())}")


def run_walk_path(torch, gpu, path, run):
    """One run of a walk path with its launch counts read around it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    obj, elapsed = run(torch)
    launches = read_launches(path)
    walked = getattr(obj, "states_walked", None)
    walked = obj.state_count() if walked is None else walked
    log(f"  {path}: states walked={walked} elapsed_s={elapsed:.3f} "
        f"states_per_s={walked / elapsed:.1f} "
        f"peak_bytes={torch.cuda.max_memory_allocated()} card={gpu!r}")
    log(f"  {path} launches: {launches}")
    return launches, obj


def same_batch(torch, what, got, want):
    """A card walk's batch against its twins' batch, every output."""
    names = ("trace", "disc", "counted", "appended", "flag")
    bad = [n for n, g, w in zip(names, got, want) if not torch.equal(g, w)]
    if bad:
        raise AssertionError(f"{what}: {bad} differ between the kernels and the twins")


def batch_vs_twins(torch, what, walk, plain, keys, params=None):
    """The whole batch through the kernels and through the twins on the
    card, bit-equal; returns the kernels' outputs and both times."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    got = walk(keys, params)
    torch.cuda.synchronize()
    t1 = time.monotonic()
    want = plain(keys, params)
    torch.cuda.synchronize()
    t2 = time.monotonic()
    same_batch(torch, what, got, want)
    walked = int(got[2].sum())
    log(f"  {what}: {keys.shape[0]} walkers, {walked} states, "
        f"{walk.steps_run} steps, bit-equal to the twins' batch; kernels "
        f"{t1 - t0:.3f} s ({walked / (t1 - t0):.1f} states/s), twins {t2 - t1:.3f} s")
    return got


def walk_rows(torch, rows, path, walk, keys, t_at, params=None, codec=None,
              model_kernel=None):
    """The walk path's kernels against their twins on one real step
    (step ``t_at`` of ``keys``' walk), timed there: K18's keys, init, step
    and finish entries, K1 on the walkers' identity, the model's step
    (``model_kernel``) and, with ``params``, K19.  Bounds count the bytes
    this step's data moves and the Threefry hashes it draws (one a key
    for ``fold_in``, six a walker's draw)."""
    from stateright_tpu_torch.ensemble.fate import fate_mask, fate_mask_plain
    from stateright_tpu_torch.models.register_compiled_common import dp_work
    from stateright_tpu_torch.ops.device_fp import device_fp64, device_fp64_plain
    from stateright_tpu_torch.ops.u32 import u32
    from stateright_tpu_torch.parallel import simulation_gpu as sg

    row = kernel_row(rows, path)
    cm, props = walk.cm, walk.props
    b, w, a, n_p = keys.shape[0], cm.state_width, cm.max_actions, props.count
    base = torch.zeros((1, 2), dtype=torch.int32)
    k_keys = sg.walker_keys(base, 0, b, keys.device)
    p_keys = sg.walker_keys_plain(base, 0, b, keys.device)
    torch.cuda.synchronize()
    row("walker_keys", max_abs_err(torch, [(k_keys, p_keys)]),
        time_ms(torch, lambda: sg.walker_keys(base, 0, b, keys.device), 10),
        time_ms(torch, lambda: sg.walker_keys_plain(base, 0, b, keys.device), 2),
        8 * b, ops=b * THREEFRY_OPS)

    init = sg.from_numpy_u32(walk.init, keys.device)
    lanes = None if walk.hook is None else walk.hook.n_lanes
    fresh = sg.WalkCarry.empty(keys, walk.t_max, w, props, lanes)
    work = sg.WalkCarry.empty(keys, walk.t_max, w, props, lanes)

    def restore(src, dst):
        for f in fields(dst):
            x = getattr(dst, f.name)
            if x is not None:
                x.copy_(getattr(src, f.name))

    def carries_err(c1, c2):
        return max_abs_err(torch, [(getattr(c1, f.name), getattr(c2, f.name))
                                   for f in fields(c1) if getattr(c1, f.name) is not None])

    twin = sg.WalkCarry.empty(keys, walk.t_max, w, props, lanes)
    sg.walk_init(work, init)
    sg.walk_init_plain(twin, init)
    torch.cuda.synchronize()
    row("walk_init", carries_err(work, twin),
        time_ms(torch, lambda: sg.walk_init(work, init), 10,
                setup=lambda: restore(fresh, work)),
        time_ms(torch, lambda: sg.walk_init_plain(work, init), 2,
                setup=lambda: restore(fresh, work)),
        b * (16 + 4 * w), ops=b * DRAW_HASHES * THREEFRY_OPS)

    c = walk.start(keys)
    for t in range(t_at):
        sg.walk_step(c, t, props, **walk.step_inputs(c, t, params))
    inp = walk.step_inputs(c, t_at, params)
    torch.cuda.synchronize()
    active = int((~c.done).sum())
    state = c.state
    ident = state[:, : walk.fp_words]
    fpw = ident.shape[1]
    k1, p1 = device_fp64(ident), device_fp64_plain(ident)
    torch.cuda.synchronize()
    row("device_fp64", max_abs_err(torch, zip(k1, p1)),
        time_ms(torch, lambda: device_fp64(ident), 10),
        time_ms(torch, lambda: device_fp64_plain(ident), 2), b * (fpw * 4 + 8))

    name = model_kernel
    k_m = cm.walk_step(state)
    p_m = cm.walk_step(state, plain=True)
    torch.cuda.synchronize()
    ops = 0 if codec is None else int(dp_work(codec, u32(state)).sum())
    row(name, max_abs_err(torch, [(x, y) for x, y in zip(k_m, p_m) if x is not None]),
        time_ms(torch, lambda: cm.walk_step(state), 10),
        time_ms(torch, lambda: cm.walk_step(state, plain=True), 2),
        b * w * 4 + b * a * (w * 4 + 1) + b * n_p + (b if k_m[3] is not None else 0),
        ops=ops)
    del p_m

    if params is not None:
        ctr = c.ctr
        k19 = fate_mask(t_at, ctr, params)
        p19 = fate_mask_plain(t_at, ctr, params)
        torch.cuda.synchronize()
        # Each lane: its counter, two seed words, two thresholds, two flags,
        # two group ids in, a byte out; each member's three words in.  Two
        # splitmix finalizers of about 20 operations a lane.
        row("fate_mask", max_abs_err(torch, [(k19, p19)]),
            time_ms(torch, lambda: fate_mask(t_at, ctr, params), 10),
            time_ms(torch, lambda: fate_mask_plain(t_at, ctr, params), 2),
            b * a * (4 + 8 + 8 + 2 + 8 + 1) + b * 12, ops=b * a * 40)
        log(f"  fate_mask: {int(k19.sum())} of {b * a} lanes blocked at step {t_at}")

    snap = sg.WalkCarry.empty(keys, walk.t_max, w, props, lanes)
    restore(c, snap)
    restore(snap, twin)
    sg.walk_step(c, t_at, props, **inp)
    sg.walk_step_plain(twin, t_at, props, **inp)
    torch.cuda.synchronize()
    # Bytes this step's data moves: per walker its fingerprint, done,
    # appended, key (read and written) and flags; per counted walker its
    # valid and cond bytes, counters, a trace row and history entry
    # written, its row read; per advancing walker a successor read and
    # its row written; the history entries each active walker scanned.
    app = snap.appended.long()
    appended = int((c.appended.long() - app).sum())
    counted = int((c.counted.long() - snap.counted.long()).sum())
    advanced = int((c.state != snap.state).any(dim=1).sum())
    scanned = int(app[~snap.done].sum())
    lane_bytes = a * (1 + (9 if params is not None else 0))
    nbytes = (b * (8 + 1 + 4 + 16 + 1) + appended * (4 * w * 2 + 8)
              + counted * (lane_bytes + n_p + 12) + advanced * 8 * w
              + scanned * 8)
    row("walk_step", carries_err(c, twin),
        time_ms(torch, lambda: sg.walk_step(work, t_at, props, **inp), 10,
                setup=lambda: restore(snap, work)),
        time_ms(torch, lambda: sg.walk_step_plain(work, t_at, props, **inp), 2,
                setup=lambda: restore(snap, work)),
        nbytes, ops=b * DRAW_HASHES * THREEFRY_OPS)
    log(f"  walk_step at step {t_at}: {active} of {b} walkers active, "
        f"{counted} counted, {advanced} advanced, {scanned} history entries "
        f"scanned")

    restore(c, snap)
    restore(c, twin)
    sg.walk_finish(c, props)
    sg.walk_finish_plain(twin, props)
    torch.cuda.synchronize()
    row("walk_finish", carries_err(c, twin),
        time_ms(torch, lambda: sg.walk_finish(work, props), 10,
                setup=lambda: restore(snap, work)),
        time_ms(torch, lambda: sg.walk_finish_plain(work, props), 2,
                setup=lambda: restore(snap, work)),
        b * (1 + 4 + 4) + b * n_p * 4)


def phase_sim_rm10(torch, rows):
    """The 2**18-walker rm=10 round against its twins' batch, and the
    path's kernels on one real step."""
    from stateright_tpu_torch.models.twophase import TwoPhaseSys
    from stateright_tpu_torch.ops import prng
    from stateright_tpu_torch.parallel.simulation_gpu import build_walk, walker_keys

    model = TwoPhaseSys(rm_count=RM)
    cm = model.compiled()
    keys = walker_keys(prng.fold_in(prng.prng_key(3), 0), 0, SIM_RM10_WIDE, "cuda")
    walk = build_walk(cm, model.properties(), 64)
    out = batch_vs_twins(torch, "sim-rm10 2**18", walk,
                         build_walk(cm, model.properties(), 64, plain=True), keys)
    if int(out[4].sum()):
        raise AssertionError("sim-rm10: a 2pc step flagged")
    walk_rows(torch, rows, "sim-rm10", walk, keys, 8, model_kernel="twophase_step")


def phase_sim_raft(torch, rows):
    """The 2**16-walker raft round against its twins' batch, and the
    path's kernels on one real step."""
    import numpy as np

    from stateright_tpu_torch.core.path import Path
    from stateright_tpu_torch.ops import prng
    from stateright_tpu_torch.ops.u32 import to_numpy_u32
    from stateright_tpu_torch.parallel.simulation_gpu import NO_STEP, build_walk, walker_keys

    model = raft_model()
    cm = model.compiled()
    keys = walker_keys(prng.fold_in(prng.prng_key(3), 0), 0, SIM_RAFT_WIDE, "cuda")
    walk = build_walk(cm, model.properties(), 12)
    out = batch_vs_twins(torch, "sim-raft 2**16", walk,
                         build_walk(cm, model.properties(), 12, plain=True), keys)
    disc = to_numpy_u32(out[1])
    found = {}
    for i, prop in enumerate(model.properties()):
        hits = np.flatnonzero(disc[:, i] != NO_STEP)
        if len(hits):  # the first hitting walker's trace, on the host
            wkr, end = int(hits[0]), int(disc[hits[0], i]) + 1
            rows_np = to_numpy_u32(out[0][wkr, :end])
            found[prop.name] = Path.from_fingerprints(
                model, [model.fingerprint(cm.decode(r)) for r in rows_np])
    if RAFT_NEVER in found or int(out[4].sum()):
        raise AssertionError(f"sim-raft 2**16: found {sorted(found)}, "
                             f"flags {int(out[4].sum())}")
    check_paths("sim-raft 2**16", model, found)
    walk_rows(torch, rows, "sim-raft", walk, keys, 6, model_kernel="raft_step")


def phase_ens(torch, rows, result):
    """The ensemble's golden, its repro member's trace re-executed on the
    host, the 2**16-member sweep against its twins' batch, and the path's
    kernels on one real step."""
    from stateright_tpu_torch.core.path import Path
    from stateright_tpu_torch.ensemble.engine import (
        FateLaneHook, _abd_model, _member_params, params_on,
    )
    from stateright_tpu_torch.ensemble.schedule import derive_schedule
    from stateright_tpu_torch.models.abd_compiled import AbdCompiled, _codec
    from stateright_tpu_torch.ops import prng
    from stateright_tpu_torch.ops.u32 import to_numpy_u32
    from stateright_tpu_torch.parallel.simulation_gpu import build_walk, walker_keys
    from stateright_tpu_torch.runtime.chaos import ChaosSpec

    g = GOLDEN_ENS
    got = dict(members=result.members, states_walked=result.states_walked,
               failing=len(result.failing), shrink_steps=result.shrink_steps,
               repro_member=result.repro["member"], repro_steps=result.repro["steps"])
    log(f"  ens-abd 1,024: {got}, elapsed_s={result.elapsed_sec:.4f}")
    if got != g:
        raise AssertionError(f"ens-abd: {got} != {g}")

    model = _abd_model(2, ENS_ARGS["fault"])
    cm = AbdCompiled(model)
    spec = ChaosSpec.from_json(ENS_ARGS["chaos"])
    steps = ENS_ARGS["steps"]
    hook = FateLaneHook(len(cm.pairs))
    walk = build_walk(cm, model.properties(), steps, fault_hook=hook)
    base = prng.prng_key(ENS_ARGS["seed"])

    # The repro member's walk, re-executed on the host model: its trace up
    # to the latch is a path of the model that ends non-linearizable.
    member = g["repro_member"]
    first = next(f for f in result.failing if f["member"] == member)
    sch = derive_schedule(ENS_ARGS["seed"], member, spec, steps)
    trace, _d, _c, _a, _f = walk(walker_keys(base, member, 1, "cuda"),
                                 params_on(_member_params(cm.pairs, [sch]), "cuda"))
    rows_np = to_numpy_u32(trace[0, : first["step"] + 1])
    path = Path.from_fingerprints(model, [model.fingerprint(cm.decode(r)) for r in rows_np])
    lin = model.get_property("linearizable")
    if lin.condition(model, path.last_state()):
        raise AssertionError("ens-abd: the repro member's path ends linearizable")
    log(f"  ens-abd repro member {member}: a {len(path) - 1}-step path re-executed "
        "on the host, ending non-linearizable")

    scheds = [derive_schedule(ENS_ARGS["seed"], m, spec, steps) for m in range(ENS_WIDE)]
    params = params_on(_member_params(cm.pairs, scheds), "cuda")
    keys = walker_keys(base, 0, ENS_WIDE, "cuda")
    out = batch_vs_twins(torch, "ens-abd 2**16", walk,
                         build_walk(cm, model.properties(), steps, fault_hook=hook,
                                    plain=True), keys, params)
    failing = int((to_numpy_u32(out[1])[:, 0] != 0xFFFFFFFF).sum())
    log(f"  ens-abd 2**16: {failing} failing members")
    walk_rows(torch, rows, "ens-abd", walk, keys, 4, params=params,
              codec=_codec(2, True), model_kernel="abd_step")


# --- the tiered checker -------------------------------------------------------


def run_tiered_paxos3(torch, journal=None, **kw):
    """``paxos check 3`` through ``spawn_gpu_tiered()`` at
    ``TIERED_PAXOS3_ARGS``, held to its golden; returns the joined checker
    and its wall seconds.  ``gpu_profile.py --model tiered-paxos3`` times
    and traces this same run."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    checker = paxos_model(3).checker().spawn_gpu_tiered(
        journal=journal, **TIERED_PAXOS3_ARGS, **kw).join()
    elapsed = time.monotonic() - t0
    got = (checker.unique_state_count(), checker.max_depth())
    if got != GOLDEN_PAXOS3:
        raise AssertionError(f"tiered paxos check 3 {got} != {GOLDEN_PAXOS3}")
    return checker, elapsed


def run_tiered_raft(torch, journal=None):
    """``raft check`` through ``spawn_gpu_tiered()`` at
    ``TIERED_RAFT_ARGS``, held to the JAX engine's count and discovery
    set; ``gpu_profile.py --model tiered-raft`` times this same run."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    checker = raft_model().checker().target_max_depth(12).spawn_gpu_tiered(
        journal=journal, **TIERED_RAFT_ARGS).join()
    elapsed = time.monotonic() - t0
    got = (checker.unique_state_count(), checker.state_count(), checker.max_depth())
    if got != GOLDEN_RAFT:
        raise AssertionError(f"tiered raft check {got} != {GOLDEN_RAFT}")
    if sorted(checker.discoveries()) != RAFT_FOUND:
        raise AssertionError(f"tiered raft check found {sorted(checker.discoveries())}")
    return checker, elapsed


class ColdWaveCapture:
    """While entered, keeps the inputs and the result of the tiered runs'
    cold filter on its largest wave (the most hot-new keys times cold
    entries; the last such): the wave's key buffer, origin and new mask
    before the probes, the query's minimum and maximum, the cold runs, and
    the fresh mask and count the run went on with."""

    def __enter__(self):
        from stateright_tpu_torch.tiered.engine import TieredGpuChecker

        self.wave = None
        best = [-1]
        orig = self._orig = TieredGpuChecker._cold_filter
        cap = self

        def capturing(eng, wave):
            score = wave.n_new * eng._cold.entries
            take = score >= best[0]
            if take:
                saved = dict(
                    hi=wave.hi.clone(), lo=wave.lo.clone(),
                    origin=None if wave.u_origin is None else wave.u_origin.clone(),
                    is_new=wave.is_new.clone(), minmax=wave.extra[:2],
                    runs=eng._cold.runs, chunk=eng._cold_chunk,
                    cold_entries=eng._cold.entries,
                )
            acct = orig(eng, wave)
            if take:
                saved.update(fresh=wave.is_new.clone(), n_fresh=wave.n_new,
                             acct=acct)
                best[0] = score
                cap.wave = saved
            return acct

        TieredGpuChecker._cold_filter = capturing
        return self

    def __exit__(self, *exc):
        from stateright_tpu_torch.tiered.engine import TieredGpuChecker

        TieredGpuChecker._cold_filter = self._orig
        return False


def cold_chunks(torch, wave):
    """The padded chunks of the captured wave's cold windows, on the card,
    in the engine's pass order."""
    import numpy as np

    from stateright_tpu_torch.tiered.cold_join import cold_windows, load_chunk

    lo_key, hi_key = (x & ((1 << 64) - 1) for x in wave["minmax"])
    chunk = wave["chunk"]
    out = []
    for run, a, b in cold_windows(wave["runs"], lo_key, hi_key):
        for off in range(a, b, chunk):
            buf = torch.empty((chunk,), dtype=torch.int64, device="cuda")
            load_chunk(buf, np.asarray(run[off:off + chunk]))
            out.append(buf)
    return out


def phase_cold_kernels(torch, rows, path, cap):
    """K20's two entries against their twins on the captured real cold
    wave of ``path``'s run: the query's minimum and maximum as the run read
    them, every probe pass bit-equal and leaving the fresh mask the run
    went on with; the query and the first pass timed (twins, and
    ``torch.searchsorted`` alone as the library call)."""
    from stateright_tpu_torch.ops.device_fp import fp64_of
    from stateright_tpu_torch.tiered.cold_join import (
        _SIGN, cold_probe, cold_probe_plain, cold_query, cold_query_plain,
    )

    wave = cap.wave
    if wave is None:
        raise AssertionError(f"{path}: no cold wave was captured")
    row = kernel_row(rows, path)
    hi, lo, origin, is_new0 = wave["hi"], wave["lo"], wave["origin"], wave["is_new"]
    n = is_new0.shape[0]
    n_new = int(is_new0.sum())
    key_bytes = 8 + (0 if origin is None else 4)

    kq = cold_query(hi, lo, origin, is_new0)
    pq = cold_query_plain(hi, lo, origin, is_new0)
    torch.cuda.synchronize()
    ran = torch.tensor(list(wave["minmax"]), dtype=torch.int64, device="cuda")
    row("cold_query", max_abs_err(torch, [(kq, pq), (kq, ran)]),
        time_ms(torch, lambda: cold_query(hi, lo, origin, is_new0), 10),
        time_ms(torch, lambda: cold_query_plain(hi, lo, origin, is_new0), 2),
        n + n_new * key_bytes + 16)

    chunks = cold_chunks(torch, wave)
    if len(chunks) != wave["acct"]["passes"]:
        raise AssertionError(f"{path}: {len(chunks)} chunks replayed, the run "
                             f"made {wave['acct']['passes']} passes")
    k = is_new0.clone()
    p = is_new0.clone()
    for ch in chunks:
        cold_probe(hi, lo, origin, k, ch)
        cold_probe_plain(hi, lo, origin, p, ch)
    torch.cuda.synchronize()
    err = max_abs_err(torch, [(k, p), (k, wave["fresh"])])
    if int(k.sum()) != wave["n_fresh"]:
        err += 1
    c = chunks[0].shape[0]
    first = is_new0.clone()
    cold_probe_plain(hi, lo, origin, first, chunks[0])
    # The timed first pass writes one byte a hit, not the whole mask.
    first_hits = n_new - int(first.sum())

    def fresh():
        first.copy_(is_new0)

    o = torch.arange(n, device="cuda") if origin is None else origin.long()
    flipped_q = fp64_of(hi[o], lo[o])[is_new0] ^ _SIGN
    flipped_c = chunks[0] ^ _SIGN
    # The tiered loop probes each chunk once, right after loading it: time
    # the probe turning through the wave's chunks (past the 50 MB L2 on
    # tiered-raft's 16 of 8 MB) beside the same chunk again and again.
    turns = itertools.cycle(chunks)
    rotating_ms = time_ms(
        torch, lambda: cold_probe(hi, lo, origin, first, next(turns)),
        max(10, len(chunks)), setup=fresh)
    row("cold_probe", err,
        time_ms(torch, lambda: cold_probe(hi, lo, origin, first, chunks[0]), 10,
                setup=fresh),
        time_ms(torch, lambda: cold_probe_plain(hi, lo, origin, first, chunks[0]),
                2, setup=fresh),
        n + n_new * key_bytes + first_hits + 8 * c,
        library_ms=time_ms(torch, lambda: torch.searchsorted(flipped_c, flipped_q), 10),
        ops=n_new * COLD_STEP_OPS * (c.bit_length() - 1),
        rotating_ms=rotating_ms)
    log(f"  {path} cold wave: {n} buffer lanes, {n_new} hot-new, "
        f"{wave['n_fresh']} fresh, {first_hits} hits in the first pass, "
        f"{len(chunks)} passes of {c} keys over "
        f"{len(wave['runs'])} runs ({wave['cold_entries']} cold entries), "
        f"accounting {wave['acct']}")


def journal_events(path, kinds, drop=("t",)):
    from stateright_tpu_torch.runtime.journal import read_journal

    return [{k: v for k, v in e.items() if k not in drop}
            for e in read_journal(path) if e["event"] in kinds]


def tiered_summary(what, checker, events):
    spills = [e for e in events if e["event"] == "spill"]
    probes = [e for e in events if e["event"] == "cold_probe"]
    m = checker.metrics()
    log(f"  {what}: capacity={m['capacity']} spills={m.get('spills', 0)} "
        f"cold_runs={m['cold_runs']} cold_entries={m['cold_entries']} "
        f"probe passes={m.get('cold_probe_passes_total', 0)} "
        f"probe bytes={m.get('cold_probe_bytes_total', 0)} "
        f"cold hits={m.get('cold_hits_total', 0)} "
        f"cold filter host s={m.get('cold_probe_sec_total', 0.0):.3f} "
        f"max_frontier={m['max_frontier']} growths={checker._grow_notes[:4]}...")
    if len(spills) != m.get("spills", 0) or not probes:
        raise AssertionError(f"{what}: {len(spills)} spill and {len(probes)} "
                             "cold_probe events journaled")
    if not sum(e["hits"] for e in probes):
        raise AssertionError(f"{what}: the cold tier answered no duplicate")
    return m


def phase_tiered_paxos3(torch, gpu, rows, want_logs, want_fps):
    """Tiered ``paxos check 3`` under a 2 MB budget: the golden, its row
    log, parents and ebits and its fingerprints equal to phase 6's in-HBM
    run, spills and cold probes journaled, K20 launched and held against
    its twins on the run's largest cold wave."""
    with tempfile.TemporaryDirectory() as tmp, ColdWaveCapture() as cap:
        journal = os.path.join(tmp, "tiered.jsonl")
        launches, checker = run_full(
            torch, gpu, "tiered-paxos3",
            lambda t: run_tiered_paxos3(t, journal=journal))
        events = journal_events(journal, ("spill", "cold_probe"))
    m = tiered_summary("tiered paxos check 3", checker, events)
    if m["spills"] < 4:
        raise AssertionError(f"tiered paxos check 3 spilled {m['spills']} times")
    got = card_logs(checker)
    if not all(torch.equal(a, b) for a, b in zip(got, want_logs)):
        raise AssertionError("tiered paxos check 3: logs differ from the in-HBM run's")
    if not (checker.discovered_fingerprints() == want_fps).all():
        raise AssertionError("tiered paxos check 3: fingerprints differ")
    log("  tiered paxos check 3: row log, parents, ebits and fingerprints "
        "equal to the in-HBM run's")
    phase_cold_kernels(torch, rows, "tiered-paxos3", cap)
    return launches


def phase_tiered_checkpoint(torch, want, want_fps):
    """A mid-run checkpoint of tiered ``paxos check 3``, written by the
    ``checkpoint_every_waves`` cadence once the cold tier holds two runs
    (the run is stopped there), resumed by a fresh ``spawn_gpu_tiered``
    to the in-HBM run's counts ``want`` and fingerprints."""
    import shutil

    from stateright_tpu_torch.tiered.engine import TieredGpuChecker

    orig = TieredGpuChecker._wl_write_checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck.npz")
        mid = os.path.join(tmp, "mid.npz")
        journal = os.path.join(tmp, "ck.jsonl")

        def keep_mid(eng):
            extra = orig(eng)
            if eng._cold.run_count >= 2 and not os.path.exists(mid):
                shutil.copy(eng._checkpoint_path, mid)
                eng.request_stop()
            return extra

        TieredGpuChecker._wl_write_checkpoint = keep_mid
        try:
            cut = paxos_model(3).checker().spawn_gpu_tiered(
                checkpoint_path=ck, checkpoint_every_waves=4, journal=journal,
                **TIERED_PAXOS3_ARGS).join()
        finally:
            TieredGpuChecker._wl_write_checkpoint = orig
        cks = journal_events(journal, ("checkpoint",))
        if not os.path.exists(mid) or not any(not e.get("final") for e in cks):
            raise AssertionError("no mid-run tiered checkpoint was written")
        t0 = time.monotonic()
        resumed = paxos_model(3).checker().spawn_gpu_tiered(
            resume_from=mid, **TIERED_PAXOS3_ARGS).join()
        elapsed = time.monotonic() - t0
    got = (resumed.unique_state_count(), resumed.state_count(), resumed.max_depth())
    log(f"  checkpoint at unique={cut.unique_state_count()} "
        f"cold_runs={cut.metrics()['cold_runs']} ({len(cks)} checkpoint "
        f"events); resumed to unique={got[0]} states={got[1]} depth={got[2]} "
        f"in {elapsed:.3f}s")
    if got != want or not (resumed.discovered_fingerprints() == want_fps).all():
        raise AssertionError(f"resumed tiered paxos check 3 {got} != {want} "
                             "or its fingerprints differ")


def phase_tiered_rm5(torch):
    """``2pc check 5`` tiered at 512 slots and 64 states a chunk on the card
    and on the CPU: the golden, and logs, the journal's ``spill`` and
    ``cold_probe`` events (without their times) and the snapshot's cold
    arrays bit-equal."""
    import numpy as np

    from stateright_tpu_torch.models.twophase import TwoPhaseSys

    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for dev in ("cuda", "cpu"):
            journal = os.path.join(tmp, f"{dev}.jsonl")
            c = TwoPhaseSys(rm_count=5).checker().spawn_gpu_tiered(
                device=dev, journal=journal, **TIERED_RM5_ARGS).join()
            path = os.path.join(tmp, f"{dev}.npz")
            c.save_snapshot(path)
            with np.load(path) as snap:
                cold = {k: snap[k].copy() for k in snap.files
                        if k.startswith("tiered_")}
            runs[dev] = (c, journal_events(journal, ("spill", "cold_probe"),
                                           drop=("t", "spill_sec")), cold)
        (gpu, g_ev, g_cold), (cpu, c_ev, c_cold) = runs["cuda"], runs["cpu"]
        got = (gpu.unique_state_count(), gpu.state_count(), gpu.max_depth())
        if got != GOLDEN_RM5:
            raise AssertionError(f"tiered rm=5 {got} != {GOLDEN_RM5}")
        assert_same_as_cpu(gpu, cpu, "tiered rm=5", 2)
    if g_ev != c_ev or not g_ev:
        raise AssertionError("tiered rm=5: spill/cold_probe events differ "
                             "between card and CPU")
    if sorted(g_cold) != sorted(c_cold) or not all(
        np.array_equal(g_cold[k], c_cold[k]) for k in g_cold
    ):
        raise AssertionError("tiered rm=5: the snapshots' cold arrays differ")
    log(f"  tiered rm=5: {sum(e['event'] == 'spill' for e in g_ev)} spills and "
        f"{sum(e['event'] == 'cold_probe' for e in g_ev)} cold probes, "
        "events and cold arrays bit-equal to the CPU run")


def phase_tiered_raft(torch, gpu, rows, want_fps, in_hbm_peak):
    """Tiered ``raft check`` under a 64 MB budget: the golden, at least
    four spills, fingerprints equal to phase 20's, ``Election Safety``'s
    path re-executed, the peak device memory beside phase 20's (each above
    what earlier phases still held), and K20 against its twins on the
    run's largest cold wave."""
    with tempfile.TemporaryDirectory() as tmp, ColdWaveCapture() as cap:
        journal = os.path.join(tmp, "tiered.jsonl")
        held = torch.cuda.memory_allocated()
        launches, checker = run_full(
            torch, gpu, "tiered-raft",
            lambda t: run_tiered_raft(t, journal=journal),
            properties_hold=False)
        peak = torch.cuda.max_memory_allocated() - held
        events = journal_events(journal, ("spill", "cold_probe"))
    m = tiered_summary("tiered raft check", checker, events)
    log(f"  tiered raft check: peak device memory {peak} bytes above what "
        f"earlier phases held, the in-HBM run's {in_hbm_peak} bytes")
    if m["spills"] < 4:
        raise AssertionError(f"tiered raft check spilled {m['spills']} times")
    if not (checker.discovered_fingerprints() == want_fps).all():
        raise AssertionError("tiered raft check: fingerprints differ")
    log("  tiered raft check: fingerprints equal to the in-HBM run's")
    phase_raft_election_safety(checker)
    phase_cold_kernels(torch, rows, "tiered-raft", cap)
    return launches


# --- the incremental verification store (incr/) -----------------------------


def incr_request(torch, builder, store, journal, geometry):
    """One ``incremental_check`` request on the card; returns the checker,
    its ``info`` and the seconds of the request's run (the mode's own work,
    ``info["sec"]``) and of its store write (the rest of the call)."""
    from stateright_tpu_torch.incr import incremental_check

    torch.cuda.synchronize()
    t0 = time.monotonic()
    checker, info = incremental_check(builder, store, engine_kwargs=geometry,
                                      journal=journal)
    torch.cuda.synchronize()
    total = time.monotonic() - t0
    return checker, info, info["sec"], total - info["sec"]


def wave_count(journal):
    return len(journal_events(journal, ("wave",)))


def path_fps(model, path):
    return [int(model.fingerprint(s)) for s in path.into_states()]


def same_discoveries(what, got, want):
    """Discovery names and paths (their states' fingerprints) equal."""
    model = want.model()
    g, w = got.discoveries(), want.discoveries()
    if sorted(g) != sorted(w) or any(
        path_fps(model, g[k]) != path_fps(model, w[k]) for k in w
    ):
        raise AssertionError(f"{what}: discoveries or paths differ from the "
                             "cold run's")


def phase_incr_grid(torch, gpu, captured):
    """GridWalk: bound 511 cold and stored, widened to 1,023 (a resume
    seeded from the 262,144 stored states, K21 launched), bit-equal to a
    cold bound-1,023 run in its fingerprints; then the same request again, served from the
    verdict cache with no kernel launched."""
    from stateright_tpu_torch.models.fixtures import GridWalk

    lo, hi = GRID_BOUNDS
    with tempfile.TemporaryDirectory() as tmp:
        store, journal = os.path.join(tmp, "store"), os.path.join(tmp, "j.jsonl")
        cold, info, run_s, store_s = incr_request(
            torch, GridWalk(bound=lo).checker(), store, journal, GRID_GEOMETRY)
        if info["mode"] != "cold" or cold.unique_state_count() != (lo + 1) ** 2:
            raise AssertionError(f"GridWalk {lo}: {info['mode']} "
                                 f"{cold.unique_state_count()}")
        log(f"  GridWalk {lo} cold: unique={cold.unique_state_count()} "
            f"depth={cold.max_depth()} cold run {run_s:.3f}s, store write "
            f"{store_s:.3f}s")
        del cold
        reset_launches()
        wide, info, run_s, store_s = incr_request(
            torch, GridWalk(bound=hi).checker(), store, journal, GRID_GEOMETRY)
        launches = read_launches("incr-grid")
        log(f"  GridWalk {hi} {info['mode']}: seeded={info.get('seeded_states')} "
            f"unique={wide.unique_state_count()} states={wide.state_count()} "
            f"depth={wide.max_depth()} waves={wide.waves()} re-check "
            f"{run_s:.3f}s, store write {store_s:.3f}s; launches {launches}")
        if (info["mode"], info.get("seeded_states"), wide.unique_state_count()) != (
            "constant_widening", (lo + 1) ** 2, (hi + 1) ** 2
        ):
            raise AssertionError(f"GridWalk {hi}: {info}")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        ref = GridWalk(bound=hi).checker().spawn_gpu(**GRID_GEOMETRY).join()
        cold_s = time.monotonic() - t0
        log(f"  GridWalk {hi} cold run for comparison: {cold_s:.3f}s, "
            f"unique={ref.unique_state_count()} depth={ref.max_depth()}")
        if not (wide.discovered_fingerprints() == ref.discovered_fingerprints()).all():
            raise AssertionError("GridWalk widening: fingerprints differ from "
                                 "the cold run's")
        # A seeded run's log holds the stored states first, so its path to
        # the corner may differ from the cold run's; it must reach it.
        corner = wide.discoveries().get("reaches corner")
        if sorted(wide.discoveries()) != sorted(ref.discoveries()) or (
            corner is None or corner.last_state() != (hi, hi)
        ):
            raise AssertionError("GridWalk widening: discoveries differ")
        # K21's row: the log's head (the origin's diagonals), its tail (the
        # box edge and the corner) and the tail's x + 1 neighbours, some
        # outside the box, so every branch of the kernel is read.
        q = GRID_GEOMETRY["max_frontier"] // 4
        log_rows = ref._carry.rows[: ref.unique_state_count()].view(-1, 1)
        captured["grid"] = (torch.cat([log_rows[:q], log_rows[-2 * q:],
                                       log_rows[-q:] + 1]).clone(), hi)
        del wide, ref
        reset_launches()
        hit, info, run_s, _ = incr_request(
            torch, GridWalk(bound=hi).checker(), store, journal, GRID_GEOMETRY)
        counts = {fn.__name__: fn.launches for fn in launch_counted()}
        log(f"  GridWalk {hi} again: {info['mode']} in {run_s:.4f}s, "
            f"{sum(counts.values())} kernel launches")
        if info["mode"] != "identical" or any(counts.values()):
            raise AssertionError(f"verdict cache: {info['mode']}, launches {counts}")
        if hit.unique_state_count() != (hi + 1) ** 2 or sorted(
            hit.discoveries()) != ["reaches corner"]:
            raise AssertionError("verdict cache: counts or discoveries differ")
    return launches


def phase_incr_2pc(torch, gpu, captured):
    """2pc rm=9: the stock model cold and stored, then
    ``TwoPhaseEdited.build(9)`` re-evaluated over the stored row log (K2c
    and K22, no wave and no exploration kernel), its discoveries and paths
    those of a cold card run of the edited model."""
    from stateright_tpu_torch.models.fixtures import TwoPhaseEdited
    from stateright_tpu_torch.models.twophase import TwoPhaseSys

    with tempfile.TemporaryDirectory() as tmp:
        store, journal = os.path.join(tmp, "store"), os.path.join(tmp, "j.jsonl")
        cold, info, run_s, store_s = incr_request(
            torch, TwoPhaseSys(rm_count=RM9).checker(), store, journal,
            RM9_GEOMETRY)
        log(f"  2pc rm={RM9} cold: unique={cold.unique_state_count()} "
            f"states={cold.state_count()} depth={cold.max_depth()} "
            f"waves={cold.waves()} cold run {run_s:.3f}s, store write "
            f"{store_s:.3f}s")
        if info["mode"] != "cold":
            raise AssertionError(f"2pc rm={RM9}: {info}")
        captured["2pc"] = cold._carry.rows[: 2 * F].view(F, 2).clone()
        del cold
        waves = wave_count(journal)
        reset_launches()
        edited, info, run_s, store_s = incr_request(
            torch, TwoPhaseEdited.build(RM9).checker(), store, journal,
            RM9_GEOMETRY)
        launches = read_launches("incr-2pc")
        explore = {k: launches[k] for k in
                   ("twophase_step", "device_fp64", "insert_batch_claim", "wave_eval")}
        recheck = journal_events(journal, ("incr_property_recheck",))[-1]
        log(f"  edited rm={RM9} {info['mode']}: rows={recheck['rows']} "
            f"chunks={recheck['dispatches']} found={recheck['discoveries']} "
            f"re-check {run_s:.3f}s, store write {store_s:.3f}s; launches "
            f"{launches}")
        if info["mode"] != "property_only" or wave_count(journal) != waves or any(
            explore.values()
        ):
            raise AssertionError(f"property-only re-check: {info['mode']}, "
                                 f"waves added, or exploration {explore}")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        ref = TwoPhaseEdited.build(RM9).checker().spawn_gpu(**RM9_GEOMETRY).join()
        cold_s = time.monotonic() - t0
        log(f"  edited rm={RM9} cold run for comparison: {cold_s:.3f}s")
        got = (edited.unique_state_count(), edited.state_count(), edited.max_depth())
        want = (ref.unique_state_count(), ref.state_count(), ref.max_depth())
        if got != want:
            raise AssertionError(f"property-only counts {got} != cold {want}")
        same_discoveries("property-only re-check", edited, ref)
        log(f"  edited rm={RM9}: discoveries {sorted(ref.discoveries())} and "
            "paths equal to the cold run's")
    return launches


def phase_incr_paxos3(torch, gpu, want_fps):
    """``paxos check 3`` at ``max_round=1`` cold and stored, then the
    unbounded check seeded from it: phase 6's 1,194,428 states and its
    fingerprints, bit for bit."""
    from stateright_tpu_torch.actor import Network
    from stateright_tpu_torch.models.paxos import PaxosModelCfg

    def model(max_round):
        return PaxosModelCfg(3, 3, Network.new_unordered_nonduplicating(),
                             max_round=max_round).into_model()

    with tempfile.TemporaryDirectory() as tmp:
        store, journal = os.path.join(tmp, "store"), os.path.join(tmp, "j.jsonl")
        cold, info, run_s, store_s = incr_request(
            torch, model(PAXOS3_SEED_ROUND).checker(), store, journal,
            PAXOS3_GEOMETRY)
        log(f"  paxos check 3 max_round={PAXOS3_SEED_ROUND} cold: "
            f"unique={cold.unique_state_count()} states={cold.state_count()} "
            f"depth={cold.max_depth()} cold run {run_s:.3f}s, store write "
            f"{store_s:.3f}s")
        del cold
        reset_launches()
        wide, info, run_s, store_s = incr_request(
            torch, model(None).checker(), store, journal, PAXOS3_GEOMETRY)
        launches = read_launches("incr-paxos3")
        log(f"  paxos check 3 {info['mode']}: seeded={info.get('seeded_states')} "
            f"unique={wide.unique_state_count()} states={wide.state_count()} "
            f"depth={wide.max_depth()} waves={wide.waves()} re-check "
            f"{run_s:.3f}s, store write {store_s:.3f}s")
        if info["mode"] != "constant_widening" or (
            wide.unique_state_count() != GOLDEN_PAXOS3[0]
        ):
            raise AssertionError(f"paxos widening: {info}")
        if not (wide.discovered_fingerprints() == want_fps).all():
            raise AssertionError("paxos widening: fingerprints differ from "
                                 "phase 6's")
        log("  paxos check 3 widened: fingerprints equal to phase 6's cold run")
        wide.assert_properties()
    return launches


def phase_incr_kernels(torch, rows, captured):
    """K21, K2c and K22 against their twins on the re-check paths' inputs:
    K21 on the head and tail of the bound-1,023 log (with out-of-box
    neighbours of the tail), K2c (with the edited
    model's fourth column) on the first 2**20 rows of the 2pc rm=9 log, K22
    on those conds with the edited model's property kinds."""
    from stateright_tpu_torch.incr.recheck import first_hits, first_hits_plain
    from stateright_tpu_torch.models.fixtures import grid_walk, grid_walk_plain
    from stateright_tpu_torch.ops import cuda
    from stateright_tpu_torch.models.twophase_compiled import (
        twophase_conds, twophase_conds_plain,
    )

    states, bound = captured.pop("grid")
    f = states.shape[0]
    k = grid_walk(states, bound)
    p = grid_walk_plain(states, bound)
    torch.cuda.synchronize()
    for name, col in [("valid", p[1]), ("in bounds", p[2][:, 0]),
                      ("reaches corner", p[2][:, 1])]:
        if col.all() or not col.any():
            raise AssertionError(f"grid_walk's row: {name} takes one value only")
    row = kernel_row(rows, "incr-grid")
    row("grid_walk", max_abs_err(torch, zip(k, p)),
        time_ms(torch, lambda: grid_walk(states, bound), 10),
        time_ms(torch, lambda: grid_walk_plain(states, bound), 5),
        f * (4 + 8 + 2 + 2))

    states = captured.pop("2pc")
    n = states.shape[0]
    row = kernel_row(rows, "incr-2pc")
    k = twophase_conds(states, RM9, some_prepared=True)
    p = twophase_conds_plain(states, RM9, some_prepared=True)
    stock = twophase_conds(states, RM9)
    torch.cuda.synchronize()
    if not torch.equal(stock, twophase_conds_plain(states, RM9)):
        raise AssertionError("twophase_conds (stock columns) disagrees with its twin")
    n_props = k.shape[1]
    row("twophase_conds", max_abs_err(torch, [(k, p)]),
        time_ms(torch, lambda: twophase_conds(states, RM9, some_prepared=True), 10),
        time_ms(torch, lambda: twophase_conds_plain(states, RM9, some_prepared=True), 3),
        n * (8 + n_props))
    conds = k
    # abort agreement, commit agreement: sometimes; consistent: always;
    # some rm prepared: sometimes.
    always, sometimes = 0b0100, 0b1011
    start = 3 * n  # a chunk past the first
    kh = first_hits(conds, n, always, sometimes, start)
    ph = first_hits_plain(conds, n, always, sometimes, start)
    torch.cuda.synchronize()
    bits = torch.tensor([1, 2, 4, 8], device=conds.device)
    hit = (((always & bits) != 0) & ~conds) | (((sometimes & bits) != 0) & conds)
    hit_u8 = hit.to(torch.uint8)
    # The row times the kernel alone, on slots filled once (its atomicMin
    # leaves them as they are); the wrapper adds the slot fill.
    kernel = cuda.function(
        "recheck", "sr_first_hits",
        [cuda.P, cuda.I64, cuda.I32, cuda.U32, cuda.U32, cuda.I64, cuda.P,
         cuda.P],
    )
    slots = kh.clone()

    def alone():
        code = kernel(cuda.ptr(conds), n, n_props, always, sometimes, start,
                      cuda.ptr(slots), cuda.stream(conds))
        cuda.check(code, "recheck", "first_hits")

    kernel_ms = time_ms(torch, alone, 10)
    if not torch.equal(slots, kh):
        raise AssertionError("first_hits moved slots it had already set")
    log(f"  first_hits on {n} rows: {kh.tolist()}; the kernel alone "
        f"{kernel_ms:.4f} ms, with the slot fill (the wrapper) "
        f"{time_ms(torch, lambda: first_hits(conds, n, always, sometimes, start), 10):.4f} ms")
    row("first_hits", max_abs_err(torch, [(kh, ph)]), kernel_ms,
        time_ms(torch, lambda: first_hits_plain(conds, n, always, sometimes, start), 3),
        n * n_props + n_props * 8,
        library_ms=time_ms(torch, lambda: torch.argmax(hit_u8, dim=0), 10))



# --- gang batching (fleet/gang.py) -------------------------------------------


def gang_members(models):
    return [{"tag": i, "model": m, "cm": m.compiled(),
             "consts": m.compiled().gang_constants()}
            for i, m in enumerate(models)]


class GangWaveCapture:
    """Keeps copies of the inputs of two waves a gang runs, to replay its
    kernels against their twins: the widest (the most active lanes), and
    the first of the waves whose outputs vary most -- the most cond columns
    taking both values over the active lanes, plus one where ``first``
    holds both a hit and a miss (for a gang of walks, the wave that reaches
    the smallest bound's corner)."""

    def __init__(self):
        from stateright_tpu_torch.fleet import gang

        self._cls = gang._Wave
        self._run = gang._Wave.run
        self.best = None
        self.varied = None

    @staticmethod
    def _copy(wave, **extra):
        return dict(always=wave.always, consts=wave.consts.clone(), **extra,
                    **{k: v.clone() for k, v in wave.host_in.items()})

    def __enter__(self):
        cap = self

        def run(wave):
            out = cap._run(wave)  # reads host_in, writes host_out only
            active = wave.host_in["active"].numpy()
            n = int(active.sum())
            if cap.best is None or n > cap.best["n"]:
                cap.best = cap._copy(wave, n=n)
            conds = out["conds"][active]
            first = out["first"][active.any(1)]
            score = int(sum(conds[:, q].any() and not conds[:, q].all()
                            for q in range(conds.shape[1])))
            score += int((first >= 0).any() and (first < 0).any())
            if cap.varied is None or score > cap.varied["score"]:
                cap.varied = cap._copy(wave, n=n, score=score)
            return out

        self._cls.run = run
        return self

    def __exit__(self, *exc):
        self._cls.run = self._run


def phase_gang(torch, gpu, path, models, solo_path=None):
    """``run_gang`` on the card at F = ``GANG_F``: every wave one launch each
    of the family's gang kernel, K23 and K1 (and K1 once to seed), nothing
    else; each member's summary and fingerprints equal its solo
    ``spawn_gpu`` run's on the card.  Returns the gang's launches, the solo
    runs' (read as ``solo_path``), the results and the captured waves."""
    import numpy as np
    from stateright_tpu_torch.fleet import run_gang
    from stateright_tpu_torch.serve.portfolio import checker_summary

    torch.cuda.synchronize()
    reset_launches()
    with GangWaveCapture() as cap:
        t0 = time.monotonic()
        results, waves = run_gang(gang_members(models), max_frontier=GANG_F)
        torch.cuda.synchronize()
        gang_s = time.monotonic() - t0
    launches = read_launches(path)
    family = PATH_KERNELS[path][0]
    want = {family: waves, "gang_eval": waves, "device_fp64": waves + 1}
    got = {k: v for k, v in launches.items() if v}
    if got != want:
        raise AssertionError(f"{path}: launches {got}, expected {want}")
    solos, solo_s = [], []
    reset_launches()
    for m in models:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        solos.append(m.checker().spawn_gpu(**GANG_SOLO).join())
        solo_s.append(time.monotonic() - t0)
    solo_launches = read_launches(solo_path) if solo_path else None
    for (tag, c, reason), solo in zip(results, solos):
        if c is None:
            raise AssertionError(f"{path}: member {tag} ejected: {reason}")
        if checker_summary(c) != checker_summary(solo) or not np.array_equal(
                c.discovered_fingerprints(), solo.discovered_fingerprints()):
            raise AssertionError(f"{path}: member {tag} differs from its solo run")
    log(f"  {path}: K={len(models)} waves={waves} gang wall {gang_s:.4f}s; "
        f"members' solo runs {sum(solo_s):.4f}s in all "
        f"({', '.join(f'{x:.4f}' for x in solo_s)}); card={gpu!r}")
    log(f"  {path} members: " + "; ".join(
        f"{c.unique_state_count()}/{c.state_count()}/{c.max_depth()} "
        f"{sorted(c.discoveries())}" for _t, c, _r in results))
    log(f"  {path} launches: {got}; solo runs: {solo_launches}")
    return launches, solo_launches, results, cap


def phase_gang_grid(torch, gpu, captured):
    from stateright_tpu_torch.models.fixtures import GridWalk

    launches, _solo, results, waves = phase_gang(
        torch, gpu, "gang-grid", [GridWalk(bound=b) for b in GANG_GRID_BOUNDS])
    for (_t, c, _r), b in zip(results, GANG_GRID_BOUNDS):
        if c.unique_state_count() != (b + 1) ** 2:
            raise AssertionError(f"GridWalk({b}): {c.unique_state_count()} states")
    captured["gang-grid"] = waves
    return launches


def phase_gang_cap(torch, gpu, captured):
    from stateright_tpu_torch.models.fixtures import CapCounter
    from stateright_tpu_torch.serve.portfolio import checker_summary

    launches, solo, results, waves = phase_gang(
        torch, gpu, "gang-cap",
        [CapCounter(limit=lim, cap=cap) for lim, cap in GANG_CAP_PARAMS],
        solo_path="cap-solo")
    violations = [checker_summary(c)["violation"] for _t, c, _r in results]
    log(f"  gang-cap violations: {violations}")
    if violations != GANG_CAP_VIOLATIONS:
        raise AssertionError(f"gang-cap violations {violations}")
    captured["gang-cap"] = waves
    return launches, solo


def phase_gang_of_5(torch, gpu):
    """A gang of 5, padded to K = 8: one launch each a wave as at K = 8."""
    from stateright_tpu_torch.models.fixtures import GridWalk

    phase_gang(torch, gpu, "gang-grid", [GridWalk(bound=b) for b in GANG_OF_5])


def phase_gang_eject():
    """GridWalk(2) and GridWalk(12) at F = 8: the second is ejected with the
    JAX package's reason, the first completes as on the CPU."""
    import numpy as np
    from stateright_tpu_torch.fleet import run_gang
    from stateright_tpu_torch.models.fixtures import GridWalk
    from stateright_tpu_torch.serve.portfolio import checker_summary

    models = [GridWalk(bound=2), GridWalk(bound=12)]
    (small, big), waves = run_gang(gang_members(models), max_frontier=8)
    (csmall, cbig), cwaves = run_gang(gang_members(models), max_frontier=8,
                                      device="cpu")
    log(f"  eject: waves={waves}, GridWalk(2) "
        f"{small[1] and small[1].unique_state_count()}, GridWalk(12) "
        f"ejected: {big[2]!r}")
    if big[1] is not None or big[2] != "frontier overgrew gang geometry (9 > 8)":
        raise AssertionError(f"eject: {big}")
    if waves != cwaves or big[2] != cbig[2] or checker_summary(small[1]) != \
            checker_summary(csmall[1]) or not np.array_equal(
                small[1].discovered_fingerprints(),
                csmall[1].discovered_fingerprints()):
        raise AssertionError("eject: the card's gang differs from the CPU's")
    if small[1].unique_state_count() != 9:
        raise AssertionError("eject: GridWalk(2) did not complete at 9 states")


def edited_raft(torch):
    """Raft with one property appended, "at the init row" (ALWAYS: the
    packed row equals the init state's), through a compiled subclass that
    overrides ``property_conds``: the fused K11's conds must give way to the
    override's."""
    from stateright_tpu_torch.core.model import Expectation
    from stateright_tpu_torch.ops.u32 import from_numpy_u32

    model = raft_model()
    codec = model.compiled()
    init_row = codec.init_packed()[0]
    on_device = {}

    class Edited(type(codec)):
        def property_conds(self, states):
            conds = super().property_conds(states)
            # The init row is uploaded once a device: the quantum's graph
            # capture takes no host copy.
            row = on_device.get(states.device)
            if row is None:
                row = on_device[states.device] = from_numpy_u32(
                    init_row, states.device)
            same = (states == row).all(1)
            return torch.cat([conds, same[:, None]], dim=1)

    model.property(Expectation.ALWAYS, "at the init row",
                   lambda _m, s: bool((codec.encode(s) == init_row).all()))
    model.compiled = lambda: Edited(model)
    return model


def phase_edited_raft(torch):
    from stateright_tpu_torch.models.raft_compiled import W

    gpu = card_and_cpu(
        "edited raft to depth 6",
        lambda: edited_raft(torch).checker().target_max_depth(6),
        GOLDEN_EDITED_RAFT_D6, W, capacity=1 << 15, max_frontier=1 << 8)
    found = sorted(gpu.discoveries())
    log(f"  edited raft found {found}")
    if "at the init row" not in found or len(
            gpu.discoveries()["at the init row"]) != 2:
        raise AssertionError(f"edited raft: the override's discovery {found}")


# Cond columns that hold on every state by definition: CapCounter's
# "non-negative" (n >= 0 of a u32).
GANG_CONSTANT_CONDS = {"gang-cap": {0}}


def replay_varied_wave(torch, path, kernel, plain, w):
    """The family kernel, K23 and K1 bit-equal to their twins on ``path``'s
    most varied wave, after checking that the wave can tell them apart:
    every cond column not constant by definition takes both values over the
    active lanes and, for the walks, over the wave's candidate successors
    (where "in bounds" fails: a frontier lies inside its box), and K23's
    ``first`` holds a hit and a miss among the live jobs."""
    from stateright_tpu_torch.fleet.gang import gang_eval, gang_eval_plain
    from stateright_tpu_torch.ops.device_fp import device_fp64, device_fp64_plain

    dev = torch.device("cuda", 0)
    states, consts = w["frontier"].to(dev), w["consts"]
    active, undisc = w["active"].to(dev), w["undisc"].to(dev)
    k, f, _w = states.shape
    got, want = kernel(states, consts), plain(states, consts)
    nexts, valid, conds = got
    a, p = valid.shape[2], conds.shape[2]
    seen = [conds[active]]
    if path == "gang-grid":
        succ = nexts.view(k, f * a, 1)
        got2, want2 = kernel(succ, consts), plain(succ, consts)
        err = max_abs_err(torch, zip(got2, want2))
        lanes = active.unsqueeze(-1).expand(k, f, a).reshape(k, f * a)
        seen.append(got2[2][lanes])
    else:
        err = 0
    err = max(err, max_abs_err(torch, zip(got, want)))
    seen = torch.cat(seen)
    varies = [bool(seen[:, q].any()) and not bool(seen[:, q].all())
              for q in range(p)]
    gated = valid.clone()
    k23 = gang_eval(conds, gated, active, undisc, w["always"])
    p23 = gang_eval_plain(conds, valid, active, undisc, w["always"])
    first = k23[2][active.any(1)]
    flat = nexts.view(k * f * a, -1)
    k1, p1 = device_fp64(flat), device_fp64_plain(flat)
    torch.cuda.synchronize()
    err = max(err, max_abs_err(torch, zip(k23, p23)),
              max_abs_err(torch, zip(k1, p1)))
    log(f"  {path}'s most varied wave: K={k} F={f} active={w['n']} "
        f"valid={int(valid[active].sum())} conds vary {varies} first "
        f"{k23[2].tolist()} max_abs_err={err}")
    constant = GANG_CONSTANT_CONDS.get(path, set())
    if not all(v for q, v in enumerate(varies) if q not in constant):
        raise AssertionError(f"{path}: a cond column is constant on the "
                             f"replayed wave: {varies}")
    if not (bool((first >= 0).any()) and bool((first < 0).any())):
        raise AssertionError(f"{path}: K23's first lacks a hit or a miss")
    if not (bool(valid[active].any()) and not bool(valid[active].all())):
        raise AssertionError(f"{path}: validity is constant on the wave")
    if err:
        raise AssertionError(f"{path}: a kernel disagrees with its twin on "
                             f"the most varied wave")


def phase_gang_kernels(torch, rows, captured):
    """K21g, K24 (gang and solo), K23 and K1 against their twins on the
    widest real wave of gang-grid and gang-cap, timed; K23 beside
    ``torch.argmax`` over the precomputed hit columns.  Then each family
    kernel, K23 and K1 again on the gang's most varied wave
    (:func:`replay_varied_wave`)."""
    from stateright_tpu_torch.fleet.gang import gang_eval, gang_eval_plain
    from stateright_tpu_torch.models.fixtures import (
        cap_counter, cap_counter_gang, cap_counter_gang_plain, cap_counter_plain,
        grid_walk_gang, grid_walk_gang_plain,
    )
    from stateright_tpu_torch.ops.device_fp import device_fp64, device_fp64_plain

    dev = torch.device("cuda", 0)
    for path, kernel, plain in (
        ("gang-grid", grid_walk_gang, grid_walk_gang_plain),
        ("gang-cap", cap_counter_gang, cap_counter_gang_plain),
    ):
        waves = captured.pop(path)
        replay_varied_wave(torch, path, kernel, plain, waves.varied)
        w = waves.best
        states, consts = w["frontier"].to(dev), w["consts"]
        active, undisc = w["active"].to(dev), w["undisc"].to(dev)
        k, f, _w = states.shape
        c = consts.shape[1]
        row = kernel_row(rows, path)
        got = kernel(states, consts)
        want = plain(states, consts)
        torch.cuda.synchronize()
        nexts, valid, conds = got
        a, p = valid.shape[2], conds.shape[2]
        log(f"  {path}'s widest wave: K={k} F={f} active={w['n']} "
            f"valid={int(valid[active].sum())}")
        row(PATH_KERNELS[path][0], max_abs_err(torch, zip(got, want)),
            time_ms(torch, lambda: kernel(states, consts), 10),
            time_ms(torch, lambda: plain(states, consts), 5),
            k * f * (4 + 4 * a + a + p) + k * c * 4)

        gated = valid.clone()

        def fresh():
            gated.copy_(valid)

        k23 = gang_eval(conds, gated, active, undisc, w["always"])
        p23 = gang_eval_plain(conds, valid, active, undisc, w["always"])
        torch.cuda.synchronize()
        bits = torch.tensor([(w["always"] >> q) & 1 for q in range(p)],
                            dtype=torch.bool, device=dev)
        hit = (active.unsqueeze(-1) & torch.where(bits, ~conds, conds)).to(torch.uint8)
        log(f"  gang_eval [{path}]: generated {k23[1].tolist()} first "
            f"{k23[2].tolist()}")
        row("gang_eval", max_abs_err(torch, zip(k23, p23)),
            time_ms(torch, lambda: gang_eval(conds, gated, active, undisc,
                                             w["always"]), 10, setup=fresh),
            time_ms(torch, lambda: gang_eval_plain(conds, valid, active, undisc,
                                                   w["always"]), 5),
            k * f * (p + 2 * a + 1) + k * (p + 4 + 4 * p),
            library_ms=time_ms(torch, lambda: torch.argmax(hit, dim=1), 10))

        flat = nexts.view(k * f * a, -1)
        k1 = device_fp64(flat)
        p1 = device_fp64_plain(flat)
        torch.cuda.synchronize()
        row("device_fp64", max_abs_err(torch, zip(k1, p1)),
            time_ms(torch, lambda: device_fp64(flat), 10),
            time_ms(torch, lambda: device_fp64_plain(flat), 5),
            flat.shape[0] * (4 * flat.shape[1] + 8))

        if path == "gang-cap":
            # K24's solo entry on the wave's rows at each member's constants.
            flat_states = states.view(k * f, 1)
            row = kernel_row(rows, "cap-solo")
            errs = []
            for limit, cap in GANG_CAP_PARAMS:
                got = cap_counter(flat_states, limit, cap)
                want = cap_counter_plain(flat_states, limit, cap)
                errs.append(max_abs_err(torch, zip(got, want)))
            limit, cap = GANG_CAP_PARAMS[5]
            row("cap_counter", max(errs),
                time_ms(torch, lambda: cap_counter(flat_states, limit, cap), 10),
                time_ms(torch, lambda: cap_counter_plain(flat_states, limit, cap), 5),
                k * f * (4 + 4 + 1 + 3))

# The sharded paths: four shards on the one card (``mesh=["cuda:0"] * 4``).
# paxos check 3: 2**20 slots a shard (about 300K states each, load under
# 0.3); a shard expands up to 4,096 states a wave into a 32,768-lane
# buffer (the JAX spawn clamp keeps four buffers inside 244,667 lanes at
# 45 words).  2pc check 10: 2**26 slots a shard (26 + 2 gid bits; about
# 15.4M states each, load 0.23) and the JAX clamp's 8,192 states a shard at
# dedup_factor=4.
SH_SHARDS = 4
SH_PAXOS3 = dict(capacity=1 << 22, chunk_size=1 << 12)
SH_RM10 = dict(capacity=1 << 28, chunk_size=1 << 13)
SH_SYM12 = dict(capacity=1 << 16, chunk_size=1 << 12)
SH_PAXOS2 = dict(capacity=1 << 16, chunk_size=1 << 9)  # test_tpu_sharded.py:247
SH_PAXOS2_MAX_BYTES = 250_000_000
SH_PAXOS2_MIN_OCCUPANCY = 0.02


def sharded_mesh(n=SH_SHARDS):
    return ["cuda:0"] * n


def sharded_device_fps(torch, checker):
    """A sharded run's identity fingerprints as a sorted int64 tensor on the
    card: each shard's queue prefix, as :func:`device_fps` reads a log."""
    from stateright_tpu_torch.ops.device_fp import device_fp64, fp64_of

    parts = []
    for sh in checker._shards:
        if sh.tail:
            rows = sh.store[sh.queue[: sh.tail].long()]
            parts.append(fp64_of(*device_fp64(checker._identity(rows))))
    return torch.sort(torch.cat(parts)).values


class ShardCapture:
    """While entered, keeps the inputs of the widest committed waves of a
    sharded run: the senders' K12 (prefix entry) and K26 calls of the wave
    that sent the most representatives, and the owners' K4 and K27 calls
    (and K12's mask entry on the sorted path) of the wave that committed
    the most new states (with each owner's tail then)."""

    def __enter__(self):
        import stateright_tpu_torch.parallel.sharded as sharded

        self.mod = sharded
        self.saved = {k: getattr(sharded, k) for k in (
            "prededup", "prededup_prefix", "owner_bucket", "insert_batch_claim",
            "shard_commit")}
        self.saved_host = sharded.ShardedGpuChecker._wave_host
        self.cur = {k: [] for k in self.saved}
        self.send = self.recv = None
        self.best_reps = self.best_new = -1
        cap = self

        def recording(name):
            fn = cap.saved[name]

            def call(*args, **kw):
                cap.cur[name].append((args, kw))
                return fn(*args, **kw)

            return call

        for name in self.saved:
            setattr(sharded, name, recording(name))

        def host(eng, exp, got, size, sovf):
            flags = cap.saved_host(eng, exp, got, size, sovf)
            n = eng._n
            if not flags:
                reps = sum(r[5] for r in got)
                new = sum(r[0] for r in got)
                if reps > cap.best_reps:
                    cap.best_reps = reps
                    cap.send = dict(prededup=cap.cur["prededup_prefix"],
                                    bucket=cap.cur["owner_bucket"])
                if new > cap.best_new:
                    cap.best_new = new
                    cap.recv = dict(insert=cap.cur["insert_batch_claim"][-n:],
                                    commit=cap.cur["shard_commit"][-n:],
                                    sorted=cap.cur["prededup"][-n:])
            cap.cur = {k: [] for k in cap.saved}
            return flags

        sharded.ShardedGpuChecker._wave_host = host
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.mod, name, fn)
        self.mod.ShardedGpuChecker._wave_host = self.saved_host


def run_sharded(torch, gpu, path, builder, kw, want_counts=None,
                spawn="spawn_gpu_sharded"):
    """``builder().spawn_gpu_sharded(**kw)`` (or the ``spawn`` named) on the
    card with the launch counts read around it (``path``'s kernels must all
    launch where it is in ``PATH_KERNELS``); logs its counts, time, peak
    memory and accounting, holds ``(unique, depth)`` to ``want_counts`` (or
    its first item); returns ``(launches, checker, seconds)``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.monotonic()
    checker = getattr(builder(), spawn)(**kw).join()
    elapsed = time.monotonic() - t0
    launches = (read_launches(path) if path in PATH_KERNELS
                else {fn.__name__: fn.launches for fn in launch_counted()})
    got = (checker.unique_state_count(), checker.state_count(), checker.max_depth())
    peak = torch.cuda.max_memory_allocated() - held
    acc = checker.accounting()
    log(f"  {path}: unique={got[0]} states={got[1]} depth={got[2]} "
        f"waves={acc['waves']} elapsed_s={elapsed:.3f} "
        f"unique_per_s={got[0] / elapsed:.1f} peak_bytes={peak} card={gpu!r}")
    log(f"  {path} accounting: {json.dumps(acc)}")
    log(f"  {path} launches: {launches}")
    if want_counts is not None and (got[0], got[2])[: len(want_counts)] != want_counts:
        raise AssertionError(f"{path} (unique, depth) {got} != {want_counts}")
    return launches, checker, elapsed


def same_fps(what, got, want):
    import numpy as np

    if not np.array_equal(got, want):
        raise AssertionError(f"{what}: fingerprints differ from the single-card run's")
    log(f"  {what}: {len(got)} fingerprints equal to the single-card run's")


def phase_sh_paxos3(torch, gpu, want_counts, want_fps):
    """``paxos check 3`` on four shards of the card: phase 6's counts and
    fingerprints; returns its launches, checker and capture."""
    with ShardCapture() as cap:
        launches, checker, _ = run_sharded(
            torch, gpu, "sh-paxos3", paxos_model(3).checker,
            dict(mesh=sharded_mesh(), **SH_PAXOS3), want_counts)
    same_fps("sh-paxos3", checker.discovered_fingerprints(), want_fps)
    checker.assert_properties()
    return launches, checker, cap


def phase_sh_rm10(torch, gpu, want_counts, want_fps):
    """``2pc check 10`` on four shards of the card: phase 4's counts and
    fingerprints, and the peak device memory."""
    from stateright_tpu_torch.models.twophase import TwoPhaseSys

    with ShardCapture() as cap:
        launches, checker, _ = run_sharded(
            torch, gpu, "sh-rm10", TwoPhaseSys(rm_count=RM).checker,
            dict(mesh=sharded_mesh(), **SH_RM10), want_counts)
    if not torch.equal(sharded_device_fps(torch, checker), want_fps):
        raise AssertionError("sh-rm10: fingerprints differ from phase 4's")
    log(f"  sh-rm10: {want_counts[0]} fingerprints equal to phase 4's")
    checker.assert_properties()
    return launches, checker, cap


def phase_sh1_paxos3(torch, gpu, want_counts, want_fps):
    """``paxos check 3`` on a 1-shard mesh: the exchange elided, K26 and K12
    never launched, phase 6's counts and fingerprints."""
    launches, checker, _ = run_sharded(
        torch, gpu, "sh1-paxos3", paxos_model(3).checker,
        dict(mesh=sharded_mesh(1), capacity=1 << 22, chunk_size=1 << 14),
        want_counts)
    if (launches["owner_bucket"] or launches["prededup"]
            or launches["prededup_prefix"]):
        raise AssertionError("a 1-shard mesh launched K26 or K12")
    if not launches["shard_commit"] or not checker.accounting()["exchange_elided"]:
        raise AssertionError("the 1-shard mesh did not commit through K27 "
                             "with the exchange elided")
    same_fps("sh1-paxos3", checker.discovered_fingerprints(), want_fps)


def phase_sh_paxos2(torch, gpu):
    """The paxos C = 2 pin of ``test_tpu_sharded.py:247`` on the card: 16,668
    at 1/2/4/8 shards, each set the single-card run's; at 8 shards at most
    250 MB of all-to-all bytes and occupancy >= 0.02; a forced
    ``bucket_slack=1`` at 2 shards climbs the slack ladder."""
    single = paxos_model(2).checker().spawn_gpu(
        capacity=1 << 16, max_frontier=1 << 9).join()
    want = single.discovered_fingerprints()
    for n in (1, 2, 4, 8):
        _l, checker, _ = run_sharded(
            torch, gpu, f"sh-paxos2-{n}", paxos_model(2).checker,
            dict(mesh=sharded_mesh(n), **SH_PAXOS2), GOLDEN_PAXOS2[:1])
        same_fps(f"paxos check 2 on {n} shards", checker.discovered_fingerprints(),
                 want)
        if n == 8:
            acc = checker.accounting()
            if not (acc["all_to_all_bytes_total"] <= SH_PAXOS2_MAX_BYTES
                    and acc["exchange_occupancy"] >= SH_PAXOS2_MIN_OCCUPANCY):
                raise AssertionError(f"8-shard exchange out of its pin: {acc}")
    _l, forced, _ = run_sharded(
        torch, gpu, "sh-paxos2-forced", paxos_model(2).checker,
        dict(mesh=sharded_mesh(2), bucket_slack=1, **SH_PAXOS2),
        GOLDEN_PAXOS2[:1])
    same_fps("forced bucket retry", forced.discovered_fingerprints(), want)
    if forced.accounting()["bucket_retries"] < 1:
        raise AssertionError("bucket_slack=1 at 2 shards never retried")


def phase_sh_sorted(torch, gpu, rows):
    """The paxos C = 2 pin on four shards on the sorted path
    (``sortless=False``): the senders' dedup through K12's prefix entry,
    the owners' insert through its mask entry (the received validity is no
    prefix), the single-card run's fingerprints; K12's mask entry against
    its twin on the widest owner batch.  Returns its launches."""
    single = paxos_model(2).checker().spawn_gpu(
        capacity=1 << 16, max_frontier=1 << 9).join()
    with ShardCapture() as cap:
        launches, checker, _ = run_sharded(
            torch, gpu, "sh-paxos2s", paxos_model(2).checker,
            dict(mesh=sharded_mesh(), sortless=False, **SH_PAXOS2),
            GOLDEN_PAXOS2[:1])
    same_fps("paxos check 2 on four shards, sorted", checker.discovered_fingerprints(),
             single.discovered_fingerprints())
    if cap.recv is None or not cap.recv["sorted"]:
        raise AssertionError("sh-paxos2s: no sorted owner insert was captured")
    args, _kw = max(cap.recv["sorted"], key=lambda c: int(c[0][2].sum()))
    check_prededup(torch, kernel_row(rows, "sh-paxos2s"), None, "sh-paxos2s",
                   args[0], args[1], active=args[2])
    return launches


def phase_sh_sym12(torch, gpu):
    """``2pc check-sym 12`` on four shards: 6,656 orbits, K15 launched (the
    canonical fingerprint routes owners)."""
    from stateright_tpu_torch.models.twophase import TwoPhaseSys

    with ShardCapture() as cap:
        launches, checker, _ = run_sharded(
            torch, gpu, "sh-sym12", TwoPhaseSys(rm_count=12).checker().symmetry,
            dict(mesh=sharded_mesh(), **SH_SYM12), GOLDEN_SYM[12][:1])
    if sorted(checker.discoveries()) != SYM_FOUND:
        raise AssertionError(f"sh-sym12 found {sorted(checker.discoveries())}")
    return launches, checker, cap


def phase_sh_checkpoint(torch, want_counts, want_fps):
    """A mid-run checkpoint of sh-paxos3 (the ``checkpoint_every_waves``
    cadence) resumed by a fresh four-shard spawn to phase 6's counts and
    fingerprints; resuming it on two shards fails with the JAX message."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sh.npz")
        cut = paxos_model(3).checker().target_max_depth(15).spawn_gpu_sharded(
            mesh=sharded_mesh(), checkpoint_path=path, checkpoint_every_waves=8,
            **SH_PAXOS3).join()
        log(f"  cut at depth {cut.max_depth()}: {cut.unique_state_count()} states")
        resumed = paxos_model(3).checker().spawn_gpu_sharded(
            mesh=sharded_mesh(), resume_from=path, **SH_PAXOS3).join()
        got = (resumed.unique_state_count(), resumed.max_depth())
        if got != want_counts:
            raise AssertionError(f"resumed sharded run {got} != {want_counts}")
        same_fps("resumed sh-paxos3", resumed.discovered_fingerprints(), want_fps)
        try:
            paxos_model(3).checker().spawn_gpu_sharded(
                mesh=sharded_mesh(2), resume_from=path, **SH_PAXOS3).join()
        except ValueError as e:
            if "written on a 4-shard mesh and cannot resume on 2 shards" not in str(e):
                raise
            log(f"  a 2-shard resume refused: {str(e)[:80]}...")
        else:
            raise AssertionError("a 4-shard snapshot resumed on 2 shards")


def phase_shard_kernels(torch, rows, path, checker, cap):
    """K12 and K26 on the senders of the path's widest wave (the shard with
    the most active lanes), K1, K4 and K27 on the owner that committed the
    most of its widest committed wave -- each against its twin, bit-equal,
    timed; K26 beside ``torch.sort(stable=True)`` of its owner keys, K12
    beside the same sort of its keys (:func:`check_prededup`); K27
    replayed into fresh tables and held against what the run wrote at
    those slots and queue positions."""
    from stateright_tpu_torch.ops.device_fp import device_fp64, device_fp64_plain
    from stateright_tpu_torch.parallel.exchange import (
        owner_bucket, owner_bucket_plain, owner_mix, shard_commit,
        shard_commit_plain,
    )
    from stateright_tpu_torch.parallel.hashset import HashSet, insert_batch_claim

    if cap.send is None or cap.recv is None:
        raise AssertionError(f"{path}: no committed wave was captured")
    row = kernel_row(rows, path)
    w = checker._compiled.state_width
    fpw = checker._fp_words
    n = checker._n

    # K12's prefix entry: the sender batch with the most active lanes (the
    # mask entry checked and timed on the same batch).
    pd = max(cap.send["prededup"], key=lambda c: int(c[0][2]))
    v_hi, v_lo, n_valid = pd[0][:3]
    check_prededup(torch, row, kernel_row(rows, None), path, v_hi, v_lo,
                   count=n_valid)

    # K26: the sender with the most representatives.
    args, _kw = max(cap.send["bucket"], key=lambda c: int(c[0][2].sum()))
    u_hi, u_lo, u_valid = args[:3]
    bkt = args[10]
    k = owner_bucket(*args)
    p = owner_bucket_plain(*args)
    torch.cuda.synchronize()
    reps, u = int(u_valid.sum()), u_hi.shape[0]
    key = torch.where(u_valid, owner_mix(u_hi, u_lo) % n, n)
    row("owner_bucket", max_abs_err(torch, zip(k, p)),
        time_ms(torch, lambda: owner_bucket(*args), 10),
        time_ms(torch, lambda: owner_bucket_plain(*args), 2),
        u * (4 + 4 + 1) + reps * (4 + 4 + 4 * w + 8) + n * bkt * (w + 3) * 4,
        library_ms=time_ms(torch, lambda: torch.sort(key, stable=True), 10))
    log(f"  owner_bucket [{path}]: {reps} representatives of {u} lanes into "
        f"{n} buckets of {bkt}, counts {k[1].tolist()}")

    # K1, K4 and K27: the owner that committed the most in its widest wave.
    commits = cap.recv["commit"]
    d = max(range(len(commits)), key=lambda i: int(commits[i][0][0].sum()))
    (is_new, slot, origin, rrows, gid, eb, store, parent, ebits, queue,
     tail), _kw = commits[d]
    sh = checker._shards[d]
    ins_args = cap.recv["insert"][d][0]
    hi, lo, rv = ins_args[1:4]
    ident = checker._identity(rrows)
    k1 = device_fp64(ident)
    p1 = device_fp64_plain(ident)
    torch.cuda.synchronize()
    row("device_fp64", max_abs_err(torch, zip(k1, p1)) +
        max_abs_err(torch, zip(k1, (hi, lo))),
        time_ms(torch, lambda: device_fp64(ident), 10),
        time_ms(torch, lambda: device_fp64_plain(ident), 2),
        ident.shape[0] * (4 * fpw + 8))
    # The owner's table as it stood: every state of its queue before.
    table = HashSet.empty(checker._cap_s, hi.device)
    before = sh.store[sh.queue[:tail].long()]
    b_hi, b_lo = device_fp64(checker._identity(before))
    insert_batch_claim(table, b_hi, b_lo,
                       torch.ones((tail,), dtype=torch.bool, device=hi.device))
    log(f"  owner {d}: a table of {tail} states, {int(rv.sum())} received keys")
    check_insert(torch, row, table, hi, lo, rv)
    del table

    n_new = int(is_new.sum())
    fresh = [torch.zeros_like(t) for t in (sh.store, sh.parent, sh.ebits, sh.queue)]
    plain = [t.clone() for t in fresh]
    kn = shard_commit(is_new, slot, origin, rrows, gid, eb, *fresh, tail)
    pn = shard_commit_plain(is_new, slot, origin, rrows, gid, eb, *plain, tail)
    torch.cuda.synchronize()
    err = max_abs_err(torch, [(kn, pn)] + list(zip(fresh, plain)))
    s_new = slot[is_new].long()
    ran = (
        torch.equal(fresh[0][s_new], sh.store[s_new])
        and torch.equal(fresh[1][s_new], sh.parent[s_new])
        and torch.equal(fresh[2][s_new], sh.ebits[s_new])
        and torch.equal(fresh[3][tail : tail + n_new], sh.queue[tail : tail + n_new])
    )
    if not ran:
        raise AssertionError(f"{path}: K27's replay does not write what the run did")
    log(f"  shard_commit [{path}]: {n_new} new of {is_new.shape[0]} lanes at "
        f"tail {tail}, equal to what the run wrote")
    idx_words = 1 if origin is None else 2
    row("shard_commit", err,
        time_ms(torch, lambda: shard_commit(is_new, slot, origin, rrows, gid, eb,
                                            *fresh, tail), 10),
        time_ms(torch, lambda: shard_commit_plain(is_new, slot, origin, rrows, gid,
                                                  eb, *plain, tail), 2),
        is_new.shape[0] + n_new * (4 * idx_words + 2 * (4 * w + 8) + 4))
    if path == "sh-sym12":
        from stateright_tpu_torch.parallel.canon import (
            canonicalize_rows, canonicalize_rows_plain,
        )

        spec = checker._compiled.canon_spec()
        flat = rrows.contiguous()
        k15 = canonicalize_rows(spec, flat)
        p15 = canonicalize_rows_plain(spec, flat)
        torch.cuda.synchronize()
        row("canonicalize_rows", max_abs_err(torch, [(k15, p15)]),
            time_ms(torch, lambda: canonicalize_rows(spec, flat), 10),
            time_ms(torch, lambda: canonicalize_rows_plain(spec, flat), 2),
            flat.shape[0] * w * 4 * 2)


# The tiered-sharded checker (phases 61-63): paxos check 3 on four shards
# under 2 MB a shard (131,072 slots at 16 bytes, about 300,000 states a
# shard: several spills each), 2pc check-sym 12 under 0.016 MB (1,024 slots,
# about 1,700 orbits a shard); the mid-run checkpoint for the reshards is
# cut at depth 15.
TS_PAXOS3 = dict(memory_budget_mb=2)
TS_SYM12 = dict(memory_budget_mb=0.016)
TS_CUT_DEPTH = 15
TS_WIDTHS = (2, 8)


def run_ts(torch, gpu, path, builder, kw, want_counts=None, want_hits=True):
    """``builder().spawn_gpu_tiered_sharded(**kw)`` on the card with the
    launch counts read around it, as :func:`run_sharded` does; also logs
    the spills, cold entries and hits and fails unless every shard spilled
    and (with ``want_hits``) the cold tier answered a duplicate."""
    launches, checker, elapsed = run_sharded(
        torch, gpu, path, builder, kw, want_counts,
        spawn="spawn_gpu_tiered_sharded")
    m = checker.metrics()
    log(f"  {path}: per-shard capacity {checker._cap_s}, spills "
        f"{m['shard_spills']}, cold_entries={m['cold_entries']} "
        f"cold_runs={m['cold_runs']} cold hits={m.get('cold_hits_total', 0)} "
        f"queried={m.get('cold_probe_queries_total', 0)} "
        f"K20 passes={m.get('cold_probe_passes_total', 0)} "
        f"log_capacity={checker._log_cap} growths={m.get('grows', 0)}")
    if min(m["shard_spills"].values()) < 1 or (
            want_hits and not m.get("cold_hits_total")):
        raise AssertionError(f"{path}: a shard never spilled, or no cold hit")
    return launches, checker, elapsed


class TsCapture:
    """While entered, keeps the inputs of the tiered-sharded runs' widest
    kernel calls: the owner insert with the most active receive lanes (its
    table as it stood, the receive rows and keys), the owner cold filter
    with the most new keys times cold entries (in :func:`phase_cold_kernels`'
    format), and the K28 append with the most fresh lanes (with its shard
    and tail)."""

    def __enter__(self):
        import stateright_tpu_torch.tiered.sharded_engine as ts
        from stateright_tpu_torch.parallel.sharded import ShardedGpuChecker
        from stateright_tpu_torch.tiered.cold_join import cold_windows

        self.mod = ts
        self.saved = (ts.TieredShardedGpuChecker._cold_filter,
                      ts.shard_log_append)
        self.insert = self.cold = self.append = None
        cap = self
        best = {"insert": -1, "cold": -1, "append": -1}

        def insert(eng, sh, r, rv):
            act = int(rv.sum())
            take = act >= best["insert"]
            keys = sh.table.keys.clone() if take else None
            out = ShardedGpuChecker._phase_insert(eng, sh, r, rv)
            if take:
                best["insert"] = act
                cap.insert = dict(keys=keys, rows=r.rows.clone(), hi=r.hi.clone(),
                                  lo=r.lo.clone(), rv=rv.clone(), eng=eng)
            return out

        def cold_filter(eng, recvs, ins, got, new, fresh):
            before = {}
            for d, sh in enumerate(eng._shards):
                score = new[d] * sh.cold.entries
                if new[d] and sh.cold.run_count and score >= best["cold"]:
                    before[d] = (score, ins[d].is_new.clone(), list(sh.cold.runs),
                                 sh.cold.entries)
            out = cap.saved[0](eng, recvs, ins, got, new, fresh)
            for d, (score, is_new, runs, entries) in before.items():
                if score < best["cold"]:
                    continue
                lo_key, hi_key = (x & ((1 << 64) - 1) for x in got[d][-2:])
                passes = sum(-(-(b - a) // ts.COLD_CHUNK)
                             for _r, a, b in cold_windows(runs, lo_key, hi_key))
                best["cold"] = score
                cap.cold = dict(
                    hi=recvs[d].hi.clone(), lo=recvs[d].lo.clone(),
                    origin=None if ins[d].origin is None else ins[d].origin.clone(),
                    is_new=is_new, minmax=tuple(got[d][-2:]), runs=runs,
                    chunk=ts.COLD_CHUNK, cold_entries=entries,
                    fresh=ins[d].is_new.clone(), n_fresh=fresh[d],
                    acct={"passes": passes, "new": new[d],
                          "hits": new[d] - fresh[d]},
                )
            return out

        def append(fresh, origin, rows, gid, eb, log_rows, log_parent,
                   log_ebits, tail):
            k = int(fresh.sum())
            if k and k >= best["append"]:
                best["append"] = k
                cap.append = dict(
                    fresh=fresh.clone(),
                    origin=None if origin is None else origin.clone(),
                    rows=rows.clone(), gid=gid.clone(), eb=eb.clone(),
                    log_rows=log_rows, tail=tail, n=k,
                )
            return cap.saved[1](fresh, origin, rows, gid, eb, log_rows,
                                log_parent, log_ebits, tail)

        ts.TieredShardedGpuChecker._phase_insert = insert
        ts.TieredShardedGpuChecker._cold_filter = cold_filter
        ts.shard_log_append = append
        return self

    def __exit__(self, *exc):
        ts = self.mod
        del ts.TieredShardedGpuChecker._phase_insert
        ts.TieredShardedGpuChecker._cold_filter = self.saved[0]
        ts.shard_log_append = self.saved[1]


def phase_tr_sh_paxos3(torch, gpu, want_fps):
    """Traced ``paxos check 3`` on four shards of the card: phase 6's counts
    and fingerprints, the traced summary's checks (no wave or phase above
    1.05 of the peak), the journal's exchange payload equal to the
    accounting's, and the measured breakdown printed; returns its launches,
    checker and capture (K26/K27 rows)."""
    from stateright_tpu_torch.runtime.journal import read_journal

    with tempfile.TemporaryDirectory() as tmp, ShardCapture() as cap:
        journal = os.path.join(tmp, "tr-sh.jsonl")
        launches, checker, elapsed = run_sharded(
            torch, gpu, "tr-sh-paxos3", paxos_model(3).checker,
            dict(mesh=sharded_mesh(), trace=True, journal=journal, **SH_PAXOS3),
            GOLDEN_PAXOS3)
        s = traced_checks("tr-sh-paxos3", checker, journal)
        waves = [e for e in read_journal(journal) if e["event"] == "wave"]
    same_fps("tr-sh-paxos3", checker.discovered_fingerprints(), want_fps)
    payload = sum(w["exchange_payload_bytes"] for w in waves)
    acc = checker.accounting()
    if not payload == s["exchange_payload_bytes"] == acc["exchange_payload_bytes_total"]:
        raise AssertionError(f"tr-sh-paxos3: journal payload {payload} != "
                             f"accounting {acc['exchange_payload_bytes_total']}")
    host = s["wave_breakdown"].get("readback", 0.0)
    log(f"  tr-sh-paxos3: {len(waves)} traced waves in {elapsed:.3f} s; "
        f"breakdown {s['wave_breakdown']} (fractions {s['wave_breakdown_frac']}); "
        f"readback share {host / s['traced_sec']:.4f}; exchange payload "
        f"{payload} bytes, occupancy {acc['exchange_occupancy']:.4f}")
    checker.assert_properties()
    return launches, checker, cap


def phase_tr_sh1_paxos3(torch, gpu, want_fps):
    """Traced ``paxos check 3`` on a 1-shard mesh: the exchange elided (0
    modeled bytes, 0 payload), phase 6's fingerprints."""
    _l, checker, _ = run_sharded(
        torch, gpu, "tr-sh1-paxos3", paxos_model(3).checker,
        dict(mesh=sharded_mesh(1), capacity=1 << 22, chunk_size=1 << 14,
             trace=True), GOLDEN_PAXOS3)
    s = checker.trace_summary()
    if s["bytes"]["exchange"] or s["exchange_payload_bytes"] or not \
            checker.accounting()["exchange_elided"]:
        raise AssertionError("tr-sh1-paxos3: the 1-shard exchange was not elided")
    log(f"  tr-sh1-paxos3 breakdown {s['wave_breakdown']}")
    same_fps("tr-sh1-paxos3", checker.discovered_fingerprints(), want_fps)


def phase_ts_paxos3(torch, gpu, want_fps):
    """``paxos check 3`` through ``spawn_gpu_tiered_sharded`` on four shards
    at 2 MB a shard: phase 6's counts and fingerprints, every shard spilled,
    cold hits; returns its launches, checker and capture."""
    with TsCapture() as cap:
        launches, checker, _ = run_ts(
            torch, gpu, "ts-paxos3", paxos_model(3).checker,
            dict(mesh=sharded_mesh(), **TS_PAXOS3), GOLDEN_PAXOS3)
    same_fps("ts-paxos3", checker.discovered_fingerprints(), want_fps)
    checker.assert_properties()
    return launches, checker, cap


def phase_ts_sym12(torch, gpu):
    """``2pc check-sym 12`` tiered-sharded on four shards at 1,024 slots a
    shard: 6,656 orbits, spills, K15 launched."""
    from stateright_tpu_torch.models.twophase import TwoPhaseSys

    with TsCapture() as cap:
        launches, checker, _ = run_ts(
            torch, gpu, "ts-sym12", TwoPhaseSys(rm_count=12).checker().symmetry,
            dict(mesh=sharded_mesh(), **TS_SYM12), GOLDEN_SYM[12][:1],
            want_hits=False)
    if sorted(checker.discoveries()) != SYM_FOUND:
        raise AssertionError(f"ts-sym12 found {sorted(checker.discoveries())}")
    return launches, checker, cap


def phase_ts_reshard(torch, want_counts, want_fps):
    """A checkpoint of ts-paxos3 cut at depth 15 resharded on the host 4 -> 2
    and 4 -> 8 (``reshard_snapshot``), each resumed on that many shards to
    phase 6's counts and fingerprints; a plain sh-paxos3 checkpoint
    resharded into a 2-shard tiered one resumes to them too; the 4-shard
    tiered snapshot resumed on 2 shards unresharded fails with the JAX
    engine's message."""
    from stateright_tpu_torch.tiered.reshard import reshard_snapshot

    model = paxos_model(3)
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ts.npz")
        cut = model.checker().target_max_depth(TS_CUT_DEPTH).spawn_gpu_tiered_sharded(
            mesh=sharded_mesh(), checkpoint_path=ck, **TS_PAXOS3).join()
        log(f"  ts-paxos3 cut at depth {cut.max_depth()}: "
            f"{cut.unique_state_count()} states")
        plain = os.path.join(tmp, "plain.npz")
        model.checker().target_max_depth(TS_CUT_DEPTH).spawn_gpu_sharded(
            mesh=sharded_mesh(), checkpoint_path=plain, **SH_PAXOS3).join()
        # A resume adopts the snapshot's table; the plain run's is not the
        # budget's, so that one resumes with no budget.
        for what, src, m, kw in [("tiered 4", ck, m, TS_PAXOS3)
                                 for m in TS_WIDTHS] + [("plain 4", plain, 2, {})]:
            out = os.path.join(tmp, f"rs{m}.npz")
            t0 = time.monotonic()
            summary = reshard_snapshot(model, src, out, m)
            t_rs = time.monotonic() - t0
            t0 = time.monotonic()
            res = model.checker().spawn_gpu_tiered_sharded(
                mesh=sharded_mesh(m), resume_from=out, **kw).join()
            got = (res.unique_state_count(), res.max_depth())
            log(f"  {what} -> {m}: resharded in {t_rs:.3f} s (tails "
                f"{summary['tails']}), resumed in {time.monotonic() - t0:.3f} s "
                f"to {got}")
            if got != want_counts:
                raise AssertionError(f"{what} -> {m} resumed to {got}")
            same_fps(f"{what} -> {m}", res.discovered_fingerprints(), want_fps)
        try:
            model.checker().spawn_gpu_tiered_sharded(
                mesh=sharded_mesh(2), resume_from=ck, **TS_PAXOS3).join()
        except ValueError as e:
            if "written on a 4-shard mesh and cannot resume on 2 shards" not in str(e):
                raise
            log(f"  an unresharded 2-shard resume refused: {str(e)[:80]}...")
        else:
            raise AssertionError("a 4-shard tiered snapshot resumed on 2 shards")


def phase_ts_kernels(torch, rows, path, checker, cap):
    """K28 against its twin on the path's widest captured append, both
    into scratch logs, bit-equal to each other and to what the run wrote
    at that tail, timed beside the torch glue it replaced (``nonzero``,
    ``index_select`` and the slice writes); on ts-paxos3 also K20 on the
    owner's largest cold filter and K1 and K4 on the widest owner insert
    (into its table as it stood); on ts-sym12 K15 on that insert's
    receive rows."""
    from stateright_tpu_torch.ops.device_fp import device_fp64, device_fp64_plain
    from stateright_tpu_torch.parallel.exchange import (
        shard_log_append, shard_log_append_plain,
    )
    from stateright_tpu_torch.parallel.hashset import HashSet

    ap = cap.append
    if ap is None or cap.insert is None:
        raise AssertionError(f"{path}: no append or insert was captured")
    row = kernel_row(rows, path)
    fresh, origin, rr, gid, eb = (ap[k] for k in ("fresh", "origin", "rows",
                                                  "gid", "eb"))
    n, w, tail = ap["n"], rr.shape[1], ap["tail"]
    dev = fresh.device

    def logs():
        return (torch.zeros((n, w), dtype=torch.int32, device=dev),
                torch.zeros((n,), dtype=torch.int32, device=dev),
                torch.zeros((n,), dtype=torch.int32, device=dev))

    k, p, g = logs(), logs(), logs()
    kn = shard_log_append(fresh, origin, rr, gid, eb, *k, 0)
    pn = shard_log_append_plain(fresh, origin, rr, gid, eb, *p, 0)

    def glue():
        lanes = torch.nonzero(fresh).flatten()
        src = lanes if origin is None else origin[lanes].long()
        torch.index_select(rr, 0, src, out=g[0])
        torch.index_select(gid, 0, src, out=g[1])
        torch.index_select(eb, 0, src, out=g[2])

    glue()
    torch.cuda.synchronize()
    # Owners partition the states: one shard's log holds these rows there.
    held = [s for s in checker._shards
            if s.tail >= tail + n and torch.equal(s.rows[tail : tail + n], k[0])]
    if len(held) != 1:
        raise AssertionError(f"{path}: K28's rows are in {len(held)} shards' logs")
    sh = held[0]
    ran = (sh.rows[tail : tail + n], sh.parent[tail : tail + n],
           sh.ebits[tail : tail + n])
    if not all(torch.equal(x, y) for x, y in zip(k, ran)):
        raise AssertionError(f"{path}: K28 does not write what the run appended")
    err = max_abs_err(torch, [(kn, pn)] + list(zip(k, p)) + list(zip(k, g)))
    idx_words = 0 if origin is None else 1
    log(f"  shard_log_append [{path}]: the widest append, {n} fresh of "
        f"{fresh.shape[0]} lanes, {w} words a row, at tail {tail} of shard "
        f"{sh.index}, bit-equal to the twin, the glue and the run's log")
    row("shard_log_append", err,
        time_ms(torch, lambda: shard_log_append(fresh, origin, rr, gid, eb, *k, 0), 10),
        time_ms(torch, lambda: shard_log_append_plain(fresh, origin, rr, gid, eb,
                                                      *p, 0), 10),
        fresh.shape[0] + n * (4 * idx_words + 2 * (4 * w + 8)),
        library_ms=time_ms(torch, glue, 10))
    ins = cap.insert
    eng = ins["eng"]
    if path == "ts-sym12":
        from stateright_tpu_torch.parallel.canon import (
            canonicalize_rows, canonicalize_rows_plain,
        )

        spec = eng._compiled.canon_spec()
        flat = ins["rows"].contiguous()
        k15 = canonicalize_rows(spec, flat)
        p15 = canonicalize_rows_plain(spec, flat)
        torch.cuda.synchronize()
        row("canonicalize_rows", max_abs_err(torch, [(k15, p15)]),
            time_ms(torch, lambda: canonicalize_rows(spec, flat), 10),
            time_ms(torch, lambda: canonicalize_rows_plain(spec, flat), 2),
            flat.shape[0] * flat.shape[1] * 4 * 2)
        return
    if cap.cold is None:
        raise AssertionError(f"{path}: no cold filter was captured")
    phase_cold_kernels(torch, rows, path, SimpleNamespace(wave=cap.cold))
    ident = eng._identity(ins["rows"])
    k1 = device_fp64(ident)
    p1 = device_fp64_plain(ident)
    torch.cuda.synchronize()
    row("device_fp64", max_abs_err(torch, zip(k1, p1)) +
        max_abs_err(torch, zip(k1, (ins["hi"], ins["lo"]))),
        time_ms(torch, lambda: device_fp64(ident), 10),
        time_ms(torch, lambda: device_fp64_plain(ident), 2),
        ident.shape[0] * (4 * eng._fp_words + 8))
    log(f"  {path} owner insert: {int(ins['rv'].sum())} active receive lanes "
        f"into a {ins['keys'].shape[0]}-slot hot table")
    check_insert(torch, row, HashSet(ins["keys"]), ins["hi"], ins["lo"], ins["rv"])


# --- the fused wave loop (K29, phases 65-69) ----------------------------------

# The per-wave loop's warm seconds of these runs before the fused quantum
# (gpu_profile.py medians, H100 80GB HBM3 at 700 W: rm10 PR 12, paxos3 PR
# 6; PERF.md).
PER_WAVE_S = {"rm10": 0.273, "paxos3": 0.03405}


def profiled(torch, fn):
    """``fn()`` under ``torch.profiler``: ``(result, wall seconds, the
    card's busy seconds)`` -- the sum of the device-side events' own time
    (one stream)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    busy = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ) / 1e6
    return out, wall, busy


def rm10_geometry():
    return dict(capacity=CAPACITY, log_capacity=LOG_CAPACITY, max_frontier=F,
                dedup_factor=1)


def phase_fused_quantum(torch, fused_runs):
    """rm10 and paxos3 at the default ``waves_per_call`` (256) and at 1: the
    same logs and fingerprints, the readbacks counted; warm seconds and the
    card's idle share (one profiled run each) printed beside the per-wave
    loop's seconds of earlier PRs.  Fills ``fused_runs`` with the
    numbers."""
    from stateright_tpu_torch.models.twophase import TwoPhaseSys

    for path, build, kw, golden in (
        ("rm10", lambda: TwoPhaseSys(rm_count=RM).checker(), rm10_geometry(),
         GOLDEN_RM10),
        ("paxos3", lambda: paxos_model(3).checker(), PAXOS3_GEOMETRY,
         GOLDEN_PAXOS3),
    ):
        logs, fps = {}, {}
        for wpc in (None, 1):
            def spawn():
                return build().spawn_gpu(waves_per_call=wpc, **kw).join()

            spawn()  # warm: allocator pools, the first capture's loads
            torch.cuda.synchronize()
            t0 = time.monotonic()
            checker = spawn()
            secs = time.monotonic() - t0
            got = (checker.unique_state_count(), checker.max_depth())
            if got != golden:
                raise AssertionError(f"{path} at waves_per_call={wpc}: {got}")
            logs[wpc], fps[wpc] = card_logs(checker), device_fps(torch, checker)
            del checker
            checker, wall, busy = profiled(torch, spawn)
            fused_runs[path, wpc] = r = dict(
                seconds=secs, readbacks=checker._readbacks,
                waves=checker._waves_run, profiled_s=wall, busy_s=busy,
                idle_share=1 - busy / wall, captures=len(checker._capture_sec),
                capture_s=sum(checker._capture_sec),
            )
            log(f"  {path} waves_per_call={wpc or 256}: {secs:.4f} s warm, "
                f"{r['waves']} waves behind {r['readbacks']} readbacks, "
                f"{r['captures']} graph captures ({r['capture_s']:.4f} s); "
                f"profiled {wall:.4f} s, card busy {busy:.4f} s, idle share "
                f"{r['idle_share']:.3f}; the per-wave loop's "
                f"{PER_WAVE_S[path]} s (earlier PRs)")
            del checker
            torch.cuda.empty_cache()
        if not all(torch.equal(x, y) for x, y in zip(logs[None], logs[1])):
            raise AssertionError(f"{path}: the quantum's logs differ at 256 and 1")
        if not torch.equal(fps[None], fps[1]):
            raise AssertionError(f"{path}: fingerprints differ at 256 and 1")
        if fused_runs[path, None]["readbacks"] >= fused_runs[path, 1]["readbacks"]:
            raise AssertionError(f"{path}: the quantum read back as often as one "
                                 "wave a call")
        log(f"  {path}: logs and fingerprints equal at 256 and 1 waves a call")
        del logs, fps
        torch.cuda.empty_cache()


def phase_fused_growth(torch, want_fps):
    """rm10 with a 2**20-slot table: flag 1 falls inside a quantum (the
    quantum committed waves before the flagged one), the table grows x16
    twice, and the run ends at phase 4's fingerprints."""
    from stateright_tpu_torch.models.twophase import TwoPhaseSys
    from stateright_tpu_torch.runtime.journal import read_journal

    with tempfile.TemporaryDirectory() as tmp:
        journal = os.path.join(tmp, "j.jsonl")
        t0 = time.monotonic()
        checker = TwoPhaseSys(rm_count=RM).checker().spawn_gpu(
            journal=journal, **dict(rm10_geometry(), capacity=1 << 20)).join()
        elapsed = time.monotonic() - t0
        events = [e for e in read_journal(journal) if e["event"] == "wave"]
    got = (checker.unique_state_count(), checker.max_depth())
    if got != GOLDEN_RM10:
        raise AssertionError(f"rm10 grown {got} != {GOLDEN_RM10}")
    if not torch.equal(device_fps(torch, checker), want_fps):
        raise AssertionError("rm10 grown: fingerprints differ from phase 4's")
    inside = [
        e for i, e in enumerate(events) if e["flags"] & 1
        and e["unique"] > (events[i - 1]["unique"] if i else 1)
    ]
    if not inside or 1 not in checker._grow_flags:
        raise AssertionError(f"rm10 grown: no flag 1 inside a quantum "
                             f"({checker._grow_flags})")
    log(f"  rm10 from 2**20 slots: growths {checker._grow_notes}, flag 1 "
        f"inside a quantum at unique {[e['unique'] for e in inside]}, "
        f"{checker._readbacks} readbacks, {len(checker._capture_sec)} graph "
        f"captures, {elapsed:.3f} s; phase 4's fingerprints")
    del checker
    torch.cuda.empty_cache()


def phase_fused_finish_when(torch):
    """``2pc check 10`` under ``finish_when(ANY)``: the quantum stops at the
    wave of the first discovery, inside the quantum, with the discovery ids
    and counts of the one-wave-a-call run."""
    from stateright_tpu_torch.core.has_discoveries import HasDiscoveries
    from stateright_tpu_torch.models.twophase import TwoPhaseSys

    runs = {}
    for wpc in (None, 1):
        runs[wpc] = ck = TwoPhaseSys(rm_count=RM).checker().finish_when(
            HasDiscoveries.ANY).spawn_gpu(waves_per_call=wpc,
                                          **rm10_geometry()).join()
        log(f"  waves_per_call={wpc or 256}: discoveries "
            f"{dict(ck._discovery_slots)}, unique {ck.unique_state_count()}, "
            f"states {ck.state_count()}, {ck._waves_run} waves behind "
            f"{ck._readbacks} readbacks")
    a, b = runs[None], runs[1]
    if dict(a._discovery_slots) != dict(b._discovery_slots) or not a._discovery_slots:
        raise AssertionError("finish_when: the discovery ids differ")
    if (a.unique_state_count(), a.state_count()) != (
            b.unique_state_count(), b.state_count()):
        raise AssertionError("finish_when: the counts differ")
    if a._readbacks != 1 or a._waves_run >= 256:
        raise AssertionError("finish_when: the stop was not inside a quantum")
    del runs, a, b
    torch.cuda.empty_cache()


def phase_fused_stopped_waves(torch, fused_runs):
    """``2pc check 5`` in one quantum of 256 waves against one of exactly
    its wave count: warm medians of five, alternating, the 256 run within
    1.3x -- the waves after the stop cost nothing."""
    from stateright_tpu_torch.models.twophase import TwoPhaseSys

    geo = dict(capacity=1 << 15, max_frontier=1 << 12)  # no growth

    def spawn(wpc):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        ck = TwoPhaseSys(rm_count=5).checker().spawn_gpu(
            waves_per_call=wpc, **geo).join()
        return ck, time.monotonic() - t0

    probe, _ = spawn(256)
    n = probe._waves_run
    if probe._readbacks != 1 or (probe.unique_state_count(),
                                 probe.max_depth()) != GOLDEN_RM5[::2]:
        raise AssertionError(f"rm5 in one quantum: {probe._readbacks} readbacks")
    spawn(n)
    times = {256: [], n: []}
    for i in range(5):
        for wpc in ((256, n) if i % 2 == 0 else (n, 256)):
            ck, secs = spawn(wpc)
            if ck._waves_run != n or ck._readbacks != 1:
                raise AssertionError(f"rm5 at {wpc}: {ck._waves_run} waves")
            times[wpc].append(secs)
    med = {k: sorted(v)[2] for k, v in times.items()}
    ratio = med[256] / med[n]
    fused_runs["rm5-stop"] = dict(waves=n, median_256=med[256],
                                  median_n=med[n], ratio=ratio)
    log(f"  2pc check 5: {n} waves in one quantum; warm medians "
        f"{med[256]:.4f} s at 256 and {med[n]:.4f} s at {n} waves a call "
        f"(ratio {ratio:.3f}; runs {times})")
    if ratio > 1.3:
        raise AssertionError(f"a 256-wave quantum of {n} waves took {ratio:.2f}x")


def phase_fused_kernels(torch, rows, path, checker, geometry):
    """K29's two entries and the device-count entries of K1 (two-phase),
    K4, K8 and K25 against their twins on one real wave of the run,
    replayed from its log at the card's full chunk (:func:`replay_wave`;
    the lanes past the level inactive): bit-equal, timed, with bounds; the
    replayed wave appends what the run appended."""
    from stateright_tpu_torch.ops.device_fp import device_fp64
    from stateright_tpu_torch.ops.u32 import M32
    from stateright_tpu_torch.parallel import fused
    from stateright_tpu_torch.parallel.append import (
        append_block_dev, append_block_dev_plain,
    )
    from stateright_tpu_torch.parallel.hashset import (
        compact_valid, compact_valid_indices, insert_batch_claim_dev,
    )
    from stateright_tpu_torch.parallel.wave_common import NO_ID, compact, prop_kinds

    row = kernel_row(rows, path)
    cm = checker._compiled
    w, a = cm.state_width, cm.max_actions
    props = checker._properties
    p = len(props)
    carry = checker._carry
    (_states, start, _eb, _discovered, table, appended, level_end) = replay_wave(
        torch, checker, geometry, with_level_end=True)
    f = geometry["max_frontier"]
    count = min(f, level_end - start)
    disc = [d if d != NO_ID and d < start else NO_ID for d in carry.disc]
    words = [start, level_end, level_end, 0, 0, level_end, 0, 0] + disc
    words += [8, 1, 0, 0, 0, 0, 0]
    stats = torch.tensor([((x & M32) ^ 0x80000000) - 0x80000000 for x in words],
                         dtype=torch.int32, device=carry.rows.device)
    stats_bytes = 4 * stats.shape[0]

    # K29 wave_load: the chunk at the card's full width.
    k = fused.wave_load(carry.rows, carry.ebits, stats, f, w)
    q = fused.wave_load_plain(carry.rows, carry.ebits, stats, f, w)
    torch.cuda.synchronize()
    row("wave_load", max_abs_err(torch, zip(k, q)),
        time_ms(torch, lambda: fused.wave_load(carry.rows, carry.ebits, stats, f, w), 10),
        time_ms(torch, lambda: fused.wave_load_plain(carry.rows, carry.ebits, stats, f, w), 2),
        count * (4 * w + 4) + f * (4 * w + 4 + 1) + 8)
    states, eb_in, active = k
    del q
    log(f"  wave_load: {count} active lanes of the {f}-state chunk")

    # The model's step and conds, then K8's device entry.
    kinds = prop_kinds(props)
    size = unique_buffer_size_of(geometry, a)
    if checker._two_phase:
        conds, valid = cm.property_conds(states), cm.step_valid(states)
    else:
        _nexts, valid, conds, _flag = cm.expand(states)
    valid_g, eb, cands = check_wave_eval_dev(torch, row, conds, valid, eb_in,
                                             stats, active, kinds)

    if checker._two_phase:
        v_orig, v_act, n_valid = compact_valid_indices(valid_g.view(-1),
                                                       sort_lanes=size)
        cand_rows, _lane_flags = cm.step_lane(states, v_orig, n_valid)
        hi, lo = check_fp_n(torch, row, checker._identity(cand_rows), n_valid)
    else:
        cand_rows = _nexts.view(f * a, w)
        hi, lo, v_orig, v_act, n_valid = compact_valid(
            *device_fp64(checker._identity(cand_rows)), valid_g.view(-1),
            sort_lanes=size)

    # K4's device-epoch entry into the table as it stood, then the
    # wave's insert for what follows.
    check_insert_dev(torch, row, table, hi, lo, v_act)
    epoch = torch.tensor([7], dtype=torch.int32, device=stats.device)
    k_new, k_ok = insert_batch_claim_dev(table, hi, lo, v_act, epoch)
    n_new = int(k_new.sum())
    sel, n_new_d = compact(k_new, k_new.shape[0])

    # K29 wave_ctl: close the wave on copies of the stats.
    ctl_kw = dict(
        waves=8, f_eff=f, f_full=f, cap=table.capacity,
        qcap=carry.parent.shape[0], size=v_orig.shape[0],
        target=checker._options._target_max_depth or 0,
        fw_masks=checker._fw_masks,
    )
    step_flag = torch.zeros((), dtype=torch.bool, device=stats.device)
    closing = dict(n_new=n_new_d, n_valid=n_valid, probe_ok=k_ok,
                   step_flag=step_flag, dd_flag=None, cands=cands)
    ks, ps = stats.clone(), stats.clone()
    fused.wave_ctl(ks, p, begin=False, **closing, **ctl_kw)
    fused.wave_ctl_plain(ps, p, begin=False, **closing, **ctl_kw)
    torch.cuda.synchronize()
    ts = stats.clone()

    def reset():
        ts.copy_(stats)

    row("wave_ctl", max_abs_err(torch, [(ks, ps)]),
        time_ms(torch, lambda: fused.wave_ctl(ts, p, begin=False, **closing,
                                              **ctl_kw), 10, setup=reset),
        time_ms(torch, lambda: fused.wave_ctl_plain(ts, p, begin=False, **closing,
                                                    **ctl_kw), 2, setup=reset),
        2 * stats_bytes + 8 + 8 + 1 + 1 + 8 * p)
    kw_ = [int(x) & M32 for x in ks.tolist()]
    ctl0 = fused.STAT_DISC + p
    if kw_[fused.STAT_FLAGS] or kw_[ctl0 + fused.CTL_WAVE_NEW] != n_new:
        raise AssertionError(f"wave_ctl did not commit the replayed wave: {kw_}")
    log(f"  wave_ctl: committed {n_new} new states, level_start "
        f"{start} -> {kw_[fused.STAT_LEVEL_START]}, go {kw_[ctl0 + fused.CTL_GO]}")

    # K25's device entry from K29's record, into a scratch block at tail 0.
    rec = torch.tensor([start, 0, n_new], dtype=torch.int32, device=stats.device)

    def block():
        return (torch.zeros((n_new * w,), dtype=torch.int32, device=stats.device),
                torch.zeros((n_new,), dtype=torch.int32, device=stats.device),
                torch.zeros((n_new,), dtype=torch.int32, device=stats.device))

    kb, pb = block(), block()
    args = (sel, None, v_orig, cand_rows, eb, rec, a, checker._two_phase)
    append_block_dev(*kb, *args)
    append_block_dev_plain(*pb, *args)
    torch.cuda.synchronize()
    t = int(appended[0])
    ran = (carry.rows[t * w:(t + n_new) * w], carry.parent[t:t + n_new],
           carry.ebits[t:t + n_new])
    if appended.numel() != n_new or not all(torch.equal(x, y) for x, y in zip(kb, ran)):
        raise AssertionError(f"{path}: K25's device entry does not write what "
                             "the run appended")
    row("append_block_dev", max_abs_err(torch, zip(kb, pb)),
        time_ms(torch, lambda: append_block_dev(*kb, *args), 10),
        time_ms(torch, lambda: append_block_dev_plain(*pb, *args), 2),
        n_new * (4 * 2 + 8 * w + 12) + 12)
    log(f"  append_block(wave=): {n_new} new states, equal to the run's log "
        f"at {t}")


def unique_buffer_size_of(geometry, a):
    from stateright_tpu_torch.parallel.hashset import unique_buffer_size

    return unique_buffer_size(geometry["max_frontier"] * a,
                              geometry.get("dedup_factor", 8))


def main() -> int:
    use_one_card()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "stateright_tpu_torch")):
        print("chip_smoke: run from a checkout (stateright_tpu_torch/ is "
              "missing beside the script)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from stateright_tpu_torch.ops import cuda as kcuda

    t_start = time.monotonic()
    log("phase 1: build")
    t0 = time.monotonic()
    secs = kcuda.build()
    log(f"  built {sorted(secs)} in {time.monotonic() - t0:.1f}s "
        f"(per source: {', '.join(f'{k}={v:.1f}s' for k, v in secs.items())})")
    frames = ptxas_frames(kcuda.BUILD_DIR)
    local = {k: v for k, v in frames.items() if any(v)}
    log(f"  ptxas: {len(frames)} kernel entries, those with a stack frame or "
        f"spills (bytes of frame, spill stores, spill loads): {local}")
    gpu = gpu_line()
    log(f"  card: {gpu}; derived INT32 rate {int32_rate():.4g} ops/s "
        f"(132 SMs x 64 lanes x the maximum SM clock)")
    from stateright_tpu_torch.parallel.fused import cuda_versions

    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}; the kernels' CUDA runtime "
        f"and the driver (12090 = 12.9): {cuda_versions()}")

    log("phase 2: the 2pc check 10 path's kernels against their twins")
    rows = {}
    phase_kernels(torch, rows)
    torch.cuda.empty_cache()

    log("phase 3: 2pc check 5 on the card")
    phase_rm5(torch)

    log("phase 4: 2pc check 10 on the card")
    launches = {}
    launches["rm10"], checker = run_full(torch, gpu, "rm10", run_rm10)
    # Held against the traced run's (phase 48).
    rm10_counts = (checker.unique_state_count(), checker.state_count(),
                   checker.max_depth())
    rm10_logs, rm10_fps = card_logs(checker), device_fps(torch, checker)
    del checker
    torch.cuda.empty_cache()

    log("phase 5: paxos check 2 on the card")
    phase_paxos2(torch)

    log("phase 6: paxos check 3 on the card")
    launches["paxos3"], checker = run_full(torch, gpu, "paxos3", run_paxos3)
    # Held against the tiered runs'.
    paxos3_fps = checker.discovered_fingerprints()
    paxos3_counts = (checker.unique_state_count(), checker.state_count(),
                     checker.max_depth())

    log("phase 7: the paxos check 3 path's kernels against their twins on "
        "one of its waves")
    phase_paxos_kernels(torch, checker, rows, "paxos3", PAXOS3_GEOMETRY,
                        host_path="tr-paxos3")
    paxos3_logs = card_logs(checker)  # held against the bounded run's
    del checker
    torch.cuda.empty_cache()

    log("phase 8: paxos check 3, never decided, to the first violation")
    phase_never_decided(torch)

    log("phase 9: paxos check 6 to depth 6 on the card and on the CPU")
    phase_paxos6_prefix(torch)

    log("phase 10: paxos check 6 on the card")
    launches["paxos6"], checker = run_full(torch, gpu, "paxos6", run_paxos6)

    log("phase 11: the paxos check 6 path's kernels against their twins on "
        "one of its waves")
    phase_paxos_kernels(torch, checker, rows, "paxos6", PAXOS6_GEOMETRY)
    del checker
    torch.cuda.empty_cache()

    log("phase 12: the single-copy register, linearizable and not")
    phase_single_copy(torch)

    log("phase 13: single-copy-register check 4 on the card")
    launches["sc4"], checker = run_full(torch, gpu, "sc4", run_sc4)

    log("phase 14: the single-copy-register check 4 path's kernels against "
        "their twins on one of its waves")
    phase_sc4_kernels(torch, checker, rows)
    del checker
    torch.cuda.empty_cache()

    log("phase 15: the ABD register, check 2 on both fabrics and the "
        "skip_ack counterexample")
    phase_abd2(torch)

    log("phase 16: linearizable-register check 3 on the card")
    checker, elapsed = run_abd(torch, False, GOLDEN_ABD3)
    log(f"  abd check 3: unique={checker.unique_state_count()} "
        f"states={checker.state_count()} depth={checker.max_depth()} "
        f"waves={checker.waves()} elapsed_s={elapsed:.3f}")
    checker.assert_properties()
    del checker

    log("phase 17: linearizable-register check 3 ordered on the card")
    launches["abd3o"], checker = run_full(torch, gpu, "abd3o", run_abd3o)

    log("phase 18: the linearizable-register check 3 ordered path's kernels "
        "against their twins on one of its waves")
    phase_abd3o_kernels(torch, checker, rows)
    del checker
    torch.cuda.empty_cache()

    log("phase 19: raft to depth 6 and 10 on the card")
    phase_raft_prefix(torch)
    torch.cuda.empty_cache()

    log("phase 20: raft check (depth 12) on the card")
    held = torch.cuda.memory_allocated()  # earlier phases' tensors
    launches["raft"], checker = run_full(torch, gpu, "raft", run_raft,
                                         properties_hold=False)
    raft_peak = torch.cuda.max_memory_allocated() - held
    raft_fps = checker.discovered_fingerprints()  # held against the tiered run's
    phase_raft_election_safety(checker)
    phase_raft_other_chunking(torch, checker)

    log("phase 21: the raft check path's kernels against their twins on one "
        "of its waves")
    phase_raft_kernels(torch, checker, rows)
    del checker
    torch.cuda.empty_cache()

    log("phase 22: lossy ping-pong at max_nat 13 on the card, and its kernels "
        "against their twins on one of its waves")
    launches["pp13"], checker = run_full(torch, gpu, "pp13", run_pp13,
                                         properties_hold=False)
    checker._carry.table = None  # the replay rebuilds its own
    torch.cuda.empty_cache()
    phase_pp13_collisions(torch, checker)
    torch.cuda.empty_cache()
    phase_ping_pong_kernels(torch, checker, rows, "pp13", PP13_GEOMETRY)
    del checker
    torch.cuda.empty_cache()

    log("phase 23: lossy ping-pong at max_nat 11 through the sorted fallback, "
        "and its kernels (K25 on its widest sorted commit) against their "
        "twins on one of its waves")
    launches["pp11s"], checker = run_full(torch, gpu, "pp11s", run_pp11s,
                                          properties_hold=False)
    log(f"  pp11s growths: {checker._grow_notes}")
    # The untraced run commits inside its captured quanta: K25 is held on
    # the replayed sorted-path wave's commit.
    commit = phase_ping_pong_kernels(torch, checker, rows, "pp11s",
                                     PP11S_GEOMETRY)
    if commit["origin"] is None:
        raise AssertionError("pp11s: the replayed wave is not on the sorted path")
    phase_append_kernel(torch, rows, None, checker,
                        SimpleNamespace(wave=commit), dev_path="pp11s")
    del commit
    del checker
    torch.cuda.empty_cache()
    phase_prededup_fuzz(torch)

    log("phase 24: the reference's ping-pong goldens against the CPU runs")
    phase_ping_pong_goldens(torch)

    log("phase 25: bounded paxos, single-phase through K14")
    launches["paxos3b"], checker = run_full(torch, gpu, "paxos3b", run_paxos3b)
    phase_bounded_paxos(torch, checker, rows, paxos3_logs)
    del checker
    torch.cuda.empty_cache()

    log("phase 26: raft to depth 10 on the sorted path")
    launches["raft10s"], checker = run_full(torch, gpu, "raft10s", run_raft10s,
                                            properties_hold=False)
    log(f"  raft10s growths: {checker._grow_notes}")
    phase_raft_sorted(torch, checker, rows)
    del checker
    torch.cuda.empty_cache()

    log("phase 27: 2pc check-sym 12 on the card; rm=5 and rm=10 against "
        "the CPU runs")
    launches["sym12"], checker = run_full(torch, gpu, "sym12", run_sym12)
    phase_sym_smaller(torch)

    log("phase 28: K15 against its twin at size; the sym12 path's kernels, "
        "K15 among them, on one of its waves")
    phase_canon_kernel(torch)
    torch.cuda.empty_cache()
    phase_sym12_kernels(torch, checker, rows)
    del checker
    torch.cuda.empty_cache()

    log("phase 29: the LWW-register CRDT (SelectRandom) on the card")
    launches["lww"], checker = run_full(torch, gpu, "lww", run_lww)
    log(f"  lww growths: {checker._grow_notes}")
    phase_lww(torch, checker, rows)
    del checker
    torch.cuda.empty_cache()

    log("phase 30: the trap counter on the card")
    launches["trap"], checker = run_full(torch, gpu, "trap", run_trap,
                                         properties_hold=False)
    phase_trap(torch, checker, rows)
    del checker

    log("phase 31: 2pc rm=10 through spawn_gpu_simulation on the card (K18)")
    launches["sim-rm10"], _checker = run_walk_path(torch, gpu, "sim-rm10", run_sim_rm10)
    phase_sim_rm10(torch, rows)
    torch.cuda.empty_cache()

    log("phase 32: raft through spawn_gpu_simulation on the card")
    launches["sim-raft"], _checker = run_walk_path(torch, gpu, "sim-raft", run_sim_raft)
    _checker, elapsed = run_sim_raft_wide(torch)
    log(f"  raft at 2**16 walkers a round: {_checker.state_count()} states in "
        f"{_checker.rounds()} rounds, {elapsed:.3f} s "
        f"({_checker.state_count() / elapsed:.1f} states/s), found "
        f"{sorted(_checker.discoveries())}")
    phase_sim_raft(torch, rows)
    torch.cuda.empty_cache()

    log("phase 33: the ABD chaos ensemble on the card (K18 with K19)")
    launches["ens-abd"], result = run_walk_path(torch, gpu, "ens-abd", run_ens)
    phase_ens(torch, rows, result)
    del _checker, result
    torch.cuda.empty_cache()

    log("phase 34: tiered paxos check 3 on the card under a 2 MB budget "
        "(K20), against the in-HBM run")
    launches["tiered-paxos3"] = phase_tiered_paxos3(
        torch, gpu, rows, paxos3_logs, paxos3_fps)
    torch.cuda.empty_cache()

    log("phase 35: a mid-run tiered checkpoint of paxos check 3, resumed")
    phase_tiered_checkpoint(torch, paxos3_counts, paxos3_fps)
    torch.cuda.empty_cache()

    log("phase 36: 2pc check 5 tiered on the card against the CPU run")
    phase_tiered_rm5(torch)

    log("phase 37: tiered raft check on the card under a 64 MB budget, "
        "against the in-HBM run")
    launches["tiered-raft"] = phase_tiered_raft(torch, gpu, rows, raft_fps,
                                                raft_peak)
    del raft_fps
    torch.cuda.empty_cache()

    captured = {}
    log("phase 38: GridWalk widened 511 -> 1,023 through incremental_check "
        "(K21), and the verdict cache")
    launches["incr-grid"] = phase_incr_grid(torch, gpu, captured)
    torch.cuda.empty_cache()

    log("phase 39: 2pc rm=9 stored, the edited model re-evaluated over its "
        "row log (K2c, K22)")
    launches["incr-2pc"] = phase_incr_2pc(torch, gpu, captured)
    torch.cuda.empty_cache()

    log("phase 40: paxos check 3 widened from max_round=1")
    launches["incr-paxos3"] = phase_incr_paxos3(torch, gpu, paxos3_fps)
    torch.cuda.empty_cache()

    log("phase 41: K21, K2c and K22 against their twins on the re-check "
        "paths' inputs")
    phase_incr_kernels(torch, rows, captured)
    torch.cuda.empty_cache()

    log("phase 42: gang-grid, eight GridWalks at bounds 248-255 in one "
        "gang (K21g, K23, K1)")
    launches["gang-grid"] = phase_gang_grid(torch, gpu, captured)

    log("phase 43: gang-cap, eight CapCounters with mixed verdicts (K24)")
    launches["gang-cap"], launches["cap-solo"] = phase_gang_cap(
        torch, gpu, captured)

    log("phase 44: a gang of 5 GridWalks, padded to 8")
    phase_gang_of_5(torch, gpu)

    log("phase 45: a gang member ejected at F = 8")
    phase_gang_eject()

    log("phase 46: raft to depth 6 with an edited property_conds")
    phase_edited_raft(torch)

    log("phase 47: K21g, K23, K24 and K1 against their twins on the gangs' "
        "widest waves")
    phase_gang_kernels(torch, rows, captured)
    torch.cuda.empty_cache()

    log("phase 48: traced 2pc check 10 against phase 4's run, and K25 on "
        "its widest commit")
    launches["tr-rm10"] = phase_traced_rm10(torch, gpu, rows, rm10_counts,
                                            rm10_logs, rm10_fps)
    del rm10_logs
    torch.cuda.empty_cache()

    log("phase 49: traced paxos check 3 against phase 6's run, and K25 on "
        "its widest commit")
    launches["tr-paxos3"] = phase_traced_paxos3(torch, gpu, rows, paxos3_counts,
                                                paxos3_logs, paxos3_fps)
    del paxos3_logs
    torch.cuda.empty_cache()

    log("phase 50: traced tiered paxos check 3, with its cold_probe phase")
    phase_traced_tiered_paxos3(torch, gpu, paxos3_counts, paxos3_fps)
    torch.cuda.empty_cache()

    log("phase 51: a visitor on 2pc check 5")
    phase_visitor_rm5(torch)

    log("phase 52: paxos check 3 on four shards of the card (K26, K27), "
        "against phase 6's fingerprints")
    launches["sh-paxos3"], sh_paxos3, sh_paxos3_cap = phase_sh_paxos3(
        torch, gpu, GOLDEN_PAXOS3, paxos3_fps)
    torch.cuda.empty_cache()

    log("phase 53: 2pc check 10 on four shards of the card, against phase "
        "4's fingerprints")
    launches["sh-rm10"], sh_rm10, sh_rm10_cap = phase_sh_rm10(
        torch, gpu, GOLDEN_RM10, rm10_fps)
    rm10_fps = rm10_fps.cpu()  # held against phase 66's run
    torch.cuda.empty_cache()

    log("phase 54: paxos check 3 on a 1-shard mesh: the exchange elided")
    phase_sh1_paxos3(torch, gpu, GOLDEN_PAXOS3, paxos3_fps)
    torch.cuda.empty_cache()

    log("phase 55: paxos check 2 at 1/2/4/8 shards, and a forced bucket "
        "retry")
    phase_sh_paxos2(torch, gpu)

    log("phase 56: 2pc check-sym 12 on four shards")
    launches["sh-sym12"], sh_sym12, sh_sym12_cap = phase_sh_sym12(torch, gpu)

    log("phase 57: a mid-run checkpoint of sh-paxos3 resumed on four shards "
        "and refused on two")
    phase_sh_checkpoint(torch, GOLDEN_PAXOS3, paxos3_fps)
    torch.cuda.empty_cache()

    log("phase 58: K26, K27, K1, K4 and K12 against their twins on the "
        "sharded paths' widest waves (and K15 on sh-sym12's)")
    phase_shard_kernels(torch, rows, "sh-paxos3", sh_paxos3, sh_paxos3_cap)
    del sh_paxos3, sh_paxos3_cap
    torch.cuda.empty_cache()
    phase_shard_kernels(torch, rows, "sh-rm10", sh_rm10, sh_rm10_cap)
    del sh_rm10, sh_rm10_cap
    torch.cuda.empty_cache()
    phase_shard_kernels(torch, rows, "sh-sym12", sh_sym12, sh_sym12_cap)
    del sh_sym12, sh_sym12_cap
    torch.cuda.empty_cache()

    log("phase 59: traced paxos check 3 on four shards of the card, against "
        "phase 6's fingerprints")
    launches["tr-sh-paxos3"], tr_sh, tr_sh_cap = phase_tr_sh_paxos3(
        torch, gpu, paxos3_fps)
    torch.cuda.empty_cache()

    log("phase 60: traced paxos check 3 on a 1-shard mesh: the exchange elided")
    phase_tr_sh1_paxos3(torch, gpu, paxos3_fps)
    torch.cuda.empty_cache()

    log("phase 61: paxos check 3 tiered-sharded on four shards at 2 MB a "
        "shard (K20, K28), against phase 6's fingerprints")
    launches["ts-paxos3"], ts_paxos3, ts_paxos3_cap = phase_ts_paxos3(
        torch, gpu, paxos3_fps)
    torch.cuda.empty_cache()

    log("phase 62: 2pc check-sym 12 tiered-sharded on four shards at 1,024 "
        "slots a shard")
    launches["ts-sym12"], ts_sym12, ts_sym12_cap = phase_ts_sym12(torch, gpu)
    torch.cuda.empty_cache()

    log("phase 63: a ts-paxos3 checkpoint resharded 4 -> 2 and 4 -> 8, a "
        "plain sh-paxos3 one into tiered, each resumed")
    phase_ts_reshard(torch, GOLDEN_PAXOS3, paxos3_fps)
    del paxos3_fps
    torch.cuda.empty_cache()

    log("phase 64: K28 against its twin on the tiered-sharded paths' widest "
        "appends; K20, K1 and K4 on ts-paxos3's, K15 on ts-sym12's; K26 "
        "and K27 on tr-sh-paxos3's widest waves")
    phase_ts_kernels(torch, rows, "ts-paxos3", ts_paxos3, ts_paxos3_cap)
    del ts_paxos3, ts_paxos3_cap
    torch.cuda.empty_cache()
    phase_ts_kernels(torch, rows, "ts-sym12", ts_sym12, ts_sym12_cap)
    del ts_sym12, ts_sym12_cap
    phase_shard_kernels(torch, rows, "tr-sh-paxos3", tr_sh, tr_sh_cap)
    del tr_sh, tr_sh_cap
    torch.cuda.empty_cache()

    fused_runs = {}
    log("phase 65: the fused quantum: rm10 and paxos3 at 256 and at 1 wave "
        "a call")
    phase_fused_quantum(torch, fused_runs)

    log("phase 66: rm10 from a 2**20-slot table: flag 1 inside a quantum")
    phase_fused_growth(torch, rm10_fps.to("cuda"))
    del rm10_fps
    torch.cuda.empty_cache()

    log("phase 67: finish_when(ANY) inside a quantum")
    phase_fused_finish_when(torch)

    log("phase 68: 2pc check 5 in a 256-wave quantum and in one of its own "
        "wave count")
    phase_fused_stopped_waves(torch, fused_runs)

    log("phase 69: K29 and the device-count entries of K1, K4, K8 and K25 "
        "against their twins on replayed waves of rm10 and paxos3")
    checker, _elapsed = run_rm10(torch)
    phase_fused_kernels(torch, rows, "rm10", checker, rm10_geometry())
    del checker
    torch.cuda.empty_cache()
    checker, _elapsed = run_paxos3(torch)
    phase_fused_kernels(torch, rows, "paxos3", checker, PAXOS3_GEOMETRY)
    del checker
    torch.cuda.empty_cache()
    log(f"  fused runs: {json.dumps({str(k): v for k, v in fused_runs.items()})}")

    log("phase 70: paxos check 2 on four shards on the sorted path: K12's "
        "prefix entry on the senders, its mask entry on the owners")
    launches["sh-paxos2s"] = phase_sh_sorted(torch, gpu, rows)
    torch.cuda.empty_cache()

    log("phase 71: K26, K20's probe, K4 and K27 against their twins on "
        "fuzzed inputs")
    phase_bucket_fuzz(torch)
    torch.cuda.empty_cache()
    phase_cold_probe_fuzz(torch)
    torch.cuda.empty_cache()
    phase_insert_fuzz(torch)
    torch.cuda.empty_cache()
    phase_commit_fuzz(torch)
    torch.cuda.empty_cache()

    log(f"all phases passed in {time.monotonic() - t_start:.1f}s")
    kernels = []
    for path, names in PATH_KERNELS.items():
        for name in names:
            r = rows[name, path]
            source, replaces = KERNELS[name]
            kernels.append(dict(
                name=name, path=path, route=r["route"], source=source,
                replaces=replaces,
                launches=launches[path][name],
                max_abs_err=r["max_abs_err"], bit_equal=r["bit_equal"],
                ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=r["library_ms"],
                **{k: r[k] for k in ("rotating_ms",) if k in r},
            ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
