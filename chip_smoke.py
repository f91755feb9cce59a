#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``). Imports nothing of JAX.
Phases, in order; any failure exits nonzero and prints no result:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build every kernel from ``byzantinerandomizedconsensus_tpu_torch/csrc``
   (``fused_round``, ``keys_step``, ``urn_step``; one ``nvcc`` each, in
   parallel) and print each one's ptxas registers, for ``fused_round`` per
   (protocol, adversary) instantiation;
3. ``fused_round`` against its plain torch version on the card, on a grid
   of small configs (every init law, both coins, capped instances; both
   protocols under every static adversary, up to n=1024) and at config4's
   shape, with tolerance 0: the outputs are integers drawn from one
   counter-based PRF, so they must be identical;
4. the fused main path: preset config4, all 100,000 instances, through
   ``get_backend("torch")``, held against the reference histograms; its
   throughput, best of 5 after a warm-up; the kernel's and the plain
   version's times on the main path's inputs, and the kernel's bound;
5. ``keys_step`` and ``urn_step`` against their plain versions, tolerance
   0: per broadcast step through the real round body on a grid (n in
   4..1024, adversary none / adaptive / adaptive_min, every init, both
   coins, rounds 0 and 1), then per driver, the step path against the plain
   path to termination;
6. the per-step main path: config 5's sweep point at n=512 (bracha, f=170,
   adaptive, shared coin, 2000 instances) under delivery keys and under
   urn, through ``get_backend("torch", kernel="step")``, held per instance
   against the committed reference results (``artifacts/sweep_keys``,
   ``artifacts/sweep_urn``); the four goldens of ``spec/golden/golden.npz``
   on this surface through the kernels; throughput, best of 5 after a
   warm-up; each kernel's device time per launch (launches captured in a
   CUDA graph, its replay timed, so the wrapper's host path is left out)
   beside its wrapper time (back-to-back calls), launches per run, and bound
   per launch, counted from each launch's planes (keys_step's from the
   crossing-class pairs, with their fraction of all pairs and the earlier
   all-pairs design's cost beside it; urn_step's from the receivers with
   D > 0 and the draws the law needs, with the earlier count beside it),
   failing if a kernel beats its bound; the ptxas report of each; and the
   plain path's time;
7. the other BASELINE configurations as shipped, through
   ``get_backend("torch")`` and so through ``fused_round``: config1,
   config2 and config3 against the decision and full round histograms of
   the reference's product run (``artifacts/product_r5.json``), config 5
   under its own urn2 law at every n of the sweep (8 × 2000 instances)
   per instance against ``artifacts/sweep_urn2/``, and the four urn2
   goldens; for each configuration its throughput (best of 3 after a
   warm-up: cut from 5 when phase 9 came), the kernel's time (CUDA events
   around 3 launches, the adversary's planes built beforehand) beside the
   wrapper's and its
   launches, the plain version's time, the bound counted from the plain
   version's work counters, and the instantiation's ptxas registers,
   failing if the kernel beats its bound;
8. the §9 fault schedules (recover, partition, omission) through
   ``fused_round``: the kernel against its plain version on a grid (both
   protocols, every static adversary, n in 13..1024, both coins, capped
   instances); the port's divergence tool's fault grid
   (``tools/divergence.py::fault_row`` over its ``FAULT_GRID``: four
   configs at 400 instances under each kind and without one, through
   ``get_backend("torch")``) against the ``fault_rows`` of
   ``artifacts/divergence_r23.json``; and config4 under each kind at
   100,000 instances through ``get_backend("torch")``, instances 0-1999
   per instance against ``artifacts/sweep_faults/``, all of them against
   the plain version on the card, each with its throughput, the kernel's,
   the wrapper's, the planes' and the plain version's times and the bound;
9. past n = 1024: the §4c urn3 law, the §10 committee family and the §2
   v2/v3 packing laws through ``fused_round`` (its wide kernel,
   ``csrc/fused_round_wide.cuh``): the kernel against its plain version on
   a grid (urn3 and committee × both protocols × every static adversary ×
   every §9 schedule, every init, both coins, capped instances, n from 4 to
   1024, in (1024, 4096] and, for committee, up to 2^20); the committee
   cost curve of ``artifacts/committee_r19.json`` (n = 2048 … 131,072 and
   its urn2/urn3 baselines, at its instance counts, against its
   aggregates), then the committee legs at 2000 instances against plain;
   ``committee_point(8192)`` and ``committee_point(131072)`` (ids 0-255 per
   instance against ``artifacts/sweep_committee/``, all 2000 against
   plain); config 5's shape at n = 2048 under urn2 and urn3 against
   ``artifacts/n2048_r7.json``; config1-5 under urn3 against the
   ``preset_rows`` of ``artifacts/divergence_r6.json``, and config4 under
   urn3 at 100,000 instances against plain; each timed cell as in phase 7;
10. the keys and urn laws over the per-config surface: ``keys_step`` and
   ``urn_step`` against their plain versions at every step of a grid (both
   protocols × every static adversary × both coins, n 4 to 4096: packing
   laws v1 and v2, Ben-Or's Byzantine equivocation and two-faced rows);
   config1-5 under §4b urn through ``fused_round`` (its libraries
   ``fused_round_urn_r1`` and ``_r4``) and through ``urn_step``, both
   against the histograms of ``artifacts/product_r4.json`` and against
   each other per instance; config1-4 under keys through ``keys_step``,
   ids 0-255 against ``artifacts/sweep_keys_shipped/`` and against the plain
   path on the card (config2 and config4: ids 0-1999), and Ben-Or's Byzantine pairing
   (n=64, f=12) under keys and urn against its records there; the 15 rows
   of ``artifacts/divergence_r5.json`` under keys and under urn (both
   kernels); the two urn rows of ``artifacts/fused_r20.json`` and config
   5's shape under urn at n = 2048 and 4096 against plain; each timed cell
   (config2-4 under both laws, config 5 at n = 4096 under urn through
   ``fused_round``) with its walls, the kernel's device time (a per-step
   run's launches in one CUDA graph), the plain version's time, the bound
   and kernel/bound, failing if a kernel beats its bound;
11. the replica-sharded path (``parallel/sharded.py``): ``keys_step`` and
   ``urn_step`` on receiver ranges against their plain versions and their
   own full width at every step of a grid (n = 16 in the ranges 0-4, 5-10,
   11-15, both protocols × every static adversary; n = 2048 in four
   shards); config4 under keys and under urn at 100,000 instances through
   ``TorchShardedBackend(kernel="step")`` on the layouts (1, 4) and (2, 2),
   four shards of the one card, per instance against the unsharded step
   run and on ids 0-1999 against plain; the two
   ``sharded_bitmatch_virtual_2x2_n2048`` legs of ``artifacts/n2048_r7.json``
   through ``virtual:2x2`` and the (2, 2) mesh's plain path against the
   unsharded run; config4 through the mesh with ``kernel="fused"`` (data
   axis only) against the unsharded fused run; timed at (1, 4): the walls,
   each kernel's device time a sharded run and a launch at n_recv = 128
   against its bound for that shard, and the barrier overhead (the wall
   less the kernel time);
12. the config-5 sweep and the bit-match check through the CLI a user
   calls: ``cli sweep`` on the card at config 5's full size (8 n × 2000
   instances, 32 shards of 500) into an empty directory, every shard equal
   to ``artifacts/sweep_urn2/``'s file of the same name, with its walls,
   shards/s, instances/s and the sums over its shards of K1's time and of
   the wrapper's (planes and K1); the
   same sweep again (no launch, the same points), then with one shard
   deleted (that shard's launches alone); ``cli bitmatch`` of config4
   against the C++ core (``--arbiter native``, 300 samples) under urn2
   (``fused_round``), keys (``keys_step``) and urn with ``--kernel step``
   (``urn_step``), and against the object oracle (``--arbiter cpu``) on
   config1 and a Bracha n = 16 config, each rc 0; ``cli run --counters
   --kernel plain`` on the card equal to the CPU's, and under
   ``fused_round`` the unsupported block;
13. the lane runners (``backends/batch.py``, ``backends/compaction.py``,
   ``backends/lanestate.py``) on the plain round driver, which launches no
   kernel (counted: 0 launches of each in every lane run): a strict
   bucket of 16 Bracha n = 64 urn2 crash configs and a mixed-n set of 16
   padded to tier 64 through ``run_batch`` twice (1 build, then 0 new
   entries), every lane per instance against its per-config
   ``fused_round`` run, the walls beside 16 per-config plain runs and 16
   per-config K1 runs; 40 fused ``superset`` configs over both protocols,
   every adversary, schedule, coin and init, n 4-40, caps 64-256, through
   ``run_fused`` without and with compaction, each against its K1 run;
   config4 at 100,000 instances through ``run_many(compaction=)`` against
   K1 per instance, with its wall beside the plain per-chunk run's and
   K1's and its compaction block; config4 at ids 0-19,999 parked by
   ``LaneControl`` at the first boundary after a refill, its records
   round-tripped through JSON and resumed in a fresh grid, equal to the
   uninterrupted run; ``cli sweep --batched --kernel plain`` at config 5's
   full size, its 32 shards equal to ``artifacts/sweep_urn2/``, and
   without ``--kernel plain`` the lane runner's refusal;
14. the consensus server (``serve/server.py``): (a) the direct leg,
   ``ConsensusServer(get_backend("torch"), round_cap_ceiling=256)`` behind
   ``serve_http`` on an ephemeral port, driven over HTTP (``POST /submit``,
   ``POST /cancel``, ``GET /result/<id>``, ``POST /run``): config4 at
   100,000 instances (K1), config4 under keys and config 5's n = 512 point
   under keys (K2), config2 under urn (K1 ``urn_r1``),
   ``committee_point(8192)`` (K1 ``committee_r0``), a 4-slot session of
   config3, config3 with ``check_invariants`` (checked on the card) and
   config1 cancelled while queued; every reply equal to
   ``get_backend("torch").run`` per instance, config4 to the reference
   histograms, the session to ``run_session``; K1 and K2 launched by the
   server, no kernel library built after the warm-up; then a
   ``kernel="step"`` server on config 5's n = 512 point under urn (K3);
   (b) the lane leg (``kernel="plain"``, policy ``width=4096,segment=1``):
   phase 13's strict bucket streamed through the live feed, then its
   mixed-n set, twice (the second pass builds no lane program), 0 kernel
   launches, each reply per instance equal to its per-config K1 run; a
   preemption park and resume of config4 at 20,000 instances around a
   deadline-urgent arrival; the same request's live lanes exported from one
   server and imported into another; (c) ``cli serve --wal DIR`` in a
   subprocess, SIGKILLed with four replies owed (config4 under keys first),
   restarted with ``--recover DIR``: every ``GET /result/<original id>``
   equal to the offline run; with per-request latency, queue wait and
   service time, and the served throughput beside the offline walls;
15. the serving fleet (``serve/fleet.py``): two worker processes on
   ``cuda:0``, each a ``ConsensusServer`` on the direct leg, each with its
   time to ready and CUDA memory; a warm-up of each worker, then phase 14's
   burst through the fleet (K1 and K2; config1 cancelled while queued),
   every reply equal to the offline run, config4 to the reference
   histograms, no kernel library loaded after the warm-up, each request's
   latency, queue wait and service time beside phase 14's one server; the
   worker holding config4 under keys SIGKILLed mid-run, its requests back
   from the survivor under their ids, equal, and a replacement within the
   respawn budget; ``Autoscaler.tick`` on an injected clock, one ``up`` and
   one ``down`` that retires a worker with none lost; each worker's kernel
   census (registers, shared memory and launch shape per instantiation
   launched, from the ptxas report); a ``kernel="step"`` fleet on config
   5's n = 512 point under urn (K3); ``cli serve --workers 2`` over HTTP
   (/run, /stats with the workers' legs and a parent that never brought
   CUDA up, /healthz);
16. the load drivers (``tools/loadgen.py``, ``tools/hostile.py``,
   ``tools/soak.py``) through the entry points a user calls: (a) the
   stream digest of seed 15 against ``artifacts/serve_fleet_migrate_r23.json``;
   (b) ``cli loadgen --device cuda`` at the reference's defaults (seed 14,
   200 requests, rate 4/s) on the direct leg, K1 and K2 counted (per
   library from the kernel census), 0 steady-state builds, every reply and
   session replay equal to the plain driver; (c) its first 24 requests on
   the lane leg (``--kernel plain``, 0 launches), each reply equal to
   (b)'s; (d) ``--kernel step`` (K2 and K3); (e) ``--workers 1,2``, the
   fleet differential; (f) ``--scenario all`` at full size (a 429, fairness,
   0 mismatches, 0 steady builds), ``--scenario elastic --smoke`` and
   ``--scenario preempt --smoke --kernel plain``; (g) the classic soak of
   120 configs (the kernels against the C++ core and the object oracle),
   ``cli chaos --configs 16 --jobs 4 --liveness`` and the crash drill;
17. (alone, after phase 16's processes have ended) the adversary hunter
   (``hunt/``) through ``cli hunt``, each hunt's archive held digest for
   digest against the reference's hunts of
   ``artifacts/hunt_port/reference.json``: (a) the defaults (evolution,
   seed 17, budget 500, generation 16, archive 8) on the direct leg, K1
   and K2 counted per library from the kernel census, pipelined and then
   the barriered control, without the per-reply invariant checks, with 0
   builds after the warm-up, every archive entry replayed on the card and
   the rediscovery pin against the config4 baseline; then the same hunt's
   first 64 evaluations with every reply's invariants checked on the card,
   pipelined and barriered; (b) each archive entry of (a) and of (d)
   through the kernel by law and the plain driver on the card, per
   instance, and its safety invariants, and each library the hunts
   launched that no entry reached on the warm-up's config for it; (c) one
   small hunt in process, on the lane leg (``--kernel plain``, 0
   launches) and with ``--url`` against a ``cli serve`` subprocess; (d)
   ``--committee-scale``;
18. a ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import pathlib
import re
import subprocess
import sys
import time
import types

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

# The reference result of config4 (seed 0, 100,000 instances): the JAX
# package's ``cli run --preset config4 --hist``, identical on a TPU v5e and a
# CPU (artifacts/product_r5.json["config4"]).
CONFIG4_DECISIONS = [47697, 52303, 0]
CONFIG4_ROUNDS_HEAD = [0, 57987, 42008, 5]
METRIC = "consensus_instances_per_sec@n512_f170_shared_coin"
# Config 5 at n=512 under the keys and urn laws: the JAX package's sweep
# results, per instance (seed 0, 2000 instances).
SWEEP_FILES = {
    "keys": "artifacts/sweep_keys/bracha_n512_f170_adaptive_shared_s0_i*.npz",
    "urn": "artifacts/sweep_urn/bracha_n512_f170_adaptive_shared_urn_s0_i0-2000.npz",
}
CONFIG5_DECISIONS = [890, 1110, 0]
CONFIG5_ROUNDS_HEAD = [0, 73, 1927]
# The reference's run of every BASELINE configuration as shipped (seed 0,
# urn2, round cap 256): decision and full round histograms per preset.
PRODUCT_FILE = "artifacts/product_r5.json"
# Config 5 under its own urn2 law: the reference's per-instance results for
# every n of the sweep, four shard files each.
SWEEP_URN2_FILES = "artifacts/sweep_urn2/bracha_n{n}_f*_adaptive_shared_urn2_s0_i*.npz"
# The urn2 goldens of spec/golden/golden.npz (configs of spec/golden/regen.py).
URN2_GOLDENS = {
    "urn2_benor_byz": dict(protocol="benor", n=16, f=3, adversary="byzantine",
                           coin="local", seed=9),
    "urn2_bracha_crash": dict(protocol="bracha", n=10, f=3, adversary="crash",
                              coin="shared", seed=10),
    "urn2_bracha_adaptive": dict(protocol="bracha", n=13, f=4, adversary="adaptive",
                                 coin="shared", seed=11),
    "urn2_bracha_adaptive_min": dict(protocol="bracha", n=13, f=4,
                                     adversary="adaptive_min", coin="shared", seed=12),
}
# fused_round's instantiations, by the template arguments of its entry.
FUSED_PROTOCOLS = ("benor", "bracha")
FUSED_ADVERSARIES = ("none", "crash", "byzantine", "adaptive", "adaptive_min")
FUSED_FAULTS = ("none", "recover", "partition", "omission")
FAULT_KINDS = FUSED_FAULTS[1:]
# Config4 under each §9 fault schedule: the JAX package's per-instance
# results for instances 0-1999 (artifacts/sweep_faults/make_reference.py).
SWEEP_FAULTS_FILE = "artifacts/sweep_faults/bracha_n512_f170_none_shared_urn2_{kind}_s0_i0-2000.npz"
# The divergence tool's fault leg: the four configs of the port's
# tools/divergence.py FAULT_GRID, each run at 400 instances without a
# schedule and under each kind, against the committed rows.
DIVERGENCE_FILE = "artifacts/divergence_r23.json"
DIVERGENCE_INSTANCES = 400
# Phase 9's references: the committee cost curve (tools/cost_curve.py
# --committee-r19 of the JAX package: its committee legs and its urn2/urn3
# baselines), config 5's shape at n=512, 1024 and 2048 under urn2 and urn3,
# the divergence tool's preset rows under urn3, and committee_point's
# per-instance results (artifacts/sweep_committee/make_reference.py).
COMMITTEE_R19_FILE = "artifacts/committee_r19.json"
N2048_FILE = "artifacts/n2048_r7.json"
DIVERGENCE_R6_FILE = "artifacts/divergence_r6.json"
SWEEP_COMMITTEE_FILE = "artifacts/sweep_committee/bracha_n{n}_f{f}_adaptive_shared_committee_s0_i0-256.npz"
# The aggregates of a leg that a run must reproduce exactly.
LEG_FIELDS = ("decision_histogram", "mean_rounds_decided", "max_rounds", "rounds_p50",
              "rounds_p90", "rounds_p99")
# committee_point's instance count, and the (instance, replica) pairs of one
# chunk of the plain version in phase 9 (int64 planes of 128 MB).
COMMITTEE_INSTANCES = 2000
PHASE9_PLAIN_PAIRS = 1 << 24
INITS = ("random", "all0", "all1", "split")
# Phase 10's references: the reference's product run of config1-5 under the
# §4b urn law (decision and round histograms, mean rounds of the decided),
# the divergence tool's 15 rows under keys and urn, the per-instance records
# of config1-4 under keys and of a Ben-Or Byzantine configuration
# (artifacts/sweep_keys_shipped/make_reference.py), and the two urn rows of
# the reference's fused-kernel record (artifacts/fused_r20.json, its keys).
PRODUCT_URN_FILE = "artifacts/product_r4.json"
DIVERGENCE_R5_FILE = "artifacts/divergence_r5.json"
SWEEP_KEYS_SHIPPED_FILE = ("artifacts/sweep_keys_shipped/{protocol}_n{n}_f{f}_{adversary}_"
                           "{coin}_{delivery}_s0_i0-{hi}.npz")
BENOR_BYZANTINE = dict(protocol="benor", n=64, f=12, instances=256, adversary="byzantine",
                       coin="local")
FUSED_R20_URN_ROWS = (
    dict(protocol="benor", n=8, f=1, instances=12, adversary="crash", coin="shared",
         round_cap=32, seed=0),
    dict(protocol="benor", n=12, f=2, instances=8, adversary="adaptive_min", coin="shared",
         round_cap=48, seed=0, faults="partition"),
)
# The widths of phase 10's per-step grid: packing law v1 up to 256, v2 at
# 1100 and 4096; instances per config and round cap there.
LAW_GRID = ((4, 16), (64, 16), (256, 8), (1100, 4), (4096, 2))
LAW_GRID_ROUNDS = 2
# The plain version under keys on ids 0..PLAIN_KEYS_IDS-1 of a larger run:
# its (B, n, n) keys make config4's 100,000 instances take minutes, and
# config2's 10,000 about a minute with its timed cell.
PLAIN_KEYS_IDS = 2000

# Phase 11, the replica-sharded path on one card: the layouts config4 runs
# on (four shards of the card each), the one timed, the receiver ranges of
# the per-step grid (n = 16, not aligned with the kernels' tiles, one
# across the two-faced class boundary 8) and its v2 width in four shards,
# and the plain version's ids.
MESH_LAYOUTS = ((1, 4), (2, 2))
MESH_TIMED = (1, 4)
MESH_DEVICES = 4
OFFSET_RANGES = ((0, 5), (5, 11), (11, 16))
OFFSET_V2_N, OFFSET_V2_MODEL = 2048, 4
MESH_PLAIN_IDS = 2000

# The goldens of spec/golden/golden.npz on the per-step surface, with the
# configs of spec/golden/regen.py (delivery "keys" is SimConfig's default).
GOLDENS = {
    "bracha_adaptive": dict(n=13, f=4, adversary="adaptive", seed=3, delivery="keys"),
    "bracha_adaptive_min": dict(n=13, f=4, adversary="adaptive_min", seed=7,
                                delivery="keys"),
    "urn_bracha_adaptive": dict(n=13, f=4, adversary="adaptive", seed=6, delivery="urn"),
    "urn_bracha_adaptive_min": dict(n=13, f=4, adversary="adaptive_min", seed=8,
                                    delivery="urn"),
}

# H100 SXM peaks for the bound: HBM3 at 3.35 TB/s (NVIDIA data sheet). For
# integer work, each of an SM's 4 schedulers issues one 32-lane warp
# instruction per clock: 64 lanes of INT32 ALU plus the FMA pipe, which runs
# IMAD (Hopper white paper), so at most 128 lane-operations per SM per clock,
# x 132 SMs x 1.98 GHz boost. A bound must not exceed the least time, so it
# takes this issue peak rather than the 64-lane INT32 rate alone.
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 128 * 1.98e9
# Integer operations per unit of work, counted from the .cuh sources:
# a threefry word (prf.cuh) is 20 rounds of (add, rotate, xor), 5 key
# injections of two adds and the two initial adds; a urn2 chain draw
# (fused_round.cuh) is the LCG multiply-add, the shift-xor, the range
# reduction (shift, subtract, multiply, shift) and the compare-and-add.
OPS_PER_PRF_WORD = 20 * 3 + 5 * 2 + 2
OPS_PER_CHAIN_DRAW = 9
# A §4c cheap-law segment (fused_round.cuh::cheap): at least the nibble's
# shift and mask, its popcount, the mean's two multiplies, add and divide,
# the support's two subtracts, max and min, and the clamp's max and min.
OPS_PER_CHEAP_SEGMENT = 12
# Where the wide kernel keeps the state words in device memory (layout 0,
# n > 4096), each round reads and writes each word at least once.
SCRATCH_BYTES_PER_REPLICA_ROUND = 8
# The Byzantine adversary's PRF words per faulty sender and round: one per
# step under Bracha (3 steps), two per step under Ben-Or's two-faced pairing
# (2 steps), whatever the data.
BYZ_WORDS_PER_ROUND = {"bracha": 3, "benor": 4}
# The keys law: a receiver row needs one threefry word for each sender of
# its crossing class, the class (silent, bias) in which the n - f threshold
# falls, other than itself (crossing_pairs, counted from each launch's
# planes), and about one compare for each of those keys to pick the
# threshold among them; every other class is selected whole or not at all
# from its count, which takes one pass over the senders per class table
# (two under adaptive, where the bias depends on the receiver's preference).
# The key assembly and the tally are left out, so the bound stays a least
# time. The earlier design hashed every pair and ran 22 search passes of a
# compare and an add per pair: that cost is printed beside the bound and not
# counted in it.
OPS_PER_KEY = 1
SEARCH_OPS_PER_KEY_PAIR = 22 * 2
# The urn law: a receiver with D > 0 needs one threefry word. A draw of the
# adaptive family's biased phase is at least the LCG multiply-add, a shift,
# an xor-and-mask, a high multiply, one compare and one decrement (the
# kernel's own loop trades the high multiply for a shift and a full-rate
# multiply: 7); a single-stratum draw adds a compare and a decrement. Two
# strata need min(D, B0) draws per receiver (the tail needs no random
# word), one stratum D (urn_draws, counted from each launch's planes). The
# earlier design's count, one threefry word per receiver and 10 operations
# for each of D draws, is printed beside the bound and not used.
OPS_PER_URN_DRAW = 6
OPS_PER_SINGLE_URN_DRAW = 8
EARLIER_OPS_PER_URN_DRAW = 10
# Device time per launch: this many launches captured in one CUDA graph,
# whose replay is timed by CUDA events, so the wrapper's host path is left out.
GRAPH_LAUNCHES = 20

STEP_LAWS = {"keys": "keys_step", "urn": "urn_step"}
STEP_REPLACES = {"keys_step": "byzantinerandomizedconsensus_tpu/ops/pallas_tally.py:326",
                 "urn_step": "byzantinerandomizedconsensus_tpu/ops/pallas_urn.py:291"}


# Phase 12: config 5's sweep through ``cli sweep`` (the reference's own
# checkpoint directory at full size, 8 n x 4 shards of 500), the shard a
# resumed sweep recomputes after its deletion, the bit-match check through
# ``cli bitmatch`` against the C++ core (law, extra flags, the kernel it runs,
# label, samples) and against the object oracle, and the counted run's size.
SWEEP_URN2_DIR = "artifacts/sweep_urn2"
SWEEP_SHARD = 500
SWEEP_DELETED = (640, 1000)
BITMATCH_NATIVE = (("urn2", [], "fused_round", "", 300),
                   ("keys", [], "keys_step", "", 300),
                   ("urn", ["--kernel", "step"], "urn_step", " --kernel step", 300))
BITMATCH_ORACLE = (
    (["--preset", "config1", "--samples", "24", "--arbiter", "cpu"], "config1 vs cpu"),
    (["--protocol", "bracha", "-n", "16", "-f", "5", "--instances", "64", "--adversary",
      "adaptive", "--coin", "shared", "--delivery", "urn2", "--samples", "24", "--arbiter",
      "cpu"], "bracha n=16 f=5 adaptive urn2 vs cpu"),
)
COUNTER_INSTANCES = 200


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, launches: int = GRAPH_LAUNCHES, replays: int = 5) -> float:
    """Device time of one ``fn()`` (a kernel launch on the current stream):
    ``launches`` calls captured in one CUDA graph, the graph's replay timed by
    CUDA events, the mean over ``replays`` replays divided by ``launches``.
    Each call's outputs are kept for the graph's life, so the launches write
    to distinct memory and not again and again to the same lines of L2."""
    fn()  # warm-up outside the capture
    torch.cuda.synchronize()
    graph, outs = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for _ in range(launches):
            outs.append(fn())
    graph.replay()
    torch.cuda.synchronize()
    ms = cuda_ms(graph.replay, replays) / launches
    del graph, outs
    return ms


def ptxas_summary(name: str) -> str:
    """Registers and spills of the current build of ``name``, from its
    ``ptxas -v`` report."""
    from byzantinerandomizedconsensus_tpu_torch.ops import _build

    return " / ".join(line.split("info    : ")[-1].strip()
                      for line in _build.build_log(name).splitlines()
                      if "registers" in line or "spill" in line)


def fused_ptxas(lib: str = "fused_round") -> dict:
    """``{(protocol, adversary, faults): "N registers, S bytes spill stores,
    L bytes spill loads"}`` of the current build of the fused round library
    ``lib`` (``fused_round`` or a wide one), one entry per instantiation,
    from its ``ptxas -v`` report."""
    from byzantinerandomizedconsensus_tpu_torch.ops import _build

    out, key = {}, None
    for line in _build.build_log(lib).splitlines():
        m = re.search(r"fused_round(?:_wide)?_kernelILi(\d)ELi(\d)ELi(\d)E", line)
        if m and ("Compiling entry" in line or "Function properties" in line):
            key = (FUSED_PROTOCOLS[int(m.group(1))], FUSED_ADVERSARIES[int(m.group(2))],
                   FUSED_FAULTS[int(m.group(3))])
            out.setdefault(key, [])
        elif "Compiling entry" in line or "Function properties" in line:
            key = None
        elif key is not None and ("registers" in line or "spill" in line):
            out[key].append(line.split("info    : ")[-1].strip())
    return {k: " / ".join(v) for k, v in out.items()}


def config4_sass_count() -> str:
    """The SASS instructions of config4's instantiation (bracha, none, none)
    of ``fused_round``, by ``cuobjdump``, or why they were not counted."""
    from byzantinerandomizedconsensus_tpu_torch.ops import _build

    tool = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return "not counted (no cuobjdump)"
    out = subprocess.run([str(tool), "-sass", str(_build.library_path("fused_round"))],
                         capture_output=True, text=True, timeout=120).stdout
    for func in re.split(r"\n\s*Function : ", out)[1:]:
        name, _, body = func.partition("\n")
        if "fused_round_kernelILi1ELi0ELi0EE" in name:
            return str(len(re.findall(r"/\*[0-9a-f]{4,}\*/\s*(.*?);", body)))
    return "not counted (no such function)"


def adversary_grid():
    """Both protocols under every static adversary other than config4's
    (bracha, none), both coins, with round caps that the local coin reaches;
    and each adversary at a wide n of each protocol."""
    from byzantinerandomizedconsensus_tpu_torch.config import SimConfig

    out = []
    for protocol, n in (("bracha", 13), ("benor", 16)):
        for adversary in FUSED_ADVERSARIES:
            if (protocol, adversary) == ("bracha", "none"):
                continue
            lying = adversary in ("byzantine", "adaptive", "adaptive_min")
            f = (n - 1) // 3 if protocol == "bracha" else (n - 1) // (5 if lying else 2)
            for coin in ("shared", "local"):
                out.append(SimConfig(protocol=protocol, n=n, f=f, instances=512,
                                     adversary=adversary, coin=coin, delivery="urn2",
                                     round_cap=32, seed=len(out) + 77))
    for adversary in FUSED_ADVERSARIES[1:]:
        out.append(SimConfig(protocol="bracha", n=1024, f=341, instances=16,
                             adversary=adversary, coin="shared", delivery="urn2",
                             round_cap=8, seed=len(out)))
        lying = adversary != "crash"
        out.append(SimConfig(protocol="benor", n=512, f=102 if lying else 255,
                             instances=16, adversary=adversary, coin="local",
                             delivery="urn2", round_cap=8, seed=len(out)))
    return [c.validate() for c in out]


def grid_configs():
    from byzantinerandomizedconsensus_tpu_torch.config import SimConfig

    out = []
    for n in (4, 7, 16, 64, 512):
        for init in ("random", "all0", "all1", "split"):
            for coin in ("shared", "local"):
                out.append(SimConfig(
                    protocol="bracha", n=n, f=(n - 1) // 3,
                    instances=64 if n == 512 else 512, coin=coin, init=init,
                    delivery="urn2", seed=1000 + n))
    # Capped instances (decision 2 at round_cap), and f below its optimum
    # with n - f even, where step-0 ties (which go to 1) happen.
    out.append(SimConfig(protocol="bracha", n=16, f=5, instances=512,
                         coin="local", round_cap=2, delivery="urn2", seed=5))
    out.append(SimConfig(protocol="bracha", n=64, f=10, instances=512,
                         coin="shared", delivery="urn2", seed=6))
    out.append(SimConfig(protocol="bracha", n=10, f=2, instances=512,
                         coin="local", delivery="urn2", seed=7))
    return [c.validate() for c in out]


def compare(cfg, ids):
    """Kernel and plain version on the same CUDA inputs; returns the plain
    outputs after checking they are identical."""
    from byzantinerandomizedconsensus_tpu_torch.ops import fused_round

    rk, dk = fused_round.run_chunk(cfg, ids)
    rp, dp = fused_round.run_chunk_plain(cfg, ids)
    torch.cuda.synchronize()
    if not (torch.equal(rk, rp) and torch.equal(dk, dp)):
        bad = (rk != rp) | (dk != dp)
        i = int(bad.nonzero()[0, 0])
        fail(f"fused_round disagrees with its plain version on {cfg}: "
             f"{int(bad.sum())} instances differ, first id {int(ids[i])}: "
             f"kernel ({int(rk[i])}, {int(dk[i])}) vs plain ({int(rp[i])}, {int(dp[i])})")
    return rp, dp


def reset_launches():
    from byzantinerandomizedconsensus_tpu_torch.ops import fused_round, keys_step, urn_step

    for mod in (fused_round, keys_step, urn_step):
        mod.launches = 0


def read_launches() -> dict:
    from byzantinerandomizedconsensus_tpu_torch.ops import fused_round, keys_step, urn_step

    return {"fused_round": fused_round.launches, "keys_step": keys_step.launches,
            "urn_step": urn_step.launches}


def step_module(law):
    from byzantinerandomizedconsensus_tpu_torch.ops import keys_step, urn_step

    return {"keys": keys_step, "urn": urn_step}[law]


def plain_step(law, cfg, seed, ids, rnd, t, values, silent, faulty, honest, recv_ids=None):
    mod = step_module(law)
    if law == "keys":
        return mod.step_counts_plain(cfg, seed, ids, rnd, t, values, silent, faulty,
                                     recv_ids=recv_ids)
    return mod.step_counts_plain(cfg, seed, ids, rnd, t, values, silent, faulty, honest,
                                 recv_ids=recv_ids)


def step_counts_max_err(a, b) -> int:
    return max(int((a[0] - b[0]).abs().max()), int((a[1] - b[1]).abs().max()))


def checking_counts_fn(law, seen):
    """A round-body delivery hook that runs the kernel and the plain version
    on the same inputs, fails on any difference, and returns the kernel's."""
    mod = step_module(law)

    def counts_fn(cfg, seed, ids, rnd, t, values, silent, faulty, honest):
        got = mod.counts_fn(cfg, seed, ids, rnd, t, values, silent, faulty, honest)
        want = plain_step(law, cfg, seed, ids, rnd, t, values, silent, faulty, honest)
        err = step_counts_max_err(got, want)
        if err != 0:
            fail(f"{STEP_LAWS[law]} differs from plain on {cfg}, round {rnd}, "
                 f"step {t}: max abs err {err}")
        seen["steps"] += 1
        return got

    return counts_fn


def step_grid(law):
    from byzantinerandomizedconsensus_tpu_torch.config import SimConfig

    out = []
    for n in (4, 10, 16, 64, 128, 200, 512, 1024):
        for adversary in ("none", "adaptive", "adaptive_min"):
            for init in ("random", "all0", "all1", "split"):
                for coin in ("shared", "local"):
                    out.append(SimConfig(
                        protocol="bracha", n=n, f=(n - 1) // 3, instances=1000,
                        adversary=adversary, coin=coin, init=init, delivery=law,
                        seed=len(out) + 31 * n).validate())
    return out


def step_phase(dev):
    """Phase 5: the per-step kernels against plain, per step and per driver."""
    from byzantinerandomizedconsensus_tpu_torch.models import driver

    for law, name in STEP_LAWS.items():
        t0 = time.perf_counter()
        seen = {"steps": 0}
        grid = step_grid(law)
        for cfg in grid:
            B = 16 if cfg.n <= 200 else (8 if cfg.n <= 512 else 4)
            ids = torch.arange(B, dtype=torch.int32, device=dev) * 37
            driver.run_chunk(dataclasses.replace(cfg, round_cap=2), ids,
                             counts_fn=checking_counts_fn(law, seen))
        say(f"[steps] {name} == plain on {seen['steps']} steps of {len(grid)} "
            f"configs (n in 4..1024, adversary none/adaptive/adaptive_min, "
            f"every init, both coins, rounds 0-1) in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        runs = 0
        for cfg in grid:
            if cfg.init != "random" or cfg.coin != "shared":
                continue
            ids = torch.arange(64 if cfg.n <= 200 else 16, dtype=torch.int32, device=dev)
            rk, dk = driver.run_chunk(cfg, ids, counts_fn=step_module(law).counts_fn)
            rp, dp = driver.run_chunk(cfg, ids)
            if not (torch.equal(rk, rp) and torch.equal(dk, dp)):
                fail(f"the {name} driver differs from the plain driver on {cfg}")
            runs += 1
        say(f"[driver] step path == plain path under {law} on {runs} configs "
            f"(to termination) in {time.perf_counter() - t0:.1f} s")


def load_sweep(law):
    paths = sorted(ROOT.glob(SWEEP_FILES[law]))
    if not paths:
        fail(f"no reference results at {SWEEP_FILES[law]}")
    parts = [np.load(p) for p in paths]
    ids = np.concatenate([z["inst_ids"] for z in parts])
    order = np.argsort(ids)
    return (ids[order], np.concatenate([z["rounds"] for z in parts])[order],
            np.concatenate([z["decision"] for z in parts])[order])


def recorded_launches(cfg, law, dev):
    """The inputs of every kernel launch of one run of ``cfg`` (the main
    path's chunk), in order."""
    from byzantinerandomizedconsensus_tpu_torch.models import driver

    calls = []
    mod = step_module(law)

    def counts_fn(cfg, seed, ids, rnd, t, values, silent, faulty, honest):
        calls.append((seed, ids, rnd, t, values.clone(), silent.clone(), faulty, honest.clone()))
        return mod.counts_fn(cfg, seed, ids, rnd, t, values, silent, faulty, honest)

    driver.run_chunk(cfg, torch.arange(cfg.instances, dtype=torch.int32, device=dev),
                     counts_fn=counts_fn)
    return calls


def crossing_pairs(cfg, values: torch.Tensor, silent: torch.Tensor,
                   faulty: torch.Tensor, rows=slice(None)) -> int:
    """The PRF words one keys step needs on these planes: for each receiver
    row (of ``rows``, default all), the senders of its crossing class other
    than itself, and none where every live key is selected
    (``csrc/keys_step.cuh::row_plan``). The classes come from the wire
    values alone, so this count needs no hashing.
    """
    from byzantinerandomizedconsensus_tpu_torch.models.adversaries import scheduling_bias

    (B, n), k = values.shape, cfg.n - cfg.f
    live = ~silent.bool()
    bias = scheduling_bias(cfg, values, faulty)  # (B, 1 or n, n)
    own_bias = bias.expand(B, n, n).diagonal(dim1=1, dim2=2)
    # Live senders of class 1 and of class 0 at each receiver, then the own
    # key moved from its natural class to class 0.
    m1 = (live[:, None, :] & bias).sum(-1)
    m0 = live.sum(-1, keepdim=True) - m1
    m0 = m0 - (live & ~own_bias).long() + 1
    m1 = m1 - (live & own_bias).long()
    hashed = torch.where(k < m0, m0 - 1,
                         torch.where((k > m0) & (k < m0 + m1), m1, torch.zeros_like(m1)))
    return int(hashed.expand(B, n)[:, rows].sum())


def urn_draws(cfg, seed, ids, rnd, t, values: torch.Tensor, silent: torch.Tensor,
              faulty: torch.Tensor, honest: torch.Tensor, recv_ids=None):
    """(draws, PRF words, drops) of one urn step on these planes, from the
    plain version's work counters (``ops/urn.py::counts_fn``): the
    receivers with D > 0 need a PRF word each; two strata draw min(D, B0)
    per receiver, B0 being its live biased messages other than its own, and
    one stratum D (``csrc/urn_step.cuh::urn_counts``); drops is the sum of D.
    Over the receivers ``recv_ids`` (default all)."""
    from byzantinerandomizedconsensus_tpu_torch.ops import urn

    stats = {}
    urn.counts_fn(cfg, seed, ids, rnd, t, values, silent, faulty, honest, stats=stats,
                  recv_ids=recv_ids)
    return (int(stats["urn_random_draws"].sum()), int(stats["urn_words"].sum()),
            int(stats["urn_draws"].sum()))


def equivocation_words(cfg, call, recv_ids=None) -> int:
    """The PRF words of Ben-Or's Byzantine pairing in one keys step: one per
    (receiver, delivered faulty sender) pair, own message included, from the
    plain version's counter (0 under any other adversary), over the
    receivers ``recv_ids`` (default all)."""
    from byzantinerandomizedconsensus_tpu_torch.models.adversaries import two_faced
    from byzantinerandomizedconsensus_tpu_torch.ops import keys_step

    if not two_faced(cfg):
        return 0
    stats = {}
    keys_step.step_counts_plain(cfg, *call[:7], stats=stats, recv_ids=recv_ids)
    return stats["equivocation_words"]


def step_bound(law, cfg, call, recv_ids=None):
    """(operations, bytes, PRF words, the earlier count's operations) the
    step must do on these inputs, for the receivers ``recv_ids`` (a
    contiguous range, default all: a shard reads every sender's planes and
    writes its own rows). Under Ben-Or's Byzantine pairing the keys step
    adds a word per delivered faulty (receiver, sender) pair, the urn step
    two per faulty sender (its two class values)."""
    from byzantinerandomizedconsensus_tpu_torch.models.adversaries import two_faced

    seed, ids, rnd, t, values, silent, faulty, honest = call
    B, n = values.shape
    rows = slice(None) if recv_ids is None else slice(int(recv_ids[0]), int(recv_ids[-1]) + 1)
    n_recv = n if recv_ids is None else len(recv_ids)
    if law == "keys":
        words = crossing_pairs(cfg, values, silent, faulty, rows)
        tables = 2 if cfg.adversary == "adaptive" else 1
        ops = words * (OPS_PER_PRF_WORD + OPS_PER_KEY) + B * n * tables
        equiv = equivocation_words(cfg, call, recv_ids)
        ops += equiv * OPS_PER_PRF_WORD
        nbytes = B * (4 + 3 * n + 8 * n_recv)
        return ops, nbytes, words + equiv, ops
    draws, words, drops = urn_draws(cfg, *call, recv_ids=recv_ids)
    if two_faced(cfg):
        words += 2 * int(faulty.sum())
    per_draw = (OPS_PER_URN_DRAW if cfg.adversary in ("adaptive", "adaptive_min")
                else OPS_PER_SINGLE_URN_DRAW)
    ops = words * OPS_PER_PRF_WORD + draws * per_draw
    earlier = B * n_recv * OPS_PER_PRF_WORD + drops * EARLIER_OPS_PER_URN_DRAW
    planes = 3 if cfg.adversary == "adaptive_min" else 2
    nbytes = B * (4 + planes * n + 8 * n_recv)
    return ops, nbytes, words, earlier


def config5_phase(dev, card):
    """Phase 6: config 5 at n=512 under keys and urn through the step
    kernels; returns the kernels-line entries of keys_step and urn_step."""
    from byzantinerandomizedconsensus_tpu_torch import get_backend
    from byzantinerandomizedconsensus_tpu_torch.cli import (
        decision_histogram, round_histogram)
    from byzantinerandomizedconsensus_tpu_torch.config import (
        SWEEP_POINT_N, SimConfig, sweep_point)

    entries = []
    for law, name in STEP_LAWS.items():
        cfg = dataclasses.replace(sweep_point(SWEEP_POINT_N), delivery=law).validate()
        want_ids, want_rounds, want_dec = load_sweep(law)
        if not np.array_equal(want_ids, np.arange(cfg.instances)):
            fail(f"the reference results under {law} do not cover ids 0..{cfg.instances - 1}")
        backend = get_backend("torch", kernel="step")
        backend.prepare(cfg)
        reset_launches()
        res = backend.timed_run(cfg)
        launches = read_launches()
        if launches[name] < 1:
            fail(f"config 5 under {law} did not launch {name}")
        bad = (res.rounds != want_rounds) | (res.decision != want_dec)
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            fail(f"config 5 under {law} differs from the reference on {int(bad.sum())} "
                 f"instances; first id {i}: ({res.rounds[i]}, {res.decision[i]}) vs "
                 f"({want_rounds[i]}, {want_dec[i]})")
        dh = decision_histogram(res).tolist()
        rh = round_histogram(res).tolist()
        if dh != CONFIG5_DECISIONS or rh[:3] != CONFIG5_ROUNDS_HEAD or any(rh[3:]):
            fail(f"config 5 under {law}: histograms {dh}, {rh[:6]}")
        say(f"[main] config 5, n=512, {law}: {len(res.inst_ids)} instances equal to "
            f"the reference per instance; decision_histogram {dh}, "
            f"round_histogram[:3] {rh[:3]}; launches {launches}")
        backend.timed_run(cfg)  # warm-up
        walls = [backend.timed_run(cfg).wall_s for _ in range(5)]
        say(f"[main] config 5 {law} instances/s = {len(res.inst_ids) / min(walls)} "
            f"(best of 5 walls {walls} s; {card})")

        # The goldens on this law, through the kernels.
        gold = np.load(ROOT / "spec" / "golden" / "golden.npz")
        for gname, fields in GOLDENS.items():
            if fields["delivery"] != law:
                continue
            gcfg = SimConfig(protocol="bracha", instances=100, coin="shared",
                             round_cap=64, **fields).validate()
            got = backend.run(gcfg)
            if not (np.array_equal(got.rounds, gold[f"{gname}__rounds"])
                    and np.array_equal(got.decision, gold[f"{gname}__decision"])):
                fail(f"golden {gname} differs through {name}")
            say(f"[golden] {gname}: 100 instances equal to spec/golden/golden.npz "
                f"through {name}")

        # The plain path on the same 2000 instances.
        plain = get_backend("torch", kernel="plain")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pres = plain.run(cfg)
        plain_run_ms = (time.perf_counter() - t0) * 1e3
        if not (np.array_equal(pres.rounds, want_rounds)
                and np.array_equal(pres.decision, want_dec)):
            fail(f"the plain path under {law} differs from the reference")
        say(f"[plain] config 5 {law}, plain torch path on the card: "
            f"{plain_run_ms:.1f} ms for 2000 instances ({card})")

        # Each launch of the main path: device time, wrapper time, plain
        # time, bound.
        calls = recorded_launches(cfg, law, dev)
        mod = step_module(law)
        dev_ms, wrap_ms, p_ms, bounds, err = [], [], [], [], 0
        ops = nbytes = words = earlier = ops_bound = bytes_bound = 0.0
        for i, call in enumerate(calls):
            got = mod.counts_fn(cfg, *call)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = plain_step(law, cfg, *call)
            torch.cuda.synchronize()
            p_ms.append((time.perf_counter() - t0) * 1e3)
            err = max(err, step_counts_max_err(got, want))
            wrap_ms.append(cuda_ms(lambda: mod.counts_fn(cfg, *call), 5))
            dev_ms.append(graph_ms(lambda: mod.counts_fn(cfg, *call)))
            o, b, w, e = step_bound(law, cfg, call)
            o_ms, b_ms = o / INT_OPS_PER_S * 1e3, b / HBM_BYTES_PER_S * 1e3
            bounds.append(max(o_ms, b_ms))
            if o_ms >= b_ms:
                ops_bound += o_ms
            else:
                bytes_bound += b_ms
            if dev_ms[-1] < bounds[-1]:
                fail(f"{name} took {dev_ms[-1]:.5f} ms on launch {i}, under its bound of "
                     f"{bounds[-1]:.5f} ms: the bound's count is wrong")
            ops, nbytes, words, earlier = ops + o, nbytes + b, words + w, earlier + e
        if err != 0:
            fail(f"{name} differs from plain on the main path's inputs (max abs err {err})")
        n_calls = len(calls)
        kernel_ms, wrapper_ms = sum(dev_ms) / n_calls, sum(wrap_ms) / n_calls
        plain_ms, bound_ms = sum(p_ms) / n_calls, sum(bounds) / n_calls
        if law == "keys":
            # The earlier design's cost: every pair hashed, then its 22-pass search.
            pairs = sum(c[4].shape[0] for c in calls) * cfg.n * cfg.n / n_calls
            all_ops = pairs * (OPS_PER_PRF_WORD + OPS_PER_KEY)
            search_ops = pairs * (OPS_PER_PRF_WORD + SEARCH_OPS_PER_KEY_PAIR)
            design = (f"; crossing-class pairs {words / n_calls:.6g} of {pairs:.6g} per "
                      f"launch, fraction {words / n_calls / pairs:.4f}; the all-pairs design "
                      f"hashed every pair: {all_ops:.4g} int ops, "
                      f"{all_ops / INT_OPS_PER_S * 1e3:.3f} ms, and with its 22-pass "
                      f"search {search_ops:.4g}, {search_ops / INT_OPS_PER_S * 1e3:.3f} ms "
                      f"at the issue peak")
        else:
            draws = [urn_draws(cfg, *call)[:2] for call in calls]
            design = (f"; draws and PRF words (receivers with D > 0) by launch {draws}; "
                      f"PRF words {words / n_calls:.6g} per launch; "
                      f"the earlier design's count (a word per receiver, 10 ops for each of "
                      f"D draws): {earlier / n_calls:.4g} int ops, "
                      f"{earlier / n_calls / INT_OPS_PER_S * 1e3:.4f} ms per launch")
        say(f"[kernel] {name} on config 5 {law} (2000 instances, n=512): device "
            f"{kernel_ms:.4f} ms per launch (mean over the {n_calls} launches of a run; "
            f"each {GRAPH_LAUNCHES} launches in a CUDA graph, 5 replays, CUDA events; per "
            f"launch {[round(x, 4) for x in dev_ms]}); wrapper {wrapper_ms:.4f} ms per "
            f"launch (back-to-back calls, 5 reps, CUDA events; per launch "
            f"{[round(x, 4) for x in wrap_ms]}); {launches[name]} launches per run; "
            f"plain {plain_ms:.1f} ms per launch; bound {bound_ms:.4f} ms per launch (per "
            f"launch {[round(x, 4) for x in bounds]}) from {ops / n_calls:.4g} int ops and "
            f"{nbytes / n_calls:.4g} bytes{design}; ptxas {ptxas_summary(name)}; {card}")
        entries.append({
            "name": name, "route": "cuda",
            "source": f"byzantinerandomizedconsensus_tpu_torch/csrc/{name}.cu",
            "replaces": STEP_REPLACES[name],
            "launches": launches[name], "max_abs_err": err, "matches_plain": True,
            "ms": kernel_ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if ops_bound >= bytes_bound else "bytes",
            "library_ms": None,
        })
    return entries


def fused_bound(cfg, stats: dict, B: int):
    """(operations, bytes, PRF words) one run of ``cfg`` over B instances
    needs, from the plain version's work counters: the chain draws, a PRF
    word per chain with a draw, per coin taken (per replica under the local
    coin, per instance under the shared one), per replica at a random init,
    per faulty sender and step under the Byzantine adversary, and under
    omission the burst gate's word per instance and round and a bit word per
    fault-prone replica in a burst round; under urn a word per receiver with
    a drop and the draws that need a random word (as the per-step urn
    kernel, whose draws K1 calls); under urn3 a word per receiver
    with a drop, under committee a membership word per replica and step and
    a drop word per receiver with a drop, and their cheap-law segments; the
    ids read, the results written and the adversary's and the fault
    schedule's planes read once (a byte per replica for the faulty set, four
    more for the crash rounds; a byte per replica for the fault-prone set
    under adversary none, whose faulty plane is that set otherwise, eight
    more for the outage window, one more for the side and eight per
    instance for the epoch), and past n = 4096 a read and a write of each
    state word per instance-round in the scratch plane."""
    from byzantinerandomizedconsensus_tpu_torch.ops import fused_round

    byz = BYZ_WORDS_PER_ROUND[cfg.protocol] if cfg.adversary == "byzantine" else 0
    words = (stats.get("chain_seeds", 0) + stats["coin_words"]
             + (B * cfg.n if cfg.init == "random" else 0)
             + byz * cfg.f * stats["instance_rounds"] + stats.get("fault_words", 0)
             + stats.get("urn3_words", 0) + stats.get("committee_draws", 0)
             + stats.get("urn_words", 0))
    per_urn_draw = (OPS_PER_URN_DRAW if cfg.adversary in ("adaptive", "adaptive_min")
                    else OPS_PER_SINGLE_URN_DRAW)
    ops = (stats.get("chain_trips", 0) * OPS_PER_CHAIN_DRAW + words * OPS_PER_PRF_WORD
           + stats.get("cheap_segments", 0) * OPS_PER_CHEAP_SEGMENT
           + stats.get("urn_random_draws", 0) * per_urn_draw)
    plane = {"none": 0, "crash": 5}.get(cfg.adversary, 1)
    plane += {"none": 0, "recover": 8, "partition": 1, "omission": 0}[cfg.faults]
    plane += cfg.faults != "none" and cfg.adversary == "none"
    per_instance = 8 if cfg.faults == "partition" else 0
    scratch = (SCRATCH_BYTES_PER_REPLICA_ROUND * cfg.n * stats["instance_rounds"]
               if fused_round.layout(cfg) == 0 else 0)
    return ops, B * (4 + 4 + 1 + plane * cfg.n + per_instance) + scratch, words


def fused_on_path(cfg, ids, reps: int, plain_pairs: int = 0):
    """The kernel and its plain version on one path's inputs: the kernel's
    time (CUDA events around ``reps`` launches, the adversary's and the
    fault schedule's planes built beforehand), the planes' build, the
    wrapper's (planes built each call), the plain version's (host clock,
    synchronised; chunks of the plain backend's size, or of ``plain_pairs``
    (instance, replica) pairs) and its work counters, the max abs error
    between the two, and the bound. Fails if they differ, or if the kernel
    beats its bound."""
    from byzantinerandomizedconsensus_tpu_torch import get_backend
    from byzantinerandomizedconsensus_tpu_torch.ops import fused_round, prf

    key = prf.seed_key(cfg.seed)
    planes = fused_round.operand_planes(cfg, ids, key)
    rk, dk = fused_round.run_chunk(cfg, ids, planes=planes)
    kernel_ms = cuda_ms(lambda: fused_round.run_chunk(cfg, ids, planes=planes), reps)
    planes_ms = cuda_ms(lambda: fused_round.operand_planes(cfg, ids, key), reps)
    wrapper_ms = cuda_ms(lambda: fused_round.run_chunk(cfg, ids), reps)
    del planes
    chunk = (max(1, plain_pairs // cfg.n) if plain_pairs
             else get_backend("torch", kernel="plain").chunk_size(cfg))
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parts = [fused_round.run_chunk_plain(cfg, ids[lo:lo + chunk], stats=stats)
             for lo in range(0, len(ids), chunk)]
    rp = torch.cat([p[0] for p in parts])
    dp = torch.cat([p[1] for p in parts])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(int((rk - rp).abs().max()),
              int((dk.to(torch.int32) - dp.to(torch.int32)).abs().max()))
    if err != 0:
        fail(f"fused_round differs from plain on {cfg} (max abs err {err})")
    ops, nbytes, words = fused_bound(cfg, stats, len(ids))
    ops_ms, bytes_ms = ops / INT_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    if kernel_ms < bound_ms:
        fail(f"fused_round took {kernel_ms:.5f} ms on {cfg}, under its bound of "
             f"{bound_ms:.5f} ms: the bound's count is wrong")
    return {"ms": kernel_ms, "wrapper_ms": wrapper_ms, "planes_ms": planes_ms,
            "plain_ms": plain_ms, "plain_chunk": chunk,
            "bound_ms": bound_ms, "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "max_abs_err": err, "ops": ops, "bytes": nbytes, "prf_words": words,
            "chain_draws": stats.get("chain_trips", 0),
            "cheap_segments": stats.get("cheap_segments", 0),
            "instance_rounds": stats["instance_rounds"]}


_PTXAS = {}


def instantiation_ptxas(cfg) -> str:
    """The ptxas report of the instantiation that runs ``cfg``."""
    from byzantinerandomizedconsensus_tpu_torch.ops import fused_round

    lib = fused_round.library(cfg)
    if lib not in _PTXAS:
        _PTXAS[lib] = fused_ptxas(lib)
    return _PTXAS[lib][(cfg.protocol, cfg.adversary, cfg.faults)]


#: Timed walls and kernel repeats of the cells of phases 7 to 10, cut from
#: 5 and 5 as phases 9 and 10 came, to keep the script's time near what it
#: was.
EARLIER_WALLS = EARLIER_REPS = 3


def shipped_run(backend, cfg, label, card, reps=EARLIER_REPS, plain_pairs=0,
                walls=EARLIER_WALLS):
    """One shipped configuration through the backend a user calls: the run
    with its launches counted, its throughput (best of ``walls`` after a
    warm-up), then the kernel and the plain version on its inputs. Returns
    ``(result, path entry)``."""
    from byzantinerandomizedconsensus_tpu_torch.ops import fused_round

    backend.prepare(cfg)
    reset_launches()
    res = backend.timed_run(cfg)
    launches = read_launches()
    if launches["fused_round"] < 1 or launches["keys_step"] or launches["urn_step"]:
        fail(f"{label} did not run through fused_round alone: launches {launches}")
    backend.timed_run(cfg)  # warm-up
    n_walls, walls = walls, [backend.timed_run(cfg).wall_s for _ in range(walls)]
    ids = torch.as_tensor(res.inst_ids, dtype=torch.int32).cuda()
    entry = fused_on_path(cfg, ids, reps, plain_pairs)
    inst = (cfg.protocol, cfg.adversary, cfg.faults)
    lib = fused_round.library(cfg)
    entry.update(config=label, instances=len(res.inst_ids), launches=launches["fused_round"],
                 instances_per_s=len(res.inst_ids) / min(walls), walls_s=walls,
                 library=lib, ptxas=instantiation_ptxas(cfg))
    say(f"[shipped] {label} ({cfg.protocol}, {cfg.adversary}, n={cfg.n}, f={cfg.f}, "
        f"{cfg.coin} coin, faults {cfg.faults}, {cfg.delivery}, {len(res.inst_ids)} "
        f"instances): instances/s = "
        f"{entry['instances_per_s']} (best of {n_walls} walls {walls} s); {lib} "
        f"{entry['ms']:.4f} ms (mean of {reps}, CUDA events, planes built beforehand; "
        f"wrapper {entry['wrapper_ms']:.4f} ms, of which the planes' build "
        f"{entry['planes_ms']:.4f} ms), {launches['fused_round']} launch(es); "
        f"plain {entry['plain_ms']:.1f} ms (chunks of {entry['plain_chunk']}); bound "
        f"{entry['bound_ms']:.5f} ms by "
        f"{entry['bound_by']} from {entry['ops']:.4g} int ops ({entry['chain_draws']} "
        f"chain draws, {entry['cheap_segments']} cheap segments, {entry['prf_words']} PRF "
        f"words, {entry['instance_rounds']} instance-rounds) and {entry['bytes']} bytes; "
        f"kernel/bound {entry['ms'] / entry['bound_ms']:.2f}; ptxas {inst} "
        f"{entry['ptxas']}; {card}")
    return res, entry


def load_sweep_urn2(n: int, instances: int):
    paths = sorted(ROOT.glob(SWEEP_URN2_FILES.format(n=n)))
    if len(paths) != 4:
        fail(f"expected 4 reference shards for n={n}, found {len(paths)}")
    parts = [np.load(p) for p in paths]
    ids = np.concatenate([z["inst_ids"] for z in parts])
    order = np.argsort(ids)
    if not np.array_equal(ids[order], np.arange(instances)):
        fail(f"the urn2 sweep reference at n={n} does not cover ids 0..{instances - 1}")
    return (np.concatenate([z["rounds"] for z in parts])[order],
            np.concatenate([z["decision"] for z in parts])[order])


def shipped_phase(card):
    """Phase 7: the other BASELINE configurations as shipped, through
    ``get_backend("torch")``; returns their path entries."""
    from byzantinerandomizedconsensus_tpu_torch import get_backend, preset
    from byzantinerandomizedconsensus_tpu_torch.cli import (
        decision_histogram, round_histogram)
    from byzantinerandomizedconsensus_tpu_torch.config import (
        SWEEP_NS, SWEEP_POINT_N, SimConfig, sweep_point)

    backend = get_backend("torch")
    product = json.loads((ROOT / PRODUCT_FILE).read_text())
    paths = []
    for name in ("config1", "config2", "config3"):
        cfg = preset(name)
        res, entry = shipped_run(backend, cfg, name, card,
                                 reps=2 if name == "config2" else EARLIER_REPS)
        dh, rh = decision_histogram(res).tolist(), round_histogram(res).tolist()
        want = product[name]
        if dh != want["decision_histogram"] or rh != want["round_histogram"]:
            fail(f"{name} differs from {PRODUCT_FILE}: decisions {dh}, rounds "
                 f"{[(r, c) for r, c in enumerate(rh) if c]}")
        say(f"[shipped] {name}: decision_histogram {dh} and the full "
            f"{len(rh)}-bin round histogram equal {PRODUCT_FILE}; mean_rounds_decided "
            f"{float(res.rounds[res.decision != 2].mean())}")
        paths.append(entry)
    for n in SWEEP_NS:
        cfg = sweep_point(n)
        want_rounds, want_dec = load_sweep_urn2(n, cfg.instances)
        res, entry = shipped_run(backend, cfg, f"config5 n={n}", card)
        bad = (res.rounds != want_rounds) | (res.decision != want_dec)
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            fail(f"config 5 under urn2 at n={n} differs from the reference on "
                 f"{int(bad.sum())} instances; first id {i}: ({res.rounds[i]}, "
                 f"{res.decision[i]}) vs ({want_rounds[i]}, {want_dec[i]})")
        dh, rh = decision_histogram(res).tolist(), round_histogram(res).tolist()
        if n == SWEEP_POINT_N and (dh != CONFIG5_DECISIONS or rh[:3] != CONFIG5_ROUNDS_HEAD
                                   or any(rh[3:])):
            fail(f"config 5 under urn2 at n={n}: histograms {dh}, {rh[:6]}")
        say(f"[shipped] config 5 urn2 n={n}: {cfg.instances} instances equal to "
            f"{SWEEP_URN2_FILES.format(n=n)} per instance; decision_histogram {dh}, "
            f"round_histogram {[(r, c) for r, c in enumerate(rh) if c]}")
        paths.append(entry)
    gold = np.load(ROOT / "spec" / "golden" / "golden.npz")
    for gname, fields in URN2_GOLDENS.items():
        gcfg = SimConfig(instances=100, round_cap=64, delivery="urn2", **fields).validate()
        reset_launches()
        got = backend.run(gcfg)
        if read_launches()["fused_round"] < 1:
            fail(f"golden {gname} did not launch fused_round")
        if not (np.array_equal(got.rounds, gold[f"{gname}__rounds"])
                and np.array_equal(got.decision, gold[f"{gname}__decision"])):
            fail(f"golden {gname} differs through fused_round")
        say(f"[golden] {gname}: 100 instances equal to spec/golden/golden.npz through "
            f"fused_round")
    return paths


def f_of(protocol, n, adversary):
    """The largest f each protocol allows at n: Bracha n > 3f, Ben-Or n > 5f
    under a lying adversary and n > 2f otherwise."""
    lying = adversary in ("byzantine", "adaptive", "adaptive_min")
    return (n - 1) // 3 if protocol == "bracha" else (n - 1) // (5 if lying else 2)


def fault_grid():
    """Both protocols under every static adversary and each §9 fault kind:
    at n=13 (Bracha) and n=16 (Ben-Or) with both coins and a round cap the
    local coin reaches, at n=64 for both protocols and coins, and at n=512
    and n=1024 for both protocols, the coin alternating by adversary, with a
    short round cap, so capped instances occur."""
    from byzantinerandomizedconsensus_tpu_torch.config import SimConfig

    out = []
    for faults in FAULT_KINDS:
        for protocol, n, coins, B, cap in (("bracha", 13, ("shared", "local"), 256, 32),
                                           ("benor", 16, ("shared", "local"), 256, 32),
                                           ("bracha", 64, ("shared", "local"), 64, 16),
                                           ("benor", 64, ("shared", "local"), 64, 16),
                                           ("bracha", 512, None, 16, 6),
                                           ("benor", 512, None, 16, 6),
                                           ("bracha", 1024, None, 8, 4),
                                           ("benor", 1024, None, 8, 4)):
            for i, adversary in enumerate(FUSED_ADVERSARIES):
                for coin in coins or (("shared", "local")[i % 2],):
                    out.append(SimConfig(protocol=protocol, n=n, f=f_of(protocol, n, adversary),
                                         instances=B, adversary=adversary, coin=coin,
                                         delivery="urn2", round_cap=cap, faults=faults,
                                         seed=len(out) + 501))
    return [c.validate() for c in out]


def divergence_phase(backend):
    """The divergence tool's fault leg through ``backend``: each row of the
    port's ``tools/divergence.py`` (its ``FAULT_GRID`` without a schedule
    and under each kind) recomputed from this run, every field of its
    committed row compared for equality."""
    from byzantinerandomizedconsensus_tpu_torch.tools import divergence

    rows = json.loads((ROOT / DIVERGENCE_FILE).read_text())["fault_rows"]
    for cfg, row in zip(divergence.FAULT_GRID, rows, strict=True):
        reset_launches()
        got = divergence.fault_row(cfg, DIVERGENCE_INSTANCES, backend)
        if read_launches()["fused_round"] < len(FUSED_FAULTS):
            fail(f"the divergence fault row {cfg} did not run through fused_round")
        diff = {k: (got.get(k), v) for k, v in row.items()
                if k != "backend" and got.get(k) != v}
        if diff:
            fail(f"the divergence fault row {cfg} differs from {DIVERGENCE_FILE}: {diff}")
        say(f"[faults] divergence row {cfg.protocol} n={cfg.n} f={cfg.f} {cfg.adversary} "
            f"{cfg.coin} seed {cfg.seed}: all {len(row) - 1} fields equal "
            f"{DIVERGENCE_FILE} fault_rows ({DIVERGENCE_INSTANCES} instances per kind, "
            f"through fused_round): {got}")


def fault_phase(dev, card):
    """Phase 8: the §9 fault schedules through ``fused_round``; returns the
    config4 cells' path entries."""
    from byzantinerandomizedconsensus_tpu_torch import get_backend, preset
    from byzantinerandomizedconsensus_tpu_torch.cli import (
        decision_histogram, round_histogram)

    t0 = time.perf_counter()
    grid, capped = fault_grid(), 0
    for cfg in grid:
        ids = torch.arange(cfg.instances, dtype=torch.int32, device=dev)
        _, dp = compare(cfg, ids)
        capped += int((dp == 2).sum())
    if capped == 0:
        fail("the fault grid reached no capped instance")
    say(f"[faults] fused_round == plain on {len(grid)} configs (recover, partition, "
        f"omission; both protocols under every static adversary; n 13, 16, 64, 512, 1024; "
        f"both coins; {capped} capped instances) in {time.perf_counter() - t0:.1f} s")

    backend = get_backend("torch")
    t0 = time.perf_counter()
    divergence_phase(backend)
    say(f"[faults] the divergence fault grid took {time.perf_counter() - t0:.1f} s")

    paths = []
    for kind in FAULT_KINDS:
        cfg = preset("config4", faults=kind)
        z = np.load(ROOT / SWEEP_FAULTS_FILE.format(kind=kind))
        res, entry = shipped_run(backend, cfg, f"config4 {kind}", card)
        n_ref = len(z["inst_ids"])
        if not np.array_equal(res.inst_ids[:n_ref], z["inst_ids"]):
            fail(f"the reference of config4 {kind} does not cover the run's first ids")
        bad = (res.rounds[:n_ref] != z["rounds"]) | (res.decision[:n_ref] != z["decision"])
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            fail(f"config4 {kind} differs from the reference on {int(bad.sum())} of "
                 f"instances 0-{n_ref - 1}; first id {i}: ({res.rounds[i]}, "
                 f"{res.decision[i]}) vs ({z['rounds'][i]}, {z['decision'][i]})")
        dh, rh = decision_histogram(res).tolist(), round_histogram(res).tolist()
        say(f"[faults] config4 {kind}: instances 0-{n_ref - 1} equal to "
            f"{SWEEP_FAULTS_FILE.format(kind=kind)} per instance, all {len(res.inst_ids)} "
            f"equal to the plain version on the card; decision_histogram {dh}, "
            f"round_histogram {[(r, c) for r, c in enumerate(rh) if c]}")
        entry.update(faults=kind)
        paths.append(entry)
    return paths


def wide_grid():
    """Phase 9's grid: urn3 and committee × both protocols × every static
    adversary × every §9 schedule at a small n (urn3 13 and 16, committee
    64, where C = 48 < n), with a round cap the local coin reaches, the coin
    alternating and every init in turn; the same at n = 1500 (packing law
    v2) and, for committee, n = 5000 (v3), a few instances with a short cap;
    urn2 at n = 1500 for both protocols under every adversary; and the
    edges: n = 4 and 1024 (urn3), 1024 and 4096 (committee), 2^20
    (committee, two instances)."""
    from byzantinerandomizedconsensus_tpu_torch.config import SimConfig

    def f_of(law, protocol, n, adversary):
        lying = adversary in ("byzantine", "adaptive", "adaptive_min")
        if law == "committee":
            return n // 5 if protocol == "bracha" else (n // 16 if lying else n // 6)
        return (n - 1) // 3 if protocol == "bracha" else (n - 1) // (5 if lying else 2)

    out = []

    def add(law, protocol, n, adversary, faults, B, cap):
        i = len(out)
        out.append(SimConfig(protocol=protocol, n=n, f=f_of(law, protocol, n, adversary),
                             instances=B, adversary=adversary, coin=("shared", "local")[i % 2],
                             init=INITS[(i // 2) % 4], delivery=law, round_cap=cap,
                             faults=faults, seed=901 + i))

    for law in ("urn3", "committee"):
        for faults in FUSED_FAULTS:
            for protocol in FUSED_PROTOCOLS:
                for adversary in FUSED_ADVERSARIES:
                    small = 64 if law == "committee" else (13 if protocol == "bracha" else 16)
                    add(law, protocol, small, adversary, faults, 128, 16)
                    add(law, protocol, 1500, adversary, faults, 4, 5)
                    if law == "committee":
                        add(law, protocol, 5000, adversary, faults, 2, 4)
    for protocol in FUSED_PROTOCOLS:
        for k, adversary in enumerate(FUSED_ADVERSARIES):
            add("urn2", protocol, 1500, adversary, FUSED_FAULTS[k % 4], 4, 5)
    for law, n, B in (("urn3", 4, 256), ("urn3", 1024, 16), ("committee", 1024, 16),
                      ("committee", 4096, 8), ("committee", 1 << 20, 2)):
        add(law, "bracha", n, "none", "none", B, 8)
        add(law, "bracha", n, "adaptive", "none", B, 8)
    return [c.validate() for c in out]


def leg_fields(res) -> dict:
    """A run's aggregates as the JAX package's summary computes them."""
    from byzantinerandomizedconsensus_tpu_torch.cli import summary

    got = summary(res)
    return {k: got[k] for k in LEG_FIELDS}


def check_leg(backend, leg, label):
    """One leg of a committed record through ``backend`` at its own
    instance count, launches counted, against the record's aggregates."""
    from byzantinerandomizedconsensus_tpu_torch.config import SimConfig

    cfg = SimConfig(protocol=leg["protocol"], n=leg["n"], f=leg["f"],
                    instances=leg["instances"], adversary=leg["adversary"], coin=leg["coin"],
                    seed=leg["seed"], round_cap=leg["round_cap"],
                    delivery=leg["delivery"]).validate()
    reset_launches()
    res = backend.run(cfg)
    if read_launches()["fused_round"] < 1:
        fail(f"{label} did not launch fused_round")
    check_result_against_leg(res, leg, f"{label} ({cfg.instances} instances)")
    return cfg


def check_per_instance(res, path, label):
    """Instances 0..k-1 of ``res`` against a committed shard."""
    z = np.load(ROOT / path)
    n_ref = len(z["inst_ids"])
    if not np.array_equal(res.inst_ids[:n_ref], z["inst_ids"]):
        fail(f"the reference of {label} does not cover the run's first ids")
    bad = (res.rounds[:n_ref] != z["rounds"]) | (res.decision[:n_ref] != z["decision"])
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        fail(f"{label} differs from {path} on {int(bad.sum())} of instances 0-{n_ref - 1}; "
             f"first id {i}: ({res.rounds[i]}, {res.decision[i]}) vs "
             f"({z['rounds'][i]}, {z['decision'][i]})")
    return n_ref


def wide_phase(dev, card):
    """Phase 9: urn3, committee and the packing laws v2/v3 through
    ``fused_round``; returns the timed cells' path entries."""
    from byzantinerandomizedconsensus_tpu_torch import get_backend, preset
    from byzantinerandomizedconsensus_tpu_torch.config import (
        SimConfig, committee_point, sweep_point)
    from byzantinerandomizedconsensus_tpu_torch.ops import fused_round

    t0 = time.perf_counter()
    grid, capped, by_lib = wide_grid(), 0, {}
    for cfg in grid:
        ids = torch.arange(cfg.instances, dtype=torch.int32, device=dev)
        _, dp = compare(cfg, ids)
        capped += int((dp == 2).sum())
        lib = fused_round.library(cfg)
        by_lib[lib] = by_lib.get(lib, 0) + 1
    if capped == 0:
        fail("the wide grid reached no capped instance")
    say(f"[wide] fused_round == plain on {len(grid)} configs (urn3 and committee, both "
        f"protocols, every static adversary and schedule, every init, both coins, n 4 to "
        f"2^20; configs by library {by_lib}; {capped} capped instances) in "
        f"{time.perf_counter() - t0:.1f} s")

    backend = get_backend("torch")
    paths = []
    r19 = json.loads((ROOT / COMMITTEE_R19_FILE).read_text())
    t0 = time.perf_counter()
    committee_legs = []
    for leg in r19["legs"]:
        cfg = check_leg(backend, leg, f"{COMMITTEE_R19_FILE} leg {leg['delivery']} "
                                      f"n={leg['n']}")
        if cfg.delivery == "committee":
            committee_legs.append(cfg)
    say(f"[wide] the {len(r19['legs'])} legs of {COMMITTEE_R19_FILE} took "
        f"{time.perf_counter() - t0:.1f} s")
    for cfg in committee_legs:
        cfg = dataclasses.replace(cfg, instances=COMMITTEE_INSTANCES).validate()
        _, entry = shipped_run(backend, cfg, f"committee n={cfg.n} (r19 shape)", card,
                               plain_pairs=PHASE9_PLAIN_PAIRS)
        paths.append(entry)
    for n in (1024, 8192, 131072):
        cfg = committee_point(n)
        res, entry = shipped_run(backend, cfg, f"committee_point({n})", card,
                                 plain_pairs=PHASE9_PLAIN_PAIRS)
        paths.append(entry)
        if n == 1024:
            continue
        n_ref = check_per_instance(res, SWEEP_COMMITTEE_FILE.format(n=n, f=cfg.f),
                                   f"committee_point({n})")
        say(f"[wide] committee_point({n}): instances 0-{n_ref - 1} equal to "
            f"{SWEEP_COMMITTEE_FILE.format(n=n, f=cfg.f)} per instance, all "
            f"{cfg.instances} equal to plain on the card; {leg_fields(res)}")
    n2048 = json.loads((ROOT / N2048_FILE).read_text())
    for leg in n2048["legs"]:
        if leg["n"] != 2048:
            continue
        cfg = dataclasses.replace(sweep_point(2048), delivery=leg["delivery"]).validate()
        res, entry = shipped_run(backend, cfg, f"config5 n=2048 {leg['delivery']}", card,
                                 plain_pairs=PHASE9_PLAIN_PAIRS)
        check_result_against_leg(res, leg, f"{N2048_FILE} leg {leg['delivery']} n=2048")
        paths.append(entry)
    rows = json.loads((ROOT / DIVERGENCE_R6_FILE).read_text())["preset_rows"]
    for row in rows:
        fields = {k: row[k] for k in ("protocol", "n", "f", "adversary", "coin", "seed",
                                      "round_cap")}
        cfg = SimConfig(instances=row["instances"], delivery="urn3", **fields).validate()
        res, entry = shipped_run(backend, cfg, f"{row['preset']} urn3 (divergence row)",
                                 card, plain_pairs=PHASE9_PLAIN_PAIRS)
        got = {"mean_rounds_urn3": float(res.rounds.mean()),
               "p1_urn3": float((res.decision == 1).mean()),
               "capped_urn3": float((res.decision == 2).mean())}
        diff = {k: (v, row[k]) for k, v in got.items() if row[k] != v}
        if diff:
            fail(f"{row['preset']} under urn3 differs from {DIVERGENCE_R6_FILE}: {diff}")
        say(f"[wide] {row['preset']} under urn3 ({row['instances']} instances): {got} "
            f"equal {DIVERGENCE_R6_FILE} preset_rows")
        paths.append(entry)
    cfg = preset("config4", delivery="urn3")
    _, entry = shipped_run(backend, cfg, "config4 urn3", card, plain_pairs=PHASE9_PLAIN_PAIRS)
    say(f"[wide] config4 under urn3: all {cfg.instances} instances equal to plain on the card")
    paths.append(entry)
    return paths


def check_result_against_leg(res, leg, label):
    """A run's aggregates (and its round histogram, where the record has
    one) against a committed leg."""
    from byzantinerandomizedconsensus_tpu_torch.cli import round_histogram

    got = leg_fields(res)
    want = {k: leg[k] for k in LEG_FIELDS if k in leg}
    if leg.get("round_histogram") is not None:
        got["round_histogram"] = round_histogram(res).tolist()
        want["round_histogram"] = leg["round_histogram"]
    diff = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
    if diff:
        fail(f"{label} differs from its record: {diff}")
    say(f"[wide] {label}: {', '.join(f'{k} {got[k]}' for k in LEG_FIELDS if k in want)}"
        f"{' and the round histogram' if 'round_histogram' in want else ''} equal the record")


def wide_kernels(paths) -> list:
    """The ``{"kernels": [...]}`` entries of the wide kernel's libraries,
    each from its timed cell of phase 9 (its launches from that cell's run)."""
    cells = {"fused_round_committee_r0": "committee_point(131072)",
             "fused_round_committee_r1": "committee_point(1024)",
             "fused_round_committee_r4": "committee n=4096 (r19 shape)",
             "fused_round_urn3_r1": "config4 urn3",
             "fused_round_urn3_r4": "config5 n=2048 urn3",
             "fused_round_urn2_r4": "config5 n=2048 urn2"}
    by_label = {p["config"]: p for p in paths}
    out = []
    for lib, label in cells.items():
        p = by_label[label]
        out.append({
            "name": lib, "route": "cuda",
            "source": f"byzantinerandomizedconsensus_tpu_torch/csrc/{lib}.cu",
            "replaces": "byzantinerandomizedconsensus_tpu/ops/pallas_round.py:268",
            "path": label, "launches": p["launches"], "max_abs_err": p["max_abs_err"],
            "ms": p["ms"], "wrapper_ms": p["wrapper_ms"], "plain_ms": p["plain_ms"],
            "bound_ms": p["bound_ms"], "bound_by": p["bound_by"], "library_ms": None,
        })
    return out


def law_grid(law):
    """Phase 10's per-step grid: both protocols × every static adversary ×
    both coins × n in LAW_GRID, every init in turn, a short round cap."""
    from byzantinerandomizedconsensus_tpu_torch.config import SimConfig

    out = []
    for protocol in FUSED_PROTOCOLS:
        for adversary in FUSED_ADVERSARIES:
            for coin in ("shared", "local"):
                for n, B in LAW_GRID:
                    out.append(SimConfig(
                        protocol=protocol, n=n, f=f_of(protocol, n, adversary),
                        instances=1000, adversary=adversary, coin=coin,
                        init=INITS[len(out) % 4], delivery=law,
                        round_cap=LAW_GRID_ROUNDS, seed=len(out) + 4001).validate())
    return out


def law_grid_phase(dev):
    """K2 and K3 against their plain versions at every step of the grid's
    runs, through the real round bodies."""
    from byzantinerandomizedconsensus_tpu_torch.models import driver

    for law, name in STEP_LAWS.items():
        t0 = time.perf_counter()
        seen, grid = {"steps": 0}, law_grid(law)
        for cfg in grid:
            B = dict(LAW_GRID)[cfg.n]
            ids = torch.arange(B, dtype=torch.int32, device=dev) * 37
            driver.run_chunk(cfg, ids, counts_fn=checking_counts_fn(law, seen))
        say(f"[laws] {name} == plain on {seen['steps']} steps of {len(grid)} configs "
            f"(both protocols, every static adversary, both coins, n "
            f"{[n for n, _ in LAW_GRID]}, rounds 0-{LAW_GRID_ROUNDS - 1}) in "
            f"{time.perf_counter() - t0:.1f} s")


def run_counted(backend, cfg, kernel, label):
    """One run of ``cfg`` through ``backend`` with the launch counts set to
    0 just before and read just after; fails unless ``kernel`` launched and
    no other kernel did."""
    backend.prepare(cfg)
    reset_launches()
    res = backend.timed_run(cfg)
    launches = read_launches()
    if launches[kernel] < 1 or any(v for k, v in launches.items() if k != kernel):
        fail(f"{label} did not run through {kernel} alone: launches {launches}")
    return res, launches[kernel]


def check_equal_results(a, b, label):
    bad = (a.rounds != b.rounds) | (a.decision != b.decision)
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        fail(f"{label}: {int(bad.sum())} instances differ; first id {int(a.inst_ids[i])}: "
             f"({a.rounds[i]}, {a.decision[i]}) vs ({b.rounds[i]}, {b.decision[i]})")


def graph_run_ms(fns, replays: int = 3) -> float:
    """Device time of one pass over ``fns`` (kernel launches on the current
    stream): all captured in one CUDA graph, each call's outputs kept, the
    replay timed by CUDA events, the mean over ``replays``."""
    for fn in fns:  # warm-up outside the capture
        fn()
    torch.cuda.synchronize()
    graph, outs = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for fn in fns:
            outs.append(fn())
    graph.replay()
    torch.cuda.synchronize()
    ms = cuda_ms(graph.replay, replays)
    del graph, outs
    return ms


def step_cell(cfg, law, label, card, dev, plain_ids=None):
    """A timed cell of a per-step law through ``get_backend("torch",
    kernel="step")``: the run with its launches counted, its throughput
    (best of 3 walls after a warm-up), then every launch of the run
    recorded and replayed: the kernel's device time of a whole run (all its
    launches in one CUDA graph), the plain version on the same inputs
    (timed on the host clock; on instances 0..plain_ids-1 when given) and
    compared with the kernel, and the bound summed over the launches from
    each launch's planes. Fails if the kernel beats its bound. Returns the
    path entry."""
    from byzantinerandomizedconsensus_tpu_torch import get_backend
    from byzantinerandomizedconsensus_tpu_torch.ops import _step

    name = STEP_LAWS[law]
    backend = get_backend("torch", kernel="step")
    res, launches = run_counted(backend, cfg, name, label)
    backend.timed_run(cfg)  # warm-up
    walls = [backend.timed_run(cfg).wall_s for _ in range(EARLIER_WALLS)]
    calls = recorded_launches(cfg, law, dev)
    mod = step_module(law)
    kernel_ms = graph_run_ms([lambda c=call: mod.counts_fn(cfg, *c) for call in calls])
    err, plain_ms, ops, nbytes, words, bound_ms = 0, 0.0, 0, 0, 0, 0.0
    ops_ms_sum = bytes_ms_sum = 0.0
    for call in calls:
        got = mod.counts_fn(cfg, *call)
        seed, ids, rnd, t, *planes = call
        if plain_ids is not None:
            ids, planes = ids[:plain_ids], [x[:plain_ids] for x in planes]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain_step(law, cfg, seed, ids, rnd, t, *planes)
        torch.cuda.synchronize()
        plain_ms += (time.perf_counter() - t0) * 1e3
        k = want[0].shape[0]
        err = max(err, step_counts_max_err((got[0][:k], got[1][:k]), want))
        o, b, w, _ = step_bound(law, cfg, call)
        o_ms, b_ms = o / INT_OPS_PER_S * 1e3, b / HBM_BYTES_PER_S * 1e3
        bound_ms += max(o_ms, b_ms)
        ops_ms_sum, bytes_ms_sum = ops_ms_sum + o_ms, bytes_ms_sum + b_ms
        ops, nbytes, words = ops + o, nbytes + b, words + w
    if err != 0:
        fail(f"{name} differs from plain on {label} (max abs err {err})")
    if kernel_ms < bound_ms:
        fail(f"{name} took {kernel_ms:.5f} ms on {label}, under its bound of "
             f"{bound_ms:.5f} ms: the bound's count is wrong")
    n_calls = len(calls)
    on = "" if plain_ids is None else f" on ids 0-{plain_ids - 1}"
    say(f"[cell] {label} ({cfg.protocol}, {cfg.adversary}, n={cfg.n}, f={cfg.f}, {cfg.coin} "
        f"coin, {cfg.delivery}, {len(res.inst_ids)} instances) through {name} "
        f"({_step.library(name, cfg)}): "
        f"instances/s = {len(res.inst_ids) / min(walls)} (best of {EARLIER_WALLS} walls "
        f"{walls} s); {name} {kernel_ms:.4f} ms of device time a run ({n_calls} launches "
        f"in one CUDA graph, mean of 3 replays, CUDA events; {kernel_ms / n_calls:.5f} ms a "
        f"launch), {launches} launches; plain {plain_ms:.1f} ms{on}; bound "
        f"{bound_ms:.5f} ms from {ops:.4g} int ops ({words} PRF words) and {nbytes} bytes; "
        f"kernel/bound {kernel_ms / bound_ms:.2f}; {card}")
    return {"config": label, "kernel": name, "library": _step.library(name, cfg),
            "instances": len(res.inst_ids), "launches": launches, "max_abs_err": err,
            "ms": kernel_ms, "ms_per_launch": kernel_ms / n_calls, "plain_ms": plain_ms,
            "plain_ms_per_launch": plain_ms / n_calls, "plain_ids": plain_ids,
            "bound_ms": bound_ms, "bound_ms_per_launch": bound_ms / n_calls,
            "bound_by": "operations" if ops_ms_sum >= bytes_ms_sum else "bytes",
            "instances_per_s": len(res.inst_ids) / min(walls), "walls_s": walls}


def histogram_fields(res) -> dict:
    from byzantinerandomizedconsensus_tpu_torch.cli import decision_histogram, round_histogram

    decided = res.rounds[res.decision != 2]
    return {"decision_histogram": decision_histogram(res).tolist(),
            "round_histogram": round_histogram(res).tolist(),
            "mean_rounds_decided": float(decided.mean()) if len(decided) else None}


def urn_product_phase(card, dev):
    """config1-5 under §4b urn as shipped through K1 and through K3, each
    against the reference's histograms and K1 against K3 per instance; the
    timed cells config2-4 on both kernels. Returns (K1 paths, K3 paths)."""
    from byzantinerandomizedconsensus_tpu_torch import get_backend, preset
    from byzantinerandomizedconsensus_tpu_torch.config import SWEEP_POINT_N, sweep_point

    product = json.loads((ROOT / PRODUCT_URN_FILE).read_text())
    fused, step = get_backend("torch"), get_backend("torch", kernel="step")
    k1_paths, k3_paths = [], []
    for name in ("config1", "config2", "config3", "config4", "config5"):
        cfg = (dataclasses.replace(sweep_point(SWEEP_POINT_N), delivery="urn").validate()
               if name == "config5" else preset(name, delivery="urn"))
        label = f"{name} urn"
        if name in ("config2", "config3", "config4"):
            r1, entry = shipped_run(fused, cfg, f"{label} (K1)", card)
            k1_paths.append(entry)
        else:
            r1, _ = run_counted(fused, cfg, "fused_round", f"{label} (K1)")
        r3, _ = run_counted(step, cfg, "urn_step", f"{label} (K3)")
        check_equal_results(r1, r3, f"{label}: fused_round and urn_step")
        want = product[name]
        for res, kernel in ((r1, "fused_round"), (r3, "urn_step")):
            got = histogram_fields(res)
            rh = got["round_histogram"]
            diff = {k: (got[k], want[k]) for k in ("decision_histogram", "mean_rounds_decided")
                    if got[k] != want[k]}
            if diff or rh != want["round_histogram"][:len(rh)] or any(
                    want["round_histogram"][len(rh):]):
                fail(f"{label} through {kernel} differs from {PRODUCT_URN_FILE}: {diff}, "
                     f"rounds {[(r, c) for r, c in enumerate(rh) if c]}")
        say(f"[urn] {label} ({len(r1.inst_ids)} instances): fused_round and urn_step equal "
            f"per instance, and both equal {PRODUCT_URN_FILE}: decision_histogram "
            f"{got['decision_histogram']}, the round histogram, mean_rounds_decided "
            f"{got['mean_rounds_decided']}")
        if name in ("config2", "config3", "config4"):
            k3_paths.append(step_cell(cfg, "urn", f"{label} (K3)", card, dev))
    return k1_paths, k3_paths


def check_against_shard(res, cfg, label):
    """Instances 0..hi-1 of ``res`` against their committed record in
    ``artifacts/sweep_keys_shipped/``."""
    path = SWEEP_KEYS_SHIPPED_FILE.format(protocol=cfg.protocol, n=cfg.n, f=cfg.f,
                                          adversary=cfg.adversary, coin=cfg.coin,
                                          delivery=cfg.delivery,
                                          hi=min(256, cfg.instances))
    return check_per_instance(res, path, label), path


def keys_shipped_phase(card, dev):
    """config1-4 under the keys law through K2: ids 0-255 against the
    committed record, the plain version on the card on ids up to
    PLAIN_KEYS_IDS, the timed cells config2-4; then Ben-Or's Byzantine pairing
    under keys (K2) and urn (K1, K3) against its records. Returns the K2
    paths."""
    from byzantinerandomizedconsensus_tpu_torch import get_backend, preset
    from byzantinerandomizedconsensus_tpu_torch.config import SimConfig

    step, fused = get_backend("torch", kernel="step"), get_backend("torch")
    plain = get_backend("torch", kernel="plain")
    paths = []
    for name in ("config1", "config2", "config3", "config4"):
        cfg = preset(name, delivery="keys")
        label = f"{name} keys"
        res, _ = run_counted(step, cfg, "keys_step", f"{label} (K2)")
        n_ref, path = check_against_shard(res, cfg, label)
        cut = PLAIN_KEYS_IDS if cfg.instances > PLAIN_KEYS_IDS else None
        ids = None if cut is None else np.arange(cut)
        t0 = time.perf_counter()
        pres = plain.run(cfg, inst_ids=ids)
        plain_s = time.perf_counter() - t0
        k = len(pres.inst_ids)
        check_equal_results(types.SimpleNamespace(inst_ids=res.inst_ids[:k],
                                                  rounds=res.rounds[:k],
                                                  decision=res.decision[:k]),
                            pres, f"{label}: keys_step and the plain path")
        say(f"[keys] {label} ({len(res.inst_ids)} instances) through keys_step: ids "
            f"0-{n_ref - 1} equal {path}, ids 0-{k - 1} equal the plain path on the card "
            f"({plain_s:.1f} s); {histogram_fields(res)['decision_histogram']}")
        if name != "config1":
            paths.append(step_cell(cfg, "keys", f"{label} (K2)", card, dev,
                                   plain_ids=cut))
    for law in ("keys", "urn"):
        cfg = SimConfig(delivery=law, **BENOR_BYZANTINE).validate()
        label = f"Ben-Or byzantine n=64 f=12 {law}"
        runs = [run_counted(step, cfg, STEP_LAWS[law], f"{label} ({STEP_LAWS[law]})")[0]]
        if law == "urn":
            runs.append(run_counted(fused, cfg, "fused_round", f"{label} (fused_round)")[0])
        for res in runs:
            n_ref, path = check_against_shard(res, cfg, label)
        check_equal_results(runs[0], plain.run(cfg), f"{label}: kernel and plain path")
        say(f"[keys] {label}: ids 0-{n_ref - 1} through "
            f"{' and '.join(['keys_step'] if law == 'keys' else ['urn_step', 'fused_round'])} "
            f"equal {path} and the plain path on the card")
        if law == "keys":
            paths.append(step_cell(cfg, "keys", f"{label} (K2)", card, dev))
    return paths


def divergence_r5_phase():
    """The divergence tool's 15 rows under keys (K2) and urn (K1 and K3):
    mean rounds, p1 and the capped share of each law, and the sum of rounds
    equal to mean_rounds × instances."""
    from byzantinerandomizedconsensus_tpu_torch import get_backend
    from byzantinerandomizedconsensus_tpu_torch.config import SimConfig

    rows = json.loads((ROOT / DIVERGENCE_R5_FILE).read_text())["rows"]
    step, fused = get_backend("torch", kernel="step"), get_backend("torch")
    t0 = time.perf_counter()
    for row in rows:
        fields = {k: row[k] for k in ("protocol", "n", "f", "adversary", "coin", "seed",
                                      "round_cap", "instances")}
        for law, runs in (("keys", ((step, "keys_step"),)),
                          ("urn", ((fused, "fused_round"), (step, "urn_step")))):
            cfg = SimConfig(delivery=law, **fields).validate()
            for backend, kernel in runs:
                res, _ = run_counted(backend, cfg, kernel, f"divergence row {fields} {law}")
                got = {f"mean_rounds_{law}": float(res.rounds.mean()),
                       f"p1_{law}": float((res.decision == 1).mean()),
                       f"capped_{law}": float((res.decision == 2).mean())}
                total = int(res.rounds.sum())
                diff = {k: (v, row[k]) for k, v in got.items() if row[k] != v}
                if diff or total != round(row[f"mean_rounds_{law}"] * cfg.instances):
                    fail(f"divergence row {fields} under {law} through {kernel} differs "
                         f"from {DIVERGENCE_R5_FILE}: {diff}, sum of rounds {total}")
    say(f"[divergence] the {len(rows)} rows of {DIVERGENCE_R5_FILE}: mean rounds (sum of "
        f"rounds = mean × instances), p1 and capped equal under keys through keys_step and "
        f"under urn through fused_round and urn_step, in {time.perf_counter() - t0:.1f} s")


def urn_wide_phase(card, dev):
    """The two urn rows of artifacts/fused_r20.json, and config 5's shape
    under urn at n = 2048 and 4096, through K1 (layout R = 4 past 1024) and
    K3 (law v2) against the plain version; n = 4096 timed. Returns the K1
    path of n = 4096."""
    from byzantinerandomizedconsensus_tpu_torch import get_backend
    from byzantinerandomizedconsensus_tpu_torch.config import SimConfig, sweep_point
    from byzantinerandomizedconsensus_tpu_torch.models import driver
    from byzantinerandomizedconsensus_tpu_torch.ops import fused_round

    for fields in FUSED_R20_URN_ROWS:
        cfg = SimConfig(delivery="urn", **fields).validate()
        ids = torch.arange(cfg.instances, dtype=torch.int32, device=dev)
        rp, dp = compare(cfg, ids)
        if cfg.faults == "none":  # the per-step kernels have no fault channel
            rk, dk = driver.run_chunk(cfg, ids, counts_fn=step_module("urn").counts_fn)
            if not (torch.equal(rk, rp) and torch.equal(dk, dp)):
                fail(f"urn_step differs from plain on the fused_r20 row {fields}")
        say(f"[urn] {fields}: fused_round == plain"
            f"{' == urn_step' if cfg.faults == 'none' else ''} on its {cfg.instances} "
            f"instances; decisions {dp.tolist()}, rounds {rp.tolist()}")
    fused, step = get_backend("torch"), get_backend("torch", kernel="step")
    path = None
    for n in (2048, 4096):
        cfg = dataclasses.replace(sweep_point(n), delivery="urn").validate()
        label = f"config5 n={n} urn"
        if n == 4096:
            r1, path = shipped_run(fused, cfg, f"{label} (K1)", card,
                                   plain_pairs=PHASE9_PLAIN_PAIRS)
        else:
            r1, _ = run_counted(fused, cfg, "fused_round", f"{label} (K1)")
            ids = torch.as_tensor(r1.inst_ids, dtype=torch.int32, device=dev)
            chunk = max(1, PHASE9_PLAIN_PAIRS // cfg.n)
            rp = torch.cat([fused_round.run_chunk_plain(cfg, ids[lo:lo + chunk])[0]
                            for lo in range(0, len(ids), chunk)])
            if not np.array_equal(rp.cpu().numpy(), r1.rounds):
                fail(f"{label}: fused_round differs from plain")
        r3, _ = run_counted(step, cfg, "urn_step", f"{label} (K3)")
        check_equal_results(r1, r3, f"{label}: fused_round and urn_step")
        say(f"[urn] {label} ({cfg.instances} instances): fused_round ({fused_round.library(cfg)}) "
            f"== urn_step (law v2) == plain per instance; {histogram_fields(r1)['decision_histogram']}")
    k3 = step_cell(cfg, "urn", f"{label} (K3)", card, dev)
    return path, k3


def laws_phase(dev, card):
    """Phase 10: the keys and urn laws over the per-config surface. Returns
    (K1 paths, {library: its timed path}, K2 paths, K3 paths): the two urn
    libraries of K1 and the wide libraries of K2 and K3."""
    t0 = time.perf_counter()
    law_grid_phase(dev)
    k1_paths, k3_paths = urn_product_phase(card, dev)
    k2_paths = keys_shipped_phase(card, dev)
    divergence_r5_phase()
    wide, k3_wide = urn_wide_phase(card, dev)
    k1_paths.append(wide)
    k3_paths.append(k3_wide)
    libs = {"fused_round_urn_r1": next(p for p in k1_paths if p["config"] == "config4 urn (K1)"),
            "fused_round_urn_r4": wide,
            "keys_step_wide": next(p for p in k2_paths if p["library"] == "keys_step_wide"),
            "urn_step_wide": k3_wide}
    say(f"[laws] phase 10 took {time.perf_counter() - t0:.1f} s")
    return k1_paths, libs, k2_paths, k3_paths


def offset_grid(law):
    """Phase 11's per-step grid of receiver ranges: n = 16 with ranges that
    do not align with the kernels' tiles (the two-faced class boundary
    (n+1)/2 = 8 inside one), both protocols under every static adversary;
    and a v2 width, n = 2048 in four shards."""
    from byzantinerandomizedconsensus_tpu_torch.config import SimConfig

    out = []
    for protocol, adversary in (("bracha", "none"), ("bracha", "adaptive"),
                                ("bracha", "adaptive_min"), ("bracha", "byzantine"),
                                ("benor", "crash"), ("benor", "byzantine"),
                                ("benor", "adaptive")):
        out.append((SimConfig(protocol=protocol, n=16, f=f_of(protocol, 16, adversary),
                              instances=256, adversary=adversary, delivery=law,
                              coin="local" if protocol == "benor" else "shared",
                              round_cap=LAW_GRID_ROUNDS, seed=len(out) + 211).validate(),
                    OFFSET_RANGES))
    quarter = OFFSET_V2_N // OFFSET_V2_MODEL
    shards = tuple((m * quarter, (m + 1) * quarter) for m in range(OFFSET_V2_MODEL))
    for protocol, adversary in (("bracha", "adaptive"), ("benor", "byzantine")):
        out.append((SimConfig(protocol=protocol, n=OFFSET_V2_N,
                              f=f_of(protocol, OFFSET_V2_N, adversary), instances=64,
                              adversary=adversary, delivery=law, coin="shared",
                              round_cap=LAW_GRID_ROUNDS, seed=len(out) + 211).validate(),
                    shards))
    return out


def offset_checking_counts_fn(law, ranges, seen):
    """A delivery hook that runs the kernel at full width and on each
    receiver range, the plain version on each range, fails on any
    difference (range against plain and against the full width's rows), and
    returns the full width's counts. The ranges' ids are CPU tensors, so
    reading the offset does not wait for the card."""
    mod = step_module(law)

    def counts_fn(cfg, seed, ids, rnd, t, values, silent, faulty, honest):
        full = mod.counts_fn(cfg, seed, ids, rnd, t, values, silent, faulty, honest)
        for lo, hi in ranges:
            recv = torch.arange(lo, hi)
            got = mod.counts_fn(cfg, seed, ids, rnd, t, values, silent, faulty, honest,
                                recv_ids=recv)
            want = plain_step(law, cfg, seed, ids, rnd, t, values, silent, faulty, honest,
                              recv_ids=recv)
            err = max(step_counts_max_err(got, want),
                      step_counts_max_err(got, (full[0][:, lo:hi], full[1][:, lo:hi])))
            if err != 0:
                fail(f"{STEP_LAWS[law]} on receivers [{lo}, {hi}) differs from plain on "
                     f"{cfg}, round {rnd}, step {t}: max abs err {err}")
            seen["steps"] += 1
        return full

    return counts_fn


def mesh_cell(cfg, law, label, backend, ref, card, dev):
    """The timed cell of the (1, 4) layout: best of 3 walls (the counted run
    was the warm-up); every launch of the unsharded run recorded and
    replayed on each shard's receiver range: the kernel's device time of a
    whole sharded run (its 4 × launches in one CUDA graph) and of one launch
    at n_recv = 128 (shard 1's range), that launch's bound from the same
    counts as phase 10 over its rows, and the barrier overhead: the best
    wall less the kernel's time a run. Fails if the kernel beats its
    bound."""
    name = STEP_LAWS[law]
    n_model = backend.mesh.shape["model"]
    walls = [backend.timed_run(cfg).wall_s for _ in range(EARLIER_WALLS)]
    calls = recorded_launches(cfg, law, dev)
    mod = step_module(law)
    width = cfg.n // n_model
    ranges = [torch.arange(m * width, (m + 1) * width) for m in range(n_model)]
    run_ms = graph_run_ms([lambda c=call, r=r: mod.counts_fn(cfg, *c, recv_ids=r)
                           for call in calls for r in ranges])
    shard = ranges[1]
    launch_ms = graph_run_ms([lambda c=call: mod.counts_fn(cfg, *c, recv_ids=shard)
                              for call in calls]) / len(calls)
    err, plain_ms, bound_ms, ops_sum, bytes_sum = 0, 0.0, 0.0, 0.0, 0.0
    plain_ids = MESH_PLAIN_IDS if law == "keys" else None
    for call in calls:
        got = mod.counts_fn(cfg, *call, recv_ids=shard)
        seed, ids, rnd, t, *planes = call
        if plain_ids is not None:
            ids, planes = ids[:plain_ids], [x[:plain_ids] for x in planes]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain_step(law, cfg, seed, ids, rnd, t, *planes, recv_ids=shard)
        torch.cuda.synchronize()
        plain_ms += (time.perf_counter() - t0) * 1e3
        k = want[0].shape[0]
        err = max(err, step_counts_max_err((got[0][:k], got[1][:k]), want))
        o, b, _, _ = step_bound(law, cfg, call, shard)
        o_ms, b_ms = o / INT_OPS_PER_S * 1e3, b / HBM_BYTES_PER_S * 1e3
        bound_ms += max(o_ms, b_ms)
        ops_sum, bytes_sum = ops_sum + o_ms, bytes_sum + b_ms
    n_calls = len(calls)
    bound_ms /= n_calls
    if err != 0:
        fail(f"{name} on receivers 128-255 differs from plain on {label} (max abs err {err})")
    if launch_ms < bound_ms:
        fail(f"{name} took {launch_ms:.5f} ms a launch at n_recv = {width} on {label}, "
             f"under its bound of {bound_ms:.5f} ms: the bound's count is wrong")
    overhead_ms = min(walls) * 1e3 - run_ms
    on = "" if plain_ids is None else f" on ids 0-{plain_ids - 1}"
    say(f"[mesh] {label} through {name}: instances/s = {cfg.instances / min(walls)} (best of "
        f"{EARLIER_WALLS} walls {walls} s; unsharded wall {ref.wall_s} s); {name} "
        f"{run_ms:.4f} ms of device time a sharded run ({n_calls} steps x {n_model} shards "
        f"in one CUDA graph); {launch_ms:.5f} ms a launch at n_recv = {width} (receivers "
        f"{width}-{2 * width - 1}), bound {bound_ms:.5f} ms, kernel/bound "
        f"{launch_ms / bound_ms:.2f}; plain {plain_ms / n_calls:.1f} ms a step{on}; barrier "
        f"and driver overhead {overhead_ms:.1f} ms a run (best wall less the kernel time); "
        f"{card}")
    return {"config": label, "kernel": name, "layout": [backend.mesh.shape["data"], n_model],
            "instances": cfg.instances, "launches": None, "max_abs_err": err,
            "ms": launch_ms, "ms_run": run_ms, "n_recv": width, "plain_ms": plain_ms / n_calls,
            "plain_ids": plain_ids, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_sum >= bytes_sum else "bytes",
            "walls_s": walls, "unsharded_wall_s": ref.wall_s,
            "overhead_ms": overhead_ms, "instances_per_s": cfg.instances / min(walls)}


def mesh_phase(dev, card):
    """Phase 11: the replica-sharded path (``parallel/sharded.py``) on one
    card. Returns {kernel: [its sharded cells]}."""
    from byzantinerandomizedconsensus_tpu_torch import get_backend, preset
    from byzantinerandomizedconsensus_tpu_torch.config import sweep_point
    from byzantinerandomizedconsensus_tpu_torch.models import driver
    from byzantinerandomizedconsensus_tpu_torch.parallel.mesh import make_mesh
    from byzantinerandomizedconsensus_tpu_torch.parallel.sharded import TorchShardedBackend

    t0 = time.perf_counter()
    for law, name in STEP_LAWS.items():
        t1, seen = time.perf_counter(), {"steps": 0}
        grid = offset_grid(law)
        for cfg, ranges in grid:
            ids = torch.arange(cfg.instances, dtype=torch.int32, device=dev) * 7
            driver.run_chunk(cfg, ids, counts_fn=offset_checking_counts_fn(law, ranges, seen))
        say(f"[mesh] {name} with a receiver range == plain and == its full width's rows on "
            f"{seen['steps']} (step, range) pairs of {len(grid)} configs (n = 16 in ranges "
            f"{list(OFFSET_RANGES)}, n = {OFFSET_V2_N} in {OFFSET_V2_MODEL} shards; both "
            f"protocols, every static adversary, rounds 0-{LAW_GRID_ROUNDS - 1}) in "
            f"{time.perf_counter() - t1:.1f} s")

    cells = {}
    step, plain = get_backend("torch", kernel="step"), get_backend("torch", kernel="plain")
    for law, name in STEP_LAWS.items():
        cfg = preset("config4", delivery=law)
        ref, _ = run_counted(step, cfg, name, f"config4 {law} (unsharded)")
        ref = step.timed_run(cfg)
        pres = plain.run(cfg, inst_ids=np.arange(MESH_PLAIN_IDS))
        k = len(pres.inst_ids)

        def head(res):
            return types.SimpleNamespace(inst_ids=res.inst_ids[:k], rounds=res.rounds[:k],
                                         decision=res.decision[:k])

        check_equal_results(head(ref), pres, f"config4 {law}: unsharded {name} and plain")
        for layout in MESH_LAYOUTS:
            label = f"config4 {law} mesh {layout[0]}x{layout[1]}"
            backend = TorchShardedBackend(mesh=make_mesh(*layout, [dev] * MESH_DEVICES),
                                          kernel="step")
            res, launches = run_counted(backend, cfg, name, f"{label} ({name})")
            check_equal_results(ref, res, f"{label}: sharded and unsharded {name}")
            check_equal_results(head(res), pres, f"{label}: sharded {name} and plain")
            say(f"[mesh] {label} ({cfg.instances} instances) through {name} with receiver "
                f"offsets: == the unsharded {name} run per instance, ids 0-{k - 1} == plain; "
                f"{launches} launches; wall {res.wall_s} s; "
                f"{histogram_fields(res)['decision_histogram']}")
            if layout == MESH_TIMED:
                cell = mesh_cell(cfg, law, label, backend, ref, card, dev)
                cell["launches"] = launches
                cells.setdefault(name, []).append(cell)

    n2048 = json.loads((ROOT / N2048_FILE).read_text())["sharded_bitmatch_virtual_2x2_n2048"]
    fused = get_backend("torch")
    for leg in n2048:
        if not leg["match"]:
            fail(f"{N2048_FILE}'s virtual leg {leg} does not record a match")
        cfg = dataclasses.replace(sweep_point(2048, instances=leg["instances"]),
                                  delivery=leg["delivery"]).validate()
        want = fused.run(cfg)
        for label, backend in (("virtual:2x2", get_backend("virtual:2x2")),
                               ("torch_sharded 2x2 plain", TorchShardedBackend(
                                   mesh=make_mesh(2, 2, [dev] * 4), kernel="plain"))):
            check_equal_results(want, backend.run(cfg),
                                f"{N2048_FILE} leg {leg['delivery']} through {label}")
        say(f"[mesh] {N2048_FILE} leg {leg['mesh']} {leg['delivery']} n=2048 "
            f"({leg['instances']} instances, match: true): virtual:2x2 (CPU) and "
            f"torch_sharded 2x2 plain (card) == the unsharded fused_round run")

    cfg = preset("config4")
    ref, _ = run_counted(fused, cfg, "fused_round", "config4 (unsharded fused_round)")
    backend = TorchShardedBackend(mesh=make_mesh(2, 2, [dev] * 4), kernel="fused")
    res, launches = run_counted(backend, cfg, "fused_round", "config4 mesh 2x2 fused")
    check_equal_results(ref, res, "config4 mesh 2x2: sharded and unsharded fused_round")
    if launches != 2:
        fail(f"config4 mesh 2x2 fused: {launches} launches of fused_round, not one per "
             f"data shard")
    say(f"[mesh] config4 mesh 2x2 through fused_round (data axis only: {launches} launches, "
        f"one per data shard) == the unsharded run per instance on {cfg.instances} instances")
    say(f"[mesh] phase 11 took {time.perf_counter() - t0:.1f} s")
    return cells


def run_cli(argv) -> tuple:
    """``cli.main(argv)`` in this process, its stdout and stderr captured:
    ``(exit code, the last stdout line as JSON or None, seconds)``."""
    import contextlib
    import io

    from byzantinerandomizedconsensus_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    seconds = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    if rc not in (0, 1, 2):
        fail(f"cli {' '.join(argv)} exited {rc}: {err.getvalue()[-2000:]}")
    return rc, json.loads(lines[-1]) if lines else None, seconds


def strip_walls(points: dict) -> dict:
    return {n: {k: v for k, v in s.items() if k not in ("wall_s", "instances_per_sec")}
            for n, s in points.items()}


def sweep_cli_phase(card):
    """Phase 12a: ``cli sweep`` at config 5's full size into an empty
    directory, held shard by shard against ``artifacts/sweep_urn2/``; its
    resume (no launch) and a deleted shard's recompute (that shard's
    launches alone). Returns fused_round's path entry."""
    import tempfile

    from byzantinerandomizedconsensus_tpu_torch import get_backend
    from byzantinerandomizedconsensus_tpu_torch.config import SWEEP_INSTANCES, SWEEP_NS, sweep_point
    from byzantinerandomizedconsensus_tpu_torch.ops import fused_round, prf
    from byzantinerandomizedconsensus_tpu_torch.utils import checkpoint

    ref_dir = ROOT / SWEEP_URN2_DIR
    shards = [(n, lo) for n in SWEEP_NS for lo in range(0, SWEEP_INSTANCES, SWEEP_SHARD)]
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "sweep"
        argv = ["sweep", "--out", str(out)]
        reset_launches()
        rc, rec, wall = run_cli(argv)
        launches = read_launches()
        if rc != 0 or rec is None:
            fail(f"cli sweep exited {rc}")
        if launches["fused_round"] < len(shards) or launches["keys_step"] or launches["urn_step"]:
            fail(f"cli sweep did not run its {len(shards)} shards through fused_round: "
                 f"launches {launches}")
        names = sorted(p.name for p in out.glob("*.npz"))
        want_names = sorted(p.name for p in ref_dir.glob("*.npz"))
        if names != want_names or len(names) != len(shards):
            fail(f"cli sweep wrote {len(names)} shards {names[:2]}..., not the "
                 f"{len(want_names)} of {SWEEP_URN2_DIR}")
        for name in names:
            got, want = np.load(out / name), np.load(ref_dir / name)
            for key in ("inst_ids", "rounds", "decision"):
                if got[key].dtype != want[key].dtype or not np.array_equal(got[key], want[key]):
                    fail(f"cli sweep shard {name}: {key} differs from {SWEEP_URN2_DIR}")
            # The reference's shards predate the faults field; it takes its default.
            if checkpoint.load_shard(out / name).config != \
                    checkpoint.load_shard(ref_dir / name).config:
                fail(f"cli sweep shard {name}: its config differs from {SWEEP_URN2_DIR}")
        k1_ms = wrapper_ms = 0.0
        for n, lo in shards:
            cfg = sweep_point(n)
            ids = torch.arange(lo, lo + SWEEP_SHARD, dtype=torch.int32, device="cuda")
            planes = fused_round.operand_planes(cfg, ids, prf.seed_key(cfg.seed))
            k1_ms += cuda_ms(lambda: fused_round.run_chunk(cfg, ids, planes=planes), 3)
            wrapper_ms += cuda_ms(lambda: fused_round.run_chunk(cfg, ids), 3)
        say(f"[sweep] cli sweep, config 5 at full size ({len(SWEEP_NS)} n x "
            f"{SWEEP_INSTANCES} instances, {len(names)} shards of {SWEEP_SHARD}): every shard "
            f"equal to {SWEEP_URN2_DIR} (inst_ids, rounds, decision, config); "
            f"{launches['fused_round']} fused_round launches; wall {wall} s, "
            f"{len(names) / wall} shards/s, {len(SWEEP_NS) * SWEEP_INSTANCES / wall} "
            f"instances/s; summed over its shards (CUDA events, mean of 3 each), K1 "
            f"{k1_ms:.4f} ms with the planes built beforehand, the wrapper (planes and K1) "
            f"{wrapper_ms:.4f} ms; {card}")

        reset_launches()
        rc, again, resume_wall = run_cli(argv)
        if rc != 0 or sum(read_launches().values()):
            fail(f"the resumed cli sweep exited {rc} with launches {read_launches()}")
        if strip_walls(again["points"]) != strip_walls(rec["points"]):
            fail("the resumed cli sweep's points differ from the first run's")

        n, lo = SWEEP_DELETED
        cfg = sweep_point(n)
        victim = checkpoint.shard_name(cfg, lo, lo + SWEEP_SHARD)
        reset_launches()
        get_backend("torch").run(cfg, np.arange(lo, lo + SWEEP_SHARD))
        per_shard = read_launches()["fused_round"]
        (out / victim).unlink()
        reset_launches()
        rc, third, redo_wall = run_cli(argv)
        redo = read_launches()
        if rc != 0 or redo["fused_round"] != per_shard or redo["keys_step"] or redo["urn_step"]:
            fail(f"recomputing the deleted shard {victim}: rc {rc}, launches {redo}, "
                 f"not the shard's {per_shard}")
        got, want = np.load(out / victim), np.load(ref_dir / victim)
        if not (np.array_equal(got["rounds"], want["rounds"])
                and np.array_equal(got["decision"], want["decision"])):
            fail(f"the recomputed shard {victim} differs from {SWEEP_URN2_DIR}")
        if strip_walls(third["points"]) != strip_walls(rec["points"]):
            fail("the sweep with a recomputed shard differs from the first run's points")
    say(f"[sweep] resumed: 0 launches, the same points, wall {resume_wall} s; with "
        f"{victim} deleted: {redo['fused_round']} launch(es) (the shard's own), the shard "
        f"equal to the reference again, wall {redo_wall} s; {card}")
    return {"config": f"cli sweep (config 5, {len(SWEEP_NS)} n x {SWEEP_INSTANCES} "
                      f"instances, {len(names)} shards)",
            "launches": launches["fused_round"], "max_abs_err": 0, "wall_s": wall,
            "shards_per_s": len(names) / wall,
            "instances_per_s": len(SWEEP_NS) * SWEEP_INSTANCES / wall,
            "k1_ms_sum": k1_ms, "wrapper_ms_sum": wrapper_ms,
            "resume_wall_s": resume_wall, "resume_launches": 0,
            "recompute_launches": redo["fused_round"], "recompute_wall_s": redo_wall}


def bitmatch_phase(card):
    """Phase 12b: ``cli bitmatch`` on the card against the C++ core through
    K1, K2 and K3, and against the object oracle on two small configs.
    Returns {kernel: [path entries]}."""
    from byzantinerandomizedconsensus_tpu_torch.backends import native_backend

    t0 = time.perf_counter()
    native_backend.load()
    say(f"[bitmatch] the native core built with g++ in {time.perf_counter() - t0:.1f} s")
    paths = {}
    runs = [(["--preset", "config4", "--delivery", law, "--samples", str(samples),
              "--arbiter", "native", *extra], kernel, f"config4 {law}{label} vs native")
            for law, extra, kernel, label, samples in BITMATCH_NATIVE]
    runs += [(argv, "fused_round", label) for argv, label in BITMATCH_ORACLE]
    for argv, kernel, label in runs:
        reset_launches()
        rc, out, wall = run_cli(["bitmatch", *argv])
        launches = read_launches()
        if rc != 0 or not out["bitmatch"]:
            fail(f"cli bitmatch {label}: rc {rc}, {out}")
        others = {k: v for k, v in launches.items() if k != kernel and v}
        if launches[kernel] < 1 or others:
            fail(f"cli bitmatch {label} did not run through {kernel} alone: {launches}")
        say(f"[bitmatch] {label}: rc 0, {out['n_samples']} samples of {out['instances']} "
            f"instances identical; {launches[kernel]} {kernel} launch(es); arbiter "
            f"{out['arbiter_wall_s']:.3f} s, backend {out['backend_wall_s']:.4f} s, cli wall "
            f"{wall:.3f} s; {card}")
        paths.setdefault(kernel, []).append({
            "config": f"cli bitmatch {label}", "samples": out["n_samples"],
            "launches": launches[kernel], "max_abs_err": 0, "wall_s": wall,
            "arbiter_wall_s": out["arbiter_wall_s"],
            "backend_wall_s": out["backend_wall_s"]})
    return paths


def counters_cli_phase(card):
    """Phase 12c: ``cli run --counters`` on the card through the plain path,
    equal to the same run on the CPU; under fused_round, the run made as
    asked with the unsupported block."""
    argv = ["run", "--preset", "config3", "--instances", str(COUNTER_INSTANCES), "--counters"]
    reset_launches()
    rc, card_out, wall = run_cli(argv + ["--kernel", "plain"])
    if rc != 0 or sum(read_launches().values()):
        fail(f"cli run --counters --kernel plain: rc {rc}, launches {read_launches()}")
    rc, cpu_out, cpu_wall = run_cli(argv + ["--kernel", "plain", "--device", "cpu"])
    if rc != 0 or card_out["counters"] != cpu_out["counters"] or \
            card_out["decision_histogram"] != cpu_out["decision_histogram"]:
        fail(f"config3's counters on the card differ from the CPU's: {card_out['counters']} "
             f"vs {cpu_out['counters']}")
    reset_launches()
    rc, fused_out, _ = run_cli(argv)
    if rc != 0 or fused_out["counters"]["supported"] or read_launches()["fused_round"] < 1 \
            or fused_out["decision_histogram"] != card_out["decision_histogram"]:
        fail(f"cli run --counters under fused_round: rc {rc}, {fused_out.get('counters')}, "
             f"launches {read_launches()}")
    say(f"[counters] config3 ({COUNTER_INSTANCES} instances) run --counters --kernel plain "
        f"on the card == on the CPU: {len(card_out['counters']['totals'])} totals, "
        f"rounds_active {card_out['counters']['totals']['rounds_active']}; walls "
        f"{wall:.3f} s (card) and {cpu_wall:.3f} s (CPU); under fused_round the run is made "
        f"by the kernel and the JSON carries the unsupported block "
        f"({fused_out['counters']['reason'][:60]}...); {card}")


def sweep_bitmatch_phase(card):
    """Phase 12: the config-5 sweep, the bit-match check and the counters
    through the CLI. Returns {kernel: [path entries]}."""
    t0 = time.perf_counter()
    paths = {"fused_round": [sweep_cli_phase(card)]}
    for kernel, entries in bitmatch_phase(card).items():
        paths.setdefault(kernel, []).extend(entries)
    counters_cli_phase(card)
    say(f"[sweep] phase 12 took {time.perf_counter() - t0:.1f} s")
    return paths


# Phase 13: the lane runners on the plain round driver.
LANE_STRICT = dict(protocol="bracha", n=64, adversary="crash", coin="shared",
                   delivery="urn2", instances=2000)
LANE_MIXED_NS = (40, 48, 56, 64)
LANE_FUSED_CONFIGS = 40
LANE_FUSED_INSTANCES = 500
LANE_FUSED_SEED = 12
LANE_PARK_IDS = 20_000
LANE_PARK_WIDTH = 4096


def lane_results_equal(res, ref, label):
    """Per instance: the lane's (rounds, decision) against ``ref``'s."""
    if not (np.array_equal(np.asarray(res.inst_ids), np.asarray(ref.inst_ids))
            and np.array_equal(res.rounds, ref.rounds)
            and np.array_equal(res.decision, ref.decision)):
        bad = int((res.rounds != ref.rounds).sum() + (res.decision != ref.decision).sum())
        fail(f"lanes differ from the per-config run on {label}: {bad} mismatches")


def lanes_launched_nothing(label):
    """The lanes run the plain driver: no kernel may have launched."""
    if sum(read_launches().values()):
        fail(f"{label} launched kernels {read_launches()}: the lanes run kernel='plain'")


def per_config_k1(cfgs, ids=None):
    """Each config's per-config run through fused_round (plain where the
    kernel refuses it by name): ``(results, wall_s, refused)``."""
    from byzantinerandomizedconsensus_tpu_torch import get_backend
    from byzantinerandomizedconsensus_tpu_torch.ops.fused_round import FusedUnsupported

    k1, plain = get_backend("torch", kernel="fused"), get_backend("torch", kernel="plain")
    out, refused = [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, cfg in enumerate(cfgs):
        try:
            out.append(k1.run(cfg, None if ids is None else ids[i]))
        except FusedUnsupported:
            refused += 1
            out.append(plain.run(cfg, None if ids is None else ids[i]))
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, refused


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def fused_lane_grid():
    """The superset grid: ``LANE_FUSED_CONFIGS`` valid configs drawn from a
    fixed seed over every folded axis, n 4-40, caps 64-256."""
    import random

    from byzantinerandomizedconsensus_tpu_torch.config import SimConfig

    rng = random.Random(LANE_FUSED_SEED)
    out = []
    while len(out) < LANE_FUSED_CONFIGS:
        protocol = FUSED_PROTOCOLS[len(out) % 2]
        adversary = rng.choice(FUSED_ADVERSARIES)
        n = rng.randint(4, 40)
        try:
            cfg = SimConfig(protocol=protocol, n=n, f=rng.randint(0, f_of(protocol, n, adversary)),
                            instances=LANE_FUSED_INSTANCES, adversary=adversary,
                            coin=rng.choice(("local", "shared")), seed=rng.randint(0, 2 ** 32),
                            round_cap=rng.randint(64, 256), crash_window=rng.randint(1, 8),
                            init=rng.choice(INITS), delivery="urn2",
                            faults=rng.choice(FUSED_FAULTS)).validate()
        except ValueError:
            continue
        out.append(cfg)
    return out


def lanes_strict_phase(card):
    """Phase 13a: the strict bucket and the mixed-n set through run_batch."""
    from byzantinerandomizedconsensus_tpu_torch.backends import batch

    lanes = get_plain_backend()
    strict, mixed = lane_strict_mixed()
    buckets = {batch.ShapeBucket.of(c) for c in strict + mixed}
    if len(buckets) != 1:
        fail(f"the strict and mixed-n sets span {len(buckets)} buckets")
    out = {}
    for label, cfgs in (("strict", strict), ("mixed-n", mixed)):
        walls = []
        for rep in range(2):
            before = lanes.compile_cache_stats()
            reset_launches()
            res, wall = timed(lambda: lanes.run_batch(cfgs))
            lanes_launched_nothing(f"run_batch ({label})")
            after = lanes.compile_cache_stats()
            new = after["compiles"] - before["compiles"]
            want = 1 if (label == "strict" and rep == 0) else 0
            if new != want or after["hits"] - before["hits"] != 1 - want:
                fail(f"run_batch ({label}, run {rep + 1}): {new} new cache entries "
                     f"({before} -> {after}), not {want}")
            walls.append(wall)
        k1, k1_wall, refused = per_config_k1(cfgs)
        for c, a, b in zip(cfgs, res, k1):
            lane_results_equal(a, b, f"{label} n={c.n} f={c.f} seed={c.seed}")
        _, plain_wall = timed(lambda: [get_plain_backend().run(c) for c in cfgs])
        say(f"[lanes] run_batch, {label} bucket {batch.ShapeBucket.of(cfgs[0]).label()}: "
            f"16 lanes x {LANE_STRICT['instances']} instances equal to 16 per-config "
            f"fused_round runs instance by instance (0 kernel launches in the lane runs); "
            f"walls {walls} s (run 1, run 2) against 16 per-config plain runs "
            f"{plain_wall:.3f} s and 16 per-config K1 runs {k1_wall:.3f} s; cache "
            f"{lanes.compile_cache_stats()}; {card}")
        out[label] = {"run_batch_walls_s": walls, "plain_wall_s": plain_wall,
                      "k1_wall_s": k1_wall}
    return out


@functools.lru_cache(maxsize=None)
def get_plain_backend():
    """The one card backend on kernel='plain' the lane phase runs on (its
    compile cache persists across the phase)."""
    from byzantinerandomizedconsensus_tpu_torch import get_backend

    return get_backend("torch", kernel="plain")


def lanes_fused_phase(card):
    """Phase 13b: the superset grid through run_fused, without and with
    compaction, each config against its per-config K1 run."""
    from byzantinerandomizedconsensus_tpu_torch.backends.compaction import CompactionPolicy

    cfgs = fused_lane_grid()
    k1, k1_wall, refused = per_config_k1(cfgs)
    out = {"k1_wall_s": k1_wall, "k1_refused": refused}
    for label, kw in (("fused", {}), ("fused+compaction", {"compaction": CompactionPolicy()})):
        reset_launches()
        (res, report), wall = timed(lambda: get_plain_backend().run_fused(cfgs, **kw))
        lanes_launched_nothing(f"run_fused ({label})")
        for c, a, b in zip(cfgs, res, k1):
            lane_results_equal(a, b, f"{label}: {c}")
        comp = report.get("compaction")
        say(f"[lanes] run_fused ({label}): {len(cfgs)} superset configs "
            f"(both protocols, {len(set(c.adversary for c in cfgs))} adversaries, "
            f"{len(set(c.faults for c in cfgs))} schedules, both coins, "
            f"{len(set(c.init for c in cfgs))} inits, n {min(c.n for c in cfgs)}-"
            f"{max(c.n for c in cfgs)}, caps {min(c.round_cap for c in cfgs)}-"
            f"{max(c.round_cap for c in cfgs)}, {LANE_FUSED_INSTANCES} instances each) in "
            f"{report['buckets']} bucket(s), each equal to its per-config K1 run "
            f"({refused} refused by K1, held against plain); wall {wall:.3f} s against "
            f"40 per-config K1 runs {k1_wall:.3f} s"
            + (f"; compaction {comp}" if comp else "") + f"; {card}")
        out[label] = {"wall_s": wall, "compaction": comp}
    return out


def lanes_compacted_phase(card):
    """Phase 13c: config4 at full width through run_many(compaction=)."""
    from byzantinerandomizedconsensus_tpu_torch import get_backend, preset
    from byzantinerandomizedconsensus_tpu_torch.backends.compaction import CompactionPolicy

    c4 = preset("config4")
    reset_launches()
    (res, report), wall = timed(lambda: get_plain_backend().run_many(
        [c4], compaction=CompactionPolicy()))
    lanes_launched_nothing("run_many(compaction=) on config4")
    (k1,), k1_wall, _ = per_config_k1([c4])
    lane_results_equal(res[0], k1, "config4 through the compacted grid")
    plain, plain_wall = timed(lambda: get_plain_backend().run(c4))
    lane_results_equal(plain, k1, "config4's plain per-chunk run")
    comp = report["compaction"]
    say(f"[lanes] config4, {c4.instances} instances, through run_many(compaction="
        f"CompactionPolicy()): equal to K1 per instance; wall {wall:.3f} s against the "
        f"plain per-chunk run {plain_wall:.3f} s and K1 {k1_wall:.4f} s; compaction block "
        f"{json.dumps(comp)} (occupancy {comp['occupancy']}, wasted lane-rounds "
        f"{comp['device_lane_rounds'] - comp['useful_lane_rounds']} of "
        f"{comp['device_lane_rounds']}, {comp['segments']} segments incl. the drain, "
        f"{comp['refills']} refills); {card}")
    return {"wall_s": wall, "plain_wall_s": plain_wall, "k1_wall_s": k1_wall,
            "compaction": comp}


def lanes_park_phase(card):
    """Phase 13d: park config4 at the first boundary after a refill,
    round-trip the records through JSON and resume in a fresh grid."""
    from byzantinerandomizedconsensus_tpu_torch import preset
    from byzantinerandomizedconsensus_tpu_torch.backends import batch, compaction, lanestate

    c4 = preset("config4")
    ids = np.arange(LANE_PARK_IDS, dtype=np.int64)
    bucket = batch.ShapeBucket.of(c4)
    # One round a segment, so the boundary after the first refill still
    # holds undecided rows (config4 decides in one or two rounds).
    policy = compaction.CompactionPolicy(width=LANE_PARK_WIDTH, segment=1)
    be = get_plain_backend()
    whole, _, _ = compaction.run_bucket(be, bucket, [c4], [ids], policy=policy)
    ctl = lanestate.LaneControl()
    first = {}

    def park_after_refill(msg):
        queued = int(msg.rsplit(", ", 1)[1].split()[0])
        first.setdefault("queued", queued)
        if queued < first["queued"] and not first.get("asked"):
            first["asked"] = True
            ctl.park()

    reset_launches()
    t0 = time.perf_counter()
    _, _, stats = compaction.run_bucket(be, bucket, [c4], [ids], policy=policy,
                                        control=ctl, progress=park_after_refill)
    park_wall = time.perf_counter() - t0
    recs = ctl.parked
    if not (stats["parked_exit"] and stats["refills"] >= 1 and recs
            and recs[0].lane_count() > 0):
        fail(f"the park did not land after a refill with live lanes: {stats}")
    t0 = time.perf_counter()
    wire = json.dumps([r.to_doc() for r in recs])
    thawed = [lanestate.LaneRecord.from_doc(d) for d in json.loads(wire)]
    codec_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    resumed, _, rstats = compaction.run_bucket(be, bucket, [], [], policy=policy,
                                               imports=thawed)
    resume_wall = time.perf_counter() - t0
    lanes_launched_nothing("the parked and resumed grids")
    lane_results_equal(resumed[0], whole[0], "config4 parked and resumed")
    say(f"[lanes] config4 ids 0-{LANE_PARK_IDS - 1}, width {LANE_PARK_WIDTH}, segment 1: "
        f"parked by "
        f"LaneControl after {stats['segments']} segments and {stats['refills']} refill(s) "
        f"({recs[0].doc_summary()}), {len(wire)} bytes of JSON, resumed in a fresh grid "
        f"({rstats['restored_lanes']} lanes restored): equal to the uninterrupted run; "
        f"walls: park {park_wall:.3f} s, codec {codec_wall:.3f} s, resume "
        f"{resume_wall:.3f} s; {card}")
    return {"park_wall_s": park_wall, "codec_wall_s": codec_wall,
            "resume_wall_s": resume_wall, "json_bytes": len(wire),
            "restored_lanes": rstats["restored_lanes"]}


def lanes_sweep_phase(card):
    """Phase 13e: ``cli sweep --batched --kernel plain`` at config 5's full
    size into an empty directory, every shard equal to
    ``artifacts/sweep_urn2/``; without ``--kernel plain``, the refusal."""
    import tempfile

    ref_dir = ROOT / SWEEP_URN2_DIR
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "sweep"
        try:
            run_cli(["sweep", "--out", str(out), "--batched"])
            fail("cli sweep --batched without --kernel plain ran")
        except ValueError as e:
            if "kernel='plain'" not in str(e) or list(out.glob("*.npz")):
                fail(f"cli sweep --batched without --kernel plain: {e}")
            refusal = str(e)
        reset_launches()
        rc, rec, wall = run_cli(["sweep", "--out", str(out), "--batched", "--kernel", "plain"])
        lanes_launched_nothing("cli sweep --batched --kernel plain")
        names = sorted(p.name for p in out.glob("*.npz"))
        want = sorted(p.name for p in ref_dir.glob("*.npz"))
        if rc != 0 or names != want or len(names) != 32:
            fail(f"cli sweep --batched wrote {len(names)} shards, rc {rc}")
        for name in names:
            got, ref = np.load(out / name), np.load(ref_dir / name)
            for key in ("inst_ids", "rounds", "decision"):
                if not np.array_equal(got[key], ref[key]):
                    fail(f"cli sweep --batched shard {name}: {key} differs from "
                         f"{SWEEP_URN2_DIR}")
    say(f"[lanes] cli sweep --batched --kernel plain, config 5 at full size: {len(names)} "
        f"shards equal to {SWEEP_URN2_DIR} (0 kernel launches); wall {wall:.3f} s; "
        f"without --kernel plain: ValueError ({refusal[:80]}...); {card}")
    return {"wall_s": wall, "shards": len(names)}


def lanes_phase(card):
    """Phase 13: the lane runners. Returns the phase's summary."""
    t0 = time.perf_counter()
    out = {"strict": lanes_strict_phase(card), "fused": lanes_fused_phase(card),
           "compacted": lanes_compacted_phase(card), "park": lanes_park_phase(card),
           "sweep_batched": lanes_sweep_phase(card)}
    out["phase_wall_s"] = time.perf_counter() - t0
    say(f"[lanes] phase 13 took {out['phase_wall_s']:.1f} s")
    say("[lanes] " + json.dumps({"lanes": out}))
    return out


# Phase 14: the consensus server on the card.
SERVE_CEILING = 256
SERVE_HTTP_TIMEOUT = 120.0
SERVE_WAIT_S = 300.0
SERVE_START_S = 180.0
SERVE_LANE_POLICY = "width=4096,segment=1"
SERVE_FAT_INSTANCES = 20_000


def http_json(base, path, payload=None, method=None):
    """``(status, JSON document)`` of one HTTP call, with a timeout."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=SERVE_HTTP_TIMEOUT) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def poll_result(base, rid):
    """``GET /result/<rid>`` until it stops answering 202."""
    deadline = time.monotonic() + SERVE_WAIT_S
    while time.monotonic() < deadline:
        code, doc = http_json(base, f"/result/{rid}")
        if code != 202:
            return code, doc
        time.sleep(0.005)
    fail(f"no result for {rid} within {SERVE_WAIT_S} s")


def wait_answered(base, n):
    """Poll the small ``GET /stats`` (not the replies) until ``n`` requests
    are answered, so the client's JSON work does not contend with the
    dispatcher for the interpreter while the requests are timed."""
    deadline = time.monotonic() + SERVE_WAIT_S
    while time.monotonic() < deadline:
        _, st = http_json(base, "/stats")
        if st["replied"] + st["failed"] + st["cancelled"] >= n:
            return
        time.sleep(0.02)
    fail(f"{n} requests not answered within {SERVE_WAIT_S} s")


def offline_wall(backend, cfg, reps: int = 3):
    """``(result, best wall of reps timed runs)`` of the offline run."""
    runs = [backend.timed_run(cfg) for _ in range(reps)]
    return runs[0], min(r.wall_s for r in runs)


def http_front(srv):
    """``serve_http`` over a started server on an ephemeral port."""
    import threading

    from byzantinerandomizedconsensus_tpu_torch.serve.server import serve_http

    httpd = serve_http(srv, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, "http://%s:%s" % httpd.server_address[:2]


def reply_equal(rec, res, label):
    """A reply record per instance against a SimResult."""
    if not (rec["inst_ids"] == [int(i) for i in res.inst_ids]
            and rec["rounds"] == res.rounds.tolist()
            and rec["decision"] == res.decision.tolist()):
        bad = int((np.asarray(rec["rounds"]) != res.rounds).sum()
                  + (np.asarray(rec["decision"]) != res.decision).sum())
        fail(f"the served reply for {label} differs from the offline run: {bad} mismatches")


def request_ms(req) -> dict:
    """A served request's latency, queue wait and service time (ms)."""
    return {"latency_ms": req.latency_s * 1e3,
            "queue_ms": (req.t_dispatch - req.t_submit) * 1e3,
            "service_ms": (req.t_reply - req.t_dispatch) * 1e3}


def served_line(label, cfg, req, offline_wall):
    t = request_ms(req)
    say(f"[serve] {label}: {cfg.instances} instances, latency {t['latency_ms']:.3f} ms "
        f"(queue {t['queue_ms']:.3f}, service {t['service_ms']:.3f}); served "
        f"{cfg.instances / req.latency_s:.1f} instances/s against the offline run's wall "
        f"{offline_wall * 1e3:.3f} ms ({cfg.instances / offline_wall:.1f} instances/s)")
    return {"config": label, "instances": cfg.instances, **t,
            "offline_wall_ms": offline_wall * 1e3}


def serve_direct_configs():
    """Phase 14a's requests: ``(label, config, envelope)``; config1 is the
    request cancelled while queued (behind config4 under keys)."""
    from byzantinerandomizedconsensus_tpu_torch.config import (
        committee_point, preset, sweep_point)

    c4, c3 = preset("config4"), preset("config3")
    return [("config4", c4, {}),
            ("config4 keys", dataclasses.replace(c4, delivery="keys").validate(), {}),
            ("config1 (cancelled)", preset("config1"), {}),
            ("config5@512 keys", dataclasses.replace(sweep_point(512),
                                                     delivery="keys").validate(), {}),
            ("config2 urn", dataclasses.replace(preset("config2"),
                                                delivery="urn").validate(), {}),
            ("committee_point(8192)", committee_point(8192), {}),
            ("config3 session x4", c3, {"session_slots": 4})]


def serve_direct_phase(card):
    """Phase 14a: the direct leg over HTTP, K1 and K2 through
    ``get_backend("torch")``, then K3 through ``kernel="step"``."""
    from byzantinerandomizedconsensus_tpu_torch import get_backend, preset
    from byzantinerandomizedconsensus_tpu_torch.config import sweep_point
    from byzantinerandomizedconsensus_tpu_torch.models import session
    from byzantinerandomizedconsensus_tpu_torch.serve.server import ConsensusServer

    reqs = serve_direct_configs()
    c3 = preset("config3")
    srv = ConsensusServer(get_backend("torch"), round_cap_ceiling=SERVE_CEILING).start()
    httpd, base = http_front(srv)
    try:
        if srv.leg != "direct" or srv.device.type != "cuda":
            fail(f"get_backend('torch') served on the {srv.leg} leg on {srv.device}")
        reset_launches()
        t0 = time.perf_counter()
        ids = []
        for label, cfg, env in reqs:
            code, doc = http_json(base, "/submit", {**dataclasses.asdict(cfg), **env})
            if code != 200:
                fail(f"POST /submit {label}: {code} {doc}")
            ids.append(doc["id"])
            if label.endswith("(cancelled)"):
                code, ack = http_json(base, f"/cancel/{doc['id']}", {}, method="POST")
                if code != 200 or ack.get("where") != "queued":
                    fail(f"POST /cancel/{doc['id']}: {code} {ack}, not cancelled while queued")
        wait_answered(base, len(ids))
        wall = time.perf_counter() - t0
        recs = [poll_result(base, rid) for rid in ids]
        code, inv = http_json(base, "/run", {**dataclasses.asdict(c3), "check_invariants": True})
        if code != 200:
            fail(f"POST /run config3 check_invariants: {code} {inv}")
        warm = srv.compile_count()
        # the steady state, one request at a time: each alone on the server
        again = [http_json(base, "/run", dataclasses.asdict(reqs[i][1])) for i in (0, 3, 4)]
        steady = srv.compile_count() - warm
        launches = read_launches()
        handles = dict(httpd.requests)
        say(f"[serve] direct leg stats: {json.dumps(srv.stats())}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.shutdown(timeout=SERVE_WAIT_S)
    if launches["fused_round"] < 1 or launches["keys_step"] < 1 or launches["urn_step"]:
        fail(f"the direct leg's launches {launches}: K1 and K2, not K3, expected")
    if steady != 0:
        fail(f"the direct leg built {steady} kernel libraries after the warm-up")
    if any(code != 200 for code, _ in again):
        fail(f"the second pass: {[code for code, _ in again]}")
    if inv["invariants"]["violations"] or \
            inv["invariants"]["checked_instances"] != c3.instances:
        fail(f"config3's invariant block on the card: {inv['invariants']}")
    rows, walls = [], {}
    for (label, cfg, env), rid, (code, rec) in zip(reqs, ids, recs):
        if label.endswith("(cancelled)"):
            if code != 500 or rec.get("error") != "cancelled":
                fail(f"the cancelled request answered {code} {rec}")
            continue
        if code != 200:
            fail(f"GET /result/{rid} ({label}): {code} {rec}")
        off, off_wall = offline_wall(get_backend("torch"), cfg)
        reply_equal(rec, off, label)
        if "session_slots" in env:
            ref = session.run_session(get_backend("torch"), cfg, env["session_slots"])
            blk = rec["session"]
            if blk["decisions"] != [r.decision.tolist() for r in ref] or \
                    blk["rounds"] != [r.rounds.tolist() for r in ref] or \
                    blk["seeds"] != [int(r.config.seed) for r in ref]:
                fail("the served config3 session differs from run_session")
        rows.append(served_line(f"{label} (burst)", cfg, handles[rid], off_wall))
        walls[label] = off_wall
    dh = np.bincount(recs[0][1]["decision"], minlength=3).tolist()
    rh = np.bincount(recs[0][1]["rounds"], minlength=257).tolist()
    if dh != CONFIG4_DECISIONS or rh[:4] != CONFIG4_ROUNDS_HEAD or any(rh[4:]):
        fail(f"config4 served: histograms {dh}, {rh[:6]} differ from the reference")
    for (label, cfg, _), (code, rec) in zip((reqs[0], reqs[3], reqs[4]), again):
        reply_equal(rec, get_backend("torch").run(cfg), "the second pass")
        rows.append(served_line(f"{label} (alone)", cfg, handles[rec["request_id"]],
                                walls[label]))
    say(f"[serve] direct leg over HTTP on {srv.device}: {len(ids)} submits, 1 cancelled "
        f"while queued, 1 POST /run with check_invariants ({c3.instances} instances, 0 "
        f"violations, checked on {srv.device}); every reply equal to get_backend('torch')"
        f".run per instance, config4 equal to the reference histograms, the session equal "
        f"to run_session slot by slot; launches {launches}; kernel libraries built or "
        f"loaded: {warm}, then {steady} new on the second pass; wall {wall:.3f} s; {card}")

    k3_cfg = dataclasses.replace(sweep_point(512), delivery="urn").validate()
    step = get_backend("torch", kernel="step")
    srv = ConsensusServer(step, round_cap_ceiling=SERVE_CEILING).start()
    httpd, base = http_front(srv)
    try:
        reset_launches()
        # twice: the second is the steady state, as the direct leg's second pass
        first = http_json(base, "/run", dataclasses.asdict(k3_cfg))
        code, rec = http_json(base, "/run", dataclasses.asdict(k3_cfg))
        k3_launches = read_launches()
        k3_req = httpd.requests.get(rec.get("request_id"))
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.shutdown(timeout=SERVE_WAIT_S)
    if code != 200 or first[0] != 200 or first[1]["rounds"] != rec["rounds"] \
            or k3_launches["urn_step"] < 2 or k3_launches["fused_round"] \
            or k3_launches["keys_step"]:
        fail(f"kernel='step' served config5@512 urn: {code}, launches {k3_launches}")
    off, off_wall = offline_wall(get_backend("torch", kernel="step"), k3_cfg)
    reply_equal(rec, off, "config5@512 urn (step)")
    k3_row = served_line("config5@512 urn (kernel='step')", k3_cfg, k3_req, off_wall)
    return {"rows": rows, "k3_row": k3_row, "launches": launches, "k3_launches": k3_launches,
            "wall_s": wall}


def lane_strict_mixed(seed0: int = 0):
    """Phase 13's strict bucket and mixed-n set, seeds from ``seed0``."""
    from byzantinerandomizedconsensus_tpu_torch.config import SimConfig

    strict = [SimConfig(**LANE_STRICT, f=5 + s, seed=seed0 + s,
                        crash_window=1 + s % 4).validate() for s in range(16)]
    mixed = [SimConfig(**{**LANE_STRICT, "n": n}, f=(n - 1) // 3, seed=seed0 + s,
                       crash_window=1 + s % 4).validate()
             for s, n in zip(range(16), LANE_MIXED_NS * 4)]
    return strict, mixed


def blocking_hook():
    """A segment hook that holds the grid at its first boundary until
    released, so lanes are provably live while the script acts."""
    import threading

    started, go = threading.Event(), threading.Event()

    def hook(_msg):
        if not started.is_set():
            started.set()
            if not go.wait(timeout=SERVE_WAIT_S):
                fail("the held grid was never released")

    return hook, started, go


def serve_lanes_phase(card):
    """Phase 14b: the lane leg (``kernel="plain"``) on the card: the strict
    bucket streamed through the live feed, then the mixed-n set, twice;
    a preemption park and resume; lanes exported from one server and
    imported into another."""
    import threading

    from byzantinerandomizedconsensus_tpu_torch import get_backend, preset
    from byzantinerandomizedconsensus_tpu_torch.backends.compaction import CompactionPolicy
    from byzantinerandomizedconsensus_tpu_torch.backends.lanestate import LaneRecord
    from byzantinerandomizedconsensus_tpu_torch.serve.server import ConsensusServer

    policy = CompactionPolicy.parse(SERVE_LANE_POLICY)
    passes = []
    reset_launches()
    with ConsensusServer(get_backend("torch", kernel="plain"), policy=policy,
                         round_cap_ceiling=SERVE_CEILING) as srv:
        if srv.leg != "lanes" or srv.device.type != "cuda":
            fail(f"kernel='plain' served on the {srv.leg} leg on {srv.device}")
        for seed0 in (0, 100):
            strict, mixed = lane_strict_mixed(seed0)
            t0 = time.perf_counter()
            hs = [srv.submit(c) for c in strict + mixed]
            recs = [h.wait(timeout=SERVE_WAIT_S) for h in hs]
            torch.cuda.synchronize()
            passes.append({"cfgs": strict + mixed, "handles": hs, "recs": recs,
                           "wall_s": time.perf_counter() - t0,
                           "compiles": srv.compile_count()})
        cache = srv.stats()["compile_cache"]
    lanes_launched_nothing("the lane leg's two passes")
    if passes[1]["compiles"] != passes[0]["compiles"]:
        fail(f"the lane leg built {passes[1]['compiles'] - passes[0]['compiles']} lane "
             f"programs after the warm-up pass ({cache})")
    for i, p in enumerate(passes):
        k1, k1_wall, _ = per_config_k1(p["cfgs"])
        for c, rec, ref in zip(p["cfgs"], p["recs"], k1):
            reply_equal(rec, ref, f"lane pass {i + 1}, n={c.n} seed={c.seed}")
        p["k1_wall_s"] = k1_wall
        lat = [h.latency_s * 1e3 for h in p["handles"]]
        queue = [(h.t_dispatch - h.t_submit) * 1e3 for h in p["handles"]]
        n_inst = sum(c.instances for c in p["cfgs"])
        say(f"[serve] lane leg pass {i + 1} ({'warm-up' if i == 0 else 'steady'}): 16 strict "
            f"+ 16 mixed-n configs x {LANE_STRICT['instances']} instances streamed through "
            f"the live feed, each equal per instance to its per-config K1 run; wall "
            f"{p['wall_s']:.3f} s ({n_inst / p['wall_s']:.1f} instances/s) against 32 "
            f"per-config K1 runs {k1_wall:.3f} s; latency p50 {np.median(lat):.1f} ms, max "
            f"{max(lat):.1f} ms; queue wait p50 {np.median(queue):.1f} ms, max "
            f"{max(queue):.1f} ms; lane programs built {p['compiles']}; {card}")

    c4 = preset("config4")
    fat = dataclasses.replace(c4, instances=SERVE_FAT_INSTANCES).validate()
    urgent = lane_strict_mixed(200)[0][0]
    hook, started, go = blocking_hook()
    reset_launches()
    with ConsensusServer(get_backend("torch", kernel="plain"), policy=policy,
                         round_cap_ceiling=SERVE_CEILING, preempt=True,
                         segment_hook=hook) as srv:
        hf = srv.submit(fat)
        if not started.wait(timeout=SERVE_WAIT_S):
            fail("the fat request's grid never reached a segment boundary")
        hu = srv.submit({**dataclasses.asdict(urgent), "deadline_ms": 50.0})
        go.set()
        rf, ru = hf.wait(timeout=SERVE_WAIT_S), hu.wait(timeout=SERVE_WAIT_S)
        pre = srv.stats()["preempt"]
    lanes_launched_nothing("the preempted lane grid")
    if pre["parks"] != 1 or pre["resumes"] != 1 or pre["lanes_exported"] < 1 \
            or not hu.t_reply < hf.t_reply:
        fail(f"no park and resume around the urgent request: {pre}")
    (k1_fat, k1_urgent), _, _ = per_config_k1([fat, urgent])
    reply_equal(rf, k1_fat, "config4 (20,000 instances) parked and resumed")
    reply_equal(ru, k1_urgent, "the deadline-urgent request")
    say(f"[serve] preemption: config4 at {fat.instances} instances parked at a segment "
        f"boundary by a deadline-urgent n=64 arrival ({pre}); the urgent request replied "
        f"first (latency {hu.latency_s * 1e3:.1f} ms), the parked one resumed mid-round "
        f"(latency {hf.latency_s * 1e3:.1f} ms); both equal to their K1 runs; {card}")

    hook, started, go = blocking_hook()
    out = {}
    reset_launches()
    with ConsensusServer(get_backend("torch", kernel="plain"), policy=policy,
                         round_cap_ceiling=SERVE_CEILING, segment_hook=hook) as srv:
        h = srv.submit(fat)
        if not started.wait(timeout=SERVE_WAIT_S):
            fail("the exported request's grid never reached a segment boundary")
        t = threading.Thread(target=lambda: out.setdefault(
            "recs", srv.export_lanes([h.id], timeout=SERVE_WAIT_S)))
        t.start()
        time.sleep(0.2)
        go.set()
        t.join(timeout=SERVE_WAIT_S)
    recs = out.get("recs") or []
    if len(recs) != 1 or recs[0].lane_count() < 1:
        fail(f"export_lanes returned {[r.doc_summary() for r in recs]}")
    wire = json.dumps(recs[0].to_doc())
    if json.dumps(LaneRecord.from_doc(json.loads(wire)).to_doc()) != wire:
        fail("the exported lane record does not round-trip through JSON")
    with ConsensusServer(get_backend("torch", kernel="plain"), policy=policy,
                         round_cap_ceiling=SERVE_CEILING) as other:
        (h2,) = other.import_lanes([json.loads(wire)])
        rec = h2.wait(timeout=SERVE_WAIT_S)
    lanes_launched_nothing("the export and import")
    reply_equal(rec, k1_fat, "config4 (20,000 instances) exported and imported")
    say(f"[serve] export_lanes: config4 at {fat.instances} instances extracted with live "
        f"lanes ({recs[0].doc_summary()}, {len(wire)} bytes of JSON), imported into a "
        f"second server, reply equal to its K1 run; {card}")
    return {"passes": [{k: v for k, v in p.items() if k in ("wall_s", "compiles", "k1_wall_s")}
                       for p in passes], "preempt": pre}


def serve_process(*args):
    """``cli serve`` on the card in a subprocess: ``(process, base URL,
    output lines)``, the output read on a thread."""
    import os
    import threading

    env = dict(os.environ, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "byzantinerandomizedconsensus_tpu_torch.cli", "serve",
         "--port", "0", "--round-cap-ceiling", str(SERVE_CEILING), *args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    lines, ready = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip())
            if "listening on http://" in line:
                ready.set()
        ready.set()

    threading.Thread(target=read, daemon=True).start()
    if not ready.wait(SERVE_START_S) or proc.poll() is not None:
        proc.kill()
        proc.wait(timeout=60)
        fail(f"cli serve {' '.join(args)} did not start: {lines[-20:]}")
    base = re.search(r"listening on (http://\S+)", [x for x in lines if "listening" in x][0])
    return proc, base.group(1), lines


def stop_process(proc):
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)  # drain and exit
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)


def serve_crash_phase(card):
    """Phase 14c: ``cli serve --wal DIR`` SIGKILLed with replies owed,
    restarted with ``--recover DIR``; every owed reply fetched by its
    original id, equal to the offline run."""
    import tempfile

    from byzantinerandomizedconsensus_tpu_torch import get_backend
    from byzantinerandomizedconsensus_tpu_torch.serve import wal

    by_label = {label: cfg for label, cfg, _ in serve_direct_configs()}
    cfgs = [(label, by_label[label]) for label in
            ("config4 keys", "config3 session x4", "config2 urn", "config5@512 keys")]
    cfgs[1] = ("config3", cfgs[1][1])
    with tempfile.TemporaryDirectory() as tmp:
        wal_dir = str(pathlib.Path(tmp) / "wal")
        t0 = time.perf_counter()
        proc, base, _ = serve_process("--wal", wal_dir)
        start_s = time.perf_counter() - t0
        try:
            ids = []
            for label, cfg in cfgs:
                code, doc = http_json(base, "/submit", dataclasses.asdict(cfg))
                if code != 200:
                    fail(f"POST /submit {label} to cli serve: {code} {doc}")
                ids.append(doc["id"])
        finally:
            proc.kill()
            proc.wait(timeout=60)
        owed = [e["id"] for e in wal.WriteAheadLog.plan_recovery(wal_dir)[0]]
        if owed != ids:
            fail(f"the SIGKILL left {owed} owed, not every submitted id {ids}")
        t0 = time.perf_counter()
        proc, base, lines = serve_process("--recover", wal_dir)
        try:
            recs = [poll_result(base, rid) for rid in ids]
            recover_s = time.perf_counter() - t0
        finally:
            stop_process(proc)
        if proc.returncode != 0:
            fail(f"the recovered cli serve exited {proc.returncode}: {lines[-10:]}")
        if wal.WriteAheadLog.plan_recovery(wal_dir)[0]:
            fail("the recovered server left journal entries open")
    for (label, cfg), rid, (code, rec) in zip(cfgs, ids, recs):
        if code != 200 or rec.get("request_id") != rid:
            fail(f"GET /result/{rid} ({label}) after --recover: {code} {rec}")
        reply_equal(rec, get_backend("torch").run(cfg), f"{label} recovered")
        say(f"[serve] {label} recovered as {rid}: latency {rec['latency_s'] * 1e3:.3f} ms "
            f"from its re-admission (the server's own clock, in its own process)")
    say(f"[serve] crash drill: cli serve --wal (up in {start_s:.1f} s), {len(ids)} submits "
        f"({', '.join(label for label, _ in cfgs)}), SIGKILL with all {len(owed)} owed; "
        f"cli serve --recover: every GET /result/<original id> equal to the offline run, "
        f"{recover_s:.1f} s from restart to the last reply; {card}")
    return {"start_s": start_s, "recover_s": recover_s, "owed": len(owed)}


def serve_phase(card):
    """Phase 14: the consensus server. Returns ``({kernel: [path entries]},
    the direct leg's per-request rows)``."""
    t0 = time.perf_counter()
    direct = serve_direct_phase(card)
    lanes = serve_lanes_phase(card)
    crash = serve_crash_phase(card)
    wall = time.perf_counter() - t0
    say(f"[serve] phase 14 took {wall:.1f} s")
    say("[serve] " + json.dumps({"serve": {"direct": direct, "lanes": lanes, "crash": crash,
                                           "phase_wall_s": wall}}))
    label = ("serve direct leg over HTTP (config4, config4 keys, config5@512 keys, "
             "config2 urn, committee_point(8192), config3 session x4, config3 "
             "check_invariants)")
    return {"fused_round": [{"config": label, "launches": direct["launches"]["fused_round"],
                             "max_abs_err": 0, "wall_s": direct["wall_s"]}],
            "keys_step": [{"config": label, "launches": direct["launches"]["keys_step"],
                           "max_abs_err": 0, "wall_s": direct["wall_s"]}],
            "urn_step": [{"config": "serve direct leg, kernel='step' (config5@512 urn)",
                          "launches": direct["k3_launches"]["urn_step"], "max_abs_err": 0,
                          "latency_ms": direct["k3_row"]["latency_ms"]}]}, direct["rows"]


# Phase 15: the serving fleet on the card.
FLEET_WORKERS = 2
#: Instances of each warm-up request: the burst's configs at this size load
#: the same kernel libraries in each worker, so the burst loads none.
FLEET_WARM_INSTANCES = 8
#: Seeds of the autoscaler's backlog: config 5's n = 512 point under keys.
FLEET_SCALE_SEEDS = (1, 2, 3, 4)


@contextlib.contextmanager
def running_fleet(**kw):
    """A started ``FleetServer`` for a ``with`` block: drained and shut down
    after it; if the block fails, its worker processes are killed first, so
    a failed check never waits on them."""
    from byzantinerandomizedconsensus_tpu_torch.serve.fleet import FleetServer

    fleet = FleetServer(**kw)
    try:
        fleet.start()
        yield fleet
    except BaseException:
        for w in fleet._workers:
            if w.proc.poll() is None:
                w.proc.kill()
        fleet.shutdown(drain=False, timeout=10.0)
        raise
    fleet.shutdown(drain=True, timeout=SERVE_WAIT_S)


def fleet_rows(fleet) -> list:
    """Each worker's live stats (``None`` for a dead one), by index."""
    return [row.get("server") for row in fleet.stats(live=True)["per_worker"]]


def fleet_request_ms(req) -> dict:
    """A fleet request's latency, queue wait (in the parent and in its
    worker) and service time (ms)."""
    return {"latency_ms": req.latency_s * 1e3, "queue_ms": req.queue_s * 1e3,
            "service_ms": req.service_s * 1e3}


def wait_fleet(fleet, what, cond, timeout=SERVE_WAIT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            fail(f"the fleet: {what} not within {timeout} s: {fleet.health()}")
        time.sleep(0.05)


def launch_delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def census_lines(label, rows, card):
    """Print each live worker's census of launched kernel instantiations
    (obs/programs.py), and fail where a launched instantiation's ptxas
    report was not found in its library's build log."""
    out = []
    for st in rows:
        if st is None:
            continue
        blk = st.get("programs") or {}
        kernels = [e for e in blk.get("programs", []) if e["key"].startswith("kernel/")]
        for e in kernels:
            if not e.get("ptxas"):
                fail(f"worker {st['worker']}: no ptxas report for {e['key']} "
                     f"({e['fingerprint']})")
            px = e["ptxas"]
            say(f"[fleet] {label} census, worker {st['worker']}: {e['key']} "
                f"({e['fingerprint']['symbol']}): {px['registers']} registers, "
                f"{px['smem_bytes']} bytes static smem, spill {px['spill_stores']}/"
                f"{px['spill_loads']} bytes, launch grid {e['launch']['grid']} block "
                f"{e['launch']['block']} dynamic smem {e['launch']['dynamic_smem_bytes']}, "
                f"{e['calls']} launches; {card}")
            out.append({"worker": st["worker"], "key": e["key"],
                        "registers": px["registers"], "smem_bytes": px["smem_bytes"],
                        "launches": e["calls"], "launch": e["launch"]})
        mem = st.get("cuda_memory") or {}
        say(f"[fleet] {label} worker {st['worker']}: launches {st['launches']}, "
            f"kernel libraries loaded {st['libraries_loaded']}, {len(kernels)} "
            f"instantiations launched; CUDA memory allocated "
            f"{mem.get('allocated_bytes')} bytes (peak {mem.get('max_allocated_bytes')}), "
            f"reserved {mem.get('reserved_bytes')}, card used by all processes "
            f"{mem.get('device_used_bytes')} of {mem.get('device_total_bytes')}; {card}")
    return out


def fleet_burst_phase(fleet, card, single_rows):
    """Phase 15b: phase 14's direct-leg burst through the fleet after a
    warm-up of each worker; every reply against the offline run."""
    from byzantinerandomizedconsensus_tpu_torch import get_backend
    from byzantinerandomizedconsensus_tpu_torch.models import session

    reqs = serve_direct_configs()
    warm = [fleet.submit({**dataclasses.asdict(dataclasses.replace(
                cfg, instances=FLEET_WARM_INSTANCES).validate()), **env}, pin_worker=w)
            for w in range(FLEET_WORKERS) for _, cfg, env in reqs]
    for h in warm:
        h.wait(timeout=SERVE_WAIT_S)
    before = fleet_rows(fleet)
    t0 = time.perf_counter()
    handles = {}
    for label, cfg, env in reqs:
        payload = {**dataclasses.asdict(cfg), **env}
        if label.endswith("(cancelled)"):
            # pinned behind config4 under keys, so it is still queued
            keys_worker = next(w.idx for w in fleet._workers
                               if handles["config4 keys"].id in w.inflight)
            h = fleet.submit(payload, pin_worker=keys_worker)
            ack = fleet.cancel(h.id)
            if ack.get("where") != "queued":
                fail(f"the fleet's cancel of {label}: {ack}, not queued")
        else:
            h = fleet.submit(payload)
        handles[label] = h
    for h in handles.values():
        h.done.wait(SERVE_WAIT_S)
    wall = time.perf_counter() - t0
    after = fleet_rows(fleet)
    lib_growth = [a["libraries_loaded"] - b["libraries_loaded"] for a, b in zip(after, before)]
    if any(lib_growth):
        fail(f"workers loaded {lib_growth} kernel libraries after their warm-up")
    deltas = [launch_delta(a["launches"], b["launches"]) for a, b in zip(after, before)]
    total = {k: sum(d[k] for d in deltas) for k in deltas[0]}
    if total["fused_round"] < 1 or total["keys_step"] < 1 or total["urn_step"]:
        fail(f"the fleet burst's launches {deltas}: K1 and K2, not K3, expected")
    single = {r["config"].replace(" (burst)", ""): r for r in single_rows}
    rows = []
    for label, cfg, env in reqs:
        h = handles[label]
        if label.endswith("(cancelled)"):
            if h.error != "cancelled" or h.record is not None:
                fail(f"the cancelled request: {h.error} {h.record}")
            continue
        if h.error is not None:
            fail(f"the fleet's {label}: {h.error}")
        rec = h.record
        off = get_backend("torch").run(cfg)
        reply_equal(rec, off, f"{label} through the fleet")
        if "session_slots" in env:
            ref = session.run_session(get_backend("torch"), cfg, env["session_slots"])
            if rec["session"]["decisions"] != [r.decision.tolist() for r in ref]:
                fail("the fleet's config3 session differs from run_session")
        t = fleet_request_ms(h)
        one = single.get(label)
        say(f"[fleet] {label}: {cfg.instances} instances, latency {t['latency_ms']:.3f} ms "
            f"(queue {t['queue_ms']:.3f}, service {t['service_ms']:.3f})"
            + (f"; one server in phase 14: latency {one['latency_ms']:.3f} ms (queue "
               f"{one['queue_ms']:.3f}, service {one['service_ms']:.3f})" if one else "")
            + f"; {card}")
        rows.append({"config": label, "instances": cfg.instances, **t,
                     "single_server": one})
    dh = np.bincount(handles["config4"].record["decision"], minlength=3).tolist()
    rh = np.bincount(handles["config4"].record["rounds"], minlength=257).tolist()
    if dh != CONFIG4_DECISIONS or rh[:4] != CONFIG4_ROUNDS_HEAD or any(rh[4:]):
        fail(f"config4 through the fleet: histograms {dh}, {rh[:6]} differ from the reference")
    say(f"[fleet] burst: {len(reqs)} submits, 1 cancelled while queued, every reply equal to "
        f"get_backend('torch').run per instance, config4 equal to the reference histograms; "
        f"launches per worker {deltas}; kernel libraries loaded after warm-up: {lib_growth}; "
        f"wall {wall:.3f} s; {card}")
    return {"rows": rows, "launches": total, "per_worker_launches": deltas,
            "library_growth": lib_growth, "wall_s": wall}


def fleet_loss_phase(fleet, card):
    """Phase 15c: SIGKILL the worker holding config4 under keys mid-run;
    its requests come back from the survivor under their ids; the respawn
    budget replaces it."""
    from byzantinerandomizedconsensus_tpu_torch import get_backend
    from byzantinerandomizedconsensus_tpu_torch.config import sweep_point

    by_label = {label: cfg for label, cfg, _ in serve_direct_configs()}
    cfgs = [dataclasses.replace(by_label["config4 keys"], seed=7).validate(),
            dataclasses.replace(sweep_point(512), delivery="keys", seed=7).validate()]
    lost0 = fleet.stats(live=False)["lost_workers"]
    first = fleet.submit(cfgs[0])
    wait_fleet(fleet, "config4 keys in flight",
               lambda: any(first.id in w.inflight for w in fleet._workers))
    victim = next(w for w in fleet._workers if first.id in w.inflight)
    second = fleet.submit(cfgs[1], pin_worker=victim.idx)
    time.sleep(0.3)  # the K2 run is under way in the victim
    t_kill = time.perf_counter()
    victim.kill()
    for h in (first, second):
        if not h.done.wait(SERVE_WAIT_S) or h.error is not None:
            fail(f"request {h.id} after the kill: {h.error}")
    kill_to_reply = max(h.t_reply for h in (first, second)) - t_kill
    for h, cfg in ((first, cfgs[0]), (second, cfgs[1])):
        if h.record["request_id"] != h.id:
            fail(f"a re-admitted reply carries {h.record['request_id']}, not {h.id}")
        reply_equal(h.record, get_backend("torch").run(cfg), f"{h.id} after the kill")
    wait_fleet(fleet, "the respawn", lambda: fleet.health()["ok"]
               and fleet.stats(live=False)["respawns"]["used"] == 1)
    respawn_s = time.perf_counter() - t_kill
    st = fleet.stats(live=False)
    if st["lost_workers"] != lost0 + 1 or st["readmitted"] < 2 or st["failed"]:
        fail(f"after the kill: {st}")
    say(f"[fleet] worker loss: worker {victim.idx} (pid {victim.pid}) SIGKILLed while its K2 "
        f"run of config4 under keys was under way, 2 requests re-admitted to the survivor "
        f"under their ids, both equal to the offline run; {kill_to_reply:.3f} s from the kill "
        f"to the last reply; the replacement up and health green {respawn_s:.1f} s after "
        f"the kill (respawns {st['respawns']}); {card}")
    return {"kill_to_last_reply_s": kill_to_reply, "respawn_s": respawn_s,
            "readmitted": st["readmitted"]}


def fleet_scale_phase(fleet, card):
    """Phase 15d: ``Autoscaler.tick`` on an injected clock: one ``up``
    under a backlog, one ``down`` once it drains, retiring a worker with
    no loss."""
    from byzantinerandomizedconsensus_tpu_torch import get_backend
    from byzantinerandomizedconsensus_tpu_torch.config import sweep_point
    from byzantinerandomizedconsensus_tpu_torch.serve.autoscale import Autoscaler

    clock = [0.0]
    scaler = Autoscaler(fleet, min_workers=FLEET_WORKERS, max_workers=FLEET_WORKERS + 1,
                        up_per_worker=1.0, down_per_worker=0.5, up_ticks=1,
                        down_ticks=1, cooldown_s=0.0, clock=lambda: clock[0])
    st0 = fleet.stats(live=False)
    cfgs = [dataclasses.replace(sweep_point(512), delivery="keys", seed=s).validate()
            for s in FLEET_SCALE_SEEDS]
    hs = [fleet.submit(c) for c in cfgs]
    t0 = time.perf_counter()
    up = scaler.tick()
    up_s = time.perf_counter() - t0
    for h in hs:
        if not h.done.wait(SERVE_WAIT_S) or h.error is not None:
            fail(f"the autoscaler's backlog: {h.id} {h.error}")
    clock[0] = 1.0
    down = scaler.tick()
    wait_fleet(fleet, "the retirement", lambda: not fleet.health().get("retiring"))
    st = fleet.stats(live=False)
    if (up, down) != ("up", "down") or st["lost_workers"] != st0["lost_workers"] \
            or st["retired_workers"] != st0["retired_workers"] + 1 \
            or st["routable"] != FLEET_WORKERS or not fleet.health()["ok"]:
        fail(f"the autoscaler: {up}, {down}; {st}; {fleet.health()}")
    for h, c in zip(hs, cfgs):
        reply_equal(h.record, get_backend("torch").run(c), f"backlog {c.seed}")
    say(f"[fleet] autoscaler: tick 'up' under {len(cfgs)} outstanding on "
        f"{st0['routable']} workers (a third spawned in {up_s:.1f} s), tick 'down' once "
        f"drained (a worker retired through the shutdown handshake, none lost: "
        f"lost_workers {st['lost_workers']}, retired_workers {st['retired_workers']}); "
        f"every reply equal to the offline run; {scaler.stop()}; {card}")
    return {"up_s": up_s, "decisions": [up, down]}


def fleet_step_phase(card):
    """Phase 15e: a ``kernel="step"`` fleet serves config 5's n = 512 point
    under urn through K3."""
    from byzantinerandomizedconsensus_tpu_torch import get_backend
    from byzantinerandomizedconsensus_tpu_torch.config import sweep_point

    cfg = dataclasses.replace(sweep_point(512), delivery="urn").validate()
    with running_fleet(workers=FLEET_WORKERS, mode="process", backend="torch",
                       device="cuda:0", kernel="step",
                       round_cap_ceiling=SERVE_CEILING) as fleet:
        before = fleet_rows(fleet)
        hs = []
        for _ in range(2):  # the first warms its worker; the second is timed
            hs.append(fleet.submit(cfg))
            if not hs[-1].done.wait(SERVE_WAIT_S) or hs[-1].error is not None:
                fail(f"kernel='step' fleet: {hs[-1].error}")
        after = fleet_rows(fleet)
        census = census_lines("kernel='step' fleet", after, card)
    deltas = [launch_delta(a["launches"], b["launches"]) for a, b in zip(after, before)]
    total = {k: sum(d[k] for d in deltas) for k in deltas[0]}
    if total["urn_step"] < 2 or total["fused_round"] or total["keys_step"]:
        fail(f"kernel='step' fleet served config5@512 urn with launches {deltas}")
    off = get_backend("torch", kernel="step").run(cfg)
    for h in hs:
        reply_equal(h.record, off, "config5@512 urn (kernel='step' fleet)")
    t = fleet_request_ms(hs[1])
    say(f"[fleet] kernel='step' fleet: config5@512 urn twice, both equal to the offline step "
        f"run; launches per worker {deltas}; the second (warm) request's latency "
        f"{t['latency_ms']:.3f} ms "
        f"(queue {t['queue_ms']:.3f}, service {t['service_ms']:.3f}); {card}")
    return {"launches": total, "row": t, "census": census}


def fleet_cli_phase(card):
    """Phase 15f: ``cli serve --workers 2`` over HTTP: /run, /stats (two
    workers and their legs, a parent that never brought CUDA up) and
    /healthz; SIGINT drains it and it exits 0."""
    from byzantinerandomizedconsensus_tpu_torch import get_backend, preset

    c4 = preset("config4")
    t0 = time.perf_counter()
    proc, base, lines = serve_process("--workers", str(FLEET_WORKERS))
    start_s = time.perf_counter() - t0
    try:
        code, rec = http_json(base, "/run", dataclasses.asdict(c4))
        _, stats = http_json(base, "/stats")
        health = http_json(base, "/healthz")
    finally:
        stop_process(proc)
    if code != 200:
        fail(f"cli serve --workers 2: POST /run config4: {code} {rec}")
    reply_equal(rec, get_backend("torch").run(c4), "config4 through cli serve --workers 2")
    legs = [(r["leg"], r["device"]) for r in stats["per_worker"]]
    if stats["workers"] != FLEET_WORKERS or legs != [("direct", "cuda:0")] * FLEET_WORKERS \
            or stats["parent_cuda_initialized"] is not False:
        fail(f"cli serve --workers 2 /stats: workers {stats['workers']}, legs {legs}, parent "
             f"CUDA initialized {stats['parent_cuda_initialized']}")
    if health != (200, {"ok": True, "workers": FLEET_WORKERS, "alive": FLEET_WORKERS,
                        "dead_workers": []}):
        fail(f"cli serve --workers 2 /healthz: {health}")
    if proc.returncode != 0:
        fail(f"cli serve --workers 2 exited {proc.returncode}: {lines[-10:]}")
    say(f"[fleet] cli serve --workers 2: up in {start_s:.1f} s, POST /run config4 equal to the "
        f"offline run (latency in its worker {rec['latency_s'] * 1e3:.3f} ms), /stats: "
        f"{stats['workers']} workers on legs {legs}, the parent never brought CUDA up; "
        f"/healthz {health[1]}; SIGINT drained it, exit 0; {card}")
    return {"start_s": start_s}


def fleet_phase(card, single_rows):
    """Phase 15: the fleet on the card. Returns {kernel: [path entries]}."""
    import os

    t_phase = time.perf_counter()
    os.environ["BRC_PROGRAMS"] = "1"  # each worker's kernel census
    try:
        t0 = time.perf_counter()
        with running_fleet(workers=FLEET_WORKERS, mode="process", backend="torch",
                           device="cuda:0", round_cap_ceiling=SERVE_CEILING,
                           max_respawns=1) as fleet:
            spawn_s = time.perf_counter() - t0
            rows = fleet_rows(fleet)
            for w, st in zip(fleet._workers, rows):
                if w.leg != "direct" or w.device != "cuda:0" or \
                        not fleet.slot(w.idx)["shared"]:
                    fail(f"worker {w.idx}: {w.leg} leg on {w.device}, {fleet.slot(w.idx)}")
                say(f"[fleet] worker {w.idx} (pid {w.pid}) ready {w.ready_s:.2f} s after its "
                    f"spawn, {w.leg} leg on {w.device} ({st['device_name']}, shared), CUDA "
                    f"memory {st['cuda_memory']}; {card}")
            burst = fleet_burst_phase(fleet, card, single_rows)
            census = census_lines("burst", fleet_rows(fleet), card)
            loss = fleet_loss_phase(fleet, card)
            scale = fleet_scale_phase(fleet, card)
        step = fleet_step_phase(card)
    finally:
        os.environ.pop("BRC_PROGRAMS", None)
    cli = fleet_cli_phase(card)
    wall = time.perf_counter() - t_phase
    say(f"[fleet] phase 15 took {wall:.1f} s (fleet of {FLEET_WORKERS} up in {spawn_s:.1f} s)")
    say("[fleet] " + json.dumps({"fleet": {
        "spawn_s": spawn_s, "ready_s": [w.ready_s for w in fleet._workers[:FLEET_WORKERS]],
        "burst": burst, "census": census, "loss": loss, "scale": scale, "step": step,
        "cli": cli, "phase_wall_s": wall}}))
    label = ("fleet of 2 workers on cuda:0, phase 14's direct-leg burst (config4, config4 "
             "keys, config5@512 keys, config2 urn, committee_point(8192), config3 session x4)")
    return {"fused_round": [{"config": label, "launches": burst["launches"]["fused_round"],
                             "per_worker_launches": [d["fused_round"] for d in
                                                     burst["per_worker_launches"]],
                             "max_abs_err": 0, "wall_s": burst["wall_s"]}],
            "keys_step": [{"config": label, "launches": burst["launches"]["keys_step"],
                           "per_worker_launches": [d["keys_step"] for d in
                                                   burst["per_worker_launches"]],
                           "max_abs_err": 0, "wall_s": burst["wall_s"]}],
            "urn_step": [{"config": "fleet of 2 workers, kernel='step' (config5@512 urn x2)",
                          "launches": step["launches"]["urn_step"], "max_abs_err": 0,
                          "latency_ms": step["row"]["latency_ms"]}]}


# Phase 16: the load drivers on the card. The reference's digest of its
# generator-v3 stream (seed 15, 200 requests, rate 4/s), and the defaults
# the steps run at: loadgen's (seed 14, 200 requests, rate 4/s), the hostile
# suite's (seed 18), the soak's documented claim (120 configs, seed 0).
LOADGEN_DIGEST_FILE = "artifacts/serve_fleet_migrate_r23.json"
LOADGEN_SMOKE = 24
SOAK_CONFIGS = 120
CHAOS_CONFIGS = 16
CHAOS_JOBS = 4
BACKGROUND_STEP_S = 600.0


def cli_step(label, argv, out=None):
    """Run ``cli.main(argv)`` (a user's entry point, in this process) and
    fail unless it exits 0; returns ``(record or None, wall_s)``."""
    from byzantinerandomizedconsensus_tpu_torch import cli

    t0 = time.perf_counter()
    rc = cli.main(argv + (["--out", str(out)] if out is not None else []))
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"{label}: `cli {' '.join(argv)}` exited {rc}")
    say(f"[load] `cli {' '.join(argv)}`: rc 0 in {wall:.1f} s")
    return (json.loads(pathlib.Path(out).read_text()) if out is not None else None), wall


def in_background(steps):
    """Run ``steps``, a list of ``(label, argv or callable)``, one after
    another in a thread: an argv as a process of its own from the
    checkout's root (its launches never reach this process's counters), a
    callable in the thread. Returns the thread and ``{label: (rc or
    result, wall_s, output tail)}``, with ``"error"`` set if a step raised."""
    import threading

    out = {}

    def work():
        for label, step in steps:
            t0 = time.perf_counter()
            try:
                if callable(step):
                    out[label] = (step(), time.perf_counter() - t0, "")
                else:
                    proc = subprocess.run([sys.executable, "-m", *step], capture_output=True,
                                          text=True, timeout=BACKGROUND_STEP_S, cwd=ROOT)
                    out[label] = (proc.returncode, time.perf_counter() - t0,
                                  (proc.stdout + proc.stderr)[-3000:])
            except BaseException as e:  # noqa: BLE001 — the main thread fails on it
                out["error"] = f"{label}: {e!r}"
                return

    thread = threading.Thread(target=work, daemon=True)
    thread.start()
    return thread, out


def join_background(thread, out, labels):
    """Wait for a background thread; fail if it raised, is still running,
    or a process step exited nonzero. Returns ``out``."""
    thread.join(BACKGROUND_STEP_S * len(labels) + 60.0)
    if thread.is_alive() or "error" in out:
        fail(f"background steps {labels}: {out.get('error', 'still running')}")
    for label in labels:
        result, wall, tail = out[label]
        if isinstance(result, int) and result != 0:
            fail(f"{label} exited {result}: {tail}")
        say(f"[load] {label}: done in {wall:.1f} s (in the background)")
    return out


def census_by_library(doc) -> dict:
    """Kernel launches per library from a record's census block."""
    out: dict = {}
    for e in (doc.get("programs") or {}).get("programs", []):
        if e["key"].startswith("kernel/"):
            out[e["library"]] = out.get(e["library"], 0) + e["calls"]
    return out


def loadgen_checks(label, doc, card):
    """The serving record's gates, and its numbers printed."""
    serve, diff = doc["serve"], doc["differential"]
    if serve["steady_state_compiles"] or diff["mismatches"] or doc["failed"]:
        fail(f"{label}: {serve['steady_state_compiles']} steady-state builds, "
             f"{diff['mismatches']} mismatches ({diff['detail']}), failed {doc['failed']}")
    open_leg, burst = doc["legs"]["open_loop"], doc["legs"]["burst"]
    off = doc["legs"].get("offline")
    say(f"[load] {label}: {doc['leg']} leg on {doc['device']}, {serve['requests']} "
        f"requests, burst {burst['throughput_cps']} configs/s (p50 "
        f"{burst['latency_ms']['p50']} ms), open loop p50 {open_leg['latency_ms']['p50']} "
        f"ms p99 {open_leg['latency_ms']['p99']} ms, time to first result "
        f"{open_leg['time_to_first_result_ms']} ms"
        + (f", offline ({off['mode']}) walls {off['walls_s']} s" if off else "")
        + f"; {serve['warmup_requests']} warm-up requests, {serve['warmup_compiles']} "
        f"builds, 0 after; {diff['sessions_replayed']} sessions replayed; 0 mismatches "
        f"against the plain driver; launches in the measured legs {doc['launches']}; {card}")


def loadgen_phase(card):
    """Phase 16: the load drivers on the card. Returns {library: launches}
    of the default loadgen run (from the census)."""
    import os
    import tempfile

    from byzantinerandomizedconsensus_tpu_torch.obs import programs
    from byzantinerandomizedconsensus_tpu_torch.tools import loadgen, soak

    t_phase = time.perf_counter()
    walls = {}
    cli = "byzantinerandomizedconsensus_tpu_torch.cli"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        # (a) the stream digest against the reference's
        digest = loadgen.stream_digest(loadgen.request_stream(200, 15, 4.0))
        ref = json.loads((ROOT / LOADGEN_DIGEST_FILE).read_text())["stream_digest"]
        if digest != ref:
            fail(f"stream_digest(request_stream(200, 15, 4.0)) {digest} != {ref}")
        say(f"[load] stream digest (seed 15, 200 requests, rate 4) {digest} == "
            f"{LOADGEN_DIGEST_FILE}")
        stream = loadgen.request_stream(200, 14, 4.0)
        n_sessions = sum(1 for *_, slots in stream if slots > 1)

        # (b) the reference's default load on the direct leg, census on,
        # nothing else running
        programs.disable()
        os.environ[programs.PROGRAMS_ENV] = "1"
        reset_launches()
        try:
            doc_b, walls["b"] = cli_step("loadgen", ["loadgen", "--device", "cuda"],
                                         tmp / "b.json")
        finally:
            os.environ.pop(programs.PROGRAMS_ENV, None)
            programs.disable()
        launched_b = read_launches()
        by_lib = census_by_library(doc_b)
        loadgen_checks("cli loadgen (seed 14, 200 requests, rate 4/s)", doc_b, card)
        if doc_b["leg"] != "direct" or doc_b["differential"]["sessions_replayed"] != n_sessions:
            fail(f"cli loadgen: leg {doc_b['leg']}, {doc_b['differential']['sessions_replayed']} "
                 f"of {n_sessions} sessions replayed")
        if launched_b["fused_round"] < 1 or launched_b["keys_step"] < 1:
            fail(f"cli loadgen launched {launched_b}: K1 and K2 expected")
        if sum(by_lib.values()) != sum(launched_b.values()):
            fail(f"the census {by_lib} disagrees with the launch counts {launched_b}")
        say(f"[load] cli loadgen launches, this run (warm-up, legs, offline): {launched_b}; "
            f"per library (census): {by_lib}; {card}")

        # Beside (c) and (d), each in processes of their own (no launch of
        # this process's counters): (g) the chaos soak and the crash drill,
        # the classic soak; (e) the fleet; the elastic and preempt drills of
        # (f), whose timing gates are sleep-dominated.
        t_bg = time.perf_counter()
        bg_preempt = in_background([
            ("preempt", [cli, "loadgen", "--scenario", "preempt", "--smoke",
                         "--kernel", "plain", "--out", str(tmp / "pr.json")])])

        bg_chaos = in_background([
            ("chaos", [cli, "chaos", "--configs", str(CHAOS_CONFIGS), "--jobs",
                       str(CHAOS_JOBS), "--liveness", "--out", str(tmp / "chaos.json")]),
            ("drill", lambda: soak.run_soak(2, seed=0, oracle_every=100, chaos=True,
                                            timeout_s=120, backoff_s=0.05,
                                            checkpoint=str(tmp / "drill.ckpt"),
                                            inject={0: "crash"}, jobs=2,
                                            progress=lambda *a: None))])
        bg_soak = in_background([
            ("soak", ["byzantinerandomizedconsensus_tpu_torch.tools.soak", "--configs",
                      str(SOAK_CONFIGS), "--out", str(tmp / "soak.json")])])
        bg_fleet = in_background([
            ("fleet", [cli, "loadgen", "--workers", "1,2", "--smoke",
                       "--out", str(tmp / "e.json")])])
        bg_elastic = in_background([
            ("elastic", [cli, "loadgen", "--scenario", "elastic", "--smoke",
                         "--out", str(tmp / "el.json")])])
        # (c) the lane leg on the same stream's first requests: no kernel
        reset_launches()
        doc_c, walls["c"] = cli_step("loadgen --kernel plain",
                                     ["loadgen", "--smoke", "--kernel", "plain",
                                      "--no-offline"], tmp / "c.json")
        if any(read_launches().values()):
            fail(f"the lane leg launched {read_launches()}")
        loadgen_checks("cli loadgen --smoke --kernel plain", doc_c, card)
        digests_b = doc_b["differential"]["reply_digests"][:LOADGEN_SMOKE]
        if doc_c["leg"] != "lanes" or doc_c["differential"]["reply_digests"] != digests_b:
            fail("the lane leg's replies differ from the direct leg's for the same requests")
        say(f"[load] lane leg: 0 launches; all {LOADGEN_SMOKE} replies equal the direct "
            f"leg's replies to the same requests")

        # (d) the step kernel
        reset_launches()
        doc_d, walls["d"] = cli_step("loadgen --kernel step",
                                     ["loadgen", "--smoke", "--kernel", "step"],
                                     tmp / "d.json")
        launched_d = read_launches()
        if launched_d["urn_step"] < 1 or launched_d["keys_step"] < 1 or launched_d["fused_round"]:
            fail(f"loadgen --kernel step launched {launched_d}: K2 and K3 only expected")
        loadgen_checks("cli loadgen --smoke --kernel step", doc_d, card)
        say(f"[load] --kernel step: launches {launched_d}; left out by name "
            f"{doc_d['unsupported']}")

        # (g) the soaks, back from the background
        bg = join_background(*bg_chaos, ["chaos", "drill"])
        doc_ch = json.loads((tmp / "chaos.json").read_text())
        if doc_ch["mismatches"] or doc_ch["violations"] or doc_ch["skipped"]:
            fail(f"cli chaos: {doc_ch['mismatches'][:2]} {doc_ch['violations'][:2]} "
                 f"{doc_ch['skipped'][:2]}")
        say(f"[load] cli chaos --configs {CHAOS_CONFIGS} --jobs {CHAOS_JOBS} --liveness: "
            f"device legs {doc_ch['kernels']}, {doc_ch['safety_checked_instances']} instances "
            f"checked for safety, 0 mismatches, violations or skips; liveness "
            f"{doc_ch['liveness']['summary']}; {card}")
        drill = bg["drill"][0]
        skipped = drill["skipped"]
        if [r.get("index") for r in skipped] != [0] or skipped[0]["attempts"] != 2 \
                or "exit 139" not in skipped[0]["error"] or drill["mismatches"]:
            fail(f"the crash drill: {skipped} {drill['mismatches']}")
        say(f"[load] chaos crash drill: config 0 retried and skipped with its record "
            f"({skipped[0]['error'][:80]}), config 1 ok")
        join_background(*bg_soak, ["soak"])
        doc_s = json.loads((tmp / "soak.json").read_text())
        if doc_s["mismatches"] or not doc_s["oracle_subsampled_configs"] \
                or set(doc_s["kernels"]) != {"fused", "step"}:
            fail(f"the classic soak: kernels {doc_s['kernels']}, {doc_s['mismatches'][:2]}")
        say(f"[load] soak --configs {SOAK_CONFIGS}: kernels {doc_s['kernels']} against native "
            f"and {doc_s['oracle_subsampled_configs']} oracle subsamples, 0 mismatches; {card}")

        # (e) the fleet, one and two worker processes; the elastic drills
        join_background(*bg_fleet, ["fleet"])
        join_background(*bg_elastic, ["elastic"])
        doc_e = json.loads((tmp / "e.json").read_text())
        fd = doc_e["differential"]
        if fd["mismatches"] or doc_e["fleet"]["steady_state_compiles"]:
            fail(f"the fleet: {fd['mismatches']} mismatches, "
                 f"{doc_e['fleet']['steady_state_compiles']} steady-state builds")
        legs_e = {k: (leg["burst"]["throughput_cps"], leg["steady_state_compiles"],
                      [w["launches"] for w in leg["per_worker"]])
                  for k, leg in doc_e["legs"].items()}
        say(f"[load] cli loadgen --workers 1,2 --smoke: {fd['compared']} replies compared, 0 "
            f"mismatches; per worker count (burst configs/s, steady builds, worker "
            f"launches): {legs_e}; open loop p50/p99 "
            f"{doc_e['fleet']['latency_ms']} ms; {card}")
        doc_el = json.loads((tmp / "el.json").read_text())
        say(f"[load] --scenario elastic --smoke: {doc_el['elastic']['scenarios']}; {card}")
        # (f) the hostile suite at full size, with only the preempt drills
        # left beside it: its clients meet the servers' bounds (429s, the
        # per-tenant cap) as the reference's do
        reset_launches()
        doc_f, walls["f"] = cli_step("loadgen --scenario all",
                                     ["loadgen", "--scenario", "all"], tmp / "f.json")
        hb = doc_f["hostile"]
        if hb["rejected_overflow"] < 1 or hb["mismatches"] or hb["steady_state_compiles"] \
                or not (hb["fairness"] or {}).get("ok"):
            fail(f"the hostile suite: {hb}")
        say(f"[load] cli loadgen --scenario all ({doc_f['leg']} leg): "
            + "; ".join(f"{r['scenario']} {r['replied']}/{r['requests']} replied, "
                        f"rejected {r['rejected']}, cancelled {r['cancelled']}"
                        for r in hb["scenarios"])
            + f"; {hb['rejected_overflow']} overflow 429s, fairness {hb['fairness']}, "
              f"deadline hit rate {hb['deadline_hit_rate']}, 0 mismatches, 0 steady builds; "
              f"launches {read_launches()}; {card}")
        join_background(*bg_preempt, ["preempt"])
        walls["background"] = time.perf_counter() - t_bg
        doc_pr = json.loads((tmp / "pr.json").read_text())
        say(f"[load] --scenario preempt --smoke --kernel plain: {doc_pr['preempt']}; "
            f"restore grid {doc_pr['lanestate']['grid_points']} points, "
            f"{doc_pr['lanestate']['restore_mismatches']} mismatches; {card}")

    wall = time.perf_counter() - t_phase
    say(f"[load] phase 16 took {wall:.1f} s; steps {walls}")
    say("[load] " + json.dumps({"load": {
        "by_library": by_lib, "launches": launched_b, "walls_s": walls,
        "serve": doc_b["serve"], "legs": doc_b["legs"], "fleet_legs": legs_e,
        "background_s": {k: v[1] for k, v in bg.items()},
        "hostile": {r["scenario"]: {k: r.get(k) for k in ("replied", "rejected", "cancelled",
                                                          "deadline_hit_rate")}
                    for r in hb["scenarios"]},
        "phase_wall_s": wall}}))
    return by_lib


# Phase 17: the adversary hunter on the card. The reference hunts of
# artifacts/hunt_port/make_reference.py (the JAX package's Hunter over its
# numpy backend): (a) the cli hunt defaults, (c) a small hunt, (d) the
# committee-scale wing. A stuck reply fails the phase by name. (a) runs
# without the per-reply invariant checks: on the card each check is a run
# of the plain driver with its full state, 0.72 s a candidate against 6.7
# ms for the candidate's own run through K1 (PERF.md §4). Its first
# HUNT_CHECKED evaluations run again with every reply checked; (b), (c)
# and (d) check every reply and archive entry they see.
HUNT_REFERENCE_FILE = "artifacts/hunt_port/reference.json"
HUNT_WAIT_S = 300.0
HUNT_CHECKED = 64
HUNT_SMALL = ["--budget", "16", "--generation", "8", "--archive-k", "4", "--no-control"]
HUNT_COMMITTEE = ["--committee-scale", "--budget", "32", "--generation", "8", "--no-control"]


def hunt_step(label, argv, tmp, name, census=False):
    """``cli hunt`` in this process (rc 0 required) with the kernel census
    on where asked: ``(record, regressions doc, wall_s, wrapper launches,
    {library: launches} from the census)``."""
    import os

    from byzantinerandomizedconsensus_tpu_torch.obs import programs

    reg = tmp / f"{name}_regressions.json"
    argv = ["hunt", *argv, "--regressions-out", str(reg)]
    programs.disable()
    if census:
        os.environ[programs.PROGRAMS_ENV] = "1"
    reset_launches()
    try:
        doc, wall = cli_step(label, argv, tmp / f"{name}.json")
    finally:
        os.environ.pop(programs.PROGRAMS_ENV, None)
        programs.disable()
    launched = read_launches()
    by_lib = census_by_library(doc)
    if census and sum(by_lib.values()) != sum(launched.values()):
        fail(f"{label}: the census {by_lib} disagrees with the launch counts {launched}")
    return doc, json.loads(reg.read_text()), wall, launched, by_lib


def hunt_equal(label, reg, leg):
    """A hunt's archive against a reference leg: every digest and fitness in
    order, the evaluations and the best fitness."""
    got = [(e["digest"], e["fitness"]) for e in reg["entries"]]
    want = [(e["digest"], e["fitness"]) for e in leg["archive"]]
    hunt = reg["hunt"]
    if got != want or hunt["best_fitness"] != leg["best_fitness"] \
            or hunt["evaluations"] != leg["evaluations"]:
        fail(f"{label}: archive {[(d[:12], f) for d, f in got]} (best {hunt['best_fitness']}, "
             f"{hunt['evaluations']} evaluations) != the reference's "
             f"{[(d[:12], f) for d, f in want]} (best {leg['best_fitness']}, "
             f"{leg['evaluations']})")


def hunt_checks(label, doc, baseline):
    """The hunt record's gates: violations, builds after the warm-up, the
    replay check, the rediscovery pin and the baseline."""
    h = doc["hunt"]
    bad = [r for r in doc["replay_check"] if not r["ok"]]
    red = h["rediscovery"]
    if h["violations"] or h["steady_state_compiles"] not in (0, None) or bad \
            or not doc["replay_check"] or not red["above_baseline"] \
            or h["baseline_mean_rounds"] != baseline:
        fail(f"{label}: violations {h['violations']}, steady-state builds "
             f"{h['steady_state_compiles']}, replays failed {bad}, rediscovery {red}, "
             f"baseline {h['baseline_mean_rounds']} (reference {baseline})")


def hunt_compare(label, cfg, law, plain, card, want=None):
    """One config through the card's kernel by law and through the plain
    driver with its full state on the card: the kernel must equal plain per
    instance (and ``want``, the archived arrays, where given) and the state
    must keep the safety invariants. Returns ``(library, max abs err)``."""
    from byzantinerandomizedconsensus_tpu_torch.models import invariants
    from byzantinerandomizedconsensus_tpu_torch.tools import loadgen

    rk = law.run(cfg)
    rp, state, faulty = plain.run_with_state(cfg)
    err = max(int(np.abs(rk.rounds.astype(np.int64) - rp.rounds).max()),
              int(np.abs(rk.decision.astype(np.int64) - rp.decision).max()))
    lib = loadgen.library_of(law, cfg) or "plain"
    if err or (want is not None and (rk.rounds.tolist(), rk.decision.tolist()) != want):
        fail(f"{label} ({cfg.delivery}, faults {cfg.faults}): {law.kernel_for(cfg)} ({lib}) "
             f"against plain max abs err {err}, or not the archived arrays")
    viols = invariants.state_violations(cfg, state, faulty, res=rp, inst_ids=rp.inst_ids)
    if viols:
        fail(f"{label}: safety violations {viols[:2]}")
    say(f"[hunt] (b) {label}: {cfg.protocol} n={cfg.n} f={cfg.f} {cfg.adversary} "
        f"{cfg.delivery} faults {cfg.faults}, {cfg.instances} instances, cap {cfg.round_cap}, "
        f"max rounds {int(rk.rounds.max())}: {law.kernel_for(cfg)} ({lib}) == plain on the "
        f"card per instance{' == the archived arrays' if want is not None else ''}, "
        f"0 violations; {card}")
    return lib, err


def hunt_errs(label, reg, by_lib, committee_scale, card):
    """Phase 17b for one hunt: each archive entry of ``reg``, then, for each
    library the hunt launched (``by_lib``) that no entry reached, the config
    its warm-up loaded that library with (``hunter.library_sample``). Fails
    if a launched library has no comparison. Returns ``{library:
    {"max_abs_err", "compared_on"}}``."""
    from byzantinerandomizedconsensus_tpu_torch import get_backend
    from byzantinerandomizedconsensus_tpu_torch.hunt import hunter
    from byzantinerandomizedconsensus_tpu_torch.hunt import space as hunt_space
    from byzantinerandomizedconsensus_tpu_torch.tools import loadgen

    law, plain = get_backend("torch"), get_backend("torch", kernel="plain")
    out = {}

    def note(lib, err, on):
        row = out.setdefault(lib, {"max_abs_err": 0, "compared_on": []})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["compared_on"].append(on)

    for e in reg["entries"]:
        on = f"{label} archive entry {e['digest'][:12]} (fitness {e['fitness']})"
        lib, err = hunt_compare(on, hunt_space.decode(e["genome"]), law, plain, card,
                                want=(e["rounds"], e["decision"]))
        note(lib, err, on)
    space = hunt_space.SearchSpace(committee_scale=committee_scale)
    warm = {loadgen.library_of(law, c): c
            for c in loadgen.library_configs(law, hunter.library_sample(space))}
    for lib in sorted(set(by_lib) - set(out)):
        if lib not in warm:
            fail(f"{label} launched {lib}, which neither an archive entry nor a warm-up "
                 f"config reaches: no comparison with plain")
        on = f"{label} warm-up config for {lib}"
        note(*hunt_compare(on, warm[lib], law, plain, card), on)
    return out


def hunt_phase(card):
    """Phase 17: the adversary hunter on the card, each reply's wait
    bounded by HUNT_WAIT_S. Returns the census ``{library: launches}`` of
    (a) and of (d), and (b)'s ``{library: {"max_abs_err", "compared_on"}}``
    of each."""
    from byzantinerandomizedconsensus_tpu_torch.hunt import hunter

    wait = hunter.WAIT_TIMEOUT_S
    hunter.WAIT_TIMEOUT_S = HUNT_WAIT_S
    try:
        return _hunt_phase(card)
    finally:
        hunter.WAIT_TIMEOUT_S = wait


def _hunt_phase(card):
    import tempfile

    from byzantinerandomizedconsensus_tpu_torch.obs import metrics

    t_phase = time.perf_counter()
    ref = json.loads((ROOT / HUNT_REFERENCE_FILE).read_text())
    legs, baseline = ref["legs"], ref["baseline_mean_rounds"]
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        # (a) the reference's defaults on the direct leg, census on
        say(f"[hunt] (a) cli hunt --device cuda --no-invariants (the defaults otherwise) ...")
        doc_a, reg_a, walls["a"], launched_a, by_lib_a = hunt_step(
            "cli hunt (the defaults)", ["--device", "cuda", "--no-invariants"], tmp, "a",
            census=True)
        hunt_checks("cli hunt", doc_a, baseline)
        hunt_equal("cli hunt, pipelined", reg_a, legs["a"]["pipelined"])
        control = legs["a"]["barriered"]
        if doc_a["control_archive_digests"] != [e["digest"] for e in control["archive"]] \
                or doc_a["control_best_fitness"] != control["best_fitness"]:
            fail(f"cli hunt, barriered: archive {doc_a['control_archive_digests']} (best "
                 f"{doc_a['control_best_fitness']}) != the reference's")
        if doc_a["leg"] != "direct" or launched_a["fused_round"] < 1 \
                or launched_a["keys_step"] < 1:
            fail(f"cli hunt: the {doc_a['leg']} leg launched {launched_a}: K1 and K2 expected")
        h = doc_a["hunt"]
        kinds = doc_a["by_kernel"]
        say(f"[hunt] (a) cli hunt (evolution, seed 17, budget 500, generation 16, archive 8, "
            f"width=64,segment=1, invariants off), direct leg: {h['evaluations']} evaluations, "
            f"best fitness {h['best_fitness']}, archive of {h['archive_size']} == "
            f"{HUNT_REFERENCE_FILE} digest for digest, pipelined and barriered; "
            f"0 builds after the warm-up, {len(doc_a['replay_check'])} replays ok on the "
            f"card, baseline {h['baseline_mean_rounds']}, rediscovery {h['rediscovery']}; "
            f"walls: pipelined {h['pipelined_wall_s']} s, barriered {h['barriered_wall_s']} "
            f"s, pipeline_speedup {h['pipeline_speedup']}; the step {walls['a']:.1f} s; {card}")
        say(f"[hunt] (a) pipelined evaluations by kernel {kinds} (plain-driver runs "
            f"{kinds.get('plain', {}).get('evaluations', 0)}); launches in the step "
            f"(warm-up, both hunts, replays, baseline) {launched_a}, per library (census) "
            f"{by_lib_a}; {card}")

        # (a) checked: the same hunt's first evaluations, every reply's
        # invariants checked on the card, pipelined and barriered
        say(f"[hunt] (a) cli hunt --device cuda --budget {HUNT_CHECKED} (invariants on) ...")
        doc_k, _, walls["a_checked"], _, _ = hunt_step(
            f"cli hunt --budget {HUNT_CHECKED}",
            ["--device", "cuda", "--budget", str(HUNT_CHECKED)], tmp, "a_checked")
        hunt_checks(f"cli hunt --budget {HUNT_CHECKED}", doc_k, baseline)
        checks = metrics.snapshot()["brc_serve_invariant_checks_total"]["series"][0]
        checks = int(checks["value"])
        if checks != 2 * HUNT_CHECKED:
            fail(f"cli hunt --budget {HUNT_CHECKED}: {checks} replies checked, not "
                 f"{2 * HUNT_CHECKED} (pipelined and barriered)")
        hk = doc_k["hunt"]
        say(f"[hunt] (a) cli hunt --budget {HUNT_CHECKED} (the defaults otherwise, invariants "
            f"on): {checks} replies checked on the card, {hk['violations']} violations, best "
            f"fitness {hk['best_fitness']}, 0 builds after the warm-up; walls: pipelined "
            f"{hk['pipelined_wall_s']} s, barriered {hk['barriered_wall_s']} s; by kernel "
            f"{doc_k['by_kernel']}; the step {walls['a_checked']:.1f} s; {card}")

        # (c) one small hunt three ways: in process on the direct leg, on the
        # lane leg (no launch), against a cli serve subprocess over HTTP
        say("[hunt] (c) the small hunt three ways ...")
        doc_c1, reg_c1, walls["c_direct"], _, _ = hunt_step(
            "cli hunt small, direct", ["--device", "cuda", *HUNT_SMALL], tmp, "c1")
        doc_c2, reg_c2, walls["c_lanes"], launched_c2, _ = hunt_step(
            "cli hunt small, lanes", ["--device", "cuda", "--kernel", "plain", *HUNT_SMALL],
            tmp, "c2")
        if any(launched_c2.values()) or doc_c2["leg"] != "lanes":
            fail(f"the lane leg's hunt ({doc_c2['leg']}) launched {launched_c2}")
        t0 = time.perf_counter()
        proc, base, lines = serve_process("--device", "cuda")
        walls["c_serve_start"] = time.perf_counter() - t0
        try:
            doc_c3, reg_c3, walls["c_remote"], _, _ = hunt_step(
                "cli hunt small, --url", ["--device", "cuda", "--url", base, *HUNT_SMALL],
                tmp, "c3")
        finally:
            stop_process(proc)
        if proc.returncode != 0:
            fail(f"cli serve exited {proc.returncode}: {lines[-10:]}")
        for label, doc, reg in (("direct", doc_c1, reg_c1), ("lanes", doc_c2, reg_c2),
                                ("remote", doc_c3, reg_c3)):
            hunt_checks(f"cli hunt small ({label})", doc, baseline)
            hunt_equal(f"cli hunt small ({label})", reg, legs["c"]["pipelined"])
        say(f"[hunt] (c) small hunt (budget 16, generation 8, archive 4): in process on the "
            f"direct leg ({walls['c_direct']:.1f} s), on the lane leg with 0 launches "
            f"({walls['c_lanes']:.1f} s), and with --url against cli serve --device cuda "
            f"(up in {walls['c_serve_start']:.1f} s; {walls['c_remote']:.1f} s, steady-state "
            f"builds {doc_c3['hunt']['steady_state_compiles']}, unmeasured) give one archive "
            f"== the reference's small leg; pipelined walls "
            f"{[d['hunt']['pipelined_wall_s'] for d in (doc_c1, doc_c2, doc_c3)]} s; {card}")

        # (d) the committee-scale wing on the direct leg, census on
        say("[hunt] (d) cli hunt --committee-scale ...")
        doc_d, reg_d, walls["d"], launched_d, by_lib_d = hunt_step(
            "cli hunt --committee-scale", ["--device", "cuda", *HUNT_COMMITTEE], tmp, "d",
            census=True)
        hunt_checks("cli hunt --committee-scale", doc_d, baseline)
        hunt_equal("cli hunt --committee-scale", reg_d, legs["d"]["pipelined"])
        committee = {k: v for k, v in by_lib_d.items() if "committee" in k}
        say(f"[hunt] (d) cli hunt --committee-scale (budget 32, generation 8): archive == the "
            f"reference's committee leg, best fitness {doc_d['hunt']['best_fitness']}, "
            f"pipelined {doc_d['hunt']['pipelined_wall_s']} s, step {walls['d']:.1f} s; by "
            f"kernel {doc_d['by_kernel']}; committee libraries' launches {committee}, all "
            f"{by_lib_d}; {card}")

        # (b) kernel by law against plain on the card, for every library
        # (a) and (d) launched
        t0 = time.perf_counter()
        errs_a = hunt_errs("(a)", reg_a, by_lib_a, False, card)
        errs_d = hunt_errs("(d)", reg_d, by_lib_d, True, card)
        walls["b"] = time.perf_counter() - t0

    wall = time.perf_counter() - t_phase
    say(f"[hunt] phase 17 took {wall:.1f} s; steps {walls}; {card}")
    say("[hunt] " + json.dumps({"hunt": {
        "by_library_a": by_lib_a, "launches_a": launched_a, "by_kernel_a": doc_a["by_kernel"],
        "by_library_d": by_lib_d, "launches_d": launched_d, "by_kernel_d": doc_d["by_kernel"],
        "errs_a": errs_a, "errs_d": errs_d, "walls_s": walls,
        "pipelined_wall_s": doc_a["hunt"]["pipelined_wall_s"],
        "barriered_wall_s": doc_a["hunt"]["barriered_wall_s"],
        "pipeline_speedup": doc_a["hunt"]["pipeline_speedup"],
        "checked": {k: doc_k["hunt"][k] for k in ("evaluations", "violations",
                                                   "pipelined_wall_s", "barriered_wall_s")},
        "phase_wall_s": wall}}))
    return by_lib_a, by_lib_d, errs_a, errs_d


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    from byzantinerandomizedconsensus_tpu_torch import get_backend, preset
    from byzantinerandomizedconsensus_tpu_torch.cli import (
        decision_histogram, round_histogram)
    from byzantinerandomizedconsensus_tpu_torch.ops import _build, fused_round

    # Phase 1: the card.
    card = card_line()
    name = torch.cuda.get_device_name(0)
    say(f"[card] {card}")
    say(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device 0 = {name}, count {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    # Phase 2: build every kernel (one nvcc per source, in parallel).
    t0 = time.perf_counter()
    took = _build.build()
    say(f"[build] {len(took)} kernel(s) built in {time.perf_counter() - t0:.1f} s: {took}")
    for k in _build.KERNELS:
        if k not in _build.FUSED_LIBRARIES:
            say(f"[build] {k}: {ptxas_summary(k)}")
    for inst, regs in fused_ptxas().items():
        say(f"[build] fused_round {inst}: {regs}")
    say(f"[build] fused_round (bracha, none, none), config4's instantiation: "
        f"{config4_sass_count()} SASS instructions")
    for lib in _build.FUSED_LIBRARIES[1:]:
        regs = fused_ptxas(lib)
        counts = [int(re.search(r"Used (\d+) registers", r).group(1)) for r in regs.values()]
        spills = [int(m) for r in regs.values()
                  for m in re.findall(r"(\d+) bytes spill stores", r)]
        say(f"[build] {lib}: {len(regs)} instantiations, {min(counts)}-{max(counts)} "
            f"registers, spill stores up to {max(spills, default=0)} bytes")

    # Phase 3: kernel against plain on a grid of small configs.
    t0 = time.perf_counter()
    grid = grid_configs()
    capped = 0
    for cfg in grid:
        ids = torch.arange(cfg.instances, dtype=torch.int32, device=dev)
        _, dp = compare(cfg, ids)
        capped += int((dp == 2).sum())
    if capped == 0:
        fail("the grid reached no capped instance")
    t1 = time.perf_counter()
    adv_grid, adv_capped = adversary_grid(), 0
    for cfg in adv_grid:
        ids = torch.arange(cfg.instances, dtype=torch.int32, device=dev)
        _, dp = compare(cfg, ids)
        adv_capped += int((dp == 2).sum())
    if adv_capped == 0:
        fail("the adversary grid reached no capped instance")
    say(f"[grid] fused_round == plain on {len(adv_grid)} configs of both protocols under "
        f"every static adversary (n 13, 16, 512, 1024; both coins; {adv_capped} capped "
        f"instances) in {time.perf_counter() - t1:.1f} s")
    c4 = preset("config4")
    ids4k = torch.arange(4096, dtype=torch.int32, device=dev)
    compare(c4, ids4k)
    plain_4k_ms = cuda_ms(lambda: fused_round.run_chunk_plain(c4, ids4k), 1)
    say(f"[grid] fused_round == plain on {len(grid)} configs "
        f"(n in 4..512, every init, both coins, {capped} capped instances) "
        f"and config4 at 4096 instances, in {time.perf_counter() - t0:.1f} s")
    say(f"[plain] config4 at 4096 instances, plain torch path on the card: "
        f"{plain_4k_ms:.1f} ms ({card})")

    # Phase 4: the main path, through the backend a user calls.
    backend = get_backend("torch")
    reset_launches()
    res = backend.timed_run(c4)
    launches = read_launches()["fused_round"]
    dh = decision_histogram(res).tolist()
    rh = round_histogram(res).tolist()
    if dh != CONFIG4_DECISIONS or rh[:4] != CONFIG4_ROUNDS_HEAD or any(rh[4:]):
        fail(f"config4 histograms differ from the reference: decisions {dh}, "
             f"rounds {rh[:8]}")
    if launches < 1:
        fail("the main path did not launch fused_round")
    say(f"[main] config4, {len(res.inst_ids)} instances: decision_histogram {dh}, "
        f"round_histogram[:4] {rh[:4]}, mean_rounds_decided "
        f"{float(res.rounds[res.decision != 2].mean())}, fused_round launches {launches}")
    backend.timed_run(c4)  # warm-up
    walls = [backend.timed_run(c4).wall_s for _ in range(5)]
    say(f"[main] {METRIC} = {len(res.inst_ids) / min(walls)} "
        f"(best of 5 walls {walls} s; {card})")

    # The kernel and its plain version on the main path's inputs.
    ids = torch.arange(c4.instances, dtype=torch.int32, device=dev)
    rk, dk = fused_round.run_chunk(c4, ids)
    kernel_ms = cuda_ms(lambda: fused_round.run_chunk(c4, ids), 5)
    chunk = get_backend("torch", kernel="plain").chunk_size(c4)
    stats = {}
    t0 = time.perf_counter()
    parts = [fused_round.run_chunk_plain(c4, ids[lo:lo + chunk], stats=stats)
             for lo in range(0, len(ids), chunk)]
    rp = torch.cat([p[0] for p in parts])
    dp = torch.cat([p[1] for p in parts])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(int((rk - rp).abs().max()),
              int((dk.to(torch.int32) - dp.to(torch.int32)).abs().max()))
    if err != 0:
        fail(f"fused_round differs from plain on config4's 100,000 instances "
             f"(max abs err {err})")
    ops, nbytes, words = fused_bound(c4, stats, c4.instances)
    ops_ms, bytes_ms = ops / INT_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    say(f"[kernel] fused_round on config4's 100,000 instances: {kernel_ms:.3f} ms "
        f"(mean of 5, CUDA events); plain {plain_ms:.1f} ms; bound "
        f"{max(ops_ms, bytes_ms):.3f} ms from {ops:.4g} int ops "
        f"({stats['chain_trips']} chain draws, {words} PRF words) and "
        f"{nbytes} bytes; {card}")
    kernels = [{
        "name": "fused_round", "route": "cuda",
        "source": "byzantinerandomizedconsensus_tpu_torch/csrc/fused_round.cu",
        "replaces": "byzantinerandomizedconsensus_tpu/ops/pallas_round.py:268",
        "launches": launches, "max_abs_err": err, "matches_plain": True,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }]

    # Phase 5: the per-step kernels against plain on a grid.
    step_phase(dev)

    # Phase 6: config 5 at n=512 through the per-step kernels.
    kernels += config5_phase(dev, card)

    # Phase 7: the other BASELINE configurations as shipped, through fused_round.
    t0 = time.perf_counter()
    kernels[0]["paths"] = shipped_phase(card)
    say(f"[shipped] phase 7 took {time.perf_counter() - t0:.1f} s")

    # Phase 8: the §9 fault schedules through fused_round.
    t0 = time.perf_counter()
    kernels[0]["paths"] += fault_phase(dev, card)
    say(f"[faults] phase 8 took {time.perf_counter() - t0:.1f} s")

    # Phase 9: urn3, committee and the packing laws v2/v3 through fused_round.
    t0 = time.perf_counter()
    wide_paths = wide_phase(dev, card)
    kernels[0]["paths"] += wide_paths
    kernels += wide_kernels(wide_paths)
    say(f"[wide] phase 9 took {time.perf_counter() - t0:.1f} s")

    # Phase 10: the keys and urn laws over the per-config surface.
    k1_paths, new_libs, k2_paths, k3_paths = laws_phase(dev, card)
    kernels[0]["paths"] += k1_paths
    by_name = {k["name"]: k for k in kernels}
    by_name["keys_step"]["paths"] = k2_paths
    by_name["urn_step"]["paths"] = k3_paths
    for lib, p in new_libs.items():
        step = lib.endswith("_wide")
        kernels.append({
            "name": lib, "route": "cuda",
            "source": f"byzantinerandomizedconsensus_tpu_torch/csrc/{lib}.cu",
            "replaces": (STEP_REPLACES[p["kernel"]] if step
                         else "byzantinerandomizedconsensus_tpu/ops/pallas_round.py:268"),
            "path": p["config"], "launches": p["launches"], "max_abs_err": p["max_abs_err"],
            # The step libraries' times per launch, as keys_step's and urn_step's.
            "ms": p["ms_per_launch"] if step else p["ms"],
            "plain_ms": p["plain_ms_per_launch"] if step else p["plain_ms"],
            "bound_ms": p["bound_ms_per_launch"] if step else p["bound_ms"],
            "bound_by": p["bound_by"], "library_ms": None,
        })

    # Phase 11: the replica-sharded path through K2 and K3 with receiver offsets.
    for kernel, cells in mesh_phase(dev, card).items():
        by_name[kernel]["mesh_paths"] = cells

    # Phase 12: the config-5 sweep, the bit-match check and the counters
    # through the CLI.
    for kernel, entries in sweep_bitmatch_phase(card).items():
        by_name[kernel]["paths"] += entries

    # Phase 13: the lane runners on the plain round driver.
    lanes_phase(card)

    # Phase 14: the consensus server, its direct leg through K1, K2 and K3,
    # its lane leg, and a crash and WAL recovery of cli serve.
    serve_paths, single_rows = serve_phase(card)
    for kernel, entries in serve_paths.items():
        by_name[kernel]["paths"] += entries

    # Phase 15: the serving fleet, worker processes on the card through K1,
    # K2 and K3: routing, a worker lost and replaced, the autoscaler, cli
    # serve --workers 2, and each worker's kernel census.
    for kernel, entries in fleet_phase(card, single_rows).items():
        by_name[kernel]["paths"] += entries

    # Phase 16: the load drivers (loadgen, the hostile suite, the soaks)
    # through K1, K2 and K3; each library's launches in the default load.
    by_name = {k["name"]: k for k in kernels}
    for lib, launches in loadgen_phase(card).items():
        by_name[lib].setdefault("paths", []).append({
            "config": "cli loadgen (seed 14, 200 requests, rate 4/s, direct leg)",
            "launches": launches, "max_abs_err": 0})

    # Phase 17: the adversary hunter (cli hunt) through K1 and K2, each
    # hunt's archive held against the reference's; each library it
    # launched held against plain.
    by_lib_a, by_lib_d, errs_a, errs_d = hunt_phase(card)
    for label, by_lib, errs in (("cli hunt (evolution, seed 17, budget 500, pipelined and "
                                 "barriered, direct leg)", by_lib_a, errs_a),
                                ("cli hunt --committee-scale (budget 32, direct leg)",
                                 by_lib_d, errs_d)):
        for lib, launches in by_lib.items():
            if lib not in by_name:
                fail(f"the hunt launched {lib}, which has no entry in the kernels line")
            by_name[lib].setdefault("paths", []).append({
                "config": label, "launches": launches,
                "max_abs_err": errs[lib]["max_abs_err"],
                "compared_on": errs[lib]["compared_on"]})

    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
