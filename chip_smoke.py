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
   goldens; for each configuration its throughput (best of 5 after a
   warm-up), the kernel's time (CUDA events around the launch, the
   adversary's planes built beforehand) beside the wrapper's and its
   launches, the plain version's time, the bound counted from the plain
   version's work counters, and the instantiation's ptxas registers,
   failing if the kernel beats its bound;
8. a ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import re
import subprocess
import sys
import time

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


def fused_ptxas() -> dict:
    """``{(protocol, adversary): "N registers, S bytes spill stores, L bytes
    spill loads"}`` of the current build of ``fused_round``, one entry per
    instantiation, from its ``ptxas -v`` report."""
    from byzantinerandomizedconsensus_tpu_torch.ops import _build

    out, key = {}, None
    for line in _build.build_log("fused_round").splitlines():
        m = re.search(r"fused_round_kernelILi(\d)ELi(\d)E", line)
        if m:
            key = (FUSED_PROTOCOLS[int(m.group(1))], FUSED_ADVERSARIES[int(m.group(2))])
            out[key] = []
        elif key is not None and ("registers" in line or "spill" in line):
            out[key].append(line.split("info    : ")[-1].strip())
    return {k: " / ".join(v) for k, v in out.items()}


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


def plain_step(law, cfg, seed, ids, rnd, t, values, silent, faulty, honest):
    mod = step_module(law)
    if law == "keys":
        return mod.step_counts_plain(cfg, seed, ids, rnd, t, values, silent, faulty)
    return mod.step_counts_plain(cfg, seed, ids, rnd, t, values, silent, faulty, honest)


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
                   faulty: torch.Tensor) -> int:
    """The PRF words one keys step needs on these planes: for each receiver
    row, the senders of its crossing class other than itself, and none where
    every live key is selected (``csrc/keys_step.cuh::row_plan``). The
    classes come from the wire values alone, so this count needs no hashing.
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
    return int(hashed.sum())


def urn_draws(cfg, values: torch.Tensor, silent: torch.Tensor, faulty: torch.Tensor,
              honest: torch.Tensor):
    """(draws, PRF words, drops) of one urn step on these planes: the
    receivers with D > 0 need a PRF word each; two strata draw min(D, B0)
    per receiver, B0 being its live biased messages other than its own, and
    one stratum D (``csrc/urn_step.cuh::urn_counts``); drops is the sum of D."""
    from byzantinerandomizedconsensus_tpu_torch.ops import urn

    _, m, st, _, D = urn.lane_setup(cfg, values, silent, faulty, honest)
    D = D.to(torch.int64)
    drawn = D
    if st is not None:
        B0 = sum(torch.where(s, c, 0).to(torch.int64) for s, c in zip(st, m))
        drawn = torch.minimum(D, B0)
    return int(drawn.sum()), int((D > 0).sum()), int(D.sum())


def step_bound(law, cfg, call):
    """(operations, bytes, PRF words, the earlier count's operations) the
    step must do on these inputs."""
    seed, ids, rnd, t, values, silent, faulty, honest = call
    B, n = values.shape
    if law == "keys":
        words = crossing_pairs(cfg, values, silent, faulty)
        tables = 2 if cfg.adversary == "adaptive" else 1
        ops = words * (OPS_PER_PRF_WORD + OPS_PER_KEY) + B * n * tables
        nbytes = B * (4 + 3 * n + 8 * n)
        return ops, nbytes, words, ops
    draws, words, drops = urn_draws(cfg, values, silent, faulty, honest)
    per_draw = OPS_PER_URN_DRAW if cfg.adversary != "none" else OPS_PER_SINGLE_URN_DRAW
    ops = words * OPS_PER_PRF_WORD + draws * per_draw
    earlier = B * n * OPS_PER_PRF_WORD + drops * EARLIER_OPS_PER_URN_DRAW
    planes = 3 if cfg.adversary == "adaptive_min" else 2
    nbytes = B * (4 + planes * n + 8 * n)
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
            draws = [urn_draws(cfg, *call[4:8])[:2] for call in calls]
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
    and per faulty sender and step under the Byzantine adversary; the ids
    read, the results written and the adversary's planes read once (a byte
    per replica for the faulty set, four more for the crash rounds)."""
    byz = BYZ_WORDS_PER_ROUND[cfg.protocol] if cfg.adversary == "byzantine" else 0
    words = (stats["chain_seeds"] + stats["coin_words"]
             + (B * cfg.n if cfg.init == "random" else 0)
             + byz * cfg.f * stats["instance_rounds"])
    ops = stats["chain_trips"] * OPS_PER_CHAIN_DRAW + words * OPS_PER_PRF_WORD
    plane = {"none": 0, "crash": 5}.get(cfg.adversary, 1)
    return ops, B * (4 + 4 + 1 + plane * cfg.n), words


def fused_on_path(cfg, ids, reps: int):
    """The kernel and its plain version on one path's inputs: the kernel's
    time (CUDA events around ``reps`` launches, the adversary's planes built
    beforehand), the wrapper's (planes built each call), the plain
    version's (host clock, synchronised) and its work counters, the max abs
    error between the two, and the bound. Fails if they differ, or if the
    kernel beats its bound."""
    from byzantinerandomizedconsensus_tpu_torch import get_backend
    from byzantinerandomizedconsensus_tpu_torch.ops import fused_round, prf

    planes = fused_round.adversary_planes(cfg, ids, prf.seed_key(cfg.seed))
    rk, dk = fused_round.run_chunk(cfg, ids, planes=planes)
    kernel_ms = cuda_ms(lambda: fused_round.run_chunk(cfg, ids, planes=planes), reps)
    wrapper_ms = cuda_ms(lambda: fused_round.run_chunk(cfg, ids), reps)
    chunk = get_backend("torch", kernel="plain").chunk_size(cfg)
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
    return {"ms": kernel_ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "max_abs_err": err, "ops": ops, "bytes": nbytes, "prf_words": words,
            "chain_draws": stats["chain_trips"], "instance_rounds": stats["instance_rounds"]}


def shipped_run(backend, cfg, label, card, ptxas, reps=5):
    """One shipped configuration through the backend a user calls: the run
    with its launches counted, its throughput (best of 5 after a warm-up),
    then the kernel and the plain version on its inputs. Returns
    ``(result, path entry)``."""
    backend.prepare(cfg)
    reset_launches()
    res = backend.timed_run(cfg)
    launches = read_launches()
    if launches["fused_round"] < 1 or launches["keys_step"] or launches["urn_step"]:
        fail(f"{label} did not run through fused_round alone: launches {launches}")
    backend.timed_run(cfg)  # warm-up
    walls = [backend.timed_run(cfg).wall_s for _ in range(5)]
    ids = torch.as_tensor(res.inst_ids, dtype=torch.int32).cuda()
    entry = fused_on_path(cfg, ids, reps)
    inst = (cfg.protocol, cfg.adversary)
    entry.update(config=label, instances=len(res.inst_ids), launches=launches["fused_round"],
                 instances_per_s=len(res.inst_ids) / min(walls), walls_s=walls,
                 ptxas=ptxas[inst])
    say(f"[shipped] {label} ({cfg.protocol}, {cfg.adversary}, n={cfg.n}, f={cfg.f}, "
        f"{cfg.coin} coin, {len(res.inst_ids)} instances): instances/s = "
        f"{entry['instances_per_s']} (best of 5 walls {walls} s); fused_round "
        f"{entry['ms']:.4f} ms (mean of {reps}, CUDA events, planes built beforehand; "
        f"wrapper {entry['wrapper_ms']:.4f} ms), {launches['fused_round']} launch(es); "
        f"plain {entry['plain_ms']:.1f} ms; bound {entry['bound_ms']:.5f} ms by "
        f"{entry['bound_by']} from {entry['ops']:.4g} int ops ({entry['chain_draws']} "
        f"chain draws, {entry['prf_words']} PRF words, {entry['instance_rounds']} "
        f"instance-rounds) and {entry['bytes']} bytes; ptxas ({cfg.protocol}, "
        f"{cfg.adversary}) {ptxas[inst]}; {card}")
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

    ptxas = fused_ptxas()
    backend = get_backend("torch")
    product = json.loads((ROOT / PRODUCT_FILE).read_text())
    paths = []
    for name in ("config1", "config2", "config3"):
        cfg = preset(name)
        res, entry = shipped_run(backend, cfg, name, card, ptxas,
                                 reps=2 if name == "config2" else 5)
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
        res, entry = shipped_run(backend, cfg, f"config5 n={n}", card, ptxas)
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
        if k != "fused_round":
            say(f"[build] {k}: {ptxas_summary(k)}")
    for (protocol, adversary), regs in fused_ptxas().items():
        say(f"[build] fused_round ({protocol}, {adversary}): {regs}")

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

    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
