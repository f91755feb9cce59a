#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``). Imports nothing of JAX.
Phases, in order; any failure exits nonzero and prints no result:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build every kernel from ``byzantinerandomizedconsensus_tpu_torch/csrc``;
3. each kernel against its plain torch version on the card, on a grid of
   small configs (every init law, both coins, capped instances) and at
   config4's shape, with tolerance 0: the outputs are integers drawn from
   one counter-based PRF, so they must be identical;
4. the main path: preset config4, all 100,000 instances, through
   ``get_backend("torch")``, held against the reference histograms; its
   throughput, best of 5 after a warm-up; the kernel's and the plain
   version's times on the main path's inputs, and the kernel's bound;
5. a ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

# The reference result of config4 (seed 0, 100,000 instances): the JAX
# package's ``cli run --preset config4 --hist``, identical on a TPU v5e and a
# CPU (artifacts/product_r5.json["config4"]).
CONFIG4_DECISIONS = [47697, 52303, 0]
CONFIG4_ROUNDS_HEAD = [0, 57987, 42008, 5]
METRIC = "consensus_instances_per_sec@n512_f170_shared_coin"

# H100 SXM peaks for the bound: HBM3 at 3.35 TB/s (NVIDIA data sheet). For
# integer work, each of an SM's 4 schedulers issues one 32-lane warp
# instruction per clock: 64 lanes of INT32 ALU plus the FMA pipe, which runs
# IMAD (Hopper white paper), so at most 128 lane-operations per SM per clock,
# x 132 SMs x 1.98 GHz boost. A bound must not exceed the least time, so it
# takes this issue peak rather than the 64-lane INT32 rate alone.
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 128 * 1.98e9
# Integer operations per unit of work, counted from csrc/fused_round.cuh:
# a threefry word is 20 rounds of (add, rotate, xor), 5 key injections of
# two adds and the two initial adds; a chain draw is the LCG multiply-add,
# the shift-xor, the range reduction (shift, subtract, multiply, shift) and
# the compare-and-add.
OPS_PER_PRF_WORD = 20 * 3 + 5 * 2 + 2
OPS_PER_CHAIN_DRAW = 9


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
        for line in _build.build_log(k).splitlines():
            if "registers" in line or "spill" in line:
                say(f"[build] {k}: {line.strip()}")

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
    fused_round.launches = 0
    res = backend.timed_run(c4)
    launches = fused_round.launches
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
    words = stats["chain_seeds"] + stats["instance_rounds"] + c4.instances * c4.n
    ops = stats["chain_trips"] * OPS_PER_CHAIN_DRAW + words * OPS_PER_PRF_WORD
    nbytes = c4.instances * (4 + 4 + 1)  # ids in, rounds and decision out
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
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
