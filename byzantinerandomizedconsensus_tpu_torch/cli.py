"""Command line of the port: run a preset or a config-5 sweep point through
the torch backend and print the same JSON summary as the reference CLI's
``run``.

    python -m byzantinerandomizedconsensus_tpu_torch.cli run --preset config4
    python -m byzantinerandomizedconsensus_tpu_torch.cli run --preset config4 \
        --instances 256 --device cpu --hist
    python -m byzantinerandomizedconsensus_tpu_torch.cli run --sweep-point 512 \
        --delivery keys
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys

import numpy as np

from byzantinerandomizedconsensus_tpu_torch.backends import get_backend
from byzantinerandomizedconsensus_tpu_torch.backends.base import SimResult
from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import KERNELS
from byzantinerandomizedconsensus_tpu_torch.config import (
    DELIVERY_KINDS, PRESETS, preset, sweep_point)


def round_histogram(res: SimResult) -> np.ndarray:
    """(round_cap + 1,) int64 — index r counts instances that terminated in r
    rounds; capped instances sit in the last bin."""
    return np.bincount(res.rounds, minlength=res.config.round_cap + 1).astype(np.int64)


def decision_histogram(res: SimResult) -> np.ndarray:
    """(3,) int64 — counts of decisions 0, 1 and 2 (undecided at the cap)."""
    return np.bincount(res.decision, minlength=3).astype(np.int64)


def _percentiles(values, qs) -> list:
    """Exact nearest-rank percentiles (an element of ``values`` each)."""
    vals = np.sort(np.asarray(values).ravel())
    if vals.size == 0:
        return [None] * len(qs)
    return [int(vals[max(1, math.ceil(q * vals.size / 100.0)) - 1]) for q in qs]


def summary(res: SimResult) -> dict:
    """The reference CLI's ``run`` summary keys, from one result."""
    cfg = res.config
    decided = res.decision != 2
    dh = decision_histogram(res)
    n_inst = int(len(res.inst_ids))
    return {
        "protocol": cfg.protocol, "n": cfg.n, "f": cfg.f,
        "adversary": cfg.adversary, "coin": cfg.coin,
        "delivery": cfg.delivery, "faults": cfg.faults, "seed": cfg.seed,
        "instances": n_inst,
        "decided": int(decided.sum()),
        "decided_fraction": round(int(decided.sum()) / n_inst, 6) if n_inst else None,
        "undecided_at_cap": int(dh[2]),
        "round_cap": cfg.round_cap,
        "mean_rounds_decided": float(res.rounds[decided].mean()) if decided.any() else None,
        "max_rounds": int(res.rounds.max()) if len(res.rounds) else 0,
        **dict(zip(("rounds_p50", "rounds_p90", "rounds_p99"),
                   _percentiles(res.rounds, (50, 90, 99)))),
        "decision_histogram": dh.tolist(),
        "wall_s": res.wall_s,
        "instances_per_sec": res.instances_per_sec if res.wall_s else None,
    }


def cmd_run(args) -> int:
    if args.sweep_point is not None:
        cfg = sweep_point(args.sweep_point)
    else:
        cfg = preset(args.preset or "config4")
    overrides = {k: v for k, v in (("instances", args.instances),
                                   ("delivery", args.delivery),
                                   ("adversary", args.adversary)) if v is not None}
    cfg = dataclasses.replace(cfg, **overrides).validate()
    backend = get_backend("torch", device=args.device, kernel=args.kernel)
    backend.prepare(cfg)
    res = backend.timed_run(cfg)
    out = summary(res)
    out["backend"] = "torch"
    out["kernel"] = backend.kernel_for(cfg)
    out["device"] = str(backend.device)
    if backend.device.type == "cuda":
        import torch

        out["device_name"] = torch.cuda.get_device_name(backend.device)
    if args.hist:
        out["round_histogram"] = round_histogram(res).tolist()
    print(json.dumps(out))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="byzantinerandomizedconsensus_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="run a preset or a config-5 sweep point "
                         "through the torch backend")
    which = run.add_mutually_exclusive_group()
    which.add_argument("--preset", choices=sorted(PRESETS), default=None,
                       help="a benchmark preset (default config4)")
    which.add_argument("--sweep-point", type=int, default=None, metavar="N",
                       help="config 5's sweep point at n=N (bracha, f=(N-1)//3, "
                            "adaptive, shared coin, 2000 instances)")
    run.add_argument("--instances", type=int, default=None,
                     help="run only the first N instances of the config")
    run.add_argument("--delivery", choices=DELIVERY_KINDS, default=None,
                     help="override the config's delivery law (keys, urn: "
                          "the per-step kernels)")
    run.add_argument("--adversary", default=None,
                     help="override the config's adversary")
    run.add_argument("--device", default="cuda",
                     help="cuda (default; raises with no card) or cpu")
    run.add_argument("--kernel", choices=KERNELS, default=None,
                     help="fused (the round-loop kernel; default on cuda for "
                          "urn2), step (the per-step kernels; default on cuda "
                          "for keys and urn) or plain (torch ops)")
    run.add_argument("--hist", action="store_true",
                     help="add the rounds histogram to the summary")
    run.set_defaults(fn=cmd_run)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
