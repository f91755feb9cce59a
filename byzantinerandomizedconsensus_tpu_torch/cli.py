"""Command line of the port: run a preset or a config-5 sweep point through
the torch backend and print the same JSON summary as the reference CLI's
``run``; or run the five benchmark configurations as shipped and print them
in one JSON, as the reference's ``product`` does.

    python -m byzantinerandomizedconsensus_tpu_torch.cli run --preset config4
    python -m byzantinerandomizedconsensus_tpu_torch.cli run --preset config2 --hist
    python -m byzantinerandomizedconsensus_tpu_torch.cli run --preset config4 \
        --instances 256 --device cpu --hist
    python -m byzantinerandomizedconsensus_tpu_torch.cli run --sweep-point 512
    python -m byzantinerandomizedconsensus_tpu_torch.cli run --sweep-point 512 \
        --delivery keys
    python -m byzantinerandomizedconsensus_tpu_torch.cli product --out product.json
    python -m byzantinerandomizedconsensus_tpu_torch.cli trace \
        --configs config3 config5@1024 config5@512/keys
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import sys
import tempfile

import numpy as np

from byzantinerandomizedconsensus_tpu_torch.backends import get_backend
from byzantinerandomizedconsensus_tpu_torch.backends.base import SimResult
from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import KERNELS
from byzantinerandomizedconsensus_tpu_torch.config import (
    DELIVERY_KINDS, PRESETS, SWEEP_POINT_N, preset, sweep_point)

#: The configurations of ``product``: the four presets and config 5's sweep
#: point, each as shipped.
PRODUCT_CONFIGS = (*PRESETS, "config5")


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
    out.update(_device_fields(backend), kernel=backend.kernel_for(cfg))
    if args.hist:
        out["round_histogram"] = round_histogram(res).tolist()
    print(json.dumps(out))
    return 0


def _device_fields(backend) -> dict:
    out = {"backend": "torch", "device": str(backend.device)}
    if backend.device.type == "cuda":
        import torch

        out["device_name"] = torch.cuda.get_device_name(backend.device)
    return out


def named_config(name: str):
    """A preset, or ``config5@N`` (config 5's sweep point at n=N under its
    own law) or ``config5@N/LAW`` (under the delivery law LAW)."""
    if not name.startswith("config5@"):
        return preset(name)
    n, _, law = name.split("@", 1)[1].partition("/")
    cfg = sweep_point(int(n))
    return dataclasses.replace(cfg, delivery=law).validate() if law else cfg


def cmd_trace(args) -> int:
    """Each configuration through the torch backend on the card under
    ``torch.profiler``: one JSON line each with the device's busy share of
    the traced runs' window, its time by kernel name and the runs' host
    times, after a line with the card's name and power limit."""
    from byzantinerandomizedconsensus_tpu_torch import trace

    backend = get_backend("torch", kernel=args.kernel)
    card = trace.card_line()
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = pathlib.Path(args.out_dir or tmp)
        out_dir.mkdir(parents=True, exist_ok=True)
        for name in args.configs:
            cfg = named_config(name)
            path = out_dir / f"trace_{name.replace('@', '_n').replace('/', '_')}.json"
            out = {"config": name, "protocol": cfg.protocol, "adversary": cfg.adversary,
                   "delivery": cfg.delivery, "n": cfg.n, "instances": cfg.instances,
                   "kernel": backend.kernel_for(cfg), "runs": args.runs,
                   **trace.trace_runs(backend, cfg, args.runs, path), "card": card}
            if args.out_dir:
                out["trace_file"] = str(path)
            print(json.dumps(out), flush=True)
    return 0


def cmd_product(args) -> int:
    """Each configuration as shipped (every instance, its own round cap and
    delivery law): one warm-up run, then the best of ``--repeats`` timed
    runs, with every wall and both histograms. One JSON object, keyed by
    configuration, on stdout and in ``--out`` if given."""
    backend = get_backend("torch", device=args.device, kernel=args.kernel)
    out = {"description": "The five benchmark configurations as shipped, through the "
                          "torch backend: per configuration the run summary, the best "
                          "of the timed walls and the full round and decision "
                          "histograms"}
    for name in args.configs:
        cfg = sweep_point(SWEEP_POINT_N) if name == "config5" else preset(name)
        backend.prepare(cfg)
        backend.run(cfg)  # warm-up
        runs = [backend.timed_run(cfg) for _ in range(args.repeats)]
        res = min(runs, key=lambda r: r.wall_s)
        if any(not (np.array_equal(r.rounds, res.rounds)
                    and np.array_equal(r.decision, res.decision)) for r in runs):
            raise RuntimeError(f"{name}: repeated runs differ")
        entry = summary(res)
        entry.update(_device_fields(backend), kernel=backend.kernel_for(cfg),
                     walls_s=[r.wall_s for r in runs],
                     round_histogram=round_histogram(res).tolist())
        out[name] = entry
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    print(text)
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
    prod = sub.add_parser("product", help="the five benchmark configurations as "
                          "shipped, timed, with histograms, in one JSON")
    prod.add_argument("--configs", nargs="+", choices=PRODUCT_CONFIGS,
                      default=list(PRODUCT_CONFIGS), help="a subset to run")
    prod.add_argument("--repeats", type=int, default=5,
                      help="timed runs after the warm-up (default 5)")
    prod.add_argument("--device", default="cuda",
                      help="cuda (default; raises with no card) or cpu")
    prod.add_argument("--kernel", choices=KERNELS, default=None,
                      help="as for run (default: fused on cuda)")
    prod.add_argument("--out", default=None, help="also write the JSON here")
    prod.set_defaults(fn=cmd_product)
    tr = sub.add_parser("trace", help="where each configuration's time goes on the "
                        "card: a torch.profiler trace of runs")
    tr.add_argument("--configs", nargs="+",
                    default=["config1", "config2", "config3", "config4", "config5@512",
                             "config5@1024", "config5@512/keys", "config5@512/urn"],
                    help="presets, or config5@N[/LAW] for config 5's sweep point at "
                         "n=N (under the delivery law LAW)")
    tr.add_argument("--runs", type=int, default=3, help="traced runs per configuration")
    tr.add_argument("--kernel", choices=KERNELS, default=None, help="as for run")
    tr.add_argument("--out-dir", default=None,
                    help="keep the Chrome traces here (default: not kept)")
    tr.set_defaults(fn=cmd_trace)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
