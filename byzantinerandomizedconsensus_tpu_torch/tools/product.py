"""The five-preset product record: every benchmark configuration as shipped.

The port's copy of the reference ``tools/product.py``. It runs **every
preset exactly as shipped** (no cap lowering, no instance trimming) plus
config 5's sweep point, on the torch backend, and writes one run record
(kind ``product``) holding per configuration its wall-clock, instances per
second, device-busy time and the full round and decision histograms (the
bit-match surface of spec §1). On the card by default; ``--device cpu``
runs the plain round driver on the CPU.

Method (``utils/timing.py``): one warm-up run at the exact chunk shape
outside the timed window, best of N timed runs with every wall on record,
and a device-busy leg from a ``torch.profiler`` trace of one more run.
``--counters`` adds the protocol counters from one further untimed run of
the plain round driver (``obs/record.py::collect_counters``).

Regression guard: each entry carries ``vs_prev_round`` against the port's
own previous product record, in the port's directory
(:data:`RECORD_DIR`, numbered as ``utils/rounds.py`` numbers rounds), and
only where that entry ran on the same platform and backend. The
reference's ``artifacts/product_r*.json`` are the JAX package's records:
this tool never reads them as its previous round, and its default output
never lands on them.

    python -m byzantinerandomizedconsensus_tpu_torch.cli product
    python -m byzantinerandomizedconsensus_tpu_torch.cli product --configs config4 \
        --out product.json --counters
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from byzantinerandomizedconsensus_tpu_torch.backends import get_backend
from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import KERNELS
from byzantinerandomizedconsensus_tpu_torch.config import (
    PRESETS, SWEEP_INSTANCES, SWEEP_POINT_N, preset, sweep_point)
from byzantinerandomizedconsensus_tpu_torch.utils import metrics
from byzantinerandomizedconsensus_tpu_torch.utils.rounds import (
    default_artifact, prev_round_artifact)
from byzantinerandomizedconsensus_tpu_torch.utils.timing import (
    DEFAULT_REPEATS, device_busy, regression_verdict, timed_best_of)

#: The configurations of the record: the four presets and config 5's sweep
#: point, each as shipped.
CONFIGS = (*PRESETS, "config5")
#: The port's own product records (``product_r{N}.json``), apart from the
#: reference's ``artifacts/product_r*.json``.
RECORD_DIR = "artifacts/port"
#: The one backend the record runs.
BACKEND = "torch"


def shipped_config(name: str):
    """The configuration ``name`` as shipped: a preset, or ``config5``,
    config 5's sweep point at n = ``SWEEP_POINT_N``."""
    return sweep_point(SWEEP_POINT_N) if name == "config5" else preset(name)


def run_config(cfg, backend, timed_repeats: int = DEFAULT_REPEATS,
               counters: bool = False):
    """One shipped config end to end on ``backend`` (a torch backend): the
    warm-up, the best of ``timed_repeats`` timed runs and the device-busy
    leg (``utils/timing.py``), in the reference's entry layout
    (``utils/metrics.summary`` through ``obs/record.timing_block``), plus
    the round histogram, the backend's name, its device and the kernel the
    runs took. Returns ``(entry, raw_walls)``: the unrounded walls feed
    ``regression_verdict``.

    ``counters``: the protocol-counter block from one more, untimed run of
    the plain round driver on the same device; the timed runs stay
    counter-free."""
    res, walls = timed_best_of(backend, cfg, timed_repeats)
    dev = device_busy(backend, cfg)
    s = metrics.summary(res, walls=walls, device=dev)
    s["round_histogram"] = metrics.round_histogram(res).tolist()
    s["backend"] = BACKEND
    s["device"] = str(backend.device)
    s["kernel"] = backend.kernel_for(cfg)
    if counters:
        from byzantinerandomizedconsensus_tpu_torch.obs import record

        plain = get_backend(BACKEND, device=backend.device, kernel="plain")
        s["counters"] = record.collect_counters(plain, cfg)
    return s, walls


def platform_of(backend) -> str:
    """``cuda:<card name>`` on the card, ``cpu`` on the host: a previous
    entry compares only on the same platform."""
    if backend.device.type != "cuda":
        return "cpu"
    import torch

    return f"cuda:{torch.cuda.get_device_name(backend.device)}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Run all five benchmark configs as shipped; write the "
                    "product record")
    ap.add_argument("--out", default=default_artifact("product", subdir=RECORD_DIR))
    ap.add_argument("--backend", default=BACKEND,
                    help="the product backend (torch, the only one it runs)")
    ap.add_argument("--configs", nargs="*", default=list(CONFIGS), choices=CONFIGS,
                    help="subset to run (merged into an existing record)")
    ap.add_argument("--counters", action="store_true",
                    help="attach the protocol-counter block per config "
                         "(obs/counters.py; one extra untimed plain run each)")
    ap.add_argument("--repeats", type=int, default=DEFAULT_REPEATS,
                    help=f"timed runs after the warm-up (default {DEFAULT_REPEATS})")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits 2 with no card) or cpu")
    ap.add_argument("--kernel", choices=KERNELS, default=None,
                    help="as for run (default: fused on cuda, step for keys)")
    args = ap.parse_args(argv)

    if args.backend != BACKEND:
        print(f"product runs the torch backend only; got --backend {args.backend!r}",
              file=sys.stderr)
        return 2
    try:
        backend = get_backend(BACKEND, device=args.device, kernel=args.kernel)
    except RuntimeError as e:
        print(f"product: {e}", file=sys.stderr)
        return 2
    platform = platform_of(backend)
    path = pathlib.Path(args.out)
    art = json.loads(path.read_text()) if path.exists() else {}
    from byzantinerandomizedconsensus_tpu_torch.obs import record

    # The record head, refreshed on every merge so the env fingerprint
    # describes the newest contributing invocation.
    art.update(record.new_record("product"))
    art.setdefault(
        "description",
        "All five benchmark configs run end-to-end AS SHIPPED through the torch "
        "backend (tools/product.py): per config, wall-clock/instances-per-sec "
        "(warmed, best-of-N with the walls_s spread recorded), the device-busy "
        "time and the full round/decision histograms")
    prev = prev_round_artifact(
        "product", subdir=RECORD_DIR,
        usable=lambda d: any(k.startswith("config") for k in d))
    for name in args.configs:
        cfg = shipped_config(name)
        label = (f"config5@n{SWEEP_POINT_N} (sweep point, {SWEEP_INSTANCES} instances)"
                 if name == "config5" else name)
        print(f"{label}: n={cfg.n} f={cfg.f} x{cfg.instances} "
              f"{cfg.adversary}/{cfg.coin} cap={cfg.round_cap}", flush=True)
        entry, raw_walls = run_config(cfg, backend, args.repeats, counters=args.counters)
        entry["platform"] = platform
        prev_entry = prev[2].get(name, {}) if prev else {}
        if (prev_entry.get("instances_per_sec")
                and prev_entry.get("platform") == platform
                and prev_entry.get("backend") == BACKEND):
            entry.update(regression_verdict(
                raw_walls, rate=entry["instances_per_sec"],
                prev_wall_rate=prev_entry["instances_per_sec"],
                device_busy_s=entry.get("device_busy_s"),
                prev_device_busy_s=prev_entry.get("device_busy_s")))
            entry["prev_round_artifact"] = prev[0]
        art[name] = entry
        print(json.dumps({k: entry[k] for k in
                          ("wall_s", "instances_per_sec", "device_busy_s",
                           "undecided_at_cap", "mean_rounds_decided", "vs_prev_round")
                          if k in entry}), flush=True)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(art, indent=1, sort_keys=True) + "\n")
    print(json.dumps({
        "out": str(path),
        "platform": platform,
        "configs": sorted(k for k in art if k.startswith("config")),
        # walls of this invocation only: merged entries may come from others
        "total_wall_s_this_run": round(
            sum(art[k].get("wall_s", 0) for k in args.configs), 2),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
