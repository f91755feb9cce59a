"""Command line of the port, with the reference CLI's JSON:

- ``run``: a preset, a config-5 sweep point or an ad-hoc config through the
  torch backend, printing the reference's run summary; with ``--counters``
  the protocol counters beside it, with ``--total-instances`` a run across
  derived seeds;
- ``sweep``: config 5's resumable sweep, one checkpoint shard per (n,
  instance range), the reference's shard files; with ``--batched`` each
  shard row runs as lanes of the lane runner (``--kernel plain``);
- ``bitmatch``: a backend against an arbiter (``cpu``, the object oracle, or
  ``native``, the C++ core), per instance on sampled ids;
- ``product``: the five benchmark configurations as shipped, in the
  reference's product record (``tools/product.py``; its options pass
  through);
- ``profile``: where each configuration's time goes on the card, from a
  ``torch.profiler`` trace (``cardprofile.py``);
- ``trace``: the consumers of the host-side telemetry (``tools/trace.py``;
  its options pass through): ``export --chrome``, ``summary``, ``follow``
  and the ``overhead`` A/B;
- ``programs``: the consumers of the kernel census (``tools/programs.py``;
  its options pass through): ``dump``, ``diff``, ``roofline`` and the
  ``census`` A/B;
- ``serve``: the always-on consensus service over HTTP
  (``serve/server.py``; its options pass through): one kernel run per
  request on the card, or the compacted lane grid with ``--kernel plain``;
  ``--wal DIR`` journals admissions and ``--recover DIR`` replays them;
- ``loadgen``: the seeded open-loop load generator over the server or a
  fleet (``tools/loadgen.py``; its options pass through), and with
  ``--scenario NAME`` the hostile and elastic drills (``tools/hostile.py``);
- ``chaos``: the randomized differential soak in chaos mode
  (``tools/soak.py --chaos``; its options pass through);
- ``hunt``: the adversary hunter over the server (``hunt/hunter.py``; its
  options pass through): a seeded worst-case search, on the card through
  the direct leg, with ``--kernel plain`` the lane leg.

Everything runs on the card unless ``--device cpu`` is given.

    python -m byzantinerandomizedconsensus_tpu_torch.cli run --preset config4
    python -m byzantinerandomizedconsensus_tpu_torch.cli run --preset config2 --hist
    python -m byzantinerandomizedconsensus_tpu_torch.cli run --preset config4 \
        --instances 256 --device cpu --hist
    python -m byzantinerandomizedconsensus_tpu_torch.cli run --preset config3 \
        --kernel plain --counters
    python -m byzantinerandomizedconsensus_tpu_torch.cli run --preset config2 \
        --total-instances 300000
    python -m byzantinerandomizedconsensus_tpu_torch.cli run --sweep-point 512
    python -m byzantinerandomizedconsensus_tpu_torch.cli run --sweep-point 512 \
        --delivery keys
    python -m byzantinerandomizedconsensus_tpu_torch.cli run --committee-point 131072 --hist
    python -m byzantinerandomizedconsensus_tpu_torch.cli sweep --out sweep_out
    python -m byzantinerandomizedconsensus_tpu_torch.cli sweep --out sweep_out \
        --batched --kernel plain
    python -m byzantinerandomizedconsensus_tpu_torch.cli bitmatch --preset config4 \
        --samples 300 --arbiter native
    python -m byzantinerandomizedconsensus_tpu_torch.cli bitmatch --protocol bracha \
        -n 16 -f 5 --instances 64 --samples 24 --arbiter cpu
    python -m byzantinerandomizedconsensus_tpu_torch.cli product --out product.json
    python -m byzantinerandomizedconsensus_tpu_torch.cli profile \
        --configs config3 config5@1024 config5@512/keys
    python -m byzantinerandomizedconsensus_tpu_torch.cli trace overhead --configs 40
    python -m byzantinerandomizedconsensus_tpu_torch.cli programs census --configs 40
    python -m byzantinerandomizedconsensus_tpu_torch.cli serve --port 8787 --wal wal_dir
    python -m byzantinerandomizedconsensus_tpu_torch.cli serve --device cpu \
        --policy width=8,segment=1
    python -m byzantinerandomizedconsensus_tpu_torch.cli run --preset config3 --profile prof
    python -m byzantinerandomizedconsensus_tpu_torch.cli loadgen
    python -m byzantinerandomizedconsensus_tpu_torch.cli loadgen --scenario all
    python -m byzantinerandomizedconsensus_tpu_torch.cli chaos --configs 16 --jobs 4
    python -m byzantinerandomizedconsensus_tpu_torch.cli hunt --out hunt.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import tempfile
import time

from byzantinerandomizedconsensus_tpu_torch.backends import get_backend
from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import KERNELS
from byzantinerandomizedconsensus_tpu_torch.config import (
    DELIVERY_KINDS, FAULT_KINDS, PRESETS, PRODUCT_DELIVERY, SWEEP_INSTANCES, SWEEP_NS,
    SWEEP_NS_EXTENDED, SimConfig, committee_point, preset, sweep_point)
from byzantinerandomizedconsensus_tpu_torch.core.simulator import Simulator
from byzantinerandomizedconsensus_tpu_torch.obs import counters
from byzantinerandomizedconsensus_tpu_torch.tools.acceptance import compare_results, sample_ids
from byzantinerandomizedconsensus_tpu_torch.tools.product import CONFIGS as PRODUCT_CONFIGS  # noqa: F401  (the product's configurations, read by the tests)
from byzantinerandomizedconsensus_tpu_torch.utils import multiseed, sweep
from byzantinerandomizedconsensus_tpu_torch.utils.metrics import (  # noqa: F401  (the run summary's helpers, read by chip_smoke.py and the tests)
    decision_histogram, round_histogram, summary)


def _add_override_args(p: argparse.ArgumentParser) -> None:
    """The reference CLI's config flags other than ``--preset``."""
    p.add_argument("--protocol", choices=["benor", "bracha"], default=None)
    p.add_argument("-n", type=int, default=None)
    p.add_argument("-f", type=int, default=None)
    p.add_argument("--instances", type=int, default=None)
    p.add_argument("--adversary",
                   choices=["none", "crash", "byzantine", "adaptive", "adaptive_min"],
                   default=None)
    p.add_argument("--coin", choices=["local", "shared"], default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--round-cap", type=int, default=None)
    p.add_argument("--init", choices=["random", "all0", "all1", "split"], default=None)
    p.add_argument("--delivery", choices=DELIVERY_KINDS, default=None,
                   help="delivery law: urn, urn2, urn3 and committee run on the "
                        "fused kernel, keys on the per-step kernel (urn too with "
                        "--kernel step)")
    p.add_argument("--faults", choices=FAULT_KINDS, default=None,
                   help="fault schedule (spec §9), orthogonal to --adversary: "
                        "recover (crash-recovery windows) | partition (an "
                        "epoch isolating part of the fault-prone set) | "
                        "omission (per-round bursts); on the card through "
                        "the fused kernel under urn, urn2, urn3 and committee, "
                        "else with --kernel plain")


def _add_device_args(p: argparse.ArgumentParser, backend_help: str) -> None:
    """``--backend`` and the port's ``--device`` and ``--kernel``."""
    p.add_argument("--backend", default="torch", help=backend_help)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises with no card) or cpu")
    p.add_argument("--kernel", choices=KERNELS, default=None,
                   help="fused (the round-loop kernel; default on cuda for "
                        "urn, urn2, urn3 and committee), step (the per-step "
                        "kernels, keys and urn; default on cuda for keys) or "
                        "plain (torch ops)")


BACKEND_HELP = ("torch (default) | torch_sharded[:n_model[,kernel]] (the (data, model) "
                "mesh: every card on the data axis, n_model replica shards per row) | "
                "virtual[:DxM] (the mesh's driver on CPU tensors, D data x M model "
                "shards) | cpu (the object oracle) | native[:threads] (the C++ core)")


def _positive_int(text: str) -> int:
    value = int(text)
    if value <= 0:
        raise argparse.ArgumentTypeError(f"must be positive, got {value}")
    return value


def _announce_default_delivery() -> str:
    """One stderr line when ``--delivery`` is defaulted, naming the product
    law it takes."""
    print(f"[cli] --delivery not given: using the product scheduling model "
          f"'{PRODUCT_DELIVERY}' (pass --delivery {'|'.join(DELIVERY_KINDS)} "
          "to pin)", file=sys.stderr)
    return PRODUCT_DELIVERY


def _config_from(args, base=None) -> SimConfig:
    """The config the flags name: every flag given applies, on top of
    ``base`` or ``--preset`` where there is one, else on the reference CLI's
    ad-hoc defaults under the product delivery law."""
    overrides = {k: v for k, v in [
        ("protocol", args.protocol), ("n", args.n), ("f", args.f),
        ("instances", args.instances), ("adversary", args.adversary),
        ("coin", args.coin), ("seed", args.seed), ("round_cap", args.round_cap),
        ("init", args.init), ("delivery", args.delivery), ("faults", args.faults),
    ] if v is not None}
    if base is not None:
        return dataclasses.replace(base, **overrides).validate()
    if args.preset:
        return preset(args.preset, **overrides)
    delivery = args.delivery if args.delivery is not None \
        else _announce_default_delivery()
    defaults = dict(protocol="benor", n=4, f=1, instances=1, adversary="none",
                    coin="local", seed=0, round_cap=256, init="random",
                    delivery=delivery)
    defaults.update(overrides)
    return SimConfig(**defaults).validate()


def cmd_run(args) -> int:
    from byzantinerandomizedconsensus_tpu_torch.utils import profiling

    with profiling.trace(args.profile):
        return _run(args)


def _run(args) -> int:
    if args.sweep_point is not None:
        base = sweep_point(args.sweep_point)
    elif args.committee_point is not None:
        base = committee_point(args.committee_point)
    else:
        base = preset(args.preset or "config4")
    cfg = _config_from(args, base)
    backend = make_backend(args.backend, args.device, args.kernel)
    backend.prepare(cfg)
    counters_doc = shards = None
    if args.total_instances:
        if args.counters:
            print("--counters is not supported with --total-instances "
                  "(multi-seed shards have no counter channel yet)", file=sys.stderr)
            return 2
        res, shards = multiseed.run_large(
            cfg, args.total_instances, backend=backend,
            progress=lambda msg: print(msg, file=sys.stderr))
    elif args.counters:
        # The counter side output: the same run with bit-identical results,
        # plus the totals. A kernel without a counter channel makes the run
        # as asked, and the JSON says why it carries no totals.
        try:
            t0 = time.perf_counter()
            res, counters_doc = backend.run_with_counters(cfg)
            res.wall_s = time.perf_counter() - t0
        except counters.CountersUnsupported as e:
            print(f"[cli] {e}", file=sys.stderr)
            counters_doc = counters.unsupported_doc(e)
            res = backend.timed_run(cfg)
    else:
        res = backend.timed_run(cfg)
    out = summary(res)
    if counters_doc is not None:
        out["counters"] = counters_doc
    if shards is not None:
        out["seeds"] = [s.seed for s in shards]
    out.update(_device_fields(backend, args.backend, cfg))
    if args.hist:
        out["round_histogram"] = round_histogram(res).tolist()
    print(json.dumps(out))
    return 0


def cmd_bitmatch(args) -> int:
    """A sampled check of a backend against an arbiter, per instance: the
    object oracle (``cpu``, independent of the model layer) or the C++ core
    (``native``, fast enough for hundreds of samples at benchmark scale).
    Exit 0 when every sample matches, 1 on any mismatch, 2 when the backend
    is the arbiter itself."""
    if args.backend.partition(":")[0] == args.arbiter:
        print("bitmatch compares the arbiter against a *different* backend; "
              "pick a --backend not implemented by the arbiter "
              "(torch|torch_sharded|virtual, or native vs --arbiter cpu)",
              file=sys.stderr)
        return 2
    cfg = _config_from(args)
    if cfg.instances < args.samples:
        # A small preset (config1 ships one instance) widens its id range
        # rather than shrink the check: instance i depends only on
        # (cfg, seed, i) (spec §1).
        cfg = dataclasses.replace(cfg, instances=args.samples).validate()
    ids = sample_ids(cfg, args.samples, seed=cfg.seed)
    backend = make_backend(args.backend, args.device, args.kernel)
    ref = Simulator(cfg, args.arbiter).run(ids)
    got = backend.timed_run(cfg, ids)
    cmp = compare_results(ref, got)
    out = {
        "bitmatch": cmp["match"],
        "arbiter": args.arbiter,
        "backend": args.backend,
        "n_samples": int(len(ids)),
        # The effective id range, which may exceed a small preset's.
        "instances": int(cfg.instances),
        "mismatches": cmp["mismatches"],
        "arbiter_wall_s": ref.wall_s,
        "backend_wall_s": got.wall_s,
    }
    out.update(_device_fields(backend, args.backend, cfg))
    if len(ids) <= 32:
        out["samples"] = ids.tolist()
        out["arbiter_rounds"] = ref.rounds.tolist()
        out["backend_rounds"] = got.rounds.tolist()
    print(json.dumps(out))
    return 0 if cmp["match"] else 1


def cmd_sweep(args) -> int:
    """Config 5's sweep, resumable from the shards in ``--out``: one JSON
    record with the per-n summaries under ``points``."""
    delivery = args.delivery if args.delivery is not None \
        else _announce_default_delivery()
    default_ns = SWEEP_NS_EXTENDED if args.extended else SWEEP_NS
    points = sweep.run_sweep(
        pathlib.Path(args.out), backend=args.backend,
        ns=tuple(args.ns) if args.ns else default_ns,
        instances=args.instances, seed=args.seed,
        shard_instances=args.shard_instances, coin=args.coin,
        delivery=delivery, round_cap=args.round_cap, batched=args.batched,
        progress=lambda msg: print(msg, file=sys.stderr),
        **backend_options(args.backend, args.device, args.kernel),
    )
    print(json.dumps(sweep.sweep_record(points, args.backend, delivery)))
    return 0


def backend_options(name: str, device: str, kernel) -> dict:
    """The options ``get_backend(name, ...)`` takes: ``device`` and
    ``kernel`` for the torch backends; none for ``virtual`` (the plain path
    on the CPU) and the arbiters ``cpu`` and ``native``."""
    base = name.partition(":")[0]
    if base == "virtual" and kernel not in (None, "plain"):
        raise SystemExit(f"--backend {name} runs the plain path; got --kernel {kernel}")
    if base in ("cpu", "native") and kernel is not None:
        raise SystemExit(f"--backend {name} runs no torch kernel; got --kernel {kernel}")
    return {} if base in ("virtual", "cpu", "native") else {"device": device,
                                                            "kernel": kernel}


def make_backend(name: str, device: str, kernel):
    """The backend ``name`` (``torch``, ``torch_sharded[:M[,KERNEL]]``,
    ``virtual[:DxM]``, ``cpu`` or ``native[:threads]``) with the options it
    takes (:func:`backend_options`)."""
    return get_backend(name, **backend_options(name, device, kernel))


def _device_fields(backend, name: str = "torch", cfg=None) -> dict:
    """The backend's name, its device (and the card's name) and, with
    ``cfg``, the kernel the run took; the arbiters run on the host and have
    neither device nor kernel."""
    out = {"backend": name}
    device = getattr(backend, "device", None)
    if device is None:
        return out
    out["device"] = str(device)
    if device.type == "cuda":
        import torch

        out["device_name"] = torch.cuda.get_device_name(device)
    if cfg is not None:
        out["kernel"] = backend.kernel_for(cfg)
    return out


def named_config(name: str):
    """A preset, or ``config5@N`` (config 5's sweep point at n=N under its
    own law) or ``config5@N/LAW`` (under the delivery law LAW), or
    ``committee@N`` (``committee_point(N)``), or ``r19@N`` (a leg of the
    committee cost curve of ``artifacts/committee_r19.json``: Bracha, f =
    N/5, no adversary, shared coin, committee, 2^20/N instances); a
    ``+KIND`` suffix adds the §9 fault schedule KIND."""
    name, _, kind = name.partition("+")
    if name.startswith("committee@"):
        cfg = committee_point(int(name.split("@", 1)[1]))
    elif name.startswith("r19@"):
        n = int(name.split("@", 1)[1])
        cfg = dataclasses.replace(committee_point(n), adversary="none",
                                  instances=max(1, (1 << 20) // n))
    elif not name.startswith("config5@"):
        cfg = preset(name)
    else:
        n, _, law = name.split("@", 1)[1].partition("/")
        cfg = sweep_point(int(n))
        if law:
            cfg = dataclasses.replace(cfg, delivery=law)
    return dataclasses.replace(cfg, faults=kind).validate() if kind else cfg.validate()


def cmd_profile(args) -> int:
    """Each configuration through the torch backend on the card under
    ``torch.profiler``: one JSON line each with the device's busy share of
    the traced runs' window, its time by kernel name and the runs' host
    times, after a line with the card's name and power limit."""
    from byzantinerandomizedconsensus_tpu_torch import cardprofile

    backend = get_backend("torch", kernel=args.kernel)
    card = cardprofile.card_line()
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = pathlib.Path(args.out_dir or tmp)
        out_dir.mkdir(parents=True, exist_ok=True)
        for name in args.configs:
            cfg = named_config(name)
            stem = name.replace('@', '_n').replace('/', '_').replace('+', '_')
            path = out_dir / f"trace_{stem}.json"
            out = {"config": name, "protocol": cfg.protocol, "adversary": cfg.adversary,
                   "delivery": cfg.delivery, "faults": cfg.faults, "n": cfg.n,
                   "instances": cfg.instances,
                   "kernel": backend.kernel_for(cfg), "runs": args.runs,
                   **cardprofile.trace_runs(backend, cfg, args.runs, path), "card": card}
            if args.out_dir:
                out["trace_file"] = str(path)
            print(json.dumps(out), flush=True)
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="byzantinerandomizedconsensus_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="run a preset, a config-5 sweep point or an "
                         "ad-hoc config through the torch backend")
    which = run.add_mutually_exclusive_group()
    which.add_argument("--preset", choices=sorted(PRESETS), default=None,
                       help="a benchmark preset (default config4)")
    which.add_argument("--sweep-point", type=int, default=None, metavar="N",
                       help="config 5's sweep point at n=N (bracha, f=(N-1)//3, "
                            "adaptive, shared coin, 2000 instances)")
    which.add_argument("--committee-point", type=int, default=None, metavar="N",
                       help="config 5's shape under the committee family at n=N "
                            "(spec §10: bracha, f=N//5, adaptive, shared coin, "
                            "2000 instances; N up to 2^20)")
    _add_override_args(run)
    _add_device_args(run, BACKEND_HELP)
    run.add_argument("--hist", action="store_true",
                     help="add the rounds histogram to the summary")
    run.add_argument("--counters", action="store_true",
                     help="add the protocol counters (obs/counters.py): delivered "
                          "and dropped per phase, coin flips, the sampler's cost; "
                          "results stay bit-identical. Only --kernel plain has a "
                          "counter channel; another kernel runs as asked and the "
                          "JSON says why it has no totals")
    run.add_argument("--total-instances", type=_positive_int, default=None,
                     help="run this many instances across derived seeds "
                          "(utils/multiseed.py), past the per-seed ceiling of spec §2")
    run.add_argument("--profile", default=None, metavar="DIR",
                     help="write a torch.profiler Chrome trace of the run to DIR "
                          "(Perfetto); the plain round bodies' spans (brc/bracha/"
                          "echo, brc/urn2, brc/coin, ...) label its timeline")
    run.set_defaults(fn=cmd_run)
    bm = sub.add_parser("bitmatch", help="a backend against an arbiter, per instance "
                        "on sampled ids")
    bm.add_argument("--preset", choices=sorted(PRESETS), default=None,
                    help="a benchmark preset (default: an ad-hoc config from the "
                         "flags, benor n=4 f=1 where none is given)")
    _add_override_args(bm)
    _add_device_args(bm, BACKEND_HELP)
    bm.add_argument("--samples", type=_positive_int, default=4)
    bm.add_argument("--arbiter", choices=["cpu", "native"], default="cpu",
                    help="cpu (the object oracle) | native (the C++ core, fast "
                         "enough for hundreds of samples at benchmark scale)")
    bm.set_defaults(fn=cmd_bitmatch)
    sw = sub.add_parser("sweep", help="config 5's sweep (resumable)")
    sw.add_argument("--out", default="sweep_out",
                    help="the checkpoint directory: shards there are skipped")
    sw.add_argument("--ns", nargs="*", type=int, default=None)
    sw.add_argument("--extended", action="store_true",
                    help="add the n=2048 point past the v1 packing edge (spec §2 v2)")
    sw.add_argument("--instances", type=int, default=SWEEP_INSTANCES)
    sw.add_argument("--shard-instances", type=int, default=500)
    sw.add_argument("--seed", type=int, default=0)
    sw.add_argument("--round-cap", type=int, default=None)
    sw.add_argument("--coin", choices=["local", "shared"], default="shared")
    sw.add_argument("--delivery", choices=DELIVERY_KINDS, default=None)
    sw.add_argument("--batched", action="store_true",
                    help="run each shard row as lanes of the lane runner "
                         "(backends/batch.py; needs --kernel plain)")
    _add_device_args(sw, BACKEND_HELP)
    sw.set_defaults(fn=cmd_sweep)
    tr = sub.add_parser("profile", help="where each configuration's time goes on the "
                        "card: a torch.profiler trace of runs")
    tr.add_argument("--configs", nargs="+",
                    default=["config1", "config2", "config3", "config4", "config5@512",
                             "config5@1024", "config5@512/keys", "config5@512/urn"],
                    help="presets, or config5@N[/LAW] for config 5's sweep point at "
                         "n=N (under the delivery law LAW), committee@N for "
                         "committee_point(N), r19@N for a leg of the committee cost "
                         "curve; a +KIND suffix adds the fault schedule KIND "
                         "(config4+partition)")
    tr.add_argument("--runs", type=int, default=3, help="traced runs per configuration")
    tr.add_argument("--kernel", choices=KERNELS, default=None, help="as for run")
    tr.add_argument("--out-dir", default=None,
                    help="keep the Chrome traces here (default: not kept)")
    tr.set_defaults(fn=cmd_profile)
    sub.add_parser("product", add_help=False,
                   help="the five benchmark configurations as shipped, timed, with "
                        "histograms, in the product record (tools/product.py; every "
                        "further option passes through): --out, --configs, "
                        "--counters, --repeats, --device, --kernel")
    sub.add_parser("trace", add_help=False,
                   help="the host-side telemetry consumers (tools/trace.py; every "
                        "further option passes through): export --chrome, summary, "
                        "follow, overhead")
    sub.add_parser("programs", add_help=False,
                   help="the kernel census consumers (tools/programs.py; every "
                        "further option passes through): dump, diff, roofline, census")
    sub.add_parser("loadgen", add_help=False,
                   help="the seeded open-loop load generator over the server "
                        "or a fleet (tools/loadgen.py; every further option "
                        "passes through, see loadgen --help): --device, "
                        "--kernel, --workers 1,2, --smoke; --scenario NAME "
                        "runs the hostile and elastic drills (tools/hostile.py)")
    sub.add_parser("chaos", add_help=False,
                   help="the randomized differential soak in chaos mode "
                        "(tools/soak.py --chaos; every further option passes "
                        "through): --configs, --jobs, --liveness, --device")
    sub.add_parser("serve", add_help=False,
                   help="the always-on consensus service over HTTP "
                        "(serve/server.py; every further option passes "
                        "through, see serve --help): --backend, --device, "
                        "--kernel fused|step|plain (plain: the compacted "
                        "lane grid), --wal DIR, --recover DIR; the fleet "
                        "options are refused by name")
    sub.add_parser("hunt", add_help=False,
                   help="the adversary hunter over the server (hunt/hunter.py; "
                        "every further option passes through, see hunt "
                        "--help): --strategy, --budget, --seed, --device, "
                        "--kernel plain (the lane leg), --url, "
                        "--committee-scale")
    return ap


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    # the tools with options of their own, dispatched before argparse
    if argv and argv[0] == "serve":
        from byzantinerandomizedconsensus_tpu_torch.serve import server

        return server.main(argv[1:])
    if argv and argv[0] == "loadgen":
        from byzantinerandomizedconsensus_tpu_torch.tools import loadgen

        return loadgen.main(argv[1:])
    if argv and argv[0] == "chaos":
        from byzantinerandomizedconsensus_tpu_torch.tools import soak

        return soak.main(["--chaos", *argv[1:]])
    if argv and argv[0] == "hunt":
        from byzantinerandomizedconsensus_tpu_torch.hunt import hunter

        return hunter.main(argv[1:])
    if argv and argv[0] == "product":
        from byzantinerandomizedconsensus_tpu_torch.tools import product

        return product.main(argv[1:])
    if argv and argv[0] == "trace":
        from byzantinerandomizedconsensus_tpu_torch.tools import trace

        return trace.main(argv[1:])
    if argv and argv[0] == "programs":
        from byzantinerandomizedconsensus_tpu_torch.tools import programs

        return programs.main(argv[1:])
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
