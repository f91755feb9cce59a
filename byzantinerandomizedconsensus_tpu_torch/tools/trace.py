"""``cli trace``: the consumers of the host-side telemetry JSONL
(``obs/trace.py``).

The port's copy of the reference ``tools/trace.py``, with its four verbs:

- ``export --chrome SRC [--out FILE]``: a trace JSONL file (or a trace
  directory: its merged ``trace.jsonl``, else all per-worker files) as
  Chrome trace-event JSON, for Perfetto next to a ``torch.profiler`` trace
  of the card (``cli run --profile``): host orchestration and kernels on
  one screen;
- ``summary SRC [--json FILE] [--top N]``: the per-span-kind
  count/total/p50/p90/p99 digest (``obs/trace.py::digest``) as a table;
- ``follow DIR [--interval S] [--once] [--metrics-url URL]``: tail a live
  trace directory (``cli chaos --trace DIR``, or a fleet's per-worker
  files), one status line per tick;
- ``overhead``: the inertness measurement: the seeded chaos grid
  (``tools/bench_batch.py::chaos_grid``) through the fused lanes
  (``backends/batch.py::run_fused``, the plain round driver on the card),
  traced against untraced after an untraced warm-up, results
  bit-compared. The legs are paired bucket by bucket
  (:func:`interleaved_ab`), each leg's wall the sum of its buckets' best of
  N, and the verdict is the reference's: traced wall / untraced wall - 1.
  Where a leg's own walls spread wider than the bound across repeats, as
  the lanes' do on the card, the record says the ratio is not resolved (:func:`overhead_of`); writes a run record (kind ``trace_bench``, with its ``trace`` block) and
  exits 0 iff the traced run was bit-same and its overhead is within
  :data:`OVERHEAD_BOUND`. On the card unless ``--device cpu``; a missing
  card exits 2 by name.

    python -m byzantinerandomizedconsensus_tpu_torch.cli trace overhead --configs 40
    python -m byzantinerandomizedconsensus_tpu_torch.cli trace summary trace.jsonl --top 5
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import re
import sys
import time

from byzantinerandomizedconsensus_tpu_torch.obs import trace as _trace

#: The bound on tracing overhead over the seeded chaos grid: traced wall /
#: untraced wall - 1 must stay within this.
OVERHEAD_BOUND = 0.02
#: The port's own records, apart from the reference's ``artifacts/*_r*.json``.
RECORD_DIR = "artifacts/port"


def _events_of(src) -> list:
    """Events of a trace JSONL file, or of a directory (its merged
    ``trace.jsonl``, else the per-worker files in time order)."""
    p = pathlib.Path(src)
    if p.is_dir():
        merged = p / "trace.jsonl"
        if merged.exists():
            return _trace.read_events(merged)
        events = []
        for f in sorted(p.glob("trace-*.jsonl")):
            events.extend(_trace.read_events(f))
        events.sort(key=lambda e: e.get("ts", 0.0))
        return events
    return _trace.read_events(p)


def cmd_export(args) -> int:
    try:
        events = _events_of(args.src)
    except OSError as e:
        print(f"cannot read trace {args.src!r}: {e}", file=sys.stderr)
        return 2
    if not args.chrome:
        print("export currently supports --chrome only", file=sys.stderr)
        return 2
    src = pathlib.Path(args.src)
    out = pathlib.Path(args.out) if args.out else (
        src / "trace.chrome.json" if src.is_dir() else src.with_suffix(".chrome.json"))
    _trace.write_chrome(events, out)
    print(json.dumps({"out": str(out), "events": len(events)}))
    return 0


def cmd_summary(args) -> int:
    try:
        events = _events_of(args.src)
    except OSError as e:
        print(f"cannot read trace {args.src!r}: {e}", file=sys.stderr)
        return 2
    dg = _trace.digest(events)
    problems = _trace.validate_events(events)
    lines = [f"trace summary — {len(events)} events, "
             f"{len(dg)} kinds, {len(problems)} problems"]
    items = list(dg.items())
    dropped = 0
    if args.top is not None:
        # The kinds that cost the most wall first (count-only instants
        # last), truncated to N: where the run went.
        items.sort(key=lambda kv: (-kv[1]["total_s"], kv[0]))
        dropped = max(0, len(items) - args.top)
        items = items[:args.top]
    for kind, entry in items:
        if "p50_s" in entry:
            lines.append(
                f"  {kind}: {entry['count']} spans, "
                f"total {entry['total_s']} s, p50 {entry['p50_s']} s, "
                f"p90 {entry['p90_s']} s, p99 {entry['p99_s']} s")
        else:
            lines.append(f"  {kind}: {entry['count']} events")
    if dropped:
        lines.append(f"  ... {dropped} more kind(s) below the top "
                     f"{args.top} (by total wall)")
    for p in problems:
        lines.append(f"  PROBLEM: {p}")
    print("\n".join(lines))
    if args.json:
        out = pathlib.Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"events": len(events), "digest": dg,
                                   "problems": problems}, indent=1) + "\n")
    return 1 if problems else 0


# ---------------------------------------------------------------------------
# follow: a live tail of a trace directory


#: The fleet workers' trace files (serve/worker.py configures role
#: ``fleet-w<i>``, so obs/trace.py writes ``trace-fleet-w<i>.jsonl``): the
#: heartbeat attributes replies to workers by file name.
_FLEET_FILE_RE = re.compile(r"trace-fleet-(w\d+)\.jsonl$")


def _fleet_worker_of(src):
    if not src:
        return None
    m = _FLEET_FILE_RE.search(str(src))
    return m.group(1) if m else None


def _follow_consume(state: dict, ev: dict, src=None) -> None:
    """Fold one event into the follow aggregate; ``src``, the sink's file
    name, attributes a fleet worker's serve events to it."""
    state["events"] += 1
    kind = ev.get("kind", "")
    attrs = ev.get("attrs") or {}
    if kind == "chaos.progress":
        state["progress"] = attrs
    elif kind == "chaos.start":
        state["total"] = attrs.get("configs")
    elif kind == "compile_cache.compile":
        state["compiles"] += 1
    elif kind in ("compaction.segment", "compaction.drain"):
        state["queue"] = attrs.get("queued")
        state["live"] = attrs.get("live")
    elif kind == "chaos.skip":
        state["skips"] += 1
    elif kind == "serve.request":
        # The server's liveness: every admitted request shows admission moving.
        state["serve_requests"] += 1
        w = _fleet_worker_of(src)
        if w is not None:
            state.setdefault("fleet", {}).setdefault(w, 0)
    elif kind == "serve.reply":
        state["serve_replies"] += 1
        w = _fleet_worker_of(src)
        if w is not None:
            fleet = state.setdefault("fleet", {})
            fleet[w] = fleet.get(w, 0) + 1


def _follow_render(state: dict) -> str:
    p = state.get("progress") or {}
    done = p.get("done", 0)
    total = p.get("total", state.get("total", "?"))
    parts = [f"{state['events']} events",
             f"configs {done}/{total}",
             f"mismatches {p.get('mismatches', 0)}",
             f"violations {p.get('violations', 0)}",
             f"skipped {p.get('skipped', state['skips'])}",
             f"compiles {state['compiles']}"]
    if state.get("queue") is not None:
        parts.append(f"queue {state['queue']} (live {state.get('live')})")
    if state.get("fleet"):
        per = " ".join(f"{w}:{n}" for w, n in sorted(
            state["fleet"].items(), key=lambda kv: int(kv[0][1:])))
        parts.append(f"fleet {state['serve_replies']}/"
                     f"{state['serve_requests']} replied ({per})")
    elif state.get("serve_requests"):
        parts.append(f"serve {state['serve_replies']}/"
                     f"{state['serve_requests']} replied")
    return "[trace] " + " | ".join(parts)


def _metrics_heartbeat(metrics_url) -> str:
    """The live-metrics suffix of a follow tick: the scraped p99 and decided
    fraction when a ``/metrics`` endpoint answers, else ''."""
    if not metrics_url:
        return ""
    from byzantinerandomizedconsensus_tpu_torch.obs import metrics as _metrics

    url = str(metrics_url).rstrip("/")
    if not url.endswith("/metrics"):
        url += "/metrics"
    snap = _metrics.scrape(url)
    if snap is None:
        return ""
    s = _metrics.summary(snap)
    parts = []
    if s["p99_latency_ms"] is not None:
        parts.append(f"p99 {s['p99_latency_ms']}ms")
    if s["decided_fraction"] is not None:
        parts.append(f"decided {s['decided_fraction']}")
    return " | live " + " ".join(parts) if parts else ""


def follow(trace_dir, interval: float = 2.0, once: bool = False,
           out=print, max_ticks=None, metrics_url=None) -> dict:
    """Tail every ``trace-*.jsonl`` in ``trace_dir``: a byte offset per file,
    complete lines only, one status line per tick. ``once`` and
    ``max_ticks`` bound the loop; ``metrics_url`` appends the live p99 and
    decided fraction of a serving endpoint's ``/metrics``. Returns the
    final aggregate."""
    trace_dir = pathlib.Path(trace_dir)
    offsets: dict = {}
    state = {"events": 0, "compiles": 0, "skips": 0, "progress": None,
             "queue": None, "live": None, "total": None,
             "serve_requests": 0, "serve_replies": 0, "fleet": {}}
    ticks = 0
    while True:
        # Per-worker files only: a merged trace.jsonl repeats their events.
        for p in sorted(trace_dir.glob("trace-*.jsonl")):
            off = offsets.get(p, 0)
            try:
                with open(p, "rb") as fh:
                    fh.seek(off)
                    data = fh.read()
            except OSError:
                continue
            end = data.rfind(b"\n") + 1
            if end <= 0:
                continue
            offsets[p] = off + end
            for line in data[:end].splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue  # a torn line: the next tick reads it whole
                _follow_consume(state, ev, src=p.name)
        out(_follow_render(state) + _metrics_heartbeat(metrics_url))
        ticks += 1
        if once or (max_ticks is not None and ticks >= max_ticks):
            return state
        done = (state.get("progress") or {}).get("done")
        total = state.get("total")
        if done is not None and total is not None and done >= total:
            return state
        time.sleep(interval)


def cmd_follow(args) -> int:
    follow(args.src, interval=args.interval, once=args.once,
           metrics_url=args.metrics_url)
    return 0


# ---------------------------------------------------------------------------
# overhead: the inertness measurement


def results_equal(a, b) -> bool:
    import numpy as np

    return all(np.array_equal(x.rounds, y.rounds) and np.array_equal(x.decision, y.decision)
               for x, y in zip(a, b))


def lane_backend(device: str):
    """The plain round driver on ``device`` (the lanes' kernel), or
    ``None`` after naming a missing card on stderr."""
    from byzantinerandomizedconsensus_tpu_torch.backends import get_backend

    try:
        return get_backend("torch", device=device, kernel="plain")
    except RuntimeError as e:
        print(f"{e}", file=sys.stderr)
        return None


def timed(fn):
    """``(wall_s, out)`` of ``fn()``, closed after the card has finished."""
    import torch

    gc.collect()
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def bucket_groups(cfgs) -> list:
    """``[(bucket label, indices)]`` of ``cfgs`` by fused bucket
    (``backends/batch.py::FusedBucket``), in first-seen order."""
    from byzantinerandomizedconsensus_tpu_torch.backends.batch import FusedBucket

    groups: dict = {}
    for i, cfg in enumerate(cfgs):
        groups.setdefault(FusedBucket.of(cfg.validate()).label(), []).append(i)
    return list(groups.items())


def interleaved_ab(cfgs, legs: dict, repeats: int) -> tuple:
    """Time the legs of an A/B on the grid ``cfgs``, paired bucket by
    bucket: each fused bucket's configs run once untimed through the first
    leg (the warm-up; its results are the baseline), then ``repeats`` times
    through every leg in turn (``legs[name](configs)`` returns their
    results), the leg that goes first alternating from repeat to repeat and
    bucket to bucket, so a leg's runs of a bucket lie next to the other
    leg's and a drift of the host's speed falls on both alike. Returns
    ``(walls, best, buckets, baseline, same)``: ``{name: [its wall in each
    repeat]}``; ``{name: the sum over buckets of the bucket's best wall}``,
    the walls the verdict compares, as the reference compares best-of-N
    walls; ``[(bucket label, {name: [its walls]})]``; the warm-up's results
    per config; and whether every timed run equalled them bit for bit. Each
    leg runs the whole grid once a repeat, as one ``run_fused`` of it does
    (the lanes group by bucket)."""
    names = list(legs)
    groups = bucket_groups(cfgs)
    per = {n: [[] for _ in groups] for n in names}
    baseline = [None] * len(cfgs)
    same = True
    for k, (_, idxs) in enumerate(groups):
        sub = [cfgs[i] for i in idxs]
        for i, r in zip(idxs, legs[names[0]](sub)):
            baseline[i] = r
        for rep in range(repeats):
            for n in (names if (rep + k) % 2 == 0 else names[::-1]):
                wall, res = timed(lambda: legs[n](sub))
                per[n][k].append(wall)
                same = same and results_equal([baseline[i] for i in idxs], res)
    walls = {n: [round(sum(b[r] for b in per[n]), 6) for r in range(repeats)] for n in names}
    best = {n: round(sum(min(b) for b in per[n]), 6) for n in names}
    buckets = [(label, {n: [round(w, 6) for w in per[n][k]] for n in names})
               for k, (label, _) in enumerate(groups)]
    return walls, best, buckets, baseline, same


def overhead_of(walls: dict, best: dict, on: str, off: str,
                bound: float = OVERHEAD_BOUND) -> dict:
    """The A/B's verdict fields. ``overhead_fraction`` is the reference's
    verdict: the on leg's best wall over the off leg's, less one (None
    without an off wall); the exit code reads it alone. ``wall_spread`` is
    the wider of the two legs' own spreads across repeats
    (``utils/timing.spread``): where it is wider than ``bound`` the walls
    cannot resolve the bound, and ``resolved`` is false, so a ratio within
    the bound is not a resolved pass, nor one over it a resolved failure."""
    from byzantinerandomizedconsensus_tpu_torch.utils.timing import spread

    noise = round(max(spread(walls[on]), spread(walls[off])), 4)
    return {"overhead_fraction": round(best[on] / best[off] - 1.0, 4) if best[off] else None,
            "wall_spread": noise, "resolved": noise <= bound}


def print_ab(walls: dict, buckets: list, same: bool) -> None:
    """Each repeat's walls and each bucket's, one line each."""
    names = list(walls)
    for rep in range(len(walls[names[0]])):
        print(f"repeat {rep}: " + ", ".join(f"{n} {walls[n][rep]:.3f} s" for n in names)
              + f", bit_identical={same}", flush=True)
    for label, legs in buckets:
        print(f"  bucket {label}: " + ", ".join(f"{n} {legs[n]} s" for n in names),
              flush=True)


def cmd_overhead(args) -> int:
    from byzantinerandomizedconsensus_tpu_torch.backends.compaction import CompactionPolicy
    from byzantinerandomizedconsensus_tpu_torch.obs import record
    from byzantinerandomizedconsensus_tpu_torch.tools import bench_batch, sampler

    be = lane_backend(args.device)
    if be is None:
        return 2
    cfgs = bench_batch.chaos_grid(args.configs, args.seed)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    trace_path = out.with_suffix(".jsonl")
    trace_path.unlink(missing_ok=True)

    print(f"the fused grid of {len(cfgs)} configs on {be.device}: a warm-up, then traced "
          f"and untraced in turns, bucket by bucket...", flush=True)

    def traced(sub):
        _trace.configure(path=trace_path)
        try:
            return be.run_fused(sub)[0]
        finally:
            _trace.disable()

    walls, best, buckets, baseline, same = interleaved_ab(
        cfgs, {"untraced": lambda sub: be.run_fused(sub)[0], "traced": traced},
        args.repeats)
    print_ab(walls, buckets, same)

    # An untimed compacted sample, so the trace holds the compacted grid's
    # segment, refill and drain spans too.
    sample = cfgs[:args.compacted_sample]
    _trace.configure(path=trace_path)
    res_comp, _ = be.run_fused(sample, compaction=CompactionPolicy(width=64, segment=1))
    _trace.disable()
    same = same and results_equal(baseline[:len(sample)], res_comp)

    verdict = overhead_of(walls, best, "traced", "untraced")
    overhead = verdict["overhead_fraction"]
    doc = {
        **record.new_record("trace_bench"),
        "description": "host-side telemetry overhead A/B on the seeded chaos grid: "
                       "fused lanes (the plain round driver) traced vs untraced after a "
                       "warm-up, the legs taking turns bucket by bucket, each leg's wall "
                       "the sum of its buckets' best, results bit-compared (tools/trace.py "
                       "overhead)",
        "generator_version": sampler.GENERATOR_VERSION,
        "seed": args.seed,
        "configs": args.configs,
        "repeats": args.repeats,
        "device": str(be.device),
        "legs": {leg: {"walls_s": walls[leg], "wall_s": best[leg]}
                 for leg in ("untraced", "traced")},
        **verdict,
        "overhead_bound": OVERHEAD_BOUND,
        "bit_identical": bool(same),
        "compacted_sample_configs": len(sample),
        "compile_cache": record.compile_cache_block(be),
        "device_chain_note": (
            "wall-only A/B of host-side instrumentation; the walls are the lanes' "
            "(torch ops on the device named), no kernel time is claimed"),
        "trace": record.trace_block(trace_path),
    }
    out.write_text(json.dumps(doc, indent=1) + "\n")
    print(json.dumps({"out": str(out), **verdict, "bit_identical": doc["bit_identical"],
                      "trace_events": (doc["trace"] or {}).get("events")}))
    ok = (same and overhead is not None and overhead <= OVERHEAD_BOUND
          and doc["trace"] is not None)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cli trace", description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_ex = sub.add_parser("export", help="trace JSONL as Chrome trace-event JSON "
                                         "(Perfetto)")
    p_ex.add_argument("src", help="trace JSONL file or trace directory")
    p_ex.add_argument("--chrome", action="store_true",
                      help="Chrome trace-event format (the only format yet)")
    p_ex.add_argument("--out", default=None)
    p_ex.set_defaults(fn=cmd_export)

    p_su = sub.add_parser("summary", help="per-span-kind count/total/p50/p90/p99 digest")
    p_su.add_argument("src", help="trace JSONL file or trace directory")
    p_su.add_argument("--json", default=None, metavar="FILE")
    p_su.add_argument("--top", type=int, default=None, metavar="N",
                      help="rank kinds by total span wall and show the top N "
                           "(default: every kind, alphabetical)")
    p_su.set_defaults(fn=cmd_summary)

    p_fo = sub.add_parser("follow", help="tail a live trace directory (chaos --trace DIR)")
    p_fo.add_argument("src", help="trace directory being written")
    p_fo.add_argument("--interval", type=float, default=2.0)
    p_fo.add_argument("--once", action="store_true",
                      help="one pass and one status line, then exit")
    p_fo.add_argument("--metrics-url", default=None,
                      help="a serving endpoint's base URL (or its /metrics URL): "
                           "appends the live p99 and decided fraction to each line")
    p_fo.set_defaults(fn=cmd_follow)

    p_ov = sub.add_parser("overhead", help="traced-vs-untraced A/B on the seeded chaos "
                                           "grid through the fused lanes")
    p_ov.add_argument("--configs", type=int, default=280)
    p_ov.add_argument("--seed", type=int, default=0)
    p_ov.add_argument("--repeats", type=int, default=3)
    p_ov.add_argument("--compacted-sample", type=int, default=40,
                      help="configs for the untimed compacted trace leg")
    p_ov.add_argument("--device", default="cuda",
                      help="cuda (default; exits 2 with no card) or cpu")
    from byzantinerandomizedconsensus_tpu_torch.utils.rounds import default_artifact

    p_ov.add_argument("--out", default=default_artifact("trace", subdir=RECORD_DIR))
    p_ov.set_defaults(fn=cmd_overhead)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
