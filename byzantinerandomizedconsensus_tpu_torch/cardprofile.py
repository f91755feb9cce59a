"""Where the time of a run goes on the card: a ``torch.profiler`` trace of
runs through the torch backend, reduced to the device's busy share of the
runs' window and its time by kernel name (``cli profile``). ``cli trace``
is the reference's telemetry tool (``tools/trace.py``), over the host-side
spans of ``obs/trace.py``."""

from __future__ import annotations

import collections
import json
import pathlib
import subprocess

import torch

#: Trace categories of work on the device: kernels, copies and fills.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "brc/run"


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def busy_share(events, lo: float, hi: float) -> float:
    """The share of [lo, hi] covered by the union of the events' intervals
    (``ts`` and ``dur`` as in a Chrome trace)."""
    spans = sorted((max(lo, e["ts"]), min(hi, e["ts"] + e["dur"])) for e in events)
    busy, end = 0.0, lo
    for a, b in spans:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy / (hi - lo)


def summarize(events, runs: int) -> dict:
    """The numbers of a trace holding ``runs + 1`` runs marked ``MARK``; the
    first run, which absorbs the profiler's start-up, is left out."""
    marks = sorted((e for e in events if e.get("name") == MARK
                    and e.get("cat") == "user_annotation"), key=lambda e: e["ts"])[1:]
    if len(marks) != runs:
        raise RuntimeError(f"the trace holds {len(marks)} of {runs} runs")
    lo = min(e["ts"] for e in marks)
    hi = max(e["ts"] + e["dur"] for e in marks)
    inside = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e
              and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    if not inside:
        raise RuntimeError("the trace holds no device event: the profiler did not "
                           "trace the card")
    by_name = collections.Counter()
    for e in inside:
        by_name[e["name"][:60]] += e["dur"]
    busy = busy_share(inside, lo, hi)
    return {
        "host_ms_per_run": [e["dur"] / 1e3 for e in marks],
        "device_busy": busy, "device_idle": 1 - busy,
        "device_events_per_run": len(inside) / runs,
        "device_ms_per_run_by_name": {k: v / runs / 1e3 for k, v in by_name.most_common(6)},
    }


def trace_runs(backend, cfg, runs: int, path: pathlib.Path) -> dict:
    """One warm-up run of ``cfg``, then ``runs + 1`` traced runs; writes the
    Chrome trace to ``path`` and returns :func:`summarize` of it."""
    backend.prepare(cfg)
    backend.run(cfg)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(runs + 1):
            with torch.profiler.record_function(MARK):
                backend.run(cfg)
    prof.export_chrome_trace(str(path))
    return summarize(json.loads(path.read_text())["traceEvents"], runs)
