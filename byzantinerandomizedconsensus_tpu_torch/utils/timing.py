"""Shared wall-clock methodology for timed runs and their records.

The port's counterpart of the reference ``utils/timing.py``, on the card:

- build and warm up OUTSIDE the timed window: one run at the exact chunk
  shape the timed run uses, only for a backend on the card
  (:func:`needs_warmup`); the host paths (the plain driver on the CPU, the
  arbiters) have nothing to build;
- best of N timed full runs, N = 5 by default, each wall closed after the
  card has finished (``torch.cuda.synchronize``), with the full list kept
  so the best and the spread are both on the record;
- rates from the unrounded minimum;
- a **device-busy** leg beside the walls: the summed device time of the
  CUDA kernels of one run, read from a ``torch.profiler`` Chrome trace
  (:func:`device_busy`), and :func:`regression_verdict`, which says which
  of the two a regression claim may key on. The arithmetic of the verdict
  and the spread is the reference's.
"""

from __future__ import annotations

import gzip
import json
import pathlib
import time

import numpy as np

DEFAULT_REPEATS = 5

# Above this (max-min)/min wall spread, a wall-based vs_prev_round is
# uninformative for sub-second runs, and a regression verdict keys on the
# device-busy time instead.
NOISY_WALLS_SPREAD = 0.3

# The explain-or-noise bound on the authoritative ratio: |ratio - 1| above
# it is a change that must be explained.
REGRESSION_THRESHOLD = 0.15

#: The Chrome-trace categories of work on the device, and the one whose
#: summed time is the device-busy leg.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
KERNEL_CAT = "kernel"
#: The span :func:`device_busy` opens around its run: kernels inside it count.
BUSY_MARK = "brc/device_busy"
TRACE_GLOB = "*.pt.trace.json*"


def _on_card(be) -> bool:
    device = getattr(be, "device", None)
    return device is not None and getattr(device, "type", None) == "cuda"


def needs_warmup(be) -> bool:
    """True for a backend on the card: its first run loads (or builds) the
    kernel library and sets up the CUDA context."""
    return _on_card(be)


def _sync(be) -> None:
    if _on_card(be):
        import torch

        torch.cuda.synchronize(be.device)


def timed_best_of(be, cfg, repeats: int = DEFAULT_REPEATS):
    """(result, walls) — ``repeats`` timed full runs of ``cfg`` after a
    warm-up run at the exact chunk shape of the run (on the card only)."""
    if needs_warmup(be):
        chunk = min(be.chunk_size(cfg), cfg.instances)
        be.run(cfg, np.arange(chunk, dtype=np.int64))
        _sync(be)
    walls, res = [], None
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        res = be.run(cfg)
        _sync(be)
        walls.append(time.perf_counter() - t0)
    return res, walls


def spread(walls) -> float:
    """(max-min)/min of a timed-run list — the dispersion recorded next to
    the best-of figure."""
    w = sorted(walls)
    return (w[-1] - w[0]) / w[0] if w and w[0] > 0 else 0.0


def trace_snapshot(trace_dir) -> dict:
    """{path: (mtime_ns, size)} of every trace file under ``trace_dir``,
    taken *before* a capture so :func:`parse_trace` can tell this run's
    output from leftovers in a reused directory (an overwrite landing in
    the same mtime quantum still counts as fresh when its size changed)."""
    d = pathlib.Path(trace_dir)
    if not d.exists():
        return {}
    return {p: (p.stat().st_mtime_ns, p.stat().st_size) for p in d.rglob(TRACE_GLOB)}


def _load_trace(path: pathlib.Path) -> dict:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as fh:
        return json.load(fh)


def parse_trace(trace_dir, before: dict | None = None) -> dict:
    """Device busy time and the top device operations from the newest
    ``torch.profiler`` Chrome trace under ``trace_dir`` that this run
    produced (a new path, or one whose (mtime_ns, size) changed against the
    ``before`` snapshot); a capture that produced none is an error, never a
    reparse of a stale trace. ``device_busy_s`` sums the CUDA kernel events
    (category ``kernel``) inside the :data:`BUSY_MARK` span when the trace
    has one, else all of them; copies and fills count in the per-op table
    only."""
    import collections

    before = before or {}
    paths = sorted(
        (p for p in pathlib.Path(trace_dir).rglob(TRACE_GLOB)
         if p not in before or (p.stat().st_mtime_ns, p.stat().st_size) != before[p]),
        key=lambda p: p.stat().st_mtime_ns)
    if not paths:
        return {"error": "no new trace produced by this run"}
    ev = _load_trace(paths[-1]).get("traceEvents", [])
    gpu_pids = {e.get("pid") for e in ev
                if e.get("ph") == "M" and e.get("name") == "process_name"
                and "GPU" in str(e.get("args", {}).get("name", ""))}
    marks = [e for e in ev if e.get("ph") == "X" and e.get("name") == BUSY_MARK]
    lo = min((e["ts"] for e in marks), default=None)
    hi = max((e["ts"] + e.get("dur", 0) for e in marks), default=None)
    per_op = collections.Counter()
    busy = 0.0
    n_dev_events = 0
    for e in ev:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        gpu_pids.add(e.get("pid"))
        if lo is not None and not (e["ts"] < hi and e["ts"] + e.get("dur", 0) > lo):
            continue
        n_dev_events += 1
        per_op[e.get("name", "?")[:80]] += e.get("dur", 0)
        if e["cat"] == KERNEL_CAT:
            busy += e.get("dur", 0)
    out = {
        "source": str(paths[-1]),
        "device_busy_s": round(busy / 1e6, 6),
        "top_device_ops_s": {k: round(v / 1e6, 6) for k, v in per_op.most_common(8)},
    }
    if busy == 0.0:
        # A zero is an absence of signal unless shown otherwise: say which
        # of the three ways it can be absent, so a record says why and
        # regression_verdict's > 0 guard refuses the ratio.
        if not gpu_pids:
            out["device_busy_suspect"] = (
                "no CUDA device in the trace (a CPU-only session?) — "
                "device_busy_s is NOT a measurement")
        elif n_dev_events:
            out["device_busy_suspect"] = (
                f"{n_dev_events} device events but 0 '{KERNEL_CAT}' events — "
                "device_busy_s is NOT a measurement")
        else:
            out["device_busy_suspect"] = (
                "CUDA device in the trace but zero device events in the window "
                "— an empty capture? device_busy_s is NOT a measurement")
    return out


def device_busy(be, cfg, trace_dir=None) -> dict:
    """Profiler-measured device-busy time of one warmed full run of
    ``cfg``: the run under ``torch.profiler`` (:mod:`utils.profiling`), its
    CUDA kernels' summed time. Call after :func:`timed_best_of`, so the
    library is loaded. Returns ``{"device_busy_s": ...}`` or
    ``{"error": ...}``: a backend off the card and a failed capture degrade
    to an error entry, never raise."""
    if not _on_card(be):
        return {"error": f"backend {getattr(be, 'name', type(be).__name__)!r} runs "
                         "on host; no device trace"}
    import contextlib
    import tempfile

    from byzantinerandomizedconsensus_tpu_torch.utils import profiling

    cleanup = contextlib.nullcontext(trace_dir) if trace_dir \
        else tempfile.TemporaryDirectory(prefix="device_busy_")
    try:
        with cleanup as tdir:
            before = trace_snapshot(tdir)
            with profiling.trace(tdir):
                with profiling.annotate(BUSY_MARK):
                    be.run(cfg)
                    _sync(be)
            out = parse_trace(tdir, before=before)
        out.pop("top_device_ops_s", None)  # records stay small
        if not trace_dir:
            # the temporary directory is gone: no dangling path in a record
            out.pop("source", None)
        return out
    except Exception as e:  # noqa: BLE001 — a profiler failure is a record entry
        return {"error": repr(e)}


def regression_verdict(walls, prev_wall_rate=None, rate=None,
                       device_busy_s=None, prev_device_busy_s=None) -> dict:
    """Machine-readable explain-or-noise record: when the wall spread
    exceeds :data:`NOISY_WALLS_SPREAD`, a wall-based ``vs_prev_round`` is
    uninformative and the signal is the device-busy ratio (when both runs
    have one); otherwise the wall ratio stands. ``regression_signal`` names
    the authoritative field."""
    sp = spread(walls)
    out = {"walls_spread": round(sp, 3)}
    if rate is not None and prev_wall_rate:
        out["vs_prev_round"] = round(rate / prev_wall_rate, 3)
    # Strictly positive, not truthy: a tiny device leg rounds to 0.0.
    if (device_busy_s or 0) > 0 and (prev_device_busy_s or 0) > 0:
        # oriented like the wall ratio: > 1 = faster than the previous run
        out["vs_prev_round_device"] = round(prev_device_busy_s / device_busy_s, 3)
    if sp > NOISY_WALLS_SPREAD:
        out["regression_signal"] = (
            "vs_prev_round_device" if "vs_prev_round_device" in out
            else "none: walls too noisy "
                 f"(spread {sp:.2f} > {NOISY_WALLS_SPREAD}) and no device-busy "
                 "comparison available")
    elif "vs_prev_round" in out:
        out["regression_signal"] = "vs_prev_round"
    return out
