"""Round and decision histograms and the run summary.

The port's copy of the reference ``utils/metrics.py``. Histograms derive
from the per-instance ``(rounds, decision)`` arrays, the bit-match surface,
and keep the overflow bucket: ``decision == 2`` marks undecided at the cap,
and such instances sit in the ``rounds == round_cap`` bin.
"""

from __future__ import annotations

import json
import math

import numpy as np

from byzantinerandomizedconsensus_tpu_torch.backends.base import SimResult


def round_histogram(res: SimResult) -> np.ndarray:
    """(round_cap + 1,) int64 — index r counts instances that terminated in r
    rounds (index 0 unused); capped instances sit in the last bin."""
    return np.bincount(res.rounds, minlength=res.config.round_cap + 1).astype(np.int64)


def decision_histogram(res: SimResult) -> np.ndarray:
    """(3,) int64 — counts of decisions 0, 1 and 2 (undecided at the cap)."""
    return np.bincount(res.decision, minlength=3).astype(np.int64)


def percentiles(values, qs=(50, 90, 99)) -> list:
    """Exact nearest-rank percentiles, one per ``q`` in ``qs`` (percent,
    0 < q <= 100): the ceil(q·N/100)-th smallest element, so each is an
    element of ``values``. Empty input maps every q to None."""
    vals = sorted(np.asarray(values).ravel().tolist())
    n = len(vals)
    out = []
    for q in qs:
        if not (0 < q <= 100):
            raise ValueError(f"percentile {q} out of range (0, 100]")
        out.append(vals[max(1, math.ceil(q * n / 100.0)) - 1] if n else None)
    return out


def mean_max_rounds_per_chunk(rounds: np.ndarray, chunk: int) -> float | None:
    """Mean over consecutive ``chunk``-sized windows of the window's max
    rounds: every instance of a chunk pays the chunk's max rounds."""
    rounds = np.asarray(rounds)
    if chunk < 1:
        raise ValueError(f"chunk={chunk} out of range (>= 1)")
    if rounds.size == 0:
        return None
    return float(np.mean([rounds[lo:lo + chunk].max()
                          for lo in range(0, len(rounds), chunk)]))


def wasted_lane_fraction(rounds: np.ndarray, chunk: int) -> float | None:
    """``1 − Σ per-instance rounds / Σ chunk cost``, a chunk costing its max
    rounds × the full chunk width (the tail chunk is padded to full width):
    the share of lane-rounds spent on instances that had already decided."""
    rounds = np.asarray(rounds)
    if chunk < 1:
        raise ValueError(f"chunk={chunk} out of range (>= 1)")
    if rounds.size == 0:
        return None
    device = sum(int(rounds[lo:lo + chunk].max()) * chunk
                 for lo in range(0, len(rounds), chunk))
    if device == 0:
        return 0.0
    return float(round(1.0 - int(rounds.sum()) / device, 6))


def summary(res: SimResult, walls=None, device=None, chunk=None) -> dict:
    """The reference's run summary: did it decide (``decided_fraction``),
    in how many rounds, and how fast on the clock.

    ``walls``, the timed-run list of ``utils/timing.timed_best_of``, adds
    the best wall, the full ``walls_s`` and their spread, and recomputes
    ``instances_per_sec`` from the unrounded best. ``device``, the
    ``utils/timing.device_busy`` dict, adds ``device_busy_s`` or its
    ``device_busy_error`` (an absence of signal is an error, never a 0.0
    measurement). Both through ``obs/record.timing_block``, the one shape.
    ``chunk``, the backend's instances per call, adds the straggler
    metrics."""
    cfg = res.config
    decided = res.decision != 2
    dh = decision_histogram(res)
    n_inst = int(len(res.inst_ids))
    out = {
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
                   percentiles(res.rounds, (50, 90, 99)))),
        "decision_histogram": dh.tolist(),
        "wall_s": res.wall_s,
        "instances_per_sec": res.instances_per_sec if res.wall_s else None,
    }
    if chunk is not None:
        out["chunk"] = int(chunk)
        out["wasted_lane_fraction"] = wasted_lane_fraction(res.rounds, chunk)
        out["mean_max_rounds_per_chunk"] = mean_max_rounds_per_chunk(res.rounds, chunk)
    if walls is not None or device is not None:
        from byzantinerandomizedconsensus_tpu_torch.obs import record

        out.update(record.timing_block(walls or [res.wall_s], device))
        if walls:
            out["instances_per_sec"] = round(n_inst / min(walls), 1)
    return out


def dump_summary(res: SimResult) -> str:
    return json.dumps(summary(res))
