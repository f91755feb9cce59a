"""The config-5 sweep (spec §7): n in {128, …, 1024}, f = (n−1)//3, Bracha
under the adaptive adversary with a shared coin; the round distribution per
n is the artifact.

The port's copy of the reference ``utils/sweep.py``. Resumable through
checkpoint shards (``utils/checkpoint.py``) per (n, instance range), so an
interrupted point restarts at its first missing shard, not at 0; the shard
files are the reference's, so a sweep resumes from the reference's own.
"""

from __future__ import annotations

import dataclasses
import pathlib
import re
import time
from typing import Iterable

import numpy as np

from byzantinerandomizedconsensus_tpu_torch.backends.base import SimResult, get_backend
from byzantinerandomizedconsensus_tpu_torch.config import (
    DEFAULT_ROUND_CAP, PRODUCT_DELIVERY, SWEEP_INSTANCES, SWEEP_NS, sweep_point)
from byzantinerandomizedconsensus_tpu_torch.ops import prf
from byzantinerandomizedconsensus_tpu_torch.utils import checkpoint, metrics


def run_sweep(
    out_dir: pathlib.Path,
    backend: str = "torch",
    ns: Iterable[int] = SWEEP_NS,
    instances: int = SWEEP_INSTANCES,
    seed: int = 0,
    shard_instances: int = 500,
    coin: str = "shared",
    delivery: str = PRODUCT_DELIVERY,
    round_cap: int | None = None,
    batched: bool = False,
    progress=print,
    **options,
) -> dict:
    """Run (or resume) the sweep; returns ``{n: summary with its
    round_histogram}``. ``options`` go to the backend (``device``,
    ``kernel``): the ``torch`` backend runs on the card unless asked for the
    CPU.

    ``batched`` runs each shard row through the lane runner
    (``backends/batch.py::run_many``) when the backend has it: sweep points
    whose n pads to one tier share one lane program and one dispatch per
    shard, bit-identically. The lanes run ``kernel="plain"`` only, and
    refuse any other kernel by name. Shards stay per (n, instance range); a
    batched shard's recorded wall is the dispatch wall split evenly across
    its lanes."""
    be = get_backend(backend, **options)
    eff_cap = DEFAULT_ROUND_CAP if round_cap is None else round_cap
    _warn_stale_shards(out_dir, delivery, eff_cap, progress)

    def point_cfg(n):
        cfg = sweep_point(n, seed=seed, instances=instances)
        if coin != cfg.coin or delivery != cfg.delivery or \
                (round_cap is not None and round_cap != cfg.round_cap):
            cfg = dataclasses.replace(
                cfg, coin=coin, delivery=delivery,
                round_cap=cfg.round_cap if round_cap is None else round_cap,
            ).validate()
        return cfg

    ns = list(ns)
    cfgs = {n: point_cfg(n) for n in ns}
    shards_by_n: dict = {n: {} for n in ns}
    if batched and hasattr(be, "run_many"):
        for lo in range(0, instances, shard_instances):
            hi = min(lo + shard_instances, instances)
            missing = []
            for n in ns:
                if checkpoint.have_shard(out_dir, cfgs[n], lo, hi):
                    shards_by_n[n][lo] = checkpoint.load_shard(
                        out_dir / checkpoint.shard_name(cfgs[n], lo, hi))
                else:
                    missing.append(n)
            if not missing:
                continue
            ids = np.arange(lo, hi, dtype=np.int64)
            t0 = time.perf_counter()
            results, _report = be.run_many([cfgs[n] for n in missing],
                                           inst_ids=[ids] * len(missing))
            wall = time.perf_counter() - t0
            for n, res in zip(missing, results):
                res.wall_s = wall / len(missing)
                checkpoint.save_shard(out_dir, cfgs[n], res)
                shards_by_n[n][lo] = res
            progress(f"sweep shard [{lo},{hi}) batched over n={missing}: "
                     f"{(hi - lo) * len(missing) / max(wall, 1e-9):.0f} "
                     "inst/s aggregate")
    for n in ns:
        cfg = cfgs[n]
        for lo in range(0, instances, shard_instances):
            hi = min(lo + shard_instances, instances)
            if lo in shards_by_n[n]:
                continue
            if checkpoint.have_shard(out_dir, cfg, lo, hi):
                shards_by_n[n][lo] = checkpoint.load_shard(
                    out_dir / checkpoint.shard_name(cfg, lo, hi))
                continue
            res = be.timed_run(cfg, np.arange(lo, hi, dtype=np.int64))
            checkpoint.save_shard(out_dir, cfg, res)
            shards_by_n[n][lo] = res
            progress(f"sweep n={n}: instances [{lo},{hi}) "
                     f"{res.instances_per_sec:.0f} inst/s")

    out = {}
    for n in ns:
        shards = [shards_by_n[n][lo] for lo in sorted(shards_by_n[n])]
        merged = _merge(cfgs[n], shards)
        s = metrics.summary(merged)
        s["round_histogram"] = metrics.round_histogram(merged).tolist()
        out[n] = s
    return out


def sweep_record(points: dict, backend: str, delivery: str) -> dict:
    """A :func:`run_sweep` result under the run-record head
    (``obs/record.py``), the per-n summaries under ``points`` with their
    keys as strings, as any JSON round trip gives them."""
    from byzantinerandomizedconsensus_tpu_torch.obs import record

    return {
        **record.new_record("sweep"),
        "backend": backend,
        "delivery": delivery,
        "points": {str(n): s for n, s in points.items()},
    }


def _warn_stale_shards(out_dir: pathlib.Path, delivery: str, round_cap: int,
                       progress) -> None:
    """Tell the user of the shards in ``out_dir`` that cannot resume this
    sweep: another delivery law or round cap, or a packing-version token
    that is not the spec §2 law of their n today. Shard names encode all
    three, so such shards are ignored, which would otherwise restart the
    sweep from zero without a word."""
    if not out_dir.is_dir():
        return
    stale, pack_stale = [], []
    for p in out_dir.glob("*.npz"):
        if "_urn3_" in p.name:
            named_delivery = "urn3"
        elif "_urn2_" in p.name:
            named_delivery = "urn2"
        elif "_urn_" in p.name:
            named_delivery = "urn"
        else:
            named_delivery = "keys"  # legacy names carry no delivery token
        m = re.search(r"_c(\d+)_", p.name)
        named_cap = int(m.group(1)) if m else DEFAULT_ROUND_CAP
        m_p = re.search(r"_p(\d+)_s", p.name)
        named_pack = int(m_p.group(1)) if m_p else 1
        m_n = re.search(r"_n(\d+)_", p.name)
        try:
            current_pack = prf.pack_version(int(m_n.group(1))) if m_n else 1
        except ValueError:  # n beyond every law: stale by definition
            current_pack = -1
        if named_pack != current_pack:
            pack_stale.append(p.name)
        elif delivery != named_delivery or named_cap != round_cap:
            stale.append(p.name)
    if stale:
        progress(
            f"warning: {len(stale)} checkpoint shard(s) in {out_dir} belong to a "
            f"different delivery model or round cap (e.g. {stale[0]}) and will "
            f"NOT resume this delivery={delivery!r} round_cap={round_cap} sweep; "
            "pass matching --delivery/--round-cap or use a fresh --out directory")
    if pack_stale:
        progress(
            f"warning: {len(pack_stale)} checkpoint shard(s) in {out_dir} carry "
            f"a stale spec §2 packing-version token (e.g. {pack_stale[0]}): "
            "they were written under a different packing law than the current "
            "code uses at their n and will NOT resume; re-run those points in "
            "a fresh --out directory")


def _merge(cfg, shards) -> SimResult:
    return SimResult(
        config=cfg,
        inst_ids=np.concatenate([s.inst_ids for s in shards]),
        rounds=np.concatenate([s.rounds for s in shards]),
        decision=np.concatenate([s.decision for s in shards]),
        wall_s=sum(s.wall_s for s in shards),
    )
