"""Multi-seed runs beyond the per-seed instance ceiling of spec §2.

The port's copy of the reference ``utils/multiseed.py``. One seed holds at
most 2^17 instances under packing law v1 (2^16 under v2, 2^12 under v3);
a larger total shards across derived seeds: shard k runs at most the cap
under ``seed_k = splitmix64(seed + k)``, and each shard is an ordinary run
of its derived config, so it can be bit-matched on its own. SplitMix64
(Steele et al., OOPSLA 2014) spaces the seeds.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from byzantinerandomizedconsensus_tpu_torch.backends.base import SimResult, get_backend
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.ops import prf

_MASK64 = (1 << 64) - 1
#: The instances one seed holds under each packing law.
PER_SEED_CAP = {1: prf.MAX_INSTANCES, 2: prf.V2_MAX_INSTANCES, 3: prf.V3_MAX_INSTANCES}


def splitmix64(x: int) -> int:
    """SplitMix64 finaliser — uint64 in, uint64 out."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def shard_seed(seed: int, k: int) -> int:
    return splitmix64((seed & _MASK64) + k)


def run_large(cfg: SimConfig, total_instances: int, backend: str = "torch",
              shard_instances: int = 0, progress=None, **options):
    """Run ``total_instances`` trials of ``cfg`` across derived seeds.

    Returns ``(result, shards)``: ``result`` merges the shards (``inst_ids``
    0..total−1, its config the caller's ``cfg`` with ``instances`` the
    total), ``shards`` the per-shard configs that reproduce each shard on
    its own. ``backend`` is a backend's name, built with ``options``
    (``device``, ``kernel``), or a backend.
    """
    if total_instances <= 0:
        raise ValueError("total_instances must be positive")
    per_seed_cap = PER_SEED_CAP[cfg.pack_version]
    shard_instances = min(shard_instances or per_seed_cap, per_seed_cap)
    be = get_backend(backend, **options) if isinstance(backend, str) else backend
    rounds, decisions, shards = [], [], []
    k = done = 0
    wall = 0.0
    while done < total_instances:
        count = min(shard_instances, total_instances - done)
        sub = dataclasses.replace(cfg, seed=shard_seed(cfg.seed, k),
                                  instances=count).validate()
        res = be.timed_run(sub)
        wall += res.wall_s
        shards.append(sub)
        rounds.append(res.rounds)
        decisions.append(res.decision)
        if progress is not None:
            progress(f"shard {k}: {count} instances, "
                     f"{res.instances_per_sec:.0f} inst/s")
        done += count
        k += 1
    # Not validated: the total may exceed the per-seed ceiling, which is the
    # point of the shards.
    merged = SimResult(
        config=dataclasses.replace(cfg, instances=total_instances),
        inst_ids=np.arange(total_instances, dtype=np.int64),
        rounds=np.concatenate(rounds),
        decision=np.concatenate(decisions),
        wall_s=wall,
    )
    return merged, shards
