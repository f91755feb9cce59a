"""Per-instance reference results of the shipped configurations under the
spec §4 keys law, and of a Ben-Or Byzantine configuration under keys and
under the §4b urn law.

Runs config1-4 (``preset(name, delivery="keys")``: their sizes as shipped,
seed 0, round cap 256) for instances 0..255 (config1 has one instance), and
Ben-Or, n=64, f=12 (the largest f with n > 5f), adversary byzantine, local
coin, seed 0, round cap 256, under keys and under urn for instances 0..255,
through the JAX package's numpy backend on the CPU, and writes one shard per
run beside this file, in the format of ``artifacts/sweep_urn2/``
(``inst_ids``, ``rounds``, ``decision``, ``config`` as JSON bytes,
``wall_s``):

    env JAX_PLATFORMS=cpu python artifacts/sweep_keys_shipped/make_reference.py

The port's ``chip_smoke.py`` holds its runs of these instances against the
shards per instance.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent.parent))

from byzantinerandomizedconsensus_tpu.backends import get_backend  # noqa: E402
from byzantinerandomizedconsensus_tpu.config import SimConfig, preset  # noqa: E402

HI = 256


def configs():
    for name in ("config1", "config2", "config3", "config4"):
        yield preset(name, delivery="keys")
    for law in ("keys", "urn"):
        yield SimConfig(protocol="benor", n=64, f=12, instances=HI, adversary="byzantine",
                        coin="local", delivery=law)


def main() -> None:
    for cfg in configs():
        cfg = cfg.validate()
        hi = min(HI, cfg.instances)
        ids = np.arange(0, hi, dtype=np.int64)
        t0 = time.perf_counter()
        res = get_backend("numpy").run(cfg, ids)
        wall = time.perf_counter() - t0
        name = (f"{cfg.protocol}_n{cfg.n}_f{cfg.f}_{cfg.adversary}_{cfg.coin}_"
                f"{cfg.delivery}_s{cfg.seed}_i0-{hi}.npz")
        np.savez_compressed(
            HERE / name, inst_ids=res.inst_ids, rounds=res.rounds,
            decision=res.decision,
            config=np.frombuffer(json.dumps(dataclasses.asdict(cfg)).encode(),
                                 dtype=np.uint8),
            wall_s=np.float64(wall))
        print(name, np.bincount(res.decision, minlength=3).tolist(),
              float(res.rounds.mean()), f"{wall:.1f} s", flush=True)


if __name__ == "__main__":
    main()
