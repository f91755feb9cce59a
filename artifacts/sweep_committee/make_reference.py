"""Reference results of the committee family's benchmark point (spec §10).

Runs ``committee_point(n)`` (bracha, f = n/5, adversary adaptive, shared
coin, delivery committee, seed 0, packing law v3) at n = 8192 and
n = 131072 through the JAX package's numpy backend on the CPU, for
instances 0..63, and writes one shard per n beside this file, in the format
of ``artifacts/sweep_urn2/`` (``inst_ids``, ``rounds``, ``decision``,
``config`` as JSON bytes, ``wall_s``):

    env JAX_PLATFORMS=cpu python artifacts/sweep_committee/make_reference.py

The port's ``chip_smoke.py`` holds its run of these instances against the
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
from byzantinerandomizedconsensus_tpu.config import committee_point  # noqa: E402

NS = (8192, 131072)
LO, HI = 0, 256


def main() -> None:
    for n in NS:
        cfg = committee_point(n)
        ids = np.arange(LO, HI, dtype=np.int64)
        t0 = time.perf_counter()
        res = get_backend("numpy").run(cfg, ids)
        wall = time.perf_counter() - t0
        name = (f"{cfg.protocol}_n{cfg.n}_f{cfg.f}_{cfg.adversary}_{cfg.coin}_"
                f"{cfg.delivery}_s{cfg.seed}_i{LO}-{HI}.npz")
        np.savez_compressed(
            HERE / name, inst_ids=res.inst_ids, rounds=res.rounds,
            decision=res.decision,
            config=np.frombuffer(json.dumps(dataclasses.asdict(cfg)).encode(),
                                 dtype=np.uint8),
            wall_s=np.float64(wall))
        print(name, np.bincount(res.decision, minlength=3).tolist(),
              np.bincount(res.rounds)[:8].tolist(), f"{wall:.1f} s", flush=True)


if __name__ == "__main__":
    main()
