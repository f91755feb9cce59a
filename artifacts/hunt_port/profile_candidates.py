"""Where a direct-leg hunt candidate's time goes on the card.

Runs the port's hunt (evolution, seed 17, ``cli hunt``'s defaults) through a
synchronous adapter over ``get_backend("torch")`` on the card and, for each
candidate, times its run (the kernel by law), the per-reply invariant check
on the card (``models/invariants.py::check_config``, the plain driver with
full state) and the same check on the CPU; stops asking after LIMIT seconds.
Writes one JSON line per candidate to OUT and prints the totals by kernel:

    python3 artifacts/hunt_port/profile_candidates.py LIMIT OUT.jsonl
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from byzantinerandomizedconsensus_tpu_torch import get_backend  # noqa: E402
from byzantinerandomizedconsensus_tpu_torch.hunt.archive import Archive  # noqa: E402
from byzantinerandomizedconsensus_tpu_torch.hunt.hunter import Hunter  # noqa: E402
from byzantinerandomizedconsensus_tpu_torch.hunt.space import SearchSpace  # noqa: E402
from byzantinerandomizedconsensus_tpu_torch.hunt.strategies import make_strategy  # noqa: E402
from byzantinerandomizedconsensus_tpu_torch.models import invariants  # noqa: E402
from byzantinerandomizedconsensus_tpu_torch.ops import _build  # noqa: E402


class _Done:
    def __init__(self, rec):
        self.rec = rec

    def wait(self, timeout=None):
        return self.rec


class _OutOfTime(Exception):
    pass


class TimedCard:
    """The Hunter's submit contract, each candidate run and checked at once."""

    def __init__(self, limit_s: float, out):
        self.backend = get_backend("torch")
        self.deadline = time.perf_counter() + limit_s
        self.out = out
        self.rows = []

    def submit(self, cfg, check_invariants=False):
        if time.perf_counter() > self.deadline:
            raise _OutOfTime
        t0 = time.perf_counter()
        res = self.backend.run(cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        invariants.check_config(cfg, device="cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        invariants.check_config(cfg, device="cpu")
        t3 = time.perf_counter()
        row = {"kernel": self.backend.kernel_for(cfg), "delivery": cfg.delivery,
               "faults": cfg.faults, "n": cfg.n, "instances": cfg.instances,
               "round_cap": cfg.round_cap, "max_rounds": int(res.rounds.max()),
               "run_s": t1 - t0, "invariants_card_s": t2 - t1, "invariants_cpu_s": t3 - t2}
        self.rows.append(row)
        self.out.write(json.dumps(row) + "\n")
        return _Done({"rounds": [int(r) for r in res.rounds],
                      "decision": [int(d) for d in res.decision]})


def main() -> None:
    limit_s, path = float(sys.argv[1]), pathlib.Path(sys.argv[2])
    _build.build()
    t0 = time.perf_counter()
    with path.open("w") as out:
        card = TimedCard(limit_s, out)
        space = SearchSpace()
        try:
            Hunter(card, make_strategy("evolution", space, 17), space=space,
                   archive=Archive(8)).run(500)
        except _OutOfTime:
            pass
    totals: dict = {}
    for r in card.rows:
        t = totals.setdefault(r["kernel"], {"evaluations": 0, "at_cap": 0, "run_s": 0.0,
                                            "invariants_card_s": 0.0, "invariants_cpu_s": 0.0})
        t["evaluations"] += 1
        t["at_cap"] += int(r["max_rounds"] >= r["round_cap"])
        for k in ("run_s", "invariants_card_s", "invariants_cpu_s"):
            t[k] += r[k]
    print(json.dumps({"evaluations": len(card.rows), "wall_s": time.perf_counter() - t0,
                      "by_kernel": totals}))


if __name__ == "__main__":
    main()
