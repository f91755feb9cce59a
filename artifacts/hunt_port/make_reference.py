"""Reference hunts for the port's adversary hunter.

Drives the JAX package's ``hunt.hunter.Hunter`` on the CPU with a
synchronous adapter over its ``numpy`` backend: the adapter's ``submit``
runs the config at once and returns a handle whose ``wait`` gives
``{"rounds", "decision"}``. A hunt's trajectory is a function of
``(strategy, seed)`` and of the per-instance arrays, so a server that
answers bit for bit gives the same archive, digest for digest. Writes
``reference.json`` beside this file with the legs

- ``a``: evolution, seed 17, budget 500, generation 16, archive 8, the
  pipelined hunt and its barriered control (``cli hunt``'s defaults);
- ``c``: evolution, seed 17, budget 16, generation 8, archive 4, pipelined;
- ``d``: ``--committee-scale``, evolution, seed 17, budget 32, generation
  8, archive 8, pipelined;

each with its evaluations, generations, ``best_fitness`` and every archive
entry's genome, fitness, mean rounds and digest, and the fault-free
config4 baseline at 64 instances (``baseline_mean_rounds``):

    env JAX_PLATFORMS=cpu python artifacts/hunt_port/make_reference.py

It took 265 s on a CPU. The port's ``chip_smoke.py`` (phase 17)
reads only the JSON, and ``tests/test_torch_hunt.py`` holds leg ``c``
against the port's hunt on the CPU.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent.parent))

from byzantinerandomizedconsensus_tpu.backends import get_backend  # noqa: E402
from byzantinerandomizedconsensus_tpu.hunt import hunter as _hunter  # noqa: E402
from byzantinerandomizedconsensus_tpu.hunt.archive import Archive  # noqa: E402
from byzantinerandomizedconsensus_tpu.hunt.space import SearchSpace  # noqa: E402
from byzantinerandomizedconsensus_tpu.hunt.strategies import make_strategy  # noqa: E402

#: leg -> (budget, generation, archive k, committee_scale, barriered control)
LEGS = {"a": (500, 16, 8, False, True),
        "c": (16, 8, 4, False, False),
        "d": (32, 8, 8, True, False)}
STRATEGY, SEED = "evolution", 17


class _Done:
    def __init__(self, rec):
        self.rec = rec

    def wait(self, timeout=None):
        return self.rec


class SyncNumpy:
    """The ``Hunter``'s submit contract over the numpy backend, run at submit."""

    def __init__(self):
        self.backend = get_backend("numpy")

    def submit(self, cfg, check_invariants=False):
        res = self.backend.run(cfg)
        return _Done({"rounds": [int(r) for r in res.rounds],
                      "decision": [int(d) for d in res.decision]})


def hunt(budget, generation, k, committee_scale, pipelined) -> dict:
    space = SearchSpace(committee_scale=committee_scale)
    h = _hunter.Hunter(SyncNumpy(), make_strategy(STRATEGY, space, SEED), space=space,
                       archive=Archive(k), generation=generation, pipelined=pipelined,
                       check_invariants=True)
    t0 = time.perf_counter()
    stats = h.run(budget)
    wall = time.perf_counter() - t0
    return {
        "evaluations": stats["evaluations"], "generations": stats["generations"],
        "best_fitness": stats["best_fitness"],
        "archive": [{key: e[key] for key in ("genome", "fitness", "mean_rounds",
                                             "max_rounds", "undecided_fraction", "digest")}
                    for e in h.archive.entries()],
        "cpu_wall_s": round(wall, 1),
    }


def main() -> None:
    t_all = time.perf_counter()
    doc = {"strategy": STRATEGY, "seed": SEED,
           "baseline_mean_rounds": round(_hunter._config4_baseline(), 6),
           "legs": {}}
    for name, (budget, generation, k, committee, control) in LEGS.items():
        leg = {"budget": budget, "generation": generation, "archive_k": k,
               "committee_scale": committee,
               "space": SearchSpace(committee_scale=committee).doc(),
               "pipelined": hunt(budget, generation, k, committee, True)}
        if control:
            leg["barriered"] = hunt(budget, generation, k, committee, False)
        doc["legs"][name] = leg
        print(name, leg["pipelined"]["best_fitness"], leg["pipelined"]["cpu_wall_s"], "s",
              [e["digest"][:12] for e in leg["pipelined"]["archive"]], flush=True)
    doc["cpu_wall_s"] = round(time.perf_counter() - t_all, 1)
    (HERE / "reference.json").write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(f"wrote reference.json in {doc['cpu_wall_s']} s")


if __name__ == "__main__":
    main()
