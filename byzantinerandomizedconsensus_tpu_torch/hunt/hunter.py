"""The closed hunt loop and the ``cli hunt`` entry point.

The port's copy of the reference ``hunt/hunter.py``. The hunter is a
*client* of the serving stack: it streams candidate generations from an
ask/tell strategy (hunt/strategies.py) into a resident
:class:`~byzantinerandomizedconsensus_tpu_torch.serve.server.ConsensusServer`
and harvests fitness at retirement, straight off each reply record's
per-instance (rounds, decision) arrays:

    fitness = mean_rounds + round_cap × undecided_fraction

— mean rounds-to-decision as the schedule-strength signal, the
undecided-at-cap fraction (decision == 2) weighted by the cap as the
liveness-cliff signal, and the reply's opt-in invariant summary as an
instant safety red alarm: any Agreement / Validity violation is counted,
alarmed on the trace bus, and fails the run.

A hunt's whole trajectory is a function of ``(strategy, seed)`` and of the
per-instance arrays, told in submit order (each generation sorted by
bucket label). Every leg of the server answers bit for bit as the offline
run, so a hunt through the port gives the reference's archive, digest for
digest.

**Ask-ahead pipelining** is the point of driving a server instead of a
batch runner: generation g+1 is drawn and submitted while generation g is
still being served. ``pipelined=False`` is the barriered control: submit,
wait for the whole generation, only then ask.

**The legs.** The server's leg follows its backend's kernel, as in ``cli
serve``: with no kernel named on the card the **direct leg** (one
``backend.run`` per candidate: the fused round kernel under urn, urn2,
urn3 and committee, the per-step keys kernel under keys, the plain driver
for keys under a §9 schedule); ``--kernel plain`` (and always on the CPU)
the **lane leg**, the compacted lane grid over the plain round driver.

The runner (``cli hunt``) follows the loadgen discipline: warm every
program the space can reach (the lane leg: the space's whole bucket
universe, then each bucket's drain; the direct leg: the bucket bursts and
one candidate per kernel library the space can reach, committee tiers
included), snapshot the build counter, hunt, then pin 0 safety violations
(exit 1), 0 steady-state builds (exit 2; also a missing card, named),
valid records (exit 3) and a replay of every archive entry on the hunt's
own device (exit 4). The elite archive exports to ``hunt_regressions.json``
beside the record.

    python -m byzantinerandomizedconsensus_tpu_torch.cli hunt --out hunt.json
    python -m byzantinerandomizedconsensus_tpu_torch.cli hunt --device cpu \\
        --budget 12 --generation 6 --no-control --out /tmp/hunt.json
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import pathlib
import random
import sys
import time

from byzantinerandomizedconsensus_tpu_torch.hunt.archive import Archive, replay
from byzantinerandomizedconsensus_tpu_torch.hunt.space import (
    COMMITTEE_N_TIERS, SearchSpace, encode)
from byzantinerandomizedconsensus_tpu_torch.hunt.strategies import (
    STRATEGIES, make_strategy)
from byzantinerandomizedconsensus_tpu_torch.obs import metrics as _metrics
from byzantinerandomizedconsensus_tpu_torch.obs import programs as _programs
from byzantinerandomizedconsensus_tpu_torch.obs import record as _record
from byzantinerandomizedconsensus_tpu_torch.obs import trace as _trace
from byzantinerandomizedconsensus_tpu_torch.serve import admission as _admission
from byzantinerandomizedconsensus_tpu_torch.utils.rounds import default_artifact

DEFAULT_BUDGET = 500
DEFAULT_GENERATION = 16
DEFAULT_ARCHIVE_K = 8
#: Seconds ``run_hunt`` waits for one reply before it fails by name (read
#: when the hunt starts, so a caller may bound it for the process).
WAIT_TIMEOUT_S = 1800.0


def fitness_of(cfg, rounds, decision) -> dict:
    """Fold one reply's result arrays into the hunt objective and its
    components (all recorded; higher fitness = worse case = better find)."""
    rounds = [int(r) for r in rounds]
    decision = [int(d) for d in decision]
    count = max(1, len(decision))
    mean_rounds = sum(rounds) / count
    undecided = sum(1 for d in decision if d == 2) / count
    return {
        "fitness": mean_rounds + float(cfg.round_cap) * undecided,
        "mean_rounds": mean_rounds,
        "undecided_fraction": undecided,
    }


class Hunter:
    """The closed loop: strategy asks → server submits → retirement tells.

    ``server`` is anything with the :class:`ConsensusServer` submit
    contract (``submit(cfg, check_invariants=...) -> handle`` with a
    blocking ``wait(timeout)``): in-process or the :class:`RemoteServer`
    adapter. ``pipelined=True`` keeps one generation in flight ahead of
    the harvest; ``False`` is the barriered control. ``wait_timeout``
    bounds each reply's wait: a stuck reply raises ``TimeoutError``
    naming the request. ``evaluated`` lists ``(cfg, max_rounds)`` per
    harvest, in tell order.
    """

    def __init__(self, server, strategy, space: SearchSpace | None = None,
                 archive: Archive | None = None,
                 generation: int = DEFAULT_GENERATION,
                 pipelined: bool = True, check_invariants: bool = True,
                 wait_timeout: float = WAIT_TIMEOUT_S):
        if generation < 1:
            raise ValueError(f"generation={generation} out of range (>= 1)")
        self.server = server
        self.strategy = strategy
        self.space = space if space is not None else strategy.space
        # explicit None test: an *empty* archive is falsy (it has __len__)
        self.archive = archive if archive is not None \
            else Archive(DEFAULT_ARCHIVE_K)
        self.generation = int(generation)
        self.pipelined = bool(pipelined)
        self.check_invariants = bool(check_invariants)
        self.wait_timeout = float(wait_timeout)
        self.generations = 0
        self.violations = 0
        self.violation_detail: list = []
        self.evaluated: list = []

    # -- one generation ----------------------------------------------------

    def _submit_generation(self, size: int) -> list:
        """Ask ``size`` candidates and stream them into the server, sorted
        by bucket so a mixed generation costs the fewest grid rotations.
        Returns ``[(cfg, handle)]`` in submit order."""
        asked = [self.strategy.ask() for _ in range(size)]
        asked.sort(key=lambda c: _admission.bucket_of(c).label())
        out = []
        for cfg in asked:
            out.append((cfg, self._submit_one(cfg)))
        self.generations += 1
        _trace.event("hunt.generation", gen=self.generations, size=size)
        if _metrics.enabled():
            _metrics.counter("brc_hunt_generations_total",
                             "Candidate generations submitted").inc()
        return out

    def _submit_one(self, cfg):
        """One submit with backpressure: a bounded WorkFeed's named
        overflow (backends/compaction.py) means *wait for the grid to
        drain*, not fail the hunt."""
        from byzantinerandomizedconsensus_tpu_torch.backends.compaction import (
            WorkFeedOverflow)
        delay = 0.01
        while True:
            try:
                return self.server.submit(
                    cfg, check_invariants=self.check_invariants)
            except WorkFeedOverflow:
                time.sleep(delay)
                delay = min(0.5, delay * 2)

    def _harvest(self, batch: list) -> None:
        """Wait out one generation and tell the strategy / archive."""
        for cfg, handle in batch:
            rec = handle.wait(timeout=self.wait_timeout)
            fit = fitness_of(cfg, rec["rounds"], rec["decision"])
            self.evaluated.append((cfg, max((int(r) for r in rec["rounds"]),
                                            default=0)))
            inv = rec.get("invariants")
            if inv is not None and inv["violations"]:
                # the red alarm: a safety violation found by the hunt is
                # instantly visible, not discovered at record assembly
                self.violations += inv["violations"]
                self.violation_detail.append(
                    {"genome": encode(cfg), "invariants": inv})
                _trace.event("hunt.violation", request=rec.get("request_id"),
                             count=inv["violations"])
                if _metrics.enabled():
                    _metrics.counter(
                        "brc_hunt_violations_total",
                        "Safety violations found by hunt evaluations").inc(
                            inv["violations"])
            prev_best = self.strategy.best_fitness
            self.strategy.tell(cfg, fit["fitness"])
            self.archive.offer(cfg, fit["fitness"], rec["rounds"],
                               rec["decision"])
            if prev_best is None or fit["fitness"] > prev_best:
                _trace.event("hunt.best", fitness=round(fit["fitness"], 3),
                             mean_rounds=round(fit["mean_rounds"], 3),
                             undecided=round(fit["undecided_fraction"], 4))
        _trace.event("hunt.harvest", gen=self.generations,
                     evaluations=self.strategy.evaluations,
                     best=round(self.strategy.best_fitness or 0.0, 3),
                     archive=len(self.archive))
        if _metrics.enabled():
            _metrics.counter("brc_hunt_evaluations_total",
                             "Candidate evaluations harvested").inc(
                                 len(batch))
            _metrics.gauge("brc_hunt_best_fitness",
                           "Best (worst-case) fitness found so far").set(
                               self.strategy.best_fitness or 0.0)
            _metrics.gauge("brc_hunt_archive_size",
                           "Distinct worst cases in the elite archive").set(
                               len(self.archive))

    # -- the loop ----------------------------------------------------------

    def run(self, budget: int) -> dict:
        """Hunt until ``budget`` evaluations have been harvested; returns
        the schema-v1.8 stats dict (:func:`obs.record.hunt_block` input)."""
        if budget < 1:
            raise ValueError(f"budget={budget} out of range (>= 1)")
        t0 = time.perf_counter()
        with _trace.span("hunt.run", strategy=self.strategy.name,
                         seed=self.strategy.seed, budget=int(budget),
                         pipelined=self.pipelined):
            remaining = int(budget)
            inflight = None
            while remaining > 0 or inflight:
                if remaining > 0:
                    size = min(self.generation, remaining)
                    batch = self._submit_generation(size)
                    remaining -= size
                else:
                    batch = None
                if self.pipelined:
                    # harvest the *previous* generation: the one just
                    # submitted is served in the meantime
                    if inflight:
                        self._harvest(inflight)
                    inflight = batch
                elif batch is not None:
                    self._harvest(batch)  # barriered control
        wall = time.perf_counter() - t0
        _trace.event("hunt.done", evaluations=self.strategy.evaluations,
                     best=round(self.strategy.best_fitness or 0.0, 3),
                     violations=self.violations, wall_s=round(wall, 3))
        stats = {
            "strategy": self.strategy.name,
            "seed": self.strategy.seed,
            "budget": int(budget),
            "evaluations": self.strategy.evaluations,
            "generations": self.generations,
            "generation_size": self.generation,
            "best_fitness": (round(self.strategy.best_fitness, 6)
                             if self.strategy.best_fitness is not None
                             else None),
            "archive_size": len(self.archive),
            "violations": self.violations,
            "duration_s": round(wall, 3),
            "space": self.space.doc(),
        }
        best = self.archive.best()
        if best is not None:
            stats["best"] = {k: best[k] for k in
                             ("fitness", "genome", "mean_rounds",
                              "undecided_fraction", "digest")}
        return stats


# -- remote adapter ----------------------------------------------------------


class RemoteServer:
    """The ``--url`` client: the :class:`Hunter` submit contract over the
    server's stdlib HTTP front end (POST /submit + GET /result/<id> polls,
    urllib only, each call with a timeout)."""

    def __init__(self, url: str, poll_s: float = 0.05):
        self.base = url.rstrip("/")
        self.poll_s = float(poll_s)

    def _request(self, path: str, payload: dict | None = None):
        import urllib.error
        import urllib.request
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(
            self.base + path, data=data,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60.0) as resp:
                return resp.status, json.loads(resp.read().decode() or "{}")
        except urllib.error.HTTPError as e:
            # non-2xx still carries the JSON error body
            try:
                return e.code, json.loads(e.read().decode() or "{}")
            except ValueError:
                return e.code, {"error": str(e)}

    def submit(self, cfg, check_invariants: bool = False):
        payload = dataclasses.asdict(cfg)
        if check_invariants:
            payload["check_invariants"] = True
        status, doc = self._request("/submit", payload)
        if status != 200 or "id" not in doc:
            raise RuntimeError(f"remote submit failed ({status}): {doc}")
        return _RemoteHandle(self, doc["id"])

    def compile_count(self):
        """Steady-state build pins need the in-process probe; a remote
        hunt reports them as unmeasured (None), never as a fake 0."""
        return None


class _RemoteHandle:
    def __init__(self, remote: RemoteServer, rid: str):
        self.remote = remote
        self.id = rid

    def wait(self, timeout: float | None = None) -> dict:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            status, doc = self.remote._request(f"/result/{self.id}")
            if status == 200 and doc.get("id") != self.id:
                return doc  # the reply record
            if status == 500 or doc.get("error"):
                raise RuntimeError(
                    f"request {self.id} failed: {doc.get('error')}")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"request {self.id} not done after {timeout}s")
            time.sleep(self.remote.poll_s)


# -- the runner --------------------------------------------------------------


def _warm_drains(server, buckets, policy) -> None:
    """Build every bucket's *drain* program (the lane leg only).

    The burst warm-up (tools/loadgen.warm_up) builds init/segment/refill,
    but its drain coverage depends on a rotation close landing while lanes
    are still live. A hunt must pin 0 steady-state builds, so each bucket
    gets one direct ``run_bucket`` pass with a pre-closed single-config
    feed: seed → queue empty → feed closed → the drain segment (at the
    feed ceiling) runs by construction."""
    from byzantinerandomizedconsensus_tpu_torch.backends import (
        compaction as _compaction)
    from byzantinerandomizedconsensus_tpu_torch.config import SimConfig

    for i, bucket in enumerate(buckets):
        feed = _compaction.WorkFeed(round_cap_ceiling=server._ceiling)
        cfg = SimConfig(
            protocol=bucket.protocol, n=min(7, bucket.n_pad), f=1,
            instances=8, adversary="none", coin="local", init="random",
            seed=5000 + i, round_cap=server._ceiling,
            delivery=bucket.delivery).validate()
        feed.push(cfg)
        feed.close()
        _compaction.run_bucket(server._backend, bucket, [], [],
                               policy=policy, feed=feed,
                               on_retire=lambda token, res: None)


def library_sample(space: SearchSpace) -> list:
    """Candidates of ``space`` over every axis that picks a kernel library
    on the direct leg: protocol × adversary × delivery × fault schedule at a
    small shape, and under ``committee_scale`` each committee tier too,
    each through the space's own repair gate. ``tools/loadgen.py::
    library_configs`` keeps one per library, so the warm-up loads every
    library a hunt of this space can reach."""
    from byzantinerandomizedconsensus_tpu_torch.config import (
        DELIVERY_KINDS, FAULT_KINDS)
    from byzantinerandomizedconsensus_tpu_torch.tools import sampler as _sampler

    base = encode(space.sample(random.Random("hunt-libraries")))
    base.update(f=1, instances=8, round_cap=32)
    shapes = [(16, d) for d in DELIVERY_KINDS]
    if space.committee_scale:
        shapes += [(n, "committee") for n in COMMITTEE_N_TIERS]
    return [space.materialize(dict(base, n=n, delivery=delivery, protocol=protocol,
                                   adversary=adversary, faults=faults))
            for n, delivery in shapes
            for protocol in _sampler._PROTOCOLS
            for adversary in _sampler._ADVERSARIES
            for faults in FAULT_KINDS]


def _config4_baseline(backend, instances: int = 64) -> float:
    """Mean rounds of the fault-free config-4 preset (small-instance
    override) on the hunt's own backend and device: the yardstick the
    'rediscovers a known hard region' claim is measured against."""
    from byzantinerandomizedconsensus_tpu_torch.config import preset

    cfg = preset("config4", instances=instances)
    res = backend.run(cfg)
    return float(sum(int(r) for r in res.rounds) / max(1, len(res.rounds)))


def _by_kernel(backend, evaluated) -> dict:
    """Evaluations per kernel (``kernel_for`` on the direct leg; ``lanes``
    on the lane leg), each with how many ran an instance to its cap and
    the sum of their max rounds."""
    kernel_for = getattr(backend, "kernel_for", None)
    lanes = getattr(backend, "kernel", None) == "plain" or kernel_for is None
    out: dict = collections.defaultdict(
        lambda: {"evaluations": 0, "at_cap": 0, "max_rounds_sum": 0})
    for cfg, max_rounds in evaluated:
        row = out["lanes" if lanes else kernel_for(cfg)]
        row["evaluations"] += 1
        row["at_cap"] += int(max_rounds >= cfg.round_cap)
        row["max_rounds_sum"] += int(max_rounds)
    return dict(sorted(out.items()))


def run_hunt(args, backend) -> tuple[dict, Archive, int]:
    """Warm-up → pipelined hunt → barriered control → pins, the server (or
    the replay check's and baseline's runs, with ``--url``) on ``backend``.
    Returns ``(stats, archive, steady_state_compiles_or_None)``."""
    from byzantinerandomizedconsensus_tpu_torch.backends import compaction as _cpt
    from byzantinerandomizedconsensus_tpu_torch.serve.server import ConsensusServer
    from byzantinerandomizedconsensus_tpu_torch.tools import loadgen as _loadgen

    space = SearchSpace(committee_scale=args.committee_scale)
    if args.url:
        server, owned = RemoteServer(args.url), False
    else:
        policy = _cpt.CompactionPolicy.parse(args.policy).validate()
        server = ConsensusServer(
            backend=backend, policy=policy,
            round_cap_ceiling=_loadgen.ROUND_CAP_CEILING).start()
        owned = True
    leg = server.leg if owned else "remote"
    try:
        if owned:
            # the space's build universe is small and closed: warm every
            # program it can reach, then pin
            lanes = leg == "lanes"
            extra = () if lanes else _loadgen.library_configs(
                backend, library_sample(space))
            _loadgen.warm_up(server, space.buckets(), burst=6, extra=extra)
            if lanes:
                _warm_drains(server, space.buckets(), policy)
        compiles_warm = server.compile_count() if owned else None

        strategy = make_strategy(args.strategy, space, args.seed)
        hunter = Hunter(server, strategy, space=space,
                        archive=Archive(args.archive_k),
                        generation=args.generation, pipelined=True,
                        check_invariants=not args.no_invariants,
                        wait_timeout=WAIT_TIMEOUT_S)
        stats = hunter.run(args.budget)
        stats["pipelined_wall_s"] = stats.pop("duration_s")

        if not args.no_control:
            # the barriered control: same (strategy, seed), same warm
            # server; only the generation overlap differs
            control = Hunter(
                server, make_strategy(args.strategy, space, args.seed),
                space=space, archive=Archive(args.archive_k),
                generation=args.generation, pipelined=False,
                check_invariants=not args.no_invariants,
                wait_timeout=WAIT_TIMEOUT_S)
            cstats = control.run(args.budget)
            stats["barriered_wall_s"] = cstats["duration_s"]
            stats["pipeline_speedup"] = round(
                cstats["duration_s"] / max(1e-9, stats["pipelined_wall_s"]),
                3)
            stats["violations"] += cstats["violations"]
            hunter.violation_detail.extend(control.violation_detail)
            stats["control_best_fitness"] = cstats["best_fitness"]
            stats["control_archive_digests"] = [
                e["digest"] for e in control.archive.entries()]

        steady = (server.compile_count() - compiles_warm) if owned else None
        stats["steady_state_compiles"] = steady
        stats["leg"] = leg
        stats["by_kernel"] = _by_kernel(backend, hunter.evaluated)
        baseline = round(_config4_baseline(backend), 6)
        stats["baseline_mean_rounds"] = baseline
        # the rediscovery pin: the hunt must land the known hard region,
        # an adaptive-family worst case whose mean rounds-to-decision sits
        # above the fault-free config-4 baseline
        adaptive = [e["mean_rounds"] for e in hunter.archive.entries()
                    if e["genome"]["adversary"].startswith("adaptive")]
        stats["rediscovery"] = {
            "best_adaptive_mean_rounds": max(adaptive) if adaptive else None,
            "baseline_mean_rounds": baseline,
            "above_baseline": bool(adaptive and max(adaptive) > baseline),
        }
        stats["violation_detail"] = hunter.violation_detail[:8]
        return stats, hunter.archive, steady
    finally:
        if owned:
            server.shutdown(drain=True)


def build_parser() -> argparse.ArgumentParser:
    from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import KERNELS

    ap = argparse.ArgumentParser(
        prog="byzantinerandomizedconsensus_tpu_torch.cli hunt",
        description="Closed-loop worst-case search over the adversary × "
                    "fault × delivery space, driving the serving stack")
    ap.add_argument("--strategy", default="evolution",
                    choices=sorted(STRATEGIES),
                    help="optimizer (default evolution)")
    ap.add_argument("--budget", type=int, default=DEFAULT_BUDGET,
                    help=f"evaluations to harvest (default {DEFAULT_BUDGET})")
    ap.add_argument("--seed", type=int, default=17,
                    help="strategy seed: the whole hunt is reproducible "
                         "from (strategy, seed) (default 17)")
    ap.add_argument("--generation", type=int, default=DEFAULT_GENERATION,
                    help="candidates per generation "
                         f"(default {DEFAULT_GENERATION})")
    ap.add_argument("--archive-k", type=int, default=DEFAULT_ARCHIVE_K,
                    help="elite archive size "
                         f"(default {DEFAULT_ARCHIVE_K})")
    ap.add_argument("--backend", default="torch",
                    help="in-process serving backend (default torch)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits 2 with no card) or cpu; also "
                         "the device of the replay check and the baseline")
    ap.add_argument("--kernel", choices=KERNELS, default=None,
                    help="plain: the lane leg; none named (default): the "
                         "direct leg on the card, the kernel by law (fused "
                         "and step run only part of the space and are "
                         "refused)")
    ap.add_argument("--policy", default="width=64,segment=1",
                    help="compaction policy (default width=64,segment=1)")
    ap.add_argument("--url", default=None,
                    help="hunt a remote server instead of in-process "
                         "(build pins become unmeasured)")
    ap.add_argument("--committee-scale", action="store_true",
                    help="admit §10 delivery='committee' genomes at "
                         "committee-scale n (pow2 tiers 1024..65536); the "
                         "warm-up universe grows by 2 buckets per tier")
    ap.add_argument("--no-invariants", action="store_true",
                    help="skip the per-reply safety checks (faster; the "
                         "violations pin becomes vacuous)")
    ap.add_argument("--no-control", action="store_true",
                    help="skip the barriered control run")
    ap.add_argument("--slo-violations", type=int, default=0,
                    help="max tolerated safety violations (default 0)")
    ap.add_argument("--out", default=None,
                    help=f"record path (default {default_artifact('hunt')})")
    ap.add_argument("--regressions-out", default=None,
                    help="elite-archive export path (default "
                         "<out dir>/hunt_regressions.json)")
    ap.add_argument("--trace", default=None,
                    help="also write the hunt trace stream to this path")
    return ap


def main(argv=None) -> int:
    from byzantinerandomizedconsensus_tpu_torch.cli import make_backend

    args = build_parser().parse_args(argv)
    if args.kernel in ("fused", "step"):
        print(f"hunt: --kernel {args.kernel} runs only part of the search "
              "space (fused refuses keys, step runs keys and urn without a "
              "schedule); name no kernel (the kernel by law) or plain (the "
              "lane leg)", file=sys.stderr)
        return 2
    try:
        # on a card unless --device cpu: with none present this raises by
        # name, and nothing falls back to the CPU
        backend = make_backend(args.backend, args.device, args.kernel)
    except (KeyError, RuntimeError, ValueError) as e:
        print(f"hunt: {e}", file=sys.stderr)
        return 2

    _metrics.configure()
    _programs.maybe_enable_from_env()
    if args.trace:
        _trace.configure(path=args.trace)

    stats, archive, steady = run_hunt(args, backend)

    doc = _record.new_record(
        "hunt",
        description="Seeded closed-loop adversary hunt driving the "
                    "consensus service: worst-case search over the "
                    "adversary × §9 fault × delivery × shape space, "
                    "pipelined generations vs a barriered control, "
                    "safety-checked at every retirement")
    doc["hunt"] = _record.hunt_block(stats)
    doc["metrics"] = _record.metrics_block(_metrics.snapshot())
    doc["backend"] = args.backend
    doc["device"] = args.device
    doc["kernel"] = args.kernel
    doc["leg"] = stats["leg"]
    doc["by_kernel"] = stats["by_kernel"]
    for key in ("control_best_fitness", "control_archive_digests"):
        if key in stats:
            doc[key] = stats[key]
    doc["replay_check"] = [replay(e, args.device, backend=args.backend,
                                  kernel=args.kernel)
                           for e in archive.entries()]
    programs = _record.programs_block()
    if programs is not None:
        doc["programs"] = programs
    out = pathlib.Path(args.out or default_artifact("hunt"))
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")

    reg_out = pathlib.Path(args.regressions_out or
                           out.parent / "hunt_regressions.json")
    reg_doc = archive.export_doc(stats)
    reg_out.write_text(json.dumps(reg_doc, indent=1, sort_keys=True) + "\n")

    best = stats.get("best") or {}
    print(f"hunt: strategy={stats['strategy']} seed={stats['seed']} "
          f"evaluations={stats['evaluations']} "
          f"best_fitness={stats['best_fitness']} "
          f"archive={stats['archive_size']} ({stats['leg']} leg on "
          f"{args.device}) -> {out}")
    if best:
        g = best["genome"]
        print(f"  worst case: {g['protocol']} n={g['n']} f={g['f']} "
              f"adversary={g['adversary']} faults={g['faults']} "
              f"delivery={g['delivery']} mean_rounds={best['mean_rounds']} "
              f"undecided={best['undecided_fraction']}")
    if stats.get("pipeline_speedup") is not None:
        print(f"  pipelined {stats['pipelined_wall_s']}s vs barriered "
              f"{stats['barriered_wall_s']}s -> "
              f"{stats['pipeline_speedup']}x")
    print(f"  evaluations by kernel {stats['by_kernel']}")
    print(f"  violations={stats['violations']} steady_state_compiles="
          f"{steady} baseline_mean_rounds={stats['baseline_mean_rounds']} "
          f"regressions -> {reg_out}")
    red = stats.get("rediscovery") or {}
    if red:
        print(f"  rediscovery: best adaptive mean rounds "
              f"{red['best_adaptive_mean_rounds']} vs baseline "
              f"{red['baseline_mean_rounds']} -> above_baseline="
              f"{red['above_baseline']}")

    if stats["violations"] > args.slo_violations:
        print(f"SAFETY: {stats['violations']} violation(s) exceed the SLO "
              f"({args.slo_violations}) — see violation_detail")
        return 1
    if steady is not None and steady > 0:
        print(f"STEADY-STATE COMPILES: {steady} != 0 — a hunt candidate "
              "escaped the warmed program universe")
        return 2
    problems = _record.validate_record(doc) + \
        _record.validate_record(reg_doc)
    if problems:
        print("INVALID RECORD: " + "; ".join(problems))
        return 3
    bad = [r for r in doc["replay_check"] if not r["ok"]]
    if bad:
        print(f"REPLAY: {len(bad)} archive entr(ies) failed bit-identical "
              "replay")
        return 4
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
