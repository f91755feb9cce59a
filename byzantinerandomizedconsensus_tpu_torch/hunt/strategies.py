"""Pluggable hunt optimizers behind one ask/tell interface.

The port's copy of the reference ``hunt/strategies.py``, plain
``random.Random`` throughout and unchanged in every draw: under the same
tell sequence each strategy asks the reference's candidates in the
reference's order.

A strategy is a stream transformer: ``ask()`` yields the next candidate
config, ``tell(cfg, fitness)`` feeds an evaluation back. The split is what
lets the hunter pipeline — the loop can ask ahead for generation g+1 while
generation g still occupies lanes, because ask never blocks on outstanding
tells (strategies act on whatever has been told *so far*).

Determinism contract: every strategy draws all randomness from one
``random.Random(f"{name}:{seed}")`` stream (string seeding is stable across
processes), and its behavior is a pure function of the tell sequence — so a
whole hunt is reproducible from ``(strategy, seed)`` given the evaluator is
deterministic (it is: every leg of the server answers bit for bit as the
offline run).

Four strategies ship:

- ``random`` — the seeded baseline: i.i.d. draws from the space, no
  learning. The control every smarter strategy must beat.
- ``evolution`` — mutation+crossover over an elite pool with tournament
  selection; the classic schedule-strength hill climber (the family that
  found ``adaptive_min`` by hand, now automated).
- ``bandit`` — successive halving over space *regions* (adversary ×
  delivery arms): every arm gets a rung of evaluations, the weaker half is
  dropped, the per-arm budget doubles, repeat until one region holds the
  whole budget.
- ``cma`` — a diagonal CMA-style evolution strategy over the numeric axes
  with PBIL-style tables over the categorical ones.
"""

from __future__ import annotations

import random

from byzantinerandomizedconsensus_tpu_torch.hunt.space import (
    _MUTATION_DOMAINS, SearchSpace)


class Strategy:
    """Base ask/tell optimizer; subclasses override ``ask`` and may extend
    ``tell`` (call super so best/evaluations bookkeeping stays right)."""

    name = "base"

    def __init__(self, space: SearchSpace, seed: int):
        self.space = space
        self.seed = int(seed)
        self.rng = random.Random(f"{self.name}:{self.seed}")
        self.evaluations = 0
        self.best_fitness: float | None = None
        self.best_cfg = None

    def ask(self):
        raise NotImplementedError

    def tell(self, cfg, fitness: float) -> None:
        self.evaluations += 1
        if self.best_fitness is None or fitness > self.best_fitness:
            self.best_fitness = float(fitness)
            self.best_cfg = cfg

    def doc(self) -> dict:
        """The run-record ``strategy`` identity sub-block."""
        return {"name": self.name, "seed": self.seed}


class RandomStrategy(Strategy):
    """Seeded i.i.d. sampling — the no-learning control."""

    name = "random"

    def ask(self):
        return self.space.sample(self.rng)


class EvolutionStrategy(Strategy):
    """Elite-pool evolution: tournament-selected parents, uniform
    crossover, single-axis mutation, with a floor of pure exploration so
    the pool can never collapse onto one basin."""

    name = "evolution"

    POOL = 16          #: elite pool size
    TOURNAMENT = 3     #: parents drawn per selection
    P_EXPLORE = 0.2    #: fresh sample probability once the pool is warm
    P_CROSSOVER = 0.5  #: crossover (vs lone mutation) probability
    P_CHILD_MUTATE = 0.3  #: post-crossover mutation probability

    def __init__(self, space: SearchSpace, seed: int):
        super().__init__(space, seed)
        self._pool: list = []  # (fitness, tiebreak, cfg), sorted desc

    def _select(self):
        contenders = [self._pool[self.rng.randrange(len(self._pool))]
                      for _ in range(min(self.TOURNAMENT, len(self._pool)))]
        return max(contenders)[2]

    def ask(self):
        if len(self._pool) < self.TOURNAMENT or \
                self.rng.random() < self.P_EXPLORE:
            return self.space.sample(self.rng)
        if self.rng.random() < self.P_CROSSOVER:
            child = self.space.crossover(self._select(), self._select(),
                                         self.rng)
            if self.rng.random() < self.P_CHILD_MUTATE:
                child = self.space.mutate(child, self.rng)
            return child
        return self.space.mutate(self._select(), self.rng)

    def tell(self, cfg, fitness: float) -> None:
        super().tell(cfg, fitness)
        # tiebreak on arrival order keeps the sort total without comparing
        # configs (SimConfig defines no ordering)
        self._pool.append((float(fitness), -self.evaluations, cfg))
        self._pool.sort(reverse=True)
        del self._pool[self.POOL:]


class BanditStrategy(Strategy):
    """Successive halving over the space's (adversary × delivery) regions:
    round-robin rungs, drop the weaker half by mean fitness, double the
    per-arm budget, repeat to one survivor — then exploit it.

    Tells are attributed to a region by the candidate's own
    (adversary, delivery) axes; a tell for a region already halved away
    (possible under the hunter's ask-ahead pipelining) only updates the
    global best, never a dead arm.
    """

    name = "bandit"

    RUNG0 = 2  #: evaluations per region in the first rung

    def __init__(self, space: SearchSpace, seed: int):
        super().__init__(space, seed)
        self._active = list(space.regions())
        self._per = self.RUNG0
        self._rung = 0
        self._stats = {r: [0, 0.0] for r in self._active}  # count, sum
        self._next = 0

    def ask(self):
        region = self._active[self._next % len(self._active)]
        self._next += 1
        return self.space.sample_region(region, self.rng)

    def tell(self, cfg, fitness: float) -> None:
        super().tell(cfg, fitness)
        region = (cfg.adversary, cfg.delivery)
        stat = self._stats.get(region)
        if stat is None:
            return  # region halved away while this candidate was in flight
        stat[0] += 1
        stat[1] += float(fitness)
        if len(self._active) > 1 and \
                all(self._stats[r][0] >= self._per for r in self._active):
            ranked = sorted(
                self._active,
                key=lambda r: (-(self._stats[r][1] / self._stats[r][0]), r))
            self._active = ranked[:max(1, len(self._active) // 2)]
            self._rung += 1
            self._per *= 2
            self._stats = {r: [0, 0.0] for r in self._active}
            self._next = 0

    def doc(self) -> dict:
        d = super().doc()
        d["rung"] = self._rung
        d["active_regions"] = [list(r) for r in self._active]
        return d


class CmaStrategy(Strategy):
    """CMA-style continuous ask/tell optimizer: a diagonal
    (μ/μ_w, λ) evolution strategy over the numeric axes plus PBIL-style
    categorical tables over the discrete ones.

    Numeric axes (n, f, round_cap rung, crash window rung) live in a
    normalized [0, 1] latent cube: ``ask()`` draws ``x = m + σ ⊙ z`` with
    ``z ~ N(0, I)`` around the adapted mean, decodes through the space's
    repair gate (:meth:`SearchSpace.materialize`), and remembers ``(x, z)``
    per candidate. Every λ tells close a generation: the top-μ candidates
    (log-rank weighted) pull the mean, the per-axis step sizes σ_j adapt by
    the elites' mean squared z (cumulative-step-size adaptation restricted
    to the diagonal — the CMA mechanism that matters at 4 dimensions), and
    the categorical tables relax toward the elite frequencies with a floor
    so no value's probability ever hits zero.

    Pipelining contract: ask never blocks, and a tell whose candidate was
    asked under an already-closed generation still joins the current
    buffer — the update is a pure function of the tell *sequence*, exactly
    like the other strategies. Instances and seed ride along from the
    chaos base draw each ask, so repeated latent points still explore
    fitness noise instead of re-measuring one seed."""

    name = "cma"

    LAMBDA = 12        #: generation size (tells per update)
    MU = 4             #: elites pulling the mean
    SIGMA0 = 0.35      #: initial per-axis step size
    SIGMA_LO, SIGMA_HI = 0.02, 0.6
    C_SIGMA = 0.3      #: per-axis step-size learning rate
    C_CAT = 0.25       #: categorical table learning rate
    CAT_FLOOR = 0.02   #: exploration floor per categorical value

    #: latent (continuous) axes, in cube-coordinate order
    AXES = ("n", "f", "round_cap", "crash_window")
    #: table (categorical) axes, in update order
    CAT_AXES = ("protocol", "adversary", "coin", "init", "delivery",
                "faults")

    def __init__(self, space: SearchSpace, seed: int):
        super().__init__(space, seed)
        self._mean = [0.5] * len(self.AXES)
        self._sigma = [self.SIGMA0] * len(self.AXES)
        self._domains = {a: tuple(_MUTATION_DOMAINS[a])
                         for a in self.CAT_AXES}
        self._tables = {a: [1.0 / len(d)] * len(d)
                        for a, d in self._domains.items()}
        # genome-signature -> [(x, z), …] for in-flight candidates (a list:
        # the same genome can be asked twice under ask-ahead pipelining)
        self._pending: dict = {}
        self._gen_buffer: list = []  # (fitness, -arrival, x, z, genome)
        self.generation = 0

    def _sig(self, genome: dict):
        from byzantinerandomizedconsensus_tpu_torch.hunt.space import GENOME_FIELDS

        return tuple(genome[k] for k in GENOME_FIELDS)

    def _pick(self, axis: str) -> str:
        """One seeded categorical draw from the axis table."""
        u = self.rng.random()
        acc = 0.0
        dom, probs = self._domains[axis], self._tables[axis]
        for v, p in zip(dom, probs):
            acc += p
            if u < acc:
                return v
        return dom[-1]

    def _decode(self, x: list) -> dict:
        """Latent cube point → genome axis values (pre-repair)."""
        def clamp01(v):
            return min(1.0, max(0.0, v))

        n = 4 + int(round(clamp01(x[0]) * (self.space.max_n - 4)))
        out = {"n": n,
               # fraction of n; the repair gate clamps to the resilience
               # ceiling for whatever (protocol, adversary) lands beside it
               "f": int(round(clamp01(x[1]) * n))}
        for j, axis in ((2, "round_cap"), (3, "crash_window")):
            dom = _MUTATION_DOMAINS[axis]
            idx = min(len(dom) - 1, int(clamp01(x[j]) * len(dom)))
            out[axis] = dom[idx]
        return out

    def ask(self):
        from byzantinerandomizedconsensus_tpu_torch.hunt import space as _space

        base = _space.encode(self.space.sample(self.rng))
        z = [self.rng.gauss(0.0, 1.0) for _ in self.AXES]
        x = [m + s * zi for m, s, zi in zip(self._mean, self._sigma, z)]
        genome = dict(base)
        genome.update(self._decode(x))
        for axis in self.CAT_AXES:
            genome[axis] = self._pick(axis)
        cfg = self.space.materialize(genome)
        # remember the latent point under the *repaired* genome — that is
        # the identity tell() will see back
        self._pending.setdefault(self._sig(_space.encode(cfg)),
                                 []).append((x, z))
        return cfg

    def tell(self, cfg, fitness: float) -> None:
        from byzantinerandomizedconsensus_tpu_torch.hunt import space as _space

        super().tell(cfg, fitness)
        genome = _space.encode(cfg)
        entry = self._pending.get(self._sig(genome))
        if not entry:
            return  # replayed/foreign candidate: best-only, like bandit
        x, z = entry.pop(0)
        if not entry:
            del self._pending[self._sig(genome)]
        self._gen_buffer.append((float(fitness), -self.evaluations, x, z,
                                 genome))
        if len(self._gen_buffer) >= self.LAMBDA:
            self._update()

    def _update(self) -> None:
        elites = sorted(self._gen_buffer, reverse=True)[:self.MU]
        self._gen_buffer = []
        self.generation += 1
        import math as _math

        raw = [_math.log(self.MU + 0.5) - _math.log(i + 1)
               for i in range(len(elites))]
        tot = sum(raw)
        w = [r / tot for r in raw]
        for j in range(len(self.AXES)):
            self._mean[j] = min(1.0, max(0.0, sum(
                wi * e[2][j] for wi, e in zip(w, elites))))
            z2 = sum(wi * e[3][j] * e[3][j] for wi, e in zip(w, elites))
            self._sigma[j] = min(self.SIGMA_HI, max(
                self.SIGMA_LO,
                self._sigma[j] * _math.exp(self.C_SIGMA
                                           * (_math.sqrt(z2) - 1.0))))
        for axis in self.CAT_AXES:
            dom = self._domains[axis]
            freq = [sum(wi for wi, e in zip(w, elites)
                        if e[4][axis] == v) for v in dom]
            probs = [(1.0 - self.C_CAT) * p + self.C_CAT * fr
                     for p, fr in zip(self._tables[axis], freq)]
            probs = [max(self.CAT_FLOOR, p) for p in probs]
            s = sum(probs)
            self._tables[axis] = [p / s for p in probs]

    def doc(self) -> dict:
        d = super().doc()
        d["generation"] = self.generation
        d["sigma"] = [round(s, 4) for s in self._sigma]
        d["mean"] = [round(m, 4) for m in self._mean]
        return d


STRATEGIES = {cls.name: cls for cls in
              (RandomStrategy, EvolutionStrategy, BanditStrategy,
               CmaStrategy)}


def make_strategy(name: str, space: SearchSpace, seed: int) -> Strategy:
    """The registry constructor behind ``brc-tpu hunt --strategy``."""
    if name not in STRATEGIES:
        raise ValueError(f"unknown strategy {name!r}; "
                         f"use one of {'|'.join(sorted(STRATEGIES))}")
    return STRATEGIES[name](space, seed)
