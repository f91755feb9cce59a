"""The hunter's search space.

The port's copy of the reference ``hunt/space.py``, draw for draw: for every
``(committee_scale, seed)`` its ``sample``, ``mutate``, ``crossover`` and
``sample_region`` draw the same candidates in the same order as the
reference, so a hunt is reproducible by ``(strategy, seed)`` in either
package. One declarative object owns the joint adversary kind × spec-§9
fault-schedule × delivery law × shape (n, f, round_cap) axes. Everything a
strategy can propose flows through here, and three rules keep proposals
honest:

1. **Shared laws.** ``sample()`` delegates to the chaos generator's seam
   (tools/sampler.py, the same ``(GENERATOR_VERSION, seed)`` contract the
   soak pins): a config the hunter can draw is by construction one the
   chaos soak could have drawn, so hunt and soak can never drift.
2. **One admissibility gate.** Every candidate (sampled, mutated, or
   crossed over) decodes through ``SimConfig.validate()``; a genome the
   gate rejects never reaches the server. Mutation and crossover *repair*
   (clamping f to the resilience ceiling, demoting the adversary when the
   shape cannot host one) before the gate, so strategies always receive
   admissible candidates, never exceptions.
3. **Serving-shaped by construction.** n ≤ 40 folds every candidate into
   the FUSED_SMALL_TIER, and round_cap ≤ 128 fits the default feed
   ceiling: the *entire* bucket universe of the space is the 10-element
   product (2 protocols × 5 deliveries), enumerable by :meth:`buckets`
   for a complete warm-up of the lane leg. On the direct leg the build
   surface is the kernel libraries those candidates reach instead
   (hunt/hunter.py warms one config per library).

**Committee scale (opt-in).** ``SearchSpace(committee_scale=True)``
admits the §10 ``delivery="committee"`` family past the n ≤ 40 fold, at
committee-scale n (10³–10⁵). Rule 3 survives because committee candidates
are pinned to the pow2 bucket tiers (:data:`COMMITTEE_N_TIERS`, a subset of
``backends.batch.N_TIERS``): the universe grows by exactly 2 protocols ×
len(tiers) buckets, still closed and warmable before measurement. Repair
snaps any off-tier committee n up to its tier and holds f under the
spec-§10.3 sortition ceiling (k·f_C < C inverted for f), so the gate never
fires; a mutation that leaves the committee family clamps n back to the
full-mesh fold. Default ``False`` keeps the 10-bucket universe.
"""

from __future__ import annotations

import math
import random

from byzantinerandomizedconsensus_tpu_torch.backends.batch import FusedBucket, n_tier
from byzantinerandomizedconsensus_tpu_torch.config import (
    DELIVERY_KINDS, FAULT_KINDS, SimConfig)
from byzantinerandomizedconsensus_tpu_torch.ops import committee as _committee
from byzantinerandomizedconsensus_tpu_torch.tools import sampler as _sampler

# Genome field order — also the crossover axis order, so it is part of the
# determinism contract (reordering changes draw sequences).
GENOME_FIELDS = ("protocol", "n", "f", "instances", "adversary", "coin",
                 "init", "seed", "round_cap", "delivery", "faults",
                 "crash_window")

#: The committee-scale n tiers: pow2 members of
#: ``backends.batch.N_TIERS`` spanning 10³–10⁵, the §10 sortition regime
#: where C(n) < n. Candidates land *exactly* on a tier, so each adds one
#: bucket per protocol and the warm-up universe stays closed.
COMMITTEE_N_TIERS = (1024, 4096, 16384, 65536)


def _committee_f_ceiling(protocol: str, adversary: str, n: int) -> int:
    """Largest f whose spec-§10.3 sortition bound holds: invert
    f_C = ⌈C·f/n⌉ + ⌊√C⌋ under k·f_C < C (k = 3 bracha, 5 benor+lying,
    2 benor). Degenerate committees (C = n) defer to the full-mesh
    ceilings — thresholds reduce to the plain §5 laws there."""
    c = _committee.committee_size(n)
    if c >= n:
        return n
    lying = adversary in ("byzantine", "adaptive", "adaptive_min")
    k = 3 if protocol == "bracha" else (5 if lying else 2)
    margin = (c - 1) // k - math.isqrt(c)
    if margin < 1:
        return 0
    return min(n - 1, margin * n // c)


#: per-axis mutation domains (f and seed are handled specially)
_MUTATION_DOMAINS = {
    "protocol": _sampler._PROTOCOLS,
    "adversary": _sampler._ADVERSARIES,
    "coin": _sampler._COINS,
    "init": _sampler._INITS,
    "round_cap": _sampler._ROUND_CAPS,
    "delivery": DELIVERY_KINDS,
    "faults": FAULT_KINDS,
    "crash_window": _sampler._CHAOS_WINDOWS,
}


def encode(cfg: SimConfig) -> dict:
    """Config → genome: the mutable dict representation strategies edit."""
    return {k: getattr(cfg, k) for k in GENOME_FIELDS}


def decode(genome: dict) -> SimConfig:
    """Genome → admissible config, through the one ``validate()`` gate."""
    return SimConfig(**{k: genome[k] for k in GENOME_FIELDS}).validate()


class SearchSpace:
    """The declarative candidate space; all randomness comes from the
    caller's ``random.Random`` so strategies stay deterministic from
    ``(strategy, seed)``."""

    generator_version = _sampler.GENERATOR_VERSION
    max_n = _sampler.MAX_SOAK_N
    max_committee_n = COMMITTEE_N_TIERS[-1]

    def __init__(self, committee_scale: bool = False):
        self.committee_scale = bool(committee_scale)

    def sample(self, rng: random.Random) -> SimConfig:
        """One seeded draw — the chaos generator's laws, verbatim."""
        return _sampler.random_config(rng, chaos=True)

    def _fmax(self, protocol: str, adversary: str, n: int,
              delivery: str) -> int:
        """The joint f ceiling: the full-mesh resilience bound, tightened
        by the §10.3 sortition bound when the delivery is committee."""
        fmax = _sampler._f_ceiling(protocol, adversary, n)
        if delivery == "committee":
            fmax = min(fmax, _committee_f_ceiling(protocol, adversary, n))
        return fmax

    def _repair(self, genome: dict) -> dict:
        """Clamp a mutated/crossed genome back into the admissible region:
        n back under the fold (or snapped up to its pow2 committee tier),
        f into the resilience ceiling for (protocol, adversary, n,
        delivery), the adversary demoted to "none" when the shape cannot
        host a faulty set. Same ceilings the sampler redraws against."""
        if genome["n"] > self.max_n:
            if self.committee_scale and genome["delivery"] == "committee":
                genome["n"] = n_tier(genome["n"])
            else:
                genome["n"] = self.max_n
        fmax = self._fmax(genome["protocol"], genome["adversary"],
                          genome["n"], genome["delivery"])
        if fmax < 1 and genome["adversary"] != "none":
            genome["adversary"] = "none"
            fmax = self._fmax(genome["protocol"], "none",
                              genome["n"], genome["delivery"])
        lo = 0 if genome["adversary"] == "none" else 1
        genome["f"] = min(max(int(genome["f"]), lo), fmax)
        return genome

    def mutate(self, cfg: SimConfig, rng: random.Random) -> SimConfig:
        """Redraw one axis of ``cfg`` (uniform over axes), repair, decode."""
        genome = encode(cfg)
        axis = rng.choice(GENOME_FIELDS)
        if axis == "n":
            if self.committee_scale and genome["delivery"] == "committee":
                genome["n"] = rng.choice(
                    tuple(range(4, self.max_n + 1)) + COMMITTEE_N_TIERS)
            else:
                genome["n"] = rng.randrange(4, self.max_n + 1)
        elif axis == "f":
            fmax = self._fmax(genome["protocol"], genome["adversary"],
                              genome["n"], genome["delivery"])
            lo = 0 if genome["adversary"] == "none" else 1
            if fmax >= lo:
                genome["f"] = rng.randrange(lo, fmax + 1)
        elif axis == "instances":
            genome["instances"] = rng.randrange(
                *_sampler._INSTANCES_RANGE)
        elif axis == "seed":
            genome["seed"] = rng.randrange(1 << 32)
        else:
            genome[axis] = rng.choice(_MUTATION_DOMAINS[axis])
        return decode(self._repair(genome))

    def crossover(self, a: SimConfig, b: SimConfig,
                  rng: random.Random) -> SimConfig:
        """Uniform per-axis recombination of two parents, repaired."""
        ga, gb = encode(a), encode(b)
        child = {k: (ga if rng.random() < 0.5 else gb)[k]
                 for k in GENOME_FIELDS}
        return decode(self._repair(child))

    def materialize(self, genome: dict) -> SimConfig:
        """Repair + decode a strategy-built genome through the one
        admissibility gate — the seam continuous strategies (hunt/
        strategies.py ``cma``) use to land arbitrary latent points inside
        the admissible region without re-implementing the repair laws."""
        return decode(self._repair(dict(genome)))

    def regions(self) -> list:
        """The successive-halving bandit's arms: the adversary × delivery
        product — the axes the hunt question is *about* (which adversary
        under which delivery law is worst)."""
        return [(adv, d) for adv in _sampler._ADVERSARIES
                for d in DELIVERY_KINDS]

    def sample_region(self, region, rng: random.Random) -> SimConfig:
        """One draw pinned to a region: the shared laws for every other
        axis, the region's (adversary, delivery) forced, then repaired —
        the bandit's within-arm sampler."""
        adversary, delivery = region
        genome = encode(self.sample(rng))
        genome["adversary"] = adversary
        genome["delivery"] = delivery
        # Grow the shape rather than let repair demote the forced adversary
        # (benor + a lying set needs n ≥ 6): region attribution must hold.
        while adversary != "none" and _sampler._f_ceiling(
                genome["protocol"], adversary, genome["n"]) < 1:
            genome["n"] += 1
        return decode(self._repair(genome))

    def buckets(self) -> list:
        """The complete bucket universe of this space: n ≤ 40 folds every
        candidate to the small fused tier, so 2 protocols × 5 deliveries is
        *all* the lane programs a hunt can touch. The hunter warms exactly
        these before measuring, which is why the 0-steady-state-build pin
        is meaningful."""
        probe = []
        for protocol in _sampler._PROTOCOLS:
            for delivery in DELIVERY_KINDS:
                cfg = SimConfig(
                    protocol=protocol, n=7, f=1, instances=8,
                    adversary="crash", round_cap=32,
                    delivery=delivery).validate()
                probe.append(FusedBucket.of(cfg))
        if self.committee_scale:
            # the committee-scale wing: one bucket per (protocol, tier);
            # candidates land exactly on COMMITTEE_N_TIERS, so this closes
            # the universe at 10 + 2·len(tiers)
            for protocol in _sampler._PROTOCOLS:
                for tier in COMMITTEE_N_TIERS:
                    cfg = SimConfig(
                        protocol=protocol, n=tier, f=1, instances=8,
                        adversary="crash", round_cap=32,
                        delivery="committee").validate()
                    probe.append(FusedBucket.of(cfg))
        return probe

    def doc(self) -> dict:
        """The run-record ``space`` sub-block (schema v1.8)."""
        return {
            "generator_version": self.generator_version,
            "max_n": self.max_n,
            "committee_scale": self.committee_scale,
            "committee_n_tiers": list(COMMITTEE_N_TIERS)
            if self.committee_scale else [],
            "protocols": list(_sampler._PROTOCOLS),
            "adversaries": list(_sampler._ADVERSARIES),
            "deliveries": list(DELIVERY_KINDS),
            "faults": list(FAULT_KINDS),
            "round_caps": list(_sampler._ROUND_CAPS),
            "regions": len(self.regions()),
            "buckets": len(self.buckets()),
        }
