"""The shared config-sampling seam: the seeded random-config law of the
chaos soak (``tools/soak.py``) and the load generator's chaos-like
population (``tools/loadgen.py``).

The port's copy of the reference ``tools/sampler.py``, draw for draw: for
every ``(seed, chaos)`` it draws the same ``SimConfig`` fields in the same
order as the reference, so an artifact's population reproduces by
``(GENERATOR_VERSION, seed)`` in either package: protocol → adversary → n
→ f → instances → coin → init → seed → round_cap → delivery, with the
chaos fault axis (faults, crash_window) drawn *after* them, so a non-chaos
population of a ``(generator_version, seed)`` pair never moves.
"""

from __future__ import annotations

import dataclasses
import random

from byzantinerandomizedconsensus_tpu_torch.config import (
    DELIVERY_KINDS, FAULT_KINDS, SimConfig)

# Bumped whenever the draw sequence below changes shape: an artifact's config
# population is reproducible only by (generator_version, seed) together —
# plus the chaos flag: chaos appends fault-axis draws *after* the legacy
# sequence, so non-chaos populations are unchanged since v1.
# v2: DELIVERY_KINDS gained "committee" (spec §10) — the delivery choice
# draws over a 5-element domain, which moves every population after it.
GENERATOR_VERSION = 2

MAX_SOAK_N = 40

_PROTOCOLS = ("benor", "bracha")
_ADVERSARIES = ("none", "crash", "byzantine", "adaptive", "adaptive_min")
_COINS = ("local", "shared")
_INITS = ("random", "all0", "all1", "split")
_CHAOS_WINDOWS = (1, 2, 4, 8, 16)
_ROUND_CAPS = (32, 64, 128)
_INSTANCES_RANGE = (8, 33)          # randrange bounds: 8..32 inclusive


def _f_ceiling(protocol: str, adversary: str, n: int) -> int:
    """Largest valid f for the resilience bound (config.validate §5.1/§5.2)."""
    lying = adversary in ("byzantine", "adaptive", "adaptive_min")
    if protocol == "bracha":
        return (n - 1) // 3
    if lying:
        return (n - 1) // 5
    return (n - 1) // 2


def random_config(rng: random.Random, chaos: bool = False) -> SimConfig:
    """One uniform-ish draw over the supported semantic surface, n ≤ 40.

    ``chaos`` appends the spec-§9 fault axis (all four kinds, "none"
    included as the in-population baseline) and a crash_window draw covering
    the window edges — appended *after* the legacy draws, so the non-chaos
    population of a (generator_version, seed) pair never moves.
    """
    while True:
        protocol = rng.choice(_PROTOCOLS)
        adversary = rng.choice(_ADVERSARIES)
        n = rng.randrange(4, MAX_SOAK_N + 1)
        fmax = _f_ceiling(protocol, adversary, n)
        if fmax < 1 and adversary != "none":
            continue  # too small to host a faulty set; redraw
        f = rng.randrange(0, fmax + 1) if adversary == "none" \
            else rng.randrange(1, fmax + 1)
        cfg = SimConfig(
            protocol=protocol, n=n, f=f,
            instances=rng.randrange(*_INSTANCES_RANGE),
            adversary=adversary,
            coin=rng.choice(_COINS),
            init=rng.choice(_INITS),
            seed=rng.randrange(1 << 32),
            round_cap=rng.choice(_ROUND_CAPS),
            delivery=rng.choice(DELIVERY_KINDS),
        )
        if chaos:
            cfg = dataclasses.replace(
                cfg, faults=rng.choice(FAULT_KINDS),
                crash_window=rng.choice(_CHAOS_WINDOWS))
        return cfg.validate()
