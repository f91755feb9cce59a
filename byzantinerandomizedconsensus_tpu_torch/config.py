"""SimConfig and the benchmark presets (spec/PROTOCOL.md §7).

The port's own copy of the reference package's ``config.py``: the same
fields, defaults, validation rules and messages, so a config built here
draws exactly what the same config draws in the reference, the committee
family's resilience check in (C, f_C) included (spec §10.3).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

from byzantinerandomizedconsensus_tpu_torch.ops import prf

Protocol = Literal["benor", "bracha"]
AdversaryKind = Literal["none", "crash", "byzantine", "adaptive", "adaptive_min"]
CoinKind = Literal["local", "shared"]
InitKind = Literal["random", "all0", "all1", "split"]
DeliveryKind = Literal["keys", "urn", "urn2", "urn3", "committee"]
FaultKind = Literal["none", "recover", "partition", "omission"]

COUNT_LEVEL_DELIVERIES = ("urn", "urn2", "urn3", "committee")
DELIVERY_KINDS = ("keys",) + COUNT_LEVEL_DELIVERIES
FAULT_KINDS = ("none", "recover", "partition", "omission")
DEFAULT_ROUND_CAP = 256


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """One simulation configuration (spec/PROTOCOL.md §7).

    ``delivery`` defaults to ``"keys"`` as in the reference; every preset
    pins the product model :data:`PRODUCT_DELIVERY` instead.
    """

    protocol: Protocol = "benor"
    n: int = 4
    f: int = 1
    instances: int = 1
    adversary: AdversaryKind = "none"
    coin: CoinKind = "local"
    seed: int = 0
    round_cap: int = DEFAULT_ROUND_CAP
    crash_window: int = 4
    init: InitKind = "random"
    delivery: DeliveryKind = "keys"
    faults: FaultKind = "none"

    @property
    def steps_per_round(self) -> int:
        return 2 if self.protocol == "benor" else 3

    @property
    def n_eff(self) -> int:
        """The value of n in protocol arithmetic (equal to ``n`` for a plain
        config; the reference's batched lanes substitute a padded view)."""
        return self.n

    @property
    def count_level(self) -> bool:
        """True for the count-domain delivery models (§4b, §4b-v2, §4c, §10)."""
        return self.delivery in COUNT_LEVEL_DELIVERIES

    @property
    def lying_adversary(self) -> bool:
        """Selects Ben-Or Protocol B thresholds (spec §5.1)."""
        return self.adversary in ("byzantine", "adaptive", "adaptive_min")

    @property
    def pack_version(self) -> int:
        """The spec §2 packing law this config draws under (a function of n)."""
        return prf.pack_version(self.n)

    def validate(self) -> "SimConfig":
        if self.delivery not in DELIVERY_KINDS:
            raise ValueError(
                f"unknown delivery {self.delivery!r}; "
                f"use one of {'|'.join(DELIVERY_KINDS)}")
        if self.faults not in FAULT_KINDS:
            raise ValueError(
                f"unknown faults {self.faults!r}; "
                f"use one of {'|'.join(FAULT_KINDS)}")
        if self.crash_window < 1:
            raise ValueError(
                f"crash_window={self.crash_window} out of range (>= 1); "
                "the §3.3/§9 schedules draw rounds mod crash_window")
        if not (0 < self.n <= prf.MAX_N):
            raise ValueError(f"n={self.n} out of range (1..{prf.MAX_N})")
        if self.n > prf.V2_MAX_N and self.delivery != "committee":
            raise ValueError(
                f"n={self.n} exceeds the full-mesh ceiling ({prf.V2_MAX_N}); "
                f"only delivery='committee' (spec §10) runs under the §2 v3 "
                f"packing law (got delivery={self.delivery!r})")
        if not (0 <= self.f < self.n):
            raise ValueError(f"f={self.f} out of range for n={self.n}")
        max_inst = {1: prf.MAX_INSTANCES, 2: prf.V2_MAX_INSTANCES,
                    3: prf.V3_MAX_INSTANCES}[self.pack_version]
        max_rounds = {1: prf.MAX_ROUNDS, 2: prf.V2_MAX_ROUNDS,
                      3: prf.V3_MAX_ROUNDS}[self.pack_version]
        if not (0 < self.instances <= max_inst):
            raise ValueError(
                f"instances={self.instances} out of range (1..{max_inst}) "
                f"under packing v{self.pack_version} (n={self.n}): the spec "
                f"§2 v{self.pack_version} law packs instance ids in "
                f"{ {1: 17, 2: 16, 3: 12}[self.pack_version] } bits — chunk "
                "sizing (backends/torch_backend.py::chunk_size) is clamped to "
                "the same ceiling")
        if not (0 < self.round_cap <= max_rounds):
            raise ValueError(
                f"round_cap={self.round_cap} out of range (1..{max_rounds}) "
                f"under packing v{self.pack_version} (n={self.n})")
        if self.protocol == "bracha":
            if 3 * self.f >= self.n:
                raise ValueError(f"bracha requires n > 3f (got n={self.n}, f={self.f})")
        elif self.lying_adversary:
            if 5 * self.f >= self.n:
                raise ValueError(
                    f"benor+{self.adversary} requires n > 5f (got n={self.n}, f={self.f}); "
                    "use protocol='bracha' for n > 3f resilience"
                )
        elif 2 * self.f >= self.n:
            raise ValueError(f"benor requires n > 2f (got n={self.n}, f={self.f})")
        if self.delivery == "committee":
            # Committee resilience (spec §10.3): the thresholds count committee
            # messages, so the protocol's bound must hold in (C, f_C).
            from byzantinerandomizedconsensus_tpu_torch.ops import committee as _cm

            c = _cm.committee_size(self.n)
            fc = _cm.committee_fault_budget(self.n, self.f)
            if self.protocol == "bracha":
                if 3 * fc >= c:
                    raise ValueError(
                        f"committee resilience: bracha requires 3·f_C < C, "
                        f"got C={c}, f_C={fc} (n={self.n}, f={self.f}; spec "
                        f"§10.3 — lower f to restore the sortition margin)")
            elif self.lying_adversary:
                if 5 * fc >= c:
                    raise ValueError(
                        f"committee resilience: benor+{self.adversary} "
                        f"requires 5·f_C < C, got C={c}, f_C={fc} "
                        f"(n={self.n}, f={self.f}; spec §10.3)")
            elif 2 * fc >= c:
                raise ValueError(
                    f"committee resilience: benor requires 2·f_C < C, got "
                    f"C={c}, f_C={fc} (n={self.n}, f={self.f}; spec §10.3)")
        return self


def validate_batch(cfgs) -> list["SimConfig"]:
    """Validate a batched lane request: every config on its own, and the
    batch servable by one program, which runs one delivery law and one spec
    §2 packing law. A request that mixes either is rejected with the
    reference's message. Returns the validated configs."""
    cfgs = [c.validate() for c in cfgs]
    if not cfgs:
        raise ValueError("empty batch: at least one config is required")
    d0 = cfgs[0].delivery
    for c in cfgs[1:]:
        if c.delivery != d0:
            raise ValueError(
                f"batch mixes delivery laws {d0!r} and {c.delivery!r}: one "
                "lane bucket runs one delivery law (split the batch per "
                "delivery, or use run_many to auto-group)")
    p0 = cfgs[0].pack_version
    for c in cfgs[1:]:
        if c.pack_version != p0:
            raise ValueError(
                f"batch mixes spec §2 packing versions v{p0} and "
                f"v{c.pack_version}: one lane bucket draws under one packing "
                "law (split the batch at the n = 1024 packing edge, or use "
                "run_many to auto-group)")
    return cfgs


# The product scheduling model: what every preset pins (spec §4b-v2).
PRODUCT_DELIVERY = "urn2"

PRESETS: dict[str, SimConfig] = {
    "config1": SimConfig(protocol="benor", n=4, f=1, instances=1, adversary="none", coin="local", delivery=PRODUCT_DELIVERY),
    "config2": SimConfig(protocol="benor", n=64, f=21, instances=10_000, adversary="crash", coin="local", delivery=PRODUCT_DELIVERY),
    "config3": SimConfig(protocol="bracha", n=256, f=85, instances=1_000, adversary="byzantine", coin="shared", delivery=PRODUCT_DELIVERY),
    "config4": SimConfig(protocol="bracha", n=512, f=170, instances=100_000, adversary="none", coin="shared", delivery=PRODUCT_DELIVERY),
}


def preset(name: str, **overrides) -> SimConfig:
    cfg = PRESETS[name]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg.validate()


def _f_opt(n: int) -> int:
    return (n - 1) // 3


# Config 5 is a sweep (spec §7): bracha, adaptive adversary, shared coin.
SWEEP_NS = (128, 256, 384, 512, 640, 768, 896, 1024)
# The opt-in extension past the v1 packing edge (spec §2 v2).
SWEEP_NS_EXTENDED = SWEEP_NS + (2048,)
SWEEP_INSTANCES = 2_000
# The single sweep point that stands in for config 5 where one config is
# needed: benchmark n, the headline scale.
SWEEP_POINT_N = 512


def sweep_point(n: int, seed: int = 0, instances: int = SWEEP_INSTANCES) -> SimConfig:
    return SimConfig(
        protocol="bracha", n=n, f=_f_opt(n), instances=instances,
        adversary="adaptive", coin="shared", seed=seed,
        delivery=PRODUCT_DELIVERY,
    ).validate()


# The committee benchmark fault fraction (spec §10.3): f = n/5, the largest
# simple fraction that keeps every committee size resilient for Bracha once
# f_C carries its +sqrt(C) sampling margin.
COMMITTEE_FAULT_DIV = 5


def committee_point(n: int, seed: int = 0,
                    instances: int = SWEEP_INSTANCES) -> SimConfig:
    """Config 5's shape under the committee family (spec §10): Bracha,
    adaptive adversary, shared coin, with f = n/5."""
    return SimConfig(
        protocol="bracha", n=n, f=n // COMMITTEE_FAULT_DIV,
        instances=instances, adversary="adaptive", coin="shared", seed=seed,
        delivery="committee",
    ).validate()
