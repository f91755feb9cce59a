"""The port's committee family (spec §10: ops/committee.py,
models/committee.py, the committee gates of config.py) against the
reference, bit for bit, tolerance 0 (every output is an integer drawn from
one counter-based PRF): the integer laws C(n), f_C and k_C over a sample of
n up to 2^20; membership and per-step (c0, c1) on random planes made from
numpy seeds, with and without the adaptive family's two strata, at packing
laws v1, v2 and v3; the resilience gates and their messages as
tests/test_committee.py pins them, and committee_point; and whole runs
through the port's round driver against the reference's numpy backend, per
instance, under every adversary and every fault schedule of both protocols,
including n = 1500 (v2) and n = 5000 (v3)."""

import dataclasses

import numpy as np
import pytest
import torch

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.backends import get_backend as ref_get_backend
from byzantinerandomizedconsensus_tpu.models import adversaries as ref_adv
from byzantinerandomizedconsensus_tpu.models import committee as ref_models_committee
from byzantinerandomizedconsensus_tpu.ops import committee as ref_cm
from byzantinerandomizedconsensus_tpu_torch import config
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.models import committee as models_committee
from byzantinerandomizedconsensus_tpu_torch.models import delivery, driver
from byzantinerandomizedconsensus_tpu_torch.ops import committee as cm
from byzantinerandomizedconsensus_tpu_torch.ops import prf

ADVERSARIES = ("none", "crash", "byzantine", "adaptive", "adaptive_min")
FAULTS = ("none", "recover", "partition", "omission")


def _ref(cfg):
    return ref_config.SimConfig(**dataclasses.asdict(cfg))


def test_committee_laws_match_reference_up_to_2_20():
    rng = np.random.default_rng(19)
    ns = sorted({1, 2, 4, 16, 40, 48, 49, 64, 1024, 1025, 2048, 4096, 4097, 8192,
                 100_000, 131_072, (1 << 20) - 1, 1 << 20,
                 *rng.integers(1, (1 << 20) + 1, 200).tolist()})
    for n in ns:
        for f in sorted({0, n // 5, (n - 1) // 3, int(rng.integers(0, n))}):
            want = (ref_cm.committee_size(n), ref_cm.committee_fault_budget(n, f),
                    ref_cm.committee_quota(n, f))
            assert (cm.committee_size(n), cm.committee_fault_budget(n, f),
                    cm.committee_quota(n, f)) == want, (n, f)
    # The values the spec and the round-19 artifact quote.
    assert cm.committee_size(49) == 48 and cm.committee_size(1 << 20) == 160
    assert cm.committee_fault_budget(100_000, 20_000) == 28 + 11


@pytest.mark.parametrize("n,instances", [(64, 4000), (1500, 4000), (5000, 4000),
                                         (1 << 20, 64)])
def test_membership_plane_matches_reference(n, instances):
    cfg = SimConfig(protocol="bracha", n=n, f=n // 5, instances=instances,
                    delivery="committee").validate()
    rng = np.random.default_rng(n)
    inst = rng.choice(instances, 3, replace=False).astype(np.uint32)
    for rnd, t in ((0, 0), (5, 2)):
        want = ref_cm.membership_plane(_ref(cfg), 77, inst, rnd, t, xp=np)
        got = cm.membership_plane(cfg, 77, torch.as_tensor(inst.astype(np.int64)), rnd, t)
        np.testing.assert_array_equal(got.numpy(), want)
        silence = cm.step_silence(cfg, 77, torch.as_tensor(inst.astype(np.int64)), rnd, t)
        np.testing.assert_array_equal(silence.numpy(), ~want)


STEP_CASES = [
    # (adversary, protocol, n, f, B, p_values over {0,1,2}, p_silent)
    ("none", "bracha", 64, 12, 16, (0.5, 0.5, 0.0), 0.0),
    ("none", "bracha", 1500, 300, 2, (0.4, 0.4, 0.2), 0.1),      # packing law v2
    ("none", "bracha", 5000, 1000, 2, (0.5, 0.5, 0.0), 0.0),     # packing law v3
    ("adaptive", "bracha", 64, 12, 12, (0.45, 0.45, 0.1), 0.0),
    ("adaptive", "bracha", 5000, 1000, 2, (0.3, 0.3, 0.4), 0.05),
    ("adaptive_min", "bracha", 1500, 300, 2, (0.8, 0.1, 0.1), 0.0),
    ("byzantine", "benor", 64, 4, 12, (0.4, 0.4, 0.2), 0.1),
    ("byzantine", "benor", 5000, 250, 2, (0.5, 0.5, 0.0), 0.0),
]


@pytest.mark.parametrize("case", STEP_CASES,
                         ids=[f"{c[0]}-{c[1]}-n{c[2]}-p{c[5]}" for c in STEP_CASES])
def test_counts_match_reference(case):
    """Per-step counts on random planes with the membership silence folded
    in, as the round bodies do, and the cost counters: one COMMITTEE drop
    word per receiver with a drop, two or four cheap segments each."""
    adversary, protocol, n, f, B, p_values, p_silent = case
    cfg = SimConfig(protocol=protocol, n=n, f=f, adversary=adversary, instances=4000,
                    delivery="committee").validate()
    rng = np.random.default_rng(n + f + 1)
    for t in range(2):
        seed = int(rng.integers(0, 1 << 62))
        rnd = int(rng.integers(0, 200))
        inst = rng.choice(cfg.instances, B, replace=False).astype(np.uint32)
        honest = rng.choice(3, size=(B, n), p=p_values).astype(np.uint8)
        faulty = ref_adv.faulty_mask(_ref(cfg), seed, inst, xp=np)
        values = honest
        if adversary in ("adaptive", "adaptive_min"):
            minority = ref_adv.observed_minority(honest, faulty, xp=np)
            values = np.where(faulty, minority[:, None], honest).astype(np.uint8)
        silent = (rng.random((B, n)) < p_silent) | ref_cm.step_silence(
            _ref(cfg), seed, inst, rnd, t, xp=np)
        w0, w1 = ref_cm.counts_fn(_ref(cfg), seed, inst, rnd, t, values, silent,
                                  faulty, honest, xp=np)
        stats = {}
        c0, c1 = cm.counts_fn(cfg, seed, torch.as_tensor(inst.astype(np.int64)), rnd, t,
                              *(torch.as_tensor(x) for x in (values, silent, faulty,
                                                             honest)),
                              stats=stats)
        assert c0.dtype == torch.int32 and c1.dtype == torch.int32
        np.testing.assert_array_equal(c0.numpy(), w0)
        np.testing.assert_array_equal(c1.numpy(), w1)
        segments = 4 if adversary in ("adaptive", "adaptive_min") else 2
        np.testing.assert_array_equal(stats["cheap_segments"].numpy(),
                                      segments * stats["committee_draws"].numpy())


def test_quorum_params_and_gate_match_reference():
    full = SimConfig(protocol="bracha", n=64, f=10, instances=4,
                     adversary="byzantine", delivery="urn2").validate()
    assert models_committee.quorum_params(full) == (64, 10)
    comm = dataclasses.replace(full, delivery="committee").validate()
    assert models_committee.quorum_params(comm) == \
        ref_models_committee.quorum_params(_ref(comm)) == (48, 14)
    assert cm.step_silence(full, 0, torch.arange(2), 0, 0) is None
    with pytest.raises(models_committee.CommitteeUnsupported,
                       match="the per-step delivery kernels has no committee channel"):
        delivery.make_counts(comm, 0, torch.arange(2), 0, {"faulty": None},
                             counts_fn=lambda *a: None)


@pytest.mark.parametrize("protocol,f,adversary,ok", [
    ("bracha", 13, "byzantine", False), ("bracha", 12, "byzantine", True),
    ("benor", 5, "byzantine", False), ("benor", 4, "byzantine", True),
    ("benor", 23, "crash", False), ("benor", 22, "crash", True),
    ("benor", 5, "adaptive_min", False), ("bracha", 13, "none", False),
])
def test_committee_resilience_gates_match_reference(protocol, f, adversary, ok):
    """The (C, f_C) gates at n = 64 (C = 48), with the reference's messages
    verbatim."""
    fields = dict(protocol=protocol, n=64, f=f, instances=4, adversary=adversary,
                  delivery="committee")
    if ok:
        assert config.SimConfig(**fields).validate() == config.SimConfig(**fields)
        ref_config.SimConfig(**fields).validate()
        return
    with pytest.raises(ValueError) as want:
        ref_config.SimConfig(**fields).validate()
    with pytest.raises(ValueError) as got:
        config.SimConfig(**fields).validate()
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("committee resilience:")


@pytest.mark.parametrize("n", [1024, 2048, 8192, 131_072, 1 << 20])
def test_committee_point_and_extended_sweep_match_reference(n):
    assert dataclasses.asdict(config.committee_point(n)) == \
        dataclasses.asdict(ref_config.committee_point(n))
    assert config.COMMITTEE_FAULT_DIV == ref_config.COMMITTEE_FAULT_DIV
    assert config.SWEEP_NS_EXTENDED == ref_config.SWEEP_NS_EXTENDED
    assert config.committee_point(n).pack_version == prf.pack_version(n)


def _f(protocol, n, adversary):
    """A resilient f: n/5 under Bracha, n/16 under Ben-Or's Protocol B and
    n/6 under its Protocol A (C = 48 at n = 64)."""
    lying = adversary in ("byzantine", "adaptive", "adaptive_min")
    return n // 5 if protocol == "bracha" else (n // 16 if lying else n // 6)


DRIVER_CASES = [(p, a, k) for p in ("bracha", "benor") for a in ADVERSARIES for k in FAULTS]


@pytest.mark.parametrize("protocol,adversary,faults", DRIVER_CASES,
                         ids=["-".join(c) for c in DRIVER_CASES])
def test_driver_matches_reference_per_instance(protocol, adversary, faults):
    """The port's round driver under committee at n = 64 (C = 48) against
    the reference's numpy backend on the same ids, every init law in turn,
    both coins."""
    i = ADVERSARIES.index(adversary) + FAULTS.index(faults)
    cfg = SimConfig(protocol=protocol, n=64, f=_f(protocol, 64, adversary), instances=12,
                    adversary=adversary, coin=("shared", "local")[i % 2],
                    init=("random", "all0", "all1", "split")[i % 4],
                    delivery="committee", round_cap=24, faults=faults,
                    seed=51 + i).validate()
    want = ref_get_backend("numpy").run(_ref(cfg))
    rounds, decision = driver.run_chunk(cfg, torch.arange(cfg.instances, dtype=torch.int32))
    np.testing.assert_array_equal(rounds.numpy(), want.rounds)
    np.testing.assert_array_equal(decision.numpy(), want.decision)


@pytest.mark.parametrize("n,protocol,adversary,faults", [
    (1500, "bracha", "none", "none"), (1500, "benor", "byzantine", "recover"),
    (5000, "bracha", "adaptive", "none"), (5000, "bracha", "crash", "partition"),
    (5000, "benor", "adaptive_min", "omission"),
])
def test_driver_matches_reference_past_v1(n, protocol, adversary, faults):
    """n = 1500 (packing law v2) and n = 5000 (v3), a few instances."""
    cfg = SimConfig(protocol=protocol, n=n, f=_f(protocol, n, adversary), instances=3,
                    adversary=adversary, coin="local" if protocol == "benor" else "shared",
                    delivery="committee", round_cap=8, faults=faults).validate()
    want = ref_get_backend("numpy").run(_ref(cfg))
    rounds, decision = driver.run_chunk(cfg, torch.arange(3, dtype=torch.int32))
    np.testing.assert_array_equal(rounds.numpy(), want.rounds)
    np.testing.assert_array_equal(decision.numpy(), want.decision)
