"""The port's §4c urn3 law (ops/urn3.py) against the reference's numpy
sampler, bit for bit, tolerance 0 (every output is an integer drawn from one
counter-based PRF): the cheap segment on random operands, per-step (c0, c1)
on random planes made from numpy seeds, with and without the adaptive
family's two strata and under Ben-Or's two-faced classes, at packing laws
v1 and v2; and whole runs through the port's round driver against the
reference's numpy backend, per instance, under every adversary and every
fault schedule of both protocols."""

import dataclasses

import numpy as np
import pytest
import torch

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.backends import get_backend as ref_get_backend
from byzantinerandomizedconsensus_tpu.models import adversaries as ref_adv
from byzantinerandomizedconsensus_tpu.ops import urn3 as ref_urn3
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.models import driver
from byzantinerandomizedconsensus_tpu_torch.ops import urn3

ADVERSARIES = ("none", "crash", "byzantine", "adaptive", "adaptive_min")
FAULTS = ("none", "recover", "partition", "omission")


def _ref(cfg):
    return ref_config.SimConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("seg", [0, 1, 2, 3])
def test_cheap_segment_matches_reference(seg):
    rng = np.random.default_rng(70 + seg)
    B, R = 32, 64
    Lr = rng.integers(0, 4096, (B, R)).astype(np.int32)
    m = (rng.random((B, R)) * (Lr + 1)).astype(np.int32)
    Dr = (rng.random((B, R)) * (Lr + 1)).astype(np.int32)
    u = rng.integers(0, 1 << 32, (B, R), dtype=np.uint64).astype(np.uint32)
    want = ref_urn3._cheap(u, seg, m, Lr, Dr, np)
    got = urn3._cheap(torch.as_tensor(u.astype(np.int64)), seg, torch.as_tensor(m),
                      torch.as_tensor(Lr), torch.as_tensor(Dr))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


STEP_CASES = [
    # (adversary, protocol, n, f, B, p_values over {0,1,2}, p_silent)
    ("none", "bracha", 4, 1, 16, (0.5, 0.5, 0.0), 0.0),
    ("none", "bracha", 16, 5, 16, (0.2, 0.7, 0.1), 0.1),
    ("none", "bracha", 512, 170, 4, (0.3, 0.3, 0.4), 0.1),
    ("none", "bracha", 1500, 499, 2, (0.5, 0.5, 0.0), 0.05),   # packing law v2
    ("adaptive", "bracha", 13, 4, 12, (0.45, 0.45, 0.1), 0.0),
    ("adaptive", "bracha", 512, 170, 3, (0.2, 0.2, 0.6), 0.2),
    ("adaptive_min", "bracha", 64, 21, 6, (0.8, 0.1, 0.1), 0.0),
    ("adaptive_min", "bracha", 2048, 682, 2, (0.4, 0.4, 0.2), 0.1),
    ("byzantine", "benor", 16, 3, 12, (0.4, 0.4, 0.2), 0.1),
    ("byzantine", "benor", 1500, 299, 2, (0.5, 0.5, 0.0), 0.0),
]


@pytest.mark.parametrize("case", STEP_CASES,
                         ids=[f"{c[0]}-{c[1]}-n{c[2]}-p{c[5]}" for c in STEP_CASES])
def test_counts_match_reference(case):
    """Per-step counts on random planes, with the cost counters: one URN3
    word per receiver with a drop, two or four cheap segments each."""
    adversary, protocol, n, f, B, p_values, p_silent = case
    cfg = SimConfig(protocol=protocol, n=n, f=f, adversary=adversary,
                    instances=4000, delivery="urn3").validate()
    rng = np.random.default_rng(n + f)
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
        silent = rng.random((B, n)) < p_silent
        w0, w1 = ref_urn3.counts_fn(_ref(cfg), seed, inst, rnd, t, values, silent,
                                    faulty, honest, xp=np)
        stats = {}
        c0, c1 = urn3.counts_fn(cfg, seed, torch.as_tensor(inst.astype(np.int64)), rnd, t,
                                *(torch.as_tensor(x) for x in (values, silent, faulty,
                                                               honest)),
                                stats=stats)
        assert c0.dtype == torch.int32 and c1.dtype == torch.int32
        np.testing.assert_array_equal(c0.numpy(), w0)
        np.testing.assert_array_equal(c1.numpy(), w1)
        assert (stats["urn3_words"] <= n).all()
        segments = 4 if adversary in ("adaptive", "adaptive_min") else 2
        np.testing.assert_array_equal(stats["cheap_segments"].numpy(),
                                      segments * stats["urn3_words"].numpy())


def _f(protocol, n, adversary):
    lying = adversary in ("byzantine", "adaptive", "adaptive_min")
    return (n - 1) // 3 if protocol == "bracha" else (n - 1) // (5 if lying else 2)


DRIVER_CASES = [(p, a, k) for p in ("bracha", "benor") for a in ADVERSARIES for k in FAULTS]


@pytest.mark.parametrize("protocol,adversary,faults", DRIVER_CASES,
                         ids=["-".join(c) for c in DRIVER_CASES])
def test_driver_matches_reference_per_instance(protocol, adversary, faults):
    """The port's round driver under urn3 against the reference's numpy
    backend on the same ids, every init law in turn, both coins."""
    n = 13 if protocol == "bracha" else 16
    i = ADVERSARIES.index(adversary) + FAULTS.index(faults)
    cfg = SimConfig(protocol=protocol, n=n, f=_f(protocol, n, adversary), instances=12,
                    adversary=adversary, coin=("shared", "local")[i % 2],
                    init=("random", "all0", "all1", "split")[i % 4], delivery="urn3",
                    round_cap=24, faults=faults, seed=31 + i).validate()
    want = ref_get_backend("numpy").run(_ref(cfg))
    rounds, decision = driver.run_chunk(cfg, torch.arange(cfg.instances, dtype=torch.int32))
    np.testing.assert_array_equal(rounds.numpy(), want.rounds)
    np.testing.assert_array_equal(decision.numpy(), want.decision)


@pytest.mark.parametrize("adversary,faults", [("none", "none"), ("adaptive", "omission"),
                                              ("byzantine", "partition")])
def test_driver_matches_reference_under_packing_v2(adversary, faults):
    """n = 1500 (packing law v2), a few instances."""
    protocol = "benor" if adversary == "byzantine" else "bracha"
    cfg = SimConfig(protocol=protocol, n=1500, f=_f(protocol, 1500, adversary),
                    instances=3, adversary=adversary, coin="shared", delivery="urn3",
                    round_cap=8, faults=faults).validate()
    want = ref_get_backend("numpy").run(_ref(cfg))
    rounds, decision = driver.run_chunk(cfg, torch.arange(3, dtype=torch.int32))
    np.testing.assert_array_equal(rounds.numpy(), want.rounds)
    np.testing.assert_array_equal(decision.numpy(), want.decision)
