"""The port's Ben-Or round body (models/benor.py) against the reference's
numpy model layer, bit for bit: both round bodies started from the same
reference state (carried over with ``state_from_numpy`` and
``setup_from_numpy``) and compared after every round, under every static
adversary and both count-level urn laws; a mid-run state; the faulty set and
crash rounds carried across; and the decision of the first correct replica
when replica 0 is faulty."""

import dataclasses

import numpy as np
import pytest
import torch

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.backends import get_backend as ref_get_backend
from byzantinerandomizedconsensus_tpu.models import benor as ref_benor
from byzantinerandomizedconsensus_tpu.models import state as ref_state
from byzantinerandomizedconsensus_tpu.models.adversaries import (
    AdversaryModel as RefAdversaryModel)
from byzantinerandomizedconsensus_tpu_torch import get_backend
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.models import benor, driver
from byzantinerandomizedconsensus_tpu_torch.models import state as state_mod
from byzantinerandomizedconsensus_tpu_torch.models.adversaries import AdversaryModel


def _ref(cfg):
    return ref_config.SimConfig(**dataclasses.asdict(cfg))


def _assert_state_equal(got, want, where=""):
    for k in ("est", "decided", "decided_val", "phase"):
        np.testing.assert_array_equal(got[k].cpu().numpy(), np.asarray(want[k]),
                                      err_msg=f"{k} {where}")
        assert got[k].dtype == state_mod._STATE_DTYPES[k], k


ROUND_CASES = [
    # (adversary, n, f, coin, delivery, B, rounds)
    ("none", 4, 1, "local", "urn2", 16, 6),
    ("none", 16, 7, "shared", "urn2", 8, 4),
    ("crash", 16, 5, "local", "urn2", 12, 6),
    ("crash", 64, 21, "local", "urn2", 6, 4),
    ("crash", 10, 4, "shared", "urn", 12, 4),
    ("byzantine", 16, 3, "local", "urn2", 12, 6),
    ("byzantine", 11, 2, "shared", "urn", 12, 4),
    ("adaptive", 16, 3, "local", "urn2", 12, 5),
    ("adaptive", 11, 2, "shared", "urn", 12, 4),
    ("adaptive_min", 16, 3, "shared", "urn2", 12, 5),
    ("adaptive_min", 21, 4, "local", "urn", 8, 4),
]


@pytest.mark.parametrize("case", ROUND_CASES,
                         ids=[f"{c[0]}-n{c[1]}-f{c[2]}-{c[3]}-{c[4]}" for c in ROUND_CASES])
def test_round_body_matches_reference_each_round(case):
    adversary, n, f, coin, delivery, B, rounds = case
    cfg = SimConfig(protocol="benor", n=n, f=f, instances=100_000, adversary=adversary,
                    coin=coin, delivery=delivery, seed=n * 17 + f).validate()
    rcfg = _ref(cfg)
    key = state_mod.key_from_seed(cfg.seed)
    inst = np.random.default_rng(n + f).choice(100_000, B, replace=False).astype(np.uint32)
    inst_t = torch.as_tensor(inst.astype(np.int64))
    radv = RefAdversaryModel(rcfg)
    rsetup = radv.setup(cfg.seed, inst, xp=np)
    adv = AdversaryModel(cfg)
    setup = state_mod.setup_from_numpy(rsetup, "cpu")
    own_setup = adv.setup(key, inst_t)
    for k in ("faulty", "crash_round"):
        assert torch.equal(own_setup[k], setup[k]), k
    rst = ref_state.init_state(rcfg, cfg.seed, inst, xp=np)
    own = state_mod.state_from_numpy(rst, "cpu")
    for r in range(rounds):
        got = benor.round_body(cfg, key, inst_t, r, state_mod.state_from_numpy(rst, "cpu"),
                               adv, setup)
        own = benor.round_body(cfg, key, inst_t, r, own, adv, own_setup)
        rst = ref_benor.round_body(rcfg, cfg.seed, inst, r, rst, radv, rsetup, xp=np)
        _assert_state_equal(got, rst, f"round {r}")
        _assert_state_equal(own, rst, f"round {r}, port's own chain")


@pytest.mark.parametrize("adversary", ["none", "crash", "byzantine", "adaptive_min"])
def test_round_body_from_arbitrary_mid_run_state(adversary):
    """States with partial decisions and advanced phases, made with numpy
    from a seed: decided replicas keep est and still report; crashed
    replicas are silent from their crash round on."""
    lying = adversary in ("byzantine", "adaptive", "adaptive_min")
    n = 21
    cfg = SimConfig(protocol="benor", n=n, f=4 if lying else 10, instances=100_000,
                    adversary=adversary, coin="local", delivery="urn2", seed=4).validate()
    rcfg = _ref(cfg)
    rng = np.random.default_rng(len(adversary))
    B = 8
    inst = rng.choice(100_000, B, replace=False).astype(np.uint32)
    decided = rng.random((B, n)) < 0.3
    rst = {"est": rng.integers(0, 2, (B, n)).astype(np.uint8),
           "decided": decided,
           "decided_val": np.where(decided, rng.integers(0, 2, (B, n)), 0).astype(np.uint8),
           "phase": rng.integers(0, 40, (B, n)).astype(np.int32)}
    radv = RefAdversaryModel(rcfg)
    rsetup = radv.setup(cfg.seed, inst, xp=np)
    for r in (2, 17):
        want = ref_benor.round_body(rcfg, cfg.seed, inst, r, rst, radv, rsetup, xp=np)
        got = benor.round_body(cfg, state_mod.key_from_seed(cfg.seed),
                               torch.as_tensor(inst.astype(np.int64)), r,
                               state_mod.state_from_numpy(rst, "cpu"),
                               AdversaryModel(cfg), state_mod.setup_from_numpy(rsetup, "cpu"))
        _assert_state_equal(got, want, f"round {r}")


def test_setup_from_numpy_carries_faulty_and_crash_rounds():
    cfg = SimConfig(protocol="benor", n=64, f=21, instances=10_000, adversary="crash",
                    coin="local", delivery="urn2").validate()
    inst = np.arange(40, dtype=np.uint32) * 97
    rsetup = RefAdversaryModel(_ref(cfg)).setup(cfg.seed, inst, xp=np)
    setup = state_mod.setup_from_numpy(rsetup, "cpu")
    assert setup["faulty"].dtype == torch.bool and setup["crash_round"].dtype == torch.int32
    np.testing.assert_array_equal(setup["faulty"].numpy(), rsetup["faulty"])
    np.testing.assert_array_equal(setup["crash_round"].numpy(), rsetup["crash_round"])
    assert setup["faults"] is None
    assert rsetup["crash_round"].max() > 0 and rsetup["faulty"].sum() == 40 * 21


@pytest.mark.parametrize("adversary", ["crash", "byzantine", "adaptive"])
def test_decision_of_the_first_correct_replica_with_faulty_replica_zero(adversary):
    """Whole runs, through both packages' backends, on ids where replica 0
    is faulty among others: the decision is the lowest correct replica's."""
    lying = adversary != "crash"
    cfg = SimConfig(protocol="benor", n=16, f=3 if lying else 7, instances=4000,
                    adversary=adversary, coin="local", round_cap=32, delivery="urn2",
                    seed=12).validate()
    cand = np.arange(400)
    faulty = AdversaryModel(cfg).setup(cfg.seed, torch.as_tensor(cand))["faulty"].numpy()
    ids = np.concatenate([cand[faulty[:, 0]][:12], cand[~faulty[:, 0]][:12]])
    assert (faulty[ids, 0]).sum() == 12
    want = ref_get_backend("numpy").run(_ref(cfg), inst_ids=ids)
    got = get_backend("torch", device="cpu").run(cfg, inst_ids=ids)
    np.testing.assert_array_equal(got.rounds, want.rounds)
    np.testing.assert_array_equal(got.decision, want.decision)
    # The same through the plain round driver directly.
    rounds, decision = driver.run_chunk(cfg, torch.as_tensor(ids.astype(np.int32)))
    np.testing.assert_array_equal(decision.numpy(), want.decision)


@pytest.mark.parametrize("coin", ["local", "shared"])
def test_driver_counts_the_coin_words_taken(coin):
    """The driver's ``coin_words``: a word per replica that takes the coin
    under the local coin, one per instance-round with any taker under the
    shared coin, counted over the instances still running."""
    cfg = SimConfig(protocol="benor", n=16, f=7, instances=1000, adversary="crash",
                    coin=coin, round_cap=24, delivery="urn2", seed=3).validate()
    stats = {}
    rounds, _ = driver.run_chunk(cfg, torch.arange(40, dtype=torch.int32), stats=stats)
    assert stats["instance_rounds"] == int(rounds.sum())
    per_round = cfg.n if coin == "local" else 1
    assert 0 < stats["coin_words"] <= stats["instance_rounds"] * per_round
    if coin == "local":
        assert stats["coin_words"] > stats["instance_rounds"]
