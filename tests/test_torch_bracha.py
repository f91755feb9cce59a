"""The port's model layer against the reference's numpy model layer, bit for
bit: init, coins, validation, result extraction, the packed state word, and
the Bracha round body — both round bodies started from the same reference
state (carried over with ``state_from_numpy``) and compared after every
round, at small n and at n=512."""

import dataclasses

import numpy as np
import pytest
import torch

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.models import bracha as ref_bracha
from byzantinerandomizedconsensus_tpu.models import coins as ref_coins
from byzantinerandomizedconsensus_tpu.models import state as ref_state
from byzantinerandomizedconsensus_tpu.models import validation as ref_validation
from byzantinerandomizedconsensus_tpu.models.adversaries import (
    AdversaryModel as RefAdversaryModel)
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.models import bracha, coins, validation
from byzantinerandomizedconsensus_tpu_torch.models import state as state_mod
from byzantinerandomizedconsensus_tpu_torch.models.adversaries import AdversaryModel
from byzantinerandomizedconsensus_tpu_torch.ops import prf


def _ref(cfg):
    return ref_config.SimConfig(**dataclasses.asdict(cfg))


def _cfg(n, f, **kw):
    kw.setdefault("instances", 100_000)
    return SimConfig(protocol="bracha", n=n, f=f, delivery="urn2", **kw).validate()


def _assert_state_equal(got, want, where=""):
    for k in ("est", "decided", "decided_val", "phase"):
        np.testing.assert_array_equal(got[k].cpu().numpy(), np.asarray(want[k]),
                                      err_msg=f"{k} {where}")
        assert got[k].dtype == state_mod._STATE_DTYPES[k], k


ROUND_CASES = [
    # (n, f, coin, init, B, rounds)
    (4, 1, "shared", "random", 16, 4),
    (7, 2, "local", "random", 16, 4),
    (7, 1, "local", "split", 16, 3),
    (16, 5, "shared", "all1", 8, 3),
    (64, 21, "local", "random", 8, 3),
    (512, 170, "shared", "random", 6, 3),
]


@pytest.mark.parametrize("case", ROUND_CASES,
                         ids=[f"n{c[0]}-f{c[1]}-{c[2]}-{c[3]}" for c in ROUND_CASES])
def test_round_body_matches_reference_each_round(case):
    n, f, coin, init, B, rounds = case
    cfg = _cfg(n, f, coin=coin, init=init, seed=n * 31 + f)
    rcfg = _ref(cfg)
    key = state_mod.key_from_seed(cfg.seed)
    inst = np.random.default_rng(n).choice(100_000, B, replace=False).astype(np.uint32)
    inst_t = torch.as_tensor(inst.astype(np.int64))
    radv = RefAdversaryModel(rcfg)
    rsetup = radv.setup(cfg.seed, inst, xp=np)
    adv = AdversaryModel(cfg)
    setup = state_mod.setup_from_numpy(rsetup, "cpu")
    rst = ref_state.init_state(rcfg, cfg.seed, inst, xp=np)
    _assert_state_equal(state_mod.init_state(cfg, key, inst_t), rst, "init")
    own = state_mod.state_from_numpy(rst, "cpu")
    for r in range(rounds):
        got = bracha.round_body(cfg, key, inst_t, r, state_mod.state_from_numpy(rst, "cpu"),
                                adv, setup)
        own = bracha.round_body(cfg, key, inst_t, r, own, adv, setup)
        rst = ref_bracha.round_body(rcfg, cfg.seed, inst, r, rst, radv, rsetup, xp=np)
        _assert_state_equal(got, rst, f"round {r}")
        _assert_state_equal(own, rst, f"round {r}, port's own chain")


@pytest.mark.parametrize("n,f", [(7, 2), (40, 13), (512, 170)])
def test_round_body_from_arbitrary_mid_run_state(n, f):
    """States with partial decisions and advanced phases, made with numpy
    from a seed: decided replicas keep est and still broadcast."""
    cfg = _cfg(n, f, coin="shared", seed=9)
    rcfg = _ref(cfg)
    rng = np.random.default_rng(n)
    B = 6
    inst = rng.choice(100_000, B, replace=False).astype(np.uint32)
    decided = rng.random((B, n)) < 0.3
    rst = {"est": rng.integers(0, 2, (B, n)).astype(np.uint8),
           "decided": decided,
           "decided_val": np.where(decided, rng.integers(0, 2, (B, n)), 0).astype(np.uint8),
           "phase": rng.integers(0, 40, (B, n)).astype(np.int32)}
    radv = RefAdversaryModel(rcfg)
    rsetup = radv.setup(cfg.seed, inst, xp=np)
    for r in (2, 17):
        want = ref_bracha.round_body(rcfg, cfg.seed, inst, r, rst, radv, rsetup, xp=np)
        got = bracha.round_body(cfg, prf.seed_key(cfg.seed),
                                torch.as_tensor(inst.astype(np.int64)), r,
                                state_mod.state_from_numpy(rst, "cpu"),
                                AdversaryModel(cfg), state_mod.setup_from_numpy(rsetup, "cpu"))
        _assert_state_equal(got, want, f"round {r}")


@pytest.mark.parametrize("init", ["random", "all0", "all1", "split"])
def test_init_est_matches_reference(init):
    cfg = _cfg(64, 21, init=init, seed=4)
    inst = np.array([0, 1, 2, 65_535, 99_999], dtype=np.uint32)
    want = ref_state.init_est(_ref(cfg), cfg.seed, inst, xp=np)
    got = state_mod.init_est(cfg, cfg.seed, torch.as_tensor(inst.astype(np.int64)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("coin", ["local", "shared"])
def test_coin_bits_match_reference(coin):
    cfg = _cfg(33, 10, coin=coin, seed=12)
    inst = np.arange(0, 100_000, 9_999, dtype=np.uint32)
    for rnd in (0, 1, 255):
        want = ref_coins.coin_bits(_ref(cfg), cfg.seed, inst, rnd, xp=np)
        got = coins.coin_bits(cfg, cfg.seed, torch.as_tensor(inst.astype(np.int64)), rnd)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,f", [(7, 2), (64, 21), (512, 170)])
def test_validation_matches_reference(n, f):
    cfg = _cfg(n, f)
    rng = np.random.default_rng(f)
    B = 64
    values = rng.integers(0, 3, (B, n)).astype(np.uint8)
    silent = rng.random((B, n)) < 0.1
    g0_0, g0_1 = ref_validation.live_counts(values, silent, xp=np)
    p0, p1 = validation.live_counts(torch.as_tensor(values), torch.as_tensor(silent))
    np.testing.assert_array_equal(p0.numpy(), g0_0)
    np.testing.assert_array_equal(p1.numpy(), g0_1)
    # Counts spread over the whole range, so every validity branch is taken.
    ga, gb = (torch.as_tensor(rng.integers(0, n + 1, B).astype(np.int32)) for _ in range(2))
    for ref_fn, fn in ((ref_validation.validate_step1, validation.validate_step1),
                       (ref_validation.validate_step2, validation.validate_step2)):
        want = ref_fn(_ref(cfg), values, ga.numpy(), gb.numpy(), xp=np)
        got = fn(cfg, torch.as_tensor(values), ga, gb)
        np.testing.assert_array_equal(got.numpy(), want)


def test_termination_and_decision_match_reference():
    rng = np.random.default_rng(5)
    B, n = 32, 9
    st = {"decided": rng.random((B, n)) < 0.8,
          "decided_val": rng.integers(0, 2, (B, n)).astype(np.uint8)}
    faulty = rng.random((B, n)) < 0.3
    faulty[0] = True                    # no correct replica: argmax gives 0
    faulty[1] = False
    done = rng.random(B) < 0.7
    tst = {k: torch.as_tensor(v) for k, v in st.items()}
    np.testing.assert_array_equal(
        state_mod.all_correct_decided(tst, torch.as_tensor(faulty)).numpy(),
        ref_state.all_correct_decided(st, faulty, xp=np))
    np.testing.assert_array_equal(
        state_mod.extract_decision(tst, torch.as_tensor(faulty),
                                   torch.as_tensor(done)).numpy(),
        ref_state.extract_decision(st, faulty, done, xp=np))


def test_packed_state_word_roundtrip_and_layout():
    """The word the kernel keeps in a register: round trip, and each field at
    its ``FUSED_STATE_BITS`` slot — the same word the reference's fused TPU
    kernel packs."""
    import jax.numpy as jnp

    from byzantinerandomizedconsensus_tpu.ops.pallas_round import _pack_state

    rng = np.random.default_rng(20)
    st = {"est": rng.integers(0, 2, 64).astype(np.uint8),
          "decided": rng.integers(0, 2, 64).astype(bool),
          "decided_val": rng.integers(0, 2, 64).astype(np.uint8),
          "phase": rng.integers(0, 1 << 20, 64).astype(np.int32)}
    word = state_mod.pack_state(state_mod.state_from_numpy(st, "cpu"))
    want = np.asarray(_pack_state({k: jnp.asarray(v) for k, v in st.items()}))
    np.testing.assert_array_equal(word.numpy().astype(np.uint32), want)
    back = state_mod.unpack_state(word)
    _assert_state_equal(back, st)


def test_setup_from_numpy_refuses_fault_schedules():
    with pytest.raises(NotImplementedError, match="fault schedules"):
        state_mod.setup_from_numpy({"faulty": np.zeros((1, 4), bool),
                                    "crash_round": np.zeros((1, 4), np.int32),
                                    "faults": {"fprone": np.zeros((1, 4), bool)}}, "cpu")


ADVERSARY_CASES = [
    # (adversary, n, f, coin, delivery, B, rounds)
    ("crash", 10, 3, "shared", "urn2", 16, 4),
    ("crash", 64, 21, "local", "urn2", 6, 3),
    ("byzantine", 10, 3, "shared", "urn2", 16, 4),
    ("byzantine", 256, 85, "shared", "urn2", 4, 2),
    ("byzantine", 13, 4, "local", "urn", 12, 3),
    ("adaptive", 13, 4, "shared", "urn2", 16, 4),
    ("adaptive", 128, 42, "local", "urn2", 4, 3),
    ("adaptive_min", 13, 4, "shared", "urn2", 16, 4),
    ("adaptive_min", 64, 21, "local", "urn2", 6, 3),
]


@pytest.mark.parametrize("case", ADVERSARY_CASES,
                         ids=[f"{c[0]}-n{c[1]}-{c[3]}-{c[4]}" for c in ADVERSARY_CASES])
def test_round_body_matches_reference_per_adversary(case):
    """The Bracha round body under crash (silent senders), byzantine
    (silent or flipped values on the wire) and the adaptive family, from the
    same reference state, after every round: the validation counts are taken
    over the injected values and silences, as the reference takes them."""
    adversary, n, f, coin, delivery, B, rounds = case
    cfg = SimConfig(protocol="bracha", n=n, f=f, instances=100_000, adversary=adversary,
                    coin=coin, delivery=delivery, seed=n + 5).validate()
    rcfg = _ref(cfg)
    key = state_mod.key_from_seed(cfg.seed)
    inst = np.random.default_rng(n).choice(100_000, B, replace=False).astype(np.uint32)
    inst_t = torch.as_tensor(inst.astype(np.int64))
    radv = RefAdversaryModel(rcfg)
    rsetup = radv.setup(cfg.seed, inst, xp=np)
    adv = AdversaryModel(cfg)
    setup = state_mod.setup_from_numpy(rsetup, "cpu")
    rst = ref_state.init_state(rcfg, cfg.seed, inst, xp=np)
    for r in range(rounds):
        got = bracha.round_body(cfg, key, inst_t, r, state_mod.state_from_numpy(rst, "cpu"),
                                adv, setup)
        rst = ref_bracha.round_body(rcfg, cfg.seed, inst, r, rst, radv, rsetup, xp=np)
        _assert_state_equal(got, rst, f"round {r}")
