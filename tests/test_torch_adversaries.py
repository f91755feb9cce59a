"""The port's adversaries (models/adversaries.py, models/faults.py) and the
config-5 sweep point against the reference: the §3.2 faulty set, the §3.3
crash rounds, the §6.4 minority observation, ``inject`` under every static
adversary on both protocols and both delivery families, the key-field
constants, and ``sweep_point``."""

import dataclasses

import numpy as np
import pytest
import torch

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.models import adversaries as ref_adv
from byzantinerandomizedconsensus_tpu.models import faults as ref_faults
from byzantinerandomizedconsensus_tpu.ops import prf as ref_prf
from byzantinerandomizedconsensus_tpu_torch import config
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.models import adversaries, faults
from byzantinerandomizedconsensus_tpu_torch.ops import prf


def _ref(cfg):
    return ref_config.SimConfig(**dataclasses.asdict(cfg))


def _ids(seed, B=8, hi=100_000):
    return np.random.default_rng(seed).choice(hi, B, replace=False)


def test_key_field_constants_match_reference():
    assert prf.KEY_LOW_BITS == ref_prf.KEY_LOW_BITS
    assert prf.KEY_MASK == ref_prf.KEY_MASK


@pytest.mark.parametrize("n,f", [(4, 1), (13, 4), (64, 21), (512, 170), (1024, 341),
                                 (2048, 682)])
def test_fault_prone_and_faulty_masks_match_reference(n, f):
    cfg = SimConfig(protocol="bracha", n=n, f=f, instances=50_000,
                    adversary="adaptive", delivery="urn").validate()
    ids = _ids(n, hi=cfg.instances)
    want = ref_faults.fault_prone_mask(_ref(cfg), 11, ids.astype(np.uint32), xp=np)
    got = faults.fault_prone_mask(cfg, 11, torch.as_tensor(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.sum(-1) == f).all()
    for adversary in ("none", "adaptive", "adaptive_min"):
        c = dataclasses.replace(cfg, adversary=adversary)
        np.testing.assert_array_equal(
            adversaries.faulty_mask(c, 11, torch.as_tensor(ids)).numpy(),
            ref_adv.faulty_mask(_ref(c), 11, ids.astype(np.uint32), xp=np))


def test_observed_minority_matches_reference():
    rng = np.random.default_rng(3)
    honest = rng.integers(0, 3, (64, 9)).astype(np.uint8)
    faulty = rng.random((64, 9)) < 0.3
    honest[0] = 1                      # a tie of 0 vs 0 goes to 1
    faulty[0] = True
    want = ref_adv.observed_minority(honest, faulty, xp=np)
    got = adversaries.observed_minority(torch.as_tensor(honest), torch.as_tensor(faulty))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,f,window", [(4, 1, 4), (64, 21, 4), (512, 170, 7),
                                         (2048, 682, 3)])
def test_crash_rounds_match_reference(n, f, window):
    cfg = SimConfig(protocol="bracha", n=n, f=f, instances=50_000, adversary="crash",
                    crash_window=window, delivery="urn2").validate()
    ids = _ids(n + window, hi=cfg.instances)
    want = ref_adv.crash_rounds(_ref(cfg), 13, ids.astype(np.uint32), xp=np)
    got = adversaries.crash_rounds(cfg, 13, torch.as_tensor(ids))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.max()) < window


def _check_inject(cfg, seed=2):
    rcfg = _ref(cfg)
    ids = _ids(5, hi=1000)
    rng = np.random.default_rng(7)
    rsetup = ref_adv.AdversaryModel(rcfg).setup(seed, ids.astype(np.uint32), xp=np)
    adv = adversaries.AdversaryModel(cfg)
    setup = adv.setup(seed, torch.as_tensor(ids))
    np.testing.assert_array_equal(setup["faulty"].numpy(), rsetup["faulty"])
    np.testing.assert_array_equal(setup["crash_round"].numpy(), rsetup["crash_round"])
    for rnd, t in ((4, 0), (4, 1), (4, 2), (0, 0), (7, 1)):
        honest = rng.integers(0, 3 if t == 2 else 2, (len(ids), cfg.n)).astype(np.uint8)
        wv, ws, wb = ref_adv.AdversaryModel(rcfg).inject(
            seed, ids.astype(np.uint32), rnd, t, honest, rsetup, xp=np)
        v, s, b = adv.inject(seed, torch.as_tensor(ids), rnd, t, torch.as_tensor(honest),
                             setup)
        assert v.dtype == torch.uint8 and s.dtype == torch.bool
        np.testing.assert_array_equal(v.numpy(), wv)
        np.testing.assert_array_equal(s.numpy(), ws)
        assert b.shape == wb.shape
        np.testing.assert_array_equal(b.numpy(), wb.astype(bool))
        v2, s2, b2 = adv.inject(seed, torch.as_tensor(ids), rnd, t, torch.as_tensor(honest),
                                setup, with_bias=False)
        assert b2 is None and torch.equal(v2, v) and torch.equal(s2, s)


@pytest.mark.parametrize("delivery", ["keys", "urn", "urn2"])
@pytest.mark.parametrize("adversary", ["none", "adaptive", "adaptive_min", "crash",
                                       "byzantine"])
def test_inject_matches_reference(adversary, delivery):
    cfg = SimConfig(protocol="bracha", n=21, f=6, instances=1000, adversary=adversary,
                    delivery=delivery).validate()
    _check_inject(cfg)
    if adversary == "crash":
        assert not _crashes_nobody(cfg)


def _crashes_nobody(cfg):
    """True if no faulty replica of the first ids is silent by round 5."""
    setup = adversaries.AdversaryModel(cfg).setup(2, torch.as_tensor(_ids(5, hi=1000)))
    return not bool((setup["faulty"] & (setup["crash_round"] <= 5)).any())


@pytest.mark.parametrize("delivery", ["keys", "urn", "urn2"])
@pytest.mark.parametrize("adversary", ["none", "crash", "byzantine", "adaptive",
                                       "adaptive_min"])
def test_inject_matches_reference_under_benor(adversary, delivery):
    """Ben-Or: under a count-level law the Byzantine pairing passes the
    honest values through (the urn draws the two-faced class values); under
    keys it needs the equivocation matrix, which raises by name."""
    lying = adversary in ("byzantine", "adaptive", "adaptive_min")
    cfg = SimConfig(protocol="benor", n=21, f=4 if lying else 10, instances=1000,
                    adversary=adversary, delivery=delivery).validate()
    if adversary == "byzantine" and delivery == "keys":
        adv = adversaries.AdversaryModel(cfg)
        ids = torch.as_tensor(_ids(5, hi=1000))
        with pytest.raises(NotImplementedError, match="byzantine.*equivocation matrix"):
            adv.inject(2, ids, 0, 0, torch.zeros((5, 21), dtype=torch.uint8),
                       adv.setup(2, ids))
        return
    _check_inject(cfg)




@pytest.mark.parametrize("n", config.SWEEP_NS)
def test_sweep_point_matches_reference_field_by_field(n):
    got = dataclasses.asdict(config.sweep_point(n))
    want = dataclasses.asdict(ref_config.sweep_point(n))
    assert got == want
    assert config.SWEEP_NS == ref_config.SWEEP_NS
    assert config.SWEEP_INSTANCES == ref_config.SWEEP_INSTANCES
    assert config.SWEEP_POINT_N == ref_config.SWEEP_POINT_N
    assert dataclasses.asdict(config.sweep_point(n, seed=5, instances=7)) == \
        dataclasses.asdict(ref_config.sweep_point(n, seed=5, instances=7))
