"""The port's PRF (byzantinerandomizedconsensus_tpu_torch/ops/prf.py) against the
reference's numpy PRF, bit for bit, on coordinate grids under packing laws v1
and v2; the port's copies of the config layer against the reference's."""

import dataclasses

import numpy as np
import pytest
import torch

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.ops import prf as ref_prf
from byzantinerandomizedconsensus_tpu_torch import config
from byzantinerandomizedconsensus_tpu_torch.ops import prf

SEEDS = [0, 1, 0xDEADBEEF12345678]


def _limits(pack):
    if pack == 1:
        return ref_prf.MAX_INSTANCES, ref_prf.MAX_ROUNDS, ref_prf.V1_MAX_N
    if pack == 3:
        return ref_prf.V3_MAX_INSTANCES, ref_prf.V3_MAX_ROUNDS, ref_prf.V3_MAX_N
    return ref_prf.V2_MAX_INSTANCES, ref_prf.V2_MAX_ROUNDS, ref_prf.V2_MAX_N


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("pack", [1, 2, 3])
def test_prf_u32_matches_reference_on_random_coordinates(pack, seed):
    rng = np.random.default_rng(100 * pack + SEEDS.index(seed))
    max_inst, max_rnd, max_n = _limits(pack)
    N = 2048
    inst, rnd, recv, send = (rng.integers(0, hi, N, dtype=np.int64)
                             for hi in (max_inst, max_rnd, max_n, max_n))
    for step in range(4):
        for purpose in (ref_prf.INIT_EST, ref_prf.SHARED_COIN, ref_prf.URN2, 15):
            want = ref_prf.prf_u32(seed, inst.astype(np.uint32), rnd.astype(np.uint32),
                                   step, recv.astype(np.uint32), send.astype(np.uint32),
                                   purpose, xp=np, pack=pack)
            got = prf.prf_u32(seed, torch.as_tensor(inst), torch.as_tensor(rnd), step,
                              torch.as_tensor(recv), torch.as_tensor(send), purpose,
                              pack=pack)
            np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("pack", [1, 2])
def test_prf_u32_broadcast_grid_and_scalar_coordinates(pack):
    """The shapes the round body uses: (B, 1) instances against (1, n)
    receivers, scalar round/step/send."""
    inst = np.array([0, 1, 99_999, 65_535], dtype=np.int64)[:, None]
    recv = np.arange(0, 1024 if pack == 1 else 4096, 7, dtype=np.int64)[None, :]
    want = ref_prf.prf_u32(5, inst.astype(np.uint32), 3, 2, recv.astype(np.uint32),
                           3, ref_prf.URN2, xp=np, pack=pack)
    got = prf.prf_u32(5, torch.as_tensor(inst), 3, 2, torch.as_tensor(recv), 3,
                      prf.URN2, pack=pack)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    bits = prf.prf_bit(5, torch.as_tensor(inst), 3, 2, torch.as_tensor(recv), 3,
                       prf.URN2, pack=pack)
    np.testing.assert_array_equal(bits.numpy(), want & 1)


def test_threefry_matches_reference_on_random_words():
    rng = np.random.default_rng(7)
    x0, x1 = (rng.integers(0, 1 << 32, 4096, dtype=np.uint64) for _ in range(2))
    for k0, k1 in [(0, 0), (0xFFFFFFFF, 1), (0x12345678, 0x9ABCDEF0)]:
        want = ref_prf.threefry2x32(np.uint32(k0), np.uint32(k1), x0.astype(np.uint32),
                                    x1.astype(np.uint32), xp=np)
        got = prf.threefry2x32(k0, k1, torch.as_tensor(x0.astype(np.int64)),
                               torch.as_tensor(x1.astype(np.int64)))
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_mul32_is_exact_modulo_2_32():
    rng = np.random.default_rng(8)
    x = rng.integers(0, 1 << 32, 10_000, dtype=np.uint64)
    for c in (prf.URN_LCG_A, 0xFFFFFFFF, 1, 0x10001):
        want = (x * np.uint64(c)) & np.uint64(0xFFFFFFFF)
        got = prf.mul32(torch.as_tensor(x.astype(np.int64)), c)
        np.testing.assert_array_equal(got.numpy().astype(np.uint64), want)


@pytest.mark.parametrize("seed", SEEDS + [-1, 1 << 70])
def test_seed_key_matches_reference(seed):
    want = tuple(int(k) for k in ref_prf.seed_key(seed))
    assert prf.seed_key(seed) == want
    assert prf.seed_key(want) == want


def test_pack_v3_raises_by_name():
    """Packing law v3 draws the reference's words (it no longer raises: the
    committee family runs it); an unknown law still raises by name."""
    assert int(prf.prf_u32(0, 1, 0, 0, 5000, 0, prf.COMMITTEE, pack=3)) == \
        int(ref_prf.prf_u32(0, 1, 0, 0, 5000, 0, prf.COMMITTEE, xp=np, pack=3))
    with pytest.raises(ValueError, match="unknown packing version"):
        prf.prf_u32(0, 1, 0, 0, 1, 0, prf.URN2, pack=4)


@pytest.mark.parametrize("name", [
    "MAX_INSTANCES", "V1_MAX_N", "MAX_ROUNDS", "V2_MAX_INSTANCES", "V2_MAX_N",
    "V2_MAX_ROUNDS", "V3_MAX_INSTANCES", "V3_MAX_N", "V3_MAX_ROUNDS", "MAX_N",
    "PACK_SHIFTS", "RED_SHIFTS", "FUSED_STATE_BITS", "FUSED_STATE_PACK_VERSION",
    "URN_LCG_A", "URN_LCG_C", "COIN_STEP", "INIT_EST", "LOCAL_COIN",
    "SHARED_COIN", "FAULTY_RANK", "CRASH_ROUND", "BYZ_VALUE", "SCHED", "URN",
    "URN2", "URN3", "FAULT_CRASH", "FAULT_HEAL", "FAULT_SIDE", "FAULT_EPOCH",
    "FAULT_OMIT", "COMMITTEE"])
def test_constants_equal_reference(name):
    assert getattr(prf, name) == getattr(ref_prf, name)


def test_pack_version_matches_reference():
    for n in (1, 4, 512, 1024, 1025, 2048, 4096, 4097, 1 << 20):
        assert prf.pack_version(n) == ref_prf.pack_version(n)


@pytest.mark.parametrize("name", sorted(ref_config.PRESETS))
def test_presets_equal_reference(name):
    assert dataclasses.asdict(config.PRESETS[name]) == \
        dataclasses.asdict(ref_config.PRESETS[name])
    assert config.preset(name) == config.PRESETS[name]
    assert config.PRODUCT_DELIVERY == ref_config.PRODUCT_DELIVERY


@pytest.mark.parametrize("fields", [
    dict(protocol="bracha", n=9, f=3),
    dict(protocol="benor", n=4, f=2),
    dict(protocol="benor", n=10, f=2, adversary="byzantine"),
    dict(n=0), dict(n=5000, delivery="urn2"), dict(n=8, f=8),
    dict(instances=0), dict(instances=(1 << 17) + 1),
    dict(n=2048, f=100, instances=(1 << 16) + 1, delivery="urn2"),
    dict(round_cap=0), dict(n=2048, f=100, round_cap=5000, delivery="urn2"),
    dict(delivery="bogus"), dict(faults="bogus"), dict(crash_window=0),
], ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()))
def test_validate_rejects_with_reference_message(fields):
    with pytest.raises(ValueError) as want:
        ref_config.SimConfig(**fields).validate()
    with pytest.raises(ValueError) as got:
        config.SimConfig(**fields).validate()
    # The same message, naming the port's own chunk sizing.
    assert str(got.value) == str(want.value).replace(
        "backends/jax_backend.py::_chunk_size", "backends/torch_backend.py::chunk_size")


@pytest.mark.parametrize("pack", [1, 2])
def test_prf_sender_matches_reference(pack):
    """The sender-addressed draw (BYZ_VALUE's family) under packs 1 and 2,
    where it is ``prf_u32(..., recv=tag, send=sender)``."""
    rng = np.random.default_rng(30 + pack)
    inst = rng.integers(0, prf.V2_MAX_INSTANCES, (16, 1))
    send = rng.integers(0, prf.V1_MAX_N, (1, 64))
    for tag in (0, 1):
        rnd = int(rng.integers(0, prf.V2_MAX_ROUNDS))
        want = ref_prf.prf_sender(9, inst.astype(np.uint32), rnd, 2, tag,
                                  send.astype(np.uint32), prf.BYZ_VALUE, xp=np, pack=pack)
        got = prf.prf_sender(9, torch.as_tensor(inst), rnd, 2, tag, torch.as_tensor(send),
                             prf.BYZ_VALUE, pack=pack)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
        np.testing.assert_array_equal(
            got.numpy(), prf.prf_u32(9, torch.as_tensor(inst), rnd, 2, tag,
                                     torch.as_tensor(send), prf.BYZ_VALUE, pack=pack).numpy())
    # Under v3 the sender moves to the wide recv field.
    assert int(prf.prf_sender(0, 1, 0, 0, 0, 5000, prf.BYZ_VALUE, pack=3)) == \
        int(ref_prf.prf_sender(0, 1, 0, 0, 0, 5000, prf.BYZ_VALUE, xp=np, pack=3)) == \
        int(prf.prf_u32(0, 1, 0, 0, 5000, 0, prf.BYZ_VALUE, pack=3))


@pytest.mark.parametrize("fields", [
    dict(protocol="benor", n=4, f=1, instances=1, coin="local", delivery="urn2"),
    dict(protocol="benor", n=64, f=21, instances=10_000, adversary="crash", coin="local",
         delivery="urn2"),
    dict(protocol="bracha", n=256, f=85, instances=1_000, adversary="byzantine",
         coin="shared", delivery="urn2"),
    dict(protocol="benor", n=16, f=3, instances=100, adversary="byzantine", coin="local",
         round_cap=64, seed=9, delivery="urn2"),
    dict(protocol="bracha", n=10, f=3, instances=100, adversary="crash", coin="shared",
         round_cap=64, seed=10, delivery="urn2"),
    dict(protocol="benor", n=11, f=2, adversary="adaptive_min", delivery="urn2"),
    dict(protocol="benor", n=7, f=3, adversary="crash", delivery="urn2"),
], ids=["config1", "config2", "config3", "urn2_benor_byz", "urn2_bracha_crash",
        "benor_lying_n11_f2", "benor_benign_n7_f3"])
def test_validate_accepts_the_shipped_and_golden_configs(fields):
    """config1-3 and the goldens' configs pass both packages' checks,
    including the Protocol A (n > 2f) and B (n > 5f) bounds at their edge."""
    assert config.SimConfig(**fields).validate() == config.SimConfig(**fields)
    ref_config.SimConfig(**fields).validate()


def test_prf_sender_v3_swaps_fields_as_the_reference():
    """Under packing law v3 the sender-addressed draw puts the replica in
    the wide recv field and the tag in send, as the reference does."""
    rng = np.random.default_rng(33)
    inst = rng.integers(0, prf.V3_MAX_INSTANCES, (8, 1))
    send = rng.integers(0, prf.V3_MAX_N, (1, 64))
    for tag in (0, 1):
        rnd = int(rng.integers(0, prf.V3_MAX_ROUNDS))
        want = ref_prf.prf_sender(9, inst.astype(np.uint32), rnd, 1, tag,
                                  send.astype(np.uint32), prf.BYZ_VALUE, xp=np, pack=3)
        got = prf.prf_sender(9, torch.as_tensor(inst), rnd, 1, tag, torch.as_tensor(send),
                             prf.BYZ_VALUE, pack=3)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
        np.testing.assert_array_equal(
            got.numpy(), prf.prf_u32(9, torch.as_tensor(inst), rnd, 1, torch.as_tensor(send),
                                     tag, prf.BYZ_VALUE, pack=3).numpy())
