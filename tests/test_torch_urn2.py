"""The port's urn2 sampler (ops/urn.py::lane_setup, ops/urn2.py) against the
reference's numpy sampler, bit for bit: per-segment chains, per-lane class
state and per-step (c0, c1), on inputs drawn from a seed with numpy —
including config4-width balanced steps, where the chain runs K = D = 170 —
with the adaptive family's two strata and Ben-Or's two-faced classes."""

import dataclasses

import numpy as np
import pytest
import torch

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.models import adversaries as ref_adv
from byzantinerandomizedconsensus_tpu.ops import urn as ref_urn
from byzantinerandomizedconsensus_tpu.ops import urn2 as ref_urn2
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.ops import urn, urn2


def _ref(cfg):
    return ref_config.SimConfig(**dataclasses.asdict(cfg))


def _step_inputs(rng, B, n, p_values, p_silent, inst_hi=100_000):
    inst = rng.choice(inst_hi, B, replace=False).astype(np.uint32)
    values = rng.choice(3, size=(B, n), p=p_values).astype(np.uint8)
    silent = rng.random((B, n)) < p_silent
    return inst, values, silent


def _ref_counts(cfg, seed, inst, rnd, t, values, silent, stats=None):
    return ref_urn2.counts_fn(_ref(cfg), seed, inst, rnd, t, values, silent,
                              np.zeros_like(silent), values, xp=np, stats=stats)


def _port_counts(cfg, seed, inst, rnd, t, values, silent, stats=None):
    return urn2.counts_fn(cfg, seed, torch.as_tensor(inst.astype(np.int64)), rnd, t,
                          torch.as_tensor(values), torch.as_tensor(silent),
                          stats=stats)


STEP_CASES = [
    # (n, f, B, p_values over {0,1,2}, p_silent)
    (4, 1, 16, (0.5, 0.5, 0.0), 0.0),
    (7, 2, 16, (0.4, 0.4, 0.2), 0.2),
    (16, 5, 16, (0.2, 0.7, 0.1), 0.1),
    (64, 21, 8, (0.45, 0.45, 0.1), 0.05),
    (64, 10, 8, (0.9, 0.1, 0.0), 0.3),
    (100, 33, 4, (0.0, 0.0, 1.0), 0.0),
    (512, 170, 4, (0.3, 0.3, 0.4), 0.1),
    (1500, 499, 2, (0.5, 0.5, 0.0), 0.0),   # packing law v2
]


@pytest.mark.parametrize("case", STEP_CASES,
                         ids=[f"n{c[0]}-f{c[1]}-p{c[3]}" for c in STEP_CASES])
def test_counts_match_reference(case):
    n, f, B, p_values, p_silent = case
    cfg = SimConfig(protocol="bracha", n=n, f=f, instances=100_000 if n <= 1024
                    else 65_536, delivery="urn2").validate()
    rng = np.random.default_rng(n + f)
    for t in range(3):
        seed = int(rng.integers(0, 1 << 62))
        rnd = int(rng.integers(0, 200))
        inst, values, silent = _step_inputs(rng, B, n, p_values, p_silent,
                                            inst_hi=cfg.instances)
        c0, c1 = _port_counts(cfg, seed, inst, rnd, t, values, silent)
        w0, w1 = _ref_counts(cfg, seed, inst, rnd, t, values, silent)
        assert c0.dtype == torch.int32 and c1.dtype == torch.int32
        np.testing.assert_array_equal(c0.numpy(), w0)
        np.testing.assert_array_equal(c1.numpy(), w1)


@pytest.mark.parametrize("rnd", [0, 1, 7])
def test_config4_balanced_step_runs_k_equals_d(rnd):
    """Balanced est at n=512, f=170 with nobody silent: L = 511, D = 170, and
    the value-0 segment sits in the draw corner with K = D = 170 — the most
    expensive chain the main path runs."""
    cfg = SimConfig(protocol="bracha", n=512, f=170, instances=100_000,
                    delivery="urn2").validate()
    rng = np.random.default_rng(40 + rnd)
    B = 8
    inst = rng.choice(100_000, B, replace=False).astype(np.uint32)
    values = np.stack([rng.permutation(np.arange(512) % 2) for _ in range(B)])
    values = values.astype(np.uint8)
    silent = np.zeros((B, 512), dtype=bool)
    ref_stats, port_stats = {}, {}
    w0, w1 = _ref_counts(cfg, 0, inst, rnd, 0, values, silent, stats=ref_stats)
    c0, c1 = _port_counts(cfg, 0, inst, rnd, 0, values, silent, stats=port_stats)
    np.testing.assert_array_equal(c0.numpy(), w0)
    np.testing.assert_array_equal(c1.numpy(), w1)
    assert int(ref_stats["chain_trips_max"].max()) == 170
    np.testing.assert_array_equal(port_stats["chain_trips"].numpy(),
                                  ref_stats["chain_trips"].astype(np.int64))
    # Every delivered count is n - f = 342 messages, own included.
    np.testing.assert_array_equal((c0 + c1).numpy(), np.full((B, 512), 342))


def test_lane_setup_matches_reference():
    cfg = SimConfig(protocol="bracha", n=33, f=10, instances=64,
                    delivery="urn2").validate()
    rng = np.random.default_rng(3)
    inst, values, silent = _step_inputs(rng, 6, 33, (0.3, 0.3, 0.4), 0.25,
                                        inst_hi=64)
    own, m, st, L, D = urn.lane_setup(cfg, torch.as_tensor(values),
                                      torch.as_tensor(silent))
    _, w_own, w_m, w_st, w_L, w_D = ref_urn.lane_setup(
        _ref(cfg), 0, inst, 0, 0, values, silent, np.zeros_like(silent), values,
        xp=np)
    assert st is None and not any(np.asarray(s).any() for s in w_st)
    np.testing.assert_array_equal(own.numpy(), w_own)
    for w in range(3):
        np.testing.assert_array_equal(m[w].numpy(), w_m[w])
    np.testing.assert_array_equal(L.numpy(), w_L)
    np.testing.assert_array_equal(D.numpy(), w_D)


@pytest.mark.parametrize("corner", ["item", "draw", "comp", "mixed"])
def test_chain_matches_reference_in_each_corner(corner):
    """One segment d ~ HG(Lr, m, Dr) on hand-placed (m, Lr, Dr) planes that
    put every lane in one corner of the chain (or a mix of all three)."""
    rng = np.random.default_rng(["item", "draw", "comp", "mixed"].index(corner))
    B, R = 6, 40
    Lr = rng.integers(1, 1024, (B, R))
    if corner == "item":      # m is the smallest: draw the m items
        m = rng.integers(0, 1, (B, R)) + (Lr // 5)
        Dr = Lr // 2
    elif corner == "draw":    # D is the smallest: draw D times
        m = Lr // 2
        Dr = rng.integers(0, 1, (B, R)) + Lr // 6
    elif corner == "comp":    # L - m is the smallest: the complement
        m = Lr - Lr // 7
        Dr = Lr // 2
    else:
        m = (rng.random((B, R)) * (Lr + 1)).astype(np.int64)
        Dr = (rng.random((B, R)) * (Lr + 1)).astype(np.int64)
    m, Lr, Dr = (x.astype(np.int32) for x in (m, Lr, Dr))
    inst = np.arange(B, dtype=np.uint32) * 977
    for seg in (2, 3):
        want = ref_urn2._chain(11, inst, 5, 1, np.arange(R, dtype=np.uint32), seg,
                               m, Lr, Dr, np, pack=1)
        got = urn2._chain(11, torch.as_tensor(inst.astype(np.int64)), 5, 1, seg,
                          torch.as_tensor(m), torch.as_tensor(Lr), torch.as_tensor(Dr))
        np.testing.assert_array_equal(got.numpy(), want)


def _adv_step_inputs(rng, cfg, B, p_values, p_silent):
    """Honest votes, the §3.2 faulty set and the wire values an adversary of
    the adaptive family or the two-faced pairing would send."""
    inst = rng.choice(cfg.instances, B, replace=False).astype(np.uint32)
    honest = rng.choice(3, size=(B, cfg.n), p=p_values).astype(np.uint8)
    faulty = ref_adv.faulty_mask(_ref(cfg), 5, inst, xp=np)
    values = honest
    if cfg.adversary in ("adaptive", "adaptive_min"):
        minority = ref_adv.observed_minority(honest, faulty, xp=np)
        values = np.where(faulty, minority[:, None], honest).astype(np.uint8)
    silent = rng.random((B, cfg.n)) < p_silent
    return inst, honest, faulty, values, silent


def _seed_count(cfg, inst, values, silent, faulty, honest, rnd, t):
    """The segments with K > 0 per instance (each one PRF word), counted from
    the reference's own lane state, segment plan and chains."""
    _, _, m, st, L, D = ref_urn.lane_setup(_ref(cfg), 5, inst, rnd, t, values, silent,
                                           faulty, honest, xp=np)
    m = [np.asarray(x, np.int32) for x in m]
    mb = [np.where(s, c, 0).astype(np.int32) for s, c in zip(st, m)]
    Lb = mb[0] + mb[1] + mb[2]
    Db = np.minimum(D, Lb)
    recv = np.arange(cfg.n, dtype=np.uint32)
    seeds = np.zeros(len(inst), np.int64)
    # Segments 0-1 over the biased stratum, 2-3 over the rest.
    for base, ms, Lr, Dr in ((0, mb[:2], Lb, Db),
                             (2, [m[w] - mb[w] for w in (0, 1)], L - Lb, D - Db)):
        for w in (0, 1):
            seeds += (np.minimum(np.minimum(ms[w], Lr - ms[w]), Dr) > 0).sum(-1)
            d = ref_urn2._chain(5, inst, rnd, t, recv, base + w, ms[w], Lr, Dr, np)
            Lr, Dr = Lr - ms[w], Dr - d
    return seeds


STRATA_CASES = [
    # (adversary, n, f, B, p_values, p_silent)
    ("adaptive", 13, 4, 12, (0.45, 0.45, 0.1), 0.0),
    ("adaptive", 64, 21, 6, (0.3, 0.3, 0.4), 0.2),
    ("adaptive", 512, 170, 3, (0.2, 0.2, 0.6), 0.0),
    ("adaptive_min", 13, 4, 12, (0.45, 0.45, 0.1), 0.1),
    ("adaptive_min", 64, 21, 6, (0.8, 0.1, 0.1), 0.0),
    ("adaptive_min", 512, 170, 4, (0.0, 0.5, 0.5), 0.0),
]


@pytest.mark.parametrize("case", STRATA_CASES,
                         ids=[f"{c[0]}-n{c[1]}-p{c[4]}" for c in STRATA_CASES])
def test_two_stratum_counts_match_reference(case):
    """urn2's two strata (the adaptive family) per step, with the cost
    counters: ``chain_trips`` against the reference's, ``chain_seeds``
    against the segments with K > 0 of the reference's own plan. At n=512,
    f=170 with ⊥-heavy votes and nobody silent, a biased segment runs
    K = D = 170 (without ⊥ each stratum holds one value and no chain draws;
    under adaptive_min the biased value is the honest majority)."""
    adversary, n, f, B, p_values, p_silent = case
    cfg = SimConfig(protocol="bracha", n=n, f=f, instances=100_000, adversary=adversary,
                    delivery="urn2").validate()
    rng = np.random.default_rng(n + len(adversary))
    kmax = 0
    for rnd, t in ((0, 0), (3, 1), (6, 2)):
        inst, honest, faulty, values, silent = _adv_step_inputs(rng, cfg, B, p_values,
                                                                p_silent)
        ref_stats, port_stats = {}, {}
        w0, w1 = ref_urn2.counts_fn(_ref(cfg), 5, inst, rnd, t, values, silent, faulty,
                                    honest, xp=np, stats=ref_stats)
        c0, c1 = urn2.counts_fn(cfg, 5, torch.as_tensor(inst.astype(np.int64)), rnd, t,
                                *(torch.as_tensor(x) for x in (values, silent, faulty,
                                                               honest)),
                                stats=port_stats)
        np.testing.assert_array_equal(c0.numpy(), w0)
        np.testing.assert_array_equal(c1.numpy(), w1)
        np.testing.assert_array_equal(port_stats["chain_trips"].numpy(),
                                      ref_stats["chain_trips"].astype(np.int64))
        np.testing.assert_array_equal(
            port_stats["chain_seeds"].numpy(),
            _seed_count(cfg, inst, values, silent, faulty, honest, rnd, t))
        kmax = max(kmax, int(ref_stats["chain_trips_max"].max()))
    assert kmax == 170 or n != 512


@pytest.mark.parametrize("delivery", ["urn", "urn2"])
def test_two_faced_lane_setup_and_counts_match_reference(delivery):
    """Ben-Or's Byzantine pairing: the two class values, the per-lane class
    state of each receiver class, and (c0, c1) per step."""
    cfg = SimConfig(protocol="benor", n=21, f=4, instances=1000, adversary="byzantine",
                    delivery=delivery).validate()
    rng = np.random.default_rng(21)
    for rnd, t in ((0, 0), (2, 1), (9, 1)):
        inst, honest, faulty, values, silent = _adv_step_inputs(rng, cfg, 8, (0.4, 0.4, 0.2),
                                                                0.0)
        tt = [torch.as_tensor(x) for x in (values, silent, faulty, honest)]
        ids = torch.as_tensor(inst.astype(np.int64))
        want = ref_urn.byz_class_values(_ref(cfg), 5, inst, rnd, t, honest, faulty, xp=np)
        got = urn.byz_class_values(cfg, 5, ids, rnd, t, tt[3], tt[2])
        for h in (0, 1):
            np.testing.assert_array_equal(got[h].numpy(), want[h])
        assert (got[0].numpy()[faulty] == 2).any(), "a faulty sender shows ⊥"
        own, m, st, L, D = urn.lane_setup(cfg, *tt, seed=5, inst_ids=ids, rnd=rnd, t=t)
        _, w_own, w_m, _, w_L, w_D = ref_urn.lane_setup(_ref(cfg), 5, inst, rnd, t, values,
                                                        silent, faulty, honest, xp=np)
        assert st is None
        np.testing.assert_array_equal(own.numpy(), w_own)
        for w in range(3):
            np.testing.assert_array_equal(m[w].numpy(), w_m[w])
        np.testing.assert_array_equal(L.numpy(), w_L)
        np.testing.assert_array_equal(D.numpy(), w_D)
        fn, ref_fn = {"urn": (urn.counts_fn, ref_urn.counts_fn),
                      "urn2": (urn2.counts_fn, ref_urn2.counts_fn)}[delivery]
        c0, c1 = fn(cfg, 5, ids, rnd, t, *tt)
        w0, w1 = ref_fn(_ref(cfg), 5, inst, rnd, t, values, silent, faulty, honest, xp=np)
        np.testing.assert_array_equal(c0.numpy(), w0)
        np.testing.assert_array_equal(c1.numpy(), w1)


@pytest.mark.parametrize("adversary", ["none", "adaptive"])
def test_work_counters_split_over_the_receivers_read(adversary):
    """``stats_lanes`` restricts the cost counters to the receivers whose
    counts are read (the kernel skips a decided replica's last draw): the
    counters over a set of receivers and over the rest add up to those over
    all, and the counts themselves do not change."""
    cfg = SimConfig(protocol="bracha", n=64, f=21, instances=1000, adversary=adversary,
                    delivery="urn2").validate()
    rng = np.random.default_rng(64)
    inst, honest, faulty, values, silent = _adv_step_inputs(rng, cfg, 6, (0.3, 0.3, 0.4),
                                                            0.1)
    args = (cfg, 5, torch.as_tensor(inst.astype(np.int64)), 2, 2,
            *(torch.as_tensor(x) for x in (values, silent, faulty, honest)))
    lanes = torch.as_tensor(rng.random((6, 64)) < 0.5)
    whole, part, rest = {}, {}, {}
    want = urn2.counts_fn(*args, stats=whole)
    got = urn2.counts_fn(*args, stats=part, stats_lanes=lanes)
    urn2.counts_fn(*args, stats=rest, stats_lanes=~lanes)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for k in ("chain_trips", "chain_seeds"):
        assert torch.equal(part[k] + rest[k], whole[k]), k
        assert 0 < int(part[k].sum()) < int(whole[k].sum()), k
