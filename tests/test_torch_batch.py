"""The port's lane runner (backends/batch.py) against the reference.

Buckets, tiers and labels equal the reference's. Every lane of a lane
dispatch — strict buckets with mixed-n padding lanes, fused ``superset``
lanes, counters on — equals the reference's numpy backend per config,
instance by instance, across the fault × adversary × delivery grid; two
small buckets also equal the reference's own ``run_batch`` and
``run_fused``. The compile cache counts builds and hits; every lane entry
point refuses a kernel other than ``plain`` by name; the batched sweep
writes the unbatched sweep's shards. Tolerance 0 throughout."""

import dataclasses
import random

import numpy as np
import pytest

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.backends import batch as ref_batch
from byzantinerandomizedconsensus_tpu.backends import get_backend as ref_get_backend
from byzantinerandomizedconsensus_tpu_torch.backends import batch
from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import TorchBackend
from byzantinerandomizedconsensus_tpu_torch.config import (
    DELIVERY_KINDS, FAULT_KINDS, SimConfig, validate_batch)
from byzantinerandomizedconsensus_tpu_torch.obs import metrics
from byzantinerandomizedconsensus_tpu_torch.utils import sweep

_ADV_PROTO = (("none", "benor"), ("crash", "benor"), ("byzantine", "bracha"),
              ("adaptive", "bracha"), ("adaptive_min", "bracha"))


def _be():
    return TorchBackend(kernel="plain", device="cpu")


def _ref(cfg):
    return ref_config.SimConfig(**dataclasses.asdict(cfg))


def _cfg(adv, proto, delivery, fault, n=7, f=2, seed=13, **kw):
    base = dict(protocol=proto, n=n, f=f, instances=4, adversary=adv, coin="local",
                seed=seed, round_cap=32, delivery=delivery, faults=fault)
    base.update(kw)
    return SimConfig(**base).validate()


def _lanes(adv, proto, delivery, fault):
    """Three lanes of one bucket: varying f, seed and (a padding lane) n."""
    return [_cfg(adv, proto, delivery, fault),
            _cfg(adv, proto, delivery, fault, f=1, seed=99, instances=6),
            _cfg(adv, proto, delivery, fault, n=6, f=1, seed=7, instances=3)]


def assert_match_numpy(cfgs, results):
    for cfg, res in zip(cfgs, results):
        ref = ref_get_backend("numpy").run(_ref(cfg), res.inst_ids)
        np.testing.assert_array_equal(ref.rounds, res.rounds)
        np.testing.assert_array_equal(ref.decision, res.decision)


def _random_grid(rng, delivery, count, n_max=40, instances=6):
    """``count`` valid configs over every folded axis, n in 4..n_max."""
    out = []
    while len(out) < count:
        proto = rng.choice(["benor", "bracha"])
        adv = rng.choice(["none", "crash", "byzantine", "adaptive", "adaptive_min"])
        n = rng.randint(4, n_max)
        lying = adv in ("byzantine", "adaptive", "adaptive_min")
        fmax = (n - 1) // 3 if proto == "bracha" else (n - 1) // (5 if lying else 2)
        c = SimConfig(protocol=proto, n=n, f=rng.randint(0, fmax), instances=instances,
                      adversary=adv, coin=rng.choice(["local", "shared"]),
                      seed=rng.randint(0, 2 ** 40), round_cap=rng.randint(2, 24),
                      crash_window=rng.randint(1, 5),
                      init=rng.choice(["random", "all0", "all1", "split"]),
                      delivery=delivery, faults=rng.choice(list(FAULT_KINDS)))
        try:
            out.append(c.validate())
        except ValueError:
            continue
    return out


# ---------------------------------------------------------------------------
# bucket law


@pytest.mark.parametrize("delivery", DELIVERY_KINDS)
def test_buckets_tiers_and_labels_equal_the_reference(delivery):
    rng = random.Random(DELIVERY_KINDS.index(delivery))
    cfgs = _random_grid(rng, delivery, 12, n_max=300)
    if delivery == "committee":
        cfgs.append(SimConfig(protocol="bracha", n=5000, f=1000, instances=4,
                              adversary="adaptive", coin="shared",
                              delivery="committee").validate())
    for c in cfgs:
        for counters in (False, True):
            ours = batch.ShapeBucket.of(c, counters=counters)
            ref = ref_batch.ShapeBucket.of(_ref(c), counters=counters)
            assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
            assert ours.label() == ref.label()
        fo, fr = batch.FusedBucket.of(c), ref_batch.FusedBucket.of(_ref(c))
        assert dataclasses.asdict(fo) == dataclasses.asdict(fr)
        assert fo.label() == fr.label()
        assert batch.n_tier(c.n) == ref_batch.n_tier(c.n)
        assert batch.fused_tier(c.n) == ref_batch.fused_tier(c.n)
    for lanes in (1, 2, 3, 5, 16, 17):
        assert batch.lane_tier(lanes) == ref_batch.lane_tier(lanes)
    assert batch.N_TIERS == ref_batch.N_TIERS
    assert batch.FUSED_SMALL_TIER == ref_batch.FUSED_SMALL_TIER
    for codes in ("ADV_CODES", "FAULT_CODES", "COIN_CODES", "INIT_CODES"):
        assert getattr(batch, codes) == getattr(ref_batch, codes)


def test_batch_rejections_carry_the_reference_messages():
    be = _be()
    mixed_delivery = [_cfg("none", "benor", "urn2", "none"),
                      _cfg("none", "benor", "urn3", "none")]
    mixed_pack = [_cfg("none", "benor", "urn2", "none", n=1024, f=3),
                  _cfg("none", "benor", "urn2", "none", n=1100, f=3)]
    for cfgs in (mixed_delivery, mixed_pack):
        with pytest.raises(ValueError) as ours:
            be.run_batch(cfgs)
        with pytest.raises(ValueError) as ref:
            ref_config.validate_batch([_ref(c) for c in cfgs])
        assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="spans 2 shape buckets"):
        be.run_batch([_cfg("none", "benor", "urn2", "none"),
                      _cfg("none", "benor", "urn2", "none", n=16, f=3)])
    with pytest.raises(ValueError, match="empty batch"):
        validate_batch([])


@pytest.mark.parametrize("kernel", ["fused", "step", None])
def test_every_lane_entry_point_refuses_other_kernels_by_name(kernel, tmp_path,
                                                              monkeypatch):
    from byzantinerandomizedconsensus_tpu_torch.backends import compaction

    be = _be()
    be.kernel = kernel  # as a card backend holds it
    cfgs = _lanes("none", "benor", "urn2", "none")
    calls = [lambda: be.run_batch(cfgs), lambda: be.run_many(cfgs),
             lambda: be.run_many(cfgs, compaction=compaction.CompactionPolicy()),
             lambda: be.run_fused(cfgs),
             lambda: be.run_fused(cfgs, compaction=compaction.CompactionPolicy())]
    monkeypatch.setattr(sweep, "get_backend", lambda name, **options: be)
    calls.append(lambda: sweep.run_sweep(tmp_path, ns=(16,), instances=4,
                                         shard_instances=4, batched=True,
                                         progress=lambda m: None))
    for call in calls:
        with pytest.raises(ValueError, match=f"kernel={kernel!r}"):
            call()
    assert not list(tmp_path.glob("*.npz"))


# ---------------------------------------------------------------------------
# strict buckets: the grid, padding, counters


@pytest.mark.parametrize("delivery", DELIVERY_KINDS)
@pytest.mark.parametrize("fault", FAULT_KINDS)
def test_lanes_equal_numpy_over_the_fault_adversary_delivery_grid(fault, delivery):
    i = FAULT_KINDS.index(fault) + DELIVERY_KINDS.index(delivery)
    adv, proto = _ADV_PROTO[i % len(_ADV_PROTO)]
    cfgs = _lanes(adv, proto, delivery, fault)
    assert_match_numpy(cfgs, _be().run_batch(cfgs))


@pytest.mark.parametrize("delivery", DELIVERY_KINDS)
def test_counters_are_pad_exact_and_equal_numpy(delivery):
    adv, proto = _ADV_PROTO[DELIVERY_KINDS.index(delivery)]
    fault = FAULT_KINDS[DELIVERY_KINDS.index(delivery) % len(FAULT_KINDS)]
    cfgs = [_cfg(adv, proto, delivery, fault, seed=3, coin="shared", instances=5),
            _cfg(adv, proto, delivery, fault, n=5, f=1, seed=21, coin="shared",
                 instances=4)]
    results, docs = _be().run_batch(cfgs, counters=True)
    assert_match_numpy(cfgs, results)
    for cfg, doc in zip(cfgs, docs):
        _, ndoc = ref_get_backend("numpy").run_with_counters(_ref(cfg))
        assert doc["totals"] == ndoc["totals"]
        assert doc["schema"] == ndoc["schema"] and doc["supported"]


def test_run_many_groups_preserve_input_order():
    cfgs = [_cfg("none", "benor", "urn3", "none", n=5, f=1, seed=t, instances=3 + t)
            for t in range(3)]
    cfgs.insert(1, _cfg("none", "benor", "urn3", "none", n=16, f=4, seed=5, instances=3))
    results, report = _be().run_many(cfgs)
    assert [len(r.inst_ids) for r in results] == [3, 3, 4, 5]
    assert_match_numpy(cfgs, results)
    assert report["buckets"] == 2 and report["configs"] == 4
    assert sorted(o["configs"] for o in report["occupancy"]) == [1, 3]
    ids = [np.array([2, 1]), np.array([], dtype=np.int64), np.array([2]), np.array([4, 0])]
    results, _ = _be().run_many(cfgs, inst_ids=ids)
    assert [list(r.inst_ids) for r in results] == [list(i) for i in ids]
    assert_match_numpy(cfgs, results)


# ---------------------------------------------------------------------------
# fused superset lanes


def test_fused_lanes_equal_numpy_on_mixed_axes():
    groups = [
        [_cfg("byzantine", "bracha", "urn2", "partition", coin="shared", init="all1",
              round_cap=24),
         _cfg("adaptive", "bracha", "urn2", "none", f=1, seed=5, coin="shared",
              round_cap=48),
         _cfg("none", "bracha", "urn2", "omission", n=5, f=1, seed=9, init="split",
              crash_window=2),
         _cfg("adaptive_min", "bracha", "urn2", "recover", f=1, seed=3, coin="shared",
              crash_window=8, instances=6)],
        [_cfg("byzantine", "benor", "keys", "none", n=6, f=1, seed=2),
         _cfg("crash", "benor", "keys", "recover", seed=4, crash_window=2),
         _cfg("adaptive", "benor", "keys", "none", n=11, f=2, seed=7, round_cap=48),
         _cfg("none", "benor", "keys", "partition", f=1, seed=8, init="all0")],
    ]
    for cfgs in groups:
        results, report = _be().run_fused(cfgs)
        assert_match_numpy(cfgs, results)
        assert report["mode"] == "fused" and report["buckets"] == 1


@pytest.mark.parametrize("delivery", DELIVERY_KINDS)
def test_fused_lanes_equal_numpy_on_a_random_grid(delivery):
    cfgs = _random_grid(random.Random(100 + DELIVERY_KINDS.index(delivery)), delivery, 12)
    results, report = _be().run_fused(cfgs)
    assert_match_numpy(cfgs, results)
    assert report["buckets"] == len({batch.FusedBucket.of(c) for c in cfgs})


def test_fused_buckets_collapse_axes():
    a = batch.FusedBucket.of(_cfg("none", "benor", "urn3", "none", n=4, f=1))
    b = batch.FusedBucket.of(_cfg("adaptive_min", "benor", "urn3", "omission", n=39, f=2,
                                  seed=9, coin="shared", init="split", round_cap=128))
    assert a == b and a.n_pad == batch.FUSED_SMALL_TIER


# ---------------------------------------------------------------------------
# against the reference's own lanes, and the cache


def test_lanes_equal_the_reference_lane_runner():
    """One strict bucket with a padding lane through the reference's
    ``run_batch``, one fused bucket through its ``run_fused``."""
    jb = ref_get_backend("jax")
    strict = [_cfg("byzantine", "bracha", "urn2", "recover", n=7, f=2, instances=5),
              _cfg("byzantine", "bracha", "urn2", "recover", n=5, f=1, seed=3)]
    ours = _be().run_batch(strict)
    for a, b in zip(ours, jb.run_batch([_ref(c) for c in strict])):
        np.testing.assert_array_equal(a.rounds, b.rounds)
        np.testing.assert_array_equal(a.decision, b.decision)
    fused = [_cfg("crash", "benor", "urn2", "omission", n=9, f=2, seed=4),
             _cfg("adaptive", "benor", "urn2", "partition", n=11, f=2, seed=8,
                  coin="shared", init="split", round_cap=16)]
    ours, _ = _be().run_fused(fused)
    theirs, _ = jb.run_fused([_ref(c) for c in fused])
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.rounds, b.rounds)
        np.testing.assert_array_equal(a.decision, b.decision)


def test_compile_cache_counts_builds_hits_and_evictions():
    be = _be()
    cfgs = _lanes("crash", "benor", "urn2", "recover")
    metrics.configure()
    try:
        be.run_batch(cfgs)
        first = be.compile_cache_stats()
        assert (first["compiles"], first["hits"]) == (1, 0)
        be.run_batch([dataclasses.replace(c, seed=c.seed + 1) for c in cfgs])
        second = be.compile_cache_stats()
        assert (second["compiles"], second["hits"]) == (1, 1)  # 0 new entries
        snap = metrics.snapshot()
        assert snap["brc_compile_cache_compiles_total"]["series"][0]["value"] == 1
        assert snap["brc_compile_cache_hits_total"]["series"][0]["value"] == 1
    finally:
        metrics.disable()
    ref_keys = set(ref_batch.CompileCache().stats())
    assert set(second) == ref_keys
    cache = batch.CompileCache(max_entries=2)
    for k in range(4):
        cache.get(k, lambda: object())
    cache.get(3, lambda: object())
    s = cache.stats()
    assert (s["compiles"], s["hits"], s["evictions"], s["entries"]) == (4, 1, 2, 2)
    with pytest.raises(ValueError):
        batch.CompileCache(max_entries=0)


def test_batched_sweep_writes_the_unbatched_shards(tmp_path):
    kw = dict(ns=(13, 16, 24), instances=12, shard_instances=5, progress=lambda m: None,
              device="cpu", kernel="plain")
    plain = sweep.run_sweep(tmp_path / "plain", **kw)
    lanes = sweep.run_sweep(tmp_path / "lanes", batched=True, **kw)
    for n in plain:
        assert {k: v for k, v in plain[n].items() if "wall" not in k and "per_sec" not in k} \
            == {k: v for k, v in lanes[n].items() if "wall" not in k and "per_sec" not in k}
    names = sorted(p.name for p in (tmp_path / "plain").glob("*.npz"))
    assert names == sorted(p.name for p in (tmp_path / "lanes").glob("*.npz"))
    for name in names:
        a, b = np.load(tmp_path / "plain" / name), np.load(tmp_path / "lanes" / name)
        for key in ("rounds", "decision", "inst_ids"):
            np.testing.assert_array_equal(a[key], b[key])
