"""The port's compacted lane grid (backends/compaction.py) against the
reference.

``run_bucket`` over the fault × adversary × delivery grid equals the
reference's numpy backend per instance, with mixed-n padding lanes and with
counters on; on one strict and one fused bucket the port's grid runs the
reference's own schedule (the same segments, refills, lane-rounds and
occupancy, and the same metric values). ``WorkFeed`` takes pushes while
the grid flies, refuses past its depth by name, and re-seeds spec §11
sessions in place as the reference's offline ``run_session`` does;
``merge_stats`` folds stats as the reference's. Tolerance 0 throughout."""

import dataclasses
import threading

import numpy as np
import pytest

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.backends import batch as ref_batch
from byzantinerandomizedconsensus_tpu.backends import compaction as ref_compaction
from byzantinerandomizedconsensus_tpu.backends import get_backend as ref_get_backend
from byzantinerandomizedconsensus_tpu.models import session as ref_session
from byzantinerandomizedconsensus_tpu.obs import metrics as ref_metrics
from byzantinerandomizedconsensus_tpu_torch.backends import batch, compaction
from byzantinerandomizedconsensus_tpu_torch.backends.compaction import (
    CompactionPolicy, WorkFeed, WorkFeedOverflow)
from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import TorchBackend
from byzantinerandomizedconsensus_tpu_torch.config import DELIVERY_KINDS, FAULT_KINDS, SimConfig
from byzantinerandomizedconsensus_tpu_torch.models import session
from byzantinerandomizedconsensus_tpu_torch.obs import counters as counters_mod
from byzantinerandomizedconsensus_tpu_torch.obs import metrics

_ADV_PROTO = (("none", "benor"), ("crash", "benor"), ("byzantine", "bracha"),
              ("adaptive", "bracha"), ("adaptive_min", "bracha"))
_POLICY = CompactionPolicy(width=8, segment=1)


def _be():
    return TorchBackend(kernel="plain", device="cpu")


def _ref(cfg):
    return ref_config.SimConfig(**dataclasses.asdict(cfg))


def _cfg(adv, proto, delivery, fault, n=7, f=2, seed=13, **kw):
    base = dict(protocol=proto, n=n, f=f, instances=10, adversary=adv, coin="local",
                seed=seed, round_cap=32, delivery=delivery, faults=fault)
    base.update(kw)
    return SimConfig(**base).validate()


def _ids(cfgs):
    return [np.arange(c.instances, dtype=np.int64) for c in cfgs]


def _assert_numpy(cfgs, results, docs=None):
    for i, (cfg, res) in enumerate(zip(cfgs, results)):
        ref = ref_get_backend("numpy").run(_ref(cfg), res.inst_ids)
        np.testing.assert_array_equal(ref.rounds, res.rounds)
        np.testing.assert_array_equal(ref.decision, res.decision)
        if docs is not None:
            _, ndoc = ref_get_backend("numpy").run_with_counters(_ref(cfg))
            assert docs[i]["totals"] == ndoc["totals"]


def test_policy_parse_and_validate_equal_the_reference():
    for spec in ("", "1", "default", "width=4096,segment=3,threshold=0.5", "w=8,s=1,t=1"):
        assert CompactionPolicy.parse(spec).doc() == ref_compaction.CompactionPolicy.parse(spec).doc()
    for bad in ("bogus=1", "segment=0", "threshold=0", "width=0"):
        with pytest.raises(ValueError) as ours:
            CompactionPolicy.parse(bad)
        with pytest.raises(ValueError) as ref:
            ref_compaction.CompactionPolicy.parse(bad)
        assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("delivery", DELIVERY_KINDS)
@pytest.mark.parametrize("fault", FAULT_KINDS)
def test_grid_equals_numpy_with_padding_and_counters(fault, delivery):
    i = FAULT_KINDS.index(fault) + DELIVERY_KINDS.index(delivery)
    adv, proto = _ADV_PROTO[i % len(_ADV_PROTO)]
    cfgs = [_cfg(adv, proto, delivery, fault),
            _cfg(adv, proto, delivery, fault, n=6, f=1, seed=7, instances=6)]
    counters = i % 2 == 0
    bucket = batch.ShapeBucket.of(cfgs[0], counters=counters)
    results, docs, stats = compaction.run_bucket(_be(), bucket, cfgs, _ids(cfgs),
                                                 policy=_POLICY, counters=counters)
    _assert_numpy(cfgs, results, docs)
    assert stats["segments"] >= 1 and stats["width"] == 8
    assert 0 < stats["occupancy"] <= 1


def test_run_many_and_run_fused_compacted_equal_numpy():
    be = _be()
    cfgs = [_cfg("crash", "benor", "urn2", "recover", seed=s, n=n, f=f, instances=7)
            for s, (n, f) in enumerate([(7, 2), (5, 1), (8, 3)])]
    cfgs.append(_cfg("adaptive", "bracha", "urn3", "partition", f=1, instances=9))
    results, docs, report = be.run_many(cfgs, counters=True, compaction=_POLICY)
    _assert_numpy(cfgs, results, docs)
    assert report["compaction"]["buckets"] == 2
    fused = [_cfg("byzantine", "benor", "urn", "omission", n=11, f=2, seed=2),
             _cfg("adaptive_min", "bracha", "urn", "partition", seed=3, coin="shared",
                  init="split", round_cap=12),
             _cfg("none", "bracha", "urn", "none", n=4, f=1, seed=5, init="all1")]
    results, report = be.run_fused(fused, compaction=CompactionPolicy(width=16))
    _assert_numpy(fused, results)
    assert report["mode"] == "fused" and "compaction" in report
    with pytest.raises(counters_mod.CountersUnsupported):
        compaction.run_bucket(be, batch.FusedBucket.of(fused[0]), fused, _ids(fused),
                              counters=True)


def _metric_values(snap):
    return {name: [(s.get("labels"), s.get("value"), s.get("count"), s.get("sum"),
                    s.get("buckets")) for s in fam["series"]]
            for name, fam in (snap or {}).items()
            if name.startswith(("brc_compaction", "brc_consensus"))}


@pytest.mark.parametrize("kind", ["strict", "fused"])
def test_schedule_stats_and_metrics_equal_the_reference_grid(kind):
    """The port's grid and the reference's run the same schedule on the
    same bucket: results, counters, stats and metric values all equal."""
    if kind == "strict":
        cfgs = [_cfg("crash", "bracha", "urn2", "recover", instances=14, crash_window=3),
                _cfg("crash", "bracha", "urn2", "recover", n=5, f=1, seed=4, instances=9)]
        bucket = batch.ShapeBucket.of(cfgs[0], counters=True)
        ref_bucket = ref_batch.ShapeBucket.of(_ref(cfgs[0]), counters=True)
    else:
        cfgs = [_cfg("adaptive", "bracha", "urn2", "partition", instances=12, init="split"),
                _cfg("none", "bracha", "urn2", "omission", n=9, f=2, seed=6, coin="shared")]
        bucket = batch.FusedBucket.of(cfgs[0])
        ref_bucket = ref_batch.FusedBucket.of(_ref(cfgs[0]))
    counters = kind == "strict"
    metrics.configure()
    ref_metrics.configure()
    try:
        ours = compaction.run_bucket(_be(), bucket, cfgs, _ids(cfgs), policy=_POLICY,
                                     counters=counters)
        theirs = ref_compaction.run_bucket(
            ref_get_backend("numpy"), ref_bucket, [_ref(c) for c in cfgs], _ids(cfgs),
            policy=ref_compaction.CompactionPolicy(width=8, segment=1), counters=counters)
        snaps = metrics.snapshot(), ref_metrics.snapshot()
    finally:
        metrics.disable()
        ref_metrics.disable()
    for a, b in zip(ours[0], theirs[0]):
        np.testing.assert_array_equal(a.rounds, b.rounds)
        np.testing.assert_array_equal(a.decision, b.decision)
    if counters:
        assert [d["totals"] for d in ours[1]] == [d["totals"] for d in theirs[1]]
    assert ours[2] == theirs[2]
    assert _metric_values(snaps[0]) == _metric_values(snaps[1])
    assert _metric_values(snaps[0])["brc_compaction_segments_total"]


def test_workfeed_mid_flight_pushes_and_overflow():
    be = _be()
    base = _cfg("crash", "bracha", "urn2", "none", instances=12, round_cap=24)
    feed = WorkFeed(round_cap_ceiling=64)
    got = {}
    pushed = [dataclasses.replace(base, seed=s).validate() for s in range(4)]

    def on_retire(token, res):
        got[token] = res

    def producer():
        for k, c in enumerate(pushed):
            feed.push(c, token=f"t{k}")
        feed.close()

    bucket = batch.ShapeBucket.of(base)
    th = threading.Thread(target=producer)
    th.start()
    results, _, stats = compaction.run_bucket(be, bucket, [base], _ids([base]),
                                              policy=_POLICY, feed=feed,
                                              on_retire=on_retire)
    th.join(30)
    assert set(got) == {0, "t0", "t1", "t2", "t3"}
    _assert_numpy([base] + pushed, results)
    assert stats["width"] == 8 and feed.pending() == 0
    bounded = WorkFeed(round_cap_ceiling=64, max_depth=2)
    bounded.push(base)
    bounded.push(base)
    with pytest.raises(WorkFeedOverflow):
        bounded.push(base)
    bounded.push(base, force=True)
    with pytest.raises(ValueError, match="ceiling"):
        bounded.push(dataclasses.replace(base, round_cap=65))
    assert bounded.pending() == 3 and bounded.cancel(None) and bounded.pending() == 0
    with pytest.raises(ValueError):
        WorkFeed(round_cap_ceiling=0)


def test_workfeed_sessions_reseed_in_place_as_the_reference_replays():
    be = _be()
    cfg = _cfg("none", "bracha", "urn2", "none", instances=6, round_cap=16)
    feed = WorkFeed(round_cap_ceiling=16)
    feed.push(cfg, token="s", session=3)
    feed.close()
    slots = []
    results, _, stats = compaction.run_bucket(
        be, batch.ShapeBucket.of(cfg), [], [], policy=_POLICY, feed=feed,
        on_retire=lambda token, res: slots.append(res))
    assert stats["session_reseeds"] == 2 and feed.sessions() == 0
    replay = ref_session.run_session(ref_get_backend("numpy"), _ref(cfg), 3)
    assert len(slots) == 3
    for ours, ref in zip(slots, replay):
        np.testing.assert_array_equal(ours.rounds, ref.rounds)
        np.testing.assert_array_equal(ours.decision, ref.decision)
        assert ours.config.seed == ref.config.seed
    assert session.next_slot_config(cfg, 0, replay[0].decision).seed == replay[1].config.seed
    assert session.replay_matches(be, cfg, [(list(map(int, s.rounds)), list(map(int, s.decision)))
                                            for s in slots])


def test_merge_stats_equals_the_reference():
    per = [{"device_lane_rounds": 64, "useful_lane_rounds": 50, "segments": 3,
            "refills": 1, "policy": {"width": 8}},
           {"device_lane_rounds": 16, "useful_lane_rounds": 16, "segments": 1,
            "refills": 0, "policy": {"width": 8}}]
    assert compaction.merge_stats(per) == ref_compaction.merge_stats(per)
    assert compaction.merge_stats([]) == ref_compaction.merge_stats([])
