"""The port's lane-state records (backends/lanestate.py) against the
reference's: a record the reference parks thaws in the port and finishes
bit-identically, and a record the port parks thaws in the reference; parked
and restored runs equal the uninterrupted run across fault schedules, with
counters on; the JSON codec round-trips exactly and speaks the reference's
document layout; another version is refused by name. Tolerance 0."""

import dataclasses
import json
import threading

import numpy as np
import pytest

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.backends import batch as ref_batch
from byzantinerandomizedconsensus_tpu.backends import compaction as ref_compaction
from byzantinerandomizedconsensus_tpu.backends import get_backend as ref_get_backend
from byzantinerandomizedconsensus_tpu.backends import lanestate as ref_lanestate
from byzantinerandomizedconsensus_tpu_torch.backends import batch, compaction
from byzantinerandomizedconsensus_tpu_torch.backends.lanestate import (
    LANESTATE_VERSION, LaneControl, LaneRecord, LaneStateVersionError)
from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import TorchBackend
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig

_POLICY = compaction.CompactionPolicy(width=8, segment=1)


def _be():
    return TorchBackend(kernel="plain", device="cpu")


def _ref(cfg):
    return ref_config.SimConfig(**dataclasses.asdict(cfg))


def _fat_cfg(seed, **kw):
    """Bracha n=10 f=3 under the adaptive adversary from split init: tens
    of rounds per lane, so a park always finds live mid-round lanes."""
    base = dict(protocol="bracha", n=10, f=3, instances=16, adversary="adaptive",
                coin="local", init="split", seed=seed, round_cap=48, delivery="urn2",
                faults="none")
    base.update(kw)
    return SimConfig(**base).validate()


def _park(run_bucket, control_cls, be, bucket, cfg, policy, counters=False):
    """Run ``cfg`` with a park queued before the first segment; return the
    parked records."""
    ctl = control_cls()
    ctl.park()
    run_bucket(be, bucket, [cfg], [np.arange(cfg.instances, dtype=np.int64)],
               policy=policy, control=ctl, counters=counters)
    assert ctl.parked and ctl.parked[0].lane_count() > 0
    return ctl.parked


def _wire(doc):
    return json.loads(json.dumps(doc))


def _assert_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a.inst_ids), np.asarray(b.inst_ids))
    np.testing.assert_array_equal(a.rounds, b.rounds)
    np.testing.assert_array_equal(a.decision, b.decision)


@pytest.mark.parametrize("faults", ["partition", "recover"])
def test_reference_records_thaw_in_the_port_and_back(faults):
    cfg = _fat_cfg(seed=41, faults=faults, crash_window=6)
    rcfg = _ref(cfg)
    control = ref_get_backend("numpy").run(rcfg)
    ref_policy = ref_compaction.CompactionPolicy(width=8, segment=1)

    # reference → port
    recs = _park(ref_compaction.run_bucket, ref_lanestate.LaneControl,
                 ref_get_backend("numpy"), ref_batch.FusedBucket.of(rcfg), rcfg, ref_policy)
    thawed = [LaneRecord.from_doc(_wire(r.to_doc())) for r in recs]
    res, _, stats = compaction.run_bucket(_be(), batch.FusedBucket.of(cfg), [], [],
                                          policy=_POLICY, imports=thawed)
    assert stats["restored_lanes"] == sum(r.lane_count() for r in recs)
    _assert_equal(res[0], control)

    # port → reference
    recs = _park(compaction.run_bucket, LaneControl, _be(), batch.FusedBucket.of(cfg), cfg,
                 _POLICY)
    thawed = [ref_lanestate.LaneRecord.from_doc(_wire(r.to_doc())) for r in recs]
    res, _, _ = ref_compaction.run_bucket(ref_get_backend("numpy"),
                                          ref_batch.FusedBucket.of(rcfg), [], [],
                                          policy=ref_policy, imports=thawed)
    _assert_equal(res[0], control)


@pytest.mark.parametrize("faults", ["none", "partition", "omission", "recover"])
@pytest.mark.parametrize("adversary,delivery", [("adaptive", "urn2"), ("byzantine", "urn"),
                                                ("none", "keys"), ("crash", "urn3")])
def test_park_restore_equals_the_uninterrupted_run(faults, adversary, delivery):
    cfg = _fat_cfg(seed=31, faults=faults, adversary=adversary, delivery=delivery,
                   crash_window=5)
    counters = adversary == "crash"
    bucket = (batch.ShapeBucket.of(cfg, counters=True) if counters
              else batch.FusedBucket.of(cfg))
    recs = _park(compaction.run_bucket, LaneControl, _be(), bucket, cfg, _POLICY,
                 counters=counters)
    assert all(r.version == LANESTATE_VERSION for r in recs)
    thawed = [LaneRecord.from_doc(_wire(r.to_doc())) for r in recs]
    res, docs, _ = compaction.run_bucket(_be(), bucket, [], [], policy=_POLICY,
                                         imports=thawed, counters=counters)
    _assert_equal(res[0], ref_get_backend("numpy").run(_ref(cfg)))
    if counters:
        _, ndoc = ref_get_backend("numpy").run_with_counters(_ref(cfg))
        assert docs[0]["totals"] == ndoc["totals"]


def test_record_codec_roundtrips_and_speaks_the_reference_layout():
    cfg = _fat_cfg(seed=5, faults="partition")
    ours = _park(compaction.run_bucket, LaneControl, _be(),
                 batch.ShapeBucket.of(cfg, counters=True), cfg, _POLICY, counters=True)[0]
    rcfg = _ref(cfg)
    theirs = _park(ref_compaction.run_bucket, ref_lanestate.LaneControl,
                   ref_get_backend("numpy"), ref_batch.ShapeBucket.of(rcfg, counters=True),
                   rcfg, ref_compaction.CompactionPolicy(width=8, segment=1),
                   counters=True)[0]
    a, b = _wire(ours.to_doc()), _wire(theirs.to_doc())
    assert a == b  # the same boundary, the same bytes
    back = LaneRecord.from_doc(a)
    assert _wire(back.to_doc()) == a
    assert back.doc_summary() == ours.doc_summary()
    for k, v in ours.lanes["st"].items():
        assert v.dtype == np.asarray(theirs.lanes["st"][k]).dtype


def test_version_mismatch_is_refused_by_name():
    cfg = _fat_cfg(seed=9)
    rec = _park(compaction.run_bucket, LaneControl, _be(), batch.FusedBucket.of(cfg), cfg,
                _POLICY)[0]
    doc = rec.to_doc()
    doc["version"] = LANESTATE_VERSION + 1
    with pytest.raises(LaneStateVersionError, match="version"):
        LaneRecord.from_doc(doc)
    stale = dataclasses.replace(rec, version=LANESTATE_VERSION + 1)
    with pytest.raises(LaneStateVersionError):
        compaction.run_bucket(_be(), batch.FusedBucket.of(cfg), [], [], policy=_POLICY,
                              imports=[stale])
    assert LANESTATE_VERSION == ref_lanestate.LANESTATE_VERSION


def test_extract_keeps_the_grid_flying_and_detach_delivers_empty():
    be = _be()
    cfgs = [_fat_cfg(seed=s) for s in (1, 2)]
    bucket = batch.FusedBucket.of(cfgs[0])
    ctl = LaneControl()
    got = {}

    def on_retire(token, res):
        got[token] = res

    out = {}
    th = threading.Thread(target=lambda: out.update(records=ctl.extract([1], timeout=60)))
    th.start()
    res, _, stats = compaction.run_bucket(be, bucket, cfgs,
                                          [np.arange(16), np.arange(16)],
                                          policy=_POLICY, control=ctl, on_retire=on_retire)
    th.join(60)
    recs = out["records"]
    if recs:  # extracted before config 1 finished: finish it elsewhere
        assert stats["exported_cfgs"] == 1 and 1 not in got
        fin, _, _ = compaction.run_bucket(be, bucket, [], [], policy=_POLICY, imports=recs)
        _assert_equal(fin[0], ref_get_backend("numpy").run(_ref(cfgs[1])))
    _assert_equal(got[0], ref_get_backend("numpy").run(_ref(cfgs[0])))
    assert ctl.park().wait(1) == [] and ctl.extract([0]) == []
