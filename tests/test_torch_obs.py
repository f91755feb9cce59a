"""The port's host metrics and trace (obs/metrics.py, obs/trace.py) against
the reference's: the same exposition text, parsed snapshots, quantiles and
summaries for the same operations; the same digests, Chrome events and
validation verdicts for the same events; inert when disabled. Exact
equality throughout."""

import json
import time

import pytest

from byzantinerandomizedconsensus_tpu.obs import metrics as ref_metrics
from byzantinerandomizedconsensus_tpu.obs import trace as ref_trace
from byzantinerandomizedconsensus_tpu_torch.obs import metrics, record, trace


def _drive(m):
    """One sequence of registry operations, run on either module."""
    reg = m.Registry()
    reg.counter("brc_compile_cache_hits_total", "CompileCache lookups served warm").inc()
    reg.counter("brc_compile_cache_hits_total", "CompileCache lookups served warm").inc(4)
    reg.counter("brc_serve_admitted_total", "admitted", bucket="a/b").inc(2)
    reg.counter("brc_serve_admitted_total", "admitted", bucket='x"y\\z').inc()
    g = reg.gauge("brc_compaction_live_lanes", "live lanes")
    g.set(17)
    g.dec(3)
    g.inc(0.5)
    h = reg.histogram("brc_consensus_rounds", "rounds", buckets=m.ROUNDS_BUCKETS)
    h.observe_many([1, 1, 2, 3, 5, 9, 200])
    h.observe(64)
    lat = reg.histogram("brc_serve_latency_seconds", "latency",
                        buckets=m.LATENCY_BUCKETS_S, route="run")
    for v in (0.0004, 0.003, 0.02, 0.7, 45.0):
        lat.observe(v)
    return reg


def test_registry_text_snapshot_and_parse_equal_the_reference():
    ours, ref = _drive(metrics), _drive(ref_metrics)
    assert ours.render() == ref.render()
    assert ours.snapshot() == ref.snapshot()
    text = ours.render()
    assert metrics.parse_text(text) == ref_metrics.parse_text(text)
    snap = metrics.parse_text(text)
    series = snap["brc_consensus_rounds"]["series"]
    for q in (0.5, 0.9, 0.99):
        assert metrics.histogram_quantile(series, q) == ref_metrics.histogram_quantile(series, q)
    assert metrics.summary(snap) == ref_metrics.summary(snap)


def test_absorb_labels_worker_snapshots_like_the_reference():
    ours, ref = metrics.Registry(), ref_metrics.Registry()
    snap = _drive(metrics).snapshot()
    for reg in (ours, ref):
        reg.absorb(snap, worker="w1")
        reg.absorb(snap, worker="w2")
    assert ours.render() == ref.render()


def test_module_functions_are_inert_until_configured(monkeypatch):
    metrics.disable()
    assert not metrics.enabled() and metrics.snapshot() is None
    null = metrics.counter("brc_x_total")
    assert null is metrics.gauge("brc_y") is metrics.histogram("brc_z")
    null.inc()
    assert metrics.render() == ref_metrics.render()
    monkeypatch.setenv(metrics.METRICS_ENV, "1")
    try:
        reg = metrics.maybe_enable_from_env()
        assert reg is metrics.current() and metrics.enabled()
        metrics.counter("brc_x_total", "x").inc(3)
        assert metrics.snapshot()["brc_x_total"]["series"][0]["value"] == 3
    finally:
        metrics.disable()


def _events():
    """A fixed event list: nested spans on two workers, instants, attrs."""
    return [
        {"ph": "X", "kind": "compaction.segment", "ts": 1.0, "dur": 0.5,
         "pid": 1, "tid": 1, "attrs": {"width": 64}},
        {"ph": "X", "kind": "compaction.refill", "ts": 1.1, "dur": 0.1,
         "pid": 1, "tid": 1, "attrs": {"take": 16}},
        {"ph": "X", "kind": "compaction.segment", "ts": 2.0, "dur": 0.25,
         "pid": 1, "tid": 1, "attrs": {}},
        {"ph": "i", "kind": "compile_cache.hit", "ts": 2.5, "pid": 1, "tid": 1,
         "attrs": {"key": "bracha/n64"}},
        {"ph": "X", "kind": "batch.dispatch", "ts": 0.5, "dur": 3.0,
         "pid": 2, "tid": 7, "attrs": {"lanes": 16}},
        {"ph": "i", "kind": "compile_cache.compile", "ts": 0.6, "pid": 2, "tid": 7,
         "attrs": {"wall_s": 0.001}},
    ]


def test_digest_chrome_and_validation_equal_the_reference():
    ev = _events()
    assert trace.digest(ev) == ref_trace.digest(ev)
    assert trace.to_chrome(ev) == ref_trace.to_chrome(ev)
    assert trace.validate_events(ev) == ref_trace.validate_events(ev) == []
    bad = ev + [{"ph": "X", "kind": "overlap", "ts": 1.2, "dur": 5.0, "pid": 1, "tid": 1},
                {"ph": "X", "kind": "nodur", "ts": 1.0, "pid": 1, "tid": 1}]
    assert trace.validate_events(bad) == ref_trace.validate_events(bad) != []


def test_tracer_files_merge_and_trace_block(tmp_path):
    trace.disable()
    assert not trace.enabled()
    assert trace.span("x") is trace.span("y")  # the shared no-op
    for role in ("a", "b"):
        tr = trace.configure(tmp_path, role=role)
        with trace.span("batch.bucket", configs=2) as sp:
            sp["lane_tier"] = 2
            trace.event("compile_cache.compile", key=role)
            time.sleep(0.001)
        trace.disable()
        assert tr.path.name == f"trace-{role}.jsonl"
    merged = trace.merge(tmp_path)
    ours = trace.read_events(merged)
    assert ours == ref_trace.read_events(merged)
    assert [e["ts"] for e in ours] == sorted(e["ts"] for e in ours)
    assert {e["kind"] for e in ours} == {"batch.bucket", "compile_cache.compile"}
    assert trace.validate_file(merged) == ref_trace.validate_file(merged) == []
    block = record.trace_block(merged)
    assert block["events"] == 4 and block["digest"] == ref_trace.digest(ours)
    assert set(record.TRACE_BLOCK_KEYS) <= set(block)


def test_env_enables_a_per_worker_sink(tmp_path, monkeypatch):
    trace.disable()
    monkeypatch.setenv(trace.TRACE_ENV, str(tmp_path))
    try:
        tr = trace.maybe_enable_from_env()
        assert tr is trace.current()
        trace.event("compaction.cancel", lanes=3)
        block = trace.finish(tr)
    finally:
        trace.disable()
    assert block["events"] == 1
    line = json.loads(tr.path.read_text().splitlines()[0])
    assert line["kind"] == "compaction.cancel" and line["attrs"]["lanes"] == 3


@pytest.mark.parametrize("kind", ["compile_cache", "compaction", "fused", "lanestate"])
def test_record_blocks_equal_the_reference(kind):
    from byzantinerandomizedconsensus_tpu.obs import record as ref_record

    stats = {"width": 64, "segments": 3, "refills": 2, "device_lane_rounds": 100,
             "useful_lane_rounds": 90, "occupancy": 0.9, "wasted_lane_fraction": 0.1,
             "policy": {"width": 64}, "configs": 4, "mismatches": 0, "rows": [],
             "device_of_record": "cpu", "version": 1, "grid_points": 3,
             "restore_mismatches": 0, "crash_window_ok": True, "roundtrip_ok": True,
             "extra": 1}
    if kind == "compile_cache":
        class Be:
            def compile_cache_stats(self):
                return {"compiles": 1, "hits": 2}

        assert record.compile_cache_block(Be()) == ref_record.compile_cache_block(Be())
        assert record.compile_cache_block(object()) is None
        return
    fn = getattr(record, f"{kind}_block")
    assert fn(stats) == getattr(ref_record, f"{kind}_block")(stats)
    assert fn(None) is None
