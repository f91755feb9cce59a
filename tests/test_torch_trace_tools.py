"""``cli trace`` (``tools/trace.py``) over the host-side telemetry
(``obs/trace.py``), against the reference's ``tests/test_trace.py``.

The port's copies of the reference's sixteen cases, every one of which
applies: the tracer (inert fast path, memory bound, a thread-safe JSONL
sink, merge, validation, the exact nearest-rank digest, the Chrome export),
inertness over the fault x adversary x delivery grid on the lanes and the
compacted grid, the compacted grid's span attributes, the lane-program
cache's events, the four verbs and the record's ``trace`` block. Beside
them: ``overhead`` on the CPU at a small size (the record in both
packages' schema, bit-identity, the trace it binds), ``overhead`` without a
card exits 2 by name, and ``backend.run`` spans name the run's census key.
"""

import json
import threading

import numpy as np
import pytest
import torch

from byzantinerandomizedconsensus_tpu.obs import record as ref_record
from byzantinerandomizedconsensus_tpu_torch import cli
from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import TorchBackend
from byzantinerandomizedconsensus_tpu_torch.config import (
    DELIVERY_KINDS, FAULT_KINDS, SimConfig)
from byzantinerandomizedconsensus_tpu_torch.obs import programs, record, trace
from byzantinerandomizedconsensus_tpu_torch.tools import trace as trace_tool


@pytest.fixture(autouse=True)
def _no_leftover_tracer():
    """Every test starts and ends with tracing off: a leaked tracer would
    instrument unrelated tests."""
    trace.disable()
    yield
    trace.disable()


def _cfg(adv, proto, delivery, fault, n=7, f=2, seed=13, **kw):
    base = dict(protocol=proto, n=n, f=f, instances=4, adversary=adv, coin="local",
                seed=seed, round_cap=32, delivery=delivery, faults=fault)
    base.update(kw)
    return SimConfig(**base).validate()


def _plain():
    return TorchBackend(device="cpu", kernel="plain")


# ---------------------------------------------------------------------------
# the tracer


def test_disabled_fast_path_is_inert():
    assert not trace.enabled()
    trace.event("x", a=1)
    cm = trace.span("y", b=2)
    assert cm is trace.span("z")
    with cm as sp:
        sp["post"] = 3
    assert trace.current() is None


def test_in_memory_tracer_records_spans_and_events():
    tr = trace.configure()
    with trace.span("work", stage=1) as sp:
        sp["result"] = "ok"
    trace.event("tick", n=2)
    assert len(tr.events) == 2
    span_ev = next(e for e in tr.events if e["ph"] == "X")
    inst_ev = next(e for e in tr.events if e["ph"] == "i")
    assert span_ev["kind"] == "work" and span_ev["dur"] >= 0
    assert span_ev["attrs"] == {"stage": 1, "result": "ok"}
    assert inst_ev["kind"] == "tick" and inst_ev["attrs"] == {"n": 2}
    trace.disable()
    assert not trace.enabled()


def test_in_memory_tracer_bounds_memory():
    tr = trace.configure(max_events=5)
    for i in range(9):
        trace.event("e", i=i)
    assert len(tr.events) == 5 and tr.dropped == 4


def test_file_sink_is_threadsafe_jsonl(tmp_path):
    trace.configure(tmp_path, role="threads")
    barrier = threading.Barrier(4)

    def worker(w):
        barrier.wait()
        for i in range(20):
            with trace.span("w.span", worker=w, i=i):
                pass
        barrier.wait()

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    trace.disable()
    path = tmp_path / "trace-threads.jsonl"
    events = trace.read_events(path)
    assert len(events) == 80
    assert trace.validate_file(path) == []
    assert len({e["tid"] for e in events}) == 4


def test_merge_orders_worker_files_by_time(tmp_path):
    for role, ts0 in (("w1", 10.0), ("w2", 5.0)):
        with open(tmp_path / f"trace-{role}.jsonl", "w") as fh:
            for k in range(3):
                fh.write(json.dumps({"ph": "i", "kind": f"{role}.e", "ts": ts0 + k,
                                     "pid": 1, "tid": 0}) + "\n")
    events = trace.read_events(trace.merge(tmp_path))
    assert [e["ts"] for e in events] == sorted(e["ts"] for e in events)
    assert events[0]["kind"] == "w2.e" and events[-1]["kind"] == "w1.e"


def test_validate_catches_torn_lines_and_overlap(tmp_path):
    p = tmp_path / "trace-bad.jsonl"
    lines = [
        json.dumps({"ph": "X", "kind": "a", "ts": 1.0, "dur": 2.0, "pid": 1, "tid": 0}),
        json.dumps({"ph": "X", "kind": "b", "ts": 2.0, "dur": 3.0, "pid": 1, "tid": 0}),
        "{torn json",
        json.dumps({"ph": "?", "kind": "c", "ts": 3.0}),
    ]
    p.write_text("\n".join(lines) + "\n")
    problems = trace.validate_file(p)
    assert any("unparseable" in s for s in problems)
    assert any("overlaps" in s for s in problems)
    assert any("missing kind/ph" in s for s in problems)
    good = tmp_path / "trace-good.jsonl"
    good.write_text("\n".join(json.dumps(e) for e in [
        {"ph": "X", "kind": "parent", "ts": 1.0, "dur": 4.0, "pid": 1, "tid": 0},
        {"ph": "X", "kind": "child", "ts": 2.0, "dur": 1.0, "pid": 1, "tid": 0},
        {"ph": "X", "kind": "sibling", "ts": 6.0, "dur": 1.0, "pid": 1, "tid": 0},
    ]) + "\n")
    assert trace.validate_file(good) == []


def test_digest_is_exact_nearest_rank():
    events = ([{"ph": "X", "kind": "k", "ts": 0.0, "dur": d}
               for d in (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)]
              + [{"ph": "i", "kind": "tick", "ts": 0.0}])
    dg = trace.digest(events)
    k = dg["k"]
    assert k["count"] == 10 and k["total_s"] == 5.5
    assert (k["p50_s"], k["p90_s"], k["p99_s"]) == (0.5, 0.9, 1.0)
    assert dg["tick"] == {"count": 1, "total_s": 0.0}


def test_chrome_export_structure(tmp_path):
    trace.configure(tmp_path, role="ch")
    with trace.span("s", a=1):
        trace.event("e", b=2)
    trace.disable()
    events = trace.read_events(tmp_path / "trace-ch.jsonl")
    doc = trace.to_chrome(events)
    assert isinstance(doc["traceEvents"], list) and len(doc["traceEvents"]) == 2
    for ev in doc["traceEvents"]:
        assert ev["ph"] in ("X", "i") and isinstance(ev["name"], str)
        assert isinstance(ev["ts"], (int, float))
        if ev["ph"] == "X":
            assert ev["dur"] >= 0
        else:
            assert ev["s"] == "t"
    out = trace.write_chrome(events, tmp_path / "t.chrome.json")
    assert json.loads(out.read_text())["traceEvents"]


# ---------------------------------------------------------------------------
# inertness


def _grid():
    adv_proto = (("none", "benor"), ("crash", "benor"), ("byzantine", "bracha"),
                 ("adaptive", "bracha"))
    cells = [(FAULT_KINDS[i], DELIVERY_KINDS[j]) for i, j in ((0, 0), (1, 1), (2, 3), (3, 2))]
    cfgs = []
    for i, (fault, delivery) in enumerate(cells):
        adv, proto = adv_proto[i % len(adv_proto)]
        cfgs += [_cfg(adv, proto, delivery, fault),
                 _cfg(adv, proto, delivery, fault, f=1, seed=99, instances=6)]
    return cfgs


def test_tracing_inert_across_fault_adversary_delivery_grid(tmp_path):
    """Traced runs equal untraced ones over the (fault, delivery) grid with
    rotating adversaries, on the lanes and on the compacted grid, and the
    trace is well-formed and holds both paths' spans."""
    from byzantinerandomizedconsensus_tpu_torch.backends.compaction import CompactionPolicy

    cfgs = _grid()
    be = _plain()
    base, _ = be.run_many(cfgs)
    base_c, _ = be.run_many(cfgs, compaction=CompactionPolicy(width=4, segment=1))
    trace.configure(tmp_path, role="grid")
    traced, _ = be.run_many(cfgs)
    traced_c, _ = be.run_many(cfgs, compaction=CompactionPolicy(width=4, segment=1))
    trace.disable()
    for a, b in zip(base + base_c, traced + traced_c):
        np.testing.assert_array_equal(a.rounds, b.rounds)
        np.testing.assert_array_equal(a.decision, b.decision)
    path = tmp_path / "trace-grid.jsonl"
    assert trace.validate_file(path) == []
    kinds = {e["kind"] for e in trace.read_events(path)}
    assert {"batch.bucket", "batch.dispatch", "compaction.segment", "compaction.drain",
            "compaction.init"} <= kinds


def test_compaction_spans_carry_anatomy_attrs(tmp_path):
    from byzantinerandomizedconsensus_tpu_torch.backends.compaction import CompactionPolicy

    cfgs = [_cfg("crash", "benor", "urn2", "none", seed=s, instances=8) for s in (1, 2, 3)]
    trace.configure(tmp_path, role="comp")
    _plain().run_many(cfgs, compaction=CompactionPolicy(width=4, segment=1))
    trace.disable()
    events = trace.read_events(tmp_path / "trace-comp.jsonl")
    segs = [e for e in events if e["kind"] in ("compaction.segment", "compaction.drain")]
    assert segs
    for e in segs:
        assert {"width", "queued", "trip_max", "useful_trips", "retired",
                "live"} <= set(e["attrs"])
    assert any(e["kind"] == "compaction.drain" for e in events)
    assert all({"keep", "take", "queued"} <= set(e["attrs"])
               for e in events if e["kind"] == "compaction.refill")


def test_compile_cache_wall_and_events(tmp_path):
    from byzantinerandomizedconsensus_tpu_torch.backends import batch as batch_mod

    be = _plain()
    trace.configure(tmp_path, role="cc")
    be.run_batch([_cfg("none", "benor", "urn2", "none", f=2, seed=1, instances=3)])
    be.run_batch([_cfg("none", "benor", "urn2", "none", f=1, seed=2, instances=3)])
    trace.disable()
    s = batch_mod.compile_cache(be).stats()
    assert s["compiles"] >= 1 and s["hits"] >= 1 and s["compile_wall_s"] >= 0
    events = trace.read_events(tmp_path / "trace-cc.jsonl")
    kinds = [e["kind"] for e in events]
    assert "compile_cache.compile" in kinds and "compile_cache.hit" in kinds
    ev = next(e for e in events if e["kind"] == "compile_cache.compile")
    assert ev["attrs"]["wall_s"] >= 0


# ---------------------------------------------------------------------------
# the verbs


def _write_sample_trace(tmp_path, role="sample"):
    trace.configure(tmp_path, role=role)
    trace.event("chaos.start", configs=4, seed=0, chaos=True, jobs=1)
    for k in range(4):
        with trace.span("chaos.config", index=k):
            pass
        trace.event("chaos.progress", done=k + 1, total=4, mismatches=0, violations=0,
                    skipped=0)
    trace.disable()
    return tmp_path / f"trace-{role}.jsonl"


def test_trace_cli_summary_and_export(tmp_path, capsys):
    path = _write_sample_trace(tmp_path)
    assert trace_tool.main(["summary", str(path), "--json", str(tmp_path / "dg.json")]) == 0
    out = capsys.readouterr().out
    assert "chaos.config" in out and "p99" in out
    dg = json.loads((tmp_path / "dg.json").read_text())
    assert dg["problems"] == [] and dg["digest"]["chaos.config"]["count"] == 4
    assert trace_tool.main(["export", "--chrome", str(path)]) == 0
    doc = json.loads(path.with_suffix(".chrome.json").read_text())
    assert len(doc["traceEvents"]) == 9
    assert trace_tool.main(["export", str(path)]) == 2
    capsys.readouterr()


def test_trace_summary_top_ranks_by_total_wall(tmp_path, capsys):
    path = tmp_path / "trace-top.jsonl"
    with open(path, "w") as fh:
        ts = 0.0
        for kind, dur in (("slow.kind", 0.5), ("slow.kind", 0.4), ("mid.kind", 0.3),
                          ("fast.kind", 0.01)):
            fh.write(json.dumps({"ph": "X", "kind": kind, "ts": ts, "dur": dur,
                                 "pid": 1, "tid": 0}) + "\n")
            ts += dur + 1.0
        fh.write(json.dumps({"ph": "i", "kind": "a.tick", "ts": ts, "pid": 1,
                             "tid": 0}) + "\n")
    assert trace_tool.main(["summary", str(path), "--top", "2"]) == 0
    out = capsys.readouterr().out
    body = [line for line in out.splitlines()[1:] if line.startswith("  ")]
    assert body[0].startswith("  slow.kind") and "total 0.9 s" in body[0]
    assert body[1].startswith("  mid.kind")
    assert "fast.kind" not in out and "a.tick" not in out
    assert "2 more kind(s) below the top 2" in out
    assert trace_tool.main(["summary", str(path)]) == 0
    out = capsys.readouterr().out
    assert "fast.kind" in out and "a.tick" in out


def test_trace_follow_reads_live_directory_incrementally(tmp_path):
    _write_sample_trace(tmp_path, role="w1")
    lines = []
    state = trace_tool.follow(tmp_path, once=True, out=lines.append)
    assert state["events"] == 9 and state["progress"]["done"] == 4
    assert "configs 4/4" in lines[-1]
    with open(tmp_path / "trace-w1.jsonl", "a") as fh:
        fh.write(json.dumps({"ph": "i", "kind": "chaos.progress", "ts": 99.0, "pid": 1,
                             "tid": 0, "attrs": {"done": 5, "total": 5, "mismatches": 1,
                                                 "violations": 0, "skipped": 0}}) + "\n")
    state2 = trace_tool.follow(tmp_path, once=True, out=lines.append)
    assert state2["events"] == 10 and state2["progress"]["mismatches"] == 1
    # A fleet directory: replies attributed to workers by file name.
    fleet = tmp_path / "fleet"
    fleet.mkdir()
    for w, n in (("w0", 2), ("w1", 1)):
        with open(fleet / f"trace-fleet-{w}.jsonl", "w") as fh:
            for k in range(n):
                for kind in ("serve.request", "serve.reply"):
                    fh.write(json.dumps({"ph": "i", "kind": kind, "ts": float(k),
                                         "pid": 1, "tid": 0}) + "\n")
    trace_tool.follow(fleet, once=True, out=lines.append)
    assert "fleet 3/3 replied (w0:2 w1:1)" in lines[-1]


def test_cli_routes_trace_verb(tmp_path, capsys):
    path = _write_sample_trace(tmp_path)
    assert cli.main(["trace", "summary", str(path)]) == 0
    assert "trace summary" in capsys.readouterr().out


def test_trace_block_and_validate_record(tmp_path):
    path = _write_sample_trace(tmp_path)
    blk = record.trace_block(path)
    assert blk["file"] == path.name and blk["events"] == 9
    assert blk["digest"]["chaos.config"]["count"] == 4
    doc = {**record.new_record("soak"), "trace": blk}
    assert record.validate_record(doc) == [] and ref_record.validate_record(doc) == []
    assert any("trace block missing" in p for p in record.validate_record(
        {**record.new_record("x"), "trace": {"file": "t.jsonl"}}))
    assert any("missing 'count'" in p for p in record.validate_record(
        {**record.new_record("x"), "trace": {"file": "t", "events": 1, "digest": {"k": {}}}}))
    assert record.trace_block(tmp_path / "absent.jsonl") is None


# ---------------------------------------------------------------------------
# overhead and the per-config span


def test_overhead_smoke_on_the_cpu(tmp_path, capsys):
    """The A/B at a small size on the CPU: a record valid in both packages,
    bit-identical traced and untraced, bound to a non-empty trace holding
    the lanes' and the compacted grid's spans. Whether a handful of CPU
    walls meets the bound is not asserted, only the exit code's range."""
    out = tmp_path / "trace_smoke.json"
    rc = trace_tool.main(["overhead", "--configs", "3", "--repeats", "1",
                          "--compacted-sample", "2", "--device", "cpu", "--out", str(out)])
    capsys.readouterr()
    assert rc in (0, 1)
    doc = json.loads(out.read_text())
    assert record.validate_record(doc) == [] and ref_record.validate_record(doc) == []
    assert doc["kind"] == "trace_bench" and doc["bit_identical"] is True
    assert doc["overhead_bound"] == trace_tool.OVERHEAD_BOUND == 0.02
    # The verdict is the reference's: the best walls' ratio, less one.
    legs = doc["legs"]
    assert doc["overhead_fraction"] == round(
        legs["traced"]["wall_s"] / legs["untraced"]["wall_s"] - 1.0, 4)
    assert doc["wall_spread"] == 0.0 and doc["resolved"] is True  # one repeat
    assert not {"wall_ratio", "overhead_basis", "instrumentation_s"} & set(doc)
    assert len(doc["legs"]["traced"]["walls_s"]) == len(doc["legs"]["untraced"]["walls_s"]) == 1
    assert doc["trace"]["file"] == "trace_smoke.jsonl" and doc["trace"]["events"] > 0
    assert {"batch.dispatch", "compaction.init"} <= set(doc["trace"]["digest"])
    assert trace_tool.main(["summary", str(out.with_suffix(".jsonl"))]) == 0
    capsys.readouterr()


def test_interleaved_ab_pairs_the_legs_bucket_by_bucket_after_a_warm_up(monkeypatch):
    """Each bucket: one untimed warm-up run through the first leg, then the
    repeats, the leg that goes first alternating by repeat and by bucket;
    a leg's wall is the sum over buckets of the bucket's best, and a timed
    run that differs from the warm-up's results clears ``same``."""
    from byzantinerandomizedconsensus_tpu_torch.tools import bench_batch

    cfgs = bench_batch.chaos_grid(6, 0)
    groups = trace_tool.bucket_groups(cfgs)
    assert len(groups) >= 2 and sorted(i for _, g in groups for i in g) == list(range(6))
    calls, clock = [], iter(range(1000))
    monkeypatch.setattr(trace_tool, "timed", lambda fn: (float(next(clock)), fn()))

    def leg(name):
        def run(sub):
            calls.append((name, len(sub)))
            return [cfgs.index(c) for c in sub]
        return run

    monkeypatch.setattr(trace_tool, "results_equal", lambda a, b: a == b)
    walls, best, buckets, baseline, same = trace_tool.interleaved_ab(
        cfgs, {"off": leg("off"), "on": leg("on")}, 2)
    assert same and baseline == list(range(6))
    order = [name for name, _ in calls]
    for k in range(len(groups)):
        first = "off" if k % 2 == 0 else "on"
        second = "on" if first == "off" else "off"
        assert order[5 * k:5 * k + 5] == ["off", first, second, second, first]
    assert [label for label, _ in buckets] == [label for label, _ in groups]
    assert best == {n: sum(min(b[n]) for _, b in buckets) for n in ("off", "on")}
    assert walls == {n: [sum(b[n][r] for _, b in buckets) for r in (0, 1)]
                     for n in ("off", "on")}
    flip = {"n": 0}

    def drifting(sub):
        flip["n"] += 1
        return [cfgs.index(c) + (flip["n"] == 3) for c in sub]

    assert not trace_tool.interleaved_ab(cfgs, {"off": leg("off"), "on": drifting}, 2)[4]


def test_overhead_is_the_best_walls_ratio_less_one():
    """The verdict is the reference's (best on wall over best off wall,
    less one), however far apart the repeats lie; the legs' own spreads
    across repeats say whether the walls resolve the bound."""
    quiet = {"on": [1.01, 1.012], "off": [1.0, 1.005]}
    got = trace_tool.overhead_of(quiet, {"on": 1.01, "off": 1.0}, "on", "off")
    assert got == {"overhead_fraction": 0.01, "wall_spread": 0.005, "resolved": True}
    noisy = {"on": [1.0, 1.2], "off": [1.0, 1.1]}
    got = trace_tool.overhead_of(noisy, {"on": 1.05, "off": 1.0}, "on", "off")
    assert got == {"overhead_fraction": 0.05, "wall_spread": 0.2, "resolved": False}
    got = trace_tool.overhead_of(noisy, {"on": 0.97, "off": 1.0}, "on", "off", bound=0.25)
    assert got["overhead_fraction"] == -0.03 and got["resolved"]
    assert trace_tool.overhead_of({"on": [1.0], "off": [0.0]}, {"on": 1.0, "off": 0.0},
                                  "on", "off")["overhead_fraction"] is None


def test_overhead_names_a_missing_card(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert trace_tool.main(["overhead", "--configs", "2", "--out",
                            str(tmp_path / "t.json")]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "t.json").exists()


def test_backend_run_span_names_the_census_key(tmp_path):
    cfg = _cfg("crash", "bracha", "urn2", "none", instances=5)
    be = _plain()
    untraced = be.run(cfg)
    tr = trace.configure()
    traced = be.run(cfg)
    trace.disable()
    np.testing.assert_array_equal(untraced.rounds, traced.rounds)
    (span,) = [e for e in tr.events if e["kind"] == "backend.run"]
    assert span["attrs"]["program"] == programs.config_label(cfg)
    assert span["attrs"]["kernel"] == "plain" and span["attrs"]["dispatches"] == 1
