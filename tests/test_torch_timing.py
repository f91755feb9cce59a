"""The port's measurement and bookkeeping utilities against the reference
on the CPU: ``utils/timing.py`` (the regression verdict and the spread on
the reference's cases, a ``torch.profiler`` Chrome trace parsed for the
device-busy leg, the host-backend degradation), ``utils/profiling.py``
(``cli run --profile``, the round bodies' spans), ``utils/metrics.summary``
with its ``walls``/``device`` legs, and ``utils/rounds.py`` on the
reference's round-anchoring cases, each on a tmp tree.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.backends import get_backend as ref_get_backend
from byzantinerandomizedconsensus_tpu.utils import metrics as ref_metrics
from byzantinerandomizedconsensus_tpu.utils import rounds as ref_rounds
from byzantinerandomizedconsensus_tpu.utils import timing as ref_timing
from byzantinerandomizedconsensus_tpu_torch import cli
from byzantinerandomizedconsensus_tpu_torch.backends import get_backend
from byzantinerandomizedconsensus_tpu_torch.config import preset
from byzantinerandomizedconsensus_tpu_torch.obs import record
from byzantinerandomizedconsensus_tpu_torch.utils import metrics, profiling, rounds, timing

# -- regression_verdict and spread: the reference's cases ---------------------

VERDICT_CASES = [
    # quiet walls: the wall ratio is the signal, the device ratio beside it
    (dict(walls=[1.0, 1.05, 1.1], prev_wall_rate=100.0, rate=110.0,
          device_busy_s=0.5, prev_device_busy_s=0.6),
     {"regression_signal": "vs_prev_round", "vs_prev_round": 1.1,
      "vs_prev_round_device": 1.2}),
    # noisy walls: the device ratio is the signal
    (dict(walls=[1.0, 1.5], prev_wall_rate=100.0, rate=70.0,
          device_busy_s=0.5, prev_device_busy_s=0.5),
     {"walls_spread": 0.5, "regression_signal": "vs_prev_round_device",
      "vs_prev_round_device": 1.0}),
    # noisy walls and no device leg: says so
    (dict(walls=[1.0, 1.5], prev_wall_rate=100.0, rate=70.0), {}),
    # a zero device leg forms no ratio
    (dict(walls=[1.0, 1.01], prev_wall_rate=100.0, rate=100.0,
          device_busy_s=0.0, prev_device_busy_s=0.5),
     {"regression_signal": "vs_prev_round"}),
    # no previous round: no ratio, no signal
    (dict(walls=[1.0, 1.02]), {}),
]


@pytest.mark.parametrize("kw,expect", VERDICT_CASES)
def test_regression_verdict_equals_the_reference(kw, expect):
    walls = kw.pop("walls")
    got = timing.regression_verdict(walls, **kw)
    assert got == ref_timing.regression_verdict(walls, **kw)
    for k, v in expect.items():
        assert got[k] == v
    if "prev_wall_rate" not in kw:
        assert "vs_prev_round" not in got and "regression_signal" not in got
    if kw.get("device_busy_s") is None and kw.get("prev_wall_rate"):
        assert got["regression_signal"].startswith("none: walls too noisy")
    if kw.get("device_busy_s") == 0.0:
        assert "vs_prev_round_device" not in got


@pytest.mark.parametrize("walls", [[], [1.0], [2.0, 1.0, 3.0], [0.0, 1.0], [0.5, 0.5]])
def test_spread_and_constants_equal_the_reference(walls):
    assert timing.spread(walls) == ref_timing.spread(walls)
    assert timing.DEFAULT_REPEATS == ref_timing.DEFAULT_REPEATS
    assert timing.NOISY_WALLS_SPREAD == ref_timing.NOISY_WALLS_SPREAD
    assert timing.REGRESSION_THRESHOLD == ref_timing.REGRESSION_THRESHOLD


# -- the device-busy leg from a torch.profiler Chrome trace -------------------

def _write_trace(path, kernel_us, mark=True, gpu=True, cats=("kernel",)):
    """A Chrome trace in torch.profiler's layout: a GPU process, kernel
    events on it, a host mark span, and a host event outside the GPU."""
    ev = [{"ph": "X", "pid": 1, "tid": 1, "name": "aten::add", "cat": "cpu_op",
           "ts": 0, "dur": 10 ** 9}]
    if gpu:
        ev.append({"ph": "M", "name": "process_name", "pid": 0,
                   "args": {"name": "GPU 0"}})
    if mark:
        ev.append({"ph": "X", "pid": 1, "tid": 1, "name": timing.BUSY_MARK,
                   "cat": "user_annotation", "ts": 100, "dur": 1000})
    for i, cat in enumerate(cats):
        ev.append({"ph": "X", "pid": 0, "tid": 7, "name": f"k{i}", "cat": cat,
                   "ts": 200 + i, "dur": kernel_us})
    # a kernel outside the mark's window never counts
    ev.append({"ph": "X", "pid": 0, "tid": 7, "name": "late", "cat": "kernel",
               "ts": 5000, "dur": 777})
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"traceEvents": ev}))


def test_parse_trace_sums_kernels_inside_the_mark(tmp_path):
    _write_trace(tmp_path / "a" / "x.pt.trace.json", kernel_us=250,
                 cats=("kernel", "kernel", "gpu_memcpy"))
    out = timing.parse_trace(tmp_path, before={})
    assert out["device_busy_s"] == 0.0005  # two kernels; the copy and the late one not
    assert "late" not in out["top_device_ops_s"]
    assert "device_busy_suspect" not in out


def test_parse_trace_rejects_stale_and_accepts_same_mtime_overwrite(tmp_path):
    p = tmp_path / "t" / "x.pt.trace.json"
    _write_trace(p, kernel_us=100)
    before = timing.trace_snapshot(tmp_path)
    assert timing.parse_trace(tmp_path, before=before) == {
        "error": "no new trace produced by this run"}
    mtime = before[p][0]
    _write_trace(p, kernel_us=9000)
    os.utime(p, ns=(mtime, mtime))
    assert timing.parse_trace(tmp_path, before=before)["device_busy_s"] == 0.009


@pytest.mark.parametrize("gpu,cats,phrase", [
    (False, (), "no CUDA device in the trace"),
    (True, ("gpu_memcpy",), "0 'kernel' events"),
    (True, (), "zero device events in the window"),
])
def test_parse_trace_names_an_absent_signal(tmp_path, gpu, cats, phrase):
    _write_trace(tmp_path / "d" / "x.pt.trace.json", kernel_us=10, gpu=gpu, cats=cats)
    (tmp_path / "d" / "x.pt.trace.json").write_text(json.dumps({"traceEvents": [
        e for e in json.loads((tmp_path / "d" / "x.pt.trace.json").read_text())["traceEvents"]
        if e.get("name") != "late"]}))
    out = timing.parse_trace(tmp_path, before={})
    assert out["device_busy_s"] == 0.0
    assert phrase in out["device_busy_suspect"]
    verdict = timing.regression_verdict([1.0, 1.5], prev_wall_rate=100.0, rate=70.0,
                                        device_busy_s=out["device_busy_s"],
                                        prev_device_busy_s=0.5)
    assert "vs_prev_round_device" not in verdict


def test_device_busy_off_the_card_degrades_to_the_references_error():
    cfg = preset("config1")
    out = timing.device_busy(get_backend("torch", device="cpu"), cfg)
    ref = ref_timing.device_busy(ref_get_backend("numpy"), ref_config.preset("config1"))
    assert "error" in out and "host" in out["error"]
    assert out["error"].split("'", 2)[2] == ref["error"].split("'", 2)[2]
    assert "error" in timing.device_busy(get_backend("native"), cfg)


def test_timed_best_of_on_the_cpu_runs_repeats_without_a_warm_up():
    be = get_backend("torch", device="cpu")
    cfg = preset("config1", instances=4)
    res, walls = timing.timed_best_of(be, cfg, repeats=3)
    assert len(walls) == 3 and min(walls) > 0
    ref = ref_get_backend("numpy").run(ref_config.preset("config1", instances=4))
    assert res.rounds.tolist() == ref.rounds.tolist()
    assert res.decision.tolist() == ref.decision.tolist()
    assert not timing.needs_warmup(be)


def test_summary_walls_and_device_legs_equal_the_reference():
    cfg = preset("config3", instances=16)
    res = get_backend("torch", device="cpu").timed_run(cfg)
    ref = ref_get_backend("numpy").timed_run(ref_config.preset("config3", instances=16))
    walls = [0.25, 0.2, 0.3]
    for device in (None, {"device_busy_s": 0.1}, {"error": "no trace"},
                   {"device_busy_s": 0.0, "device_busy_suspect": "absent"}):
        got = metrics.summary(res, walls=walls, device=device, chunk=8)
        want = ref_metrics.summary(ref, walls=walls, device=device, chunk=8)
        for key in ("wall_s", "walls_s", "walls_spread", "device_busy_s",
                    "device_busy_error", "instances_per_sec", "chunk",
                    "wasted_lane_fraction", "mean_max_rounds_per_chunk",
                    "decision_histogram", "rounds_p99"):
            assert got.get(key) == want.get(key), key
    assert "walls_s" not in metrics.summary(res)
    assert json.loads(metrics.dump_summary(res))["decision_histogram"] == \
        ref_metrics.summary(ref)["decision_histogram"]
    assert record.timing_block(walls) == {k: metrics.summary(res, walls=walls)[k]
                                          for k in ("wall_s", "walls_s", "walls_spread")}


# -- profiling --------------------------------------------------------------

def test_profile_writes_a_chrome_trace_with_the_round_bodies_spans(tmp_path, capsys):
    prof = tmp_path / "prof"
    assert cli.main(["run", "--preset", "config3", "--instances", "8", "--device", "cpu",
                     "--profile", str(prof)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ref = ref_get_backend("numpy").run(ref_config.preset("config3", instances=8))
    assert out["decision_histogram"] == np.bincount(ref.decision, minlength=3).tolist()
    (path,) = prof.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"brc/bracha/initial", "brc/bracha/echo", "brc/bracha/ready",
            "brc/coin", "brc/urn2"} <= names
    # no directory, no profile: the run is the same
    with profiling.trace(None):
        pass


# -- rounds: the reference's cases on a tmp tree ------------------------------

def _value(doc):
    try:
        return float(doc.get("parsed", doc).get("value"))
    except (AttributeError, TypeError, ValueError):
        return None


ROUND_TREES = [
    # a dead newest capture: the older usable round
    ("# VERDICT — round 3\n", {"BENCH_r02.json": {"parsed": {"value": 111.0}},
                               "BENCH_r03.json": {"rc": 1}}),
    # several dead rounds in a row, one unparseable
    ("# VERDICT — round 5\n", {"BENCH_r02.json": {"parsed": {"value": 7.0}},
                               "BENCH_r03.json": "{truncated garbage",
                               "BENCH_r04.json": {"rc": 1},
                               "BENCH_r05.json": {"parsed": {}}}),
    # every candidate dead: None
    ("# VERDICT — round 5\n", {"BENCH_r02.json": {"rc": 1}}),
    # never past VERDICT's round: no self-comparison
    ("# VERDICT — round 3\n", {"BENCH_r03.json": {"parsed": {"value": 5.0}},
                               "BENCH_r04.json": {"parsed": {"value": 9.0}}}),
    # an unparseable heading omits the comparison
    ("garbled heading\n", {"BENCH_r03.json": {"parsed": {"value": 5.0}}}),
    # no VERDICT at all: round 1, any artifact
    (None, {"BENCH_r07.json": {"parsed": {"value": 1.0}}}),
]


@pytest.mark.parametrize("verdict,files", ROUND_TREES)
def test_rounds_equal_the_reference_on_a_tmp_tree(tmp_path, verdict, files, capsys):
    if verdict is not None:
        (tmp_path / "VERDICT.md").write_text(verdict)
    for name, doc in files.items():
        (tmp_path / name).write_text(doc if isinstance(doc, str) else json.dumps(doc))
    for usable in (None, lambda d: _value(d) is not None):
        got = rounds.prev_round_artifact("BENCH", root=tmp_path, usable=usable)
        assert got == ref_rounds.prev_round_artifact("BENCH", root=tmp_path, usable=usable)
    assert rounds.verdict_round(tmp_path) == ref_rounds.verdict_round(tmp_path)
    assert rounds.this_round(tmp_path) == ref_rounds.this_round(tmp_path)
    assert rounds.default_artifact("soak", tmp_path) == \
        ref_rounds.default_artifact("soak", tmp_path)
    if verdict == "garbled heading\n":
        assert rounds.prev_round_artifact("BENCH", root=tmp_path) is None
        assert "unparseable" in capsys.readouterr().err


def test_rounds_anchor_on_the_checkout():
    assert rounds.repo_root() == ref_rounds.repo_root()
    assert rounds.default_artifact("serve") == ref_rounds.default_artifact("serve")
    assert dataclasses.is_dataclass(preset("config1"))
