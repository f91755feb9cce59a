"""The port's hostile-load suite and elastic drills (tools/hostile.py)
against the reference on the CPU.

Each scenario's population is the reference's: both packages' scenario
functions run against one recording stand-in server, and submit the same
payloads (envelopes included) and cancel the same victims. Run for real on
the CPU (the lane leg), at the smoke sizes, every scenario's replies equal
the reference's numpy results (the suite's own differential, pointed at the
reference) with 0 steady-state builds; only what a scenario makes
deterministic is asserted, never a timing gate. One subprocess each for
``cli loadgen --scenario bucket_churn --smoke`` and the ``dispatcher_kill``
drill (the reference's ``tests/test_elastic.py`` drill), each with its own
timeout. The preempt family refuses a leg without lanes by name.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import threading
import time
import types

import pytest

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.backends import get_backend as ref_get_backend
from byzantinerandomizedconsensus_tpu.backends.compaction import (
    CompactionPolicy as RefPolicy)
from byzantinerandomizedconsensus_tpu.models import session as ref_session_mod
from byzantinerandomizedconsensus_tpu.obs import record as ref_record
from byzantinerandomizedconsensus_tpu.serve import server as ref_server_mod
from byzantinerandomizedconsensus_tpu.tools import hostile as ref_hostile
from byzantinerandomizedconsensus_tpu_torch.backends.compaction import CompactionPolicy
from byzantinerandomizedconsensus_tpu_torch.models import session as session_mod
from byzantinerandomizedconsensus_tpu_torch.obs import metrics
from byzantinerandomizedconsensus_tpu_torch.obs import record
from byzantinerandomizedconsensus_tpu_torch.serve import server as server_mod
from byzantinerandomizedconsensus_tpu_torch.tools import hostile

ROOT = pathlib.Path(__file__).resolve().parent.parent
SUBPROCESS_TIMEOUT = 560


def test_suite_constants_equal_the_reference():
    for name in ("HOSTILE_GENERATOR_VERSION", "SCENARIOS", "ELASTIC_SCENARIOS",
                 "PREEMPT_SCENARIOS", "ROUND_CAP_CEILING", "_SIZES",
                 "_HOG_SESSION_SLOTS", "_FAIRNESS_FLOOR_MS"):
        assert getattr(hostile, name) == getattr(ref_hostile, name), name
    assert set(hostile._RUNNERS) == set(ref_hostile._RUNNERS)
    assert set(hostile._ELASTIC_RUNNERS) == set(ref_hostile._ELASTIC_RUNNERS)


def test_config_builders_equal_the_reference():
    for args in [("benor", 5, 1, 7), ("bracha", 7, 2, 9), ("benor", 9, 3, 11)]:
        for kw in ({}, {"delivery": "urn", "instances": 6, "round_cap": 48},
                   {"adversary": "crash", "instances": 8, "round_cap": 64}):
            assert dataclasses.asdict(hostile._cfg(*args, **kw)) == \
                dataclasses.asdict(ref_hostile._cfg(*args, **kw))
    for kw in ({}, {"faults": "recover", "adversary": "none", "delivery": "keys"},
               {"faults": "partition", "adversary": "byzantine", "delivery": "urn",
                "instances": 48}):
        assert dataclasses.asdict(hostile._fat_cfg(42, **kw)) == \
            dataclasses.asdict(ref_hostile._fat_cfg(42, **kw))


# -- the populations, through one recording stand-in server -------------------

class _Handle:
    def __init__(self, rid, payload):
        now = time.perf_counter()
        self.id = rid
        self.record = {"rounds": [], "decision": [],
                       "session": {"rounds": [], "decisions": []}}
        self.error = None
        self.t_submit = self.t_dispatch = self.t_reply = now
        self.latency_s = 0.001
        deadline = payload.get("deadline_ms")
        self.t_deadline = None if deadline is None else now + deadline / 1000.0
        self.done = threading.Event()
        self.done.set()

    def wait(self, timeout=None):
        return self.record


class _Recorder:
    """Accepts every request at once and logs what it was asked: the
    scenarios' submissions and cancellations, nothing of their timing."""

    log: list = []

    def __init__(self, *a, **kw):
        self.kw = {k: v for k, v in kw.items() if k != "backend"}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def submit(self, payload):
        doc = payload if isinstance(payload, dict) else dataclasses.asdict(payload)
        rid = f"r{len(_Recorder.log):06d}"
        _Recorder.log.append(("submit", json.dumps(doc, sort_keys=True)))
        return _Handle(rid, doc)

    def cancel(self, rid):
        _Recorder.log.append(("cancel", rid))
        return {"id": rid, "found": True, "cancelled": True, "where": "queued"}

    def compile_count(self):
        return 0

    def stats(self):
        return {"preempt": {"parks": 0, "resumes": 0, "lanes_exported": 0,
                            "lanes_imported": 0}}


def _record(module, server_module, session_module, monkeypatch, name, args):
    _Recorder.log = []
    monkeypatch.setattr(server_module, "ConsensusServer", _Recorder)
    monkeypatch.setattr(module, "_warm", lambda *a, **k: 0)
    monkeypatch.setattr(module, "_mismatch_count", lambda *a, **k: 0)
    monkeypatch.setattr(session_module, "replay_matches", lambda *a, **k: True)
    monkeypatch.setattr(time, "sleep", lambda s: None)
    module._metrics.configure()  # the rejection counters read the registry
    try:
        module._RUNNERS[name](args, 1800 + module.SCENARIOS.index(name))
    finally:
        module._metrics.disable()
    return list(_Recorder.log)


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("name", ["heavy_tail", "bucket_churn", "tenant_hog",
                                  "cancel_storm", "session_hog"])
def test_scenario_population_equals_the_reference(name, smoke, monkeypatch):
    port_args = types.SimpleNamespace(
        smoke=smoke, backend="torch", device="cpu", kernel=None, leg="lanes",
        policy=CompactionPolicy(width=8, segment=1), reference=None)
    ref_args = types.SimpleNamespace(smoke=smoke, backend="numpy",
                                     policy=RefPolicy(width=8, segment=1))
    got = _record(hostile, server_mod, session_mod, monkeypatch, name, port_args)
    want = _record(ref_hostile, ref_server_mod, ref_session_mod, monkeypatch, name,
                   ref_args)
    if name in ("tenant_hog", "session_hog"):
        # two client threads: each tenant's order is fixed, their interleaving not
        got, want = sorted(got), sorted(want)
    assert got == want and len(got) >= hostile._SIZES[name][1 if smoke else 0]


# -- the scenarios for real on the CPU, replies against the reference ----------

class _ReferenceNumpy:
    """The suite's differential pointed at the reference: each config
    through the JAX package's numpy backend."""

    device = "cpu"

    def run(self, cfg, inst_ids=None):
        return ref_get_backend("numpy").run(
            ref_config.SimConfig(**dataclasses.asdict(cfg)), inst_ids)


@pytest.mark.parametrize("name", hostile.SCENARIOS)
def test_scenario_replies_equal_the_references_numpy(name):
    args = types.SimpleNamespace(
        smoke=True, backend="torch", device="cpu", kernel=None, leg="lanes",
        policy=CompactionPolicy.parse("width=8,segment=1"), reference=_ReferenceNumpy())
    metrics.configure()
    try:
        row = hostile._RUNNERS[name](args, 1800 + hostile.SCENARIOS.index(name))
    finally:
        metrics.disable()
    assert row["scenario"] == name and row["mismatches"] == 0
    assert row["steady_state_compiles"] == 0
    assert row["replied"] + row["cancelled"] == row["requests"] == hostile._SIZES[name][1]
    if name == "session_hog":
        assert row["session_replay_ok"]


def test_bucket_churn_smoke_subprocess(tmp_path):
    out = tmp_path / "hostile_smoke.json"
    proc = subprocess.run(
        [sys.executable, "-m", "byzantinerandomizedconsensus_tpu_torch.cli", "loadgen",
         "--scenario", "bucket_churn", "--smoke", "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT, cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    doc = json.loads(out.read_text())
    assert record.validate_record(doc) == [] and ref_record.validate_record(doc) == []
    assert doc["leg"] == "lanes" and doc["device"] == "cpu"
    hb = doc["hostile"]
    assert hb["mismatches"] == 0 and hb["steady_state_compiles"] == 0
    (row,) = hb["scenarios"]
    assert row["scenario"] == "bucket_churn"
    assert row["replied"] == row["requests"] == 9
    assert row["slo_ok"] is True


def test_dispatcher_kill_drill_smoke_subprocess(tmp_path):
    """The reference's kill-the-dispatcher drill: a ``cli serve --wal``
    subprocess SIGKILLed mid-stream, restarted with ``--recover``, every
    owed reply back under its id, equal to the plain driver."""
    out = tmp_path / "elastic_smoke.json"
    proc = subprocess.run(
        [sys.executable, "-m", "byzantinerandomizedconsensus_tpu_torch.tools.loadgen",
         "--scenario", "dispatcher_kill", "--smoke", "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT, cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    doc = json.loads(out.read_text())
    assert record.validate_record(doc) == [] and ref_record.validate_record(doc) == []
    eb = doc["elastic"]
    assert eb["mismatches"] == 0 and eb["steady_state_compiles"] == 0
    assert eb["recovered"] >= 1 and eb["slo_ok"] is True
    (row,) = eb["scenarios"]
    assert row["scenario"] == "dispatcher_kill"
    assert row["replied"] + row["recovered"] >= row["requests"]
    assert row["recovered"] == row["owed"] >= 1


def test_preempt_refuses_a_leg_without_lanes_by_name(monkeypatch, capsys):
    monkeypatch.setattr(hostile, "_leg", lambda args: "direct")
    assert hostile.main(["--scenario", "preempt", "--smoke", "--device", "cpu"]) == 2
    assert "needs the lane leg (--kernel plain)" in capsys.readouterr().err


def test_no_card_no_fallback(capsys):
    assert hostile.main(["--scenario", "bucket_churn", "--smoke"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert hostile.main(["--scenario", "bucket_churn", "--smoke", "--device", "cpu",
                         "--kernel", "fused"]) == 2
    assert "kernel='fused'" in capsys.readouterr().err
