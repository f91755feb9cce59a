"""The port's fleet (serve/fleet.py, serve/worker.py) against the reference
on the CPU.

The counterparts of the reference's ``tests/test_fleet.py``: routing,
bucket affinity, LPT order, whole-rotation stealing, the rotation lane
budget, cancel, backpressure, scale-down, ``_policy_spec`` and HTTP over
the fleet run in ``mode="thread"`` (the reference's two ``trace follow``
cases test a tool the port has not got; cancel and backpressure take their
places). Three ``mode="process"`` cases run here, each with every pipe,
process and wait under a timeout: a SIGKILLed worker whose requests come
back from the survivor under their ids, the port's worker answering the
reference worker's frames for one request with the same reply, and a
worker placed on a card that is not there failing by name. The process
smoke with per-worker traces and the dead-worker ``/healthz`` case are
marked ``slow``, as the reference marks them. Every reply equals the
reference's ``get_backend("numpy").run(cfg)`` per instance and passes both
packages' ``validate_record``. On the CPU the workers' backend runs
``kernel="plain"``, the lane leg.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest
import torch

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.backends import get_backend as ref_get_backend
from byzantinerandomizedconsensus_tpu.backends.compaction import (
    CompactionPolicy as RefPolicy)
from byzantinerandomizedconsensus_tpu.obs import record as ref_record
from byzantinerandomizedconsensus_tpu.serve import admission as ref_admission
from byzantinerandomizedconsensus_tpu.serve.fleet import (
    FleetRequest as RefFleetRequest)
from byzantinerandomizedconsensus_tpu.serve.fleet import FleetServer as RefFleet
from byzantinerandomizedconsensus_tpu.serve.fleet import _policy_spec as ref_policy_spec
from byzantinerandomizedconsensus_tpu_torch.backends import get_backend
from byzantinerandomizedconsensus_tpu_torch.backends.compaction import CompactionPolicy
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.obs import record
from byzantinerandomizedconsensus_tpu_torch.obs import trace
from byzantinerandomizedconsensus_tpu_torch.serve import admission
from byzantinerandomizedconsensus_tpu_torch.serve import fleet as fleet_mod
from byzantinerandomizedconsensus_tpu_torch.serve import worker as worker_mod
from byzantinerandomizedconsensus_tpu_torch.serve.fleet import (
    FleetRequest, FleetServer, _policy_spec)
from byzantinerandomizedconsensus_tpu_torch.serve.server import ConsensusServer, serve_http

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_POLICY = CompactionPolicy(width=8, segment=1)
TIMEOUT = 120.0

#: Two genuinely distinct buckets (benor and bracha never fuse): the heavy
#: one holds a worker long enough for the light worker to go idle and
#: steal; the reference's shapes, with fewer instances.
_HEAVY = SimConfig(protocol="bracha", n=10, f=3, instances=12, seed=77,
                   round_cap=64, delivery="urn", adversary="byzantine")
_LIGHT = SimConfig(protocol="benor", n=4, f=1, instances=2, seed=3,
                   round_cap=16)
_THIRD = SimConfig(protocol="benor", n=9, f=3, instances=6, seed=21,
                   round_cap=64, adversary="crash", init="split")


def _fleet(workers=2, **kw):
    return FleetServer(workers=workers, mode="thread", policy=_POLICY,
                       device="cpu", **kw)


def _ref(cfg):
    return ref_config.SimConfig(**dataclasses.asdict(cfg))


def _check(cfg, rec, rid=None):
    """``rec`` equals the reference's numpy run per instance and passes
    both packages' ``validate_record``."""
    ref = ref_get_backend("numpy").run(_ref(cfg))
    assert rec["rounds"] == [int(r) for r in ref.rounds]
    assert rec["decision"] == [int(d) for d in ref.decision]
    assert record.validate_record(rec) == [] == ref_record.validate_record(rec)
    if rid is not None:
        assert rec["request_id"] == rid


def _wait_inflight(fleet, idx, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with fleet._cv:
            if fleet._workers[idx].inflight:
                return
        time.sleep(0.02)
    raise AssertionError(f"worker {idx} never had work in flight")


# -- the pure seams ------------------------------------------------------------

def test_policy_spec_round_trips_as_the_reference():
    for p, q in ((CompactionPolicy(width=64, segment=2, refill_threshold=0.25),
                  RefPolicy(width=64, segment=2, refill_threshold=0.25)),
                 (CompactionPolicy(width=None, segment=1), RefPolicy(width=None, segment=1))):
        assert CompactionPolicy.parse(_policy_spec(p)) == p
        assert _policy_spec(p) == ref_policy_spec(q)


def test_fleet_rejects_bad_shape_and_a_missing_card():
    with pytest.raises(ValueError, match="workers=0"):
        FleetServer(workers=0)
    with pytest.raises(ValueError, match="mode='coroutine'"):
        FleetServer(workers=2, mode="coroutine")
    with pytest.raises(ValueError, match="rotation_cap=0"):
        FleetServer(workers=2, rotation_cap=0)
    with pytest.raises(ValueError, match="max_respawns=-1"):
        FleetServer(workers=2, max_respawns=-1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device is available.*device='cpu'"):
            FleetServer(workers=2, mode="thread").start()


def test_fleet_placement_names_devices_without_opening_them(monkeypatch):
    rows = fleet_mod.placement(3, "cpu")
    assert [r["device"] for r in rows] == ["cpu"] * 3
    assert all(r["shared"] is True and r["platform"] == "cpu" for r in rows)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    rows = fleet_mod.placement(3, "cuda")
    assert [r["device"] for r in rows] == ["cuda:0", "cuda:1", "cuda:0"]
    assert all(r["shared"] is True and r["platform"] == "gpu" for r in rows)
    assert [r["device"] for r in fleet_mod.placement(2, "cuda:1")] == ["cuda:1"] * 2
    assert fleet_mod.placement(2, "cuda")[0]["shared"] is False
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        fleet_mod.placement(2, "cuda")
    with pytest.raises(ValueError, match="n_workers=0"):
        fleet_mod.placement(0, "cpu")
    assert not torch.cuda.is_initialized()


def test_lpt_rotation_order_and_chunking_equal_the_reference():
    """The pending-rotation key (EDF, tenant deficit, then the LPT chain:
    longest ``round_cap`` first) and the rotation budget's chunking sort
    the same requests the same way as the reference's."""
    port, ref = _fleet(), RefFleet(workers=2, mode="thread")
    long_ = dataclasses.replace(_THIRD, round_cap=96, seed=5)
    cfgs = [_THIRD, long_, dataclasses.replace(_THIRD, seed=6, instances=2)]
    t0 = time.perf_counter()

    def reqs(cls, adm, conv):
        out = []
        for i, c in enumerate(cfgs):
            r = cls(f"f{i:06d}", conv(c), adm.bucket_of(conv(c)))
            r.t_submit = t0
            out.append(r)
        return out

    p, r = reqs(FleetRequest, admission, lambda c: c), reqs(RefFleetRequest, ref_admission, _ref)
    assert port._chain_locked(p) == ref._chain_locked(r) == (96, 14)
    assert port._rotation_key_locked(p[0].bucket, p[:1])[1:] \
        == ref._rotation_key_locked(r[0].bucket, r[:1])[1:]
    assert port._rotation_key_locked(p[0].bucket, p[:2]) < \
        port._rotation_key_locked(p[0].bucket, p[:1])  # the longer chain first
    placed = []
    for fl, rs in ((port, p), (ref, r)):
        w = SimpleNamespace(pending={}, inflight={}, pinned=set(), current_bucket=None,
                            send=lambda req: None, idx=0)
        fl._rotation_cap = 8
        fl._dispatch_locked(w, rs[0].bucket, list(rs))
        placed.append((list(w.inflight), [q.id for q in w.pending[rs[0].bucket]]))
    # round_cap 96 first; the rest, in arrival order, past the 8-lane budget
    assert placed[0] == placed[1] == (["f000001"], ["f000000", "f000002"])


# -- routing, affinity, stealing ------------------------------------------------

def test_thread_fleet_routes_steals_and_bit_matches():
    """Same-bucket affinity keeps a bucket on one worker; a worker going
    idle takes the cross-bucket pending rotation; every reply equals the
    reference's under its fleet id; each row names its leg and device."""
    heavy2 = dataclasses.replace(_HEAVY, seed=78)
    with _fleet(segment_latency_s=0.05) as fleet:
        h_heavy = fleet.submit(_HEAVY, pin_worker=0)
        h_light = fleet.submit(_LIGHT, pin_worker=1)
        h_third = fleet.submit(_THIRD)
        h_heavy2 = fleet.submit(heavy2)
        handles = (h_heavy, h_light, h_third, h_heavy2)
        recs = [h.wait(timeout=TIMEOUT) for h in handles]
        stats = fleet.stats(live=True)
        assert fleet.leg == "lanes"
    assert (stats["submitted"], stats["replied"], stats["failed"],
            stats["lost_workers"]) == (4, 4, 0, 0)
    assert all(row["replied"] >= 1 for row in stats["per_worker"])
    assert [(row["leg"], row["device"]) for row in stats["per_worker"]] == [("lanes", "cpu")] * 2
    assert all(row["server"]["compile_count"] >= 1 for row in stats["per_worker"])
    assert all(h.service_s > 0 and 0 <= h.queue_s <= h.latency_s for h in handles)
    for h, rec, cfg in zip(handles, recs, (_HEAVY, _LIGHT, _THIRD, heavy2)):
        _check(cfg, rec, h.id)


def test_thread_fleet_steals_from_busiest_queue():
    with _fleet(segment_latency_s=0.08) as fleet:
        hs = [fleet.submit(_HEAVY, pin_worker=0), fleet.submit(_LIGHT, pin_worker=1),
              fleet.submit(_THIRD)]
        for h in hs:
            h.wait(timeout=TIMEOUT)
        stats = fleet.stats(live=False)
    assert stats["steals"] >= 1 or all(row["replied"] >= 1 for row in stats["per_worker"])


def test_rotation_cap_splits_hot_bucket_across_workers():
    cfgs = [dataclasses.replace(_THIRD, seed=s) for s in range(30, 38)]
    with _fleet(segment_latency_s=0.05, rotation_cap=6) as fleet:
        handles = [fleet.submit(c) for c in cfgs]
        recs = [h.wait(timeout=TIMEOUT) for h in handles]
        stats = fleet.stats(live=False)
    assert stats["failed"] == 0 and stats["replied"] == len(cfgs)
    assert stats["rotation_cap"] == 6 and stats["steals"] >= 1
    assert all(row["replied"] >= 1 for row in stats["per_worker"])
    for h, rec, cfg in zip(handles, recs, cfgs):
        _check(cfg, rec, h.id)


def test_thread_fleet_migrates_live_lanes_to_an_idle_worker():
    """``migrate=True``: with nothing whole to steal, the idle worker
    imports serialized lanes of the busy one's rotation; every reply still
    equals the reference's."""
    cfgs = [dataclasses.replace(_HEAVY, seed=s, instances=16) for s in range(90, 94)]
    with _fleet(segment_latency_s=0.05, migrate=True) as fleet:
        handles = [fleet.submit(c, pin_worker=0 if i == 0 else None)
                   for i, c in enumerate(cfgs)]
        recs = [h.wait(timeout=TIMEOUT) for h in handles]
        stats = fleet.stats(live=False)
    assert stats["failed"] == 0 and stats["replied"] == len(cfgs)
    assert stats["migrations"] >= 1 and stats["lanes_migrated"] >= 1
    for h, rec, cfg in zip(handles, recs, cfgs):
        _check(cfg, rec, h.id)


def test_fleet_shutdown_no_drain_fails_pending():
    fleet = _fleet(workers=1).start()
    h = fleet.submit(_LIGHT)
    fleet.shutdown(drain=True)
    assert h.error is None and h.record is not None
    with pytest.raises(RuntimeError, match="shutting down"):
        fleet.submit(_LIGHT)
    fleet = _fleet(workers=1, segment_latency_s=0.1).start()
    live = fleet.submit(_HEAVY)
    queued = fleet.submit(_THIRD)
    fleet.shutdown(drain=False)
    assert queued.error == "fleet shutdown before dispatch"
    _check(_HEAVY, live.wait(timeout=TIMEOUT), live.id)


def test_thread_fleet_kill_is_refused():
    fleet = _fleet(workers=1).start()
    try:
        with pytest.raises(RuntimeError, match="mode='process'"):
            fleet._workers[0].kill()
    finally:
        fleet.shutdown(drain=True)


# -- cancel and backpressure -------------------------------------------------------

def test_thread_fleet_cancel_queued_and_live_survivors_bit_identical():
    with _fleet(workers=1, segment_latency_s=0.1) as fleet:
        live = fleet.submit(_HEAVY)
        _wait_inflight(fleet, 0)
        queued = fleet.submit(_THIRD)  # another bucket: parent-side queue
        assert fleet.cancel(queued.id) == {"id": queued.id, "found": True,
                                           "cancelled": True, "where": "queued"}
        assert fleet.cancel(live.id)["where"] == "live"
        survivor = fleet.submit(_LIGHT)
        for h in (queued, live):
            assert h.done.wait(TIMEOUT) and h.error == "cancelled" and h.record is None
        _check(_LIGHT, survivor.wait(timeout=TIMEOUT), survivor.id)
        late = fleet.cancel(survivor.id)
        assert late == {"id": survivor.id, "found": False, "cancelled": False,
                        "done": False}
        st = fleet.stats(live=False)
    assert (st["cancelled"], st["replied"], st["failed"]) == (2, 1, 0)


def test_thread_fleet_backpressure_rotation_queue_and_tenant_cap():
    with _fleet(workers=1, segment_latency_s=0.1, rotation_queue_depth=1,
                tenant_inflight_cap=2) as fleet:
        first = fleet.submit({**dataclasses.asdict(_HEAVY), "tenant": "a"})
        _wait_inflight(fleet, 0)
        # same bucket: joins the live rotation, tenant a now at its cap
        second = fleet.submit({**dataclasses.asdict(_HEAVY), "seed": 5, "tenant": "a"})
        with pytest.raises(admission.Backpressure) as exc:
            fleet.submit({**dataclasses.asdict(_HEAVY), "seed": 6, "tenant": "a"})
        assert exc.value.reason == "tenant_cap"
        third = fleet.submit({**dataclasses.asdict(_THIRD), "tenant": "b"})  # queued
        with pytest.raises(admission.Backpressure) as exc:
            fleet.submit({**dataclasses.asdict(_LIGHT), "tenant": "c"})
        assert exc.value.reason == "overflow" and 0.05 <= exc.value.retry_after_s <= 0.5
        for h, cfg in ((first, _HEAVY), (second, dataclasses.replace(_HEAVY, seed=5)),
                       (third, _THIRD)):
            _check(cfg, h.wait(timeout=TIMEOUT), h.id)
        st = fleet.stats(live=False)
    assert st["bounds"] == {"feed_depth": None, "rotation_queue_depth": 1,
                            "tenant_inflight_cap": 2}
    assert st["submitted"] == 3


# -- elasticity -----------------------------------------------------------------------

def test_thread_fleet_scale_down_retires_not_dead():
    victims = [dataclasses.replace(_HEAVY, seed=201), dataclasses.replace(_HEAVY, seed=202)]
    with _fleet(segment_latency_s=0.2) as fleet:
        doomed = [fleet.submit(c, pin_worker=1) for c in victims]
        _wait_inflight(fleet, 1)
        assert fleet.scale_down(1) == 1
        health = fleet.health()
        assert health["ok"] is True and health["retiring"] == [1]
        st = fleet.stats(live=False)
        assert st["routable"] == 1 and st["workers"] == 2
        for h, cfg in zip(doomed, victims):
            _check(cfg, h.wait(timeout=TIMEOUT), h.id)
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and fleet.health().get("retiring"):
            time.sleep(0.05)
        assert fleet.health() == {"ok": True, "workers": 1, "alive": 1,
                                  "dead_workers": []}
        st = fleet.stats(live=False)
        assert st["lost_workers"] == 0 and st["retired_workers"] == 1


def test_thread_fleet_all_workers_share_one_front_door():
    with _fleet() as fleet:
        with pytest.raises(ValueError, match="unknown request field"):
            fleet.submit({"n": 5, "banana": 1})
        with pytest.raises(ValueError, match="exceeds the service ceiling"):
            fleet.submit(SimConfig(n=4, f=1, round_cap=256))
        assert fleet.stats(live=False)["submitted"] == 0


def test_http_over_the_fleet():
    """``serve_http`` runs unchanged in front of the fleet: /run, /submit
    then /result, /cancel, /stats (two workers and their legs, a parent
    that never brought CUDA up) and /healthz."""
    def http(base, path, payload=None, method=None):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(base + path, data=data, method=method,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read().decode())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read().decode())

    with _fleet() as fleet:
        httpd = serve_http(fleet, host="127.0.0.1", port=0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = "http://%s:%s" % httpd.server_address[:2]
        try:
            code, rec = http(base, "/run", dataclasses.asdict(_THIRD))
            assert code == 200
            _check(_THIRD, rec, "f000001")
            code, doc = http(base, "/submit", dataclasses.asdict(_LIGHT))
            assert code == 200 and doc == {"id": "f000002", "done": False}
            deadline = time.monotonic() + TIMEOUT
            while (code := http(base, "/result/f000002")[0]) == 202:
                assert time.monotonic() < deadline
                time.sleep(0.05)
            code, rec = http(base, "/result/f000002")
            assert code == 200
            _check(_LIGHT, rec, "f000002")
            code, ack = http(base, "/cancel/f000002", method="POST")
            assert code == 200 and ack["cancelled"] is False
            code, stats = http(base, "/stats")
            assert code == 200 and stats["workers"] == 2 and stats["replied"] == 2
            assert [r["leg"] for r in stats["per_worker"]] == ["lanes", "lanes"]
            assert stats["parent_cuda_initialized"] is False or torch.cuda.is_initialized()
            assert http(base, "/healthz") == (200, {"ok": True, "workers": 2, "alive": 2,
                                                    "dead_workers": []})
            assert http(base, "/submit", {"n": 5, "banana": 1})[0] == 400
        finally:
            httpd.shutdown()
            httpd.server_close()


def test_direct_leg_worker_imports_an_unstarted_record_afresh():
    """A worker on the direct leg (here the object oracle, which takes it
    on the CPU) imports a record none of whose lanes ran by admitting its
    config afresh, bit-identically; a record with lanes in flight is
    refused by name."""
    lanes = ConsensusServer(get_backend("torch", device="cpu"), policy=_POLICY)
    h = lanes.submit(_THIRD)  # not started: queued, so exported trivially
    (rec,) = lanes.export_lanes([h.id])
    with ConsensusServer(get_backend("cpu"), policy=_POLICY) as direct:
        assert direct.leg == "direct"
        got = worker_mod.import_record(direct, rec.to_doc())
        _check(_THIRD, got.wait(timeout=TIMEOUT))
        doc = rec.to_doc()
        doc["pending"] = doc["pending"][1:]
        with pytest.raises(ValueError, match="kernel='plain'"):
            worker_mod.import_record(direct, doc)


# -- mode="process" ----------------------------------------------------------------------

def test_process_fleet_worker_loss_readmits_bit_identical():
    """SIGKILL one worker mid-stream: its requests come back from the
    survivor under the same fleet ids, equal to the reference's."""
    victims = [_THIRD, dataclasses.replace(_THIRD, seed=101)]
    with FleetServer(workers=2, mode="process", policy=_POLICY, device="cpu",
                     segment_latency_s=0.2, spawn_timeout_s=60.0) as fleet:
        assert all(w.ready_s is not None for w in fleet._workers)
        doomed = [fleet.submit(c, pin_worker=0) for c in victims]
        safe = fleet.submit(_LIGHT, pin_worker=1)
        _wait_inflight(fleet, 0)
        fleet._workers[0].kill()
        recs = [h.wait(timeout=TIMEOUT) for h in doomed]
        safe_rec = safe.wait(timeout=TIMEOUT)
        stats = fleet.stats(live=False)
        assert fleet.health()["dead_workers"] == [0]
    assert stats["lost_workers"] == 1 and stats["readmitted"] >= 1
    assert (stats["failed"], stats["replied"]) == (0, 3)
    for h, rec, cfg in zip(doomed, recs, victims):
        _check(cfg, rec, h.id)
    _check(_LIGHT, safe_rec, safe.id)


def _frames(argv, frames, env, timeout=60.0):
    """Send ``frames`` to a worker process, read until its ``bye``."""
    proc = subprocess.Popen(argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True, cwd=ROOT, env=env)
    try:
        out, _ = proc.communicate(
            "".join(json.dumps(f) + "\n" for f in frames), timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    return [json.loads(line) for line in out.splitlines() if line.strip()]


def test_port_worker_answers_the_reference_workers_frames():
    """The same frames to the reference's worker (numpy) and the port's
    (CPU): the same frame sequence, reply fields and per-instance
    results, each under the fleet id."""
    cfg = dataclasses.asdict(_THIRD)
    frames = [{"op": "submit", "id": "f000007", "cfg": cfg},
              {"op": "submit", "id": "f000008", "cfg": {"n": 5, "banana": 1}},
              {"op": "shutdown"}]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    ref = _frames([sys.executable, "-m", "byzantinerandomizedconsensus_tpu.serve.worker",
                   "--index", "0", "--backend", "numpy", "--policy", "width=8,segment=1"],
                  frames, env)
    port = _frames([sys.executable, "-c", worker_mod.BOOTSTRAP, "--index", "0",
                    "--device", "cpu", "--policy", "width=8,segment=1"], frames, env)
    assert [f["op"] for f in port] == [f["op"] for f in ref] == \
        ["ready", "fail", "reply", "bye"]
    assert set(ref[0]) <= set(port[0]) and port[0]["leg"] == "lanes"
    assert port[1]["id"] == ref[1]["id"] == "f000008"
    assert "unknown request field" in port[1]["error"] and port[1]["error"] == ref[1]["error"]
    pr, rr = port[2], ref[2]
    assert set(pr) == set(rr) | {"timing"} and set(pr["record"]) == set(rr["record"])
    assert pr["timing"]["service_s"] > 0 and pr["timing"]["queue_s"] >= 0
    for key in ("request_id", "rounds", "decision", "inst_ids", "bucket", "config"):
        assert pr["record"][key] == rr["record"][key], key
    _check(_THIRD, pr["record"], "f000007")
    assert port[3]["stats"]["replied"] == ref[3]["stats"]["replied"] == 1


def test_worker_on_a_missing_card_fails_by_name():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the worker serves on it")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", worker_mod.BOOTSTRAP, "--index", "1",
                           "--device", "cuda:0"], capture_output=True, text=True,
                          timeout=60, cwd=ROOT, env=env, stdin=subprocess.DEVNULL)
    assert proc.returncode == worker_mod.EXIT_NO_DEVICE
    assert proc.stdout == ""  # no ready frame
    assert "fleet worker 1: device cuda:0 is not available" in proc.stderr


@pytest.mark.slow
def test_process_fleet_smoke_and_per_worker_traces(tmp_path):
    with FleetServer(workers=2, mode="process", policy=_POLICY, device="cpu",
                     trace_dir=str(tmp_path), spawn_timeout_s=60.0) as fleet:
        handles = [fleet.submit(c) for c in (_HEAVY, _LIGHT, _THIRD)]
        recs = [h.wait(timeout=TIMEOUT) for h in handles]
        counts = fleet.compile_counts()
        stats = fleet.stats(live=True)
    assert stats["replied"] == 3 and stats["failed"] == 0
    assert len(counts) == 2 and all(c is not None for c in counts)
    for h, rec, cfg in zip(handles, recs, (_HEAVY, _LIGHT, _THIRD)):
        _check(cfg, rec, h.id)
    sinks = sorted(p.name for p in tmp_path.glob("trace-fleet-w*.jsonl"))
    assert sinks == ["trace-fleet-w0.jsonl", "trace-fleet-w1.jsonl"]
    events = trace.read_events(trace.merge(tmp_path))
    assert any(e["kind"] == "serve.reply" for e in events)


@pytest.mark.slow
def test_process_fleet_healthz_names_dead_worker():
    with FleetServer(workers=2, mode="process", policy=_POLICY, device="cpu",
                     spawn_timeout_s=60.0) as fleet:
        httpd = serve_http(fleet, host="127.0.0.1", port=0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = "http://%s:%s" % httpd.server_address[:2]
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
                assert json.loads(r.read()) == {"ok": True, "workers": 2, "alive": 2,
                                                "dead_workers": []}
            safe = fleet.submit(_LIGHT, pin_worker=1)
            fleet._workers[0].kill()
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline and fleet.health()["ok"]:
                time.sleep(0.05)
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(base + "/healthz", timeout=30)
            assert exc.value.code == 503
            doc = json.loads(exc.value.read())
            assert doc == {"ok": False, "workers": 2, "alive": 1, "dead_workers": [0]}
            _check(_LIGHT, safe.wait(timeout=TIMEOUT), safe.id)
        finally:
            httpd.shutdown()
            httpd.server_close()
