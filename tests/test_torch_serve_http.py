"""The port's HTTP front end (serve/server.py::serve_http) and ``cli serve``
against the reference on the CPU.

The counterparts of the reference's HTTP cases: the metrics plane and
``/healthz`` (``tests/test_serve.py``), 503 ``recovering`` with Retry-After
(``test_elastic.py``), 429 + Retry-After under a bounded feed
(``test_hostile.py``); the routes' codes (200, 202, 400, 404, 413, 500);
and ``cli serve`` as a process: a SIGKILL with replies owed and a restart
with ``--recover`` returning every owed reply under its original id, the
fleet options and a missing card refused by name. Every reply equals the
reference's ``get_backend("numpy").run(cfg)`` per instance; every process
and HTTP call has a timeout.
"""

import dataclasses
import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.backends import get_backend as ref_get_backend
from byzantinerandomizedconsensus_tpu.obs import record as ref_record
from byzantinerandomizedconsensus_tpu.serve import wal as ref_wal
from byzantinerandomizedconsensus_tpu_torch.backends.compaction import CompactionPolicy
from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import TorchBackend
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.obs import metrics
from byzantinerandomizedconsensus_tpu_torch.serve import admission
from byzantinerandomizedconsensus_tpu_torch.serve import server as server_mod
from byzantinerandomizedconsensus_tpu_torch.serve.server import ConsensusServer, serve_http

ROOT = pathlib.Path(__file__).resolve().parent.parent
_POLICY = CompactionPolicy(width=8, segment=1)
_CEILING = 64
HTTP_TIMEOUT = 60
TIMEOUT = 600.0

_CFGS = [
    SimConfig(protocol="benor", n=5, f=1, instances=6, seed=3, round_cap=32),
    SimConfig(protocol="benor", n=9, f=3, instances=12, seed=21, round_cap=64,
              adversary="crash", init="split"),
    SimConfig(protocol="bracha", n=7, f=2, instances=4, seed=9, round_cap=32,
              delivery="urn"),
    SimConfig(protocol="bracha", n=10, f=3, instances=9, seed=77, round_cap=64,
              delivery="urn", adversary="byzantine"),
]


def _cfg(seed, *, protocol="benor", n=5, f=1, instances=8, round_cap=48,
         delivery="keys"):
    return SimConfig(protocol=protocol, n=n, f=f, instances=instances,
                     adversary="none", coin="local", init="random", seed=seed,
                     round_cap=round_cap, delivery=delivery).validate()


def _server(**kw):
    return ConsensusServer(TorchBackend(device="cpu"), **{"policy": _POLICY, **kw})


def _assert_numpy(cfg, rec):
    ref = ref_get_backend("numpy").run(ref_config.SimConfig(**dataclasses.asdict(cfg)))
    assert rec["rounds"] == [int(r) for r in ref.rounds]
    assert rec["decision"] == [int(d) for d in ref.decision]


def _http(base, path, payload=None, raw=None, method=None):
    """``(code, JSON document, headers)`` of one HTTP call."""
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            return r.status, json.loads(r.read().decode()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode()), e.headers


def _poll_result(base, rid, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        code, doc, _ = _http(base, f"/result/{rid}")
        if code != 202:
            return code, doc
        time.sleep(0.05)
    raise AssertionError(f"no result for {rid} within {timeout} s")


class _Front:
    """A started server behind ``serve_http`` on an ephemeral port."""

    def __init__(self, srv):
        self.srv = srv
        self.httpd = serve_http(srv, host="127.0.0.1", port=0)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.base = "http://%s:%s" % self.httpd.server_address[:2]

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


# -- the reference's test_serve.py HTTP cases ------------------------------

def test_serve_metrics_plane_bit_identical_and_exposed():
    metrics.configure()
    try:
        with _server() as srv:
            front = _Front(srv)
            try:
                handles = [srv.submit(c) for c in _CFGS]
                recs = [h.wait(timeout=TIMEOUT) for h in handles]
                with pytest.raises(ValueError, match="service ceiling"):
                    srv.submit({"n": 4, "f": 1, "round_cap": 256})
                with urllib.request.urlopen(front.base + "/metrics",
                                            timeout=HTTP_TIMEOUT) as r:
                    assert r.status == 200
                    assert r.headers["Content-Type"] == metrics.CONTENT_TYPE
                    body = r.read().decode()
                code, health, _ = _http(front.base, "/healthz")
                assert code == 200
                stats = srv.stats()
            finally:
                front.close()
    finally:
        metrics.disable()
    for cfg, rec in zip(_CFGS, recs):
        _assert_numpy(cfg, rec)
    assert stats["workers"] == 1 and stats["alive"] == 1
    row = stats["per_worker"][0]
    assert {"worker", "pid", "alive", "replied", "steals", "inflight", "pending",
            "load"} <= set(row)
    assert row["replied"] == len(_CFGS) and row["steals"] == 0
    assert health["ok"] is True and health["dead_workers"] == []
    snap = metrics.parse_text(body)
    assert snap["brc_serve_replied_total"]["series"][0]["value"] == len(_CFGS)
    lat = snap["brc_serve_request_latency_seconds"]["series"][0]
    assert lat["count"] == len(_CFGS) and lat["sum"] > 0
    for name in ("brc_serve_queue_wait_seconds", "brc_serve_service_seconds"):
        assert snap[name]["series"][0]["count"] == len(_CFGS)
    rejected = {s["labels"].get("reason"): s["value"]
                for s in snap["brc_serve_rejected_total"]["series"]}
    assert rejected.get("cap_ceiling") == 1
    assert ((metrics._sum_values(snap, "brc_compile_cache_compiles_total") or 0)
            + (metrics._sum_values(snap, "brc_compile_cache_hits_total") or 0)) > 0
    s = metrics.summary(snap)
    assert s["replied"] == len(_CFGS) and s["error_rate"] == 0.0
    assert s["p99_latency_ms"] is not None


def test_serve_healthz_degrades_to_503_when_stopped():
    srv = _server().start()
    front = _Front(srv)
    try:
        assert _http(front.base, "/healthz")[0] == 200
        srv.shutdown(drain=True, timeout=TIMEOUT)
        assert srv.health()["ok"] is False and srv.health()["dead_workers"] == [0]
        code, doc, _ = _http(front.base, "/healthz")
        assert code == 503 and doc["ok"] is False and doc["dead_workers"] == [0]
    finally:
        front.close()


# -- the reference's test_elastic.py and test_hostile.py HTTP cases ---------

def test_submit_during_recovery_rejects_503_with_retry_after():
    metrics.configure()
    try:
        with _server() as srv:
            front = _Front(srv)
            try:
                srv._recovering = True
                with pytest.raises(admission.Backpressure) as exc:
                    srv.submit(_cfg(60))
                assert exc.value.reason == "recovering"
                body = dataclasses.asdict(_cfg(61))
                code, doc, headers = _http(front.base, "/submit", body)
                assert code == 503 and float(headers["Retry-After"]) > 0
                assert doc["reason"] == "recovering"
                series = metrics.snapshot()["brc_serve_rejected_total"]["series"]
                assert any(s["labels"].get("reason") == "recovering" and s["value"] >= 2
                           for s in series)
                srv._recovering = False
                code, doc, _ = _http(front.base, "/submit", body)
                assert code == 200
                code, rec = _poll_result(front.base, doc["id"])
                assert code == 200
                _assert_numpy(_cfg(61), rec)
            finally:
                srv._recovering = False
                front.close()
    finally:
        metrics.disable()


def test_http_429_retry_after_round_trip():
    cfgs = [_cfg(40 + i, instances=16, round_cap=_CEILING) for i in range(4)]
    with _server(round_cap_ceiling=_CEILING, feed_depth=1) as srv:
        front = _Front(srv)
        try:
            rejected, ids = 0, []
            for i, c in enumerate(cfgs):
                if i == 1:
                    t0 = time.monotonic()
                    while time.monotonic() - t0 < TIMEOUT:
                        st = srv.stats()
                        if st["active_bucket"] and st["feed_depth"] == 0:
                            break
                        time.sleep(0.01)
                for _ in range(400):
                    code, doc, headers = _http(front.base, "/submit", dataclasses.asdict(c))
                    if code == 200:
                        ids.append(doc["id"])
                        break
                    assert code == 429 and doc["reason"] == "overflow"
                    hint = float(headers["Retry-After"])
                    assert 0.0 < hint < 1.0
                    rejected += 1
                    time.sleep(hint)
                else:
                    pytest.fail("submit never accepted")
            assert rejected >= 1
            recs = [_poll_result(front.base, rid)[1] for rid in ids]
            code, doc, _ = _http(front.base, "/cancel/r-nope", raw=b"", method="POST")
            assert code == 404 and "error" in doc
        finally:
            front.close()
    for c, rec in zip(cfgs, recs):
        _assert_numpy(c, rec)


# -- the routes --------------------------------------------------------------

def test_routes_codes_and_replies():
    """POST /run answers with the record; /submit then /result/<id> (202
    while pending, 200 after); /cancel of a queued id; 400 on a bad
    payload, 404 on unknown ids and paths, 413 over the body cap, 500 for
    a cancelled request's result; /stats carries the leg."""
    srv = _server()  # not started yet: /submit stays queued
    front = _Front(srv)
    try:
        code, doc, _ = _http(front.base, "/submit", dataclasses.asdict(_CFGS[0]))
        assert code == 200 and doc == {"id": "r000001", "done": False}
        assert _http(front.base, "/result/r000001")[:2] == (202, {"id": "r000001",
                                                                  "done": False})
        code, victim, _ = _http(front.base, "/submit", dataclasses.asdict(_CFGS[1]))
        code, ack, _ = _http(front.base, f"/cancel/{victim['id']}", raw=b"", method="POST")
        assert code == 200 and ack["cancelled"] and ack["where"] == "queued"
        srv.start()
        code, rec = _poll_result(front.base, "r000001")
        assert code == 200 and rec["request_id"] == "r000001"
        _assert_numpy(_CFGS[0], rec)
        assert ref_record.validate_record(rec) == []
        code, err = _poll_result(front.base, victim["id"])
        assert code == 500 and err["error"] == "cancelled"
        code, rec, _ = _http(front.base, "/run", {**dataclasses.asdict(_CFGS[2]),
                                                  "check_invariants": True})
        assert code == 200 and rec["invariants"]["violations"] == 0
        _assert_numpy(_CFGS[2], rec)
        assert _http(front.base, "/submit", {"n": 5, "banana": 1})[0] == 400
        assert _http(front.base, "/submit", raw=b"{not json")[0] == 400
        assert _http(front.base, "/result/r-nope")[0] == 404
        assert _http(front.base, "/nope")[0] == 404
        assert _http(front.base, "/nope", {})[0] == 404
        big = b"{" + b" " * (server_mod.MAX_BODY_BYTES + 1) + b"}"
        code, doc, _ = _http(front.base, "/submit", raw=big)
        assert code == 413 and "exceeds" in doc["error"]
        code, stats, _ = _http(front.base, "/stats")
        assert code == 200 and stats["leg"] == "lanes" and stats["device"] == "cpu"
        assert stats["replied"] == 2 and stats["cancelled"] == 1
    finally:
        front.close()
        srv.shutdown(timeout=TIMEOUT)


# -- cli serve as a process ---------------------------------------------------

def _spawn_serve(*args):
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    return subprocess.Popen(
        [sys.executable, "-m", "byzantinerandomizedconsensus_tpu_torch.cli", "serve",
         "--device", "cpu", "--port", "0", "--policy", "width=256,segment=4", *args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)


def _listening(proc, timeout=120.0):
    """The base URL from the process's listening line."""
    found = {}

    def read():
        for line in proc.stdout:
            m = re.search(r"listening on (http://\S+)", line)
            if m:
                found["base"] = m.group(1)
                return

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(timeout)
    if "base" not in found:
        proc.kill()
        raise AssertionError(f"cli serve did not start within {timeout} s")
    threading.Thread(target=lambda: [None for _ in proc.stdout], daemon=True).start()
    return found["base"]


def _stop(proc):
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)


def test_cli_serve_sigkill_then_recover_returns_every_owed_reply(tmp_path):
    """``cli serve --wal DIR`` is SIGKILLed with replies owed; restarted
    with ``--recover DIR`` it answers ``/result/<original id>`` for every
    owed request, equal to the offline run; a request that replied before
    the kill is journaled done and is not replayed."""
    heavy = _cfg(7, protocol="bracha", n=40, f=13, instances=2048, round_cap=64,
                 delivery="urn2")
    light = [_cfg(8), _CFGS[2], _CFGS[3]]
    wal_dir = tmp_path / "wal"
    proc = _spawn_serve("--wal", str(wal_dir))
    try:
        base = _listening(proc)
        ids = [_http(base, "/submit", dataclasses.asdict(c))[1]["id"]
               for c in [heavy] + light]
    finally:
        proc.kill()
        proc.wait(timeout=60)
    assert ids == ["r000001", "r000002", "r000003", "r000004"]
    owed = [e["id"] for e in ref_wal.WriteAheadLog.plan_recovery(str(wal_dir))[0]]
    assert "r000001" in owed
    proc = _spawn_serve("--recover", str(wal_dir))
    try:
        base = _listening(proc)
        for rid, cfg in zip(ids, [heavy] + light):
            code, rec = _poll_result(base, rid)
            if rid in owed:
                assert code == 200 and rec["request_id"] == rid
                _assert_numpy(cfg, rec)
            else:
                assert code == 404
        code, doc, _ = _http(base, "/submit", dataclasses.asdict(_CFGS[0]))
        assert code == 200 and doc["id"] == "r000005"
        code, rec = _poll_result(base, doc["id"])
        _assert_numpy(_CFGS[0], rec)
    finally:
        _stop(proc)
    assert ref_wal.WriteAheadLog.plan_recovery(str(wal_dir)) == ([], 5)


@pytest.mark.parametrize("flags", [["--workers", "2"], ["--max-workers", "2"],
                                   ["--min-workers", "1"], ["--max-respawns", "1"],
                                   ["--migrate"]])
def test_cli_serve_refuses_the_fleet_options_by_name(flags, capsys):
    from byzantinerandomizedconsensus_tpu_torch import cli

    assert cli.main(["serve", "--device", "cpu", *flags]) == 2
    err = capsys.readouterr().err
    assert flags[0] in err and "ROADMAP Queue 1 item 6b" in err


def test_cli_serve_without_a_card_exits_nonzero_by_name():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: cli serve runs on it")
    proc = subprocess.run(
        [sys.executable, "-m", "byzantinerandomizedconsensus_tpu_torch.cli", "serve",
         "--port", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert "no CUDA device is available" in proc.stderr and "--device cpu" in proc.stderr
    assert "listening" not in proc.stdout
