"""The port's elastic fleet (serve/autoscale.py, the fleet's WAL, scale-up
and scale-down, the respawn budget) against the reference on the CPU.

The counterparts of the reference's ``tests/test_elastic.py``: the WAL
cases at the fleet (journaled admits and completions, a torn tail,
bit-identical and idempotent recovery, session envelopes, and a fleet's
journal recovered by the other package's fleet, both ways); the
autoscaler's control law driven through an injected clock, which makes the
reference's decisions on the same stats; the recovering-503 gate over
HTTP; the thread fleet's scale-up and scale-down; the respawn budget on a
process fleet (``slow``, as the reference marks it); and ``cli serve
--workers 2`` SIGKILLed with replies owed and restarted with
``--recover``. The reference's ``loadgen --scenario dispatcher_kill``
drill is ported with the load drivers and held in
``tests/test_torch_hostile.py``. Every reply equals the reference's
``get_backend("numpy").run(cfg)`` per instance.
"""

import dataclasses
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.backends import get_backend as ref_get_backend
from byzantinerandomizedconsensus_tpu.backends.compaction import (
    CompactionPolicy as RefPolicy)
from byzantinerandomizedconsensus_tpu.models import session as ref_session
from byzantinerandomizedconsensus_tpu.serve import wal as ref_wal
from byzantinerandomizedconsensus_tpu.serve.autoscale import Autoscaler as RefAutoscaler
from byzantinerandomizedconsensus_tpu.serve.fleet import FleetServer as RefFleet
from byzantinerandomizedconsensus_tpu_torch.backends.compaction import CompactionPolicy
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.obs import metrics
from byzantinerandomizedconsensus_tpu_torch.serve import admission
from byzantinerandomizedconsensus_tpu_torch.serve.autoscale import Autoscaler
from byzantinerandomizedconsensus_tpu_torch.serve.fleet import FleetServer
from byzantinerandomizedconsensus_tpu_torch.serve.server import serve_http
from byzantinerandomizedconsensus_tpu_torch.serve.wal import WAL_NAME, WriteAheadLog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_POLICY = CompactionPolicy(width=8, segment=1)
TIMEOUT = 120.0


def _cfg(seed: int, **kw) -> SimConfig:
    base = dict(protocol="benor", n=5, f=1, instances=4, adversary="none",
                coin="local", init="random", seed=seed, round_cap=32,
                delivery="keys")
    base.update(kw)
    return SimConfig(**base).validate()


def _ref(cfg):
    return ref_config.SimConfig(**dataclasses.asdict(cfg))


def _offline(cfg):
    ref = ref_get_backend("numpy").run(_ref(cfg))
    return [int(r) for r in ref.rounds], [int(d) for d in ref.decision]


def _assert_offline(cfg, rec):
    rounds, decision = _offline(cfg)
    assert rec["rounds"] == rounds and rec["decision"] == decision


def _fleet(workers=1, **kw):
    return FleetServer(workers=workers, mode="thread", policy=_POLICY, device="cpu",
                       **kw)


# -- the WAL at the fleet ----------------------------------------------------------

def test_fleet_wal_journals_admits_completions_and_closes_refusals(tmp_path):
    """Every admit is journaled before routing and closed at its reply or
    cancel; a request refused by backpressure never reaches the journal;
    after a drain nothing is owed and the counter is the last id."""
    cfgs = [_cfg(1), _cfg(2, protocol="bracha", n=7, f=2)]
    with _fleet(segment_latency_s=0.1, rotation_queue_depth=1,
                wal_dir=str(tmp_path)) as fleet:
        hs = [fleet.submit(c) for c in cfgs]  # the second queues behind the first
        with pytest.raises(admission.Backpressure):
            fleet.submit(_cfg(3, n=9, f=2))
        assert fleet.cancel(hs[1].id)["where"] == "queued"
        _assert_offline(cfgs[0], hs[0].wait(timeout=TIMEOUT))
    entries = WriteAheadLog.read_entries(str(tmp_path))
    assert [(e["op"], e["id"]) for e in entries] == [
        ("admit", "f000001"), ("admit", "f000002"), ("fail", "f000002"),
        ("done", "f000001")]
    assert WriteAheadLog.plan_recovery(str(tmp_path)) == ([], 2)
    assert ref_wal.WriteAheadLog.plan_recovery(str(tmp_path)) == ([], 2)


def test_fleet_starts_on_a_torn_wal_and_recovers_the_complete_entries(tmp_path):
    log = WriteAheadLog(str(tmp_path))
    log.append_admit("f000001", dataclasses.asdict(_cfg(4)), {})
    log.close()
    path = tmp_path / WAL_NAME
    path.write_text(path.read_text() + '{"op": "admit", "id": "f0000')
    with _fleet(wal_dir=str(tmp_path)) as fleet:
        out = fleet.recover(timeout=TIMEOUT)
        assert out["ids"] == ["f000001"] and out["recovered"] == 1
        _assert_offline(_cfg(4), out["handles"][0].record)
    assert [e["op"] for e in WriteAheadLog.read_entries(str(tmp_path))] == ["admit", "done"]


def test_fleet_recovery_replays_bit_identical_and_idempotent(tmp_path):
    cfgs = [_cfg(10), _cfg(11), _cfg(12)]
    log = WriteAheadLog(str(tmp_path))
    for i, c in enumerate(cfgs):
        log.append_admit(f"f{i + 1:06d}", dataclasses.asdict(c), {})
    log.append_done("f000002")
    log.close()
    with _fleet(workers=2, wal_dir=str(tmp_path)) as fleet:
        out = fleet.recover(timeout=TIMEOUT)
        assert out["ids"] == ["f000001", "f000003"]
        assert out["replayed"] == 2 and out["recovered"] == 2 and not fleet.recovering
        for rid, h, c in zip(out["ids"], out["handles"], [cfgs[0], cfgs[2]]):
            rec = h.wait(timeout=TIMEOUT)
            assert rec["request_id"] == rid
            _assert_offline(c, rec)
        h = fleet.submit(_cfg(13))
        assert h.id == "f000004"
        h.wait(timeout=TIMEOUT)
        assert fleet.recover(timeout=TIMEOUT)["replayed"] == 0


def test_fleet_recovery_reproduces_session_envelopes(tmp_path):
    cfg = _cfg(21)
    log = WriteAheadLog(str(tmp_path))
    log.append_admit("f000001", dataclasses.asdict(cfg), {"session_slots": 3})
    log.close()
    with _fleet(wal_dir=str(tmp_path)) as fleet:
        out = fleet.recover(timeout=TIMEOUT)
        rec = out["handles"][0].wait(timeout=TIMEOUT)
    blk = rec["session"]
    assert blk["slots"] == 3 and len(blk["rounds"]) == 3
    ref = ref_session.run_session(ref_get_backend("numpy"), _ref(cfg), 3)
    assert blk["decisions"] == [[int(d) for d in r.decision] for r in ref]
    assert blk["seeds"] == [int(r.config.seed) for r in ref]


def _crash_image(fleet_cm, cfgs, wal_dir, image_dir):
    """Submit ``cfgs`` to a fleet journaling to ``wal_dir`` and copy the
    journal while they are in flight: what a SIGKILLed dispatcher leaves.
    Returns the replies the live fleet gave."""
    with fleet_cm as fleet:
        hs = [fleet.submit(c) for c in cfgs]
        shutil.copytree(wal_dir, image_dir)
        return [h.wait(timeout=TIMEOUT) for h in hs]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_crashed_fleets_journal_recovers_in_the_other_package(tmp_path, writer):
    cfgs = [_cfg(30), _cfg(31, protocol="bracha", n=7, f=2, instances=6)]
    wal_dir, image = tmp_path / "wal", tmp_path / "image"
    if writer == "port":
        live = _crash_image(_fleet(segment_latency_s=0.3, wal_dir=str(wal_dir)), cfgs,
                            wal_dir, image)
        reader = RefFleet(workers=1, mode="thread", backend="numpy",
                          policy=RefPolicy(width=8, segment=1), wal_dir=str(image))
    else:
        live = _crash_image(RefFleet(workers=1, mode="thread", backend="numpy",
                                     policy=RefPolicy(width=8, segment=1),
                                     segment_latency_s=0.3, wal_dir=str(wal_dir)),
                            [_ref(c) for c in cfgs], wal_dir, image)
        reader = _fleet(wal_dir=str(image))
    owed = [e["id"] for e in WriteAheadLog.plan_recovery(str(image))[0]]
    assert owed and owed == [e["id"] for e in
                             ref_wal.WriteAheadLog.plan_recovery(str(image))[0]]
    with reader as fleet:
        out = fleet.recover(timeout=TIMEOUT)
    assert out["ids"] == owed and out["recovered"] == len(owed)
    by_id = {h.id: h.record for h in out["handles"]}
    for cfg, rec in zip(cfgs, live):
        _assert_offline(cfg, rec)
        if rec["request_id"] in by_id:
            got = by_id[rec["request_id"]]
            assert (got["rounds"], got["decision"]) == (rec["rounds"], rec["decision"])


# -- the autoscaler ------------------------------------------------------------------

class _FakeFleet:
    """The stats/scale_up/scale_down surface, as plain knobs."""

    def __init__(self, routable: int = 1, outstanding: int = 0):
        self.routable = routable
        self.outstanding = outstanding
        self.ups = 0
        self.downs = 0

    def stats(self, live=False):
        return {"workers": self.routable, "routable": self.routable,
                "submitted": self.outstanding, "replied": 0, "failed": 0,
                "cancelled": 0}

    def scale_up(self):
        self.routable += 1
        self.ups += 1
        return self.routable - 1

    def scale_down(self, idx=None):
        self.routable -= 1
        self.downs += 1
        return self.routable


@pytest.mark.parametrize("kw, match", [({"min_workers": 0}, "min_workers"),
                                       ({"min_workers": 3, "max_workers": 2}, "min_workers"),
                                       ({"up_per_worker": 1.0, "down_per_worker": 1.0},
                                        "deadband")])
def test_autoscaler_rejects_bad_shape_as_the_reference(kw, match):
    with pytest.raises(ValueError, match=match) as port:
        Autoscaler(_FakeFleet(), **kw)
    with pytest.raises(ValueError) as ref:
        RefAutoscaler(_FakeFleet(), **kw)
    assert str(port.value) == str(ref.value)


def _drive(cls, script, **kw):
    """Run a (clock, outstanding) script of ticks; returns the decisions
    and the fake fleet's final counts."""
    t = [0.0]
    fl = _FakeFleet(routable=1)
    sc = cls(fl, clock=lambda: t[0], **kw)
    out = []
    for clock, outstanding in script:
        t[0] = clock
        if outstanding is not None:
            fl.outstanding = outstanding
        out.append(sc.tick())
    return out, (fl.routable, fl.ups, fl.downs), sc.stop()


def test_autoscaler_control_law_makes_the_references_decisions():
    """Hysteresis, cooldown and both bounds on an injected clock: the
    reference's script, and the same decisions from both packages."""
    script = ([(0.0, 10)] * 4 + [(11.0, None)] + [(22.0, None)] * 5
              + [(22.0, 0)] * 3 + [(40.0, None)] * 3 + [(60.0, None)] * 5)
    kw = dict(min_workers=1, max_workers=3, up_per_worker=4.0, down_per_worker=0.5,
              up_ticks=2, down_ticks=3, cooldown_s=10.0)
    port = _drive(Autoscaler, script, **kw)
    assert port == _drive(RefAutoscaler, script, **kw)
    decisions, (routable, ups, downs), totals = port
    assert decisions == (["hold", "up", "hold", "hold", "up"] + ["hold"] * 5
                         + ["hold", "hold", "down", "hold", "hold", "down"] + ["hold"] * 5)
    assert (routable, ups, downs) == (1, 2, 2) and totals == {"ups": 2, "downs": 2}


def test_autoscaler_deadband_holds():
    script = [(0.0, 4)] * 10
    kw = dict(min_workers=1, max_workers=4, up_per_worker=4.0, down_per_worker=0.5,
              up_ticks=1, down_ticks=2, cooldown_s=0.0)
    for cls in (Autoscaler, RefAutoscaler):
        t = [0.0]
        fl = _FakeFleet(routable=2, outstanding=4)
        sc = cls(fl, clock=lambda: t[0], **kw)
        assert [sc.tick() for _ in script] == ["hold"] * 10
        assert fl.ups == fl.downs == 0


def test_thread_fleet_autoscale_round_trip_bit_identical():
    """A backlogged one-worker fleet scales up on sustained pressure, the
    newcomer takes stealable work, the idle fleet scales back down
    (retired, not lost), and every reply equals the reference's."""
    cfgs = [_cfg(50 + i, protocol=p, n=n, f=f, delivery=d)
            for i, (p, n, f, d) in enumerate(
                [("benor", 5, 1, "keys"), ("bracha", 7, 2, "keys"),
                 ("benor", 5, 1, "urn2")] * 2)]
    with _fleet(segment_latency_s=0.05) as fl:
        sc = Autoscaler(fl, min_workers=1, max_workers=2, up_per_worker=3.0,
                        down_per_worker=0.5, up_ticks=1, down_ticks=2, cooldown_s=0.0)
        handles = [fl.submit(c) for c in cfgs]
        deadline = time.monotonic() + 60.0
        while sc.tick() != "up":
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert fl.stats(live=False)["routable"] == 2
        for h, c in zip(handles, cfgs):
            _assert_offline(c, h.wait(timeout=TIMEOUT))
        deadline = time.monotonic() + 60.0
        while sc.tick() != "down":
            assert time.monotonic() < deadline
            time.sleep(0.01)
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and fl.health().get("retiring"):
            time.sleep(0.05)
        st = fl.stats(live=False)
        assert st["routable"] == 1
        assert st["lost_workers"] == 0 and st["retired_workers"] == 1
        assert fl.health()["ok"] is True


# -- the recovering gate --------------------------------------------------------------

def test_submit_during_fleet_recovery_rejects_503_with_retry_after(tmp_path):
    metrics.configure()
    try:
        with _fleet(wal_dir=str(tmp_path)) as fleet:
            httpd = serve_http(fleet, host="127.0.0.1", port=0)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            base = "http://%s:%s" % httpd.server_address[:2]
            try:
                fleet._recovering = True
                with pytest.raises(admission.Backpressure) as exc:
                    fleet.submit(_cfg(60))
                assert exc.value.reason == "recovering"
                body = json.dumps(dataclasses.asdict(_cfg(61))).encode()
                req = urllib.request.Request(base + "/submit", data=body,
                                             headers={"Content-Type": "application/json"})
                with pytest.raises(urllib.error.HTTPError) as exc:
                    urllib.request.urlopen(req, timeout=30)
                assert exc.value.code == 503
                assert float(exc.value.headers["Retry-After"]) > 0
                assert json.loads(exc.value.read())["reason"] == "recovering"
                series = metrics.snapshot()["brc_serve_rejected_total"]["series"]
                assert any(s["labels"].get("reason") == "recovering" and s["value"] >= 2
                           for s in series)
                fleet._recovering = False
                with urllib.request.urlopen(req, timeout=30) as r:
                    assert r.status == 200
            finally:
                fleet._recovering = False
                httpd.shutdown()
                httpd.server_close()
    finally:
        metrics.disable()


# -- process fleets -----------------------------------------------------------------------

@pytest.mark.slow
def test_process_fleet_respawn_budget_and_terminal_state():
    with FleetServer(workers=2, mode="process", policy=_POLICY, device="cpu",
                     max_respawns=1, spawn_timeout_s=60.0) as fleet:
        fleet._workers[0].kill()
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            st = fleet.stats(live=False)
            if st["respawns"]["used"] == 1 and fleet.health()["ok"]:
                break
            time.sleep(0.1)
        assert fleet.health()["ok"] is True and st["lost_workers"] == 1
        _assert_offline(_cfg(70), fleet.submit(_cfg(70)).wait(timeout=TIMEOUT))
        with fleet._cv:
            victim = next(w for w in fleet._workers if w.alive and not w.retiring)
        victim.kill()
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline and not fleet.health().get("terminal"):
            time.sleep(0.1)
        health = fleet.health()
        assert health["terminal"] == "respawn_budget_exhausted" and health["ok"] is False
        assert fleet.stats(live=False)["respawns"] == {
            "budget": 1, "used": 1, "terminal": "respawn_budget_exhausted"}


def _serve(*args):
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    return subprocess.Popen(
        [sys.executable, "-m", "byzantinerandomizedconsensus_tpu_torch.cli", "serve",
         "--device", "cpu", "--port", "0", "--workers", "2",
         "--policy", "width=8,segment=1", *args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env)


def _listening(proc, timeout=90.0):
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


def _http(base, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def test_cli_serve_fleet_sigkill_then_recover_returns_every_owed_reply(tmp_path):
    """``cli serve --workers 2 --wal DIR`` SIGKILLed with replies owed (its
    workers see their pipe close and exit); restarted with ``--recover
    DIR`` it answers ``/result/<original id>`` for every owed request,
    equal to the offline run."""
    heavy = _cfg(7, protocol="bracha", n=40, f=13, instances=256, round_cap=64,
                 delivery="urn2")
    light = [_cfg(8), _cfg(9, protocol="bracha", n=7, f=2)]
    wal_dir = tmp_path / "wal"
    proc = _serve("--wal", str(wal_dir))
    try:
        base = _listening(proc)
        ids = [_http(base, "/submit", dataclasses.asdict(c))[1]["id"]
               for c in [heavy] + light]
        code, stats = _http(base, "/stats")
        assert code == 200 and stats["workers"] == 2
        assert [r["leg"] for r in stats["per_worker"]] == ["lanes", "lanes"]
        assert stats["parent_cuda_initialized"] is False
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    assert ids == ["f000001", "f000002", "f000003"]
    owed = [e["id"] for e in ref_wal.WriteAheadLog.plan_recovery(str(wal_dir))[0]]
    assert "f000001" in owed
    proc = _serve("--recover", str(wal_dir))
    try:
        base = _listening(proc)
        for rid, cfg in zip(ids, [heavy] + light):
            deadline = time.monotonic() + TIMEOUT
            while (got := _http(base, f"/result/{rid}"))[0] == 202:
                assert time.monotonic() < deadline
                time.sleep(0.05)
            if rid in owed:
                assert got[0] == 200 and got[1]["request_id"] == rid
                _assert_offline(cfg, got[1])
            else:
                assert got[0] == 404
        assert _http(base, "/healthz") == (200, {"ok": True, "workers": 2, "alive": 2,
                                                 "dead_workers": []})
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=60)
    assert proc.returncode == 0
    assert ref_wal.WriteAheadLog.plan_recovery(str(wal_dir)) == ([], 3)
