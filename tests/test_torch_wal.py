"""The port's write-ahead admission log (serve/wal.py) and WAL recovery
against the reference on the CPU.

The counterparts of the reference's WAL and recovery tests
(``tests/test_elastic.py``), and the state carried across between the two
packages: a journal written by either package is read, planned and
recovered identically by the other, a torn final line included, and the
bytes each writes for the same appends are the same. Every recovered reply
equals the reference's ``get_backend("numpy").run(cfg)`` per instance.
"""

import dataclasses

import pytest

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.backends import get_backend as ref_get_backend
from byzantinerandomizedconsensus_tpu.models import session as ref_session
from byzantinerandomizedconsensus_tpu.serve import wal as ref_wal
from byzantinerandomizedconsensus_tpu.serve.server import ConsensusServer as RefServer
from byzantinerandomizedconsensus_tpu_torch.backends.compaction import CompactionPolicy
from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import TorchBackend
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.models import session
from byzantinerandomizedconsensus_tpu_torch.serve import wal
from byzantinerandomizedconsensus_tpu_torch.serve.admission import Backpressure
from byzantinerandomizedconsensus_tpu_torch.serve.server import ConsensusServer
from byzantinerandomizedconsensus_tpu_torch.serve.wal import WAL_NAME, WriteAheadLog

_POLICY = CompactionPolicy(width=8, segment=1)
TIMEOUT = 600.0


def _cfg(seed: int, **kw) -> SimConfig:
    base = dict(protocol="benor", n=5, f=1, instances=4, adversary="none",
                coin="local", init="random", seed=seed, round_cap=32,
                delivery="keys")
    base.update(kw)
    return SimConfig(**base).validate()


def _offline(cfg):
    ref = ref_get_backend("numpy").run(ref_config.SimConfig(**dataclasses.asdict(cfg)))
    return [int(r) for r in ref.rounds], [int(d) for d in ref.decision]


def _server(tmp_path):
    return ConsensusServer(TorchBackend(device="cpu"), policy=_POLICY,
                           wal_dir=str(tmp_path))


# -- the reference's WAL tests ---------------------------------------------

def test_wal_round_trip_plan_and_counter(tmp_path):
    log = WriteAheadLog(str(tmp_path))
    cfg_doc = dataclasses.asdict(_cfg(1))
    log.append_admit("r000001", cfg_doc, {})
    log.append_done("r000001")
    log.append_admit("r000002", cfg_doc, {"session_slots": 2})
    log.append_admit("r000007", cfg_doc, {})
    log.append_done("r000007", failed=True)
    log.close()
    entries = WriteAheadLog.read_entries(str(tmp_path))
    assert [e["op"] for e in entries] == ["admit", "done", "admit", "admit", "fail"]
    plan, counter = WriteAheadLog.plan_recovery(str(tmp_path))
    assert [e["id"] for e in plan] == ["r000002"]
    assert plan[0]["env"] == {"session_slots": 2}
    assert counter == 7


def test_wal_tolerates_torn_final_line_only(tmp_path):
    log = WriteAheadLog(str(tmp_path))
    cfg_doc = dataclasses.asdict(_cfg(2))
    log.append_admit("r000001", cfg_doc, {})
    log.append_admit("r000002", cfg_doc, {})
    log.close()
    path = tmp_path / WAL_NAME
    whole = path.read_text()
    path.write_text(whole + '{"op": "admit", "id": "r0000')
    plan, counter = WriteAheadLog.plan_recovery(str(tmp_path))
    assert [e["id"] for e in plan] == ["r000001", "r000002"]
    assert counter == 2
    lines = whole.splitlines()
    path.write_text("\n".join([lines[0][: len(lines[0]) // 2]] + lines[1:]) + "\n")
    with pytest.raises(ValueError, match="only the final line may be torn"):
        WriteAheadLog.read_entries(str(tmp_path))


def test_wal_repairs_torn_tail_before_appending(tmp_path):
    log = WriteAheadLog(str(tmp_path))
    cfg_doc = dataclasses.asdict(_cfg(3))
    log.append_admit("r000001", cfg_doc, {})
    log.close()
    path = tmp_path / WAL_NAME
    path.write_text(path.read_text() + '{"op": "admit", "id')
    log2 = WriteAheadLog(str(tmp_path))
    log2.append_done("r000001")
    log2.close()
    assert [e["op"] for e in WriteAheadLog.read_entries(str(tmp_path))] == ["admit", "done"]
    path.write_text(path.read_text() + "}}}not json{{{\n")
    log3 = WriteAheadLog(str(tmp_path))
    log3.append_admit("r000002", cfg_doc, {})
    log3.close()
    assert [e["op"] for e in WriteAheadLog.read_entries(str(tmp_path))] \
        == ["admit", "done", "admit"]


def test_recovery_replays_bit_identical_and_idempotent(tmp_path):
    cfgs = [_cfg(10), _cfg(11), _cfg(12)]
    log = WriteAheadLog(str(tmp_path))
    for i, c in enumerate(cfgs):
        log.append_admit(f"r{i + 1:06d}", dataclasses.asdict(c), {})
    log.append_done("r000002")
    log.close()
    srv = _server(tmp_path).start()
    try:
        out = srv.recover(timeout=TIMEOUT)
        assert out["ids"] == ["r000001", "r000003"]
        assert out["replayed"] == 2 and out["recovered"] == 2
        assert srv.recovering is False
        for rid, h, c in zip(out["ids"], out["handles"], [cfgs[0], cfgs[2]]):
            rec = h.wait(timeout=TIMEOUT)
            assert rec["request_id"] == rid
            assert (rec["rounds"], rec["decision"]) == _offline(c)
        h = srv.submit(_cfg(13))
        assert h.id == "r000004"
        h.wait(timeout=TIMEOUT)
        out2 = srv.recover(timeout=TIMEOUT)
        assert out2["replayed"] == 0 and out2["ids"] == []
    finally:
        srv.shutdown(timeout=TIMEOUT)


def test_recovery_reproduces_session_envelopes(tmp_path):
    cfg = _cfg(21)
    log = WriteAheadLog(str(tmp_path))
    log.append_admit("r000001", dataclasses.asdict(cfg), {"session_slots": 3})
    log.close()
    srv = _server(tmp_path).start()
    try:
        out = srv.recover(timeout=TIMEOUT)
        assert out["recovered"] == 1
        blk = out["handles"][0].wait(timeout=TIMEOUT)["session"]
    finally:
        srv.shutdown(timeout=TIMEOUT)
    assert blk["slots"] == 3 and len(blk["rounds"]) == 3
    served = list(zip(blk["rounds"], blk["decisions"]))
    rcfg = ref_config.SimConfig(**dataclasses.asdict(cfg))
    assert ref_session.replay_matches(ref_get_backend("numpy"), rcfg, served)
    assert session.replay_matches(TorchBackend(device="cpu"), cfg, served)


# -- across the two packages -----------------------------------------------

def _write(mod, directory, torn: bool):
    """The same appends through ``mod``'s log: admits (one a session, one
    with a full envelope), a reply, a failure; optionally a torn tail."""
    log = mod.WriteAheadLog(str(directory))
    docs = [dataclasses.asdict(_cfg(30 + i)) for i in range(4)]
    log.append_admit("r000001", docs[0], {})
    log.append_admit("r000002", docs[1], {"session_slots": 2, "tenant": "alice",
                                          "deadline_ms": 250.0, "priority": 1,
                                          "check_invariants": True})
    log.append_done("r000001")
    log.append_admit("r000003", docs[2], {})
    log.append_done("r000003", failed=True)
    log.append_admit("r000009", docs[3], {})
    log.close()
    path = directory / WAL_NAME
    if torn:
        path.write_text(path.read_text() + '{"op": "done", "id": "r0000')
    return path


@pytest.mark.parametrize("torn", [False, True], ids=["whole", "torn"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_log_written_by_either_package_plans_identically(tmp_path, writer, torn):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    w, other = (wal, ref_wal) if writer == "port" else (ref_wal, wal)
    path = _write(w, tmp_path / "a", torn)
    _write(other, tmp_path / "b", torn)
    assert path.read_bytes() == (tmp_path / "b" / WAL_NAME).read_bytes()
    d = str(tmp_path / "a")
    assert wal.WriteAheadLog.read_entries(d) == ref_wal.WriteAheadLog.read_entries(d)
    assert wal.WriteAheadLog.plan_recovery(d) == ref_wal.WriteAheadLog.plan_recovery(d)
    assert wal.recover_payloads(d) == ref_wal.recover_payloads(d)
    pairs, counter = wal.recover_payloads(d)
    assert [rid for rid, _ in pairs] == ["r000002", "r000009"] and counter == 9
    # the reopening repair truncates the same torn tail in both packages
    for mod in (w, other):
        mod.WriteAheadLog(d).close()
    assert path.read_text().endswith("}\n")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_crashed_server_log_recovers_in_the_other_package(tmp_path, writer):
    """A server of one package journals its admissions and dies with work
    queued (never started); a server of the other package recovers the log:
    the replies under the original ids equal the offline results, a
    session's log included, and the other package plans nothing after."""
    cfgs = [_cfg(40), _cfg(41, protocol="bracha", n=7, f=2, delivery="urn")]
    sess = _cfg(42, instances=3)
    if writer == "port":
        dead = _server(tmp_path)
    else:
        dead = RefServer(backend="numpy", policy=_POLICY, wal_dir=str(tmp_path))
    ids = [dead.submit(dataclasses.asdict(c)).id for c in cfgs]
    ids.append(dead.submit({**dataclasses.asdict(sess), "session_slots": 2}).id)
    dead._wal.close()  # the process dies: no completion is journaled
    if writer == "port":
        alive = RefServer(backend="numpy", policy=_POLICY, wal_dir=str(tmp_path)).start()
    else:
        alive = _server(tmp_path).start()
    try:
        out = alive.recover(timeout=TIMEOUT)
        recs = [h.wait(timeout=TIMEOUT) for h in out["handles"]]
    finally:
        alive.shutdown(timeout=TIMEOUT)
    assert out["ids"] == ids and out["recovered"] == 3
    for c, rec in zip(cfgs + [sess], recs):
        assert (rec["rounds"], rec["decision"]) == _offline(c)
    rsess = ref_config.SimConfig(**dataclasses.asdict(sess))
    ref = ref_session.run_session(ref_get_backend("numpy"), rsess, 2)
    assert recs[-1]["session"]["decisions"] == [[int(d) for d in r.decision] for r in ref]
    for mod in (wal, ref_wal):
        assert mod.WriteAheadLog.plan_recovery(str(tmp_path)) == ([], 3)


def test_cancel_and_rejection_close_their_journal_entries(tmp_path):
    """A cancelled request and one refused after its journaling (the
    rotation-queue bound) are journaled as failed, so recovery never
    replays a request the client saw end; a tenant-cap refusal comes
    before the journal and leaves no entry."""
    srv = ConsensusServer(TorchBackend(device="cpu"), policy=_POLICY,
                          wal_dir=str(tmp_path), rotation_queue_depth=1,
                          tenant_inflight_cap=1)
    h = srv.submit(dataclasses.asdict(_cfg(50)))
    with pytest.raises(Backpressure, match="in-flight cap"):
        srv.submit(dataclasses.asdict(_cfg(51)))
    with pytest.raises(Backpressure, match="rotation queue is at its bound"):
        srv.submit({**dataclasses.asdict(_cfg(52)), "tenant": "t"})
    srv.cancel(h.id)
    srv.shutdown(drain=True, timeout=TIMEOUT)
    entries = ref_wal.WriteAheadLog.read_entries(str(tmp_path))
    assert [(e["op"], e["id"]) for e in entries] == [
        ("admit", "r000001"), ("admit", "r000002"), ("fail", "r000002"),
        ("fail", "r000001")]
    assert ref_wal.WriteAheadLog.plan_recovery(str(tmp_path)) == ([], 2)
