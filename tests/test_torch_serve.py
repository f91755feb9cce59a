"""The port's consensus server (serve/server.py, admission.py) against the
reference on the CPU.

The counterparts of the reference's ``ConsensusServer`` tests
(``tests/test_serve.py``, the envelope, cancel and tenant-hog cases of
``test_hostile.py``, the session cases of ``test_session.py``): on the CPU
the port's ``TorchBackend`` runs ``kernel="plain"``, so the server takes
the compacted lane grid, as the reference's tests do. Every reply equals
the reference's ``get_backend("numpy").run(cfg)`` per instance and passes
both packages' ``validate_record``; the same request list through the
reference's server gives the same documents apart from ``env`` and
latency; the port's ``validate_record`` gives the reference's verdicts on
every committed ``artifacts/*.json``. The direct leg (every kernel but
``plain``) and the refusals are held by name. Tolerance 0; every blocking
call has a timeout.
"""

import dataclasses
import json
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.backends import get_backend as ref_get_backend
from byzantinerandomizedconsensus_tpu.backends import lanestate as ref_lanestate
from byzantinerandomizedconsensus_tpu.models import session as ref_session
from byzantinerandomizedconsensus_tpu.obs import record as ref_record
from byzantinerandomizedconsensus_tpu.serve import admission as ref_admission
from byzantinerandomizedconsensus_tpu.serve.server import ConsensusServer as RefServer
from byzantinerandomizedconsensus_tpu.tools import trace as ref_trace_tool
from byzantinerandomizedconsensus_tpu_torch.backends import get_backend
from byzantinerandomizedconsensus_tpu_torch.backends.batch import CompileCache
from byzantinerandomizedconsensus_tpu_torch.backends.compaction import (
    CompactionPolicy, WorkFeed)
from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import TorchBackend
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig, preset
from byzantinerandomizedconsensus_tpu_torch.models import session
from byzantinerandomizedconsensus_tpu_torch.obs import record
from byzantinerandomizedconsensus_tpu_torch.obs import trace
from byzantinerandomizedconsensus_tpu_torch.serve import admission
from byzantinerandomizedconsensus_tpu_torch.serve.server import ConsensusServer
from byzantinerandomizedconsensus_tpu_torch.utils import metrics as umetrics

ROOT = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT = 600.0

#: Small lane grid: still exercises refill (instances > W).
_POLICY = CompactionPolicy(width=8, segment=1)
_CEILING = 64

#: The reference's mixed-shape batch: two fused buckets (protocol ×
#: delivery), heterogeneous n/f/instances/adversary/round_cap within them.
_CFGS = [
    SimConfig(protocol="benor", n=5, f=1, instances=6, seed=3, round_cap=32),
    SimConfig(protocol="benor", n=9, f=3, instances=12, seed=21, round_cap=64,
              adversary="crash", init="split"),
    SimConfig(protocol="bracha", n=7, f=2, instances=4, seed=9, round_cap=32,
              delivery="urn"),
    SimConfig(protocol="bracha", n=10, f=3, instances=9, seed=77, round_cap=64,
              delivery="urn", adversary="byzantine"),
]


def _be():
    return TorchBackend(device="cpu")


def _server(**kw):
    return ConsensusServer(_be(), **{"policy": _POLICY, **kw})


def _ref(cfg):
    return ref_config.SimConfig(**dataclasses.asdict(cfg))


def _cfg(seed, *, protocol="benor", n=5, f=1, instances=8, round_cap=48,
         delivery="keys"):
    return SimConfig(protocol=protocol, n=n, f=f, instances=instances,
                     adversary="none", coin="local", init="random", seed=seed,
                     round_cap=round_cap, delivery=delivery).validate()


def _session_cfg(seed=91, **kw):
    base = dict(protocol="benor", n=4, f=1, instances=3, adversary="none",
                coin="local", init="random", seed=seed, round_cap=24,
                delivery="keys")
    base.update(kw)
    return SimConfig(**base).validate()


def _assert_numpy(cfg, rec):
    ref = ref_get_backend("numpy").run(_ref(cfg))
    assert rec["rounds"] == [int(r) for r in ref.rounds]
    assert rec["decision"] == [int(d) for d in ref.decision]


def _assert_valid(rec):
    """Both packages' ``validate_record`` pass a reply, with one exception
    that is the reference's own: a session reply's per-slot ``session``
    log shares its key with the schema-v1.12 ``session`` bench block, so
    both validators flag exactly that block, with the same messages."""
    got, want = record.validate_record(rec), ref_record.validate_record(rec)
    assert got == want, rec
    if "session" in rec:
        assert got and all(p.startswith("session block") for p in got), got
    else:
        assert got == [], rec


# -- the reference's test_serve.py ----------------------------------------

def test_serve_smoke_mixed_shapes_bit_identical():
    with _server() as srv:
        assert srv.leg == "lanes" and srv.device == torch.device("cpu")
        handles = [srv.submit(c) for c in _CFGS]
        recs = [h.wait(timeout=TIMEOUT) for h in handles]
        stats = srv.stats()
    assert stats["submitted"] == stats["replied"] == len(_CFGS)
    assert stats["failed"] == 0 and stats["leg"] == "lanes"
    for cfg, h, rec in zip(_CFGS, handles, recs):
        _assert_valid(rec)
        assert rec["record_revision"] == record.RECORD_REVISION
        assert rec["kind"] == "serve_reply" and rec["request_id"] == h.id
        assert rec["config"]["n"] == cfg.n and rec["latency_s"] > 0
        _assert_numpy(cfg, rec)


def test_serve_shutdown_drains_in_flight():
    srv = _server().start()
    handles = [srv.submit(c) for c in _CFGS]
    srv.shutdown(drain=True, timeout=TIMEOUT)
    for h in handles:
        rec = h.wait(timeout=TIMEOUT)
        assert rec is not None and h.error is None
    stats = srv.stats()
    assert stats["replied"] == len(_CFGS) and stats["failed"] == 0
    with pytest.raises(RuntimeError, match="shutting down"):
        srv.submit(_CFGS[0])


def test_serve_no_drain_shutdown_fails_pending_by_name():
    srv = _server().start()
    srv.shutdown(drain=True, timeout=TIMEOUT)
    srv2 = _server()  # never started: queue only
    req = srv2.submit(_CFGS[0])
    srv2.shutdown(drain=False, timeout=TIMEOUT)
    assert req.done.is_set() and req.error is not None
    with pytest.raises(RuntimeError, match="shutdown before dispatch"):
        req.wait(timeout=1.0)


def test_admission_rejects_bad_requests():
    with pytest.raises(ValueError, match="unknown request field"):
        admission.admit({"n": 5, "banana": 1})
    with pytest.raises(TypeError, match="not a SimConfig or dict"):
        admission.admit(42)
    with pytest.raises(ValueError, match="exceeds the service ceiling"):
        admission.admit(SimConfig(n=4, f=1, round_cap=256), round_cap_ceiling=128)
    with pytest.raises(ValueError):
        admission.admit({"n": 4, "f": 3})  # resilience bound
    cfg = admission.admit({"protocol": "bracha", "n": 7, "f": 2, "instances": 3,
                           "round_cap": 64})
    assert isinstance(cfg, SimConfig) and cfg.protocol == "bracha"
    assert admission.bucket_of(cfg).protocol == "bracha"
    assert admission.REQUEST_FIELDS == ref_admission.REQUEST_FIELDS
    assert admission.ENVELOPE_FIELDS == ref_admission.ENVELOPE_FIELDS
    assert admission.DEFAULT_TENANT == ref_admission.DEFAULT_TENANT


@pytest.mark.parametrize("payload", [
    {"n": 5, "banana": 1}, 42, {"n": 4, "f": 3}, {"n": 4, "f": 1, "round_cap": 256},
    {"n": 5, "tenant": ""}, {"n": 5, "priority": 9}, {"n": 5, "session_slots": 0},
    {"protocol": "bracha", "n": 7, "f": 2, "instances": 3, "round_cap": 64,
     "tenant": "alice", "deadline_ms": 5, "session_slots": 2},
])
def test_admission_messages_word_for_word(payload):
    """Every verdict and message of the port's admission equals the
    reference's on the same payload (ceiling 128)."""
    def verdict(mod):
        try:
            rest, env = mod.envelope(payload)
            cfg = mod.admit(rest, round_cap_ceiling=128)
            return ("ok", dataclasses.asdict(cfg), env, mod.bucket_of(cfg).label())
        except (TypeError, ValueError) as e:
            return (type(e).__name__, str(e))

    assert verdict(admission) == verdict(ref_admission)


def test_serve_reply_carries_optin_invariant_summary():
    with _server() as srv:
        flagged = srv.submit(_CFGS[0], check_invariants=True)
        via_dict = srv.submit({"protocol": "bracha", "n": 7, "f": 2, "instances": 3,
                               "round_cap": 32, "check_invariants": True})
        plain = srv.submit(_CFGS[1])
        rec = flagged.wait(timeout=TIMEOUT)
        rec_d = via_dict.wait(timeout=TIMEOUT)
        rec_plain = plain.wait(timeout=TIMEOUT)
    for doc, n_inst in ((rec, _CFGS[0].instances), (rec_d, 3)):
        inv = doc["invariants"]
        assert inv["checked_instances"] == n_inst
        assert inv["violations"] == 0 and inv["detail"] == []
        assert inv["agreement_ok"] is True and inv["validity_ok"] is True
        assert inv["by_kind"] == {}
    assert "invariants" not in rec_plain


def test_serve_span_kinds_emitted():
    tr = trace.configure()  # in-memory
    try:
        with _server() as srv:
            srv.submit(_CFGS[0]).wait(timeout=TIMEOUT)
        kinds = {e["kind"] for e in tr.events}
    finally:
        trace.disable()
    for kind in ("serve.request", "serve.admit", "serve.dispatch", "serve.reply"):
        assert kind in kinds, (kind, sorted(kinds))


def test_trace_follow_treats_serve_request_as_heartbeat():
    """The port's serve events drive the reference's live follower: two
    requests and one reply read as ``serve 1/2 replied``."""
    tr = trace.configure()
    try:
        with _server() as srv:
            srv.submit(_CFGS[0]).wait(timeout=TIMEOUT)
            srv.submit(_CFGS[2])
        events = [e for e in tr.events if e["kind"].startswith("serve.")]
    finally:
        trace.disable()
    state = {"events": 0, "compiles": 0, "skips": 0, "progress": None,
             "queue": None, "live": None, "total": None,
             "serve_requests": 0, "serve_replies": 0}
    replies = [e for e in events if e["kind"] == "serve.reply"]
    for ev in [e for e in events if e["kind"] == "serve.request"] + replies[:1]:
        ref_trace_tool._follow_consume(state, json.loads(json.dumps(ev)))
    assert state["serve_requests"] == 2 and state["serve_replies"] == 1
    assert "serve 1/2 replied" in ref_trace_tool._follow_render(state)


def test_workfeed_contract():
    feed = WorkFeed(round_cap_ceiling=64)
    cfg = SimConfig(n=4, f=1, round_cap=32)
    feed.push(cfg, token="a")
    with pytest.raises(ValueError, match="exceeds the feed ceiling"):
        feed.push(SimConfig(n=4, f=1, round_cap=128))
    assert feed.pull() == [(cfg, None, "a", None)]
    assert feed.pull() == []
    feed.push(cfg, token="b")
    feed.close()
    with pytest.raises(RuntimeError, match="closed WorkFeed"):
        feed.push(cfg)
    assert feed.pull() == [(cfg, None, "b", None)]
    assert feed.pull() is None
    assert feed.pull(block=True) is None


def test_compile_cache_concurrent_access():
    cache = CompileCache(max_entries=8)
    built = []
    build_lock = threading.Lock()

    def make_build(key):
        def build():
            with build_lock:
                built.append(key)
            return lambda x, _k=key: (x, _k)
        return build

    keys = [("bucket", i) for i in range(8)]
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(300):
                k = keys[int(rng.integers(len(keys)))]
                assert cache.get(k, make_build(k))(1) == (1, k)
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert errors == []
    stats = cache.stats()
    assert stats["compiles"] == 8 == len(built)
    assert stats["evictions"] == 0
    assert stats["hits"] == 8 * 300 - 8
    assert len(cache) == 8


def test_compile_cache_concurrent_eviction_consistency():
    cache = CompileCache(max_entries=4)
    keys = [("k", i) for i in range(12)]

    def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(200):
            k = keys[int(rng.integers(len(keys)))]
            assert cache.get(k, lambda _k=k: (lambda: _k))() == k

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    stats = cache.stats()
    assert len(cache) == 4
    assert stats["compiles"] - stats["evictions"] == len(cache)
    assert stats["compiles"] + stats["hits"] == 6 * 200


# -- the reference's test_session.py (served sessions) ---------------------

def test_session_envelope_admission_bounds():
    payload = dataclasses.asdict(_session_cfg())
    rest, env = admission.envelope({**payload, "session_slots": 5})
    assert env["session_slots"] == 5
    assert "session_slots" not in rest
    assert not hasattr(admission.admit(rest), "session_slots")
    for bad in (0, -1, session.MAX_SESSION_SLOTS + 1, True, 2.0, "4"):
        with pytest.raises(ValueError):
            admission.envelope({**payload, "session_slots": bad})
    assert admission.envelope({**payload, "session_slots": None})[1]["session_slots"] == 1


def test_served_session_bit_identical_to_offline_replay():
    """A session served in-grid replays bit-identically offline on the
    reference's numpy backend and on the port's plain path, from the base
    seed alone."""
    cfg = _session_cfg(seed=35, instances=2)
    slots = 4
    with ConsensusServer(_be(), policy=CompactionPolicy(width=8, segment=2)) as srv:
        rec = srv.submit({**dataclasses.asdict(cfg), "session_slots": slots}).wait(
            timeout=TIMEOUT)
    _assert_valid(rec)
    blk = rec["session"]
    assert blk["slots"] == slots and len(blk["rounds"]) == slots
    assert rec["rounds"] == blk["rounds"][0]
    assert rec["decision"] == blk["decisions"][0]
    served = list(zip(blk["rounds"], blk["decisions"]))
    assert ref_session.replay_matches(ref_get_backend("numpy"), _ref(cfg), served)
    assert session.replay_matches(_be(), cfg, served)
    ref = ref_session.run_session(ref_get_backend("numpy"), _ref(cfg), slots)
    assert blk["seeds"] == [int(r.config.seed) for r in ref]


# -- the reference's test_hostile.py (server-only cases) -------------------

def test_envelope_validates_and_strips():
    payload = {"protocol": "benor", "n": 5, "f": 1, "instances": 4, "tenant": "alice",
               "deadline_ms": 250, "priority": 3, "check_invariants": True}
    cfg_part, env = admission.envelope(payload)
    assert set(cfg_part) & set(admission.ENVELOPE_FIELDS) == set()
    assert env["tenant"] == "alice" and env["deadline_ms"] == 250.0
    assert env["priority"] == 3 and env["check_invariants"] is True
    assert (cfg_part, env) == ref_admission.envelope(payload)
    for bad in ({"tenant": ""}, {"tenant": "x" * 65}, {"tenant": 7},
                {"deadline_ms": -1}, {"deadline_ms": "soon"},
                {"priority": 99}, {"priority": 1.5}):
        with pytest.raises(ValueError):
            admission.envelope({"n": 5, **bad})


def test_cancel_queued_and_live_survivors_bit_identical():
    cfgs = [(_cfg(60 + i) if i % 2 == 0 else
             _cfg(60 + i, protocol="bracha", n=7, f=2, delivery="urn"))
            for i in range(8)]
    with _server(round_cap_ceiling=_CEILING) as srv:
        handles = [srv.submit(c) for c in cfgs]
        early = srv.cancel(handles[0].id)
        late = srv.cancel(handles[-1].id)
        missing = srv.cancel("r-nope")
        for h in handles:
            assert h.done.wait(timeout=TIMEOUT)
        stats = srv.stats()
    assert missing["found"] is False and missing["cancelled"] is False
    assert early["found"] and late["found"]
    cancelled = [a for a in (early, late) if a["cancelled"]]
    assert cancelled, (early, late)
    for ack in cancelled:
        assert ack["where"] in ("queued", "live")
    assert stats["cancelled"] == len(cancelled)
    for i, h in enumerate(handles):
        if h.error == "cancelled":
            assert h.record is None
        else:
            _assert_valid(h.record)
            _assert_numpy(cfgs[i], h.record)
    assert sum(1 for h in handles if h.record is not None) + len(cancelled) == len(handles)


def test_cancel_last_queued_item_keeps_session_owned_feed_open():
    feed = WorkFeed(round_cap_ceiling=_CEILING)
    owner, bystander = object(), object()
    feed.push(_cfg(60), token=owner, session=3)
    items = feed.pull()
    assert [(it[2], it[3]) for it in items] == [(owner, 3)]
    feed.push(_cfg(61), token=bystander)
    assert feed.cancel(bystander) is True
    assert feed.pending() == 0
    feed.close()
    assert feed.pull() == []
    assert feed.cancel(owner) is False
    assert feed.pull() == []
    feed.session_done(owner)
    assert feed.pull() is None


def test_tenant_hog_cannot_starve_interactive_tenant():
    hog_cfgs = [_cfg(70 + i, n=9, f=3, instances=8, round_cap=_CEILING) for i in range(6)]
    int_cfgs = [_cfg(90 + i, instances=2, round_cap=16) for i in range(3)]
    with _server(round_cap_ceiling=_CEILING, tenant_inflight_cap=4) as srv:
        hog_handles, int_handles = [], []

        def hog():
            for c in hog_cfgs:
                payload = {**dataclasses.asdict(c), "tenant": "hog"}
                for _ in range(10_000):
                    try:
                        hog_handles.append(srv.submit(payload))
                        break
                    except admission.Backpressure as e:
                        assert e.reason == "tenant_cap"
                        time.sleep(e.retry_after_s)

        def interactive():
            time.sleep(0.05)
            for c in int_cfgs:
                int_handles.append(srv.submit(
                    {**dataclasses.asdict(c), "tenant": "interactive",
                     "deadline_ms": 8000.0}))
                time.sleep(0.05)

        threads = [threading.Thread(target=hog), threading.Thread(target=interactive)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        for h in hog_handles + int_handles:
            h.wait(timeout=TIMEOUT)
        stats = srv.stats()
    assert len(hog_handles) == len(hog_cfgs) and len(int_handles) == len(int_cfgs)
    assert stats["tenants"].get("hog") == 0
    assert stats["tenants"].get("interactive") == 0
    (hog_p99,) = umetrics.percentiles([h.latency_s * 1000.0 for h in hog_handles], (99,))
    (int_p99,) = umetrics.percentiles([h.latency_s * 1000.0 for h in int_handles], (99,))
    assert int_p99 <= max(0.5 * hog_p99, 2000.0), (int_p99, hog_p99)
    for c, h in zip(int_cfgs + hog_cfgs, int_handles + hog_handles):
        _assert_numpy(c, h.record)


# -- the port against the reference's own server ----------------------------

def _request_list():
    """Mixed buckets, an invariant check, a session and a tenant envelope."""
    out = [dataclasses.asdict(c) for c in _CFGS]
    out.append({**dataclasses.asdict(_CFGS[2]), "check_invariants": True})
    out.append({**dataclasses.asdict(_session_cfg(seed=7)), "session_slots": 3})
    out.append({**dataclasses.asdict(_cfg(5, instances=11)), "tenant": "alice",
                "priority": 2})
    out.append({**dataclasses.asdict(_cfg(6, protocol="bracha", n=13, f=4,
                                          delivery="urn2")), "deadline_ms": 9000})
    return out


def _serve_all(srv, payloads):
    with srv:
        handles = [srv.submit(p) for p in payloads]
        return [h.wait(timeout=TIMEOUT) for h in handles]


def _strip(doc):
    return {k: v for k, v in doc.items() if k not in ("env", "latency_s")}


def test_same_requests_same_replies_as_the_reference_server():
    """The reference's server on its numpy backend and the port's on the
    CPU: the same ids, buckets, configs, rounds, decisions, session logs
    and invariant blocks — every key but ``env`` and ``latency_s``."""
    payloads = _request_list()
    ref = _serve_all(RefServer(backend="numpy", policy=_POLICY), payloads)
    got = _serve_all(_server(), payloads)
    for r, g in zip(ref, got):
        assert sorted(r) == sorted(g)
        assert _strip(g) == _strip(r)
        _assert_valid(g)
        _assert_valid(r)


def test_served_records_round_trip_through_json():
    with _server() as srv:
        rec = srv.submit(_CFGS[3]).wait(timeout=TIMEOUT)
    again = json.loads(json.dumps(rec))
    assert again == rec
    assert set(rec["env"]) >= {"package", "python", "numpy", "torch"}


# -- lanes: export, import, preemption -------------------------------------

def _blocking_hook():
    """A segment hook that holds the grid's first segment boundary until
    released, so a test can act while lanes are provably live."""
    started, go = threading.Event(), threading.Event()

    def hook(_msg):
        if not started.is_set():
            started.set()
            assert go.wait(timeout=TIMEOUT)

    return hook, started, go


def test_export_queued_request_matches_the_reference_record():
    """A request still queued exports as the reference's trivial record:
    the same JSON document, uint32 ids, resumable in the reference's
    server and in the port's, both replies equal to numpy."""
    cfg = _cfg(41, instances=10)
    srv, ref_srv = _server(), RefServer(backend="numpy", policy=_POLICY)
    h, rh = srv.submit(cfg), ref_srv.submit(_ref(cfg))
    doc = srv.export_lanes([h.id])[0].to_doc()
    ref_doc = ref_srv.export_lanes([rh.id])[0].to_doc()
    assert doc == ref_doc
    assert doc["ids"]["dtype"] == "uint32"
    assert srv.stats()["submitted"] == 1 and not srv._byid
    with RefServer(backend="numpy", policy=_POLICY) as other:
        (hr,) = other.import_lanes([json.loads(json.dumps(doc))])
        rec_ref = hr.wait(timeout=TIMEOUT)
    with _server() as mine:
        (hp,) = mine.import_lanes([json.loads(json.dumps(ref_doc))])
        rec_port = hp.wait(timeout=TIMEOUT)
    _assert_numpy(cfg, rec_ref)
    _assert_numpy(cfg, rec_port)
    srv.shutdown(timeout=TIMEOUT)
    ref_srv.shutdown(timeout=TIMEOUT)


def test_export_live_lanes_into_another_server_bit_identical():
    """A request holding live lanes is extracted at a segment boundary and
    imported into a second server, whose reply equals numpy; the wire is
    the reference's (the reference's ``LaneRecord.from_doc`` reads it)."""
    cfg = _cfg(43, n=9, f=3, instances=40, round_cap=_CEILING)
    hook, started, go = _blocking_hook()
    srv = _server(round_cap_ceiling=_CEILING, segment_hook=hook).start()
    try:
        h = srv.submit(cfg)
        assert started.wait(timeout=TIMEOUT)
        out = {}
        t = threading.Thread(target=lambda: out.setdefault(
            "recs", srv.export_lanes([h.id], timeout=TIMEOUT)))
        t.start()
        time.sleep(0.2)
        go.set()
        t.join(timeout=TIMEOUT)
        (rec,) = out["recs"]
        assert rec.lane_count() > 0
        wire = json.loads(json.dumps(rec.to_doc()))
        ref_lanestate.LaneRecord.from_doc(wire)
    finally:
        go.set()
        srv.shutdown(timeout=TIMEOUT)
    with _server(round_cap_ceiling=_CEILING) as other:
        (h2,) = other.import_lanes([wire])
        _assert_numpy(cfg, h2.wait(timeout=TIMEOUT))


def test_preemption_parks_and_resumes_bit_identical():
    """A deadline-urgent arrival for another bucket parks the live
    rotation's lanes to host; the urgent request replies first and the
    parked one resumes mid-round, both equal to numpy."""
    fat = _cfg(44, n=9, f=3, instances=40, round_cap=_CEILING)
    urgent = _cfg(45, protocol="bracha", n=7, f=2, instances=4, delivery="urn")
    hook, started, go = _blocking_hook()
    with _server(round_cap_ceiling=_CEILING, preempt=True, segment_hook=hook) as srv:
        hf = srv.submit(fat)
        assert started.wait(timeout=TIMEOUT)
        hu = srv.submit({**dataclasses.asdict(urgent), "deadline_ms": 50.0})
        go.set()
        ru, rf = hu.wait(timeout=TIMEOUT), hf.wait(timeout=TIMEOUT)
        stats = srv.stats()
    assert stats["preempt"]["parks"] == 1 and stats["preempt"]["resumes"] == 1
    assert stats["preempt"]["lanes_exported"] > 0
    assert hu.t_reply < hf.t_reply
    _assert_numpy(urgent, ru)
    _assert_numpy(fat, rf)


# -- the direct leg and the refusals ----------------------------------------

class _Recording:
    """A backend that reports a CUDA kernel name and runs the plain path on
    the CPU: the server's leg rule reads only ``kernel``."""

    name = "recording"

    def __init__(self, kernel):
        self.kernel = kernel
        self.device = torch.device("cpu")
        self.calls = []
        self._plain = _be()
        self._resolve_inst_ids = self._plain._resolve_inst_ids

    def run(self, cfg, inst_ids=None):
        self.calls.append(cfg)
        return self._plain.run(cfg, inst_ids)

    def compile_probe(self):
        return 3


@pytest.mark.parametrize("kernel", ["fused", "step", None])
def test_every_kernel_but_plain_takes_the_direct_leg(kernel):
    """``kernel="fused"``, ``"step"`` and ``None`` (CUDA's per-law choice)
    run one ``backend.run`` per request and per session slot, with replies
    and session logs equal to the reference's; ``compile_count`` reads the
    backend's compile probe."""
    be = _Recording(kernel)
    sess = _session_cfg(seed=12)
    with ConsensusServer(be, policy=_POLICY) as srv:
        assert srv.leg == "direct"
        recs = [srv.submit(c).wait(timeout=TIMEOUT) for c in _CFGS]
        srec = srv.submit({**dataclasses.asdict(sess), "session_slots": 3}).wait(
            timeout=TIMEOUT)
        assert srv.compile_count() == 3
        with pytest.raises(ValueError, match="kernel='plain'"):
            srv.import_lanes([])
    assert len(be.calls) == len(_CFGS) + 3
    for cfg, rec in zip(_CFGS, recs):
        _assert_valid(rec)
        _assert_numpy(cfg, rec)
    ref = ref_session.run_session(ref_get_backend("numpy"), _ref(sess), 3)
    assert srec["session"]["decisions"] == [[int(d) for d in r.decision] for r in ref]
    assert srec["session"]["seeds"] == [int(r.config.seed) for r in ref]


def test_direct_leg_cancels_queued_and_fails_one_item_only():
    be = _Recording("fused")
    bad = _cfg(50, instances=3)

    def run(cfg, inst_ids=None):
        if cfg.seed == bad.seed:
            raise RuntimeError("outside the kernel's surface")
        return _be().run(cfg, inst_ids)

    be.run = run
    srv = ConsensusServer(be, policy=_POLICY)  # not started: all queued
    hs = [srv.submit(c) for c in (_CFGS[0], bad, _CFGS[1])]
    ack = srv.cancel(hs[2].id)
    assert ack == {"id": hs[2].id, "found": True, "cancelled": True, "where": "queued"}
    srv.start()
    _assert_numpy(_CFGS[0], hs[0].wait(timeout=TIMEOUT))
    with pytest.raises(RuntimeError, match="outside the kernel's surface"):
        hs[1].wait(timeout=TIMEOUT)
    assert hs[2].error == "cancelled" and hs[2].record is None
    srv.shutdown(timeout=TIMEOUT)
    st = srv.stats()
    assert (st["replied"], st["failed"], st["cancelled"]) == (1, 1, 1)


def test_leg_follows_the_kernel_by_name():
    assert ConsensusServer(_be(), policy=_POLICY).leg == "lanes"
    assert ConsensusServer(_Recording("fused")).leg == "direct"
    assert ConsensusServer(_Recording(None)).leg == "direct"
    assert ConsensusServer(get_backend("cpu")).leg == "direct"


def test_default_server_needs_a_card_and_does_not_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default server runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        ConsensusServer()
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        ConsensusServer("torch")


def test_torch_backend_compile_probe_counts_kernel_libraries():
    from byzantinerandomizedconsensus_tpu_torch.ops import _build

    be = _be()
    assert be.compile_probe() == _build.libraries_in_process()
    be.run(_CFGS[0])  # the plain path builds and loads no kernel library
    assert be.compile_probe() == _build.libraries_in_process()


def test_lane_grid_builds_nothing_after_warm_up():
    """The steady-state pin on the lane leg: a second pass of the same
    request mix adds no ``CompileCache`` entry."""
    with _server() as srv:
        for c in _CFGS:
            srv.submit(c).wait(timeout=TIMEOUT)
        warm = srv.compile_count()
        recs = [srv.submit(dataclasses.replace(c, seed=c.seed + 1)).wait(timeout=TIMEOUT)
                for c in _CFGS]
        assert srv.compile_count() == warm
    for c, rec in zip(_CFGS, recs):
        _assert_numpy(dataclasses.replace(c, seed=c.seed + 1), rec)


# -- obs/record.py ----------------------------------------------------------

ARTIFACTS = sorted((ROOT / "artifacts").glob("*.json"))


@pytest.mark.parametrize("path", ARTIFACTS, ids=[p.name for p in ARTIFACTS])
def test_validate_record_verdicts_equal_the_reference(path):
    doc = json.loads(path.read_text())
    assert record.validate_record(doc) == ref_record.validate_record(doc)
    for key, req in (("serve", record.SERVE_BLOCK_KEYS), ("fleet", record.FLEET_BLOCK_KEYS),
                     ("compaction", record.COMPACTION_BLOCK_KEYS),
                     ("programs", record.PROGRAMS_BLOCK_KEYS),
                     ("trace", record.TRACE_BLOCK_KEYS)):
        assert record.find_blocks(doc, key, req) == ref_record.find_blocks(doc, key, req)
    assert record.parsed_payload(doc) == ref_record.parsed_payload(doc)


def test_record_block_keys_and_builders_equal_the_reference():
    for name in dir(ref_record):
        if name.endswith("_KEYS"):
            assert getattr(record, name) == getattr(ref_record, name), name
    stats = {k: i for i, k in enumerate(
        ref_record.SERVE_BLOCK_KEYS + ref_record.FLEET_BLOCK_KEYS
        + ref_record.HUNT_BLOCK_KEYS + ref_record.HOSTILE_BLOCK_KEYS
        + ref_record.COMMITTEE_BLOCK_KEYS + ref_record.SESSION_BLOCK_KEYS
        + ref_record.ELASTIC_BLOCK_KEYS + ref_record.PREEMPT_BLOCK_KEYS
        + ("duration_s", "population", "best", "fairness", "serve", "slo_ms",
           "urgent_requests", "warmup_compiles", "migrations"))}
    for fn in ("serve_block", "fleet_block", "hunt_block", "hostile_block",
               "committee_block", "session_block", "elastic_block", "preempt_block",
               "fused_block", "lanestate_block"):
        assert getattr(record, fn)(stats) == getattr(ref_record, fn)(stats), fn
        assert getattr(record, fn)(None) is None
    walls = [0.31, 0.25, 0.4]
    for dev in (None, {"device_busy_s": 0.2}, {"device_busy_suspect": "zero"}, {"error": "x"}):
        assert record.timing_block(walls, dev) == ref_record.timing_block(walls, dev)


def test_programs_block_refuses_by_name():
    """``programs_block`` no longer raises: the census of the port's
    kernels (obs/programs.py) is ported. With the census off or empty it
    refuses to build a block (None, a record without it stays valid); with
    entries it builds one that both packages' ``validate_record`` accept."""
    from byzantinerandomizedconsensus_tpu_torch.obs import programs

    programs.disable()
    try:
        assert record.programs_block() is None
        census = programs.configure()
        assert record.programs_block() is None
        cfg = _CFGS[0]
        out, fn, entry = programs.capture_call(
            programs.config_label(cfg), _be().run, (cfg,), {})
        blk = record.programs_block()
    finally:
        programs.disable()
    assert entry["calls"] == 1 and entry["kernels"] == {} and fn is not None
    assert blk["count"] == 1 and blk["programs"][0]["key"].startswith("config/benor/n5/")
    doc = {**record.new_record("programs_census"), "programs": blk}
    assert record.validate_record(doc) == [] == ref_record.validate_record(doc)
    assert record.programs_block(census) == blk


def test_validate_record_flags_bad_blocks_as_the_reference():
    base = record.new_record("serve_reply", config=_CFGS[0])
    cases = [dict(base, record_revision=99), dict(base, serve={"requests": 1}),
             dict(base, fleet={"per_worker": [{}]}), dict(base, hostile={"scenarios": [1]}),
             dict(base, elastic={"slo_ok": 1, "scenarios": [{}]}),
             dict(base, preempt={"deadline_hit_rate": True}),
             dict(base, programs={"count": 1, "programs": [{}]}), dict(base, env=None),
             dict(base, metrics={"names": 1, "slo": {}}), "not a dict"]
    for doc in cases:
        got = record.validate_record(doc)
        assert got and got == ref_record.validate_record(doc)


# -- on the card -------------------------------------------------------------

@pytest.mark.cuda
def test_card_serves_config3_through_the_direct_leg():
    from byzantinerandomizedconsensus_tpu_torch.ops import fused_round

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the direct leg launches the fused round kernel")

    cfg = preset("config3")
    be = get_backend("torch")
    with ConsensusServer(be, round_cap_ceiling=256) as srv:
        assert srv.leg == "direct" and srv.device.type == "cuda"
        before = fused_round.launches
        rec = srv.submit(cfg).wait(timeout=TIMEOUT)
        assert fused_round.launches > before
    off = get_backend("torch").run(cfg)
    assert rec["rounds"] == [int(r) for r in off.rounds]
    assert rec["decision"] == [int(d) for d in off.decision]
