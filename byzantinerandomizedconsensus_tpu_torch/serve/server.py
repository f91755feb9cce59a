"""Consensus-as-a-service: the always-on continuous-batching server.

The port's copy of the reference ``serve/server.py``: ``cli serve`` turns
the batch substrate — fused shape buckets (backends/batch.py), the
decision-driven compacted lane grid (backends/compaction.py), the
thread-safe ``CompileCache`` — into a long-running service:

- **admission** (serve/admission.py) validates each request through the
  existing ``SimConfig``/``validate()`` path and maps it to its
  :class:`FusedBucket`;
- a single **dispatcher thread** owns one active bucket at a time. The
  active bucket's :class:`~byzantinerandomizedconsensus_tpu_torch.backends
  .compaction.WorkFeed` is the continuous-batching seam: same-bucket
  requests push straight into the feed; a request for a *different*
  bucket closes the feed, the active bucket drains, and the dispatcher
  rotates to the next pending bucket (EDF with aging, then tenant
  deficit);
- the bucket runs on one of two **legs**, chosen by the backend's kernel.
  ``kernel="plain"`` takes the compacted lane grid (``run_bucket`` over
  the plain round driver; feed pushes refill freed lanes mid-flight, and
  lanes park, resume, export and import as ``LaneRecord`` s). Every other
  kernel takes the **direct leg**: each request is one ``backend.run`` —
  on the card the fused round kernel or the per-step kernels, so a served
  request launches the same kernels as an offline run;
- each request's reply **streams back as it retires**: the reply is a
  schema-v1.5 run record (obs/record.py) carrying the config provenance,
  per-instance rounds/decisions, and the request latency;
- after one warm-up pass the steady state builds **nothing** new: the lane
  grid's programs are pinned by policy tier and the feed's ``round_cap``
  ceiling (``CompileCache`` compiles), and the direct leg's kernel
  libraries are built once per process (``TorchBackend.compile_probe``).

The dispatcher runs every device operation on the server's device, which
it sets as its thread's current device; HTTP handler threads only admit,
queue and read finished records, and issue no CUDA work.

Graceful shutdown (``shutdown(drain=True)``, also ``with`` exit): the stop
flag closes the active feed, the grid drains in-flight lanes, and every
pending bucket is dispatched to completion before the thread joins — no
request is ever lost. ``drain=False`` fails queued-but-undispatched
requests with a shutdown error instead (in-flight lanes still drain; the
lane grid has no mid-segment abort).

Trace spans: ``serve.request`` per submitted request (the live-follow
heartbeat), ``serve.admit`` at admission, ``serve.dispatch`` per bucket
grid, ``serve.reply`` per streamed reply.

The optional stdlib-HTTP front end (``serve_http`` / ``cli serve``) adds
no dependencies: POST /submit (JSON SimConfig fields) → request id,
GET /result/<id> → the reply record, POST /run → submit-and-wait,
POST /cancel/<id>, GET /stats, GET /healthz and GET /metrics.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

from byzantinerandomizedconsensus_tpu_torch.backends import batch as _batch
from byzantinerandomizedconsensus_tpu_torch.backends import compaction as _compaction
from byzantinerandomizedconsensus_tpu_torch.backends import lanestate as _lanestate
from byzantinerandomizedconsensus_tpu_torch.obs import metrics as _metrics
from byzantinerandomizedconsensus_tpu_torch.obs import programs as _programs
from byzantinerandomizedconsensus_tpu_torch.obs import record as _record
from byzantinerandomizedconsensus_tpu_torch.obs import trace as _trace
from byzantinerandomizedconsensus_tpu_torch.serve import admission as _admission

DEFAULT_ROUND_CAP_CEILING = 128


class ServeRequest:
    """One in-flight request: the admitted config, its timing, and the
    reply record once the last instance retires. ``wait()`` blocks the
    submitting thread until then."""

    __slots__ = ("id", "cfg", "bucket", "t_submit", "t_dispatch", "t_reply",
                 "result", "record", "error", "done", "check_invariants",
                 "tenant", "deadline_ms", "priority", "t_deadline",
                 "cancelled", "session_slots", "slot_results", "served_state")

    def __init__(self, rid: str, cfg, bucket, check_invariants: bool = False,
                 tenant: str = _admission.DEFAULT_TENANT,
                 deadline_ms: Optional[float] = None, priority: int = 0,
                 session_slots: int = 1):
        self.id = rid
        self.cfg = cfg
        self.bucket = bucket
        # spec-§11 session request kind: L chained decision slots streamed
        # over one handle; the grid re-seeds slot k+1 from slot k's decision
        # at its retire seam, and _retire accumulates the per-slot results
        # until the last slot completes the request
        self.session_slots = int(session_slots)
        self.slot_results: list = []
        # opt-in safety checking at retirement: the
        # reply record carries an Agreement/Validity verdict summary
        self.check_invariants = bool(check_invariants)
        # the direct leg's checked run: (result, state, faulty) of the run
        # that answered, which the check reads (None on the lane leg)
        self.served_state = None
        # envelope: scheduling hints only — none of these enter
        # the PRF draws or the bucket key, so replies stay bit-identical
        self.tenant = tenant
        self.deadline_ms = deadline_ms
        self.priority = int(priority)
        self.cancelled = False
        self.t_submit = time.perf_counter()
        self.t_deadline = (None if deadline_ms is None
                           else self.t_submit + deadline_ms / 1000.0)
        # stamped when the request enters a live grid (feed push or seed) —
        # splits latency into queue wait vs grid service for the histograms
        self.t_dispatch: Optional[float] = None
        self.t_reply: Optional[float] = None
        self.result = None
        self.record: Optional[dict] = None
        self.error: Optional[str] = None
        self.done = threading.Event()

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_reply is None:
            return None
        return self.t_reply - self.t_submit

    def wait(self, timeout: Optional[float] = None) -> dict:
        """Block until the reply record is ready and return it. Raises
        ``TimeoutError`` on timeout, ``RuntimeError`` if the request
        failed (dispatch error or non-drain shutdown)."""
        if not self.done.wait(timeout):
            raise TimeoutError(f"request {self.id} not done after "
                               f"{timeout}s")
        if self.error is not None:
            raise RuntimeError(f"request {self.id} failed: {self.error}")
        return self.record


class ConsensusServer:
    """The in-process service. ``submit()`` is thread-safe; replies stream
    through each request's ``wait()`` (and the optional ``on_reply``
    callback, called from the dispatcher thread)."""

    def __init__(self, backend="torch", policy=None,
                 round_cap_ceiling: int = DEFAULT_ROUND_CAP_CEILING,
                 on_reply=None, segment_hook=None,
                 feed_depth: Optional[int] = None,
                 rotation_queue_depth: Optional[int] = None,
                 tenant_inflight_cap: Optional[int] = None,
                 aging_s: float = 5.0,
                 wal_dir=None, preempt: bool = False):
        from byzantinerandomizedconsensus_tpu_torch.backends.base import get_backend

        # ``backend`` is a backend object or a registry name; the default
        # is ``get_backend("torch")``, on the card.
        self._backend = (get_backend(backend) if isinstance(backend, str)
                         else backend)
        # The leg: the compacted lane grid exactly when the backend runs the
        # plain round driver; every other kernel dispatches whole requests.
        self._lanes = getattr(self._backend, "kernel", None) == "plain"
        # The device every dispatch runs on, with its index resolved here
        # so the dispatcher thread never relies on a current-device default.
        dev = torch.device(getattr(self._backend, "device", None) or "cpu")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self._device = dev
        self._policy = (policy or _compaction.CompactionPolicy(
            width=64, segment=1)).validate()
        self._ceiling = int(round_cap_ceiling)
        self._on_reply = on_reply
        # Called once per grid segment with the progress message (the
        # run_bucket ``progress`` seam) — nothing flows back into the
        # simulation math.
        self._segment_hook = segment_hook
        # -- traffic bounds (None everywhere = unbounded) --
        # active WorkFeed bound: a same-bucket push over it raises
        # WorkFeedOverflow, surfaced as Backpressure/429
        self._feed_depth = (None if not feed_depth else int(feed_depth))
        # total requests allowed to wait for a grid rotation
        self._rotation_queue_depth = (None if not rotation_queue_depth
                                      else int(rotation_queue_depth))
        # per-tenant outstanding-request cap
        self._tenant_cap = (None if not tenant_inflight_cap
                            else int(tenant_inflight_cap))
        # EDF aging: a request with no deadline behaves as if its deadline
        # were t_submit + aging_s, bounding starvation under EDF; priority
        # shifts the effective deadline by whole aging windows
        self._aging_s = float(aging_s)
        # seeded jitter for Retry-After hints: deterministic per server, so
        # hostile-suite runs are reproducible while a rejected crowd of
        # clients still decorrelates
        self._retry_rng = random.Random(0xB9C + int(round_cap_ceiling))
        self._cv = threading.Condition()
        # bucket -> [ServeRequest] queued while another bucket holds the grid
        self._pending: dict = {}
        # (bucket, WorkFeed, [ServeRequest], LaneControl) while a grid is
        # resident — the control is the snapshot mailbox (None on
        # direct-dispatch kernels, which lane compaction cannot host)
        self._active = None
        # preemptive scheduling — True lets a deadline-urgent
        # arrival park the active rotation's fat-tail lanes to host
        # (LaneRecords) and resume them after; replies stay bit-identical
        # because restore is
        self._preempt = bool(preempt)
        # bucket -> ([LaneRecord], [ServeRequest]) rotations parked by a
        # preemption (or lanes imported by a fleet migration) awaiting
        # resume; the dispatcher treats these like pending buckets and
        # re-dispatches them with imports= so lanes continue mid-round
        self._parked: dict = {}
        self._preempt_parks = 0
        self._preempt_resumes = 0
        self._lanes_exported = 0
        self._lanes_imported = 0
        self._stop = False
        self._drain_on_stop = True
        self._counter = 0
        self._submitted = 0
        self._replied = 0
        self._failed = 0
        self._cancelled_n = 0
        # id -> unfinished ServeRequest, for cancel(rid); entries leave at
        # retire/fail/cancel so memory stays bounded by in-flight work
        self._byid: dict = {}
        # tenant -> outstanding requests / cumulative dispatched lane-round
        # weight (round_cap × instances, the balancing currency) — the
        # deficit side of the fairness ordering
        self._tenant_inflight: dict = {}
        self._tenant_served: dict = {}
        self._thread: Optional[threading.Thread] = None
        # write-ahead admission log — every admitted envelope is
        # journaled (durably) before dispatch, so a dispatcher crash loses
        # nothing: recover() replays incomplete entries bit-identically
        from byzantinerandomizedconsensus_tpu_torch.serve.wal import WriteAheadLog
        self._wal = WriteAheadLog(wal_dir) if wal_dir else None
        self._recovering = False

    @property
    def device(self) -> "torch.device":
        """The device every dispatch runs on."""
        return self._device

    @property
    def leg(self) -> str:
        """``"lanes"`` (the compacted lane grid, ``kernel="plain"``) or
        ``"direct"`` (one ``backend.run`` per request)."""
        return "lanes" if self._lanes else "direct"

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ConsensusServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._thread = threading.Thread(target=self._loop,
                                        name="brc-serve-dispatch",
                                        daemon=True)
        self._thread.start()
        return self

    def __enter__(self) -> "ConsensusServer":
        return self.start()

    def __exit__(self, *exc):
        self.shutdown(drain=True)

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop the service. ``drain=True`` (the default, and the ``with``
        semantics) dispatches every queued bucket to completion first — no
        request is lost. ``drain=False`` fails queued-but-undispatched
        requests; the active grid still drains its in-flight lanes."""
        with self._cv:
            self._stop = True
            self._drain_on_stop = drain
            if not drain:
                for reqs in self._pending.values():
                    for req in reqs:
                        self._fail(req, "server shutdown before dispatch")
                self._pending.clear()
                for _recs, reqs in self._parked.values():
                    for req in reqs:
                        if not req.done.is_set():
                            self._fail(req, "server shutdown before resume")
                self._parked.clear()
            if self._active is not None:
                self._active[1].close()
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
        if self._wal is not None:
            self._wal.close()

    # -- submission --------------------------------------------------------

    def submit(self, payload, check_invariants: bool = False,
               _rid: Optional[str] = None) -> ServeRequest:
        """Admit a request payload and queue it. Returns the
        :class:`ServeRequest` handle; ``handle.wait()`` blocks for the
        reply record. Raises on invalid payloads or a stopped server.

        ``check_invariants`` (kwarg, or a ``"check_invariants"`` key in a
        dict payload — the HTTP spelling) asks for the opt-in safety
        summary: the reply record gains an ``"invariants"`` block with
        Agreement/Validity verdicts computed at retirement.

        Dict payloads may also carry the envelope fields
        (``tenant``, ``deadline_ms``, ``priority`` —
        serve/admission.py ``envelope()``); they steer *scheduling* only
        and never enter the config, so replies stay bit-identical. Raises
        :class:`~byzantinerandomizedconsensus_tpu_torch.serve.admission
        .Backpressure` when a configured bound (rotation queue, per-tenant
        in-flight cap) is hit, and
        :class:`~byzantinerandomizedconsensus_tpu_torch.backends.compaction
        .WorkFeedOverflow` when a bounded active feed is full — the HTTP
        front end maps both to 429 + Retry-After."""
        payload, env = _admission.envelope(payload)
        if check_invariants:
            env["check_invariants"] = True
        cfg = _admission.admit(payload, round_cap_ceiling=self._ceiling)
        bucket = _admission.bucket_of(cfg)
        # a session's true lane-round claim is L slots' worth — the
        # deficit-weighted fairness must see it, or a long log rides at
        # single-request weight (the session_hog scenario pins this)
        weight = (int(cfg.round_cap) * int(cfg.instances)
                  * int(env["session_slots"]))
        with self._cv:
            if self._stop:
                raise RuntimeError("server is shutting down")
            if self._recovering and _rid is None:
                # replay in progress — new work must not
                # interleave ahead of the dead dispatcher's admissions
                self._backpressure_locked(
                    "recovering",
                    "WAL recovery replay in progress")
            tenant = env["tenant"]
            if self._tenant_cap is not None and \
                    self._tenant_inflight.get(tenant, 0) >= self._tenant_cap:
                self._backpressure_locked(
                    "tenant_cap",
                    f"tenant {tenant!r} is at its in-flight cap "
                    f"({self._tenant_cap})")
            if _rid is None:
                self._counter += 1
                rid = f"r{self._counter:06d}"
            else:
                rid = _rid  # recovery replay keeps the original id
            req = ServeRequest(rid, cfg, bucket,
                               check_invariants=env["check_invariants"],
                               tenant=tenant,
                               deadline_ms=env["deadline_ms"],
                               priority=env["priority"],
                               session_slots=env["session_slots"])
        # journal the admitted envelope OUTSIDE the dispatch lock
        # (group-committed fsync must not serialize the dispatcher) and
        # strictly BEFORE placement — a crash after this line loses nothing.
        # Replays skip re-journaling: their admit entry already exists.
        if self._wal is not None and _rid is None:
            self._wal.append_admit(req.id, dataclasses.asdict(cfg), env)
        with self._cv:
            if self._stop:
                if self._wal is not None and _rid is None:
                    self._wal.append_done(req.id, failed=True)
                raise RuntimeError("server is shutting down")
            try:
                placed = False
                if self._active is not None and self._active[0] == bucket:
                    try:
                        self._active[1].push(cfg, token=req,
                                             session=req.session_slots)
                        req.t_dispatch = time.perf_counter()
                        self._active[2].append(req)
                        self._tenant_served[tenant] = \
                            self._tenant_served.get(tenant, 0) + weight
                        if _metrics.enabled():
                            _metrics.counter(
                                "brc_serve_tenant_served_weight_total",
                                "Lane-round weight dispatched, by tenant",
                                tenant=tenant).inc(weight)
                        placed = True
                    except _compaction.WorkFeedOverflow:
                        # a bounded feed refuses the join outright: queueing
                        # it anyway would defeat backpressure, so the client
                        # is told to retry (it likely lands next rotation)
                        self._backpressure_locked(
                            "overflow",
                            f"active feed for {bucket.label()} is at its "
                            f"bound ({self._feed_depth})")
                    except RuntimeError:
                        # the feed closed under us (rotation/shutdown race):
                        # the request queues for the bucket's next grid
                        placed = False
                if not placed:
                    if self._rotation_queue_depth is not None and \
                            sum(len(v) for v in self._pending.values()) \
                            >= self._rotation_queue_depth:
                        self._backpressure_locked(
                            "overflow",
                            f"rotation queue is at its bound "
                            f"({self._rotation_queue_depth})")
                    self._pending.setdefault(bucket, []).append(req)
                    if self._active is not None and self._active[0] != bucket:
                        # rotation: the resident grid stops refilling, drains
                        # its stragglers, and yields to this bucket
                        self._active[1].close()
                        if self._preempt and self._preempt_worthy_locked(req):
                            # don't even wait for the drain — park
                            # the resident lanes to host at the next segment
                            # boundary; they resume mid-round after the
                            # urgent bucket replies (bit-identical restore)
                            self._preempt_parks += 1
                            _trace.event("serve.preempt", id=req.id,
                                         parked=self._active[0].label(),
                                         urgent=bucket.label())
                            if _metrics.enabled():
                                _metrics.counter(
                                    "brc_preempt_parked_total",
                                    "Rotations parked to host for a "
                                    "deadline-urgent arrival").inc()
                            self._active[3].park(self._active[1])
            except _admission.Backpressure:
                # the journaled admit was refused after all — close it so
                # recovery never replays a request the client saw rejected
                if self._wal is not None and _rid is None:
                    self._wal.append_done(req.id, failed=True)
                raise
            self._submitted += 1
            self._byid[req.id] = req
            self._tenant_inflight[tenant] = \
                self._tenant_inflight.get(tenant, 0) + 1
            _trace.event("serve.request", id=req.id, bucket=bucket.label(),
                         instances=int(cfg.instances), tenant=tenant)
            if req.session_slots > 1:
                _trace.event("serve.session_open", id=req.id,
                             slots=req.session_slots, bucket=bucket.label(),
                             tenant=tenant)
                if _metrics.enabled():
                    _metrics.counter(
                        "brc_session_opened_total",
                        "Session requests admitted (spec §11)").inc()
            self._cv.notify_all()
        return req

    def _backpressure_locked(self, reason: str, msg: str) -> None:
        """Reject over a traffic bound: named rejection metric, a
        ``serve.backpressure`` event, and a seeded-jitter Retry-After hint
        (raises :class:`~byzantinerandomizedconsensus_tpu_torch.serve.admission
        .Backpressure`). Caller holds ``self._cv``."""
        _admission._reject(reason)
        retry_after = round(0.05 + self._retry_rng.random() * 0.45, 3)
        _trace.event("serve.backpressure", reason=reason,
                     retry_after_s=retry_after)
        raise _admission.Backpressure(
            f"{msg}; retry after {retry_after}s",
            reason=reason, retry_after_s=retry_after)

    def _release_locked(self, req: ServeRequest) -> None:
        """Drop a finished request from the in-flight books (caller holds
        ``self._cv``): the cancel registry and its tenant's count."""
        self._byid.pop(req.id, None)
        n = self._tenant_inflight.get(req.tenant, 0) - 1
        if n > 0:
            self._tenant_inflight[req.tenant] = n
        else:
            self._tenant_inflight.pop(req.tenant, None)

    # -- cancellation ------------------------------------------------------

    def cancel(self, rid: str) -> dict:
        """Cancel an unfinished request by id. Queued work dies
        immediately (pending rotation queue) or at the feed; a request
        already holding live lanes is reclaimed by the grid at the next
        segment boundary (``run_bucket``'s reap seam) — its lanes refill
        from the feed and its reply is never produced. Replies that
        already streamed are too late to cancel.

        Returns an ack dict: ``{"id", "found", "cancelled", "where"}``
        with ``where`` one of ``"queued"``/``"live"`` (or absent when
        nothing was cancelled)."""
        if _metrics.enabled():
            _metrics.counter("brc_serve_cancel_requested_total",
                             "Cancellations requested").inc()
        with self._cv:
            req = self._byid.get(rid)
            if req is None or req.done.is_set():
                if _metrics.enabled():
                    _metrics.counter(
                        "brc_serve_cancel_too_late_total",
                        "Cancellations that missed (unknown or already "
                        "done)").inc()
                return {"id": rid, "found": req is not None,
                        "cancelled": False,
                        "done": req is not None and req.done.is_set()}
            req.cancelled = True
            where = "live"
            reqs = self._pending.get(req.bucket)
            if reqs is not None and req in reqs:
                reqs.remove(req)
                if not reqs:
                    del self._pending[req.bucket]
                where = "queued"
            elif self._active is not None and self._active[0] == req.bucket:
                # feed.cancel() strips a still-queued item (True: it never
                # reached a lane) and leaves a reap marker either way — a
                # live lane owner is reclaimed at the next segment boundary
                where = ("queued" if self._active[1].cancel(req)
                         else "live")
            req.error = "cancelled"
            self._cancelled_n += 1
            self._release_locked(req)
            if self._wal is not None:
                # a cancelled request must not rise from the dead at
                # recovery: close its journal entry like any other reply
                self._wal.append_done(req.id, failed=True)
            req.done.set()
            self._cv.notify_all()
        if _metrics.enabled():
            _metrics.counter(
                "brc_serve_cancelled_total",
                "Requests cancelled before their reply",
                where=where).inc()
        _trace.event("serve.cancel", id=rid, where=where,
                     bucket=req.bucket.label())
        return {"id": rid, "found": True, "cancelled": True, "where": where}

    # -- dispatcher --------------------------------------------------------

    def _preempt_worthy_locked(self, req: ServeRequest) -> bool:
        """True when ``req`` justifies parking the active rotation: it
        carries an explicit deadline, it is EDF-more-urgent than
        everything the active grid still owes, the grid can actually take a
        snapshot (lane-compaction kernel, a live control), and no spec-§11
        session rides the rotation (sessions are never extractable — they
        chain at the grid's retire seam). Caller holds ``self._cv``."""
        if req.t_deadline is None:
            return False
        if self._active is None or self._active[3] is None:
            return False
        live = [r for r in self._active[2] if not r.done.is_set()]
        if not live:
            return False
        if any(r.session_slots > 1 for r in live) \
                or self._active[1].sessions() > 0:
            return False
        urgency_active = min(
            (r.t_deadline if r.t_deadline is not None
             else r.t_submit + self._aging_s)
            - r.priority * self._aging_s for r in live)
        return (req.t_deadline - req.priority * self._aging_s
                < urgency_active)

    def _next_bucket_locked(self):
        """Pick the bucket for the next grid rotation.

        Each pending bucket is keyed by (quantized urgency, tenant deficit,
        arrival, label):

        - **urgency** — the bucket's most urgent request under EDF: its
          deadline, or ``t_submit + aging_s`` when it has none (the aging
          term bounds starvation — after one aging window a FIFO request
          looks like an expired deadline and beats any future one).
          ``priority`` shifts urgency by whole aging windows. Quantized to
          100 ms so the fairness term can break near-ties.
        - **tenant deficit** — the least cumulative dispatched lane-round
          weight (``round_cap×instances``) among the bucket's tenants: a
          hog tenant's buckets lose ties to starved tenants' buckets.

        Ordering here only chooses *which* grid runs next; same-bucket
        joins stay arrival-timing-free, so program cache keys — and the
        zero-recompile pin — are untouched. Parked rotations
        (preempted lanes awaiting resume, migrated lanes awaiting import)
        compete under the same key, so a parked fat tail cannot be starved
        by a stream of fresh arrivals beyond its EDF/aging due.
        Caller holds ``self._cv``."""
        candidates: dict = {}
        for bucket, reqs in self._pending.items():
            candidates.setdefault(bucket, []).extend(reqs)
        for bucket, (_recs, reqs) in self._parked.items():
            candidates.setdefault(bucket, []).extend(
                r for r in reqs if not r.done.is_set())

        def key(item):
            bucket, reqs = item
            urgency = min(
                (r.t_deadline if r.t_deadline is not None
                 else r.t_submit + self._aging_s)
                - r.priority * self._aging_s
                for r in reqs)
            deficit = min(self._tenant_served.get(r.tenant, 0)
                          for r in reqs)
            t0 = min(r.t_submit for r in reqs)
            return (round(urgency, 1), deficit, t0, bucket.label())

        return min(((b, rs) for b, rs in candidates.items() if rs),
                   key=key)[0]

    def _loop(self) -> None:
        if self._device.type == "cuda":
            # the dispatcher's own current device: every kernel and plain
            # op below lands on the server's card, whatever thread made it
            torch.cuda.set_device(self._device)
        while True:
            with self._cv:
                while not self._stop and not self._pending \
                        and not self._parked:
                    self._cv.wait()
                if not self._pending and not self._parked:
                    return  # stopped and drained
                bucket = self._next_bucket_locked()
                reqs = self._pending.pop(bucket, [])
                imports, resumed = self._parked.pop(bucket, ([], []))
                resumed = [r for r in resumed if not r.done.is_set()]
                imports = [rec for rec in imports
                           if rec.token is None
                           or not rec.token.done.is_set()]
                feed = _compaction.WorkFeed(round_cap_ceiling=self._ceiling,
                                            max_depth=self._feed_depth)
                # seed before the feed is visible to submitters: a rotation
                # close cannot land mid-seed (seeding ignores the depth
                # bound — these requests were already admitted)
                for req in reqs:
                    feed.push(req.cfg, token=req, force=True,
                              session=req.session_slots)
                    req.t_dispatch = time.perf_counter()
                    w = (int(req.cfg.round_cap) * int(req.cfg.instances)
                         * req.session_slots)
                    self._tenant_served[req.tenant] = \
                        self._tenant_served.get(req.tenant, 0) + w
                    if _metrics.enabled():
                        _metrics.counter(
                            "brc_serve_tenant_served_weight_total",
                            "Lane-round weight dispatched, by tenant",
                            tenant=req.tenant).inc(w)
                if imports:
                    # resume: parked/migrated LaneRecords ride the
                    # run_bucket imports= seam — their lanes continue
                    # mid-round, so no re-run, no re-seeding, no new
                    # program key (snapshot arrays are data operands)
                    self._preempt_resumes += 1
                    self._lanes_imported += sum(r.lane_count()
                                                for r in imports)
                    _trace.event("serve.resume", bucket=bucket.label(),
                                 records=len(imports),
                                 lanes=sum(r.lane_count() for r in imports))
                    if _metrics.enabled():
                        _metrics.counter(
                            "brc_preempt_resumed_total",
                            "Parked rotations resumed mid-round").inc()
                _trace.event("serve.rotate", bucket=bucket.label(),
                             seeded=len(reqs), resumed=len(imports),
                             pending_buckets=len(self._pending))
                run_reqs = list(reqs) + resumed
                control = _lanestate.LaneControl() if self._lanes else None
                self._active = (bucket, feed, run_reqs, control)
                # keep the feed open only when this bucket is the sole
                # claimant and the server is live — otherwise seed-and-drain
                if self._stop or self._pending or self._parked:
                    feed.close()
            try:
                with _trace.span("serve.dispatch", bucket=bucket.label(),
                                 seeded=len(reqs)):
                    if not self._lanes:
                        # The CUDA kernels (and the arbiters) run whole
                        # requests per backend call: the lane grid runs the
                        # plain round driver only (backends/batch.py), so
                        # the feed drains directly. Replies are
                        # bit-identical either way (backend determinism);
                        # each kernel library builds once per process, so
                        # the steady state builds nothing.
                        self._dispatch_direct(feed)
                    else:
                        _compaction.run_bucket(
                            self._backend, bucket, [], [], policy=self._policy,
                            feed=feed, on_retire=self._retire,
                            progress=self._segment_hook,
                            control=control, imports=imports)
            except Exception as e:  # noqa: BLE001 — a grid failure must
                # fail its requests, never kill the dispatcher
                feed.close()
                with self._cv:
                    for req in run_reqs:
                        if not req.done.is_set():
                            self._fail(req, f"dispatch error: {e!r}")
            finally:
                if control is not None:
                    control.detach()
            with self._cv:
                self._active = None
                if control is not None and control.parked:
                    self._park_rotation_locked(bucket, feed, control.parked)
                self._cv.notify_all()

    def _park_rotation_locked(self, bucket, feed, parked_records) -> None:
        """Stash a parked rotation's LaneRecords for a later resume
        (caller holds ``self._cv``; the grid has already exited). Records
        whose request finished or cancelled in the meantime are dropped;
        feed items that raced in after the park boundary re-queue as
        ordinary pending requests (their lanes never existed, so fresh
        dispatch is bit-identical)."""
        recs = [r for r in parked_records
                if r.token is not None and not r.token.done.is_set()]
        feed.close()
        items = feed.pull()
        for _cfg, _ids, token, _session in (items or []):
            if token is not None and not token.done.is_set():
                self._pending.setdefault(bucket, []).append(token)
        if not recs:
            return
        self._lanes_exported += sum(r.lane_count() for r in recs)
        old_recs, old_reqs = self._parked.get(bucket, ([], []))
        self._parked[bucket] = (old_recs + recs,
                                old_reqs + [r.token for r in recs])
        _trace.event("serve.park", bucket=bucket.label(),
                     records=len(recs),
                     lanes=sum(r.lane_count() for r in recs))

    # -- lane export/import (the migration seam) ---------------------------

    def _trivial_record(self, req: ServeRequest) -> "_lanestate.LaneRecord":
        """A pending-only LaneRecord for a request that never reached a
        grid: every lane is a pure function of ``(key, iid)``, so
        exporting a queued request is just shipping its config. Its ids are
        uint32, as in the reference's records."""
        ids = np.asarray(
            self._backend._resolve_inst_ids(req.cfg, None), dtype=np.uint32)
        k = int(ids.shape[0])
        return _lanestate.LaneRecord(
            version=_lanestate.LANESTATE_VERSION,
            cfg=req.cfg,
            ids=ids,
            rounds=np.zeros(k, dtype=np.int32),
            decision=np.zeros(k, dtype=np.uint8),
            remaining=k,
            pending=[(p, int(i)) for p, i in enumerate(ids)],
            lanes={"pos": np.empty(0, dtype=np.int64),
                   "r": np.empty(0, dtype=np.int32),
                   "st": {}, "setup": []},
            token=req)

    def export_lanes(self, rids, timeout: float = 30.0) -> list:
        """Extract the named unfinished requests as serialized
        :class:`~byzantinerandomizedconsensus_tpu_torch.backends.lanestate
        .LaneRecord` objects — the migration seam. A request still queued
        for a rotation serializes trivially; one parked by a preemption hands
        its stored record over; one holding live lanes is exported by the
        grid at its next segment boundary (``LaneControl.extract``) while
        the rotation keeps flying. Exported requests leave this server's
        books entirely — the importer owns their replies. Sessions,
        finished requests, and unknown ids are skipped (a request that
        retires while the extract is in flight simply replies here and is
        absent from the result)."""
        out, live = [], []
        with self._cv:
            active = self._active
            for rid in rids:
                req = self._byid.get(rid)
                if req is None or req.done.is_set() \
                        or req.session_slots > 1:
                    continue
                reqs = self._pending.get(req.bucket)
                if reqs is not None and req in reqs:
                    reqs.remove(req)
                    if not reqs:
                        del self._pending[req.bucket]
                    out.append(self._trivial_record(req))
                    self._release_locked(req)
                    continue
                parked = self._parked.get(req.bucket)
                if parked is not None:
                    recs, preqs = parked
                    rec = next((r for r in recs if r.token is req), None)
                    if rec is not None:
                        recs.remove(rec)
                        preqs.remove(req)
                        if not recs and not preqs:
                            del self._parked[req.bucket]
                        out.append(rec)
                        self._release_locked(req)
                        continue
                if active is not None and active[0] == req.bucket \
                        and active[3] is not None:
                    live.append(req)
            self._cv.notify_all()
        if live:
            recs = active[3].extract(live, feed=active[1], timeout=timeout)
            with self._cv:
                for rec in recs:
                    self._release_locked(rec.token)
                    if self._active is active and rec.token in active[2]:
                        active[2].remove(rec.token)
                self._cv.notify_all()
            out.extend(recs)
        self._lanes_exported += sum(r.lane_count() for r in out)
        if out:
            _trace.event("serve.export", records=len(out),
                         lanes=sum(r.lane_count() for r in out))
        return out

    def import_lanes(self, docs,
                     tenant: str = _admission.DEFAULT_TENANT) -> list:
        """Admit serialized LaneRecord documents (the migration import; raw
        LaneRecords, of this package or the reference, also accepted).
        Each record becomes a fresh parked request; the dispatcher resumes
        it through ``run_bucket``'s ``imports=`` seam, so mid-round lanes
        continue bit-identically. Returns the :class:`ServeRequest` handles
        (replies stream as usual). Lanes resume only in the lane grid: on
        the direct leg this raises ``ValueError`` by name."""
        if not self._lanes:
            raise ValueError(
                "import_lanes resumes lanes in the compacted lane grid, which "
                "runs kernel='plain'; this server's backend runs kernel="
                f"{getattr(self._backend, 'kernel', None)!r} (pass kernel='plain')")
        recs = [rec if isinstance(rec, _lanestate.LaneRecord)
                else _lanestate.LaneRecord.from_doc(rec) for rec in docs]
        handles = []
        with self._cv:
            if self._stop:
                raise RuntimeError("server is shutting down")
            for rec in recs:
                self._counter += 1
                rid = f"r{self._counter:06d}"
                bucket = _admission.bucket_of(rec.cfg)
                req = ServeRequest(rid, rec.cfg, bucket, tenant=tenant)
                rec.token = req
                old_recs, old_reqs = self._parked.get(bucket, ([], []))
                self._parked[bucket] = (old_recs + [rec],
                                        old_reqs + [req])
                self._submitted += 1
                self._byid[req.id] = req
                self._tenant_inflight[tenant] = \
                    self._tenant_inflight.get(tenant, 0) + 1
                handles.append(req)
                _trace.event("serve.import", id=rid, bucket=bucket.label(),
                             lanes=rec.lane_count(),
                             pending=len(rec.pending))
            if handles and self._active is not None:
                # force a rotation so the imported lanes dispatch promptly
                # (the EDF key decides whether they actually go first)
                self._active[1].close()
            self._cv.notify_all()
        return handles

    def _dispatch_direct(self, feed) -> None:
        """Drain ``feed`` one config at a time through ``backend.run`` —
        the dispatch leg of every kernel but the plain driver (on the card,
        the fused round kernel or the per-step kernels). A per-item failure
        (e.g. a config outside the fused kernel's named surface) fails only
        its own request; the grid keeps draining.
        Cancels that land while an item is queued were already stripped by
        ``WorkFeed.cancel``; a cancel that races the run itself is dropped
        at :meth:`_retire` (the reply is discarded, as on the lane path).
        A request with ``check_invariants`` runs its config once, through
        ``backend.run_with_state``: the reply's check reads that run's own
        final state, and the config is not run a second time (a backend
        without that method, an arbiter or the mesh, is checked as the lane
        leg is)."""
        from byzantinerandomizedconsensus_tpu_torch.models import (
            session as _session_mod)

        while True:
            items = feed.pull(block=True)
            if items is None:
                return
            feed.pop_cancelled()  # queued cancels already left the feed
            for cfg, ids, token, session in items:
                slots = int(session) if session else 1
                slot_cfg = cfg
                try:
                    for k in range(slots):
                        checked = (k == 0 and token is not None and token.check_invariants
                                   and hasattr(self._backend, "run_with_state"))
                        run = _programs.instrument(
                            _programs.config_label(slot_cfg),
                            self._backend.run_with_state if checked else self._backend.run)
                        result = run(slot_cfg, inst_ids=ids)
                        if checked:
                            token.served_state = result
                            result = result[0]
                        if token is not None:
                            self._retire(token, result)
                        if k + 1 < slots:
                            # spec §11 inline: this leg has no lane grid, so
                            # the chain runs here — same law, same seeds
                            slot_cfg = _session_mod.next_slot_config(
                                slot_cfg, k, result.decision)
                except Exception as e:  # noqa: BLE001 — isolate the item
                    if token is not None:
                        with self._cv:
                            if not token.done.is_set():
                                self._fail(token, f"dispatch error: {e!r}")
                finally:
                    if session:
                        feed.session_done(token)

    def _retire(self, req: ServeRequest, result) -> None:
        with self._cv:
            if req.cancelled or req.done.is_set():
                # cancel() won the race (its reap marker lands at a later
                # boundary than this retirement): the reply is dropped —
                # the request already answered "cancelled"
                return
            if req.session_slots > 1:
                # one call per slot (same token): accumulate the partials,
                # complete the request only at the last slot
                req.slot_results.append(result)
                slot = len(req.slot_results) - 1
                _trace.event("serve.session_slot", id=req.id, slot=slot,
                             slots=req.session_slots,
                             seed=int(result.config.seed))
                if _metrics.enabled():
                    _metrics.counter(
                        "brc_session_slots_replied_total",
                        "Session slots streamed at retire (spec §11)").inc()
                if len(req.slot_results) < req.session_slots:
                    return
                _trace.event("serve.session_done", id=req.id,
                             slots=req.session_slots)
                if _metrics.enabled():
                    _metrics.counter(
                        "brc_session_completed_total",
                        "Sessions that streamed every slot").inc()
            req.t_reply = time.perf_counter()
            self._replied += 1
            self._release_locked(req)
        req.result = result
        req.record = self._reply_record(req, result)
        if _metrics.enabled():
            if req.t_deadline is not None:
                if req.t_reply <= req.t_deadline:
                    _metrics.counter(
                        "brc_serve_deadline_met_total",
                        "Replies that beat their deadline_ms "
                        "envelope").inc()
                else:
                    _metrics.counter(
                        "brc_serve_deadline_missed_total",
                        "Replies that missed their deadline_ms "
                        "envelope").inc()
            _metrics.counter("brc_serve_replied_total",
                             "Replies streamed back at retire").inc()
            _metrics.histogram(
                "brc_serve_request_latency_seconds",
                "End-to-end request latency (admit to reply)").observe(
                    req.latency_s)
            if req.t_dispatch is not None:
                _metrics.histogram(
                    "brc_serve_queue_wait_seconds",
                    "Admit-to-dispatch wait (time queued for a grid)"
                ).observe(max(0.0, req.t_dispatch - req.t_submit))
                _metrics.histogram(
                    "brc_serve_service_seconds",
                    "Dispatch-to-reply grid service time").observe(
                        max(0.0, req.t_reply - req.t_dispatch))
        _trace.event("serve.reply", id=req.id, bucket=req.bucket.label(),
                     latency_s=round(req.latency_s, 6))
        if self._wal is not None:
            # journal the completion BEFORE waking waiters: anyone who saw
            # this reply must never see the request replayed at recovery
            self._wal.append_done(req.id)
        req.done.set()
        if self._on_reply is not None:
            self._on_reply(req)

    def _fail(self, req: ServeRequest, why: str) -> None:
        # caller holds self._cv (shutdown and the dispatch-error path)
        req.error = why
        self._failed += 1
        self._release_locked(req)
        _metrics.counter("brc_serve_failed_total",
                         "Requests failed after admission").inc()
        if self._wal is not None:
            self._wal.append_done(req.id, failed=True)
        req.done.set()

    def _reply_record(self, req: ServeRequest, result) -> dict:
        """The schema-v1.5 reply document streamed back per request. A
        session reply's top-level rounds/decision are slot 0's (the base
        config's own run, so existing differential checks hold unchanged);
        the ``session`` block carries the whole per-slot log — enough to
        bit-replay the chain offline from the base seed alone."""
        base = req.slot_results[0] if req.session_slots > 1 else result
        doc = _record.new_record("serve_reply", config=req.cfg)
        doc["request_id"] = req.id
        doc["bucket"] = req.bucket.label()
        doc["inst_ids"] = [int(i) for i in base.inst_ids]
        doc["rounds"] = [int(r) for r in base.rounds]
        doc["decision"] = [int(d) for d in base.decision]
        doc["latency_s"] = round(req.latency_s, 6)
        if req.session_slots > 1:
            doc["session"] = {
                "slots": req.session_slots,
                "seeds": [int(r.config.seed) for r in req.slot_results],
                "rounds": [[int(x) for x in r.rounds]
                           for r in req.slot_results],
                "decisions": [[int(x) for x in r.decision]
                              for r in req.slot_results],
            }
        if req.check_invariants:
            doc["invariants"] = self._invariant_summary(req.cfg, req.served_state)
        return doc

    def _invariant_summary(self, cfg, served=None) -> dict:
        """The opt-in reply safety block: the safety invariants
        (models/invariants.py) over a full per-replica state, folded into
        Agreement/Validity booleans plus a per-kind count, a second pass the
        *client* no longer has to make. On the direct leg ``served`` is
        ``(result, state, faulty)`` of the run that answered (slot 0's for a
        session): the check reads that run's own state. The lane leg keeps
        no per-replica state (``run_bucket`` retires rounds and decisions
        only), so there ``served`` is None and the config runs again on the
        plain round driver with its full state, on the server's device."""
        from byzantinerandomizedconsensus_tpu_torch.models import (
            invariants as _invariants)
        if served is None:
            rep = _invariants.check_config(cfg, device=self._device)
        else:
            res, state, faulty = served
            rep = {"checked_instances": int(len(res.inst_ids)),
                   "violations": _invariants.state_violations(
                       cfg, state, faulty, res=res, inst_ids=res.inst_ids,
                       device=self._device)}
        viols = rep["violations"]
        by_kind: dict = {}
        for v in viols:
            by_kind[v["kind"]] = by_kind.get(v["kind"], 0) + 1
        if _metrics.enabled():
            _metrics.counter(
                "brc_serve_invariant_checks_total",
                "Opt-in reply invariant checks run at retirement").inc()
            if viols:
                _metrics.counter(
                    "brc_serve_invariant_violations_total",
                    "Safety violations surfaced by reply invariant "
                    "checks").inc(len(viols))
        return {
            "checked_instances": rep["checked_instances"],
            "violations": len(viols),
            "by_kind": by_kind,
            "agreement_ok": by_kind.get("agreement", 0) == 0,
            "validity_ok": by_kind.get("validity", 0) == 0,
            # enough detail to reproduce the first few offenders standalone
            "detail": viols[:8],
        }

    # -- WAL recovery -------------------------------------------

    @property
    def recovering(self) -> bool:
        """True while a WAL replay is in flight (fresh submits get the
        named ``recovering`` backpressure — HTTP 503 + Retry-After)."""
        return self._recovering

    def recover(self, timeout: Optional[float] = None,
                on_submitted=None, on_admitted=None) -> dict:
        """Replay the WAL's admitted-but-unreplied envelopes through
        normal admission under their original request ids and wait for
        their replies. Deterministic replay makes each recovered reply
        bit-identical to what the dead dispatcher would have returned
        (spec-§11 session logs included). While the replay runs, external
        submits reject with the named ``recovering`` 503. Recovering twice
        is a no-op: replayed completions are journaled, so the second plan
        is empty. ``on_submitted`` (optional) is called with each handle
        right after its re-admission — the HTTP front end registers them
        so ``/result/<original id>`` answers for recovered requests;
        ``on_admitted`` (optional) once every owed request is re-admitted,
        before the replies are awaited — ``cli serve --recover`` opens its
        HTTP plane then, so an owed id never answers 404."""
        from byzantinerandomizedconsensus_tpu_torch.serve import wal as _wal
        if self._wal is None:
            raise RuntimeError("recover() needs a WAL (wal_dir=...)")
        pairs, counter = _wal.recover_payloads(self._wal.directory)
        with self._cv:
            self._counter = max(self._counter, counter)
            self._recovering = True
        handles = []
        try:
            for rid, payload in pairs:
                while True:
                    try:
                        handles.append(self.submit(payload, _rid=rid))
                        break
                    except _admission.Backpressure as e:
                        time.sleep(e.retry_after_s)
                if on_submitted is not None:
                    on_submitted(handles[-1])
            if on_admitted is not None:
                on_admitted()
            for h in handles:
                h.done.wait(timeout)
        finally:
            with self._cv:
                self._recovering = False
                self._cv.notify_all()
        recovered = sum(1 for h in handles if h.record is not None)
        _trace.event("serve.recovered", replayed=len(handles),
                     recovered=recovered)
        return {"replayed": len(handles), "recovered": recovered,
                "ids": [h.id for h in handles], "handles": handles}

    # -- monitoring --------------------------------------------------------

    def stats(self) -> dict:
        alive = self._thread is not None and self._thread.is_alive()
        with self._cv:
            active = self._active[0].label() if self._active else None
            feed_depth = self._active[1].pending() if self._active else 0
            pending = {b.label(): len(v) for b, v in self._pending.items()}
            inflight = (sum(1 for r in self._active[2]
                            if not r.done.is_set())
                        if self._active else 0)
            load = 0
            if self._active is not None:
                load += sum(r.cfg.round_cap * r.cfg.instances
                            * r.session_slots
                            for r in self._active[2] if not r.done.is_set())
            for reqs in self._pending.values():
                load += sum(r.cfg.round_cap * r.cfg.instances
                            * r.session_slots for r in reqs)
            out = {
                "submitted": self._submitted,
                "feed_depth": feed_depth,
                "replied": self._replied,
                "failed": self._failed,
                "cancelled": self._cancelled_n,
                "recovering": self._recovering,
                "active_bucket": active,
                "pending": pending,
                # preemption plane: parked rotations awaiting
                # resume, and the lane snapshot/restore odometers
                "parked": {
                    b.label(): sum(1 for r in reqs if not r.done.is_set())
                    for b, (_recs, reqs) in self._parked.items()},
                "preempt": {
                    "enabled": self._preempt,
                    "parks": self._preempt_parks,
                    "resumes": self._preempt_resumes,
                    "lanes_exported": self._lanes_exported,
                    "lanes_imported": self._lanes_imported,
                },
                # traffic plane: per-tenant outstanding requests
                # (zero entries kept for ever-seen tenants so the gauge
                # falls back to 0) and the configured bounds (all None =
                # pre-18 behavior)
                "tenants": {
                    t: self._tenant_inflight.get(t, 0)
                    for t in set(self._tenant_inflight)
                    | set(self._tenant_served)},
                "bounds": {
                    "feed_depth": self._feed_depth,
                    "rotation_queue_depth": self._rotation_queue_depth,
                    "tenant_inflight_cap": self._tenant_cap,
                },
                "policy": self._policy.doc(),
                "round_cap_ceiling": self._ceiling,
                "leg": self.leg,
                "device": str(self._device),
                # one-shape rule: the single-grid server reports
                # the same worker/per_worker surface as the fleet, so /stats
                # consumers never branch on worker count
                "workers": 1,
                "alive": 1 if alive else 0,
                "per_worker": [{
                    "worker": 0, "pid": os.getpid(), "alive": alive,
                    "replied": self._replied, "steals": 0,
                    "inflight": inflight, "pending": pending, "load": load,
                }],
            }
        out["compile_cache"] = _batch.compile_cache(self._backend).stats()
        # the leg's own build counter (compile_count): kernel libraries on
        # the direct leg, lane-program builds on the lane leg
        out["compile_count"] = self.compile_count()
        return out

    def health(self) -> dict:
        """Liveness doc for ``GET /healthz``: ok iff the dispatcher thread
        is running (same shape as the fleet's per-worker report)."""
        alive = self._thread is not None and self._thread.is_alive()
        return {"ok": bool(alive), "workers": 1, "alive": 1 if alive else 0,
                "dead_workers": [] if alive else [0]}

    def refresh_metrics(self) -> None:
        """Update the point-in-time gauges just before a ``/metrics``
        render (counters and histograms update at their own seams)."""
        if not _metrics.enabled():
            return
        st = self.stats()
        _metrics.gauge("brc_serve_feed_depth",
                       "Configs pending in the active WorkFeed").set(
                           st["feed_depth"])
        _metrics.gauge("brc_serve_pending_requests",
                       "Requests queued behind another bucket's grid").set(
                           sum(st["pending"].values()))
        _metrics.gauge("brc_compile_cache_entries",
                       "Programs resident in the CompileCache").set(
                           st["compile_cache"]["entries"])
        for tenant, n in st.get("tenants", {}).items():
            _metrics.gauge("brc_serve_tenant_inflight",
                           "Outstanding requests per tenant",
                           tenant=tenant).set(n)

    def compile_count(self) -> int:
        """Builds so far — the zero-steady-state probe."""
        if not self._lanes:
            # Direct-dispatch kernels never enter the bucket CompileCache;
            # their build surface is the kernel libraries of this process.
            probe = getattr(self._backend, "compile_probe", None)
            if probe is not None:
                return int(probe())
        return int(_batch.compile_cache(self._backend).stats()["compiles"])


# -- stdlib HTTP front end -------------------------------------------------

#: Largest accepted request body. A SimConfig-fields JSON object is a few
#: hundred bytes; anything near this bound is hostile or broken, and is
#: rejected 413 with the named ``body_too_large`` rejection metric before
#: a byte of it is read.
MAX_BODY_BYTES = 1 << 20
#: A body refused 413 is still read and dropped, up to this many bytes and
#: with this socket timeout, so the reply reaches a client that is still
#: sending it (``serve_http``'s ``_discard_body``).
MAX_DRAIN_BYTES = 64 * MAX_BODY_BYTES
DRAIN_TIMEOUT_S = 5.0


class _BodyTooLarge(Exception):
    def __init__(self, length: int):
        super().__init__(f"request body {length} bytes exceeds the "
                         f"{MAX_BODY_BYTES}-byte cap")
        self.length = length


def serve_http(server: ConsensusServer, host: str = "127.0.0.1",
               port: int = 8787):
    """Wrap a started :class:`ConsensusServer` in a stdlib HTTP endpoint
    (no new dependencies). Returns the ``ThreadingHTTPServer``; the caller
    owns ``serve_forever``/``shutdown``."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    requests: dict = {}
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet: the trace is the log
            pass

        def _reply(self, code: int, doc: dict, headers=None) -> None:
            body = json.dumps(doc).encode()
            try:
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                pass  # client went away mid-reply; nothing to salvage

        def _reply_text(self, code: int, text: str,
                        content_type: str = _metrics.CONTENT_TYPE) -> None:
            body = text.encode("utf-8")
            try:
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                pass  # client went away mid-reply; nothing to salvage

        def _read_payload(self):
            length = int(self.headers.get("Content-Length") or 0)
            if length > MAX_BODY_BYTES:
                raise _BodyTooLarge(length)
            raw = self.rfile.read(length) if length else b"{}"
            return json.loads(raw.decode() or "{}")

        def _discard_body(self, length: int) -> None:
            """Read and drop a refused body after its 413 went out. Closing
            with the body unread resets the connection (TCP RST), and a
            client still sending it gets a broken pipe in place of the
            413; bodies past :data:`MAX_DRAIN_BYTES`, or a client that
            stalls, are cut off."""
            self.connection.settimeout(DRAIN_TIMEOUT_S)
            left = min(length, MAX_DRAIN_BYTES)
            try:
                while left > 0:
                    chunk = self.rfile.read(min(left, 1 << 16))
                    if not chunk:
                        return
                    left -= len(chunk)
            except OSError:
                pass  # the client gave up or stalled: nothing to salvage

        def do_GET(self):  # noqa: N802 — stdlib handler name
            if self.path == "/healthz":
                # per-worker liveness: 503 + the dead worker
                # list when any worker is down and un-respawned
                health = getattr(server, "health", None)
                doc = health() if health is not None else {"ok": True}
                return self._reply(200 if doc.get("ok") else 503, doc)
            if self.path == "/metrics":
                # point-in-time gauges refresh at scrape; everything else
                # accumulated at its seam. Valid exposition text either
                # way — a disabled plane answers with a comment line.
                refresh = getattr(server, "refresh_metrics", None)
                if refresh is not None:
                    refresh()
                return self._reply_text(200, _metrics.render())
            if self.path == "/stats":
                return self._reply(200, server.stats())
            if self.path.startswith("/result/"):
                rid = self.path[len("/result/"):]
                with lock:
                    req = requests.get(rid)
                if req is None:
                    return self._reply(404, {"error": f"unknown id {rid!r}"})
                if not req.done.is_set():
                    return self._reply(202, {"id": rid, "done": False})
                if req.error is not None:
                    return self._reply(500, {"id": rid, "error": req.error})
                return self._reply(200, req.record)
            return self._reply(404, {"error": f"unknown path {self.path!r}"})

        def do_POST(self):  # noqa: N802 — stdlib handler name
            if self.path.startswith("/cancel/"):
                rid = self.path[len("/cancel/"):]
                with lock:
                    known = rid in requests
                cancel = getattr(server, "cancel", None)
                if not known or cancel is None:
                    # same 404-with-JSON contract as /result/<id>
                    return self._reply(404, {"error": f"unknown id {rid!r}"})
                return self._reply(200, cancel(rid))
            if self.path not in ("/submit", "/run"):
                return self._reply(404,
                                   {"error": f"unknown path {self.path!r}"})
            try:
                payload = self._read_payload()
                req = server.submit(payload)
            except _BodyTooLarge as e:
                _admission._reject("body_too_large")
                self.close_connection = True
                self._reply(413, {"error": str(e)}, {"Connection": "close"})
                return self._discard_body(e.length)
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                return self._reply(400, {"error": str(e)})
            except (_compaction.WorkFeedOverflow,
                    _admission.Backpressure) as e:
                # backpressure, not failure: 429 + a Retry-After hint
                # (seeded jitter) — before the RuntimeError→503 arm, since
                # both types subclass RuntimeError. The exception:
                # a WAL replay in flight answers 503 (unavailable, not
                # overloaded) so fresh work can't interleave ahead of the
                # dead dispatcher's admissions; Retry-After still rides.
                retry_after = getattr(e, "retry_after_s", 0.1)
                reason = getattr(e, "reason", "overflow")
                return self._reply(
                    503 if reason == "recovering" else 429,
                    {"error": str(e),
                     "reason": reason,
                     "retry_after_s": retry_after},
                    headers={"Retry-After": f"{retry_after:.3f}"})
            except RuntimeError as e:
                return self._reply(503, {"error": str(e)})
            with lock:
                requests[req.id] = req
            if self.path == "/submit":
                return self._reply(200, {"id": req.id, "done": False})
            try:
                return self._reply(200, req.wait(timeout=300.0))
            except Exception as e:  # timeout / failed dispatch
                return self._reply(500, {"id": req.id, "error": str(e)})

    httpd = ThreadingHTTPServer((host, port), Handler)
    # the recovery thread registers replayed handles here so
    # /result/<original id> answers for recovered requests too
    httpd.requests, httpd.requests_lock = requests, lock
    return httpd


#: The fleet's options (serve/fleet.py, serve/autoscale.py).
FLEET_FLAGS = ("--workers", "--max-workers", "--min-workers", "--max-respawns",
               "--migrate")


def main(argv=None) -> int:
    """``cli serve`` — run the HTTP service until interrupted: one
    single-grid server, or with ``--workers N`` (N > 1) or ``--max-workers``
    a fleet of worker processes (serve/fleet.py) behind the same front
    door, with the autoscaler when ``--max-workers`` is given. Exits 2 with
    a message, serving nothing, when no CUDA device is available and
    ``--device cpu`` was not asked for (naming the fleet options given),
    or on a fleet shape out of range."""
    import argparse

    from byzantinerandomizedconsensus_tpu_torch.backends.base import get_backend
    from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import KERNELS
    from byzantinerandomizedconsensus_tpu_torch.cli import backend_options

    ap = argparse.ArgumentParser(
        prog="byzantinerandomizedconsensus_tpu_torch.cli serve",
        description="Always-on consensus service: continuous batching over "
                    "the compacted lane grid (--kernel plain) or one kernel "
                    "run per request (fused, step), streamed schema-v1.5 "
                    "replies, nothing built at steady state.")
    ap.add_argument("--backend", default="torch",
                    help="simulator backend (default torch)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits nonzero with no card) or cpu")
    ap.add_argument("--kernel", choices=KERNELS, default=None,
                    help="fused or step: one backend run per request on the "
                         "card (with none named, fused for urn, urn2, urn3 "
                         "and committee, step for keys); plain: the "
                         "compacted lane grid over the plain round driver "
                         "(the CPU's only kernel)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787,
                    help="TCP port (0: an ephemeral port, printed on the "
                         "listening line)")
    ap.add_argument("--policy", default="width=64,segment=1",
                    help="compaction policy spec (CompactionPolicy.parse)")
    ap.add_argument("--round-cap-ceiling", type=int,
                    default=DEFAULT_ROUND_CAP_CEILING,
                    help="max admitted round_cap; pins the drain program")
    ap.add_argument("--trace-dir", default=None,
                    help="write a serve trace JSONL under this directory")
    ap.add_argument("--metrics", action="store_true",
                    help="enable the live metrics plane (GET /metrics, "
                         "Prometheus text format; BRC_METRICS=1 does the "
                         "same)")
    ap.add_argument("--feed-depth", type=int, default=0,
                    help="bound the active WorkFeed: same-bucket joins "
                         "over this depth answer 429 + Retry-After "
                         "(0 = unbounded, the default)")
    ap.add_argument("--rotation-queue-depth", type=int, default=0,
                    help="bound the total requests waiting for a grid "
                         "rotation (0 = unbounded, the default)")
    ap.add_argument("--tenant-cap", type=int, default=0,
                    help="per-tenant outstanding-request cap "
                         "(0 = uncapped, the default)")
    ap.add_argument("--wal", default=None, metavar="DIR",
                    help="write-ahead admission log: journal every admitted "
                         "envelope to DIR before dispatch so a dispatcher "
                         "crash loses nothing; see --recover")
    ap.add_argument("--recover", default=None, metavar="DIR",
                    help="replay DIR's incomplete WAL entries through "
                         "normal admission under their original request "
                         "ids before taking new work (implies --wal DIR); "
                         "deterministic replay makes recovered replies "
                         "bit-identical; new submits get 503 + Retry-After "
                         "while the replay runs")
    ap.add_argument("--preempt", action="store_true",
                    help="preemptive scheduling (lane grid only): a "
                         "deadline-urgent arrival parks the active "
                         "rotation's lanes to host (bit-identical "
                         "snapshot/restore, backends/lanestate.py) and "
                         "resumes them after")
    fleet = ap.add_argument_group(
        "fleet options", "N worker processes behind one front door "
        "(serve/fleet.py): bucket-affinity routing, work stealing, worker "
        "loss re-admitted under the same ids; on one card every worker "
        "shares it")
    fleet.add_argument("--workers", type=int, default=1,
                       help="worker count: 1 runs the single-grid server, "
                            ">1 the fleet")
    fleet.add_argument("--max-workers", type=int, default=0,
                       help=">0 enables the metrics-driven autoscaler "
                            "(serve/autoscale.py) between --min-workers and "
                            "this ceiling")
    fleet.add_argument("--min-workers", type=int, default=0,
                       help="autoscaler floor (default: --workers)")
    fleet.add_argument("--max-respawns", type=int, default=0,
                       help="budget for respawning crashed workers "
                            "(exponential backoff; the named terminal state "
                            "respawn_budget_exhausted when spent; 0: none)")
    fleet.add_argument("--migrate", action="store_true",
                       help="lane-level stealing: an idle worker imports "
                            "serialized lanes from the busiest one (live "
                            "lanes on --kernel plain; on fused and step, "
                            "requests no run has started)")
    args = ap.parse_args(argv)

    given = [flag for flag, on in zip(FLEET_FLAGS, (
        args.workers != 1, args.max_workers != 0, args.min_workers != 0,
        args.max_respawns != 0, args.migrate)) if on]
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        what = (f"the fleet ({', '.join(given)}) runs its workers"
                if given else "the server runs")
        print(f"cli serve: no CUDA device is available; {what} on the card "
              "by default and does not fall back to the CPU — pass --device "
              "cpu to serve from the CPU (kernel 'plain', the lane grid)",
              file=sys.stderr)
        return 2
    autoscale = args.max_workers > 0
    n_workers = max(args.workers, args.min_workers, 1)
    use_fleet = n_workers > 1 or autoscale
    problems = []
    if args.workers < 1:
        problems.append(f"--workers {args.workers} (>= 1)")
    if args.max_respawns < 0:
        problems.append(f"--max-respawns {args.max_respawns} (>= 0)")
    if autoscale and max(1, args.min_workers) > args.max_workers:
        problems.append(f"--min-workers {args.min_workers} above "
                        f"--max-workers {args.max_workers}")
    if problems:
        print(f"cli serve: out of range: {'; '.join(problems)}",
              file=sys.stderr)
        return 2
    backend = None
    if not use_fleet:
        try:
            backend = get_backend(args.backend, **backend_options(
                args.backend, args.device, args.kernel))
        except (KeyError, RuntimeError, ValueError) as e:
            print(f"cli serve: {e}", file=sys.stderr)
            return 2

    wal_dir = args.recover or args.wal
    if args.trace_dir:
        _trace.configure(out_dir=args.trace_dir,
                         role="fleet-coord" if use_fleet else "serve")
    if args.metrics:
        _metrics.configure()
    else:
        _metrics.maybe_enable_from_env()
    policy = _compaction.CompactionPolicy.parse(args.policy)
    if use_fleet:
        # the parent only routes: it builds the kernel libraries and spawns
        # the workers, each on its placed device, and never touches a card
        from byzantinerandomizedconsensus_tpu_torch.serve.fleet import FleetServer

        server = FleetServer(workers=n_workers, backend=args.backend,
                             device=args.device, kernel=args.kernel,
                             policy=policy,
                             round_cap_ceiling=args.round_cap_ceiling,
                             trace_dir=args.trace_dir,
                             rotation_queue_depth=(
                                 args.rotation_queue_depth or None),
                             tenant_inflight_cap=args.tenant_cap or None,
                             max_respawns=args.max_respawns,
                             wal_dir=wal_dir, migrate=args.migrate)
        try:
            server.start()
        except RuntimeError as e:
            # a worker that did not come up (its card missing, say): named,
            # and the workers already up are stopped
            print(f"cli serve: {e}", file=sys.stderr)
            return 2
    else:
        server = ConsensusServer(backend, policy=policy,
                                 round_cap_ceiling=args.round_cap_ceiling,
                                 feed_depth=args.feed_depth or None,
                                 rotation_queue_depth=(
                                     args.rotation_queue_depth or None),
                                 tenant_inflight_cap=args.tenant_cap or None,
                                 wal_dir=wal_dir, preempt=args.preempt)
    with server as srv:
        httpd = serve_http(srv, host=args.host, port=args.port)
        scaler = None
        if autoscale:
            from byzantinerandomizedconsensus_tpu_torch.serve.autoscale import Autoscaler

            scaler = Autoscaler(srv, min_workers=max(1, args.min_workers),
                                max_workers=args.max_workers).start()
        if args.recover:
            # replay in the background while the HTTP plane answers 503s;
            # recovered handles register so /result/<original id> works,
            # and the plane opens only once every owed id is registered
            admitted = threading.Event()

            def _register(handle):
                with httpd.requests_lock:
                    httpd.requests[handle.id] = handle

            def _replay():
                try:
                    rec = srv.recover(on_submitted=_register,
                                      on_admitted=admitted.set)
                finally:
                    admitted.set()
                print(f"cli serve: recovery replayed {rec['replayed']} "
                      f"request(s), {rec['recovered']} recovered", flush=True)

            threading.Thread(target=_replay, name="wal-recover",
                             daemon=True).start()
            admitted.wait()
        host, port = httpd.server_address[:2]
        where = (f"fleet of {n_workers} workers, {srv.leg} leg on "
                 f"{args.device}" if use_fleet
                 else f"{srv.leg} leg on {srv.device}")
        print(f"cli serve: listening on http://{host}:{port} "
              f"({where}, policy {policy.doc()}, cap "
              f"ceiling {args.round_cap_ceiling})", flush=True)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            print("cli serve: draining and shutting down", flush=True)
        finally:
            httpd.server_close()
            if scaler is not None:
                scaler.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
