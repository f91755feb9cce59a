"""Fleet serving: the sharded multi-worker dispatcher.

The port's copy of the reference ``serve/fleet.py``. One front door, N
resident servers. :class:`FleetServer` places N workers, each a full
single-grid :class:`~byzantinerandomizedconsensus_tpu_torch.serve.server
.ConsensusServer` with its *own* backend instance on its placed device and
its own trace sink, and routes every admitted request to exactly one of
them:

- **admission** stays the single-server path (serve/admission.py →
  ``SimConfig``/``validate()`` → :class:`FusedBucket`); the fleet adds a
  routing layer, never a second request schema;
- **bucket affinity**: the ``bucket → worker`` map is sticky, so repeat
  traffic for a shape lands on the worker whose kernel libraries (and live
  ``WorkFeed``) are already warm — a same-bucket request joins that
  worker's in-flight rotation, exactly as on one server. New buckets go to
  the least-loaded live worker, where load is lane-round weight
  (``round_cap x instances`` summed over queued requests), not request
  count — a fat-tailed bucket is worth dozens of quickies;
- **work stealing**: each worker's parent-side queue is an ordered map of
  pending bucket rotations. A worker that goes idle first pumps its own
  *longest* rotation (LPT: chain length is bounded by the longest member
  ``round_cap``, so dispatching long chains first keeps the end-game
  straggler short); with nothing left it steals the longest pending
  rotation from the peer with the heaviest stealable backlog, same
  lane-round weight (whole rotations move, never slices of one). Every
  reply re-pumps fully idle peers, so a chunked backlog is continuously
  rebalanced;
- **worker loss**: when a worker dies mid-stream (EOF on its protocol
  pipe), its in-flight and queued rotations are re-admitted to the
  survivors under the same fleet request ids — replies stay bit-identical
  to the offline run because identity and math never touched the dead
  process's arrival timing.

Each worker runs the leg its backend's kernel picks (serve/server.py):
``kernel="plain"`` the compacted lane grid, where ``--migrate`` moves live
lanes between workers as serialized records; ``fused`` and ``step`` one
``backend.run`` a request through the CUDA kernels, where an export moves
only requests that no run has started (a worker imports those by
admitting their config afresh, which is bit-identical: nothing of them ran).

``mode="process"`` (the default) spawns ``serve/worker.py`` children with
the subprocess discipline of the reference's chaos soak — ready-or-timeout
(``CHAOS_TIMEOUT_S``), exponential backoff (``CHAOS_BACKOFF_S *
2**attempt``), one respawn attempt — and per-worker ``BRC_TRACE`` JSONL
sinks that ``obs/trace.py::merge`` folds into one fleet timeline. The
parent only routes: it creates no CUDA context. It builds the kernel
libraries first (``ops/_build.py::build``, which needs ``nvcc`` but no
card), so no worker compiles, and names each worker's device as a string
(:func:`placement`); each worker checks that its card exists and exits
non-zero by name if not, which the parent reports as a failed spawn, never
as a CPU worker. ``mode="thread"`` runs the same routing fabric over
in-process servers (the fast surface for routing and stealing tests).

Placement goes through ``parallel/mesh.py::fleet_placement``: with fewer
cards than workers every worker shares one (``shared: true``; on one H100,
``cuda:0`` for all), otherwise each gets its own.

Elasticity and a budgeted failure path: ``scale_up()`` spawns an extra
worker through the same ladder; ``scale_down()`` marks the least-loaded
worker **retiring** — it is excluded from routing and stealing, its
parent-side queue re-admits to the survivors (the same re-admission path a
crash uses, so replies stay bit-identical), it drains its in-flight
rotation, and leaves through the graceful shutdown handshake: no
``brc_fleet_workers_lost_total`` increment, no ``dead_workers`` entry, no
503. ``max_respawns`` (default 0: a worker lost mid-stream stays lost)
lets the fleet replace a worker lost *mid-stream*: exponential backoff
between replacements, and a **named terminal state**
(``respawn_budget_exhausted`` in ``health()``/``stats()``) once the budget
runs out, instead of silent permanent loss.

Trace kinds (role ``fleet-coord``): ``fleet.spawn``, ``fleet.backoff``,
``fleet.route``, ``fleet.dispatch``, ``fleet.steal``, ``fleet.worker_lost``,
``fleet.readmit``, ``fleet.shutdown``, ``fleet.retire``, ``fleet.respawn``,
``fleet.migrate``.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import random
import subprocess
import sys
import threading
import time
from types import SimpleNamespace
from typing import Optional

import torch

from byzantinerandomizedconsensus_tpu_torch.backends import compaction as _compaction
from byzantinerandomizedconsensus_tpu_torch.obs import metrics as _metrics
from byzantinerandomizedconsensus_tpu_torch.obs import trace as _trace
from byzantinerandomizedconsensus_tpu_torch.serve import admission as _admission
from byzantinerandomizedconsensus_tpu_torch.serve.server import (
    DEFAULT_ROUND_CAP_CEILING, ConsensusServer)
from byzantinerandomizedconsensus_tpu_torch.tools.soak import (
    CHAOS_BACKOFF_S, CHAOS_TIMEOUT_S)

_STATS_RPC_TIMEOUT_S = 30.0


def reply_timing(req) -> dict:
    """A worker's split of a served request's time, from its inner
    :class:`~byzantinerandomizedconsensus_tpu_torch.serve.server.ServeRequest`:
    ``queue_s`` admit to dispatch, ``service_s`` dispatch to reply; both
    None for a request that resumed imported lanes (it has no dispatch of
    its own there)."""
    if req.t_dispatch is None or req.t_reply is None:
        return {"queue_s": None, "service_s": None}
    return {"queue_s": req.t_dispatch - req.t_submit,
            "service_s": req.t_reply - req.t_dispatch}


class FleetRequest:
    """One fleet-level request: same wait/latency surface as
    :class:`~byzantinerandomizedconsensus_tpu_torch.serve.server
    .ServeRequest`,
    but owned by the dispatcher — the id (``f000001``) survives routing,
    stealing, and re-admission after a worker loss."""

    __slots__ = ("id", "cfg", "bucket", "t_submit", "t_reply", "record",
                 "error", "done", "tenant", "deadline_ms", "priority",
                 "t_deadline", "cancelled", "session_slots", "t_dispatch",
                 "worker_timing")

    def __init__(self, rid: str, cfg, bucket,
                 tenant: str = _admission.DEFAULT_TENANT,
                 deadline_ms: Optional[float] = None, priority: int = 0,
                 session_slots: int = 1):
        self.id = rid
        self.cfg = cfg
        self.bucket = bucket
        # scheduling envelope — routing/ordering hints only;
        # nothing here enters the config or the PRF draws
        self.tenant = tenant
        self.deadline_ms = deadline_ms
        self.priority = int(priority)
        # spec-§11 session length: a session is bucket-affine and rides one
        # worker whole (its slots chain inside that worker's grid), so its
        # routing weight is L slots' worth — see _WorkerBase.load
        self.session_slots = int(session_slots)
        self.cancelled = False
        self.t_submit = time.perf_counter()
        self.t_deadline = (None if deadline_ms is None
                           else self.t_submit + deadline_ms / 1000.0)
        self.t_reply: Optional[float] = None
        # when the parent last handed it to a worker, and the worker's own
        # split of its time there (``queue_s`` before a grid or run took
        # it, ``service_s`` after), as its reply reported them
        self.t_dispatch: Optional[float] = None
        self.worker_timing: Optional[dict] = None
        self.record: Optional[dict] = None
        self.error: Optional[str] = None
        self.done = threading.Event()

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_reply is None:
            return None
        return self.t_reply - self.t_submit

    @property
    def queue_s(self) -> Optional[float]:
        """Time queued: in the parent until the last dispatch, then in the
        worker until its grid or run took the request."""
        if self.t_dispatch is None or not self.worker_timing \
                or self.worker_timing.get("queue_s") is None:
            return None
        return (self.t_dispatch - self.t_submit) + self.worker_timing["queue_s"]

    @property
    def service_s(self) -> Optional[float]:
        """The worker's time from taking the request to its reply."""
        return (self.worker_timing or {}).get("service_s")

    def wait(self, timeout: Optional[float] = None) -> dict:
        if not self.done.wait(timeout):
            raise TimeoutError(f"request {self.id} not done after "
                               f"{timeout}s")
        if self.error is not None:
            raise RuntimeError(f"request {self.id} failed: {self.error}")
        return self.record


def _policy_spec(policy: "_compaction.CompactionPolicy") -> str:
    """The argv spelling of a policy (CompactionPolicy.parse round-trip)."""
    parts = []
    if policy.width is not None:
        parts.append(f"width={policy.width}")
    parts.append(f"segment={policy.segment}")
    parts.append(f"threshold={policy.refill_threshold}")
    return ",".join(parts)


class _WorkerBase:
    """Parent-side bookkeeping for one worker. All mutable routing state
    (``current_bucket`` / ``inflight`` / ``pending``) is owned by the
    fleet's lock, never this object's threads."""

    def __init__(self, fleet: "FleetServer", idx: int):
        self.fleet = fleet
        self.idx = idx
        self.alive = False
        # autoscaler scale-down: retiring = excluded from
        # routing/stealing while its in-flight rotation drains; retired =
        # gone through the graceful handshake (never counted dead);
        # replaced = crashed but re-covered by a budgeted respawn
        self.retiring = False
        self.retired = False
        self.replaced = False
        self.pid: Optional[int] = None
        # the bucket whose rotation this worker currently runs (the
        # single-bucket-inflight invariant: every inflight req shares it)
        self.current_bucket = None
        self.inflight: dict = {}            # fleet id -> FleetRequest
        self.pending: dict = {}             # bucket -> [FleetRequest], FIFO
        # buckets queued by pin_worker (warm-up targeting): peers must not
        # steal these — a stolen warm-up would warm the wrong cache
        self.pinned: set = set()
        self.replied = 0
        self.steals = 0
        # the leg the worker's server runs ("lanes" or "direct") and its
        # device, as the worker reported them when it came up
        self.leg: Optional[str] = None
        self.device: Optional[str] = None

    def queued(self) -> int:
        return len(self.inflight) + sum(len(v) for v in self.pending.values())

    def load(self) -> int:
        """Lane-round proxy for this worker's queued work: sum of
        round_cap x instances over inflight + pending. Request count is a
        poor balance key when the population has a fat tail — one
        round_cap-ceiling request is worth dozens of quickies, and a
        worker that is handed two fat-tailed buckets becomes the
        whole-burst straggler even though its request count looks fair.
        A session (spec §11) weighs its full L-slot chain."""
        total = sum(r.cfg.round_cap * r.cfg.instances * r.session_slots
                    for r in self.inflight.values())
        for reqs in self.pending.values():
            total += sum(r.cfg.round_cap * r.cfg.instances
                         * r.session_slots for r in reqs)
        return total

    # subclasses: start() / send(req) / live_stats() / request_shutdown()
    # / finish_shutdown() / kill()


class _ProcessWorker(_WorkerBase):
    """A subprocess worker speaking the serve/worker.py JSON-lines
    protocol, spawned with the chaos ladder (ready-or-timeout, backoff,
    one respawn attempt)."""

    def __init__(self, fleet: "FleetServer", idx: int):
        super().__init__(fleet, idx)
        self.proc: Optional[subprocess.Popen] = None
        self._reader: Optional[threading.Thread] = None
        self._wlock = threading.Lock()
        self._ready = threading.Event()
        self._bye = threading.Event()
        self._expect_exit = False
        self.final_stats: Optional[dict] = None
        self._rpc_cv = threading.Condition()
        self._rpc_out: dict = {}
        # the last lines the child wrote to stderr: named in a failed spawn
        self._stderr_tail: collections.deque = collections.deque(maxlen=20)
        self.ready_s: Optional[float] = None

    def argv(self) -> list:
        """The child's command line: the worker's bootstrap (which moves
        descriptor 1 off the protocol pipe before anything loads) and its
        options, the placed device named explicitly."""
        from byzantinerandomizedconsensus_tpu_torch.serve import worker as _worker

        f = self.fleet
        slot = f.slot(self.idx)
        argv = [sys.executable, "-c", _worker.BOOTSTRAP,
                "--index", str(self.idx),
                "--backend", f._backend_name,
                "--device", slot["device"],
                "--policy", _policy_spec(f._policy),
                "--round-cap-ceiling", str(f._ceiling),
                "--placement", json.dumps(slot)]
        if f._kernel is not None:
            argv += ["--kernel", f._kernel]
        if f._segment_latency_s > 0:
            argv += ["--segment-latency-s", str(f._segment_latency_s)]
        return argv

    # -- spawn ladder ------------------------------------------------------

    def start(self) -> None:
        f = self.fleet
        argv = self.argv()
        env = dict(os.environ)
        # the child imports this package from where the parent did,
        # whatever its working directory
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH")) if p)
        if f._trace_dir is not None:
            env[_trace.TRACE_ENV] = str(f._trace_dir)
        if _metrics.enabled():
            # the child self-enables (serve/worker.py) and ships its
            # registry snapshot back over stats/bye frames
            env[_metrics.METRICS_ENV] = "1"
        attempts = 1 + f._spawn_retries
        why = None
        for attempt in range(attempts):
            self._ready.clear()
            self._stderr_tail.clear()
            t0 = time.perf_counter()
            self.proc = subprocess.Popen(
                argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, env=env, text=True, bufsize=1)
            self._reader = threading.Thread(
                target=self._read_loop, name=f"fleet-w{self.idx}-reader",
                daemon=True)
            self._reader.start()
            threading.Thread(target=self._pump_stderr, args=(self.proc,),
                             name=f"fleet-w{self.idx}-stderr",
                             daemon=True).start()
            # ready, or the child's exit, or the timeout — whichever first
            deadline = time.monotonic() + f._spawn_timeout_s
            while not self._ready.wait(0.05):
                if self.proc.poll() is not None \
                        or time.monotonic() >= deadline:
                    break
            if self._ready.is_set():
                self.alive = True
                self.pid = self.proc.pid
                self.ready_s = time.perf_counter() - t0
                _trace.event("fleet.spawn", worker=self.idx, pid=self.pid,
                             attempt=attempt, ready_s=round(self.ready_s, 6))
                return
            # ready never came: kill, back off, retry once — the chaos
            # spawn discipline (tools/soak.py)
            code = self.proc.poll()
            self.proc.kill()
            self.proc.wait()
            self._reader.join(timeout=5.0)
            why = (f"exited with code {code}" if code is not None
                   else f"not ready within {f._spawn_timeout_s:.0f}s")
            if attempt + 1 < attempts:
                delay = f._backoff_s * (2 ** attempt)
                _metrics.counter("brc_fleet_respawns_total",
                                 "Worker spawn retries (backoff ladder)"
                                 ).inc()
                _trace.event("fleet.backoff", worker=self.idx,
                             attempt=attempt, delay_s=delay)
                time.sleep(delay)
        tail = " | ".join(self._stderr_tail)
        raise RuntimeError(
            f"fleet worker {self.idx} failed to become ready after "
            f"{attempts} attempt(s) on {f.slot(self.idx)['device']}: it "
            f"{why}" + (f"; its stderr ends: {tail}" if tail else ""))

    def _pump_stderr(self, proc) -> None:
        """Forward the child's stderr (its library output too: the worker
        moves descriptor 1 onto it) to this process's descriptor 2, keeping
        the last lines for a failed spawn's message."""
        for line in proc.stderr:
            self._stderr_tail.append(line.rstrip())
            try:
                os.write(2, f"[fleet-w{self.idx}] {line}".encode())
            except OSError:
                pass
        proc.stderr.close()

    # -- protocol ----------------------------------------------------------

    def _emit(self, doc: dict) -> bool:
        proc = self.proc
        if proc is None or proc.stdin is None:
            return False
        try:
            with self._wlock:
                proc.stdin.write(json.dumps(doc, separators=(",", ":"))
                                 + "\n")
                proc.stdin.flush()
            return True
        except (OSError, ValueError):
            return False

    def send(self, req: FleetRequest) -> None:
        # a dead pipe surfaces through the reader's EOF → _worker_lost
        # re-admits this request with everything else in flight here.
        # session_slots rides inside the cfg dict as an envelope key — the
        # inner server's admission pops it before SimConfig validation
        payload = dataclasses.asdict(req.cfg)
        if req.session_slots > 1:
            payload["session_slots"] = req.session_slots
        self._emit({"op": "submit", "id": req.id, "cfg": payload})

    def send_cancel(self, rid: str) -> None:
        # the child's inner cancel answers through a fail(cancelled) frame;
        # a dead pipe resolves via _worker_lost's cancelled-orphan path
        self._emit({"op": "cancel", "id": rid})

    def _read_loop(self) -> None:
        proc = self.proc
        for line in proc.stdout:
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except ValueError:
                continue
            op = msg.get("op")
            if op == "ready":
                self.pid = msg.get("pid")
                self.leg = msg.get("leg")
                self.device = msg.get("device")
                self._ready.set()
            elif op == "reply":
                self.fleet._resolve(self, msg.get("id"),
                                    record=msg.get("record"),
                                    timing=msg.get("timing"))
            elif op == "fail":
                self.fleet._resolve(self, msg.get("id"),
                                    error=str(msg.get("error")))
            elif op == "stats":
                with self._rpc_cv:
                    self._rpc_out[msg.get("rpc")] = msg.get("stats")
                    self._rpc_cv.notify_all()
            elif op == "export":
                # migration: (fid, record-doc) pairs — rpc ids
                # are fleet-unique, so stats and exports share the map
                with self._rpc_cv:
                    self._rpc_out[msg.get("rpc")] = [
                        (d.get("id"), d.get("record"))
                        for d in msg.get("lanes") or []]
                    self._rpc_cv.notify_all()
            elif op == "bye":
                self.final_stats = msg.get("stats")
                self.fleet._absorb_worker(self.idx, self.final_stats)
                self._expect_exit = True
                self._bye.set()
        proc.stdout.close()
        if not self._expect_exit:
            self.fleet._worker_lost(self)

    def live_stats(self) -> Optional[dict]:
        """Blocking stats RPC to the child (None when dead/unresponsive —
        after a graceful shutdown the bye-frame snapshot answers instead)."""
        if not self.alive:
            return self.final_stats
        rpc = self.fleet._next_rpc()
        if not self._emit({"op": "stats", "rpc": rpc}):
            return self.final_stats
        deadline = time.monotonic() + _STATS_RPC_TIMEOUT_S
        with self._rpc_cv:
            while rpc not in self._rpc_out:
                left = deadline - time.monotonic()
                if left <= 0 or not self.alive:
                    return self._rpc_out.pop(rpc, None) or self.final_stats
                self._rpc_cv.wait(left)
            return self._rpc_out.pop(rpc)

    def export_lanes_rpc(self, fids,
                         timeout: float = _STATS_RPC_TIMEOUT_S) -> list:
        """Blocking export RPC (migration): ask the child to
        serialize the named requests' lane state at its next segment
        boundary. Returns ``(fid, record-doc)`` pairs; empty on a dead or
        unresponsive worker (the caller then just leaves the work put)."""
        if not self.alive:
            return []
        rpc = self.fleet._next_rpc()
        if not self._emit({"op": "export", "rpc": rpc, "ids": list(fids)}):
            return []
        deadline = time.monotonic() + timeout
        with self._rpc_cv:
            while rpc not in self._rpc_out:
                left = deadline - time.monotonic()
                if left <= 0 or not self.alive:
                    return self._rpc_out.pop(rpc, None) or []
                self._rpc_cv.wait(left)
            return self._rpc_out.pop(rpc)

    def import_lane(self, fid: str, doc: dict) -> None:
        """Hand a serialized LaneRecord to the child under fleet id
        ``fid`` (a dead pipe surfaces through _worker_lost, which
        re-admits the request like any other orphan)."""
        self._emit({"op": "import", "id": fid, "record": doc})

    # -- teardown ----------------------------------------------------------

    def request_shutdown(self) -> None:
        self._expect_exit = True
        self._emit({"op": "shutdown"})

    def finish_shutdown(self, timeout: float = CHAOS_TIMEOUT_S) -> None:
        if self.proc is None:
            return
        # a process that already exited (killed / crashed) will never send
        # bye — waiting the full chaos timeout for it just stalls teardown
        if self.proc.poll() is None:
            self._bye.wait(timeout)
        try:
            if self.proc.stdin is not None:
                self.proc.stdin.close()
        except OSError:
            pass
        try:
            self.proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        if self._reader is not None:
            self._reader.join(timeout=5.0)
        self.alive = False

    def kill(self) -> None:
        """Hard-kill the child (the worker-failure tests' crash lever);
        the reader's EOF then drives re-admission."""
        if self.proc is not None:
            self.proc.kill()


class _ThreadWorker(_WorkerBase):
    """An in-process worker: the same routing fabric over a plain
    :class:`ConsensusServer` with a backend of its own on its placed
    device, sharing this process's kernel libraries. Fast (no spawn, no
    JSON pipe) — the routing and stealing tests' surface."""

    def __init__(self, fleet: "FleetServer", idx: int):
        super().__init__(fleet, idx)
        self.inner: Optional[ConsensusServer] = None
        self._ids: dict = {}                # inner id -> fleet id
        self._handles: dict = {}            # fleet id -> inner handle
        self._ids_cv = threading.Condition()
        self.final_stats: Optional[dict] = None

    def start(self) -> None:
        from byzantinerandomizedconsensus_tpu_torch.backends.base import get_backend
        from byzantinerandomizedconsensus_tpu_torch.cli import backend_options

        f = self.fleet
        hook = None
        if f._segment_latency_s > 0:
            lat = f._segment_latency_s

            def hook(_msg, _sleep=time.sleep, _lat=lat):
                _sleep(_lat)

        # a backend of its own on its placed device, as a process worker
        backend = get_backend(f._backend_name, **backend_options(
            f._backend_name, f.slot(self.idx)["device"], f._kernel))
        self.inner = ConsensusServer(
            backend=backend, policy=f._policy, round_cap_ceiling=f._ceiling,
            on_reply=self._on_inner_reply, segment_hook=hook).start()
        self.alive = True
        self.pid = os.getpid()
        self.leg = self.inner.leg
        self.device = str(self.inner.device)
        _trace.event("fleet.spawn", worker=self.idx, pid=self.pid,
                     attempt=0, mode="thread")

    def send(self, req: FleetRequest) -> None:
        try:
            payload = dataclasses.asdict(req.cfg)
            if req.session_slots > 1:
                payload["session_slots"] = req.session_slots
            handle = self.inner.submit(payload)
        except Exception as e:  # noqa: BLE001 — surface as a request fail
            threading.Thread(target=self.fleet._resolve,
                             args=(self, req.id),
                             kwargs={"error": f"submit error: {e}"},
                             daemon=True).start()
            return
        with self._ids_cv:
            self._ids[handle.id] = req.id
            self._handles[req.id] = handle
            self._ids_cv.notify_all()
        # inner failures (dispatch errors) set the handle without a reply
        # callback; a per-request waiter forwards them
        threading.Thread(target=self._watch, args=(req.id, handle),
                         daemon=True).start()

    def send_cancel(self, rid: str) -> None:
        with self._ids_cv:
            handle = self._handles.get(rid)
        if handle is not None and self.inner is not None:
            # inner cancel sets error="cancelled"; _watch forwards it
            self.inner.cancel(handle.id)

    def _on_inner_reply(self, inner_req) -> None:
        with self._ids_cv:
            while inner_req.id not in self._ids:
                self._ids_cv.wait()
            fid = self._ids.pop(inner_req.id)
            self._handles.pop(fid, None)
        rec = dict(inner_req.record)
        rec["request_id"] = fid
        self.fleet._resolve(self, fid, record=rec,
                            timing=reply_timing(inner_req))

    def _watch(self, fid: str, handle) -> None:
        handle.done.wait()
        if handle.error is not None:
            with self._ids_cv:
                self._ids.pop(handle.id, None)
                self._handles.pop(fid, None)
            self.fleet._resolve(self, fid, error=handle.error)

    def export_lanes_rpc(self, fids,
                         timeout: float = _STATS_RPC_TIMEOUT_S) -> list:
        """In-process export (migration): same contract as the
        process worker's RPC — ``(fid, record-doc)`` pairs."""
        if self.inner is None:
            return []
        with self._ids_cv:
            inner = {self._handles[fid].id: fid
                     for fid in fids if fid in self._handles}
        try:
            recs = self.inner.export_lanes(list(inner), timeout=timeout)
        except Exception:  # noqa: BLE001 — an export failure just means
            recs = []      # the work stays put
        out = []
        with self._ids_cv:
            for rec in recs:
                fid = inner.get(rec.token.id)
                if fid is None:
                    continue
                self._ids.pop(rec.token.id, None)
                self._handles.pop(fid, None)
                # complete the dangling inner handle so _watch resolves
                # (the fleet treats its stale fail as already re-homed)
                rec.token.error = "migrated"
                rec.token.done.set()
                out.append((fid, rec.to_doc()))
            self._ids_cv.notify_all()
        return out

    def import_lane(self, fid: str, doc: dict) -> None:
        if self.inner is None:
            return
        from byzantinerandomizedconsensus_tpu_torch.serve import worker as _worker

        try:
            handle = _worker.import_record(self.inner, doc)
        except Exception as e:  # noqa: BLE001 — surface as a request fail
            threading.Thread(target=self.fleet._resolve,
                             args=(self, fid),
                             kwargs={"error": f"import error: {e}"},
                             daemon=True).start()
            return
        with self._ids_cv:
            self._ids[handle.id] = fid
            self._handles[fid] = handle
            self._ids_cv.notify_all()
        threading.Thread(target=self._watch, args=(fid, handle),
                         daemon=True).start()

    def live_stats(self) -> Optional[dict]:
        if self.inner is None:
            return self.final_stats
        st = self.inner.stats()
        st["worker"] = self.idx
        st["pid"] = self.pid
        st["compile_count"] = self.inner.compile_count()
        return st

    def request_shutdown(self) -> None:
        pass

    def finish_shutdown(self, timeout: float = CHAOS_TIMEOUT_S) -> None:
        if self.inner is not None:
            self.inner.shutdown(drain=True, timeout=timeout)
            self.final_stats = self.live_stats()
            self.inner = None
        self.alive = False

    def kill(self) -> None:
        raise RuntimeError("thread-mode workers cannot be killed; use "
                           "mode='process' for failure injection")


def placement(n_workers: int, device: str = "cuda") -> list:
    """Worker → device placement (``parallel/mesh.py::fleet_placement``),
    each slot with the ``device`` string its worker is started on. On the
    card the devices are counted, never opened: the parent creates no CUDA
    context. ``cuda`` spreads the workers over the visible cards (sharing
    when there are fewer cards than workers); ``cuda:i`` puts every worker
    on card i. Raises by name when no card is visible."""
    from byzantinerandomizedconsensus_tpu_torch.parallel.mesh import fleet_placement

    dev = torch.device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(
                "no CUDA device is available; the fleet's workers run on the "
                "card by default and never fall back to the CPU — pass "
                "device='cpu' for a CPU fleet")
        ids = range(count) if dev.index is None else [dev.index]
        devs = [SimpleNamespace(platform="gpu", id=i, device_kind="cuda")
                for i in ids]
    else:
        devs = [SimpleNamespace(platform=dev.type, id=0, device_kind=dev.type)]
    slots = fleet_placement(n_workers, devices=devs)
    for slot in slots:
        slot["device"] = (f"cuda:{slot['device_id']}" if dev.type == "cuda"
                          else dev.type)
    return slots


class FleetServer:
    """The sharded dispatcher. Duck-types :class:`ConsensusServer`'s
    service surface (``submit`` / ``stats`` / ``_on_reply`` / context
    manager), so ``serve_http`` and the loadgen driver run unchanged
    behind it."""

    def __init__(self, workers: int = 2, mode: str = "process",
                 backend: str = "torch", policy=None,
                 round_cap_ceiling: int = DEFAULT_ROUND_CAP_CEILING,
                 trace_dir=None, on_reply=None,
                 segment_latency_s: float = 0.0,
                 spawn_timeout_s: float = CHAOS_TIMEOUT_S,
                 spawn_retries: int = 1,
                 backoff_s: float = CHAOS_BACKOFF_S,
                 rotation_cap: Optional[int] = None,
                 rotation_queue_depth: Optional[int] = None,
                 tenant_inflight_cap: Optional[int] = None,
                 aging_s: float = 5.0,
                 max_respawns: int = 0,
                 wal_dir=None, migrate: bool = False,
                 device: str = "cuda", kernel: Optional[str] = None):
        if workers < 1:
            raise ValueError(f"workers={workers} out of range (>= 1)")
        if mode not in ("process", "thread"):
            raise ValueError(f"mode={mode!r} not in ('process', 'thread')")
        if rotation_cap is not None and rotation_cap < 1:
            raise ValueError(f"rotation_cap={rotation_cap} out of range "
                             "(>= 1, or None for unbounded)")
        self._n_workers = int(workers)
        self._mode = mode
        self._backend_name = backend
        # every worker's backend takes its placed device (a string: the
        # parent never touches the card) and this kernel (None: the
        # backend's own pick per config)
        self._device = str(device)
        self._kernel = kernel
        self._policy = (policy or _compaction.CompactionPolicy(
            width=64, segment=1)).validate()
        self._ceiling = int(round_cap_ceiling)
        self._trace_dir = trace_dir
        self._on_reply = on_reply
        self._segment_latency_s = float(segment_latency_s)
        self._spawn_timeout_s = float(spawn_timeout_s)
        self._spawn_retries = int(spawn_retries)
        self._backoff_s = float(backoff_s)
        # Work-sharing granularity: max *instance-lanes* resident per
        # rotation. None = a bucket's whole queue is one rotation. A rotation is indivisible once resident, and its
        # segment chain is ~round_cap × ceil(lanes / grid width) — so a
        # request-count bound does NOT bound the chain; a lane budget of
        # one grid wave (cap = policy width) pins it at <= round_cap
        # segments. Without any cap the heaviest bucket is one
        # indivisible unit and bounds fleet speedup at
        # 1/its-weight-share regardless of worker count.
        self._rotation_cap = rotation_cap
        # traffic bounds, same semantics as the single server:
        # total parent-side pending rotations / per-tenant outstanding
        self._rotation_queue_depth = (None if not rotation_queue_depth
                                      else int(rotation_queue_depth))
        self._tenant_cap = (None if not tenant_inflight_cap
                            else int(tenant_inflight_cap))
        self._aging_s = float(aging_s)
        self._retry_rng = random.Random(0xF1E + workers)
        self._cv = threading.Condition()
        self._workers: list = []
        self._where: dict = {}          # bucket -> worker (sticky affinity)
        self._requests: list = []
        self._byid: dict = {}           # fleet id -> unfinished FleetRequest
        self._tenant_inflight: dict = {}
        self._tenant_served: dict = {}
        self._counter = 0
        self._rpc_counter = 0
        self._submitted = 0
        self._replied = 0
        self._failed = 0
        self._cancelled_n = 0
        self._steals = 0
        # lane-level migration — an idle worker with no whole rotation to
        # steal imports *serialized lanes* from the busiest peer's
        # in-flight rotation (backends/lanestate.py), breaking the
        # indivisible-chain Amdahl cap whole-rotation stealing hits on a
        # fat-tailed backlog
        self._migrate = bool(migrate)
        self._migrations = 0
        self._lanes_migrated = 0
        self._migrating: set = set()    # worker idx with a move in flight
        self._readmitted = 0
        self._lost_workers = 0
        self._retired_n = 0
        self._stop = False
        self._started = False
        self.placement: Optional[list] = None
        # budgeted mid-stream respawns (0: a worker lost after the
        # initial ladder stays lost)
        if max_respawns < 0:
            raise ValueError(f"max_respawns={max_respawns} out of range "
                             "(>= 0)")
        self._max_respawns = int(max_respawns)
        self._respawns_used = 0
        self._respawn_terminal: Optional[str] = None
        # write-ahead admission log (durable-serving seam)
        from byzantinerandomizedconsensus_tpu_torch.serve.wal import WriteAheadLog
        self._wal = WriteAheadLog(wal_dir) if wal_dir else None
        self._recovering = False

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FleetServer":
        if self._started:
            raise RuntimeError("fleet already started")
        self._started = True
        self.placement = placement(self._n_workers, self._device)
        if self.placement[0]["platform"] == "gpu":
            # every kernel library, built here once (nvcc, no card) so no
            # worker compiles and the ready ladder never pays for it
            from byzantinerandomizedconsensus_tpu_torch.ops import _build

            _build.build()
        cls = _ProcessWorker if self._mode == "process" else _ThreadWorker
        for idx in range(self._n_workers):
            w = cls(self, idx)
            try:
                w.start()
            except BaseException:
                # a failed spawn takes the fleet down whole: the workers
                # already up are stopped, none is left behind
                self.shutdown(drain=False)
                raise
            self._workers.append(w)
        return self

    def slot(self, idx: int) -> dict:
        """Worker ``idx``'s placement; respawned and scaled-up workers carry
        indices past the initial list and inherit a slot modulo it."""
        return self.placement[idx % len(self.placement)]

    @property
    def leg(self) -> Optional[str]:
        """The leg the workers run (``"lanes"`` or ``"direct"``), as the
        first live worker reported it."""
        with self._cv:
            return next((w.leg for w in self._workers if w.leg), None)

    def __enter__(self) -> "FleetServer":
        return self if self._started else self.start()

    def __exit__(self, *exc):
        self.shutdown(drain=True)

    def _next_rpc(self) -> int:
        with self._cv:
            self._rpc_counter += 1
            return self._rpc_counter

    # -- submission & routing ----------------------------------------------

    def submit(self, payload, pin_worker: Optional[int] = None,
               _rid: Optional[str] = None) -> FleetRequest:
        """Admit a payload and route it. ``pin_worker`` bypasses affinity
        routing (the warm-up seam: the loadgen warms every bucket on every
        worker before measuring).

        Dict payloads may carry the round-18 scheduling envelope
        (``tenant``/``deadline_ms``/``priority``); a configured
        rotation-queue bound or per-tenant cap rejects with
        :class:`~byzantinerandomizedconsensus_tpu_torch.serve.admission
        .Backpressure` (HTTP 429 + Retry-After). While a WAL recovery
        replay is in progress new submits reject with the named
        ``recovering`` reason (HTTP 503 + Retry-After). ``_rid`` pins the
        request id — the recovery path replays journaled envelopes under
        their original ids, which is what keeps recovered replies
        addressable (and bit-identical) to the dead dispatcher's."""
        payload, env = _admission.envelope(payload)
        cfg = _admission.admit(payload, round_cap_ceiling=self._ceiling)
        bucket = _admission.bucket_of(cfg)
        with self._cv:
            if self._stop:
                raise RuntimeError("fleet is shutting down")
            if not self._started:
                raise RuntimeError("fleet not started")
            if self._recovering and _rid is None:
                self._backpressure_locked(
                    "recovering",
                    "WAL recovery replay in progress; new work would "
                    "interleave ahead of replayed work")
            tenant = env["tenant"]
            if self._tenant_cap is not None and \
                    self._tenant_inflight.get(tenant, 0) >= self._tenant_cap:
                self._backpressure_locked(
                    "tenant_cap",
                    f"tenant {tenant!r} is at its in-flight cap "
                    f"({self._tenant_cap})")
            if self._rotation_queue_depth is not None and \
                    sum(len(v) for w in self._workers
                        for v in w.pending.values()) \
                    >= self._rotation_queue_depth:
                # coarse overload bound: while the parent-side backlog is
                # at depth, all new work backs off (even would-be live
                # joins — under overload that is the point)
                self._backpressure_locked(
                    "overflow",
                    f"fleet rotation backlog is at its bound "
                    f"({self._rotation_queue_depth})")
            if _rid is None:
                self._counter += 1
                rid = f"f{self._counter:06d}"
            else:
                rid = _rid
            req = FleetRequest(rid, cfg, bucket,
                               tenant=tenant,
                               deadline_ms=env["deadline_ms"],
                               priority=env["priority"],
                               session_slots=env["session_slots"])
            self._requests.append(req)
            self._byid[req.id] = req
            self._tenant_inflight[tenant] = \
                self._tenant_inflight.get(tenant, 0) + 1
            self._submitted += 1
        # The WAL write sits between admission and dispatch, outside the
        # routing lock: the fsync group-commits across concurrent submits,
        # and the request is not routable until the journal entry is
        # durable. Recovery replays (_rid set) are already journaled.
        if self._wal is not None and _rid is None:
            self._wal.append_admit(req.id, dataclasses.asdict(cfg), env)
        with self._cv:
            if not req.done.is_set():    # raced with cancel()
                self._route_locked(req, pin_worker=pin_worker)
        return req

    def _backpressure_locked(self, reason: str, msg: str) -> None:
        """Named rejection + ``serve.backpressure`` event + seeded-jitter
        Retry-After hint (caller holds ``self._cv``)."""
        _admission._reject(reason)
        retry_after = round(0.05 + self._retry_rng.random() * 0.45, 3)
        _trace.event("serve.backpressure", reason=reason,
                     retry_after_s=retry_after)
        raise _admission.Backpressure(
            f"{msg}; retry after {retry_after}s",
            reason=reason, retry_after_s=retry_after)

    def _release_locked(self, req: FleetRequest) -> None:
        self._byid.pop(req.id, None)
        n = self._tenant_inflight.get(req.tenant, 0) - 1
        if n > 0:
            self._tenant_inflight[req.tenant] = n
        else:
            self._tenant_inflight.pop(req.tenant, None)

    def cancel(self, rid: str) -> dict:
        """Cancel an unfinished fleet request. Parent-side queued work is
        removed immediately; work already handed to a worker is forwarded
        as a ``cancel`` protocol op — the worker's inner server kills it
        at the feed or reclaims its lanes at the next segment boundary,
        and the resulting ``fail(cancelled)`` frame resolves the handle.
        Same ack shape as ``ConsensusServer.cancel``."""
        if _metrics.enabled():
            _metrics.counter("brc_serve_cancel_requested_total",
                             "Cancellations requested").inc()
        forward = None
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
            where = None
            for w in self._workers:
                reqs = w.pending.get(req.bucket)
                if reqs is not None and req in reqs:
                    reqs.remove(req)
                    if not reqs:
                        del w.pending[req.bucket]
                    where = "queued"
                    break
                if rid in w.inflight:
                    # stays in w.inflight until the worker's fail frame
                    # resolves it — re-admission after a worker loss must
                    # still see it (and will drop it, being cancelled)
                    where = "live"
                    forward = w
                    break
            if where is None:
                where = "queued"  # routed nowhere (all workers dead)
            if where == "queued":
                req.error = "cancelled"
                self._cancelled_n += 1
                self._release_locked(req)
                if self._wal is not None:
                    # a cancelled request must not be replayed at recovery
                    self._wal.append_done(req.id, failed=True)
                req.done.set()
            self._cv.notify_all()
        if forward is not None:
            forward.send_cancel(rid)
        if _metrics.enabled():
            _metrics.counter("brc_serve_cancelled_total",
                             "Requests cancelled before their reply",
                             where=where).inc()
        _trace.event("serve.cancel", id=rid, where=where,
                     bucket=req.bucket.label())
        return {"id": rid, "found": True, "cancelled": True, "where": where}

    def _route_locked(self, req: FleetRequest,
                      pin_worker: Optional[int] = None) -> None:
        alive = [w for w in self._workers if w.alive and not w.retiring]
        if not alive:
            self._fail_locked(req, "no live fleet workers")
            return
        affinity = False
        if pin_worker is not None:
            w = self._workers[pin_worker]
            if not w.alive or w.retiring:
                raise RuntimeError(f"pinned worker {pin_worker} is dead")
        else:
            w = self._where.get(req.bucket)
            affinity = w is not None and w.alive and not w.retiring
            if not affinity:
                # new bucket: least-loaded live worker by lane-round
                # weight (see Worker.load), ties to lowest idx — counting
                # requests instead once parked both fat-tailed buckets of
                # a burst on the same worker
                w = min(alive, key=lambda o: (o.load(), o.queued(), o.idx))
                self._where[req.bucket] = w
        _trace.event("fleet.route", id=req.id, worker=w.idx,
                     bucket=req.bucket.label(), affinity=affinity)
        cap = self._rotation_cap
        if w.current_bucket == req.bucket and (
                cap is None or pin_worker is not None
                or sum(r.cfg.instances for r in w.inflight.values())
                + req.cfg.instances <= cap):
            # mid-flight join of the live rotation (the worker's inner
            # server pushes into its active WorkFeed); a rotation at its
            # lane budget queues instead, so the overflow stays
            # stealable by idle peers. Pinned warm-up traffic bypasses
            # the budget (and dispatch chunking below): the warm-up must
            # overfill the grid so compact-refill compiles before
            # anything is measured — the cap is a steady-state
            # scheduling knob, not a warm-up one
            w.inflight[req.id] = req
            self._mark_served_locked([req])
            req.t_dispatch = time.perf_counter()
            w.send(req)
            if self._migrate:
                # a join fattens w's in-flight rotation: give fully idle
                # peers a pump pass now — with nothing stealable they may
                # slice lanes off it, instead of idling until
                # the next reply happens to pump them
                for o in self._workers:
                    if (o.alive and not o.retiring and o is not w
                            and not o.inflight
                            and o.current_bucket is None
                            and not o.pending):
                        self._pump_locked(o)
        elif w.current_bucket is None and not w.pending:
            self._dispatch_locked(w, req.bucket, [req])
        else:
            w.pending.setdefault(req.bucket, []).append(req)
            if pin_worker is not None:
                w.pinned.add(req.bucket)
                return
            # idle capacity must not watch rotations queue: hand any fully
            # idle peer a pump pass now (it will steal this — or an older —
            # pending rotation), not only on the reply path
            idle = next((o for o in self._workers
                         if o.alive and not o.retiring and o is not w
                         and not o.inflight
                         and o.current_bucket is None and not o.pending),
                        None)
            if idle is not None:
                self._pump_locked(idle)

    def _dispatch_locked(self, w, bucket, reqs) -> None:
        cap = self._rotation_cap
        if cap is not None and bucket not in w.pinned:
            # chunk the rotation at the lane budget, longest chains
            # first (round_cap varies within a bucket — it is traced
            # lane data, not part of the bucket key — and a chunk
            # dispatched last with the bucket's one fat member becomes
            # the whole burst's straggler). Stable sort: arrival order
            # breaks ties, and scheduling order never enters the PRF
            # draw coordinates. Always take at least one request — a
            # single request is never split. The tail stays pending
            # (and stealable — unless pinned warm-up).
            reqs = sorted(reqs, key=lambda r: -r.cfg.round_cap)
            lanes = 0
            take = len(reqs)
            for i, r in enumerate(reqs):
                if i and lanes + r.cfg.instances > cap:
                    take = i
                    break
                lanes += r.cfg.instances
            if take < len(reqs):
                w.pending.setdefault(bucket, []).extend(reqs[take:])
                reqs = reqs[:take]
        w.current_bucket = bucket
        for req in reqs:
            w.inflight[req.id] = req
        self._mark_served_locked(reqs)
        _trace.event("fleet.dispatch", worker=w.idx, bucket=bucket.label(),
                     requests=len(reqs))
        for req in reqs:
            req.t_dispatch = time.perf_counter()
            w.send(req)

    def _mark_served_locked(self, reqs) -> None:
        """Credit each request's tenant with its dispatched lane-round
        weight — the deficit side of the fairness ordering. Re-admitted
        requests (worker loss) are credited again; the bias is toward the
        unlucky tenant's *competitors*, which only errs safe."""
        for req in reqs:
            w = (int(req.cfg.round_cap) * int(req.cfg.instances)
                 * req.session_slots)
            self._tenant_served[req.tenant] = \
                self._tenant_served.get(req.tenant, 0) + w
            if _metrics.enabled():
                _metrics.counter(
                    "brc_serve_tenant_served_weight_total",
                    "Lane-round weight dispatched, by tenant",
                    tenant=req.tenant).inc(w)

    # -- reply / steal path ------------------------------------------------

    def _resolve(self, w, fid: str, record: Optional[dict] = None,
                 error: Optional[str] = None,
                 timing: Optional[dict] = None) -> None:
        """A worker answered (reply or fail) for fleet request ``fid``;
        called from reader / inner-dispatcher threads."""
        if error == "migrated":
            # migration: the victim's handle for an exported request
            # completes with this named error so its failure watcher never
            # stalls — but the request itself is mid-migration (the
            # migration thread re-homes it under the fleet lock), so this
            # frame must never pop it from the victim's inflight map
            return
        with self._cv:
            req = w.inflight.pop(fid, None)
            if req is None:
                return  # stale: already re-admitted elsewhere
            self._release_locked(req)
            if record is not None and not req.cancelled:
                req.t_reply = time.perf_counter()
                req.worker_timing = timing
                req.record = record
                self._replied += 1
                w.replied += 1
            elif req.cancelled:
                # a forwarded cancel coming home (fail frame, or a reply
                # that raced the cancel and lost): counted at cancel()
                req.error = "cancelled"
                self._cancelled_n += 1
            else:
                req.error = error or "worker error"
                self._failed += 1
            if not w.inflight:
                w.current_bucket = None
                self._pump_locked(w)
            # Every reply is a steal opportunity. A fully idle peer only
            # attempts a steal at the instant its own inflight empties; if
            # the victim's backlog was all in flight at that moment, the
            # peer would idle forever while the victim serially drains its
            # chunked rotations.
            for o in self._workers:
                if (o.alive and not o.retiring and o is not w
                        and not o.inflight and o.current_bucket is None):
                    self._pump_locked(o)
            cb = self._on_reply
            self._cv.notify_all()
        if self._wal is not None:
            # journal the completion BEFORE waking waiters: anyone who saw
            # this reply must never see the request replayed at recovery
            self._wal.append_done(req.id, failed=req.record is None)
        req.done.set()
        if req.record is not None and cb is not None:
            cb(req)

    @staticmethod
    def _chain_locked(reqs) -> tuple:
        """LPT weight of a pending rotation: its segment chain is bounded
        by the longest member round_cap (a rotation is indivisible once
        resident, so dispatching long chains first keeps the end-game
        straggler short — classic longest-processing-time packing). A
        session's chain is its cap times its slot count (spec §11)."""
        return (max(r.cfg.round_cap * r.session_slots for r in reqs),
                sum(r.cfg.instances for r in reqs))

    def _rotation_key_locked(self, bucket, reqs) -> tuple:
        """Pending-rotation pick order: EDF urgency (deadline,
        or ``t_submit + aging_s`` — priority shifts by aging windows),
        quantized to 100 ms so near-ties fall to the tenant deficit, then
        the pre-18 LPT chain weight (negated: longest chain first)."""
        urgency = min((r.t_deadline if r.t_deadline is not None
                       else r.t_submit + self._aging_s)
                      - r.priority * self._aging_s for r in reqs)
        deficit = min(self._tenant_served.get(r.tenant, 0) for r in reqs)
        chain = self._chain_locked(reqs)
        return (round(urgency, 1), deficit, -chain[0], -chain[1],
                bucket.label())

    def _pump_locked(self, w) -> None:
        """An idle worker takes its own most urgent (EDF; LPT among ties)
        pending rotation, else steals the most urgent rotation from the
        live peer with the heaviest stealable backlog (lane-round weight,
        see Worker.load). A retiring worker neither pumps nor steals — it
        only drains what it already holds."""
        if not w.alive or w.retiring:
            return
        if w.pending:
            bucket = min(w.pending,
                         key=lambda b: self._rotation_key_locked(
                             b, w.pending[b]))
            reqs = w.pending.pop(bucket)
            self._dispatch_locked(w, bucket, reqs)
            if bucket not in w.pending:
                # fully drained (no chunked tail left behind): the
                # warm-up pin has served its purpose
                w.pinned.discard(bucket)
            return

        def stealable(o):
            return [b for b in o.pending if b not in o.pinned]

        victims = [o for o in self._workers
                   if o.alive and o is not w and stealable(o)]
        if not victims:
            if self._migrate:
                # no whole rotation to steal anywhere: slice lanes off the
                # busiest peer's in-flight rotation instead
                self._migrate_locked(w)
            return

        def backlog(o):
            # stealable lane-round weight only: inflight and pinned work
            # cannot move, so it must not make a peer look "busiest"
            return sum(r.cfg.round_cap * r.cfg.instances * r.session_slots
                       for b in stealable(o) for r in o.pending[b])

        victim = max(victims, key=lambda o: (backlog(o), -o.idx))
        bucket = min(stealable(victim),   # most urgent stealable rotation
                     key=lambda b: self._rotation_key_locked(
                         b, victim.pending[b]))
        reqs = victim.pending.pop(bucket)
        self._where[bucket] = w
        w.steals += 1
        self._steals += 1
        _metrics.counter("brc_fleet_steals_total",
                         "Pending rotations stolen by idle workers").inc()
        _trace.event("fleet.steal", worker=w.idx, victim=victim.idx,
                     bucket=bucket.label(), requests=len(reqs))
        self._dispatch_locked(w, bucket, reqs)

    # -- lane migration ---------------------------------------------------

    def _migrate_locked(self, thief) -> None:
        """Plan a lane-level migration onto idle worker ``thief`` (caller
        holds ``self._cv``): pick the busiest peer with more than one
        migratable in-flight request (sessions never move — spec §11; a
        single request is never split off either, its owner would just go
        idle in turn) and hand roughly half its lane-round weight,
        heaviest requests first, to a background thread — the export RPC
        blocks on the victim's next segment boundary and must not hold
        the routing lock."""
        if self._stop or thief.idx in self._migrating:
            return

        def migratable(o):
            return [r for r in o.inflight.values()
                    if not r.cancelled and r.session_slots == 1]

        victims = [o for o in self._workers
                   if o.alive and not o.retiring and o is not thief
                   and o.idx not in self._migrating
                   and len(migratable(o)) > 1]
        if not victims:
            return
        victim = max(victims, key=lambda o: (o.load(), -o.idx))
        cand = sorted(migratable(victim),
                      key=lambda r: (-(r.cfg.round_cap * r.cfg.instances),
                                     r.id))
        target = sum(r.cfg.round_cap * r.cfg.instances for r in cand) // 2
        take, weight = [], 0
        for r in cand[:-1]:    # always leave the victim at least one
            if weight >= target:
                break
            take.append(r)
            weight += r.cfg.round_cap * r.cfg.instances
        if not take:
            return
        self._migrating.add(thief.idx)
        self._migrating.add(victim.idx)
        threading.Thread(
            target=self._migrate_async,
            args=(thief, victim, [r.id for r in take]),
            name=f"fleet-migrate-w{victim.idx}-w{thief.idx}",
            daemon=True).start()

    def _migrate_async(self, thief, victim, fids) -> None:
        """Execute a planned migration: export the named requests' lane
        state from the victim (blocking RPC, outside the fleet lock),
        re-home each exported request to the thief under its fleet id,
        then ship the records over as ``import`` ops. A request that
        retired, cancelled, or got orphaned while the export was in
        flight resolves through its ordinary path and is skipped here."""
        try:
            pairs = victim.export_lanes_rpc(fids)
        except Exception:  # noqa: BLE001 — a failed export leaves the
            pairs = []     # work on the victim; nothing is lost
        moved, lanes = [], 0
        with self._cv:
            self._migrating.discard(thief.idx)
            self._migrating.discard(victim.idx)
            for fid, doc in pairs:
                req = victim.inflight.pop(fid, None)
                if req is None:
                    continue   # resolved while the export was in flight
                if req.cancelled:
                    # a forwarded cancel raced the export: the victim can
                    # no longer answer it, so complete it here (the same
                    # closure _worker_lost applies to cancelled orphans)
                    req.error = "cancelled"
                    self._cancelled_n += 1
                    self._release_locked(req)
                    if self._wal is not None:
                        self._wal.append_done(req.id, failed=True)
                    req.done.set()
                    continue
                if not thief.alive or thief.retiring:
                    self._route_locked(req)   # re-admit like any orphan
                    continue
                thief.inflight[fid] = req
                moved.append((fid, doc, req))
                try:
                    lanes += int(doc["lanes"]["pos"]["shape"][0])
                except (KeyError, TypeError, IndexError):
                    pass
            if moved:
                if thief.current_bucket is None:
                    thief.current_bucket = moved[0][2].bucket
                self._where[moved[0][2].bucket] = thief
                thief.steals += 1
                self._migrations += 1
                self._lanes_migrated += lanes
                _metrics.counter(
                    "brc_lane_migrated_total",
                    "Lanes moved between workers as serialized records"
                ).inc(lanes)
                _trace.event("fleet.migrate", thief=thief.idx,
                             victim=victim.idx, requests=len(moved),
                             lanes=lanes)
            if not victim.inflight:
                victim.current_bucket = None
                self._pump_locked(victim)
            self._cv.notify_all()
        for fid, doc, _req in moved:
            thief.import_lane(fid, doc)

    # -- failure path ------------------------------------------------------

    def _worker_lost(self, w) -> None:
        """A worker's pipe hit EOF without a shutdown handshake: mark it
        dead and re-admit every orphaned request to the survivors (same
        fleet ids — replies stay bit-identical)."""
        with self._cv:
            if not w.alive:
                return
            w.alive = False
            self._lost_workers += 1
            _metrics.counter("brc_fleet_workers_lost_total",
                             "Workers lost without a shutdown handshake"
                             ).inc()
            orphans = []
            if w.inflight:
                orphans.append((w.current_bucket or
                                next(iter(w.inflight.values())).bucket,
                                list(w.inflight.values())))
            w.inflight.clear()
            w.current_bucket = None
            for bucket, reqs in w.pending.items():
                orphans.append((bucket, reqs))
            w.pending.clear()
            w.pinned.clear()
            for bucket in [b for b, o in self._where.items() if o is w]:
                del self._where[bucket]
            n_orphans = sum(len(r) for _, r in orphans)
            _trace.event("fleet.worker_lost", worker=w.idx, pid=w.pid,
                         orphans=n_orphans)
            survivors = [o for o in self._workers
                         if o.alive and not o.retiring]
            if not survivors:
                for _, reqs in orphans:
                    for req in reqs:
                        self._fail_locked(req, "all fleet workers lost")
            else:
                for bucket, reqs in orphans:
                    _trace.event("fleet.readmit", worker=w.idx,
                                 bucket=bucket.label() if bucket else None,
                                 requests=len(reqs))
                    for req in reqs:
                        if req.cancelled:
                            # a forwarded cancel orphaned by the loss:
                            # complete it here instead of re-admitting
                            req.error = "cancelled"
                            self._cancelled_n += 1
                            self._release_locked(req)
                            if self._wal is not None:
                                self._wal.append_done(req.id, failed=True)
                            req.done.set()
                            continue
                        self._readmitted += 1
                        _metrics.counter(
                            "brc_fleet_readmitted_total",
                            "Orphaned requests re-admitted to survivors"
                        ).inc()
                        self._route_locked(req)
            # budgeted mid-stream respawn: replace the lost
            # worker with a fresh one after exponential backoff — or, once
            # the budget is spent, land in a NAMED terminal state instead
            # of silent permanent loss
            if self._max_respawns > 0 and not self._stop:
                if self._respawns_used < self._max_respawns:
                    self._respawns_used += 1
                    attempt = self._respawns_used
                    delay = self._backoff_s * (2 ** (attempt - 1))
                    _trace.event("fleet.respawn", lost_worker=w.idx,
                                 attempt=attempt,
                                 budget=self._max_respawns, delay_s=delay)
                    threading.Thread(
                        target=self._respawn, args=(delay, w),
                        name=f"fleet-respawn-{attempt}",
                        daemon=True).start()
                elif self._respawn_terminal is None:
                    self._respawn_terminal = "respawn_budget_exhausted"
            self._cv.notify_all()

    def _respawn(self, delay: float, lost) -> None:
        """Replace a lost worker: back off, spawn through the same ladder
        as the initial fleet, then join the routing fabric and pump. The
        crashed worker is marked ``replaced`` so health goes green again;
        a failed replacement spawn lands in the named terminal state."""
        time.sleep(delay)
        with self._cv:
            if self._stop:
                return
            idx = len(self._workers)
        cls = _ProcessWorker if self._mode == "process" else _ThreadWorker
        w = cls(self, idx)
        try:
            w.start()
        except RuntimeError:
            with self._cv:
                self._respawn_terminal = "respawn_budget_exhausted"
                self._cv.notify_all()
            return
        _metrics.counter("brc_fleet_respawns_total",
                         "Worker spawn retries (backoff ladder)").inc()
        with self._cv:
            lost.replaced = True
            self._workers.append(w)
            self._pump_locked(w)
            self._cv.notify_all()

    def _fail_locked(self, req: FleetRequest, why: str) -> None:
        req.error = why
        self._failed += 1
        self._release_locked(req)
        _metrics.counter("brc_serve_failed_total",
                         "Requests failed after admission").inc()
        if self._wal is not None:
            self._wal.append_done(req.id, failed=True)
        req.done.set()

    # -- elasticity --------------------------------------------------------

    def scale_up(self) -> int:
        """Spawn one extra worker through the same ready-or-timeout /
        backoff ladder as the initial fleet and join it to the routing
        fabric (it immediately pumps — i.e. steals — from the backlog).
        Returns the new worker index. The new worker pays its own warm-up
        (its kernel libraries load once in its process), exactly as an
        initial worker does."""
        with self._cv:
            if not self._started or self._stop:
                raise RuntimeError("fleet not running")
            idx = len(self._workers)
        cls = _ProcessWorker if self._mode == "process" else _ThreadWorker
        w = cls(self, idx)
        w.start()   # outside the lock: the ladder can take seconds
        with self._cv:
            self._workers.append(w)
            self._pump_locked(w)
            self._cv.notify_all()
        return idx

    def scale_down(self, idx: Optional[int] = None) -> Optional[int]:
        """Gracefully retire one worker (the least-loaded routable one,
        or ``idx``). The worker is marked **retiring** — excluded from
        routing and stealing, never reported dead — its parent-side queue
        re-admits to the survivors through the same path a crash uses
        (same fleet ids, so replies stay bit-identical), and once its
        in-flight rotation drains it leaves through the graceful shutdown
        handshake. Returns the retired index, or None when only one
        routable worker remains (the fleet never scales to zero)."""
        with self._cv:
            routable = [w for w in self._workers
                        if w.alive and not w.retiring]
            if len(routable) <= 1:
                return None
            if idx is None:
                # least loaded; ties to the HIGHEST index so a fleet that
                # scaled up and back down returns to its original shape
                w = min(routable, key=lambda o: (o.load(), o.queued(),
                                                 -o.idx))
            else:
                w = self._workers[idx]
                if not w.alive or w.retiring:
                    return None
            w.retiring = True
            self._retired_n += 1
            _metrics.counter(
                "brc_fleet_retired_total",
                "Workers gracefully retired by scale-down").inc()
            orphans = list(w.pending.items())
            w.pending.clear()
            w.pinned.clear()
            for bucket in [b for b, o in self._where.items() if o is w]:
                del self._where[bucket]
            _trace.event("fleet.retire", worker=w.idx,
                         inflight=len(w.inflight),
                         orphans=sum(len(r) for _, r in orphans))
            for bucket, reqs in orphans:
                _trace.event("fleet.readmit", worker=w.idx,
                             bucket=bucket.label(), requests=len(reqs))
                for req in reqs:
                    if req.cancelled:
                        continue
                    self._readmitted += 1
                    _metrics.counter(
                        "brc_fleet_readmitted_total",
                        "Orphaned requests re-admitted to survivors").inc()
                    self._route_locked(req)
            self._cv.notify_all()
        threading.Thread(target=self._finish_retire, args=(w,),
                         name=f"fleet-retire-w{w.idx}", daemon=True).start()
        return w.idx

    def _finish_retire(self, w) -> None:
        """Drain-then-leave for a retiring worker: wait for its in-flight
        rotation to resolve, then run the graceful shutdown handshake —
        the ``bye`` path, so ``_worker_lost`` (and the lost-worker
        counter, and the ``dead_workers`` health row) never fires."""
        with self._cv:
            while w.inflight and w.alive and not self._stop:
                self._cv.wait(timeout=1.0)
            if not w.alive or self._stop:
                return   # crashed mid-drain (handled as a loss) or torn
                         # down by shutdown(), which owns the handshake
        w.request_shutdown()
        w.finish_shutdown()
        with self._cv:
            w.retired = True
            self._cv.notify_all()

    # -- teardown ----------------------------------------------------------

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop the fleet. ``drain=True`` (the ``with`` semantics) waits
        for every outstanding request, then hands each worker a graceful
        shutdown (child drains and answers ``bye`` with its final stats).
        ``drain=False`` fails parent-side queued rotations first."""
        with self._cv:
            if not self._started:
                return
            self._stop = True
            if not drain:
                for w in self._workers:
                    for reqs in w.pending.values():
                        for req in reqs:
                            self._fail_locked(
                                req, "fleet shutdown before dispatch")
                    w.pending.clear()
            handles = list(self._requests)
        if drain:
            deadline = (time.monotonic() + timeout) if timeout else None
            for req in handles:
                left = None
                if deadline is not None:
                    left = max(0.0, deadline - time.monotonic())
                req.done.wait(left)
        for w in self._workers:
            w.request_shutdown()
        for w in self._workers:
            w.finish_shutdown()
        _trace.event("fleet.shutdown", submitted=self._submitted,
                     replied=self._replied, failed=self._failed,
                     steals=self._steals, readmitted=self._readmitted,
                     lost_workers=self._lost_workers,
                     retired=self._retired_n)
        if self._wal is not None:
            self._wal.close()

    # -- WAL recovery ------------------------------------------------------

    @property
    def recovering(self) -> bool:
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
        is empty. ``on_submitted`` and ``on_admitted`` are the hooks of
        ``ConsensusServer.recover`` (``cli serve --recover`` opens its HTTP
        plane once every owed id is registered)."""
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

    def _absorb_worker(self, idx: int, st: Optional[dict]) -> None:
        """Fold a worker's shipped registry snapshot into the parent's
        (labeled per worker — the fleet ``/metrics`` federation seam)."""
        if st and _metrics.enabled():
            _metrics.absorb(st.get("metrics"), worker=str(idx))

    def stats(self, live: bool = True) -> dict:
        """Fleet counters + one row per worker (same row shape as the
        single-grid server's ``per_worker``, the one-shape rule).
        ``live=True`` adds each worker's own server stats (its build count,
        kernel launches and, with the census on, its ``programs`` block)
        via the stats RPC; dead/closed workers answer with their last
        snapshot. Each row names the worker's leg and device; the fleet
        says whether this process brought CUDA up (a process-mode parent
        never does)."""
        per_worker = []
        with self._cv:
            rows = [(w, w.alive, w.replied, w.steals, len(w.inflight),
                     {b.label(): len(v) for b, v in w.pending.items()},
                     w.load())
                    for w in self._workers]
            out = {
                "mode": self._mode,
                "workers": sum(1 for w in self._workers
                               if not w.retired and not w.replaced),
                "alive": sum(1 for w in self._workers if w.alive),
                # workers new admissions can route to (alive, not draining
                # toward retirement) — the autoscaler's denominator
                "routable": sum(1 for w in self._workers
                                if w.alive and not w.retiring),
                "submitted": self._submitted,
                "replied": self._replied,
                "failed": self._failed,
                "cancelled": self._cancelled_n,
                "recovering": self._recovering,
                "steals": self._steals,
                "migrations": self._migrations,
                "lanes_migrated": self._lanes_migrated,
                "readmitted": self._readmitted,
                "lost_workers": self._lost_workers,
                "retired_workers": self._retired_n,
                "respawns": {"budget": self._max_respawns,
                             "used": self._respawns_used,
                             "terminal": self._respawn_terminal},
                "policy": self._policy.doc(),
                "round_cap_ceiling": self._ceiling,
                "rotation_cap": self._rotation_cap,
                "tenants": {
                    t: self._tenant_inflight.get(t, 0)
                    for t in set(self._tenant_inflight)
                    | set(self._tenant_served)},
                "bounds": {
                    "feed_depth": None,
                    "rotation_queue_depth": self._rotation_queue_depth,
                    "tenant_inflight_cap": self._tenant_cap,
                },
            }
        out["device"] = self._device
        out["kernel"] = self._kernel
        out["parent_cuda_initialized"] = torch.cuda.is_initialized()
        for w, alive, replied, steals, inflight, pending, load in rows:
            row = {"worker": w.idx, "pid": w.pid, "alive": alive,
                   "replied": replied, "steals": steals,
                   "inflight": inflight, "pending": pending, "load": load,
                   "leg": w.leg, "device": w.device}
            if live:
                server = w.live_stats()
                if server is not None:
                    row["server"] = server
                    self._absorb_worker(w.idx, server)
            per_worker.append(row)
        out["per_worker"] = per_worker
        if self.placement is not None:
            out["placement"] = self.placement
        return out

    def health(self) -> dict:
        """Liveness doc for ``GET /healthz``. A worker that crashed
        mid-stream is **dead** (the doc goes non-ok and names it — unless
        a ``max_respawns`` budget replaces it); a worker the autoscaler
        retired left through the graceful handshake and is neither dead
        nor counted, so scale-down never trips a health probe. Extra keys
        appear only when the state they report is non-empty (``retiring``
        while a drain is in progress, ``terminal`` once the respawn budget
        is exhausted)."""
        with self._cv:
            counted = [w for w in self._workers
                       if not w.retired and not w.replaced]
            dead = [w.idx for w in counted if not w.alive]
            retiring = [w.idx for w in counted if w.alive and w.retiring]
            terminal = self._respawn_terminal
        total = len(counted)
        ok = self._started and total > 0 and not dead
        out = {"ok": ok, "workers": total, "alive": total - len(dead),
               "dead_workers": dead}
        if retiring:
            out["retiring"] = retiring
        if terminal is not None:
            out["terminal"] = terminal
        return out

    def refresh_metrics(self) -> None:
        """Update fleet gauges and pull each live worker's registry
        snapshot (stats RPC) just before a ``/metrics`` render."""
        if not _metrics.enabled():
            return
        with self._cv:
            # retired / replaced workers left the fleet cleanly: their
            # per-worker gauges would read as dead rows on the dash
            rows = [(w, w.idx, w.alive, w.load(), len(w.inflight))
                    for w in self._workers
                    if not w.retired and not w.replaced]
            tenants = {t: self._tenant_inflight.get(t, 0)
                       for t in set(self._tenant_inflight)
                       | set(self._tenant_served)}
        for tenant, n in tenants.items():
            _metrics.gauge("brc_serve_tenant_inflight",
                           "Outstanding requests per tenant",
                           tenant=tenant).set(n)
        _metrics.gauge("brc_fleet_workers_alive",
                       "Live fleet workers").set(
                           sum(1 for r in rows if r[2]))
        for w, idx, alive, load, inflight in rows:
            _metrics.gauge("brc_fleet_worker_up",
                           "Per-worker liveness (1 up, 0 down)",
                           worker=str(idx)).set(1 if alive else 0)
            _metrics.gauge("brc_fleet_worker_load",
                           "Queued lane-round weight per worker "
                           "(round_cap x instances over inflight+pending)",
                           worker=str(idx)).set(load)
            _metrics.gauge("brc_fleet_worker_inflight",
                           "Requests in flight per worker",
                           worker=str(idx)).set(inflight)
            self._absorb_worker(idx, w.live_stats())

    def compile_counts(self) -> list:
        """Per-worker build counters (the per-worker zero-steady-state
        probe): each worker's ``ConsensusServer.compile_count()`` — the
        kernel libraries its process loaded on the direct leg, the lane
        grid's ``CompileCache`` compiles on the lane leg. ``None`` for an
        unresponsive worker."""
        return [(w.live_stats() or {}).get("compile_count")
                for w in self._workers]

    def compile_count(self) -> int:
        """Fleet-wide compile total (ConsensusServer duck-type)."""
        return sum(c or 0 for c in self.compile_counts())
