"""Fleet worker subprocess body (serve/fleet.py spawns these).

The port's copy of the reference ``serve/worker.py``. One worker = one
process owning one single-grid
:class:`~byzantinerandomizedconsensus_tpu_torch.serve.server.ConsensusServer`
on its placed device — its own backend instance, its own kernel libraries
(loaded once in the process, so the zero-steady-state pin holds *per
worker*: after the warm-up, ``compile_count()`` does not grow) and its own
trace sink: the worker self-enables telemetry from the ``BRC_TRACE``
environment variable under the stable role ``fleet-w<index>``, so the
merged fleet timeline can attribute events to workers by file name.

The wire protocol is JSON lines over stdin/stdout, the reference's frame
for frame:

parent → worker
    ``{"op": "submit", "id": fid, "cfg": {...SimConfig fields...}}``
    ``{"op": "cancel", "id": fid}``   (inner server.cancel — the answer
    comes back as a ``fail`` frame with error "cancelled")
    ``{"op": "export", "rpc": k, "ids": [fid, ...]}``  (serialize the named
    requests' lane state — ``server.export_lanes`` — so the fleet can
    migrate them; unknown/finished ids are skipped)
    ``{"op": "import", "id": fid, "record": {...}}``   (restore a serialized
    LaneRecord under fleet id ``fid`` — :func:`import_record`; the reply
    streams back as usual)
    ``{"op": "stats", "rpc": k}``
    ``{"op": "shutdown"}``

worker → parent
    ``{"op": "ready", "pid": p, "worker": i, ...}``   (backend is live; the
    port adds the server's ``leg``, ``device`` and ``kernel``)
    ``{"op": "reply", "id": fid, "record": {...}, "timing": {...}}``
    (streamed at retire; the port adds the worker's ``queue_s`` and
    ``service_s``)
    ``{"op": "fail", "id": fid, "error": "..."}``
    ``{"op": "export", "rpc": k, "lanes": [{"id": fid, "record": ...}]}``
    ``{"op": "stats", "rpc": k, "stats": {...}}``
    ``{"op": "bye", "stats": {...}}``            (drained; about to exit)

Replies carry the *fleet* request id (the parent's ``id``), so a request
re-admitted to a different worker after a failure keeps its identity.

The protocol owns the process's original descriptor 1. The port's kernels
are ctypes libraries on the CUDA runtime, and anything they or the runtime
write to descriptor 1 would tear a frame: so the fleet starts a worker
through :data:`BOOTSTRAP`, which duplicates descriptor 1 for the protocol
and puts the stderr descriptor over 1 before torch or any library loads.
``python -m byzantinerandomizedconsensus_tpu_torch.serve.worker`` also
works, and moves the descriptors first thing in :func:`main` (the package
has loaded torch by then, but no kernel library).

A worker placed on ``cuda:i`` checks that the card exists before anything
else and, if not, exits non-zero naming the device, without a ``ready``
frame: the fleet reports a failed spawn, never a CPU worker.

``--segment-latency-s`` is the reference's fabric stub: a synthetic
per-segment delay through the server's ``segment_hook`` (never in the
simulation math — replies stay bit-identical).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import queue
import signal
import sys
import threading
import time

#: How the fleet starts a worker: ``python -c BOOTSTRAP <worker options>``.
#: The protocol descriptor is set aside before the package (and torch) is
#: imported, so no library can write into the protocol pipe.
BOOTSTRAP = ("import os, sys; fd = os.dup(1); os.dup2(2, 1); "
             "from byzantinerandomizedconsensus_tpu_torch.serve.worker import main; "
             "sys.exit(main(sys.argv[1:], protocol_fd=fd))")

#: Exit code of a worker whose placed device does not exist.
EXIT_NO_DEVICE = 3


def _protocol_writer(stream):
    """A locked line emitter; the only writer to the protocol stream."""
    lock = threading.Lock()

    def emit(doc: dict) -> None:
        with lock:
            stream.write(json.dumps(doc, separators=(",", ":")) + "\n")
            stream.flush()

    return emit


def import_record(server, doc):
    """Admit one serialized LaneRecord on ``server`` and return its handle.
    On the lane leg it resumes through ``server.import_lanes``. The direct
    leg runs whole requests and cannot resume lanes; there a record none of
    whose instances has run (all pending, no live lane: what the direct leg
    exports) is admitted as its config afresh, which is bit-identical since
    every lane is a pure function of (key, instance id). Any other record
    raises ``ValueError`` by name."""
    if server.leg == "lanes":
        return server.import_lanes([doc])[0]
    from byzantinerandomizedconsensus_tpu_torch.backends import lanestate as _lanestate

    rec = (doc if isinstance(doc, _lanestate.LaneRecord)
           else _lanestate.LaneRecord.from_doc(doc))
    full = [int(i) for i in server._backend._resolve_inst_ids(rec.cfg, None)]
    started = len(rec.lanes["pos"]) > 0 or [int(i) for _, i in rec.pending] != full
    if started:
        raise ValueError(
            "this record has lanes in flight; the direct leg (kernel "
            f"{getattr(server._backend, 'kernel', None)!r}) runs whole "
            "requests and resumes no lane — import it on a kernel='plain' "
            "worker")
    return server.submit(dataclasses.asdict(rec.cfg))


def _check_device(device: str) -> str | None:
    """Why ``device`` cannot be served on, or None when it can."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    if not torch.cuda.is_available():
        return f"device {device} is not available: no CUDA device is visible"
    index = 0 if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        return (f"device {device} is not available: {torch.cuda.device_count()} "
                "CUDA device(s) visible")
    return None


def main(argv=None, protocol_fd: int | None = None) -> int:
    if protocol_fd is None:
        # started with -m: set the protocol descriptor aside now
        sys.stdout.flush()
        protocol_fd = os.dup(1)
        os.dup2(2, 1)
    proto = os.fdopen(protocol_fd, "w", buffering=1, encoding="utf-8")
    # Python-level prints go to stderr too; descriptor 1 already does
    sys.stdout = sys.stderr
    emit = _protocol_writer(proto)
    # the parent owns the lifecycle (shutdown frame, or EOF on stdin): a
    # terminal's Ctrl-C reaches the parent, which drains its workers
    signal.signal(signal.SIGINT, signal.SIG_IGN)

    ap = argparse.ArgumentParser(prog="byzantinerandomizedconsensus_tpu_torch fleet-worker")
    ap.add_argument("--index", type=int, required=True)
    ap.add_argument("--backend", default="torch")
    ap.add_argument("--device", required=True,
                    help="the placement's device (cuda:i or cpu), explicit")
    ap.add_argument("--kernel", choices=("fused", "step", "plain"), default=None)
    ap.add_argument("--policy", default="width=64,segment=1")
    ap.add_argument("--round-cap-ceiling", type=int, default=128)
    ap.add_argument("--segment-latency-s", type=float, default=0.0)
    ap.add_argument("--placement", default=None,
                    help="JSON placement doc from serve/fleet.py::placement "
                         "(recorded in stats)")
    args = ap.parse_args(argv)

    why = _check_device(args.device)
    if why is not None:
        print(f"fleet worker {args.index}: {why}; a worker serves on its "
              "placed card or not at all", file=sys.stderr, flush=True)
        return EXIT_NO_DEVICE

    import torch

    from byzantinerandomizedconsensus_tpu_torch.backends.base import get_backend
    from byzantinerandomizedconsensus_tpu_torch.backends.compaction import CompactionPolicy
    from byzantinerandomizedconsensus_tpu_torch.cli import backend_options
    from byzantinerandomizedconsensus_tpu_torch.obs import metrics as _metrics
    from byzantinerandomizedconsensus_tpu_torch.obs import programs as _programs
    from byzantinerandomizedconsensus_tpu_torch.obs import trace as _trace
    from byzantinerandomizedconsensus_tpu_torch.ops import _build, fused_round, keys_step, urn_step
    from byzantinerandomizedconsensus_tpu_torch.serve.fleet import reply_timing
    from byzantinerandomizedconsensus_tpu_torch.serve.server import ConsensusServer

    # Per-worker trace sink under the parent's BRC_TRACE dir, with a stable
    # role so follow/merge can name workers.
    out_dir = os.environ.get(_trace.TRACE_ENV)
    if out_dir:
        _trace.configure(out_dir=out_dir, role=f"fleet-w{args.index}")
    # Same self-enable discipline for the metrics plane and the census: the
    # parent sets BRC_METRICS / BRC_PROGRAMS, the worker's snapshot rides
    # every stats/bye frame. (The reference also enables its persistent XLA
    # compile cache here; the port compiles no XLA program — its kernel
    # libraries are built once, by the fleet parent, before any spawn.)
    _metrics.maybe_enable_from_env()
    _programs.maybe_enable_from_env()

    backend = get_backend(args.backend, **backend_options(
        args.backend, args.device, args.kernel))
    placement = json.loads(args.placement) if args.placement else None
    policy = CompactionPolicy.parse(args.policy)
    hook = None
    if args.segment_latency_s > 0:
        lat = float(args.segment_latency_s)

        def hook(_msg, _sleep=time.sleep, _lat=lat):
            _sleep(_lat)

    # inner request id -> fleet id; a reply can retire before submit()
    # returns to the reader loop, so the retire callback waits for the
    # mapping under this condition instead of racing it.
    ids: dict = {}
    ids_cv = threading.Condition()
    handles: dict = {}  # fleet id -> inner handle (the cancel-op map)
    watch: "queue.Queue" = queue.Queue()

    def on_reply(req) -> None:
        with ids_cv:
            while req.id not in ids:
                ids_cv.wait()
            fid = ids.pop(req.id)
            handles.pop(fid, None)
        rec = dict(req.record)
        rec["request_id"] = fid
        emit({"op": "reply", "id": fid, "record": rec,
              "timing": reply_timing(req)})

    server = ConsensusServer(backend=backend, policy=policy,
                             round_cap_ceiling=args.round_cap_ceiling,
                             on_reply=on_reply, segment_hook=hook)

    def watch_failures() -> None:
        # on_reply only fires for successful retirements; a dispatch-error
        # _fail sets the handle's error without a callback. This thread
        # turns those into protocol "fail" frames (order is irrelevant —
        # failures are rare and the parent matches by id).
        while True:
            item = watch.get()
            if item is None:
                return
            fid, handle = item
            handle.done.wait()
            if handle.error is not None:
                emit({"op": "fail", "id": fid, "error": handle.error})

    watcher = threading.Thread(target=watch_failures,
                               name=f"fleet-w{args.index}-watch", daemon=True)

    def worker_stats() -> dict:
        st = server.stats()
        st["worker"] = args.index
        st["pid"] = os.getpid()
        st["kernel"] = getattr(backend, "kernel", None)
        # the zero-steady-state probe, and what it counts on this leg
        st["compile_count"] = server.compile_count()
        st["libraries_loaded"] = _build.libraries_in_process()
        st["launches"] = {"fused_round": fused_round.launches,
                          "keys_step": keys_step.launches,
                          "urn_step": urn_step.launches}
        if server.device.type == "cuda":
            # torch's own allocations in this worker, and the card as a
            # whole (every process's contexts and allocations)
            free, total = torch.cuda.mem_get_info(server.device)
            st["device_name"] = torch.cuda.get_device_name(server.device)
            st["cuda_memory"] = {
                "allocated_bytes": torch.cuda.memory_allocated(server.device),
                "reserved_bytes": torch.cuda.memory_reserved(server.device),
                "max_allocated_bytes": torch.cuda.max_memory_allocated(server.device),
                "device_used_bytes": total - free, "device_total_bytes": total}
        if placement is not None:
            st["placement"] = placement
        if _programs.enabled():
            st["programs"] = _programs.current().block()
        if _metrics.enabled():
            # gauges are scrape-time state; refresh before snapshotting so
            # the parent's /metrics shows this worker as of this frame
            server.refresh_metrics()
            st["metrics"] = _metrics.snapshot()
        return st

    with server:
        watcher.start()
        emit({"op": "ready", "pid": os.getpid(), "worker": args.index,
              "leg": server.leg, "device": str(server.device),
              "kernel": getattr(backend, "kernel", None)})
        graceful = False
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except ValueError:
                continue  # torn frame: the parent never half-writes; skip
            op = msg.get("op")
            if op == "submit":
                fid = msg.get("id")
                try:
                    handle = server.submit(msg.get("cfg") or {})
                except Exception as e:  # noqa: BLE001 — report, don't die
                    emit({"op": "fail", "id": fid,
                          "error": f"admission/submit error: {e}"})
                    continue
                with ids_cv:
                    ids[handle.id] = fid
                    handles[fid] = handle
                    ids_cv.notify_all()
                watch.put((fid, handle))
            elif op == "cancel":
                with ids_cv:
                    handle = handles.get(msg.get("id"))
                if handle is not None:
                    # cancel sets error="cancelled" + done; the watcher
                    # thread then emits the fail frame the parent expects
                    server.cancel(handle.id)
            elif op == "export":
                # migration: serialize the named requests' lane state at
                # the grid's next segment boundary (queued ones at once). A
                # request that retires while the extract is in flight is
                # simply absent from the reply (its own reply frame answers
                # it).
                fids = msg.get("ids") or []
                with ids_cv:
                    inner = {handles[fid].id: fid
                             for fid in fids if fid in handles}
                try:
                    recs = server.export_lanes(list(inner))
                except Exception:  # noqa: BLE001 — report empty, don't die
                    recs = []
                lanes = []
                with ids_cv:
                    for rec in recs:
                        fid = inner.get(rec.token.id)
                        if fid is None:
                            continue
                        ids.pop(rec.token.id, None)
                        handles.pop(fid, None)
                        # complete the dangling handle so the (serial)
                        # failure watcher never stalls on it; the parent
                        # treats the resulting fail frame as stale
                        rec.token.error = "migrated"
                        rec.token.done.set()
                        lanes.append({"id": fid, "record": rec.to_doc()})
                    ids_cv.notify_all()
                emit({"op": "export", "rpc": msg.get("rpc"),
                      "lanes": lanes})
            elif op == "import":
                fid = msg.get("id")
                try:
                    handle = import_record(server, msg.get("record"))
                except Exception as e:  # noqa: BLE001 — report, don't die
                    emit({"op": "fail", "id": fid,
                          "error": f"import error: {e}"})
                    continue
                with ids_cv:
                    ids[handle.id] = fid
                    handles[fid] = handle
                    ids_cv.notify_all()
                watch.put((fid, handle))
            elif op == "stats":
                emit({"op": "stats", "rpc": msg.get("rpc"),
                      "stats": worker_stats()})
            elif op == "shutdown":
                graceful = True
                break
        # context exit drains: every queued request completes (or fails
        # through the watcher) before the bye frame.
        server.shutdown(drain=graceful)
    watch.put(None)
    if graceful:
        emit({"op": "bye", "stats": worker_stats()})
    _trace.disable()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
