"""Hostile-load suite for the consensus service.

The port's copy of the reference ``tools/hostile.py``: the same scenarios,
the same seeded populations (a pure function of ``(suite seed, scenario
index)``, draw for draw), the same gates and exit ladder. Each scenario
runs against its own server on ``--device`` (the card by default) through
``--backend``/``--kernel``, the leg following the kernel as in ``cli
serve``: with no kernel named on the card the **direct leg** (one
``backend.run`` per request through the kernels by law), with ``--kernel
plain`` (and always on the CPU) the **lane leg**. Every reply is held
against the per-config run of the plain round driver on the same device
(``kernel="plain"``), bit for bit. "Compiles" below are builds: kernel
libraries loaded on the direct leg, lane programs on the lane leg
(``ConsensusServer.compile_count``). The preempt family parks lanes, so
it needs the lane leg and refuses another by name; on the direct leg a
cancel of a running request drops its reply at retirement (``where:
"live"``).

``flash_crowd``
    A synchronized burst of same-bucket clients against a **bounded**
    server (``feed_depth``/``rotation_queue_depth``) over live HTTP. The
    crowd is larger than the bounds on purpose: clients must see real
    **429 + Retry-After** answers, honor the hint, and retry until
    accepted. Gate: at least one named ``overflow`` rejection (exit 6 if
    backpressure was never demonstrated) and every eventually-accepted
    request replied bit-identically.
``heavy_tail``
    A mixed population carrying the round-18 request envelope —
    ``deadline_ms`` and ``priority`` scheduling hints — so the EDF
    rotation order is exercised; the recorded ``deadline_hit_rate`` is
    the suite's deadline-scheduling witness.
``bucket_churn``
    Requests round-robined across three fused buckets: a rotation storm.
    The zero-steady-state-recompile pin must hold through every rotation
    (this is the tier-1 smoke scenario — no timing sensitivity).
``tenant_hog``
    One tenant floods the service with heavy work while an interactive
    tenant submits small deadline-carrying requests. The per-tenant
    in-flight cap plus deficit-weighted rotation ordering must keep the
    non-hog tenant's p99 inside the fairness bound (exit 4 on breach).
``cancel_storm``
    A seeded ~40% of a two-bucket burst is cancelled at staggered
    delays — some still queued (killed at the feed / pending rotation),
    some live in lanes (reclaimed at the next segment boundary). Every
    request must resolve (reply or ``cancelled``) and every *surviving*
    reply must stay bit-identical to the offline path.
``session_hog``
    Round 21: one tenant floods the service with max-weight spec-§11
    **sessions** (the ``session_slots`` envelope at heavy instance
    counts — each one a round_cap × instances × slots lane-round claim)
    while the interactive tenant submits small deadline-carrying
    requests. The deficit-weighted fairness must price the TRUE session
    weight (p99 fairness gate, exit 5 on breach via the scenario gate),
    and every hog session must bit-replay offline from its base seed
    alone (models/session.py).

Round 22 adds the **elastic** drills (:data:`ELASTIC_SCENARIOS`,
``--scenario dispatcher_kill`` / ``autoscale_crowd`` / ``elastic`` for
both) — a separate suite writing the schema-v1.13 ``elastic`` block
(the ``elastic`` record), durability and elasticity proven by
measurement, not claims:

``dispatcher_kill``
    A real ``cli serve`` subprocess with a write-ahead admission log
    (``--wal``), SIGKILLed mid-stream at a seeded point, restarted with
    ``--recover``. Every in-flight request must be replayed under its
    original request id with a reply **bit-identical** to the offline
    plain-driver reference — spec-§11 session logs included — and a submit probe
    during the replay must answer 503 ``recovering``. The drill reads
    the journal back itself (torn final line tolerated) to know exactly
    which ids a correct recovery owes it.
``autoscale_crowd``
    A flash crowd against a one-worker thread fleet with the
    metrics-driven autoscaler (serve/autoscale.py) scaling toward
    ``max_workers``, vs the same crowd against a pinned static
    one-worker fleet. Timing is sleep-dominated (``segment_latency_s``)
    so the p99 gate is about elasticity, not host speed: the elastic
    p99 must meet the SLO bound the static baseline misses (exit 5),
    scale-down must retire — not kill — workers (health stays ok,
    0 lost), and surviving-worker steady-state compiles stay 0.

Round 23 adds the **preempt** drills (:data:`PREEMPT_SCENARIOS`,
``--scenario preempt_storm`` / ``preempt``) — the serializable-lane-state
suite writing the schema-v1.14 ``lanestate`` + ``preempt`` blocks
(the ``lanestate`` and ``preempt`` record):

``preempt_storm``
    A fat-tail rotation (adaptive adversary at full fault budget, split
    init — the slowest admitted work) holds the grid when
    deadline-urgent small requests arrive. With ``--preempt`` scheduling
    the server parks the fat lanes to host (serializable LaneRecords,
    backends/lanestate.py), runs the urgent bucket, and resumes the fat
    lanes mid-round; the same traffic through the round-18 FIFO
    (non-preemptive EDF) server is the baseline. Gates: the preemptive
    deadline hit rate must beat the FIFO baseline, every reply —
    parked-and-resumed fat work included — stays bit-identical to the
    plain-driver reference AND to the FIFO leg, and steady-state compiles stay 0
    (park/restore moves pure data, never a program key).

The preempt suite also runs the **restore bit-identity grid** (every
``faults`` × adversary × delivery point, the mid-crash-window and
mid-partition captures included: export at a segment boundary, JSON wire
round-trip, import into a different server, finish — pinned identical to
the uninterrupted control), and, unless ``--smoke``, re-runs the r15
fat-tail fleet sweep (``loadgen --workers 1,2,4 --migrate``) with
lane-level migration on.

Every scenario's population is a pure function of ``(suite seed,
scenario index)``; observed counts (rejections, cancel timing splits)
are measurements, the gates are the claims. Run it::

    python -m byzantinerandomizedconsensus_tpu_torch.tools.hostile --seed 18
    python -m byzantinerandomizedconsensus_tpu_torch.cli loadgen --scenario all

``cli loadgen --scenario <name>`` delegates here, so the hostile
suite rides the existing loadgen entry point.

Exit codes: 1 differential mismatch, 2 steady-state compiles, 3 invalid
record, 4 tenant fairness breach, 5 scenario SLO gate failed, 6 no
overflow rejection demonstrated (backpressure never engaged). A refused
invocation exits 2 naming why: no card with ``--device cuda``, or a
scenario given a leg it cannot run on.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import random
import sys
import threading
import time
import urllib.error
import urllib.request

from byzantinerandomizedconsensus_tpu_torch.backends import compaction as _compaction
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.obs import metrics as _metrics
from byzantinerandomizedconsensus_tpu_torch.obs import record
from byzantinerandomizedconsensus_tpu_torch.serve import admission as _admission
from byzantinerandomizedconsensus_tpu_torch.tools import loadgen as _loadgen
from byzantinerandomizedconsensus_tpu_torch.utils import metrics
from byzantinerandomizedconsensus_tpu_torch.utils.rounds import default_artifact

# Bumped whenever any scenario's draw sequence changes shape: a hostile
# artifact's populations are reproducible only by
# (generator_version, suite seed) together.
HOSTILE_GENERATOR_VERSION = 1

SCENARIOS = ("flash_crowd", "heavy_tail", "bucket_churn", "tenant_hog",
             "cancel_storm", "session_hog")

#: Round-22 durability/elasticity drills — a separate family so
#: ``--scenario all`` keeps its r18 meaning (and its flash-crowd
#: overflow gate); they write the schema-v1.13 ``elastic`` record.
ELASTIC_SCENARIOS = ("dispatcher_kill", "autoscale_crowd")

#: Round-23 preemption/serializable-lane-state drills — again a separate
#: family (schema-v1.14 ``lanestate`` + ``preempt`` record); ``--scenario
#: preempt`` runs the storm, the restore bit-identity grid, and (non-smoke)
#: the ``--migrate`` fleet sweep.
PREEMPT_SCENARIOS = ("preempt_storm",)

#: Admitted round_cap ceiling for the hostile servers — half the serving
#: default: the suite's populations are many small requests, and the
#: ceiling is the drain-segment length every warm-up must pay for.
ROUND_CAP_CEILING = 64

#: Per-scenario request counts, (full, --smoke).
_SIZES = {
    "flash_crowd": (28, 10),
    "heavy_tail": (30, 10),
    "bucket_churn": (18, 9),
    "tenant_hog": (24, 10),   # hog 2/3, interactive 1/3
    "cancel_storm": (24, 10),
    "session_hog": (15, 8),  # hog sessions 1/3, interactive 2/3
    "dispatcher_kill": (12, 6),   # last third are 32-slot sessions
    "autoscale_crowd": (36, 18),  # interleaved across 3 fused buckets
    "preempt_storm": (12, 6),     # 1/3 fat rotations, 2/3 urgent
}

#: session_hog: chained decision slots per hog session (each hog envelope
#: is a round_cap x instances x slots lane-round claim).
_HOG_SESSION_SLOTS = 4

#: autoscale_crowd's injected per-segment latency. The drill must be
#: sleep-dominated so its p99 gate reads elasticity, not the host: the
#: reference injects 0.05 s over its numpy lanes; the plain torch driver's
#: lane segment costs more host time (a thread fleet's workers share the
#: interpreter), so the port injects 0.2 s.
AUTOSCALE_SEGMENT_LATENCY_S = 0.2
#: Wall-clock budget of the dispatcher_kill drill's kill-point search.
DRILL_TIMEOUT_S = 600.0
#: The repository root: the drill's ``cli serve`` subprocess starts there.
ROOT = pathlib.Path(__file__).resolve().parents[2]

#: The fairness bound (tenant_hog): the interactive tenant's p99 must stay
#: under max(half the hog's p99, this floor) — the floor keeps the gate
#: robust on slow shared CI boxes where everything is uniformly slow.
_FAIRNESS_FLOOR_MS = 2000.0


def _cfg(protocol: str, n: int, f: int, seed: int, *, instances: int = 4,
         round_cap: int = 32, delivery: str = "keys",
         adversary: str = "none") -> SimConfig:
    return SimConfig(protocol=protocol, n=n, f=f, instances=instances,
                     adversary=adversary, coin="local", init="random",
                     seed=seed, round_cap=round_cap,
                     delivery=delivery).validate()


def _warm_config(bucket, seq: int) -> SimConfig:
    """Like loadgen's warm config, at the hostile ceiling: enough
    instances to overflow the grid width (refill program) and the ceiling
    cap (rotation closes catch live lanes → drain program)."""
    n = min(7, bucket.n_pad)
    return SimConfig(
        protocol=bucket.protocol, n=n, f=1, instances=16,
        adversary="none", coin="local", init="random", seed=1000 + seq,
        round_cap=ROUND_CAP_CEILING, delivery=bucket.delivery).validate()


def _warm(server, buckets, burst: int = 4) -> int:
    """Compile every steady-state program for every bucket. Phase one is
    the loadgen chaining (same-bucket bursts, submitted back-to-back so
    bucket-to-bucket rotations close grids mid-flight); phase two closes
    EVERY bucket's grid live — one long config per bucket, the next
    bucket's closer submitted only once the previous is dispatched, so
    each rotation catches live lanes and compiles that bucket's drain leg
    (a closer submitted too early would live-join the still-active grid
    instead of forcing a rotation). ``burst`` stays under any feed /
    tenant bound the scenario's server carries. Returns the warm-up
    compile count."""
    handles = []
    seq = 0
    for bucket in buckets:
        for _ in range(burst):
            handles.append(server.submit(_warm_config(bucket, seq)))
            seq += 1
    for h in handles:
        h.wait(timeout=1800.0)
    _loadgen.close_grids_live(server, buckets, _warm_config, seq)
    return server.compile_count()


def _backend(args):
    """A fresh backend for one server: ``--backend`` on ``--device`` with
    ``--kernel`` (each server owns its backend, as in the reference)."""
    return _loadgen.make_backend(args.backend, args.device, args.kernel)


def _mismatch_count(args, pairs) -> int:
    """Surviving replies vs the per-config run of the plain round driver
    on the same device, bit for bit (``pairs`` is ``[(SimConfig, reply
    record dict)]``)."""
    be = args.reference
    bad = 0
    for cfg, rec in pairs:
        ref = be.run(cfg)
        if (rec["rounds"] != [int(r) for r in ref.rounds]
                or rec["decision"] != [int(d) for d in ref.decision]):
            bad += 1
    return bad


def _counter_total(name: str, **labels) -> float:
    """Sum of a counter's matching series in the live registry (0.0 when
    the metric has not been touched)."""
    ent = _metrics.snapshot().get(name)
    if not ent:
        return 0.0
    total = 0.0
    for s in ent.get("series", []):
        if all(s.get("labels", {}).get(k) == v for k, v in labels.items()):
            total += s.get("value", 0.0)
    return total


def _row(name: str, seed: int, requests: int, replied: int, *,
         rejected: int = 0, cancelled: int = 0, mismatches: int = 0,
         steady: int = 0, slo_ok: bool = True, **extra) -> dict:
    row = {"scenario": name, "seed": seed, "requests": requests,
           "replied": replied, "rejected": rejected, "cancelled": cancelled,
           "mismatches": mismatches, "steady_state_compiles": steady,
           "slo_ok": bool(slo_ok)}
    row.update(extra)
    return row


# ---------------------------------------------------------------- HTTP --

def _http(method: str, url: str, doc=None, timeout: float = 120.0):
    """One request; returns (status, parsed JSON body, headers dict) —
    HTTP error statuses are answers here (429 is the point), not
    exceptions."""
    data = None if doc is None else json.dumps(doc).encode()
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return (resp.status,
                    json.loads(resp.read().decode() or "{}"),
                    dict(resp.headers))
    except urllib.error.HTTPError as e:
        raw = e.read().decode() or "{}"
        try:
            body = json.loads(raw)
        except ValueError:
            body = {"error": raw}
        return e.code, body, dict(e.headers or {})


def _submit_retrying(base: str, payload: dict, max_tries: int = 200):
    """POST /submit until accepted, honoring the Retry-After hint on every
    429. Returns (request id, number of 429s absorbed)."""
    rejected = 0
    for _ in range(max_tries):
        code, body, headers = _http("POST", base + "/submit", payload)
        if code == 200:
            return body["id"], rejected
        if code == 429:
            rejected += 1
            hint = headers.get("Retry-After", body.get("retry_after_s", 0.1))
            time.sleep(float(hint))
            continue
        raise RuntimeError(f"unexpected HTTP {code}: {body}")
    raise RuntimeError(f"submit never accepted after {max_tries} tries")


def _fetch_result(base: str, rid: str, timeout: float = 900.0) -> dict:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        code, body, _ = _http("GET", base + f"/result/{rid}")
        if code == 200:
            return body
        if code != 202:
            raise RuntimeError(f"result {rid}: HTTP {code}: {body}")
        time.sleep(0.05)
    raise TimeoutError(f"result {rid} not done after {timeout}s")


# ----------------------------------------------------------- scenarios --

def _scenario_flash_crowd(args, seed: int) -> dict:
    """The synchronized crowd against a bounded server, over live HTTP."""
    from byzantinerandomizedconsensus_tpu_torch.serve.server import (
        ConsensusServer, serve_http)

    n_req = _SIZES["flash_crowd"][1 if args.smoke else 0]
    cfgs = [_cfg("benor", 5, 1, seed * 1000 + i) for i in range(n_req)]
    before = _counter_total("brc_serve_rejected_total", reason="overflow")

    with ConsensusServer(backend=_backend(args), policy=args.policy,
                         round_cap_ceiling=ROUND_CAP_CEILING,
                         feed_depth=4, rotation_queue_depth=8) as srv:
        # burst=3 stays under the feed bound during warm-up (seed + 3
        # same-bucket joins never exceed depth 4)
        warm_compiles = _warm(srv, [_admission.bucket_of(cfgs[0])], burst=3)
        httpd = serve_http(srv, host="127.0.0.1", port=0)
        threading.Thread(target=httpd.serve_forever,
                         name="brc-hostile-http", daemon=True).start()
        host, port = httpd.server_address[:2]
        base = f"http://{host}:{port}"
        try:
            results: dict = {}
            errors: list = []
            lock = threading.Lock()

            def crowd(part) -> None:
                try:
                    for i in part:
                        payload = dataclasses.asdict(cfgs[i])
                        rid, rej = _submit_retrying(base, payload)
                        with lock:
                            results[i] = (rid, rej)
                except Exception as e:  # noqa: BLE001 — surfaced below
                    with lock:
                        errors.append(str(e))

            threads = [threading.Thread(
                target=crowd, args=([i for i in range(n_req) if i % 6 == t],),
                name=f"brc-crowd-{t}") for t in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                raise RuntimeError(f"flash crowd client errors: {errors}")
            pairs = [(cfgs[i], _fetch_result(base, rid))
                     for i, (rid, _) in sorted(results.items())]
        finally:
            httpd.shutdown()
            httpd.server_close()
        steady = srv.compile_count() - warm_compiles

    rejected = int(_counter_total("brc_serve_rejected_total",
                                  reason="overflow") - before)
    mism = _mismatch_count(args, pairs)
    return _row("flash_crowd", seed, n_req, len(pairs), rejected=rejected,
                mismatches=mism, steady=steady,
                slo_ok=(len(pairs) == n_req),
                client_retries=sum(r for _, r in results.values()))


def _scenario_heavy_tail(args, seed: int) -> dict:
    """Deadline/priority envelopes over a mixed population — the EDF
    scheduling witness (records the deadline hit rate)."""
    from byzantinerandomizedconsensus_tpu_torch.serve.server import ConsensusServer

    n_req = _SIZES["heavy_tail"][1 if args.smoke else 0]
    rng = random.Random(seed)
    cfgs, envs = [], []
    for i in range(n_req):
        if i % 2 == 0:
            cfgs.append(_cfg("benor", 5, 1, seed * 1000 + i))
        else:
            cfgs.append(_cfg("bracha", 7, 2, seed * 1000 + i,
                             delivery="urn", instances=6, round_cap=48))
        draw = rng.random()
        if draw < 0.5:
            envs.append({"deadline_ms": rng.uniform(3000.0, 10000.0)})
        elif draw < 0.8:
            envs.append({"deadline_ms": rng.uniform(15000.0, 45000.0)})
        else:
            envs.append({"priority": rng.randint(-4, 4)})

    with ConsensusServer(backend=_backend(args), policy=args.policy,
                         round_cap_ceiling=ROUND_CAP_CEILING) as srv:
        buckets = []
        for c in cfgs:
            b = _admission.bucket_of(c)
            if b not in buckets:
                buckets.append(b)
        warm_compiles = _warm(srv, buckets)
        handles = [srv.submit({**dataclasses.asdict(c), **env})
                   for c, env in zip(cfgs, envs)]
        for h in handles:
            h.wait(timeout=900.0)
        steady = srv.compile_count() - warm_compiles

    with_deadline = [h for h in handles if h.t_deadline is not None]
    hits = sum(1 for h in with_deadline if h.t_reply <= h.t_deadline)
    hit_rate = (round(hits / len(with_deadline), 4)
                if with_deadline else None)
    mism = _mismatch_count(args, [(c, h.record) for c, h in zip(cfgs, handles)])
    slo_ok = hit_rate is None or hit_rate >= 0.5
    return _row("heavy_tail", seed, n_req, len(handles), mismatches=mism,
                steady=steady, slo_ok=slo_ok, deadline_hit_rate=hit_rate,
                deadlines=len(with_deadline))


def _scenario_bucket_churn(args, seed: int) -> dict:
    """Rotation storm: round-robin across three fused buckets; the
    zero-recompile pin must survive every rotation."""
    from byzantinerandomizedconsensus_tpu_torch.serve.server import ConsensusServer

    n_req = _SIZES["bucket_churn"][1 if args.smoke else 0]
    families = (
        lambda s: _cfg("benor", 5, 1, s),
        lambda s: _cfg("bracha", 7, 2, s, delivery="urn"),
        lambda s: _cfg("benor", 9, 3, s, instances=6, round_cap=48,
                       adversary="crash"),
    )
    cfgs = [families[i % 3](seed * 1000 + i) for i in range(n_req)]

    with ConsensusServer(backend=_backend(args), policy=args.policy,
                         round_cap_ceiling=ROUND_CAP_CEILING) as srv:
        buckets = []
        for c in cfgs:
            b = _admission.bucket_of(c)
            if b not in buckets:
                buckets.append(b)
        warm_compiles = _warm(srv, buckets)
        handles = [srv.submit(c) for c in cfgs]
        for h in handles:
            h.wait(timeout=900.0)
        steady = srv.compile_count() - warm_compiles

    mism = _mismatch_count(args, [(c, h.record) for c, h in zip(cfgs, handles)])
    return _row("bucket_churn", seed, n_req, len(handles), mismatches=mism,
                steady=steady, slo_ok=(len(handles) == n_req),
                buckets=len(buckets))


def _scenario_tenant_hog(args, seed: int) -> dict:
    """One tenant floods, the interactive tenant must stay responsive:
    per-tenant cap + deficit-weighted rotations, p99 fairness gate."""
    from byzantinerandomizedconsensus_tpu_torch.serve.server import ConsensusServer

    n_req = _SIZES["tenant_hog"][1 if args.smoke else 0]
    n_hog = (2 * n_req) // 3
    n_int = n_req - n_hog
    hog_cfgs = [_cfg("benor", 9, 3, seed * 1000 + i, instances=8,
                     round_cap=ROUND_CAP_CEILING) for i in range(n_hog)]
    int_cfgs = [_cfg("benor", 5, 1, seed * 1000 + 500 + i, instances=2,
                     round_cap=16) for i in range(n_int)]
    before = _counter_total("brc_serve_rejected_total", reason="tenant_cap")

    with ConsensusServer(backend=_backend(args), policy=args.policy,
                         round_cap_ceiling=ROUND_CAP_CEILING,
                         tenant_inflight_cap=8) as srv:
        buckets = [_admission.bucket_of(hog_cfgs[0]),
                   _admission.bucket_of(int_cfgs[0])]
        warm_compiles = _warm(srv, buckets, burst=3)
        hog_handles: list = []
        int_handles: list = []
        errors: list = []

        def hog() -> None:
            try:
                for c in hog_cfgs:
                    payload = {**dataclasses.asdict(c), "tenant": "hog"}
                    while True:
                        try:
                            hog_handles.append(srv.submit(payload))
                            break
                        except _admission.Backpressure as e:
                            time.sleep(e.retry_after_s)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(f"hog: {e}")

        def interactive() -> None:
            try:
                time.sleep(0.1)  # let the hog flood establish itself
                for c in int_cfgs:
                    payload = {**dataclasses.asdict(c),
                               "tenant": "interactive",
                               "deadline_ms": 8000.0}
                    int_handles.append(srv.submit(payload))
                    time.sleep(0.05)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(f"interactive: {e}")

        threads = [threading.Thread(target=hog, name="brc-hog"),
                   threading.Thread(target=interactive, name="brc-int")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise RuntimeError(f"tenant_hog submit errors: {errors}")
        for h in hog_handles + int_handles:
            h.wait(timeout=900.0)
        steady = srv.compile_count() - warm_compiles

    rejected = int(_counter_total("brc_serve_rejected_total",
                                  reason="tenant_cap") - before)
    (hog_p99,) = metrics.percentiles(
        [h.latency_s * 1000.0 for h in hog_handles], (99,))
    (int_p99,) = metrics.percentiles(
        [h.latency_s * 1000.0 for h in int_handles], (99,))
    bound = max(0.5 * hog_p99, _FAIRNESS_FLOOR_MS)
    fairness = {"hog_p99_ms": round(hog_p99, 3),
                "non_hog_p99_ms": round(int_p99, 3),
                "bound_ms": round(bound, 3),
                "rejected_tenant_cap": rejected,
                "ok": int_p99 <= bound}
    mism = _mismatch_count(args, 
        [(c, h.record) for c, h in zip(hog_cfgs, hog_handles)]
        + [(c, h.record) for c, h in zip(int_cfgs, int_handles)])
    return _row("tenant_hog", seed, n_req,
                len(hog_handles) + len(int_handles), rejected=rejected,
                mismatches=mism, steady=steady, slo_ok=fairness["ok"],
                fairness=fairness)


def _scenario_cancel_storm(args, seed: int) -> dict:
    """A seeded slice of a two-bucket burst is cancelled at staggered
    delays — queued kills at the feed/pending seam, live kills reclaimed
    at the next segment boundary; survivors stay bit-identical."""
    from byzantinerandomizedconsensus_tpu_torch.serve.server import ConsensusServer

    n_req = _SIZES["cancel_storm"][1 if args.smoke else 0]
    rng = random.Random(seed)
    # Heavy enough that the burst queues deep (instances ≫ grid width):
    # cancels land while victims are still queued or live, not after.
    cfgs = [(_cfg("benor", 5, 1, seed * 1000 + i, instances=8,
                  round_cap=48) if i % 2 == 0 else
             _cfg("bracha", 7, 2, seed * 1000 + i, delivery="urn",
                  instances=8, round_cap=48))
            for i in range(n_req)]
    victims = sorted(rng.sample(range(n_req), max(2, (2 * n_req) // 5)))

    with ConsensusServer(backend=_backend(args), policy=args.policy,
                         round_cap_ceiling=ROUND_CAP_CEILING) as srv:
        buckets = [_admission.bucket_of(cfgs[0]),
                   _admission.bucket_of(cfgs[1])]
        warm_compiles = _warm(srv, buckets)
        # Warm the reap seam too: cancelling a live request exercises the
        # segment-boundary lane reclaim before the measured phase.
        pre = srv.submit(_warm_config(buckets[0], 999))
        time.sleep(0.05)
        srv.cancel(pre.id)
        pre.done.wait(timeout=900.0)
        warm_compiles = srv.compile_count()

        handles = [srv.submit(c) for c in cfgs]
        where = {"queued": 0, "live": 0}
        cancelled_ok = 0
        for i in victims:
            delay = rng.uniform(0.0, 0.05)
            if args.leg == "lanes":
                # staggered, so some victims hold live lanes; on the direct
                # leg a request runs in milliseconds, so there the cancels
                # land at once (the same victims, the same draws) while the
                # burst is still queued or running
                time.sleep(delay)
            ack = srv.cancel(handles[i].id)
            if ack["cancelled"]:
                cancelled_ok += 1
                where[ack["where"]] += 1
        for h in handles:
            h.done.wait(timeout=900.0)
        steady = srv.compile_count() - warm_compiles

    survivors = [(c, h.record) for c, h in zip(cfgs, handles)
                 if h.record is not None]
    mism = _mismatch_count(args, survivors)
    resolved = all(h.done.is_set() for h in handles)
    return _row("cancel_storm", seed, n_req, len(survivors),
                cancelled=cancelled_ok, mismatches=mism, steady=steady,
                slo_ok=(resolved and cancelled_ok >= 1
                        and len(survivors) + cancelled_ok == n_req),
                cancel_where=where)


def _scenario_session_hog(args, seed: int) -> dict:
    """One tenant floods with max-weight spec-§11 sessions, the
    interactive tenant must stay responsive: the deficit-weighted rotation
    order prices a session envelope at its TRUE lane-round weight
    (round_cap × instances × slots), so a slots-heavy hog cannot buy more
    grid time than its deficit allows. Every hog session is additionally
    bit-replayed offline from its base seed (the spec-§11 law)."""
    from byzantinerandomizedconsensus_tpu_torch.models import session as _session
    from byzantinerandomizedconsensus_tpu_torch.serve.server import ConsensusServer

    n_req = _SIZES["session_hog"][1 if args.smoke else 0]
    n_hog = n_req // 3
    n_int = n_req - n_hog
    slots = _HOG_SESSION_SLOTS
    hog_cfgs = [_cfg("benor", 9, 3, seed * 1000 + i, instances=8,
                     round_cap=ROUND_CAP_CEILING) for i in range(n_hog)]
    int_cfgs = [_cfg("benor", 5, 1, seed * 1000 + 500 + i, instances=2,
                     round_cap=16) for i in range(n_int)]

    with ConsensusServer(backend=_backend(args), policy=args.policy,
                         round_cap_ceiling=ROUND_CAP_CEILING,
                         tenant_inflight_cap=8) as srv:
        buckets = [_admission.bucket_of(hog_cfgs[0]),
                   _admission.bucket_of(int_cfgs[0])]
        warm_compiles = _warm(srv, buckets, burst=3)
        hog_handles: list = []
        int_handles: list = []
        errors: list = []

        def hog() -> None:
            try:
                for c in hog_cfgs:
                    payload = {**dataclasses.asdict(c), "tenant": "hog",
                               "session_slots": slots}
                    while True:
                        try:
                            hog_handles.append(srv.submit(payload))
                            break
                        except _admission.Backpressure as e:
                            time.sleep(e.retry_after_s)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(f"hog: {e}")

        def interactive() -> None:
            try:
                time.sleep(0.1)  # let the session flood establish itself
                for c in int_cfgs:
                    payload = {**dataclasses.asdict(c),
                               "tenant": "interactive",
                               "deadline_ms": 8000.0}
                    int_handles.append(srv.submit(payload))
                    time.sleep(0.05)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(f"interactive: {e}")

        threads = [threading.Thread(target=hog, name="brc-session-hog"),
                   threading.Thread(target=interactive,
                                    name="brc-session-int")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise RuntimeError(f"session_hog submit errors: {errors}")
        for h in hog_handles + int_handles:
            h.wait(timeout=900.0)
        steady = srv.compile_count() - warm_compiles

    (hog_p99,) = metrics.percentiles(
        [h.latency_s * 1000.0 for h in hog_handles], (99,))
    (int_p99,) = metrics.percentiles(
        [h.latency_s * 1000.0 for h in int_handles], (99,))
    # A hog request is ~slots× the interactive weight by construction, so
    # the tenant_hog bound applies unchanged: the interactive p99 must not
    # inflate toward the session-stretched hog p99.
    bound = max(0.5 * hog_p99, _FAIRNESS_FLOOR_MS)
    fairness = {"hog_p99_ms": round(hog_p99, 3),
                "non_hog_p99_ms": round(int_p99, 3),
                "bound_ms": round(bound, 3),
                "ok": int_p99 <= bound}
    mism = _mismatch_count(args, 
        [(c, h.record) for c, h in zip(hog_cfgs, hog_handles)]
        + [(c, h.record) for c, h in zip(int_cfgs, int_handles)])
    be = args.reference
    replay_ok = True
    for c, h in zip(hog_cfgs, hog_handles):
        blk = h.record["session"]
        served = list(zip(blk["rounds"], blk["decisions"]))
        if not _session.replay_matches(be, c, served):
            replay_ok = False
            mism += 1
    return _row("session_hog", seed, n_req,
                len(hog_handles) + len(int_handles), mismatches=mism,
                steady=steady, slo_ok=(fairness["ok"] and replay_ok),
                sessions=n_hog, session_slots=slots,
                session_replay_ok=replay_ok, fairness=fairness)


_RUNNERS = {
    "flash_crowd": _scenario_flash_crowd,
    "heavy_tail": _scenario_heavy_tail,
    "bucket_churn": _scenario_bucket_churn,
    "tenant_hog": _scenario_tenant_hog,
    "cancel_storm": _scenario_cancel_storm,
    "session_hog": _scenario_session_hog,
}


# ------------------------------------------------ elastic drills (r22) --

def _erow(name: str, seed: int, requests: int, replied: int, *,
          recovered: int = 0, rejected_recovering: int = 0,
          scale_up: int = 0, scale_down: int = 0, mismatches: int = 0,
          steady: int = 0, slo_ok: bool = True, **extra) -> dict:
    """One ``elastic`` scenarios row (record.ELASTIC_SCENARIO_KEYS)."""
    row = {"scenario": name, "seed": seed, "requests": requests,
           "replied": replied, "recovered": recovered,
           "rejected_recovering": rejected_recovering,
           "scale_up_events": scale_up, "scale_down_events": scale_down,
           "mismatches": mismatches, "steady_state_compiles": steady,
           "slo_ok": bool(slo_ok)}
    row.update(extra)
    return row


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait_http_up(base: str, timeout: float = 300.0, proc=None) -> None:
    """Poll ``/healthz`` until the server answers anything at all (a 503
    is up too — a recovering fleet still serves its health page)."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(
                f"serve subprocess exited {proc.returncode} before "
                "answering HTTP")
        try:
            _http("GET", base + "/healthz", timeout=5.0)
            return
        except (urllib.error.URLError, ConnectionError, OSError):
            time.sleep(0.1)
    raise TimeoutError(f"{base} not up after {timeout}s")


def _fetch_recovered(base: str, rid: str, timeout: float = 900.0) -> dict:
    """Like :func:`_fetch_result`, but tolerates 404 while the recovery
    thread is still re-admitting (a recovered id registers the moment its
    replay is submitted, so the window is short)."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        code, body, _ = _http("GET", base + f"/result/{rid}")
        if code == 200:
            return body
        if code not in (202, 404):
            raise RuntimeError(f"result {rid}: HTTP {code}: {body}")
        time.sleep(0.05)
    raise TimeoutError(f"recovered result {rid} not done after {timeout}s")


def _scenario_dispatcher_kill(args, seed: int) -> dict:
    """SIGKILL the dispatcher mid-stream, restart with ``--recover``, and
    demand every in-flight request back bit-identically under its
    original id. The drill reads the admission WAL itself after the kill
    (crash-torn final line and all) to compute exactly which ids a
    correct recovery owes it — the gate is against that plan, not against
    whatever the server chooses to return."""
    import shutil
    import subprocess
    import tempfile

    from byzantinerandomizedconsensus_tpu_torch.models import session as _session
    from byzantinerandomizedconsensus_tpu_torch.serve.wal import WriteAheadLog

    n_req = _SIZES["dispatcher_kill"][1 if args.smoke else 0]
    rng = random.Random(seed)
    cfgs, payloads = [], []
    for i in range(n_req):
        c = _cfg("benor", 5, 1, seed * 1000 + i, instances=8, round_cap=48)
        cfgs.append(c)
        payload = dataclasses.asdict(c)
        if 3 * i >= 2 * n_req:
            # the tail of the stream is long spec-§11 sessions — slots run
            # sequentially, so these are the slowest work by construction
            # and the seeded kill reliably catches them in flight; recovery
            # must then reproduce full per-slot logs
            payload["session_slots"] = 32
        payloads.append(payload)

    wal_dir = tempfile.mkdtemp(prefix="brc-elastic-wal-")
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    argv = [sys.executable, "-m",
            "byzantinerandomizedconsensus_tpu_torch.serve.server",
            "--backend", args.backend, "--device", args.device,
            "--host", "127.0.0.1",
            "--port", str(port), "--policy", args.policy_spec,
            "--round-cap-ceiling", str(ROUND_CAP_CEILING),
            "--wal", wal_dir]
    if args.kernel:
        argv += ["--kernel", args.kernel]
    deadline = time.monotonic() + DRILL_TIMEOUT_S
    try:
        proc = subprocess.Popen(argv, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL, cwd=ROOT)
        try:
            _wait_http_up(base, proc=proc)
            ids = []
            for payload in payloads:
                rid, _ = _submit_retrying(base, payload)
                ids.append(rid)
            # the seeded kill point: SIGKILL once 1-2 replies landed AND
            # the journal still carries open admits — a crash with work in
            # flight is the whole drill, so a backend quick enough to
            # drain the stream first gets fed another long-session wave
            # rather than letting the kill land on an idle dispatcher
            kill_after = 1 + rng.randrange(2)
            done: dict = {}
            waves = 0
            while True:
                if proc.poll() is not None:
                    raise RuntimeError("serve subprocess died on its own")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"dispatcher_kill: no kill point within {DRILL_TIMEOUT_S}s")
                for rid in ids:
                    if rid in done:
                        continue
                    code, body, _ = _http("GET", base + f"/result/{rid}")
                    if code == 200:
                        done[rid] = body
                        if len(done) >= kill_after:
                            break
                if len(done) >= kill_after:
                    live_plan, _ = WriteAheadLog.plan_recovery(wal_dir)
                    if live_plan:
                        break
                    waves += 1
                    c = _cfg("benor", 5, 1, seed * 1000 + n_req + waves,
                             instances=8, round_cap=48)
                    cfgs.append(c)
                    payload = dataclasses.asdict(c)
                    payload["session_slots"] = 32
                    payloads.append(payload)
                    rid, _ = _submit_retrying(base, payload)
                    ids.append(rid)
                time.sleep(0.02)
        finally:
            proc.kill()  # SIGKILL: no drain, no WAL close — the crash
            proc.wait(timeout=60)

        # What does a correct recovery owe us? Read the journal the way
        # the server will: incomplete admits, in admission order.
        plan, _counter = WriteAheadLog.plan_recovery(wal_dir)
        owed = [e["id"] for e in plan]

        proc2 = subprocess.Popen(argv + ["--recover", wal_dir],
                                 stdout=subprocess.DEVNULL,
                                 stderr=subprocess.DEVNULL, cwd=ROOT)
        try:
            _wait_http_up(base, proc=proc2)
            # probe: a fresh submit during the replay answers 503 with the
            # named ``recovering`` reason (satellite pin); if the replay
            # already finished, the accepted probe is harmless traffic
            rejected_recovering = 0
            code, body, headers = _http("POST", base + "/submit",
                                        dataclasses.asdict(cfgs[0]))
            if code == 503 and body.get("reason") == "recovering":
                rejected_recovering = 1
                assert "Retry-After" in headers
            recovered: dict = {}
            for rid in owed:
                recovered[rid] = _fetch_recovered(base, rid)
            if code == 200:
                # the probe slipped in after the replay finished: drain
                # it so its (possibly cold) compile lands before the
                # steady-state window opens
                _fetch_result(base, body["id"])
            # steady-state pin: the replay warmed exactly the owed
            # entries' programs (warm-up builds are exempt, as any cold
            # start is) — re-submitting those same payloads must build
            # NOTHING new (the server's own counter: kernel libraries on
            # the direct leg, lane programs on the lane leg)
            idx_of = {rid: i for i, rid in enumerate(ids)}
            rewave = [payloads[idx_of[rid]] for rid in owed[:3]]
            _, st, _ = _http("GET", base + "/stats")
            c0 = st.get("compile_count", 0)
            for payload in rewave:
                rid, _ = _submit_retrying(base, payload)
                _fetch_result(base, rid)
            _, st, _ = _http("GET", base + "/stats")
            c1 = st.get("compile_count", 0)
            steady = int(c1) - int(c0)
        finally:
            proc2.kill()
            proc2.wait(timeout=60)
    finally:
        shutil.rmtree(wal_dir, ignore_errors=True)

    # bit-compare every reply the drill holds — fetched pre-kill or
    # recovered — against the plain-driver reference; recovered sessions
    # additionally replay their full per-slot log (spec §11)
    by_id = {rid: i for i, rid in enumerate(ids)}
    pairs = [(cfgs[by_id[rid]], rec)
             for rid, rec in {**done, **recovered}.items()]
    mism = _mismatch_count(args, pairs)
    be = args.reference
    session_replays = 0
    for rid, rec in recovered.items():
        if "session" in rec:
            blk = rec["session"]
            served = list(zip(blk["rounds"], blk["decisions"]))
            session_replays += 1
            if not _session.replay_matches(be, cfgs[by_id[rid]], served):
                mism += 1
    slo_ok = (len(owed) >= 1 and len(recovered) == len(owed)
              and session_replays >= (0 if args.smoke else 1))
    return _erow("dispatcher_kill", seed, len(ids),
                 len(done) + len(recovered), recovered=len(recovered),
                 rejected_recovering=rejected_recovering, mismatches=mism,
                 steady=steady, slo_ok=slo_ok,
                 killed_after_replies=len(done), owed=len(owed),
                 extra_waves=waves, session_replays=session_replays)


def _scenario_autoscale_crowd(args, seed: int) -> dict:
    """The same seeded crowd twice — against a pinned one-worker fleet
    and against the autoscaled fleet — with sleep-dominated segment
    timing, so the p99 ratio measures elasticity, not the host. The
    elastic leg must clear the SLO bound the static leg misses, scale
    down gracefully afterwards (retired, not lost), and keep the
    surviving original worker at zero steady-state compiles."""
    from byzantinerandomizedconsensus_tpu_torch.serve.autoscale import Autoscaler
    from byzantinerandomizedconsensus_tpu_torch.serve.fleet import FleetServer

    n_req = _SIZES["autoscale_crowd"][1 if args.smoke else 0]
    lat = AUTOSCALE_SEGMENT_LATENCY_S
    max_workers = 3
    # three distinct fused buckets, interleaved: a one-bucket crowd would
    # mid-flight JOIN the live rotation on worker 0 (nothing left pending,
    # nothing stealable) and no amount of scaling could help it — the
    # elastic claim needs a backlog the newcomers can actually steal
    kinds = (("benor", "keys"), ("bracha", "keys"), ("benor", "urn2"))
    cfgs = [_cfg(kinds[i % 3][0], 5 if kinds[i % 3][0] == "benor" else 7,
                 1, seed * 1000 + i, delivery=kinds[i % 3][1])
            for i in range(n_req)]

    def crowd(fl) -> tuple:
        handles = [fl.submit(c) for c in cfgs]
        for h in handles:
            h.wait(timeout=900.0)
        return ([h.latency_s * 1000.0 for h in handles],
                [(c, h.record) for c, h in zip(cfgs, handles)])

    def fleet() -> FleetServer:
        # pinned to the lane leg (the plain driver on --device) on purpose:
        # timing here is the injected per-segment sleep, which only the lane
        # grid has, so the p99 ratio measures scheduling elasticity, not
        # the kernels — the real backend's crash / recovery surface is the
        # dispatcher_kill drill's job
        return FleetServer(workers=1, mode="thread", backend="torch",
                           device=args.device, kernel="plain",
                           policy=args.policy,
                           round_cap_ceiling=ROUND_CAP_CEILING,
                           segment_latency_s=lat)

    # warm-up in both legs is one unmeasured replay of the exact crowd
    # population: programs are keyed by bucket and shape, so this compiles
    # precisely what the measured crowd will need — all on worker 0
    with fleet() as fl:
        crowd(fl)
        static_lat, _static_pairs = crowd(fl)

    with fleet() as fl:
        crowd(fl)
        warm0 = fl.compile_counts()[0] or 0
        scaler = Autoscaler(fl, min_workers=1, max_workers=max_workers,
                            interval_s=0.04, up_per_worker=3.0,
                            down_per_worker=0.5, up_ticks=1, down_ticks=8,
                            cooldown_s=0.1)
        scaler.start()
        elastic_lat, elastic_pairs = crowd(fl)
        # idle tail: the crowd is gone, so sustained under-pressure must
        # retire the extra workers back toward min_workers — gracefully
        t0 = time.monotonic()
        while time.monotonic() - t0 < 30.0:
            st = fl.stats(live=False)
            if scaler._downs >= 1 and st["routable"] <= 1:
                break
            time.sleep(0.05)
        counts = scaler.stop()
        # every retirement must drain, not drop: wait the handshakes out
        t0 = time.monotonic()
        while time.monotonic() - t0 < 60.0:
            if not fl.health().get("retiring"):
                break
            time.sleep(0.05)
        health = fl.health()
        st = fl.stats(live=False)
        steady = int((fl.compile_counts()[0] or 0) - warm0)
        lost = st["lost_workers"]
        retired = st["retired_workers"]

    (static_p99,) = metrics.percentiles(static_lat, (99,))
    (elastic_p99,) = metrics.percentiles(elastic_lat, (99,))
    # the pinned bound sits below the static baseline by construction:
    # meeting it REQUIRES the scale-up to have actually absorbed load
    slo_ms = round(0.75 * static_p99, 3)
    slo_ok = (elastic_p99 <= slo_ms < static_p99
              and counts["ups"] >= 1 and counts["downs"] >= 1
              and lost == 0 and retired >= 1 and health["ok"])
    # where a request ran (and whether its worker later retired) must
    # never touch the math: the scaled crowd's replies stay bit-identical
    mism = _mismatch_count(args, elastic_pairs)
    return _erow("autoscale_crowd", seed, n_req, len(elastic_lat),
                 scale_up=counts["ups"], scale_down=counts["downs"],
                 mismatches=mism, steady=steady, slo_ok=slo_ok,
                 static_p99_ms=round(static_p99, 3),
                 elastic_p99_ms=round(elastic_p99, 3), slo_ms=slo_ms,
                 segment_latency_s=lat, max_workers=max_workers,
                 lost_workers=lost, retired_workers=retired)


_ELASTIC_RUNNERS = {
    "dispatcher_kill": _scenario_dispatcher_kill,
    "autoscale_crowd": _scenario_autoscale_crowd,
}


# ---------------------------------------------- preempt drills (r23) --

def _fat_cfg(seed: int, *, faults: str = "none",
             adversary: str = "adaptive", delivery: str = "urn2",
             instances: int = 32, round_cap: int = 48) -> SimConfig:
    """The slowest admitted work by construction: split init keeps both
    value camps alive and the adaptive adversary at the full f=3 budget
    delays convergence (mean ~35 rounds/lane at n=10, many lanes riding
    the cap) — these are the lanes a preemption must park mid-round."""
    return SimConfig(protocol="bracha", n=10, f=3, instances=instances,
                     adversary=adversary, coin="local", init="split",
                     seed=seed, round_cap=round_cap, delivery=delivery,
                     faults=faults).validate()


def _restore_grid(args, seed: int) -> dict:
    """The snapshot/restore bit-identity grid: at every ``faults`` ×
    adversary × delivery point, capture the live request's lanes at a
    segment boundary (the recover points mid-crash-window, the partition
    points mid-partition — the capture lands inside the fault schedule by
    construction), JSON-round-trip the records, restore them into a
    DIFFERENT server, and demand the finished reply bit-identical to the
    uninterrupted control AND the plain-driver reference. The PRF addresses every
    draw by (key, instance, round, step), so where a lane finishes must
    never matter — this leg is that law, measured."""
    from byzantinerandomizedconsensus_tpu_torch.backends import (
        lanestate as _lanestate)
    from byzantinerandomizedconsensus_tpu_torch.serve.server import ConsensusServer

    pairs = ((("adaptive", "urn2"),) if args.smoke else
             (("none", "keys"), ("adaptive", "urn2"), ("byzantine", "urn")))
    points = [(ft, adv, dl)
              for ft in ("none", "recover", "partition", "omission")
              for adv, dl in pairs]

    lat = 0.02

    def hook(_msg, _sleep=time.sleep, _lat=lat):
        _sleep(_lat)

    t0 = time.perf_counter()
    mism = 0
    lanes_rt = 0
    rows = []
    with ConsensusServer(backend=_backend(args), policy=args.policy,
                         round_cap_ceiling=ROUND_CAP_CEILING) as control, \
         ConsensusServer(backend=_backend(args), policy=args.policy,
                         round_cap_ceiling=ROUND_CAP_CEILING,
                         segment_hook=hook) as victim, \
         ConsensusServer(backend=_backend(args), policy=args.policy,
                         round_cap_ceiling=ROUND_CAP_CEILING) as thief:
        for idx, (ft, adv, dl) in enumerate(points):
            cfg = _fat_cfg(seed * 100 + idx, faults=ft, adversary=adv,
                           delivery=dl, instances=48)
            base = control.submit(cfg).wait(timeout=900.0)
            h = victim.submit(cfg)
            t1 = time.monotonic()
            while h.t_dispatch is None and time.monotonic() - t1 < 300.0:
                time.sleep(0.005)
            # land the capture a few segments in: mid-round, and (for the
            # recover/partition points) inside the active fault window —
            # early enough that even the fast-deciding adversary-free
            # points (mean ~2-3 rounds/lane) are still mid-wave
            time.sleep(4 * lat)
            recs = victim.export_lanes([h.id], timeout=300.0)
            if not recs:
                mism += 1
                rows.append({"faults": ft, "adversary": adv,
                             "delivery": dl, "captured": 0, "ok": False})
                continue
            lanes = sum(r.lane_count() for r in recs)
            lanes_rt += lanes
            docs = [json.loads(json.dumps(r.to_doc())) for r in recs]
            rep = thief.import_lanes(docs)[0].wait(timeout=900.0)
            ok = (rep["rounds"] == base["rounds"]
                  and rep["decision"] == base["decision"]
                  and _mismatch_count(args, [(cfg, rep)]) == 0)
            if not ok:
                mism += 1
            rows.append({"faults": ft, "adversary": adv, "delivery": dl,
                         "captured": lanes, "ok": ok})
            print(f"preempt: restore [{ft}/{adv}/{dl}] captured {lanes} "
                  f"lanes mid-round — {'OK' if ok else 'MISMATCH'}")
    return {
        "version": _lanestate.LANESTATE_VERSION,
        "grid_points": len(points),
        "restore_mismatches": mism,
        "crash_window_ok": all(r["ok"] for r in rows
                               if r["faults"] == "recover"),
        "roundtrip_ok": mism == 0,
        "grid": rows,
        "lanes_round_tripped": lanes_rt,
        "duration_s": round(time.perf_counter() - t0, 3),
    }


def _scenario_preempt_storm(args, seed: int) -> dict:
    """Deadline-urgent arrivals vs a grid-holding fat rotation, twice:
    once with preemptive scheduling (park the fat lanes, run the urgent
    bucket, resume), once through the round-18 FIFO path on identical
    traffic. Segment timing is sleep-dominated so the hit-rate split
    measures scheduling, not the host; replies from BOTH legs are
    bit-compared to each other and to the plain-driver reference."""
    from byzantinerandomizedconsensus_tpu_torch.serve.server import ConsensusServer

    n_req = _SIZES["preempt_storm"][1 if args.smoke else 0]
    n_fat = max(2, n_req // 3)
    n_urg = n_req - n_fat
    fat_cfgs = [_fat_cfg(seed * 1000 + i) for i in range(n_fat)]
    urg_cfgs = [_cfg("benor", 5, 1, seed * 1000 + 500 + i, instances=2,
                     round_cap=16) for i in range(n_urg)]
    deadline_ms = 2500.0
    lat = 0.01

    def hook(_msg, _sleep=time.sleep, _lat=lat):
        _sleep(_lat)

    def leg(preempt: bool):
        with ConsensusServer(backend=_backend(args), policy=args.policy,
                             round_cap_ceiling=ROUND_CAP_CEILING,
                             segment_hook=hook, preempt=preempt) as srv:
            buckets = [_admission.bucket_of(fat_cfgs[0]),
                       _admission.bucket_of(urg_cfgs[0])]
            warm_compiles = _warm(srv, buckets, burst=3)
            fat_handles = [srv.submit(c) for c in fat_cfgs]
            t1 = time.monotonic()
            while (all(h.t_dispatch is None for h in fat_handles)
                   and time.monotonic() - t1 < 300.0):
                time.sleep(0.005)
            time.sleep(0.3)  # the fat rotation is mid-round when...
            urg_handles = [srv.submit({**dataclasses.asdict(c),
                                       "deadline_ms": deadline_ms})
                           for c in urg_cfgs]  # ...the storm arrives
            for h in fat_handles + urg_handles:
                h.wait(timeout=1800.0)
            steady = srv.compile_count() - warm_compiles
            pstats = srv.stats()["preempt"]
        hits = sum(1 for h in urg_handles if h.t_reply <= h.t_deadline)
        return (round(hits / len(urg_handles), 4), fat_handles,
                urg_handles, steady, pstats)

    hit_pre, fat_p, urg_p, steady_p, pstats = leg(preempt=True)
    hit_fifo, fat_f, urg_f, steady_f, _ = leg(preempt=False)

    # one oracle pass (preempt leg), then cross-leg bit-identity: where a
    # lane ran — parked/resumed or straight through — must never matter
    mism = _mismatch_count(args, 
        [(c, h.record) for c, h in zip(fat_cfgs, fat_p)]
        + [(c, h.record) for c, h in zip(urg_cfgs, urg_p)])
    for a, b in zip(fat_p + urg_p, fat_f + urg_f):
        if (a.record["rounds"] != b.record["rounds"]
                or a.record["decision"] != b.record["decision"]):
            mism += 1
    slo_ok = (hit_pre > hit_fifo and pstats["parks"] >= 1
              and pstats["resumes"] >= 1)
    return _row("preempt_storm", seed, 2 * n_req,
                2 * (len(fat_p) + len(urg_p)), mismatches=mism,
                steady=steady_p + steady_f, slo_ok=slo_ok,
                deadline_hit_rate=hit_pre, fifo_hit_rate=hit_fifo,
                parks=pstats["parks"], resumes=pstats["resumes"],
                lanes_exported=pstats["lanes_exported"],
                lanes_imported=pstats["lanes_imported"],
                fat_requests=n_fat, urgent_requests=n_urg,
                segment_latency_s=lat)


def _migration_sweep(args) -> dict:
    """The r15 fat-tail fleet sweep re-run with lane-level migration on
    (``loadgen --workers 1,2,4 --migrate``): same stream, same seed, same
    fabric latency — the scaling claim now has serialized mid-round lanes
    moving between workers under it. Returns the summary the preempt
    artifact embeds (the full serve_fleet record lands beside it)."""
    # land beside the suite artifact under the SAME round stamp — an
    # explicit ``--out .../preempt_rN.json`` must not leave the
    # sweep record on whatever round VERDICT.md currently parses to
    if args.out and "preempt" in pathlib.Path(args.out).name:
        suite = pathlib.Path(args.out)
        out = suite.with_name(
            suite.name.replace("preempt", "serve_fleet_migrate", 1))
    else:
        out = pathlib.Path(default_artifact("serve_fleet_migrate"))
    out.parent.mkdir(parents=True, exist_ok=True)
    rc = _loadgen.main(["--workers", "1,2,4", "--fleet-latency-ms", "60",
                        "--requests", "200", "--seed", "15", "--rate", "4",
                        "--migrate", "--out", str(out), "--backend", args.backend,
                        "--device", args.device]
                       + (["--kernel", args.kernel] if args.kernel else []))
    doc = json.loads(out.read_text())
    legs = doc.get("legs") or {}
    return {
        "artifact": out.name,
        "exit_code": rc,
        "workers": doc.get("workers_swept"),
        "scaling_4w_vs_1w": (doc.get("summary") or {}).get(
            "scaling_4w_vs_1w"),
        "steady_state_compiles": {k: leg.get("steady_state_compiles")
                                  for k, leg in legs.items()},
        "migrations": {k: leg.get("migrations") for k, leg in legs.items()},
        "lanes_migrated": {k: leg.get("lanes_migrated")
                           for k, leg in legs.items()},
        "differential_mismatches": (doc.get("differential") or {}).get(
            "mismatches"),
    }


def _preempt_main(args) -> int:
    """Run the round-23 preemption suite and write the schema-v1.14
    ``lanestate`` + ``preempt`` record.
    Exit ladder: 3 invalid record, 1 mismatch (storm differential or a
    restore-grid divergence), 2 steady-state compiles, 5 hit-rate /
    restore-grid gate, 4 migration-sweep scaling below the r15 bar."""
    out = pathlib.Path(args.out or default_artifact("preempt"))
    out.parent.mkdir(parents=True, exist_ok=True)

    t0 = time.perf_counter()
    print(f"preempt: restore bit-identity grid, seed {args.seed} …")
    ls_stats = _restore_grid(args, args.seed * 100 + 7)
    print(f"preempt: restore grid {ls_stats['grid_points']} points, "
          f"{ls_stats['lanes_round_tripped']} lanes round-tripped, "
          f"{ls_stats['restore_mismatches']} mismatches")

    seed = args.seed * 100
    print(f"preempt: [preempt_storm] seed {seed} …")
    row = _scenario_preempt_storm(args, seed)
    print(f"preempt: [preempt_storm] hit rate {row['deadline_hit_rate']} "
          f"vs FIFO {row['fifo_hit_rate']}, parks {row['parks']}, "
          f"lanes exported/imported {row['lanes_exported']}/"
          f"{row['lanes_imported']}, mismatches {row['mismatches']}, "
          f"steady compiles {row['steady_state_compiles']}")

    sweep = None
    if not args.smoke:
        print("preempt: migration sweep (loadgen --workers 1,2,4 "
              "--migrate) …")
        sweep = _migration_sweep(args)
        print(f"preempt: sweep scaling {sweep['scaling_4w_vs_1w']}x at 4 "
              f"workers, migrations {sweep['migrations']}, exit "
              f"{sweep['exit_code']}")

    stats = {
        "suite_seed": args.seed,
        "generator_version": HOSTILE_GENERATOR_VERSION,
        "requests": row["requests"],
        "parks": row["parks"],
        "resumes": row["resumes"],
        "lanes_exported": row["lanes_exported"],
        "lanes_imported": row["lanes_imported"],
        "deadline_hit_rate": row["deadline_hit_rate"],
        "fifo_hit_rate": row["fifo_hit_rate"],
        "mismatches": row["mismatches"] + ls_stats["restore_mismatches"],
        "steady_state_compiles": row["steady_state_compiles"],
        "urgent_requests": row["urgent_requests"],
        "fat_requests": row["fat_requests"],
        "duration_s": round(time.perf_counter() - t0, 3),
    }

    doc = {
        **record.new_record(
            "preempt",
            description="Serializable lane state: the snapshot/restore "
                        "bit-identity grid across every fault x adversary "
                        "x delivery point, the preempt_storm deadline "
                        "drill vs the FIFO baseline, and the fat-tail "
                        "fleet sweep with lane-level migration."),
        "seed": args.seed,
        "smoke": bool(args.smoke),
        "backend": args.backend,
        "device": args.device,
        "kernel": args.kernel,
        "leg": args.leg,
        "policy": args.policy.doc(),
        "round_cap_ceiling": ROUND_CAP_CEILING,
        "lanestate": record.lanestate_block(ls_stats),
        "preempt": record.preempt_block(stats),
        "scenarios": [row],
    }
    if sweep is not None:
        doc["migration_sweep"] = sweep
    problems = record.validate_record(doc)
    if problems:
        print(f"preempt: INVALID RECORD: {problems}", file=sys.stderr)
        return 3
    out.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"preempt: wrote {out}")

    if stats["mismatches"]:
        print("preempt: DIFFERENTIAL MISMATCH", file=sys.stderr)
        return 1
    if stats["steady_state_compiles"]:
        print("preempt: STEADY-STATE RECOMPILES", file=sys.stderr)
        return 2
    if not (row["slo_ok"] and ls_stats["roundtrip_ok"]
            and ls_stats["crash_window_ok"]):
        print("preempt: HIT-RATE / RESTORE GATE FAILED", file=sys.stderr)
        return 5
    if sweep is not None:
        scaling = sweep["scaling_4w_vs_1w"]
        steady_all = sum(sum(v or []) for v in
                         sweep["steady_state_compiles"].values())
        if (sweep["exit_code"] != 0 or scaling is None or scaling <= 3.14
                or steady_all):
            print(f"preempt: MIGRATION SWEEP GATE FAILED "
                  f"(scaling {scaling}, steady {steady_all}, exit "
                  f"{sweep['exit_code']})", file=sys.stderr)
            return 4
    return 0


# ---------------------------------------------------------------- main --

def _elastic_main(args) -> int:
    """Run the round-22 durability/elasticity drills and write the
    schema-v1.13 ``elastic`` record.
    Same exit ladder as the hostile suite: 3 invalid record, 1 mismatch,
    2 steady-state compiles, 5 drill SLO/verdict failure."""
    names = (ELASTIC_SCENARIOS if args.scenario == "elastic"
             else (args.scenario,))
    out = pathlib.Path(args.out or default_artifact("elastic"))
    out.parent.mkdir(parents=True, exist_ok=True)

    t0 = time.perf_counter()
    rows = []
    for i, name in enumerate(names):
        seed = args.seed * 100 + i
        print(f"elastic: [{name}] seed {seed} …")
        row = _ELASTIC_RUNNERS[name](args, seed)
        rows.append(row)
        print(f"elastic: [{name}] replied {row['replied']}/"
              f"{row['requests']}, recovered {row['recovered']}, "
              f"scale +{row['scale_up_events']}/-"
              f"{row['scale_down_events']}, mismatches "
              f"{row['mismatches']}, steady compiles "
              f"{row['steady_state_compiles']}, "
              f"slo {'OK' if row['slo_ok'] else 'BREACH'}")

    autoscale = next((r for r in rows
                      if r["scenario"] == "autoscale_crowd"), {})
    stats = {
        "suite_seed": args.seed,
        "generator_version": HOSTILE_GENERATOR_VERSION,
        "scenarios": rows,
        "recovered": sum(r["recovered"] for r in rows),
        "scale_up_events": sum(r["scale_up_events"] for r in rows),
        "scale_down_events": sum(r["scale_down_events"] for r in rows),
        "mismatches": sum(r["mismatches"] for r in rows),
        "steady_state_compiles": sum(r["steady_state_compiles"]
                                     for r in rows),
        "slo_ok": all(r["slo_ok"] for r in rows),
        "duration_s": round(time.perf_counter() - t0, 3),
        "static_p99_ms": autoscale.get("static_p99_ms"),
        "elastic_p99_ms": autoscale.get("elastic_p99_ms"),
        "slo_ms": autoscale.get("slo_ms"),
    }

    doc = {
        **record.new_record(
            "elastic",
            description="Durability/elasticity drills: a SIGKILLed "
                        "dispatcher recovered bit-identically from the "
                        "write-ahead admission log, and a flash crowd "
                        "absorbed by the metrics-driven autoscaler "
                        "against a pinned static baseline."),
        "seed": args.seed,
        "smoke": bool(args.smoke),
        "backend": args.backend,
        "device": args.device,
        "kernel": args.kernel,
        "leg": args.leg,
        "policy": args.policy.doc(),
        "round_cap_ceiling": ROUND_CAP_CEILING,
        "elastic": record.elastic_block(stats),
    }
    problems = record.validate_record(doc)
    if problems:
        print(f"elastic: INVALID RECORD: {problems}", file=sys.stderr)
        return 3
    out.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"elastic: wrote {out}")

    if stats["mismatches"]:
        print("elastic: DIFFERENTIAL MISMATCH", file=sys.stderr)
        return 1
    if stats["steady_state_compiles"]:
        print("elastic: STEADY-STATE RECOMPILES", file=sys.stderr)
        return 2
    if not stats["slo_ok"]:
        print("elastic: DRILL SLO BREACH", file=sys.stderr)
        return 5
    return 0


def _leg(args) -> str:
    """The leg every scenario's server runs: ``"lanes"`` when the backend's
    kernel is the plain driver (``--kernel plain``; the CPU's only kernel),
    else ``"direct"``."""
    return "lanes" if getattr(_backend(args), "kernel", None) == "plain" else "direct"


def main(argv=None) -> int:
    from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import KERNELS
    ap = argparse.ArgumentParser(
        prog="byzantinerandomizedconsensus_tpu_torch.cli loadgen --scenario",
        description="Hostile-load suite: backpressure, fairness, deadline "
                    "scheduling and cancellation under adversarial "
                    "traffic, every gate exit-code enforced.")
    ap.add_argument("--scenario", default="all",
                    choices=SCENARIOS + ELASTIC_SCENARIOS
                    + PREEMPT_SCENARIOS + ("all", "elastic", "preempt"),
                    help="'all' runs the six hostile scenarios; 'elastic' the "
                         "two durability drills (dispatcher_kill + "
                         "autoscale_crowd, the elastic record); 'preempt' (or "
                         "preempt_storm) the preemption suite — restore "
                         "bit-identity grid, preempt_storm vs FIFO, migration "
                         "sweep (the lanestate + preempt record; the lane leg "
                         "only: --kernel plain on the card)")
    ap.add_argument("--seed", type=int, default=18)
    ap.add_argument("--backend", default="torch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits 2 with no card) or cpu")
    ap.add_argument("--kernel", choices=KERNELS, default=None,
                    help="as for cli serve: fused or step (the direct leg), "
                         "plain (the lane leg); none named: the direct leg on "
                         "the card, the kernel by law")
    ap.add_argument("--policy", default="width=8,segment=1",
                    help="compaction policy spec (small grid: the hostile "
                         "populations are many small requests)")
    ap.add_argument("--out", default=None,
                    help=f"record path (default "
                         f"{default_artifact('hostile')})")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny fast run: ~10 requests per scenario")
    # swallowed when handed over from cli loadgen with loadgen flags
    args, _extra = ap.parse_known_args(argv)

    try:
        # a backend on a card unless --device cpu: with none present this
        # raises by name, and nothing falls back to the CPU
        args.leg = _leg(args)
    except (KeyError, RuntimeError, ValueError) as e:
        print(f"hostile: {e}", file=sys.stderr)
        return 2
    preempt = args.scenario == "preempt" or args.scenario in PREEMPT_SCENARIOS
    if preempt and args.leg != "lanes":
        print(f"hostile: --scenario {args.scenario} needs the lane leg "
              f"(--kernel plain): preemption parks and restores lanes, and "
              f"the {args.leg} leg (kernel {args.kernel or 'by law'} on "
              f"{args.device}) has none", file=sys.stderr)
        return 2
    if args.device != "cpu":
        # every kernel library built here, once: no server, subprocess or
        # timed window runs nvcc
        from byzantinerandomizedconsensus_tpu_torch.ops import _build

        _build.build()
    # The rejection/fairness/cancel gates read the live metrics plane.
    _metrics.configure()
    args.reference = _loadgen.plain_reference(args.device)
    args.policy_spec = args.policy  # the serve-subprocess spelling
    args.policy = _compaction.CompactionPolicy.parse(args.policy)
    print(f"hostile: {args.backend} on {args.device}, {args.leg} leg (kernel "
          f"{args.kernel or 'by law'}), every reply against the plain driver "
          f"on {args.device}")

    if args.scenario == "elastic" or args.scenario in ELASTIC_SCENARIOS:
        return _elastic_main(args)
    if preempt:
        return _preempt_main(args)

    names = SCENARIOS if args.scenario == "all" else (args.scenario,)
    out = pathlib.Path(args.out or default_artifact("hostile"))
    out.parent.mkdir(parents=True, exist_ok=True)

    t0 = time.perf_counter()
    rows = []
    for i, name in enumerate(names):
        seed = args.seed * 100 + i
        print(f"hostile: [{name}] seed {seed} …")
        row = _RUNNERS[name](args, seed)
        rows.append(row)
        print(f"hostile: [{name}] replied {row['replied']}/{row['requests']}"
              f", rejected {row['rejected']}, cancelled {row['cancelled']}, "
              f"mismatches {row['mismatches']}, steady compiles "
              f"{row['steady_state_compiles']}, "
              f"slo {'OK' if row['slo_ok'] else 'BREACH'}")

    hit_rates = [r["deadline_hit_rate"] for r in rows
                 if r.get("deadline_hit_rate") is not None]
    fairness = next((r["fairness"] for r in rows if "fairness" in r), None)
    stats = {
        "suite_seed": args.seed,
        "generator_version": HOSTILE_GENERATOR_VERSION,
        "scenarios": rows,
        "rejected_overflow": int(_counter_total(
            "brc_serve_rejected_total", reason="overflow")),
        "mismatches": sum(r["mismatches"] for r in rows),
        "steady_state_compiles": sum(r["steady_state_compiles"]
                                     for r in rows),
        "duration_s": round(time.perf_counter() - t0, 3),
        "deadline_hit_rate": hit_rates[0] if hit_rates else None,
        "fairness": fairness,
    }

    doc = {
        **record.new_record(
            "hostile",
            description="Hostile-load suite: seeded adversarial traffic "
                        "(flash crowd, heavy tail, bucket churn, tenant "
                        "hog, cancel storm, session hog) through the "
                        "bounded continuous-batching consensus service."),
        "seed": args.seed,
        "smoke": bool(args.smoke),
        "backend": args.backend,
        "device": args.device,
        "kernel": args.kernel,
        "leg": args.leg,
        "policy": args.policy.doc(),
        "round_cap_ceiling": ROUND_CAP_CEILING,
        "hostile": record.hostile_block(stats),
    }
    problems = record.validate_record(doc)
    if problems:
        print(f"hostile: INVALID RECORD: {problems}", file=sys.stderr)
        return 3
    out.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"hostile: wrote {out}")

    if stats["mismatches"]:
        print("hostile: DIFFERENTIAL MISMATCH", file=sys.stderr)
        return 1
    if stats["steady_state_compiles"]:
        print("hostile: STEADY-STATE RECOMPILES", file=sys.stderr)
        return 2
    if fairness is not None and not fairness["ok"]:
        print(f"hostile: FAIRNESS BREACH: {fairness}", file=sys.stderr)
        return 4
    if not all(r["slo_ok"] for r in rows):
        print("hostile: SCENARIO SLO BREACH", file=sys.stderr)
        return 5
    if "flash_crowd" in names and stats["rejected_overflow"] == 0:
        print("hostile: backpressure never engaged (0 overflow "
              "rejections)", file=sys.stderr)
        return 6
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
