"""Open-loop load generator for the consensus service.

The port's copy of the reference ``tools/loadgen.py``. It drives an
in-process :class:`~byzantinerandomizedconsensus_tpu_torch.serve.server
.ConsensusServer` (or, with ``--workers``, a fleet of worker processes)
with a *seeded, reproducible* request stream and writes the serving
record: p50/p99 request latency (``utils/metrics.percentiles``), burst
configs/s, time to first result, and the build counter proving **nothing
is built at steady state**.

The stream is open-loop (arrivals do not wait for replies): seeded Poisson
gaps (``rng.expovariate``) over a heterogeneous population, generator v3,
draw for draw the reference's (the same ``stream_digest`` at every seed):

- ~50% **chaos-like schedules**: ``soak.random_config(rng, chaos=True)``,
  the whole semantic surface with the spec-§9 fault axis;
- ~30% **keys-model validation traffic**: small-n, adversary-free keys
  configs;
- ~20% **fat-tailed adversarial shapes**: lying adversaries at the large
  end of the soak range, heavy instance counts, the longest admitted
  ``round_cap``;
- a seeded ~15% of them become spec-§11 **sessions** (2..8 chained
  decision slots, the ``session_slots`` envelope key).

**Legs.** The server's leg follows its backend's kernel (``--kernel``, as
``cli serve`` takes it). With none named, the **direct leg** runs each
request as one ``backend.run`` on the card, the kernel chosen by law: the
fused round kernel under urn, urn2, urn3 and committee and under every §9
schedule outside keys, the per-step keys kernel under keys, the plain
driver for keys under a schedule. ``--kernel step`` runs the per-step
kernels (keys and urn without a schedule); ``--kernel fused`` the round
kernel; a stream request outside the named kernel's surface is left out of
the drive, counted by reason in the record's ``unsupported`` block (the
digest is still the whole stream's). ``--kernel plain`` takes the **lane
leg**, the compacted lane grid over the plain round driver, which is the
only kernel of ``--device cpu``.

Phases:

1. **warm-up**: per distinct bucket a same-bucket burst, chained bucket to
   bucket so every rotation's drain runs too; on the direct leg also one
   stream request per kernel library the stream needs, so every library is
   loaded before the measured legs;
2. **burst leg**: the whole population submitted at once (configs/s at
   capacity);
3. **open-loop leg**: the population re-submitted on its Poisson schedule
   (latency percentiles, time to first result);
4. **steady-state check**: ``ConsensusServer.compile_count()`` after the
   legs minus its value after the warm-up (kernel libraries loaded on the
   direct leg, lane-program builds on the lane leg); the exit code
   enforces 0;
5. **offline leg** (best-of walls): on the lane leg ``run_fused`` over the
   population, as the reference; on the direct leg one ``backend.run`` per
   config with the same kernel (``run_fused`` runs the plain driver only);
6. **differential**: every open-loop reply against the per-config run of
   the plain driver on the same device (``kernel="plain"``, independent of
   the kernels), bit for bit; a session reply is also replayed slot by slot
   from its base seed (``models/session.py``).

**Fleet mode** (``--workers 1,2``): the same stream through
:class:`~byzantinerandomizedconsensus_tpu_torch.serve.fleet.FleetServer`
at each worker count (worker processes on ``--device``, bucket affinity,
stealing; ``--migrate`` moves lanes or unstarted requests). The stream
never depends on the worker count (:func:`fleet_request_stream`); every
worker is warmed on every bucket (``pin_worker``), the zero-build pin is
per worker, and every reply of every leg is held against the plain driver.

**SLO gate** (``--slo-p99-ms``, ``--slo-error-rate``): a live
``serve_http`` endpoint on an ephemeral port is scraped at every phase
boundary (``GET /metrics``), and the final scrape is enforced by exit code
(in fleet mode at every worker count).

**Session bench** (``--session-bench``): K sessions of L chained slots
against K clients each submitting L dependent single requests; the ratio
of the two legs' decisions/s is the amortization ratio, every session
replayed from its base seed and compared slot for slot with the
independent leg.

**Hostile and elastic drills** (``--scenario NAME``): the whole
invocation goes to ``tools/hostile.py``, with its own flags and exit
ladder.

    python -m byzantinerandomizedconsensus_tpu_torch.cli loadgen
    python -m byzantinerandomizedconsensus_tpu_torch.cli loadgen --smoke --kernel plain
    python -m byzantinerandomizedconsensus_tpu_torch.cli loadgen --workers 1,2 --smoke
    python -m byzantinerandomizedconsensus_tpu_torch.cli loadgen --smoke --device cpu --no-offline

Exit codes: 1 differential mismatch (a session replay or cross-leg
mismatch included), 2 steady-state builds (or no card with ``--device
cuda``, named), 3 invalid record or bad flags, 4 fleet scaling below
``--min-scaling`` or session amortization below ``--min-amortization``, 5
SLO breach, 6 a stream request failed.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import hashlib
import json
import pathlib
import random
import sys
import threading
import time

import numpy as np

from byzantinerandomizedconsensus_tpu_torch.backends import compaction as _compaction
from byzantinerandomizedconsensus_tpu_torch.cli import make_backend
from byzantinerandomizedconsensus_tpu_torch.config import DELIVERY_KINDS, SimConfig
from byzantinerandomizedconsensus_tpu_torch.obs import metrics as _metrics
from byzantinerandomizedconsensus_tpu_torch.obs import programs as _programs
from byzantinerandomizedconsensus_tpu_torch.obs import record
from byzantinerandomizedconsensus_tpu_torch.obs import trace as _trace
from byzantinerandomizedconsensus_tpu_torch.tools import soak
from byzantinerandomizedconsensus_tpu_torch.utils import metrics
from byzantinerandomizedconsensus_tpu_torch.utils.rounds import default_artifact

# Bumped whenever the draw sequence below changes shape: a serving
# record's request stream is reproducible only by (generator_version,
# seed, requests, rate) together. v2: fat-tail instance draws capped at
# one grid wave (64 lanes). v3: a seeded ~15% of requests become spec-§11
# sessions (2..8 chained slots), and the digest covers the slot counts.
GENERATOR_VERSION = 3

#: The admitted round_cap ceiling (as serve/server.py's default): every
#: population draw stays at or under it by construction.
ROUND_CAP_CEILING = 128

_MIX = (("chaos", 0.5), ("keys", 0.3), ("fat_tail", 0.2))

#: Generator-v3 session mix: the fraction of stream items that become
#: sessions, and the slot-count draws; drawn AFTER the config.
_SESSION_RATE = 0.15
_SESSION_SLOTS = (2, 3, 4, 6, 8)

#: Seconds a client waits for any one reply.
REPLY_TIMEOUT_S = 1800.0


def _keys_config(rng: random.Random) -> SimConfig:
    """Small-n keys-model validation traffic: adversary-free, short caps."""
    protocol = rng.choice(("benor", "bracha"))
    n = rng.randrange(4, 12)
    fmax = soak._f_ceiling(protocol, "none", n)
    return SimConfig(
        protocol=protocol, n=n, f=rng.randrange(0, fmax + 1),
        instances=rng.randrange(4, 17), adversary="none",
        coin=rng.choice(("local", "shared")),
        init=rng.choice(("random", "all0", "all1", "split")),
        seed=rng.randrange(1 << 32),
        round_cap=rng.choice((32, 64)), delivery="keys").validate()


def _fat_tail_config(rng: random.Random) -> SimConfig:
    """Lying adversaries, heavy instance counts, the longest admitted cap;
    instances at or under one default-width grid wave (64)."""
    n = rng.randrange(16, soak.MAX_SOAK_N + 1)
    adversary = rng.choice(("byzantine", "adaptive", "adaptive_min"))
    fmax = soak._f_ceiling("bracha", adversary, n)
    return SimConfig(
        protocol="bracha", n=n, f=rng.randrange(1, fmax + 1),
        instances=rng.choice((16, 24, 32, 48, 64)), adversary=adversary,
        coin=rng.choice(("local", "shared")),
        init=rng.choice(("random", "all0", "all1", "split")),
        seed=rng.randrange(1 << 32),
        round_cap=ROUND_CAP_CEILING,
        delivery=rng.choice(DELIVERY_KINDS)).validate()


def request_stream(requests: int, seed: int, rate: float) -> list:
    """The seeded open-loop request stream:
    ``[(arrival_s, SimConfig, session_slots)]``.

    A pure function of its arguments (and GENERATOR_VERSION): one
    ``random.Random(seed)`` drives the Poisson gaps, the population draws
    and the session slot counts, interleaved in the reference's order.
    ``session_slots`` is 1 for an ordinary request."""
    rng = random.Random(seed)
    t = 0.0
    out = []
    for _ in range(requests):
        t += rng.expovariate(rate)
        u = rng.random()
        if u < _MIX[0][1]:
            cfg = soak.random_config(rng, chaos=True)
        elif u < _MIX[0][1] + _MIX[1][1]:
            cfg = _keys_config(rng)
        else:
            cfg = _fat_tail_config(rng)
        slots = (rng.choice(_SESSION_SLOTS)
                 if rng.random() < _SESSION_RATE else 1)
        out.append((t, cfg, slots))
    return out


def fleet_request_stream(requests: int, seed: int, rate: float,
                         workers: int = 1) -> list:
    """The fleet-mode stream: *identical* to :func:`request_stream` for
    every ``workers`` value (worker count is placement, never population)."""
    if workers < 1:
        raise ValueError(f"workers={workers} out of range (>= 1)")
    return request_stream(requests, seed, rate)


def stream_digest(stream) -> str:
    """sha256 over the canonical JSON of the stream: arrival times, configs
    and session slot counts."""
    doc = [[round(t, 9), dataclasses.asdict(cfg), int(slots)]
           for t, cfg, slots in stream]
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def reply_digest(rec: dict) -> str:
    """A short digest of one reply's per-instance results (with the session
    log's slots, when it has one): two legs' replies to the same request
    are equal exactly when their digests are."""
    doc = [rec["rounds"], rec["decision"]]
    if rec.get("session"):
        doc.append([rec["session"]["rounds"], rec["session"]["decisions"]])
    return hashlib.sha256(json.dumps(doc).encode()).hexdigest()[:16]


# -- the device and the backend --------------------------------------------

def library_of(backend, cfg):
    """The CUDA library a direct-leg run of ``cfg`` loads, or None (the
    plain driver, or a backend without kernels)."""
    kernel_for = getattr(backend, "kernel_for", None)
    if kernel_for is None:
        return None
    kernel = kernel_for(cfg)
    if kernel == "fused":
        from byzantinerandomizedconsensus_tpu_torch.ops import fused_round

        return fused_round.library(cfg)
    if kernel == "step":
        from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import (
            STEP_KERNELS)
        from byzantinerandomizedconsensus_tpu_torch.ops import _step

        return _step.library(STEP_KERNELS[cfg.delivery][0], cfg)
    return None


def supported_split(backend, stream):
    """``(served, unsupported)``: the stream items the backend's kernel
    runs, and a count by reason of those it refuses by name (a named
    kernel's surface; with the kernel by law every stream request runs)."""
    check = getattr(backend, "check_supported", None)
    served, refused = [], collections.Counter()
    for item in stream:
        try:
            if check is not None:
                check(item[1])
        except Exception as e:  # noqa: BLE001 — the refusal is the record
            refused[f"{type(e).__name__}: {item[1].delivery}/faults={item[1].faults}"] += 1
            continue
        served.append(item)
    return served, dict(sorted(refused.items()))


def launch_counts() -> dict:
    """The kernels' launch counters (each wrapper adds one per launch)."""
    from byzantinerandomizedconsensus_tpu_torch.ops import fused_round, keys_step, urn_step

    return {"fused_round": fused_round.launches, "keys_step": keys_step.launches,
            "urn_step": urn_step.launches}


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


# -- warm-up -----------------------------------------------------------------

def _warm_bucket_config(bucket, seq: int) -> SimConfig:
    """A representative config of ``bucket`` for the warm-up burst: enough
    instances to overflow the grid width (the refill) and the ceiling cap
    (rotation closes catch live lanes: the drain)."""
    n = min(7, bucket.n_pad)
    return SimConfig(
        protocol=bucket.protocol, n=n, f=1, instances=32,
        adversary="none", coin="local", init="random", seed=1000 + seq,
        round_cap=ROUND_CAP_CEILING, delivery=bucket.delivery).validate()


def library_configs(backend, cfgs) -> list:
    """One config per kernel library the direct leg loads for ``cfgs``
    (the first that needs it), so a warm-up loads every library."""
    seen, out = set(), []
    for cfg in cfgs:
        lib = library_of(backend, cfg)
        if lib is not None and lib not in seen:
            seen.add(lib)
            out.append(cfg)
    return out


def close_grids_live(server, buckets, make_cfg, seq: int) -> list:
    """Close EVERY bucket's grid while its lanes are live: one config per
    bucket, the next bucket's closer submitted only once the previous one
    is dispatched, so each rotation catches live lanes and builds that
    bucket's drain program (a closer submitted too early would join the
    still-active grid instead of forcing a rotation). The lane leg's
    warm-up ends with it, so no drain is first built at steady state.
    Returns the closers' handles, waited for."""
    if len(buckets) < 2:
        return []
    closers = [server.submit(make_cfg(buckets[0], seq))]
    seq += 1
    for bucket in list(buckets[1:]) + [buckets[0]]:
        t0 = time.monotonic()
        while closers[-1].t_dispatch is None and time.monotonic() - t0 < 600.0:
            time.sleep(0.005)
        closers.append(server.submit(make_cfg(bucket, seq)))
        seq += 1
    _wait_all(closers)
    return closers


def warm_up(server, buckets, burst: int = 6, extra=()) -> list:
    """Build or load every steady-state program: per bucket a same-bucket
    burst, each next bucket's burst rotating the previous grid closed
    mid-flight (drain); the final grid closed by one more first-bucket
    request; then ``extra`` (the direct leg's one config per library). On
    the lane leg every grid is then closed live once more
    (:func:`close_grids_live`): whether a burst's rotation caught live
    lanes depends on timing; there the backend's program cache is first
    sized to hold every bucket's programs. Returns the handles, waited
    for."""
    if server.leg == "lanes":
        _compaction.reserve_programs(server._backend, buckets)
    handles = []
    seq = 0
    for bucket in buckets:
        for _ in range(burst):
            handles.append(server.submit(_warm_bucket_config(bucket, seq)))
            seq += 1
    if buckets:
        handles.append(server.submit(_warm_bucket_config(buckets[0], seq)))
        seq += 1
    handles += [server.submit(cfg) for cfg in extra]
    _wait_all(handles)
    if server.leg == "lanes":
        handles += close_grids_live(server, buckets, _warm_bucket_config, seq)
    return handles


def warm_up_fleet(fleet, buckets, burst: int = 6, extra=()) -> list:
    """:func:`warm_up`'s chaining replayed on *every* worker through
    ``pin_worker`` (stealing can land any bucket anywhere, so the
    per-worker zero-build pin needs every program warm everywhere)."""
    handles = []
    seq = 0
    for w in range(fleet._n_workers):
        for bucket in buckets:
            for _ in range(burst):
                handles.append(fleet.submit(_warm_bucket_config(bucket, seq),
                                            pin_worker=w))
                seq += 1
        if buckets:
            handles.append(fleet.submit(
                _warm_bucket_config(buckets[0], seq), pin_worker=w))
            seq += 1
        handles += [fleet.submit(cfg, pin_worker=w) for cfg in extra]
    return handles


def _wait_all(handles, timeout: float = REPLY_TIMEOUT_S) -> None:
    for h in handles:
        h.wait(timeout=timeout)


# -- the legs ----------------------------------------------------------------

def _latency_ms(handles) -> list:
    return [h.latency_s * 1000.0 for h in handles]


def _leg_metrics(handles, t0: float, t_first_reply, t_last_reply) -> dict:
    lats = _latency_ms(handles)
    p50, p99 = metrics.percentiles(lats, (50, 99))
    span = (t_last_reply - t0) if t_last_reply else None
    return {
        "requests": len(handles),
        "latency_ms": ({"p50": round(p50, 3), "p99": round(p99, 3),
                        "mean": round(float(np.mean(lats)), 3)} if lats
                       else {"p50": None, "p99": None, "mean": None}),
        "throughput_cps": (round(len(handles) / span, 3)
                           if span and span > 0 else None),
        "time_to_first_result_ms": (round((t_first_reply - t0) * 1000.0, 3)
                                    if t_first_reply else None),
        "duration_s": round(span, 3) if span else None,
    }


class _MetricsEndpoint:
    """The live scrape surface of the SLO gate: a real ephemeral
    ``serve_http`` endpoint (``port=0``) around the in-process server, so
    the enforced numbers come from ``GET /metrics`` text."""

    def __init__(self, server):
        from byzantinerandomizedconsensus_tpu_torch.serve.server import serve_http

        self._httpd = serve_http(server, host="127.0.0.1", port=0)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="brc-loadgen-metrics", daemon=True)
        self._thread.start()
        host, port = self._httpd.server_address[:2]
        self.url = f"http://{host}:{port}/metrics"

    def scrape(self):
        """Parsed snapshot of the live exposition text (None on failure)."""
        return _metrics.scrape(self.url, timeout=30.0)

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


def _slo_enabled(args) -> bool:
    return args.slo_p99_ms is not None or args.slo_error_rate is not None


def _slo_verdict(args, snap) -> dict:
    """Enforce the SLO thresholds against one parsed ``/metrics`` scrape;
    a missing observation fails (an SLO that cannot be measured is not
    met)."""
    s = _metrics.summary(snap or {})
    checks = {}
    ok = True
    if args.slo_p99_ms is not None:
        got = s.get("p99_latency_ms")
        passed = got is not None and got <= args.slo_p99_ms
        checks["p99_latency_ms"] = {"limit": args.slo_p99_ms,
                                    "observed": got, "ok": passed}
        ok = ok and passed
    if args.slo_error_rate is not None:
        got = s.get("error_rate")
        passed = got is not None and got <= args.slo_error_rate
        checks["error_rate"] = {"limit": args.slo_error_rate,
                                "observed": got, "ok": passed}
        ok = ok and passed
    return {"ok": ok, "source": "GET /metrics", "checks": checks}


def _slo_print(tag: str, verdict: dict) -> None:
    parts = ", ".join(
        f"{k} {c['observed']} vs limit {c['limit']}"
        for k, c in verdict["checks"].items())
    status = "OK" if verdict["ok"] else "BREACH"
    print(f"loadgen: SLO {status} [{tag}]: {parts}")


def _drive(server, stream, open_loop: bool):
    """Submit the stream (on its arrival schedule, or all at once) and wait
    for every reply. Returns the leg metrics and the reply handles."""
    t_first_reply = [None]
    t_last_reply = [None]
    lock = threading.Lock()

    def on_done(_req):
        now = time.perf_counter()
        with lock:
            if t_first_reply[0] is None:
                t_first_reply[0] = now
            t_last_reply[0] = now

    server._on_reply = on_done
    t0 = time.perf_counter()
    handles = []
    for arrival, cfg, slots in stream:
        if open_loop:
            delay = t0 + arrival - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
        # session_slots rides as an envelope key next to the config fields
        payload = (cfg if slots == 1
                   else {**dataclasses.asdict(cfg), "session_slots": slots})
        handles.append(server.submit(payload))
    for h in handles:
        h.done.wait(timeout=REPLY_TIMEOUT_S)
    server._on_reply = None
    leg = _leg_metrics([h for h in handles if h.record is not None], t0,
                       t_first_reply[0], t_last_reply[0])
    leg["mode"] = "open_loop" if open_loop else "burst"
    leg["failed"] = sum(1 for h in handles if h.record is None)
    return leg, handles


def _failures(handles) -> list:
    return [{"request_id": h.id, "error": h.error} for h in handles
            if h.record is None][:10]


def _offline_leg(backend, cfgs, reps: int, lanes: bool) -> dict:
    """The offline comparison over the same population, best of ``reps``
    walls: ``run_fused`` on the lane leg (the reference's), one
    ``backend.run`` per config on the direct leg (the same kernels)."""
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        if lanes:
            backend.run_fused(cfgs)
        else:
            for cfg in cfgs:
                backend.run(cfg)
        walls.append(time.perf_counter() - t0)
    best = min(walls)
    return {"mode": "offline_run_fused" if lanes else "offline_per_config",
            "reps": reps, "walls_s": [round(w, 6) for w in walls],
            "wall_s": round(best, 6),
            "throughput_cps": round(len(cfgs) / best, 3)}


def plain_reference(device: str):
    """The differential's reference: the plain round driver on ``device``,
    independent of the kernels."""
    from byzantinerandomizedconsensus_tpu_torch.backends.base import get_backend

    return get_backend("torch", device=device, kernel="plain")


def _differential(cfgs, handles, ref_be) -> dict:
    """Every served reply against the per-config run of ``ref_be`` (the
    plain driver), bit for bit. A session reply's top level is its slot-0
    run, so the check is uniform; a reply with a ``session`` block is also
    replayed slot by slot from the base seed (``models/session.py``).
    Mismatches are counted, never swallowed."""
    from byzantinerandomizedconsensus_tpu_torch.models import session as _session

    mismatches = []
    sessions_replayed = 0
    digests = []
    for cfg, h in zip(cfgs, handles):
        if h.record is None:
            digests.append(None)
            continue
        digests.append(reply_digest(h.record))
        ref = ref_be.run(cfg)
        if (h.record["rounds"] != [int(r) for r in ref.rounds]
                or h.record["decision"] != [int(d) for d in ref.decision]):
            mismatches.append({"request_id": h.id,
                               "config": dataclasses.asdict(cfg)})
            continue
        blk = h.record.get("session")
        if blk:
            sessions_replayed += 1
            served = list(zip(blk["rounds"], blk["decisions"]))
            if not _session.replay_matches(ref_be, cfg, served):
                mismatches.append({"request_id": h.id, "leg": "session",
                                   "config": dataclasses.asdict(cfg)})
    return {"backend": "torch", "kernel": "plain", "device": str(ref_be.device),
            "configs": len(cfgs), "sessions_replayed": sessions_replayed,
            "mismatches": len(mismatches), "detail": mismatches[:10],
            "reply_digests": digests}


def _fleet_differential(ref_be, cfgs, leg_handles) -> dict:
    """Every fleet reply (every leg, every worker count) against the
    per-config plain-driver run: routing, stealing and re-admission may
    move work anywhere, the bits must not care."""
    refs = [ref_be.run(cfg) for cfg in cfgs]
    mismatches = []
    compared = 0
    for leg_name, handles in leg_handles:
        for cfg, ref, h in zip(cfgs, refs, handles):
            compared += 1
            if (h.record is None
                    or h.record["rounds"] != [int(r) for r in ref.rounds]
                    or h.record["decision"] != [int(d) for d in ref.decision]):
                mismatches.append({"leg": leg_name, "request_id": h.id,
                                   "config": dataclasses.asdict(cfg)})
    return {"backend": "torch", "kernel": "plain", "device": str(ref_be.device),
            "mode": "per_config_plain", "configs": len(cfgs), "compared": compared,
            "mismatches": len(mismatches), "detail": mismatches[:10]}


# -- the session bench -------------------------------------------------------

#: Session-bench compaction policy (unless --policy is given): multi-round
#: segments are where the in-grid chain pays.
_SESSION_BENCH_POLICY = "width=64,segment=4"


def _session_population(sessions: int, seed: int) -> list:
    """The session-bench population: one fused bucket, short fast-deciding
    slots, seeds from one ``random.Random(seed)``."""
    rng = random.Random(seed)
    return [SimConfig(protocol="benor", n=5, f=1, instances=4,
                      adversary="none", coin="local", init="random",
                      seed=rng.randrange(1 << 32), round_cap=16,
                      delivery="keys").validate() for _ in range(sessions)]


def _session_counter(name: str) -> float:
    """Sum of a counter's series in the live registry (0.0 if untouched)."""
    ent = (_metrics.snapshot() or {}).get(name)
    if not ent:
        return 0.0
    return sum(s.get("value", 0.0) for s in ent.get("series", []))


def _run_session_bench(args, backend, policy, out) -> int:
    """The ``--session-bench`` driver: the L-slot session path against L
    dependency-honoring independent requests over the same population, the
    spec-§11 replay pin, and the session record."""
    from byzantinerandomizedconsensus_tpu_torch.models import session as _session
    from byzantinerandomizedconsensus_tpu_torch.serve import admission
    from byzantinerandomizedconsensus_tpu_torch.serve.server import ConsensusServer

    K, L = args.sessions, args.session_slots
    cfgs = _session_population(K, args.seed)
    bucket = admission.bucket_of(cfgs[0])
    _metrics.configure()  # the reseed counter is part of the record
    t_suite0 = time.perf_counter()
    print(f"loadgen: session bench — {K} sessions x {L} slots, "
          f"seed {args.seed}, bucket {bucket.label()}")

    server = ConsensusServer(backend=backend, policy=policy,
                             round_cap_ceiling=ROUND_CAP_CEILING)
    with server:
        warm_up(server, [bucket], extra=library_configs(backend, cfgs))
        pre = server.submit({**dataclasses.asdict(cfgs[0]), "session_slots": 2})
        pre.wait(timeout=REPLY_TIMEOUT_S)
        warm_compiles = server.compile_count()
        reseeds0 = _session_counter("brc_session_reseeds_total")

        # leg A: K sessions, one submit each; slots chain in the grid (on the
        # direct leg, inline in the dispatcher)
        t0 = time.perf_counter()
        sess_handles = [server.submit({**dataclasses.asdict(c),
                                       "session_slots": L}) for c in cfgs]
        _wait_all(sess_handles)
        wall_a = time.perf_counter() - t0

        # leg B: K concurrent clients, each submitting L single requests in
        # turn (slot k+1's seed needs slot k's decision)
        results_b: list = [None] * K
        errors: list = []

        def client(i: int) -> None:
            try:
                cfg = cfgs[i]
                recs = []
                for k in range(L):
                    h = server.submit(cfg)
                    h.wait(timeout=REPLY_TIMEOUT_S)
                    recs.append(h.record)
                    if k + 1 < L:
                        cfg = _session.next_slot_config(cfg, k, h.record["decision"])
                results_b[i] = recs
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(f"client {i}: {e}")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,),
                                    name=f"brc-session-indep-{i}")
                   for i in range(K)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall_b = time.perf_counter() - t0
        if errors:
            raise RuntimeError(f"independent-leg client errors: {errors}")

        steady = server.compile_count() - warm_compiles
        reseeds = int(_session_counter("brc_session_reseeds_total") - reseeds0)
        server_stats = server.stats()

    ref_be = plain_reference(args.device)
    mismatches = 0
    replay_ok = True
    for i, (cfg, h) in enumerate(zip(cfgs, sess_handles)):
        blk = h.record["session"]
        served = list(zip(blk["rounds"], blk["decisions"]))
        if not _session.replay_matches(ref_be, cfg, served):
            replay_ok = False
        for k in range(L):
            rec = results_b[i][k]
            if (blk["rounds"][k] != rec["rounds"]
                    or blk["decisions"][k] != rec["decision"]):
                mismatches += 1

    decisions = K * L * int(cfgs[0].instances)
    ratio = round(wall_b / wall_a, 3) if wall_a > 0 else None
    stats = {
        "sessions": K,
        "slots": L,
        "decisions": decisions,
        "amortization_ratio": ratio,
        "session_cps": round(decisions / wall_a, 3),
        "independent_cps": round(decisions / wall_b, 3),
        "steady_state_compiles": steady,
        "mismatches": mismatches,
        "replay_ok": replay_ok,
        "generator_version": GENERATOR_VERSION,
        "session_reseeds": reseeds,
        "population": {"bucket": bucket.label(),
                       "instances": int(cfgs[0].instances),
                       "round_cap": int(cfgs[0].round_cap)},
        "duration_s": round(time.perf_counter() - t_suite0, 3),
    }
    doc = {
        **record.new_record(
            "session",
            description="Replicated-log session bench: K sessions of L "
                        "chained decision slots against L dependency-"
                        "honoring independent requests, with the offline "
                        "replay pin."),
        "seed": args.seed,
        "backend": args.backend,
        "device": args.device,
        "kernel": args.kernel,
        "leg": server.leg,
        "policy": policy.doc(),
        "session": record.session_block(stats),
        "legs": {
            "session": {"mode": "session", "wall_s": round(wall_a, 6),
                        "throughput_cps": round(decisions / wall_a, 3)},
            "independent": {"mode": "independent_chained",
                            "wall_s": round(wall_b, 6),
                            "throughput_cps": round(decisions / wall_b, 3)},
        },
        "compile_cache": server_stats["compile_cache"],
    }
    problems = record.validate_record(doc)
    if problems:
        print(f"loadgen: INVALID RECORD: {problems}", file=sys.stderr)
        return 3
    out.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"loadgen: wrote {out}")
    print(f"loadgen: session {stats['session_cps']} dec/s vs independent "
          f"{stats['independent_cps']} dec/s — amortization x{ratio}, "
          f"{reseeds} in-grid reseeds, {steady} steady-state builds, "
          f"{mismatches} mismatches, replay {'OK' if replay_ok else 'FAIL'}")
    if mismatches or not replay_ok:
        return 1
    if steady:
        return 2
    if args.min_amortization is not None and ratio is not None \
            and ratio < args.min_amortization:
        print(f"loadgen: amortization {ratio} below --min-amortization "
              f"{args.min_amortization}", file=sys.stderr)
        return 4
    return 0


# -- the fleet ---------------------------------------------------------------

def _fleet_leg(args, policy, k: int, stream, buckets, extra,
               headline: bool, trace_dir) -> dict:
    """One worker-count leg: spawn a k-worker fleet, warm every bucket and
    library on every worker, run the burst (and, on the headline leg, the
    open-loop) stream, and snapshot the per-worker counters. Returns the
    leg doc and the reply handles for the differential."""
    from byzantinerandomizedconsensus_tpu_torch.serve.fleet import FleetServer

    if _slo_enabled(args):
        # a fresh registry per worker count: each leg's scrape answers for
        # its own width only
        _metrics.configure()
    fleet = FleetServer(
        workers=k, mode="process", backend=args.backend, policy=policy,
        round_cap_ceiling=ROUND_CAP_CEILING, trace_dir=trace_dir,
        segment_latency_s=args.fleet_latency_ms / 1000.0,
        rotation_cap=args.rotation_cap, migrate=args.migrate,
        device=args.device, kernel=args.kernel)
    with fleet:
        endpoint = _MetricsEndpoint(fleet) if _slo_enabled(args) else None
        phase_scrapes = {}
        t0 = time.perf_counter()
        warm_handles = warm_up_fleet(fleet, buckets, extra=extra)
        _wait_all(warm_handles)
        warm_counts = [c or 0 for c in fleet.compile_counts()]
        warm_s = time.perf_counter() - t0
        print(f"loadgen: fleet x{k} warm-up {len(warm_handles)} requests, "
              f"builds/worker {warm_counts}, {warm_s:.1f}s")
        if endpoint:
            phase_scrapes["warm_up"] = _metrics.summary(endpoint.scrape() or {})

        pre = {r["worker"]: r["replied"]
               for r in fleet.stats(live=False)["per_worker"]}
        burst_leg, burst_handles = _drive(fleet, stream, open_loop=False)
        burst_replied = {r["worker"]: r["replied"] - pre.get(r["worker"], 0)
                         for r in fleet.stats(live=False)["per_worker"]}
        print(f"loadgen: fleet x{k} burst {burst_leg['throughput_cps']} "
              f"cfg/s (per-worker replied {burst_replied})")
        if endpoint:
            phase_scrapes["burst"] = _metrics.summary(endpoint.scrape() or {})

        open_leg = open_handles = None
        if headline:
            open_leg, open_handles = _drive(fleet, stream, open_loop=True)
            print(f"loadgen: fleet x{k} open-loop "
                  f"p50 {open_leg['latency_ms']['p50']}ms "
                  f"p99 {open_leg['latency_ms']['p99']}ms")

        steady = [(c or 0) - w for c, w in zip(fleet.compile_counts(), warm_counts)]
        stats = fleet.stats()
        final_snap = None
        if endpoint:
            final_snap = endpoint.scrape()
            phase_scrapes["open_loop" if headline else "burst_final"] = (
                _metrics.summary(final_snap or {}))
            endpoint.close()
    span = burst_leg["duration_s"] or 0.0
    per_worker = []
    for row in stats["per_worker"]:
        w = row["worker"]
        server = row.get("server") or {}
        per_worker.append({
            "worker": w,
            "pid": row["pid"],
            "replied": row["replied"],
            "burst_replied": burst_replied.get(w, 0),
            "cfg_per_s": (round(burst_replied.get(w, 0) / span, 3)
                          if span > 0 else None),
            "steals": row["steals"],
            "warmup_compiles": warm_counts[w] if w < len(warm_counts) else None,
            "steady_state_compiles": steady[w] if w < len(steady) else None,
            "leg": row.get("leg"),
            "device": row.get("device"),
            "launches": server.get("launches"),
        })
    return {
        "workers": k,
        "warmup": {"requests": len(warm_handles),
                   "compiles_per_worker": warm_counts,
                   "wall_s": round(warm_s, 3)},
        "burst": burst_leg,
        "open_loop": open_leg,
        "per_worker": per_worker,
        "steady_state_compiles": steady,
        "steals": stats["steals"],
        "migrations": stats.get("migrations", 0),
        "lanes_migrated": stats.get("lanes_migrated", 0),
        "readmitted": stats["readmitted"],
        "lost_workers": stats["lost_workers"],
        "stats": stats,
        "metrics_scrapes": phase_scrapes or None,
        "_snap": final_snap,
        "_handles": [("burst", burst_handles)]
                    + ([("open_loop", open_handles)] if open_handles else []),
    }


def _run_fleet(args, policy, backend, workers_list, stream, digest, cfgs,
               buckets, unsupported, out, trace_path) -> int:
    """The ``--workers`` driver: one leg per worker count (the last is the
    headline), the fleet-wide differential, and the fleet record."""
    import shutil
    import tempfile

    legs = {}
    leg_handles = []
    trace_dir = None
    headline_k = workers_list[-1]
    extra = library_configs(backend, cfgs)
    for i, k in enumerate(workers_list):
        headline = i == len(workers_list) - 1
        this_dir = None
        if headline and args.trace:
            trace_dir = tempfile.mkdtemp(prefix="brc-fleet-trace-")
            this_dir = trace_dir
            _trace.configure(out_dir=this_dir, role="fleet-coord")
        leg = _fleet_leg(args, policy, k, stream, buckets, extra,
                         headline=headline, trace_dir=this_dir)
        for name, handles in leg.pop("_handles"):
            leg_handles.append((f"x{k}/{name}", handles))
        legs[str(k)] = leg
    head = legs[str(headline_k)]

    slo = None
    head_snap = None
    if _slo_enabled(args):
        per_width = {}
        all_ok = True
        for k in workers_list:
            snap = legs[str(k)].pop("_snap", None)
            v = _slo_verdict(args, snap)
            _slo_print(f"x{k}", v)
            per_width[str(k)] = v
            all_ok = all_ok and v["ok"]
            if k == headline_k:
                head_snap = snap
        slo = {"ok": all_ok, "source": "GET /metrics",
               "checks": per_width[str(headline_k)]["checks"],
               "per_width": per_width}
    else:
        for k in workers_list:
            legs[str(k)].pop("_snap", None)

    differential = _fleet_differential(plain_reference(args.device), cfgs, leg_handles)
    failed = sum(1 for _, hs in leg_handles for h in hs if h.record is None)

    fleet_stats = {
        "workers": headline_k,
        "arrival_seed": args.seed,
        "admission_policy": {"mode": "fused-compaction",
                             "policy": policy.doc(),
                             "round_cap_ceiling": ROUND_CAP_CEILING},
        "requests": len(cfgs),
        "latency_ms": (head["open_loop"] or head["burst"])["latency_ms"],
        "throughput_cps": head["burst"]["throughput_cps"],
        "steady_state_compiles": sum(head["steady_state_compiles"]),
        "steals": head["steals"],
        "migrations": head["migrations"],
        "lanes_migrated": head["lanes_migrated"],
        "readmitted": head["readmitted"],
        "lost_workers": head["lost_workers"],
        "per_worker": head["per_worker"],
        "warmup_compiles": sum(head["warmup"]["compiles_per_worker"]),
        "duration_s": (head["open_loop"] or head["burst"])["duration_s"],
        "population": {"buckets": len(buckets),
                       "mix": {k_: w for k_, w in _MIX}},
        "fabric_latency_ms": args.fleet_latency_ms,
        "rotation_cap": args.rotation_cap,
        "placement": head["stats"].get("placement"),
    }
    scaling = {str(k): {"workers": k,
                        "throughput_cps": legs[str(k)]["burst"]["throughput_cps"],
                        "steady_state_compiles": legs[str(k)]["steady_state_compiles"],
                        "steals": legs[str(k)]["steals"],
                        "migrations": legs[str(k)]["migrations"],
                        "stream_digest": digest}
               for k in workers_list}
    doc = {
        **record.new_record(
            "serve_fleet",
            description="Fleet serving run: the seeded open-loop stream "
                        "through the worker processes at each worker count "
                        "(bucket affinity, stealing, per-worker build pins)."),
        "generator_version": GENERATOR_VERSION,
        "seed": args.seed,
        "rate": args.rate,
        "requests": args.requests,
        "stream_digest": digest,
        "backend": args.backend,
        "device": args.device,
        "kernel": args.kernel,
        "unsupported": unsupported,
        "workers_swept": workers_list,
        "fleet": record.fleet_block(fleet_stats),
        "scaling": scaling,
        "legs": {k: {kk: v for kk, v in leg.items() if kk != "stats"}
                 for k, leg in legs.items()},
        "differential": differential,
    }
    if "1" in legs and str(headline_k) != "1":
        base = legs["1"]["burst"]["throughput_cps"]
        peak = head["burst"]["throughput_cps"]
        doc["summary"] = {
            f"scaling_{headline_k}w_vs_1w": (round(peak / base, 3) if base else None)}
    if slo is not None:
        blk = record.metrics_block(head_snap, slo=slo)
        if blk is not None:
            doc["metrics"] = blk
    if args.trace and trace_dir is not None:
        _trace.disable()
        merged = _trace.merge(trace_dir)
        shutil.move(str(merged), trace_path)
        shutil.rmtree(trace_dir, ignore_errors=True)
        blk = record.trace_block(trace_path)
        if blk is not None:
            doc["trace"] = blk

    problems = record.validate_record(doc)
    if problems:
        print(f"loadgen: INVALID RECORD: {problems}", file=sys.stderr)
        return 3
    out.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"loadgen: wrote {out}")
    steady_total = sum(sum(leg["steady_state_compiles"]) for leg in legs.values())
    scale_note = ""
    if doc.get("summary"):
        scale_note = (f", scaling {list(doc['summary'].values())[0]}x "
                      f"({headline_k}w vs 1w)")
    print(f"loadgen: fleet steady-state builds {steady_total}, "
          f"steals {head['steals']}, migrations {head['migrations']} "
          f"({head['lanes_migrated']} lanes), failed {failed}, differential "
          f"mismatches {differential['mismatches']}{scale_note}")
    if differential["mismatches"]:
        return 1
    if steady_total:
        return 2
    if failed:
        return 6
    if args.min_scaling is not None and doc.get("summary"):
        if list(doc["summary"].values())[0] < args.min_scaling:
            print(f"loadgen: fleet scaling below --min-scaling "
                  f"{args.min_scaling}", file=sys.stderr)
            return 4
    if slo is not None and not slo["ok"]:
        print("loadgen: SLO BREACH (see per-width checks above)", file=sys.stderr)
        return 5
    return 0


# -- main --------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import KERNELS

    ap = argparse.ArgumentParser(
        prog="byzantinerandomizedconsensus_tpu_torch.cli loadgen",
        description="Seeded open-loop load generator for cli serve: drives "
                    "an in-process server (or a fleet) and writes the serving "
                    "record (latency percentiles, configs/s, zero steady-state "
                    "builds, the differential). --scenario NAME runs the "
                    "hostile and elastic drills (tools/hostile.py).")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--seed", type=int, default=14)
    ap.add_argument("--rate", type=float, default=4.0,
                    help="open-loop Poisson arrival rate, requests/sec")
    ap.add_argument("--backend", default="torch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits 2 with no card) or cpu")
    ap.add_argument("--kernel", choices=KERNELS, default=None,
                    help="fused or step: the direct leg through that kernel "
                         "(stream requests outside its surface are left out, "
                         "counted by reason); plain: the lane leg; none named "
                         "(default): the direct leg, the kernel by law")
    ap.add_argument("--policy", default="width=64,segment=1",
                    help="compaction policy spec (CompactionPolicy.parse)")
    ap.add_argument("--reps", type=int, default=2,
                    help="offline-leg timing repetitions (best-of)")
    ap.add_argument("--out", default=None,
                    help=f"record path (default {default_artifact('serve')})")
    ap.add_argument("--trace", action="store_true",
                    help="write the serve trace JSONL next to the record")
    ap.add_argument("--no-offline", action="store_true",
                    help="skip the offline comparison leg")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny fast run: 24 requests, 1 rep")
    ap.add_argument("--workers", default="1",
                    help="worker counts, comma-separated (e.g. 1,2): anything "
                         "beyond a bare 1 sweeps the fleet (serve/fleet.py) at "
                         "each count, the last the headline leg; the stream "
                         "never depends on it")
    ap.add_argument("--fleet-latency-ms", type=float, default=0.0,
                    help="fleet mode: synthetic per-segment latency injected "
                         "through the workers' segment hook (the lane leg)")
    ap.add_argument("--min-scaling", type=float, default=None,
                    help="fleet mode: exit 4 if headline-vs-1-worker burst "
                         "scaling falls below this factor")
    ap.add_argument("--slo-p99-ms", type=float, default=None,
                    help="enforce p99 request latency (ms) against a live "
                         "GET /metrics scrape (every worker count in fleet "
                         "mode); breach = exit 5")
    ap.add_argument("--slo-error-rate", type=float, default=None,
                    help="enforce failed/(replied+failed) against the same "
                         "live /metrics scrape; breach = exit 5")
    ap.add_argument("--session-bench", action="store_true",
                    help="run the replicated-log session bench instead of "
                         "the open-loop stream")
    ap.add_argument("--sessions", type=int, default=8,
                    help="session bench: number of sessions (K)")
    ap.add_argument("--session-slots", type=int, default=12,
                    help="session bench: chained decision slots per session (L)")
    ap.add_argument("--min-amortization", type=float, default=1.5,
                    help="session bench: exit 4 if the session-vs-independent "
                         "decisions/s ratio falls below this")
    ap.add_argument("--migrate", action="store_true",
                    help="fleet mode: an idle worker imports serialized lanes "
                         "(lane leg) or unstarted requests (direct leg) from "
                         "the busiest one")
    ap.add_argument("--rotation-cap", type=int, default=64,
                    help="fleet mode: max instance-lanes per dispatched "
                         "rotation (0 = unbounded)")
    return ap


def main(argv=None) -> int:
    raw = sys.argv[1:] if argv is None else list(argv)
    if any(a == "--scenario" or a.startswith("--scenario=") for a in raw):
        # the hostile-load suite owns its flags: the whole argv goes there
        from byzantinerandomizedconsensus_tpu_torch.tools import hostile

        return hostile.main(raw)
    args = build_parser().parse_args(argv)

    if args.smoke:
        args.requests = min(args.requests, 24)
        args.reps = 1
        args.sessions = min(args.sessions, 3)
        args.session_slots = min(args.session_slots, 4)

    try:
        workers_list = [int(x) for x in str(args.workers).split(",") if x.strip()]
    except ValueError:
        print(f"loadgen: bad --workers {args.workers!r}", file=sys.stderr)
        return 3
    if not workers_list or any(k < 1 for k in workers_list):
        print(f"loadgen: bad --workers {args.workers!r}", file=sys.stderr)
        return 3
    args.rotation_cap = args.rotation_cap if args.rotation_cap > 0 else None
    fleet_mode = workers_list != [1]
    try:
        # on a card unless --device cpu: with none present this raises by
        # name, and nothing falls back to the CPU
        backend = make_backend(args.backend, args.device, args.kernel)
    except (KeyError, RuntimeError, ValueError) as e:
        print(f"loadgen: {e}", file=sys.stderr)
        return 2
    _programs.maybe_enable_from_env()

    if args.session_bench:
        if not any(a == "--policy" or a.startswith("--policy=") for a in raw):
            args.policy = _SESSION_BENCH_POLICY
        policy = _compaction.CompactionPolicy.parse(args.policy)
        out = pathlib.Path(args.out or default_artifact("session"))
        out.parent.mkdir(parents=True, exist_ok=True)
        return _run_session_bench(args, backend, policy, out)

    from byzantinerandomizedconsensus_tpu_torch.serve import admission
    from byzantinerandomizedconsensus_tpu_torch.serve.server import ConsensusServer

    out = pathlib.Path(args.out or default_artifact(
        "serve_fleet" if fleet_mode else "serve"))
    out.parent.mkdir(parents=True, exist_ok=True)
    trace_path = out.with_suffix(".jsonl")
    if args.trace and not fleet_mode:
        _trace.configure(path=trace_path)
    if _slo_enabled(args):
        # the SLO gate reads the live metrics plane
        _metrics.configure()

    policy = _compaction.CompactionPolicy.parse(args.policy)
    full = fleet_request_stream(args.requests, args.seed, args.rate,
                                workers=max(workers_list))
    digest = stream_digest(full)
    stream, unsupported = supported_split(backend, full)
    cfgs = [cfg for _, cfg, _ in stream]
    n_sessions = sum(1 for _, _, s in stream if s > 1)
    buckets = []
    for cfg in cfgs:
        b = admission.bucket_of(cfg)
        if b not in buckets:
            buckets.append(b)
    kernel_label = args.kernel or "by law"
    print(f"loadgen: {args.requests} requests ({n_sessions} sessions served), "
          f"seed {args.seed}, rate {args.rate}/s, {len(buckets)} fused buckets, "
          f"digest {digest[:12]}…, {args.backend} on {args.device}, kernel "
          f"{kernel_label}")
    if unsupported:
        print(f"loadgen: --kernel {args.kernel} does not run "
              f"{len(full) - len(stream)} of the stream's {len(full)} requests, "
              f"left out of the drive: {unsupported}")

    if fleet_mode:
        return _run_fleet(args, policy, backend, workers_list, stream, digest,
                          cfgs, buckets, unsupported, out, trace_path)

    server = ConsensusServer(backend=backend, policy=policy,
                             round_cap_ceiling=ROUND_CAP_CEILING)
    lanes = server.leg == "lanes"
    with server:
        endpoint = _MetricsEndpoint(server) if _slo_enabled(args) else None
        phase_scrapes = {}
        t_warm0 = time.perf_counter()
        warm_handles = warm_up(server, buckets,
                               extra=() if lanes else library_configs(backend, cfgs))
        warm_s = time.perf_counter() - t_warm0
        warmup_compiles = server.compile_count()
        print(f"loadgen: warm-up {len(warm_handles)} requests, {warmup_compiles} "
              f"builds ({server.leg} leg), {warm_s:.1f}s")
        if endpoint:
            phase_scrapes["warm_up"] = _metrics.summary(endpoint.scrape() or {})

        launches0 = launch_counts()
        burst_leg, _burst_handles = _drive(server, stream, open_loop=False)
        print(f"loadgen: burst leg {burst_leg['throughput_cps']} cfg/s "
              f"(p50 {burst_leg['latency_ms']['p50']}ms)")
        if endpoint:
            phase_scrapes["burst"] = _metrics.summary(endpoint.scrape() or {})

        open_leg, open_handles = _drive(server, stream, open_loop=True)
        launches = _delta(launch_counts(), launches0)
        print(f"loadgen: open-loop leg p50 {open_leg['latency_ms']['p50']}ms "
              f"p99 {open_leg['latency_ms']['p99']}ms, time to first result "
              f"{open_leg['time_to_first_result_ms']}ms")

        steady_compiles = server.compile_count() - warmup_compiles
        server_stats = server.stats()
        final_snap = None
        if endpoint:
            final_snap = endpoint.scrape()
            phase_scrapes["open_loop"] = _metrics.summary(final_snap or {})
            endpoint.close()

    differential = _differential(cfgs, open_handles, plain_reference(args.device))
    offline_leg = (None if args.no_offline
                   else _offline_leg(backend, cfgs, args.reps, lanes))
    failed = _failures(_burst_handles + open_handles)

    serve_stats = {
        "arrival_seed": args.seed,
        "admission_policy": {"mode": "fused-compaction" if lanes else "direct",
                             "policy": policy.doc(),
                             "round_cap_ceiling": ROUND_CAP_CEILING},
        "requests": len(cfgs),
        "latency_ms": open_leg["latency_ms"],
        "throughput_cps": burst_leg["throughput_cps"],
        "time_to_first_result_ms": open_leg["time_to_first_result_ms"],
        "steady_state_compiles": steady_compiles,
        "warmup_compiles": warmup_compiles,
        "warmup_requests": len(warm_handles),
        "duration_s": open_leg["duration_s"],
        "population": {"buckets": len(buckets),
                       "mix": {k: w for k, w in _MIX}},
    }
    doc = {
        **record.new_record(
            "serve",
            description="Open-loop serving run: seeded Poisson arrivals over "
                        "a heterogeneous population through the consensus "
                        "service."),
        "generator_version": GENERATOR_VERSION,
        "seed": args.seed,
        "rate": args.rate,
        "requests": args.requests,
        "stream_digest": digest,
        "backend": args.backend,
        "device": str(server.device),
        "kernel": args.kernel,
        "leg": server.leg,
        "unsupported": unsupported,
        "serve": record.serve_block(serve_stats),
        "legs": {"burst": burst_leg, "open_loop": open_leg,
                 **({"offline": offline_leg} if offline_leg else {})},
        "launches": launches,
        "differential": differential,
        "failed": failed,
        "server": {k: server_stats[k] for k in
                   ("submitted", "replied", "failed", "policy",
                    "round_cap_ceiling", "leg", "device")},
        "compile_cache": server_stats["compile_cache"],
    }
    programs = record.programs_block()
    if programs is not None:
        doc["programs"] = programs
    if offline_leg:
        doc["summary"] = {
            "serve_vs_offline_cps": round(
                burst_leg["throughput_cps"] / offline_leg["throughput_cps"], 3),
        }
    slo = None
    if _slo_enabled(args):
        slo = _slo_verdict(args, final_snap)
        _slo_print("open_loop", slo)
        blk = record.metrics_block(final_snap, slo=slo)
        if blk is not None:
            blk["phase_scrapes"] = phase_scrapes
            doc["metrics"] = blk
    if args.trace:
        _trace.disable()
        blk = record.trace_block(trace_path)
        if blk is not None:
            doc["trace"] = blk

    problems = record.validate_record(doc)
    if problems:
        print(f"loadgen: INVALID RECORD: {problems}", file=sys.stderr)
        return 3
    out.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"loadgen: wrote {out}")
    print(f"loadgen: steady-state builds {steady_compiles}, launches {launches}, "
          f"failed {len(failed)}, sessions replayed "
          f"{differential['sessions_replayed']}, differential mismatches "
          f"{differential['mismatches']}"
          + (f", offline {offline_leg['mode']} walls {offline_leg['walls_s']} s"
             if offline_leg else ""))
    if differential["mismatches"]:
        return 1
    if steady_compiles:
        return 2
    if slo is not None and not slo["ok"]:
        print("loadgen: SLO BREACH (see checks above)", file=sys.stderr)
        return 5
    if failed:
        print(f"loadgen: FAILED REQUESTS: {failed}", file=sys.stderr)
        return 6
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
