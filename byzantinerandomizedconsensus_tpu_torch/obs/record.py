"""Run records — the versioned schema every artifact carries.

The port's copy of the reference ``obs/record.py``: the record version and
revision, the environment fingerprint, the config, counters and timing
blocks, every versioned block with its required keys (``compile_cache``,
``compaction``, ``trace``, ``programs``, ``serve``, ``fleet``, ``metrics``,
``hunt``, ``hostile``, ``committee``, ``fused``, ``session``, ``elastic``,
``lanestate``, ``preempt``), the artifact walk (:func:`parsed_payload`,
:func:`find_blocks`) and :func:`validate_record`, which gives the
reference's verdicts. ``env_fingerprint`` reports torch and CUDA where the
reference reports JAX, and never initializes CUDA: the device fields appear
only when the calling tool already brought the card up.
:func:`programs_block` builds the ``programs`` block from the census of the
port's CUDA kernels (``obs/programs.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

RECORD_VERSION = 1
RECORD_REVISION = 14


def env_fingerprint() -> dict:
    """Environment identity for a run record."""
    import platform

    import torch

    from byzantinerandomizedconsensus_tpu_torch import __version__
    from byzantinerandomizedconsensus_tpu_torch.backends.native_backend import ABI_VERSION
    from byzantinerandomizedconsensus_tpu_torch.ops import prf

    out = {
        "package": __version__,
        "python": platform.python_version(),
        "numpy": np.__version__,
        "pack_versions": sorted(prf.KEY_LOW_BITS),
        # The fused round kernel's resident u32 state word, field ->
        # [bit offset, width].
        "fused_state_pack": {
            "version": prf.FUSED_STATE_PACK_VERSION,
            "bits": {k: list(v) for k, v in sorted(prf.FUSED_STATE_BITS.items())},
        },
        "native_abi": ABI_VERSION,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    if torch.cuda.is_initialized():
        out["platform"] = "gpu"
        out["device_kind"] = torch.cuda.get_device_name(0)
        out["device_count"] = torch.cuda.device_count()
    else:
        out["platform"] = "uninitialized"
    return out


def new_record(kind: str, description: str | None = None, config=None) -> dict:
    """The shared head every artifact document merges its payload into."""
    out = {"record_version": RECORD_VERSION,
           "record_revision": RECORD_REVISION, "kind": kind}
    if description is not None:
        out["description"] = description
    out["env"] = env_fingerprint()
    if config is not None:
        out["config"] = config_block(config)
    return out


def config_block(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d["pack_version"] = cfg.pack_version
    return d


def _spread(walls) -> float:
    """(max-min)/min of a timed-run list — the dispersion recorded next to
    the best-of figure."""
    w = sorted(walls)
    return (w[-1] - w[0]) / w[0] if w and w[0] > 0 else 0.0


def timing_block(walls, device: dict | None = None) -> dict:
    """The canonical timing leg: best-of wall, the full walls list + spread,
    and the device-busy measurement or its honest error — an
    absence-of-signal 0.0 s (``device_busy_suspect``) is an error, never a
    measurement."""
    best = min(walls)
    out = {
        "wall_s": round(best, 3),
        "walls_s": [round(w, 3) for w in walls],
        "walls_spread": round(_spread(walls), 3),
    }
    if device is not None:
        if "device_busy_suspect" in device:
            out["device_busy_error"] = device["device_busy_suspect"]
        elif "device_busy_s" in device:
            out["device_busy_s"] = device["device_busy_s"]
        else:
            out["device_busy_error"] = device.get("error", "?")
    return out


def collect_counters(be, cfg, inst_ids=None) -> dict:
    """Run ``cfg`` once more with the counter leg on and return its counters
    block; a backend or kernel without a counter channel degrades to
    :func:`~obs.counters.unsupported_doc`. The counted run is separate from
    any timed run, so the timed window stays counter-free."""
    from byzantinerandomizedconsensus_tpu_torch.obs import counters

    try:
        _res, doc = be.run_with_counters(cfg, inst_ids)
        return doc
    except counters.CountersUnsupported as e:
        return counters.unsupported_doc(e)


def compile_cache_block(backend) -> dict | None:
    """The schema-v1.1 ``compile_cache`` block from a backend name or object:
    the shape-bucketed program LRU's counters (backends/batch.py), or None
    when the backend has no bucket cache (the oracle, the native core). Never
    raises — observability must not break record assembly."""
    try:
        if isinstance(backend, str):
            from byzantinerandomizedconsensus_tpu_torch.backends.base import (
                get_backend)

            backend = get_backend(backend)
        fn = getattr(backend, "compile_cache_stats", None)
        return None if fn is None else fn()
    except Exception:
        return None


#: The fields a schema-v1.2 ``compaction`` block must carry (the lane-grid
#: occupancy accounting of backends/compaction.py::run_bucket/merge_stats).
COMPACTION_BLOCK_KEYS = ("occupancy", "wasted_lane_fraction", "segments",
                         "refills", "policy")


def compaction_block(stats: dict | None) -> dict | None:
    """The schema-v1.2 ``compaction`` block from a compacted-runner stats
    dict (backends/compaction.py), or from an object exposing
    ``last_stats``. None in, None out — a
    record without the block stays a valid v1/v1.1 record."""
    if stats is None:
        return None
    if not isinstance(stats, dict):
        stats = getattr(stats, "last_stats", None)
        if stats is None:
            return None
    return {k: stats.get(k) for k in
            ("width", "segments", "refills", "device_lane_rounds",
             "useful_lane_rounds", "occupancy", "wasted_lane_fraction",
             "policy") if k in stats}


#: The fields a schema-v1.3 ``trace`` block must carry (the host-side
#: telemetry binding of obs/trace.py: file + event census + span digest).
TRACE_BLOCK_KEYS = ("file", "events", "digest")


def trace_block(path) -> dict | None:
    """The schema-v1.3 ``trace`` block from a trace JSONL path: the file
    name (basename — artifacts move, the binding is by name next to the
    record), its event count, and the per-span-kind digest
    (obs/trace.digest). None on any failure — observability must not break
    record assembly."""
    import pathlib

    from byzantinerandomizedconsensus_tpu_torch.obs import trace as _trace

    try:
        path = pathlib.Path(path)
        events = _trace.read_events(path)
        return {"file": path.name, "events": len(events),
                "digest": _trace.digest(events)}
    except Exception:
        return None


#: The fields a schema-v1.4 ``programs`` block must carry (the compiled-
#: program census of obs/programs.py: entry count + the entry list; each
#: entry needs at least its ``key`` and ``fingerprint``).
PROGRAMS_BLOCK_KEYS = ("count", "programs")


def parsed_payload(doc):
    """The payload of a driver-captured artifact (``{"parsed": {...}}``
    wrapper) or the document itself when it was written directly — the one
    unwrap every artifact consumer shares."""
    return doc.get("parsed", doc) if isinstance(doc, dict) else {}


def find_blocks(doc, block_key: str, required_keys) -> list:
    """Every ``block_key`` sub-dict of an artifact payload carrying all
    ``required_keys``, wherever it sits (top level, per-leg, per-point):
    (path, block) pairs: the one recursive walk every versioned-block
    consumer shares."""
    found = []

    def walk(node, path):
        if isinstance(node, dict):
            blk = node.get(block_key)
            if isinstance(blk, dict) and all(k in blk for k in required_keys):
                found.append((path or ".", blk))
            for k, v in node.items():
                if k != block_key:
                    walk(v, f"{path}.{k}" if path else k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")

    walk(parsed_payload(doc), "")
    return found


def programs_block(source=None) -> dict | None:
    """The schema-v1.4 ``programs`` block: from the process-global census
    (``source=None``, the common case after a ``BRC_PROGRAMS`` run), a
    :class:`~byzantinerandomizedconsensus_tpu_torch.obs.programs.ProgramCensus`,
    or a dict of census entries by key. None when the census is off or
    empty: a record without the block stays a valid v1.x record. Never
    raises."""
    from byzantinerandomizedconsensus_tpu_torch.obs import programs as _programs

    try:
        if source is None:
            source = _programs.current()
        if source is None:
            return None
        if hasattr(source, "block"):
            return source.block()
        if not isinstance(source, dict) or not source:
            return None
        census = _programs.ProgramCensus()
        for entry in source.values():
            census.record(entry)
        return census.block()
    except Exception:
        return None


#: The fields a schema-v1.5 ``serve`` block must carry (the open-loop
#: serving accounting of serve/server.py + tools/loadgen.py: who generated
#: the traffic, how it was admitted, and what the service delivered).
SERVE_BLOCK_KEYS = ("arrival_seed", "admission_policy", "requests",
                    "latency_ms", "throughput_cps",
                    "time_to_first_result_ms", "steady_state_compiles")


def serve_block(stats: dict | None) -> dict | None:
    """The schema-v1.5 ``serve`` block from a serving-run stats dict
    (tools/loadgen.py / serve/server.py). None in, None out — a record
    without the block stays a valid v1.x record. Latencies are milliseconds
    (requests retire in the single-digit-ms to seconds range; seconds would
    bury the p50 in decimals), throughput is configs/sec."""
    if stats is None:
        return None
    return {k: stats.get(k) for k in
            (SERVE_BLOCK_KEYS + ("warmup_compiles", "warmup_requests",
                                 "duration_s", "population"))
            if k in stats}


#: The fields a schema-v1.6 ``fleet`` block must carry (the sharded
#: multi-worker serving accounting of serve/fleet.py + ``loadgen
#: --workers``: fleet-wide numbers plus the per-worker ledger rows).
FLEET_BLOCK_KEYS = ("workers", "arrival_seed", "admission_policy",
                    "requests", "latency_ms", "throughput_cps",
                    "steady_state_compiles", "steals", "readmitted",
                    "lost_workers", "per_worker")


def fleet_block(stats: dict | None) -> dict | None:
    """The schema-v1.6 ``fleet`` block from a fleet-serving stats dict
    (serve/fleet.py / tools/loadgen.py). None in, None out — a record
    without the block stays a valid v1.x record. ``steady_state_compiles``
    is the fleet-wide sum; ``per_worker`` carries the per-worker split the
    zero-recompile pin is enforced on (every row must be 0)."""
    if stats is None:
        return None
    return {k: stats.get(k) for k in
            (FLEET_BLOCK_KEYS + ("warmup_compiles", "duration_s",
                                 "population", "fabric_latency_ms",
                                 "rotation_cap", "placement",
                                 "migrations", "lanes_migrated"))
            if k in stats}


#: The fields a schema-v1.7 ``metrics`` block must carry (the live metrics
#: plane of obs/metrics.py: which metric families the run registered, the
#: headline scraped gauges, and the SLO verdict when one was enforced).
METRICS_BLOCK_KEYS = ("names", "series", "p99_latency_ms",
                      "decided_fraction")


def metrics_block(snapshot: dict | None, slo: dict | None = None
                  ) -> dict | None:
    """The schema-v1.7 ``metrics`` block from a registry snapshot
    (obs/metrics.py ``snapshot()`` or a ``parse_text`` scrape). None in,
    None out — a record without the block stays a valid v1.x record. The
    block is a *digest*, not the full series dump: family names, series
    count, and the headline gauges the SLO gate reads; ``slo`` (when the
    run enforced one) carries the thresholds and the verdict."""
    if not snapshot:
        return None
    from byzantinerandomizedconsensus_tpu_torch.obs import metrics as _metrics

    summ = _metrics.summary(snapshot)
    out = {
        "names": sorted(snapshot),
        "series": sum(len(f.get("series") or ()) for f in snapshot.values()),
        "p99_latency_ms": summ["p99_latency_ms"],
        "decided_fraction": summ["decided_fraction"],
        "p50_latency_ms": summ["p50_latency_ms"],
        "error_rate": summ["error_rate"],
    }
    if slo is not None:
        out["slo"] = dict(slo)
    return out


#: The fields a schema-v1.8 ``hunt`` block must carry (the closed-loop
#: adversary hunter of hunt/hunter.py: strategy identity, budget accounting,
#: and the red-alarm pins the artifact's claims rest on).
HUNT_BLOCK_KEYS = ("strategy", "seed", "budget", "evaluations",
                   "generations", "best_fitness", "archive_size",
                   "violations", "steady_state_compiles")


def hunt_block(stats: dict | None) -> dict | None:
    """The schema-v1.8 ``hunt`` block from a hunt-run stats dict
    (hunt/hunter.py). None in, None out — a record without the block stays
    a valid v1.x record. ``best_fitness`` is the hunt's objective (mean
    rounds-to-decision plus the round_cap-weighted undecided fraction —
    higher is worse-case); ``violations`` and ``steady_state_compiles``
    are the pins whose committed value 0 is the round's claim."""
    if stats is None:
        return None
    return {k: stats.get(k) for k in
            (HUNT_BLOCK_KEYS + ("space", "best", "pipelined_wall_s",
                                "barriered_wall_s", "pipeline_speedup",
                                "baseline_mean_rounds", "rediscovery",
                                "violation_detail", "generation_size",
                                "duration_s"))
            if k in stats}


#: The fields a schema-v1.9 ``hostile`` block must carry (the hostile-load
#: suite of tools/hostile.py: suite identity, per-scenario rows, and the
#: suite-wide mismatch / steady-compile / backpressure pins).
HOSTILE_BLOCK_KEYS = ("suite_seed", "scenarios", "rejected_overflow",
                      "mismatches", "steady_state_compiles")

#: The fields every row of a hostile block's ``scenarios`` list must carry
#: (one row per seeded scenario; the ledger's hostile columns).
HOSTILE_SCENARIO_KEYS = ("scenario", "seed", "requests", "replied",
                         "rejected", "cancelled", "mismatches",
                         "steady_state_compiles", "slo_ok")


def hostile_block(stats: dict | None) -> dict | None:
    """The schema-v1.9 ``hostile`` block from a hostile-suite stats dict
    (tools/hostile.py). None in, None out — a record without the block
    stays a valid v1.x record. ``rejected_overflow`` is the suite-wide
    count of named 429 overflow rejections (the acceptance gate requires
    it nonzero in at least one scenario); ``mismatches`` and
    ``steady_state_compiles`` are the pins whose committed value 0 is the
    round's claim."""
    if stats is None:
        return None
    return {k: stats.get(k) for k in
            (HOSTILE_BLOCK_KEYS + ("generator_version", "duration_s",
                                   "deadline_hit_rate", "fairness"))
            if k in stats}


#: The fields a schema-v1.10 ``committee`` block must carry (the spec §10
#: committee cost-curve accounting of tools/cost_curve.py: the measured n
#: grid, the realized committee laws along it, the per-replica flatness
#: verdict vs the full-mesh baseline, and the checker / serve pins).
COMMITTEE_BLOCK_KEYS = ("ns", "committee_sizes", "fault_budgets",
                        "per_replica_cost", "flatness",
                        "checker_n", "checker_ok")


def committee_block(stats: dict | None) -> dict | None:
    """The schema-v1.10 ``committee`` block from a committee cost-curve
    stats dict (tools/cost_curve.py). None in, None out — a record without
    the block stays a valid v1.x record. ``per_replica_cost`` maps n →
    wall / (instances · n); ``flatness`` is the largest-to-smallest-n ratio
    of that cost per delivery (the committee family's flat-ish claim is that
    its ratio stays near 1 where the full-mesh families grow like n)."""
    if stats is None:
        return None
    return {k: stats.get(k) for k in
            (COMMITTEE_BLOCK_KEYS + ("fault_div", "instances", "baseline",
                                     "serve", "counters"))
            if k in stats}


#: The fields a schema-v1.11 ``fused`` block must carry (the ABI v6 fused
#: round kernel A/B of tools/programs.py ``programs fused``: per-config
#: bytes/dispatch rows vs the xla baseline, the bit-match pin whose
#: committed value 0 is the round's claim, and the device-of-record field
#: the ledger's debt row reads).
FUSED_BLOCK_KEYS = ("configs", "mismatches", "rows", "device_of_record")


def fused_block(stats: dict | None) -> dict | None:
    """The schema-v1.11 ``fused`` block from a fused-A/B stats dict
    (tools/programs.py ``programs fused``). None in, None out — a record
    without the block stays a valid v1.x record. ``rows`` is one entry per
    A/B config: census label, xla and fused bytes/dispatch, their ratio.
    ``device_of_record`` names where the bit-match ran ("interpret/cpu"
    until the Mosaic lowering lands — the ledger tracks that debt)."""
    if stats is None:
        return None
    return {k: stats.get(k) for k in
            (FUSED_BLOCK_KEYS + ("state_pack", "steady_state_compiles",
                                 "bytes_total", "duration_s"))
            if k in stats}


#: The fields a schema-v1.12 ``session`` block must carry (the spec-§11
#: replicated-log session bench of tools/loadgen.py: the measured session
#: population, decisions/s for the L-slot session path vs L
#: dependency-honoring independent requests, the amortization ratio that is
#: the round's headline, and the standing pins — steady-state compiles,
#: per-slot numpy differential mismatches, and offline bit-replay).
SESSION_BLOCK_KEYS = ("sessions", "slots", "decisions", "amortization_ratio",
                      "session_cps", "independent_cps",
                      "steady_state_compiles", "mismatches", "replay_ok")


def session_block(stats: dict | None) -> dict | None:
    """The schema-v1.12 ``session`` block from a session-bench stats dict
    (tools/loadgen.py ``--session-bench``). None in, None out — a record
    without the block stays a valid v1.x record. ``session_cps`` /
    ``independent_cps`` are decisions per second for the two legs over the
    same seeded population; ``amortization_ratio`` is their quotient;
    ``replay_ok`` is True iff every measured session bit-replays offline
    from its base seed alone (spec §11's pure-function-of-seed law)."""
    if stats is None:
        return None
    return {k: stats.get(k) for k in
            (SESSION_BLOCK_KEYS + ("generator_version", "session_reseeds",
                                   "population", "duration_s"))
            if k in stats}


#: The fields a schema-v1.13 ``elastic`` block must carry (the
#: durability/elasticity drills of tools/hostile.py: suite identity,
#: per-drill rows, WAL recovery and autoscale scale-event counts, and the
#: suite-wide mismatch / steady-compile / SLO pins).
ELASTIC_BLOCK_KEYS = ("suite_seed", "scenarios", "recovered",
                      "scale_up_events", "scale_down_events",
                      "mismatches", "steady_state_compiles", "slo_ok")

#: The fields every row of an elastic block's ``scenarios`` list must carry
#: (one row per seeded drill; the ledger's elastic columns).
ELASTIC_SCENARIO_KEYS = ("scenario", "seed", "requests", "replied",
                         "recovered", "rejected_recovering",
                         "scale_up_events", "scale_down_events",
                         "mismatches", "steady_state_compiles", "slo_ok")


def elastic_block(stats: dict | None) -> dict | None:
    """The schema-v1.13 ``elastic`` block from an elastic-drill stats dict
    (tools/hostile.py ``dispatcher_kill`` / ``autoscale_crowd``). None in,
    None out — a record without the block stays a valid v1.x record.
    ``recovered`` counts the in-flight requests replayed from the
    write-ahead admission log after the dispatcher SIGKILL; ``mismatches``,
    ``steady_state_compiles`` and ``slo_ok`` are the pins whose committed
    values (0, 0, True) are the round's claim."""
    if stats is None:
        return None
    return {k: stats.get(k) for k in
            (ELASTIC_BLOCK_KEYS + ("generator_version", "duration_s",
                                   "static_p99_ms", "elastic_p99_ms",
                                   "slo_ms"))
            if k in stats}


#: The fields a schema-v1.14 ``lanestate`` block must carry (the
#: serializable-lane-state audit of backends/lanestate.py: the record
#: version the run speaks, the restore bit-identity grid size, and the
#: mismatch / crash-window / wire-round-trip pins).
LANESTATE_BLOCK_KEYS = ("version", "grid_points", "restore_mismatches",
                        "crash_window_ok", "roundtrip_ok")


def lanestate_block(stats: dict | None) -> dict | None:
    """The schema-v1.14 ``lanestate`` block from a snapshot/restore audit
    stats dict (tools/hostile.py ``preempt_storm`` restore leg). None in,
    None out — a record without the block stays a valid v1.x record.
    ``restore_mismatches`` counts grid points where a parked-and-resumed
    run diverged from the uninterrupted control (pinned 0);
    ``crash_window_ok`` / ``roundtrip_ok`` are the mid-crash-window-restore
    and serialized-wire (JSON) round-trip verdicts."""
    if stats is None:
        return None
    return {k: stats.get(k) for k in
            (LANESTATE_BLOCK_KEYS + ("grid", "lanes_round_tripped",
                                     "duration_s"))
            if k in stats}


#: The fields a schema-v1.14 ``preempt`` block must carry (the
#: preempt_storm drill of tools/hostile.py: suite identity, park/resume
#: and lane-migration accounting, the preemptive-vs-FIFO deadline hit
#: rates, and the suite-wide mismatch / steady-compile pins).
PREEMPT_BLOCK_KEYS = ("suite_seed", "requests", "parks", "resumes",
                      "lanes_exported", "lanes_imported",
                      "deadline_hit_rate", "fifo_hit_rate",
                      "mismatches", "steady_state_compiles")


def preempt_block(stats: dict | None) -> dict | None:
    """The schema-v1.14 ``preempt`` block from a preempt_storm stats dict
    (tools/hostile.py). None in, None out — a record without the block
    stays a valid v1.x record. ``deadline_hit_rate`` is the urgent-request
    deadline hit rate with preemptive scheduling on; ``fifo_hit_rate`` is
    the same traffic through the round-18 FIFO path (the claim is
    deadline_hit_rate > fifo_hit_rate at ``mismatches`` == 0 and
    ``steady_state_compiles`` == 0)."""
    if stats is None:
        return None
    return {k: stats.get(k) for k in
            (PREEMPT_BLOCK_KEYS + ("generator_version", "urgent_requests",
                                   "fat_requests", "duration_s"))
            if k in stats}


def validate_record(doc: dict) -> list:
    """Schema check: returns a list of problems (empty = valid v1 record)."""
    problems = []
    if not isinstance(doc, dict):
        return [f"record is {type(doc).__name__}, not a dict"]
    if doc.get("record_version") != RECORD_VERSION:
        problems.append(f"record_version {doc.get('record_version')!r} != "
                        f"{RECORD_VERSION}")
    rev = doc.get("record_revision")
    if rev is not None and (not isinstance(rev, int) or isinstance(rev, bool)
                            or rev < 0 or rev > RECORD_REVISION):
        # A revision from the future (or garbage) must fail BY NAME: the
        # schema-drift census pins this message, so a build that meets an
        # artifact it cannot understand says so instead of part-validating.
        problems.append(f"unknown record_revision {rev!r} (this build knows "
                        f"revisions 0..{RECORD_REVISION})")
    if not isinstance(doc.get("kind"), str) or not doc.get("kind"):
        problems.append("missing/empty 'kind'")
    env = doc.get("env")
    if not isinstance(env, dict):
        problems.append("missing 'env' fingerprint")
    else:
        for key in ("package", "python", "numpy"):
            if key not in env:
                problems.append(f"env missing {key!r}")
    counters = doc.get("counters")
    if counters is not None and isinstance(counters, dict):
        if "supported" not in counters:
            problems.append("counters block missing 'supported'")
        elif counters["supported"] and not isinstance(
                counters.get("totals"), dict):
            problems.append("supported counters block missing 'totals'")
    cc = doc.get("compile_cache")
    if cc is not None:
        if not isinstance(cc, dict):
            problems.append("compile_cache block is not a dict")
        else:
            for key in ("compiles", "hits", "evictions"):
                if key not in cc:
                    problems.append(f"compile_cache block missing {key!r}")
    comp = doc.get("compaction")
    if comp is not None:
        if not isinstance(comp, dict):
            problems.append("compaction block is not a dict")
        else:
            for key in COMPACTION_BLOCK_KEYS:
                if key not in comp:
                    problems.append(f"compaction block missing {key!r}")
    tr = doc.get("trace")
    if tr is not None:
        if not isinstance(tr, dict):
            problems.append("trace block is not a dict")
        else:
            for key in TRACE_BLOCK_KEYS:
                if key not in tr:
                    problems.append(f"trace block missing {key!r}")
            dg = tr.get("digest")
            if dg is not None and isinstance(dg, dict):
                for kind, entry in dg.items():
                    if not isinstance(entry, dict) or "count" not in entry:
                        problems.append(
                            f"trace digest entry {kind!r} missing 'count'")
    sv = doc.get("serve")
    if sv is not None:
        if not isinstance(sv, dict):
            problems.append("serve block is not a dict")
        else:
            for key in SERVE_BLOCK_KEYS:
                if key not in sv:
                    problems.append(f"serve block missing {key!r}")
            lat = sv.get("latency_ms")
            if lat is not None and isinstance(lat, dict):
                for q in ("p50", "p99"):
                    if q not in lat:
                        problems.append(f"serve latency_ms missing {q!r}")
    fl = doc.get("fleet")
    if fl is not None:
        if not isinstance(fl, dict):
            problems.append("fleet block is not a dict")
        else:
            for key in FLEET_BLOCK_KEYS:
                if key not in fl:
                    problems.append(f"fleet block missing {key!r}")
            lat = fl.get("latency_ms")
            if lat is not None and isinstance(lat, dict):
                for q in ("p50", "p99"):
                    if q not in lat:
                        problems.append(f"fleet latency_ms missing {q!r}")
            pw = fl.get("per_worker")
            if pw is not None:
                if not isinstance(pw, list):
                    problems.append("fleet per_worker is not a list")
                else:
                    for i, row in enumerate(pw):
                        if not isinstance(row, dict) or "worker" not in row \
                                or "steady_state_compiles" not in row:
                            problems.append(
                                f"fleet per_worker row {i} missing "
                                "'worker'/'steady_state_compiles'")
    mt = doc.get("metrics")
    if mt is not None:
        if not isinstance(mt, dict):
            problems.append("metrics block is not a dict")
        else:
            for key in METRICS_BLOCK_KEYS:
                if key not in mt:
                    problems.append(f"metrics block missing {key!r}")
            if not isinstance(mt.get("names"), list):
                problems.append("metrics block 'names' is not a list")
            slo = mt.get("slo")
            if slo is not None and (not isinstance(slo, dict)
                                    or "ok" not in slo):
                problems.append("metrics slo block missing 'ok'")
    ht = doc.get("hunt")
    if ht is not None:
        if not isinstance(ht, dict):
            problems.append("hunt block is not a dict")
        else:
            for key in HUNT_BLOCK_KEYS:
                if key not in ht:
                    problems.append(f"hunt block missing {key!r}")
            best = ht.get("best")
            if best is not None and (not isinstance(best, dict)
                                     or "genome" not in best):
                problems.append("hunt best entry missing 'genome'")
    hb = doc.get("hostile")
    if hb is not None:
        if not isinstance(hb, dict):
            problems.append("hostile block is not a dict")
        else:
            for key in HOSTILE_BLOCK_KEYS:
                if key not in hb:
                    problems.append(f"hostile block missing {key!r}")
            rows = hb.get("scenarios")
            if rows is not None:
                if not isinstance(rows, list):
                    problems.append("hostile scenarios is not a list")
                else:
                    for i, row in enumerate(rows):
                        if not isinstance(row, dict):
                            problems.append(
                                f"hostile scenario row {i} is not a dict")
                            continue
                        for key in HOSTILE_SCENARIO_KEYS:
                            if key not in row:
                                problems.append(
                                    f"hostile scenario row {i} missing "
                                    f"{key!r}")
    cb = doc.get("committee")
    if cb is not None:
        if not isinstance(cb, dict):
            problems.append("committee block is not a dict")
        else:
            for key in COMMITTEE_BLOCK_KEYS:
                if key not in cb:
                    problems.append(f"committee block missing {key!r}")
            if not isinstance(cb.get("ns"), list):
                problems.append("committee block 'ns' is not a list")
            ok = cb.get("checker_ok")
            if ok is not None and not isinstance(ok, bool):
                problems.append("committee block 'checker_ok' is not a bool")
    fu = doc.get("fused")
    if fu is not None:
        if not isinstance(fu, dict):
            problems.append("fused block is not a dict")
        else:
            for key in FUSED_BLOCK_KEYS:
                if key not in fu:
                    problems.append(f"fused block missing {key!r}")
            rows = fu.get("rows")
            if rows is not None:
                if not isinstance(rows, list):
                    problems.append("fused block 'rows' is not a list")
                else:
                    for i, row in enumerate(rows):
                        if not isinstance(row, dict) or "key" not in row \
                                or "fused_bytes_per_dispatch" not in row:
                            problems.append(
                                f"fused row {i} missing "
                                "'key'/'fused_bytes_per_dispatch'")
    sb = doc.get("session")
    if sb is not None:
        if not isinstance(sb, dict):
            problems.append("session block is not a dict")
        else:
            for key in SESSION_BLOCK_KEYS:
                if key not in sb:
                    problems.append(f"session block missing {key!r}")
            ok = sb.get("replay_ok")
            if ok is not None and not isinstance(ok, bool):
                problems.append("session block 'replay_ok' is not a bool")
            ratio = sb.get("amortization_ratio")
            if ratio is not None and (isinstance(ratio, bool)
                                      or not isinstance(ratio, (int, float))):
                problems.append(
                    "session block 'amortization_ratio' is not a number")
    eb = doc.get("elastic")
    if eb is not None:
        if not isinstance(eb, dict):
            problems.append("elastic block is not a dict")
        else:
            for key in ELASTIC_BLOCK_KEYS:
                if key not in eb:
                    problems.append(f"elastic block missing {key!r}")
            ok = eb.get("slo_ok")
            if ok is not None and not isinstance(ok, bool):
                problems.append("elastic block 'slo_ok' is not a bool")
            rows = eb.get("scenarios")
            if rows is not None:
                if not isinstance(rows, list):
                    problems.append("elastic scenarios is not a list")
                else:
                    for i, row in enumerate(rows):
                        if not isinstance(row, dict):
                            problems.append(
                                f"elastic scenario row {i} is not a dict")
                            continue
                        for key in ELASTIC_SCENARIO_KEYS:
                            if key not in row:
                                problems.append(
                                    f"elastic scenario row {i} missing "
                                    f"{key!r}")
    ls = doc.get("lanestate")
    if ls is not None:
        if not isinstance(ls, dict):
            problems.append("lanestate block is not a dict")
        else:
            for key in LANESTATE_BLOCK_KEYS:
                if key not in ls:
                    problems.append(f"lanestate block missing {key!r}")
            for key in ("crash_window_ok", "roundtrip_ok"):
                ok = ls.get(key)
                if ok is not None and not isinstance(ok, bool):
                    problems.append(
                        f"lanestate block {key!r} is not a bool")
    pb = doc.get("preempt")
    if pb is not None:
        if not isinstance(pb, dict):
            problems.append("preempt block is not a dict")
        else:
            for key in PREEMPT_BLOCK_KEYS:
                if key not in pb:
                    problems.append(f"preempt block missing {key!r}")
            for key in ("deadline_hit_rate", "fifo_hit_rate"):
                rate = pb.get(key)
                if rate is not None and (isinstance(rate, bool)
                                         or not isinstance(rate,
                                                           (int, float))):
                    problems.append(
                        f"preempt block {key!r} is not a number")
    pg = doc.get("programs")
    if pg is not None:
        if not isinstance(pg, dict):
            problems.append("programs block is not a dict")
        else:
            for key in PROGRAMS_BLOCK_KEYS:
                if key not in pg:
                    problems.append(f"programs block missing {key!r}")
            entries = pg.get("programs")
            if isinstance(entries, list):
                for i, entry in enumerate(entries):
                    if not isinstance(entry, dict) or "key" not in entry \
                            or "fingerprint" not in entry:
                        problems.append(f"programs entry {i} missing "
                                        "'key'/'fingerprint'")
    return problems
