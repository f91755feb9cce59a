"""Run records — the head of the versioned schema every artifact carries.

The port's copy of the head of the reference ``obs/record.py``: the record
version and revision, the environment fingerprint, the config block and the
counters block, and the blocks of the lane runner: ``compile_cache``,
``compaction``, ``trace``, ``fused`` and ``lanestate``. ``env_fingerprint`` reports torch and CUDA where the
reference reports JAX, and never initializes CUDA: the device fields appear
only when the calling tool already brought the card up.
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


#: The fields a ``fused`` block must carry (lanes against per-config runs).
FUSED_BLOCK_KEYS = ("configs", "mismatches", "rows", "device_of_record")


def fused_block(stats: dict | None) -> dict | None:
    """The schema-v1.11 ``fused`` block from a fused-lane A/B stats dict
    (lanes against per-config runs). None in, None out — a record
    without the block stays a valid v1.x record. ``rows`` is one entry per
    A/B config; ``device_of_record`` names where the bit-match ran."""
    if stats is None:
        return None
    return {k: stats.get(k) for k in
            (FUSED_BLOCK_KEYS + ("state_pack", "steady_state_compiles",
                                 "bytes_total", "duration_s"))
            if k in stats}


#: The fields a ``lanestate`` block must carry (a park-and-restore audit).
LANESTATE_BLOCK_KEYS = ("version", "grid_points", "restore_mismatches",
                        "crash_window_ok", "roundtrip_ok")


def lanestate_block(stats: dict | None) -> dict | None:
    """The schema-v1.14 ``lanestate`` block from a snapshot/restore audit
    stats dict (a park-and-restore audit). None in,
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
