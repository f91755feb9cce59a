"""Admission control for the consensus service.

The port's copy of the reference ``serve/admission.py``, its messages word
for word. A request enters the server as a payload — a :class:`SimConfig`,
or a plain dict of SimConfig field names (the HTTP front-end's JSON body).
Admission is the one seam where it becomes trusted work:

1. **validate** — the payload goes through the existing
   ``SimConfig``/``validate()`` path, the same checks every CLI entry point
   applies. Unknown fields and out-of-range values are rejected here, before
   anything is queued.
2. **bound** — the server pins a ``round_cap`` ceiling (the drain-segment
   length of the steady-state lane grid, serve/server.py); a config whose
   cap exceeds it would force a new drain program and break the
   zero-steady-state-recompiles claim, so it is rejected at admission, not
   discovered at dispatch.
3. **bucket** — the admitted config maps to its fused shape bucket
   (:class:`~byzantinerandomizedconsensus_tpu_torch.backends.batch.FusedBucket`),
   the key under which the server coalesces heterogeneous requests into one
   compacted lane grid (``run_fused(compaction=...)``'s admission law).

Every admitted request emits a ``serve.admit`` trace event carrying the
bucket label, and every rejection counts in ``brc_serve_rejected_total``
under its reason (``unknown_fields``, ``invalid_config``, ``bad_type``,
``cap_ceiling``, ``bad_envelope``; the server adds ``overflow``,
``tenant_cap``, ``recovering`` and ``body_too_large``).
"""

from __future__ import annotations

import dataclasses

from byzantinerandomizedconsensus_tpu_torch.backends.batch import FusedBucket
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.obs import metrics as _metrics
from byzantinerandomizedconsensus_tpu_torch.obs import trace as _trace

_REJECT_HELP = "Requests rejected at admission, by reason"


def _reject(reason: str) -> None:
    _metrics.counter("brc_serve_rejected_total", _REJECT_HELP,
                     reason=reason).inc()

#: The payload keys a dict request may carry — exactly the SimConfig fields.
REQUEST_FIELDS = tuple(f.name for f in dataclasses.fields(SimConfig))

#: Request-envelope keys: scheduling hints that ride a dict
#: payload NEXT TO the SimConfig fields and are popped before config
#: validation — they must never become SimConfig fields, because SimConfig
#: feeds the PRF draw coordinates and the fused bucket key (bit-identity
#: and the zero-recompile pin both depend on that separation).
ENVELOPE_FIELDS = ("check_invariants", "tenant", "deadline_ms", "priority",
                   "session_slots")

#: The tenant every envelope-less request belongs to.
DEFAULT_TENANT = "default"


class Backpressure(RuntimeError):
    """The service is over a configured bound — retry later.

    Raised by ``ConsensusServer.submit`` when the
    bounded pending-rotation queue or a per-tenant in-flight cap is hit
    (``reason`` names which). The HTTP front end maps it — and the feed's
    :class:`~byzantinerandomizedconsensus_tpu_torch.backends.compaction
    .WorkFeedOverflow` — to **429** with a ``Retry-After`` hint of
    ``retry_after_s`` seconds (seeded jitter, so a synchronized crowd of
    rejected clients decorrelates instead of re-stampeding).
    """

    def __init__(self, msg: str, reason: str = "overflow",
                 retry_after_s: float = 0.1):
        super().__init__(msg)
        self.reason = reason
        self.retry_after_s = float(retry_after_s)


def envelope(payload):
    """Split a request payload into (config payload, envelope dict).

    Dict payloads may carry the :data:`ENVELOPE_FIELDS` scheduling keys;
    they are validated and popped here so :func:`admit` sees pure SimConfig
    fields. Non-dict payloads (an in-process SimConfig) get the default
    envelope. Raises ``ValueError`` (named ``bad_envelope`` rejection) on
    malformed values.
    """
    env = {"check_invariants": False, "tenant": DEFAULT_TENANT,
           "deadline_ms": None, "priority": 0, "session_slots": 1}
    if not isinstance(payload, dict):
        return payload, env
    payload = dict(payload)
    if "check_invariants" in payload:
        env["check_invariants"] = bool(payload.pop("check_invariants"))
    if "tenant" in payload:
        tenant = payload.pop("tenant")
        if tenant is None:
            tenant = DEFAULT_TENANT
        if not isinstance(tenant, str) or not tenant or len(tenant) > 64:
            _reject("bad_envelope")
            raise ValueError(
                f"tenant must be a non-empty string (<= 64 chars), "
                f"got {tenant!r}")
        env["tenant"] = tenant
    if "deadline_ms" in payload:
        deadline = payload.pop("deadline_ms")
        if deadline is not None:
            if isinstance(deadline, bool) or \
                    not isinstance(deadline, (int, float)) or deadline <= 0:
                _reject("bad_envelope")
                raise ValueError(
                    f"deadline_ms must be a positive number, "
                    f"got {deadline!r}")
            env["deadline_ms"] = float(deadline)
    if "priority" in payload:
        prio = payload.pop("priority")
        if isinstance(prio, bool) or not isinstance(prio, int) \
                or not (-8 <= prio <= 8):
            _reject("bad_envelope")
            raise ValueError(
                f"priority must be an int in [-8, 8], got {prio!r}")
        env["priority"] = prio
    if "session_slots" in payload:
        # Spec-§11 session request kind: L chained decision slots, one
        # stream. L is an envelope key — NOT a SimConfig field — so the
        # program cache keys and the bit-identity law never see it; the
        # grid derives slot k+1's seed from slot k's decision.
        slots = payload.pop("session_slots")
        if slots is None:
            slots = 1
        from byzantinerandomizedconsensus_tpu_torch.models.session import (
            MAX_SESSION_SLOTS)
        if isinstance(slots, bool) or not isinstance(slots, int) \
                or not (1 <= slots <= MAX_SESSION_SLOTS):
            _reject("bad_envelope")
            raise ValueError(
                f"session_slots must be an int in [1, {MAX_SESSION_SLOTS}], "
                f"got {slots!r}")
        env["session_slots"] = slots
    return payload, env


def admit(payload, round_cap_ceiling: int | None = None) -> SimConfig:
    """Validate a request payload into a :class:`SimConfig` or raise.

    ``payload`` is a SimConfig or a dict of SimConfig fields. Raises
    ``ValueError`` on unknown fields, invalid configs, or a ``round_cap``
    above ``round_cap_ceiling`` (when given); ``TypeError`` on anything
    else. Emits a ``serve.admit`` event on success.
    """
    if isinstance(payload, SimConfig):
        cfg = payload
    elif isinstance(payload, dict):
        unknown = sorted(set(payload) - set(REQUEST_FIELDS))
        if unknown:
            _reject("unknown_fields")
            raise ValueError(
                f"unknown request field(s) {unknown}; "
                f"a request carries SimConfig fields: {REQUEST_FIELDS}")
        try:
            cfg = SimConfig(**payload)
        except (TypeError, ValueError):
            _reject("invalid_config")
            raise
    else:
        _reject("bad_type")
        raise TypeError(
            f"request payload is {type(payload).__name__}, "
            "not a SimConfig or dict")
    try:
        cfg.validate()
    except ValueError:
        _reject("invalid_config")
        raise
    if round_cap_ceiling is not None and cfg.round_cap > round_cap_ceiling:
        _reject("cap_ceiling")
        raise ValueError(
            f"round_cap={cfg.round_cap} exceeds the service ceiling "
            f"{round_cap_ceiling}; a longer cap would force a new drain "
            "program (zero steady-state recompiles is a service guarantee)")
    _metrics.counter("brc_serve_admitted_total",
                     "Requests admitted into the service").inc()
    _trace.event("serve.admit", bucket=bucket_of(cfg).label(),
                 instances=int(cfg.instances))
    return cfg


def bucket_of(cfg: SimConfig) -> FusedBucket:
    """The fused shape bucket a request coalesces under (admission law)."""
    return FusedBucket.of(cfg)
