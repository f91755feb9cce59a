"""Host-side telemetry — structured trace events.

The port's copy of the reference ``obs/trace.py``; ``tools/trace.py`` (``cli
trace``) reads what it writes. (``cardprofile.py``, ``cli profile``, is the
card's ``torch.profiler`` reduction, a different thing.)
It records monotonic-clock spans (``ph: "X"``: kind, start, duration,
attrs) and instant events (``ph: "i"``) from the orchestration seams: the
lane runner's compile cache, batched dispatches, and the compacted grid's
segments, refills and drains. It is inert when disabled: the module-level
fast path checks one global and returns a shared no-op context manager, and
nothing flows into any simulation math, so results are bit-identical traced
or untraced.

Events sink to a JSONL file (one per line, line-buffered) or, without a
path, to a bounded in-memory list (overflow counted in ``dropped``).
Workers enable themselves from ``BRC_TRACE`` and append to their own
``trace-w<pid>.jsonl``; :func:`merge` joins those files into one timeline.
:func:`to_chrome` converts a trace to the Chrome trace-event format and
:func:`digest` gives per-kind count/total/p50/p90/p99 through the port's
``utils/metrics.percentiles``.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import pathlib
import threading
import time

#: Environment variable naming the trace directory. Subprocess workers
#: (tools/soak.py chaos children) call :func:`maybe_enable_from_env` and
#: append to their own per-worker file inside it.
TRACE_ENV = "BRC_TRACE"

#: In-memory sink bound: a tracer without a file sink never holds more than
#: this many events — overflow is counted in ``Tracer.dropped``, not stored.
MAX_EVENTS = 200_000


def _jsonable(obj):
    """Last-resort JSON coercion for attrs (numpy scalars -> python)."""
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return str(obj)


class _Discard(dict):
    """The attrs sink handed out by the disabled fast path: accepts writes,
    keeps nothing — so ``with span(...) as sp: sp["k"] = v`` costs nothing
    when tracing is off."""

    def __setitem__(self, key, value):  # noqa: D105 — deliberate no-op
        pass

    def update(self, *a, **kw):
        pass


_NULL_SPAN = contextlib.nullcontext(_Discard())


class Tracer:
    """Thread-safe span/event collector with a JSONL file sink.

    One instance per process; module-level :func:`span` / :func:`event` route
    to the configured instance (or to the shared no-op when disabled). Event
    timestamps are raw ``time.monotonic()`` seconds — system-wide on Linux,
    so per-worker files merge into one ordered timeline.
    """

    def __init__(self, path=None, max_events: int = MAX_EVENTS):
        self._lock = threading.Lock()
        self.path = pathlib.Path(path) if path is not None else None
        self._fh = None
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            # Line-buffered: a live `trace follow` must see events as they
            # happen, not when a 64K block fills.
            self._fh = open(self.path, "a", buffering=1)
        self.max_events = max_events
        self.events: list = []
        self.dropped = 0
        self.pid = os.getpid()
        self._tids: dict = {}

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            # Under the lock: two threads first-emitting concurrently must
            # not both read len()==k and share one tid (the span-nesting
            # validation is per (pid, tid) — a shared tid interleaves two
            # threads' spans on one timeline row).
            with self._lock:
                tid = self._tids.get(ident)
                if tid is None:
                    tid = self._tids[ident] = len(self._tids)
        return tid

    def _emit(self, ev: dict) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.write(json.dumps(ev, separators=(",", ":"),
                                          default=_jsonable) + "\n")
            elif len(self.events) < self.max_events:
                self.events.append(ev)
            else:
                self.dropped += 1

    def event(self, kind: str, **attrs) -> None:
        """Record an instant event (Chrome ``ph: "i"``)."""
        ev = {"ph": "i", "kind": kind, "ts": round(time.monotonic(), 6),
              "pid": self.pid, "tid": self._tid()}
        if attrs:
            ev["attrs"] = attrs
        self._emit(ev)

    @contextlib.contextmanager
    def span(self, kind: str, **attrs):
        """Record a complete span (Chrome ``ph: "X"``) around the block.

        Yields the (mutable) attrs dict so call sites can attach results
        that only exist once the block ran (retired-lane counts, statuses):
        whatever is in the dict at exit is what gets written.
        """
        t0 = time.monotonic()
        try:
            yield attrs
        finally:
            ev = {"ph": "X", "kind": kind, "ts": round(t0, 6),
                  "dur": round(time.monotonic() - t0, 6),
                  "pid": self.pid, "tid": self._tid()}
            if attrs:
                ev["attrs"] = attrs
            self._emit(ev)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


# ---------------------------------------------------------------------------
# module-level fast path


_tracer: Tracer | None = None


def enabled() -> bool:
    return _tracer is not None


def current() -> Tracer | None:
    return _tracer


def span(kind: str, **attrs):
    """A span context manager, or the shared no-op when tracing is off."""
    t = _tracer
    if t is None:
        return _NULL_SPAN
    return t.span(kind, **attrs)


def event(kind: str, **attrs) -> None:
    t = _tracer
    if t is not None:
        t.event(kind, **attrs)


def _close_at_exit() -> None:
    t = _tracer
    if t is not None:
        t.close()


_atexit_registered = False


def configure(out_dir=None, role: str | None = None,
              max_events: int = MAX_EVENTS, path=None) -> Tracer:
    """Enable tracing for this process.

    ``out_dir=None`` keeps events in (bounded) memory; with a directory, the
    sink is ``out_dir/trace-<role or w<pid>>.jsonl`` — the per-worker file
    naming :func:`merge` expects. ``path`` pins an exact sink file instead.
    Replaces any previously configured tracer (closing its sink)."""
    global _tracer, _atexit_registered
    if _tracer is not None:
        _tracer.close()
    if path is None and out_dir is not None:
        name = f"trace-{role or 'w%d' % os.getpid()}.jsonl"
        path = pathlib.Path(out_dir) / name
    _tracer = Tracer(path, max_events=max_events)
    if not _atexit_registered:
        # A chaos child exits right after printing its record; the sink must
        # flush even when nobody calls disable().
        atexit.register(_close_at_exit)
        _atexit_registered = True
    return _tracer


def disable() -> None:
    """Close the sink and return to the zero-work fast path."""
    global _tracer
    if _tracer is not None:
        _tracer.close()
        _tracer = None


def finish(tracer: Tracer | None) -> dict | None:
    """The one teardown every tracing tool shares: close ``tracer``'s sink
    (disabling the global fast path when it is the current tracer — a tool
    must never leave a dead run's tracer collecting) and return the
    schema-v1.3 ``trace`` block for its file (obs/record.trace_block), or
    None when there is nothing to bind."""
    if tracer is None:
        return None
    if _tracer is tracer:
        disable()
    else:
        tracer.close()
    if tracer.path is None:
        return None
    from byzantinerandomizedconsensus_tpu_torch.obs import record

    return record.trace_block(tracer.path)


def maybe_enable_from_env() -> Tracer | None:
    """Honor ``BRC_TRACE=<dir>`` (set by the chaos coordinator for its
    subprocess workers). No-op when unset or already configured."""
    out_dir = os.environ.get(TRACE_ENV)
    if out_dir and _tracer is None:
        return configure(out_dir)
    return None


# ---------------------------------------------------------------------------
# consumers: read / merge / digest / chrome / validate


def read_events(path) -> list:
    """Parse a trace JSONL file into its event dicts (raises on a torn
    line — :func:`validate_file` is the diagnostic form)."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def merge(out_dir, out_name: str = "trace.jsonl") -> pathlib.Path:
    """Merge every per-worker ``trace-*.jsonl`` in ``out_dir`` into ONE
    time-ordered ``out_name`` (the coordinator's post-run step; monotonic
    timestamps are system-wide, so sorting by ``ts`` is a true timeline).
    Returns the merged path."""
    out_dir = pathlib.Path(out_dir)
    events = []
    for p in sorted(out_dir.glob("trace-*.jsonl")):
        events.extend(read_events(p))
    events.sort(key=lambda e: e.get("ts", 0.0))
    merged = out_dir / out_name
    with open(merged, "w") as fh:
        for ev in events:
            fh.write(json.dumps(ev, separators=(",", ":"),
                                default=_jsonable) + "\n")
    return merged


def digest(events) -> dict:
    """Per-span-kind latency digest: ``{kind: {count, total_s, p50_s, p90_s,
    p99_s}}`` over span durations, exact nearest-rank percentiles via the one
    ``utils/metrics.percentiles`` implementation (the serving loop's future
    p50/p99 request-latency targets use the same helper). Instant events
    contribute a count-only entry (``total_s`` 0)."""
    from byzantinerandomizedconsensus_tpu_torch.utils.metrics import percentiles

    durs: dict = {}
    counts: dict = {}
    for ev in events:
        kind = ev.get("kind", "?")
        counts[kind] = counts.get(kind, 0) + 1
        if ev.get("ph") == "X":
            durs.setdefault(kind, []).append(float(ev.get("dur", 0.0)))
    out = {}
    for kind in sorted(counts):
        ds = durs.get(kind)
        if ds:
            p50, p90, p99 = percentiles(ds, (50, 90, 99))
            out[kind] = {"count": counts[kind],
                         "total_s": round(sum(ds), 6),
                         "p50_s": round(p50, 6), "p90_s": round(p90, 6),
                         "p99_s": round(p99, 6)}
        else:
            out[kind] = {"count": counts[kind], "total_s": 0.0}
    return out


def digest_file(path) -> dict:
    return digest(read_events(path))


def to_chrome(events) -> dict:
    """Chrome trace-event JSON (the ``{"traceEvents": [...]}`` object
    format): load in Perfetto / chrome://tracing next to a ``--profile``
    device trace. Spans map to complete events (``ph: "X"``), instants to
    ``ph: "i"`` with thread scope; timestamps are microseconds."""
    out = []
    for ev in events:
        ch = {"name": ev.get("kind", "?"), "ph": ev.get("ph", "i"),
              "ts": round(float(ev.get("ts", 0.0)) * 1e6, 1),
              "pid": ev.get("pid", 0), "tid": ev.get("tid", 0),
              "cat": "brc"}
        if ev.get("ph") == "X":
            ch["dur"] = round(float(ev.get("dur", 0.0)) * 1e6, 1)
        else:
            ch["s"] = "t"
        if ev.get("attrs"):
            ch["args"] = ev["attrs"]
        out.append(ch)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome(events, out_path) -> pathlib.Path:
    out_path = pathlib.Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(to_chrome(events)) + "\n")
    return out_path


#: Span-end comparisons tolerate the 1e-6 rounding of ts/dur.
_NEST_EPS = 5e-6


def validate_events(events) -> list:
    """Structural problems in a parsed event stream (empty = well-formed):
    every event needs kind/ph/ts, spans need a non-negative dur, and each
    worker's (pid, tid) span set must be properly nested — two spans on one
    thread either disjoint or contained, never partially overlapping."""
    problems = []
    spans: dict = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        if not ev.get("kind") or ev.get("ph") not in ("X", "i") \
                or not isinstance(ev.get("ts"), (int, float)):
            problems.append(f"event {i}: missing kind/ph/ts "
                            f"({json.dumps(ev)[:80]})")
            continue
        if ev["ph"] == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: span without valid dur")
                continue
            spans.setdefault((ev.get("pid"), ev.get("tid")), []).append(
                (float(ev["ts"]), float(dur), ev["kind"]))
    for (pid, tid), rows in spans.items():
        # Sort by start (longer span first on ties = the parent), then walk
        # with a stack of open span ends.
        rows.sort(key=lambda r: (r[0], -r[1]))
        stack: list = []
        for ts, dur, kind in rows:
            end = ts + dur
            while stack and stack[-1][0] <= ts + _NEST_EPS:
                stack.pop()
            if stack and end > stack[-1][0] + _NEST_EPS:
                problems.append(
                    f"worker (pid={pid}, tid={tid}): span {kind!r} "
                    f"[{ts:.6f}, {end:.6f}] overlaps enclosing "
                    f"{stack[-1][1]!r} ending {stack[-1][0]:.6f}")
            stack.append((end, kind))
    return problems


def validate_file(path) -> list:
    """:func:`validate_events` over a JSONL file, with per-line parse
    diagnostics instead of a raised exception."""
    problems = []
    events = []
    try:
        with open(path) as fh:
            for lineno, line in enumerate(fh, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except ValueError as e:
                    problems.append(f"line {lineno}: unparseable ({e})")
    except OSError as e:
        return [f"unreadable: {e}"]
    return problems + validate_events(events)
