"""Live metrics plane — the Prometheus-style registry.

The port's copy of the reference ``obs/metrics.py``: the same metric names,
the same text exposition format and the same module functions. A
stdlib-only, thread-safe registry of counters (monotonic), gauges (set,
inc, dec) and fixed-bucket histograms with exact ``sum``/``count``. It is
inert when disabled: every module-level accessor checks one global and
hands back a shared no-op object, and nothing flows into any simulation
math, so results are bit-identical with metrics on or off.

Workers self-enable from the ``BRC_METRICS`` environment variable and ship
their registry :func:`snapshot`; a parent :func:`absorb`\\ s each snapshot
under a ``worker`` label. :func:`parse_text` reads exposition text back into
snapshot form, with :func:`histogram_quantile` and :func:`summary` on top.
"""

from __future__ import annotations

import math
import os
import threading

#: Environment variable enabling the registry in a process. The fleet
#: dispatcher sets it for its subprocess workers (serve/fleet.py) the same
#: way ``BRC_TRACE`` propagates the trace sink.
METRICS_ENV = "BRC_METRICS"

#: Default histogram edges for second-valued latencies (admit→dispatch→
#: reply): sub-ms to the 300 s HTTP wait ceiling, roughly log-spaced.
LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

#: Histogram edges for rounds-to-decision: the admission ceiling is 128
#: (serve/server.py), so the top finite edge matches it and the +Inf cell
#: catches undecided-at-cap instances.
ROUNDS_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)

#: The content type a Prometheus scraper expects from ``GET /metrics``.
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class _Null:
    """The shared no-op handed out by the disabled fast path: accepts every
    metric mutation, keeps nothing — one global check is the whole cost of
    a disabled call site."""

    def inc(self, n=1):
        pass

    def dec(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass

    def observe_many(self, vs):
        pass


_NULL = _Null()


def _labels_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter. ``inc()`` with a negative amount raises — the
    registry's one hard invariant (Prometheus counter semantics)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n=1):
        if n < 0:
            raise ValueError(f"counter increment {n} < 0 (counters are "
                             "monotonic; use a gauge)")
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value

    def _set(self, v):  # absorb() only: replace with a worker's snapshot
        with self._lock:
            self._value = float(v)


class Gauge:
    """Instantaneous value: set/inc/dec."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v):
        with self._lock:
            self._value = float(v)

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def dec(self, n=1):
        with self._lock:
            self._value -= n

    @property
    def value(self):
        with self._lock:
            return self._value

    _set = set


class Histogram:
    """Fixed-bucket histogram with exact ``sum`` and ``count``.

    ``buckets`` are the finite upper edges (ascending); a +Inf cell is
    implicit. Counts are stored per cell (non-cumulative); the text
    renderer emits the cumulative ``_bucket{le=...}`` series Prometheus
    expects. ``observe_many`` folds a whole array under one lock
    acquisition — the retire-loop path observes a batch per segment, not a
    Python call per instance."""

    __slots__ = ("_lock", "buckets", "counts", "sum", "count")

    def __init__(self, buckets):
        edges = tuple(float(b) for b in buckets)
        if not edges or list(edges) != sorted(set(edges)):
            raise ValueError(f"histogram buckets {buckets!r} must be "
                             "non-empty, ascending and unique")
        self._lock = threading.Lock()
        self.buckets = edges
        self.counts = [0] * (len(edges) + 1)   # last cell = +Inf
        self.sum = 0.0
        self.count = 0

    def _cell(self, v: float) -> int:
        lo, hi = 0, len(self.buckets)
        while lo < hi:                          # first edge >= v
            mid = (lo + hi) // 2
            if v <= self.buckets[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def observe(self, v):
        v = float(v)
        cell = self._cell(v)
        with self._lock:
            self.counts[cell] += 1
            self.sum += v
            self.count += 1

    def observe_many(self, vs):
        vs = [float(v) for v in vs]
        if not vs:
            return
        cells = [self._cell(v) for v in vs]
        with self._lock:
            for cell in cells:
                self.counts[cell] += 1
            self.sum += sum(vs)
            self.count += len(vs)

    def _set(self, entry: dict):  # absorb() only
        with self._lock:
            self.counts = [int(c) for c in entry["counts"]]
            self.sum = float(entry["sum"])
            self.count = int(entry["count"])


class Registry:
    """Thread-safe family registry: one entry per metric name, holding the
    type, help string, and the per-label-set children. The module-level
    accessors route here (or to the shared no-op when disabled)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict = {}   # name -> {"type", "help", "series"}

    def _family(self, name: str, kind: str, help_: str | None) -> dict:
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = self._families[name] = {
                        "type": kind, "help": help_ or name, "series": {}}
        if fam["type"] != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam['type']}, "
                f"not {kind}")
        return fam

    def _child(self, name, kind, help_, labels, make):
        fam = self._family(name, kind, help_)
        key = _labels_key(labels)
        child = fam["series"].get(key)
        if child is None:
            with self._lock:
                child = fam["series"].get(key)
                if child is None:
                    child = fam["series"][key] = (dict(labels), make())
        return child[1]

    def counter(self, name: str, help: str | None = None,
                **labels) -> Counter:
        return self._child(name, "counter", help, labels, Counter)

    def gauge(self, name: str, help: str | None = None, **labels) -> Gauge:
        return self._child(name, "gauge", help, labels, Gauge)

    def histogram(self, name: str, help: str | None = None,
                  buckets=LATENCY_BUCKETS_S, **labels) -> Histogram:
        return self._child(name, "histogram", help, labels,
                           lambda: Histogram(buckets))

    # -- export ------------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able registry state: the fleet-protocol shipping form and
        the input of :func:`absorb` / :func:`summary` — histogram counts
        per cell (non-cumulative, +Inf last)."""
        with self._lock:
            fams = {name: (fam["type"], fam["help"], list(fam["series"]
                           .values())) for name, fam in self._families.items()}
        out = {}
        for name, (kind, help_, series) in sorted(fams.items()):
            rows = []
            for labels, child in series:
                if kind == "histogram":
                    with child._lock:
                        rows.append({"labels": dict(labels),
                                     "buckets": list(child.buckets),
                                     "counts": list(child.counts),
                                     "sum": child.sum,
                                     "count": child.count})
                else:
                    rows.append({"labels": dict(labels),
                                 "value": child.value})
            out[name] = {"type": kind, "help": help_, "series": rows}
        return out

    def absorb(self, snap: dict | None, **labels) -> None:
        """Fold a worker's :func:`snapshot` into this registry, each series
        re-labeled with ``labels`` (the fleet merge: ``worker="0"``).
        Absolute-value semantics — the worker's counters are monotonic from
        its own zero, so latest-wins per labeled series is the correct
        federation rule."""
        if not snap:
            return
        for name, fam in snap.items():
            kind = fam.get("type")
            if kind not in ("counter", "gauge", "histogram"):
                continue
            for row in fam.get("series", ()):
                merged = dict(row.get("labels") or {})
                merged.update(labels)
                if kind == "histogram":
                    child = self.histogram(name, fam.get("help"),
                                           buckets=row["buckets"], **merged)
                elif kind == "counter":
                    child = self.counter(name, fam.get("help"), **merged)
                else:
                    child = self.gauge(name, fam.get("help"), **merged)
                child._set(row if kind == "histogram" else row["value"])

    def render(self) -> str:
        """The Prometheus text exposition format (``# HELP``/``# TYPE``
        heads, cumulative ``_bucket{le=...}`` + ``_sum``/``_count`` per
        histogram series)."""
        lines = []
        for name, fam in sorted(self.snapshot().items()):
            lines.append(f"# HELP {name} {_esc_help(fam['help'])}")
            lines.append(f"# TYPE {name} {fam['type']}")
            for row in fam["series"]:
                labels = row["labels"]
                if fam["type"] != "histogram":
                    lines.append(f"{name}{_label_str(labels)} "
                                 f"{_fmt(row['value'])}")
                    continue
                cum = 0
                for edge, cnt in zip(row["buckets"], row["counts"]):
                    cum += cnt
                    le = dict(labels, le=_fmt(edge))
                    lines.append(f"{name}_bucket{_label_str(le)} {cum}")
                cum += row["counts"][-1]
                inf = dict(labels, le="+Inf")
                lines.append(f"{name}_bucket{_label_str(inf)} {cum}")
                lines.append(f"{name}_sum{_label_str(labels)} "
                             f"{_fmt(row['sum'])}")
                lines.append(f"{name}_count{_label_str(labels)} "
                             f"{row['count']}")
        return "\n".join(lines) + "\n" if lines else ""


def _fmt(v) -> str:
    f = float(v)
    if f != f or f in (float("inf"), float("-inf")):
        return {float("inf"): "+Inf", float("-inf"): "-Inf"}.get(f, "NaN")
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _esc_help(s: str) -> str:
    return str(s).replace("\\", "\\\\").replace("\n", "\\n")


def _esc_label(s: str) -> str:
    return (str(s).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_str(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc_label(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


# ---------------------------------------------------------------------------
# module-level fast path


_registry: Registry | None = None


def enabled() -> bool:
    return _registry is not None


def current() -> Registry | None:
    return _registry


def counter(name: str, help: str | None = None, **labels):
    r = _registry
    if r is None:
        return _NULL
    return r.counter(name, help, **labels)


def gauge(name: str, help: str | None = None, **labels):
    r = _registry
    if r is None:
        return _NULL
    return r.gauge(name, help, **labels)


def histogram(name: str, help: str | None = None,
              buckets=LATENCY_BUCKETS_S, **labels):
    r = _registry
    if r is None:
        return _NULL
    return r.histogram(name, help, buckets=buckets, **labels)


def configure() -> Registry:
    """Enable the registry for this process (replacing any previous one —
    a fresh loadgen leg starts from zero)."""
    global _registry
    _registry = Registry()
    return _registry


def disable() -> None:
    """Return to the zero-work fast path."""
    global _registry
    _registry = None


def maybe_enable_from_env() -> Registry | None:
    """Honor ``BRC_METRICS=1`` (set by the fleet dispatcher for its
    subprocess workers). No-op when unset/falsy or already configured."""
    val = os.environ.get(METRICS_ENV, "")
    if val and val != "0" and _registry is None:
        return configure()
    return None


def snapshot() -> dict | None:
    r = _registry
    return None if r is None else r.snapshot()


def absorb(snap: dict | None, **labels) -> None:
    r = _registry
    if r is not None:
        r.absorb(snap, **labels)


def render() -> str:
    """The ``GET /metrics`` body: the registry in exposition format, or a
    comment naming the enable switch when the plane is off (an empty-ish
    body is still valid exposition text — scrapers see 200 either way)."""
    r = _registry
    if r is None:
        return f"# brc metrics disabled ({METRICS_ENV} unset)\n"
    return r.render()


# ---------------------------------------------------------------------------
# scrape consumers: parse / quantile / summary


def parse_text(body: str) -> dict:
    """Exposition text back into :func:`snapshot` form — the ONE scrape
    parser every consumer shares (loadgen SLO checks, ``brc-tpu dash``,
    the ``trace follow`` heartbeat). Histograms are reassembled from their
    cumulative ``_bucket`` series into per-cell counts; unparseable lines
    are skipped (a scrape is diagnostic, not load-bearing state)."""
    types: dict = {}
    helps: dict = {}
    values: dict = {}   # (name, labels_key) -> (labels, value)
    hists: dict = {}    # (name, labels_key) -> {"le": {edge: cum}, ...}
    for line in body.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3].strip()
            elif len(parts) >= 4 and parts[1] == "HELP":
                helps[parts[2]] = parts[3]
            continue
        name, labels, val = _parse_sample(line)
        if name is None:
            continue
        base, suffix = name, None
        for suf in ("_bucket", "_sum", "_count"):
            if name.endswith(suf) and types.get(name[:-len(suf)]) \
                    == "histogram":
                base, suffix = name[:-len(suf)], suf
                break
        if suffix is None:
            values[(name, _labels_key(labels))] = (labels, val)
            continue
        le = labels.pop("le", None)
        h = hists.setdefault((base, _labels_key(labels)),
                             {"labels": labels, "le": {}, "sum": 0.0,
                              "count": 0})
        if suffix == "_bucket" and le is not None:
            h["le"][le] = val
        elif suffix == "_sum":
            h["sum"] = val
        elif suffix == "_count":
            h["count"] = int(val)
    out: dict = {}

    def fam(name, kind):
        return out.setdefault(name, {"type": kind,
                                     "help": helps.get(name, name),
                                     "series": []})

    for (name, _), (labels, val) in values.items():
        kind = types.get(name, "gauge")
        if kind == "histogram":
            continue
        fam(name, kind)["series"].append({"labels": labels, "value": val})
    for (name, _), h in hists.items():
        finite = sorted((float(k), v) for k, v in h["le"].items()
                        if k != "+Inf")
        edges = [e for e, _ in finite]
        cums = [c for _, c in finite]
        inf_cum = h["le"].get("+Inf", h["count"])
        counts, prev = [], 0
        for c in cums:
            counts.append(int(c - prev))
            prev = c
        counts.append(int(inf_cum - prev))
        fam(name, "histogram")["series"].append(
            {"labels": h["labels"], "buckets": edges, "counts": counts,
             "sum": h["sum"], "count": h["count"]})
    return out


def _parse_sample(line: str):
    """One sample line -> (name, labels dict, float value); (None, ...) on
    anything that does not parse."""
    try:
        if "{" in line:
            name, rest = line.split("{", 1)
            inner, tail = rest.rsplit("}", 1)
            labels = {}
            for part in _split_labels(inner):
                k, v = part.split("=", 1)
                labels[k.strip()] = (v.strip().strip('"')
                                     .replace('\\"', '"')
                                     .replace("\\\\", "\\"))
            return name.strip(), labels, float(tail.split()[0])
        name, val = line.split(None, 1)
        return name, {}, float(val.split()[0])
    except (ValueError, IndexError):
        return None, None, None


def _split_labels(inner: str) -> list:
    """Split ``k="v",k2="v2"`` on commas outside quotes."""
    parts, buf, quoted = [], "", False
    i = 0
    while i < len(inner):
        ch = inner[i]
        if ch == "\\" and quoted and i + 1 < len(inner):
            buf += ch + inner[i + 1]
            i += 2
            continue
        if ch == '"':
            quoted = not quoted
        if ch == "," and not quoted:
            if buf.strip():
                parts.append(buf)
            buf = ""
        else:
            buf += ch
        i += 1
    if buf.strip():
        parts.append(buf)
    return parts


def histogram_quantile(series, q: float) -> float | None:
    """The Prometheus ``histogram_quantile`` estimate over one or more
    snapshot-form histogram series (summed when several — the fleet's
    per-worker series fold into one distribution): linear interpolation
    inside the bucket holding rank ``q*count``; the +Inf cell answers with
    the top finite edge. None on an empty histogram."""
    if isinstance(series, dict):
        series = [series]
    if not series:
        return None
    edges = list(series[0]["buckets"])
    counts = [0] * (len(edges) + 1)
    for s in series:
        if list(s["buckets"]) != edges:
            # mismatched edges: degrade to the coarsest shared view by
            # per-series quantile, worst case — never silently wrong
            return max(filter(lambda v: v is not None,
                              (histogram_quantile(x, q) for x in series)),
                       default=None)
        for i, c in enumerate(s["counts"]):
            counts[i] += int(c)
    total = sum(counts)
    if total == 0:
        return None
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= rank or i == len(counts) - 1:
            if i >= len(edges):        # +Inf cell
                return edges[-1]
            lo = edges[i - 1] if i else 0.0
            frac = (rank - cum) / c
            return lo + (edges[i] - lo) * min(max(frac, 0.0), 1.0)
        cum += c
    return edges[-1]


def _series_of(snap: dict | None, name: str) -> list:
    fam = (snap or {}).get(name) or {}
    return list(fam.get("series") or ())


def _sum_values(snap, name) -> float | None:
    rows = _series_of(snap, name)
    if not rows:
        return None
    return float(sum(r.get("value", 0.0) for r in rows))


def summary(snap: dict | None) -> dict:
    """The headline live-gauge digest off a snapshot (local or scraped via
    :func:`parse_text`): p50/p99 request latency (ms), decided fraction,
    replied/failed counts and the derived error rate — what the dash
    header, the ``trace follow`` heartbeat and the loadgen SLO gate all
    read. Every field is None when its series is absent."""
    lat = _series_of(snap, "brc_serve_request_latency_seconds")
    p50 = histogram_quantile(lat, 0.50)
    p99 = histogram_quantile(lat, 0.99)
    decided = _sum_values(snap, "brc_consensus_decided_total")
    undecided = _sum_values(snap, "brc_consensus_undecided_total")
    frac = None
    if decided is not None or undecided is not None:
        d, u = decided or 0.0, undecided or 0.0
        frac = round(d / (d + u), 6) if (d + u) else None
    replied = _sum_values(snap, "brc_serve_replied_total")
    failed = _sum_values(snap, "brc_serve_failed_total")
    err = None
    if replied is not None or failed is not None:
        r, f = replied or 0.0, failed or 0.0
        err = round(f / (r + f), 6) if (r + f) else 0.0
    return {
        "p50_latency_ms": (None if p50 is None
                           else round(p50 * 1e3, 3)),
        "p99_latency_ms": (None if p99 is None
                           else round(p99 * 1e3, 3)),
        "decided_fraction": frac,
        "replied": None if replied is None else int(replied),
        "failed": None if failed is None else int(failed),
        "error_rate": err,
    }


def scrape(url: str, timeout: float = 2.0) -> dict | None:
    """GET a ``/metrics`` endpoint and parse it (None when unreachable —
    consumers degrade, they never die on a dead endpoint)."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            body = resp.read().decode("utf-8", "replace")
    except (urllib.error.URLError, OSError, ValueError):
        return None
    return parse_text(body)
