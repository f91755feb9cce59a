"""Serializable per-lane state — the snapshot and restore seam of the
compacted lane grid.

The port's counterpart of the reference ``backends/lanestate.py``, with its
wire format. A lane of the compacted grid (``backends/compaction.py``)
carries a pure function of coordinates: the PRF key, the lane's own round
counter, the replica state rows (``models/state.py`` layout), the adversary
and fault setup products and, with counters on, the counter accumulator.
The PRF addresses every draw by ``(key, instance, round, step, ...)`` (spec
§2), never by placement, so that row is the instance's whole future: frozen
at a segment boundary and thawed in any grid of the same bucket, the
instance continues bit-identically, in this package or in the reference.

- :class:`LaneRecord` — one config's extractable state: the config, its
  instance ids, the partial results already retired, the queued
  ``(pos, iid)`` entries not yet dispatched, and the live lanes' arrays.
  Versioned (:data:`LANESTATE_VERSION`); :meth:`LaneRecord.from_doc`
  refuses another version by name (:class:`LaneStateVersionError`).
- :meth:`LaneRecord.to_doc` / :meth:`LaneRecord.from_doc` — the JSON-safe
  array codec.
- :class:`LaneControl` — the thread-safe mailbox through which a scheduler
  asks a flying ``run_bucket`` to **park** (export everything and return)
  or **extract** named tokens (keep flying), serviced at segment
  boundaries only.

The record's layout is the reference's: ``setup`` holds the setup dict's
leaves in sorted-key order with nested dicts flattened in place
(``crash_round``, the §9 schedule's arrays by name, ``faulty``), and
``acc`` the counter rows as (lo, hi) u32 word pairs.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np

from byzantinerandomizedconsensus_tpu_torch.config import SimConfig

#: The lane-state schema version. Bump whenever the carry row layout changes
#: (st keys, setup leaf order, acc shape) — a restore across versions would
#: silently corrupt draws, so :func:`LaneRecord.from_doc` rejects by name.
LANESTATE_VERSION = 1


class LaneStateVersionError(ValueError):
    """A serialized lane record speaks a different schema version."""


def _nd_doc(a) -> dict:
    a = np.asarray(a)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "data": a.reshape(-1).tolist()}


def _nd_undoc(d) -> np.ndarray:
    return np.asarray(d["data"], dtype=np.dtype(d["dtype"])).reshape(
        tuple(d["shape"]))


def _tree_doc(obj):
    """JSON-encode a pytree of numpy arrays (dict / list / ndarray)."""
    if isinstance(obj, dict):
        return {"kind": "dict",
                "items": {k: _tree_doc(v) for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {"kind": "list", "items": [_tree_doc(v) for v in obj]}
    return {"kind": "nd", **_nd_doc(obj)}


def _tree_undoc(doc):
    kind = doc.get("kind")
    if kind == "dict":
        return {k: _tree_undoc(v) for k, v in doc["items"].items()}
    if kind == "list":
        return [_tree_undoc(v) for v in doc["items"]]
    return _nd_undoc(doc)


@dataclasses.dataclass
class LaneRecord:
    """One config's serialized lane state, captured at a segment boundary.

    ``lanes`` is the mid-round surface: parallel arrays over the config's
    live lanes at capture time — ``pos`` (row position in the config's
    instance list), ``r`` (per-lane round counter), ``st`` (dict of packed
    replica-state rows, models/state.py layout), ``setup`` (the adversary
    setup dict's leaves, flattened in sorted-key order — the
    structure is a pure function of the bucket, so leaves alone round-trip),
    and optionally ``acc`` (the counter accumulator rows).

    ``pending`` is the not-yet-dispatched surface: ``(pos, iid)`` pairs that
    were still queued in the host work stream. A restore re-derives their
    lanes from scratch — initial state is a pure function of ``(key, iid)``,
    so fresh init is bit-identical to having never been exported.

    ``rounds`` / ``decision`` hold the partial results of instances that
    already retired before capture; ``remaining`` counts what the record
    still owes (``len(pending) + len(lanes["pos"])``).

    ``token`` is the in-process retire token (e.g. the ServeRequest). It is
    deliberately NOT serialized — across a process boundary the importer
    supplies its own token.
    """

    version: int
    cfg: SimConfig
    ids: np.ndarray
    rounds: np.ndarray
    decision: np.ndarray
    remaining: int
    pending: list  # [(pos, iid), ...]
    lanes: dict    # {"pos", "r", "st": {...}, "setup": [leaves], "acc"?}
    token: object = None
    #: Counters-mode only: the partial per-instance counter accumulator
    #: ``(len(ids), n_counters, 2)`` for instances retired before capture
    #: (live lanes' accumulators ride ``lanes["acc"]`` instead).
    acc_done: Optional[np.ndarray] = None

    def lane_count(self) -> int:
        return int(np.asarray(self.lanes["pos"]).shape[0])

    def doc_summary(self) -> dict:
        """The trace/metrics-facing shape of this record (no arrays)."""
        return {"version": self.version, "instances": len(self.ids),
                "remaining": self.remaining, "pending": len(self.pending),
                "mid_round_lanes": self.lane_count()}

    def to_doc(self) -> dict:
        """JSON-safe document (fleet worker protocol). ``token`` is NOT
        serialized — the importer owns request identity."""
        lanes = {
            "pos": _nd_doc(self.lanes["pos"]),
            "r": _nd_doc(self.lanes["r"]),
            "st": {k: _nd_doc(v) for k, v in self.lanes["st"].items()},
            "setup": [_tree_doc(leaf) for leaf in self.lanes["setup"]],
        }
        if self.lanes.get("acc") is not None:
            lanes["acc"] = _nd_doc(self.lanes["acc"])
        doc = {
            "version": int(self.version),
            "cfg": dataclasses.asdict(self.cfg),
            "ids": _nd_doc(self.ids),
            "rounds": _nd_doc(self.rounds),
            "decision": _nd_doc(self.decision),
            "remaining": int(self.remaining),
            "pending": [[int(p), int(i)] for p, i in self.pending],
            "lanes": lanes,
        }
        if self.acc_done is not None:
            doc["acc_done"] = _nd_doc(self.acc_done)
        return doc

    @classmethod
    def from_doc(cls, doc: dict, token=None) -> "LaneRecord":
        ver = doc.get("version")
        if ver != LANESTATE_VERSION:
            raise LaneStateVersionError(
                f"lanestate version {ver!r} (this build speaks "
                f"{LANESTATE_VERSION}): refusing to restore — a cross-"
                "version splice would silently corrupt lane draws")
        ld = doc["lanes"]
        lanes = {
            "pos": _nd_undoc(ld["pos"]),
            "r": _nd_undoc(ld["r"]),
            "st": {k: _nd_undoc(v) for k, v in ld["st"].items()},
            "setup": [_tree_undoc(leaf) for leaf in ld["setup"]],
        }
        if "acc" in ld:
            lanes["acc"] = _nd_undoc(ld["acc"])
        return cls(
            version=int(ver),
            cfg=SimConfig(**doc["cfg"]).validate(),
            ids=_nd_undoc(doc["ids"]),
            rounds=_nd_undoc(doc["rounds"]),
            decision=_nd_undoc(doc["decision"]),
            remaining=int(doc["remaining"]),
            pending=[(int(p), int(i)) for p, i in doc["pending"]],
            lanes=lanes,
            token=token,
            acc_done=(_nd_undoc(doc["acc_done"])
                      if "acc_done" in doc else None),
        )


class _ControlRequest:
    """One park/extract ask, delivered at the next segment boundary."""

    def __init__(self, kind: str, tokens=None):
        self.kind = kind          # "park" | "extract"
        self.tokens = tokens      # extract: identity-matched token list
        self.records: list = []
        self._done = threading.Event()

    def deliver(self, records: list) -> None:
        self.records = records
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> list:
        self._done.wait(timeout)
        return self.records


class LaneControl:
    """The scheduler → grid mailbox for boundary snapshot requests.

    A scheduler thread calls :meth:`park` (export every extractable config
    and return from ``run_bucket``) or :meth:`extract` (export just the
    named tokens, keep flying). ``run_bucket`` services requests at its next
    segment boundary and delivers :class:`LaneRecord` lists; when the grid
    exits (drained, or parked) it **detaches**, delivering ``[]`` to any
    still-queued request so callers never hang on a dead rotation.

    Spec-§11 sessions are never extractable: a session's future slots chain
    at the grid's retire seam under bucket-resident state, so the session
    rides one grid whole (the same rule a fleet applies to
    whole-rotation stealing).
    """

    def __init__(self):
        self._cv = threading.Condition()
        self._requests: list = []
        self._detached = False
        #: Records delivered by a serviced park — the dispatcher reads these
        #: after ``run_bucket`` returns.
        self.parked: list = []

    def park(self, feed=None) -> _ControlRequest:
        """Ask the grid to export everything extractable and return. The
        grid's exit delivers the request; records also land in ``parked``.
        ``feed.poke()`` wakes a grid idling in its blocking pull."""
        req = _ControlRequest("park")
        with self._cv:
            if self._detached:
                req.deliver([])
                return req
            self._requests.append(req)
        if feed is not None:
            feed.poke()
        return req

    def extract(self, tokens, feed=None,
                timeout: Optional[float] = None) -> list:
        """Export the configs owning ``tokens`` (identity match) at the next
        boundary; the grid keeps flying. Blocks until delivered (or the
        grid detaches → ``[]``)."""
        req = _ControlRequest("extract", tokens=list(tokens))
        with self._cv:
            if self._detached:
                return []
            self._requests.append(req)
        if feed is not None:
            feed.poke()
        return req.wait(timeout)

    # ---- grid side -------------------------------------------------------

    def _pop_request(self):
        with self._cv:
            return self._requests.pop(0) if self._requests else None

    def _deliver_park(self, req: _ControlRequest, records: list) -> None:
        self.parked.extend(records)
        req.deliver(records)

    def detach(self) -> None:
        """Grid exit: fail any queued request with an empty delivery and
        refuse new ones — callers must not hang on a finished rotation."""
        with self._cv:
            self._detached = True
            reqs, self._requests = self._requests, []
        for req in reqs:
            req.deliver([])
