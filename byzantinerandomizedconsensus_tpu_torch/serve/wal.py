"""Write-ahead admission log: durable serving.

The port's copy of the reference ``serve/wal.py``, with its JSONL layout:
a log written by either package is recovered by the other. Every reply
this service produces is a pure function of (config, seed) — the
determinism the randomized protocol family gives us. That turns crash
recovery into *deterministic replay*: if the admitted envelope survives
the crash, re-running it through normal
admission under its original request id reproduces the reply bit for bit,
full spec-§11 session logs included. This module is the survival half of
that argument.

Format — one JSON object per line, append-only (``admission.wal`` inside
the log directory):

``{"op": "admit", "id": rid, "cfg": {...}, "env": {...}}``
    journaled *before* dispatch; ``cfg`` is the validated SimConfig as a
    dict, ``env`` the admission envelope (tenant / deadline_ms / priority /
    session_slots / check_invariants). Durable (fsync) on return.
``{"op": "done", "id": rid}`` / ``{"op": "fail", "id": rid}``
    appended at reply time (flushed, not fsynced — losing a completion
    record only costs one redundant, bit-identical replay).

Appends group-commit: concurrent ``append_admit`` callers that land inside
the same fsync window share a single ``os.fsync``, so a burst of
admissions pays ~one disk sync, not one per request.

Recovery (:func:`WriteAheadLog.plan_recovery`) reads the journal back
tolerating exactly one torn final line (a crash mid-append), pairs admits
with completions, and returns the incomplete admits in admission order plus
the highest request-id counter seen — the restarting dispatcher replays the
former under their original ids and resumes its counter past the latter.
Replaying appends fresh completion records to the same journal, so
recovering twice is a no-op.
"""

from __future__ import annotations

import json
import os
import threading

from byzantinerandomizedconsensus_tpu_torch.obs import metrics as _metrics
from byzantinerandomizedconsensus_tpu_torch.obs import trace as _trace

WAL_NAME = "admission.wal"


class WriteAheadLog:
    """Append-only JSONL journal with group-committed fsync."""

    def __init__(self, directory: str):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.path = os.path.join(self.directory, WAL_NAME)
        # opening for append repairs a torn final line first (a crash
        # mid-append) — otherwise our own appends would land after the
        # tear and turn it into mid-file corruption on the next read
        self._repair_tail()
        self._f = open(self.path, "a", encoding="utf-8")
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._written = 0   # lines written (flushed) so far
        self._synced = 0    # lines covered by the last fsync
        self._syncing = False
        self._closed = False

    def _repair_tail(self) -> None:
        """Truncate a torn final line (crash mid-append) before appending.
        Mid-file tears are NOT repaired — :meth:`read_entries` raises on
        them, because they mean corruption, not a crash."""
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except OSError:
            return
        if not raw:
            return
        keep = len(raw)
        nl = raw.rfind(b"\n")
        if raw[nl + 1:]:
            keep = nl + 1  # unterminated partial write: drop it
        else:
            prev = raw.rfind(b"\n", 0, nl)
            try:
                entry = json.loads(raw[prev + 1:nl])
                if not isinstance(entry, dict) or "op" not in entry:
                    raise ValueError("not a WAL entry")
            except ValueError:
                keep = prev + 1  # terminated but torn mid-JSON
        if keep < len(raw):
            with open(self.path, "r+b") as f:
                f.truncate(keep)

    # -- appends ---------------------------------------------------------

    def _write_locked(self, entry: dict) -> int:
        self._f.write(json.dumps(entry, sort_keys=True) + "\n")
        self._f.flush()
        self._written += 1
        _metrics.counter(
            "brc_wal_records_total",
            "WAL records appended, by kind.",
            op=entry["op"]).inc()
        return self._written

    def append_admit(self, rid: str, cfg_doc: dict, env: dict) -> None:
        """Journal an admitted envelope. Durable (fsynced) on return —
        callers dispatch only after this comes back."""
        with self._cv:
            seq = self._write_locked(
                {"op": "admit", "id": rid, "cfg": cfg_doc, "env": env})
            # Group commit: if a sync that will cover our line is already
            # running (or finished), ride it; otherwise become the syncer
            # for every line written so far.
            while self._synced < seq:
                if self._closed:
                    return
                if self._syncing:
                    self._cv.wait(timeout=1.0)
                    continue
                self._syncing = True
                target = self._written
                break
            else:
                return
        try:
            os.fsync(self._f.fileno())
        finally:
            with self._cv:
                self._synced = max(self._synced, target)
                self._syncing = False
                self._cv.notify_all()

    def append_done(self, rid: str, *, failed: bool = False) -> None:
        """Journal a completion (reply or failure). Flushed, not fsynced."""
        with self._cv:
            if self._closed:
                return
            self._write_locked({"op": "fail" if failed else "done",
                                "id": rid})

    def close(self) -> None:
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._f.flush()
            try:
                os.fsync(self._f.fileno())
            except OSError:
                pass
            self._f.close()
            self._cv.notify_all()

    # -- recovery --------------------------------------------------------

    @staticmethod
    def read_entries(directory: str) -> list:
        """All well-formed entries in journal order. A torn FINAL line —
        the signature of a crash mid-append — is dropped; a torn line
        anywhere else means real corruption and raises ValueError."""
        path = os.path.join(str(directory), WAL_NAME)
        if not os.path.exists(path):
            return []
        with open(path, "r", encoding="utf-8") as f:
            raw = f.read()
        lines = raw.split("\n")
        if lines and lines[-1] == "":
            lines.pop()
        entries = []
        for i, line in enumerate(lines):
            try:
                entry = json.loads(line)
                if not isinstance(entry, dict) or "op" not in entry:
                    raise ValueError("not a WAL entry")
            except ValueError:
                if i == len(lines) - 1:
                    break  # torn final line: crash mid-append, tolerated
                raise ValueError(
                    f"corrupt WAL line {i + 1} of {len(lines)} in {path!r} "
                    "(only the final line may be torn)")
            entries.append(entry)
        return entries

    @staticmethod
    def plan_recovery(directory: str) -> tuple:
        """Pair admits with completions: returns ``(incomplete, counter)``
        where ``incomplete`` is the admitted-but-unreplied admit entries in
        admission order and ``counter`` the highest numeric request-id
        suffix seen (the restarting dispatcher resumes past it)."""
        open_admits: dict = {}
        counter = 0
        for entry in WriteAheadLog.read_entries(directory):
            rid = entry.get("id")
            if entry["op"] == "admit":
                open_admits[rid] = entry
                tail = str(rid)[1:] if rid else ""
                if tail.isdigit():
                    counter = max(counter, int(tail))
            elif entry["op"] in ("done", "fail"):
                open_admits.pop(rid, None)
        return list(open_admits.values()), counter


def recover_payloads(directory: str) -> tuple:
    """The recovery plan as (rid, payload) pairs ready for re-admission:
    each payload is the journaled config dict with its envelope keys merged
    back in, exactly what the original ``/submit`` body carried."""
    incomplete, counter = WriteAheadLog.plan_recovery(directory)
    out = []
    for entry in incomplete:
        payload = dict(entry.get("cfg") or {})
        payload.update(entry.get("env") or {})
        out.append((entry["id"], payload))
    if out:
        _trace.event("serve.recover", pending=len(out), counter=counter)
        _metrics.counter(
            "brc_wal_recovered_total",
            "Incomplete WAL entries replayed at recovery.").inc(len(out))
    return out, counter
