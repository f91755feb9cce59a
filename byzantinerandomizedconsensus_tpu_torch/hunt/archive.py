"""The hunter's elite archive.

The port's copy of the reference ``hunt/archive.py``. Found worst cases are
only worth the hunt if they outlive it. The archive keeps the top-k
candidates by fitness and exports them as *pinned regression configs*:
genome, the exact per-instance (rounds, decision) arrays the server
produced, and a content digest (the path ``adaptive_min`` took by hand).
The digest is the reference's, byte for byte, so an export of either
package replays in the other: :func:`replay` decodes each genome through
the one ``validate()`` gate, re-runs it on the port's backend on an
explicit device (the plain driver on the CPU; on the card the kernel by
law, or the one named) and compares the arrays element for element
(tests/test_torch_hunt.py replays the committed
``artifacts/hunt_regressions.json`` this way).
"""

from __future__ import annotations

import hashlib
import json

from byzantinerandomizedconsensus_tpu_torch.hunt import space as _space
from byzantinerandomizedconsensus_tpu_torch.obs import record as _record


def _digest(genome: dict, rounds: list, decision: list) -> str:
    """Content address of a pinned worst case: genome + both result arrays,
    canonical JSON — any drift in replay changes the digest."""
    blob = json.dumps({"genome": genome, "rounds": rounds,
                       "decision": decision}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


class Archive:
    """Top-k elite archive, sorted worst-case-first (higher fitness = worse
    case = more valuable). ``offer`` is idempotent per genome: re-finding
    the same config updates nothing, so archive size counts *distinct*
    worst cases."""

    def __init__(self, k: int = 8):
        if k < 1:
            raise ValueError(f"archive k={k} out of range (>= 1)")
        self.k = int(k)
        self._entries: list = []  # dicts, sorted by fitness desc

    def __len__(self) -> int:
        return len(self._entries)

    def entries(self) -> list:
        return list(self._entries)

    def best(self) -> dict | None:
        return self._entries[0] if self._entries else None

    def offer(self, cfg, fitness: float, rounds, decision) -> bool:
        """Submit an evaluated candidate; returns True when it entered the
        elite set (new genome and fitness within the top k)."""
        genome = _space.encode(cfg)
        if any(e["genome"] == genome for e in self._entries):
            return False
        rounds = [int(r) for r in rounds]
        decision = [int(d) for d in decision]
        undecided = sum(1 for d in decision if d == 2)
        entry = {
            "fitness": round(float(fitness), 6),
            "genome": genome,
            "mean_rounds": round(sum(rounds) / max(1, len(rounds)), 6),
            "max_rounds": max(rounds) if rounds else 0,
            "undecided_fraction": round(undecided / max(1, len(decision)), 6),
            "rounds": rounds,
            "decision": decision,
            "digest": _digest(genome, rounds, decision),
        }
        self._entries.append(entry)
        self._entries.sort(key=lambda e: (-e["fitness"], e["digest"]))
        if len(self._entries) <= self.k:
            return True
        dropped = self._entries.pop()
        return dropped is not entry

    def export_doc(self, hunt_stats: dict | None = None) -> dict:
        """The committed ``hunt_regressions.json`` document: a schema-v1.8
        record whose payload is the elite entries (each independently
        replayable) plus the originating hunt's identity block."""
        doc = _record.new_record(
            "hunt_regressions",
            description="Elite archive of a seeded adversary hunt: each "
                        "entry is a pinned worst-case config with its exact "
                        "result arrays, replayable bit-identically")
        doc["k"] = self.k
        doc["entries"] = self.entries()
        if hunt_stats is not None:
            doc["hunt"] = _record.hunt_block(hunt_stats)
        return doc


def replay(entry: dict, device, backend: str = "torch", kernel=None) -> dict:
    """Re-run one archived worst case and compare bit for bit against its
    pinned arrays. ``device`` is explicit (``"cpu"`` or ``"cuda"``);
    ``backend`` and ``kernel`` are as ``cli run`` takes them (no kernel
    named: the kernel by law on the card). Returns ``{"ok", "digest_ok",
    "mismatches"}``: the committed-test contract and the re-verification
    path for later hunts."""
    from byzantinerandomizedconsensus_tpu_torch.cli import make_backend

    cfg = _space.decode(entry["genome"])
    res = make_backend(backend, device, kernel).run(cfg)
    rounds = [int(r) for r in res.rounds]
    decision = [int(d) for d in res.decision]
    mismatches = sum(1 for a, b in zip(rounds, entry["rounds"]) if a != b)
    mismatches += sum(1 for a, b in zip(decision, entry["decision"])
                      if a != b)
    mismatches += abs(len(rounds) - len(entry["rounds"]))
    digest_ok = _digest(entry["genome"], rounds, decision) == entry["digest"]
    return {"ok": mismatches == 0 and digest_ok,
            "digest_ok": digest_ok, "mismatches": int(mismatches)}
