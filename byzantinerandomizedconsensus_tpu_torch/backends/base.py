"""The simulator backend seam: ``run(cfg, inst_ids) -> SimResult``.

The port's copy of the reference ``backends/base.py``: the result type, the
chunked dispatch with tail padding, and the backend registry. Instance ``i``'s
trajectory depends only on ``(cfg, seed, i)`` (spec §1), so ``inst_ids`` may
be any subset of the config's instances.
"""

from __future__ import annotations

import abc
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from byzantinerandomizedconsensus_tpu_torch.config import SimConfig


@dataclasses.dataclass
class SimResult:
    """Per-instance outputs (spec §1): the bit-match surface."""

    config: SimConfig
    inst_ids: np.ndarray   # (I,) int64 — which instances these rows are
    rounds: np.ndarray     # (I,) int32 — rounds to termination (== round_cap if capped)
    decision: np.ndarray   # (I,) uint8 — 0/1 decided value, 2 = undecided (overflow)
    wall_s: float = 0.0

    @property
    def instances_per_sec(self) -> float:
        return len(self.inst_ids) / self.wall_s if self.wall_s > 0 else float("inf")


class SimulatorBackend(abc.ABC):
    name: str = "?"

    @abc.abstractmethod
    def run(self, cfg: SimConfig, inst_ids: Optional[np.ndarray] = None) -> SimResult:
        """Simulate the given instances (default: all of them) to termination."""

    @staticmethod
    def _resolve_inst_ids(cfg: SimConfig, inst_ids) -> np.ndarray:
        if inst_ids is None:
            return np.arange(cfg.instances, dtype=np.int64)
        ids = np.asarray(inst_ids, dtype=np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= cfg.instances):
            raise ValueError("inst_ids out of range for config")
        return ids

    def timed_run(self, cfg: SimConfig, inst_ids=None) -> SimResult:
        t0 = time.perf_counter()
        res = self.run(cfg, inst_ids)
        res.wall_s = time.perf_counter() - t0
        return res


def run_chunked(fn, ids: np.ndarray, chunk: int, device) -> tuple:
    """Run ``fn(chunk_ids) -> (rounds, decision)`` over fixed-size chunks.

    ``chunk_ids`` is an int32 tensor on ``device``. The tail chunk is padded
    with its last id to the chunk size, so every call sees one shape; padded
    rows decide with the instance they repeat and are discarded. Every chunk
    is dispatched before any result is fetched, and the results come back to
    the host in one copy.
    """
    if len(ids) == 0:
        return np.empty(0, dtype=np.int32), np.empty(0, dtype=np.uint8)
    rounds, decision = [], []
    for lo in range(0, len(ids), chunk):
        cids = ids[lo:lo + chunk]
        if len(cids) < chunk:
            cids = np.concatenate([cids, np.full(chunk - len(cids), cids[-1])])
        r, d = fn(torch.as_tensor(cids, dtype=torch.int32).to(device))
        rounds.append(r)
        decision.append(d)
    rounds = torch.cat(rounds)[:len(ids)].cpu().numpy().astype(np.int32, copy=False)
    decision = torch.cat(decision)[:len(ids)].cpu().numpy().astype(np.uint8, copy=False)
    return rounds, decision


_REGISTRY: dict[str, Callable[..., SimulatorBackend]] = {}


def register_backend(name: str, factory: Callable[..., SimulatorBackend]) -> None:
    _REGISTRY[name] = factory


def get_backend(name: str, **options) -> SimulatorBackend:
    """A new backend of the given name, built with ``options`` (e.g.
    ``device="cpu"``)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown backend {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**options)
