"""The sampled bit-match's two helpers: which instances to compare, and
whether two results agree.

The port's copy of ``sample_ids`` and ``compare_results`` of the reference
``tools/acceptance.py``, which ``cli bitmatch`` reads.
"""

from __future__ import annotations

import zlib

import numpy as np

from byzantinerandomizedconsensus_tpu_torch.config import SimConfig


def sample_ids(cfg: SimConfig, samples: int, tag: str = None,
               seed: int = None) -> np.ndarray:
    """A deterministic pseudo-random subset of exactly ``samples`` instance
    ids (without replacement), keyed by exactly one of ``tag`` or ``seed``;
    the whole id range when it is no larger than the request."""
    if (tag is None) == (seed is None):
        raise ValueError("sample_ids needs exactly one of tag= or seed=")
    if samples >= cfg.instances:
        return np.arange(cfg.instances, dtype=np.int64)
    rng = np.random.default_rng(zlib.crc32(tag.encode()) if seed is None else seed)
    return np.sort(rng.choice(cfg.instances, size=samples,
                              replace=False)).astype(np.int64)


def compare_results(ref, got) -> dict:
    """The bit-match surface (spec §1): per-instance (rounds, decision)."""
    if ref.rounds.shape != got.rounds.shape \
            or ref.decision.shape != got.decision.shape:
        return {"match": False, "mismatches": -1,
                "error": f"shape mismatch: arbiter {ref.rounds.shape} vs "
                         f"backend {got.rounds.shape}"}
    mism = int(np.count_nonzero((ref.rounds != got.rounds)
                                | (ref.decision != got.decision)))
    return {"match": mism == 0, "mismatches": mism}
