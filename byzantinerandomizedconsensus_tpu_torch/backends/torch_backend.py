"""The torch backend: the round loop on a CUDA card through the fused kernel,
or anywhere through the plain torch round driver.

``TorchBackend(kernel="fused")`` launches ``csrc/fused_round.cu`` once per
chunk; ``kernel="plain"`` runs :func:`ops.fused_round.run_chunk_plain`. The
device is CUDA unless the caller asks for the CPU; with no card present and
the CPU not asked for, construction raises. The CPU runs the plain path only.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from byzantinerandomizedconsensus_tpu_torch.backends.base import (
    SimResult, SimulatorBackend, run_chunked)
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.ops import _build, fused_round, prf

KERNELS = ("fused", "plain")


class TorchBackend(SimulatorBackend):
    name = "torch"

    def __init__(self, kernel: Optional[str] = None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the torch backend runs on the "
                "card by default — pass device='cpu' for the plain path on "
                "the CPU")
        if kernel is None:
            kernel = "fused" if self.device.type == "cuda" else "plain"
        if kernel not in KERNELS:
            raise ValueError(f"unknown kernel {kernel!r}; use one of {KERNELS}")
        if kernel == "fused" and self.device.type != "cuda":
            raise ValueError(
                "kernel='fused' launches the CUDA kernel and needs a CUDA "
                f"device (got {self.device}); the CPU runs kernel='plain'")
        self.kernel = kernel

    def chunk_size(self, cfg: SimConfig) -> int:
        """Instances per call. The kernel takes a whole chunk of the spec §2
        instance field in one launch (one CTA per instance); the plain driver
        holds (B, n) int64 planes, so it is bounded by memory."""
        pack_cap = {1: prf.MAX_INSTANCES, 2: prf.V2_MAX_INSTANCES}[cfg.pack_version]
        if self.kernel == "fused":
            return pack_cap
        return max(1, min(pack_cap, (1 << 22) // cfg.n))

    def prepare(self) -> None:
        """Build (or load) the kernel, so a timed run does not pay for it."""
        if self.kernel == "fused":
            _build.load("fused_round")

    def run(self, cfg: SimConfig, inst_ids: Optional[np.ndarray] = None) -> SimResult:
        cfg = cfg.validate()
        fused_round.check_fused_supported(cfg)
        ids = self._resolve_inst_ids(cfg, inst_ids)
        self.prepare()
        chunk = min(self.chunk_size(cfg), max(1, len(ids)))
        impl = (fused_round.run_chunk if self.kernel == "fused"
                else fused_round.run_chunk_plain)
        rounds, decision = run_chunked(functools.partial(impl, cfg), ids, chunk,
                                       self.device)
        return SimResult(config=cfg, inst_ids=ids, rounds=rounds, decision=decision)
