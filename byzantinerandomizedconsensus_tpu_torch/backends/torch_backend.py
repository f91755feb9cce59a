"""The torch backend: the round loop on a CUDA card through the port's
kernels, or anywhere through the plain torch round driver.

Three kernels, chosen per backend:

- ``"fused"`` launches ``csrc/fused_round.cu`` once per chunk: the whole
  round loop (delivery urn2; both protocols, every static adversary);
- ``"step"`` runs the per-step round driver (:func:`models.driver.run_chunk`)
  with a CUDA kernel as each broadcast step's delivery: ``csrc/keys_step.cu``
  under ``delivery="keys"``, ``csrc/urn_step.cu`` under ``delivery="urn"``;
- ``"plain"`` runs the same driver with each delivery law's plain torch
  version, on either surface.

The device is CUDA unless the caller asks for the CPU; with no card present
and the CPU not asked for, construction raises. The CPU runs ``"plain"``
only. With no kernel named, CUDA picks ``"fused"`` for urn2 and ``"step"``
for the per-step laws.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from byzantinerandomizedconsensus_tpu_torch.backends.base import (
    SimResult, SimulatorBackend, run_chunked)
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.models import driver
from byzantinerandomizedconsensus_tpu_torch.ops import (
    _build, _step, fused_round, keys_step, prf, urn_step)

KERNELS = ("fused", "step", "plain")
_STEP_KERNELS = {"keys": ("keys_step", keys_step.counts_fn),
                 "urn": ("urn_step", urn_step.counts_fn)}


class TorchBackend(SimulatorBackend):
    name = "torch"

    def __init__(self, kernel: Optional[str] = None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the torch backend runs on the "
                "card by default — pass device='cpu' for the plain path on "
                "the CPU")
        if kernel is not None and kernel not in KERNELS:
            raise ValueError(f"unknown kernel {kernel!r}; use one of {KERNELS}")
        if kernel in ("fused", "step") and self.device.type != "cuda":
            raise ValueError(
                f"kernel={kernel!r} launches CUDA kernels and needs a CUDA "
                f"device (got {self.device}); the CPU runs kernel='plain'")
        if kernel is None and self.device.type != "cuda":
            kernel = "plain"
        self.kernel = kernel

    def kernel_for(self, cfg: SimConfig) -> str:
        """The kernel a run of ``cfg`` takes: the one asked for, else
        ``"fused"`` for urn2 and ``"step"`` for the per-step laws."""
        if self.kernel is not None:
            return self.kernel
        return "fused" if cfg.delivery == "urn2" else "step"

    def check_supported(self, cfg: SimConfig) -> None:
        """Raise :class:`~ops.fused_round.FusedUnsupported` or
        :class:`~ops._step.StepUnsupported` for a config outside the
        kernel's surface; ``"plain"`` takes the union of both surfaces, by
        the delivery law."""
        kernel = self.kernel_for(cfg)
        step_law = cfg.delivery in _step.STEP_SUPPORTED["delivery"]
        if kernel == "fused" or (kernel == "plain" and not step_law):
            fused_round.check_fused_supported(cfg)
        else:
            _step.check_step_supported(cfg)

    def chunk_size(self, cfg: SimConfig) -> int:
        """Instances per call. The kernels take a whole chunk of the spec §2
        instance field (state is (B, n)); the plain driver holds (B, n) int64
        planes, so it is bounded by memory. (The plain keys law builds its
        (B, n, n) int64 keys :data:`ops.keys_step.PLAIN_PAIRS` triples at a
        time; what it holds whole is ``adaptive``'s (B, n, n) bool bias, one
        byte per triple.)"""
        pack_cap = {1: prf.MAX_INSTANCES, 2: prf.V2_MAX_INSTANCES}[cfg.pack_version]
        if self.kernel_for(cfg) != "plain":
            return pack_cap
        return max(1, min(pack_cap, (1 << 22) // cfg.n))

    def prepare(self, cfg: SimConfig) -> None:
        """Build (or load) the kernel a run of ``cfg`` launches, so a timed
        run does not pay for it."""
        if self.kernel_for(cfg) == "plain":
            return
        if self.kernel_for(cfg) == "fused":
            _build.load("fused_round")
        else:
            _build.load(_STEP_KERNELS[cfg.delivery][0])

    def run(self, cfg: SimConfig, inst_ids: Optional[np.ndarray] = None) -> SimResult:
        cfg = cfg.validate()
        self.check_supported(cfg)
        ids = self._resolve_inst_ids(cfg, inst_ids)
        self.prepare(cfg)
        chunk = min(self.chunk_size(cfg), max(1, len(ids)))
        kernel = self.kernel_for(cfg)
        if kernel == "fused":
            impl = functools.partial(fused_round.run_chunk, cfg)
        elif kernel == "step":
            impl = functools.partial(driver.run_chunk, cfg,
                                     counts_fn=_STEP_KERNELS[cfg.delivery][1])
        else:
            impl = functools.partial(driver.run_chunk, cfg)
        rounds, decision = run_chunked(impl, ids, chunk, self.device)
        return SimResult(config=cfg, inst_ids=ids, rounds=rounds, decision=decision)
