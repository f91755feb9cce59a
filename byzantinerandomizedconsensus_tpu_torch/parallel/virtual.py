"""``virtual:DxM`` — the sharded driver on CPU tensors: the host twin of
``parallel/sharded.py``.

The port's counterpart of the reference ``parallel/virtual.py``. It runs the
``(data, model)`` layout of the mesh with each model shard on its own
thread, through the same driver (:func:`parallel.sharded.run_mesh`): state
that holds only a receiver shard, a barrier-fenced all-gather of each
step's wire values, termination by a cross-shard count. The data axis
splits the instances as ``np.array_split`` does, without padding, as the
reference's does. It runs the model layer's whole surface, the §9 fault
schedules and the committee family included (the reference's
``tests/test_faults.py`` runs faults through it).

A validation instrument, not a performance path: the barriers of each step
cost more than the torch work they fence at small B.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from byzantinerandomizedconsensus_tpu_torch.backends.base import SimResult, SimulatorBackend
from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import check_plain_supported
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.parallel import sharded
from byzantinerandomizedconsensus_tpu_torch.parallel.mesh import make_mesh


class VirtualMeshBackend(SimulatorBackend):
    """``virtual:DxM`` — D data shards × M model (replica) shards, threads,
    on the CPU."""

    name = "virtual"
    device = torch.device("cpu")

    def __init__(self, n_data: int = 2, n_model: int = 2):
        self.n_data = max(1, n_data)
        self.n_model = max(1, n_model)
        self.mesh = make_mesh(self.n_data, self.n_model,
                              ["cpu"] * (self.n_data * self.n_model))

    def kernel_for(self, cfg: SimConfig) -> str:
        return "plain"

    def prepare(self, cfg: SimConfig) -> None:
        """Nothing to build: the plain path."""

    def run(self, cfg: SimConfig, inst_ids: Optional[np.ndarray] = None) -> SimResult:
        cfg = cfg.validate()
        if cfg.n % self.n_model:
            raise ValueError(f"n={cfg.n} not divisible by model-axis size {self.n_model}")
        check_plain_supported(cfg)
        ids = self._resolve_inst_ids(cfg, inst_ids)
        parts = np.array_split(np.arange(len(ids)), self.n_data)
        outs = sharded.run_mesh(cfg, self.mesh,
                                [torch.as_tensor(ids[sl], dtype=torch.int32) for sl in parts])
        rounds = np.empty(len(ids), dtype=np.int32)
        decision = np.empty(len(ids), dtype=np.uint8)
        for sl, out in zip(parts, outs):
            if out is not None:
                rounds[sl] = out[0].numpy()
                decision[sl] = out[1].numpy()
        return SimResult(config=cfg, inst_ids=ids, rounds=rounds, decision=decision)
