"""The §3.2 fault-prone set (spec/PROTOCOL.md §3.2, §9), in torch.

The port's counterpart of the reference ``models/faults.py::fault_prone_mask``.
The §9 fault schedules themselves are not ported yet; this module holds only
the selection law that the adversaries share with them.
"""

from __future__ import annotations

import torch

from byzantinerandomizedconsensus_tpu_torch.ops import prf


def fault_prone_mask(cfg, seed, inst_ids: torch.Tensor) -> torch.Tensor:
    """(B, n) bool — the f replicas with the smallest FAULTY_RANK keys
    ``(rank & KEY_MASK) | replica``. The keys are distinct (the low bits are
    the replica), so the f-th smallest is exact."""
    B, dev = inst_ids.shape[0], inst_ids.device
    if cfg.f == 0:
        return torch.zeros((B, cfg.n), dtype=torch.bool, device=dev)
    replica = torch.arange(cfg.n, dtype=torch.int64, device=dev)[None, :]
    rank = prf.prf_u32(seed, inst_ids.to(torch.int64)[:, None], 0, 0, replica, 0,
                       prf.FAULTY_RANK, pack=cfg.pack_version)
    key = (rank & prf.KEY_MASK[cfg.pack_version]) | replica
    kth = torch.kthvalue(key, cfg.f, dim=-1).values
    return key <= kth[:, None]
