"""Common-coin implementations (spec/PROTOCOL.md §5.3), in torch.

``local``  — an independent fair bit per (instance, round, replica).
``shared`` — one common bit per (instance, round), the keyed-PRF stub of a
threshold-signature coin.
``superset`` — the fused lanes' law (``backends/batch.py``): both are drawn
and the per-row ``cfg.coin_code`` (0 local, 1 shared) selects.
"""

from __future__ import annotations

import torch

from byzantinerandomizedconsensus_tpu_torch.ops import prf
from byzantinerandomizedconsensus_tpu_torch.ops.prf import receivers


def coin_bits(cfg, seed, inst_ids: torch.Tensor, rnd: int, recv_ids=None) -> torch.Tensor:
    """Coin bits, shape (B, R) uint8, of the replicas ``recv_ids`` (global
    indices; default all n)."""
    inst = inst_ids.to(torch.int64)[:, None]
    B = inst.shape[0]
    replica = receivers(cfg, recv_ids, inst.device)[None, :]
    if cfg.coin not in ("local", "shared", "superset"):
        raise ValueError(f"unknown coin {cfg.coin!r}")
    if cfg.coin != "shared":
        local = prf.prf_bit(seed, inst, rnd, prf.COIN_STEP, replica, 0,
                            prf.LOCAL_COIN, pack=cfg.pack_version).to(torch.uint8)
        if cfg.coin == "local":
            return local
    bit = prf.prf_bit(seed, inst, rnd, prf.COIN_STEP, 0, 0, prf.SHARED_COIN,
                      pack=cfg.pack_version).to(torch.uint8)
    shared = bit.expand(B, replica.shape[1])
    if cfg.coin == "shared":
        return shared
    return torch.where(prf.rows(cfg.coin_code, 2) == 1, shared, local)


def coin_words(cfg, takes_coin: torch.Tensor) -> torch.Tensor:
    """(B,) int64 — the PRF words a round's coin needs when the replicas
    ``takes_coin`` (B, n) take it: one per such replica under the local
    coin, one per instance with any under the shared coin."""
    if cfg.coin == "local":
        return takes_coin.sum(dim=-1, dtype=torch.int64)
    return takes_coin.any(dim=-1).to(torch.int64)
