"""Common-coin implementations (spec/PROTOCOL.md §5.3), in torch.

``local``  — an independent fair bit per (instance, round, replica).
``shared`` — one common bit per (instance, round), the keyed-PRF stub of a
threshold-signature coin.
"""

from __future__ import annotations

import torch

from byzantinerandomizedconsensus_tpu_torch.ops import prf


def coin_bits(cfg, seed, inst_ids: torch.Tensor, rnd: int) -> torch.Tensor:
    """Coin bits, shape (B, n) uint8."""
    inst = inst_ids.to(torch.int64)[:, None]
    B = inst.shape[0]
    if cfg.coin == "local":
        replica = torch.arange(cfg.n, dtype=torch.int64,
                               device=inst.device)[None, :]
        return prf.prf_bit(seed, inst, rnd, prf.COIN_STEP, replica, 0,
                           prf.LOCAL_COIN, pack=cfg.pack_version).to(torch.uint8)
    if cfg.coin != "shared":
        raise ValueError(f"unknown coin {cfg.coin!r}")
    bit = prf.prf_bit(seed, inst, rnd, prf.COIN_STEP, 0, 0, prf.SHARED_COIN,
                      pack=cfg.pack_version).to(torch.uint8)
    return bit.expand(B, cfg.n)


def coin_words(cfg, takes_coin: torch.Tensor) -> torch.Tensor:
    """(B,) int64 — the PRF words a round's coin needs when the replicas
    ``takes_coin`` (B, n) take it: one per such replica under the local
    coin, one per instance with any under the shared coin."""
    if cfg.coin == "local":
        return takes_coin.sum(dim=-1, dtype=torch.int64)
    return takes_coin.any(dim=-1).to(torch.int64)
