"""Bracha message validation at count level (spec/PROTOCOL.md §5.1b), in torch.

Invalid messages join the silent set *before* the delivery draw, so they never
take a wait-quota slot.
"""

from __future__ import annotations

import torch


def live_counts(values: torch.Tensor, silent: torch.Tensor):
    """Global per-instance counts G_b of live messages with value b, (B,) int32."""
    live = ~silent
    g0 = (live & (values == 0)).sum(dim=-1, dtype=torch.int32)
    g1 = (live & (values == 1)).sum(dim=-1, dtype=torch.int32)
    return g0, g1


def validate_step1(cfg, values, g0_0, g0_1) -> torch.Tensor:
    """(B, n) bool — invalid step-1 messages, from step-0 global counts."""
    n, f = cfg.n_eff, cfg.f
    q = n - f
    ok1 = g0_1 >= (q + 1) // 2        # x=1: a ties->1 majority of a q-subset
    ok0 = g0_0 >= q // 2 + 1          # x=0: a strict majority
    ok = torch.where(values == 1, ok1[:, None],
                     torch.where(values == 0, ok0[:, None], True))
    return ~ok


def validate_step2(cfg, values, g1_0, g1_1) -> torch.Tensor:
    """(B, n) bool — invalid step-2 messages, from valid step-1 global counts."""
    n, f = cfg.n_eff, cfg.f
    q = n - f
    okv1 = g1_1 >= n // 2 + 1
    okv0 = g1_0 >= n // 2 + 1
    # z = bot: some q-subset of valid step-1 messages has no > n/2 majority.
    lo = torch.clamp(torch.clamp(q - g1_0, min=0), min=q - n // 2)
    hi = torch.clamp(torch.clamp(g1_1, max=q), max=n // 2)
    okbot = lo <= hi
    ok = torch.where(values == 1, okv1[:, None],
                     torch.where(values == 0, okv0[:, None], okbot[:, None]))
    return ~ok
