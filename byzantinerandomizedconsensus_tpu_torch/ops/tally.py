"""Quorum tallies: delivered vote counts per receiver, in torch.

The port's counterpart of the reference ``ops/tally.py``. Values on the wire
are {0, 1, 2 = ⊥}; counts are int32.
"""

from __future__ import annotations

import torch


def count_value(mask: torch.Tensor, values: torch.Tensor, val: int) -> torch.Tensor:
    """(B, R) int32 — delivered messages equal to ``val``. ``mask`` (B, R, n)
    bool; ``values`` (B, n) per sender or (B, R, n) per (recv, send)."""
    eq = (values[:, None, :] if values.dim() == 2 else values) == val
    return (mask & eq).sum(dim=-1, dtype=torch.int32)


def tally01(mask: torch.Tensor, values: torch.Tensor):
    """Counts of value 0 and of value 1 (⊥ is not counted)."""
    return count_value(mask, values, 0), count_value(mask, values, 1)
