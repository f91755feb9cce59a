"""Urn delivery (spec/PROTOCOL.md §4b) — the per-receiver class state, in torch.

The port's counterpart of the reference ``ops/urn.py::lane_setup`` on the path
with no partition and no two-faced values: every receiver sees the same wire
value from each sender, so one set of global class totals serves all lanes.
"""

from __future__ import annotations

import torch


def lane_setup(cfg, values: torch.Tensor, silent: torch.Tensor):
    """Shared §4b/§4b-v2 per-lane class state.

    ``values`` (B, n) wire values in {0, 1, 2}; ``silent`` (B, n) bool.
    Returns ``(own_val, m, L, D)``: the (B, n) own wire value, the per-lane
    live class counts ``m[w]`` (B, n) int32 over senders ``u != v``, and the
    urn totals ``L`` (live messages) and ``D`` (drops, ``L − (n−f−1)``
    floored at 0).
    """
    live = ~silent
    own_val = values
    m = []
    for w in (0, 1, 2):
        is_w = values == w
        total = (live & is_w).sum(dim=-1, dtype=torch.int32)[:, None]
        m.append(total - (live & is_w).to(torch.int32))
    L = m[0] + m[1] + m[2]
    k = cfg.n_eff - cfg.f - 1
    D = torch.clamp(L - k, min=0)
    return own_val, m, L, D
