"""Bracha-style randomized consensus over reliable broadcast — the round body,
in torch (spec/PROTOCOL.md §5.2) [Bracha, Information & Computation 75, 1987].

One round is 3 broadcast steps, each simulated at count level through the
delivered guarantees of reliable broadcast under n > 3f. Thresholds: > n/2
absolute for decide-proposals, 2f+1 to decide, f+1 to adopt.
"""

from __future__ import annotations

import torch

from byzantinerandomizedconsensus_tpu_torch.models import coins, validation
from byzantinerandomizedconsensus_tpu_torch.models.delivery import make_counts


def round_body(cfg, seed, inst_ids, rnd: int, state: dict, adv, setup,
               counts_fn=None, stats=None) -> dict:
    """Execute one Bracha round; returns the new state dict.

    ``counts_fn`` swaps a per-step kernel in for the delivery law's plain
    torch version (models/delivery.py). The kernels recompute the scheduling
    bias from the wire values, so no bias is built for them. ``stats``, when
    a dict, collects the delivery sampler's cost counters — a side output
    the round math never reads — over the receivers whose counts are read
    (the last step's only by undecided replicas), and ``coin_words``.
    """
    n, f = cfg.n_eff, cfg.f
    est, decided = state["est"], state["decided"]
    counts = make_counts(cfg, seed, inst_ids, rnd, setup, counts_fn=counts_fn,
                         stats=stats)
    with_bias = counts_fn is None

    # Step 0 — broadcast est; majority of delivered (ties -> 1).
    v0, s0, b0 = adv.inject(seed, inst_ids, rnd, 0, est, setup, with_bias)
    g0_0, g0_1 = validation.live_counts(v0, s0)
    c0_0, c0_1 = counts(0, est, v0, s0, b0)
    m = (c0_1 >= c0_0).to(torch.uint8)

    # Step 1 — broadcast m; invalid messages silenced before delivery
    # (spec §5.1b); a decide-proposal needs an absolute > n/2 quorum.
    v1, s1, b1 = adv.inject(seed, inst_ids, rnd, 1, m, setup, with_bias)
    s1 = s1 | validation.validate_step1(cfg, v1, g0_0, g0_1)
    g1_0, g1_1 = validation.live_counts(v1, s1)
    c1_0, c1_1 = counts(1, m, v1, s1, b1)
    one, zero, bot = (torch.tensor(v, dtype=torch.uint8, device=est.device)
                      for v in (1, 0, 2))
    d = torch.where(2 * c1_1 > n, one, torch.where(2 * c1_0 > n, zero, bot))

    # Step 2 — broadcast d (bot = 2 is not counted); validated against G1.
    v2, s2, b2 = adv.inject(seed, inst_ids, rnd, 2, d, setup, with_bias)
    s2 = s2 | validation.validate_step2(cfg, v2, g1_0, g1_1)
    upd = ~decided
    c2_0, c2_1 = counts(2, d, v2, s2, b2, need=upd)
    w = (c2_1 >= c2_0).to(torch.uint8)
    c = torch.where(w == 1, c2_1, c2_0)

    coin = coins.coin_bits(cfg, seed, inst_ids, rnd)
    decide_now = c >= 2 * f + 1
    adopt = c >= f + 1
    new_est = torch.where(adopt, w, coin)
    if stats is not None:
        stats["coin_words"] = coins.coin_words(cfg, upd & ~adopt)

    return {
        "est": torch.where(upd, new_est, est),
        "decided_val": torch.where(upd & decide_now, w, state["decided_val"]),
        "decided": decided | (upd & decide_now),
        "phase": state["phase"] + upd.to(torch.int32),
    }
