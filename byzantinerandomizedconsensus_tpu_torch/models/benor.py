"""Ben-Or randomized binary consensus — the round body, in torch
(spec/PROTOCOL.md §5.1) [Ben-Or, PODC 1983].

One round is 2 broadcast steps (report, propose) and a coin. All thresholds
are absolute in n and f (strict ``2*c > n``). Protocol A (benign adversaries:
none, crash) and Protocol B (lying adversaries: byzantine and the adaptive
family) differ only in the thresholds, chosen by ``cfg.lying_adversary``.
"""

from __future__ import annotations

import torch

from byzantinerandomizedconsensus_tpu_torch.models import coins
from byzantinerandomizedconsensus_tpu_torch.models.delivery import make_counts


def round_body(cfg, seed, inst_ids, rnd: int, state: dict, adv, setup,
               counts_fn=None, stats=None) -> dict:
    """Execute one Ben-Or round; returns the new state dict.

    ``counts_fn`` and ``stats`` are the delivery hook and the sampler's cost
    counters (the propose step's over undecided replicas only) and
    ``coin_words``, as in :func:`models.bracha.round_body`.
    """
    n, f = cfg.n_eff, cfg.f
    est, decided = state["est"], state["decided"]
    counts = make_counts(cfg, seed, inst_ids, rnd, setup, counts_fn=counts_fn,
                         stats=stats)
    with_bias = counts_fn is None
    lying = cfg.lying_adversary
    quorum_rhs = n + f if lying else n
    adopt_min = f + 1 if lying else 1
    one, zero, bot = (torch.tensor(v, dtype=torch.uint8, device=est.device)
                      for v in (1, 0, 2))

    # Step 0 — report: broadcast est.
    v0, s0, b0 = adv.inject(seed, inst_ids, rnd, 0, est, setup, with_bias)
    r0, r1 = counts(0, est, v0, s0, b0)
    prop = torch.where(2 * r1 > quorum_rhs, one,
                       torch.where(2 * r0 > quorum_rhs, zero, bot))

    # Step 1 — propose: broadcast prop (bot = 2 is not counted).
    v1, s1, b1 = adv.inject(seed, inst_ids, rnd, 1, prop, setup, with_bias)
    upd = ~decided
    p0, p1 = counts(1, prop, v1, s1, b1, need=upd)
    w = (p1 >= p0).to(torch.uint8)
    c = torch.where(w == 1, p1, p0)

    coin = coins.coin_bits(cfg, seed, inst_ids, rnd)
    adopt = c >= adopt_min
    new_est = torch.where(adopt, w, coin)
    decide_now = (2 * c > n + f) if lying else (c >= f + 1)
    if stats is not None:
        stats["coin_words"] = coins.coin_words(cfg, upd & ~adopt)

    # Updates apply to every replica not yet decided (spec §6.3).
    return {
        "est": torch.where(upd, new_est, est),
        "decided_val": torch.where(upd & decide_now, w, state["decided_val"]),
        "decided": decided | (upd & decide_now),
        "phase": state["phase"] + upd.to(torch.int32),
    }
