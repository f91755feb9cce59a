"""Ben-Or randomized binary consensus — the round body, in torch
(spec/PROTOCOL.md §5.1) [Ben-Or, PODC 1983].

One round is 2 broadcast steps (report, propose) and a coin. All thresholds
are absolute in n and f (strict ``2*c > n``). Protocol A (benign adversaries:
none, crash) and Protocol B (lying adversaries: byzantine and the adaptive
family) differ only in the thresholds, chosen by ``cfg.lying_adversary``.
Under the lane runner ``n`` and ``f`` are (B,) per-row tensors, and under
the fused lanes ``lying_adversary`` is a (B,) bool tensor too: the
thresholds then take the arithmetic forms ``n + f·lying`` and
``1 + f·lying``, equal to the branches for both values.
"""

from __future__ import annotations

import torch

from byzantinerandomizedconsensus_tpu_torch.models import coins, committee, faults
from byzantinerandomizedconsensus_tpu_torch.models.delivery import make_counts
from byzantinerandomizedconsensus_tpu_torch.ops.prf import rows
from byzantinerandomizedconsensus_tpu_torch.utils import profiling


def round_body(cfg, seed, inst_ids, rnd: int, state: dict, adv, setup,
               counts_fn=None, stats=None, recv_ids=None, gather=None, obs=None) -> dict:
    """Execute one Ben-Or round; returns the new state dict.

    ``counts_fn`` and ``stats`` are the delivery hook and the sampler's cost
    counters (the propose step's over undecided replicas only),
    ``coin_words`` and ``fault_words``, ``recv_ids``/``gather`` the
    replica-sharded path's seams and ``obs`` the counter side channel, as
    in :func:`models.bracha.round_body`.
    """
    # Committee configs evaluate the thresholds over (C, f_C) (spec §10.3).
    n, f = committee.quorum_params(cfg)
    est, decided = state["est"], state["decided"]
    # The §9 fault masks of this round: extra sender silences after each
    # inject, and the partition side plane for the delivery law.
    fsil, fside = faults.round_masks(cfg, seed, inst_ids, rnd, setup.get("faults"),
                                     stats=stats)
    counts = make_counts(cfg, seed, inst_ids, rnd, setup, counts_fn=counts_fn,
                         stats=stats, fside=fside, recv_ids=recv_ids, obs=obs,
                         fsil=fsil)
    if gather is None:  # the unsharded path: R = n
        def gather(v):
            return v
    with_bias = counts_fn is None

    def inject(t, honest):
        """The adversary's wire, then the §9 fault silences, then the
        committee's membership silence (spec §10.4)."""
        v, s, b = adv.inject(seed, inst_ids, rnd, t, honest, setup, with_bias,
                             recv_ids=recv_ids)
        if fsil is not None:
            s = s | fsil
        msil = committee.step_silence(cfg, seed, inst_ids, rnd, t, stats=stats)
        return v, (s if msil is None else s | msil), b

    lying = cfg.lying_adversary
    if isinstance(lying, torch.Tensor):
        lyi = lying.to(torch.int64)
        quorum_rhs, adopt_min = n + f * lyi, 1 + f * lyi
    else:
        quorum_rhs = n + f if lying else n
        adopt_min = f + 1 if lying else 1
    quorum_rhs, adopt_min = rows(quorum_rhs, 2), rows(adopt_min, 2)
    one, zero, bot = (torch.tensor(v, dtype=torch.uint8, device=est.device)
                      for v in (1, 0, 2))

    # Step 0 — report: broadcast est.
    with profiling.annotate("brc/benor/report"):
        h0 = gather(est)
        v0, s0, b0 = inject(0, h0)
        r0, r1 = counts(0, h0, v0, s0, b0)
        prop = torch.where(2 * r1 > quorum_rhs, one,
                           torch.where(2 * r0 > quorum_rhs, zero, bot))

    # Step 1 — propose: broadcast prop (bot = 2 is not counted).
    with profiling.annotate("brc/benor/propose"):
        h1 = gather(prop)
        v1, s1, b1 = inject(1, h1)
        upd = ~decided
        p0, p1 = counts(1, h1, v1, s1, b1, need=upd)
        w = (p1 >= p0).to(torch.uint8)
        c = torch.where(w == 1, p1, p0)

    with profiling.annotate("brc/coin"):
        coin = coins.coin_bits(cfg, seed, inst_ids, rnd, recv_ids)
    adopt = c >= adopt_min
    new_est = torch.where(adopt, w, coin)
    n2, f2 = rows(n, 2), rows(f, 2)
    if isinstance(lying, torch.Tensor):
        decide_now = torch.where(rows(lying, 2), 2 * c > n2 + f2, c >= f2 + 1)
    else:
        decide_now = (2 * c > n2 + f2) if lying else (c >= f2 + 1)
    if stats is not None:
        stats["coin_words"] = coins.coin_words(cfg, upd & ~adopt)

    # Updates apply to every replica not yet decided (spec §6.3).
    return {
        "est": torch.where(upd, new_est, est),
        "decided_val": torch.where(upd & decide_now, w, state["decided_val"]),
        "decided": decided | (upd & decide_now),
        "phase": state["phase"] + upd.to(torch.int32),
    }
