"""Bracha-style randomized consensus over reliable broadcast — the round body,
in torch (spec/PROTOCOL.md §5.2) [Bracha, Information & Computation 75, 1987].

One round is 3 broadcast steps, each simulated at count level through the
delivered guarantees of reliable broadcast under n > 3f. Thresholds: > n/2
absolute for decide-proposals, 2f+1 to decide, f+1 to adopt.
"""

from __future__ import annotations

import torch

from byzantinerandomizedconsensus_tpu_torch.models import coins, committee, faults, validation
from byzantinerandomizedconsensus_tpu_torch.models.delivery import make_counts
from byzantinerandomizedconsensus_tpu_torch.ops.prf import rows
from byzantinerandomizedconsensus_tpu_torch.utils import profiling


def round_body(cfg, seed, inst_ids, rnd: int, state: dict, adv, setup,
               counts_fn=None, stats=None, recv_ids=None, gather=None, obs=None) -> dict:
    """Execute one Bracha round; returns the new state dict.

    ``counts_fn`` swaps a per-step kernel in for the delivery law's plain
    torch version (models/delivery.py). The kernels recompute the scheduling
    bias from the wire values, so no bias is built for them. ``stats``, when
    a dict, collects the delivery sampler's cost counters — a side output
    the round math never reads — over the receivers whose counts are read
    (the last step's only by undecided replicas), ``coin_words`` and, under
    omission, the fault schedule's ``fault_words``.

    ``recv_ids``/``gather`` are the replica-sharded path's seams
    (``parallel/sharded.py``): the state holds only the receivers
    ``recv_ids`` (global indices), and ``gather`` all-gathers each step's
    (B, R) values to the full (B, n) width before the adversary, validation
    and delivery see them. Validation and the live counts run over the
    full sender width. Without them R = n and nothing is gathered.

    ``obs``, when a dict, receives each step's counter side channel
    (``models/delivery.py::make_counts``, ``obs/counters.py``).

    Under the lane runner (``backends/batch.py``) ``cfg``'s ``n_eff`` and
    ``f``, the key and ``rnd`` may be (B,) per-row tensors; the thresholds
    read them as (B, 1) columns.
    """
    # Committee configs evaluate the thresholds over (C, f_C) (spec §10.3).
    n, f = committee.quorum_params(cfg)
    est, decided = state["est"], state["decided"]
    # The §9 fault masks of this round: fault silences join the silent set
    # before the §5.1b validation counts (a fault-silent sender's message
    # does not exist, so it cannot vouch for validity); the partition cut
    # applies only at the delivery law.
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

    # Step 0 — broadcast est; majority of delivered (ties -> 1).
    with profiling.annotate("brc/bracha/initial"):
        h0 = gather(est)
        v0, s0, b0 = inject(0, h0)
        g0_0, g0_1 = validation.live_counts(v0, s0)
        c0_0, c0_1 = counts(0, h0, v0, s0, b0)
        m = (c0_1 >= c0_0).to(torch.uint8)

    # Step 1 — broadcast m; invalid messages silenced before delivery
    # (spec §5.1b); a decide-proposal needs an absolute > n/2 quorum.
    with profiling.annotate("brc/bracha/echo"):
        h1 = gather(m)
        v1, s1, b1 = inject(1, h1)
        s1 = s1 | validation.validate_step1(cfg, v1, g0_0, g0_1, nf=(n, f))
        g1_0, g1_1 = validation.live_counts(v1, s1)
        c1_0, c1_1 = counts(1, h1, v1, s1, b1)
        one, zero, bot = (torch.tensor(v, dtype=torch.uint8, device=est.device)
                          for v in (1, 0, 2))
        n2, f2 = rows(n, 2), rows(f, 2)  # (B, 1) under the lane runner
        d = torch.where(2 * c1_1 > n2, one, torch.where(2 * c1_0 > n2, zero, bot))

    # Step 2 — broadcast d (bot = 2 is not counted); validated against G1.
    with profiling.annotate("brc/bracha/ready"):
        h2 = gather(d)
        v2, s2, b2 = inject(2, h2)
        s2 = s2 | validation.validate_step2(cfg, v2, g1_0, g1_1, nf=(n, f))
        upd = ~decided
        c2_0, c2_1 = counts(2, h2, v2, s2, b2, need=upd)
        w = (c2_1 >= c2_0).to(torch.uint8)
        c = torch.where(w == 1, c2_1, c2_0)

    with profiling.annotate("brc/coin"):
        coin = coins.coin_bits(cfg, seed, inst_ids, rnd, recv_ids)
    decide_now = c >= 2 * f2 + 1
    adopt = c >= f2 + 1
    new_est = torch.where(adopt, w, coin)
    if stats is not None:
        stats["coin_words"] = coins.coin_words(cfg, upd & ~adopt)

    return {
        "est": torch.where(upd, new_est, est),
        "decided_val": torch.where(upd & decide_now, w, state["decided_val"]),
        "decided": decided | (upd & decide_now),
        "phase": state["phase"] + upd.to(torch.int32),
    }
