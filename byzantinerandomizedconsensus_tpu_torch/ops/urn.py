"""Urn delivery (spec/PROTOCOL.md §4b) — count-level message scheduling, in torch.

The port's counterpart of the reference ``ops/urn.py`` on the path with no
partition: every receiver sees the same wire value from each sender, so one
set of global class totals serves all lanes, except under Ben-Or's
Byzantine pairing, where each of two receiver classes has its own. Each
receiver drops ``D = L - (n-f-1)`` of its ``L`` live messages, drawn
sequentially without replacement from an urn of (stratum, value) classes,
the biased stratum first. :func:`counts_fn` is the plain version of the urn
kernel (``ops/urn_step.py``).
"""

from __future__ import annotations

import torch

from byzantinerandomizedconsensus_tpu_torch.models.adversaries import observed_minority
from byzantinerandomizedconsensus_tpu_torch.ops import prf


def byz_class_values(cfg, seed, inst_ids: torch.Tensor, rnd, t,
                     honest: torch.Tensor, faulty: torch.Tensor):
    """The two-faced equivocation values of Ben-Or's Byzantine pairing
    (spec §4b): ``(v_class0, v_class1)``, each (B, n) uint8. A faulty sender
    shows receiver class h the value ``prf_sender(..., tag=h, sender) % 3``
    (2 is ⊥: a live message that is not counted); the others their honest
    value."""
    inst = inst_ids.to(torch.int64)[:, None]
    send = torch.arange(cfg.n, dtype=torch.int64, device=honest.device)[None, :]
    out = []
    for h in (0, 1):
        e = prf.prf_sender(seed, inst, rnd, t, h, send, prf.BYZ_VALUE,
                           pack=cfg.pack_version)
        out.append(torch.where(faulty, (e % 3).to(torch.uint8), honest))
    return out[0], out[1]


def lane_setup(cfg, values: torch.Tensor, silent: torch.Tensor, faulty=None,
               honest=None, seed=None, inst_ids=None, rnd=None, t=None):
    """Shared §4b/§4b-v2 per-lane class state.

    ``values`` (B, n) wire values in {0, 1, 2}; ``silent`` (B, n) bool;
    ``faulty``/``honest`` (B, n), read under ``adaptive_min`` and the
    two-faced pairing, which also reads ``seed``, ``inst_ids``, ``rnd`` and
    the step ``t`` to draw its class values. Returns
    ``(own_val, m, st, L, D)``: the (B, n) own wire value, the per-lane live
    class counts ``m[w]`` (B, n) int32 over senders ``u != v``, the stratum
    flags ``st[w]`` (bool, broadcastable to (B, n); ``None`` without strata),
    and the urn totals ``L`` (live messages) and ``D`` (drops,
    ``L − (n−f−1)`` floored at 0). Under the two-faced pairing a receiver
    reads the class totals of its own class ``h = v >= (n+1)/2``, and its
    own value is the one its class sees.
    """
    live = ~silent
    h_lane = (torch.arange(cfg.n, device=values.device)
              >= (cfg.n_eff + 1) // 2)[None, :]
    if cfg.adversary == "byzantine" and cfg.protocol != "bracha":
        v0c, v1c = byz_class_values(cfg, seed, inst_ids, rnd, t, honest, faulty)
        own_val = torch.where(h_lane, v1c, v0c)
    else:
        v0c = v1c = own_val = values
    m = []
    for w in (0, 1, 2):
        total = (live & (v0c == w)).sum(dim=-1, dtype=torch.int32)[:, None]
        if v1c is not v0c:
            total1 = (live & (v1c == w)).sum(dim=-1, dtype=torch.int32)[:, None]
            total = torch.where(h_lane, total1, total)
        m.append(total - (live & (own_val == w)).to(torch.int32))
    st = None
    if cfg.adversary == "adaptive":
        # biased(w, v) = (w == 2) | (w != pref(v)), pref(v) = v >= (n+1)/2.
        st = [h_lane, ~h_lane, torch.ones_like(h_lane)]
    elif cfg.adversary == "adaptive_min":
        minority = observed_minority(honest, faulty)[:, None]
        st = [minority != 0, minority != 1, torch.ones_like(minority, dtype=torch.bool)]
    L = m[0] + m[1] + m[2]
    D = torch.clamp(L - (cfg.n_eff - cfg.f - 1), min=0)
    return own_val, m, st, L, D


def counts_fn(cfg, seed, inst_ids, rnd, t, values, silent, faulty=None,
              honest=None, stats=None, stats_lanes=None):
    """(c0, c1) delivered-value counts per receiver lane — spec §4b.

    ``values`` (B, n) wire values, ``silent`` (B, n) bool (validation
    silences included). Returns two (B, n) int32. ``stats``, when a dict,
    gains ``urn_draws`` (B,) int64, the draws the law needs (the sum of D
    over the receivers ``stats_lanes``, default all).
    All lanes step together to the batch maximum of D; a lane past its own D
    is masked, which leaves its counts as the reference's masked tail does.
    """
    own_val, m, st, L, D = lane_setup(cfg, values, silent, faulty, honest,
                                      seed, inst_ids, rnd, t)
    if stats is not None:
        drawn = D if stats_lanes is None else D * stats_lanes
        stats["urn_draws"] = stats.get("urn_draws", 0) + drawn.sum(dim=-1, dtype=torch.int64)
    inst = inst_ids.to(torch.int64)[:, None]
    recv = torch.arange(cfg.n, dtype=torch.int64, device=values.device)[None, :]
    s = prf.prf_u32(seed, inst, rnd, t, recv, 0, prf.URN, pack=cfg.pack_version)
    rs, rd = prf.RED_SHIFTS[cfg.pack_version]
    r0, r1, r2 = (x.to(torch.int64) for x in m)
    L, D = L.to(torch.int64), D.to(torch.int64)

    def draw(s):
        s = (prf.mul32(s, prf.URN_LCG_A) + prf.URN_LCG_C) & prf.MASK32
        return s, (s ^ (s >> 16)) >> rs

    def step(j, s, r0, r1, r2):
        """General (two-stratum) draw — spec §4b verbatim."""
        s, u = draw(s)
        active = j < D
        b_rem = (torch.where(st[0], r0, 0) + torch.where(st[1], r1, 0)
                 + torch.where(st[2], r2, 0))
        in_biased = b_rem > 0
        R_cur = torch.where(in_biased, b_rem, r0 + r1 + r2 - b_rem)
        d = (u * R_cur) >> rd
        e0 = torch.where(st[0] == in_biased, r0, 0)
        e1 = torch.where(st[1] == in_biased, r1, 0)
        pick0 = d < e0
        pick1 = ~pick0 & (d < e0 + e1)
        pick2 = ~pick0 & ~pick1
        return (s, r0 - (pick0 & active).to(torch.int64),
                r1 - (pick1 & active).to(torch.int64),
                r2 - (pick2 & active).to(torch.int64))

    def step_single(j, s, r0, r1, r2):
        """Single-stratum draw (no adaptive strata): the urn size is L − j,
        and the ⊥ class is never read by the outputs, so it is not tracked."""
        s, u = draw(s)
        active = j < D
        d = (u * (L - j)) >> rd
        pick0 = d < r0
        pick1 = ~pick0 & (d < r0 + r1)
        return (s, r0 - (pick0 & active).to(torch.int64),
                r1 - (pick1 & active).to(torch.int64), r2)

    fn = step_single if st is None else step
    s = s.expand(r0.shape)
    for j in range(int(D.max()) if D.numel() else 0):
        s, r0, r1, r2 = fn(j, s, r0, r1, r2)
    c0 = (r0 + (own_val == 0).to(torch.int64)).to(torch.int32)
    c1 = (r1 + (own_val == 1).to(torch.int64)).to(torch.int32)
    return c0, c1
