"""Urn delivery (spec/PROTOCOL.md §4b) — count-level message scheduling, in torch.

The port's counterpart of the reference ``ops/urn.py``. Every receiver
sees the same wire value from each sender, so one set of class totals
serves all lanes, except under Ben-Or's Byzantine pairing, where each of two
receiver classes has its own, and inside a §9 partition epoch, where each
side has its own. Each receiver drops ``D = L - (n-f-1)`` of its ``L`` live
messages, drawn sequentially without replacement from an urn of (stratum,
value) classes, the biased stratum first. :func:`counts_fn` is the plain version of the urn
kernel (``ops/urn_step.py``).

Under the lane runner (``backends/batch.py``) ``n_eff`` and ``f`` are (B,)
per-row tensors. The fused lanes' ``superset`` adversary takes the
two-stratum structure with per-row strata: the adaptive family's planes on
its rows, all False elsewhere, under which the two-stratum draws equal the
single-stratum ones (one urn, drawn in value order).
"""

from __future__ import annotations

import torch

from byzantinerandomizedconsensus_tpu_torch.models.adversaries import (
    maybe_two_faced, observed_minority)
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
               honest=None, seed=None, inst_ids=None, rnd=None, t=None,
               fside=None, recv_ids=None):
    """Shared §4b/§4b-v2 per-lane class state.

    ``values`` (B, n) wire values in {0, 1, 2}; ``silent`` (B, n) bool;
    ``faulty``/``honest`` (B, n), read under ``adaptive_min`` and the
    two-faced pairing, which also reads ``seed``, ``inst_ids``, ``rnd`` and
    the step ``t`` to draw its class values. Returns
    ``(own_val, m, st, L, D)``: the (B, R) own wire value, the per-lane live
    class counts ``m[w]`` (B, R) int32 over senders ``u != v``, the stratum
    flags ``st[w]`` (bool, broadcastable to (B, R); ``None`` without strata),
    and the urn totals ``L`` (live messages) and ``D`` (drops,
    ``L − (n−f−1)`` floored at 0). Under the two-faced pairing a receiver
    reads the class totals of its own class ``h = v >= (n+1)/2``, and its
    own value is the one its class sees. ``fside``, when given, is the (B, n)
    §9 partition side plane: a receiver's urn then holds only the live
    senders of its own side (the class totals split per side and are read by
    the receiver's side), and the own-sender term is subtracted as before.
    The lanes are the receivers ``recv_ids`` (global indices, a replica
    shard of the sharded path; default all n, R = n); the class totals
    range over every sender.
    """
    live = ~silent
    recv = prf.receivers(cfg, recv_ids, values.device)

    def at_lanes(x):
        """(B, n) -> (B, R): a plane read at the receiver lanes."""
        return x if recv_ids is None else x[:, recv]

    h_lane = recv[None, :] >= prf.rows((cfg.n_eff + 1) // 2, 2)
    tf = maybe_two_faced(cfg)
    if tf is not False:
        v0c, v1c = byz_class_values(cfg, seed, inst_ids, rnd, t, honest, faulty)
        if tf is not True:  # superset rows: the Byzantine code's only
            v0c = torch.where(tf[:, None], v0c, values)
            v1c = torch.where(tf[:, None], v1c, values)
        own_val = torch.where(h_lane, at_lanes(v1c), at_lanes(v0c))
    else:
        v0c = v1c = values
        own_val = at_lanes(values)
    sides = (live,) if fside is None else (live & (fside == 0), live & (fside == 1))

    def class_total(w):
        """(B, n) int32: the live senders of value w that each receiver's urn
        ranges over, its own included."""
        per_side = []
        for sel in sides:
            total = (sel & (v0c == w)).sum(dim=-1, dtype=torch.int32)[:, None]
            if v1c is not v0c:
                total1 = (sel & (v1c == w)).sum(dim=-1, dtype=torch.int32)[:, None]
                total = torch.where(h_lane, total1, total)
            per_side.append(total)
        if fside is None:
            return per_side[0]
        return torch.where(at_lanes(fside) == 1, per_side[1], per_side[0])

    live_at = at_lanes(live)
    m = [class_total(w) - (live_at & (own_val == w)).to(torch.int32) for w in (0, 1, 2)]
    st = None
    if cfg.adversary in ("adaptive", "superset"):
        # biased(w, v) = (w == 2) | (w != pref(v)), pref(v) = v >= (n+1)/2.
        st = st_ad = [h_lane, ~h_lane, torch.ones_like(h_lane)]
    if cfg.adversary in ("adaptive_min", "superset"):
        minority = observed_minority(honest, faulty)[:, None]
        st = st_min = [minority != 0, minority != 1,
                       torch.ones_like(minority, dtype=torch.bool)]
    if cfg.adversary == "superset":
        code = prf.rows(cfg.adv_code, 2)
        st = [torch.where(code == 3, a, (code == 4) & b) for a, b in zip(st_ad, st_min)]
    L = m[0] + m[1] + m[2]
    D = torch.clamp(L - prf.rows(cfg.n_eff - cfg.f - 1, 2), min=0).to(L.dtype)
    return own_val, m, st, L, D


def counts_fn(cfg, seed, inst_ids, rnd, t, values, silent, faulty=None,
              honest=None, stats=None, stats_lanes=None, fside=None, recv_ids=None):
    """(c0, c1) delivered-value counts per receiver lane — spec §4b.

    ``values`` (B, n) wire values, ``silent`` (B, n) bool (validation
    silences included), ``fside`` the §9 partition side plane or ``None``.
    Returns two (B, R) int32 over the receivers ``recv_ids`` (default all
    n). ``stats``, when a dict,
    gains, each (B,) int64 over the receivers ``stats_lanes`` (default
    all): ``urn_draws``, the draws the law needs (the sum of D);
    ``urn_words``, the receivers with a drop, each one PRF word; and
    ``urn_random_draws``, the draws that need a random word: D under one
    stratum, min(D, B0) under two, B0 being the receiver's live biased
    messages other than its own (the rest come from the preferred class
    without a draw; ``csrc/urn_step.cuh::urn_counts``).
    All lanes step together to the batch maximum of D; a lane past its own D
    is masked, which leaves its counts as the reference's masked tail does.
    """
    own_val, m, st, L, D = lane_setup(cfg, values, silent, faulty, honest,
                                      seed, inst_ids, rnd, t, fside=fside,
                                      recv_ids=recv_ids)
    if stats is not None:
        lanes = 1 if stats_lanes is None else stats_lanes
        random = D
        if st is not None:
            b0 = sum(torch.where(x, c, 0) for x, c in zip(st, m))
            random = torch.minimum(D, b0)
        for key, per in (("urn_draws", D), ("urn_words", (D > 0).to(torch.int32)),
                         ("urn_random_draws", random)):
            stats[key] = stats.get(key, 0) + (per * lanes).sum(dim=-1, dtype=torch.int64)
    inst = inst_ids.to(torch.int64)[:, None]
    recv = prf.receivers(cfg, recv_ids, values.device)[None, :]
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
