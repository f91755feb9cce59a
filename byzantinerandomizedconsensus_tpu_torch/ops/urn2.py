"""Urn delivery v2 (spec/PROTOCOL.md §4b-v2) — direct dropped-count inversion,
in torch.

Samples each receiver's dropped count per tracked value as a hypergeometric
``d ~ HG(L, m, D)`` through the corner-minimal conditional-Bernoulli chain.
This is the plain version of what the fused CUDA kernel runs per thread
(csrc/fused_round.cuh ``urn2_chain``): here all lanes step together up to the
batch maximum of the chain length K, with lanes past their own K masked.
The two agree because a masked draw only advances the segment's LCG state,
which is dead after the segment (each segment reseeds from the PRF).

Under the adaptive family the biased stratum runs first (segments 0 and
1), then the rest of the urn (segments 2 and 3); without strata only
segments 2 and 3 run.
"""

from __future__ import annotations

import torch

from byzantinerandomizedconsensus_tpu_torch.ops import prf, urn


def _chain(seed, inst_ids, rnd, t, seg, m, Lr, Dr, pack=1, stats=None, lanes=None,
           recv=None):
    """One §4b-v2 segment: d ~ HG(Lr, m, Dr) via the corner-minimal chain.

    ``m``/``Lr``/``Dr`` are (B, R) int32, non-negative, at the (R,) global
    receiver indices ``recv`` (default 0..R-1). Returns (B, R) int32
    ``d``. ``stats``, when a dict, gains this segment's work per instance,
    (B,) int64 each: ``chain_trips`` (draws, the sum of K) and
    ``chain_seeds`` (lanes with K > 0, which need the segment's PRF word),
    over the (B, R) bool ``lanes`` whose counts are read (default all).
    """
    comp = Lr - m
    is_item = (m <= comp) & (m <= Dr)
    is_draw = ~is_item & (Dr <= comp)
    is_comp = ~is_item & ~is_draw
    K = torch.minimum(torch.minimum(m, comp), Dr)
    P = torch.where(is_draw, m, Dr).to(torch.int64)
    if stats is not None:
        for name, per_lane in (("chain_trips", K), ("chain_seeds", K > 0)):
            if lanes is not None:
                per_lane = per_lane * lanes
            stats[name] = stats.get(name, 0) + per_lane.sum(dim=-1, dtype=torch.int64)

    inst = inst_ids.to(torch.int64)[:, None]
    if recv is None:
        recv = torch.arange(m.shape[1], dtype=torch.int64, device=m.device)
    s = prf.prf_u32(seed, inst, rnd, t, recv[None, :], seg, prf.URN2, pack=pack)
    s = s.expand(m.shape).contiguous()
    a = torch.zeros_like(s)
    Lr64 = Lr.to(torch.int64)
    rs, rd = prf.RED_SHIFTS[pack]
    kmax = int(K.max()) if K.numel() else 0
    for j in range(kmax):
        s = (prf.mul32(s, prf.URN_LCG_A) + prf.URN_LCG_C) & prf.MASK32
        u = s ^ (s >> 16)
        # den >= 1 while j < K; lanes past their K are masked below.
        q = ((u >> rs) * (Lr64 - j)) >> rd
        a += (q < (P - a)) & (K > j)
    a = a.to(torch.int32)
    return torch.where(is_comp, Dr - a, a)


def counts_fn(cfg, seed, inst_ids, rnd, t, values, silent, faulty=None,
              honest=None, stats=None, stats_lanes=None, fside=None, recv_ids=None):
    """(c0, c1) delivered-value counts per receiver lane — spec §4b-v2.

    ``values`` (B, n) wire values, ``silent`` (B, n) bool (validation
    silences included). Returns two (B, R) int32 over the receivers
    ``recv_ids`` (default all n). The receiver's own value is added back:
    the urn ranges over the other senders only. ``faulty``
    and ``honest`` feed :func:`ops.urn.lane_setup` (adaptive_min's minority
    and the two-faced class values); ``fside`` is the §9 partition side
    plane or ``None``.

    Under the adaptive family the biased stratum ``mb[w] = st[w] ? m[w] : 0``
    absorbs ``Db = min(D, Lb)`` drops over segments 0 and 1, the rest of the
    urn the other ``D − Db`` over segments 2 and 3. Without strata the
    biased stratum is empty: segments 0 and 1 draw nothing and are skipped,
    and segments 2 and 3 keep their seeds. ``stats`` counts every segment
    that runs, over the receivers ``stats_lanes`` (default all).
    """
    own_val, m, st, L, D = urn.lane_setup(cfg, values, silent, faulty, honest,
                                          seed, inst_ids, rnd, t, fside=fside,
                                          recv_ids=recv_ids)
    recv = prf.receivers(cfg, recv_ids, values.device)
    d = [torch.zeros_like(m[0]), torch.zeros_like(m[0])]
    mu, Lr, Dr = m[:2], L, D
    if st is not None:
        mb = [torch.where(s, c, 0) for s, c in zip(st, m)]
        Lb = mb[0] + mb[1] + mb[2]
        Db = torch.minimum(D, Lb)
        Lr, Dr = Lb, Db
        for w in (0, 1):
            d[w] = _chain(seed, inst_ids, rnd, t, w, mb[w], Lr, Dr,
                          pack=cfg.pack_version, stats=stats, lanes=stats_lanes, recv=recv)
            Lr = Lr - mb[w]
            Dr = Dr - d[w]
        mu = [m[w] - mb[w] for w in (0, 1)]
        Lr, Dr = L - Lb, D - Db
    for w in (0, 1):
        du = _chain(seed, inst_ids, rnd, t, 2 + w, mu[w], Lr, Dr,
                    pack=cfg.pack_version, stats=stats, lanes=stats_lanes, recv=recv)
        d[w] = d[w] + du
        Lr = Lr - mu[w]
        Dr = Dr - du
    c0 = m[0] - d[0] + (own_val == 0).to(torch.int32)
    c1 = m[1] - d[1] + (own_val == 1).to(torch.int32)
    return c0, c1
