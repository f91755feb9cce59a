"""Urn delivery v3 (spec/PROTOCOL.md §4c) — the mode-anchored cheap law, in torch.

The port's counterpart of the reference ``ops/urn3.py``. Not a third exact
sampler of the §4b family but a different distribution: a receiver's dropped
count per class is the rounded hypergeometric mean plus a correction
``Binomial(4, 1/2) − 2`` (the popcount of one PRF nibble, minus 2), clamped
to the hypergeometric support. One threefry word per receiver-step and no
loop. This is the plain version of what the fused CUDA kernel runs per
thread (``csrc/fused_round.cuh``: ``cheap``, ``urn3_counts``).

Under the adaptive family the biased stratum runs first (nibbles 0 and 1),
then the rest of the urn (nibbles 2 and 3); without strata only nibbles 2
and 3 are read, as §4b-v2 seeds its segments.
"""

from __future__ import annotations

import torch

from byzantinerandomizedconsensus_tpu_torch.ops import prf, urn

#: Segments of the cheap law per receiver-step: without strata, with them.
SEGMENTS = {False: 2, True: 4}


def _cheap(u: torch.Tensor, seg: int, m, Lr, Dr) -> torch.Tensor:
    """One §4c segment: ``d = clamp(round(Dr·m/Lr) + popcount(nibble) − 2,
    HG support)``. ``u`` is the (B, R) int64 per-receiver PRF word; segment
    ``seg`` reads bits ``[8·seg, 8·seg + 4)``. ``m``, ``Lr`` and ``Dr`` are
    (B, R) integer tensors, non-negative, ``Dr <= Lr``. Returns (B, R)
    int32."""
    nib = (u >> (8 * seg)) & 0xF
    pop = (nib & 1) + ((nib >> 1) & 1) + ((nib >> 2) & 1) + ((nib >> 3) & 1)
    m, Lr, Dr = (x.to(torch.int64) for x in (m, Lr, Dr))
    den = torch.clamp(Lr, min=1)                      # Lr = 0 => m = Dr = 0
    base = torch.div(2 * Dr * m + den, 2 * den, rounding_mode="floor")
    lo = torch.clamp(Dr - (Lr - m), min=0)
    hi = torch.minimum(m, Dr)
    return torch.minimum(torch.maximum(base + pop - 2, lo), hi).to(torch.int32)


def cheap_split(u, m, st, L, D):
    """The drops ``(d0, d1)`` of values 0 and 1 at each receiver, split by
    the cheap law from the word ``u``: under strata (``st`` not ``None``)
    the biased stratum ``mb[w] = st[w] ? m[w] : 0`` absorbs ``min(D, Lb)``
    over nibbles 0 and 1 and the rest of the urn the remainder over nibbles
    2 and 3; without strata nibbles 2 and 3 split all of ``D``."""
    d = [torch.zeros_like(m[0]), torch.zeros_like(m[0])]
    mu, Lr, Dr = m[:2], L, D
    if st is not None:
        mb = [torch.where(s, c, 0) for s, c in zip(st, m)]
        Lb = mb[0] + mb[1] + mb[2]
        Db = torch.minimum(D, Lb)
        Lr, Dr = Lb, Db
        for w in (0, 1):
            d[w] = _cheap(u, w, mb[w], Lr, Dr)
            Lr = Lr - mb[w]
            Dr = Dr - d[w]
        mu = [m[w] - mb[w] for w in (0, 1)]
        Lr, Dr = L - Lb, D - Db
    for w in (0, 1):
        du = _cheap(u, 2 + w, mu[w], Lr, Dr)
        d[w] = d[w] + du
        Lr = Lr - mu[w]
        Dr = Dr - du
    return d[0], d[1]


def count_work(stats, name: str, D: torch.Tensor, strata: bool, lanes=None) -> None:
    """Add one step's cheap-law work to ``stats``, (B,) int64 each, over the
    receivers ``lanes`` whose counts are read (default all): ``name``, the
    drop words the law needs (one per receiver with ``D > 0``; with no drop
    every segment is 0 whatever the word), and ``cheap_segments``, the
    segments those receivers evaluate."""
    need = D > 0
    if lanes is not None:
        need = need & lanes
    words = need.sum(dim=-1, dtype=torch.int64)
    stats[name] = stats.get(name, 0) + words
    stats["cheap_segments"] = stats.get("cheap_segments", 0) + SEGMENTS[strata] * words


def counts_fn(cfg, seed, inst_ids, rnd, t, values, silent, faulty=None,
              honest=None, stats=None, stats_lanes=None, fside=None, recv_ids=None):
    """(c0, c1) delivered-value counts per receiver lane — spec §4c.

    The same class and stratum state as §4b and §4b-v2
    (:func:`ops.urn.lane_setup`); only the drop law differs. ``stats``, when
    a dict, gains ``urn3_words`` and ``cheap_segments`` (:func:`count_work`)
    over the receivers ``stats_lanes``. The lanes are the receivers
    ``recv_ids`` (default all n).
    """
    own_val, m, st, L, D = urn.lane_setup(cfg, values, silent, faulty, honest,
                                          seed, inst_ids, rnd, t, fside=fside,
                                          recv_ids=recv_ids)
    if stats is not None:
        count_work(stats, "urn3_words", D, st is not None, stats_lanes)
    inst = inst_ids.to(torch.int64)[:, None]
    recv = prf.receivers(cfg, recv_ids, values.device)[None, :]
    u = prf.prf_u32(seed, inst, rnd, t, recv, 0, prf.URN3, pack=cfg.pack_version)
    d0, d1 = cheap_split(u, m, st, L, D)
    c0 = m[0] - d0 + (own_val == 0).to(torch.int32)
    c1 = m[1] - d1 + (own_val == 1).to(torch.int32)
    return c0, c1
