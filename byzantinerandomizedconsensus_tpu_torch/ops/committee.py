"""Committee-sampled delivery (spec/PROTOCOL.md §10) — sortition at count level,
in torch.

The port's counterpart of the reference ``ops/committee.py``. Per
(instance, round, step) a PRF-drawn committee of
``C(n) = min(n, max(16, 8·⌈log₂ n⌉))`` replicas broadcasts, everyone
listens, and the protocol thresholds are evaluated over committee counts
with the sampled fault budget ``f_C = ⌈C·f/n⌉ + ⌊√C⌋`` (spec §10.3). It is
the only delivery family admitted past the full-mesh ceiling n = 4096, under
the §2 v3 packing law, up to n = 2^20.

Replica u is in the committee of (instance, round, step) iff

    prf(seed, instance, round, step, recv=u, send=0, COMMITTEE) % n < C(n).

Non-members join the step's silent set (the round bodies OR the membership
silence in after the §9 fault silences and before §5.1b validation, spec
§10.4). Each receiver then drops ``D = max(0, L − k_C)`` of its ``L`` live
committee messages, ``k_C = C − f_C − 1``, split by the §4c cheap law with
the COMMITTEE ``send=1`` word; its own message is delivered iff it is itself
a member. The fused CUDA kernel runs the same law per thread
(``csrc/fused_round.cuh``: ``committee_counts``).

The integer laws are the reference's static compare-sums (no log2 or isqrt
library call), on python ints or, under the lane runner, on (B,) per-row
int64 tensors of ``n_eff`` and ``f``. Membership is drawn mod ``n_eff``, so
a padded lane's real replicas see the draws of the unpadded config.
"""

from __future__ import annotations

import torch

from byzantinerandomizedconsensus_tpu_torch.ops import prf, urn, urn3

#: C(n) law constants (spec §10.1).
SIZE_FLOOR = 16
SIZE_SLOPE = 8
#: ⌈log₂ n⌉ as a sum of compares: 20 terms cover n ≤ 2^20.
_CL2_BITS = 20
#: ⌊√C⌋ as a sum of compares: C ≤ 16 + 8·20 = 176 < 14², so 13 terms.
_ISQRT_MAX = 13


def committee_size(n):
    """C(n) = min(n, max(16, 8·⌈log₂ n⌉)) — spec §10.1."""
    if isinstance(n, torch.Tensor):
        cl2 = sum(((1 << k) < n).to(torch.int64) for k in range(_CL2_BITS))
        return torch.minimum(n, torch.clamp(SIZE_SLOPE * cl2, min=SIZE_FLOOR))
    cl2 = sum(1 for k in range(_CL2_BITS) if (1 << k) < n)
    return min(int(n), max(SIZE_FLOOR, SIZE_SLOPE * cl2))


def committee_fault_budget(n, f):
    """f_C (spec §10.3): ``f`` itself when the committee is the full mesh
    (C = n), else ``⌈C·f/n⌉ + ⌊√C⌋``."""
    c = committee_size(n)
    if isinstance(c, torch.Tensor):
        isq = sum((s * s <= c).to(torch.int64) for s in range(1, _ISQRT_MAX + 1))
        return torch.where(c == n, f, (c * f + n - 1) // n + isq)
    if c == n:
        return int(f)
    isq = sum(1 for s in range(1, _ISQRT_MAX + 1) if s * s <= c)
    return (c * int(f) + int(n) - 1) // int(n) + isq


def committee_quota(n: int, f: int) -> int:
    """k_C = C − f_C − 1, the per-receiver guaranteed-delivery quota of the
    §10.2 drop law (the committee's n − f − 1)."""
    return committee_size(n) - committee_fault_budget(n, f) - 1


def membership_plane(cfg, seed, inst_ids: torch.Tensor, rnd, t, recv_ids=None) -> torch.Tensor:
    """(B, R) bool — committee membership of the replicas ``recv_ids``
    (default all n) for step ``t`` (spec §10.1): each one's COMMITTEE
    ``send=0`` word mod n below C."""
    inst = inst_ids.to(torch.int64)[:, None]
    replica = prf.receivers(cfg, recv_ids, inst_ids.device)[None, :]
    word = prf.prf_u32(seed, inst, rnd, t, replica, 0, prf.COMMITTEE, pack=cfg.pack_version)
    ne = prf.rows(cfg.n_eff, 2)
    return (word % ne) < committee_size(ne)


def step_silence(cfg, seed, inst_ids: torch.Tensor, rnd, t, stats=None):
    """The (B, n) membership-silence plane a round body ORs into the step's
    silent set (spec §10.4), or ``None`` for every other delivery law.
    ``stats``, when a dict, gains ``committee_draws`` (one membership word
    per replica and step) and ``committee_members`` (the members this
    step), (B,) int64 each."""
    if cfg.delivery != "committee":
        return None
    member = membership_plane(cfg, seed, inst_ids, rnd, t)
    if stats is not None:
        B = inst_ids.shape[0]
        stats["committee_draws"] = stats.get("committee_draws", 0) + torch.full(
            (B,), cfg.n, dtype=torch.int64, device=member.device)
        stats["committee_members"] = stats.get("committee_members", 0) + member.sum(
            dim=-1, dtype=torch.int64)
    return ~member


def counts_fn(cfg, seed, inst_ids, rnd, t, values, silent, faulty=None,
              honest=None, stats=None, stats_lanes=None, fside=None, recv_ids=None):
    """(c0, c1) delivered-value counts per receiver lane — spec §10.2.

    ``silent`` arrives with the membership silence folded in (spec §10.4),
    so the class counts of :func:`ops.urn.lane_setup` range over the live
    committee senders; the drop total is re-derived from the quota k_C.
    ``stats``, when a dict, gains ``committee_draws`` (the drop words the
    law needs) and ``cheap_segments`` over the receivers ``stats_lanes``
    (:func:`ops.urn3.count_work`); the membership words are counted by
    :func:`step_silence`. The lanes are the receivers ``recv_ids``
    (default all n).
    """
    own_val, m, st, L, _ = urn.lane_setup(cfg, values, silent, faulty, honest,
                                          seed, inst_ids, rnd, t, fside=fside,
                                          recv_ids=recv_ids)
    D = torch.clamp(L - prf.rows(committee_quota(cfg.n_eff, cfg.f), 2), min=0).to(L.dtype)
    if stats is not None:
        urn3.count_work(stats, "committee_draws", D, st is not None, stats_lanes)
    inst = inst_ids.to(torch.int64)[:, None]
    recv = prf.receivers(cfg, recv_ids, values.device)[None, :]
    u = prf.prf_u32(seed, inst, rnd, t, recv, 1, prf.COMMITTEE, pack=cfg.pack_version)
    # The receiver's own membership: the coordinates of its silence.
    member = membership_plane(cfg, seed, inst_ids, rnd, t, recv_ids)
    d0, d1 = urn3.cheap_split(u, m, st, L, D)
    c0 = m[0] - d0 + (member & (own_val == 0)).to(torch.int32)
    c1 = m[1] - d1 + (member & (own_val == 1)).to(torch.int32)
    return c0, c1
