"""Protocol counters — the opt-in side output of the round bodies, in torch.

The port's copy of the reference ``obs/counters.py`` (schema v3): the same
counter names, column order, laws and documents. The round bodies record
each broadcast step into a pure side channel (``obs=``,
``models/delivery.py::make_counts``) that the step math never reads, and the
plain driver folds one row of increments per round under the ``done_at < 0``
activity mask (``models/driver.py::run_chunk_full``), so counters on leave
``(rounds, decision)`` bit-identical to counters off.

Accumulator representation: per-instance ``(B, C)`` int64 totals. The
reference carries (lo, hi) u32 pairs because JAX without x64 narrows int64;
torch has no u32 add on the CPU, and int64 holds every per-instance total
exactly (a round adds at most steps·n² < 2³², and the round cap is < 2¹⁶).
:func:`finalize` folds the rows to the same python-int totals.
``chain_trips_max`` merges by max, every other counter by sum.

The fused and per-step CUDA kernels compute delivery and tally in-kernel and
have no side channel: their backends raise :class:`CountersUnsupported`
rather than count a different code path.
"""

from __future__ import annotations

import torch

# v2 (spec §9): fault-attributed counters for configs with a fault schedule,
# and a partition-aware ``dropped@ph`` law. v3 (spec §10): committee configs
# gain ``committee_size@ph`` after the sampler cost counters, and their
# ``dropped@ph`` quota is the committee k_C = C − f_C − 1.
COUNTER_SCHEMA_VERSION = 3

#: Step index → phase name per protocol (spec §5.1, §5.2).
PHASE_NAMES = {
    "benor": ("report", "propose"),
    "bracha": ("initial", "echo", "ready"),
}


class CountersUnsupported(RuntimeError):
    """Raised by a backend or kernel with no counter channel (the CUDA
    kernels, the mesh, the native core). Callers that build run records
    catch it and record :func:`unsupported_doc` instead."""


def phase_names(cfg) -> tuple[str, ...]:
    return PHASE_NAMES[cfg.protocol]


# Sampler-owned cost counters (spec §4b, §4b-v2, §4c, §10):
#   urn_draws        — §4b sequential LCG draws (= the drop total, by law)
#   chain_trips      — §4b-v2 conditional-Bernoulli trips Σ_segments Σ_lanes K
#   chain_trips_max  — max per-(lane, segment) K seen
#   urn3_words       — §4c Threefry words (one per receiver-step)
#   committee_draws  — §10 Threefry words (2·n per receiver-step)
_SAMPLER_COUNTERS = {
    "urn": ("urn_draws",),
    "urn2": ("chain_trips", "chain_trips_max"),
    "urn3": ("urn3_words",),
    "committee": ("committee_draws",),
}

MAX_COUNTERS = frozenset({"chain_trips_max"})


def counter_names(cfg) -> tuple[str, ...]:
    """The counter schema of one config, in accumulator column order: per
    phase ``delivered0@ph``, ``delivered1@ph`` and ``dropped@ph``; then
    ``coin_flips``, ``rounds_active`` and the delivery law's sampler
    counters; ``committee_size@ph`` under the committee family; and
    ``fault_silenced@ph``, ``fault_cut_pairs@ph`` under a fault schedule."""
    names = []
    for ph in phase_names(cfg):
        names += [f"delivered0@{ph}", f"delivered1@{ph}", f"dropped@{ph}"]
    names += ["coin_flips", "rounds_active"]
    names += _SAMPLER_COUNTERS.get(cfg.delivery, ())
    if cfg.delivery == "committee":
        names += [f"committee_size@{ph}" for ph in phase_names(cfg)]
    if cfg.faults != "none":
        for ph in phase_names(cfg):
            names += [f"fault_silenced@{ph}", f"fault_cut_pairs@{ph}"]
    return tuple(names)


def max_mask(cfg, device=None) -> torch.Tensor:
    """(C,) bool — True where the counter merges by max, not sum."""
    return torch.tensor([n in MAX_COUNTERS for n in counter_names(cfg)],
                        dtype=torch.bool, device=device)


def zeros(cfg, batch: int, device=None) -> torch.Tensor:
    """(B, C) int64 accumulator."""
    return torch.zeros((batch, len(counter_names(cfg))), dtype=torch.int64,
                       device=device)


def step_stats(cfg, seed, inst_ids: torch.Tensor, rnd, t, n_recv: int,
               law_stats: dict) -> dict:
    """One step's sampler counters under the reference's laws, (B,) int64
    each, from the work counters the law recorded over all its receivers
    (``law_stats``). The §4c and §10 word counts are fixed by the law:
    one word per receiver, and two per receiver under the committee family,
    with the realized committee size beside them."""
    B, dev = inst_ids.shape[0], inst_ids.device
    if cfg.delivery == "urn":
        return {"urn_draws": law_stats["urn_draws"]}
    if cfg.delivery == "urn2":
        return {k: law_stats[k] for k in ("chain_trips", "chain_trips_max")}
    if cfg.delivery == "urn3":
        return {"urn3_words": torch.full((B,), n_recv, dtype=torch.int64, device=dev)}
    if cfg.delivery == "committee":
        from byzantinerandomizedconsensus_tpu_torch.ops import committee

        member = committee.membership_plane(cfg, seed, inst_ids, rnd, t)
        return {"committee_draws": torch.full((B,), 2 * n_recv, dtype=torch.int64,
                                              device=dev),
                "committee_members": member.sum(dim=-1, dtype=torch.int64)}
    return {}


def round_increments(cfg, obs: dict) -> torch.Tensor:
    """(B, C) int64 — one round's per-instance counter increments, from the
    per-step entries ``obs[t] = {"c0", "c1", "silent", "stats", "fsil",
    "fside"}`` the round body recorded."""
    steps = cfg.steps_per_round
    if sorted(obs) != list(range(steps)):
        raise ValueError(f"obs is missing step entries: have {sorted(obs)}")
    i64 = torch.int64
    batch, dev = obs[0]["c0"].shape[0], obs[0]["c0"].device
    if cfg.delivery == "committee":
        from byzantinerandomizedconsensus_tpu_torch.ops import committee

        k = committee.committee_quota(cfg.n_eff, cfg.f)
    else:
        k = cfg.n_eff - cfg.f - 1

    def live_by_side(live, side):
        """(B,) live senders on side 0 and on side 1."""
        return [(live & (side == p)).sum(dim=-1, dtype=i64) for p in (0, 1)]

    cols = []
    for t in range(steps):
        e = obs[t]
        cols.append(e["c0"].sum(dim=-1, dtype=i64))
        cols.append(e["c1"].sum(dim=-1, dtype=i64))
        # Every delivery law drops max(0, L_v − k) live messages per
        # receiver (spec §4); under a §9 partition L_v counts only the
        # receiver's own side.
        live = ~e["silent"]
        fside = e.get("fside")
        if fside is None:
            tot = live.sum(dim=-1, dtype=i64)[:, None]
        else:
            p0, p1 = live_by_side(live, fside)
            tot = torch.where(fside == 1, p1[:, None], p0[:, None])
        L = tot - live.to(i64)
        cols.append(torch.clamp(L - k, min=0).sum(dim=-1))
    cols.append(torch.full((batch,), cfg.n_eff if cfg.coin == "local" else 1,
                           dtype=i64, device=dev))
    cols.append(torch.ones((batch,), dtype=i64, device=dev))
    for name in _SAMPLER_COUNTERS.get(cfg.delivery, ()):
        per_step = [obs[t]["stats"][name].to(i64) for t in range(steps)]
        acc = per_step[0]
        for v in per_step[1:]:
            acc = torch.maximum(acc, v) if name in MAX_COUNTERS else acc + v
        cols.append(acc)
    if cfg.delivery == "committee":
        cols += [obs[t]["stats"]["committee_members"].to(i64) for t in range(steps)]
    if cfg.faults != "none":
        zero = torch.zeros((batch,), dtype=i64, device=dev)
        for t in range(steps):
            e = obs[t]
            fsil, fside = e.get("fsil"), e.get("fside")
            cols.append(zero if fsil is None else fsil.sum(dim=-1, dtype=i64))
            if fside is None:
                cols.append(zero)
                continue
            p0, p1 = live_by_side(~e["silent"], fside)
            # A receiver on side s misses every live sender on side 1 − s.
            cross = torch.where(fside == 1, p0[:, None], p1[:, None])
            cols.append(cross.sum(dim=-1))
    return torch.stack(cols, dim=1)


def accumulate(acc: torch.Tensor, inc: torch.Tensor, active: torch.Tensor,
               cfg) -> torch.Tensor:
    """Fold one round's increments into the (B, C) accumulator. ``active``
    is the (B,) bool undecided-at-round-entry mask, the eligibility the
    oracle realizes by stopping its per-instance round loop. Sum counters
    add, max counters max-merge."""
    inc = torch.where(active[:, None], inc, torch.zeros_like(inc))
    return torch.where(max_mask(cfg, acc.device)[None, :],
                       torch.maximum(acc, inc), acc + inc)


def finalize(cfg, rows) -> dict:
    """Fold per-instance (I, C) int64 rows (padding dropped) into exact
    python-int totals keyed by counter name."""
    rows = torch.as_tensor(rows, dtype=torch.int64).cpu()
    totals = {}
    for c, name in enumerate(counter_names(cfg)):
        col = rows[:, c]
        if name in MAX_COUNTERS:
            totals[name] = int(col.max()) if len(col) else 0
        else:
            totals[name] = int(col.sum())
    return totals


def counters_doc(cfg, totals: dict, backend: str = "?") -> dict:
    """The counters block a run record carries."""
    return {
        "schema": COUNTER_SCHEMA_VERSION,
        "supported": True,
        "backend": backend,
        "protocol": cfg.protocol,
        "delivery": cfg.delivery,
        "phases": list(phase_names(cfg)),
        "totals": dict(totals),
    }


def unsupported_doc(reason) -> dict:
    """The block of a run whose backend or kernel has no counter channel."""
    return {"schema": COUNTER_SCHEMA_VERSION, "supported": False,
            "reason": str(reason)}
