"""Cross-model per-instance divergence map (spec §4b/§4b-v2/§4c), the §9
fault-schedule liveness rows and the §10 committee-vs-full-mesh rows.

The port's copy of the reference ``tools/divergence.py``: the same grids,
the same row fields and the same arithmetic, so a row computed here equals
the reference's row on the same configs (``artifacts/divergence_r*.json``).
Rows run on the port's backends, named or given as objects: the tool's
default is ``native`` (the C++ core) for the delivery-law pairs and the
preset rows, and ``torch`` for the fault and committee rows, whose laws
the C++ core has no channel for; on the card ``torch`` runs the kernels
(the fused round kernel under urn, urn2, urn3, committee and every §9
schedule; the per-step kernel under keys), on the CPU the plain driver.

The three §4b-family samplers (keys, urn, urn2) are exact samplers of one
delivery-distribution family: per-instance outcomes diverge wherever
scheduling freedom can cross a quorum margin (the *divergent* regime: the
non-adaptive adversaries at small n, and Ben-Or under adaptive), and are
identical in the *robust* regime (the config-5 family, Bracha under
adaptive, and adaptive_min under both protocols), where binary-alphabet
steps have value-homogeneous bias strata. §4c (urn3) is a different law,
so its gaps are real and bounded. The fault rows report each schedule's
rounds-histogram TV distance to the fault-free baseline; the committee
rows report the TV distance to the §4b-v2 full mesh and the measured f_C
tail against its Chernoff bound.

CLI: ``python -m byzantinerandomizedconsensus_tpu_torch.tools.divergence``
(``--full`` adds the large-n config-5-family rows, ``--presets`` the
five-preset §4c rows, ``--faults`` the §9 rows, ``--committee`` the §10
rows; ``--device cpu`` runs ``torch`` on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import sys

from byzantinerandomizedconsensus_tpu_torch.backends.base import get_backend
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig

# (cfg, regime) rows. Regimes are the measured classification above; a row's
# placement is an expectation the artifact records, not an input to it.
_BASE = dict(round_cap=64)
GRID: tuple[tuple[SimConfig, str], ...] = (
    (SimConfig(protocol="benor", n=4, f=1, adversary="none", coin="local",
               seed=0, **_BASE), "divergent"),
    (SimConfig(protocol="benor", n=4, f=1, adversary="none", coin="shared",
               seed=0, **_BASE), "divergent"),
    (SimConfig(protocol="benor", n=16, f=7, adversary="none", coin="local",
               seed=2, **_BASE), "divergent"),
    (SimConfig(protocol="benor", n=64, f=21, adversary="crash", coin="local",
               seed=3, round_cap=96), "divergent"),
    (SimConfig(protocol="bracha", n=10, f=3, adversary="byzantine", coin="local",
               seed=4, **_BASE), "divergent"),
    (SimConfig(protocol="bracha", n=10, f=3, adversary="byzantine", coin="shared",
               seed=4, **_BASE), "divergent"),
    (SimConfig(protocol="benor", n=11, f=2, adversary="adaptive", coin="local",
               seed=3, **_BASE), "divergent"),
    (SimConfig(protocol="bracha", n=16, f=5, adversary="adaptive", coin="local",
               seed=5, **_BASE), "robust"),
    (SimConfig(protocol="bracha", n=16, f=5, adversary="adaptive", coin="shared",
               seed=11, **_BASE), "robust"),
    # adaptive_min (spec §6.4b) is delivery-robust by the same two mechanisms
    # as the class rule — its bias is a function of the wire value alone, so
    # binary-alphabet steps have value-homogeneous strata, and the ⊥-bearing
    # step's ⊥/majority drop split stays inside dead margins (measured; note
    # even benor+adaptive_min is robust where benor+adaptive diverges — the
    # receiver-independent bias removes the class/value misalignment that
    # made the n=11 class-rule row divergent).
    (SimConfig(protocol="bracha", n=16, f=5, adversary="adaptive_min",
               coin="local", seed=5, **_BASE), "robust"),
    (SimConfig(protocol="bracha", n=16, f=5, adversary="adaptive_min",
               coin="shared", seed=11, **_BASE), "robust"),
    (SimConfig(protocol="benor", n=11, f=2, adversary="adaptive_min",
               coin="local", seed=3, **_BASE), "robust"),
)

# Large-n config-5-family rows (--full): the round-3 "identical at every sweep
# point" finding, re-established by the committed artifact. Keys delivery at
# these n is the O(n²) path — run on an accelerated backend.
FULL_GRID: tuple[tuple[SimConfig, str], ...] = (
    (SimConfig(protocol="bracha", n=97, f=32, adversary="adaptive", coin="local",
               seed=0, round_cap=128), "robust"),
    (SimConfig(protocol="bracha", n=98, f=32, adversary="adaptive", coin="local",
               seed=0, round_cap=128), "robust"),
    (SimConfig(protocol="bracha", n=512, f=170, adversary="adaptive",
               coin="shared", seed=0, round_cap=128), "robust"),
)


# Pairwise sampler comparisons. The bare suffix is the original keys↔urn map
# (field names unchanged since r4); each later pair gets an explicit suffix.
# The urn3 pairs (round 6) compare ACROSS distribution families — spec §4c is
# a different law, so their distribution-level gaps are expected to be real
# (bounded, measured), not sampler noise; the robust-regime rows must still
# be identical (the homogeneous-strata mechanism is law-independent).
PAIRS = (("keys", "urn", ""), ("keys", "urn2", "_keys_urn2"),
         ("urn", "urn2", "_urn_urn2"), ("keys", "urn3", "_keys_urn3"),
         ("urn2", "urn3", "_urn2_urn3"))

DELIVERIES = ("keys", "urn", "urn2", "urn3")


def rounds_hist_tv(ra, rb) -> float:
    """Total-variation distance between two rounds-to-decision histograms
    (0 = identical distribution, 1 = disjoint). The distribution-level
    deviation measure the §4c ship-or-bury decision keys on, next to the
    per-instance disagreement fraction."""
    import numpy as np

    hi = int(max(ra.max(initial=0), rb.max(initial=0))) + 1
    pa = np.bincount(ra, minlength=hi) / max(1, len(ra))
    pb = np.bincount(rb, minlength=hi) / max(1, len(rb))
    return float(0.5 * np.abs(pa - pb).sum())


def resolve_backend(backend, device: str = "cuda"):
    """A backend object from a registry name (``torch`` and
    ``torch_sharded`` on ``device``; ``native``, ``cpu`` and ``virtual``
    take no device) or the object itself."""
    if not isinstance(backend, str):
        return backend
    if backend.partition(":")[0] in ("torch", "torch_sharded"):
        return get_backend(backend, device=device)
    return get_backend(backend)


def backend_label(backend) -> str:
    """The name a row records for ``backend`` (a name or an object)."""
    return backend if isinstance(backend, str) else getattr(backend, "name", "?")


def _run(cfg: SimConfig, backend):
    return resolve_backend(backend).timed_run(cfg.validate())


def _delivery_results(cfg: SimConfig, backend, results=None) -> dict:
    """{delivery: SimResult} for one row — from a precomputed batched slice
    (``results``: the 4 per-delivery results in DELIVERIES order) or by
    running per-config."""
    if results is not None:
        return dict(zip(DELIVERIES, results))
    be = resolve_backend(backend)
    return {d: _run(dataclasses.replace(cfg, delivery=d), be) for d in DELIVERIES}


def compare_row(cfg: SimConfig, instances: int, backend,
                results=None) -> dict:
    """Run ``cfg`` at all three deliveries; return the pairwise per-instance
    comparison. ``frac_rounds_differ``/``frac_decision_differ`` stay the
    keys↔urn pair (the original map's fields); the §4b-v2 sampler adds the
    keys↔urn2 and urn↔urn2 pairs (round 5 — the "divergence regimes apply
    verbatim" claim of spec §4b-v2, measured). ``results`` injects the
    batched-lane results (round 10) — same configs, same order, same bits."""
    cfg = dataclasses.replace(cfg, instances=instances).validate()
    res = _delivery_results(cfg, backend, results=results)

    row = {
        "protocol": cfg.protocol, "n": cfg.n, "f": cfg.f,
        "adversary": cfg.adversary, "coin": cfg.coin, "seed": cfg.seed,
        "round_cap": cfg.round_cap, "instances": instances,
    }
    for a, b, suffix in PAIRS:
        ra, rb = res[a], res[b]
        row[f"frac_rounds_differ{suffix}"] = float(
            (ra.rounds != rb.rounds).mean())
        row[f"frac_decision_differ{suffix}"] = float(
            (ra.decision != rb.decision).mean())
        row[f"rounds_hist_tv{suffix}"] = rounds_hist_tv(ra.rounds, rb.rounds)
    for name, r in res.items():
        row[f"mean_rounds_{name}"] = float(r.rounds.mean())
        row[f"p1_{name}"] = float((r.decision == 1).mean())
        row[f"capped_{name}"] = float((r.decision == 2).mean())
    return row


def preset_row(name: str, cfg: SimConfig, instances: int, backend) -> dict:
    """§4c-vs-§4b-v2 deviation at one benchmark preset shape (the ship-or-bury
    evidence row): per-instance disagreement + rounds-histogram TV distance,
    urn2 vs urn3 only (keys at benchmark n is the O(n²) path and the §4b pair
    is already mapped by the grid rows)."""
    cfg = dataclasses.replace(cfg, instances=instances).validate()
    be = resolve_backend(backend)
    res = {d: _run(dataclasses.replace(cfg, delivery=d), be) for d in ("urn2", "urn3")}
    ra, rb = res["urn2"], res["urn3"]
    return {
        "preset": name, "protocol": cfg.protocol, "n": cfg.n, "f": cfg.f,
        "adversary": cfg.adversary, "coin": cfg.coin, "seed": cfg.seed,
        "round_cap": cfg.round_cap, "instances": instances,
        "backend": backend_label(backend),
        "frac_rounds_differ_urn2_urn3": float((ra.rounds != rb.rounds).mean()),
        "frac_decision_differ_urn2_urn3": float(
            (ra.decision != rb.decision).mean()),
        "rounds_hist_tv_urn2_urn3": rounds_hist_tv(ra.rounds, rb.rounds),
        "mean_rounds_urn2": float(ra.rounds.mean()),
        "mean_rounds_urn3": float(rb.rounds.mean()),
        "p1_urn2": float((ra.decision == 1).mean()),
        "p1_urn3": float((rb.decision == 1).mean()),
        "capped_urn2": float((ra.decision == 2).mean()),
        "capped_urn3": float((rb.decision == 2).mean()),
    }


def run_preset_rows(instances: int = 2000, backend="native",
                    progress=print) -> list:
    """The five benchmark presets (config5 = its SWEEP_POINT_N stand-in),
    §4c vs §4b-v2. Config 1 ships instances=1; all rows use the same sampled
    ``instances`` id range (instance i depends only on (cfg, seed, i))."""
    from byzantinerandomizedconsensus_tpu_torch.config import (
        PRESETS, SWEEP_POINT_N, sweep_point)

    rows = []
    shapes = {**PRESETS, "config5": sweep_point(SWEEP_POINT_N)}
    for name, cfg in shapes.items():
        rows.append(preset_row(name, cfg, instances, backend))
        progress(json.dumps(rows[-1]))
    return rows


# Fault-schedule liveness map (spec §9): each row runs one config at
# faults="none" (the baseline) and at every fault kind, and reports the
# rounds-histogram TV distance vs the baseline — the §9 schedules must
# degrade *liveness only* (safety is the invariant checker's job,
# models/invariants.py + the chaos soak), and this leg quantifies by how
# much. Product delivery, small n.
FAULT_GRID: tuple[SimConfig, ...] = (
    SimConfig(protocol="benor", n=9, f=3, adversary="crash", coin="local",
              seed=1, round_cap=96, delivery="urn2"),
    SimConfig(protocol="benor", n=9, f=4, adversary="none", coin="local",
              seed=2, round_cap=96, delivery="urn2"),
    SimConfig(protocol="bracha", n=16, f=5, adversary="byzantine",
              coin="shared", seed=3, round_cap=96, delivery="urn2"),
    SimConfig(protocol="bracha", n=16, f=5, adversary="adaptive",
              coin="shared", seed=4, round_cap=96, delivery="urn2"),
)

FAULT_KINDS_MEASURED = ("recover", "partition", "omission")


def fault_row(cfg: SimConfig, instances: int, backend,
              results=None) -> dict:
    """One §9 liveness row: the fault-free baseline vs every fault kind on
    the same config — per-kind rounds-histogram TV, mean rounds, capped and
    decided-1 fractions. ``results`` injects the batched-lane results
    (baseline then FAULT_KINDS_MEASURED order)."""
    cfg = dataclasses.replace(cfg, instances=instances).validate()
    if results is None:
        be = resolve_backend(backend)
        results = [_run(cfg, be)] + [
            _run(dataclasses.replace(cfg, faults=kind), be)
            for kind in FAULT_KINDS_MEASURED]
    base = results[0]
    row = {
        "protocol": cfg.protocol, "n": cfg.n, "f": cfg.f,
        "adversary": cfg.adversary, "coin": cfg.coin, "seed": cfg.seed,
        "round_cap": cfg.round_cap, "delivery": cfg.delivery,
        "instances": instances, "backend": backend_label(backend),
        "mean_rounds_none": float(base.rounds.mean()),
        "capped_none": float((base.decision == 2).mean()),
        "p1_none": float((base.decision == 1).mean()),
    }
    for kind, r in zip(FAULT_KINDS_MEASURED, results[1:]):
        row[f"rounds_hist_tv_{kind}"] = rounds_hist_tv(base.rounds, r.rounds)
        row[f"mean_rounds_{kind}"] = float(r.rounds.mean())
        row[f"capped_{kind}"] = float((r.decision == 2).mean())
        row[f"p1_{kind}"] = float((r.decision == 1).mean())
    return row


def run_fault_rows(instances: int = 400, backend="torch",
                   batched: bool = False, progress=print, device: str = "cuda") -> list:
    """The :data:`FAULT_GRID` rows through ``backend`` (``torch`` on
    ``device``: the fused round kernel on the card); ``batched`` runs the
    grid as lanes of the lane runner (``kernel="plain"`` only)."""
    backend = resolve_backend(backend, device)
    rows = []
    per_row = 1 + len(FAULT_KINDS_MEASURED)
    if batched:
        from byzantinerandomizedconsensus_tpu_torch.backends import batch as _batch

        cfgs = [
            dataclasses.replace(cfg, instances=instances,
                                faults=kind).validate()
            for cfg in FAULT_GRID
            for kind in ("none",) + FAULT_KINDS_MEASURED]
        flat, _ = _batch.run_grid(backend, cfgs)
        for i, cfg in enumerate(FAULT_GRID):
            rows.append(fault_row(cfg, instances, backend,
                                  results=flat[i * per_row:(i + 1) * per_row]))
            progress(json.dumps(rows[-1]))
        return rows
    for cfg in FAULT_GRID:
        rows.append(fault_row(cfg, instances, backend))
        progress(json.dumps(rows[-1]))
    return rows


def fault_rows_summary(rows: list) -> dict:
    return {
        f"fault_max_rounds_hist_tv_{kind}": max(
            r[f"rounds_hist_tv_{kind}"] for r in rows)
        for kind in FAULT_KINDS_MEASURED
    } | {
        f"fault_max_capped_{kind}": max(r[f"capped_{kind}"] for r in rows)
        for kind in FAULT_KINDS_MEASURED
    }


# Committee-vs-full-mesh leg (spec §10, round 23). Shapes where C(n) < n so
# sortition is non-degenerate; the first two carry f_C ≥ f (the sampling
# margin swallows the whole faulty set — tail exactly 0), the larger-f rows
# have a genuinely non-trivial tail for the Chernoff comparison.
COMMITTEE_GRID: tuple[SimConfig, ...] = (
    SimConfig(protocol="bracha", n=64, f=12, adversary="adaptive",
              coin="shared", seed=7, round_cap=96, delivery="committee"),
    SimConfig(protocol="benor", n=64, f=6, adversary="crash", coin="local",
              seed=9, round_cap=96, delivery="committee"),
    SimConfig(protocol="bracha", n=128, f=25, adversary="adaptive",
              coin="local", seed=8, round_cap=96, delivery="committee"),
    SimConfig(protocol="bracha", n=256, f=48, adversary="adaptive",
              coin="shared", seed=10, round_cap=96, delivery="committee"),
)

#: full-mesh reference law for the committee TV rows: §4b-v2, the count-level
#: sampler the committee family replaces (keys at these n is the O(n²) path)
COMMITTEE_MESH_REFERENCE = "urn2"


def fc_tail_row(cfg: SimConfig, rounds_sampled: int = 16, device: str = "cpu") -> dict:
    """Measured §10.3 sortition-margin tail vs its Chernoff bound.

    Every committee of ``rounds_sampled`` rounds × all phases × all
    instances is materialized through the real §10.1 sortition
    (``membership_plane``) and intersected with the real §3.2 faulty sets
    (``faulty_mask``); the tail is the fraction whose faulty-member count
    exceeds f_C. The bound is the classical multiplicative Chernoff tail
    for Binomial(f, C/n) at a = f_C + 1 — membership of each faulty
    replica is an independent Bernoulli(C/n) draw (distinct PRF purposes),
    so it bounds the true tail; the measurement must sit under it."""
    import torch

    from byzantinerandomizedconsensus_tpu_torch.models.adversaries import faulty_mask
    from byzantinerandomizedconsensus_tpu_torch.ops import committee as _committee

    c = _committee.committee_size(cfg.n)
    fc = _committee.committee_fault_budget(cfg.n, cfg.f)
    inst = torch.arange(cfg.instances, dtype=torch.int32, device=device)
    faulty = faulty_mask(cfg, cfg.seed, inst)  # (B, n) bool
    phases = 3 if cfg.protocol == "bracha" else 2
    sampled = exceed = 0
    member_sum = 0
    for rnd in range(rounds_sampled):
        for t in range(phases):
            member = _committee.membership_plane(
                cfg, cfg.seed, inst, rnd, t)  # (B, n) bool
            bad = (member & faulty).sum(axis=1)
            exceed += int((bad > fc).sum())
            sampled += int(bad.shape[0])
            member_sum += int(member.sum())
    mu = c * cfg.f / cfg.n
    a = fc + 1
    chernoff = 1.0 if a <= mu else math.exp(a - mu - a * math.log(a / mu))
    measured = exceed / max(1, sampled)
    return {
        "committee_c": int(c), "committee_f_budget": int(fc),
        "committees_sampled": sampled, "fc_exceed_count": exceed,
        "fc_tail_measured": measured,
        "fc_tail_chernoff": chernoff,
        "fc_bound_holds": bool(measured <= chernoff),
        "fc_tail_trivial": bool(fc >= cfg.f),
        "mean_committee_size_measured": member_sum / max(1, sampled),
        "rounds_sampled": rounds_sampled, "phases": phases,
    }


def committee_row(cfg: SimConfig, instances: int, backend) -> dict:
    """One §10 row: the shape under the committee law vs the same shape
    under the full-mesh reference (rounds-histogram TV + outcome stats),
    plus the measured-vs-Chernoff f_C tail. Per-instance disagreement is
    reported but *expected* — the committee family is a different protocol
    over sampled quorums, so only distribution-level agreement is a claim."""
    cfg = dataclasses.replace(cfg, instances=instances).validate()
    mesh = dataclasses.replace(
        cfg, delivery=COMMITTEE_MESH_REFERENCE).validate()
    be = resolve_backend(backend)
    rc = _run(cfg, be)
    rm = _run(mesh, be)
    row = {
        "protocol": cfg.protocol, "n": cfg.n, "f": cfg.f,
        "adversary": cfg.adversary, "coin": cfg.coin, "seed": cfg.seed,
        "round_cap": cfg.round_cap, "instances": instances,
        "backend": backend_label(backend), "mesh_reference": COMMITTEE_MESH_REFERENCE,
        "rounds_hist_tv_mesh_committee": rounds_hist_tv(rm.rounds, rc.rounds),
        "frac_rounds_differ_mesh_committee": float(
            (rm.rounds != rc.rounds).mean()),
        "mean_rounds_committee": float(rc.rounds.mean()),
        "mean_rounds_mesh": float(rm.rounds.mean()),
        "p1_committee": float((rc.decision == 1).mean()),
        "p1_mesh": float((rm.decision == 1).mean()),
        "capped_committee": float((rc.decision == 2).mean()),
        "capped_mesh": float((rm.decision == 2).mean()),
    }
    row.update(fc_tail_row(cfg, device=getattr(be, "device", None) or "cpu"))
    return row


def run_committee_rows(instances: int = 400, backend="torch",
                       progress=print, device: str = "cuda") -> list:
    backend = resolve_backend(backend, device)
    rows = []
    for cfg in COMMITTEE_GRID:
        rows.append(committee_row(cfg, instances, backend))
        progress(json.dumps(rows[-1]))
    return rows


def committee_rows_summary(rows: list) -> dict:
    nontrivial = [r for r in rows if not r["fc_tail_trivial"]]
    return {
        "committee_rows": len(rows),
        "committee_max_rounds_hist_tv": max(
            r["rounds_hist_tv_mesh_committee"] for r in rows),
        "committee_max_capped": max(r["capped_committee"] for r in rows),
        "committee_fc_bound_holds_all": all(r["fc_bound_holds"] for r in rows),
        "committee_max_fc_tail_measured": max(
            r["fc_tail_measured"] for r in rows),
        "committee_nontrivial_tail_rows": len(nontrivial),
    }


def run_divergence(instances: int = 400, backend="native",
                   full: bool = False, full_backend="torch",
                   full_instances: int = 2000, presets: bool = False,
                   preset_instances: int = 2000, preset_backend="native",
                   faults: bool = False, fault_instances: int = 400,
                   fault_backend="torch",
                   committee: bool = False, committee_instances: int = 400,
                   committee_backend="torch",
                   batched: bool = False, device: str = "cuda",
                   progress=print) -> dict:
    """The grid rows through ``backend``, plus the legs asked for, each
    through its own backend (a name, ``torch`` names on ``device``, or an
    object). ``batched`` runs the grid (and the fault rows) as lanes of the
    lane runner, which takes ``torch`` on ``kernel="plain"``."""
    rows = []
    batch_report = None
    grid_be = resolve_backend(backend, device)
    label = backend_label(backend)
    if batched:
        # The whole grid × all four delivery laws through the lane runner,
        # one lane program per bucket; compare_row takes the results
        # positionally, so the rows are the per-config rows.
        from byzantinerandomizedconsensus_tpu_torch.backends import batch as _batch

        grid_cfgs = [
            dataclasses.replace(cfg, instances=instances,
                                delivery=d).validate()
            for cfg, _ in GRID for d in DELIVERIES]
        flat, batch_report = _batch.run_grid(grid_be, grid_cfgs)
        for i, (cfg, regime) in enumerate(GRID):
            row = compare_row(cfg, instances, grid_be,
                              results=flat[i * len(DELIVERIES):
                                           (i + 1) * len(DELIVERIES)])
            # batch_report is None when run_grid ran the per-config loop
            # (a backend without lanes): no batched provenance is claimed.
            row.update(regime=regime, backend=label,
                       batched=batch_report is not None)
            progress(json.dumps(row))
            rows.append(row)
    else:
        for cfg, regime in GRID:
            row = compare_row(cfg, instances, grid_be)
            row.update(regime=regime, backend=label)
            progress(json.dumps(row))
            rows.append(row)
    if full:
        full_be = resolve_backend(full_backend, device)
        for cfg, regime in FULL_GRID:
            row = compare_row(cfg, full_instances, full_be)
            row.update(regime=regime, backend=backend_label(full_backend))
            progress(json.dumps(row))
            rows.append(row)
    div = [r for r in rows if r["regime"] == "divergent"]
    rob = [r for r in rows if r["regime"] == "robust"]
    summary = {"divergent_rows": len(div), "robust_rows": len(rob)}
    # Bare-suffixed fields keep their keys↔urn meaning (PAIRS); each later
    # pair has its own suffix.
    for a, b, suffix in PAIRS:
        summary[f"min_frac_rounds_differ_divergent{suffix}"] = \
            min(r[f"frac_rounds_differ{suffix}"] for r in div)
        summary[f"max_frac_rounds_differ_robust{suffix}"] = \
            max(r[f"frac_rounds_differ{suffix}"] for r in rob)
        summary[f"max_abs_mean_rounds_gap_{a}_{b}"] = max(
            abs(r[f"mean_rounds_{a}"] - r[f"mean_rounds_{b}"]) for r in rows)
        summary[f"max_rounds_hist_tv_{a}_{b}"] = max(
            r[f"rounds_hist_tv{suffix}"] for r in rows)
    summary["max_abs_mean_rounds_gap"] = \
        summary["max_abs_mean_rounds_gap_keys_urn"]
    out = {"rows": rows, "summary": summary}
    if batch_report is not None:
        out["batch"] = batch_report
    if presets:
        prows = run_preset_rows(instances=preset_instances,
                                backend=resolve_backend(preset_backend, device),
                                progress=progress)
        out["preset_rows"] = prows
        summary["preset_max_rounds_hist_tv_urn2_urn3"] = max(
            r["rounds_hist_tv_urn2_urn3"] for r in prows)
        summary["preset_max_abs_mean_rounds_gap_urn2_urn3"] = max(
            abs(r["mean_rounds_urn2"] - r["mean_rounds_urn3"]) for r in prows)
    if faults:
        frows = run_fault_rows(instances=fault_instances,
                               backend=grid_be if batched else fault_backend,
                               batched=batched, progress=progress, device=device)
        out["fault_rows"] = frows
        summary.update(fault_rows_summary(frows))
    if committee:
        crows = run_committee_rows(instances=committee_instances,
                                   backend=committee_backend, progress=progress,
                                   device=device)
        out["committee_rows"] = crows
        summary.update(committee_rows_summary(crows))
    return out


def main(argv=None) -> int:
    from byzantinerandomizedconsensus_tpu_torch.utils.rounds import default_artifact

    ap = argparse.ArgumentParser(
        description="cross-model (keys/urn/urn2/urn3) divergence map")
    ap.add_argument("--out", default=default_artifact("divergence"))
    ap.add_argument("--instances", type=int, default=400)
    ap.add_argument("--backend", default="native",
                    help="the grid's backend: native (default, the C++ core), "
                         "cpu (the object oracle) or torch (on --device)")
    ap.add_argument("--device", default="cuda",
                    help="the device of every torch backend: cuda (default; "
                         "exits nonzero with no card) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="add large-n config-5-family rows (torch on the card)")
    ap.add_argument("--full-backend", default="torch")
    ap.add_argument("--full-instances", type=int, default=2000)
    ap.add_argument("--presets", action="store_true",
                    help="add the five-preset §4c-vs-§4b-v2 deviation rows "
                         "(per-instance disagreement + rounds-histogram TV)")
    ap.add_argument("--preset-instances", type=int, default=2000)
    ap.add_argument("--preset-backend", default="native")
    ap.add_argument("--faults", action="store_true",
                    help="add the spec-§9 fault-schedule liveness rows "
                         "(rounds-histogram TV vs the fault-free baseline)")
    ap.add_argument("--fault-instances", type=int, default=400)
    ap.add_argument("--fault-backend", default="torch")
    ap.add_argument("--committee", action="store_true",
                    help="add the spec-§10 committee-vs-full-mesh rows "
                         "(rounds-histogram TV vs the §4b-v2 reference + "
                         "measured f_C tail vs its Chernoff bound)")
    ap.add_argument("--committee-instances", type=int, default=400)
    ap.add_argument("--committee-backend", default="torch")
    ap.add_argument("--batched", action="store_true",
                    help="run the grid and the fault rows as lanes of the lane "
                         "runner (backends/batch.py; --backend torch, which it "
                         "runs on kernel='plain') — bit-identical rows, the "
                         "artifact carries the compile-cache stats")
    args = ap.parse_args(argv)

    backend = args.backend
    if args.batched:
        if backend.partition(":")[0] != "torch":
            print(f"divergence: --batched runs the lane runner, which takes "
                  f"--backend torch (got {backend!r})", file=sys.stderr)
            return 2
        backend = get_backend("torch", device=args.device, kernel="plain")
    try:
        result = run_divergence(instances=args.instances, backend=backend,
                                full=args.full, full_backend=args.full_backend,
                                full_instances=args.full_instances,
                                presets=args.presets,
                                preset_instances=args.preset_instances,
                                preset_backend=args.preset_backend,
                                faults=args.faults,
                                fault_instances=args.fault_instances,
                                fault_backend=args.fault_backend,
                                committee=args.committee,
                                committee_instances=args.committee_instances,
                                committee_backend=args.committee_backend,
                                batched=args.batched, device=args.device)
    except RuntimeError as e:
        # no card with cuda asked for: named, nothing carries on on the CPU
        print(f"divergence: {e}", file=sys.stderr)
        return 2
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1, sort_keys=True) + "\n")
    print(json.dumps({"out": str(out), **result["summary"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
