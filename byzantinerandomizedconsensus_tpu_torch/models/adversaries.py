"""Adversaries-as-data (spec/PROTOCOL.md §6), in torch.

The port's counterpart of the reference ``models/adversaries.py`` for the
benign adversary and the adaptive family: ``none`` (no faulty replica),
``adaptive`` (§6.4) and ``adaptive_min`` (§6.4b). An adversary is a static
per-instance setup (the faulty set) and a per-step injection mapping honest
outgoing values to ``(values, silent, bias)``:

- ``values``: (B, n) common per-sender wire values;
- ``silent``: (B, n) bool sender silences;
- ``bias``:   (B, 1, n) or (B, R, n) scheduling-bias bits (spec §4 bit 30).

``crash`` and ``byzantine`` raise by name.
"""

from __future__ import annotations

import torch

from byzantinerandomizedconsensus_tpu_torch.models.faults import fault_prone_mask

PORTED = ("none", "adaptive", "adaptive_min")


def faulty_mask(cfg, seed, inst_ids: torch.Tensor) -> torch.Tensor:
    """(B, n) bool — the §3.2 faulty set; empty under the benign adversary."""
    if cfg.adversary == "none":
        return torch.zeros((inst_ids.shape[0], cfg.n), dtype=torch.bool,
                           device=inst_ids.device)
    return fault_prone_mask(cfg, seed, inst_ids)


def observed_minority(honest_values: torch.Tensor, faulty: torch.Tensor) -> torch.Tensor:
    """(B,) uint8 — the spec §6.4 observation: the minority value among the
    honest non-⊥ votes of this step (ties → 1)."""
    honest = ~faulty
    h1 = (honest & (honest_values == 1)).sum(-1, dtype=torch.int32)
    h0 = (honest & (honest_values == 0)).sum(-1, dtype=torch.int32)
    return (h1 <= h0).to(torch.uint8)


def scheduling_bias(cfg, values: torch.Tensor, faulty: torch.Tensor) -> torch.Tensor:
    """The keys law's scheduling-bias bits (spec §4 bit 30) for one step's
    wire ``values``: all zero (B, 1, n) under ``none``; by receiver class
    under ``adaptive`` ((B, n, n): receiver v prefers 0 iff v < (n+1)/2);
    minority first under ``adaptive_min`` ((B, 1, n)), the minority of the
    non-faulty wire values, which are the honest ones. ⊥ is always biased."""
    B, n = values.shape
    if cfg.adversary == "none":
        return torch.zeros((B, 1, n), dtype=torch.bool, device=values.device)
    vv = values[:, None, :]
    if cfg.adversary == "adaptive_min":
        return (vv == 2) | (vv != observed_minority(values, faulty)[:, None, None])
    pref = (torch.arange(n, device=values.device) >= (cfg.n_eff + 1) // 2)[None, :, None]
    return (vv == 2) | (vv != pref)


class AdversaryModel:
    """Static dispatch on ``cfg.adversary``; holds only the config."""

    def __init__(self, cfg):
        if cfg.adversary not in PORTED:
            raise NotImplementedError(
                f"adversary={cfg.adversary!r} is not ported yet; the port "
                f"runs adversary in {PORTED}")
        self.cfg = cfg

    def setup(self, seed, inst_ids: torch.Tensor) -> dict:
        fm = faulty_mask(self.cfg, seed, inst_ids)
        return {"faulty": fm,
                "crash_round": torch.zeros(fm.shape, dtype=torch.int32,
                                           device=fm.device),
                "faults": None}

    def inject(self, seed, inst_ids, rnd, t, honest_values: torch.Tensor, setup,
               with_bias: bool = True):
        """One step's ``(values, silent, bias)`` (spec §6).

        Faulty replicas of the adaptive family push the observed minority.
        Under a count-level delivery law the urn derives its strata from the
        wire values, so the bias is all zero (B, 1, n); under the keys law
        it is :func:`scheduling_bias`. ``with_bias=False`` returns ``None``
        for the bias: the per-step kernels recompute it from the wire values
        themselves, as the reference's Pallas kernels do.
        """
        cfg = self.cfg
        B, n = honest_values.shape
        dev = honest_values.device
        silent = torch.zeros((B, n), dtype=torch.bool, device=dev)
        if cfg.adversary == "none":
            values = honest_values
        else:
            faulty = setup["faulty"]
            minority = observed_minority(honest_values, faulty)
            values = torch.where(faulty, minority[:, None], honest_values)
        if not with_bias:
            return values, silent, None
        if cfg.count_level:
            return values, silent, torch.zeros((B, 1, n), dtype=torch.bool, device=dev)
        return values, silent, scheduling_bias(cfg, values, setup["faulty"])
