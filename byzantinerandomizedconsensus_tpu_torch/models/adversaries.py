"""Adversaries-as-data (spec/PROTOCOL.md §6), in torch.

The port's counterpart of the reference ``models/adversaries.py`` for every
static adversary: ``none`` (no faulty replica), ``crash`` (§3.3),
``byzantine`` (§6.3), ``adaptive`` (§6.4) and ``adaptive_min`` (§6.4b). An
adversary is a static per-instance setup (the faulty set, the crash rounds)
and a per-step injection mapping honest outgoing values to
``(values, silent, bias)``:

- ``values``: (B, n) common per-sender wire values;
- ``silent``: (B, n) bool sender silences;
- ``bias``:   (B, 1, n) or (B, R, n) scheduling-bias bits (spec §4 bit 30).

Ben-Or's Byzantine pairing under the keys law needs the reference's
(B, n, n) per-receiver equivocation matrix, which is not ported: it raises
by name. Under a count-level law the urn recomputes the two-faced class
values itself (``ops/urn.py::byz_class_values``).
"""

from __future__ import annotations

import torch

from byzantinerandomizedconsensus_tpu_torch.models.faults import fault_prone_mask
from byzantinerandomizedconsensus_tpu_torch.ops import prf

PORTED = ("none", "crash", "byzantine", "adaptive", "adaptive_min")
ADAPTIVE = ("adaptive", "adaptive_min")


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


def crash_rounds(cfg, seed, inst_ids: torch.Tensor) -> torch.Tensor:
    """(B, n) int32 crash round per replica (read only where faulty; spec
    §3.3): one CRASH_ROUND word per replica, mod ``crash_window``."""
    replica = torch.arange(cfg.n, dtype=torch.int64, device=inst_ids.device)[None, :]
    c = prf.prf_u32(seed, inst_ids.to(torch.int64)[:, None], 0, 0, replica, 0,
                    prf.CRASH_ROUND, pack=cfg.pack_version)
    return (c % cfg.crash_window).to(torch.int32)


def bracha_byzantine_code(cfg, seed, inst_ids: torch.Tensor, rnd, t) -> torch.Tensor:
    """(B, n) int64 — the §6.3 reliable-broadcast outcome of each sender at
    one Bracha step, ``prf_sender(..., tag=0, sender) & 3``: 0 silent, 1
    sends 0, 2 sends 1, 3 the honest value (read only where faulty)."""
    send = torch.arange(cfg.n, dtype=torch.int64, device=inst_ids.device)[None, :]
    return prf.prf_sender(seed, inst_ids.to(torch.int64)[:, None], rnd, t, 0, send,
                          prf.BYZ_VALUE, pack=cfg.pack_version) & 3


def scheduling_bias(cfg, values: torch.Tensor, faulty: torch.Tensor) -> torch.Tensor:
    """The keys law's scheduling-bias bits (spec §4 bit 30) for one step's
    wire ``values``: all zero (B, 1, n) under ``none``; by receiver class
    under ``adaptive`` ((B, n, n): receiver v prefers 0 iff v < (n+1)/2);
    minority first under ``adaptive_min`` ((B, 1, n)), the minority of the
    non-faulty wire values, which are the honest ones. ⊥ is always biased.
    Only the adaptive family biases scheduling."""
    B, n = values.shape
    if cfg.adversary not in ADAPTIVE:
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
        if self.cfg.adversary == "crash":
            cr = crash_rounds(self.cfg, seed, inst_ids)
        else:
            cr = torch.zeros(fm.shape, dtype=torch.int32, device=fm.device)
        return {"faulty": fm, "crash_round": cr, "faults": None}

    def inject(self, seed, inst_ids, rnd, t, honest_values: torch.Tensor, setup,
               with_bias: bool = True):
        """One step's ``(values, silent, bias)`` (spec §6).

        Crashed replicas (faulty, from their crash round on) are silent.
        Under Bracha a Byzantine sender's reliable broadcast is silent or
        carries 0, 1 or its honest value (:func:`bracha_byzantine_code`);
        under Ben-Or and a count-level law the honest values pass through,
        because the urn recomputes the two-faced class values. Faulty
        replicas of the adaptive family push the observed minority. Under a
        count-level delivery law the urn derives its strata from the wire
        values, so the bias is all zero (B, 1, n); under the keys law it is
        :func:`scheduling_bias`. ``with_bias=False`` returns ``None`` for
        the bias: the per-step kernels recompute it from the wire values
        themselves, as the reference's Pallas kernels do.
        """
        cfg = self.cfg
        B, n = honest_values.shape
        dev = honest_values.device
        silent = torch.zeros((B, n), dtype=torch.bool, device=dev)
        values = honest_values
        faulty = setup["faulty"]
        if cfg.adversary == "crash":
            silent = faulty & (rnd >= setup["crash_round"])
        elif cfg.adversary == "byzantine" and cfg.protocol == "bracha":
            b = bracha_byzantine_code(cfg, seed, inst_ids, rnd, t)
            silent = faulty & (b == 0)
            v = torch.where(b == 1, 0, torch.where(b == 2, 1, honest_values.to(torch.int64)))
            values = torch.where(faulty, v.to(torch.uint8), honest_values)
        elif cfg.adversary == "byzantine" and not cfg.count_level:
            raise NotImplementedError(
                "adversary='byzantine' under protocol='benor' and delivery='keys' "
                "needs the (B, n, n) per-receiver equivocation matrix (spec §6.3), "
                "which is not ported yet; the count-level laws run it")
        elif cfg.adversary in ADAPTIVE:
            minority = observed_minority(honest_values, faulty)
            values = torch.where(faulty, minority[:, None], honest_values)
        if not with_bias:
            return values, silent, None
        if cfg.count_level:
            return values, silent, torch.zeros((B, 1, n), dtype=torch.bool, device=dev)
        return values, silent, scheduling_bias(cfg, values, faulty)
