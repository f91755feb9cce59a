"""Adversaries-as-data (spec/PROTOCOL.md §6), in torch.

The port's counterpart of the reference ``models/adversaries.py`` for every
static adversary: ``none`` (no faulty replica), ``crash`` (§3.3),
``byzantine`` (§6.3), ``adaptive`` (§6.4) and ``adaptive_min`` (§6.4b). An
adversary is a static per-instance setup (the faulty set, the crash rounds)
and a per-step injection mapping honest outgoing values to
``(values, silent, bias)``:

- ``values``: (B, n) common per-sender wire values;
- ``silent``: (B, n) bool sender silences;
- ``bias``:   (B, 1, n) or (B, R, n) scheduling-bias bits (spec §4 bit 30),
  R the receivers (all n, or a replica shard's ``recv_ids``).

Ben-Or's Byzantine pairing equivocates per receiver. Its inject passes the
honest values through, and each delivery law draws the equivocation itself:
the keys law the per-(receiver, sender) values of
:func:`equivocation_values`, a bounded chunk of instances at a time
(``ops/keys_step.py::step_counts_plain``), the urn the two-faced class
values (``ops/urn.py::byz_class_values``).

The fused lanes (``backends/batch.py``) run the ``superset`` adversary:
every adversary's outputs are computed on the shared setup and the per-row
``cfg.adv_code`` (``backends/batch.py::ADV_CODES``) selects. The faulty
set is gated on the code (empty on ``none`` rows), so each selected output
is the static law's.
"""

from __future__ import annotations

import torch

from byzantinerandomizedconsensus_tpu_torch.models.faults import (
    fault_prone_mask, setup_faults)
from byzantinerandomizedconsensus_tpu_torch.ops import prf

PORTED = ("none", "crash", "byzantine", "adaptive", "adaptive_min")
ADAPTIVE = ("adaptive", "adaptive_min")


def faulty_mask(cfg, seed, inst_ids: torch.Tensor) -> torch.Tensor:
    """(B, n) bool — the §3.2 faulty set; empty under the benign adversary
    (on a ``superset`` row: ``adv_code`` 0)."""
    if cfg.adversary == "none":
        return torch.zeros((inst_ids.shape[0], cfg.n), dtype=torch.bool,
                           device=inst_ids.device)
    mask = fault_prone_mask(cfg, seed, inst_ids)
    if cfg.adversary == "superset":
        mask = mask & (prf.rows(cfg.adv_code, 2) != 0)
    return mask


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
    return (c % prf.rows(cfg.crash_window, 2)).to(torch.int32)


def bracha_byzantine_code(cfg, seed, inst_ids: torch.Tensor, rnd, t) -> torch.Tensor:
    """(B, n) int64 — the §6.3 reliable-broadcast outcome of each sender at
    one Bracha step, ``prf_sender(..., tag=0, sender) & 3``: 0 silent, 1
    sends 0, 2 sends 1, 3 the honest value (read only where faulty)."""
    send = torch.arange(cfg.n, dtype=torch.int64, device=inst_ids.device)[None, :]
    return prf.prf_sender(seed, inst_ids.to(torch.int64)[:, None], rnd, t, 0, send,
                          prf.BYZ_VALUE, pack=cfg.pack_version) & 3


def two_faced(cfg) -> bool:
    """True for Ben-Or's Byzantine pairing, whose faulty senders show each
    receiver its own value (spec §6.3)."""
    return cfg.adversary == "byzantine" and cfg.protocol != "bracha"


def maybe_two_faced(cfg):
    """Where Ben-Or's Byzantine pairing holds: ``True``/``False`` for a
    static adversary, or the (B,) bool rows of a ``superset`` lane
    (``adv_code`` 2) under Ben-Or."""
    if cfg.adversary == "superset" and cfg.protocol != "bracha":
        return cfg.adv_code == 2
    return two_faced(cfg)


def equivocation_values(cfg, seed, inst_ids: torch.Tensor, rnd, t,
                        honest: torch.Tensor, faulty: torch.Tensor,
                        recv_ids=None) -> torch.Tensor:
    """(B, R, n) uint8, axes (instance, recv, send): the wire value each
    receiver of ``recv_ids`` (default all n) sees from each sender under
    Ben-Or's Byzantine pairing (spec §6.3). A faulty sender shows receiver
    ``recv`` the value ``prf_u32(..., recv, send, BYZ_VALUE) % 3`` (2 is ⊥,
    a live message that is not counted); the others their honest value."""
    n, dev = cfg.n, honest.device
    recv = prf.receivers(cfg, recv_ids, dev)[None, :, None]
    send = torch.arange(n, dtype=torch.int64, device=dev)[None, None, :]
    e = prf.prf_u32(seed, inst_ids.to(torch.int64)[:, None, None], rnd, t, recv, send,
                    prf.BYZ_VALUE, pack=cfg.pack_version)
    return torch.where(faulty[:, None, :], (e % 3).to(torch.uint8), honest[:, None, :])


def scheduling_bias(cfg, values: torch.Tensor, faulty: torch.Tensor,
                    recv_ids=None) -> torch.Tensor:
    """The keys law's scheduling-bias bits (spec §4 bit 30) for one step's
    wire ``values``: all zero (B, 1, n) under ``none``; by receiver class
    under ``adaptive`` ((B, R, n) over the receivers ``recv_ids``, default
    all n: receiver v prefers 0 iff v < (n+1)/2); minority first under
    ``adaptive_min`` ((B, 1, n)), the minority of the non-faulty wire
    values, which are the honest ones. ⊥ is always biased. Only the
    adaptive family biases scheduling."""
    B, n = values.shape
    if cfg.adversary not in ADAPTIVE + ("superset",):
        return torch.zeros((B, 1, n), dtype=torch.bool, device=values.device)
    vv = values[:, None, :]
    if cfg.adversary != "adaptive":
        bias_min = (vv == 2) | (vv != observed_minority(values, faulty)[:, None, None])
        if cfg.adversary == "adaptive_min":
            return bias_min
    recv = prf.receivers(cfg, recv_ids, values.device)[None, :, None]
    bias_ad = (vv == 2) | (vv != (recv >= prf.rows((cfg.n_eff + 1) // 2, 3)))
    if cfg.adversary == "adaptive":
        return bias_ad
    code = prf.rows(cfg.adv_code, 3)
    return torch.where(code == 3, bias_ad, (code == 4) & bias_min)


class AdversaryModel:
    """Static dispatch on ``cfg.adversary``; holds only the config."""

    def __init__(self, cfg):
        if cfg.adversary not in PORTED + ("superset",):
            raise ValueError(
                f"unknown adversary={cfg.adversary!r}; the port runs the static "
                f"adversaries {PORTED} and, on the fused lanes, 'superset'")
        self.cfg = cfg

    def setup(self, seed, inst_ids: torch.Tensor) -> dict:
        """The static per-instance setup: the faulty set, the crash rounds
        and the §9 fault schedule's state (``None`` under faults none)."""
        fm = faulty_mask(self.cfg, seed, inst_ids)
        if self.cfg.adversary in ("crash", "superset"):
            cr = crash_rounds(self.cfg, seed, inst_ids)
        else:
            cr = torch.zeros(fm.shape, dtype=torch.int32, device=fm.device)
        # Any static adversary but none selects the fault-prone set as its
        # faulty set; the superset's is gated per row, so the schedule draws
        # its own.
        fprone = None if self.cfg.adversary in ("none", "superset") else fm
        return {"faulty": fm, "crash_round": cr,
                "faults": setup_faults(self.cfg, seed, inst_ids, fprone=fprone)}

    def inject(self, seed, inst_ids, rnd, t, honest_values: torch.Tensor, setup,
               with_bias: bool = True, recv_ids=None):
        """One step's ``(values, silent, bias)`` (spec §6).

        Crashed replicas (faulty, from their crash round on) are silent.
        Under Bracha a Byzantine sender's reliable broadcast is silent or
        carries 0, 1 or its honest value (:func:`bracha_byzantine_code`);
        under Ben-Or the honest values pass through, because the delivery
        law draws the equivocation (:func:`equivocation_values`,
        ``ops/urn.py::byz_class_values``). Faulty
        replicas of the adaptive family push the observed minority. Under a
        count-level delivery law the urn derives its strata from the wire
        values, so the bias is all zero (B, 1, n); under the keys law it is
        :func:`scheduling_bias`. ``with_bias=False`` returns ``None`` for
        the bias: the per-step kernels recompute it from the wire values
        themselves, as the reference's Pallas kernels do. ``recv_ids``
        (global indices, a replica shard of the sharded path) restricts the
        receiver axis of the adaptive bias; the sender axis stays full width.
        """
        cfg = self.cfg
        B, n = honest_values.shape
        dev = honest_values.device
        silent = torch.zeros((B, n), dtype=torch.bool, device=dev)
        values = honest_values
        faulty = setup["faulty"]
        if cfg.adversary == "superset":
            values, silent = self._inject_superset(seed, inst_ids, rnd, t,
                                                   honest_values, setup)
        elif cfg.adversary == "crash":
            silent = faulty & (prf.rows(rnd, 2) >= setup["crash_round"])
        elif cfg.adversary == "byzantine" and cfg.protocol == "bracha":
            b = bracha_byzantine_code(cfg, seed, inst_ids, rnd, t)
            silent = faulty & (b == 0)
            v = torch.where(b == 1, 0, torch.where(b == 2, 1, honest_values.to(torch.int64)))
            values = torch.where(faulty, v.to(torch.uint8), honest_values)
        elif cfg.adversary in ADAPTIVE:
            minority = observed_minority(honest_values, faulty)
            values = torch.where(faulty, minority[:, None], honest_values)
        if not with_bias:
            return values, silent, None
        if cfg.count_level:
            return values, silent, torch.zeros((B, 1, n), dtype=torch.bool, device=dev)
        return values, silent, scheduling_bias(cfg, values, faulty, recv_ids)

    def _inject_superset(self, seed, inst_ids, rnd, t, honest_values, setup):
        """The fused lanes' ``(values, silent)``: crash, the Bracha
        Byzantine broadcast and the adaptive minority push, each computed
        on the shared setup and selected by the per-row ``adv_code``. Under
        Ben-Or the Byzantine rows pass their honest values through, as the
        static pairing does (the delivery law draws the equivocation)."""
        cfg = self.cfg
        faulty = setup["faulty"]
        code = prf.rows(cfg.adv_code, 2)
        crash_sil = faulty & (prf.rows(rnd, 2) >= setup["crash_round"])
        minority = observed_minority(honest_values, faulty)
        adapt = torch.where(faulty, minority[:, None], honest_values)
        byz_values, byz_sil = honest_values, torch.zeros_like(faulty)
        if cfg.protocol == "bracha":
            b = bracha_byzantine_code(cfg, seed, inst_ids, rnd, t)
            byz_sil = faulty & (b == 0)
            v = torch.where(b == 1, 0, torch.where(b == 2, 1, honest_values.to(torch.int64)))
            byz_values = torch.where(faulty, v.to(torch.uint8), honest_values)
        values = torch.where(code == 2, byz_values,
                             torch.where(code >= 3, adapt, honest_values))
        silent = torch.where(code == 1, crash_sil, (code == 2) & byz_sil)
        return values, silent


class PadAdversary(AdversaryModel):
    """The lane runner's adversary (``backends/batch.py``): padding replicas
    (index ≥ the row's ``n_eff``) are silent on every step, so no delivery
    law or validation rule counts them, and faulty for termination and
    extraction, so they never gate a decision."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self._pad = None
        if isinstance(cfg.n_eff, torch.Tensor) or cfg.n_eff != cfg.n:
            replica = torch.arange(cfg.n, dtype=torch.int64,
                                   device=prf.rows(cfg.n_eff, 2).device)[None, :]
            self._pad = replica >= prf.rows(cfg.n_eff, 2)

    def setup(self, seed, inst_ids: torch.Tensor) -> dict:
        s = super().setup(seed, inst_ids)
        if self._pad is not None:
            s = dict(s, faulty=s["faulty"] | self._pad)
        return s

    def inject(self, seed, inst_ids, rnd, t, honest_values, setup,
               with_bias: bool = True, recv_ids=None):
        v, s, b = super().inject(seed, inst_ids, rnd, t, honest_values, setup,
                                 with_bias, recv_ids)
        if self._pad is not None:
            s = s | self._pad
        return v, s, b
