"""Fault schedules as data (spec/PROTOCOL.md §9), in torch.

The port's counterpart of the reference ``models/faults.py``. A fault
schedule is the axis orthogonal to the §6 adversary: a static per-instance
setup (the §3.2 fault-prone set and PRF-drawn window or epoch parameters,
:func:`setup_faults`) and a per-round mask function (:func:`round_masks`)
giving

- ``fsil``: (B, n) bool extra sender silences this round (crash-recovery
  windows, omission bursts), OR'd into the adversary's silent set before
  §5.1b validation and §4 delivery;
- ``fside``: (B, n) uint8 partition side plane (1 = isolated), 0 everywhere
  outside the instance's partition epoch; cross-side messages are
  suppressed at the delivery law in both directions.

Every schedule draws only from the §3.2 fault-prone set (the f replicas the
adversary would pick), so a run never has more than f misbehaving replicas.
u32 words are carried in int64, as everywhere in the port.

Under the lane runner (``backends/batch.py``) ``cfg.f``, ``cfg.n_eff`` and
``cfg.crash_window`` are (rows,) int64 tensors and the round may be one too
(the compacted grid); the fused lanes' ``superset`` kind draws the recover
and the partition setups both and selects per row by ``cfg.faults_code``
(0 none, 1 recover, 2 partition, 3 omission).
"""

from __future__ import annotations

import torch

from byzantinerandomizedconsensus_tpu_torch.config import FAULT_KINDS
from byzantinerandomizedconsensus_tpu_torch.ops import prf


class FaultsUnsupported(RuntimeError):
    """Raised by a kernel that has no fault-schedule channel, by name,
    instead of silently running the fault-free law."""


def check_faults_supported(cfg, where: str, exc=FaultsUnsupported) -> None:
    """Reject ``cfg.faults != "none"`` on a stack without a fault channel,
    raising ``exc`` (a :class:`FaultsUnsupported`) with a message that
    starts with ``where``."""
    if cfg.faults != "none":
        raise exc(
            f"{where}: no fault-schedule channel, so faults={cfg.faults!r} "
            f"runs on kernel='plain' (or kernel='fused' under delivery urn2)")


def _check_kind(cfg) -> None:
    if cfg.faults == "superset" and not hasattr(cfg, "faults_code"):
        raise NotImplementedError(
            "faults='superset' is the fused lanes' law: it selects by per-row "
            "codes, which only a lane config carries (backends/batch.py::"
            "FusedLaneConfig)")
    if cfg.faults not in FAULT_KINDS + ("superset",):
        raise ValueError(f"unknown faults {cfg.faults!r}")


def fault_prone_mask(cfg, seed, inst_ids: torch.Tensor) -> torch.Tensor:
    """(B, n) bool — the f replicas with the smallest FAULTY_RANK keys
    ``(rank & KEY_MASK) | replica``. The keys are distinct (the low bits are
    the replica), so the f-th smallest is exact.

    A lane row (``backends/batch.py``) with ``n_eff`` below the padded
    width forces its padding replicas' keys past every real key and masks
    them out; a per-row ``f`` selects each row's f-th smallest key, and
    ``f = 0`` selects none."""
    B, dev = inst_ids.shape[0], inst_ids.device
    f = cfg.f
    f_static = not isinstance(f, torch.Tensor)
    if f_static and f == 0:
        return torch.zeros((B, cfg.n), dtype=torch.bool, device=dev)
    replica = torch.arange(cfg.n, dtype=torch.int64, device=dev)[None, :]
    rank = prf.prf_u32(seed, inst_ids.to(torch.int64)[:, None], 0, 0, replica, 0,
                       prf.FAULTY_RANK, pack=cfg.pack_version)
    key = (rank & prf.KEY_MASK[cfg.pack_version]) | replica
    n_eff = cfg.n_eff
    padded = isinstance(n_eff, torch.Tensor) or n_eff != cfg.n
    if padded:
        real = replica < prf.rows(n_eff, 2)
        key = torch.where(real, key, prf.MASK32)
    if f_static:
        kth = torch.kthvalue(key, f, dim=-1).values
        mask = key <= kth[:, None]
    else:
        idx = (torch.clamp(f, min=1) - 1).to(torch.int64)[:, None]
        kth = torch.gather(torch.sort(key, dim=-1).values, 1, idx)
        mask = (key <= kth) & (f > 0)[:, None]
    if padded:
        mask = mask & real
    return mask


def setup_faults(cfg, seed, inst_ids: torch.Tensor, fprone=None):
    """The static per-instance schedule state (spec §9), or ``None`` under
    ``faults="none"``: ``fprone`` (B, n) bool always; under ``recover`` the
    (B, n) int32 outage window ``[down_at, up_at)``; under ``partition`` the
    (B, n) uint8 ``side`` (a PRF-drawn subset of the fault-prone set) and the
    (B,) int32 epoch ``[part_start, part_heal)``. Omission draws per round.
    ``fprone``, when the caller holds the §3.2 selection already (the faulty
    set of any adversary but ``none`` is the same set), is taken as it is
    instead of sorting again. The fused lanes' ``superset`` kind draws the
    recover and the partition state both."""
    _check_kind(cfg)
    if cfg.faults == "none":
        return None
    pack = cfg.pack_version
    inst1 = inst_ids.to(torch.int64)
    inst = inst1[:, None]
    replica = torch.arange(cfg.n, dtype=torch.int64, device=inst_ids.device)[None, :]
    w = cfg.crash_window
    w2 = prf.rows(w, 2)
    if fprone is None:
        fprone = fault_prone_mask(cfg, seed, inst_ids)
    out = {"fprone": fprone}
    if cfg.faults in ("recover", "superset"):
        down = prf.prf_u32(seed, inst, 0, 0, replica, 0, prf.FAULT_CRASH, pack=pack) % w2
        length = prf.prf_u32(seed, inst, 0, 0, replica, 0, prf.FAULT_HEAL,
                             pack=pack) % (2 * w2)
        out["down_at"] = down.to(torch.int32)
        out["up_at"] = (down + length + 1).to(torch.int32)
    if cfg.faults in ("partition", "superset"):
        side = prf.prf_u32(seed, inst, 0, 0, replica, 0, prf.FAULT_SIDE, pack=pack) & 1
        out["side"] = (side.to(torch.uint8) * out["fprone"].to(torch.uint8))
        start = prf.prf_u32(seed, inst1, 0, 0, 0, 0, prf.FAULT_EPOCH, pack=pack) % w
        length = prf.prf_u32(seed, inst1, 0, 0, 1, 0, prf.FAULT_EPOCH,
                             pack=pack) % (2 * w)
        out["part_start"] = start.to(torch.int32)
        out["part_heal"] = (start + length + 1).to(torch.int32)
    return out


def omission_gate(cfg, seed, inst_ids: torch.Tensor, rnd) -> torch.Tensor:
    """(B,) bool — the per-(instance, round) burst gate of ``omission``:
    ``prf(inst, rnd, step 0, recv 0, send 1, FAULT_OMIT) & 3 == 0`` (rate
    1/4)."""
    gate = prf.prf_u32(seed, inst_ids.to(torch.int64), rnd, 0, 0, 1, prf.FAULT_OMIT,
                       pack=cfg.pack_version)
    return (gate & 3) == 0


def omission_bits(cfg, seed, inst_ids: torch.Tensor, rnd) -> torch.Tensor:
    """(B, n) bool — each replica's own omission bit in a burst round,
    ``prf(inst, rnd, step 0, recv replica, send 0, FAULT_OMIT) & 1``."""
    replica = torch.arange(cfg.n, dtype=torch.int64, device=inst_ids.device)[None, :]
    bit = prf.prf_u32(seed, inst_ids.to(torch.int64)[:, None], rnd, 0, replica, 0,
                      prf.FAULT_OMIT, pack=cfg.pack_version)
    return (bit & 1) == 1


def round_masks(cfg, seed, inst_ids: torch.Tensor, rnd, fsetup, stats=None):
    """The round's fault masks ``(fsil, fside)`` (module docstring), each
    ``None`` where the kind has none; ``(None, None)`` without a schedule.
    ``stats``, when a dict, gains ``fault_words`` (B,) int64 under omission:
    the PRF words the round needs, the burst gate's and one bit word per
    fault-prone replica in a burst round."""
    if fsetup is None:
        return None, None
    _check_kind(cfg)
    fprone = fsetup["fprone"]
    r2 = prf.rows(rnd, 2)
    if cfg.faults in ("recover", "superset"):
        fsil_rec = fprone & (r2 >= fsetup["down_at"]) & (r2 < fsetup["up_at"])
        if cfg.faults == "recover":
            return fsil_rec, None
    if cfg.faults in ("partition", "superset"):
        active = (rnd >= fsetup["part_start"]) & (rnd < fsetup["part_heal"])
        fside = torch.where(active[:, None], fsetup["side"],
                            torch.zeros_like(fsetup["side"]))
        if cfg.faults == "partition":
            return None, fside
    drawn = fprone & omission_gate(cfg, seed, inst_ids, rnd)[:, None]
    if stats is not None:
        stats["fault_words"] = 1 + drawn.sum(dim=-1, dtype=torch.int64)
    fsil_om = drawn & omission_bits(cfg, seed, inst_ids, rnd)
    if cfg.faults == "omission":
        return fsil_om, None
    code = prf.rows(cfg.faults_code, 2)
    fsil = torch.where(code == 1, fsil_rec, (code == 3) & fsil_om)
    return fsil, torch.where(code == 2, fside, torch.zeros_like(fside))


def cross_silent(fside: torch.Tensor, recv_ids=None) -> torch.Tensor:
    """(B, R, n) bool — the partition cut as a per-(recv, send) silence
    plane for the spec §4 keys law: suppressed iff the two sides differ.
    ``recv_ids`` restricts the receiver axis (default all n)."""
    fside_recv = (fside if recv_ids is None
                  else fside[:, recv_ids.to(device=fside.device, dtype=torch.int64)])
    return fside_recv[:, :, None] != fside[:, None, :]
