"""State initialisation, result extraction and the packed state word.

Torch counterpart of the reference ``models/state.py``. The state dict has the
reference's keys and dtypes: ``est`` and ``decided_val`` uint8 (B, n),
``decided`` bool (B, n), ``phase`` int32 (B, n). The ``*_from_numpy``
functions carry a reference state (numpy arrays) into the port, so both round
bodies can start from the same mid-run state.
"""

from __future__ import annotations

import numpy as np
import torch

from byzantinerandomizedconsensus_tpu_torch.ops import prf


def init_est(cfg, seed, inst_ids: torch.Tensor) -> torch.Tensor:
    """(B, n) uint8 initial estimates (spec §3.1)."""
    B, dev = inst_ids.shape[0], inst_ids.device
    replica = torch.arange(cfg.n, dtype=torch.int64, device=dev)[None, :]
    if cfg.init == "all0":
        return torch.zeros((B, cfg.n), dtype=torch.uint8, device=dev)
    if cfg.init == "all1":
        return torch.ones((B, cfg.n), dtype=torch.uint8, device=dev)
    if cfg.init == "split":
        return (replica & 1).to(torch.uint8).expand(B, cfg.n).contiguous()
    if cfg.init != "random":
        raise ValueError(f"unknown init {cfg.init!r}")
    inst = inst_ids.to(torch.int64)[:, None]
    return prf.prf_bit(seed, inst, 0, 0, replica, 0, prf.INIT_EST,
                       pack=cfg.pack_version).to(torch.uint8)


def init_state(cfg, seed, inst_ids: torch.Tensor) -> dict:
    est = init_est(cfg, seed, inst_ids)
    return {
        "est": est,
        "decided": torch.zeros(est.shape, dtype=torch.bool, device=est.device),
        "decided_val": torch.zeros_like(est),
        "phase": torch.zeros(est.shape, dtype=torch.int32, device=est.device),
    }


def all_correct_decided(state: dict, faulty: torch.Tensor) -> torch.Tensor:
    """(B,) bool — instance termination predicate (spec §1)."""
    return (state["decided"] | faulty).all(dim=-1)


def extract_decision(state: dict, faulty: torch.Tensor,
                     done: torch.Tensor) -> torch.Tensor:
    """(B,) uint8 — decided value of the lowest-indexed correct replica, 2 if
    undone. ``argmax`` takes no bool, so the correct mask is cast first; it
    returns the first maximum, as numpy's does."""
    first_correct = torch.argmax((~faulty).to(torch.uint8), dim=-1)
    val = torch.gather(state["decided_val"], 1, first_correct[:, None])[:, 0]
    return torch.where(done, val, torch.full_like(val, 2))


def pack_state(state: dict) -> torch.Tensor:
    """The resident u32 state word per (instance, replica), as int64 — the
    layout of ``prf.FUSED_STATE_BITS`` that the fused kernel keeps in a
    register."""
    word = torch.zeros(state["est"].shape, dtype=torch.int64,
                       device=state["est"].device)
    for name in ("est", "decided", "decided_val", "phase"):
        word |= state[name].to(torch.int64) << prf.FUSED_STATE_BITS[name][0]
    return word


def unpack_state(word: torch.Tensor) -> dict:
    def get(name):
        shift, width = prf.FUSED_STATE_BITS[name]
        return (word >> shift) & ((1 << width) - 1)

    return {
        "est": get("est").to(torch.uint8),
        "decided": get("decided") != 0,
        "decided_val": get("decided_val").to(torch.uint8),
        "phase": get("phase").to(torch.int32),
    }


_STATE_DTYPES = {"est": torch.uint8, "decided": torch.bool,
                 "decided_val": torch.uint8, "phase": torch.int32}


def state_from_numpy(state_np: dict, device) -> dict:
    """The reference's numpy state dict as the port's tensors on ``device``."""
    return {k: torch.tensor(np.asarray(state_np[k])).to(device=device, dtype=dt)
            for k, dt in _STATE_DTYPES.items()}


def setup_from_numpy(setup_np: dict, device) -> dict:
    """The reference's adversary setup (``faulty``, ``crash_round``) as the
    port's tensors on ``device``. The fault-schedule entry must be absent
    (``faults="none"``): the port has no fault schedules yet."""
    if setup_np.get("faults") is not None:
        raise NotImplementedError("fault schedules (spec §9) are not ported yet")
    return {
        "faulty": torch.tensor(np.asarray(setup_np["faulty"])).to(
            device=device, dtype=torch.bool),
        "crash_round": torch.tensor(np.asarray(setup_np["crash_round"])).to(
            device=device, dtype=torch.int32),
        "faults": None,
    }


def key_from_seed(seed) -> tuple[int, int]:
    """The (k0, k1) PRF key of a 64-bit seed, as python ints."""
    return prf.seed_key(seed)
