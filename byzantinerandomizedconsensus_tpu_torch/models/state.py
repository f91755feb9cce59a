"""State initialisation, result extraction and the packed state word.

Torch counterpart of the reference ``models/state.py``. The state dict has the
reference's keys and dtypes: ``est`` and ``decided_val`` uint8 (B, R),
``decided`` bool (B, R), ``phase`` int32 (B, R), R the n replicas or, on
the sharded path, a shard of them (``recv_ids``). The ``*_from_numpy``
functions carry a reference state (numpy arrays) into the port, so both round
bodies can start from the same mid-run state.

Under the fused lanes (``backends/batch.py``) ``cfg.init`` is
``"superset"``: all four init laws are evaluated and the per-row
``cfg.init_code`` (0 random, 1 all0, 2 all1, 3 split) selects.
"""

from __future__ import annotations

import numpy as np
import torch

from byzantinerandomizedconsensus_tpu_torch.ops import prf
from byzantinerandomizedconsensus_tpu_torch.ops.prf import receivers


def init_est(cfg, seed, inst_ids: torch.Tensor, recv_ids=None) -> torch.Tensor:
    """(B, R) uint8 initial estimates (spec §3.1) of the receivers
    ``recv_ids`` (global indices; default all n, R = n)."""
    B, dev = inst_ids.shape[0], inst_ids.device
    replica = receivers(cfg, recv_ids, dev)[None, :]
    R = replica.shape[1]
    if cfg.init == "all0":
        return torch.zeros((B, R), dtype=torch.uint8, device=dev)
    if cfg.init == "all1":
        return torch.ones((B, R), dtype=torch.uint8, device=dev)
    if cfg.init == "split":
        return (replica & 1).to(torch.uint8).expand(B, R).contiguous()
    if cfg.init not in ("random", "superset"):
        raise ValueError(f"unknown init {cfg.init!r}")
    inst = inst_ids.to(torch.int64)[:, None]
    rand = prf.prf_bit(seed, inst, 0, 0, replica, 0, prf.INIT_EST,
                       pack=cfg.pack_version).to(torch.uint8)
    if cfg.init == "random":
        return rand
    code = prf.rows(cfg.init_code, 2)
    split = (replica & 1).to(torch.uint8)
    return torch.where(code == 0, rand, torch.where(
        code == 1, 0, torch.where(code == 2, 1, split))).to(torch.uint8)


def init_state(cfg, seed, inst_ids: torch.Tensor, recv_ids=None) -> dict:
    """The (B, R) state of the receivers ``recv_ids`` (default all n)."""
    est = init_est(cfg, seed, inst_ids, recv_ids)
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


_FAULT_DTYPES = {"fprone": torch.bool, "down_at": torch.int32, "up_at": torch.int32,
                 "side": torch.uint8, "part_start": torch.int32,
                 "part_heal": torch.int32}


def setup_from_numpy(setup_np: dict, device) -> dict:
    """The reference's adversary setup (``faulty``, ``crash_round`` and the
    §9 ``faults`` entry) as the port's tensors on ``device``, for one
    config's static schedule. The fused lanes' ``superset`` schedule, which
    carries the recover and the partition state at once, is refused by name:
    a lane record restores its rows through ``backends/compaction.py``."""
    def tensor(x, dtype):
        return torch.tensor(np.asarray(x)).to(device=device, dtype=dtype)

    fs = setup_np.get("faults")
    if fs is not None and "down_at" in fs and "side" in fs:
        raise NotImplementedError(
            "fault schedules of the fused lanes' 'superset' law hold per-row "
            "codes; restore them through backends/compaction.py::run_bucket")
    return {
        "faulty": tensor(setup_np["faulty"], torch.bool),
        "crash_round": tensor(setup_np["crash_round"], torch.int32),
        "faults": None if fs is None else {k: tensor(v, _FAULT_DTYPES[k])
                                           for k, v in fs.items()},
    }


def key_from_seed(seed) -> tuple[int, int]:
    """The (k0, k1) PRF key of a 64-bit seed, as python ints."""
    return prf.seed_key(seed)
