"""Fault schedule for one instance (spec §9) — the scalar oracle leg.

The port's copy of the reference oracle's ``core/faults.py``. Implemented
independently of ``models/faults.py`` (per-instance numpy against batched
torch tensors), so the oracle cross-checks the vectorized fault laws, as
``core/adversary.py`` does ``models/adversaries.py``. Both draw from the
same PRF coordinates, so they agree bit for bit on every mask
(``tests/test_torch_oracle.py``).
"""

from __future__ import annotations

import numpy as np

from byzantinerandomizedconsensus_tpu_torch.core import prf


class FaultSchedule:
    """Per-instance fault-schedule state + the per-round mask function.

    ``round_masks(rnd)`` returns ``(fsil, fside)``: the (n,) bool extra
    sender silences this round and the (n,) uint8 partition side plane
    (None when no cut is active this round — including always, for the
    non-partition kinds).
    """

    def __init__(self, cfg, seed: int, instance: int):
        self.cfg = cfg
        self.seed = seed
        self.instance = instance
        self._pack = cfg.pack_version
        n, w = cfg.n, cfg.crash_window
        replica = np.arange(n, dtype=np.uint32)
        self.fprone = self._fault_prone()
        if cfg.faults == "recover":
            down = prf.prf_u32(seed, instance, 0, 0, replica, 0,
                               prf.FAULT_CRASH, pack=self._pack) \
                % np.uint32(w)
            length = prf.prf_u32(seed, instance, 0, 0, replica, 0,
                                 prf.FAULT_HEAL, pack=self._pack) \
                % np.uint32(2 * w)
            self.down_at = down.astype(np.int32)
            self.up_at = (down + length).astype(np.int32) + np.int32(1)
        elif cfg.faults == "partition":
            side = prf.prf_u32(seed, instance, 0, 0, replica, 0,
                               prf.FAULT_SIDE, pack=self._pack) \
                & np.uint32(1)
            # Isolated side ⊆ the fault-prone set (spec §9 safety reduction).
            self.side = (side.astype(np.uint8) * self.fprone.astype(np.uint8))
            start = int(prf.prf_u32(seed, instance, 0, 0, 0, 0,
                                    prf.FAULT_EPOCH, pack=self._pack))
            length = int(prf.prf_u32(seed, instance, 0, 0, 1, 0,
                                     prf.FAULT_EPOCH, pack=self._pack))
            self.part_start = start % w
            self.part_heal = self.part_start + length % (2 * w) + 1

    def _fault_prone(self) -> np.ndarray:
        """(n,) bool — the §3.2 selection, not gated on cfg.adversary."""
        cfg = self.cfg
        if cfg.f == 0:
            return np.zeros(cfg.n, dtype=bool)
        replica = np.arange(cfg.n, dtype=np.uint32)
        rank = prf.prf_u32(self.seed, self.instance, 0, 0, replica, 0,
                           prf.FAULTY_RANK, pack=self._pack)
        key = (rank & np.uint32(prf.KEY_MASK[self._pack])) | replica
        kth = np.partition(key, cfg.f - 1)[cfg.f - 1]
        return key <= kth

    def round_masks(self, rnd: int):
        cfg = self.cfg
        if cfg.faults == "recover":
            fsil = self.fprone & (rnd >= self.down_at) & (rnd < self.up_at)
            return fsil, None
        if cfg.faults == "partition":
            if self.part_start <= rnd < self.part_heal:
                return np.zeros(cfg.n, dtype=bool), self.side
            return np.zeros(cfg.n, dtype=bool), None
        # omission: burst gate at rate 1/4, per-replica bit inside a burst.
        gate = int(prf.prf_u32(self.seed, self.instance, rnd, 0, 0, 1,
                               prf.FAULT_OMIT, pack=self._pack))
        if gate & 3:
            return np.zeros(cfg.n, dtype=bool), None
        replica = np.arange(cfg.n, dtype=np.uint32)
        bit = prf.prf_u32(self.seed, self.instance, rnd, 0, replica, 0,
                          prf.FAULT_OMIT, pack=self._pack) \
            & np.uint32(1)
        return self.fprone & (bit == 1), None
