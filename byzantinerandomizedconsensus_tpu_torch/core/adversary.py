"""Adversary — fault injection for one instance (spec §6).

The port's copy of the reference oracle's ``core/adversary.py``: classes with
a per-step ``inject`` hook between broadcast and delivery. Implemented
independently of ``models/adversaries.py`` (scalar per-instance numpy against
batched torch tensors), so the oracle cross-checks the vectorized path.
"""

from __future__ import annotations

import numpy as np

from byzantinerandomizedconsensus_tpu_torch.core import prf


class Adversary:
    """Base class == the benign adversary ("none"): no faults, no bias."""

    kind = "none"

    def __init__(self, cfg, seed: int, instance: int):
        self.cfg = cfg
        self.seed = seed
        self.instance = instance
        self._pack = cfg.pack_version
        self.faulty = self._pick_faulty()
        self._no_bias = np.zeros((1, cfg.n), dtype=np.uint32)

    def _pick_faulty(self) -> np.ndarray:
        cfg = self.cfg
        if self.kind == "none" or cfg.f == 0:
            return np.zeros(cfg.n, dtype=bool)
        replica = np.arange(cfg.n, dtype=np.uint32)
        rank = prf.prf_u32(self.seed, self.instance, 0, 0, replica, 0,
                           prf.FAULTY_RANK, pack=self._pack)
        # Replica field: 10 | 12 bits per packing law (spec §2 v2).
        key = (rank & np.uint32(prf.KEY_MASK[self._pack])) | replica
        kth = np.partition(key, cfg.f - 1)[cfg.f - 1]
        return key <= kth

    def inject(self, rnd: int, t: int, honest_values: np.ndarray):
        """honest (n,) wire values -> (values (n,) or (n,n), silent (n,), bias)."""
        return honest_values, np.zeros(self.cfg.n, dtype=bool), self._no_bias


class CrashAdversary(Adversary):
    """Honest until a PRF-chosen crash round, silent after (spec §3.3, §6.2)."""

    kind = "crash"

    def __init__(self, cfg, seed, instance):
        super().__init__(cfg, seed, instance)
        replica = np.arange(cfg.n, dtype=np.uint32)
        c = prf.prf_u32(seed, instance, 0, 0, replica, 0, prf.CRASH_ROUND, pack=self._pack)
        self.crash_round = (c % np.uint32(cfg.crash_window)).astype(np.int32)

    def inject(self, rnd, t, honest_values):
        silent = self.faulty & (rnd >= self.crash_round)
        return honest_values, silent, self._no_bias


class ByzantineAdversary(Adversary):
    """spec §6.3 — RBC common outcome under bracha; per-receiver equivocation under
    plain benor (test-only pairing)."""

    kind = "byzantine"

    def inject(self, rnd, t, honest_values):
        cfg = self.cfg
        n = cfg.n
        send = np.arange(n, dtype=np.uint32)
        if cfg.protocol == "bracha":
            # Sender-addressed draw: prf_sender swaps the wide field under
            # the §2 v3 packing law (bit-identical at pack ≤ 2).
            b = prf.prf_sender(self.seed, self.instance, rnd, t, 0, send,
                               prf.BYZ_VALUE, pack=self._pack) & 3
            silent = self.faulty & (b == 0)
            v = np.where(b == 1, 0, np.where(b == 2, 1, honest_values)).astype(np.uint8)
            values = np.where(self.faulty, v, honest_values).astype(np.uint8)
            return values, silent, self._no_bias
        recv = np.arange(n, dtype=np.uint32)[:, None]
        e = prf.prf_u32(self.seed, self.instance, rnd, t, recv, send[None, :],
                        prf.BYZ_VALUE, pack=self._pack)
        vmat = (e % np.uint32(3)).astype(np.uint8)
        values = np.where(self.faulty[None, :], vmat,
                          np.broadcast_to(honest_values, (n, n)).astype(np.uint8))
        return values, np.zeros(n, dtype=bool), self._no_bias


class AdaptiveAdversary(Adversary):
    """spec §6.4 — observes this step's honest votes, pushes the minority value, and
    biases delivery order to keep the two halves of the receivers split."""

    kind = "adaptive"

    def observed_minority(self, honest_values) -> int:
        """spec §6.4: minority among live honest non-⊥ votes this step (ties → 1)."""
        honest = ~self.faulty
        nonbot = honest_values != 2
        h1 = int(np.count_nonzero(honest & nonbot & (honest_values == 1)))
        h0 = int(np.count_nonzero(honest & nonbot & (honest_values == 0)))
        return 1 if h1 <= h0 else 0

    def inject(self, rnd, t, honest_values):
        cfg = self.cfg
        n = cfg.n
        minority = self.observed_minority(honest_values)
        values = np.where(self.faulty, minority, honest_values).astype(np.uint8)
        pref = (np.arange(n) >= (n + 1) // 2).astype(np.uint8)[:, None]
        vv = values[None, :]
        bias = ((vv == 2) | (vv != pref)).astype(np.uint32)
        return values, np.zeros(n, dtype=bool), bias


class AdaptiveMinAdversary(AdaptiveAdversary):
    """spec §6.4b — same value attack as §6.4, but the scheduling bias is
    global-minority-first: every receiver hears minority-value senders first
    (receiver-independent, hence also urn-expressible)."""

    kind = "adaptive_min"

    def inject(self, rnd, t, honest_values):
        n = self.cfg.n
        minority = self.observed_minority(honest_values)
        values = np.where(self.faulty, minority, honest_values).astype(np.uint8)
        vv = values[None, :]
        bias = ((vv == 2) | (vv != np.uint8(minority))).astype(np.uint32)  # (1, n)
        return values, np.zeros(n, dtype=bool), bias


ADVERSARIES = {
    "none": Adversary,
    "crash": CrashAdversary,
    "byzantine": ByzantineAdversary,
    "adaptive": AdaptiveAdversary,
    "adaptive_min": AdaptiveMinAdversary,
}


def make_adversary(cfg, seed: int, instance: int) -> Adversary:
    return ADVERSARIES[cfg.adversary](cfg, seed, instance)
