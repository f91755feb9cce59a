"""Replica — per-replica protocol state machine (spec §5).

The port's copy of the reference oracle's ``core/replica.py``. Scalar state
(``phase``, ``est``, ``decided``, ``decided_val``), driven one broadcast step
at a time. Implements both protocol round bodies with plain integer
arithmetic; this is the oracle the vectorized backends are bit-matched
against, so it is written for obviousness, not speed.
"""

from __future__ import annotations

import numpy as np


class Replica:
    def __init__(self, cfg, index: int, est: int):
        from byzantinerandomizedconsensus_tpu_torch.models.committee import (
            quorum_params)

        self.cfg = cfg
        # The (n, f) pair thresholds evaluate over: (n, f) itself for the
        # full-mesh deliveries, the committee (C, f_C) under spec §10.3.
        self._nq, self._fq = quorum_params(cfg)
        self.index = index
        self.est = int(est)
        self.decided = False
        self.decided_val = 0
        self.phase = 0
        # per-round temporaries
        self._prop = 2
        self._m = 0
        self._d = 2
        self._w = 0
        self._decide_now = False
        self._adopt = False

    # -- sending ---------------------------------------------------------------
    def send_value(self, t: int) -> int:
        """The honest wire value for step t (decided replicas keep participating
        with est frozen — spec §1)."""
        if t == 0:
            return self.est
        if self.cfg.protocol == "benor":
            return self._prop
        return self._m if t == 1 else self._d

    # -- receiving -------------------------------------------------------------
    def on_deliver(self, t: int, values: np.ndarray, delivered: np.ndarray) -> None:
        """Process one step's delivered messages (values row + delivery mask row)."""
        c0 = int(np.count_nonzero(delivered & (values == 0)))
        c1 = int(np.count_nonzero(delivered & (values == 1)))
        self.on_counts(t, c0, c1)

    def on_counts(self, t: int, c0: int, c1: int) -> None:
        """Process one step from delivered-value counts (urn delivery, spec
        §4b). Committee configs evaluate the same thresholds over (C, f_C)
        — spec §10.3."""
        n, f = self._nq, self._fq
        if self.cfg.protocol == "benor":
            # Protocol A (benign) vs Protocol B (lying) thresholds — spec §5.1.
            lying = self.cfg.lying_adversary
            qrhs = n + f if lying else n
            if t == 0:  # report -> proposal
                self._prop = 1 if 2 * c1 > qrhs else (0 if 2 * c0 > qrhs else 2)
            else:       # propose -> action
                self._w = 1 if c1 >= c0 else 0
                c = c1 if self._w else c0
                self._decide_now = (2 * c > n + f) if lying else (c >= f + 1)
                self._adopt = c >= (f + 1 if lying else 1)
        else:
            if t == 0:    # majority of delivered, ties -> 1 (spec §5.2)
                self._m = 1 if c1 >= c0 else 0
            elif t == 1:  # decide-proposal needs absolute > n/2
                self._d = 1 if 2 * c1 > n else (0 if 2 * c0 > n else 2)
            else:
                self._w = 1 if c1 >= c0 else 0
                c = c1 if self._w else c0
                self._decide_now = c >= 2 * f + 1
                self._adopt = c >= f + 1

    # -- end of round ----------------------------------------------------------
    def end_round(self, coin_bit: int) -> None:
        if self.decided:
            return
        self.phase += 1
        if self._decide_now:
            self.decided = True
            self.decided_val = self._w
            self.est = self._w
        elif self._adopt:
            self.est = self._w
        else:
            self.est = int(coin_bit)
