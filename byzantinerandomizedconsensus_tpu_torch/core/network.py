"""Network — in-process message transport for one instance (spec §4).

The port's copy of the reference oracle's ``core/network.py``. Materialises
the per-step (n_recv, n_send) delivery mask: each receiver gets exactly the
n-f live senders whose combined scheduling key is smallest; and the
count-level laws (§4b, §4b-v2, §4c, §10.2) per receiver with scalar Python
ints. Implemented independently of ``ops/`` (row-wise ``numpy.partition``
and per-receiver loops against the vectorized torch code), so the oracle
cross-checks the vectorized semantics. Its draws come from the oracle's own
PRF (``core/prf.py``).
"""

from __future__ import annotations

import math

import numpy as np

from byzantinerandomizedconsensus_tpu_torch.core import prf


class Network:
    def __init__(self, cfg, seed: int, instance: int):
        self.cfg = cfg
        self.seed = seed
        self.instance = instance
        self._recv = np.arange(cfg.n, dtype=np.uint32)
        self._pack = cfg.pack_version
        # Packing-law sub-parameters (spec §2 v2): range-reduction shifts and
        # the combined-key field split (prf-top width, sender-index width).
        self._rs, self._rd = prf.RED_SHIFTS[self._pack]
        self._klow = prf.KEY_LOW_BITS[self._pack]

    def delivery_mask(self, rnd: int, t: int, silent: np.ndarray, bias: np.ndarray,
                      fside=None) -> np.ndarray:
        """(n, n) bool delivered(recv, send). ``silent``: (n,) bool; ``bias``: (n, n)
        or (1, n) uint32 per-(recv, send) bias bits (spec §4/§6.4). ``fside``:
        optional (n,) uint8 spec-§9 partition side plane — cross-side senders
        are silenced from this receiver's perspective."""
        n, f = self.cfg.n, self.cfg.f
        mask = np.empty((n, n), dtype=bool)
        send = self._recv
        for v in range(n):
            row_silent = silent if fside is None \
                else (silent | (fside != fside[v]))
            sched = prf.prf_u32(self.seed, self.instance, rnd, t,
                                v, send, prf.SCHED,
                                pack=self._pack)
            bias_row = bias[0] if bias.shape[0] == 1 else bias[v]
            top = np.uint32(30 - self._klow)          # prf field width: 20 | 18
            combined = (
                (row_silent.astype(np.uint32) << np.uint32(31))
                | (bias_row.astype(np.uint32) << np.uint32(30))
                | (((sched >> np.uint32(32 - int(top)))
                    & np.uint32((1 << int(top)) - 1)) << np.uint32(self._klow))
                | send
            )
            combined[v] = v  # own message always delivered (spec §4)
            kth = np.partition(combined, n - f - 1)[n - f - 1]
            mask[v] = (combined <= kth) & ~row_silent
            mask[v, v] = True  # own delivery is exempt from silence (spec §4)
        return mask

    def deliver(self, rnd: int, t: int, values, silent: np.ndarray, bias: np.ndarray,
                fside=None):
        """Returns (vmat (n_recv, n_send) uint8, mask (n_recv, n_send) bool)."""
        n = self.cfg.n
        values = np.asarray(values, dtype=np.uint8)
        vmat = np.broadcast_to(values, (n, n)) if values.ndim == 1 else values
        return vmat, self.delivery_mask(rnd, t, silent, bias, fside=fside)

    def urn_counts(self, rnd: int, t: int, vals_by_class, silent: np.ndarray,
                   strata: str = "none", minority: int = 0, fside=None):
        """Per-receiver delivered counts (c0, c1) via the §4b urn process.

        ``vals_by_class``: pair of (n,) wire-value arrays, one per receiver class
        (identical objects when the adversary doesn't equivocate). ``strata``
        selects the bias rule: "none" | "class" (spec §6.4, adaptive) |
        "minority" (spec §6.4b, adaptive_min — ``minority`` is the observed
        minority value this step). Scalar python-int implementation, independent
        of ops/urn.py, per the spec's D-iteration form (unused LCG draws are
        never generated, which is equivalent to the vectorized f-iteration
        masked form).
        """
        n, f = self.cfg.n, self.cfg.f
        half = (n + 1) // 2
        k = n - f - 1
        c0 = np.empty(n, dtype=np.int32)
        c1 = np.empty(n, dtype=np.int32)
        for v in range(n):
            h = 0 if v < half else 1
            vals = vals_by_class[h]
            rem = [0, 0, 0]
            for u in range(n):
                if u != v and not silent[u] \
                        and (fside is None or fside[u] == fside[v]):
                    rem[int(vals[u])] += 1
            drops = max(0, sum(rem) - k)
            # biased(w, h) per spec §4b / §6.4b.
            if strata == "class":
                st = [h != 0, h != 1, True]
            elif strata == "minority":
                st = [minority != 0, minority != 1, True]
            else:
                st = [False, False, False]
            s = int(prf.prf_u32(self.seed, self.instance, rnd, t,
                                v, 0, prf.URN,
                                pack=self._pack))
            for _ in range(drops):
                s = (s * prf.URN_LCG_A + prf.URN_LCG_C) & 0xFFFFFFFF
                u32 = s ^ (s >> 16)
                b_rem = sum(rem[w] for w in range(3) if st[w])
                in_biased = b_rem > 0
                r_cur = b_rem if in_biased else sum(rem) - b_rem
                d = ((u32 >> self._rs) * r_cur) >> self._rd
                e = [rem[w] if st[w] == in_biased else 0 for w in range(3)]
                w = 0 if d < e[0] else (1 if d < e[0] + e[1] else 2)
                rem[w] -= 1
            own = int(vals[v])
            c0[v] = rem[0] + (1 if own == 0 else 0)
            c1[v] = rem[1] + (1 if own == 1 else 0)
        return c0, c1

    def urn2_counts(self, rnd: int, t: int, vals_by_class, silent: np.ndarray,
                    strata: str = "none", minority: int = 0, fside=None):
        """Per-receiver delivered counts (c0, c1) via the §4b-v2 inversion.

        Same class/stratum semantics as :meth:`urn_counts`; the dropped-count
        vector is sampled directly as nested hypergeometrics via the
        corner-minimal conditional-Bernoulli chains of spec §4b-v2. Scalar
        python-int implementation, independent of ops/urn2.py.
        """
        n, f = self.cfg.n, self.cfg.f
        half = (n + 1) // 2
        k = n - f - 1
        c0 = np.empty(n, dtype=np.int32)
        c1 = np.empty(n, dtype=np.int32)
        for v in range(n):
            h = 0 if v < half else 1
            vals = vals_by_class[h]
            m = [0, 0, 0]
            for u in range(n):
                if u != v and not silent[u] \
                        and (fside is None or fside[u] == fside[v]):
                    m[int(vals[u])] += 1
            L = sum(m)
            D = max(0, L - k)
            if strata == "class":
                st = [h != 0, h != 1, True]
            elif strata == "minority":
                st = [minority != 0, minority != 1, True]
            else:
                st = [False, False, False]

            def chain(seg: int, mm: int, Lr: int, Dr: int) -> int:
                """d ~ HG(Lr, mm, Dr), corner-minimal chain (spec §4b-v2)."""
                comp = Lr - mm
                if mm <= comp and mm <= Dr:
                    is_comp, K, P = False, mm, Dr      # ITEM
                elif Dr <= comp:
                    is_comp, K, P = False, Dr, mm      # DRAW
                else:
                    is_comp, K, P = True, comp, Dr     # COMP
                s = int(prf.prf_u32(self.seed, self.instance, rnd, t,
                                    v, seg, prf.URN2,
                                    pack=self._pack))
                a = 0
                for j in range(K):
                    s = (s * prf.URN_LCG_A + prf.URN_LCG_C) & 0xFFFFFFFF
                    u32 = s ^ (s >> 16)
                    q = ((u32 >> self._rs) * (Lr - j)) >> self._rd
                    if q < P - a:
                        a += 1
                return (Dr - a) if is_comp else a

            d = [0, 0]
            mb = [m[w] if st[w] else 0 for w in range(3)]
            Lb = sum(mb)
            Db = min(D, Lb)
            Lr, Dr = Lb, Db
            for w in (0, 1):                 # segments 0-1: biased stratum
                dw = chain(w, mb[w], Lr, Dr)
                d[w] += dw
                Lr -= mb[w]
                Dr -= dw
            Lr, Dr = L - Lb, D - Db
            for w in (0, 1):                 # segments 2-3: unbiased stratum
                mu = m[w] - mb[w]
                dw = chain(2 + w, mu, Lr, Dr)
                d[w] += dw
                Lr -= mu
                Dr -= dw
            own = int(vals[v])
            c0[v] = m[0] - d[0] + (1 if own == 0 else 0)
            c1[v] = m[1] - d[1] + (1 if own == 1 else 0)
        return c0, c1

    def committee_counts(self, rnd: int, t: int, vals_by_class,
                         silent: np.ndarray, strata: str = "none",
                         minority: int = 0, fside=None):
        """Per-receiver delivered counts (c0, c1) via the §10.2 committee law.

        ``silent`` arrives with the membership silence already folded in
        (spec §10.4 composition order), so the class counts ``m`` range over
        live committee senders only. Same class/stratum semantics as
        :meth:`urn3_counts` and the same §4c cheap split — but the drop
        quota is the committee k_C = C − f_C − 1 (spec §10.3), the nibble
        word is the COMMITTEE send=1 sub-address, and a receiver's own
        message is delivered iff the receiver is itself a committee member
        this step (send=0 word — non-members do not broadcast). Scalar
        python-int implementation, independent of ops/committee.py: the
        integer committee laws use bit_length()/math.isqrt here vs the
        static compare-sums of the vectorized path.
        """
        n, f = self.cfg.n, self.cfg.f
        half = (n + 1) // 2
        cn = min(n, max(16, 8 * (n - 1).bit_length()))     # C(n), spec §10.1
        fc = f if cn == n else (cn * f + n - 1) // n + math.isqrt(cn)
        k = cn - fc - 1                                     # k_C, spec §10.3
        c0 = np.empty(n, dtype=np.int32)
        c1 = np.empty(n, dtype=np.int32)
        for v in range(n):
            h = 0 if v < half else 1
            vals = vals_by_class[h]
            m = [0, 0, 0]
            for u in range(n):
                if u != v and not silent[u] \
                        and (fside is None or fside[u] == fside[v]):
                    m[int(vals[u])] += 1
            L = sum(m)
            D = max(0, L - k)
            if strata == "class":
                st = [h != 0, h != 1, True]
            elif strata == "minority":
                st = [minority != 0, minority != 1, True]
            else:
                st = [False, False, False]
            word = int(prf.prf_u32(self.seed, self.instance, rnd, t,
                                   v, 1, prf.COMMITTEE,
                                   pack=self._pack))
            mw = int(prf.prf_u32(self.seed, self.instance, rnd, t,
                                 v, 0, prf.COMMITTEE,
                                 pack=self._pack))
            member = (mw % n) < cn                          # spec §10.1

            def cheap(seg: int, mm: int, Lr: int, Dr: int) -> int:
                nib = (word >> (8 * seg)) & 0xF
                corr = bin(nib).count("1") - 2
                den = max(Lr, 1)
                base = (2 * Dr * mm + den) // (2 * den)
                lo = max(0, Dr - (Lr - mm))
                hi = min(mm, Dr)
                return min(max(base + corr, lo), hi)

            d = [0, 0]
            mb = [m[w] if st[w] else 0 for w in range(3)]
            Lb = sum(mb)
            Db = min(D, Lb)
            Lr, Dr = Lb, Db
            for w in (0, 1):                 # segments 0-1: biased stratum
                dw = cheap(w, mb[w], Lr, Dr)
                d[w] += dw
                Lr -= mb[w]
                Dr -= dw
            Lr, Dr = L - Lb, D - Db
            for w in (0, 1):                 # segments 2-3: unbiased stratum
                mu = m[w] - mb[w]
                dw = cheap(2 + w, mu, Lr, Dr)
                d[w] += dw
                Lr -= mu
                Dr -= dw
            own = int(vals[v])
            c0[v] = m[0] - d[0] + (1 if member and own == 0 else 0)
            c1[v] = m[1] - d[1] + (1 if member and own == 1 else 0)
        return c0, c1

    def urn3_counts(self, rnd: int, t: int, vals_by_class, silent: np.ndarray,
                    strata: str = "none", minority: int = 0, fside=None):
        """Per-receiver delivered counts (c0, c1) via the §4c cheap law.

        Same class/stratum semantics as :meth:`urn_counts`, same deterministic
        stratum split as :meth:`urn2_counts` — but the within-stratum class
        split is the spec §4c mode-anchored bounded-correction law, not a
        hypergeometric: d = clamp(round(Dr·m/Lr) + (popcount(nibble) − 2),
        HG support), one PRF word per receiver-step, segment ``g`` owning
        nibble bits [8g, 8g+4). Scalar python-int implementation, independent
        of ops/urn3.py.
        """
        n, f = self.cfg.n, self.cfg.f
        half = (n + 1) // 2
        k = n - f - 1
        c0 = np.empty(n, dtype=np.int32)
        c1 = np.empty(n, dtype=np.int32)
        for v in range(n):
            h = 0 if v < half else 1
            vals = vals_by_class[h]
            m = [0, 0, 0]
            for u in range(n):
                if u != v and not silent[u] \
                        and (fside is None or fside[u] == fside[v]):
                    m[int(vals[u])] += 1
            L = sum(m)
            D = max(0, L - k)
            if strata == "class":
                st = [h != 0, h != 1, True]
            elif strata == "minority":
                st = [minority != 0, minority != 1, True]
            else:
                st = [False, False, False]
            word = int(prf.prf_u32(self.seed, self.instance, rnd, t,
                                   v, 0, prf.URN3,
                                   pack=self._pack))

            def cheap(seg: int, mm: int, Lr: int, Dr: int) -> int:
                nib = (word >> (8 * seg)) & 0xF
                corr = bin(nib).count("1") - 2
                den = max(Lr, 1)
                base = (2 * Dr * mm + den) // (2 * den)
                lo = max(0, Dr - (Lr - mm))
                hi = min(mm, Dr)
                return min(max(base + corr, lo), hi)

            d = [0, 0]
            mb = [m[w] if st[w] else 0 for w in range(3)]
            Lb = sum(mb)
            Db = min(D, Lb)
            Lr, Dr = Lb, Db
            for w in (0, 1):                 # segments 0-1: biased stratum
                dw = cheap(w, mb[w], Lr, Dr)
                d[w] += dw
                Lr -= mb[w]
                Dr -= dw
            Lr, Dr = L - Lb, D - Db
            for w in (0, 1):                 # segments 2-3: unbiased stratum
                mu = m[w] - mb[w]
                dw = cheap(2 + w, mu, Lr, Dr)
                d[w] += dw
                Lr -= mu
                Dr -= dw
            own = int(vals[v])
            c0[v] = m[0] - d[0] + (1 if own == 0 else 0)
            c1[v] = m[1] - d[1] + (1 if own == 1 else 0)
        return c0, c1
