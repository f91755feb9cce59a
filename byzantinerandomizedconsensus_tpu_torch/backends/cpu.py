"""CPU oracle backend, registered as ``cpu`` — an arbiter of the bit-match.

The port's copy of the reference ``backends/cpu.py``: a per-instance,
per-replica object loop over the oracle (``core/``: Replica, Network,
Adversary, FaultSchedule). Correctness first and independent of the
vectorized torch model layer: the torch backend, on the card or on the CPU,
must bit-match it (``cli bitmatch --arbiter cpu``). It is never the default
of ``run`` or ``sweep``.
"""

from __future__ import annotations

import math

from typing import Optional

import numpy as np

from byzantinerandomizedconsensus_tpu_torch.backends.base import SimResult, SimulatorBackend
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.core.adversary import make_adversary
from byzantinerandomizedconsensus_tpu_torch.core.network import Network
from byzantinerandomizedconsensus_tpu_torch.core.replica import Replica
from byzantinerandomizedconsensus_tpu_torch.core import prf


def _committee_nf(n: int, f: int):
    """Oracle-side (C, f_C) — spec §10.1/§10.3. Independent of
    ops/committee.py: bit_length()/math.isqrt vs the static compare-sums."""
    cn = min(n, max(16, 8 * (n - 1).bit_length()))
    fc = f if cn == n else (cn * f + n - 1) // n + math.isqrt(cn)
    return cn, fc


class CpuBackend(SimulatorBackend):
    name = "cpu"

    def run(self, cfg: SimConfig, inst_ids: Optional[np.ndarray] = None) -> SimResult:
        cfg = cfg.validate()
        ids = self._resolve_inst_ids(cfg, inst_ids)
        rounds = np.empty(len(ids), dtype=np.int32)
        decision = np.empty(len(ids), dtype=np.uint8)
        for k, i in enumerate(ids):
            rounds[k], decision[k] = self._run_instance(cfg, int(i))
        return SimResult(config=cfg, inst_ids=ids, rounds=rounds, decision=decision)

    def run_with_counters(self, cfg: SimConfig,
                          inst_ids: Optional[np.ndarray] = None):
        """``run`` plus the message-level protocol-counter subset
        (obs/counters.py): delivered/dropped per phase, coin flips, rounds.

        Counted with independent scalar arithmetic straight off the oracle's
        own per-receiver counts — this is the anchor the vectorized stacks'
        totals are cross-checked against at small n. The sampler-owned cost
        counters (chain trips etc.) are kernel internals of the vectorized
        implementations and are deliberately absent here.
        """
        from byzantinerandomizedconsensus_tpu_torch.obs import counters as _counters

        cfg = cfg.validate()
        ids = self._resolve_inst_ids(cfg, inst_ids)
        rounds = np.empty(len(ids), dtype=np.int32)
        decision = np.empty(len(ids), dtype=np.uint8)
        totals: dict = {}
        for k, i in enumerate(ids):
            rounds[k], decision[k] = self._run_instance(cfg, int(i),
                                                        collect=totals)
        names = [n for n in _counters.counter_names(cfg)
                 if n.split("@")[0] in ("delivered0", "delivered1", "dropped",
                                        "fault_silenced", "fault_cut_pairs")
                 or n in ("coin_flips", "rounds_active")]
        totals = {n: totals.get(n, 0) for n in names}
        res = SimResult(config=cfg, inst_ids=ids, rounds=rounds,
                        decision=decision)
        return res, _counters.counters_doc(cfg, totals, backend=self.name)

    @staticmethod
    def _invalid(cfg: SimConfig, t: int, values: np.ndarray, g_prev,
                 nf=None) -> np.ndarray:
        """Per-sender invalidity per spec §5.1b, from the previous step's global
        live-valid counts (g0, g1). Independent scalar re-implementation of
        models/validation.py for the oracle cross-check. ``nf`` overrides the
        (n, f) pair the intervals derive from — the committee path passes
        (C, f_C) so validity matches the committee-scoped G counts (§10.3)."""
        n, f = nf if nf is not None else (cfg.n, cfg.f)
        q = n - f
        g0, g1 = g_prev
        if t == 1:
            ok = {1: g1 >= (q + 1) // 2, 0: g0 >= q // 2 + 1, 2: True}
        else:
            lo = max(0, q - g0, q - n // 2)
            hi = min(g1, q, n // 2)
            ok = {1: g1 >= n // 2 + 1, 0: g0 >= n // 2 + 1, 2: lo <= hi}
        return np.array([not ok[int(v)] for v in values], dtype=bool)

    @staticmethod
    def _initial_estimates(cfg: SimConfig, instance: int) -> np.ndarray:
        replica = np.arange(cfg.n, dtype=np.uint32)
        if cfg.init == "all0":
            return np.zeros(cfg.n, dtype=np.uint8)
        if cfg.init == "all1":
            return np.ones(cfg.n, dtype=np.uint8)
        if cfg.init == "split":
            return (replica & 1).astype(np.uint8)
        return prf.prf_bit(cfg.seed, instance, 0, 0, replica, 0, prf.INIT_EST, pack=cfg.pack_version).astype(np.uint8)

    def _run_instance(self, cfg: SimConfig, instance: int, collect=None):
        est0 = self._initial_estimates(cfg, instance)
        replicas = [Replica(cfg, j, est0[j]) for j in range(cfg.n)]
        net = Network(cfg, cfg.seed, instance)
        adv = make_adversary(cfg, cfg.seed, instance)
        correct = [j for j in range(cfg.n) if not adv.faulty[j]]
        fs = None
        if cfg.faults != "none":
            from byzantinerandomizedconsensus_tpu_torch.core.faults import (
                FaultSchedule)

            fs = FaultSchedule(cfg, cfg.seed, instance)

        two_faced = cfg.count_level and cfg.adversary == "byzantine" \
            and cfg.protocol != "bracha"
        committee = cfg.delivery == "committee"
        cm_nf = _committee_nf(cfg.n, cfg.f) if committee else None

        if collect is not None:
            from byzantinerandomizedconsensus_tpu_torch.obs.counters import (
                phase_names)

            phases = phase_names(cfg)
            # Every delivery law waits for a quota of k live messages per
            # receiver: n−f−1 for the full mesh (spec §4), the committee
            # k_C = C − f_C − 1 under §10.2.
            k_quota = (cm_nf[0] - cm_nf[1] - 1) if committee \
                else cfg.n - cfg.f - 1

            def note(name: str, inc: int) -> None:
                collect[name] = collect.get(name, 0) + int(inc)

        for r in range(cfg.round_cap):
            g_prev = None  # global live-valid counts of the previous step (bracha)
            # Fault-schedule masks for this round (spec §9): silences join the
            # silent set before §5.1b validation; the partition side plane
            # applies only at the delivery law — same composition order as
            # the vectorized round bodies.
            fsil, fside = fs.round_masks(r) if fs is not None else (None, None)
            for t in range(cfg.steps_per_round):
                honest = np.array([rep.send_value(t) for rep in replicas], dtype=np.uint8)
                values, silent, bias = adv.inject(r, t, honest)
                if fsil is not None:
                    silent = silent | fsil
                if committee:
                    # spec §10.4 composition order: membership silence joins
                    # after the §9 fault silences, before §5.1b validation —
                    # non-members of this step's committee do not broadcast.
                    rep_ids = np.arange(cfg.n, dtype=np.uint32)
                    mw = prf.prf_u32(cfg.seed, instance, r, t, rep_ids, 0,
                                     prf.COMMITTEE,
                                     pack=cfg.pack_version)
                    silent = silent | ((mw % np.uint32(cfg.n))
                                       >= np.uint32(cm_nf[0]))
                if cfg.protocol == "bracha":
                    # spec §5.1b: invalid messages are silenced before delivery.
                    if t > 0:
                        silent = silent | self._invalid(cfg, t, values, g_prev,
                                                        nf=cm_nf)
                    live = ~silent
                    g_prev = (int(np.count_nonzero(live & (values == 0))),
                              int(np.count_nonzero(live & (values == 1))))
                if cfg.count_level:
                    if two_faced:
                        # §4b two-faced equivocation, independent of ops/urn.py.
                        send = np.arange(cfg.n, dtype=np.uint32)
                        vbc = []
                        for h in (0, 1):
                            # Sender-addressed: prf_sender puts the sender
                            # index in the wide field under §2 v3 (bit-
                            # identical at pack ≤ 2).
                            e = prf.prf_sender(cfg.seed, instance, r, t, h,
                                               send, prf.BYZ_VALUE,
                                               pack=cfg.pack_version)
                            vh = (e % np.uint32(3)).astype(np.uint8)
                            vbc.append(np.where(adv.faulty, vh, honest).astype(np.uint8))
                    else:
                        vbc = [values, values]
                    if cfg.adversary == "adaptive":
                        strata, minority = "class", 0
                    elif cfg.adversary == "adaptive_min":
                        strata = "minority"
                        minority = adv.observed_minority(honest)
                    else:
                        strata, minority = "none", 0
                    counts = {"urn": net.urn_counts, "urn2": net.urn2_counts,
                              "urn3": net.urn3_counts,
                              "committee": net.committee_counts}[cfg.delivery]
                    c0, c1 = counts(r, t, vbc, silent,
                                    strata=strata, minority=minority,
                                    fside=fside)
                    if collect is not None:
                        note(f"delivered0@{phases[t]}", c0.sum())
                        note(f"delivered1@{phases[t]}", c1.sum())
                    for rep in replicas:
                        rep.on_counts(t, int(c0[rep.index]), int(c1[rep.index]))
                else:
                    vmat, mask = net.deliver(r, t, values, silent, bias,
                                             fside=fside)
                    if collect is not None:
                        note(f"delivered0@{phases[t]}", (mask & (vmat == 0)).sum())
                        note(f"delivered1@{phases[t]}", (mask & (vmat == 1)).sum())
                    for rep in replicas:
                        rep.on_deliver(t, vmat[rep.index], mask[rep.index])
                if collect is not None:
                    # Every delivery law drops exactly max(0, L_v − (n−f−1))
                    # live messages per receiver (spec §4) — same scalar
                    # formula obs/counters.round_increments vectorizes. Under
                    # a §9 partition, L_v counts only same-side live senders.
                    live = ~silent
                    if fside is None:
                        live_tot = np.full(cfg.n, np.count_nonzero(live))
                    else:
                        live_tot = np.array(
                            [np.count_nonzero(live & (fside == fside[v]))
                             for v in range(cfg.n)])
                    note(f"dropped@{phases[t]}",
                         sum(max(0, int(live_tot[v])
                                 - (0 if silent[v] else 1) - k_quota)
                             for v in range(cfg.n)))
                    if cfg.faults != "none":
                        # Schema-v2 fault attribution (obs/counters.py):
                        # schedule-silenced senders, and live cross-cut pairs.
                        note(f"fault_silenced@{phases[t]}",
                             0 if fsil is None else int(fsil.sum()))
                        cut = 0
                        if fside is not None:
                            for v in range(cfg.n):
                                cut += int(np.count_nonzero(
                                    live & (fside != fside[v])))
                        note(f"fault_cut_pairs@{phases[t]}", cut)
            if cfg.coin == "shared":
                shared = int(prf.prf_bit(cfg.seed, instance, r, prf.COIN_STEP, 0, 0,
                                         prf.SHARED_COIN,
                                         pack=cfg.pack_version))
                coin = [shared] * cfg.n
            else:
                replica = np.arange(cfg.n, dtype=np.uint32)
                coin = prf.prf_bit(cfg.seed, instance, r, prf.COIN_STEP, replica, 0,
                                   prf.LOCAL_COIN, pack=cfg.pack_version)
            for rep in replicas:
                rep.end_round(int(coin[rep.index]))
            if collect is not None:
                note("coin_flips", cfg.n if cfg.coin == "local" else 1)
                note("rounds_active", 1)
            if all(replicas[j].decided for j in correct):
                # Always-on Agreement invariant: the result
                # surface reports correct[0]'s value, which would mask a
                # disagreement among higher-indexed correct replicas — so the
                # oracle checks ALL of them before returning. Every
                # oracle-anchored run (bitmatch --arbiter cpu) is thereby
                # an agreement check.
                vals = {replicas[j].decided_val for j in correct}
                if len(vals) != 1:
                    raise AssertionError(
                        f"Agreement violation: correct replicas decided {sorted(vals)} "
                        f"(instance={instance}, cfg={cfg})")
                return r + 1, replicas[correct[0]].decided_val
        # Agreement binds any two correct deciders even when the instance
        # caps out with a partial decided set.
        vals = {replicas[j].decided_val for j in correct if replicas[j].decided}
        if len(vals) > 1:
            raise AssertionError(
                f"Agreement violation at round cap: correct replicas decided "
                f"{sorted(vals)} (instance={instance}, cfg={cfg})")
        return cfg.round_cap, 2
