"""Replicated-log sessions: the chained-slot seed law (spec §11).

The port's copy of the reference ``models/session.py``. A session is one
stream of ``L`` chained decision slots over one base config: slot 0 runs the
config as written, slot ``k+1`` the same config with the seed derived from
slot ``k``'s seed and decision vector (``ops/prf.py::session_chain_seed``).
Every slot is an ordinary run, so the whole log is a pure function of
``(seed, config, L)``; the compacted grid's in-place re-seeding
(``backends/compaction.py``) must reproduce :func:`run_session` bit for bit.
"""

from __future__ import annotations

import dataclasses

from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.ops import prf

#: Admitted slot-count ceiling (an admission layer validates against it):
#: bounds a single session's lane-round weight so the r18 deficit-weighted
#: fairness always sees a finite, known claim per envelope.
MAX_SESSION_SLOTS = 256


def next_slot_config(cfg: SimConfig, slot: int, decision) -> SimConfig:
    """Slot ``slot + 1``'s config: the base config with the spec-§11
    derived seed. ``decision`` is slot ``slot``'s per-instance decision
    vector in instance order (values 0/1/2)."""
    seed = prf.session_chain_seed(cfg.seed, slot, decision,
                                  pack=cfg.pack_version)
    return dataclasses.replace(cfg, seed=seed).validate()


def session_slot_configs(cfg: SimConfig, results) -> list:
    """The slot configs a finished session actually ran, re-derived from
    the base config and the per-slot decision vectors (``results`` is the
    slot-ordered list of decision vectors). Slot 0 is ``cfg`` itself."""
    out = [cfg]
    for k, dec in enumerate(results[:-1] if results else []):
        out.append(next_slot_config(out[-1], k, dec))
    return out


def run_session(backend, cfg: SimConfig, slots: int) -> list:
    """Run an ``slots``-slot session offline: the reference implementation
    of the spec-§11 chain (slot k+1's seed from slot k's decision), one
    ``backend.run`` per slot. Returns the slot-ordered SimResult list.

    This is the replay law: any serving-path session must be bit-identical
    to this function at the same (backend-independent) base seed.
    """
    if slots < 1:
        raise ValueError(f"slots={slots} out of range (>= 1)")
    out = []
    slot_cfg = cfg
    for k in range(slots):
        res = backend.run(slot_cfg)
        out.append(res)
        if k + 1 < slots:
            slot_cfg = next_slot_config(slot_cfg, k, res.decision)
    return out


def replay_matches(backend, cfg: SimConfig, served_slots) -> bool:
    """Bit-identity check of a served session against the offline replay:
    ``served_slots`` is the slot-ordered list of ``(rounds, decision)``
    int-list pairs a server streamed back. True iff every slot matches the
    :func:`run_session` replay from the base seed exactly."""
    ref = run_session(backend, cfg, len(served_slots))
    for (rounds, decision), r in zip(served_slots, ref):
        if rounds != [int(x) for x in r.rounds]:
            return False
        if decision != [int(x) for x in r.decision]:
            return False
    return True
