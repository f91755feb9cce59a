"""Safety invariants over the full per-replica state (spec §1; §9 checker).

The port's copy of the reference ``models/invariants.py``. The result
surface (``SimResult.decision``) collapses an instance to the lowest-indexed
correct replica's value, which assumes Agreement; these checks read every
replica of the state the plain driver computed
(``TorchBackend.run_with_state``). Per instance:

- **Agreement** — all correct decided replicas share one decided value;
- **Validity** — unanimity forces the decision, over the correct replicas
  under a lying adversary (byzantine and the adaptive family) and over all
  replicas otherwise (a crash-faulty replica runs the honest machine on
  honest inputs, and Ben-Or Protocol A's validity is the all-processes
  statement);
- **Decision consistency** — the collapsed ``SimResult.decision`` equals the
  first correct replica's decided value (2 when the instance capped out).
"""

from __future__ import annotations

import numpy as np
import torch

from byzantinerandomizedconsensus_tpu_torch.models import state as state_mod


def state_violations(cfg, state, faulty, res=None, inst_ids=None, device="cpu") -> list:
    """Violation records over a (B, n) state dict of numpy arrays; empty =
    safe. ``faulty`` is the adversary's (B, n) mask (spec §3.2): a replica
    silenced only by a §9 fault schedule is correct and bound by Agreement
    and Validity. ``res``, when given, adds the decision-consistency check
    against its (B,) arrays.

    The reference's records, in its order (by instance: agreement,
    validity, decision consistency), from whole-array predicates over B:
    only the instances that break one are visited one by one. The initial
    estimates (the validity basis) are drawn on ``device``."""
    decided = np.asarray(state["decided"], dtype=bool)
    dval = np.asarray(state["decided_val"])
    correct = ~np.asarray(faulty, dtype=bool)
    B = decided.shape[0]
    if inst_ids is None:
        inst_ids = np.arange(B)
    ids = torch.as_tensor(np.asarray(inst_ids, dtype=np.int64), device=device)
    est0 = state_mod.init_est(cfg, cfg.seed, ids).cpu().numpy()

    cd = correct & decided
    values = np.unique(dval[cd])
    held = np.stack([(cd & (dval == v)).any(axis=1) for v in values], axis=1) \
        if len(values) else np.zeros((B, 0), dtype=bool)
    agreement = held.sum(axis=1) > 1
    # Validity: the basis is every replica, or the correct ones under a
    # lying adversary; unanimous when it is non-empty and holds one value.
    basis = correct if cfg.lying_adversary else np.ones_like(correct)
    has0 = (basis & (est0 == 0)).any(axis=1)
    has1 = (basis & (est0 != 0)).any(axis=1)
    unanimous = has0 ^ has1
    init = est0[np.arange(B), np.argmax(basis, axis=1)] if B else est0[:, 0]
    validity = unanimous & (cd & (dval != init[:, None])).any(axis=1)
    consistency = np.zeros(B, dtype=bool)
    if res is not None:
        done = (cd.sum(axis=1) == correct.sum(axis=1)) & correct.any(axis=1)
        want = dval[np.arange(B), np.argmax(correct, axis=1)] if B else dval[:, 0]
        got = np.asarray(res.decision)
        consistency = done & (np.asarray(res.rounds) < cfg.round_cap) & (got != want)

    out = []
    for i in np.flatnonzero(agreement | validity | consistency):
        inst = int(inst_ids[i])
        vals = [int(v) for v, h in zip(values, held[i]) if h]
        if agreement[i]:
            out.append({"instance": inst, "kind": "agreement",
                        "decided_values": vals})
        if validity[i]:
            out.append({"instance": inst, "kind": "validity",
                        "unanimous_init": int(init[i]),
                        "decided_values": vals})
        if consistency[i]:
            out.append({"instance": inst, "kind": "decision_consistency",
                        "expected": int(want[i]), "got": int(got[i])})
    return out


def check_config(cfg, backend="torch", inst_ids=None, device="cuda") -> dict:
    """Run ``cfg`` with its full state and check the safety invariants;
    returns ``{"checked_instances", "violations"}``. The backend is pinned
    to one with ``run_with_state``: ``torch`` on ``kernel="plain"``, on
    ``device`` (the card unless the caller asks for the CPU)."""
    from byzantinerandomizedconsensus_tpu_torch.backends import get_backend

    be = get_backend(backend, device=device, kernel="plain")
    res, state, faulty = be.run_with_state(cfg, inst_ids)
    return {
        "checked_instances": int(len(res.inst_ids)),
        "violations": state_violations(cfg, state, faulty, res=res,
                                       inst_ids=res.inst_ids),
    }
