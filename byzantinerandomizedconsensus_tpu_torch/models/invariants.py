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


def state_violations(cfg, state, faulty, res=None, inst_ids=None) -> list:
    """Violation records over a (B, n) state dict of numpy arrays; empty =
    safe. ``faulty`` is the adversary's (B, n) mask (spec §3.2): a replica
    silenced only by a §9 fault schedule is correct and bound by Agreement
    and Validity. ``res``, when given, adds the decision-consistency check
    against its (B,) arrays."""
    decided = np.asarray(state["decided"])
    dval = np.asarray(state["decided_val"])
    correct = ~np.asarray(faulty)
    B = decided.shape[0]
    if inst_ids is None:
        inst_ids = np.arange(B)
    ids = torch.as_tensor(np.asarray(inst_ids, dtype=np.int64))
    est0 = state_mod.init_est(cfg, cfg.seed, ids).numpy()

    out = []
    for i in range(B):
        inst = int(inst_ids[i])
        cd = correct[i] & decided[i]
        vals = sorted(set(dval[i][cd].tolist()))
        if len(vals) > 1:
            out.append({"instance": inst, "kind": "agreement",
                        "decided_values": vals})
        ce = est0[i][correct[i]] if cfg.lying_adversary else est0[i]
        if len(ce) and (ce == ce[0]).all():
            v = int(ce[0])
            if any(int(x) != v for x in dval[i][cd]):
                out.append({"instance": inst, "kind": "validity",
                            "unanimous_init": v,
                            "decided_values": vals})
        if res is not None:
            done = bool(cd.sum() == correct[i].sum() and correct[i].any())
            want = int(dval[i][np.argmax(correct[i])]) if done \
                and int(res.rounds[i]) < cfg.round_cap else None
            got = int(res.decision[i])
            if want is not None and got != want:
                out.append({"instance": inst, "kind": "decision_consistency",
                            "expected": want, "got": got})
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
