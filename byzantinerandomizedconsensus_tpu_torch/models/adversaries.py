"""Adversaries-as-data (spec/PROTOCOL.md §6), in torch.

The port has the benign adversary only: no faulty replicas, no silences, the
honest values on the wire. Every other adversary raises by name.
"""

from __future__ import annotations

import torch


class AdversaryModel:
    """Static dispatch on ``cfg.adversary``; holds only the config."""

    def __init__(self, cfg):
        if cfg.adversary != "none":
            raise NotImplementedError(
                f"adversary={cfg.adversary!r} is not ported yet; the port "
                "runs adversary='none' only")
        self.cfg = cfg

    def setup(self, seed, inst_ids: torch.Tensor) -> dict:
        shape = (inst_ids.shape[0], self.cfg.n)
        dev = inst_ids.device
        return {"faulty": torch.zeros(shape, dtype=torch.bool, device=dev),
                "crash_round": torch.zeros(shape, dtype=torch.int32, device=dev),
                "faults": None}

    def inject(self, seed, inst_ids, rnd, t, honest_values: torch.Tensor, setup):
        """One step's ``(values, silent)``: the honest values, nobody silent."""
        return honest_values, torch.zeros(honest_values.shape, dtype=torch.bool,
                                          device=honest_values.device)
