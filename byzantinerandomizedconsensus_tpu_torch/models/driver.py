"""The per-step round driver.

:func:`run_chunk` is the port's counterpart of the reference's
``backends/jax_backend.py::_run_chunk``: a loop of the protocol's round body
(:func:`models.benor.round_body` or :func:`models.bracha.round_body`) over
the whole chunk until every instance has decided or the round cap is
reached. ``counts_fn`` is the delivery hook
of the round body: ``None`` runs each delivery law's plain torch version,
``ops.keys_step.counts_fn`` or ``ops.urn_step.counts_fn`` the CUDA kernels,
one launch per broadcast step.
"""

from __future__ import annotations

import torch

from byzantinerandomizedconsensus_tpu_torch.models import benor, bracha
from byzantinerandomizedconsensus_tpu_torch.models import state as state_mod
from byzantinerandomizedconsensus_tpu_torch.models.adversaries import AdversaryModel
from byzantinerandomizedconsensus_tpu_torch.ops import prf


def run_chunk(cfg, inst_ids: torch.Tensor, key=None, counts_fn=None, stats=None):
    """Simulate one chunk; returns ``(rounds (B,) int32, decision (B,) uint8)``
    on ``inst_ids.device``.

    ``key`` is the PRF seed or ``(k0, k1)`` key (default ``cfg.seed``).
    ``stats``, when a dict, receives the work the run needed, counted over
    the instances still running in each round: ``instance_rounds``,
    ``coin_words`` (the coin's PRF words for the replicas that take it) and
    the sampler's own counters (``ops/urn2.py``, ``ops/urn.py``).
    """
    seed = cfg.seed if key is None else prf.seed_key(key)
    adv = AdversaryModel(cfg)
    round_body = benor.round_body if cfg.protocol == "benor" else bracha.round_body
    setup = adv.setup(seed, inst_ids)
    faulty = setup["faulty"]
    st = state_mod.init_state(cfg, seed, inst_ids)
    done_at = torch.full(inst_ids.shape, -1, dtype=torch.int32,
                         device=inst_ids.device)
    r = 0
    while r < cfg.round_cap and not bool((done_at >= 0).all()):
        running = done_at < 0
        round_stats = {} if stats is not None else None
        st = round_body(cfg, seed, inst_ids, r, st, adv, setup,
                               counts_fn=counts_fn, stats=round_stats)
        if stats is not None:
            round_stats["instance_rounds"] = torch.ones_like(running, dtype=torch.int64)
            for k, v in round_stats.items():
                stats[k] = stats.get(k, 0) + int((v * running).sum())
        done_now = state_mod.all_correct_decided(st, faulty)
        done_at = torch.where(running & done_now,
                              torch.full_like(done_at, r + 1), done_at)
        r += 1
    done = done_at >= 0
    rounds = torch.where(done, done_at, torch.full_like(done_at, cfg.round_cap))
    decision = state_mod.extract_decision(st, faulty, done)
    return rounds, decision
