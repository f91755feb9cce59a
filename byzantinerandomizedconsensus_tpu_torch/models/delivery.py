"""Delivery-count dispatch of the round body, in torch.

The port's counterpart of the reference ``models/delivery.py::make_counts``.
One closure decides, per step, which delivery and tally implementation runs:
a caller-supplied ``counts_fn`` (the per-step CUDA kernels,
``ops/keys_step.py`` and ``ops/urn_step.py``), the registered count-level
sampler (§4b ``urn``, §4b-v2 ``urn2``, §4c ``urn3``, §10 ``committee``), or
the spec-§4 keys law (masks and tally, chunked:
``ops/keys_step.py::step_counts_plain``). The §9 partition cut reaches the delivery law
here: the count-level samplers take the side plane ``fside``, and so does
the keys law, which builds its per-(recv, send) cut chunk by chunk.
"""

from __future__ import annotations

from byzantinerandomizedconsensus_tpu_torch.models.committee import check_committee_supported
from byzantinerandomizedconsensus_tpu_torch.models.faults import check_faults_supported
from byzantinerandomizedconsensus_tpu_torch.obs.counters import (
    CountersUnsupported, real_receivers, step_stats)
from byzantinerandomizedconsensus_tpu_torch.ops import committee, keys_step, urn, urn2, urn3

_COUNTS_FNS = {"urn": urn.counts_fn, "urn2": urn2.counts_fn, "urn3": urn3.counts_fn,
               "committee": committee.counts_fn}
DELIVERIES = ("keys",) + tuple(_COUNTS_FNS)


def make_counts(cfg, seed, inst_ids, rnd, setup, counts_fn=None, stats=None,
                fside=None, recv_ids=None, obs=None, fsil=None):
    """Build the ``counts(t, honest, values, silent, bias, need=None) ->
    (c0, c1)`` closure a round body calls once per broadcast step.
    ``stats``, when a dict, collects the count-level sampler's cost counters
    over the receivers ``need`` whose counts are read (default all); a
    custom ``counts_fn`` has none. ``fside`` is the round's §9 partition
    side plane (``models/faults.py::round_masks``; the fault silences reach
    the law through ``silent``); the per-step kernels have no fault
    channel, so a ``counts_fn`` under a fault schedule raises
    :class:`~models.faults.FaultsUnsupported`, and no committee channel
    (:class:`~models.committee.CommitteeUnsupported`). ``recv_ids`` (global
    indices, a replica shard of the sharded path) makes the counts (B, R)
    over those receivers; a ``counts_fn`` is given it as a keyword only
    then, so a hook without the argument runs the full width.

    ``obs``, when a dict, receives per-step entries ``obs[t] = {"c0", "c1",
    "silent", "stats", "fsil", "fside"}`` for ``obs/counters.py``: a pure
    side channel the step math never reads. ``stats`` there holds the
    sampler counters under the reference's laws, counted over every
    receiver (:func:`obs.counters.step_stats`); ``fsil`` is the round's §9
    fault-silence plane. The kernels have no side channel, so ``obs`` with
    a ``counts_fn`` raises :class:`~obs.counters.CountersUnsupported`, and
    ``obs`` takes the sampler's counters in place of ``stats``."""
    if cfg.delivery not in DELIVERIES:
        raise NotImplementedError(
            f"delivery={cfg.delivery!r} is not ported yet; the port runs "
            f"delivery in {DELIVERIES}")
    if counts_fn is not None:
        check_faults_supported(cfg, "the per-step delivery kernels")
        check_committee_supported(cfg, "the per-step delivery kernels")

    if obs is not None:
        if counts_fn is not None:
            raise CountersUnsupported(
                "the per-step delivery kernels have no counter side channel; "
                "protocol counters run on kernel='plain'")
        if stats is not None:
            raise ValueError("obs= takes the sampler's counters; pass stats=None")

    shard = {} if recv_ids is None else {"recv_ids": recv_ids}

    def law_counts(t, honest, values, silent, bias, need, law_stats):
        if counts_fn is not None:
            return counts_fn(cfg, seed, inst_ids, rnd, t, values, silent,
                             setup["faulty"], honest, **shard)
        if cfg.count_level:
            return _COUNTS_FNS[cfg.delivery](cfg, seed, inst_ids, rnd, t, values,
                                             silent, setup["faulty"], honest,
                                             stats=law_stats, stats_lanes=need,
                                             fside=fside, recv_ids=recv_ids)
        return keys_step.step_counts_plain(cfg, seed, inst_ids, rnd, t, values,
                                           silent, setup["faulty"], bias,
                                           fside=fside, recv_ids=recv_ids)

    def counts(t, honest, values, silent, bias, need=None):
        if obs is None:
            return law_counts(t, honest, values, silent, bias, need, stats)
        law_stats = {}
        # A padded lane row counts its real receivers only.
        real = real_receivers(cfg, values.shape[-1], values.device)
        c0, c1 = law_counts(t, honest, values, silent, bias, real, law_stats)
        obs[t] = {"c0": c0, "c1": c1, "silent": silent, "fsil": fsil, "fside": fside,
                  "stats": step_stats(cfg, seed, inst_ids, rnd, t, c0.shape[-1],
                                      law_stats)}
        return c0, c1

    return counts
