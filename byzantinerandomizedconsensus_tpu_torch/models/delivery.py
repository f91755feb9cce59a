"""Delivery-count dispatch of the round body, in torch.

The port's counterpart of the reference ``models/delivery.py::make_counts``.
One closure decides, per step, which delivery and tally implementation runs:
a caller-supplied ``counts_fn`` (the per-step CUDA kernels,
``ops/keys_step.py`` and ``ops/urn_step.py``), the registered count-level
sampler (§4b ``urn``, §4b-v2 ``urn2``), or the spec-§4 keys law (masks and
tally, chunked: ``ops/keys_step.py::step_counts_plain``). Every other
delivery law raises by name.
"""

from __future__ import annotations

from byzantinerandomizedconsensus_tpu_torch.ops import keys_step, urn, urn2

_COUNTS_FNS = {"urn": urn.counts_fn, "urn2": urn2.counts_fn}
DELIVERIES = ("keys",) + tuple(_COUNTS_FNS)


def make_counts(cfg, seed, inst_ids, rnd, setup, counts_fn=None, stats=None):
    """Build the ``counts(t, honest, values, silent, bias, need=None) ->
    (c0, c1)`` closure a round body calls once per broadcast step.
    ``stats``, when a dict, collects the count-level sampler's cost counters
    over the receivers ``need`` whose counts are read (default all); a
    custom ``counts_fn`` has none."""
    if cfg.delivery not in DELIVERIES:
        raise NotImplementedError(
            f"delivery={cfg.delivery!r} is not ported yet; the port runs "
            f"delivery in {DELIVERIES}")

    def counts(t, honest, values, silent, bias, need=None):
        if counts_fn is not None:
            return counts_fn(cfg, seed, inst_ids, rnd, t, values, silent,
                             setup["faulty"], honest)
        if cfg.count_level:
            return _COUNTS_FNS[cfg.delivery](cfg, seed, inst_ids, rnd, t, values,
                                             silent, setup["faulty"], honest,
                                             stats=stats, stats_lanes=need)
        return keys_step.step_counts_plain(cfg, seed, inst_ids, rnd, t, values,
                                           silent, setup["faulty"], bias)

    return counts
