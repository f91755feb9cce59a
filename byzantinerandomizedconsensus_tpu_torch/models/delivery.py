"""Delivery-count dispatch of the round body, in torch.

The port's counterpart of the reference ``models/delivery.py::make_counts``,
count-level branch only: each broadcast step's ``(c0, c1)`` comes from the
registered count-level sampler. The port has §4b-v2 (``urn2``); every other
delivery law raises by name.
"""

from __future__ import annotations

from byzantinerandomizedconsensus_tpu_torch.ops import urn2

_COUNTS_FNS = {"urn2": urn2.counts_fn}


def make_counts(cfg, seed, inst_ids, rnd, stats=None):
    """Build the ``counts(t, values, silent) -> (c0, c1)`` closure a round
    body calls once per broadcast step. ``stats``, when a dict, collects the
    sampler's cost counters (see :func:`urn2.counts_fn`)."""
    if cfg.delivery not in _COUNTS_FNS:
        raise NotImplementedError(
            f"delivery={cfg.delivery!r} is not ported yet; the port runs "
            f"delivery in {tuple(_COUNTS_FNS)}")
    fn = _COUNTS_FNS[cfg.delivery]

    def counts(t, values, silent):
        return fn(cfg, seed, inst_ids, rnd, t, values, silent, stats=stats)

    return counts
