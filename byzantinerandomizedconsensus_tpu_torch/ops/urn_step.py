"""The urn step: one broadcast step's delivered counts under the spec §4b urn
law.

Counterpart of the reference ``ops/pallas_urn.py`` (the TPU kernel
``step_counts``). Two implementations of one function
``(cfg, seed, inst_ids, rnd, step, values, silent, faulty, honest) ->
(c0, c1)``, two (B, n) int32:

- :func:`step_counts` launches the hand-written CUDA kernel
  (``csrc/urn_step.cu``): one CTA per instance, one thread per receiver,
  each thread running its own drop draws (under the adaptive family only
  those of the biased stratum; the rest come from the preferred class in
  closed form). It takes CUDA tensors; given CPU
  tensors it runs the plain version, because there is no kernel to run
  there.
- :func:`step_counts_plain` is ``ops/urn.py::counts_fn``.

:func:`counts_fn` is the round body's delivery hook. The surface is
:data:`ops._step.STEP_SUPPORTED`; anything else raises
:class:`ops._step.StepUnsupported`.
"""

from __future__ import annotations

import torch

from byzantinerandomizedconsensus_tpu_torch.ops import _step, urn

#: Launches of the CUDA kernel since the count was last set to 0.
launches = 0

#: The plain version: ``ops/urn.py::counts_fn`` (``stats`` gains ``urn_draws``).
step_counts_plain = urn.counts_fn


def counts_fn(cfg, seed, inst_ids, rnd, t, values, silent, faulty, honest):
    """The round body's delivery hook (models/delivery.py)."""
    return step_counts(cfg, seed, inst_ids, rnd, t, values, silent, faulty, honest)


def step_counts(cfg, seed, inst_ids: torch.Tensor, rnd: int, step: int,
                values: torch.Tensor, silent: torch.Tensor, faulty: torch.Tensor,
                honest: torch.Tensor):
    """(c0, c1) for one broadcast step through the CUDA kernel; CPU tensors
    run :func:`step_counts_plain`. The kernel takes adaptive_min's minority
    from the non-faulty wire values, which are the honest ones, so it does
    not read ``honest``."""
    global launches
    _step.check_step_supported(cfg)
    if inst_ids.device.type == "cpu":
        return step_counts_plain(cfg, seed, inst_ids, rnd, step, values, silent,
                                 faulty, honest)
    out = _step.launch("urn_step", cfg, seed, inst_ids, rnd, step, values,
                       silent, faulty)
    launches += 1
    return out
