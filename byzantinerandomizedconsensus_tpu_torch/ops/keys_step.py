"""The keys step: one broadcast step's delivered counts under the spec §4 keys
law.

Counterpart of the reference ``ops/pallas_tally.py`` (the TPU kernel
``step_counts``). Two implementations of one function
``(cfg, seed, inst_ids, rnd, step, values, silent, faulty) -> (c0, c1)``,
two (B, n) int32:

- :func:`step_counts` launches the hand-written CUDA kernel
  (``csrc/keys_step.cu``): class counts per instance first, then one warp
  per receiver row hashes only the class in which the n − f threshold falls
  and finds the threshold by a histogram on the PRF's top bits and an exact
  finish in its bin. It takes CUDA tensors; given CPU tensors it runs the
  plain version, because there is no kernel to run there.
- :func:`step_counts_plain` is the keys law in torch ops
  (``ops/masks.py`` and ``ops/tally.py``), a bounded number of key triples
  at a time. It is also the round body's default keys delivery
  (``models/delivery.py``), which passes the bias ``inject`` built; without
  one it recomputes the bias from the wire values, as the kernel does.

:func:`counts_fn` is the round body's delivery hook. The surface is
:data:`ops._step.STEP_SUPPORTED`; anything else raises
:class:`ops._step.StepUnsupported`.
"""

from __future__ import annotations

import torch

from byzantinerandomizedconsensus_tpu_torch.models.adversaries import scheduling_bias
from byzantinerandomizedconsensus_tpu_torch.ops import _step, masks, tally

#: (instance, receiver, sender) key triples the plain version holds at once:
#: about 100 bytes each across the int64 PRF temporaries, so 1.6 GB.
PLAIN_PAIRS = 1 << 24

#: Launches of the CUDA kernel since the count was last set to 0.
launches = 0


def counts_fn(cfg, seed, inst_ids, rnd, t, values, silent, faulty, honest):
    """The round body's delivery hook (models/delivery.py): the kernel
    recomputes the bias from the wire values, so ``honest`` is not read."""
    return step_counts(cfg, seed, inst_ids, rnd, t, values, silent, faulty)


def step_counts(cfg, seed, inst_ids: torch.Tensor, rnd: int, step: int,
                values: torch.Tensor, silent: torch.Tensor, faulty: torch.Tensor):
    """(c0, c1) for one broadcast step through the CUDA kernel; CPU tensors
    run :func:`step_counts_plain`."""
    global launches
    _step.check_step_supported(cfg)
    if inst_ids.device.type == "cpu":
        return step_counts_plain(cfg, seed, inst_ids, rnd, step, values, silent, faulty)
    out = _step.launch("keys_step", cfg, seed, inst_ids, rnd, step, values,
                       silent, faulty)
    launches += 1
    return out


def step_counts_plain(cfg, seed, inst_ids: torch.Tensor, rnd: int, step: int,
                      values: torch.Tensor, silent: torch.Tensor,
                      faulty: torch.Tensor, bias=None):
    """The keys law in torch ops, at most :data:`PLAIN_PAIRS` key triples
    at a time. ``bias`` is the (B, 1, n) or (B, R, n) scheduling bias of
    ``inject``; ``None`` computes it chunk by chunk with
    :func:`models.adversaries.scheduling_bias`."""
    per = max(1, PLAIN_PAIRS // (cfg.n * cfg.n))
    parts = []
    for lo in range(0, inst_ids.shape[0], per):
        hi = lo + per
        v = values[lo:hi]
        b = scheduling_bias(cfg, v, faulty[lo:hi]) if bias is None else bias[lo:hi]
        mask = masks.delivery_mask(cfg, seed, inst_ids[lo:hi], rnd, step,
                                   silent[lo:hi], b)
        parts.append(tally.tally01(mask, v))
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))
