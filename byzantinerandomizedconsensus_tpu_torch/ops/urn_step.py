"""The urn step: one broadcast step's delivered counts under the spec §4b urn
law.

Counterpart of the reference ``ops/pallas_urn.py`` (the TPU kernel
``step_counts``). Two implementations of one function
``(cfg, seed, inst_ids, rnd, step, values, silent, faulty, honest) ->
(c0, c1)``, two (B, n) int32:

- :func:`step_counts` launches the hand-written CUDA kernel
  (``csrc/urn_step.cu``): one CTA per instance, one thread per receiver (up
  to four past n = 1024), each thread running its own drop draws (under the
  adaptive family only those of the biased stratum; the rest come from the
  preferred class in closed form); under Ben-Or's Byzantine pairing the
  kernel draws the two class rows from the faulty plane. It takes CUDA
  tensors; given CPU tensors it runs the plain version, because there is no
  kernel to run there.
- :func:`step_counts_plain` is ``ops/urn.py::counts_fn``.

:func:`counts_fn` is the round body's delivery hook. The surface is
:data:`ops._step.STEP_SUPPORTED`; anything else raises
:class:`ops._step.StepUnsupported`.
"""

from __future__ import annotations

import threading

import torch

from byzantinerandomizedconsensus_tpu_torch.ops import _step, urn

#: Launches of the CUDA kernel since the count was last set to 0 (the
#: sharded path's shard threads add under :data:`_count_lock`).
launches = 0
_count_lock = threading.Lock()

#: The plain version: ``ops/urn.py::counts_fn`` (``stats`` gains its work counters).
step_counts_plain = urn.counts_fn


def counts_fn(cfg, seed, inst_ids, rnd, t, values, silent, faulty, honest,
              recv_ids=None):
    """The round body's delivery hook (models/delivery.py). ``recv_ids``, a
    contiguous receiver shard, maps to the kernel's receiver offset, as in
    the reference's adapter (``pallas_urn.py:202-207``)."""
    return step_counts(cfg, seed, inst_ids, rnd, t, values, silent, faulty, honest,
                       recv_ids)


def step_counts(cfg, seed, inst_ids: torch.Tensor, rnd: int, step: int,
                values: torch.Tensor, silent: torch.Tensor, faulty: torch.Tensor,
                honest: torch.Tensor, recv_ids=None):
    """(c0, c1) for one broadcast step through the CUDA kernel, (B, R) over
    the receivers ``recv_ids`` (a contiguous range of global indices,
    default all n); CPU tensors run :func:`step_counts_plain`. The kernel
    takes adaptive_min's minority from the non-faulty wire values, which
    are the honest ones, and under Ben-Or's Byzantine pairing the wire
    values are the honest ones, so it does not read ``honest``."""
    global launches
    _step.check_step_supported(cfg)
    if inst_ids.device.type == "cpu":
        return step_counts_plain(cfg, seed, inst_ids, rnd, step, values, silent,
                                 faulty, honest, recv_ids=recv_ids)
    out = _step.launch("urn_step", cfg, seed, inst_ids, rnd, step, values,
                       silent, faulty, *_step.receiver_range(cfg, recv_ids))
    with _count_lock:
        launches += 1
    return out
