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
  finish in its bin; under Ben-Or's Byzantine pairing each row also hashes
  the values its faulty senders show it. It takes CUDA tensors; given CPU
  tensors it runs the plain version, because there is no kernel to run
  there.
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

import threading

import torch

from byzantinerandomizedconsensus_tpu_torch.models.adversaries import (
    equivocation_values, maybe_two_faced, scheduling_bias)
from byzantinerandomizedconsensus_tpu_torch.models.faults import cross_silent
from byzantinerandomizedconsensus_tpu_torch.ops import _step, masks, prf, tally

#: (instance, receiver, sender) key triples the plain version holds at once:
#: about 100 bytes each across the int64 PRF temporaries (the keys, and under
#: Ben-Or's Byzantine pairing the equivocation values), so 1.6 GB.
PLAIN_PAIRS = 1 << 24

#: Launches of the CUDA kernel since the count was last set to 0 (the
#: sharded path's shard threads add under :data:`_count_lock`).
launches = 0
_count_lock = threading.Lock()


def counts_fn(cfg, seed, inst_ids, rnd, t, values, silent, faulty, honest,
              recv_ids=None):
    """The round body's delivery hook (models/delivery.py): the kernel
    recomputes the bias from the wire values, so ``honest`` is not read.
    ``recv_ids``, a contiguous receiver shard, maps to the kernel's receiver
    offset, as in the reference's adapter (``pallas_tally.py:268-273``)."""
    return step_counts(cfg, seed, inst_ids, rnd, t, values, silent, faulty, recv_ids)


def step_counts(cfg, seed, inst_ids: torch.Tensor, rnd: int, step: int,
                values: torch.Tensor, silent: torch.Tensor, faulty: torch.Tensor,
                recv_ids=None):
    """(c0, c1) for one broadcast step through the CUDA kernel, (B, R) over
    the receivers ``recv_ids`` (a contiguous range of global indices,
    default all n); CPU tensors run :func:`step_counts_plain`."""
    global launches
    _step.check_step_supported(cfg)
    if inst_ids.device.type == "cpu":
        return step_counts_plain(cfg, seed, inst_ids, rnd, step, values, silent, faulty,
                                 recv_ids=recv_ids)
    out = _step.launch("keys_step", cfg, seed, inst_ids, rnd, step, values,
                       silent, faulty, *_step.receiver_range(cfg, recv_ids))
    with _count_lock:
        launches += 1
    return out


def step_counts_plain(cfg, seed, inst_ids: torch.Tensor, rnd: int, step: int,
                      values: torch.Tensor, silent: torch.Tensor,
                      faulty: torch.Tensor, bias=None, fside=None, stats=None,
                      recv_ids=None):
    """The keys law in torch ops, at most :data:`PLAIN_PAIRS` key triples
    at a time. ``bias`` is the (B, 1, n) or (B, R, n) scheduling bias of
    ``inject``; ``None`` computes it chunk by chunk with
    :func:`models.adversaries.scheduling_bias`. ``fside`` is the round's
    (B, n) partition side plane (``models/faults.py::round_masks``); the
    cut it makes (``models/faults.py::cross_silent``) is built chunk by
    chunk, and not at all in a round with nobody on side 1. Under Ben-Or's
    Byzantine pairing ``values`` are the honest values, and each chunk's
    per-receiver values come from
    :func:`models.adversaries.equivocation_values`; ``stats``, when a dict,
    then gains ``equivocation_words``, the (receiver, delivered faulty
    sender) pairs, own message included, each one PRF word of the
    kernel. The rows are the receivers ``recv_ids`` (global indices,
    default all n): the counts are (B, R).

    Under the lane runner the config's per-row operands, the key and the
    round are sliced with the instances (``take_rows``); the fused lanes'
    ``superset`` rows draw the equivocation where their code is Byzantine's."""
    if fside is not None and not bool(fside.any()):
        fside = None
    R = cfg.n if recv_ids is None else recv_ids.shape[0]
    shard = {} if recv_ids is None else {"recv_ids": recv_ids}
    per = max(1, PLAIN_PAIRS // (R * cfg.n))
    parts = []
    for lo in range(0, inst_ids.shape[0], per):
        hi = lo + per
        sl = slice(lo, hi)
        c = cfg.take_rows(sl) if hasattr(cfg, "take_rows") else cfg
        k, r = prf.take_rows(seed, sl), prf.take_rows(rnd, sl)
        v = values[lo:hi]
        b = (scheduling_bias(c, v, faulty[lo:hi], recv_ids) if bias is None
             else bias[lo:hi])
        x = None if fside is None else cross_silent(fside[lo:hi], **shard)
        mask = masks.delivery_mask(c, k, inst_ids[lo:hi], r, step,
                                   silent[lo:hi], b, recv_ids=recv_ids, xsilent=x)
        tf = maybe_two_faced(c)
        if tf is not False:
            eq = equivocation_values(c, k, inst_ids[lo:hi], r, step, v,
                                     faulty[lo:hi], recv_ids)
            v = eq if tf is True else torch.where(tf[:, None, None], eq, v[:, None, :])
            if stats is not None:
                stats["equivocation_words"] = stats.get("equivocation_words", 0) + int(
                    (mask & faulty[lo:hi, None, :]).sum())
        parts.append(tally.tally01(mask, v))
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))
