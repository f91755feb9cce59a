"""Delivery masks (spec/PROTOCOL.md §4) — the keys law, in torch.

The port's counterpart of the reference ``ops/masks.py``. Each receiver gets
the messages of the ``n - f`` senders with the smallest combined scheduling
keys, ``silent(1) | bias(1) | prf_top(20) | sender(10)`` under packing law v1
(``prf_top(18) | sender(12)`` under v2), and always its own. The keys are
distinct by construction (the low bits are the sender), so "the n - f
smallest" is an exact integer selection: here a ``kthvalue`` over int64 keys
that hold u32 words. With :mod:`ops.tally` this is the plain version of the
keys kernel (``ops/keys_step.py``). It holds the (B, R, n) key tensor in
device memory, so its caller, ``keys_step.step_counts_plain``, bounds B.
"""

from __future__ import annotations

import torch

from byzantinerandomizedconsensus_tpu_torch.ops import prf


def combined_keys(cfg, seed, inst_ids: torch.Tensor, rnd, t, silent, bias,
                  recv_ids=None) -> torch.Tensor:
    """Combined scheduling keys, (B, R, n) int64 u32 words, axes (instance,
    recv, send). ``silent`` (B, n) bool; ``bias`` (B, 1, n) or (B, R, n)
    bool; ``recv_ids`` the global receiver indices (default all n)."""
    n, dev = cfg.n, silent.device
    if recv_ids is None:
        recv_ids = torch.arange(n, device=dev)
    recv = recv_ids.to(torch.int64)[None, :, None]
    send = torch.arange(n, dtype=torch.int64, device=dev)[None, None, :]
    sched = prf.prf_u32(seed, inst_ids.to(torch.int64)[:, None, None], rnd, t,
                        recv, send, prf.SCHED, pack=cfg.pack_version)
    low = prf.KEY_LOW_BITS[cfg.pack_version]
    top = 30 - low
    combined = ((silent.to(torch.int64)[:, None, :] << 31)
                | (bias.to(torch.int64) << 30)
                | (((sched >> (32 - top)) & ((1 << top) - 1)) << low)
                | send)
    # A replica always receives its own message: its key is its own index.
    return torch.where(recv == send, recv, combined)


def mask_from_keys(combined: torch.Tensor, n_deliver: int, silent,
                   recv_ids=None) -> torch.Tensor:
    """(B, R, n) bool: the ``n_deliver`` smallest keys of each receiver row,
    minus silent senders, plus the receiver's own message."""
    n = combined.shape[-1]
    kth = torch.kthvalue(combined, n_deliver, dim=-1).values
    mask = combined <= kth[..., None]
    if recv_ids is None:
        recv_ids = torch.arange(n, device=combined.device)
    own = (recv_ids.to(torch.int64)[:, None]
           == torch.arange(n, device=combined.device)[None, :])[None]
    return (mask & ~silent[:, None, :]) | own


def delivery_mask(cfg, seed, inst_ids, rnd, t, silent, bias, recv_ids=None):
    """(B, R, n) bool — delivered(recv, send) per spec §4."""
    combined = combined_keys(cfg, seed, inst_ids, rnd, t, silent, bias,
                             recv_ids=recv_ids)
    return mask_from_keys(combined, cfg.n_eff - cfg.f, silent, recv_ids=recv_ids)
