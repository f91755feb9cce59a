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
                  recv_ids=None, xsilent=None) -> torch.Tensor:
    """Combined scheduling keys, (B, R, n) int64 u32 words, axes (instance,
    recv, send). ``silent`` (B, n) bool; ``bias`` (B, 1, n) or (B, R, n)
    bool; ``recv_ids`` the global receiver indices (default all n);
    ``xsilent`` an optional (B, R, n) bool per-(recv, send) silence plane,
    the spec §9 partition cut, OR'd into the sender silences (its diagonal
    is False: a replica shares its own side)."""
    n, dev = cfg.n, silent.device
    recv = prf.receivers(cfg, recv_ids, dev)[None, :, None]
    send = torch.arange(n, dtype=torch.int64, device=dev)[None, None, :]
    sched = prf.prf_u32(seed, inst_ids.to(torch.int64)[:, None, None], rnd, t,
                        recv, send, prf.SCHED, pack=cfg.pack_version)
    low = prf.KEY_LOW_BITS[cfg.pack_version]
    top = 30 - low
    silent_b = silent[:, None, :] if xsilent is None else silent[:, None, :] | xsilent
    combined = ((silent_b.to(torch.int64) << 31)
                | (bias.to(torch.int64) << 30)
                | (((sched >> (32 - top)) & ((1 << top) - 1)) << low)
                | send)
    # A replica always receives its own message: its key is its own index.
    return torch.where(recv == send, recv, combined)


def mask_from_keys(combined: torch.Tensor, n_deliver, silent,
                   recv_ids=None, xsilent=None) -> torch.Tensor:
    """(B, R, n) bool: the ``n_deliver`` smallest keys of each receiver row,
    minus silent senders (and the (B, R, n) ``xsilent`` cut), plus the
    receiver's own message. ``n_deliver`` is an int, or the lane runner's
    (B,) per-row tensor."""
    n, dev = combined.shape[-1], combined.device
    if isinstance(n_deliver, torch.Tensor):
        idx = (n_deliver - 1).to(torch.int64)[:, None, None].expand(
            combined.shape[0], combined.shape[1], 1)
        kth = torch.gather(torch.sort(combined, dim=-1).values, 2, idx)[..., 0]
    else:
        kth = torch.kthvalue(combined, n_deliver, dim=-1).values
    mask = combined <= kth[..., None]
    recv = (torch.arange(n, device=dev) if recv_ids is None
            else recv_ids.to(device=dev, dtype=torch.int64))
    own = (recv[:, None] == torch.arange(n, device=dev)[None, :])[None]
    excl = silent[:, None, :] if xsilent is None else silent[:, None, :] | xsilent
    return (mask & ~excl) | own


def delivery_mask(cfg, seed, inst_ids, rnd, t, silent, bias, recv_ids=None,
                  xsilent=None):
    """(B, R, n) bool — delivered(recv, send) per spec §4 (and the §9 cut)."""
    combined = combined_keys(cfg, seed, inst_ids, rnd, t, silent, bias,
                             recv_ids=recv_ids, xsilent=xsilent)
    return mask_from_keys(combined, cfg.n_eff - cfg.f, silent, recv_ids=recv_ids,
                          xsilent=xsilent)
