"""The single source of randomness: Threefry-2x32 counter-based PRF, in torch.

spec/PROTOCOL.md §2 is the normative definition; this is the port's copy of
the reference ``ops/prf.py``. Every draw is one evaluation of :func:`prf_u32`
at a coordinate, so the port draws exactly the bits the reference draws.

``torch.uint32`` has no add, shift or compare on the CPU, so every u32 word
is carried in an ``int64`` tensor and masked back to 32 bits after each
operation that can leave the range. Products of two u32 words would overflow
int64, so they go through :func:`mul32`, which splits the constant factor.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

# Field-packing limits (spec §2).
MAX_INSTANCES = 1 << 17
V1_MAX_N = 1 << 10
MAX_ROUNDS = 1 << 16
V2_MAX_INSTANCES = 1 << 16
V2_MAX_N = 1 << 12
V2_MAX_ROUNDS = 1 << 12
V3_MAX_INSTANCES = 1 << 12
V3_MAX_N = 1 << 20
V3_MAX_ROUNDS = 1 << 12
MAX_N = V3_MAX_N

# (send, rnd, recv) bit offsets of packing laws v1 and v2; v3 puts recv in
# x0 and instance in x1 (:func:`prf_u32`), which a triple cannot describe.
PACK_SHIFTS = {1: (17, 16, 6), 2: (19, 20, 8)}

# The fused round kernel's resident state word: field -> (bit offset, width).
FUSED_STATE_PACK_VERSION = 1
FUSED_STATE_BITS = {"est": (0, 2), "decided": (2, 1),
                    "decided_val": (3, 2), "phase": (8, 24)}

# Range reduction of the urn-family draws: (pre_shift, post_shift) per law.
RED_SHIFTS = {1: (10, 22), 2: (12, 20), 3: (12, 20)}
# Width of the replica-index field at the bottom of the spec §4 combined
# scheduling key and of the §3.2 faulty-rank key, per law; KEY_MASK keeps the
# rank bits above it.
KEY_LOW_BITS = {1: 10, 2: 12, 3: 20}
KEY_MASK = {p: (MASK32 >> low) << low for p, low in KEY_LOW_BITS.items()}


def pack_version(n) -> int:
    """The packing law of a config of size ``n``: v1 for n ≤ 1024, v2 for
    n ≤ 4096, v3 above (spec §2)."""
    if n > V3_MAX_N:
        raise ValueError(f"n={n} exceeds the v3 packing ceiling ({V3_MAX_N})")
    if n > V2_MAX_N:
        return 3
    return 1 if n <= V1_MAX_N else 2


# Purposes (spec §2).
INIT_EST = 0
LOCAL_COIN = 1
SHARED_COIN = 2
FAULTY_RANK = 3
CRASH_ROUND = 4
BYZ_VALUE = 5
SCHED = 6
URN = 7
URN2 = 8
URN3 = 9
FAULT_CRASH = 10
FAULT_HEAL = 11
FAULT_SIDE = 12
FAULT_EPOCH = 13
FAULT_OMIT = 14
COMMITTEE = 15
#: The ``send`` coordinate of the spec §11 session word under COMMITTEE
#: (§10 uses send 0 and 1 only).
SESSION_SEND = 2

# Urn-delivery LCG (spec §4b): full period mod 2^32.
URN_LCG_A = 0x915F77F5
URN_LCG_C = 0x6A09E667

# The step index used for coin draws.
COIN_STEP = 3

_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for an int64 tensor of u32 words and a u32
    constant, without leaving int64: the constant is split in 16-bit
    halves so each partial product stays below 2^48."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Threefry-2x32, 20 rounds, first output word. ``k0``/``k1`` are python
    ints, or int64 tensors of u32 key words that broadcast against ``x0``
    and ``x1`` (one key per row of the lane runner); ``x0``/``x1`` int64
    tensors of u32 words (broadcastable)."""
    if not isinstance(k0, torch.Tensor):
        k0, k1 = int(k0) & MASK32, int(k1) & MASK32
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    inject = ((ks[1], ks[2], 1), (ks[2], ks[0], 2), (ks[0], ks[1], 3),
              (ks[1], ks[2], 4), (ks[2], ks[0], 5))
    for g in range(5):
        for r in _ROTATIONS[(g % 2) * 4: (g % 2) * 4 + 4]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl32(x1, r) ^ x0
        a, b, inc = inject[g]
        x0 = (x0 + a) & MASK32
        x1 = (x1 + b + inc) & MASK32
    return x0


def take_rows(x, sl: slice):
    """The rows ``sl`` of a per-row lane operand: a (rows,) tensor, or a
    ``(k0, k1)`` key of them; anything else (python ints, 0-dim tensors)
    passes through."""
    if isinstance(x, tuple):
        return tuple(take_rows(k, sl) for k in x)
    if isinstance(x, torch.Tensor) and x.dim() == 1:
        return x[sl]
    return x


def receivers(cfg, recv_ids, device) -> torch.Tensor:
    """(R,) int64 global receiver indices: ``recv_ids`` (a replica shard of
    the sharded path, ``parallel/sharded.py``) or all n."""
    if recv_ids is None:
        return torch.arange(cfg.n, dtype=torch.int64, device=device)
    return recv_ids.to(device=device, dtype=torch.int64)


def seed_key(seed) -> tuple:
    """Split a 64-bit python int seed into the (k0, k1) u32 key pair; an
    already-split ``(k0, k1)`` tuple passes through, as python ints, or as
    the lane runner's (rows,) int64 tensors of per-row key words."""
    if isinstance(seed, tuple):
        if isinstance(seed[0], torch.Tensor):
            return seed
        return int(seed[0]) & MASK32, int(seed[1]) & MASK32
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & MASK32, (seed >> 32) & MASK32


def _word(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    return torch.tensor(int(x), dtype=torch.int64, device=device)


def rows(x, ndim: int):
    """A per-row lane operand viewed to broadcast against ``ndim``-dim
    tensors whose leading axis is the row axis: a (rows,) tensor becomes
    (rows, 1, ..., 1); python ints and 0-dim tensors pass through."""
    if isinstance(x, torch.Tensor) and x.dim() == 1 and ndim > 1:
        return x.view((-1,) + (1,) * (ndim - 1))
    return x


def prf_u32(seed, instance, rnd, step, recv, send, purpose, pack=1,
            device=None) -> torch.Tensor:
    """One PRF evaluation per spec §2, as an int64 tensor of u32 words.

    ``seed`` is a python int or a ``(k0, k1)`` key; ``instance``, ``rnd``,
    ``recv`` and ``send`` are ints or integer tensors (broadcastable);
    ``step`` and ``purpose`` are ints. ``device`` places the result when
    every coordinate is a python int. Under the lane runner
    (``backends/batch.py``) the key words and the round are per-row
    operands: (rows,) tensors along the leading axis of ``instance``,
    viewed here to the coordinates' rank (:func:`rows`).

    v1 (n ≤ 1024): x0 = send<<17 | instance,
                   x1 = rnd<<16 | recv<<6 | step<<4 | purpose.
    v2 (n ≤ 4096): x0 = send<<19 | instance,
                   x1 = rnd<<20 | recv<<8 | step<<4 | purpose.
    v3 (n > 4096, the committee family): x0 = send<<20 | recv,
                   x1 = rnd<<20 | instance<<8 | step<<4 | purpose.
    """
    if pack not in (1, 2, 3):
        raise ValueError(f"unknown packing version {pack!r}")
    if device is None:
        for c in (instance, rnd, recv, send):
            if isinstance(c, torch.Tensor):
                device = c.device
                break
    k0, k1 = seed_key(seed)
    instance, rnd, recv, send = (_word(c, device)
                                 for c in (instance, rnd, recv, send))
    if isinstance(k0, torch.Tensor) or rnd.dim() == 1:
        nd = max(instance.dim(), recv.dim(), send.dim())
        rnd = rows(rnd, nd)
        k0, k1 = rows(k0, nd), rows(k1, nd)
    low = (int(step) << 4) | int(purpose)
    if pack == 3:
        x0 = ((send << 20) | recv) & MASK32
        x1 = ((rnd << 20) | (instance << 8) | low) & MASK32
    else:
        s_send, s_rnd, s_recv = PACK_SHIFTS[pack]
        x0 = ((send << s_send) | instance) & MASK32
        x1 = ((rnd << s_rnd) | (recv << s_recv) | low) & MASK32
    return threefry2x32(k0, k1, x0, x1)


def prf_sender(seed, instance, rnd, step, tag, sender, purpose, pack=1,
               device=None) -> torch.Tensor:
    """A PRF draw addressed by *sender* (spec §2 v3 sender-draw rule): the
    BYZ_VALUE family puts the replica id in ``send`` and a small tag in
    ``recv``. Under v1 and v2 that is ``prf_u32(..., recv=tag, send=sender)``;
    v3, whose wide field is ``recv``, swaps the two."""
    if pack >= 3:
        tag, sender = sender, tag
    return prf_u32(seed, instance, rnd, step, tag, sender, purpose, pack=pack,
                   device=device)


def prf_bit(seed, instance, rnd, step, recv, send, purpose, pack=1,
            device=None) -> torch.Tensor:
    return prf_u32(seed, instance, rnd, step, recv, send, purpose, pack=pack,
                   device=device) & 1


def session_digest(slot, decision) -> int:
    """The spec §11 decision digest: ``d_0 = slot + 1``; ``d_{i+1} =
    (URN_LCG_A·d_i + dec_i + 1) mod 2^32`` over the slot's decision vector
    in instance order, in closed affine form (u32 wraparound cumprod)."""
    import numpy as np

    dec = np.ravel(np.asarray(decision)).astype(np.uint32)
    d0 = (int(slot) + 1) & MASK32
    if dec.size == 0:
        return d0
    pw = np.cumprod(np.full(dec.size, URN_LCG_A, dtype=np.uint32), dtype=np.uint32)
    weights = np.concatenate([np.ones(1, dtype=np.uint32), pw[:-1]])[::-1]
    acc = int(np.sum(weights * (dec + np.uint32(1)), dtype=np.uint32))
    return (int(pw[-1]) * d0 + acc) & MASK32


def session_chain_seed(seed, slot, decision, pack=1) -> int:
    """Slot ``slot + 1``'s seed from slot ``slot``'s decision vector (spec
    §11): one COMMITTEE draw at ``send=SESSION_SEND``, the digest split over
    the (instance, rnd, recv) coordinates masked to 12/12/6 bits."""
    dig = session_digest(slot, decision)
    word = prf_u32(seed, dig & 0xFFF, (dig >> 12) & 0xFFF, 0, (dig >> 24) & 0x3F,
                   SESSION_SEND, COMMITTEE, pack=pack, device="cpu")
    return int(word)
