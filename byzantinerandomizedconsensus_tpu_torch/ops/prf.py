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

# (send, rnd, recv) bit offsets per packing law.
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


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Threefry-2x32, 20 rounds, first output word. ``k0``/``k1`` are python
    ints; ``x0``/``x1`` int64 tensors of u32 words (broadcastable)."""
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


def seed_key(seed) -> tuple[int, int]:
    """Split a 64-bit python int seed into the (k0, k1) u32 key pair; an
    already-split ``(k0, k1)`` tuple passes through."""
    if isinstance(seed, tuple):
        return int(seed[0]) & MASK32, int(seed[1]) & MASK32
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & MASK32, (seed >> 32) & MASK32


def _word(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    return torch.tensor(int(x), dtype=torch.int64, device=device)


def prf_u32(seed, instance, rnd, step, recv, send, purpose, pack=1,
            device=None) -> torch.Tensor:
    """One PRF evaluation per spec §2, as an int64 tensor of u32 words.

    ``seed`` is a python int or a ``(k0, k1)`` key; ``instance``, ``rnd``,
    ``recv`` and ``send`` are ints or integer tensors (broadcastable);
    ``step`` and ``purpose`` are ints. ``device`` places the result when
    every coordinate is a python int.

    v1 (n ≤ 1024): x0 = send<<17 | instance,
                   x1 = rnd<<16 | recv<<6 | step<<4 | purpose.
    v2 (n ≤ 4096): x0 = send<<19 | instance,
                   x1 = rnd<<20 | recv<<8 | step<<4 | purpose.
    v3 belongs to the committee family, which the port does not run yet.
    """
    if pack not in PACK_SHIFTS:
        if pack == 3:
            raise NotImplementedError(
                "packing law v3 (spec §2 v3, n > 4096) is used only by the "
                "committee family, which is not ported yet")
        raise ValueError(f"unknown packing version {pack!r}")
    if device is None:
        for c in (instance, rnd, recv, send):
            if isinstance(c, torch.Tensor):
                device = c.device
                break
    k0, k1 = seed_key(seed)
    s_send, s_rnd, s_recv = PACK_SHIFTS[pack]
    instance, rnd, recv, send = (_word(c, device)
                                 for c in (instance, rnd, recv, send))
    x0 = ((send << s_send) | instance) & MASK32
    x1 = ((rnd << s_rnd) | (recv << s_recv) | (int(step) << 4)
          | int(purpose)) & MASK32
    return threefry2x32(k0, k1, x0, x1)


def prf_sender(seed, instance, rnd, step, tag, sender, purpose, pack=1,
               device=None) -> torch.Tensor:
    """A PRF draw addressed by *sender* (spec §2 v3 sender-draw rule): the
    BYZ_VALUE family puts the replica id in ``send`` and a small tag in
    ``recv``. Under v1 and v2 that is ``prf_u32(..., recv=tag, send=sender)``;
    v3 swaps the two fields, and raises by name here like every v3 draw."""
    if pack >= 3:
        tag, sender = sender, tag
    return prf_u32(seed, instance, rnd, step, tag, sender, purpose, pack=pack,
                   device=device)


def prf_bit(seed, instance, rnd, step, recv, send, purpose, pack=1,
            device=None) -> torch.Tensor:
    return prf_u32(seed, instance, rnd, step, recv, send, purpose, pack=pack,
                   device=device) & 1
