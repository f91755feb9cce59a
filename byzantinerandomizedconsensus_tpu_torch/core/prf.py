"""The spec §2 PRF for the object oracle: Python ints and numpy arrays.

The oracle draws one word per message, and ``ops/prf.py`` computes on torch
tensors, where a 0-d tensor per call would cost far more than the
arithmetic. This is the same Threefry-2x32 and the same packing laws v1–v3
on Python ints (a scalar draw returns an ``int``) and on numpy integer
arrays (an array draw returns ``uint32``), held bit for bit against
``ops/prf.prf_u32`` by the tests.
"""

from __future__ import annotations

import numpy as np

from byzantinerandomizedconsensus_tpu_torch.ops.prf import (  # noqa: F401  (the oracle's constants)
    BYZ_VALUE, COIN_STEP, COMMITTEE, CRASH_ROUND, FAULT_CRASH, FAULT_EPOCH, FAULT_HEAL,
    FAULT_OMIT, FAULT_SIDE, FAULTY_RANK, INIT_EST, KEY_LOW_BITS, KEY_MASK, LOCAL_COIN,
    MASK32, PACK_SHIFTS, RED_SHIFTS, SCHED, SHARED_COIN, URN, URN2, URN3, URN_LCG_A,
    URN_LCG_C)

_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _seed_key(seed) -> tuple[int, int]:
    if isinstance(seed, tuple):
        return int(seed[0]) & MASK32, int(seed[1]) & MASK32
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & MASK32, (seed >> 32) & MASK32


def _coord(x):
    """A coordinate as a Python int, or as a uint64 array (room for the
    shifts before the 32-bit mask)."""
    if isinstance(x, np.ndarray):
        return x.astype(np.uint64)
    return int(x)


def threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32, 20 rounds, first output word, on u32 words held as
    Python ints or uint64 arrays."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    inject = ((ks[1], ks[2], 1), (ks[2], ks[0], 2), (ks[0], ks[1], 3),
              (ks[1], ks[2], 4), (ks[2], ks[0], 5))
    for g in range(5):
        for r in _ROTATIONS[(g % 2) * 4: (g % 2) * 4 + 4]:
            x0 = (x0 + x1) & MASK32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK32) ^ x0
        a, b, inc = inject[g]
        x0 = (x0 + a) & MASK32
        x1 = (x1 + b + inc) & MASK32
    return x0


def prf_u32(seed, instance, rnd, step, recv, send, purpose, pack=1):
    """One PRF evaluation per spec §2 (``ops/prf.prf_u32``'s packing): an
    ``int`` when every coordinate is a scalar, else a ``uint32`` array of
    the broadcast shape."""
    if pack not in (1, 2, 3):
        raise ValueError(f"unknown packing version {pack!r}")
    k0, k1 = _seed_key(seed)
    instance, rnd, recv, send = (_coord(c) for c in (instance, rnd, recv, send))
    low = (int(step) << 4) | int(purpose)
    if pack == 3:
        x0 = ((send << 20) | recv) & MASK32
        x1 = ((rnd << 20) | (instance << 8) | low) & MASK32
    else:
        s_send, s_rnd, s_recv = PACK_SHIFTS[pack]
        x0 = ((send << s_send) | instance) & MASK32
        x1 = ((rnd << s_rnd) | (recv << s_recv) | low) & MASK32
    out = threefry2x32(k0, k1, x0, x1)
    return out.astype(np.uint32) if isinstance(out, np.ndarray) else out


def prf_sender(seed, instance, rnd, step, tag, sender, purpose, pack=1):
    """A draw addressed by sender (spec §2 v3 sender-draw rule): v3 swaps
    the (tag, sender) coordinates, v1 and v2 pass them through."""
    if pack >= 3:
        tag, sender = sender, tag
    return prf_u32(seed, instance, rnd, step, tag, sender, purpose, pack=pack)


def prf_bit(seed, instance, rnd, step, recv, send, purpose, pack=1):
    return prf_u32(seed, instance, rnd, step, recv, send, purpose, pack=pack) & 1
