"""The urn step kernel's per-receiver arithmetic (``csrc/urn_step.cuh``),
built for the host behind ``csrc/urn_step_host.cpp``, on rows built to reach
each branch of its draw loop: no drops (D = 0), an empty biased stratum
(B0 = 0), a biased stratum that runs out before D (the closed-form tail),
every live message dropped (D = L), the own message in the biased and in the
unbiased class, adaptive_min's tie h0 == h1, and n = 1024 with an urn of
1023. Each is held against the port's plain version (``ops/urn.py``) and the
reference's (``byzantinerandomizedconsensus_tpu/ops/urn.py``). Beside them:
the draw's scaled index and the pick against the reference's range
reduction, and the draws the host build makes against
``chip_smoke.py::urn_draws``, the count
behind the kernel's bound. The ``__global__`` launch needs the card and is
checked by ``chip_smoke.py``.
"""

import ctypes
import importlib.util
import pathlib
import shutil

import numpy as np
import pytest
import torch
from test_torch_keys_step import _ref

from byzantinerandomizedconsensus_tpu.ops import urn as ref_urn
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.ops import _build, urn

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

ADVERSARY = {"none": 0, "adaptive": 1, "adaptive_min": 2}
KEY = (0x01234567, 0x89ABCDEF)


@pytest.fixture(scope="module")
def host():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host build of csrc/urn_step.cuh needs a "
                    "C++ compiler")
    lib = _build.load_host("urn_step_host")
    lib.brc_host_urn_step.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_uint32] * 2
    lib.brc_host_urn_step.restype = ctypes.c_longlong
    lib.brc_urn_scaled.argtypes = [ctypes.c_uint32] * 2
    lib.brc_urn_scaled.restype = ctypes.c_uint32
    lib.brc_sub_if_below.argtypes = [ctypes.c_uint32] * 3
    lib.brc_sub_if_below.restype = ctypes.c_uint32
    return lib


def host_step(host, cfg, ids, values, silent, faulty, rnd, t):
    """(c0, c1, draws) of one step through the host build."""
    B, n = values.shape
    c0 = np.empty((B, n), np.int32)
    c1 = np.empty((B, n), np.int32)
    planes = [np.ascontiguousarray(x, dtype=np.uint8) for x in (values, silent, faulty)]
    draws = host.brc_host_urn_step(ids.ctypes.data, *(x.ctypes.data for x in planes),
                                   c0.ctypes.data, c1.ctypes.data, B, n, cfg.f, rnd, t,
                                   ADVERSARY[cfg.adversary], *KEY)
    return c0, c1, draws


def _lanes(cfg, values, silent, faulty, honest):
    """(D, L, B0, own biased) per lane, from the plain version's class state
    (B0 and own biased are None without strata)."""
    own, m, st, L, D = urn.lane_setup(cfg, *(torch.as_tensor(x) for x in
                                             (values, silent, faulty, honest)))
    if st is None:
        return D.numpy(), L.numpy(), None, None
    B0 = sum(torch.where(s, c, 0) for s, c in zip(st, m)).numpy()
    own_biased = sum(torch.where(s, own == w, False).to(torch.int32)
                     for w, s in enumerate(st)).numpy() > 0
    return D.numpy(), L.numpy(), B0, own_biased


def _pref(n):
    """adaptive's preferred value per receiver: 1 iff v >= (n+1)/2."""
    return (np.arange(n) >= (n + 1) // 2).astype(np.uint8)


def _row(case, n, rng):
    """(values, silent, faulty, honest) of two instances built for ``case``."""
    B = 2
    values = rng.integers(0, 3, (B, n)).astype(np.uint8)
    silent = np.zeros((B, n), bool)
    faulty = np.zeros((B, n), bool)
    if case == "d_zero":
        silent[:, :n // 3 + 1] = True
    elif case == "b0_zero":
        # All 1 in one instance and all 0 in the other: each preference
        # meets an empty biased stratum in one of them.
        values[0], values[1] = 1, 0
    elif case == "tail":
        values[0], values[1] = 1, 0
        values[:, 1:3] = 1 - values[:, :1]
        values[:, 5] = 2
    elif case == "own_biased":
        values[:] = 1 - _pref(n)
        values[:, -1] = 2
    elif case == "own_unbiased":
        values[:] = _pref(n)
        silent[:, 0] = True
    elif case == "min_tie":
        # Honest non-faulty votes: four 0s and four 1s, the rest ⊥; the
        # faulty senders put the minority, 1 (ties go to 1), on the wire.
        faulty[:, :n // 4] = True
        honest = values.copy()
        honest[:, n // 4:] = 2
        honest[:, n // 4:n // 4 + 4] = 0
        honest[:, n // 4 + 4:n // 4 + 8] = 1
        values = np.where(faulty, 1, honest).astype(np.uint8)
        return values, silent, faulty, honest
    elif case == "n1024_strata":
        # Only 0 and ⊥ on the wire: minority 1, so every message is biased.
        values = np.where(rng.random((B, n)) < 0.7, 0, 2).astype(np.uint8)
    return values, silent, faulty, values.copy()


def _both_prefs(mask):
    """True when mask holds lanes of both adaptive preferences."""
    pref = _pref(mask.shape[1]).astype(bool)
    return mask[:, ~pref].any() and mask[:, pref].any()


# (case, adversary, n, f, the branch the rows must reach).
ROW_CASES = [
    ("d_zero", "adaptive", 16, 5, lambda D, L, B0, ob: (D == 0).all()),
    ("d_zero", "none", 16, 5, lambda D, L, B0, ob: (D == 0).all()),
    ("b0_zero", "adaptive", 16, 5, lambda D, L, B0, ob: _both_prefs((B0 == 0) & (D > 0))),
    ("tail", "adaptive", 16, 5, lambda D, L, B0, ob: _both_prefs((B0 > 0) & (B0 < D))),
    # f = n - 1: nothing is delivered but the own message, D = L.
    ("d_equals_l", "none", 16, 15, lambda D, L, B0, ob: (D == L).all() and (D > 0).any()),
    ("d_equals_l", "adaptive", 16, 15,
     lambda D, L, B0, ob: (D == L).all() and _both_prefs((B0 > 0) & (B0 < D))),
    ("own_biased", "adaptive", 16, 5, lambda D, L, B0, ob: ob.all() and (D > 0).all()),
    ("own_unbiased", "adaptive", 16, 5, lambda D, L, B0, ob: (~ob[:, 1:]).all()),
    ("min_tie", "adaptive_min", 16, 5, lambda D, L, B0, ob: (D > 0).any()),
    ("n1024_none", "none", 1024, 341, lambda D, L, B0, ob: (L == 1023).any()),
    ("n1024_strata", "adaptive_min", 1024, 341,
     lambda D, L, B0, ob: (B0 == 1023).any() and (D > 0).all()),
]


@pytest.mark.parametrize("case,adversary,n,f,reached", ROW_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in ROW_CASES])
def test_host_rows_match_plain_and_reference(host, case, adversary, n, f, reached):
    # Not validated: the d_equals_l rows take f = n - 1, outside bracha's
    # n > 3f, which the per-receiver arithmetic does not read.
    cfg = SimConfig(protocol="bracha", n=n, f=f, instances=1000, adversary=adversary,
                    delivery="urn")
    rng = np.random.default_rng(n + f + len(case))
    values, silent, faulty, honest = _row(case, n, rng)
    assert reached(*_lanes(cfg, values, silent, faulty, honest)), case
    if case == "min_tie":
        h = honest[~faulty].reshape(2, -1)
        assert ((h == 0).sum(1) == (h == 1).sum(1)).all()
    ids = np.array([7, 999], np.int32)
    for rnd, t in ((0, 0), (3, 2)):
        c0, c1, draws = host_step(host, cfg, ids, values, silent, faulty, rnd, t)
        planes = [torch.as_tensor(x) for x in (values, silent, faulty, honest)]
        w0, w1 = urn.counts_fn(cfg, KEY, torch.as_tensor(ids), rnd, t, *planes)
        np.testing.assert_array_equal(c0, w0.numpy(), err_msg=f"{case} {rnd} {t}")
        np.testing.assert_array_equal(c1, w1.numpy(), err_msg=f"{case} {rnd} {t}")
        r0, r1 = ref_urn.counts_fn(_ref(cfg), KEY, ids.astype(np.uint32), rnd, t, values,
                                   silent, faulty, honest, xp=np)
        np.testing.assert_array_equal(c0, r0, err_msg=f"{case} {rnd} {t} reference")
        np.testing.assert_array_equal(c1, r1, err_msg=f"{case} {rnd} {t} reference")
        assert draws == chip_smoke.urn_draws(cfg, *planes)[0]


EDGE_S = [0, 1, 0x3FF, 0x400, 0x7FFFFFFF, 0x80000000, 0xFFFFFC00, 0xFFFFFFFF,
          0x915F77F5, 0x6A09E667]


@pytest.mark.parametrize("s", EDGE_S, ids=[f"{s:#010x}" for s in EDGE_S])
def test_scaled_pick_is_the_reference_range_reduction(host, s):
    """urn_scaled(s, R) is the reference's ((s ^ s >> 16) >> 10) * R before
    its last shift (>> 22), with no wrap, and sub_if_below on it takes one
    from a count r carried as r << 22 exactly when the reference's index d
    is below r: for every urn size R of packing law v1 and counts r at the
    edges of d."""
    one = 1 << 22
    u = (s ^ (s >> 16)) >> 10
    for R in range(1024):
        x = host.brc_urn_scaled(s, R)
        assert x == u * R < 1 << 32, R
        d = x >> 22
        for r in sorted({0, 1, d, d + 1, R, 1023}):
            want = r - 1 if d < r else r
            assert host.brc_sub_if_below(x, r * one, one) == want * one, (R, r)


DRAW_CASES = [(n, (n - 1) // 3, adv) for n in (10, 64, 200)
              for adv in ("none", "adaptive", "adaptive_min")]


@pytest.mark.parametrize("n,f,adversary", DRAW_CASES,
                         ids=[f"n{c[0]}-{c[2]}" for c in DRAW_CASES])
def test_urn_draws_counts_the_kernels_draws(host, n, f, adversary):
    """chip_smoke.py's urn_draws, the bound's count (min(D, B0) per receiver
    under two strata, D under one), equals the draws the host build of the
    kernel makes, on random planes (faulty senders on the wire with a value
    of their own)."""
    cfg = SimConfig(protocol="bracha", n=n, f=f, instances=100_000, adversary=adversary,
                    delivery="urn").validate()
    rng = np.random.default_rng(5 * n)
    B = 4
    ids = rng.choice(cfg.instances, B, replace=False).astype(np.int32)
    for p_silent in (0.0, 0.15, 0.5):
        honest = rng.integers(0, 3, (B, n)).astype(np.uint8)
        faulty = rng.random((B, n)) < 0.3
        values = np.where(faulty, rng.integers(0, 2, (B, 1)), honest).astype(np.uint8)
        silent = rng.random((B, n)) < p_silent
        _, _, draws = host_step(host, cfg, ids, values, silent, faulty, 2, 1)
        want, words, drops = chip_smoke.urn_draws(
            cfg, *(torch.as_tensor(x) for x in (values, silent, faulty, honest)))
        assert draws == want, p_silent
        assert want <= drops and words <= B * n
