"""The CUDA kernels' per-thread arithmetic, built for the host.

``csrc/fused_round.cuh``, ``csrc/keys_step.cuh`` and ``csrc/urn_step.cuh``
keep everything a kernel thread computes between two block or warp
reductions in ``__host__ __device__`` functions; g++ builds them behind the
``csrc/*_host.cpp`` shims. Each is held here against the port's plain torch
version: the host run of the fused kernel's round loop
(``brc_host_fused_round``) against the plain round driver, and the host runs
of the two per-step kernels (``brc_host_keys_step``, ``brc_host_urn_step``)
against their plain versions per step. The ``__global__`` launches
themselves need the card and are checked by ``chip_smoke.py``.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.ops import (
    _build, fused_round, keys_step, masks, prf, urn2, urn_step)


@pytest.fixture(scope="module")
def host():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host build of csrc/fused_round.cuh "
                    "needs a C++ compiler")
    lib = _build.load_host("fused_round_host")
    u32, i32, p = ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p
    lib.brc_threefry2x32.argtypes = [u32] * 4
    lib.brc_threefry2x32.restype = u32
    lib.brc_prf_u32.argtypes = [u32] * 8
    lib.brc_prf_u32.restype = u32
    lib.brc_urn2_chain.argtypes = [u32] * 7 + [i32] * 3
    lib.brc_urn2_chain.restype = i32
    lib.brc_urn2_counts.argtypes = [u32] * 7 + [i32] * 6 + [p, p]
    lib.brc_urn2_counts.restype = None
    lib.brc_host_fused_round.argtypes = [p] * 3 + [i32] * 6 + [u32] * 2
    lib.brc_host_fused_round.restype = None
    return lib


def test_threefry_and_prf_match_plain(host):
    rng = np.random.default_rng(1)
    k0, k1 = 0x9ABCDEF0, 0x12345678
    x = rng.integers(0, 1 << 32, (64, 2), dtype=np.int64)
    want = prf.threefry2x32(k0, k1, torch.as_tensor(x[:, 0]), torch.as_tensor(x[:, 1]))
    got = [host.brc_threefry2x32(k0, k1, int(a), int(b)) for a, b in x]
    np.testing.assert_array_equal(np.array(got), want.numpy())
    coords = np.stack([rng.integers(0, hi, 64) for hi in
                       (prf.MAX_INSTANCES, prf.MAX_ROUNDS, 4, 1024, 1024, 16)], 1)
    for inst, rnd, step, recv, send, purpose in coords:
        want = int(prf.prf_u32((k0, k1), int(inst), int(rnd), int(step), int(recv),
                               int(send), int(purpose)))
        assert host.brc_prf_u32(k0, k1, int(inst), int(rnd), int(step), int(recv),
                                int(send), int(purpose)) == want


def test_urn2_chain_matches_plain(host):
    """Per-receiver chains of their own length K against the plain batch
    loop to max K with masked lanes, on (m, Lr, Dr) spread over all three
    corners."""
    rng = np.random.default_rng(2)
    B, R = 4, 64
    Lr = rng.integers(0, 1024, (B, R))
    m = (rng.random((B, R)) * (Lr + 1)).astype(np.int64)
    Dr = (rng.random((B, R)) * (Lr + 1)).astype(np.int64)
    inst = np.array([0, 5, 77_777, 131_071])
    for seg in (2, 3):
        want = urn2._chain((7, 9), torch.as_tensor(inst), 3, 2, seg,
                           *(torch.as_tensor(x.astype(np.int32)) for x in (m, Lr, Dr)))
        for b in range(B):
            for r in range(R):
                got = host.brc_urn2_chain(7, 9, int(inst[b]), 3, 2, r, seg,
                                          int(m[b, r]), int(Lr[b, r]), int(Dr[b, r]))
                assert got == int(want[b, r]), (b, r, seg)


@pytest.mark.parametrize("n,f", [(7, 2), (64, 21), (512, 170)])
def test_urn2_counts_match_plain(host, n, f):
    cfg = SimConfig(protocol="bracha", n=n, f=f, instances=1000,
                    delivery="urn2").validate()
    rng = np.random.default_rng(n)
    B = 2
    inst = np.array([3, 999])
    values = rng.choice(3, (B, n), p=(0.4, 0.4, 0.2)).astype(np.uint8)
    silent = rng.random((B, n)) < 0.1
    for t in range(3):
        c0, c1 = urn2.counts_fn(cfg, (1, 2), torch.as_tensor(inst), 4, t,
                                torch.as_tensor(values), torch.as_tensor(silent))
        live = ~silent
        M = [(live & (values == w)).sum(1) for w in range(3)]
        out0, out1 = ctypes.c_int(), ctypes.c_int()
        for b in range(B):
            for v in range(n):
                host.brc_urn2_counts(1, 2, int(inst[b]), 4, t, v, int(values[b, v]),
                                     int(live[b, v]), *(int(x[b]) for x in M), n, f,
                                     ctypes.byref(out0), ctypes.byref(out1))
                assert (out0.value, out1.value) == (int(c0[b, v]), int(c1[b, v])), (b, v, t)


def _host_run(host, cfg, ids):
    B = len(ids)
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    rounds = np.empty(B, dtype=np.int32)
    decision = np.empty(B, dtype=np.uint8)
    k0, k1 = prf.seed_key(cfg.seed)
    host.brc_host_fused_round(
        ids.ctypes.data, rounds.ctypes.data, decision.ctypes.data,
        B, cfg.n, cfg.f, cfg.round_cap, fused_round._INIT_CODES[cfg.init],
        fused_round._COIN_CODES[cfg.coin], k0, k1)
    return rounds, decision


HOST_CASES = [
    (n, (n - 1) // 3, init, coin, 256, 64)
    for n in (4, 7, 16) for init in ("random", "all0", "all1", "split")
    for coin in ("shared", "local")
] + [(16, 5, "random", "local", 2, 256), (64, 9, "random", "shared", 256, 64),
     # n - f even: step-0 ties (c0 == c1, which go to 1) happen.
     (10, 2, "random", "local", 256, 256), (64, 10, "random", "shared", 256, 64),
     (512, 170, "random", "shared", 256, 24)]


@pytest.mark.parametrize("case", HOST_CASES,
                         ids=[f"n{c[0]}-f{c[1]}-{c[2]}-{c[3]}-cap{c[4]}" for c in HOST_CASES])
def test_host_round_loop_matches_plain_driver(host, case):
    n, f, init, coin, cap, B = case
    cfg = SimConfig(protocol="bracha", n=n, f=f, instances=100_000, init=init,
                    coin=coin, round_cap=cap, seed=n + cap, delivery="urn2").validate()
    ids = np.random.default_rng(n).choice(cfg.instances, B, replace=False)
    rounds, decision = _host_run(host, cfg, ids)
    pr, pd = fused_round.run_chunk_plain(cfg, torch.as_tensor(ids.astype(np.int32)))
    np.testing.assert_array_equal(rounds, pr.numpy())
    np.testing.assert_array_equal(decision, pd.numpy())
    if cap == 2:
        assert (decision == 2).any(), "the capped case must reach the cap"


STEP_ADVERSARY = {"none": 0, "adaptive": 1, "adaptive_min": 2}


def _step_host(name):
    if shutil.which("g++") is None:
        pytest.skip(f"g++ not found: the host build of csrc/{name}.cuh needs a "
                    "C++ compiler")
    lib = _build.load_host(f"{name}_host")
    fn = getattr(lib, f"brc_host_{name}")
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_uint32] * 2
    fn.restype = None
    return lib, fn


STEP_HOST_CASES = [(n, (n - 1) // 3, adv) for n in (4, 10, 64, 128, 200, 512)
                   for adv in ("none", "adaptive", "adaptive_min")]


@pytest.mark.parametrize("n,f,adversary", STEP_HOST_CASES,
                         ids=[f"n{c[0]}-{c[2]}" for c in STEP_HOST_CASES])
@pytest.mark.parametrize("name", ["keys_step", "urn_step"])
def test_step_kernel_host_run_matches_plain(name, n, f, adversary):
    """One step of the kernel's per-thread arithmetic, every (instance,
    receiver), on random planes (faulty senders on the wire with a value
    of their own), against the plain version."""
    _, fn = _step_host(name)
    cfg = SimConfig(protocol="bracha", n=n, f=f, instances=100_000, adversary=adversary,
                    delivery={"keys_step": "keys", "urn_step": "urn"}[name]).validate()
    rng = np.random.default_rng(n)
    B = 3 if n <= 200 else 2
    ids = rng.choice(cfg.instances, B, replace=False).astype(np.int32)
    honest = rng.integers(0, 3, (B, n)).astype(np.uint8)
    faulty = rng.random((B, n)) < 0.3
    values = np.where(faulty, rng.integers(0, 2, (B, 1)), honest).astype(np.uint8)
    silent = rng.random((B, n)) < 0.15
    k0, k1 = 0x01234567, 0x89ABCDEF
    for rnd, t in ((0, 0), (5, 1), (300, 2)):
        c0 = np.empty((B, n), np.int32)
        c1 = np.empty((B, n), np.int32)
        sil8, fa8 = silent.astype(np.uint8), faulty.astype(np.uint8)
        fn(ids.ctypes.data, values.ctypes.data, sil8.ctypes.data, fa8.ctypes.data,
           c0.ctypes.data, c1.ctypes.data, B, n, f, rnd, t,
           STEP_ADVERSARY[adversary], k0, k1)
        planes = [torch.as_tensor(x) for x in (values, silent, faulty)]
        if name == "keys_step":
            w0, w1 = keys_step.step_counts_plain(cfg, (k0, k1), torch.as_tensor(ids),
                                                 rnd, t, *planes)
        else:
            w0, w1 = urn_step.step_counts_plain(cfg, (k0, k1), torch.as_tensor(ids),
                                                rnd, t, *planes, torch.as_tensor(honest))
        np.testing.assert_array_equal(c0, w0.numpy(), err_msg=f"round {rnd} step {t}")
        np.testing.assert_array_equal(c1, w1.numpy(), err_msg=f"round {rnd} step {t}")


def test_combined_key_matches_plain_keys():
    lib, _ = _step_host("keys_step")
    fn = lib.brc_combined_key
    fn.argtypes = [ctypes.c_uint32] * 2 + [ctypes.c_int] * 4 + [ctypes.c_uint32] * 4 + [
        ctypes.c_int, ctypes.c_uint32]
    fn.restype = ctypes.c_uint32
    rng = np.random.default_rng(6)
    for adversary, code in STEP_ADVERSARY.items():
        cfg = SimConfig(protocol="bracha", n=40, f=13, instances=1000, adversary=adversary,
                        delivery="keys").validate()
        inst, minority = 777, code & 1
        values = rng.integers(0, 3, (1, 40)).astype(np.uint8)
        silent = rng.random((1, 40)) < 0.3
        vv, recv = values[:, None, :], np.arange(40)[None, :, None]
        pref = minority if adversary == "adaptive_min" else (recv >= 20)
        bias = ((vv == 2) | (vv != pref)) & (adversary != "none")
        want = masks.combined_keys(cfg, (3, 4), torch.tensor([inst]), 9, 2,
                                   torch.as_tensor(silent), torch.as_tensor(bias))[0]
        for r in range(40):
            for s_ in range(44):
                v = int(values[0, s_]) if s_ < 40 else 2
                got = fn(3, 4, 40, 9, 2, code, inst, r, s_, v,
                         int(silent[0, s_]) if s_ < 40 else 0, minority)
                assert got == (int(want[r, s_]) if s_ < 40 else 0xFFFFFFFF), (r, s_)


def test_host_selection_vs_sort_with_tie_classes():
    """The kernel's selection (the MSB-first search on the top field and the
    tie class in sender order) against an argsort of the full keys, on rows
    with dense top-field collisions, and on random 22-bit tops."""
    lib, _ = _step_host("keys_step")
    fn = lib.brc_select_row
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = None
    rng = np.random.default_rng(99)
    for trial in range(60):
        S = int(rng.integers(1, 1025))
        spread = (5, 1 << 22)[trial % 2]
        top = np.ascontiguousarray(rng.integers(0, spread, S).astype(np.uint32))
        k = int(rng.integers(1, S + 1))
        sel = np.zeros(S, np.uint8)
        fn(top.ctypes.data, S, k, sel.ctypes.data)
        keys = (top.astype(np.int64) << 10) | np.arange(S)
        want = np.zeros(S, np.uint8)
        want[np.argsort(keys)[:k]] = 1
        np.testing.assert_array_equal(sel, want, err_msg=f"S={S} k={k}")
