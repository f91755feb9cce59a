"""The fused CUDA kernel's per-replica arithmetic, built for the host.

``csrc/fused_round.cuh`` keeps everything a kernel thread computes between
two block reductions in ``__host__ __device__`` functions; g++ builds them
behind ``csrc/fused_round_host.cpp``. Each is held here against the port's
plain torch version, and the host run of the kernel's round loop
(``brc_host_fused_round``) against the plain round driver. The ``__global__``
launch itself needs the card and is checked by ``chip_smoke.py``.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.ops import _build, fused_round, prf, urn2


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
