"""The CUDA kernels' per-thread arithmetic, built for the host.

``csrc/fused_round.cuh``, ``csrc/keys_step.cuh`` and ``csrc/urn_step.cuh``
keep everything a kernel thread computes between two block or warp
reductions in ``__host__ __device__`` functions; g++ builds them behind the
``csrc/*_host.cpp`` shims. Each is held here against the port's plain torch
version: the host run of the fused kernel's round loop
(``brc_host_fused_round``) against the plain round driver, and the host runs
of the two per-step kernels (``brc_host_keys_step``, ``brc_host_urn_step``)
against their plain versions per step, and the keys kernel's row selection
(``brc_deliver_row``) against an argsort. The ``__global__`` launches
themselves need the card and are checked by ``chip_smoke.py``.
"""

import ctypes
import importlib.util
import pathlib
import shutil

import numpy as np
import pytest
import torch

from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.models import adversaries
from byzantinerandomizedconsensus_tpu_torch.ops import (
    _build, fused_round, keys_step, masks, prf, urn, urn2, urn_step)

# chip_smoke.py holds the keys bound's count, crossing_pairs.
_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)


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
    lib.brc_urn2_counts_strata.argtypes = [u32] * 7 + [i32] * 6 + [u32, p, p]
    lib.brc_urn2_counts_strata.restype = None
    lib.brc_inject.argtypes = [i32] + [u32] * 7 + [i32] * 2
    lib.brc_inject.restype = i32
    lib.brc_two_faced_value.argtypes = [u32] * 7
    lib.brc_two_faced_value.restype = u32
    lib.brc_benor_report.argtypes = [i32] * 5
    lib.brc_benor_report.restype = u32
    lib.brc_benor_update.argtypes = [u32] * 2 + [i32] * 4 + [u32] * 4 + [i32] * 2
    lib.brc_benor_update.restype = u32
    lib.brc_host_fused_round.argtypes = [p] * 5 + [i32] * 8 + [u32] * 2
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
    """The host build of the kernel's round loop on ``ids``, with the
    adversary's planes built by the wrapper's own ``adversary_planes``."""
    B = len(ids)
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    rounds = np.empty(B, dtype=np.int32)
    decision = np.empty(B, dtype=np.uint8)
    k0, k1 = prf.seed_key(cfg.seed)
    planes = [None if x is None else np.ascontiguousarray(x.numpy()) for x in
              fused_round.adversary_planes(cfg, torch.as_tensor(ids), (k0, k1))]
    host.brc_host_fused_round(
        ids.ctypes.data, *(None if x is None else x.ctypes.data for x in planes),
        rounds.ctypes.data, decision.ctypes.data,
        B, cfg.n, cfg.f, cfg.round_cap, fused_round._INIT_CODES[cfg.init],
        fused_round._COIN_CODES[cfg.coin], fused_round._PROTOCOL_CODES[cfg.protocol],
        fused_round._ADVERSARY_CODES[cfg.adversary], k0, k1)
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


def ids_with_faulty_zero(cfg, B, seed):
    """B instance ids of ``cfg``, a quarter of them (under an adversary)
    with replica 0 faulty, so the first correct replica is not replica 0."""
    rng = np.random.default_rng(seed)
    cand = rng.choice(cfg.instances, min(cfg.instances, 16 * B), replace=False)
    zero = adversaries.faulty_mask(cfg, cfg.seed, torch.as_tensor(cand))[:, 0].numpy()
    picked = np.concatenate([cand[zero][:B // 4], cand[~zero]])[:B]
    assert cfg.adversary == "none" or zero.any()
    return picked


# (protocol, adversary, n, f, coin, round_cap, B): every instantiation of the
# kernel other than config4's (bracha, none), with capped cases.
ADVERSARY_CASES = [
    ("bracha", "crash", 10, 3, "shared", 64, 48),
    ("bracha", "crash", 16, 5, "local", 3, 48),
    ("bracha", "byzantine", 10, 3, "shared", 64, 48),
    ("bracha", "byzantine", 16, 5, "local", 64, 48),
    ("bracha", "adaptive", 13, 4, "shared", 64, 48),
    ("bracha", "adaptive", 64, 21, "local", 64, 12),
    ("bracha", "adaptive_min", 13, 4, "shared", 64, 48),
    ("bracha", "adaptive_min", 16, 5, "local", 2, 48),
    ("benor", "none", 4, 1, "local", 32, 48),
    ("benor", "none", 7, 3, "shared", 32, 48),
    ("benor", "crash", 16, 5, "local", 32, 48),
    ("benor", "crash", 64, 21, "local", 6, 12),
    ("benor", "byzantine", 16, 3, "local", 32, 48),
    ("benor", "byzantine", 11, 2, "shared", 32, 48),
    ("benor", "adaptive", 16, 3, "local", 32, 48),
    ("benor", "adaptive_min", 16, 3, "shared", 32, 48),
]


@pytest.mark.parametrize("case", ADVERSARY_CASES,
                         ids=[f"{c[0]}-{c[1]}-n{c[2]}-{c[4]}-cap{c[5]}" for c in ADVERSARY_CASES])
def test_host_round_loop_matches_plain_driver_per_adversary(host, case):
    """Every new (protocol, adversary) instantiation of the kernel's round
    loop, on ids with a faulty replica 0 among them, against the plain
    round driver."""
    protocol, adversary, n, f, coin, cap, B = case
    cfg = SimConfig(protocol=protocol, n=n, f=f, instances=100_000, adversary=adversary,
                    coin=coin, round_cap=cap, seed=3 * n + cap,
                    delivery="urn2").validate()
    ids = ids_with_faulty_zero(cfg, B, n + cap)
    rounds, decision = _host_run(host, cfg, ids)
    pr, pd = fused_round.run_chunk_plain(cfg, torch.as_tensor(ids.astype(np.int32)))
    np.testing.assert_array_equal(rounds, pr.numpy())
    np.testing.assert_array_equal(decision, pd.numpy())


def test_host_wire_values_match_inject(host):
    """The kernel's per-sender wire value and silence (crash, Bracha's
    Byzantine word) and Ben-Or's two-faced class values against
    ``AdversaryModel.inject`` and ``ops/urn.py::byz_class_values``."""
    rng = np.random.default_rng(12)
    k0, k1 = 0x0BADCAFE, 0x12345
    for protocol, adversary, n, f in (("bracha", "crash", 16, 5),
                                      ("bracha", "byzantine", 31, 10),
                                      ("benor", "crash", 16, 7)):
        cfg = SimConfig(protocol=protocol, n=n, f=f, instances=1000, adversary=adversary,
                        delivery="urn2").validate()
        ids = torch.as_tensor(rng.choice(1000, 6, replace=False))
        adv = adversaries.AdversaryModel(cfg)
        setup = adv.setup((k0, k1), ids)
        for rnd, t in ((0, 0), (3, 1), (9, 2)):
            honest = torch.as_tensor(rng.integers(0, 3, (6, n)).astype(np.uint8))
            values, silent, _ = adv.inject((k0, k1), ids, rnd, t, honest, setup)
            for b in range(6):
                for v in range(n):
                    got = host.brc_inject(fused_round._ADVERSARY_CODES[adversary], k0, k1,
                                          int(ids[b]), rnd, t, v, int(honest[b, v]),
                                          int(setup["faulty"][b, v]),
                                          int(setup["crash_round"][b, v]))
                    assert (got & 0xFF, got >> 8) == (int(values[b, v]),
                                                      int(not silent[b, v])), (b, v)
    cfg = SimConfig(protocol="benor", n=16, f=3, instances=1000, adversary="byzantine",
                    delivery="urn2").validate()
    ids = torch.as_tensor(rng.choice(1000, 6, replace=False))
    honest = torch.as_tensor(rng.integers(0, 3, (6, 16)).astype(np.uint8))
    faulty = torch.ones((6, 16), dtype=torch.bool)
    for rnd, t in ((0, 0), (7, 1)):
        want = urn.byz_class_values(cfg, (k0, k1), ids, rnd, t, honest, faulty)
        for h in (0, 1):
            got = [[host.brc_two_faced_value(k0, k1, int(ids[b]), rnd, t, v, h)
                    for v in range(16)] for b in range(6)]
            np.testing.assert_array_equal(np.array(got), want[h].numpy())


@pytest.mark.parametrize("adversary", ["adaptive", "adaptive_min"])
def test_urn2_counts_strata_match_plain(host, adversary):
    """One receiver's two-stratum counts against ``ops/urn2.py::counts_fn``
    on random planes, with the receiver's preferred value from its lane
    (adaptive) or the minority of the honest non-faulty votes
    (adaptive_min); n=512, f=170 reaches K = D."""
    for n, f in ((13, 4), (512, 170)):
        cfg = SimConfig(protocol="bracha", n=n, f=f, instances=1000, adversary=adversary,
                        delivery="urn2").validate()
        rng = np.random.default_rng(n)
        B, inst = 2, np.array([5, 811])
        honest = rng.choice(3, (B, n), p=(0.45, 0.45, 0.1)).astype(np.uint8)
        faulty = rng.random((B, n)) < 0.3
        minority = adversaries.observed_minority(torch.as_tensor(honest),
                                                 torch.as_tensor(faulty)).numpy()
        values = np.where(faulty, minority[:, None], honest).astype(np.uint8)
        silent = rng.random((B, n)) < 0.1
        c0, c1 = urn2.counts_fn(cfg, (1, 2), torch.as_tensor(inst), 4, 2,
                                torch.as_tensor(values), torch.as_tensor(silent),
                                torch.as_tensor(faulty), torch.as_tensor(honest))
        live = ~silent
        M = [(live & (values == w)).sum(1) for w in range(3)]
        out0, out1 = ctypes.c_int(), ctypes.c_int()
        for b in range(B):
            for v in range(n):
                pref = int(v >= (n + 1) // 2) if adversary == "adaptive" else int(minority[b])
                host.brc_urn2_counts_strata(1, 2, int(inst[b]), 4, 2, v, int(values[b, v]),
                                            int(live[b, v]), *(int(x[b]) for x in M), n, f,
                                            pref, ctypes.byref(out0), ctypes.byref(out1))
                assert (out0.value, out1.value) == (int(c0[b, v]), int(c1[b, v])), (b, v)


def test_benor_report_and_update_match_round_body_rules(host):
    """Ben-Or's report and round's end under both threshold sets against
    the rules of ``models/benor.py``, on every count pair of a small n."""
    n, f = 11, 2
    k0, k1 = 7, 8
    for lying in (0, 1):
        rhs = n + f if lying else n
        for r0 in range(n + 1):
            for r1 in range(n + 1 - r0):
                want = 1 if 2 * r1 > rhs else (0 if 2 * r0 > rhs else 2)
                assert host.brc_benor_report(n, f, lying, r0, r1) == want
                w = int(r1 >= r0)
                c = r1 if w else r0
                decide = (2 * c > n + f) if lying else (c >= f + 1)
                for coin_code in (0, 1):
                    coin = int(prf.prf_u32((k0, k1), 9, 3, prf.COIN_STEP,
                                           5 if coin_code == 0 else 0, 0,
                                           prf.LOCAL_COIN if coin_code == 0
                                           else prf.SHARED_COIN)) & 1
                    est = w if c >= (f + 1 if lying else 1) else coin
                    word = (3 << 8) | 1
                    got = host.brc_benor_update(k0, k1, n, f, coin_code, lying, 9, 3, 5,
                                                word, r0, r1)
                    assert got == (est | (int(decide) << 2) | ((w if decide else 0) << 3)
                                   | (4 << 8)), (lying, r0, r1, coin_code)


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


def _deliver_row_fn():
    lib, _ = _step_host("keys_step")
    fn = lib.brc_deliver_row
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def test_host_selection_vs_sort_with_tie_classes():
    """The kernel's row selection (brc_deliver_row: the class plan, the
    histogram select and the exact finish) against an argsort of the full
    keys, on rows with dense top-field collisions, which fill one bin past
    the finish slots, and on random 22-bit tops (every class, silent ones
    included)."""
    fn = _deliver_row_fn()
    rng = np.random.default_rng(99)
    for trial in range(60):
        S = int(rng.integers(1, 1025))
        spread = (5, 1 << 22)[trial % 2]
        top = np.ascontiguousarray(rng.integers(0, spread, S).astype(np.uint32))
        values = np.ascontiguousarray(rng.integers(0, 3, S).astype(np.uint8))
        k = int(rng.integers(1, S + 1))
        recv = int(rng.integers(0, S))
        deliv = np.zeros(S, np.uint8)
        out = np.zeros(2, np.int32)
        fn(top.ctypes.data, values.ctypes.data, S, recv, k, deliv.ctypes.data,
           out.ctypes.data)
        keys = (top.astype(np.int64) << 10) | np.arange(S)
        keys[recv] = recv
        want = np.zeros(S, bool)
        want[np.argsort(keys)[:k]] = True
        want &= (top >> 21) == 0
        want[recv] = True
        np.testing.assert_array_equal(deliv.astype(bool), want, err_msg=f"S={S} k={k}")


def _row_case(case, n, rng):
    """Natural classes (silent << 1 | bias) and PRF fields of a row of n
    senders, built to reach one branch of the kernel's row plan."""
    perm = rng.permutation(n)
    prf_ = rng.integers(0, 1 << 20, n)
    cls = np.zeros(n, np.int64)
    if case == "cross1":
        cls[:] = 1
        cls[perm[:max(1, n // 3)]] = 0
    elif case == "live_below_k":
        cls = rng.integers(0, 2, n)
        cls[perm[:n // 2 + 1]] |= 2
    elif case == "all_silent":
        cls = 2 | rng.integers(0, 2, n)
    elif case == "own_ties":
        prf_[perm[:n // 2]] = 0  # ties at top 0 with the own key
    elif case == "bin_ties":
        # One 8-bit bin holds a third of the senders, some with equal PRFs.
        tied = perm[:max(2, n // 3)]
        prf_[tied] = (0x5A << 12) | rng.integers(0, 4, len(tied))
        cls = rng.integers(0, 2, n)
    return cls, prf_


ROW_CASES = ["cross0", "cross1", "live_below_k", "all_silent", "own_ties", "bin_ties"]


@pytest.mark.parametrize("n", [4, 10, 200, 512, 1024])
@pytest.mark.parametrize("case", ROW_CASES)
def test_deliver_row_vs_argsort(case, n):
    """The kernel's row (class plan, crossing class, histogram select, exact
    finish) against an argsort of the full keys (top, sender) with the own
    key recv, on rows built to reach each branch; the counts against the
    delivered flags."""
    fn = _deliver_row_fn()
    rng = np.random.default_rng(n + 7 * ROW_CASES.index(case))
    cls, prf_ = _row_case(case, n, rng)
    top = np.ascontiguousarray((cls << 20) | prf_, dtype=np.uint32)
    values = np.ascontiguousarray(rng.integers(0, 3, n), dtype=np.uint8)
    silent = cls >= 2
    plans = set()
    for recv in sorted({0, n // 2, n - 1}):
        for k in sorted({1, max(1, n // 8), n - (n - 1) // 3, n - 1, n}):
            if k < 1:
                continue
            keys = (top.astype(np.int64) << 10) | np.arange(n)
            keys[recv] = recv
            sel = np.zeros(n, bool)
            sel[np.argsort(keys)[:k]] = True
            want = sel & ~silent
            want[recv] = True
            deliv = np.zeros(n, np.uint8)
            out = np.zeros(2, np.int32)
            hashed = fn(top.ctypes.data, values.ctypes.data, n, recv, k,
                        deliv.ctypes.data, out.ctypes.data)
            np.testing.assert_array_equal(deliv.astype(bool), want,
                                          err_msg=f"recv={recv} k={k}")
            assert tuple(out) == (int((want & (values == 0)).sum()),
                                  int((want & (values == 1)).sum())), (recv, k)
            # The plan the row took, from the class counts alone.
            own_cls = cls[recv]
            m0 = int((cls == 0).sum()) - (own_cls == 0) + 1
            m1 = int((cls == 1).sum()) - (own_cls == 1)
            plan = 0 if k < m0 else (1 if k < m0 + m1 else 2)
            plans.add(plan)
            assert hashed == (m0 - 1 if plan == 0 else (m1 if plan == 1 and k > m0 else 0))
    expect = {"cross0": 0, "cross1": 1, "live_below_k": 2, "all_silent": 2,
              "own_ties": 0, "bin_ties": 1}[case]
    assert expect in plans, plans


CROSSING_CASES = [(n, (n - 1) // 3, adv) for n in (10, 64, 200)
                  for adv in ("none", "adaptive", "adaptive_min")]


@pytest.mark.parametrize("n,f,adversary", CROSSING_CASES,
                         ids=[f"n{c[0]}-{c[2]}" for c in CROSSING_CASES])
def test_crossing_pairs_counts_the_kernels_prf_words(n, f, adversary):
    """chip_smoke.py's crossing_pairs, the bound's count, equals the PRF
    words the host build of the kernel computes, on planes with every class
    filled."""
    _, fn = _step_host("keys_step")
    fn.restype = ctypes.c_longlong  # brc_host_keys_step returns its PRF words
    cfg = SimConfig(protocol="bracha", n=n, f=f, instances=100_000, adversary=adversary,
                    delivery="keys").validate()
    rng = np.random.default_rng(3 * n)
    B = 4
    ids = rng.choice(cfg.instances, B, replace=False).astype(np.int32)
    for p_silent in (0.0, 0.15, 0.5):
        values = rng.integers(0, 3, (B, n)).astype(np.uint8)
        silent = (rng.random((B, n)) < p_silent).astype(np.uint8)
        faulty = (rng.random((B, n)) < 0.3).astype(np.uint8)
        c0 = np.empty((B, n), np.int32)
        c1 = np.empty((B, n), np.int32)
        got = fn(ids.ctypes.data, values.ctypes.data, silent.ctypes.data, faulty.ctypes.data,
                 c0.ctypes.data, c1.ctypes.data, B, n, f, 2, 1,
                 STEP_ADVERSARY[adversary], 5, 6)
        want = chip_smoke.crossing_pairs(cfg, *(torch.as_tensor(x) for x in
                                               (values, silent.astype(bool), faulty.astype(bool))))
        assert got == want, p_silent
