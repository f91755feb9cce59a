"""The fused round (ops/fused_round.py, csrc/fused_round.{cuh,cu}) under the
§9 fault schedules: the plain round driver against the reference's fused
TPU kernel in Pallas interpret mode on urn2 fault configs; the wrapper's
fault planes; the host build of the kernel's new per-thread functions and
of its whole round loop against the plain torch path; and the surfaces of
the three kernels. tests/test_torch_card.py runs the kernel itself on a
card."""

import ctypes
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.ops import pallas_round
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.models import faults
from byzantinerandomizedconsensus_tpu_torch.ops import (
    _build, _step, fused_round, keys_step, prf, urn, urn_step)
from byzantinerandomizedconsensus_tpu_torch.ops.fused_round import FusedUnsupported

KINDS = ("recover", "partition", "omission")
ADVERSARIES = ("none", "crash", "byzantine", "adaptive", "adaptive_min")


def _ref(cfg):
    return ref_config.SimConfig(**dataclasses.asdict(cfg))


# urn2 fault configs in the manner of the rows of artifacts/fused_r20.json.
BLOCK_CASES = [
    SimConfig(protocol="bracha", n=6, f=1, instances=8, adversary="adaptive",
              coin="shared", init="split", round_cap=64, faults="recover", delivery="urn2"),
    SimConfig(protocol="benor", n=8, f=1, instances=8, adversary="crash", coin="shared",
              round_cap=32, faults="omission", delivery="urn2"),
    SimConfig(protocol="bracha", n=8, f=1, instances=8, coin="local", init="all1",
              round_cap=32, faults="omission", delivery="urn2"),
    SimConfig(protocol="benor", n=12, f=2, instances=8, adversary="adaptive_min",
              coin="shared", round_cap=48, faults="partition", delivery="urn2"),
    SimConfig(protocol="benor", n=11, f=2, instances=8, adversary="byzantine",
              coin="local", round_cap=16, faults="partition", delivery="urn2", seed=4),
]


@pytest.mark.parametrize("cfg", BLOCK_CASES,
                         ids=[f"{c.protocol}-n{c.n}-{c.adversary}-{c.faults}"
                              for c in BLOCK_CASES])
def test_plain_driver_matches_reference_fused_kernel_under_faults(cfg, pallas_interpret):
    """One 8-instance block through the reference's fused Pallas kernel with
    its §9 operand block (interpret mode on the CPU) and through the port's
    plain driver."""
    assert pallas_interpret, "the reference kernel runs in interpret mode here"
    cfg = cfg.validate()
    ids = np.arange(cfg.instances, dtype=np.uint32)
    want = pallas_round.run_chunk(_ref(cfg), ids, interpret=True)
    rounds, decision = fused_round.run_chunk_plain(
        cfg, torch.arange(cfg.instances, dtype=torch.int32))
    np.testing.assert_array_equal(rounds.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(decision.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("kind", ("none",) + KINDS)
def test_fault_planes_are_the_schedules_setup(kind):
    ids = torch.arange(5, dtype=torch.int32) * 7
    names = ("fprone", "down_at", "up_at", "side", "part_start", "part_heal")
    dtypes = {"fprone": torch.uint8, "side": torch.uint8}
    for adversary in ("none", "crash"):
        cfg = SimConfig(protocol="bracha", n=13, f=4, instances=100, adversary=adversary,
                        delivery="urn2", faults=kind).validate()
        planes = fused_round.fault_planes(cfg, ids, (3, 4))
        setup = faults.setup_faults(cfg, (3, 4), ids)
        for name, plane in zip(names, planes):
            # Under crash the kernel reads the faulty plane as the fault-prone set.
            if setup is None or name not in setup or (name == "fprone"
                                                      and adversary != "none"):
                assert plane is None, name
                continue
            assert plane.is_contiguous() and plane.dtype == dtypes.get(name, torch.int32)
            assert torch.equal(plane, setup[name].to(plane.dtype)), name
        both = fused_round.operand_planes(cfg, ids, (3, 4))
        assert len(both) == 8
        for a, b in zip(both[2:], planes):
            assert (a is None and b is None) or torch.equal(a, b)
        if setup is not None and adversary != "none":
            assert torch.equal(both[0].bool(), setup["fprone"])


@pytest.fixture(scope="module")
def host():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host build of csrc/fused_round.cuh "
                    "needs a C++ compiler")
    lib = _build.load_host("fused_round_host")
    u32, i32, p = ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p
    lib.brc_recover_silent.argtypes = [i32] * 4
    lib.brc_omission_burst.argtypes = [u32] * 4
    lib.brc_omission_silent.argtypes = [u32] * 5 + [i32]
    lib.brc_partition_cut.argtypes = [i32] * 3
    lib.brc_own_side_totals.argtypes = [i32] * 7 + [p]
    lib.brc_own_side_totals.restype = None
    lib.brc_host_fused_round.argtypes = [p] * 12 + [i32] * 9 + [u32] * 2
    lib.brc_host_fused_round.restype = None
    return lib


def test_host_fault_masks_match_plain(host):
    """recover's window, omission's gate and bit, and partition's epoch,
    per replica and round, against models/faults.py::round_masks."""
    key = (0x1234, 0xBEEF)
    ids = torch.tensor([0, 9, 4242, 99_999])
    for kind in KINDS:
        cfg = SimConfig(protocol="bracha", n=40, f=13, instances=100_000,
                        delivery="urn2", faults=kind, crash_window=3).validate()
        setup = faults.setup_faults(cfg, key, ids)
        for rnd in range(12):
            fsil, fside = faults.round_masks(cfg, key, ids, rnd, setup)
            for b, inst in enumerate(ids.tolist()):
                if kind == "omission":
                    gate = bool(faults.omission_gate(cfg, key, ids, rnd)[b])
                    assert host.brc_omission_burst(*key, inst, rnd) == gate
                if kind == "partition":
                    start, heal = int(setup["part_start"][b]), int(setup["part_heal"][b])
                    cut = host.brc_partition_cut(start, heal, rnd)
                    assert cut == int(start <= rnd < heal)
                    assert fside[b].tolist() == [cut * int(s) for s in setup["side"][b]]
                    continue
                for v in range(cfg.n):
                    fp = int(setup["fprone"][b, v])
                    if kind == "recover":
                        got = host.brc_recover_silent(fp, int(setup["down_at"][b, v]),
                                                      int(setup["up_at"][b, v]), rnd)
                    else:
                        got = host.brc_omission_silent(*key, inst, rnd, v, fp)
                    assert got == int(fsil[b, v]), (kind, rnd, b, v)


def test_host_own_side_totals_match_lane_setup(host):
    """A receiver's side totals from the global and the side-1 totals, as
    the urn's per-side class counts plus its own live message."""
    rng = np.random.default_rng(5)
    n, B = 30, 6
    cfg = SimConfig(protocol="bracha", n=n, f=9, instances=100, delivery="urn2").validate()
    values = rng.choice(3, (B, n)).astype(np.uint8)
    silent = rng.random((B, n)) < 0.2
    fside = (rng.random((B, n)) < 0.3).astype(np.uint8)
    own, m, _, _, _ = urn.lane_setup(cfg, torch.as_tensor(values), torch.as_tensor(silent),
                                     fside=torch.as_tensor(fside))
    live = ~silent
    U = (ctypes.c_int * 3)()
    for b in range(B):
        M = [int((live[b] & (values[b] == w)).sum()) for w in range(3)]
        S = [int((live[b] & (fside[b] == 1) & (values[b] == w)).sum()) for w in range(3)]
        for v in range(n):
            host.brc_own_side_totals(int(fside[b, v]), *M, *S, U)
            for w in range(3):
                own_term = int(live[b, v] and values[b, v] == w)
                assert U[w] == int(m[w][b, v]) + own_term, (b, v, w)


def _host_run(host, cfg, ids):
    B = len(ids)
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    rounds = np.empty(B, dtype=np.int32)
    decision = np.empty(B, dtype=np.uint8)
    words = np.empty((B, cfg.n), dtype=np.int32)
    k0, k1 = prf.seed_key(cfg.seed)
    planes = [None if x is None else np.ascontiguousarray(x.numpy()) for x in
              fused_round.operand_planes(cfg, torch.as_tensor(ids), (k0, k1))]
    host.brc_host_fused_round(
        ids.ctypes.data, *(None if x is None else x.ctypes.data for x in planes),
        rounds.ctypes.data, decision.ctypes.data, words.ctypes.data, B, cfg.n, cfg.f, cfg.round_cap,
        fused_round._INIT_CODES[cfg.init], fused_round._COIN_CODES[cfg.coin],
        fused_round._PROTOCOL_CODES[cfg.protocol], fused_round._ADVERSARY_CODES[cfg.adversary],
        fused_round._FAULT_CODES[cfg.faults], k0, k1)
    return rounds, decision, words


HOST_CASES = [(kind, protocol, adversary) for kind in KINDS
              for protocol in ("bracha", "benor") for adversary in ADVERSARIES]


@pytest.mark.parametrize("kind,protocol,adversary", HOST_CASES,
                         ids=["-".join(c) for c in HOST_CASES])
def test_host_round_loop_matches_plain_driver_under_faults(host, kind, protocol, adversary):
    """The kernel's round loop built for the host, for every (protocol,
    adversary, fault schedule) instantiation, against the plain driver."""
    lying = adversary in ("byzantine", "adaptive", "adaptive_min")
    n = 13 if protocol == "bracha" else 16
    f = (n - 1) // 3 if protocol == "bracha" else (n - 1) // (5 if lying else 2)
    cfg = SimConfig(protocol=protocol, n=n, f=f, instances=5000, adversary=adversary,
                    coin="local" if adversary in ("none", "byzantine") else "shared",
                    delivery="urn2", round_cap=24, faults=kind,
                    seed=len(kind) * 10 + len(adversary)).validate()
    ids = np.random.default_rng(n).choice(cfg.instances, 24, replace=False)
    rounds, decision, words = _host_run(host, cfg, ids)
    want = fused_round.run_chunk_plain(cfg, torch.as_tensor(ids, dtype=torch.int32),
                                       state=True)
    np.testing.assert_array_equal(rounds, want[0].numpy())
    np.testing.assert_array_equal(decision, want[1].numpy())
    np.testing.assert_array_equal(words, want[2].numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_host_round_loop_matches_plain_at_config4_width(host, kind):
    """Config4's width (n=512, f=170) under each schedule, a few instances."""
    cfg = SimConfig(protocol="bracha", n=512, f=170, instances=100_000, coin="shared",
                    delivery="urn2", faults=kind).validate()
    ids = np.array([0, 1, 2, 77_777])
    rounds, decision, words = _host_run(host, cfg, ids)
    want = fused_round.run_chunk_plain(cfg, torch.as_tensor(ids, dtype=torch.int32),
                                       state=True)
    np.testing.assert_array_equal(rounds, want[0].numpy())
    np.testing.assert_array_equal(decision, want[1].numpy())
    np.testing.assert_array_equal(words, want[2].numpy())


@pytest.mark.parametrize("law,module", [("keys", keys_step), ("urn", urn_step)])
@pytest.mark.parametrize("kind", KINDS)
def test_per_step_kernels_raise_faults_unsupported(kind, law, module):
    cfg = SimConfig(protocol="bracha", n=16, f=5, instances=8, delivery=law,
                    faults=kind).validate()
    ids = torch.zeros(1, dtype=torch.int32)
    planes = [torch.zeros((1, cfg.n), dtype=torch.uint8) for _ in range(4)]
    for call in (lambda: _step.check_step_supported(cfg),
                 lambda: module.counts_fn(cfg, 0, ids, 0, 0, *planes)):
        with pytest.raises(faults.FaultsUnsupported) as e:
            call()
        assert f"faults={kind!r}" in str(e.value) and "kernel='plain'" in str(e.value)
        assert isinstance(e.value, _step.StepUnsupported)


def test_fused_surface_takes_every_schedule_and_refuses_superset():
    cfg = SimConfig(protocol="benor", n=16, f=3, instances=8, adversary="byzantine",
                    delivery="urn2").validate()
    for kind in ("none",) + KINDS:
        fused_round.check_fused_supported(dataclasses.replace(cfg, faults=kind))
    with pytest.raises(FusedUnsupported, match="faults='superset'"):
        fused_round.check_fused_supported(dataclasses.replace(cfg, faults="superset"))
    assert fused_round.SUPPORTED["faults"] == ("none",) + KINDS
