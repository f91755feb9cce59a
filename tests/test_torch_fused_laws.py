"""The fused round (ops/fused_round.py) on its new surface: the deliveries urn,
urn3 and committee, and the packing laws v2 and v3 past n = 1024. Tolerance
0 throughout: every output is an integer drawn from one counter-based PRF.

- The plain round driver against the reference's fused TPU kernel in Pallas
  interpret mode, on the rows of artifacts/fused_r20.json
  (tests/test_pallas_round.py::GATED_GRID) that use urn, urn2, urn3 or
  committee; the host build of the wide kernel's loop against the same
  kernel on the two urn rows.
- The host build of the wide kernel's round loop (csrc/fused_round_wide.cuh
  behind csrc/fused_round_wide_*_host.cpp) against the plain driver on a
  grid: urn, urn3 and committee × both protocols × every static adversary
  × every §9 fault schedule, at n in each layout (one replica per thread
  for n ≤ 1024, registers for n ≤ 4096, the scratch plane past that), and
  urn2 at n = 1500.
- The kernel's surface: what it takes, the layout and library each config
  goes to, and what it refuses by name.

tests/test_torch_card.py runs the kernel itself on a card."""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.ops import pallas_round
from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import (
    KERNEL_MAX_PAIRS, PlainUnsupported, TorchBackend, check_plain_supported)
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig, committee_point
from byzantinerandomizedconsensus_tpu_torch.ops import _build, fused_round, prf
from byzantinerandomizedconsensus_tpu_torch.ops.fused_round import FusedUnsupported

ADVERSARIES = ("none", "crash", "byzantine", "adaptive", "adaptive_min")
FAULTS = ("none", "recover", "partition", "omission")


def _ref(cfg):
    return ref_config.SimConfig(**dataclasses.asdict(cfg))


# The rows of artifacts/fused_r20.json on the laws of this surface.
FUSED_R20_ROWS = [
    SimConfig(protocol="bracha", n=6, f=1, instances=8, adversary="adaptive",
              coin="shared", init="split", seed=7, round_cap=64, delivery="urn2",
              faults="recover", crash_window=4),
    SimConfig(protocol="bracha", n=8, f=1, instances=10, adversary="none", coin="local",
              init="all1", seed=5, round_cap=32, delivery="urn3", faults="omission"),
    SimConfig(protocol="benor", n=64, f=2, instances=6, adversary="byzantine",
              coin="shared", init="random", seed=3, round_cap=48, delivery="committee"),
]
# Its two rows under the §4b urn law.
FUSED_R20_URN_ROWS = [
    SimConfig(protocol="benor", n=8, f=1, instances=12, adversary="crash", coin="shared",
              init="random", seed=0, round_cap=32, delivery="urn"),
    SimConfig(protocol="benor", n=12, f=2, instances=8, adversary="adaptive_min",
              coin="shared", init="random", seed=0, round_cap=48, delivery="urn",
              faults="partition"),
]
FUSED_R20_ROWS += FUSED_R20_URN_ROWS


@pytest.mark.parametrize("cfg", FUSED_R20_ROWS,
                         ids=[f"{c.protocol}-n{c.n}-{c.delivery}-{c.adversary}-f{c.faults}"
                              for c in FUSED_R20_ROWS])
def test_plain_driver_matches_reference_fused_kernel(cfg, pallas_interpret):
    assert pallas_interpret, "the reference kernel runs in interpret mode here"
    cfg = cfg.validate()
    ids = np.arange(cfg.instances, dtype=np.uint32)
    want = pallas_round.run_chunk(_ref(cfg), ids, interpret=True)
    rounds, decision = fused_round.run_chunk_plain(
        cfg, torch.arange(cfg.instances, dtype=torch.int32))
    np.testing.assert_array_equal(rounds.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(decision.numpy(), np.asarray(want[1]))


@pytest.fixture(scope="module")
def hosts():
    libs = {}
    for law, name in (("urn", "fused_round_wide_urn_host"),
                      ("committee", "fused_round_wide_committee_host")):
        fn = _build.load_host(name).brc_host_fused_round_wide
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 14 + [ctypes.c_uint32] * 2
        fn.restype = ctypes.c_int
        libs[law] = fn
    return libs


def host_run(hosts, cfg, ids):
    """The wide kernel's round loop built for the host, on the planes the
    wrapper builds: ``(rounds, decision, words)``, ``words`` the final state
    words (int32) as the kernel's state plane holds them."""
    fn = hosts["committee" if cfg.delivery == "committee" else "urn"]
    B = len(ids)
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    rounds = np.empty(B, dtype=np.int32)
    decision = np.empty(B, dtype=np.uint8)
    words = np.empty((B, cfg.n), dtype=np.int32)
    k0, k1 = prf.seed_key(cfg.seed)
    planes = [None if x is None else np.ascontiguousarray(x.numpy()) for x in
              fused_round.operand_planes(cfg, torch.as_tensor(ids), (k0, k1))]
    rc = fn(ids.ctypes.data, *(None if x is None else x.ctypes.data for x in planes),
            rounds.ctypes.data, decision.ctypes.data, words.ctypes.data, B, cfg.n, cfg.f, cfg.round_cap,
            fused_round._INIT_CODES[cfg.init], fused_round._COIN_CODES[cfg.coin],
            *fused_round.wide_params(cfg), fused_round._LAW_CODES[cfg.delivery],
            fused_round._PROTOCOL_CODES[cfg.protocol],
            fused_round._ADVERSARY_CODES[cfg.adversary], fused_round._FAULT_CODES[cfg.faults],
            k0, k1)
    assert rc == 0
    return rounds, decision, words


def _f(law, protocol, n, adversary):
    lying = adversary in ("byzantine", "adaptive", "adaptive_min")
    if law == "committee":
        return n // 5 if protocol == "bracha" else (n // 16 if lying else n // 6)
    return (n - 1) // 3 if protocol == "bracha" else (n - 1) // (5 if lying else 2)


# (delivery law, n): each layout of each law.
LAW_SIZES = [("urn3", 13), ("urn3", 1500), ("committee", 64), ("committee", 1500),
             ("committee", 5000), ("urn2", 1500), ("urn", 13), ("urn", 1500)]
HOST_CASES = [(law, n, p, a, k) for law, n in LAW_SIZES for p in ("bracha", "benor")
              for a in ADVERSARIES for k in FAULTS]


@pytest.mark.parametrize("law,n,protocol,adversary,faults", HOST_CASES,
                         ids=[f"{c[0]}-n{c[1]}-{c[2]}-{c[3]}-{c[4]}" for c in HOST_CASES])
def test_host_round_loop_matches_plain_driver(hosts, law, n, protocol, adversary, faults):
    """Every (protocol, adversary, fault schedule) instantiation of the wide
    kernel's loop, at an n of each layout, against the plain driver; the
    small sizes with a round cap the local coin reaches, so capped instances
    occur, and every init law in turn."""
    if law in ("urn", "urn3") and protocol == "benor" and n < 100:
        n = 16
    i = ADVERSARIES.index(adversary) + FAULTS.index(faults)
    small = n < 100
    cfg = SimConfig(protocol=protocol, n=n, f=_f(law, protocol, n, adversary),
                    instances=4000, adversary=adversary, coin=("shared", "local")[i % 2],
                    init=("random", "all0", "all1", "split")[i % 4], delivery=law,
                    round_cap=24 if small else 6, faults=faults, seed=i + 7 + n).validate()
    ids = np.random.default_rng(n + i).choice(cfg.instances, 12 if small else 2,
                                              replace=False)
    rounds, decision, words = host_run(hosts, cfg, ids)
    want = fused_round.run_chunk_plain(cfg, torch.as_tensor(ids, dtype=torch.int32),
                                       state=True)
    np.testing.assert_array_equal(rounds, want[0].numpy())
    np.testing.assert_array_equal(decision, want[1].numpy())
    np.testing.assert_array_equal(words, want[2].numpy())


def test_host_round_loop_at_committee_point_widths(hosts):
    """committee_point at n = 8192 and n = 131072 (adaptive, v3), two
    instances each, against the plain driver."""
    for n in (8192, 131_072):
        cfg = committee_point(n)
        ids = np.array([0, 1999])
        rounds, decision, words = host_run(hosts, cfg, ids)
        want = fused_round.run_chunk_plain(cfg, torch.as_tensor(ids, dtype=torch.int32),
                                           state=True)
        np.testing.assert_array_equal(rounds, want[0].numpy())
        np.testing.assert_array_equal(decision, want[1].numpy())
        np.testing.assert_array_equal(words, want[2].numpy())


@pytest.mark.parametrize("fields,library,layout", [
    (dict(n=512, f=170, delivery="urn2"), "fused_round", 1),
    (dict(n=1025, f=341, delivery="urn2"), "fused_round_urn2_r4", 4),
    (dict(n=1024, f=341, delivery="urn3"), "fused_round_urn3_r1", 1),
    (dict(n=4096, f=1365, delivery="urn3"), "fused_round_urn3_r4", 4),
    (dict(n=1024, f=341, delivery="urn"), "fused_round_urn_r1", 1),
    (dict(n=4096, f=1365, delivery="urn"), "fused_round_urn_r4", 4),
    (dict(n=64, f=12, delivery="committee"), "fused_round_committee_r1", 1),
    (dict(n=2048, f=409, delivery="committee"), "fused_round_committee_r4", 4),
    (dict(n=4097, f=819, delivery="committee", instances=4096), "fused_round_committee_r0", 0),
    (dict(n=1 << 20, f=(1 << 20) // 5, delivery="committee", instances=64),
     "fused_round_committee_r0", 0),
], ids=lambda x: str(x) if not isinstance(x, dict) else f"{x['delivery']}-n{x['n']}")
def test_each_config_goes_to_its_layout_and_library(fields, library, layout):
    cfg = SimConfig(**{**dict(protocol="bracha", instances=100), **fields}).validate()
    fused_round.check_fused_supported(cfg)
    assert fused_round.library(cfg) == library
    assert fused_round.layout(cfg) == layout
    assert library in _build.KERNELS
    assert {1: 1, 4: 2, 0: 3}[layout] == cfg.pack_version


def test_urn_and_keys_raise_fused_unsupported_naming_where_they_run():
    """keys, the one law off the kernel's surface, raises by name and names
    the per-step kernel that runs it; urn is on the surface, and a CPU
    tensor runs its plain version."""
    cfg = SimConfig(protocol="bracha", n=16, f=5, instances=4, delivery="keys").validate()
    with pytest.raises(FusedUnsupported) as e:
        fused_round.check_fused_supported(cfg)
    assert "delivery='keys'" in str(e.value) and "csrc/keys_step.cu" in str(e.value)
    with pytest.raises(FusedUnsupported):
        fused_round.run_chunk(cfg, torch.zeros(1, dtype=torch.int32))
    assert set(fused_round.SUPPORTED["delivery"]) | {"keys"} == set(
        ("keys", "urn", "urn2", "urn3", "committee"))
    cfg = dataclasses.replace(cfg, delivery="urn").validate()
    fused_round.check_fused_supported(cfg)
    ids = torch.arange(4, dtype=torch.int32)
    got, want = fused_round.run_chunk(cfg, ids), fused_round.run_chunk_plain(cfg, ids)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("cfg", FUSED_R20_URN_ROWS,
                         ids=[f"{c.protocol}-n{c.n}-{c.adversary}-f{c.faults}"
                              for c in FUSED_R20_URN_ROWS])
def test_host_round_loop_matches_reference_fused_kernel_under_urn(hosts, cfg,
                                                                  pallas_interpret):
    """The host build of the wide kernel's loop under §4b urn against the
    reference's fused TPU kernel in Pallas interpret mode, on the two urn rows
    of artifacts/fused_r20.json."""
    assert pallas_interpret, "the reference kernel runs in interpret mode here"
    cfg = cfg.validate()
    ids = np.arange(cfg.instances, dtype=np.uint32)
    want = pallas_round.run_chunk(_ref(cfg), ids, interpret=True)
    rounds, decision, _ = host_run(hosts, cfg, ids)
    np.testing.assert_array_equal(rounds, np.asarray(want[0]))
    np.testing.assert_array_equal(decision, np.asarray(want[1]))


def test_n_beyond_its_law_raises_fused_unsupported():
    """The ceiling is the law's: 4096 for the full-mesh laws (a config past
    it is refused by validate too), 2^20 for committee."""
    for law in ("urn2", "urn3"):
        cfg = SimConfig(protocol="bracha", n=4097, f=1000, instances=4, delivery=law)
        with pytest.raises(FusedUnsupported, match=f"n=4097 \\(delivery='{law}' stops at"):
            fused_round.check_fused_supported(cfg)
        with pytest.raises(ValueError, match="full-mesh ceiling"):
            cfg.validate()
    cfg = SimConfig(protocol="bracha", n=(1 << 20) + 1, f=1000, instances=4,
                    delivery="committee")
    with pytest.raises(FusedUnsupported, match="delivery='committee' stops at n=1048576"):
        fused_round.check_fused_supported(cfg)


def test_backend_takes_fused_for_every_law_of_its_surface():
    backend = TorchBackend(device="cpu")
    assert backend.kernel == "plain"
    card = TorchBackend.__new__(TorchBackend)
    card.kernel, card.device = None, torch.device("cuda")
    for law in ("urn", "urn2", "urn3", "committee"):
        cfg = SimConfig(protocol="bracha", n=64, f=12, instances=4, delivery=law).validate()
        assert card.kernel_for(cfg) == "fused"
    cfg = SimConfig(protocol="bracha", n=64, f=12, instances=4, delivery="keys").validate()
    assert card.kernel_for(cfg) == "step"
    big = committee_point(131_072)
    assert card.chunk_size(big) == KERNEL_MAX_PAIRS // 131_072 == 2048
    assert card.chunk_size(committee_point(8192)) == prf.V3_MAX_INSTANCES
    assert card.chunk_size(SimConfig(protocol="bracha", n=2048, f=682, instances=4,
                                     delivery="urn3").validate()) == prf.V2_MAX_INSTANCES
    assert backend.chunk_size(big) == (1 << 22) // 131_072


def test_plain_surface_takes_each_law_to_its_ceiling():
    check_plain_supported(committee_point(1 << 20))
    check_plain_supported(SimConfig(protocol="bracha", n=4096, f=1365, instances=4,
                                    delivery="urn3").validate())
    with pytest.raises(PlainUnsupported, match="n=4097"):
        check_plain_supported(SimConfig(protocol="bracha", n=4097, f=1365, instances=4,
                                        delivery="urn3"))


def test_cpu_tensors_run_the_plain_version():
    cfg = SimConfig(protocol="benor", n=64, f=2, instances=6, adversary="byzantine",
                    coin="shared", seed=3, round_cap=48, delivery="committee").validate()
    ids = torch.arange(6, dtype=torch.int32)
    got = fused_round.run_chunk(cfg, ids)
    want = fused_round.run_chunk_plain(cfg, ids)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_plain_work_counters_of_the_new_laws():
    """The counters the bound reads: under urn3 one URN3 word per receiver
    with a drop; under committee a membership word per replica and step
    plus a drop word per receiver with a drop; two cheap segments per drop
    word without strata, four with them."""
    for law, adversary in (("urn3", "none"), ("committee", "none"),
                           ("committee", "adaptive")):
        cfg = SimConfig(protocol="bracha", n=64, f=12, instances=16, adversary=adversary,
                        delivery=law, coin="shared").validate()
        stats = {}
        rounds, _ = fused_round.run_chunk_plain(cfg, torch.arange(16, dtype=torch.int32),
                                                stats=stats)
        assert stats["instance_rounds"] == int(rounds.sum())
        words = stats["urn3_words" if law == "urn3" else "committee_draws"]
        drops = words - (3 * 64 * stats["instance_rounds"] if law == "committee" else 0)
        assert 0 < drops <= 3 * 64 * stats["instance_rounds"]
        segments = 4 if adversary == "adaptive" else 2
        assert stats["cheap_segments"] == segments * drops
        assert "chain_trips" not in stats
    # Under urn: a PRF word per receiver with a drop, and the draws that
    # need a random word, all D under one stratum, fewer under two.
    for adversary in ("none", "adaptive"):
        cfg = SimConfig(protocol="bracha", n=64, f=21, instances=16, adversary=adversary,
                        delivery="urn", coin="shared").validate()
        stats = {}
        fused_round.run_chunk_plain(cfg, torch.arange(16, dtype=torch.int32), stats=stats)
        assert 0 < stats["urn_words"] <= stats["urn_random_draws"] <= stats["urn_draws"]
        assert (stats["urn_random_draws"] == stats["urn_draws"]) == (adversary == "none")


@pytest.mark.parametrize("pack", [1, 2, 3])
def test_host_prf_of_each_packing_law_matches_the_port(hosts, pack):
    """csrc/prf.cuh's prf<PACK> and prf_sender<PACK>, built for the host,
    against ops/prf.py on random coordinates of the law's fields."""
    lib = _build.load_host("fused_round_wide_committee_host")
    for fn in (lib.brc_prf_packed, lib.brc_prf_sender_packed):
        fn.argtypes = [ctypes.c_int] + [ctypes.c_uint32] * 8
        fn.restype = ctypes.c_uint32
    rng = np.random.default_rng(90 + pack)
    max_inst, max_rnd, max_n = {1: (prf.MAX_INSTANCES, prf.MAX_ROUNDS, prf.V1_MAX_N),
                                2: (prf.V2_MAX_INSTANCES, prf.V2_MAX_ROUNDS, prf.V2_MAX_N),
                                3: (prf.V3_MAX_INSTANCES, prf.V3_MAX_ROUNDS, prf.V3_MAX_N)}[pack]
    k0, k1 = prf.seed_key(0xDEADBEEF12345678)
    for _ in range(64):
        inst, rnd = int(rng.integers(0, max_inst)), int(rng.integers(0, max_rnd))
        recv, step = int(rng.integers(0, max_n)), int(rng.integers(0, 4))
        send = int(rng.integers(0, 2))
        purpose = int(rng.choice([prf.URN3, prf.COMMITTEE, prf.BYZ_VALUE, prf.INIT_EST]))
        want = int(prf.prf_u32((k0, k1), inst, rnd, step, recv, send, purpose, pack=pack))
        assert lib.brc_prf_packed(pack, k0, k1, inst, rnd, step, recv, send, purpose) == want
        want = int(prf.prf_sender((k0, k1), inst, rnd, step, send, recv, purpose, pack=pack))
        assert lib.brc_prf_sender_packed(pack, k0, k1, inst, rnd, step, send, recv,
                                         purpose) == want


def test_host_cheap_segment_matches_the_port():
    from byzantinerandomizedconsensus_tpu_torch.ops import urn3

    lib = _build.load_host("fused_round_wide_urn_host")
    lib.brc_cheap.argtypes = [ctypes.c_uint32, ctypes.c_uint32] + [ctypes.c_int] * 3
    lib.brc_cheap.restype = ctypes.c_int
    rng = np.random.default_rng(5)
    Lr = rng.integers(0, 4096, 512)
    m = (rng.random(512) * (Lr + 1)).astype(np.int64)
    Dr = (rng.random(512) * (Lr + 1)).astype(np.int64)
    u = rng.integers(0, 1 << 32, 512, dtype=np.uint64).astype(np.int64)
    for seg in range(4):
        want = urn3._cheap(torch.as_tensor(u), seg, *(torch.as_tensor(x) for x in (m, Lr, Dr)))
        got = [lib.brc_cheap(int(u[i]), seg, int(m[i]), int(Lr[i]), int(Dr[i]))
               for i in range(512)]
        np.testing.assert_array_equal(np.array(got), want.numpy())
