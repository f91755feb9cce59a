"""The port's arbiters: the object oracle (``core/``, backend ``cpu``), its
scalar PRF, the C++ core's loader (backend ``native``) and the Simulator
front end, against the reference's own ``cpu`` and ``native`` backends and
against the port's torch backend on the CPU, per instance at n <= 16 over
both protocols, every static adversary and every delivery law. Tolerance 0
throughout: every output is an integer drawn from one counter-based PRF."""

import dataclasses

import numpy as np
import pytest
import torch

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.backends import get_backend as ref_get_backend
from byzantinerandomizedconsensus_tpu_torch import get_backend, preset
from byzantinerandomizedconsensus_tpu_torch.backends import native_backend
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.core import prf as core_prf
from byzantinerandomizedconsensus_tpu_torch.core.faults import FaultSchedule
from byzantinerandomizedconsensus_tpu_torch.core.simulator import Simulator
from byzantinerandomizedconsensus_tpu_torch.models import faults
from byzantinerandomizedconsensus_tpu_torch.models.committee import CommitteeUnsupported
from byzantinerandomizedconsensus_tpu_torch.models.faults import FaultsUnsupported
from byzantinerandomizedconsensus_tpu_torch.ops import prf

# (protocol, adversary, n, f): both protocols under every static adversary,
# n <= 16 (Ben-Or under a lying adversary needs n > 5f).
GRID = [
    ("benor", "none", 7, 2), ("benor", "crash", 9, 4), ("benor", "byzantine", 11, 2),
    ("benor", "adaptive", 11, 2), ("benor", "adaptive_min", 11, 2),
    ("bracha", "none", 10, 3), ("bracha", "crash", 13, 4), ("bracha", "byzantine", 10, 3),
    ("bracha", "adaptive", 7, 2), ("bracha", "adaptive_min", 8, 2),
]
GRID_IDS = [f"{p}-{a}" for p, a, _, _ in GRID]
NATIVE_LAWS = ("keys", "urn", "urn2", "urn3")
PACK_FIELDS = {1: (1 << 17, 1 << 10, 1 << 16, 1 << 10), 2: (1 << 16, 1 << 12, 1 << 12, 1 << 12),
               3: (1 << 12, 1 << 20, 1 << 12, 1 << 12)}


def _ref(cfg):
    return ref_config.SimConfig(**dataclasses.asdict(cfg))


def _cfg(proto, adv, n, f, delivery, **kw):
    base = dict(protocol=proto, n=n, f=f, instances=12, adversary=adv, delivery=delivery,
                coin="shared" if n % 2 else "local", round_cap=16, seed=n * 7 + 1)
    return SimConfig(**{**base, **kw}).validate()


def _assert_same(a, b):
    assert np.array_equal(a.inst_ids, b.inst_ids)
    assert np.array_equal(a.rounds, b.rounds)
    assert np.array_equal(a.decision, b.decision)


@pytest.mark.parametrize("pack", (1, 2, 3))
def test_scalar_prf_equals_torch_prf(pack):
    """The oracle's PRF on Python ints and numpy arrays == ops/prf.prf_u32,
    under each packing law, at random coordinates up to each field's edge."""
    rng = np.random.default_rng(pack)
    n_inst, n_rep, n_rnd, n_send = PACK_FIELDS[pack]
    for _ in range(40):
        seed = int(rng.integers(0, 2**63))
        inst, rnd = int(rng.integers(n_inst)), int(rng.integers(n_rnd))
        step, purpose = int(rng.integers(4)), int(rng.integers(16))
        recv, send = rng.integers(n_rep, size=9), int(rng.integers(n_send))
        want = prf.prf_u32(seed, inst, rnd, step, torch.as_tensor(recv), send, purpose,
                           pack=pack).numpy()
        got = core_prf.prf_u32(seed, inst, rnd, step, recv, send, purpose, pack=pack)
        assert got.dtype == np.uint32 and np.array_equal(got, want)
        one = core_prf.prf_u32(seed, inst, rnd, step, int(recv[0]), send, purpose, pack=pack)
        assert isinstance(one, int) and one == int(want[0])
        tag = int(rng.integers(4))
        assert core_prf.prf_sender(seed, inst, rnd, step, tag, send, purpose, pack=pack) \
            == int(prf.prf_sender(seed, inst, rnd, step, tag, send, purpose, pack=pack))
        assert core_prf.prf_bit(seed, inst, rnd, step, int(recv[1]), send, purpose,
                                pack=pack) == int(want[1]) & 1


@pytest.mark.parametrize("delivery", ("keys", "urn", "urn2", "urn3", "committee"))
@pytest.mark.parametrize("proto,adv,n,f", GRID, ids=GRID_IDS)
def test_oracle_equals_reference_oracle_and_torch(proto, adv, n, f, delivery):
    cfg = _cfg(proto, adv, n, f, delivery)
    got = get_backend("cpu").run(cfg)
    _assert_same(ref_get_backend("cpu").run(_ref(cfg)), got)
    _assert_same(get_backend("torch", device="cpu").run(cfg), got)


@pytest.mark.parametrize("delivery", ("keys", "urn2", "committee"))
@pytest.mark.parametrize("fault", ("recover", "partition", "omission"))
def test_oracle_under_fault_schedules(fault, delivery):
    for proto, adv, n, f in (("bracha", "crash", 10, 3), ("benor", "byzantine", 11, 2)):
        cfg = _cfg(proto, adv, n, f, delivery, faults=fault, crash_window=3)
        got = get_backend("cpu").run(cfg)
        _assert_same(ref_get_backend("cpu").run(_ref(cfg)), got)
        _assert_same(get_backend("torch", device="cpu").run(cfg), got)


@pytest.mark.parametrize("fault", ("recover", "partition", "omission"))
def test_oracle_fault_masks_equal_the_model_layer(fault):
    cfg = _cfg("bracha", "crash", 16, 5, "urn2", faults=fault, crash_window=3)
    ids = torch.arange(cfg.instances)
    setup = faults.setup_faults(cfg, cfg.seed, ids)
    for rnd in range(8):
        fsil, fside = faults.round_masks(cfg, cfg.seed, ids, rnd, setup)
        for i in range(cfg.instances):
            osil, oside = FaultSchedule(cfg, cfg.seed, i).round_masks(rnd)
            want_sil = np.zeros(cfg.n, bool) if fsil is None else fsil[i].numpy()
            assert np.array_equal(np.zeros(cfg.n, bool) if osil is None else osil, want_sil)
            zero = np.zeros(cfg.n, np.uint8)
            assert np.array_equal(zero if oside is None else oside,
                                  zero if fside is None else fside[i].numpy())


@pytest.mark.parametrize("delivery", NATIVE_LAWS)
@pytest.mark.parametrize("proto,adv,n,f", GRID, ids=GRID_IDS)
def test_native_equals_reference_native_and_oracle(proto, adv, n, f, delivery):
    cfg = _cfg(proto, adv, n, f, delivery, instances=20)
    got = get_backend("native:2").run(cfg)
    _assert_same(ref_get_backend("native").run(_ref(cfg)), got)
    _assert_same(get_backend("cpu").run(cfg), got)


@pytest.mark.parametrize("init", ("random", "all0", "all1", "split"))
def test_native_init_modes_and_subsets(init):
    cfg = _cfg("bracha", "byzantine", 13, 4, "urn2", init=init, instances=200)
    ids = np.array([3, 17, 0, 199, 64])
    got = get_backend("native").run(cfg, ids)
    _assert_same(ref_get_backend("native").run(_ref(cfg), ids), got)
    _assert_same(get_backend("torch", device="cpu").run(cfg, ids), got)


def test_native_refuses_fault_schedules_and_committee_by_name():
    nb = get_backend("native")
    with pytest.raises(FaultsUnsupported, match=r"native core \(ABI v5\).*recover"):
        nb.run(_cfg("bracha", "none", 10, 3, "urn2", faults="recover"))
    with pytest.raises(CommitteeUnsupported, match=r"native core \(ABI v5\).*committee"):
        nb.run(_cfg("bracha", "none", 10, 3, "committee"))


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No fallback: a missing compiler or a failed build raises."""
    bad = tmp_path / "simcore.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_backend, "source_path", lambda: bad)
    monkeypatch.setattr(native_backend, "library_path", lambda: tmp_path / "simcore.so")
    with pytest.raises(RuntimeError, match="native build failed"):
        native_backend.build_library()
    monkeypatch.setattr(native_backend.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native_backend.build_library()
    assert not (tmp_path / "simcore.so").exists()


def test_native_builds_into_the_port_and_leaves_native_alone():
    from byzantinerandomizedconsensus_tpu_torch.ops import _build

    path = native_backend.build_library()
    assert path.parent == _build.BUILD and path.name.startswith("simcore-v5-")
    assert native_backend.load().sim_abi_version() == 5


def test_simulator_defaults_to_the_oracle():
    cfg = preset("config1", instances=20)
    sim = Simulator(cfg)
    assert sim.backend.name == "cpu"
    res = sim.run()
    assert res.wall_s > 0
    _assert_same(Simulator(cfg, "torch", device="cpu").run(), res)
    _assert_same(ref_get_backend("cpu").run(_ref(cfg)), res)
