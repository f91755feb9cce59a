"""The port's ``virtual:DxM`` backend (``parallel/virtual.py``: the sharded
driver on CPU tensors, one thread per model shard) against the reference's
``get_backend("virtual:DxM")`` and its numpy backend, per instance: both
protocols × every static adversary × the keys, urn, urn2 and urn3 laws on
the meshes 2x2, 1x4 and 4x1, and the §9 partition and recover schedules
through the mesh. Tolerance 0: ``(rounds, decision)`` are integers of one
counter-based PRF."""

import dataclasses
import functools

import numpy as np
import pytest

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.backends import get_backend as ref_get_backend
from byzantinerandomizedconsensus_tpu_torch import get_backend
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.parallel.virtual import VirtualMeshBackend

MESHES = ("2x2", "1x4", "4x1")
ADVERSARIES = ("none", "crash", "byzantine", "adaptive", "adaptive_min")
LAWS = ("keys", "urn", "urn2", "urn3")
N = 12  # divisible by every mesh's model axis


def _cfg(protocol, adversary, law, faults="none", seed=0):
    lying = adversary in ("byzantine", "adaptive", "adaptive_min")
    f = (N - 1) // 3 if protocol == "bracha" else (N - 1) // (5 if lying else 2)
    return SimConfig(protocol=protocol, n=N, f=f, instances=6, adversary=adversary,
                     coin="local" if protocol == "benor" else "shared", delivery=law,
                     faults=faults, round_cap=8, seed=seed).validate()


@functools.lru_cache(maxsize=None)
def _reference(cfg, backend):
    res = ref_get_backend(backend).run(ref_config.SimConfig(**dataclasses.asdict(cfg)))
    return res.rounds, res.decision


def _assert_matches_reference(cfg, mesh):
    got = get_backend(f"virtual:{mesh}").run(cfg)
    for backend in (f"virtual:{mesh}", "numpy"):
        rounds, decision = _reference(cfg, backend)
        np.testing.assert_array_equal(got.rounds, rounds, err_msg=f"{backend} {cfg}")
        np.testing.assert_array_equal(got.decision, decision, err_msg=f"{backend} {cfg}")


GRID = [(p, a, law, i) for i, (p, a, law) in enumerate(
    (p, a, law) for p in ("benor", "bracha") for a in ADVERSARIES for law in LAWS)]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("protocol,adversary,law,seed", GRID,
                         ids=[f"{p}-{a}-{law}" for p, a, law, _ in GRID])
def test_virtual_mesh_matches_reference_virtual_and_numpy(protocol, adversary, law, seed,
                                                          mesh):
    _assert_matches_reference(_cfg(protocol, adversary, law, seed=seed), mesh)


FAULT_CASES = [("bracha", "byzantine", "urn2", "partition"),
               ("bracha", "adaptive", "keys", "partition"),
               ("benor", "crash", "keys", "recover"),
               ("bracha", "none", "urn3", "recover")]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("protocol,adversary,law,faults", FAULT_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}-{c[3]}" for c in FAULT_CASES])
def test_fault_schedules_run_through_the_virtual_mesh(protocol, adversary, law, faults,
                                                      mesh):
    """The §9 schedules run on the virtual mesh, as the reference's
    (tests/test_faults.py)."""
    _assert_matches_reference(_cfg(protocol, adversary, law, faults, seed=40), mesh)


def test_virtual_mesh_runs_a_subset_of_ids_and_more_data_shards_than_ids():
    cfg = _cfg("bracha", "adaptive", "urn2", seed=3)
    ids = np.array([5, 1, 4])
    got = VirtualMeshBackend(n_data=5, n_model=3).run(cfg, inst_ids=ids)
    rounds, decision = _reference(cfg, "numpy")
    np.testing.assert_array_equal(got.inst_ids, ids)
    np.testing.assert_array_equal(got.rounds, rounds[ids])
    np.testing.assert_array_equal(got.decision, decision[ids])


def test_virtual_mesh_refuses_a_model_axis_that_does_not_divide_n():
    with pytest.raises(ValueError, match="not divisible by model-axis size 5"):
        get_backend("virtual:1x5").run(_cfg("bracha", "none", "urn2"))


@pytest.mark.parametrize("faults", ["none", "omission"])
def test_committee_runs_through_the_virtual_mesh(faults):
    """The §10 committee family (membership silences, its own drop quota)
    on the virtual mesh, as the reference's."""
    cfg = SimConfig(protocol="bracha", n=32, f=6, instances=6, adversary="adaptive",
                    coin="shared", delivery="committee", faults=faults, round_cap=12,
                    seed=9).validate()
    _assert_matches_reference(cfg, "2x4")
