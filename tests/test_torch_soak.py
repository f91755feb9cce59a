"""The port's seeded config sampler (tools/sampler.py) and randomized
differential soak (tools/soak.py) against the reference on the CPU.

The sampler draws, for every ``(seed, chaos)``, the same configs field for
field as the reference's. The soak's classic leg (the plain torch driver
on the CPU against the C++ core, with the object-oracle subsample) finds
no mismatch and reports one instead of raising; the chaos leg runs the
plain driver with the full state and the §1 invariants, per instance equal
to the reference's numpy ``run_with_state``, in two real subprocesses (the
device leg recorded as none on the CPU). The crash and hang drill stays
``slow``, as the reference marks it. Every subprocess has its own timeout.
"""

import dataclasses
import json
import random
import shutil

import numpy as np
import pytest

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.backends import get_backend as ref_get_backend
from byzantinerandomizedconsensus_tpu.models import invariants as ref_invariants
from byzantinerandomizedconsensus_tpu.tools import sampler as ref_sampler
from byzantinerandomizedconsensus_tpu.tools import soak as ref_soak
from byzantinerandomizedconsensus_tpu_torch import cli
from byzantinerandomizedconsensus_tpu_torch.backends import get_backend
from byzantinerandomizedconsensus_tpu_torch.config import DELIVERY_KINDS, FAULT_KINDS
from byzantinerandomizedconsensus_tpu_torch.models import invariants
from byzantinerandomizedconsensus_tpu_torch.tools import sampler, soak

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")


@pytest.mark.parametrize("seed", [0, 7, 123, 2 ** 31 + 5])
@pytest.mark.parametrize("chaos", [False, True])
def test_sampler_draws_the_references_population(seed, chaos):
    rng, ref_rng = random.Random(seed), random.Random(seed)
    for _ in range(300):
        got = sampler.random_config(rng, chaos=chaos)
        want = ref_sampler.random_config(ref_rng, chaos=chaos)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert rng.random() == ref_rng.random()  # the draw sequences stay in step


def test_sampler_constants_and_soak_reexports_equal_the_reference():
    for name in ("GENERATOR_VERSION", "MAX_SOAK_N", "_PROTOCOLS", "_ADVERSARIES",
                 "_COINS", "_INITS", "_CHAOS_WINDOWS", "_ROUND_CAPS", "_INSTANCES_RANGE"):
        assert getattr(sampler, name) == getattr(ref_sampler, name), name
    assert soak.random_config is sampler.random_config
    assert soak._f_ceiling is sampler._f_ceiling
    assert soak.MAX_SOAK_N == ref_soak.MAX_SOAK_N
    assert (soak.CHAOS_TIMEOUT_S, soak.CHAOS_BACKOFF_S) == \
        (ref_soak.CHAOS_TIMEOUT_S, ref_soak.CHAOS_BACKOFF_S)
    for protocol in ("benor", "bracha"):
        for adversary in sampler._ADVERSARIES:
            for n in range(4, 41):
                assert sampler._f_ceiling(protocol, adversary, n) == \
                    ref_sampler._f_ceiling(protocol, adversary, n)


@pytest.mark.parametrize("chaos", [False, True])
def test_generator_emits_valid_configs_over_the_whole_surface(chaos):
    rng = random.Random(7)
    deliveries, faults = set(), set()
    for _ in range(80):
        cfg = soak.random_config(rng, chaos=chaos)
        assert cfg.n <= soak.MAX_SOAK_N and cfg.pack_version == 1
        assert cfg.crash_window >= 1
        deliveries.add(cfg.delivery)
        faults.add(cfg.faults)
    assert deliveries == set(DELIVERY_KINDS)
    assert faults == (set(FAULT_KINDS) if chaos else {"none"})


@needs_gxx
def test_small_soak_zero_mismatches():
    doc = soak.run_soak(8, seed=123, oracle_every=4, oracle_instances=2,
                        progress=lambda *a: None, device="cpu")
    assert doc["configs"] == 8 and doc["chaos"] is False
    assert doc["oracle_subsampled_configs"] == 2
    assert doc["mismatches"] == []
    assert doc["kernels"] == {"plain": 8}
    assert set(doc["legs"]) == {"vectorized", "arbiter", "oracle"}
    ref = ref_soak.run_soak(8, seed=123, oracle_every=4, oracle_instances=2,
                            progress=lambda *a: None)
    for key in ("by_delivery", "by_adversary", "generator_version",
                "oracle_subsampled_configs"):
        assert doc[key] == ref[key], key


@needs_gxx
def test_soak_reports_mismatch_instead_of_raising(monkeypatch):
    real = get_backend("native").run

    class Liar:
        name = "native"

        def run(self, cfg, inst_ids=None):
            res = real(cfg, inst_ids)
            res.rounds[0] += 1
            return res

    monkeypatch.setattr(soak, "get_backend",
                        lambda name, **kw: Liar() if name == "native"
                        else get_backend(name, **kw))
    doc = soak.run_soak(3, seed=5, oracle_every=100, progress=lambda *a: None,
                        device="cpu")
    assert len(doc["mismatches"]) == 3
    for m in doc["mismatches"]:
        assert m["leg"] == "torch_vs_native"
        assert m["first_divergent_instance"] == 0 and m["n_differing"] >= 1
        at = m["at_first_divergence"]
        assert at["native"]["rounds"] == at["torch"]["rounds"] + 1
        for leg in ("torch", "native"):
            assert len(m[leg]["rounds"]) == m["config"]["instances"]


@pytest.mark.parametrize("k", range(6))
def test_chaos_plain_leg_equals_the_references_numpy_with_state(k):
    """The chaos child's plain leg, per instance and per replica, against
    the reference's numpy ``run_with_state`` on the same sampled config,
    and the same §1 verdicts."""
    rng = random.Random(11)
    cfgs = [soak.random_config(rng, chaos=True) for _ in range(6)]
    cfg = dataclasses.replace(cfgs[k], instances=min(cfgs[k].instances, 12))
    res, state, faulty = get_backend("torch", device="cpu", kernel="plain") \
        .run_with_state(cfg)
    ref_cfg = ref_config.SimConfig(**dataclasses.asdict(cfg))
    rres, rstate, rfaulty = ref_get_backend("numpy").run_with_state(ref_cfg)
    assert res.rounds.tolist() == rres.rounds.tolist()
    assert res.decision.tolist() == rres.decision.tolist()
    assert np.array_equal(faulty, rfaulty)
    for key in rstate:
        assert np.array_equal(np.asarray(state[key]), np.asarray(rstate[key])), key
    assert invariants.state_violations(cfg, state, faulty, res=res,
                                       inst_ids=res.inst_ids) == \
        ref_invariants.state_violations(ref_cfg, rstate, rfaulty, res=rres,
                                        inst_ids=rres.inst_ids) == []


def test_chaos_child_records_no_device_leg_on_the_cpu():
    rng = random.Random(3)
    cfg = soak.random_config(rng, chaos=True)
    rec = soak.run_child(dataclasses.asdict(cfg), 2, device="cpu")
    assert rec["status"] == "ok" and rec["violations"] == []
    assert rec["device_leg"] == "none (cpu)"
    assert rec["oracle_instances"] == 2
    assert rec["checked_instances"] == cfg.instances


def test_two_config_chaos_children_in_subprocesses(tmp_path):
    doc = soak.run_soak(2, seed=123, oracle_every=1, oracle_instances=2, chaos=True,
                        timeout_s=300, jobs=2, checkpoint=str(tmp_path / "ck.json"),
                        trace_dir=str(tmp_path / "tr"), progress=lambda *a: None,
                        device="cpu")
    assert doc["mismatches"] == [] and doc["violations"] == [] and doc["skipped"] == []
    assert doc["kernels"] == {"none (cpu)": 2}
    assert doc["oracle_subsampled_configs"] == 2
    assert doc["legs"]["device"] == "none (cpu)"
    assert doc["trace"]["digest"]["chaos.config"]["count"] == 2
    ref_rng = random.Random(123)
    ref_cfgs = [ref_sampler.random_config(ref_rng, chaos=True) for _ in range(2)]
    assert doc["by_faults"] == {k: sum(c.faults == k for c in ref_cfgs) for k in FAULT_KINDS}
    # the checkpoint resumes both without a subprocess
    again = soak.run_soak(2, seed=123, oracle_every=1, oracle_instances=2, chaos=True,
                          checkpoint=str(tmp_path / "ck.json"), progress=lambda *a: None,
                          device="cpu")
    assert again["resumed_configs"] == 2 and again["skipped"] == []


@pytest.mark.slow
def test_chaos_survives_crash_and_hang_and_resumes(tmp_path):
    ck = str(tmp_path / "ck.json")
    doc = soak.run_soak(2, seed=7, oracle_every=100, chaos=True, timeout_s=20,
                        backoff_s=0.05, checkpoint=ck, inject={0: "crash", 1: "hang"},
                        progress=lambda *a: None, device="cpu")
    assert len(doc["skipped"]) == 2
    assert all(s["attempts"] == 2 for s in doc["skipped"])
    errs = " ".join(s["error"] for s in doc["skipped"])
    assert "exit 139" in errs and "timeout" in errs
    doc2 = soak.run_soak(2, seed=7, oracle_every=100, chaos=True, timeout_s=300,
                         backoff_s=0.05, checkpoint=ck, progress=lambda *a: None,
                         device="cpu")
    assert doc2["resumed_configs"] == 0 and doc2["skipped"] == []
    doc3 = soak.run_soak(2, seed=7, oracle_every=100, chaos=True, timeout_s=300,
                         checkpoint=ck, progress=lambda *a: None, device="cpu")
    assert doc3["resumed_configs"] == 2


def test_chaos_checkpoint_rejects_other_population(tmp_path):
    ck = tmp_path / "ck.json"
    soak._save_checkpoint(ck, seed=1, records={"0": {"status": "ok"}})
    assert soak._load_checkpoint(ck, seed=1) == {"0": {"status": "ok"}}
    assert soak._load_checkpoint(ck, seed=2) == {}
    ck.write_text("{ torn")
    assert soak._load_checkpoint(ck, seed=1) == {}


@pytest.mark.parametrize("argv", [["chaos", "--configs", "2"],
                                  ["chaos", "--configs", "2", "--device", "cuda:0"]])
def test_chaos_without_a_card_exits_nonzero_by_name(argv, capsys):
    assert cli.main(argv + ["--out", "/dev/null"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        soak.run_soak(1, chaos=True)


def test_compile_cache_is_refused_by_name(capsys, tmp_path):
    assert soak.main(["--chaos", "--configs", "1", "--device", "cpu",
                      "--compile-cache", str(tmp_path), "--out", str(tmp_path / "x")]) == 2
    assert "--compile-cache" in capsys.readouterr().err
    assert not (tmp_path / "x").exists()


@needs_gxx
def test_soak_cli_writes_the_record(tmp_path, capsys):
    out = tmp_path / "soak.json"
    assert soak.main(["--configs", "3", "--seed", "4", "--device", "cpu",
                      "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["configs"] == 3 and doc["mismatches"] == [] and doc["device"] == "cpu"
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["mismatches"] == 0
