"""The port's config-5 sweep and its host stack (utils/checkpoint.py,
utils/sweep.py, utils/metrics.py, utils/multiseed.py, tools/acceptance.py)
and the CLI's ``sweep``, ``bitmatch`` and ``run --total-instances``,
against the reference's: the same shard files and arrays, the same
summaries less the wall fields, a resume from the reference's own full-size
checkpoint directory (``artifacts/sweep_urn2/``) without a backend call, and
the bit-match's exit codes. Tolerance 0 throughout."""

import dataclasses
import json
import pathlib
import shutil

import numpy as np
import pytest

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.backends import get_backend as ref_get_backend
from byzantinerandomizedconsensus_tpu.tools import acceptance as ref_acceptance
from byzantinerandomizedconsensus_tpu.utils import checkpoint as ref_checkpoint
from byzantinerandomizedconsensus_tpu.utils import metrics as ref_metrics
from byzantinerandomizedconsensus_tpu.utils import multiseed as ref_multiseed
from byzantinerandomizedconsensus_tpu.utils import sweep as ref_sweep
from byzantinerandomizedconsensus_tpu_torch import cli, get_backend, preset
from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import TorchBackend
from byzantinerandomizedconsensus_tpu_torch.config import SWEEP_NS, SimConfig, sweep_point
from byzantinerandomizedconsensus_tpu_torch.tools import acceptance
from byzantinerandomizedconsensus_tpu_torch.utils import checkpoint, metrics, multiseed, sweep

ROOT = pathlib.Path(__file__).resolve().parent.parent
SWEEP_DIR = ROOT / "artifacts" / "sweep_urn2"
SWEEP_SUMMARY = ROOT / "artifacts" / "sweep_urn2_summary.json"
WALL_FIELDS = ("wall_s", "instances_per_sec")
SMALL = dict(ns=(16, 24), instances=60, shard_instances=25)


def _ref(cfg):
    return ref_config.SimConfig(**dataclasses.asdict(cfg))


def _files(d):
    return sorted(p.name for p in pathlib.Path(d).glob("*.npz"))


def _strip(points):
    return {str(n): {k: v for k, v in s.items() if k not in WALL_FIELDS}
            for n, s in points.items()}


def _quiet(_msg):
    pass


def _count_runs(monkeypatch):
    """Record the instance ids of every TorchBackend.run call."""
    calls = []
    run = TorchBackend.run

    def counted(self, cfg, inst_ids=None):
        calls.append((cfg.n, None if inst_ids is None else (int(inst_ids[0]),
                                                             int(inst_ids[-1]) + 1)))
        return run(self, cfg, inst_ids)

    monkeypatch.setattr(TorchBackend, "run", counted)
    return calls


SHARD_NAME_CASES = [
    SimConfig(protocol="bracha", n=512, f=170, adversary="adaptive", coin="shared",
              delivery="urn2"),
    SimConfig(protocol="benor", n=64, f=21, adversary="crash", delivery="keys"),
    SimConfig(protocol="bracha", n=2048, f=682, adversary="adaptive", coin="shared",
              delivery="urn3", round_cap=128, seed=7),
    SimConfig(protocol="bracha", n=8192, f=1638, adversary="none", coin="shared",
              delivery="committee", seed=3),
]


@pytest.mark.parametrize("cfg", SHARD_NAME_CASES, ids=lambda c: f"{c.delivery}-n{c.n}")
def test_shard_name_equals_reference(cfg):
    for lo, hi in ((0, 500), (1500, 2000)):
        assert checkpoint.shard_name(cfg, lo, hi) == ref_checkpoint.shard_name(_ref(cfg), lo, hi)


def test_artifact_shards_are_named_as_shard_name_gives():
    names = _files(SWEEP_DIR)
    assert len(names) == 32
    want = sorted(checkpoint.shard_name(sweep_point(n), lo, lo + 500)
                  for n in SWEEP_NS for lo in range(0, 2000, 500))
    assert names == want


def test_sweep_equals_reference_sweep(tmp_path):
    """The port's sweep on the CPU writes the reference numpy sweep's files
    and arrays, and the same summaries less the wall fields; each side reads
    the other's shards."""
    got = sweep.run_sweep(tmp_path / "port", device="cpu", progress=_quiet, **SMALL)
    want = ref_sweep.run_sweep(tmp_path / "ref", backend="numpy", progress=_quiet, **SMALL)
    assert _strip(got) == _strip(want)
    names = _files(tmp_path / "port")
    assert names == _files(tmp_path / "ref") and len(names) == 6
    for name in names:
        a, b = np.load(tmp_path / "port" / name), np.load(tmp_path / "ref" / name)
        assert sorted(a.files) == sorted(b.files)
        for key in ("inst_ids", "rounds", "decision", "config"):
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key
        mine = checkpoint.load_shard(tmp_path / "ref" / name)
        theirs = ref_checkpoint.load_shard(tmp_path / "port" / name)
        assert dataclasses.asdict(mine.config) == dataclasses.asdict(theirs.config)
        assert np.array_equal(mine.rounds, theirs.rounds)


def test_resume_from_the_reference_checkpoint_runs_no_backend_call(tmp_path, monkeypatch):
    """A sweep into a copy of the reference's full-size checkpoint directory
    loads every shard; its points equal the reference's summary file."""
    out = tmp_path / "sweep"
    shutil.copytree(SWEEP_DIR, out)
    calls = _count_runs(monkeypatch)
    said = []
    points = sweep.run_sweep(out, device="cpu", progress=said.append)
    assert calls == [] and said == []
    want = json.loads(SWEEP_SUMMARY.read_text())
    assert sorted(want) == sorted(str(n) for n in points)
    for n, s in points.items():
        w = want[str(n)]
        common = (set(w) & set(s)) - set(WALL_FIELDS)
        assert {k: s[k] for k in common} == {k: w[k] for k in common}
        assert w["round_histogram_nonzero"] == {
            str(r): c for r, c in enumerate(s["round_histogram"]) if c}


def test_deleted_shard_is_recomputed_alone(tmp_path, monkeypatch):
    out = tmp_path / "sweep"
    first = sweep.run_sweep(out, device="cpu", progress=_quiet, **SMALL)
    victim = checkpoint.shard_name(sweep_point(24, instances=60), 25, 50)
    before = np.load(out / victim)["rounds"].copy()
    (out / victim).unlink()
    calls = _count_runs(monkeypatch)
    again = sweep.run_sweep(out, device="cpu", progress=_quiet, **SMALL)
    assert calls == [(24, (25, 50))]
    assert np.array_equal(np.load(out / victim)["rounds"], before)
    assert _strip(again) == _strip(first)
    calls.clear()
    sweep.run_sweep(out, device="cpu", progress=_quiet, **SMALL)
    assert calls == []


def test_stale_shards_warn_and_fresh_ones_do_not(tmp_path):
    out = tmp_path / "sweep"
    out.mkdir()
    for name in _files(SWEEP_DIR)[:2]:
        shutil.copy(SWEEP_DIR / name, out / name)
    said = []
    sweep._warn_stale_shards(out, "urn2", 256, said.append)
    assert said == []
    sweep._warn_stale_shards(out, "keys", 256, said.append)
    ref_said = []
    ref_sweep._warn_stale_shards(out, "keys", 256, ref_said.append)
    assert said == ref_said and len(said) == 1 and "different delivery" in said[0]
    (out / "bracha_n2048_f682_adaptive_shared_urn2_s0_i0-500.npz").write_bytes(b"")
    said.clear()
    sweep._warn_stale_shards(out, "urn2", 256, said.append)
    assert len(said) == 1 and "packing-version" in said[0]


def test_batched_sweep_raises_by_name(tmp_path):
    with pytest.raises(NotImplementedError, match="batched lane runner"):
        sweep.run_sweep(tmp_path, batched=True, device="cpu", progress=_quiet, **SMALL)
    assert not tmp_path.joinpath("sweep").exists() and _files(tmp_path) == []


def test_sweep_defaults_to_the_card(monkeypatch):
    """Without a card the default sweep backend raises rather than run on
    the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.run_sweep(pathlib.Path("unused"), progress=_quiet, **SMALL)


def test_run_large_equals_reference():
    cfg = SimConfig(protocol="bracha", n=10, f=3, instances=1, adversary="byzantine",
                    coin="shared", delivery="urn2", seed=11).validate()
    got, shards = multiseed.run_large(cfg, 45, shard_instances=20, device="cpu")
    want, ref_shards = ref_multiseed.run_large(_ref(cfg), 45, backend="numpy",
                                               shard_instances=20)
    assert [dataclasses.asdict(s) for s in shards] == \
        [dataclasses.asdict(s) for s in ref_shards]
    assert np.array_equal(got.rounds, want.rounds)
    assert np.array_equal(got.decision, want.decision)
    assert np.array_equal(got.inst_ids, want.inst_ids)
    assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)
    for x in (0, 1, 2**63, 2**64 - 1):
        assert multiseed.splitmix64(x) == ref_multiseed.splitmix64(x)


def test_metrics_equal_reference():
    cfg = preset("config2", instances=120)
    res = get_backend("torch", device="cpu").timed_run(cfg)
    ref_res = ref_get_backend("numpy").timed_run(_ref(cfg))
    ref_res.wall_s = res.wall_s
    s = metrics.summary(res, chunk=64)
    assert s == ref_metrics.summary(ref_res, chunk=64)
    assert np.array_equal(metrics.round_histogram(res), ref_metrics.round_histogram(ref_res))
    for values, qs in ((res.rounds, (50, 90, 99, 100)), ([], (50,)), ([3, 1, 2], (1, 34))):
        assert metrics.percentiles(values, qs) == ref_metrics.percentiles(values, qs)
    for chunk in (1, 7, 120, 1000):
        assert metrics.wasted_lane_fraction(res.rounds, chunk) == \
            ref_metrics.wasted_lane_fraction(res.rounds, chunk)
        assert metrics.mean_max_rounds_per_chunk(res.rounds, chunk) == \
            ref_metrics.mean_max_rounds_per_chunk(res.rounds, chunk)


def test_sample_ids_and_compare_results_equal_reference():
    cfg = preset("config4")
    for samples, seed in ((300, 0), (5, 17), (200_000, 1)):
        assert np.array_equal(acceptance.sample_ids(cfg, samples, seed=seed),
                              ref_acceptance.sample_ids(_ref(cfg), samples, seed=seed))
    assert np.array_equal(acceptance.sample_ids(cfg, 9, tag="config4:urn2"),
                          ref_acceptance.sample_ids(_ref(cfg), 9, tag="config4:urn2"))
    with pytest.raises(ValueError, match="exactly one"):
        acceptance.sample_ids(cfg, 3)
    a = get_backend("torch", device="cpu").run(preset("config1", instances=5))
    assert acceptance.compare_results(a, a) == {"match": True, "mismatches": 0}


def test_cli_sweep_resumes_and_prints_the_record(tmp_path, capsys):
    argv = ["sweep", "--out", str(tmp_path), "--ns", "16", "--instances", "30",
            "--shard-instances", "10", "--device", "cpu", "--delivery", "urn2"]
    assert cli.main(argv) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["kind"] == "sweep" and out["record_version"] == 1
    assert out["backend"] == "torch" and out["delivery"] == "urn2"
    assert out["points"]["16"]["instances"] == 30 and len(_files(tmp_path)) == 3
    assert cli.main(argv) == 0
    again = json.loads(capsys.readouterr().out)
    assert _strip(again["points"]) == _strip(out["points"])


@pytest.mark.parametrize("arbiter", ("cpu", "native"))
def test_cli_bitmatch_passes_against_each_arbiter(arbiter, capsys):
    argv = ["bitmatch", "--protocol", "bracha", "-n", "16", "-f", "5", "--instances", "64",
            "--adversary", "adaptive", "--coin", "shared", "--delivery", "urn2",
            "--samples", "12", "--device", "cpu", "--arbiter", arbiter]
    assert cli.main(argv) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["bitmatch"] is True and out["mismatches"] == 0 and out["n_samples"] == 12
    assert out["arbiter"] == arbiter and out["kernel"] == "plain"
    assert out["arbiter_rounds"] == out["backend_rounds"]


def test_cli_bitmatch_widens_a_small_preset(capsys):
    assert cli.main(["bitmatch", "--preset", "config1", "--samples", "9", "--device", "cpu",
                     "--arbiter", "native"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["instances"] == 9 and out["samples"] == list(range(9))


@pytest.mark.parametrize("backend,arbiter", (("cpu", "cpu"), ("native:2", "native")))
def test_cli_bitmatch_refuses_the_arbiter_against_itself(backend, arbiter, capsys):
    assert cli.main(["bitmatch", "--preset", "config1", "--backend", backend,
                     "--arbiter", arbiter]) == 2
    assert "different" in capsys.readouterr().err


def test_cli_bitmatch_fails_on_a_mismatch(monkeypatch, capsys):
    run = TorchBackend.run

    def off_by_one(self, cfg, inst_ids=None):
        res = run(self, cfg, inst_ids)
        res.rounds = res.rounds.copy()
        res.rounds[1] += 1
        return res

    monkeypatch.setattr(TorchBackend, "run", off_by_one)
    assert cli.main(["bitmatch", "--preset", "config1", "--samples", "5", "--device", "cpu",
                     "--arbiter", "cpu"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["bitmatch"] is False and out["mismatches"] == 1


def test_cli_run_total_instances(capsys):
    argv = ["run", "--preset", "config3", "--instances", "1", "--device", "cpu",
            "--total-instances", "70"]
    cfg = preset("config3", instances=1)
    want, shards = multiseed.run_large(cfg, 70, device="cpu")
    assert cli.main(argv) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["instances"] == 70 and out["seeds"] == [s.seed for s in shards]
    assert out["decision_histogram"] == metrics.decision_histogram(want).tolist()
    assert cli.main(argv + ["--counters"]) == 2


def test_cli_run_summary_keys_stay_the_same(capsys):
    assert cli.main(["run", "--preset", "config1", "--device", "cpu", "--hist"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert list(out) == [
        "protocol", "n", "f", "adversary", "coin", "delivery", "faults", "seed", "instances",
        "decided", "decided_fraction", "undecided_at_cap", "round_cap",
        "mean_rounds_decided", "max_rounds", "rounds_p50", "rounds_p90", "rounds_p99",
        "decision_histogram", "wall_s", "instances_per_sec", "backend", "device", "kernel",
        "round_histogram"]
