"""The port's fused round (ops/fused_round.py) and its whole slice against the
reference: ``run_chunk_plain`` against the reference's fused TPU kernel in
Pallas interpret mode on one 8-instance block, then ``get_backend("torch")``
on the CPU against ``get_backend("jax")`` at config4's n=512, f=170; the
surface gate; the default device; the CLI summary."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.backends.base import get_backend as ref_get_backend
from byzantinerandomizedconsensus_tpu_torch import cli, get_backend, preset
from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import TorchBackend
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.ops import fused_round
from byzantinerandomizedconsensus_tpu_torch.ops.fused_round import FusedUnsupported


def _ref(cfg):
    return ref_config.SimConfig(**dataclasses.asdict(cfg))


BLOCK_CASES = [
    SimConfig(protocol="bracha", n=4, f=1, instances=8, coin="shared",
              init="random", seed=3, delivery="urn2"),
    SimConfig(protocol="bracha", n=7, f=2, instances=8, coin="local",
              init="split", seed=11, delivery="urn2"),
    SimConfig(protocol="bracha", n=13, f=4, instances=8, coin="local",
              init="random", seed=2, round_cap=2, delivery="urn2"),
    SimConfig(protocol="bracha", n=16, f=3, instances=8, coin="shared",
              init="all1", seed=5, delivery="urn2"),
    SimConfig(protocol="bracha", n=10, f=2, instances=8, coin="local",
              init="random", seed=1, delivery="urn2"),   # n - f even: ties
]


@pytest.mark.parametrize("cfg", BLOCK_CASES,
                         ids=[f"n{c.n}-f{c.f}-{c.coin}-{c.init}-cap{c.round_cap}"
                              for c in BLOCK_CASES])
def test_plain_round_driver_matches_reference_fused_kernel(cfg, pallas_interpret):
    """One 8-instance block through the reference's fused Pallas kernel
    (interpret mode on the CPU) and through the port's plain driver."""
    assert pallas_interpret, "the reference kernel runs in interpret mode here"
    cfg = cfg.validate()
    want = ref_get_backend("jax_fused").run(_ref(cfg))
    rounds, decision = fused_round.run_chunk_plain(
        cfg, torch.arange(cfg.instances, dtype=torch.int32))
    assert rounds.dtype == torch.int32 and decision.dtype == torch.uint8
    np.testing.assert_array_equal(rounds.numpy(), want.rounds)
    np.testing.assert_array_equal(decision.numpy(), want.decision)


def test_capped_block_reports_round_cap_and_decision_2(pallas_interpret):
    cfg = BLOCK_CASES[2].validate()
    rounds, decision = fused_round.run_chunk_plain(
        cfg, torch.arange(cfg.instances, dtype=torch.int32))
    capped = decision == 2
    assert bool(capped.any()), "the case must reach the cap"
    assert bool((rounds[capped] == cfg.round_cap).all())


def test_config4_slice_matches_reference_backend():
    """The whole slice at n=512, f=170: config4 on 32 instance ids spread
    over the whole id range, through each package's backend."""
    cfg = preset("config4")
    ids = np.sort(np.random.default_rng(4).choice(cfg.instances, 32, replace=False))
    ids[-1] = cfg.instances - 1
    want = ref_get_backend("jax").run(ref_config.preset("config4"), inst_ids=ids)
    got = get_backend("torch", device="cpu").run(cfg, inst_ids=ids)
    assert got.rounds.dtype == np.int32 and got.decision.dtype == np.uint8
    np.testing.assert_array_equal(got.inst_ids, want.inst_ids)
    np.testing.assert_array_equal(got.rounds, want.rounds)
    np.testing.assert_array_equal(got.decision, want.decision)


def test_chunked_dispatch_pads_the_tail(monkeypatch):
    """Chunks of 5 over 12 ids (the tail padded with its last id) give the
    same rows as one chunk."""
    cfg = SimConfig(protocol="bracha", n=7, f=2, instances=64, coin="local",
                    seed=8, delivery="urn2").validate()
    ids = np.arange(3, 15)
    backend = TorchBackend(device="cpu")
    whole = backend.run(cfg, inst_ids=ids)
    monkeypatch.setattr(backend, "chunk_size", lambda cfg: 5)
    chunked = backend.run(cfg, inst_ids=ids)
    np.testing.assert_array_equal(chunked.rounds, whole.rounds)
    np.testing.assert_array_equal(chunked.decision, whole.decision)
    assert len(chunked.rounds) == 12
    empty = backend.run(cfg, inst_ids=np.array([], dtype=np.int64))
    assert empty.rounds.shape == (0,) and empty.decision.shape == (0,)


def test_run_chunk_on_a_cpu_tensor_runs_the_plain_version():
    cfg = BLOCK_CASES[0].validate()
    ids = torch.arange(8, dtype=torch.int32)
    before = fused_round.launches
    rounds, decision = fused_round.run_chunk(cfg, ids)
    assert fused_round.launches == before, "no kernel launch on the CPU"
    pr, pd = fused_round.run_chunk_plain(cfg, ids)
    assert torch.equal(rounds, pr) and torch.equal(decision, pd)


def test_plain_driver_counts_the_work_of_running_instances():
    cfg = preset("config4")
    stats = {}
    rounds, _ = fused_round.run_chunk_plain(
        cfg, torch.arange(16, dtype=torch.int32), stats=stats)
    assert stats["instance_rounds"] == int(rounds.sum())
    assert 0 < stats["chain_seeds"] <= stats["instance_rounds"] * cfg.n * 6
    assert stats["chain_trips"] >= stats["chain_seeds"]


UNSUPPORTED = [
    (dict(protocol="benor", n=7, f=2), "protocol='benor'"),
    (dict(delivery="urn"), "delivery='urn'"),
    (dict(delivery="urn3"), "delivery='urn3'"),
    (dict(delivery="keys"), "delivery='keys'"),
    (dict(adversary="crash"), "adversary='crash'"),
    (dict(adversary="byzantine"), "adversary='byzantine'"),
    (dict(adversary="adaptive"), "adversary='adaptive'"),
    (dict(adversary="adaptive_min"), "adversary='adaptive_min'"),
    (dict(faults="recover"), "faults='recover'"),
    (dict(faults="partition"), "faults='partition'"),
    (dict(faults="omission"), "faults='omission'"),
    (dict(n=1025, f=341, instances=64), "n=1025"),
]


@pytest.mark.parametrize("fields,named", UNSUPPORTED, ids=[u[1] for u in UNSUPPORTED])
def test_unsupported_surface_raises_fused_unsupported_by_name(fields, named):
    base = dict(protocol="bracha", n=16, f=5, instances=64, delivery="urn2")
    cfg = SimConfig(**{**base, **fields}).validate()
    calls = [lambda: fused_round.check_fused_supported(cfg),
             lambda: fused_round.run_chunk_plain(cfg, torch.zeros(1, dtype=torch.int32))]
    if cfg.delivery in ("keys", "urn"):
        # The plain backend runs these laws on the per-step surface.
        assert len(TorchBackend(device="cpu").run(cfg, inst_ids=[0]).rounds) == 1
    else:
        calls.append(lambda: TorchBackend(device="cpu").run(cfg))
    for call in calls:
        with pytest.raises(FusedUnsupported) as e:
            call()
        assert named in str(e.value)
        assert "surface is protocol in ('bracha',)" in str(e.value)


def test_default_device_is_cuda():
    """Entry points run on the card unless the CPU is asked for; with no card
    they raise rather than fall back."""
    if torch.cuda.is_available():
        backend = TorchBackend()
        assert backend.device.type == "cuda"
        assert backend.kernel_for(preset("config4")) == "fused"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBackend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_backend("torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run", "--preset", "config4", "--instances", "4"])


def test_fused_kernel_on_the_cpu_is_refused():
    with pytest.raises(ValueError, match="kernel='fused'"):
        TorchBackend(kernel="fused", device="cpu")
    with pytest.raises(ValueError, match="unknown kernel"):
        TorchBackend(kernel="xla", device="cpu")
    assert TorchBackend(device="cpu").kernel == "plain"


def test_cli_run_prints_the_reference_summary_keys(capsys):
    """``cli run`` on the CPU prints the reference ``run`` summary keys, with
    the histograms of the reference backend on the same instances."""
    assert cli.main(["run", "--preset", "config4", "--instances", "12",
                     "--device", "cpu", "--hist"]) == 0
    out = json.loads(capsys.readouterr().out)
    from byzantinerandomizedconsensus_tpu.utils import metrics as ref_metrics

    ref = ref_get_backend("jax").run(ref_config.preset("config4", instances=12))
    want = ref_metrics.summary(ref)
    assert set(want) <= set(out)
    for k in ("decision_histogram", "mean_rounds_decided", "max_rounds",
              "rounds_p50", "rounds_p90", "rounds_p99", "decided", "instances"):
        assert out[k] == want[k], k
    assert out["round_histogram"] == ref_metrics.round_histogram(ref).tolist()
    assert out["kernel"] == "plain" and out["device"] == "cpu"
    assert out["instances_per_sec"] > 0
