"""The port's fused round (ops/fused_round.py) and its whole slice against the
reference: ``run_chunk_plain`` against the reference's fused TPU kernel in
Pallas interpret mode on one 8-instance block, for every (protocol,
adversary) pair of the kernel's surface, then ``get_backend("torch")`` on
the CPU against ``get_backend("jax")`` at config4's n=512, f=170, the four
urn2 goldens and config1 and config3 as shipped; the surface gate; the
default device; the CLI summary and ``product``."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.backends.base import get_backend as ref_get_backend
from byzantinerandomizedconsensus_tpu_torch import cli, get_backend, preset
from byzantinerandomizedconsensus_tpu_torch import config as config_module
from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import TorchBackend
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.ops import fused_round, prf
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


# One block per (protocol, adversary) pair other than (bracha, none), with a
# capped block and blocks whose instances include a faulty replica 0.
ADVERSARY_BLOCK_CASES = [
    SimConfig(protocol="bracha", n=10, f=3, instances=8, adversary="crash",
              coin="shared", seed=10, delivery="urn2"),
    SimConfig(protocol="bracha", n=16, f=5, instances=8, adversary="byzantine",
              coin="local", seed=4, round_cap=3, delivery="urn2"),
    SimConfig(protocol="bracha", n=13, f=4, instances=8, adversary="adaptive",
              coin="shared", seed=3, delivery="urn2"),
    SimConfig(protocol="bracha", n=13, f=4, instances=8, adversary="adaptive_min",
              coin="local", seed=8, round_cap=16, delivery="urn2"),
    SimConfig(protocol="benor", n=7, f=3, instances=8, adversary="none",
              coin="local", seed=2, round_cap=32, delivery="urn2"),
    SimConfig(protocol="benor", n=16, f=7, instances=8, adversary="crash",
              coin="local", seed=6, round_cap=32, delivery="urn2"),
    SimConfig(protocol="benor", n=16, f=3, instances=8, adversary="byzantine",
              coin="local", seed=3, round_cap=32, delivery="urn2"),
    SimConfig(protocol="benor", n=11, f=2, instances=8, adversary="adaptive",
              coin="shared", seed=5, round_cap=32, delivery="urn2"),
    SimConfig(protocol="benor", n=16, f=3, instances=8, adversary="adaptive_min",
              coin="shared", seed=7, round_cap=32, delivery="urn2"),
]


@pytest.mark.parametrize("cfg", ADVERSARY_BLOCK_CASES,
                         ids=[f"{c.protocol}-{c.adversary}-n{c.n}-{c.coin}-cap{c.round_cap}"
                              for c in ADVERSARY_BLOCK_CASES])
def test_plain_round_driver_matches_reference_fused_kernel_per_adversary(
        cfg, pallas_interpret):
    """One 8-instance block of each new (protocol, adversary) pair through
    the reference's fused Pallas kernel (interpret mode) and the port's plain
    driver."""
    assert pallas_interpret, "the reference kernel runs in interpret mode here"
    cfg = cfg.validate()
    want = ref_get_backend("jax_fused").run(_ref(cfg))
    rounds, decision = fused_round.run_chunk_plain(
        cfg, torch.arange(cfg.instances, dtype=torch.int32))
    np.testing.assert_array_equal(rounds.numpy(), want.rounds)
    np.testing.assert_array_equal(decision.numpy(), want.decision)


def test_adversary_block_cases_reach_a_faulty_replica_zero_and_the_cap():
    """The per-adversary blocks above include instances whose replica 0 is
    faulty, and one capped block."""
    zero = 0
    for cfg in ADVERSARY_BLOCK_CASES:
        planes = fused_round.adversary_planes(
            cfg.validate(), torch.arange(8, dtype=torch.int32), prf.seed_key(cfg.seed))
        assert (planes[0] is None) == (cfg.adversary == "none")
        assert (planes[1] is None) == (cfg.adversary != "crash")
        if planes[0] is not None:
            assert planes[0].dtype == torch.uint8 and tuple(planes[0].shape) == (8, cfg.n)
            zero += int(planes[0][:, 0].sum())
    assert zero >= 3
    _, decision = fused_round.run_chunk_plain(ADVERSARY_BLOCK_CASES[1].validate(),
                                              torch.arange(8, dtype=torch.int32))
    assert bool((decision == 2).any())


# The urn2 goldens of spec/golden/golden.npz (configs of spec/golden/regen.py).
URN2_GOLDENS = {
    "urn2_benor_byz": dict(protocol="benor", n=16, f=3, adversary="byzantine",
                           coin="local", seed=9),
    "urn2_bracha_crash": dict(protocol="bracha", n=10, f=3, adversary="crash",
                              coin="shared", seed=10),
    "urn2_bracha_adaptive": dict(protocol="bracha", n=13, f=4, adversary="adaptive",
                                 coin="shared", seed=11),
    "urn2_bracha_adaptive_min": dict(protocol="bracha", n=13, f=4,
                                     adversary="adaptive_min", coin="shared", seed=12),
}


@pytest.mark.parametrize("name", sorted(URN2_GOLDENS))
def test_urn2_goldens_per_instance(name):
    gold = np.load(pathlib.Path(__file__).resolve().parents[1] / "spec" / "golden"
                   / "golden.npz")
    cfg = SimConfig(instances=100, round_cap=64, delivery="urn2", **URN2_GOLDENS[name])
    res = get_backend("torch", device="cpu").run(cfg)
    np.testing.assert_array_equal(res.rounds, gold[f"{name}__rounds"])
    np.testing.assert_array_equal(res.decision, gold[f"{name}__decision"])


@pytest.mark.parametrize("name", ["config1", "config3"])
def test_shipped_presets_match_the_product_histograms(name):
    """config1 and config3 as shipped (all instances, round cap 256), on the
    CPU, against the reference's product run (artifacts/product_r5.json)."""
    prod = json.loads((pathlib.Path(__file__).resolve().parents[1] / "artifacts"
                       / "product_r5.json").read_text())[name]
    # One intra-op thread: beside other test workers, torch's thread pool
    # over (1000, 256) planes waits on busy cores for minutes.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = get_backend("torch", device="cpu").run(preset(name))
    finally:
        torch.set_num_threads(threads)
    assert cli.decision_histogram(res).tolist() == prod["decision_histogram"]
    assert cli.round_histogram(res).tolist() == prod["round_histogram"]


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
    (dict(delivery="urn"), "delivery='urn'"),
    (dict(delivery="urn3"), "delivery='urn3'"),
    (dict(delivery="keys"), "delivery='keys'"),
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
        assert ("surface is protocol in ('benor', 'bracha'), delivery in ('urn2',), "
                "adversary in ('none', 'crash', 'byzantine', 'adaptive', 'adaptive_min')"
                in str(e.value))


@pytest.mark.parametrize("protocol", ["benor", "bracha"])
def test_every_static_adversary_is_on_the_surface(protocol):
    """Both protocols under every static adversary pass the gate; the same
    configs under another delivery law or with a fault schedule are refused
    by name."""
    for adversary in fused_round.SUPPORTED["adversary"]:
        cfg = SimConfig(protocol=protocol, n=16, f=3, instances=64, adversary=adversary,
                        delivery="urn2").validate()
        fused_round.check_fused_supported(cfg)
        for other, named in ((dict(delivery="urn3"), "delivery='urn3'"),
                             (dict(faults="omission"), "faults='omission'")):
            with pytest.raises(FusedUnsupported, match=named):
                fused_round.check_fused_supported(dataclasses.replace(cfg, **other))


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


def test_cli_product_prints_the_shipped_configs(capsys, tmp_path):
    """``cli product`` on the CPU: each configuration as shipped, with the
    reference product run's summary keys and histograms."""
    out_file = tmp_path / "product.json"
    assert cli.main(["product", "--device", "cpu", "--configs", "config1", "--repeats", "2",
                     "--out", str(out_file)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert json.loads(out_file.read_text()) == out
    prod = json.loads((pathlib.Path(__file__).resolve().parents[1] / "artifacts"
                       / "product_r5.json").read_text())["config1"]
    got = out["config1"]
    for k in ("protocol", "n", "f", "adversary", "coin", "delivery", "instances", "decided",
              "undecided_at_cap", "round_cap", "mean_rounds_decided", "max_rounds",
              "decision_histogram", "round_histogram"):
        assert got[k] == prod[k], k
    assert got["kernel"] == "plain" and got["device"] == "cpu" and len(got["walls_s"]) == 2
    assert got["wall_s"] == min(got["walls_s"])
    assert set(cli.PRODUCT_CONFIGS) == {"config1", "config2", "config3", "config4", "config5"}


def test_trace_summary_of_a_chrome_trace():
    """``trace.summarize`` on a hand-made trace: the first marked run is
    left out, the busy share is the union of the device intervals inside
    the other runs' window, and time is summed by kernel name."""
    from byzantinerandomizedconsensus_tpu_torch import trace

    def mark(ts, dur):
        return {"name": trace.MARK, "cat": "user_annotation", "ts": ts, "dur": dur}

    def dev(name, ts, dur, cat="kernel"):
        return {"name": name, "cat": cat, "ts": ts, "dur": dur}

    events = [mark(0, 50), mark(100, 100), mark(200, 100),
              {"name": trace.MARK, "cat": "gpu_user_annotation", "ts": 100, "dur": 200},
              dev("k", 10, 20), dev("k", 110, 40), dev("k", 130, 40), dev("copy", 250, 10,
                                                                            "gpu_memcpy"),
              dev("late", 290, 50), {"name": "aten::add", "cat": "cpu_op", "ts": 120,
                                     "dur": 100}]
    out = trace.summarize(events, 2)
    assert out["host_ms_per_run"] == [0.1, 0.1]
    # Busy: [110, 170) + [250, 260) + [290, 300) = 80 of the window [100, 300).
    assert out["device_busy"] == pytest.approx(0.4) and out["device_idle"] == pytest.approx(0.6)
    assert out["device_events_per_run"] == 2.0
    assert out["device_ms_per_run_by_name"] == {"k": 0.04, "late": 0.025, "copy": 0.005}
    with pytest.raises(RuntimeError, match="1 of 2 runs"):
        trace.summarize(events[1:], 2)
    with pytest.raises(RuntimeError, match="no device event"):
        trace.summarize([e for e in events if e["cat"] == "user_annotation"], 2)


def test_cli_named_configs_and_trace_needs_the_card():
    assert cli.named_config("config2") == preset("config2")
    assert cli.named_config("config5@1024") == config_module.sweep_point(1024)
    keys = cli.named_config("config5@512/keys")
    assert keys.delivery == "keys" and keys.n == 512 and keys.adversary == "adaptive"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["trace", "--configs", "config1"])
