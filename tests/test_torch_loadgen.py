"""The port's load generator (tools/loadgen.py) against the reference on
the CPU.

The request stream is the reference's, draw for draw: at seeds 14 and 15
(200 requests, rate 4) the same arrivals, configs and session slots, and
the same digests (seed 15's is committed in
``artifacts/serve_fleet_migrate_r23.json``). A small ``cli loadgen`` on
the CPU (the lane leg) writes a valid record with 0 steady-state builds
and 0 mismatches, and every reply it served, session slots included,
equals the reference's numpy run of the same request. The card's direct
leg is pinned by law without a card: which kernel and library each
request of the default stream takes, and what a named kernel leaves out.
With the card asked for and none present, every entry point exits
nonzero naming it.
"""

import collections
import dataclasses
import json
import pathlib

import pytest
import torch

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.backends import get_backend as ref_get_backend
from byzantinerandomizedconsensus_tpu.models import session as ref_session
from byzantinerandomizedconsensus_tpu.obs import record as ref_record
from byzantinerandomizedconsensus_tpu.tools import loadgen as ref_loadgen
from byzantinerandomizedconsensus_tpu_torch import cli
from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import TorchBackend
from byzantinerandomizedconsensus_tpu_torch.obs import record
from byzantinerandomizedconsensus_tpu_torch.serve import fleet as fleet_mod
from byzantinerandomizedconsensus_tpu_torch.tools import loadgen

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _doc(stream):
    return [(t, dataclasses.asdict(c), s) for t, c, s in stream]


@pytest.mark.parametrize("seed", [14, 15])
def test_stream_equals_the_references_draw_for_draw(seed):
    got = loadgen.request_stream(200, seed, 4.0)
    want = ref_loadgen.request_stream(200, seed, 4.0)
    assert _doc(got) == _doc(want)
    assert loadgen.stream_digest(got) == ref_loadgen.stream_digest(want)


def test_seed_15_digest_is_the_committed_one():
    committed = json.loads((ROOT / "artifacts/serve_fleet_migrate_r23.json").read_text())
    assert loadgen.stream_digest(loadgen.request_stream(200, 15, 4.0)) == \
        committed["stream_digest"]


def test_seed_14_population_as_the_reference_draws_it():
    stream = loadgen.request_stream(200, 14, 4.0)
    laws = collections.Counter(c.delivery for _, c, _ in stream)
    assert laws == {"keys": 104, "urn3": 28, "committee": 26, "urn2": 23, "urn": 19}
    assert sum(c.faults != "none" for _, c, _ in stream) == 71
    assert sum(s > 1 for *_, s in stream) == 19
    assert max(c.n for _, c, _ in stream) <= 40
    assert max(c.instances for _, c, _ in stream) <= 64
    assert round(stream[-1][0], 1) == 51.5


@pytest.mark.parametrize("seed,n", [(35, 40), (7, 120), (3, 24)])
def test_stream_determinism_and_fleet_invariance_as_the_reference(seed, n):
    a = loadgen.request_stream(n, seed, 4.0)
    assert loadgen.stream_digest(a) == loadgen.stream_digest(loadgen.request_stream(n, seed, 4.0))
    assert loadgen.stream_digest(a) != loadgen.stream_digest(
        loadgen.request_stream(n, seed + 1, 4.0))
    times = [t for t, _, _ in a]
    assert all(t1 > t0 for t0, t1 in zip(times, times[1:]))
    digests = {k: loadgen.stream_digest(loadgen.fleet_request_stream(n, seed, 4.0, workers=k))
               for k in (1, 2, 4)}
    assert set(digests.values()) == {loadgen.stream_digest(a)}
    for _, cfg, slots in a:
        assert cfg.round_cap <= loadgen.ROUND_CAP_CEILING and 1 <= slots <= 8
    with pytest.raises(ValueError):
        loadgen.fleet_request_stream(n, seed, 4.0, workers=0)


def test_generator_constants_equal_the_reference():
    for name in ("GENERATOR_VERSION", "ROUND_CAP_CEILING", "_MIX", "_SESSION_RATE",
                 "_SESSION_SLOTS", "_SESSION_BENCH_POLICY"):
        assert getattr(loadgen, name) == getattr(ref_loadgen, name), name
    assert sum(1 for *_, s in loadgen.request_stream(40, 35, 4.0) if s > 1) == 7
    mutated = [(t, c, s + (i == 0)) for i, (t, c, s) in
               enumerate(loadgen.request_stream(40, 35, 4.0))]
    assert loadgen.stream_digest(mutated) != loadgen.stream_digest(
        loadgen.request_stream(40, 35, 4.0))
    from byzantinerandomizedconsensus_tpu.serve import admission as ref_admission
    from byzantinerandomizedconsensus_tpu_torch.serve import admission

    for _, cfg, _ in loadgen.request_stream(24, 14, 4.0):
        got = loadgen._warm_bucket_config(admission.bucket_of(cfg), 3)
        want = ref_loadgen._warm_bucket_config(
            ref_admission.bucket_of(ref_config.SimConfig(**dataclasses.asdict(cfg))), 3)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [dataclasses.asdict(c) for c in loadgen._session_population(3, 21)] == \
        [dataclasses.asdict(c) for c in ref_loadgen._session_population(3, 21)]


def _card(kernel=None):
    """A card backend's kernel choice, without a card: only its pure
    methods are called."""
    be = TorchBackend.__new__(TorchBackend)
    be.kernel, be.device = kernel, torch.device("cuda")
    return be


def test_direct_leg_takes_the_kernels_by_law_on_the_default_stream():
    stream = loadgen.request_stream(200, 14, 4.0)
    card = _card()
    kernels = collections.Counter(card.kernel_for(c) for _, c, _ in stream)
    assert kernels == {"fused": 96, "step": 89, "plain": 15}
    assert all(c.delivery == "keys" and c.faults != "none"
               for _, c, _ in stream if card.kernel_for(c) == "plain")
    libs = collections.Counter(loadgen.library_of(card, c) for _, c, _ in stream)
    assert libs == {"keys_step": 88, "fused_round_urn3_r1": 28,
                    "fused_round_committee_r1": 26, "fused_round": 23,
                    "fused_round_urn_r1": 19, None: 15, "keys_step_wide": 1}
    warm = loadgen.library_configs(card, [c for _, c, _ in stream])
    assert sorted(loadgen.library_of(card, c) for c in warm) == sorted(k for k in libs if k)
    served, unsupported = loadgen.supported_split(card, stream)
    assert len(served) == 200 and unsupported == {}


def test_a_named_kernel_leaves_out_what_it_does_not_run_by_name():
    stream = loadgen.request_stream(24, 14, 4.0)
    served, unsupported = loadgen.supported_split(_card("step"), stream)
    assert len(served) == 11
    assert unsupported == {"StepFaultsUnsupported: keys/faults=omission": 1,
                           "StepFaultsUnsupported: keys/faults=recover": 1,
                           "StepFaultsUnsupported: urn/faults=partition": 3,
                           "StepFaultsUnsupported: urn2/faults=omission": 2,
                           "StepUnsupported: urn3/faults=none": 6}
    assert all(c.delivery in ("keys", "urn") and c.faults == "none" for _, c, _ in served)
    served, unsupported = loadgen.supported_split(_card("fused"), stream)
    assert all(c.delivery != "keys" for _, c, _ in served)
    assert sum(unsupported.values()) == sum(c.delivery == "keys" for _, c, _ in stream)


def _ref_digest(cfg, slots):
    """The reply digest of the reference's numpy run of one request (its
    session log, slot by slot, when it has one)."""
    ref_cfg = ref_config.SimConfig(**dataclasses.asdict(cfg))
    numpy_be = ref_get_backend("numpy")
    res = numpy_be.run(ref_cfg)
    rec = {"rounds": [int(r) for r in res.rounds], "decision": [int(d) for d in res.decision]}
    if slots > 1:
        runs = ref_session.run_session(numpy_be, ref_cfg, slots)
        rec["session"] = {"rounds": [[int(r) for r in x.rounds] for x in runs],
                          "decisions": [[int(d) for d in x.decision] for x in runs]}
    return loadgen.reply_digest(rec)


def test_cli_loadgen_on_the_cpu_serves_the_references_replies(tmp_path, capsys):
    out = tmp_path / "serve.json"
    assert cli.main(["loadgen", "--smoke", "--device", "cpu", "--no-offline",
                     "--rate", "50", "--requests", "12", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert record.validate_record(doc) == []
    assert ref_record.validate_record(doc) == []
    assert doc["leg"] == "lanes" and doc["device"] == "cpu" and doc["unsupported"] == {}
    assert doc["serve"]["steady_state_compiles"] == 0
    assert doc["differential"]["mismatches"] == 0 and doc["failed"] == []
    assert doc["launches"] == {"fused_round": 0, "keys_step": 0, "urn_step": 0}
    stream = loadgen.request_stream(12, 14, 50.0)
    assert doc["stream_digest"] == ref_loadgen.stream_digest(
        ref_loadgen.request_stream(12, 14, 50.0))
    assert doc["differential"]["sessions_replayed"] == sum(s > 1 for *_, s in stream)
    assert doc["differential"]["reply_digests"] == [_ref_digest(c, s) for _, c, s in stream]
    assert "steady-state builds 0" in capsys.readouterr().out


class _ThreadFleet(fleet_mod.FleetServer):
    """The fleet leg's FleetServer with in-process workers (no spawn)."""

    def __init__(self, **kw):
        kw["mode"] = "thread"
        super().__init__(**kw)


def test_fleet_mode_differential_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(fleet_mod, "FleetServer", _ThreadFleet)
    out = tmp_path / "fleet.json"
    assert loadgen.main(["--workers", "1,2", "--requests", "6", "--rate", "50",
                         "--device", "cpu", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert record.validate_record(doc) == []
    assert doc["differential"]["mismatches"] == 0
    assert doc["differential"]["compared"] == 6 * 3  # x1 burst, x2 burst and open loop
    assert doc["fleet"]["steady_state_compiles"] == 0
    assert doc["workers_swept"] == [1, 2]


@pytest.mark.parametrize("argv", [
    ["loadgen", "--smoke"],
    ["loadgen", "--smoke", "--workers", "1,2"],
    ["loadgen", "--session-bench"],
    ["loadgen", "--scenario", "bucket_churn", "--smoke"],
    ["loadgen", "--scenario", "elastic", "--smoke"],
])
def test_no_card_no_fallback(argv, capsys, tmp_path):
    assert cli.main(argv + ["--out", str(tmp_path / "x.json")]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "x.json").exists()


def test_a_kernel_the_cpu_cannot_run_is_refused_by_name(capsys):
    assert loadgen.main(["--smoke", "--device", "cpu", "--kernel", "step"]) == 2
    assert "kernel='step'" in capsys.readouterr().err


def test_help_names_the_load_drivers(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    text = capsys.readouterr().out
    assert "loadgen" in text and "chaos" in text
