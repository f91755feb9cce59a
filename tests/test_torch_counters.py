"""The port's protocol counters (obs/counters.py), the counter side channel of
the round bodies, ``TorchBackend.run_with_counters``/``run_with_state`` and
the safety invariants (models/invariants.py), against the reference's
numpy backend and invariants on the same configs. Counters on must leave
(rounds, decision) bit-identical, and every total, per-instance row, state
plane and violation list must equal the reference's: tolerance 0."""

import dataclasses

import numpy as np
import pytest
import torch

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.backends import get_backend as ref_get_backend
from byzantinerandomizedconsensus_tpu.models import invariants as ref_invariants
from byzantinerandomizedconsensus_tpu.obs import counters as ref_counters
from byzantinerandomizedconsensus_tpu_torch import cli, get_backend, preset
from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import TorchBackend
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig, sweep_point
from byzantinerandomizedconsensus_tpu_torch.models import driver, invariants
from byzantinerandomizedconsensus_tpu_torch.models.delivery import make_counts
from byzantinerandomizedconsensus_tpu_torch.obs import counters, record
from byzantinerandomizedconsensus_tpu_torch.ops import keys_step

DELIVERIES = ("keys", "urn", "urn2", "urn3", "committee")
# The adversary grid of the reference's counter tests: (protocol, adversary,
# n, f), every static adversary, both protocols, n <= 16.
ADVERSARY_GRID = [
    ("bracha", "adaptive", 10, 3),
    ("bracha", "byzantine", 10, 3),
    ("bracha", "adaptive_min", 8, 2),
    ("benor", "byzantine", 7, 1),
    ("benor", "crash", 9, 4),
    ("benor", "none", 7, 2),
]
# The reference's preset shapes, instance counts cut: config1-3 and config 5's
# sweep shape.
PRESET_CASES = [
    ("config1", preset("config1")),
    ("config2", preset("config2", instances=32)),
    ("config3", preset("config3", instances=8)),
    ("config5", sweep_point(64, instances=8)),
]
FAULT_KINDS = ("recover", "partition", "omission")


def _ref(cfg):
    return ref_config.SimConfig(**dataclasses.asdict(cfg))


def _eq(a, b):
    return np.array_equal(a.rounds, b.rounds) and np.array_equal(a.decision, b.decision)


def _plain():
    return get_backend("torch", device="cpu")


def _check_against_reference(cfg):
    """Counters on == off, totals and per-instance rows == the reference's
    numpy backend; returns the port's document."""
    be = _plain()
    base = be.run(cfg)
    res, doc = be.run_with_counters(cfg)
    assert _eq(base, res), "counters moved the results"
    ref_res, ref_doc = ref_get_backend("numpy").run_with_counters(_ref(cfg))
    assert _eq(ref_res, res)
    assert doc["totals"] == ref_doc["totals"]
    assert list(doc["totals"]) == list(ref_counters.counter_names(_ref(cfg)))
    assert {k: v for k, v in doc.items() if k != "backend"} == \
        {k: v for k, v in ref_doc.items() if k != "backend"}
    # Per instance: the reference's (lo, hi) u32 pairs against the port's
    # int64 rows.
    ref_rows = ref_get_backend("numpy")._run_impl(_ref(cfg), None, False,
                                                  counters=True)[3].astype(np.uint64)
    rows = be._run_full(cfg, None, counters=True)[3]
    names = counters.counter_names(cfg)
    for c, name in enumerate(names):
        want = ref_rows[:, c, 0] + (ref_rows[:, c, 1] << np.uint64(32))
        assert np.array_equal(rows[:, c].astype(np.uint64), want), name
    assert doc["totals"]["rounds_active"] == int(base.rounds.sum())
    return doc


@pytest.mark.parametrize("name,cfg", PRESET_CASES, ids=[c[0] for c in PRESET_CASES])
def test_counters_invariant_and_equal_to_reference_on_presets(name, cfg):
    _check_against_reference(cfg)


@pytest.mark.parametrize("proto,adv,n,f", ADVERSARY_GRID,
                         ids=[f"{p}-{a}" for p, a, _, _ in ADVERSARY_GRID])
@pytest.mark.parametrize("delivery", DELIVERIES)
def test_counters_equal_to_reference_per_law_and_adversary(delivery, proto, adv, n, f):
    cfg = SimConfig(protocol=proto, n=n, f=f, instances=6, adversary=adv,
                    coin="shared", delivery=delivery, round_cap=32).validate()
    doc = _check_against_reference(cfg)
    # The oracle's message-level subset is the same count again.
    _, oracle_doc = get_backend("cpu").run_with_counters(cfg)
    assert {k: doc["totals"][k] for k in oracle_doc["totals"]} == oracle_doc["totals"]


@pytest.mark.parametrize("delivery", ("keys", "urn2", "committee"))
@pytest.mark.parametrize("fault", FAULT_KINDS)
def test_fault_counters_equal_to_reference(fault, delivery):
    cfg = SimConfig(protocol="bracha", n=8, f=2, instances=6, adversary="crash",
                    coin="local", seed=9, round_cap=48, delivery=delivery,
                    faults=fault).validate()
    doc = _check_against_reference(cfg)
    phases = counters.phase_names(cfg)
    sil = sum(doc["totals"][f"fault_silenced@{ph}"] for ph in phases)
    cut = sum(doc["totals"][f"fault_cut_pairs@{ph}"] for ph in phases)
    assert cut == 0 if fault != "partition" else sil == 0


def test_counter_names_equal_reference():
    for proto, adv, n, f in ADVERSARY_GRID:
        for delivery in DELIVERIES:
            for faults in ("none",) + FAULT_KINDS:
                cfg = SimConfig(protocol=proto, n=n, f=f, adversary=adv,
                                delivery=delivery, faults=faults)
                assert counters.counter_names(cfg) == \
                    ref_counters.counter_names(_ref(cfg))
    assert counters.COUNTER_SCHEMA_VERSION == ref_counters.COUNTER_SCHEMA_VERSION == 3
    assert counters.unsupported_doc("why") == ref_counters.unsupported_doc("why")


def test_sampler_cost_counter_laws():
    """§4b draws are the drop total, §4c words one per receiver-step, and
    the §4b-v2 chains sit in their deterministic corner under the adaptive
    strata."""
    def totals(adversary, delivery):
        cfg = SimConfig(protocol="bracha", n=16, f=5, instances=16, adversary=adversary,
                        coin="shared", delivery=delivery, round_cap=64).validate()
        return _plain().run_with_counters(cfg)[1]["totals"]

    t = totals("none", "urn")
    assert t["urn_draws"] == sum(v for k, v in t.items() if k.startswith("dropped@"))
    t = totals("none", "urn3")
    assert t["urn3_words"] == 3 * 16 * t["rounds_active"]
    balanced, adaptive = totals("none", "urn2"), totals("adaptive", "urn2")
    assert 0 < balanced["chain_trips_max"] <= 5
    assert balanced["chain_trips"] > 10 * adaptive["chain_trips"]


def test_accumulator_sums_max_merges_and_masks():
    cfg = preset("config1")
    names = counters.counter_names(cfg)
    acc = counters.zeros(cfg, 2)
    big = torch.full((2, len(names)), 0xFFFFFFFF, dtype=torch.int64)
    for _ in range(2):
        acc = counters.accumulate(acc, big, torch.tensor([True, True]), cfg)
    totals = counters.finalize(cfg, acc)
    for name in names:
        assert totals[name] == (0xFFFFFFFF if name == "chain_trips_max"
                                else 2 * 2 * 0xFFFFFFFF), name
    acc = counters.accumulate(counters.zeros(cfg, 2), torch.full_like(big, 7),
                              torch.tensor([True, False]), cfg)
    assert counters.finalize(cfg, acc)["rounds_active"] == 7


def test_kernels_and_mesh_raise_counters_unsupported_by_name():
    """No counter channel on the CUDA kernels or the mesh: they raise by
    name before any work, and never count the plain path instead."""
    cfg = preset("config1")
    for kernel in ("fused", "step"):
        be = TorchBackend(device="cpu")
        be.kernel = kernel  # the card's kernel choice, without a card
        for fn in (be.run_with_counters, be.run_with_state):
            with pytest.raises(counters.CountersUnsupported, match=f"kernel='{kernel}'"):
                fn(cfg)
    with pytest.raises(counters.CountersUnsupported, match="per-step delivery kernels"):
        driver.run_chunk_full(cfg, torch.arange(1, dtype=torch.int32),
                              counts_fn=keys_step.counts_fn, counters=True)
    with pytest.raises(counters.CountersUnsupported, match="per-step delivery kernels"):
        make_counts(cfg, 0, torch.arange(1), 0, {"faulty": None},
                    counts_fn=keys_step.counts_fn, obs={})
    for name in ("virtual:2x1", "native"):
        with pytest.raises(counters.CountersUnsupported, match=name.partition(":")[0]):
            get_backend(name).run_with_counters(cfg)
    doc = record.collect_counters(get_backend("virtual:2x1"), cfg)
    assert doc == {"schema": 3, "supported": False, "reason": doc["reason"]}


def test_cli_run_counters(capsys):
    import json

    argv = ["run", "--preset", "config3", "--instances", "6", "--device", "cpu"]
    assert cli.main(argv + ["--counters"]) == 0
    out = json.loads(capsys.readouterr().out)
    _, doc = _plain().run_with_counters(preset("config3", instances=6))
    assert out["counters"] == doc
    assert cli.main(argv) == 0
    plain = json.loads(capsys.readouterr().out)
    assert {k: v for k, v in out.items() if k not in ("counters", "wall_s",
                                                       "instances_per_sec")} == \
        {k: v for k, v in plain.items() if k not in ("wall_s", "instances_per_sec")}
    # A backend without a counter channel makes the run as asked and says why.
    assert cli.main(argv + ["--backend", "virtual:2x1", "--counters"]) == 0
    mesh = json.loads(capsys.readouterr().out)
    assert mesh["counters"]["supported"] is False and mesh["backend"] == "virtual:2x1"
    assert mesh["decision_histogram"] == plain["decision_histogram"]


RUN_WITH_STATE_CASES = [
    SimConfig(protocol="bracha", n=10, f=3, instances=7, adversary="adaptive",
              coin="shared", delivery="urn2", round_cap=32),
    SimConfig(protocol="benor", n=9, f=4, instances=7, adversary="crash",
              delivery="keys", round_cap=3),
    SimConfig(protocol="bracha", n=8, f=2, instances=7, adversary="byzantine",
              delivery="committee", faults="partition", round_cap=32),
]


@pytest.mark.parametrize("cfg", RUN_WITH_STATE_CASES,
                         ids=[f"{c.protocol}-{c.delivery}" for c in RUN_WITH_STATE_CASES])
def test_run_with_state_equals_reference(cfg):
    res, state, faulty = _plain().run_with_state(cfg)
    ref_res, ref_state, ref_faulty = ref_get_backend("numpy").run_with_state(_ref(cfg))
    assert _eq(ref_res, res)
    assert np.array_equal(faulty, ref_faulty)
    assert sorted(state) == sorted(ref_state)
    for k in state:
        assert state[k].dtype == ref_state[k].dtype, k
        assert np.array_equal(state[k], ref_state[k]), k


INVARIANT_GRID = [
    dict(protocol=p, n=n, f=f, adversary=a, delivery=d, faults=k, coin=c, instances=12,
         round_cap=24, seed=5)
    for p, a, n, f in ADVERSARY_GRID
    for d, k, c in (("urn2", "none", "shared"), ("keys", "recover", "local"),
                    ("urn", "omission", "shared"), ("urn3", "partition", "local"))
]


@pytest.mark.parametrize("kw", INVARIANT_GRID,
                         ids=[f"{k['protocol']}-{k['adversary']}-{k['delivery']}-{k['faults']}"
                              for k in INVARIANT_GRID])
def test_check_config_equals_reference(kw):
    cfg = SimConfig(**kw).validate()
    got = invariants.check_config(cfg, device="cpu")
    assert got == ref_invariants.check_config(_ref(cfg))
    assert got["checked_instances"] == cfg.instances


def test_state_violations_flag_what_the_reference_flags():
    """A corrupted state: disagreeing correct replicas, a broken validity
    basis and a wrong collapsed decision are each reported as the reference
    reports them."""
    cfg = SimConfig(protocol="bracha", n=10, f=3, instances=6, adversary="none",
                    init="all1", delivery="urn2").validate()
    res, state, faulty = _plain().run_with_state(cfg)
    state = {k: v.copy() for k, v in state.items()}
    state["decided_val"][0, 4] = 1 - state["decided_val"][0, 4]
    state["decided_val"][1, :] = 0
    res.decision[2] = 1 - res.decision[2]
    got = invariants.state_violations(cfg, state, faulty, res=res, inst_ids=res.inst_ids)
    want = ref_invariants.state_violations(_ref(cfg), state, faulty, res=res,
                                           inst_ids=res.inst_ids)
    assert got == want
    assert {v["kind"] for v in got} == {"agreement", "validity", "decision_consistency"}


def test_env_fingerprint_does_not_initialize_cuda():
    env = record.new_record("sweep")["env"]
    assert env["torch"] == torch.__version__ and env["native_abi"] == 5
    assert env["platform"] == "uninitialized"
    assert not torch.cuda.is_initialized()
