"""The final per-replica state of a served run, on every kernel.

K1 hands back its final state words (``csrc/fused_round.cu`` and the wide
kernel's ``state_out``; the scratch plane past n = 4096) and the wrapper's
plain version (``ops/fused_round.py::run_chunk_plain(state=True)``) gives the
same plane: each instance's state as its own loop left it. Here on the CPU:

- the plain plane, decoded, against the reference's numpy
  ``run_with_state`` run one instance at a time (a one-instance chunk ends
  with its instance, as a CTA does), on every field of every replica;
- ``TorchBackend.run_with_state`` on ``fused`` and ``step`` (their CPU
  fallbacks: the wrappers run their plain versions on CPU tensors) against
  the plain driver;
- the vectorised ``models/invariants.py::state_violations`` against the
  reference's per-instance loop, on hand-made violating states and on the
  states of 300 sampler configs;
- a checked reply of the server's direct leg: its ``invariants`` block
  equals the reference server's, and the config ran once.

The host builds of the kernels' loops write the same plane
(``tests/test_torch_kernel_host.py``, ``test_torch_fused_faults.py``,
``test_torch_fused_laws.py``); ``chip_smoke.py`` phase 18 (iv) holds K1's
plane against this plain one on the card. Integers compare exactly.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.backends import get_backend as ref_get_backend
from byzantinerandomizedconsensus_tpu.models import invariants as ref_invariants
from byzantinerandomizedconsensus_tpu.serve.server import ConsensusServer as RefServer
from byzantinerandomizedconsensus_tpu_torch.backends.base import SimResult
from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import TorchBackend
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig, preset
from byzantinerandomizedconsensus_tpu_torch.models import invariants
from byzantinerandomizedconsensus_tpu_torch.ops import fused_round
from byzantinerandomizedconsensus_tpu_torch.serve.server import ConsensusServer
from byzantinerandomizedconsensus_tpu_torch.tools import sampler

TIMEOUT = 60.0
FIELDS = ("est", "decided", "decided_val", "phase")


def _ref(cfg):
    return ref_config.SimConfig(**dataclasses.asdict(cfg))


def _per_instance_reference(cfg, ids):
    """The reference's numpy state of each instance alone, stacked: the
    state at the instance's own end."""
    be = ref_get_backend("numpy")
    parts = [be.run_with_state(_ref(cfg), np.array([i]))[1] for i in ids]
    return {k: np.concatenate([p[k] for p in parts]) for k in FIELDS}


STATE_CASES = [
    dataclasses.replace(preset("config4"), instances=6),
    SimConfig(protocol="bracha", n=13, f=4, instances=8, adversary="none", coin="local",
              delivery="urn2", round_cap=16, seed=3),
    SimConfig(protocol="benor", n=16, f=5, instances=8, adversary="crash", coin="shared",
              delivery="urn2", round_cap=24, seed=4),
    SimConfig(protocol="bracha", n=13, f=4, instances=8, adversary="byzantine",
              coin="shared", delivery="urn2", round_cap=24, seed=5),
    SimConfig(protocol="benor", n=16, f=3, instances=8, adversary="adaptive", coin="shared",
              delivery="urn2", round_cap=24, seed=6),
    SimConfig(protocol="bracha", n=16, f=5, instances=8, adversary="adaptive_min",
              coin="local", delivery="urn2", round_cap=4, seed=7),
    SimConfig(protocol="bracha", n=16, f=5, instances=8, adversary="crash", coin="shared",
              delivery="urn2", faults="recover", round_cap=24, seed=8),
    SimConfig(protocol="benor", n=16, f=3, instances=8, adversary="byzantine", coin="local",
              delivery="urn", round_cap=24, seed=9),
    SimConfig(protocol="bracha", n=13, f=4, instances=8, adversary="adaptive",
              coin="shared", delivery="urn3", round_cap=24, seed=10),
    SimConfig(protocol="bracha", n=64, f=12, instances=6, adversary="crash", coin="shared",
              delivery="committee", round_cap=24, seed=11),
]


@pytest.mark.parametrize("cfg", STATE_CASES,
                         ids=[f"{c.protocol}-{c.adversary}-{c.delivery}-{c.faults}-n{c.n}"
                              for c in STATE_CASES])
def test_plain_state_plane_equals_the_reference_per_instance(cfg):
    cfg = cfg.validate()
    ids = np.arange(cfg.instances)
    rounds, decision, words = fused_round.run_chunk_plain(
        cfg, torch.as_tensor(ids, dtype=torch.int32), state=True)
    assert words.dtype == torch.int32 and tuple(words.shape) == (len(ids), cfg.n)
    got = fused_round.decode_state(words)
    want = _per_instance_reference(cfg, ids)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    ref = ref_get_backend("numpy").run(_ref(cfg), ids)
    np.testing.assert_array_equal(rounds.numpy(), ref.rounds)
    np.testing.assert_array_equal(decision.numpy(), ref.decision)


def test_state_word_mask_clears_only_the_between_step_bits():
    """The wide kernel's scratch words carry a step's honest value (bits
    5-6) and the membership bit (7); the plane the wrapper hands back has
    them cleared and every other field intact."""
    word = torch.tensor([[(37 << 8) | (1 << 7) | (2 << 5) | (1 << 3) | (1 << 2) | 1]],
                        dtype=torch.int32)
    got = fused_round.decode_state(word & fused_round.STATE_WORD_MASK)
    assert [int(got[k][0, 0]) for k in FIELDS] == [1, 1, 1, 37]
    assert int(word & fused_round.STATE_WORD_MASK) == (37 << 8) | (1 << 3) | (1 << 2) | 1


def _kernel_backend(kernel):
    be = TorchBackend(device="cpu")
    be.kernel = kernel  # the card's kernel choice, its wrappers' CPU fallbacks
    return be


@pytest.mark.parametrize("cfg", [
    SimConfig(protocol="bracha", n=16, f=5, instances=10, adversary="byzantine",
              coin="shared", delivery="keys", round_cap=24, seed=21),
    SimConfig(protocol="benor", n=13, f=2, instances=10, adversary="crash", coin="local",
              delivery="urn", round_cap=24, seed=22),
], ids=["keys", "urn"])
def test_run_with_state_on_step_equals_the_plain_driver(cfg):
    got = _kernel_backend("step").run_with_state(cfg)
    want = TorchBackend(device="cpu").run_with_state(cfg)
    np.testing.assert_array_equal(got[0].rounds, want[0].rounds)
    np.testing.assert_array_equal(got[0].decision, want[0].decision)
    np.testing.assert_array_equal(got[2], want[2])
    for k in FIELDS:
        np.testing.assert_array_equal(got[1][k], want[1][k], err_msg=k)


@pytest.mark.parametrize("cfg", [
    SimConfig(protocol="bracha", n=16, f=5, instances=12, adversary="crash", coin="local",
              delivery="urn2", faults="omission", round_cap=24, seed=31),
    SimConfig(protocol="benor", n=16, f=3, instances=12, adversary="adaptive_min",
              coin="shared", delivery="urn3", round_cap=24, seed=32),
    SimConfig(protocol="bracha", n=10, f=3, instances=12, adversary="none", coin="shared",
              delivery="urn", round_cap=24, seed=33),
], ids=["urn2-crash-omission", "urn3-adaptive_min", "urn-none"])
def test_run_with_state_on_fused_equals_the_plain_driver(cfg):
    """The fused leg's state is each instance's at its own end: equal to
    the plain driver on every correct replica (a finished instance's faulty
    replicas may run on in the plain chunk), to the frozen plain plane
    everywhere, with the same faulty plane and the same verdicts."""
    cfg = cfg.validate()
    res, state, faulty = _kernel_backend("fused").run_with_state(cfg)
    pres, pstate, pfaulty = TorchBackend(device="cpu").run_with_state(cfg)
    np.testing.assert_array_equal(res.rounds, pres.rounds)
    np.testing.assert_array_equal(res.decision, pres.decision)
    np.testing.assert_array_equal(faulty, pfaulty)
    correct = ~faulty
    for k in FIELDS:
        np.testing.assert_array_equal(state[k][correct], pstate[k][correct], err_msg=k)
    frozen = _per_instance_reference(cfg, np.arange(cfg.instances))
    for k in FIELDS:
        np.testing.assert_array_equal(state[k], frozen[k], err_msg=k)
    assert invariants.state_violations(cfg, state, faulty, res=res) == \
        invariants.state_violations(cfg, pstate, pfaulty, res=pres)


def _violating(cfg, seed):
    """A state of ``cfg``'s shape with frequent violations of every kind,
    and a result whose decisions and rounds are drawn to disagree."""
    rng = np.random.default_rng(seed)
    B, n = cfg.instances, cfg.n
    decided = rng.random((B, n)) < 0.7
    dval = rng.integers(0, 2, (B, n)).astype(np.uint8)
    agree = rng.random(B) < 0.5
    dval[agree] = rng.integers(0, 2, int(agree.sum()))[:, None].astype(np.uint8)
    full = rng.random(B) < 0.4
    decided[full] = True
    faulty = rng.random((B, n)) < 0.2
    faulty[:, 0] &= rng.random(B) < 0.5
    state = {"est": rng.integers(0, 2, (B, n)).astype(np.uint8), "decided": decided,
             "decided_val": dval, "phase": rng.integers(0, 9, (B, n)).astype(np.int32)}
    res = SimResult(config=cfg, inst_ids=np.arange(B),
                    rounds=rng.integers(1, cfg.round_cap + 1, B).astype(np.int32),
                    decision=rng.integers(0, 3, B).astype(np.uint8))
    return state, faulty, res


def test_vectorised_violations_equal_the_reference_on_sampler_configs():
    rng = random.Random(18)
    kinds = set()
    for k in range(300):
        cfg = sampler.random_config(rng, chaos=bool(k % 2))
        cfg = dataclasses.replace(cfg, instances=min(cfg.instances, 24)).validate()
        state, faulty, res = _violating(cfg, k)
        ids = np.arange(cfg.instances) * 3 + k
        got = invariants.state_violations(cfg, state, faulty, res=res, inst_ids=ids)
        want = ref_invariants.state_violations(_ref(cfg), state, faulty, res=res,
                                               inst_ids=ids)
        assert got == want, cfg
        kinds |= {v["kind"] for v in got}
        assert invariants.state_violations(cfg, state, faulty) == \
            ref_invariants.state_violations(_ref(cfg), state, faulty)
    assert kinds == {"agreement", "validity", "decision_consistency"}


@pytest.mark.parametrize("lying", [False, True])
def test_vectorised_violations_flag_hand_made_states(lying):
    """Disagreeing correct replicas, a decision against a unanimous initial
    estimate, a collapsed decision that is not the first correct replica's,
    and a faulty replica's disagreement, which is no violation."""
    cfg = SimConfig(protocol="bracha", n=6, f=1, instances=5, init="all1",
                    adversary="byzantine" if lying else "crash", coin="shared",
                    delivery="urn2", round_cap=16).validate()
    B, n = cfg.instances, cfg.n
    decided = np.ones((B, n), dtype=bool)
    dval = np.ones((B, n), dtype=np.uint8)
    faulty = np.zeros((B, n), dtype=bool)
    faulty[:, 5] = True
    dval[0, 2] = 0                      # agreement and validity
    dval[1, 5] = 0                      # a faulty replica: nothing
    dval[2, :] = 0                      # validity against the all-ones start
    decided[3, 4] = False               # not done: no consistency check
    res = SimResult(config=cfg, inst_ids=np.arange(B),
                    rounds=np.array([3, 3, 3, 3, 16], dtype=np.int32),
                    decision=np.array([1, 1, 0, 0, 0], dtype=np.uint8))
    res.decision[4] = 0                 # capped: no consistency check either
    state = {"est": np.ones((B, n), np.uint8), "decided": decided, "decided_val": dval,
             "phase": np.zeros((B, n), np.int32)}
    got = invariants.state_violations(cfg, state, faulty, res=res)
    assert got == ref_invariants.state_violations(_ref(cfg), state, faulty, res=res)
    assert [(v["instance"], v["kind"]) for v in got] == [
        (0, "agreement"), (0, "validity"), (2, "validity")]
    res.decision[1] = 0
    got = invariants.state_violations(cfg, state, faulty, res=res)
    assert got == ref_invariants.state_violations(_ref(cfg), state, faulty, res=res)
    assert (1, "decision_consistency") in [(v["instance"], v["kind"]) for v in got]


class _Counting(TorchBackend):
    """The fused leg's choice on CPU tensors (the wrapper's plain fallback),
    counting how each config is run."""

    def __init__(self):
        super().__init__(device="cpu")
        self.kernel = "fused"
        self.runs, self.state_runs = [], []

    def run(self, cfg, inst_ids=None):
        self.runs.append(cfg)
        return super().run(cfg, inst_ids)

    def run_with_state(self, cfg, inst_ids=None):
        self.state_runs.append(cfg)
        return super().run_with_state(cfg, inst_ids)


def test_direct_leg_checks_the_served_runs_own_state(monkeypatch):
    """Each checked request runs once, through ``run_with_state``; its
    ``invariants`` block equals the reference server's; an unchecked one
    runs through ``run``; nothing runs ``check_config`` again."""
    def no_rerun(*a, **kw):
        raise AssertionError("the direct leg re-ran a checked config")

    monkeypatch.setattr(invariants, "check_config", no_rerun)
    cfgs = [SimConfig(protocol="bracha", n=7, f=2, instances=6, adversary="byzantine",
                      coin="shared", delivery="urn2", round_cap=32, seed=41).validate(),
            SimConfig(protocol="benor", n=9, f=2, instances=5, adversary="crash",
                      coin="local", delivery="urn3", faults="partition", round_cap=32,
                      seed=42).validate(),
            SimConfig(protocol="bracha", n=10, f=3, instances=4, adversary="none",
                      init="all0", coin="local", delivery="urn", round_cap=32,
                      seed=43).validate()]
    be = _Counting()
    with ConsensusServer(be) as srv:
        assert srv.leg == "direct"
        recs = [srv.submit(c, check_invariants=True).wait(timeout=TIMEOUT) for c in cfgs]
        plain = srv.submit(cfgs[0]).wait(timeout=TIMEOUT)
    assert be.state_runs == cfgs and be.runs == [cfgs[0]]
    assert "invariants" not in plain
    for cfg, rec in zip(cfgs, recs):
        assert rec["invariants"] == RefServer._invariant_summary(_ref(cfg))
        assert rec["invariants"]["checked_instances"] == cfg.instances
