"""The urn step (ops/urn_step.py) and the spec-§4b urn law of the port
(ops/urn.py) against the reference: per broadcast step through the real
round bodies, against both the reference's XLA urn path and its Pallas
kernel (ops/pallas_urn.py) in interpret mode; the class state, strata and
draw count; the driver against ``get_backend("jax")``; the urn goldens;
config 5 at n=512 against the committed sweep results; the surface gate."""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from test_torch_keys_step import _ref, assert_rounds_equal, port_rounds, ref_rounds

from byzantinerandomizedconsensus_tpu.backends.base import get_backend as ref_get_backend
from byzantinerandomizedconsensus_tpu.ops import urn as ref_urn
from byzantinerandomizedconsensus_tpu_torch import get_backend
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig, sweep_point
from byzantinerandomizedconsensus_tpu_torch.ops import urn, urn_step
from byzantinerandomizedconsensus_tpu_torch.ops._step import StepUnsupported

# The bracha adaptive row of tests/test_pallas_step.py::URN_STEP (two
# rounds), and the tile-boundary shapes n=128 and n=200 under the other two
# adversaries.
URN_STEP = [
    (SimConfig(protocol="bracha", n=16, f=5, instances=8, adversary="adaptive",
               coin="shared", round_cap=8, seed=5, delivery="urn"), 2),
    (SimConfig(protocol="bracha", n=128, f=42, instances=4, adversary="adaptive_min",
               coin="local", round_cap=4, seed=3, delivery="urn"), 1),
    (SimConfig(protocol="bracha", n=200, f=66, instances=4, adversary="none",
               coin="shared", init="all0", round_cap=4, seed=4, delivery="urn"), 1),
]


@pytest.mark.parametrize("cfg,n_rounds", URN_STEP,
                         ids=[f"n{c.n}f{c.f}-{c.adversary}" for c, _ in URN_STEP])
def test_urn_steps_match_reference_xla_and_pallas(cfg, n_rounds, pallas_interpret):
    """The port's urn hook (the plain version on the CPU) and its default urn
    path, through the port's round body, equal the reference's XLA urn path
    and its Pallas kernel through the reference's round body."""
    from byzantinerandomizedconsensus_tpu.ops import pallas_urn

    cfg = cfg.validate()
    xla = ref_rounds(cfg, None, n_rounds)
    pallas = ref_rounds(cfg, functools.partial(pallas_urn.counts_fn,
                                               interpret=pallas_interpret), n_rounds)
    assert_rounds_equal(pallas, xla, "reference pallas vs xla")
    assert_rounds_equal(port_rounds(cfg, urn_step.counts_fn, n_rounds), xla, "hook")
    assert_rounds_equal(port_rounds(cfg, None, n_rounds), xla, "default urn path")


def _planes(rng, B, n):
    inst = rng.choice(1000, B, replace=False).astype(np.int32)
    honest = rng.integers(0, 3, (B, n)).astype(np.uint8)
    faulty = rng.random((B, n)) < 0.3
    minority = rng.integers(0, 2, (B, 1)).astype(np.uint8)
    values = np.where(faulty, minority, honest).astype(np.uint8)
    silent = rng.random((B, n)) < 0.2
    return inst, honest, values, silent, faulty


@pytest.mark.parametrize("adversary", ["none", "adaptive", "adaptive_min"])
@pytest.mark.parametrize("n,f", [(10, 3), (64, 21), (512, 170)])
def test_counts_strata_and_draws_match_reference(adversary, n, f):
    """One step on random planes (faulty senders on the wire with a value of
    their own, so honest != values): class state, strata, (c0, c1) and the
    ``urn_draws`` counter against the reference's ops/urn.py."""
    cfg = SimConfig(protocol="bracha", n=n, f=f, instances=1000,
                    adversary=adversary, delivery="urn").validate()
    rng = np.random.default_rng(n + len(adversary))
    inst, honest, values, silent, faulty = _planes(rng, 4, n)
    t = (torch.as_tensor(values), torch.as_tensor(silent), torch.as_tensor(faulty),
         torch.as_tensor(honest))
    own, m, st, L, D = urn.lane_setup(cfg, *t)
    _, w_own, w_m, w_st, w_L, w_D = ref_urn.lane_setup(
        _ref(cfg), 9, inst.astype(np.uint32), 2, 1, values, silent, faulty, honest, xp=np)
    for got, want in [(own, w_own), (L, w_L), (D, w_D)] + list(zip(m, w_m)):
        np.testing.assert_array_equal(got.numpy(), want)
    if adversary == "none":
        assert st is None
    else:
        for s, w in zip(st, w_st):
            np.testing.assert_array_equal(np.broadcast_to(s.numpy(), (4, n)),
                                          np.broadcast_to(w, (4, n)))
    stats, ref_stats = {}, {}
    c0, c1 = urn_step.step_counts_plain(cfg, 9, torch.as_tensor(inst), 2, 1, *t,
                                        stats=stats)
    w0, w1 = ref_urn.counts_fn(_ref(cfg), 9, inst.astype(np.uint32), 2, 1, values,
                               silent, faulty, honest, xp=np, stats=ref_stats)
    np.testing.assert_array_equal(c0.numpy(), w0)
    np.testing.assert_array_equal(c1.numpy(), w1)
    np.testing.assert_array_equal(stats["urn_draws"].numpy(),
                                  ref_stats["urn_draws"].astype(np.int64))
    k0, k1 = urn_step.step_counts(cfg, 9, torch.as_tensor(inst), 2, 1, *t)
    assert torch.equal(k0, c0) and torch.equal(k1, c1)


URN_DRIVER = [
    SimConfig(protocol="bracha", n=7, f=2, instances=24, adversary="none",
              coin="local", seed=3, delivery="urn"),
    SimConfig(protocol="bracha", n=10, f=3, instances=24, adversary="adaptive",
              coin="shared", init="split", seed=4, delivery="urn"),
    SimConfig(protocol="bracha", n=16, f=5, instances=24, adversary="adaptive_min",
              coin="shared", seed=5, delivery="urn"),
]


@pytest.mark.parametrize("cfg", URN_DRIVER, ids=[c.adversary for c in URN_DRIVER])
def test_cpu_backend_matches_reference_backend(cfg):
    cfg = cfg.validate()
    want = ref_get_backend("jax").run(_ref(cfg))
    got = get_backend("torch", device="cpu").run(cfg)
    np.testing.assert_array_equal(got.rounds, want.rounds)
    np.testing.assert_array_equal(got.decision, want.decision)


@pytest.mark.parametrize("name,fields", [
    ("urn_bracha_adaptive", dict(adversary="adaptive", seed=6)),
    ("urn_bracha_adaptive_min", dict(adversary="adaptive_min", seed=8)),
])
def test_urn_goldens(name, fields):
    """spec/golden/golden.npz, with the configs of spec/golden/regen.py."""
    cfg = SimConfig(protocol="bracha", n=13, f=4, instances=100, coin="shared",
                    round_cap=64, delivery="urn", **fields).validate()
    gold = np.load("spec/golden/golden.npz")
    res = get_backend("torch", device="cpu").run(cfg)
    np.testing.assert_array_equal(res.rounds, gold[f"{name}__rounds"])
    np.testing.assert_array_equal(res.decision, gold[f"{name}__decision"])


def test_config5_n512_matches_the_committed_sweep_results():
    """Config 5's sweep point at full width under urn, on a handful of ids,
    against artifacts/sweep_urn (the reference's per-instance results)."""
    z = np.load("artifacts/sweep_urn/bracha_n512_f170_adaptive_shared_urn_s0_i0-2000.npz")
    assert np.array_equal(z["inst_ids"], np.arange(2000))
    pick = np.array([0, 1, 7, 512, 1337, 1999])
    cfg = dataclasses.replace(sweep_point(512), delivery="urn").validate()
    res = get_backend("torch", device="cpu").run(cfg, inst_ids=pick)
    np.testing.assert_array_equal(res.rounds, z["rounds"][pick])
    np.testing.assert_array_equal(res.decision, z["decision"][pick])


@pytest.mark.parametrize("fields,named", [
    (dict(protocol="benor", n=7, f=1), "protocol='benor'"),
    (dict(adversary="crash"), "adversary='crash'"),
    (dict(adversary="byzantine"), "adversary='byzantine'"),
    (dict(faults="omission"), "faults='omission'"),
    (dict(n=1536, f=511), "n=1536"),
], ids=["benor", "crash", "byzantine", "faults", "n1536"])
def test_unsupported_surface_raises_step_unsupported_by_name(fields, named):
    cfg = SimConfig(**{**dict(protocol="bracha", n=16, f=5, instances=64,
                              delivery="urn"), **fields}).validate()
    ids = torch.zeros(1, dtype=torch.int32)
    planes = [torch.zeros((1, cfg.n), dtype=torch.uint8) for _ in range(4)]
    for call in (lambda: urn_step.step_counts(cfg, 0, ids, 0, 0, *planes),
                 lambda: get_backend("torch", device="cpu").run(cfg)):
        with pytest.raises(StepUnsupported) as e:
            call()
        assert named in str(e.value)
