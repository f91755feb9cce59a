"""The keys step (ops/keys_step.py) and the spec-§4 keys law of the port
(ops/masks.py, ops/tally.py) against the reference: per broadcast step
through the real round bodies, against both the reference's XLA masks+tally
path and its Pallas kernel (ops/pallas_tally.py) in interpret mode; the
selection against a full sort; the driver against ``get_backend("jax")``;
the keys goldens; config 5 at n=512 against the committed sweep results;
the surface gate."""

import dataclasses
import functools
import glob

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.backends.base import get_backend as ref_get_backend
from byzantinerandomizedconsensus_tpu.models import bracha as ref_bracha
from byzantinerandomizedconsensus_tpu.models import state as ref_state
from byzantinerandomizedconsensus_tpu.models.adversaries import (
    AdversaryModel as RefAdversaryModel)
from byzantinerandomizedconsensus_tpu.ops import masks as ref_masks
from byzantinerandomizedconsensus_tpu_torch import get_backend
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig, sweep_point
from byzantinerandomizedconsensus_tpu_torch.models import bracha, delivery
from byzantinerandomizedconsensus_tpu_torch.models import state as state_mod
from byzantinerandomizedconsensus_tpu_torch.models.adversaries import AdversaryModel
from byzantinerandomizedconsensus_tpu_torch.ops import _step, keys_step, masks, tally
from byzantinerandomizedconsensus_tpu_torch.ops._step import StepUnsupported


def _ref(cfg):
    return ref_config.SimConfig(**dataclasses.asdict(cfg))


def ref_rounds(cfg, counts_fn, n_rounds):
    """The reference round body run eagerly with ``xp=jnp`` (the template of
    tests/test_pallas_step.py); the state after each round."""
    rcfg = _ref(cfg)
    ids = jnp.arange(cfg.instances, dtype=jnp.uint32)
    adv = RefAdversaryModel(rcfg)
    setup = adv.setup(cfg.seed, ids, xp=jnp)
    st = ref_state.init_state(rcfg, cfg.seed, ids, xp=jnp)
    out = []
    for r in range(n_rounds):
        st = ref_bracha.round_body(rcfg, cfg.seed, ids, r, st, adv, setup, xp=jnp,
                                   counts_fn=counts_fn)
        out.append({k: np.asarray(v) for k, v in st.items()})
    return out


def port_rounds(cfg, counts_fn, n_rounds):
    ids = torch.arange(cfg.instances, dtype=torch.int32)
    adv = AdversaryModel(cfg)
    setup = adv.setup(cfg.seed, ids)
    st = state_mod.init_state(cfg, cfg.seed, ids)
    out = []
    for r in range(n_rounds):
        st = bracha.round_body(cfg, cfg.seed, ids, r, st, adv, setup, counts_fn=counts_fn)
        out.append({k: v.numpy() for k, v in st.items()})
    return out


def assert_rounds_equal(got, want, what):
    for r, (a, b) in enumerate(zip(got, want)):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}, round {r}, {k}")


# The bracha adaptive row of tests/test_pallas_step.py::KEYS_STEP (two
# rounds, so decided replicas and validation silences reach the second), and
# the tile-boundary shapes under the other two adversaries: n == the TPU lane
# width (128), and n straddling two receiver tiles (200). Interpret-mode
# Pallas costs seconds per (config, step) to trace, so the rows are few.
KEYS_STEP = [
    # (cfg, n_rounds)
    (SimConfig(protocol="bracha", n=16, f=5, instances=6, adversary="adaptive",
               coin="shared", round_cap=8, seed=13, delivery="keys"), 2),
    (SimConfig(protocol="bracha", n=128, f=42, instances=4, adversary="none",
               coin="local", init="split", round_cap=4, seed=2, delivery="keys"), 1),
    (SimConfig(protocol="bracha", n=200, f=66, instances=4, adversary="adaptive_min",
               coin="shared", round_cap=4, seed=2, delivery="keys"), 1),
]


@pytest.mark.parametrize("cfg,n_rounds", KEYS_STEP,
                         ids=[f"n{c.n}f{c.f}-{c.adversary}" for c, _ in KEYS_STEP])
def test_keys_steps_match_reference_xla_and_pallas(cfg, n_rounds, pallas_interpret):
    """The port's keys hook (the plain version on the CPU) and its default
    keys path, through the port's round body, equal the reference's XLA
    path and its Pallas kernel through the reference's round body."""
    from byzantinerandomizedconsensus_tpu.ops import pallas_tally

    cfg = cfg.validate()
    xla = ref_rounds(cfg, None, n_rounds)
    pallas = ref_rounds(cfg, functools.partial(pallas_tally.counts_fn,
                                               interpret=pallas_interpret), n_rounds)
    assert_rounds_equal(pallas, xla, "reference pallas vs xla")
    assert_rounds_equal(port_rounds(cfg, keys_step.counts_fn, n_rounds), xla, "hook")
    assert_rounds_equal(port_rounds(cfg, None, n_rounds), xla, "default keys path")


@pytest.mark.parametrize("adversary", ["none", "adaptive", "adaptive_min"])
def test_step_counts_match_reference_masks_on_random_planes(adversary):
    """One step on random wire values, silences and faulty sets, against the
    reference's masks + tally with its own adversary's bias."""
    from byzantinerandomizedconsensus_tpu.ops import tally as ref_tally

    cfg = SimConfig(protocol="bracha", n=40, f=13, instances=1000,
                    adversary=adversary, delivery="keys").validate()
    rng = np.random.default_rng(["none", "adaptive", "adaptive_min"].index(adversary))
    B, n = 5, cfg.n
    inst = rng.choice(1000, B, replace=False).astype(np.int32)
    honest = rng.integers(0, 3, (B, n)).astype(np.uint8)
    silent = rng.random((B, n)) < 0.2
    faulty = rng.random((B, n)) < 0.3
    rcfg = _ref(cfg)
    values, _, bias = RefAdversaryModel(rcfg).inject(
        7, inst.astype(np.uint32), 3, 1, honest, {"faulty": faulty}, xp=np)
    mask = ref_masks.delivery_mask(rcfg, 7, inst.astype(np.uint32), 3, 1, silent, bias, xp=np)
    w0, w1 = ref_tally.tally01(mask, values, xp=np)
    c0, c1 = keys_step.step_counts(cfg, 7, torch.as_tensor(inst), 3, 1,
                                   torch.as_tensor(values), torch.as_tensor(silent),
                                   torch.as_tensor(faulty))
    np.testing.assert_array_equal(c0.numpy(), w0)
    np.testing.assert_array_equal(c1.numpy(), w1)


def test_combined_keys_and_mask_match_reference():
    cfg = SimConfig(protocol="bracha", n=33, f=10, instances=1000,
                    delivery="keys").validate()
    rng = np.random.default_rng(4)
    B, n = 4, cfg.n
    inst = rng.choice(1000, B, replace=False)
    silent = rng.random((B, n)) < 0.25
    bias = rng.random((B, n, n)) < 0.5
    want = ref_masks.combined_keys(_ref(cfg), 5, inst.astype(np.uint32), 2, 0, silent,
                                   bias, xp=np)
    got = masks.combined_keys(cfg, 5, torch.as_tensor(inst), 2, 0,
                              torch.as_tensor(silent), torch.as_tensor(bias))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        masks.mask_from_keys(got, n - cfg.f, torch.as_tensor(silent)).numpy(),
        ref_masks.mask_from_keys(want, n - cfg.f, silent, xp=np))
    values = rng.integers(0, 3, (B, n)).astype(np.uint8)
    m = rng.random((B, n, n)) < 0.5
    from byzantinerandomizedconsensus_tpu.ops import tally as ref_tally

    for got_c, want_c in zip(tally.tally01(torch.as_tensor(m), torch.as_tensor(values)),
                             ref_tally.tally01(m, values, xp=np)):
        np.testing.assert_array_equal(got_c.numpy(), want_c)


def _random_step(cfg, B, seed):
    """One step's inputs, with the wire values and bias ``inject`` makes."""
    rng = np.random.default_rng(seed)
    ids = torch.as_tensor(rng.choice(cfg.instances, B, replace=False).astype(np.int32))
    honest = torch.as_tensor(rng.integers(0, 3, (B, cfg.n)).astype(np.uint8))
    silent = torch.as_tensor(rng.random((B, cfg.n)) < 0.2)
    setup = {"faulty": torch.as_tensor(rng.random((B, cfg.n)) < 0.3)}
    values, _, bias = AdversaryModel(cfg).inject(cfg.seed, ids, 1, 2, honest, setup)
    return ids, setup, honest, values, silent, bias


def test_plain_keys_path_holds_at_most_plain_pairs_key_triples(monkeypatch):
    """At n=1024 the round body's keys delivery (models/delivery.py) builds
    its (B, R, n) keys at most PLAIN_PAIRS triples at a time, each chunk with
    its own rows of the bias."""
    cfg = SimConfig(protocol="bracha", n=1024, f=341, instances=1000,
                    adversary="adaptive", delivery="keys").validate()
    B = 20
    ids, setup, honest, values, silent, bias = _random_step(cfg, B, 0)
    assert bias.shape == (B, cfg.n, cfg.n)
    chunks = []

    def recording_mask(cfg, seed, inst_ids, rnd, t, silent, bias, recv_ids=None):
        b = inst_ids.shape[0]
        chunks.append((b, tuple(silent.shape), tuple(bias.shape)))
        return torch.zeros((b, cfg.n, cfg.n), dtype=torch.bool)

    monkeypatch.setattr(masks, "delivery_mask", recording_mask)
    counts = delivery.make_counts(cfg, cfg.seed, ids, 1, setup)
    c0, c1 = counts(2, honest, values, silent, bias)
    assert c0.shape == c1.shape == (B, cfg.n)
    assert len(chunks) > 1 and sum(b for b, _, _ in chunks) == B
    for b, silent_shape, bias_shape in chunks:
        assert b * cfg.n * cfg.n <= keys_step.PLAIN_PAIRS
        assert silent_shape == (b, cfg.n) and bias_shape == (b, cfg.n, cfg.n)


@pytest.mark.parametrize("adversary", ["none", "adaptive", "adaptive_min"])
def test_plain_keys_chunks_equal_one_unchunked_step(adversary, monkeypatch):
    """Chunked by PLAIN_PAIRS, with inject's bias or with the bias computed
    per chunk, the plain keys law equals masks + tally over the whole batch."""
    cfg = SimConfig(protocol="bracha", n=24, f=7, instances=1000,
                    adversary=adversary, delivery="keys").validate()
    ids, setup, _, values, silent, bias = _random_step(cfg, 8, 1)
    want = tally.tally01(masks.delivery_mask(cfg, cfg.seed, ids, 1, 2, silent, bias),
                         values)
    monkeypatch.setattr(keys_step, "PLAIN_PAIRS", 3 * cfg.n * cfg.n)
    for given in (bias, None):
        got = keys_step.step_counts_plain(cfg, cfg.seed, ids, 1, 2, values, silent,
                                          setup["faulty"], given)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_mask_from_keys_vs_sort_with_tie_classes():
    """The k smallest of keys with dense top-field collisions (large tie
    classes, broken by the sender bits) against an argsort."""
    rng = np.random.default_rng(99)
    S = 96
    for _ in range(20):
        top = rng.integers(0, 5, size=(4, 3, S)).astype(np.int64)
        keys = (top << 10) | np.arange(S)[None, None, :]
        k = int(rng.integers(1, S))
        got = masks.mask_from_keys(torch.as_tensor(keys), k,
                                   torch.zeros((4, S), dtype=torch.bool),
                                   recv_ids=torch.full((3,), S + 1)).numpy()
        want = np.zeros_like(got)
        order = np.argsort(keys, axis=-1)[..., :k]
        np.put_along_axis(want, order, True, axis=-1)
        np.testing.assert_array_equal(got, want)


KEYS_DRIVER = [
    SimConfig(protocol="bracha", n=7, f=2, instances=24, adversary="none",
              coin="shared", seed=3, delivery="keys"),
    SimConfig(protocol="bracha", n=10, f=3, instances=24, adversary="adaptive",
              coin="local", init="all1", seed=4, delivery="keys"),
    SimConfig(protocol="bracha", n=16, f=5, instances=24, adversary="adaptive_min",
              coin="shared", seed=5, delivery="keys"),
]


@pytest.mark.parametrize("cfg", KEYS_DRIVER, ids=[c.adversary for c in KEYS_DRIVER])
def test_cpu_backend_matches_reference_backend(cfg):
    cfg = cfg.validate()
    want = ref_get_backend("jax").run(_ref(cfg))
    got = get_backend("torch", device="cpu").run(cfg)
    np.testing.assert_array_equal(got.rounds, want.rounds)
    np.testing.assert_array_equal(got.decision, want.decision)


@pytest.mark.parametrize("name,fields", [
    ("bracha_adaptive", dict(adversary="adaptive", seed=3)),
    ("bracha_adaptive_min", dict(adversary="adaptive_min", seed=7)),
])
def test_keys_goldens(name, fields):
    """spec/golden/golden.npz, with the configs of spec/golden/regen.py."""
    cfg = SimConfig(protocol="bracha", n=13, f=4, instances=100, coin="shared",
                    round_cap=64, **fields).validate()
    assert cfg.delivery == "keys"
    gold = np.load("spec/golden/golden.npz")
    res = get_backend("torch", device="cpu").run(cfg)
    np.testing.assert_array_equal(res.rounds, gold[f"{name}__rounds"])
    np.testing.assert_array_equal(res.decision, gold[f"{name}__decision"])


def test_config5_n512_matches_the_committed_sweep_results():
    """Config 5's sweep point at full width under keys, on a handful of ids,
    against artifacts/sweep_keys (the reference's per-instance results)."""
    parts = [np.load(p) for p in sorted(glob.glob(
        "artifacts/sweep_keys/bracha_n512_f170_adaptive_shared_s0_i*.npz"))]
    ids = np.concatenate([z["inst_ids"] for z in parts])
    rounds = np.concatenate([z["rounds"] for z in parts])
    decision = np.concatenate([z["decision"] for z in parts])
    order = np.argsort(ids)
    ids, rounds, decision = ids[order], rounds[order], decision[order]
    pick = np.array([0, 2, 1000, 1999])
    cfg = dataclasses.replace(sweep_point(512), delivery="keys").validate()
    res = get_backend("torch", device="cpu").run(cfg, inst_ids=ids[pick])
    np.testing.assert_array_equal(res.rounds, rounds[pick])
    np.testing.assert_array_equal(res.decision, decision[pick])


UNSUPPORTED = [
    (dict(protocol="benor", n=7, f=1), "protocol='benor'"),
    (dict(adversary="crash"), "adversary='crash'"),
    (dict(adversary="byzantine"), "adversary='byzantine'"),
    (dict(faults="recover"), "faults='recover'"),
    (dict(delivery="urn2"), "delivery='urn2'"),
    (dict(delivery="urn3"), "delivery='urn3'"),
    (dict(n=1025, f=341), "n=1025"),
]


@pytest.mark.parametrize("fields,named", UNSUPPORTED, ids=[u[1] for u in UNSUPPORTED])
def test_unsupported_surface_raises_step_unsupported_by_name(fields, named):
    cfg = SimConfig(**{**dict(protocol="bracha", n=16, f=5, instances=64,
                              delivery="keys"), **fields}).validate()
    ids = torch.zeros(1, dtype=torch.int32)
    planes = [torch.zeros((1, cfg.n), dtype=torch.uint8) for _ in range(3)]
    for call in (lambda: _step.check_step_supported(cfg),
                 lambda: keys_step.step_counts(cfg, 0, ids, 0, 0, *planes)):
        with pytest.raises(StepUnsupported) as e:
            call()
        assert named in str(e.value)
        assert "surface is protocol in ('bracha',)" in str(e.value)
