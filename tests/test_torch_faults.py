"""The port's §9 fault schedules (models/faults.py) and their path through
the model layer against the reference: the static setup, the per-round
masks and the keys law's cross-cut plane at every packing law; the masks,
the urn samplers and the chunked keys law with the cut; the round driver
over the reference's fault × adversary × delivery grid; the cases where
the port once ran a schedule as if it were absent; the plain backend's
surface; the CLI; and config4 under each kind against the committed
per-instance reference. Every comparison is exact."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.backends import get_backend as ref_get_backend
from byzantinerandomizedconsensus_tpu.models import faults as ref_faults
from byzantinerandomizedconsensus_tpu.models.adversaries import (
    AdversaryModel as RefAdversaryModel)
from byzantinerandomizedconsensus_tpu.ops import masks as ref_masks
from byzantinerandomizedconsensus_tpu.ops import urn as ref_urn
from byzantinerandomizedconsensus_tpu.ops import urn2 as ref_urn2
from byzantinerandomizedconsensus_tpu_torch import cli, get_backend, preset
from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import PlainUnsupported
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.models import delivery, driver, faults
from byzantinerandomizedconsensus_tpu_torch.models import state as state_mod
from byzantinerandomizedconsensus_tpu_torch.models.adversaries import AdversaryModel
from byzantinerandomizedconsensus_tpu_torch.ops import keys_step, masks, urn, urn2

KINDS = ("recover", "partition", "omission")
SIZES = [(4, 1), (7, 2), (512, 170), (1100, 366)]


def _ref(cfg):
    return ref_config.SimConfig(**dataclasses.asdict(cfg))


def _cfg(n, f, kind, **kw):
    base = dict(protocol="bracha", n=n, f=f, instances=60_000, delivery="urn2",
                faults=kind, crash_window=4)
    return SimConfig(**{**base, **kw}).validate()


def _ids(seed, B=6, hi=60_000):
    return np.random.default_rng(seed).choice(hi, B, replace=False)


@pytest.mark.parametrize("n,f", SIZES, ids=[f"n{n}" for n, _ in SIZES])
@pytest.mark.parametrize("kind", KINDS)
def test_setup_faults_matches_reference(kind, n, f):
    cfg = _cfg(n, f, kind)
    ids = _ids(n)
    want = ref_faults.setup_faults(_ref(cfg), 21, ids.astype(np.uint32), xp=np)
    got = faults.setup_faults(cfg, 21, torch.as_tensor(ids))
    assert sorted(got) == sorted(want)
    dtypes = {"fprone": torch.bool, "down_at": torch.int32, "up_at": torch.int32,
              "side": torch.uint8, "part_start": torch.int32, "part_heal": torch.int32}
    for k, v in want.items():
        assert got[k].dtype == dtypes[k], k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert (got["fprone"].sum(-1) == f).all()
    assert faults.setup_faults(dataclasses.replace(cfg, faults="none"), 21,
                               torch.as_tensor(ids)) is None


@pytest.mark.parametrize("n,f", SIZES, ids=[f"n{n}" for n, _ in SIZES])
@pytest.mark.parametrize("kind", KINDS)
def test_round_masks_and_cross_silent_match_reference(kind, n, f):
    cfg = _cfg(n, f, kind)
    ids = _ids(n + 1)
    rsetup = ref_faults.setup_faults(_ref(cfg), 5, ids.astype(np.uint32), xp=np)
    setup = faults.setup_faults(cfg, 5, torch.as_tensor(ids))
    hit = False
    for rnd in (0, 1, 2, 3, 5, 8, 11, 40):
        want = ref_faults.round_masks(_ref(cfg), 5, ids.astype(np.uint32), rnd, rsetup, xp=np)
        got = faults.round_masks(cfg, 5, torch.as_tensor(ids), rnd, setup)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                np.testing.assert_array_equal(g.numpy(), w)
                hit = hit or bool(w.any())
        if kind == "partition" and n <= 512:
            np.testing.assert_array_equal(faults.cross_silent(got[1]).numpy(),
                                          ref_faults.cross_silent(want[1], xp=np))
            recv = torch.tensor([0, n - 1, n // 2])
            np.testing.assert_array_equal(
                faults.cross_silent(got[1], recv).numpy(),
                ref_faults.cross_silent(want[1], recv_ids=recv.numpy(), xp=np))
    assert hit, "no mask was ever set over the rounds tried"


def test_omission_counts_the_prf_words_it_draws():
    cfg = _cfg(64, 21, "omission")
    ids = torch.arange(40)
    setup = faults.setup_faults(cfg, 3, ids)
    for rnd in range(4):
        stats = {}
        faults.round_masks(cfg, 3, ids, rnd, setup, stats=stats)
        burst = faults.omission_gate(cfg, 3, ids, rnd)
        want = 1 + burst.to(torch.int64) * setup["fprone"].sum(-1)
        assert torch.equal(stats["fault_words"], want)


def test_recover_edge_outage_from_round_0_past_round_cap():
    """A replica silent from round 0 whose heal lands at or past round_cap
    speaks in no round; the whole run equals the reference."""
    cap, w = 8, 16
    for seed in range(500):
        cfg = SimConfig(protocol="benor", n=7, f=2, instances=1, seed=seed,
                        round_cap=cap, crash_window=w, delivery="urn2",
                        faults="recover").validate()
        setup = faults.setup_faults(cfg, seed, torch.arange(1))
        edge = setup["fprone"] & (setup["down_at"] == 0) & (setup["up_at"] >= cap)
        if bool(edge.any()):
            break
    else:
        pytest.fail("no edge schedule within the scanned seeds")
    j = int(edge[0].nonzero()[0, 0])
    rsetup = ref_faults.setup_faults(_ref(cfg), seed, np.arange(1, dtype=np.uint32), xp=np)
    for rnd in range(cap + 1):
        fsil, _ = faults.round_masks(cfg, seed, torch.arange(1), rnd, setup)
        want, _ = ref_faults.round_masks(_ref(cfg), seed, np.arange(1, dtype=np.uint32),
                                         rnd, rsetup, xp=np)
        np.testing.assert_array_equal(fsil.numpy(), want)
        assert bool(fsil[0, j]) == (rnd < int(setup["up_at"][0, j]))
    ref = ref_get_backend("numpy").run(_ref(cfg))
    rounds, decision = driver.run_chunk(cfg, torch.arange(1, dtype=torch.int32))
    np.testing.assert_array_equal(rounds.numpy(), ref.rounds)
    np.testing.assert_array_equal(decision.numpy(), ref.decision)


def test_superset_raises_by_name():
    cfg = dataclasses.replace(_cfg(7, 2, "recover"), faults="superset")
    with pytest.raises(NotImplementedError, match="superset"):
        faults.setup_faults(cfg, 0, torch.arange(2))
    with pytest.raises(NotImplementedError, match="superset"):
        AdversaryModel(cfg).setup(0, torch.arange(2))


@pytest.mark.parametrize("kind", KINDS)
def test_setup_from_numpy_carries_the_reference_schedule(kind):
    cfg = _cfg(13, 4, kind, adversary="crash")
    ids = np.arange(9, dtype=np.uint32) * 31
    rsetup = RefAdversaryModel(_ref(cfg)).setup(cfg.seed, ids, xp=np)
    got = state_mod.setup_from_numpy(rsetup, "cpu")
    mine = AdversaryModel(cfg).setup(cfg.seed, torch.as_tensor(ids.astype(np.int64)))
    assert sorted(got["faults"]) == sorted(rsetup["faults"]) == sorted(mine["faults"])
    for k, v in rsetup["faults"].items():
        assert got["faults"][k].dtype == mine["faults"][k].dtype
        np.testing.assert_array_equal(got["faults"][k].numpy(), v)
        assert torch.equal(got["faults"][k], mine["faults"][k])


def _planes(n, B, seed):
    rng = np.random.default_rng(seed)
    values = rng.choice(3, (B, n), p=(0.45, 0.45, 0.1)).astype(np.uint8)
    silent = rng.random((B, n)) < 0.15
    fside = (rng.random((B, n)) < 0.3).astype(np.uint8)
    faulty = rng.random((B, n)) < 0.25
    return values, silent, fside, faulty


@pytest.mark.parametrize("n,f", [(7, 2), (64, 21)])
def test_masks_with_the_cut_match_reference(n, f):
    cfg = _cfg(n, f, "partition", delivery="keys", adversary="adaptive")
    B = 4
    values, silent, fside, _ = _planes(n, B, n)
    ids = _ids(n, B)
    bias = np.random.default_rng(1).random((B, n, n)) < 0.5
    x = ref_faults.cross_silent(fside, xp=np)
    xt = faults.cross_silent(torch.as_tensor(fside))
    args = (ids.astype(np.uint32), 3, 1, silent, bias)
    targs = (torch.as_tensor(ids), 3, 1, torch.as_tensor(silent), torch.as_tensor(bias))
    want = ref_masks.combined_keys(_ref(cfg), 9, *args, xp=np, xsilent=x)
    got = masks.combined_keys(cfg, 9, *targs, xsilent=xt)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        masks.mask_from_keys(got, n - f, torch.as_tensor(silent), xsilent=xt).numpy(),
        ref_masks.mask_from_keys(want, n - f, silent, xp=np, xsilent=x))
    np.testing.assert_array_equal(
        masks.delivery_mask(cfg, 9, *targs, xsilent=xt).numpy(),
        ref_masks.delivery_mask(_ref(cfg), 9, *args, xp=np, xsilent=x))


def test_chunked_keys_law_slices_the_cut(monkeypatch):
    """The plain keys law builds its keys a bounded number of triples at a
    time; the cut is sliced with each chunk, and the counts equal those of
    one unchunked mask."""
    cfg = _cfg(64, 21, "partition", delivery="keys")
    B = 10
    values, silent, fside, faulty = _planes(64, B, 2)
    ids = torch.as_tensor(_ids(2, B))
    t = [torch.as_tensor(x) for x in (values, silent, faulty)]
    fs = torch.as_tensor(fside)
    bias = torch.zeros((B, 1, 64), dtype=torch.bool)
    whole = keys_step.step_counts_plain(cfg, 4, ids, 2, 1, *t, bias=bias, fside=fs)
    planes = []
    monkeypatch.setattr(keys_step, "PLAIN_PAIRS", 3 * 64 * 64)
    monkeypatch.setattr(keys_step, "cross_silent",
                        lambda x: planes.append(x.shape[0]) or faults.cross_silent(x))
    chunked = keys_step.step_counts_plain(cfg, 4, ids, 2, 1, *t, bias=bias, fside=fs)
    assert planes == [3, 3, 3, 1]
    # Outside the epoch nobody is on side 1: no plane, the fault-free counts.
    quiet = keys_step.step_counts_plain(cfg, 4, ids, 2, 1, *t, bias=bias,
                                        fside=torch.zeros_like(fs))
    assert planes == [3, 3, 3, 1]
    for g, w in zip(quiet, keys_step.step_counts_plain(cfg, 4, ids, 2, 1, *t, bias=bias)):
        assert torch.equal(g, w)
    m = ref_masks.delivery_mask(_ref(cfg), 4, ids.numpy().astype(np.uint32), 2, 1, silent,
                                np.zeros((B, 1, 64), bool), xp=np,
                                xsilent=ref_faults.cross_silent(fside, xp=np))
    want = [(m & (values[:, None, :] == w)).sum(-1) for w in (0, 1)]
    for got in (whole, chunked):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


URN_CASES = [("urn", "bracha", "none"), ("urn", "bracha", "adaptive"),
             ("urn", "benor", "byzantine"), ("urn2", "bracha", "adaptive_min"),
             ("urn2", "benor", "byzantine"), ("urn2", "bracha", "crash")]


@pytest.mark.parametrize("law,protocol,adversary", URN_CASES,
                         ids=["-".join(c) for c in URN_CASES])
def test_count_level_samplers_split_the_urn_by_side(law, protocol, adversary):
    n, B = 40, 5
    cfg = _cfg(n, 7, "partition", delivery=law, protocol=protocol, adversary=adversary)
    values, silent, fside, faulty = _planes(n, B, 7)
    honest = values
    ids = _ids(3, B)
    ref_fn, fn = {"urn": (ref_urn.counts_fn, urn.counts_fn),
                  "urn2": (ref_urn2.counts_fn, urn2.counts_fn)}[law]
    for t in (0, 1):
        want = ref_fn(_ref(cfg), 17, ids.astype(np.uint32), 2, t, values, silent, faulty,
                      honest, xp=np, fside=fside)
        got = fn(cfg, 17, torch.as_tensor(ids), 2, t, torch.as_tensor(values),
                 torch.as_tensor(silent), torch.as_tensor(faulty), torch.as_tensor(honest),
                 fside=torch.as_tensor(fside))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
        _, m, _, L, D = urn.lane_setup(cfg, torch.as_tensor(values), torch.as_tensor(silent),
                                       torch.as_tensor(faulty), torch.as_tensor(honest), 17,
                                       torch.as_tensor(ids), 2, t, fside=torch.as_tensor(fside))
        _, _, rm, _, rL, rD = ref_urn.lane_setup(_ref(cfg), 17, ids.astype(np.uint32), 2, t,
                                                 values, silent, faulty, honest, xp=np,
                                                 fside=fside)
        for g, w in zip(m + [L, D], rm + [rL, rD]):
            np.testing.assert_array_equal(g.numpy(), w)


def test_per_step_kernels_refuse_the_fault_masks():
    cfg = _cfg(7, 2, "omission", delivery="keys")
    ids = torch.arange(3)
    setup = AdversaryModel(cfg).setup(cfg.seed, ids)
    _, fside = faults.round_masks(cfg, cfg.seed, ids, 0, setup["faults"])
    with pytest.raises(faults.FaultsUnsupported, match="kernel='plain'"):
        delivery.make_counts(cfg, cfg.seed, ids, 0, setup, counts_fn=keys_step.counts_fn,
                             fside=fside)
    with pytest.raises(faults.FaultsUnsupported, match="kernel='plain'"):
        faults.check_faults_supported(cfg, "the keys kernel")


ADV_PROTO = (("none", "benor"), ("crash", "benor"), ("byzantine", "bracha"))
GRID = ([(kind, adv, proto, law) for kind in KINDS for adv, proto in ADV_PROTO
         for law in ("keys", "urn", "urn2")]
        + [(kind, adv, "bracha", "urn2") for kind in KINDS
           for adv in ("adaptive", "adaptive_min")])


@pytest.mark.parametrize("kind,adversary,protocol,law", GRID,
                         ids=["-".join(c) for c in GRID])
def test_driver_matches_reference_on_the_fault_grid(kind, adversary, protocol, law):
    cfg = SimConfig(protocol=protocol, n=7, f=2, instances=4, adversary=adversary,
                    coin="local", seed=13, round_cap=32, delivery=law,
                    faults=kind).validate()
    want = ref_get_backend("numpy").run(_ref(cfg))
    rounds, decision = driver.run_chunk(cfg, torch.arange(4, dtype=torch.int32))
    np.testing.assert_array_equal(rounds.numpy(), want.rounds)
    np.testing.assert_array_equal(decision.numpy(), want.decision)
    res = get_backend("torch", device="cpu").run(cfg)
    np.testing.assert_array_equal(res.rounds, want.rounds)
    np.testing.assert_array_equal(res.decision, want.decision)


PINNED = [("recover", 5, (1, 1)), ("partition", 2, (4, 1)), ("omission", 50, (4, 0))]


@pytest.mark.parametrize("kind,instance,want", PINNED, ids=[p[0] for p in PINNED])
def test_fault_schedule_is_not_run_as_if_absent(kind, instance, want):
    """Bracha at n=4, f=1 under urn2: once the model layer ran each schedule
    as if none were set and gave another result for these instances (with
    no schedule, recover's instance 5 gives (2, 1))."""
    cfg = SimConfig(protocol="bracha", n=4, f=1, instances=64, delivery="urn2",
                    faults=kind, seed=0).validate()
    ref = ref_get_backend("numpy").run(_ref(cfg))
    assert (int(ref.rounds[instance]), int(ref.decision[instance])) == want
    rounds, decision = driver.run_chunk(cfg, torch.arange(64, dtype=torch.int32))
    assert (int(rounds[instance]), int(decision[instance])) == want
    np.testing.assert_array_equal(rounds.numpy(), ref.rounds)
    np.testing.assert_array_equal(decision.numpy(), ref.decision)
    none = driver.run_chunk(dataclasses.replace(cfg, faults="none"),
                            torch.arange(64, dtype=torch.int32))
    assert not (torch.equal(none[0], rounds) and torch.equal(none[1], decision))


PLAIN_CONFIGS = [
    dict(protocol="bracha", n=2048, f=682, instances=3, delivery="urn2", round_cap=3),
    dict(protocol="benor", n=16, f=7, instances=6, adversary="crash", delivery="keys"),
    dict(protocol="bracha", n=1100, f=366, instances=2, delivery="urn2", faults="partition",
         round_cap=4),
    dict(protocol="benor", n=16, f=3, instances=6, adversary="byzantine", delivery="keys",
         faults="omission"),
]


@pytest.mark.parametrize("fields", PLAIN_CONFIGS,
                         ids=["n2048-urn2", "benor-crash-keys", "n1100-partition",
                              "benor-byzantine-keys"])
def test_plain_backend_runs_the_model_layers_surface(fields):
    """Past the kernels' surfaces: packing law v2, Ben-Or's crash adversary
    under keys, and Ben-Or's Byzantine pairing under keys with a fault
    schedule, through the plain backend, equal the reference."""
    cfg = SimConfig(**fields).validate()
    want = ref_get_backend("numpy").run(_ref(cfg))
    got = get_backend("torch", device="cpu").run(cfg)
    np.testing.assert_array_equal(got.rounds, want.rounds)
    np.testing.assert_array_equal(got.decision, want.decision)


@pytest.mark.parametrize("fields,named", [
    (dict(delivery="urn3", n=4097, f=1365), "n=4097"),
    (dict(delivery="keys", n=4097, f=1365), "n=4097"),
], ids=["urn3", "keys"])
def test_plain_backend_refuses_the_rest_by_name(fields, named):
    """The full-mesh laws run on the plain path up to their ceiling,
    n = 4096; past it (a config validate refuses too) the plain backend
    refuses by name."""
    cfg = SimConfig(**{**dict(protocol="bracha", n=16, f=5, instances=4), **fields})
    with pytest.raises(PlainUnsupported, match=named):
        get_backend("torch", device="cpu").check_supported(cfg)
    with pytest.raises(ValueError, match="full-mesh ceiling"):
        cfg.validate()


def test_cli_runs_a_fault_schedule_on_the_cpu(capsys):
    cli.main(["run", "--preset", "config4", "--instances", "6", "--faults", "partition",
              "--device", "cpu", "--hist"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["faults"] == "partition" and out["kernel"] == "plain"
    z = np.load("artifacts/sweep_faults/bracha_n512_f170_none_shared_urn2_partition_"
                "s0_i0-2000.npz")
    assert out["decision_histogram"] == np.bincount(z["decision"][:6], minlength=3).tolist()
    assert out["round_histogram"][:8] == np.bincount(z["rounds"][:6], minlength=257)[:8].tolist()


@pytest.mark.parametrize("kind", KINDS)
def test_config4_under_each_kind_matches_the_committed_reference(kind):
    """Config4 (n=512, f=170) under each schedule through the plain backend,
    on a few of the instances the reference file holds."""
    z = np.load(f"artifacts/sweep_faults/bracha_n512_f170_none_shared_urn2_{kind}_"
                "s0_i0-2000.npz")
    cfg = json.loads(bytes(z["config"]).decode())
    assert cfg["faults"] == kind and cfg["crash_window"] == 4
    assert np.array_equal(z["inst_ids"], np.arange(2000))
    pick = np.array([0, 3, 641, 1999])
    res = get_backend("torch", device="cpu").run(preset("config4", faults=kind), inst_ids=pick)
    np.testing.assert_array_equal(res.rounds, z["rounds"][pick])
    np.testing.assert_array_equal(res.decision, z["decision"][pick])
