"""The replica-sharded path of the port (``parallel/``) against the
reference, on the CPU, tolerance 0:

- the model layer's seams over a receiver shard (``init_state``,
  ``coin_bits``, ``inject``, ``round_masks`` with the cut, the keys law and
  the count-level samplers) against the reference's with ``recv_ids``;
- ``TorchShardedBackend(kernel="plain")`` on CPU meshes against the
  reference's ``JaxShardedBackend`` over the meshes and configs of
  ``tests/test_sharded.py`` (the conftest gives JAX 8 CPU devices);
- the gates by name, a shard that raises and one that never reaches its
  barrier (each fails within its timeout, never a hang), the registry and
  the mesh's layout functions against the reference's.

The mesh through K2, K3 and K1 on the card is ``tests/test_torch_card.py``'s
(it imports no JAX).

No test spawns a process or opens a socket: the mesh is threads.
"""

import dataclasses
import os
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from test_sharded import CONFIGS as REF_SHARDED_CONFIGS
from test_sharded import MESHES as REF_SHARDED_MESHES

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.models import coins as ref_coins
from byzantinerandomizedconsensus_tpu.models import faults as ref_faults
from byzantinerandomizedconsensus_tpu.models import state as ref_state
from byzantinerandomizedconsensus_tpu.models.adversaries import (
    AdversaryModel as RefAdversaryModel)
from byzantinerandomizedconsensus_tpu.ops import committee as ref_committee
from byzantinerandomizedconsensus_tpu.ops import masks as ref_masks
from byzantinerandomizedconsensus_tpu.ops import tally as ref_tally
from byzantinerandomizedconsensus_tpu.ops import urn as ref_urn
from byzantinerandomizedconsensus_tpu.ops import urn2 as ref_urn2
from byzantinerandomizedconsensus_tpu.ops import urn3 as ref_urn3
from byzantinerandomizedconsensus_tpu.parallel import mesh as ref_mesh
from byzantinerandomizedconsensus_tpu_torch import get_backend
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.models import bracha, coins, faults, state
from byzantinerandomizedconsensus_tpu_torch.models.adversaries import (
    AdversaryModel, equivocation_values)
from byzantinerandomizedconsensus_tpu_torch.models.committee import CommitteeUnsupported
from byzantinerandomizedconsensus_tpu_torch.models.faults import FaultsUnsupported
from byzantinerandomizedconsensus_tpu_torch.ops import committee, keys_step, urn, urn2, urn3
from byzantinerandomizedconsensus_tpu_torch.parallel import mesh as pmesh
from byzantinerandomizedconsensus_tpu_torch.parallel import sharded
from byzantinerandomizedconsensus_tpu_torch.parallel.sharded import (
    ShardFailed, TorchShardedBackend)

SEED = 23
RANGES = [(0, 5), (5, 11), (11, 16)]


def _ref(cfg):
    return ref_config.SimConfig(**dataclasses.asdict(cfg))


def _port(ref_cfg):
    return SimConfig(**dataclasses.asdict(ref_cfg)).validate()


def _recv(lo, hi):
    return np.arange(lo, hi, dtype=np.uint32), torch.arange(lo, hi)


def _ids(B):
    ids = (np.arange(B) * 131 + 7).astype(np.int64)
    return ids.astype(np.uint32), torch.as_tensor(ids)


# --- the model layer's seams over a receiver shard ---------------------------

@pytest.mark.parametrize("lo,hi", RANGES)
@pytest.mark.parametrize("init", ["random", "all0", "all1", "split"])
def test_init_state_over_a_shard_matches_reference(init, lo, hi):
    cfg = SimConfig(protocol="bracha", n=16, f=5, instances=40, init=init,
                    seed=SEED).validate()
    rids, tids = _ids(12)
    rrecv, trecv = _recv(lo, hi)
    want = ref_state.init_state(_ref(cfg), SEED, rids, xp=np, recv_ids=rrecv)
    got = state.init_state(cfg, SEED, tids, trecv)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    full = state.init_state(cfg, SEED, tids)
    np.testing.assert_array_equal(got["est"].numpy(), full["est"][:, lo:hi].numpy())


@pytest.mark.parametrize("lo,hi", RANGES)
@pytest.mark.parametrize("coin", ["local", "shared"])
def test_coin_bits_over_a_shard_match_reference(coin, lo, hi):
    cfg = SimConfig(protocol="benor", n=16, f=3, instances=40, coin=coin,
                    seed=SEED).validate()
    rids, tids = _ids(12)
    rrecv, trecv = _recv(lo, hi)
    for rnd in (0, 3, 200):
        want = ref_coins.coin_bits(_ref(cfg), SEED, rids, rnd, xp=np, recv_ids=rrecv)
        got = coins.coin_bits(cfg, SEED, tids, rnd, trecv)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"round {rnd}")


def _planes(cfg, B, seed):
    rng = np.random.default_rng(seed)
    honest = rng.integers(0, 3, (B, cfg.n)).astype(np.uint8)
    silent = rng.random((B, cfg.n)) < 0.15
    return honest, silent


@pytest.mark.parametrize("lo,hi", RANGES)
@pytest.mark.parametrize("protocol,adversary,delivery", [
    ("bracha", "adaptive", "keys"), ("bracha", "adaptive_min", "keys"),
    ("bracha", "byzantine", "keys"), ("benor", "crash", "keys"),
    ("benor", "byzantine", "keys"), ("bracha", "adaptive", "urn2")])
def test_inject_over_a_shard_matches_reference(protocol, adversary, delivery, lo, hi):
    """The wire values and silences stay full sender width; the receiver
    axis of the adaptive bias, and under Ben-Or's Byzantine pairing of the
    per-receiver values (the port draws them in ``equivocation_values``), is
    the shard's."""
    f = 5 if protocol == "bracha" else 3
    cfg = SimConfig(protocol=protocol, n=16, f=f, instances=40, adversary=adversary,
                    delivery=delivery, seed=SEED).validate()
    rids, tids = _ids(10)
    rrecv, trecv = _recv(lo, hi)
    honest, _ = _planes(cfg, 10, lo + 1)
    radv, adv = RefAdversaryModel(_ref(cfg)), AdversaryModel(cfg)
    rsetup = radv.setup(SEED, rids, xp=np)
    setup = adv.setup(SEED, tids)
    np.testing.assert_array_equal(setup["faulty"].numpy(), rsetup["faulty"])
    for rnd, t in ((0, 0), (4, 1)):
        wv, ws, wb = radv.inject(SEED, rids, rnd, t, honest, rsetup, xp=np, recv_ids=rrecv)
        v, s, b = adv.inject(SEED, tids, rnd, t, torch.as_tensor(honest), setup,
                             recv_ids=trecv)
        if wv.ndim == 3:
            v = equivocation_values(cfg, SEED, tids, rnd, t, v, setup["faulty"], trecv)
        np.testing.assert_array_equal(v.numpy(), wv)
        np.testing.assert_array_equal(s.numpy(), ws)
        np.testing.assert_array_equal(b.to(torch.uint8).numpy(),
                                      np.broadcast_to(wb, b.shape).astype(np.uint8))


@pytest.mark.parametrize("kind", ["recover", "partition", "omission"])
def test_round_masks_and_the_cut_over_a_shard_match_reference(kind):
    """The fault masks are sender width on every shard; the keys law's cut
    (``cross_silent``) is restricted to the shard's receivers."""
    cfg = SimConfig(protocol="bracha", n=16, f=5, instances=40, adversary="crash",
                    faults=kind, crash_window=3, seed=SEED).validate()
    rids, tids = _ids(12)
    rsetup = RefAdversaryModel(_ref(cfg)).setup(SEED, rids, xp=np)
    setup = AdversaryModel(cfg).setup(SEED, tids)
    for rnd in range(6):
        wsil, wside = ref_faults.round_masks(_ref(cfg), SEED, rids, rnd, rsetup["faults"],
                                             xp=np)
        fsil, fside = faults.round_masks(cfg, SEED, tids, rnd, setup["faults"])
        for got, want in ((fsil, wsil), (fside, wside)):
            assert (got is None) == (want is None)
            if want is not None:
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f"round {rnd}")
        if wside is not None:
            for lo, hi in RANGES:
                rrecv, trecv = _recv(lo, hi)
                np.testing.assert_array_equal(
                    faults.cross_silent(fside, trecv).numpy(),
                    ref_faults.cross_silent(wside, recv_ids=rrecv, xp=np))


SAMPLERS = {"urn": (urn, ref_urn), "urn2": (urn2, ref_urn2), "urn3": (urn3, ref_urn3),
            "committee": (committee, ref_committee)}


@pytest.mark.parametrize("lo,hi", RANGES)
@pytest.mark.parametrize("law,protocol,adversary", [
    ("urn", "benor", "byzantine"), ("urn", "bracha", "adaptive"),
    ("urn2", "benor", "byzantine"), ("urn2", "bracha", "adaptive_min"),
    ("urn3", "bracha", "adaptive"), ("urn3", "benor", "crash"),
    ("committee", "bracha", "adaptive")])
def test_count_level_samplers_over_a_shard_match_reference(law, protocol, adversary,
                                                           lo, hi):
    f = 5 if protocol == "bracha" else 3
    cfg = SimConfig(protocol=protocol, n=16, f=f, instances=40, adversary=adversary,
                    delivery=law, seed=SEED).validate()
    port, ref = SAMPLERS[law]
    rids, tids = _ids(10)
    rrecv, trecv = _recv(lo, hi)
    honest, silent = _planes(cfg, 10, 3 * lo + 2)
    faulty = RefAdversaryModel(_ref(cfg)).setup(SEED, rids, xp=np)["faulty"]
    values = np.where(faulty, 1, honest).astype(np.uint8)
    fside = np.where(np.arange(16) % 5 == 1, 1, 0).astype(np.uint8)[None].repeat(10, 0)
    for t, side in ((0, None), (1, fside)):
        want = ref.counts_fn(_ref(cfg), SEED, rids, 2, t, values, silent, faulty, honest,
                             recv_ids=rrecv, xp=np, fside=side)
        got = port.counts_fn(cfg, SEED, tids, 2, t, torch.as_tensor(values),
                             torch.as_tensor(silent), torch.as_tensor(faulty),
                             torch.as_tensor(honest), recv_ids=trecv,
                             fside=None if side is None else torch.as_tensor(side))
        full = port.counts_fn(cfg, SEED, tids, 2, t, torch.as_tensor(values),
                              torch.as_tensor(silent), torch.as_tensor(faulty),
                              torch.as_tensor(honest),
                              fside=None if side is None else torch.as_tensor(side))
        for g, w, a in zip(got, want, full):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"step {t}")
            np.testing.assert_array_equal(g.numpy(), a[:, lo:hi].numpy())


@pytest.mark.parametrize("lo,hi", RANGES)
@pytest.mark.parametrize("protocol,adversary", [
    ("bracha", "adaptive"), ("bracha", "adaptive_min"), ("benor", "byzantine"),
    ("benor", "crash")])
def test_keys_law_over_a_shard_matches_reference(protocol, adversary, lo, hi):
    """The plain keys law's rows of a shard (its bias, cut and equivocation
    restricted to them) against the reference's masks and tally with
    ``recv_ids``."""
    f = 5 if protocol == "bracha" else 3
    cfg = SimConfig(protocol=protocol, n=16, f=f, instances=40, adversary=adversary,
                    faults="partition", seed=SEED).validate()
    rcfg = _ref(cfg)
    rids, tids = _ids(10)
    rrecv, trecv = _recv(lo, hi)
    honest, silent = _planes(cfg, 10, 5 * lo + 1)
    radv = RefAdversaryModel(rcfg)
    rsetup = radv.setup(SEED, rids, xp=np)
    faulty = rsetup["faulty"]
    fside = np.where(np.arange(16) % 3 == 0, 1, 0).astype(np.uint8)[None].repeat(10, 0)
    rv, _, rb = radv.inject(SEED, rids, 1, 2, honest, rsetup, xp=np, recv_ids=rrecv)
    xsil = ref_faults.cross_silent(fside, recv_ids=rrecv, xp=np)
    mask = ref_masks.delivery_mask(rcfg, SEED, rids, 1, 2, silent, rb, xp=np,
                                   recv_ids=rrecv, xsilent=xsil)
    want = ref_tally.tally01(mask, rv, xp=np)
    adv = AdversaryModel(cfg)
    tv, _, _ = adv.inject(SEED, tids, 1, 2, torch.as_tensor(honest), adv.setup(SEED, tids),
                          with_bias=False)
    got = keys_step.step_counts_plain(cfg, SEED, tids, 1, 2, tv, torch.as_tensor(silent),
                                      torch.as_tensor(faulty), fside=torch.as_tensor(fside),
                                      recv_ids=trecv)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


# --- the mesh against the reference's shard_map mesh -------------------------

@pytest.fixture(scope="module")
def jax_sharded_results():
    import jax

    from byzantinerandomizedconsensus_tpu.parallel.sharded import JaxShardedBackend

    devs = jax.devices("cpu")
    out = {}
    for cfg in REF_SHARDED_CONFIGS:
        for n_data, n_model in REF_SHARDED_MESHES:
            if len(devs) < n_data * n_model:
                pytest.skip(f"needs {n_data * n_model} cpu devices")
            mesh = ref_mesh.make_mesh(n_data=n_data, n_model=n_model,
                                      devices=devs[:n_data * n_model])
            res = JaxShardedBackend(mesh=mesh).run(cfg)
            out[(cfg, n_data, n_model)] = (res.rounds, res.decision)
    return out


@pytest.mark.parametrize("n_data,n_model", REF_SHARDED_MESHES)
@pytest.mark.parametrize("ref_cfg", REF_SHARDED_CONFIGS,
                         ids=lambda c: f"{c.protocol}-{c.adversary}-n{c.n}")
def test_cpu_mesh_matches_reference_jax_sharded(ref_cfg, n_data, n_model,
                                                jax_sharded_results):
    mesh = pmesh.make_mesh(n_data, n_model, ["cpu"] * (n_data * n_model))
    got = TorchShardedBackend(mesh=mesh, kernel="plain").run(_port(ref_cfg))
    rounds, decision = jax_sharded_results[(ref_cfg, n_data, n_model)]
    np.testing.assert_array_equal(got.rounds, rounds)
    np.testing.assert_array_equal(got.decision, decision)


def test_mesh_chunking_matches_unchunked(monkeypatch):
    """Chunk boundaries (the tail padded) and uneven data shards do not move
    the results."""
    cfg = SimConfig(protocol="bracha", n=8, f=2, instances=30, adversary="byzantine",
                    coin="shared", seed=7, round_cap=64).validate()
    mesh = pmesh.make_mesh(4, 2, ["cpu"] * 8)
    big = TorchShardedBackend(mesh=mesh).run(cfg)
    monkeypatch.setattr(TorchShardedBackend, "chunk_size", lambda self, cfg: 7)
    small = TorchShardedBackend(mesh=mesh).run(cfg)
    want = get_backend("torch", device="cpu").run(cfg)
    for got in (big, small):
        np.testing.assert_array_equal(got.rounds, want.rounds)
        np.testing.assert_array_equal(got.decision, want.decision)


# --- gates, failures, registry, layout ----------------------------------------

def _cfg(**kw):
    fields = dict(protocol="bracha", n=12, f=3, instances=6, coin="shared", round_cap=16,
                  seed=SEED)
    fields.update(kw)
    return SimConfig(**fields).validate()


def test_mesh_refuses_a_model_axis_that_does_not_divide_n():
    backend = get_backend("torch_sharded:5", device="cpu")
    with pytest.raises(ValueError, match="n=12 not divisible by model-axis size 5"):
        backend.run(_cfg())


@pytest.mark.parametrize("fields,exc,named", [
    (dict(faults="recover"), FaultsUnsupported, "the mesh"),
    (dict(faults="partition", delivery="keys"), FaultsUnsupported, "the mesh"),
    (dict(delivery="committee", n=16, f=3), CommitteeUnsupported, "the mesh"),
], ids=["faults", "faults-keys", "committee"])
def test_mesh_refuses_faults_and_committees_by_name(fields, exc, named):
    with pytest.raises(exc, match=named):
        get_backend("torch_sharded:2", device="cpu").run(_cfg(**fields))


def test_mesh_kernels_other_than_plain_need_cards():
    for kernel in ("step", "fused"):
        with pytest.raises(ValueError, match="needs a mesh of CUDA devices"):
            TorchShardedBackend(mesh=pmesh.make_mesh(1, 2, ["cpu", "cpu"]), kernel=kernel)
    with pytest.raises(ValueError, match="unknown kernel"):
        TorchShardedBackend(mesh=pmesh.make_mesh(1, 1, ["cpu"]), kernel="xla")


def test_fused_mesh_takes_the_fused_kernels_own_gate():
    """``kernel="fused"`` shards only the data axis and is gated by K1 alone:
    a fault schedule passes the mesh, the keys law is refused by name."""
    from byzantinerandomizedconsensus_tpu_torch.ops.fused_round import FusedUnsupported

    backend = TorchShardedBackend(mesh=pmesh.make_mesh(2, 2, ["cpu"] * 4))
    backend.kernel = "fused"  # the gate alone: there is no card to launch on
    backend.check_supported(_cfg(delivery="urn2", faults="partition"))
    with pytest.raises(FusedUnsupported):
        backend.check_supported(_cfg(delivery="keys"))


def _failing_round_body(monkeypatch, fail):
    real = bracha.round_body

    def body(cfg, seed, ids, rnd, st, adv, setup, **kw):
        fail(int(kw["recv_ids"][0]), rnd)
        return real(cfg, seed, ids, rnd, st, adv, setup, **kw)

    monkeypatch.setattr(bracha, "round_body", body)


def test_a_shard_that_raises_fails_the_run_by_name(monkeypatch):
    def fail(first, rnd):
        if first == 6 and rnd == 1:
            raise ZeroDivisionError("shard 1 died")

    _failing_round_body(monkeypatch, fail)
    cfg = _cfg(delivery="urn2", adversary="adaptive", round_cap=8, init="split")
    backend = TorchShardedBackend(mesh=pmesh.make_mesh(1, 2, ["cpu"] * 2))
    t0 = time.perf_counter()
    with pytest.raises(ShardFailed, match=r"shard \(data 0, model 1\).*shard 1 died"):
        backend.run(cfg)
    assert time.perf_counter() - t0 < 20.0  # the sibling's barrier was aborted, not timed out


def test_a_shard_that_never_arrives_fails_within_the_timeout(monkeypatch):
    def fail(first, rnd):
        if first == 6:
            time.sleep(3.0)

    _failing_round_body(monkeypatch, fail)
    monkeypatch.setattr(sharded, "BARRIER_TIMEOUT_S", 0.5)
    backend = get_backend("virtual:1x2")
    t0 = time.perf_counter()
    with pytest.raises(ShardFailed, match="did not reach a barrier within 0.5 s"):
        backend.run(_cfg(delivery="urn2"))
    assert time.perf_counter() - t0 < 2.5


def test_collective_exchange_under_thread_switching():
    """More shard threads than cores exchange many generations with the
    interpreter switching threads every microsecond: every shard reads every
    sibling's value of its own generation (a slot overwritten by a shard
    that ran ahead would show), and every thread ends."""
    n = (os.cpu_count() or 1) + 3
    coll = sharded._Collective(n, timeout=60.0)
    bad = []

    def worker(m):
        for k in range(100):
            got = coll.exchange(m, (k, m))
            if got != [(k, j) for j in range(n)]:
                bad.append((m, k, got))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(m,), daemon=True)
                   for m in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert bad == []


def test_registry_parses_mesh_names():
    b = get_backend("torch_sharded:3,plain", device="cpu")
    assert b.mesh.shape == {"data": 1, "model": 3} and b.kernel == "plain"
    v = get_backend("virtual:4x2")
    assert v.mesh.shape == {"data": 4, "model": 2}
    assert get_backend("virtual").mesh.shape == {"data": 2, "model": 2}
    assert get_backend("torch_sharded", device="cpu").mesh.shape == {"data": 1, "model": 1}


def test_make_mesh_shapes_and_errors():
    m = pmesh.make_mesh(2, 3, ["cpu"] * 6)
    assert m.shape == {"data": 2, "model": 3}
    assert m.distinct_devices() == [torch.device("cpu")]
    assert pmesh.make_mesh(n_model=2, devices=["cpu"] * 4).shape == {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="not divisible by n_model=3"):
        pmesh.make_mesh(n_model=3, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="mesh 2x2 needs 4 devices, have 3"):
        pmesh.make_mesh(2, 2, ["cpu"] * 3)


def _fake_devs(n_hosts, per_host):
    return [SimpleNamespace(id=h * per_host + k, process_index=h, slice_index=0)
            for h in range(n_hosts) for k in range(per_host)]


@pytest.mark.parametrize("n_hosts,per_host,n_model", [(2, 4, 2), (4, 8, 4), (1, 8, 8),
                                                      (2, 4, 1)])
def test_hybrid_grid_matches_reference(n_hosts, per_host, n_model):
    devs = _fake_devs(n_hosts, per_host)
    got = pmesh.hybrid_grid(list(reversed(devs)), n_model)
    want = ref_mesh.hybrid_grid(list(reversed(devs)), n_model)
    assert got.shape == want.shape
    assert [d.id for d in got.ravel()] == [d.id for d in want.ravel()]


def test_hybrid_grid_rejects_bad_model_split():
    with pytest.raises(ValueError, match="n_model=3"):
        pmesh.hybrid_grid(_fake_devs(2, 4), n_model=3)


def test_fleet_placement_matches_reference():
    devs = [SimpleNamespace(platform="gpu", id=k, device_kind="H100") for k in range(4)]
    for n_workers, pool in ((3, devs), (4, devs[:2]), (1, devs[:1])):
        assert pmesh.fleet_placement(n_workers, pool) == ref_mesh.fleet_placement(
            n_workers, pool)
    with pytest.raises(ValueError, match="n_workers=0"):
        pmesh.fleet_placement(0, devices=devs)
    with pytest.raises(ValueError, match="at least one device"):
        pmesh.fleet_placement(2, devices=[])
    rows = pmesh.fleet_placement(2, devices=[torch.device("cpu")])
    assert [r["platform"] for r in rows] == ["cpu", "cpu"] and rows[0]["shared"]

