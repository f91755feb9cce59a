"""The port's fused round kernel on a CUDA card against its plain torch
version, under every §9 fault schedule, and on its urn, urn3 and committee
laws in each layout (n ≤ 1024, n ≤ 4096, past 4096); the per-step keys and
urn kernels against theirs on both protocols, every static adversary and
both packing laws; the replica-sharded mesh (``parallel/sharded.py``)
through the per-step kernels with receiver offsets and through the fused
kernel, against the unsharded kernels. Each test needs a card, is marked
``cuda`` and skips by name without one; this file imports only the port,
so it runs where JAX is not installed:

    python -m pytest tests/test_torch_card.py -m cuda -q
"""

import pytest
import torch

from byzantinerandomizedconsensus_tpu_torch import get_backend, preset
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig, committee_point
from byzantinerandomizedconsensus_tpu_torch.models import driver
from byzantinerandomizedconsensus_tpu_torch.ops import fused_round, keys_step, urn_step
from byzantinerandomizedconsensus_tpu_torch.parallel.mesh import make_mesh
from byzantinerandomizedconsensus_tpu_torch.parallel.sharded import TorchShardedBackend

KINDS = ("none", "recover", "partition", "omission")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_plain_under_each_schedule(card, kind):
    for protocol, adversary, f in (("bracha", "none", 21), ("benor", "byzantine", 12),
                                   ("bracha", "adaptive", 21), ("benor", "crash", 31)):
        cfg = SimConfig(protocol=protocol, n=64, f=f, instances=256, adversary=adversary,
                        coin="shared", delivery="urn2", round_cap=16, faults=kind).validate()
        ids = torch.arange(cfg.instances, dtype=torch.int32, device=card)
        got = fused_round.run_chunk(cfg, ids)
        want = fused_round.run_chunk_plain(cfg, ids)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS[1:])
def test_backend_runs_config4_under_each_schedule_through_the_kernel(card, kind):
    cfg = preset("config4", faults=kind)
    fused_round.launches = 0
    res = get_backend("torch").run(cfg, inst_ids=list(range(512)))
    assert fused_round.launches == 1
    want = fused_round.run_chunk_plain(cfg, torch.arange(512, dtype=torch.int32,
                                                         device=card))
    assert res.rounds.tolist() == want[0].tolist()
    assert res.decision.tolist() == want[1].tolist()


LAW_CASES = [("urn3", 64, 21), ("urn3", 2048, 682), ("committee", 64, 12),
             ("committee", 2048, 409), ("committee", 8192, 1638), ("urn2", 2048, 682),
             ("urn", 64, 21), ("urn", 2048, 682)]


@pytest.mark.cuda
@pytest.mark.parametrize("law,n,f", LAW_CASES, ids=[f"{c[0]}-n{c[1]}" for c in LAW_CASES])
def test_kernel_matches_plain_on_each_law_and_layout(card, law, n, f):
    for adversary, kind in (("none", "none"), ("adaptive", "omission"),
                            ("byzantine", "partition"), ("crash", "recover")):
        cfg = SimConfig(protocol="bracha", n=n, f=f, instances=32, adversary=adversary,
                        coin="shared", delivery=law, round_cap=12, faults=kind).validate()
        ids = torch.arange(cfg.instances, dtype=torch.int32, device=card)
        got = fused_round.run_chunk(cfg, ids)
        want = fused_round.run_chunk_plain(cfg, ids)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), cfg


@pytest.mark.cuda
def test_backend_runs_committee_point_past_v2_through_the_kernel(card):
    cfg = committee_point(131_072, instances=16)
    fused_round.launches = 0
    res = get_backend("torch").run(cfg)
    assert fused_round.launches == 1
    want = fused_round.run_chunk_plain(cfg, torch.arange(16, dtype=torch.int32,
                                                         device=card))
    assert res.rounds.tolist() == want[0].tolist()
    assert res.decision.tolist() == want[1].tolist()


STEP_CASES = [(law, protocol, adversary, n) for law in ("keys", "urn")
              for protocol, adversary in (("benor", "crash"), ("benor", "byzantine"),
                                          ("benor", "adaptive"), ("bracha", "crash"),
                                          ("bracha", "byzantine"), ("bracha", "adaptive_min"))
              for n in (64, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("law,protocol,adversary,n", STEP_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}-n{c[3]}" for c in STEP_CASES])
def test_step_kernels_match_plain_on_both_protocols_and_packs(card, law, protocol,
                                                               adversary, n):
    lying = adversary != "crash"
    f = (n - 1) // 3 if protocol == "bracha" else (n - 1) // (5 if lying else 2)
    cfg = SimConfig(protocol=protocol, n=n, f=f, instances=64, adversary=adversary,
                    coin="shared", delivery=law, round_cap=3).validate()
    ids = torch.arange(8, dtype=torch.int32, device=card)
    kernel = {"keys": keys_step, "urn": urn_step}[law]
    got = driver.run_chunk(cfg, ids, counts_fn=kernel.counts_fn)
    want = driver.run_chunk(cfg, ids)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("law", ["keys", "urn"])
@pytest.mark.parametrize("layout", [(1, 4), (2, 2)])
def test_step_mesh_matches_the_unsharded_kernel(card, law, layout):
    cfg = SimConfig(protocol="bracha", n=64, f=21, instances=64, adversary="adaptive",
                    coin="shared", delivery=law, round_cap=16).validate()
    got = TorchShardedBackend(mesh=make_mesh(*layout, [card] * 4), kernel="step").run(cfg)
    want = get_backend("torch", kernel="step").run(cfg)
    assert (got.rounds == want.rounds).all() and (got.decision == want.decision).all()


@pytest.mark.cuda
def test_fused_mesh_matches_the_unsharded_kernel(card):
    cfg = SimConfig(protocol="bracha", n=64, f=21, instances=64, coin="shared",
                    delivery="urn2", round_cap=16).validate()
    got = TorchShardedBackend(mesh=make_mesh(2, 2, [card] * 4), kernel="fused").run(cfg)
    want = get_backend("torch").run(cfg)
    assert (got.rounds == want.rounds).all() and (got.decision == want.decision).all()
