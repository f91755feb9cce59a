"""The port's adversary hunter (hunt/) against the reference on the CPU.

The port's copies of the reference's ``tests/test_hunt.py`` cases (space
admissibility, strategy determinism, the archive and its replay, the
bounded WorkFeed, the serving-stack smoke), then the port held against the
reference: the space and every strategy draw for draw, the bucket labels
that fix the tell order, ``fitness_of`` and the archive's export doc, the
committed ``artifacts/hunt_regressions.json`` replayed bit for bit through
the port's torch backend, and whole hunts through the port's
``ConsensusServer`` (in process and over HTTP) the direct leg's warm-up reaching every
kernel library of the space, and ``cli hunt`` asked for the card with none
present exiting 2 naming it. Whole hunts through the server are in
``tests/test_torch_hunt_serve.py``.
"""

import dataclasses
import json
import pathlib
import random

import pytest
import torch

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.backends.batch import FusedBucket as RefFusedBucket
from byzantinerandomizedconsensus_tpu.hunt import archive as ref_archive
from byzantinerandomizedconsensus_tpu.hunt import hunter as ref_hunter
from byzantinerandomizedconsensus_tpu.hunt import space as ref_space
from byzantinerandomizedconsensus_tpu.hunt import strategies as ref_strategies
from byzantinerandomizedconsensus_tpu.tools import sampler as ref_sampler
from byzantinerandomizedconsensus_tpu_torch import cli
from byzantinerandomizedconsensus_tpu_torch.backends import get_backend
from byzantinerandomizedconsensus_tpu_torch.backends.batch import FusedBucket
from byzantinerandomizedconsensus_tpu_torch.backends.compaction import (
    CompactionPolicy, WorkFeed, WorkFeedOverflow)
from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import TorchBackend
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.hunt import archive as hunt_archive
from byzantinerandomizedconsensus_tpu_torch.hunt import hunter as hunt_hunter
from byzantinerandomizedconsensus_tpu_torch.hunt import space as hunt_space
from byzantinerandomizedconsensus_tpu_torch.hunt.archive import Archive
from byzantinerandomizedconsensus_tpu_torch.hunt.hunter import Hunter, fitness_of
from byzantinerandomizedconsensus_tpu_torch.hunt.space import SearchSpace
from byzantinerandomizedconsensus_tpu_torch.hunt.strategies import (
    STRATEGIES, make_strategy)
from byzantinerandomizedconsensus_tpu_torch.obs import record
from byzantinerandomizedconsensus_tpu_torch.tools import loadgen, sampler

ROOT = pathlib.Path(__file__).resolve().parents[1]
_POLICY = CompactionPolicy(width=8, segment=1)
TIMEOUT = 600.0


def _fake_fitness(cfg) -> float:
    """A deterministic stand-in evaluator: a pure function of the genome,
    so strategy determinism can be tested without a server."""
    blob = json.dumps(hunt_space.encode(cfg), sort_keys=True)
    return float(sum(blob.encode()) % 997)


def _ref_cfg(cfg):
    return ref_config.SimConfig(**dataclasses.asdict(cfg))


def _doc(cfg) -> dict:
    return dataclasses.asdict(cfg)


# ---- space ----------------------------------------------------------------


def test_space_shares_the_chaos_sampler_laws():
    """The hunt space draws THROUGH tools/sampler.py: same draw sequence,
    same (generator_version, seed) contract as `cli chaos`."""
    sp = SearchSpace()
    assert sp.generator_version == sampler.GENERATOR_VERSION
    assert sp.sample(random.Random(123)) == sampler.random_config(
        random.Random(123), chaos=True)


def test_space_candidates_are_admissible_everywhere():
    """Sampled, mutated, crossed and region-pinned candidates all pass
    validate() and stay inside the serving envelope (one fused tier,
    round_cap within the default feed ceiling)."""
    sp = SearchSpace()
    rng = random.Random(42)
    pool = [sp.sample(rng) for _ in range(30)]
    pool.extend(sp.mutate(cfg, rng) for cfg in list(pool))
    for a, b in zip(pool[:20], pool[20:40]):
        pool.append(sp.crossover(a, b, rng))
    for region in sp.regions():
        pool.append(sp.sample_region(region, rng))
    for cfg in pool:
        cfg.validate()  # raises on an inadmissible candidate
        assert cfg.n <= sp.max_n
        assert cfg.round_cap <= 128
        assert FusedBucket.of(cfg) in sp.buckets()


def test_space_committee_scale_wing():
    """SearchSpace(committee_scale=True): §10 committee genomes ride the
    pow2 tiers past n ≤ 40, every candidate decodes admissibly (sortition f
    ceiling included), and the bucket universe stays closed at
    10 + 2·len(COMMITTEE_N_TIERS)."""
    sp = SearchSpace(committee_scale=True)
    buckets = sp.buckets()
    tiers = hunt_space.COMMITTEE_N_TIERS
    assert len(buckets) == 10 + 2 * len(tiers)
    assert len(set(buckets)) == len(buckets)
    assert all(t & (t - 1) == 0 for t in tiers)  # pow2, tier-exact
    assert 1_000 <= tiers[0] and tiers[-1] <= 131_072

    big = 0
    for seed in range(120):
        rng = random.Random(seed)
        base = SimConfig(protocol="bracha", n=20, f=3, instances=8,
                         adversary="adaptive", delivery="committee",
                         seed=seed, round_cap=32).validate()
        m = sp.mutate(base, rng)
        m.validate()
        assert FusedBucket.of(m) in buckets
        if m.n > sp.max_n:
            big += 1
            assert m.delivery == "committee" and m.n in tiers
            # crossing with a full-mesh parent must clamp n back under
            # the fold: delivery gates the committee wing
            child = sp.crossover(m, sp.sample(rng), rng)
            child.validate()
            assert child.delivery == "committee" or child.n <= sp.max_n
            assert FusedBucket.of(child) in buckets
    assert big >= 1  # the wing is actually reachable

    # the default space is the 10-bucket universe
    assert len(SearchSpace().buckets()) == 10
    assert SearchSpace().doc()["committee_n_tiers"] == []
    sp = SearchSpace()
    buckets = sp.buckets()
    assert len(buckets) == 10
    assert len(set(buckets)) == 10
    rng = random.Random(7)
    for _ in range(60):
        assert FusedBucket.of(sp.sample(rng)) in buckets


def test_space_region_pinning_survives_repair():
    """sample_region must return a candidate IN the region (the bandit
    attributes tells by the candidate's own axes) even where the forced
    adversary needs a larger shape."""
    sp = SearchSpace()
    rng = random.Random(5)
    for region in sp.regions():
        for _ in range(5):
            cfg = sp.sample_region(region, rng)
            assert (cfg.adversary, cfg.delivery) == region


def test_genome_roundtrip():
    sp = SearchSpace()
    cfg = sp.sample(random.Random(9))
    assert hunt_space.decode(hunt_space.encode(cfg)) == cfg


@pytest.mark.parametrize("committee_scale", [False, True])
def test_space_draws_equal_the_references(committee_scale):
    """sample, mutate, crossover and sample_region draw the reference's
    candidates on 200 seeds (mutation from a committee parent under the
    committee wing), and buckets() and doc() are the reference's."""
    sp = SearchSpace(committee_scale=committee_scale)
    rsp = ref_space.SearchSpace(committee_scale=committee_scale)
    assert [b.label() for b in sp.buckets()] == [b.label() for b in rsp.buckets()]
    assert sp.doc() == rsp.doc()
    assert sp.regions() == rsp.regions()
    regions = sp.regions()
    for seed in range(200):
        rng, rrng = random.Random(seed), random.Random(seed)
        a, ra = sp.sample(rng), rsp.sample(rrng)
        assert _doc(a) == dataclasses.asdict(ra)
        if committee_scale:
            a = sp.materialize(dict(hunt_space.encode(a), delivery="committee"))
            ra = rsp.materialize(dict(ref_space.encode(ra), delivery="committee"))
        m, rm = sp.mutate(a, rng), rsp.mutate(ra, rrng)
        assert _doc(m) == dataclasses.asdict(rm)
        c, rc = sp.crossover(a, m, rng), rsp.crossover(ra, rm, rrng)
        assert _doc(c) == dataclasses.asdict(rc)
        region = regions[seed % len(regions)]
        s, rs = sp.sample_region(region, rng), rsp.sample_region(region, rrng)
        assert _doc(s) == dataclasses.asdict(rs)


def test_bucket_labels_equal_the_references():
    """The tell order is each generation sorted by bucket label: the port's
    FusedBucket.label() is the reference's on 300 chaos-sampler seeds."""
    for seed in range(300):
        cfg = sampler.random_config(random.Random(seed), chaos=True)
        ref = ref_sampler.random_config(random.Random(seed), chaos=True)
        assert _doc(cfg) == dataclasses.asdict(ref)
        assert FusedBucket.of(cfg).label() == RefFusedBucket.of(ref).label()


# ---- strategies -----------------------------------------------------------


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_strategy_deterministic_from_name_and_seed(name):
    """Two strategies built from the same (strategy, seed) produce the
    identical candidate stream under the identical tell stream: the
    reproducibility contract a hunt rests on."""
    def run(seed):
        st = make_strategy(name, SearchSpace(), seed)
        out = []
        for _ in range(40):
            cfg = st.ask()
            st.tell(cfg, _fake_fitness(cfg))
            out.append(hunt_space.encode(cfg))
        return out, st.best_fitness

    a, best_a = run(11)
    b, best_b = run(11)
    assert a == b
    assert best_a == best_b
    c, _ = run(12)
    assert a != c  # a different seed moves the stream


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_strategy_candidates_admissible(name):
    st = make_strategy(name, SearchSpace(), 3)
    for _ in range(30):
        cfg = st.ask()
        cfg.validate()
        st.tell(cfg, _fake_fitness(cfg))


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_strategy_asks_equal_the_references(name):
    """Every strategy asks the reference's candidates over 40 evaluations
    under the same tell stream, and ends in the reference's state."""
    assert sorted(STRATEGIES) == sorted(ref_strategies.STRATEGIES)
    st = make_strategy(name, SearchSpace(), 11)
    ref = ref_strategies.make_strategy(name, ref_space.SearchSpace(), 11)
    for _ in range(40):
        cfg, rcfg = st.ask(), ref.ask()
        assert _doc(cfg) == dataclasses.asdict(rcfg)
        fit = _fake_fitness(cfg)
        st.tell(cfg, fit)
        ref.tell(rcfg, fit)
    assert st.best_fitness == ref.best_fitness
    assert st.doc() == ref.doc()


def test_bandit_halves_regions():
    sp = SearchSpace()
    st = make_strategy("bandit", sp, 1)
    n0 = len(st._active)
    for _ in range(len(sp.regions()) * st.RUNG0):
        cfg = st.ask()
        st.tell(cfg, _fake_fitness(cfg))
    assert len(st._active) == max(1, n0 // 2)
    assert st._rung == 1


def test_cma_adapts_and_stays_deterministic():
    """The continuous strategy: generations close every λ tells, the latent
    mean/step-sizes move off their initial point, categorical tables stay
    normalized with the exploration floor, and the whole trajectory
    (including the internal state) is a pure function of (strategy, seed)
    and the tell sequence."""
    def run(seed):
        st = make_strategy("cma", SearchSpace(), seed)
        for _ in range(3 * st.LAMBDA):
            cfg = st.ask()
            st.tell(cfg, _fake_fitness(cfg))
        return st

    a, b = run(5), run(5)
    assert a.generation == 3
    assert a.doc() == b.doc()
    assert a._mean == b._mean and a._sigma == b._sigma
    assert a._tables == b._tables
    # adaptation actually happened: some axis moved off the init point
    assert a._mean != [0.5] * len(a.AXES) or \
        a._sigma != [a.SIGMA0] * len(a.AXES)
    for axis, probs in a._tables.items():
        assert abs(sum(probs) - 1.0) < 1e-9
        assert min(probs) >= a.CAT_FLOOR - 1e-9
    # in-flight pipelined asks don't leak: pending drains as tells arrive
    assert not a._pending


def test_unknown_strategy_rejected():
    with pytest.raises(ValueError, match="unknown strategy"):
        make_strategy("gradient", SearchSpace(), 0)


# ---- archive --------------------------------------------------------------


def test_archive_keeps_topk_sorted_and_dedupes():
    sp = SearchSpace()
    rng = random.Random(2)
    a = Archive(4)
    cfgs = [sp.sample(rng) for _ in range(12)]
    for i, cfg in enumerate(cfgs):
        a.offer(cfg, float(i), [1, 2], [1, 1])
    assert len(a) == 4
    fits = [e["fitness"] for e in a.entries()]
    assert fits == sorted(fits, reverse=True)
    assert fits == [11.0, 10.0, 9.0, 8.0]
    # re-offering an archived genome is a no-op (distinct worst cases only)
    assert a.offer(cfgs[-1], 99.0, [1, 2], [1, 1]) is False
    assert len(a) == 4


def test_archive_replay_detects_drift():
    sp = SearchSpace()
    cfg = sp.sample(random.Random(31))
    res = get_backend("torch", device="cpu").run(cfg)
    a = Archive(2)
    a.offer(cfg, 5.0, res.rounds, res.decision)
    entry = a.best()
    assert hunt_archive.replay(entry, "cpu")["ok"]
    tampered = dict(entry)
    tampered["rounds"] = [r + 1 for r in entry["rounds"]]
    verdict = hunt_archive.replay(tampered, "cpu")
    assert not verdict["ok"] and verdict["mismatches"] > 0


def _committed_regressions():
    return json.loads((ROOT / "artifacts" / "hunt_regressions.json").read_text())


def test_committed_archive_replays_bit_identically():
    """Every archived worst case of the committed artifact replays bit for
    bit (digest included) through the port's torch backend on the CPU."""
    doc = _committed_regressions()
    assert len(doc["entries"]) == 8
    for entry in doc["entries"]:
        verdict = hunt_archive.replay(entry, "cpu")
        assert verdict == {"ok": True, "digest_ok": True, "mismatches": 0}, entry["genome"]


def test_committed_archive_replays_bit_identically_on_the_mesh():
    """The top archived worst case replays bit for bit through the mesh's
    driver too (``virtual:1x2``, two replica shards): another backend, the
    same arrays."""
    doc = _committed_regressions()
    verdict = hunt_archive.replay(doc["entries"][0], "cpu", backend="virtual:1x2")
    assert verdict["ok"], verdict


# ---- fitness --------------------------------------------------------------


def test_fitness_weights_liveness_cliff():
    cfg = SimConfig(protocol="benor", n=7, f=1, instances=4,
                    adversary="crash", round_cap=64).validate()
    decided = fitness_of(cfg, [3, 5, 4, 4], [1, 0, 1, 1])
    capped = fitness_of(cfg, [64, 64, 64, 64], [2, 2, 2, 2])
    assert decided["undecided_fraction"] == 0.0
    assert capped["undecided_fraction"] == 1.0
    # an undecided-at-cap population dominates any decided one
    assert capped["fitness"] > decided["fitness"] + cfg.round_cap / 2


def test_fitness_and_export_doc_equal_the_references():
    """fitness_of and the archive's export doc (``env`` aside) are the
    reference's on the same candidates and arrays."""
    sp, rng = SearchSpace(), random.Random(4)
    a, ra = Archive(3), ref_archive.Archive(3)
    for i in range(6):
        cfg = sp.sample(rng)
        rounds = [(i * 7 + j) % cfg.round_cap + 1 for j in range(cfg.instances)]
        decision = [(i + j) % 3 for j in range(cfg.instances)]
        fit = fitness_of(cfg, rounds, decision)
        assert fit == ref_hunter.fitness_of(_ref_cfg(cfg), rounds, decision)
        a.offer(cfg, fit["fitness"], rounds, decision)
        ra.offer(_ref_cfg(cfg), fit["fitness"], rounds, decision)
    stats = {"strategy": "evolution", "seed": 1, "budget": 6, "evaluations": 6,
             "generations": 1, "best_fitness": a.best()["fitness"], "archive_size": 3,
             "violations": 0, "steady_state_compiles": 0}
    doc, rdoc = a.export_doc(stats), ra.export_doc(stats)
    doc.pop("env")
    rdoc.pop("env")
    assert doc == rdoc


# ---- bounded WorkFeed (backpressure) --------------------------------------


def test_workfeed_default_stays_unbounded():
    feed = WorkFeed(round_cap_ceiling=64)
    assert feed.max_depth is None
    cfg = SimConfig(protocol="benor", n=4, f=0, instances=1,
                    round_cap=32).validate()
    for _ in range(300):  # far past any plausible implicit bound
        feed.push(cfg)
    assert feed.pending() == 300


def test_workfeed_bounded_rejects_overflow_by_name():
    feed = WorkFeed(round_cap_ceiling=64, max_depth=2)
    cfg = SimConfig(protocol="benor", n=4, f=0, instances=1,
                    round_cap=32).validate()
    feed.push(cfg)
    feed.push(cfg)
    with pytest.raises(WorkFeedOverflow, match="max_depth"):
        feed.push(cfg)
    # a drain (pull) frees depth again
    assert len(feed.pull()) == 2
    feed.push(cfg)
    with pytest.raises(ValueError, match="max_depth"):
        WorkFeed(max_depth=0)


# ---- the closed loop ------------------------------------------------------


@pytest.fixture(scope="module")
def server():
    """One CPU server (the lane leg) for the module's hunts."""
    from byzantinerandomizedconsensus_tpu_torch.serve.server import ConsensusServer
    srv = ConsensusServer(backend=get_backend("torch", device="cpu"), policy=_POLICY)
    srv.start()
    yield srv
    srv.shutdown(drain=True)


@pytest.mark.slow
def test_mini_hunt_smoke_pipelined(server):
    """A seeded in-process mini-hunt over the real serving stack: budget
    harvested exactly, all archive entries admissible, elite fitness
    monotone non-increasing down the archive, best == archive head, and
    the safety alarm quiet."""
    sp = SearchSpace()
    hunter = Hunter(server, make_strategy("evolution", sp, 5), space=sp,
                    archive=Archive(4), generation=6, pipelined=True,
                    check_invariants=True)
    stats = hunter.run(18)
    assert stats["evaluations"] == 18
    assert stats["generations"] == 3
    assert stats["violations"] == 0
    assert 1 <= stats["archive_size"] <= 4
    fits = [e["fitness"] for e in hunter.archive.entries()]
    assert fits == sorted(fits, reverse=True)
    assert stats["best_fitness"] == pytest.approx(fits[0])
    for entry in hunter.archive.entries():
        hunt_space.decode(entry["genome"])  # replayable genome
    # the stats dict is a valid schema-v1.8 hunt block
    stats["steady_state_compiles"] = 0
    doc = record.new_record("hunt")
    doc["hunt"] = record.hunt_block(stats)
    assert record.validate_record(doc) == []


def test_mini_hunt_reply_invariants_flow_to_hunter(server):
    """check_invariants=True: the reply record itself carries the verdict
    block (no client second pass)."""
    sp = SearchSpace()
    cfg = sp.sample(random.Random(77))
    rec = server.submit(cfg, check_invariants=True).wait(timeout=TIMEOUT)
    inv = rec["invariants"]
    assert inv["checked_instances"] == cfg.instances
    assert inv["agreement_ok"] is True and inv["validity_ok"] is True
    assert inv["violations"] == 0
    # and stays opt-in: a plain submit carries no invariants block
    rec2 = server.submit(cfg).wait(timeout=TIMEOUT)
    assert "invariants" not in rec2


def test_library_sample_reaches_every_library_of_the_space():
    """On the direct leg the warm-up loads one candidate per kernel library
    the space reaches: the six of n ≤ 40, and under the committee wing the
    committee libraries of every tier."""
    card = TorchBackend.__new__(TorchBackend)
    card.kernel, card.device = None, torch.device("cuda")
    libs = {loadgen.library_of(card, c)
            for c in loadgen.library_configs(card, hunt_hunter.library_sample(SearchSpace()))}
    assert libs == {"fused_round", "fused_round_urn_r1", "fused_round_urn3_r1",
                    "fused_round_committee_r1", "keys_step", "keys_step_wide"}
    rng = random.Random(3)
    sp = SearchSpace()
    assert {loadgen.library_of(card, sp.sample(rng)) for _ in range(400)} - {None} <= libs
    wide = {loadgen.library_of(card, c) for c in loadgen.library_configs(
        card, hunt_hunter.library_sample(SearchSpace(committee_scale=True)))}
    assert wide == libs | {"fused_round_committee_r4", "fused_round_committee_r0"}


def test_cli_hunt_without_a_card_exits_2_naming_it(tmp_path, capsys):
    out = tmp_path / "hunt.json"
    assert cli.main(["hunt", "--budget", "4", "--out", str(out)]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not out.exists()


@pytest.mark.parametrize("kernel", ["fused", "step"])
def test_cli_hunt_refuses_a_kernel_that_runs_part_of_the_space(kernel, capsys):
    assert cli.main(["hunt", "--device", "cpu", "--kernel", kernel]) == 2
    assert f"--kernel {kernel} runs only part" in capsys.readouterr().err
