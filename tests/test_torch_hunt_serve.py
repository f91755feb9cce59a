"""Whole hunts through the port's serving stack on the CPU, against the
reference.

The mini hunt of the reference's ``tests/test_hunt.py`` (evolution, seed
5, generation 6, budget 18, archive 4) through the port's
``ConsensusServer`` equals the reference's ``Hunter`` over its numpy
backend in evaluations, best fitness and every archive digest; the small
leg of ``artifacts/hunt_port/reference.json`` is what the port's hunt
gives; a hunt through ``RemoteServer`` over ``serve_http`` equals the same
hunt in process; and ``cli hunt`` on the CPU (the lane leg) exits 0 with
records both packages validate.
"""

import json
import pathlib
import threading

import pytest

from byzantinerandomizedconsensus_tpu.backends import get_backend as ref_get_backend
from byzantinerandomizedconsensus_tpu.hunt import archive as ref_archive
from byzantinerandomizedconsensus_tpu.hunt import hunter as ref_hunter
from byzantinerandomizedconsensus_tpu.hunt import space as ref_space
from byzantinerandomizedconsensus_tpu.hunt import strategies as ref_strategies
from byzantinerandomizedconsensus_tpu.obs import record as ref_record
from byzantinerandomizedconsensus_tpu_torch import cli
from byzantinerandomizedconsensus_tpu_torch.backends import get_backend
from byzantinerandomizedconsensus_tpu_torch.backends.compaction import CompactionPolicy
from byzantinerandomizedconsensus_tpu_torch.hunt import hunter as hunt_hunter
from byzantinerandomizedconsensus_tpu_torch.hunt.archive import Archive
from byzantinerandomizedconsensus_tpu_torch.hunt.hunter import Hunter
from byzantinerandomizedconsensus_tpu_torch.hunt.space import SearchSpace
from byzantinerandomizedconsensus_tpu_torch.hunt.strategies import make_strategy
from byzantinerandomizedconsensus_tpu_torch.obs import record

ROOT = pathlib.Path(__file__).resolve().parents[1]
_POLICY = CompactionPolicy(width=8, segment=1)
TIMEOUT = 600.0


@pytest.fixture(scope="module")
def server():
    """One CPU server (the lane leg) for the module's hunts."""
    from byzantinerandomizedconsensus_tpu_torch.serve.server import ConsensusServer
    srv = ConsensusServer(backend=get_backend("torch", device="cpu"), policy=_POLICY)
    srv.start()
    yield srv
    srv.shutdown(drain=True)


class _Done:
    def __init__(self, rec):
        self.rec = rec

    def wait(self, timeout=None):
        return self.rec


class _SyncNumpy:
    """The reference Hunter's submit contract over its numpy backend, run
    at submit (the adapter of artifacts/hunt_port/make_reference.py)."""

    def __init__(self):
        self.backend = ref_get_backend("numpy")

    def submit(self, cfg, check_invariants=False):
        res = self.backend.run(cfg)
        return _Done({"rounds": [int(r) for r in res.rounds],
                      "decision": [int(d) for d in res.decision]})


def _hunt(server, seed, generation, k, budget, invariants=False):
    sp = SearchSpace()
    h = Hunter(server, make_strategy("evolution", sp, seed), space=sp, archive=Archive(k),
               generation=generation, pipelined=True, check_invariants=invariants,
               wait_timeout=TIMEOUT)
    return h.run(budget), h


def _archive(h):
    return [(e["digest"], e["fitness"]) for e in h.archive.entries()]



def test_mini_hunt_equals_the_references(server):
    """The mini hunt (evolution, seed 5, generation 6, budget 18, archive
    4) through the port's ConsensusServer equals the reference's Hunter
    over its numpy backend: evaluations, best fitness and every digest."""
    stats, h = _hunt(server, 5, 6, 4, 18, invariants=True)
    rsp = ref_space.SearchSpace()
    ref = ref_hunter.Hunter(_SyncNumpy(), ref_strategies.make_strategy("evolution", rsp, 5),
                            space=rsp, archive=ref_archive.Archive(4), generation=6,
                            pipelined=True)
    rstats = ref.run(18)
    assert stats["violations"] == 0
    for key in ("evaluations", "generations", "best_fitness", "archive_size", "space"):
        assert stats[key] == rstats[key], key
    assert _archive(h) == [(e["digest"], e["fitness"]) for e in ref.archive.entries()]
    assert stats["best"] == rstats["best"]


def test_reference_file_small_leg_equals_the_ports_hunt(server):
    """artifacts/hunt_port/reference.json's small leg (evolution, seed 17,
    budget 16, generation 8, archive 4) is what the port's hunt gives."""
    leg = json.loads((ROOT / "artifacts/hunt_port/reference.json").read_text())["legs"]["c"]
    stats, h = _hunt(server, 17, leg["generation"], leg["archive_k"], leg["budget"])
    want = leg["pipelined"]
    assert (stats["evaluations"], stats["generations"], stats["best_fitness"]) == \
        (want["evaluations"], want["generations"], want["best_fitness"])
    assert _archive(h) == [(e["digest"], e["fitness"]) for e in want["archive"]]
    assert stats["space"] == leg["space"]


def test_remote_hunt_equals_the_in_process_hunt(server):
    """RemoteServer over the port's serve_http gives the in-process hunt."""
    from byzantinerandomizedconsensus_tpu_torch.serve.server import serve_http

    httpd = serve_http(server, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        remote = hunt_hunter.RemoteServer("http://%s:%s" % httpd.server_address[:2])
        assert remote.compile_count() is None
        stats, h = _hunt(remote, 9, 3, 4, 6)
    finally:
        httpd.shutdown()
        httpd.server_close()
    local_stats, local = _hunt(server, 9, 3, 4, 6)
    assert stats["evaluations"] == local_stats["evaluations"] == 6
    assert stats["best_fitness"] == local_stats["best_fitness"]
    assert _archive(h) == _archive(local)


def test_cli_hunt_on_the_cpu(tmp_path, capsys):
    """cli hunt on the CPU (the lane leg): rc 0, 0 steady-state builds, every
    replay ok, and its record and regressions doc valid in both packages."""
    out, reg = tmp_path / "hunt.json", tmp_path / "reg.json"
    assert cli.main(["hunt", "--device", "cpu", "--budget", "12", "--generation", "6",
                     "--no-control", "--policy", "width=8,segment=1", "--out", str(out),
                     "--regressions-out", str(reg)]) == 0
    doc, reg_doc = json.loads(out.read_text()), json.loads(reg.read_text())
    for validate in (record.validate_record, ref_record.validate_record):
        assert validate(doc) == [] and validate(reg_doc) == []
    assert doc["leg"] == "lanes" and doc["device"] == "cpu"
    assert doc["hunt"]["steady_state_compiles"] == 0 and doc["hunt"]["violations"] == 0
    assert doc["hunt"]["evaluations"] == 12 and doc["hunt"]["baseline_mean_rounds"] == 1.34375
    assert doc["replay_check"] and all(r["ok"] for r in doc["replay_check"])
    assert doc["by_kernel"]["lanes"]["evaluations"] == 12
    assert doc["hunt"]["best"]["digest"] == reg_doc["entries"][0]["digest"]
    assert reg_doc["hunt"]["evaluations"] == 12
    assert "steady_state_compiles=0" in capsys.readouterr().out
