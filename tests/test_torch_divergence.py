"""The port's divergence tool (tools/divergence.py) against the reference's
on the CPU: the same grids, and row for row the same fields at small
instance counts — the delivery-law pairs through the C++ core (the
port's default) against the reference's numpy backend, the §9 fault rows
and the §10 committee rows (with the measured f_C tail) through the
plain torch driver on the CPU against numpy. Equality, not tolerance:
every field is computed from per-instance integers the two packages draw
from one PRF.
"""

import dataclasses
import json

import pytest

from byzantinerandomizedconsensus_tpu.tools import divergence as ref_div
from byzantinerandomizedconsensus_tpu_torch.backends import get_backend
from byzantinerandomizedconsensus_tpu_torch.tools import divergence as div

SMALL = 12


def _rows_equal(got, want, skip=("backend",)):
    assert set(got) == set(want)
    diff = {k: (got[k], want[k]) for k in want if k not in skip and got[k] != want[k]}
    assert diff == {}


def test_grids_and_pairs_equal_the_reference():
    def doc(grid):
        return [dataclasses.asdict(c) if not isinstance(c, tuple)
                else (dataclasses.asdict(c[0]), c[1]) for c in grid]

    assert doc(div.GRID) == doc(ref_div.GRID)
    assert doc(div.FULL_GRID) == doc(ref_div.FULL_GRID)
    assert doc(div.FAULT_GRID) == doc(ref_div.FAULT_GRID)
    assert doc(div.COMMITTEE_GRID) == doc(ref_div.COMMITTEE_GRID)
    assert div.PAIRS == ref_div.PAIRS and div.DELIVERIES == ref_div.DELIVERIES
    assert div.FAULT_KINDS_MEASURED == ref_div.FAULT_KINDS_MEASURED
    assert div.COMMITTEE_MESH_REFERENCE == ref_div.COMMITTEE_MESH_REFERENCE


@pytest.mark.parametrize("i", range(len(div.GRID)))
def test_compare_row_through_native_equals_the_reference(i):
    cfg, _ = div.GRID[i]
    ref_cfg, _ = ref_div.GRID[i]
    got = div.compare_row(cfg, SMALL, "native")
    _rows_equal(got, ref_div.compare_row(ref_cfg, SMALL, "numpy"))


@pytest.mark.parametrize("i", range(len(div.FAULT_GRID)))
def test_fault_row_through_torch_equals_the_reference(i):
    got = div.fault_row(div.FAULT_GRID[i], SMALL, get_backend("torch", device="cpu"))
    want = ref_div.fault_row(ref_div.FAULT_GRID[i], SMALL, "numpy")
    _rows_equal(got, want)
    assert got["backend"] == "torch"


@pytest.mark.parametrize("i", range(len(div.COMMITTEE_GRID)))
def test_committee_row_and_fc_tail_equal_the_reference(i):
    got = div.committee_row(div.COMMITTEE_GRID[i], 8, get_backend("torch", device="cpu"))
    _rows_equal(got, ref_div.committee_row(ref_div.COMMITTEE_GRID[i], 8, "numpy"))
    assert got["fc_bound_holds"]


def test_preset_row_through_native_equals_the_reference():
    from byzantinerandomizedconsensus_tpu import config as ref_config
    from byzantinerandomizedconsensus_tpu_torch.config import preset

    got = div.preset_row("config3", preset("config3"), SMALL, "native")
    _rows_equal(got, ref_div.preset_row("config3", ref_config.preset("config3"),
                                        SMALL, "numpy"))


def test_cli_rows_and_summaries_equal_the_reference(tmp_path, capsys):
    out = tmp_path / "div.json"
    assert div.main(["--out", str(out), "--instances", "6", "--device", "cpu",
                     "--faults", "--fault-instances", "6",
                     "--committee", "--committee-instances", "6"]) == 0
    got = json.loads(out.read_text())
    want = ref_div.run_divergence(instances=6, backend="numpy", faults=True,
                                  fault_instances=6, committee=True,
                                  committee_instances=6, progress=lambda *a: None)
    assert got["summary"] == want["summary"]
    for key in ("rows", "fault_rows", "committee_rows"):
        assert len(got[key]) == len(want[key])
        for g, w in zip(got[key], want[key]):
            _rows_equal(g, w)
    assert {r["backend"] for r in got["rows"]} == {"native"}
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["out"] == str(out)


def test_batched_grid_takes_the_lane_runner_and_equals_per_config(tmp_path):
    lanes = get_backend("torch", device="cpu", kernel="plain")
    got = div.run_divergence(instances=4, backend=lanes, batched=True, faults=True,
                             fault_instances=4, progress=lambda *a: None)
    per = div.run_divergence(instances=4, backend="native", faults=True,
                             fault_instances=4, device="cpu", progress=lambda *a: None)
    assert got["summary"] == per["summary"]
    assert all(r["batched"] for r in got["rows"])
    assert got["batch"]["configs"] == len(div.GRID) * len(div.DELIVERIES)
    assert div.main(["--out", str(tmp_path / "x.json"), "--batched",
                     "--backend", "native"]) == 2


def test_cuda_without_a_card_exits_nonzero_by_name(capsys):
    assert div.main(["--out", "/dev/null", "--backend", "torch", "--instances", "2"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
