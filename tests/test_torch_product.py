"""``cli product`` (``tools/product.py``): the five-preset product record.

On the CPU at small sizes: the record's entries against the reference's
``tools/product.run_config(cfg, "numpy")`` (same histograms and summary),
the record valid in both packages' schema, ``--counters`` from a plain run,
``--backend`` other than torch refused by name, a missing card named, the
merge of two invocations into one record, and the previous-round guard,
which reads the port's own records only and never names the reference's
``artifacts/product_r*.json``.
"""

import json
import pathlib

import pytest
import torch

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.obs import record as ref_record
from byzantinerandomizedconsensus_tpu.tools import product as ref_product
from byzantinerandomizedconsensus_tpu_torch import cli
from byzantinerandomizedconsensus_tpu_torch.obs import record
from byzantinerandomizedconsensus_tpu_torch.tools import product

SAME = ("protocol", "n", "f", "adversary", "coin", "delivery", "faults", "seed", "instances",
        "decided", "decided_fraction", "undecided_at_cap", "round_cap",
        "mean_rounds_decided", "max_rounds", "rounds_p50", "rounds_p90", "rounds_p99",
        "decision_histogram", "round_histogram")


def _run(argv, capsys):
    rc = cli.main(["product", *argv])
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(lines[-1])


def test_product_entry_equals_the_references_numpy_run_config(tmp_path, capsys):
    out = tmp_path / "p.json"
    rc, last = _run(["--device", "cpu", "--configs", "config1", "--repeats", "1",
                     "--out", str(out)], capsys)
    assert rc == 0 and last["platform"] == "cpu" and last["configs"] == ["config1"]
    doc = json.loads(out.read_text())
    want, _ = ref_product.run_config(ref_config.PRESETS["config1"].validate(), "numpy",
                                     timed_repeats=1)
    got = doc["config1"]
    for k in SAME:
        assert got[k] == want[k], k
    assert set(want) - {"device_busy_error"} <= set(got)
    assert got["backend"] == "torch" and got["kernel"] == "plain" and got["device"] == "cpu"
    assert got["platform"] == "cpu" and len(got["walls_s"]) == 1
    # A host run has no device trace: an error entry, never a 0.0 measurement.
    assert "device_busy_s" not in got and "no device trace" in got["device_busy_error"]
    assert doc["kind"] == "product"
    assert record.validate_record(doc) == [] == ref_record.validate_record(doc)


def test_product_merges_invocations_and_matches_the_shipped_histograms(tmp_path, capsys):
    out = tmp_path / "p.json"
    assert _run(["--device", "cpu", "--configs", "config1", "--repeats", "1",
                 "--out", str(out)], capsys)[0] == 0
    rc, last = _run(["--device", "cpu", "--configs", "config3", "--repeats", "1",
                     "--counters", "--out", str(out)], capsys)
    assert rc == 0 and last["configs"] == ["config1", "config3"]
    doc = json.loads(out.read_text())
    shipped = json.loads((pathlib.Path(__file__).resolve().parents[1]
                          / "artifacts" / "product_r5.json").read_text())
    for name in ("config1", "config3"):
        for k in ("decision_histogram", "round_histogram", "instances", "round_cap"):
            assert doc[name][k] == shipped[name][k], (name, k)
    assert doc["config3"]["counters"]["supported"] is True
    assert "counters" not in doc["config1"]
    assert record.validate_record(doc) == [] == ref_record.validate_record(doc)


def test_product_refuses_another_backend_and_names_a_missing_card(tmp_path, capsys,
                                                                  monkeypatch):
    assert cli.main(["product", "--backend", "numpy", "--out", str(tmp_path / "a.json")]) == 2
    assert "torch backend only" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["product", "--configs", "config1", "--out",
                     str(tmp_path / "b.json")]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "a.json").exists() and not (tmp_path / "b.json").exists()


def test_vs_prev_round_reads_the_ports_own_records_only(tmp_path, capsys, monkeypatch):
    """The default record lands in the port's directory, the guard looks
    there (never at the reference's ``artifacts/product_r*.json``), and a
    previous entry of the same platform and backend yields the verdict."""
    seen = {}

    def prev(stem, subdir="", usable=None, root=None):
        seen["subdir"] = subdir
        return ("product_r4.json", 4, {"config1": {"instances_per_sec": 10.0,
                                                   "platform": "cpu", "backend": "torch",
                                                   "device_busy_s": None}})

    monkeypatch.setattr(product, "prev_round_artifact", prev)
    out = tmp_path / "p.json"
    assert _run(["--device", "cpu", "--configs", "config1", "--repeats", "2",
                 "--out", str(out)], capsys)[0] == 0
    entry = json.loads(out.read_text())["config1"]
    assert seen["subdir"] == product.RECORD_DIR == "artifacts/port"
    assert entry["prev_round_artifact"] == "product_r4.json"
    assert entry["vs_prev_round"] == round(entry["instances_per_sec"] / 10.0, 3)
    assert "walls_spread" in entry and "regression_signal" in entry
    assert product.default_artifact("product", subdir=product.RECORD_DIR).startswith(
        "artifacts/port/product_r")


@pytest.mark.parametrize("name", product.CONFIGS)
def test_shipped_configs_are_the_references(name):
    cfg = product.shipped_config(name)
    if name == "config5":
        want = ref_config.sweep_point(ref_config.SWEEP_POINT_N)
    else:
        want = ref_config.PRESETS[name].validate()
    assert cfg.__dict__ == want.__dict__


def test_product_fails_where_repeated_runs_differ(monkeypatch):
    """The timed runs are held against the first, rounds and decisions:
    a run that differs fails the record rather than entering it."""
    import dataclasses

    from byzantinerandomizedconsensus_tpu_torch.backends import get_backend
    from byzantinerandomizedconsensus_tpu_torch.config import preset

    be = get_backend("torch", device="cpu")
    cfg = preset("config1", instances=4)
    real, calls = be.run, []

    def drifting(c, inst_ids=None):
        res = real(c, inst_ids)
        calls.append(c)
        if len(calls) == 2:
            res = dataclasses.replace(res, decision=res.decision ^ 1)
        return res

    monkeypatch.setattr(be, "run", drifting)
    with pytest.raises(RuntimeError, match="repeated runs differ"):
        product.run_config(cfg, be, 3)
    monkeypatch.setattr(be, "run", real)
    entry, walls = product.run_config(cfg, be, 3)
    assert len(walls) == 3 and entry["decision_histogram"]
