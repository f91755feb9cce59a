"""``cli programs`` (``tools/programs.py``) over the kernel census
(``obs/programs.py``), against the reference's ``tests/test_programs.py``.

The reference's fourteen cases, where they apply. Three read HLO and have
no counterpart, since the port builds no XLA program:
``test_fingerprint_stable_against_renumbering_and_metadata`` and
``test_fingerprint_stable_across_real_compile_histories`` (HLO
fingerprints) and ``test_normalize_strips_metadata_and_ssa_only``
(``normalize_hlo``); in their place the kernel fingerprint's identity.
The bucket-program capture case becomes its port form: the lanes launch no
kernel, so a census-on lane run adds no entry and is bit-identical; the
shape-drift case runs one config at two sizes under the census. The rest
are copies: the inert census, the per-config seam, the grid inertness,
the ``programs`` block in both packages' schema, ``dump``, ``diff``,
``roofline``, ``census`` at a small size on the CPU and the CLI route.
Beside them: ``fused`` and ``dump --ops`` refused with exit code 2, and
``census`` naming a missing card.
"""

import json

import numpy as np
import pytest
import torch

from byzantinerandomizedconsensus_tpu.obs import record as ref_record
from byzantinerandomizedconsensus_tpu_torch import cli
from byzantinerandomizedconsensus_tpu_torch.backends.compaction import CompactionPolicy
from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import TorchBackend
from byzantinerandomizedconsensus_tpu_torch.config import (
    DELIVERY_KINDS, FAULT_KINDS, SimConfig)
from byzantinerandomizedconsensus_tpu_torch.obs import programs, record, trace
from byzantinerandomizedconsensus_tpu_torch.ops import _build, fused_round
from byzantinerandomizedconsensus_tpu_torch.tools import programs as programs_tool

#: A ``ptxas -v`` report of one fused_round instantiation (config4's).
PTXAS = """\
ptxas info    : Compiling entry function '_Z18fused_round_kernelILi1ELi0ELi0EEvPKiPKhS1_NS_11FaultPlanesEPiPhPjN3brc6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _Z18fused_round_kernelILi1ELi0ELi0EEvPKiPKhS1_NS_11FaultPlanesEPiPhPjN3brc6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 29 registers, used 1 barriers, 4 bytes smem, 448 bytes cmem[0]
"""


@pytest.fixture(autouse=True)
def _no_leftover_census():
    programs.disable()
    trace.disable()
    yield
    programs.disable()
    trace.disable()


@pytest.fixture
def ptxas_log(monkeypatch):
    monkeypatch.setattr(_build, "build_log", lambda name: PTXAS)


def _cfg(adv, proto, delivery, fault, n=7, f=2, seed=13, **kw):
    base = dict(protocol=proto, n=n, f=f, instances=4, adversary=adv, coin="local",
                seed=seed, round_cap=32, delivery=delivery, faults=fault)
    base.update(kw)
    return SimConfig(**base).validate()


def _plain():
    return TorchBackend(device="cpu", kernel="plain")


def _equal(a, b):
    np.testing.assert_array_equal(a.rounds, b.rounds)
    np.testing.assert_array_equal(a.decision, b.decision)


# ---------------------------------------------------------------------------
# the fingerprint and the capture seams


def test_kernel_fingerprint_is_the_build_digest_and_symbol():
    sym = "_Z18fused_round_kernelILi1ELi0ELi0EEvv"
    a = programs.kernel_fingerprint("fused_round", sym)
    assert a == programs.kernel_fingerprint("fused_round", sym)
    assert a["symbol"] == sym and a["library"] == "fused_round"
    assert a["build_digest"] == _build.library_path("fused_round").stem.rsplit("-", 1)[-1]
    assert programs.kernel_fingerprint("fused_round", sym + "x")["hash"] != a["hash"]
    assert programs.kernel_fingerprint("keys_step", sym)["hash"] != a["hash"]


def test_disabled_census_is_inert():
    assert not programs.enabled()
    fn = _plain().run
    assert programs.instrument("k", fn) is fn
    assert record.programs_block() is None


def test_lane_runs_add_no_entry_and_stay_bit_identical():
    """The reference captures each bucket program it compiles; the port's
    lanes are plain torch ops and launch no kernel, so the census stays
    empty across a census-on lane run, which equals a census-off one."""
    a = _cfg("none", "benor", "urn2", "none", f=2, seed=1, instances=3)
    b = _cfg("none", "benor", "urn2", "none", f=1, seed=2, instances=3)
    ref = _plain().run_batch([a])
    census = programs.configure()
    got = _plain().run_batch([a])
    _plain().run_batch([b])
    assert census.entries == {} and record.programs_block() is None
    _equal(got[0], ref[0])


def test_census_covers_per_config_seam(ptxas_log):
    census = programs.configure()
    cfg = _cfg("crash", "benor", "urn2", "none", instances=3)
    key = programs.config_label(cfg)
    res = programs.capture_call(key, _plain().run, (cfg,), {})[0]
    assert key in census.entries and key.startswith("config/benor/n7/")
    # A launch inside the call lands in its entry (the card's wrappers call
    # note_launch; here the hook is driven directly).
    programs.capture_call(key, fused_round._census_launch, (
        _cfg("none", "bracha", "urn2", "none"), "fused_round", 4), {})
    entry = census.entries[key]
    assert entry["calls"] == 2
    assert entry["kernels"] == {"kernel/fused_round/bracha,none,none": 1}
    programs.disable()
    _equal(res, _plain().run(cfg))


def test_census_survives_shape_drift_on_per_config_path():
    programs.configure()
    cfg = _cfg("none", "benor", "urn2", "none", instances=8)
    key = programs.config_label(cfg)
    be = _plain()
    full = programs.capture_call(key, be.run, (cfg,), {})[0]
    sub = programs.capture_call(key, be.run, (cfg, np.arange(2)), {})[0]
    assert programs.current().entries[key]["calls"] == 2
    programs.disable()
    ref = _plain().run(cfg)
    _equal(full, ref)
    np.testing.assert_array_equal(sub.rounds, ref.rounds[:2])
    np.testing.assert_array_equal(sub.decision, ref.decision[:2])


def test_census_inert_across_fault_adversary_delivery_grid():
    adv_proto = (("none", "benor"), ("crash", "benor"), ("byzantine", "bracha"),
                 ("adaptive", "bracha"))
    cells = [(FAULT_KINDS[i], DELIVERY_KINDS[j]) for i, j in ((0, 0), (1, 1), (2, 3), (3, 2))]
    cfgs = []
    for i, (fault, delivery) in enumerate(cells):
        adv, proto = adv_proto[i % len(adv_proto)]
        cfgs += [_cfg(adv, proto, delivery, fault),
                 _cfg(adv, proto, delivery, fault, f=1, seed=99, instances=6)]
    off = _plain()
    base, _ = off.run_many(cfgs)
    base_c, _ = off.run_many(cfgs, compaction=CompactionPolicy(width=4, segment=1))
    census = programs.configure()
    on = _plain()
    got, _ = on.run_many(cfgs)
    got_c, _ = on.run_many(cfgs, compaction=CompactionPolicy(width=4, segment=1))
    for a, b in zip(base + base_c, got + got_c):
        _equal(a, b)
    assert census.capture_errors == 0 and census.entries == {}


# ---------------------------------------------------------------------------
# the record block


def test_programs_block_and_validate_record(ptxas_log):
    programs.configure()
    fused_round._census_launch(_cfg("none", "bracha", "urn2", "none"), "fused_round", 8)
    programs.capture_call("config/x", lambda: None, (), {})
    blk = record.programs_block()
    assert blk["count"] == 2 and blk["totals"]["kernel_launches"] == 1
    assert blk["totals"]["with_ptxas"] == 1
    doc = {**record.new_record("programs_census"), "programs": blk}
    assert record.validate_record(doc) == [] == ref_record.validate_record(doc)
    assert any("programs block missing" in p for p in record.validate_record(
        {**record.new_record("x"), "programs": {"count": 1}}))
    assert any("'key'/'fingerprint'" in p for p in record.validate_record(
        {**record.new_record("x"), "programs": {"count": 1, "programs": [{"cost": {}}]}}))


def test_programs_block_from_backend_and_empty_sources(ptxas_log):
    assert record.programs_block() is None
    census = programs.configure()
    assert record.programs_block() is None
    fused_round._census_launch(_cfg("none", "bracha", "urn2", "none"), "fused_round", 8)
    assert record.programs_block()["count"] == 1
    assert record.programs_block(dict(census.entries))["count"] == 1
    assert record.programs_block({}) is None


# ---------------------------------------------------------------------------
# the verbs


def _sample_record(tmp_path, name="census.json", symbol="_Z18fused_round_kernelv",
                   trace_file=None, calls=3):
    kernel_key = "kernel/fused_round/bracha,none,none"
    blk = {"count": 2, "programs": [
        {"key": kernel_key, "library": "fused_round", "kernel": "fused_round_kernel",
         "template_args": [1, 0, 0], "label": "bracha,none,none",
         "fingerprint": programs.kernel_fingerprint("fused_round", symbol),
         "ptxas": {"registers": 29, "barriers": 1, "smem_bytes": 4, "cmem0_bytes": 448,
                   "stack_bytes": 0, "spill_stores": 0, "spill_loads": 0},
         "calls": calls, "launch": {"grid": [100], "block": [512], "dynamic_smem_bytes": 0},
         "shapes": {"100/512/0": calls}},
        {"key": "config/a", "calls": 1, "wall_s": 0.5, "kernels": {kernel_key: calls},
         "fingerprint": {"hash": "cafe", "kernels": 1}}],
        "totals": {"kernel_instantiations": 1, "kernel_launches": calls}}
    doc = {**record.new_record("programs_census"), "programs": blk}
    if trace_file:
        doc["trace"] = {"file": trace_file, "events": 2, "digest": {}}
    p = tmp_path / name
    p.write_text(json.dumps(doc))
    return p


def test_programs_dump_and_diff(tmp_path, capsys):
    a = _sample_record(tmp_path, "a.json")
    b = _sample_record(tmp_path, "b.json", symbol="_Z18fused_round_kernelvv")
    assert programs_tool.main(["dump", str(a)]) == 0
    out = capsys.readouterr().out
    assert "kernel/fused_round/bracha,none,none" in out and "registers 29" in out
    assert "config/a" in out and "3 launch(es) of 1 instantiation(s)" in out
    assert programs_tool.main(["dump", str(a), "--ops", "2"]) == 2
    assert "HLO op counts" in capsys.readouterr().err
    ha = programs.kernel_fingerprint("fused_round", "_Z18fused_round_kernelv")["hash"]
    hb = programs.kernel_fingerprint("fused_round", "_Z18fused_round_kernelvv")["hash"]
    assert programs_tool.main(["diff", str(a), str(b)]) == 1
    assert f"{ha} -> {hb}" in capsys.readouterr().out
    assert programs_tool.main(["diff", str(a), str(a)]) == 0
    capsys.readouterr()
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps(record.new_record("bench")))
    assert programs_tool.main(["dump", str(empty)]) == 1
    capsys.readouterr()


def test_programs_roofline_joins_trace_spans(tmp_path, capsys):
    art = _sample_record(tmp_path, "c.json", trace_file="c.jsonl")
    events = [
        {"ph": "X", "kind": "backend.run", "ts": 1.0, "dur": 2.0, "pid": 1, "tid": 0,
         "attrs": {"program": "config/a", "dispatches": 4}},
        {"ph": "X", "kind": "compaction.segment", "ts": 4.0, "dur": 1.0, "pid": 1, "tid": 0,
         "attrs": {"program": "prog/other"}},
        {"ph": "X", "kind": "batch.bucket", "ts": 0.0, "dur": 9.0, "pid": 1, "tid": 0,
         "attrs": {"program": "config/a"}},
    ]
    (tmp_path / "c.jsonl").write_text("\n".join(json.dumps(e) for e in events) + "\n")
    assert programs_tool.main(["roofline", "--census", str(art), "--json"]) == 0
    rows = {r["key"]: r for r in json.loads(capsys.readouterr().out)["rows"]}
    row = rows["config/a"]
    assert row["dispatches"] == 4 and row["wall_s"] == 2.0 and row["in_census"]
    assert (row["launches"], row["registers"], row["smem_bytes"]) == (3, 29, 4)
    assert row["flops_per_dispatch"] is None and row["bytes_per_dispatch"] is None
    assert rows["prog/other"]["in_census"] is False
    assert programs_tool.main(["roofline", "--census", str(art), "--vs", str(art)]) == 0
    assert '"matched": 1' in capsys.readouterr().out


def test_programs_census_smoke(tmp_path, capsys):
    """The A/B at a small size on the CPU: the record validates in both
    packages, the lanes are bit-identical, the census holds the per-config
    calls and the trace their spans, which roofline joins. Whether a
    handful of CPU walls meets the bound is not asserted."""
    out = tmp_path / "programs_smoke.json"
    rc = programs_tool.main(["census", "--configs", "4", "--repeats", "1",
                             "--compacted-sample", "2", "--per-config-sample", "2",
                             "--device", "cpu", "--out", str(out)])
    capsys.readouterr()
    assert rc in (0, 1)
    doc = json.loads(out.read_text())
    assert record.validate_record(doc) == [] == ref_record.validate_record(doc)
    assert doc["kind"] == "programs_census" and doc["bit_identical"] is True
    assert doc["programs"]["count"] >= 2 and doc["capture_errors"] == 0
    assert doc["per_config_kernels"] == ["plain", "plain"]
    legs = doc["legs"]
    assert doc["overhead_fraction"] == round(
        legs["census_on"]["wall_s"] / legs["census_off"]["wall_s"] - 1.0, 4)
    assert doc["wall_spread"] == 0.0 and doc["resolved"] is True  # one repeat
    assert doc["trace"]["events"] > 0 and "backend.run" in doc["trace"]["digest"]
    assert (tmp_path / "programs_smoke.jsonl").exists()
    assert programs_tool.main(["roofline", "--census", str(out), "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)["rows"]
    assert rows and any(r["in_census"] for r in rows)


def test_cli_routes_programs_verb(tmp_path, capsys):
    assert cli.main(["programs", "dump", str(_sample_record(tmp_path))]) == 0
    assert "kernel census" in capsys.readouterr().out


def test_fused_is_refused_by_name(capsys):
    assert cli.main(["programs", "fused"]) == 2
    assert "XLA" in capsys.readouterr().err


def test_census_names_a_missing_card(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert programs_tool.main(["census", "--configs", "2", "--out",
                               str(tmp_path / "c.json")]) == 2
    assert "no CUDA device" in capsys.readouterr().err
