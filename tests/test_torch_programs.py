"""The port's program census (obs/programs.py): a census of its CUDA kernels.

The counterparts of the reference's ``tests/test_programs.py`` where they
carry over: the census is inert when off, the keyed capture seam
(``capture_call``, ``instrument``) counts calls, and the schema-v1.4
``programs`` block passes both packages' ``validate_record``. The HLO
fingerprint cases have no counterpart (the port builds no XLA program); in
their place the ``ptxas -v`` parse of a fixture report written here (no
build log is committed: ``build/`` is not in the repo), the mangled-name
reading, and each kernel wrapper's launch hook matched to its
instantiation, with the launch shape its C entry picks.
"""

import dataclasses
import threading

import pytest

from byzantinerandomizedconsensus_tpu import config as ref_config
from byzantinerandomizedconsensus_tpu.obs import programs as ref_programs
from byzantinerandomizedconsensus_tpu.obs import record as ref_record
from byzantinerandomizedconsensus_tpu_torch.backends import get_backend
from byzantinerandomizedconsensus_tpu_torch.backends.compaction import CompactionPolicy
from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import TorchBackend
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.obs import programs, record
from byzantinerandomizedconsensus_tpu_torch.ops import _build, _step, fused_round
from byzantinerandomizedconsensus_tpu_torch.serve.server import ConsensusServer

TIMEOUT = 600.0

#: A ``ptxas -v`` report in nvcc's format: the config-4 instantiation of
#: the fused round (protocol 1, adversary 0, schedule 0) under the name
#: nvcc gives a kernel in an anonymous namespace (as the card's build
#: logs have it), another in the plain form, a wide one, a keys_step
#: instantiation with a stack frame, a device function's properties
#: between entries, and urn_step.
FIXTURE = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__f6b25c1c_14_fused_round_cu_163dae0e18fused_round_kernelILi1ELi0ELi0EEEvPKiPKhS2_NS_11FaultPlanesEPiPhN3brc6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__f6b25c1c_14_fused_round_cu_163dae0e18fused_round_kernelILi1ELi0ELi0EEEvPKiPKhS2_NS_11FaultPlanesEPiPhN3brc6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 29 registers, used 1 barriers, 4 bytes smem, 448 bytes cmem[0]
ptxas info    : Compile time = 292.679 ms
ptxas info    : Compiling entry function '_Z18fused_round_kernelILi0ELi2ELi3EEvPKiPKhS1_S3_S1_S1_S3_S1_S1_PiPhN3brc6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _Z18fused_round_kernelILi0ELi2ELi3EEvPKiPKhS1_S3_S1_S1_S3_S1_S1_PiPhN3brc6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 33 registers, used 1 barriers, 4 bytes smem, 448 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123fused_round_wide_kernelILi1ELi0ELi0ELi1ELi4EEEvPKiNS_6PlanesEPjPiPhN5fused6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123fused_round_wide_kernelILi1ELi0ELi0ELi1ELi4EEEvPKiNS_6PlanesEPjPiPhN5fused6ParamsE
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 1024 bytes smem, 480 bytes cmem[0]
ptxas info    : Function properties for _ZN3brc9prf_wordsEjjjjj
    24 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116keys_step_kernelILi1ELb0EEEvPKiPKhS4_S4_PiS5_N3brc10StepParamsEiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116keys_step_kernelILi1ELb0EEEvPKiPKhS4_S4_PiS5_N3brc10StepParamsEiii
    24 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 24 bytes cumulative stack size, 64 bytes smem, 416 bytes cmem[0]
ptxas info    : Compiling entry function '_Z15urn_step_kernelPKiPKhS2_S2_PiS3_N3brc10StepParamsEii' for 'sm_90a'
ptxas info    : Function properties for _Z15urn_step_kernelPKiPKhS2_S2_PiS3_N3brc10StepParamsEii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 29 registers, used 1 barriers, 416 bytes cmem[0]
"""
FUSED4 = ("_ZN47_GLOBAL__N__f6b25c1c_14_fused_round_cu_163dae0e18fused_round_kernelILi1ELi0"
          "ELi0EEEvPKiPKhS2_NS_11FaultPlanesEPiPhN3brc6ParamsE")
WIDE = ("_ZN12_GLOBAL__N_123fused_round_wide_kernelILi1ELi0ELi0ELi1ELi4EEEvPKiNS_6Planes"
        "EPjPiPhN5fused6ParamsE")
KEYS = ("_ZN12_GLOBAL__N_116keys_step_kernelILi1ELb0EEEvPKiPKhS4_S4_PiS5_N3brc10Step"
        "ParamsEiii")
URN = "_Z15urn_step_kernelPKiPKhS2_S2_PiS3_N3brc10StepParamsEii"


@pytest.fixture(autouse=True)
def _no_leftover_census():
    """Every test starts and ends with the census disabled."""
    programs.disable()
    yield
    programs.disable()


@pytest.fixture
def fixture_logs(monkeypatch):
    """Every library's build log reads as :data:`FIXTURE`."""
    monkeypatch.setattr(_build, "build_log", lambda name: FIXTURE)


def _cfg(**kw):
    base = dict(protocol="bracha", n=7, f=2, instances=4, adversary="none",
                coin="local", seed=13, round_cap=32, delivery="urn2")
    base.update(kw)
    return SimConfig(**base).validate()


# -- the ptxas report and the symbols ----------------------------------------

def test_ptxas_parse_of_a_fixture_report_gives_what_it_states():
    got = programs.parse_ptxas(FIXTURE)
    other = "_Z18fused_round_kernelILi0ELi2ELi3EEvPKiPKhS1_S3_S1_S1_S3_S1_S1_PiPhN3brc6ParamsE"
    assert set(got) == {FUSED4, other, WIDE, KEYS, URN}
    assert got[other]["registers"] == 33
    assert got[FUSED4] == {"registers": 29, "barriers": 1, "smem_bytes": 4,
                           "cmem0_bytes": 448, "stack_bytes": 0,
                           "spill_stores": 0, "spill_loads": 0}
    assert got[WIDE]["registers"] == 64 and got[WIDE]["smem_bytes"] == 1024
    assert (got[WIDE]["spill_stores"], got[WIDE]["spill_loads"]) == (4, 4)
    assert got[WIDE]["stack_bytes"] == 8  # not the device function's 24
    assert got[KEYS]["registers"] == 32 and got[KEYS]["smem_bytes"] == 64
    assert got[KEYS]["stack_bytes"] == 24
    assert got[URN]["registers"] == 29 and got[URN]["smem_bytes"] == 0


@pytest.mark.parametrize("symbol, want", [
    (FUSED4, ("fused_round_kernel", (1, 0, 0))),
    (WIDE, ("fused_round_wide_kernel", (1, 0, 0, 1, 4))),
    (KEYS, ("keys_step_kernel", (1, 0))),
    (URN, ("urn_step_kernel", ())),
    ("_ZN3brc9prf_wordsEjjjjj", None),
])
def test_kernel_of_reads_the_mangled_names(symbol, want):
    assert programs.kernel_of(symbol) == want


# -- the launch hooks ----------------------------------------------------------

def test_fused_launch_hook_matches_its_instantiation_and_shape(fixture_logs):
    census = programs.configure()
    cfg = _cfg()
    fused_round._census_launch(cfg, "fused_round", 4096)
    fused_round._census_launch(cfg, "fused_round", 100)
    other = _cfg(protocol="benor", n=11, f=2, adversary="byzantine", faults="omission")
    fused_round._census_launch(other, "fused_round", 8)
    blk = census.block()
    by_key = {e["key"]: e for e in blk["programs"]}
    e = by_key["kernel/fused_round/bracha,none,none"]
    assert e["calls"] == 2 and e["fingerprint"]["symbol"] == FUSED4
    assert e["ptxas"]["registers"] == 29 and e["ptxas"]["smem_bytes"] == 4
    assert e["launch"] == {"grid": [100], "block": [32], "dynamic_smem_bytes": 0}
    assert e["shapes"] == {"4096/32/0": 1, "100/32/0": 1}
    o = by_key["kernel/fused_round/benor,byzantine,omission"]
    assert o["ptxas"]["registers"] == 33 and o["template_args"] == [0, 2, 3]
    assert blk["totals"] == {"kernel_instantiations": 2, "kernel_launches": 3,
                             "with_ptxas": 2, "wall_s": 0.0}


def test_wide_and_step_launch_hooks_take_their_c_entries_shapes(fixture_logs):
    census = programs.configure()
    wide = _cfg(n=2048, f=600, delivery="urn3")  # layout 4 (n <= 4096)
    assert fused_round.layout(wide) == 4
    fused_round._census_launch(wide, "fused_round_urn3_r4", 16)
    keys = _cfg(protocol="benor", n=512, f=100, delivery="keys")
    _step._census_launch("keys_step", keys, 3, 512)
    _step._census_launch("keys_step", keys, 3, 128)  # a receiver shard
    urn = _cfg(n=100, f=30, delivery="urn")
    _step._census_launch("urn_step", urn, 5, 100)
    by_key = {e["key"]: e for e in census.block()["programs"]}
    w = by_key["kernel/fused_round_urn3_r4/bracha,none,none"]
    assert w["ptxas"]["registers"] == 64 and w["fingerprint"]["symbol"] == WIDE
    assert w["launch"]["block"] == [512]  # 2048 / 4 replicas a thread
    k = by_key["kernel/keys_step/benor,none,v1"]
    smem = 8 * (256 * 4 + (32 + 512) * 4) + 8 * 512 + 2 * 512
    assert k["shapes"] == {f"24/256/{smem}": 1, f"6/256/{smem}": 1}
    assert k["ptxas"]["registers"] == 32 and k["fingerprint"]["symbol"] == KEYS
    u = by_key["kernel/urn_step/bracha,none,v1"]
    assert u["launch"] == {"grid": [5], "block": [128], "dynamic_smem_bytes": 0}
    assert u["ptxas"]["registers"] == 29


def test_an_instantiation_missing_from_the_log_is_kept_without_ptxas(fixture_logs):
    census = programs.configure()
    fused_round._census_launch(_cfg(adversary="crash"), "fused_round", 2)
    (e,) = census.block()["programs"]
    assert e["ptxas"] is None and e["fingerprint"]["symbol"] is None
    assert e["fingerprint"]["build_digest"] == _build.library_path(
        "fused_round").stem.rsplit("-", 1)[-1]
    assert census.block()["totals"]["with_ptxas"] == 0


# -- the capture seam ------------------------------------------------------------

def test_disabled_census_is_inert():
    assert not programs.enabled()
    fn = TorchBackend(device="cpu").run
    assert programs.instrument("k", fn) is fn
    out, same, entry = programs.capture_call("k", lambda x: x + 1, (1,), {})
    assert (out, entry) == (2, None) and same is not None
    programs.note_launch("fused_round", "fused_round_kernel", "x", (1, 0, 0), (1,), (32,))
    assert record.programs_block() is None and programs.current() is None


def test_capture_call_and_instrument_count_calls_and_launches(fixture_logs):
    census = programs.configure()
    cfg = _cfg()

    def launching(k):
        for _ in range(k):
            fused_round._census_launch(cfg, "fused_round", 8)
        return k

    wrapped = programs.instrument("config/a", launching)
    assert wrapped is not launching and wrapped.census_key == "config/a"
    assert [wrapped(2), wrapped(1)] == [2, 1]
    out, fn, entry = programs.capture_call("config/b", launching, (0,), {})
    assert (out, fn) == (0, launching)
    a = census.entries["config/a"]
    assert a["calls"] == 2 and a["kernels"] == {"kernel/fused_round/bracha,none,none": 3}
    assert a["fingerprint"]["kernels"] == 1
    assert entry["calls"] == 1 and entry["kernels"] == {} and entry["fingerprint"] is None
    assert census.entries["kernel/fused_round/bracha,none,none"]["calls"] == 3
    with pytest.raises(ZeroDivisionError):
        programs.capture_call("config/c", lambda: 1 / 0, (), {})


def test_captures_on_two_threads_count_their_own_launches(fixture_logs):
    census = programs.configure()
    go = threading.Barrier(2)

    def serve(key, cfg, k):
        def body():
            go.wait(timeout=60)
            for _ in range(k):
                fused_round._census_launch(cfg, "fused_round", 4)
        programs.capture_call(key, body, (), {})

    a, b = _cfg(), _cfg(protocol="benor", n=11, f=2, adversary="byzantine",
                        faults="omission")
    ts = [threading.Thread(target=serve, args=("config/a", a, 5)),
          threading.Thread(target=serve, args=("config/b", b, 3))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert census.entries["config/a"]["kernels"] == {"kernel/fused_round/bracha,none,none": 5}
    assert census.entries["config/b"]["kernels"] == {
        "kernel/fused_round/benor,byzantine,omission": 3}


def test_served_direct_leg_counts_each_config_it_ran():
    """The serving path keys every ``backend.run`` of the direct leg by
    ``config_label`` (here the object oracle, which runs the direct leg on
    the CPU and launches no kernel)."""
    census = programs.configure()
    cfgs = [SimConfig(protocol="benor", n=5, f=1, instances=3, seed=s, round_cap=24)
            for s in (1, 2)]
    with ConsensusServer(get_backend("cpu"),
                         policy=CompactionPolicy(width=8, segment=1)) as srv:
        assert srv.leg == "direct"
        for c in cfgs + cfgs[:1]:
            srv.submit(c).wait(timeout=TIMEOUT)
    calls = {k: e["calls"] for k, e in census.entries.items()}
    assert calls == {programs.config_label(cfgs[0]): 2, programs.config_label(cfgs[1]): 1}
    ref = ref_config.SimConfig(**dataclasses.asdict(cfgs[0]))
    assert programs.config_label(cfgs[0]) == ref_programs.config_label(ref)


def test_census_enables_from_the_environment(monkeypatch):
    monkeypatch.setenv(programs.PROGRAMS_ENV, "0")
    assert programs.maybe_enable_from_env() is None and not programs.enabled()
    monkeypatch.setenv(programs.PROGRAMS_ENV, "1")
    census = programs.maybe_enable_from_env()
    assert census is programs.current() is programs.configure()


# -- schema v1.4 -------------------------------------------------------------------

def test_programs_block_and_validate_record_in_both_packages(fixture_logs):
    census = programs.configure()
    fused_round._census_launch(_cfg(), "fused_round", 8)
    programs.capture_call("config/x", lambda: None, (), {})
    blk = record.programs_block()
    assert blk["count"] == 2 and blk["totals"]["kernel_launches"] == 1
    doc = {**record.new_record("programs_census"), "programs": blk}
    assert record.validate_record(doc) == [] == ref_record.validate_record(doc)
    for bad in ({"count": 1}, {"count": 1, "programs": [{"cost": {}}]}):
        torn = {**record.new_record("x"), "programs": bad}
        assert record.validate_record(torn) == ref_record.validate_record(torn) != []
    assert record.programs_block(census) == blk
    assert record.programs_block(dict(census.entries))["count"] == 2
    assert record.programs_block({}) is None


def test_programs_block_survives_a_json_round_trip(fixture_logs):
    import json

    census = programs.configure()
    fused_round._census_launch(_cfg(), "fused_round", 8)
    blk = census.block()
    assert json.loads(json.dumps(blk)) == blk
