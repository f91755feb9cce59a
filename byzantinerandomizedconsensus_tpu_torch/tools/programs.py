"""``cli programs``: the consumers of the kernel census (``obs/programs.py``).

The port's copy of the reference ``tools/programs.py``. The reference
censuses XLA programs (HLO fingerprints, cost and memory analyses); the
port's census holds the instantiations of its hand-written CUDA kernels
(ptxas registers, shared memory and spills, launch shapes, a fingerprint
from the library's build digest and the symbol) and the keyed calls that
launched them. The verbs:

- ``dump SRC [--json]``: the ``programs`` block(s) of a record as a table;
- ``diff A B``: two records' censuses by key: entries added and removed,
  fingerprint drift (exit 1 on drift, :func:`obs.programs.kernel_fingerprint`);
- ``roofline --census ART [--trace JSONL] [--vs ART]``: per dispatched
  program, the wall of the trace spans in :data:`_DISPATCH_KINDS` whose
  ``program`` attribute names it, joined to the census: dispatches, wall,
  kernel launches, registers and shared memory. The census holds no static
  cost of a kernel (its work depends on the run's data; ``chip_smoke.py``
  counts it per run), so flops, bytes and rates stay null, as in the
  reference's rows of entries without a cost;
- ``census``: the seeded chaos grid (``tools/bench_batch.py::chaos_grid``)
  through the fused lanes (the plain round driver), census on against
  census off after a warm-up, the legs paired bucket by bucket and judged
  by their walls as ``tools/trace.py overhead``'s are (with the same
  ``resolved`` flag), results
  bit-compared, plus an untimed
  compacted sample and a per-config sample through ``backend.run`` (on the
  card K1, K2 or K3 by law), so the census holds kernel instantiations;
  writes a run record (kind ``programs_census``, with its ``programs``,
  ``trace`` and ``compile_cache`` blocks) and exits 0 iff bit-same,
  within :data:`OVERHEAD_BOUND` and the census is not empty. On the card
  unless ``--device cpu``; a missing card exits 2 by name;
- ``fused``: the reference's XLA-against-Pallas A/B. The port has no XLA
  program to compare, so it is refused by name with exit code 2 (K1 is held
  against the plain round driver by ``chip_smoke.py``).

The reference's HLO verbs and fields (``normalize_hlo``, HLO fingerprints,
``dump --ops``' HLO op counts, XLA's cost and memory analyses) have no
counterpart here.

    python -m byzantinerandomizedconsensus_tpu_torch.cli programs census --configs 40
    python -m byzantinerandomizedconsensus_tpu_torch.cli programs roofline \
        --census artifacts/port/programs_r6.json
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import sys

from byzantinerandomizedconsensus_tpu_torch.obs import programs as _programs
from byzantinerandomizedconsensus_tpu_torch.obs import trace as _trace

#: The bound on census overhead over the seeded chaos grid: census-on wall /
#: census-off wall - 1 must stay within this.
OVERHEAD_BOUND = 0.02
#: Span kinds whose ``program`` attribute names a census key (the roofline
#: join): the lanes' dispatches and the compacted grid's programs carry
#: their lane program's key, ``backend.run`` the run's ``config_label``.
_DISPATCH_KINDS = ("batch.dispatch", "backend.run", "compaction.init",
                   "compaction.segment", "compaction.drain",
                   "compaction.refill")
#: The port's own records, apart from the reference's ``artifacts/*_r*.json``.
RECORD_DIR = "artifacts/port"


def _programs_of(path) -> dict:
    """{key: entry} over every programs block of one record."""
    from byzantinerandomizedconsensus_tpu_torch.obs import record

    doc = json.loads(pathlib.Path(path).read_text())
    out: dict = {}
    for _path, blk in record.find_blocks(doc, "programs", record.PROGRAMS_BLOCK_KEYS):
        for entry in blk.get("programs") or []:
            if isinstance(entry, dict) and entry.get("key"):
                out[entry["key"]] = entry
    return out


def _hash(entry: dict):
    return (entry.get("fingerprint") or {}).get("hash")


def _entry_row(entry: dict) -> str:
    if entry.get("kernel"):
        px = entry.get("ptxas") or {}
        launch = entry.get("launch") or {}
        return (f"  {entry['key']}\n"
                f"    hash {_hash(entry) or '?'}  {entry['kernel']}"
                f"{tuple(entry.get('template_args') or ())} in {entry.get('library')}, "
                f"{entry.get('calls', 0)} launch(es), registers "
                f"{px.get('registers', '?')}, smem {px.get('smem_bytes', '?')} B "
                f"+ {launch.get('dynamic_smem_bytes', '?')} B dynamic, spill stores "
                f"{px.get('spill_stores', '?')} B, last grid {launch.get('grid')} x "
                f"block {launch.get('block')}")
    kernels = entry.get("kernels") or {}
    return (f"  {entry['key']}\n"
            f"    hash {_hash(entry) or '-'}  {entry.get('calls', 0)} call(s), "
            f"{entry.get('wall_s', 0.0)} s wall, {sum(kernels.values())} launch(es) of "
            f"{len(kernels)} instantiation(s)")


def cmd_dump(args) -> int:
    if args.ops:
        print("dump --ops lists HLO op counts, which have no counterpart here: the "
              "census holds CUDA kernel instantiations", file=sys.stderr)
        return 2
    try:
        entries = _programs_of(args.src)
    except (OSError, ValueError) as e:
        print(f"cannot read {args.src!r}: {e}", file=sys.stderr)
        return 2
    if not entries:
        print(f"{args.src}: no programs block (a census-off run)", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps({"programs": list(entries.values())}, indent=1))
        return 0
    print(f"kernel census — {len(entries)} entr{'y' if len(entries) == 1 else 'ies'} "
          f"({args.src})")
    for entry in entries.values():
        print(_entry_row(entry))
    return 0


def cmd_diff(args) -> int:
    try:
        a, b = _programs_of(args.a), _programs_of(args.b)
    except (OSError, ValueError) as e:
        print(f"cannot read census: {e}", file=sys.stderr)
        return 2
    added = sorted(set(b) - set(a))
    removed = sorted(set(a) - set(b))
    drifted = [(key, _hash(a[key]), _hash(b[key])) for key in sorted(set(a) & set(b))
               if _hash(a[key]) != _hash(b[key])]
    print(f"census diff {args.a} -> {args.b}: {len(added)} added, {len(removed)} removed, "
          f"{len(drifted)} fingerprint drift(s)")
    for key in added:
        print(f"  + {key}")
    for key in removed:
        print(f"  - {key}")
    for key, fa, fb in drifted:
        ra = (a[key].get("ptxas") or {}).get("registers", "?")
        rb = (b[key].get("ptxas") or {}).get("registers", "?")
        print(f"  ~ {key}: hash {fa} -> {fb}, registers {ra} -> {rb}")
    return 1 if drifted else 0


# ---------------------------------------------------------------------------
# roofline: per-dispatch wall (trace spans) joined to the census


def _launch_fields(entry, entries: dict) -> dict:
    """Launches, registers and shared memory of a census entry: a kernel
    instantiation's own, or the most of those a keyed call launched."""
    if entry is None:
        return {"launches": None, "registers": None, "smem_bytes": None,
                "dynamic_smem_bytes": None}
    kernels = ({entry["key"]: entry.get("calls", 0)} if entry.get("kernel")
               else entry.get("kernels") or {})
    insts = [entries[k] for k in kernels if k in entries]

    def most(get):
        vals = [v for v in (get(e) for e in insts) if v is not None]
        return max(vals) if vals else None

    return {"launches": sum(kernels.values()),
            "registers": most(lambda e: (e.get("ptxas") or {}).get("registers")),
            "smem_bytes": most(lambda e: (e.get("ptxas") or {}).get("smem_bytes")),
            "dynamic_smem_bytes": most(
                lambda e: (e.get("launch") or {}).get("dynamic_smem_bytes"))}


def roofline_rows(entries: dict, events) -> list:
    """One row per program the trace dispatched: dispatches, wall, whether
    the census holds it, its kernel launches, registers and shared memory;
    flops and bytes per dispatch are null (the census holds no static cost).
    A ``batch.dispatch`` span covers its ``dispatches`` executions; every
    other dispatch kind is one."""
    walls: dict = {}
    counts: dict = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("kind") not in _DISPATCH_KINDS:
            continue
        key = (ev.get("attrs") or {}).get("program")
        if not key:
            continue
        walls[key] = walls.get(key, 0.0) + float(ev.get("dur", 0.0))
        # dispatches=0 is a real count (an empty run); only a missing
        # attribute counts one execution per span.
        n = (ev.get("attrs") or {}).get("dispatches")
        counts[key] = counts.get(key, 0) + (1 if n is None else int(n))
    rows = []
    for key, wall in sorted(walls.items(), key=lambda kv: -kv[1]):
        entry = entries.get(key)
        rows.append({"key": key, "dispatches": counts.get(key, 0),
                     "wall_s": round(wall, 6), "in_census": entry is not None,
                     **_launch_fields(entry, entries),
                     "flops_per_dispatch": None, "bytes_per_dispatch": None})
    return rows


def _canon_label(key: str) -> str:
    """A census key without its per-run segments (fault budget, crash
    window, instances, seed: ``f<n>``, ``w<n>``, ``i<n>``, ``s<n>``), for
    the ``--vs`` join across runs."""
    return "/".join(p for p in key.split("/") if not re.fullmatch(r"[fwis]\d+", p))


def baseline_delta_rows(rows: list, base_entries: dict) -> list:
    """Join roofline rows against a baseline census by key (exact, then
    :func:`_canon_label`): each matched row gains the baseline's key and its
    launches and registers beside its own."""
    base_canon: dict = {}
    for k in sorted(base_entries):
        base_canon.setdefault(_canon_label(k), k)
    out = []
    for row in rows:
        bk = row["key"] if row["key"] in base_entries else \
            base_canon.get(_canon_label(row["key"]))
        row = dict(row, baseline_key=bk)
        if bk is not None:
            base = _launch_fields(base_entries[bk], base_entries)
            row["baseline_launches"] = base["launches"]
            row["baseline_registers"] = base["registers"]
        out.append(row)
    return out


def cmd_roofline(args) -> int:
    from byzantinerandomizedconsensus_tpu_torch.obs import record

    try:
        entries = _programs_of(args.census)
        doc = json.loads(pathlib.Path(args.census).read_text())
    except (OSError, ValueError) as e:
        print(f"cannot read census {args.census!r}: {e}", file=sys.stderr)
        return 2
    trace_path = args.trace
    if trace_path is None:
        # The record's own trace block names the file, next to the record.
        tr = record.parsed_payload(doc).get("trace") or {}
        if tr.get("file"):
            trace_path = pathlib.Path(args.census).parent / tr["file"]
    if trace_path is None:
        print("no --trace given and the census record binds no trace block",
              file=sys.stderr)
        return 2
    try:
        events = _trace.read_events(trace_path)
    except (OSError, ValueError) as e:
        print(f"cannot read trace {trace_path!r}: {e}", file=sys.stderr)
        return 2
    rows = roofline_rows(entries, events)
    vs = None
    if args.vs:
        try:
            base_entries = _programs_of(args.vs)
        except (OSError, ValueError) as e:
            print(f"cannot read baseline census {args.vs!r}: {e}", file=sys.stderr)
            return 2
        rows = baseline_delta_rows(rows, base_entries)
        vs = {"baseline": str(args.vs), "rows": len(rows),
              "matched": sum(1 for r in rows if r.get("baseline_key"))}
    if args.json:
        print(json.dumps({"rows": rows, **({"vs": vs} if vs is not None else {})},
                         indent=1))
        return 0
    print(f"roofline join — {len(rows)} dispatched program(s), {len(entries)} in census "
          f"({args.census} x {trace_path})")
    for row in rows:
        launched = ("" if row["launches"] is None else
                    f", {row['launches']} kernel launch(es), registers {row['registers']}, "
                    f"smem {row['smem_bytes']} B + {row['dynamic_smem_bytes']} B dynamic")
        print(f"  {row['key']}\n    {row['dispatches']} dispatch(es), {row['wall_s']} s wall"
              f"{launched}" + ("" if row["in_census"] else "  [NOT IN CENSUS]"))
        if row.get("baseline_key"):
            print(f"    vs {row['baseline_key']}: {row['baseline_launches']} launch(es), "
                  f"registers {row['baseline_registers']}")
    if vs is not None:
        print(json.dumps(vs, indent=1))
    return 0


# ---------------------------------------------------------------------------
# census: the census-on-vs-off A/B and the census record


def cmd_census(args) -> int:
    from byzantinerandomizedconsensus_tpu_torch.backends.compaction import CompactionPolicy
    from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import TorchBackend
    from byzantinerandomizedconsensus_tpu_torch.obs import record
    from byzantinerandomizedconsensus_tpu_torch.tools import bench_batch, sampler
    from byzantinerandomizedconsensus_tpu_torch.tools.trace import (
        interleaved_ab, overhead_of, print_ab, results_equal)

    if args.repeats < 1:
        print("census needs --repeats >= 1 (the A/B has no walls without timed runs)",
              file=sys.stderr)
        return 2
    try:
        # One lane backend for both legs (its lane programs are bindings,
        # nothing to compile per leg), and the per-config backend with the
        # card's kernel by law.
        be = TorchBackend(kernel="plain", device=args.device)
        be_run = TorchBackend(device=args.device)
    except RuntimeError as e:
        print(f"{e}", file=sys.stderr)
        return 2
    cfgs = bench_batch.chaos_grid(args.configs, args.seed)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    trace_path = out.with_suffix(".jsonl")
    trace_path.unlink(missing_ok=True)

    print(f"the fused grid of {len(cfgs)} configs on {be.device}: a warm-up, then census "
          f"off and on in turns, bucket by bucket...", flush=True)
    _programs.disable()
    census = _programs.configure()

    def run_leg(on):
        def run(sub):
            _programs.install(census if on else None)
            return be.run_fused(sub)[0]
        return run

    walls, best, buckets, baseline, same = interleaved_ab(
        cfgs, {"census_off": run_leg(False), "census_on": run_leg(True)},
        args.repeats)
    _programs.install(census)
    print_ab(walls, buckets, same)
    verdict = overhead_of(walls, best, "census_on", "census_off", OVERHEAD_BOUND)
    overhead = verdict["overhead_fraction"]

    # The untimed compacted and per-config samples, census on and traced:
    # the census holds the kernel instantiations the per-config runs launch.
    _trace.configure(path=trace_path)
    sample = cfgs[:args.compacted_sample]
    res_comp, _ = be.run_fused(sample, compaction=CompactionPolicy(width=64, segment=1))
    res_percfg = [_programs.capture_call(_programs.config_label(c), be_run.run, (c,), {})[0]
                  for c in cfgs[:args.per_config_sample]]
    _trace.disable()
    same = (same and results_equal(baseline[:len(sample)], res_comp)
            and results_equal(baseline[:len(res_percfg)], res_percfg))

    programs_block = record.programs_block()
    doc = {
        **record.new_record("programs_census"),
        "description": "kernel-census A/B on the seeded chaos grid: fused lanes census-on "
                       "vs census-off after a warm-up, the legs taking turns bucket by "
                       "bucket, each leg's wall the sum of its buckets' best, results "
                       "bit-compared; the census holds the kernel instantiations of the "
                       "per-config sample (tools/programs.py census)",
        "generator_version": sampler.GENERATOR_VERSION,
        "seed": args.seed,
        "configs": args.configs,
        "repeats": args.repeats,
        "device": str(be_run.device),
        "legs": {leg: {"walls_s": walls[leg], "wall_s": best[leg]}
                 for leg in ("census_off", "census_on")},
        **verdict,
        "overhead_bound": OVERHEAD_BOUND,
        "bit_identical": bool(same),
        # The census's first time on over the grid (the first repeat's leg).
        "capture_wall_s": walls["census_on"][0] if walls["census_on"] else None,
        "capture_errors": census.capture_errors,
        "compacted_sample_configs": len(sample),
        "per_config_sample_configs": len(res_percfg),
        "per_config_kernels": [be_run.kernel_for(c) for c in cfgs[:len(res_percfg)]],
        "programs": programs_block,
        "compile_cache": record.compile_cache_block(be),
        "device_chain_note": (
            "wall-only A/B of host-side instrumentation; the census counts launches "
            "and reads ptxas reports, no kernel time is claimed"),
        "trace": record.trace_block(trace_path),
    }
    _programs.disable()
    out.write_text(json.dumps(doc, indent=1) + "\n")
    print(json.dumps({"out": str(out), "programs": (programs_block or {}).get("count"),
                      "kernel_launches": ((programs_block or {}).get("totals") or {})
                      .get("kernel_launches"),
                      **verdict, "bit_identical": doc["bit_identical"]}))
    ok = (same and overhead is not None and overhead <= OVERHEAD_BOUND
          and programs_block is not None)
    return 0 if ok else 1


def cmd_fused(args) -> int:
    print("programs fused is the reference's XLA-against-Pallas A/B of its fused "
          "round kernel; the port builds no XLA program to compare. K1 "
          "(csrc/fused_round.cu and the wide kernel) is held against the plain "
          "round driver by chip_smoke.py", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cli programs", description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_du = sub.add_parser("dump", help="a record's programs block as a table")
    p_du.add_argument("src", help="record JSON carrying a programs block")
    p_du.add_argument("--json", action="store_true")
    p_du.add_argument("--ops", type=int, default=0, metavar="N",
                      help="the reference's HLO op counts: no counterpart (refused)")
    p_du.set_defaults(fn=cmd_dump)

    p_di = sub.add_parser("diff", help="two censuses by key; exit 1 on fingerprint drift")
    p_di.add_argument("a")
    p_di.add_argument("b")
    p_di.set_defaults(fn=cmd_diff)

    p_ro = sub.add_parser("roofline", help="per-dispatch wall (trace spans) joined to "
                                           "the census")
    p_ro.add_argument("--census", required=True, help="record JSON with a programs block")
    p_ro.add_argument("--trace", default=None,
                      help="trace JSONL with program-attributed dispatch spans (default: "
                           "the file the record's trace block names, next to it)")
    p_ro.add_argument("--json", action="store_true")
    p_ro.add_argument("--vs", default=None, metavar="ART",
                      help="baseline record with a programs block: each row gains the "
                           "baseline entry's launches and registers")
    p_ro.set_defaults(fn=cmd_roofline)

    p_ce = sub.add_parser("census", help="census-on-vs-off A/B on the seeded chaos grid")
    p_ce.add_argument("--configs", type=int, default=280)
    p_ce.add_argument("--seed", type=int, default=0)
    p_ce.add_argument("--repeats", type=int, default=3)
    p_ce.add_argument("--compacted-sample", type=int, default=40,
                      help="configs for the untimed compacted leg")
    p_ce.add_argument("--per-config-sample", type=int, default=2,
                      help="configs for the untimed per-config leg (backend.run)")
    p_ce.add_argument("--device", default="cuda",
                      help="cuda (default; exits 2 with no card) or cpu")
    from byzantinerandomizedconsensus_tpu_torch.utils.rounds import default_artifact

    p_ce.add_argument("--out", default=default_artifact("programs", subdir=RECORD_DIR))
    p_ce.set_defaults(fn=cmd_census)

    p_fu = sub.add_parser("fused", help="the reference's XLA-vs-Pallas A/B: refused by "
                                        "name (no XLA program here)")
    p_fu.add_argument("--out", default=None)
    p_fu.set_defaults(fn=cmd_fused)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
