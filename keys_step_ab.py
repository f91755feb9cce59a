#!/usr/bin/env python3
"""Same-call A/B of a kernel against an earlier version of it.

    python3 keys_step_ab.py --kernel urn_step --extract chip_archive/urn_step_old --rev REV
    python3 keys_step_ab.py --kernel urn_step --old chip_archive/urn_step_old
    python3 keys_step_ab.py --kernel fused_round --old chip_archive/fused_round_old
    python3 keys_step_ab.py --kernel keys_step --old chip_archive/keys_step_old --sass

``--kernel`` is ``keys_step`` (the default), ``urn_step`` or ``fused_round``.
``--extract``
(in a git checkout) writes the earlier version's sources of that kernel
(``SOURCES``, those the revision has) from revision ``--rev`` into a
directory. ``--sass`` with ``--old`` (one card's machine, ``nvcc``) only
compares the two builds' SASS of the kernel's instantiation that config 5
runs (``SASS_FUNCTIONS``; config4's for ``fused_round``) and stops. ``--old`` needs one
CUDA card and ``nvcc``: it builds that directory's ``<kernel>.cu`` with the
port's flags into a temporary directory outside the repo, records the inputs
of every launch of the kernel in one run of config 5 at n=512 under its law
(keys or urn; 2000 instances, the main path of ``chip_smoke.py``'s phase 6)
through the current kernel, checks that the earlier kernel, the current one
and the plain version agree on each launch (both kernels through
``ops/_step.py::launch``, so the C interface must not have changed between
the two revisions), and times the two kernels in turns (old, new, new, old).
Each turn takes every launch's device time as ``chip_smoke.py`` does: 20
launches in a CUDA graph, its replay timed by CUDA events. It prints both
builds' ptxas registers and spills and the card's name and power limit.

For ``fused_round`` the earlier version's C entry point is the one that
takes the adversary's and the fault schedule's eight planes but no state
plane (ids, the planes, rounds, decision, then the sizes, the init, coin,
protocol, adversary and fault codes and the key). The run is config4's
100,000 instances in one
launch each: the two kernels must give identical results and the
reference's histograms, and each turn is the mean of 5 launches timed by
CUDA events, as ``chip_smoke.py`` times config4, in three rounds of turns
(old, new, new, old). Before the turns it compares the two builds' SASS of
config4's instantiation (``cuobjdump``), instruction by instruction, with
and without the constant-bank offsets of the kernel's parameters.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import difflib
import pathlib
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

import chip_smoke

#: The sources of each kernel's build: its .cu and every header it includes.
SOURCES = {
    "keys_step": ("keys_step.cu", "keys_step_kernel.cuh", "keys_step.cuh", "prf.cuh"),
    "urn_step": ("urn_step.cu", "urn_step.cuh", "keys_step.cuh", "prf.cuh"),
    "fused_round": ("fused_round.cu", "fused_round.cuh", "prf.cuh"),
}
#: The function whose SASS ``--sass`` compares, as a part of its mangled
#: name in the earlier build and in the current one: config 5's
#: instantiation of each step kernel (packing law v1, no equivocation; the
#: earlier version compared is one where the keys kernel is already a
#: template on (PACK, EQUIV)), config4's of fused_round.
SASS_FUNCTIONS = {
    "keys_step": ("keys_step_kernelILi1ELb0EE", "keys_step_kernelILi1ELb0EE"),
    "urn_step": ("urn_step_kernelE", "urn_step_kernelE"),
    "fused_round": ("fused_round_kernelILi1ELi0ELi0EE", "fused_round_kernelILi1ELi0ELi0EE"),
}
LAWS = {name: law for law, name in chip_smoke.STEP_LAWS.items()}
CSRC = "byzantinerandomizedconsensus_tpu_torch/csrc"


def extract(kernel: str, rev: str, out: pathlib.Path) -> None:
    out.mkdir(parents=True, exist_ok=True)
    wrote = []
    for name in SOURCES[kernel]:
        got = subprocess.run(["git", "show", f"{rev}:{CSRC}/{name}"], capture_output=True,
                             text=True)
        if got.returncode == 0:
            (out / name).write_text(got.stdout)
            wrote.append(name)
    print(f"wrote {', '.join(wrote)} of {rev} to {out}")


def build_old(kernel: str, src: pathlib.Path, tmp: pathlib.Path):
    from byzantinerandomizedconsensus_tpu_torch.ops import _build

    lib = tmp / f"{kernel}_old.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(src / f"{kernel}.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        chip_smoke.fail(f"nvcc failed for the earlier {kernel}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib)), proc.stdout + proc.stderr


def run(kernel, cfg, call, lib=None):
    """One recorded launch's inputs through ``ops/_step.py::launch``: the
    earlier build given as ``lib``, else the current kernel."""
    from byzantinerandomizedconsensus_tpu_torch.ops import _step

    return _step.launch(kernel, cfg, *call[:7], lib=lib)


def ab(kernel: str, old: pathlib.Path) -> None:
    from byzantinerandomizedconsensus_tpu_torch.config import SWEEP_POINT_N, sweep_point
    from byzantinerandomizedconsensus_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device is available")
    law = LAWS[kernel]
    card = chip_smoke.card_line()
    print(f"[card] {card}", flush=True)
    dev = torch.device("cuda", 0)
    _build.build((kernel,))
    with tempfile.TemporaryDirectory() as tmp:
        lib, log = build_old(kernel, old, pathlib.Path(tmp))
        for what, text in (("old", log), ("new", _build.build_log(kernel))):
            for line in text.splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    print(f"[ptxas] {what}: {line.strip()}", flush=True)
        cfg = dataclasses.replace(sweep_point(SWEEP_POINT_N), delivery=law).validate()
        calls = chip_smoke.recorded_launches(cfg, law, dev)
        for i, call in enumerate(calls):
            new, prev = run(kernel, cfg, call), run(kernel, cfg, call, lib)
            plain = chip_smoke.plain_step(law, cfg, *call)
            torch.cuda.synchronize()
            if chip_smoke.step_counts_max_err(new, plain) or chip_smoke.step_counts_max_err(
                    prev, plain):
                chip_smoke.fail(f"launch {i}: the kernels and the plain version disagree")
        print(f"[check] old, new and plain equal on all {len(calls)} launches of config 5 "
              f"{law} (n=512, 2000 instances)", flush=True)

        def turn(which):
            which_lib = lib if which == "old" else None
            per = [chip_smoke.graph_ms(lambda c=call: run(kernel, cfg, c, which_lib))
                   for call in calls]
            return sum(per) / len(per), per

        turns = []
        for which in ("old", "new", "new", "old"):
            mean, per = turn(which)
            turns.append((which, mean, per))
            print(f"[time] {which}: {mean:.5f} ms per launch, device time (per launch "
                  f"{[round(x, 5) for x in per]}; {card})", flush=True)
        old_ms = sum(m for w, m, _ in turns if w == "old") / 2
        new_ms = sum(m for w, m, _ in turns if w == "new") / 2
        per_old = [sum(x) / 2 for x in zip(*(per for w, _, per in turns if w == "old"))]
        per_new = [sum(x) / 2 for x in zip(*(per for w, _, per in turns if w == "new"))]
        print(f"[ab] {kernel} on config 5 {law}, n=512: old {old_ms:.5f} ms, new "
              f"{new_ms:.5f} ms per launch, {old_ms / new_ms:.2f}x; old/new by launch "
              f"{[round(o / n, 2) for o, n in zip(per_old, per_new)]}; {card}", flush=True)


def sass(lib: pathlib.Path, kernel: str) -> list:
    """The SASS instructions of the first function of ``lib`` whose mangled
    name contains ``kernel``, without addresses and encodings."""
    from byzantinerandomizedconsensus_tpu_torch.ops import _build

    tool = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    for func in re.split(r"\n\s*Function : ", out)[1:]:
        name, _, body = func.partition("\n")
        if kernel in name:
            return [re.sub(r"\s+", " ", m.group(1)).strip()
                    for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s*(.*?);", body)]
    chip_smoke.fail(f"no function {kernel} in {lib}")


def sass_diff(kernel: str, old_lib: pathlib.Path, old_name: str = None) -> None:
    """Print how the instantiation ``SASS_FUNCTIONS[kernel]`` differs
    between the earlier build and the current one, instruction by
    instruction, as compiled and with the parameters' constant-bank offsets
    masked. ``old_name`` names the function in the earlier build where its
    mangled name differs from ``SASS_FUNCTIONS``'."""
    from byzantinerandomizedconsensus_tpu_torch.ops import _build

    old_default, new_name = SASS_FUNCTIONS[kernel]
    old_name = old_name or old_default
    old_ins = sass(old_lib, old_name)
    new_ins = sass(_build.library_path(kernel), new_name)
    params = [[re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][param]", i) for i in ins]
              for ins in (old_ins, new_ins)]
    for what, (a, b) in (("as compiled", (old_ins, new_ins)),
                         ("with parameter offsets masked", params)):
        lines = [line for line in difflib.unified_diff(a, b, lineterm="", n=0)
                 if line[:1] in "+-" and line[:3] not in ("+++", "---")]
        print(f"[sass] {kernel} {new_name} {what}: old {len(a)}, new {len(b)} "
              f"instructions, {len(lines)} lines differ{': ' if lines else ''}"
              f"{' | '.join(lines[:16])}", flush=True)


def sass_only(kernel: str, old: pathlib.Path) -> None:
    """Build the earlier sources and the current ones and compare their SASS."""
    from byzantinerandomizedconsensus_tpu_torch.ops import _build

    _build.build((kernel,))
    with tempfile.TemporaryDirectory() as tmp:
        build_old(kernel, old, pathlib.Path(tmp))
        sass_diff(kernel, pathlib.Path(tmp) / f"{kernel}_old.so")


#: Rounds of turns (old, new, new, old) of the fused_round A/B: one round
#: left the difference outside the old kernel's two-turn spread.
FUSED_ROUNDS = 3


def ab_fused(old: pathlib.Path) -> None:
    """config4 through the current kernel's (bracha, none, none)
    instantiation and through an earlier build, in :data:`FUSED_ROUNDS`
    rounds of turns (old, new, new, old)."""
    from byzantinerandomizedconsensus_tpu_torch.config import preset
    from byzantinerandomizedconsensus_tpu_torch.ops import _build, fused_round, prf

    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device is available")
    card = chip_smoke.card_line()
    print(f"[card] {card}", flush=True)
    _build.build(("fused_round",))
    cfg = preset("config4")
    ids = torch.arange(cfg.instances, dtype=torch.int32, device="cuda")
    k0, k1 = prf.seed_key(cfg.seed)
    with tempfile.TemporaryDirectory() as tmp:
        lib, log = build_old("fused_round", old, pathlib.Path(tmp))
        for what, text in (("old", log), ("new", _build.build_log("fused_round"))):
            for line in text.splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    print(f"[ptxas] {what}: {line.strip()}", flush=True)
        # config4's instantiation: (bracha, none, none).
        sass_diff("fused_round", pathlib.Path(tmp) / "fused_round_old.so")
        # config4 has no adversary and no schedule: eight null planes.
        old_fn = lib.brc_fused_round_launch
        old_fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p]
        old_fn.restype = ctypes.c_int

        def run_old():
            rounds = torch.empty(cfg.instances, dtype=torch.int32, device="cuda")
            decision = torch.empty(cfg.instances, dtype=torch.uint8, device="cuda")
            rc = old_fn(ids.data_ptr(), *([None] * 8), rounds.data_ptr(),
                        decision.data_ptr(), cfg.instances, cfg.n, cfg.f, cfg.round_cap,
                        fused_round._INIT_CODES[cfg.init], fused_round._COIN_CODES[cfg.coin],
                        fused_round._PROTOCOL_CODES[cfg.protocol],
                        fused_round._ADVERSARY_CODES[cfg.adversary],
                        fused_round._FAULT_CODES[cfg.faults], k0, k1,
                        torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                chip_smoke.fail(f"the earlier fused_round failed to launch: CUDA error {rc}")
            return rounds, decision

        def run_new():
            return fused_round.run_chunk(cfg, ids)

        (ro, do), (rn, dn) = run_old(), run_new()
        torch.cuda.synchronize()
        if not (torch.equal(ro, rn) and torch.equal(do, dn)):
            chip_smoke.fail("the earlier and the current fused_round disagree on config4")
        dh = np.bincount(dn.cpu().numpy(), minlength=3).tolist()
        rh = np.bincount(rn.cpu().numpy(), minlength=cfg.round_cap + 1).tolist()
        if dh != chip_smoke.CONFIG4_DECISIONS or rh[:4] != chip_smoke.CONFIG4_ROUNDS_HEAD:
            chip_smoke.fail(f"config4 histograms differ from the reference: {dh}, {rh[:6]}")
        print(f"[check] old and new equal on config4's {cfg.instances} instances; "
              f"decision_histogram {dh}", flush=True)
        turns = []
        for _ in range(FUSED_ROUNDS):
            for which in ("old", "new", "new", "old"):
                ms = chip_smoke.cuda_ms(run_old if which == "old" else run_new, 5)
                turns.append((which, ms))
                print(f"[time] {which}: {ms:.4f} ms per launch (config4, 100,000 "
                      f"instances, mean of 5, CUDA events; {card})", flush=True)
        olds = [m for w, m in turns if w == "old"]
        news = [m for w, m in turns if w == "new"]
        old_ms, new_ms = sum(olds) / len(olds), sum(news) / len(news)
        print(f"[ab] fused_round on config4: old {old_ms:.4f} ms, new {new_ms:.4f} ms, "
              f"new/old {new_ms / old_ms:.4f}; new - old {new_ms - old_ms:.4f} ms against "
              f"the old kernel's spread {max(olds) - min(olds):.4f} ms over its "
              f"{len(olds)} turns (the new one's {max(news) - min(news):.4f} ms); turns "
              f"{[(w, round(m, 4)) for w, m in turns]}; {card}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=tuple(SOURCES), default="keys_step",
                    help="the kernel to compare (default keys_step)")
    ap.add_argument("--extract", type=pathlib.Path, help="write the earlier sources here")
    ap.add_argument("--rev", help="git revision of the earlier kernel (with --extract)")
    ap.add_argument("--old", type=pathlib.Path, help="directory of the earlier sources")
    ap.add_argument("--sass", action="store_true",
                    help="with --old: compare the two builds' SASS only")
    args = ap.parse_args()
    if args.extract:
        if not args.rev:
            ap.error("--extract needs --rev")
        extract(args.kernel, args.rev, args.extract)
    elif args.old and args.sass:
        sass_only(args.kernel, args.old)
    elif args.old and args.kernel == "fused_round":
        ab_fused(args.old)
    elif args.old:
        ab(args.kernel, args.old)
    else:
        ap.error("give --extract DIR or --old DIR")
    return 0


if __name__ == "__main__":
    sys.exit(main())
