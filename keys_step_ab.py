#!/usr/bin/env python3
"""Same-call A/B of a kernel against an earlier version of it.

    python3 keys_step_ab.py --kernel urn_step --extract chip_archive/urn_step_old --rev REV
    python3 keys_step_ab.py --kernel urn_step --old chip_archive/urn_step_old
    python3 keys_step_ab.py --kernel fused_round --old chip_archive/fused_round_old

``--kernel`` is ``keys_step`` (the default), ``urn_step`` or ``fused_round``.
``--extract``
(in a git checkout) writes the earlier version's sources of that kernel
(``SOURCES``) from revision ``--rev`` into a directory. ``--old`` needs one
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

For ``fused_round`` the earlier version is one whose C entry point takes no
adversary operands (the config4 surface: ids, rounds, decision, then the
sizes, codes and key), and the run is config4's 100,000 instances in one
launch each: the two kernels must give identical results and the
reference's histograms, and each turn is the mean of 5 launches timed by
CUDA events, as ``chip_smoke.py`` times config4.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

import chip_smoke

#: The sources of each kernel's build: its .cu and every header it includes.
SOURCES = {
    "keys_step": ("keys_step.cu", "keys_step.cuh", "prf.cuh"),
    "urn_step": ("urn_step.cu", "urn_step.cuh", "keys_step.cuh", "prf.cuh"),
    "fused_round": ("fused_round.cu", "fused_round.cuh", "prf.cuh"),
}
LAWS = {name: law for law, name in chip_smoke.STEP_LAWS.items()}
CSRC = "byzantinerandomizedconsensus_tpu_torch/csrc"


def extract(kernel: str, rev: str, out: pathlib.Path) -> None:
    out.mkdir(parents=True, exist_ok=True)
    for name in SOURCES[kernel]:
        text = subprocess.run(["git", "show", f"{rev}:{CSRC}/{name}"], capture_output=True,
                              text=True, check=True).stdout
        (out / name).write_text(text)
    print(f"wrote {', '.join(SOURCES[kernel])} of {rev} to {out}")


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


def ab_fused(old: pathlib.Path) -> None:
    """config4 through the current kernel's (bracha, none) instantiation and
    through an earlier build, in turns (old, new, new, old)."""
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
        old_fn = lib.brc_fused_round_launch
        old_fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p]
        old_fn.restype = ctypes.c_int

        def run_old():
            rounds = torch.empty(cfg.instances, dtype=torch.int32, device="cuda")
            decision = torch.empty(cfg.instances, dtype=torch.uint8, device="cuda")
            rc = old_fn(ids.data_ptr(), rounds.data_ptr(), decision.data_ptr(),
                        cfg.instances, cfg.n, cfg.f, cfg.round_cap,
                        fused_round._INIT_CODES[cfg.init], fused_round._COIN_CODES[cfg.coin],
                        k0, k1, torch.cuda.current_stream().cuda_stream)
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
        for which in ("old", "new", "new", "old"):
            ms = chip_smoke.cuda_ms(run_old if which == "old" else run_new, 5)
            turns.append((which, ms))
            print(f"[time] {which}: {ms:.4f} ms per launch (config4, 100,000 instances, "
                  f"mean of 5, CUDA events; {card})", flush=True)
        old_ms = sum(m for w, m in turns if w == "old") / 2
        new_ms = sum(m for w, m in turns if w == "new") / 2
        print(f"[ab] fused_round on config4: old {old_ms:.4f} ms, new {new_ms:.4f} ms, "
              f"new/old {new_ms / old_ms:.4f}; turns {[(w, round(m, 4)) for w, m in turns]}; "
              f"{card}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=tuple(SOURCES), default="keys_step",
                    help="the kernel to compare (default keys_step)")
    ap.add_argument("--extract", type=pathlib.Path, help="write the earlier sources here")
    ap.add_argument("--rev", help="git revision of the earlier kernel (with --extract)")
    ap.add_argument("--old", type=pathlib.Path, help="directory of the earlier sources")
    args = ap.parse_args()
    if args.extract:
        if not args.rev:
            ap.error("--extract needs --rev")
        extract(args.kernel, args.rev, args.extract)
    elif args.old and args.kernel == "fused_round":
        ab_fused(args.old)
    elif args.old:
        ab(args.kernel, args.old)
    else:
        ap.error("give --extract DIR or --old DIR")
    return 0


if __name__ == "__main__":
    sys.exit(main())
