#!/usr/bin/env python3
"""Same-call A/B of the keys step kernel against an earlier version of it.

    python3 keys_step_ab.py --extract chip_archive/keys_step_old --rev REV
    python3 keys_step_ab.py --old chip_archive/keys_step_old

``--extract`` (in a git checkout) writes the earlier version's
``keys_step.cu``, ``keys_step.cuh`` and ``prf.cuh`` from revision ``--rev``
into a directory. ``--old`` needs one CUDA card and ``nvcc``: it builds that
directory's ``keys_step.cu`` with the port's flags into a temporary directory
outside the repo, records the inputs of every ``keys_step`` launch of
config 5 at n=512 under keys (2000 instances, the main path of
``chip_smoke.py``'s phase 6) through the current kernel, checks that the
earlier kernel, the current one and the plain version agree on each launch
(both kernels through ``ops/_step.py::launch``, so the C interface must not
have changed between the two revisions), and times the two kernels in turns (old, new, new, old): each turn the mean
per launch over the run's launches, 5 reps each, by CUDA events. It prints
both builds' ptxas registers and spills and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import pathlib
import subprocess
import sys
import tempfile

import torch

import chip_smoke

SOURCES = ("keys_step.cu", "keys_step.cuh", "prf.cuh")
CSRC = "byzantinerandomizedconsensus_tpu_torch/csrc"


def extract(rev: str, out: pathlib.Path) -> None:
    out.mkdir(parents=True, exist_ok=True)
    for name in SOURCES:
        text = subprocess.run(["git", "show", f"{rev}:{CSRC}/{name}"], capture_output=True,
                              text=True, check=True).stdout
        (out / name).write_text(text)
    print(f"wrote {', '.join(SOURCES)} of {rev} to {out}")


def build_old(src: pathlib.Path, tmp: pathlib.Path):
    from byzantinerandomizedconsensus_tpu_torch.ops import _build

    lib = tmp / "keys_step_old.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(src / "keys_step.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        chip_smoke.fail(f"nvcc failed for the earlier keys_step:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib)), proc.stdout + proc.stderr


def run(cfg, call, lib=None):
    """One recorded launch's inputs through ``ops/_step.py::launch``: the
    earlier build given as ``lib``, else the current kernel."""
    from byzantinerandomizedconsensus_tpu_torch.ops import _step

    return _step.launch("keys_step", cfg, *call[:7], lib=lib)


def ab(old: pathlib.Path) -> None:
    from byzantinerandomizedconsensus_tpu_torch.config import SWEEP_POINT_N, sweep_point
    from byzantinerandomizedconsensus_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device is available")
    card = chip_smoke.card_line()
    print(f"[card] {card}", flush=True)
    dev = torch.device("cuda", 0)
    _build.build(("keys_step",))
    with tempfile.TemporaryDirectory() as tmp:
        lib, log = build_old(old, pathlib.Path(tmp))
        for what, text in (("old", log), ("new", _build.build_log("keys_step"))):
            for line in text.splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    print(f"[ptxas] {what}: {line.strip()}", flush=True)
        cfg = dataclasses.replace(sweep_point(SWEEP_POINT_N), delivery="keys").validate()
        calls = chip_smoke.recorded_launches(cfg, "keys", dev)
        for i, call in enumerate(calls):
            new, prev = run(cfg, call), run(cfg, call, lib)
            plain = chip_smoke.plain_step("keys", cfg, *call)
            torch.cuda.synchronize()
            if chip_smoke.step_counts_max_err(new, plain) or chip_smoke.step_counts_max_err(
                    prev, plain):
                chip_smoke.fail(f"launch {i}: the kernels and the plain version disagree")
        print(f"[check] old, new and plain equal on all {len(calls)} launches of config 5 "
              f"keys (n=512, 2000 instances)", flush=True)

        def turn(which):
            which_lib = lib if which == "old" else None
            per = [chip_smoke.cuda_ms(lambda c=call: run(cfg, c, which_lib), 5)
                   for call in calls]
            return sum(per) / len(per), per

        turns = []
        for which in ("old", "new", "new", "old"):
            mean, per = turn(which)
            turns.append((which, mean))
            print(f"[time] {which}: {mean:.4f} ms per launch (per launch "
                  f"{[round(x, 4) for x in per]}; {card})", flush=True)
        old_ms = sum(m for w, m in turns if w == "old") / 2
        new_ms = sum(m for w, m in turns if w == "new") / 2
        print(f"[ab] keys_step on config 5 keys, n=512: old {old_ms:.4f} ms, new "
              f"{new_ms:.4f} ms per launch, {old_ms / new_ms:.2f}x; {card}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--extract", type=pathlib.Path, help="write the earlier sources here")
    ap.add_argument("--rev", help="git revision of the earlier kernel (with --extract)")
    ap.add_argument("--old", type=pathlib.Path, help="directory of the earlier sources")
    args = ap.parse_args()
    if args.extract:
        if not args.rev:
            ap.error("--extract needs --rev")
        extract(args.rev, args.extract)
    elif args.old:
        ab(args.old)
    else:
        ap.error("give --extract DIR or --old DIR")
    return 0


if __name__ == "__main__":
    sys.exit(main())
