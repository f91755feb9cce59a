"""Randomized differential soak — the instrument behind the "N configs, 0
mismatches" claims.

The port's copy of the reference ``tools/soak.py``. A seeded random config
generator (``tools/sampler.py``, draw for draw the reference's) sweeps the
whole semantic surface at small n (protocols × adversaries × coins × inits
× every delivery law, n ≤ 40, packing law v1) and holds every config's
per-instance (rounds, decision) arrays equal, bit for bit, across
independent implementations. The legs, each named in the record
(``legs``):

- **classic** (no ``--chaos``): the vectorized backend
  ``get_backend("torch", device=...)`` against the C++ core (``native``);
  on the card that is the kernels by law (the fused round kernel under
  urn, urn2, urn3 and committee, the per-step kernel under keys), on the
  CPU the plain driver. Every ``--oracle-every``-th config also runs a
  subsample of instances through the object oracle (``cpu``), the third
  implementation, anchoring the pair to the spec. The C++ core has no
  committee channel, so committee draws run the oracle on every instance
  in its place.
- **chaos** (``--chaos``): the spec-§9 fault schedules, and every config in
  a *subprocess* with a wall timeout, one retry after exponential backoff
  and a skip-with-record, with a checkpoint after each config (an
  interrupted run resumes where it stopped). The child runs the plain
  driver (``kernel="plain"``) with the full per-replica state and the §1
  safety invariants (``models/invariants.py``), then the **device leg**
  ``get_backend("torch")`` on the card (the fused round kernel; the plain
  driver for keys under a schedule, the one path that computes it), then
  the oracle subsample. A child asked for the CPU has no device leg and
  records ``"device_leg": "none (cpu)"``. The C++ core has no fault
  channel, so chaos has no native leg. Every kernel library is built by
  the parent before the first child starts; no child compiles.

    python -m byzantinerandomizedconsensus_tpu_torch.tools.soak --configs 120
    python -m byzantinerandomizedconsensus_tpu_torch.tools.soak --chaos --configs 16 --jobs 4
    python -m byzantinerandomizedconsensus_tpu_torch.cli chaos --configs 16 --liveness

Everything runs on the card unless ``--device cpu`` is given; with no card
and the card asked for, the soak exits 2 naming it. ``--compile-cache``
(the reference's XLA cache) has no counterpart and is refused by name.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import pathlib
import random
import subprocess
import sys
import time

import numpy as np

from byzantinerandomizedconsensus_tpu_torch.backends import get_backend
from byzantinerandomizedconsensus_tpu_torch.config import (
    DELIVERY_KINDS, FAULT_KINDS, SimConfig)
from byzantinerandomizedconsensus_tpu_torch.obs import trace as _trace
# The seeded config-draw laws live in the shared sampler; the names are
# re-exported here because they are this module's reproducibility contract
# (the load generator reads random_config, _f_ceiling and MAX_SOAK_N).
from byzantinerandomizedconsensus_tpu_torch.tools.sampler import (  # noqa: F401
    GENERATOR_VERSION, MAX_SOAK_N, _ADVERSARIES, _CHAOS_WINDOWS, _COINS,
    _INITS, _PROTOCOLS, _f_ceiling, random_config)
from byzantinerandomizedconsensus_tpu_torch.utils.rounds import default_artifact

#: Wall-clock budget of one subprocess attempt (a chaos child, or a fleet
#: worker's ready-or-timeout ladder).
CHAOS_TIMEOUT_S = 180.0
#: Base of the exponential backoff before a retry (``CHAOS_BACKOFF_S *
#: 2**attempt``).
CHAOS_BACKOFF_S = 0.5
#: The repository root: chaos children start there, so ``-m`` finds the
#: package whatever the caller's directory.
ROOT = pathlib.Path(__file__).resolve().parents[2]


def check_device(device: str) -> None:
    """Raise by name when ``device`` is a card and none is available: the
    soak never falls back to the CPU."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device is available; the soak runs its device legs on "
            f"{device!r} and does not fall back to the CPU — pass --device cpu")


def _leg_summary(res) -> dict:
    """Compact per-leg reproduction summary for a mismatch record."""
    return {
        "mean_rounds": float(res.rounds.mean()) if len(res.rounds) else 0.0,
        "capped": int((res.decision == 2).sum()),
        "rounds": res.rounds.tolist(),
        "decision": res.decision.tolist(),
    }


def mismatch_record(cfg: SimConfig, leg: str, a, b,
                    names=("a", "b")) -> dict:
    """A mismatch record that reproduces standalone from the artifact: the
    config, the first divergent instance with both legs' values there, and
    both legs' full (rounds, decision) summaries (instance counts here are
    ≤ 32 by the generator, so the arrays are artifact-sized)."""
    ra, rb = np.asarray(a.rounds), np.asarray(b.rounds)
    da, db = np.asarray(a.decision), np.asarray(b.decision)
    m = min(len(ra), len(rb))
    diff = np.flatnonzero((ra[:m] != rb[:m]) | (da[:m] != db[:m]))
    first = int(diff[0]) if len(diff) else None
    rec = {
        "config": dataclasses.asdict(cfg),
        "leg": leg,
        "n_differing": int(len(diff)),
        "first_divergent_instance": first,
    }
    if first is not None:
        rec["at_first_divergence"] = {
            names[0]: {"rounds": int(ra[first]), "decision": int(da[first])},
            names[1]: {"rounds": int(rb[first]), "decision": int(db[first])},
        }
    rec[names[0]] = _leg_summary(a)
    rec[names[1]] = _leg_summary(b)
    return rec


def _equal(a, b) -> bool:
    return (np.array_equal(a.rounds, b.rounds)
            and np.array_equal(a.decision, b.decision))


def _head(res, k: int):
    """``res`` cut to its first ``k`` instances (an oracle subsample)."""
    sub = dataclasses.replace(res)
    sub.rounds, sub.decision = res.rounds[:k], res.decision[:k]
    return sub


def run_soak(n_configs: int, seed: int = 0, oracle_every: int = 10,
             oracle_instances: int = 3, progress=print, chaos: bool = False,
             timeout_s: float = CHAOS_TIMEOUT_S,
             backoff_s: float = CHAOS_BACKOFF_S,
             checkpoint=None, inject=None, jobs: int = 1,
             trace_dir=None, device: str = "cuda", kernel=None) -> dict:
    """Run the differential; returns the artifact document (never raises on
    a mismatch: a soak reports every divergence it finds).

    ``device`` (``cuda`` by default, or ``cpu``) and ``kernel`` (``None``:
    the kernel by law) place the vectorized leg (classic) and the device
    leg (chaos). Chaos mode runs each config in a subprocess (wall timeout
    ``timeout_s``, one retry after ``backoff_s``·2^attempt, then
    skip-with-record) and resumes from ``checkpoint`` (a JSON path, written
    after every config). ``inject`` maps config indices to "crash" |
    "hang", the deterministic failure drill. ``jobs`` runs up to that many
    chaos subprocesses at once: the population is drawn first (the same
    draws as the sequential path), each worker keeps its own ladder, and the
    checkpoint is merged and written on the coordinating thread only.

    ``trace_dir`` turns on the host telemetry (``obs/trace.py``): the
    coordinator's lifecycle and heartbeat events to ``trace-coord.jsonl``,
    each subprocess to its own file (``BRC_TRACE``), merged into
    ``trace.jsonl`` after the run; its digest rides the record as the
    ``trace`` block."""
    check_device(device)
    tracer = None
    prev_trace_env = os.environ.get(_trace.TRACE_ENV)
    if trace_dir is not None:
        pathlib.Path(trace_dir).mkdir(parents=True, exist_ok=True)
        tracer = _trace.configure(trace_dir, role="coord")
        os.environ[_trace.TRACE_ENV] = str(trace_dir)
        _trace.event("chaos.start", configs=n_configs, seed=seed,
                     chaos=chaos, jobs=jobs)
    try:
        doc = _run_soak(n_configs, seed, oracle_every, oracle_instances,
                        progress, chaos, timeout_s, backoff_s, checkpoint,
                        inject, jobs, device, kernel)
    except BaseException:
        # a raising soak body must not leave the global tracer collecting
        # into the dead run's file
        if tracer is not None:
            _trace.finish(tracer)
        raise
    finally:
        if trace_dir is not None:
            if prev_trace_env is None:
                os.environ.pop(_trace.TRACE_ENV, None)
            else:
                os.environ[_trace.TRACE_ENV] = prev_trace_env
    if tracer is not None:
        _trace.event("chaos.done", mismatches=len(doc["mismatches"]),
                     violations=len(doc.get("violations", [])),
                     skipped=len(doc.get("skipped", [])))
        _trace.finish(tracer)
        from byzantinerandomizedconsensus_tpu_torch.obs import record as _record

        merged = _trace.merge(trace_dir)
        doc["trace"] = _record.trace_block(merged)
    return doc


def _run_soak(n_configs, seed, oracle_every, oracle_instances, progress,
              chaos, timeout_s, backoff_s, checkpoint, inject, jobs,
              device, kernel) -> dict:
    rng = random.Random(seed)
    mismatches = []
    violations = []
    skipped = []
    by_delivery: dict[str, int] = {d: 0 for d in DELIVERY_KINDS}
    by_adversary: dict[str, int] = {a: 0 for a in _ADVERSARIES}
    by_faults: dict[str, int] = {k: 0 for k in FAULT_KINDS}
    kernels: collections.Counter = collections.Counter()
    oracle_checked = 0
    resumed = 0
    records: dict[str, dict] = {}
    ckpt_path = pathlib.Path(checkpoint) if checkpoint else None
    if chaos and ckpt_path is not None:
        records = _load_checkpoint(ckpt_path, seed)

    if chaos:
        # The whole population first (the sequential draw order, so the
        # record reproduces by (generator_version, seed) whatever --jobs).
        cfgs = [random_config(rng, chaos=True) for _ in range(n_configs)]
        for cfg in cfgs:
            by_delivery[cfg.delivery] += 1
            by_adversary[cfg.adversary] += 1
            by_faults[cfg.faults] += 1
        if device != "cpu":
            # every kernel library built here, once, before any child
            # starts: no child runs nvcc
            from byzantinerandomizedconsensus_tpu_torch.ops import _build

            _build.build()

        def _oracle_n(k):
            return oracle_instances if k % max(1, oracle_every) == 0 else 0

        pending = []
        for k in range(n_configs):
            prev = records.get(str(k))
            if prev is not None and prev.get("status") != "skipped":
                resumed += 1
            else:
                pending.append(k)

        def _work(k):
            rec = _run_chaos_config(
                cfgs[k], _oracle_n(k), timeout_s=timeout_s,
                backoff_s=backoff_s, inject=(inject or {}).get(k), index=k,
                device=device, kernel=kernel)
            rec["index"] = k
            return k, rec

        done_count = 0

        def _merge(k, rec):
            nonlocal done_count, oracle_checked
            cfg = cfgs[k]
            if rec is not None:  # freshly run (resumed records pre-merged)
                records[str(k)] = rec
                if ckpt_path is not None:
                    _save_checkpoint(ckpt_path, seed, records)
                    _trace.event("chaos.checkpoint", merged=len(records))
            rec = records[str(k)]
            # count only oracle legs that ran: the child stamps
            # ``oracle_instances`` after its compare
            if rec.get("oracle_instances"):
                oracle_checked += 1
            leg = rec.get("device_leg")
            kernels[leg["kernel"] if isinstance(leg, dict) else str(leg)] += 1
            if rec["status"] == "skipped":
                skipped.append(rec)
                progress(f"soak[{k}]: SKIPPED after retry "
                         f"({rec.get('error', '?')}) {cfg}")
            elif rec["status"] == "mismatch":
                mismatches.append(rec["mismatch"])
                progress(f"soak[{k}]: MISMATCH {rec['mismatch']['leg']} {cfg}")
            # a mismatch and a safety violation can share a root cause:
            # both are recorded
            if rec.get("violations"):
                violations.append({"index": k,
                                   "config": dataclasses.asdict(cfg),
                                   "violations": rec["violations"]})
                progress(f"soak[{k}]: SAFETY VIOLATION {cfg}")
            done_count += 1
            # the live heartbeat: one instant event per completion
            _trace.event("chaos.progress", done=done_count, total=n_configs,
                         mismatches=len(mismatches),
                         violations=len(violations), skipped=len(skipped))
            if (rec["status"] == "ok" and not rec.get("violations")
                    and done_count % 25 == 0):
                progress(f"soak[{done_count}/{n_configs}]: "
                         f"{len(mismatches)} mismatches, "
                         f"{len(violations)} violations so far")

        if jobs <= 1:
            for k in range(n_configs):
                _merge(k, None if k not in pending else _work(k)[1])
        else:
            import concurrent.futures as _fut

            with _fut.ThreadPoolExecutor(max_workers=jobs) as pool:
                futs = {pool.submit(_work, k): k for k in pending}
                for k in sorted(set(range(n_configs)) - set(pending)):
                    _merge(k, None)
                for f in _fut.as_completed(futs):
                    _merge(*f.result())
    else:
        vec_be = get_backend("torch", device=device, kernel=kernel)
        native_be = get_backend("native")
        cpu_be = get_backend("cpu")
        for k in range(n_configs):
            cfg = random_config(rng, chaos=chaos)
            by_delivery[cfg.delivery] += 1
            by_adversary[cfg.adversary] += 1
            by_faults[cfg.faults] += 1
            oracle_n = oracle_instances if k % max(1, oracle_every) == 0 else 0

            kernels[vec_be.kernel_for(cfg)] += 1
            a = vec_be.run(cfg)
            if cfg.delivery == "committee":
                # The C++ core has no committee channel (spec §10): the
                # committee slice runs the object oracle on EVERY instance,
                # a stronger check than the subsample.
                b = cpu_be.run(cfg)
                record = None
                if not _equal(a, b):
                    record = mismatch_record(cfg, "torch_vs_oracle", a, b,
                                             names=("torch", "oracle"))
                elif oracle_n:
                    oracle_checked += 1
                if record is not None:
                    mismatches.append(record)
                    progress(f"soak[{k}]: MISMATCH {record['leg']} {cfg}")
                elif (k + 1) % 25 == 0:
                    progress(f"soak[{k + 1}/{n_configs}]: 0 mismatches so far")
                continue
            b = native_be.run(cfg)
            record = None
            if not _equal(a, b):
                record = mismatch_record(cfg, "torch_vs_native", a, b,
                                         names=("torch", "native"))
            elif oracle_n:
                ids = np.arange(min(oracle_n, cfg.instances), dtype=np.int64)
                c = cpu_be.run(cfg, ids)
                oracle_checked += 1
                if not _equal(_head(a, len(ids)), c):
                    record = mismatch_record(cfg, "torch_vs_oracle",
                                             _head(a, len(ids)), c,
                                             names=("torch", "oracle"))
            if record is not None:
                mismatches.append(record)
                progress(f"soak[{k}]: MISMATCH {record['leg']} {cfg}")
            elif (k + 1) % 25 == 0:
                progress(f"soak[{k + 1}/{n_configs}]: 0 mismatches so far")

    from byzantinerandomizedconsensus_tpu_torch.obs import record

    if chaos:
        legs = {"plain": f"torch kernel='plain' on {device}, full state and "
                         "the §1 safety invariants",
                "device": (f"torch on {device}, kernel {kernel or 'by law'}"
                           if device != "cpu" else "none (cpu)"),
                "oracle": "cpu (the object oracle), a subsample"}
    else:
        legs = {"vectorized": f"torch on {device}, kernel {kernel or 'by law'}",
                "arbiter": "native (the C++ core)",
                "oracle": "cpu (the object oracle), a subsample; every "
                          "instance of a committee draw"}
    doc = {
        **record.new_record("soak"),
        "description": ("randomized chaos soak: subprocess-isolated plain-"
                        "driver-vs-device differential under spec-§9 fault "
                        "schedules, with the safety invariants and an "
                        "object-oracle subsample (tools/soak.py --chaos)" if chaos
                        else "randomized torch-vs-native differential with an "
                        "object-oracle subsample; committee draws run the full "
                        "torch-vs-oracle leg instead (no native channel) "
                        "(tools/soak.py)"),
        "generator_version": GENERATOR_VERSION,
        "seed": seed,
        "chaos": chaos,
        "configs": n_configs,
        "device": device,
        "legs": legs,
        "kernels": dict(sorted(kernels.items())),
        "oracle_subsampled_configs": oracle_checked,
        "oracle_instances_per_check": oracle_instances,
        "by_delivery": by_delivery,
        "by_adversary": by_adversary,
        "mismatches": mismatches,
    }
    if chaos:
        doc.update(
            by_faults=by_faults,
            timeout_s=timeout_s,
            resumed_configs=resumed,
            skipped=skipped,
            violations=violations,
            safety_checked_instances=sum(
                r.get("checked_instances", 0) for r in records.values()),
        )
    return doc


# ---------------------------------------------------------------------------
# chaos mode: subprocess child, timeout/retry, checkpoint


def _load_checkpoint(path: pathlib.Path, seed: int) -> dict:
    """Per-config records of a prior run, or {} when absent or for another
    population: a checkpoint binds to (generator_version, seed, chaos)."""
    try:
        doc = json.loads(path.read_text())
    except (OSError, ValueError):
        return {}
    if (doc.get("generator_version") != GENERATOR_VERSION
            or doc.get("seed") != seed or not doc.get("chaos")):
        return {}
    done = doc.get("done")
    return dict(done) if isinstance(done, dict) else {}


def _save_checkpoint(path: pathlib.Path, seed: int, records: dict) -> None:
    """Atomic rewrite (tmp + replace): a kill mid-write leaves the old
    checkpoint or the new one, never a torn file."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(json.dumps({
        "generator_version": GENERATOR_VERSION, "seed": seed, "chaos": True,
        "done": records}, indent=1) + "\n")
    os.replace(tmp, path)


def child_argv(cfg: SimConfig, oracle_n: int, device: str = "cuda",
               kernel=None, inject=None) -> list:
    """The command line of one chaos child."""
    cmd = [sys.executable, "-m", "byzantinerandomizedconsensus_tpu_torch.tools.soak",
           "--child-config", json.dumps(dataclasses.asdict(cfg)),
           "--child-oracle", str(oracle_n), "--device", device]
    if kernel:
        cmd += ["--kernel", kernel]
    if inject:
        cmd += ["--inject", inject]
    return cmd


def _run_chaos_config(cfg: SimConfig, oracle_n: int, timeout_s: float,
                      backoff_s: float, inject=None, index=None,
                      device: str = "cuda", kernel=None) -> dict:
    """One config in a subprocess: wall timeout, one retry with exponential
    backoff, then a skip-with-record. Returns the per-config record (status
    ok | mismatch | skipped, with the child's payload). The ladder is one
    ``chaos.config`` trace span; each rung (spawn, timeout, exit error,
    backoff, retry, skip) is an instant event."""
    cmd = child_argv(cfg, oracle_n, device, kernel, inject)
    errors = []
    with _trace.span("chaos.config", index=index) as sp:
        for attempt in range(2):
            if attempt:
                sleep_s = backoff_s * (2 ** (attempt - 1))
                _trace.event("chaos.backoff", index=index,
                             sleep_s=round(sleep_s, 3))
                time.sleep(sleep_s)
                _trace.event("chaos.retry", index=index, attempt=attempt)
            _trace.event("chaos.spawn", index=index, attempt=attempt)
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=timeout_s, cwd=ROOT)
            except subprocess.TimeoutExpired:
                _trace.event("chaos.timeout", index=index, attempt=attempt,
                             timeout_s=timeout_s)
                errors.append(f"attempt {attempt}: timeout after {timeout_s}s")
                continue
            if proc.returncode != 0:
                _trace.event("chaos.exit_error", index=index, attempt=attempt,
                             rc=proc.returncode)
                errors.append(f"attempt {attempt}: exit {proc.returncode} "
                              f"({(proc.stderr or '').strip()[-200:]})")
                continue
            try:
                payload = json.loads(proc.stdout.strip().splitlines()[-1])
            except (ValueError, IndexError):
                errors.append(f"attempt {attempt}: unparseable child output "
                              f"({proc.stdout[-200:]!r})")
                continue
            payload["attempts"] = attempt + 1
            sp["status"] = payload.get("status")
            sp["attempts"] = attempt + 1
            return payload
        _trace.event("chaos.skip", index=index)
        sp["status"] = "skipped"
    return {"status": "skipped", "config": dataclasses.asdict(cfg),
            "attempts": 2, "error": "; ".join(errors)}


def run_child(cfg_dict: dict, oracle_n: int, inject=None, device: str = "cuda",
              kernel=None) -> dict:
    """The chaos subprocess body: the plain driver with the full state and
    the §1 safety invariants, against the device leg (on the card; none on
    the CPU), then the object-oracle subsample. Prints nothing: returns the
    record, which :func:`main` emits as one JSON line."""
    if inject == "crash":
        os._exit(139)  # a native SIGSEGV death
    if inject == "hang":
        time.sleep(3600)
    # this child's own telemetry file (BRC_TRACE), merged by the
    # coordinator after the run, and with BRC_PROGRAMS its kernel census
    _trace.maybe_enable_from_env()
    from byzantinerandomizedconsensus_tpu_torch.obs import programs as _programs

    _programs.maybe_enable_from_env()
    cfg = SimConfig(**cfg_dict).validate()
    from byzantinerandomizedconsensus_tpu_torch.models import invariants

    plain_be = get_backend("torch", device=device, kernel="plain")
    with _trace.span("chaos.child.plain", n=cfg.n, protocol=cfg.protocol,
                     delivery=cfg.delivery, faults=cfg.faults):
        res, state, faulty = plain_be.run_with_state(cfg)
        viol = invariants.state_violations(cfg, state, faulty, res=res,
                                           inst_ids=res.inst_ids)
    rec = {
        "status": "ok",
        "config": cfg_dict,
        "checked_instances": int(len(res.inst_ids)),
        "violations": viol,
        "mean_rounds": float(res.rounds.mean()),
        "capped": int((res.decision == 2).sum()),
    }
    if device == "cpu":
        # no card: the plain driver is not passed off as a device leg
        rec["device_leg"] = "none (cpu)"
    else:
        dev_be = get_backend("torch", device=device, kernel=kernel)
        rec["device_leg"] = {"backend": "torch", "device": str(dev_be.device),
                             "kernel": dev_be.kernel_for(cfg)}
        with _trace.span("chaos.child.device", n=cfg.n, protocol=cfg.protocol,
                         delivery=cfg.delivery, faults=cfg.faults):
            dres = dev_be.run(cfg)
        if not _equal(res, dres):
            rec["status"] = "mismatch"
            rec["mismatch"] = mismatch_record(cfg, "plain_vs_device", res, dres,
                                              names=("plain", "device"))
            return rec
    if oracle_n > 0:
        ids = np.arange(min(oracle_n, cfg.instances), dtype=np.int64)
        with _trace.span("chaos.child.oracle", n=cfg.n,
                         instances=int(len(ids))):
            ores = get_backend("cpu").run(cfg, ids)
        rec["oracle_instances"] = int(len(ids))
        if not _equal(_head(res, len(ids)), ores):
            rec["status"] = "mismatch"
            rec["mismatch"] = mismatch_record(cfg, "plain_vs_oracle",
                                              _head(res, len(ids)), ores,
                                              names=("plain", "oracle"))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits 2 with no card) or cpu")
    ap.add_argument("--kernel", choices=("fused", "step", "plain"), default=None,
                    help="the vectorized (classic) or device (chaos) leg's "
                         "kernel; default: by law")
    ap.add_argument("--oracle-every", type=int, default=10,
                    help="every k-th config also runs an oracle subsample")
    ap.add_argument("--oracle-instances", type=int, default=3)
    ap.add_argument("--chaos", action="store_true",
                    help="chaos mode: random spec-§9 fault schedules, each "
                         "config subprocess-isolated (timeout → backoff → "
                         "retry → skip-with-record) with checkpoint resume "
                         "and the §1 safety-invariant checker")
    ap.add_argument("--timeout", type=float, default=CHAOS_TIMEOUT_S,
                    help="chaos: wall seconds per subprocess attempt")
    ap.add_argument("--backoff", type=float, default=CHAOS_BACKOFF_S,
                    help="chaos: base of the exponential retry backoff")
    ap.add_argument("--checkpoint", default=None,
                    help="chaos: checkpoint JSON path (default: OUT.ckpt)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="chaos: run up to N config subprocesses in parallel "
                         "(checkpoint merge stays single-threaded; per-"
                         "worker timeout/backoff/retry preserved)")
    ap.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="refused: the reference's XLA compilation cache has "
                         "no counterpart here (the kernels are built once, "
                         "before any child starts)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="host-side telemetry (obs/trace.py): coordinator "
                         "lifecycle/heartbeat events + one JSONL per worker "
                         "subprocess in DIR (exported as BRC_TRACE), merged "
                         "to DIR/trace.jsonl after the run; the record gains "
                         "the trace block")
    ap.add_argument("--liveness", action="store_true",
                    help="chaos: embed the spec-§9 liveness-degradation rows "
                         "(tools/divergence.py fault leg, torch on --device)")
    ap.add_argument("--out", default=None)
    # the chaos child's flags (the parent-spawned subprocess protocol)
    ap.add_argument("--child-config", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--child-oracle", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--inject", choices=("crash", "hang"), default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.child_config is not None:
        rec = run_child(json.loads(args.child_config), args.child_oracle,
                        inject=args.inject, device=args.device,
                        kernel=args.kernel)
        print(json.dumps(rec))
        return 0

    if args.compile_cache is not None:
        print("soak: --compile-cache configures XLA's on-disk compilation "
              "cache, which this package has no counterpart of: its CUDA "
              "kernels are built once into its build directory, before any "
              "chaos child starts", file=sys.stderr)
        return 2
    try:
        check_device(args.device)
    except RuntimeError as e:
        print(f"soak: {e}", file=sys.stderr)
        return 2
    out = pathlib.Path(args.out if args.out is not None
                       else default_artifact("chaos" if args.chaos else "soak"))
    checkpoint = args.checkpoint
    if args.chaos and checkpoint is None:
        checkpoint = str(out) + ".ckpt"
    doc = run_soak(args.configs, seed=args.seed,
                   oracle_every=args.oracle_every,
                   oracle_instances=args.oracle_instances,
                   chaos=args.chaos, timeout_s=args.timeout,
                   backoff_s=args.backoff, checkpoint=checkpoint,
                   jobs=max(1, args.jobs), trace_dir=args.trace,
                   device=args.device, kernel=args.kernel)
    if args.chaos:
        doc["jobs"] = max(1, args.jobs)
    if args.chaos and args.liveness:
        from byzantinerandomizedconsensus_tpu_torch.tools import divergence

        rows = divergence.run_fault_rows(backend="torch", device=args.device,
                                         progress=lambda *a: None)
        doc["liveness"] = {"rows": rows,
                           "summary": divergence.fault_rows_summary(rows)}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=1) + "\n")
    summary = {"out": str(out), "mismatches": len(doc["mismatches"]),
               "kernels": doc["kernels"]}
    if args.chaos:
        summary.update(violations=len(doc["violations"]),
                       skipped=len(doc["skipped"]),
                       resumed=doc["resumed_configs"])
    print(json.dumps(summary))
    return 1 if (doc["mismatches"] or doc.get("violations")
                 or doc.get("skipped")) else 0


if __name__ == "__main__":
    raise SystemExit(main())
