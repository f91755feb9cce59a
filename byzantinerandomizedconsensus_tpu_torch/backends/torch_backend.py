"""The torch backend: the round loop on a CUDA card through the port's
kernels, or anywhere through the plain torch round driver.

Three kernels, chosen per backend:

- ``"fused"`` launches the fused round kernel once per chunk: the whole
  round loop (deliveries urn, urn2, urn3 and committee; both protocols,
  every static adversary, every §9 fault schedule, n up to each law's
  ceiling);
- ``"step"`` runs the per-step round driver (:func:`models.driver.run_chunk`)
  with a CUDA kernel as each broadcast step's delivery: ``csrc/keys_step.cu``
  under ``delivery="keys"``, ``csrc/urn_step.cu`` under ``delivery="urn"``
  (both protocols, every static adversary, n ≤ 4096);
- ``"plain"`` runs the same driver with each delivery law's plain torch
  version, on the model layer's own surface (:data:`PLAIN_SUPPORTED`).

The device is CUDA unless the caller asks for the CPU; with no card present
and the CPU not asked for, construction raises. The CPU runs ``"plain"``
only. With no kernel named, CUDA picks ``"fused"`` for every law of its
surface (urn among them) and ``"step"`` for keys; the per-step kernels have
no §9 fault channel, so a fault config under keys takes ``"plain"``, the
one path that computes it (under urn it runs on ``"fused"``). Named
explicitly, ``kernel="step"`` refuses such a config by name.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from byzantinerandomizedconsensus_tpu_torch.backends.base import (
    SimResult, SimulatorBackend, run_chunked)
from byzantinerandomizedconsensus_tpu_torch.config import FAULT_KINDS, SimConfig
from byzantinerandomizedconsensus_tpu_torch.models import adversaries, driver
from byzantinerandomizedconsensus_tpu_torch.models import state as state_mod
from byzantinerandomizedconsensus_tpu_torch.models.delivery import DELIVERIES
from byzantinerandomizedconsensus_tpu_torch.obs import counters as counters_mod
from byzantinerandomizedconsensus_tpu_torch.obs import programs as _programs
from byzantinerandomizedconsensus_tpu_torch.obs import trace as _trace
from byzantinerandomizedconsensus_tpu_torch.ops import (
    _build, _step, fused_round, keys_step, prf, urn_step)

KERNELS = ("fused", "step", "plain")
STEP_KERNELS = {"keys": ("keys_step", keys_step.counts_fn),
                 "urn": ("urn_step", urn_step.counts_fn)}

#: The surface of the plain path: what the model layer computes.
PLAIN_SUPPORTED = {
    "protocol": ("benor", "bracha"),
    "delivery": DELIVERIES,
    "adversary": adversaries.PORTED,
    "faults": FAULT_KINDS,
}
#: Largest n of the plain path, per delivery law: the full-mesh laws stop
#: at packing law v2's edge, the committee family at v3's.
PLAIN_MAX_N = {**{law: prf.V2_MAX_N for law in DELIVERIES}, "committee": prf.V3_MAX_N}
#: The fused kernel's chunks hold at most this many (instance, replica)
#: pairs: its u32 state plane and the wrapper's int64 adversary planes stay a
#: few GB at n = 2^17 (2048 instances) and beyond.
KERNEL_MAX_PAIRS = 1 << 28


class PlainUnsupported(RuntimeError):
    """A config outside the model layer's surface, raised by name."""


def check_plain_supported(cfg) -> None:
    """Reject configs the model layer does not compute, with one message
    naming its surface."""
    problems = [f"{field}={getattr(cfg, field)!r}"
                for field, allowed in PLAIN_SUPPORTED.items()
                if getattr(cfg, field) not in allowed]
    if cfg.n > PLAIN_MAX_N.get(cfg.delivery, prf.V2_MAX_N):
        problems.append(f"n={cfg.n}")
    if problems:
        surface = ", ".join(f"{k} in {v}" for k, v in PLAIN_SUPPORTED.items())
        raise PlainUnsupported(
            f"kernel='plain' does not support {', '.join(problems)}; its "
            f"surface is {surface}, n <= {prf.V2_MAX_N} (committee: n <= "
            f"{prf.V3_MAX_N})")


def kernel_chunk_size(cfg: SimConfig, kernel: str) -> int:
    """Instances per call of ``kernel``. The kernels take a whole chunk of
    the spec §2 instance field (4096 ids under v3), the fused kernel at most
    :data:`KERNEL_MAX_PAIRS` (instance, replica) pairs; the plain driver
    holds (B, n) int64 planes, so it is bounded by memory. (The plain keys
    law builds its (B, n, n) int64 keys and the partition cut's (B, n, n)
    bool plane :data:`ops.keys_step.PLAIN_PAIRS` triples at a time; what it
    holds whole is ``adaptive``'s (B, n, n) bool bias, one byte per
    triple.)"""
    pack_cap = {1: prf.MAX_INSTANCES, 2: prf.V2_MAX_INSTANCES,
                3: prf.V3_MAX_INSTANCES}[cfg.pack_version]
    if kernel == "step":
        return pack_cap
    if kernel == "fused":
        return max(1, min(pack_cap, KERNEL_MAX_PAIRS // cfg.n))
    return max(1, min(pack_cap, (1 << 22) // cfg.n))


class TorchBackend(SimulatorBackend):
    name = "torch"

    def __init__(self, kernel: Optional[str] = None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the torch backend runs on the "
                "card by default — pass device='cpu' for the plain path on "
                "the CPU")
        if kernel is not None and kernel not in KERNELS:
            raise ValueError(f"unknown kernel {kernel!r}; use one of {KERNELS}")
        if kernel in ("fused", "step") and self.device.type != "cuda":
            raise ValueError(
                f"kernel={kernel!r} launches CUDA kernels and needs a CUDA "
                f"device (got {self.device}); the CPU runs kernel='plain'")
        if kernel is None and self.device.type != "cuda":
            kernel = "plain"
        self.kernel = kernel

    def kernel_for(self, cfg: SimConfig) -> str:
        """The kernel a run of ``cfg`` takes: the one asked for, else
        ``"fused"`` for the laws of its surface, ``"step"`` for keys, and
        ``"plain"`` for keys under a §9 schedule (no kernel has both)."""
        if self.kernel is not None:
            return self.kernel
        if cfg.delivery in fused_round.SUPPORTED["delivery"]:
            return "fused"
        return "step" if cfg.faults == "none" else "plain"

    def check_supported(self, cfg: SimConfig) -> None:
        """Raise :class:`~ops.fused_round.FusedUnsupported`,
        :class:`~ops._step.StepUnsupported` (a fault config:
        :class:`~ops._step.StepFaultsUnsupported`) or
        :class:`PlainUnsupported` for a config outside the kernel's
        surface."""
        kernel = self.kernel_for(cfg)
        if kernel == "fused":
            fused_round.check_fused_supported(cfg)
        elif kernel == "step":
            _step.check_step_supported(cfg)
        else:
            check_plain_supported(cfg)

    def chunk_size(self, cfg: SimConfig) -> int:
        """Instances per call (:func:`kernel_chunk_size`)."""
        return kernel_chunk_size(cfg, self.kernel_for(cfg))

    def prepare(self, cfg: SimConfig) -> None:
        """Build (or load) the kernel a run of ``cfg`` launches, so a timed
        run does not pay for it. Off the card there is nothing to build."""
        if self.kernel_for(cfg) == "plain" or self.device.type != "cuda":
            return
        if self.kernel_for(cfg) == "fused":
            _build.load(fused_round.library(cfg))
        else:
            _build.load(_step.library(STEP_KERNELS[cfg.delivery][0], cfg))

    def compile_probe(self) -> int:
        """Kernel libraries loaded (built first where missing) in this
        process so far (``ops/_build.py``): the serving path's direct leg
        reads it, and after a warm-up pass over a config set it stays
        flat."""
        return _build.libraries_in_process()

    def run(self, cfg: SimConfig, inst_ids: Optional[np.ndarray] = None) -> SimResult:
        cfg = cfg.validate()
        self.check_supported(cfg)
        ids = self._resolve_inst_ids(cfg, inst_ids)
        self.prepare(cfg)
        chunk = min(self.chunk_size(cfg), max(1, len(ids)))
        kernel = self.kernel_for(cfg)
        if kernel == "fused":
            impl = functools.partial(fused_round.run_chunk, cfg)
        elif kernel == "step":
            impl = functools.partial(driver.run_chunk, cfg,
                                     counts_fn=STEP_KERNELS[cfg.delivery][1])
        else:
            impl = functools.partial(driver.run_chunk, cfg)
        # The per-config path's trace span (obs/trace.py), named by the
        # run's census key (obs/programs.py::config_label): the roofline
        # join (tools/programs.py) matches it against the census.
        with _trace.span("backend.run", backend=self.name, kernel=kernel, n=cfg.n,
                         instances=int(len(ids)), chunk=int(chunk),
                         dispatches=-(-len(ids) // chunk) if len(ids) else 0) as sp:
            if _trace.enabled():
                sp["program"] = _programs.config_label(cfg)
            rounds, decision = run_chunked(impl, ids, chunk, self.device)
        return SimResult(config=cfg, inst_ids=ids, rounds=rounds, decision=decision)

    def run_batch(self, cfgs, inst_ids=None, counters: bool = False):
        """Many configs of one shape bucket as lanes of one lane program,
        bit-identical per lane to :meth:`run` (``backends/batch.py``);
        ``kernel="plain"`` only."""
        from byzantinerandomizedconsensus_tpu_torch.backends import batch

        return batch.run_batch(self, cfgs, inst_ids=inst_ids, counters=counters)

    def run_many(self, cfgs, inst_ids=None, counters: bool = False, progress=None,
                 compaction=None):
        """Group arbitrary configs by shape bucket and run each group as
        lanes; ``compaction`` (a ``CompactionPolicy``) runs each bucket
        through the compacted lane grid (``backends/compaction.py``).
        Returns ``(results, report)`` (with counters: ``(results, docs,
        report)``)."""
        from byzantinerandomizedconsensus_tpu_torch.backends import batch

        return batch.run_many(self, cfgs, inst_ids=inst_ids, counters=counters,
                              progress=progress, compaction=compaction)

    def run_fused(self, cfgs, inst_ids=None, progress=None, compaction=None):
        """Fused ``superset`` lanes for sparse grids: only (protocol,
        delivery, tier, packing law) stay bound; adversary, fault kind,
        coin, init and round cap are per-row lane data."""
        from byzantinerandomizedconsensus_tpu_torch.backends import batch

        return batch.run_fused(self, cfgs, inst_ids=inst_ids, progress=progress,
                               compaction=compaction)

    def compile_cache_stats(self) -> dict:
        """The lane-program LRU's counters (the run record's
        ``compile_cache`` block)."""
        from byzantinerandomizedconsensus_tpu_torch.backends import batch

        return batch.compile_cache(self).stats()

    def run_with_counters(self, cfg: SimConfig, inst_ids: Optional[np.ndarray] = None):
        """``run`` plus the protocol-counter totals (``obs/counters.py``):
        returns ``(SimResult, counters_doc)``. The counters are a side output
        of the plain driver's round bodies, folded under the ``done_at < 0``
        mask, so the results are bit-identical to ``run``'s. The CUDA
        kernels compute delivery and tally in-kernel with no side channel:
        under ``fused`` or ``step`` this raises
        :class:`~obs.counters.CountersUnsupported`, naming the kernel."""
        res, _, _, rows = self._run_full(cfg, inst_ids, counters=True)
        totals = counters_mod.finalize(res.config, rows)
        return res, counters_mod.counters_doc(res.config, totals, backend=self.name)

    def run_with_state(self, cfg: SimConfig, inst_ids: Optional[np.ndarray] = None):
        """``run`` plus the final per-replica state and the faulty mask of
        that same run: ``(SimResult, state, faulty)``, ``state`` the
        ``models/state.py`` dict of (I, n) numpy arrays and ``faulty`` the
        (I, n) bool mask, the surface the safety invariants read
        (``models/invariants.py``). On every kernel:

        - ``fused``: the kernel's plane of final state words (its
          ``state_out``, or the scratch plane past n = 4096), decoded, and
          the wrapper's faulty plane (``ops/fused_round.py::
          adversary_planes``; all False under adversary none). Each
          instance's state is as its CTA left the loop, at its own end;
        - ``step``: the per-step driver's own state tensors
          (``models/driver.py::run_chunk_full`` with the kernel's counts
          function), as on ``plain``: the chunk's loop runs to its last
          instance's end.

        The two agree on every correct replica; a finished instance's faulty
        replicas, which run the honest machine, may differ (the invariants
        read correct replicas only)."""
        return self._run_full(cfg, inst_ids)[:3]

    def _run_full(self, cfg: SimConfig, inst_ids, counters: bool = False):
        cfg = cfg.validate()
        kernel = self.kernel_for(cfg)
        if counters and kernel != "plain":
            raise counters_mod.CountersUnsupported(
                f"kernel={kernel!r} has no protocol-counter side channel: the CUDA "
                f"kernel computes delivery and tally in-kernel; run with kernel='plain'")
        self.check_supported(cfg)
        ids = self._resolve_inst_ids(cfg, inst_ids)
        self.prepare(cfg)
        chunk = min(self.chunk_size(cfg), max(1, len(ids)))
        parts = []
        for lo in range(0, len(ids), chunk):
            cids = torch.as_tensor(ids[lo:lo + chunk], dtype=torch.int32).to(self.device)
            if kernel == "fused":
                out = self._fused_full(cfg, cids)
            else:
                counts_fn = STEP_KERNELS[cfg.delivery][1] if kernel == "step" else None
                out = driver.run_chunk_full(cfg, cids, counts_fn=counts_fn,
                                            counters=counters)
            parts.append({k: v for k, v in out.items() if v is not None})
        if not parts:
            parts = [{"rounds": torch.empty(0, dtype=torch.int32),
                      "decision": torch.empty(0, dtype=torch.uint8),
                      "state": state_mod.init_state(cfg, cfg.seed,
                                                    torch.empty(0, dtype=torch.int32)),
                      "faulty": torch.zeros((0, cfg.n), dtype=torch.bool),
                      "counters": counters_mod.zeros(cfg, 0)}]

        def cat(get):
            return torch.cat([get(p) for p in parts]).cpu().numpy()

        res = SimResult(config=cfg, inst_ids=ids,
                        rounds=cat(lambda p: p["rounds"]).astype(np.int32, copy=False),
                        decision=cat(lambda p: p["decision"]).astype(np.uint8, copy=False))
        state = {k: cat(lambda p: p["state"][k]) for k in parts[0]["state"]}
        rows = cat(lambda p: p["counters"]) if counters else None
        return res, state, cat(lambda p: p["faulty"]), rows

    @staticmethod
    def _fused_full(cfg: SimConfig, cids: torch.Tensor) -> dict:
        """One chunk through the fused kernel with its state plane: the
        run's outcome in :func:`models.driver.run_chunk_full`'s shape."""
        key = prf.seed_key(cfg.seed)
        planes = fused_round.operand_planes(cfg, cids, key)
        rounds, decision, words = fused_round.run_chunk(cfg, cids, key, planes=planes,
                                                        state=True)
        faulty = (torch.zeros(words.shape, dtype=torch.bool, device=words.device)
                  if planes[0] is None else planes[0].bool())
        return {"rounds": rounds, "decision": decision,
                "state": fused_round.decode_state(words), "faulty": faulty}
