"""The sharded round driver and its backend: a ``(data, model)`` mesh in one
process.

The port's counterpart of the reference ``parallel/sharded.py`` (its
``shard_map``'d ``_run_chunk_sharded``) and of the threads of its host twin
``parallel/virtual.py``. Per chunk of instances on a mesh
(``parallel/mesh.py``):

- instance axis → ``data``: each data shard simulates its part of the
  instances with no communication at all;
- replica axis → ``model``: model shard m holds the state of the receivers
  ``recv_ids = m·n/M .. (m+1)·n/M − 1`` only. Each is a thread that runs the
  protocol's round body over its receivers
  (``models/bracha.py``/``benor.py::round_body`` with ``recv_ids`` and
  ``gather``). ``gather`` is a barrier-fenced concatenation of the shards'
  (B, n/M) values to the full (B, n) width, before the adversary,
  validation and delivery see them; the termination count and the
  decision are barrier-fenced sums (the reference's ``psum``).

The PRF addresses randomness by global coordinates, so a shard computes
exactly the draws of its receivers, and every count is an exact integer sum
over the full sender axis: the results equal the unsharded run's for every
mesh. The adversary's setup is full sender width on every shard, as in the
reference.

Each barrier waits at most :data:`BARRIER_TIMEOUT_S`: a shard that raises, or
one that never arrives, aborts the barriers of every shard, and the error
is raised on the calling thread by name (:class:`ShardFailed`), never a
hang. The shards of one device launch on the caller's current stream of
that device. The kernels' libraries are loaded before the threads start
(:meth:`TorchShardedBackend.prepare`), so no two shards build or load one
at the same moment.

This is the layout a multi-card mesh needs; on one card the shards share
it and take turns on its stream, so the mesh is slower than the unsharded
run there.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

import numpy as np
import torch

from byzantinerandomizedconsensus_tpu_torch.backends.base import (
    SimResult, SimulatorBackend, run_chunked)
from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import (
    KERNELS, STEP_KERNELS, check_plain_supported, kernel_chunk_size)
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig
from byzantinerandomizedconsensus_tpu_torch.models import benor, bracha
from byzantinerandomizedconsensus_tpu_torch.models import state as state_mod
from byzantinerandomizedconsensus_tpu_torch.models.adversaries import AdversaryModel
from byzantinerandomizedconsensus_tpu_torch.models.committee import check_committee_supported
from byzantinerandomizedconsensus_tpu_torch.models.faults import check_faults_supported
from byzantinerandomizedconsensus_tpu_torch.ops import _build, _step, fused_round, prf
from byzantinerandomizedconsensus_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, Mesh, make_mesh, visible_devices)

#: Seconds a shard waits at a barrier for its siblings before the run fails.
BARRIER_TIMEOUT_S = 120.0


class ShardFailed(RuntimeError):
    """A shard of the mesh raised, or did not reach a barrier in time; the
    message names the shard and the cause."""


class _Collective:
    """The barrier-fenced exchange of the model shards of one data shard:
    shard m contributes a tensor, every shard receives all of them. Two
    barrier phases per call (contribute, then read), so a shard cannot run
    ahead and overwrite a slot while a sibling still reads it."""

    def __init__(self, n_model: int, timeout: float):
        self.slots = [None] * n_model
        self.barrier = threading.Barrier(n_model, timeout=timeout)

    def exchange(self, m: int, x: torch.Tensor) -> list:
        self.slots[m] = x
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out

    def gather(self, m: int, v: torch.Tensor) -> torch.Tensor:
        """(B, R) per shard → the (B, n) concatenation, on shard m's device."""
        return torch.cat([s.to(v.device) for s in self.exchange(m, v)], dim=-1)

    def sum(self, m: int, x: torch.Tensor) -> torch.Tensor:
        """The sum over the shards of x, on shard m's device."""
        parts = self.exchange(m, x)
        out = parts[0].to(x.device)
        for p in parts[1:]:
            out = out + p.to(x.device)
        return out


def _run_shard(cfg, seed, ids: torch.Tensor, m: int, n_model: int, coll: _Collective,
               counts_fn):
    """One model shard's round loop; returns (rounds, decision) of its data
    shard, the same on every model shard."""
    n_local = cfg.n // n_model
    dev = ids.device
    round_body = benor.round_body if cfg.protocol == "benor" else bracha.round_body
    recv_ids = torch.arange(m * n_local, (m + 1) * n_local, dtype=torch.int64, device=dev)
    adv = AdversaryModel(cfg)
    setup = adv.setup(seed, ids)          # sender width: the full (B, n)
    faulty = setup["faulty"]
    faulty_local = faulty[:, m * n_local:(m + 1) * n_local]
    st = state_mod.init_state(cfg, seed, ids, recv_ids)
    done_at = torch.full(ids.shape, -1, dtype=torch.int32, device=dev)

    def gather(v):
        return coll.gather(m, v)

    r = 0
    while r < cfg.round_cap and not bool((done_at >= 0).all()):
        st = round_body(cfg, seed, ids, r, st, adv, setup, counts_fn=counts_fn,
                        recv_ids=recv_ids, gather=gather)
        cnt = coll.sum(m, (st["decided"] | faulty_local).sum(dim=-1, dtype=torch.int32))
        done_at = torch.where((done_at < 0) & (cnt == cfg.n),
                              torch.full_like(done_at, r + 1), done_at)
        r += 1
    done = done_at >= 0
    rounds = torch.where(done, done_at, torch.full_like(done_at, cfg.round_cap))
    # The decision: decided_val of the lowest-indexed correct replica (spec
    # §1), contributed by the shard that owns it through a sum.
    first = torch.argmax((~faulty).to(torch.uint8), dim=-1) - m * n_local
    owns = (first >= 0) & (first < n_local)
    mine = torch.gather(st["decided_val"], 1, first.clamp(0, n_local - 1)[:, None])[:, 0]
    val = coll.sum(m, torch.where(owns, mine.to(torch.int32), 0))
    decision = torch.where(done, val, 2).to(torch.uint8)
    return rounds, decision


def run_mesh(cfg, mesh: Mesh, ids_by_data: list, key=None, counts_fn=None) -> list:
    """Simulate each data shard's instances on its row of the mesh: one
    thread per (data, model) shard, all started together. ``ids_by_data``
    holds one (B_d,) integer tensor per data shard (an empty one is
    skipped). Returns one ``(rounds, decision)`` per data shard, on the
    device of its model shard 0 (``None`` for an empty shard). Raises
    :class:`ShardFailed` if any shard raises or waits at a barrier longer
    than :data:`BARRIER_TIMEOUT_S`."""
    timeout = BARRIER_TIMEOUT_S
    n_data, n_model = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
    if len(ids_by_data) != n_data:
        raise ValueError(f"{len(ids_by_data)} id shards for {n_data} data shards")
    if cfg.n % n_model:
        raise ValueError(f"n={cfg.n} not divisible by model-axis size {n_model}")
    seed = cfg.seed if key is None else prf.seed_key(key)
    # Each worker launches on the caller's current stream of every card.
    streams = {dev: torch.cuda.current_stream(dev) for dev in mesh.distinct_devices()
               if dev.type == "cuda"}
    colls = [_Collective(n_model, timeout) for _ in range(n_data)]
    results = [[None] * n_model for _ in range(n_data)]
    errors = []

    def worker(d, m):
        dev = mesh.devices[d][m]
        try:
            with contextlib.ExitStack() as stack:
                for s in streams.values():
                    stack.enter_context(torch.cuda.stream(s))
                if dev.type == "cuda":
                    stack.enter_context(torch.cuda.device(dev))
                results[d][m] = _run_shard(cfg, seed, ids_by_data[d].to(dev), m, n_model,
                                           colls[d], counts_fn)
        except BaseException as e:  # noqa: BLE001 — re-raised on the calling thread
            errors.append((d, m, e))
            for c in colls:  # siblings blocked at a barrier unwind at once
                c.barrier.abort()

    threads = [threading.Thread(target=worker, args=(d, m), daemon=True,
                                name=f"brc-shard-{d}x{m}")
               for d in range(n_data) if len(ids_by_data[d]) for m in range(n_model)]
    for t in threads:
        t.start()
    _join(threads, errors, timeout)
    if errors:
        broken = threading.BrokenBarrierError
        d, m, e = next((x for x in errors if not isinstance(x[2], broken)), errors[0])
        if isinstance(e, broken):
            raise ShardFailed(f"a shard of the {n_data}x{n_model} mesh did not reach a "
                              f"barrier within {timeout} s") from e
        raise ShardFailed(f"shard (data {d}, model {m}) of the {n_data}x{n_model} mesh "
                          f"failed: {e!r}") from e
    return [row[0] for row in results]


def _join(threads, errors, timeout: float) -> None:
    """Wait for the shard threads; once a shard has failed, wait at most
    ``timeout`` more for the rest (a shard stuck outside a barrier is left
    behind, a daemon thread)."""
    failed_at = None
    while any(t.is_alive() for t in threads):
        for t in threads:
            t.join(0.05)
        if errors and failed_at is None:
            failed_at = time.monotonic()
        if failed_at is not None and time.monotonic() - failed_at > timeout:
            return


def default_mesh(n_model: int, device="cuda") -> Mesh:
    """Every visible card (or the CPU) on the data axis with ``n_model``
    model shards each: when the cards divide by ``n_model`` the model axis
    spans cards, else each card holds its row's ``n_model`` shards (one
    card: the ``(1, n_model)`` layout on it)."""
    devs = visible_devices(device)
    if len(devs) % n_model == 0:
        return make_mesh(n_model=n_model, devices=devs)
    return make_mesh(n_data=len(devs), n_model=n_model,
                     devices=[d for d in devs for _ in range(n_model)])


class TorchShardedBackend(SimulatorBackend):
    """Mesh-parallel backend: instances over ``data``, replicas over
    ``model``; ``mesh=None`` builds :func:`default_mesh` with ``n_model``
    model shards on ``device``.

    ``kernel``: ``"plain"`` (the model layer's torch ops), ``"step"`` (the
    per-step CUDA kernels K2 and K3 with each shard's receiver offset,
    delivery keys or urn) or ``"fused"`` (the round-loop kernel K1, which
    holds the full replica width, so only the data axis shards: one launch
    per data shard, on its model shard 0's device). With none named, the
    card takes ``"step"`` for keys and urn and ``"plain"`` otherwise; the
    CPU takes ``"plain"``. The reference's counterparts are ``xla``,
    ``pallas`` and ``fused``.
    """

    name = "torch_sharded"

    def __init__(self, mesh: Optional[Mesh] = None, n_model: int = 1,
                 kernel: Optional[str] = None, device="cuda"):
        if kernel is not None and kernel not in KERNELS:
            raise ValueError(f"unknown kernel {kernel!r}; use one of {KERNELS}")
        self.mesh = default_mesh(n_model, device) if mesh is None else mesh
        self.device = self.mesh.devices[0][0]
        on_card = all(d.type == "cuda" for d in self.mesh.distinct_devices())
        if kernel in ("step", "fused") and not on_card:
            raise ValueError(f"kernel={kernel!r} launches CUDA kernels and needs a mesh "
                             f"of CUDA devices; a CPU mesh runs kernel='plain'")
        self.kernel = kernel if kernel is not None or on_card else "plain"

    def kernel_for(self, cfg: SimConfig) -> str:
        if self.kernel is not None:
            return self.kernel
        return "step" if cfg.delivery in _step.STEP_SUPPORTED["delivery"] else "plain"

    def check_supported(self, cfg: SimConfig) -> None:
        """``n % n_model`` raises ``ValueError``; ``fused`` takes K1's own
        gate; ``plain`` and ``step`` refuse a §9 fault schedule and the
        committee family on the mesh, by name, then take their kernel's
        gate (``kernel='fused'`` and the virtual mesh run both)."""
        n_model = self.mesh.shape[MODEL_AXIS]
        if cfg.n % n_model:
            raise ValueError(f"n={cfg.n} not divisible by model-axis size {n_model}")
        kernel = self.kernel_for(cfg)
        if kernel == "fused":
            fused_round.check_fused_supported(cfg)
            return
        check_faults_supported(cfg, "the mesh")
        check_committee_supported(cfg, "the mesh")
        if kernel == "step":
            _step.check_step_supported(cfg)
        else:
            check_plain_supported(cfg)

    def chunk_size(self, cfg: SimConfig) -> int:
        """Instances per chunk across the mesh, split over the data axis: the
        torch backend's chunk of the same kernel."""
        return kernel_chunk_size(cfg, self.kernel_for(cfg))

    def prepare(self, cfg: SimConfig) -> None:
        """Load the kernel's library and bind its entry before any shard
        thread starts."""
        kernel = self.kernel_for(cfg)
        if kernel == "fused":
            _build.load(fused_round.library(cfg))
        elif kernel == "step":
            lib = _step.library(STEP_KERNELS[cfg.delivery][0], cfg)
            _build.load(lib)
            _step._launcher(lib)

    def _chunk_fn(self, cfg):
        kernel = self.kernel_for(cfg)
        n_data = self.mesh.shape[DATA_AXIS]

        def fn(ids):
            parts = list(ids.tensor_split(n_data))
            if kernel == "fused":
                outs = [fused_round.run_chunk(cfg, p.to(self.mesh.devices[d][0]))
                        if len(p) else None for d, p in enumerate(parts)]
            else:
                counts_fn = STEP_KERNELS[cfg.delivery][1] if kernel == "step" else None
                outs = run_mesh(cfg, self.mesh, parts, counts_fn=counts_fn)
            outs = [o for o in outs if o is not None]
            return (torch.cat([o[0].to(ids.device) for o in outs]),
                    torch.cat([o[1].to(ids.device) for o in outs]))

        return fn

    def run(self, cfg: SimConfig, inst_ids: Optional[np.ndarray] = None) -> SimResult:
        cfg = cfg.validate()
        self.check_supported(cfg)
        ids = self._resolve_inst_ids(cfg, inst_ids)
        self.prepare(cfg)
        chunk = min(self.chunk_size(cfg), max(1, len(ids)))
        rounds, decision = run_chunked(self._chunk_fn(cfg), ids, chunk, self.device)
        return SimResult(config=cfg, inst_ids=ids, rounds=rounds, decision=decision)
