"""The launch shared by the per-step kernels (``csrc/keys_step.cu``,
``csrc/urn_step.cu``), and the surface they guard: both take the same
operands (the (B, n) planes of every sender and a range of receivers) and
write two (B, n_recv) int32 count planes, so one binding serves both.
Both protocols, every static adversary, every init law, both coins and the
packing laws v1 and v2 (n ≤ 4096) are on the surface; each kernel has two
libraries (:func:`library`), its config-5 instantiation (law v1, no
equivocation) alone and ``<kernel>_wide`` for the rest. Crash silences and
Bracha's Byzantine pairing reach the kernels through the ``silent`` and
``values`` planes, as in the reference (``pallas_tally.py:208``); the
adaptive family's bias and Ben-Or's per-receiver equivocation are drawn in
the kernels (:func:`adversary_code`). Like the reference's per-step kernels
they have no §9 fault-schedule channel: a fault config raises
:class:`StepFaultsUnsupported`, a :class:`~models.faults.FaultsUnsupported`,
and runs on ``kernel='plain'``."""

from __future__ import annotations

import ctypes
import functools

import torch

from byzantinerandomizedconsensus_tpu_torch.models.adversaries import two_faced
from byzantinerandomizedconsensus_tpu_torch.models.faults import (
    FaultsUnsupported, check_faults_supported)
from byzantinerandomizedconsensus_tpu_torch.ops import _build, prf

#: The kernels' adversary codes (csrc/keys_step.cuh): crash and byzantine
#: act through the planes alone, as none does; Ben-Or's Byzantine pairing
#: has a code of its own (:data:`TWO_FACED_CODE`).
ADVERSARY_CODES = {"none": 0, "crash": 0, "byzantine": 0, "adaptive": 1,
                   "adaptive_min": 2}
TWO_FACED_CODE = 3

#: The surface of the per-step kernels (ops/keys_step.py, ops/urn_step.py).
STEP_SUPPORTED = {
    "protocol": ("benor", "bracha"),
    "delivery": ("keys", "urn"),
    "adversary": tuple(ADVERSARY_CODES),
    "faults": ("none",),
}
#: Largest n: packing law v2's edge.
STEP_MAX_N = prf.V2_MAX_N


def adversary_code(cfg) -> int:
    """The kernels' adversary code of ``cfg``."""
    return TWO_FACED_CODE if two_faced(cfg) else ADVERSARY_CODES[cfg.adversary]


def library(name: str, cfg) -> str:
    """The library of kernel ``name`` that runs ``cfg``: ``name`` itself
    under packing law v1 without Ben-Or's equivocation, else
    ``<name>_wide``."""
    return name if cfg.pack_version == 1 and not two_faced(cfg) else f"{name}_wide"


class StepUnsupported(RuntimeError):
    """A config outside the per-step kernels' surface — raised by name, never
    a silent fallback to another code path."""


class StepFaultsUnsupported(StepUnsupported, FaultsUnsupported):
    """A §9 fault schedule given to the per-step kernels, which have no
    fault channel."""


def check_step_supported(cfg) -> None:
    """Reject configs outside the per-step surface with one message naming
    it; under a fault schedule as :class:`StepFaultsUnsupported`."""
    problems = [f"{field}={getattr(cfg, field)!r}"
                for field, allowed in STEP_SUPPORTED.items()
                if getattr(cfg, field) not in allowed]
    if cfg.n > STEP_MAX_N:
        problems.append(f"n={cfg.n}")
    if problems:
        surface = ", ".join(f"{k} in {v}" for k, v in STEP_SUPPORTED.items())
        msg = (f"the per-step kernels do not support {', '.join(problems)}; "
               f"their surface is {surface}, n <= {STEP_MAX_N}")
        check_faults_supported(cfg, msg, StepFaultsUnsupported)
        raise StepUnsupported(msg)


@functools.lru_cache(maxsize=None)
def _launcher(name: str, lib=None, shard: bool = True):
    """The C entry of library ``name``, or of ``lib``: ``brc_<name>_shard_launch``,
    which takes a receiver range, or with ``shard=False`` ``brc_<name>_launch``,
    the full-width entry of the builds before the range."""
    entry = f"brc_{name}_shard_launch" if shard else f"brc_{name}_launch"
    fn = getattr(_build.load(name) if lib is None else lib, entry)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_uint32, ctypes.c_uint32] + [ctypes.c_int] * (2 if shard else 0) + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def receiver_range(cfg, recv_ids) -> tuple[int, int]:
    """``(recv_offset, n_recv)`` of ``recv_ids``, a contiguous range of
    global receiver indices (a replica shard of the sharded path), as the
    reference's adapters read it (``recv_ids[0]`` and its length; checked
    by :func:`launch`); ``(0, n)`` for ``None``. Reading the first index of
    a CUDA tensor waits for it."""
    if recv_ids is None:
        return 0, cfg.n
    return (int(recv_ids[0]) if len(recv_ids) else 0), len(recv_ids)


def _u8(x: torch.Tensor, what: str, shape) -> torch.Tensor:
    if x.dtype not in (torch.uint8, torch.bool) or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {shape} uint8 or bool "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    return x.view(torch.uint8)


def launch(name: str, cfg, seed, inst_ids: torch.Tensor, rnd: int, step: int,
           values: torch.Tensor, silent: torch.Tensor, faulty: torch.Tensor,
           recv_offset: int = 0, n_recv=None, lib=None):
    """Launch kernel ``name`` (``keys_step`` or ``urn_step``) on CUDA
    tensors, from its :func:`library` for ``cfg``; returns ``(c0, c1)``,
    two (B, n_recv) int32 planes: the counts of the global receivers
    ``recv_offset .. recv_offset + n_recv - 1`` (default all n).

    ``inst_ids`` (B,) int32; ``values``, ``silent``, ``faulty`` (B, n) uint8
    or bool, all contiguous and on one CUDA device: the sender axis is
    always full width. Raises on anything else and on a launch that
    returns a CUDA error. ``lib`` is a loaded build of ``csrc/<name>.cu``,
    for a config of its surface (default: the port's own builds); one
    without ``brc_<name>_shard_launch`` (a build before the receiver
    range) runs the full width only, through ``brc_<name>_launch``.
    """
    dev = inst_ids.device
    if dev.type != "cuda" or any(x.device != dev for x in (values, silent, faulty)):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if inst_ids.dtype != torch.int32 or inst_ids.dim() != 1 \
            or not inst_ids.is_contiguous():
        raise ValueError("inst_ids must be a contiguous 1-D int32 tensor")
    B, n = inst_ids.shape[0], cfg.n
    n_recv = n if n_recv is None else int(n_recv)
    if n_recv < 1 or recv_offset < 0 or recv_offset + n_recv > n:
        raise ValueError(f"receiver range [{recv_offset}, {recv_offset + n_recv}) "
                         f"is not a non-empty range of the n={n} replicas")
    planes = [_u8(x, w, (B, n)) for x, w in
              ((values, "values"), (silent, "silent"), (faulty, "faulty"))]
    k0, k1 = prf.seed_key(seed)
    c0 = torch.empty((B, n_recv), dtype=torch.int32, device=dev)
    c1 = torch.empty((B, n_recv), dtype=torch.int32, device=dev)
    shard = lib is None or hasattr(lib, f"brc_{name}_shard_launch")
    if not shard and (recv_offset, n_recv) != (0, n):
        raise ValueError(f"this build of {name} has no receiver range")
    fn = _launcher(name if lib is not None else library(name, cfg), lib, shard)
    args = [inst_ids.data_ptr(), *(x.data_ptr() for x in planes), c0.data_ptr(),
            c1.data_ptr(), B, n, cfg.f, int(rnd), int(step), adversary_code(cfg), k0, k1]
    if shard:
        args += [int(recv_offset), n_recv]
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return c0, c1
