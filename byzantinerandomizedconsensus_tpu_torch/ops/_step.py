"""The launch shared by the per-step kernels (``csrc/keys_step.cu``,
``csrc/urn_step.cu``), and the surface they guard: both take the same
operands and write two (B, n) int32 count planes, so one binding serves both.
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
def _launcher(name: str, lib=None):
    """The C entry ``brc_<name>_launch`` of library ``name``, or of ``lib``."""
    fn = getattr(_build.load(name) if lib is None else lib, f"brc_{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _u8(x: torch.Tensor, what: str, shape) -> torch.Tensor:
    if x.dtype not in (torch.uint8, torch.bool) or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {shape} uint8 or bool "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    return x.view(torch.uint8)


def launch(name: str, cfg, seed, inst_ids: torch.Tensor, rnd: int, step: int,
           values: torch.Tensor, silent: torch.Tensor, faulty: torch.Tensor, lib=None):
    """Launch kernel ``name`` (``keys_step`` or ``urn_step``) on CUDA
    tensors, from its :func:`library` for ``cfg``; returns ``(c0, c1)``.

    ``inst_ids`` (B,) int32; ``values``, ``silent``, ``faulty`` (B, n) uint8
    or bool, all contiguous and on one CUDA device. Raises on anything else
    and on a launch that returns a CUDA error. ``lib`` is a loaded build of
    ``csrc/<name>.cu`` with the same C interface, for a config of its
    surface (default: the port's own builds).
    """
    dev = inst_ids.device
    if dev.type != "cuda" or any(x.device != dev for x in (values, silent, faulty)):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if inst_ids.dtype != torch.int32 or inst_ids.dim() != 1 \
            or not inst_ids.is_contiguous():
        raise ValueError("inst_ids must be a contiguous 1-D int32 tensor")
    B, n = inst_ids.shape[0], cfg.n
    planes = [_u8(x, w, (B, n)) for x, w in
              ((values, "values"), (silent, "silent"), (faulty, "faulty"))]
    k0, k1 = prf.seed_key(seed)
    c0 = torch.empty((B, n), dtype=torch.int32, device=dev)
    c1 = torch.empty((B, n), dtype=torch.int32, device=dev)
    fn = _launcher(name if lib is not None else library(name, cfg), lib)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(inst_ids.data_ptr(), *(x.data_ptr() for x in planes),
                c0.data_ptr(), c1.data_ptr(), B, n, cfg.f, int(rnd), int(step),
                adversary_code(cfg), k0, k1, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return c0, c1
