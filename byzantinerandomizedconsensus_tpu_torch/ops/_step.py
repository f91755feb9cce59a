"""The launch shared by the per-step kernels (``csrc/keys_step.cu``,
``csrc/urn_step.cu``), and the surface they guard: both take the same
operands and write two (B, n) int32 count planes, so one binding serves both.
Every init law and both coins are on the surface."""

from __future__ import annotations

import ctypes
import functools

import torch

from byzantinerandomizedconsensus_tpu_torch.ops import _build, prf

#: The kernels' adversary codes (csrc/keys_step.cuh).
ADVERSARY_CODES = {"none": 0, "adaptive": 1, "adaptive_min": 2}

#: The surface of the per-step kernels (ops/keys_step.py, ops/urn_step.py).
STEP_SUPPORTED = {
    "protocol": ("bracha",),
    "delivery": ("keys", "urn"),
    "adversary": tuple(ADVERSARY_CODES),
    "faults": ("none",),
}
#: Largest n of packing law v1, and the most threads a CTA may have.
STEP_MAX_N = prf.V1_MAX_N


class StepUnsupported(RuntimeError):
    """A config outside the per-step kernels' surface — raised by name, never
    a silent fallback to another code path."""


def check_step_supported(cfg) -> None:
    """Reject configs outside the per-step surface with one message naming it."""
    problems = [f"{field}={getattr(cfg, field)!r}"
                for field, allowed in STEP_SUPPORTED.items()
                if getattr(cfg, field) not in allowed]
    if cfg.n > STEP_MAX_N:
        problems.append(f"n={cfg.n}")
    if problems:
        surface = ", ".join(f"{k} in {v}" for k, v in STEP_SUPPORTED.items())
        raise StepUnsupported(
            f"the per-step kernels do not support {', '.join(problems)}; "
            f"their surface is {surface}, n <= {STEP_MAX_N}")


@functools.lru_cache(maxsize=None)
def _launcher(name: str, lib=None):
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
    """Launch ``csrc/<name>.cu`` on CUDA tensors; returns ``(c0, c1)``.

    ``inst_ids`` (B,) int32; ``values``, ``silent``, ``faulty`` (B, n) uint8
    or bool, all contiguous and on one CUDA device. Raises on anything else
    and on a launch that returns a CUDA error. ``lib`` is a loaded build of
    the kernel with the same C interface (default: the port's own build).
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
    fn = _launcher(name, lib)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(inst_ids.data_ptr(), *(x.data_ptr() for x in planes),
                c0.data_ptr(), c1.data_ptr(), B, n, cfg.f, int(rnd), int(step),
                ADVERSARY_CODES[cfg.adversary], k0, k1, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return c0, c1
