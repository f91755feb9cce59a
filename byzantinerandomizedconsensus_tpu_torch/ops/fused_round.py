"""The fused round: the whole round loop of a chunk of instances in one call.

Counterpart of the reference ``ops/pallas_round.py`` (the TPU kernel
``run_chunk``). Two implementations of one function
``(cfg, inst_ids, key) -> (rounds (B,) int32, decision (B,) uint8)``:

- :func:`run_chunk` launches the hand-written CUDA kernel
  (``csrc/fused_round.cu``): one CTA per instance, one thread per replica,
  the state word in a register. It takes CUDA tensors; given a CPU tensor it
  runs the plain version instead, because there is no kernel to run there.
- :func:`run_chunk_plain` is the plain torch round driver
  (:func:`models.driver.run_chunk`, the mirror of the reference's
  ``backends/jax_backend.py::_run_chunk``) on the kernel's surface. It runs
  on any device.

Both are bit-identical to the reference (tests/test_torch_fused_round.py on
the CPU; chip_smoke.py compares the two on the card).

The kernel's surface: both protocols (benor, bracha), every static adversary
(none, crash, byzantine, adaptive, adaptive_min), delivery urn2, faults none,
n ≤ 1024 (packing law v1), every init law and both coins. The host builds
the adversary's static operands as the reference's kernel does
(``pallas_round.py:244-265``): a (B, n) faulty plane and, under crash, a
(B, n) crash-round plane, from :meth:`AdversaryModel.setup`, which needs the
§3.2 sort; under adversary none there is none. The first correct replica,
which reports each instance's decision, is found in the kernel by a block
reduction. Anything else raises :class:`FusedUnsupported`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from byzantinerandomizedconsensus_tpu_torch.models import driver
from byzantinerandomizedconsensus_tpu_torch.models.adversaries import AdversaryModel
from byzantinerandomizedconsensus_tpu_torch.ops import _build, prf

#: The kernel's protocol and adversary codes (csrc/fused_round.cuh, brc::fused).
_PROTOCOL_CODES = {"benor": 0, "bracha": 1}
_ADVERSARY_CODES = {"none": 0, "crash": 1, "byzantine": 2, "adaptive": 3,
                    "adaptive_min": 4}

SUPPORTED = {
    "protocol": tuple(_PROTOCOL_CODES),
    "delivery": ("urn2",),
    "adversary": tuple(_ADVERSARY_CODES),
    "faults": ("none",),
    "init": ("random", "all0", "all1", "split"),
    "coin": ("local", "shared"),
}
#: Largest n of packing law v1, and the most threads a CTA may have.
MAX_N = prf.V1_MAX_N

_INIT_CODES = {"random": 0, "all0": 1, "all1": 2, "split": 3}
_COIN_CODES = {"local": 0, "shared": 1}

#: Launches of the CUDA kernel since the count was last set to 0.
launches = 0


class FusedUnsupported(RuntimeError):
    """A config outside the fused kernel's surface — raised by name, never a
    silent fallback to another code path."""


def check_fused_supported(cfg) -> None:
    """Reject configs outside the surface with one message naming it."""
    problems = [f"{field}={getattr(cfg, field)!r}"
                for field, allowed in SUPPORTED.items()
                if getattr(cfg, field) not in allowed]
    if cfg.n > MAX_N:
        problems.append(f"n={cfg.n}")
    if problems:
        surface = ", ".join(f"{k} in {v}" for k, v in SUPPORTED.items())
        raise FusedUnsupported(
            f"the fused round does not support {', '.join(problems)}; its "
            f"surface is {surface}, n <= {MAX_N}")


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("fused_round").brc_fused_round_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def adversary_planes(cfg, inst_ids: torch.Tensor, key):
    """The kernel's static adversary operands on ``inst_ids.device``: the
    (B, n) uint8 faulty plane (``None`` under adversary none) and the (B, n)
    int32 crash-round plane (``None`` but under crash), from
    :meth:`AdversaryModel.setup` under the PRF key ``key``."""
    if cfg.adversary == "none":
        return None, None
    setup = AdversaryModel(cfg).setup(key, inst_ids)
    faulty = setup["faulty"].to(torch.uint8).contiguous()
    if cfg.adversary != "crash":
        return faulty, None
    return faulty, setup["crash_round"].to(torch.int32).contiguous()


def run_chunk(cfg, inst_ids: torch.Tensor, key=None, planes=None):
    """Simulate one chunk with the CUDA kernel; returns ``(rounds, decision)``.

    ``inst_ids`` (B,) int32 on a CUDA device; ``key`` the ``(k0, k1)`` PRF
    key (default: from ``cfg.seed``) — an argument of the kernel, so one
    build serves every seed. ``planes`` are :func:`adversary_planes` of
    these ids and key, when the caller has them (default: built here). A CPU
    ``inst_ids`` runs :func:`run_chunk_plain`.
    """
    global launches
    check_fused_supported(cfg)
    if inst_ids.device.type == "cpu":
        return run_chunk_plain(cfg, inst_ids, key)
    if inst_ids.device.type != "cuda":
        raise ValueError(f"run_chunk takes CUDA or CPU tensors, got {inst_ids.device}")
    if inst_ids.dtype != torch.int32 or inst_ids.dim() != 1 \
            or not inst_ids.is_contiguous():
        raise ValueError("inst_ids must be a contiguous 1-D int32 tensor")
    k0, k1 = prf.seed_key(cfg.seed if key is None else key)
    B, dev = inst_ids.shape[0], inst_ids.device
    rounds = torch.empty(B, dtype=torch.int32, device=dev)
    decision = torch.empty(B, dtype=torch.uint8, device=dev)
    faulty, crash_round = (adversary_planes(cfg, inst_ids, (k0, k1)) if planes is None
                           else planes)
    launch = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(inst_ids.data_ptr(),
                    None if faulty is None else faulty.data_ptr(),
                    None if crash_round is None else crash_round.data_ptr(),
                    rounds.data_ptr(), decision.data_ptr(),
                    B, cfg.n, cfg.f, cfg.round_cap,
                    _INIT_CODES[cfg.init], _COIN_CODES[cfg.coin],
                    _PROTOCOL_CODES[cfg.protocol], _ADVERSARY_CODES[cfg.adversary],
                    k0, k1, stream)
    if rc != 0:
        raise RuntimeError(f"fused_round kernel launch failed: CUDA error {rc}")
    launches += 1
    return rounds, decision


def run_chunk_plain(cfg, inst_ids: torch.Tensor, key=None, stats=None):
    """The plain torch round driver (:func:`models.driver.run_chunk` with
    the urn2 law's plain sampler); returns ``(rounds, decision)`` on
    ``inst_ids.device``.

    ``stats``, when a dict, receives the work the run needed, counted over
    the instances still running in each round: ``instance_rounds``,
    ``coin_words`` (the coin's PRF words), ``chain_trips`` (urn2 chain draws)
    and ``chain_seeds`` (segments with at least one draw, each one PRF
    word), each over the receivers whose counts are read — the inputs of
    the kernel's bound.
    """
    check_fused_supported(cfg)
    return driver.run_chunk(cfg, inst_ids, key, stats=stats)
