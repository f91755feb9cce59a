"""The fused round: the whole round loop of a chunk of instances in one call.

Counterpart of the reference ``ops/pallas_round.py`` (the TPU kernel
``run_chunk``). Two implementations of one function
``(cfg, inst_ids, key) -> (rounds (B,) int32, decision (B,) uint8)``:

- :func:`run_chunk` launches the hand-written CUDA kernel: one CTA per
  instance. Under urn2 at n ≤ 1024 that is ``csrc/fused_round.cu``, one
  thread per replica; every other law and size runs the wide kernel
  (``csrc/fused_round_wide.cuh``), one library per (delivery law, layout):
  one replica per thread for n ≤ 1024 (packing law v1), up to four per
  thread in registers for n ≤ 4096 (v2), and past that (v3, the committee
  family) the state words in a (B, n) u32 scratch plane that this wrapper
  allocates. It takes CUDA tensors; given a CPU tensor it runs the plain
  version instead, because there is no kernel to run there.
- :func:`run_chunk_plain` is the plain torch round driver
  (:func:`models.driver.run_chunk`, the mirror of the reference's
  ``backends/jax_backend.py::_run_chunk``) on the kernel's surface. It runs
  on any device.

Both are bit-identical to the reference (tests/test_torch_fused_round.py and
tests/test_torch_fused_laws.py on the CPU; chip_smoke.py compares the two on
the card).

The kernel's surface: both protocols (benor, bracha), every static adversary
(none, crash, byzantine, adaptive, adaptive_min), every §9 fault schedule
(none, recover, partition, omission), every init law and both coins, under
the deliveries urn, urn2 and urn3 up to n = 4096 and committee up to
n = 2^20: the reference kernel's surface (``SUPPORTED_DELIVERIES``,
``pallas_round.py:74``) but its superset lanes. The §4b draws are those of
the per-step urn kernel (``csrc/urn_step.cuh::urn_counts``). The host
builds the static operands as the reference's kernel does
(``pallas_round.py:244-265``), since they need the §3.2 sort:
:func:`adversary_planes`, a (B, n) faulty plane and, under crash, a (B, n)
crash-round plane (none under adversary none); and :func:`fault_planes`, the
schedule's planes from :func:`models.faults.setup_faults`, whose fault-prone
set is the faulty plane under any adversary but none. The omission draws and
the committee's membership draws are made in the kernel. The first correct
replica, which reports each instance's decision, is found in the kernel by a
block reduction. Anything else raises :class:`FusedUnsupported`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from byzantinerandomizedconsensus_tpu_torch.models import adversaries, driver, faults
from byzantinerandomizedconsensus_tpu_torch.models.committee import quorum_params
from byzantinerandomizedconsensus_tpu_torch.obs import programs as _programs
from byzantinerandomizedconsensus_tpu_torch.ops import _build, prf
from byzantinerandomizedconsensus_tpu_torch.ops import committee as committee_law

#: The kernel's protocol, adversary, fault and delivery-law codes
#: (csrc/fused_round.cuh and csrc/fused_round_wide.cuh, brc::fused).
_PROTOCOL_CODES = {"benor": 0, "bracha": 1}
_ADVERSARY_CODES = {"none": 0, "crash": 1, "byzantine": 2, "adaptive": 3,
                    "adaptive_min": 4}
_FAULT_CODES = {"none": 0, "recover": 1, "partition": 2, "omission": 3}
_LAW_CODES = {"urn2": 0, "urn3": 1, "committee": 2, "urn": 3}

SUPPORTED = {
    "protocol": tuple(_PROTOCOL_CODES),
    "delivery": tuple(_LAW_CODES),
    "adversary": tuple(_ADVERSARY_CODES),
    "faults": tuple(_FAULT_CODES),
    "init": ("random", "all0", "all1", "split"),
    "coin": ("local", "shared"),
}
#: The largest n of each delivery law: the full-mesh laws stop at packing
#: law v2's edge, the committee family at v3's.
MAX_N = {"urn2": prf.V2_MAX_N, "urn3": prf.V2_MAX_N, "committee": prf.V3_MAX_N,
         "urn": prf.V2_MAX_N}
#: Where the law the kernel does not run is run instead.
ELSEWHERE = {"keys": "kernel='step' (csrc/keys_step.cu) or kernel='plain'"}

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
    if cfg.delivery in MAX_N and cfg.n > MAX_N[cfg.delivery]:
        problems.append(f"n={cfg.n} (delivery={cfg.delivery!r} stops at "
                        f"n={MAX_N[cfg.delivery]})")
    if problems:
        surface = ", ".join(f"{k} in {v}" for k, v in SUPPORTED.items())
        where = ELSEWHERE.get(cfg.delivery)
        raise FusedUnsupported(
            f"the fused round does not support {', '.join(problems)} at n={cfg.n}; "
            f"its surface is {surface}, n <= {MAX_N}"
            + (f"; delivery={cfg.delivery!r} runs on {where}" if where else ""))


def layout(cfg) -> int:
    """The kernel's layout R for ``cfg``: replicas per thread in registers
    (1 for n ≤ 1024, 4 for n ≤ 4096), or 0 past that, where the state words
    live in the scratch plane. It fixes the packing law (v1, v2, v3)."""
    return {1: 1, 2: 4, 3: 0}[cfg.pack_version]


def library(cfg) -> str:
    """The CUDA library (``csrc/<name>.cu``) that runs ``cfg``."""
    if cfg.delivery == "urn2" and cfg.n <= prf.V1_MAX_N:
        return "fused_round"
    return f"fused_round_{cfg.delivery}_r{layout(cfg)}"


@functools.lru_cache(maxsize=None)
def _launcher(name: str):
    fn = _build.load(name).brc_fused_round_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _wide_launcher(name: str):
    fn = _build.load(name).brc_fused_round_wide_launch
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 13 + [
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def wide_params(cfg) -> tuple:
    """The wide kernel's threshold and committee parameters ``(nq, fq, kq,
    csize)``: the (n, f) of the thresholds (:func:`quorum_params`), the
    committee quota k_C and size C (0 under the other laws)."""
    nq, fq = quorum_params(cfg)
    if cfg.delivery != "committee":
        return nq, fq, 0, 0
    return (nq, fq, committee_law.committee_quota(cfg.n, cfg.f),
            committee_law.committee_size(cfg.n))


def adversary_planes(cfg, inst_ids: torch.Tensor, key):
    """The kernel's static adversary operands on ``inst_ids.device``: the
    (B, n) uint8 faulty plane (``None`` under adversary none) and the (B, n)
    int32 crash-round plane (``None`` but under crash), as
    :meth:`AdversaryModel.setup` draws them under the PRF key ``key``."""
    if cfg.adversary == "none":
        return None, None
    faulty = adversaries.faulty_mask(cfg, key, inst_ids).to(torch.uint8).contiguous()
    if cfg.adversary != "crash":
        return faulty, None
    return faulty, adversaries.crash_rounds(cfg, key, inst_ids).contiguous()


def fault_planes(cfg, inst_ids: torch.Tensor, key, faulty=None):
    """The kernel's §9 operands on ``inst_ids.device``, from
    :func:`models.faults.setup_faults` under the PRF key ``key``:
    ``(fprone, down_at, up_at, side, part_start, part_heal)``, the (B, n)
    uint8 fault-prone plane, the (B, n) int32 outage window under recover,
    the (B, n) uint8 side and the (B,) int32 epoch under partition, ``None``
    where the schedule has none (all six under faults none). Under any
    adversary but none the fault-prone set is the faulty set, which the
    kernel reads from the faulty plane: the fprone slot is then ``None``,
    and ``faulty``, that plane when the caller has built it, saves the
    second sort. Omission's draws are made in the kernel."""
    fprone = None if faulty is None else faulty.bool()
    fs = faults.setup_faults(cfg, key, inst_ids, fprone=fprone)
    if fs is None:
        return (None,) * 6
    planes = dict(fs)
    planes["fprone"] = (fs["fprone"].to(torch.uint8) if cfg.adversary == "none"
                        else None)
    return tuple(None if planes.get(k) is None else planes[k].contiguous()
                 for k in ("fprone", "down_at", "up_at", "side", "part_start",
                           "part_heal"))


def operand_planes(cfg, inst_ids: torch.Tensor, key):
    """All eight static operands of one launch: :func:`adversary_planes`,
    then :func:`fault_planes`, which reuses the faulty plane."""
    faulty, crash = adversary_planes(cfg, inst_ids, key)
    return (faulty, crash) + fault_planes(cfg, inst_ids, key, faulty=faulty)


def run_chunk(cfg, inst_ids: torch.Tensor, key=None, planes=None):
    """Simulate one chunk with the CUDA kernel; returns ``(rounds, decision)``.

    ``inst_ids`` (B,) int32 on a CUDA device; ``key`` the ``(k0, k1)`` PRF
    key (default: from ``cfg.seed``) — an argument of the kernel, so one
    build serves every seed. ``planes`` are :func:`operand_planes` of these
    ids and key, when the caller has them (default: built here). A CPU
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
    if planes is None:
        planes = operand_planes(cfg, inst_ids, (k0, k1))
    name = library(cfg)
    ptrs = [None if x is None else x.data_ptr() for x in planes]
    head = (B, cfg.n, cfg.f, cfg.round_cap, _INIT_CODES[cfg.init], _COIN_CODES[cfg.coin])
    codes = (_PROTOCOL_CODES[cfg.protocol], _ADVERSARY_CODES[cfg.adversary],
             _FAULT_CODES[cfg.faults])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if name == "fused_round":
            rc = _launcher(name)(inst_ids.data_ptr(), *ptrs, rounds.data_ptr(),
                                 decision.data_ptr(), *head, *codes, k0, k1, stream)
        else:
            # The u32 state words of layout 0, as int32 (torch has no
            # uint32 arithmetic to need here).
            scratch = (torch.empty((B, cfg.n), dtype=torch.int32, device=dev)
                       if layout(cfg) == 0 else None)
            rc = _wide_launcher(name)(
                inst_ids.data_ptr(), *ptrs, None if scratch is None else scratch.data_ptr(),
                rounds.data_ptr(), decision.data_ptr(), *head, *wide_params(cfg), *codes,
                k0, k1, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches += 1
    if _programs.enabled():
        _census_launch(cfg, name, B)
    return rounds, decision


def _census_launch(cfg, name: str, B: int) -> None:
    """Count one launch in the program census (obs/programs.py): the
    instantiation (protocol, adversary, fault schedule; the wide kernel's
    layout) and the launch shape its C entry picks (one CTA per instance;
    blockDim the replicas per thread rounded up to whole warps, 1024 past
    n = 4096)."""
    codes = (_PROTOCOL_CODES[cfg.protocol], _ADVERSARY_CODES[cfg.adversary],
             _FAULT_CODES[cfg.faults])
    label = f"{cfg.protocol},{cfg.adversary},{cfg.faults}"
    if name == "fused_round":
        _programs.note_launch(name, "fused_round_kernel", label, codes, (B,),
                              ((cfg.n + 31) // 32 * 32,))
        return
    r = layout(cfg)
    threads = ((cfg.n + r - 1) // r + 31) // 32 * 32 if r else 1024
    _programs.note_launch(name, "fused_round_wide_kernel", label,
                          codes + (None, r), (B,), (threads,))


def run_chunk_plain(cfg, inst_ids: torch.Tensor, key=None, stats=None):
    """The plain torch round driver (:func:`models.driver.run_chunk` with
    the delivery law's plain sampler); returns ``(rounds, decision)`` on
    ``inst_ids.device``.

    ``stats``, when a dict, receives the work the run needed, counted over
    the instances still running in each round: ``instance_rounds``,
    ``coin_words`` (the coin's PRF words), under urn2 ``chain_trips`` (chain
    draws) and ``chain_seeds`` (segments with at least one draw, each one
    PRF word), under urn3 ``urn3_words`` and under committee
    ``committee_draws`` (the PRF words of the law: a drop word per receiver
    with a drop, and under committee a membership word per replica and
    step) with ``cheap_segments`` (the cheap law's segments), under urn
    ``urn_words`` (a drop word per receiver with a drop) and
    ``urn_random_draws`` (the draws that need a random word), each over the
    receivers whose counts are read, and under omission ``fault_words`` (the
    burst gate's and the bits' PRF words) — the inputs of the kernel's bound.
    """
    check_fused_supported(cfg)
    return driver.run_chunk(cfg, inst_ids, key, stats=stats)
