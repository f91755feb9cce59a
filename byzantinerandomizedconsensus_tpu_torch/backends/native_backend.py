"""Native C++ backend, registered as ``native[:threads]`` — an arbiter of the
bit-match.

A ctypes loader of the repo's multithreaded C++ core, ``native/simcore.cpp``
(C ABI v5), which bit-matches the object oracle: fast enough for
thousand-sample checks at benchmark scale (``cli bitmatch --arbiter
native``). It compiles the source with ``g++`` at first use into the port's
own ``build/`` directory, named by a hash of the source and the ABI, and
reads ``native/`` only. A missing ``g++`` or a failed build raises; nothing
runs in its place. The core has no §9 fault channel, no §10 committee
channel and no counter channel, and refuses those configs by name. It is
never the default of ``run`` or ``sweep``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Optional

import numpy as np

from byzantinerandomizedconsensus_tpu_torch.backends.base import SimResult, SimulatorBackend
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig

_PROTO = {"benor": 0, "bracha": 1}
_ADV = {"none": 0, "crash": 1, "byzantine": 2, "adaptive": 3, "adaptive_min": 4}
_COIN = {"local": 0, "shared": 1}
_INIT = {"random": 0, "all0": 1, "all1": 2, "split": 3}
_DELIVERY = {"keys": 0, "urn": 1, "urn2": 2, "urn3": 3}

#: v5: ``sim_run`` carries the spec §2 packing version in its arguments.
ABI_VERSION = 5
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
STACK = f"the native core (ABI v{ABI_VERSION})"


def source_path() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[2] / "native" / "simcore.cpp"


def library_path() -> pathlib.Path:
    """Where the current source builds to."""
    from byzantinerandomizedconsensus_tpu_torch.ops._build import BUILD

    digest = hashlib.sha256(source_path().read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"simcore-v{ABI_VERSION}-{digest}.so"


def build_library() -> pathlib.Path:
    """Compile ``native/simcore.cpp`` unless its library is built; returns
    the library's path. Raises if ``g++`` is missing or the build fails."""
    src = source_path()
    if not src.exists():
        raise FileNotFoundError(f"native source not found: {src}")
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found; {STACK} builds with a C++ compiler")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(src), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed (g++ exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    lib.sim_abi_version.restype = ctypes.c_int
    if lib.sim_abi_version() != ABI_VERSION:
        raise RuntimeError(f"native library ABI v{lib.sim_abi_version()} is not "
                           f"v{ABI_VERSION}")
    lib.sim_run.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
    ]
    lib.sim_run.restype = None
    return lib


def check_native_supported(cfg: SimConfig) -> None:
    """Refuse by name what the core has no channel for: §9 fault schedules
    and the §10 committee family."""
    from byzantinerandomizedconsensus_tpu_torch.models.committee import CommitteeUnsupported
    from byzantinerandomizedconsensus_tpu_torch.models.faults import FaultsUnsupported

    if cfg.faults != "none":
        raise FaultsUnsupported(
            f"{STACK} has no fault-schedule channel; "
            f"faults={cfg.faults!r} runs on the cpu|torch stacks")
    if cfg.delivery == "committee":
        raise CommitteeUnsupported(
            f"{STACK} has no committee channel; "
            "delivery='committee' runs on the cpu|torch stacks")


class NativeBackend(SimulatorBackend):
    """``n_threads=0`` (the default) uses every CPU."""

    name = "native"

    def __init__(self, n_threads: int = 0):
        self.n_threads = n_threads or (os.cpu_count() or 1)

    def run(self, cfg: SimConfig, inst_ids: Optional[np.ndarray] = None) -> SimResult:
        cfg = cfg.validate()
        check_native_supported(cfg)
        lib = load()
        ids = np.ascontiguousarray(self._resolve_inst_ids(cfg, inst_ids))
        rounds = np.empty(len(ids), dtype=np.int32)
        decision = np.empty(len(ids), dtype=np.uint8)
        if len(ids):
            lib.sim_run(
                _PROTO[cfg.protocol], cfg.n, cfg.f, _ADV[cfg.adversary],
                _COIN[cfg.coin], _INIT[cfg.init],
                ctypes.c_uint64(cfg.seed & 0xFFFFFFFFFFFFFFFF),
                cfg.round_cap, cfg.crash_window, _DELIVERY[cfg.delivery],
                cfg.pack_version,
                ids, len(ids), self.n_threads, rounds, decision,
            )
        return SimResult(config=cfg, inst_ids=ids, rounds=rounds, decision=decision)
