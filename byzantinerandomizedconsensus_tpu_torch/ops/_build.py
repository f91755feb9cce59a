"""Build the port's hand-written kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into its
own shared library with a plain C interface, under the package's ``build/``
directory, named by a hash of the sources and flags: a changed source builds
anew, an unchanged one loads what is there. Several sources build in
parallel, one ``nvcc`` each. ``ptxas -v`` output (registers, spills) is kept
beside each library as ``<name>-<hash>.log``.

``load_host`` builds a ``csrc/<name>.cpp`` shim with ``g++`` the same way, so
the CPU tests can run the kernels' per-thread arithmetic without a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"

#: The CUDA sources of the port, one library each.
KERNELS = ("fused_round", "keys_step", "urn_step")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")


def _digest(source: pathlib.Path, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in [source] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> pathlib.Path:
    """Where ``csrc/<name>.cu`` builds to for the current sources."""
    return BUILD / f"{name}-{_digest(CSRC / f'{name}.cu', NVCC_FLAGS)}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under CUDA_HOME); the port's "
            "CUDA kernels build with the CUDA toolkit at first use")
    return str(path)


def build(names=KERNELS) -> dict:
    """Build every named kernel whose library is missing, all ``nvcc``
    processes started together. Returns ``{name: seconds}`` for the ones
    built; raises with the compiler's output if any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    running = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, out, tmp)
    took, failed = {}, []
    for name, (proc, out, tmp) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        took[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return took


def build_log(name: str) -> str:
    """The ``ptxas -v`` report of the current build of ``name``."""
    return library_path(name).with_suffix(".log").read_text()


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it first if needed."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))


@functools.lru_cache(maxsize=None)
def load_host(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cpp`` with ``g++`` (host code only) and load it."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found; the host build needs a C++ compiler")
    src = CSRC / f"{name}.cpp"
    out = BUILD / f"{name}-{_digest(src, GXX_FLAGS)}.so"
    if not out.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {src.name}:\n{proc.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))
