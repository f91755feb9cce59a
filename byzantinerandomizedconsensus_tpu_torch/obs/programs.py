"""The program census: which hand-written CUDA kernels a process launched.

The port's counterpart of the reference ``obs/programs.py``. The reference
censuses the XLA programs its compile seams build: cost and memory
analysis, an HLO fingerprint, the shape signature. The port builds no XLA
program; its programs are the instantiations of its CUDA kernels, built by
``nvcc`` at first use (``ops/_build.py``). So the census records, per
launched instantiation (one template instantiation of one kernel of one
library):

- what ``ptxas -v`` reported for it at build time (``ops/_build.py::
  build_log``): registers, barriers, static shared memory, stack frame and
  spill stores and loads (:func:`parse_ptxas`, in place of the reference's
  ``memory_summary``);
- the launch shape, grid and block and dynamic shared memory, of its last
  launch, and the distinct shapes it was launched at;
- its library and mangled symbol, and a fingerprint: the library's build
  digest (a hash of its sources and flags) with the symbol
  (:func:`kernel_fingerprint`, in place of ``hlo_fingerprint``);
- the number of launches.

The reference's ``normalize_hlo``, ``hlo_fingerprint``, ``cost_summary`` and
``memory_summary`` read HLO text and XLA's analyses; they have no
counterpart here and are not imitated. A kernel's cost is what
``chip_smoke.py`` bounds per kernel, from the plain version's work counters.

The kernel wrappers (``ops/fused_round.py::run_chunk``, ``ops/_step.py::
launch``) call :func:`note_launch` beside their launch counts when the
census is on. :func:`capture_call` (and :func:`instrument`, which wraps a
callable in it) counts the calls of a keyed callable, with their wall and
the instantiations each launched: the serving path keys each served config
by :func:`config_label`. Like the trace layer the census is opt-in
(:func:`configure` or ``BRC_PROGRAMS=1``) and inert when off, and it never
changes a result: it only counts. :func:`ProgramCensus.block` is the
schema-v1.4 ``programs`` record block (``obs/record.py::programs_block``).
"""

from __future__ import annotations

import hashlib
import os
import re
import threading
import time
from collections import OrderedDict

#: Environment knob: ``BRC_PROGRAMS=1`` (or any non-empty, non-"0" value)
#: enables the census in a process through :func:`maybe_enable_from_env`;
#: fleet workers inherit it from their parent.
PROGRAMS_ENV = "BRC_PROGRAMS"

# ---------------------------------------------------------------------------
# the ptxas report

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FIELDS = {
    "registers": re.compile(r"Used (\d+) registers"),
    "barriers": re.compile(r"used (\d+) barriers"),
    "smem_bytes": re.compile(r"(\d+) bytes smem"),
    "cmem0_bytes": re.compile(r"(\d+) bytes cmem\[0\]"),
}
_FRAME = {
    "stack_bytes": re.compile(r"(\d+) bytes stack frame"),
    "spill_stores": re.compile(r"(\d+) bytes spill stores"),
    "spill_loads": re.compile(r"(\d+) bytes spill loads"),
}


def parse_ptxas(log: str) -> dict:
    """``{symbol: {...}}`` of every entry function in a ``ptxas -v``
    report: ``registers``, ``barriers``, ``smem_bytes`` (static shared
    memory), ``cmem0_bytes``, ``stack_bytes``, ``spill_stores`` and
    ``spill_loads``, each as the report states it (0 where it states
    nothing). The ``Used`` line belongs to the last entry compiled; a
    stack-frame line to the function whose properties it follows."""
    out: dict = {}
    entry = props = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            entry = m.group(1)
            out.setdefault(entry, {k: 0 for k in (*_FIELDS, *_FRAME)})
            continue
        m = _PROPS.search(line)
        if m:
            props = m.group(1).strip("'")
            continue
        if "bytes stack frame" in line and props in out:
            for k, rx in _FRAME.items():
                f = rx.search(line)
                if f:
                    out[props][k] = int(f.group(1))
            continue
        if "Used" in line and "registers" in line and entry is not None:
            for k, rx in _FIELDS.items():
                f = rx.search(line)
                if f:
                    out[entry][k] = int(f.group(1))
    return out


_TEMPLATE_ARG = re.compile(r"L([ib])(n?)(\d+)E")


def kernel_of(symbol: str):
    """``(name, template args)`` of a mangled kernel symbol
    (``_Z18fused_round_kernelILi1ELi0ELi0EEv...`` → ``("fused_round_kernel",
    (1, 0, 0))``; bools as 0/1), or ``None`` when no ``*_kernel`` name is in
    it. Reads the Itanium source names, so a kernel in an anonymous
    namespace (``_ZN12_GLOBAL__N_1...``) is found as well."""
    i = 0
    while i < len(symbol):
        if not symbol[i].isdigit() or (i and symbol[i - 1].isdigit()):
            i += 1
            continue
        j = i
        while j < len(symbol) and symbol[j].isdigit():
            j += 1
        for start in range(i, j):
            size = int(symbol[start:j])
            name = symbol[j:j + size]
            if len(name) == size and name.endswith("_kernel") \
                    and re.fullmatch(r"[A-Za-z_]\w*", name):
                args, k = [], j + size
                if k < len(symbol) and symbol[k] == "I":
                    k += 1
                    while True:
                        m = _TEMPLATE_ARG.match(symbol, k)
                        if not m:
                            break
                        v = int(m.group(3))
                        args.append(-v if m.group(2) else v)
                        k = m.end()
                return name, tuple(args)
        i = j
    return None


def kernel_fingerprint(library: str, symbol: str | None) -> dict:
    """The identity of one built instantiation: the library's build digest
    (``ops/_build.py``: a hash of its sources and flags, which names the
    built file) and the symbol, hashed together."""
    from byzantinerandomizedconsensus_tpu_torch.ops import _build

    digest = _build.library_path(library).stem.rsplit("-", 1)[-1]
    h = hashlib.sha256(f"{library}:{digest}:{symbol}".encode()).hexdigest()[:16]
    return {"hash": h, "library": library, "build_digest": digest,
            "symbol": symbol}


# ---------------------------------------------------------------------------
# the census collector


class ProgramCensus:
    """Thread-safe collector of census entries: one per launched kernel
    instantiation (``kernel/<library>/<label>``) and one per key given to
    :func:`capture_call`. One instance per process; the module-level fast
    path routes to it, or does nothing, as obs/trace.py does."""

    def __init__(self):
        self._lock = threading.Lock()
        self.entries: OrderedDict = OrderedDict()
        self.capture_errors = 0
        self._ptxas: dict = {}   # library -> parse_ptxas of its build log

    def _ptxas_of(self, library: str) -> dict | None:
        if library not in self._ptxas:
            from byzantinerandomizedconsensus_tpu_torch.ops import _build
            try:
                self._ptxas[library] = parse_ptxas(_build.build_log(library))
            except OSError:
                self.capture_errors += 1
                self._ptxas[library] = None
        return self._ptxas[library]

    def _instantiation(self, library: str, kernel: str, targs) -> tuple:
        """``(symbol, ptxas fields)`` of the instantiation of ``kernel``
        whose template arguments match ``targs`` (``None`` matches any),
        or ``(None, None)`` when the build log does not name it."""
        for symbol, fields in (self._ptxas_of(library) or {}).items():
            got = kernel_of(symbol)
            if got is None or got[0] != kernel or len(got[1]) != len(targs):
                continue
            if all(t is None or t == a for t, a in zip(targs, got[1])):
                return symbol, fields
        return None, None

    def note_launch(self, library: str, kernel: str, label: str, targs,
                    grid, block, smem: int = 0) -> str:
        """Count one launch of ``kernel``'s instantiation ``targs`` from
        ``library`` at launch shape ``grid`` x ``block`` with ``smem``
        bytes of dynamic shared memory; returns the entry's key."""
        key = f"kernel/{library}/{label}"
        shape = {"grid": list(grid), "block": list(block),
                 "dynamic_smem_bytes": int(smem)}
        with self._lock:
            entry = self.entries.get(key)
            if entry is None:
                symbol, fields = self._instantiation(library, kernel, tuple(targs))
                entry = {"key": key, "library": library, "kernel": kernel,
                         "template_args": list(targs), "label": label,
                         "fingerprint": kernel_fingerprint(library, symbol),
                         "ptxas": fields, "calls": 0, "shapes": {}}
                self.entries[key] = entry
            entry["calls"] += 1
            entry["launch"] = shape
            sk = f"{'x'.join(map(str, grid))}/{'x'.join(map(str, block))}/{int(smem)}"
            entry["shapes"][sk] = entry["shapes"].get(sk, 0) + 1
        frames = getattr(_local, "frames", None)
        if frames:
            for frame in frames:
                frame[key] = frame.get(key, 0) + 1
        return key

    def note_call(self, key: str, wall_s: float, kernels: dict) -> dict:
        """Count one call of the callable keyed ``key``: its wall and the
        launches it made, per instantiation key."""
        with self._lock:
            entry = self.entries.get(key)
            if entry is None:
                entry = {"key": key, "calls": 0, "wall_s": 0.0, "kernels": {}}
                self.entries[key] = entry
            entry["calls"] += 1
            entry["wall_s"] = round(entry["wall_s"] + wall_s, 6)
            for k, n in kernels.items():
                entry["kernels"][k] = entry["kernels"].get(k, 0) + n
            entry["fingerprint"] = _call_fingerprint(
                [self.entries[k]["fingerprint"]["hash"] for k in entry["kernels"]
                 if k in self.entries])
        return entry

    def record(self, entry: dict) -> None:
        with self._lock:
            self.entries[entry["key"]] = entry

    def block(self) -> dict | None:
        """The schema-v1.4 ``programs`` block, or None when nothing was
        counted (a record without the block stays a valid v1.x record).
        Totals: the entries, the kernel launches and the instantiations
        whose ptxas report was found."""
        with self._lock:
            programs = [dict(e) for e in self.entries.values()]
        if not programs:
            return None
        kernels = [e for e in programs if e["key"].startswith("kernel/")]
        totals = {"kernel_instantiations": len(kernels),
                  "kernel_launches": sum(e["calls"] for e in kernels),
                  "with_ptxas": sum(1 for e in kernels if e.get("ptxas")),
                  "wall_s": round(sum(e.get("wall_s") or 0.0 for e in programs), 6)}
        return {"count": len(programs), "programs": programs, "totals": totals}


def _call_fingerprint(hashes) -> dict | None:
    """A captured call's identity: the instantiations it launched."""
    if not hashes:
        return None
    h = hashlib.sha256(",".join(sorted(hashes)).encode()).hexdigest()[:16]
    return {"hash": h, "kernels": len(hashes)}


# ---------------------------------------------------------------------------
# module-level fast path (mirrors obs/trace.py: one global, zero work off)


_census: ProgramCensus | None = None
#: Per thread, the open capture_call frames: each gets the launches made
#: under it, so two servers in one process never share a count.
_local = threading.local()


def enabled() -> bool:
    return _census is not None


def current() -> ProgramCensus | None:
    return _census


def configure() -> ProgramCensus:
    """Enable the census for this process (idempotent: an already-running
    census keeps its entries)."""
    global _census
    if _census is None:
        _census = ProgramCensus()
    return _census


def disable() -> None:
    global _census
    _census = None


def maybe_enable_from_env() -> ProgramCensus | None:
    """Honor ``BRC_PROGRAMS`` (inherited by fleet workers from the parent
    environment). No-op when unset or ``0``."""
    val = os.environ.get(PROGRAMS_ENV, "")
    if val and val != "0":
        return configure()
    return None


def note_launch(library: str, kernel: str, label: str, targs, grid, block,
                smem: int = 0) -> None:
    """The kernel wrappers' hook (a no-op when the census is off)."""
    census = _census
    if census is not None:
        census.note_launch(library, kernel, label, targs, grid, block, smem)


def config_label(cfg) -> str:
    """The census key of a served or run config: every field that selects
    or shapes the kernel instantiations it launches, and the seed."""
    return (f"config/{cfg.protocol}/n{cfg.n}/f{cfg.f}/c{cfg.round_cap}/"
            f"{cfg.delivery}/{cfg.adversary}/{cfg.coin}/{cfg.init}/"
            f"f{cfg.faults}/w{cfg.crash_window}/i{cfg.instances}/"
            f"s{cfg.seed}/p{cfg.pack_version}")


def capture_call(key: str, fn, args, kwargs):
    """Run ``fn(*args, **kwargs)`` and count the call under ``key``, with
    its wall and the kernel launches it made on this thread. Returns
    ``(out, fn, entry)``, the reference's shape, where the reference's
    second item is the compiled executable to cache: here there is nothing
    to compile, so it is ``fn`` itself. With the census off the call runs
    uncounted and ``entry`` is None. An exception of ``fn`` propagates, as
    it would uncounted."""
    census = _census
    if census is None:
        return fn(*args, **kwargs), fn, None
    frames = getattr(_local, "frames", None)
    if frames is None:
        frames = _local.frames = []
    frame: dict = {}
    frames.append(frame)
    t0 = time.perf_counter()
    try:
        out = fn(*args, **kwargs)
    finally:
        frames.pop()
    return out, fn, census.note_call(key, time.perf_counter() - t0, frame)


def instrument(key: str, fn):
    """Wrap ``fn`` so each call runs through :func:`capture_call` under
    ``key``. Returns ``fn`` unchanged when the census is off."""
    if _census is None:
        return fn

    def wrapper(*args, **kwargs):
        return capture_call(key, fn, args, kwargs)[0]

    wrapper.census_key = key
    return wrapper
