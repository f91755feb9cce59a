"""Config-batched execution — shape buckets, lane programs and their cache.

The port's counterpart of the reference ``backends/batch.py``. A config
splits in two:

- the **shape bucket** (:class:`ShapeBucket`): what selects different code
  or array shapes — protocol, n padded to the next tier, round cap,
  delivery law, adversary, coin, init, fault kind, counters on or off, the
  spec §2 packing law. One lane program per bucket.
- the **lane operands**: what enters only the arithmetic — f, the PRF key,
  crash_window and the lane's real n (``n_eff``).

Torch has no ``vmap`` over a data-dependent loop, so the lane axis folds
into the row axis: one row per (lane, instance), each row carrying its
lane's operands as (rows,) int64 tensors (:class:`LaneConfig`), which the
model layer broadcasts against its (rows, n) planes. The program runs the
round body until every row has finished, freezing finished rows, as the
reference's vmapped ``while_loop`` does. No Python branch reads a lane
value. The **fused** lanes (:class:`FusedBucket`, :func:`run_fused`) fold
the adversary, fault kind, coin, init and round cap into lane data too
(per-row codes selecting between the jointly computed ``superset`` laws),
leaving one program per (protocol, delivery, tier, packing law).

Bit-identity to the per-config run is the law. The PRF addresses every draw
by coordinates (spec §2), so a row's draws do not depend on which program
or row evaluates them; lanes whose n is below the tier mark their padding
replicas silent and faulty for termination
(``models/adversaries.py::PadAdversary``), force their §3.2 rank keys past
every real key and read every value-of-n law through ``n_eff``.

Torch compiles nothing: a :class:`CompileCache` entry is the built lane
program for its key (bucket, lane tier, chunk), with the bucket's static law
choices bound. The cache keeps the reference's counters
(``brc_compile_cache_{hits,compiles,evictions}_total``), trace events
(``compile_cache.*``) and ``stats()`` keys; "0 steady-state recompiles"
reads here as "0 new entries". Every lane entry point runs the plain torch
round driver and refuses any other kernel by name.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from byzantinerandomizedconsensus_tpu_torch.config import (
    COUNT_LEVEL_DELIVERIES, SimConfig, validate_batch)
from byzantinerandomizedconsensus_tpu_torch.models import benor, bracha
from byzantinerandomizedconsensus_tpu_torch.models import state as state_mod
from byzantinerandomizedconsensus_tpu_torch.models.adversaries import PadAdversary
from byzantinerandomizedconsensus_tpu_torch.obs import counters as counters_mod
from byzantinerandomizedconsensus_tpu_torch.obs import metrics as _metrics
from byzantinerandomizedconsensus_tpu_torch.obs import trace as _trace
from byzantinerandomizedconsensus_tpu_torch.ops import prf

# Supported n tiers: a lane's n is padded up to the next tier so that nearby
# sizes share one program. Tiers above 4096 are reachable only by the §10
# committee family.
N_TIERS = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096,
           8192, 16384, 32768, 65536, 131072, 262144, 524288, 1048576)

#: Rows (lane, instance pairs) of one lane dispatch times the padded n: the
#: plain driver's (rows, n) int64 planes stay a few hundred MB, the budget
#: of the per-config plain path (``torch_backend.kernel_chunk_size``).
ROW_PAIRS = 1 << 22

#: The fused lanes' per-row codes of the folded config axes.
ADV_CODES = {"none": 0, "crash": 1, "byzantine": 2, "adaptive": 3, "adaptive_min": 4}
FAULT_CODES = {"none": 0, "recover": 1, "partition": 2, "omission": 3}
COIN_CODES = {"local": 0, "shared": 1}
INIT_CODES = {"random": 0, "all0": 1, "all1": 2, "split": 3}

#: The coarse small-n tier of the fused lanes: every n up to it pads to it.
FUSED_SMALL_TIER = 40


def n_tier(n: int) -> int:
    """The bucket shape tier for a config of size n (next tier ≥ n)."""
    for t in N_TIERS:
        if n <= t:
            return t
    raise ValueError(f"n={n} exceeds the largest supported tier {N_TIERS[-1]}")


def fused_tier(n: int) -> int:
    return FUSED_SMALL_TIER if n <= FUSED_SMALL_TIER else n_tier(n)


def _bucket_committee_c(delivery: str, n_pad: int) -> int:
    """C(n_pad) for committee buckets, 0 otherwise (a label field only)."""
    if delivery != "committee":
        return 0
    from byzantinerandomizedconsensus_tpu_torch.ops.committee import committee_size

    return committee_size(n_pad)


def lane_tier(lanes: int) -> int:
    """Lane-axis padding: the next power of two ≥ lanes."""
    if lanes < 1:
        raise ValueError("lane_tier needs >= 1 lanes")
    t = 1
    while t < lanes:
        t <<= 1
    return t


@dataclasses.dataclass(frozen=True)
class ShapeBucket:
    """The static half of a SimConfig: what the lane program binds.
    ``committee_c`` is C(n_pad) for committee buckets (0 otherwise), a pure
    function of (delivery, n_pad) that labels the bucket."""

    protocol: str
    n_pad: int
    round_cap: int
    delivery: str
    adversary: str
    coin: str
    init: str
    faults: str
    counters: bool
    pack_version: int
    committee_c: int = 0

    @classmethod
    def of(cls, cfg: SimConfig, counters: bool = False) -> "ShapeBucket":
        return cls(protocol=cfg.protocol, n_pad=n_tier(cfg.n),
                   round_cap=cfg.round_cap, delivery=cfg.delivery,
                   adversary=cfg.adversary, coin=cfg.coin, init=cfg.init,
                   faults=cfg.faults, counters=counters,
                   pack_version=cfg.pack_version,
                   committee_c=_bucket_committee_c(cfg.delivery, n_tier(cfg.n)))

    def label(self) -> str:
        tag = (f"{self.protocol}/n{self.n_pad}/c{self.round_cap}/"
               f"{self.delivery}/{self.adversary}/{self.coin}/{self.init}/"
               f"f{self.faults}/p{self.pack_version}")
        if self.committee_c:
            tag += f"/C{self.committee_c}"
        return tag + ("/counters" if self.counters else "")


@dataclasses.dataclass(frozen=True)
class FusedBucket:
    """The static residue of a config under fused lanes: what selects
    different code (step count, sampler family, key packing) or shapes."""

    protocol: str
    n_pad: int
    delivery: str
    pack_version: int
    committee_c: int = 0

    @classmethod
    def of(cls, cfg: SimConfig) -> "FusedBucket":
        return cls(protocol=cfg.protocol, n_pad=fused_tier(cfg.n),
                   delivery=cfg.delivery, pack_version=cfg.pack_version,
                   committee_c=_bucket_committee_c(cfg.delivery, fused_tier(cfg.n)))

    def label(self) -> str:
        tag = (f"fused/{self.protocol}/n{self.n_pad}/{self.delivery}/"
               f"p{self.pack_version}")
        return tag + (f"/C{self.committee_c}" if self.committee_c else "")

    counters = False


class LaneConfig:
    """A SimConfig view over (bucket statics, per-row lane operands).

    ``n`` is the padded tier (every array shape); ``f``, ``crash_window``
    and ``n_eff`` are (rows,) int64 tensors. ``seed`` is None: the key is
    always a per-row operand on the lane path."""

    __slots__ = ("_b", "f", "crash_window", "n_eff")

    def __init__(self, bucket, f, crash_window, n_eff):
        self._b = bucket
        self.f = f
        self.crash_window = crash_window
        self.n_eff = n_eff

    def take_rows(self, sl: slice) -> "LaneConfig":
        """The view of the rows ``sl`` (every per-row operand sliced)."""
        out = object.__new__(type(self))
        for cls in type(self).__mro__:
            for name in getattr(cls, "__slots__", ()):
                setattr(out, name, prf.take_rows(getattr(self, name), sl))
        return out

    protocol = property(lambda self: self._b.protocol)
    n = property(lambda self: self._b.n_pad)
    delivery = property(lambda self: self._b.delivery)
    pack_version = property(lambda self: self._b.pack_version)
    round_cap = property(lambda self: self._b.round_cap)
    adversary = property(lambda self: self._b.adversary)
    coin = property(lambda self: self._b.coin)
    init = property(lambda self: self._b.init)
    faults = property(lambda self: self._b.faults)
    seed = property(lambda self: None)

    @property
    def steps_per_round(self):
        return 2 if self.protocol == "benor" else 3

    @property
    def count_level(self):
        return self.delivery in COUNT_LEVEL_DELIVERIES

    @property
    def lying_adversary(self):
        return self.adversary in ("byzantine", "adaptive", "adaptive_min")


class FusedLaneConfig(LaneConfig):
    """A LaneConfig whose adversary, faults, coin and init are the
    ``superset`` laws (the model layer computes every variant and selects by
    the per-row codes) and whose round cap is per-row data too."""

    __slots__ = ("round_cap_t", "adv_code", "faults_code", "coin_code", "init_code")

    def __init__(self, bucket, f, crash_window, n_eff, round_cap,
                 adv_code, faults_code, coin_code, init_code):
        super().__init__(bucket, f=f, crash_window=crash_window, n_eff=n_eff)
        self.round_cap_t = round_cap
        self.adv_code = adv_code
        self.faults_code = faults_code
        self.coin_code = coin_code
        self.init_code = init_code

    round_cap = property(lambda self: self.round_cap_t)
    adversary = property(lambda self: "superset")
    faults = property(lambda self: "superset")
    coin = property(lambda self: "superset")
    init = property(lambda self: "superset")

    @property
    def lying_adversary(self):
        # byzantine (2), adaptive (3), adaptive_min (4): a per-row bool.
        return self.adv_code >= 2


#: Per-row operand names: strict buckets, then the fused lanes' codes.
STRICT_OPS = ("k0", "k1", "f", "win", "neff")
FUSED_OPS = STRICT_OPS + ("cap", "adv", "flt", "coin", "init")


def host_op_row(bucket, cfg: SimConfig) -> dict:
    """One config's lane operands as python ints."""
    k0, k1 = prf.seed_key(cfg.seed)
    row = {"k0": k0, "k1": k1, "f": cfg.f, "win": cfg.crash_window, "neff": cfg.n}
    if isinstance(bucket, FusedBucket):
        row.update(cap=cfg.round_cap, adv=ADV_CODES[cfg.adversary],
                   flt=FAULT_CODES[cfg.faults], coin=COIN_CODES[cfg.coin],
                   init=INIT_CODES[cfg.init])
    return row


def lane_cfg(bucket, ops: dict):
    """The lane config view over a dict of (rows,) operand tensors."""
    if isinstance(bucket, FusedBucket):
        return FusedLaneConfig(bucket, ops["f"], ops["win"], ops["neff"], ops["cap"],
                               ops["adv"], ops["flt"], ops["coin"], ops["init"])
    return LaneConfig(bucket, ops["f"], ops["win"], ops["neff"])


def lane_cap(bucket, ops: dict):
    """The round cap per row: bucket-static, or the fused lanes' operand."""
    return ops["cap"] if isinstance(bucket, FusedBucket) else bucket.round_cap


def lane_setup(bucket, ops: dict, iids: torch.Tensor):
    """The one-time per-row work: the initial state (spec §3.1) and the
    adversary and fault setup (spec §3.2, §3.3, §9)."""
    cfg = lane_cfg(bucket, ops)
    key = (ops["k0"], ops["k1"])
    return (state_mod.init_state(cfg, key, iids),
            PadAdversary(cfg).setup(key, iids))


def lane_rounds(bucket, ops: dict, iids, r, st, setup, done, acc=None,
                max_rounds=None):
    """Run rows from their own round counters ``r`` (rows,) until each is
    done, reaches its cap or has run ``max_rounds`` rounds (None: no such
    bound). Finished rows are frozen. Returns ``(r, st, done, acc)``:
    ``done`` is the round count at decision, -1 while undecided; ``acc``
    the (rows, C) counter accumulator when given."""
    cfg = lane_cfg(bucket, ops)
    key = (ops["k0"], ops["k1"])
    cap = lane_cap(bucket, ops)
    adv = PadAdversary(cfg)
    round_body = benor.round_body if bucket.protocol == "benor" else bracha.round_body
    faulty = setup["faulty"]
    k = 0
    while max_rounds is None or k < max_rounds:
        active = (done < 0) & (r < cap)
        if not bool(active.any()):
            break
        obs = {} if acc is not None else None
        new = round_body(cfg, key, iids, r, st, adv, setup, obs=obs)
        st = {name: torch.where(active[:, None], new[name], st[name]) for name in st}
        if acc is not None:
            acc = counters_mod.accumulate(acc, counters_mod.round_increments(cfg, obs),
                                          active, cfg)
        r = r + active.to(r.dtype)
        done = torch.where(active & state_mod.all_correct_decided(st, faulty),
                           r, done)
        k += 1
    return r, st, done, acc


def lane_outcome(bucket, ops: dict, r, st, setup, done):
    """``(rounds, decision, finished)`` per row (spec §1)."""
    cap = lane_cap(bucket, ops)
    decided = done >= 0
    rounds = torch.where(decided, done, torch.zeros_like(done) + cap).to(torch.int32)
    decision = state_mod.extract_decision(st, setup["faulty"], decided)
    return rounds, decision, decided | (r >= cap)


def _run_lanes(bucket, ops: dict, iids: torch.Tensor, counters: bool = False):
    """The lane program: every row from round 0 to its end. Returns
    ``(rounds, decision)`` (rows,), plus the (rows, C) counter rows."""
    st, setup = lane_setup(bucket, ops, iids)
    rows = iids.shape[0]
    r = torch.zeros(rows, dtype=torch.int32, device=iids.device)
    done = torch.full((rows,), -1, dtype=torch.int32, device=iids.device)
    acc = None
    if counters:
        acc = counters_mod.zeros(lane_cfg(bucket, ops), rows, iids.device)
    r, st, done, acc = lane_rounds(bucket, ops, iids, r, st, setup, done, acc)
    rounds, decision, _ = lane_outcome(bucket, ops, r, st, setup, done)
    return (rounds, decision) + ((acc,) if counters else ())


def _key_label(key) -> str:
    """Compact spelling of a cache key for trace events."""
    if isinstance(key, tuple):
        return "/".join(_key_label(k) for k in key)
    lab = getattr(key, "label", None)
    return lab() if callable(lab) else str(key)


class CompileCache:
    """Bounded LRU of built lane programs with the run record's counters
    (compiles, hits, evictions, ``compile_wall_s``). A build binds the
    bucket's static law choices to the lane program; torch compiles nothing,
    so the build wall is the binding's. Lookup and build run under one
    reentrant lock, so ``stats()`` is safe from any thread."""

    def __init__(self, max_entries: int = 32):
        if max_entries < 1:
            raise ValueError("CompileCache needs max_entries >= 1")
        self.max_entries = max_entries
        self._entries: OrderedDict = OrderedDict()
        self._lock = threading.RLock()
        self.compiles = 0
        self.hits = 0
        self.evictions = 0
        self.compile_wall_s = 0.0

    def get(self, key, build):
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
                _metrics.counter("brc_compile_cache_hits_total",
                                 "CompileCache lookups served warm").inc()
                _trace.event("compile_cache.hit", key=_key_label(key))
                return self._entries[key]
            t0 = time.perf_counter()
            fn = build()
            wall = time.perf_counter() - t0
            self.compiles += 1
            self.compile_wall_s += wall
            _metrics.counter("brc_compile_cache_compiles_total",
                             "Program builds (cold CompileCache keys)").inc()
            _trace.event("compile_cache.compile", key=_key_label(key),
                         wall_s=round(wall, 6))
            self._entries[key] = fn
            while len(self._entries) > self.max_entries:
                old_key, _ = self._entries.popitem(last=False)
                self.evictions += 1
                _metrics.counter("brc_compile_cache_evictions_total",
                                 "LRU evictions from the CompileCache").inc()
                _trace.event("compile_cache.evict", key=_key_label(old_key))
            return fn

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        """The run record's ``compile_cache`` block."""
        with self._lock:
            return {
                "compiles": self.compiles,
                "hits": self.hits,
                "evictions": self.evictions,
                "entries": len(self._entries),
                "max_entries": self.max_entries,
                "compile_wall_s": round(self.compile_wall_s, 6),
            }


def compile_cache(backend) -> CompileCache:
    """The backend's bucket-keyed program LRU (created on first use)."""
    cache = getattr(backend, "_bucket_cache", None)
    if cache is None:
        cache = CompileCache()
        backend._bucket_cache = cache
    return cache


def check_lane_kernel(backend, what: str = "batched lanes") -> None:
    """Refuse every kernel but the plain round driver, by name: the lanes
    run the plain driver, and no path switches to it in a kernel's place."""
    if backend.kernel != "plain":
        raise ValueError(
            f"{what} run the plain torch round driver and require "
            f"kernel='plain'; kernel={backend.kernel!r} runs per-config "
            "programs (pass kernel='plain')")


def _floor_pow2(x: int) -> int:
    t = 1
    while t * 2 <= x:
        t <<= 1
    return t


def _chunk_instances(bucket, lanes: int, max_i: int, pairs: int = ROW_PAIRS) -> int:
    """Instances per lane per dispatch: the row budget ``pairs // n_pad``
    divided across the lanes, floored to a power of two, and no larger
    than the next power of two of the longest lane."""
    b = max(1, pairs // max(1, bucket.n_pad) // lanes)
    return min(_floor_pow2(b), lane_tier(max(1, max_i)))


def _op_tensors(rows: list, names, device) -> dict:
    """Per-row operand tensors from a list of host operand dicts."""
    return {k: torch.tensor([row[k] for row in rows], dtype=torch.int64, device=device)
            for k in names}


def _empty_result(cfg, ids):
    from byzantinerandomizedconsensus_tpu_torch.backends.base import SimResult

    return SimResult(config=cfg, inst_ids=ids, rounds=np.empty(0, dtype=np.int32),
                     decision=np.empty(0, dtype=np.uint8))


def _dispatch_and_collect(backend, fn, bucket, cfgs, ids_list, l_pad, chunk, max_i,
                          counters, program=None):
    """The lane-grid executor shared by :func:`run_batch` and
    :func:`run_fused`: each (l_pad, chunk) grid of ids (a lane's tail
    repeats its last id; padding lanes replicate the last config) runs as
    l_pad·chunk rows, every dispatch before one fetch, then per-lane trim."""
    lanes = len(cfgs)
    dev = backend.device
    names = FUSED_OPS if isinstance(bucket, FusedBucket) else STRICT_OPS
    host = [host_op_row(bucket, cfgs[min(i, lanes - 1)]) for i in range(l_pad)]
    ops = {k: v.repeat_interleave(chunk)
           for k, v in _op_tensors(host, names, dev).items()}

    def lane_ids(i):
        ids = ids_list[min(i, lanes - 1)]
        return ids if len(ids) else np.zeros(1, dtype=np.int64)

    pending = []
    with _trace.span("batch.dispatch", lanes=l_pad, chunk=chunk, configs=lanes,
                     program=program, occupancy=round(lanes / l_pad, 4)) as sp:
        for lo in range(0, max_i, chunk):
            grid = np.empty((l_pad, chunk), dtype=np.int64)
            for i in range(l_pad):
                ids = lane_ids(i)
                seg = ids[lo:lo + chunk]
                if len(seg) == 0:
                    seg = ids[-1:]
                if len(seg) < chunk:
                    seg = np.concatenate([seg, np.full(chunk - len(seg), seg[-1])])
                grid[i] = seg
            iids = torch.as_tensor(grid.reshape(-1), dtype=torch.int32).to(dev)
            pending.append(fn(ops, iids, counters))
        sp["dispatches"] = len(pending)
        fetched = [tuple(x.reshape(l_pad, chunk, *x.shape[1:]).cpu().numpy()
                         for x in out) for out in pending]

    results, docs = [], []
    from byzantinerandomizedconsensus_tpu_torch.backends.base import SimResult

    for i, (cfg, ids) in enumerate(zip(cfgs, ids_list)):
        parts = [[], [], []]
        for c, ch in enumerate(fetched):
            take = max(0, min(len(ids) - c * chunk, chunk))
            for j in range(len(ch)):
                if take:
                    parts[j].append(ch[j][i][:take])
        rounds = (np.concatenate(parts[0]).astype(np.int32, copy=False) if parts[0]
                  else np.empty(0, dtype=np.int32))
        decision = (np.concatenate(parts[1]).astype(np.uint8, copy=False) if parts[1]
                    else np.empty(0, dtype=np.uint8))
        results.append(SimResult(config=cfg, inst_ids=ids, rounds=rounds,
                                 decision=decision))
        if counters:
            rows = (np.concatenate(parts[2]) if parts[2]
                    else counters_mod.zeros(cfg, 0).numpy())
            docs.append(counters_mod.counters_doc(
                cfg, counters_mod.finalize(cfg, rows), backend=backend.name))
    return (results, docs) if counters else results


def run_batch(backend, cfgs: Sequence[SimConfig], inst_ids=None, counters: bool = False):
    """Run many configs of ONE shape bucket as lanes on ``backend`` (a
    TorchBackend on ``kernel="plain"``). Returns per-config SimResults,
    bit-identical to ``backend.run`` per lane; with ``counters``,
    ``(results, counters_docs)``, pad-exact (``obs/counters.py``).

    ``inst_ids`` is an optional per-config list of instance-id arrays.
    Raises ``ValueError`` on mixed delivery laws or packing laws
    (``config.validate_batch``) and on configs of different buckets."""
    check_lane_kernel(backend)
    cfgs = validate_batch(cfgs)
    buckets = {ShapeBucket.of(c, counters=counters) for c in cfgs}
    if len(buckets) != 1:
        labels = sorted(b.label() for b in buckets)
        raise ValueError(
            f"batch spans {len(buckets)} shape buckets ({', '.join(labels)}); "
            "run_batch serves one bucket — use run_many to auto-group")
    bucket = next(iter(buckets))
    lanes = len(cfgs)
    l_pad = lane_tier(lanes)
    ids_list = [backend._resolve_inst_ids(c, None if inst_ids is None else inst_ids[i])
                for i, c in enumerate(cfgs)]
    max_i = max((len(i) for i in ids_list), default=0)
    if max_i == 0:
        empty = [_empty_result(c, i) for c, i in zip(cfgs, ids_list)]
        if counters:
            return empty, [counters_mod.counters_doc(
                c, counters_mod.finalize(c, counters_mod.zeros(c, 0)),
                backend=backend.name) for c in cfgs]
        return empty
    chunk = _chunk_instances(bucket, l_pad, max_i)
    cache_key = (bucket, l_pad, chunk)
    fn = compile_cache(backend).get(cache_key, lambda: functools.partial(_run_lanes, bucket))
    return _dispatch_and_collect(backend, fn, bucket, cfgs, ids_list, l_pad, chunk,
                                 max_i, counters,
                                 program=_key_label(cache_key) if _trace.enabled() else None)


def run_many(backend, cfgs: Sequence[SimConfig], inst_ids=None, counters: bool = False,
             progress=None, compaction=None):
    """Group arbitrary configs by shape bucket and run each group as lanes.

    Returns ``(results, report)`` in input order, ``report`` the
    observability block (per-bucket occupancy, the compile-cache stats);
    with ``counters``, ``(results, docs, report)``. ``compaction`` (a
    :class:`~.compaction.CompactionPolicy`) runs each bucket through the
    compacted lane grid instead: every (config, instance) pair of a bucket
    feeds one shared queue, and the report gains the ``compaction`` block."""
    check_lane_kernel(backend)
    cfgs = [c.validate() for c in cfgs]
    groups: OrderedDict = OrderedDict()
    for i, c in enumerate(cfgs):
        groups.setdefault(ShapeBucket.of(c, counters=counters), []).append(i)
    results = [None] * len(cfgs)
    docs = [None] * len(cfgs)
    occupancy = []
    compaction_stats = []
    for bucket, idxs in groups.items():
        if progress is not None:
            progress(f"batch bucket {bucket.label()}: {len(idxs)} config(s)")
        group_ids = None if inst_ids is None else [inst_ids[i] for i in idxs]
        with _trace.span("batch.bucket", bucket=bucket.label(), configs=len(idxs),
                         mode="compacted" if compaction is not None else "bucketed") as sp:
            if compaction is not None:
                from byzantinerandomizedconsensus_tpu_torch.backends import (
                    compaction as _compaction)

                group = [cfgs[i] for i in idxs]
                ids_list = [backend._resolve_inst_ids(
                    c, None if group_ids is None else group_ids[j])
                    for j, c in enumerate(group)]
                group_res, group_docs, stats = _compaction.run_bucket(
                    backend, bucket, group, ids_list, policy=compaction,
                    counters=counters, progress=progress)
                compaction_stats.append(stats)
                sp["lane_tier"] = stats["width"]
                sp["occupancy"] = stats["occupancy"]
                occupancy.append({"bucket": bucket.label(), "configs": len(idxs),
                                  "lane_tier": stats["width"], "compaction": stats})
            else:
                out = run_batch(backend, [cfgs[i] for i in idxs], inst_ids=group_ids,
                                counters=counters)
                group_res, group_docs = out if counters else (out, None)
                sp["lane_tier"] = lane_tier(len(idxs))
                occupancy.append({"bucket": bucket.label(), "configs": len(idxs),
                                  "lane_tier": lane_tier(len(idxs))})
        for j, i in enumerate(idxs):
            results[i] = group_res[j]
            if counters:
                docs[i] = group_docs[j]
    report = {"buckets": len(groups), "configs": len(cfgs), "occupancy": occupancy,
              "compile_cache": compile_cache(backend).stats()}
    if compaction_stats:
        from byzantinerandomizedconsensus_tpu_torch.backends import compaction as _compaction

        report["compaction"] = _compaction.merge_stats(compaction_stats)
    if counters:
        return results, docs, report
    return results, report


def run_grid(backend, cfgs: Sequence[SimConfig], inst_ids=None, progress=None):
    """Lanes through ``run_many`` when ``backend`` (an object or a
    registered name) has them, else a per-config loop. Returns ``(results,
    report_or_None)``."""
    if isinstance(backend, str):
        from byzantinerandomizedconsensus_tpu_torch.backends.base import get_backend

        backend = get_backend(backend)
    if hasattr(backend, "run_many"):
        return run_many(backend, cfgs, inst_ids=inst_ids, progress=progress)
    results = [backend.run(c, None if inst_ids is None else inst_ids[i])
               for i, c in enumerate(cfgs)]
    return results, None


def run_fused(backend, cfgs: Sequence[SimConfig], inst_ids=None, progress=None,
              compaction=None):
    """Run arbitrary configs through fused ``superset`` lanes, grouped only
    by (protocol, delivery, tier, packing law). Bit-identical per lane to
    the per-config path; no counter leg (the counter schema is a static
    function of the fault kind, which is lane data here). Returns
    ``(results, report)``; ``compaction`` runs each fused bucket through
    the compacted lane grid, recycling lanes across configs and instances."""
    check_lane_kernel(backend, "fused lanes")
    cfgs = [c.validate() for c in cfgs]
    groups: OrderedDict = OrderedDict()
    for i, c in enumerate(cfgs):
        groups.setdefault(FusedBucket.of(c), []).append(i)
    results = [None] * len(cfgs)
    occupancy = []
    compaction_stats = []
    cache = compile_cache(backend)
    for bucket, idxs in groups.items():
        if progress is not None:
            progress(f"fused bucket {bucket.label()}: {len(idxs)} config(s)")
        group = [cfgs[i] for i in idxs]
        ids_list = [backend._resolve_inst_ids(
            c, None if inst_ids is None else inst_ids[idxs[j]])
            for j, c in enumerate(group)]
        max_i = max((len(i) for i in ids_list), default=0)
        if max_i == 0:
            for j, i in enumerate(idxs):
                results[i] = _empty_result(group[j], ids_list[j])
            continue
        if compaction is not None:
            from byzantinerandomizedconsensus_tpu_torch.backends import (
                compaction as _compaction)

            with _trace.span("batch.bucket", bucket=bucket.label(), configs=len(idxs),
                             mode="compacted") as sp:
                group_res, _docs, stats = _compaction.run_bucket(
                    backend, bucket, group, ids_list, policy=compaction,
                    counters=False, progress=progress)
                sp["lane_tier"] = stats["width"]
                sp["occupancy"] = stats["occupancy"]
            compaction_stats.append(stats)
            occupancy.append({"bucket": bucket.label(), "configs": len(idxs),
                              "lane_tier": stats["width"], "compaction": stats})
        else:
            l_pad = lane_tier(len(group))
            chunk = _chunk_instances(bucket, l_pad, max_i)
            cache_key = ("fused", bucket, l_pad, chunk)
            fn = cache.get(cache_key, lambda: functools.partial(_run_lanes, bucket))
            with _trace.span("batch.bucket", bucket=bucket.label(), configs=len(idxs),
                             mode="fused", lane_tier=l_pad):
                group_res = _dispatch_and_collect(
                    backend, fn, bucket, group, ids_list, l_pad, chunk, max_i, False,
                    program=_key_label(cache_key) if _trace.enabled() else None)
            occupancy.append({"bucket": bucket.label(), "configs": len(idxs),
                              "lane_tier": l_pad})
        for j, i in enumerate(idxs):
            results[i] = group_res[j]
    report = {"mode": "fused", "buckets": len(groups), "configs": len(cfgs),
              "occupancy": occupancy, "compile_cache": cache.stats()}
    if compaction_stats:
        from byzantinerandomizedconsensus_tpu_torch.backends import compaction as _compaction

        report["compaction"] = _compaction.merge_stats(compaction_stats)
    return results, report
