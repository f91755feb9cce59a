"""Decision-driven lane compaction — continuous batching at the instance axis.

The port's counterpart of the reference ``backends/compaction.py``. A chunk
of the per-config driver makes every instance pay the chunk's largest
rounds-to-decision. The compacted grid instead:

- runs the round loop in short **segments** (``CompactionPolicy.segment``
  rounds per dispatch) over a fixed-width grid of W rows, one instance per
  row, each row carrying its own round counter ``r`` — rows at different
  rounds share one pass (``backends/batch.py::lane_rounds``);
- after each segment fetches only the per-row ``(finished, rounds,
  decision)``; when the retired fraction crosses ``refill_threshold`` (and
  work is queued) it **compacts** the survivors (a row permutation) and
  **refills** the freed rows from the queue;
- once the queue is dry runs the **drain** (segment length = the round
  cap), which stops as soon as the last row finishes.

Bit-identity to the per-config run is the law, and it holds by construction:
the PRF addresses every draw by ``(key, instance, round, step, ...)`` (spec
§2) and a row's round counter is the instance's own round index, so which
row, segment or refill generation an instance lands in enters no draw and
no threshold. Rows carry the bucket's lane operands ``(key, f,
crash_window, n_eff)`` (and the fused lanes' codes and cap), so one set of
programs serves every config of a bucket, and ``run_many`` / ``run_fused``
feed a whole bucket through one shared queue.

A grid's programs (init, refill, segment and drain) are
:class:`~.batch.CompileCache` entries, keyed like the reference's.
:class:`WorkFeed` opens the queue to configs pushed while the grid flies,
spec §11 sessions re-seed their next slot in place at the retire seam, and
:class:`~.lanestate.LaneControl` parks or extracts lanes as
:class:`~.lanestate.LaneRecord` s at segment boundaries.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from byzantinerandomizedconsensus_tpu_torch.backends import lanestate as _lanestate
from byzantinerandomizedconsensus_tpu_torch.backends.batch import (
    FUSED_OPS, STRICT_OPS, FusedBucket, _chunk_instances, _key_label, compile_cache,
    host_op_row, lane_cfg, lane_outcome, lane_rounds, lane_setup, lane_tier)
from byzantinerandomizedconsensus_tpu_torch.obs import counters as counters_mod
from byzantinerandomizedconsensus_tpu_torch.obs import metrics as _metrics
from byzantinerandomizedconsensus_tpu_torch.obs import trace as _trace
from byzantinerandomizedconsensus_tpu_torch.ops import prf


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    """The decision-driven refill law.

    ``width``: lanes resident on device (None = the backend's chunk-sizing
    law for the bucket). Rounded to the next power of two so nearby runs
    share programs.

    ``segment``: rounds per device dispatch between refill opportunities.
    Small segments react faster (retired lanes idle at most ``segment - 1``
    rounds before a refill can reclaim them) but pay more host round-trips.

    ``refill_threshold``: compact + refill when at least this fraction of
    lanes is retired (and pending instances exist). The host always refills
    when the grid is fully drained, whatever the threshold.
    """

    width: Optional[int] = None
    segment: int = 2
    refill_threshold: float = 0.25

    def validate(self) -> "CompactionPolicy":
        if self.width is not None and self.width < 1:
            raise ValueError(f"compaction width={self.width} out of range")
        if self.segment < 1:
            raise ValueError(
                f"compaction segment={self.segment} out of range (>= 1)")
        if not (0.0 < self.refill_threshold <= 1.0):
            raise ValueError(
                f"refill_threshold={self.refill_threshold} out of range "
                "(0 < t <= 1)")
        return self

    @classmethod
    def parse(cls, spec: str) -> "CompactionPolicy":
        """``"width=4096,segment=2,threshold=0.25"`` (any subset; bare "1"
        or "" = defaults) — the CLI/env spelling of the policy."""
        kw: dict = {}
        if spec and spec not in ("1", "default"):
            for part in spec.split(","):
                k, _, v = part.partition("=")
                k = k.strip()
                if k in ("width", "w"):
                    kw["width"] = int(v)
                elif k in ("segment", "seg", "s"):
                    kw["segment"] = int(v)
                elif k in ("threshold", "thr", "t", "refill_threshold"):
                    kw["refill_threshold"] = float(v)
                else:
                    raise ValueError(
                        f"unknown compaction policy field {k!r}; use "
                        "width=/segment=/threshold=")
        return cls(**kw).validate()

    def doc(self) -> dict:
        """The run-record ``policy`` sub-block (obs/record.py schema v1.2)."""
        return {"width": self.width, "segment": self.segment,
                "refill_threshold": self.refill_threshold}


class WorkFeedOverflow(RuntimeError):
    """Raised by :meth:`WorkFeed.push` when a bounded feed is full.

    The named rejection is the backpressure seam: a producer that can
    outdraw the grid gets a typed signal to throttle on instead of growing
    the host queue without bound. Default feeds stay unbounded, so no
    existing caller can see this without opting in via ``max_depth``.
    """


class WorkFeed:
    """Externally-fed work queue for :func:`run_bucket` — the serving seam.

    The offline path hands ``run_bucket`` a closed list of configs; a server
    cannot. A ``WorkFeed`` lets requests arrive *while the lane grid is
    flying*: ``push(cfg)`` from any thread enqueues a config (with an opaque
    ``token`` the retirement callback hands back), ``run_bucket`` splices
    newly arrived items into its host work stream at every segment boundary,
    and freed lanes refill from them exactly like queued offline work —
    placement never enters a draw (spec §2 coordinates), so served results
    stay bit-identical to the offline path.

    Two program-stability rules keep the steady state recompile-free:
    ``run_bucket`` pins the grid width to the policy's lane tier (never
    shrinking to the momentary queue length), and the drain program is
    compiled once at ``round_cap_ceiling`` — ``push`` rejects configs whose
    cap exceeds it, so no late request can mint a new program key.
    """

    def __init__(self, round_cap_ceiling: int = 128,
                 max_depth: int | None = None):
        if round_cap_ceiling < 1:
            raise ValueError(
                f"round_cap_ceiling={round_cap_ceiling} out of range (>= 1)")
        if max_depth is not None and max_depth < 1:
            raise ValueError(
                f"max_depth={max_depth} out of range (>= 1, or None for "
                "unbounded)")
        self.round_cap_ceiling = int(round_cap_ceiling)
        self.max_depth = None if max_depth is None else int(max_depth)
        self._items: list = []
        self._cancelled: list = []
        self._cv = threading.Condition()
        self._closed = False
        self._poked = False
        # Tokens of live sessions (spec §11) that own this feed: a session's
        # future slots materialize at the grid's retire seam, not here, so
        # "queue empty + closed" is NOT "drained" while an owner lives —
        # pull() keeps the stream open until every owner finishes
        # (session_done) or is cancelled.
        self._owner_tokens: list = []

    def _release_owner(self, token) -> None:
        """Drop ``token`` from the live-session owners (identity match,
        idempotent — a cancel and a reap may both report the same death)."""
        self._owner_tokens = [t for t in self._owner_tokens
                              if t is not token]

    def push(self, cfg, ids=None, token=None, force: bool = False,
             session=None) -> None:
        """Enqueue one config (its instances become queued lane work).
        ``ids`` defaults to the config's full instance range; ``token`` is
        returned verbatim to ``on_retire`` when the config completes.
        ``force=True`` bypasses the ``max_depth`` bound (requests admitted
        before this feed existed). ``session=L`` marks the config
        as slot 0 of an L-slot spec-§11 session: the grid re-seeds slots
        1..L-1 in place at its retire seam, ``on_retire`` fires once per
        slot with the same token, and the token owns the feed (it cannot
        report drained) until the last slot retires or the session is
        cancelled."""
        if cfg.round_cap > self.round_cap_ceiling:
            raise ValueError(
                f"round_cap={cfg.round_cap} exceeds the feed ceiling "
                f"{self.round_cap_ceiling}: the drain program is compiled "
                "once per bucket at the ceiling, so admission must reject "
                "or re-route larger caps")
        session = None if session is None or int(session) <= 1 \
            else int(session)
        with self._cv:
            if self._closed:
                raise RuntimeError("push on a closed WorkFeed")
            if not force and self.max_depth is not None and \
                    len(self._items) >= self.max_depth:
                raise WorkFeedOverflow(
                    f"WorkFeed depth {len(self._items)} at max_depth="
                    f"{self.max_depth}: producer must back off until the "
                    "grid drains")
            self._items.append((cfg, ids, token, session))
            if session is not None:
                self._owner_tokens.append(token)
            self._cv.notify_all()

    def close(self) -> None:
        """No more pushes; run_bucket drains what remains and returns."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def closed(self) -> bool:
        return self._closed

    def pending(self) -> int:
        """Configs pushed but not yet pulled into the grid — the queue-depth
        probe the serving stats and the fleet dispatcher's steal heuristic
        read."""
        with self._cv:
            return len(self._items)

    def cancel(self, token) -> bool:
        """Mark ``token``'s work dead (the cancellation seam).

        Items still queued in the feed are removed here, synchronously —
        they never reach a lane. Items already pulled into a flying grid
        are reclaimed by :func:`run_bucket` at its next segment boundary:
        the lane is dropped from the host bookkeeping (no result is ever
        recorded, ``on_retire`` never fires) and freed at the next
        compaction refill. Returns True when the token was still queued
        here (the cheap case); False means the grid owns it now — or never
        saw it — and the boundary reap is the reclaim path. Survivors are
        bit-identical either way: lane placement never enters a draw.

        Session ownership is released **only** for a session still queued
        here (it died before its first slot reached a lane); a session
        already flying keeps owning the feed until :func:`run_bucket`'s
        boundary reap reports its death via :meth:`session_done`. The
        edge case this ordering fixes: cancelling the last queued
        config of a session-owned feed empties the queue, but must NOT make
        a closed feed report drained (``pull() -> None``) while a different
        session's future slots are still due from the grid — that would
        close the feed out from under the dispatcher mid-session.
        """
        with self._cv:
            n = len(self._items)
            kept = []
            for it in self._items:
                if it[2] is token:
                    if it[3] is not None:
                        self._release_owner(token)
                else:
                    kept.append(it)
            self._items = kept
            self._cancelled.append(token)
            self._cv.notify_all()
            return len(self._items) < n

    def pop_cancelled(self) -> list:
        """Drain the cancel marks since the last call — run_bucket's
        segment-boundary reap reads them (tokens, verbatim)."""
        with self._cv:
            out = self._cancelled
            self._cancelled = []
            return out

    def sessions(self) -> int:
        """Live sessions owning this feed (queued or flying) — the serving
        stats probe."""
        with self._cv:
            return len(self._owner_tokens)

    def session_done(self, token) -> None:
        """Release ``token``'s session ownership — :func:`run_bucket` calls
        this when the session's last slot retires (or its lanes are reaped
        after a cancel), letting a closed feed finally report drained."""
        with self._cv:
            self._release_owner(token)
            self._cv.notify_all()

    def poke(self) -> None:
        """Wake a grid parked in a blocking :meth:`pull` without enqueuing
        work: the next blocking pull returns ``[]`` once so
        ``run_bucket`` reaches its segment boundary and services any
        pending :class:`~.lanestate.LaneControl` request (park/extract)."""
        with self._cv:
            self._poked = True
            self._cv.notify_all()

    def pull(self, block: bool = False):
        """Everything pushed since the last pull: a list of
        ``(cfg, ids, token, session)`` items, ``[]`` when nothing is
        pending, or ``None`` once the feed is closed *and* drained.
        ``block=True`` waits for items, close, or a :meth:`poke` — the idle
        server parks here. A feed owned by a live session is never drained:
        its future slots materialize at the grid's retire seam, so pull
        keeps the stream open (returns ``[]`` / keeps waiting) until every
        owner retires its last slot or is cancelled."""
        with self._cv:
            while block and not self._items and not self._poked and not (
                    self._closed and not self._owner_tokens):
                self._cv.wait()
            self._poked = False
            if not self._items:
                return (None if self._closed and not self._owner_tokens
                        else [])
            out = self._items
            self._items = []
            return out


def setup_leaves(setup: dict) -> list:
    """The setup dict's leaves in sorted-key order, nested dicts flattened
    in place (the ``LaneRecord`` layout): ``crash_round``, the §9
    schedule's arrays by name (``faults``, if any), then ``faulty``."""
    out = []
    for k in sorted(setup):
        v = setup[k]
        if isinstance(v, dict):
            out += [v[j] for j in sorted(v)]
        elif v is not None:
            out.append(v)
    return out


def acc_to_words(acc) -> np.ndarray:
    """(rows, C) int64 counter rows → the record's (rows, C, 2) u32 (lo, hi)."""
    acc = np.asarray(acc, dtype=np.int64)
    return np.stack([acc & prf.MASK32, acc >> 32], axis=-1).astype(np.uint32)


def acc_from_words(words) -> np.ndarray:
    """The record's (rows, C, 2) u32 (lo, hi) pairs → (rows, C) int64."""
    w = np.asarray(words, dtype=np.int64)
    return w[..., 0] + (w[..., 1] << 32)


def _merge(old, new, fn):
    """Apply ``fn(old_tensor, new_tensor)`` over matching carry entries."""
    if isinstance(old, dict):
        return {k: _merge(old[k], new[k], fn) for k in old}
    if old is None:
        return None
    return fn(old, new)


def _make_init(bucket, counters: bool):
    """The grid-fill program: ``init(ops, iids, n_fill) -> carry``, the
    carry a dict of W-row tensors; rows at index ``>= n_fill`` start
    retired (``done = 0``), so no segment runs them."""

    def init(ops, iids, n_fill):
        W, dev = iids.shape[0], iids.device
        st, setup = lane_setup(bucket, ops, iids)
        live = torch.arange(W, device=dev) < n_fill
        return {"ops": ops, "iids": iids,
                "r": torch.zeros(W, dtype=torch.int32, device=dev),
                "st": st, "setup": setup,
                "done": torch.where(live, -1, 0).to(torch.int32),
                "acc": (counters_mod.zeros(lane_cfg(bucket, ops), W, dev)
                        if counters else None)}

    return init


def _make_refill(bucket, F: int, counters: bool):
    """The compaction program: ``refill(perm, n_keep, n_fill, ops_block,
    iids_block, carry) -> carry'``. Row ``i < n_keep`` takes old row
    ``perm[i]`` (survivors first); row ``n_keep + j`` takes row ``j`` of the
    fresh ``F``-row block (live for ``j < n_fill``, retired otherwise)."""
    init = _make_init(bucket, counters)

    def refill(perm, n_keep, n_fill, ops_block, iids_block, carry):
        W = perm.shape[0]
        idx = torch.arange(W, device=perm.device)
        keep = idx < n_keep
        src_new = torch.clamp(idx - n_keep, 0, F - 1)
        fresh = init(ops_block, iids_block, n_fill)

        def pick(old, new):
            k = keep.view((W,) + (1,) * (old.dim() - 1))
            return torch.where(k, old[perm], new[src_new])

        out = _merge(carry, fresh, pick)
        out["done"] = torch.where(keep, carry["done"][perm],
                                  torch.where(idx - n_keep < n_fill, -1, 0).to(torch.int32))
        return out

    return refill


def _make_segment(bucket, seg: int, counters: bool):
    """The hot program: up to ``seg`` rounds per row, finished rows frozen.
    ``segment(carry) -> (carry', rounds, decision, finished)``."""

    def segment(carry):
        ops, iids, setup = carry["ops"], carry["iids"], carry["setup"]
        r, st, done, acc = lane_rounds(bucket, ops, iids, carry["r"], carry["st"],
                                       setup, carry["done"], carry["acc"],
                                       max_rounds=seg)
        rounds, decision, finished = lane_outcome(bucket, ops, r, st, setup, done)
        return dict(carry, r=r, st=st, done=done, acc=acc), rounds, decision, finished

    return segment


def run_bucket(backend, bucket, cfgs, ids_list, policy=None, counters: bool = False,
               progress=None, feed=None, on_retire=None, control=None, imports=None):
    """Run every instance of every config of ONE bucket through the
    compacted lane grid. Returns ``(results, docs_or_None, stats)``:
    per-config SimResults bit-identical to the per-config path, and the run
    record's ``compaction`` block (occupancy, wasted lane-rounds, segments,
    refills).

    ``feed`` (a :class:`WorkFeed`) opens the queue: configs pushed from other
    threads join the work stream at segment boundaries; the grid width is
    then pinned to the policy tier and the drain length to the feed's cap
    ceiling, so the steady state builds nothing new. ``on_retire(token,
    SimResult)`` fires the moment a config's last instance retires (tokens
    of the initial ``cfgs`` are their list indices). Feed items pushed with
    ``session=L`` (spec §11) re-seed their next slot in place at the retire
    seam (``models/session.py::next_slot_config``).

    ``control`` (a :class:`~.lanestate.LaneControl`) services **park**
    (export every extractable config as LaneRecords and return) and
    **extract** (export the named tokens, keep flying) at every segment
    boundary; sessions are never extractable. ``imports`` is a list of
    LaneRecords (from this package or the reference): their pending
    instances re-enter the work stream, and their mid-round lanes are
    spliced back over the rows the ordinary init or refill placed them in.
    """
    from byzantinerandomizedconsensus_tpu_torch.backends.base import SimResult
    from byzantinerandomizedconsensus_tpu_torch.models import session as _session_mod

    policy = (policy or CompactionPolicy()).validate()
    if counters and isinstance(bucket, FusedBucket):
        raise counters_mod.CountersUnsupported(
            "fused compacted lanes have no counter leg: the counter schema "
            "is a static function of the fault kind, which is lane data here")
    if counters and feed is not None:
        raise counters_mod.CountersUnsupported(
            "the externally-fed lane grid has no counter leg: replies carry "
            "(rounds, decision) only")
    dev = backend.device
    op_names = FUSED_OPS if isinstance(bucket, FusedBucket) else STRICT_OPS

    cfgs = list(cfgs)
    ids_list = list(ids_list)
    tokens = list(range(len(cfgs)))
    remaining = [len(ids) for ids in ids_list]
    rounds_out = [np.zeros(len(ids), dtype=np.int32) for ids in ids_list]
    dec_out = [np.zeros(len(ids), dtype=np.uint8) for ids in ids_list]
    total = sum(remaining)
    sess_left = [1] * len(cfgs)
    sess_slot = [0] * len(cfgs)
    sess_owner = [False] * len(cfgs)

    # The shared work stream: (config index, row position, instance id),
    # configs in input order, with a head pointer. Queue order enters no draw.
    work_cfg = np.concatenate([np.full(len(ids), ci, dtype=np.int64)
                               for ci, ids in enumerate(ids_list)] or [np.empty(0, np.int64)])
    work_pos = np.concatenate([np.arange(len(ids), dtype=np.int64)
                               for ids in ids_list] or [np.empty(0, np.int64)])
    work_iid = np.concatenate([np.asarray(ids, dtype=np.int64)
                               for ids in ids_list] or [np.empty(0, np.int64)])
    op_rows = [host_op_row(bucket, c) for c in cfgs]

    def add_config(cfg, ids, token, session=None, rounds=None, decision=None,
                   pending=None):
        """Book one more config; its stream entries are ``pending`` (pos,
        iid) pairs (default every instance)."""
        nonlocal work_cfg, work_pos, work_iid, total
        ci = len(cfgs)
        cfgs.append(cfg)
        ids_list.append(ids)
        tokens.append(token if token is not None else ci)
        rounds_out.append(np.zeros(len(ids), dtype=np.int32) if rounds is None
                          else np.array(rounds, dtype=np.int32))
        dec_out.append(np.zeros(len(ids), dtype=np.uint8) if decision is None
                       else np.array(decision, dtype=np.uint8))
        sess_left.append(int(session) if session else 1)
        sess_slot.append(0)
        sess_owner.append(session is not None)
        op_rows.append(host_op_row(bucket, cfg))
        if pending is None:
            pos = np.arange(len(ids), dtype=np.int64)
            iid = np.asarray(ids, dtype=np.int64)
        else:
            pos, iid = pending
        remaining.append(len(pos))
        work_cfg = np.concatenate([work_cfg, np.full(len(pos), ci, dtype=np.int64)])
        work_pos = np.concatenate([work_pos, pos])
        work_iid = np.concatenate([work_iid, iid])
        total += len(pos)
        return ci

    # Restore: imported records join the books like configs; their pending
    # instances and their mid-round lanes enter the work stream, the lanes
    # flagged in ``restore_map`` so the host splices the saved rows in right
    # after init or refill places them.
    restore_map: dict = {}
    restored_lanes = 0
    import_entries: list = []
    for rec in (imports or []):
        if rec.version != _lanestate.LANESTATE_VERSION:
            raise _lanestate.LaneStateVersionError(
                f"lanestate version {rec.version!r} (this build speaks "
                f"{_lanestate.LANESTATE_VERSION})")
        ids = np.asarray(rec.ids, dtype=np.int64)
        lane_pos = np.asarray(rec.lanes["pos"], dtype=np.int64)
        pend = list(rec.pending)
        pos_new = np.concatenate([lane_pos, np.asarray([p for p, _ in pend], dtype=np.int64)])
        iid_new = np.concatenate([ids[lane_pos], np.asarray([i for _, i in pend], dtype=np.int64)])
        ci = add_config(rec.cfg.validate(), ids, rec.token, rounds=rec.rounds,
                        decision=rec.decision, pending=(pos_new, iid_new))
        for j, p in enumerate(lane_pos):
            restore_map[(ci, int(p))] = (rec, j)
        import_entries.append((ci, rec))
        _trace.event("compaction.import", cfg_index=ci, **rec.doc_summary())

    def _ingest(block=False):
        """Splice newly arrived feed items into the work stream. Returns
        False once the feed is closed and drained."""
        items = feed.pull(block=block)
        if items is None:
            return False
        for cfg, ids, token, session in items:
            cfg = cfg.validate()
            ids = (np.asarray(backend._resolve_inst_ids(cfg, None)) if ids is None
                   else np.asarray(ids, dtype=np.int64))
            ci = add_config(cfg, ids, token, session=session)
            if len(ids) == 0:
                # Nothing to run, so nothing to chain: reply once.
                if on_retire is not None:
                    on_retire(tokens[ci], SimResult(config=cfg, inst_ids=ids,
                                                    rounds=rounds_out[ci],
                                                    decision=dec_out[ci]))
                if sess_owner[ci]:
                    feed.session_done(tokens[ci])
        return True

    if feed is not None:
        _ingest(block=total == 0)

    head = 0
    if total == 0:
        results = [SimResult(config=c, inst_ids=i, rounds=np.empty(0, dtype=np.int32),
                             decision=np.empty(0, dtype=np.uint8))
                   for c, i in zip(cfgs, ids_list)]
        docs = None
        if counters:
            docs = [counters_mod.counters_doc(c, counters_mod.finalize(
                c, counters_mod.zeros(c, 0)), backend=backend.name) for c in cfgs]
        if control is not None:
            control.detach()
        return results, docs, {"width": 0, "segments": 0, "refills": 0, "parks": 0,
                               "parked_exit": False, "exported_cfgs": 0,
                               "exported_lanes": 0, "restored_lanes": 0,
                               "device_lane_rounds": 0, "useful_lane_rounds": 0,
                               "occupancy": None, "wasted_lane_fraction": None,
                               "policy": policy.doc()}

    n_counters = len(counters_mod.counter_names(cfgs[0])) if counters else 0
    acc_out = ([np.zeros((len(ids), n_counters), dtype=np.int64) for ids in ids_list]
               if counters else None)
    if counters:
        for ci, rec in import_entries:
            if rec.acc_done is not None:
                acc_out[ci][:] = acc_from_words(rec.acc_done)

    base = policy.width or _chunk_instances(bucket, 1, total)
    # A feed pins W to the policy tier, so arrivals never mint a new
    # program key; offline the grid shrinks to the work.
    W = lane_tier(base) if feed is not None else min(lane_tier(base), lane_tier(total))
    cache = compile_cache(backend)
    seg = policy.segment
    drain_seg = (max(seg, feed.round_cap_ceiling) if feed is not None
                 else max(seg, max(int(c.round_cap) for c in cfgs)))

    def init_program():
        return cache.get(("compact-init", bucket, W, counters),
                         lambda: _make_init(bucket, counters))

    def refill_program(F):
        return cache.get(("compact-refill", bucket, W, F, counters),
                         lambda: _make_refill(bucket, F, counters))

    def segment_program(seg_len):
        return cache.get(("compact-seg", bucket, W, seg_len, counters),
                         lambda: _make_segment(bucket, seg_len, counters))

    if _trace.enabled():
        lab_init = _key_label(("compact-init", bucket, W, counters))
        lab_refill = _key_label(("compact-refill", bucket, W, W, counters))
        lab_seg = _key_label(("compact-seg", bucket, W, seg, counters))
        lab_drain = _key_label(("compact-seg", bucket, W, drain_seg, counters))
    else:
        lab_init = lab_refill = lab_seg = lab_drain = None

    def block(take, F):
        """The (ops, iids) block of F rows: the next ``take`` stream items,
        padded with repeats of config 0 (inert: ``n_fill`` gates them)."""
        src = np.zeros(F, dtype=np.int64)
        src[:take] = work_cfg[head:head + take]
        iids = np.zeros(F, dtype=np.int64)
        iids[:take] = work_iid[head:head + take]
        ops = {k: torch.as_tensor(np.asarray([row[k] for row in op_rows],
                                             dtype=np.int64)[src], device=dev)
               for k in op_names}
        return ops, torch.as_tensor(iids, dtype=torch.int32, device=dev)

    owner_cfg = np.full(W, -1, dtype=np.int64)   # -1 = row not live
    owner_pos = np.zeros(W, dtype=np.int64)
    prev_r = np.zeros(W, dtype=np.int64)
    segments = refills = 0
    device_rounds = useful_rounds = 0
    dead: set = set()
    cancelled_lanes = 0
    session_reseeds = 0

    def _reap() -> bool:
        """Process ``feed.cancel()`` marks at the segment boundary. True
        when any row or queued entry was reclaimed."""
        nonlocal work_cfg, work_pos, work_iid, total, cancelled_lanes
        changed = False
        for token in feed.pop_cancelled():
            for ci, t in enumerate(tokens):
                if t is not token or ci in dead:
                    continue
                dead.add(ci)
                tail = work_cfg[head:]
                keep = tail != ci
                dropped = int((~keep).sum())
                if dropped:
                    work_cfg = np.concatenate([work_cfg[:head], tail[keep]])
                    work_pos = np.concatenate([work_pos[:head], work_pos[head:][keep]])
                    work_iid = np.concatenate([work_iid[:head], work_iid[head:][keep]])
                    total -= dropped
                lanes = int((owner_cfg == ci).sum())
                cancelled_lanes += lanes
                owner_cfg[owner_cfg == ci] = -1
                changed = True
                if sess_owner[ci]:
                    feed.session_done(tokens[ci])
                _trace.event("compaction.cancel", cfg_index=ci, lanes=lanes,
                             queued_dropped=dropped)
        return changed

    def _chain_slot(ci: int) -> None:
        """Spec §11: slot ``ci`` retired with slots still owed, so its next
        slot (same config, chained seed) joins the work stream in place."""
        nonlocal session_reseeds
        nxt = _session_mod.next_slot_config(cfgs[ci], sess_slot[ci], dec_out[ci])
        cj = add_config(nxt, ids_list[ci], tokens[ci])
        sess_left[cj] = sess_left[ci] - 1
        sess_slot[cj] = sess_slot[ci] + 1
        sess_owner[cj] = sess_owner[ci]
        session_reseeds += 1
        _trace.event("compaction.reseed", cfg_index=cj, slot=sess_slot[cj],
                     slots_left=sess_left[cj], lanes=len(ids_list[ci]))
        if _metrics.enabled():
            _metrics.counter("brc_session_reseeds_total",
                             "In-grid session slot re-seeds at the retire seam "
                             "(spec §11)").inc()

    parked_cis: set = set()
    exported_lanes = 0
    parks = 0

    def _restore_rows(carry, placed):
        """Splice saved rows over freshly placed ones (the restore half)."""
        nonlocal restored_lanes
        rows = []
        for w in placed:
            key = (int(owner_cfg[w]), int(owner_pos[w]))
            if key in restore_map:
                rows.append((w,) + restore_map.pop(key))
        if not rows:
            return carry
        with _trace.span("compaction.restore", lanes=len(rows)):
            leaves = setup_leaves(carry["setup"])
            for w, rec, j in rows:
                carry["r"][w] = int(rec.lanes["r"][j])
                for k, v in carry["st"].items():
                    v[w] = torch.as_tensor(np.asarray(rec.lanes["st"][k][j])).to(v.dtype)
                for li, leaf in enumerate(leaves):
                    leaf[w] = torch.as_tensor(np.asarray(rec.lanes["setup"][li][j])).to(leaf.dtype)
                carry["done"][w] = -1
                if counters and rec.lanes.get("acc") is not None:
                    carry["acc"][w] = torch.as_tensor(acc_from_words(rec.lanes["acc"][j]))
                prev_r[w] = int(rec.lanes["r"][j])
        restored_lanes += len(rows)
        return carry

    def _export(tokens_req=None) -> list:
        """Export every extractable config (or ``tokens_req``'s, by
        identity) as LaneRecords and drop it from the grid's books."""
        nonlocal work_cfg, work_pos, work_iid, total, exported_lanes
        cis = []
        for ci in range(len(cfgs)):
            if ci in dead or ci in parked_cis or remaining[ci] <= 0:
                continue
            if sess_owner[ci] or sess_left[ci] > 1 or sess_slot[ci] > 0:
                continue  # spec §11 sessions ride one grid whole
            if tokens_req is not None and not any(tokens[ci] is t for t in tokens_req):
                continue
            cis.append(ci)
        if not cis:
            return []
        records = []
        with _trace.span("compaction.snapshot", configs=len(cis)) as sp:
            host = None
            if any((owner_cfg == ci).any() for ci in cis):
                host = {"r": carry["r"].cpu().numpy(),
                        "st": {k: v.cpu().numpy() for k, v in carry["st"].items()},
                        "setup": [x.cpu().numpy() for x in setup_leaves(carry["setup"])],
                        "acc": None if carry["acc"] is None else carry["acc"].cpu().numpy()}
            for ci in cis:
                sel = owner_cfg == ci
                n_l = int(sel.sum())
                if n_l:
                    lanes = {"pos": owner_pos[sel].copy(), "r": host["r"][sel],
                             "st": {k: v[sel] for k, v in host["st"].items()},
                             "setup": [leaf[sel] for leaf in host["setup"]]}
                    if counters:
                        lanes["acc"] = acc_to_words(host["acc"][sel])
                else:
                    lanes = {"pos": np.empty(0, dtype=np.int64),
                             "r": np.empty(0, dtype=np.int32), "st": {}, "setup": []}
                tail = work_cfg[head:]
                mask = tail == ci
                pend = list(zip(work_pos[head:][mask].tolist(), work_iid[head:][mask].tolist()))
                if mask.any():
                    keep = ~mask
                    work_cfg = np.concatenate([work_cfg[:head], tail[keep]])
                    work_pos = np.concatenate([work_pos[:head], work_pos[head:][keep]])
                    work_iid = np.concatenate([work_iid[:head], work_iid[head:][keep]])
                    total -= int(mask.sum())
                records.append(_lanestate.LaneRecord(
                    version=_lanestate.LANESTATE_VERSION, cfg=cfgs[ci],
                    ids=np.asarray(ids_list[ci], dtype=np.uint32),
                    rounds=rounds_out[ci].copy(), decision=dec_out[ci].copy(),
                    remaining=len(pend) + n_l, pending=pend, lanes=lanes,
                    token=tokens[ci],
                    acc_done=acc_to_words(acc_out[ci]) if counters else None))
                parked_cis.add(ci)
                owner_cfg[sel] = -1
                exported_lanes += n_l
            sp["lanes"] = sum(r.lane_count() for r in records)
            sp["pending"] = sum(len(r.pending) for r in records)
        return records

    def _service_control() -> bool:
        """Drain the control mailbox at this boundary. True = a park
        emptied the grid, so run_bucket returns now."""
        nonlocal parks
        stop = False
        while True:
            req = control._pop_request()
            if req is None:
                return stop
            recs = _export(req.tokens)
            if req.kind == "park":
                parks += 1
                control._deliver_park(req, recs)
                if not (owner_cfg >= 0).any():
                    stop = True
            else:
                req.deliver(recs)

    take = min(W, total)
    with _trace.span("compaction.init", width=W, fill=take, queued=total - take,
                     program=lab_init):
        ops_b, iids_b = block(take, W)
        carry = init_program()(ops_b, iids_b, take)
    owner_cfg[:take] = work_cfg[:take]
    owner_pos[:take] = work_pos[:take]
    head = take
    carry = _restore_rows(carry, range(take))

    parked_exit = False
    while True:
        drain = head >= total and (feed is None or feed.closed())
        with _trace.span("compaction.drain" if drain else "compaction.segment",
                         width=W, queued=total - head,
                         program=lab_drain if drain else lab_seg) as sp:
            carry, rounds_t, dec_t, fin_t = segment_program(drain_seg if drain else seg)(carry)
            r_h = carry["r"].cpu().numpy().astype(np.int64)
            rounds_h = rounds_t.cpu().numpy()
            dec_h = dec_t.cpu().numpy()
            fin_h = fin_t.cpu().numpy()
            segments += 1
            trips = r_h - prev_r
            device_rounds += int(trips.max()) * W
            useful_rounds += int(trips.sum())
            prev_r = r_h
            retire = fin_h.astype(bool) & (owner_cfg >= 0)
            acc_h = carry["acc"].cpu().numpy() if counters and retire.any() else None
            for ci in np.unique(owner_cfg[retire]):
                ci = int(ci)
                if ci in dead:
                    continue  # cancelled: reclaim silently, never record
                sel = retire & (owner_cfg == ci)
                rows = owner_pos[sel]
                rounds_out[ci][rows] = rounds_h[sel]
                dec_out[ci][rows] = dec_h[sel]
                if counters:
                    acc_out[ci][rows] = acc_h[sel]
                remaining[ci] -= int(sel.sum())
                if remaining[ci] == 0:
                    if on_retire is not None:
                        on_retire(tokens[ci], SimResult(
                            config=cfgs[ci], inst_ids=ids_list[ci],
                            rounds=rounds_out[ci], decision=dec_out[ci]))
                    if sess_left[ci] > 1:
                        _chain_slot(ci)
                    elif sess_owner[ci] and feed is not None:
                        feed.session_done(tokens[ci])
            owner_cfg[retire] = -1
            live = owner_cfg >= 0
            free = W - int(live.sum())
            sp["trip_max"] = int(trips.max())
            sp["useful_trips"] = int(trips.sum())
            sp["retired"] = int(retire.sum())
            sp["live"] = W - free
        if _metrics.enabled():
            _metrics.counter("brc_compaction_segments_total",
                             "Segment dispatches across all grids").inc()
            _metrics.gauge("brc_compaction_live_lanes",
                           "Lanes holding live instances after the last "
                           "segment").set(W - free)
            if device_rounds:
                _metrics.gauge("brc_compaction_occupancy",
                               "Cumulative useful/device lane-round "
                               "ratio").set(round(useful_rounds / device_rounds, 6))
            n_ret = int(retire.sum())
            if n_ret:
                _metrics.histogram(
                    "brc_consensus_rounds",
                    "Ben-Or rounds to decision per retired instance",
                    buckets=_metrics.ROUNDS_BUCKETS).observe_many(
                        rounds_h[retire].tolist())
                decided = int((dec_h[retire] != 2).sum())
                if decided:
                    _metrics.counter("brc_consensus_decided_total",
                                     "Instances retired with a decision").inc(decided)
                if n_ret - decided:
                    _metrics.counter("brc_consensus_undecided_total",
                                     "Instances retired undecided at "
                                     "round_cap").inc(n_ret - decided)
        if progress is not None:
            progress(f"compaction segment {segments}: {W - free}/{W} live, "
                     f"{total - head} queued")
        if feed is not None:
            _ingest()
            if _reap():
                live = owner_cfg >= 0
                free = W - int(live.sum())
        if control is not None:
            if _service_control():
                parked_exit = True
                break
            live = owner_cfg >= 0
            free = W - int(live.sum())
        if head >= total and not live.any():
            if feed is None or not _ingest(block=True):
                break
        if head >= total:
            continue  # queue dry: drain the stragglers, no more refills
        if free >= W * policy.refill_threshold or not live.any():
            with _trace.span("compaction.refill", width=W, program=lab_refill) as sp:
                perm = np.concatenate([np.flatnonzero(live), np.flatnonzero(~live)])
                n_keep = W - free
                take = min(free, total - head)
                ops_b, iids_b = block(take, W)
                carry = refill_program(W)(torch.as_tensor(perm, device=dev), n_keep, take,
                                          ops_b, iids_b, carry)
                owner_cfg = np.concatenate([owner_cfg[perm[:n_keep]],
                                            np.full(free, -1, dtype=np.int64)])
                owner_pos = np.concatenate([owner_pos[perm[:n_keep]],
                                            np.zeros(free, dtype=np.int64)])
                prev_r = np.concatenate([prev_r[perm[:n_keep]], np.zeros(free, dtype=np.int64)])
                sl = slice(n_keep, n_keep + take)
                owner_cfg[sl] = work_cfg[head:head + take]
                owner_pos[sl] = work_pos[head:head + take]
                head += take
                refills += 1
                sp["keep"] = n_keep
                sp["take"] = take
                sp["queued"] = total - head
            carry = _restore_rows(carry, range(n_keep, n_keep + take))
            if _metrics.enabled():
                _metrics.counter("brc_compaction_refills_total",
                                 "Compaction+refill dispatches").inc()
                _metrics.gauge("brc_compaction_refill_depth",
                               "Work-stream items still queued after the "
                               "last refill").set(total - head)

    if control is not None:
        control.detach()

    results = [SimResult(config=c, inst_ids=i, rounds=r, decision=d)
               for c, i, r, d in zip(cfgs, ids_list, rounds_out, dec_out)]
    docs = None
    if counters:
        docs = [counters_mod.counters_doc(c, counters_mod.finalize(c, rows),
                                          backend=backend.name)
                for c, rows in zip(cfgs, acc_out)]
        if _metrics.enabled():
            silenced = sum(int(v) for d in docs for k, v in d["totals"].items()
                           if k.startswith("fault_silenced@"))
            if silenced:
                _metrics.counter("brc_consensus_fault_silenced_total",
                                 "Messages silenced by faulty senders "
                                 "(schema-v2 counter totals)").inc(silenced)
    stats = {
        "width": W,
        "segments": segments,
        "refills": refills,
        "cancelled_cfgs": len(dead),
        "cancelled_lanes": cancelled_lanes,
        "session_reseeds": session_reseeds,
        "parks": parks,
        "parked_exit": parked_exit,
        "exported_cfgs": len(parked_cis),
        "exported_lanes": exported_lanes,
        "restored_lanes": restored_lanes,
        "device_lane_rounds": device_rounds,
        "useful_lane_rounds": useful_rounds,
        "occupancy": round(useful_rounds / device_rounds, 4) if device_rounds else None,
        "wasted_lane_fraction": (round(1.0 - useful_rounds / device_rounds, 4)
                                 if device_rounds else None),
        "policy": policy.doc(),
    }
    return results, docs, stats


def merge_stats(per_bucket: Sequence[dict]) -> dict:
    """Fold per-bucket compaction stats into the run record's one
    ``compaction`` block."""
    dev = sum(s["device_lane_rounds"] for s in per_bucket)
    use = sum(s["useful_lane_rounds"] for s in per_bucket)
    return {
        "buckets": len(per_bucket),
        "segments": sum(s["segments"] for s in per_bucket),
        "refills": sum(s["refills"] for s in per_bucket),
        "device_lane_rounds": dev,
        "useful_lane_rounds": use,
        "occupancy": round(use / dev, 4) if dev else None,
        "wasted_lane_fraction": round(1.0 - use / dev, 4) if dev else None,
        "policy": per_bucket[0]["policy"] if per_bucket else None,
    }
