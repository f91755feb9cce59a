"""Metrics-driven fleet autoscaler: elastic serving.

The port's copy of the reference ``serve/autoscale.py``, unchanged in law.

A small control loop over the fleet's own observability plane: each tick
reads the dispatcher's counters (``FleetServer.stats(live=False)`` — cheap,
no worker RPC) and, when the metrics registry is live, the queue-wait p99
from the ``brc_serve_queue_wait_seconds`` histogram, then decides between
three actions:

``up``
    sustained backlog pressure (outstanding admissions per routable
    worker >= ``up_per_worker`` for ``up_ticks`` consecutive ticks, or the
    queue-wait p99 over ``p99_slo_s``) spawns one worker through the same
    ladder ``--workers N`` uses (:meth:`FleetServer.scale_up`) — the
    newcomer pays its warm-up (its kernel libraries load once in its
    process, exempt from the steady-state pin like any cold worker) and
    then serves.
``down``
    sustained idleness (pressure <= ``down_per_worker`` for ``down_ticks``
    ticks) retires the least-loaded worker gracefully
    (:meth:`FleetServer.scale_down`): it stops taking new work, drains its
    in-flight rotations, re-dispatches queued orphans to survivors — the
    worker-loss re-admission path, minus the loss — and exits through the
    clean shutdown handshake. Replies stay bit-identical because *where* a
    config runs never enters the PRF draws.
``hold``
    everything else: inside the deadband, inside the post-action
    ``cooldown_s``, or at a ``min_workers``/``max_workers`` bound.

Hysteresis is deliberate and asymmetric — scale-up needs a short streak
(flash crowds should be answered in a tick or two), scale-down a long one
plus the cooldown, so an adversarial on/off load (the ``flash_crowd``
scenario) cannot flap the fleet. Every decision is observable:
``autoscale.up`` / ``autoscale.down`` trace events, the
``brc_autoscale_target_workers`` gauge, and ``brc_autoscale_up_total`` /
``brc_autoscale_down_total`` counters.

The loop itself is a daemon thread (``start()``/``stop()``), but every
decision lives in :meth:`Autoscaler.tick` — pure with respect to the
injected clock — so tests drive it deterministically without sleeping.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..obs import metrics as _metrics
from ..obs import trace as _trace


class Autoscaler:
    """Scale a :class:`~byzantinerandomizedconsensus_tpu_torch.serve
    .fleet.FleetServer` between ``min_workers`` and ``max_workers`` on observed
    load. See the module docstring for the control law."""

    def __init__(self, fleet, min_workers: int = 1, max_workers: int = 4,
                 interval_s: float = 0.25,
                 up_per_worker: float = 4.0,
                 down_per_worker: float = 0.5,
                 up_ticks: int = 2, down_ticks: int = 8,
                 cooldown_s: float = 1.0,
                 p99_slo_s: Optional[float] = None,
                 clock=time.monotonic):
        if not (1 <= min_workers <= max_workers):
            raise ValueError(
                f"need 1 <= min_workers <= max_workers, got "
                f"{min_workers}..{max_workers}")
        if up_per_worker <= down_per_worker:
            raise ValueError(
                "up_per_worker must exceed down_per_worker (the deadband "
                "is the flap guard)")
        self.fleet = fleet
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.interval_s = float(interval_s)
        self.up_per_worker = float(up_per_worker)
        self.down_per_worker = float(down_per_worker)
        self.up_ticks = int(up_ticks)
        self.down_ticks = int(down_ticks)
        self.cooldown_s = float(cooldown_s)
        self.p99_slo_s = p99_slo_s
        self._clock = clock
        self._hot = 0           # consecutive over-pressure ticks
        self._cold = 0          # consecutive under-pressure ticks
        self._last_action_t: Optional[float] = None
        self._ups = 0
        self._downs = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- signals -----------------------------------------------------------

    @staticmethod
    def _queue_wait_p99() -> Optional[float]:
        """Queue-wait p99 seconds from the live registry, or None when the
        metrics plane is off / the histogram has no observations yet."""
        if not _metrics.enabled():
            return None
        snap = _metrics.snapshot() or {}
        fam = snap.get("brc_serve_queue_wait_seconds")
        if not fam:
            return None
        try:
            # several series (the fleet's per-worker federation labels)
            # fold into one distribution before the quantile estimate
            return _metrics.histogram_quantile(fam.get("series") or [], 0.99)
        except (KeyError, ValueError, ZeroDivisionError):
            return None

    def pressure(self) -> tuple:
        """The tick's inputs: ``(outstanding-per-routable-worker,
        routable-worker-count, queue-wait p99 | None)``."""
        st = self.fleet.stats(live=False)
        outstanding = max(0, st["submitted"] - st["replied"]
                          - st["failed"] - st["cancelled"])
        routable = max(1, st.get("routable", st["workers"]))
        return outstanding / routable, routable, self._queue_wait_p99()

    # -- the control law ---------------------------------------------------

    def tick(self) -> str:
        """One control decision: ``"up"``, ``"down"``, or ``"hold"``."""
        per_worker, routable, p99 = self.pressure()
        hot = per_worker >= self.up_per_worker or (
            self.p99_slo_s is not None and p99 is not None
            and p99 > self.p99_slo_s)
        cold = per_worker <= self.down_per_worker and not hot
        self._hot = self._hot + 1 if hot else 0
        self._cold = self._cold + 1 if cold else 0
        now = self._clock()
        cooling = (self._last_action_t is not None
                   and now - self._last_action_t < self.cooldown_s)
        if (self._hot >= self.up_ticks and routable < self.max_workers
                and not cooling):
            idx = self.fleet.scale_up()
            self._record("up", routable + 1, per_worker, p99, worker=idx)
            return "up"
        if (self._cold >= self.down_ticks and routable > self.min_workers
                and not cooling):
            idx = self.fleet.scale_down()
            if idx is None:
                return "hold"  # fleet refused (already at one worker)
            self._record("down", routable - 1, per_worker, p99, worker=idx)
            return "down"
        return "hold"

    def _record(self, action: str, target: int, per_worker: float,
                p99, worker: int) -> None:
        self._hot = self._cold = 0
        self._last_action_t = self._clock()
        if action == "up":
            self._ups += 1
            _trace.event("autoscale.up", worker=worker, target=target,
                         per_worker=round(per_worker, 3),
                         p99_s=None if p99 is None else round(p99, 6))
            _metrics.counter("brc_autoscale_up_total",
                             "Autoscaler scale-up decisions").inc()
        else:
            self._downs += 1
            _trace.event("autoscale.down", worker=worker, target=target,
                         per_worker=round(per_worker, 3),
                         p99_s=None if p99 is None else round(p99, 6))
            _metrics.counter("brc_autoscale_down_total",
                             "Autoscaler scale-down decisions").inc()
        _metrics.gauge("brc_autoscale_target_workers",
                       "Worker count the autoscaler last steered to"
                       ).set(target)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Autoscaler":
        if self._thread is not None:
            raise RuntimeError("autoscaler already started")
        _trace.event("autoscale.start", min_workers=self.min_workers,
                     max_workers=self.max_workers,
                     interval_s=self.interval_s)
        _metrics.gauge("brc_autoscale_target_workers",
                       "Worker count the autoscaler last steered to"
                       ).set(self.fleet.stats(live=False)["workers"])
        self._thread = threading.Thread(target=self._loop, name="autoscale",
                                        daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except RuntimeError:
                # the fleet is shutting down under us; the stop() that
                # caused it lands momentarily
                if self._stop.is_set():
                    break

    def stop(self, timeout: Optional[float] = 5.0) -> dict:
        """Stop the loop; returns ``{"ups", "downs"}`` decision totals."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        _trace.event("autoscale.stop", ups=self._ups, downs=self._downs)
        return {"ups": self._ups, "downs": self._downs}
