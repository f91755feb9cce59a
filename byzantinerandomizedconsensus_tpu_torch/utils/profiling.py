"""Tracing and profiling: a ``torch.profiler`` trace around a run, written
as a Chrome trace (Perfetto, ``chrome://tracing``), and named spans that
label its timeline.

The port's counterpart of the reference ``utils/profiling.py``. The
round bodies of the plain driver (``models/bracha.py``, ``benor.py``,
``delivery.py``) open their spans here; the fused kernel's wrapper opens
none, so its launch shows as one kernel on the device row.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import time

import torch


@contextlib.contextmanager
def trace(out_dir=None):
    """Profile the enclosed work into ``out_dir``: host (CPU) activity
    always, the card's (CUDA) activity when a card is present, written on
    exit as ``brc_<pid>_<ns>.pt.trace.json``. ``None`` profiles nothing, so
    a call site can pass a CLI flag straight through."""
    if out_dir is None:
        yield
        return
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(
        str(out / f"brc_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


def annotate(name: str):
    """A named span on the trace's host timeline (``brc/bracha/echo``,
    ``brc/urn2``, ...); it costs one profiler call when no trace is taken."""
    return torch.profiler.record_function(name)
