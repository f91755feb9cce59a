"""The ``(data, model)`` mesh over torch devices, and the reference's pure
layout functions.

The simulator's two parallel axes:

- ``data``  — independent consensus instances (Monte-Carlo data
  parallelism; no communication at all);
- ``model`` — the replicas of one instance: each model shard holds the
  state of a contiguous range of receivers, and each broadcast step
  all-gathers the (B, n) wire values (``parallel/sharded.py``).

A mesh here is a grid of torch devices inside one process. A device may
appear more than once: on one card, ``make_mesh(1, 4, ["cuda:0"] * 4)``
lays four model shards on it, an emulation of the layout that exercises
its semantics (and the kernels' receiver offsets) without the speed of
four cards. The reference's multi-host bootstrap (``init_distributed``)
and multi-host ``make_hybrid_mesh`` have no counterpart here;
:func:`hybrid_grid` keeps their layout logic, pure and testable.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` grid of torch devices: ``devices[d][m]``."""

    devices: tuple

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: len(self.devices), MODEL_AXIS: len(self.devices[0])}

    def distinct_devices(self) -> list:
        """Each device of the grid once, in grid order."""
        out = []
        for row in self.devices:
            for dev in row:
                if dev not in out:
                    out.append(dev)
        return out


def visible_devices(device="cuda") -> list:
    """Every visible device of ``device``'s type: all CUDA cards, or the CPU.
    A device with an index names itself alone."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the mesh runs on the cards by default — "
            "pass device='cpu' for a mesh of CPU shards")
    if dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``(data, model)`` mesh. Defaults: every visible card on the data
    axis.

    ``n_data * n_model`` must equal the number of devices given (a device
    may repeat); ``n_data=None`` infers it from the device count and
    ``n_model``."""
    devs = [torch.device(d) for d in (devices if devices is not None
                                      else visible_devices())]
    if n_model < 1:
        raise ValueError(f"n_model={n_model} out of range (>= 1)")
    if n_data is None:
        if len(devs) % n_model:
            raise ValueError(f"{len(devs)} devices not divisible by n_model={n_model}")
        n_data = len(devs) // n_model
    if n_data < 1 or n_data * n_model != len(devs):
        raise ValueError(
            f"mesh {n_data}x{n_model} needs {n_data * n_model} devices, have {len(devs)}")
    return Mesh(tuple(tuple(devs[d * n_model:(d + 1) * n_model]) for d in range(n_data)))


def hybrid_grid(devs: Sequence, n_model: int) -> np.ndarray:
    """(data, model) device grid for a multi-host device set (pure layout
    logic over objects with ``process_index``, ``id`` and optionally
    ``slice_index``): host-major order, model-axis groups of ``n_model``
    consecutive same-host devices, the data axis crossing hosts in blocks.
    ``n_model`` must divide each host's device count. (The reference's
    multi-slice TPU pods order each slice by its physical topology; here
    slices simply come first in the order.)"""
    n_hosts = len({d.process_index for d in devs})
    per_host = len(devs) // n_hosts
    if per_host % n_model:
        raise ValueError(f"n_model={n_model} must divide per-host device count {per_host}")
    order = sorted(devs, key=lambda d: (getattr(d, "slice_index", 0),
                                        d.process_index, d.id))
    return np.asarray(order, dtype=object).reshape(-1, n_model)


def _describe(dev) -> tuple:
    """(platform, device id, device kind) of a torch device or a stand-in
    object with those attributes."""
    if isinstance(dev, torch.device):
        if dev.type == "cuda":
            index = 0 if dev.index is None else dev.index
            return "gpu", index, torch.cuda.get_device_name(index)
        return dev.type, 0 if dev.index is None else dev.index, dev.type
    return (getattr(dev, "platform", "unknown"), getattr(dev, "id", None),
            getattr(dev, "device_kind", "unknown"))


def fleet_placement(n_workers: int, devices: Optional[Sequence] = None) -> list:
    """Worker → device placement for a fleet of workers: with at least as
    many devices as workers each worker gets its own (round-robin over the
    data axis: instances are independent, so no collective crosses
    workers), otherwise workers share and the placement says so
    (``shared: true``). One dict per worker (``worker``, ``platform``,
    ``device_id``, ``device_kind``, ``shared``); pure layout logic when
    ``devices`` is given."""
    if n_workers < 1:
        raise ValueError(f"n_workers={n_workers} out of range (>= 1)")
    devs = list(devices) if devices is not None else visible_devices(
        "cuda" if torch.cuda.is_available() else "cpu")
    if not devs:
        raise ValueError("fleet placement needs at least one device")
    shared = len(devs) < n_workers
    out = []
    for w in range(n_workers):
        platform, dev_id, kind = _describe(devs[w % len(devs)])
        out.append({
            "worker": w,
            "platform": platform,
            "device_id": int(w % len(devs) if dev_id is None else dev_id),
            "device_kind": kind,
            "shared": bool(shared),
        })
    return out
