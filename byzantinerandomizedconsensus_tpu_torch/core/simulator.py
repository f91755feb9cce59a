"""Simulator — the front end: a config run through a backend of the seam.

The port's copy of the reference ``core/simulator.py``. ``backend="cpu"``
(the object oracle) is the default, as in the reference; ``options`` go to
the backend (``Simulator(cfg, "torch", device="cpu")``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from byzantinerandomizedconsensus_tpu_torch.backends.base import SimResult, get_backend
from byzantinerandomizedconsensus_tpu_torch.config import SimConfig


class Simulator:
    def __init__(self, cfg: SimConfig, backend: str = "cpu", **options):
        self.cfg = cfg.validate()
        self.backend = get_backend(backend, **options)

    def run(self, inst_ids: Optional[np.ndarray] = None) -> SimResult:
        return self.backend.timed_run(self.cfg, inst_ids)
