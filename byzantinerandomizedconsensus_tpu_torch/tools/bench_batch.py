"""The seeded chaos grid of the config-batched measurements.

The port's copy of the reference ``tools/bench_batch.py``, so far its
population only: :func:`chaos_grid`, which ``tools/trace.py overhead`` and
``tools/programs.py census`` run. The batched-execution A/B legs of the
reference module are not ported yet.
"""

from __future__ import annotations

import random

from byzantinerandomizedconsensus_tpu_torch.tools import soak


def chaos_grid(n_configs: int, seed: int) -> list:
    """The seeded chaos population: the same draw law as ``soak --chaos``
    (``tools/sampler.py``; ``GENERATOR_VERSION`` and the seed reproduce it,
    in either package), so the measurements run the grid the chaos soak
    runs."""
    rng = random.Random(seed)
    return [soak.random_config(rng, chaos=True) for _ in range(n_configs)]
