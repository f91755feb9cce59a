"""Adversary hunter: a closed-loop worst-case search engine driving the
serving stack. The port's copy of the reference ``hunt`` package.

The subsystem splits along its seams:

- :mod:`.space`: the declarative, seeded search space over the joint
  adversary × §9 fault-schedule × delivery × shape axes. Candidates are
  genomes that encode/decode to admissible ``SimConfig`` s through the one
  ``validate()`` path, and sampling delegates to the shared chaos-generator
  seam (tools/sampler.py) so hunt and soak can never drift.
- :mod:`.strategies`: pluggable optimizers behind one ask/tell interface
  (seeded random, mutation+crossover evolution, successive-halving bandit
  over space regions, a CMA-style strategy), each deterministic from
  ``(strategy, seed)``.
- :mod:`.hunter`: the closed loop: streams candidate generations into a
  resident :class:`~byzantinerandomizedconsensus_tpu_torch.serve.server
  .ConsensusServer` (on the card its direct leg through the kernels by
  law, or the lane leg), harvests fitness at retirement, and asks ahead so
  the next generation is drawn while the last is still served. Also the
  ``cli hunt`` entry point.
- :mod:`.archive`: the elite archive; exports found worst cases as pinned
  regression configs, replayable bit for bit in either package.
"""

from byzantinerandomizedconsensus_tpu_torch.hunt.archive import Archive  # noqa: F401
from byzantinerandomizedconsensus_tpu_torch.hunt.space import SearchSpace  # noqa: F401
from byzantinerandomizedconsensus_tpu_torch.hunt.strategies import (  # noqa: F401
    STRATEGIES, make_strategy)
