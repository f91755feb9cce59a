"""byzantinerandomizedconsensus_tpu_torch — the simulator's port to PyTorch and
CUDA (an NVIDIA H100), beside the JAX reference package.

The port runs every benchmark configuration as shipped under the urn2
delivery law — Ben-Or (config1, config2 under crash faults), Bracha over
reliable broadcast (config3 under a Byzantine adversary, config4, config 5's
adaptive sweep), both coins, every static adversary — through one
hand-written CUDA kernel, the fused round loop (``csrc/fused_round.cu`` and
``csrc/fused_round_wide.cuh``), which also runs the urn, urn3 and committee
laws; and every configuration under the keys and urn delivery laws through
a per-step round driver whose deliveries are hand-written CUDA kernels
(``csrc/keys_step.cu``, ``csrc/urn_step.cu``). All go through the ``torch``
backend. Entry points run on the card unless the caller asks for
the CPU (``device="cpu"``), where the plain torch path runs.
"""

from byzantinerandomizedconsensus_tpu_torch.backends import get_backend
from byzantinerandomizedconsensus_tpu_torch.config import PRESETS, SimConfig, preset

__version__ = "0.1.0"

__all__ = ["PRESETS", "SimConfig", "get_backend", "preset"]
