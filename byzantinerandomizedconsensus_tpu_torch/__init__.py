"""byzantinerandomizedconsensus_tpu_torch — the simulator's port to PyTorch and
CUDA (an NVIDIA H100), beside the JAX reference package.

The port runs the benchmark's main path, Bracha over reliable broadcast with
the shared coin and the urn2 delivery law (preset ``config4``), whose fused
round loop is a hand-written CUDA kernel (``csrc/fused_round.cu``); and
config 5's adaptive-adversary sweep point under the keys and urn delivery
laws, through a per-step round driver whose deliveries are hand-written CUDA
kernels (``csrc/keys_step.cu``, ``csrc/urn_step.cu``). Both go through the
``torch`` backend. Entry points run on the card unless the caller asks for
the CPU (``device="cpu"``), where the plain torch path runs.
"""

from byzantinerandomizedconsensus_tpu_torch.backends import get_backend
from byzantinerandomizedconsensus_tpu_torch.config import PRESETS, SimConfig, preset

__version__ = "0.1.0"

__all__ = ["PRESETS", "SimConfig", "get_backend", "preset"]
