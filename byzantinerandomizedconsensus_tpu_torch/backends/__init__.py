"""Backend registry of the port: ``torch`` (the CUDA kernels on the card, or
the plain torch round driver)."""

from byzantinerandomizedconsensus_tpu_torch.backends.base import (
    SimResult,
    SimulatorBackend,
    get_backend,
    register_backend,
)


def _torch(**options):
    """``torch`` — ``TorchBackend(kernel=..., device=...)``; the default is
    CUDA, with the kernel chosen by the config's delivery law."""
    from byzantinerandomizedconsensus_tpu_torch.backends.torch_backend import (
        TorchBackend)

    return TorchBackend(**options)


register_backend("torch", _torch)

__all__ = [
    "SimResult",
    "SimulatorBackend",
    "get_backend",
    "register_backend",
]
