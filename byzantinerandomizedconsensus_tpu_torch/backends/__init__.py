"""Backend registry of the port: ``torch`` (the CUDA kernels on the card, or
the plain torch round driver), ``torch_sharded[:n_model[,kernel]]`` (the
``(data, model)`` mesh), ``virtual[:DxM]`` (the mesh's driver on CPU
tensors), and the two arbiters of the bit-match, ``cpu`` (the object
oracle) and ``native[:threads]`` (the C++ core). A name's ``:param`` suffix
goes to its factory."""

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


def _torch_sharded(param: str = "1", **options):
    """``torch_sharded[:<n_model>[,<kernel>]]`` — the ``(data, model)`` mesh
    (``parallel/sharded.py``): every visible card on the data axis, each row
    with ``n_model`` replica shards, through the kernel named (plain, step
    or fused; ``device`` and ``kernel`` options as for ``torch``)."""
    from byzantinerandomizedconsensus_tpu_torch.parallel.sharded import (
        TorchShardedBackend)

    n_model, _, kernel = param.partition(",")
    if kernel:
        options["kernel"] = kernel
    return TorchShardedBackend(n_model=int(n_model or "1"), **options)


def _virtual(param: str = "2x2", **options):
    """``virtual[:<data>x<model>]`` — the sharded driver on CPU tensors
    (``parallel/virtual.py``): a validation instrument of the sharding
    semantics, not a performance path."""
    from byzantinerandomizedconsensus_tpu_torch.parallel.virtual import VirtualMeshBackend

    d, _, m = param.partition("x")
    return VirtualMeshBackend(n_data=int(d or "2"), n_model=int(m or "1"), **options)


def _cpu():
    """``cpu`` — the object oracle (``core/``), an arbiter."""
    from byzantinerandomizedconsensus_tpu_torch.backends.cpu import CpuBackend

    return CpuBackend()


def _native(n_threads: str = "0"):
    """``native[:<threads>]`` — the C++ core (``native/simcore.cpp``), an
    arbiter."""
    from byzantinerandomizedconsensus_tpu_torch.backends.native_backend import NativeBackend

    return NativeBackend(n_threads=int(n_threads or "0"))


register_backend("torch", _torch)
register_backend("torch_sharded", _torch_sharded)
register_backend("virtual", _virtual)
register_backend("cpu", _cpu)
register_backend("native", _native)

__all__ = [
    "SimResult",
    "SimulatorBackend",
    "get_backend",
    "register_backend",
]
