"""Run records — the head of the versioned schema every artifact carries.

The port's copy of the head of the reference ``obs/record.py``: the record
version and revision, the environment fingerprint, the config block and the
counters block. ``env_fingerprint`` reports torch and CUDA where the
reference reports JAX, and never initializes CUDA: the device fields appear
only when the calling tool already brought the card up.
"""

from __future__ import annotations

import dataclasses

import numpy as np

RECORD_VERSION = 1
RECORD_REVISION = 14


def env_fingerprint() -> dict:
    """Environment identity for a run record."""
    import platform

    import torch

    from byzantinerandomizedconsensus_tpu_torch import __version__
    from byzantinerandomizedconsensus_tpu_torch.backends.native_backend import ABI_VERSION
    from byzantinerandomizedconsensus_tpu_torch.ops import prf

    out = {
        "package": __version__,
        "python": platform.python_version(),
        "numpy": np.__version__,
        "pack_versions": sorted(prf.KEY_LOW_BITS),
        # The fused round kernel's resident u32 state word, field ->
        # [bit offset, width].
        "fused_state_pack": {
            "version": prf.FUSED_STATE_PACK_VERSION,
            "bits": {k: list(v) for k, v in sorted(prf.FUSED_STATE_BITS.items())},
        },
        "native_abi": ABI_VERSION,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    if torch.cuda.is_initialized():
        out["platform"] = "gpu"
        out["device_kind"] = torch.cuda.get_device_name(0)
        out["device_count"] = torch.cuda.device_count()
    else:
        out["platform"] = "uninitialized"
    return out


def new_record(kind: str, description: str | None = None, config=None) -> dict:
    """The shared head every artifact document merges its payload into."""
    out = {"record_version": RECORD_VERSION,
           "record_revision": RECORD_REVISION, "kind": kind}
    if description is not None:
        out["description"] = description
    out["env"] = env_fingerprint()
    if config is not None:
        out["config"] = config_block(config)
    return out


def config_block(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d["pack_version"] = cfg.pack_version
    return d


def collect_counters(be, cfg, inst_ids=None) -> dict:
    """Run ``cfg`` once more with the counter leg on and return its counters
    block; a backend or kernel without a counter channel degrades to
    :func:`~obs.counters.unsupported_doc`. The counted run is separate from
    any timed run, so the timed window stays counter-free."""
    from byzantinerandomizedconsensus_tpu_torch.obs import counters

    try:
        _res, doc = be.run_with_counters(cfg, inst_ids)
        return doc
    except counters.CountersUnsupported as e:
        return counters.unsupported_doc(e)
