"""Observability of the port: the protocol counters harvested from the
round bodies (``obs/counters.py``) and the head of the versioned run record
(``obs/record.py``)."""

from byzantinerandomizedconsensus_tpu_torch.obs.counters import (
    COUNTER_SCHEMA_VERSION,
    CountersUnsupported,
    counter_names,
    phase_names,
)
from byzantinerandomizedconsensus_tpu_torch.obs.record import (
    RECORD_VERSION,
    env_fingerprint,
    new_record,
)

__all__ = [
    "COUNTER_SCHEMA_VERSION",
    "CountersUnsupported",
    "counter_names",
    "phase_names",
    "RECORD_VERSION",
    "env_fingerprint",
    "new_record",
]
