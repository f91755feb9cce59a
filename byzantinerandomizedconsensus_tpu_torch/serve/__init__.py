"""Consensus-as-a-service: the always-on single-grid server
(``serve/server.py``) with its admission (``serve/admission.py``) and
write-ahead log (``serve/wal.py``), the port's copy of the reference's
``serve`` package. The fleet (``worker.py``, ``fleet.py``,
``autoscale.py``) is not ported yet."""

from byzantinerandomizedconsensus_tpu_torch.serve.admission import (  # noqa: F401
    DEFAULT_TENANT, REQUEST_FIELDS, Backpressure, admit, bucket_of, envelope)
from byzantinerandomizedconsensus_tpu_torch.serve.server import (  # noqa: F401
    ConsensusServer, ServeRequest, serve_http)
