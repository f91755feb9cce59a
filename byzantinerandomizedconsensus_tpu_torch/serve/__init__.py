"""Consensus-as-a-service: the always-on single-grid server
(``serve/server.py``) with its admission (``serve/admission.py``) and
write-ahead log (``serve/wal.py``), and the fleet that places N of them
behind one front door (``serve/fleet.py``, its worker process
``serve/worker.py`` and the autoscaler ``serve/autoscale.py``): the port's
copy of the reference's ``serve`` package."""

from byzantinerandomizedconsensus_tpu_torch.serve.admission import (  # noqa: F401
    DEFAULT_TENANT, REQUEST_FIELDS, Backpressure, admit, bucket_of, envelope)
from byzantinerandomizedconsensus_tpu_torch.serve.autoscale import Autoscaler  # noqa: F401
from byzantinerandomizedconsensus_tpu_torch.serve.fleet import (  # noqa: F401
    FleetRequest, FleetServer)
from byzantinerandomizedconsensus_tpu_torch.serve.server import (  # noqa: F401
    ConsensusServer, ServeRequest, serve_http)
