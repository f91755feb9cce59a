"""Committee quorum seam of the round bodies (spec/PROTOCOL.md §10), in torch.

The port's counterpart of the reference ``models/committee.py``. The round
bodies read every value-of-n law through :func:`quorum_params`: for every
delivery but the committee family it is ``(cfg.n_eff, cfg.f)``; for the
committee family the static committee size C and fault budget f_C
(``ops/committee.py``).

:class:`CommitteeUnsupported` is raised, by name, by a stack that has no
committee channel (the per-step kernels), instead of running the full-mesh
law.
"""

from __future__ import annotations

from byzantinerandomizedconsensus_tpu_torch.ops import committee as _committee
from byzantinerandomizedconsensus_tpu_torch.ops.committee import step_silence  # noqa: F401  (re-export for the round bodies)


class CommitteeUnsupported(RuntimeError):
    """Raised by a stack without a committee channel, by name."""


def check_committee_supported(cfg, stack: str) -> None:
    """Reject ``cfg.delivery == "committee"`` on a stack without a committee
    channel with one message naming the stacks that run it."""
    if cfg.delivery == "committee":
        raise CommitteeUnsupported(
            f"{stack} has no committee channel; "
            "delivery='committee' runs on kernel='fused' and kernel='plain'")


def quorum_params(cfg):
    """The (n, f) pair the protocol thresholds evaluate over (spec §10.3):
    ``(cfg.n_eff, cfg.f)``, or ``(C, f_C)`` under the committee family."""
    n, f = cfg.n_eff, cfg.f
    if cfg.delivery != "committee":
        return n, f
    return _committee.committee_size(n), _committee.committee_fault_budget(n, f)
