"""The port's versioned spatial serving runtime.

* :class:`SpatialServer` (``server``) -- versions, free snapshots,
  pipelined updates, a bounded version window and ``commit()`` with a
  deferred (replay-on-overflow) capacity check.
* :class:`MicroBatcher` (``batcher``) -- coalesces kNN/range requests
  into pow2-padded batches; answers bit-match per-request dispatch.
* :mod:`driver` / :class:`LatencyRecorder` (``metrics``) -- a workload
  driver replaying deterministic mixed update/query traces
  (``repro_torch.data.points.make_trace``) and reporting per-op
  p50/p95/p99 plus sustained q/s and update-points/s.

``python -m repro_torch.serving.driver --smoke --device cpu`` runs the
whole stack on a tiny trace; as in the reference, the driver is a module
of its own and not imported here.
"""

from .batcher import MicroBatcher, Ticket  # noqa: F401
from .metrics import LatencyRecorder, summarize  # noqa: F401
from .server import Snapshot, SpatialServer  # noqa: F401

__all__ = ["LatencyRecorder", "MicroBatcher", "Snapshot", "SpatialServer",
           "Ticket", "summarize"]
