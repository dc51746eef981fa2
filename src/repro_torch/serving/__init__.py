"""The port's versioned spatial serving runtime.

* :class:`SpatialServer` (``server``) -- versions, free snapshots,
  pipelined updates, a bounded version window and ``commit()`` with a
  deferred (replay-on-overflow) capacity check.
* :class:`MicroBatcher` (``batcher``) -- coalesces kNN/range requests
  into pow2-padded batches; answers bit-match per-request dispatch.
* :class:`LatencyRecorder` (``metrics``) -- per-op percentiles and
  sustained rates.

The reference's driver CLI (``repro.serving.driver``) is not ported yet;
``chip_smoke.py`` at the repository root runs the same pipelined pattern.
"""

from .batcher import MicroBatcher, Ticket  # noqa: F401
from .metrics import LatencyRecorder, summarize  # noqa: F401
from .server import Snapshot, SpatialServer  # noqa: F401

__all__ = ["LatencyRecorder", "MicroBatcher", "Snapshot", "SpatialServer",
           "Ticket", "summarize"]
