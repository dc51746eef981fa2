"""Live-buffer memory accounting from tensor metadata -- no device reads.

Counterpart of ``repro/obs/memory.py``. A tree's resident footprint is
the sum of its tensors' ``nbytes``, pure shape/dtype arithmetic that
never touches the device or waits on queued work, so these helpers are
safe on dispatch paths.

Consumers:

* ``SpatialIndex.nbytes`` wraps :func:`tree_bytes` for one index.
* ``SpatialServer`` tracks bytes per retained version and emits the
  ``server.mem.live_bytes`` / ``server.mem.window_bytes`` gauges plus
  eviction counters through :mod:`repro_torch.obs`.
* The workload driver's per-scenario report has a memory section
  (steady/peak window bytes, eviction traffic).

The allocator's own numbers (``torch.cuda.memory_stats``) are not here:
that is a device-runtime query, made only inside ``Recorder.resolve``
when ``memory_snapshots`` is set.
"""

from __future__ import annotations

__all__ = ["tree_bytes", "fmt_bytes"]


def tree_bytes(tree) -> int:
    """Resident bytes of a backend tree's tensors (a tree dataclass's
    attributes; a tuple of trees, one per mesh lane, sums them):
    shape/dtype arithmetic, never a device read. Other attributes (ints,
    static config) contribute 0."""
    import torch  # deferred import: obs stays stdlib-importable

    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(t) for t in tree)
    return sum(v.nbytes for v in vars(tree).values()
               if isinstance(v, torch.Tensor))


def fmt_bytes(n: float) -> str:
    """Human-readable byte count (binary units, one decimal)."""
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:,.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:,.1f} TiB"
