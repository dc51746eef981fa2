"""``SpatialServer``: a versioned spatial index with snapshot-isolated
queries and pipelined updates.

Counterpart of ``repro/serving/server.py``. The port's trees are
functional -- every update returns new tensors and never writes the old
ones -- so a *snapshot* is a reference to version ``v``'s handle, and
queries against it are answered from exactly that version while later
updates are queued behind them on the card.

* ``insert`` dispatches version ``v+1`` and returns without reading the
  device: the facade's host read of ``overflowed`` is deferred. The flag
  is sticky across updates, so one read at the next sync point covers
  every update since the last known-good version. (``delete`` reads one
  scalar per call in the port, see :func:`repro_torch.core.spac.delete`
  and :func:`repro_torch.core.porth.delete`.)
* A bounded version window (``window=``) is the backpressure knob:
  publishing ``v+1`` evicts ``v - window`` and waits on the CUDA event
  recorded when that version was published (the reference's
  ``jax.block_until_ready``), so at most ``window`` updates are queued.
  Its ``overflowed`` flag was copied to pinned host memory before that
  event, so the early overflow check there reads no device memory.
* ``commit()`` is the barrier: it waits for the head, runs the deferred
  overflow check and, if any insert overflowed, replays the op log from
  the last good version through the facade's synchronous recovery, so a
  committed head always holds the exact multiset of every op.

Snapshot isolation needs old versions live, so the server refuses an
index built with ``donate=True``.

The same lineage fronts a mesh-sharded head
(:class:`repro_torch.core.index.DistributedIndex`, ``build(...,
mesh=)``): updates route through the all-to-all and queries through the
engine's merge, both functional, so snapshots, the window and commit
work unchanged. Distribution adds a second sticky failure signal beside
the per-shard ``overflowed`` flags: the routing slab's ``dropped``
counter, compared with its committed baseline. Both are copied behind
the version's one event and read at the same sync points, and either
replays the op log through the facade's checked re-shard / slack
escalation.

Observability (:mod:`repro_torch.obs`, the reference's names): spans
``serving.insert`` / ``serving.delete`` (dispatch), ``serving.evict_block``
(the window's wait), ``serving.commit`` (the exposed stall; it ends with
``obs.resolve()``, the barrier that drains deferred reads) and
``serving.replay``; the ``server.mem.live_bytes`` / ``window_bytes``
gauges and the ``server.mem.evicted_bytes`` / ``evictions`` counters,
all from tensor metadata.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from .. import obs
from ..core.index import DistributedIndex, SpatialIndex, make_index
from ..obs.memory import tree_bytes


def _flags(index):
    """A version's sticky ``overflowed`` flags as one device tensor: the
    scalar of a local tree, the per-shard vector of a distributed head;
    None for a tree without the flag (the rebuild baselines kd and zd,
    whose updates are checked synchronously by the facade)."""
    if isinstance(index, DistributedIndex):
        return index.overflowed
    return getattr(index.tree, "overflowed", None)


def _mark(index):
    """What a later sync point needs about ``index``'s version: on the
    card, copies of its sticky failure signals (the ``overflowed`` flags
    and, on a distributed head, the routing-slab ``dropped`` counter)
    queued into pinned host memory and one CUDA event recorded after
    them, so waiting on the event and reading the copies waits for this
    version only (a plain host read would wait for everything queued
    after it). None on the CPU, where every op has finished when it
    returns, and for a tree without the flag."""
    flags_dev = _flags(index)
    if flags_dev is None or index.device.type != "cuda":
        return None
    flags = torch.empty(flags_dev.shape, dtype=torch.bool, pin_memory=True)
    flags.copy_(flags_dev, non_blocking=True)
    dropped = None
    if isinstance(index, DistributedIndex):
        dropped = torch.empty((), dtype=index.dropped.dtype,
                              pin_memory=True)
        dropped.copy_(index.dropped, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(index.device))
    return event, flags, dropped


def _dirty(index, mark, base_dropped: int) -> bool:
    """Wait for the version behind ``mark`` and read its sticky signals:
    dirty if any ``overflowed`` flag is set or, on a distributed head,
    ``dropped`` moved from its committed baseline."""
    if mark is None:
        flags = _flags(index)
        dropped = (index.dropped if isinstance(index, DistributedIndex)
                   else None)
    else:
        event, flags, dropped = mark
        event.synchronize()
    return bool(flags is not None and flags.any()) or (
        dropped is not None and int(dropped) != base_dropped)


class Snapshot:
    """Immutable view of one server version; queries delegate to its
    :class:`SpatialIndex` and are isolated from every later update."""

    __slots__ = ("version", "index")

    def __init__(self, version: int, index: SpatialIndex):
        self.version = version
        self.index = index

    def knn(self, qpts, k: int, *, impl: str = "auto"):
        return self.index.knn(qpts, k, impl=impl)

    def knn_points(self, qpts, k: int, *, impl: str = "auto"):
        return self.index.knn_points(qpts, k, impl=impl)

    def range_count(self, lo, hi):
        return self.index.range_count(lo, hi)

    def range_list(self, lo, hi):
        return self.index.range_list(lo, hi)

    @property
    def size(self):
        return self.index.size

    def __len__(self) -> int:
        return len(self.index)

    def __repr__(self):
        return f"Snapshot(version={self.version}, kind={self.index.kind!r})"


class SpatialServer:
    """Owns a lineage of :class:`SpatialIndex` versions; see the module
    docstring for the pipelining/backpressure/commit contract."""

    def __init__(self, index: SpatialIndex, *, window: int = 4):
        if getattr(index, "_donate", False):
            raise ValueError(
                "SpatialServer requires a non-donating index: snapshots "
                "keep old versions' buffers live; the bounded version "
                "window (window=) bounds memory instead")
        if window < 1:
            raise ValueError("window must be >= 1")
        self.window = int(window)
        self._head = 0
        self._versions: OrderedDict[int, SpatialIndex] = OrderedDict(
            {0: index})
        self._marks: dict[int, object] = {0: _mark(index)}
        nb = tree_bytes(index.tree)
        self._version_bytes: dict[int, int] = {0: nb}
        self.mem = {"live_bytes": nb, "window_bytes": nb,
                    "peak_window_bytes": nb, "evicted_bytes": 0,
                    "evictions": 0}
        # recovery state: the last version whose sticky overflow flag was
        # read clean, plus every op dispatched since
        self._base = 0
        self._base_index = index
        # a distributed head's second sticky signal: the routing-slab
        # `dropped` counter, compared with its committed baseline at the
        # sync points (construction is one, so this read is free)
        self._base_dropped = (int(index.dropped)
                              if isinstance(index, DistributedIndex) else 0)
        self._log: list[tuple[str, object, object]] = []
        self.stats = {"inserts": 0, "deletes": 0, "commits": 0,
                      "recoveries": 0, "update_points": 0}
        # device-side row counts not yet folded into update_points;
        # commit() (a barrier) reads them
        self._deferred_points: list = []

    @classmethod
    def build(cls, kind: str, points, *, window: int = 4, device=None,
              mesh=None, **make_kw):
        """Build a fresh index with :func:`make_index` on ``device``
        (default: the card), or over ``mesh``'s lanes as a
        :class:`DistributedIndex`, and wrap it; pass ``capacity_points=``
        for the lifetime maximum so the deferred overflow check never
        trips."""
        if make_kw.get("donate"):
            raise ValueError("SpatialServer does not support donate=True")
        return cls(make_index(kind, points, device=device, mesh=mesh,
                              **make_kw), window=window)

    # -- introspection -----------------------------------------------------

    @property
    def head_version(self) -> int:
        return self._head

    @property
    def head_index(self) -> SpatialIndex:
        return self._versions[self._head]

    @property
    def versions(self) -> tuple[int, ...]:
        """Retained version ids, oldest first."""
        return tuple(self._versions)

    @property
    def in_flight(self) -> int:
        """Updates dispatched since the last commit."""
        return self._head - self._base

    def snapshot(self, version: int | None = None) -> Snapshot:
        """A consistent view of ``version`` (default: head). Raises
        ``KeyError`` for versions outside the retained window."""
        v = self._head if version is None else int(version)
        try:
            return Snapshot(v, self._versions[v])
        except KeyError:
            raise KeyError(f"version {v} not retained (window holds "
                           f"{list(self._versions)})") from None

    # -- updates (dispatch) ------------------------------------------------

    def _live_rows(self, pts, mask) -> int:
        """Rows contributed to ``stats["update_points"]`` without a
        device read: a tensor mask is summed on the device and folded in
        at the next commit."""
        if mask is None:
            return int(pts.shape[0])
        if isinstance(mask, torch.Tensor):
            self._deferred_points.append(mask.sum())
            return 0
        return int(np.count_nonzero(mask))

    def _as_tensor(self, pts):
        return torch.as_tensor(pts, device=self.head_index.device)

    def insert(self, pts, mask=None) -> int:
        """Dispatch a batch insert as version ``head+1``; returns the new
        version id without reading the device."""
        with obs.span("serving.insert") as sp:
            pts = self._as_tensor(pts)
            sp.set(rows=pts.shape[0], version=self._head + 1)
            new = self.head_index.insert_unchecked(pts, mask)
            self.stats["inserts"] += 1
            self.stats["update_points"] += self._live_rows(pts, mask)
            return self._publish(new, ("insert", pts, mask))

    def delete(self, pts, mask=None) -> int:
        """Dispatch a batch delete as version ``head+1``."""
        with obs.span("serving.delete") as sp:
            pts = self._as_tensor(pts)
            sp.set(rows=pts.shape[0], version=self._head + 1)
            new = self.head_index.delete_unchecked(pts, mask)
            self.stats["deletes"] += 1
            self.stats["update_points"] += self._live_rows(pts, mask)
            return self._publish(new, ("delete", pts, mask))

    def _publish(self, index: SpatialIndex, op: tuple) -> int:
        self._head += 1
        self._versions[self._head] = index
        self._marks[self._head] = _mark(index)
        self._log.append(op)
        nb = tree_bytes(index.tree)
        self._version_bytes[self._head] = nb
        mem = self.mem
        mem["live_bytes"] = nb
        mem["window_bytes"] += nb
        while len(self._versions) > self.window:
            v, old = self._versions.popitem(last=False)
            freed = self._version_bytes.pop(v, 0)
            mem["window_bytes"] -= freed
            mem["evicted_bytes"] += freed
            mem["evictions"] += 1
            obs.count("server.mem.evicted_bytes", freed)
            obs.count("server.mem.evictions")
            # backpressure: the evicted version's work must be done
            # before more updates pile on; past the wait its sticky
            # overflow read is free and doubles as an early check
            with obs.span("serving.evict_block", version=v):
                dirty = _dirty(old, self._marks.pop(v, None),
                               self._base_dropped)
            if dirty:
                self._recover()
            elif v > self._base:
                del self._log[: v - self._base]
                self._base, self._base_index = v, old
        mem["peak_window_bytes"] = max(mem["peak_window_bytes"],
                                       mem["window_bytes"])
        obs.gauge("server.mem.live_bytes", mem["live_bytes"])
        obs.gauge("server.mem.window_bytes", mem["window_bytes"])
        return self._head

    # -- sync points -------------------------------------------------------

    def commit(self) -> int:
        """Barrier: wait for the head version, run the deferred overflow
        check (replaying from the last good version on overflow), and
        drop every older version. Returns the committed version id."""
        with obs.span("serving.commit") as sp:
            sp.set(version=self._head, in_flight=self._head - self._base)
            head = self._versions[self._head]
            if _dirty(head, self._marks.get(self._head),
                      self._base_dropped):
                head = self._recover()
            if self._deferred_points:
                self.stats["update_points"] += sum(
                    int(x) for x in self._deferred_points)
                self._deferred_points = []
            self._base, self._base_index = self._head, head
            if isinstance(head, DistributedIndex):
                self._base_dropped = int(head.dropped)
            self._log = []
            self._versions = OrderedDict({self._head: head})
            self._marks = {self._head: None}
            self._rebase_memory(head)
            self.stats["commits"] += 1
            # commit is THE barrier: deferred obs reads resolve here
            obs.resolve()
            return self._head

    def _recover(self) -> SpatialIndex:
        """Replay the op log from the last good version through the
        facade's synchronous recovery (grow -> retry -> compact)."""
        with obs.span("serving.replay", ops=len(self._log),
                      base=self._base, head=self._head):
            idx = self._base_index
            for op, pts, mask in self._log:
                idx = (idx.insert(pts, mask) if op == "insert"
                       else idx.delete(pts, mask))
            idx.block_until_ready()
        self._versions = OrderedDict({self._head: idx})
        self._marks = {self._head: None}
        self._base, self._base_index = self._head, idx
        if isinstance(idx, DistributedIndex):
            # the replayed head is the new baseline of the routing-slab
            # counter (a re-shard during the replay resets it)
            self._base_dropped = int(idx.dropped)
        self._log = []
        self._rebase_memory(idx)
        self.stats["recoveries"] += 1
        return idx

    # -- memory accounting -------------------------------------------------

    def _rebase_memory(self, index: SpatialIndex) -> None:
        nb = tree_bytes(index.tree)
        self._version_bytes = {self._head: nb}
        mem = self.mem
        mem["live_bytes"] = mem["window_bytes"] = nb
        mem["peak_window_bytes"] = max(mem["peak_window_bytes"], nb)
        obs.gauge("server.mem.live_bytes", nb)
        obs.gauge("server.mem.window_bytes", nb)

    def memory_report(self) -> dict:
        """Byte aggregates plus per-retained-version bytes (tensor
        metadata only, never a device read)."""
        return {**self.mem, "version_bytes": dict(self._version_bytes),
                "retained": len(self._versions)}

    def __repr__(self):
        return (f"SpatialServer(kind={self.head_index.kind!r}, "
                f"head={self._head}, window={self.window}, "
                f"retained={len(self._versions)})")
