"""Fault-tolerance runtime: heartbeats, stragglers, snapshot rollback,
the counterpart of ``repro/ft/runtime.py``, with the same policies.

  * HeartbeatMonitor -- workers stamp a heartbeat each step; the monitor
    flags hosts whose stamp is older than ``timeout`` (an injectable
    clock makes the policy unit-testable).
  * StragglerTracker -- robust step-time stats (median + MAD); a host
    slower than median + k*MAD for ``patience`` consecutive steps is a
    straggler.
  * Snapshotter -- rolling in-memory (step, state) snapshots for
    rollback on loss spikes without touching disk. The port's state is
    mutable (a step updates the model and the optimizer state in
    place), so a snapshot is a clone on the device, and a rollback
    copies it back into the live state.
  * FaultTolerantLoop -- composes them around a train step: runs the
    steps, retries a step after a failure, rolls back on divergence, and
    writes periodic async checkpoints.

A step that raises before its update (a simulated node failure, a failed
launch) leaves the state it failed on, so a retry sees it unchanged
(``repro_torch.train.step``).

One change from the reference: a checkpoint written after step ``s``
(the loop's ``step % ckpt_every == 0``) is labelled ``s + 1``, the
number of steps it holds, as ``tests/test_ckpt_ft.py`` labels its own
saves. The reference's loop labels it ``s``, so a job resumed from it
(``start_step = s``) applies batch ``s`` a second time and cannot
reproduce the uninterrupted run; the port's resumes from ``s + 1`` and
does, bit for bit.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Optional

import torch
from torch import nn

from .. import ckpt
from ..train import step as step_lib


class HeartbeatMonitor:
    def __init__(self, hosts, timeout: float = 60.0, clock=time.monotonic):
        self.timeout = timeout
        self.clock = clock
        self.last = {h: clock() for h in hosts}

    def beat(self, host):
        self.last[host] = self.clock()

    def dead_hosts(self):
        now = self.clock()
        return [h for h, t in self.last.items() if now - t > self.timeout]


class StragglerTracker:
    def __init__(self, k: float = 4.0, patience: int = 3, window: int = 64):
        self.k = k
        self.patience = patience
        self.times: dict[object, collections.deque] = {}
        self.strikes: dict[object, int] = {}
        self.window = window

    def record(self, host, step_time: float):
        self.times.setdefault(
            host, collections.deque(maxlen=self.window)).append(step_time)

    def _stats(self):
        all_t = sorted(t for d in self.times.values() for t in d)
        if not all_t:
            return 0.0, 0.0
        med = all_t[len(all_t) // 2]
        mad = sorted(abs(t - med) for t in all_t)[len(all_t) // 2]
        return med, mad

    def stragglers(self):
        med, mad = self._stats()
        out = []
        for host, d in self.times.items():
            if d and d[-1] > med + self.k * max(mad, 1e-9):
                self.strikes[host] = self.strikes.get(host, 0) + 1
                if self.strikes[host] >= self.patience:
                    out.append(host)
            else:
                self.strikes[host] = 0
        return out


def _clone(state):
    """A copy on the same devices of a tree of tensors, modules (their
    parameters by name), dicts, lists and tuples."""
    if isinstance(state, nn.Module):
        return {k: p.detach().clone() for k, p in state.named_parameters()}
    if isinstance(state, dict):
        return {k: _clone(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_clone(v) for v in state)
    return state.detach().clone()


@torch.no_grad()
def _copy_into(live, snap) -> None:
    if isinstance(live, nn.Module):
        for k, p in live.named_parameters():
            p.copy_(snap[k])
    elif isinstance(live, dict):
        for k, v in live.items():
            _copy_into(v, snap[k])
    elif isinstance(live, (list, tuple)):
        for a, b in zip(live, snap):
            _copy_into(a, b)
    else:
        live.copy_(snap)


class Snapshotter:
    """Rolling in-memory snapshots (clones on the device) for cheap
    rollback."""

    def __init__(self, keep: int = 2):
        self.keep = keep
        self.snaps: collections.deque = collections.deque(maxlen=keep)

    def snap(self, step: int, state):
        self.snaps.append((step, _clone(state)))

    def rollback(self, into=None):
        """``(step, state)`` of the newest snapshot: copied into ``into``
        (the live state, in place) when given, else a fresh clone."""
        if not self.snaps:
            raise RuntimeError("no snapshot to roll back to")
        step, snap = self.snaps[-1]
        if into is None:
            return step, _clone(snap)
        _copy_into(into, snap)
        return step, into


class FaultTolerantLoop:
    """Drives train_step with checkpoint/restart + rollback policies."""

    def __init__(self, train_step: Callable, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 50, snap_every: int = 10,
                 max_retries: int = 2, loss_spike: float = 10.0):
        self.train_step = train_step
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.snap_every = snap_every
        self.max_retries = max_retries
        self.loss_spike = loss_spike
        self.snapshotter = Snapshotter()
        self.rollbacks = 0
        self.retries = 0

    def run(self, state, batches, start_step: int = 0,
            fail_hook: Optional[Callable] = None):
        """state = (model, opt_state), updated in place. batches: iterable
        of (step, batch). fail_hook(step) may raise to simulate a node
        failure."""
        params, opt = state
        last_loss = None
        for step, batch in batches:
            if step < start_step:
                continue
            if step % self.snap_every == 0:
                self.snapshotter.snap(step, (params, opt))
            for attempt in range(self.max_retries + 1):
                try:
                    if fail_hook is not None:
                        fail_hook(step)
                    params, opt, metrics = self.train_step(params, opt,
                                                           batch)
                    break
                except RuntimeError:
                    self.retries += 1
                    if attempt == self.max_retries:
                        raise
            loss = float(metrics["loss"])
            if last_loss is not None and loss > last_loss * self.loss_spike:
                self.snapshotter.rollback(into=(params, opt))
                self.rollbacks += 1
                continue
            last_loss = loss
            if self.ckpt_dir and step % self.ckpt_every == 0:
                ckpt.async_save(step_lib.state_tree(params, opt),
                                self.ckpt_dir, step + 1)
        ckpt.wait_pending()
        return params, opt
