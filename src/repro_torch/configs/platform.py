"""The mesh: one controller and an ordered tuple of torch devices.

Counterpart of ``repro/configs/platform.py``. JAX's mesh is
single-controller: one Python process owns every shard, and
``simulate_mesh(n)`` gives it n forced host devices. The port keeps that
shape. A :class:`Mesh` is an axis name and an ordered tuple of torch
devices, its *lanes*; lane i holds shard i, and the collectives of
:mod:`repro_torch.core.distributed` move per-lane blocks between lanes
with ``Tensor.to(lane, non_blocking=True)`` (a no-op when two lanes are
the same device).

* :func:`simulate_mesh` puts n lanes on one device (default: the card;
  tests pass ``device="cpu"``), the counterpart of n forced host
  devices. Nothing falls back to the CPU on its own.
* :func:`make_mesh` takes one lane per given device. A mesh of several
  cards is untested on cards (ROADMAP queue 1 item 6): the CPU tests
  run its lanes on one host.

The reference's env staging (``stage``, ``jax_initialized``, the
``XLA_FLAGS`` bookkeeping) has no counterpart: torch locks no device
topology at first use, so a mesh can be made at any point of a process.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices[i]`` is lane i. ``shape[axis]`` is the lane
    count, as on the reference's ``jax.sharding.Mesh``."""
    devices: tuple
    axis_names: tuple = ("data",)

    def __post_init__(self):
        if len(self.axis_names) != 1:
            raise ValueError(f"the port's mesh is 1-D; got axes "
                             f"{self.axis_names}")
        if not self.devices:
            raise ValueError("a mesh needs at least one lane")
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def simulate_mesh(n: int, axis_names: tuple = ("data",), device=None) -> Mesh:
    """``n`` lanes on one device (default: the card; a host without CUDA
    raises unless ``device="cpu"``)."""
    if n < 1:
        raise ValueError(f"simulate_mesh({n}): need at least one lane")
    dev = resolve_device(device)
    return Mesh((dev,) * int(n), tuple(axis_names))


def make_mesh(devices, axis_names: tuple = ("data",)) -> Mesh:
    """One lane per device in ``devices`` (torch devices or specs)."""
    return Mesh(tuple(resolve_device(d) for d in devices), tuple(axis_names))
