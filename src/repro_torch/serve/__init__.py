"""LM serving (prefill and greedy or sampled decode over fixed slots),
counterpart of ``repro.serve``. Spatial-index serving is
:mod:`repro_torch.serving`."""

from .engine import ServeEngine  # noqa: F401
