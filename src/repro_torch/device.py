"""Device resolution for the port's entry points.

Entry points (``make_index``, ``SpatialServer.build``) run on the card
unless the caller asks for the CPU. Nothing falls back to the CPU on its
own: ``device=None`` means CUDA, and a host without CUDA raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; an explicit ``"cpu"`` (or any torch device
    spec) is honoured. Raises ``RuntimeError`` when CUDA is asked for
    (explicitly or by default) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device=\"cpu\" to "
            "run the port on the CPU")
    return dev
