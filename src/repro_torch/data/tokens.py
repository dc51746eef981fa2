"""Deterministic synthetic token pipeline for the LM substrate.

Counterpart of ``repro/data/tokens.py``. Every batch is a pure function
of ``(seed, step)`` -- restart-safe: a job resumed from step k makes
batch k again exactly, so no data-loader state is checkpointed. The
numbers come from numpy's generator seeded with ``[seed, step]`` (the
same on every device) and differ from the reference's ``jax.random``
streams for the same seed: tests that compare the two packages hand both
the same arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), int(step)])


def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
             device=None):
    """(tokens, labels) for a causal-LM step, (batch, seq) int64 on
    ``device`` (``None``: the card); labels are tokens shifted by one."""
    dev = resolve_device(device)
    toks = _rng(seed, step).integers(0, vocab, (batch, seq + 1),
                                     dtype=np.int64)
    toks = torch.as_tensor(toks, device=dev)
    return toks[:, :-1], toks[:, 1:]


def embedding_batch(seed: int, step: int, batch: int, seq: int, dim: int,
                    device=None):
    """Precomputed frame/patch embeddings (batch, seq, dim) f32 for the
    audio/VLM frontend stubs."""
    dev = resolve_device(device)
    x = _rng(seed, step).standard_normal((batch, seq, dim), dtype=np.float32)
    return torch.as_tensor(x, device=dev)
