"""Plain PyTorch version of the wkv6 kernel: the reference's ``step`` of
``repro/models/rwkv.py:time_mix`` (its ``lax.scan`` over tokens), one
token at a time. r, k and v are cast to f32 before any product; ``u``
indexes the key dimension. No in-place update: autograd runs through it
on the CPU."""

from __future__ import annotations

import torch


def wkv6_plain(r, k, v, w, u, state):
    """r, k, v: (B, S, H, hd) in the activation type; w: (B, S, H, hd) f32
    decays; u: (H, hd) f32; state: (B, H, hd, hd) f32, ``state[..., k,
    v]``. Returns ``(y, state)``: y (B, S, H, hd) f32 and the state after
    the last token."""
    s = state
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t].float()[..., :, None] * v[:, t].float()[..., None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t].float(),
                               s + u[None, :, :, None] * kv))
        s = w[:, t][..., None] * s + kv
    y = torch.stack(ys, 1) if ys else r.new_zeros(r.shape, dtype=torch.float32)
    return y, s
