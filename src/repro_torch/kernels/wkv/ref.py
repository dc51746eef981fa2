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


KEY_BLOCK = 8   # keys a thread of the kernel holds (csrc/wkv6.cu: kTK)


def _fma(a, b, c):
    """``a * b + c`` rounded once to f32, as ``__fmaf_rn`` (the product of
    two f32 values is exact in f64; the f64 sum rounds, then f32 does)."""
    return (a.double() * b.double() + c.double()).float()


def _tree(parts):
    """Sum over dim 2 as the kernel's butterflies and ``tree_sum`` do,
    from the highest index bit down: ``(P0 + P2) + (P1 + P3)`` for 4
    parts."""
    while parts.shape[2] > 1:
        half = parts.shape[2] // 2
        parts = parts[:, :, :half] + parts[:, :, half:]
    return parts[:, :, 0]


def wkv6_split_plain(r, k, v, w, u, state):
    """:func:`wkv6_plain`'s function with ``csrc/wkv6.cu``'s decomposition,
    for the CPU tests: the keys split into groups of ``KEY_BLOCK``; a
    group's partial of ``out[v]`` is ``r_k s_kv`` summed in key order by
    FMAs (the first a product); the partials of groups ``2w`` and ``2w +
    1`` (one warp) added, then the warps' sums by :func:`_tree`; the bonus
    factored out as ``v_v B`` with ``B = sum_k (r_k u_k) k_k`` (in key
    order by FMAs within a chunk of 4 keys, the chunks by :func:`_tree`)
    and added last by an FMA; the state is ``fma(w, s, k v)``. The
    kernel's decode (one token) sums in the same order. Same arguments
    and results as :func:`wkv6_plain`."""
    B, S, H, hd = r.shape
    G = hd // KEY_BLOCK
    s = state.float()
    ys = []
    for t in range(S):
        rt, kt, vt = (a[:, t].float() for a in (r, k, v))      # (B, H, hd)
        wt = w[:, t].float()
        ru = (rt * u[None]).reshape(B, H, hd // 4, 4)
        kc = kt.reshape(B, H, hd // 4, 4)
        bonus = torch.zeros((B, H, hd // 4), dtype=torch.float32)
        for q in range(4):
            bonus = _fma(ru[..., q], kc[..., q], bonus)
        bonus = _tree(bonus[..., None])[..., 0]                # (B, H)
        # parts[b, h, g, v]: key group g's partial of out[v]
        sg = s.reshape(B, H, G, KEY_BLOCK, hd)
        rg = rt.reshape(B, H, G, KEY_BLOCK)
        parts = rg[..., 0, None] * sg[:, :, :, 0]
        for q in range(1, KEY_BLOCK):
            parts = _fma(rg[..., q, None], sg[:, :, :, q], parts)
        # a warp's two key groups, then the warps
        pairs = parts[:, :, 0::2] + parts[:, :, 1::2]
        ys.append(_fma(vt, bonus[..., None], _tree(pairs)))
        s = _fma(wt[..., None], s, kt[..., :, None] * vt[..., None, :])
    y = torch.stack(ys, 1) if ys else r.new_zeros(r.shape, dtype=torch.float32)
    return y, s
