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


def wkv6_bwd_plain(r, k, v, w, u, state0, y_grad):
    """The gradients of :func:`wkv6_plain`'s ``y`` (the last state takes
    none) given ``y_grad`` (B, S, H, hd) f32, written out one token at a
    time in the backward kernel's order of work (``csrc/wkv6_bwd.cu``),
    not by autograd. With ``S_{t-1}`` the state before token t and ``G_t``
    the gradient of the state after it (``G`` of the last token 0), for
    t from the last token down:

      dr_t[k] = sum_v dy_t[v] S_{t-1}[k, v] + u[k] k_t[k] (v_t . dy_t)
      dk_t[k] = u[k] r_t[k] (v_t . dy_t) + sum_v G_t[k, v] v_t[v]
      dv_t[v] = dy_t[v] sum_k r_t[k] u[k] k_t[k] + sum_k G_t[k, v] k_t[k]
      dw_t[k] = sum_v G_t[k, v] S_{t-1}[k, v]
      du[k]   = sum_{b, t} r_t[k] k_t[k] (v_t . dy_t)
      G_{t-1} = w_t G_t + r_t dy_t^T,  dstate0 = G before the first token

    Returns ``(dr, dk, dv, dw, du, dstate0)``: dr, dk, dv in the types of
    r, k, v (computed in f32, rounded once), the rest f32."""
    rf, kf, vf = r.float(), k.float(), v.float()
    w, u, dy = w.float(), u.float(), y_grad.float()
    S = r.shape[1]
    s = state0.float()
    before = []
    for t in range(S):
        before.append(s)
        s = w[:, t][..., None] * s + kf[:, t][..., :, None] * \
            vf[:, t][..., None, :]
    G = torch.zeros_like(s)
    du = torch.zeros_like(u)
    dr, dk, dv, dw = ([None] * S for _ in range(4))
    for t in reversed(range(S)):
        rt, kt, vt, wt, dyt = rf[:, t], kf[:, t], vf[:, t], w[:, t], dy[:, t]
        vdy = (vt * dyt).sum(-1, keepdim=True)                # (B, H, 1)
        dr[t] = torch.einsum("bhkv,bhv->bhk", before[t], dyt) + u * kt * vdy
        dk[t] = u * rt * vdy + torch.einsum("bhkv,bhv->bhk", G, vt)
        dv[t] = dyt * (rt * u * kt).sum(-1, keepdim=True) + \
            torch.einsum("bhkv,bhk->bhv", G, kt)
        dw[t] = (G * before[t]).sum(-1)
        du = du + (rt * kt * vdy).sum(0)
        G = wt[..., None] * G + rt[..., :, None] * dyt[..., None, :]

    def stack(parts, dtype):
        if not parts:
            return torch.zeros(r.shape, dtype=dtype)
        return torch.stack(parts, 1).to(dtype)
    return (stack(dr, r.dtype), stack(dk, k.dtype), stack(dv, v.dtype),
            stack(dw, torch.float32), du, G)


CHUNK = 8   # tokens between the backward's checkpoints (wkv6_bwd.cu: kChunk)


def wkv6_bwd_segmented_plain(r, k, v, w, u, state0, y_grad, seg: int):
    """:func:`wkv6_bwd_plain`'s function with ``csrc/wkv6_bwd.cu``'s
    decomposition, for the CPU tests: the tokens cut into segments of
    ``seg`` (a multiple of ``CHUNK``; the last may be short), and

      (a) each segment's walks from zero: the state from the segment's
          first token, kept at every ``CHUNK``-th token with the keys'
          decay products from the segment's start (the local
          checkpoints and prefixes), to ``S_loc`` and the segment's decay
          product ``D``; then ``G`` back from the segment's last token to
          ``G_loc``, and du (``r k (v . dy)``) on the way;
      (b) the carry over the segments in order: ``S_start`` of the next
          segment ``D S_start + S_loc`` from ``state0``, and ``G`` at a
          segment's end ``D G_end + G_loc`` of the one after it, back
          from 0; ``G`` before the first segment is dstate0;
      (c) each segment's chunks from its last: the checkpoint rebuilt as
          local + prefix ``S_start``, the chunk's states recomputed, then
          walked back with ``G`` from the segment's end.

    The segments are padded to whole ones with ``w = 1`` and zeros, which
    leave every sum as it is. Same results as :func:`wkv6_bwd_plain`."""
    if seg <= 0 or seg % CHUNK:
        raise ValueError(f"wkv6: segment {seg} is not a positive multiple "
                         f"of {CHUNK}")
    B, S, H, hd = r.shape
    n = max(1, -(-S // seg))

    def cut(a, fill):
        a = a.float()
        pad = torch.full((B, n * seg - S, H, hd), fill, dtype=torch.float32)
        return torch.cat([a, pad], 1).reshape(B, n, seg, H, hd)
    rf, kf, vf, dy = (cut(a, 0.0) for a in (r, k, v, y_grad))
    wf, u = cut(w, 1.0), u.float()

    def kv(t):
        return kf[:, :, t][..., :, None] * vf[:, :, t][..., None, :]

    def vdy(t):
        return (vf[:, :, t] * dy[:, :, t]).sum(-1, keepdim=True)
    # (a)
    s = torch.zeros((B, n, H, hd, hd))
    d = torch.ones((B, n, H, hd))
    ckpt, pre = [], []
    for t in range(seg):
        if t % CHUNK == 0:
            ckpt.append(s)
            pre.append(d)
        s = wf[:, :, t][..., None] * s + kv(t)
        d = d * wf[:, :, t]
    s_loc, D = s, d
    g = torch.zeros_like(s)
    du = torch.zeros((H, hd))
    for t in reversed(range(seg)):
        du = du + (rf[:, :, t] * kf[:, :, t] * vdy(t)).sum((0, 1))
        g = wf[:, :, t][..., None] * g + \
            rf[:, :, t][..., :, None] * dy[:, :, t][..., None, :]
    g_loc = g
    # (b)
    starts, sc = [], state0.float()
    for i in range(n):
        starts.append(sc)
        sc = D[:, i][..., None] * sc + s_loc[:, i]
    ends, gc = [None] * n, torch.zeros((B, H, hd, hd))
    for i in reversed(range(n)):
        ends[i] = gc
        gc = D[:, i][..., None] * gc + g_loc[:, i]
    s_start, G = torch.stack(starts, 1), torch.stack(ends, 1)
    # (c)
    dr, dk, dv, dw = (torch.zeros((B, n, seg, H, hd)) for _ in range(4))
    for c in reversed(range(seg // CHUNK)):
        s = ckpt[c] + pre[c][..., None] * s_start
        before = []
        for t in range(c * CHUNK, (c + 1) * CHUNK):
            before.append(s)
            s = wf[:, :, t][..., None] * s + kv(t)
        for t in reversed(range(c * CHUNK, (c + 1) * CHUNK)):
            rt, kt, vt, dyt = (a[:, :, t] for a in (rf, kf, vf, dy))
            sb = before[t - c * CHUNK]
            dr[:, :, t] = torch.einsum("bnhkv,bnhv->bnhk", sb, dyt) + \
                u * kt * vdy(t)
            dk[:, :, t] = u * rt * vdy(t) + \
                torch.einsum("bnhkv,bnhv->bnhk", G, vt)
            dv[:, :, t] = dyt * (rt * u * kt).sum(-1, keepdim=True) + \
                torch.einsum("bnhkv,bnhk->bnhv", G, kt)
            dw[:, :, t] = (G * sb).sum(-1)
            G = wf[:, :, t][..., None] * G + \
                rt[..., :, None] * dyt[..., None, :]

    def back(a, dtype):
        return a.reshape(B, n * seg, H, hd)[:, :S].to(dtype)
    return (back(dr, r.dtype), back(dk, k.dtype), back(dv, v.dtype),
            back(dw, torch.float32), du, gc)
