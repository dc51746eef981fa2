"""Plain PyTorch version of the selective-scan kernel.

Counterpart of what ``repro/models/ssm.py:mamba_block`` computes with
``_selective_scan`` and the ``C`` contraction: the recurrence one token
at a time, with the reference's roundings (``da`` from ``dt`` cast to
f32, ``db`` formed in the activation type and then cast to f32, the
state and the output in f32). The reference's chunked associative scan
multiplies the decays in another order, so the two agree to f32
rounding, not bit for bit. No in-place update: autograd runs through it
on the CPU.
"""

from __future__ import annotations

import torch


def selective_scan_plain(dt, xc, A, Bm, Cm, D_skip, h0):
    """dt, xc: (B, S, di) in the activation type; A: (di, ds) f32; Bm, Cm:
    (B, S, ds) in the activation type; D_skip: (di,) f32; h0: (B, di, ds)
    f32. Returns ``(y, h_last)``: y (B, S, di) f32, ``sum_s h_t C_t + xc
    D_skip``, and the state after the last token (B, di, ds) f32."""
    h = h0
    C32 = Cm.float()
    ys = []
    for t in range(dt.shape[1]):
        d = dt[:, t, :, None]                                  # (B, di, 1)
        da = torch.exp(d.float() * A)
        db = (d * Bm[:, t, None, :] * xc[:, t, :, None]).float()
        h = da * h + db
        ys.append((h * C32[:, t, None, :]).sum(-1))
    y = torch.stack(ys, 1) if ys else dt.new_zeros(dt.shape, dtype=torch.float32)
    return y + xc.float() * D_skip, h


LOG2E = 1.4426950408889634
_F32_MIN_NORMAL = 2.0 ** -126


def _fma(a, b, c):
    """``a * b + c`` rounded once to f32, as ``__fmaf_rn`` (the product of
    two f32 values is exact in f64; the f64 sum rounds, then f32 does)."""
    return (a.double() * b.double() + c.double()).float()


def _bf16_mul(a, b):
    """The product of two bf16 values rounded once to bf16 (RNE), as
    ``__hmul2`` forms it; returned in f32."""
    return (a.float() * b.float()).to(torch.bfloat16).float()


def selective_scan_ex2_plain(dt, xc, A, Bm, Cm, D_skip, h0):
    """:func:`selective_scan_plain`'s function with
    ``csrc/selective_scan.cu``'s arithmetic, for the CPU tests: ``da =
    exp2(dt A')`` with ``A' = A log2(e)`` formed once in f32 (results below
    f32's smallest normal flushed to 0, as ``ex2.approx.ftz`` does; the
    hardware's last bits aside); ``db`` from the two bf16 products, each
    rounded once (f32 products for f32 inputs); ``h = fma(da, h, db)``,
    the output ``fma(h, C, acc)`` over the states in index order, then
    ``fma(x, D, acc)``. Same arguments and results as
    :func:`selective_scan_plain`."""
    a2 = A.float() * LOG2E
    h = h0.float()
    ys = []
    for t in range(dt.shape[1]):
        d, x = dt[:, t], xc[:, t]                               # (B, di)
        df = d.float()[..., None]
        da = torch.exp2(df * a2)
        da = torch.where(da < _F32_MIN_NORMAL, torch.zeros_like(da), da)
        Bt = Bm[:, t, None, :]
        if dt.dtype == torch.bfloat16:
            db = _bf16_mul(_bf16_mul(d[..., None], Bt).to(torch.bfloat16),
                           x[..., None])
        else:
            db = df * Bt.float() * x.float()[..., None]
        h = _fma(da, h, db)
        acc = torch.zeros(h.shape[:2], dtype=torch.float32)
        C = Cm[:, t].float()
        for s in range(h.shape[-1]):
            acc = _fma(h[..., s], C[:, None, s], acc)
        ys.append(_fma(x.float(), D_skip.float(), acc))
    y = (torch.stack(ys, 1) if ys
         else dt.new_zeros(dt.shape, dtype=torch.float32))
    return y, h


def selective_scan_bwd_plain(dt, xc, A, Bm, Cm, D_skip, h0, y_grad):
    """The gradients of :func:`selective_scan_plain`'s ``y`` (``h_last``
    takes none) given ``y_grad`` (B, S, di) f32, written out one token at
    a time in the backward kernel's order of work
    (``csrc/selective_scan_bwd.cu``), not by autograd. With ``a_t =
    exp(dt_t A)``, ``b_t = dt_t B_t x_t`` (formed in the activation type,
    as the forward does; its gradient is the product's), ``h_{t-1}`` the
    state before token t and ``g_t = dy_t C_t + a_{t+1} g_{t+1}`` the
    gradient of ``h_t`` (``g`` past the last token 0):

      dC_t[n] = sum_i dy_t[i] h_t[i, n]
      dlog a_t = g_t a_t h_{t-1}
      ddt_t = sum_n (dlog a_t[n] A[n] + g_t[n] B_t[n] x_t)
      dA = sum_{b, t} dlog a_t dt_t
      dB_t[n] = sum_i g_t[i, n] dt_t[i] x_t[i]
      dx_t = sum_n g_t[n] dt_t B_t[n] + dy_t D
      dD = sum_{b, t} dy_t x_t,  dh0 = a_1 g_1 (the first token's)

    Returns ``(ddt, dxc, dA, dBm, dCm, dD, dh0)``: ddt, dxc, dBm, dCm in
    the types of their inputs (computed in f32, rounded once), the rest
    f32."""
    dtf, x, Bf, Cf = dt.float(), xc.float(), Bm.float(), Cm.float()
    A, D, dy = A.float(), D_skip.float(), y_grad.float()
    S = dt.shape[1]
    h = h0.float()
    before, decay = [], []
    for t in range(S):
        d = dt[:, t, :, None]
        a = torch.exp(d.float() * A)
        db = (d * Bm[:, t, None, :] * xc[:, t, :, None]).float()
        before.append(h)
        decay.append(a)
        h = a * h + db
    g = torch.zeros_like(h)
    a_next = torch.ones_like(h)
    dA = torch.zeros_like(A)
    dD = torch.zeros_like(D)
    ddt, dx, dB, dC = ([None] * S for _ in range(4))
    for t in reversed(range(S)):
        h_t = before[t + 1] if t + 1 < S else h
        dyt, dtt, xt = dy[:, t], dtf[:, t], x[:, t]            # (B, di)
        dC[t] = (dyt[..., None] * h_t).sum(1)                  # (B, ds)
        g = dyt[..., None] * Cf[:, t, None, :] + a_next * g
        dloga = g * decay[t] * before[t]
        gB = (g * Bf[:, t, None, :]).sum(-1)                   # (B, di)
        ddt[t] = (dloga * A).sum(-1) + gB * xt
        dA = dA + (dloga * dtt[..., None]).sum(0)
        dB[t] = (g * (dtt * xt)[..., None]).sum(1)
        dx[t] = dtt * gB + dyt * D
        dD = dD + (dyt * xt).sum(0)
        a_next = decay[t]

    def stack(parts, like):
        if not parts:
            return torch.zeros(like.shape, dtype=like.dtype)
        return torch.stack(parts, 1).to(like.dtype)
    return (stack(ddt, dt), stack(dx, xc), dA, stack(dB, Bm),
            stack(dC, Cm), dD, a_next * g)


CHUNK = 8   # tokens between the backward's checkpoints (kChunk there)


def selective_scan_bwd_segmented_plain(dt, xc, A, Bm, Cm, D_skip, h0, y_grad,
                                       seg: int | None = None):
    """:func:`selective_scan_bwd_plain`'s function with the time
    decomposition of the reference's chunked scan (``ssm.py:_selective_scan``
    carries ``h`` across chunks by the chunk's decay product), for the CPU
    tests. No kernel of the port takes segments: ``csrc/selective_scan_bwd.cu``
    runs the sequence whole, with checkpoints every ``CHUNK`` tokens, and
    walks each chunk back carrying ``g`` and recomputing ``a_t``; this
    mirror carries ``a g`` and sums in torch's order. The tokens are cut
    into segments of ``seg`` (a multiple of ``CHUNK``; default one segment
    of the whole sequence, rounded up), and

      (a) each segment's walks from zero: the state, kept at every
          ``CHUNK``-th token with the decay products from the segment's
          start, to ``h_loc`` and the segment's decay product ``P``; then
          ``g`` back from the segment's last token, to ``a g`` of its
          first (``E_loc``);
      (b) the carry: ``h`` at the next segment's start ``P h + h_loc`` from
          ``h0``, and ``a g`` entering a segment from the one after it
          ``P E + E_loc``, back from 0; what leaves the first is dh0;
      (c) each segment's chunks from its last: the checkpoint rebuilt as
          local + prefix ``h``, the chunk's states recomputed, then walked
          back from the ``a g`` entering the segment.

    Segments are padded to whole ones with ``a = 1`` and zeros, which leave
    every sum as it is. Same results as :func:`selective_scan_bwd_plain`."""
    B, S, di = dt.shape
    ds = A.shape[-1]
    if seg is None:
        seg = max(CHUNK, -(-S // CHUNK) * CHUNK)
    if seg <= 0 or seg % CHUNK:
        raise ValueError(f"selective_scan: segment {seg} is not a positive "
                         f"multiple of {CHUNK}")
    n = max(1, -(-S // seg))
    A, D, dy = A.float(), D_skip.float(), y_grad.float()
    a = torch.exp(dt.float()[..., None] * A)                  # (B, S, di, ds)
    db = (dt[..., None] * Bm[:, :, None, :] * xc[..., None]).float()

    def cut(x, fill=0.0):
        pad = torch.full((B, n * seg - S, *x.shape[2:]), fill,
                         dtype=torch.float32)
        return torch.cat([x.float(), pad], 1).reshape(B, n, seg,
                                                      *x.shape[2:])
    a, db = cut(a, 1.0), cut(db)
    dtf, x, Bf, Cf, dy = (cut(t) for t in (dt, xc, Bm, Cm, dy))
    # (a)
    h = torch.zeros((B, n, di, ds))
    p = torch.ones((B, n, di, ds))
    ckpt, pre = [], []
    for t in range(seg):
        if t % CHUNK == 0:
            ckpt.append(h)
            pre.append(p)
        h = a[:, :, t] * h + db[:, :, t]
        p = p * a[:, :, t]
    h_loc, P = h, p
    e = torch.zeros_like(h)
    for t in reversed(range(seg)):
        e = a[:, :, t] * (dy[:, :, t, :, None] * Cf[:, :, t, None, :] + e)
    e_loc = e
    # (b)
    starts, hc = [], h0.float()
    for i in range(n):
        starts.append(hc)
        hc = P[:, i] * hc + h_loc[:, i]
    ins, ec = [None] * n, torch.zeros((B, di, ds))
    for i in reversed(range(n)):
        ins[i] = ec
        ec = P[:, i] * ec + e_loc[:, i]
    h_start, gd = torch.stack(starts, 1), torch.stack(ins, 1)
    # (c)
    ddt, dx, dC, dB = (torch.zeros(s) for s in ((B, n, seg, di),
                                                (B, n, seg, di),
                                                (B, n, seg, ds),
                                                (B, n, seg, ds)))
    dA = torch.zeros((di, ds))
    dD = torch.zeros((di,))
    for c in reversed(range(seg // CHUNK)):
        h = ckpt[c] + pre[c] * h_start
        before = []
        for t in range(c * CHUNK, (c + 1) * CHUNK):
            before.append(h)
            h = a[:, :, t] * h + db[:, :, t]
            dC[:, :, t] = (dy[:, :, t, :, None] * h).sum(2)
        for t in reversed(range(c * CHUNK, (c + 1) * CHUNK)):
            at, dyt, dtt, xt = a[:, :, t], dy[:, :, t], dtf[:, :, t], x[:, :, t]
            g = dyt[..., None] * Cf[:, :, t, None, :] + gd
            dloga = g * at * before[t - c * CHUNK]
            gB = (g * Bf[:, :, t, None, :]).sum(-1)
            ddt[:, :, t] = (dloga * A).sum(-1) + gB * xt
            dA = dA + (dloga * dtt[..., None]).sum((0, 1))
            dB[:, :, t] = (g * (dtt * xt)[..., None]).sum(2)
            dx[:, :, t] = dtt * gB + dyt * D
            dD = dD + (dyt * xt).sum((0, 1))
            gd = at * g

    def back(t, like):
        return t.reshape(B, n * seg, *t.shape[3:])[:, :S].to(like.dtype)
    return (back(ddt, dt), back(dx, xc), dA, back(dB, Bm), back(dC, Cm), dD,
            ec)
