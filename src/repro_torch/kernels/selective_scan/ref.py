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
