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
