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
