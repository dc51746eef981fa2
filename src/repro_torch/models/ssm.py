"""Mamba-1 selective-scan block (jamba's mixer), counterpart of
``repro/models/ssm.py``.

The recurrence and its output contraction are one launch of the
selective-scan kernel (``kernels/selective_scan``) for CUDA tensors and
its plain version, one token at a time, for CPU tensors; the reference's
(B, S, d_inner, d_state) tensors never exist. With grad mode on (and no
cache) it goes through the training entry ``selective_scan_train``,
whose gradient is the selective-scan backward kernel on the card and its
plain version on the CPU. The causal depthwise
convolution is the reference's sum of ``d_conv`` shifted products in the
activation type (not ``F.conv1d``, which cuDNN runs in TF32 on the card).
Decode keeps O(1) state: the convolution's tail (activation type) and h
(f32), both updated in place in the cache given.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.selective_scan import kernel as ssk
from .layers import _normal, rms_norm


def _softplus(x):
    """``jax.nn.softplus``'s formula (``logaddexp(x, 0)``)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def mamba_block(x, p, cfg, cache=None):
    """x: (B, S, D). cache: None or dict(conv=(B, di, K-1), h=(B, di,
    ds)), written in place. Returns (x', cache)."""
    ssm = cfg.ssm
    B, S, D = x.shape
    di = ssm.expand * D
    ds, K = ssm.d_state, ssm.d_conv
    dtr = ssm.dt_rank or max(1, D // 16)

    r = rms_norm(x, p["ln"], cfg.norm_eps)
    xz = torch.einsum("bsd,de->bse", r, p["in_proj"])
    xi, z = xz[..., :di], xz[..., di:]                       # (B, S, di)

    # causal depthwise conv over the tokens, kept (B, S, di)
    if cache is None:
        tail = xi.new_zeros((B, K - 1, di))
    else:
        tail = cache["conv"].transpose(1, 2)
    full = torch.cat([tail, xi], dim=1)                      # (B, K-1+S, di)
    w = p["conv_w"]
    conv = w[:, 0] * full[:, 0:S]
    for k in range(1, K):
        conv = conv + w[:, k] * full[:, k:k + S]
    xc = F.silu(conv + p["conv_b"])

    proj = torch.einsum("bse,ef->bsf", xc, p["x_proj"])
    dt, Bm, Cm = proj[..., :dtr], proj[..., dtr:dtr + ds], proj[..., dtr + ds:]
    dt = _softplus(torch.einsum("bsr,re->bse", dt, p["dt_proj"])
                   + p["dt_bias"])                            # (B, S, di)
    A = -torch.exp(p["A_log"].float())                        # (di, ds)
    if cache is None:
        h0 = torch.zeros((B, di, ds), dtype=torch.float32, device=x.device)
        if torch.is_grad_enabled():
            y = ssk.selective_scan_train(dt, xc, A, Bm, Cm, p["D_skip"], h0)
        else:
            y, _ = ssk.selective_scan(dt, xc, A, Bm, Cm, p["D_skip"], h0)
    else:
        y, _ = ssk.selective_scan(dt, xc, A, Bm, Cm, p["D_skip"], cache["h"],
                                  out_state=cache["h"])
        cache["conv"].copy_(full[:, S:].transpose(1, 2))
    y = y.to(x.dtype) * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    return x + out, cache


def init_mamba(generator, cfg, dtype, device):
    """The reference's ``init_mamba`` tree from ``generator``; ``A_log``
    and ``D_skip`` are f32 whatever ``dtype`` is."""
    ssm, D = cfg.ssm, cfg.d_model
    di = ssm.expand * D
    ds, K = ssm.d_state, ssm.d_conv
    dtr = ssm.dt_rank or max(1, D // 16)
    a_log = torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                   device=device))
    return dict(
        ln=torch.ones((D,), dtype=dtype, device=device),
        in_proj=_normal(generator, (D, 2 * di), D ** -0.5, dtype, device),
        conv_w=_normal(generator, (di, K), K ** -0.5, dtype, device),
        conv_b=torch.zeros((di,), dtype=dtype, device=device),
        x_proj=_normal(generator, (di, dtr + 2 * ds), di ** -0.5, dtype,
                       device),
        dt_proj=_normal(generator, (dtr, di), dtr ** -0.5, dtype, device),
        dt_bias=torch.full((di,), -4.0, dtype=dtype, device=device),
        A_log=a_log.expand(di, ds).contiguous(),
        D_skip=torch.ones((di,), dtype=torch.float32, device=device),
        out_proj=_normal(generator, (di, D), di ** -0.5, dtype, device),
    )
