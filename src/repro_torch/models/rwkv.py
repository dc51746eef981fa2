"""RWKV6 "Finch" block: data-dependent-decay linear attention and channel
mix, counterpart of ``repro/models/rwkv.py``.

The time mix's recurrence over tokens (the reference's ``lax.scan``) is
one launch of the wkv6 kernel (``kernels/wkv``) for CUDA tensors and its
plain version, one token at a time, for CPU tensors. With grad mode on
(and no cache) it goes through the training entry ``wkv6_train``, whose
gradient is the wkv6 backward kernel on the card and its plain version
on the CPU. Its state is (B, H, hd, hd) f32 a layer (O(1) a decoded
token); with a cache, the token-shift states and the wkv state are
updated in place in the cache given.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.wkv import kernel as wk
from .layers import _normal, rms_norm


def _token_shift(x, prev):
    """x_{t-1} with prev as the t=0 predecessor. x: (B, S, D), prev: (B, D)."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def time_mix(x, p, cfg, cache=None):
    rw = cfg.rwkv
    B, S, D = x.shape
    hd = rw.head_dim
    H = D // hd
    r0 = rms_norm(x, p["ln"], cfg.norm_eps)
    prev = x.new_zeros((B, D)) if cache is None else cache["shift_t"]
    sx = _token_shift(r0, prev) - r0

    # data-dependent lerp (ddlerp) for the five projections
    xxx = r0 + sx * p["mu_x"]
    deltas = torch.einsum(
        "pbsl,pld->pbsd",
        torch.tanh(torch.einsum("bsd,pdl->pbsl", xxx, p["mix_w1_p"])),
        p["mix_w2"])
    mw, mk, mv, mr, mg = deltas
    xw = r0 + sx * (p["mu_w"] + mw)
    xk = r0 + sx * (p["mu_k"] + mk)
    xv = r0 + sx * (p["mu_v"] + mv)
    xr = r0 + sx * (p["mu_r"] + mr)
    xg = r0 + sx * (p["mu_g"] + mg)

    r = torch.einsum("bsd,de->bse", xr, p["Wr"]).reshape(B, S, H, hd)
    k = torch.einsum("bsd,de->bse", xk, p["Wk"]).reshape(B, S, H, hd)
    v = torch.einsum("bsd,de->bse", xv, p["Wv"]).reshape(B, S, H, hd)
    g = F.silu(torch.einsum("bsd,de->bse", xg, p["Wg"]))
    w = p["w0"] + torch.einsum(
        "bsl,ld->bsd", torch.tanh(torch.einsum("bsd,dl->bsl", xw, p["dw1"])),
        p["dw2"])
    w = torch.exp(-torch.exp(w.float())).reshape(B, S, H, hd)

    if cache is None:
        state0 = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                             device=x.device)
        if torch.is_grad_enabled():
            y = wk.wkv6_train(r, k, v, w, p["u"], state0)
        else:
            y, _ = wk.wkv6(r, k, v, w, p["u"], state0)
    else:
        y, _ = wk.wkv6(r, k, v, w, p["u"], cache["wkv"],
                       out_state=cache["wkv"])
        cache["shift_t"].copy_(r0[:, -1, :])
    y = y.reshape(B, S, D).to(x.dtype)
    # per-head group norm (population variance, as jnp.var)
    yh = y.reshape(B, S, H, hd).float()
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, unbiased=False)
    yh = ((yh - mu) * torch.rsqrt(var + 64e-5)).reshape(B, S, D)
    y = (yh.to(x.dtype) * p["ln_x"]) * g
    out = torch.einsum("bse,ed->bsd", y, p["Wo"])
    return x + out, cache


def channel_mix(x, p, cfg, cache=None):
    B, S, D = x.shape
    r0 = rms_norm(x, p["ln"], cfg.norm_eps)
    prev = x.new_zeros((B, D)) if cache is None else cache["shift_c"]
    sx = _token_shift(r0, prev) - r0
    xk = r0 + sx * p["mu_ck"]
    xr = r0 + sx * p["mu_cr"]
    k = torch.einsum("bsd,df->bsf", xk, p["Wck"])
    k = torch.square(F.relu(k))
    v = torch.einsum("bsf,fd->bsd", k, p["Wcv"])
    r = torch.sigmoid(torch.einsum("bsd,de->bse", xr, p["Wcr"]))
    if cache is not None:
        cache["shift_c"].copy_(r0[:, -1, :])
    return x + r * v, cache


def rwkv_block(x, p, cfg, cache=None):
    """Full RWKV6 layer = time mix + channel mix."""
    x, _ = time_mix(x, p, cfg, cache)
    x, _ = channel_mix(x, p, cfg, cache)
    return x, cache


def init_rwkv(generator, cfg, dtype, device):
    """The reference's ``init_rwkv`` tree from ``generator``; ``u`` is f32
    whatever ``dtype`` is."""
    rw, D, F_ = cfg.rwkv, cfg.d_model, cfg.d_ff
    hd = rw.head_dim
    H = D // hd
    L, M = rw.decay_lora, rw.mix_lora
    std = D ** -0.5

    def zeros():
        return torch.zeros((D,), dtype=dtype, device=device)

    def normal(shape, s):
        return _normal(generator, shape, s, dtype, device)

    return dict(
        ln=torch.ones((D,), dtype=dtype, device=device),
        mu_x=zeros(), mu_w=zeros(), mu_k=zeros(), mu_v=zeros(),
        mu_r=zeros(), mu_g=zeros(),
        mix_w1_p=normal((5, D, M), std),
        mix_w2=normal((5, M, D), M ** -0.5),
        Wr=normal((D, D), std), Wk=normal((D, D), std),
        Wv=normal((D, D), std), Wg=normal((D, D), std),
        Wo=normal((D, D), std),
        w0=torch.full((D,), -1.0, dtype=dtype, device=device),
        dw1=normal((D, L), std), dw2=normal((L, D), L ** -0.5),
        u=_normal(generator, (H, hd), 0.1, torch.float32, device),
        ln_x=torch.ones((D,), dtype=dtype, device=device),
        mu_ck=zeros(), mu_cr=zeros(),
        Wck=normal((D, F_), std), Wcv=normal((F_, D), F_ ** -0.5),
        Wcr=normal((D, D), std),
    )
