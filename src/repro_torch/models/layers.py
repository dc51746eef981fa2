"""Transformer building blocks: norms, rotary, GQA/SWA attention, cross
attention (encoder-decoder), SwiGLU.

Counterpart of ``repro/models/layers.py``. Attention is one call of the
flash-attention kernel (``kernels/flash_attn``) for CUDA tensors and its
plain version for CPU tensors, through :func:`_chunk_attention`, the
reference models' attention with the same signature and function.

Parameters are mappings with the reference's names and layouts
(``wq (D, Hq, hd)``, ``wo (Hq, hd, D)``, ...): a dict of tensors or a
module of ``models.transformer`` (which indexes like one). The
reference's sharding constraints are dropped: on one card they are
no-ops. Unlike the reference, the kv cache is written in place: a block
returns the cache it was given, updated.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.flash_attn import backward as fab
from ..kernels.flash_attn import kernel as fa


def rms_norm(x, scale, eps: float = 1e-5):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rotary(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    # theta stays a host scalar: a tensor made from it on the card would
    # be a synchronising copy in every decode step
    freqs = 1.0 / (float(theta) ** exps)
    ang = positions[..., :, None].float() * freqs          # (..., S, hf)
    cos = torch.cos(ang)[..., :, None, :]                  # (..., S, 1, hf)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _chunk_attention(q, k, v, *, causal: bool, window, q_offset: int,
                     kv_len: int | None = None, k_positions=None):
    """Online-softmax attention, the reference's ``_chunk_attention``
    without its XLA tiling arguments (``chunk_q``, ``chunk_k``,
    ``causal_prune``): the kernel tiles by itself.

    q: (B, Hq, Sq, d); k/v: (B, Hkv, Skv, d). Query i sits at absolute
    position ``q_offset + i``; ``kv_len`` (a host int) keeps the first
    ``kv_len`` slots of a partly filled cache, as a view; ``k_positions``
    (Skv,) int32 gives explicit kv positions (ring caches; -1 = empty).
    One kernel launch for CUDA tensors, the plain version for CPU ones.

    With grad mode on and an input that requires grad, the call must be
    a training form and goes through :func:`backward.flash_attention_train`,
    whose backward is the backward kernels (their plain version on the
    CPU): no cache, ``q_offset`` 0, and either ``Sq == Skv`` (self
    attention) or a non-causal call without a window (cross attention,
    :func:`cross_attention_block`, at any ``Sq`` and ``Skv``).
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        cross = not causal and window is None
        if kv_len is not None or k_positions is not None or q_offset != 0 \
                or (q.shape[2] != k.shape[2] and not cross):
            raise ValueError("attention: gradients need a training form (no "
                             "cache, queries at offset 0 over the whole "
                             "sequence, or cross attention)")
        return fab.flash_attention_train(q, k, v, causal=causal,
                                         window=window)
    if k_positions is None and kv_len is not None:
        k, v = k[:, :, :kv_len], v[:, :, :kv_len]
    return fa.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, k_pos=k_positions)


def attention_block(x, p, cfg, positions, cache=None, cache_len=None,
                    cache_pos=None, causal: bool = True):
    """Full attention block (pre-norm, rotary, GQA, residual).

    x: (B, S, D). cache: None, or dict(k=(B, Hkv, W, hd), v=...) with
    ``cache_len`` = tokens already in the cache (a host int). When
    ``cache_pos`` (W,) int32 is given the cache is a ring buffer (W ==
    cfg.window): new kv goes to slots (cache_len + i) % W and cache_pos
    holds each slot's absolute position (-1 = empty). The cache's k and
    v are written in place. Returns (x', cache).
    """
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    kk = torch.einsum("bsd,dhk->bshk", h, p["wk"])
    vv = torch.einsum("bsd,dhk->bshk", h, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        kk = kk + p["bk"]
        vv = vv + p["bv"]
    q = rotary(q, positions, cfg.rope_theta).transpose(1, 2)  # (B,Hq,S,hd)
    kk = rotary(kk, positions, cfg.rope_theta).transpose(1, 2)
    vv = vv.transpose(1, 2)
    S = x.shape[1]
    dev = x.device

    if cache is None:
        out = _chunk_attention(q, kk, vv, causal=causal, window=cfg.window,
                               q_offset=0)
    elif cache_pos is not None:
        ck, cv = cache["k"], cache["v"]
        W = ck.shape[2]
        if S >= W:
            # ring prefill (S >= window, an empty ring): attend over the
            # in-flight sequence; only the last W kv land in the cache
            out = _chunk_attention(q, kk, vv, causal=causal,
                                   window=cfg.window, q_offset=cache_len)
            tail = cache_len + S - W + torch.arange(W, device=dev)
            ck[:, :, tail % W] = kk[:, :, -W:].to(ck.dtype)
            cv[:, :, tail % W] = vv[:, :, -W:].to(cv.dtype)
        else:
            new = cache_len + torch.arange(S, device=dev)
            slots = new % W
            ck[:, :, slots] = kk.to(ck.dtype)
            cv[:, :, slots] = vv.to(cv.dtype)
            new_pos = cache_pos.index_put((slots,), new.to(torch.int32))
            out = _chunk_attention(q, ck, cv, causal=causal,
                                   window=cfg.window, q_offset=cache_len,
                                   k_positions=new_pos)
    else:
        pos = cache_len
        ck, cv = cache["k"], cache["v"]
        ck[:, :, pos:pos + S] = kk.to(ck.dtype)
        cv[:, :, pos:pos + S] = vv.to(cv.dtype)
        out = _chunk_attention(q, ck, cv, causal=causal, window=cfg.window,
                               q_offset=pos, kv_len=pos + S)
    out = out.transpose(1, 2)  # (B, S, Hq, hd)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return x + y, cache


def cross_attention_block(x, p, cfg, memory=None, mem_kv=None):
    """Cross attention (the decoder side of an encoder-decoder): q from
    ``x``, k and v from the encoder memory, ``Hq`` kv heads and no
    rotary (positions live in the encoder's self-attention). ``mem_kv``
    is the memory's (k, v) projections, (B, Hq, Sm, hd) each, made once
    and reused by every decode step.

    x: (B, S, D); memory: (B, Sm, D). Returns (x', (k, v))."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"]).transpose(1, 2)
    if mem_kv is None:
        kk = torch.einsum("bsd,dhk->bshk", memory, p["wk"]).transpose(1, 2)
        vv = torch.einsum("bsd,dhk->bshk", memory, p["wv"]).transpose(1, 2)
    else:
        kk, vv = mem_kv
    # every query sees the whole memory: q_offset 0, not the kv suffix
    out = _chunk_attention(q, kk, vv, causal=False, window=None, q_offset=0)
    y = torch.einsum("bshk,hkd->bsd", out.transpose(1, 2), p["wo"])
    return x + y, (kk, vv)


def swiglu_block(x, p, cfg):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    a = torch.einsum("bsd,df->bsf", h, p["w1"])
    b = torch.einsum("bsd,df->bsf", h, p["w3"])
    y = torch.einsum("bsf,fd->bsd", F.silu(a) * b, p["w2"])
    return x + y


def _normal(generator, shape, std, dtype, device):
    return (torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32) * std).to(dtype)


def init_attention(generator, cfg, dtype, device):
    """The reference's ``init_attention`` tree, drawn from ``generator``
    (a ``torch.Generator`` on ``device``): N(0, 1/D) projections, wo
    N(0, 1/(Hq hd)), unit norm scale, zero biases."""
    hd, Hq, Hkv, D = cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    std = D ** -0.5
    p = dict(
        ln=torch.ones((D,), dtype=dtype, device=device),
        wq=_normal(generator, (D, Hq, hd), std, dtype, device),
        wk=_normal(generator, (D, Hkv, hd), std, dtype, device),
        wv=_normal(generator, (D, Hkv, hd), std, dtype, device),
        wo=_normal(generator, (Hq, hd, D), (Hq * hd) ** -0.5, dtype,
                   device),
    )
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((Hq, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((Hkv, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((Hkv, hd), dtype=dtype, device=device)
    return p


def init_cross_attention(generator, cfg, dtype, device):
    """The reference's ``init_cross_attention`` tree: kv heads = q heads
    (standard for an encoder-decoder), no biases."""
    hd, Hq, D = cfg.hd, cfg.n_heads, cfg.d_model
    std = D ** -0.5
    return dict(
        ln=torch.ones((D,), dtype=dtype, device=device),
        wq=_normal(generator, (D, Hq, hd), std, dtype, device),
        wk=_normal(generator, (D, Hq, hd), std, dtype, device),
        wv=_normal(generator, (D, Hq, hd), std, dtype, device),
        wo=_normal(generator, (Hq, hd, D), (Hq * hd) ** -0.5, dtype,
                   device),
    )


def init_swiglu(generator, cfg, dtype, device, d_ff=None):
    D = cfg.d_model
    F_ = d_ff or cfg.d_ff
    return dict(
        ln=torch.ones((D,), dtype=dtype, device=device),
        w1=_normal(generator, (D, F_), D ** -0.5, dtype, device),
        w3=_normal(generator, (D, F_), D ** -0.5, dtype, device),
        w2=_normal(generator, (F_, D), F_ ** -0.5, dtype, device),
    )
