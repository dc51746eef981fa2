"""Encoder-decoder assembly (seamless-m4t style), the counterpart of
``repro/models/encdec.py``.

Encoder: ``cfg.encoder_layers`` bidirectional attention layers (rotary
over the frame positions) over precomputed modality-frontend embeddings
(the speech frontend is a stub: ``data/tokens.py:embedding_batch`` gives
frame embeddings), which the ``adapter`` projects to ``d_model``.
Decoder: ``cfg.n_layers`` causal layers, each self-attention, cross
attention over the encoder memory, then SwiGLU. Every attention is one
flash-attention call (``layers._chunk_attention``).

State-dict names follow the reference's tree with the layer axis
unstacked: ``encoder.{l}.attn.wq`` is
``params["encoder"]["attn"]["wq"][l]`` and ``decoder.{l}.xattn.wk``
``params["decoder"]["xattn"]["wk"][l]``;
:func:`load_reference_params` and :func:`reference_params` (the
decoder LM's, which map any model of the port) carry weights across.

Training (``EncDecLM(..., train=True)``): :func:`loss_fn` is the
reference's chunked cross-entropy over the decoder's labels, and every
attention (the encoder's, the decoder's self and cross attention) trains
through the attention backward kernels
(``kernels/flash_attn/backward.py``; the cross attention at Sq != Skv).
With grad mode on and ``cfg.remat`` other than ``"none"``, each encoder
and decoder layer runs under ``torch.utils.checkpoint`` and is recomputed
whole in the backward, as the reference's ``jax.checkpoint`` of each
layer's body with no policy: unlike the decoder LM's ``"dots"``, which
saves the projections, every remat mode here saves only each layer's
input (``"dots"`` and ``"full"`` alike).

Serving caches keep the reference's stacked layout: ``self_k`` and
``self_v`` (L, B, Hkv, max_len, hd) for the decoder's self-attention,
``mem_k`` and ``mem_v`` (L, B, Hq, mem_len, hd) for the cross
attention's projections of the (static) encoder memory, written once by
:func:`prefill` and read by every :func:`decode_step`. As in the decoder
LM, ``cache["len"]`` is a host int and the tensors are updated in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt_lib

from ..device import resolve_device
from . import layers
from .config import ModelCfg
from .transformer import (_REMAT, _Params, chunked_ce, default_generator,
                          init_adapter, load_reference_params,  # noqa: F401
                          param_count, reference_params)


def _layer(inits, generator, cfg, dtype, device) -> nn.ModuleDict:
    """One layer: ``{name: parameters}`` drawn by each of ``inits``."""
    return nn.ModuleDict({name: _Params(init(generator, cfg, dtype, device))
                          for name, init in inits.items()})


_ENCODER = {"attn": layers.init_attention, "ffn": layers.init_swiglu}
_DECODER = {"attn": layers.init_attention,
            "xattn": layers.init_cross_attention, "ffn": layers.init_swiglu}


class EncDecLM(nn.Module):
    """The encoder-decoder of ``cfg`` (``cfg.kind == "encdec"``) with
    weights drawn from ``generator`` (default: seed 0 on the model's
    device), in ``cfg.act_dtype``, built for serving (no gradients) or,
    with ``train=True``, with parameters that require grad.
    ``device=None`` means the card and raises on a host without one; the
    ``meta`` device sizes the model without memory."""

    def __init__(self, cfg: ModelCfg, device=None, generator=None,
                 train: bool = False):
        super().__init__()
        if cfg.kind != "encdec":
            raise ValueError(f"{cfg.name}: EncDecLM needs kind 'encdec', not "
                             f"{cfg.kind!r}")
        if cfg.remat not in _REMAT:
            raise ValueError(f"{cfg.name}: remat {cfg.remat!r} is not one of "
                             f"{sorted(_REMAT)}")
        dev = resolve_device(device)
        dtype = getattr(torch, cfg.act_dtype)
        if generator is None:
            generator = default_generator(dev)
        self.cfg = cfg
        D = cfg.d_model
        self.embed = nn.Parameter(layers._normal(
            generator, (cfg.vocab, D), D ** -0.5, dtype, dev))
        self.adapter = _Params(init_adapter(generator, cfg, dtype, dev))
        self.encoder = nn.ModuleList(
            _layer(_ENCODER, generator, cfg, dtype, dev)
            for _ in range(cfg.encoder_layers))
        self.enc_ln = nn.Parameter(torch.ones((D,), dtype=dtype, device=dev))
        self.decoder = nn.ModuleList(
            _layer(_DECODER, generator, cfg, dtype, dev)
            for _ in range(cfg.n_layers))
        self.final_ln = nn.Parameter(torch.ones((D,), dtype=dtype,
                                                device=dev))
        self.requires_grad_(train)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, frames, tokens):
        return forward(self, frames, tokens)


def _positions(start: int, B: int, S: int, dev):
    # start is a host int: no tensor made from it, no sync
    return (start + torch.arange(S, device=dev)).expand(B, S)


def _layer_call(cfg: ModelCfg, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (the whole layer
    recomputed in the backward) when grad mode is on and ``cfg.remat``
    is not ``"none"``: the reference's ``jax.checkpoint`` of the body."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    return ckpt_lib.checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------------- encoder

def encode(model: EncDecLM, frames):
    """frames: (B, S_enc, frontend_dim) -> memory (B, S_enc, D)."""
    cfg = model.cfg
    x = (frames.to(model.embed.dtype) @ model.adapter["w"]
         + model.adapter["b"])
    B, S = x.shape[:2]
    positions = _positions(0, B, S, x.device)
    for layer in model.encoder:
        x = _layer_call(cfg, _enc_body, layer, x, cfg, positions)
    return layers.rms_norm(x, model.enc_ln, cfg.norm_eps)


def _enc_body(layer, x, cfg, positions):
    x, _ = layers.attention_block(x, layer["attn"], cfg, positions,
                                  causal=False)
    return layers.swiglu_block(x, layer["ffn"], cfg)


# ---------------------------------------------------------------- decoder

def _dec_body(layer, x, cfg, positions, memory=None, mem_kv=None,
              cache=None, cache_len=None):
    x, kv = layers.attention_block(x, layer["attn"], cfg, positions,
                                   cache=cache, cache_len=cache_len)
    x, xkv = layers.cross_attention_block(x, layer["xattn"], cfg,
                                          memory=memory, mem_kv=mem_kv)
    x = layers.swiglu_block(x, layer["ffn"], cfg)
    return x, kv, xkv


def _dec_train_body(layer, x, cfg, positions, memory):
    return _dec_body(layer, x, cfg, positions, memory=memory)[0]


def decode_train(model: EncDecLM, tokens, memory):
    """Teacher-forced decoder pass. tokens: (B, S_dec) -> hidden (B,
    S_dec, D)."""
    cfg = model.cfg
    x = F.embedding(tokens, model.embed)
    positions = _positions(0, *tokens.shape, x.device)
    for layer in model.decoder:
        x = _layer_call(cfg, _dec_train_body, layer, x, cfg, positions,
                        memory)
    return layers.rms_norm(x, model.final_ln, cfg.norm_eps)


def _logits(model: EncDecLM, hidden):
    return torch.einsum("bsd,vd->bsv", hidden, model.embed)


def forward(model: EncDecLM, frames, tokens):
    """Full encoder-decoder forward to logits (B, S_dec, V)."""
    return _logits(model, decode_train(model, tokens, encode(model, frames)))


def loss_fn(model: EncDecLM, frames, tokens, labels):
    """Mean cross-entropy over label positions (-1 = ignore), the
    logits taken ``cfg.loss_chunk`` positions at a time, so (B, S, V)
    never exists at once."""
    hidden = decode_train(model, tokens, encode(model, frames))
    return chunked_ce(hidden, model.embed.T, labels, model.cfg.loss_chunk)


# ---------------------------------------------------------------- serving

def init_cache(cfg: ModelCfg, batch: int, max_len: int, mem_len: int,
               device=None):
    """Zeroed caches in ``cfg.act_dtype``: the decoder's self-attention
    kv for ``max_len`` tokens and the cross attention's projections of a
    ``mem_len``-frame memory."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.act_dtype)
    L, hd = cfg.n_layers, cfg.hd

    def zeros(heads, n):
        return torch.zeros((L, batch, heads, n, hd), dtype=dtype, device=dev)

    return {"len": 0,
            "self_k": zeros(cfg.n_kv_heads, max_len),
            "self_v": zeros(cfg.n_kv_heads, max_len),
            "mem_k": zeros(cfg.n_heads, mem_len),
            "mem_v": zeros(cfg.n_heads, mem_len)}


def prefill(model: EncDecLM, frames, tokens, max_len: int):
    """Encode ``frames``, fill both caches from the decoder prompt
    ``tokens``; returns the last position's logits (B, 1, V) and the
    cache ready for :func:`decode_step`."""
    memory = encode(model, frames)
    cache = init_cache(model.cfg, tokens.shape[0], max_len, memory.shape[1],
                       device=model.device)
    return _forward_cached(model, cache, tokens, memory=memory)


def decode_step(model: EncDecLM, cache, tokens):
    """One decode step. tokens: (B, 1). Returns (logits (B, 1, V),
    cache)."""
    return _forward_cached(model, cache, tokens)


def _forward_cached(model: EncDecLM, cache, tokens, memory=None):
    """With ``memory`` (a prefill) the cross attention projects it and
    writes the projections into ``mem_k``/``mem_v``; without (a decode
    step) it reads them back."""
    cfg = model.cfg
    x = F.embedding(tokens, model.embed)
    L0 = cache["len"]
    positions = _positions(L0, *tokens.shape, x.device)
    for l, layer in enumerate(model.decoder):
        mk, mv = cache["mem_k"][l], cache["mem_v"][l]
        x, _, (kk, vv) = _dec_body(
            layer, x, cfg, positions, memory=memory,
            mem_kv=None if memory is not None else (mk, mv),
            cache=dict(k=cache["self_k"][l], v=cache["self_v"][l]),
            cache_len=L0)
        if memory is not None:
            mk.copy_(kk)
            mv.copy_(vv)
    hidden = layers.rms_norm(x, model.final_ln, cfg.norm_eps)
    return _logits(model, hidden[:, -1:]), {**cache, "len": L0 +
                                             tokens.shape[1]}
