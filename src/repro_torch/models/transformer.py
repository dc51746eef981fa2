"""Decoder-LM assembly, counterpart of ``repro/models/transformer.py``,
for dense attention-only decoders (``pattern`` of ``a`` layers, no MoE,
no frontend).

A model is ``cfg.n_layers`` layers in ``cfg.n_groups`` groups of
``len(cfg.pattern)``; the reference stacks each group position's
parameters over the groups for ``lax.scan``, the port keeps one module a
layer and loops over them. State-dict names follow the reference's tree
with the group axis unstacked: ``groups.{g}.pos{j}.mixer.wq`` is
``params["groups"][f"pos{j}"]["mixer"]["wq"][g]``, in the same layout;
:func:`load_reference_params` fills a model from that tree.

Caches keep the reference's stacked layout (``layers.pos{j}.k`` is
``(G, B, Hkv, W, hd)``), but ``cache["len"]`` is a host int known to the
caller, so a decode step reads nothing back and attention gets the
cache's valid prefix as a view. The cache's k and v are updated in
place: the cache returned by :func:`forward_with_cache` shares them with
the one passed in. Ring caches (``cfg.window`` below ``max_len``) keep
each slot's position in ``cache["pos"]`` as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from . import layers
from .config import ModelCfg


def _check_supported(cfg: ModelCfg) -> None:
    """Refuse what the port does not run yet (ROADMAP queue 1, item 5)."""
    what = None
    if cfg.kind == "encdec":
        what = "encoder-decoder models (encdec)"
    elif cfg.frontend is not None:
        what = f"the {cfg.frontend} frontend"
    elif cfg.moe is not None:
        what = "MoE layers (moe)"
    elif set(cfg.pattern) != {"a"}:
        what = f"layer pattern {cfg.pattern!r} (mamba 'm' / rwkv 'r')"
    if what is not None:
        raise NotImplementedError(
            f"{cfg.name}: {what} not ported yet (ROADMAP queue 1, item 5: "
            f"the LM substrate's mixers); the port runs dense "
            f"attention-only decoders")


class _Params(nn.Module):
    """Leaf parameters of one mixer or FFN, indexable by name like the
    reference's dict (``p["wq"]``)."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, t in tree.items():
            self.register_parameter(name, nn.Parameter(t))

    def __getitem__(self, name: str):
        return self._parameters[name]


class Attention(_Params):
    def __init__(self, cfg, dtype, device, generator):
        super().__init__(layers.init_attention(generator, cfg, dtype,
                                               device))


class SwiGLU(_Params):
    def __init__(self, cfg, dtype, device, generator):
        super().__init__(layers.init_swiglu(generator, cfg, dtype, device))


class DecoderLayer(nn.Module):
    """Attention block then SwiGLU block, each pre-norm with a residual."""

    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        self.cfg = cfg
        self.mixer = Attention(cfg, dtype, device, generator)
        self.ffn = SwiGLU(cfg, dtype, device, generator)

    def forward(self, x, positions, cache=None, cache_len=None,
                cache_pos=None):
        x, _ = layers.attention_block(x, self.mixer, self.cfg, positions,
                                      cache=cache, cache_len=cache_len,
                                      cache_pos=cache_pos)
        return layers.swiglu_block(x, self.ffn, self.cfg)


class DecoderLM(nn.Module):
    """The decoder LM of ``cfg`` with weights drawn from ``generator``
    (default: seed 0 on the model's device), in ``cfg.act_dtype``, built
    for serving (no gradients). ``device=None`` means the card and raises
    on a host without one (:func:`repro_torch.device.resolve_device`)."""

    def __init__(self, cfg: ModelCfg, device=None, generator=None):
        super().__init__()
        _check_supported(cfg)
        dev = resolve_device(device)
        dtype = getattr(torch, cfg.act_dtype)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.cfg = cfg
        D = cfg.d_model
        self.embed = nn.Parameter(layers._normal(
            generator, (cfg.vocab, D), D ** -0.5, dtype, dev))
        self.final_ln = nn.Parameter(torch.ones((D,), dtype=dtype,
                                                device=dev))
        self.groups = nn.ModuleList(
            nn.ModuleDict({f"pos{j}": DecoderLayer(cfg, dtype, dev,
                                                   generator)
                           for j in range(len(cfg.pattern))})
            for _ in range(cfg.n_groups))
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(layers._normal(
                generator, (D, cfg.vocab), D ** -0.5, dtype, dev))
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def iter_layers(self):
        """(group, position, layer) in execution order."""
        for g, group in enumerate(self.groups):
            for j in range(len(self.cfg.pattern)):
                yield g, j, group[f"pos{j}"]

    def forward(self, tokens):
        return forward(self, tokens)


def param_count(model: DecoderLM) -> int:
    return sum(p.numel() for p in model.parameters())


# ------------------------------------------------------------- weights

def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes; exact in f32
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a))       # a writable copy


def _fill(param, a, name: str) -> None:
    t = _tensor(a)
    if tuple(t.shape) != tuple(param.shape):
        raise ValueError(f"load_reference_params: {name} has shape "
                         f"{tuple(t.shape)}, the model's {tuple(param.shape)}")
    param.copy_(t.to(param.dtype))


@torch.no_grad()
def load_reference_params(model: DecoderLM, tree) -> DecoderLM:
    """Fill ``model`` from the JAX package's ``init_params`` tree, given as
    numpy arrays (or anything ``np.asarray`` takes): group-position
    leaves ``groups/pos{j}/{mixer,ffn}/name`` carry a leading
    ``(n_groups,)`` axis. Every leaf must have its parameter and every
    parameter its leaf."""
    top = {"embed": model.embed, "final_ln": model.final_ln}
    if not model.cfg.tie_embeddings:
        top["unembed"] = model.unembed
    want = set(top) | {"groups"}
    if set(tree) != want:
        raise ValueError(f"load_reference_params: tree has {sorted(tree)}, "
                         f"the model needs {sorted(want)}")
    for name, param in top.items():
        _fill(param, tree[name], name)
    for g, j, layer in model.iter_layers():
        leaves = tree["groups"][f"pos{j}"]
        for sub in ("mixer", "ffn"):
            mod = getattr(layer, sub)
            if set(leaves[sub]) != set(mod._parameters):
                raise ValueError(
                    f"load_reference_params: pos{j}.{sub} has "
                    f"{sorted(leaves[sub])}, the model "
                    f"{sorted(mod._parameters)}")
            for name, a in leaves[sub].items():
                _fill(mod[name], np.asarray(a)[g], f"pos{j}.{sub}.{name}")
    return model


# ------------------------------------------------------------- forward

def logits_fn(model: DecoderLM, hidden):
    w = model.embed.T if model.cfg.tie_embeddings else model.unembed
    return torch.einsum("bsd,dv->bsv", hidden, w)


def forward_hidden(model: DecoderLM, tokens):
    """tokens: (B, S) int. Returns final hidden states (B, S, D)."""
    cfg = model.cfg
    x = F.embedding(tokens, model.embed)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    for _, _, layer in model.iter_layers():
        x = layer(x, positions)
    return layers.rms_norm(x, model.final_ln, cfg.norm_eps)


def forward(model: DecoderLM, tokens):
    """Full-vocab logits (B, S, V), teacher-forced."""
    return logits_fn(model, forward_hidden(model, tokens))


# -------------------------------------------------------------- caches

def init_cache(cfg: ModelCfg, batch: int, max_len: int, device=None):
    """Decode cache in ``cfg.act_dtype``. Attention caches hold W =
    min(max_len, window) kv slots; ring layout iff windowed and window <
    max_len."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.act_dtype)
    W = max_len if cfg.window is None else min(max_len, cfg.window)
    shape = (cfg.n_groups, batch, cfg.n_kv_heads, W, cfg.hd)
    cache = {"len": 0, "layers": {
        f"pos{j}": dict(k=torch.zeros(shape, dtype=dtype, device=dev),
                        v=torch.zeros(shape, dtype=dtype, device=dev))
        for j in range(len(cfg.pattern))}}
    if W < max_len:
        cache["pos"] = torch.full((W,), -1, dtype=torch.int32, device=dev)
    return cache


def forward_with_cache(model: DecoderLM, cache, tokens):
    """Shared prefill/decode forward. Returns (hidden, new_cache); the
    kv tensors are the same, updated in place."""
    cfg = model.cfg
    x = F.embedding(tokens, model.embed)
    B, S = tokens.shape
    L0 = cache["len"]
    ring_pos = cache.get("pos")
    positions = (L0 + torch.arange(S, device=x.device)).expand(B, S)
    for g, j, layer in model.iter_layers():
        c = {name: t[g] for name, t in cache["layers"][f"pos{j}"].items()}
        x = layer(x, positions, cache=c, cache_len=L0, cache_pos=ring_pos)
    new_cache = {"len": L0 + S, "layers": cache["layers"]}
    if ring_pos is not None:
        W = ring_pos.shape[0]
        m = min(S, W)
        new = L0 + S - m + torch.arange(m, device=x.device)
        new_cache["pos"] = ring_pos.index_put((new % W,),
                                              new.to(torch.int32))
    return layers.rms_norm(x, model.final_ln, cfg.norm_eps), new_cache


def prefill(model: DecoderLM, tokens, max_len: int):
    """Run the prompt through the model, build the cache, return the
    last-position logits (B, 1, V) and the cache ready for
    :func:`decode_step`."""
    cache = init_cache(model.cfg, tokens.shape[0], max_len,
                       device=model.device)
    hidden, cache = forward_with_cache(model, cache, tokens)
    return logits_fn(model, hidden[:, -1:]), cache


def decode_step(model: DecoderLM, cache, tokens):
    """One decode step. tokens: (B, 1). Returns (logits (B, 1, V),
    cache)."""
    hidden, cache = forward_with_cache(model, cache, tokens)
    return logits_fn(model, hidden), cache
