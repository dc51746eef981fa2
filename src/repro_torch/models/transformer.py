"""Decoder-LM assembly, counterpart of ``repro/models/transformer.py``,
for every decoder pattern: attention (``a``), Mamba (``m``) and RWKV6
(``r``) layers, each ``a`` and ``m`` layer followed by a SwiGLU FFN or,
where ``cfg.is_moe_layer(j)``, a MoE FFN (an ``r`` layer's channel mix is
its FFN). A frontend arch (``cfg.frontend``: internvl2's vision stub)
takes ``prefix_embed``, precomputed patch or frame embeddings (B, P,
``frontend_dim``) that the ``adapter`` projects to ``d_model`` and puts
before the tokens; the loss covers the tokens only. Encoder-decoder
models are :mod:`repro_torch.models.encdec`.

A model is ``cfg.n_layers`` layers in ``cfg.n_groups`` groups of
``len(cfg.pattern)``; the reference stacks each group position's
parameters over the groups for ``lax.scan``, the port keeps one module a
layer and loops over them. State-dict names follow the reference's tree
with the group axis unstacked: ``groups.{g}.pos{j}.mixer.wq`` is
``params["groups"][f"pos{j}"]["mixer"]["wq"][g]``, in the same layout,
and ``adapter.w`` is ``params["adapter"]["w"]``;
:func:`load_reference_params` fills a model (this module's or
``encdec``'s) from that tree. Leaves the
reference keeps in f32 whatever the activation type (Mamba's ``A_log``
and ``D_skip``, RWKV6's ``u``) stay f32.

Training (``DecoderLM(..., train=True)``): :func:`loss_fn` is the
reference's chunked cross-entropy, and ``cfg.remat`` checkpoints each
layer group with ``torch.utils.checkpoint`` when grad mode is on:
``"full"`` recomputes the group in the backward, ``"dots"`` saves the
products without batch dimensions (the projections, whose einsums lower
to ``bmm`` over a batch of one) and recomputes the rest, attention
included (the counterpart of ``checkpoint_dots_with_no_batch_dims``),
``"none"`` saves everything. The reference's ``scan_layers`` has no
counterpart: the layers run as a Python loop. The Mamba and RWKV
recurrences train through autograd functions whose backward is a CUDA
kernel on the card and a plain version on the CPU
(``kernels/wkv/kernel.py:Wkv6``,
``kernels/selective_scan/kernel.py:SelectiveScan``); under remat their
forward kernels run again in the recompute. :func:`reference_tree` and
:func:`from_reference_tree` map any ``{parameter name: tensor}`` dict
(the parameters, the optimizer's moments) to the reference's tree with
the group axis stacked, and back; :func:`reference_params` is the
inverse of :func:`load_reference_params`.

Caches keep the reference's stacked layout (``layers.pos{j}.k`` is
``(G, B, Hkv, W, hd)``; a Mamba position holds ``conv`` (G, B, di, K-1)
and ``h`` (G, B, di, ds) f32, an RWKV position ``shift_t``, ``shift_c``
(G, B, D) and ``wkv`` (G, B, H, hd, hd) f32), but ``cache["len"]`` is a
host int known to the caller, so a decode step reads nothing back and
attention gets the cache's valid prefix as a view. Every cache tensor is
updated in place: the cache returned by :func:`forward_with_cache`
shares them with the one passed in. Ring caches (``cfg.window`` below
``max_len``) keep each slot's position in ``cache["pos"]`` as in the
reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt_lib

from ..device import resolve_device
from . import layers, moe as moe_lib, rwkv as rwkv_lib, ssm as ssm_lib
from .config import ModelCfg


def _check_supported(cfg: ModelCfg) -> None:
    if cfg.kind != "decoder":
        raise ValueError(
            f"{cfg.name}: DecoderLM runs decoder-only models, not kind "
            f"{cfg.kind!r}; build an encoder-decoder with "
            f"repro_torch.models.encdec.EncDecLM")
    bad = set(cfg.pattern) - set("amr")
    if bad:
        raise ValueError(f"{cfg.name}: unknown layer types {sorted(bad)}")
    if cfg.moe is not None and len(cfg.pattern) % cfg.moe.every:
        raise ValueError(f"{cfg.name}: moe.every must divide the pattern "
                         f"length for scanned groups")


def default_generator(dev: torch.device) -> torch.Generator:
    """Seed 0 on ``dev`` (a CPU generator for the ``meta`` device, where
    a model is only sized)."""
    return torch.Generator(
        device="cpu" if dev.type == "meta" else dev).manual_seed(0)


def init_adapter(generator, cfg: ModelCfg, dtype, device) -> dict:
    """The frontend stub's projection ``frontend_dim -> d_model``."""
    D, Fd = cfg.d_model, cfg.frontend_dim
    return dict(w=layers._normal(generator, (Fd, D), Fd ** -0.5, dtype,
                                 device),
                b=torch.zeros((D,), dtype=dtype, device=device))


class _Params(nn.Module):
    """Leaf parameters of one mixer or FFN, indexable by name like the
    reference's dict (``p["wq"]``)."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, t in tree.items():
            self.register_parameter(name, nn.Parameter(t))

    def __getitem__(self, name: str):
        return self._parameters[name]


# each layer type's parameter tree (mixer), and each FFN's
_MIXERS = {"a": layers.init_attention, "m": ssm_lib.init_mamba,
           "r": rwkv_lib.init_rwkv}


class DecoderLayer(nn.Module):
    """Group position ``j``: its mixer (attention, Mamba or RWKV6) then,
    except after RWKV6 (whose channel mix is its FFN), a SwiGLU or MoE
    FFN; each block pre-norm with a residual."""

    def __init__(self, cfg, j: int, dtype, device, generator):
        super().__init__()
        self.cfg = cfg
        self.kind = cfg.layer_type(j)
        self.moe = cfg.is_moe_layer(j)
        self.mixer = _Params(_MIXERS[self.kind](generator, cfg, dtype,
                                                device))
        if self.kind != "r":
            init = moe_lib.init_moe if self.moe else layers.init_swiglu
            self.ffn = _Params(init(generator, cfg, dtype, device))

    def forward(self, x, positions, cache=None, cache_len=None,
                cache_pos=None):
        if self.kind == "a":
            x, _ = layers.attention_block(x, self.mixer, self.cfg, positions,
                                          cache=cache, cache_len=cache_len,
                                          cache_pos=cache_pos)
        elif self.kind == "m":
            x, _ = ssm_lib.mamba_block(x, self.mixer, self.cfg, cache=cache)
        else:
            x, _ = rwkv_lib.rwkv_block(x, self.mixer, self.cfg, cache=cache)
            return x
        if self.moe:
            return moe_lib.moe_block(x, self.ffn, self.cfg)
        return layers.swiglu_block(x, self.ffn, self.cfg)


class DecoderLM(nn.Module):
    """The decoder LM of ``cfg`` with weights drawn from ``generator``
    (default: seed 0 on the model's device), in ``cfg.act_dtype``, built
    for serving (no gradients) or, with ``train=True``, with parameters
    that require grad. ``device=None`` means the card and raises on a
    host without one (:func:`repro_torch.device.resolve_device`); the
    ``meta`` device sizes a model without memory. A frontend arch also
    holds ``adapter.{w,b}``."""

    def __init__(self, cfg: ModelCfg, device=None, generator=None,
                 train: bool = False):
        super().__init__()
        _check_supported(cfg)
        dev = resolve_device(device)
        dtype = getattr(torch, cfg.act_dtype)
        if generator is None:
            generator = default_generator(dev)
        self.cfg = cfg
        D = cfg.d_model
        self.embed = nn.Parameter(layers._normal(
            generator, (cfg.vocab, D), D ** -0.5, dtype, dev))
        self.final_ln = nn.Parameter(torch.ones((D,), dtype=dtype,
                                                device=dev))
        self.groups = nn.ModuleList(
            nn.ModuleDict({f"pos{j}": DecoderLayer(cfg, j, dtype, dev,
                                                   generator)
                           for j in range(len(cfg.pattern))})
            for _ in range(cfg.n_groups))
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(layers._normal(
                generator, (D, cfg.vocab), D ** -0.5, dtype, dev))
        if cfg.frontend is not None:
            self.adapter = _Params(init_adapter(generator, cfg, dtype, dev))
        if cfg.remat not in _REMAT:
            raise ValueError(f"{cfg.name}: remat {cfg.remat!r} is not one of "
                             f"{sorted(_REMAT)}")
        self.requires_grad_(train)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def iter_layers(self):
        """(group, position, layer) in execution order."""
        for g, group in enumerate(self.groups):
            for j in range(len(self.cfg.pattern)):
                yield g, j, group[f"pos{j}"]

    def forward(self, tokens, prefix_embed=None):
        return forward(self, tokens, prefix_embed)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def _ref_path(name: str):
    """A parameter name -> (its path in the reference's tree, its index
    on the stacked layer axis or None): ``groups.{g}.pos{j}.mixer.wq`` ->
    (``("groups", "pos{j}", "mixer", "wq")``, g), ``encoder.{l}.attn.wq``
    -> (``("encoder", "attn", "wq")``, l), ``adapter.w`` ->
    (``("adapter", "w")``, None)."""
    parts = name.split(".")
    if len(parts) > 1 and parts[1].isdigit():
        return (parts[0], *parts[2:]), int(parts[1])
    return tuple(parts), None


def reference_tree(named) -> dict:
    """``{parameter name: tensor}`` (the model's names, e.g. its
    ``named_parameters()`` or an optimizer moment keyed the same way) ->
    the reference's nested tree, group-position leaves stacked over a
    leading ``(n_groups,)`` axis (``torch.stack``: a copy)."""
    tree: dict = {}
    stacks: dict = {}
    for name, t in named.items():
        path, g = _ref_path(name)
        if g is None:
            _put(tree, path, t)
        else:
            stacks.setdefault(path, {})[g] = t
    for path, by_group in stacks.items():
        _put(tree, path, torch.stack([by_group[g]
                                      for g in range(len(by_group))]))
    return tree


def _put(tree: dict, path: tuple, leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def _leaves(tree, prefix=()):
    """(path, leaf) of every leaf of a nested dict."""
    for key, node in tree.items():
        if isinstance(node, dict):
            yield from _leaves(node, (*prefix, key))
        else:
            yield (*prefix, key), node


def from_reference_tree(tree, names) -> dict:
    """The inverse of :func:`reference_tree`: ``{name: leaf}`` for each of
    ``names``, a group-position leaf sliced at its group (a view)."""
    out = {}
    for name in names:
        path, g = _ref_path(name)
        node = tree
        for key in path:
            node = node[key]
        out[name] = node if g is None else node[g]
    return out


def reference_params(model: nn.Module) -> dict:
    """The model's weights as the reference's ``init_params`` tree of
    numpy arrays (the inverse of :func:`load_reference_params`); bf16
    weights come out as f32 (exact), since numpy has no bf16. Every array
    is a copy: training the model in place leaves the tree as it was."""
    tree = reference_tree({n: p.detach()
                           for n, p in model.named_parameters()})
    return _to_numpy(tree)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    t = tree.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return np.array(t.cpu().numpy())


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
def load_reference_params(model: nn.Module, tree):
    """Fill ``model`` (a :class:`DecoderLM` or an ``encdec.EncDecLM``)
    from the JAX package's ``init_params`` tree, given as numpy arrays
    (or anything ``np.asarray`` takes): stacked leaves (``groups/pos{j}/
    {mixer,ffn}/name``, ``encoder/attn/name``, ...) carry a leading layer
    axis, one entry a layer. Every leaf must have its parameters and
    every parameter its leaf."""
    want: dict = {}
    for name, param in model.named_parameters():
        path, g = _ref_path(name)
        want.setdefault(path, {})[g] = param
    have = dict(_leaves(tree))
    if set(have) != set(want):
        show = sorted("/".join(p) for p in set(have) ^ set(want))
        raise ValueError(f"load_reference_params: tree has {len(have)} "
                         f"leaves, the model {len(want)}; not in both: "
                         f"{show}")
    for path, by_layer in want.items():
        a, name = np.asarray(have[path]), "/".join(path)
        if None in by_layer:
            _fill(by_layer[None], a, name)
            continue
        if a.shape[:1] != (len(by_layer),):
            raise ValueError(f"load_reference_params: {name} has shape "
                             f"{a.shape}, the model {len(by_layer)} layers")
        for g, param in by_layer.items():
            _fill(param, a[g], f"{name}[{g}]")
    return model


# ------------------------------------------------------------- forward

def logits_fn(model: DecoderLM, hidden):
    w = model.embed.T if model.cfg.tie_embeddings else model.unembed
    return torch.einsum("bsd,dv->bsv", hidden, w)


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing's ``"dots"``: save the products without
    batch dimensions (``mm``, ``addmm``, and ``bmm`` over a batch of one,
    which is what the projections' einsums lower to); recompute the rest."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return ckpt_lib.CheckpointPolicy.MUST_SAVE
    return ckpt_lib.CheckpointPolicy.PREFER_RECOMPUTE


_REMAT = {
    "none": None,
    "full": ckpt_lib.noop_context_fn,
    "dots": functools.partial(ckpt_lib.create_selective_checkpoint_contexts,
                              _dots_policy),
}


def _group_fn(group, x, positions):
    """One group of len(pattern) layers, training mode (no caches)."""
    for j in range(len(group)):
        x = group[f"pos{j}"](x, positions)
    return x


def _embed_inputs(model: DecoderLM, tokens, prefix_embed):
    """The tokens' embeddings, after the ``adapter``'s projection of
    ``prefix_embed`` (cast to the activation type first) when given."""
    x = F.embedding(tokens, model.embed)
    if prefix_embed is None:
        return x
    if model.cfg.frontend is None:
        raise ValueError(f"{model.cfg.name}: prefix_embed needs a frontend "
                         f"arch (this one has no adapter)")
    pre = prefix_embed.to(x.dtype) @ model.adapter["w"] + model.adapter["b"]
    return torch.cat([pre, x], dim=1)


def forward_hidden(model: DecoderLM, tokens, prefix_embed=None):
    """tokens: (B, S_tok) int; prefix_embed: (B, P, frontend_dim) or
    None. Returns final hidden states (B, P + S_tok, D). With grad mode
    on each layer group runs under ``cfg.remat``."""
    cfg = model.cfg
    x = _embed_inputs(model, tokens, prefix_embed)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    context_fn = _REMAT[cfg.remat] if torch.is_grad_enabled() else None
    for group in model.groups:
        if context_fn is None:
            x = _group_fn(group, x, positions)
        else:
            x = ckpt_lib.checkpoint(_group_fn, group, x, positions,
                                    use_reentrant=False,
                                    context_fn=context_fn)
    return layers.rms_norm(x, model.final_ln, cfg.norm_eps)


def forward(model: DecoderLM, tokens, prefix_embed=None):
    """Full-vocab logits (B, P + S, V), teacher-forced."""
    return logits_fn(model, forward_hidden(model, tokens, prefix_embed))


def loss_fn(model: DecoderLM, tokens, labels, prefix_embed=None):
    """Mean cross-entropy over label positions, the logits taken
    ``cfg.loss_chunk`` positions at a time in f32, so (B, S, V) never
    exists at once. labels: (B, S_tok) int, -1 = ignore; the prefix's
    positions (modality stubs) carry no loss. Returns a 0-d f32 tensor
    (no host read)."""
    cfg = model.cfg
    hidden = forward_hidden(model, tokens, prefix_embed)
    if prefix_embed is not None:
        hidden = hidden[:, prefix_embed.shape[1]:]
    w = model.embed.T if cfg.tie_embeddings else model.unembed
    return chunked_ce(hidden, w, labels, cfg.loss_chunk)


def chunked_ce(hidden, w, labels, chunk: int):
    """Mean cross-entropy of the logits ``hidden @ w`` (w: (D, V)) over
    labels >= 0, ``chunk`` positions at a time in f32."""
    S = hidden.shape[1]
    C = min(chunk, S)
    tot = hidden.new_zeros((), dtype=torch.float32)
    cnt = torch.zeros((), dtype=torch.long, device=hidden.device)
    for a in range(0, S, C):
        lbl = labels[:, a:a + C].long()
        logits = torch.einsum("bsd,dv->bsv", hidden[:, a:a + C], w).float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, lbl.clamp_min(0)[..., None])[..., 0]
        valid = lbl >= 0
        tot = tot + torch.where(valid, lse - tgt, 0.0).sum()
        cnt = cnt + valid.sum()
    return tot / cnt.clamp_min(1)


# -------------------------------------------------------------- caches

def init_cache(cfg: ModelCfg, batch: int, max_len: int, device=None):
    """Decode cache in ``cfg.act_dtype`` (Mamba's ``h`` and RWKV6's
    ``wkv`` in f32). Attention caches hold W = min(max_len, window) kv
    slots; ring layout iff windowed and window < max_len. Mamba and RWKV6
    states are O(1) a token."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.act_dtype)
    W = max_len if cfg.window is None else min(max_len, cfg.window)
    G, D = cfg.n_groups, cfg.d_model

    def zeros(*shape, dt=dtype):
        return torch.zeros((G, batch, *shape), dtype=dt, device=dev)

    layers_c = {}
    for j, t in enumerate(cfg.pattern):
        if t == "a":
            shape = (cfg.n_kv_heads, W, cfg.hd)
            layers_c[f"pos{j}"] = dict(k=zeros(*shape), v=zeros(*shape))
        elif t == "m":
            di = cfg.ssm.expand * D
            layers_c[f"pos{j}"] = dict(
                conv=zeros(di, cfg.ssm.d_conv - 1),
                h=zeros(di, cfg.ssm.d_state, dt=torch.float32))
        else:
            hd = cfg.rwkv.head_dim
            layers_c[f"pos{j}"] = dict(
                shift_t=zeros(D), wkv=zeros(D // hd, hd, hd, dt=torch.float32),
                shift_c=zeros(D))
    cache = {"len": 0, "layers": layers_c}
    if W < max_len:
        cache["pos"] = torch.full((W,), -1, dtype=torch.int32, device=dev)
    return cache


def forward_with_cache(model: DecoderLM, cache, tokens, prefix_embed=None):
    """Shared prefill/decode forward. Returns (hidden, new_cache); the
    cache tensors are the same, updated in place. A prefix takes cache
    slots like tokens."""
    cfg = model.cfg
    x = _embed_inputs(model, tokens, prefix_embed)
    B, S = x.shape[:2]
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


def prefill(model: DecoderLM, tokens, max_len: int, prefix_embed=None):
    """Run the prompt (after ``prefix_embed``, when given) through the
    model, build the cache, return the last-position logits (B, 1, V)
    and the cache ready for :func:`decode_step`. ``max_len`` counts the
    prefix's slots."""
    cache = init_cache(model.cfg, tokens.shape[0], max_len,
                       device=model.device)
    hidden, cache = forward_with_cache(model, cache, tokens, prefix_embed)
    return logits_fn(model, hidden[:, -1:]), cache


def decode_step(model: DecoderLM, cache, tokens):
    """One decode step. tokens: (B, 1). Returns (logits (B, 1, V),
    cache)."""
    hidden, cache = forward_with_cache(model, cache, tokens)
    return logits_fn(model, hidden), cache
