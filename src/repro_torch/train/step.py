"""train_step factory: loss -> grads -> (compressed) update, the
counterpart of ``repro/train/step.py``.

Features, flags in :class:`TrainCfg`:

  * microbatch gradient accumulation -- the batch splits into
    ``n_microbatch`` slices run in turn; gradients accumulate in
    ``accum_dtype`` (f32);
  * int8 gradient compression with error feedback -- each gradient
    quantizes to int8 (per-tensor max scale); the residual is carried in
    the optimizer state (``ef``) and added back the next step;
  * AdamW (:mod:`repro_torch.optim.adamw`).

The reference pins each gradient to its ZeRO sharding the moment it
exists (``_grad_specs``) so that GSPMD reduce-scatters it; on one card
there is nothing to shard and the port has no counterpart (ROADMAP queue
1, item 5.3, the sharding layer).

Models, as the reference's ``_model_loss`` picks them: the decoder LMs
(``DecoderLM(..., train=True)``; ``batch`` holds ``tokens`` and
``labels``), the frontend archs (the same, with the ``adapter`` and
``batch["prefix"]``'s patch or frame embeddings before the tokens) and
the encoder-decoder (``EncDecLM(..., train=True)``, ``batch["prefix"]``
the encoder's frame embeddings).

State: the port's parameters are the model's and the optimizer state is
a dict of tensors keyed by parameter name (``m``, ``v``, ``step``, and ``ef`` with compression).
A step updates both in place and returns them. It changes nothing until
every gradient exists, so a step that raises before its update (a
preempted node, a failed launch) leaves the state it failed on, and the
fault-tolerant loop retries from it. :func:`state_tree` gives the state
as the reference's ``{"params": ..., "opt": ...}`` tree (the checkpoint's
leaf keys) and :func:`load_state_tree` takes one back.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import resolve_device
from ..models import encdec, transformer
from ..models.config import ModelCfg
from ..optim.adamw import OptCfg, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    n_microbatch: int = 1
    compress_grads: bool = False
    moment_dtype: str = "float32"   # bf16 halves optimizer bytes
    accum_dtype: str = "float32"    # microbatch gradient accumulator
    opt: OptCfg = dataclasses.field(default_factory=OptCfg)


# ---------------------------------------------------- grad compression

def quantize_int8(x):
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_with_ef(grads: dict, ef: dict):
    """int8-quantize each gradient, carrying the residual in ``ef`` (f32).
    Returns new dicts ``(grads, ef)``."""
    new_g, new_ef = {}, {}
    for k, g in grads.items():
        g32 = g.float() + ef[k]
        q, scale = quantize_int8(g32)
        deq = q.float() * scale
        new_g[k] = deq.to(g.dtype)
        new_ef[k] = g32 - deq
    return new_g, new_ef


# ------------------------------------------------------------ factory

def _model_loss(cfg: ModelCfg):
    """``loss(model, batch)`` for ``cfg``'s kind: the encoder-decoder's
    over ``batch["prefix"]`` frames, a frontend arch's with
    ``batch["prefix"]`` before the tokens, a decoder LM's."""
    if cfg.kind == "encdec":
        def loss(model, batch):
            return encdec.loss_fn(model, batch["prefix"], batch["tokens"],
                                  batch["labels"])
    elif cfg.frontend is not None:
        def loss(model, batch):
            return transformer.loss_fn(model, batch["tokens"],
                                       batch["labels"],
                                       prefix_embed=batch["prefix"])
    else:
        def loss(model, batch):
            return transformer.loss_fn(model, batch["tokens"],
                                       batch["labels"])
    return loss


def _check_model(model, cfg: ModelCfg) -> None:
    if model.cfg != cfg:
        raise ValueError(f"train step: the model is {model.cfg.name}'s "
                         f"config, not the step's ({cfg.name})")


def init_train_state(seed, cfg: ModelCfg, tcfg: TrainCfg, device=None):
    """``(model, opt_state)``: ``EncDecLM(cfg, train=True)`` for the
    encoder-decoder, ``DecoderLM(cfg, train=True)`` (with its ``adapter``
    for a frontend arch) otherwise, weights drawn from ``seed`` (an int,
    or a ``torch.Generator`` on the device), zero moments in
    ``tcfg.moment_dtype``, and ``ef`` zeros (f32) when gradients are
    compressed. ``device=None`` means the card."""
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator(device=dev).manual_seed(int(seed))
    build = encdec.EncDecLM if cfg.kind == "encdec" else \
        transformer.DecoderLM
    model = build(cfg, device=dev, generator=gen, train=True)
    params = dict(model.named_parameters())
    opt = adamw_init(params, getattr(torch, tcfg.moment_dtype))
    if tcfg.compress_grads:
        opt["ef"] = {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for k, p in params.items()}
    return model, opt


def _value_and_grad(model, batch, loss_fn=None):
    """``(loss, {name: gradient})`` of ``loss_fn(model, batch)`` (default:
    the model's own kind's loss)."""
    loss_fn = loss_fn or _model_loss(model.cfg)
    params = dict(model.named_parameters())
    loss = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def make_train_step(cfg: ModelCfg, tcfg: Optional[TrainCfg] = None):
    """Returns ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``; ``batch`` holds ``tokens`` and ``labels`` (B, S) int and,
    for the encoder-decoder and the frontend archs, ``prefix`` (B, P,
    ``frontend_dim``); microbatching splits every entry along B. Metrics
    ``loss``, ``lr`` and ``grad_norm`` are 0-d tensors."""
    tcfg = tcfg or TrainCfg()
    loss_fn = _model_loss(cfg)

    def train_step(model, opt_state, batch):
        _check_model(model, cfg)
        n = tcfg.n_microbatch
        if n == 1:
            loss, grads = _value_and_grad(model, batch, loss_fn)
        else:
            micro = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])
                     for k, v in batch.items()}
            acc_dt = getattr(torch, tcfg.accum_dtype)
            dev = batch["tokens"].device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = {k: torch.zeros(p.shape, dtype=acc_dt, device=dev)
                     for k, p in model.named_parameters()}
            for i in range(n):
                li, gi = _value_and_grad(
                    model, {k: v[i] for k, v in micro.items()}, loss_fn)
                grads = {k: g + gi[k].to(acc_dt) for k, g in grads.items()}
                loss = loss + li
            loss = loss / n
            grads = {k: g / n for k, g in grads.items()}

        ef = None
        if tcfg.compress_grads:
            grads, ef = compress_with_ef(grads, opt_state["ef"])
        _, _, metrics = adamw_update(grads, opt_state,
                                     dict(model.named_parameters()),
                                     tcfg.opt)
        if ef is not None:
            for k, e in ef.items():
                opt_state["ef"][k].copy_(e)
        metrics["loss"] = loss
        return model, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelCfg):
    """Returns ``eval_step(model, batch) -> loss`` (no gradients)."""
    loss_fn = _model_loss(cfg)

    @torch.no_grad()
    def eval_step(model, batch):
        _check_model(model, cfg)
        return loss_fn(model, batch)

    return eval_step


# ------------------------------------------------- checkpointable state

def state_tree(model, opt_state) -> dict:
    """The training state as the reference's ``{"params": ...,
    "opt": {"m", "v", "step"[, "ef"]}}`` tree: parameters and moments
    with the group (or encoder and decoder layer) axis stacked
    (:func:`transformer.reference_tree`, copies on the device)."""
    params = {k: p.detach() for k, p in model.named_parameters()}
    opt = {k: transformer.reference_tree(v) if isinstance(v, dict) else v
           for k, v in opt_state.items()}
    return {"params": transformer.reference_tree(params), "opt": opt}


@torch.no_grad()
def load_state_tree(model, opt_state, tree) -> None:
    """Copy a :func:`state_tree`-shaped tree (tensors or numpy arrays)
    into ``model`` and ``opt_state`` in place."""
    names = [k for k, _ in model.named_parameters()]
    for k, src in transformer.from_reference_tree(tree["params"],
                                                   names).items():
        _copy(model.get_parameter(k), src)
    for key, dst in opt_state.items():
        if isinstance(dst, dict):
            src = transformer.from_reference_tree(tree["opt"][key], names)
            for k, t in dst.items():
                _copy(t, src[k])
        else:
            _copy(dst, tree["opt"][key])


def _copy(dst, src) -> None:
    src = torch.as_tensor(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"train state: shape {tuple(src.shape)} does not "
                         f"fit {tuple(dst.shape)}")
    dst.copy_(src)
