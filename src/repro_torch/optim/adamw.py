"""AdamW + cosine schedule + global-norm clipping (hand-rolled, no
``torch.optim``), counterpart of ``repro/optim/adamw.py``.

Parameters, gradients and moments are dicts of tensors keyed by the
model's parameter names (``dict(model.named_parameters())``). The
arithmetic is the reference's, in its order: f32 math, the clip scale,
the bias corrections, decoupled weight decay, the cast back to the
parameter's dtype (``torch.optim.AdamW`` orders the terms differently),
each step as one ``torch._foreach_*`` call over a group of tensors: the
groups run in turn, each at most ``GROUP_BYTES`` of f32 parameters, so
the f32 temporaries stay bounded (over all of a 3 B-parameter model at
once they ran the 80 GB card out of memory); the global norm is taken
over every gradient first.
Moments are f32 by default whatever the parameters' dtype. Unlike the
reference, :func:`adamw_update` writes the new parameters, moments and
step into the tensors it is given (``torch.no_grad``), and returns them.
The step, the learning rate and the norm stay on the device (0-d
tensors): nothing is read back.
"""

from __future__ import annotations

import dataclasses
import math

import torch

# f32 bytes of parameters a group of the update's foreach calls (a larger
# tensor is a group alone)
GROUP_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class OptCfg:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def cosine_lr(step, cfg: OptCfg):
    """The learning rate at ``step`` (an int tensor, or a number), a 0-d
    f32 tensor: linear warm-up, then cosine decay to ``min_lr_frac``."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def adamw_init(params: dict, moment_dtype=torch.float32) -> dict:
    """Zero moments (``moment_dtype=torch.bfloat16`` halves their bytes)
    and step 0, on the parameters' device."""
    dev = next(iter(params.values())).device
    return {
        "m": {k: torch.zeros(p.shape, dtype=moment_dtype, device=dev)
              for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=moment_dtype, device=dev)
              for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))


@torch.no_grad()
def adamw_update(grads: dict, state: dict, params: dict, cfg: OptCfg):
    """Returns ``(params, state, metrics)``, ``params`` and ``state``
    (``m``, ``v``, ``step``) updated in place; metrics ``lr`` and
    ``grad_norm`` are 0-d tensors. Each elementwise step runs over a
    group of tensors at once (``torch._foreach_*``: a few launches a
    group instead of one a tensor; :func:`_groups`), with the
    reference's operations in its order."""
    keys = list(params)
    step = state["step"] + 1
    lr = cosine_lr(step, cfg)
    gnorm = global_norm(grads[k] for k in keys)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()
    for group in _groups(keys, params):
        _update(group, grads, state, params, cfg, scale, bc1, bc2, lr)
    state["step"].copy_(step)
    return params, state, {"lr": lr, "grad_norm": gnorm}


def _groups(keys, params):
    """``keys`` in order, cut into runs of at most ``GROUP_BYTES`` of f32
    parameters."""
    group, size = [], 0
    for k in keys:
        n = 4 * params[k].numel()
        if group and size + n > GROUP_BYTES:
            yield group
            group, size = [], 0
        group.append(k)
        size += n
    if group:
        yield group


def _update(keys, grads, state, params, cfg, scale, bc1, bc2, lr):
    """The update of the tensors of ``keys``, each step one foreach call
    over them."""
    p32 = [params[k].float() for k in keys]
    m, v = [state["m"][k] for k in keys], [state["v"][k] for k in keys]
    mul, add, div = torch._foreach_mul, torch._foreach_add, torch._foreach_div
    g = mul([grads[k].float() for k in keys], scale)
    m32 = add(mul([x.float() for x in m], cfg.b1), mul(g, 1 - cfg.b1))
    v32 = add(mul([x.float() for x in v], cfg.b2),
              mul(mul(g, 1 - cfg.b2), g))
    del g
    u = div(div(m32, bc1),
            add(torch._foreach_sqrt(div(v32, bc2)), cfg.eps))
    u = add(u, mul(p32, cfg.weight_decay))
    torch._foreach_copy_([params[k] for k in keys],
                         torch._foreach_sub(p32, mul(u, lr)))
    torch._foreach_copy_(m, m32)
    torch._foreach_copy_(v, v32)
