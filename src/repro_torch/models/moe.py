"""Mixture-of-Experts with capacity-based sort dispatch, counterpart of
``repro/models/moe.py``'s dense-dispatch path (``_moe_group``).

Tokens are processed in groups of ``cfg.moe_group``, in turn. In a group
each (token, choice) pair is ranked within its expert (a stable sort by
expert); the first C = ``max(1, int(Tg K capacity_factor / E))`` pairs of
each expert survive and the rest are dropped, exactly as the reference
drops them (at decode with a batch of 8, C is 1). Survivors are copied
into an (E C + 1, D) buffer whose last row catches the dropped pairs and
is cut off, the expert products are batched matrix products, and each
token sums its experts' outputs weighted by its renormalised router
probabilities.

The reference's manual expert-parallel path (``_moe_shard_map``) runs
only under a mesh with a "model" axis; on one card it takes this path,
and its counterpart waits for the sharding layer (ROADMAP queue 1, item
5.3). Nothing here reads a device value back: capacity is a host int.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import _normal, rms_norm


def _route(xg, wr, K: int):
    """Router: (topw (Tg, K) renormalised, in ``xg``'s dtype; topi (Tg, K)
    int64). Ties between equal probabilities go to the lowest expert
    index, as ``jax.lax.top_k`` breaks them (``torch.topk`` promises no
    order): a stable descending sort keeps equal values in index order."""
    logits = torch.einsum("td,de->te", xg, wr).float()
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :K], topi[:, :K]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return topw.to(xg.dtype), topi


def _rank_in_expert(flat_e):
    """Stable rank of each pair within its expert bucket: a stable sort by
    expert, then each sorted position less the start of its run (the
    running maximum of run starts)."""
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    idx = torch.arange(n, device=flat_e.device)
    change = torch.ones(n, dtype=torch.bool, device=flat_e.device)
    change[1:] = sorted_e[1:] != sorted_e[:-1]
    first = torch.cummax(torch.where(change, idx, 0), dim=0).values
    rank = torch.empty_like(idx)
    rank[order] = idx - first
    return rank


def _expert_ffn(xe, p):
    """xe: (E, C, D) -> (E, C, D), each expert's SwiGLU as batched
    products."""
    h1 = torch.bmm(xe, p["w1"])
    h3 = torch.bmm(xe, p["w3"])
    return torch.bmm(F.silu(h1) * h3, p["w2"])


def _moe_group(xg, p, moe):
    """Dense-dispatch path. xg: (Tg, D) -> (Tg, D)."""
    Tg, D = xg.shape
    E, K = moe.n_experts, moe.top_k
    C = max(1, int(Tg * K * moe.capacity_factor / E))

    topw, topi = _route(xg, p["wr"], K)
    flat_e = topi.reshape(-1)                                # (Tg*K,)
    rank = _rank_in_expert(flat_e)
    keep = rank < C
    slot = torch.where(keep, flat_e * C + rank, E * C)       # E*C => drop
    tok = torch.arange(Tg * K, device=xg.device) // K
    xe = xg.new_zeros((E * C + 1, D)).index_copy(0, slot, xg[tok])
    ye = _expert_ffn(xe[:-1].reshape(E, C, D), p).reshape(E * C, D)
    safe = torch.clamp(slot, max=E * C - 1)
    yk = torch.where(keep[:, None], ye[safe], 0).reshape(Tg, K, D)
    return torch.einsum("tk,tkd->td", topw, yk)


def moe_block(x, p, cfg):
    """x: (B, S, D), residual included."""
    B, S, D = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    T = B * S
    Tg = min(cfg.moe_group, T)
    hf = h.reshape(T, D)
    n_groups = (T + Tg - 1) // Tg
    pad = n_groups * Tg - T
    if pad:
        hf = torch.cat([hf, hf.new_zeros((pad, D))])
    y = torch.cat([_moe_group(g, p, cfg.moe)
                   for g in hf.split(Tg)])[:T]
    return x + y.reshape(B, S, D)


def init_moe(generator, cfg, dtype, device):
    """The reference's ``init_moe`` tree from ``generator``: router
    N(0, 1/D), expert weights N(0, 1/D) in and N(0, 1/F) out."""
    moe, D = cfg.moe, cfg.d_model
    E, F_ = moe.n_experts, moe.d_ff
    return dict(
        ln=torch.ones((D,), dtype=dtype, device=device),
        wr=_normal(generator, (D, E), D ** -0.5, dtype, device),
        w1=_normal(generator, (E, D, F_), D ** -0.5, dtype, device),
        w3=_normal(generator, (E, D, F_), D ** -0.5, dtype, device),
        w2=_normal(generator, (E, F_, D), F_ ** -0.5, dtype, device),
    )
