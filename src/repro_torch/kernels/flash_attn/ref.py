"""Plain PyTorch version of the flash-attention kernel.

Counterpart of ``repro/kernels/flash_attn/ref.py:attention_ref`` with the
TPU kernel's (``repro/kernels/flash_attn/kernel.py:_attn_kernel``) and the
reference models' (``repro/models/layers.py:_chunk_attention``) treatment
of masked scores: their exponentials are zeroed, so a row whose every kv
slot is masked gives 0. ``attention_ref`` does not zero them and gives
the mean of ``v`` on such a row; rows with a visible slot agree.

Everything is computed in f32 (q scaled before the product, as the TPU
kernel does) and cast to ``q.dtype`` at the end. Scores are formed for
a few query rows at a time, so memory stays bounded at long sequences;
each row's softmax is exact over all its slots.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
# scores materialised at once: (B, Hq, rows, Skv) f32 entries
_SCORE_BUDGET = 1 << 27


def attention_plain(q, k, v, *, causal: bool, window=None, q_offset=None,
                    k_pos=None):
    """q: (B, Hq, Sq, d), k/v: (B, Hkv, Skv, d) -> (B, Hq, Sq, d).

    Query row i sits at absolute position ``q_offset + i`` (``None``:
    ``Skv - Sq``, the queries are the suffix of the kv sequence); kv slot
    t at ``k_pos[t]`` (``(Skv,)`` int, -1 = empty) or, without ``k_pos``,
    at t. A slot is visible to a query when its position is >= 0 and, if
    ``causal``, at or below the query's and, with a ``window``, above the
    query's minus ``window``. q head h reads kv head ``h // (Hq / Hkv)``.
    """
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"attention: {Hq} q heads over {Hkv} kv heads")
    if q_offset is None:
        q_offset = Skv - Sq
    dev = q.device
    group = Hq // Hkv
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    qf = q.float() * (1.0 / (d ** 0.5))
    kp = (torch.arange(Skv, device=dev) if k_pos is None
          else k_pos.to(device=dev, dtype=torch.long))
    rows = max(1, _SCORE_BUDGET // max(1, B * Hq * Skv))
    out = []
    for a in range(0, Sq, rows):
        qc = qf[:, :, a:a + rows]
        qp = q_offset + a + torch.arange(qc.shape[2], device=dev)
        mask = (kp >= 0)[None, :].expand(qc.shape[2], Skv)
        if causal:
            mask = mask & (kp[None, :] <= qp[:, None])
        if window is not None:
            mask = mask & (kp[None, :] > qp[:, None] - window)
        s = torch.einsum("bhqd,bhkd->bhqk", qc, kf)
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(s - m), 0.0)
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        out.append(torch.einsum("bhqk,bhkd->bhqd", p, vf) / l)
    return torch.cat(out, dim=2).to(q.dtype)
