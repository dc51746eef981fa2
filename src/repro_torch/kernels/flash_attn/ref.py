"""Plain PyTorch versions of the flash-attention kernel.

:func:`attention_plain` is the counterpart of
``repro/kernels/flash_attn/ref.py:attention_ref`` with the TPU kernel's
(``repro/kernels/flash_attn/kernel.py:_attn_kernel``) and the reference
models' (``repro/models/layers.py:_chunk_attention``) treatment of masked
scores: their exponentials are zeroed, so a row whose every kv slot is
masked gives 0. ``attention_ref`` does not zero them and gives the mean
of ``v`` on such a row; rows with a visible slot agree.

Everything is computed in f32 (q scaled before the product, as the TPU
kernel does) and cast to ``q.dtype`` at the end. Scores are formed for
a few query rows at a time, so memory stays bounded at long sequences;
each row's softmax is exact over all its slots.

:func:`attention_lse_plain` also returns each row's log-sum-exp, which
the training form's forward saves, and :func:`attention_bwd_plain` is
the backward kernel's (``csrc/flash_attn_bwd.cu``) arithmetic: the
gradients of :func:`attention_plain` from ``(q, k, v, o, lse, do)``, by
FlashAttention-2's recomputation of ``p`` from the saved log-sum-exp.

Beside them, plain mirrors of three CUDA designs' arithmetic, so the CPU
tests can hold each against :func:`attention_plain` or
:func:`attention_bwd_plain`: :func:`attention_split_plain` (``decode``:
the kv span cut into chunks, a softmax per chunk, the chunks merged in
order), :func:`attention_tc_plain` (``tc``: bf16 products summed in
f32, the scale after the product, an online softmax over 64-slot tiles,
and the weights ``p`` carried into the value product as bf16 hi + lo)
and :func:`attention_bwd_tc_plain` (the ``tc`` backward: the same
products, ``p`` and dS as bf16 hi + lo, in the kernels' tile order).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
# scores materialised at once: (B, Hq, rows, Skv) f32 entries
_SCORE_BUDGET = 1 << 27
# the tc variant's kv tile
TC_BLOCK = 64
# the tc backward's tile of rows streamed through its ring (query rows in
# dkdv, kv slots in dq)
TC_BWD_TILE = 64
LOG2E = 1.4426950408889634


def kv_span(Sq: int, Skv: int, q_offset: int, causal: bool, window,
            has_kpos: bool) -> tuple[int, int]:
    """The kv slots ``[lo, hi)`` that any of ``Sq`` queries at positions
    ``q_offset ..`` can see, when kv positions are slot indices (every
    slot under explicit positions). ``lo == hi`` when none."""
    lo, hi = 0, Skv
    if not has_kpos:
        if causal:
            hi = min(hi, q_offset + Sq)
        if window is not None:
            lo = max(0, q_offset - window + 1)
    return lo, max(lo, hi)


def _prepare(q, k, v, q_offset, k_pos):
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"attention: {Hq} q heads over {Hkv} kv heads")
    if q_offset is None:
        q_offset = Skv - Sq
    group = Hq // Hkv
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    kp = (torch.arange(Skv, device=q.device) if k_pos is None
          else k_pos.to(device=q.device, dtype=torch.long))
    return q_offset, kf, vf, kp


def _visible(kp, qp, causal: bool, window):
    """(rows, slots) mask of slots at positions ``kp`` that queries at
    positions ``qp`` see."""
    mask = (kp >= 0)[None, :].expand(qp.shape[0], kp.shape[0])
    if causal:
        mask = mask & (kp[None, :] <= qp[:, None])
    if window is not None:
        mask = mask & (kp[None, :] > qp[:, None] - window)
    return mask


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
    return _attention(q, k, v, causal, window, q_offset, k_pos)[0]


def attention_lse_plain(q, k, v, *, causal: bool, window=None,
                        q_offset=None):
    """:func:`attention_plain` and each row's log-sum-exp of its scaled
    visible scores, (B, Hq, Sq) f32: ``m + log(l)``, ``+inf`` on a row
    that sees no slot."""
    return _attention(q, k, v, causal, window, q_offset, None)


def _attention(q, k, v, causal, window, q_offset, k_pos):
    B, Hq, Sq, d = q.shape
    Skv = k.shape[2]
    q_offset, kf, vf, kp = _prepare(q, k, v, q_offset, k_pos)
    dev = q.device
    qf = q.float() * (1.0 / (d ** 0.5))
    rows = max(1, _SCORE_BUDGET // max(1, B * Hq * Skv))
    out, lse = [], []
    for a in range(0, Sq, rows):
        qc = qf[:, :, a:a + rows]
        qp = q_offset + a + torch.arange(qc.shape[2], device=dev)
        mask = _visible(kp, qp, causal, window)
        s = torch.einsum("bhqd,bhkd->bhqk", qc, kf)
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(s - m), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        out.append(torch.einsum("bhqk,bhkd->bhqd", p, vf)
                   / l.clamp_min(1e-30))
        lse.append(torch.where(l > 0, m + torch.log(l), torch.inf)[..., 0])
    return torch.cat(out, dim=2).to(q.dtype), torch.cat(lse, dim=2)


def attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool, window=None,
                        q_offset=None):
    """Gradients ``(dq, dk, dv)`` of :func:`attention_plain` (the kernels
    take ``q_offset = 0``: self attention at ``Sq == Skv``, and cross
    attention at any ``Sq`` and ``Skv``, non-causal without a window) at
    ``do``, from the forward's output ``o`` and ``lse``, each in
    its input's dtype, by the backward kernel's arithmetic in f32: q
    scaled before the products; ``p = exp(s - lse)`` on visible slots, 0
    elsewhere; ``D = rowsum(do * o)`` from the forward's output ``o``;
    ``dp = do v^T``, ``ds = p (dp - D)``; ``dv = p^T do`` and ``dk = ds^T
    (q * scale)`` summed over the q heads of each kv head's group, ``dq =
    ds k * scale``."""
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    q_offset, kf, vf, kp = _prepare(q, k, v, q_offset, None)
    dev = q.device
    scale = 1.0 / (d ** 0.5)
    qs = q.float() * scale
    dof = do.float()
    delta = (dof * o.float()).sum(dim=-1)
    dq = torch.empty((B, Hq, Sq, d), device=dev)
    dk = torch.zeros((B, Hq, Skv, d), device=dev)
    dv = torch.zeros((B, Hq, Skv, d), device=dev)
    rows = max(1, _SCORE_BUDGET // max(1, B * Hq * Skv))
    for a in range(0, Sq, rows):
        sl = slice(a, a + rows)
        qp = q_offset + a + torch.arange(qs[:, :, sl].shape[2], device=dev)
        mask = _visible(kp, qp, causal, window)
        s = torch.einsum("bhqd,bhkd->bhqk", qs[:, :, sl], kf)
        p = torch.where(mask, torch.exp(s - lse[:, :, sl, None]), 0.0)
        dp = torch.einsum("bhqd,bhkd->bhqk", dof[:, :, sl], vf)
        ds = p * (dp - delta[:, :, sl, None])
        dv += torch.einsum("bhqk,bhqd->bhkd", p, dof[:, :, sl])
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, qs[:, :, sl])
        dq[:, :, sl] = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    group = Hq // Hkv
    dk = dk.view(B, Hkv, group, Skv, d).sum(dim=2)
    dv = dv.view(B, Hkv, group, Skv, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_split_plain(q, k, v, *, chunk: int, causal: bool,
                          window=None, q_offset=None, k_pos=None):
    """:func:`attention_plain`'s function by the ``decode`` variant's
    arithmetic: the kv span (:func:`kv_span`) is cut into chunks of
    ``chunk`` slots from its first slot; each chunk gives (m, l, acc)
    relative to its own row maxima (m >= -1e30, so a chunk whose every
    slot is masked gives l = 0, acc = 0); the chunks are merged in order
    with weights exp(m_i - max m)."""
    B, Hq, Sq, d = q.shape
    Skv = k.shape[2]
    q_offset, kf, vf, kp = _prepare(q, k, v, q_offset, k_pos)
    dev = q.device
    qf = q.float() * (1.0 / (d ** 0.5))
    qp = q_offset + torch.arange(Sq, device=dev)
    lo, hi = kv_span(Sq, Skv, q_offset, causal, window, k_pos is not None)
    parts = []
    for s0 in range(lo, max(hi, lo + 1), chunk):
        sl = slice(s0, min(s0 + chunk, hi))
        mask = _visible(kp[sl], qp, causal, window)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, sl])
        s = torch.where(mask, s, float("-inf"))
        m = torch.full((B, Hq, Sq, 1), NEG_INF, device=dev)
        if s.shape[-1]:
            m = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m)
        parts.append((m, p.sum(dim=-1, keepdim=True),
                      torch.einsum("bhqk,bhkd->bhqd", p, vf[:, :, sl])))
    mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    num = torch.zeros((B, Hq, Sq, d), device=dev)
    den = torch.zeros((B, Hq, Sq, 1), device=dev)
    for m, l, acc in parts:
        w = torch.exp(m - mx)
        den = den + l * w
        num = num + acc * w
    return (num / den.clamp_min(1e-30)).to(q.dtype)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def attention_tc_plain(q, k, v, *, causal: bool, window=None,
                       q_offset=None, k_pos=None):
    """:func:`attention_plain`'s function by the ``tc`` variant's
    arithmetic: q and k (bf16 values) multiplied exactly and summed in
    f32, the scale applied to the f32 scores, an online softmax over
    kv tiles of 64 slots, and the value product fed ``p`` as
    ``hi = bf16(p)`` plus ``lo = bf16(p - hi)`` (about 16 significant
    bits) against bf16 ``v``, summed in f32."""
    B, Hq, Sq, d = q.shape
    Skv = k.shape[2]
    q_offset, kf, vf, kp = _prepare(q, k, v, q_offset, k_pos)
    dev = q.device
    scale = 1.0 / (d ** 0.5)
    qb, kb, vb = _bf16(q), _bf16(kf), _bf16(vf)
    qp = q_offset + torch.arange(Sq, device=dev)
    lo, hi = kv_span(Sq, Skv, q_offset, causal, window, k_pos is not None)
    m = torch.full((B, Hq, Sq, 1), NEG_INF, device=dev)
    l = torch.zeros((B, Hq, Sq, 1), device=dev)
    acc = torch.zeros((B, Hq, Sq, d), device=dev)
    for t0 in range(lo - lo % TC_BLOCK, hi, TC_BLOCK):
        sl = slice(t0, min(t0 + TC_BLOCK, Skv))
        s = torch.einsum("bhqd,bhkd->bhqk", qb, kb[:, :, sl]) * scale
        s = torch.where(_visible(kp[sl], qp, causal, window), s,
                        float("-inf"))
        mx = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - mx)
        p = torch.exp(s - mx)
        p_hi = _bf16(p)
        p_lo = _bf16(p - p_hi)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = (acc * alpha
               + torch.einsum("bhqk,bhkd->bhqd", p_hi, vb[:, :, sl])
               + torch.einsum("bhqk,bhkd->bhqd", p_lo, vb[:, :, sl]))
        m = mx
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def _hi_lo(x, split: bool):
    """``x`` as the value products take it: ``hi = bf16(x)`` plus ``lo
    = bf16(x - hi)`` (``split``), or ``hi`` alone; f32 tensors holding
    bf16 values."""
    hi = _bf16(x)
    return (hi, _bf16(x - hi)) if split else (hi,)


def attention_bwd_tc_plain(q, k, v, o, lse, do, *, causal: bool,
                           window=None, split: bool = True):
    """:func:`attention_bwd_plain`'s function (the training forms, queries
    at ``q_offset`` 0: ``Sq == Skv``, or any ``Sq`` and ``Skv``
    non-causal without a window) by the ``tc`` backward kernels' arithmetic
    (``csrc/flash_attn_bwd.cu``): bf16 operands multiplied exactly and
    summed in f32; ``D = rowsum(do * o)`` in f32; scores unscaled, ``p =
    2^(s * scale * log2 e - lse * log2 e)`` on visible pairs; ``dS = p
    (dP - D)``; ``p`` and ``dS`` enter the value products as bf16 hi + lo
    (``split``; ``False`` tries a single bf16); the scale applied to dK
    and dQ at the end. Tile order as the kernels take it: dK and dV sum
    over the q heads of each kv head's group, and over each head's query
    tiles of ``TC_BWD_TILE`` rows in order; dQ over kv tiles of
    ``TC_BWD_TILE`` slots in order."""
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    scale = 1.0 / (d ** 0.5)
    sl2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    qb, kb, vb, dob = (_bf16(t) for t in (q, k, v, do))
    delta = (do.float() * o.float()).sum(dim=-1)
    lse2 = lse.float() * torch.tensor(LOG2E, dtype=torch.float32)
    qpos = torch.arange(Sq, device=dev)
    kpos = torch.arange(Skv, device=dev)
    T = TC_BWD_TILE

    def grads(rows, cols, qg, dog, kg, vg, lg, dg):
        """p and dS of query rows ``rows`` against kv slots ``cols``."""
        s = torch.einsum("bhqd,bhkd->bhqk", qg[:, :, rows], kg[:, :, cols])
        p = torch.exp2(s * sl2 - lg[:, :, rows, None])
        p = torch.where(_visible(kpos[cols], qpos[rows], causal, window), p,
                        0.0)
        dp = torch.einsum("bhqd,bhkd->bhqk", dog[:, :, rows], vg[:, :, cols])
        return p, p * (dp - dg[:, :, rows, None])

    dk = torch.zeros((B, Hkv, Skv, d), device=dev)
    dv = torch.zeros((B, Hkv, Skv, d), device=dev)
    for g in range(G):  # head hk * G + g of each kv head hk
        heads = slice(g, Hq, G)
        qg, dog = qb[:, heads], dob[:, heads]
        lg, dg = lse2[:, heads], delta[:, heads]
        for q0 in range(0, Sq, T):
            rows = slice(q0, q0 + T)
            p, ds = grads(rows, slice(0, Skv), qg, dog, kb, vb, lg, dg)
            for part in _hi_lo(p, split):
                dv += torch.einsum("bhqk,bhqd->bhkd", part, dog[:, :, rows])
            for part in _hi_lo(ds, split):
                dk += torch.einsum("bhqk,bhqd->bhkd", part, qg[:, :, rows])
    kf = kb.repeat_interleave(G, dim=1)
    vf = vb.repeat_interleave(G, dim=1)
    dq = torch.zeros((B, Hq, Sq, d), device=dev)
    for t0 in range(0, Skv, T):
        cols = slice(t0, t0 + T)
        _, ds = grads(slice(0, Sq), cols, qb, dob, kf, vf, lse2, delta)
        for part in _hi_lo(ds, split):
            dq += torch.einsum("bhqk,bhkd->bhqd", part, kf[:, :, cols])
    return ((dq * scale).to(q.dtype), (dk * scale).to(k.dtype),
            dv.to(v.dtype))
