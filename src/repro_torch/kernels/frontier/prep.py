"""Host-side prep for the frontier kernel and its plain version.

Counterpart of ``repro/kernels/frontier/prep.py:prepare``. The group
bounding boxes, the query Morton key and its stable sort, ``inv``,
``order`` and ``glb`` are bit-equal to the reference's. The reference
also builds a copy of every point centered on its group (for the TPU's
centered MXU identity) on every query batch; the port's kernel computes
the direct ``(q - p)^2`` and reads the tree's own ``(R, C, D)`` points,
so that copy is gone.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BIG = 3.4e38

_MORTON_BITS = 10  # 10 bits/dim -> <= 30-bit codes for D <= 3


def morton_key(q: torch.Tensor, bits: int = _MORTON_BITS) -> torch.Tensor:
    """Quantized Morton code per query (int64), for spatial blocking:
    queries are sorted by it before being cut into ``block_q`` blocks."""
    qf = q.float()
    lo = qf.amin(dim=0)
    span = torch.clamp_min(qf.amax(dim=0) - lo, 1e-30)
    top = float((1 << bits) - 1)
    cell = torch.clamp((qf - lo) / span * top, 0.0, top).to(torch.int64)
    code = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    dim = q.shape[1]
    for b in range(bits):
        for d in range(dim):
            code = code | (((cell[:, d] >> b) & 1) << (b * dim + d))
    return code


class FrontierPrep(NamedTuple):
    """Kernel-ready operands; see :func:`prepare` for shapes."""

    qs: torch.Tensor      # (Qp, D) f32 sorted + padded queries
    order: torch.Tensor   # (nqb, G) int32 group visit order per block
    glb: torch.Tensor     # (nqb, G) f32 group lower bounds, ascending
    inv: torch.Tensor     # (Q,) int64, undoes the query sort
    block_q: int
    block_r: int          # leaf rows per group
    points_per_group: int


def prepare(pts, valid, active, bbox_lo, bbox_hi, queries, *,
            block_q: int, block_p: int) -> FrontierPrep:
    """Group rows ``block_r = max(1, block_p // C)`` at a time and order
    the groups per query block by their bbox lower bound.

    Group ``g`` is rows ``[g * block_r, (g + 1) * block_r)``, so the
    flat id of slot ``o`` in it is ``g * P + o`` -- the engine's
    ``row * C + col`` id space. ``valid`` is unused here (the kernel
    reads it per slot) but kept so the signature matches the
    reference's."""
    del valid
    R, C, D = pts.shape
    dev = pts.device
    block_r = max(1, block_p // C)
    P = block_r * C
    G = -(-R // block_r)
    pad_r = G * block_r - R

    lo_f = torch.where(active[:, None], bbox_lo.float(), BIG)
    hi_f = torch.where(active[:, None], bbox_hi.float(), -BIG)
    if pad_r:
        lo_f = torch.cat([lo_f, torch.full((pad_r, D), BIG, device=dev)])
        hi_f = torch.cat([hi_f, torch.full((pad_r, D), -BIG, device=dev)])
    glo = lo_f.reshape(G, block_r, D).amin(dim=1)           # (G, D)
    ghi = hi_f.reshape(G, block_r, D).amax(dim=1)
    galive = glo[:, 0] <= ghi[:, 0]

    Q = queries.shape[0]
    qf = queries.float()
    perm = torch.argsort(morton_key(qf), stable=True)
    inv = torch.argsort(perm, stable=True)
    qs = qf[perm]
    nqb = -(-Q // block_q)
    pad_q = nqb * block_q - Q
    if pad_q:
        # pad with the *last* sorted query so the tail block stays tight
        qs = torch.cat([qs, qs[-1:].expand(pad_q, D)])

    qb = qs.reshape(nqb, block_q, D)
    blo, bhi = qb.amin(dim=1), qb.amax(dim=1)               # (nqb, D)
    gap = torch.clamp_min(torch.maximum(glo[None] - bhi[:, None],
                                        blo[:, None] - ghi[None]), 0.0)
    lb = gap[..., 0] * gap[..., 0]
    for d in range(1, D):
        lb = lb + gap[..., d] * gap[..., d]
    glb = torch.where(galive[None, :], lb, BIG)
    order = torch.argsort(glb, dim=1, stable=True)
    glb = glb.gather(1, order)
    return FrontierPrep(qs=qs.contiguous(), order=order.int().contiguous(),
                        glb=glb.contiguous(), inv=inv, block_q=block_q,
                        block_r=block_r, points_per_group=P)
