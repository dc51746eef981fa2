"""Tile defaults for the frontier walk: impl -> (block_q, block_p).

``block_p`` is a point budget per group; prep rounds it to whole rows
(``block_r = block_p // C``). The ``cuda`` entry is a first pick, not a
sweep: 32 queries is one query a lane of each walker warp (the kernel
takes at most 32), and 512 points is 8 leaf rows of C = 64, whose flags a
warp reads with one 16-byte load a lane. The ``plain`` entry keeps the
reference's CPU tiles: small query blocks keep the early exit tight.
"""

from __future__ import annotations

_DEFAULT_TILES = {
    "plain": (8, 512),
    "cuda": (32, 512),
}


def tiles(impl: str, block_q=None, block_p=None):
    """Resolve (block_q, block_p), honoring explicit overrides."""
    dq, dp = _DEFAULT_TILES[impl]
    return int(block_q or dq), int(block_p or dp)
