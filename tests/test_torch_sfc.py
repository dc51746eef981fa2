"""Port parity: ``repro_torch.core.sfc`` against ``repro.core.sfc``.

The reference carries codes as uint32; the port carries them in int64
(values < 2^32, same order). Inputs are made once with numpy and fed to
both packages; codes must be bit-equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sfc as jsfc
from repro_torch.core import sfc

torch.set_num_threads(1)


@pytest.mark.parametrize("dim,bits", [(2, 16), (2, 10), (3, 10), (3, 7)])
@pytest.mark.parametrize("curve", ["morton", "hilbert"])
def test_encode_bit_equal(curve, dim, bits):
    rng = np.random.default_rng(dim * 100 + bits)
    coords = rng.integers(0, 1 << bits, size=(2000, dim)).astype(np.uint32)
    want = np.asarray(getattr(jsfc, f"{curve}_encode")(jnp.asarray(coords),
                                                       bits))
    got = getattr(sfc, f"{curve}_encode")(torch.as_tensor(
        coords.astype(np.int64)), bits)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert (got.numpy() >= 0).all() and (got.numpy() < 1 << 32).all()


@pytest.mark.parametrize("dim,bits", [(2, 8), (3, 6)])
def test_hilbert_decode_round_trip(dim, bits):
    codes = torch.arange(1 << (dim * bits), dtype=torch.int64)
    pts = sfc.hilbert_decode(codes, dim, bits)
    np.testing.assert_array_equal(sfc.hilbert_encode(pts, bits).numpy(),
                                  codes.numpy())
    # consecutive Hilbert codes are grid neighbours
    step = (pts[1:] - pts[:-1]).abs().sum(-1)
    assert (step == 1).all()
    np.testing.assert_array_equal(
        pts.numpy(), np.asarray(jsfc.hilbert_decode(
            jnp.asarray(codes.numpy().astype(np.uint32)), dim, bits)))


def test_codes_wider_than_32_bits_are_refused():
    with pytest.raises(ValueError, match="32 bits"):
        sfc.morton_encode(torch.zeros((4, 3), dtype=torch.int64), 11)
