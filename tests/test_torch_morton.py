"""Port parity: the Morton-encode op (``repro_torch.kernels.morton``)
against ``repro.kernels.morton``: its plain version equals the
reference's ``morton_encode_ref`` and the Pallas kernel in interpret
mode bit for bit, in 2D (bits 15 and 16) and 3D (bits 10), at
coord_bits 20 and 30, with coordinates at or above ``2^bits`` after the
shift and N not a multiple of the Pallas block (1024). The op takes the
plain version for CPU tensors without counting a launch, casts other
dtypes as the reference's ``astype(uint32)`` does, and refuses any
device but the CPU and the card."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.morton.kernel import morton_encode_pallas
from repro.kernels.morton.ref import morton_encode_ref
from repro_torch.kernels.morton import kernel as mk
from repro_torch.kernels.morton import ops

torch.set_num_threads(1)


@pytest.mark.parametrize("n,dim,bits,coord_bits,hi_bits", [
    (1500, 2, 15, 20, 20),     # zd's default: shift 5
    (3000, 2, 16, 30, 30),     # spac-z's default: shift 14
    (1025, 3, 10, 20, 20),
    (777, 3, 10, 30, 30),
    (900, 2, 15, 20, 24),      # coordinates >= 2^15 after the shift
    (1023, 3, 10, 20, 27),     # >= 2^10 after the shift (3D keeps 10)
    (600, 2, 16, 10, 31),      # no shift: all 31 bits reach the spread
])
def test_plain_matches_reference_and_pallas(n, dim, bits, coord_bits,
                                            hi_bits):
    rng = np.random.default_rng(n + dim)
    pts = rng.integers(0, 1 << hi_bits, (n, dim)).astype(np.int32)
    want = np.asarray(morton_encode_ref(jnp.asarray(pts), bits=bits,
                                        coord_bits=coord_bits))
    pallas = np.asarray(morton_encode_pallas(
        jnp.asarray(pts), bits=bits, coord_bits=coord_bits, interpret=True))
    before = mk.launch_count()
    got = ops.morton_encode(torch.as_tensor(pts), bits=bits,
                            coord_bits=coord_bits)
    assert mk.launch_count() == before   # the CPU takes the plain version
    assert got.dtype == torch.int64 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(got.numpy(), pallas.astype(np.int64))
    plain = ops.morton_encode_plain(torch.as_tensor(pts), bits=bits,
                                    coord_bits=coord_bits)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("dtype", [np.float32, np.int64, np.int16])
def test_other_dtypes_cast_as_the_reference(dtype):
    """Non-int32 points take the reference's ``astype(uint32)``."""
    rng = np.random.default_rng(7)
    if dtype == np.float32:
        pts = (rng.random((500, 2)) * (1 << 20)).astype(np.float32)
    else:
        pts = rng.integers(0, 1 << 15, (500, 2)).astype(dtype)
    want = np.asarray(morton_encode_ref(jnp.asarray(pts), bits=15,
                                        coord_bits=20))
    got = ops.morton_encode(torch.as_tensor(pts), bits=15, coord_bits=20)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_negative_int32_wraps_as_uint32():
    pts = np.array([[-1, 5], [-(1 << 31), 1 << 30], [7, -8]], np.int32)
    want = np.asarray(morton_encode_ref(jnp.asarray(pts), bits=16,
                                        coord_bits=16))
    got = ops.morton_encode(torch.as_tensor(pts), bits=16, coord_bits=16)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_wrapper_refuses_wide_codes_and_other_devices():
    with pytest.raises(ValueError, match="at most 32 bits"):
        ops.morton_encode(torch.zeros((4, 3), dtype=torch.int32), bits=15,
                          coord_bits=20)
    meta = torch.empty((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mk.morton_encode(meta, bits=15, coord_bits=20)
