"""The port's attention against the JAX package's, on the same numpy
inputs: ``attention_plain`` (what ``repro_torch``'s ``flash_attention``
runs for CPU tensors) against the Pallas kernel in interpret mode on the
cases of ``tests/test_kernels.py`` (f32 at 2e-5, bf16 at 2e-2, the
reference's own bars), against the reference models'
``_chunk_attention`` in its ``(q_offset, kv_len, k_positions)`` form,
and the dispatch rules of the port's wrappers on the CPU."""

from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import ops as jops
from repro.kernels.flash_attn.ref import attention_ref
from repro.models import layers as jlayers
from repro_torch.kernels.flash_attn import kernel as fk
from repro_torch.kernels.flash_attn import ops
from repro_torch.kernels.flash_attn.ref import attention_plain
from repro_torch.models import layers

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(seed, B, Hq, Hkv, Sq, Skv, d, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, Hq, Sq, d), (B, Hkv, Skv, d), (B, Hkv, Skv, d))]
    if dtype == "bfloat16":
        arrs = [a.astype(ml_dtypes.bfloat16) for a in arrs]
    return arrs


def _torch(arrs, dtype):
    return [torch.from_numpy(a.astype(np.float32)).to(TORCH[dtype])
            for a in arrs]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,d", [
    (1, 2, 2, 64, 64, 32),     # MHA square
    (2, 4, 2, 64, 64, 32),     # GQA
    (1, 4, 1, 32, 128, 16),    # MQA decode-ish (suffix queries)
    (1, 2, 2, 48, 80, 32),     # ragged (non-multiple of block)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel(B, Hq, Hkv, Sq, Skv, d, dtype):
    arrs = _qkv(0, B, Hq, Hkv, Sq, Skv, d, dtype)
    want = jops.attention(*map(jnp.asarray, arrs), causal=True,
                          impl="interpret", block_q=32, block_k=32)
    got = attention_plain(*_torch(arrs, dtype), causal=True)
    assert got.dtype == TORCH[dtype] and got.shape == (B, Hq, Sq, d)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("window", [16, 64])
def test_plain_sliding_window(window):
    arrs = _qkv(1, 1, 2, 2, 96, 96, 32)
    want = jops.attention(*map(jnp.asarray, arrs), causal=True,
                          window=window, impl="interpret", block_q=32,
                          block_k=32)
    got = ops.flash_attention(*_torch(arrs, "float32"), causal=True,
                              window=window)
    _close(got, want, 2e-5)


def test_plain_non_causal():
    arrs = _qkv(2, 1, 2, 2, 64, 64, 32)
    want = jops.attention(*map(jnp.asarray, arrs), causal=False,
                          impl="interpret", block_q=32, block_k=32)
    got = ops.attention_plain(*_torch(arrs, "float32"), causal=False)
    _close(got, want, 2e-5)


def test_fully_masked_rows_give_zero_as_the_pallas_kernel():
    # Sq=4 queries on Skv=2 slots, causal: queries 0 and 1 sit at
    # positions -2 and -1 and see no slot. The Pallas kernel zeroes their
    # exponentials and gives 0 there; attention_ref does not zero them and
    # gives the mean of v. The port follows the kernel (and the models'
    # _chunk_attention). Rows 2-3 agree with both.
    arrs = _qkv(3, 1, 2, 2, 4, 2, 16)
    kern = np.asarray(jops.attention(*map(jnp.asarray, arrs), causal=True,
                                     impl="interpret", block_q=32,
                                     block_k=32))
    ref = np.asarray(attention_ref(*map(jnp.asarray, arrs), causal=True))
    got = attention_plain(*_torch(arrs, "float32"), causal=True).numpy()
    assert np.all(kern[:, :, :2] == 0) and np.all(got[:, :, :2] == 0)
    np.testing.assert_allclose(ref[:, :, :2],
                               np.broadcast_to(arrs[2].mean(2, keepdims=True),
                                               ref[:, :, :2].shape),
                               atol=1e-6)
    _close(torch.from_numpy(got[:, :, 2:]), kern[:, :, 2:], 2e-5)
    _close(torch.from_numpy(got[:, :, 2:]), ref[:, :, 2:], 2e-5)


@pytest.mark.parametrize("case", ["linear", "ring", "offset-window"])
def test_chunk_attention_forms_match_reference(case):
    B, Hq, Hkv, d = 2, 4, 2, 32
    kw, jkw = {}, {}
    if case == "linear":
        # 5 new queries at positions 40..44 over a 64-slot cache holding 45
        Sq, Skv, off, window = 5, 64, 40, None
        kw = jkw = dict(kv_len=45)
    elif case == "ring":
        # a 16-slot ring holding positions 25..40 out of order, one empty
        Sq, Skv, off, window = 1, 16, 40, 16
        pos = np.empty(16, np.int32)
        pos[np.arange(25, 41) % 16] = np.arange(25, 41)
        pos[3] = -1
        kw = dict(k_positions=torch.from_numpy(pos))
        jkw = dict(k_positions=jnp.asarray(pos, jnp.int32))
    else:
        Sq, Skv, off, window = 40, 40, 0, 8
    q, k, v = _qkv(5, B, Hq, Hkv, Sq, Skv, d)
    want = jlayers._chunk_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, q_offset=off, chunk_q=16, chunk_k=16, **jkw)
    got = layers._chunk_attention(*_torch([q, k, v], "float32"), causal=True,
                                  window=window, q_offset=off, **kw)
    _close(got, want, 2e-5)


def test_wrappers_take_plain_on_cpu_and_check_arguments():
    q, k, v = _torch(_qkv(6, 1, 4, 2, 8, 8, 16), "float32")
    before = fk.launch_count()
    want = attention_plain(q, k, v, causal=True)
    assert ops.flash_attention is fk.flash_attention
    assert ops.attention_plain is attention_plain
    assert torch.equal(fk.flash_attention(q, k, v), want)
    assert torch.equal(fk.flash_attention(q, k, v, q_offset=0, k_pos=None),
                       want)
    assert fk.launch_count() == before
    with pytest.raises(ValueError, match="unsupported device"):
        fk.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
