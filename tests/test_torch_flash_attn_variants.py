"""The three CUDA variants of the port's flash attention, checked where
the CPU can reach them: which variant :func:`variant_for` gives each
input (the LM path's own views included), the decode variant's split-kv
arithmetic (``attention_split_plain``) against ``attention_plain`` at
f32 and against the JAX package's Pallas kernel in interpret mode, and
the tc variant's arithmetic (``attention_tc_plain``: bf16 products, the
scale after the product, ``p`` as bf16 hi + lo) against
``attention_plain`` within the kernels' bf16 bar."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import ops as jops
from repro_torch import configs
from repro_torch.kernels.flash_attn import kernel as fk
from repro_torch.kernels.flash_attn.ref import (attention_plain,
                                                attention_split_plain,
                                                attention_tc_plain, kv_span)
from repro_torch.models import layers, transformer
from repro_torch.serve import ServeEngine

torch.set_num_threads(1)

BF16 = torch.bfloat16
# the kernels' bf16 bar against attention_plain (chip_smoke.ATTN_TOL)
BF16_RTOL, BF16_ATOL = 1e-2, 1e-4


def _qkv(seed, B, Hq, Hkv, Sq, Skv, d, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(
        dtype) for s in ((B, Hq, Sq, d), (B, Hkv, Skv, d), (B, Hkv, Skv, d))]


def _ring(W, off, empty=()):
    """Slot positions of a W-slot ring holding positions ..off-1."""
    pos = np.full(W, -1, np.int32)
    live = np.arange(max(0, off - W), off)
    pos[live % W] = live
    pos[list(empty)] = -1
    return torch.from_numpy(pos)


# --------------------------------------------------------------- routing

@pytest.mark.parametrize("dtype,Sq,d,want", [
    (BF16, 2048, 64, "tc"), (BF16, 2, 16, "tc"), (BF16, 100, 80, "tc"),
    (BF16, 65, 128, "tc"),
    (BF16, 1, 64, "decode"), (torch.float32, 1, 64, "decode"),
    (BF16, 1, 256, "decode"), (BF16, 1, 30, "decode"),
    (torch.float32, 64, 64, "simt"), (BF16, 64, 256, "simt"),
    (BF16, 64, 144, "simt"), (BF16, 64, 30, "simt"), (BF16, 64, 72, "simt"),
])
def test_variant_for_by_dtype_and_shape(dtype, Sq, d, want):
    q, k, v = (torch.zeros(s, dtype=dtype) for s in
               ((2, 4, Sq, d), (2, 2, 96, d), (2, 2, 96, d)))
    assert fk.variant_for(q, k, v) == want


def test_variant_for_strided_and_unaligned_views():
    B, H, S, d, cap = 2, 4, 40, 64, 96
    proj = torch.zeros((B, S, H, d), dtype=BF16)
    q = proj.transpose(1, 2)                       # (B, H, S, d) strided
    cache = torch.zeros((3, B, H, cap, d), dtype=BF16)
    k = v = cache[1][:, :, :57]                    # a cache's valid prefix
    assert not q.is_contiguous() and not k.is_contiguous()
    assert fk.variant_for(q, k, v) == "tc"
    wide = torch.zeros((B, H, cap, d + 4), dtype=BF16)
    k_odd = wide[..., :d]                          # sequence stride 68
    assert fk.variant_for(q, k_odd, k_odd) == "simt"
    assert fk.variant_for(q[:, :, :1], k_odd, k_odd) == "decode"
    shifted = torch.zeros((B, H, cap, d + 8), dtype=BF16)[..., 4:4 + d]
    assert shifted.data_ptr() % 16 == 8            # rows on 8 bytes
    assert fk.variant_for(q, shifted, shifted) == "simt"
    assert fk.variant_for(shifted[:, :, :S], k, v) == "simt"
    # a last dimension that is not contiguous is copied: tc takes the copy
    k_t = torch.zeros((B, H, d, cap), dtype=BF16).transpose(2, 3)
    assert fk.variant_for(q, k_t, k_t) == "tc"


@pytest.mark.parametrize("arch,hd", [("qwen1.5-0.5b", 64),
                                     ("h2o-danube-1.8b", 80),
                                     ("yi-9b", 128)])
def test_lm_path_views_take_tc_and_decode(monkeypatch, arch, hd):
    """Every attention call of a bf16 generate (prefill, then decode
    steps through the cache's views, a ring cache for danube) is routed
    to tc in the prefill and decode in the steps."""
    cfg = configs.smoke(arch).with_(head_dim=hd, act_dtype="bfloat16")
    model = transformer.DecoderLM(cfg, device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    seen = []
    plain = fk.flash_attention

    def record(q, k, v, **kw):
        seen.append((q.shape[2], fk.variant_for(q, k, v)))
        return plain(q, k, v, **kw)

    monkeypatch.setattr(layers.fa, "flash_attention", record)
    P, new = 40, 4
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, P)))
    ServeEngine(cfg, model, P + new).generate(prompts, new)
    L = cfg.n_layers
    assert seen == [(P, "tc")] * L + [(1, "decode")] * (L * (new - 1))


# ------------------------------------------------------- decode's arithmetic

def test_decode_plan_covers_the_card():
    assert fk.decode_plan(8, 16, 2175, q_offset=2174, causal=True,
                          window=None, has_kpos=False) == (0, 2175, 256, 9)
    lo, hi, chunk, splits = fk.decode_plan(
        1, 4, 4096, q_offset=4095, causal=True, window=None,
        has_kpos=False)
    assert 4 * splits >= 2 * fk.SMS and (lo, hi, chunk) == (0, 4096, 32)
    assert fk.decode_plan(8, 16, 300, q_offset=299, causal=True,
                          window=100, has_kpos=False)[:2] == (200, 300)
    assert fk.decode_plan(2, 2, 50, q_offset=-1, causal=True,
                          window=None, has_kpos=False) == (0, 0, 32, 1)
    assert kv_span(3, 10, 5, True, None, True) == (0, 10)


def _split_cases():
    ring = _ring(100, 160, empty=(3, 40))
    ring[32:48] = -1                     # a whole chunk of empty slots
    return {
        # chunk edges cut the causal limit (slot 50) ...
        "causal": dict(Sq=1, chunk=16, q_offset=50),
        # ... and the window's first slot (31)
        "window": dict(Sq=1, chunk=16, q_offset=50, window=20),
        "ring": dict(Sq=1, chunk=16, q_offset=160, window=100, k_pos=ring),
        # a query that sees no slot gives 0
        "no_slot": dict(Sq=1, chunk=16, q_offset=-1),
        "rows": dict(Sq=9, chunk=32, q_offset=40, window=30),
        "non_causal": dict(Sq=1, chunk=64, q_offset=0, causal=False),
    }


@pytest.mark.parametrize("case", sorted(_split_cases()))
def test_split_plain_matches_plain(case):
    kw = dict(_split_cases()[case])
    Sq, chunk = kw.pop("Sq"), kw.pop("chunk")
    kw.setdefault("causal", True)
    q, k, v = _qkv(11, 2, 8, 2, Sq, 100, 32)
    got = attention_split_plain(q, k, v, chunk=chunk, **kw)
    want = attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    if case == "no_slot":
        assert torch.equal(got, torch.zeros_like(got))


def test_split_plain_matches_pallas_kernel():
    q, k, v = _qkv(12, 1, 8, 2, 1, 96, 32)
    want = jops.attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                          causal=True, impl="interpret", block_q=32,
                          block_k=32)
    got = attention_split_plain(q, k, v, chunk=32, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


# ----------------------------------------------------------- tc's arithmetic

@pytest.mark.parametrize("d,kw", [
    (64, dict(causal=True)),
    (64, dict(causal=False, q_offset=0)),
    (80, dict(causal=True, window=50)),
    (128, dict(causal=True)),
    (80, dict(causal=True, window=64, q_offset=150, k_pos=_ring(128, 157))),
])
def test_tc_plain_within_the_bf16_bar(d, kw):
    Sq = 7 if "k_pos" in kw else 150
    q, k, v = _qkv(13 + d, 1, 4, 2, Sq, 128 if "k_pos" in kw else 150, d,
                   BF16)
    got = attention_tc_plain(q, k, v, **kw).float()
    want = attention_plain(q, k, v, **kw).float()
    share = ((got - want).abs() / (BF16_ATOL + BF16_RTOL * want.abs()))
    assert float(share.max()) <= 1.0
