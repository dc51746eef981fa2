"""The attention gradient on the CPU: the backward kernel's plain version
(``ref.attention_bwd_plain``, from the forward's output and row
log-sum-exp) against ``torch.autograd.grad`` of ``attention_plain`` and
against ``jax.vjp`` of the reference models' ``_chunk_attention`` (what
XLA differentiates in the reference), at f32 on the same numpy inputs,
within 1e-5 of the largest gradient magnitude; the training form's
autograd function (what the models take with grad on) against the same;
the wrapper's refusals of what the kernel does not take; and the tc
kernels' mirror (``attention_bwd_tc_plain``) within the bf16 bar of the
plain version. Cross attention (the encoder-decoder's: Sq != Skv,
non-causal, no window, queries at offset 0) at Sq > Skv, Sq < Skv and
lengths off the 64-row tile, through the same three comparisons."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.kernels.flash_attn import backward as fab
from repro_torch.kernels.flash_attn import kernel as fak
from repro_torch.kernels.flash_attn.ref import (attention_bwd_plain,
                                                attention_bwd_tc_plain,
                                                attention_lse_plain,
                                                attention_plain)
from repro_torch.models import layers

torch.set_num_threads(1)

# f32 sums taken in another order: 1e-5 of the largest gradient
REL = 1e-5


def _inputs(seed, B, Hq, Hkv, S, d, Skv=None):
    """q, k, v, do; k and v of ``Skv`` slots (default ``S``)."""
    rng = np.random.default_rng(seed)
    Skv = S if Skv is None else Skv
    return [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, Hq, S, d), (B, Hkv, Skv, d), (B, Hkv, Skv, d),
                      (B, Hq, S, d))]


def _close(got, want):
    """Each of (dq, dk, dv) within REL of the largest magnitude of the
    three (dq and dk are 0 where a row sees one slot, dv never is)."""
    want = [np.asarray(w, np.float32) for w in want]
    bar = REL * max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(np.asarray(g, np.float32), w, rtol=0,
                                   atol=bar)


@functools.lru_cache(maxsize=None)
def _jax_vjp(causal, window, q_offset):
    def f(q, k, v, do):
        out, pull = jax.vjp(functools.partial(
            jlayers._chunk_attention, causal=causal, window=window,
            q_offset=q_offset), q, k, v)
        return pull(do)
    return jax.jit(f)


def _port_grads(q, k, v, do, causal, window, q_offset=None):
    o, lse = attention_lse_plain(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    return attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                               window=window, q_offset=q_offset)


GRID = dict(Hkv=(4, 2), S=(1, 17, 64, 130), d=(32, 64, 80),
            causal=(True, False), window=(None, 16))
# (Hkv, causal, window) for each (S, d) of the reference comparison, so
# that every value of every axis meets the reference (one XLA compile a
# case keeps the full grid to the autograd comparison)
MASKS = [(h, c, w) for h in GRID["Hkv"] for c in GRID["causal"]
         for w in GRID["window"]]
REF_CASES = [(S, d, *MASKS[(i * 3) % len(MASKS)]) for i, (S, d) in
             enumerate((S, d) for S in GRID["S"] for d in GRID["d"])]


@pytest.mark.parametrize("window", GRID["window"])
@pytest.mark.parametrize("causal", GRID["causal"])
@pytest.mark.parametrize("d", GRID["d"])
@pytest.mark.parametrize("S", GRID["S"])
@pytest.mark.parametrize("Hkv", GRID["Hkv"])
def test_bwd_plain_matches_autograd(Hkv, S, d, causal, window):
    arrs = _inputs(S * d + Hkv, 2, 4, Hkv, S, d)
    q, k, v, do = map(torch.from_numpy, arrs)
    got = _port_grads(q, k, v, do, causal, window)
    assert all(g.dtype == torch.float32 for g in got)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = attention_plain(*leaves, causal=causal, window=window)
    _close(got, torch.autograd.grad(out, leaves, do))


@pytest.mark.parametrize("S,d,Hkv,causal,window", REF_CASES)
def test_bwd_plain_matches_reference_vjp(S, d, Hkv, causal, window):
    arrs = _inputs(S * d + Hkv, 2, 4, Hkv, S, d)
    got = _port_grads(*map(torch.from_numpy, arrs), causal, window)
    _close(got, _jax_vjp(causal, window, 0)(*map(jnp.asarray, arrs)))


def test_reference_cases_cover_the_grid():
    for i, axis in enumerate(("S", "d", "Hkv", "causal", "window")):
        assert {c[i] for c in REF_CASES} == set(GRID[axis]), axis


def test_fully_masked_rows_have_zero_gradients():
    """Queries at positions -3..S-4 (q_offset = -3): the first three see
    no kv slot under the causal mask; their output is 0, their lse +inf
    and every gradient they feed is 0, as ``jax.vjp`` gives it."""
    B, Hq, Hkv, S, d = 2, 4, 2, 40, 32
    arrs = _inputs(7, B, Hq, Hkv, S, d)
    q, k, v, do = map(torch.from_numpy, arrs)
    o, lse = attention_lse_plain(q, k, v, causal=True, q_offset=-3)
    assert bool(torch.isinf(lse[:, :, :3]).all())
    assert not bool(o[:, :, :3].any())
    got = _port_grads(q, k, v, do, True, None, q_offset=-3)
    want = _jax_vjp(True, None, -3)(*map(jnp.asarray, arrs))
    _close(got, want)
    assert not bool(got[0][:, :, :3].any())


@pytest.mark.parametrize("S,d,Hkv,causal,window", [
    (50, 64, 2, True, 16), (33, 80, 4, False, None), (64, 32, 1, True, None)])
def test_training_form_autograd_matches_reference(S, d, Hkv, causal, window):
    """``flash_attention_train`` (the route the models take with grad on)
    and ``layers._chunk_attention`` under grad, on the CPU, against
    ``jax.vjp`` of the reference's ``_chunk_attention``."""
    arrs = _inputs(S + d, 2, 4, Hkv, S, d)
    want = _jax_vjp(causal, window, 0)(*map(jnp.asarray, arrs))
    for run in (functools.partial(fab.flash_attention_train, causal=causal,
                                  window=window),
                functools.partial(layers._chunk_attention, causal=causal,
                                  window=window, q_offset=0)):
        leaves = [torch.from_numpy(a).requires_grad_() for a in arrs[:3]]
        out = run(*leaves)
        _close(torch.autograd.grad(out, leaves, torch.from_numpy(arrs[3])),
               want)


def test_forward_lse_matches_plain_forward():
    arrs = _inputs(3, 2, 4, 2, 70, 48)
    q, k, v, _ = map(torch.from_numpy, arrs)
    out, lse = fak.flash_attention_lse(q, k, v, causal=True, window=20)
    assert torch.equal(out, attention_plain(q, k, v, causal=True, window=20))
    s = torch.einsum("bhqd,bhkd->bhqk", q * 48 ** -0.5,
                     k.repeat_interleave(2, dim=1))
    pos = torch.arange(70)
    vis = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - 20)
    want = torch.logsumexp(torch.where(vis, s, -torch.inf), dim=-1)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-6)


def test_training_form_refuses_other_calls():
    arrs = _inputs(1, 1, 2, 2, 16, 32)
    q, k, v, do = map(torch.from_numpy, arrs)
    with pytest.raises(ValueError, match="training form"):
        fab.flash_attention_train(q[:, :, :8], k, v,       # Sq != Skv,
                                  causal=True)             # causal
    with pytest.raises(ValueError, match="training form"):
        fab.flash_attention_train(q[:, :, :8], k, v, causal=False,
                                  window=4)                # a window
    with pytest.raises(ValueError, match="training form"):
        layers._chunk_attention(q[:, :, :8].requires_grad_(), k, v,
                                causal=False, window=None, q_offset=2)
    with pytest.raises(ValueError, match="training form"):
        fab.flash_attention_train(q[..., :24], k[..., :24], v[..., :24])
    with pytest.raises(ValueError, match="lse"):
        fab.attention_bwd(q, k, v, q, torch.zeros(1, 2, 8), do)
    with pytest.raises(ValueError, match="training form"):
        layers._chunk_attention(q.requires_grad_(), k, v, causal=True,
                                window=None, q_offset=0, kv_len=8)
    # serving (no grad) keeps the plain forward and its counts
    with torch.no_grad():
        assert torch.equal(layers._chunk_attention(
            q, k, v, causal=True, window=None, q_offset=0),
            attention_plain(q, k, v, causal=True))
    assert fab.launch_count() == 0


def test_backward_variant_rule():
    """``variant_for`` (decided on the CPU too, from dtype, head width
    and row alignment alone): tc for bf16 views the tensor cores' loads
    take, simt for f32, other widths and unaligned rows."""
    B, S, H, d = 2, 16, 4, 64
    bf = torch.zeros((B, S, H, d), dtype=torch.bfloat16).transpose(1, 2)
    assert fab.variant_for(bf, bf, bf, bf, bf) == "tc"
    f32 = bf.float()
    assert fab.variant_for(f32, f32, f32, f32, f32) == "simt"
    odd = torch.zeros((B, S, H, d + 1), dtype=torch.bfloat16)[..., 1:]
    odd = odd.transpose(1, 2)
    assert fab.variant_for(bf, odd, bf, bf, bf) == "simt"
    narrow = torch.zeros((B, H, S, 40), dtype=torch.bfloat16)
    assert fab.variant_for(*[narrow] * 5) == "simt"


# the tc backward's mirror against the plain version, bf16 in and out,
# each of dq, dk, dv: |got - want| <= rtol |want| + atol_rel (the largest
# |want| of the three). Both sum f32 from the same bf16 inputs and round
# once to bf16, so they differ by at most one bf16 ulp (2^-7 of the
# value, under 1e-2); atol_rel covers f32 sums taken in another order
# and p, dS carried as bf16 hi + lo (about 16 significant bits). The
# card's bar for its kernels (chip_smoke's BWD_TOL, tests/test_torch_cuda)
BF16_BWD_TOL = (1e-2, 1e-5)


def _bf16_inputs(seed, B, Hq, Hkv, S, d):
    return [torch.from_numpy(a).to(torch.bfloat16)
            for a in _inputs(seed, B, Hq, Hkv, S, d)]


def _tol_share(got, want):
    """The largest share of ``BF16_BWD_TOL``'s allowed error over dq, dk
    and dv (<= 1 passes)."""
    rtol, arel = BF16_BWD_TOL
    top = max(float(w.float().abs().max()) for w in want)
    share = 0.0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.bfloat16 and g.shape == w.shape
        g, w = g.float(), w.float()
        share = max(share, float(((g - w).abs()
                                  / (rtol * w.abs() + arel * top)).max()))
    return share


# (Hq, Hkv, S, window): MHA at a ragged S (not a multiple of the 64-row
# tile), and GQA with a sliding window at another ragged S
TC_MIRROR_CASES = [(4, 4, 130, None), (4, 2, 200, 40)]


@pytest.mark.parametrize("Hq,Hkv,S,window", TC_MIRROR_CASES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 80, 128])
def test_bwd_tc_mirror_matches_plain(d, causal, Hq, Hkv, S, window):
    """``attention_bwd_tc_plain`` (the tc kernels' arithmetic and tile
    order) within the bf16 bar of ``attention_bwd_plain`` on the same
    bf16 inputs and the same forward's o and lse."""
    q, k, v, do = _bf16_inputs(S * d + Hkv, 1, Hq, Hkv, S, d)
    kw = dict(causal=causal, window=window)
    o, lse = attention_lse_plain(q, k, v, **kw)
    want = attention_bwd_plain(q, k, v, o, lse, do, **kw)
    got = attention_bwd_tc_plain(q, k, v, o, lse, do, **kw)
    assert _tol_share(got, want) <= 1.0


def test_bwd_tc_mirror_needs_hi_lo():
    """Why the kernels carry p and dS as bf16 hi + lo: a single bf16
    (8 significant bits) misses the bar by more than an order of
    magnitude at the train layer's width, hi + lo keeps within it."""
    q, k, v, do = _bf16_inputs(11, 2, 8, 2, 256, 64)
    o, lse = attention_lse_plain(q, k, v, causal=True)
    want = attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    split = attention_bwd_tc_plain(q, k, v, o, lse, do, causal=True)
    single = attention_bwd_tc_plain(q, k, v, o, lse, do, causal=True,
                                    split=False)
    assert _tol_share(split, want) <= 1.0
    assert _tol_share(single, want) > 10.0


def test_broadcast_views_are_copied_for_the_tensor_maps():
    """A view with a zero stride over more than one element (a broadcast
    gradient) is copied before the tc kernels' tensor maps describe it;
    any other view goes as it is."""
    B, S, H, d = 2, 16, 4, 64
    view = torch.zeros((B, S, H, d), dtype=torch.bfloat16).transpose(1, 2)
    assert fab._strided(view) is view
    row = torch.arange(d, dtype=torch.float32).to(torch.bfloat16)
    wide = row.expand(B, H, S, d)
    got = fab._strided(wide)
    assert got.is_contiguous() and torch.equal(got, wide)


# cross attention's shapes (Sq, Skv, Hq, Hkv, d): Sq > Skv off the tile
# (70 over 33), Sq < Skv, Sq = 2 Skv (the encoder-decoder's decoder over
# its memory), group 1 each, and one grouped case
CROSS_CASES = [(70, 33, 4, 4, 32), (33, 70, 4, 4, 64), (128, 64, 2, 2, 64),
               (16, 100, 4, 2, 32)]


@pytest.mark.parametrize("Sq,Skv,Hq,Hkv,d", CROSS_CASES)
def test_bwd_plain_cross_matches_reference_vjp(Sq, Skv, Hq, Hkv, d):
    """``attention_bwd_plain`` at ``q_offset`` 0, non-causal, against
    ``jax.vjp`` of the reference's ``_chunk_attention(causal=False,
    q_offset=0)`` (cross attention), within ``REL``."""
    arrs = _inputs(Sq * Skv + d, 2, Hq, Hkv, Sq, d, Skv=Skv)
    got = _port_grads(*map(torch.from_numpy, arrs), False, None, q_offset=0)
    assert tuple(got[1].shape) == (2, Hkv, Skv, d)
    _close(got, _jax_vjp(False, None, 0)(*map(jnp.asarray, arrs)))


@pytest.mark.parametrize("Sq,Skv,Hq,Hkv,d", CROSS_CASES)
def test_bwd_tc_mirror_cross_matches_plain(Sq, Skv, Hq, Hkv, d):
    """The tc kernels' mirror at cross attention's shapes (query tiles
    and kv tiles of other lengths) within the bf16 bar of the plain
    version."""
    q, k, v, do = [torch.from_numpy(a).to(torch.bfloat16) for a in
                   _inputs(Sq + Skv, 1, Hq, Hkv, Sq, d, Skv=Skv)]
    kw = dict(causal=False, window=None)
    o, lse = attention_lse_plain(q, k, v, q_offset=0, **kw)
    want = attention_bwd_plain(q, k, v, o, lse, do, q_offset=0, **kw)
    got = attention_bwd_tc_plain(q, k, v, o, lse, do, **kw)
    assert _tol_share(got, want) <= 1.0


@pytest.mark.parametrize("Sq,Skv", [(70, 33), (16, 100)])
def test_training_form_cross_autograd_matches_reference(Sq, Skv):
    """Cross attention with grad on, through ``flash_attention_train``
    and ``layers._chunk_attention`` (what ``cross_attention_block`` calls),
    on the CPU against ``jax.vjp`` of the reference's ``_chunk_attention``;
    the forward's lse is the plain one's at ``q_offset`` 0."""
    arrs = _inputs(Sq + 7 * Skv, 2, 4, 4, Sq, 64, Skv=Skv)
    want = _jax_vjp(False, None, 0)(*map(jnp.asarray, arrs))
    for run in (functools.partial(fab.flash_attention_train, causal=False),
                functools.partial(layers._chunk_attention, causal=False,
                                  window=None, q_offset=0)):
        leaves = [torch.from_numpy(a).requires_grad_() for a in arrs[:3]]
        out = run(*leaves)
        _close(torch.autograd.grad(out, leaves, torch.from_numpy(arrs[3])),
               want)
    q, k, v = map(torch.from_numpy, arrs[:3])
    out, lse = fak.flash_attention_lse(q, k, v, causal=False)
    want_o, want_lse = attention_lse_plain(q, k, v, causal=False,
                                           q_offset=0)
    assert torch.equal(out, want_o) and torch.equal(lse, want_lse)
