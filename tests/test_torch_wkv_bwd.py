"""The plain backward of the wkv6 kernel (``kernels/wkv/ref.py:
wkv6_bwd_plain``) and the autograd function that joins the forward and
backward kernels (``kernels/wkv/kernel.py:Wkv6``), on the CPU.

``wkv6_bwd_plain`` writes the gradients out one token at a time, in the
CUDA backward's order of work; it is held against autograd of
``wkv6_plain`` at f32 within 1e-5 of each output's largest magnitude,
and, through the port's ``time_mix`` (whose training entry is the
function), against ``jax.vjp`` of the reference's ``time_mix`` (the
reference's ``step`` is a closure inside it) within 1e-4 of each leaf's
largest. Decays near 0 (which a backward that divided by ``w`` could not
take) give finite gradients that still match autograd.
``wkv6_bwd_segmented_plain`` (the CUDA backward's time segments: local
walks, the carry over segments, checkpoints rebuilt from them) is held
to the plain backward and autograd within 1e-5, and through ``time_mix``
to ``jax.vjp`` within 1e-4, at a sequence shorter than a segment, one
that ends in a short segment, several whole segments and decays that
underflow to 0. The kernels themselves run on the card only
(``tests/test_torch_cuda.py``)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import rwkv as jrwkv
from repro_torch import configs
from repro_torch.kernels.wkv import kernel as wk
from repro_torch.kernels.wkv.ref import (wkv6_bwd_plain,
                                         wkv6_bwd_segmented_plain,
                                         wkv6_plain)
from repro_torch.models import rwkv

torch.set_num_threads(1)

# f32 sums over the head's keys and values in another order than
# autograd's
REL = 1e-5
# through the whole time mix against XLA's autodiff: f32 products and
# norms of other shapes on both sides
VJP_REL = 1e-4
ARCH = "rwkv6-3b"
NAMES = ("dr", "dk", "dv", "dw", "du", "dstate")
# (S, tokens a segment): shorter than one segment, a short last segment,
# three whole segments; "underflow" adds decays of 1e-30 (the CPU cases)
# or pushes half the channels' w0 to 5, exp(-exp(5)) ~ 1e-65, 0 in f32
# (through time_mix)
SEGMENTS = {"short": (5, 8), "ragged": (19, 8), "several": (24, 8),
            "underflow": (21, 8)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(B, S, H, hd, seed, w_lo=None):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)) for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, S, H, hd)) - 1))
    if w_lo is not None:   # decays near 0 and near 1
        w = np.where(rng.uniform(size=w.shape) < 0.5, w_lo, 1 - w_lo)
    u = rng.standard_normal((H, hd)) * 0.1
    s0 = rng.standard_normal((B, H, hd, hd))
    dy = rng.standard_normal((B, S, H, hd))
    return [_t(a.astype(np.float32)) for a in (r, k, v, w, u, s0, dy)]


def _autograd(r, k, v, w, u, s0, dy):
    ins = [a.clone().requires_grad_() for a in (r, k, v, w, u, s0)]
    y, _ = wkv6_plain(*ins)
    # at S = 1 y does not depend on w: its gradient is 0
    return torch.autograd.grad(y, ins, dy, allow_unused=True,
                               materialize_grads=True)


def _close(got, want, rel, names=NAMES):
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        err = float(np.abs(g - w).max())
        assert err <= rel * float(np.abs(w).max()), (name, err)


@pytest.mark.parametrize("S", [1, 5, 37])
@pytest.mark.parametrize("hd", [8, 32])
def test_wkv6_bwd_plain_matches_autograd(S, hd):
    args = _inputs(2, S, 3, hd, S + hd)
    got = wkv6_bwd_plain(*args)
    _close([g.numpy() for g in got],
           [g.numpy() for g in _autograd(*args)], REL)
    assert [g.dtype for g in got] == [torch.float32] * 6


def test_wkv6_bwd_plain_in_bf16_rounds_once():
    """bf16 r, k, v: the gradients are the f32 ones rounded once to bf16
    (autograd of the plain version casts them back the same way)."""
    args = _inputs(2, 9, 2, 32, 4)
    args[:3] = [a.to(torch.bfloat16) for a in args[:3]]
    got = wkv6_bwd_plain(*args)
    want = _autograd(*args)
    assert [g.dtype for g in got[:3]] == [torch.bfloat16] * 3
    for g, w in zip(got[:3], want[:3]):
        # one bf16 ulp of the value, plus f32 sums in another order
        assert bool(((g.float() - w.float()).abs()
                     <= 2 ** -8 * w.float().abs()
                     + REL * float(w.float().abs().max())).all())
    _close([g.numpy() for g in got[3:]], [g.numpy() for g in want[3:]], REL,
           NAMES[3:])


@pytest.mark.parametrize("w_lo", [1e-30, 1e-6])
def test_wkv6_bwd_plain_at_extreme_decays(w_lo):
    """Decays near 0 (1e-30: products underflow within a few tokens) and
    near 1: every gradient finite and equal to autograd's."""
    args = _inputs(2, 21, 2, 32, 5, w_lo)
    got = wkv6_bwd_plain(*args)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _close([g.numpy() for g in got],
           [g.numpy() for g in _autograd(*args)], REL)


def test_wkv6_function_on_the_cpu():
    """``wkv6_train`` on CPU tensors: one forward and one backward call of
    the function, no kernel launch, the plain version's output and the
    plain backward's gradients bit for bit; a state that needs no
    gradient gets none."""
    r, k, v, w, u, s0, dy = _inputs(2, 11, 2, 32, 6)
    ins = [a.clone().requires_grad_() for a in (r, k, v, w, u)]
    before = (wk.call_count("forward"), wk.call_count("backward"),
              wk.launch_count(), wk.launch_count("bwd"))
    y = wk.wkv6_train(*ins, s0)
    grads = torch.autograd.grad(y, ins, dy)
    assert (wk.call_count("forward") - before[0],
            wk.call_count("backward") - before[1],
            wk.launch_count() - before[2],
            wk.launch_count("bwd") - before[3]) == (1, 1, 0, 0)
    assert torch.equal(y, wkv6_plain(r, k, v, w, u, s0)[0])
    want = wkv6_bwd_plain(r, k, v, w, u, s0, dy)
    for g, x in zip(grads, want[:5]):
        assert torch.equal(g, x)
    # the serving entry under grad mode takes the function too; its last
    # state is not differentiable
    y2, s = wk.wkv6(*ins, s0)
    assert torch.equal(y2, y) and not s.requires_grad
    assert wk.call_count("forward") - before[0] == 2
    with pytest.raises(ValueError, match="call count"):
        wk.launch_count("forward")


def _params(seed):
    jcfg = jconfigs.smoke(ARCH).with_(act_dtype="float32")
    p = jax.tree.map(np.asarray, jrwkv.init_rwkv(jax.random.PRNGKey(seed),
                                                 jcfg, jnp.float32))
    rng = np.random.default_rng(seed)
    for name in ("mu_x", "mu_w", "mu_k", "mu_v", "mu_r", "mu_g"):
        p[name] = rng.uniform(0, 1, p[name].shape).astype(np.float32)
    p["w0"] = (p["w0"] + rng.standard_normal(p["w0"].shape) * 0.5).astype(
        np.float32)
    return configs.smoke(ARCH).with_(act_dtype="float32"), jcfg, p


@pytest.mark.parametrize("S", [1, 19])
def test_time_mix_gradients_match_jax_vjp(S):
    """The port's ``time_mix`` (recurrence through ``Wkv6``, backward
    ``wkv6_bwd_plain``) against ``jax.vjp`` of the reference's, the same
    output cotangent: the input's and every weight's gradient within
    ``VJP_REL`` of its largest magnitude."""
    _time_mix_vs_jax(S, *_params(S))


def _time_mix_vs_jax(S, cfg, jcfg, p):
    rng = np.random.default_rng(S + 3)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    # the time mix's weights (the channel mix's are in the same tree)
    leaves = sorted(k for k in p if k not in ("mu_ck", "mu_cr", "Wck",
                                              "Wcv", "Wcr"))
    tp = {k: _t(v).requires_grad_(k in leaves) for k, v in p.items()}
    tx = _t(x).requires_grad_()
    before = wk.call_count("backward")
    out, _ = rwkv.time_mix(tx, tp, cfg)
    got = torch.autograd.grad(out, [tx] + [tp[k] for k in leaves], _t(ct))
    assert wk.call_count("backward") == before + 1
    assert all(bool(torch.isfinite(g).all()) for g in got)

    def f(x, p):
        return jrwkv.time_mix(x, p, jcfg)[0]
    _, vjp = jax.vjp(f, jnp.asarray(x), {k: jnp.asarray(v)
                                         for k, v in p.items()})
    jx, jp = vjp(jnp.asarray(ct))
    want = [jx] + [jp[k] for k in leaves]
    _close([g.numpy() for g in got], want, VJP_REL, ["x", *leaves])


@pytest.mark.parametrize("case", sorted(SEGMENTS))
@pytest.mark.parametrize("hd", [8, 32])
def test_wkv6_bwd_segmented_mirror_matches_plain(case, hd):
    """The segmented mirror against the plain backward and autograd of
    the plain forward, each output within ``REL`` of its largest."""
    S, seg = SEGMENTS[case]
    args = _inputs(2, S, 3, hd, S + hd + seg,
                   1e-30 if case == "underflow" else None)
    got = wkv6_bwd_segmented_plain(*args, seg)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert [g.dtype for g in got] == [torch.float32] * 6
    for want in (wkv6_bwd_plain(*args), _autograd(*args)):
        _close([g.numpy() for g in got], [g.numpy() for g in want], REL)


def test_wkv6_bwd_segmented_mirror_in_bf16():
    """bf16 r, k, v over several segments: dr, dk, dv come back in bf16,
    within one bf16 ulp of the plain backward's beside ``REL`` of the
    largest; the f32 outputs within ``REL``."""
    args = _inputs(2, 19, 2, 32, 11)
    args[:3] = [a.to(torch.bfloat16) for a in args[:3]]
    got = wkv6_bwd_segmented_plain(*args, 8)
    want = wkv6_bwd_plain(*args)
    assert [g.dtype for g in got[:3]] == [torch.bfloat16] * 3
    for g, w in zip(got[:3], want[:3]):
        assert bool(((g.float() - w.float()).abs()
                     <= 2 ** -7 * w.float().abs()
                     + REL * float(w.float().abs().max())).all())
    _close([g.numpy() for g in got[3:]], [g.numpy() for g in want[3:]], REL,
           NAMES[3:])


@pytest.mark.parametrize("case", sorted(SEGMENTS))
def test_segmented_mirror_through_time_mix_matches_jax_vjp(case,
                                                           monkeypatch):
    """``Wkv6``'s backward on the CPU swapped for the segmented mirror:
    the port's ``time_mix`` gradients against ``jax.vjp`` of the
    reference's (whose ``lax.scan``, rwkv.py:58-69, is the recurrence),
    each within ``VJP_REL`` of its largest."""
    S, seg = SEGMENTS[case]
    cfg, jcfg, p = _params(S + seg)
    if case == "underflow":
        p["w0"] = np.where(np.arange(p["w0"].shape[-1]) % 2 == 0, 5.0,
                           p["w0"]).astype(np.float32)
    monkeypatch.setattr(wk, "wkv6_bwd_plain",
                        lambda *a: wkv6_bwd_segmented_plain(*a, seg))
    _time_mix_vs_jax(S, cfg, jcfg, p)
