"""The plain backward of the selective-scan kernel
(``kernels/selective_scan/ref.py:selective_scan_bwd_plain``) and the
autograd function that joins the forward and backward kernels
(``kernels/selective_scan/kernel.py:SelectiveScan``), on the CPU.

``selective_scan_bwd_plain`` writes the gradients out one token at a
time, in the CUDA backward's order of work; it is held against autograd
of ``selective_scan_plain`` at f32 within 1e-5 of each output's largest
magnitude, against ``jax.vjp`` of the reference's ``_selective_scan``
(with ``mamba_block``'s ``da``, ``db`` and ``C`` contraction around it)
and, through the port's ``mamba_block`` (whose training entry is the
function), against ``jax.vjp`` of the reference's ``mamba_block``, each
within 1e-4 of each leaf's largest. Decays that underflow to 0 give
finite gradients. ``selective_scan_bwd_segmented_plain`` (the time
segments of the reference's chunked scan: local walks, the carry over
segments, checkpoints rebuilt from them; no kernel of the port takes
segments) is held to the plain backward and autograd within
1e-5 and to ``jax.vjp`` of the reference's scan within 1e-4, at a
sequence shorter than a segment, one that ends in a short segment,
several whole segments, one segment and decays that underflow to 0. The
kernels themselves run on the card only (``tests/test_torch_cuda.py``)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.kernels.selective_scan import kernel as ssk
from repro_torch.kernels.selective_scan.ref import (
    selective_scan_bwd_plain, selective_scan_bwd_segmented_plain,
    selective_scan_plain)
from repro_torch.models import ssm

torch.set_num_threads(1)

# f32 sums over the states, channels and tokens in another order than
# autograd's
REL = 1e-5
# against XLA's autodiff of the reference's chunked associative scan,
# which multiplies the decays in another order
VJP_REL = 1e-4
ARCH = "jamba-1.5-large-398b"
NAMES = ("ddt", "dxc", "dA", "dBm", "dCm", "dD", "dh0")
# (S, tokens a segment, dt scale): shorter than one segment, a short last
# segment, three whole segments, one segment (the kernel's), decays that
# underflow to 0 (dt x 400) over several segments
SEGMENTS = {"short": (5, 16, 1.0), "ragged": (40, 16, 1.0),
            "several": (48, 16, 1.0), "whole": (37, None, 1.0),
            "underflow": (21, 8, 400.0)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(B, S, di, ds, seed, dt_scale=1.0):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)) - 2.0)) * dt_scale
    xc = rng.standard_normal((B, S, di))
    Bm = rng.standard_normal((B, S, ds))
    Cm = rng.standard_normal((B, S, ds))
    A = -np.broadcast_to(np.arange(1, ds + 1), (di, ds)) * rng.uniform(
        0.5, 1.5, (di, ds))
    D = rng.standard_normal(di)
    h0 = rng.standard_normal((B, di, ds))
    dy = rng.standard_normal((B, S, di))
    return [a.astype(np.float32) for a in (dt, xc, A, Bm, Cm, D, h0, dy)]


def _autograd(*args):
    ins = [a.clone().requires_grad_() for a in args[:7]]
    y, _ = selective_scan_plain(*ins)
    return torch.autograd.grad(y, ins, args[7])


def _close(got, want, rel, names=NAMES):
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        err = float(np.abs(g - w).max())
        assert err <= rel * float(np.abs(w).max()), (name, err)


@pytest.mark.parametrize("S", [1, 5, 37])
@pytest.mark.parametrize("di,ds", [(24, 4), (40, 16)])
def test_selective_scan_bwd_plain_matches_autograd(S, di, ds):
    args = [_t(a) for a in _inputs(2, S, di, ds, S + di)]
    got = selective_scan_bwd_plain(*args)
    _close([g.numpy() for g in got],
           [g.numpy() for g in _autograd(*args)], REL)


def _reference_y(dt, xc, A, Bm, Cm, D, h0):
    """ssm.py:80-88's arithmetic on given (dt, xc, Bm, Cm): da, db, the
    reference's ``_selective_scan``, the C contraction and the D skip."""
    da = jnp.exp(dt[..., None] * A)
    db = dt[..., None] * Bm[:, :, None, :] * xc[..., None]
    hs, _ = jssm._selective_scan(da, db, h0)
    return jnp.einsum("bsnk,bsk->bsn", hs, Cm) + xc * D


@pytest.mark.parametrize("S", [5, 300])
def test_selective_scan_bwd_plain_matches_jax_vjp(S):
    """Against ``jax.vjp`` of the reference's scan; S = 300 crosses its
    256-token chunk."""
    a = _inputs(2, S, 24, 4, S)
    got = selective_scan_bwd_plain(*map(_t, a))
    _, vjp = jax.vjp(_reference_y, *map(jnp.asarray, a[:7]))
    _close([g.numpy() for g in got], vjp(jnp.asarray(a[7])), VJP_REL)


def test_selective_scan_bwd_plain_at_underflowing_decays():
    """dt large enough that exp(dt A) underflows to 0 on most states:
    every gradient finite and equal to autograd's."""
    args = [_t(a) for a in _inputs(2, 21, 24, 16, 3, dt_scale=400.0)]
    assert float(torch.exp(args[0][..., None] * args[2]).min()) == 0.0
    got = selective_scan_bwd_plain(*args)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _close([g.numpy() for g in got],
           [g.numpy() for g in _autograd(*args)], REL)


def test_selective_scan_bwd_plain_in_bf16():
    """bf16 dt, xc, B, C: their gradients come back in bf16, computed in
    f32 and rounded once, within 2e-2 of each leaf's largest magnitude of
    autograd's (which rounds each product's gradient to bf16 on the way
    and sums the states in bf16); the f32 leaves likewise."""
    args = [_t(a) for a in _inputs(2, 9, 24, 4, 8)]
    for i in (0, 1, 3, 4):
        args[i] = args[i].to(torch.bfloat16)
    got = selective_scan_bwd_plain(*args)
    assert [got[i].dtype for i in (0, 1, 3, 4)] == [torch.bfloat16] * 4
    _close([g.float().numpy() for g in got],
           [g.float().numpy() for g in _autograd(*args)], 2e-2)


def test_selective_scan_function_on_the_cpu():
    """``selective_scan_train`` on CPU tensors: one forward and one
    backward call of the function, no kernel launch, the plain version's
    output and the plain backward's gradients bit for bit; a state that
    needs no gradient gets none."""
    args = [_t(a) for a in _inputs(2, 11, 24, 4, 6)]
    ins = [a.clone().requires_grad_() for a in args[:6]]
    before = (ssk.call_count("forward"), ssk.call_count("backward"),
              ssk.launch_count(), ssk.launch_count("bwd"))
    y = ssk.selective_scan_train(*ins, args[6])
    grads = torch.autograd.grad(y, ins, args[7])
    assert (ssk.call_count("forward") - before[0],
            ssk.call_count("backward") - before[1],
            ssk.launch_count() - before[2],
            ssk.launch_count("bwd") - before[3]) == (1, 1, 0, 0)
    assert torch.equal(y, selective_scan_plain(*args[:7])[0])
    want = selective_scan_bwd_plain(*args)
    for g, x in zip(grads, want[:6]):
        assert torch.equal(g, x)
    y2, h = ssk.selective_scan(*ins, args[6])
    assert torch.equal(y2, y) and not h.requires_grad
    with pytest.raises(ValueError, match="no call count"):
        ssk.call_count("bwd")


def _mamba(seed):
    jcfg = jconfigs.smoke(ARCH).with_(act_dtype="float32")
    p = jax.tree.map(np.asarray, jssm.init_mamba(jax.random.PRNGKey(seed),
                                                 jcfg, jnp.float32))
    rng = np.random.default_rng(seed)
    p["conv_b"] = rng.standard_normal(p["conv_b"].shape).astype(np.float32)
    p["dt_bias"] = (p["dt_bias"] + rng.standard_normal(
        p["dt_bias"].shape)).astype(np.float32)
    return configs.smoke(ARCH).with_(act_dtype="float32"), jcfg, p


@pytest.mark.parametrize("S", [1, 23])
def test_mamba_block_gradients_match_jax_vjp(S):
    """The port's ``mamba_block`` (scan through ``SelectiveScan``, backward
    ``selective_scan_bwd_plain``) against ``jax.vjp`` of the reference's,
    the same output cotangent: the input's and every weight's gradient
    within ``VJP_REL`` of its largest magnitude."""
    cfg, jcfg, p = _mamba(S)
    rng = np.random.default_rng(S + 5)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    leaves = sorted(p)
    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    tx = _t(x).requires_grad_()
    before = ssk.call_count("backward")
    out, _ = ssm.mamba_block(tx, tp, cfg)
    got = torch.autograd.grad(out, [tx] + [tp[k] for k in leaves], _t(ct))
    assert ssk.call_count("backward") == before + 1

    def f(x, p):
        return jssm.mamba_block(x, p, jcfg)[0]
    _, vjp = jax.vjp(f, jnp.asarray(x), {k: jnp.asarray(v)
                                         for k, v in p.items()})
    jx, jp = vjp(jnp.asarray(ct))
    _close([g.numpy() for g in got], [jx] + [jp[k] for k in leaves],
           VJP_REL, ["x", *leaves])


@pytest.mark.parametrize("case", sorted(SEGMENTS))
@pytest.mark.parametrize("di,ds", [(24, 4), (40, 16)])
def test_selective_scan_bwd_segmented_mirror_matches_plain(case, di, ds):
    """The segmented mirror against the plain backward and autograd of
    the plain forward, each output within ``REL`` of its largest."""
    S, seg, scale = SEGMENTS[case]
    args = [_t(a) for a in _inputs(2, S, di, ds, S + di, dt_scale=scale)]
    if case == "underflow":
        assert float(torch.exp(args[0][..., None] * args[2]).min()) == 0.0
    got = selective_scan_bwd_segmented_plain(*args, seg=seg)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    for want in (selective_scan_bwd_plain(*args), _autograd(*args)):
        _close([g.numpy() for g in got], [g.numpy() for g in want], REL)


@pytest.mark.parametrize("case", sorted(SEGMENTS))
def test_selective_scan_bwd_segmented_mirror_matches_jax_vjp(case):
    """The segmented mirror against ``jax.vjp`` of the reference's scan
    (``_reference_y``), each output within ``VJP_REL`` of its largest."""
    S, seg, scale = SEGMENTS[case]
    a = _inputs(2, S, 24, 4, S + 7, dt_scale=scale)
    got = selective_scan_bwd_segmented_plain(*map(_t, a), seg=seg)
    _, vjp = jax.vjp(_reference_y, *map(jnp.asarray, a[:7]))
    _close([g.numpy() for g in got], vjp(jnp.asarray(a[7])), VJP_REL)


def test_selective_scan_bwd_segmented_mirror_in_bf16():
    """bf16 dt, xc, B, C over several segments: their gradients in bf16,
    one bf16 ulp of the plain backward's beside ``REL`` of the largest;
    the f32 leaves within ``REL``."""
    args = [_t(a) for a in _inputs(2, 30, 24, 4, 12)]
    for i in (0, 1, 3, 4):
        args[i] = args[i].to(torch.bfloat16)
    got = selective_scan_bwd_segmented_plain(*args, seg=16)
    want = selective_scan_bwd_plain(*args)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype, NAMES[i]
        ulp = 2 ** -7 if w.dtype == torch.bfloat16 else 0.0
        assert bool(((g.float() - w.float()).abs()
                     <= ulp * w.float().abs()
                     + REL * float(w.float().abs().max())).all()), NAMES[i]
