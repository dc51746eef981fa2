"""The port's Mamba block (``repro_torch/models/ssm.py``) and the plain
version of the selective-scan kernel (``kernels/selective_scan/ref.py``)
against the JAX package's ``mamba_block`` and ``_selective_scan``, on the
same numpy inputs and weights. The reference scans chunks of
``SSM_CHUNK`` = 256 tokens by an associative scan, the port one token at
a time, so the decays multiply in another order: outputs agree within
1e-5 of their largest magnitude in f32 (states likewise). S runs over 1,
5, 256 and 300 (across a chunk edge), with and without a cache (whose
``conv`` tail and ``h`` are random, and come back updated in place). In
bf16 the plain version forms ``db`` as the reference does, rounding after
each product: on the same bf16 inputs it stays within 1e-5 of the
reference's output, while the same sum with ``db`` formed in f32 does
not."""

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
    selective_scan_ex2_plain, selective_scan_plain)
from repro_torch.models import ssm

torch.set_num_threads(1)

REL = 1e-5
# the CUDA kernel's bar against the plain version (chip_smoke.REC_TOL,
# tests/test_torch_cuda.py:REC_REL), held here by its CPU mirror
REC_TOL = 2e-5
ARCH = "jamba-1.5-large-398b"


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _scan_inputs(B, S, di, ds, seed):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)) - 2.0))
    xc = rng.standard_normal((B, S, di))
    Bm = rng.standard_normal((B, S, ds))
    Cm = rng.standard_normal((B, S, ds))
    A = -np.broadcast_to(np.arange(1, ds + 1), (di, ds)) * rng.uniform(
        0.5, 1.5, (di, ds))
    D = rng.standard_normal(di)
    h0 = rng.standard_normal((B, di, ds))
    return [a.astype(np.float32) for a in (dt, xc, A, Bm, Cm, D, h0)]


def _reference_scan(dt, xc, A, Bm, Cm, D, h0):
    """ssm.py:80-88's arithmetic on given (dt, xc, Bm, Cm), in their
    dtype: da from dt in f32, db formed in that dtype then cast."""
    da = jnp.exp(dt[..., None].astype(jnp.float32) * A)
    db = (dt[..., None] * Bm[:, :, None, :] * xc[..., None]).astype(
        jnp.float32)
    hs, h_last = jssm._selective_scan(da, db, h0)
    y = jnp.einsum("bsnk,bsk->bsn", hs, Cm.astype(jnp.float32))
    return y + xc.astype(jnp.float32) * D, h_last


@pytest.mark.parametrize("S", [1, 5, 256, 300])
def test_selective_scan_plain_matches_reference(S):
    args = _scan_inputs(2, S, 24, 4, S)
    y, h = selective_scan_plain(*map(_t, args))
    wy, wh = _reference_scan(*map(jnp.asarray, args))
    _close(y.numpy(), wy)
    _close(h.numpy(), wh)


def test_selective_scan_bf16_rounds_db_as_the_reference():
    dt, xc, A, Bm, Cm, D, h0 = _scan_inputs(2, 40, 32, 16, 9)
    bf = jnp.bfloat16
    ref_y, ref_h = _reference_scan(jnp.asarray(dt, bf), jnp.asarray(xc, bf),
                                   jnp.asarray(A), jnp.asarray(Bm, bf),
                                   jnp.asarray(Cm, bf), jnp.asarray(D),
                                   jnp.asarray(h0))
    # the same bf16 values on both sides
    bt = [_t(np.asarray(jnp.asarray(a, bf), np.float32)).to(torch.bfloat16)
          for a in (dt, xc, Bm, Cm)]
    y, h = selective_scan_plain(bt[0], bt[1], _t(A), bt[2], bt[3], _t(D),
                                _t(h0))
    assert y.dtype == h.dtype == torch.float32
    _close(y.numpy(), ref_y)
    _close(h.numpy(), ref_h)
    # db formed in f32 from the same values: beyond the bar
    y32, _ = selective_scan_plain(bt[0].float(), bt[1].float(), _t(A),
                                  bt[2].float(), bt[3].float(), _t(D),
                                  _t(h0))
    ref_y = np.asarray(ref_y)
    assert np.abs(y32.numpy() - ref_y).max() > \
        10 * REL * np.abs(ref_y).max()


def _bf16(a):
    """numpy f32 -> the torch bf16 tensor and the jnp bf16 array of the
    same values."""
    t = _t(a).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("S", [1, 37])
@pytest.mark.parametrize("di,ds", [(24, 4), (40, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selective_scan_ex2_mirror_matches_plain_and_reference(S, di, ds,
                                                               dtype):
    """The kernel's arithmetic (exp2 of the pre-scaled A, db's two bf16
    roundings, the FMAs) against the plain version and the reference's
    ``da``/``db`` and ``_selective_scan`` on the same inputs, within
    ``REC_TOL`` of the largest value; S = 37 is not a multiple of the
    kernel's 16-token stage."""
    dt, xc, A, Bm, Cm, D, h0 = _scan_inputs(2, S, di, ds, S + di)
    if dtype == "bfloat16":
        (tdt, jdt), (txc, jxc), (tB, jB), (tC, jC) = map(_bf16,
                                                         (dt, xc, Bm, Cm))
    else:
        tdt, txc, tB, tC = map(_t, (dt, xc, Bm, Cm))
        jdt, jxc, jB, jC = map(jnp.asarray, (dt, xc, Bm, Cm))
    args = (tdt, txc, _t(A), tB, tC, _t(D), _t(h0))
    y, h = selective_scan_ex2_plain(*args)
    py, ph = selective_scan_plain(*args)
    _close(y.numpy(), py.numpy(), REC_TOL)
    _close(h.numpy(), ph.numpy(), REC_TOL)
    wy, wh = _reference_scan(jdt, jxc, jnp.asarray(A), jB, jC,
                             jnp.asarray(D), jnp.asarray(h0))
    _close(y.numpy(), wy, REC_TOL)
    _close(h.numpy(), wh, REC_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_ex2_mirror_db_is_the_plain_versions(dtype):
    """With A so negative that da is 0, C one-hot on one state, D = 0 and
    h0 = 0, y is db: the mirror's equals the plain version's bit for bit
    (the two bf16 roundings are the same), and in bf16 it is not the f32
    product's."""
    dt, xc, A, Bm, Cm, D, h0 = _scan_inputs(2, 9, 32, 16, 4)
    A = np.full_like(A, -1e6)
    Cm = np.zeros_like(Cm)
    Cm[..., 5] = 1
    args = [_t(dt).to(dtype), _t(xc).to(dtype), _t(A), _t(Bm).to(dtype),
            _t(Cm).to(dtype), torch.zeros(32), torch.zeros(2, 32, 16)]
    y, _ = selective_scan_ex2_plain(*args)
    py, _ = selective_scan_plain(*args)
    assert torch.equal(y, py)
    f32 = (args[0].float() * args[3].float()[..., 5:6] * args[1].float())
    assert torch.equal(py == f32, torch.ones_like(py, dtype=torch.bool)) \
        == (dtype == torch.float32)


def test_selective_scan_ex2_mirror_at_an_underflowing_decay():
    """dt large enough that da underflows to 0 on some states: the mirror
    flushes da below f32's smallest normal, as ``ex2.approx.ftz`` does, and
    stays within the bar."""
    dt, xc, A, Bm, Cm, D, h0 = _scan_inputs(2, 21, 24, 16, 6)
    dt = dt * 40 + 20     # dt A down to ~ -1,500
    args = list(map(_t, (dt, xc, A, Bm, Cm, D, h0)))
    y, h = selective_scan_ex2_plain(*args)
    py, ph = selective_scan_plain(*args)
    _close(y.numpy(), py.numpy(), REC_TOL)
    _close(h.numpy(), ph.numpy(), REC_TOL)


def test_selective_scan_ex2_mirror_carries_the_state():
    """Two calls that carry the state, split at token 11 (inside the
    kernel's first 16-token stage), give one call's outputs bit for
    bit."""
    args = [_t(a) for a in _scan_inputs(1, 30, 16, 16, 2)]
    for i in (0, 1, 3, 4):
        args[i] = args[i].to(torch.bfloat16)
    y, h = selective_scan_ex2_plain(*args)
    cut = [a[:, :11] if i in (0, 1, 3, 4) else a for i, a in enumerate(args)]
    y1, h1 = selective_scan_ex2_plain(*cut)
    rest = [a[:, 11:] if i in (0, 1, 3, 4) else a for i, a in enumerate(args)]
    y2, h2 = selective_scan_ex2_plain(*rest[:-1], h1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)


def test_selective_scan_wrapper_takes_the_plain_version_on_the_cpu():
    args = list(map(_t, _scan_inputs(2, 7, 16, 4, 3)))
    out = torch.zeros_like(args[-1])
    before = ssk.launch_count()
    y, h = ssk.selective_scan(*args, out_state=out)
    want_y, want_h = selective_scan_plain(*args)
    assert ssk.launch_count() == before and h is out
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(out, want_h, rtol=0, atol=0)


def _mamba(seed):
    cfg = configs.smoke(ARCH).with_(act_dtype="float32")
    jcfg = jconfigs.smoke(ARCH).with_(act_dtype="float32")
    p = jax.tree.map(np.asarray, jssm.init_mamba(jax.random.PRNGKey(seed),
                                                 jcfg, jnp.float32))
    # conv_b and dt_bias start constant; make them vary by channel
    rng = np.random.default_rng(seed)
    p["conv_b"] = rng.standard_normal(p["conv_b"].shape).astype(np.float32)
    p["dt_bias"] = (p["dt_bias"] + rng.standard_normal(
        p["dt_bias"].shape)).astype(np.float32)
    return cfg, jcfg, p


@pytest.mark.parametrize("S", [1, 5, 256, 300])
@pytest.mark.parametrize("cached", [False, True])
def test_mamba_block_matches_reference(S, cached):
    cfg, jcfg, p = _mamba(S + 1)
    di = cfg.ssm.expand * cfg.d_model
    rng = np.random.default_rng(S)
    B = 2
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    kw, jkw = {}, {}
    if cached:
        conv = rng.standard_normal((B, di, cfg.ssm.d_conv - 1)).astype(
            np.float32)
        h = rng.standard_normal((B, di, cfg.ssm.d_state)).astype(np.float32)
        kw = {"cache": {"conv": _t(conv), "h": _t(h)}}
        jkw = {"cache": {"conv": jnp.asarray(conv), "h": jnp.asarray(h)}}
    got, gc = ssm.mamba_block(_t(x), {k: _t(v) for k, v in p.items()}, cfg,
                              **kw)
    want, wc = jssm.mamba_block(jnp.asarray(x), p, jcfg, **jkw)
    _close(got.numpy(), want)
    if cached:
        assert gc is kw["cache"]
        _close(gc["conv"].numpy(), wc["conv"])
        _close(gc["h"].numpy(), wc["h"])
    else:
        assert gc is None


def test_mamba_cache_continues_the_forward():
    """A prefill of 7 tokens then 5 single-token steps through one cache
    give the outputs of one 12-token pass."""
    cfg, _, p = _mamba(2)
    di = cfg.ssm.expand * cfg.d_model
    tp = {k: _t(v) for k, v in p.items()}
    x = _t(np.random.default_rng(8).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32))
    whole, _ = ssm.mamba_block(x, tp, cfg)
    cache = {"conv": torch.zeros(2, di, cfg.ssm.d_conv - 1),
             "h": torch.zeros(2, di, cfg.ssm.d_state)}
    parts = [ssm.mamba_block(x[:, :7], tp, cfg, cache)[0]]
    for t in range(7, 12):
        parts.append(ssm.mamba_block(x[:, t:t + 1], tp, cfg, cache)[0])
    _close(torch.cat(parts, 1).numpy(), whole.numpy())


def test_init_mamba_keeps_the_reference_leaves_and_types():
    cfg = configs.smoke(ARCH)
    jcfg = jconfigs.smoke(ARCH)
    p = ssm.init_mamba(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                       "cpu")
    jp = jssm.init_mamba(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    assert set(p) == set(jp)
    for k, v in jp.items():
        assert tuple(p[k].shape) == v.shape, k
        assert str(p[k].dtype).split(".")[-1] == str(v.dtype), k
    np.testing.assert_array_equal(p["A_log"].numpy(), np.asarray(jp["A_log"]))
