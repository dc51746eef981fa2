"""The port's RWKV6 block (``repro_torch/models/rwkv.py``) and the plain
version of the wkv6 kernel (``kernels/wkv/ref.py``) against the JAX
package's ``time_mix``, ``channel_mix`` and ``rwkv_block`` at f32, on the
same numpy inputs and weights (the reference's zero token-shift mixes
``mu_*`` and constant ``w0`` made random, so every path carries weight).
Outputs and states within 1e-5 of their largest magnitude (f32 sums in
another order). The group norm takes the population variance, as
``jnp.var``: at head width 32, ``torch.var``'s default (``correction=1``)
would be 1.6% off, far outside the bar. A cache is carried across a
prefill and single-token steps, and its token shifts and wkv state come
back updated in place."""

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
from repro_torch.kernels.wkv.ref import wkv6_plain, wkv6_split_plain
from repro_torch.models import rwkv

torch.set_num_threads(1)

REL = 1e-5
# the CUDA kernel's bar against the plain version (chip_smoke.REC_TOL,
# tests/test_torch_cuda.py:REC_REL), held here by its CPU mirror
REC_TOL = 2e-5
ARCH = "rwkv6-3b"


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _reference_wkv(r, k, v, w, u, s0):
    """rwkv.py:58-69 (``step`` under ``lax.scan``) as the reference runs
    it, on (B, S, H, hd) inputs."""
    def step(s, inp):
        rt, kt, vt, wt = inp
        kv = jnp.einsum("bhk,bhv->bhkv", kt.astype(jnp.float32),
                        vt.astype(jnp.float32))
        out = jnp.einsum("bhk,bhkv->bhv", rt.astype(jnp.float32),
                         s + u[None, :, :, None] * kv)
        return wt[..., None] * s + kv, out

    xs = tuple(a.transpose(1, 0, 2, 3) for a in (r, k, v, w))
    s, ys = jax.lax.scan(step, s0, xs)
    return ys.transpose(1, 0, 2, 3), s


@pytest.mark.parametrize("S", [1, 5, 300])
def test_wkv6_plain_matches_reference(S):
    rng = np.random.default_rng(S)
    B, H, hd = 2, 3, 32
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, S, H, hd)) - 1)).astype(
        np.float32)
    u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    y, s = wkv6_plain(*map(_t, (r, k, v, w, u, s0)))
    wy, ws = _reference_wkv(*map(jnp.asarray, (r, k, v, w, u, s0)))
    _close(y.numpy(), wy)
    _close(s.numpy(), ws)


def _wkv_numpy(B, S, H, hd, seed, w_lo=None):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, S, H, hd)) - 1))
    if w_lo is not None:   # decays near 0 and near 1
        w = np.where(rng.uniform(size=w.shape) < 0.5, w_lo,
                     1 - w_lo)
    u = rng.standard_normal((H, hd)) * 0.1
    s0 = rng.standard_normal((B, H, hd, hd))
    return [a.astype(np.float32) for a in (r, k, v, w, u, s0)]


@pytest.mark.parametrize("S", [1, 37])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_split_mirror_matches_plain_and_reference(S, hd, dtype):
    """The kernel's decomposition (bonus factored out, keys in groups of
    8, the groups' butterfly sum, ``fma(w, s, k v)``) against the plain
    version and the reference's scan on the same inputs, within
    ``REC_TOL`` of the largest value; S = 37 is not a multiple of the
    kernel's 16-token stage."""
    args = _wkv_numpy(2, S, 3, hd, S + hd)
    t = [_t(a) for a in args]
    t[:3] = [a.to(dtype) for a in t[:3]]
    y, s = wkv6_split_plain(*t)
    py, ps = wkv6_plain(*t)
    _close(y.numpy(), py.numpy(), REC_TOL)
    _close(s.numpy(), ps.numpy(), REC_TOL)
    # the reference on the same (rounded) values
    j = [jnp.asarray(a.float().numpy()) for a in t]
    wy, ws = _reference_wkv(*j)
    _close(y.numpy(), wy, REC_TOL)
    _close(s.numpy(), ws, REC_TOL)


@pytest.mark.parametrize("w_lo", [1e-6, 1e-2])
def test_wkv6_split_mirror_at_extreme_decays(w_lo):
    """Decays near 0 and near 1 (each token's keys drawn from both)."""
    t = [_t(a) for a in _wkv_numpy(2, 21, 2, 64, 5, w_lo)]
    y, s = wkv6_split_plain(*t)
    py, ps = wkv6_plain(*t)
    _close(y.numpy(), py.numpy(), REC_TOL)
    _close(s.numpy(), ps.numpy(), REC_TOL)


def test_wkv6_split_mirror_carries_the_state():
    """Two calls that carry the state, split at token 13 (inside the
    kernel's first 16-token stage), give one call's outputs bit for
    bit."""
    t = [_t(a) for a in _wkv_numpy(1, 29, 2, 32, 8)]
    y, s = wkv6_split_plain(*t)
    y1, s1 = wkv6_split_plain(*[a[:, :13] for a in t[:4]], *t[4:])
    y2, s2 = wkv6_split_plain(*[a[:, 13:] for a in t[:4]], t[4], s1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(s2, s)


def test_wkv6_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(1)
    args = [_t(rng.standard_normal(s).astype(np.float32)) for s in
            ((2, 4, 2, 32),) * 4 + ((2, 32), (2, 2, 32, 32))]
    out = torch.zeros_like(args[-1])
    before = wk.launch_count()
    y, s = wk.wkv6(*args, out_state=out)
    want_y, want_s = wkv6_plain(*args)
    assert wk.launch_count() == before and s is out
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(out, want_s, rtol=0, atol=0)


def _params(seed):
    cfg = configs.smoke(ARCH).with_(act_dtype="float32")
    jcfg = jconfigs.smoke(ARCH).with_(act_dtype="float32")
    p = jax.tree.map(np.asarray, jrwkv.init_rwkv(jax.random.PRNGKey(seed),
                                                 jcfg, jnp.float32))
    rng = np.random.default_rng(seed)
    for name in ("mu_x", "mu_w", "mu_k", "mu_v", "mu_r", "mu_g", "mu_ck",
                 "mu_cr"):
        p[name] = rng.uniform(0, 1, p[name].shape).astype(np.float32)
    p["w0"] = (p["w0"] + rng.standard_normal(p["w0"].shape) * 0.5).astype(
        np.float32)
    return cfg, jcfg, p


def _cache(cfg, B, rng):
    D, hd = cfg.d_model, cfg.rwkv.head_dim
    return {"shift_t": rng.standard_normal((B, D)).astype(np.float32),
            "shift_c": rng.standard_normal((B, D)).astype(np.float32),
            "wkv": rng.standard_normal((B, D // hd, hd, hd)).astype(
                np.float32)}


@pytest.mark.parametrize("fn", ["time_mix", "channel_mix", "rwkv_block"])
@pytest.mark.parametrize("S,cached", [(1, True), (5, False), (5, True),
                                      (40, False)])
def test_block_matches_reference(fn, S, cached):
    cfg, jcfg, p = _params(S)
    rng = np.random.default_rng(S + 10)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    c = _cache(cfg, 2, rng) if cached else None
    tc = None if c is None else {k: _t(v) for k, v in c.items()}
    jc = None if c is None else {k: jnp.asarray(v) for k, v in c.items()}
    got, gc = getattr(rwkv, fn)(_t(x), {k: _t(v) for k, v in p.items()},
                                cfg, tc)
    want, wc = getattr(jrwkv, fn)(jnp.asarray(x), p, jcfg, jc)
    _close(got.numpy(), want)
    if cached:
        assert gc is tc
        for name, val in wc.items():
            _close(gc[name].numpy(), val)


def test_cache_continues_the_forward():
    """A prefill of 9 tokens then 4 single-token steps through one cache
    give the outputs of one 13-token pass (zero initial state)."""
    cfg, _, p = _params(3)
    tp = {k: _t(v) for k, v in p.items()}
    D, hd = cfg.d_model, cfg.rwkv.head_dim
    x = _t(np.random.default_rng(4).standard_normal((2, 13, D)).astype(
        np.float32))
    whole, _ = rwkv.rwkv_block(x, tp, cfg)
    cache = {"shift_t": torch.zeros(2, D), "shift_c": torch.zeros(2, D),
             "wkv": torch.zeros(2, D // hd, hd, hd)}
    parts = [rwkv.rwkv_block(x[:, :9], tp, cfg, cache)[0]]
    for t in range(9, 13):
        parts.append(rwkv.rwkv_block(x[:, t:t + 1], tp, cfg, cache)[0])
    _close(torch.cat(parts, 1).numpy(), whole.numpy())


def test_init_rwkv_keeps_the_reference_leaves_and_types():
    cfg, jcfg = configs.smoke(ARCH), jconfigs.smoke(ARCH)
    p = rwkv.init_rwkv(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                       "cpu")
    jp = jrwkv.init_rwkv(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    assert set(p) == set(jp)
    for k, v in jp.items():
        assert tuple(p[k].shape) == v.shape, k
        assert str(p[k].dtype).split(".")[-1] == str(v.dtype), k
