"""The port's LM serving path against the JAX package's, at f32 on the
same numpy weights and tokens: prefill logits and cache, teacher-forced
decode logits step by step (as ``tests/test_models.py`` checks the
reference against its own forward; danube also through a ring cache of
W=16 at max_len=48) and ``ServeEngine.generate``'s greedy tokens. Also
the ``device=`` rule and that nothing launches the kernel on the CPU."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import transformer as jT
from repro.serve import ServeEngine as JEngine
from repro_torch import configs
from repro_torch.kernels.flash_attn import kernel as fk
from repro_torch.models import transformer
from repro_torch.serve import ServeEngine

torch.set_num_threads(1)

ARCHS = ["qwen1.5-0.5b", "yi-9b", "h2o-danube-1.8b"]


def _pair(arch, window=None, seed=1):
    cfg = configs.smoke(arch).with_(act_dtype="float32")
    jcfg = jconfigs.smoke(arch).with_(act_dtype="float32")
    if window is not None:
        cfg, jcfg = cfg.with_(window=window), jcfg.with_(window=window)
    params = jax.tree.map(np.asarray,
                          jT.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for leaves in params["groups"].values():
        for name in ("bq", "bk", "bv"):
            if name in leaves["mixer"]:
                leaves["mixer"][name] = rng.standard_normal(
                    leaves["mixer"][name].shape, dtype=np.float32) * 0.1
    model = transformer.DecoderLM(cfg, device="cpu")
    transformer.load_reference_params(model, params)
    return cfg, jcfg, params, model


def _tokens(cfg, B, S, seed=2):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def _rel(got, want, scale):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want)))) / scale


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache(arch):
    cfg, jcfg, params, model = _pair(arch)
    toks = _tokens(cfg, 2, 30)
    lg, cache = transformer.prefill(model, torch.from_numpy(toks), 40)
    jlg, jcache = jT.prefill(params, jnp.asarray(toks), jcfg, max_len=40)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=1e-4,
                               atol=1e-4)
    assert cache["len"] == int(jcache["len"]) == 30
    assert ("pos" in cache) == ("pos" in jcache)
    for name, c in cache["layers"].items():
        for kv in ("k", "v"):
            np.testing.assert_allclose(
                c[kv].numpy(), np.asarray(jcache["layers"][name][kv]),
                rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_reference(arch):
    cfg, jcfg, params, model = _pair(arch)
    B, S, P = 2, 40, 34
    toks = _tokens(cfg, B, S)
    ref = np.asarray(jT.forward(params, jnp.asarray(toks), jcfg))
    scale = float(np.max(np.abs(ref)))
    lg, cache = transformer.prefill(model, torch.from_numpy(toks[:, :P]), S)
    jlg, jcache = jT.prefill(params, jnp.asarray(toks[:, :P]), jcfg,
                             max_len=S)
    errs = [_rel(lg.numpy()[:, 0], ref[:, P - 1], scale)]
    for i in range(P, S - 1):
        step = toks[:, i:i + 1]
        lg, cache = transformer.decode_step(model, cache,
                                            torch.from_numpy(step))
        jlg, jcache = jT.decode_step(params, jcache, jnp.asarray(step), jcfg)
        errs.append(_rel(lg.numpy(), jlg, scale))
        errs.append(_rel(lg.numpy()[:, 0], ref[:, i], scale))
    assert max(errs) < 1e-4, errs


def test_ring_cache_decode_matches_reference():
    """Windowed decode through a ring cache (W=16 < max_len=48) against
    the reference's ring cache and its full-attention forward."""
    cfg, jcfg, params, model = _pair("h2o-danube-1.8b", window=16, seed=3)
    B, S = 2, 48
    toks = _tokens(cfg, B, S, seed=4)
    ref = np.asarray(jT.forward(params, jnp.asarray(toks), jcfg))
    scale = float(np.max(np.abs(ref)))
    cache = transformer.init_cache(cfg, B, S, device="cpu")
    jcache = jT.init_cache(jcfg, B, S)
    assert "pos" in cache and cache["layers"]["pos0"]["k"].shape[3] == 16
    errs = []
    for i in range(S):
        step = toks[:, i:i + 1]
        lg, cache = transformer.decode_step(model, cache,
                                            torch.from_numpy(step))
        jlg, jcache = jT.decode_step(params, jcache, jnp.asarray(step), jcfg)
        errs.append(_rel(lg.numpy(), jlg, scale))
        errs.append(_rel(lg.numpy()[:, 0], ref[:, i], scale))
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    assert max(errs) < 1e-4, errs


@pytest.mark.parametrize("arch,window", [("qwen1.5-0.5b", None),
                                         ("yi-9b", None),
                                         ("h2o-danube-1.8b", None),
                                         ("h2o-danube-1.8b", 16)])
def test_generate_greedy_tokens_match_reference(arch, window):
    cfg, jcfg, params, model = _pair(arch, window=window, seed=5)
    prompts = _tokens(cfg, 3, 24, seed=6)
    before = fk.launch_count()
    got = ServeEngine(cfg, model, 40).generate(torch.from_numpy(prompts),
                                               16)
    want = JEngine(jcfg, params, 40).generate(jnp.asarray(prompts), 16)
    assert got.dtype == torch.int32 and got.shape == (3, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert fk.launch_count() == before


def test_generate_sampling_and_limits():
    cfg, _, _, model = _pair("qwen1.5-0.5b")
    eng = ServeEngine(cfg, model, 32)
    prompts = torch.from_numpy(_tokens(cfg, 2, 8))
    draws = [eng.generate(prompts, 6, greedy=False,
                          generator=torch.Generator().manual_seed(9))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    assert int(draws[0].min()) >= 0 and int(draws[0].max()) < cfg.vocab
    with pytest.raises(ValueError, match="cache slots"):
        eng.generate(prompts, 26)
    with pytest.raises(ValueError, match="config"):
        ServeEngine(cfg.with_(name="other"), model, 32)


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.smoke("qwen1.5-0.5b")
    for call in (lambda: transformer.DecoderLM(cfg),
                 lambda: transformer.init_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    model = transformer.DecoderLM(cfg, device="cpu")
    assert model.device == torch.device("cpu")
    assert model.embed.dtype == torch.bfloat16
