"""The port's encoder-decoder (seamless-m4t-large-v2's smoke config)
against the JAX package's ``repro.models.encdec``, at f32 on the same
numpy weights (carried by ``load_reference_params``), frames and tokens:
the cross-attention layer in both its branches, ``encode``, teacher-forced
``forward`` logits, the ``loss_fn`` value, and ``prefill`` plus
``decode_step`` against the reference's, each within 1e-4 of the
reference's largest value; the port's own decode against its forward
(``tests/test_models.py::test_encdec_decode_matches_forward``'s bar).
Also the full configs' parameter counts (built on the ``meta`` device)
against ``jax.eval_shape`` of the reference's ``init_params``, the
state-dict names' round trip, and training's remat: each layer recomputed
whole, with the gradients of remat "none" (the gradients against the
reference's are ``tests/test_torch_train.py``'s)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import encdec as jE
from repro.models import layers as jlayers
from repro.models import transformer as jT
from repro_torch import configs
from repro_torch.kernels.flash_attn import kernel as fk
from repro_torch.models import encdec, layers, transformer

torch.set_num_threads(1)

ARCH = "seamless-m4t-large-v2"
B, S_ENC, S_DEC = 2, 12, 10


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want))) / float(
        np.max(np.abs(want)))


def _pair(seed=0):
    cfg = configs.smoke(ARCH).with_(act_dtype="float32")
    jcfg = jconfigs.smoke(ARCH).with_(act_dtype="float32")
    params = jax.tree.map(np.asarray,
                          jE.init_params(jax.random.PRNGKey(seed), jcfg))
    # the reference initialises the adapter's bias to 0: make it count
    params["adapter"]["b"] = np.random.default_rng(seed).standard_normal(
        params["adapter"]["b"].shape, dtype=np.float32) * 0.1
    model = encdec.load_reference_params(
        encdec.EncDecLM(cfg, device="cpu"), params)
    return cfg, jcfg, params, model


def _inputs(cfg, seed=3, s_dec=S_DEC):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, S_ENC, cfg.frontend_dim),
                                 dtype=np.float32)
    toks = rng.integers(0, cfg.vocab, (B, s_dec)).astype(np.int32)
    return frames, toks


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("branch", ["memory", "mem_kv"])
def test_cross_attention_block(branch):
    cfg = configs.smoke(ARCH).with_(act_dtype="float32")
    jcfg = jconfigs.smoke(ARCH).with_(act_dtype="float32")
    p = jax.tree.map(np.asarray, jlayers.init_cross_attention(
        jax.random.PRNGKey(4), jcfg, jnp.float32))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 5, cfg.d_model), dtype=np.float32)
    mem = rng.standard_normal((B, S_ENC, cfg.d_model), dtype=np.float32)
    want, (wk, wv) = jlayers.cross_attention_block(
        jnp.asarray(x), p, jcfg, memory=jnp.asarray(mem))
    tp = {k: _t(v) for k, v in p.items()}
    kw = (dict(memory=_t(mem)) if branch == "memory" else
          dict(mem_kv=(_t(wk), _t(wv))))
    got, (gk, gv) = layers.cross_attention_block(_t(x), tp, cfg, **kw)
    assert gk.shape == (B, cfg.n_heads, S_ENC, cfg.hd)
    assert _rel(got.numpy(), want) < 1e-4
    assert _rel(gk.numpy(), wk) < 1e-4 and _rel(gv.numpy(), wv) < 1e-4


def test_encode_matches_reference():
    cfg, jcfg, params, model = _pair()
    frames, _ = _inputs(cfg)
    got = encdec.encode(model, _t(frames))
    want = jE.encode(params, jnp.asarray(frames), jcfg)
    assert got.shape == (B, S_ENC, cfg.d_model)
    assert _rel(got.numpy(), want) < 1e-4


def test_forward_logits_match_reference():
    cfg, jcfg, params, model = _pair(1)
    frames, toks = _inputs(cfg, 5)
    before = fk.launch_count()
    got = encdec.forward(model, _t(frames), _t(toks))
    assert fk.launch_count() == before    # the CPU takes the plain version
    want = jE.forward(params, jnp.asarray(frames), jnp.asarray(toks), jcfg)
    assert got.shape == (B, S_DEC, cfg.vocab)
    assert _rel(got.numpy(), want) < 1e-4


def test_loss_matches_reference():
    cfg, jcfg, params, model = _pair(2)
    frames, toks = _inputs(cfg, 6)
    labels = np.roll(toks, -1, axis=1)
    labels[0, -3:] = -1                   # ignored positions
    with torch.no_grad():
        got = encdec.loss_fn(model, _t(frames), _t(toks), _t(labels))
    want = float(jE.loss_fn(params, jnp.asarray(frames), jnp.asarray(toks),
                            jnp.asarray(labels), jcfg))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-4 * abs(want)


def test_prefill_and_decode_match_reference():
    """The port's prefill and decode steps against the reference's on the
    same tokens: logits at every step and the caches."""
    cfg, jcfg, params, model = _pair(3)
    frames, toks = _inputs(cfg, 7, s_dec=14)
    P, max_len = 8, 16
    lg, cache = encdec.prefill(model, _t(frames), _t(toks[:, :P]), max_len)
    jlg, jcache = jE.prefill(params, jnp.asarray(frames),
                             jnp.asarray(toks[:, :P]), jcfg, max_len)
    assert lg.shape == (B, 1, cfg.vocab)
    errs = [_rel(lg.numpy(), jlg)]
    for i in range(P, toks.shape[1]):
        lg, cache = encdec.decode_step(model, cache, _t(toks[:, i:i + 1]))
        jlg, jcache = jE.decode_step(params, jcache,
                                     jnp.asarray(toks[:, i:i + 1]), jcfg)
        errs.append(_rel(lg.numpy(), jlg))
    assert max(errs) < 1e-4, errs
    assert cache["len"] == int(jcache["len"]) == toks.shape[1]
    for name in ("self_k", "self_v", "mem_k", "mem_v"):
        assert tuple(cache[name].shape) == jcache[name].shape
        assert _rel(cache[name].numpy(), jcache[name]) < 1e-4, name


def test_decode_matches_own_forward():
    """Prefill and teacher-forced decode steps through the caches give
    the port's own forward's logits (1e-4 of their scale)."""
    cfg, _, _, model = _pair(4)
    frames, toks = _inputs(cfg, 8, s_dec=20)
    ref = encdec.forward(model, _t(frames), _t(toks)).numpy()
    P = 12
    lg, cache = encdec.prefill(model, _t(frames), _t(toks[:, :P]), 20)
    errs = [np.abs(lg[:, 0].numpy() - ref[:, P - 1]).max()]
    for i in range(P, toks.shape[1] - 1):
        lg, cache = encdec.decode_step(model, cache, _t(toks[:, i:i + 1]))
        errs.append(np.abs(lg[:, 0].numpy() - ref[:, i]).max())
    assert max(errs) / np.abs(ref).max() < 1e-4, errs


@pytest.mark.parametrize("arch,count", [(ARCH, 1_773_478_912),
                                        ("internvl2-26b", 19_312_281_600)])
def test_full_config_parameter_counts_match_reference(arch, count):
    cfg, jcfg = configs.ARCHS[arch], jconfigs.ARCHS[arch]
    if cfg.kind == "encdec":
        model, jinit = encdec.EncDecLM(cfg, device="meta"), jE.init_params
    else:
        model = transformer.DecoderLM(cfg, device="meta")
        jinit = jT.init_params
    shapes = jax.eval_shape(lambda k: jinit(k, jcfg), jax.random.PRNGKey(0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    assert transformer.param_count(model) == want == count
    assert model.embed.device.type == "meta"


@pytest.mark.parametrize("arch", [ARCH, "internvl2-26b"])
def test_state_dict_names_round_trip(arch):
    cfg = configs.smoke(arch).with_(act_dtype="float32")
    jcfg = jconfigs.smoke(arch).with_(act_dtype="float32")
    if cfg.kind == "encdec":
        params = jE.init_params(jax.random.PRNGKey(5), jcfg)
        model = encdec.EncDecLM(cfg, device="cpu")
        names = ("encoder.1.attn.wq", "decoder.0.xattn.wk", "adapter.w",
                 "enc_ln")
    else:
        params = jT.init_params(jax.random.PRNGKey(5), jcfg)
        model = transformer.DecoderLM(cfg, device="cpu")
        names = ("groups.1.pos0.mixer.wq", "adapter.w", "adapter.b")
    params = jax.tree.map(np.asarray, params)
    transformer.load_reference_params(model, params)
    sd = model.state_dict()
    assert set(names) <= set(sd)
    np.testing.assert_array_equal(sd["adapter.w"].numpy(),
                                  params["adapter"]["w"])
    if cfg.kind == "encdec":
        np.testing.assert_array_equal(sd["decoder.1.xattn.wv"].numpy(),
                                      params["decoder"]["xattn"]["wv"][1])
    back = transformer.reference_params(model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="tree has"):
        transformer.load_reference_params(
            model, {k: v for k, v in params.items() if k != "adapter"})


def test_decoder_lm_refuses_an_encdec_config():
    with pytest.raises(ValueError, match="models.encdec"):
        transformer.DecoderLM(configs.smoke(ARCH), device="cpu")
    with pytest.raises(ValueError, match="kind 'encdec'"):
        encdec.EncDecLM(configs.smoke("qwen1.5-0.5b"), device="cpu")


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_training_remat_recomputes_each_layer(remat, monkeypatch):
    """With grad on, every attention call (the encoder's, the decoder's
    self and cross attention) goes through the training form's forward
    once a layer without remat and again in the backward's recompute
    with it (each layer checkpointed whole, the reference's
    ``jax.checkpoint``); the gradients equal remat "none"'s. The serving
    model has no gradients, ``train=True`` every parameter."""
    calls = []
    fwd = fk._forward_lse

    def counting(*a, **kw):
        calls.append(a[0].shape[2] != a[1].shape[2])   # cross attention
        return fwd(*a, **kw)

    monkeypatch.setattr(fk, "_forward_lse", counting)
    frames, toks = _inputs(configs.smoke(ARCH))
    labels = np.roll(toks, -1, axis=1)
    out = {}
    for mode in ("none", remat):
        cfg = configs.smoke(ARCH).with_(act_dtype="float32", remat=mode)
        model = encdec.EncDecLM(cfg, device="cpu", train=True)
        assert all(p.requires_grad for p in model.parameters())
        calls.clear()
        loss = encdec.loss_fn(model, _t(frames), _t(toks), _t(labels))
        out[mode] = torch.autograd.grad(loss, list(model.parameters()))
        once = cfg.encoder_layers + 2 * cfg.n_layers
        assert len(calls) == once * (1 if mode == "none" else 2), mode
        assert sum(calls) == cfg.n_layers * (1 if mode == "none" else 2)
    for a, b in zip(out["none"], out[remat]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    assert not any(p.requires_grad for p in encdec.EncDecLM(
        configs.smoke(ARCH), device="cpu").parameters())
    with pytest.raises(ValueError, match="remat"):
        encdec.EncDecLM(configs.smoke(ARCH).with_(remat="some"),
                        device="cpu")
