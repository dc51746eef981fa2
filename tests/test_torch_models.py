"""The port's LM layers and decoder against the JAX package's, at f32 on
the same numpy inputs and weights: ``rms_norm``, ``rotary``,
``swiglu_block``, ``attention_block`` in its three cache branches (none,
ring, linear), and teacher-forced ``forward`` logits of the smoke
configs of qwen1.5-0.5b (QKV bias, set nonzero here since both packages
initialise it to 0), yi-9b (GQA), h2o-danube-1.8b (sliding window),
phi3.5-moe and qwen3-moe (MoE FFNs), jamba (Mamba, attention and MoE in
one pattern) and rwkv6 (RWKV6 layers), with the weights carried by
``load_reference_params``. For the mixer archs, prefill plus
step-by-step decode against the reference's teacher-forced forward, under
``tests/test_models.py``'s protocol (f32, MoE capacity 4.0 so no token
drops, B=2, S=40, within 1e-4 of the logits' scale). internvl2's vision
frontend stub: ``forward``, ``loss_fn`` and prefill plus decode with
``prefix_embed`` against the reference's, each within 1e-4 of the
reference's largest value; the paper's workload grid (``configs.psi``)
equal to the reference's."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.configs.psi as jpsi
from repro.models import encdec as jE
from repro.models import layers as jlayers
from repro.models import transformer as jT
from repro_torch import configs
from repro_torch.configs import psi
from repro_torch.kernels.flash_attn import kernel as fk
from repro_torch.models import encdec, layers, transformer

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def _cfg(arch):
    cfg = configs.smoke(arch).with_(act_dtype="float32")
    return cfg, jconfigs.smoke(arch).with_(act_dtype="float32")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# the reference's XLA knobs, which the port's ModelCfg does not carry
# (``moe_group`` it does: capacity is counted per group)
XLA_FIELDS = {"attn_chunk_q", "attn_chunk_k", "attn_causal_prune",
              "moe_shard_map", "scan_layers"}


def _same_cfg(cfg, jcfg):
    """Every field the port keeps equal to the reference's, and the
    reference's other fields exactly its XLA knobs."""
    names = [f.name for f in dataclasses.fields(cfg)]
    jnames = {f.name for f in dataclasses.fields(jcfg)}
    assert set(names) <= jnames and jnames - set(names) == XLA_FIELDS
    for name in names:
        assert repr(getattr(cfg, name)) == repr(getattr(jcfg, name)), name


def test_configs_are_the_reference_data():
    assert list(configs.ARCHS) == list(jconfigs.ARCHS)
    defaults = {f.name: f.default
                for f in dataclasses.fields(type(jconfigs.ARCHS["yi-9b"]))}
    for arch, cfg in configs.ARCHS.items():
        jcfg = jconfigs.ARCHS[arch]
        _same_cfg(cfg, jcfg)
        # a published config leaves every XLA knob at its default
        assert all(getattr(jcfg, n) == defaults[n] for n in XLA_FIELDS)
        _same_cfg(configs.smoke(arch), jconfigs.smoke(arch))
        assert configs.cells(arch) == jconfigs.cells(arch)
    assert {k: repr(v) for k, v in configs.SHAPES.items()} == \
        {k: repr(v) for k, v in jconfigs.SHAPES.items()}


def test_psi_workloads_are_the_reference_data():
    """``configs.psi`` is the reference's grid, field by field."""
    assert [f.name for f in dataclasses.fields(psi.PsiWorkload)] == \
        [f.name for f in dataclasses.fields(jpsi.PsiWorkload)]
    assert dataclasses.asdict(psi.PsiWorkload("w", "uniform", 1)) == \
        dataclasses.asdict(jpsi.PsiWorkload("w", "uniform", 1))
    for name in ("FIG3", "FIG9", "FIG10", "SERVICE"):
        got, want = getattr(psi, name), getattr(jpsi, name)
        got, want = (got, want) if isinstance(got, tuple) else \
            ((got,), (want,))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert type(a).__name__ == type(b).__name__
            assert dataclasses.asdict(a) == dataclasses.asdict(b), name


def test_rms_norm_and_rotary():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 4, 32), dtype=np.float32)
    scale = rng.standard_normal(32, dtype=np.float32)
    pos = rng.integers(0, 5000, (2, 12)).astype(np.int32)
    np.testing.assert_allclose(
        layers.rms_norm(_t(x), _t(scale), 1e-5).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale),
                                    1e-5)), **TOL)
    np.testing.assert_allclose(
        layers.rotary(_t(x), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(jlayers.rotary(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        **TOL)


def test_swiglu_block():
    cfg, jcfg = _cfg("qwen1.5-0.5b")
    p = _np(jlayers.init_swiglu(jax.random.PRNGKey(1), jcfg, jnp.float32))
    x = np.random.default_rng(1).standard_normal((2, 9, cfg.d_model),
                                                 dtype=np.float32)
    got = layers.swiglu_block(_t(x), {k: _t(v) for k, v in p.items()}, cfg)
    want = jlayers.swiglu_block(jnp.asarray(x), p, jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _attn_params(cfg, jcfg, seed):
    p = _np(jlayers.init_attention(jax.random.PRNGKey(seed), jcfg,
                                   jnp.float32))
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        if name in p:
            p[name] = rng.standard_normal(p[name].shape,
                                          dtype=np.float32) * 0.1
    return p


@pytest.mark.parametrize("arch,branch,S,L0", [
    ("qwen1.5-0.5b", "none", 20, 0),
    ("qwen1.5-0.5b", "linear", 7, 0),       # prefill into a linear cache
    ("yi-9b", "linear", 1, 33),             # a decode step, GQA
    ("h2o-danube-1.8b", "ring", 20, 0),     # ring prefill, S >= W
    ("h2o-danube-1.8b", "ring", 1, 37),     # ring decode, S < W
])
def test_attention_block_cache_branches(arch, branch, S, L0):
    cfg, jcfg = _cfg(arch)
    if branch == "ring":
        cfg, jcfg = cfg.with_(window=16), jcfg.with_(window=16)
    p = _attn_params(cfg, jcfg, 2)
    rng = np.random.default_rng(3)
    B, W = 2, 16 if branch == "ring" else 48
    x = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(L0 + np.arange(S, dtype=np.int32), (B, S))
    shape = (B, cfg.n_kv_heads, W, cfg.hd)
    ck = rng.standard_normal(shape, dtype=np.float32)
    cv = rng.standard_normal(shape, dtype=np.float32)
    tp = {k: _t(v) for k, v in p.items()}
    kw, jkw = {}, {}
    if branch != "none":
        kw = dict(cache=dict(k=_t(ck), v=_t(cv)), cache_len=L0)
        jkw = dict(cache=dict(k=jnp.asarray(ck), v=jnp.asarray(cv)),
                   cache_len=jnp.int32(L0))
    if branch == "ring":
        slot_pos = np.full(W, -1, np.int32)
        live = np.arange(max(0, L0 - W), L0)
        slot_pos[live % W] = live
        kw["cache_pos"] = torch.from_numpy(slot_pos)
        jkw["cache_pos"] = jnp.asarray(slot_pos)
    got, gc = layers.attention_block(_t(x), tp, cfg, torch.from_numpy(
        np.ascontiguousarray(pos)), **kw)
    want, wc = jlayers.attention_block(jnp.asarray(x), p, jcfg,
                                       jnp.asarray(pos), **jkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if branch != "none":
        for name in ("k", "v"):
            np.testing.assert_allclose(gc[name].numpy(),
                                       np.asarray(wc[name]), **TOL)


def _models(arch, seed=0):
    cfg, jcfg = _cfg(arch)
    params = _np(jT.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for leaves in params["groups"].values():
        mixer = leaves["mixer"]
        for name in ("bq", "bk", "bv"):
            if name in mixer:
                mixer[name] = rng.standard_normal(
                    mixer[name].shape, dtype=np.float32) * 0.1
    model = transformer.DecoderLM(cfg, device="cpu")
    transformer.load_reference_params(model, params)
    return cfg, jcfg, params, model


MIXER_ARCHS = ["phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b",
               "jamba-1.5-large-398b", "rwkv6-3b"]


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "yi-9b",
                                  "h2o-danube-1.8b", *MIXER_ARCHS])
def test_forward_logits_match_reference(arch):
    cfg, jcfg, params, model = _models(arch)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 40)
                                             ).astype(np.int32)
    before = fk.launch_count()
    got = transformer.forward(model, torch.from_numpy(toks))
    want = jT.forward(params, jnp.asarray(toks), jcfg)
    assert got.shape == (2, 40, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert fk.launch_count() == before


def test_state_dict_names_follow_the_reference_tree():
    cfg, _, params, model = _models("qwen1.5-0.5b")
    sd = model.state_dict()
    assert "groups.1.pos0.mixer.wq" in sd and "embed" in sd
    np.testing.assert_array_equal(
        sd["groups.1.pos0.mixer.bq"].numpy(),
        params["groups"]["pos0"]["mixer"]["bq"][1])
    assert transformer.param_count(model) == sum(
        np.asarray(a).size for a in jax.tree.leaves(params))
    bad = dict(params, extra=np.zeros(1))
    with pytest.raises(ValueError, match="tree has"):
        transformer.load_reference_params(model, bad)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-1.5-large-398b",
                                  "qwen3-moe-235b-a22b",
                                  "seamless-m4t-large-v2", "internvl2-26b"])
def test_unported_mixers_raise(arch):
    """Every arch once unported builds, and its smoke forward matches
    the reference's: the mixer archs, the encoder-decoder (through
    ``models.encdec``, on frame embeddings) and the vision frontend
    (``prefix_embed``)."""
    if arch == "seamless-m4t-large-v2":
        cfg, jcfg = _cfg(arch)
        params = _np(jE.init_params(jax.random.PRNGKey(1), jcfg))
        model = encdec.load_reference_params(
            encdec.EncDecLM(cfg, device="cpu"), params)
        rng = np.random.default_rng(8)
        frames = rng.standard_normal((2, 16, cfg.frontend_dim),
                                     dtype=np.float32)
        toks = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
        got = encdec.forward(model, _t(frames), torch.from_numpy(toks))
        want = jE.forward(params, jnp.asarray(frames), jnp.asarray(toks),
                          jcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        return
    if arch == "internvl2-26b":
        cfg, jcfg, params, model = _frontend_models(1)
        toks, pre = _frontend_inputs(cfg, 8, 24)
        got = transformer.forward(model, torch.from_numpy(toks), _t(pre))
        want = jT.forward(params, jnp.asarray(toks), jcfg,
                          prefix_embed=jnp.asarray(pre))
        assert got.shape == (2, cfg.frontend_seq + 24, cfg.vocab)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        return
    cfg, jcfg, params, model = _models(arch, seed=1)
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 24)
                                             ).astype(np.int32)
    got = transformer.forward(model, torch.from_numpy(toks))
    want = jT.forward(params, jnp.asarray(toks), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", MIXER_ARCHS)
def test_decode_matches_reference_forward(arch):
    cfg, jcfg = _cfg(arch)
    if cfg.moe is not None:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
        jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe,
                                                  capacity_factor=4.0))
    params = _np(jT.init_params(jax.random.PRNGKey(1), jcfg))
    model = transformer.load_reference_params(
        transformer.DecoderLM(cfg, device="cpu"), params)
    B, S = 2, 40
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (B, S)
                                             ).astype(np.int32)
    ref = np.asarray(jT.forward(params, jnp.asarray(toks), jcfg))
    P = S - 6
    lg, cache = transformer.prefill(model, torch.from_numpy(toks[:, :P]), S)
    errs = [np.abs(lg[:, 0].numpy() - ref[:, P - 1]).max()]
    for i in range(P, S - 1):
        lg, cache = transformer.decode_step(
            model, cache, torch.from_numpy(toks[:, i:i + 1]))
        errs.append(np.abs(lg[:, 0].numpy() - ref[:, i]).max())
    assert max(errs) / np.abs(ref).max() < 1e-4, (arch, errs)


def test_training_mixers_route_through_the_recurrence_functions():
    """``DecoderLM(train=True)`` with Mamba and RWKV6 layers (the smoke
    configs of jamba and rwkv6, f32, on the CPU) trains through the
    autograd functions of the recurrence kernels: under remat "dots" a
    loss and its gradients call each function's forward twice a layer
    (the forward and the backward's recompute) and its backward once,
    and every recurrence parameter gets a finite gradient."""
    from repro_torch.kernels.selective_scan import kernel as ssk
    from repro_torch.kernels.wkv import kernel as wk
    for arch, mod, kind in (("jamba-1.5-large-398b", ssk, "m"),
                            ("rwkv6-3b", wk, "r")):
        cfg = configs.smoke(arch).with_(act_dtype="float32")
        assert cfg.remat == "dots"
        model = transformer.DecoderLM(cfg, device="cpu", train=True)
        rng = np.random.default_rng(7)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 24)))
        labels = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 24)))
        n = cfg.n_groups * cfg.pattern.count(kind)
        before = (mod.call_count("forward"), mod.call_count("backward"))
        loss = transformer.loss_fn(model, toks, labels)
        named = dict(model.named_parameters())
        grads = dict(zip(named, torch.autograd.grad(loss,
                                                    list(named.values()))))
        assert (mod.call_count("forward") - before[0],
                mod.call_count("backward") - before[1]) == (2 * n, n)
        leaves = ("A_log", "D_skip", "dt_proj") if kind == "m" else (
            "u", "w0", "Wr", "Wk", "Wv")
        for name, g in grads.items():
            assert bool(torch.isfinite(g).all()), name
        for leaf in leaves:
            hit = [g for name, g in grads.items() if name.endswith(leaf)]
            assert hit and all(float(g.abs().max()) > 0 for g in hit), leaf


FRONTEND = "internvl2-26b"


def _frontend_models(seed):
    """internvl2's smoke config with the reference's weights, the
    adapter's bias made nonzero (both packages initialise it to 0)."""
    cfg, jcfg, params, _ = _models(FRONTEND, seed)
    params["adapter"]["b"] = np.random.default_rng(seed).standard_normal(
        params["adapter"]["b"].shape, dtype=np.float32) * 0.1
    model = transformer.load_reference_params(
        transformer.DecoderLM(cfg, device="cpu"), params)
    return cfg, jcfg, params, model


def _frontend_inputs(cfg, seed, S, B=2):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    pre = rng.standard_normal((B, cfg.frontend_seq, cfg.frontend_dim),
                              dtype=np.float32)
    return toks, pre


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want))) / float(
        np.max(np.abs(want)))


def test_frontend_loss_matches_reference():
    """The loss covers the tokens past the prefix (labels -1 ignored)."""
    cfg, jcfg, params, model = _frontend_models(2)
    toks, pre = _frontend_inputs(cfg, 9, 20)
    labels = np.roll(toks, -1, axis=1)
    labels[1, -4:] = -1
    with torch.no_grad():
        got = transformer.loss_fn(model, torch.from_numpy(toks),
                                  torch.from_numpy(labels), _t(pre))
    want = float(jT.loss_fn(params, jnp.asarray(toks), jnp.asarray(labels),
                            jcfg, prefix_embed=jnp.asarray(pre)))
    assert abs(float(got) - want) <= 1e-4 * abs(want)


def test_frontend_prefill_and_decode_match_reference():
    """Prefill with ``prefix_embed`` (the prefix takes cache slots) and
    decode steps against the reference's on the same tokens."""
    cfg, jcfg, params, model = _frontend_models(3)
    toks, pre = _frontend_inputs(cfg, 10, 16)
    P, max_len = 10, cfg.frontend_seq + 16
    lg, cache = transformer.prefill(model, torch.from_numpy(toks[:, :P]),
                                    max_len, prefix_embed=_t(pre))
    jlg, jcache = jT.prefill(params, jnp.asarray(toks[:, :P]), jcfg,
                             max_len, prefix_embed=jnp.asarray(pre))
    assert cache["len"] == int(jcache["len"]) == cfg.frontend_seq + P
    errs = [_rel(lg.numpy(), jlg)]
    for i in range(P, toks.shape[1]):
        tok = toks[:, i:i + 1]
        lg, cache = transformer.decode_step(model, cache,
                                            torch.from_numpy(tok))
        jlg, jcache = jT.decode_step(params, jcache, jnp.asarray(tok), jcfg)
        errs.append(_rel(lg.numpy(), jlg))
    assert max(errs) < 1e-4, errs
    for name, c in cache["layers"].items():
        for kv in ("k", "v"):
            assert _rel(c[kv].numpy(), jcache["layers"][name][kv]) < 1e-4


def test_prefix_embed_needs_a_frontend():
    cfg, _, _, model = _models("qwen1.5-0.5b")
    with pytest.raises(ValueError, match="prefix_embed needs a frontend"):
        transformer.forward(model, torch.zeros((1, 4), dtype=torch.long),
                            torch.zeros((1, 2, 32)))
