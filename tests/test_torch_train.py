"""The port's training path against the JAX package's, at f32 on the same
numpy inputs and weights (carried by ``load_reference_params``): the
token pipeline's determinism, ``cosine_lr`` and ``adamw_update`` (1e-6),
``loss_fn`` and its gradients on the smoke configs of qwen1.5-0.5b (QKV
bias, set nonzero), yi-9b (GQA), h2o-danube-1.8b (sliding window),
phi3.5-moe and qwen3-moe (MoE), jamba (Mamba, attention, MoE) and rwkv6
(the mixers through their plain versions under autograd) against
``jax.value_and_grad(repro.models.transformer.loss_fn)`` (loss to 1e-5,
gradients to 1e-4 of each leaf's largest magnitude), one
``make_train_step`` step against the reference's (plain, microbatched,
compressed on qwen; plain on each mixer arch), microbatch equivalence
and compression as in ``tests/test_models.py``, the three ``remat``
modes, and the weight and state trees (f32 leaves staying f32, the AdamW
moments under the same keys) carried across in both directions. The
multimodal archs' smoke configs, seamless-m4t-large-v2 (encoder-decoder:
the encoder over frame embeddings, cross attention at Sq != Skv) and
internvl2-26b (patch embeddings before the tokens): the loss and every
gradient leaf against ``jax.value_and_grad`` of the reference's
``_model_loss`` branch under remat "none" and the arch's own, one
``make_train_step`` step against the reference's (plain, microbatched,
compressed), the state tree's round trip, and the launcher's own inputs
through both packages' steps."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import encdec as jE
from repro.models import transformer as jT
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.data import tokens
from repro_torch.kernels.flash_attn import kernel as fak
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.train import step as tstep

torch.set_num_threads(1)

MIXER_ARCHS = ("phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b",
               "jamba-1.5-large-398b", "rwkv6-3b")
ARCHS = ("qwen1.5-0.5b", "yi-9b", "h2o-danube-1.8b", *MIXER_ARCHS)
# the encoder-decoder and the vision-frontend stub: their batches carry
# ``prefix`` (frame or patch embeddings)
MM_ARCHS = ("seamless-m4t-large-v2", "internvl2-26b")


def _cfg(arch, **kw):
    return (configs.smoke(arch).with_(act_dtype="float32", **kw),
            jconfigs.smoke(arch).with_(act_dtype="float32", **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_params(jcfg, seed=0):
    """The reference's init tree (its encoder-decoder's for an encdec
    config) with its zero QKV and adapter biases made nonzero."""
    init = jE.init_params if jcfg.kind == "encdec" else jT.init_params
    p = _np(init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    biases = [(p["adapter"], ("b",))] if "adapter" in p else []
    if "groups" in p:
        biases.append((p["groups"]["pos0"]["mixer"], ("bq", "bk", "bv")))
    for tree, names in biases:
        for name in names:
            if name in tree:
                tree[name] = rng.standard_normal(tree[name].shape,
                                                 dtype=np.float32) * 0.1
    return p


def _model(cfg, params, seed=0):
    model, opt = tstep.init_train_state(seed, cfg, tstep.TrainCfg(),
                                        device="cpu")
    transformer.load_reference_params(model, params)
    return model


def _batch(cfg, B=2, S=40, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    labels[0, :3] = -1                       # ignored positions
    return toks, labels


def _batch_dict(cfg, B, S, seed) -> dict:
    """``_batch`` as a train step's batch (numpy), with the ``prefix`` of
    the multimodal archs as the launcher makes it: ``S // 2`` frames for
    the encoder-decoder, ``frontend_seq`` patches for a frontend arch."""
    toks, labels = _batch(cfg, B=B, S=S, seed=seed)
    batch = {"tokens": toks, "labels": labels}
    if cfg.kind == "encdec" or cfg.frontend is not None:
        P = S // 2 if cfg.kind == "encdec" else cfg.frontend_seq
        batch["prefix"] = np.random.default_rng(seed + 1).standard_normal(
            (B, P, cfg.frontend_dim), dtype=np.float32)
    return batch


def _assert_tree_close(got, want, rel):
    """Every leaf within ``rel`` of itself and of its largest magnitude."""
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g)
    for path, w in flat_w:
        g = np.asarray(flat_g[path], np.float32)
        w = np.asarray(w, np.float32)
        bar = rel * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=rel, atol=bar,
                                   err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------------------ data, optim

def test_lm_batch_is_a_function_of_seed_and_step():
    a = tokens.lm_batch(3, 5, 4, 16, 100, device="cpu")
    b = tokens.lm_batch(3, 5, 4, 16, 100, device="cpu")
    c = tokens.lm_batch(3, 6, 4, 16, 100, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    toks, labels = a
    assert toks.shape == labels.shape == (4, 16)
    assert torch.equal(toks[:, 1:], labels[:, :-1])
    assert int(toks.min()) >= 0 and int(toks.max()) < 100
    e = tokens.embedding_batch(3, 5, 2, 4, 8, device="cpu")
    assert e.dtype == torch.float32 and e.shape == (2, 4, 8)
    assert torch.equal(e, tokens.embedding_batch(3, 5, 2, 4, 8,
                                                 device="cpu"))


def test_cosine_lr_matches_reference():
    cfg = adamw.OptCfg(lr=1e-3, warmup_steps=7, total_steps=40)
    jcfg = jadamw.OptCfg(lr=1e-3, warmup_steps=7, total_steps=40)
    steps = np.arange(0, 50, dtype=np.int32)
    got = adamw.cosine_lr(torch.from_numpy(steps), cfg).numpy()
    want = np.asarray(jadamw.cosine_lr(jnp.asarray(steps), jcfg))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_adamw_update_matches_reference():
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 7), "b": (3,), "c": (2, 3, 4)}
    params = {k: rng.standard_normal(s, dtype=np.float32)
              for k, s in shapes.items()}
    cfg = adamw.OptCfg(lr=1e-2, warmup_steps=2, total_steps=10,
                       clip_norm=0.5)
    jcfg = jadamw.OptCfg(lr=1e-2, warmup_steps=2, total_steps=10,
                         clip_norm=0.5)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = adamw.adamw_init(tp)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jadamw.adamw_init(jp)
    jupdate = jax.jit(lambda g, st, p: jadamw.adamw_update(g, st, p, jcfg))
    for step in range(4):
        grads = {k: rng.standard_normal(s, dtype=np.float32)
                 for k, s in shapes.items()}
        _, _, met = adamw.adamw_update(
            {k: torch.from_numpy(v) for k, v in grads.items()}, ts, tp, cfg)
        jp, js, jmet = jupdate(
            {k: jnp.asarray(v) for k, v in grads.items()}, js, jp)
        for k in shapes:
            for got, want in ((tp[k], jp[k]), (ts["m"][k], js["m"][k]),
                              (ts["v"][k], js["v"][k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-7)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for name in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(met[name]),
                                       float(jmet[name]), rtol=1e-6)


# --------------------------------------------------------- loss and grads

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """Chunked CE over 40 positions in chunks of 16 (a ragged last chunk,
    the reference pads it) with ignored labels, under remat "dots"."""
    cfg, jcfg = _cfg(arch, loss_chunk=16)
    params = _ref_params(jcfg)
    toks, labels = _batch(cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jT.loss_fn(p, jnp.asarray(toks), jnp.asarray(labels),
                             jcfg)))(jax.tree.map(jnp.asarray, params))
    model = _model(cfg, params)
    loss = transformer.loss_fn(model, torch.from_numpy(toks),
                               torch.from_numpy(labels))
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [model.get_parameter(k)
                                       for k in names])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    got = transformer.reference_tree(dict(zip(names, grads)))
    _assert_tree_close(jax.tree.map(lambda t: t.numpy(), got),
                       _np(jgrads), 1e-4)


@pytest.mark.parametrize("tcfg_kw", [
    {}, {"n_microbatch": 2}, {"compress_grads": True}],
    ids=["plain", "microbatch2", "compressed"])
def test_train_step_matches_reference(tcfg_kw):
    """One step from the same weights and batch. The first AdamW step
    moves each weight by lr * g / (|g| + eps) (plus decay): a sign for all
    but the smallest gradients, so a 1e-4 relative gradient difference
    can move a weight whose gradient is ~0 by up to lr. So: the moments
    within 1e-4 of each leaf's largest (``m`` is (1 - b1) g, ``v`` (1 -
    b2) g^2), and the weights' update within 1e-4 of itself where the
    reference's clipped gradient is above 1e-3 of its leaf's largest and
    1000 eps (and 8 int8 levels when compressed), within 2 lr elsewhere.
    With int8 compression an element on a rounding edge may take the
    neighbouring level: ``m`` and ``ef`` within one level (the leaf's
    max |g| / 127), the norm within 1e-4."""
    _check_train_step("qwen1.5-0.5b", tcfg_kw)


@pytest.mark.parametrize("arch", MIXER_ARCHS)
def test_train_step_matches_reference_mixers(arch):
    """One plain step of each mixer arch, under the bars of
    :func:`test_train_step_matches_reference`."""
    _check_train_step(arch, {})


@pytest.mark.parametrize("remat", ["none", "arch"])
@pytest.mark.parametrize("arch", MM_ARCHS)
def test_loss_and_grads_match_reference_multimodal(arch, remat):
    """The multimodal archs' loss over 24 tokens in chunks of 16 with
    ignored labels and a ``prefix`` (12 frames for seamless's encoder,
    internvl2's 8 patches) and every gradient leaf, adapter included,
    against ``jax.value_and_grad`` of the reference's ``_model_loss``
    branch, under remat "none" and the arch's own ("dots": each
    encoder-decoder layer recomputed whole, as the reference's
    ``jax.checkpoint``; the decoder LM's selective policy)."""
    kw = {"loss_chunk": 16} if remat == "arch" else \
        {"loss_chunk": 16, "remat": "none"}
    cfg, jcfg = _cfg(arch, **kw)
    params = _ref_params(jcfg, seed=5)
    batch = _batch_dict(cfg, B=2, S=24, seed=6)
    jloss, jgrads = jax.jit(jax.value_and_grad(jstep._model_loss(jcfg)))(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    model = _model(cfg, params)
    names = [k for k, _ in model.named_parameters()]
    loss, grads = tstep._value_and_grad(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = transformer.reference_tree({k: grads[k] for k in names})
    _assert_tree_close(jax.tree.map(lambda t: t.numpy(), got),
                       _np(jgrads), 1e-4)


@pytest.mark.parametrize("arch,tcfg_kw", [
    (MM_ARCHS[0], {}), (MM_ARCHS[0], {"n_microbatch": 2}),
    (MM_ARCHS[0], {"compress_grads": True}), (MM_ARCHS[1], {}),
    (MM_ARCHS[1], {"n_microbatch": 2, "compress_grads": True})],
    ids=["seamless-plain", "seamless-microbatch2", "seamless-compressed",
         "internvl2-plain", "internvl2-microbatch2-compressed"])
def test_train_step_matches_reference_multimodal(arch, tcfg_kw):
    """One step of each multimodal arch (the batch's ``prefix`` split
    with the rest by microbatching) under the bars of
    :func:`test_train_step_matches_reference`."""
    _check_train_step(arch, tcfg_kw)


@pytest.mark.parametrize("arch", MM_ARCHS)
def test_multimodal_state_round_trip(arch):
    """The encoder-decoder's and the frontend arch's training state (the
    encoder and decoder layers stacked, the adapter, moments and ``ef``)
    as the reference's tree and back into a fresh state, after a step;
    the tree's structure is the reference's ``init_params`` tree's."""
    cfg, jcfg = _cfg(arch)
    tcfg = tstep.TrainCfg(compress_grads=True)
    src, state = tstep.init_train_state(1, cfg, tcfg, device="cpu")
    batch = _batch_dict(cfg, B=2, S=16, seed=7)
    tstep.make_train_step(cfg, tcfg)(
        src, state, {k: torch.from_numpy(v) for k, v in batch.items()})
    tree = jax.tree.map(lambda t: t.numpy(), tstep.state_tree(src, state))
    dst, fresh = tstep.init_train_state(2, cfg, tcfg, device="cpu")
    tstep.load_state_tree(dst, fresh, tree)
    again = jax.tree.map(lambda t: t.numpy(), tstep.state_tree(dst, fresh))
    assert jax.tree.structure(again) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    ref = _ref_params(jcfg)
    for key in ("params", ("opt", "m"), ("opt", "ef")):
        sub = tree[key] if isinstance(key, str) else tree[key[0]][key[1]]
        assert jax.tree.structure(sub) == jax.tree.structure(ref), key


@pytest.mark.parametrize("arch", MM_ARCHS)
def test_launcher_inputs_match_reference_multimodal(arch):
    """The training launcher's own inputs at seed 0 (the port's initial
    weights, ``make_batches``' tokens and its seeded frames or patches,
    handed to the reference as numpy) at the launcher's default batch,
    length and lr (8 x 128, 3e-4; 4 of its steps): the reference's jitted
    step gives the port's losses within 1e-5, step by step, so the
    launcher's loss-decrease check decides alike in both packages on
    these inputs (uniform tokens make it a coin flip at this lr: ROADMAP
    queue 3)."""
    from repro_torch.launch.train import make_batches
    cfg, jcfg = _cfg(arch)
    opt = dict(lr=3e-4, warmup_steps=10, total_steps=20)
    tcfg = tstep.TrainCfg(opt=adamw.OptCfg(**opt))
    jtcfg = jstep.TrainCfg(opt=jadamw.OptCfg(**opt))
    model, state = tstep.init_train_state(0, cfg, tcfg, device="cpu")
    jp = jax.tree.map(jnp.asarray, transformer.reference_params(model))
    jo = jadamw.adamw_init(jp)
    jfn = jax.jit(jstep.make_train_step(jcfg, jtcfg))
    fn = tstep.make_train_step(cfg, tcfg)
    got, want = [], []
    for _, b in make_batches(cfg, 0, 4, 8, 128, device="cpu"):
        model, state, m = fn(model, state, b)
        got.append(float(m["loss"]))
        jp, jo, jm = jfn(jp, jo, {k: jnp.asarray(v.numpy())
                                  for k, v in b.items()})
        want.append(float(jm["loss"]))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _check_train_step(arch, tcfg_kw):
    cfg, jcfg = _cfg(arch)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    tcfg = tstep.TrainCfg(opt=adamw.OptCfg(**opt), **tcfg_kw)
    jtcfg = jstep.TrainCfg(opt=jadamw.OptCfg(**opt), **tcfg_kw)
    params = _ref_params(jcfg, seed=2)
    jopt = jadamw.adamw_init(jax.tree.map(jnp.asarray, params))
    if tcfg.compress_grads:
        jopt["ef"] = jax.tree.map(jnp.zeros_like, jopt["m"])
    batch = _batch_dict(cfg, B=4, S=24, seed=3)
    jp, jo, jm = jax.jit(jstep.make_train_step(jcfg, jtcfg))(
        jax.tree.map(jnp.asarray, params), jopt,
        {k: jnp.asarray(v) for k, v in batch.items()})

    model, state = tstep.init_train_state(0, cfg, tcfg, device="cpu")
    transformer.load_reference_params(model, params)
    model, state, met = tstep.make_train_step(cfg, tcfg)(
        model, state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for name, rel in (("loss", 1e-5), ("lr", 1e-6), ("grad_norm", 1e-4 if
                                                     tcfg.compress_grads
                                                     else 1e-5)):
        np.testing.assert_allclose(float(met[name]), float(jm[name]),
                                   rtol=rel, err_msg=name)
    got = jax.tree.map(lambda t: t.numpy(), tstep.state_tree(model, state))
    assert int(got["opt"]["step"]) == int(jo["step"]) == 1
    b1, b2 = tcfg.opt.b1, tcfg.opt.b2
    clip = min(1.0, tcfg.opt.clip_norm / float(jm["grad_norm"]))
    for path, m_ref in jax.tree_util.tree_flatten_with_path(_np(jo["m"]))[0]:
        at = lambda tree: np.asarray(  # noqa: E731
            _leaf(tree, path), np.float32)
        top = float(np.abs(m_ref).max())
        g_top = top / ((1 - b1) * clip)       # the leaf's largest |g|
        # one int8 level of the leaf (|ef| <= half a level)
        level = 2 * float(np.abs(at(_np(jo["ef"]))).max()) \
            if tcfg.compress_grads else 0.0
        np.testing.assert_allclose(at(got["opt"]["m"]), m_ref, rtol=0,
                                   atol=1e-4 * top + (1 - b1) * clip * level)
        v_ref = at(_np(jo["v"]))
        np.testing.assert_allclose(
            at(got["opt"]["v"]), v_ref, rtol=0,
            atol=1e-4 * float(np.abs(v_ref).max())
            + (1 - b2) * clip ** 2 * (2 * g_top + level) * level)
        if tcfg.compress_grads:
            np.testing.assert_allclose(at(got["opt"]["ef"]),
                                       at(_np(jo["ef"])), rtol=0,
                                       atol=1e-4 * g_top + level)
        before = at(params)
        step_ref = at(_np(jp)) - before
        step_got = at(got["params"]) - before
        # the updates within 1e-4 of themselves and two f32 ulps of the
        # weight they were added to, where the clipped gradient is above
        # 1e-3 of the leaf's largest, 1000 eps (nearer eps g / (|g| + eps)
        # is no sign) and 8 int8 levels (nearer 0 a level is a large
        # share of g)
        big = np.abs(m_ref) > max(1e-3 * top, (1 - b1) * max(
            1e3 * tcfg.opt.eps, 8 * clip * level))
        err = np.abs(step_got - step_ref)
        bar = 1e-4 * np.abs(step_ref) + 2 * np.spacing(np.abs(before))
        assert (err[big] <= bar[big]).all(), (path, float(err[big].max()))
        assert err.max() <= 2 * tcfg.opt.lr


def test_launcher_run_matches_reference_on_the_ports_inputs():
    """The training launcher's own inputs at seed 0 (the port's initial
    weights and token stream, handed to the reference as numpy) at
    ``examples/train_lm.py``'s first phase (24 steps of 8 x 128 tokens,
    2 microbatches, lr 3e-4, the launcher's schedule): the reference's
    jitted step gives the port's losses step by step within 1e-5, so the
    launcher's loss-decrease check decides the same in both packages
    (on these inputs the loss does not fall in either: ROADMAP queue
    3)."""
    from repro_torch.launch.train import make_batches
    cfg, jcfg = _cfg("qwen1.5-0.5b")
    opt = dict(lr=3e-4, warmup_steps=10, total_steps=24)
    tcfg = tstep.TrainCfg(n_microbatch=2, opt=adamw.OptCfg(**opt))
    jtcfg = jstep.TrainCfg(n_microbatch=2, opt=jadamw.OptCfg(**opt))
    model, state = tstep.init_train_state(0, cfg, tcfg, device="cpu")
    jp = jax.tree.map(jnp.asarray, transformer.reference_params(model))
    jo = jadamw.adamw_init(jp)
    jfn = jax.jit(jstep.make_train_step(jcfg, jtcfg))
    fn = tstep.make_train_step(cfg, tcfg)
    got, want = [], []
    for _, b in make_batches(cfg, 0, 24, 8, 128, device="cpu"):
        model, state, m = fn(model, state, b)
        got.append(float(m["loss"]))
        jp, jo, jm = jfn(jp, jo, {k: jnp.asarray(v.numpy())
                                  for k, v in b.items()})
        want.append(float(jm["loss"]))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got[-1] < got[0]) == (want[-1] < want[0])


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def test_microbatch_equivalence():
    """n_microbatch=4 gives the same loss and (near-)same parameters as
    one batch (f32 accumulation), as ``tests/test_models.py`` holds the
    reference."""
    cfg, _ = _cfg("qwen1.5-0.5b")
    toks, labels = _batch(cfg, B=8, S=32, seed=4)
    labels[0, :3] = labels[0, 3]     # every position counts, as there
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    out = []
    for n in (1, 4):
        tcfg = tstep.TrainCfg(n_microbatch=n)
        model, state = tstep.init_train_state(0, cfg, tcfg, device="cpu")
        _, _, met = tstep.make_train_step(cfg, tcfg)(model, state, batch)
        out.append((float(met["loss"]), {k: p.detach() for k, p in
                                         model.named_parameters()}))
    assert abs(out[0][0] - out[1][0]) < 1e-4
    for k, p in out[0][1].items():
        assert float((p - out[1][1][k]).abs().max()) < 2e-3, k


def test_grad_compression_trains():
    """int8 + error-feedback compression still decreases the loss on a
    repeated batch, and the residual is carried."""
    cfg, _ = _cfg("qwen1.5-0.5b")
    tcfg = tstep.TrainCfg(compress_grads=True, opt=adamw.OptCfg(
        lr=2e-3, warmup_steps=2, total_steps=20))
    model, state = tstep.init_train_state(0, cfg, tcfg, device="cpu")
    assert "ef" in state
    step = tstep.make_train_step(cfg, tcfg)
    toks, labels = _batch(cfg, B=4, S=32, seed=0)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    losses = []
    for _ in range(15):
        model, state, met = step(model, state, batch)
        losses.append(float(met["loss"]))
    assert min(losses[-3:]) < losses[0], losses
    assert sum(float(e.abs().sum()) for e in state["ef"].values()) > 0


def test_quantize_int8_matches_reference():
    x = np.random.default_rng(5).standard_normal((6, 9), dtype=np.float32)
    q, s = tstep.quantize_int8(torch.from_numpy(x))
    jq, js = jstep.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(s), float(js), rtol=1e-7)


# ------------------------------------------------------------------ remat

def test_remat_modes_give_the_same_gradients(monkeypatch):
    """none, dots and full: equal gradients; attention runs once a layer
    without remat and again in the backward's recompute with it."""
    calls = []
    fwd = fak._forward_lse

    def counting(*a, **kw):
        calls.append(1)
        return fwd(*a, **kw)

    monkeypatch.setattr(fak, "_forward_lse", counting)
    toks, labels = _batch(configs.smoke("yi-9b"), B=2, S=24, seed=6)
    out = {}
    for remat in ("none", "dots", "full"):
        cfg, jcfg = _cfg("yi-9b", remat=remat)
        model = _model(cfg, _ref_params(jcfg, seed=3))
        calls.clear()
        loss = transformer.loss_fn(model, torch.from_numpy(toks),
                                   torch.from_numpy(labels))
        out[remat] = torch.autograd.grad(loss, list(model.parameters()))
        want = cfg.n_layers * (1 if remat == "none" else 2)
        assert len(calls) == want, (remat, len(calls))
    for remat in ("dots", "full"):
        for a, b in zip(out["none"], out[remat]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_unknown_remat_raises():
    cfg, _ = _cfg("qwen1.5-0.5b", remat="some")
    with pytest.raises(ValueError, match="remat"):
        transformer.DecoderLM(cfg, device="cpu")


def test_serving_model_has_no_gradients():
    cfg, _ = _cfg("qwen1.5-0.5b")
    assert not any(p.requires_grad for p in transformer.DecoderLM(
        cfg, device="cpu").parameters())
    assert all(p.requires_grad for p in transformer.DecoderLM(
        cfg, device="cpu", train=True).parameters())


# ------------------------------------------------------- trees both ways

@pytest.mark.parametrize("arch", ARCHS)
def test_weights_and_state_round_trip(arch):
    """reference tree -> port -> reference tree is the identity for the
    weights (``reference_params``), and the training state's tree
    (moments and ``ef`` included) loads back into a fresh state."""
    cfg, jcfg = _cfg(arch)
    params = _ref_params(jcfg, seed=4)
    model = _model(cfg, params)
    back = transformer.reference_params(model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)

    tcfg = tstep.TrainCfg(compress_grads=True)
    src, state = tstep.init_train_state(1, cfg, tcfg, device="cpu")
    toks, labels = _batch(cfg, B=2, S=16, seed=7)
    tstep.make_train_step(cfg, tcfg)(src, state, {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    tree = jax.tree.map(lambda t: t.numpy(), tstep.state_tree(src, state))
    dst, fresh = tstep.init_train_state(2, cfg, tcfg, device="cpu")
    tstep.load_state_tree(dst, fresh, tree)
    again = jax.tree.map(lambda t: t.numpy(), tstep.state_tree(dst, fresh))
    assert jax.tree.structure(again) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    jopt = jadamw.adamw_init(jax.tree.map(jnp.asarray, params))
    assert jax.tree.structure(tree["opt"]["m"]) == \
        jax.tree.structure(_np(jopt["m"]))


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "rwkv6-3b"])
def test_bf16_trees_keep_f32_leaves(arch):
    """In bf16 the reference keeps Mamba's ``A_log`` and ``D_skip`` and
    RWKV6's ``u`` in f32: the port's parameters and AdamW moments of
    those leaves are f32, and a bf16 reference tree goes in and comes back
    out unchanged."""
    cfg, jcfg = configs.smoke(arch), jconfigs.smoke(arch)
    params = _np(jT.init_params(jax.random.PRNGKey(5), jcfg))
    model = transformer.load_reference_params(
        transformer.DecoderLM(cfg, device="cpu"), params)
    f32 = {n for n, p in model.named_parameters() if p.dtype == torch.float32}
    want = {"A_log", "D_skip"} if arch.startswith("jamba") else {"u"}
    assert {n.rsplit(".", 1)[1] for n in f32} == want
    back = transformer.reference_params(model)
    for path, a in jax.tree_util.tree_flatten_with_path(params)[0]:
        b = _leaf(back, path)
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b, np.asarray(a, np.float32))
    _, state = tstep.init_train_state(0, cfg, tstep.TrainCfg(), device="cpu")
    assert all(state["m"][n].dtype == torch.float32 for n in f32)
    tree = tstep.state_tree(model, state)
    assert jax.tree.structure(jax.tree.map(np.asarray, tree["opt"]["m"])) \
        == jax.tree.structure(params)
