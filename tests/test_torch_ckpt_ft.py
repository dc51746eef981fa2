"""Checkpointing and fault tolerance on the port, on the CPU: the cases of
``tests/test_ckpt_ft.py`` (atomic saves, bitwise resume, placement on
restore, heartbeat and straggler policies, snapshot rollback, the loop's
retry), a checkpoint written by the reference restored in the port and
one written by the port restored in the reference (same leaf keys and
layout), both launchers resuming from either package's checkpoint (the
step each starts at), the loop's rollback on a loss spike, and a resume
through the fault-tolerant loop that reproduces the uninterrupted run
bit for bit."""

from __future__ import annotations

import json
import os
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro import ckpt as jckpt
from repro.train import step as jstep
from repro_torch import ckpt, configs
from repro_torch.data.tokens import lm_batch
from repro_torch.ft import (FaultTolerantLoop, HeartbeatMonitor, Snapshotter,
                            StragglerTracker)
from repro_torch.train import step as tstep
from repro_torch.train.step import TrainCfg, init_train_state, make_train_step

torch.set_num_threads(1)

CFG = configs.smoke("qwen1.5-0.5b").with_(act_dtype="float32")
JCFG = jconfigs.smoke("qwen1.5-0.5b").with_(act_dtype="float32")


def _batch(s, seed=0):
    toks, labels = lm_batch(seed, s, 4, 32, CFG.vocab, device="cpu")
    return {"tokens": toks, "labels": labels}


def _run(steps, model, opt, step_fn, from_step=0):
    losses = []
    for s in range(from_step, steps):
        model, opt, m = step_fn(model, opt, _batch(s))
        losses.append(float(m["loss"]))
    return model, opt, losses


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(
                jax.tree.map(lambda t: t.numpy() if isinstance(
                    t, torch.Tensor) else t, tree))[0]}


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def test_save_restore_roundtrip(tmp_path):
    model, opt = init_train_state(0, CFG, TrainCfg(), device="cpu")
    tree = tstep.state_tree(model, opt)
    ckpt.save(tree, str(tmp_path), step=7)
    state, step = ckpt.restore(tree, str(tmp_path))
    assert step == 7
    _assert_same(state, tree)


def test_resume_is_bitwise_deterministic(tmp_path):
    """Interrupt at step 5 of 10, restore, finish: identical parameters
    and moments to an uninterrupted 10-step run."""
    step_fn = make_train_step(CFG, TrainCfg())
    ma, oa, _ = _run(10, *init_train_state(0, CFG, TrainCfg(),
                                           device="cpu"), step_fn)
    mb, ob, _ = _run(5, *init_train_state(0, CFG, TrainCfg(),
                                          device="cpu"), step_fn)
    ckpt.save(tstep.state_tree(mb, ob), str(tmp_path), step=5)
    mc, oc = init_train_state(1, CFG, TrainCfg(), device="cpu")
    state, s = ckpt.restore(tstep.state_tree(mc, oc), str(tmp_path))
    tstep.load_state_tree(mc, oc, state)
    mc, oc, _ = _run(10, mc, oc, step_fn, from_step=s)
    _assert_same(tstep.state_tree(mc, oc), tstep.state_tree(ma, oa))


def test_async_save_atomic(tmp_path):
    model, opt = init_train_state(1, CFG, TrainCfg(), device="cpu")
    tree = {"params": tstep.state_tree(model, opt)["params"]}
    before = jax.tree.map(torch.clone, tree)
    ckpt.async_save(tree, str(tmp_path), step=3)
    with torch.no_grad():      # the state changes in place after the call
        for p in model.parameters():
            p.add_(1.0)
    ckpt.wait_pending()
    path, manifest = ckpt.load_manifest(str(tmp_path))
    assert manifest["step"] == 3
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    state, _ = ckpt.restore(tree, str(tmp_path))
    _assert_same(state, before)
    assert not torch.equal(state["params"]["embed"], model.embed.detach())


def test_restore_places_leaves(tmp_path):
    """The counterpart of the reference's elastic reshard: save, restore
    onto the devices the job now has (here the CPU); values identical."""
    arr = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    ckpt.save({"w": arr}, str(tmp_path), step=1)
    state, _ = ckpt.restore({"w": np.zeros((8, 8), np.float32)},
                            str(tmp_path), devices={"w": torch.device("cpu")})
    assert torch.equal(state["w"], arr)
    assert state["w"].device == torch.device("cpu")
    with pytest.raises(ValueError, match="template"):
        ckpt.restore({"w": np.zeros((4, 8), np.float32)}, str(tmp_path))


def test_bf16_leaves_in_the_reference_format(tmp_path):
    """bf16 leaves are 2-byte records with manifest dtype ``bfloat16``, as
    the reference writes them, and come back as bf16."""
    x = torch.randn(3, 5).to(torch.bfloat16)
    ckpt.save({"x": x}, str(tmp_path / "port"), step=1)
    ref = np.asarray(jnp.asarray(x.float().numpy(), jnp.bfloat16))
    jckpt.save({"x": jnp.asarray(ref)}, str(tmp_path / "ref"), step=1)
    for sub in ("port", "ref"):
        path, man = ckpt.load_manifest(str(tmp_path / sub))
        assert man["leaves"]["x"]["dtype"] == "bfloat16"
        state, _ = ckpt.restore({"x": x}, str(tmp_path / sub))
        assert state["x"].dtype == torch.bfloat16
        assert torch.equal(state["x"], x)
    raw = [np.load(tmp_path / sub / "step_00000001" / "x.npy")
           for sub in ("port", "ref")]
    assert raw[0].dtype == raw[1].dtype
    np.testing.assert_array_equal(raw[0].view(np.uint16),
                                  raw[1].view(np.uint16))
    assert ref.dtype == ml_dtypes.bfloat16


def _trained_state(seed):
    """A port state two steps in (moments nonzero)."""
    tcfg = TrainCfg(compress_grads=True)
    model, opt = init_train_state(seed, CFG, tcfg, device="cpu")
    _run(2, model, opt, make_train_step(CFG, tcfg))
    return model, opt, tcfg


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tcfg = jstep.TrainCfg(compress_grads=True)
    params, opt = jstep.init_train_state(jax.random.PRNGKey(3), JCFG, tcfg)
    opt = {**opt, "m": jax.tree.map(lambda x: x + 0.5, opt["m"]),
           "step": jnp.int32(4)}
    jckpt.save({"params": params, "opt": opt}, str(tmp_path), step=9)
    model, state, _ = _trained_state(0)
    tree, step = ckpt.restore(tstep.state_tree(model, state), str(tmp_path))
    assert step == 9
    tstep.load_state_tree(model, state, tree)
    _assert_same(tstep.state_tree(model, state),
                 jax.tree.map(np.asarray, {"params": params, "opt": opt}))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    model, state, _ = _trained_state(1)
    tree = tstep.state_tree(model, state)
    ckpt.async_save(tree, str(tmp_path), step=2)
    ckpt.wait_pending()
    tcfg = jstep.TrainCfg(compress_grads=True)
    params, opt = jstep.init_train_state(jax.random.PRNGKey(0), JCFG, tcfg)
    state_j, step = jckpt.restore({"params": params, "opt": opt},
                                  str(tmp_path))
    assert step == 2
    assert jax.tree.structure(state_j) == jax.tree.structure(
        {"params": params, "opt": opt})
    _assert_same(jax.tree.map(np.asarray, state_j), tree)
    with open(tmp_path / "step_00000002" / "manifest.json") as f:
        keys = set(json.load(f)["leaves"])
    assert "opt/step" in keys and "params/groups/pos0/mixer/wq" in keys


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_launchers_resume_from_each_others_checkpoints(writer, tmp_path,
                                                        capsys):
    """A 13-step launcher run checkpoints after steps 0 and 10. The
    reference's loop labels the second checkpoint 10, the port's 11 (the
    steps it holds). Either launcher resumes from the newest label, so
    from the reference's checkpoint both start at step 10 (batch 10 runs
    a second time, as in the reference's own resume) and from the port's
    both start at step 11 (the uninterrupted run goes on)."""
    from repro.launch import train as jlaunch
    from repro_torch.launch import train as tlaunch
    args = ["--smoke", "--steps", "13", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path)]
    port = ["--device", "cpu"]
    if writer == "reference":
        jlaunch.main(args)
    else:
        tlaunch.main(args + port)
    label = {"reference": 10, "port": 11}[writer]
    assert sorted(os.listdir(tmp_path)) == [
        f"step_{s:08d}" for s in sorted({label - 10, label})]
    capsys.readouterr()
    for name, main, extra in (("reference", jlaunch.main, []),
                              ("port", tlaunch.main, port)):
        again = tmp_path.parent / f"{tmp_path.name}_{name}"
        shutil.copytree(tmp_path, again)
        losses = main(["--smoke", "--steps", "13", "--batch", "2", "--seq",
                       "16", "--ckpt-dir", str(again), "--resume", *extra])
        assert f"resumed from step {label}" in capsys.readouterr().out, name
        assert len(losses) == 13 - label, name


def test_heartbeat_monitor():
    clock = [0.0]
    mon = HeartbeatMonitor(["h0", "h1", "h2"], timeout=10,
                           clock=lambda: clock[0])
    clock[0] = 5.0
    mon.beat("h0")
    mon.beat("h1")
    clock[0] = 12.0
    assert mon.dead_hosts() == ["h2"]
    mon.beat("h2")
    assert mon.dead_hosts() == []


def test_straggler_tracker():
    tr = StragglerTracker(k=3.0, patience=2)
    for step in range(6):
        for h in ("h0", "h1", "h2", "h3"):
            tr.record(h, 1.0 + 0.01 * step)
        tr.record("slow", 9.0)
        out = tr.stragglers()
    assert out == ["slow"]


def test_snapshot_rollback():
    snap = Snapshotter(keep=2)
    state = {"w": torch.ones(4)}
    snap.snap(3, state)
    state["w"].add_(5.0)                      # the live state moves on
    step, restored = snap.rollback()
    assert step == 3
    assert torch.equal(restored["w"], torch.ones(4))
    step, live = snap.rollback(into=state)
    assert live is state and torch.equal(state["w"], torch.ones(4))


def _batches(n):
    for s in range(n):
        yield s, _batch(s)


def test_ft_loop_retries_and_completes(tmp_path):
    """A transient RuntimeError at step 2 is retried from the state it
    failed on, and training completes with a checkpoint on disk (labelled
    with the steps it holds: after steps 0 and 4, 1 and 5)."""
    step_fn = make_train_step(CFG, TrainCfg())
    model, opt = init_train_state(0, CFG, TrainCfg(), device="cpu")
    loop = FaultTolerantLoop(step_fn, ckpt_dir=str(tmp_path),
                             ckpt_every=4, snap_every=2, max_retries=2)
    fails = {"left": 1}

    def flaky(step):
        if step == 2 and fails["left"]:
            fails["left"] -= 1
            raise RuntimeError("simulated preemption")

    model, opt = loop.run((model, opt), _batches(6), fail_hook=flaky)
    assert loop.retries == 1
    _, manifest = ckpt.load_manifest(str(tmp_path))
    assert manifest["step"] in (1, 5)
    ref_m, ref_o, _ = _run(6, *init_train_state(0, CFG, TrainCfg(),
                                                device="cpu"), step_fn)
    _assert_same(tstep.state_tree(model, opt),
                 tstep.state_tree(ref_m, ref_o))


def test_ft_loop_rolls_back_on_a_loss_spike():
    step_fn = make_train_step(CFG, TrainCfg())

    def spiky(m, o, b):
        m, o, met = step_fn(m, o, b)
        if int(o["step"]) == 4:
            met = {**met, "loss": met["loss"] * 100}
        return m, o, met

    model, opt = init_train_state(0, CFG, TrainCfg(), device="cpu")
    loop = FaultTolerantLoop(spiky, snap_every=2)
    model, opt = loop.run((model, opt), _batches(4))
    assert loop.rollbacks == 1
    # step 3's update was rolled back to the snapshot taken before step 2
    ref_m, ref_o, _ = _run(2, *init_train_state(0, CFG, TrainCfg(),
                                                device="cpu"), step_fn)
    _assert_same(tstep.state_tree(model, opt),
                 tstep.state_tree(ref_m, ref_o))


def test_loop_resume_reproduces_the_run(tmp_path):
    """The loop checkpoints after step 4 (labelled 5); a fresh job that
    restores it and runs steps 5.. gives the uninterrupted run's losses
    bit for bit."""
    step_fn = make_train_step(CFG, TrainCfg())
    losses = []

    def logging(m, o, b):
        m, o, met = step_fn(m, o, b)
        losses.append(float(met["loss"]))
        return m, o, met

    model, opt = init_train_state(0, CFG, TrainCfg(), device="cpu")
    FaultTolerantLoop(logging, ckpt_dir=str(tmp_path), ckpt_every=4).run(
        (model, opt), _batches(8))
    straight = list(losses)
    model, opt = init_train_state(0, CFG, TrainCfg(), device="cpu")
    tree, start = ckpt.restore(tstep.state_tree(model, opt), str(tmp_path))
    assert start == 5
    tstep.load_state_tree(model, opt, tree)
    losses.clear()
    FaultTolerantLoop(logging).run((model, opt), _batches(8),
                                   start_step=start)
    assert losses == straight[start:]
