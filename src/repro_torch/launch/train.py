"""Training launcher: real steps on the card (or the CPU when asked),
the counterpart of ``repro/launch/train.py``, with the same flags and
``--device``.

Fault tolerance: the deterministic ``(seed, step)`` data pipeline,
atomic async checkpoints every 10 steps and the FaultTolerantLoop
(rollback on loss spikes, retry on step failures, periodic snapshots).
A checkpoint written after step s holds s + 1 steps and a resumed run
starts at step s + 1 (``repro_torch.ft.runtime``), so ``--resume``
reproduces the uninterrupted run's later losses.

Every arch trains: the decoder LMs, the frontend archs (internvl2-26b,
with seeded patch embeddings before the tokens) and the encoder-decoder
(seamless-m4t-large-v2, over ``seq // 2`` seeded frame embeddings).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from repro_torch import configs
from repro_torch.data.tokens import embedding_batch, lm_batch
from repro_torch.device import resolve_device
from repro_torch.ft import FaultTolerantLoop
from repro_torch.optim.adamw import OptCfg
from repro_torch.train import step as step_lib
from repro_torch.train.step import TrainCfg, init_train_state, make_train_step


def make_batches(cfg, seed: int, steps: int, batch: int, seq: int,
                 device=None):
    """The reference's batches: tokens and labels, and ``prefix``: the
    encoder-decoder's frame embeddings (``seq // 2`` frames, the encoder's
    input) or a frontend arch's ``frontend_seq`` patch embeddings (before
    the tokens); the train step's loss consumes them."""
    for step in range(steps):
        toks, labels = lm_batch(seed, step, batch, seq, cfg.vocab,
                                device=device)
        b = {"tokens": toks, "labels": labels}
        if cfg.kind == "encdec":
            b["prefix"] = embedding_batch(seed + 1, step, batch, seq // 2,
                                          cfg.frontend_dim, device=device)
        elif cfg.frontend is not None:
            b["prefix"] = embedding_batch(seed + 1, step, batch,
                                          cfg.frontend_seq,
                                          cfg.frontend_dim, device=device)
        yield step, b


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; a host "
                    "without CUDA needs --device cpu)")
    args = ap.parse_args(argv)
    cfg = configs.smoke(args.arch) if args.smoke else configs.ARCHS[args.arch]
    cfg = cfg.with_(act_dtype="float32")   # the reference's choice
    dev = resolve_device(args.device)
    tcfg = TrainCfg(n_microbatch=args.microbatch,
                    compress_grads=args.compress_grads,
                    opt=OptCfg(lr=args.lr, warmup_steps=10,
                               total_steps=args.steps))
    params, opt = init_train_state(args.seed, cfg, tcfg, device=dev)
    start = 0
    if args.resume and args.ckpt_dir:
        from repro_torch import ckpt
        state, start = ckpt.restore(step_lib.state_tree(params, opt),
                                    args.ckpt_dir)
        step_lib.load_state_tree(params, opt, state)
        del state
        print(f"resumed from step {start}")

    step_fn = make_train_step(cfg, tcfg)
    loop = FaultTolerantLoop(step_fn, ckpt_dir=args.ckpt_dir,
                             ckpt_every=10)

    t0 = time.time()
    losses = []

    def logging_step(p, o, b):
        p, o, m = step_fn(p, o, b)
        losses.append(float(m["loss"]))
        return p, o, m

    loop.train_step = logging_step
    params, opt = loop.run(
        (params, opt),
        make_batches(cfg, args.seed, args.steps, args.batch, args.seq,
                     device=dev),
        start_step=start)
    dt = time.time() - t0
    toks = args.batch * args.seq * (args.steps - start)
    print(f"{cfg.name}: {args.steps - start} steps, "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
          f"{toks / dt:,.0f} tok/s, retries={loop.retries} "
          f"rollbacks={loop.rollbacks}")
    if start == 0 and args.steps >= 20:
        assert losses[-1] < losses[0], "loss did not decrease"
    return losses


if __name__ == "__main__":
    main()
