"""Train a reduced-config LM end to end on the PyTorch/CUDA port with
the full substrate: the deterministic data pipeline, AdamW + cosine,
remat, microbatching, the fault-tolerant loop with async checkpoints,
then a restart that resumes from the newest checkpoint.

Counterpart of ``examples/train_lm.py``:

    PYTHONPATH=src python examples/port/train_lm.py [--arch yi-9b] \\
        [--steps 40] [--device cpu]

The port trains every decoder arch, Mamba and RWKV6 layers (jamba,
rwkv6) included; the encoder-decoder and frontend archs raise
NotImplementedError.
"""

import argparse
import os
import shutil
import tempfile

from repro_torch.launch.train import main as train_main

# uniform random tokens teach nothing but the unigram, so at the
# launcher's default 3e-4 its loss-decrease check (phase 1 runs 24 steps
# at the defaults) is decided by the draw: on the port's seed-0 weights
# and tokens the loss does not fall, and the reference's own step given
# the same arrays gives the same losses (ROADMAP queue 3). At 3e-3 the
# fall is well above the noise
LR = 3e-3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()

    ckpt_dir = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    common = ["--arch", args.arch, "--smoke", "--batch", str(args.batch),
              "--seq", str(args.seq), "--ckpt-dir", ckpt_dir,
              "--microbatch", "2", "--lr", str(LR)]
    if args.device:
        common += ["--device", args.device]
    # phase 1: train the first 60% of the run with checkpointing
    first = train_main(common + ["--steps", str(int(args.steps * 0.6))])
    # phase 2: simulate a restart -- resume from the checkpoint and finish
    print("-- simulated restart: resuming from checkpoint --")
    second = train_main(common + ["--steps", str(args.steps), "--resume"])
    print(f"OK: {len(first)} + {len(second)} steps, loss {first[0]:.3f} "
          f"-> {second[-1]:.3f}")


if __name__ == "__main__":
    main()
