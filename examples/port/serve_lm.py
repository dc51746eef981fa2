"""Batched LM serving on a reduced config on the PyTorch/CUDA port:
prefill + greedy decode through the ServeEngine, then the check that
greedy decode agrees with the teacher-forced forward.

Counterpart of ``examples/serve_lm.py``:

    PYTHONPATH=src python examples/port/serve_lm.py \\
        [--arch h2o-danube-1.8b] [--device cpu]

h2o-danube exercises the sliding-window ring cache.
"""

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.serve import ServeEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=48)
    ap.add_argument("--new", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = configs.smoke(args.arch).with_(act_dtype="float32")
    model = transformer.DecoderLM(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    engine = ServeEngine(cfg, model, max_len=args.prompt + args.new)

    prompts = torch.randint(
        0, cfg.vocab, (args.batch, args.prompt), device=dev,
        generator=torch.Generator(device=dev).manual_seed(1))
    t0 = time.time()
    out = engine.generate(prompts, args.new)
    out_host = out.cpu()  # waits for the device
    dt = time.time() - t0
    print(f"{cfg.name}: generated {tuple(out_host.shape)} in {dt:.2f}s "
          f"({args.batch * args.new / dt:.1f} tok/s)")

    # consistency: greedy decode must match the argmax of the full
    # teacher-forced forward over the same prefix at every position
    full = torch.cat([prompts, out.long()], dim=1)
    with torch.inference_mode():
        logits = transformer.forward(model, full)
    ref = logits[:, args.prompt - 1:-1].argmax(dim=-1)
    match = float((ref == out).float().mean())
    print(f"decode-vs-forward greedy agreement: {match:.1%}")
    assert match > 0.99, "serving path diverged from training forward"


if __name__ == "__main__":
    main()
