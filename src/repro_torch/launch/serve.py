"""Serving launcher: the paper's dynamic-index service and LM serving,
the counterpart of ``repro/launch/serve.py``, with the same flags and
``--device``.

  * ``--service index`` -- a thin CLI over the ported workload driver
    (:mod:`repro_torch.serving.driver`): the churn trace for (``--dist``,
    ``--kind``), or another ``--scenario``, through the versioned
    serving runtime, with per-op percentiles over the measured steps.
  * ``--service lm`` -- batched LM serving (prefill + greedy decode)
    through :class:`repro_torch.serve.ServeEngine` on the arch's smoke
    config at f32, as the reference's (every decoder arch, the MoE,
    Mamba and RWKV6 ones included).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --service index \\
      --n 100000 --batches 20 --queries 1000 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --service lm \\
      --arch qwen1.5-0.5b --batch 4 --new 16 [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.data import points as gen
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.serve import ServeEngine
from repro_torch.serving import driver as serving_driver


def serve_index(args, dev):
    """Replay the churn trace for (--dist, --kind) through the serving
    runtime; ``--scenario`` picks any other registered trace shape."""
    scenario = args.scenario or args.dist
    # churn bootstraps half of --n and streams in the rest; for the
    # dynamic shapes --n is the object/window count itself
    n = args.n // 2 if scenario in gen.GENERATORS else args.n
    cfg = serving_driver.DriverCfg(
        n=n, batch=max(args.n // (2 * args.batches), 16),
        steps=args.batches, warmup=min(2, max(args.batches // 2, 1)),
        queries=args.queries, k=args.k, seed=args.seed)
    payload = serving_driver.run(kinds=(args.kind,),
                                 scenarios=(scenario,), cfg=cfg,
                                 verbose=True, device=dev)
    res = payload["results"][args.kind][scenario]
    thr = res["throughput"]
    print(f"index service [{scenario}/{args.kind}] n={args.n}: "
          f"build {res['build_s']:.2f}s | "
          f"{thr['query_per_s']:,.0f} q/s | "
          f"{thr['update_pts_per_s']:,.0f} update-pts/s | "
          f"final size {res['final_size']} | "
          f"recoveries {res['recoveries']}")


def serve_lm(args, dev):
    cfg = configs.smoke(args.arch).with_(act_dtype="float32")
    model = transformer.DecoderLM(
        cfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(args.seed))
    engine = ServeEngine(cfg, model, max_len=args.prompt + args.new)
    prompts = torch.randint(
        0, cfg.vocab, (args.batch, args.prompt), device=dev,
        generator=torch.Generator(device=dev).manual_seed(1))
    t0 = time.time()
    out = engine.generate(prompts, args.new)
    out = out.cpu()  # waits for the device
    dt = time.time() - t0
    print(f"lm serving [{cfg.name}]: batch={args.batch} prompt={args.prompt}"
          f" +{args.new} new -> {tuple(out.shape)}, "
          f"{args.batch * args.new / dt:,.1f} tok/s")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--service", choices=["index", "lm"], default="index")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; a host "
                    "without CUDA needs --device cpu)")
    # index service
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--dist", default="uniform",
                    choices=list(gen.GENERATORS))
    ap.add_argument("--kind", default="spac-h",
                    help="registered index backend (see repro_torch.core)")
    ap.add_argument("--scenario", default=None,
                    choices=list(gen.SCENARIOS),
                    help="trace shape (default: churn over --dist); "
                         "moving-objects / sliding-window etc.")
    # lm service
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--new", type=int, default=16)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    (serve_index if args.service == "index" else serve_lm)(args, dev)


if __name__ == "__main__":
    main()
