"""Training launcher: the port of ``repro.launch.train``.

Trains a reduced config (or, with ``--full-config``, the published one)
with the full substrate: the synthetic token pipeline, ``LM.loss``, the
train step at ``TRAIN_ADAM`` with optional microbatches, and checkpoints
every ``--ckpt-every`` steps, resuming from the newest one in
``--ckpt-dir``. Params are kept in the param dtype (fp32) and the compute
runs in the config's dtype, as in the reference. Runs on the card unless
``--device cpu``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --steps 100 --batch 8 --seq 128 [--microbatches 2] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.data.tokens import SyntheticTokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import adam_init, tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--full-config", action="store_true",
                    help="use the published config at full width (a card's "
                         "job, not the CPU's)")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory (resume if it has checkpoints)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = smoke_variant(cfg).replace(num_layers=4, d_model=256, d_ff=512,
                                         vocab_size=512, remat=False)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        dtype=model.param_dtype)
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"{cfg.name}: {n/1e6:.1f}M params, microbatches={args.microbatches}")

    step = make_train_step(cfg, microbatches=args.microbatches)
    opt = adam_init(params)
    start = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        state, meta = ckpt.restore(args.ckpt_dir, {"params": params, "opt": opt})
        params, opt = state["params"], state["opt"]
        start = ckpt.latest_step(args.ckpt_dir) + 1
        print(f"resumed from step {start - 1}")
    pipe = SyntheticTokenPipeline(vocab=cfg.vocab_size, seq_len=args.seq,
                                  batch=args.batch, device=dev)
    t0 = time.time()
    for i in range(start, start + args.steps):
        params, opt, metrics = step(params, opt, pipe.next_batch())
        if i % max(args.steps // 10, 1) == 0:
            print(f"step {i:4d} loss {float(metrics['loss']):.4f} "
                  f"lr {float(metrics['lr']):.2e}")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, i, {"params": params, "opt": opt},
                      metadata={"loss": float(metrics['loss'])})
            ckpt.prune(args.ckpt_dir, keep=3)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"{args.steps} steps in {dt:.1f}s "
          f"({args.steps * args.batch * args.seq / dt:.0f} tok/s), "
          f"final loss {float(metrics['loss']):.4f}")


if __name__ == "__main__":
    main()
