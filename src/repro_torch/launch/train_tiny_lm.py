"""Train a small LM for a few hundred steps with the full training
substrate (data pipeline -> model -> Adam -> metrics): the counterpart of
the reference's ``examples/train_tiny_lm.py``, with its defaults and its
output. A reduced tinyllama-family config sized for the CPU; runs on the
card unless ``--device cpu``.

Run:  PYTHONPATH=src python -m repro_torch.launch.train_tiny_lm [--steps 200]
"""
import argparse
import time

import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.data.tokens import SyntheticTokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.train.optimizer import (AdamConfig, adam_init, adam_update,
                                         tree_leaves, value_and_grad)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_variant(get_config("tinyllama-1.1b")).replace(
        num_layers=4, d_model=256, d_ff=512, vocab_size=512, remat=False)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        dtype=model.param_dtype)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"model: {cfg.name} ({n_params/1e6:.1f}M params)")

    pipe = SyntheticTokenPipeline(vocab=cfg.vocab_size, seq_len=args.seq,
                                  batch=args.batch, seed=0, device=dev)
    opt_cfg = AdamConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    opt = adam_init(params)

    def step(params, opt, batch):
        (loss, metrics), grads = value_and_grad(model.loss, params, batch)
        params, opt, om = adam_update(opt_cfg, grads, opt, params)
        return params, opt, loss, om["grad_norm"]

    t0 = time.time()
    first_loss = None
    for i in range(args.steps):
        batch = pipe.next_batch()
        params, opt, loss, gnorm = step(params, opt, batch)
        if i == 0:
            first_loss = float(loss)
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {float(loss):.4f} |g| {float(gnorm):.3f}")
    dt = time.time() - t0
    print(f"\n{args.steps} steps in {dt:.1f}s "
          f"({args.steps*args.batch*args.seq/dt:.0f} tok/s)")
    print(f"loss: {first_loss:.3f} -> {float(loss):.3f} "
          f"({'learned' if float(loss) < first_loss - 0.5 else 'check lr'})")


if __name__ == "__main__":
    main()
