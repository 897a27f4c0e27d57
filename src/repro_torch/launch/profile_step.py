"""Where a serve-path step's time goes on the card.

Runs the full-width tinyllama-1.1b model (bf16, kernels on) at the serve
geometry — one prefill of 8 x 512 tokens, then 8 decode steps against the
576-slot ring cache — under ``torch.profiler``, and prints for each: wall
time (host clock, device synchronised), device time summed over kernels,
the device busy share (device time / wall), kernel launches, and device
time split into the attention kernels, matrix products and everything
else, plus the top kernels by device time.

Usage (on the machine with the card):
  PYTHONPATH=src python -m repro_torch.launch.profile_step [--layers 22]
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.models.model import LM

B, PROMPT, CAP, STEPS = 8, 512, 576, 8


def _classify(name: str) -> str:
    n = name.lower()
    if "flash_prefill" in n or "flash_decode" in n:
        return "attention_kernels"
    if any(s in n for s in ("gemm", "gemv", "cutlass", "xmma", "cublas",
                            "nvjet")):      # nvjet: cuBLAS's Hopper kernels
        return "matmul"
    return "other"


def _region(fn, label: str, top: int = 8) -> dict:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    split = {"attention_kernels": 0.0, "matmul": 0.0, "other": 0.0}
    launches = 0
    rows = []
    for e in prof.key_averages():
        dev_us = e.self_device_time_total
        if dev_us <= 0 or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        split[_classify(e.key)] += dev_us / 1e3
        launches += e.count
        rows.append((dev_us / 1e3, e.count, e.key[:90]))
    dev_ms = sum(split.values())
    out = {"region": label, "wall_ms": wall_ms, "device_ms": dev_ms,
           "busy_share": dev_ms / wall_ms if wall_ms else float("nan"),
           "kernel_launches": launches,
           **{f"{k}_ms": v for k, v in split.items()}}
    print(json.dumps(out))
    for ms, n, name in sorted(rows, reverse=True)[:top]:
        print(f"    {ms:9.3f} ms  {n:6d}x  {name}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=22)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs an NVIDIA card")
    dev = torch.device("cuda")
    cfg = get_config("tinyllama-1.1b").replace(num_layers=args.layers,
                                               use_kernels=True)
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (B, PROMPT), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    state = {}

    def prefill():
        state["logits"], state["cache"] = lm.prefill(
            params, {"tokens": toks}, max_len=CAP)

    def decode():
        for _ in range(STEPS):
            tok = torch.argmax(state["logits"], -1)
            state["logits"], _ = lm.decode_step(params, state["cache"], tok)

    prefill()
    decode()                                       # warm-up (builds, caches)
    print(f"tinyllama-1.1b L{args.layers} bf16, kernels on, "
          f"{torch.cuda.get_device_name(0)}")
    _region(prefill, f"prefill B={B} S={PROMPT}")
    _region(decode, f"decode {STEPS} steps B={B} C={CAP}")


if __name__ == "__main__":
    main()
