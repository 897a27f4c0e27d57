"""Where a serve-path step's time goes on the card, run op by op and
replayed as a CUDA graph.

Runs a full-width model (``--arch``, default tinyllama-1.1b; bf16,
kernels on) at the serve geometry — one prefill of 8 x 512 tokens, then 8
decode steps against the 576-slot cache; for the families with a paged
form (dense), also the same prefill scattered into a page pool, then 8
paged decode steps over 36-page tables of 16, then 3 prefill-continuation
chunks of 16 tokens on every row through the pool (the paged fused tick's
call), then 3 such chunks against the dense cache (the dense fused tick's
call: one flash_decode chunk-form launch per layer) — under
``torch.profiler``. Each region runs twice: eagerly, op by
op, and as the replay of a CUDA graph captured from the same calls
(``serving.graphs.StepGraph``, as the engine runs its steps; the 8 decode
steps are one graph, as the engine's decode chunk is). It prints for
each: wall time (host clock, device synchronised), device time summed over
kernels, the device busy share (device time / wall), kernel launches, and
device time split into the port's kernels, matrix products and everything
else, plus the top kernels by device time. For the MoE family (granite-
moe-3b-a800m) the eager regions also split the device time into the
attention kernels, the expert products, the dispatch (router, top-k,
sort, the gathers and scatters into and out of the expert buffer) and
the rest, from the profiler ranges ``models/moe.py`` opens
(``moe_split``); a replayed graph runs no Python, so its regions have no
such split.

Usage (on the machine with the card):
  PYTHONPATH=src python -m repro_torch.launch.profile_step \
      [--arch mamba2-130m | granite-moe-3b-a800m] [--layers N]
      (default: the published depth)
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.models.model import LM
from repro_torch.serving.graphs import (StepGraph, capture_stream,
                                       tensor_leaves)

B, PROMPT, CAP, STEPS = 8, 512, 576, 8
PAGE, CHUNK, CHUNKS = 16, 16, 3


def _classify(name: str) -> str:
    n = name.lower()
    if any(k in n for k in ("flash_prefill", "flash_decode", "paged_decode",
                            "paged_chunk", "ssd_scan")):
        return "port_kernels"
    if any(s in n for s in ("gemm", "gemv", "cutlass", "xmma", "cublas",
                            "nvjet")):      # nvjet: cuBLAS's Hopper kernels
        return "matmul"
    return "other"


def moe_split(events, device_ms: float) -> dict:
    """Device ms of the MoE ranges among ``key_averages()`` ``events``
    (each range's kernels, its children's included) and the split of
    ``device_ms``: attention kernels, expert products, dispatch (the
    ``moe.dispatch`` and ``moe.combine`` ranges) and the rest. Empty when
    no MoE range ran."""
    cuda = torch.autograd.DeviceType.CUDA
    ranges = {e.key: e.device_time_total / 1e3 for e in events
              if e.key.startswith("moe.") and e.device_type != cuda}
    if not ranges:
        return {}
    attention = sum(e.self_device_time_total for e in events
                    if e.device_type == cuda
                    and _classify(e.key) == "port_kernels") / 1e3
    experts = ranges.get("moe.experts", 0.0)
    dispatch = ranges.get("moe.dispatch", 0.0) + ranges.get("moe.combine",
                                                              0.0)
    return {"attention_ms": attention, "experts_ms": experts,
            "dispatch_ms": dispatch,
            "rest_ms": device_ms - attention - experts - dispatch}


def _region(fn, label: str, top: int = 8) -> dict:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    split = {"port_kernels": 0.0, "matmul": 0.0, "other": 0.0}
    launches = 0
    rows = []
    for e in prof.key_averages():
        dev_us = e.self_device_time_total
        if dev_us <= 0 or e.device_type != torch.autograd.DeviceType.CUDA \
                or e.key.startswith("moe."):   # a range's span, no kernel
            continue
        split[_classify(e.key)] += dev_us / 1e3
        launches += e.count
        rows.append((dev_us / 1e3, e.count, e.key[:90]))
    dev_ms = sum(split.values())
    out = {"region": label, "wall_ms": wall_ms, "device_ms": dev_ms,
           "busy_share": dev_ms / wall_ms if wall_ms else float("nan"),
           "kernel_launches": launches,
           **{f"{k}_ms": v for k, v in split.items()},
           **{f"moe_{k}": v for k, v in moe_split(prof.key_averages(),
                                                  dev_ms).items()}}
    print(json.dumps(out))
    for ms, n, name in sorted(rows, reverse=True)[:top]:
        print(f"    {ms:9.3f} ms  {n:6d}x  {name}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--layers", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs an NVIDIA card")
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    cfg = cfg.replace(num_layers=args.layers or cfg.num_layers,
                      use_kernels=True)
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (B, PROMPT), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    state = {}

    def prefill():
        return lm.prefill(params, {"tokens": toks}, max_len=CAP)

    def decode_steps(tok):
        for _ in range(STEPS):
            logits, _ = lm.decode_step(params, state["cache"], tok)
            tok = torch.argmax(logits, -1)
        return logits

    def decode():
        state["logits"] = decode_steps(torch.argmax(state["logits"], -1))

    width = CAP // PAGE

    def paged_admit():
        logits, pref = lm.prefill(params, {"tokens": toks}, max_len=PROMPT)
        state["plogits"] = logits
        state["pcache"] = lm.init_paged_cache(B, B * width + 1, PAGE, width,
                                              dev)
        lm.paged_admit(state["pcache"], pref,
                       torch.zeros(B, dtype=torch.int64, device=dev),
                       torch.argmax(logits, -1),
                       torch.arange(1, B * width + 1,
                                    device=dev).reshape(B, width),
                       torch.arange(B, device=dev))

    def paged_steps(tok):
        for _ in range(STEPS):
            logits, _ = lm.decode_step_paged(params, state["pcache"], tok,
                                             n_pages=width)
            tok = torch.argmax(logits, -1)
        return logits

    def paged_decode():
        state["plogits"] = paged_steps(torch.argmax(state["plogits"], -1))

    def chunk(tokens, start, n_valid):
        return lm.prefill_chunk_paged(params, state["pcache"], tokens, start,
                                      n_valid)[0]

    n_valid = torch.full((B,), CHUNK, device=dev)
    starts = [torch.full((B,), PROMPT + i * CHUNK, device=dev)
              for i in range(CHUNKS)]

    def fused_chunks():
        for start in starts:
            chunk(toks[:, :CHUNK], start, n_valid)

    def dense_chunk(tokens, start, n_valid):
        return lm.prefill_chunk(params, state["cache"], tokens, start,
                                n_valid)[0]

    def dense_chunks():
        for start in starts:
            dense_chunk(toks[:, :CHUNK], start, n_valid)

    paged = lm.supports_paged_cache()
    state["logits"], state["cache"] = prefill()
    decode()                                       # warm-up (builds, caches)
    if paged:
        paged_admit()
        paged_decode()
        fused_chunks()
        dense_chunks()

    # the same calls captured: warm all on the capture stream, then capture
    stream = capture_stream(dev)
    tok = torch.argmax(state["logits"], -1)

    def captured():
        return (tensor_leaves(params) + tensor_leaves(state["cache"])
                + tensor_leaves(state.get("pcache")))

    graphs = {
        "prefill": StepGraph("prefill", lambda tokens: lm.prefill(
            params, {"tokens": tokens}, max_len=CAP), {"tokens": toks},
            captured, stream),
        "decode": StepGraph("decode", decode_steps, {"tok": tok}, captured,
                            stream)}
    if paged:
        graphs["paged"] = StepGraph("paged decode", paged_steps,
                                    {"tok": tok}, captured, stream)
        graphs["chunk"] = StepGraph("chunk", chunk, {
            "tokens": toks[:, :CHUNK], "start": starts[0],
            "n_valid": n_valid}, captured, stream)
        graphs["dense chunk"] = StepGraph("dense chunk", dense_chunk, {
            "tokens": toks[:, :CHUNK], "start": starts[0],
            "n_valid": n_valid}, captured, stream)
    pool = torch.cuda.graph_pool_handle()
    for g in graphs.values():                   # after every warm-up
        g.capture(pool)

    def replay(name, **inputs):
        return lambda: graphs[name].run(**inputs)

    def chunk_replays(name):
        def run():
            for start in starts:
                graphs[name].run(tokens=toks[:, :CHUNK], start=start,
                                 n_valid=n_valid)
        return run

    print(f"{args.arch} L{cfg.num_layers} bf16, kernels on, "
          f"{torch.cuda.get_device_name(0)}")
    regions = [(prefill, replay("prefill", tokens=toks),
                f"prefill B={B} S={PROMPT}"),
               (decode, replay("decode", tok=tok),
                f"decode {STEPS} steps B={B} C={CAP}")]
    if paged:
        regions += [(paged_decode, replay("paged", tok=tok),
                     f"paged decode {STEPS} steps B={B} n_pages={width} "
                     f"page={PAGE}"),
                    (fused_chunks, chunk_replays("chunk"),
                     f"paged prefill chunks {CHUNKS} x {CHUNK} tokens B={B}"),
                    (dense_chunks, chunk_replays("dense chunk"),
                     f"dense prefill chunks {CHUNKS} x {CHUNK} tokens B={B} "
                     f"C={CAP}")]
    for eager_fn, replay_fn, label in regions:
        e = _region(eager_fn, f"{label}, eager")
        r = _region(replay_fn, f"{label}, graph replay")
        print(f"  replay/eager: wall {r['wall_ms'] / e['wall_ms']:.3f}, "
              f"kernels seen by the profiler {r['kernel_launches']} / "
              f"{e['kernel_launches']}")


if __name__ == "__main__":
    main()
