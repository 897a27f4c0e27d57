#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Drives ``repro_torch`` (never the JAX package) phase by phase; any failing
phase raises, and the script exits nonzero:

  1. device   card name and power limit (nvidia-smi), torch/CUDA versions;
  2. build    nvcc builds every kernel from ``src/repro_torch/kernels/csrc``;
  3. kernels  each CUDA kernel against its plain PyTorch version at the
              serve path's shapes (bf16 and fp32) and on small edge cases
              (window, softcap, ragged lengths), with stated tolerances; then
              kernel / plain / library (SDPA, a yardstick the port never
              calls) times from CUDA events, inputs rotated through more
              than the 50 MB L2 cache, beside the bound (bytes or operations
              over the card's peak rates);
  4. model    full-width tinyllama-1.1b (22 layers, bf16): prefill of 8 x 512
              tokens plus 8 decode steps with the kernels on and off, logits
              held to a stated tolerance; a full-width 4-layer fp32 rung must
              give identical greedy tokens either way;
  5. serve    the InfAdapter loop (``launch.serve``: full-width ladder
              8/15/22 layers, calibrate, ``run_serving_loop`` with the
              controller) for ~30 s; every request completes with its full
              budget and both kernels' launch counters grow in this phase;
  6. output   the ``{"kernels": [...]}`` line, then the ok line last.

Usage: ``python3 chip_smoke.py`` from the repository root (one card).
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet, at 700 W
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
TOL = {"torch.float32": 1e-5, "torch.bfloat16": 1e-2}
L2_BYTES = 50e6

# serve path geometry (launch.serve GEOMETRY[True]) and model widths
B, PROMPT, MAX_NEW, CHUNK = 8, 512, 64, 8
H, KV, HD = 32, 4, 64
CAP = PROMPT + MAX_NEW
BF16_LOGIT_TOL = 5e-2       # ||on - off|| / ||off|| over the logits, bf16
SERVE_SECONDS = 30
DEVICE = "cuda"


def log(msg):
    print(msg, flush=True)


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype)]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                      else "operations")


def time_ms(torch, fn, arg_sets, iters=40):
    """Mean ms per call over ``iters`` calls cycling through ``arg_sets``
    (together larger than L2, so each call finds its inputs cold)."""
    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def check(name, got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[str(dtype)]
    log(f"  {name:<44s} max_abs_err {err:.3e}  tol {tol:.0e}")
    if not err <= tol:
        raise AssertionError(f"{name}: max abs err {err} > {tol}")
    return err


def kernel_phase(torch):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def dec_inputs(b, kv, g, hd, c, dtype, masked=False):
        bias = torch.zeros((b, c), device=dev)
        if masked:
            bias[:, c // 3:] = -1e9
        return (randn(b, kv, g, hd, dtype=dtype), randn(b, kv, c, hd, dtype=dtype),
                randn(b, kv, c, hd, dtype=dtype), bias)

    def pre_inputs(b, s, h, kv, hd, dtype):
        return (randn(b, s, h, hd, dtype=dtype), randn(b, s, kv, hd, dtype=dtype),
                randn(b, s, kv, hd, dtype=dtype))

    log("[3] kernels against their plain versions")
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, bias = dec_inputs(B, KV, H // KV, HD, CAP, dtype)
        errs[("decode", dtype)] = check(
            f"flash_decode serve shape {str(dtype)[6:]}",
            fd.flash_decode_bkhd(q, k, v, bias),
            fd.flash_decode_plain(q, k, v, bias), dtype)
        q, k, v = pre_inputs(B, PROMPT, H, KV, HD, dtype)
        errs[("prefill", dtype)] = check(
            f"flash_prefill serve shape {str(dtype)[6:]}",
            fp.flash_prefill_bshd(q, k, v), fp.flash_prefill_plain(q, k, v),
            dtype)
        for c, sc in ((100, 0.0), (37, 30.0)):
            q, k, v, bias = dec_inputs(2, 2, 4, 128, c, dtype, masked=True)
            check(f"flash_decode C={c} softcap={sc} hd128 {str(dtype)[6:]}",
                  fd.flash_decode_bkhd(q, k, v, bias, softcap=sc),
                  fd.flash_decode_plain(q, k, v, bias, softcap=sc), dtype)
        for s, w, sc in ((40, 0, 0.0), (130, 8, 30.0), (200, 64, 0.0)):
            q, k, v = pre_inputs(2, s, 8, 2, 64, dtype)
            check(f"flash_prefill S={s} window={w} softcap={sc} "
                  f"{str(dtype)[6:]}",
                  fp.flash_prefill_bshd(q, k, v, window=w, softcap=sc),
                  fp.flash_prefill_plain(q, k, v, window=w, softcap=sc),
                  dtype)
    torch.cuda.synchronize()

    log("    timing at the serve shapes, bf16 (ms per call, inputs cold)")
    dt = torch.bfloat16
    esz = 2
    dec_set = dec_inputs(B, KV, H // KV, HD, CAP, dt)
    n_dec = int(3 * L2_BYTES // sum(t.numel() * t.element_size()
                                    for t in dec_set)) + 1
    decs = [dec_set] + [dec_inputs(B, KV, H // KV, HD, CAP, dt)
                        for _ in range(n_dec - 1)]
    sdpa_dec = [(q.reshape(B, H, 1, HD), k, v, bias[:, None, None, :])
                for q, k, v, bias in decs]
    rows = []
    t_k = time_ms(torch, fd.flash_decode_bkhd, decs)
    t_p = time_ms(torch, fd.flash_decode_plain, decs, iters=20)
    t_l = time_ms(torch, lambda q, k, v, m: F.scaled_dot_product_attention(
        q, k, v, attn_mask=m, enable_gqa=True), sdpa_dec)
    nbytes = esz * (2 * B * H * HD + 2 * B * KV * CAP * HD) + 4 * B * CAP
    b_ms, b_by = bound(nbytes, 4 * B * H * CAP * HD, dt)
    rows.append(dict(name="flash_decode", route="cuda",
                     source="src/repro_torch/kernels/csrc/flash_decode.cu",
                     replaces="src/repro/kernels/flash_decode.py:81",
                     max_abs_err=errs[("decode", dt)], ms=t_k, plain_ms=t_p,
                     bound_ms=b_ms, bound_by=b_by, library_ms=t_l))
    pre_set = pre_inputs(B, PROMPT, H, KV, HD, dt)
    n_pre = int(3 * L2_BYTES // sum(t.numel() * t.element_size()
                                    for t in pre_set)) + 1
    pres = [pre_set] + [pre_inputs(B, PROMPT, H, KV, HD, dt)
                        for _ in range(n_pre - 1)]
    sdpa_pre = [(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                 v.transpose(1, 2).contiguous()) for q, k, v in pres]
    t_k = time_ms(torch, fp.flash_prefill_bshd, pres, iters=20)
    t_p = time_ms(torch, fp.flash_prefill_plain, pres, iters=6)
    t_l = time_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), sdpa_pre)
    nbytes = esz * (2 * B * PROMPT * H * HD + 2 * B * PROMPT * KV * HD)
    pairs = PROMPT * (PROMPT + 1) // 2            # causal (query, key) pairs
    b_ms, b_by = bound(nbytes, 4 * B * H * pairs * HD, dt)
    rows.append(dict(name="flash_prefill", route="cuda",
                     source="src/repro_torch/kernels/csrc/flash_prefill.cu",
                     replaces="src/repro/kernels/flash_prefill.py:88",
                     max_abs_err=errs[("prefill", dt)], ms=t_k, plain_ms=t_p,
                     bound_ms=b_ms, bound_by=b_by, library_ms=t_l))
    for r in rows:
        log(f"  {r['name']:<14s} kernel {r['ms']:.4f}  plain {r['plain_ms']:.4f}"
            f"  library {r['library_ms']:.4f}  bound {r['bound_ms']:.4f} "
            f"({r['bound_by']})")
    return rows


def model_phase(torch):
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    dev = torch.device(DEVICE)
    log("[4] model: full-width tinyllama-1.1b, kernels on vs off")
    cfg = get_config("tinyllama-1.1b")
    toks = torch.randint(0, cfg.vocab_size, (B, PROMPT), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))

    def run(lm, params, feed=None):
        """Prefill + 8 decode steps; feeds ``feed`` tokens when given,
        else its own greedy tokens. Returns (logits list, tokens, ms)."""
        torch.cuda.synchronize()
        t0 = time.time()
        logits, cache = lm.prefill(params, {"tokens": toks}, max_len=CAP)
        torch.cuda.synchronize()
        t1 = time.time()
        outs, seq = [logits], []
        for i in range(8):
            tok = torch.argmax(logits, -1) if feed is None else feed[i]
            seq.append(tok)
            logits, cache = lm.decode_step(params, cache, tok)
            outs.append(logits)
        torch.cuda.synchronize()
        t2 = time.time()
        return outs, seq, ((t1 - t0) * 1e3, (t2 - t1) * 1e3 / 8)

    lm_off = LM(cfg)
    lm_on = LM(cfg.replace(use_kernels=True))
    params = lm_off.init(torch.Generator(device=dev).manual_seed(0))
    run(lm_on, params)                                   # warm-up
    off, seq, t_off = run(lm_off, params)
    on, _, t_on = run(lm_on, params, feed=seq)
    rel = max(((a.float() - b.float()).norm() / b.float().norm()).item()
              for a, b in zip(on, off))
    finite = all(bool(torch.isfinite(a).all()) for a in on)
    log(f"  L22 bf16: logits rel err (on vs off) {rel:.3e}  tol "
        f"{BF16_LOGIT_TOL:.0e}  finite {finite}")
    log(f"  L22 bf16 B={B} S={PROMPT}: prefill ms on {t_on[0]:.2f} off "
        f"{t_off[0]:.2f}; decode step ms on {t_on[1]:.2f} off {t_off[1]:.2f}")
    if not (finite and rel <= BF16_LOGIT_TOL):
        raise AssertionError(f"bf16 logits disagree: rel err {rel}")
    del params, on, off
    cfg32 = cfg.replace(num_layers=4, dtype="float32", name="tinyllama-L4-f32")
    lm_off, lm_on = LM(cfg32), LM(cfg32.replace(use_kernels=True))
    params = lm_off.init(torch.Generator(device=dev).manual_seed(0))
    _, seq_off, _ = run(lm_off, params)
    _, seq_on, _ = run(lm_on, params)
    same = all(bool((a == b).all()) for a, b in zip(seq_on, seq_off))
    log(f"  L4 fp32: greedy 8 tokens x {B} rows identical on vs off: {same}")
    if not same:
        raise AssertionError("fp32 greedy tokens differ with kernels on/off")
    del params
    torch.cuda.empty_cache()
    return {"prefill_ms_on": t_on[0], "prefill_ms_off": t_off[0],
            "decode_step_ms_on": t_on[1], "decode_step_ms_off": t_off[1],
            "logits_rel_err": rel}


def serve_phase(torch):
    from repro_torch.core.adapter import ControllerConfig, InfAdapterController
    from repro_torch.core.forecaster import MovingMaxForecaster
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import (GEOMETRY, LOAD, build_ladder,
                                          calibrate)
    from repro_torch.serving.driver import rise_fall_load, run_serving_loop
    from repro_torch.serving.engine import InProcessServingEngine
    log("[5] serve: InfAdapter loop, full-width ladder, kernels on")
    variants = build_ladder("tinyllama-1.1b", full_width=True)
    geo = GEOMETRY[True]
    engine = InProcessServingEngine(variants, use_kernels=True,
                                    device=DEVICE, **geo)
    profiles = calibrate(engine, variants, reps=2, max_new=geo["max_new"])
    for n, p in profiles.items():
        log(f"  {n}: rt {p.rt:.3f}s  {p.th_slope:.2f} rps/unit  "
            f"p(1) {p.p99_ms(1):.0f} ms")
    slo_ms = 5000.0
    ctrl = InfAdapterController(
        profiles, MovingMaxForecaster(window=10),
        ControllerConfig(interval_s=6.0, budget=3, slo_ms=slo_ms, beta=0.05,
                         gamma=0.05, reactive=True, queue_aware=True))
    vocab = next(iter(variants.values()))[0].vocab_size
    ops.reset_launch_counts()
    t0 = time.time()
    n_sub = run_serving_loop(engine, ctrl, seconds=SERVE_SECONDS,
                             interval=6.0,
                             load_fn=rise_fall_load(SERVE_SECONDS,
                                                    *LOAD[True]),
                             prompt_len=geo["prompt_len"],
                             max_new=geo["max_new"], vocab=vocab, log=log)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = ops.launch_counts()
    s = engine.summarize(slo_ms, max(p.accuracy for p in profiles.values()))
    if not s or s["n_requests"] < 1:
        raise AssertionError(f"no request completed ({n_sub} submitted)")
    if s["pending"] != 0:
        raise AssertionError(f"{s['pending']} requests pending after drain")
    bad = [r.rid for r in engine.done
           if len(r.output) != min(r.max_new, geo["max_new"])
           or not ((r.output >= 0) & (r.output < vocab)).all()]
    if bad:
        raise AssertionError(f"requests with wrong outputs: {bad[:10]}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel never ran in the serve phase: "
                             f"{launches}")
    summary = {"n_submitted": n_sub, "n_requests": s["n_requests"],
               "rejected": s["rejected"], "p99_ms": s["p99_ms"],
               "p50_ms": s["p50_ms"], "violation_rate": s["violation_rate"],
               "goodput": s["goodput"], "avg_cost_units": s["avg_cost_units"],
               "accuracy_loss": s["accuracy_loss"], "slo_ms": slo_ms,
               "wall_s": wall,
               "readiness_s": {n: p.rt for n, p in profiles.items()},
               "launches": launches}
    log("  serve summary " + json.dumps(summary))
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false")
    if not (ROOT / "src" / "repro_torch").is_dir():
        sys.exit("chip_smoke: run from a checkout of the repository "
                 "(src/repro_torch is missing)")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"[1] device {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    from repro_torch.kernels import build
    t0 = time.time()
    build.ensure_built()
    log(f"[2] build: {time.time() - t0:.1f}s into {build.lib_dir()}")
    for n in build.SOURCES:
        for line in build.build_log(n).splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {n}: {line.strip()}")

    rows = kernel_phase(torch)
    model_phase(torch)
    launches = serve_phase(torch)
    for r in rows:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
