#!/usr/bin/env python3
"""Variants of the pipelined ``wgmma`` prefill and the tensor-core decode
step (both templates on the head dim), each built from this checkout's
sources with one text patch, timed on the card and held to the plain
version: what the source notes of ``csrc/flash_prefill.cu`` and
``csrc/flash_decode_step.cu`` report as tried and as diagnostics (a
``diag`` variant computes a wrong result on purpose, to time the kernel
without one of its parts). The prefill is timed at gemma-2b's (hd 256)
and internvl2-26b's (G 6 / hd 128) serve shapes and at the three hd-64
ones: tinyllama-1.1b's (32 heads on 4 KV heads), granite-moe's (24 on 8)
and whisper-tiny's decoder (6 on 6); the decode step at the first two.
The decode step's body lives in ``csrc/decode_step.cuh``: its variants
patch that header, and each builds ``flash_decode_step.cu`` beside its
own copy.

    python3 kernel_variants.py                 # from the repository root
    python3 kernel_variants.py --hd 64         # the hd-64 shapes alone
    git archive <commit> | tar -x -C build/<name>
    python3 kernel_variants.py --hd 64 --parent build/<name>

``--parent`` adds an earlier checkout's hd-64 route as it was (rows
``<name>_as_committed``) and, where that route is the `cp.async` kernel
``flash_prefill_wgmma_kernel``, its diagnostics. Device ms per call come
from chip_smoke's ``device_ms`` (the profiler's kernel time over inputs
rotated through more than 3x the L2 size); the prefill at B 8, S 512;
the decode step at B 8, C 576, by split count. Prints ptxas's registers
and spills of each prefill variant's kernels, one line a variant and
shape, and the card's name and power limit. Builds go to
``build/kernel_variants/`` (ignored by git).
"""
import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "kernel_variants"
B, S, C = 8, 512, 576
# (name, query heads, KV heads, head dim, the decode step's split counts;
# none at hd 64, where the prefill alone is timed)
SHAPES = (("gemma", 8, 1, 256, (4, 6, 8)),
          ("internvl", 48, 8, 128, (4, 5, 6, 7, 8)),
          ("tinyllama", 32, 4, 64, ()),
          ("granite", 24, 8, 64, ()),
          ("whisper", 6, 6, 64, ()))


def sub(text, old, new):
    if old not in text:
        raise SystemExit(f"kernel_variants: no patch target {old[:50]!r}")
    return text.replace(old, new)


def in_region(text, start, end, old, new):
    """``text`` with ``old`` replaced between the first ``start`` and the
    next ``end`` only."""
    i = text.index(start)
    j = text.index(end, i)
    return text[:i] + sub(text[i:j], old, new) + text[j:]


FP32 = "// " + "=" * 60 + " fp32: CUDA cores"
WIDE = "flash_prefill_wide_kernel(const"


def prefill_variants(src):
    """name -> (flash_prefill.cu text, the head dims it is timed at)."""
    lam = src.index("  auto rescale_split = [&]")
    split_lines = src[src.index("      split_bf16_trunc(p0[0]", lam):
                      src.index("  };", lam)]

    def in_rescale_split(text, old, new):
        """``text`` with ``old`` replaced inside the wide kernel's
        rescale_split only."""
        i = text.index("  auto rescale_split = [&]")
        return text[:i] + sub(text[i:], old, new)
    stores = src[src.index("  // O / l in bf16, staged"):src.index(FP32)]
    direct = """  if (wg == 1 && !two) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
    const int qi = q0 + warp * 16 + g + r * 8;
    if (qi >= S) continue;
    __nv_bfloat16* orow = out + (size_t)b * S * q_stride +
                          (size_t)qi * q_stride + (size_t)h * HD + 2 * t;
#pragma unroll
    for (int nn = 0; nn < HD / 8; ++nn)
      *reinterpret_cast<uint32_t*>(orow + nn * 8) =
          pack_bf16(o[4 * nn + 2 * r] * l[r], o[4 * nn + 2 * r + 1] * l[r]);
  }
}

"""
    # Q's A fragments held in registers at hd 128 (one head a CTA): QK^T as
    # `wgmma` with A from registers, so only K is read from shared memory
    q_regs = sub(sub(sub(
        src,
        "  uint32_t ph[4][4], pl[4][4];          // the last tile's P, hi + "
        "lo bf16\n",
        "  uint32_t ph[4][4], pl[4][4];          // the last tile's P, hi + "
        "lo bf16\n  constexpr bool kQr = HD == 128 && kHeads == 1;\n"
        "  uint32_t qf[kQr ? HD / 16 : 1][4];\n"),
        "    mbar_wait(bar_q, 0);\n",
        "    mbar_wait(bar_q, 0);\n    if constexpr (kQr) {\n#pragma unroll\n"
        "      for (int kk = 0; kk < HD / 16; ++kk)\n"
        "        asm volatile(\"ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
        "{%0,%1,%2,%3}, [%4];\\n\"\n"
        "                     : \"=r\"(qf[kk][0]), \"=r\"(qf[kk][1]), "
        "\"=r\"(qf[kk][2]), \"=r\"(qf[kk][3])\n"
        "                     : \"r\"(Qw + wg_tile_off(warp * 16 + "
        "(lane & 15), 2 * kk + (lane >> 4))));\n    }\n"),
        "      wg_ss(s, wg_desc(Qw + at), wg_desc(Kt + at), kk > 0);\n",
        "      if constexpr (kQr)\n"
        "        asm volatile(\"{\\n.reg .pred p;\\nsetp.ne.b32 p, %37, "
        "0;\\n\"\n"
        "          \"wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "\" WG_D32\n"
        "          \", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\\n}\\n\"\n"
        "          : WG_D32_OPS(s)\n"
        "          : \"r\"(qf[kk][0]), \"r\"(qf[kk][1]), "
        "\"r\"(qf[kk][2]), \"r\"(qf[kk][3]),\n"
        "            \"l\"(wg_desc(Kt + at)), \"r\"(kk > 0 ? 1 : 0));\n"
        "      else\n"
        "        wg_ss(s, wg_desc(Qw + at), wg_desc(Kt + at), kk > 0);\n")
    wide = {
        "two_heads_a_cta_at_hd128": sub(
            src, "constexpr int kWide128Heads = 1;",
            "constexpr int kWide128Heads = 2;"),
        "q_in_registers_at_hd128": q_regs,
        # P's hi term rounded (split_bf16) rather than truncated
        "rounded_hi_split": in_rescale_split(
            src, split_lines,
            split_lines.replace("split_bf16_trunc(", "split_bf16(")),
        "skip_rescale_at_alpha_1": sub(
            src, "  auto rescale_split = [&](const float (&s)[32], "
                 "const float (&alpha)[2]) {\n",
            "  auto rescale_split = [&](const float (&s)[32], "
            "const float (&alpha)[2]) {\n    if (__any_sync(0xffffffffu, "
            "alpha[0] != 1.f || alpha[1] != 1.f))\n"),
        "4_byte_stores": src.replace(stores, direct),
    }
    # diagnostics, at every head dim: wrong results on purpose, to time the
    # kernel without one of its parts
    diags = {
        "diag_no_pv": in_region(src, WIDE, FP32, "pv(i - 1);",
                                "wg_commit();"),
        "diag_no_lo_term": sub(
            src, "#pragma unroll\n    for (int kk = 0; kk < 4; ++kk)\n"
                 "      wg_rs(o, pl[kk], wg_desc(Vt + kk * 2048, kWgTile));\n",
            ""),
        "diag_no_softmax": sub(
            src, "  auto softmax = [&](int i, float (&s)[32], "
                 "float (&alpha)[2]) {\n",
            "  auto softmax = [&](int i, float (&s)[32], "
            "float (&alpha)[2]) {\n    alpha[0] = alpha[1] = 1.f;\n"
            "    if (i >= 0) return;\n"),
        # K and V never copied after the first K tile (no wait for them):
        # the products and softmax run on stale tiles
        "diag_no_copies": sub(sub(
            src, "    __syncthreads();\n    if (threadIdx.x != 0) return;\n",
            "    __syncthreads();\n    if (i >= 0) return;\n"),
            "    if (i < n) mbar_wait(bar_k + 8 * (i & 1), (i >> 1) & 1);\n"
            "    if (i > 0) mbar_wait(",
            "    if (i == 0) mbar_wait(bar_k, 0);\n    if (i < 0) mbar_wait("),
    }
    # hd 64: the step as at hd 128 (QK^T_i with PV_{i-1}, softmax under PV),
    # other CTA counts an SM, and masked tiles by two bounds a row
    overlapped = lambda text: sub(sub(  # noqa: E731
        text, "    if constexpr (HD == 64) {", "    if constexpr (HD == 0) {"),
        "    if constexpr (HD != 64) refill(i);\n", "    refill(i);\n")
    ctas = lambda text, n: sub(  # noqa: E731
        text, "  return HD == 64 ? 4 :", f"  return HD == 64 ? {n} :")
    bounds = in_region(in_region(
        src, WIDE, FP32,
        "    const bool masked = tile_needs_mask(q0, k0, S, window);\n"
        "    float mx[2] = {-INFINITY, -INFINITY};\n",
        "    const bool masked = tile_needs_mask(q0, k0, S, window);\n"
        "    float mx[2] = {-INFINITY, -INFINITY};\n"
        "    int hi[2], lo[2];\n#pragma unroll\n"
        "    for (int r = 0; r < 2; ++r) {\n"
        "      const int diag = q0 - k0 + warp * 16 + g + 8 * r - 2 * t;\n"
        "      hi[r] = min(diag, S - 1 - k0 - 2 * t);\n"
        "      lo[r] = window > 0 ? diag - window : -(1 << 30);\n    }\n"),
        WIDE, FP32,
        "      if (masked && !visible(q0 + warp * 16 + g + ((e >> 1) & 1) * 8,"
        "\n                             k0 + (e >> 2) * 8 + 2 * t + (e & 1), "
        "S, window))\n",
        "      if (masked && ((e >> 2) * 8 + (e & 1) > hi[(e >> 1) & 1] ||\n"
        "                     (e >> 2) * 8 + (e & 1) <= lo[(e >> 1) & 1]))\n")
    # the next tiles' copies started before this step's products are issued
    early_copies = sub(sub(
        src, "    if constexpr (HD != 64) refill(i);\n", "    refill(i);\n"),
        "      qk(i, s);\n      refill(i);\n", "      qk(i, s);\n")
    # PV_{i-1} waited for before QK^T_i is issued
    serial = sub(
        early_copies, "      pv(i - 1);\n      qk(i, s);\n      wg_wait<0>();\n"
        "      wg_fence_regs(o);\n      wg_fence_regs(ph);\n"
        "      wg_fence_regs(pl);\n      wg_fence_regs(s);\n",
        "      pv(i - 1);\n      wg_wait<0>();\n      wg_fence_regs(o);\n"
        "      wg_fence_regs(ph);\n      wg_fence_regs(pl);\n      wg_fence();\n"
        "      qk(i, s);\n      wg_wait<0>();\n      wg_fence_regs(s);\n")
    hd64 = {
        "hd64_serial_issue": serial,
        "hd64_early_copies": early_copies,
        "overlapped_step_at_hd64": overlapped(src),
        "overlapped_step_at_hd64_3_ctas": ctas(overlapped(src), 3),
        "hd64_at_3_ctas": ctas(src, 3),
        "hd64_at_5_ctas": ctas(src, 5),
        "hd64_bounds_mask": bounds,
    }
    return {"as_committed": (src, (64, 128, 256)),
            **{n: (t, (128, 256)) for n, t in wide.items()},
            **{n: (t, (64, 128, 256)) for n, t in diags.items()},
            **{n: (t, (64,)) for n, t in hd64.items()}}


def checkout_variants(name, src):
    """name -> (flash_prefill.cu text, (64,)) for an earlier checkout's
    source ``src``: as it is and, where its hd-64 route is the `cp.async`
    kernel ``flash_prefill_wgmma_kernel``, that kernel's diagnostics
    (wrong results on purpose): no softmax, no lo term, no PV, no copies
    after the first K tile."""
    out = {f"{name}_as_committed": src}
    if "launch<bf16>(flash_prefill_wgmma_kernel" in src:
        start = "flash_prefill_wgmma_kernel(const"
        end = "// " + "=" * 49 + " bf16: wgmma, hd 128, 256"
        soft = src[src.index("    // softcap, mask; online softmax per row",
                             src.index(start)):
                   src.index("    // O += P V, P as hi + lo bf16 A fragments",
                             src.index(start))]
        lo = ("#pragma unroll\n    for (int kk = 0; kk < 4; ++kk) wg_rs(o, "
              "pl[kk], wg_desc(Vt + kk * 2048));\n")
        hi = lo.replace("pl[kk]", "ph[kk]")
        out.update({
            f"{name}_diag_no_softmax": in_region(src, start, end, soft, ""),
            f"{name}_diag_no_lo_term": in_region(src, start, end, lo, ""),
            f"{name}_diag_no_pv": in_region(src, start, end, hi + lo, ""),
            f"{name}_diag_no_copies": in_region(
                src, start, end, "    if (kt + 1 < kt_end) {             // "
                "prefetch the next key tile", "    if (false) {"),
        })
    return {n: (t, (64,)) for n, t in out.items()}


def decode_variants(src):
    """name -> decode_step.cuh text."""
    return {
        "as_committed": src,
        "diag_no_combine": sub(
            src, "  cluster_publish_and_combine<HD, kNt>(",
            "  if (split >= 0) return;\n"
            "  cluster_publish_and_combine<HD, kNt>("),
    }


PREFILL_KERNELS = ("flash_prefill_wide", "flash_prefill_pingpong",
                   "flash_prefill_wgmma")


def ptxas_lines(log, kernels):
    """ptxas's lines (registers, spills) for each entry of ``log`` whose
    mangled name holds one of ``kernels``."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = any(k in line for k in kernels)
            if keep:
                out.append(line.split("'")[1])
        elif keep and ("registers" in line or "spill" in line):
            out.append("    " + line.split(":", 1)[-1].strip())
    return out


def build(name, src_name, text, header=None, csrc=CSRC):
    """Start nvcc on ``text`` written as ``src_name`` into its own
    directory (with ``header``, a (name, text) pair, beside it: a quoted
    include finds it there before ``csrc``)."""
    from repro_torch.kernels import build as kb
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / src_name).write_text(text)
    if header is not None:
        (d / header[0]).write_text(header[1])
    cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-I", str(d), "-I", str(csrc), "-o",
           str(d / "lib.so"), str(d / src_name)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hd", type=int, action="append",
                    help="only the shapes of this head dim (repeatable)")
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="an earlier checkout (unpacked into a directory "
                         "whose name tags its rows) whose hd-64 route is "
                         "timed too, with the `cp.async` kernel's "
                         "diagnostics where that is its route; repeatable")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_variants: torch.cuda.is_available() is false")
    import chip_smoke as cs
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    cs.HBM_BYTES_PER_S, cs.PEAK_FLOPS["torch.bfloat16"] = cs.card_rates()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    shapes = [sh for sh in SHAPES if not args.hd or sh[3] in args.hd]
    hds = {sh[3] for sh in shapes}
    pre = {n: v for n, v in prefill_variants(
        (CSRC / "flash_prefill.cu").read_text()).items() if hds & set(v[1])}
    csrc = {n: CSRC for n in pre}
    for parent in args.parent if 64 in hds else ():
        pcsrc = parent / "src" / "repro_torch" / "kernels" / "csrc"
        par = checkout_variants(parent.name,
                                (pcsrc / "flash_prefill.cu").read_text())
        pre.update(par)
        csrc.update({n: pcsrc for n in par})
    dec = (decode_variants((CSRC / "decode_step.cuh").read_text())
           if any(sh[4] for sh in shapes) else {})
    step_cu = (CSRC / "flash_decode_step.cu").read_text()
    procs = {f"prefill/{n}": build(f"prefill_{n}", "flash_prefill.cu", t,
                                   csrc=csrc[n])
             for n, (t, _) in pre.items()}
    procs.update({f"decode/{n}": build(f"decode_{n}", "flash_decode_step.cu",
                                       step_cu, ("decode_step.cuh", t))
                  for n, t in dec.items()})
    libs = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            if n.endswith("/as_committed"):
                sys.exit(f"kernel_variants: {n} did not build:\n{log}")
            print(f"{n} did not build, left out:\n{log}", flush=True)
            continue
        if n.startswith("prefill/"):
            print(f"{n} ptxas:", *ptxas_lines(log, PREFILL_KERNELS),
                  sep="\n  ", flush=True)
        libs[n] = ctypes.CDLL(str(OUT / n.replace("/", "_") / "lib.so"))

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for tag, H, KV, HD, _ in shapes:
        make = lambda: (randn(B, S, H, HD), randn(B, S, KV, HD),  # noqa
                        randn(B, S, KV, HD))
        sets = cs.rotated(make(), make, ())
        want = fp.flash_prefill_plain(*sets[0]).float()
        for n, (_, at) in pre.items():
            if HD not in at or f"prefill/{n}" not in libs:
                continue
            f = libs[f"prefill/{n}"].flash_prefill_launch
            f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]

            def run(q, k, v, f=f, H=H, KV=KV, HD=HD):
                out = torch.empty_like(q)
                err = f(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), B, S, H, KV, HD, 0, 0.0, 1, stream())
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")
                return out
            e = (run(*sets[0]).float() - want).abs().max().item()
            t = [cs.device_ms(torch, run, sets) for _ in range(3)]
            print(f"prefill {tag} hd {HD} {n}: max_abs_err {e:.3e}, device "
                  f"ms {t}", flush=True)
        del sets

    for tag, H, KV, HD, splits_swept in shapes:
        if not splits_swept:
            continue
        G = H // KV
        mk = lambda: (randn(B, KV, G, HD), randn(B, KV, C, HD),  # noqa
                      randn(B, KV, C, HD), torch.zeros((B, C), device=dev))
        dsets = cs.rotated(mk(), mk, ())
        want = fd.flash_decode_plain(*dsets[0]).float()
        for n in dec:
            f = libs[f"decode/{n}"].flash_decode_step_launch
            f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            for splits in splits_swept:
                def run(q, k, v, bias, f=f, splits=splits, KV=KV, G=G,
                        HD=HD):
                    out = torch.empty_like(q)
                    err = f(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            bias.data_ptr(), out.data_ptr(), B, KV, G, C, HD,
                            splits, fd.STEP_TILE[HD], 0.0, 1, stream())
                    if err:
                        raise RuntimeError(f"launch failed: cudaError {err}")
                    return out
                e = (run(*dsets[0]).float() - want).abs().max().item()
                t = [cs.device_ms(torch, run, dsets) for _ in range(2)]
                print(f"decode {tag} hd {HD} {n} splits {splits}: "
                      f"max_abs_err {e:.3e}, device ms {t}", flush=True)
        del dsets


if __name__ == "__main__":
    main()
