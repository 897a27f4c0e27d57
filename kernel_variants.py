#!/usr/bin/env python3
"""Variants of the two hd-256 kernels, each built from this checkout's
sources with one text patch, timed on the card at gemma-2b's serve shapes
and held to the plain version: what the source notes of
``csrc/flash_prefill.cu`` and ``csrc/flash_decode_step.cu`` report as tried
and as diagnostics (a ``diag`` variant computes a wrong result on purpose,
to time the kernel without one of its parts).

    python3 kernel_variants.py        # from the repository root, one card

Device ms per call come from chip_smoke's ``device_ms`` (the profiler's
kernel time over inputs rotated through more than 3x the L2 size); the
prefill at B 8, S 512, 8 query heads on one KV head; the decode step at B
8, C 576, by split count. Prints one line a variant and the card's name and
power limit. Builds go to ``build/kernel_variants/`` (ignored by git).
"""
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "kernel_variants"
B, S, H, KV, HD, C = 8, 512, 8, 1, 256, 576
SPLITS = (8, 12, 16, 18, 24, 36)


def sub(text, old, new):
    if old not in text:
        raise SystemExit(f"kernel_variants: no patch target {old[:50]!r}")
    return text.replace(old, new)


def prefill_variants(src):
    """name -> flash_prefill.cu text."""
    loop = "    qk(i, s);\n    pv(i - 1);\n    refill(i);\n"
    fp32 = "// " + "=" * 60 + " fp32: CUDA cores"
    stores = src[src.index("  // O / l in bf16, staged"):src.index(fp32)]
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
    copies = src[src.index("  const int r = threadIdx.x / 32, c = "
                           "threadIdx.x % 32;\n  const uint32_t d = dst"):
                 src.index("// One CTA: two query heads of one KV head")]
    generic = """  for (int i = threadIdx.x; i < kBK * 32; i += kWideThreads) {
    const int r = i / 32, c = i % 32;
    const bool ok = r0 + r < S;
    cp_async16(dst + wg_tile_off(r, c),
               base + (size_t)(ok ? r0 + r : 0) * stride + c * 8, ok);
  }
}

"""
    return {
        "as_committed": src,
        "copies_before_products": sub(sub(
            src, loop, "    refill(i);\n    qk(i, s);\n    pv(i - 1);\n"),
            "    qk(0, s);\n    refill(0);\n",
            "    refill(0);\n    qk(0, s);\n"),
        "skip_rescale_at_alpha_1": sub(
            src, "  auto rescale_split = [&](const float (&s)[32], "
                 "const float (&alpha)[2]) {\n",
            "  auto rescale_split = [&](const float (&s)[32], "
            "const float (&alpha)[2]) {\n    if (__any_sync(0xffffffffu, "
            "alpha[0] != 1.f || alpha[1] != 1.f))\n"),
        "4_byte_stores": src.replace(stores, direct),
        "generic_copy_loop": src.replace(copies, generic),
        "diag_no_pv": sub(src, "    qk(i, s);\n    pv(i - 1);",
                          "    qk(i, s);\n    wg_commit();"),
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
        "diag_no_refill": sub(src, loop,
                              "    qk(i, s);\n    pv(i - 1);\n"
                              "    cp_async_commit();\n"),
        "diag_no_barrier": sub(
            src, "    asm volatile(\"fence.proxy.async.shared::cta;\\n\" "
                 "::: \"memory\");\n    __syncthreads();\n  };",
            "    asm volatile(\"fence.proxy.async.shared::cta;\\n\" "
            "::: \"memory\");\n  };"),
    }


def decode_variants(src, hdr):
    """name -> (flash_decode_step.cu text, wgmma.cuh text or None)."""
    return {
        "as_committed": (src, None),
        "diag_no_combine": (src, sub(hdr, "  if (!last) return;",
                                     "  return;")),
    }


def build(name, src_name, text, hdr):
    from repro_torch.kernels import build as kb
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / src_name).write_text(text)
    if hdr is not None:
        (d / "wgmma.cuh").write_text(hdr)
    cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-I", str(d), "-I", str(CSRC), "-o",
           str(d / "lib.so"), str(d / src_name)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def main():
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
    pre = prefill_variants((CSRC / "flash_prefill.cu").read_text())
    dec = decode_variants((CSRC / "flash_decode_step.cu").read_text(),
                          (CSRC / "wgmma.cuh").read_text())
    procs = {f"prefill/{n}": build(f"prefill_{n}", "flash_prefill.cu", t,
                                   None) for n, t in pre.items()}
    procs.update({f"decode/{n}": build(f"decode_{n}", "flash_decode_step.cu",
                                       t, h) for n, (t, h) in dec.items()})
    libs = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            sys.exit(f"kernel_variants: {n} did not build:\n{log}")
        libs[n] = ctypes.CDLL(str(OUT / n.replace("/", "_") / "lib.so"))

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    make = lambda: (randn(B, S, H, HD), randn(B, S, KV, HD),  # noqa: E731
                    randn(B, S, KV, HD))
    sets = cs.rotated(make(), make, ())
    want = fp.flash_prefill_plain(*sets[0]).float()
    for n in pre:
        f = libs[f"prefill/{n}"].flash_prefill_launch
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]

        def run(q, k, v, f=f):
            out = torch.empty_like(q)
            err = f(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, S, H, KV, HD, 0, 0.0, 1, stream())
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")
            return out
        e = (run(*sets[0]).float() - want).abs().max().item()
        t = [cs.device_ms(torch, run, sets) for _ in range(3)]
        print(f"prefill {n}: max_abs_err {e:.3e}, device ms {t}", flush=True)

    mk = lambda: (randn(B, KV, 8, HD), randn(B, KV, C, HD),  # noqa: E731
                  randn(B, KV, C, HD), torch.zeros((B, C), device=dev))
    dsets = cs.rotated(mk(), mk, ())
    want = fd.flash_decode_plain(*dsets[0]).float()
    part = torch.empty(B * KV * max(SPLITS) * (16 * HD + 32), device=dev)
    arrivals = torch.zeros(B * KV, dtype=torch.int32, device=dev)
    for n in dec:
        f = libs[f"decode/{n}"].flash_decode_step_launch
        f.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        for splits in SPLITS:
            def run(q, k, v, bias, f=f, splits=splits):
                out = torch.empty_like(q)
                err = f(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        bias.data_ptr(), out.data_ptr(), part.data_ptr(),
                        arrivals.data_ptr(), B, KV, 8, C, HD, 1, splits, 0.0,
                        1, stream())
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")
                return out
            e = (run(*dsets[0]).float() - want).abs().max().item()
            t = [cs.device_ms(torch, run, dsets) for _ in range(2)]
            print(f"decode {n} splits {splits}: max_abs_err {e:.3e}, "
                  f"device ms {t}", flush=True)


if __name__ == "__main__":
    main()
