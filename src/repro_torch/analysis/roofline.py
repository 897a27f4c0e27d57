"""Roofline analysis of a dry-run step: the port of
``repro.analysis.roofline``.

Three terms per (arch × shape × mesh), all *per device*:

    compute_s    = FLOPs / peak_FLOP/s
    memory_s     = bytes accessed / HBM_bw
    collective_s = collective_bytes / link_bw

``analyze`` takes the peak, the HBM rate and the link rate as keyword
arguments whose defaults are the reference's TPU v5e constants (kept
here for parity: 197 TFLOP/s bf16, 819 GB/s, ~50 GB/s a link ICI); the
port's dry run passes the H100's (``core.profiles.PEAK_FLOPS_BF16`` and
``HBM_BW``, and ``NVLINK_BW`` below). A term whose input was not measured
(``cost["bytes accessed"]`` None, or no HLO text and no collective
override) is None, and so is ``dominant``: a missing count is never
reported as a zero.

``collective_bytes`` parses XLA HLO text, as the reference does: it sums
the *result* sizes of every all-gather / all-reduce / reduce-scatter /
all-to-all / collective-permute (all-reduce counted twice: reduce+broadcast
phases each move the payload over the links in a ring schedule). The port
has no HLO; the function stays for parity with the reference's tests.

Also reported: MODEL_FLOPS = 6·N·D (train) or 2·N·D (inference fwd) with
N = (active) params, D = tokens — and the usefulness ratio
MODEL_FLOPS / (FLOPs × chips), which catches remat/redundancy waste.
"""
from __future__ import annotations

import re
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Tuple

# TPU v5e, per chip (the reference's target; the defaults of ``analyze``)
PEAK_FLOPS = 197e12       # bf16
HBM_BW = 819e9            # bytes/s
ICI_BW = 50e9             # bytes/s per link

# NVIDIA H100 SXM: NVLink 4, 900 GB/s per card to the other cards of the
# host, 450 GB/s each way (NVIDIA H100 Tensor Core GPU data sheet). The
# card's peak and HBM rate live in ``repro_torch.core.profiles``.
NVLINK_BW = 450e9         # bytes/s each way per card

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2,
    "f16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

_COLL_RE = re.compile(
    r"=\s+(?:\(([^)]*)\)|(\w+\[[\d,]*\][^\s]*))\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(")
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(typestr: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(typestr):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> Tuple[float, Dict[str, float]]:
    """Sum result sizes of collective ops in (per-device) HLO text."""
    per_kind: Dict[str, float] = {}
    seen_done = set()
    for m in _COLL_RE.finditer(hlo_text):
        tuple_part, single, kind = m.groups()
        typestr = tuple_part if tuple_part else single
        nbytes = _shape_bytes(typestr)
        # async pairs (-start/-done) would double count; -done result equals
        # -start's: count the op once by keying on position text
        factor = 2.0 if kind == "all-reduce" else 1.0
        per_kind[kind] = per_kind.get(kind, 0.0) + nbytes * factor
    # subtract double-counted async -done ops: count ratio of starts/dones
    starts = len(re.findall(r"(all-reduce|all-gather|reduce-scatter|"
                            r"all-to-all|collective-permute)-start", hlo_text))
    dones = len(re.findall(r"(all-reduce|all-gather|reduce-scatter|"
                           r"all-to-all|collective-permute)-done", hlo_text))
    total = sum(per_kind.values())
    if starts and dones:
        total *= 0.5  # each async collective appeared as start+done
        per_kind = {k: v * 0.5 for k, v in per_kind.items()}
    return total, per_kind


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_device: float
    hlo_bytes_per_device: Optional[float]
    collective_bytes_per_device: Optional[float]
    compute_s: float
    memory_s: Optional[float]
    collective_s: Optional[float]
    dominant: Optional[str]
    model_flops_global: float
    usefulness: float            # MODEL_FLOPS / (FLOPs · chips)
    collectives_by_kind: Dict[str, float] = field(default_factory=dict)
    memory_per_device_bytes: Optional[float] = None
    notes: str = ""

    def to_dict(self) -> Dict:
        return asdict(self)


def analyze(arch: str, shape_name: str, mesh_name: str, chips: int,
            cost: Dict, hlo_text: Optional[str], model_flops_global: float,
            memory_bytes: Optional[float] = None, notes: str = "",
            extra_flops: float = 0.0, extra_bytes: float = 0.0,
            collective_override: Optional[float] = None, *,
            peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
            link_bw: float = ICI_BW) -> RooflineReport:
    """The reference's ``analyze`` with the device's rates as keywords.
    ``cost["bytes accessed"]`` None leaves the memory term unmeasured;
    ``hlo_text`` None with no ``collective_override`` the collective one."""
    flops = float(cost.get("flops", 0.0)) + extra_flops
    raw_bytes = cost.get("bytes accessed", 0.0)
    byts = None if raw_bytes is None else float(raw_bytes) + extra_bytes
    coll, per_kind = (collective_bytes(hlo_text) if hlo_text is not None
                      else (None, {}))
    if collective_override is not None:
        coll = collective_override
    compute_s = flops / peak_flops
    memory_s = None if byts is None else byts / hbm_bw
    collective_s = None if coll is None else coll / link_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = (None if any(v is None for v in terms.values())
                else max(terms, key=terms.get))
    usefulness = (model_flops_global / (flops * chips)) if flops else 0.0
    return RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops_per_device=flops, hlo_bytes_per_device=byts,
        collective_bytes_per_device=coll, compute_s=compute_s,
        memory_s=memory_s, collective_s=collective_s, dominant=dominant,
        model_flops_global=model_flops_global, usefulness=usefulness,
        collectives_by_kind=per_kind, memory_per_device_bytes=memory_bytes,
        notes=notes)


def scan_corrections(cfg, shape, *, batch_shard: int, model_shard: int,
                     heads_sharded: bool) -> Tuple[float, float, str]:
    """Exact analytic correction for inner lax.scan loops whose body XLA's
    cost analysis counts once (layers are unrolled in the dry-run; the only
    scanned loops left are the q-block flash attention and the SSD chunk
    recurrence). Returns (flops, bytes) PER DEVICE to add, + a note.

    Closed forms (per layer, forward, global):
      attention q-block scan (trips nq = S/bq):
        matmul  4·B·S²·H·hd      (scores + PV over full-S blocks)
        softmax ~8·B·H·S²        (mask/max/exp/sum/div elementwise)
        bytes   nq·(2·2·B·S·KV·hd)  (K/V re-read per block)
                + 3·4·B·H·bq·S·nq   (score buffer traffic, f32)
      SSD chunk scan (trips c = S/chunk):
        matmuls 2·B·S·chunk·h·p + 4·B·S·h·p·n (+ q²-decay elementwise ~4·B·S·chunk·h)
        bytes   ~B·S·(chunk·h + 2·h·p)·4
    Training multiplies by 4 (fwd + remat-replay + 2·bwd); prefill by 1.
    The scanned body was counted once, so we add (trips-1)/trips of the total.

    The port's dry run counts its step's operations with PyTorch's
    ``FlopCounterMode`` over Python loops that run every layer and q-block,
    so it adds no correction; this stays for parity with the reference.
    """
    from repro_torch.models.attention import FLASH_JNP_BQ, FLASH_JNP_THRESHOLD
    if shape.kind == "decode":
        return 0.0, 0.0, ""
    B, S = shape.global_batch, shape.seq_len
    mult = 4.0 if shape.kind == "train" else 1.0
    flops = 0.0
    byts = 0.0
    notes = []
    L = cfg.num_layers
    if cfg.num_heads and S > FLASH_JNP_THRESHOLD:
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        bq = FLASH_JNP_BQ
        nq = -(-S // bq)
        f = 4.0 * B * S * S * H * hd + 8.0 * B * H * S * S
        by = nq * (4.0 * B * S * KV * hd) + 3.0 * 4.0 * B * H * bq * S * nq
        scale = (nq - 1.0) / nq * mult * L / batch_shard
        if heads_sharded:
            scale /= model_shard
        flops += f * scale
        byts += by * scale
        notes.append(f"attn qblock scan x{nq}")
    if cfg.family in ("ssm", "hybrid") and cfg.ssm_state:
        h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        ch = min(cfg.ssd_chunk, S)
        c = -(-S // ch)
        f = 2.0 * B * S * ch * h * p + 4.0 * B * S * h * p * n + 4.0 * B * S * ch * h
        by = 4.0 * B * S * (ch * h + 2 * h * p)
        scale = (c - 1.0) / max(c, 1) * mult * L / batch_shard
        flops += f * scale
        byts += by * scale
        notes.append(f"ssd chunk scan x{c}")
    return flops, byts, "; ".join(notes)


def analytic_hbm_bytes(cfg, shape, *, param_bytes_global: float,
                       model_shard: int, batch_shard: int,
                       fsdp_shard: int = 1, train: bool,
                       microbatches: int = 1) -> float:
    """Closed-form per-device HBM estimate (the reference's model, which
    the port's dry run holds against an H100's 80 GB). Terms: sharded
    params (+grads+Adam moments fp32 for training), remat-saved layer
    inputs, the fp32 logits pipeline (~3 live copies), and one layer's
    transient working set (flash blocks / FFN activations).
    """
    B, S = shape.global_batch, shape.seq_len
    D, L, Vp = cfg.d_model, cfg.num_layers, cfg.padded_vocab
    shards = model_shard * fsdp_shard
    mem = param_bytes_global / shards
    if train:
        mem += param_bytes_global / shards          # grads
        mem += 2 * 4 * (param_bytes_global / 4) / shards  # Adam mu+nu fp32
    B_loc = B / batch_shard
    if shape.kind == "train":
        B_mb = B_loc / microbatches             # grad-accumulation slices
        mem += L * B_mb * S * D * 2             # remat layer inputs (bf16)
        mem += 3 * 4 * B_mb * S * (Vp / model_shard)    # fp32 logits pipeline
        mem += 2 * 4 * B_mb * 512 * S * max(cfg.num_heads, 1) / model_shard
        mem += 2 * B_mb * S * max(cfg.d_ff, D) / max(model_shard, 1) * 4
        if microbatches > 1:
            mem += param_bytes_global / (model_shard * fsdp_shard)  # grad acc
    elif shape.kind == "prefill":
        mem += 2 * B_loc * S * D * 2                # activations in flight
        mem += 3 * 4 * B_loc * (Vp / model_shard)   # last-token logits only
        # KV cache being built
        mem += 2 * L * B_loc * min(S, cfg.sliding_window or S) \
            * max(cfg.num_kv_heads, 1) * cfg.resolved_head_dim * 2 / model_shard
    else:  # decode
        C = min(S, cfg.sliding_window or S)
        if cfg.family != "ssm":
            mem += 2 * L * B_loc * C * max(cfg.num_kv_heads, 1) \
                * cfg.resolved_head_dim * 2 / model_shard
        if cfg.family in ("ssm", "hybrid"):
            mem += L * B_loc * cfg.ssm_heads * cfg.ssm_head_dim \
                * cfg.ssm_state * 4
        mem += 3 * 4 * B_loc * (Vp / model_shard)
    return float(mem)


def model_flops(cfg, shape) -> float:
    """6·N·D for training, 2·N_active·D for inference forward passes."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch   # one decoded token per sequence
