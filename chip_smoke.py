#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Drives ``repro_torch`` (never the JAX package) phase by phase; any failing
phase raises, and the script exits nonzero:

  1. device   card name and power limit (nvidia-smi), torch/CUDA versions;
  2. build    nvcc builds every kernel from ``src/repro_torch/kernels/csrc``
              (one nvcc per source, all started together);
  3. kernels  each CUDA kernel against its plain PyTorch version at the
              serve path's shapes (bf16 and fp32) and on small edge cases
              (window, softcap, ragged lengths; for flash_prefill S around
              the 16-row warp and 64-row tile edges and at 128 and 255, G 3
              and G 1, a window of one tile and one crossing a tile edge,
              hd 128; for flash_decode C = 1,
              C below the split count, splits wholly under the -1e9 bias,
              C not a multiple of the splits; hymba-1.5b's GQA group of 5
              with a window that binds; for paged decode: page 8 and hd 128,
              softcap, a table slice narrower than the table, length-0 rows
              and NaN pages past every row's length; for the SSD scan:
              mamba2-130m's and hymba-1.5b's heads with a nonzero initial
              state, through the strided views the model passes, and a
              ragged last chunk, and its narrowest widths p 16 / n 8 at the
              reference's kernel-test shape (2, 64, 2, 16, 8; q 32) and
              ragged (2, 45, 3, 16, 8; q 16), each with its device ms
              beside its bound on an edge line; for flash_decode's chunk
              form, the dense
              fused tick's shape B 8, ck 16, C 576 and softcap, C below the
              split count, hymba-1.5b's group of 5, hd 128, ragged starts
              with an inert row, queries that see only the first key, and
              the tensor-core route's edges in bf16 at hd 64 and 256: C
              below its splits, C not a multiple of 64, more tiles than
              splits, G 7 and G 1; for the paged chunk form also hd 256
              at page 8 with a softcap;
              both chunk forms at a speculative round's shapes: the verify
              at ck 5 over C 576 / 36 pages, the drafter's resync at ck 1
              over its 582-slot ring / 37 pages), with stated tolerances;
              then kernel /
              plain / library (SDPA, a yardstick the port never calls; for
              the chunk form SDPA with a (B, H, ck, C) float mask; none
              for paged decode and the SSD scan, timed at mamba2-130m's and
              hymba-1.5b's heads) times from CUDA events,
              inputs rotated through more than the 50 MB L2 cache (``ms``:
              back-to-back calls, so host-side launch cost counts where it
              exceeds the device time), and device time alone from
              ``torch.profiler`` (``device_ms``), beside the bound (bytes or
              operations over the card's peak rates); flash_prefill and
              flash_decode in fp32 as well as bf16, flash_prefill's kernel
              as the profiler sees it held to its plan, and flash_prefill
              at hymba-1.5b's heads with its window of 256 beside SDPA
              with the boolean mask;
  4. model    full-width tinyllama-1.1b (22 layers, bf16): prefill of 8 x 512
              tokens plus 8 decode steps with the kernels on and off, and
              the same 8 steps through the page pool (``paged_admit`` +
              ``decode_step_paged``) against the dense steps, logits held to
              a stated tolerance; full-width 4-layer fp32 rungs must give
              identical greedy tokens kernels on vs off and paged vs dense;
              then the same prefill and decode steps, kernels on vs off, for
              full-width mamba2-130m (24 layers, bf16; a 4-layer fp32 rung
              must give identical greedy tokens) and hymba-1.5b (32 layers,
              bf16: ssd_scan beside flash_prefill / flash_decode with GQA
              group 5 and per-layer windows);
  5. graphs   the engine's steps replayed as CUDA graphs against the same
              steps run op by op (``step_graphs=False``), at full width on
              shared weights: tinyllama-1.1b L22 dense (decode step) and
              paged with prefix sharing (fused tick with every row
              prefilling, paged decode step), dense with the chunked
              machinery (the dense fused tick, rows finishing their
              prefill at different ticks and then decoding in it: one
              flash_decode_chunk launch per layer per tick, 22, where the
              reference's per-token route makes 352), mamba2-130m L24
              (prefill, decode step), hymba-1.5b L32 (decode step); tokens
              and every cache leaf bitwise equal, port kernel launches per
              step equal; wall ms, stream span (CUDA events), device ms and
              kernels per step for both paths, and each backend's
              readiness (captures included);
  6. serve    the InfAdapter loop (``launch.serve``: full-width ladder
              8/15/22 layers, calibrate, ``run_serving_loop`` with the
              controller) on the dense engine, then on the paged engine with
              prefix sharing (``kv_cache="paged"``, page 16; the paged
              backend has no pump path, so it runs on the profiles
              calibrated on the dense engine of the same ladder and
              geometry), then on the dense engine over the full-width
              mamba2-130m ladder 8/16/24, every step replayed as a CUDA
              graph (the engine's default) and the readiness of every
              variant load printed; every request completes with its
              full budget, every pool ends empty and consistent, and each
              path's kernels' launch counters (replays add their captured
              launches) grow in its own phase; P99, violation rate and
              goodput are printed only over TAIL_MIN_REQUESTS requests
              (a short loop is a path smoke);
  7. prefix   the shared-system-prompt study at full width: 24 staggered
              512-token requests over a 384-token shared prefix, every
              fourth an exact repeat (copy-on-write), sharing on vs off:
              prefix hits, CoW copies and fewer prefilled tokens with
              sharing on; paged_decode launches per tick must be one per
              layer in a fused tick (the chunk form) and one per layer per
              step in a decode tick; bf16 token agreement printed; a
              4-layer fp32 rung must give identical tokens on vs off;
  8. async    the dispatch/commit tick at full width on shared weights
              (tinyllama-1.1b L22, fp32, kernels on, steps replayed): one
              fixed list of 12 staggered 512-token requests (half over a
              shared prefix, tight deadlines on half) on a fake clock,
              through the dense engine and the paged engine with prefix
              sharing, each as sync and async FIFO and as sync and async
              ``chunked`` + ``preemption="requeue"``: sync and async
              outputs bitwise equal, every request complete, every pool
              empty and consistent, preemption fired; wall ms per tick,
              hidden host ms and commit_wait_ms printed sync against
              async; a 4-layer fp32 rung, chunked dense against monolithic
              dense, identical greedy tokens; then a 10 s serve loop of the
              InfAdapter loop (phase 6) on the dense ladder with
              ``async_tick=True, scheduler="chunked",
              preemption="requeue"``;
  9. spec     speculative decoding (``spec_k=4``) at full width on shared
              weights, steps replayed: a 4-layer fp32 rung drafted by a
              2-layer rung and by a twin, dense and paged with sharing,
              FIFO sync and async and ``chunked`` async: speculative
              output equal to target-only, pools (the drafter mirror's
              included) empty; L22 bf16 drafted by the L8 rung and by an
              L22 twin, dense and paged: replay equal to eager bitwise in
              tokens and every cache leaf, 22 + L_d chunk-form and 4 x L_d
              decode-form launches every round after the first (verify,
              resync, drafts), per round wall ms, tokens per verifier step
              and acceptance, device ms of one round, ms per committed
              token against target-only, agreement with target-only
              printed; then a 10 s serve loop of the InfAdapter loop
              (phase 6) on the dense ladder with
              ``speculative="tinyllama-1.1b-L8:tinyllama-1.1b-L22"``;
 10. obs      observability on the engine at full width (tinyllama-1.1b
              L22, bf16, kernels on, steps replayed): the async phase's
              request list on a fake clock through dense FIFO with the
              sync tick and paged with sharing + ``chunked`` + requeue +
              the async tick, each with observability off
              (``Observability.disabled()``) and traced (spans, ticks,
              windows, a flight recorder, ``profile_dispatch=2``): tokens
              bitwise equal, every kernel's launches equal (tracing adds
              no kernel to a replayed tick), a valid Chrome trace with no
              dropped span or tick, every request's spans monotone from
              QUEUED to a terminal event, sampled ticks split into
              dispatch + device + host sync within exec_ms and unsampled
              ticks NaN; the dispatch floor summary and wall ms per tick
              traced and untraced printed; then 10 s of the launcher's own
              ``--trace --profile-dispatch --burn-rate-alerts
              --flight-dir`` serve (``launch.serve.serve``) at an SLO the
              ladder cannot meet: an alert fires, the controller re-solves
              for it (reason ``burn_rate``), a flight dump and the trace,
              metrics and audit reports validate with zero drops;
 11. profile  the paper's Profiler (``repro_torch.profiling``) at full
              width: ``EngineProfiler`` sweeps the dense tinyllama-1.1b
              L8/L15/L22 ladder and a paged L22 at the serve geometry
              (sync FIFO, kernels on, steps replayed) at 1, 2, 4 and 8
              slots, 16 requests a point after 4, each on a throwaway
              backend that must be closed after it; per rung every point,
              both fits with R², readiness, the serve phase's
              ``calibrate()`` profile, the H100 ``roofline_profile`` and
              ``roofline_scale_factor``; th(8) > th(1) and R² in [0, 1]
              asserted; the store saved and reloaded equal; drift on the
              live L8 rung at 2 units: a healthy check in band, then a host
              stall of 5 mean chunk times ahead of every decode chunk
              flagged, ``OnlineRecalibrator`` re-profiles it, throughput(1)
              falls and the controller provisions more units for the same
              load;
 12. fabric   the replica fabric (``repro_torch.cluster`` on the engine's
              ``nodes=``) at full width: tinyllama-1.1b L8 and L22, bf16,
              kernels on, steps replayed, on two nodes of four units
              (spread placement, p2c routing), each replica its own seeded
              weights: {L8: 2, L22: 2} on the dense engine, then on the
              paged engine with prefix sharing, serving FAB_N requests of
              512 + 64 tokens on a fake clock, half to each rung, node0
              crashed at a fixed tick: every request completes once, none
              rejected, each on its own rung's replicas through the retry,
              capacity_factor 0.5, memory_allocated down by at least 90% of
              the killed replicas' weights and KV; the allocation
              re-applied: capacity_factor 1.0, every replica on node1;
              memory and readiness printed per load; tokens held against
              one plain backend per rung (equal in bf16, or else the same
              on 2- and 4-layer fp32 rungs must be); paged pools empty and
              consistent and
              ``kv_pool_stats`` summed over the live replicas; then
              {L22: 2} with one replica slowed FAB_SLOW-fold under a steady
              stream (decode commits at least 2.5x its twin's, p2c's split
              printed) and restored; then FAB_SERVE_SECONDS of the
              launcher's ``--replicas 4 --nodes 2 --fail-node-at
              --flight-dir`` serve: every request completes once, the
              crash's flight dump validates, the next decision sees the
              crash and capacity_factor returns to 1.0 (the time printed);
 13. eval     the paper's evaluation at full width (tinyllama-1.1b
              L8/L15/L22, bf16, kernels on, steps replayed) on the profile
              phase's measured dense profiles: (a) InfAdapter, MS+, VPA+ (on
              L22), INFaaS and Cocktail, each driving a fresh dense FIFO
              engine through ``run_serving_loop`` for EVAL_SECONDS of the
              bursty trace from EVAL_T0 (the spike's onset), scaled so that
              its base is EVAL_BASE_SHARE of L22's capacity at EVAL_BUDGET
              units and its spike lies between L22's and L8's (the scale
              printed): every submission completes once with its full
              budget or is counted as rejected, every controller leaves its
              decisions, Cocktail's requests land only on its ensembles'
              members (one member a request: the loop has no fan-out),
              flash_prefill and flash_decode launch, each engine closed
              after its run; decisions, served, rejected, cost and
              accuracy loss printed, P99, violation rate and goodput over
              TAIL_MIN_REQUESTS; (b) ``launch.replay_trace --engine
              --engine-seconds EVAL_REPLAY_SECONDS
              --full-width`` in process (the simulated panels, then the
              trace on a ``chunked`` engine: flash_decode's chunk form
              launches); (c) ``run_experiment`` of the five controllers on
              ``SimCluster`` over the same measured profiles, the trace
              scaled as ``launch.llm_autoscale`` scales it, printed beside
              (a)'s engine numbers;
 14. dense    the other dense configs: every attention kernel at
              gemma-2b's hd 256 (8 query heads on one KV head; flash_prefill
              at B 8, S 512; flash_decode's decode step at C 576 and its
              chunk form at ck 16; paged decode and its chunk form over 36
              pages of 16, also with NaN pages past every length) and
              flash_prefill at hd 32 with a window, against the plain
              versions in bf16 and fp32, then timed beside SDPA and the
              bound, with the kernel the profiler sees launched asserted to
              be the planned one (at hd 256 in bf16 flash_prefill's
              two-head ``wgmma`` kernel and the decode step's tensor-core
              kernel); flash_prefill and the decode step at hd 256 on their
              routes' edges (S 1, 63, 65, 129, G 3 and 7; C 1, C around the
              step's split count, only the first key unbiased, G 3 and 7,
              several tiles a split); gemma-2b L18 at full width (bf16:
              GeGLU, MQA, the tied
              256000 x 2048 table) kernels on vs off, dense and paged, 18
              launches per prefill and per step asserted, wall and device
              ms, and a 2-layer fp32 rung with identical greedy tokens; its
              steps replayed vs eager on the L6 rung (dense, paged +
              sharing, dense chunked), launches per step asserted; the
              gemma-2b 6/12/18
              ladder through the InfAdapter loop (dense FIFO, paged +
              sharing and ``chunked``, 6 s each; served, rejected,
              launches, memory_allocated after close); both chunk forms
              at yi-6b's fused tick (hd 128: 32 query heads on 4 KV
              heads), against the plain versions, timed beside SDPA and
              the bound; yi-6b L32 kernels on vs off at model level;
              ``python -m repro_torch.launch.llm_autoscale`` at its
              default (yi-6b), run alongside in a subprocess;
 15. moe      the MoE family: granite-moe-3b-a800m (40 experts, top 8;
              24 query heads on 8 KV heads of hd 64) at full width, bf16:
              ``apply_moe`` in fp32 on the card against the CPU, a decode
              step's 8 tokens (dropless, also against the dense oracle)
              and a prefill's 8 x 512 at capacity factor 1.0 (experts
              overflow: slot 0 of each overflowing expert reads zero);
              every attention kernel at its GQA group of 3 against its
              plain version in bf16 and fp32, timed beside SDPA and the
              bound; L32 kernels on vs off (prefill, decode steps, paged
              steps, both fused ticks), 32 launches per prefill, step and
              fused tick asserted, the logits held to twice what the
              kernels-off path moves under a 1e-3 perturbation of its
              embedding (a deep random MoE reroutes tokens after any bf16
              rounding), a 2-layer fp32 rung with identical greedy
              tokens; the device split of an L32 decode step and
              prefill (attention kernels, expert products, dispatch, the
              rest) beside its bound; its steps replayed vs eager with
              launches per step asserted on the ladder's L8 rung
              (GRAPH_DEPTH); the 8/16/32 ladder through the
              InfAdapter loop (dense FIFO, paged + sharing, ``chunked``,
              6 s each; none rejected), ``memory_allocated`` per load and,
              after each close and a collection, back at the loop's start
              within CLOSE_MARGIN (every closing loop of phase 14 too);
 16. train    the training path (no kernel of the port: it runs with
              ``use_kernels`` off, and the kernels refuse autograd; the
              phase asserts none launched): tinyllama-1.1b at full width
              (22 layers, bf16 compute, fp32 params and Adam moments,
              remat) on B 8 x S 512 synthetic-token batches: 3 warm-up and
              10 timed steps at TRAIN_ADAM (ms a step, tokens/s, peak
              memory, the FLOPs share of the bf16 dense peak by the hand
              count, and beside it the dry run's ``FlopCounterMode`` count
              of the same step on meta and ``roofline.model_flops``), the
              peaks
              with remat off, one step's device split (matrix products,
              elementwise, cross-entropy, Adam; the top kernels), 60
              steps at the tiny-LM example's optimizer (its 512-token
              vocabulary) held to its "learned" criterion; resume from a
              checkpoint bitwise; at 2 layers in fp32 one train step card
              = CPU and microbatches 2 = 1; the paper's LSTM for 30 of
              the example's 300 steps (loss falls, a CPU twin's first 20
              losses, one
              step's kernels and busy share, MAE and under-prediction of
              LSTM, MovingMax and their ensemble), then the InfAdapter
              loop with it as the forecaster for 6 s on the dense
              full-width ladder (served, rejected, decisions);
 18. whisper  the encoder-decoder family: whisper-tiny at its
              published size (4 + 4 layers, d_model 384, 6 heads of hd 64
              on 6 KV heads: G 1, 1500 frames); every attention kernel at
              its heads against its plain version in bf16 and fp32, timed
              beside SDPA and the bound; B 8 x 64 decoder tokens after
              seeded frames and 64 decode steps, bf16, kernels on vs off,
              4 flash_prefill launches a prefill, 4 flash_decode launches
              a step and none in the encoder asserted; ms of encode,
              prefill and a decode step, and the share of a step that
              projects the cached encoder output to K and V again (the
              reference's arithmetic); fp32 with the kernels on, card
              against the CPU (B 2, 8 steps);
 19. vlm      the VLM family: internvl2-26b (48 query heads on 8 KV heads
              of hd 128: G 6) at full width; every attention kernel at its
              heads against its plain version, timed beside SDPA and the
              bound; flash_prefill's pipelined ``wgmma`` route and the
              tensor-core decode step on their hd-128 edges (as at hd 256
              in phase 14); L48 (39.7 GB of bf16 weights drawn on the
              card, the time printed) kernels on vs off with a 256-token
              image prefix before the 512-token prompt, the logits held as
              the MoE phase holds them, 48 launches a prefill, a step and a
              fused tick asserted, peak memory printed; its steps replayed
              vs eager at GRAPH_DEPTH layers; its 8/16/48 ladder served
              text-only (as the reference's engine serves it) through the
              InfAdapter loop, dense FIFO, paged + sharing and
              ``chunked``, 6 s each, every close back at its start;
 20. resnet   the paper's ResNet family (cuDNN convolutions, no port
              kernel; none may launch) at 224 x 224 in fp32, TF32 off:
              each variant's logits card vs CPU at B 2, then ms, images/s
              and the share of the fp32 peak that ``resnet_flops`` counts
              at B 1, 8 and 32. Phases 18-20 run between 15 and 16.
 21. dryrun   the production-mesh dry run as a user runs it: ``python -m
              repro_torch.launch.dryrun --arch tinyllama-1.1b --shape all
              --both-meshes`` in a subprocess (meta tensors on the
              16x16 and 2x16x16 geometries; it must exit 0), each
              pair's per-device bytes, counted FLOPs and usefulness printed
              on its own line; after 16.
 17. output   ``memory_allocated`` at the end and the part of it that is
              cuBLAS's per-stream workspaces (dropped once nothing replays
              again); the ``{"kernels": [...]}`` line (launches summed over the
              serve loops, the prefix phase, the obs phase's serve, the
              profile, fabric and eval phases, the gemma-2b, the
              granite and the internvl2-26b loops, the LSTM-driven loop;
              the chunk forms' rows carry their verify
              shape's times, and every attention kernel's row its gemma-2b
              and granite times under ``gemma_*`` and ``granite_*`` keys,
              whisper-tiny's and internvl2-26b's under ``whisper_*`` and
              ``internvl_*``
              (with ``gemma_kernel``, the kernel each launched, and
              ``gemma_launches``, its launches in the gemma-2b loops),
              the chunk forms' rows their yi-6b times under ``yi_*``,
              flash_prefill's its hd-32 times under ``hd32_*``), then the
              ok line last.

The SSD scan's outputs grow with the sequence, so it is held to a relative
tolerance (``SSD_REL_TOL``: max |kernel - plain| / max |plain|) where the
attention kernels take the absolute ``TOL``.

Usage: ``python3 chip_smoke.py`` from the repository root (one card);
``python3 chip_smoke.py --phases whisper,vlm,resnet`` builds the kernels
and runs only the named ones of phases 3 (``kernels``), 18-20 and 21
(``dryrun``), with no result line.
``python3 chip_smoke.py --ab <checkout>/src`` instead holds and times only
flash_prefill and flash_decode of that checkout (event and device times,
SDPA beside them, bf16 and fp32), flash_decode's chunk form where the
checkout has it (the dense fused tick's shape, SDPA with a float mask
beside it; on the tensor-core route also its device time by split
count), both chunk forms at gemma-2b's, yi-6b's and granite's fused
ticks with the route the checkout picks (at hd 128 and 256, where the
checkout takes the split count by head dim, its sweep), flash_prefill and
the decode step in bf16 at gemma-2b's, internvl2-26b's and granite's
serve shapes with the kernel each launches (at each decode step the split
sweep of the checkout's tensor-core step route, where it plans one, and
the chunk kernel called with ck 1 as a yardstick), paged_decode (the
decode step's call, and one layer of the fused tick's
``paged_chunk_prefill_attention`` with
the paged kernels' device time inside it) and ssd_scan (mamba2-130m's and
hymba-1.5b's serve shapes, bf16, strided views, nonzero initial state,
held to the plain version) and prints one JSON line, so a parent and a
change compare in one call: unpack the parent with ``git archive <commit>
| tar -x -C build/parent`` and run parent, change, change, parent.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the card's HBM rate and dense bf16 peak are read from the port's one home
# for the H100 constants, ``repro_torch.core.profiles`` (``card_rates``, in
# ``main``); the fp32 peak (H100 SXM data sheet, no tensor cores) is local
HBM_BYTES_PER_S = None
PEAK_FLOPS = {"torch.float32": 67e12}
TOL = {"torch.float32": 1e-5, "torch.bfloat16": 1e-2}
# ssd_scan, relative to max |plain|: fp32 sums in other orders over 128-step
# chunks; bf16 y is one rounding of the same fp32 value (2^-8); the final
# state is fp32 in both dtypes
SSD_REL_TOL = {"torch.float32": 1e-4, "torch.bfloat16": 1e-2}
L2_BYTES = 50e6

# serve path geometry (launch.serve GEOMETRY[True]) and model widths
B, PROMPT, MAX_NEW, CHUNK = 8, 512, 64, 8
H, KV, HD = 32, 4, 64
CAP = PROMPT + MAX_NEW
PAGE = 16
WIDTH = CAP // PAGE         # block-table width: 36 pages per slot
CK = 16                     # the engine's prefill chunk: tokens per fused tick
BF16_LOGIT_TOL = 5e-2       # ||on - off|| / ||off|| over the logits, bf16
FP32_LOGIT_TOL = 1e-4       # the same in fp32: sums in other orders only
BF16_VS_PLAIN = 1.1         # bf16 kernels' distance from the fp32 logits,
#                             at most this times the plain bf16 path's
EMBED_NOISE = 1e-3          # a perturbation under one bf16 rounding (2^-8)
SSD_CHUNK = 128
# (h, p, n) of the SSD scan at the serve shape: mamba2-130m, hymba-1.5b
SSD_HEADS = {"mamba2-130m": (24, 64, 128), "hymba-1.5b": (50, 64, 16)}
# the SSD scan's narrowest widths, p 16 / n 8 (no config runs them): the
# reference's own kernel test's shape and a ragged last chunk,
# (b, s, h, p, n, chunk)
SSD_NARROW = ((2, 64, 2, 16, 8, 32), (2, 45, 3, 16, 8, 16))
HYMBA_H, HYMBA_KV = 25, 5   # hymba-1.5b attention heads: GQA group 5
HYMBA_WINDOW = 256          # its sliding window
# each of the dense and the paged tinyllama serve loops and the mamba2
# loop (20 s until the script neared its time limit)
SERVE_SECONDS = 10
# prefix phase: the reference's shared-system-prompt study at full width
PS_N, PS_SHARED = 24, 384
AS_N = 12                   # async phase: requests in its fixed list
ASYNC_SERVE_SECONDS = 10    # the async + chunked + requeue serve loop
SPEC_K = 4                  # spec phase: drafts a round
SPEC_CAP = CAP + SPEC_K + 2  # the drafter's ring: the headroom of k + 2
SPEC_SERVE_SECONDS = 10     # the speculative serve loop
OBS_SERVE_SECONDS = 10      # the obs phase's traced serve loop
# the obs phase's serve: an SLO no rung meets (a request spends >= 9 ticks
# of the loop's 50 ms sleep) but the profiles call feasible, so the
# controller allocates and every completion burns the error budget; the
# load keeps the burn monitor's 5 s window above its 5 requests
OBS_SLO_MS = 300.0
OBS_LOAD = (2.0, 4.0)
# profile phase: EngineProfiler at the reference's defaults, and the drift
# check's requests per stage and stall (in measured mean chunk times)
PROF_POINTS, PROF_RPP, PROF_WARMUP = (1, 2, 4, 8), 16, 4
DRIFT_N = 12
DRIFT_STALL_X = 5
# fabric phase: requests in its fixed list (half to each rung), the tick
# at which node0 crashes, the straggler's stream and slow factor, and the
# launcher's crash-and-recover serve (crash FAB_FAIL_AT s in)
FAB_N, FAB_CRASH_TICK = 32, 6
FAB_STRAGGLER_N, FAB_SLOW = 24, 3.0
FAB_SERVE_SECONDS, FAB_FAIL_AT = 15, 5.0
# eval phase: the five controllers' serve loops on a window of the bursty
# trace from EVAL_T0 (the spike starts at 600 s), at EVAL_BUDGET units and
# EVAL_SLO_MS; the trace is scaled so that its base (EVAL_BASE req/s) is
# EVAL_BASE_SHARE of what the L22 rung sustains at the full budget
EVAL_SECONDS, EVAL_INTERVAL = 20, 5.0
EVAL_REPLAY_SECONDS = 6     # the replay launcher's engine run
EVAL_T0, EVAL_BASE, EVAL_BASE_SHARE = 595, 40.0, 0.5
EVAL_BUDGET, EVAL_SLO_MS = 3, 2000.0
EVAL_CONTROLLERS = ("InfAdapter", "MS+", "VPA+", "INFaaS", "Cocktail")
# A serve loop reports its P99, violation rate and goodput only over this
# many requests: over the 10-30 a short loop serves, the P99 is the slowest
# request and one request moves the rate by several points. Short loops
# are path smokes (completions, preemptions, launches).
TAIL_MIN_REQUESTS = 100
# dense-config phase: gemma-2b's attention heads (8 query heads on one KV
# head of hd 256), the serve loop of its paged and chunked engines (the
# side loops of phases 14, 15, 19 and 16 run 6 s: path smokes, so that
# the whole script keeps room under a chip run's 1200 s)
GEMMA = "gemma-2b"
GEMMA_H, GEMMA_KV, GEMMA_HD = 8, 1, 256
GEMMA_SIDE_SECONDS = 6
GEMMA_GRAPH_DEPTH = 6       # replay vs eager on the ladder's first rung
# yi-6b's attention heads (32 query heads on 4 KV heads of hd 128): the
# chunk forms' hd-128 tensor-core instance at its fused tick
YI = "yi-6b"
YI_H, YI_KV, YI_HD = 32, 4, 128
# MoE phase: granite-moe-3b-a800m's attention heads (24 query heads on 8 KV
# heads of hd 64: GQA group 3), its serve loops' length, and apply_moe's
# tolerance card vs CPU in fp32 (max |card - CPU| / max |CPU|: sums over
# 1536 and 512 terms in other orders)
GRANITE = "granite-moe-3b-a800m"
GRANITE_H, GRANITE_KV, GRANITE_HD = 24, 8, 64
MOE_SERVE_SECONDS = 6
MOE_REL_TOL = 1e-4
# the MoE and VLM phases replay their steps against eager on the ladders'
# 8-layer rungs (gemma-2b on its 6-layer one): at L32 / L48 an eager step
# is host-bound at ~0.1 s and the comparison took 77 s a phase (the
# published depth's launches are asserted by each phase's model check)
GRAPH_DEPTH = 8
# encoder-decoder phase: whisper-tiny at its published size (4 + 4 layers,
# d_model 384, 6 heads of hd 64 on 6 KV heads: G 1, 1500 frames): B x
# WHISPER_PROMPT decoder tokens and WHISPER_STEPS decode steps; its fp32
# card-vs-CPU twin at WHISPER_TWIN_B rows and 8 steps, logits within
# FP32_CPU_REL_TOL (||card - CPU|| / ||CPU||: fp32 sums in other orders)
WHISPER = "whisper-tiny"
WHISPER_H, WHISPER_KV, WHISPER_HD = 6, 6, 64
WHISPER_PROMPT, WHISPER_STEPS, WHISPER_TWIN_B = 64, 64, 2
FP32_CPU_REL_TOL = 1e-4
# VLM phase: internvl2-26b's heads (48 query heads on 8 KV heads of hd 128:
# G 6), its image prefix (256 projected patches before the 512-token
# prompt), its serve loops' length
INTERNVL = "internvl2-26b"
INTERNVL_H, INTERNVL_KV, INTERNVL_HD = 48, 8, 128
INTERNVL_PREFIX = 256
VLM_SERVE_SECONDS = 6
# ResNet phase: the paper's five variants at 224 x 224 in fp32 (TF32 off),
# card vs CPU at RESNET_TWIN_B images within RESNET_REL_TOL of the logits'
# largest magnitude, timed at each of RESNET_BATCHES
RESNET_BATCHES = (1, 8, 32)
RESNET_TWIN_B, RESNET_REL_TOL = 2, 1e-5
# C1: memory_allocated after an engine's close (every backend retired, a
# collection, the cache emptied) may exceed the engine's start by this
# much: what the first engine of a process leaves for good on the one
# capture stream (cuBLAS's workspace, 33.8 MB on the H100, and the
# kernels' split workspace)
CLOSE_MARGIN = 0.1e9
# train phase: tinyllama-1.1b at full width on B x S token batches (warm-up
# and timed steps at TRAIN_ADAM, then the tiny-LM example's optimizer for
# LEARN_STEPS); the card-vs-CPU twin at full width and TWIN_LAYERS layers
# in fp32 (Adam's first update moves an element by at most ~lr, 3e-6 at
# TRAIN_ADAM's first step: params within TWIN_PARAM_ATOL; losses within
# TRAIN_LOSS_RTOL: fp32 sums in other orders); the paper's LSTM, a CPU
# twin of 20 steps within LSTM_REL_TOL, then the InfAdapter loop with it
# as the forecaster. Step counts keep the phase near 150 s: the LSTM runs
# 30 of the example's 300 steps (a step takes 0.4-0.5 s on an H100 80GB
# HBM3 at 700 W, launch-bound), the learning run 60
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_B, TRAIN_S = 8, 512
TRAIN_WARMUP, TRAIN_TIMED, LEARN_STEPS = 3, 10, 60
# the learning run draws its tokens from the tiny-LM example's 512-token
# vocabulary: over all 32000 the chain's 256k transitions are each seen a
# few times in 80 steps, and the loss only falls to the uniform floor
# (10.711 -> 10.431 on an H100 80GB HBM3 at 700 W)
LEARN_VOCAB = 512
TWIN_LAYERS, TWIN_B, TWIN_S = 2, 2, 64
TWIN_PARAM_ATOL, TRAIN_LOSS_RTOL = 1e-5, 1e-5
LSTM_STEPS, LSTM_TWIN_STEPS, LSTM_REL_TOL = 30, 20, 1e-4
LSTM_SERVE_SECONDS = 6
DEVICE = "cuda"


def log(msg):
    print(msg, flush=True)


def card_rates():
    """(HBM bytes/s, dense bf16 FLOP/s) of the H100 SXM from this
    checkout's ``repro_torch/core/profiles.py``, loaded by path so that
    ``--ab`` against an older checkout reads the same constants."""
    import importlib.util
    path = ROOT / "src" / "repro_torch" / "core" / "profiles.py"
    spec = importlib.util.spec_from_file_location("_card_rates", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod.HBM_BW, mod.PEAK_FLOPS_BF16


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


def kernel_events(torch, fn, arg_sets, iters=20, only=None):
    """``torch.profiler``'s events of the kernels that ``iters`` calls of
    ``fn`` cycling through ``arg_sets`` launched (or of those whose name
    holds ``only``). The profiler now and then records some of a trace's
    kernels or none, the first most often: each trace starts with three
    short spin kernels that are not counted, and a trace is kept only when
    its kernels are a nonzero whole multiple of ``iters`` (every call
    launches the same kernels), else it is taken again; after three such
    traces the result is None, never a partial trace."""
    from torch.profiler import ProfilerActivity, profile
    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(3):
                torch.cuda._sleep(1000)
            for i in range(iters):
                fn(*arg_sets[i % len(arg_sets)])
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_type == cuda
               and "spin_kernel" not in e.key
               and (only is None or only in e.key)]
        n = sum(e.count for e in evs)
        if n > 0 and n % iters == 0:
            return evs
        log(f"  profiler trace held {n} kernels for {iters} calls: "
            "taken again")
    log("  profiler: three short traces")
    return None


def device_ms(torch, fn, arg_sets, iters=20, only=None):
    """Device time per call from ``kernel_events``: every kernel the calls
    launched (or those whose name holds ``only``), summed (no host time, no
    gaps between launches); None (not measured) when the profiler gave no
    whole trace."""
    evs = kernel_events(torch, fn, arg_sets, iters, only)
    return (None if evs is None
            else sum(e.self_device_time_total for e in evs) / 1e3 / iters)


def ms4(x):
    """A time for the log: 4 decimals, or "not measured" for None."""
    return "not measured" if x is None else f"{x:.4f}"


def check(name, got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[str(dtype)]
    log(f"  {name:<44s} max_abs_err {err:.3e}  tol {tol:.0e}")
    if not err <= tol:
        raise AssertionError(f"{name}: max abs err {err} > {tol}")
    return err


def paged_inputs(torch, gen, b, kv, g, hd, ps, width, dtype, poison=False):
    """A pool of b*width+1 pages shuffled across the rows' tables, ragged
    lengths in 1..width*ps with the last row at 0. With ``poison``, page 0
    holds NaN and every table entry past a row's live pages points at it."""
    dev = torch.device(DEVICE)
    P = b * width + 1
    q = torch.randn((b, kv, g, hd), generator=gen, device=dev).to(dtype)
    kp = torch.randn((kv, P, ps, hd), generator=gen, device=dev).to(dtype)
    vp = torch.randn((kv, P, ps, hd), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    tables = perm.reshape(b, width).to(torch.int32)
    lengths = torch.randint(1, width * ps + 1, (b,), generator=gen,
                            device=dev).to(torch.int32)
    lengths[-1] = 0
    if poison:
        kp[:, 0] = float("nan")
        vp[:, 0] = float("nan")
        live = (lengths + ps - 1) // ps
        cols = torch.arange(width, device=dev)[None, :]
        tables = torch.where(cols >= live[:, None], 0, tables)
    return q, kp, vp, tables, lengths


def chunk_inputs(torch, gen, b, kv, g, hd, ps, width, n_pages, ck, dtype,
                 poison=False, start_range=None):
    """The chunk form's operands: q (b, ck, kv, g, hd), a shuffled pool,
    tables sliced to n_pages of width columns, lengths clip(start + j + 1,
    1, T) with start drawn from ``start_range`` (default: the whole table,
    row 0 crossing the 64-position tile border, row 1 all 1, row 2 clipped
    at T, row 3 zero at every other token). With ``poison``, page 0 holds
    NaN and every table entry past a row's largest length points at it."""
    dev = torch.device(DEVICE)
    P, T = b * width + 1, n_pages * ps
    q = torch.randn((b, ck, kv, g, hd), generator=gen, device=dev).to(dtype)
    kp = torch.randn((kv, P, ps, hd), generator=gen, device=dev).to(dtype)
    vp = torch.randn((kv, P, ps, hd), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    tables = perm.reshape(b, width).to(torch.int32)
    lo, hi = start_range or (0, T - 1)
    start = torch.randint(lo, hi + 1, (b,), generator=gen, device=dev)
    if start_range is None:
        start[0] = min(64 - ck // 2, T - 1)
        start[2 % b] = T - 2
    lengths = (start[:, None] + torch.arange(ck, device=dev)[None, :] + 1
               ).clamp(1, T).to(torch.int32)
    if start_range is None:
        lengths[1 % b] = 1
        if b > 3:
            lengths[3, ::2] = 0
    if poison:
        kp[:, 0] = float("nan")
        vp[:, 0] = float("nan")
        live = (lengths.max(1).values + ps - 1) // ps
        cols = torch.arange(width, device=dev)[None, :]
        tables = torch.where(cols >= live[:, None], 0, tables)
    return q, kp, vp, tables[:, :n_pages], lengths


def fused_inputs(torch, gen, dtype):
    """The fused tick's chunk in the shared-prefix study: B rows of CK
    tokens at positions past the 384-token shared prefix of 512-token
    prompts, over full 36-page tables of 16."""
    return chunk_inputs(torch, gen, B, KV, H // KV, HD, PAGE, WIDTH, WIDTH,
                        CK, dtype, start_range=(PS_SHARED, PROMPT - CK))


def dense_chunk_inputs(torch, gen, b, ck, kv, g, hd, c, dtype, kind="fused"):
    """flash_decode's chunk form operands: q (b, ck, kv, g, hd), k/v
    (b, kv, c, hd) and the bias (b, ck, c). ``kind`` "fused": the dense
    fused tick's causal bias (t <= start + j) with every row at a chunk
    border of a 512-token prompt (row 1 inert at 0, where a padded query
    still sees key 0, as in the engine); "verify": a speculative round's
    verify, every row at a position past the 512-token prompt with its ck
    = k + 1 queries inside c (row 1 inert at 0); "ragged": starts
    anywhere, one row running past c; "first": every key but the first
    under -1e9."""
    dev = torch.device(DEVICE)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q, k, v = randn(b, ck, kv, g, hd), randn(b, kv, c, hd), randn(b, kv, c, hd)
    if kind == "first":
        bias = torch.full((b, ck, c), -1e9, device=dev)
        bias[..., 0] = 0.0
        return q, k, v, bias
    if kind == "fused":
        start = ck * torch.randint(0, max(1, PROMPT // ck), (b,),
                                   generator=gen, device=dev)
    elif kind == "verify":
        start = torch.randint(PROMPT, c - ck + 1, (b,), generator=gen,
                              device=dev)
    else:
        start = torch.randint(0, c, (b,), generator=gen, device=dev)
        start[-1] = max(c - ck // 2, 0)
    start[min(1, b - 1)] = 0
    pos = start[:, None] + torch.arange(ck, device=dev)[None, :]
    valid = torch.arange(c, device=dev)[None, None, :] <= pos[:, :, None]
    return q, k, v, torch.where(valid, 0.0, -1e9).float()


def dense_chunk_checks(torch, fd, gen):
    """flash_decode's chunk form against its plain version (the stack of
    single-query plain calls): the dense fused tick's shape in bf16 and
    fp32, then the edges. Returns (bf16 fused-shape error, its inputs)."""
    G = H // KV
    edges = (("softcap=30.0", (B, CK, KV, G, HD, CAP), 30.0, "fused"),
             (f"C={fd.SPLITS - 3} below the split count",
              (3, 5, 2, 8, HD, fd.SPLITS - 3), 0.0, "ragged"),
             ("hymba heads G=5", (B, CK, HYMBA_KV, HYMBA_H // HYMBA_KV, HD,
                                  CAP), 0.0, "fused"),
             ("hd 128 ragged", (2, CK, 2, 8, 128, 300), 0.0, "ragged"),
             ("hd 128 softcap, first key only", (2, 7, 2, 4, 128, 100),
              30.0, "first"),
             ("first key only", (B, CK, KV, G, HD, CAP), 0.0, "first"),
             # the tensor-core route's edges (bf16 at hd 64, then 256):
             # C below its splits, C not a multiple of its 64-position
             # tiles, more tiles than splits, a short second row block
             # (G 7), 64 tokens a block (G 1)
             (f"C={fd.TC_SPLITS - 1} below the tensor-core splits",
              (3, 5, 2, 8, HD, fd.TC_SPLITS - 1), 0.0, "ragged"),
             ("C=203 ragged tile", (4, CK, KV, G, HD, 203), 0.0, "ragged"),
             ("C=700 softcap, first key only", (2, CK, 2, G, HD, 700), 30.0,
              "first"),
             ("G=7 short row block", (2, 9, 3, 7, HD, 130), 0.0, "ragged"),
             ("G=1 ck=80", (2, 80, 2, 1, HD, 320), 0.0, "ragged"),
             ("ck=1 chunk layout", (2, 1, 2, G, HD, 50), 0.0, "ragged"),
             ("hd 256 C=3 below the splits", (3, 5, 1, 8, 256, 3), 0.0,
              "ragged"),
             ("hd 256 C=203 softcap", (4, CK, 1, 8, 256, 203), 30.0,
              "ragged"),
             ("hd 256 C=700 first key only", (2, CK, 1, 8, 256, 700), 0.0,
              "first"),
             ("hd 256 G=7 ck=10 two row blocks", (2, 10, 3, 7, 256, 130),
              0.0, "ragged"),
             ("hd 256 G=1 ck=80", (2, 80, 2, 1, 256, 320), 0.0, "ragged"))
    err = args = None
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        a = dense_chunk_inputs(torch, gen, B, CK, KV, G, HD, CAP, dtype)
        e = check(f"flash_decode_chunk fused shape {name}",
                  fd.flash_decode_chunk(*a), fd.flash_decode_chunk_plain(*a),
                  dtype)
        if dtype == torch.bfloat16:
            err, args = e, a
        for label, (b, ck, kv, g, hd, c), sc, kind in edges:
            a = dense_chunk_inputs(torch, gen, b, ck, kv, g, hd, c, dtype,
                                   kind)
            out = fd.flash_decode_chunk(*a, softcap=sc)
            if not torch.isfinite(out).all():
                raise AssertionError(f"flash_decode_chunk {label}: non-finite")
            check(f"flash_decode_chunk {label} {name}", out,
                  fd.flash_decode_chunk_plain(*a, softcap=sc), dtype)
    return err, args


def dense_chunk_timing(torch, F, fd, gen, args, kind="fused"):
    """The chunk form at the dense fused tick's shape (bf16; with
    ``kind="verify"`` at a speculative verify's, ck from ``args``): kernel,
    plain, device and SDPA-with-a-(B, H, ck, C)-float-mask times (SDPA: the
    yardstick the port never calls), inputs rotated through more than 3x
    the L2 size, each set with its own chunk starts. The bound reads q,
    out, the bias and each row's K/V below its largest query length once;
    its operations are QK^T and PV over each query's own valid keys on the
    bf16 tensor cores."""
    dt, esz, G = torch.bfloat16, 2, H // KV
    ck = args[0].shape[1]
    sets = rotated(args, lambda: dense_chunk_inputs(
        torch, gen, B, ck, KV, G, HD, CAP, dt, kind), ())
    bias = args[3]
    valid = (bias == 0).sum(-1)                       # (B, ck) keys per query
    lmax = valid.max(1).values
    nbytes = (esz * (2 * int(lmax.sum()) * KV * HD + 2 * B * ck * H * HD)
              + 4 * B * ck * CAP)
    b_ms, b_by = bound(nbytes, 4 * H * HD * int(valid.sum()), dt)
    sdpa_sets = [(q.reshape(B, ck, H, HD).transpose(1, 2), k, v,
                  m[:, None]) for q, k, v, m in sets]
    sdpa = (lambda q, k, v, m: F.scaled_dot_product_attention(
        q, k, v, attn_mask=m, enable_gqa=True))
    return dict(ms=time_ms(torch, fd.flash_decode_chunk, sets),
                plain_ms=time_ms(torch, fd.flash_decode_chunk_plain, sets,
                                 iters=4),
                bound_ms=b_ms, bound_by=b_by,
                device_ms=device_ms(torch, fd.flash_decode_chunk, sets),
                library_ms=time_ms(torch, sdpa, sdpa_sets),
                library_device_ms=device_ms(torch, sdpa, sdpa_sets))


def chunk_splits(torch, mod, attr, fn, plain, sets, label,
                 splits=(1, 2, 3, 4, 6, 9), key=None):
    """A tensor-core chunk form's device time (bf16, over ``sets``, the
    first held to the plain version at each count) for each count of CTAs
    per row block: ``mod.<attr>`` (its entry ``key`` where it maps head
    dims to counts), which ``launch_plan`` reads at each call. The sweep
    behind the kernel's split count. Returns {splits: device ms}."""
    keep, out = getattr(mod, attr), {}
    try:
        for n in splits:
            setattr(mod, attr, n if key is None else {**keep, key: n})
            check(f"{label}, {n} splits", fn(*sets[0]), plain(*sets[0]),
                  torch.bfloat16)
            out[n] = device_ms(torch, fn, sets)
    finally:
        setattr(mod, attr, keep)
    log(f"  {label} device ms by splits: " + json.dumps(out))
    return out


def dense_chunk_splits(torch, fd, gen, args):
    """``chunk_splits`` of flash_decode's chunk form at the dense fused
    tick's shape (tinyllama, hd 64)."""
    sets = rotated(args, lambda: dense_chunk_inputs(
        torch, gen, B, CK, KV, H // KV, HD, CAP, torch.bfloat16), ())
    return chunk_splits(torch, fd, "TC_SPLITS", fd.flash_decode_chunk,
                        fd.flash_decode_chunk_plain, sets,
                        "flash_decode_chunk fused shape")


def paged_kernel_checks(torch, pd, gen):
    """paged_decode, both forms, against their plain versions; returns
    (bf16 decode serve-shape error, its inputs, bf16 fused-shape chunk
    error, its inputs)."""
    G = H // KV
    err = None
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        args = paged_inputs(torch, gen, B, KV, G, HD, PAGE, WIDTH, dtype)
        e = check(f"paged_decode serve shape {name}",
                  pd.paged_flash_decode_bkhd(*args),
                  pd.paged_flash_decode_plain(*args), dtype)
        if dtype == torch.bfloat16:
            err, serve_args = e, args
        cargs = fused_inputs(torch, gen, dtype)
        got = pd.paged_flash_decode_chunk(*cargs)
        e = check(f"paged_decode chunk fused shape {name}", got,
                  pd.paged_flash_decode_chunk_plain(*cargs), dtype)
        per_token = torch.stack([pd.paged_flash_decode_bkhd(
            cargs[0][:, j].contiguous(), *cargs[1:4],
            cargs[4][:, j].contiguous()) for j in range(CK)], 1)
        check(f"paged_decode chunk vs {CK} single-query launches {name}",
              got, per_token, dtype)
        if dtype == torch.bfloat16:
            chunk_err, chunk_args = e, cargs
        chunk_cases = (  # label, (b, kv, g, hd, ps, width, n_pages, ck),
            #              softcap, poison
            ("fused shape NaN pages", (B, KV, G, HD, PAGE, WIDTH, WIDTH, CK),
             0.0, True),
            ("hd=128 ps=8", (3, 2, 4, 128, 8, 10, 10, 5), 0.0, False),
            ("softcap=30", (4, KV, G, HD, PAGE, 12, 12, CK), 30.0, True),
            ("G=1 n_pages 12 < width 20", (5, 2, 1, HD, 8, 20, 12, 5), 0.0,
             True),
            ("ck=1", (4, 1, G, HD, PAGE, 9, 9, 1), 0.0, False),
            ("hymba G=5", (4, 2, 5, HD, PAGE, 12, 12, CK), 0.0, True),
            ("hd=256 ps=8 softcap", (3, 1, 8, 256, 8, 20, 20, 10), 30.0,
             True))
        for label, shape, sc, poison in chunk_cases:
            q, kp, vp, t, ln = chunk_inputs(torch, gen, *shape, dtype,
                                            poison)
            got = pd.paged_flash_decode_chunk(q, kp, vp, t, ln, softcap=sc)
            want = pd.paged_flash_decode_chunk_plain(q, kp, vp, t, ln,
                                                     softcap=sc)
            if not (bool(torch.isfinite(got.float()).all())
                    and bool((got.float()[ln == 0] == 0).all())):
                raise AssertionError(f"paged_decode chunk {label}: "
                                     f"non-finite output or nonzero "
                                     f"length-0 query")
            check(f"paged_decode chunk {label} {name}", got, want, dtype)
        # the decode form's split: lengths 0, below the split count, not a
        # multiple of it, full; a one-page table; poisoned pages past each
        for label, shape, lens in (
                ("split edges", (4, 2, G, HD, PAGE, WIDTH), (0, 3, 203, 576)),
                ("one-page table", (3, 2, 4, HD, PAGE, 1), (1, 16, 7))):
            q, kp, vp, t, _ = paged_inputs(torch, gen, *shape, dtype)
            kp[:, 0] = float("nan")
            vp[:, 0] = float("nan")
            ln = torch.tensor(lens, dtype=torch.int32, device=q.device)
            t = torch.where(torch.arange(t.shape[1], device=q.device)[None]
                            >= (ln[:, None] + PAGE - 1) // PAGE, 0, t)
            got = pd.paged_flash_decode_bkhd(q, kp, vp, t, ln)
            if not (bool(torch.isfinite(got.float()).all())
                    and bool((got[ln == 0] == 0).all())):
                raise AssertionError(f"paged_decode {label}: non-finite "
                                     f"output or nonzero length-0 row")
            check(f"paged_decode {label} {name}", got,
                  pd.paged_flash_decode_plain(q, kp, vp, t, ln), dtype)
        cases = (  # label, (b, kv, g, hd, ps, width), n_pages, softcap, poison
            ("ps=8 hd=128", (3, 2, 4, 128, 8, 10), 10, 0.0, False),
            ("softcap=30", (4, KV, G, HD, PAGE, 12), 12, 30.0, False),
            ("n_pages 5 < width 12", (5, 2, 4, HD, PAGE, 12), 5, 0.0, False),
            ("NaN pages past length", (6, KV, G, HD, PAGE, 9), 9, 0.0, True))
        for label, shape, n_pages, sc, poison in cases:
            q, kp, vp, t, ln = paged_inputs(torch, gen, *shape, dtype, poison)
            t = t[:, :n_pages]               # a column slice, not a copy
            got = pd.paged_flash_decode_bkhd(q, kp, vp, t, ln, softcap=sc)
            want = pd.paged_flash_decode_plain(q, kp, vp, t, ln, softcap=sc)
            if not (bool(torch.isfinite(got.float()).all())
                    and bool((got[-1] == 0).all())):
                raise AssertionError(f"paged_decode {label}: non-finite "
                                     f"output or nonzero length-0 row")
            check(f"paged_decode {label} {name}", got, want, dtype)
    return err, serve_args, chunk_err, chunk_args


def step_route_checks(torch, fd, pd, gen):
    """The decode step's tensor-core routes on their edges in bf16 (as in
    tests/test_torch_cuda.py), each held to its plain version: the dense
    step at hd 64 at tinyllama's G 8 (C 1, C just below and just above
    ``STEP_SPLITS[64]``, only the first key unbiased, C 2000), granite's G
    3, G 16 and whisper-tiny's G 1 (which the plan keeps on the CUDA-core
    kernel at hd 64); the paged step at the heads of
    tinyllama, granite, gemma-2b and internvl2-26b over 4 pages of 16 at
    lengths 0, 1, ps - 1, ps, ps + 1, n_pages * ps and above it, and over
    the serve path's 36 pages with a softcap, NaN pages past every length
    and, for the kernel, table entries there out of range (the plain
    version gathers the whole table, so it reads the NaN page there); a
    length-0 row must give zeros."""
    dev, bf = torch.device(DEVICE), torch.bfloat16
    splits, G = fd.STEP_SPLITS[HD], H // KV

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)
    for b, kv, g, c, sc, masked in (
            (B, KV, G, 1, 0.0, False), (B, KV, G, splits - 1, 0.0, False),
            (B, KV, G, splits + 1, 30.0, True), (B, KV, G, CAP, 0.0, "first"),
            (2, KV, G, 2000, 0.0, True),
            (4, GRANITE_KV, GRANITE_H // GRANITE_KV, 2000, 30.0, False),
            (2, 2, 16, CAP, 0.0, True),
            (B, WHISPER_KV, WHISPER_H // WHISPER_KV, CAP, 0.0, False),
            (4, WHISPER_KV, WHISPER_H // WHISPER_KV, 1000, 30.0, True)):
        q, k, v = randn(b, kv, g, HD), randn(b, kv, c, HD), randn(b, kv, c, HD)
        bias = torch.zeros((b, c), device=dev)
        if masked == "first":
            bias[:, 1:] = -1e9
        elif masked:
            bias[:, c // 2:] = -1e9
        check(f"flash_decode step hd {HD} B={b} KV={kv} G={g} C={c} "
              f"softcap={sc} bias={masked} bfloat16",
              fd.flash_decode_bkhd(q, k, v, bias, softcap=sc),
              fd.flash_decode_plain(q, k, v, bias, softcap=sc), bf)
    for tag, (H_, KV_, HD_) in (
            ("tinyllama", (H, KV, HD)),
            ("granite", (GRANITE_H, GRANITE_KV, GRANITE_HD)),
            ("gemma", (GEMMA_H, GEMMA_KV, GEMMA_HD)),
            ("internvl", (INTERNVL_H, INTERNVL_KV, INTERNVL_HD))):
        for width, lens, sc in (
                (4, (0, 1, PAGE - 1, PAGE, PAGE + 1, 4 * PAGE, 4 * PAGE + 6),
                 0.0),
                (WIDTH, (0, 3, 203, CAP, CAP + 100, 97, 575, 1), 30.0)):
            q, kp, vp, tables, _ = paged_inputs(torch, gen, len(lens), KV_,
                                                H_ // KV_, HD_, PAGE, width,
                                                bf)
            ln = torch.tensor(lens, dtype=torch.int32, device=dev)
            kp[:, 0] = float("nan")
            vp[:, 0] = float("nan")
            past = (torch.arange(width, device=dev)[None, :]
                    >= ((ln + PAGE - 1) // PAGE)[:, None])
            wild = torch.where(past, 2**31 - 1, tables).to(torch.int32)
            tables = torch.where(past, 0, tables).to(torch.int32)
            got = pd.paged_flash_decode_bkhd(q, kp, vp, wild, ln, softcap=sc)
            if not (bool(torch.isfinite(got.float()).all())
                    and bool((got[ln == 0] == 0).all())):
                raise AssertionError(f"paged_decode step {tag}: non-finite "
                                     f"output or nonzero length-0 row")
            check(f"paged_decode step {tag} hd {HD_} {width} pages, lengths "
                  f"{lens}, softcap {sc}, NaN pages and wild entries past "
                  f"each bfloat16", got,
                  pd.paged_flash_decode_plain(q, kp, vp, tables, ln,
                                              softcap=sc), bf)


def verify_paged_inputs(torch, gen, ck, width, dtype):
    """The paged chunk form's operands at a speculative round's shape: B
    rows of ck queries at positions past the 512-token prompt, over full
    ``width``-page tables of 16."""
    return chunk_inputs(torch, gen, B, KV, H // KV, HD, PAGE, width, width,
                        ck, dtype, start_range=(PROMPT, width * PAGE - ck))


def verify_shape_checks(torch, fd, pd, gen):
    """Both chunk forms at a speculative round's shapes against their plain
    versions, bf16 and fp32: the verify at ck = SPEC_K + 1 over the
    verifier's 576-slot ring and 36-page tables, and the drafter's width-1
    resync over its SPEC_CAP = 582-slot ring (not a multiple of 64) and
    37-page tables, queries past the 512-token prompt. Returns {(form,
    dtype): (max abs err, inputs)} of the verify shape."""
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        for label, ck, c in (("verify", SPEC_K + 1, CAP),
                             ("resync", 1, SPEC_CAP)):
            a = dense_chunk_inputs(torch, gen, B, ck, KV, H // KV, HD, c,
                                   dtype, "verify")
            e = check(f"flash_decode_chunk {label} B={B} ck={ck} C={c} "
                      f"{name}", fd.flash_decode_chunk(*a),
                      fd.flash_decode_chunk_plain(*a), dtype)
            pa = verify_paged_inputs(torch, gen, ck, -(-c // PAGE), dtype)
            e2 = check(f"paged_decode chunk {label} ck={ck} "
                       f"{-(-c // PAGE)} pages {name}",
                       pd.paged_flash_decode_chunk(*pa),
                       pd.paged_flash_decode_chunk_plain(*pa), dtype)
            if label == "verify":
                out[("dense", dtype)] = (e, a)
                out[("paged", dtype)] = (e2, pa)
    return out


def ssd_inputs(torch, gen, b, s, h, p, n, dtype, strided=True):
    """x, dt, A, B, C, initial state of one SSD scan; with ``strided`` x, B
    and C are views of one packed (b, s, h*p + 2n) tensor, as the model
    passes its conv output."""
    dev = torch.device(DEVICE)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    dt = torch.nn.functional.softplus(randn(b, s, h))
    A = -randn(h).abs()
    init = randn(b, h, p, n) * 0.1
    if strided:
        xc = randn(b, s, h * p + 2 * n).to(dtype)
        x = xc[..., :h * p].unflatten(-1, (h, p))
        B, C = xc[..., h * p:h * p + n], xc[..., h * p + n:]
    else:
        x, B, C = (randn(b, s, h, p).to(dtype), randn(b, s, n).to(dtype),
                   randn(b, s, n).to(dtype))
    return x, dt, A, B, C, init


def rel_check(name, got, want, tol):
    """Hold max |got - want| / max |want| to ``tol``; returns max abs err."""
    err = (got.float() - want.float()).abs().max().item()
    rel = err / want.float().abs().max().item()
    log(f"  {name:<44s} max_abs_err {err:.3e}  rel_err {rel:.3e}  "
        f"tol {tol:.0e}")
    if not rel <= tol:
        raise AssertionError(f"{name}: relative err {rel} > {tol}")
    return err


def ssd_kernel_checks(torch, ss, plain, gen):
    """ssd_scan against its plain version at both serve geometries (bf16
    and fp32, nonzero initial state, strided and packed operands) and on a
    ragged last chunk; returns the max abs error of the bf16 mamba2-130m
    y (held relative to max |y|)."""
    err = None
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        tol = SSD_REL_TOL[str(dtype)]
        cases = [(f"{arch} serve shape", (B, PROMPT, *hpn), SSD_CHUNK,
                  strided) for arch, hpn in SSD_HEADS.items()
                 for strided in (True, False)]
        cases.append(("ragged s=300", (2, 300, *SSD_HEADS["mamba2-130m"]),
                      SSD_CHUNK, True))
        cases += [(f"p16/n8 {shape}", shape[:5], shape[5], True)
                  for shape in SSD_NARROW]
        for label, shape, chunk, strided in cases:
            x, dt, A, Bm, Cm, init = ssd_inputs(torch, gen, *shape, dtype,
                                                strided)
            y, fin = ss.ssd_scan_chunked(x, dt, A, Bm, Cm, init, chunk=chunk)
            wy, wfin = plain(x, dt, A, Bm, Cm, chunk, init)
            lab = f"ssd_scan {label}{'' if strided else ' packed'} {name}"
            e = rel_check(f"{lab} y", y, wy, tol)
            rel_check(f"{lab} state", fin, wfin,
                      SSD_REL_TOL["torch.float32"])
            if dtype == torch.bfloat16 and label.startswith("mamba2") \
                    and strided:
                err = e
    return err


def ssd_work(b, s, h, p, n, chunk, esz):
    """(bytes, operations) the SSD scan must move and do: x, B, C, dt, A
    and the initial state read once, y and the final state written once;
    per (row, chunk) C.B over the causal (l, s) pairs once (shared by the
    heads), then per head the diagonal product over those pairs and the
    carried-state and state-update products (q x p x n each), 2 flops per
    multiply-add; a ragged last chunk counts its own steps."""
    nbytes = (esz * (2 * b * s * h * p + 2 * b * s * n)
              + 4 * (b * s * h + h + 2 * b * h * p * n))
    flops = 0
    for q in [chunk] * (s // chunk) + ([s % chunk] if s % chunk else []):
        pairs = q * (q + 1) // 2
        flops += 2 * b * (pairs * n + h * (pairs * p + 2 * q * p * n))
    return nbytes, flops


def ssd_narrow_rows(torch, ss, plain, gen):
    """The p 16 / n 8 edge line: each SSD_NARROW shape in bf16 and fp32
    (strided views, nonzero initial state) held to the plain version, then
    its device ms beside its bound (``ssd_work``)."""
    out = {}
    for b, s, h, p, n, chunk in SSD_NARROW:
        for dt in (torch.bfloat16, torch.float32):
            args = ssd_inputs(torch, gen, b, s, h, p, n, dt)
            y, fin = ss.ssd_scan_chunked(*args, chunk=chunk)
            wy, wfin = plain(*args[:5], chunk, args[5])
            lab = f"ssd_scan p16/n8 {(b, s, h, p, n, chunk)} {str(dt)[6:]}"
            err = rel_check(f"{lab} y", y, wy, SSD_REL_TOL[str(dt)])
            rel_check(f"{lab} state", fin, wfin,
                      SSD_REL_TOL["torch.float32"])
            b_ms, b_by = bound(*ssd_work(b, s, h, p, n, chunk,
                                         2 if dt == torch.bfloat16 else 4),
                               dt)
            dev_ms = device_ms(torch, lambda *a: ss.ssd_scan_chunked(
                *a, chunk=chunk), [args])
            log(f"  {'ssd_scan':<14s} {str(dt)[6:]:<9s} edge "
                f"(b,s,h,p,n,q)={(b, s, h, p, n, chunk)}: device "
                f"{ms4(dev_ms)} ms, bound {b_ms:.6f} ({b_by})")
            out[f"{(b, s, h, p, n, chunk)} {str(dt)[6:]}"] = dict(
                max_abs_err=err, device_ms=dev_ms, bound_ms=b_ms,
                bound_by=b_by)
    return out


def ssd_timing(torch, ss, plain, gen, arch, iters=20):
    """ssd_scan at ``arch``'s serve shape (B x PROMPT, bf16, the strided
    views the model passes, nonzero initial state), inputs rotated through
    more than 3x the L2 size: kernel, plain and device times beside the
    bound. The bound reads x, B, C, dt, A and the initial state once and
    writes y and the final state once; its operations are, per (row,
    chunk), C.B over the causal (l, s) pairs once (shared by the heads),
    then per head the diagonal product over those pairs and the
    carried-state and state-update products (q x p x n each), 2 flops per
    multiply-add (``ssd_work``)."""
    dt, esz = torch.bfloat16, 2
    h, p, n = SSD_HEADS[arch]
    nbytes, flops = ssd_work(B, PROMPT, h, p, n, SSD_CHUNK, esz)
    sets = [ssd_inputs(torch, gen, B, PROMPT, h, p, n, dt)
            for _ in range(int(3 * L2_BYTES // nbytes) + 1)]
    b_ms, b_by = bound(nbytes, flops, dt)

    def kern(*a):
        return ss.ssd_scan_chunked(*a, chunk=SSD_CHUNK)
    # device time of each of the kernel's launches (kernel names holding
    # these; an older single-launch kernel matches none of them)
    per_launch = {k: device_ms(torch, kern, sets, only=k) for k in (
        "ssd_scan_chunk", "ssd_scan_pass", "ssd_scan_out")}
    return dict(ms=time_ms(torch, kern, sets, iters=iters),
                plain_ms=time_ms(torch, lambda *a: plain(*a[:5], SSD_CHUNK,
                                                         a[5]),
                                 sets, iters=6),
                bound_ms=b_ms, bound_by=b_by,
                device_ms=device_ms(torch, kern, sets),
                launch_device_ms=per_launch)


def ssd_ab(torch, gen):
    """ssd_scan of the imported ``repro_torch`` (``--ab``) at mamba2-130m's
    and hymba-1.5b's serve shapes in bf16, through the strided views the
    model passes with a nonzero initial state: y and the final state held
    to the plain version under SSD_REL_TOL, then timed (``ssd_timing``)."""
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models.ssd import ssd_scan_plain
    rows = []
    for arch, hpn in SSD_HEADS.items():
        x, dt, A, Bm, Cm, init = ssd_inputs(torch, gen, B, PROMPT, *hpn,
                                            torch.bfloat16)
        y, fin = ss.ssd_scan_chunked(x, dt, A, Bm, Cm, init, chunk=SSD_CHUNK)
        wy, wfin = ssd_scan_plain(x, dt, A, Bm, Cm, SSD_CHUNK, init)
        err = rel_check(f"ssd_scan {arch} serve shape bfloat16 y", y, wy,
                        SSD_REL_TOL["torch.bfloat16"])
        rel_check(f"ssd_scan {arch} serve shape bfloat16 state", fin, wfin,
                  SSD_REL_TOL["torch.float32"])
        rows.append(dict(name="ssd_scan", shape=arch, max_abs_err=err,
                         **ssd_timing(torch, ss, ssd_scan_plain, gen, arch)))
    return rows


def rotated(first, make, shared):
    """``first`` plus enough sets from ``make()`` to exceed 3x the L2 size,
    each taking the arguments at indices ``shared`` from ``first`` (so
    every call has the same lengths and tables, which the bound counts)."""
    nbytes = sum(t.numel() * t.element_size() for t in first)
    sets = [first] + [make() for _ in range(int(3 * L2_BYTES // nbytes))]
    return [tuple(first[i] if i in shared else a for i, a in enumerate(st))
            for st in sets]


def paged_decode_timing(torch, pd, gen, serve_args):
    """The decode form at the serve shape (bf16): B=8 rows over 36-page
    tables of 16, ragged lengths (one row 0); kernel, plain and device
    times beside the bound, which counts what these lengths need."""
    dt, esz = torch.bfloat16, 2
    q, kp, vp, tables, lengths = serve_args
    pags = rotated(serve_args, lambda: paged_inputs(
        torch, gen, B, KV, H // KV, HD, PAGE, WIDTH, dt), (3, 4))
    # K/V of the positions below each row's length (not the tails of the
    # last pages, which the kernel never loads), q, out, the table entries
    # of the live pages and the lengths
    live_pages = int(((lengths.long() + PAGE - 1) // PAGE).sum())
    live_pos = int(lengths.long().sum())
    nbytes = (esz * (2 * live_pos * KV * HD + 2 * B * H * HD)
              + 4 * live_pages + 4 * B)
    b_ms, b_by = bound(nbytes, 4 * H * live_pos * HD, dt)
    return dict(ms=time_ms(torch, pd.paged_flash_decode_bkhd, pags),
                plain_ms=time_ms(torch, pd.paged_flash_decode_plain, pags,
                                 iters=10),
                bound_ms=b_ms, bound_by=b_by,
                device_ms=device_ms(torch, pd.paged_flash_decode_bkhd, pags))


def paged_chunk_timing(torch, pd, gen, chunk_args, make=None,
                       prefix="chunk"):
    """The chunk form at the fused tick's shape (bf16; ``fused_inputs``, or
    ``make(dtype)``'s inputs, such as a speculative verify's): kernel,
    plain and device times beside the bound, under ``<prefix>_*`` keys.
    The bound reads each row's K/V below its largest length once, q, out,
    the live table entries and the lengths; its operations are QK^T and PV
    over each query's own length on the bf16 tensor cores."""
    dt, esz = torch.bfloat16, 2
    lengths = chunk_args[4]
    ck = lengths.shape[1]
    make = make or (lambda d: fused_inputs(torch, gen, d))
    sets = rotated(chunk_args, lambda: make(dt), (3, 4))
    lmax = lengths.long().max(1).values
    nbytes = (esz * (2 * int(lmax.sum()) * KV * HD + 2 * B * ck * H * HD)
              + 4 * int(((lmax + PAGE - 1) // PAGE).sum()) + 4 * B * ck)
    b_ms, b_by = bound(nbytes, 4 * H * HD * int(lengths.long().sum()), dt)
    out = dict(ms=time_ms(torch, pd.paged_flash_decode_chunk, sets),
               plain_ms=time_ms(torch, pd.paged_flash_decode_chunk_plain,
                                sets, iters=4),
               bound_ms=b_ms, bound_by=b_by,
               device_ms=device_ms(torch, pd.paged_flash_decode_chunk, sets))
    return {f"{prefix}_{k}": v for k, v in out.items()}


def attention_timing(torch, F, fd, fp, dec_inputs, pre_inputs, errs, dt):
    """flash_decode and flash_prefill at the serve shapes in ``dt``: kernel,
    plain and SDPA (the yardstick the port never calls) times, inputs
    rotated through more than 3x the L2 size, beside the bound. Returns
    their two JSON rows, tagged with ``dtype``."""
    esz = torch.tensor([], dtype=dt).element_size()
    name = str(dt)[6:]
    rows = []
    dec_set = dec_inputs(B, KV, H // KV, HD, CAP, dt)
    n_dec = int(3 * L2_BYTES // sum(t.numel() * t.element_size()
                                    for t in dec_set)) + 1
    decs = [dec_set] + [dec_inputs(B, KV, H // KV, HD, CAP, dt)
                        for _ in range(n_dec - 1)]
    sdpa_dec = [(q.reshape(B, H, 1, HD), k, v, bias[:, None, None, :])
                for q, k, v, bias in decs]
    sdpa = (lambda q, k, v, m: F.scaled_dot_product_attention(
        q, k, v, attn_mask=m, enable_gqa=True))
    t_k = time_ms(torch, fd.flash_decode_bkhd, decs)
    t_p = time_ms(torch, fd.flash_decode_plain, decs, iters=20)
    t_l = time_ms(torch, sdpa, sdpa_dec)
    nbytes = esz * (2 * B * H * HD + 2 * B * KV * CAP * HD) + 4 * B * CAP
    b_ms, b_by = bound(nbytes, 4 * B * H * CAP * HD, dt)
    tc = fd.launch_plan(1, H // KV, HD, dt, False)[0]
    rows.append(dict(name="flash_decode", route="cuda", dtype=name,
                     source="src/repro_torch/kernels/csrc/"
                            f"{fd.KERNELS[tc, False][0]}.cu",
                     replaces="src/repro/kernels/flash_decode.py:81",
                     max_abs_err=errs[("decode", dt)], ms=t_k, plain_ms=t_p,
                     bound_ms=b_ms, bound_by=b_by, library_ms=t_l,
                     device_ms=device_ms(torch, fd.flash_decode_bkhd, decs),
                     library_device_ms=device_ms(torch, sdpa, sdpa_dec)))
    pre_set = pre_inputs(B, PROMPT, H, KV, HD, dt)
    n_pre = int(3 * L2_BYTES // sum(t.numel() * t.element_size()
                                    for t in pre_set)) + 1
    pres = [pre_set] + [pre_inputs(B, PROMPT, H, KV, HD, dt)
                        for _ in range(n_pre - 1)]
    sdpa_pre = [(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                 v.transpose(1, 2).contiguous()) for q, k, v in pres]
    sdpa = (lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    t_k = time_ms(torch, fp.flash_prefill_bshd, pres, iters=20)
    t_p = time_ms(torch, fp.flash_prefill_plain, pres, iters=6)
    t_l = time_ms(torch, sdpa, sdpa_pre)
    nbytes = esz * (2 * B * PROMPT * H * HD + 2 * B * PROMPT * KV * HD)
    pairs = PROMPT * (PROMPT + 1) // 2            # causal (query, key) pairs
    b_ms, b_by = bound(nbytes, 4 * B * H * pairs * HD, dt)
    # the kernel the plan picks at this head dim, as the profiler sees it
    # (None: no whole trace, logged)
    seen = kernels_seen(torch, fp.flash_prefill_bshd, pres[0])
    want = fp.launch_plan(HD, dt)[0]
    if seen is not None and (len(seen) != 1 or want not in seen[0]):
        raise AssertionError(f"flash_prefill serve shape {name}: kernels "
                             f"{seen}, planned {want}")
    rows.append(dict(name="flash_prefill", route="cuda", dtype=name,
                     source="src/repro_torch/kernels/csrc/flash_prefill.cu",
                     replaces="src/repro/kernels/flash_prefill.py:88",
                     max_abs_err=errs[("prefill", dt)], ms=t_k, plain_ms=t_p,
                     bound_ms=b_ms, bound_by=b_by, library_ms=t_l,
                     device_ms=device_ms(torch, fp.flash_prefill_bshd, pres),
                     library_device_ms=device_ms(torch, sdpa, sdpa_pre),
                     kernel=seen))
    return rows


def attention_inputs(torch, gen):
    """Input makers for flash_decode (q, k, v, bias; -1e9 on slots C//3 ..
    when masked) and flash_prefill (q, k, v), drawn from ``gen``."""
    dev = torch.device(DEVICE)

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

    return dec_inputs, pre_inputs


def paged_ab(torch, gen):
    """paged_decode of the imported ``repro_torch`` in bf16 (``--ab``): the
    decode form at the serve shape through ``paged_flash_decode_bkhd``, held
    to its plain version and timed; then the fused tick's chunk through one
    layer of ``paged_chunk_prefill_attention`` with the kernels on (the same
    signature in every checkout since the paged engine was ported), held to
    the layer with the kernels off, timed with CUDA events (the whole layer)
    and by the profiler (the paged kernels inside it alone); then the
    decode step at the heads of tinyllama, granite, gemma-2b and
    internvl2-26b (``paged_step_rows``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.models.attention import (init_attention,
                                              paged_chunk_prefill_attention)
    dev, dt = torch.device(DEVICE), torch.bfloat16
    serve = paged_inputs(torch, gen, B, KV, H // KV, HD, PAGE, WIDTH, dt)
    err = check("paged_decode serve shape bfloat16",
                pd.paged_flash_decode_bkhd(*serve),
                pd.paged_flash_decode_plain(*serve), dt)
    rows = [dict(name="paged_decode", shape="decode", max_abs_err=err,
                 **paged_decode_timing(torch, pd, gen, serve))]
    cfg = get_config("tinyllama-1.1b").replace(use_kernels=True)
    p = init_attention(gen, cfg, dt, dev)
    P = B * WIDTH + 1
    table = (torch.randperm(P - 1, generator=gen, device=dev) + 1
             ).reshape(B, WIDTH).to(torch.int32)
    start = torch.randint(PS_SHARED, PROMPT - CK + 1, (B,), generator=gen,
                          device=dev)
    n_valid = torch.full((B,), CK, device=dev)

    def layer_inputs():
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dt)
        return (randn(B, CK, cfg.d_model), randn(KV, P, PAGE, HD),
                randn(KV, P, PAGE, HD))

    def layer(x, kp, vp, c=cfg):
        return paged_chunk_prefill_attention(c, p, x, kp, vp, table, start,
                                             n_valid)[0]

    sets = rotated(layer_inputs(), layer_inputs, ())
    n0 = pd.paged_flash_decode_bkhd.launches
    on = layer(*sets[0])
    per_call = pd.paged_flash_decode_bkhd.launches - n0
    off = layer(*sets[0], c=cfg.replace(use_kernels=False))
    rel = ((on.float() - off.float()).norm() / off.float().norm()).item()
    log(f"  paged chunk layer (fused shape B={B} ck={CK}) kernels on vs off: "
        f"rel err {rel:.3e}  tol {BF16_LOGIT_TOL:.0e}; paged launches per "
        f"call {per_call}")
    if not rel <= BF16_LOGIT_TOL:
        raise AssertionError(f"paged chunk layer: rel err {rel}")
    rows.append(dict(name="paged_decode", shape="fused chunk layer",
                     layer_rel_err=rel, launches_per_call=per_call,
                     layer_ms=time_ms(torch, layer, sets),
                     paged_device_ms=device_ms(torch, layer, sets,
                                               only="paged_"),
                     layer_device_ms=device_ms(torch, layer, sets)))
    return rows + paged_step_rows(torch, fd, pd, gen)


def paged_step_rows(torch, fd, pd, gen):
    """paged_decode's decode step of the imported checkout in bf16 through
    ``paged_flash_decode_bkhd`` at the serve shapes (B 8, 36 pages of 16,
    ragged lengths, one row 0) of tinyllama (G 8 / hd 64), granite (G 3 /
    hd 64), gemma-2b (hd 256), internvl2-26b (G 6 / hd 128) and
    whisper-tiny's heads (G 1 / hd 64, which no paged engine serves: the
    plan's one-row edge): held to
    its plain version, timed beside the bound (K/V below each row's
    length, q, out, the live table entries and the lengths), the kernel
    the profiler sees, and where the checkout plans the tensor-core step
    route the sweep of its splits and tiles (``step_sweep``)."""
    dt, rows = torch.bfloat16, []
    for tag, heads in (("tinyllama", (H, KV, HD)),
                       ("granite", (GRANITE_H, GRANITE_KV, GRANITE_HD)),
                       ("gemma", (GEMMA_H, GEMMA_KV, GEMMA_HD)),
                       ("internvl", (INTERNVL_H, INTERNVL_KV, INTERNVL_HD)),
                       ("whisper", (WHISPER_H, WHISPER_KV, WHISPER_HD))):
        H_, KV_, HD_ = heads
        mk = head_inputs(torch, gen, dt, heads)["paged"]
        first = mk()
        sets = rotated(first, mk, (3, 4))
        label = f"paged_decode {tag} serve shape hd {HD_}"
        fn, plain = pd.paged_flash_decode_bkhd, pd.paged_flash_decode_plain
        err = check(f"{label} bfloat16", fn(*first), plain(*first), dt)
        lengths = first[4].long()
        live = int(lengths.sum())
        row = timed_row(
            torch, fn, plain, sets,
            2 * (2 * live * KV_ * HD_ + 2 * B * H_ * HD_)
            + 4 * int(((lengths + PAGE - 1) // PAGE).sum()) + 4 * B,
            4 * H_ * live * HD_, dt)
        row = dict(name="paged_decode", shape=f"{tag} step", hd=HD_,
                   kernel=kernels_seen(torch, fn, first), max_abs_err=err,
                   **row)
        log(f"  {label}: {row['kernel']}, device {ms4(row['device_ms'])} "
            f"ms, bound {row['bound_ms']:.4f} ({row['bound_by']})")
        if pd.launch_plan(1, H_ // KV_, HD_, dt, False)[0]:
            row["splits_device_ms"] = step_sweep(torch, fd, pd, fn, plain,
                                                 sets, label, HD_)
        rows.append(row)
    return rows


def wide_chunk_ab(torch, fd, gen):
    """Both chunk forms of the imported ``repro_torch`` in bf16 at the fused
    ticks of gemma-2b (hd 256), yi-6b (hd 128) and granite-moe-3b-a800m
    (hd 64, G 3) (``--ab``): timed (``dense_chunk_row``,
    ``paged_chunk_row``) and held to their plain versions, beside the route
    the checkout's ``launch_plan`` picks; at hd 128 and 256 each form on
    the tensor cores also runs ``chunk_splits``, and gemma-2b's paged form
    ``paged_chunk_starts``."""
    from repro_torch.kernels import paged_decode as pd
    rows = []
    for tag, heads in (("gemma", (GEMMA_H, GEMMA_KV, GEMMA_HD)),
                       ("yi", (YI_H, YI_KV, YI_HD)),
                       ("granite", (GRANITE_H, GRANITE_KV, GRANITE_HD))):
        H_, KV_, HD_ = heads
        mk = head_inputs(torch, gen, torch.bfloat16, heads)
        for name, mod, attr, fn, plain, timed in (
                ("flash_decode_chunk", fd, "TC_SPLITS", fd.flash_decode_chunk,
                 fd.flash_decode_chunk_plain, dense_chunk_row),
                ("paged_decode_chunk", pd, "CHUNK_SPLITS",
                 pd.paged_flash_decode_chunk,
                 pd.paged_flash_decode_chunk_plain, paged_chunk_row)):
            row, sets = timed(torch, mod, mk, heads)
            label = f"{name} {tag} fused shape hd {HD_}"
            err = check(f"{label} bfloat16", fn(*sets[0]), plain(*sets[0]),
                        torch.bfloat16)
            tc = mod.launch_plan(CK, H_ // KV_, HD_, torch.bfloat16, True)[0]
            log(f"  {label}: {'tensor' if tc else 'CUDA'} cores, device "
                f"{ms4(row['device_ms'])} ms, bound {row['bound_ms']:.4f}")
            row = dict(name=name, shape=f"{tag} fused", hd=HD_,
                       tensor_cores=tc, max_abs_err=err, **row)
            if HD_ > 64 and tc:
                row["splits_device_ms"] = chunk_splits(
                    torch, mod, attr, fn, plain, sets, label,
                    splits=(1, 2, 3, 4, 6, 8, 9))
            if tag == "gemma" and mod is pd:
                row["starts_device_ms"] = paged_chunk_starts(torch, pd, gen,
                                                             heads)
            rows.append(row)
    return rows


def paged_chunk_starts(torch, pd, gen, heads,
                       starts=(0, 128, 256, 384, 496)):
    """paged_decode's chunk form in bf16 at one config's fused tick with
    every row's chunk at one start, for each of ``starts`` (the fused ticks
    of a chunked 512-token prompt cross them all): device ms by start, the
    first set of each held to the plain version. Returns {start: ms}."""
    H_, KV_, HD_ = heads
    out = {}
    for s0 in starts:
        def make(s0=s0):
            return chunk_inputs(torch, gen, B, KV_, H_ // KV_, HD_, PAGE,
                                WIDTH, WIDTH, CK, torch.bfloat16,
                                start_range=(s0, s0))
        first = make()
        check(f"paged_decode_chunk hd {HD_} chunk at {s0} bfloat16",
              pd.paged_flash_decode_chunk(*first),
              pd.paged_flash_decode_chunk_plain(*first), torch.bfloat16)
        out[s0] = device_ms(torch, pd.paged_flash_decode_chunk,
                            rotated(first, make, (3, 4)))
    log(f"  paged_decode_chunk hd {HD_} device ms by chunk start: "
        + json.dumps(out))
    return out


# --ab's decode-step split sweeps by head dim
STEP_SWEEP = {64: (2, 3, 4, 5, 6, 7, 8), 128: (2, 3, 4, 5, 6, 7, 8),
              256: (2, 4, 6, 8)}


def step_sweep(torch, fd, mod, fn, plain, sets, label, hd):
    """A tensor-core decode step's device time (``mod``: flash_decode or
    paged_decode of the imported checkout, whose ``launch_plan`` and
    launch read ``STEP_SPLITS`` and, where it has one, ``STEP_TILE`` at
    each call) by split count (``STEP_SWEEP[hd]``, ``chunk_splits``), for
    each tile of positions the checkout builds at ``hd``
    (``fd.STEP_TILES``): {tile: {splits: device ms}}, or {splits: device
    ms} in checkouts without tiles."""
    key = hd if isinstance(mod.STEP_SPLITS, dict) else None
    if not hasattr(mod, "STEP_TILE"):
        return chunk_splits(torch, mod, "STEP_SPLITS", fn, plain, sets, label,
                            splits=STEP_SWEEP[hd], key=key)
    keep, out = mod.STEP_TILE, {}
    try:
        for tile in fd.STEP_TILES[hd]:
            mod.STEP_TILE = {**keep, hd: tile}
            out[tile] = chunk_splits(torch, mod, "STEP_SPLITS", fn, plain,
                                     sets, f"{label}, tile {tile}",
                                     splits=STEP_SWEEP[hd], key=key)
    finally:
        mod.STEP_TILE = keep
    return out


def head_step_ab(torch, fd, fp, gen):
    """flash_prefill and flash_decode's decode step of the imported
    ``repro_torch`` in bf16 at gemma-2b's (hd 256), internvl2-26b's (G 6 /
    hd 128), granite's (G 3 / hd 64), tinyllama's (G 8 / hd 64) and
    whisper-tiny's (G 1 / hd 64) serve shapes (``--ab``): held to their
    plain versions and timed (``prefill_row``, ``decode_row``: beside SDPA
    and the bound), with the kernel each checkout launches as the profiler
    sees it (the prefill's must be the one its plan names). At each decode
    step also the device time by split count (and
    tile, ``step_sweep``) where the checkout plans the tensor-core step
    route there, and the yardstick of the tensor-core chunk kernel called
    with ck = 1 (G live rows of its 64) at 4 and 9 splits."""
    bf = torch.bfloat16
    rows = []
    for tag, heads in (("gemma", (GEMMA_H, GEMMA_KV, GEMMA_HD)),
                       ("internvl", (INTERNVL_H, INTERNVL_KV, INTERNVL_HD)),
                       ("granite", (GRANITE_H, GRANITE_KV, GRANITE_HD)),
                       ("tinyllama", (H, KV, HD)),
                       ("whisper", (WHISPER_H, WHISPER_KV, WHISPER_HD))):
        mk = head_inputs(torch, gen, bf, heads)
        for name, timed, mod, fn, plain in (
                ("flash_prefill", prefill_row, fp, fp.flash_prefill_bshd,
                 fp.flash_prefill_plain),
                ("flash_decode", decode_row, fd, fd.flash_decode_bkhd,
                 fd.flash_decode_plain)):
            row, sets = timed(torch, mod, mk, heads, bf)
            label = f"{name} {tag} serve shape hd {heads[2]}"
            err = check(f"{label} bfloat16", fn(*sets[0]), plain(*sets[0]),
                        bf)
            row = dict(name=name, shape=f"{tag} serve", hd=heads[2],
                       kernel=kernels_seen(torch, fn, sets[0]),
                       max_abs_err=err, **row)
            # the prefill kernel the checkout's plan picks, as the profiler
            # sees it (None: no whole trace, logged)
            want = fp.launch_plan(heads[2], bf)[0]
            if name == "flash_prefill" and row["kernel"] is not None and (
                    len(row["kernel"]) != 1 or want not in row["kernel"][0]):
                raise AssertionError(f"{label}: kernels {row['kernel']}, "
                                     f"planned {want}")
            log(f"  {label}: {row['kernel']}, device "
                f"{ms4(row['device_ms'])} ms, SDPA device "
                f"{ms4(row['library_device_ms'])}, bound "
                f"{row['bound_ms']:.4f} ({row['bound_by']})")
            if name == "flash_decode":
                hd, G = heads[2], heads[0] // heads[1]
                if fd.launch_plan(1, G, hd, bf, False)[0]:  # the step route
                    row["splits_device_ms"] = step_sweep(
                        torch, fd, fd, fn, plain, sets, label, hd)
                one = [(q[:, None].contiguous(), k, v, m[:, None].contiguous())
                       for q, k, v, m in sets]
                row["chunk_ck1_device_ms"] = chunk_splits(
                    torch, fd, "TC_SPLITS", fd.flash_decode_chunk,
                    fd.flash_decode_chunk_plain, one,
                    f"{label}, the chunk kernel at ck 1", splits=(4, 9))
            rows.append(row)
    return rows


def ab_phase(torch):
    """flash_decode and flash_prefill of the imported ``repro_torch`` alone
    at the serve shapes, bf16 and fp32: held to their plain versions, then
    timed beside SDPA and the bound; both chunk forms at the wide-head and
    G-3 fused ticks (``wide_chunk_ab``); flash_prefill and the decode step
    at gemma-2b's, internvl2-26b's and granite's serve shapes
    (``head_step_ab``); flash_prefill with a window at hymba-1.5b's heads
    and at hd 32 (``window_ab``); then
    paged_decode's two forms (``paged_ab``) and ssd_scan at both SSM serve
    shapes (``ssd_ab``) (``--ab``: one checkout per process, so a parent
    and a change compare in one call)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    dec_inputs, pre_inputs = attention_inputs(
        torch, torch.Generator(device=DEVICE).manual_seed(0))
    errs, rows = {}, []
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, bias = dec_inputs(B, KV, H // KV, HD, CAP, dt)
        errs[("decode", dt)] = check(
            f"flash_decode serve shape {str(dt)[6:]}",
            fd.flash_decode_bkhd(q, k, v, bias),
            fd.flash_decode_plain(q, k, v, bias), dt)
        q, k, v = pre_inputs(B, PROMPT, H, KV, HD, dt)
        errs[("prefill", dt)] = check(
            f"flash_prefill serve shape {str(dt)[6:]}",
            fp.flash_prefill_bshd(q, k, v), fp.flash_prefill_plain(q, k, v),
            dt)
    for dt in (torch.bfloat16, torch.float32):
        rows += attention_timing(torch, F, fd, fp, dec_inputs, pre_inputs,
                                 errs, dt)
    if hasattr(fd, "flash_decode_chunk"):      # the chunk form's checkouts
        gen = torch.Generator(device=DEVICE).manual_seed(3)
        args = dense_chunk_inputs(torch, gen, B, CK, KV, H // KV, HD, CAP,
                                  torch.bfloat16)
        err = check("flash_decode_chunk fused shape bfloat16",
                    fd.flash_decode_chunk(*args),
                    fd.flash_decode_chunk_plain(*args), torch.bfloat16)
        rows.append(dict(name="flash_decode_chunk", max_abs_err=err,
                         **dense_chunk_timing(torch, F, fd, gen, args)))
        if hasattr(fd, "TC_SPLITS"):           # the tensor-core route's
            rows[-1]["splits_device_ms"] = dense_chunk_splits(torch, fd, gen,
                                                              args)
        rows += wide_chunk_ab(torch, fd, gen)
    rows += head_step_ab(torch, fd, fp,
                         torch.Generator(device=DEVICE).manual_seed(4))
    rows += window_ab(torch, fp, pre_inputs,
                      torch.Generator(device=DEVICE).manual_seed(5))
    return (rows + paged_ab(torch, torch.Generator(device=DEVICE).manual_seed(1))
            + ssd_ab(torch, torch.Generator(device=DEVICE).manual_seed(2)))


def kernel_phase(torch):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models.ssd import ssd_scan_plain
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    dec_inputs, pre_inputs = attention_inputs(torch, gen)

    log("[3] kernels against their plain versions")
    # edge cases, as in tests/test_torch_cuda.py: decode (label, (b, kv, g,
    # hd, C), softcap, -1e9 bias on slots C//3 ..); prefill ((b, s, h, kv,
    # hd), window, softcap)
    dec_edges = (
        ("C=100 softcap=0.0 hd128", (2, 2, 4, 128, 100), 0.0, True),
        ("C=37 softcap=30.0 hd128", (2, 2, 4, 128, 37), 30.0, True),
        ("C=1", (2, 2, 4, HD, 1), 0.0, False),
        (f"C={fd.SPLITS - 3} below the split count",
         (3, 2, 8, HD, fd.SPLITS - 3), 0.0, True),
        ("serve shape, splits wholly under the bias",
         (B, KV, H // KV, HD, CAP), 0.0, True),
        ("C=203 not a multiple of the splits", (4, KV, H // KV, HD, 203),
         0.0, False),
        ("C=300 softcap=30.0 hd128", (2, 2, 8, 128, 300), 30.0, True),
        ("hymba heads G=5", (B, HYMBA_KV, HYMBA_H // HYMBA_KV, HD, CAP), 0.0,
         True))
    pre_edges = tuple(((2, s, 8, 2, HD), 0, 0.0)
                      for s in (1, 15, 16, 17, 40, 127, 128, 129, 255)) + (
        ((2, 127, 15, 5, HD), 0, 0.0),          # G 3 (granite's group)
        ((3, 255, 6, 6, HD), 0, 0.0),           # G 1 (whisper's)
        ((2, 300, 24, 8, HD), 32, 30.0),        # G 3, window, softcap
        ((2, 130, 8, 2, HD), 8, 30.0),
        ((2, 200, 8, 2, HD), 64, 0.0),          # window of one tile
        ((1, 300, 8, 2, HD), 100, 0.0),         # window crossing a tile edge
        ((2, 200, 8, 2, 128), 48, 30.0),        # hd 128, window, softcap
        # hymba-1.5b's heads: GQA group 5; a window that binds, and none
        ((B, PROMPT, HYMBA_H, HYMBA_KV, HD), 256, 0.0),
        ((B, PROMPT, HYMBA_H, HYMBA_KV, HD), 0, 0.0))
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        q, k, v, bias = dec_inputs(B, KV, H // KV, HD, CAP, dtype)
        errs[("decode", dtype)] = check(
            f"flash_decode serve shape {name}",
            fd.flash_decode_bkhd(q, k, v, bias),
            fd.flash_decode_plain(q, k, v, bias), dtype)
        q, k, v = pre_inputs(B, PROMPT, H, KV, HD, dtype)
        errs[("prefill", dtype)] = check(
            f"flash_prefill serve shape {name}",
            fp.flash_prefill_bshd(q, k, v), fp.flash_prefill_plain(q, k, v),
            dtype)
        for label, shape, sc, masked in dec_edges:
            q, k, v, bias = dec_inputs(*shape, dtype, masked=masked)
            check(f"flash_decode {label} {name}",
                  fd.flash_decode_bkhd(q, k, v, bias, softcap=sc),
                  fd.flash_decode_plain(q, k, v, bias, softcap=sc), dtype)
        for (b, s, h, kv, hd), w, sc in pre_edges:
            q, k, v = pre_inputs(b, s, h, kv, hd, dtype)
            check(f"flash_prefill S={s} H/KV={h}/{kv} hd={hd} window={w} "
                  f"softcap={sc} {name}",
                  fp.flash_prefill_bshd(q, k, v, window=w, softcap=sc),
                  fp.flash_prefill_plain(q, k, v, window=w, softcap=sc),
                  dtype)
    errs["dense_chunk"], dense_chunk_args = dense_chunk_checks(torch, fd,
                                                              gen)
    errs["paged"], paged_serve, errs["chunk"], chunk_args = \
        paged_kernel_checks(torch, pd, gen)
    step_route_checks(torch, fd, pd, gen)
    errs["ssd"] = ssd_kernel_checks(torch, ss, ssd_scan_plain, gen)
    narrow = ssd_narrow_rows(torch, ss, ssd_scan_plain, gen)
    verify = verify_shape_checks(torch, fd, pd, gen)
    torch.cuda.synchronize()

    log("    timing at the serve shapes (ms per call, inputs cold); the "
        "JSON line carries bf16")
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        rows += attention_timing(torch, F, fd, fp, dec_inputs, pre_inputs,
                                 errs, dt)
    hy = window_prefill_row(
        torch, fp, lambda: pre_inputs(B, PROMPT, HYMBA_H, HYMBA_KV, HD,
                                      torch.bfloat16), HYMBA_WINDOW)[0]
    log(f"  flash_prefill  bfloat16  hymba-1.5b's heads, window "
        f"{HYMBA_WINDOW}: kernel {hy['ms']:.4f} (device "
        f"{ms4(hy['device_ms'])})  plain {hy['plain_ms']:.4f}  SDPA with a "
        f"boolean mask {hy['library_ms']:.4f} (device "
        f"{ms4(hy['library_device_ms'])})  bound {hy['bound_ms']:.4f} "
        f"({hy['bound_by']})")
    next(r for r in rows if r["name"] == "flash_prefill").update(
        {f"hymba_{k}": v for k, v in hy.items()})
    rows.append(dict(name="flash_decode_chunk", route="cuda",
                     source="src/repro_torch/kernels/csrc/"
                            "flash_decode_chunk.cu",
                     replaces="src/repro/kernels/flash_decode.py:81",
                     max_abs_err=errs["dense_chunk"],
                     **dense_chunk_timing(torch, F, fd, gen,
                                          dense_chunk_args)))
    # the verify shape (B 8, ck SPEC_K + 1, C 576) beside the fused tick's
    e, a = verify[("dense", torch.bfloat16)]
    rows[-1].update(verify_max_abs_err=e, **{
        f"verify_{k}": v for k, v in dense_chunk_timing(
            torch, F, fd, gen, a, kind="verify").items()})
    step = pd.launch_plan(1, H // KV, HD, torch.bfloat16, False)[0]
    rows.append(dict(name="paged_decode", route="cuda",
                     source="src/repro_torch/kernels/csrc/"
                            f"{pd.KERNELS[step, False][0]}.cu",
                     chunk_source="src/repro_torch/kernels/csrc/"
                                  "paged_decode.cu",
                     replaces="src/repro/kernels/paged/decode.py:97",
                     max_abs_err=errs["paged"], library_ms=None,
                     library_device_ms=None,
                     chunk_max_abs_err=errs["chunk"],
                     **paged_decode_timing(torch, pd, gen, paged_serve),
                     **paged_chunk_timing(torch, pd, gen, chunk_args)))
    e, a = verify[("paged", torch.bfloat16)]
    rows[-1].update(verify_max_abs_err=e, **paged_chunk_timing(
        torch, pd, gen, a, prefix="verify", make=lambda d: (
            verify_paged_inputs(torch, gen, SPEC_K + 1, WIDTH, d))))
    ssd = {arch: ssd_timing(torch, ss, ssd_scan_plain, gen, arch)
           for arch in SSD_HEADS}
    hy = ssd["hymba-1.5b"]
    rows.append(dict(name="ssd_scan", route="cuda",
                     source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                     replaces="src/repro/kernels/ssd_scan.py:79",
                     max_abs_err=errs["ssd"], library_ms=None,
                     library_device_ms=None, **ssd["mamba2-130m"],
                     hymba_ms=hy["ms"], hymba_device_ms=hy["device_ms"],
                     hymba_plain_ms=hy["plain_ms"],
                     hymba_bound_ms=hy["bound_ms"],
                     p16n8=narrow))
    for r in rows:
        lib = ("no single library call" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} (device "
               f"{ms4(r['library_device_ms'])})")
        log(f"  {r['name']:<14s} {r.get('dtype', 'bfloat16'):<9s} kernel "
            f"{r['ms']:.4f} (device {ms4(r['device_ms'])})  plain "
            f"{r['plain_ms']:.4f}  library {lib}  bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']})")
        if "hymba_ms" in r:
            log(f"  {'ssd_scan':<14s} {'bfloat16':<9s} kernel "
                f"{r['hymba_ms']:.4f} (device {ms4(r['hymba_device_ms'])})  "
                f"plain {r['hymba_plain_ms']:.4f}  bound "
                f"{r['hymba_bound_ms']:.4f}; hymba-1.5b's heads")
            for arch, t in ssd.items():
                log(f"  ssd_scan device ms by launch, {arch}: "
                    + json.dumps(t["launch_device_ms"]))
        if r["name"] == "flash_decode_chunk":
            tc, n_rows, splits = fd.launch_plan(CK, H // KV, HD,
                                                torch.bfloat16, True)
            log(f"  {'':<14s} the dense fused tick's chunk: B={B} ck={CK} "
                f"C={CAP}, one launch for the reference's {CK} per-token "
                f"calls ({'tensor cores' if tc else 'CUDA cores'}, "
                f"{n_rows} rows x {splits} splits a CTA block); library = "
                f"SDPA with a (B, H, ck, C) float mask")
        if "chunk_ms" in r:
            log(f"  {'paged chunk':<14s} {'bfloat16':<9s} kernel "
                f"{r['chunk_ms']:.4f} (device {ms4(r['chunk_device_ms'])})  "
                f"plain {r['chunk_plain_ms']:.4f}  bound "
                f"{r['chunk_bound_ms']:.4f} ({r['chunk_bound_by']}); "
                f"fused shape B={B} ck={CK}")
        if "verify_ms" in r:
            lib = ("" if r.get("verify_library_ms") is None else
                   f"  library {r['verify_library_ms']:.4f} (device "
                   f"{ms4(r['verify_library_device_ms'])})")
            log(f"  {r['name'][:14]:<14s} {'bfloat16':<9s} verify kernel "
                f"{r['verify_ms']:.4f} (device {ms4(r['verify_device_ms'])})"
                f"  plain {r['verify_plain_ms']:.4f}{lib}  bound "
                f"{r['verify_bound_ms']:.4f} ({r['verify_bound_by']}); "
                f"verify shape B={B} ck={SPEC_K + 1}")
    return [r for r in rows if r.get("dtype", "bfloat16") == "bfloat16"]


def prefill_decode(torch, lm, params, toks, feed=None, extra=None, cap=CAP,
                   steps=8):
    """Prefill (of ``toks`` and the batch entries in ``extra``: an image
    prefix's ``patch_embeds``, an encoder's ``frames``) into a cache of
    ``cap`` + ``steps`` decode steps; feeds ``feed`` tokens when given,
    else its own greedy tokens. Returns (logits list, tokens, (prefill ms,
    decode step ms))."""
    torch.cuda.synchronize()
    t0 = time.time()
    logits, cache = lm.prefill(params, {"tokens": toks, **(extra or {})},
                               max_len=cap)
    torch.cuda.synchronize()
    t1 = time.time()
    outs, seq = [logits], []
    for i in range(steps):
        tok = torch.argmax(logits, -1) if feed is None else feed[i]
        seq.append(tok)
        logits, cache = lm.decode_step(params, cache, tok)
        outs.append(logits)
    torch.cuda.synchronize()
    t2 = time.time()
    return outs, seq, ((t1 - t0) * 1e3, (t2 - t1) * 1e3 / steps)


def paged_prefill_decode(torch, lm, params, toks, feed=None):
    """The same prefill as ``prefill_decode``, scattered into a page pool of
    B*WIDTH+1 shuffled pages (``paged_admit``), then 8 ``decode_step_paged``
    steps over the full 36-page tables. Returns like ``prefill_decode``,
    with paged_decode launches per paged step last."""
    from repro_torch.kernels import paged_decode as pd
    dev = toks.device
    torch.cuda.synchronize()
    t0 = time.time()
    logits, pref = lm.prefill(params, {"tokens": toks}, max_len=PROMPT)
    cache = lm.init_paged_cache(B, B * WIDTH + 1, PAGE, WIDTH, dev)
    perm = torch.randperm(B * WIDTH, device=dev,
                          generator=torch.Generator(device=dev)
                          .manual_seed(2)) + 1
    lm.paged_admit(cache, pref, torch.zeros(B, dtype=torch.int64,
                                            device=dev),
                   torch.argmax(logits, -1), perm.reshape(B, WIDTH),
                   torch.arange(B, device=dev))
    torch.cuda.synchronize()
    t1 = time.time()
    n0 = pd.paged_flash_decode_bkhd.launches
    outs, seq = [logits], []
    for i in range(8):
        tok = torch.argmax(logits, -1) if feed is None else feed[i]
        seq.append(tok)
        logits, cache = lm.decode_step_paged(params, cache, tok,
                                             n_pages=WIDTH)
        outs.append(logits)
    torch.cuda.synchronize()
    t2 = time.time()
    per_step = (pd.paged_flash_decode_bkhd.launches - n0) / 8
    return outs, seq, ((t1 - t0) * 1e3, (t2 - t1) * 1e3 / 8, per_step)


def rel_err(xs, ys, vocab):
    """Largest ||x - y|| / ||y|| over pairs of logits, over the real vocab
    (the padded entries carry the -1e9 mask, which would swamp the norm)."""
    return max(((a[..., :vocab].float() - b[..., :vocab].float()).norm()
                / b[..., :vocab].float().norm()).item()
               for a, b in zip(xs, ys))


def _tree_float(tree):
    """A params tree with every leaf in fp32."""
    if isinstance(tree, dict):
        return {k: _tree_float(v) for k, v in tree.items()}
    return tree.float()


def model_phase(torch):
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    dev = torch.device(DEVICE)
    log("[4] model: full-width tinyllama-1.1b, kernels on vs off")
    cfg = get_config("tinyllama-1.1b")
    toks = torch.randint(0, cfg.vocab_size, (B, PROMPT), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))

    def run(lm, params, feed=None):
        return prefill_decode(torch, lm, params, toks, feed)

    def run_paged(lm, params, feed=None):
        return paged_prefill_decode(torch, lm, params, toks, feed)

    lm_off = LM(cfg)
    lm_on = LM(cfg.replace(use_kernels=True))
    params = lm_off.init(torch.Generator(device=dev).manual_seed(0))
    run(lm_on, params)                                   # warm-up
    run_paged(lm_on, params)
    off, seq, t_off = run(lm_off, params)
    on, _, t_on = run(lm_on, params, feed=seq)
    paged, _, t_pg = run_paged(lm_on, params, feed=seq)
    rel = rel_err(on, off, cfg.vocab_size)
    rel_pg = rel_err(paged, on, cfg.vocab_size)
    finite = all(bool(torch.isfinite(a).all()) for a in on + paged)
    log(f"  L22 bf16: logits rel err (on vs off) {rel:.3e}, (paged vs dense, "
        f"kernels on) {rel_pg:.3e}  tol {BF16_LOGIT_TOL:.0e}  finite {finite}")
    log(f"  L22 bf16 B={B} S={PROMPT}: prefill ms on {t_on[0]:.2f} off "
        f"{t_off[0]:.2f}; decode step ms on {t_on[1]:.2f} off {t_off[1]:.2f}"
        f" paged {t_pg[1]:.2f} (prefill + paged_admit {t_pg[0]:.2f}); "
        f"paged_decode launches per paged step {t_pg[2]:g}")
    if not (finite and rel <= BF16_LOGIT_TOL and rel_pg <= BF16_LOGIT_TOL):
        raise AssertionError(f"bf16 logits disagree: rel err {rel} "
                             f"(kernels), {rel_pg} (paged)")
    del params, on, off, paged
    cfg32 = cfg.replace(num_layers=4, dtype="float32", name="tinyllama-L4-f32")
    lm_off, lm_on = LM(cfg32), LM(cfg32.replace(use_kernels=True))
    params = lm_off.init(torch.Generator(device=dev).manual_seed(0))
    _, seq_off, _ = run(lm_off, params)
    _, seq_on, _ = run(lm_on, params)
    _, seq_pg, _ = run_paged(lm_on, params)
    same = all(bool((a == b).all()) for a, b in zip(seq_on, seq_off))
    same_pg = all(bool((a == b).all()) for a, b in zip(seq_pg, seq_on))
    log(f"  L4 fp32: greedy 8 tokens x {B} rows identical on vs off: {same};"
        f" paged vs dense: {same_pg}")
    if not (same and same_pg):
        raise AssertionError("fp32 greedy tokens differ: kernels on/off "
                             f"{same}, paged/dense {same_pg}")
    del params
    torch.cuda.empty_cache()
    return {"prefill_ms_on": t_on[0], "prefill_ms_off": t_off[0],
            "decode_step_ms_on": t_on[1], "decode_step_ms_off": t_off[1],
            "decode_step_ms_paged": t_pg[1], "paged_launches_per_step": t_pg[2],
            "logits_rel_err": rel,
            "paged_logits_rel_err": rel_pg}


def ssm_model_phase(torch):
    """Full-width mamba2-130m (L24) and hymba-1.5b (L32): prefill B x
    PROMPT plus 8 decode steps, kernels on vs off, in bf16 and on the same
    weights in fp32 (every ssd_scan launch accounted for); mamba2-130m L4
    fp32 must give identical greedy tokens on and off.

    Checks: the fp32 logits on vs off within FP32_LOGIT_TOL (the kernels'
    correctness at full width); the bf16 kernels-on logits no farther from
    the fp32 logits than BF16_VS_PLAIN times the bf16 plain path's own
    distance (the kernels add no error beyond bf16 rounding); mamba2's bf16
    on/off gap within BF16_LOGIT_TOL. hymba-1.5b's bf16 on/off gap is
    printed, not held to BF16_LOGIT_TOL: over 32 layers of two mixers bf16
    rounding alone moves its logits about that far from the fp32 logits
    (the line prints both distances)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import LM
    dev = torch.device(DEVICE)
    out = {}
    for arch in ("mamba2-130m", "hymba-1.5b"):
        cfg = get_config(arch)
        V, L = cfg.vocab_size, cfg.num_layers
        log(f"[4] model: full-width {arch} (L{L}), kernels on vs off")
        toks = torch.randint(0, V, (B, PROMPT), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(1))
        lm_off, lm_on = LM(cfg), LM(cfg.replace(use_kernels=True))
        params = lm_off.init(torch.Generator(device=dev).manual_seed(0))
        prefill_decode(torch, lm_on, params, toks)          # warm-up
        off, seq, t_off = prefill_decode(torch, lm_off, params, toks)
        ops.reset_launch_counts()
        on, _, t_on = prefill_decode(torch, lm_on, params, toks, feed=seq)
        launches = ops.launch_counts()
        # the same weights in fp32 (bf16-stored matrices widened exactly)
        c32 = cfg.replace(dtype="float32")
        p32 = _tree_float(params)
        ref, _, _ = prefill_decode(torch, LM(c32), p32, toks, feed=seq)
        on32, _, _ = prefill_decode(torch, LM(c32.replace(use_kernels=True)),
                                    p32, toks, feed=seq)
        rel = rel_err(on, off, V)
        rel32 = rel_err(on32, ref, V)
        d_on, d_off = rel_err(on, ref, V), rel_err(off, ref, V)
        finite = all(bool(torch.isfinite(a).all()) for a in on)
        log(f"  L{L} fp32: logits rel err (on vs off) {rel32:.3e}  tol "
            f"{FP32_LOGIT_TOL:.0e}")
        log(f"  L{L} bf16: logits rel err (on vs off) {rel:.3e}"
            f"{f'  tol {BF16_LOGIT_TOL:.0e}' if arch == 'mamba2-130m' else ''}"
            f"; from the fp32 logits: on {d_on:.3e}, off {d_off:.3e} (on "
            f"within {BF16_VS_PLAIN:g} x off)  finite {finite}; launches "
            f"{launches}")
        log(f"  L{L} bf16 B={B} S={PROMPT}: prefill ms on {t_on[0]:.2f} off "
            f"{t_off[0]:.2f}; decode step ms on {t_on[1]:.2f} off "
            f"{t_off[1]:.2f}")
        want = {"ssd_scan": L}                      # one per layer per prefill
        if cfg.family == "hybrid":
            want.update(flash_prefill=L, flash_decode=8 * L)
        if not (finite and rel32 <= FP32_LOGIT_TOL
                and d_on <= BF16_VS_PLAIN * d_off
                and (arch != "mamba2-130m" or rel <= BF16_LOGIT_TOL)) or any(
                launches[k] != v for k, v in want.items()):
            raise AssertionError(f"{arch}: fp32 rel err {rel32}, bf16 rel "
                                 f"err {rel} (from fp32: on {d_on}, off "
                                 f"{d_off}), finite {finite}, launches "
                                 f"{launches} (want {want})")
        out[arch] = {"prefill_ms_on": t_on[0], "prefill_ms_off": t_off[0],
                     "decode_step_ms_on": t_on[1],
                     "decode_step_ms_off": t_off[1], "logits_rel_err": rel,
                     "fp32_logits_rel_err": rel32}
        del params, p32, on, off, ref, on32
        torch.cuda.empty_cache()
    cfg32 = get_config("mamba2-130m").replace(num_layers=4, dtype="float32",
                                              name="mamba2-L4-f32")
    lm_off, lm_on = LM(cfg32), LM(cfg32.replace(use_kernels=True))
    params = lm_off.init(torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg32.vocab_size, (B, PROMPT), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    _, seq_off, _ = prefill_decode(torch, lm_off, params, toks)
    _, seq_on, _ = prefill_decode(torch, lm_on, params, toks)
    same = all(bool((a == b).all()) for a, b in zip(seq_on, seq_off))
    log(f"  mamba2-130m L4 fp32: greedy 8 tokens x {B} rows identical on vs "
        f"off: {same}")
    if not same:
        raise AssertionError("mamba2-130m fp32 greedy tokens differ kernels "
                             "on vs off")
    del params
    torch.cuda.empty_cache()
    return out


def profiled(torch, fn):
    """(device ms, kernels) of one call of ``fn`` from ``torch.profiler``:
    every kernel it ran, a graph replay's included."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.key_averages()
           if e.device_type == cuda and e.self_device_time_total > 0]
    return (sum(e.self_device_time_total for e in evs) / 1e3,
            sum(e.count for e in evs))


def graph_drive(torch, b, prompts, engine):
    """Drive one backend through the serve path's steps and time them:
    the prefill step alone, then B requests of ``prompts`` — admitted into
    the dense ring ("dense"); on the paged backend bound for chunked
    prefill so every row advances one CK-token chunk per fused tick
    ("paged"); or on the dense backend with the chunked machinery
    ("dense-chunked"), row i right-sized to its first PROMPT - 32 i tokens,
    so rows finish prefilling at different fused ticks and then decode
    riding the fused tick — and decode ticks until all finish. Each timed
    call ends in a host read or a synchronise; CUDA events around it give
    its span on the stream (first to last work enqueued: kernels plus the
    gaps between them); the second call of each kind runs under the
    profiler instead. Returns ({kind: {wall_ms, span_ms, device_ms,
    kernels, port_launches, launches, steps}} per step, outputs, cache
    leaves and cur_tok)."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serving.api import Request
    out = {}

    def timed(kind, fn, calls, steps):
        walls, spans, port = [], [], {}
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        for i in range(calls):
            if i == 1:
                dev_ms, kern = profiled(torch, fn)
                continue
            n0 = ops.launch_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            ev0.record()
            fn()
            ev1.record()
            torch.cuda.synchronize()
            walls.append((time.time() - t0) * 1e3)
            spans.append(ev0.elapsed_time(ev1))
            port = {k: (c - n0[k]) / steps
                    for k, c in ops.launch_counts().items() if c != n0[k]}
        out[kind] = dict(wall_ms=float(np.median(walls)) / steps,
                         span_ms=float(np.median(spans)) / steps,
                         device_ms=dev_ms / steps, kernels=kern / steps,
                         port_launches=sum(port.values()), launches=port,
                         steps=steps)

    tokens = b._host(prompts)
    timed("prefill", lambda: b._step("prefill", B, tokens=tokens), 4, 1)
    cut = 32 if engine == "dense-chunked" else 0
    reqs = [Request(rid=i, tokens=prompts[i][:PROMPT - cut * i],
                    max_new=b.max_new, arrival=time.time())
            for i in range(B)]
    if engine == "dense":
        b.admit(reqs, 0.0)
    else:
        b.admit_chunked(reqs, 0.0)
        timed("fused", lambda: b.fused_chunk_step(0.0), PROMPT // CK, 1)
        if b._prefilling:
            raise AssertionError(f"{b.name}: rows still prefilling")
    ticks = -(-(b.max_new - 1) // CHUNK)
    timed("decode", lambda: b.decode_step_batch(0.0), ticks, CHUNK)
    if b.active_slots:
        raise AssertionError(f"{b.name}: {b.active_slots} rows still live")
    state = {**{k: t.clone() for k, t in b.cache.items()},
             "cur_tok": b.cur_tok.clone()}
    return out, {r.rid: r.output for r in reqs}, state


def graph_arch(torch, arch, max_new, engines, depth=None):
    """``graph_phase``'s comparison for one architecture at full width over
    the given engines ("dense", "paged", "dense-chunked"), at its published
    depth or at ``depth`` layers. Returns {"<arch> L<layers> <engine>":
    summary}."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.serving.engine import PagedVariantBackend, VariantBackend
    dev = torch.device(DEVICE)
    summary = {}
    cfg = get_config(arch).replace(use_kernels=True)
    if depth:
        cfg = cfg.replace(num_layers=depth)
    params = LM(cfg).init(torch.Generator(device=dev).manual_seed(0))
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                                (B, PROMPT))
    for engine in engines:
        paged = engine == "paged"
        runs = {}
        for path in ("eager", "replay"):
            kw = dict(page_size=PAGE, prefix_sharing=True) if paged \
                else dict(chunked=engine == "dense-chunked")
            cls = PagedVariantBackend if paged else VariantBackend
            b = cls(f"{arch}-{engine}-{path}", cfg, 0.0, max_batch=B,
                    prompt_len=PROMPT, max_new=max_new,
                    decode_chunk=CHUNK, use_kernels=True, device=DEVICE,
                    params=params, prefill_chunk_tokens=CK,
                    step_graphs=path == "replay", **kw)
            steps, outs, state = graph_drive(torch, b, prompts, engine)
            runs[path] = (steps, outs, state, b.readiness_s)
            b.close()
            del b
        (e_steps, e_outs, e_state, e_rt), (r_steps, r_outs, r_state,
                                            r_rt) = runs["eager"], \
            runs["replay"]
        same_tok = all(np.array_equal(e_outs[i], r_outs[i])
                       for i in e_outs)
        # the pool's trash page 0 takes colliding writes of inert rows
        # in scatter order on either path, and no live row reads it
        cut = {k: (lambda t: t[:, :, 1:]) if k in ("kp", "vp")
               else (lambda t: t) for k in e_state}
        diff = {k: float((cut[k](r_state[k]).float()
                          - cut[k](e_state[k]).float()).abs().max())
                for k in e_state
                if not torch.equal(cut[k](r_state[k]),
                                   cut[k](e_state[k]))}
        name = f"{arch} L{cfg.num_layers} {engine}"
        log(f"  {name}: readiness eager {e_rt:.3f}s, replay {r_rt:.3f}s;"
            f" tokens equal {same_tok}; cache leaves differing "
            f"{diff or 'none'}")
        for kind, e in e_steps.items():
            r = r_steps[kind]
            log(f"    {kind:<8s} per step: eager wall {e['wall_ms']:.3f}"
                f" ms, span {e['span_ms']:.3f}, device "
                f"{e['device_ms']:.3f}, {e['kernels']:g} kernels "
                f"({e['port_launches']:g} port); replay wall "
                f"{r['wall_ms']:.3f} ms, span {r['span_ms']:.3f}, "
                f"device {r['device_ms']:.3f}, {r['kernels']:g} kernels "
                f"({r['port_launches']:g} port)")
            if r["launches"] != e["launches"]:
                raise AssertionError(f"{name} {kind}: port launches per "
                                     f"step {r['launches']} replayed, "
                                     f"{e['launches']} eager")
            if engine == "dense-chunked" and kind == "fused" and \
                    r["launches"] != {"flash_decode_chunk":
                                      cfg.num_layers}:
                raise AssertionError(
                    f"{name}: launches per dense fused tick "
                    f"{r['launches']}, want one flash_decode_chunk per "
                    f"layer ({cfg.num_layers})")
        if not same_tok or diff:
            raise AssertionError(f"{name}: replay differs from eager "
                                 f"(tokens equal {same_tok}, cache "
                                 f"leaves {diff})")
        summary[name] = {"readiness_s": {"eager": e_rt, "replay": r_rt},
                         "eager": e_steps, "replay": r_steps}
    del params
    torch.cuda.empty_cache()
    return summary


def graph_phase(torch):
    """Replays against the eager steps at full width (bf16, kernels on),
    through the engine's backends on shared weights, one replaying CUDA
    graphs and one op by op (``step_graphs=False``), fed the same requests:
    tinyllama-1.1b L22 on the dense engine (decode step), on the paged
    engine with prefix sharing (fused tick, every row prefilling; paged
    decode step) and on the dense engine with the chunked machinery (the
    dense fused tick: all 8 rows prefilling, then decode riding it; one
    flash_decode_chunk launch per layer per tick), mamba2-130m L24
    (prefill, decode step) and hymba-1.5b L32 (decode step). Per-request
    tokens and every cache leaf must be bitwise equal, and the port's
    kernel launches per step equal, kernel by kernel. Prints
    wall ms per step (host clock, device synchronised), span ms (CUDA
    events around the call), device ms and kernels per step
    (``torch.profiler``), and each backend's readiness
    (the replaying one's includes its captures)."""
    log("[5] graphs: full-width steps replayed vs eager, bf16, kernels on")
    summary = {}
    for arch, max_new, engines in (
            ("tinyllama-1.1b", MAX_NEW, ("dense", "paged", "dense-chunked")),
            ("mamba2-130m", 2 * CHUNK, ("dense",)),
            ("hymba-1.5b", 2 * CHUNK, ("dense",))):
        summary.update(graph_arch(torch, arch, max_new, engines))
    log("  graph summary " + json.dumps(summary))
    return summary


def mapped_pages(engine):
    """Each paged backend's pool checked for consistency; returns the pages
    still mapped per backend (none after a drain)."""
    for b in engine.backends.values():
        b.pool.assert_invariants()
    return {n: b.pool.used_pages for n, b in engine.backends.items()
            if b.pool.used_pages}


def serve_phase(torch, paged=False, profiles=None, arch="tinyllama-1.1b",
                engine_kw=None, seconds=SERVE_SECONDS, close=False,
                forecaster=None):
    """The InfAdapter loop on the dense engine (calibrating the ladder's
    profiles first), or on the paged engine with prefix sharing using the
    given dense profiles, over ``arch``'s full-width ladder; ``engine_kw``
    adds engine options (the async tick, a scheduler, preemption: the
    engine then stamps requests on the loop's elapsed clock, which its
    deadlines are read against) and ``seconds`` sets the loop's length.
    With ``close`` every backend is retired (closed) after the loop, and
    the card's ``memory_allocated`` after a collection must be back at the
    loop's start within CLOSE_MARGIN (``close_engine``). ``forecaster``
    replaces the controller's ``MovingMaxForecaster(window=10)``. Every
    load prints its readiness and ``memory_allocated``. Returns (this
    phase's launch counts, profiles)."""
    from repro_torch.configs import get_config
    from repro_torch.core.adapter import ControllerConfig, InfAdapterController
    from repro_torch.core.forecaster import MovingMaxForecaster
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import (GEOMETRY, LOAD, build_ladder,
                                          calibrate)
    from repro_torch.serving.driver import (ElapsedClock, rise_fall_load,
                                            run_serving_loop)
    from repro_torch.serving.engine import InProcessServingEngine
    kind = f"{arch}, " + ("paged + prefix sharing" if paged else "dense")
    engine_kw = dict(engine_kw or {})
    if engine_kw:
        kind += ", " + ", ".join(f"{k}={v}" for k, v in engine_kw.items())
        engine_kw["clock"] = ElapsedClock()
    log(f"[6] serve ({kind}): InfAdapter loop, full-width ladder, kernels "
        f"on, steps replayed as CUDA graphs")
    variants = build_ladder(arch, full_width=True)
    geo = GEOMETRY[True]
    kv = dict(kv_cache="paged", kv_page_size=PAGE,
              kv_prefix_sharing=True) if paged else {}
    base = settled_memory(torch) if close else None
    engine = InProcessServingEngine(variants, use_kernels=True,
                                    device=DEVICE, **geo, **kv, **engine_kw)
    loads = []                 # (variant, readiness s) of every load
    make = engine._make_backend

    def make_logged(name):
        b = make(name)
        loads.append((name, b.readiness_s))
        drafter = "" if b._spec_pair is None else (
            f"; drafter {b._spec_pair.d.name}: readiness "
            f"{b._spec_pair.d.readiness_s:.3f}s "
            f"({len(b._spec_pair.d.graphs)} step graphs)")
        log(f"  loaded {name}: readiness {b.readiness_s:.3f}s "
            f"({len(b.graphs)} step graphs){drafter}; memory_allocated "
            f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
        return b
    engine._make_backend = make_logged
    if profiles is None:
        profiles = calibrate(engine, variants, reps=2,
                             max_new=geo["max_new"])
    else:
        log("  profiles: calibrated on the plain dense engine of this ladder "
            "and geometry")
    for n, p in profiles.items():
        log(f"  {n}: rt {p.rt:.3f}s  {p.th_slope:.2f} rps/unit  "
            f"p(1) {p.p99_ms(1):.0f} ms")
    slo_ms = 5000.0
    ctrl = InfAdapterController(
        profiles, forecaster or MovingMaxForecaster(window=10),
        ControllerConfig(interval_s=5.0, budget=3, slo_ms=slo_ms, beta=0.05,
                         gamma=0.05, reactive=True, queue_aware=True))
    vocab = next(iter(variants.values()))[0].vocab_size
    ops.reset_launch_counts()
    t0 = time.time()
    n_sub = run_serving_loop(engine, ctrl, seconds=seconds,
                             interval=5.0,
                             load_fn=rise_fall_load(seconds, *LOAD[True]),
                             prompt_len=geo["prompt_len"],
                             max_new=geo["max_new"], vocab=vocab,
                             slo_ms=slo_ms if engine_kw else 0.0, log=log)
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
    if get_config(arch).family == "ssm":      # attention-free
        need = ("ssd_scan",)
    elif engine_kw.get("scheduler") == "chunked":   # prefill in chunks only
        need = ("paged_decode",) if paged else ("flash_decode_chunk",
                                                "flash_decode")
    else:
        need = ("flash_prefill", "paged_decode" if paged else "flash_decode")
    spec = engine_kw.get("speculative")
    if spec is not None:    # the verify runs flash_decode's chunk form
        verifier = spec.split(":")[1]
        if verifier not in {n for n, _ in loads}:
            raise AssertionError(f"the controller never loaded the "
                                 f"verifier {verifier}: {loads}")
        need += ("flash_decode_chunk",)
        if not engine.metrics.value("spec.rounds") > 0:
            raise AssertionError(f"{kind}: no speculative round ran")
    if min(launches[k] for k in need) < 1:
        raise AssertionError(f"a kernel of the {kind} path never ran in its "
                             f"serve phase: {launches}")
    summary = {"arch": arch, "kv_cache": "paged" if paged else "dense",
               "n_submitted": n_sub, "n_requests": s["n_requests"],
               "rejected": s["rejected"], "p50_ms": s["p50_ms"],
               "avg_cost_units": s["avg_cost_units"],
               "accuracy_loss": s["accuracy_loss"], "slo_ms": slo_ms,
               "wall_s": wall, "launches": launches, "loads": loads,
               "decisions": len(ctrl.decisions),
               "options": {k: v for k, v in engine_kw.items()
                           if k != "clock"},
               "preempted": int(engine.metrics.value("requests.preempted"))}
    if spec is not None:
        summary.update({k: engine.metrics.value(k) for k in (
            "spec.batch_rounds", "spec.rounds", "spec.committed_tokens",
            "spec.drafts_accepted", "spec.drafts_proposed")},
            spec_accept_rate=s.get("spec_accept_rate"),
            spec_tokens_per_step=s.get("spec_tokens_per_step"))
    summary.update(tail_fields(s))
    if paged:
        mapped = mapped_pages(engine)
        if mapped:
            raise AssertionError(f"pages still mapped after the drain: "
                                 f"{mapped}")
        summary["kv_pool"] = engine.kv_pool_stats()
        summary["readiness_s"] = {n: b.readiness_s
                                  for n, b in engine.backends.items()}
    else:
        summary["readiness_s"] = {n: p.rt for n, p in profiles.items()}
    # (no loop over backends in this frame: its variable would keep the
    # last backend, weights and cache, alive past the close below)
    busy = [n for n, b in engine.backends.items()
            if b._pending is not None or b._uncommitted_done
            or b.active_slots]
    if busy:
        raise AssertionError(f"{busy}: uncommitted work after the drain")
    log(f"  serve summary ({kind}) " + json.dumps(summary))
    if close:
        log(f"  {kind}: served {s['n_requests']}, rejected "
            f"{s['rejected']}, {len(ctrl.decisions)} decisions; "
            f"memory_allocated after close "
            f"{close_engine(torch, engine, base) / 1e9:.3f} GB (at the "
            f"loop's start {base / 1e9:.3f})")
    del engine
    torch.cuda.empty_cache()
    return launches, profiles


def prefix_phase(torch):
    """The reference's shared-system-prompt study (benchmarks/bench_engine.py
    prefix_sharing) at full width: the same staggered workload on a
    sharing-on and a sharing-off paged engine. Returns the launch counts of
    the bf16 runs."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.serving.api import Request
    from repro_torch.serving.engine import InProcessServingEngine
    log(f"[7] prefix: {PS_N} staggered {PROMPT}-token requests over a "
        f"{PS_SHARED}-token shared prefix, every 4th an exact repeat")
    cfg = get_config("tinyllama-1.1b")
    rng = np.random.default_rng(23)
    prefix = rng.integers(0, cfg.vocab_size, PS_SHARED)
    prompts = []
    for i in range(PS_N):
        if i % 4 == 3:                       # an exact earlier prompt: CoW
            prompts.append(prompts[int(rng.integers(i))].copy())
        else:
            prompts.append(np.concatenate([prefix, rng.integers(
                0, cfg.vocab_size, PROMPT - PS_SHARED)]))

    def serve(c, sharing):
        eng = InProcessServingEngine(
            {c.name: (c, 78.0)}, max_batch=B, prompt_len=PROMPT,
            max_new=MAX_NEW, decode_chunk=CHUNK, queue_cap=1000,
            kv_cache="paged", kv_page_size=PAGE, kv_prefix_sharing=sharing,
            use_kernels=True, device=DEVICE)
        eng.apply_allocation(0.0, {c.name: 1})
        b = eng.backends[c.name]
        ticks = {"fused": [0, 0.0, 0], "decode": [0, 0.0, 0]}

        def timed(fn, kind):
            """Count and time each tick kind that runs (the sync tick ends
            in a host read of its tokens, so the host clock covers the
            device work), with the paged kernel launches it made."""
            def tick(now):
                if not b.active_slots:
                    return fn(now)
                n0 = pd.paged_flash_decode_bkhd.launches
                t = time.time()
                out = fn(now)
                rec = ticks[kind]
                rec[0] += 1
                rec[1] += time.time() - t
                rec[2] += pd.paged_flash_decode_bkhd.launches - n0
                return out
            return tick

        b.fused_chunk_step = timed(b.fused_chunk_step, "fused")
        b.decode_step_batch = timed(b.decode_step_batch, "decode")
        torch.cuda.synchronize()
        t0 = time.time()
        for i, p in enumerate(prompts):      # one arrival per tick
            eng.submit(Request(rid=i, tokens=p, max_new=MAX_NEW,
                               arrival=time.time()), c.name)
            eng.step(0.0)
        eng.drain(0.0)
        torch.cuda.synchronize()
        wall = time.time() - t0
        b.pool.assert_invariants()
        outs = {r.rid: r.output for r in eng.done}
        if len(outs) != PS_N or b.pool.used_pages or any(
                len(o) != MAX_NEW for o in outs.values()):
            raise AssertionError(f"prefix phase (sharing={sharing}): "
                                 f"{len(outs)}/{PS_N} complete, "
                                 f"{b.pool.used_pages} pages still mapped")
        stats = eng.kv_pool_stats()
        stats.update(prefill_tokens=b.prefill_tokens_total,
                     cow_copies=int(eng.metrics.value("kv.cow_copies")),
                     makespan_s=wall, readiness_s=b.readiness_s)
        for kind, (n, sec, launches) in ticks.items():
            stats[f"{kind}_ticks"] = n
            stats[f"{kind}_tick_ms"] = sec * 1e3 / max(n, 1)
            stats[f"paged_launches_per_{kind}_tick"] = launches / max(n, 1)
        del eng, b
        torch.cuda.empty_cache()
        return outs, stats

    def study(c):
        ops.reset_launch_counts()
        on, s_on = serve(c, True)
        launches = ops.launch_counts()
        off, s_off = serve(c, False)
        agree = sum(int((on[i] == off[i]).sum()) for i in on)
        log(f"  {c.name}: sharing on {json.dumps(s_on)}")
        log(f"  {c.name}: sharing off {json.dumps(s_off)}")
        log(f"  {c.name}: prefill tokens off/on {s_off['prefill_tokens']}/"
            f"{s_on['prefill_tokens']}; tokens agreeing on vs off "
            f"{agree}/{PS_N * MAX_NEW}; launches with sharing on {launches}")
        if not (s_on["prefix_hits"] > 0 and s_on["cow_copies"] > 0
                and s_on["prefill_tokens"] < s_off["prefill_tokens"]):
            raise AssertionError(f"{c.name}: prefix sharing did not engage "
                                 f"(hits {s_on['prefix_hits']}, CoW "
                                 f"{s_on['cow_copies']}, prefill tokens "
                                 f"{s_on['prefill_tokens']} vs "
                                 f"{s_off['prefill_tokens']})")
        if min(launches["flash_prefill"], launches["paged_decode"]) < 1:
            raise AssertionError(f"a kernel of the prefix path never ran: "
                                 f"{launches}")
        # one chunk launch per layer per fused tick; one decode launch per
        # layer per step, CHUNK steps per decode tick
        want = {"fused": c.num_layers, "decode": CHUNK * c.num_layers}
        got = {k: s_on[f"paged_launches_per_{k}_tick"] for k in want}
        if got != want:
            raise AssertionError(f"{c.name}: paged launches per tick {got}, "
                                 f"want {want}")
        return agree, launches

    _, launches = study(cfg.replace(name="tinyllama-1.1b-L22"))
    agree, _ = study(cfg.replace(num_layers=4, dtype="float32",
                                 name="tinyllama-L4-f32"))
    if agree != PS_N * MAX_NEW:
        raise AssertionError(f"fp32 tokens differ with sharing on vs off: "
                             f"{agree}/{PS_N * MAX_NEW} agree")
    return launches


def async_requests(vocab, n=AS_N, seed=31):
    """The async phase's fixed request list: ``n`` prompts of PROMPT tokens,
    every other one over a shared PS_SHARED-token prefix (the paged
    engine's prefix hits), budgets 8..40 tokens, 30 ms SLOs on even rids
    (hopeless a tick after arrival on the fake clock, so EDF preemption
    fires) and 1e6 ms on odd ones. Returns [(tokens, max_new, slo_ms)]."""
    import numpy as np
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, PS_SHARED)
    out = []
    for i in range(n):
        if i % 2:
            toks = np.concatenate([prefix, rng.integers(
                0, vocab, PROMPT - PS_SHARED)])
        else:
            toks = rng.integers(0, vocab, PROMPT)
        out.append((toks, int(rng.integers(8, 41)),
                    30.0 if i % 2 == 0 else 1e6))
    return out


def async_serve(torch, cfg, params, reqs, engine_kw, inspect=None):
    """One engine of ``cfg`` alone (``ladder_serve``)."""
    return ladder_serve(torch, {cfg.name: (cfg, 78.0)}, {cfg.name: params},
                        cfg.name, reqs, engine_kw, inspect)


def ladder_serve(torch, variants, weights, target, reqs, engine_kw,
                 inspect=None):
    """One engine of ``variants`` on ``weights`` (kernels on, steps
    replayed) serving ``target`` on a fake clock that advances 50 ms a
    tick: a request arrives per tick, then ticks until every queue and
    slot is empty; every pool (a speculative drafter's mirror included)
    must end empty and consistent. Returns (rid -> tokens, stats: ticks,
    wall ms per tick (host clock, device synchronised at the end only, as
    a serving loop runs), mean hidden host ms and commit_wait_ms per tick,
    preemptions, launches, and with ``speculative`` the spec counters and
    rates; ``inspect(engine)``'s result under "inspect" when given)."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serving.api import Request
    from repro_torch.serving.engine import InProcessServingEngine
    t = [0.0]
    eng = InProcessServingEngine(
        variants, max_batch=B, prompt_len=PROMPT,
        max_new=MAX_NEW, decode_chunk=CHUNK, prefill_chunk=CK,
        queue_cap=1000, use_kernels=True, device=DEVICE,
        weights=weights, clock=lambda: t[0], **engine_kw)
    eng.apply_allocation(0.0, {target: 1})
    b = eng.backends[target]
    waits, hidden = [], []
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0, ticks = time.time(), 0

    def tick():
        eng.step(t[0])
        t[0] += 0.05
        if b.commit_wait_ms == b.commit_wait_ms:         # not NaN
            waits.append(b.commit_wait_ms)
            b.commit_wait_ms = float("nan")
        if b.hidden_host_ms == b.hidden_host_ms:
            hidden.append(b.hidden_host_ms)
            b.hidden_host_ms = float("nan")

    for i, (toks, max_new, slo) in enumerate(reqs):
        eng.submit(Request(rid=i, tokens=toks, max_new=max_new,
                           arrival=t[0], slo_ms=slo), target)
        tick()
        ticks += 1
    while eng.backlog(t[0]) or eng.in_flight():
        tick()
        ticks += 1
        if ticks > 5000:
            raise AssertionError(f"{engine_kw}: the engine did not drain")
    # an async speculative engine may hold one dispatched round of rows
    # that finished at the last commit (it verifies nothing): commit it
    eng.flush_pending(t[0])
    torch.cuda.synchronize()
    wall = time.time() - t0
    outs = {r.rid: np.asarray(r.output) for r in eng.done}
    if sorted(outs) != list(range(len(reqs))) or any(
            len(outs[i]) != min(reqs[i][1], MAX_NEW) for i in outs):
        raise AssertionError(f"{engine_kw}: {len(outs)}/{len(reqs)} requests "
                             f"complete with their budgets")
    if b._pending is not None or b._uncommitted_done or b.active_slots:
        raise AssertionError(f"{engine_kw}: uncommitted work after the drain")
    pair = b._spec_pair
    for x in (b,) if pair is None else (b, pair.d):
        if hasattr(x, "pool"):
            x.pool.assert_invariants()
            if x.pool.used_pages:
                raise AssertionError(f"{engine_kw}: {x.pool.used_pages} "
                                     f"pages of {x.name} still mapped")
    stats = dict(ticks=ticks, wall_ms_per_tick=wall * 1e3 / ticks,
                 commit_wait_ms=float(np.mean(waits)),
                 hidden_host_ms=float(np.mean(hidden)) if hidden else None,
                 preempted=int(eng.metrics.value("requests.preempted")),
                 launches=ops.launch_counts())
    if pair is not None:
        stats.update(pair.acceptance_stats(), readiness_s={
            "verifier": b.readiness_s, "drafter": pair.d.readiness_s})
    if inspect is not None:
        stats["inspect"] = inspect(eng)
    for bk in eng.backends.values():
        bk.close()
    del eng, b, pair
    torch.cuda.empty_cache()
    return outs, stats


def async_phase(torch):
    """The async dispatch/commit tick at full width on shared weights:
    tinyllama-1.1b L22 in fp32 (kernels on, steps replayed) on the dense
    engine and on the paged engine with prefix sharing, each run four ways
    over one fixed request list (``async_requests``) on a fake clock: sync
    and async FIFO, sync and async ``chunked`` + ``preemption="requeue"``.
    Sync and async outputs of each configuration must be bitwise equal
    (fp32: the async FIFO tick admits through the chunked prefill, a
    different sum order than the monolithic prefill, which bf16 rounding
    would turn into different greedy tokens); every request completes
    with its budget and every pool ends empty and consistent. Prints wall
    ms per tick, hidden host ms (host work overlapped with the device) and
    commit_wait_ms, sync against async. Then a full-width 4-layer fp32
    rung: chunked dense against monolithic dense, identical tokens."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    dev = torch.device(DEVICE)
    log(f"[8] async: the dispatch/commit tick at full width, fp32, "
        f"{AS_N} requests, fake clock")
    base = get_config("tinyllama-1.1b").replace(dtype="float32",
                                                use_kernels=True)
    summary = {}
    for layers in (22, 4):
        cfg = base.replace(num_layers=layers,
                           name=f"tinyllama-1.1b-L{layers}-f32")
        params = LM(cfg).init(torch.Generator(device=dev).manual_seed(0))
        reqs = async_requests(cfg.vocab_size)
        if layers == 4:
            mono, _ = async_serve(torch, cfg, params, reqs, {})
            chunk, st = async_serve(torch, cfg, params, reqs,
                                    dict(scheduler="chunked"))
            same = all(np.array_equal(mono[i], chunk[i]) for i in mono)
            log(f"  {cfg.name}: chunked dense vs monolithic dense greedy "
                f"tokens identical {same}; flash_decode_chunk launches "
                f"{st['launches']['flash_decode_chunk']}")
            if not same or st["launches"]["flash_decode_chunk"] < 1:
                raise AssertionError(f"{cfg.name}: chunked dense differs "
                                     f"from monolithic dense")
            summary[cfg.name] = {"chunked_equals_monolithic": same}
            continue
        for kv in ("dense", "paged"):
            kvkw = dict(kv_cache="paged", kv_page_size=PAGE,
                        kv_prefix_sharing=True) if kv == "paged" else {}
            for mode in ("fifo", "chunked+requeue"):
                mkw = dict(scheduler="chunked", preemption="requeue") \
                    if mode != "fifo" else {}
                runs = {}
                for tick in ("sync", "async"):
                    runs[tick] = async_serve(
                        torch, cfg, params, reqs,
                        dict(kvkw, **mkw, async_tick=tick == "async"))
                (so, ss), (ao, as_) = runs["sync"], runs["async"]
                same = all(np.array_equal(so[i], ao[i]) for i in so)
                name = f"L{layers} {kv} {mode}"
                log(f"  {name}: sync vs async tokens bitwise equal {same}; "
                    f"ticks {ss['ticks']}/{as_['ticks']}; wall ms per tick "
                    f"sync {ss['wall_ms_per_tick']:.3f}, async "
                    f"{as_['wall_ms_per_tick']:.3f}; commit_wait_ms sync "
                    f"{ss['commit_wait_ms']:.3f}, async "
                    f"{as_['commit_wait_ms']:.3f}; hidden host ms (async) "
                    f"{as_['hidden_host_ms']:.3f}; preempted "
                    f"{ss['preempted']}/{as_['preempted']}")
                if not same:
                    raise AssertionError(f"{name}: async outputs differ from "
                                         f"sync")
                if mode != "fifo" and not (ss["preempted"]
                                           and as_["preempted"]):
                    raise AssertionError(f"{name}: preemption never fired")
                summary[name] = {"sync": ss, "async": as_}
        del params
        torch.cuda.empty_cache()
    log("  async summary " + json.dumps(summary))
    return summary


def spec_rung(torch):
    """The spec phase's part 1: a full-width 4-layer fp32 rung of
    tinyllama-1.1b as the verifier, drafted by a 2-layer rung of the same
    seed (the serve ladder's weights: its first layers) and by a twin with
    the verifier's own weights, over the async phase's request list on a
    fake clock: dense and paged with prefix sharing, each FIFO sync, FIFO
    async and ``chunked`` async (the twin on two of them). Every
    speculative output must equal the target-only greedy tokens, and every
    pool, the drafter mirror's included, end empty (``ladder_serve``)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    dev = torch.device(DEVICE)
    base = get_config("tinyllama-1.1b").replace(dtype="float32",
                                                use_kernels=True)
    v = base.replace(num_layers=4, name="tinyllama-L4-f32")
    d2 = base.replace(num_layers=2, name="tinyllama-L2-f32")
    twin = v.replace(name="tinyllama-L4-f32-twin")
    pv = LM(v).init(torch.Generator(device=dev).manual_seed(0))
    pd2 = LM(d2).init(torch.Generator(device=dev).manual_seed(0))
    variants = {v.name: (v, 78.0), d2.name: (d2, 70.0),
                twin.name: (twin, 75.0)}
    weights = {v.name: pv, d2.name: pd2, twin.name: pv}
    reqs = async_requests(v.vocab_size)
    out = {}
    for kv in ("dense", "paged"):
        kvkw = dict(kv_cache="paged", kv_page_size=PAGE,
                    kv_prefix_sharing=True) if kv == "paged" else {}
        want, _ = ladder_serve(torch, variants, weights, v.name, reqs, kvkw)
        for mode, mkw in (("fifo sync", {}),
                          ("fifo async", dict(async_tick=True)),
                          ("chunked async", dict(scheduler="chunked",
                                                 async_tick=True))):
            for dr in (d2, twin):
                if dr is twin and mode != ("fifo sync" if kv == "dense"
                                           else "chunked async"):
                    continue
                got, st = ladder_serve(
                    torch, variants, weights, v.name, reqs,
                    dict(kvkw, **mkw, speculative=f"{dr.name}:{v.name}",
                         spec_k=SPEC_K))
                same = all(np.array_equal(got[i], want[i]) for i in want)
                name = f"L4 fp32 {kv} {mode}, drafter {dr.name}"
                log(f"  {name}: speculative == target-only {same}; accept "
                    f"rate {st['accept_rate']:.3f}, tokens per verifier "
                    f"step {st['tokens_per_step']:.3f}, {st['rounds']} "
                    f"row-rounds, {st['ticks']} ticks, wall ms per tick "
                    f"{st['wall_ms_per_tick']:.3f}")
                if not same or st["rounds"] < 1:
                    raise AssertionError(f"{name}: speculative output "
                                         f"differs from target-only")
                if dr is twin and st["accept_rate"] != 1.0:
                    raise AssertionError(f"{name}: a twin drafter accepted "
                                         f"{st['accept_rate']}")
                out[name] = {k: st[k] for k in (
                    "accept_rate", "tokens_per_step", "rounds", "ticks",
                    "wall_ms_per_tick", "readiness_s")}
    del pv, pd2
    torch.cuda.empty_cache()
    return out


def live_tokens(torch, b):
    """``b.cur_tok`` with the rows of a paged backend whose block table is
    the trash page alone (retired rows) set to -1: such a row keeps
    decoding from page 0, whose contents depend on the scatter order of
    colliding writes (deliberate difference 2), and so does its token."""
    if "pt" not in b.cache:
        return b.cur_tok.clone()
    return torch.where((b.cache["pt"] != 0).any(1), b.cur_tok, -1)


def spec_drive(torch, variants, weights, target, prompts, engine_kw):
    """Admit B full-budget requests of ``prompts`` at once on a
    ``target`` engine (bf16, kernels on; sync ticks) and tick until they
    finish; each tick after the admitting one is one speculative round
    (``speculative`` in ``engine_kw``) or one decode chunk of CHUNK steps,
    timed on the host clock with the device synchronised, its kernel
    launches and committed tokens counted; the third such tick runs under
    the profiler instead (its device ms). Returns (rid -> tokens, the
    verifier's and drafter's cache leaves and cur_tok, per-tick records,
    device ms of one tick, readiness, the engine's graphs' launches)."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serving.api import Request
    from repro_torch.serving.engine import InProcessServingEngine
    eng = InProcessServingEngine(
        variants, max_batch=B, prompt_len=PROMPT, max_new=MAX_NEW,
        decode_chunk=CHUNK, prefill_chunk=CK, use_kernels=True,
        device=DEVICE, weights=weights, **engine_kw)
    eng.apply_allocation(0.0, {target: 1})
    b = eng.backends[target]
    pair = b._spec_pair
    for i in range(B):
        eng.submit(Request(rid=i, tokens=prompts[i], max_new=MAX_NEW,
                           arrival=0.0), target)
    m = eng.metrics

    def committed():
        return (sum(len(t) for t in b.slot_tokens)
                + sum(len(r.output) for r in eng.done))

    eng.step(0.0)                        # admission (+ the first round)
    ticks, dev_ms = [], None
    while eng.in_flight():
        if len(ticks) == 2 and dev_ms is None:
            dev_ms, _ = profiled(torch, lambda: eng.step(0.0))
            continue
        n0, c0 = ops.launch_counts(), committed()
        s0 = {k: m.value(k) for k in ("spec.rounds", "spec.drafts_accepted",
                                      "spec.drafts_proposed")}
        torch.cuda.synchronize()
        t0 = time.time()
        eng.step(0.0)
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
        n1 = ops.launch_counts()
        ds = {k: m.value(k) - s0[k] for k in s0}
        ticks.append(dict(
            wall_ms=wall, tokens=committed() - c0,
            launches={k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]},
            row_rounds=ds["spec.rounds"],
            tokens_per_step=((committed() - c0) / ds["spec.rounds"]
                             if ds["spec.rounds"] else None),
            accept_rate=(ds["spec.drafts_accepted"]
                         / ds["spec.drafts_proposed"]
                         if ds["spec.drafts_proposed"] else None)))
    if len(eng.done) != B or any(len(r.output) != MAX_NEW
                                 for r in eng.done):
        raise AssertionError(f"{target} {engine_kw}: requests incomplete")
    parts = [("verifier", b)] + ([] if pair is None else [("drafter",
                                                            pair.d)])
    state = {n: {**{k: t.clone() for k, t in x.cache.items()},
                 "cur_tok": live_tokens(torch, x)} for n, x in parts}
    for n, x in parts:
        if hasattr(x, "pool"):
            x.pool.assert_invariants()
            if x.pool.used_pages:
                raise AssertionError(f"{n} {x.name}: {x.pool.used_pages} "
                                     f"pages still mapped")
    graphs = {n: {f"{k[0]}@{k[1]}": g.launches for k, g in x.graphs.items()}
              for n, x in parts}
    # each captured step of a round alone, replayed back to back on its
    # last inputs (the state is read above): its ms from CUDA events
    step_ms = {}
    if pair is not None and b.graphs and b.device.type == "cuda":
        draft = max((k for k in pair.d.graphs if k[0] == "chunk"),
                    key=lambda k: k[1] or 0)
        for label, g in (("verify", b.graphs[("verify", B)]),
                         ("draft", pair.d.graphs[draft]),
                         ("resync", pair.d.graphs[("resync", B)])):
            step_ms[label] = time_ms(torch, g.graph.replay, [()], iters=20)
    ready = {n: x.readiness_s for n, x in parts}
    outs = {r.rid: np.asarray(r.output) for r in eng.done}
    for _, x in parts:
        x.close()
    del eng, b, pair, parts
    torch.cuda.empty_cache()
    return outs, state, ticks, dev_ms, ready, (graphs, step_ms)


def spec_phase(torch):
    """Speculative decoding at full width on shared weights, steps
    replayed. Part 1 (``spec_rung``): a 4-layer fp32 rung, speculative ==
    target-only. Part 2: tinyllama-1.1b L22 in bf16 drafted by the L8 rung
    of the same seed and by an L22 twin, dense and paged with prefix
    sharing (``spec_drive``): replay against ``step_graphs=False`` bitwise
    in tokens and every cache leaf of verifier and drafter (the pool's
    trash page 0 aside: deliberate difference 2); each round after the
    first launches the verify's 22 chunk-form kernels, the drafter's resync
    (one chunk-form launch per drafter layer) and its SPEC_K decode steps
    (SPEC_K decode-form launches per drafter layer), and each captured step
    holds exactly its share. Prints per round the wall ms, tokens per
    verifier step and acceptance, device ms of one round, ms per committed
    token against the target-only decode chunk's on the same weights, and
    the agreement with target-only (bf16 rounding can part them after the
    first differently rounded logit: printed, not held). The tokens of a
    retired paged row are not compared (``live_tokens``). Each part's
    seconds are printed."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    dev = torch.device(DEVICE)
    log(f"[9] spec: speculative decoding, spec_k={SPEC_K}, full width, "
        f"steps replayed")
    t0 = time.time()
    summary = {"L4 fp32": spec_rung(torch)}
    log(f"  L4 fp32 part: {time.time() - t0:.1f}s")
    t0 = time.time()
    base = get_config("tinyllama-1.1b").replace(use_kernels=True)
    v = base.replace(name="tinyllama-1.1b-L22")
    d8 = base.replace(num_layers=8, name="tinyllama-1.1b-L8")
    twin = v.replace(name="tinyllama-1.1b-L22-twin")
    pv = LM(v).init(torch.Generator(device=dev).manual_seed(0))
    pd8 = LM(d8).init(torch.Generator(device=dev).manual_seed(0))
    variants = {v.name: (v, 78.0), d8.name: (d8, 70.0),
                twin.name: (twin, 75.0)}
    weights = {v.name: pv, d8.name: pd8, twin.name: pv}
    prompts = np.random.default_rng(41).integers(0, v.vocab_size,
                                                 (B, PROMPT))
    for kv in ("dense", "paged"):
        kvkw = dict(kv_cache="paged", kv_page_size=PAGE,
                    kv_prefix_sharing=True) if kv == "paged" else {}
        want, _, t_ticks, t_dev, _, _ = spec_drive(
            torch, variants, weights, v.name, prompts, kvkw)
        t_tok = (sum(t["wall_ms"] for t in t_ticks)
                 / sum(t["tokens"] for t in t_ticks))
        for dr in (d8, twin):
            Ld = dr.num_layers
            runs = {}
            for path in ("eager", "replay"):
                runs[path] = spec_drive(
                    torch, variants, weights, v.name, prompts,
                    dict(kvkw, speculative=f"{dr.name}:{v.name}",
                         spec_k=SPEC_K, step_graphs=path == "replay"))
            (e_out, e_st, e_ticks, e_dev, e_rt, _), \
                (r_out, r_st, r_ticks, r_dev, r_rt, (graphs, step_ms)) = \
                runs["eager"], runs["replay"]
            name = f"L22 bf16 {kv}, drafter {dr.name}"
            same_tok = all(np.array_equal(e_out[i], r_out[i]) for i in e_out)
            diff = {}
            for part in e_st:
                for k in e_st[part]:
                    a, b = r_st[part][k], e_st[part][k]
                    if k in ("kp", "vp"):      # the trash page 0 aside
                        a, b = a[:, :, 1:], b[:, :, 1:]
                    if not torch.equal(a, b):
                        diff[f"{part}.{k}"] = float(
                            (a.float() - b.float()).abs().max())
            agree = sum(int((r_out[i] == want[i]).sum()) for i in want)
            chunk_key, dec_key = (("paged_decode", "paged_decode")
                                  if kv == "paged"
                                  else ("flash_decode_chunk", "flash_decode"))
            per_round = {chunk_key: v.num_layers + Ld}
            per_round[dec_key] = per_round.get(dec_key, 0) + SPEC_K * Ld
            bad = [(p, i, t["launches"]) for p, tk in (("eager", e_ticks),
                                                       ("replay", r_ticks))
                   for i, t in enumerate(tk) if t["launches"] != per_round]
            draft = [g for key, g in graphs["drafter"].items()
                     if key.startswith("chunk@")]
            steps_ok = (graphs["verifier"][f"verify@{B}"]
                        == {chunk_key: v.num_layers}
                        and graphs["drafter"][f"resync@{B}"]
                        == {chunk_key: Ld}
                        and bool(draft) and all(g == {dec_key: SPEC_K * Ld}
                                                for g in draft))
            r_tok = (sum(t["wall_ms"] for t in r_ticks)
                     / sum(t["tokens"] for t in r_ticks))
            log(f"  {name}: replay vs eager tokens equal {same_tok}, cache "
                f"leaves differing {diff or 'none'}; launches per round "
                f"{per_round} on every round: {not bad}; captured steps "
                f"hold their share: {steps_ok}; readiness replay "
                f"{json.dumps(r_rt)}, eager {json.dumps(e_rt)}")
            log(f"    per round (replay): wall ms "
                f"{[round(t['wall_ms'], 3) for t in r_ticks]}; tokens per "
                f"verifier step {[t['tokens_per_step'] for t in r_ticks]}; "
                f"accept rate "
                f"{[None if t['accept_rate'] is None else round(t['accept_rate'], 3) for t in r_ticks]}")
            log(f"    device ms of one round: replay {ms4(r_dev)}, eager "
                f"{ms4(e_dev)}; wall ms per round replay "
                f"{np.mean([t['wall_ms'] for t in r_ticks]):.3f}, eager "
                f"{np.mean([t['wall_ms'] for t in e_ticks]):.3f}; ms per "
                f"committed token {r_tok:.4f} against target-only "
                f"{t_tok:.4f} (decode chunk of {CHUNK}, device ms "
                f"{ms4(t_dev)} a chunk); tokens agreeing with target-only "
                f"{agree}/{B * MAX_NEW}")
            r_wall = float(np.mean([t["wall_ms"] for t in r_ticks]))
            log(f"    a round's replayed steps alone (ms, CUDA events): "
                f"{json.dumps(step_ms)}; the rest of a round's wall "
                f"(accept, rewind, copies, read-back, host) "
                f"{r_wall - sum(step_ms.values()):.3f}")
            if not same_tok or diff or bad or not steps_ok:
                raise AssertionError(f"{name}: replay differs from eager "
                                     f"(tokens {same_tok}, leaves {diff}) "
                                     f"or launches per round {bad[:3]} / "
                                     f"steps {graphs}")
            summary[name] = {
                "replay_wall_ms_per_round": float(np.mean(
                    [t["wall_ms"] for t in r_ticks])),
                "eager_wall_ms_per_round": float(np.mean(
                    [t["wall_ms"] for t in e_ticks])),
                "replay_device_ms_round": r_dev, "eager_device_ms_round": e_dev,
                "timed_rounds": len(r_ticks),
                "ms_per_token": r_tok, "target_ms_per_token": t_tok,
                "target_device_ms_chunk": t_dev,
                "agree_with_target": agree, "readiness_s": r_rt,
                "step_ms": step_ms,
                "launches_per_round": per_round}
    del pv, pd8
    torch.cuda.empty_cache()
    log(f"  L22 bf16 part: {time.time() - t0:.1f}s")
    log("  spec summary " + json.dumps(summary))
    return summary


def traced_checks(eng, every=None, monotone=True):
    """The obs phase's checks of one traced engine after its drain: a
    valid Chrome trace, no dropped span or tick, every request's spans
    from QUEUED to one terminal event, monotone in time with ``monotone``
    (on a fake clock: under a wall clock the prefill events carry the
    tick's ``now``, a little before the ``clock()`` stamp of an admission
    in the same tick, as in the reference), and the dispatch profiler's
    split finite, non-negative and within exec_ms where it was sampled and
    NaN elsewhere. With ``every`` (an engine with one backend from its
    first tick on, so that backend's record i is tick i + 1), the sampled
    ticks must be exactly the non-idle ticks whose number ``every``
    divides. Returns the dispatch floor summary per backend and counts."""
    import math
    from repro_torch.obs import (dispatch_floor_summary, to_chrome_trace,
                                 validate_chrome_trace)
    from repro_torch.obs import trace as ev
    n_events = validate_chrome_trace(to_chrome_trace(eng.tracer))
    dropped = (eng.metrics.value("obs.spans_dropped"),
               eng.metrics.value("obs.ticks_dropped"))
    if not n_events > 0 or dropped != (0.0, 0.0):
        raise AssertionError(f"trace: {n_events} events, dropped {dropped}")
    for r in eng.done:
        names = [e.name for e in r.spans or ()]
        ts = [e.t for e in r.spans or ()]
        if (not names or names[0] != ev.QUEUED
                or (monotone and ts != sorted(ts))
                or names[-1] not in ev.TERMINAL_EVENTS
                or ev.TERMINAL_EVENTS & set(names[:-1])):
            raise AssertionError(f"request {r.rid}: spans {names} at {ts}")
    recs = {}
    for r in eng.tracer.ticks:
        recs.setdefault(r.backend, []).append(r)
    n_sampled = 0
    for name, rs in recs.items():
        for i, r in enumerate(rs):       # record i of a backend: tick i + 1
            split = (r.dispatch_ms, r.device_ms, r.host_sync_ms)
            if every is None:
                sampled = not math.isnan(r.dispatch_ms)
            else:
                sampled = (i + 1) % every == 0 and r.kind != "idle"
            if not sampled:
                if not all(math.isnan(x) for x in split):
                    raise AssertionError(f"{name} tick {i + 1}: unsampled "
                                         f"split {split}")
                continue
            n_sampled += 1
            if not (all(math.isfinite(x) and x >= 0 for x in split)
                    and sum(split) <= r.exec_ms + 1e-3):
                raise AssertionError(f"{name} tick {i + 1}: split {split} "
                                     f"against exec_ms {r.exec_ms}")
    if not n_sampled:
        raise AssertionError("no tick was sampled by the dispatch profiler")
    return {"dispatch_floor": {n: dispatch_floor_summary(rs)
                               for n, rs in recs.items()},
            "trace_events": n_events, "sampled_ticks": n_sampled,
            "ticks": len(eng.tracer.ticks)}


def obs_phase(torch, profiles):
    """Observability on the engine at full width: tinyllama-1.1b L22 in
    bf16, kernels on, steps replayed. Part (a): the async phase's request
    list on a fake clock through dense FIFO (sync tick) and paged with
    sharing + ``chunked`` + requeue + async tick, each untraced
    (``Observability.disabled()``) and traced (trace, windows, a flight
    recorder, ``profile_dispatch=2``); tokens and every kernel's launches
    must be equal between the two, and the traced engine must pass
    ``traced_checks``. Part (b): the launcher's own observability wiring
    (``launch.serve.serve`` with ``--trace --profile-dispatch 4
    --burn-rate-alerts --flight-dir``) for OBS_SERVE_SECONDS at OBS_SLO_MS
    on the dense ladder's profiles: at least one alert, a ``burn_rate``
    re-solve in the audit, a valid flight dump, valid trace / metrics /
    audit reports and zero drop counters. Returns the launch counts of
    part (b)'s serve loop."""
    import tempfile
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    from repro_torch.models.model import LM
    from repro_torch.obs import FlightRecorder, Observability
    from repro_torch.obs.export import (assert_zero, summarize_file,
                                        validate_metrics_file,
                                        validate_trace_file)
    t_phase = time.time()
    dev = torch.device(DEVICE)
    log("[10] obs: tracing, windows, the flight recorder and the dispatch "
        "profiler on the engine, full width L22 bf16, kernels on, steps "
        "replayed")
    cfg = get_config("tinyllama-1.1b").replace(
        num_layers=22, name="tinyllama-1.1b-L22", use_kernels=True)
    params = LM(cfg).init(torch.Generator(device=dev).manual_seed(0))
    reqs = async_requests(cfg.vocab_size)
    summary = {}
    configs = {
        "dense fifo sync": {},
        "paged sharing chunked+requeue async": dict(
            kv_cache="paged", kv_page_size=PAGE, kv_prefix_sharing=True,
            scheduler="chunked", preemption="requeue", async_tick=True)}
    with tempfile.TemporaryDirectory() as tmp:
        for name, kw in configs.items():
            off_out, off = async_serve(torch, cfg, params, reqs, dict(
                kw, obs=Observability.disabled()))
            flight = FlightRecorder(out_dir=tmp)
            on_out, on = async_serve(
                torch, cfg, params, reqs,
                dict(kw, obs=Observability(trace=True, windows=True,
                                           flight=flight),
                     profile_dispatch=2),
                inspect=lambda eng: traced_checks(eng, 2))
            same = all(np.array_equal(off_out[i], on_out[i])
                       for i in off_out)
            if not same:
                raise AssertionError(f"{name}: traced tokens differ")
            if on["launches"] != off["launches"]:
                raise AssertionError(f"{name}: tracing changed the kernel "
                                     f"launches: {off['launches']} -> "
                                     f"{on['launches']}")
            if not flight.ticks or not flight.spans:
                raise AssertionError(f"{name}: the flight ring stayed empty")
            # the untraced run's registry is off too: read preemptions here
            if kw.get("preemption") and not on["preempted"]:
                raise AssertionError(f"{name}: preemption never fired")
            ins = on.pop("inspect")
            log(f"  {name}: tokens bitwise equal {same}; launches equal "
                f"{on['launches'] == off['launches']}; ticks "
                f"{off['ticks']}/{on['ticks']}; wall ms per tick untraced "
                f"{off['wall_ms_per_tick']:.3f}, traced "
                f"{on['wall_ms_per_tick']:.3f}; {ins['trace_events']} "
                f"trace events, {ins['sampled_ticks']} sampled ticks; "
                f"preempted {on['preempted']}")
            log(f"  {name}: dispatch floor " + json.dumps(
                ins["dispatch_floor"]))
            summary[name] = {"untraced": off, "traced": on, **ins}
        del params
        torch.cuda.empty_cache()

        args = launcher.parse_args([
            "--full-width", "--device", DEVICE,
            "--seconds", str(OBS_SERVE_SECONDS), "--interval", "5",
            "--slo-ms", str(OBS_SLO_MS), "--load", *map(str, OBS_LOAD),
            "--trace", "--profile-dispatch", "4", "--burn-rate-alerts",
            "--flight-dir", f"{tmp}/flight", "--report-dir",
            f"{tmp}/reports"])
        log(f"  launcher serve: {OBS_SERVE_SECONDS}s at slo {OBS_SLO_MS} ms, "
            f"load {OBS_LOAD} req/s, --trace --profile-dispatch 4 "
            f"--burn-rate-alerts --flight-dir")
        ops.reset_launch_counts()
        out = launcher.serve(args, profiles=profiles,
                             log=lambda m: log("  " + m))
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        eng, s = out["engine"], out["summary"]
        if s is None or s["pending"] != 0:
            raise AssertionError(f"launcher serve: summary {s}")
        if min(launches["flash_prefill"], launches["flash_decode"]) < 1:
            raise AssertionError(f"a kernel of the dense path never ran in "
                                 f"the launcher serve: {launches}")
        n_alerts = len(out["slo_monitor"].alerts)
        if n_alerts < 1 or out["burn_resolves"] < 1:
            raise AssertionError(f"{n_alerts} alerts, "
                                 f"{out['burn_resolves']} burn_rate "
                                 f"re-solves")
        dumps = out["flight"].dumps
        if not dumps:
            raise AssertionError("no flight dump written")
        flight_events = [validate_trace_file(p) for p in dumps]
        rep = out["reports"]
        n_trace = validate_trace_file(rep["TRACE_engine.json"])
        n_rows = validate_metrics_file(rep["METRICS_engine.jsonl"])
        for c in ("obs.spans_dropped", "obs.ticks_dropped"):
            assert_zero(rep["METRICS_engine.jsonl"], c)
        audit = [json.loads(line) for line in
                 open(rep["AUDIT_decisions.jsonl"]) if line.strip()]
        summarize_file(rep["AUDIT_decisions.jsonl"])
        if not any(d.get("reason") == "burn_rate" for d in audit):
            raise AssertionError("the audit holds no burn_rate decision")
        ins = traced_checks(eng, monotone=False)
        log(f"  launcher serve: {s['n_requests']} requests, {n_alerts} "
            f"alerts, {out['burn_resolves']} burn_rate re-solves, "
            f"{len(dumps)} flight dumps ({flight_events} events), trace "
            f"{n_trace} events, metrics {n_rows} rows, audit {len(audit)} "
            f"decisions; dispatch floor " + json.dumps(ins["dispatch_floor"]))
        summary["launcher serve"] = {
            "n_requests": s["n_requests"], "alerts": n_alerts,
            "burn_resolves": out["burn_resolves"], "flight_dumps": len(dumps),
            "trace_events": n_trace, "audit_decisions": len(audit),
            "launches": launches, **ins}
        for b in eng.backends.values():
            b.close()
        del eng, out
        torch.cuda.empty_cache()
    log(f"  obs phase: {time.time() - t_phase:.1f}s")
    log("  obs summary " + json.dumps(summary))
    return launches


def fabric_requests(vocab, n=FAB_N, seed=41):
    """The fabric phase's fixed request list: ``n`` prompts of PROMPT
    tokens, every other one over a shared PS_SHARED-token prefix (prefix
    hits on a paged replica), each with the full MAX_NEW budget."""
    import numpy as np
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, PS_SHARED)
    return [np.concatenate([prefix, rng.integers(0, vocab,
                                                 PROMPT - PS_SHARED)])
            if i % 2 else rng.integers(0, vocab, PROMPT) for i in range(n)]


def own_bytes(b):
    """A backend's own weights and KV cache, in bytes."""
    from repro_torch.serving.graphs import tensor_leaves
    return sum(t.numel() * t.element_size()
               for t in tensor_leaves(b.params) + tensor_leaves(b.cache))


def fabric_engine(torch, variants, engine_kw, loads=None, fabric=True):
    """An engine of ``variants`` at the serve geometry on a fake clock
    (``engine.t``), kernels on, steps replayed, every backend its own
    seeded weights; with ``fabric`` on two nodes of four units, spread
    placement, p2c routing. ``loads`` collects each backend's variant,
    readiness and ``memory_allocated`` after its load."""
    from repro_torch.cluster import make_nodes
    from repro_torch.serving.engine import InProcessServingEngine
    t = [1.0]
    fab = dict(nodes=make_nodes(2, 4), placement="spread", router="p2c") \
        if fabric else {}
    eng = InProcessServingEngine(
        variants, max_batch=B, prompt_len=PROMPT, max_new=MAX_NEW,
        decode_chunk=CHUNK, prefill_chunk=CK, queue_cap=1000,
        use_kernels=True, device=DEVICE, clock=lambda: t[0], **fab,
        **engine_kw)
    eng.t = t
    if loads is not None:
        make = eng._make_backend

        def make_logged(name):
            b = make(name)
            torch.cuda.synchronize()
            loads.append({"variant": name, "readiness_s": b.readiness_s,
                          "memory_allocated": torch.cuda.memory_allocated(),
                          "own_bytes": own_bytes(b)})
            log(f"    loaded a {name} replica: readiness "
                f"{b.readiness_s:.3f}s, {own_bytes(b)} bytes of weights and "
                f"KV, memory_allocated {torch.cuda.memory_allocated()}")
            return b
        eng._make_backend = make_logged
    return eng


def fabric_drive(torch, eng, reqs, names, crash_tick=None, per_tick=2):
    """Submit ``reqs`` on the engine's fake clock, ``per_tick`` a tick, rid
    i to ``names[i % len(names)]``, then tick until every queue and slot is
    empty; at ``crash_tick`` crash node0 and measure what it frees. Returns
    (rid -> tokens, crash stats or None)."""
    import gc
    import numpy as np
    from repro_torch.cluster import node_crash
    from repro_torch.serving.api import Request
    t, crash, ticks, i = eng.t, None, 0, 0
    while i < len(reqs) or eng.backlog(t[0]) or eng.in_flight():
        for _ in range(per_tick):
            if i < len(reqs):
                if not eng.submit(Request(rid=i, tokens=reqs[i],
                                          max_new=MAX_NEW, arrival=t[0]),
                                  names[i % len(names)]):
                    raise AssertionError(f"request {i} rejected")
                i += 1
        if ticks == crash_tick:
            dead = [r for r in eng.fabric.replicas.values()
                    if r.node_id == "node0"]
            own = sum(own_bytes(r.handle) for r in dead)
            busy = sum(r.handle.active_slots for r in dead)
            rids = sorted(r.rid for r in dead)
            n_sub = eng.metrics.value("requests.submitted")
            del dead
            gc.collect()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            t_c = time.time()
            eng.inject_fault(t[0], node_crash(t[0], "node0"))
            crash_ms = (time.time() - t_c) * 1e3
            gc.collect()
            torch.cuda.synchronize()
            after = torch.cuda.memory_allocated()
            crash = dict(killed=rids, in_slots=busy, own_bytes=own,
                         before=before, after=after, freed=before - after,
                         crash_ms=crash_ms,
                         retried=int(eng.metrics.value("requests.submitted")
                                     - n_sub),
                         capacity_factor=eng.capacity_factor(t[0]),
                         backends=sorted(eng.backends))
            log(f"    crash node0 at tick {ticks}: killed {rids} ({busy} "
                f"requests in slots), {crash['retried']} retried; "
                f"memory_allocated {before} -> {after} (freed "
                f"{before - after}, the killed replicas' own {own}); "
                f"capacity_factor {crash['capacity_factor']}")
            if crash["capacity_factor"] != 0.5:
                raise AssertionError(f"capacity_factor after the crash: "
                                     f"{crash['capacity_factor']}")
            if crash["freed"] < 0.9 * own:
                raise AssertionError(f"the killed replicas' memory was not "
                                     f"released: {crash}")
            if not busy or not crash["retried"]:
                raise AssertionError(f"the crash hit no request: {crash}")
        eng.step(t[0])
        t[0] += 0.05
        ticks += 1
        if ticks > 5000:
            raise AssertionError("the fabric did not drain")
    eng.flush_pending(t[0])
    torch.cuda.synchronize()
    outs = {r.rid: np.asarray(r.output) for r in eng.done}
    if sorted(r.rid for r in eng.done) != list(range(len(reqs))):
        raise AssertionError(f"{len(eng.done)} completions for "
                             f"{len(reqs)} requests")
    if eng.rejected or any(len(o) != MAX_NEW for o in outs.values()):
        raise AssertionError(f"rejected {eng.rejected}, or a short output")
    wrong = [r.rid for r in eng.done
             if r.backend.split("#")[0] != names[r.rid % len(names)]]
    if wrong:
        raise AssertionError(f"requests served off their variant: {wrong}")
    return outs, crash


def fabric_crash(torch, variants, kv, label):
    """Part (a)/(b) of the fabric phase on one KV discipline: {L8: 2, L22:
    2} on two nodes, FAB_N requests (half to each rung), node0 crashed at
    FAB_CRASH_TICK, then the allocation re-applied; the tokens held
    against one plain backend per rung. Returns (summary, launches)."""
    import gc
    import numpy as np
    from repro_torch.kernels import ops
    names = list(variants)
    alloc = {n: 2 for n in names}
    reqs = fabric_requests(next(iter(variants.values()))[0].vocab_size)
    loads = []
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    log(f"  {label}: memory_allocated before loading {mem0}")
    eng = fabric_engine(torch, variants, kv, loads)
    eng.apply_allocation(eng.t[0], alloc)
    placed = {rid: r.node_id for rid, r in eng.fabric.replicas.items()}
    log(f"  {label}: placed {placed}")
    ops.reset_launch_counts()
    outs, crash = fabric_drive(torch, eng, reqs, names,
                               crash_tick=FAB_CRASH_TICK)
    launches = ops.launch_counts()
    need = ("flash_prefill", "paged_decode" if kv else "flash_decode")
    if min(launches[k] for k in need) < 1:
        raise AssertionError(f"{label}: a kernel of the path never ran: "
                             f"{launches}")
    served = {rid: sum(r.backend == rid for r in eng.done)
              for rid in placed}
    n_loads = len(loads)
    eng.apply_allocation(eng.t[0], alloc)
    cf = eng.capacity_factor(eng.t[0])
    nodes = {r.node_id for r in eng.fabric.replicas.values()}
    log(f"  {label}: re-applied {alloc}: capacity_factor {cf}, replicas "
        f"{sorted(eng.fabric.replicas)} on {sorted(nodes)}; new replicas' "
        f"readiness {[round(x['readiness_s'], 3) for x in loads[n_loads:]]}")
    if cf != 1.0 or nodes != {"node1"}:
        raise AssertionError(f"{label}: re-placement gave capacity_factor "
                             f"{cf} on {nodes}")
    pool = None
    if kv:
        for rid, b in eng.backends.items():
            b.pool.assert_invariants()
            if b.pool.used_pages:
                raise AssertionError(f"{rid}: {b.pool.used_pages} pages "
                                     f"still mapped")
        pool = eng.kv_pool_stats()
        usable = sum(b.pool.usable_pages for b in eng.backends.values())
        if pool["usable_pages"] != usable or pool["used_pages"] != 0:
            raise AssertionError(f"kv_pool_stats {pool} over {usable} "
                                 f"usable pages")
    for b in eng.backends.values():
        b.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # one plain backend per rung on the same requests: the tokens a
    # request gets must not depend on the replica that served it
    one = fabric_engine(torch, variants, kv, fabric=False)
    one.apply_allocation(one.t[0], {n: 1 for n in names})
    want, _ = fabric_drive(torch, one, reqs, names)
    for b in one.backends.values():
        b.close()
    del one
    gc.collect()
    torch.cuda.empty_cache()
    same = sum(np.array_equal(outs[i], want[i]) for i in outs)
    log(f"  {label}: tokens equal to one plain backend per rung for "
        f"{same}/{len(outs)} requests; served per replica {served}")
    summary = dict(placed=placed, loads=loads, crash=crash, served=served,
                   tokens_equal=same, kv_pool=pool, launches=launches,
                   memory_before_loading=mem0)
    return summary, launches


def fabric_straggler(torch, variants):
    """Part (c): {L22: 2} with L22#0 slowed FAB_SLOW-fold under a steady
    stream (a request a tick): the slowed replica's decode commits, timed
    from dispatch to the commit's end, against its twin's; p2c's split
    printed; then the replica restored. Returns (summary, launches)."""
    import numpy as np
    from repro_torch.cluster import replica_restore, replica_slowdown
    from repro_torch.kernels import ops
    (name,) = [n for n in variants if n.endswith("-L22")]
    eng = fabric_engine(torch, {name: variants[name]}, {})
    eng.apply_allocation(eng.t[0], {name: 2})
    slow, twin = f"{name}#0", f"{name}#1"
    eng.inject_fault(eng.t[0], replica_slowdown(eng.t[0], slow, FAB_SLOW))
    if eng.backends[slow].slow_factor != FAB_SLOW:
        raise AssertionError("the slowdown did not reach the backend")
    spans = {slow: [], twin: []}
    for rid, b in eng.backends.items():
        commit = b.commit_exec

        def timed(pending, now, rid=rid, commit=commit):
            out = commit(pending, now)
            if pending is not None and pending.kind == "decode":
                spans[rid].append((time.perf_counter()
                                   - pending.dispatched_at) * 1e3)
            return out
        b.commit_exec = timed
    reqs = fabric_requests(variants[name][0].vocab_size, FAB_STRAGGLER_N)
    ops.reset_launch_counts()
    fabric_drive(torch, eng, reqs, [name], per_tick=1)
    launches = ops.launch_counts()
    split = {rid: sum(r.backend == rid for r in eng.done) for rid in spans}
    ms = {rid: float(np.mean(v)) for rid, v in spans.items()}
    ratio = ms[slow] / ms[twin]
    log(f"  straggler: {slow} x{FAB_SLOW}: decode commit {ms[slow]:.3f} ms "
        f"against {twin}'s {ms[twin]:.3f} ({ratio:.3f}x, {len(spans[slow])} "
        f"and {len(spans[twin])} commits); p2c sent {split}")
    if ratio < 2.5:
        raise AssertionError(f"the straggler is only {ratio:.3f}x slower")
    eng.inject_fault(eng.t[0], replica_restore(eng.t[0], slow))
    if eng.backends[slow].slow_factor != 1.0:
        raise AssertionError("replica_restore left the slow factor")
    for b in eng.backends.values():
        b.close()
    del eng
    torch.cuda.empty_cache()
    return dict(commit_ms=ms, ratio=ratio, split=split,
                commits={k: len(v) for k, v in spans.items()},
                launches=launches), launches


def fabric_launcher(torch, profiles, tmp):
    """Part (d): FAB_SERVE_SECONDS of the launcher's ``--replicas 4 --nodes
    2 --fail-node-at FAB_FAIL_AT --flight-dir`` serve at full width, at a
    steady load: every accepted request completes once, the crash's flight
    dump validates, the controller's first decision after the crash sees
    capacity below 1 and re-places the replicas; the time from the crash
    to capacity_factor 1.0 printed. Returns (summary, launches)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    from repro_torch.obs.export import validate_trace_file
    from repro_torch.serving.engine import InProcessServingEngine as E
    args = launcher.parse_args([
        "--full-width", "--device", DEVICE, "--seconds",
        str(FAB_SERVE_SECONDS), "--interval", "3", "--load", "1.5", "1.5",
        "--replicas", "4", "--nodes", "2", "--fail-node-at",
        str(FAB_FAIL_AT), "--flight-dir", f"{tmp}/flight"])
    events = []      # (engine clock, what, capacity_factor after)
    apply, inject = E.apply_allocation, E.inject_fault

    def apply_logged(self, t, units):
        apply(self, t, units)
        events.append((self.clock(), "apply", self.capacity_factor(t)))

    def inject_logged(self, now, event):
        inject(self, now, event)
        events.append((self.clock(), event.kind, self.capacity_factor(now)))
    E.apply_allocation, E.inject_fault = apply_logged, inject_logged
    ops.reset_launch_counts()
    try:
        out = launcher.serve(args, profiles=profiles,
                             log=lambda m: log("    " + m))
    finally:
        E.apply_allocation, E.inject_fault = apply, inject
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    eng, s = out["engine"], out["summary"]
    if s is None or s["pending"] != 0:
        raise AssertionError(f"launcher fabric serve: summary {s}")
    rids = [r.rid for r in eng.done]
    if len(rids) != len(set(rids)):
        raise AssertionError("a request completed twice")
    if len(out["faults"]):
        raise AssertionError("a fault was never injected")
    dump = Path(tmp) / "flight" / "FLIGHT_fault_node_crash.json"
    n_dump = validate_trace_file(str(dump))
    (t_crash,) = [t for t, what, _ in events if what == "node_crash"]
    after = [e for e in out["controller"].audit.entries if e.t >= t_crash]
    if not after or after[0].inputs["capacity_factor"] >= 1.0:
        raise AssertionError(f"no decision saw the crash: {events}")
    back = [t for t, what, cf in events
            if what == "apply" and t >= t_crash and cf == 1.0]
    if not back:
        raise AssertionError(f"capacity never came back: {events}")
    log(f"  launcher: {s['n_requests']} requests, {eng.rejected} rejected; "
        f"crash at t={t_crash:.3f}s, the next decision at "
        f"t={after[0].t:.3f}s saw capacity_factor "
        f"{after[0].inputs['capacity_factor']}; capacity_factor 1.0 after "
        f"{back[0] - t_crash:.3f}s; flight dump {n_dump} events; "
        f"events {[(round(t, 3), w, cf) for t, w, cf in events]}")
    summary = dict(n_requests=s["n_requests"], rejected=eng.rejected,
                   crash_t=t_crash, decision_t=after[0].t,
                   recovery_s=back[0] - t_crash, flight_events=n_dump,
                   events=events, launches=launches)
    for b in eng.backends.values():
        b.close()
    del eng, out
    torch.cuda.empty_cache()
    return summary, launches


def fabric_phase(torch, profiles):
    """The replica fabric at full width (tinyllama-1.1b L8 and L22, bf16,
    kernels on, steps replayed; two nodes of four units, spread placement,
    p2c routing): (a) dense {L8: 2, L22: 2}, node0 crashed mid-run; (b) the
    same on the paged engine with prefix sharing; (c) a straggler; (d) the
    launcher's crash-and-recover serve. Returns the phase's launch
    counts."""
    import tempfile
    from collections import Counter
    from repro_torch.launch.serve import build_ladder
    t_phase = time.time()
    log("[12] fabric: replicas, p2c routing, a node crash with retry, a "
        "straggler and the launcher's --replicas/--nodes/--fail-node-at, "
        "full width bf16, kernels on, steps replayed")
    variants = build_ladder("tinyllama-1.1b", depths=(8, 22),
                            accs=(70.0, 78.0), full_width=True)
    summary, launches = {}, Counter()
    f32 = {n: (c.replace(dtype="float32"), a) for n, (c, a) in
           build_ladder("tinyllama-1.1b", depths=(2, 4), accs=(70.0, 78.0),
                        full_width=True).items()}
    for kv, label in (({}, "dense"), (dict(
            kv_cache="paged", kv_page_size=PAGE, kv_prefix_sharing=True),
            "paged sharing")):
        summary[label], n = fabric_crash(torch, variants, kv, label)
        launches.update(n)
        if summary[label]["tokens_equal"] == FAB_N:
            continue
        # bf16 greedy tokens part after a differently rounded logit (with
        # sharing, a prompt that hits one replica's prefix index misses
        # another's and prefills in chunks): at fp32 they must agree
        label = f"{label} fp32"
        summary[label], n = fabric_crash(torch, f32, kv, label)
        launches.update(n)
        if summary[label]["tokens_equal"] != FAB_N:
            raise AssertionError(f"{label}: fabric tokens differ from the "
                                 f"plain backend's")
    summary["straggler"], n = fabric_straggler(torch, variants)
    launches.update(n)
    with tempfile.TemporaryDirectory() as tmp:
        summary["launcher"], n = fabric_launcher(torch, profiles, tmp)
    launches.update(n)
    summary["wall_s"] = time.time() - t_phase
    log(f"  fabric phase: {summary['wall_s']:.1f}s; launches "
        f"{dict(launches)}")
    log("  fabric summary " + json.dumps(summary, default=str))
    return dict(launches)


def eval_controller(kind, profiles, cfg, window):
    """One of the paper's five controllers over ``profiles``: VPA+ holds the
    most accurate rung; INFaaS takes any rung (its accuracy floor is the
    ladder's lowest); the forecasters look back ``window`` seconds."""
    from repro_torch.core.adapter import (InfAdapterController,
                                          MSPlusController, VPAPlusController)
    from repro_torch.core.cocktail import CocktailController
    from repro_torch.core.forecaster import MovingMaxForecaster
    from repro_torch.core.infaas import INFaaSController
    top = max(profiles, key=lambda n: profiles[n].accuracy)
    fc = MovingMaxForecaster(window=window)
    if kind == "InfAdapter":
        return InfAdapterController(profiles, fc, cfg)
    if kind == "MS+":
        return MSPlusController(profiles, fc, cfg)
    if kind == "VPA+":
        return VPAPlusController(profiles[top], cfg)
    if kind == "INFaaS":
        return INFaaSController(profiles, cfg, min_accuracy=min(
            p.accuracy for p in profiles.values()))
    return CocktailController(profiles, fc, cfg)


def settled_memory(torch):
    """``memory_allocated`` after a collection and an emptied cache."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def close_engine(torch, eng, base=None):
    """Retire every backend (each is closed: its graphs and pool go) and
    return the card's ``memory_allocated`` after a collection. With
    ``base`` (the engine's start) it must be back there within
    CLOSE_MARGIN, or the largest tensors still alive are printed and the
    check fails."""
    eng.apply_allocation(0.0, {})
    if eng.backends:
        raise AssertionError(f"backends left open: {sorted(eng.backends)}")
    after = settled_memory(torch)
    if base is not None and after - base > CLOSE_MARGIN:
        import gc
        live = {}
        for o in gc.get_objects():
            if isinstance(o, torch.Tensor) and o.is_cuda:
                st = o.untyped_storage()
                live[st.data_ptr()] = (st.nbytes(), tuple(o.shape), o.dtype)
        top = sorted(live.values(), key=lambda v: -v[0])[:8]
        raise AssertionError(
            f"memory_allocated {after / 1e9:.3f} GB after the close, "
            f"{(after - base) / 1e9:.3f} GB above the engine's start; "
            f"{sum(v[0] for v in live.values()) / 1e9:.3f} GB in live "
            f"tensors, the largest {top}")
    return after


def served_checks(label, eng, n_sub, max_new, vocab):
    """Every submission finished once with its full budget or was counted
    as rejected, and nothing is left in flight."""
    rids = [r.rid for r in eng.done]
    if len(rids) != len(set(rids)):
        raise AssertionError(f"{label}: a request completed twice")
    if len(rids) + eng.rejected != n_sub:
        raise AssertionError(f"{label}: {n_sub} submitted, {len(rids)} "
                             f"done, {eng.rejected} rejected")
    bad = [r.rid for r in eng.done if len(r.output) != max_new
           or not ((r.output >= 0) & (r.output < vocab)).all()]
    if bad:
        raise AssertionError(f"{label}: requests with wrong outputs: "
                             f"{bad[:10]}")
    if eng.in_flight() or eng.backlog(0.0):
        raise AssertionError(f"{label}: work left after the drain")


def tail_fields(s):
    """P99, violation rate and goodput over TAIL_MIN_REQUESTS or more."""
    if s["n_requests"] >= TAIL_MIN_REQUESTS:
        return dict(p99_ms=s["p99_ms"], violation_rate=s["violation_rate"],
                    goodput=s["goodput"])
    return {"tail": f"not reported: {s['n_requests']} requests, under "
                    f"{TAIL_MIN_REQUESTS}"}


def eval_serve(torch, kind, variants, profiles, scale):
    """Part (a): ``kind`` drives a fresh dense FIFO engine of the
    full-width ladder through ``run_serving_loop`` for EVAL_SECONDS of the
    bursty trace from EVAL_T0, scaled by ``scale``. Returns (summary,
    launches)."""
    from repro_torch.core.adapter import ControllerConfig
    from repro_torch.data.traces import paper_bursty_trace
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import GEOMETRY
    from repro_torch.serving.driver import run_serving_loop, trace_load
    from repro_torch.serving.engine import InProcessServingEngine
    geo = GEOMETRY[True]
    vocab = next(iter(variants.values()))[0].vocab_size
    cfg = ControllerConfig(interval_s=EVAL_INTERVAL, budget=EVAL_BUDGET,
                           slo_ms=EVAL_SLO_MS, beta=0.05, gamma=0.05,
                           reactive=True, queue_aware=True)
    ctrl = eval_controller(kind, profiles, cfg, window=10)
    mem0 = torch.cuda.memory_allocated()
    eng = InProcessServingEngine(variants, use_kernels=True, device=DEVICE,
                                 **geo)
    load = trace_load(paper_bursty_trace()[EVAL_T0:], scale=scale)
    log(f"  {kind}: serving {EVAL_SECONDS}s of the bursty trace from "
        f"{EVAL_T0}s at scale {scale:.5f}")
    ops.reset_launch_counts()
    t0 = time.time()
    n_sub = run_serving_loop(eng, ctrl, seconds=EVAL_SECONDS,
                             interval=EVAL_INTERVAL, load_fn=load,
                             prompt_len=geo["prompt_len"],
                             max_new=geo["max_new"], vocab=vocab,
                             slo_ms=EVAL_SLO_MS,
                             log=lambda m: log("    " + m))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = ops.launch_counts()
    served_checks(kind, eng, n_sub, geo["max_new"], vocab)
    if len(ctrl.decisions) < EVAL_SECONDS / EVAL_INTERVAL:
        raise AssertionError(f"{kind}: {len(ctrl.decisions)} decisions")
    decisions = [(round(d.t, 3), {m: n for m, n in
                                  d.allocation.units.items() if n})
                 for d in ctrl.decisions]
    if kind == "Cocktail":
        members = set().union(*(u for _, u in decisions))
        stray = {r.backend for r in eng.done} - members
        if stray:
            raise AssertionError(f"Cocktail served on {stray}, outside its "
                                 f"ensembles {members}")
    best = max(a for _, a in variants.values())
    s = eng.summarize(EVAL_SLO_MS, best) if eng.done else {}
    if not s:
        raise AssertionError(f"{kind}: no request completed ({n_sub} "
                             f"submitted, {eng.rejected} rejected)")
    summary = dict(decisions=decisions, submitted=n_sub,
                   served=s["n_requests"], rejected=eng.rejected,
                   avg_cost_units=s["avg_cost_units"],
                   accuracy_loss=s["accuracy_loss"], p50_ms=s["p50_ms"],
                   wall_s=wall, **tail_fields(s))
    summary["memory_left_bytes"] = close_engine(torch, eng) - mem0
    del eng
    log(f"  {kind}: " + json.dumps(summary))
    return summary, launches


def eval_replay(torch, profiles, scale):
    """Part (b): the replay launcher in process with ``--engine
    --full-width`` (its ``chunked`` scheduler: the dense fused tick) on the
    profile phase's profiles. Returns (summary, launches)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import replay_trace
    from repro_torch.launch.serve import GEOMETRY
    geo = GEOMETRY[True]
    vocab = next(iter(replay_trace.engine_ladder(True).values()))[0].vocab_size
    ops.reset_launch_counts()
    t0 = time.time()
    out = replay_trace.main(
        ["--engine", "--full-width", "--device", DEVICE, "--engine-seconds",
         str(EVAL_REPLAY_SECONDS), "--engine-scale", f"{scale:.5f}"],
        profiles=profiles, log=lambda m: log("    " + m))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    res = out["engine"]
    eng, s = res["engine"], res["summary"]
    if s is None:
        raise AssertionError("replay launcher: no request completed")
    served_checks("replay launcher", eng, res["submitted"], geo["max_new"],
                  vocab)
    if launches["flash_decode_chunk"] < 1:
        raise AssertionError(f"the replay's chunked engine never ran "
                             f"flash_decode's chunk form: {launches}")
    summary = dict(submitted=res["submitted"], served=s["n_requests"],
                   rejected=eng.rejected, avg_cost_units=s["avg_cost_units"],
                   accuracy_loss=s["accuracy_loss"],
                   wall_s=time.time() - t0, **tail_fields(s))
    close_engine(torch, eng)
    del eng, res, out
    log("  replay launcher: " + json.dumps(summary))
    return summary, launches


def eval_sim(profiles):
    """Part (c): ``run_experiment`` of the five controllers on
    ``SimCluster`` over the card's measured profiles, on the bursty trace
    scaled as ``launch.llm_autoscale`` scales it (base 2x, spike 4.5x the
    slowest rung's th(4)), at its budget of 12 units. Returns name ->
    summary."""
    from repro_torch.core.adapter import ControllerConfig
    from repro_torch.data.traces import paper_bursty_trace
    from repro_torch.sim.runner import run_experiment
    cap4 = min(p.throughput(4) for p in profiles.values())
    trace = paper_bursty_trace(base=cap4 * 2.0, spike=cap4 * 4.5)
    cfg = ControllerConfig(budget=12, slo_ms=EVAL_SLO_MS, beta=0.02,
                           gamma=0.05)
    best = max(p.accuracy for p in profiles.values())
    fastest = max(profiles, key=lambda m: profiles[m].th_slope)
    top = max(profiles, key=lambda m: profiles[m].accuracy)
    log(f"  simulator: the bursty trace at base {cap4 * 2.0:.3f}, spike "
        f"{cap4 * 4.5:.3f} req/s, budget 12")
    out = {}
    for kind in EVAL_CONTROLLERS:
        ctrl = eval_controller(kind, profiles, cfg, window=120)
        profs, warm = ({top: profiles[top]}, {top: 4}) if kind == "VPA+" \
            else (profiles, {fastest: 4})
        r = run_experiment(kind, ctrl, profs, trace, slo_ms=EVAL_SLO_MS,
                           warm_start=warm, reference_accuracy=best)
        out[kind] = {k: r.summary[k] for k in (
            "n_requests", "violation_rate", "p99_ms", "accuracy_loss",
            "avg_cost_units", "goodput")}
        if not out[kind]["n_requests"] > 0:
            raise AssertionError(f"simulator: {kind} served nothing")
    return out


def eval_phase(torch, measured):
    """The paper's evaluation on the card: (a) the five controllers, each
    on a fresh dense engine of the full-width ladder; (b) the replay
    launcher's engine replay; (c) the simulator on the same measured
    profiles. Returns the phase's launch counts."""
    from collections import Counter
    from repro_torch.launch.serve import build_ladder
    t_phase = time.time()
    log("[13] eval: InfAdapter, MS+, VPA+, INFaaS and Cocktail on the "
        "full-width ladder over the bursty trace; the replay launcher; the "
        "simulator on the measured profiles")
    variants = build_ladder("tinyllama-1.1b", full_width=True)
    profiles = {n: measured[n] for n in variants}
    top = max(variants, key=lambda n: variants[n][0].num_layers)
    low = min(variants, key=lambda n: variants[n][0].num_layers)
    cap = profiles[top].throughput(EVAL_BUDGET)
    scale = EVAL_BASE_SHARE * cap / EVAL_BASE
    spike = 95.0 * scale
    log(f"  scale {scale:.5f}: base {EVAL_BASE * scale:.3f} req/s = "
        f"{EVAL_BASE_SHARE} x {top}'s th({EVAL_BUDGET}) {cap:.3f}; spike "
        f"{spike:.3f} req/s against {low}'s th({EVAL_BUDGET}) "
        f"{profiles[low].throughput(EVAL_BUDGET):.3f}")
    if not cap < spike < profiles[low].throughput(EVAL_BUDGET):
        raise AssertionError("the spike does not sit between the rungs' "
                             "capacities")
    summary, launches = {"scale": scale, "engine": {}}, Counter()
    for kind in EVAL_CONTROLLERS:
        summary["engine"][kind], n = eval_serve(torch, kind, variants,
                                                profiles, scale)
        launches.update(n)
    for k in ("flash_prefill", "flash_decode"):
        if launches[k] < 1:
            raise AssertionError(f"{k} never ran in the controllers' loops: "
                                 f"{dict(launches)}")
    summary["replay"], n = eval_replay(torch, profiles, scale)
    launches.update(n)
    t0 = time.time()
    summary["sim"] = eval_sim(profiles)
    summary["sim_wall_s"] = time.time() - t0
    log(f"  {'controller':<11} | simulator: {'viol%':>7} {'p99 ms':>9} "
        f"{'acc loss':>8} {'cost':>6} | engine: {'served':>6} {'rej':>4} "
        f"{'viol%':>7} {'p99 ms':>9} {'acc loss':>8} {'cost':>6}")
    for kind in EVAL_CONTROLLERS:
        m, e = summary["sim"][kind], summary["engine"][kind]
        tail = (f"{e['violation_rate'] * 100:6.2f}% {e['p99_ms']:9.1f}"
                if "p99_ms" in e else f"{'n/a':>7} {'n/a':>9}")
        log(f"  {kind:<11} | {m['violation_rate'] * 100:17.2f}% "
            f"{m['p99_ms']:9.1f} {m['accuracy_loss']:8.3f} "
            f"{m['avg_cost_units']:6.2f} | {e['served']:14d} "
            f"{e['rejected']:4d} {tail} {e['accuracy_loss']:8.3f} "
            f"{e['avg_cost_units']:6.2f}")
    summary["wall_s"] = time.time() - t_phase
    log(f"  eval phase: {summary['wall_s']:.1f}s; launches "
        f"{dict(launches)}")
    log("  eval summary " + json.dumps(summary, default=str))
    return dict(launches)


def profiling_phase(torch, profiles):
    """The paper's Profiler on the card (``repro_torch.profiling``): the
    full-width L8/L15/L22 dense ladder at the serve geometry, sync FIFO,
    kernels on, steps replayed, each rung swept by ``EngineProfiler`` at
    PROF_POINTS (PROF_RPP requests a point after PROF_WARMUP) on a
    throwaway backend, and L22 once more on a paged engine. Per rung: every
    point, both fits with R², readiness, and beside them the serve phase's
    ``calibrate()`` profile (``profiles``), the H100 ``roofline_profile``
    and ``roofline_scale_factor`` at MAX_NEW tokens a request. Asserts
    th(8) > th(1) and R² in [0, 1] on every rung, every throwaway closed,
    and the store's save/load round trip equal. Then drift on the live L8
    rung at 2 units: a healthy check within band; a host stall of
    DRIFT_STALL_X mean chunk times ahead of every decode chunk
    (``VariantBackend._dispatch_chunk``) flagged; ``OnlineRecalibrator``
    re-profiles it at (1, 2), throughput(1) falls and the controller
    provisions more units for the same load. Returns (launch counts of the
    phase, summary, the dense rungs' measured ``VariantProfile``s)."""
    import dataclasses
    import tempfile
    import numpy as np
    from repro_torch.core.adapter import (ControllerConfig,
                                          InfAdapterController)
    from repro_torch.core.forecaster import MovingMaxForecaster
    from repro_torch.core.profiles import roofline_profile
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_and_serve import stall_decode_chunks
    from repro_torch.launch.serve import GEOMETRY, build_ladder
    from repro_torch.profiling.calibrate import roofline_scale_factor
    from repro_torch.profiling.drift import DriftDetector, OnlineRecalibrator
    from repro_torch.profiling.measure import EngineProfiler
    from repro_torch.profiling.store import ProfileStore
    from repro_torch.serving.api import Request
    from repro_torch.serving.engine import InProcessServingEngine
    t_phase = time.time()
    log("[11] profile: EngineProfiler on the full-width ladder (dense L8/L15/"
        "L22, paged L22), the profile store, drift and recalibration, the "
        "H100 roofline")
    variants = build_ladder("tinyllama-1.1b", full_width=True)
    geo = GEOMETRY[True]
    vocab = next(iter(variants.values()))[0].vocab_size
    engines = {
        "dense": InProcessServingEngine(variants, use_kernels=True,
                                        device=DEVICE, enforce_units=True,
                                        **geo)}
    top = max(variants, key=lambda n: variants[n][0].num_layers)
    engines["paged"] = InProcessServingEngine(
        {top: variants[top]}, use_kernels=True, device=DEVICE,
        enforce_units=True, kv_cache="paged", kv_page_size=PAGE, **geo)
    throwaways = []
    for eng in engines.values():
        make = eng._make_backend
        eng._make_backend = (lambda make: lambda name: throwaways.append(
            make(name)) or throwaways[-1])(make)

    def fmt(p, n):
        return f"th({n}) {p.throughput(n):.3f} req/s, p99({n}) " \
               f"{p.p99_ms(n):.1f} ms"

    ops.reset_launch_counts()
    summary, measured = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        store = ProfileStore(f"{tmp}/profiles.json")
        rungs = [(n, "dense") for n in variants] + [(top, "paged")]
        for name, kind in rungs:
            cfg, acc = variants[name]
            t0 = time.time()
            m = EngineProfiler(engines[kind], points=PROF_POINTS,
                               requests_per_point=PROF_RPP,
                               warmup=PROF_WARMUP, vocab=vocab,
                               ).profile_variant(name)
            key = name if kind == "dense" else f"{name}-paged"
            measured[key] = m
            store.register(dataclasses.replace(m.profile, name=key),
                           "measured", fit=m.th_fit, meta=m.store_meta())
            roof = roofline_profile(cfg, acc, tokens_per_request=MAX_NEW)
            scale = roofline_scale_factor({name: m}, {name: cfg},
                                          tokens_per_request=MAX_NEW)
            log(f"  {key} ({kind}): sweep {time.time() - t0:.1f}s, "
                f"readiness {m.readiness_s:.3f}s")
            for pt in m.points:
                log(f"    units {pt.units}: {pt.throughput_rps:.4f} req/s, "
                    f"service mean {pt.mean_service_ms:.2f} ms, P99 "
                    f"{pt.p99_service_ms:.2f} ms, queue "
                    f"{pt.mean_queue_ms:.3f} ms, n {pt.n_requests}")
            log(f"    fit th(n) = {m.th_fit.slope:.4f} n "
                f"{m.th_fit.intercept:+.4f} req/s (R2 "
                f"{m.th_fit.r_squared:.4f}); p99(n) = {m.lat_base_ms:.2f} "
                f"+ {m.lat_k_ms:.2f}/n ms (R2 {m.lat_r_squared:.4f}); "
                f"mean(n) = {m.lat_mean_base_ms:.2f} + "
                f"{m.lat_mean_k_ms:.2f}/n ms")
            for label, p in (("measured", m.profile),
                             ("calibrate()", profiles[name]),
                             ("H100 roofline", roof)):
                log(f"    {label:>13}: slope {p.th_slope:.4f}, intercept "
                    f"{p.th_intercept:+.4f}, p = {p.lat_base_ms:.2f} + "
                    f"{p.lat_k_ms:.2f}/n ms, rt {p.rt:.3f} s; "
                    f"{fmt(p, 1)}; {fmt(p, 8)}")
            log(f"    roofline_scale_factor (measured / roofline slope, "
                f"{MAX_NEW} tokens a request): {scale:.5f}")
            if not m.profile.throughput(8) > m.profile.throughput(1):
                raise AssertionError(f"{key}: th(8) <= th(1)")
            for r2 in (m.th_fit.r_squared, m.lat_r_squared):
                if not 0.0 <= r2 <= 1.0:
                    raise AssertionError(f"{key}: R2 {r2} outside [0, 1]")
            summary[key] = {
                "points": [dataclasses.asdict(pt) for pt in m.points],
                "th_fit": [m.th_fit.slope, m.th_fit.intercept,
                           m.th_fit.r_squared],
                "p99_fit": [m.lat_base_ms, m.lat_k_ms, m.lat_r_squared],
                "mean_fit": [m.lat_mean_base_ms, m.lat_mean_k_ms],
                "readiness_s": m.readiness_s,
                "calibrate": dataclasses.asdict(profiles[name]),
                "roofline": dataclasses.asdict(roof),
                "roofline_scale_factor": scale}
        open_ = [b.name for b in throwaways if b.graphs or b._steps]
        if len(throwaways) != len(rungs) or open_:
            raise AssertionError(f"throwaways {len(throwaways)} of "
                                 f"{len(rungs)}, left open: {open_}")
        throwaways.clear()
        ladder = {n: variants[n][0] for n in variants}
        summary["ladder_scale_factor"] = roofline_scale_factor(
            {n: measured[n] for n in variants}, ladder,
            tokens_per_request=MAX_NEW)
        loaded = ProfileStore.load(store.save())
        if loaded.names() != store.names() or any(
                loaded.get(n) != store.get(n)
                or loaded.entry(n).provenance != store.entry(n).provenance
                for n in store.names()):
            raise AssertionError("the profile store's round trip differs")
        log(f"  store: {len(loaded)} profiles saved and reloaded equal; "
            f"ladder roofline_scale_factor "
            f"{summary['ladder_scale_factor']:.5f}")

        # drift on the live L8 rung, observed against the reloaded store
        low = min(variants, key=lambda n: variants[n][0].num_layers)
        eng = engines["dense"]
        eng.apply_allocation(0.0, {low: 2})
        b = eng.backends[low]
        throwaways.clear()          # the live load: not a throwaway
        detector = DriftDetector(loaded, tolerance=1.0, min_requests=8)
        rng = np.random.default_rng(5)
        rid = [0]

        def serve(n):
            for _ in range(n):
                eng.submit(Request(rid=rid[0], tokens=rng.integers(
                    0, vocab, PROMPT).astype(np.int64), max_new=MAX_NEW,
                    arrival=time.time()), low)
                rid[0] += 1
            eng.drain(0.0)
            detector.observe_engine(eng)
            return detector.check(low, units=2)
        healthy = serve(DRIFT_N)
        m1 = measured[low]
        chunk_ms = m1.points[0].mean_service_ms / (MAX_NEW // CHUNK)
        stall_s = DRIFT_STALL_X * chunk_ms / 1e3
        stall_decode_chunks(b, stall_s)
        drifted = serve(DRIFT_N)
        log(f"  drift on {low} at 2 units: healthy service ratio "
            f"{healthy.service_ratio:.3f} ({healthy.n_obs} obs, "
            f"{healthy.reason or 'within band'}); stall {stall_s * 1e3:.1f} "
            f"ms a chunk ({DRIFT_STALL_X} x {chunk_ms:.2f} ms): ratio "
            f"{drifted.service_ratio:.3f} ({drifted.reason})")
        if healthy.drifted or healthy.n_obs < 8:
            raise AssertionError(f"healthy check: {healthy}")
        if not drifted.drifted:
            raise AssertionError(f"stalled check not flagged: {drifted}")
        lam = 0.8 * m1.profile.throughput(1)
        ctrl = InfAdapterController(
            {low: loaded.get(low)}, MovingMaxForecaster(window=5),
            ControllerConfig(budget=B, slo_ms=10_000.0, min_load=lam))
        before = ctrl.decide(0.0, eng).allocation
        recal = OnlineRecalibrator(
            EngineProfiler(eng, warmup=2, vocab=vocab), loaded,
            controller=ctrl, detector=detector, points=(1, 2),
            requests_per_point=6)
        t0 = time.time()
        m2 = recal.recalibrate(low)
        after = ctrl.decide(0.0, eng).allocation
        log(f"  recalibrated {low} in {time.time() - t0:.1f}s: th(1) "
            f"{m1.profile.throughput(1):.4f} -> "
            f"{m2.profile.throughput(1):.4f} req/s; units for "
            f"{lam:.3f} req/s {before.units} -> {after.units}")
        if throwaways:
            raise AssertionError("recalibration built a throwaway")
        if not m2.profile.throughput(1) < m1.profile.throughput(1):
            raise AssertionError("throughput(1) did not fall")
        if ctrl.profiles[low] != m2.profile or not loaded.entry(
                low).meta.get("recalibrated"):
            raise AssertionError("recalibration did not patch the "
                                 "controller and the store")
        if not after.total_units() > before.total_units():
            raise AssertionError(f"allocation did not grow: {before.units} "
                                 f"-> {after.units}")
        if b.slot_cap != 2 or eng.backends[low] is not b:
            raise AssertionError("the live backend was not restored")
        summary["drift"] = {
            "healthy_ratio": healthy.service_ratio,
            "drifted_ratio": drifted.service_ratio, "stall_ms": stall_s * 1e3,
            "chunk_ms": chunk_ms, "th1_before": m1.profile.throughput(1),
            "th1_after": m2.profile.throughput(1), "lam": lam,
            "units_before": before.units, "units_after": after.units,
            "recal_points": [dataclasses.asdict(pt) for pt in m2.points]}
        eng.apply_allocation(0.0, {})
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    for k in ("flash_prefill", "flash_decode", "paged_decode"):
        if launches[k] < 1:
            raise AssertionError(f"{k} never ran in the profile phase: "
                                 f"{launches}")
    del engines, eng, b
    torch.cuda.empty_cache()
    summary["wall_s"] = time.time() - t_phase
    log(f"  profile phase: {summary['wall_s']:.1f}s; launches "
        + json.dumps(launches))
    log("  profile summary " + json.dumps(summary))
    return launches, summary, {n: measured[n].profile for n in variants}


def head_inputs(torch, gen, dtype, heads):
    """Makers of each attention kernel's operands at one config's serve
    shapes: ``heads`` = (query heads, KV heads, head dim) (gemma-2b: 8 on
    one KV head of hd 256; granite-moe-3b-a800m: 24 on 8 of hd 64), the
    serve geometry's B 8, 512-token prompts, ring C 576, 36 pages of 16,
    chunks of 16."""
    dev = torch.device(DEVICE)
    H_, KV_, HD_ = heads
    G = H_ // KV_

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    return {
        "prefill": lambda: (randn(B, PROMPT, H_, HD_),
                            randn(B, PROMPT, KV_, HD_),
                            randn(B, PROMPT, KV_, HD_)),
        "decode": lambda: (randn(B, KV_, G, HD_),
                           randn(B, KV_, CAP, HD_),
                           randn(B, KV_, CAP, HD_),
                           torch.zeros((B, CAP), device=dev)),
        "chunk": lambda: dense_chunk_inputs(torch, gen, B, CK, KV_, G,
                                            HD_, CAP, dtype),
        "paged": lambda: paged_inputs(torch, gen, B, KV_, G, HD_,
                                      PAGE, WIDTH, dtype),
        "paged_chunk": lambda: chunk_inputs(
            torch, gen, B, KV_, G, HD_, PAGE, WIDTH, WIDTH, CK,
            dtype, start_range=(PS_SHARED, PROMPT - CK)),
    }


def timed_row(torch, fn, plain, sets, nbytes, flops, dt, library=None,
              plain_iters=4):
    """Kernel, plain and device times of ``fn`` over ``sets`` beside the
    bound of ``nbytes`` and ``flops`` in ``dt``; ``library`` is (fn, sets)
    of one PyTorch call computing the same function (SDPA), or None."""
    b_ms, b_by = bound(nbytes, flops, dt)
    row = dict(ms=time_ms(torch, fn, sets),
               plain_ms=time_ms(torch, plain, sets, iters=plain_iters),
               bound_ms=b_ms, bound_by=b_by,
               device_ms=device_ms(torch, fn, sets), library_ms=None,
               library_device_ms=None)
    if library is not None:
        lib, lib_sets = library
        row.update(library_ms=time_ms(torch, lib, lib_sets),
                   library_device_ms=device_ms(torch, lib, lib_sets))
    return row


def sdpa_mask(q, k, v, m):
    """SDPA with a float mask: the chunk forms' and decode step's yardstick
    (the port never calls it)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                          enable_gqa=True)


def dense_chunk_row(torch, fd, mk, heads):
    """flash_decode's chunk form in bf16 at one config's fused tick (``mk``
    = ``head_inputs``' makers, ``heads`` = (query heads, KV heads, head
    dim)): ``timed_row`` over inputs rotated through more than 3x the L2
    size, beside SDPA with a (B, H, ck, C) float mask. The bound reads q,
    out, the bias and each row's K/V below its largest query length once;
    its operations are QK^T and PV over each query's valid keys on the
    bf16 tensor cores. Returns (row, the rotated sets)."""
    H_, KV_, HD_ = heads
    first = mk["chunk"]()
    sets = rotated(first, mk["chunk"], ())
    valid = (first[3] == 0).sum(-1)
    lmax = valid.max(1).values
    return timed_row(
        torch, fd.flash_decode_chunk, fd.flash_decode_chunk_plain, sets,
        2 * (2 * int(lmax.sum()) * KV_ * HD_ + 2 * B * CK * H_ * HD_)
        + 4 * B * CK * CAP, 4 * H_ * HD_ * int(valid.sum()), torch.bfloat16,
        library=(sdpa_mask, [(q.reshape(B, CK, H_, HD_).transpose(1, 2), k,
                              v, m[:, None]) for q, k, v, m in sets])), sets


def paged_chunk_row(torch, pd, mk, heads):
    """paged_decode's chunk form in bf16 at one config's fused tick, as
    ``dense_chunk_row`` (no single library call). The bound reads q, out,
    the lengths, the live table entries and each row's K/V below its
    largest length once; its operations are QK^T and PV over each query's
    own length. Returns (row, the rotated sets)."""
    H_, KV_, HD_ = heads
    first = mk["paged_chunk"]()
    sets = rotated(first, mk["paged_chunk"], (3, 4))
    lengths = first[4].long()
    lmax = lengths.max(1).values
    return timed_row(
        torch, pd.paged_flash_decode_chunk, pd.paged_flash_decode_chunk_plain,
        sets, 2 * (2 * int(lmax.sum()) * KV_ * HD_ + 2 * B * CK * H_ * HD_)
        + 4 * int(((lmax + PAGE - 1) // PAGE).sum()) + 4 * B * CK,
        4 * H_ * HD_ * int(lengths.sum()), torch.bfloat16), sets


def sdpa_causal(q, k, v):
    """Causal SDPA: flash_prefill's yardstick (the port never calls it)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                          enable_gqa=True)


def hd32_inputs(torch, gen):
    """A maker of flash_prefill's inputs at the reference kernel test's
    hd-32 shape (B 2, S 128, 4 heads on 4 KV heads), bf16."""
    return lambda: tuple(
        torch.randn((2, 128, 4, 32), generator=gen, device=DEVICE).to(
            torch.bfloat16) for _ in range(3))


def window_ab(torch, fp, pre_inputs, gen):
    """flash_prefill of the imported ``repro_torch`` in bf16 with a window
    (``--ab``): at hymba-1.5b's heads (window 256) and at the hd-32 test
    shape (window 32), held to the plain version, timed beside SDPA with
    the boolean mask (``window_prefill_row``), with the kernel the
    profiler sees held to the checkout's plan."""
    bf, rows = torch.bfloat16, []
    for tag, hd, w, make in (
            ("hymba serve", HD, HYMBA_WINDOW,
             lambda: pre_inputs(B, PROMPT, HYMBA_H, HYMBA_KV, HD, bf)),
            ("hd32 test", 32, 32, hd32_inputs(torch, gen))):
        row, sets = window_prefill_row(torch, fp, make, w)
        label = f"flash_prefill {tag} shape hd {hd} window {w}"
        fn = lambda q, k, v, w=w: fp.flash_prefill_bshd(  # noqa: E731
            q, k, v, window=w)
        err = check(f"{label} bfloat16", fn(*sets[0]),
                    fp.flash_prefill_plain(*sets[0], window=w), bf)
        seen = kernels_seen(torch, fn, sets[0])
        want = fp.launch_plan(hd, bf)[0]
        if seen is not None and (len(seen) != 1 or want not in seen[0]):
            raise AssertionError(f"{label}: kernels {seen}, planned {want}")
        log(f"  {label}: {seen}, device {ms4(row['device_ms'])} ms, SDPA "
            f"device {ms4(row['library_device_ms'])}, bound "
            f"{row['bound_ms']:.4f} ({row['bound_by']})")
        rows.append(dict(name="flash_prefill", shape=tag, hd=hd, window=w,
                         kernel=seen, max_abs_err=err, **row))
    return rows


def window_prefill_row(torch, fp, make, w):
    """flash_prefill in bf16 with a window of ``w`` on the inputs ``make()``
    draws (q (B,S,H,hd), k, v (B,S,KV,hd)), rotated through more than 3x
    the L2 size, beside SDPA with the (S, S) boolean mask. The bound reads
    q, k, v and writes out once; its operations are QK^T and PV over the
    pairs the window leaves. Returns (row, the rotated sets)."""
    first = make()
    sets = rotated(first, make, ())
    b, s, h, hd = first[0].shape
    kv = first[1].shape[2]
    mask = fp.causal_window_mask(s, w, torch.device(DEVICE))
    return timed_row(
        torch, lambda q, k, v: fp.flash_prefill_bshd(q, k, v, window=w),
        lambda q, k, v: fp.flash_prefill_plain(q, k, v, window=w), sets,
        2 * 2 * b * s * (h + kv) * hd, 4 * b * h * int(mask.sum()) * hd,
        torch.bfloat16,
        library=(sdpa_mask, [tuple(t.transpose(1, 2).contiguous()
                                   for t in st) + (mask,) for st in sets])
    ), sets


def prefill_row(torch, fp, mk, heads, dt):
    """flash_prefill in ``dt`` at one config's prefill (``mk`` =
    ``head_inputs``' makers, ``heads`` = (query heads, KV heads, head
    dim)): ``timed_row`` over inputs rotated through more than 3x the L2
    size, beside causal SDPA. The bound reads q, k, v and writes out once;
    its operations are QK^T and PV over the causal pairs. Returns (row,
    the rotated sets)."""
    H_, KV_, HD_ = heads
    esz = torch.tensor([], dtype=dt).element_size()
    first = mk["prefill"]()
    sets = rotated(first, mk["prefill"], ())
    pairs = PROMPT * (PROMPT + 1) // 2
    return timed_row(
        torch, fp.flash_prefill_bshd, fp.flash_prefill_plain, sets,
        esz * 2 * B * PROMPT * (H_ + KV_) * HD_, 4 * B * H_ * pairs * HD_,
        dt, library=(sdpa_causal, [tuple(t.transpose(1, 2).contiguous()
                                         for t in st) for st in sets])), sets


def decode_row(torch, fd, mk, heads, dt):
    """flash_decode's decode step in ``dt`` at one config's serve shape,
    as ``prefill_row``, beside SDPA with a (B, 1, 1, C) float mask. The
    bound reads q, the bias and K/V and writes out once; its operations
    are QK^T and PV over the C positions. Returns (row, the rotated
    sets)."""
    H_, KV_, HD_ = heads
    esz = torch.tensor([], dtype=dt).element_size()
    first = mk["decode"]()
    sets = rotated(first, mk["decode"], ())
    return timed_row(
        torch, fd.flash_decode_bkhd, fd.flash_decode_plain, sets,
        esz * (2 * B * H_ * HD_ + 2 * B * KV_ * CAP * HD_) + 4 * B * CAP,
        4 * B * H_ * CAP * HD_, dt, library=(sdpa_mask, [
            (q.reshape(B, H_, 1, HD_), k, v, m[:, None, None, :])
            for q, k, v, m in sets])), sets


def kernels_seen(torch, fn, args):
    """Short names (up to the argument list) of the port's CUDA kernels
    that ``fn(*args)`` launches, from ``kernel_events``; None when the
    profiler gave no whole trace."""
    import re
    evs = kernel_events(torch, fn, [args])
    if evs is None:
        return None
    return sorted({m.group(0) for e in evs for m in [
        re.search(r"(flash|paged|ssd)_\w+(<[^()]*>)?", e.key)] if m})


def wide_edge_checks(torch, fd, fp, gen, hd=256):
    """flash_prefill and flash_decode's decode step at hd 256 or 128 on the
    edges of their bf16 routes (the pipelined ``wgmma`` prefill, the
    tensor-core step kernel), against the plain versions in bf16 and fp32
    (as in tests/test_torch_cuda.py). At hd 256 on gemma's heads: the
    prefill at S 1, 63, 65 and 129, at B 1 with a softcap, G 3 on two KV
    heads with a window and G 7 (an unpaired head); the decode step at C 1,
    C just below and just above its split count, only the first key
    unbiased, G 3 and G 7, and a split of several 64-position tiles. At hd
    128 on internvl2-26b's G 6: the prefill at S 1, 37 and 130, G 3 and G 5
    (an unpaired head), a window of 32 with a softcap; the decode step at
    C 1, around its split count, only the first key unbiased, C 2000, G 8
    and G 16."""
    dev = torch.device(DEVICE)
    splits = fd.STEP_SPLITS[hd]
    if hd == 256:
        pre = ((2, 1, 8, 1, 0, 0.0), (2, 63, 8, 1, 0, 0.0),
               (2, 65, 8, 1, 0, 0.0), (1, 129, 8, 1, 0, 30.0),
               (2, 130, 6, 2, 48, 0.0), (1, 200, 7, 1, 0, 0.0))
        dec = ((8, 1, 8, 1, 0.0, False), (8, 1, 8, splits - 1, 0.0, False),
               (8, 1, 8, splits + 1, 30.0, True),
               (8, 1, 8, CAP, 0.0, "first"), (4, 2, 3, 203, 0.0, True),
               (4, 1, 7, CAP, 30.0, False), (2, 1, 8, 2000, 0.0, True))
    else:
        pre = ((2, 1, 12, 2, 0, 0.0), (2, 37, 48, 8, 0, 0.0),
               (2, 130, 12, 2, 0, 0.0), (2, 130, 6, 2, 0, 0.0),
               (1, 200, 5, 1, 0, 30.0), (2, 200, 12, 2, 32, 30.0))
        dec = ((8, 8, 6, 1, 0.0, False), (8, 8, 6, splits - 1, 0.0, False),
               (8, 8, 6, splits + 1, 30.0, True),
               (8, 8, 6, CAP, 0.0, "first"), (2, 8, 6, 2000, 0.0, True),
               (4, 4, 8, 203, 30.0, True), (2, 2, 16, CAP, 0.0, True))
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt)[6:]

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dt)
        for b, s, h, kv, w, sc in pre:
            q, k, v = randn(b, s, h, hd), randn(b, s, kv, hd), \
                randn(b, s, kv, hd)
            check(f"flash_prefill hd {hd} B={b} S={s} H/KV={h}/{kv} "
                  f"window={w} softcap={sc} {name}",
                  fp.flash_prefill_bshd(q, k, v, window=w, softcap=sc),
                  fp.flash_prefill_plain(q, k, v, window=w, softcap=sc), dt)
        for b, kv, g, c, sc, masked in dec:
            q, k, v = randn(b, kv, g, hd), randn(b, kv, c, hd), \
                randn(b, kv, c, hd)
            bias = torch.zeros((b, c), device=dev)
            if masked == "first":
                bias[:, 1:] = -1e9
            elif masked:
                bias[:, c // 2:] = -1e9
            check(f"flash_decode hd {hd} B={b} KV={kv} G={g} C={c} "
                  f"softcap={sc} bias={masked} {name}",
                  fd.flash_decode_bkhd(q, k, v, bias, softcap=sc),
                  fd.flash_decode_plain(q, k, v, bias, softcap=sc), dt)


HEAD_KINDS = ("prefill", "decode", "chunk", "paged", "paged_chunk")


def head_kernel_rows(torch, fd, fp, pd, gen, heads, tag, hd32=False,
                     kinds=HEAD_KINDS):
    """The attention kernels of ``kinds`` at one config's serve shapes
    (``heads`` = (query heads, KV heads, head dim)) against their plain
    versions in bf16 and fp32 (paged: also NaN pages past every length),
    with ``hd32`` flash_prefill at hd 32 with a window (the reference
    kernel test's shape), then their times in bf16 (flash_prefill and
    flash_decode's decode step in fp32 too). Returns {kernel name:
    {"<tag>_<key>": ..., "hd32_<key>": ...}} for the JSON line (bf16)."""
    H_, KV_, HD_ = heads
    G = H_ // KV_
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt)[6:]
        mk = head_inputs(torch, gen, dt, heads)
        for key, fn, plain in (
                ("prefill", fp.flash_prefill_bshd, fp.flash_prefill_plain),
                ("decode", fd.flash_decode_bkhd, fd.flash_decode_plain),
                ("chunk", fd.flash_decode_chunk, fd.flash_decode_chunk_plain),
                ("paged", pd.paged_flash_decode_bkhd,
                 pd.paged_flash_decode_plain),
                ("paged_chunk", pd.paged_flash_decode_chunk,
                 pd.paged_flash_decode_chunk_plain)):
            if key not in kinds:
                continue
            a = mk[key]()
            errs[(key, dt)] = check(f"{key} hd {HD_} {tag} shape {name}",
                                    fn(*a), plain(*a), dt)
        for key, a, fn, plain in (
                ("paged", paged_inputs(torch, gen, B, KV_, G, HD_, PAGE,
                                       WIDTH, dt, poison=True),
                 pd.paged_flash_decode_bkhd, pd.paged_flash_decode_plain),
                ("paged_chunk", chunk_inputs(torch, gen, B, KV_, G, HD_, PAGE,
                                             WIDTH, WIDTH, CK, dt,
                                             poison=True),
                 pd.paged_flash_decode_chunk,
                 pd.paged_flash_decode_chunk_plain)):
            if key not in kinds:
                continue
            out = fn(*a)
            if not torch.isfinite(out).all():
                raise AssertionError(f"{key} hd {HD_} {tag}: non-finite "
                                     f"output past NaN pages")
            check(f"{key} hd {HD_} {tag} NaN pages past every length "
                  f"{name}", out, plain(*a), dt)
        if not hd32:
            continue
        q, k, v = (torch.randn(s, generator=gen, device=DEVICE).to(dt)
                   for s in ((2, 128, 4, 32), (2, 128, 4, 32),
                             (2, 128, 4, 32)))
        errs[("hd32", dt)] = check(
            f"flash_prefill hd 32 window 32 {name}",
            fp.flash_prefill_bshd(q, k, v, window=32),
            fp.flash_prefill_plain(q, k, v, window=32), dt)
    torch.cuda.synchronize()

    names = {"prefill": "flash_prefill", "decode": "flash_decode",
             "chunk": "flash_decode_chunk", "paged": "paged_decode"}
    rows = {names[k]: {} for k in kinds if k in names}
    for dt in (torch.bfloat16, torch.float32):
        esz, name = torch.tensor([], dtype=dt).element_size(), str(dt)[6:]
        mk = head_inputs(torch, gen, dt, heads)
        res = {}
        for key, timed, mod in (("prefill", prefill_row, fp),
                                ("decode", decode_row, fd)):
            if key not in kinds:
                continue
            row, sets = timed(torch, mod, mk, heads, dt)
            # the kernel the checkout's plan picks, as the profiler sees it
            # (None: the profiler gave no whole trace, logged)
            row["kernel"] = kernels_seen(
                torch, fp.flash_prefill_bshd if mod is fp
                else fd.flash_decode_bkhd, sets[0])
            want = (fp.launch_plan(HD_, dt)[0] if mod is fp else fd.KERNELS[
                fd.launch_plan(1, G, HD_, dt, False)[0], False][1])
            if row["kernel"] is not None and (
                    len(row["kernel"]) != 1 or want not in row["kernel"][0]):
                raise AssertionError(f"{names[key]} {tag} {name}: kernels "
                                     f"{row['kernel']}, planned {want}")
            res[names[key]] = row
        if dt == torch.bfloat16 and "chunk" in kinds:
            res["flash_decode_chunk"] = dense_chunk_row(torch, fd, mk,
                                                        heads)[0]
        if dt == torch.bfloat16 and "paged_chunk" in kinds:
            res["paged_chunk"] = paged_chunk_row(torch, pd, mk, heads)[0]
        if dt == torch.bfloat16 and "paged" in kinds:
            first = mk["paged"]()
            sets = rotated(first, mk["paged"], (3, 4))
            lengths = first[4].long()
            live = int(lengths.sum())
            res["paged_decode"] = timed_row(
                torch, pd.paged_flash_decode_bkhd,
                pd.paged_flash_decode_plain, sets,
                esz * (2 * live * KV_ * HD_ + 2 * B * H_ * HD_)
                + 4 * int(((lengths + PAGE - 1) // PAGE).sum()) + 4 * B,
                4 * H_ * live * HD_, dt)
        if dt == torch.bfloat16 and hd32:
            res["hd32"] = window_prefill_row(torch, fp,
                                             hd32_inputs(torch, gen), 32)[0]
        for key, r in res.items():
            lib = ("no single library call" if r["library_ms"] is None else
                   f"SDPA {r['library_ms']:.4f} (device "
                   f"{ms4(r['library_device_ms'])})")
            seen = (f"  {r['kernel'] or ['kernel not seen']}"
                    if "kernel" in r else "")
            log(f"  {key:<18s} {name:<9s} hd "
                f"{32 if key == 'hd32' else HD_}: kernel {r['ms']:.4f} "
                f"(device {ms4(r['device_ms'])})  plain {r['plain_ms']:.4f}"
                f"  {lib}  bound {r['bound_ms']:.4f} ({r['bound_by']})"
                f"{seen}")
        if dt != torch.bfloat16:
            continue
        err = {"flash_prefill": "prefill", "flash_decode": "decode",
               "flash_decode_chunk": "chunk", "paged_decode": "paged"}
        for kernel, row in rows.items():
            if kernel in res:
                row.update({f"{tag}_{k}": v for k, v in res[kernel].items()})
                row[f"{tag}_max_abs_err"] = errs[(err[kernel], dt)]
        if "paged_chunk" in res:
            row = rows.setdefault("paged_decode", {})
            row.update({f"{tag}_chunk_{k}": v
                        for k, v in res["paged_chunk"].items()})
            row[f"{tag}_chunk_max_abs_err"] = errs[("paged_chunk", dt)]
        if hd32:
            rows["flash_prefill"].update(
                {f"hd32_{k}": v for k, v in res["hd32"].items()},
                hd32_max_abs_err=errs[("hd32", dt)])
    return rows


def fused_tick_check(torch, arch, lm_on, lm_off, params, toks, tol):
    """Both fused ticks' calls, kernels on vs off: one CK-token chunk per
    row at position PROMPT after a prefill of ``toks``, against the dense
    ring (``prefill_chunk``: one flash_decode chunk-form launch per layer)
    and through the page pool (``prefill_chunk_paged``: one paged_decode
    launch per layer), logits held to ``tol``. Returns
    {"dense"|"paged": (rel err, launches)}."""
    from repro_torch.kernels import ops
    dev = toks.device
    L = lm_on.cfg.num_layers
    start = torch.full((B,), PROMPT, device=dev)
    n_valid = torch.full((B,), CK, device=dev)
    chunk = toks[:, :CK]
    out = {}
    for kind, kernel in (("dense", "flash_decode_chunk"),
                         ("paged", "paged_decode")):
        logits, got = [], None
        for lm in (lm_on, lm_off):
            if kind == "dense":
                _, cache = lm.prefill(params, {"tokens": toks}, max_len=CAP)
                step = lm.prefill_chunk
            else:
                first, pref = lm.prefill(params, {"tokens": toks},
                                         max_len=PROMPT)
                cache = lm.init_paged_cache(B, B * WIDTH + 1, PAGE, WIDTH,
                                            dev)
                lm.paged_admit(cache, pref, torch.zeros(
                    B, dtype=torch.int64, device=dev),
                    torch.argmax(first, -1),
                    torch.arange(1, B * WIDTH + 1,
                                 device=dev).reshape(B, WIDTH),
                    torch.arange(B, device=dev))
                step = lm.prefill_chunk_paged
            n0 = ops.launch_counts()
            logits.append(step(params, cache, chunk, start, n_valid)[0])
            n1 = ops.launch_counts()
            got = got or {k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]}
            del cache
        rel = rel_err(logits[:1], logits[1:], lm_on.cfg.vocab_size)
        log(f"  {arch} L{L} {kind} fused tick (chunk of {CK} at {PROMPT}): "
            f"logits rel err on vs off {rel:.3e}; launches {got}")
        if got != {kernel: L} or rel > tol \
                or not bool(torch.isfinite(logits[0]).all()):
            raise AssertionError(f"{arch} {kind} fused tick: launches {got}"
                                 f" (want {L} {kernel}), rel err {rel}")
        out[kind] = (rel, got[kernel])
    return out


def dense_model_check(torch, arch, paged=True, fused=False,
                      sensitivity=False, prefix=0):
    """``arch`` at full width (its published depth, bf16) with random
    seeded weights: prefill of B x PROMPT tokens and 8 decode steps with
    the kernels on and off (and, with ``paged``, the steps through the page
    pool with the kernels on; with ``fused``, both fused ticks' calls on
    and off, ``fused_tick_check``), logits held to BF16_LOGIT_TOL,
    launches asserted per prefill and per step, wall and device ms (one
    prefill and one decode step under ``torch.profiler``) printed; then a
    2-layer fp32 rung of the same widths must give identical greedy tokens
    kernels on vs off (and paged vs dense). With ``sensitivity`` the logits
    are held instead to twice what the kernels-off path itself gives with
    its embedding table perturbed by EMBED_NOISE (relative), where that
    exceeds BF16_LOGIT_TOL: a deep random MoE routes some token to another
    expert after any bf16 rounding, and its logits part from there. With
    ``prefix`` (the VLM) the prefill, the decode steps and the fp32 rung
    run after an image prefix of that many seeded ``patch_embeds`` (the
    cache grows by it), while the paged steps and the fused ticks stay
    text-only, as the engine serves the family (paged: against a
    text-only dense run). The params' init time and the peak of
    ``memory_allocated`` over the check are printed. Returns the
    numbers."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import LM
    from repro_torch.serving.graphs import tensor_leaves
    dev = torch.device(DEVICE)
    cfg = get_config(arch)
    L = cfg.num_layers
    toks = torch.randint(0, cfg.vocab_size, (B, PROMPT), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    lm_off, lm_on = LM(cfg), LM(cfg.replace(use_kernels=True))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t_init = time.time()
    params = lm_off.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    t_init = time.time() - t_init
    wbytes = sum(t.numel() * t.element_size() for t in tensor_leaves(params))

    def image(dtype):
        return {"patch_embeds": torch.randn(
            (B, prefix, 1024), device=dev, generator=torch.Generator(
                device=dev).manual_seed(4)).to(dtype)} if prefix else None

    extra, cap = image(lm_on.compute_dtype), CAP + prefix
    prefill_decode(torch, lm_on, params, toks, extra=extra,
                   cap=cap)                                    # warm-up
    off, seq, t_off = prefill_decode(torch, lm_off, params, toks,
                                     extra=extra, cap=cap)
    n0 = ops.launch_counts()
    on, seq_on, t_on = prefill_decode(torch, lm_on, params, toks, feed=seq,
                                      extra=extra, cap=cap)
    n1 = ops.launch_counts()
    got = {k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]}
    if got != {"flash_prefill": L, "flash_decode": 8 * L}:
        raise AssertionError(f"{arch}: launches over one prefill and 8 "
                             f"decode steps {got}, want {L} and {8 * L}")
    rel = rel_err(on, off, cfg.vocab_size)
    first = [int((torch.argmax(a, -1) == torch.argmax(b, -1)).sum())
             for a, b in zip(on, off)]
    tol, noise = BF16_LOGIT_TOL, None
    if sensitivity:
        table = params["embed"]["table"]
        grain = torch.randn(table.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(3))
        nudged = {**params, "embed": {**params["embed"], "table": (
            table.float() * (1 + EMBED_NOISE * grain)).to(table.dtype)}}
        del grain
        noisy, _, _ = prefill_decode(torch, lm_off, nudged, toks, feed=seq,
                                     extra=extra, cap=cap)
        noise = rel_err(noisy, off, cfg.vocab_size)
        tol = max(BF16_LOGIT_TOL, 2 * noise)
        del nudged, noisy
        log(f"  {arch} L{L} bf16, kernels off, embedding perturbed by "
            f"{EMBED_NOISE:g}: logits rel err {noise:.3e}; tolerance on vs "
            f"off {tol:.3e}")
    out = {"weight_bytes": wbytes, "init_s": t_init, "prefix": prefix,
           "logits_tol": tol,
           "perturbed_rel_err": noise, "prefill_ms_on": t_on[0],
           "prefill_ms_off": t_off[0], "decode_step_ms_on": t_on[1],
           "decode_step_ms_off": t_off[1], "logits_rel_err": rel,
           "launches_per_prefill": got["flash_prefill"],
           "launches_per_decode_step": got["flash_decode"] / 8,
           "greedy_agree_per_step": first}
    cache_tok = seq[0]
    batch = {"tokens": toks, **(extra or {})}
    for path, lm in (("on", lm_on), ("off", lm_off)):
        logits, cache = lm.prefill(params, batch, max_len=cap)
        out[f"prefill_device_ms_{path}"], _ = profiled(torch, lambda: (
            lm.prefill(params, batch, max_len=cap)))
        out[f"decode_device_ms_{path}"], _ = profiled(torch, lambda: (
            lm.decode_step(params, cache, cache_tok)))
        del logits, cache
    log(f"  {arch} L{L} bf16 ({wbytes / 1e9:.3f} GB of weights, drawn in "
        f"{t_init:.2f}s{f'; an image prefix of {prefix} tokens' if prefix else ''}): logits rel "
        f"err on vs off {rel:.3e} (tol {tol:.3e}); greedy tokens "
        f"on = off per step (of {B}) {first}; launches per prefill "
        f"{got['flash_prefill']} flash_prefill, per decode step "
        f"{got['flash_decode'] / 8:g} flash_decode")
    log(f"  {arch} L{L} B={B} S={PROMPT}: prefill wall ms on {t_on[0]:.2f} "
        f"off {t_off[0]:.2f}, device {out['prefill_device_ms_on']:.3f} / "
        f"{out['prefill_device_ms_off']:.3f}; decode step wall ms on "
        f"{t_on[1]:.2f} off {t_off[1]:.2f}, device "
        f"{out['decode_device_ms_on']:.3f} / "
        f"{out['decode_device_ms_off']:.3f}")
    bad = not all(bool(torch.isfinite(a).all()) for a in on)
    if paged:
        txt, txt_seq = on, seq
        if prefix:               # the engine serves the family text-only
            _, txt_seq, _ = prefill_decode(torch, lm_off, params, toks)
            txt, _, _ = prefill_decode(torch, lm_on, params, toks,
                                       feed=txt_seq)
        pg, _, t_pg = paged_prefill_decode(torch, lm_on, params, toks,
                                           feed=txt_seq)
        out.update(paged_logits_rel_err=rel_err(pg, txt, cfg.vocab_size),
                   decode_step_ms_paged=t_pg[1],
                   paged_launches_per_step=t_pg[2])
        log(f"  {arch} L{L} paged: logits rel err (paged vs dense, kernels "
            f"on) {out['paged_logits_rel_err']:.3e}; step ms {t_pg[1]:.2f}; "
            f"paged_decode launches per step {t_pg[2]:g}")
        bad |= not all(bool(torch.isfinite(a).all()) for a in pg)
        if t_pg[2] != L or out["paged_logits_rel_err"] > tol:
            raise AssertionError(f"{arch} paged: {t_pg[2]} launches a step "
                                 f"(want {L}), rel err "
                                 f"{out['paged_logits_rel_err']}")
    if bad or rel > tol:
        raise AssertionError(f"{arch} bf16 logits: rel err {rel}, finite "
                             f"{not bad}")
    if fused:
        out["fused"] = fused_tick_check(torch, arch, lm_on, lm_off, params,
                                        toks, tol)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  {arch} L{L}: peak memory_allocated {out['peak_gb']:.3f} GB")
    del params, on, off
    torch.cuda.empty_cache()
    cfg32 = cfg.replace(num_layers=2, dtype="float32", name=f"{arch}-L2-f32")
    lm_off, lm_on = LM(cfg32), LM(cfg32.replace(use_kernels=True))
    params = lm_off.init(torch.Generator(device=dev).manual_seed(0))
    extra = image(torch.float32)
    _, s_off, _ = prefill_decode(torch, lm_off, params, toks, extra=extra,
                                 cap=cap)
    _, s_on, _ = prefill_decode(torch, lm_on, params, toks, extra=extra,
                                cap=cap)
    same = all(bool((a == b).all()) for a, b in zip(s_on, s_off))
    same_pg = True
    if paged:
        _, s_pg, _ = paged_prefill_decode(torch, lm_on, params, toks)
        s_txt = prefill_decode(torch, lm_on, params, toks)[1] if prefix \
            else s_on
        same_pg = all(bool((a == b).all()) for a, b in zip(s_pg, s_txt))
    log(f"  {arch} L2 fp32{' after the image prefix' if prefix else ''}: "
        f"greedy 8 tokens x {B} rows identical on vs off: {same}; paged vs "
        f"dense (text-only): {same_pg}")
    if not (same and same_pg):
        raise AssertionError(f"{arch} fp32 greedy tokens differ: kernels "
                             f"on/off {same}, paged/dense {same_pg}")
    del params
    torch.cuda.empty_cache()
    return out


def step_launch_checks(torch, arch, max_new=MAX_NEW, depth=None):
    """``graph_arch`` for ``arch`` at full width (at ``depth`` layers where
    given) on the dense, paged + sharing and dense chunked engines (replay
    = eager bitwise; requests of ``max_new`` tokens), then one launch of
    the path's kernel per layer asserted for every replayed step: prefill,
    decode step, and both fused ticks. Returns the graph summary."""
    from repro_torch.configs import get_config
    graphs = graph_arch(torch, arch, max_new,
                        ("dense", "paged", "dense-chunked"), depth)
    L = depth or get_config(arch).num_layers
    want = {"dense": {"prefill": {"flash_prefill": L},
                      "decode": {"flash_decode": L}},
            "paged": {"prefill": {"flash_prefill": L},
                      "fused": {"paged_decode": L},
                      "decode": {"paged_decode": L}},
            "dense-chunked": {"fused": {"flash_decode_chunk": L}}}
    for engine, kinds in want.items():
        steps = graphs[f"{arch} L{L} {engine}"]["replay"]
        for kind, launches in kinds.items():
            if steps[kind]["launches"] != launches:
                raise AssertionError(
                    f"{arch} {engine} {kind}: launches per step "
                    f"{steps[kind]['launches']}, want {launches}")
    log(f"  {arch} L{L} launches per step as asserted: {want}")
    return graphs


def dense_config_phase(torch):
    """The other dense configs on the card (gemma-2b, yi-6b): the attention
    kernels at hd 256, the chunk forms at yi-6b's hd 128; gemma-2b L18 at
    full width kernels on vs off, dense and paged; its steps replayed vs
    eager on its L6 rung with launches per step asserted; its 6/12/18
    ladder through the
    serve loop on the dense, paged + sharing and chunked engines; yi-6b
    L32 at model level; and the ``llm_autoscale`` launcher at its default
    (yi-6b), run alongside.
    ``memory_allocated`` is printed (after a collection) at the phase's
    start and after each of its model stages, beside each serve loop's
    after its close. Returns (kernel rows' gemma keys, the serve loops'
    launch counts)."""
    import gc
    from collections import Counter
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import paged_decode as pd
    t_phase = time.time()
    cfg = get_config(GEMMA)
    if (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim) != (
            GEMMA_H, GEMMA_KV, GEMMA_HD):
        raise AssertionError(f"{GEMMA}'s heads are not the phase's shapes")
    log("[14] dense configs: gemma-2b (MQA, hd 256, GeGLU, tied 256000 x "
        "2048 embedding) and yi-6b at full width")
    autoscale = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.llm_autoscale"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def memory(label):
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  memory_allocated {label}: "
            f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")

    try:
        memory("at the phase's start")
        gen = torch.Generator(device=DEVICE).manual_seed(25)
        rows = head_kernel_rows(torch, fd, fp, pd, gen,
                                (GEMMA_H, GEMMA_KV, GEMMA_HD), "gemma",
                                hd32=True)
        wide_edge_checks(torch, fd, fp, gen)
        # the bf16 decode step at hd 256 has a kernel of its own
        rows["flash_decode"]["gemma_source"] = (
            "src/repro_torch/kernels/csrc/flash_decode_step.cu")
        rows["paged_decode"]["gemma_source"] = (
            "src/repro_torch/kernels/csrc/paged_decode_step.cu")
        yi_cfg = get_config(YI)
        if (yi_cfg.num_heads, yi_cfg.num_kv_heads,
                yi_cfg.resolved_head_dim) != (YI_H, YI_KV, YI_HD):
            raise AssertionError(f"{YI}'s heads are not the phase's shapes")
        for name, row in head_kernel_rows(
                torch, fd, fp, pd, gen, (YI_H, YI_KV, YI_HD), "yi",
                kinds=("chunk", "paged_chunk")).items():
            rows[name].update(row)
        t_k = time.time()
        memory("after the kernels")
        model = dense_model_check(torch, GEMMA)
        t_m = time.time()
        memory(f"after {GEMMA}'s model check")
        graphs = step_launch_checks(torch, GEMMA, depth=GEMMA_GRAPH_DEPTH)
        memory(f"after {GEMMA}'s graphs")
        t_g = time.time()
        launches = Counter()
        dense, profiles = serve_phase(torch, arch=GEMMA, close=True,
                                      seconds=GEMMA_SIDE_SECONDS)
        launches.update(dense)
        paged, _ = serve_phase(torch, paged=True, profiles=profiles,
                               arch=GEMMA, seconds=GEMMA_SIDE_SECONDS,
                               close=True)
        launches.update(paged)
        chunked, _ = serve_phase(torch, profiles=profiles, arch=GEMMA,
                                 engine_kw=dict(scheduler="chunked"),
                                 seconds=GEMMA_SIDE_SECONDS, close=True)
        launches.update(chunked)
        t_s = time.time()
        yi = dense_model_check(torch, "yi-6b", paged=False)
        t_y = time.time()
        text, err = autoscale.communicate(timeout=600)
    finally:
        if autoscale.poll() is None:
            autoscale.kill()
            autoscale.wait()
    if autoscale.returncode != 0:
        raise AssertionError(f"llm_autoscale exited {autoscale.returncode}:"
                             f" {err[-2000:]}")
    if not text.startswith("variant ladder for yi-6b (H100 cards as units)"):
        raise AssertionError(f"llm_autoscale's default: {text[:200]!r}")
    for line in text.splitlines():
        log(f"  llm_autoscale | {line}")
    summary = {"model": model, "yi": yi, "launches": dict(launches),
               "wall_s": {"kernels": t_k - t_phase, "model": t_m - t_k,
                          "graphs": t_g - t_m, "serve": t_s - t_g,
                          "yi": t_y - t_s,
                          "phase": time.time() - t_phase}}
    log("  dense-config summary " + json.dumps(summary, default=str))
    return rows, dict(launches)


def moe_layer_checks(torch):
    """``apply_moe`` at granite-moe-3b-a800m's widths (D 1536, 40 experts
    of F 512, top 8) in fp32 on the card against the same call on the CPU
    (MOE_REL_TOL): a decode step's B tokens, dropless (C 8, and a token
    picks an expert once), also against ``apply_moe_dense_oracle`` on the
    card; and a prefill's B x PROMPT tokens at capacity factor 1.0, where
    experts overflow: the three metrics equal the CPU's, and slot 0 of
    every overflowing expert reads zero in the card's buffer (the
    reference's overflow write). Returns {case: numbers}."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(GRANITE).replace(dtype="float32")
    E, k = cfg.num_experts, cfg.experts_per_token
    gen = torch.Generator().manual_seed(26)
    cpu = moe.init_moe(gen, cfg, torch.float32, torch.float32,
                       torch.device("cpu"))
    card = {n: t.to(DEVICE) for n, t in cpu.items()}
    out = {}
    for label, S, cf in (("decode", 1, None), ("prefill", PROMPT, 1.0)):
        x = torch.randn((B, S, cfg.d_model), generator=gen)
        want, m_cpu = moe.apply_moe(cfg, cpu, x, capacity_factor=cf)
        got, m_card = moe.apply_moe(cfg, card, x.to(DEVICE),
                                    capacity_factor=cf)
        scale = float(want.abs().max())
        rel = float((got.cpu() - want).abs().max()) / scale
        metrics = {n: (float(m_card[n]), float(m_cpu[n])) for n in m_cpu}
        row = {"tokens": B * S, "capacity": moe.moe_capacity(
            B * S, cfg, cf or cfg.moe_capacity_factor), "rel_err": rel,
            "metrics_card_cpu": metrics}
        bad = rel > MOE_REL_TOL or any(
            abs(a - b) > 1e-5 * max(1.0, abs(b)) for a, b in metrics.values())
        drop = metrics["drop_fraction"][0]
        if label == "decode":
            oracle = moe.apply_moe_dense_oracle(cfg, card, x.to(DEVICE))
            row["oracle_rel_err"] = float(
                (got - oracle).abs().max()) / scale
            bad |= drop != 0.0 or row["oracle_rel_err"] > MOE_REL_TOL
        else:
            flat = x.to(DEVICE).reshape(B * S, -1)
            ids = moe.route(cfg, card, flat)[2].reshape(-1)
            buf, *_, counts = moe._dispatch(flat, ids, E, row["capacity"],
                                            k)
            over = counts > row["capacity"]
            row["overflowing_experts"] = int(over.sum())
            row["slot0_max_abs"] = float(buf[over, 0].abs().max()) \
                if bool(over.any()) else None
            bad |= not drop > 0.0 or not bool(over.any()) \
                or row["slot0_max_abs"] != 0.0
        log(f"  apply_moe {label} ({B * S} tokens, C {row['capacity']}, "
            f"fp32): card vs CPU {rel:.2e} of max |y| {scale:.1f} (tol "
            f"{MOE_REL_TOL:.0e}); metrics card / CPU {metrics}"
            + (f"; vs the dense oracle {row['oracle_rel_err']:.2e}"
               if label == "decode" else
               f"; {row['overflowing_experts']} experts overflow, their "
               f"slot 0 max |x| {row['slot0_max_abs']}"))
        if bad:
            raise AssertionError(f"apply_moe {label} on the card: {row}")
        out[label] = row
    return out


def moe_step_split(torch):
    """Device time of an eager granite-moe-3b-a800m L32 decode step (B 8
    at position PROMPT) and prefill (B x PROMPT), kernels on, bf16, split
    by ``launch.profile_step.moe_split`` into the attention kernels, the
    expert products, the dispatch and the rest, beside each step's bound:
    the bytes it must move (every weight once, the K/V it reads or writes,
    the logits) and the operations its tokens need (every layer's products
    over T tokens with each token's k experts, the attention scores), over
    the card's rates. Returns {step: numbers}."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_step import moe_split
    from repro_torch.models.model import LM
    from repro_torch.serving.graphs import tensor_leaves
    dev = torch.device(DEVICE)
    cfg = get_config(GRANITE).replace(use_kernels=True)
    L, D, F_, E, k = (cfg.num_layers, cfg.d_model, cfg.d_ff,
                      cfg.num_experts, cfg.experts_per_token)
    H_, KV_, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    weights = sum(t.numel() * t.element_size()
                  for t in tensor_leaves(params))
    toks = torch.randint(0, cfg.vocab_size, (B, PROMPT), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    logits, cache = lm.prefill(params, {"tokens": toks}, max_len=CAP)
    tok = torch.argmax(logits, -1)
    kv_bytes = 2 * L * B * KV_ * PROMPT * hd * 2
    attn_params = D * (H_ + 2 * KV_) * hd + H_ * hd * D
    logit_bytes = B * cfg.padded_vocab * 2

    def flops(T, pairs):
        per_token = 2 * (attn_params + D * E + k * 3 * D * F_)
        return L * (T * per_token + 4 * B * H_ * pairs * hd) \
            + 2 * B * D * cfg.padded_vocab

    steps = {"decode": (lambda: lm.decode_step(params, cache, tok),
                        weights + kv_bytes + logit_bytes,
                        flops(B, B * (PROMPT + 1))),
             "prefill": (lambda: lm.prefill(params, {"tokens": toks},
                                             max_len=CAP),
                         weights + kv_bytes + logit_bytes,
                         flops(B * PROMPT, B * PROMPT * (PROMPT + 1) // 2))}
    out = {}
    cuda = torch.autograd.DeviceType.CUDA
    for name, (fn, nbytes, nflops) in steps.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            fn()
            torch.cuda.synchronize()
        ev = prof.key_averages()
        device = sum(e.self_device_time_total for e in ev
                     if e.device_type == cuda
                     and not e.key.startswith("moe.")) / 1e3
        split = moe_split(ev, device)
        b_ms, b_by = bound(nbytes, nflops, torch.bfloat16)
        out[name] = {"device_ms": device, **split, "bound_ms": b_ms,
                     "bound_by": b_by, "bytes": nbytes, "flops": nflops}
        log(f"  {GRANITE} L{L} {name} (eager, B {B}): device {device:.3f} "
            f"ms = attention kernels {split['attention_ms']:.3f} + expert "
            f"products {split['experts_ms']:.3f} + dispatch "
            f"{split['dispatch_ms']:.3f} + rest {split['rest_ms']:.3f}; "
            f"bound {b_ms:.3f} ms ({b_by}: {nbytes / 1e9:.2f} GB, "
            f"{nflops / 1e12:.2f} TFLOP)")
        if not split or min(split.values()) < 0.0:
            raise AssertionError(f"{name}: no MoE split {split}")
    del params, cache
    torch.cuda.empty_cache()
    return out


def moe_phase(torch):
    """The MoE family on the card: granite-moe-3b-a800m (40 experts, top 8;
    24 query heads on 8 KV heads of hd 64) at full width. ``apply_moe``
    card vs CPU (``moe_layer_checks``); every attention kernel at its GQA
    group of 3 against its plain version, timed beside SDPA and the bound
    (``head_kernel_rows``); L32 kernels on vs off, dense and paged, both
    fused ticks, launches per prefill and per step asserted
    (``dense_model_check``); the device split of a decode step and a
    prefill (``moe_step_split``); its steps replayed vs eager at
    GRAPH_DEPTH layers (``step_launch_checks``); its 8/16/32 ladder
    through the InfAdapter
    loop on the dense FIFO, paged + sharing and chunked engines, none
    rejected, ``memory_allocated`` printed per load and held after each
    close to the loop's start within CLOSE_MARGIN. Returns (kernel rows'
    granite keys, the serve loops' launch counts)."""
    import gc
    from collections import Counter
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import paged_decode as pd
    t_phase = time.time()
    cfg = get_config(GRANITE)
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim)
    if heads != (GRANITE_H, GRANITE_KV, GRANITE_HD):
        raise AssertionError(f"{GRANITE}'s heads {heads} are not the "
                             f"phase's shapes")
    log(f"[15] MoE: {GRANITE} ({cfg.num_experts} experts, top "
        f"{cfg.experts_per_token}; {GRANITE_H} query heads on {GRANITE_KV} "
        f"KV heads of hd {GRANITE_HD}) at full width")

    def memory(label):
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  memory_allocated {label}: "
            f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")

    memory("at the phase's start")
    layer = moe_layer_checks(torch)
    gen = torch.Generator(device=DEVICE).manual_seed(26)
    rows = head_kernel_rows(torch, fd, fp, pd, gen, heads, "granite")
    t_k = time.time()
    model = dense_model_check(torch, GRANITE, fused=True, sensitivity=True)
    split = moe_step_split(torch)
    t_m = time.time()
    memory(f"after {GRANITE}'s model checks")
    # two decode chunks a request: an eager MoE step takes ~0.1 s at L32;
    # replay vs eager runs on the ladder's L16 rung (the L32 model checks
    # above assert its launches) to keep the script within its time limit
    step_launch_checks(torch, GRANITE, max_new=2 * CHUNK, depth=GRAPH_DEPTH)
    memory(f"after {GRANITE}'s graphs")
    t_g = time.time()
    launches = Counter()
    dense, profiles = serve_phase(torch, arch=GRANITE, close=True,
                                  seconds=MOE_SERVE_SECONDS)
    launches.update(dense)
    paged, _ = serve_phase(torch, paged=True, profiles=profiles,
                           arch=GRANITE, seconds=MOE_SERVE_SECONDS,
                           close=True)
    launches.update(paged)
    chunked, _ = serve_phase(torch, profiles=profiles, arch=GRANITE,
                             engine_kw=dict(scheduler="chunked"),
                             seconds=MOE_SERVE_SECONDS, close=True)
    launches.update(chunked)
    memory("at the phase's end")
    summary = {"layer": layer, "model": model, "split": split,
               "launches": dict(launches),
               "wall_s": {"kernels": t_k - t_phase, "model": t_m - t_k,
                          "graphs": t_g - t_m, "serve": time.time() - t_g,
                          "phase": time.time() - t_phase}}
    log("  moe summary " + json.dumps(summary, default=str))
    return rows, dict(launches)


def whisper_phase(torch):
    """The encoder-decoder family on the card: whisper-tiny at its
    published size. Every attention kernel at its heads (G 1, hd 64)
    against its plain version in bf16 and fp32, timed beside SDPA and the
    bound (``head_kernel_rows``); B x WHISPER_PROMPT decoder tokens after
    B x 1500 seeded frames and WHISPER_STEPS greedy decode steps in bf16,
    kernels on vs off (logits held to BF16_LOGIT_TOL), 4 flash_prefill
    launches a prefill, 4 flash_decode launches a step and none in the
    encoder asserted; ms of encode, prefill and a decode step, and the
    share of a step spent projecting the cached encoder output to K and V
    again (the reference's cross-attention arithmetic: ROADMAP B); then
    the fp32 model with the kernels on, card against the CPU. Returns
    (kernel rows' whisper keys, the numbers)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.models import attention as attn
    from repro_torch.models.model import AUDIO_FRAME_DIM, LM
    t_phase = time.time()
    dev = torch.device(DEVICE)
    cfg = get_config(WHISPER)
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim)
    L, T = cfg.num_layers, cfg.enc_seq
    log(f"[18] encoder-decoder: {WHISPER} ({cfg.enc_layers} + {L} layers, "
        f"d_model {cfg.d_model}, {heads[0]} heads on {heads[1]} KV heads of "
        f"hd {heads[2]}, {T} frames) at its published size")
    gen = torch.Generator(device=dev).manual_seed(27)
    rows = head_kernel_rows(torch, fd, fp, pd, gen, heads, "whisper")
    t_k = time.time()
    lm_off, lm_on = LM(cfg), LM(cfg.replace(use_kernels=True))
    params = lm_off.init(torch.Generator(device=dev).manual_seed(0))
    frames = torch.randn((B, T, AUDIO_FRAME_DIM), device=dev, generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (B, WHISPER_PROMPT), device=dev,
                         generator=gen)
    batch = {"tokens": toks, "frames": frames}
    cap = WHISPER_PROMPT + WHISPER_STEPS

    def run(lm, feed=None):
        return prefill_decode(torch, lm, params, toks, feed=feed,
                              extra={"frames": frames}, cap=cap,
                              steps=WHISPER_STEPS)

    def launched(fn):
        n0 = ops.launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: c - n0[k] for k, c in ops.launch_counts().items()
                     if c != n0[k]}

    run(lm_on)                                                  # warm-up
    off, seq, t_off = run(lm_off)
    (on, _, t_on), run_n = launched(lambda: run(lm_on, feed=seq))
    (_, cache), pre_n = launched(lambda: lm_on.prefill(params, batch,
                                                       max_len=cap))
    _, enc_n = launched(lambda: lm_on.encode(params, frames))
    for i in range(WHISPER_STEPS):          # the cache at the run's end
        lm_on.decode_step(params, cache, seq[i])
    step_n = {k: v - pre_n.get(k, 0) for k, v in run_n.items()
              if v != pre_n.get(k, 0)}
    rel = rel_err(on, off, cfg.vocab_size)
    agree = float(np.mean([float((torch.argmax(a, -1) == torch.argmax(
        b, -1)).float().mean()) for a, b in zip(on, off)]))
    enc_ms = time_ms(torch, lambda f: lm_on.encode(params, f), [(frames,)],
                     iters=10)
    tok = seq[-1]
    step_ms = time_ms(torch, lambda: lm_on.decode_step(
        params, {**cache, "pos": cache["pos"].clone()}, tok), [()],
        iters=20)
    enc = cache["enc"]
    layers = lm_on._layers(params)
    kv_ms = time_ms(torch, lambda: [enc @ lp["xattn"][w] for lp in layers
                                    for w in ("wk", "wv")], [()], iters=20)
    # the encoder's unmasked attention (plain fp32 scores and softmax, as
    # the reference's): its 4 layers' calls alone, beside one SDPA call a
    # layer computing the same function (a yardstick the port never calls)
    h = torch.randn((B, T, cfg.d_model), device=dev,
                    generator=gen).to(lm_on.compute_dtype)
    enc_layers = lm_on._layers(params, "enc_layers")
    enc_attn_ms = time_ms(torch, lambda: [attn.bidirectional_attention(
        cfg, lp["attn"], h) for lp in enc_layers], [()], iters=10)

    def sdpa_layers():
        for lp in enc_layers:
            q, k, v = (torch.nn.functional.linear(
                h, lp["attn"][w].t()).reshape(B, T, -1, heads[2])
                .transpose(1, 2) for w in ("wq", "wk", "wv"))
            o = torch.nn.functional.scaled_dot_product_attention(q, k, v)
            o.transpose(1, 2).reshape(B, T, -1) @ lp["attn"]["wo"]

    enc_sdpa_ms = time_ms(torch, sdpa_layers, [()], iters=10)
    dec_dev, _ = profiled(torch, lambda: lm_on.decode_step(
        params, {**cache, "pos": cache["pos"].clone()}, tok))
    kv_dev, _ = profiled(torch, lambda: [enc @ lp["xattn"][w]
                                         for lp in layers
                                         for w in ("wk", "wv")])
    # a trace that kept no kernel (PERF.md §7) measures nothing
    kv_share = kv_dev / dec_dev if kv_dev > 0 and dec_dev > 0 else None
    out = {"logits_rel_err": rel, "greedy_agree": agree,
           "launches_prefill": pre_n, "launches_per_step": {
               k: v / WHISPER_STEPS for k, v in step_n.items()},
           "launches_encode": enc_n, "encode_ms": enc_ms,
           "prefill_ms_on": t_on[0], "prefill_ms_off": t_off[0],
           "decode_step_ms_on": t_on[1], "decode_step_ms_off": t_off[1],
           "decode_step_ms": step_ms, "cross_kv_ms": kv_ms,
           "cross_kv_share": kv_ms / step_ms, "decode_device_ms": dec_dev,
           "cross_kv_device_ms": kv_dev,
           "cross_kv_device_share": kv_share,
           "encoder_attention_ms": enc_attn_ms,
           "encoder_attention_sdpa_ms": enc_sdpa_ms}
    log(f"  {WHISPER} bf16, B {B}, {T} frames, {WHISPER_PROMPT}-token prompt,"
        f" {WHISPER_STEPS} steps: logits rel err on vs off {rel:.3e} (tol "
        f"{BF16_LOGIT_TOL:.0e}), greedy agreement {agree:.3f}; launches: "
        f"prefill {pre_n}, per step {out['launches_per_step']}, encoder "
        f"{enc_n or 'none'}")
    log(f"  {WHISPER}: encode {enc_ms:.3f} ms; prefill (encoder included) "
        f"on {t_on[0]:.2f} off {t_off[0]:.2f} ms; decode step on "
        f"{t_on[1]:.3f} off {t_off[1]:.3f} ms (timed alone {step_ms:.3f}, "
        f"device {dec_dev:.3f}); the cross K/V projections of the cached "
        f"encoder output {kv_ms:.3f} ms (device {kv_dev:.3f}): "
        f"{100 * kv_ms / step_ms:.1f}% of a step's wall time, "
        + (f"{100 * kv_share:.1f}%" if kv_share else "not measured (a "
           "profiler trace without kernels)")
        + f" of its device time; the encoder's "
        f"{cfg.enc_layers} unmasked attentions (projections included) "
        f"{enc_attn_ms:.3f} ms of the encode, {enc_sdpa_ms:.3f} ms through "
        f"SDPA")
    if pre_n != {"flash_prefill": L} or step_n != {
            "flash_decode": L * WHISPER_STEPS} or enc_n:
        raise AssertionError(f"{WHISPER}: launches prefill {pre_n}, steps "
                             f"{step_n}, encoder {enc_n}")
    if rel > BF16_LOGIT_TOL or not all(bool(torch.isfinite(a).all())
                                       for a in on):
        raise AssertionError(f"{WHISPER} bf16 logits: rel err {rel}")
    del params, cache, enc, layers, enc_layers, h
    # fp32, kernels on: the card against the CPU on the same weights
    cfg32 = cfg.replace(dtype="float32", use_kernels=True)
    card = LM(cfg32).init(torch.Generator(device=dev).manual_seed(0))
    cpu = _tree_to(card, "cpu")
    b32 = {"tokens": toks[:WHISPER_TWIN_B],
           "frames": frames[:WHISPER_TWIN_B]}
    res = {}
    for where, p in (("cuda", card), ("cpu", cpu)):
        outs, seq32, _ = prefill_decode(
            torch, LM(cfg32), p, b32["tokens"].to(where),
            extra={"frames": b32["frames"].to(where)},
            cap=WHISPER_PROMPT + 8)
        res[where] = ([x.cpu() for x in outs], [t.cpu() for t in seq32])
    rel32 = rel_err(res["cuda"][0], res["cpu"][0], cfg.vocab_size)
    same = all(bool((a == b).all()) for a, b in zip(res["cuda"][1],
                                                     res["cpu"][1]))
    out.update(fp32_card_cpu_rel_err=rel32, fp32_card_cpu_tokens_equal=same)
    log(f"  {WHISPER} fp32, kernels on, B {WHISPER_TWIN_B}: card vs CPU "
        f"logits rel err {rel32:.3e} (tol {FP32_CPU_REL_TOL:.0e}), greedy "
        f"8 tokens equal {same}")
    if rel32 > FP32_CPU_REL_TOL or not same:
        raise AssertionError(f"{WHISPER} fp32 card vs CPU: rel err "
                             f"{rel32}, tokens equal {same}")
    del card, cpu
    torch.cuda.empty_cache()
    out["wall_s"] = {"kernels": t_k - t_phase,
                     "phase": time.time() - t_phase}
    log("  whisper summary " + json.dumps(out, default=str))
    return rows, out


def _tree_to(tree, device):
    """A params tree with every leaf moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def vlm_phase(torch):
    """The VLM family on the card: internvl2-26b (48 query heads on 8 KV
    heads of hd 128: G 6) at full width. Every attention kernel at its
    heads against its plain version in bf16 and fp32, timed beside SDPA
    and the bound (``head_kernel_rows``), flash_prefill and the decode
    step on the edges of their bf16 routes (``wide_edge_checks``); L48
    (~40 GB of bf16 weights,
    drawn on the card from a seed, the time printed) kernels on vs off
    with a 256-token image prefix before the 512-token prompt (S 768),
    the logits held as the MoE phase holds them, 48 launches a prefill, a
    step and a fused tick asserted, paged steps and fused ticks text-only,
    peak memory printed (``dense_model_check``); its steps replayed vs
    eager at GRAPH_DEPTH layers (``step_launch_checks``); its 8/16/48
    ladder served text-only
    (as the reference's engine serves it) through the InfAdapter loop on
    the dense FIFO, paged + sharing and chunked engines, VLM_SERVE_SECONDS
    each, every closing loop back at its start memory within CLOSE_MARGIN.
    Returns (kernel rows' internvl keys, the serve loops' launch
    counts)."""
    import gc
    from collections import Counter
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import paged_decode as pd
    t_phase = time.time()
    cfg = get_config(INTERNVL)
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim)
    log(f"[19] VLM: {INTERNVL} ({heads[0]} query heads on {heads[1]} KV "
        f"heads of hd {heads[2]}, d_model {cfg.d_model}, "
        f"{cfg.num_layers} layers) at full width")

    def memory(label):
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  memory_allocated {label}: "
            f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")

    memory("at the phase's start")
    gen = torch.Generator(device=DEVICE).manual_seed(28)
    if heads != (INTERNVL_H, INTERNVL_KV, INTERNVL_HD):
        raise AssertionError(f"{INTERNVL}'s heads are not the phase's shapes")
    rows = head_kernel_rows(torch, fd, fp, pd, gen, heads, "internvl")
    wide_edge_checks(torch, fd, fp, gen, hd=INTERNVL_HD)
    # the bf16 decode step at hd 128 has a kernel of its own
    rows["flash_decode"]["internvl_source"] = (
        "src/repro_torch/kernels/csrc/flash_decode_step.cu")
    rows["paged_decode"]["internvl_source"] = (
        "src/repro_torch/kernels/csrc/paged_decode_step.cu")
    t_k = time.time()
    model = dense_model_check(torch, INTERNVL, fused=True, sensitivity=True,
                              prefix=INTERNVL_PREFIX)
    t_m = time.time()
    memory(f"after {INTERNVL}'s model check")
    step_launch_checks(torch, INTERNVL, max_new=2 * CHUNK,
                       depth=GRAPH_DEPTH)
    memory(f"after {INTERNVL}'s graphs")
    t_g = time.time()
    launches = Counter()
    dense, profiles = serve_phase(torch, arch=INTERNVL, close=True,
                                  seconds=VLM_SERVE_SECONDS)
    launches.update(dense)
    paged, _ = serve_phase(torch, paged=True, profiles=profiles,
                           arch=INTERNVL, seconds=VLM_SERVE_SECONDS,
                           close=True)
    launches.update(paged)
    chunked, _ = serve_phase(torch, profiles=profiles, arch=INTERNVL,
                             engine_kw=dict(scheduler="chunked"),
                             seconds=VLM_SERVE_SECONDS, close=True)
    launches.update(chunked)
    memory("at the phase's end")
    summary = {"model": model, "launches": dict(launches),
               "wall_s": {"kernels": t_k - t_phase, "model": t_m - t_k,
                          "graphs": t_g - t_m, "serve": time.time() - t_g,
                          "phase": time.time() - t_phase}}
    log("  vlm summary " + json.dumps(summary, default=str))
    return rows, dict(launches)


def resnet_phase(torch):
    """The paper's ResNet family (``repro_torch.models.resnet``: cuDNN
    convolutions, no kernel of the port) at 224 x 224 in fp32 with TF32
    off: each variant's logits on the card against the CPU at
    RESNET_TWIN_B images (RESNET_REL_TOL of their largest magnitude), then
    ms a batch (CUDA events, inputs made on the card), images/s and the
    share of the card's fp32 peak (67 TFLOP/s) that ``resnet_flops``'
    count reaches, at each of RESNET_BATCHES. Returns the numbers."""
    from repro_torch.kernels import ops
    from repro_torch.models import resnet
    t_phase = time.time()
    dev = torch.device(DEVICE)
    log(f"[20] ResNet: {', '.join(resnet.RESNET_SPECS)} at 224 x 224, fp32 "
        f"(TF32 off)")
    out = {}
    n0 = ops.launch_counts()
    for name in resnet.RESNET_SPECS:
        cpu = resnet.init_resnet(torch.Generator().manual_seed(0), name)
        card = _tree_to(cpu, dev)
        x = torch.randn((RESNET_TWIN_B, 224, 224, 3),
                        generator=torch.Generator().manual_seed(1))
        want = resnet.apply_resnet(cpu, name, x)
        got = resnet.apply_resnet(card, name, x.to(dev)).cpu()
        rel = float((got - want).abs().max()) / float(want.abs().max())
        row = {"card_cpu_rel_err": rel}
        if rel > RESNET_REL_TOL or got.shape != (RESNET_TWIN_B, 1000):
            raise AssertionError(f"{name}: card vs CPU {rel}, shape "
                                 f"{tuple(got.shape)}")
        for b in RESNET_BATCHES:
            xs = [(torch.randn((b, 224, 224, 3), device=dev),)
                  for _ in range(2)]
            ms = time_ms(torch, lambda v: resnet.apply_resnet(card, name, v),
                         xs, iters=10)
            flops = resnet.resnet_flops(name) * b
            row[f"b{b}"] = {"ms": ms, "images_per_s": b / ms * 1e3,
                            "fp32_peak_share": flops / (ms / 1e3)
                            / PEAK_FLOPS["torch.float32"]}
        out[name] = row
        log(f"  {name}: card vs CPU {rel:.2e} of max |logit|; " + "; ".join(
            f"B {b} {row[f'b{b}']['ms']:.3f} ms, "
            f"{row[f'b{b}']['images_per_s']:.0f} images/s, "
            f"{100 * row[f'b{b}']['fp32_peak_share']:.1f}% of fp32 peak"
            for b in RESNET_BATCHES))
        del cpu, card
    if ops.launch_counts() != n0:
        raise AssertionError("a port kernel launched in the ResNet phase")
    torch.cuda.empty_cache()
    out["wall_s"] = time.time() - t_phase
    log("  resnet summary " + json.dumps(out))
    return out


def _finite(pairs, label):
    """Raise unless every (loss, grad_norm) tensor pair is finite."""
    bad = [i for i, (l, g) in enumerate(pairs)
           if not (bool(l.isfinite()) and bool(g.isfinite()))]
    if bad:
        raise AssertionError(f"{label}: non-finite loss or grad_norm at "
                             f"steps {bad[:10]}")


def train_flops(cfg, batch, seq):
    """(model FLOPs, hardware FLOPs) of one train step at (batch, seq):
    6·N·T over the N matrix-product params (every layer's projections and
    the unembedding; the embedding is a gather) plus the attention's
    score and value products over the full S x S the plain path computes,
    3x (forward, two in the backward pass); the hardware count adds the
    remat's second forward pass of the layers, less each layer's last
    product (the MLP's down projection): ``checkpoint`` stops its replay
    once the last tensor the backward needs is recomputed, and that
    product's output is not one (the dry run's count, ``FlopCounterMode``
    on meta, agrees to the FLOP; tests/test_torch_dryrun.py holds it to a
    hand count)."""
    D, F_, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    H_, KV_, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    per_layer = D * (H_ + 2 * KV_) * hd + H_ * hd * D + 3 * D * F_
    n_mm = L * per_layer + D * cfg.padded_vocab
    T = batch * seq
    attn_fwd = L * 4 * batch * H_ * seq * seq * hd
    model = 6 * n_mm * T + 3 * attn_fwd
    recompute = (2 * L * (per_layer - F_ * D) * T + attn_fwd if cfg.remat
                 else 0)
    return model, model + recompute, n_mm


def train_split(torch, lm, adam_cfg, params, opt, batch):
    """Device ms of one train step, split: the loss and its gradients
    (one ``torch.profiler`` trace: matrix products, cross-entropy — the
    log-softmax and the label gather, forward and backward — and the
    elementwise rest) and Adam's update (a second trace). Returns
    {part: ms} and the kernels each trace held."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train.optimizer import adam_update, value_and_grad
    cuda = torch.autograd.DeviceType.CUDA

    def trace(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            out = fn()
            torch.cuda.synchronize()
        return out, [e for e in prof.key_averages()
                     if e.device_type == cuda and e.self_device_time_total > 0]

    (_, grads), fb = trace(lambda: value_and_grad(lm.loss, params, batch))
    _, adam = trace(lambda: adam_update(adam_cfg, grads, opt, params))
    del grads
    split = {"matmul_ms": 0.0, "cross_entropy_ms": 0.0,
             "elementwise_ms": 0.0}
    for e in fb:
        n = e.key.lower()
        if any(k in n for k in ("gemm", "gemv", "cutlass", "xmma",
                                "cublas", "nvjet")):
            part = "matmul_ms"
        elif "logsoftmax" in n or "scatter_gather" in n:
            part = "cross_entropy_ms"
        else:
            part = "elementwise_ms"
        split[part] += e.self_device_time_total / 1e3
    split["adam_ms"] = sum(e.self_device_time_total for e in adam) / 1e3
    split["device_ms"] = sum(split.values())
    split["kernels"] = {"loss_and_grads": sum(e.count for e in fb),
                        "adam": sum(e.count for e in adam)}
    split["top"] = [(round(e.self_device_time_total / 1e3, 3), e.count,
                     e.key[:80]) for e in sorted(
        fb, key=lambda e: -e.self_device_time_total)[:8]]
    return split


def dryrun_train_counts(torch, cfg, step_ms, hw_f):
    """Beside ``train_flops``' hand count: the dry run's count of the same
    step (``FlopCounterMode`` over it on meta tensors at TRAIN_B x TRAIN_S,
    remat on; products only) and ``roofline.model_flops`` (6·N·T over
    every param, the embedding's too), each as a share of the bf16 dense
    peak at the measured ms a step, and the hand count's distance from
    the counted one."""
    from repro_torch.analysis.roofline import model_flops
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun, steps as steps_mod
    shape = InputShape("train_chip", TRAIN_S, TRAIN_B, "train")
    fn, args = steps_mod.input_specs(
        cfg.replace(param_dtype="float32"), shape)
    counted = dryrun.count_step(fn, args)
    rl_f = model_flops(cfg, shape)
    peak = PEAK_FLOPS["torch.bfloat16"] * (step_ms / 1e3)
    out = {"counted_flops": counted, "counted_flops_share": counted / peak,
           "roofline_model_flops": rl_f,
           "roofline_model_flops_share": rl_f / peak,
           "hand_vs_counted": hw_f / counted - 1.0}
    log(f"  (a) the dry run's count of this step (FlopCounterMode on meta, "
        f"remat on) {counted / 1e12:.3f} T = "
        f"{100 * out['counted_flops_share']:.2f}% of the bf16 dense peak; "
        f"roofline.model_flops {rl_f / 1e12:.3f} T = "
        f"{100 * out['roofline_model_flops_share']:.2f}%; the hand count "
        f"with recompute is {100 * out['hand_vs_counted']:+.2f}% of the "
        f"counted")
    return out


def train_full(torch, tmp):
    """(a) and (c): tinyllama-1.1b at its published width and depth (22
    layers, bf16 compute, fp32 params and Adam moments, remat on, the
    plain paths: ``use_kernels`` off) on ``SyntheticTokenPipeline`` batches
    of TRAIN_B x TRAIN_S. TRAIN_WARMUP steps at TRAIN_ADAM, then
    TRAIN_TIMED timed with CUDA events (the batches drawn first): ms a
    step, tokens/s, ``max_memory_allocated``; the device split of one step
    (``train_split``) and its FLOPs shares of the bf16 dense peak; one
    step with remat off and both passes' peaks. Then LEARN_STEPS at
    ``launch.train_tiny_lm``'s optimizer (lr 1e-3, warmup 20) from a fresh
    Adam state on batches over its LEARN_VOCAB tokens, held to its
    "learned" criterion (last loss < first - 0.5);
    the state before the last step is checkpointed, restored into a fresh
    tree and stepped again on the same batch: bitwise the run's last
    state. Returns the numbers."""
    import gc
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import SyntheticTokenPipeline
    from repro_torch.launch.steps import TRAIN_ADAM, make_train_step
    from repro_torch.models.model import LM
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import (AdamConfig, adam_init,
                                             adam_update, tree_leaves,
                                             value_and_grad)
    dev = torch.device(DEVICE)
    cfg = get_config(TRAIN_ARCH)
    if not (cfg.remat and not cfg.use_kernels and cfg.dtype == "bfloat16"
            and cfg.param_dtype == "float32"):
        raise AssertionError(f"{TRAIN_ARCH}: not the trainer's config {cfg}")
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(0),
                     dtype=torch.float32)
    n_params = sum(t.numel() for t in tree_leaves(params))
    opt = adam_init(params)
    log(f"  (a) {TRAIN_ARCH} L{cfg.num_layers}: {n_params / 1e9:.3f} B "
        f"params (fp32), bf16 compute, remat, B {TRAIN_B} x S {TRAIN_S}; "
        f"params + Adam moments {torch.cuda.memory_allocated() / 1e9:.2f} "
        f"GB")
    pipe = SyntheticTokenPipeline(vocab=cfg.vocab_size, seq_len=TRAIN_S,
                                  batch=TRAIN_B, seed=0, device=dev)
    step = make_train_step(cfg)
    t0 = time.time()
    for _ in range(TRAIN_WARMUP):
        params, opt, m = step(params, opt, pipe.next_batch())
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    batches = [pipe.next_batch() for _ in range(TRAIN_TIMED)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    pairs = []
    e0.record()
    for b in batches:
        params, opt, m = step(params, opt, b)
        pairs.append((m["loss"], m["grad_norm"]))
    e1.record()
    torch.cuda.synchronize()
    step_ms = e0.elapsed_time(e1) / TRAIN_TIMED
    peak_step = torch.cuda.max_memory_allocated()
    _finite(pairs, "TRAIN_ADAM steps")
    tokens_s = TRAIN_B * TRAIN_S / (step_ms / 1e3)
    model_f, hw_f, n_mm = train_flops(cfg, TRAIN_B, TRAIN_S)
    peak = PEAK_FLOPS["torch.bfloat16"]
    out = {"params": n_params, "matmul_params": n_mm, "step_ms": step_ms,
           "tokens_per_s": tokens_s, "warmup_s": warm_s,
           "peak_step_gb": peak_step / 1e9,
           "model_flops": model_f, "hardware_flops": hw_f,
           "model_flops_share": model_f / (step_ms / 1e3) / peak,
           "hardware_flops_share": hw_f / (step_ms / 1e3) / peak,
           "losses": [float(l) for l, _ in pairs]}
    log(f"  (a) TRAIN_ADAM: {step_ms:.2f} ms a step over {TRAIN_TIMED} "
        f"steps (CUDA events, after {TRAIN_WARMUP} warm-up steps in "
        f"{warm_s:.1f} s), {tokens_s:.0f} tokens/s; max_memory_allocated "
        f"{peak_step / 1e9:.2f} GB; model FLOPs {model_f / 1e12:.2f} T a "
        f"step = {100 * out['model_flops_share']:.1f}% of the bf16 dense "
        f"peak, with the remat's recompute {hw_f / 1e12:.2f} T = "
        f"{100 * out['hardware_flops_share']:.1f}%")
    out.update(dryrun_train_counts(torch, cfg, step_ms, hw_f))
    # the peaks of the loss and its gradients alone, remat on and off, and
    # one remat-off step's time
    for remat in (True, False):
        lm_r = LM(cfg.replace(remat=remat))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        (_, _), g = value_and_grad(lm_r.loss, params, batches[0])
        torch.cuda.synchronize()
        out[f"peak_loss_grads_gb_remat_{'on' if remat else 'off'}"] = (
            torch.cuda.max_memory_allocated() / 1e9)
        del g
    plain = make_train_step(cfg.replace(remat=False))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e0.record()
    p2, o2, m2 = plain(params, opt, batches[0])
    e1.record()
    torch.cuda.synchronize()
    out["step_ms_remat_off"] = e0.elapsed_time(e1)
    out["peak_step_gb_remat_off"] = torch.cuda.max_memory_allocated() / 1e9
    _finite([(m2["loss"], m2["grad_norm"])], "remat-off step")
    del p2, o2, m2
    log(f"  (a) peak of loss + gradients: remat on "
        f"{out['peak_loss_grads_gb_remat_on']:.2f} GB, off "
        f"{out['peak_loss_grads_gb_remat_off']:.2f} GB; of a whole step "
        f"(Adam's new tree beside the old): on {peak_step / 1e9:.2f} GB, "
        f"off {out['peak_step_gb_remat_off']:.2f} GB; one remat-off step "
        f"{out['step_ms_remat_off']:.2f} ms")
    if not (out["peak_loss_grads_gb_remat_on"]
            < out["peak_loss_grads_gb_remat_off"]):
        raise AssertionError("remat does not lower the peak")
    split = train_split(torch, lm, TRAIN_ADAM, params, opt, batches[0])
    out["split"] = split
    log(f"  (a) device split of one step: {split['device_ms']:.2f} ms = "
        f"matrix products {split['matmul_ms']:.2f} + elementwise "
        f"{split['elementwise_ms']:.2f} + cross-entropy "
        f"{split['cross_entropy_ms']:.2f} + Adam {split['adam_ms']:.2f} "
        f"({split['kernels']['loss_and_grads']} + "
        f"{split['kernels']['adam']} kernels)")
    for ms_, n, name in split["top"]:
        log(f"      {ms_:8.3f} ms  {n:5d}x  {name}")
    del batches
    # the example's optimizer from a fresh state; (c) at its last step
    learn = AdamConfig(lr=1e-3, warmup_steps=20, total_steps=LEARN_STEPS)

    def learn_step(p, o, b):
        (loss, _), g = value_and_grad(lm.loss, p, b)
        p, o, om = adam_update(learn, g, o, p)
        return p, o, (loss, om["grad_norm"])

    opt = adam_init(params)
    pipe = SyntheticTokenPipeline(vocab=LEARN_VOCAB, seq_len=TRAIN_S,
                                  batch=TRAIN_B, seed=0, device=dev)
    pairs = []
    t0 = time.time()
    for i in range(LEARN_STEPS):
        b = pipe.next_batch()
        if i == LEARN_STEPS - 1:
            t_save = time.time()
            path = ckpt.save(tmp, i - 1, {"params": params, "opt": opt})
            save_s = time.time() - t_save
            last = b
        params, opt, pair = learn_step(params, opt, b)
        pairs.append(pair)
    torch.cuda.synchronize()
    learn_s = time.time() - t0 - save_s
    _finite(pairs, "learning run")
    first, final = float(pairs[0][0]), float(pairs[-1][0])
    out.update(learn_first_loss=first, learn_last_loss=final,
               learn_s=learn_s)
    log(f"  (a) {LEARN_STEPS} steps at lr 1e-3, warmup 20, tokens of "
        f"{LEARN_VOCAB}: loss {first:.3f} "
        f"-> {final:.3f} ({'learned' if final < first - 0.5 else 'check lr'}"
        f"), {learn_s:.1f} s with the pipeline's draws")
    if not final < first - 0.5:
        raise AssertionError(f"the trainer did not learn: {first} -> "
                             f"{final}")
    size = sum(f.stat().st_size for f in Path(path).iterdir())
    t_load = time.time()
    state, _ = ckpt.restore(tmp, {"params": params, "opt": opt})
    load_s = time.time() - t_load
    p2, o2, _ = learn_step(state["params"], state["opt"], last)
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves((params, opt)), tree_leaves((p2, o2))))
    log(f"  (c) resume: step {LEARN_STEPS - 2}'s checkpoint "
        f"({size / 1e9:.2f} GB: params and moments, fp32) saved in "
        f"{save_s:.1f} s, restored in {load_s:.1f} s; step "
        f"{LEARN_STEPS - 1} from it bitwise the uninterrupted run's: {same}")
    out.update(ckpt_gb=size / 1e9, ckpt_save_s=save_s, ckpt_load_s=load_s,
               resume_bitwise=same)
    shutil.rmtree(tmp, ignore_errors=True)
    if not same:
        raise AssertionError("the resumed step differs from the "
                             "uninterrupted run")
    del params, opt, state, p2, o2, pipe
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_twin(torch):
    """(b): tinyllama at full width and TWIN_LAYERS layers in fp32 (TF32
    off): one ``make_train_step`` on the card against the same step on
    the CPU from one state on one batch (loss within TRAIN_LOSS_RTOL
    relative, params within TWIN_PARAM_ATOL), and ``microbatches=2``
    against 1 on the card (params within 1e-5, loss within 1e-4, the
    reference test's bounds). Returns the errors."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import SyntheticTokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import LM
    from repro_torch.train.optimizer import adam_init, tree_leaves, tree_map
    dev = torch.device(DEVICE)
    cfg = get_config(TRAIN_ARCH).replace(num_layers=TWIN_LAYERS,
                                         dtype="float32")
    card = LM(cfg).init(torch.Generator(device=dev).manual_seed(1),
                        dtype=torch.float32)
    cpu = tree_map(lambda t: t.cpu(), card)
    batch = SyntheticTokenPipeline(vocab=cfg.vocab_size, seq_len=TWIN_S,
                                   batch=TWIN_B, seed=1,
                                   device="cpu").next_batch()
    batch_d = {k: v.to(dev) for k, v in batch.items()}
    step = make_train_step(cfg)
    t0 = time.time()
    pc, oc, mc = step(card, adam_init(card), batch_d)
    torch.cuda.synchronize()
    t_card = time.time() - t0
    t0 = time.time()
    pp, op, mp = step(cpu, adam_init(cpu), batch)
    t_cpu = time.time() - t0
    loss_rel = abs(float(mc["loss"]) - float(mp["loss"])) / abs(
        float(mp["loss"]))
    gn_rel = abs(float(mc["grad_norm"]) - float(mp["grad_norm"])) / abs(
        float(mp["grad_norm"]))
    p_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        tree_leaves((pc, oc)), tree_leaves((pp, op))))
    p2, _, m2 = make_train_step(cfg, microbatches=2)(card, adam_init(card),
                                                     batch_d)
    mb_err = max(float((a - b).abs().max())
                 for a, b in zip(tree_leaves(pc), tree_leaves(p2)))
    mb_loss = abs(float(mc["loss"]) - float(m2["loss"]))
    log(f"  (b) L{TWIN_LAYERS} fp32, B {TWIN_B} x S {TWIN_S}: card vs CPU "
        f"loss {loss_rel:.2e} relative, grad_norm {gn_rel:.2e}, params and "
        f"moments max |diff| {p_err:.2e} (bound {TWIN_PARAM_ATOL}); "
        f"microbatches 2 vs 1 on the card: params {mb_err:.2e}, loss "
        f"{mb_loss:.2e}; step {t_card:.2f} s on the card (first call), "
        f"{t_cpu:.2f} s on the CPU")
    if loss_rel > TRAIN_LOSS_RTOL or gn_rel > TRAIN_LOSS_RTOL \
            or p_err > TWIN_PARAM_ATOL:
        raise AssertionError("the card's train step is not the CPU's")
    if mb_err >= 1e-5 or mb_loss >= 1e-4:
        raise AssertionError("microbatches 2 != 1 on the card")
    del card, cpu, pc, oc, pp, op, p2
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss_rel": loss_rel, "grad_norm_rel": gn_rel,
            "param_err": p_err, "microbatch_param_err": mb_err,
            "microbatch_loss_err": mb_loss}


def train_lstm(torch):
    """(d): the paper's LSTM trained as ``launch.train_forecaster`` does
    (``synthetic_twitter_trace`` of 4 h, seed 2, split 75/25; hidden 25,
    history 600, horizon 60, batch 64) for LSTM_STEPS on the card, the
    loss falling; a CPU twin of LSTM_TWIN_STEPS from the same seed (one
    init, the same batch indices) within LSTM_REL_TOL; the device time
    and kernels of one step beside its wall time; MAE and under-prediction
    rate of LSTM, MovingMax and the ensemble on the test split. Returns
    (the trained forecaster, the numbers)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import forecaster as pf
    from repro_torch.data.traces import synthetic_twitter_trace
    from repro_torch.train.optimizer import (AdamConfig, adam_init,
                                             adam_update, value_and_grad)
    trace = synthetic_twitter_trace(seconds=4 * 3600, seed=2)
    split = int(len(trace) * 0.75)
    torch.cuda.synchronize()
    t0 = time.time()
    fc, losses = pf.train_lstm_forecaster(trace[:split], steps=LSTM_STEPS,
                                          device=DEVICE)
    torch.cuda.synchronize()
    ms = (time.time() - t0) / LSTM_STEPS * 1e3
    t0 = time.time()
    _, cpu = pf.train_lstm_forecaster(trace[:split], steps=LSTM_TWIN_STEPS,
                                      device="cpu")
    cpu_ms = (time.time() - t0) / LSTM_TWIN_STEPS * 1e3
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu))
    # one step under the profiler: its kernels and their device time
    xs, ys = pf._windows(trace[:split], pf.HISTORY, pf.HORIZON)
    scale = float(max(trace[:split].max(), 1.0))
    xb = torch.from_numpy(xs[:64] / scale).to(DEVICE)
    yb = torch.from_numpy(ys[:64] / scale).to(DEVICE)
    params = fc.params
    opt = adam_init(params)
    cfg = AdamConfig(lr=3e-3, warmup_steps=20, total_steps=LSTM_STEPS,
                     grad_clip=1.0)

    def one():
        (_, _), g = value_and_grad(pf._mse, params, xb, yb)
        return adam_update(cfg, g, opt, params)

    one()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.time()
        one()
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    ev = [e for e in prof.key_averages() if e.device_type == cuda
          and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
    n_k = sum(e.count for e in ev)
    test = trace[split:]
    rows = {"LSTM (paper)": fc, "MovingMax": pf.MovingMaxForecaster(),
            "Ensemble(max)": pf.EnsembleMaxForecaster(
                members=(fc, pf.MovingMaxForecaster()))}
    mae = {n: pf.forecast_mae(f, test, stride=240) for n, f in rows.items()}
    out = {"first_loss": losses[0], "last_loss": losses[-1],
           "ms_per_step": ms, "cpu_ms_per_step": cpu_ms,
           "twin_rel": rel, "profiled_step_wall_ms": wall,
           "profiled_step_device_ms": dev_ms, "profiled_step_kernels": n_k,
           "mae": mae}
    log(f"  (d) LSTM {LSTM_STEPS} steps on the card: loss {losses[0]:.4f} "
        f"-> {losses[-1]:.4f}, {ms:.1f} ms a step (host clock); CPU twin "
        f"{LSTM_TWIN_STEPS} steps at {cpu_ms:.1f} ms a step, first "
        f"{LSTM_TWIN_STEPS} losses within {rel:.2e} relative; one step "
        f"under the profiler: {n_k} kernels, {dev_ms:.2f} ms device in "
        f"{wall:.1f} ms wall ({100 * dev_ms / wall:.1f}% busy)")
    for n, m in mae.items():
        log(f"      {n:<16} MAE {m['mae']:8.2f}  under-predict "
            f"{m['under_rate']:7.2%}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the LSTM's loss did not fall: {losses[0]} -> "
                             f"{losses[-1]}")
    if rel > LSTM_REL_TOL:
        raise AssertionError(f"LSTM card vs CPU losses {rel} apart")
    return fc, out


class ForecastFromHistory:
    """The trained LSTM as the controller's forecaster. The reference's
    ``LSTMForecaster.predict`` raises on an empty history (``np.pad``'s
    "edge" mode), which the loop's first decision at t = 0 passes: that
    one forecast is 0 (the controller floors it at ``min_load``); every
    other is the LSTM's, counted in ``calls``."""

    def __init__(self, lstm):
        self.lstm = lstm
        self.calls = []

    def predict(self, recent):
        if len(recent) == 0:
            return 0.0
        y = self.lstm.predict(recent)
        self.calls.append(y)
        return y


def train_phase(torch, profiles):
    """The training path on the card (A10, A11): (a) tinyllama-1.1b at
    full width, (b) its card = CPU and microbatch checks, (c) resume
    bitwise (``train_full``, ``train_twin``); (d) the paper's LSTM
    (``train_lstm``), then the InfAdapter loop on the dense full-width
    ladder with the trained LSTM as its forecaster for
    LSTM_SERVE_SECONDS. The training path launches no kernel of the port
    (it runs with ``use_kernels`` off, and the kernels refuse autograd):
    asserted. Returns the serve loop's launch counts."""
    import tempfile
    from repro_torch.kernels import ops
    t_phase = time.time()
    log(f"[16] train: {TRAIN_ARCH} at full width, the paper's LSTM")
    ops.reset_launch_counts()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    full = train_full(torch, tmp)
    t_a = time.time()
    twin = train_twin(torch)
    t_b = time.time()
    fc, lstm = train_lstm(torch)
    t_d = time.time()
    if any(ops.launch_counts().values()):
        raise AssertionError(f"the training path launched port kernels: "
                             f"{ops.launch_counts()}")
    forecaster = ForecastFromHistory(fc)
    launches, _ = serve_phase(torch, profiles=profiles,
                              forecaster=forecaster,
                              seconds=LSTM_SERVE_SECONDS, close=True)
    if not forecaster.calls:
        raise AssertionError("the controller never asked the LSTM")
    lstm["controller_forecasts"] = forecaster.calls
    log(f"  (d) the LSTM forecast {len(forecaster.calls)} times in the "
        f"loop: {[round(y, 2) for y in forecaster.calls]} req/s")
    summary = {"full": full, "twin": twin, "lstm": lstm,
               "wall_s": {"full": t_a - t_phase, "twin": t_b - t_a,
                          "lstm": t_d - t_b, "serve": time.time() - t_d,
                          "phase": time.time() - t_phase}}
    log("  train summary " + json.dumps(summary, default=str))
    return launches


DRYRUN_ARCH = "tinyllama-1.1b"


def dryrun_phase(torch):
    """The port's production-mesh dry run for DRYRUN_ARCH over every shape
    and both meshes, as a user runs it (``python -m
    repro_torch.launch.dryrun``, a subprocess); it must exit 0, and each
    pair's per-device bytes, counted FLOPs and usefulness are printed."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.time()
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                            "--arch", DRYRUN_ARCH, "--shape", "all",
                            "--both-meshes", "--out", tmp], env=env,
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=300)
        wall = time.time() - t0
        if r.returncode != 0:
            raise AssertionError(f"dryrun exited {r.returncode}: "
                                 f"{(r.stdout + r.stderr)[-3000:]}")
        log(f"[21] dry run ({DRYRUN_ARCH}, every shape, both meshes; "
            f"subprocess wall {wall:.1f} s)")
        for f in sorted(Path(tmp).glob("*.json")):
            d = json.loads(f.read_text())
            if d.get("skipped"):
                log(f"  {f.stem}: skipped ({d['reason'][:60]})")
                continue
            per = d["per_device_bytes"]
            log(f"  {f.stem}: per-device bytes params {per['params']} opt "
                f"{per['opt']} cache {per['cache']} batch {per['batch']}; "
                f"counted FLOPs {d['flops_counted_global']:.4e} global "
                f"({d['hlo_flops_per_device']:.4e} a device); usefulness "
                f"{d['usefulness']:.4f}")
    return wall


def main():
    t_start = time.time()
    ap = argparse.ArgumentParser()
    ap.add_argument("--ab", metavar="SRC", default=None,
                    help="time only flash_prefill and flash_decode (beside "
                         "SDPA), paged_decode (its decode step and one "
                         "fused-tick layer) and ssd_scan (mamba2-130m's and "
                         "hymba-1.5b's serve shapes) of the repro_torch "
                         "under SRC (a checkout's src/), print one JSON line "
                         "and stop")
    ap.add_argument("--phases", default=None, metavar="NAMES",
                    help="after the build, run only these phases "
                         "(comma-separated: kernels, whisper, vlm, resnet, "
                         "dryrun) and print no result line")
    args = ap.parse_args()
    src = Path(args.ab).resolve() if args.ab else ROOT / "src"
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false")
    if not (src / "repro_torch").is_dir():
        sys.exit("chip_smoke: run from a checkout of the repository "
                 f"({src / 'repro_torch'} is missing)")
    sys.path.insert(0, str(src))
    global HBM_BYTES_PER_S
    HBM_BYTES_PER_S, PEAK_FLOPS["torch.bfloat16"] = card_rates()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"[1] device {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    from repro_torch.kernels import build
    if args.ab:
        if not Path(build.__file__).resolve().is_relative_to(src):
            sys.exit(f"chip_smoke: imported {build.__file__}, not from {src}")
        rows = ab_phase(torch)
        print(smi)
        print(json.dumps({"src": str(src), "kernels": rows}))
        return
    t0 = time.time()
    build.ensure_built()
    log(f"[2] build: {time.time() - t0:.1f}s into {build.lib_dir()}")
    for n in build.SOURCES:
        for line in build.build_log(n).splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {n}: {line.strip()}")

    if args.phases:
        for name in args.phases.split(","):
            {"whisper": whisper_phase, "vlm": vlm_phase,
             "resnet": resnet_phase, "kernels": kernel_phase,
             "dryrun": dryrun_phase}[name](torch)
        log(f"phases {args.phases}: total wall time "
            f"{time.time() - t_start:.1f}s")
        return
    walls = {}              # phase -> wall s: the script's time limit

    def timed(name, fn, *args, **kw):
        t = time.time()
        out = fn(*args, **kw)
        walls[name] = round(time.time() - t, 1)
        return out

    rows = timed("kernels", kernel_phase, torch)
    timed("model", model_phase, torch)
    timed("ssm model", ssm_model_phase, torch)
    timed("graphs", graph_phase, torch)
    dense, profiles = timed("serve dense", serve_phase, torch)
    paged, _ = timed("serve paged", serve_phase, torch, paged=True,
                     profiles=profiles)
    prefix = timed("prefix", prefix_phase, torch)
    ssm, _ = timed("serve ssm", serve_phase, torch, arch="mamba2-130m")
    timed("async", async_phase, torch)
    chunked, _ = timed("serve async", serve_phase, torch, profiles=profiles,
                       engine_kw=dict(async_tick=True, scheduler="chunked",
                                      preemption="requeue"),
                       seconds=ASYNC_SERVE_SECONDS)
    timed("spec", spec_phase, torch)
    spec, _ = timed("serve spec", serve_phase, torch, profiles=profiles,
                    engine_kw=dict(speculative="tinyllama-1.1b-L8:"
                                   "tinyllama-1.1b-L22", spec_k=SPEC_K),
                    seconds=SPEC_SERVE_SECONDS)
    obs = timed("obs", obs_phase, torch, profiles)
    prof, _, measured = timed("profile", profiling_phase, torch, profiles)
    fabric = timed("fabric", fabric_phase, torch, profiles)
    evaluation = timed("eval", eval_phase, torch, measured)
    gemma_rows, dense_cfgs = timed("dense configs", dense_config_phase,
                                   torch)
    granite_rows, moe = timed("moe", moe_phase, torch)
    whisper_rows, _ = timed("whisper", whisper_phase, torch)
    internvl_rows, vlm = timed("vlm", vlm_phase, torch)
    timed("resnet", resnet_phase, torch)
    trained = timed("train", train_phase, torch, profiles)
    timed("dryrun", dryrun_phase, torch)
    for r in rows:
        for extra in (gemma_rows, granite_rows, whisper_rows,
                      internvl_rows):
            r.update(extra.get(r["name"], {}))
        r["launches"] = sum(c.get(r["name"], 0) for c in (
            dense, paged, prefix, ssm, chunked, spec, obs, prof, fabric,
            evaluation, dense_cfgs, moe, vlm, trained))
        # of them gemma-2b's loops' (bf16, hd 256: its prefill on the
        # two-head wgmma kernel, its decode step on the step kernel)
        r["gemma_launches"] = dense_cfgs.get(r["name"], 0)
    # paged_decode's row also carries its chunk form at the fused tick's
    # shape (chunk_*; its launches count in the row's one total)
    keys = ("name", "route", "source", "chunk_source", "replaces", "launches",
            "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms", "library_device_ms", "chunk_max_abs_err",
            "chunk_ms", "chunk_plain_ms", "chunk_bound_ms", "chunk_bound_by",
            "chunk_device_ms", "verify_max_abs_err", "verify_ms",
            "verify_plain_ms", "verify_bound_ms", "verify_bound_by",
            "verify_device_ms", "verify_library_ms",
            "verify_library_device_ms", "hymba_ms", "hymba_device_ms",
            "hymba_plain_ms", "hymba_bound_ms")
    # nothing replays from here on: what the process keeps for good is
    # read off by dropping cuBLAS's per-stream workspaces (C1)
    end = settled_memory(torch)
    torch._C._cuda_clearCublasWorkspaces()
    log(f"[17] memory_allocated at the end {end / 1e9:.3f} GB, of it "
        f"{(end - settled_memory(torch)) / 1e6:.1f} MB cuBLAS's per-stream "
        f"workspaces; total wall time {time.time() - t_start:.1f}s; by "
        f"phase {json.dumps(walls)}")
    print(smi)
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys if k in r},
         **{k: v for k, v in r.items()
            if k.startswith(("gemma_", "yi_", "hd32_", "granite_",
                             "whisper_", "internvl_", "p16n8"))}}
        for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
