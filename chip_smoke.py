#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); it imports neither
``jax`` nor the JAX package. In order:

1. the card's name and power limit (``nvidia-smi``);
2. builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
   into ``build/``, one ``nvcc`` per source, all started together, and
   prints each build's seconds; counts the ``HGMMA`` (wgmma) instructions
   of the bf16 flash library with ``cuobjdump -sass`` and fails on none;
3. kernel phase: holds each kernel against its plain PyTorch version on the
   card: the update kernels' packed entries at the MNIST shape
   [8, 1_066_240], at
   M = 1, at a ragged n, at a misaligned view and at n < 4 (within 1e-6),
   ``adafbio_update`` both with one shared ``a`` row and with one ``a`` row
   per client row (the gossip engine's per-node accumulators);
   the int8 codec's quantize and dequantize on a packed message, the codec
   path's [8, 2_173_440] in its 10 leaf segments, at M = 1, at 4 bits, at a ragged
   n, at two misaligned views (one with n % 4 == 0) and at n < 4 (bit for
   bit). Times kernel and
   plain version with CUDA events (median of 30 launches after warm-up,
   each behind a spin kernel that keeps the card busy while the host
   issues it, so a time is the card's and not the host's) beside the bound
   (bytes moved over 3.35 TB/s);
4. main path: ``FedDriver`` (AdaFBiO, ``fused="auto"``) on hyper-
   representation at MNIST width (in 784, hidden 1024, rep 256, 10 classes,
   batch 256, 8 clients: x is 1,066,240 f32 per client), eager and scan
   engines for 4 rounds of q = 8 steps; asserts the kernels' launch counts,
   a finite validation loss and eager == scan;
5. codec path: the same at ``codec="int8"`` with error feedback and
   participation 0.5, eager and scan: one quantize and one dequantize
   launch per leaf per sync (the codec goes leaf by leaf: 10 leaves), the
   update kernels' counts as on the main path, a
   finite loss, eager == scan, and bytes_up as the formula gives them;
6. population path: 32 clients in a bank, cohorts of 8, participants sync
   with staleness weights, int8 with error feedback, 4 rounds: one quantize
   and one dequantize launch per leaf per round, a finite loss, bytes as the
   formulas give them; then broadcast population rounds against the
   masked path with the same cohorts (within 1e-5), and a topk run;
7. hyperclean-mnist-width: hyper-cleaning (8 clients, 7,500 training and
   1,250 validation samples each, 784 features, 10 classes, 30% of the
   training labels corrupted: x is a [8, 7500] table per client, y 7,850
   entries), AdaFBiO eager (tracking the consensus error) and scan, 4
   rounds of q 8, K 4, theta 0.1 (under 1/L_g, asserted): exact launch
   counts, eager == scan within 1e-5, a finite consensus log, finite
   ``true_grad_norm`` and ``val_loss`` at full width, and both against the
   CPU in float64 at a reduced width (feat 64, 512 samples) within 1e-4;
   async-int8-tiers: hyper-representation at MNIST width on 32 clients,
   cohorts of 8, tiered delays, staleness bound 4, delay_eta 0.5,
   participants, int8 with error feedback, 6 rounds: launch counts, bytes
   per arrival, the staleness histogram summing to the accepted arrivals,
   no client in flight dispatched again; the degenerate setting against
   the synchronous population path (within 1e-5); gossip-ring-int8: 8
   nodes on a ring, int8 with error feedback, 4 rounds: 16 directed edges
   billed a sync, launch counts with every adafbio launch on per-node
   accumulators; the complete graph against the star population engine
   (within 1e-5). Each prints steady ms/round and peak device memory;
8. round checks: one round on the card against the same round on the CPU
   through the plain kernels, stage by stage, beside a float64 witness: at
   a Neumann step theta under 1/L_g (held tight), and at the main path's
   theta = 1 (the card held no farther from the witness than the CPU);
9. the quadratic quickstart problem, eager and scan, with its grad-norm
   trajectory;
10. leaf-table phase: the update kernels' leaf-table entries (one launch
   over a table of leaves where they lie, f32 and bf16 mixed) held bit for
   bit against the packed f32 entries (pack, kernel, cast back) and
   against the per-leaf plain versions (KERNEL_RTOL) on mixed tables at
   M 1 and 3 with ``a`` shared and per row, misaligned leaves and leaves of
   1-3 elements, and on qwen1.5-4b's x tree cut to 2 layers (548 M
   elements); then timed on the full x tree (3.56 B elements, 28.5 GB a
   call), warm and cold (tables rebuilt, L2 flushed), beside the plain
   version and the bound. These are rows 1-2 of the kernels line, the
   packed entry's MNIST-shape numbers beside them (``packed_*``);
11. lm-train-qwen1.5-4b: ``FederatedTrainer`` on qwen1.5-4b at full width
   and LM_TRAIN_LAYERS of its 40 layers (full depth until PR 23; 2.29 B x
   and 0.39 B y parameters, bf16 from a seed, one client), launch/train.py's FedConfig (q 4, K 2), LL batch 8 x 1024, UL
   1 x 1024, zeta_0 and Neumann batches 1 x 256: eager 8 steps and scan 2
   rounds from the same init, batches and draws; asserts the exact launch
   counts (storm 2 a local step, adafbio 1 a local step and 1 a sync), one
   launch a tree-level call, finite losses and eager == scan bit for bit;
   prints steady ms a step and a round, LL tokens/s, the model FLOP rate,
   peak memory and the update kernels' ms inside a step. Every layer of
   the training forward runs under remat (``models/remat.py``), as the
   reference's under ``jax.checkpoint``;
11b. lm-train-zamba2-1.2b (full width, 10 of its 38 mamba2 layers and
   the shared block) and lm-train-falcon-mamba-7b (full width, 8 of its
   64 layers; FALCON_STEPS steps, one scan round; both depths cut for the
   script's time limit since PR 23): the
   shape and checks of item 11 at LM_FAMILY_FED (item 11's FedConfig at
   rho 1e-2 and theta 0.1: at item 11's own both families diverge
   within a round), every state leaf finite after every step, sync and
   round (the port's SSD masks before its exponential, where the
   reference's gradient is NaN); then both
   families at reduced size, one local step and one sync on the card
   against the CPU from the same draws (LM_FAMILY_PARITY_REL), and the
   remat'd layer against the direct layer on the card, one layer of each
   family at full width: features and gradients bit for bit;
12. train-ckpt-serve: the port's train CLI on reduced qwen1.5-4b on the
   card (scan, 8 steps, a checkpoint in 2 shards), ``--resume`` for one
   more round, then the serve CLI on 4 requests from the checkpoint: the
   bridge's params equal the saved client mean and every request is served
   once; then the population CLI (N 4, C 2, 2 shards) dense and with
   ``--spill host``, whose checkpoint files must be equal bit for bit;
12b. the LM rounds (``LM_ROUND_PHASES``): ``FederatedTrainer``'s
   population, async and gossip builders on qwen1.5-4b at full width,
   the depth cut to what one card holds, the launcher's FedConfig, seq
   512, global batch 8 over the cohort, 2-3 rounds: lm-population (N 4,
   C 2, broadcast, 4 layers), lm-async (N 4, C 2, tiered delays,
   participants, 2 layers), lm-gossip (a ring of 4, 2 layers),
   lm-population-int8 (N 2, C 1, int8 + EF, 4 layers); each under the cut
   rule (a peak above LM_PEAK_GB halves seq, then drops to 2 layers),
   with exact launch counts, every bank row equal to the sync's state bit
   for bit, the async flight invariants, finite leaves and the wire bytes
   against ``wire_costs``; prints ms a round, the peak and the cut. Then
   the same rounds at reduced size on the CPU and the card (the card
   given the CPU's int8 levels) within the CPU tests' tolerances, and the
   codec's leaf route against the packed route bit for bit at full width
   (the embedding, a layer, the final norm) with the quantize pair timed
   at the embedding leaf [1, 388_956_160]: rows 3-4 of the kernels line;
12c. the host-spill bank (ROADMAP 2c), right after the LM rounds:
   lm-population-spill-int8-qwen1.5-4b, lm-population-int8's spec, seed
   and cut spilled (the bank and the EF bank in pinned host memory, the
   rows built one client at a time, the cohort round, the host
   write-back, the next cohort prefetched on a side stream): the bank, EF
   bank, last_sync and server equal the dense phase's bit for bit (the
   dense phase keeps them on the host), its device peak no higher; then
   lm-population-spill-qwen1.5-4b: qwen1.5-4b at full width and depth
   (40 layers), codec none, C 1, 2 rounds, N 4 or, where 5 rows' pinned
   bytes pass half the host's MemTotal, 2 (printed with the reason),
   under SPILL_CUTS; exact launches, every row of the bank after the last
   round equal to the sync's state leaf by leaf on the host, last_sync, finite leaves, the
   wire bytes; then one round at the other N (SPILL_OTHER_N) with the
   same cut, its device peak within 1 GiB of the first run's; prints ms a
   round by part (gather, round program, broadcast, prefetch), the H2D
   and D2H rates, whether the prefetch freed the next gather, the pinned
   bytes and the peak beside the dense bank's device bytes;
13. flash phase: the prefill's attention kernel against its plain version
   (f32 math) in the prefill's [B, S, H, D] layout: the full-width prefill
   (qwen2.5-14b: 40 heads over 8, head_dim 128, S 1536, bf16, causal), MHA
   at a ragged S 1000, MQA at granite-20b's 48 heads over 1, a sliding
   window (S 4096, window 1024), zamba2-1.2b's shared block (32 heads,
   head_dim 64, S 1536, bf16) and an f32 case (the SIMT kernel; bf16 runs
   on the tensor cores); times kernel, plain version and
   ``F.scaled_dot_product_attention`` (the library yardstick, not on the
   path) beside the bound and the time before the redesign
   (``BEFORE_MS``);
14. quant-decode phase: the int8 decode kernel against its plain version
   on one layer's slice of the serve pool (B 8, H 40 over 8, W 2048,
   Dh 128), at per-row positions from 1 to 2048, MQA, a W that is not a
   multiple of the kernel's tile, a scalar position and every row in the
   cache's last tiles (``QD_CASES``); both attention phases hold each
   element of the output at tol * (1 + |plain|). Times the kernel warm
   (the same pool every call) and cold (a rotation of pools, 100 MB in
   all, so each call finds its pool outside L2 as each layer of a serve
   tick does) beside the time before the redesign; then captures the
   call in a CUDA graph and requires each replay, after q and pos change,
   to equal an eager call bit for bit;
15. mamba-scan phase: the selective-scan kernel against its plain version,
   y and the f32 last state at tol * (1 + |plain|) (1e-5 f32, 2e-2 bf16):
   the full-width prefill (B 1, S 1536, Di 8192, N 16, B and C column
   views of the [1, 1536, 288] projection), B 2 at S 1024, a ragged Di
   (8004), S 1 and bf16 inputs; times kernel and plain version beside the
   bound (the larger of bytes over 3.35 TB/s and the exponentials over the
   special-function units' rate at the card's clock) and the time before
   the redesign;
16. serve phase: qwen2.5-14b at full width (48 layers, bf16, 14.8 B params
   from a seeded generator) through ``Engine(slots=8, max_len=2048,
   kv_quant=True)`` replaying 16 requests of 256, 1024 and 1536 prompt
   tokens: 48 flash launches per admission and 48 int8-decode launches per
   tick, req/s, tok/s, latency, steady prefill and tick times;
17. serve check: with the same weights, two requests' prefill logits and 8
   teacher-forced decode ticks, every path starting each tick from one
   int8 pool, through the kernels against the plain versions: in bf16 beside
   the reference's own path as a witness of bf16 noise, then with the
   weights widened to f32 against a limit that a one-key fault (the
   control) exceeds; and the greedy-token agreement;
18. ssm serve phase: falcon-mamba-7b at full width (64 layers, bf16, 7.3 B
   params) through ``Engine(slots=8, max_len=2048)`` on the same 16
   requests: 64 mamba_scan launches per admission and no other kernel;
19. ssm check: prefill logits and 8 decode ticks through the scan kernel
   against its plain version, in bf16 beside the reference's chunked scan
   as a witness, then in f32 against a limit that a one-step scan fault
   (the state zeroed before the prompt's last 64 steps) exceeds;
20. hybrid serve phase: zamba2-1.2b at full width (38 mamba2 layers and
   the shared attention block after each 6) on 8 of the requests: 6 flash
   launches per admission; then its f32 prefill logits at each prompt
   length through the kernel path against the plain path, within a limit
   that a one-key fault (the control) exceeds, and against the reference
   path where it takes the prompt;
21. the MoE and vlm slice (moe_vlm_phases): serve-qwen3-moe-30b-a3b (all
   48 layers, 128 experts top 8, 32 heads over 4 at head_dim 64, 30.08 B
   params, SERVE_LOAD), serve-llama4-scout-17b-a16e (12 of 48 layers, 16
   experts top 1 beside the shared FFN, 256 prefix embeddings from the
   load generator, 8 requests of 512, 1024 and 1536 tokens),
   serve-deepseek-67b (40 of 95 layers, 8 of SERVE_LOAD's requests) and
   serve-internvl2-76b (32 of 80 layers, 256 prefix embeddings, as
   llama4's requests), each at full width through ``Engine(slots=8,
   max_len=2048, kv_quant=True)`` at the first depth of its cut rule that
   fits (MOE_VLM_SERVE; each depth passed over printed with its reason):
   flash launches L an admission, int8-decode launches L a tick, no other
   kernel, every request once, every logit finite, req/s, tok/s, steady
   prefill ms by prompt length, steady tick ms, peak memory; each with
   the serve check of item 17 on the same width cut to
   SERVE_CHECK_LAYERS layers. Then lm-train-qwen3-moe-30b-a3b (depth 6,
   4 or 2 by the cut rule) and lm-train-internvl2-76b (2 or 1; every
   batch with its prefix embeddings) as item 11b, FALCON_STEPS steps and
   one round; both trainers card vs CPU at reduced size and one
   qwen3-moe layer under remat against the direct layer on the card.
   Each phase prints its seconds. The flash and int8-decode phases (13
   and 14) hold the slice's head layouts too (32 over 4 at head_dim 64,
   64 over 8 at 128);
22. the encdec slice (encdec_phases): serve-whisper-tiny at full width
   and depth (4 encoder and 4 decoder layers, d_model 384, 6 heads over
   6 at head_dim 64, 61 M params) through ``Engine(slots=8,
   max_len=2048, kv_quant=True)``, 16 requests of 4, 64 and 224 prompt
   tokens, each with 2048 frames of encoder embeddings: 12 flash launches
   an admission (the encoder's 4, and each decoder layer's self- and
   cross-attention, neither of the encoder's nor the cross-attention's
   causal, the cross-attention's Sq the prompt and Sk the frames) and 4
   int8-decode launches a tick, then its serve check (item 17);
   lm-train-whisper-tiny at full width and depth as item 11 (the
   launcher's FedConfig; 8 x 1024 frames, 256 decoder tokens), card vs
   CPU at reduced size, one encoder and one decoder layer under remat
   against the direct layers; lm-baselines-whisper-tiny: AdaFBiO and the
   five baselines through FederatedTrainer, one scan round each at the
   same shape, exact launches (AdaFBiO's, the adaptive-"none" three's
   storm_update only, none for fednest and localbsgvrm), every leaf
   finite, then each card vs CPU at reduced size. The flash phase holds
   whisper's encoder (2048 frames), its cross-attention (224 over 2048)
   and a cross case at 1500 frames, none causal; the int8-decode phase
   its 6 over 6 at head_dim 64. Each phase prints its seconds;
23. one JSON line with every kernel's numbers (launches summed over every
   path above), then the result line ``{"ok": true, "device": {...}}``.

Every phase either passes or raises, and the script exits nonzero.
"""
import contextlib
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12              # H100 SXM f32 peak outside the tensor cores
KERNEL_RTOL = 1e-6             # kernel vs plain version, f32
# attention kernels vs their plain versions, element by element:
# |got - want| <= tol * (1 + |want|), the reference's kernel rule
# (tests/test_kernels.py:45, atol = rtol = tol), with its tolerances: 1e-6
# where the inputs are f32 (sums in another order) and 2e-2 where they are
# bf16 (the output's rounding)
ATTN_TOL = {"float32": 1e-6, "bfloat16": 2e-2}
SERVE_WITNESS = 2.0            # bf16 serve checks, see serve_check
# mamba_scan vs its plain version, element by element, as ATTN_TOL: 1e-5
# where the inputs are f32 (the reference's own kernel tolerance,
# tests/test_kernels.py:236) and 2e-2 where they are bf16 (y's rounding)
SCAN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SFU_PER_CLOCK = 16             # exponentials per clock per SM (Hopper SFUs)
QUEUE_FILL_CYCLES = 2_000_000  # the spin before a timed call, ~1 ms
# flash_phase's cases: label, B, H, KV, Sq, Sk, head_dim, dtype, window,
# causal
FLASH_CASES = [
    ("main", 1, 40, 8, 1536, 1536, 128, "bfloat16", None, True),
    ("mha-ragged", 1, 20, 20, 1000, 1000, 128, "bfloat16", None, True),
    ("mqa", 1, 48, 1, 1536, 1536, 128, "bfloat16", None, True),
    ("window", 1, 40, 8, 4096, 4096, 128, "bfloat16", 1024, True),
    # zamba2-1.2b's shared block at the longest prompt
    ("hybrid", 1, 32, 32, 1536, 1536, 64, "bfloat16", None, True),
    # the MoE and vlm slice's prefills at the longest prompt:
    # qwen3-moe-30b-a3b (a group of 8 at head_dim 64) and deepseek-67b and
    # internvl2-76b (64 heads over 8); llama4-scout-17b-a16e's 40 over 8
    # is "main"
    ("qwen3-moe", 1, 32, 4, 1536, 1536, 64, "bfloat16", None, True),
    ("64-over-8", 1, 64, 8, 1536, 1536, 128, "bfloat16", None, True),
    # whisper-tiny's prefill (6 heads over 6 at head_dim 64), neither
    # causal: its encoder over the serve phase's 2048 frames, its
    # cross-attention from the longest prompt (224 tokens) over them, and
    # a cross case at whisper's own 1500 frames (a ragged key tile)
    ("whisper-enc", 1, 6, 6, 2048, 2048, 64, "bfloat16", None, False),
    ("whisper-cross", 1, 6, 6, 224, 2048, 64, "bfloat16", None, False),
    ("cross-ragged", 1, 6, 6, 77, 1500, 64, "bfloat16", None, False),
    ("f32", 1, 8, 2, 512, 512, 64, "float32", None, True)]
# mamba_scan_phase's cases: label, B, S, Di, N, dtype
SCAN_CASES = [("main", 1, 1536, 8192, 16, "float32"),
              ("B=2", 2, 1024, 8192, 16, "float32"),
              ("ragged-Di", 1, 1024, 8004, 16, "float32"),
              ("S=1", 1, 1, 8192, 16, "float32"),
              ("bf16", 1, 1536, 8192, 16, "bfloat16")]
SCAN_TIMED = ("main", "bf16")
SCAN_DT_RANK = 256             # falcon-mamba-7b's dt_rank, d_model / 16
# The two redesigned kernels before their redesign (commit 078fb78: the
# SIMT flash kernel, one lane a state in the scan), timed as time_ms times
# this run's, by scripts/kernel_times.py in one machine call beside the
# redesign (PERF.md section 6: H100 80GB HBM3, 700 W); printed beside this
# run's times
BEFORE_MS = {("flash_attention", "main"): 1.2261,
             ("flash_attention", "mha-ragged"): 0.3866,
             ("flash_attention", "mqa"): 1.4154,
             ("flash_attention", "window"): 3.2199,
             ("flash_attention", "hybrid"): 0.5937,
             ("flash_attention", "f32"): 0.0692,
             ("mamba_scan", "main"): 0.3846, ("mamba_scan", "bf16"): 0.3836}
# quant_decode_phase's cases: label, B, H, KV, W, pos (a [B] tuple or one
# int for every row); Dh 128, bf16 q
QD_CASES = [
    ("main", 8, 40, 8, 2048, (1, 2048, 1000, 1536, 37, 2047, 512, 1300)),
    ("mqa", 4, 48, 1, 2048, (2048, 1, 999, 1700)),
    ("ragged-W", 8, 40, 8, 2000, (2000, 1, 64, 65, 1999, 640, 3, 1234)),
    ("scalar", 8, 40, 8, 2048, 777),
    # every row in the cache's last tiles
    ("long-rows", 8, 40, 8, 2048,
     (2048, 1793, 1900, 2047, 1801, 1999, 2020, 1850))]
# the MoE and vlm slice's decode layouts (label, B, H, KV, W, pos, Dh),
# held and timed beside QD_CASES (Dh 128): qwen3-moe-30b-a3b and the 64
# heads over 8 of deepseek-67b and internvl2-76b
QD_LAYOUTS = [
    ("qwen3-moe", 8, 32, 4, 2048, (1, 2048, 1000, 1536, 37, 2047, 512, 1300),
     64),
    ("64-over-8", 8, 64, 8, 2048, (1, 2048, 1000, 1536, 37, 2047, 512, 1300),
     128),
    # whisper-tiny's decoder self-attention: 6 heads over 6 (a group of 1)
    # at head_dim 64
    ("whisper", 8, 6, 6, 2048, (1, 2048, 1000, 1536, 37, 2047, 512, 1300),
     64)]
COLD_BYTES = 100_000_000       # the cold pools' bytes in all: twice L2
# The decode kernel before its redesign (PR 13's kernel, commit 061b1b3),
# timed warm and cold by scripts/kernel_times.py in one machine call beside
# the redesign (PERF.md section 6: H100 80GB HBM3, 700 W)
BEFORE_MS.update({("quant_decode_attention", "main"): 0.0728,
                  ("quant_decode_attention", "mqa"): 0.0413,
                  ("quant_decode_attention", "ragged-W"): 0.0725,
                  ("quant_decode_attention", "scalar"): 0.0626,
                  ("quant_decode_attention", "long-rows"): 0.0742})
BEFORE_COLD_MS = {"main": 0.0751, "mqa": 0.0427, "ragged-W": 0.0746,
                  "scalar": 0.0670, "long-rows": 0.0767}
# f32 serve check, normwise (serve_check): on the H100 the kernel path
# parted from the plain one by at most 2.7e-5 (a prefill's logits; 1.3e-5
# over the ticks) and the control, one key of each row zeroed in every
# layer, by at least 8.6e-2; the limit sits about 55 times from each
SERVE_F32_RTOL = 1.5e-3
# f32 ssm check (ssm_check), set from the H100's readings (PERF.md
# section 6, PR 14). Prefill logits, normwise: the kernel path parted from
# the plain one by at most 1.1e-5 (the reference's chunked scan by as
# much), the control by at least 5.4e-4. Ticks: the kernel path's distance
# from the plain one was 0.97-1.04 times the reference path's at every
# tick; the control's 7.96 and 4.08 times at ticks 0 and 1, falling to
# 1.71 by tick 7 as the amplified rounding of every path closes on it. The
# witness bound sits about 2x from each reading of the first two ticks
SSM_F32_RTOL = 1e-4
SSM_TICK_WITNESS = 2.0
SSM_CONTROL_TICKS = 2
# f32 hybrid check, normwise (hybrid_check): the reference's own
# kernel-vs-model tolerance (tests/test_kernels.py:259-260). On the H100
# the kernel path parted from the plain one by at most 3.0e-6 (the
# reference path by as much) and the control, one key zeroed in each
# shared-block call, by at least 1.9e-3; the limit sits about 20 times
# from each
HYBRID_F32_RTOL = 1e-4
MAIN_SHAPE = (8, 1_066_240)    # the main path's packed [M, n] x buffer
MSG_ELEMENTS = 2_173_440       # one client's message at MNIST width
MSG_LEAVES = 10                # its leaves: one int8 launch pair each a sync
# the source of each kernel the main paths launch: flash_attention's bf16
# kernel (the serve paths'); its f32 inputs run csrc/flash_attention.cu
SOURCES = {"storm_update": "src/repro_torch/kernels/csrc/storm_update.cu",
           "adafbio_update": "src/repro_torch/kernels/csrc/storm_update.cu",
           "quantize_stoch": "src/repro_torch/kernels/csrc/quantize.cu",
           "dequantize": "src/repro_torch/kernels/csrc/quantize.cu",
           "flash_attention":
               "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
           "quant_decode_attention":
               "src/repro_torch/kernels/csrc/quant_decode.cu",
           "mamba_scan": "src/repro_torch/kernels/csrc/mamba_scan.cu"}
REPLACES = {"storm_update": "src/repro/kernels/storm_update.py:45",
            "adafbio_update": "src/repro/kernels/storm_update.py:80",
            "quantize_stoch": "src/repro/kernels/quantize.py:37",
            "dequantize": "src/repro/kernels/quantize.py:69",
            "flash_attention": "src/repro/kernels/flash_attention.py:63",
            "quant_decode_attention": "src/repro/kernels/quant_decode.py:64",
            "mamba_scan": "src/repro/kernels/mamba_scan.py:44"}
SERVE_ARCH = "qwen2.5-14b"
# the serve phase's workload: 16 requests, all at once, prompts of 256,
# 1024 and 1536 tokens, budgets ~ 1 + Geom(1/16) capped at 32
SERVE_LOAD = dict(n_requests=16, rate=0.0, prompt_lens=(256, 1024, 1536),
                  mean_new_tokens=16.0, max_new_cap=32, seed=0)
SERVE_SLOTS, SERVE_MAX_LEN = 8, 2048
SSM_ARCH = "falcon-mamba-7b"   # the ssm serve phase, SERVE_LOAD's requests
HYBRID_ARCH = "zamba2-1.2b"    # the hybrid serve phase, 8 of them
HYBRID_LOAD = dict(SERVE_LOAD, n_requests=8)
# The MoE and vlm slice's serve phases (cut_serve_phase): name, arch, depths
# (the cut rule takes the first that does not run out of memory), load. The
# first depth from the reference's parameter count in bf16: qwen3-moe-30b-a3b
# whole (30.08 B, 60.2 GB), llama4-scout-17b-a16e 12 of 48 layers (57.0 GB),
# deepseek-67b 40 of 95 (58.7 GB), internvl2-76b 32 of 80 (59.0 GB), so that
# the prefill's activations and the int8 pool fit beside them. The prefix
# archs' prompts (256 image embeddings) take at least 256 text tokens more.
PREFIX_LOAD = dict(HYBRID_LOAD, prompt_lens=(512, 1024, 1536))
MOE_VLM_SERVE = [
    ("serve-qwen3-moe-30b-a3b", "qwen3-moe-30b-a3b", (48, 40), SERVE_LOAD),
    ("serve-llama4-scout-17b-a16e", "llama4-scout-17b-a16e", (12, 10),
     PREFIX_LOAD),
    ("serve-deepseek-67b", "deepseek-67b", (40, 32), HYBRID_LOAD),
    ("serve-internvl2-76b", "internvl2-76b", (32, 24), PREFIX_LOAD)]
# their serve checks: the same width at this depth (f32 needs twice the
# bytes of the served bf16 weights)
SERVE_CHECK_LAYERS = 4
# One round on the card against the same round on the CPU, stage by stage
# (round_check): each stage starts both devices from the card's state before
# it, with the same batches and draws, so they differ only in how cuBLAS and
# the CPU's BLAS order their sums and in the last bit of tanh and exp. A
# float64 run of each stage on the CPU, the witness, shows which side drifts.
# - At theta = CHECK_THETA, under 1/L_g through the round (the script
#   measures L_g, the top eigenvalue of the LL y-y Hessian, and fails
#   otherwise), every stage is held at STAGE_RTOL. On the H100 the worst
#   stage was 1.6e-6, each side 1.6e-6 or less from the witness.
# - At the main path's theta = 1, L_g grows from 1 to about 23 within the
#   round, so (I - theta H)^k in the Neumann product multiplies the f32
#   rounding by up to 22 per factor: both sides end up to 7e-4 from the
#   witness, in the hypergradient estimator w. Card and CPU cannot be held
#   to each other there; the card is held to be no farther from the witness
#   than WITNESS_FACTOR times the CPU's f32 run (the worst ratio measured on
#   the H100 was 1.4), with WITNESS_FLOOR for stages that round to nothing.
CHECK_THETA = 0.1
STAGE_RTOL = 1e-5
WITNESS_FACTOR = 4.0
WITNESS_FLOOR = 1e-6
ENGINE_RTOL = 1e-5             # eager vs scan on the card: the same ops
# hyperclean_path: MNIST's 60,000/10,000 split over 8 clients at 784
# features (synthetic data from the seed). The Neumann step must stay under
# 1/L_g: at this width L_g is far above the reference's small default
# (feat 32) would give, so theta is 0.1, and the run asserts theta * L_g <= 1
HC_MNIST = dict(n_clients=8, n_train_per_client=7500, n_val_per_client=1250,
                feat_dim=784, n_classes=10, corrupt_frac=0.3, batch=256)
HC_THETA = 0.1
HC_ROUNDS = 4
# the exact diagnostics, card f32 against CPU float64, at a reduced width
HC_CHECK = dict(n_clients=8, n_train_per_client=512, n_val_per_client=128,
                feat_dim=64, n_classes=10, corrupt_frac=0.3, batch=64)
DIAG_RTOL = 1e-4
ASYNC_ROUNDS = 6
GOSSIP_ROUNDS = 4
# Broadcast population rounds against the masked path with the same
# cohorts: the same math, but the hypergradient's batched products run over
# 4 clients instead of 8, so the card may order their sums differently. At
# CHECK_THETA (under 1/L_g) that stays a rounding difference; at theta 1
# (section 7 of PERF.md) it would be magnified up to 22 times per Neumann
# factor, so the comparison runs at CHECK_THETA.


# The LM slice (lm_train_phase): the trainer on qwen1.5-4b at full width
# and LM_TRAIN_LAYERS of its 40 layers, with launch/train.py's FedConfig
# and one client; per step an LL batch of 8 x 1024 tokens, a UL batch of
# 1 x 1024, zeta_0 and K = 2 Neumann batches of 1 x 256, microbatch 1.
# It ran all 40 layers until the host-spill phase (PR 23) took over full
# depth (lm_spill_phase: qwen1.5-4b's local steps at 40 layers), and the
# script's time limit wanted the ~40 s back.
LM_ARCH = "qwen1.5-4b"
LM_TRAIN_LAYERS = 24
LM_SEQ, LM_BATCH = 1024, 8
LM_FED = dict(q=4, neumann_k=2, lr_x=1e-2, lr_y=1e-1)
LM_STEPS = 8                   # eager 8 steps; scan 2 rounds of q = 4
# The ssm and hybrid families' trainers (lm_family_phase), at their full
# width with LM_FAMILY_FED and LM_SEQ x LM_BATCH: zamba2-1.2b at
# HYBRID_DEPTHS (10 of its 38 layers) for LM_STEPS; falcon-mamba-7b at the
# first depth of FALCON_DEPTHS that one card holds, for FALCON_STEPS (one
# scan round of q 4). Both depths were cut (zamba2 from 38, falcon from
# 32) when the host-spill phases came, to keep the script inside its
# time limit: zamba2 took ~8.5 s a step and falcon ~12 s at those depths.
# LM_FAMILY_FED is LM_FED at rho 1e-2 and theta 0.1. At LM_FED both
# families diverge within a round (PERF.md, section 6): the Neumann step
# theta 1 exceeds 1/L_g, so the first depth-1 step multiplies
# falcon-mamba-7b's hypergradient by ~10^4 (w 2.6 -> 7.0e4; non-finite
# after step 2, at rho 1e-2), and at the launcher's rho 1e-4 the warm
# start's a = w_0^2 (refreshed only at a sync) lets an element whose first
# hypergradient was ~0 step by up to lr / rho times its w (zamba2-1.2b
# non-finite after step 3; scripts/lm_train_diag.py shows both); the
# reference's own launcher on reduced falcon-mamba-7b at seq 1024 reaches
# f = nan at step 4 on the CPU. The MNIST-width phases run theta 0.1 for
# the same reason (CHECK_THETA, HC_THETA), and the tests hold free runs at
# rho 1e-2 (tests/test_torch_lm_train.py: RHO).
LM_FAMILY_FED = dict(LM_FED, rho=1e-2, theta=0.1)
HYBRID_DEPTHS = (10,)
FALCON_DEPTHS = (8,)
FALCON_STEPS = 4
# The MoE and vlm slice's trainers (moe_vlm_phases): arch and depths under
# the same cut rule, FALCON_STEPS steps and one round at LM_FAMILY_FED. At
# qwen1.5-4b's ~15.6 bytes a parameter under remat, qwen3-moe-30b-a3b's 4
# layers (3.08 B params) sit near 48 GiB and internvl2-76b's 2 (3.81 B)
# near 58 GiB. llama4-scout-17b-a16e (4.27 B at one layer with its head) and
# deepseek-67b (the dense family, trained by lm-train-qwen1.5-4b) train in
# the CPU tests only.
MOE_VLM_TRAIN = [("qwen3-moe-30b-a3b", (6, 4, 2)), ("internvl2-76b", (2, 1))]
# the same trainers at reduced size, card against CPU (lm_family_parity):
# 2 training sequences of 512 tokens (2 scan chunks each), within the
# CPU tests' per-stage limit against the reference
# (tests/test_torch_lm_train.py: TRAIN_REL)
LM_FAMILY_PARITY_SEQ = 512
LM_FAMILY_PARITY_REL = 1e-4
# the leaf-table entries against the packed f32 entries and the per-leaf
# plain versions (leaf_table_phase): qwen1.5-4b's x tree cut to this depth
LEAF_CUT_LAYERS = 2
# mixed f32/bf16 leaf tables: (rows, [(elements a row, dtype, offset in
# elements of the leaf's start from its allocation)]); an offset of 1
# leaves the operands off 16-byte alignment
LEAF_CASES = [
    ("mixed M=1", 1, [(4096, "bfloat16", 0), (1000, "float32", 0),
                      (1, "bfloat16", 0), (2, "float32", 0),
                      (3, "bfloat16", 0), (65_541, "bfloat16", 0)]),
    ("mixed M=3", 3, [(4096, "bfloat16", 0), (1000, "float32", 0),
                      (1, "bfloat16", 0), (2, "float32", 0),
                      (3, "bfloat16", 0), (65_541, "bfloat16", 0)]),
    ("misaligned", 2, [(4096, "bfloat16", 1), (1001, "float32", 1),
                       (8, "bfloat16", 3), (2560, "float32", 0)])]
COLD_FLUSH_BYTES = 128 * 2 ** 20   # written before each cold call: > L2
# The LM trainer's population, async and gossip rounds (lm_rounds_phase):
# qwen1.5-4b at full width, the depth cut to what one card holds, the
# launcher's FedConfig and ShapeConfig("cli", 512, 8): the global batch of
# 8 split over the cohort. Cut rule: where a phase's peak passes
# LM_PEAK_GB, seq 256, then 2 layers.
LM_ROUND_SEQ, LM_ROUND_BATCH = 512, 8
LM_ROUNDS = 2
LM_PEAK_GB = 76.0
LM_ROUND_PHASES = [
    ("lm-population-qwen1.5-4b",
     dict(mode="population", n=4, c=2, layers=4, codec="none")),
    # seed 1: the fast tier's client is in round 0's cohort, so arrivals
    # land in rounds 1 and 2, and round 2 finds a client in flight
    ("lm-async-qwen1.5-4b",
     dict(mode="async", n=4, c=2, layers=2, codec="none", rounds=3,
          seed=1)),
    ("lm-gossip-qwen1.5-4b",
     dict(mode="gossip", n=4, c=4, layers=2, codec="none")),
    ("lm-population-int8-qwen1.5-4b",
     dict(mode="population", n=2, c=1, layers=4, codec="int8"))]
# The host-spill phases (lm_spill_phase, ROADMAP 2c): qwen1.5-4b's
# population at full width and depth with the bank in pinned host memory,
# at the LM rounds' FedConfig and shape: N SPILL_N, or SPILL_SMALL_N where
# SPILL_N + 1 rows (the bank and the broadcast's base) pin more than half
# the host's memory; C SPILL_C, codec none; then one round at
# SPILL_OTHER_N[N] with the same cut, its device peak within
# SPILL_PEAK_SAME_GIB of the first run's. Cut rule: where the peak passes
# LM_PEAK_GB, seq 256, then 32, then 24 layers.
SPILL_N, SPILL_SMALL_N, SPILL_C = 4, 2, 1
SPILL_CUTS = ((LM_ROUND_SEQ, 40), (LM_ROUND_SEQ // 2, 40),
              (LM_ROUND_SEQ // 2, 32), (LM_ROUND_SEQ // 2, 24))
SPILL_OTHER_N = {4: 2, 2: 1}
SPILL_PEAK_SAME_GIB = 1.0
# the same rounds at reduced qwen1.5-4b, card against CPU: the tolerances
# the CPU tests hold the port to against the reference at K = 1
# (tests/test_torch_lm_population.py, _async.py, _gossip.py)
LM_PARITY_FED = dict(q=2, neumann_k=1, rho=1e-2)
LM_PARITY_REL = {"population": 1e-4, "async": 1e-3, "gossip": 1e-4}
LM_PARITY_EF_REL = 5e-2
# The encdec slice (encdec_phases, ROADMAP 1c with 1i): whisper-tiny at
# full width and depth (4 encoder and 4 decoder layers, d_model 384, 6
# heads over 6 at head_dim 64, d_ff 1536, vocab 51865: 61 M params; no
# cut). Served through Engine(slots=8, max_len=2048, kv_quant=True), so
# each request carries 2048 frames of encoder embeddings (whisper's own
# window is 1500 frames; the reference path's attend_flash needs the
# frames a multiple of attn_chunk, 1024); the load's prompts and budgets
# from whisper's 448-token decoder context: prompts of 4, 64 and 224
# tokens, budgets ~ 1 + Geom(1/64) capped at 224
ENCDEC_ARCH = "whisper-tiny"
ENCDEC_LOAD = dict(n_requests=16, rate=0.0, prompt_lens=(4, 64, 224),
                   mean_new_tokens=64.0, max_new_cap=224, seed=0)
# lm-baselines-whisper-tiny: AdaFBiO and the five baselines of Table 1
# through FederatedTrainer, one scan round each at lm_train_phase's shape
BASELINES = ("adafbio", "adafbio_na", "fedbioacc", "fedavg_sgd", "fednest",
             "localbsgvrm")
# whisper-tiny's trainers at reduced size, card against CPU
# (lm_family_parity): the CPU tests' per-stage limit for the family against
# the reference (tests/lm_family.py: ENCDEC_STAGE_REL; its first local step
# rounds to ~1e-4 in the cross-attention's leaves of w on every path)
ENCDEC_PARITY_REL = 3e-4


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=30, warmup=3, before=None):
    """Median per-call device time of ``fn`` with CUDA events. A spin
    kernel of QUEUE_FILL_CYCLES is queued before each timed call, so the
    card is still busy while the host issues the call and the events see
    its device work alone. ``before``, if given, runs ahead of each timed
    call, outside the events (a cache flush)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_FILL_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def hgmma_count(build, lib_path):
    """The HGMMA (wgmma) instructions in a built library's SASS, read with
    the toolkit's cuobjdump (``build`` is ``repro_torch.kernels._build``)."""
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True,
                         timeout=300)
    return sum("HGMMA" in line for line in out.stdout.splitlines())


def kernel_phase(torch, kern, ref):
    """Each kernel against its plain version at every listed shape; returns
    the numbers at the main path's shape."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = [("main", MAIN_SHAPE, 0), ("M=1", (1, MAIN_SHAPE[1]), 0),
             ("ragged", (8, 1_000_003), 0),
             ("misaligned", (1, 1_000_003), 1), ("n<4", (3, 3), 0)]
    results = {}
    for label, (m, n), offset in cases:
        def buf(rows, cols):
            flat = torch.randn(rows * cols + offset, generator=gen,
                               device=dev)
            return flat[offset:].view(rows, cols)
        gn, go, est, p, w = (buf(m, n) for _ in range(5))
        a = buf(1, n)[0].abs()
        # the gossip engine's per-node accumulators: one row per client row
        a_rows = buf(m, n).abs()
        beta = torch.rand((), generator=gen, device=dev)
        lr_eta = torch.full((), 0.01, device=dev)
        rho = torch.full((), 1e-4, device=dev)
        calls = {
            "storm_update": (
                lambda: kern.storm_update(gn, go, est, beta),
                lambda: ref.storm_update_ref(gn, go, est, beta),
                16 * m * n),
            "adafbio_update": (
                lambda: kern.adafbio_update(p, w, a, lr_eta, rho),
                lambda: ref.adafbio_update_ref(p, w, a, lr_eta, rho),
                12 * m * n + 4 * n),
            "adafbio_update per-row": (
                lambda: kern.adafbio_update(p, w, a_rows, lr_eta, rho),
                lambda: ref.adafbio_update_ref(p, w, a_rows, lr_eta, rho),
                16 * m * n),
        }
        for name, (fast, plain, nbytes) in calls.items():
            got, want = fast(), plain()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            limit = KERNEL_RTOL * max(1.0, want.abs().max().item())
            ok = err <= limit
            row = {"max_abs_err": err, "limit": limit}
            if label == "main":
                row.update(ms=time_ms(torch, fast), plain_ms=time_ms(
                    torch, plain), bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    bytes=nbytes)
                if name.endswith(" per-row"):
                    results["adafbio_update"].update(
                        {f"per_row_{k}": row[k] for k in
                         ("max_abs_err", "ms", "plain_ms", "bound_ms")})
                else:
                    results[name] = row
            print(f"kernel {name:22s} {label:10s} [{m}, {n}] max_abs_err "
                  f"{err:.3e} (limit {limit:.1e}) "
                  + (f"kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f}"
                     f" ms bound {row['bound_ms']:.4f} ms"
                     if label == "main" else "")
                  + ("" if ok else "  FAILED"), flush=True)
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version at {label} [{m}, {n}]")
    return results


def quantize_phase(torch, qkern, ref, ops, segments):
    """quantize_stoch and dequantize against their plain versions, bit for
    bit, at every listed shape; returns the numbers at the codec path's
    message shape [8, sum(segments)]."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    cases = [("main", 8, segments, 0, 8), ("M=1", 1, segments, 0, 8),
             ("bits=4", 8, segments, 0, 4),
             ("ragged", 8, (1, 999_999, 3), 0, 8),
             ("misaligned", 1, (500_000, 500_003), 1, 8),
             # n % 4 == 0: only the alignment test keeps float4 off
             ("misaligned4", 2, (500_000, 500_004), 1, 8),
             ("n<4", 3, (1, 2), 0, 8)]
    results = {}
    for label, m, segs, offset, bits in cases:
        n, qmax = sum(segs), (1 << (bits - 1)) - 1
        offsets = [0]
        for size in segs:
            offsets.append(offsets[-1] + size)
        flat = torch.randn(m * n + offset, generator=gen, device=dev)
        x = flat[offset:].view(m, n)
        for i, (a, b) in enumerate(zip(offsets, offsets[1:])):
            x[:, a:b] *= 10.0 ** (i % 5 - 2)
        u = torch.rand((m, n), generator=gen, device=dev)
        table = torch.tensor(offsets, dtype=torch.int64, device=dev)
        scale = ops.leaf_scales(x, offsets, qmax)
        q = qkern.quantize_stoch(x, u, scale, table, qmax)
        q_in = q
        if offset:
            qbuf = torch.empty(m * n + offset, dtype=torch.int8, device=dev)
            qbuf[offset:].copy_(q.view(-1))
            q_in = qbuf[offset:].view(m, n)
        dq = qkern.dequantize(q_in, scale, table)
        q_ref = ref.quantize_stoch_ref(x, u, scale, table, qmax)
        dq_ref = ref.dequantize_ref(q, scale, table)
        torch.cuda.synchronize()
        errs = {"quantize_stoch": (q.int() - q_ref.int()).abs().max().item(),
                "dequantize": (dq - dq_ref).abs().max().item()}
        exact = {"quantize_stoch": torch.equal(q, q_ref),
                 "dequantize": torch.equal(dq.view(torch.int32),
                                           dq_ref.view(torch.int32))}
        calls = {
            "quantize_stoch": (
                lambda: qkern.quantize_stoch(x, u, scale, table, qmax),
                lambda: ref.quantize_stoch_ref(x, u, scale, table, qmax),
                9 * m * n),
            "dequantize": (
                lambda: qkern.dequantize(q, scale, table),
                lambda: ref.dequantize_ref(q, scale, table),
                5 * m * n)}
        for name, (fast, plain, nbytes) in calls.items():
            # the per-(row, segment) scales and the offset table are read
            # once too
            nbytes += 4 * m * len(segs) + 8 * (len(segs) + 1)
            row = {"max_abs_err": errs[name]}
            if label == "main":
                row.update(ms=time_ms(torch, fast), plain_ms=time_ms(
                    torch, plain), bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    bytes=nbytes)
                results[name] = row
            print(f"kernel {name:15s} {label:10s} [{m}, {n}] {bits} bits, "
                  f"{len(segs)} segments: max_abs_err {errs[name]:.3e}, "
                  f"bit-exact {exact[name]} "
                  + (f"kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f}"
                     f" ms bound {row['bound_ms']:.4f} ms"
                     if label == "main" else ""), flush=True)
            if not exact[name]:
                raise AssertionError(f"{name} differs from its plain "
                                     f"version at {label} [{m}, {n}]")
    return results


def rel_err(torch, got, want):
    """Normwise relative error of ``got`` against ``want``, on the host."""
    got, want = got.double().cpu(), want.double().cpu()
    return ((got - want).norm() / max(want.norm().item(), 1e-30)).item()


def reset_launches(kerns):
    for k in kerns:
        k.reset_launches()


def launch_counts(kerns):
    counts = {}
    for k in kerns:
        counts.update(k.launches)
    return counts


def steady_ms(drv):
    return 1e3 * sum(drv.round_seconds) / len(drv.round_seconds)


def mnist_width(n_clients=8):
    from repro_torch.configs import HyperRepConfig
    return HyperRepConfig(n_clients=n_clients, in_dim=784, hidden=1024,
                          rep_dim=256, n_classes=10, batch=256)


def message_segments(cfg):
    """Leaf sizes of one client's message in packed order (dict keys
    sorted): v (y-shaped), w (x-shaped), x, y; x is {b1, b2, w1, w2}, y the
    heads of every client."""
    x = [cfg.hidden, cfg.rep_dim, cfg.in_dim * cfg.hidden,
         cfg.hidden * cfg.rep_dim]
    y = [cfg.n_clients * cfg.rep_dim * cfg.n_classes]
    return y + x + x + y


def main_path(torch, kerns):
    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.tasks import FedDriver, build_hyperrep

    cfg = mnist_width()
    fed = cfg.fed
    task = build_hyperrep(cfg, device="cuda")
    rounds, q = 4, fed.q
    steps = rounds * q
    launches, finals = {}, {}
    for engine in ("eager", "scan"):
        drv = FedDriver(task["problem"], fed, cfg.n_clients, task["batch_fn"],
                        task["init_xy"], metric_fn=task["val_loss"],
                        engine=engine, device="cuda")
        reset_launches(kerns)
        res = drv.run(steps, seed=0, eval_every=q)
        torch.cuda.synchronize()
        counts = launch_counts(kerns)
        syncs = res.comms[-1]
        want = {"storm_update": 2 * steps, "adafbio_update": steps + syncs,
                "quantize_stoch": 0, "dequantize": 0}
        if counts != want:
            raise AssertionError(f"{engine}: launches {counts}, want {want}")
        if not all(math.isfinite(v) for v in res.metric):
            raise AssertionError(f"{engine}: validation loss {res.metric}")
        ms_round = steady_ms(drv)
        print(f"main path {engine:5s}: {steps} steps, {syncs} syncs, "
              f"launches {counts}; first round {res.compile_seconds:.3f} s; "
              f"steady {ms_round:.2f} ms/round, "
              f"{q * 1e3 / ms_round:.2f} steps/s over "
              f"{len(drv.round_seconds)} rounds; "
              f"val loss {[round(v, 5) for v in res.metric]}", flush=True)
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        finals[engine] = res.final_avg_state
    worst = max(rel_err(torch, a, b) for a, b in zip(
        tree_leaves(finals["scan"]), tree_leaves(finals["eager"])))
    print(f"eager vs scan final state: max normwise rel err {worst:.3e} "
          f"(limit {ENGINE_RTOL})", flush=True)
    if not worst <= ENGINE_RTOL:
        raise AssertionError("eager and scan final states disagree")

    return launches, task, cfg


def codec_path(torch, kerns, task, cfg):
    """The masked path with the int8 codec and error feedback, eager and
    scan: one quantize and one dequantize launch per leaf per sync."""
    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.tasks import FedDriver

    fed = dataclasses.replace(cfg.fed, codec="int8", error_feedback=True)
    rounds, q = 4, fed.q
    steps = rounds * q
    active = max(int(0.5 * cfg.n_clients), 1)
    launches, finals = {}, {}
    for engine in ("eager", "scan"):
        drv = FedDriver(task["problem"], fed, cfg.n_clients, task["batch_fn"],
                        task["init_xy"], metric_fn=task["val_loss"],
                        participation=0.5, engine=engine, device="cuda")
        reset_launches(kerns)
        res = drv.run(steps, seed=0, eval_every=q)
        torch.cuda.synchronize()
        counts = launch_counts(kerns)
        syncs = res.comms[-1]
        want = {"storm_update": 2 * steps, "adafbio_update": steps + syncs,
                "quantize_stoch": MSG_LEAVES * syncs,
                "dequantize": MSG_LEAVES * syncs}
        if counts != want:
            raise AssertionError(f"codec {engine}: launches {counts}, "
                                 f"want {want}")
        if not all(math.isfinite(v) for v in res.metric):
            raise AssertionError(f"codec {engine}: val loss {res.metric}")
        # int8 at 8 bits: each leaf's levels, one byte each, and its scale
        want_up = syncs * active * (MSG_ELEMENTS + 4 * 10)
        if res.bytes_up[-1] != want_up:
            raise AssertionError(f"codec {engine}: bytes_up "
                                 f"{res.bytes_up[-1]}, want {want_up}")
        print(f"codec path int8 {engine:5s}: {syncs} syncs, launches "
              f"{counts}; bytes_up {res.bytes_up[-1]} bytes_down "
              f"{res.bytes_down[-1]}; first round "
              f"{res.compile_seconds:.3f} s; steady {steady_ms(drv):.2f} "
              f"ms/round over {len(drv.round_seconds)} rounds; val loss "
              f"{[round(v, 5) for v in res.metric]}", flush=True)
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        finals[engine] = res.final_avg_state
    worst = max(rel_err(torch, a, b) for a, b in zip(
        tree_leaves(finals["scan"]), tree_leaves(finals["eager"])))
    print(f"codec path eager vs scan final state: max normwise rel err "
          f"{worst:.3e} (limit {ENGINE_RTOL})", flush=True)
    if not worst <= ENGINE_RTOL:
        raise AssertionError("codec path: eager and scan disagree")
    return launches


def population_path(torch, kerns, cfg):
    """32 clients in a bank, cohorts of 8, participants sync with staleness
    weights, int8 with error feedback: one quantize and one dequantize
    launch per leaf per round."""
    from repro_torch.configs import PopulationConfig
    from repro_torch.tasks import FedDriver, build_hyperrep

    cfg32 = mnist_width(32)
    n_msg = sum(message_segments(cfg32))
    task = build_hyperrep(cfg32, device="cuda")
    fed = dataclasses.replace(cfg.fed, codec="int8", error_feedback=True)
    pcfg = PopulationConfig(n=32, cohort=8, sync_mode="participants",
                            staleness_decay=0.5)
    rounds, q = 4, fed.q
    steps = rounds * q
    drv = FedDriver(task["problem"], fed, 32, task["batch_fn"],
                    task["init_xy"], metric_fn=task["val_loss"],
                    population=pcfg, device="cuda")
    reset_launches(kerns)
    res = drv.run(steps, seed=0, eval_every=q)
    torch.cuda.synchronize()
    counts = launch_counts(kerns)
    syncs = res.comms[-1]
    want = {"storm_update": 2 * steps, "adafbio_update": steps + syncs,
            "quantize_stoch": MSG_LEAVES * rounds,
            "dequantize": MSG_LEAVES * rounds}
    if counts != want:
        raise AssertionError(f"population: launches {counts}, want {want}")
    if not all(math.isfinite(v) for v in res.metric):
        raise AssertionError(f"population: val loss {res.metric}")
    # a uniform cohort has 8 distinct clients: 8 messages up, and in
    # participants mode 8 full-precision states down, per sync
    want_bytes = (syncs * 8 * (n_msg + 4 * 10), syncs * 8 * 4 * n_msg)
    got_bytes = (res.bytes_up[-1], res.bytes_down[-1])
    if got_bytes != want_bytes:
        raise AssertionError(f"population: bytes {got_bytes}, "
                             f"want {want_bytes}")
    print(f"population path (N 32, C 8, participants, int8+EF): {rounds} "
          f"rounds, launches {counts}; bytes up/down {got_bytes}; first "
          f"round {res.compile_seconds:.3f} s; steady {steady_ms(drv):.2f} "
          f"ms/round over {len(drv.round_seconds)} rounds; val loss "
          f"{[round(v, 5) for v in res.metric]}", flush=True)
    return counts


def broadcast_vs_masked(torch, task, cfg):
    """Broadcast population rounds against the masked path with the same
    cohorts (the reference's invariant, tests/test_population.py:28)."""
    from repro_torch.configs import PopulationConfig
    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.fed.sampling import UniformSampler
    from repro_torch.tasks import FedDriver

    fed = dataclasses.replace(cfg.fed, theta=CHECK_THETA)
    sampler = UniformSampler(cfg.n_clients, 4, seed=5)
    finals = {}
    for mode in ("population", "masked"):
        kw = (dict(population=PopulationConfig(n=cfg.n_clients, cohort=4))
              if mode == "population" else dict(engine="scan"))
        drv = FedDriver(task["problem"], fed, cfg.n_clients, task["batch_fn"],
                        task["init_xy"], sampler=sampler, device="cuda", **kw)
        finals[mode] = drv.run(2 * fed.q, seed=0,
                               eval_every=2 * fed.q).final_avg_state
    worst = max(rel_err(torch, a, b) for a, b in zip(
        tree_leaves(finals["population"]), tree_leaves(finals["masked"])))
    print(f"broadcast population vs masked (theta {CHECK_THETA}, 2 rounds): "
          f"max normwise rel err {worst:.3e} (limit {ENGINE_RTOL})",
          flush=True)
    if not worst <= ENGINE_RTOL:
        raise AssertionError("broadcast population and masked disagree")


def topk_run(torch, task, cfg):
    from repro_torch.tasks import FedDriver

    fed = dataclasses.replace(cfg.fed, codec="topk", topk_frac=0.1,
                              error_feedback=True)
    drv = FedDriver(task["problem"], fed, cfg.n_clients, task["batch_fn"],
                    task["init_xy"], metric_fn=task["val_loss"],
                    participation=0.5, engine="scan", device="cuda")
    res = drv.run(2 * fed.q, seed=0, eval_every=fed.q)
    syncs = res.comms[-1]
    kept = sum(min(max(int(round(0.1 * s)), 1), s)
               for s in message_segments(cfg))
    want_up = syncs * max(int(0.5 * cfg.n_clients), 1) * kept * (4 + 4)
    if not all(math.isfinite(v) for v in res.metric):
        raise AssertionError(f"topk: val loss {res.metric}")
    if res.bytes_up[-1] != want_up:
        raise AssertionError(f"topk: bytes_up {res.bytes_up[-1]}, "
                             f"want {want_up}")
    print(f"topk run (frac 0.1, EF, scan): {syncs} syncs, bytes_up "
          f"{res.bytes_up[-1]}; val loss {[round(v, 5) for v in res.metric]}",
          flush=True)


def peak_gib(torch):
    return torch.cuda.max_memory_allocated() / 2 ** 30


def add_counts(total, counts):
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def check_counts(what, counts, want):
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, want {want}")


def final_gap(torch, a, b):
    """Largest normwise relative error over the leaves of two final
    states."""
    from repro_torch.core.tree_util import tree_leaves
    return max(rel_err(torch, x, y) for x, y in zip(tree_leaves(a),
                                                    tree_leaves(b)))


def hyperclean_path(torch, kerns):
    """Hyper-cleaning at MNIST width (the paper's second experiment: 8
    clients holding MNIST's 60,000/10,000 split, 784 features, 10 classes,
    30% of the training labels corrupted; synthetic data from the seed):
    AdaFBiO eager (tracking the consensus error) and scan for HC_ROUNDS
    rounds of q 8, K 4; then the exact diagnostics at the final state, and
    card against CPU float64 at HC_CHECK's reduced width."""
    from repro_torch.configs import HyperCleanConfig
    from repro_torch.tasks import FedDriver, build_hyperclean

    cfg = HyperCleanConfig(**HC_MNIST)
    fed = dataclasses.replace(cfg.fed, theta=HC_THETA)
    task = build_hyperclean(cfg, device="cuda")
    q = fed.q
    steps = HC_ROUNDS * q
    launches, finals = {}, {}
    for engine in ("eager", "scan"):
        drv = FedDriver(task["problem"], fed, cfg.n_clients, task["batch_fn"],
                        task["init_xy"], engine=engine,
                        track_consensus=engine == "eager", device="cuda")
        torch.cuda.reset_peak_memory_stats()
        reset_launches(kerns)
        res = drv.run(steps, seed=0, eval_every=q)
        torch.cuda.synchronize()
        counts = launch_counts(kerns)
        syncs = res.comms[-1]
        check_counts(f"hyperclean {engine}", counts, {
            "storm_update": 2 * steps, "adafbio_update": steps + syncs,
            "quantize_stoch": 0, "dequantize": 0})
        add_counts(launches, counts)
        if engine == "eager":
            log = drv.consensus_log
            if len(log) != syncs or not all(
                    math.isfinite(r[k]) for r in log for k in "xyvw"):
                raise AssertionError(f"hyperclean consensus log {log}")
            print("hyperclean consensus error before each sync: "
                  + "; ".join(f"step {r['step']}: " + ", ".join(
                      f"{k} {r[k]:.4e}" for k in "xyvw") for r in log),
                  flush=True)
        print(f"hyperclean-mnist-width {engine:5s}: {steps} steps, {syncs} "
              f"syncs, launches {counts}; first round "
              f"{res.compile_seconds:.3f} s; steady {steady_ms(drv):.2f} "
              f"ms/round over {len(drv.round_seconds)} rounds; peak "
              f"{peak_gib(torch):.2f} GiB", flush=True)
        finals[engine] = res.final_avg_state
    worst = final_gap(torch, finals["scan"], finals["eager"])
    print(f"hyperclean eager vs scan final state: max normwise rel err "
          f"{worst:.3e} (limit {ENGINE_RTOL})", flush=True)
    if not worst <= ENGINE_RTOL:
        raise AssertionError("hyperclean: eager and scan disagree")
    # the Neumann step must stay under 1/L_g at this width
    states, _ = drv.init_run(0, drv.draws(q, seed=0))
    l_g = top_eig_yy(torch, task["problem"], states, drv.batches(0))
    print(f"hyperclean theta {HC_THETA}: L_g at init {l_g:.4f}, theta * L_g "
          f"{HC_THETA * l_g:.3f}", flush=True)
    if not HC_THETA * l_g <= 1.0:
        raise AssertionError(f"hyperclean theta {HC_THETA} exceeds 1/L_g")
    avg = finals["eager"]
    for name in ("true_grad_norm", "val_loss"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        value = float(task[name](avg["x"], avg["y"]))
        dt = time.time() - t0
        print(f"hyperclean {name} at the final state, full width: {value:.6e} "
              f"({dt:.3f} s, peak {peak_gib(torch):.2f} GiB)", flush=True)
        if not math.isfinite(value):
            raise AssertionError(f"hyperclean {name} {value}")
    diagnostic_check(torch)
    return launches


def diagnostic_check(torch):
    """The exact diagnostics on the card (f32) against the CPU in float64 on
    the same data and point, at HC_CHECK's reduced width."""
    from repro_torch.configs import HyperCleanConfig
    from repro_torch.tasks import build_hyperclean

    cfg = HyperCleanConfig(**HC_CHECK)
    card = build_hyperclean(cfg, device="cuda", seed=1)
    cpu = build_hyperclean(cfg, device="cpu", data={
        k: v.cpu() for k, v in card["data"].items()})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    x = 0.5 * torch.randn(cfg.n_clients, cfg.n_train_per_client,
                          generator=gen, device="cuda")
    y = {"w": 0.1 * torch.randn(cfg.feat_dim, cfg.n_classes, generator=gen,
                                device="cuda"),
         "b": 0.1 * torch.randn(cfg.n_classes, generator=gen,
                                device="cuda")}
    y64 = {k: v.cpu().double() for k, v in y.items()}
    for name in ("true_grad_norm", "val_loss"):
        got = float(card[name](x, y))
        want = float(cpu[name](x.cpu().double(), y64))
        err = abs(got - want) / abs(want)
        print(f"hyperclean {name} card f32 {got:.8e} vs CPU float64 "
              f"{want:.8e} at feat {cfg.feat_dim}, {cfg.n_train_per_client} "
              f"samples a client: rel err {err:.3e} (limit {DIAG_RTOL})",
              flush=True)
        if not err <= DIAG_RTOL:
            raise AssertionError(f"hyperclean {name}: card and float64 "
                                 f"CPU disagree")


@contextlib.contextmanager
def recording_async_rounds(record):
    """Every async round the driver runs, with the flight bookkeeping
    before and after it, appended to ``record`` as ``(round, ids, before,
    after)``."""
    from repro_torch.tasks import driver as drvmod
    real = drvmod.make_async_round
    keys = ("in_flight", "dispatch_round", "return_round")

    def make(*args, **kw):
        round_fn = real(*args, **kw)

        def recorded(state, ids, batches_q, draws_q, r, u=None):
            before = {k: state[k].clone() for k in keys}
            state, stats = round_fn(state, ids, batches_q, draws_q, r, u)
            record.append((r, ids.clone(), before,
                           {k: state[k].clone() for k in keys}))
            return state, stats
        return recorded

    drvmod.make_async_round = make
    try:
        yield
    finally:
        drvmod.make_async_round = real


def check_no_redispatch(record):
    """No client still in flight after a round's arrivals is dispatched
    again: its dispatch and return rounds stay; every other cohort client
    starts at this round. Returns the slots that found their client busy."""
    busy_slots = 0
    for r, ids, before, after in record:
        busy = before["in_flight"] & (before["return_round"] > r)
        for g in ids.tolist():
            if busy[g]:
                busy_slots += 1
                if (after["dispatch_round"][g] != before["dispatch_round"][g]
                        or after["return_round"][g]
                        != before["return_round"][g]):
                    raise AssertionError(f"async round {r}: client {g} was "
                                         f"in flight and dispatched again")
            elif not (after["in_flight"][g]
                      and int(after["dispatch_round"][g]) == r):
                raise AssertionError(f"async round {r}: idle client {g} "
                                     f"was not dispatched")
    return busy_slots


def async_path(torch, kerns):
    """Hyper-representation at MNIST width on an asynchronous population:
    32 clients, cohorts of 8, tiered delays up to 8 rounds, a staleness
    bound of 4, delay-adaptive eta, participants sync, int8 with error
    feedback, ASYNC_ROUNDS rounds; then the degenerate setting against the
    synchronous population path."""
    from repro_torch.configs import PopulationConfig
    from repro_torch.fed.sampling import UniformSampler
    from repro_torch.tasks import FedDriver, build_hyperrep

    cfg32 = mnist_width(32)
    n_msg = sum(message_segments(cfg32))
    task = build_hyperrep(cfg32, device="cuda")
    fed = dataclasses.replace(cfg32.fed, codec="int8", error_feedback=True)
    pcfg = PopulationConfig(n=32, cohort=8, sync_mode="participants",
                            staleness_decay=0.5, max_staleness=4,
                            max_delay=8, delay_model="tiers", delay_eta=0.5)
    steps = ASYNC_ROUNDS * fed.q
    drv = FedDriver(task["problem"], fed, 32, task["batch_fn"],
                    task["init_xy"], metric_fn=task["val_loss"],
                    population=pcfg, device="cuda")
    record = []
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kerns)
    with recording_async_rounds(record):
        res = drv.run(steps, seed=0, eval_every=fed.q)
    torch.cuda.synchronize()
    counts = launch_counts(kerns)
    # every round: q local steps, one server step (a round without an
    # accepted arrival discards it), one codec round trip for the cohort
    # (a launch pair a leaf)
    check_counts("async", counts, {
        "storm_update": 2 * steps, "adafbio_update": steps + ASYNC_ROUNDS,
        "quantize_stoch": MSG_LEAVES * ASYNC_ROUNDS,
        "dequantize": MSG_LEAVES * ASYNC_ROUNDS})
    log = drv.staleness_log
    tot = {k: sum(r[k] for r in log) for k in ("arrived", "accepted",
                                               "dropped", "synced",
                                               "dispatched")}
    # every arrival bills one int8 message (levels and 10 scales), every
    # synced row one full-precision state
    want_bytes = (tot["arrived"] * (n_msg + 4 * 10), tot["synced"] * 4 * n_msg)
    got_bytes = (res.bytes_up[-1], res.bytes_down[-1])
    if got_bytes != want_bytes:
        raise AssertionError(f"async: bytes {got_bytes}, want {want_bytes}")
    hist = [int(v) for v in drv.staleness_hist]
    by_tier = {t: [int(v) for v in h]
               for t, h in sorted(drv.staleness_hist_by_tier.items())}
    if sum(hist) != tot["accepted"] or sum(
            sum(h) for h in by_tier.values()) != tot["accepted"]:
        raise AssertionError(f"async: histogram {hist} / {by_tier} does not "
                             f"sum to the {tot['accepted']} accepted")
    busy = check_no_redispatch(record)
    if busy == 0:
        raise AssertionError("async: no cohort slot found its client in "
                             "flight, so the re-dispatch check saw nothing")
    if not all(math.isfinite(v) for v in res.metric):
        raise AssertionError(f"async: val loss {res.metric}")
    print(f"async-int8-tiers (N 32, C 8, tiers, max_staleness 4, max_delay "
          f"8, delay_eta 0.5, participants, int8+EF): {ASYNC_ROUNDS} rounds, "
          f"launches {counts}; arrivals {tot}; {busy} cohort slots found "
          f"their client in flight and left it; staleness histogram {hist}, "
          f"by tier {by_tier}; bytes up/down {got_bytes}; first round "
          f"{res.compile_seconds:.3f} s; steady {steady_ms(drv):.2f} ms/round "
          f"over {len(drv.round_seconds)} rounds; peak {peak_gib(torch):.2f} "
          f"GiB; val loss {[round(v, 5) for v in res.metric]}", flush=True)

    # degenerate: every delay one round, no gate, no delay adaptation
    fed01 = dataclasses.replace(cfg32.fed, theta=CHECK_THETA)
    sampler = UniformSampler(32, 8, seed=5)
    finals = {}
    for name, p in (("sync", PopulationConfig(n=32, cohort=8)),
                    ("async", PopulationConfig(n=32, cohort=8,
                                               max_staleness=math.inf))):
        d = FedDriver(task["problem"], fed01, 32, task["batch_fn"],
                      task["init_xy"], population=p, sampler=sampler,
                      device="cuda")
        finals[name] = d.run(3 * fed.q, seed=0,
                             eval_every=3 * fed.q).final_avg_state
    worst = final_gap(torch, finals["async"], finals["sync"])
    print(f"degenerate async (max_delay 1, no staleness bound, delay_eta 0) "
          f"vs sync population, theta {CHECK_THETA}, 3 rounds: max normwise "
          f"rel err {worst:.3e} (limit {ENGINE_RTOL})", flush=True)
    if not worst <= ENGINE_RTOL:
        raise AssertionError("degenerate async and sync population disagree")
    return counts


def gossip_path(torch, kerns, task, cfg):
    """Hyper-representation at MNIST width on the gossip engine: 8 nodes on
    a ring, int8 with error feedback, GOSSIP_ROUNDS rounds; then the
    complete graph without a codec against the star population engine at
    cohort 8."""
    from repro_torch.configs import PopulationConfig
    from repro_torch.kernels import ops
    from repro_torch.tasks import FedDriver

    n_msg = sum(message_segments(cfg))
    fed = dataclasses.replace(cfg.fed, codec="int8", error_feedback=True)
    pcfg = PopulationConfig(n=8, cohort=8, topology="ring")
    steps = GOSSIP_ROUNDS * fed.q
    drv = FedDriver(task["problem"], fed, 8, task["batch_fn"],
                    task["init_xy"], metric_fn=task["val_loss"],
                    engine="gossip", population=pcfg, device="cuda")
    real = ops.adafbio_update_leaves
    per_row = []

    def counting(p, w, a, lr_eta, rho):
        # a per-node accumulator leaf has its p leaf's [n, ...] shape
        per_row.append(all(ai.shape == pi.shape for pi, ai in zip(p, a)))
        return real(p, w, a, lr_eta, rho)

    torch.cuda.reset_peak_memory_stats()
    reset_launches(kerns)
    ops.adafbio_update_leaves = counting
    try:
        res = drv.run(steps, seed=0, eval_every=fed.q)
    finally:
        ops.adafbio_update_leaves = real
    torch.cuda.synchronize()
    counts = launch_counts(kerns)
    syncs = res.comms[-1]
    # every local step and every node sync: one adafbio launch over the 8
    # node rows, each with its own accumulator row
    check_counts("gossip", counts, {
        "storm_update": 2 * steps, "adafbio_update": steps + syncs,
        "quantize_stoch": MSG_LEAVES * GOSSIP_ROUNDS,
        "dequantize": MSG_LEAVES * GOSSIP_ROUNDS})
    if len(per_row) != steps + syncs or not all(per_row):
        raise AssertionError(f"gossip: {sum(per_row)} of {len(per_row)} "
                             f"adafbio launches took per-node accumulators")
    edges = drv.gossip_agg.edges(0)
    want = syncs * edges * (n_msg + 4 * 10)
    if edges != 16 or (res.bytes_up[-1], res.bytes_down[-1]) != (want, want):
        raise AssertionError(f"gossip: {edges} edges, bytes "
                             f"{res.bytes_up[-1]}/{res.bytes_down[-1]}, "
                             f"want {want} each way")
    if not all(math.isfinite(v) for v in res.metric):
        raise AssertionError(f"gossip: val loss {res.metric}")
    print(f"gossip-ring-int8 (8 nodes, ring, {edges} directed edges, "
          f"spectral gap {drv.gossip_agg.gap:.4f}, int8+EF): {GOSSIP_ROUNDS} "
          f"rounds, launches {counts} (every adafbio launch per-node); bytes "
          f"up/down {res.bytes_up[-1]}/{res.bytes_down[-1]}; first round "
          f"{res.compile_seconds:.3f} s; steady {steady_ms(drv):.2f} ms/round "
          f"over {len(drv.round_seconds)} rounds; peak {peak_gib(torch):.2f} "
          f"GiB; val loss {[round(v, 5) for v in res.metric]}", flush=True)

    fed01 = dataclasses.replace(cfg.fed, theta=CHECK_THETA)
    finals = {}
    for engine in ("gossip", "eager"):
        p = (PopulationConfig(n=8, cohort=8, topology="complete")
             if engine == "gossip" else PopulationConfig(n=8, cohort=8))
        d = FedDriver(task["problem"], fed01, 8, task["batch_fn"],
                      task["init_xy"], engine=engine, population=p,
                      device="cuda")
        finals[engine] = d.run(2 * fed.q, seed=0,
                               eval_every=2 * fed.q).final_avg_state
    worst = final_gap(torch, finals["gossip"], finals["eager"])
    print(f"gossip on the complete graph vs star population at cohort 8, "
          f"theta {CHECK_THETA}, 2 rounds: max normwise rel err {worst:.3e} "
          f"(limit {ENGINE_RTOL})", flush=True)
    if not worst <= ENGINE_RTOL:
        raise AssertionError("complete-graph gossip and star disagree")
    return counts


def named_leaves(tree, path=""):
    """``(path, leaf)`` pairs in the port's leaf order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{path}/{k}" if path else k)
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from named_leaves(t, f"{path}/{i}" if path else str(i))
    else:
        yield path, tree


def to_host(torch, tree, dtype=None):
    """Every leaf on the CPU; floating leaves cast to ``dtype`` if given."""
    from repro_torch.core.tree_util import tree_map
    return tree_map(lambda t: t.cpu().to(dtype) if dtype is not None and
                    t.is_floating_point() else t.cpu(), tree)


def top_eig_yy(torch, problem, states, batches):
    """The largest eigenvalue, over the clients, of the LL Hessian's y-y
    block on each client's LL batch, by 30 power iterations: the L_g that
    the Neumann step theta must not exceed the inverse of."""
    from torch.func import grad, jvp
    from repro_torch.core.tree_util import (tree_index, tree_map, tree_norm,
                                            tree_vdot)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    worst = 0.0
    for m in range(tree_leaves_of(states["y"])[0].shape[0]):
        x, y = tree_index(states["x"], m), tree_index(states["y"], m)
        b = tree_index(batches["g"], m)
        u = tree_map(lambda t: torch.randn(t.shape, generator=gen,
                                           device=t.device), y)
        for _ in range(30):
            u = tree_map(lambda t: t / tree_norm(u), u)
            hu = jvp(lambda yy: grad(problem.g, argnums=1)(x, yy, b),
                     (y,), (u,))[1]
            lam = tree_vdot(u, hu).item()
            u = hu
        worst = max(worst, lam)
    return worst


def tree_leaves_of(tree):
    return [leaf for _, leaf in named_leaves(tree)]


def lossless_segment(drv, states, server, batches_q, draws_q, **kw):
    """``drv.round_segment`` without a codec: the messages are the states
    themselves (``ref`` is unused), no residuals and no noise."""
    return drv.round_segment(states, server, states, None, batches_q,
                             draws_q, **kw)[:2]


def round_check(torch, task, cfg, fed):
    """One round (the sync, then q local steps) on the card and on the CPU,
    stage by stage: each stage starts both from the card's state before it,
    with the same batches and draws; the CPU goes through the kernels' plain
    versions (fused="on"), once in f32 and once in float64 (the witness).
    Prints and returns, per stage, the leaf where card and CPU differ most
    and the largest error of each f32 run against the witness; and L_g at
    the round's start and end."""
    from repro_torch.core.tree_util import tree_map
    from repro_torch.fed.round import stack_round_batches
    from repro_torch.tasks import FedDriver

    q = fed.q
    gpu = FedDriver(task["problem"], fed, cfg.n_clients, task["batch_fn"],
                    task["init_xy"], engine="scan", device="cuda")
    cpu = FedDriver(task["problem"], dataclasses.replace(fed, fused="on"),
                    cfg.n_clients, None, None, engine="scan", device="cpu")
    draws = gpu.draws(q, seed=0)
    states, server = gpu.init_run(0, draws)
    batches_q = stack_round_batches(gpu.batches, 0, q)
    l_g = [top_eig_yy(torch, task["problem"], states,
                      tree_map(lambda a: a[0], batches_q))]
    stages = []
    for j in range(q):
        args = (states, server, tree_map(lambda a: a[j:j + 1], batches_q))
        d_j = draws.steps[j:j + 1]
        kw = dict(n_steps=1, sync_first=j == 0)
        out_cpu = lossless_segment(cpu, *to_host(torch, args), d_j.cpu(),
                                   **kw)
        out_64 = lossless_segment(cpu, *to_host(torch, args, torch.float64),
                                  d_j.cpu(), **kw)
        states, server = lossless_segment(gpu, *args, d_j, **kw)
        named = [dict(zip(("state", "server"), out))
                 for out in ((states, server), out_cpu, out_64)]
        names = [n for n, _ in named_leaves(named[0])]
        card, c32, c64 = (tree_leaves_of(t) for t in named)
        card_cpu = [rel_err(torch, a, b) for a, b in zip(card, c32)]
        worst = max(range(len(names)), key=card_cpu.__getitem__)
        stage = {"worst_leaf": names[worst], "card_cpu": card_cpu[worst],
                 "card_f64": max(rel_err(torch, a, b)
                                 for a, b in zip(card, c64)),
                 "cpu_f64": max(rel_err(torch, a, b)
                                for a, b in zip(c32, c64))}
        stages.append(stage)
        print(f"round check theta={fed.theta} stage {j}: card vs CPU "
              f"{stage['card_cpu']:.2e} (worst leaf {stage['worst_leaf']}); "
              f"against the float64 witness: card {stage['card_f64']:.2e}, "
              f"CPU f32 {stage['cpu_f64']:.2e}", flush=True)
    l_g.append(top_eig_yy(torch, task["problem"], states,
                          tree_map(lambda a: a[q - 1], batches_q)))
    print(f"round check theta={fed.theta}: L_g (top eigenvalue of the LL "
          f"y-y Hessian) {l_g[0]:.4f} at the round's start, {l_g[1]:.4f} at "
          f"its end; theta * L_g up to {fed.theta * max(l_g):.3f}", flush=True)
    return stages, max(l_g)


def round_checks(torch, task, cfg):
    """The card against the CPU at CHECK_THETA (held at STAGE_RTOL) and at
    the main path's own theta (held against the witness)."""
    t0 = time.time()
    fed = dataclasses.replace(cfg.fed, theta=CHECK_THETA)
    stages, l_g = round_check(torch, task, cfg, fed)
    if not CHECK_THETA * l_g <= 1.0:
        raise AssertionError(f"theta {CHECK_THETA} exceeds 1/L_g = "
                             f"{1 / l_g:.4f}: the tight check needs "
                             f"theta <= 1/L_g")
    if not all(s["card_cpu"] <= STAGE_RTOL for s in stages):
        raise AssertionError(f"card and CPU rounds disagree at theta "
                             f"{CHECK_THETA}: {stages}")
    stages, _ = round_check(torch, task, cfg, cfg.fed)
    for s in stages:
        if not s["card_f64"] <= WITNESS_FACTOR * max(s["cpu_f64"],
                                                     WITNESS_FLOOR):
            raise AssertionError(
                f"at theta {cfg.fed.theta} the card drifts from the float64 "
                f"witness more than {WITNESS_FACTOR}x the CPU's f32 run: {s}")
    print(f"round checks passed in {time.time() - t0:.1f} s", flush=True)


def quadratic(torch):
    from repro_torch.configs import FedConfig
    from repro_torch.core.bilevel import (quadratic_bilevel_problem,
                                          quadratic_true_grad)
    from repro_torch.tasks import FedDriver

    dev = torch.device("cuda")
    d, p, m = 8, 6, 4
    g = torch.Generator()
    g.manual_seed(0)
    A = torch.randn(p, p, generator=g)
    H = (A @ A.T / p + 0.5 * torch.eye(p)).to(dev)
    Bm = (torch.randn(p, d, generator=g) * 0.3).to(dev)
    c = torch.randn(p, generator=g).to(dev)
    Q = (torch.eye(d) * 0.2).to(dev)
    fed = FedConfig(q=4, neumann_k=8, lr_x=0.3, lr_y=0.3,
                    theta=float(1.0 / torch.linalg.eigvalsh(H)[-1]))
    zero, gi = torch.zeros((), device=dev), torch.zeros(8, device=dev)
    for engine in ("eager", "scan"):
        drv = FedDriver(
            quadratic_bilevel_problem(H, Bm, c, Q), fed, n_clients=m,
            batch_fn=lambda cl, st: {"f": zero, "g": zero, "g0": zero,
                                     "gi": gi},
            init_xy=lambda gen: (torch.ones(d, device=dev) * 2.0,
                                 torch.zeros(p, device=dev)),
            grad_norm_fn=lambda x, y: torch.linalg.norm(
                quadratic_true_grad(H, Bm, c, Q, x)),
            engine=engine, device="cuda")
        res = drv.run(120, seed=0, eval_every=20)
        traj = [round(v, 4) for v in res.grad_norm]
        print(f"quadratic {engine:5s}: steps {res.steps} grad norm {traj}",
              flush=True)
        if not (all(math.isfinite(v) for v in traj) and traj[-1] < traj[0]):
            raise AssertionError(f"quadratic {engine} did not descend")


def attention_pairs(sq, sk, causal, window):
    """The (query, key) pairs the mask lets through, positions from 0 (all
    Sq x Sk of them where nothing is masked)."""
    total = 0
    for qp in range(sq):
        hi = min(qp + 1, sk) if causal else sk
        lo = max(0, qp - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def attn_error(torch, got, want, dtype):
    """(largest |got - want|, the worst element's error over its limit
    tol * (1 + |want|)), tol from ATTN_TOL by ``dtype``; fails above 1."""
    torch.cuda.synchronize()
    tol = ATTN_TOL[str(dtype).removeprefix("torch.")]
    diff = (got.float() - want.float()).abs()
    worst = (diff / (tol * (1 + want.float().abs()))).max().item()
    return diff.max().item(), worst


def flash_inputs(torch, gen, b, h, kv, sq, sk, d, dtype):
    """q [B, H, Sq, D], k and v [B, KV, Sk, D]: views of the prefill's
    [B, S, heads, D] layout, drawn from ``gen`` on the card."""
    def make(heads, s):
        return torch.randn(b, s, heads, d, generator=gen, device="cuda",
                           dtype=dtype).transpose(1, 2)
    return make(h, sq), make(kv, sk), make(kv, sk)


def scan_inputs(torch, gen, b, s, di, n, dtype):
    """x, dt, A, B, C as ``mamba1_seq`` makes them (dt a softplus, A =
    -(1..N) per channel as A_log's init gives it, B and C column views of
    the [B, S, dt_rank + 2N] projection), drawn from ``gen`` on the
    card."""
    import torch.nn.functional as F

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    x = rand(b, s, di).to(dtype)
    dt = F.softplus(rand(b, s, di)).to(dtype)
    A = -torch.arange(1, n + 1, dtype=torch.float32, device="cuda").expand(
        di, n).contiguous()
    proj = rand(b, s, SCAN_DT_RANK + 2 * n).to(dtype)
    return (x, dt, A, proj[..., SCAN_DT_RANK:SCAN_DT_RANK + n],
            proj[..., SCAN_DT_RANK + n:])


def flash_phase(torch, fkern, ref):
    """flash_attention against its plain version at every listed shape, in
    the prefill's [B, S, H, D] layout viewed as [B, H, S, D]; returns the
    numbers of the full-width prefill shape."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    results = {}
    for label, b, h, kv, sq, sk, d, dtype, window, causal in FLASH_CASES:
        dtype = getattr(torch, dtype)
        q, k, v = flash_inputs(torch, gen, b, h, kv, sq, sk, d, dtype)
        fast = lambda: fkern.flash_attention(q, k, v, causal=causal,  # noqa
                                             window=window)
        plain = lambda: ref.flash_attention_ref(  # noqa: E731
            q, k, v, causal=causal, window=window)
        if window is None:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=causal, enable_gqa=True)
        else:
            pos = torch.arange(sq, device=dev)
            mask = ((pos[None, :] <= pos[:, None])
                    & (pos[None, :] > pos[:, None] - window))
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=mask, enable_gqa=True)
        err, worst = attn_error(torch, fast(), plain(), dtype)
        flops = 4 * b * h * d * attention_pairs(sq, sk, causal, window)
        nbytes = (2 * b * sq * h * d + 2 * b * sk * kv * d) * q.element_size()
        peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        bound = max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3
        row = {"max_abs_err": err, "worst": worst, "ms": time_ms(torch, fast),
               "plain_ms": time_ms(torch, plain),
               "library_ms": time_ms(torch, lib), "bound_ms": bound,
               "bound_by": ("operations" if flops / peak
                            >= nbytes / HBM_BYTES_PER_S else "bytes"),
               "flops": flops, "bytes": nbytes}
        if label == "main":
            results["flash_attention"] = row
        print(f"kernel flash_attention {label:10s} B {b} H {h} KV {kv} Sq "
              f"{sq} Sk {sk} D {d} {str(dtype)[6:]} window {window} "
              f"{'causal' if causal else 'not causal'} ("
              f"{fkern.source_for(dtype)}): max_abs_err {err:.3e}, worst "
              f"element at {worst:.3f} of its limit; kernel {row['ms']:.4f} "
              f"ms ("
              + (f"before the redesign: "
                 f"{BEFORE_MS[('flash_attention', label)]} ms"
                 if ('flash_attention', label) in BEFORE_MS else
                 "a layout added after the redesign, not timed before it")
              + "), plain "
              f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, "
              f"bound {bound:.4f} ms ({row['bound_by']}: {flops:.4g} FLOP, "
              f"{nbytes} bytes)" + ("" if worst <= 1 else "  FAILED"),
              flush=True)
        if not worst <= 1:
            raise AssertionError(f"flash_attention disagrees with its plain "
                                 f"version at {label}")
    return results


def qd_pool(torch, qd, gen, b, kv, w, d):
    """One layer's int8 pool slice, [B, W, KV, Dh] quantized from bf16
    draws, as the kernel reads it: (k8, k_scale, v8, v_scale) viewed as
    [B, KV, W, Dh] and [B, KV, W]."""
    pool = []
    for _ in range(2):
        x = torch.randn(b, w, kv, d, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        lv, sc = qd.quantize_kv(x)
        pool += [lv.transpose(1, 2), sc.transpose(1, 2)]
    return tuple(pool)


def qd_positions(torch, pos):
    return (torch.tensor(pos, dtype=torch.int32, device="cuda")
            if isinstance(pos, tuple) else pos)


def qd_cold(torch, qd, gen, q, pos, b, kv, w, d):
    """A call of the decode kernel that finds its pool outside L2, as each
    of the serve tick's layers does: every call takes the next of n
    distinct pools of the case's size, n >= 3 and above COLD_BYTES in
    all. Returns (call, n, bytes of the pools)."""
    per = b * w * kv * (d + 4) * 2
    n = max(3, COLD_BYTES // per + 1)
    pools = [qd_pool(torch, qd, gen, b, kv, w, d) for _ in range(n)]
    turn = [0]

    def call():
        turn[0] = (turn[0] + 1) % n
        return qd.quant_decode_attention(q, *pools[turn[0]], pos)
    return call, n, n * per


def quant_decode_phase(torch, qd, ref):
    """quant_decode_attention against its plain version on one layer's
    slice of the serve pool ([B, W, KV, Dh] viewed as [B, KV, W, Dh]) at
    QD_CASES, timed warm (``ms``: the same pool every call) and cold
    (``cold_ms``: qd_cold), then captured in a CUDA graph (qd_graph_check);
    returns the numbers of the main shape."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results = {}
    for label, b, h, kv, w, pos, d in ([c + (128,) for c in QD_CASES]
                                       + QD_LAYOUTS):
        q = torch.randn(b, h, d, generator=gen, device=dev,
                        dtype=torch.bfloat16)
        args = (q,) + qd_pool(torch, qd, gen, b, kv, w, d)
        p = qd_positions(torch, pos)
        fast = lambda: qd.quant_decode_attention(*args, p)  # noqa: E731
        plain = lambda: ref.quant_decode_ref(*args, p)  # noqa: E731
        err, worst = attn_error(torch, fast(), plain(), q.dtype)
        cold, n_pools, cold_bytes = qd_cold(torch, qd, gen, q, p, b, kv, w,
                                            d)
        rows = pos if isinstance(pos, tuple) else (pos,) * b
        slots = sum(min(r, w) if r > 0 else w for r in rows)
        # levels (1 byte) and scales (4 bytes) of K and V at each valid slot
        # and kv head, q and the output (bf16), the positions
        nbytes = (slots * kv * 2 * (d + 4) + 2 * b * h * d * 2
                  + 4 * len(rows))
        flops = 4 * slots * h * d
        bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
        row = {"max_abs_err": err, "worst": worst, "ms": time_ms(torch, fast),
               "cold_ms": time_ms(torch, cold),
               "plain_ms": time_ms(torch, plain), "bound_ms": bound,
               "bound_by": "bytes", "bytes": nbytes}
        del cold
        if label == "main":
            results["quant_decode_attention"] = row
        passes, gc = qd.head_passes(h // kv, q.dtype)
        blocks = qd.grid_blocks(b, kv, w, passes, sms, q.dtype)
        tiles = kv * sum(qd.row_tiles(rows, w))
        print(f"kernel quant_decode_attention {label:9s} B {b} H {h} KV {kv} "
              f"W {w} Dh {d} pos {pos} ({tiles} tiles over {blocks} blocks "
              f"x {passes} passes of {gc} heads): max_abs_err {err:.3e}, "
              f"worst element at {worst:.3f} of its limit; kernel warm "
              f"{row['ms']:.4f} ms, cold {row['cold_ms']:.4f} ms ({n_pools} "
              f"pools, {cold_bytes / 1e6:.1f} MB) ("
              + (f"before the redesign: warm "
                 f"{BEFORE_MS[('quant_decode_attention', label)]}, cold "
                 f"{BEFORE_COLD_MS[label]} ms"
                 if label in BEFORE_COLD_MS else
                 "a layout added after the redesign, not timed before it")
              + f"), plain {row['plain_ms']:.4f} ms, "
              f"library none (no single PyTorch call dequantizes and "
              f"attends), bound {bound:.4f} ms (bytes: {nbytes}; cold at "
              f"{bound / row['cold_ms']:.3f} of it)"
              + ("" if worst <= 1 else "  FAILED"), flush=True)
        if not worst <= 1:
            raise AssertionError(f"quant_decode_attention disagrees with its "
                                 f"plain version at {label}")
    qd_graph_check(torch, qd, ref, gen)
    return results


def qd_graph_check(torch, qd, ref, gen):
    """The main case's call captured in a CUDA graph with q and pos in
    static tensors: after each change of both, a replay must equal an
    eager call bit for bit (the kernel's merge counters come back to zero
    and nothing reads pos on the host) and the plain version within
    ATTN_TOL."""
    dev = torch.device("cuda")
    _, b, h, kv, w, _ = QD_CASES[0]
    pool = qd_pool(torch, qd, gen, b, kv, w, 128)
    draws = [(1, 2048, 1000, 1536, 37, 2047, 512, 1300), (2048,) + (1,) * 7,
             (0,) * 8, (64, 65, 63, 3000, 128, 1, 2, 777)]
    qs = [torch.randn(b, h, 128, generator=gen, device=dev,
                      dtype=torch.bfloat16) for _ in draws]
    q_in, p_in = qs[0].clone(), qd_positions(torch, draws[0])
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        qd.quant_decode_attention(q_in, *pool, p_in)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qd.quant_decode_attention(q_in, *pool, p_in)
    for q, pos in zip(qs, draws):
        q_in.copy_(q)
        p_in.copy_(qd_positions(torch, pos))
        graph.replay()
        eager = qd.quant_decode_attention(q, *pool, p_in)
        _, worst = attn_error(torch, eager, ref.quant_decode_ref(
            q, *pool, p_in), q.dtype)
        same = torch.equal(out, eager)
        print(f"quant_decode_attention graph replay pos {pos}: "
              f"{'equal to' if same else 'DIFFERS from'} the eager call, "
              f"worst element at {worst:.3f} of its limit", flush=True)
        if not (same and worst <= 1):
            raise AssertionError("quant_decode_attention's graph replay "
                                 "disagrees with the eager call")
    del graph


def percentile(values, q):
    vals = sorted(values)
    return vals[min(int(q * len(vals)), len(vals) - 1)]


def serve_path(torch, kerns, arch, load, kv_quant, expect, layers=None):
    """``arch`` at full width (bf16 params from a seeded generator; its
    depth cut to ``layers`` where given) through ``Engine(slots=8,
    max_len=2048, kv_quant=kv_quant)``, replaying ``load`` (each request
    with its prefix embeddings, or its 2048 frames of encoder embeddings,
    from the load generator where the arch takes them). ``expect(cfg, admissions, ticks)`` gives the launch count
    of each kernel the path runs; every other kernel must stay at 0.
    Returns (launch counts, cfg, params, requests)."""
    from repro_torch import device as devlib
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params, model_specs, param_count
    from repro_torch.serve import (Engine, LoadSpec, generate_requests,
                                   replay)

    cfg = get_arch(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    t0 = time.time()
    params = init_params(model_specs(cfg), devlib.generator("cuda", 0),
                         cfg.dtype)
    torch.cuda.synchronize()
    n_params = param_count(model_specs(cfg))
    print(f"serve path: {arch} ({cfg.family}) at full width "
          f"({cfg.n_layers} of {get_arch(arch).n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} "
          f"heads over {cfg.n_kv_heads}, {n_params} params, {cfg.dtype}) "
          f"drawn in {time.time() - t0:.1f} s; device memory allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    pre = ((cfg.n_prefix_embeds, cfg.d_model) if cfg.n_prefix_embeds
           else None)
    enc = ((SERVE_MAX_LEN, cfg.d_model) if cfg.family == "encdec"
           else None)
    reqs = generate_requests(LoadSpec(**load), cfg.vocab, enc_shape=enc,
                             prefix_shape=pre)
    eng = Engine(cfg, params, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                 kv_quant=kv_quant)
    # every prefill's and tick's logits finite: one flag a call, on the
    # card, read once after the drain
    finite = []
    for key in ("_prefill", "_decode"):
        def checked(*a, _real=getattr(eng, key)):
            logits, cache = _real(*a)
            finite.append(torch.isfinite(logits).all())
            return logits, cache
        setattr(eng, key, checked)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kerns)
    t0 = time.perf_counter()
    done = replay(eng, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(kerns)
    if not bool(torch.stack(finite).all()):
        raise AssertionError(f"serve {arch}: logits not finite")
    ticks = len(eng.timings["decode"])
    want = {name: 0 for name in counts}
    want.update(expect(cfg, len(reqs), ticks))
    if counts != want:
        raise AssertionError(f"serve {arch}: launches {counts}, want {want}")
    if sorted(c.rid for c in done) != [r.rid for r in reqs]:
        raise AssertionError(f"serve {arch}: not every request completed "
                             f"once")
    for c, r in zip(sorted(done, key=lambda c: c.rid), reqs):
        if not (1 <= len(c.tokens) <= r.max_new_tokens and all(
                0 <= t < cfg.vocab for t in c.tokens)
                and c.finish_reason in ("length", "capacity")):
            raise AssertionError(f"serve {arch}: request {c.rid} gave {c}")
    toks = sum(len(c.tokens) for c in done)
    lats = [c.latency_s for c in done]
    by_len = {}
    for r, t in list(zip(reqs, eng.timings["prefill"]))[1:]:
        by_len.setdefault(len(r.tokens), []).append(1e3 * t)
    prefill_ms = {n: statistics.median(v) for n, v in sorted(by_len.items())}
    tick_ms = [1e3 * t for t in eng.timings["decode"][1:]]
    print(f"serve path {arch}: {len(done)} requests, {toks} tokens in "
          f"{wall:.2f} s: {len(done) / wall:.3f} req/s, {toks / wall:.2f} "
          f"tok/s, latency p50 {percentile(lats, 0.5):.3f} s p99 "
          f"{percentile(lats, 0.99):.3f} s; {ticks} decode ticks; launches "
          f"{counts}; steady prefill ms (median by prompt length, first "
          f"admission excluded) "
          f"{ {n: round(v, 2) for n, v in prefill_ms.items()} }; steady "
          f"decode tick {statistics.median(tick_ms):.2f} ms median, "
          f"{statistics.mean(tick_ms):.2f} ms mean (first tick "
          f"{1e3 * eng.timings['decode'][0]:.2f} ms, first admission "
          f"{1e3 * eng.timings['prefill'][0]:.2f} ms); every logit finite; "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return counts, cfg, params, reqs


def serve_logits(torch, cfg, params, pair, paths):
    """Each path's logits for the two requests of ``pair``: the prefill
    (one row each), then 8 decode ticks of both rows, every path fed the
    first path's greedy tokens. The first path's prefill rows fill the int8
    pool (and an encdec model's dense cross cache), and every path starts
    each tick from the first path's pool, so
    the paths differ only in their attention (each still quantizes its
    new token's K/V from its own activations). ``paths``: name ->
    ``ModelCtx.attn``; the path named "control" also has each row's first
    key and value (slot 0, every layer) zeroed before each tick: a fault of
    one key in every layer. Returns name -> [prefill logits of each
    request, then each tick's logits]."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.fed.serve import serve_cache
    from repro_torch.kernels.quant_decode import quantize_kv
    from repro_torch.models.decode import decode_step, prefill, zeros
    from repro_torch.models.model import ModelCtx

    dev = torch.device("cuda")
    row_abs = serve_cache(cfg, ShapeConfig("check_prefill", SERVE_MAX_LEN,
                                           1, "prefill"))[0]
    pool_abs = serve_cache(cfg, ShapeConfig("check_decode", SERVE_MAX_LEN, 2,
                                            "decode"), kv_quant=True)[0]
    pools = {name: zeros(pool_abs, dev) for name in paths}
    out = {name: [] for name in paths}
    lead = next(iter(paths))
    for i, r in enumerate(pair):
        batch = {"tokens": torch.from_numpy(r.tokens[None]).to(dev)}
        if cfg.n_prefix_embeds:
            batch["prefix_embeds"] = torch.from_numpy(
                r.prefix_embeds[None]).to(dev, getattr(torch, cfg.dtype))
        if cfg.family == "encdec":
            batch["enc_embeds"] = torch.from_numpy(
                r.enc_embeds[None]).to(dev, getattr(torch, cfg.dtype))
        for name, attn in paths.items():
            logits, row = prefill(cfg, params, batch,
                                  zeros(row_abs, dev),
                                  ModelCtx(kind="prefill", attn=attn))
            out[name].append(logits)
            if name == lead:
                for key in ("k", "v"):
                    levels, scale = quantize_kv(row[key][:, 0])
                    pools[name][key][:, i] = levels
                    pools[name][key + "_scale"][:, i] = scale
                for key in ("ck", "cv"):
                    if key in row:        # the encdec cross cache, dense
                        pools[name][key][:, i] = row[key][:, 0]
    token = torch.cat([lg[:, 0].argmax(-1) for lg in out[lead]]).to(
        torch.int32)[:, None]
    pos = torch.tensor([len(r.tokens) for r in pair], dtype=torch.int32,
                       device=dev)
    for _ in range(8):
        for name in paths:
            if name != lead:
                for key, buf in pools[name].items():
                    buf.copy_(pools[lead][key])
        if "control" in pools:
            for key in ("k", "v"):
                pools["control"][key][:, :, 0] = 0
        for name, attn in paths.items():
            out[name].append(decode_step(
                cfg, params, pools[name], token, pos,
                ModelCtx(kind="decode", attn=attn))[0])
        token = out[lead][-1][:, 0].argmax(-1).to(torch.int32)[:, None]
        pos = pos + 1
    return out


def serve_check(torch, cfg, params, reqs):
    """The served model through the kernels against their plain versions
    (``ModelCtx(attn="plain")``), same weights: two requests' prefill
    logits, then 8 decode ticks fed the kernel path's tokens, every path
    starting each tick from the kernel path's int8 pool.

    In bf16 the two paths round differently wherever an attention output
    lands near a bf16 rounding boundary, and from there on every later bf16
    rounding of the 48 layers can differ: the paths part by the model's
    bf16 rounding noise, which no bf16 implementation avoids. The
    reference's own path (``attn="reference"``: probabilities rounded to
    bf16, the cache dequantized to bf16) is the witness of that noise: the
    kernel path is held to be no farther from the plain one than
    SERVE_WITNESS times the reference path is, at every row. The moe
    family's rows are held by their median: its router picks experts
    discretely, so where one path's bf16 rounding moves a token across a
    routing boundary that row parts by a whole expert's output (3-5e-2
    normwise at qwen3-moe-30b-a3b, against 5e-3 of rounding), and each
    path crosses at other rows (on the H100 the kernel path at one tick,
    the reference path at two others). Then the same weights
    widened to f32 (exactly) run both paths again, where rounding noise is
    2^16 times smaller, and the kernel path is held within SERVE_F32_RTOL of
    the plain one, a limit that the control (the plain path with one key
    of each row zeroed in every layer, see serve_logits) must exceed.
    Widening turns ``params`` into f32 in place, leaf by leaf (59 GB)."""
    pair = [reqs[0], next(r for r in reqs if len(r.tokens)
                          != len(reqs[0].tokens))]
    names = ["prefill " + str(len(r.tokens)) for r in pair] + [
        f"tick {t}" for t in range(8)]
    runs = serve_logits(torch, cfg, params, pair, {
        "kernel": "kernel", "plain": "plain", "reference": "reference"})
    rows = []
    for n, k, p, x in zip(names, runs["kernel"], runs["plain"],
                          runs["reference"]):
        agree = int((k[:, -1].argmax(-1) == p[:, -1].argmax(-1)).sum())
        rows.append((n, rel_err(torch, k, p), rel_err(torch, x, p), agree,
                     k.shape[0]))
    for n, kp, xp, agree, of in rows:
        print(f"serve check bf16 {n:12s}: kernel vs plain {kp:.3e}, "
              f"reference path vs plain {xp:.3e} (normwise rel err); greedy "
              f"tokens kernel vs plain agree {agree} of {of}", flush=True)
    ratios = [kp / max(xp, 1e-30) for _, kp, xp, _, _ in rows]
    held, rule = ((statistics.median(ratios), "the median row")
                  if cfg.family == "moe" else (max(ratios), "every row"))
    print(f"serve check bf16: kernel path at most {max(ratios):.3f}x (median "
          f"{statistics.median(ratios):.3f}x) the reference path's distance "
          f"from the plain one (limit {SERVE_WITNESS}, held at {rule}); "
          f"greedy tokens agree in {sum(r[3] for r in rows)} of "
          f"{sum(r[4] for r in rows)}", flush=True)
    if not held <= SERVE_WITNESS:
        raise AssertionError(f"serve check: the kernel path is {held:.3f}x "
                             f"farther from the plain path than the "
                             f"reference path ({rule})")
    del runs
    f32 = widen_to_f32(torch, cfg, params)
    runs = serve_logits(torch, f32, params, pair, {
        "kernel": "kernel", "plain": "plain", "control": "plain"})
    errs = [rel_err(torch, k, p) for k, p in zip(runs["kernel"],
                                                 runs["plain"])]
    control = [rel_err(torch, c, p) for c, p in zip(runs["control"][2:],
                                                    runs["plain"][2:])]
    agree = sum(int((k[:, -1].argmax(-1) == p[:, -1].argmax(-1)).sum())
                for k, p in zip(runs["kernel"], runs["plain"]))
    print(f"serve check f32 (the same weights widened): kernel vs plain "
          f"normwise rel err {dict(zip(names, (f'{e:.3e}' for e in errs)))}"
          f" (limit {SERVE_F32_RTOL}); control (one key zeroed in every "
          f"layer) vs plain over the ticks "
          f"{[f'{e:.3e}' for e in control]}; greedy tokens agree in {agree} "
          f"of {2 * len(errs) - 2}", flush=True)
    if not max(errs) <= SERVE_F32_RTOL:
        raise AssertionError(f"serve check f32: kernel and plain paths part "
                             f"by {max(errs):.3e}")
    if not min(control) > SERVE_F32_RTOL:
        raise AssertionError(f"serve check f32: the control parts from the "
                             f"plain path by only {min(control):.3e}, so the "
                             f"limit {SERVE_F32_RTOL} could not see a "
                             f"corrupted key")


def widen_to_f32(torch, cfg, params):
    """Widen ``params`` to f32 in place, leaf by leaf (exact), and return
    the f32 config."""
    def widen(tree):
        for key in sorted(tree):
            if isinstance(tree[key], dict):
                widen(tree[key])
            else:
                tree[key] = tree[key].float()
    widen(params)
    free_device_memory(torch)
    return dataclasses.replace(cfg, dtype="float32")


def sm_clock_hz():
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def mamba_scan_phase(torch, mk, ref):
    """mamba_scan against its plain version, y and h_last element by
    element, with the inputs as ``mamba1_seq`` makes them (scan_inputs);
    returns the numbers of the full-width prefill shape."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    sfu_per_s = (SFU_PER_CLOCK * sm_clock_hz()
                 * torch.cuda.get_device_properties(dev).multi_processor_count)
    results = {}
    for label, b, s, di, n, dtype in SCAN_CASES:
        dtype = getattr(torch, dtype)
        args = scan_inputs(torch, gen, b, s, di, n, dtype)
        x = args[0]
        fast = lambda: mk.mamba_scan(*args)  # noqa: E731
        plain = lambda: ref.mamba_scan_ref(*args)  # noqa: E731
        (y, h), (y_ref, h_ref) = fast(), plain()
        torch.cuda.synchronize()
        tol = SCAN_TOL[str(dtype).removeprefix("torch.")]
        errs, worst = [], 0.0
        for got, want in ((y, y_ref), (h, h_ref)):
            diff = (got.float() - want.float()).abs()
            errs.append(diff.max().item())
            worst = max(worst, (diff / (tol * (1 + want.float().abs())))
                        .max().item())
        # each input read once, y and h_last written once; per (b, t, d, n)
        # one exponential and about 6 f32 operations (dt*A, the state's
        # FMA, (dt*x)*B, the FMA of y)
        size = x.element_size()
        nbytes = (3 * b * s * di * size + 2 * b * s * n * size
                  + 4 * di * n + 4 * b * di * n)
        exps = b * s * di * n
        t_bytes, t_exp = nbytes / HBM_BYTES_PER_S, exps / sfu_per_s
        t_flops = 6 * exps / F32_FLOPS
        bound = max(t_bytes, t_exp, t_flops) * 1e3
        row = {"max_abs_err": max(errs), "worst": worst,
               "bound_ms": bound, "library_ms": None,
               "bound_by": "bytes" if t_bytes >= max(t_exp, t_flops)
               else "operations", "bytes": nbytes, "exps": exps}
        timed = label in SCAN_TIMED
        if timed:
            row.update(ms=time_ms(torch, fast), plain_ms=time_ms(
                torch, plain))
        if label == "main":
            results["mamba_scan"] = row
        print(f"kernel mamba_scan {label:9s} B {b} S {s} Di {di} N {n} "
              f"{str(dtype)[6:]}: max_abs_err y {errs[0]:.3e} h_last "
              f"{errs[1]:.3e}, worst element at {worst:.3f} of its limit "
              f"(tol {tol})"
              + (f"; kernel {row['ms']:.4f} ms (before the redesign: "
                 f"{BEFORE_MS[('mamba_scan', label)]} ms), plain "
                 f"{row['plain_ms']:.4f} ms, library none (no single "
                 f"PyTorch call runs the selective scan), bound "
                 f"{bound:.4f} ms ({row['bound_by']}: {nbytes} bytes "
                 f"{t_bytes * 1e3:.4f} ms, {exps} exponentials "
                 f"{t_exp * 1e3:.4f} ms, f32 operations "
                 f"{t_flops * 1e3:.4f} ms)" if timed else "")
              + ("" if worst <= 1 else "  FAILED"), flush=True)
        if not worst <= 1:
            raise AssertionError(f"mamba_scan disagrees with its plain "
                                 f"version at {label}")
    return results


@contextlib.contextmanager
def faulty(ref, name, fault):
    """While the block runs, the plain version ``ref.<name>`` is replaced
    by ``fault(plain)``: the controls of ssm_check and hybrid_check."""
    plain = getattr(ref, name)
    setattr(ref, name, fault(plain))
    try:
        yield
    finally:
        setattr(ref, name, plain)


def state_zeroed(plain):
    """The plain scan with a one-step fault: in every layer the state is
    zeroed before the prompt's last 64 steps (the last tile the kernel
    stages), as a scan that lost its carry there would."""
    import torch

    def control(x, dt, A, Bm, Cm, h0=None):
        k = x.shape[1] - 64
        y0, _ = plain(x[:, :k], dt[:, :k], A, Bm[:, :k], Cm[:, :k])
        y1, h = plain(x[:, k:], dt[:, k:], A, Bm[:, k:], Cm[:, k:])
        return torch.cat([y0, y1], dim=1), h
    return control


def first_key_zeroed(plain):
    """The plain attention with the first key and value of every row
    zeroed, in each call: a fault of one key."""
    def control(q, k, v, **kw):
        k, v = k.clone(), v.clone()
        k[:, :, 0] = 0
        v[:, :, 0] = 0
        return plain(q, k, v, **kw)
    return control


def ssm_logits(torch, ref, cfg, params, pair, paths):
    """Each path's logits for the two requests of ``pair``: the prefill
    (one row each, its state and conv tail into the path's own 2-row
    pool), then 8 decode ticks of both rows from that pool, every path fed
    the first path's greedy tokens. The paths differ only in the prefill's
    scan; each tick carries the state its own prefill left. ``paths``: name
    -> ``ModelCtx.attn``; the path named "control" prefills under
    ``state_zeroed``. Returns name -> [prefill logits of each request, then
    each tick's logits]."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.fed.serve import serve_cache
    from repro_torch.models.decode import decode_step, prefill, zeros
    from repro_torch.models.model import ModelCtx

    dev = torch.device("cuda")
    row_abs = serve_cache(cfg, ShapeConfig("check_prefill", SERVE_MAX_LEN,
                                           1, "prefill"))[0]
    pool_abs = serve_cache(cfg, ShapeConfig("check_decode", SERVE_MAX_LEN, 2,
                                            "decode"))[0]
    pools = {name: zeros(pool_abs, dev) for name in paths}
    out = {name: [] for name in paths}
    lead = next(iter(paths))
    for i, r in enumerate(pair):
        tokens = torch.from_numpy(r.tokens[None]).to(dev)
        for name, attn in paths.items():
            with (faulty(ref, "mamba_scan_ref", state_zeroed)
                  if name == "control" else contextlib.nullcontext()):
                logits, row = prefill(cfg, params, {"tokens": tokens},
                                      zeros(row_abs, dev),
                                      ModelCtx(kind="prefill", attn=attn))
            out[name].append(logits)
            for key, buf in pools[name].items():
                buf[:, i] = row[key][:, 0]
    token = torch.cat([lg[:, 0].argmax(-1) for lg in out[lead]]).to(
        torch.int32)[:, None]
    pos = torch.tensor([len(r.tokens) for r in pair], dtype=torch.int32,
                       device=dev)
    for _ in range(8):
        for name in paths:
            out[name].append(decode_step(
                cfg, params, pools[name], token, pos,
                ModelCtx(kind="decode"))[0])
        token = out[lead][-1][:, 0].argmax(-1).to(torch.int32)[:, None]
        pos = pos + 1
    return out


def ssm_check(torch, ref, cfg, params, reqs):
    """falcon-mamba-7b through the mamba_scan kernel against its plain
    version (``ModelCtx(attn="plain")``), same weights: two requests'
    prefill logits, then 8 decode ticks fed the kernel path's tokens, each
    path from the state its own prefill left.

    In bf16, as serve_check: the reference's chunked scan is the witness of
    the model's bf16 noise, and the kernel path is held to be no farther
    from the plain one than SERVE_WITNESS times the reference path is.
    Then the weights widened to f32 (in place, 29 GB). The prefill logits,
    where the kernel runs, are held within SSM_F32_RTOL of the plain path's,
    a limit that the control (the plain path with each layer's state zeroed
    64 steps before the end of the prompt) must exceed. The random model
    amplifies any difference in its state from tick to tick, rounding
    included (8 ticks take the distance from 1e-5 to 3e-3), so the ticks
    are held against a witness: the kernel path within SSM_TICK_WITNESS
    times the f32 reference path's distance at every tick, a bound that the
    control must exceed over the first SSM_CONTROL_TICKS ticks, before the
    amplified rounding of every path closes on it."""
    pair = [reqs[0], next(r for r in reqs if len(r.tokens)
                          != len(reqs[0].tokens))]
    names = ["prefill " + str(len(r.tokens)) for r in pair] + [
        f"tick {t}" for t in range(8)]
    runs = ssm_logits(torch, ref, cfg, params, pair, {
        "kernel": "kernel", "plain": "plain", "reference": "reference"})
    rows = [(n, rel_err(torch, k, p), rel_err(torch, x, p))
            for n, k, p, x in zip(names, runs["kernel"], runs["plain"],
                                  runs["reference"])]
    for n, kp, xp in rows:
        print(f"ssm check bf16 {n:12s}: kernel vs plain {kp:.3e}, reference "
              f"path vs plain {xp:.3e} (normwise rel err)", flush=True)
    worst = max(kp / max(xp, 1e-30) for _, kp, xp in rows)
    print(f"ssm check bf16: kernel path at most {worst:.3f}x the reference "
          f"path's distance from the plain one (limit {SERVE_WITNESS})",
          flush=True)
    if not worst <= SERVE_WITNESS:
        raise AssertionError(f"ssm check: the kernel path is {worst:.3f}x "
                             f"farther from the plain path than the "
                             f"reference path")
    del runs
    f32 = widen_to_f32(torch, cfg, params)
    runs = ssm_logits(torch, ref, f32, params, pair, {
        "kernel": "kernel", "plain": "plain", "reference": "reference",
        "control": "plain"})
    err = {name: [rel_err(torch, g, p) for g, p in zip(runs[name],
                                                       runs["plain"])]
           for name in runs if name != "plain"}
    for i, n in enumerate(names):
        print(f"ssm check f32 {n:12s}: vs plain (normwise rel err) "
              + ", ".join(f"{name} {e[i]:.3e}" for name, e in err.items()),
              flush=True)
    witness = [SSM_TICK_WITNESS * max(e, 1e-30)
               for e in err["reference"][2:]]
    kernel_ratio = max(k / w for k, w in zip(err["kernel"][2:], witness))
    control_ratio = min(c / w for c, w in zip(
        err["control"][2:2 + SSM_CONTROL_TICKS], witness))
    print(f"ssm check f32: prefill kernel vs plain at most "
          f"{max(err['kernel'][:2]):.3e}, control at least "
          f"{min(err['control'][:2]):.3e} (limit {SSM_F32_RTOL}); ticks "
          f"kernel at most {kernel_ratio:.3f} of {SSM_TICK_WITNESS}x the "
          f"reference path's distance, control at least {control_ratio:.3f} "
          f"of it over the first {SSM_CONTROL_TICKS} ticks", flush=True)
    if not max(err["kernel"][:2]) <= SSM_F32_RTOL:
        raise AssertionError(f"ssm check f32: kernel and plain prefill "
                             f"logits part by {max(err['kernel'][:2]):.3e}")
    if not min(err["control"][:2]) > SSM_F32_RTOL:
        raise AssertionError(f"ssm check f32: the control parts from the "
                             f"plain prefill by only "
                             f"{min(err['control'][:2]):.3e}, so the limit "
                             f"{SSM_F32_RTOL} could not see a one-step scan "
                             f"fault")
    if not kernel_ratio <= 1:
        raise AssertionError(f"ssm check f32: over the ticks the kernel path "
                             f"is {kernel_ratio * SSM_TICK_WITNESS:.3f}x "
                             f"farther "
                             f"from the plain path than the reference path")
    if not control_ratio > 1:
        raise AssertionError("ssm check f32: the control stays within the "
                             "ticks' witness bound")


def hybrid_check(torch, ref, cfg, params, reqs):
    """zamba2-1.2b's prefill logits with the weights widened to f32 (in
    place), for one prompt of each length in ``reqs``: the kernel path (the
    shared block on flash_attention) against the plain path
    (``flash_attention_ref``), held within HYBRID_F32_RTOL, a limit that the
    control (the plain path with the first key and value of every row
    zeroed in each shared-block call) must exceed. The reference path is a
    witness, held to the same limit, for the prompts it takes (at most
    ``attn_chunk`` tokens: past it the reference's chunked attention needs
    a multiple of the chunk)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.fed.serve import serve_cache
    from repro_torch.models.decode import prefill, zeros
    from repro_torch.models.model import ModelCtx

    dev = torch.device("cuda")
    f32 = widen_to_f32(torch, cfg, params)
    row_abs = serve_cache(f32, ShapeConfig("check_prefill", SERVE_MAX_LEN,
                                           1, "prefill"))[0]
    prompts = {len(r.tokens): r for r in reversed(reqs)}
    errs = {}
    for n, r in sorted(prompts.items()):
        tokens = torch.from_numpy(r.tokens[None]).to(dev)

        def logits(attn):
            return prefill(f32, params, {"tokens": tokens},
                           zeros(row_abs, dev),
                           ModelCtx(kind="prefill", attn=attn))[0]
        plain, kernel = logits("plain"), logits("kernel")
        row = {"kernel": rel_err(torch, kernel, plain)}
        with faulty(ref, "flash_attention_ref", first_key_zeroed):
            row["control"] = rel_err(torch, logits("plain"), plain)
        if n <= ModelCtx().attn_chunk:
            row["reference"] = rel_err(torch, kernel, logits("reference"))
        errs[n] = row
        print(f"hybrid check f32 prefill {n}: normwise rel err kernel vs "
              f"plain {row['kernel']:.3e}, control vs plain "
              f"{row['control']:.3e}"
              + (f", kernel vs reference path {row['reference']:.3e}"
                 if "reference" in row else "")
              + f" (limit {HYBRID_F32_RTOL})", flush=True)
    worst = max(e for row in errs.values() for k, e in row.items()
                if k != "control")
    if not worst <= HYBRID_F32_RTOL:
        raise AssertionError(f"hybrid check f32: the kernel path parts from "
                             f"the plain or reference path by {worst:.3e}")
    control = min(row["control"] for row in errs.values())
    if not control > HYBRID_F32_RTOL:
        raise AssertionError(f"hybrid check f32: the control parts from the "
                             f"plain path by only {control:.3e}, so the "
                             f"limit {HYBRID_F32_RTOL} could not see a "
                             f"zeroed key")


def attention_serve_expect(cfg, admissions, ticks):
    """The int8 serve path's launches: flash once a layer an admission,
    the int8 decode once a layer a tick."""
    return {"flash_attention": cfg.n_layers * admissions,
            "quant_decode_attention": cfg.n_layers * ticks}


def cut_serve_phase(torch, kerns, name, arch, depths, load):
    """<name>: ``arch`` at full width through serve_path with the int8 pool
    (exact launches, every request served once, every logit finite), at
    the first depth of ``depths`` that does not run out of memory (the cut
    rule; each depth passed over is printed with its reason); then
    serve_check on the same width cut to SERVE_CHECK_LAYERS layers (a
    second draw: bf16 beside the reference path as a witness, then the
    weights widened to f32 against a one-key-zeroed control). Returns the
    serve path's launches."""
    from repro_torch.configs import get_arch
    t0, tried = time.time(), []
    for layers in depths:
        free_device_memory(torch)
        err = None
        try:
            counts, _, params, reqs = serve_path(
                torch, kerns, arch, load, True, attention_serve_expect,
                layers=layers)
        except torch.cuda.OutOfMemoryError as e:
            err = str(e).splitlines()[0]
        if err is None:
            break
        tried.append(f"{layers} layers: out of memory ({err})")
    else:
        raise AssertionError(f"{name}: nothing fits: {tried}")
    del params
    free_device_memory(torch)
    served = time.time() - t0
    cfg = dataclasses.replace(get_arch(arch), n_layers=SERVE_CHECK_LAYERS)
    from repro_torch import device as devlib
    from repro_torch.models import init_params, model_specs
    params = init_params(model_specs(cfg), devlib.generator("cuda", 1),
                         cfg.dtype)
    serve_check(torch, cfg, params, reqs)
    del params
    free_device_memory(torch)
    print(f"{name}: depth {layers} of {get_arch(arch).n_layers} layers "
          f"(cut rule: {'; '.join(tried) or 'the first depth fits'}); serve "
          f"{served:.1f} s, its check at {SERVE_CHECK_LAYERS} layers "
          f"{time.time() - t0 - served:.1f} s", flush=True)
    return counts


def moe_vlm_phases(torch, kerns):
    """The MoE and vlm slice's phases (ROADMAP 1a and 1b): the four serve
    phases of MOE_VLM_SERVE (cut_serve_phase), then the two trainers of
    MOE_VLM_TRAIN through lm_family_phase (the cut rule: the first depth
    whose peak stays within LM_PEAK_GB and that does not run out of
    memory; FALCON_STEPS steps and one scan round), both card against CPU
    at reduced size (lm_family_parity) and one qwen3-moe layer under remat
    against the direct layer (remat_check). Prints each phase's seconds;
    returns the launches of the serve and train paths."""
    launches = {}
    for name, arch, depths, load in MOE_VLM_SERVE:
        t0 = time.time()
        add_counts(launches, cut_serve_phase(torch, kerns, name, arch,
                                             depths, load))
        print(f"{name}: {time.time() - t0:.1f} s", flush=True)
    for arch, depths in MOE_VLM_TRAIN:
        t0 = time.time()
        add_counts(launches, lm_family_phase(torch, kerns[:2], arch, depths,
                                             FALCON_STEPS))
        print(f"lm-train-{arch}: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    lm_family_parity(torch, kerns[:2], [a for a, _ in MOE_VLM_TRAIN])
    remat_check(torch, [MOE_VLM_TRAIN[0][0]])
    print(f"moe and vlm trainers card vs CPU and remat: "
          f"{time.time() - t0:.1f} s", flush=True)
    return launches


def encdec_serve_expect(cfg, admissions, ticks):
    """The encdec int8 serve path's launches: flash once an encoder layer
    and twice a decoder layer (self- and cross-attention) an admission,
    the int8 decode once a decoder layer a tick (the tick's
    cross-attention reads the dense cross cache through the plain
    ``attend_decode``, as the reference's)."""
    return {"flash_attention": (cfg.encoder.n_layers + 2 * cfg.n_layers)
            * admissions,
            "quant_decode_attention": cfg.n_layers * ticks}


def lm_baselines_phase(torch, kerns, arch=ENCDEC_ARCH):
    """lm-baselines-<arch>: AdaFBiO and the Table-1 baselines (BASELINES)
    through FederatedTrainer at lm_train_phase's shape (full width and
    depth, launch/train.py's FedConfig, LM_BATCH x LM_SEQ, one client),
    each from the same params, batches and Neumann depths: the init and
    one scan round (q local steps and the sync); every state leaf finite
    after it, and the update kernels' launches as the code gives them:
    AdaFBiO 2 storm_update a step and one adafbio_update a step and a
    sync; adafbio_na, fedbioacc and fedavg_sgd (AdaFBiO's step at
    adaptive "none": the STORM refreshes launch, the plain x update does
    not) 2 storm_update a step; fednest and localbsgvrm (their own steps)
    none. Prints each round's ms and peak; then one local step and a sync
    of each, card against the CPU at reduced size (lm_family_parity).
    Returns the launches."""
    from repro_torch import device as devlib
    from repro_torch.configs import FedConfig, ShapeConfig, get_arch
    from repro_torch.core.tree_util import tree_leaves, tree_map, tree_stack
    from repro_torch.data.synthetic import (FederatedLMData, TorchLMDraws,
                                            make_client_batch)
    from repro_torch.fed.runtime import (FederatedTrainer, NeumannDraws,
                                         client_batch_specs)
    from repro_torch.launch.train import PARAM_SALT

    cfg = get_arch(arch)
    fed = FedConfig(**LM_FED)
    q = fed.q
    shape = ShapeConfig("cli", LM_SEQ, LM_BATCH, "train")
    base = FederatedTrainer(cfg, fed, shape, device="cuda")
    specs = client_batch_specs(cfg, shape, base.m, fed)
    data = FederatedLMData(vocab=cfg.vocab, n_clients=base.m,
                           draws=TorchLMDraws(0, "cuda"))
    depths = NeumannDraws(0, fed.neumann_k, base.m, "cuda")
    batches = [make_client_batch(data, cfg, specs, t, "cuda")
               for t in range(q)]
    batch_q = tree_stack(batches)
    k_q = torch.stack([depths.step(t) for t in range(q)])
    params = base.init_params(devlib.generator("cuda", 0, PARAM_SALT))
    del base
    launches = {}
    for alg in BASELINES:
        tr = FederatedTrainer(cfg, fed, shape, algorithm=alg, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        # a copy each: at one client the states view the params they start
        # from, and a round may write its states in place
        states, server = tr.init_states(tree_map(torch.clone, params),
                                        batches[0], depths.init())
        reset_launches(kerns)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, server = tr.round_step_fn()(states, server, batch_q, k_q)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        counts = launch_counts(kerns)
        storm = 2 * q if alg not in ("fednest", "localbsgvrm") else 0
        check_counts(f"lm-baselines {alg}", counts, {
            "storm_update": storm,
            "adafbio_update": q + 1 if alg == "adafbio" else 0,
            "quantize_stoch": 0, "dequantize": 0})
        add_counts(launches, counts)
        bad = [path for path, t in named_leaves({"states": states,
                                                 "server": server})
               if t.is_floating_point() and not bool(torch.isfinite(t).all())]
        if bad:
            raise AssertionError(f"lm-baselines {alg}: leaves not finite "
                                 f"after the round: {bad}")
        loss = float(tr.eval_fn()(states, batches[-1]))
        print(f"lm-baselines-{arch} {alg:11s}: one round (q {q} steps and "
              f"the sync) {ms:.1f} ms, launches {counts}, server "
              f"keys {sorted(server['adaptive'])}, every leaf finite, "
              f"f(x̄,ȳ) {loss:.5f}, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"({len(tree_leaves(states))} state leaves)", flush=True)
        del states, server, tr
        free_device_memory(torch)
    del params, batches, batch_q
    free_device_memory(torch)
    lm_family_parity(torch, kerns, [arch], BASELINES)
    return launches


def encdec_phases(torch, kerns):
    """The encdec slice's phases (ROADMAP 1c with 1i), whisper-tiny at full
    width and depth: serve-whisper-tiny (serve_path over ENCDEC_LOAD with
    the int8 pool, exact launches by encdec_serve_expect, then serve_check
    on the same weights), lm-train-whisper-tiny (lm_train_phase at
    launch/train.py's FedConfig; the trainer card vs CPU at reduced size;
    one encoder and one decoder layer under remat against the direct
    layers) and lm-baselines-whisper-tiny (lm_baselines_phase). Prints each
    phase's seconds; returns the serve and train paths' launches."""
    from repro_torch.configs import get_arch
    launches = {}
    t0 = time.time()
    counts, cfg, params, reqs = serve_path(
        torch, kerns, ENCDEC_ARCH, ENCDEC_LOAD, True, encdec_serve_expect)
    add_counts(launches, counts)
    serve_check(torch, cfg, params, reqs)
    del params
    free_device_memory(torch)
    print(f"serve-{ENCDEC_ARCH}: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    counts, _ = lm_train_phase(torch, kerns[:2], get_arch(ENCDEC_ARCH))
    add_counts(launches, counts)
    lm_family_parity(torch, kerns[:2], [ENCDEC_ARCH])
    remat_check(torch, [ENCDEC_ARCH])
    print(f"lm-train-{ENCDEC_ARCH}: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    add_counts(launches, lm_baselines_phase(torch, kerns[:2]))
    print(f"lm-baselines-{ENCDEC_ARCH}: {time.time() - t0:.1f} s",
          flush=True)
    return launches


def x_tree(torch, cfg, gen, n_layers=None):
    """qwen1.5-4b's x tree (its backbone leaves: bf16, the norms f32) as
    normal draws on the card, cut to ``n_layers`` if given."""
    from repro_torch.core.tree_util import tree_map
    from repro_torch.models import model_specs
    from repro_torch.models.params import torch_dtype
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)

    def make(spec):
        t = torch.empty(spec.shape, device="cuda",
                        dtype=torch_dtype(spec.dtype or cfg.dtype))
        return t.normal_(generator=gen)
    return tree_map(make, model_specs(cfg)["x"])


def bits(torch, t):
    """A tensor's raw bits (bit-for-bit comparisons)."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def leaves_equal(torch, got, want):
    return all(g.dtype == w.dtype and torch.equal(bits(torch, g),
                                                  bits(torch, w))
               for g, w in zip(got, want))


def leaves_err(torch, got, want):
    """(max abs error, its limit) of leaf lists: KERNEL_RTOL relative to
    the largest plain value, as the packed kernels are held."""
    err = max((g.float() - w.float()).abs().max().item()
              for g, w in zip(got, want))
    top = max(w.float().abs().max().item() for w in want)
    return err, KERNEL_RTOL * max(1.0, top)


def packed_storm(torch, kern, gn, go, est, beta):
    """The packed route: pack to [M, n] f32, the packed kernel, unpack to
    est's dtypes."""
    from repro_torch.core.tree_util import (tree_pack_stacked,
                                            tree_unpack_stacked)
    fl_e, spec = tree_pack_stacked(est)
    out = kern.storm_update(tree_pack_stacked(gn, spec)[0],
                            tree_pack_stacked(go, spec)[0], fl_e, beta)
    return tree_unpack_stacked(out, spec)


def packed_adafbio(torch, kern, p, w, a, lr, rho, per_row):
    from repro_torch.core.tree_util import (tree_pack_stacked,
                                            tree_unpack_stacked)
    fl_p, spec = tree_pack_stacked(p)
    fl_a = (tree_pack_stacked(a, spec)[0] if per_row else
            tree_pack_stacked([x.unsqueeze(0) for x in a])[0][0])
    out = kern.adafbio_update(fl_p, tree_pack_stacked(w, spec)[0], fl_a, lr,
                              rho)
    return tree_unpack_stacked(out, spec)


def check_leaf_entries(torch, kern, ref, label, gn, go, est, p, w, a_shared,
                       a_rows, scalars):
    """The leaf-table entries against the packed f32 entries (bit for bit)
    and the per-leaf plain versions (KERNEL_RTOL) on one leaf table;
    returns the worst error against the plain versions."""
    beta, lr, rho = scalars
    worst = 0.0
    calls = [
        ("storm_update",
         lambda: kern.storm_update_leaves(gn, go, est, beta),
         lambda: packed_storm(torch, kern, gn, go, est, beta),
         lambda: [ref.storm_update_ref(*t, beta)
                  for t in zip(gn, go, est)]),
        ("adafbio_update",
         lambda: kern.adafbio_update_leaves(p, w, a_shared, lr, rho),
         lambda: packed_adafbio(torch, kern, p, w, a_shared, lr, rho, False),
         lambda: [ref.adafbio_update_ref(*t, lr, rho)
                  for t in zip(p, w, a_shared)])]
    if a_rows is not None:
        calls.append((
            "adafbio_update per-row",
            lambda: kern.adafbio_update_leaves(p, w, a_rows, lr, rho),
            lambda: packed_adafbio(torch, kern, p, w, a_rows, lr, rho, True),
            lambda: [ref.adafbio_update_ref(*t, lr, rho)
                     for t in zip(p, w, a_rows)]))
    for name, leaves, packed, plain in calls:
        before = dict(kern.launches)
        got = leaves()
        launched = {k: kern.launches[k] - before[k] for k in before}
        want_p, want = packed(), plain()
        torch.cuda.synchronize()
        key = name.split()[0]
        if launched[key] != 1:
            raise AssertionError(f"{name} {label}: {launched[key]} launches "
                                 f"for {len(got)} leaves, want 1")
        same = leaves_equal(torch, got, want_p)
        err, limit = leaves_err(torch, got, want)
        worst = max(worst, err)
        print(f"kernel {name:22s} leaf table {label:14s} {len(got)} leaves, "
              f"{sum(t.numel() for t in got):,} elements: bit-equal to the "
              f"packed entry {same}; max_abs_err {err:.3e} against the "
              f"plain version (limit {limit:.1e}), bit-equal "
              f"{leaves_equal(torch, got, want)}", flush=True)
        if not same or not err <= limit:
            raise AssertionError(f"{name} leaf table disagrees at {label}")
    return worst


def leaf_table_phase(torch, kern, ref):
    """The leaf-table entries of kernels 1-2: held bit for bit against the
    packed f32 entries and against the per-leaf plain versions on mixed
    f32/bf16 tables (M 1 and 3, ``a`` shared and per row, misaligned
    leaves, leaves of 1-3 elements) and on qwen1.5-4b's x tree cut to
    LEAF_CUT_LAYERS layers; then timed on the full x tree (3.56 B
    elements), warm and cold, beside the plain version and the bound.
    Returns the kernels' numbers for the ``kernels`` line."""
    from repro_torch.configs import get_arch
    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.kernels import storm_update as kmod
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    scalars = (torch.full((), 0.3, device=dev),
               torch.full((), 0.01, device=dev),
               torch.full((), 1e-4, device=dev))
    worst = 0.0
    for label, m, leaf_specs in LEAF_CASES:
        def leaf(n, dtype, off, rows=m):
            flat = torch.randn(rows * n + off, generator=gen, device=dev)
            return flat.to(getattr(torch, dtype))[off:].view(rows, n)
        ops5 = [[leaf(*sp) for sp in leaf_specs] for _ in range(5)]
        a_sh = [leaf(n, dt, off, 1)[0].abs_() for n, dt, off in leaf_specs]
        a_rows = [leaf(*sp).abs_() for sp in leaf_specs]
        worst = max(worst, check_leaf_entries(
            torch, kern, ref, label, *ops5, a_sh, a_rows, scalars))
    cfg = get_arch(LM_ARCH)
    cut = [tree_leaves(x_tree(torch, cfg, gen, LEAF_CUT_LAYERS))
           for _ in range(5)]
    a_cut = [t.abs() for t in tree_leaves(x_tree(torch, cfg, gen,
                                                 LEAF_CUT_LAYERS))]
    worst = max(worst, check_leaf_entries(
        torch, kern, ref, f"{LM_ARCH} x/{LEAF_CUT_LAYERS}L",
        *[[t.unsqueeze(0) for t in c] for c in cut], a_cut, None,
        scalars))
    del cut, a_cut
    free_device_memory(torch)

    # the full x tree, one client: g_new/p, g_old/w and est/a
    trees = [tree_leaves(x_tree(torch, cfg, gen)) for _ in range(3)]
    trees[2] = [t.abs_() for t in trees[2]]
    n_el = sum(t.numel() for t in trees[0])
    nbytes = sum(4 * t.numel() * t.element_size() for t in trees[0])
    flush = torch.empty(COLD_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    beta, lr, rho = scalars
    entries = {
        "storm_update": (
            lambda: kern.storm_update_leaves(*trees, beta),
            lambda: [ref.storm_update_ref(*t, beta) for t in zip(*trees)]),
        "adafbio_update": (
            lambda: kern.adafbio_update_leaves(*trees, lr, rho),
            lambda: [ref.adafbio_update_ref(*t, lr, rho)
                     for t in zip(*trees)])}
    numbers = {}
    for name, (fast, plain) in entries.items():
        err, limit = leaves_err(torch, fast(), plain())
        ms = time_ms(torch, fast)

        def evict():
            kmod._info_table.cache_clear()
            flush.zero_()
        cold_ms = time_ms(torch, fast, reps=5, warmup=0, before=evict)
        plain_ms = time_ms(torch, plain, reps=5, warmup=1)
        numbers[name] = dict(ms=ms, cold_ms=cold_ms, plain_ms=plain_ms,
                             bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                             max_abs_err=max(worst, err), bytes=nbytes,
                             elements=n_el)
        print(f"kernel {name:22s} leaf table {LM_ARCH} full x tree "
              f"({len(trees[0])} leaves, {n_el:,} elements, {nbytes:,} "
              f"bytes): max_abs_err {err:.3e} (limit {limit:.1e}); kernel "
              f"{ms:.4f} ms warm, {cold_ms:.4f} ms cold (tables rebuilt, L2 "
              f"flushed); plain {plain_ms:.4f} ms; bound "
              f"{numbers[name]['bound_ms']:.4f} ms", flush=True)
        if not err <= limit:
            raise AssertionError(f"{name} leaf table disagrees on the full "
                                 f"x tree")
    del trees, flush
    free_device_memory(torch)
    return numbers


class KernelCalls:
    """Counts the tree-level calls of the update kernels and times each on
    the card with CUDA events around it (the launch inside it and its
    argument checks), while in a ``with`` block."""

    NAMES = {"storm_update": "storm_update_tree",
             "adafbio_update": "adafbio_update_tree"}

    def __init__(self, torch):
        self.torch = torch
        self.events = {k: [] for k in self.NAMES}

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops, self.real = ops, {}
        for name, attr in self.NAMES.items():
            real = self.real[name] = getattr(ops, attr)

            def timed(*a, _real=real, _name=name, **kw):
                start = self.torch.cuda.Event(enable_timing=True)
                end = self.torch.cuda.Event(enable_timing=True)
                start.record()
                out = _real(*a, **kw)
                end.record()
                self.events[_name].append((start, end))
                return out
            setattr(ops, attr, timed)
        return self

    def __exit__(self, *exc):
        for name, attr in self.NAMES.items():
            setattr(self.ops, attr, self.real[name])

    def calls(self):
        return {k: len(v) for k, v in self.events.items()}

    def ms(self):
        self.torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v)
                for k, v in self.events.items()}


def lm_step_flops(cfg, fed, seq, batch):
    """Model FLOPs of one local step (2 per multiply-add), from the shapes:
    a forward is the projections (2 d_in d_out a token a layer), the
    attention's two products over the full S x S (attend_full computes the
    masked half too) and the head; a backward to the weights and inputs is
    twice a forward. Per step: the LL gradient in y at the new and old
    params (backbone forward, head forward and its weight gradient); two
    hypergradients, each the UL gradient in (x, y) (forward and backward),
    the Neumann batches' features (forwards) with their head products (4
    head passes a Neumann iteration) and the mixed term on zeta_0 (forward
    and backward, three head passes)."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    hd, H, KV = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    layer = 2 * (d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * cfg.d_ff)

    def backbone(tokens, s):
        return tokens * L * (layer + 2 * 2 * s * H * hd)

    def head(tokens):
        return 2 * d * V * tokens

    s, sn = seq, max(seq // 4, 64)
    bf = max(int(batch * fed.ul_batch_frac), 1)
    bn, K = fed.neumann_batch, fed.neumann_k
    gy = backbone(batch * s, s) + 2 * head(batch * (s - 1))
    hg = (3 * (backbone(bf * s, s) + head(bf * (s - 1)))
          + K * backbone(bn * sn, sn) + 4 * (K - 1) * head(bn * (sn - 1))
          + 3 * backbone(bn * sn, sn) + 3 * head(bn * (sn - 1)))
    return 2 * gy + 2 * hg


def lm_train_phase(torch, kerns, cfg=None, steps=LM_STEPS, seq=LM_SEQ,
                   fed_kw=LM_FED):
    """lm-train-<arch>: FederatedTrainer on ``cfg`` (qwen1.5-4b at full width
    and depth by default; bf16 params from a seed, one client), eager for
    ``steps`` local steps and scan for ``steps / q`` rounds from the same
    init, batches and Neumann draws: every state leaf finite after every
    step, sync and round, exact launch counts (storm 2 a local step,
    adafbio 1 a local step and 1 a sync), one launch a tree-level call,
    finite losses, eager == scan leaf by leaf; prints steady ms a step and
    a round, LL tokens/s, the model FLOP rate (dense family), peak memory
    and the two kernels' ms inside a step. Each layer runs under remat
    (``models/remat.py``), as the training forward always does. Returns
    the launches of both engines and the numbers."""
    from repro_torch import device as devlib
    from repro_torch.configs import FedConfig, ShapeConfig, get_arch
    from repro_torch.core.tree_util import tree_leaves, tree_map, tree_stack
    from repro_torch.data.synthetic import (FederatedLMData, TorchLMDraws,
                                            make_client_batch)
    from repro_torch.fed.runtime import (FederatedTrainer, NeumannDraws,
                                         client_batch_specs)
    from repro_torch.launch.train import PARAM_SALT, server_step
    from repro_torch.models import model_specs, param_count

    cfg = cfg or get_arch(LM_ARCH)
    name = f"lm-train-{cfg.name}"
    fed = FedConfig(**fed_kw)

    def finite(stage, states, server):
        bad = [path for path, t in named_leaves({"states": states,
                                                 "server": server})
               if t.is_floating_point() and not bool(torch.isfinite(t).all())]
        if bad:
            raise AssertionError(f"{name}: state leaves not finite after "
                                 f"{stage}: {bad}")

    shape = ShapeConfig("cli", seq, LM_BATCH, "train")
    tr = FederatedTrainer(cfg, fed, shape, device="cuda")
    specs = client_batch_specs(cfg, shape, tr.m, fed)
    data = FederatedLMData(vocab=cfg.vocab, n_clients=tr.m,
                           draws=TorchLMDraws(0, "cuda"))
    depths = NeumannDraws(0, fed.neumann_k, tr.m, "cuda")
    batches = [make_client_batch(data, cfg, specs, t, "cuda")
               for t in range(steps)]
    if cfg.n_prefix_embeds and not all(
            p + "prefix_embeds" in b for b in batches
            for p in ("", "val_", "hyper0_", "neumann_")):
        raise AssertionError(f"{name}: a batch lacks its prefix embeddings")
    ks = [depths.step(server_step(t, fed.q)) for t in range(steps)]
    pspecs = model_specs(cfg)
    print(f"{name}: x {param_count(pspecs['x']):,} and y "
          f"{param_count(pspecs['y']):,} parameters, {cfg.n_layers} layers, "
          f"batch {({k: tuple(v.shape) for k, v in specs.items()})}",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = tr.init_params(devlib.generator("cuda", 0, PARAM_SALT))
    states, server = tr.init_states(params, batches[0], depths.init())
    del params
    torch.cuda.synchronize()
    init_s = time.time() - t0
    finite("init", states, server)
    init_host = to_host(torch, (states, server))
    ev = tr.eval_fn()
    flops = (lm_step_flops(cfg, fed, seq, LM_BATCH)
             if cfg.family in ("dense", "vlm") else None)
    ll_tokens = LM_BATCH * seq
    q = fed.q

    # eager: one call a local step, the sync before each step t % q == 0
    local, sync = tr.local_step_fn(), tr.sync_step_fn()
    step_s, loss_e = [], []
    reset_launches(kerns)
    with KernelCalls(torch) as timer:
        for t in range(steps):
            if t > 0 and t % q == 0:
                states, server = sync(states, server)
                finite(f"the sync before step {t}", states, server)
            torch.cuda.synchronize()
            r0 = time.time()
            states, server = local(states, server, batches[t], ks[t])
            torch.cuda.synchronize()
            step_s.append(time.time() - r0)
            finite(f"step {t}", states, server)
        loss_e.append(float(ev(states, batches[-1])))
    counts = launch_counts(kerns)
    syncs_e = (steps - 1) // q
    check_counts(f"{name} eager", counts, {
        "storm_update": 2 * steps, "adafbio_update": steps + syncs_e,
        "quantize_stoch": 0, "dequantize": 0})
    if timer.calls() != {"storm_update": counts["storm_update"],
                         "adafbio_update": counts["adafbio_update"]}:
        raise AssertionError(f"{name} eager: calls {timer.calls()} and "
                             f"launches {counts} differ")
    kernel_ms = {k: v / steps for k, v in timer.ms().items()}
    launches = dict(counts)
    # the sync the eager loop runs before step ``steps``, so that both
    # engines end on a sync
    states, server = sync(states, server)
    finite("the last sync", states, server)
    eager_final = to_host(torch, (states, server))
    del states, server
    free_device_memory(torch)

    # scan: steps / q rounds, each q local steps and the sync
    states, server = tree_map(lambda t: t.cuda(), init_host)
    del init_host
    round_fn = tr.round_step_fn()
    round_s = []
    peak_eager = peak_gib(torch)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kerns)
    rounds = steps // q
    with KernelCalls(torch) as timer:
        for r in range(rounds):
            batch_q = tree_stack(batches[r * q:(r + 1) * q])
            k_q = torch.stack(ks[r * q:(r + 1) * q])
            torch.cuda.synchronize()
            r0 = time.time()
            states, server = round_fn(states, server, batch_q, k_q)
            torch.cuda.synchronize()
            round_s.append(time.time() - r0)
            finite(f"round {r}", states, server)
    loss_s = float(ev(states, batches[-1]))
    counts = launch_counts(kerns)
    check_counts(f"{name} scan", counts, {
        "storm_update": 2 * steps, "adafbio_update": steps + rounds,
        "quantize_stoch": 0, "dequantize": 0})
    if timer.calls() != {"storm_update": counts["storm_update"],
                         "adafbio_update": counts["adafbio_update"]}:
        raise AssertionError(f"{name} scan: calls {timer.calls()} and "
                             f"launches {counts} differ")
    add_counts(launches, counts)
    peak_scan = peak_gib(torch)
    peak = max(peak_eager, peak_scan)
    for v in loss_e + [loss_s]:
        if not math.isfinite(v):
            raise AssertionError(f"{name}: loss {loss_e} {loss_s}")
    worst, unequal = 0.0, 0
    got = tree_leaves((states, server))
    want = tree_leaves(eager_final)
    for g, w in zip(got, want):
        w = w.to(g.device)
        if not torch.equal(g, w):
            unequal += 1
            worst = max(worst, rel_err(torch, g, w))
    steady_step = statistics.mean(step_s[1:])
    # the rounds after the first; a run of one round has only that one
    steady_round = statistics.mean(round_s[1:] or round_s)
    rate = (f"{flops / steady_step / 1e12:.1f} TFLOP/s of an estimated "
            f"{flops / 1e12:.1f} TFLOP a step" if flops else
            "model FLOP rate not estimated (the dense family's formula)")
    print(f"{name}: init {init_s:.2f} s; eager {steps} steps "
          f"({syncs_e} sync): steps {[round(x, 4) for x in step_s]} s, "
          f"steady {steady_step * 1e3:.2f} ms a local step, "
          f"{ll_tokens / steady_step:.1f} LL tokens/s, {rate}; scan "
          f"{rounds} rounds: {[round(x, 4) for x in round_s]} s, steady "
          f"{steady_round * 1e3:.2f} ms a round "
          f"({q * ll_tokens / steady_round:.1f} LL tokens/s); kernels in "
          f"a step: storm_update {kernel_ms['storm_update']:.3f} ms "
          f"(2 calls), adafbio_update {kernel_ms['adafbio_update']:.3f} ms "
          f"(1 call, and 1 a sync); peak {peak_eager:.2f} GiB eager, "
          f"{peak_scan:.2f} GiB scan; every state leaf finite after every "
          f"step, sync and round; f(x̄,ȳ) eager "
          f"{loss_e[-1]:.5f} scan {loss_s:.5f}; eager vs scan: "
          f"{len(got) - unequal} of {len(got)} leaves bit-equal, worst "
          f"normwise rel err {worst:.3e}", flush=True)
    if unequal:
        raise AssertionError(f"{name}: eager and scan final states differ")
    del states, server, eager_final
    free_device_memory(torch)
    return launches, dict(step_ms=steady_step * 1e3,
                          round_ms=steady_round * 1e3, peak_gib=peak,
                          kernel_ms=kernel_ms, layers=cfg.n_layers)


def lm_family_phase(torch, kerns, arch, depths, steps):
    """lm-train-<arch> for the ssm and hybrid families: ``lm_train_phase``
    at the arch's full width with LM_FAMILY_FED, at the first depth of
    ``depths`` whose peak stays within LM_PEAK_GB and that does not run
    out of memory (the cut rule; no other cut). Prints the depth taken and
    the cuts tried; returns the launches."""
    from repro_torch.configs import get_arch
    tried = []
    for depth in depths:
        free_device_memory(torch)
        cfg = dataclasses.replace(get_arch(arch), n_layers=depth)
        err = None
        try:
            counts, out = lm_train_phase(torch, kerns, cfg, steps,
                                         fed_kw=LM_FAMILY_FED)
        except torch.cuda.OutOfMemoryError as e:
            err = str(e).splitlines()[0]
        if err is None and out["peak_gib"] * 2 ** 30 / 1e9 <= LM_PEAK_GB:
            break
        tried.append(f"{depth} layers: " + (
            f"out of memory ({err})" if err else
            f"peak {out['peak_gib'] * 2 ** 30 / 1e9:.2f} GB"))
    else:
        raise AssertionError(f"lm-train-{arch}: nothing fits: {tried}")
    print(f"lm-train-{arch}: depth {depth} of {get_arch(arch).n_layers} "
          f"layers (cut rule: {'; '.join(tried) or 'the first depth fits'}), "
          f"{steps} steps, {out['step_ms']:.2f} ms a step, "
          f"{out['round_ms']:.2f} ms a round, peak {out['peak_gib']:.2f} GiB",
          flush=True)
    free_device_memory(torch)
    return counts


def lm_family_parity(torch, kerns, archs=(SSM_ARCH, HYBRID_ARCH),
                     algorithms=("adafbio",)):
    """The trainers of ``archs`` (the ssm and hybrid ones by default), each
    running each algorithm of ``algorithms`` (AdaFBiO by default), at
    reduced size in f32, on the CPU (the kernels' plain versions) and then
    on the card from the same params, batches and depths (LM_PARITY_FED:
    K 1, no bf16 feature cache; ShapeConfig("cli", LM_FAMILY_PARITY_SEQ,
    2), so each training sequence spans 2 scan chunks of the ssm and
    hybrid layers): the init, one local step and one sync, every leaf
    within LM_FAMILY_PARITY_REL normwise of the CPU's after each
    (whisper-tiny's within ENCDEC_PARITY_REL)."""
    from repro_torch import device as devlib
    from repro_torch.configs import FedConfig, ShapeConfig, get_arch, reduced
    from repro_torch.core.tree_util import tree_leaves, tree_map
    from repro_torch.data.synthetic import (FederatedLMData, TorchLMDraws,
                                            make_client_batch)
    from repro_torch.fed.runtime import (FederatedTrainer, NeumannDraws,
                                         client_batch_specs)
    from repro_torch.launch.train import PARAM_SALT

    fed = FedConfig(**{**LM_FED, **LM_PARITY_FED})
    shape = ShapeConfig("cli", LM_FAMILY_PARITY_SEQ, 2, "train")
    for arch in archs:
        cfg = reduced(get_arch(arch), dtype="float32")
        cpu = FederatedTrainer(cfg, fed, shape, device="cpu")
        specs = client_batch_specs(cfg, shape, cpu.m, fed)
        data = FederatedLMData(vocab=cfg.vocab, n_clients=cpu.m,
                               draws=TorchLMDraws(0, "cpu"))
        batch = make_client_batch(data, cfg, specs, 0, "cpu")
        depths = NeumannDraws(0, fed.neumann_k, cpu.m, "cpu")
        params = cpu.init_params(devlib.generator("cpu", 1, PARAM_SALT))
        limit = (ENCDEC_PARITY_REL if cfg.family == "encdec"
                 else LM_FAMILY_PARITY_REL)
        for alg in algorithms:
            runs = {}
            for dev in ("cpu", "cuda"):
                tr = FederatedTrainer(cfg, fed, shape, algorithm=alg,
                                      device=dev)

                def on(tree, dev=dev):
                    return tree_map(lambda t: t.to(dev), tree)
                st = tr.init_states(on(params), on(batch), on(depths.init()))
                stages = [st]
                st = tr.local_step_fn()(*st, on(batch), on(depths.step(0)))
                stages.append(st)
                stages.append(tr.sync_step_fn()(*st))
                runs[dev] = stages
            worst = [max(rel_err(torch, a.float(), b.to(a.device).float())
                         for a, b in zip(tree_leaves(g), tree_leaves(w))
                         if a.is_floating_point())
                     for g, w in zip(runs["cuda"], runs["cpu"])]
            print(f"lm-train parity at reduced {arch}, {alg} (f32, K 1, seq "
                  f"{LM_FAMILY_PARITY_SEQ}): card vs CPU worst normwise rel "
                  f"err init {worst[0]:.3e}, local step {worst[1]:.3e}, sync "
                  f"{worst[2]:.3e} (limit {limit})", flush=True)
            finite = all(bool(torch.isfinite(t).all())
                         for t in tree_leaves(runs["cuda"])
                         if t.is_floating_point())
            if max(worst) > limit or not finite:
                raise AssertionError(f"lm-train {arch} {alg}: card and CPU "
                                     f"disagree")


def remat_check(torch, archs=(LM_ARCH, SSM_ARCH, HYBRID_ARCH)):
    """The training forward's per-layer remat against the same layers
    called directly, on the card: for each arch of ``archs`` (by default
    qwen1.5-4b, falcon-mamba-7b, zamba2-1.2b; the moe family's
    qwen3-moe-30b-a3b in moe_vlm_phases, whisper-tiny in encdec_phases)
    one layer at full width (zamba2: one mamba2 layer and the shared block
    after it; whisper-tiny: one encoder layer over LM_SEQ frames and one
    decoder layer, whose remat takes its cross-attention's K and V of the
    encoder's output as inputs),
    bf16 params from a seed, one
    sequence of LM_SEQ tokens: the features and the gradients of the LM
    loss in every layer leaf (the layers, zamba2's shared block, the head)
    through ``torch.func.grad`` equal bit for bit. The embedding's gradient
    comes from the embedding lookup's backward, outside the layers, and is
    not compared."""
    from repro_torch import device as devlib
    from repro_torch.configs import get_arch
    from repro_torch.core.bilevel import softmax_xent
    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.models import model
    from repro_torch.models.params import init_params

    for arch in archs:
        cfg = dataclasses.replace(get_arch(arch), n_layers=1)
        if cfg.family == "hybrid":
            cfg = dataclasses.replace(cfg, shared_attn_every=1)
        batch, n_remat = {}, 1
        if cfg.family == "encdec":
            # one encoder layer over LM_SEQ frames and one decoder layer
            # over a quarter as many tokens, its cross-attention's K and V
            # of the encoder's output going into its remat as inputs
            cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
                cfg.encoder, n_layers=1))
            n_remat = 2
        params = init_params(model.model_specs(cfg), devlib.generator(
            "cuda", 2, 0), cfg.dtype, "cuda")
        gen = devlib.generator("cuda", 3, 0)
        seq = LM_SEQ // 4 if cfg.family == "encdec" else LM_SEQ
        tokens = torch.randint(0, cfg.vocab, (1, seq + 1), generator=gen,
                               device="cuda")
        batch["tokens"] = tokens[:, :-1]
        if cfg.family == "encdec":
            batch["enc_embeds"] = 0.02 * torch.randn(
                1, LM_SEQ, cfg.d_model, generator=gen, device="cuda").to(
                    getattr(torch, cfg.dtype))
        ctx = model.ModelCtx(kind="train")
        calls = []

        def loss(xp, yp):
            feats = model.features(cfg, xp, batch, ctx)
            logits = model.head_logits(cfg, yp, feats)
            return softmax_xent(logits, tokens[:, 1:]), feats

        def run():
            (gx, gy), feats = torch.func.grad(loss, argnums=(0, 1),
                                              has_aux=True)(params["x"],
                                                            params["y"])
            torch.cuda.synchronize()
            gx = {k: v for k, v in gx.items() if k != "embed"}
            return [feats] + tree_leaves((gx, gy))

        real = model.remat_layer

        def counted(body, h, p):
            calls.append(1)
            return real(body, h, p)
        model.remat_layer = counted
        try:
            remat = run()
            model.remat_layer = lambda body, h, p: body(h, p)
            direct = run()
        finally:
            model.remat_layer = real
        unequal = sum(not torch.equal(a, b) for a, b in zip(remat, direct))
        finite = all(bool(torch.isfinite(t).all()) for t in remat)
        print(f"remat vs direct on the card, {arch} ({cfg.family}, one "
              f"layer{' of the encoder and one of the decoder' if n_remat > 1 else ''} "
              f"at full width, seq {LM_SEQ}): {len(calls)} remat'd "
              f"layer calls, features and {len(remat) - 1} gradient leaves: "
              f"{len(remat) - unequal} of {len(remat)} bit-equal, finite "
              f"{finite}", flush=True)
        if unequal or not finite or len(calls) != n_remat:
            raise AssertionError(f"remat vs direct on {arch}: {unequal} "
                                 f"leaves differ")
        del params, remat, direct
        free_device_memory(torch)


def train_ckpt_serve_phase(torch, kerns):
    """train-ckpt-serve: the port's train CLI on reduced qwen1.5-4b on the
    card (scan, 8 steps, q 4, a checkpoint in 2 shards), --resume for one
    more round, then the serve CLI serving 4 requests from the checkpoint:
    the bridge's params must equal the client mean of the saved state, and
    every request must be served once; then the population CLI (N 4, C 2,
    8 steps, 2 shards) dense and with ``--spill host``: the same
    checkpoint files, bit for bit, and the same wire bytes. Returns the
    training launches."""
    import shutil
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.tree_util import tree_leaves, tree_mean_axis0
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.serve import load_serve_params

    ckdir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    path = ckdir / "qwen1p5_4b_reduced"
    base = ["--arch", LM_ARCH, "--reduced", "--engine", "scan", "--q", "4",
            "--ckpt", str(path)]
    reset_launches(kerns)
    first = train_cli.main(base + ["--steps", "8", "--ckpt-shards", "2"])
    second = train_cli.main(base + ["--steps", "12", "--resume"])
    counts = launch_counts(kerns)
    check_counts("train-ckpt-serve training", counts, {
        "storm_update": 2 * 12, "adafbio_update": 12 + 3,
        "quantize_stoch": 0, "dequantize": 0})
    if (first["step"], second["step"]) != (8, 12):
        raise AssertionError(f"train-ckpt-serve: steps {first['step']}, "
                             f"{second['step']}")
    cfg = reduced(get_arch(LM_ARCH))
    params, info = load_serve_params(path, cfg, device="cuda")
    want = tree_mean_axis0(second["states"])
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(params), tree_leaves({"x": want["x"], "y": want["y"]})))
    done = serve_cli.main(["--arch", LM_ARCH, "--reduced", "--ckpt",
                           str(path), "--requests", "4", "--max-len", "64",
                           "--prompt-lens", "8,16,32"])
    rids = sorted(c.rid for c in done)
    # the population CLI, dense and with --spill host: the same files
    pop = ["--arch", LM_ARCH, "--reduced", "--steps", "8", "--q", "4",
           "--population", "4", "--cohort", "2", "--ckpt-shards", "2"]
    reset_launches(kerns)
    dense = train_cli.main(pop + ["--ckpt", str(ckdir / "pop_dense")])
    spilled = train_cli.main(pop + ["--spill", "host", "--ckpt",
                                    str(ckdir / "pop_spill")])
    pop_counts = launch_counts(kerns)
    check_counts("train-ckpt-serve population", pop_counts, {
        "storm_update": 2 * 2 * 8, "adafbio_update": 2 * (8 + 2),
        "quantize_stoch": 0, "dequantize": 0})
    add_counts(counts, pop_counts)
    pinned = all(t.is_pinned() for t in tree_leaves(spilled["spill"].rows))
    files = same_checkpoint_files(ckdir / "pop_dense", ckdir / "pop_spill")
    print(f"train-ckpt-serve: trained to step {second['step']} (resumed at "
          f"8), bridge layout {info['layout']} step {info['step']}, params "
          f"equal to the saved client mean {same}; served "
          f"{len(done)} requests {rids}; the population CLI (N 4, C 2, 2 "
          f"shards) dense and --spill host (bank pinned {pinned}): "
          f"{len(files)} files {files} equal bit for bit, wire "
          f"{dense['bytes_up']}/{dense['bytes_down']} and "
          f"{spilled['bytes_up']}/{spilled['bytes_down']}", flush=True)
    shutil.rmtree(ckdir, ignore_errors=True)
    if not same or info["step"] != 12:
        raise AssertionError("train-ckpt-serve: the bridge's params are not "
                             "the saved state's client mean")
    if rids != list(range(4)):
        raise AssertionError(f"train-ckpt-serve: served {rids}, want each "
                             f"of 4 requests once")
    if not pinned or (dense["bytes_up"], dense["bytes_down"]) != (
            spilled["bytes_up"], spilled["bytes_down"]):
        raise AssertionError("train-ckpt-serve: the spilled bank is not "
                             "pinned, or its wire bytes differ")
    return counts


def same_checkpoint_files(a, b):
    """The files of two checkpoints (``<path>.json``, ``.npz`` and
    ``.shard{k}.npz``) hold the same sidecar and the same arrays, name,
    dtype and bits; returns the suffixes compared (raises on a
    difference)."""
    import numpy as np
    suffixes = sorted(p.name[len(a.name):] for p in a.parent.glob(
        a.name + ".*"))
    other = sorted(p.name[len(b.name):] for p in b.parent.glob(
        b.name + ".*"))
    if suffixes != other or ".json" not in suffixes:
        raise AssertionError(f"checkpoint files {suffixes} against {other}")
    for suf in suffixes:
        fa, fb = Path(f"{a}{suf}"), Path(f"{b}{suf}")
        if suf == ".json":
            if json.loads(fa.read_text()) != json.loads(fb.read_text()):
                raise AssertionError(f"checkpoint sidecars differ: {suf}")
            continue
        za, zb = np.load(fa), np.load(fb)
        if sorted(za.files) != sorted(zb.files) or any(
                za[k].dtype != zb[k].dtype or not np.array_equal(za[k], zb[k])
                for k in za.files):
            raise AssertionError(f"checkpoint arrays differ in {suf}")
    return suffixes


# ------------------------------------------------------------ LM rounds

class DrawsOn:
    """A :class:`repro_torch.fed.population.DelayDraws` whose draws are made
    on the host and handed to ``device``: the card and CPU runs of the
    parity checks then see the same delays."""

    def __init__(self, torch, seed, device):
        from repro_torch.fed.population import DelayDraws
        self.host, self.device = DelayDraws(seed, "cpu"), torch.device(device)

    def randint(self, *a):
        return self.host.randint(*a).to(self.device)

    def uniform(self, *a):
        return self.host.uniform(*a).to(self.device)

    def normal(self, *a):
        return self.host.normal(*a).to(self.device)

    def permutation(self, *a):
        return self.host.permutation(*a).to(self.device)


def lm_rounds(torch, kerns, cfg, mode, n, c, seq, codec="none",
              rounds=LM_ROUNDS, device="cuda", draw_dev="cuda", params=None,
              seed=0, batch=LM_ROUND_BATCH, fed_kw=None):
    """``rounds`` rounds of the LM trainer's ``mode`` (population, async or
    gossip) builder on ``cfg``: FedConfig as the train launcher's (with
    ``fed_kw`` over it), the global ``batch`` split over the cohort as
    ``client_batch_specs`` splits it, every draw (data, cohorts, depths,
    codec noise, delays) made on ``draw_dev`` from ``seed`` and handed to
    ``device``. Checks each round's invariants (broadcast: every bank row
    equals the sync's client state bit for bit, ``last_sync`` r + 1, the
    server's t q + 1 a round; async: no client in flight dispatched again;
    gossip: every adafbio launch on per-node accumulators), the exact
    launch counts (from after the init), finite leaves and the bytes
    against ``wire_costs``. Returns the final state, the counts, ms a
    round, peak GB and the bytes."""
    from repro_torch import device as devlib
    from repro_torch.configs import FedConfig, ShapeConfig
    from repro_torch.core.tree_util import tree_leaves, tree_map, tree_stack
    from repro_torch.data.synthetic import (FederatedLMData, TorchLMDraws,
                                            make_client_batch,
                                            make_cohort_batch)
    from repro_torch.fed.compress import CodecNoise
    from repro_torch.fed.population import make_delay_model
    from repro_torch.fed.runtime import (FederatedTrainer, NeumannDraws,
                                         client_batch_specs, round_depths)
    from repro_torch.fed.sampling import UniformSampler
    from repro_torch.kernels import ops
    from repro_torch.launch.train import PARAM_SALT, wire_costs
    from repro_torch.models.params import TensorSpec

    dev = torch.device(device)
    fed = FedConfig(**{**LM_FED, **(fed_kw or {})}, codec=codec,
                    error_feedback=True)
    q = fed.q
    tr = FederatedTrainer(cfg, fed, ShapeConfig("cli", seq, batch, "train"),
                          device=dev)
    specs_c = client_batch_specs(cfg, tr.shape, c, fed)
    specs_n = {k: TensorSpec((n,) + tuple(v.shape[1:]), v.dtype)
               for k, v in specs_c.items()}
    data = FederatedLMData(vocab=cfg.vocab, n_clients=n,
                           draws=TorchLMDraws(seed, draw_dev))
    depths = NeumannDraws(seed, fed.neumann_k, n, draw_dev)
    noise = CodecNoise(seed, draw_dev)
    sampler = UniformSampler(n, c, seed)
    syncs, copy_s = [], []
    if mode == "population":
        # the sync's client state for the broadcast check, kept on the host:
        # off the card's peak, and the copy's seconds off the round's clock
        real_alg = tr.alg

        def sync_kept_on_host(s, a, m):
            out = real_alg.sync_update(s, a, m)
            devlib.fence(dev)
            t0 = time.time()
            syncs.append(tree_map(lambda t: t.to("cpu"), out[0]))
            copy_s.append(time.time() - t0)
            return out
        tr.alg = dataclasses.replace(real_alg, sync_update=sync_kept_on_host)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    if params is None:
        params = tr.init_params(devlib.generator(dev, seed, PARAM_SALT))
    batch0 = make_client_batch(data, cfg, specs_n, 0, dev)
    k0 = depths.init().to(dev)
    ef = srv_bank = state = None
    if mode == "population":
        bank, last_sync, server = tr.init_population_states(params, batch0,
                                                            k0)
        ef = tr.init_ef_bank(n)
        round_fn = tr.population_round_fn(n)
    elif mode == "async":
        dm = make_delay_model("tiers", 8)
        draws = DrawsOn(torch, seed, dev)
        dm = dm.resolve(draws, n)
        state = tr.init_async_population_states(params, batch0, k0)
        round_fn = tr.async_population_round_fn(
            n, sync_mode="participants", staleness_decay=0.5,
            max_staleness=4, max_delay=8, delay_eta=0.5, delay_model=dm,
            delay_draws=draws)
    else:
        bank, srv_bank = tr.init_gossip_states(params, batch0, k0)
        ef = tr.init_ef_bank(n)
        round_fn = tr.gossip_round_fn(n, topology="ring")
        agg = tr.gossip_aggregator(n, topology="ring")
    del params, batch0
    msg_b, down_b = wire_costs(tr, n)
    bytes_up = bytes_down = 0
    record, hist, per_row, ms = [], [], [], []
    real_ada = ops.adafbio_update_leaves

    def counting(p, w, a, lr_eta, rho):
        per_row.append(all(ai.shape == pi.shape for pi, ai in zip(p, a)))
        return real_ada(p, w, a, lr_eta, rho)

    reset_launches(kerns)
    ops.adafbio_update_leaves = counting
    try:
        for r in range(rounds):
            ids_host = (torch.arange(n) if mode == "gossip"
                        else sampler.cohort(r))
            ids = ids_host.to(dev)
            if mode == "gossip":
                batch_q = tree_stack([make_client_batch(
                    data, cfg, specs_n, r * q + j, dev) for j in range(q)])
            else:
                batch_q = tree_stack([make_cohort_batch(
                    data, cfg, specs_c, r * q + j, ids_host, dev)
                    for j in range(q)])
            k_q = round_depths(depths, r, q, ids_host.to(draw_dev)).to(dev)
            u = None
            if codec == "int8":
                src = noise(r, ids_host.to(draw_dev))
                u = lambda i, size, src=src: src(i, size).to(dev)
            devlib.fence(dev)
            r0 = time.time()
            if mode == "population":
                if codec == "none":
                    bank, last_sync, server = round_fn(
                        bank, last_sync, server, ids, batch_q, k_q, r)
                else:
                    bank, last_sync, ef, server = round_fn(
                        bank, last_sync, ef, server, ids, batch_q, k_q, r,
                        u)
            elif mode == "async":
                before = {k: state[k].clone() for k in (
                    "in_flight", "dispatch_round", "return_round")}
                state, stats = round_fn(state, ids, batch_q, k_q, r, u)
                record.append((r, ids.cpu(), {k: v.cpu() for k, v in
                                              before.items()},
                               {k: state[k].cpu() for k in before}))
            else:
                bank, srv_bank, ef = round_fn(bank, srv_bank, ef, batch_q,
                                              k_q, r, u, sync_first=r > 0)
            devlib.fence(dev)
            ms.append((time.time() - r0 - sum(copy_s)) * 1e3)
            copy_s.clear()
            del batch_q
            if mode == "population":
                new = dict(named_leaves(syncs.pop()))
                for name, row in named_leaves(bank):
                    want = new.pop(name).to(dev)
                    for i in range(n):
                        if not torch.equal(row[i], want):
                            raise AssertionError(
                                f"lm population round {r}: bank row {i} "
                                f"{name} differs from the sync's state")
                    del want
                del new
                if (last_sync != r + 1).any() or int(server["t"]) != (
                        q + 1) * (r + 1):
                    raise AssertionError(f"lm population round {r}: "
                                         f"last_sync {last_sync.tolist()}, "
                                         f"t {int(server['t'])}")
                bytes_up += int(torch.unique(ids_host).numel()) * msg_b
                bytes_down += n * down_b
            elif mode == "async":
                host = {k: v.cpu() for k, v in stats.items()}
                hist += [int(t) for t in host["staleness"] if t >= 0]
                bytes_up += int(host["arrived"]) * msg_b
                bytes_down += int(host["synced"]) * down_b
            elif r > 0:
                up, down = agg.wire_round(msg_b, down_b, edges=agg.edges(0))
                bytes_up += up
                bytes_down += down
    finally:
        ops.adafbio_update_leaves = real_ada
        if mode == "population":
            tr.alg = real_alg
    counts = launch_counts(kerns)
    peak = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" \
        else float("nan")
    final = (state if mode == "async" else
             {"bank": bank, "ef": ef, **({"server": server,
                                          "last_sync": last_sync}
                                         if mode == "population" else
                                         {"srv_bank": srv_bank})})
    leaves = tree_leaves(final["bank"])
    n_leaves = len(leaves)
    steps = rounds * q
    syncs_n = rounds - 1 if mode == "gossip" else rounds
    want = {"storm_update": 2 * steps, "adafbio_update": steps + syncs_n,
            "quantize_stoch": n_leaves * rounds if codec == "int8" else 0,
            "dequantize": n_leaves * rounds if codec == "int8" else 0}
    if dev.type == "cuda":
        check_counts(f"lm {mode}", counts, want)
        if mode == "gossip" and not (len(per_row) == want[
                "adafbio_update"] and all(per_row)):
            raise AssertionError(f"lm gossip: {sum(per_row)} of "
                                 f"{len(per_row)} adafbio launches per-node")
    busy = check_no_redispatch(record) if mode == "async" else 0
    bad = [name for name, t in named_leaves(final)
           if t is not None and t.is_floating_point()
           and not bool(torch.isfinite(t).all())]
    if bad:
        raise AssertionError(f"lm {mode}: non-finite leaves {bad}")
    check_wire(f"lm {mode}", leaves, codec, msg_b)
    return dict(final=final, counts=counts, ms=ms, peak_gb=peak,
                bytes=(bytes_up, bytes_down), msg_b=msg_b, down_b=down_b,
                hist=hist, busy=busy, n_leaves=n_leaves)


def check_wire(what, leaves, codec, msg_b):
    """The uplink message's bytes against the pricing's own formula, leaf
    by leaf over the bank's [N, ...] leaves (codec none or int8)."""
    sizes = [math.prod(t.shape[1:]) for t in leaves]
    want = (sum(s + 4 for s in sizes) if codec == "int8" else
            sum(math.prod(t.shape[1:]) * t.element_size() for t in leaves))
    if msg_b != want:
        raise AssertionError(f"{what}: wire_costs {msg_b}, the formula "
                             f"{want}")


def lm_depth_cfg(layers):
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(LM_ARCH), n_layers=layers)


def lm_rounds_phase(torch, kerns, name, spec, keep=False):
    """One of the LM rounds phases at qwen1.5-4b's full width, under the
    cut rule: at seq 512 first; where the peak passes LM_PEAK_GB (or the
    card runs out of memory), seq 256, then 2 layers. Prints the round
    times, the peak and the cut; returns the launch counts and the cut
    (with ``keep``, the final state too, copied to the host leaf by
    leaf)."""
    mode, n, c, layers, codec = (spec[k] for k in ("mode", "n", "c",
                                                   "layers", "codec"))
    rounds, seed = spec.get("rounds", LM_ROUNDS), spec.get("seed", 0)
    cuts = [(LM_ROUND_SEQ, layers), (LM_ROUND_SEQ // 2, layers)]
    if layers > 2:
        cuts.append((LM_ROUND_SEQ // 2, 2))
    tried = []
    for seq, depth in cuts:
        free_device_memory(torch)
        err = None
        try:
            out = lm_rounds(torch, kerns, lm_depth_cfg(depth), mode, n, c,
                            seq, codec, rounds=rounds, seed=seed)
        except torch.cuda.OutOfMemoryError as e:
            err = str(e).splitlines()[0]
        if err is None and out["peak_gb"] <= LM_PEAK_GB:
            break
        tried.append(f"seq {seq} L {depth}: " + (
            f"out of memory ({err})" if err else
            f"peak {out['peak_gb']:.2f} GB"))
        out = None
    else:
        raise AssertionError(f"{name}: nothing fits: {tried}")
    up, down = out["bytes"]
    extra = ""
    if mode == "async":
        extra = (f"; accepted staleness {sorted(out['hist'])}, "
                 f"{out['busy']} cohort slots found their client in flight")
        if not out["hist"] or not out["busy"]:
            raise AssertionError(f"{name}: no accepted arrival or no busy "
                                 f"slot, so the async checks saw nothing")
    print(f"{name}: N {n}, C {c}, codec {codec}, seq {seq}, {depth} layers "
          f"(cut: {'; '.join(tried) or 'none beyond the depth'}), "
          f"{rounds} rounds of q {LM_FED['q']}: "
          f"{[round(x, 2) for x in out['ms']]} ms a round, peak "
          f"{out['peak_gb']:.2f} GB; launches {out['counts']}; "
          f"{out['n_leaves']} leaves; wire totals ({codec}): bytes_up={up} "
          f"bytes_down={down} (message {out['msg_b']} B, downlink "
          f"{out['down_b']} B){extra}", flush=True)
    counts = out["counts"]
    run = dict(seq=seq, layers=depth, cut=tried, peak_gb=out["peak_gb"])
    if keep:
        run["final"] = to_host(torch, out["final"])
    del out
    free_device_memory(torch)
    return counts, run


# ------------------------------------------------------------ host spill

def host_mem_total():
    """The host's MemTotal in bytes (``/proc/meminfo``)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) * 1024
    raise AssertionError("no MemTotal in /proc/meminfo")


def spill_row_bytes(cfg):
    """One client row's bytes (x, y, v and w at the arch's dtype)."""
    from repro_torch.configs import FedConfig, ShapeConfig
    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.fed.runtime import FederatedTrainer
    tr = FederatedTrainer(cfg, FedConfig(**LM_FED), ShapeConfig(
        "cli", LM_ROUND_SEQ, LM_ROUND_BATCH, "train"), device="cuda")
    return sum(math.prod(s.shape) * s.dtype.itemsize
               for s in tree_leaves(tr.abstract_population_states(1)))


def check_rows_equal(torch, bank, want, what):
    """Every row of the bank's dense view equal, leaf by leaf on the host,
    to the client state ``want`` (on the card) bit for bit."""
    got = dict(named_leaves(bank.lazy_leaves()))
    for name, leaf in named_leaves(want):
        rows, w = got.pop(name).fetch(0, bank.n), leaf.cpu()
        for i in range(bank.n):
            if not torch.equal(rows[i], w):
                raise AssertionError(f"{what}: bank row {i} {name} differs "
                                     f"from the sync's state")
        del rows, w
    if got:
        raise AssertionError(f"{what}: leaves {sorted(got)} not in the state")


def lm_spill_rounds(torch, kerns, cfg, n, c, seq, codec="none",
                    rounds=LM_ROUNDS, seed=0, batch=LM_ROUND_BATCH):
    """``rounds`` rounds of the host-spill population on ``cfg``: the
    trainer's row-by-row init into a pinned ``HostSpillBank``, its
    ``cohort_round_fn``, the host write-back and the next cohort
    prefetched, as the launcher's ``run_population_spill`` runs them, with
    :func:`lm_rounds`' FedConfig, shape and draws (so with its seed a
    spilled run replays :func:`lm_rounds`' population run). Each round is
    timed in four parts on the host's clock, each closed by a fence (the
    gather, the round program, the broadcast with the EF scatter, the
    prefetch's issue); the progress line's work and the next round's
    batches run between the prefetch and the gather, as in the launcher.
    Checks ``last_sync``, the server's counter and finite leaves every
    round, every row against the sync's state after the last round (the
    base and the stale rows), then the exact launches and the wire bytes.
    Returns the banks, the server, the counts, the parts' ms, the
    transfer rates and the peak."""
    from repro_torch import device as devlib
    from repro_torch.configs import FedConfig, ShapeConfig
    from repro_torch.core.tree_util import tree_leaves, tree_stack
    from repro_torch.data.synthetic import (FederatedLMData, TorchLMDraws,
                                            make_client_batch,
                                            make_cohort_batch)
    from repro_torch.fed.compress import CodecNoise
    from repro_torch.fed.runtime import (FederatedTrainer, NeumannDraws,
                                         client_batch_specs, round_depths)
    from repro_torch.fed.sampling import UniformSampler
    from repro_torch.launch.train import PARAM_SALT, wire_costs
    from repro_torch.models.params import TensorSpec

    dev = torch.device("cuda")
    fed = FedConfig(**LM_FED, codec=codec, error_feedback=True)
    q = fed.q
    tr = FederatedTrainer(cfg, fed, ShapeConfig("cli", seq, batch, "train"),
                          device=dev)
    specs_c = client_batch_specs(cfg, tr.shape, c, fed)
    specs_n = {k: TensorSpec((n,) + tuple(v.shape[1:]), v.dtype)
               for k, v in specs_c.items()}
    data = FederatedLMData(vocab=cfg.vocab, n_clients=n,
                           draws=TorchLMDraws(seed, dev))
    depths = NeumannDraws(seed, fed.neumann_k, n, dev)
    noise = CodecNoise(seed, dev)
    sampler = UniformSampler(n, c, seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = tr.init_params(devlib.generator(dev, seed, PARAM_SALT))
    batch0 = make_client_batch(data, cfg, specs_n, 0, dev)
    bank, last_sync, server = tr.init_spilled_population_states(
        params, batch0, depths.init())
    ef = tr.init_spilled_ef_bank(n)
    del params, batch0
    devlib.fence(dev)
    init_s = time.time() - t0
    round_fn = tr.cohort_round_fn(n)
    msg_b, down_b = wire_costs(tr, n)
    bytes_up = bytes_down = 0
    parts = []
    reset_launches(kerns)
    ids_host = sampler.cohort(0)
    for r in range(rounds):
        ids = ids_host.to(dev)
        batch_q = tree_stack([make_cohort_batch(
            data, cfg, specs_c, r * q + j, ids_host, dev) for j in range(q)])
        k_q = round_depths(depths, r, q, ids)
        u = noise(r, ids) if codec == "int8" else None
        devlib.fence(dev)
        ms = {}
        t0 = time.time()
        cur = bank.gather(ids_host)
        ef_c = ef.gather(ids_host) if ef is not None else None
        ls_c = last_sync.index_select(0, ids_host.long()).to(dev)
        devlib.fence(dev)
        ms["gather"] = (time.time() - t0) * 1e3
        t0 = time.time()
        if codec == "none":
            new_client, server = round_fn(cur, ls_c, server, ids, batch_q,
                                          k_q, r)
        else:
            new_client, ef_c, server = round_fn(cur, ls_c, ef_c, server,
                                                ids, batch_q, k_q, r, u)
        devlib.fence(dev)
        ms["round"] = (time.time() - t0) * 1e3
        t0 = time.time()
        bank.broadcast(new_client)
        last_sync.fill_(r + 1)
        if ef is not None:
            ef.scatter(ids_host, ef_c)
        del ef_c
        ms["broadcast"] = (time.time() - t0) * 1e3
        del batch_q, cur
        if r == rounds - 1:          # after the base and the stale rows
            check_rows_equal(torch, bank, new_client, f"lm spill round {r}")
        bad = [name for name, t in named_leaves((new_client, server))
               if t.is_floating_point() and not bool(torch.isfinite(t).all())]
        if bad:
            raise AssertionError(f"lm spill round {r}: non-finite {bad}")
        if (last_sync != r + 1).any() or int(server["t"]) != (q + 1) * (
                r + 1):
            raise AssertionError(f"lm spill round {r}: last_sync "
                                 f"{last_sync.tolist()}, t "
                                 f"{int(server['t'])}")
        del new_client
        ms["prefetch"] = 0.0
        if r + 1 < rounds:
            ids_host = sampler.cohort(r + 1)
            t0 = time.time()
            bank.prefetch(ids_host)
            if ef is not None:
                ef.prefetch(ids_host)
            ms["prefetch"] = (time.time() - t0) * 1e3
        parts.append(ms)
        bytes_up += int(torch.unique(ids).numel()) * msg_b
        bytes_down += n * down_b
    counts = launch_counts(kerns)
    peak = torch.cuda.max_memory_allocated() / 1e9
    leaves = tree_leaves(bank.rows)
    steps = rounds * q
    check_counts("lm spill", counts, {
        "storm_update": 2 * steps, "adafbio_update": steps + rounds,
        "quantize_stoch": len(leaves) * rounds if codec == "int8" else 0,
        "dequantize": len(leaves) * rounds if codec == "int8" else 0})
    check_wire("lm spill", leaves, codec, msg_b)
    want_up = sum(int(torch.unique(sampler.cohort(r)).numel())
                  for r in range(rounds)) * msg_b
    if (bytes_up, bytes_down) != (want_up, rounds * n * down_b):
        raise AssertionError(f"lm spill: bytes {bytes_up}, {bytes_down}")
    if ef is not None:
        bad = [name for name, t in named_leaves(ef.materialize())
               if not bool(torch.isfinite(t).all())]
        if bad:
            raise AssertionError(f"lm spill: non-finite EF {bad}")
    row_b = bank.nbytes // n
    pinned = bank.nbytes + row_b + (ef.nbytes if ef is not None else 0)
    return dict(bank=bank, ef=ef, last_sync=last_sync, server=server,
                counts=counts, parts=parts, peak_gb=peak, init_s=init_s,
                pinned=pinned, row_b=row_b, msg_b=msg_b, down_b=down_b,
                bytes=(bytes_up, bytes_down), n_leaves=len(leaves))


def spill_rates(out, c):
    """H2D GB/s of round 0's gather (no prefetch before it: C rows of the
    bank and, with EF, of the EF bank) and D2H GB/s of the last round's
    broadcast (one row; base is allocated in round 0's)."""
    ef_row = out["ef"].nbytes // out["bank"].n if out["ef"] else 0
    h2d = c * (out["row_b"] + ef_row) / (out["parts"][0]["gather"] / 1e3)
    d2h = (out["row_b"] + c * ef_row) / (out["parts"][-1]["broadcast"] / 1e3)
    return h2d / 1e9, d2h / 1e9


def lm_spill_phase(torch, kerns):
    """lm-population-spill-qwen1.5-4b: qwen1.5-4b's population at full
    width and depth with the bank in pinned host memory (N SPILL_N, or
    SPILL_SMALL_N where SPILL_N + 1 rows exceed half the host's memory; C
    SPILL_C, codec none, LM_ROUNDS rounds) under SPILL_CUTS; then one round
    at SPILL_OTHER_N of N at the same cut, whose peak must lie within
    SPILL_PEAK_SAME of the first run's. Prints ms a round in parts, the
    transfer rates, whether the prefetch freed the next gather, the pinned
    bytes and the peak beside the dense bank's device bytes; returns the
    launch counts."""
    from repro_torch.configs import get_arch
    name = "lm-population-spill-qwen1.5-4b"
    full = get_arch(LM_ARCH).n_layers
    row_full, mem = spill_row_bytes(get_arch(LM_ARCH)), host_mem_total()
    n = SPILL_N if (SPILL_N + 1) * row_full <= mem / 2 else SPILL_SMALL_N
    why = (f"{SPILL_N + 1} rows of {row_full / 1e9:.2f} GB pinned "
           f"({(SPILL_N + 1) * row_full / 1e9:.1f} GB) "
           f"{'within' if n == SPILL_N else 'exceed'} half of MemTotal "
           f"{mem / 1e9:.1f} GB")
    print(f"{name}: N {n} ({why})", flush=True)
    tried = []
    for seq, layers in SPILL_CUTS:
        free_device_memory(torch)
        err = None
        t0 = time.time()
        try:
            out = lm_spill_rounds(torch, kerns, lm_depth_cfg(layers), n,
                                  SPILL_C, seq)
        except torch.cuda.OutOfMemoryError as e:
            err = str(e).splitlines()[0]
        if err is None and out["peak_gb"] <= LM_PEAK_GB:
            break
        tried.append(f"seq {seq} L {layers}: " + (
            f"out of memory ({err})" if err else
            f"peak {out['peak_gb']:.2f} GB"))
        out = None
    else:
        raise AssertionError(f"{name}: nothing fits: {tried}")
    secs = time.time() - t0
    h2d, d2h = spill_rates(out, SPILL_C)
    parts = [{k: round(v, 2) for k, v in p.items()} for p in out["parts"]]
    free_gather = out["parts"][-1]["gather"]
    print(f"{name}: N {n}, C {SPILL_C}, seq {seq}, {layers} of {full} "
          f"layers (cut: {'; '.join(tried) or 'none'}), {LM_ROUNDS} rounds "
          f"of q {LM_FED['q']}: ms a round by part {parts}; init "
          f"{out['init_s']:.2f} s (row by row, pinned); H2D "
          f"{h2d:.2f} GB/s (round 0's gather), D2H {d2h:.2f} GB/s (the "
          f"last broadcast); the prefetched gather {free_gather:.2f} ms "
          f"against {out['parts'][0]['gather']:.2f} ms without "
          f"({'free' if free_gather < 0.05 * out['parts'][0]['gather'] else 'not free'}); "
          f"pinned host {out['pinned'] / 1e9:.2f} GB; device peak "
          f"{out['peak_gb']:.2f} GB against a dense bank's "
          f"{n * out['row_b'] / 1e9:.2f} GB of device memory at N {n}; "
          f"launches {out['counts']}; wire totals (none): "
          f"bytes_up={out['bytes'][0]} bytes_down={out['bytes'][1]} "
          f"({secs:.1f} s)", flush=True)
    counts, peak = out["counts"], out["peak_gb"]
    del out
    free_device_memory(torch)
    other = SPILL_OTHER_N[n]
    t0 = time.time()
    out = lm_spill_rounds(torch, kerns, lm_depth_cfg(layers), other,
                          SPILL_C, seq, rounds=1)
    add_counts(counts, out["counts"])
    gap = abs(out["peak_gb"] - peak) * 1e9
    print(f"{name}: one round at N {other}, same cut: device peak "
          f"{out['peak_gb']:.2f} GB ({gap / 2 ** 30:.3f} GiB from N {n}'s; "
          f"a dense bank's {other * out['row_b'] / 1e9:.2f} GB at N "
          f"{other}), pinned host {out['pinned'] / 1e9:.2f} GB, ms by part "
          f"{[{k: round(v, 2) for k, v in p.items()} for p in out['parts']]} "
          f"({time.time() - t0:.1f} s)", flush=True)
    del out
    free_device_memory(torch)
    if gap > SPILL_PEAK_SAME_GIB * 2 ** 30:
        raise AssertionError(f"{name}: the device peak moved "
                             f"{gap / 2 ** 30:.3f} GiB between N {n} and "
                             f"N {other}")
    return counts


def lm_spill_int8_phase(torch, kerns, dense):
    """lm-population-spill-int8-qwen1.5-4b: the lm-population-int8 phase's
    spec and seed at its cut, spilled: the bank, the EF bank, last_sync
    and the server equal the dense phase's (``dense``, kept on the host)
    bit for bit, and the device peak is no higher. Returns the counts."""
    name = "lm-population-spill-int8-qwen1.5-4b"
    spec = dict(LM_ROUND_PHASES)["lm-population-int8-qwen1.5-4b"]
    free_device_memory(torch)
    t0 = time.time()
    out = lm_spill_rounds(torch, kerns, lm_depth_cfg(dense["layers"]),
                          spec["n"], spec["c"], dense["seq"], spec["codec"],
                          rounds=spec.get("rounds", LM_ROUNDS),
                          seed=spec.get("seed", 0))
    # leaf by leaf on the host: the banks' dense views one leaf at a time
    want = dict(named_leaves(dense["final"]))
    got = {"bank": out["bank"].lazy_leaves(), "ef": out["ef"].lazy_leaves(),
           "last_sync": out["last_sync"], "server": out["server"]}
    diff = []
    for k, a in named_leaves(got):
        a = a.fetch(0, a.shape[0]) if hasattr(a, "fetch") else a.cpu()
        if not torch.equal(a, want.pop(k)):
            diff.append(k)
        del a
    diff += sorted(want)             # leaves the spilled run lacks
    h2d, d2h = spill_rates(out, spec["c"])
    print(f"{name}: N {spec['n']}, C {spec['c']}, int8 + EF, seq "
          f"{dense['seq']}, {dense['layers']} layers: ms a round by part "
          f"{[{k: round(v, 2) for k, v in p.items()} for p in out['parts']]}; "
          f"H2D {h2d:.2f} GB/s, D2H {d2h:.2f} GB/s; device peak "
          f"{out['peak_gb']:.2f} GB against the dense phase's "
          f"{dense['peak_gb']:.2f} GB; pinned host {out['pinned'] / 1e9:.2f} "
          f"GB; bank, EF bank, last_sync and server equal to the dense "
          f"phase's bit for bit: {not diff}; launches {out['counts']} "
          f"({time.time() - t0:.1f} s)", flush=True)
    counts, peak = out["counts"], out["peak_gb"]
    del out, got
    free_device_memory(torch)
    if diff:
        raise AssertionError(f"{name}: differs from the dense phase at "
                             f"{diff[:8]}")
    if peak > dense["peak_gb"]:
        raise AssertionError(f"{name}: peak {peak:.2f} GB above the dense "
                             f"phase's {dense['peak_gb']:.2f}")
    return counts


class LevelReplay:
    """The int8 levels of one run, call by call: ``record`` keeps the
    levels of the plain run's quantize calls, ``replay`` hands them to the
    card run's calls in the same order (counting how many of the card's
    own levels sit apart, and by how much), so that a level one f32
    rounding put one step apart does not carry into the rest of the run,
    as the CPU tests replay the reference's levels."""

    def __init__(self, ops):
        self.ops, self.real = ops, ops.quantize_stoch
        self.levels, self.at, self.apart, self.worst, self.seen = [], 0, 0, 0, 0

    def record(self, *args):
        q = self.real(*args)
        self.levels.append(q.clone())
        return q

    def replay(self, *args):
        q = self.real(*args)
        want = self.levels[self.at].to(q.device)
        self.at += 1
        diff = (q.int() - want.int()).abs()
        self.apart += int((diff > 0).sum())
        self.worst = max(self.worst, int(diff.max()))
        self.seen += diff.numel()
        return want


def lm_rounds_parity(torch, kerns):
    """The LM rounds at reduced(qwen1.5-4b) in f32, on the CPU (the
    kernels' plain versions) and then on the card from the same params and
    draws, as the CPU tests run them against the reference (seq 32, batch
    2, q 2, rho 1e-2; K = 1, no bf16 feature cache): population int8 +
    EF, async, gossip int8 + EF, the card given the CPU's int8 levels
    (:class:`LevelReplay`). Every final leaf within the CPU tests'
    tolerance against the reference, normwise: LM_PARITY_REL for the
    state, LM_PARITY_EF_REL for the EF residuals."""
    from repro_torch import device as devlib
    from repro_torch.configs import FedConfig, ShapeConfig, get_arch, reduced
    from repro_torch.core.tree_util import tree_map
    from repro_torch.fed.runtime import FederatedTrainer
    from repro_torch.kernels import ops
    from repro_torch.launch.train import PARAM_SALT

    cfg = reduced(get_arch(LM_ARCH), dtype="float32")
    cpu_tr = FederatedTrainer(cfg, FedConfig(**LM_FED), ShapeConfig(
        "cli", 32, 2, "train"), device="cpu")
    params = cpu_tr.init_params(devlib.generator("cpu", 1, PARAM_SALT))
    for mode, n, c, codec in (("population", 4, 2, "int8"),
                              ("async", 4, 2, "none"),
                              ("gossip", 4, 4, "int8")):
        runs, levels = {}, LevelReplay(ops)
        for dev, tap in (("cpu", levels.record), ("cuda", levels.replay)):
            reset_launches(kerns)
            ops.quantize_stoch = tap
            try:
                runs[dev] = lm_rounds(
                    torch, kerns, cfg, mode, n, c, 32, codec,
                    rounds=3 if mode == "async" else 2, device=dev,
                    draw_dev="cpu", seed=1, batch=2, fed_kw=LM_PARITY_FED,
                    params=tree_map(lambda t: t.to(dev), params))["final"]
            finally:
                ops.quantize_stoch = levels.real
        worst = {"state": 0.0, "ef": 0.0}
        for (name, a), (_, b) in zip(named_leaves(runs["cuda"]),
                                     named_leaves(runs["cpu"])):
            if a is None or not a.is_floating_point():
                continue
            group = "ef" if name.startswith("ef/") else "state"
            worst[group] = max(worst[group], rel_err(torch, a, b))
        print(f"lm-rounds parity at reduced {LM_ARCH} (f32, K 1), {mode} "
              f"{codec}: card vs CPU worst normwise rel err state "
              f"{worst['state']:.3e} (limit {LM_PARITY_REL[mode]}), EF "
              f"{worst['ef']:.3e} (limit {LM_PARITY_EF_REL}); int8 levels "
              f"replayed: {levels.apart} of {levels.seen} apart, by at most "
              f"{levels.worst}", flush=True)
        if not (worst["state"] <= LM_PARITY_REL[mode]
                and worst["ef"] <= LM_PARITY_EF_REL and levels.worst <= 1):
            raise AssertionError(f"lm {mode}: card and CPU disagree")


def codec_route_check(torch, qkern, ref):
    """The leaf route against the packed route at qwen1.5-4b's full width,
    bit for bit, on a subtree where the packed route fits (the final norm,
    one layer's leaves and the embedding; one client, int8 + EF), the
    packed route given the per-leaf noise concatenated; then the quantize
    pair timed at the embedding leaf [1, 388,956,160]. Returns rows 3-4's
    numbers."""
    from repro_torch.core.tree_util import (tree_map, tree_pack_stacked,
                                            tree_unpack_stacked)
    from repro_torch.fed import compress
    from repro_torch.kernels import ops
    from repro_torch.models import model_specs
    from repro_torch.models.params import torch_dtype

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    specs = model_specs(lm_depth_cfg(1))
    sub = {"embed": specs["x"]["embed"], "final_norm": specs["y"][
        "final_norm"], "layer": specs["x"]["layers"]}

    def draw(s, scale):
        t = torch.randn((1,) + tuple(s.shape), generator=gen, device=dev)
        return (t * scale).to(torch_dtype(s.dtype or "bfloat16"))
    ref_t = tree_map(lambda s: draw(s, 0.02), sub)
    cur = tree_map(lambda a: (a.float() + 1e-3 * torch.randn(
        a.shape, generator=gen, device=dev)).to(a.dtype), ref_t)
    ef = tree_map(lambda a: 1e-4 * torch.randn(a.shape, generator=gen,
                                                device=dev), ref_t)
    codec = compress.make_codec("int8")
    u = compress.CodecNoise(0, dev)(0, torch.zeros(1, dtype=torch.long,
                                                   device=dev))
    reset_launches((qkern,))
    recon, ef_new = compress.client_messages(codec, ref_t, cur, ef, u)
    leaf_launches = dict(qkern.launches)
    # the packed route: one [1, n] f32 buffer, one launch pair over every
    # leaf segment
    fl_ref, spec = tree_pack_stacked(ref_t)
    delta = tree_pack_stacked(cur, spec)[0] - fl_ref
    delta = delta + tree_pack_stacked(ef, spec)[0]
    sizes = [math.prod(s) for s in spec.shapes]
    offsets = [0]
    for size in sizes:
        offsets.append(offsets[-1] + size)
    u_all = torch.cat([u(i, size) for i, size in enumerate(sizes)], dim=1)
    table = torch.tensor(offsets, dtype=torch.int64, device=dev)
    scale = ops.leaf_scales(delta, offsets, codec.qmax)
    sent = qkern.dequantize(qkern.quantize_stoch(delta, u_all, scale, table,
                                                 codec.qmax), scale, table)
    del u_all
    want_recon = tree_unpack_stacked(fl_ref + sent, spec)
    want_ef = tree_unpack_stacked(delta - sent, spec.with_dtype(
        torch.float32))
    del fl_ref, delta, sent
    same = all(bits(torch, a).equal(bits(torch, b)) for a, b in zip(
        [t for _, t in named_leaves((recon, ef_new))],
        [t for _, t in named_leaves((want_recon, want_ef))]))
    print(f"codec leaf route vs packed route at full width ({len(sizes)} "
          f"leaves, {sum(sizes):,} elements, the embedding "
          f"{sizes[0]:,}): bit-equal {same}; leaf route launches "
          f"{leaf_launches}", flush=True)
    if not same or leaf_launches != {"quantize_stoch": len(sizes),
                                     "dequantize": len(sizes)}:
        raise AssertionError("the codec's leaf route differs from the "
                             "packed route")
    del recon, ef_new, want_recon, want_ef, ref_t, cur, ef
    # the quantize pair at the embedding leaf, as the int8 LM phase runs it
    n = sizes[0]
    x = torch.randn((1, n), generator=gen, device=dev)
    uu = torch.rand((1, n), generator=gen, device=dev)
    t2 = torch.tensor([0, n], dtype=torch.int64, device=dev)
    sc = ops.leaf_scales(x, (0, n), codec.qmax)
    qq = qkern.quantize_stoch(x, uu, sc, t2, codec.qmax)
    exact = (torch.equal(qq, ref.quantize_stoch_ref(x, uu, sc, t2,
                                                    codec.qmax))
             and bits(torch, qkern.dequantize(qq, sc, t2)).equal(
                 bits(torch, ref.dequantize_ref(qq, sc, t2))))
    if not exact:
        raise AssertionError("quantize pair differs from its plain "
                             "version at the embedding leaf")
    # one segment: a single PyTorch call dequantizes (int8 times the [1, 1]
    # f32 scale promotes to f32 and rounds once, as the kernel does)
    library = lambda: torch.mul(qq, sc)
    if not bits(torch, library()).equal(bits(torch, qkern.dequantize(
            qq, sc, t2))):
        raise AssertionError("torch.mul differs from the dequantize kernel "
                             "at the embedding leaf")
    out = {}
    for name, fast, plain, nbytes in (
            ("quantize_stoch",
             lambda: qkern.quantize_stoch(x, uu, sc, t2, codec.qmax),
             lambda: ref.quantize_stoch_ref(x, uu, sc, t2, codec.qmax),
             9 * n),
            ("dequantize", lambda: qkern.dequantize(qq, sc, t2),
             lambda: ref.dequantize_ref(qq, sc, t2), 5 * n)):
        nbytes += 4 + 16
        out[name] = dict(ms=time_ms(torch, fast), plain_ms=time_ms(
            torch, plain, reps=5), bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            max_abs_err=0.0, elements=n, library_ms=(
                time_ms(torch, library) if name == "dequantize" else None))
        lib = ("" if out[name]["library_ms"] is None else
               f" torch.mul {out[name]['library_ms']:.4f} ms")
        print(f"kernel {name:15s} embedding leaf [1, {n}]: kernel "
              f"{out[name]['ms']:.4f} ms plain {out[name]['plain_ms']:.4f} "
              f"ms{lib} bound {out[name]['bound_ms']:.4f} ms (bit-exact)",
              flush=True)
    del x, uu, qq
    free_device_memory(torch)
    return out


def adafbio_phases(torch, kern, qkern, ref, ops):
    """Phases 3-9: the update and codec kernels against their plain
    versions, then the federated paths; returns the kernels' numbers and
    the paths' launch counts. The tasks they build are freed on return."""
    kerns = (kern, qkern)
    segments = message_segments(mnist_width())
    if sum(segments) != MSG_ELEMENTS or len(segments) != MSG_LEAVES:
        raise AssertionError(f"message segments {segments}")
    numbers = kernel_phase(torch, kern, ref)
    numbers.update(quantize_phase(torch, qkern, ref, ops, segments))
    launches, task, cfg = main_path(torch, kerns)
    codec_launches = codec_path(torch, kerns, task, cfg)
    pop_launches = population_path(torch, kerns, cfg)
    for name in ("quantize_stoch", "dequantize"):
        launches[name] = codec_launches[name] + pop_launches[name]
    broadcast_vs_masked(torch, task, cfg)
    topk_run(torch, task, cfg)
    # the slice-6 paths (hyper-cleaning, async, gossip), each counted alone
    for counts in (hyperclean_path(torch, kerns), async_path(torch, kerns),
                   gossip_path(torch, kerns, task, cfg)):
        add_counts(launches, counts)
    round_checks(torch, task, cfg)
    quadratic(torch)
    return numbers, launches


START = time.time()


def free_device_memory(torch):
    gc.collect()
    torch.cuda.empty_cache()
    gib = 2 ** 30
    print(f"device memory allocated {torch.cuda.memory_allocated() / gib:.2f} "
          f"GiB, reserved {torch.cuda.memory_reserved() / gib:.2f} GiB "
          f"(at {time.time() - START:.1f} s)", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    print(gpu_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as fkern
    from repro_torch.kernels import mamba_scan as mk
    from repro_torch.kernels import quant_decode as qd
    from repro_torch.kernels import quantize as qkern
    from repro_torch.kernels import storm_update as kern

    t0 = time.time()
    libs = _build.build_all()
    nvcc_s = ", ".join(f"{n} {t:.2f} s" for n, t in
                       sorted(_build.build_seconds.items()))
    print(f"built {sorted(libs)} in {time.time() - t0:.2f} s (nvcc, one "
          f"process a source, in parallel: {nvcc_s or 'none; all built'})",
          flush=True)
    hgmma = hgmma_count(_build, libs["flash_attention_sm90"])
    print(f"flash_attention_sm90: {hgmma} HGMMA instructions in its SASS",
          flush=True)
    if hgmma == 0:
        raise AssertionError("the bf16 flash kernel has no wgmma (HGMMA)")

    numbers, launches = adafbio_phases(torch, kern, qkern, ref, ops)
    free_device_memory(torch)
    # rows 1-2 of the kernels line: the leaf-table entry on this slice's
    # main path (qwen1.5-4b's x tree), the packed entry at the MNIST shape
    # beside it
    for name, row in leaf_table_phase(torch, kern, ref).items():
        packed = numbers[name]
        numbers[name] = {**{f"packed_{k}": packed[k] for k in (
            "ms", "plain_ms", "bound_ms", "max_abs_err")},
            **{k: v for k, v in packed.items() if k.startswith("per_row_")},
            **row}
    lm_counts, lm = lm_train_phase(torch, (kern, qkern),
                                   lm_depth_cfg(LM_TRAIN_LAYERS))
    add_counts(launches, lm_counts)
    for name, ms in lm["kernel_ms"].items():
        numbers[name]["lm_step_ms"] = ms
    free_device_memory(torch)
    # the ssm and hybrid families' trainers (ROADMAP 1h)
    add_counts(launches, lm_family_phase(
        torch, (kern, qkern), HYBRID_ARCH, HYBRID_DEPTHS,
        LM_STEPS))
    add_counts(launches, lm_family_phase(torch, (kern, qkern), SSM_ARCH,
                                         FALCON_DEPTHS, FALCON_STEPS))
    lm_family_parity(torch, (kern, qkern))
    remat_check(torch)
    add_counts(launches, train_ckpt_serve_phase(torch, (kern, qkern)))
    free_device_memory(torch)
    for name, spec in LM_ROUND_PHASES:
        keep = name == "lm-population-int8-qwen1.5-4b"
        counts, run = lm_rounds_phase(torch, (kern, qkern), name, spec,
                                      keep=keep)
        add_counts(launches, counts)
        if keep:
            dense_int8 = run
    # the host-spill bank (ROADMAP 2c): the int8 phase spilled, then the
    # population at full depth
    add_counts(launches, lm_spill_int8_phase(torch, (kern, qkern),
                                             dense_int8))
    del dense_int8
    add_counts(launches, lm_spill_phase(torch, (kern, qkern)))
    lm_rounds_parity(torch, (kern, qkern))
    # rows 3-4 of the kernels line: the codec's per-leaf launch at the
    # embedding leaf (this slice's path), the packed message at the MNIST
    # shape beside it
    for name, row in codec_route_check(torch, qkern, ref).items():
        packed = numbers[name]
        numbers[name] = {**{f"packed_{k}": packed[k] for k in (
            "ms", "plain_ms", "bound_ms", "max_abs_err")}, **row}
    free_device_memory(torch)
    numbers.update(flash_phase(torch, fkern, ref))
    numbers.update(quant_decode_phase(torch, qd, ref))
    numbers.update(mamba_scan_phase(torch, mk, ref))
    free_device_memory(torch)
    kerns = (kern, qkern, fkern, qd, mk)
    counts, cfg, params, reqs = serve_path(
        torch, kerns, SERVE_ARCH, SERVE_LOAD, True,
        attention_serve_expect)
    add_counts(launches, counts)
    serve_check(torch, cfg, params, reqs)
    del params
    free_device_memory(torch)
    counts, cfg, params, reqs = serve_path(
        torch, kerns, SSM_ARCH, SERVE_LOAD, False,
        lambda cfg, admissions, ticks: {
            "mamba_scan": cfg.n_layers * admissions})
    add_counts(launches, counts)
    ssm_check(torch, ref, cfg, params, reqs)
    del params
    free_device_memory(torch)
    counts, cfg, params, reqs = serve_path(
        torch, kerns, HYBRID_ARCH, HYBRID_LOAD, False,
        lambda cfg, admissions, ticks: {
            "flash_attention": (cfg.n_layers // cfg.shared_attn_every)
            * admissions})
    add_counts(launches, counts)
    hybrid_check(torch, ref, cfg, params, reqs)
    del params
    free_device_memory(torch)
    # the MoE and vlm slice (ROADMAP 1a and 1b)
    add_counts(launches, moe_vlm_phases(torch, kerns))
    # the encdec slice and the LM trainer's baselines (ROADMAP 1c with 1i)
    add_counts(launches, encdec_phases(torch, kerns))

    kernels = [{
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": launches[name],
        "max_abs_err": numbers[name]["max_abs_err"],
        "ms": numbers[name]["ms"], "plain_ms": numbers[name]["plain_ms"],
        "bound_ms": numbers[name]["bound_ms"],
        "bound_by": numbers[name].get("bound_by", "bytes"),
        "library_ms": numbers[name].get("library_ms"),
        **{k: v for k, v in numbers[name].items()
           if k in ("cold_ms", "elements", "lm_step_ms")
           or k.startswith(("per_row_", "packed_"))}}
        for name in SOURCES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
