#!/usr/bin/env python3
"""Chip smoke for the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --kernels-only  # phases 1-2: build, check, time

Phases (any failure raises and exits nonzero; no phase catches its own):
  1. device and build: the card's name and power limit (nvidia-smi), then
     the ten CUDA kernels built from the nine sources in
     ``src/repro_torch/kernels/csrc`` with nvcc, one process per source,
     all started together; ptxas's registers and spills, and for each
     instantiation of flash_attention's two kernels, of the tensor-core
     FFN core (ffn_tc.cuh, in swiglu, moe_gmm and moe_gather, by row rule)
     and of mla_paged_decode's kernels (the tensor-core split kernel of
     mla_tc.cuh, its merge, the SIMT kernel) a ``[tensor cores]`` line
     with its registers, spills and the count of HGMMA (wgmma)
     instructions in the library's SASS (cuobjdump): a tensor-core
     instantiation with no HGMMA, or with spills, fails the run;
  2. each kernel against its plain PyTorch version on the card at the shapes
     of its path, in float32 (|err| <= 1e-4 max|ref|) and bfloat16 (|err|
     <= 2e-2 max|ref|; sentinel rows of moe_gather exactly zero;
     paged_attn_decode and mla_paged_decode on fragmented tables, rows
     sharing a lane, all-trash padding rows and depths that are not a
     multiple of the block size, paged_attn_decode also at grp 1 and 4 and
     a window that masks whole leading blocks, and on its split-KV core
     over views of several 256-key chunks: pos at and around the chunk
     edges, a window that kills the leading chunks, granite's 48 query
     heads per kv head of 128, hd 256, llama4's 5 query heads on 8 kv
     heads of 128 (also timed at its engine's decode shape); both
     kernels with rows at pos -1,
     every key masked: the view's mean; mla_paged_decode with each call
     checked to run the route mla_route names, bfloat16 at r 512 / dr 64
     on the tensor cores, 12 heads in a padded M tile and views of several
     1024-key chunks with pos at and around the chunk edges and -1), then
     timed with CUDA events
     in bfloat16 beside its plain version, a PyTorch yardstick (library_ms,
     null where no one PyTorch call computes the function) and its bound
     on the card; moe_gmm_ragged and moe_gather also at deepseek-v2's
     expert shapes (moe_gather also at the widest mixed step), with a
     gather row, the ragged row of the same (token, expert) and moe_gmm's
     capacity row held bitwise equal there; the four FFN kernels, which
     have a tensor-core kernel for bfloat16 and the SIMT one for float32,
     with each call checked to run the kernel its route names, and timed
     on both (at qwen's shapes also as calls replayed from a CUDA graph);
  3. the static path at the full width of qwen1.5-0.5b (24 layers, seeded
     random weights): (a) in float32 the kernel path against the plain path
     on one converted model (prefill logits within 1e-3 max|logit|, greedy
     tokens compared), (b) in bfloat16 through the serving CLI's entry
     point (convert S3A3E8, prefill 4 x 32, decode 16 tokens), with every
     kernel's launch count zeroed just before and read just after; between
     them path B, the CMoE router's fused scoring: ops.router_score on
     every layer of (a)'s converted model, on the layer's captured FFN
     input over the calibration batch (4 x 128 tokens), counts zeroed just
     before and read just after (24 launches), each layer held against the
     plain version and core.router.router_scores, the gate's top-k ids
     compared token by token;
  4. the continuous-batching engine at the same width in bfloat16: first
     each dense product of the engine (and the norm) is checked bitwise
     width-invariant on the card (a row alone and inside every width the
     engine runs), at qwen1.5-0.5b's and deepseek-v2's shapes, and
     the four FFN kernels on the tensor cores up to 512 rows (tokens, for
     the routed experts), and at qwen's and deepseek's expert widths a
     (token, expert) pair's row bitwise the same through moe_gather,
     moe_gmm_ragged and moe_gmm; then two
     runs through the CLI's entry point (overlapped + paged, with parity
     replays: sequential, contiguous, and in the second run prefix reuse
     off), with the launch counts zeroed before and read after; every
     request done, streams identical, zero dropped pairs, a clean pool
     audit, prefix hits in the second run;
  5. deepseek-v2-236b at its published widths (MLA with r 512, 128 heads,
     160 experts top-6 with 2 shared, vocab 102400), cut only in depth:
     (a) float32, 2 layers: the kernel path against the plain path through
     Model.step on a paged cache, a prefill chunk then 4 decode steps
     (logits within 1e-3 max|logit| at every step, greedy tokens compared);
     (b) bfloat16, 4 layers, the static path through the CLI's entry point
     (prefill 4 x 32, 16 generated); (c) bfloat16, 4 layers, the engine
     through the CLI's entry point (the phase 4 arguments without
     conversion: overlapped + paged, with parity replays), launch counts
     zeroed before (b) and before (c) and read after each; path A, the
     bounded-buffer routed-expert path (moe_gate -> assign_positions ->
     dispatch -> expert_ffn, i.e. ops.moe_gmm -> combine), after (a) on its
     float32 model and after (c) on the engine's bfloat16 model: the last
     layer's captured FFN input over 4 x 32 tokens with its own router, at
     C = the largest expert load (no drops, equal to the exact oracle) and
     a quarter of it (drops equal to the loads past C, kept pairs equal to
     the oracle masked by keep), counts zeroed before and read after;
     (d) the hierarchical CMoE of deepseek-v2 (each routed expert split
     into 3 shared and 5 routed sub-experts of m' 192 with its own
     sub-router, top-3: S3A3E8), bfloat16, 2 layers: one expert's
     conversion time on the host, and 8 partitions on the conversion's
     thread pool bitwise equal to the serial loop's; the unconverted
     static path (the reference logits), then the CLI's static path
     with --cmoe S3A3E8, converting once on the CLI's 4 x 128 calibration
     batch (backends grouped_kernel / gather on the tensor cores; counts
     zeroed before and read after); the same converted params with all 5
     routed sub-experts active against the unconverted prefill logits
     (within DS_HIER_ALL_ACTIVE_TOL of max|logit|); the device time of a
     converted prefill and decode step by kernel (torch.profiler); layer
     0's hierarchical FFN bitwise the same for a token alone and among
     DS_MIXED_TOKENS tokens at decode and on a fused step, and with and
     without dead outer rows re-aimed at the sentinel; moe_gmm_ragged and
     moe_gather on the inputs that FFN gives them at a 4 x 32 prefill and
     a 4-token decode (800 sub-experts of 5120 x 192), against their
     plain versions and timed beside bounds that count live rows; then
     the engine (serve_continuous, the phase 4 engine flags) on the
     converted model, counts zeroed before and read after;
     (e) llama4-maverick-400b-a17b at its published widths (40 query heads
     on 8 kv heads of 128, 128 experts of 8192 top-1 with a shared expert,
     dense layers of d_ff 8192, vocab 202048), bfloat16, cut to one period
     (a dense and an MoE layer): the CLI's static path (prefill 4 x 64,
     past the break-even of 128 tokens, so moe_gmm_ragged runs beside
     swiglu_ffn and moe_gather; the reference logits), the device time of
     its prefill and decode step by kernel, its three FFN kernels on the
     inputs the path gives them against their plain versions and timed,
     then the engine (phase 4's engine flags, paged_attn_decode at 5 query
     heads a kv head); then the CLI's static path with --cmoe S3A3E8
     (640 routed sub-experts of m' 1024, the dense layer left dense; the
     peak device memory after init, conversion and serving), all 5 routed
     sub-experts active against the reference logits (within
     DS_HIER_ALL_ACTIVE_TOL of max|logit|), the same trace and FFN checks
     as (d) on the converted MoE layer, and the engine; launch counts
     zeroed before each of the four runs and read after;
  6. the SSM family at full published width and depth: (a) float32, for
     mamba2-370m and zamba2-1.2b, the kernel path against the plain path
     on one set of weights: Model.forward on 2 x 1024 tokens, then a 4 x 32
     prefill from a fresh cache and 4 decode steps (logits within 1e-3
     max|logit| everywhere, greedy tokens compared); (b) mamba2-370m and
     (c) zamba2-1.2b in bfloat16 through the CLI's static entry point
     (prefill 4 x 32, 16 generated), launch counts zeroed before each and
     read after: ssd_scan once per layer per prefill, and zamba2's shared
     block's swiglu_ffn once per application per prefill and decode step;
  7. the attention pair at llama2-7b's published widths (32 heads of 128),
     depth cut to 2 layers, once in float32 and once in bfloat16, through
     the reference's entry points ops.flash_attention and ops.flash_decode
     (neither has a model caller, so none is added), launch counts zeroed
     before and read after: (a) layer 0's q, k, v of a 1 x 4096 prompt
     (gqa_project_qkv and apply_rope), causal against the plain version
     and the port's chunked_attention, non-causal with T = 4096 - 37, and a
     causal call at the static main path's shape (4 x 32 tokens, 16 heads
     of 64), the float32 calls on the SIMT kernel and the bfloat16 ones on
     the tensor cores; (b) Model.prefill of 4 x 1024 tokens into a
     contiguous cache of 1100, one Model.decode_step, then layer 0's cache
     and the step's post-RoPE query (BH 128, T 1100, pos 1024) against the
     plain version and decode_attention, both calls on the split-KV
     core (flash_decode.route); tolerances as in phase 2;
  8. the last decoder-only archs at their published widths (DENSE_ARCHS):
     phi3-medium-14b (all 40 layers) and gemma3-4b (all 34: GEGLU, hd 256
     with 1024-token windows on 5 layers of 6, a tied 262144-row head),
     granite-34b (GELU 2-matrix FFN, 48 query heads on one kv head) and
     internvl2-26b (the VLM family) cut to 8 layers; for each: (a) float32
     at 2 layers, the kernel path against the plain path through
     Model.step on a paged cache, a prefill chunk (internvl2's carries 256
     random patch embeddings before 32 text tokens) and 4 decode steps
     (logits within 1e-3 max|logit| at every step); (b) bfloat16, the
     CLI's static path unconverted (prefill 4 x 32, 16 generated), with
     swiglu_ffn (phi3, gemma3) and paged_attn_decode (the decode step of a
     paged cache 64 tokens deep, also timed in a CUDA graph: granite's
     group of 48) on the inputs the path gives them against their plain
     versions; (c) the same with --cmoe S3A3E8 (conversion seconds, peak
     memory after init, conversion and serving), the device time of a
     converted prefill and decode step by kernel (phi3, gemma3, granite),
     the share of a converted decode step that gemma3's float32 LM head
     and granite's plain non-GLU gather take, and moe_gmm_ragged and
     moe_gather on their inputs (phi3, gemma3); (d) the engine on the
     converted model with phase 4's engine flags; launch counts zeroed
     before each run and read after: granite launches no GLU-only FFN
     kernel, the others all three, and every engine paged_attn_decode;
  9. whisper-small (the enc-dec family) at its published widths and depth,
     through the model's entry points (the CLI has no audio path, as the
     reference's has none): (a) float32 at 2 encoder and 2 decoder
     layers, the card against the port on the CPU on one set of weights, a
     prefill of 2 x 24 tokens over 1500 frames and 4 greedy steps (logits
     within 1e-3 max|logit|, tokens equal); (b) bfloat16, 12 + 12 layers,
     frames (4, 1500, 768) N(0, 1) and 4 x 32 prompts, 16 generated: the
     peak after init, the encoder alone and the prefill (medians of 5
     warm), decode tok/s, the encoder and a decode step by kernel
     (torch.profiler); (c) the
     S3A3E8 conversion of the decoder's FFNs on the CLI's 4 x 128
     calibration tokens plus frames (profile and cluster seconds; its peak
     held to its calibration forward's plus two layers' FFN and the taps;
     enc_blocks bitwise unchanged; backends grouped_plain / gather), the
     converted path as in (b), and the converted weights with every routed
     expert active against (b)'s prefill logits (within
     DS_HIER_ALL_ACTIVE_TOL); launch counts zeroed before each run and read
     after: no kernel runs on whisper's path, as no Pallas kernel runs on
     the reference's;
 10. training (the reference's training path runs no Pallas kernel, so
     the launch counts, zeroed at the start, must all be 0 at the end):
     (a) qwen1.5-0.5b whole in bfloat16 with its kernels off, batches of
     8 x 256 from ShardedLoader, layer remat, make_train_step (AdamW, f32
     moments), in deterministic mode: one Model.loss gradient with every
     parameter leaf reached, then 6 straight steps; 3 steps, an async
     checkpoint of params, moments and loader position, a restore into a
     new manager and loader, and 3 more steps, bitwise the straight run's
     params and both moments; loss, grad norm, the median warm step and
     tokens/s, the peak after init and during training, the step's time
     with the deterministic mode off, and one step's device time by
     kernel (torch.profiler); (b) the CLIs at full width:
     train.main for 2 steps, then --steps 4 --resume auto (restores step
     2 and the loader, runs steps 2-3 with finite losses), and
     convert.main --cmoe S3A3E8 restored leaf for leaf bitwise the
     in-memory conversion of the same seed; (c) 3 train steps on that
     converted model at 4 x 128 (cmoe.u's gradient non-zero in all 24
     layers, moe_load (24, N_r), apply_balance_update moving each bias
     by 0 or +-gamma) and LoRA at rank 8, alpha 32 (B = 0 merges bitwise to the
     base loss; one AdamW step on the adapters alone lowers the loss on
     the same batch); (d) float32 at 2 layers, TF32 off, the loss and
     every gradient leaf on the card against the port on the CPU (|dloss|
     <= 1e-5 relative, max|dg| <= 1e-4 max|g| a leaf).
Each phase prints its seconds (``[seconds]``).
The ``[routes]`` lines of phases 3a, 3b, 4, 5 (5a, path A, 5b-5e), 6 and 8
count which kernel each launch of the four FFN kernels and of
mla_paged_decode ran: every bfloat16 launch on the tensor cores, every
float32 one on the SIMT kernel (phase 7 checks half and half), or the run
fails.
Phase 2 checks swiglu_ffn at T 512 in float32 and bfloat16 and, in
bfloat16, at T 1, 4, 100 and 512 at qwen1.5-0.5b's and zamba2-1.2b's widths
(swiglu and geglu); it times it at T 512 (also the SIMT kernel on the same
bfloat16 inputs and in float32, and the kernel and its yardstick as 50
calls replayed from one CUDA graph) and at zamba2-1.2b's decode (T 4, d
2048, f 8192) on both kernels.
Phase 2 also holds ssd_scan against its plain version (float32, and bf16
inputs, |err| <= 1e-4 max|ref|: the arithmetic is float32 in both) at
mamba2's prefill shape from a zero and a random state, a length that is
not a multiple of the kernel's chunk, 2 x 2048 from a zero and a random
state, a ragged 1000 tokens from a random state and zamba2's widths, and
each of its three passes against its plain pass at 2 x 2048 and 1000
tokens, and times it at the prefill shape (also as calls replayed from
one CUDA graph); moe_gmm at C = 8, 1,
70 and 130 and at deepseek-v2's expert widths (E 160, d 5120, m 1536, C =
8, where it is timed, beside the SIMT kernel in bfloat16 and float32; in
bfloat16 also at C 1, 8, 70 and 130 on 4 of those experts), and
router_score at d 1024 / N_r 5 and d 4096 /
N_r 5 and 13 for T of 1, 4, 128, 512 and 100 (timed at T 512, d 1024,
N_r 5, also in a CUDA graph), each in float32 and bfloat16 with the
tolerances above; mla_paged_decode timed at MLA_MAIN and
MLA_LONG back to back and in a CUDA graph, with each CUDA kernel's device
time (torch.profiler: the split and merge kernels apart);
flash_attention at D 16, 64, 128 and 256 with S and T off the tiles, causal
S > T, a non-causal ragged T and the static main path's shape, and in
bfloat16 (the tensor-core route) at D 64, 128 and 256 with S and T off its
128-row and K/V tiles: causal S > T and S < T, a non-causal ragged T, S =
1, T = 1 and more than one wave of blocks, each call checked to run the
kernel that flash_attention.route names (timed at llama2-7b's causal
prefill, BH 32, S = T = 4096, D 128, and at D 64 and 256 at the same BH,
S and T, each beside scaled_dot_product_attention), and flash_decode at D
16 to 256 with pos 0, T - 1, >= T and < 0, on views of several 256-key
chunks (pos at and around the chunk edges) and at D 6 (the SIMT kernel),
each call checked to run the kernel flash_decode.route names (timed at
phase 7's decode shape and a full 4096 cache, beside
scaled_dot_product_attention with a boolean mask, back to back and in a
CUDA graph; paged_attn_decode too is timed in a graph). Before
each SSM model and phase 7 the memory still allocated is printed before
and after a garbage collection.
Prints the kernels JSON line, then ``{"ok": true, "device": {...}}`` last.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

# cuBLAS is deterministic only with a fixed workspace, which has to be set
# before torch starts CUDA (phase 10's bitwise resume runs in
# deterministic mode)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 and TF32 tensor cores,
# fp32 FMA outside them, and HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# the kernels with a tensor-core route for bfloat16 and a SIMT one for
# float32, whose [routes] lines count both: the GLU-FFN cores (ffn_tc.cuh,
# ffn_core.cuh) and mla_paged_decode (mla_tc.cuh, mla_paged.cu)
ROUTED_KERNELS = ("swiglu_ffn", "moe_gmm_ragged", "moe_gather", "moe_gmm",
                  "mla_paged_decode")

ARCH = "qwen1.5-0.5b"
CMOE = "S3A3E8"
BATCH, PROMPT, GEN = 4, 32, 16
CALIB_ROWS = 4 * 128
L2_BYTES = 50e6

# the engine's main path (phase 4) and its second, prefix-sharing run
ENGINE_ARGS = ["--arch", ARCH, "--cmoe", CMOE, "--continuous", "--paged",
               "--batch", "4", "--requests", "8", "--rate", "0.5",
               "--prompt-len", "64", "--gen", "16",
               "--max-prefill-tokens", "32", "--block-size", "16",
               "--parity", "--seed", "0"]
PREFIX_ARGS = ["--prefix-groups", "32", "--prefix-reuse"]
# paged_attn_decode at the engine's decode shape (qwen1.5-0.5b is MHA) and
# at a long context
PAGED_MAIN = dict(rows=4, kh=16, grp=1, hd=64, bs=16, depth=80)
PAGED_LONG = dict(rows=32, kh=16, grp=1, hd=64, bs=16, depth=2048)

# deepseek-v2-236b (phase 5): published widths, depth cut to fit one card
DS_ARCH = "deepseek-v2-236b"
DS_F32_LAYERS = 2          # float32: 15.9 GB a layer + 4.2 GB of embeddings
DS_LAYERS = 4              # bfloat16: 7.94 GB a layer + 2.10 GB
DS_STATIC_ARGS = ["--arch", DS_ARCH, "--layers", str(DS_LAYERS),
                  "--batch", str(BATCH), "--prompt-len", str(PROMPT),
                  "--gen", str(GEN), "--seed", "0"]
DS_ENGINE_ARGS = ["--arch", DS_ARCH, "--layers", str(DS_LAYERS)] + \
    ENGINE_ARGS[ENGINE_ARGS.index("--continuous"):]
# the widest fused step the engine sends to gather at deepseek-v2: its
# break-even, E / k = 160 / 6 tokens (core.experts.select_backend)
DS_MIXED_TOKENS = 26
# the hierarchical CMoE of deepseek-v2 (phase 5d): bfloat16, depth cut to 2
# layers (15.1 GB of expert banks; the conversion holds one more layer's);
# S3A3E8 splits each 1536-neuron expert into 8 of m' 192: 3 shared, 5
# routed, top-3 (800 routed sub-experts a layer)
DS_HIER_LAYERS = 2
DS_HIER_CMOE = "S3A3E8"
DS_HIER_ARGS = ["--arch", DS_ARCH, "--layers", str(DS_HIER_LAYERS),
                "--batch", str(BATCH), "--prompt-len", str(PROMPT),
                "--gen", str(GEN), "--seed", "0"]
# all 5 routed sub-experts active against the unconverted model's prefill
# logits, relative to max|logit|: the same neurons, but the shared and
# routed parts' outputs each rounded to bfloat16 before they are summed
DS_HIER_ALL_ACTIVE_TOL = 3e-2
# llama4-maverick-400b-a17b (phase 5e): published widths (d_model 5120, 40
# query heads on 8 kv heads of 128, 128 experts of 8192 top-1 with a shared
# expert of 8192, dense layers of d_ff 8192, vocab 202048), bfloat16, depth
# cut to one period (a dense and an MoE layer; 32.2 GB of expert banks, the
# conversion holds a copy of them). The static prefill is 4 x 64 tokens:
# past the unconverted break-even E / k = 128 tokens, so moe_gmm_ragged
# runs there as well as in the calibration forward; the converted model's
# inner pass crosses its own (640 sub-experts at top-3) at any prefill
L4_ARCH = "llama4-maverick-400b-a17b"
L4_LAYERS = 2
L4_PROMPT = 64
L4_CMOE = "S3A3E8"
L4_ARGS = ["--arch", L4_ARCH, "--layers", str(L4_LAYERS), "--batch",
           str(BATCH), "--prompt-len", str(L4_PROMPT), "--gen", str(GEN),
           "--seed", "0"]
# paged_attn_decode at llama4's engine decode shape (5 query heads a kv head)
PAGED_LLAMA4 = dict(rows=4, kh=8, grp=5, hd=128, bs=16, depth=80)
# the most tiles of a routed kernel's layout held against the plain version
# on llama4's banks (the plain version copies each tile's three expert
# slabs to float32, 503 MB a tile unconverted)
L4_CHECK_TILES = 24
# the last decoder-only archs (phase 8), each at its published widths in
# bfloat16 through phase 3b's static shapes and phase 4's engine flags,
# unconverted and converted to DENSE_CMOE: (arch, short key, layers; None
# keeps the published depth). phi3-medium-14b (40 layers, 29.3 GB) and
# gemma3-4b (34, 7.8 GB, a tied 262144-row head) run whole; granite-34b
# (88 layers of 0.76 GB) and internvl2-26b (48 of 0.78 GB) are cut to 8
# layers for time
DENSE_ARCHS = (("phi3-medium-14b", "phi3", None),
               ("gemma3-4b", "gemma3", None),
               ("granite-34b", "granite", 8),
               ("internvl2-26b", "internvl2", 8))
DENSE_CMOE = "S3A3E8"
DENSE_F32_LAYERS = 2
# internvl2's published patch count: its float32 prefill carries this many
# random patch embeddings in place of its first positions, then PROMPT
# text tokens
VLM_PATCHES = 256
# the depth of the paged decode step whose paged_attn_decode inputs phase 8
# checks and times: the engine's longest prompt (ENGINE_ARGS --prompt-len)
PAGED_STEP_DEPTH = 64
# gemma3's second paged decode step, past its 1024-token sliding window, so
# the window masks keys on the local layer the check reads
WINDOW_STEP_DEPTH = 1100
# whisper-small (phase 9), the enc-dec family at its published widths and
# depth (12 encoder and 12 decoder layers, 1500 frames; 0.56 GB in
# bfloat16); its float32 check against the CPU at 2 + 2 layers
WHISPER = "whisper-small"
WHISPER_F32_LAYERS = 2
WHISPER_F32_BATCH, WHISPER_F32_PROMPT, WHISPER_F32_STEPS = 2, 24, 4
WHISPER_CMOE = "S3A3E8"
# timed runs of the encoder and of the prefill after a warm one (median)
WHISPER_REPEATS = 5
# phase 10: training qwen1.5-0.5b (ARCH) whole in bfloat16; TRAIN_STRAIGHT
# steps straight, against half of them, a checkpoint and the other half
TRAIN_BATCH, TRAIN_SEQ = 8, 256
TRAIN_STRAIGHT = 6
TRAIN_SCHEDULE = dict(lr=3e-4, warmup=2, total=TRAIN_STRAIGHT)
TRAIN_CLI_ARGS = ["--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                  "--log-every", "1", "--seed", "0"]
# 10c: the converted model's routed experts run grouped_plain's slab
# copies, ~13 s a step at 8 x 256 on a slow host; its checks need no width
TRAIN_CONVERTED_STEPS, TRAIN_CONVERTED_BATCH = 3, (4, 128)
BALANCE_GAMMA = 1e-3
LORA_RANK, LORA_ALPHA, LORA_LR = 8, 32.0, 1e-3
# 10d: float32 at 2 layers, 2 x 64 tokens, card against the CPU
TRAIN_F32_LAYERS, TRAIN_F32_TOKENS = 2, (2, 64)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-5, 1e-4
# mla_paged_decode at the engine's decode shape and at a long context
# (r = kv_lora_rank, dr = qk_rope_head_dim, scale (dn + dr)^-0.5)
MLA_MAIN = dict(rows=4, heads=128, r=512, dr=64, bs=16, depth=80)
MLA_LONG = dict(rows=32, heads=128, r=512, dr=64, bs=16, depth=2048)
MLA_SCALE = (128 + 64) ** -0.5

# swiglu_ffn's widths: qwen1.5-0.5b's dense FFN (d, f), timed at the
# calibration forward (CALIB_ROWS tokens), and zamba2-1.2b's shared block at
# a decode step of the static path
QWEN_FFN = (1024, 2816)
ZAMBA_DECODE = dict(t=BATCH, d=2048, f=8192)
# moe_gmm's timed shape: deepseek-v2's experts at a static prefill's
# capacity (4 x 32 tokens, top-6 of 160: 4.8 rows an expert on average);
# router_score's: the converted qwen1.5-0.5b's calibration batch
GMM_C = 8
ROUTER_MAIN = (4 * 128, 1024, 5)

# the SSM family (phase 6): full published width and depth, one card
SSM_ARCHS = ("mamba2-370m", "zamba2-1.2b")
SSM_FWD = (2, 1024)        # Model.forward batch x tokens (phase 6a)
# ssd_scan at mamba2-370m's static prefill (4 x 32, 32 heads of 64, state
# 128), and at a long forward and zamba2-1.2b's widths (64 heads, state 64)
SSD_MAIN = dict(b=BATCH, s=PROMPT, nh=32, hp=64, n=128)
SSD_LONG = dict(b=2, s=2048, nh=32, hp=64, n=128)
SSD_ZAMBA = dict(b=BATCH, s=PROMPT, nh=64, hp=64, n=64)
# ssd_scan's phase 2 cases from a random state past one chunk: a ragged
# 1000-token forward (the long shape is SSD_LONG)
SSD_RAGGED = dict(b=2, s=1000, nh=32, hp=64, n=128)
# the chunk ssd_work reckons the bound's FLOPs at: a constant of the
# function's yardstick, not the kernels' chunk (ssd_scan.kernel_chunk)
SSD_BOUND_CHUNK = 64
# TF32 tensor-core passes csrc/ssd_scan.cu runs for C B^T, the masked
# product M xw, and C h^T and the state update, by the itemsize of x, B
# and C (3xTF32 for an fp32 operand; bf16 B and C go in unsplit): the
# weights of ssd_work's second bound, at the TF32 rate
SSD_TC_PASSES = {2: (1, 3, 2), 4: (3, 3, 3)}

# the attention pair (phase 7): llama2-7b at its published widths (32 heads
# of 128), depth cut to 2 layers (only layer 0's attention is read); a
# 1 x 4096 prefill (llama2's context length) and a decode step after a
# 4 x 1024 prefill into a contiguous cache of 1100 (not a multiple of any
# tile)
LLAMA_ARCH = "llama2-7b"
LLAMA_LAYERS = 2
LLAMA_PREFILL = 4096
LLAMA_RAGGED = 37          # the non-causal call drops the last 37 keys
LLAMA_DECODE = dict(batch=4, prompt=1024, max_len=1100)
# timed shapes (bf16): flash_attention at llama2-7b's prefill, causal;
# flash_decode at phase 7's decode shape and at a full 4096 cache
FA_MAIN = dict(bh=32, s=4096, t=4096, d=128)
FD_MAIN = dict(bh=128, t=1100, d=128, pos=1024)
FD_LONG = dict(bh=128, t=4096, d=128, pos=4095)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def time_ms(fn, inputs: list, iters: int = 50) -> float:
    """Mean ms per call with CUDA events. Calls rotate over `inputs` (sets
    whose bytes together exceed L2), so each call finds its operands cold,
    as the next layer's call does on the main path."""
    import torch
    for i in range(3):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, inputs: list, iters: int = 50) -> float:
    """Mean ms per call of `iters` calls (rotating over `inputs`) captured
    in one CUDA graph and replayed: the device's time without the host's
    cost of each launch."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(*inputs[i % len(inputs)])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def routed(name: str, want: str, call):
    """call() with `name`'s route counts cleared; fails unless it ran the
    `want` kernel once. Returns what call() returned."""
    from repro_torch.kernels import ops
    ops.ROUTES[name].clear()
    out = call()
    if dict(ops.ROUTES[name]) != {want: 1}:
        raise AssertionError(f"{name}: routes {dict(ops.ROUTES[name])}, "
                             f"want {{{want!r}: 1}}")
    return out


def both_routes(name, sets, kernel, simt, plain, chain, b_ms, b_by,
                iters=50, graphs=True) -> dict:
    """Times one FFN kernel's two CUDA routes on the same bfloat16 sets
    (`kernel` through ops, which routes to the tensor cores; `simt`
    forced), its plain version and its PyTorch chain, back to back and
    (the kernel and the chain) as calls replayed from one CUDA graph, where
    back-to-back times are host-bound. Prints a [time] line; returns the
    record's timing keys."""
    ms = time_ms(kernel, sets, iters)
    simt_ms = time_ms(simt, sets, iters)
    plain_ms = time_ms(plain, sets, iters)
    lib_ms = time_ms(chain, sets, iters)
    out = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, simt_ms=simt_ms)
    in_graph = ["", ""]
    if graphs:
        out.update(graph_ms=graph_ms(kernel, sets, iters),
                   library_graph_ms=graph_ms(chain, sets, iters))
        in_graph = [f" ({out[key]:.4f} ms in a CUDA graph)"
                    for key in ("graph_ms", "library_graph_ms")]
    print(f"[time] {name} bf16: tensor cores {ms:.4f} ms{in_graph[0]}, SIMT "
          f"{simt_ms:.4f} ms, plain {plain_ms:.4f} ms, chain {lib_ms:.4f} "
          f"ms{in_graph[1]}, bound {b_ms:.4f} ms ({b_by})")
    return out


def check(name: str, got, ref, dtype, sentinel_rows=None) -> float:
    """Kernel against plain on the same inputs; returns max |err|."""
    import torch
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = (1e-4 if dtype == torch.float32 else 2e-2) * max(scale, 1e-30)
    if not (torch.isfinite(got).all() and err <= tol):
        raise AssertionError(f"{name} {dtype}: max|err| {err:.3e} > "
                             f"{tol:.3e} (max|ref| {scale:.3e})")
    if sentinel_rows is not None and got[sentinel_rows].abs().max() != 0:
        raise AssertionError(f"{name}: sentinel rows are not exactly zero")
    print(f"[check] {name} {str(dtype).split('.')[-1]}: max|err| {err:.3e} "
          f"(tol {tol:.3e})")
    return err


def bound(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def n_sets(nbytes: float) -> int:
    return max(2, min(16, math.ceil(2 * L2_BYTES / nbytes)))


def kernel_phase() -> dict:
    """Phase 2. Returns per-kernel records. Their launches stay None (no
    count was taken) until phase 3b fills them from the main path's run."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.experts import ragged_layout, ragged_scatter
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_gather import (moe_gather_cuda,
                                                moe_gather_plain, route)
    from repro_torch.kernels.moe_gmm import (moe_gmm_ragged_cuda,
                                             moe_gmm_ragged_plain)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    d, f = QWEN_FFN
    n_e, m, top_k = 5, f // 8, 3
    block = ops.ragged_block_c()

    def rnd(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def banks(dtype):
        return [rnd((n_e, d, m), dtype, d ** -0.5),
                rnd((n_e, d, m), dtype, d ** -0.5),
                rnd((n_e, m, d), dtype, m ** -0.5)]

    def gmm_set(dtype):
        t = BATCH * PROMPT
        ids = torch.randint(0, n_e, (t * top_k,), generator=g, device=dev)
        slot, owner, _, p_total = ragged_layout(ids, n_e, block)
        xp = ragged_scatter(rnd((t, d), dtype), top_k, slot, p_total)
        return [xp, owner] + banks(dtype)

    def gather_set(dtype, sentinels=False):
        ids = torch.randint(0, n_e, (BATCH * top_k,), generator=g,
                            device=dev).to(torch.int32)
        if sentinels:
            ids[1::4] = n_e
        return [rnd((BATCH, d), dtype), ids] + banks(dtype)

    records = {}
    act = "swiglu"

    records["swiglu_ffn"] = swiglu_phase(g, dev)

    # --- moe_gmm_ragged: routed experts at prefill (4 x 32 tokens, top-3)
    for dt in (torch.float32, torch.bfloat16):
        xp, owner, wg, wu, wd = gmm_set(dt)
        err = check("moe_gmm_ragged", routed(
            "moe_gmm_ragged", route(dt, d, m),
            lambda: ops.moe_gmm_ragged(xp, owner, wg, wu, wd, block_c=block)),
            moe_gmm_ragged_plain(xp, owner, wg, wu, wd, act, block), dt)
    live = BATCH * PROMPT * top_k
    nbytes = 2 * (3 * n_e * d * m + 2 * live * d)
    sets = [gmm_set(torch.bfloat16) for _ in range(n_sets(nbytes))]

    def gmm_kernel(xp, o, wg, wu, wd):
        return ops.moe_gmm_ragged(xp, o, wg, wu, wd, block_c=block)

    def gmm_library(xp, o, wg, wu, wd):
        own = o.long()
        xb = xp.reshape(-1, block, d)
        h = F.silu(torch.bmm(xb, wg[own])) * torch.bmm(xb, wu[own])
        return torch.bmm(h, wd[own])

    b_ms, b_by = bound(6 * live * d * m, nbytes, "bfloat16")
    records["moe_gmm_ragged"] = dict(
        name="moe_gmm_ragged", route="cuda",
        source="src/repro_torch/kernels/csrc/moe_gmm.cu",
        replaces="src/repro/kernels/moe_gmm.py:124", launches=None,
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by, dtype="bfloat16",
        shape=f"P={xp.shape[0]} live rows={live} E={n_e} d={d} m={m} "
              f"block_c={block}", kernel_route="tensor_core",
        **both_routes("moe_gmm_ragged", sets, gmm_kernel,
                      lambda *a: moe_gmm_ragged_cuda(*a, "swiglu", block,
                                                     path="simt"),
                      lambda *a: moe_gmm_ragged_plain(*a, act, block),
                      gmm_library, b_ms, b_by))

    # --- moe_gather: routed experts at decode (4 tokens, top-3)
    for dt in (torch.float32, torch.bfloat16):
        xf, ids, wg, wu, wd = gather_set(dt, sentinels=True)
        err = check("moe_gather", routed(
            "moe_gather", route(dt, d, m),
            lambda: ops.moe_gather(xf, ids, wg, wu, wd, top_k=top_k)),
            moe_gather_plain(xf, ids, wg, wu, wd, top_k=top_k),
            dt, sentinel_rows=ids == n_e)
    sets = [gather_set(torch.bfloat16) for _ in range(16)]
    distinct = sum(len(set(s[1].tolist())) for s in sets) / len(sets)
    nbytes = 2 * (3 * distinct * d * m + BATCH * d + BATCH * top_k * d)
    sets = sets[:n_sets(nbytes)]

    def gather_library(xf, i, wg, wu, wd):
        ids = i.long()
        xr = xf.repeat_interleave(top_k, dim=0)[:, None]
        h = F.silu(torch.bmm(xr, wg[ids])) * torch.bmm(xr, wu[ids])
        return torch.bmm(h, wd[ids])[:, 0]

    b_ms, b_by = bound(6 * BATCH * top_k * d * m, nbytes, "bfloat16")
    records["moe_gather"] = dict(
        name="moe_gather", route="cuda",
        source="src/repro_torch/kernels/csrc/moe_gather.cu",
        replaces="src/repro/kernels/moe_gather.py:100", launches=None,
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by, dtype="bfloat16",
        shape=f"rows={BATCH * top_k} E={n_e} d={d} m={m} "
              f"distinct experts~{distinct:.2f}", kernel_route="tensor_core",
        **both_routes("moe_gather", sets,
                      lambda xf, i, wg, wu, wd: ops.moe_gather(
                          xf, i, wg, wu, wd, top_k=top_k),
                      lambda *a: moe_gather_cuda(*a, top_k=top_k,
                                                 path="simt"),
                      lambda *a: moe_gather_plain(*a, top_k=top_k),
                      gather_library, b_ms, b_by))
    records["paged_attn_decode"] = paged_attn_phase(g, dev)
    records["mla_paged_decode"] = mla_phase(g, dev)
    records["ssd_scan"] = ssd_phase(g, dev)
    deepseek_expert_times(g, dev, records)
    records["moe_gmm"] = moe_gmm_phase(g, dev)
    records["router_score"] = router_score_phase(g, dev)
    records["flash_attention"] = flash_attention_phase(g, dev)
    records["flash_decode"] = flash_decode_phase(g, dev)
    for r in records.values():
        lib = "null" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        print(f"[time] {r['name']}: {r['ms']:.4f} ms (bound "
              f"{r['bound_ms']:.4f} ms, {r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, "
              f"library {lib}")
    return records


def swiglu_phase(g, dev) -> dict:
    """swiglu_ffn, the dense FFN of the calibration forward (T 512, d 1024,
    f 2816), against its plain version in float32 and bfloat16, each call
    checked to run the kernel swiglu.route names; in bfloat16 (the tensor-
    core route) also at T 1, 4, 100 and 512 at qwen1.5-0.5b's and zamba2-
    1.2b's widths, swiglu and geglu. Timed in bfloat16 at T 512 beside its
    plain version, the SIMT kernel on the same inputs and in float32, the
    F.silu + @ chain and its bound, as 50 back-to-back calls and (the
    kernel and the chain) as 50 calls replayed from one CUDA graph; and at
    zamba2-1.2b's decode (ZAMBA_DECODE) on both routes beside the chain."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.swiglu import (route, swiglu_ffn_cuda,
                                            swiglu_ffn_plain)

    bf = torch.bfloat16
    d, f = QWEN_FFN
    # the tensor-core checks and the zamba2 timing draw from their own
    # generator, so that g's draws (and every later phase 2 check) stay as
    # they were before those were added
    g_tc = torch.Generator(device=dev)
    g_tc.manual_seed(23)

    def swiglu_set(dtype, t=CALIB_ROWS, d=d, f=f, gen=g):
        def rnd(shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device=dev) *
                    scale).to(dtype)
        return [rnd((t, d)), rnd((d, f), d ** -0.5), rnd((d, f), d ** -0.5),
                rnd((f, d), f ** -0.5)]

    def checked(what, x, wg, wu, wd, activation="swiglu"):
        return check(f"swiglu_ffn {what}", routed(
            "swiglu_ffn", route(x.dtype, *wg.shape),
            lambda: ops.swiglu_ffn(x, wg, wu, wd, activation=activation)),
            swiglu_ffn_plain(x, wg, wu, wd, activation), x.dtype)

    def chain(x, wg, wu, wd):
        return (F.silu(x @ wg) * (x @ wu)) @ wd

    def simt(*a):
        return swiglu_ffn_cuda(*a, path="simt")

    for dt in (torch.float32, bf):
        err = checked(f"T={CALIB_ROWS} d={d} f={f}", *swiglu_set(dt))
    nbytes = 2 * (2 * CALIB_ROWS * d + 3 * d * f)
    sets = [swiglu_set(bf) for _ in range(n_sets(nbytes))]
    ms = time_ms(lambda x, wg, wu, wd: ops.swiglu_ffn(x, wg, wu, wd), sets)
    plain_ms = time_ms(lambda *a: swiglu_ffn_plain(*a), sets)
    lib_ms = time_ms(chain, sets)
    b_ms, b_by = bound(6 * CALIB_ROWS * d * f, nbytes, "bfloat16")
    simt_ms = time_ms(simt, sets)
    simt_f32_ms = time_ms(lambda *a: ops.swiglu_ffn(*a),
                          [[a.float() for a in s] for s in sets])
    g_ms = graph_ms(lambda x, wg, wu, wd: ops.swiglu_ffn(x, wg, wu, wd),
                    sets)
    lib_g_ms = graph_ms(chain, sets)
    print(f"[time] swiglu_ffn T={CALIB_ROWS} d={d} f={f} bf16: tensor cores "
          f"{ms:.4f} ms ({g_ms:.4f} ms in a CUDA graph), SIMT {simt_ms:.4f} "
          f"ms (float32 {simt_f32_ms:.4f} ms), chain {lib_ms:.4f} ms "
          f"({lib_g_ms:.4f} ms in a CUDA graph), bound {b_ms:.4f} ms "
          f"({b_by})")
    for dd, ff in (QWEN_FFN, (ZAMBA_DECODE["d"], ZAMBA_DECODE["f"])):
        for t in (1, 4, 100, 512):
            for a in ("swiglu", "geglu"):
                checked(f"tensor cores T={t} d={dd} f={ff} {a}",
                        *swiglu_set(bf, t, dd, ff, g_tc), activation=a)
    zt, zd, zf = ZAMBA_DECODE.values()
    z_bytes = 2 * (2 * zt * zd + 3 * zd * zf)
    zsets = [swiglu_set(bf, zt, zd, zf, g_tc) for _ in range(n_sets(z_bytes))]
    z_ms = time_ms(lambda x, wg, wu, wd: ops.swiglu_ffn(x, wg, wu, wd),
                   zsets)
    z_simt = time_ms(simt, zsets)
    z_lib = time_ms(chain, zsets)
    z_b, z_by = bound(6 * zt * zd * zf, z_bytes, "bfloat16")
    print(f"[time] swiglu_ffn zamba2-1.2b decode T={zt} d={zd} f={zf} bf16: "
          f"tensor cores {z_ms:.4f} ms, SIMT {z_simt:.4f} ms, chain "
          f"{z_lib:.4f} ms, bound {z_b:.4f} ms ({z_by})")
    return dict(
        name="swiglu_ffn", route="cuda",
        source="src/repro_torch/kernels/csrc/swiglu.cu",
        replaces="src/repro/kernels/swiglu.py:55", launches=None,
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, dtype="bfloat16",
        shape=f"T={CALIB_ROWS} d={d} f={f}", kernel_route="tensor_core",
        graph_ms=g_ms, library_graph_ms=lib_g_ms, simt_ms=simt_ms,
        simt_f32_ms=simt_f32_ms,
        zamba2_decode=dict(shape=f"T={zt} d={zd} f={zf}", ms=z_ms,
                           simt_ms=z_simt, library_ms=z_lib, bound_ms=z_b,
                           bound_by=z_by))


def paged_case(g, dev, dtype, *, rows, kh, grp, hd, bs, depth, share=False,
               trash_rows=0, at=None):
    """One paged_attn_decode input set: a pool with poisoned (large, finite)
    unused blocks, fragmented tables (a random permutation of physical
    blocks), positions spread around `depth` (or the list `at`, one a row:
    chunk edges, -1); `share` makes consecutive row pairs one lane at two
    positions, `trash_rows` appends padding rows whose tables are all trash
    (block 0)."""
    import torch
    nblk = -(-(depth + 1) // bs)
    nblocks = rows * nblk + 1
    k_pool = torch.randn((nblocks, bs, kh, hd), generator=g, device=dev)
    v_pool = torch.randn((nblocks, bs, kh, hd), generator=g, device=dev)
    perm = torch.randperm(nblocks - 1, generator=g, device=dev)[
        :rows * nblk] + 1
    table = perm.reshape(rows, nblk).to(torch.int32)
    pos = torch.randint(max(depth - 2 * bs, 0), depth + 1, (rows,),
                        generator=g, device=dev).to(torch.int32)
    if at is not None:
        pos = torch.tensor(at, dtype=torch.int32, device=dev)
    if share:
        odd = table[1::2].shape[0]
        table[1::2] = table[0::2][:odd]
        pos[1::2] = (pos[0::2][:odd] - 3).clamp(min=0)
    if trash_rows:
        table = torch.cat([table, table.new_zeros((trash_rows, nblk))])
        pos = torch.cat([pos, pos.new_zeros(trash_rows)])
    k_pool[0] = 1e4          # the trash block: finite garbage
    v_pool[0] = -1e4
    q = torch.randn((table.shape[0], 1, kh * grp, hd), generator=g,
                    device=dev)
    return [t.to(dtype) for t in (q, k_pool, v_pool)] + [table, pos]


def paged_attn_phase(g, dev) -> dict:
    """paged_attn_decode against its plain version, then timed at the
    engine's decode shape and at a long context, back to back and as calls
    replayed from one CUDA graph. Beside the engine's shapes: views of
    several 256-key chunks of the split-KV core (pos at and around the
    chunk edges, a window that kills the leading chunks), granite's 48
    query heads per kv head of 128, hd 256, and rows at pos -1 (every key
    masked: the view's mean)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import paged_attn_decode_plain

    err = 0.0
    cases = [dict(rows=6, kh=16, grp=1, hd=64, bs=16, depth=80, share=True,
                  trash_rows=2, window=0),
             dict(rows=6, kh=16, grp=1, hd=64, bs=16, depth=80, window=40),
             dict(rows=5, kh=2, grp=4, hd=128, bs=8, depth=70, share=True,
                  trash_rows=1, window=0),
             dict(rows=5, kh=2, grp=4, hd=128, bs=8, depth=70, window=27)]
    # the split-KV core's own cases draw from a generator of their own, so
    # that g's draws (and every later phase 2 check) stay as they were
    g_split = torch.Generator(device=dev)
    g_split.manual_seed(25)
    split_cases = [
        dict(rows=8, kh=16, grp=1, hd=64, bs=16, depth=1000, window=0,
             at=[1000, 255, 256, 257, 511, 512, 0, -1], what="chunk edges"),
        dict(rows=4, kh=16, grp=1, hd=64, bs=16, depth=1000, window=300,
             at=[1000, 700, 299, -1], what="window past chunks"),
        dict(rows=4, kh=2, grp=48, hd=128, bs=16, depth=600, window=0,
             at=[600, 300, 17, -1], what="granite group"),
        dict(rows=4, kh=2, grp=2, hd=256, bs=8, depth=520, window=0,
             at=[520, 256, 3, -1], what="hd 256")]
    # llama4's grouping (8 kv heads of 128, 5 query heads each), on a
    # generator of its own: rows sharing a lane and all-trash rows, and a
    # view of several chunks
    g_l4 = torch.Generator(device=dev)
    g_l4.manual_seed(30)
    l4_cases = [
        dict(rows=6, kh=8, grp=5, hd=128, bs=16, depth=80, share=True,
             trash_rows=2, window=0, what="llama4 group"),
        dict(rows=4, kh=8, grp=5, hd=128, bs=16, depth=700, window=0,
             at=[700, 256, 255, -1], what="llama4 group chunks")]
    for dt in (torch.float32, torch.bfloat16):
        for c in cases + split_cases + l4_cases:
            c = dict(c)
            window = c.pop("window")
            tag = c.pop("what", "")
            gen = (g_l4 if tag.startswith("llama4") else g_split) if tag \
                else g
            q, kp, vp, table, pos = paged_case(gen, dev, dt, **c)
            sc = c["hd"] ** -0.5
            got = ops.paged_attn_decode(q, kp, vp, table=table, pos=pos,
                                        window=window, scale=sc)
            ref = paged_attn_decode_plain(q, kp, vp, table, pos, window,
                                          scale=sc)
            # real rows and the all-trash padding rows (which read the
            # poisoned block) are held to tolerances of their own scale
            real = c["rows"]
            if tag:
                # each row against its own scale (the pos -1 row is the
                # small mean of its view; a trash row reads the poison)
                for i in range(got.shape[0]):
                    check(f"paged_attn_decode {tag} grp={c['grp']} "
                          f"hd={c['hd']} depth={c['depth']} window={window} "
                          f"pos={int(pos[i])}", got[i], ref[i], dt)
                continue
            e = check(f"paged_attn_decode grp={c['grp']} bs={c['bs']} "
                      f"window={window}", got[:real], ref[:real], dt)
            if real < got.shape[0]:
                check(f"paged_attn_decode grp={c['grp']} bs={c['bs']} "
                      f"trash rows", got[real:], ref[real:], dt)
            if dt == torch.bfloat16:
                err = max(err, e)

    def timed(shape, gen=g):
        """Kernel and plain ms at `shape` (every row at depth), and the
        bound from the live K/V rows, q, out, table and pos."""
        item = 2                                     # bf16 bytes

        def one_set():
            q, kp, vp, table, pos = paged_case(gen, dev, torch.bfloat16,
                                               **shape)
            return [q, kp, vp, table, pos.fill_(shape["depth"])]

        sets = [one_set()]
        pool_bytes = sum(t.numel() * t.element_size() for t in sets[0])
        sets += [one_set() for _ in range(n_sets(pool_bytes) - 1)]
        sc = shape["hd"] ** -0.5

        def kernel(q, kp, vp, t, p):
            return ops.paged_attn_decode(q, kp, vp, table=t, pos=p, scale=sc)
        ms = time_ms(kernel, sets)
        g_ms = graph_ms(kernel, sets)
        plain_ms = time_ms(lambda q, kp, vp, t, p: paged_attn_decode_plain(
            q, kp, vp, t, p, 0, scale=sc), sets)
        rows, kh, grp, hd = (shape[k] for k in ("rows", "kh", "grp", "hd"))
        live = shape["depth"] + 1
        nbytes = (2 * rows * live * kh * hd * item        # K and V rows
                  + 2 * rows * kh * grp * hd * item       # q and out
                  + rows * (-(-live // shape["bs"]) + 1) * 4)  # table, pos
        flops = 4 * rows * live * kh * grp * hd
        return ms, g_ms, plain_ms, bound(flops, nbytes, "bfloat16")

    ms, g_ms, plain_ms, (b_ms, b_by) = timed(PAGED_MAIN)
    lms, lg_ms, lplain_ms, (lb_ms, lb_by) = timed(PAGED_LONG)
    l4 = timed(PAGED_LLAMA4, g_l4)
    print(f"[time] paged_attn_decode llama4 engine decode {PAGED_LLAMA4}: "
          f"{l4[0]:.4f} ms ({l4[1]:.4f} ms in a CUDA graph; bound "
          f"{l4[3][0]:.4f} ms, {l4[3][1]}), plain {l4[2]:.4f} ms")
    print(f"[time] paged_attn_decode engine decode {PAGED_MAIN}: {ms:.4f} "
          f"ms ({g_ms:.4f} ms in a CUDA graph; bound {b_ms:.4f} ms, "
          f"{b_by}), plain {plain_ms:.4f} ms")
    print(f"[time] paged_attn_decode long context {PAGED_LONG}: {lms:.4f} "
          f"ms ({lg_ms:.4f} ms in a CUDA graph; bound {lb_ms:.4f} ms, "
          f"{lb_by}), plain {lplain_ms:.4f} ms")
    return dict(
        name="paged_attn_decode", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attn.cu",
        core="src/repro_torch/kernels/csrc/decode_split.cuh",
        replaces="src/repro/kernels/paged_attention.py:119", launches=None,
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        library_note="no single PyTorch call computes a block-table lookup "
                     "plus attention", dtype="bfloat16",
        shape=" ".join(f"{k}={v}" for k, v in PAGED_MAIN.items()),
        graph_ms=g_ms,
        long_context=dict(shape=" ".join(f"{k}={v}" for k, v in
                                         PAGED_LONG.items()),
                          ms=lms, graph_ms=lg_ms, plain_ms=lplain_ms,
                          bound_ms=lb_ms, bound_by=lb_by),
        llama4=dict(shape=" ".join(f"{k}={v}" for k, v in
                                   PAGED_LLAMA4.items()),
                    ms=l4[0], graph_ms=l4[1], plain_ms=l4[2],
                    bound_ms=l4[3][0], bound_by=l4[3][1]))


def mla_case(g, dev, dtype, *, rows, heads, r, dr, bs, depth, share=False,
             trash_rows=0, at=None):
    """One mla_paged_decode input set, built as `paged_case` builds its
    own: latent and rope-key pools with a poisoned trash block 0,
    fragmented tables, positions spread around `depth` (or the list `at`),
    optional rows sharing a lane and all-trash padding rows."""
    import torch
    nblk = -(-(depth + 1) // bs)
    nblocks = rows * nblk + 1
    cc = torch.randn((nblocks, bs, r), generator=g, device=dev)
    cp = torch.randn((nblocks, bs, dr), generator=g, device=dev)
    perm = torch.randperm(nblocks - 1, generator=g, device=dev)[
        :rows * nblk] + 1
    table = perm.reshape(rows, nblk).to(torch.int32)
    pos = torch.randint(max(depth - 2 * bs, 0), depth + 1, (rows,),
                        generator=g, device=dev).to(torch.int32)
    if at is not None:
        pos = torch.tensor(at, dtype=torch.int32, device=dev)
    if share:
        odd = table[1::2].shape[0]
        table[1::2] = table[0::2][:odd]
        pos[1::2] = (pos[0::2][:odd] - 3).clamp(min=0)
    if trash_rows:
        table = torch.cat([table, table.new_zeros((trash_rows, nblk))])
        pos = torch.cat([pos, pos.new_zeros(trash_rows)])
    cc[0], cp[0] = 1e4, -1e4          # the trash block: finite garbage
    n = table.shape[0]
    q_abs = torch.randn((n, heads, r), generator=g, device=dev)
    q_pe = torch.randn((n, heads, dr), generator=g, device=dev)
    return [t.to(dtype) for t in (q_abs, q_pe, cc, cp)] + [table, pos]


def mla_phase(g, dev) -> dict:
    """mla_paged_decode against its plain version, each call checked to
    run the route mla_route names (bfloat16 at r 512 / dr 64 on the tensor
    cores, padded M tiles at 12 heads included; float32 and other widths on
    SIMT), then timed at the engine's decode shape and at a long context,
    back to back and as calls replayed from one CUDA graph, with the
    tensor-core route's split and merge kernels apart (torch.profiler)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import (mla_paged_decode_plain,
                                                     mla_route)

    def run(qa, qp, cc, cp, table, pos):
        want = mla_route(qa.dtype, qa.shape[-1], qp.shape[-1])
        return routed("mla_paged_decode", want, lambda: ops.mla_paged_decode(
            qa, qp, cc, cp, table=table, pos=pos, scale=MLA_SCALE))

    err = 0.0
    # depths 75 and 70 are not multiples of the block sizes 16 and 8
    cases = [dict(rows=6, heads=128, r=512, dr=64, bs=16, depth=75,
                  share=True, trash_rows=2),
             dict(rows=5, heads=128, r=512, dr=64, bs=8, depth=70),
             dict(rows=3, heads=12, r=96, dr=16, bs=16, depth=37,
                  share=True, trash_rows=1)]
    # the tensor-core route's own cases, on a generator of their own (so g's
    # draws stay as they were): 12 heads in a 64-row M tile, and views of
    # several 1024-key chunks, pos at and around the chunk edges and -1
    g_tc = torch.Generator(device=dev)
    g_tc.manual_seed(27)
    tc_cases = [
        dict(rows=4, heads=12, r=512, dr=64, bs=16, depth=75,
             at=[75, 40, 0, -1], what="12 heads"),
        dict(rows=8, heads=128, r=512, dr=64, bs=16, depth=2100,
             at=[2100, 1023, 1024, 1025, 2047, 2048, 5, -1],
             what="chunk edges")]
    for dt in (torch.float32, torch.bfloat16):
        for c in cases + tc_cases:
            c = dict(c)
            tag = c.pop("what", "")
            qa, qp, cc, cp, table, pos = mla_case(g_tc if tag else g, dev,
                                                  dt, **c)
            got = run(qa, qp, cc, cp, table, pos)
            ref = mla_paged_decode_plain(qa, qp, cc, cp, table, pos,
                                         scale=MLA_SCALE)
            name = (f"mla_paged_decode {tag} H={c['heads']} r={c['r']} "
                    f"bs={c['bs']} ({mla_route(dt, c['r'], c['dr'])})")
            if tag:
                # each row against its own scale (the pos -1 row is the
                # small mean of its view)
                for i in range(c["rows"]):
                    check(f"{name} depth={c['depth']} pos={int(pos[i])}",
                          got[i], ref[i], dt)
                continue
            real = c["rows"]
            e = check(name, got[:real], ref[:real], dt)
            if real < got.shape[0]:
                check(f"{name} trash rows", got[real:], ref[real:], dt)
            if dt == torch.bfloat16:
                err = max(err, e)
        # a row at pos -1 (every key masked: the mean of its view's latent
        # rows) beside rows at pos >= 0, on a generator of its own
        g_neg = torch.Generator(device=dev)
        g_neg.manual_seed(25)
        qa, qp, cc, cp, table, pos = mla_case(
            g_neg, dev, dt, rows=3, heads=128, r=512, dr=64, bs=16, depth=75,
            at=[75, -1, 20])
        got = run(qa, qp, cc, cp, table, pos)
        ref = mla_paged_decode_plain(qa, qp, cc, cp, table, pos,
                                     scale=MLA_SCALE)
        for i in range(3):
            check(f"mla_paged_decode pos={int(pos[i])}", got[i], ref[i], dt)

    def kernel(qa, qp, cc, cp, t, p):
        return ops.mla_paged_decode(qa, qp, cc, cp, table=t, pos=p,
                                    scale=MLA_SCALE)

    def timed(shape):
        """Kernel ms back to back and in a CUDA graph, plain ms, the bound
        (from the live latent and rope-key rows, the queries, out, table
        and pos) at `shape` (every row at depth), and each CUDA kernel's
        device ms a call."""
        def one_set():
            *ts, pos = mla_case(g, dev, torch.bfloat16, **shape)
            return ts + [pos.fill_(shape["depth"])]

        sets = [one_set()]
        pool_bytes = sum(t.numel() * t.element_size() for t in sets[0])
        sets += [one_set() for _ in range(n_sets(pool_bytes) - 1)]
        flops, nbytes = mla_work(**shape, itemsize=2)
        return dict(ms=time_ms(kernel, sets), graph_ms=graph_ms(kernel, sets),
                    plain_ms=time_ms(lambda qa, qp, cc, cp, t, p:
                                     mla_paged_decode_plain(
                                         qa, qp, cc, cp, t, p,
                                         scale=MLA_SCALE), sets),
                    bound=bound(flops, nbytes, "bfloat16"),
                    kernels=kernel_ms(kernel, sets))

    main, long = timed(MLA_MAIN), timed(MLA_LONG)
    for what, shape, t in (("engine decode", MLA_MAIN, main),
                           ("long context", MLA_LONG, long)):
        print(f"[time] mla_paged_decode {what} {shape}: {t['ms']:.4f} ms "
              f"({t['graph_ms']:.4f} ms in a CUDA graph; bound "
              f"{t['bound'][0]:.4f} ms, {t['bound'][1]}), plain "
              f"{t['plain_ms']:.4f} ms; device ms a call by kernel "
              f"{t['kernels']}")
    return dict(
        name="mla_paged_decode", route="cuda",
        source="src/repro_torch/kernels/csrc/mla_paged.cu",
        core="src/repro_torch/kernels/csrc/mla_tc.cuh",
        replaces="src/repro/kernels/paged_attention.py:192", launches=None,
        max_abs_err=err, ms=main["ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound"][0], bound_by=main["bound"][1],
        library_ms=None,
        library_note="no single PyTorch call computes a block-table lookup "
                     "plus absorbed latent attention", dtype="bfloat16",
        kernel_route="tensor_core",
        shape=" ".join(f"{k}={v}" for k, v in MLA_MAIN.items()),
        graph_ms=main["graph_ms"], kernels_ms=main["kernels"],
        long_context=dict(shape=" ".join(f"{k}={v}" for k, v in
                                         MLA_LONG.items()),
                          ms=long["ms"], graph_ms=long["graph_ms"],
                          plain_ms=long["plain_ms"],
                          bound_ms=long["bound"][0],
                          bound_by=long["bound"][1],
                          kernels_ms=long["kernels"]))


def mla_work(rows, heads, r, dr, bs, depth, itemsize) -> tuple[float, float]:
    """(FLOPs, bytes) of one mla_paged_decode call with every row at
    `depth`: the scores (2 (r + dr) a head and key) and the latent-value
    product (2 r) over the live keys; their latent and rope-key rows, the
    queries, out, table and pos each moved once."""
    live = depth + 1
    nbytes = (rows * live * (r + dr) * itemsize            # latent, rope key
              + rows * heads * (2 * r + dr) * itemsize     # q_abs, q_pe, out
              + rows * (-(-live // bs) + 1) * 4)           # table, pos
    return rows * heads * live * (2 * (r + dr) + 2 * r), nbytes


def kernel_ms(fn, inputs: list, calls: int = 20) -> dict:
    """Device ms per call of each CUDA kernel `fn` launches (torch.profiler's
    CUDA activity over `calls` calls after 3 warm ones), keyed by the
    kernel's name cut to 60 characters."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for i in range(3):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(*inputs[i % len(inputs)])
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        t_us = getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
        if t_us > 0:
            # kernels whose names share the first 60 characters (the
            # elementwise and copy kernels' instantiations) add up
            key = e.key[:60]
            per[key] = round(per.get(key, 0.0) + t_us / calls / 1e3, 5)
    return per


def ssd_case(g, dev, dtype, *, b, s, nh, hp, n, state=True, slow=False):
    """ssd_scan operands as mamba2_block hands them: xh, B and C are views
    of one conv output (batch and sequence strides over di + 2N channels),
    dt post-softplus in float32, h0 random or None. slow: dt ~ U(0.001,
    0.05) and A ~ -U(0.1, 1), so a 64-row chunk keeps exp(l_end) >= ~0.04
    (0.4 typical) of its start state and the state carried across chunks
    shows in y and h_fin; else dt = softplus(N(0, 1) - 1) and A =
    -exp(0.3 N(0, 1)), which keep ~1e-5 of it at most."""
    import torch
    di = nh * hp
    conv = torch.randn((b, s, di + 2 * n), generator=g, device=dev).to(dtype)
    if slow:
        dt = 0.001 + 0.049 * torch.rand((b, s, nh), generator=g, device=dev)
        a_log = torch.log(0.1 + 0.9 * torch.rand((nh,), generator=g,
                                                 device=dev))
    else:
        dt = torch.nn.functional.softplus(
            torch.randn((b, s, nh), generator=g, device=dev) - 1.0)
        a_log = 0.3 * torch.randn((nh,), generator=g, device=dev)
    d_skip = torch.randn((nh,), generator=g, device=dev)
    h0 = torch.randn((b, nh, hp, n), generator=g, device=dev) \
        if state else None
    return [conv[..., :di].reshape(b, s, nh, hp), dt, conv[..., di:di + n],
            conv[..., di + n:], a_log, d_skip, h0]


def ssd_work(b, s, nh, hp, n, itemsize, state=True,
             passes=(1, 1, 1)) -> tuple[float, float]:
    """(FLOPs, bytes) of one ssd_scan call. FLOPs of the chunked algorithm
    at SSD_BOUND_CHUNK, only the causal entries: per chunk of L rows,
    C B^T once per batch (L(L+1)/2 x 2N), and per head the intra-chunk
    product (L(L+1)/2 x 2hp), C h^T and the state update (2 L hp N each),
    each weighted by its entry of `passes` (SSD_TC_PASSES: the tensor-core
    passes the kernels run for it; 1: the function's own FLOPs). Bytes:
    each input read once (B and C per batch, not per head), each output
    written once."""
    w_cb, w_intra, w_state = passes
    flops = 0.0
    for c0 in range(0, s, SSD_BOUND_CHUNK):
        L = min(SSD_BOUND_CHUNK, s - c0)
        tri = L * (L + 1) / 2
        flops += w_cb * b * tri * 2 * n + b * nh * (
            w_intra * tri * 2 * hp + w_state * 4 * L * hp * n)
    state_bytes = b * nh * hp * n * 4
    nbytes = (b * s * nh * hp * itemsize + b * s * nh * 4          # x, dt
              + 2 * b * s * n * itemsize + 2 * nh * 4              # B, C, A, D
              + (state_bytes if state else 0)                      # h0
              + b * s * nh * hp * 4 + state_bytes)                 # y, h_fin
    return flops, nbytes


def ssd_passes_check(g, dev, tag, shape) -> float:
    """Each of ssd_scan's three CUDA passes against its plain pass on the
    same inputs (bf16 x, B, C and a random float32 state; each pass is fed
    the plain result of the pass before), at the kernels' own chunk.
    Returns the largest max|err|."""
    import torch

    from repro_torch.kernels import ssd_scan as S
    xh, dt, bm, cm, a_log, d_skip, h0 = ssd_case(g, dev, torch.bfloat16,
                                                 **shape)
    chunk = S.kernel_chunk(shape["s"], shape["n"])
    nc = -(-shape["s"] // chunk)
    n = shape["n"]
    _, ws, lend = S.workspace(shape["b"], nc, shape["nh"], shape["hp"], n,
                              dev)
    S.chunk_states_cuda(xh, dt, bm, a_log, chunk, ws, lend)
    states, lend_ref = S.ssd_chunk_states_plain(xh, dt, bm, a_log, chunk)
    err = max(check(f"ssd_scan {tag} chunk_states", ws[..., :n], states,
                    torch.float32),
              check(f"ssd_scan {tag} chunk l_end", lend, lend_ref,
                    torch.float32))
    ws[..., :n].copy_(states)
    lend.copy_(lend_ref)
    S.state_pass_cuda(h0, ws, lend, shape["s"], n, chunk)
    starts = S.ssd_state_pass_plain(states, lend_ref, h0)
    err = max(err, check(f"ssd_scan {tag} state_pass", ws[..., :n], starts,
                         torch.float32))
    ws[..., :n].copy_(starts)
    hg = S.heads_per_block(shape["b"], nc, shape["nh"], shape["hp"],
                           torch.cuda.get_device_properties(dev)
                           .multi_processor_count)
    y, h = S.chunk_out_cuda(xh, dt, bm, cm, a_log, d_skip, h0, ws, chunk, hg)
    y_ref, h_ref = S.ssd_chunk_out_plain(xh, dt, bm, cm, a_log, d_skip,
                                         chunk, h0, starts)
    return max(err, check(f"ssd_scan {tag} chunk_out y", y, y_ref,
                          torch.float32),
               check(f"ssd_scan {tag} chunk_out h_fin", h, h_ref,
                     torch.float32))


def ssd_phase(g, dev) -> dict:
    """ssd_scan against its plain version (the config's chunk of 256) at
    mamba2-370m's prefill shape, lengths off the kernels' chunk, 2 x 2048
    from zero and from a random state, and zamba2-1.2b's widths; each of
    its three passes against its plain pass at 2 x 2048 and at a ragged
    1000 tokens from a random state; the 2 x 2048 and ragged 1000 calls
    and passes again with a slow decay (ssd_case's `slow`), where the
    state carried across chunks is not lost in the tolerance; then timed at the prefill shape in
    the main path's types (bf16 x, B, C; a float32 zero state from the
    fresh cache), and at the long forward and zamba2-1.2b's widths, back
    to back and as calls replayed from one CUDA graph."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_scan_plain

    err = 0.0
    cases = [("mamba2 prefill, zero h0", torch.float32,
              dict(SSD_MAIN, state=False)),
             ("mamba2 prefill, random h0", torch.float32, SSD_MAIN),
             ("mamba2 prefill, random h0, bf16 inputs", torch.bfloat16,
              SSD_MAIN),
             ("ragged length 100", torch.float32,
              dict(b=3, s=100, nh=8, hp=64, n=128)),
             ("long forward 2 x 2048", torch.float32,
              dict(SSD_LONG, state=False)),
             ("2 x 2048, random h0", torch.float32, SSD_LONG),
             ("2 x 2048, random h0, bf16 inputs", torch.bfloat16, SSD_LONG),
             ("ragged 1000, random h0", torch.float32, SSD_RAGGED),
             ("zamba2 widths", torch.float32, SSD_ZAMBA),
             ("2 x 2048, random h0, slow decay", torch.float32,
              dict(SSD_LONG, slow=True)),
             ("2 x 2048, random h0, slow decay, bf16 inputs", torch.bfloat16,
              dict(SSD_LONG, slow=True)),
             ("ragged 1000, random h0, slow decay", torch.float32,
              dict(SSD_RAGGED, slow=True))]
    for tag, dt, shape in cases:
        args = ssd_case(g, dev, dt, **shape)
        y, h = ops.ssd_scan(*args[:6], chunk=256, h0=args[6])
        y_ref, h_ref = ssd_scan_plain(*args[:6], 256, h0=args[6])
        # fp32 arithmetic on the same values in both: the fp32 tolerance
        err = max(err, check(f"ssd_scan {tag} y", y, y_ref, torch.float32),
                  check(f"ssd_scan {tag} h_fin", h, h_ref, torch.float32))
    for tag, shape in (("2 x 2048", SSD_LONG), ("ragged 1000", SSD_RAGGED),
                       ("2 x 2048 slow decay", dict(SSD_LONG, slow=True)),
                       ("ragged 1000 slow decay",
                        dict(SSD_RAGGED, slow=True))):
        err = max(err, ssd_passes_check(g, dev, tag, shape))

    def scan(*a):
        return ops.ssd_scan(*a[:6], chunk=256, h0=a[6])

    def timed(shape):
        """Kernel (back to back and in a CUDA graph) and plain ms at
        `shape`, bf16 inputs and a float32 zero state (the prefill from a
        fresh cache), and the bound."""
        def one_set():
            args = ssd_case(g, dev, torch.bfloat16, **shape)
            args[6].zero_()
            return args

        flops, nbytes = ssd_work(**shape, itemsize=2)
        tc_flops, _ = ssd_work(**shape, itemsize=2,
                               passes=SSD_TC_PASSES[2])
        sets = [one_set() for _ in range(n_sets(nbytes))]
        ms, gms = time_ms(scan, sets), graph_ms(scan, sets)
        plain_ms = time_ms(lambda *a: ssd_scan_plain(*a[:6], 256, h0=a[6]),
                           sets)
        return (ms, gms, plain_ms, bound(flops, nbytes, "float32"),
                bound(tc_flops, nbytes, "tf32"))

    def line(tag, shape, ms, gms, plain_ms, b, tc):
        print(f"[time] ssd_scan {tag} {shape}: {ms:.4f} ms ({gms:.4f} ms in "
              f"a CUDA graph; bound {b[0]:.4f} ms, {b[1]}; at the TF32 "
              f"passes run {tc[0]:.4f} ms, {tc[1]}), plain {plain_ms:.4f} ms")

    ms, gms, plain_ms, (b_ms, b_by), tc_main = timed(SSD_MAIN)
    line("main", SSD_MAIN, ms, gms, plain_ms, (b_ms, b_by), tc_main)
    extra = {}
    for tag, shape in (("long", SSD_LONG), ("zamba2", SSD_ZAMBA)):
        xms, xgms, xplain, (xb, xby), tc = timed(shape)
        line(tag, shape, xms, xgms, xplain, (xb, xby), tc)
        extra[tag] = dict(shape=" ".join(f"{k}={v}" for k, v in
                                         shape.items()),
                          ms=xms, graph_ms=xgms, plain_ms=xplain,
                          bound_ms=xb, bound_by=xby, tc_bound_ms=tc[0])
    return dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:61", launches=None,
        max_abs_err=err, ms=ms, graph_ms=gms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, tc_bound_ms=tc_main[0],
        library_ms=None,
        library_note="no single PyTorch call computes an SSD chunk scan",
        dtype="bfloat16 x/B/C, float32 dt/state/y",
        shape=" ".join(f"{k}={v}" for k, v in SSD_MAIN.items()),
        long_context=extra["long"], zamba2=extra["zamba2"])


def deepseek_expert_times(g, dev, records: dict) -> None:
    """moe_gmm_ragged (static prefill, 4 x 32 tokens) and moe_gather (a
    decode step, 4 tokens; and the widest mixed step, DS_MIXED_TOKENS) at
    deepseek-v2's expert shapes: 160 experts of d 5120, m 1536, top-6,
    bfloat16. Checked against the plain version once (each call on the
    tensor cores), then timed on both routes beside the plain version and
    the chain; the records gain a "deepseek" entry. On the decode set's
    tokens and ids, a gather row, the ragged row of the same (token,
    expert) and moe_gmm's capacity row must be bitwise equal (BN 128 at 160
    experts)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core.experts import (assign_positions, ragged_layout,
                                          ragged_scatter)
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_gather import (moe_gather_cuda,
                                                moe_gather_plain)
    from repro_torch.kernels.moe_gmm import (moe_gmm_ragged_cuda,
                                             moe_gmm_ragged_plain)

    moe = get_config(DS_ARCH).moe
    d = get_config(DS_ARCH).d_model
    n_e, m, k = moe.num_experts, moe.d_expert, moe.top_k
    bf = torch.bfloat16
    block = ops.ragged_block_c()
    # one bank (7.5 GB), shared by every input set: the sets differ in
    # tokens and expert ids, and each call's slabs far exceed L2
    bank = [(torch.randn(s, generator=g, device=dev) * s[1] ** -0.5).to(bf)
            for s in ((n_e, d, m), (n_e, d, m), (n_e, m, d))]

    def gmm_set():
        t = BATCH * PROMPT
        ids = torch.randint(0, n_e, (t * k,), generator=g, device=dev)
        slot, owner, _, p_total = ragged_layout(ids, n_e, block)
        x = torch.randn((t, d), generator=g, device=dev).to(bf)
        return [ragged_scatter(x, k, slot, p_total), owner] + bank, ids

    def gather_set(t=BATCH):
        ids = torch.randint(0, n_e, (t * k,), generator=g,
                            device=dev).to(torch.int32)
        x = torch.randn((t, d), generator=g, device=dev).to(bf)
        return [x, ids] + bank, ids

    def gmm_chain(xp, o, wg, wu, wd):
        own = o.long()
        xb = xp.reshape(-1, block, d)
        h = F.silu(torch.bmm(xb, wg[own])) * torch.bmm(xb, wu[own])
        return torch.bmm(h, wd[own])

    def gather_chain(xf, i, wg, wu, wd):
        ids = i.long()
        xr = xf.repeat_interleave(k, dim=0)[:, None]
        h = F.silu(torch.bmm(xr, wg[ids])) * torch.bmm(xr, wu[ids])
        return torch.bmm(h, wd[ids])[:, 0]

    def work(ids, rows):
        live = sum(len(set(i.tolist())) for i in ids) / len(ids)
        nbytes = 2 * (3 * live * d * m + 2 * rows * d)
        return live, bound(6 * rows * d * m, nbytes, "bfloat16")

    def note(name, sets, ids, fn, simt, plain, chain, rows):
        err = check(f"{name} deepseek-v2 shape",
                    routed(name, "tensor_core", lambda: fn(*sets[0])),
                    plain(*sets[0]), bf)
        live, (b_ms, b_by) = work(ids, rows)
        t = both_routes(f"{name} deepseek-v2 shape ({rows} rows, {n_e} "
                        f"experts of {d}x{m})", sets, fn, simt, plain, chain,
                        b_ms, b_by, iters=10, graphs=False)
        records[name]["deepseek"] = dict(
            shape=f"rows={rows} E={n_e} d={d} m={m} top_k={k} "
                  f"distinct experts~{live:.1f}", max_abs_err=err,
            bound_ms=b_ms, bound_by=b_by, **t)

    def gather(xf, i, wg, wu, wd):
        return ops.moe_gather(xf, i, wg, wu, wd, top_k=k)

    made = [gmm_set() for _ in range(2)]
    note("moe_gmm_ragged", [a for a, _ in made], [i for _, i in made],
         lambda xp, o, wg, wu, wd: ops.moe_gmm_ragged(xp, o, wg, wu, wd,
                                                      block_c=block),
         lambda *a: moe_gmm_ragged_cuda(*a, "swiglu", block, path="simt"),
         lambda *a: moe_gmm_ragged_plain(*a, "swiglu", block), gmm_chain,
         BATCH * PROMPT * k)
    # what the layout's padding costs: the same calls cut to their live
    # tiles (no trailing tile), and moe_gmm on n_e full 64-row tiles (every
    # A row read, as a ragged tile's are, and no trailing tile)
    cut = []
    for a, ids in made:
        tiles = int(((torch.bincount(ids, minlength=n_e) + block - 1) //
                     block).sum())
        cut.append([a[0][:tiles * block], a[1][:tiles]] + bank)
    cut_ms = time_ms(lambda xp, o, wg, wu, wd: ops.moe_gmm_ragged(
        xp, o, wg, wu, wd, block_c=block), cut, iters=10)
    g_full = torch.Generator(device=dev)
    g_full.manual_seed(25)
    full = [[torch.randn((n_e, block, d), generator=g_full,
                         device=dev).to(bf)] + bank for _ in range(2)]
    full_ms = time_ms(lambda x, wg, wu, wd: ops.moe_gmm(x, wg, wu, wd), full,
                      iters=10)
    print(f"[time] moe_gmm_ragged deepseek-v2 shape cut to its live tiles "
          f"({tiles} of {made[-1][0][0].shape[0] // block}): {cut_ms:.4f} "
          f"ms; moe_gmm on {n_e} full {block}-row tiles: {full_ms:.4f} ms")
    records["moe_gmm_ragged"]["deepseek"].update(
        live_tiles_ms=cut_ms, moe_gmm_full_tiles_ms=full_ms)
    del made, cut, full
    made = [gather_set() for _ in range(4)]
    note("moe_gather", [a for a, _ in made], [i for _, i in made], gather,
         lambda *a: moe_gather_cuda(*a, top_k=k, path="simt"),
         lambda *a: moe_gather_plain(*a, top_k=k), gather_chain, BATCH * k)
    # the widest mixed step the engine sends to gather (the break-even)
    mixed = [gather_set(DS_MIXED_TOKENS) for _ in range(2)]
    rows = DS_MIXED_TOKENS * k
    check(f"moe_gather deepseek-v2 mixed step ({rows} rows)",
          gather(*mixed[0][0]), moe_gather_plain(*mixed[0][0], top_k=k), bf)
    live, (b_ms, b_by) = work([i for _, i in mixed], rows)
    ms = time_ms(gather, [a for a, _ in mixed], iters=10)
    print(f"[time] moe_gather deepseek-v2 mixed step ({rows} rows, "
          f"~{live:.1f} distinct experts): tensor cores {ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})")
    records["moe_gather"]["deepseek"]["mixed"] = dict(
        rows=rows, distinct=live, ms=ms, bound_ms=b_ms, bound_by=b_by)

    # one arithmetic for a routed row, at 160 experts (BN 128)
    (xf, ids, *_), _ = made[0]
    flat = ids.long()
    rows_g = gather(xf, ids, *bank)
    slot, owner, _, p_total = ragged_layout(flat, n_e, block)
    rows_r = ops.moe_gmm_ragged(ragged_scatter(xf, k, slot, p_total), owner,
                                *bank, block_c=block)[slot]
    pos = assign_positions(flat.reshape(-1, k), n_e, BATCH * k)[0].reshape(-1)
    xbuf = torch.zeros((n_e, BATCH * k, d), dtype=bf, device=dev)
    xbuf[flat, pos] = xf.repeat_interleave(k, dim=0)
    rows_c = ops.moe_gmm(xbuf, *bank)[flat, pos]
    if not (torch.equal(rows_g, rows_r) and torch.equal(rows_g, rows_c)):
        raise AssertionError("deepseek-v2 experts: gather, ragged and "
                             "capacity rows of the same (token, expert) "
                             "differ")
    print(f"[invariance] deepseek-v2 experts (E {n_e}): {BATCH * k} gather "
          f"rows == their ragged rows == their capacity rows, bitwise")


def moe_gmm_phase(g, dev) -> dict:
    """moe_gmm over dense (E, C, d) capacity buffers against its plain
    version: C = 8, C = 1 and C of 70 and 130 (not multiples of the 64-row
    tile, one and three tiles an expert) at qwen1.5-0.5b's converted expert
    width, then deepseek-v2's expert widths (E 160, d 5120, m 1536) at C =
    8 in float32 and bfloat16, each call checked to run the kernel
    moe_gmm.route names; in bfloat16 also at C 1, 8, 70 and 130 at
    deepseek's d and m (E 4). Timed at deepseek's widths in bfloat16 beside
    its plain version, the SIMT kernel on the same inputs and in float32, a
    torch.bmm yardstick and its bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_gmm import (moe_gmm_cuda, moe_gmm_plain,
                                             route)

    def rnd(shape, dtype, scale=1.0, gen=g):
        return (torch.randn(shape, generator=gen, device=dev) *
                scale).to(dtype)

    def bank(e, d, m, dtype, gen=g):
        return [rnd((e, d, m), dtype, d ** -0.5, gen),
                rnd((e, d, m), dtype, d ** -0.5, gen),
                rnd((e, m, d), dtype, m ** -0.5, gen)]

    def checked(what, x, w, act="swiglu"):
        return check(f"moe_gmm {what}", routed(
            "moe_gmm", route(x.dtype, *w[0].shape[1:]),
            lambda: ops.moe_gmm(x, *w, activation=act)),
            moe_gmm_plain(x, *w, act), x.dtype)

    for dt in (torch.float32, torch.bfloat16):
        for e, c, d, m, act in ((8, 8, 1024, 352, "swiglu"),
                                (8, 1, 1024, 352, "swiglu"),
                                (8, 70, 1024, 352, "geglu"),
                                (4, 130, 1024, 352, "swiglu")):
            x, w = rnd((e, c, d), dt), bank(e, d, m, dt)
            checked(f"E={e} C={c} d={d} m={m} {act}", x, w, act)
    ds = get_config(DS_ARCH)
    e, c, d, m = ds.moe.num_experts, GMM_C, ds.d_model, ds.moe.d_expert
    w32 = bank(e, d, m, torch.float32)            # 15.1 GB
    x32 = rnd((e, c, d), torch.float32)
    checked(f"deepseek-v2 E={e} C={c} d={d} m={m}", x32, w32)
    simt_f32_ms = time_ms(lambda x, wg, wu, wd: ops.moe_gmm(x, wg, wu, wd),
                          [[x32] + w32], iters=10)
    bf = torch.bfloat16
    wb = [t.to(bf) for t in w32]                  # 7.55 GB
    del w32
    err = checked(f"deepseek-v2 E={e} C={c} d={d} m={m}", x32.to(bf), wb)
    del x32
    # one bank shared by the sets (7.55 GB, far past L2): they differ in x
    sets = [[rnd((e, c, d), bf)] + wb for _ in range(2)]
    ms = time_ms(lambda x, wg, wu, wd: ops.moe_gmm(x, wg, wu, wd), sets,
                 iters=10)
    plain_ms = time_ms(lambda *a: moe_gmm_plain(*a), sets, iters=10)
    lib_ms = time_ms(lambda x, wg, wu, wd: torch.bmm(
        F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu), wd), sets, iters=10)
    simt_ms = time_ms(lambda *a: moe_gmm_cuda(*a, path="simt"), sets,
                      iters=10)
    nbytes = 2 * (3 * e * d * m + 2 * e * c * d)
    b_ms, b_by = bound(6 * e * c * d * m, nbytes, "bfloat16")
    print(f"[time] moe_gmm deepseek-v2 E={e} C={c} d={d} m={m} bf16: tensor "
          f"cores {ms:.4f} ms, SIMT {simt_ms:.4f} ms (float32 "
          f"{simt_f32_ms:.4f} ms), bmm chain {lib_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})")
    del sets, wb
    # the tensor-core route off its 64-row tile at deepseek's widths; its
    # own generator, so g's later draws stay as they were
    g_tc = torch.Generator(device=dev)
    g_tc.manual_seed(24)
    w = bank(4, d, m, bf, g_tc)
    for cc in (1, 8, 70, 130):
        checked(f"tensor cores E=4 C={cc} d={d} m={m}",
                rnd((4, cc, d), bf, gen=g_tc), w)
    return dict(
        name="moe_gmm", route="cuda",
        source="src/repro_torch/kernels/csrc/moe_gmm.cu",
        replaces="src/repro/kernels/moe_gmm.py:60", launches=None,
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, dtype="bfloat16",
        shape=f"E={e} C={c} d={d} m={m}", kernel_route="tensor_core",
        simt_ms=simt_ms, simt_f32_ms=simt_f32_ms)


def router_score_phase(g, dev) -> dict:
    """router_score against its plain version at qwen1.5-0.5b's converted
    widths (d 1024, N_r 5) and llama2-7b's (d 4096, N_r 5 and 13), at T of
    1, 4, 128, 512 and 100 (not a multiple of any block), in float32 and
    bfloat16; timed at the converted qwen's calibration batch (T 512, d
    1024, N_r 5) in bfloat16, back to back and as calls replayed from one
    CUDA graph, beside its plain version and a torch chain."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, router_score
    from repro_torch.kernels.router_score import router_score_plain

    def case(t, d, nr, dtype):
        x = torch.randn((t, d), generator=g, device=dev).to(dtype)
        w = [(torch.randn((d, nr), generator=g, device=dev) *
              d ** -0.5).to(dtype) for _ in range(2)]
        return [x] + w

    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        for d, nr in ((1024, 5), (4096, 5), (4096, 13)):
            for t in (1, 4, 128, 512, 100):
                x, wg, wu = case(t, d, nr, dt)
                e = check(f"router_score T={t} d={d} N_r={nr}",
                          ops.router_score(x, wg, wu),
                          router_score_plain(x, wg, wu), dt)
                if dt == torch.bfloat16 and (t, d, nr) == ROUTER_MAIN:
                    err = e
    t, d, nr = ROUTER_MAIN
    nbytes = 2 * t * d + 2 * 2 * d * nr + 4 * t * nr
    sets = [case(t, d, nr, torch.bfloat16) for _ in range(n_sets(nbytes))]
    def kernel(x, wg, wu):
        return ops.router_score(x, wg, wu)

    def chain(x, wg, wu):
        return F.silu((x @ wg).float()) * (x @ wu).float()

    ms, g_ms = time_ms(kernel, sets), graph_ms(kernel, sets)
    plain_ms = time_ms(lambda *a: router_score_plain(*a), sets)
    lib_ms, lib_g_ms = time_ms(chain, sets), graph_ms(chain, sets)
    b_ms, b_by = bound(4 * t * d * nr, nbytes, "bfloat16")
    pl = router_score.plan(t, d, nr, 2)
    print(f"[time] router_score T={t} d={d} N_r={nr} bf16 ({pl}): {ms:.4f} "
          f"ms ({g_ms:.4f} ms in a CUDA graph; bound {b_ms:.5f} ms, "
          f"{b_by}), plain {plain_ms:.4f} ms, chain {lib_ms:.4f} ms "
          f"({lib_g_ms:.4f} in a graph)")
    return dict(
        name="router_score", route="cuda",
        source="src/repro_torch/kernels/csrc/router_score.cu",
        replaces="src/repro/kernels/router_score.py:36", launches=None,
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, dtype="bfloat16 x and weights, "
        "float32 scores", shape=f"T={t} d={d} N_r={nr}", graph_ms=g_ms,
        library_graph_ms=lib_g_ms, plan=pl)


def attention_work(bh, s, t, d, causal, itemsize) -> tuple[float, float]:
    """(FLOPs, bytes) of one flash_attention call: 4 d FLOPs for each live
    (query, key) pair (under the top-left causal mask query i sees min(i +
    1, t) keys); q, k, v and out each moved once."""
    pairs = sum(min(i + 1, t) for i in range(s)) if causal else s * t
    return 4.0 * bh * d * pairs, (2 * bh * s * d + 2 * bh * t * d) * itemsize


def decode_work(bh, t, d, pos, itemsize) -> tuple[float, float]:
    """(FLOPs, bytes) of one flash_decode call over its live keys (those
    <= min(pos, t - 1); all t where pos < 0): their K and V rows, q, out
    and pos each moved once."""
    live = t if pos < 0 else min(pos, t - 1) + 1
    return 4.0 * bh * d * live, (2 * bh * live * d + 2 * bh * d) * \
        itemsize + 4


# the tensor-core kernels in mangled names, by library: flash_attention's
# by (DP, BK), the FFN core's (ffn_tc.cuh, in swiglu, moe_gmm and
# moe_gather) by (BN, GLU, consumer warpgroups, row rule); and
# flash_attention's SIMT one by (element type, NJ)
FA_TC_KERNEL = re.compile(r"flash_attn_tcILi(\d+)ELi(\d+)E")
FFN_TC_KERNEL = re.compile(
    r"ffn_tc_tileILi(\d+)ELb([01])ELi(\d+)ELi(\d+)E")
FFN_TC_RULES = {"0": "capacity", "1": "ragged", "2": "gather"}
SIMT_KERNEL = re.compile(r"flash_attn_kernelI(f|13__nv_bfloat16)Li(\d+)E")
# mla_paged_decode's tensor-core split kernel (mla_tc.cuh) and, for the
# record, its merge and the SIMT kernel by (element type, NC)
MLA_TC_KERNEL = re.compile(r"mla_tc\w*split_kernel")
MLA_OTHER_KERNEL = re.compile(
    r"(mla_tc\w*merge_kernel)|mla_kernelI(f|13__nv_bfloat16)Li(\d+)E")
# tensor-core instantiations each library must hold: DP 64, 128, 256; for
# each row rule of the FFN core, BN 64 and 128 of gate/up and of down, and
# under the capacity rule (swiglu_ffn's and moe_gmm's) gate/up also with
# two consumer warpgroups; mla_paged_decode's one split kernel
TC_INSTANCES = {"flash_attention": 3, "swiglu": 6, "moe_gmm": 10,
                "moe_gather": 4, "mla_paged": 1}


def tensor_core_report() -> None:
    """Phase 1: a [tensor cores] line for each instantiation of the
    tensor-core kernels (flash_attention's, the FFN core's in swiglu,
    moe_gmm and moe_gather, and mla_paged_decode's split kernel) and of the
    SIMT kernels beside them in flash_attention and mla_paged, with its
    registers and spills (ptxas) and the HGMMA instructions in its SASS
    (cuobjdump -sass on the library). A tensor-core instantiation with no
    HGMMA or with spills fails."""
    from repro_torch.kernels import build

    def label(name):
        m = FA_TC_KERNEL.search(name)
        if m:
            return f"bf16 flash_attn_tc<DP {m[1]}, BK {m[2]}>", True
        m = FFN_TC_KERNEL.search(name)
        if m:
            stage = "gate/up" if m[2] == "1" else "down"
            return (f"bf16 ffn_tc_tile<BN {m[1]}, {stage}, {m[3]} consumer "
                    f"warpgroups, {FFN_TC_RULES[m[4]]} rows>"), True
        m = SIMT_KERNEL.search(name)
        if m:
            return (f"{'f32' if m[1] == 'f' else 'bf16'} flash_attn_kernel"
                    f"<NJ {m[2]}>"), False
        if MLA_TC_KERNEL.search(name):
            return ("bf16 mla_tc split_kernel<64 heads x 64 keys, two "
                    "warpgroups>"), True
        m = MLA_OTHER_KERNEL.search(name)
        if m:
            return ("bf16 mla_tc merge_kernel" if m[1] else
                    f"{'f32' if m[2] == 'f' else 'bf16'} SIMT mla_kernel"
                    f"<NC {m[3]}>"), False
        return None, False

    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    for lib, want in TC_INSTANCES.items():
        usage, cur = {}, None
        for line in build.build_log(lib).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = m[1]
                usage[cur] = {}
            elif cur and (m := re.search(r"(\d+) bytes spill stores, (\d+) "
                                         r"bytes spill loads", line)):
                usage[cur]["spills"] = int(m[1]) + int(m[2])
            elif cur and (m := re.search(r"Used (\d+) registers", line)):
                usage[cur]["regs"] = int(m[1])
            if "wgmma" in line or "setmaxnreg" in line or "Loss" in line:
                print(f"[tensor cores] {lib} ptxas: {line.strip()}")
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(build.library_path(lib))],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        hgmma, cur = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                cur = m[1]
                hgmma[cur] = 0
            elif cur and "HGMMA" in line:
                hgmma[cur] += 1
        n_tc = 0
        for name in sorted(hgmma, key=lambda n: label(n)[0] or n):
            what, tensor_core = label(name)
            if what is None:
                continue
            use = usage.get(name, {})
            print(f"[tensor cores] {lib} {what}: {use.get('regs')} "
                  f"registers, {use.get('spills')} bytes spilled, "
                  f"{hgmma[name]} HGMMA in SASS")
            if tensor_core:
                n_tc += 1
                if hgmma[name] == 0 or use.get("spills") != 0:
                    raise AssertionError(f"{lib} {what}: {hgmma[name]} "
                                         f"HGMMA, {use.get('spills')} bytes "
                                         f"spilled")
        if n_tc != want:
            raise AssertionError(f"{lib}: {n_tc} tensor-core instantiations "
                                 f"in the SASS, want {want}")


def kernel_routes(tag: str, want: str) -> dict:
    """The route counts of the four FFN kernels and mla_paged_decode since
    the last reset of the launch counts: every launch must have run the
    `want` kernel ("tensor_core" in a bfloat16 phase, "simt" in a float32
    one). Prints and returns those of the kernels that ran."""
    from repro_torch.kernels import ops
    routes = {n: dict(ops.ROUTES[n]) for n in ROUTED_KERNELS
              if ops.LAUNCHES[n]}
    for name, counts in routes.items():
        if counts != {want: ops.LAUNCHES[name]}:
            raise AssertionError(f"{tag}: {name} routes {counts} for "
                                 f"{ops.LAUNCHES[name]} launches, want all "
                                 f"on {want}")
    print(f"[routes] {tag}: {routes or 'no routed kernel launch'}")
    return routes


def flash_attention_phase(g, dev) -> dict:
    """flash_attention against its plain version in float32 and bfloat16 at
    D 16, 64, 128 and 256: S and T not multiples of the kernel's 64 x 32
    tiles, causal S > T and S < T, a non-causal ragged T, the static main
    path's shape (4 x 32 tokens, qwen1.5-0.5b's 16 heads of 64) and
    llama2-7b's causal prefill (32 heads, 4096 tokens, D 128); in bfloat16
    also at D 64, 128 and 256 with S and T off the tensor-core kernel's
    128-row and K/V tiles, S = 1, T = 1 and more than one wave of blocks.
    Every call is checked to have run the kernel flash_attention.route
    names. Timed in bfloat16 at llama2-7b's prefill beside its plain
    version, scaled_dot_product_attention (is_causal: the top-left mask)
    and its bound, and at D 64 and 256 (same BH, S and T) beside SDPA."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (flash_attention_plain,
                                                     route)

    def case(bh, s, t, d, dtype, gen=g):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for shape in ((bh, s, d), (bh, t, d), (bh, t, d))]

    # the tensor-core cases and the D 64 / 256 timings draw from their own
    # generator, so that g's draws (and every later phase 2 check) stay as
    # they were before those were added
    g_tc = torch.Generator(device=dev)
    g_tc.manual_seed(22)

    def checked(q, k, v, causal, what):
        return check(f"flash_attention {what} "
                     f"{'causal' if causal else 'full'}", routed(
                         "flash_attention", route(q.dtype, q.shape[-1]),
                         lambda: ops.flash_attention(q, k, v, causal=causal)),
                     flash_attention_plain(q, k, v, causal), q.dtype)

    cases = [(3, 100, 100, 16, True), (2, 200, 130, 64, True),
             (2, 75, 300, 128, True), (2, 100, 77, 128, False),
             (2, 130, 130, 256, True), (2, 90, 41, 256, False),
             (BATCH * 16, PROMPT, PROMPT, 64, True)]
    for dt in (torch.float32, torch.bfloat16):
        for bh, s, t, d, causal in cases:
            checked(*case(bh, s, t, d, dt), causal,
                    f"BH={bh} S={s} T={t} D={d}")
    # the tensor-core route off its tiles (128 q rows; 128 keys at D 64 and
    # 128, 64 at D 256), and 264 x 2 blocks: four waves of 132
    for d in (64, 128, 256):
        for bh, s, t, causal in [(2, 300, 190, True), (2, 150, 333, True),
                                 (2, 200, 259, False), (3, 1, 77, False),
                                 (3, 77, 1, True), (264, 130, 130, True)]:
            checked(*case(bh, s, t, d, torch.bfloat16, g_tc), causal,
                    f"tensor cores BH={bh} S={s} T={t} D={d}")
    bh, s, t, d = (FA_MAIN[n] for n in ("bh", "s", "t", "d"))
    bf = torch.bfloat16

    def timed(d, plain, gen=g):
        flops, nbytes = attention_work(bh, s, t, d, True, 2)
        sets = [case(bh, s, t, d, bf, gen) for _ in range(n_sets(nbytes))]
        err = checked(*sets[0], True, f"llama2-7b prefill BH={bh} S={s} "
                      f"D={d}")
        ms = time_ms(lambda q, k, v: ops.flash_attention(q, k, v), sets,
                     iters=10)
        plain_ms = time_ms(lambda q, k, v: flash_attention_plain(q, k, v),
                           sets, iters=10) if plain else None
        lib_ms = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True), sets, iters=10)
        b_ms, b_by = bound(flops, nbytes, "bfloat16")
        print(f"[time] flash_attention BH={bh} S={s} T={t} D={d} causal "
              f"bf16: {ms:.4f} ms, {flops / ms * 1e-9:.1f} TFLOP/s (bound "
              f"{b_ms:.4f} ms, {b_by}; SDPA {lib_ms:.4f} ms, "
              f"{flops / lib_ms * 1e-9:.1f} TFLOP/s)")
        return err, ms, plain_ms, lib_ms, b_ms, b_by

    err, ms, plain_ms, lib_ms, b_ms, b_by = timed(d, True)
    widths = {}
    for dw in (64, 256):
        _, w_ms, _, w_lib, w_b, w_by = timed(dw, False, g_tc)
        widths[f"D={dw}"] = dict(ms=w_ms, library_ms=w_lib, bound_ms=w_b,
                                 bound_by=w_by)
    return dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:72", launches=None,
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, dtype="bfloat16",
        shape=f"BH={bh} S={s} T={t} D={d} causal", other_widths=widths)


def flash_decode_phase(g, dev) -> dict:
    """flash_decode against its plain version in float32 and bfloat16 at
    D 16, 64, 128 and 256: T not a multiple of the kernel's 32-key tile,
    pos 0, pos = T - 1, pos >= T, a negative pos (every key masked: the
    oracle's uniform average) and phase 7's decode shape; views of several
    256-key chunks of the split-KV core (pos at and around the chunk
    edges, a negative pos over 8 chunks) and D 6 (the SIMT kernel), each
    call checked to run the kernel flash_decode.route names. Timed at
    phase 7's decode shape and at a full 4096 cache in bfloat16 beside its
    plain version, scaled_dot_product_attention with the mask kpos <= pos,
    and its bound, back to back and (the kernel and SDPA) as calls
    replayed from one CUDA graph. pos reaches the kernel as a device int32,
    as on the main path."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_decode import flash_decode_plain, route

    def case(bh, t, d, pos, dtype, gen=g):
        q, k, v = [torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((bh, 1, d), (bh, t, d), (bh, t, d))]
        keep = (torch.arange(t, device=dev) <= pos)[None]   # (L 1, S t)
        return [q, k, v, torch.full((1,), pos, dtype=torch.int32,
                                    device=dev), keep]

    # the split-KV core's own cases draw from a generator of their own, so
    # that g's draws (and the timings after them) stay as they were
    g_split = torch.Generator(device=dev)
    g_split.manual_seed(25)
    cases = [(4, 100, 16, 63), (3, 70, 64, 0), (2, 100, 128, 99),
             (2, 100, 128, 120), (2, 40, 128, -1), (2, 300, 256, 200),
             tuple(FD_MAIN.values())]
    split_cases = [(4, 1100, 128, 255), (4, 1100, 128, 256),
                   (4, 1100, 128, 257), (2, 2000, 64, -1),
                   (2, 777, 256, 513), (2, 45, 6, 30)]
    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        for bh, t, d, pos in cases + split_cases:
            gen = g_split if (bh, t, d, pos) in split_cases else g
            q, k, v, p_d, _ = case(bh, t, d, pos, dt, gen)
            got = routed("flash_decode", route(dt, d),
                         lambda: ops.flash_decode(q, k, v, p_d))
            e = check(f"flash_decode {route(dt, d)} BH={bh} T={t} D={d} "
                      f"pos={pos}", got, flash_decode_plain(q, k, v, pos),
                      dt)
            if dt == torch.bfloat16 and (bh, t, d, pos) == \
                    tuple(FD_MAIN.values()):
                err = e

    def timed(shape):
        bh, t, d, pos = shape.values()
        flops, nbytes = decode_work(bh, t, d, pos, 2)
        sets = [case(bh, t, d, pos, torch.bfloat16)
                for _ in range(n_sets(nbytes))]

        def kernel(q, k, v, p_d, keep):
            return ops.flash_decode(q, k, v, p_d)

        def sdpa(q, k, v, p_d, keep):
            return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                  attn_mask=keep)
        ms, lib_ms = time_ms(kernel, sets), time_ms(sdpa, sets)
        g_ms, lib_g_ms = graph_ms(kernel, sets), graph_ms(sdpa, sets)
        plain_ms = time_ms(lambda q, k, v, p_d, keep: flash_decode_plain(
            q, k, v, p_d), sets)
        b_ms, b_by = bound(flops, nbytes, "bfloat16")
        print(f"[time] flash_decode {shape}: {ms:.4f} ms ({g_ms:.4f} ms in a "
              f"CUDA graph; bound {b_ms:.4f} ms, {b_by}), plain "
              f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms ({lib_g_ms:.4f} ms "
              f"in a graph)")
        return dict(ms=ms, graph_ms=g_ms, plain_ms=plain_ms, library_ms=lib_ms,
                    library_graph_ms=lib_g_ms, bound_ms=b_ms, bound_by=b_by)

    main, long = timed(FD_MAIN), timed(FD_LONG)
    return dict(
        name="flash_decode", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_decode.cu",
        core="src/repro_torch/kernels/csrc/decode_split.cuh",
        replaces="src/repro/kernels/flash_decode.py:65", launches=None,
        max_abs_err=err, **main, dtype="bfloat16",
        kernel_route=route(torch.bfloat16, FD_MAIN["d"]),
        shape=" ".join(f"{k}={v}" for k, v in FD_MAIN.items()),
        long_context=dict(shape=" ".join(f"{k}={v}" for k, v in
                                         FD_LONG.items()), **long))


def f32_agreement():
    """Phase 3a: kernel path vs plain path on one converted f32 model.
    Returns the converted kernel-path model, its params and the
    calibration tokens, for path B."""
    import numpy as np
    import torch

    from repro_torch.config import CMoEConfig, override
    from repro_torch.configs import get_config
    from repro_torch.core.convert import convert_dense_model
    from repro_torch.data import make_calibration_batch
    from repro_torch.models import build_model

    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    cfg = override(get_config(ARCH), dtype="float32")
    model = build_model(cfg, use_kernel=True, device=dev)
    ops.reset_launches()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen)
    calib = make_calibration_batch(cfg.vocab_size, 4, 128, seed=0)
    calib = {"tokens": torch.as_tensor(calib["tokens"], dtype=torch.long,
                                       device=dev)}
    cm = CMoEConfig(num_experts=8, num_shared=3, top_k=3)
    t0 = time.perf_counter()
    k_model, cparams, report = convert_dense_model(model, params, calib, cm)
    torch.cuda.synchronize()
    print(f"[e2e f32] converted {report.num_layers} layers ({cm.tag()}) in "
          f"{time.perf_counter() - t0:.2f} s")
    p_model = build_model(k_model.cfg, use_kernel=False, device=dev)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                           (BATCH, PROMPT)),
                              dtype=torch.long, device=dev)
    toks = {}
    for tag, m in (("kernel", k_model), ("plain", p_model)):
        logits, cache = m.prefill(cparams, {"tokens": prompts},
                                  max_len=PROMPT + GEN)
        seq = [torch.argmax(logits, -1)]
        for i in range(GEN - 1):
            lg, cache = m.decode_step(cparams, seq[-1][:, None], cache,
                                      PROMPT + i)
            seq.append(torch.argmax(lg, -1))
        toks[tag] = (logits.float(), torch.stack(seq, 1).cpu())
    lk, lp = toks["kernel"][0], toks["plain"][0]
    err = (lk - lp).abs().max().item()
    scale = lp.abs().max().item()
    agree = int((toks["kernel"][1] == toks["plain"][1]).sum())
    print(f"[e2e f32] prefill logits max|kernel - plain| {err:.3e} "
          f"(max|logit| {scale:.3e}, tol {1e-3 * scale:.3e}); greedy "
          f"tokens agree {agree}/{BATCH * GEN}")
    if not (torch.isfinite(lk).all() and err <= 1e-3 * scale):
        raise AssertionError("f32 kernel path disagrees with the plain path")
    torch.cuda.synchronize()
    kernel_routes("phase 3a f32 conversion and kernel path", "simt")
    return k_model, cparams, calib["tokens"]


def router_path(model, params, tokens) -> dict:
    """Path B: the CMoE analytical router's fused scoring through
    ops.router_score on every layer of the converted f32 model of phase 3a,
    on that layer's captured FFN input over the calibration batch and its
    own router weights, with the launch counts zeroed just before and read
    just after. Each layer's scores are held against the plain version
    (<= 1e-4 max|ref|) and against core.router.router_scores (<= 1e-5
    max|ref|: float32, so its rounding of the products is none), and the
    top-k ids the gate picks from each are compared token by token.
    Returns the launch counts."""
    import torch

    from repro_torch.core.router import cmoe_gate, router_scores
    from repro_torch.kernels import ops
    from repro_torch.kernels.router_score import router_score_plain

    cfg = model.cfg
    act, top_k, d = cfg.activation, cfg.cmoe.top_k, cfg.d_model
    ffn = params["blocks"]["cmoe"]
    with torch.no_grad():
        xs = model.ffn_inputs(params, {"tokens": tokens}).reshape(
            cfg.num_layers, -1, d)
    torch.cuda.synchronize()
    ops.reset_launches()
    scores = [ops.router_score(xs[li], ffn["router"]["wg_r"][li],
                               ffn["router"]["wu_r"][li], activation=act)
              for li in range(cfg.num_layers)]
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    got = {k: v for k, v in launches.items() if v}
    if got != {"router_score": cfg.num_layers}:
        raise AssertionError(f"path B launches {got}, want router_score "
                             f"once a layer ({cfg.num_layers})")
    worst_plain = worst_ref = 0.0
    differ = ties = 0
    for li, s in enumerate(scores):
        rp = {n: ffn["router"][n][li] for n in ("wg_r", "wu_r")}
        plain = router_score_plain(xs[li], rp["wg_r"], rp["wu_r"], act)
        ref = router_scores(xs[li], rp, act)
        rel = []
        for what, want, tol in (("plain", plain, 1e-4),
                                ("router_scores", ref, 1e-5)):
            rel.append(((s - want).abs().max() / want.abs().max()).item())
            if not (torch.isfinite(s).all() and rel[-1] <= tol):
                raise AssertionError(f"path B layer {li}: router_score vs "
                                     f"{what} {rel[-1]:.3e} > {tol} "
                                     f"max|ref|")
        worst_plain, worst_ref = max(worst_plain, rel[0]), \
            max(worst_ref, rel[1])
        bias = ffn["bias"][li]
        ids_k = cmoe_gate(s, top_k, bias=bias)[1].sort(-1).values
        _, ids_r, probs_r = cmoe_gate(ref, top_k, bias=bias)
        bad = (ids_k != ids_r.sort(-1).values).any(-1)
        differ += int(bad.sum())
        if bad.any():
            # the gate ranks probs + bias: a fork is allowed only where the
            # k-th and (k+1)-th selection values tie within 1e-6
            sel = (probs_r + bias[None, :]).sort(-1, descending=True).values
            gap = sel[bad, top_k - 1] - sel[bad, top_k]
            ties += int((gap <= 1e-6).sum())
    print(f"[path B] router_score on {cfg.num_layers} layers x "
          f"{xs.shape[1]} tokens (d {d}, N_r {ffn['router']['wg_r'].shape[-1]}"
          f", float32): max|kernel - plain| / max|plain| {worst_plain:.3e} "
          f"(tol 1e-4), vs router_scores {worst_ref:.3e} (tol 1e-5); top-"
          f"{top_k} ids differ on {differ} tokens, {ties} of them at a tie "
          f"within 1e-6; launches {got}")
    if differ != ties:
        raise AssertionError(f"path B: top-k ids differ on {differ} tokens, "
                             f"only {ties} at a tie")
    return launches


def capacity_path(model, params, tag: str) -> dict:
    """Path A: the bounded-buffer routed-expert path at deepseek-v2's
    expert widths, on the FFN input of the last MoE layer of a deepseek
    model phase 5 built (captured by Model.ffn_inputs over 4 x 32 tokens)
    with that layer's router and experts: moe_gate -> assign_positions
    (router weight as priority) -> dispatch into (E, C, d) buffers ->
    expert_ffn (ops.moe_gmm) -> combine, at C = the largest expert load
    (zero drops; equal to routed_experts' exact oracle) and at a quarter
    of it (the dropped pairs equal each expert's load past C; the kept
    pairs equal the oracle masked by keep). Launch counts are zeroed just
    before the two runs and read just after. Returns them."""
    import numpy as np
    import torch

    from repro_torch.core.experts import (DispatchInfo, assign_positions,
                                          combine, dispatch, dropped_pairs,
                                          routed_experts)
    from repro_torch.kernels import ops
    from repro_torch.models.model import tree_map
    from repro_torch.models.moe import expert_ffn, moe_gate

    cfg = model.cfg
    moe, d, li = cfg.moe, cfg.d_model, cfg.num_layers - 1
    e = moe.num_experts
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)), dtype=torch.long,
        device=model.device)
    with torch.no_grad():
        xf = model.ffn_inputs(params, {"tokens": tokens})[li].reshape(-1, d)
    p = tree_map(lambda a: a[li], params["blocks"]["moe"])
    gates, idx, _ = moe_gate(xf, p, moe)
    load = torch.bincount(idx.reshape(-1), minlength=e)
    c_max = int(load.max())
    caps = (c_max, max(1, c_max // 4))
    torch.cuda.synchronize()
    ops.reset_launches()
    runs = []
    for cap in caps:
        pos, keep = assign_positions(idx, e, cap, priority=gates)
        info = DispatchInfo(idx, pos, keep, gates)
        xbuf = dispatch(xf, info, e, cap)
        ybuf = expert_ffn(xbuf, p["wg"], p["wu"], p["wd"], cfg.activation,
                          use_kernel=model.use_kernel)
        runs.append((cap, combine(ybuf, info), keep))
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    got = {k: v for k, v in launches.items() if v}
    if got != {"moe_gmm": len(caps)}:
        raise AssertionError(f"path A ({tag}) launches {got}, want moe_gmm "
                             f"once a capacity ({len(caps)})")
    tol = 1e-4 if xf.dtype == torch.float32 else 2e-2
    bank = {n: p[n] for n in ("wg", "wu", "wd")}
    for cap, out, keep in runs:
        roomy = cap == c_max
        dropped = int(dropped_pairs(keep, None, idx.shape))
        over = int((load - cap).clamp(min=0).sum())
        if dropped != over or (dropped == 0) != roomy:
            raise AssertionError(f"path A ({tag}) C={cap}: {dropped} pairs "
                                 f"dropped, loads past C give {over}")
        ref, _ = routed_experts(xf, bank, gates, idx, cfg, backend="exact",
                                valid=None if roomy else keep)
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        if not (out.shape == xf.shape and torch.isfinite(out).all() and
                err <= tol * scale):
            raise AssertionError(f"path A ({tag}) C={cap}: max|err| "
                                 f"{err:.3e} > {tol} x {scale:.3e}")
        print(f"[path A {tag}] {cfg.name} layer {li}, {xf.shape[0]} tokens "
              f"top-{moe.top_k} of {e} experts (d {d}, m {moe.d_expert}), "
              f"C={cap} (largest load {c_max}): {dropped} of {idx.numel()} "
              f"pairs dropped (loads past C: {over}); max|combine - exact"
              f"{'' if roomy else ' masked by keep'}| {err:.3e} (tol "
              f"{tol * scale:.3e})")
    print(f"[path A {tag}] launches {got}")
    kernel_routes(f"path A {tag}",
               "simt" if xf.dtype == torch.float32 else "tensor_core")
    return launches


def routed_rows(kernel: str, x, ws, k: int):
    """Each (token, expert) pair's output row (T * k, d), token-major,
    through `kernel` ("moe_gather", "moe_gmm_ragged" on its layout, or
    "moe_gmm" on capacity buffers that hold every pair). A token's k expert
    ids come from its own values, so a token names the same experts at any
    width."""
    import torch

    from repro_torch.core.experts import (assign_positions, ragged_layout,
                                          ragged_scatter)
    from repro_torch.kernels import ops
    e, t = ws[0].shape[0], x.shape[0]
    ids = (x[:, :k].float() * 64).floor().long().remainder(e)
    flat = ids.reshape(-1)
    if kernel == "moe_gather":
        return ops.moe_gather(x, flat, *ws, top_k=k)
    if kernel == "moe_gmm_ragged":
        slot, owner, _, p_total = ragged_layout(flat, e, 64)
        xp = ragged_scatter(x, k, slot, p_total)
        return ops.moe_gmm_ragged(xp, owner, *ws, block_c=64)[slot]
    pos = assign_positions(ids, e, t * k)[0].reshape(-1)
    xbuf = torch.zeros((e, t * k, x.shape[1]), dtype=x.dtype,
                       device=x.device)
    xbuf[flat, pos] = x.repeat_interleave(k, dim=0)
    return ops.moe_gmm(xbuf, *ws)[flat, pos]


def width_invariance() -> None:
    """Phase 4a: every dense product the engine runs (and the norms and the
    MoE gate), on the card in bfloat16 at qwen1.5-0.5b's and deepseek-v2's
    shapes, gives a row bitwise the same result alone and inside every
    width the engine runs; so do the four FFN kernels on the tensor cores,
    up to 512 rows (tokens, for the routed experts). At qwen's and
    deepseek's expert widths a (token, expert) pair's row is bitwise the
    same through moe_gather, moe_gmm_ragged and moe_gmm. Raw torch.matmul
    and torch.bmm, without the port's fixed row tiles, are measured beside
    them."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.layers import (_ONE_CALL_OK, PROBE_ROWS,
                                           head_matmul, matmul, rms_norm,
                                           unembed)
    from repro_torch.models.moe import moe_gate

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    bf = torch.bfloat16

    def w(*shape):
        return (torch.randn(shape, generator=g, device=dev) *
                shape[-2] ** -0.5).to(bf)

    cfg = get_config(ARCH)
    d, hd, h = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads
    m = cfg.d_ff // 8
    table = w(cfg.vocab_size, d)
    norm = torch.zeros(d, dtype=bf, device=dev)
    products = {
        "q/k/v/o projections (d x d)": ((d,), lambda x, w_=w(d, h * hd):
                                        matmul(x, w_)),
        "shared experts gate/up (d x 3m)": ((d,), lambda x, w_=w(d, 3 * m):
                                            matmul(x, w_)),
        "shared experts down (3m x d)": ((3 * m,), lambda x, w_=w(3 * m, d):
                                         matmul(x, w_)),
        "router (d x 5)": ((d,), lambda x, w_=w(d, 5): matmul(x, w_)),
        "unembed (f32, d x vocab)": ((d,), lambda x: unembed(x, table,
                                                             True)),
        "rms_norm": ((d,), lambda x: rms_norm(x, norm, cfg.norm_eps)),
    }
    ds = get_config(DS_ARCH)
    dd, hh, mla, moe = ds.d_model, ds.num_heads, ds.mla, ds.moe
    qr, r, dr = mla.q_lora_rank, mla.kv_lora_rank, mla.qk_rope_head_dim
    dn, dv = mla.qk_nope_head_dim, mla.v_head_dim
    head = w(dd, ds.vocab_size)
    gate_p = {"router": w(dd, moe.num_experts),
              "balance_bias": torch.zeros(moe.num_experts, device=dev)}
    ds_products = {
        "deepseek q_dproj (5120 x 1536)": ((dd,), lambda x, w_=w(dd, qr):
                                           matmul(x, w_)),
        "deepseek q_uproj (1536 x 128*192)": (
            (qr,), lambda x, w_=w(qr, hh * (dn + dr)): matmul(x, w_)),
        "deepseek kv_dproj (5120 x 576)": (
            (dd,), lambda x, w_=w(dd, r + dr): matmul(x, w_)),
        "deepseek absorption q_nope W_uk (128 heads, 128 x 512)": (
            (hh, dn), lambda x, w_=w(hh, dn, r): head_matmul(x, w_)),
        "deepseek value expansion W_uv (128 heads, 512 x 128)": (
            (hh, r), lambda x, w_=w(hh, r, dv): head_matmul(x, w_)),
        "deepseek wo (128*128 x 5120)": ((hh * dv,), lambda x,
                                         w_=w(hh * dv, dd): matmul(x, w_)),
        "deepseek router + gate (5120 x 160, top-6)": (
            (dd,), lambda x: moe_gate(x, gate_p, moe)[0]),
        "deepseek shared experts gate/up (5120 x 3072)": (
            (dd,), lambda x, w_=w(dd, moe.d_shared): matmul(x, w_)),
        "deepseek shared experts down (3072 x 5120)": (
            (moe.d_shared,), lambda x, w_=w(moe.d_shared, dd):
            matmul(x, w_)),
        "deepseek unembed (f32, 5120 x 102400)": (
            (dd,), lambda x: unembed(x, head, False)),
        "deepseek rms_norm (5120, 1536, 512)": (
            (dd,), lambda x: torch.cat([
                rms_norm(x[:, :n], torch.zeros(n, dtype=bf, device=dev))
                for n in (dd, qr, r)], dim=-1)),
    }
    # the two FFN kernels on the tensor cores: swiglu_ffn at qwen's dense
    # FFN (the calibration forward's T = 512 included), and moe_gmm at C
    # rows of 8 of qwen's converted experts and of deepseek's (x is (C, E,
    # d) here, so that a row is one capacity slot of every expert)
    em = moe.d_expert

    def by_slot(x, ws):
        return ops.moe_gmm(x.transpose(0, 1).contiguous(), *ws
                           ).transpose(0, 1)

    ffn_products = {
        "swiglu_ffn, tensor cores (1024 x 2816 x 1024)": (
            (d,), lambda x, ws=(w(d, cfg.d_ff), w(d, cfg.d_ff),
                                w(cfg.d_ff, d)): ops.swiglu_ffn(x, *ws)),
        "moe_gmm, tensor cores (8 experts of 1024 x 352)": (
            (8, d), lambda x, ws=(w(8, d, m), w(8, d, m), w(8, m, d)):
            by_slot(x, ws)),
        "moe_gmm, tensor cores (8 experts of 5120 x 1536)": (
            (8, dd), lambda x, ws=(w(8, dd, em), w(8, dd, em),
                                   w(8, em, dd)): by_slot(x, ws)),
    }
    # the routed experts' two kernels on the tensor cores, each token's
    # expert rows (T, k, d): qwen's converted experts (5 routed, top-3) and
    # 8 of deepseek's (top-6)
    routed_banks = {"qwen": (5, d, m, 3), "deepseek": (8, dd, em, 6)}
    for tag, (e, de, me, k) in routed_banks.items():
        ws = (w(e, de, me), w(e, de, me), w(e, me, de))
        routed_banks[tag] = (ws, k)
        for kernel in ("moe_gmm_ragged", "moe_gather"):
            ffn_products[f"{kernel}, tensor cores ({e} experts of {de} x "
                         f"{me}, top-{k})"] = (
                (de,), lambda x, ws=ws, k=k, kernel=kernel:
                routed_rows(kernel, x, ws, k).reshape(len(x), k, -1))
    # up to PROBE_ROWS a product may run as one call; above, in row tiles
    widths = sorted({1, 2, 3, 4, 8, 12, 16, 20, 24, 28, 32, 36, 64, 65, 128,
                     129, 192})

    def invariant(name, tail, fn, widths):
        x = torch.randn((max(widths), *tail), generator=g, device=dev).to(bf)
        bad = []
        for wd in widths:
            y = fn(x[:wd])
            for row in {0, wd - 1}:
                if not torch.equal(y[row:row + 1], fn(x[row:row + 1])):
                    bad.append(wd)
                    break
        if bad:
            raise AssertionError(f"{name} is not width-invariant on the "
                                 f"card: widths {bad}")
        print(f"[invariance] {name}: bitwise width-invariant at {widths}")

    for name, (tail, fn) in {**products, **ds_products}.items():
        invariant(name, tail, fn, widths)
    for name, (tail, fn) in ffn_products.items():
        invariant(name, tail, fn, widths + [300, 512])
    # one arithmetic for a routed row: a (token, expert) pair's output row
    # through moe_gather, moe_gmm_ragged and moe_gmm's capacity buffers
    for tag, (ws, k) in routed_banks.items():
        x = torch.randn((100, ws[0].shape[1]), generator=g, device=dev).to(bf)
        rows = [routed_rows(kr, x, ws, k)
                for kr in ("moe_gather", "moe_gmm_ragged", "moe_gmm")]
        if not (torch.equal(rows[0], rows[1]) and
                torch.equal(rows[0], rows[2])):
            raise AssertionError(f"{tag} experts: gather, ragged and "
                                 f"capacity rows of the same (token, expert) "
                                 f"differ")
        print(f"[invariance] {tag} experts ({ws[0].shape[0]} of "
              f"{ws[0].shape[1]} x {ws[0].shape[2]}): {rows[0].shape[0]} "
              f"gather rows == their ragged rows == their capacity rows, "
              f"bitwise")

    def raw_breaks(fn, tail):
        x = torch.randn((max(widths), *tail), generator=g, device=dev)
        return [wd for wd in widths
                if not torch.equal(fn(x[:wd])[:1], fn(x[:1]))]

    wf = table.T.float()
    print(f"[invariance] raw float32 torch.matmul (d x vocab) breaks at "
          f"widths {raw_breaks(lambda x: x @ wf, (d,))}")
    for name, k, n in (("q_dproj", dd, qr), ("router", dd, moe.num_experts),
                       ("shared down", moe.d_shared, dd),
                       ("wo", hh * dv, dd)):
        wb = w(k, n)
        print(f"[invariance] raw bfloat16 torch.matmul deepseek {name} "
              f"({k} x {n}) breaks at widths "
              f"{raw_breaks(lambda x: x.to(bf) @ wb, (k,))}")
    wk = w(hh, dn, r)

    def raw_absorb(x):
        return torch.bmm(x.to(bf).transpose(0, 1), wk).transpose(0, 1)

    print(f"[invariance] raw bfloat16 torch.bmm deepseek absorption breaks "
          f"at widths {raw_breaks(raw_absorb, (hh, dn))}: the port runs "
          f"the per-head products in fixed 64-row tiles")
    verdicts = {ok: sorted({(str(dt).removeprefix("torch."), tuple(shape))
                            for (dt, _, shape, _, _), o in
                            _ONE_CALL_OK.items() if o == ok})
                for ok in (True, False)}
    print(f"[invariance] row_matmul probe: one call up to {PROBE_ROWS} rows "
          f"for {verdicts[True]}; row tiles for {verdicts[False]}")


def engine_phase() -> dict:
    """Phase 4b: the continuous-batching engine through the CLI's entry
    point, launch counts zeroed before both runs and read after them.
    Returns the launch counts (the engines, and the models they hold, are
    freed on return)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    torch.cuda.synchronize()
    ops.reset_launches()
    results = []
    for extra in ([], PREFIX_ARGS):
        res = serve.run(ENGINE_ARGS + extra)
        results.append(res)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    for extra, res in zip(([], PREFIX_ARGS), results):
        rep = res["report"]
        tag = "prefix reuse" if extra else "paged"
        want = ["overlap == sequential"] + \
            (["prefix reuse == no reuse"] if extra else []) + \
            ["paged == contiguous"]
        if res["parity"] != want:
            raise AssertionError(f"{tag}: parity replays {res['parity']}")
        if not all(r.done for r in rep.requests) or rep.dropped_pairs or \
                not rep.pool_audit.get("ok") or \
                rep.pool_audit.get("allocated"):
            raise AssertionError(f"{tag}: unfinished requests, drops or a "
                                 f"bad audit {rep.pool_audit}")
        if extra and rep.prefix_hits <= 0:
            raise AssertionError("prefix reuse run had no prefix hits")
        bc = {ph: dict(c) for ph, c in rep.backend_counts.items()}
        print(f"[e2e engine] {tag}: {rep.num_requests} requests, "
              f"{rep.total_new_tokens} tokens in {rep.steps} steps, wall "
              f"{rep.wall_s:.3f} s, goodput {rep.goodput:.1f} tok/s, TTFT "
              f"p50/p95 {rep.ttft_p50_s * 1e3:.1f}/"
              f"{rep.ttft_p95_s * 1e3:.1f} ms, TPOT p50/p95 "
              f"{rep.tpot_p50_s * 1e3:.2f}/{rep.tpot_p95_s * 1e3:.2f} ms, "
              f"overlap occupancy {rep.overlap_occupancy:.3f}, prefix hits "
              f"{rep.prefix_hits}, backends {bc}, audit {rep.pool_audit}, "
              f"parity {res['parity']}")
    print(f"[e2e engine] launches over both runs {launches}")
    kernel_routes("phase 4 engine bf16", "tensor_core")
    return launches


def paged_agreement(k_model, p_model, params, prompts, gen, tag: str,
                    extras: Optional[dict] = None, steps: int = 4,
                    bs: int = 16) -> None:
    """The kernel path against the plain path on one set of weights,
    through Model.step on a paged cache with fragmented tables (drawn from
    `gen`): a prefill chunk of `prompts` on a lane each (with `extras` for
    the embedder), then `steps` decode steps. Both paths are fed the kernel
    path's greedy tokens, so every step's logits are comparable: within
    1e-3 of max|logit| at every step, no routed pair dropped. Launch counts
    are zeroed first."""
    import torch

    from repro_torch.kernels import ops

    dev = prompts.device
    rows, seq = prompts.shape
    nblk = -(-(seq + steps) // bs)
    table = (torch.randperm(rows * nblk, generator=gen, device=dev) + 1
             ).reshape(rows, nblk).to(torch.int32)
    feed = [prompts]
    logits = {}
    torch.cuda.synchronize()
    ops.reset_launches()
    for path, m in (("kernel", k_model), ("plain", p_model)):
        pool = m.init_paged_cache(1 + rows * nblk, bs)
        out = []
        for i in range(steps + 1):
            start = torch.full((rows,), 0 if i == 0 else seq + i - 1,
                               dtype=torch.int32, device=dev)
            lg, pool, stats = m.step(params, feed[i], pool, start,
                                     block_tables=table, return_stats=True,
                                     extras=extras if i == 0 else None)
            if int(stats["dropped"]):
                raise AssertionError(f"{tag} {path} path dropped routed "
                                     f"pairs")
            out.append(lg.float())
            if path == "kernel" and i < steps:
                feed.append(torch.argmax(lg, -1)[:, None])
        logits[path] = out
    worst = 0.0
    agree = 0
    for i, (lk, lp) in enumerate(zip(logits["kernel"], logits["plain"])):
        err = (lk - lp).abs().max().item()
        scale = lp.abs().max().item()
        worst = max(worst, err / scale)
        if not (torch.isfinite(lk).all() and err <= 1e-3 * scale):
            raise AssertionError(f"{tag} step {i}: kernel path disagrees "
                                 f"with the plain path ({err:.3e} > 1e-3 x "
                                 f"{scale:.3e})")
        agree += int((lk.argmax(-1) == lp.argmax(-1)).sum())
    print(f"[e2e {tag}] kernel vs plain over a prefill chunk of {seq} "
          f"tokens and {steps} decode steps: max|err| / max|logit| "
          f"{worst:.3e} (tol 1e-3); greedy tokens agree "
          f"{agree}/{rows * (steps + 1)}")


def deepseek_f32_agreement() -> dict:
    """Phase 5a: deepseek-v2 at full width in float32, cut to DS_F32_LAYERS
    layers: the kernel path (mla_paged_decode, moe_gmm_ragged, moe_gather)
    against the plain path on one set of weights, through Model.step on a
    paged cache with fragmented tables: a 32-token prefill chunk on 4
    lanes, then 4 decode steps. Both paths are fed the kernel path's greedy
    tokens, so every step's logits are comparable. Then path A in float32
    on the same model; returns its launch counts."""
    import numpy as np
    import torch

    from repro_torch.config import override
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    dev = torch.device("cuda")
    cfg = override(get_config(DS_ARCH), dtype="float32",
                   num_layers=DS_F32_LAYERS)
    k_model = build_model(cfg, use_kernel=True, device=dev)
    p_model = build_model(cfg, use_kernel=False, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = k_model.init(gen)
    torch.cuda.synchronize()
    print(f"[e2e deepseek f32] {DS_ARCH} at published widths, "
          f"{DS_F32_LAYERS} layers, float32: init "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)), dtype=torch.long, device=dev)
    paged_agreement(k_model, p_model, params, prompts, gen, "deepseek f32")
    kernel_routes("phase 5a deepseek f32 kernel path", "simt")
    return capacity_path(k_model, params, "f32")


def deepseek_serving() -> dict:
    """Phases 5b and 5c: deepseek-v2 at full width in bfloat16, cut to
    DS_LAYERS layers, through the CLI's entry point: the static path, then
    the engine. Launch counts are zeroed before each and read after. Then
    path A in bfloat16 on the engine's model. Returns the engine run's
    launch counts and path A's."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    print(f"[cut] {DS_ARCH}: depth 60 -> {DS_F32_LAYERS} layers (phase 5a, "
          f"float32) and {DS_LAYERS} layers (phases 5b and 5c, bfloat16); "
          f"every width as published; requests and generated tokens as in "
          f"phases 3b and 4")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res = serve.run(DS_STATIC_ARGS)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    toks = torch.as_tensor(res["tokens"])
    from repro_torch.configs import get_config
    vocab = get_config(DS_ARCH).vocab_size
    if toks.shape != (BATCH, GEN) or toks.min() < 0 or \
            toks.max() >= vocab or \
            not torch.isfinite(res["prefill_logits"]).all():
        raise AssertionError(f"bad deepseek serve output: tokens "
                             f"{tuple(toks.shape)}")
    if res["backends"] != {"prefill": "grouped_kernel", "decode": "gather"}:
        raise AssertionError(f"deepseek backends per phase: "
                             f"{res['backends']}")
    for name in ("moe_gmm_ragged", "moe_gather"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"deepseek static path")
    print(f"[e2e deepseek bf16] static: prefill {res['prefill_ms']:.2f} ms "
          f"({BATCH}x{PROMPT}, median of {serve.PREFILL_REPEATS} warm), "
          f"decode {res['decode_tok_s']:.1f} tok/s ({BATCH} lanes, "
          f"{GEN - 1} steps), peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB, launches "
          f"{launches}")
    kernel_routes("phase 5b deepseek static bf16", "tensor_core")
    del res

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ops.reset_launches()
    res = serve.run(DS_ENGINE_ARGS)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    rep = res["report"]
    if res["parity"] != ["overlap == sequential", "paged == contiguous"]:
        raise AssertionError(f"deepseek engine parity replays "
                             f"{res['parity']}")
    if not all(r.done for r in rep.requests) or rep.dropped_pairs or \
            not rep.pool_audit.get("ok") or rep.pool_audit.get("allocated"):
        raise AssertionError(f"deepseek engine: unfinished requests, drops "
                             f"or a bad audit {rep.pool_audit}")
    for name in ("mla_paged_decode", "moe_gmm_ragged", "moe_gather"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"deepseek engine's path")
    bc = {ph: dict(c) for ph, c in rep.backend_counts.items()}
    print(f"[e2e deepseek engine] {rep.num_requests} requests, "
          f"{rep.total_new_tokens} tokens in {rep.steps} steps, wall "
          f"{rep.wall_s:.3f} s, goodput {rep.goodput:.1f} tok/s, TTFT "
          f"p50/p95 {rep.ttft_p50_s * 1e3:.1f}/{rep.ttft_p95_s * 1e3:.1f} "
          f"ms, TPOT p50/p95 {rep.tpot_p50_s * 1e3:.2f}/"
          f"{rep.tpot_p95_s * 1e3:.2f} ms, overlap occupancy "
          f"{rep.overlap_occupancy:.3f}, backends {bc}, audit "
          f"{rep.pool_audit}, parity {res['parity']}, launches {launches}")
    kernel_routes("phase 5c deepseek engine bf16", "tensor_core")
    # path A in bfloat16 on the model the engine served
    path_a = capacity_path(res["engine"].model, res["engine"].params, "bf16")
    return launches, path_a


def capture_call(name: str, call, module=None):
    """call() with <module>.<name> (default ops.<name>) wrapped to keep the
    arguments of its first call (the inputs the path gives the kernel or
    function) and count its calls. Returns (call()'s result, (args,
    kwargs), the number of calls)."""
    from repro_torch.kernels import ops
    if module is None:
        module = ops
    kernel = getattr(module, name)
    seen = []

    def wrapper(*args, **kwargs):
        seen.append((args, kwargs) if not seen else None)
        return kernel(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        out = call()
    finally:
        setattr(module, name, kernel)
    return out, seen[0], len(seen)


def live_bound(live_rows: int, x_rows: int, ids, d: int, m: int):
    """Bound of a routed GLU FFN on the rows that carry data: each live
    row's input and output once, each distinct live expert's slabs once
    (bf16). Returns (distinct experts, (bound ms, bound by))."""
    import torch
    distinct = int(torch.unique(ids).numel())
    nbytes = 2 * (3 * distinct * d * m + x_rows * d + live_rows * d)
    return distinct, bound(6 * live_rows * d * m, nbytes, "bfloat16")


def hierarchical_ffn_checks(model, p0, records: dict,
                            key: str = "hierarchical") -> None:
    """Phases 5d and 5e on the converted MoE layer whose block params are
    p0: the hierarchical FFN bitwise width-invariant (a token alone and
    among DS_MIXED_TOKENS, at decode and on a fused step) and unchanged by
    re-aiming dead outer rows at the sentinel; then moe_gmm_ragged (a 4 x
    32 prefill) and moe_gather (a 4-token decode) on the inputs the FFN
    gives them, against their plain versions on the rows that carry data,
    and timed beside their plain versions, the bmm chains and bounds that
    count live rows. The records go under records[kernel][key]."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import hierarchical as hier
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_gather import moe_gather_plain
    from repro_torch.kernels.moe_gmm import moe_gmm_ragged_plain

    cfg = model.cfg
    dev = torch.device("cuda")
    bf = torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    d, k = cfg.d_model, cfg.cmoe.top_k
    what = f"{cfg.name} hierarchical"

    def ffn(x, phase):
        return hier.hierarchical_moe_ffn(x, p0, cfg, use_kernel=True,
                                         phase=phase)[0]

    x = torch.randn((DS_MIXED_TOKENS, 1, d), generator=g, device=dev).to(bf)
    for phase in ("decode", "mixed"):
        full = ffn(x, phase)
        for r in (0, DS_MIXED_TOKENS // 2, DS_MIXED_TOKENS - 1):
            if not torch.equal(ffn(x[r:r + 1], phase)[0], full[r]):
                raise AssertionError(f"{what} FFN ({phase}): token {r} "
                                     f"alone differs from its row among "
                                     f"{DS_MIXED_TOKENS}")
    reaim = hier.dead_rows_to_sentinel
    hier.dead_rows_to_sentinel = lambda flat_sub, occ, sentinel: flat_sub
    try:
        kept = ffn(x[:BATCH], "decode")
    finally:
        hier.dead_rows_to_sentinel = reaim
    if not torch.equal(kept, ffn(x[:BATCH], "decode")):
        raise AssertionError("re-aiming dead outer rows at the sentinel "
                             "changed the hierarchical FFN's output")
    print(f"[invariance] {what} FFN ({cfg.cmoe.tag()}, the first MoE "
          f"layer, bf16): a token alone == its row among {DS_MIXED_TOKENS} at "
          f"decode (moe_gather) and on a fused step (moe_gmm_ragged), "
          f"bitwise; dead outer rows re-aimed at the sentinel or not: "
          f"bitwise equal ({BATCH} decode tokens)")

    # moe_gmm_ragged at a 4 x 32 prefill
    xp = torch.randn((BATCH, PROMPT, d), generator=g, device=dev).to(bf)
    _, (args, kw), _ = capture_call("moe_gmm_ragged",
                                    lambda: ffn(xp, "prefill"))
    lay, owner, wg, wu, wd = args
    block = kw["block_c"]
    m = wg.shape[2]
    got = routed("moe_gmm_ragged", "tensor_core",
                 lambda: ops.moe_gmm_ragged(*args, **kw))
    live = lay.abs().amax(dim=1) > 0                       # rows with data
    tiles = live.reshape(-1, block).any(dim=1)
    err = check(f"moe_gmm_ragged {what} ({wg.shape[0]} sub-experts)",
                got, moe_gmm_ragged_plain(*args, "swiglu", block), bf)
    n_live = int(live.sum())
    distinct, (b_ms, b_by) = live_bound(
        n_live, n_live, owner[tiles].long(), d, m)

    def chain(xp_, o, wg_, wu_, wd_):
        own = o.long()
        xb = xp_.reshape(-1, block, d)
        h = F.silu(torch.bmm(xb, wg_[own])) * torch.bmm(xb, wu_[own])
        return torch.bmm(h, wd_[own])

    kernel = lambda *a: ops.moe_gmm_ragged(*a, block_c=block)  # noqa: E731
    rec = dict(shape=f"P={lay.shape[0]} live rows={n_live} in "
                     f"{int(tiles.sum())} of {tiles.numel()} tiles, "
                     f"E'={wg.shape[0]} d={d} m'={m} distinct live "
                     f"sub-experts={distinct}",
               max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
               ms=time_ms(kernel, [args], iters=10),
               graph_ms=graph_ms(kernel, [args], iters=10),
               plain_ms=time_ms(lambda *a: moe_gmm_ragged_plain(
                   *a, "swiglu", block), [args], iters=3),
               library_ms=time_ms(chain, [args], iters=3))
    cut = int(tiles.nonzero().max()) + 1          # through the last live tile
    rec["live_tiles_ms"] = time_ms(
        kernel, [[lay[:cut * block], owner[:cut], wg, wu, wd]], iters=10)
    records["moe_gmm_ragged"][key] = rec
    print(f"[time] moe_gmm_ragged {what} prefill ({rec['shape']}): "
          f"{rec['ms']:.4f} ms ({rec['graph_ms']:.4f} in a CUDA graph), "
          f"through the last live tile {rec['live_tiles_ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms, chain {rec['library_ms']:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by})")

    # moe_gather at a 4-token decode
    xd = torch.randn((BATCH, 1, d), generator=g, device=dev).to(bf)
    _, (args, kw), _ = capture_call("moe_gather",
                                    lambda: ffn(xd, "decode"))
    xf, ids, wg, wu, wd = args
    n_sub = wg.shape[0]
    got = routed("moe_gather", "tensor_core",
                 lambda: ops.moe_gather(*args, **kw))
    live = ids < n_sub
    row_live = live.reshape(-1, k).any(dim=1)
    tok = row_live.nonzero()[:, 0]                          # outer live rows
    sel = torch.cat([tok, (~row_live).nonzero()[:1, 0]])    # and a dead one
    sub_ids = ids.reshape(-1, k)[sel].reshape(-1)
    err = check(f"moe_gather {what} ({n_sub} sub-experts, live outer "
                f"rows)", got.reshape(-1, k, d)[sel].reshape(-1, d),
                moe_gather_plain(xf[sel], sub_ids, wg, wu, wd, top_k=k), bf,
                sentinel_rows=sub_ids == n_sub)
    if got[~live].abs().max() != 0:
        raise AssertionError("moe_gather: sentinel rows are not exactly zero")
    n_live = int(live.sum())
    distinct, (b_ms, b_by) = live_bound(n_live, int(tok.numel()), ids[live],
                                        d, wg.shape[2])
    kernel = lambda *a: ops.moe_gather(*a, top_k=k)  # noqa: E731
    sub = [xf[tok], ids.reshape(-1, k)[tok].reshape(-1), wg, wu, wd]

    def chain(xf_, i, wg_, wu_, wd_):
        i = i.long().clamp(max=n_sub - 1)
        xr = xf_.repeat_interleave(k, dim=0)[:, None]
        h = F.silu(torch.bmm(xr, wg_[i])) * torch.bmm(xr, wu_[i])
        return torch.bmm(h, wd_[i])[:, 0]

    rec = dict(shape=f"rows={ids.numel()} live={n_live} (outer rows "
                     f"{xf.shape[0]}, live {tok.numel()}) E'={n_sub} d={d} "
                     f"m'={wg.shape[2]} distinct live sub-experts="
                     f"{distinct}",
               max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
               ms=time_ms(kernel, [args], iters=10),
               graph_ms=graph_ms(kernel, [args], iters=10),
               live_rows_ms=time_ms(kernel, [sub], iters=10),
               plain_live_rows_ms=time_ms(
                   lambda *a: moe_gather_plain(*a, top_k=k), [sub], iters=3),
               library_live_rows_ms=time_ms(chain, [sub], iters=3))
    records["moe_gather"][key] = rec
    print(f"[time] moe_gather {what} decode ({rec['shape']}): "
          f"{rec['ms']:.4f} ms ({rec['graph_ms']:.4f} in a CUDA graph); on "
          f"the live outer rows alone {rec['live_rows_ms']:.4f} ms, plain "
          f"{rec['plain_live_rows_ms']:.4f} ms, chain "
          f"{rec['library_live_rows_ms']:.4f} ms; bound {b_ms:.4f} ms "
          f"({b_by})")


def conversion_cost() -> None:
    """The host's share of a hierarchical conversion, at deepseek-v2's
    expert width (d 5120, m 1536, bfloat16, CALIB_ROWS calibration rows,
    DS_HIER_CMOE): one expert's convert_expert (profile on the card,
    partition on the host), and 8 experts' partitions one after another and
    on the thread pool convert_moe_model uses, which must agree bit for
    bit."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import hierarchical as hier
    from repro_torch.core.partition import partition_neurons
    from repro_torch.launch.serve import parse_sxayez

    cfg = get_config(DS_ARCH)
    d, m = cfg.d_model, cfg.moe.d_expert
    cm = parse_sxayez(DS_HIER_CMOE)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    x = torch.randn((CALIB_ROWS, d), generator=g, device=dev).to(
        torch.bfloat16)
    profiles, seconds = [], []
    for _ in range(8):
        w = {n: (torch.randn(s, generator=g, device=dev) * s[0] ** -0.5).to(
            torch.bfloat16) for n, s in (("wg", (d, m)), ("wu", (d, m)),
                                         ("wd", (m, d)))}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hier.convert_expert(w["wg"], w["wu"], w["wd"], x, cm, cfg.activation)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        profiles.append(hier.profile_expert(w, x, cm, cfg.activation))
    t0 = time.perf_counter()
    serial = [partition_neurons(a, mu, cm) for a, mu in profiles]
    t_serial = time.perf_counter() - t0
    t0 = time.perf_counter()
    pooled = hier.partition_profiles(profiles, cm)
    t_pool = time.perf_counter() - t0
    for one, other in zip(serial, pooled):
        if not ((one.routed_idx == other.routed_idx).all() and
                (one.rep_idx == other.rep_idx).all() and
                (one.shared_idx == other.shared_idx).all()):
            raise AssertionError("the thread pool's partitions differ from "
                                 "the serial loop's")
    print(f"[convert] one expert's convert_expert at {d}x{m} "
          f"({DS_HIER_CMOE}, {CALIB_ROWS} calibration rows): "
          f"{min(seconds[1:]):.3f}-{max(seconds[1:]):.3f} s after the first "
          f"({seconds[0]:.3f} s); 8 partitions {t_serial:.3f} s serially, "
          f"{t_pool:.3f} s on {len(os.sched_getaffinity(0))} threads, "
          f"bitwise equal")


def step_trace(model, params, prompts, host_ms: dict, what: str) -> dict:
    """Where a static prefill of `prompts` and a decode step (a lane each)
    spend the card's time: each CUDA kernel's device ms a call
    (torch.profiler), their sum against the static path's host-timed ms,
    and the kernels that take most of it. Returns the device ms a call by
    phase."""
    import torch
    seq = prompts.shape[1]
    _, cache = model.prefill(params, {"tokens": prompts}, max_len=seq + GEN)
    tok = prompts[:, -1:]
    calls = {"prefill": lambda: model.prefill(params, {"tokens": prompts}),
             "decode": lambda: model.decode_step(params, tok, cache, seq)}
    busy_ms = {phase: trace_line(f"{what} {phase}", fn, host_ms[phase])
               for phase, fn in calls.items()}
    del cache
    torch.cuda.synchronize()
    return busy_ms


def deepseek_hierarchical(records: dict) -> tuple[dict, dict]:
    """Phase 5d: deepseek-v2 at full width, bfloat16, DS_HIER_LAYERS
    layers, converted hierarchically (DS_HIER_CMOE) once through the CLI's
    static entry point, then checked (all-active exactness, the FFN's
    checks) and served by the engine. Returns the launch counts of the
    static run and of the engine run."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_map

    print(f"[cut] {DS_ARCH} hierarchical {DS_HIER_CMOE}: depth 60 -> "
          f"{DS_HIER_LAYERS} layers (phase 5d, bfloat16; every width as "
          f"published); converted once on the CLI's 4 x 128 calibration "
          f"batch; requests and generated tokens as in phases 3b and 4")
    free_device("phase 5d")
    conversion_cost()
    torch.cuda.reset_peak_memory_stats()
    ref = serve.run(DS_HIER_ARGS)
    ref_logits = ref["prefill_logits"]
    print(f"[e2e deepseek hierarchical] unconverted reference, "
          f"{DS_HIER_LAYERS} layers: prefill {ref['prefill_ms']:.2f} ms, "
          f"decode {ref['decode_tok_s']:.1f} tok/s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    del ref
    free_device("phase 5d's conversion")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res = serve.run(DS_HIER_ARGS + ["--cmoe", DS_HIER_CMOE])
    torch.cuda.synchronize()
    static = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    toks = torch.as_tensor(res["tokens"])
    vocab = get_config(DS_ARCH).vocab_size
    if toks.shape != (BATCH, GEN) or toks.min() < 0 or \
            toks.max() >= vocab or \
            not torch.isfinite(res["prefill_logits"]).all():
        raise AssertionError(f"bad hierarchical serve output: tokens "
                             f"{tuple(toks.shape)}")
    if res["backends"] != {"prefill": "grouped_kernel", "decode": "gather"}:
        raise AssertionError(f"hierarchical backends per phase: "
                             f"{res['backends']}")
    # the calibration forward of the unconverted model runs moe_gmm_ragged
    # once a layer; the converted prefills (a warm-up and the timed ones)
    # once a layer each, and only the converted decode runs moe_gather
    want = DS_HIER_LAYERS * (2 + serve.PREFILL_REPEATS)
    if static["moe_gmm_ragged"] < want or static["moe_gather"] <= 0:
        raise AssertionError(f"hierarchical static path launches {static}: "
                             f"want moe_gmm_ragged >= {want} and moe_gather "
                             f"> 0")
    agree = int((res["prefill_logits"].argmax(-1) ==
                 ref_logits.argmax(-1)).sum())
    print(f"[e2e deepseek hierarchical] static {DS_HIER_CMOE}: convert "
          f"{res['convert_s']:.2f} s (profile {res['convert_profile_s']:.2f}"
          f" s, cluster {res['convert_cluster_s']:.2f} s), prefill "
          f"{res['prefill_ms']:.2f} ms ({BATCH}x{PROMPT}, median of "
          f"{serve.PREFILL_REPEATS} warm), decode {res['decode_tok_s']:.1f} "
          f"tok/s ({BATCH} lanes, {GEN - 1} steps), peak {peak:.1f} GB, "
          f"first greedy token as unconverted {agree}/{BATCH}, launches "
          f"{static}")
    kernel_routes("phase 5d hierarchical static bf16", "tensor_core")
    model, params = res["model"], res["params"]
    host_ms = {"prefill": res["prefill_ms"],
               "decode": 1e3 * BATCH / res["decode_tok_s"]}
    del res

    # all-active: the converted weights with every routed sub-expert on
    cm = model.cfg.cmoe
    m_all = build_model(model.cfg.with_cmoe(dataclasses.replace(
        cm, top_k=cm.num_routed)), use_kernel=True, device="cuda")
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, vocab, (BATCH, PROMPT)), dtype=torch.long, device="cuda")
    logits = m_all.prefill(params, {"tokens": prompts})[0].float().cpu()
    err = (logits - ref_logits).abs().max().item()
    scale = ref_logits.abs().max().item()
    if not (torch.isfinite(logits).all() and
            err <= DS_HIER_ALL_ACTIVE_TOL * scale):
        raise AssertionError(f"all-active conversion: max|err| {err:.3e} > "
                             f"{DS_HIER_ALL_ACTIVE_TOL} x max|logit| "
                             f"{scale:.3e}")
    print(f"[e2e deepseek hierarchical] all {cm.num_routed} routed "
          f"sub-experts active vs the unconverted model, prefill logits "
          f"{BATCH}x{PROMPT}: max|err| / max|logit| {err / scale:.3e} (tol "
          f"{DS_HIER_ALL_ACTIVE_TOL}), greedy tokens agree "
          f"{int((logits.argmax(-1) == ref_logits.argmax(-1)).sum())}/"
          f"{BATCH}")
    del m_all
    step_trace(model, params, prompts, host_ms, "hierarchical")
    hierarchical_ffn_checks(
        model, tree_map(lambda a: a[0], params["blocks"]), records)

    engine = engine_run(model, params, "deepseek hierarchical", "5d",
                        ("mla_paged_decode", "moe_gmm_ragged", "moe_gather"))
    return static, engine


def glu_act(activation: str):
    """The GLU activation of the PyTorch chains that yardstick the FFN
    kernels (swish for swiglu, tanh-approximated GELU for geglu)."""
    import torch.nn.functional as F
    if activation == "swiglu":
        return F.silu
    return lambda v: F.gelu(v, approximate="tanh")


def swiglu_check(model, params, prompts, records: dict, key: str) -> None:
    """swiglu_ffn on the inputs the first dense FFN of a prefill of
    `prompts` gives it, against its plain version, timed beside a chain of
    PyTorch calls and a bound; the record goes under
    records["swiglu_ffn"][key]."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.swiglu import swiglu_ffn_plain

    cfg = model.cfg
    d = cfg.d_model
    act = glu_act(cfg.activation)
    _, (args, kw), _ = capture_call("swiglu_ffn", lambda: model.prefill(
        params, {"tokens": prompts}))
    x, wg, wu, wd = args
    args = [x.reshape(-1, d), wg, wu, wd]
    t, f = args[0].shape[0], wg.shape[1]
    got = routed("swiglu_ffn", "tensor_core",
                 lambda: ops.swiglu_ffn(*args, **kw))
    err = check(f"swiglu_ffn {cfg.name} dense layer (T={t} d={d} f={f} "
                f"{cfg.activation})", got,
                swiglu_ffn_plain(*args, cfg.activation), torch.bfloat16)
    b_ms, b_by = bound(6 * t * d * f, 2 * (3 * d * f + 2 * t * d),
                       "bfloat16")
    rec = dict(shape=f"T={t} d={d} f={f} {cfg.activation}", max_abs_err=err,
               bound_ms=b_ms, bound_by=b_by,
               ms=time_ms(lambda *a: ops.swiglu_ffn(*a, **kw), [args],
                          iters=20),
               plain_ms=time_ms(lambda *a: swiglu_ffn_plain(
                   *a, cfg.activation), [args], iters=3),
               library_ms=time_ms(lambda x_, wg_, wu_, wd_: (
                   act(x_ @ wg_) * (x_ @ wu_)) @ wd_, [args], iters=10))
    records["swiglu_ffn"][key] = rec
    print(f"[time] swiglu_ffn {cfg.name} dense prefill ({rec['shape']}): "
          f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, chain "
          f"{rec['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")


def ragged_check(model, params, prompts, records: dict, key: str) -> None:
    """moe_gmm_ragged on the inputs the first routed-expert layer of a
    prefill of `prompts` gives it. The plain version copies each layout
    tile's expert slabs in float32, so the kernel is held to it on
    L4_CHECK_TILES live tiles spread over the layout (a tile's rows depend
    on that tile alone); the subset is timed on the kernel, the plain
    version and a chain of PyTorch calls, the whole layout on the kernel
    beside a bound that counts live rows and experts. The record goes
    under records["moe_gmm_ragged"][key]."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_gmm import moe_gmm_ragged_plain

    cfg = model.cfg
    dev = prompts.device
    d = cfg.d_model
    act = glu_act(cfg.activation)
    _, (args, kw), _ = capture_call("moe_gmm_ragged", lambda: model.prefill(
        params, {"tokens": prompts}))
    lay, owner, wg, wu, wd = args
    block = kw["block_c"]
    m = wg.shape[2]
    got = routed("moe_gmm_ragged", "tensor_core",
                 lambda: ops.moe_gmm_ragged(*args, **kw))
    live = lay.abs().amax(dim=1) > 0
    tiles = live.reshape(-1, block).any(dim=1)
    live_tiles = tiles.nonzero()[:, 0]
    pick = live_tiles[torch.linspace(
        0, live_tiles.numel() - 1, min(L4_CHECK_TILES, live_tiles.numel()),
        device=dev).long()]
    rows = (pick[:, None] * block +
            torch.arange(block, device=dev)[None, :]).reshape(-1)
    sub = [lay[rows].contiguous(), owner[pick].contiguous(), wg, wu, wd]
    err = check(f"moe_gmm_ragged {cfg.name} ({wg.shape[0]} experts of "
                f"{m}, {pick.numel()} live tiles of {tiles.numel()})",
                got[rows], moe_gmm_ragged_plain(*sub, **kw), torch.bfloat16)
    n_live = int(live.sum())
    distinct, (b_ms, b_by) = live_bound(n_live, n_live,
                                        owner[tiles].long(), d, m)

    def tile_chain(xp_, o, wg_, wu_, wd_):
        own = o.long()
        xb = xp_.reshape(-1, block, d)
        h = act(torch.bmm(xb, wg_[own])) * torch.bmm(xb, wu_[own])
        return torch.bmm(h, wd_[own])

    kernel = lambda *a: ops.moe_gmm_ragged(*a, **kw)  # noqa: E731
    cut = int(live_tiles.max()) + 1               # through the last live tile
    rec = dict(shape=f"P={lay.shape[0]} live rows={n_live} in "
                     f"{int(tiles.sum())} of {tiles.numel()} tiles, "
                     f"E={wg.shape[0]} d={d} m={m} distinct live "
                     f"experts={distinct} {cfg.activation}",
               max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
               ms=time_ms(kernel, [args], iters=10),
               live_tiles_ms=time_ms(kernel, [[lay[:cut * block],
                                               owner[:cut], wg, wu, wd]],
                                     iters=10),
               subset=f"{pick.numel()} live tiles",
               subset_ms=time_ms(kernel, [sub], iters=10),
               plain_subset_ms=time_ms(lambda *a: moe_gmm_ragged_plain(
                   *a, **kw), [sub], iters=3),
               library_subset_ms=time_ms(tile_chain, [sub], iters=3))
    records["moe_gmm_ragged"][key] = rec
    print(f"[time] moe_gmm_ragged {cfg.name} prefill ({rec['shape']}): "
          f"{rec['ms']:.4f} ms, through the last live tile "
          f"{rec['live_tiles_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); on "
          f"{rec['subset']}: {rec['subset_ms']:.4f} ms, plain "
          f"{rec['plain_subset_ms']:.4f} ms, chain "
          f"{rec['library_subset_ms']:.4f} ms")


def gather_check(model, params, prompts, records: dict, key: str) -> None:
    """moe_gather on the inputs the first routed-expert layer of a decode
    step (a lane for each prompt, after their prefill) gives it, against
    its plain version, timed back to back and in a CUDA graph beside a
    chain of PyTorch calls and a bound that counts live rows and experts.
    The record goes under records["moe_gather"][key]."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_gather import moe_gather_plain

    cfg = model.cfg
    d = cfg.d_model
    act = glu_act(cfg.activation)
    seq = prompts.shape[1]
    _, cache = model.prefill(params, {"tokens": prompts}, max_len=seq + 1)
    _, (args, kw), _ = capture_call("moe_gather", lambda: model.decode_step(
        params, prompts[:, -1:], cache, seq))
    del cache
    xf, ids, wg, wu, wd = args
    m = wg.shape[2]
    got = routed("moe_gather", "tensor_core",
                 lambda: ops.moe_gather(*args, **kw))
    dead = ids >= wg.shape[0]
    err = check(f"moe_gather {cfg.name} ({ids.numel()} rows, "
                f"{wg.shape[0]} experts of {m})", got,
                moe_gather_plain(*args, **kw), torch.bfloat16,
                sentinel_rows=dead if bool(dead.any()) else None)
    n_live = int((~dead).sum())
    distinct, (b_ms, b_by) = live_bound(n_live, xf.shape[0], ids[~dead], d,
                                        m)

    def row_chain(xf_, i, wg_, wu_, wd_):
        i = i.long().clamp(max=wg_.shape[0] - 1)
        xr = xf_.repeat_interleave(kw["top_k"], dim=0)[:, None]
        h = act(torch.bmm(xr, wg_[i])) * torch.bmm(xr, wu_[i])
        return torch.bmm(h, wd_[i])[:, 0]

    rec = dict(shape=f"rows={ids.numel()} live={n_live} E={wg.shape[0]} "
                     f"d={d} m={m} distinct live experts={distinct} "
                     f"{cfg.activation}",
               max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
               ms=time_ms(lambda *a: ops.moe_gather(*a, **kw), [args],
                          iters=20),
               graph_ms=graph_ms(lambda *a: ops.moe_gather(*a, **kw),
                                 [args], iters=20),
               plain_ms=time_ms(lambda *a: moe_gather_plain(*a, **kw),
                                [args], iters=5),
               library_ms=time_ms(row_chain, [args], iters=5))
    records["moe_gather"][key] = rec
    print(f"[time] moe_gather {cfg.name} decode ({rec['shape']}): "
          f"{rec['ms']:.4f} ms ({rec['graph_ms']:.4f} in a CUDA graph), "
          f"plain {rec['plain_ms']:.4f} ms, chain {rec['library_ms']:.4f} "
          f"ms, bound {b_ms:.4f} ms ({b_by})")


def llama4_ffn_checks(model, params, records: dict) -> None:
    """Phase 5e on the unconverted model: its three FFN kernels on the
    inputs the path gives them, captured from a 4 x L4_PROMPT prefill
    (swiglu_ffn in the dense layer, moe_gmm_ragged past the break-even)
    and a 4-lane decode step (moe_gather), each against its plain version
    and timed beside a chain of PyTorch calls and a bound. The records go
    under records[kernel]["llama4"]."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(6)
    prompts = torch.randint(0, model.cfg.vocab_size, (BATCH, L4_PROMPT),
                            generator=g, device="cuda")
    for fn in (swiglu_check, ragged_check, gather_check):
        fn(model, params, prompts, records, "llama4")


def engine_run(model, params, tag: str, phase: str, want: tuple) -> dict:
    """The engine (serve_continuous with phase 4's engine flags) on
    `model`, counts zeroed before and read after: every request done,
    both parity replays, no dropped pair, a clean audit, and each kernel
    of `want` launched. Returns the launch counts."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    args = serve.parser().parse_args(
        ENGINE_ARGS[ENGINE_ARGS.index("--continuous"):])
    torch.cuda.synchronize()
    ops.reset_launches()
    res = serve.serve_continuous(model, params, args)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    rep = res["report"]
    if res["parity"] != ["overlap == sequential", "paged == contiguous"]:
        raise AssertionError(f"{tag} engine parity replays {res['parity']}")
    if not all(r.done for r in rep.requests) or rep.dropped_pairs or \
            not rep.pool_audit.get("ok") or rep.pool_audit.get("allocated"):
        raise AssertionError(f"{tag} engine: unfinished requests, drops or "
                             f"a bad audit {rep.pool_audit}")
    for name in want:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{tag} engine's path")
    bc = {ph: dict(c) for ph, c in rep.backend_counts.items()}
    print(f"[e2e {tag} engine] {rep.num_requests} requests, "
          f"{rep.total_new_tokens} tokens in {rep.steps} steps, wall "
          f"{rep.wall_s:.3f} s, goodput {rep.goodput:.1f} tok/s, TTFT "
          f"p50/p95 {rep.ttft_p50_s * 1e3:.1f}/{rep.ttft_p95_s * 1e3:.1f} "
          f"ms, TPOT p50/p95 {rep.tpot_p50_s * 1e3:.2f}/"
          f"{rep.tpot_p95_s * 1e3:.2f} ms, overlap occupancy "
          f"{rep.overlap_occupancy:.3f}, backends {bc}, audit "
          f"{rep.pool_audit}, parity {res['parity']}, launches {launches}, "
          f"peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    kernel_routes(f"phase {phase} {tag} engine bf16", "tensor_core")
    return launches


def static_run(argv: list, tag: str, phase: str, want: tuple = (
        "swiglu_ffn", "moe_gmm_ragged", "moe_gather"),
        backends: Optional[dict] = None) -> tuple[dict, dict]:
    """serve.run(argv) with the peak and the launch counts zeroed before
    and read after; checks its tokens, logits and backends per phase
    (default grouped_kernel / gather), and that each kernel of `want` was
    launched. Returns (its result, the launch counts)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    if backends is None:
        backends = {"prefill": "grouped_kernel", "decode": "gather"}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res = serve.run(argv)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    toks = torch.as_tensor(res["tokens"])
    vocab = res["model"].cfg.vocab_size
    if toks.shape != (BATCH, GEN) or toks.min() < 0 or \
            toks.max() >= vocab or \
            not torch.isfinite(res["prefill_logits"]).all():
        raise AssertionError(f"bad {tag} serve output: tokens "
                             f"{tuple(toks.shape)}")
    if res["backends"] != backends:
        raise AssertionError(f"{tag} backends per phase: {res['backends']}")
    for name in want:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{tag} static path: {launches}")
    convert = "" if "convert_s" not in res else (
        f"convert {res['convert_s']:.2f} s (profile "
        f"{res['convert_profile_s']:.2f} s, cluster "
        f"{res['convert_cluster_s']:.2f} s), ")
    peaks = ", ".join(f"{k} {v:.2f}" for k, v in res["peak_gb"].items())
    prompt = argv[argv.index("--prompt-len") + 1]
    print(f"[e2e {tag}] static: {convert}prefill {res['prefill_ms']:.2f} ms "
          f"({BATCH}x{prompt}, median of {serve.PREFILL_REPEATS} warm), "
          f"decode {res['decode_tok_s']:.1f} tok/s ({BATCH} lanes, "
          f"{GEN - 1} steps), peak GB after {peaks}, launches {launches}")
    kernel_routes(f"phase {phase} {tag} static bf16", "tensor_core")
    return res, launches


def llama4_phase(records: dict) -> dict:
    """Phase 5e: llama4-maverick-400b-a17b at full width, bfloat16, one
    period (L4_LAYERS), through the CLI's entry points: unconverted static
    (the reference logits), its FFN kernels on their own inputs, the
    device time of a prefill and a decode step, the engine; then converted
    to L4_CMOE once through the static entry point, all-active exactness,
    the same for the converted model, and its engine. Returns the launch
    counts of the four runs."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_map

    base = get_config(L4_ARCH)
    print(f"[cut] {L4_ARCH}: depth {base.num_layers} -> {L4_LAYERS} layers "
          f"(phase 5e, bfloat16: one dense and one MoE layer); every width "
          f"as published (d_model {base.d_model}, {base.num_heads} heads "
          f"on {base.num_kv_heads} kv heads of {base.resolved_head_dim}, "
          f"{base.moe.num_experts} experts of {base.moe.d_expert} top-"
          f"{base.moe.top_k} + {base.moe.num_shared} shared, d_ff "
          f"{base.d_ff}, vocab {base.vocab_size}); prefill {BATCH}x"
          f"{L4_PROMPT}, past the break-even of "
          f"{base.moe.num_experts // base.moe.top_k} tokens")
    free_device("phase 5e")
    launches = {}
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, base.vocab_size, (BATCH, L4_PROMPT)), dtype=torch.long,
        device="cuda")
    res, launches["static"] = static_run(L4_ARGS, "llama4", "5e")
    ref_logits = res["prefill_logits"]          # on the host
    model, params = res["model"], res["params"]
    host_ms = {"prefill": res["prefill_ms"],
               "decode": 1e3 * BATCH / res["decode_tok_s"]}
    del res
    step_trace(model, params, prompts, host_ms, "llama4")
    llama4_ffn_checks(model, params, records)
    launches["engine"] = engine_run(
        model, params, "llama4", "5e",
        ("swiglu_ffn", "moe_gather", "paged_attn_decode"))
    del model, params
    free_device("phase 5e's conversion")

    res, launches["hierarchical_static"] = static_run(
        L4_ARGS + ["--cmoe", L4_CMOE], "llama4 hierarchical", "5e")
    model, params = res["model"], res["params"]
    host_ms = {"prefill": res["prefill_ms"],
               "decode": 1e3 * BATCH / res["decode_tok_s"]}
    agree = int((res["prefill_logits"].argmax(-1) ==
                 ref_logits.argmax(-1)).sum())
    print(f"[e2e llama4 hierarchical] first greedy token as unconverted "
          f"{agree}/{BATCH}")
    del res
    cm = model.cfg.cmoe
    m_all = build_model(model.cfg.with_cmoe(dataclasses.replace(
        cm, top_k=cm.num_routed)), use_kernel=True, device="cuda")
    logits = m_all.prefill(params, {"tokens": prompts})[0].float().cpu()
    err = (logits - ref_logits).abs().max().item()
    scale = ref_logits.abs().max().item()
    if not (torch.isfinite(logits).all() and
            err <= DS_HIER_ALL_ACTIVE_TOL * scale):
        raise AssertionError(f"llama4 all-active conversion: max|err| "
                             f"{err:.3e} > {DS_HIER_ALL_ACTIVE_TOL} x "
                             f"max|logit| {scale:.3e}")
    print(f"[e2e llama4 hierarchical] all {cm.num_routed} routed "
          f"sub-experts active vs the unconverted model, prefill logits "
          f"{BATCH}x{L4_PROMPT}: max|err| / max|logit| {err / scale:.3e} "
          f"(tol {DS_HIER_ALL_ACTIVE_TOL}), greedy tokens agree "
          f"{int((logits.argmax(-1) == ref_logits.argmax(-1)).sum())}/"
          f"{BATCH}")
    del m_all, logits
    step_trace(model, params, prompts, host_ms, "llama4 hierarchical")
    hierarchical_ffn_checks(
        model, tree_map(lambda a: a[0], params["blocks_moe"]), records,
        key="llama4_hierarchical")
    launches["hierarchical_engine"] = engine_run(
        model, params, "llama4 hierarchical", "5e",
        ("swiglu_ffn", "moe_gmm_ragged", "moe_gather", "paged_attn_decode"))
    del model, params
    free_device("the phases after 5e")
    return launches


def dense_f32_agreement(arch: str, key: str) -> dict:
    """Phase 8a for one arch: its published widths in float32, cut to
    DENSE_F32_LAYERS layers, the kernel path (swiglu_ffn for a GLU FFN,
    paged_attn_decode) against the plain path on one set of weights
    through Model.step on a paged cache (paged_agreement); internvl2's
    prefill carries VLM_PATCHES random patch embeddings before PROMPT text
    tokens. Returns the launch counts."""
    import numpy as np
    import torch

    from repro_torch.config import override
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    dev = torch.device("cuda")
    cfg = override(get_config(arch), dtype="float32",
                   num_layers=DENSE_F32_LAYERS)
    k_model = build_model(cfg, use_kernel=True, device=dev)
    p_model = build_model(cfg, use_kernel=False, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = k_model.init(gen)
    extras, patches = None, 0
    if cfg.family == "vlm":
        patches = VLM_PATCHES
        width = cfg.vision.d_patch or cfg.d_model
        extras = {"patches": torch.randn((BATCH, patches, width),
                                         generator=gen, device=dev)}
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, patches + PROMPT)), dtype=torch.long,
        device=dev)
    paged_agreement(k_model, p_model, params, prompts, gen, f"{key} f32",
                    extras=extras)
    launches = dict(ops.LAUNCHES)
    want = ["paged_attn_decode"]
    if cfg.activation in ("swiglu", "geglu"):
        want.append("swiglu_ffn")
    for name in want:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{key} f32 kernel path: {launches}")
    kernel_routes(f"phase 8a {key} f32 kernel path", "simt")
    return launches


def paged_step_check(model, params, records: dict, key: str,
                     seq: int = PAGED_STEP_DEPTH) -> None:
    """paged_attn_decode on the inputs a paged decode step of `model` gives
    its first layer: BATCH lanes prefilled to `seq` tokens through
    fragmented block tables, then one decode step (the engine's Model.step
    with block tables). Held against the plain version, timed back to back
    and in a CUDA graph beside the bound of the K/V rows in the layer's
    window; the record goes under records["paged_attn_decode"][key]. Where
    the window is shorter than the depth, the step also reports how far
    the plain version without the window lies from the windowed one."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import paged_attn_decode_plain

    dev = torch.device("cuda")
    rows, bs = BATCH, 16
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    nblk = -(-(seq + 1) // bs)
    table = (torch.randperm(rows * nblk, generator=g, device=dev) + 1
             ).reshape(rows, nblk).to(torch.int32)
    pool = model.init_paged_cache(1 + rows * nblk, bs)
    prompts = torch.randint(0, model.cfg.vocab_size, (rows, seq),
                            generator=g, device=dev)
    model.step(params, prompts, pool, torch.zeros((rows,), dtype=torch.int32,
                                                  device=dev),
               block_tables=table)
    _, (args, kw), _ = capture_call("paged_attn_decode", lambda: model.step(
        params, prompts[:, -1:], pool,
        torch.full((rows,), seq, dtype=torch.int32, device=dev),
        block_tables=table))
    q, kp, vp = args
    kh, hd = kp.shape[2:]
    grp = q.shape[2] // kh
    got = ops.paged_attn_decode(*args, **kw)
    err = check(f"paged_attn_decode {model.cfg.name} decode step (rows "
                f"{rows}, {kh} kv heads x {grp} of {hd}, depth {seq + 1}, "
                f"window {kw['window']})", got,
                paged_attn_decode_plain(q, kp, vp, kw["table"], kw["pos"],
                                        kw["window"], scale=kw["scale"]),
                torch.bfloat16)
    live = seq + 1
    keys = live
    if 0 < kw["window"] < live:
        keys = kw["window"]
        full = paged_attn_decode_plain(q, kp, vp, kw["table"], kw["pos"],
                                       scale=kw["scale"]).float()
        moved = (full - got.float()).abs().max().item()
        if moved == 0:
            raise AssertionError(f"{key}: the window masked nothing")
        print(f"[window] {model.cfg.name} layer 0 reads the last {keys} of "
              f"{live} keys; the plain version without the window lies "
              f"{moved:.3e} from the kernel (max|err| {err:.3e} with it)")
    nbytes = (2 * rows * keys * kh * hd * 2 + 2 * rows * kh * grp * hd * 2
              + rows * (nblk + 1) * 4)
    b_ms, b_by = bound(4 * rows * keys * kh * grp * hd, nbytes, "bfloat16")

    def kernel(*a):
        return ops.paged_attn_decode(*a, **kw)
    rec = dict(shape=f"rows={rows} kh={kh} grp={grp} hd={hd} bs={bs} "
                     f"depth={live} window={kw['window']}",
               max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
               ms=time_ms(kernel, [args]), graph_ms=graph_ms(kernel, [args]),
               plain_ms=time_ms(lambda *a: paged_attn_decode_plain(
                   *a, kw["table"], kw["pos"], kw["window"],
                   scale=kw["scale"]), [args], iters=10))
    records["paged_attn_decode"][key] = rec
    print(f"[time] paged_attn_decode {model.cfg.name} decode step "
          f"({rec['shape']}): {rec['ms']:.4f} ms ({rec['graph_ms']:.4f} ms "
          f"in a CUDA graph), plain {rec['plain_ms']:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})")
    del pool
    torch.cuda.synchronize()


def decode_share(model, params, prompts, module, name: str, busy_ms: float,
                 host_ms: float, what: str) -> None:
    """The share of a static decode step (a lane for each prompt, after
    their prefill) that the calls of <module>.<name> take: the step's calls
    counted, the first call's inputs timed with CUDA events, times the
    count, against the step's device time (`busy_ms`, from step_trace) and
    its time on the host's clock (`host_ms`)."""
    import torch
    seq = prompts.shape[1]
    _, cache = model.prefill(params, {"tokens": prompts}, max_len=seq + 1)
    fn = getattr(module, name)
    _, (args, kwargs), calls = capture_call(name, lambda: model.decode_step(
        params, prompts[:, -1:], cache, seq), module=module)
    del cache
    ms = time_ms(lambda *a: fn(*a, **kwargs), [list(args)], iters=10)
    total = ms * calls
    print(f"[share] {what}: {calls} call(s) of {name} in a decode step, "
          f"{ms:.4f} ms each, {total:.3f} ms: {total / busy_ms:.2f} of the "
          f"step's {busy_ms:.2f} ms of device time, {total / host_ms:.2f} of "
          f"its {host_ms:.2f} ms on the host's clock")
    torch.cuda.synchronize()


def dense_arch_phase(arch: str, key: str, layers: Optional[int],
                     records: dict) -> dict:
    """Phase 8 for one arch at its published widths, bfloat16, `layers`
    deep (None: all): (a) dense_f32_agreement at DENSE_F32_LAYERS; (b) the
    CLI's static path unconverted (the reference logits), with swiglu_ffn
    (phi3, gemma3) and paged_attn_decode on the inputs the path gives them
    (gemma3's again at WINDOW_STEP_DEPTH, past its sliding window);
    (c) the CLI's static path with --cmoe DENSE_CMOE (the conversion's
    seconds and the peak memory after init, conversion and serving), the
    device time of a converted prefill and decode step by kernel (phi3,
    gemma3, granite), gemma3's float32 LM head's share of a decode step and
    granite's plain non-GLU gather's, moe_gmm_ragged and moe_gather on
    their inputs (phi3, gemma3); (d) the engine on the converted model with
    phase 4's engine flags. Launch counts are zeroed before each run and
    read after: the GLU archs launch every FFN kernel; granite's GELU FFN
    runs plain products, as the reference's GLU-only kernels imply, and
    launches none. Returns the launch counts by run."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import experts
    from repro_torch.models import model as model_mod

    base = get_config(arch)
    glu = base.activation in ("swiglu", "geglu")
    ffn = ("swiglu_ffn", "moe_gmm_ragged", "moe_gather")
    depth = f"all {base.num_layers} layers" if layers is None else \
        f"depth {base.num_layers} -> {layers} layers"
    print(f"[cut] {arch}: {depth} (phase 8, bfloat16; {DENSE_F32_LAYERS} "
          f"in float32); every width as "
          f"published (d_model {base.d_model}, {base.num_heads} heads on "
          f"{base.num_kv_heads} kv heads of {base.resolved_head_dim}, d_ff "
          f"{base.d_ff} {base.activation}, vocab {base.vocab_size}"
          f"{', tied' if base.tie_embeddings else ''})")
    free_device(f"phase 8 {key}")
    launches = {"f32": dense_f32_agreement(arch, key)}
    free_device(f"phase 8 {key} bf16")

    def no_ffn_kernel(run: str) -> None:
        if not glu and any(launches[run][n] for n in ffn):
            raise AssertionError(f"{key} {run}: a GLU-only FFN kernel ran "
                                 f"on a {base.activation} FFN: "
                                 f"{launches[run]}")

    no_ffn_kernel("f32")
    argv = ["--arch", arch] + ([] if layers is None else
                               ["--layers", str(layers)]) + \
        ["--batch", str(BATCH), "--prompt-len", str(PROMPT), "--gen",
         str(GEN), "--seed", "0"]
    res, launches["dense_static"] = static_run(
        argv, key, "8b", want=ffn[:1] if glu else (),
        backends={"prefill": None, "decode": None})
    no_ffn_kernel("dense_static")
    ref_logits = res["prefill_logits"]
    model, params = res["model"], res["params"]
    del res
    # serve.run's prompts
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, base.vocab_size, (BATCH, PROMPT)), dtype=torch.long,
        device="cuda")
    if glu and key != "internvl2":
        swiglu_check(model, params, prompts, records, key)
    paged_step_check(model, params, records, key)
    if base.sliding_window:
        paged_step_check(model, params, records, f"{key}_window",
                         seq=WINDOW_STEP_DEPTH)
    del model, params
    free_device(f"phase 8 {key}'s conversion")

    res, launches["static"] = static_run(
        argv + ["--cmoe", DENSE_CMOE], f"{key} cmoe", "8c",
        want=ffn if glu else (),
        backends={"prefill": "grouped_kernel" if glu else "grouped_plain",
                  "decode": "gather"})
    no_ffn_kernel("static")
    model, params = res["model"], res["params"]
    host_ms = {"prefill": res["prefill_ms"],
               "decode": 1e3 * BATCH / res["decode_tok_s"]}
    agree = int((res["prefill_logits"].argmax(-1) ==
                 ref_logits.argmax(-1)).sum())
    print(f"[e2e {key} cmoe] first greedy token as unconverted "
          f"{agree}/{BATCH}")
    del res
    if key != "internvl2":
        busy = step_trace(model, params, prompts, host_ms, f"{key} cmoe")
        if key == "gemma3":
            decode_share(model, params, prompts, model_mod, "unembed",
                         busy["decode"], host_ms["decode"],
                         "gemma3 cmoe float32 LM head (unembed)")
        if key == "granite":
            decode_share(model, params, prompts, experts, "_gather",
                         busy["decode"], host_ms["decode"],
                         "granite cmoe plain non-GLU gather (routed experts)")
    if glu and key != "internvl2":
        ragged_check(model, params, prompts, records, f"{key}_cmoe")
        gather_check(model, params, prompts, records, f"{key}_cmoe")
    launches["engine"] = engine_run(
        model, params, f"{key} cmoe", "8d",
        ("moe_gmm_ragged", "moe_gather", "paged_attn_decode") if glu
        else ("paged_attn_decode",))
    no_ffn_kernel("engine")
    del model, params
    free_device(f"the phases after 8 {key}")
    return launches


def free_device(what: str) -> None:
    """Release what earlier phases left and print what is still allocated
    before `what`, before and after a garbage collection (a finished
    serving engine holds no reference cycle, so the two should agree)."""
    import torch
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"[memory] {before / 1e9:.3f} GB allocated before {what}, "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB after a collection")


def ssm_f32_agreement(arch: str) -> None:
    """Phase 6a for one arch: full published width and depth in float32,
    the kernel path (ssd_scan; zamba2's shared block also swiglu_ffn)
    against the plain path on one set of weights. Model.forward on
    SSM_FWD tokens (several chunks, so the carried state is exercised),
    then a 4 x 32 prefill from a fresh cache and 4 decode steps; both
    paths are fed the kernel path's greedy tokens."""
    import numpy as np
    import torch

    from repro_torch.config import override
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    free_device(f"{arch} f32")
    cfg = override(get_config(arch), dtype="float32")
    ops.reset_launches()
    k_model = build_model(cfg, use_kernel=True, device=dev)
    p_model = build_model(cfg, use_kernel=False, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = k_model.init(gen)
    torch.cuda.synchronize()
    print(f"[e2e {arch} f32] {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, float32: init {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, SSM_FWD),
                           dtype=torch.long, device=dev)

    def held(what, lk, lp):
        err = (lk - lp).abs().max().item()
        scale = lp.abs().max().item()
        if not (torch.isfinite(lk).all() and err <= 1e-3 * scale):
            raise AssertionError(f"{arch} f32 {what}: kernel path disagrees "
                                 f"with the plain path ({err:.3e} > 1e-3 x "
                                 f"{scale:.3e})")
        return err / scale, int((lk.argmax(-1) == lp.argmax(-1)).sum())

    with torch.no_grad():
        lk = k_model.forward(params, {"tokens": toks})
        lp = p_model.forward(params, {"tokens": toks})
        fwd_err, fwd_agree = held("forward", lk, lp)
        del lk, lp
        prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                               (BATCH, PROMPT)),
                                  dtype=torch.long, device=dev)
        steps = 4
        feed, logits = [prompts], {}
        for tag, m in (("kernel", k_model), ("plain", p_model)):
            lg, cache = m.prefill(params, {"tokens": prompts},
                                  max_len=PROMPT + steps)
            out = [lg.float()]
            for i in range(steps):
                if tag == "kernel":
                    feed.append(torch.argmax(out[-1], -1)[:, None])
                lg, cache = m.decode_step(params, feed[i + 1], cache,
                                          PROMPT + i)
                out.append(lg.float())
            logits[tag] = out
            del cache
    worst, agree = 0.0, 0
    for i, (lk, lp) in enumerate(zip(logits["kernel"], logits["plain"])):
        e, a = held("prefill" if i == 0 else f"decode step {i}", lk, lp)
        worst, agree = max(worst, e), agree + a
    print(f"[e2e {arch} f32] kernel vs plain: forward {SSM_FWD[0]}x"
          f"{SSM_FWD[1]} max|err| / max|logit| {fwd_err:.3e}, argmax agrees "
          f"{fwd_agree}/{SSM_FWD[0] * SSM_FWD[1]}; prefill {BATCH}x{PROMPT} "
          f"+ {steps} decode steps {worst:.3e} (tol 1e-3), greedy tokens "
          f"agree {agree}/{BATCH * (steps + 1)}")
    torch.cuda.synchronize()
    kernel_routes(f"phase 6a {arch} f32 kernel path", "simt")


def ssm_serving(arch: str) -> dict:
    """Phases 6b / 6c: `arch` in bfloat16 at full width and depth through
    the CLI's static entry point, launch counts zeroed before and read
    after. ssd_scan runs once per layer per prefill (the warm-up and
    PREFILL_REPEATS timed ones; decode steps take the recurrent form), and
    zamba2's shared block swiglu_ffn once per application per prefill and
    decode step. Returns the launch counts."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import hybrid_attn_layers

    cfg = get_config(arch)
    prefills = 1 + serve.PREFILL_REPEATS
    want = {"ssd_scan": cfg.num_layers * prefills}
    if cfg.family == "hybrid":
        apps = hybrid_attn_layers(cfg)[2]
        want["swiglu_ffn"] = apps * (prefills + GEN)   # warm-up + GEN - 1
    free_device(f"{arch} bf16")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res = serve.run(["--arch", arch, "--batch", str(BATCH), "--prompt-len",
                     str(PROMPT), "--gen", str(GEN), "--seed", "0"])
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    toks = torch.as_tensor(res["tokens"])
    if toks.shape != (BATCH, GEN) or toks.min() < 0 or \
            toks.max() >= cfg.vocab_size or \
            not torch.isfinite(res["prefill_logits"]).all():
        raise AssertionError(f"bad {arch} serve output: tokens "
                             f"{tuple(toks.shape)}")
    got = {k: v for k, v in launches.items() if v}
    if got != want:
        raise AssertionError(f"{arch} static path launches {got}, reckoned "
                             f"{want}")
    print(f"[e2e {arch} bf16] static: prefill {res['prefill_ms']:.2f} ms "
          f"({BATCH}x{PROMPT}, median of {serve.PREFILL_REPEATS} warm), "
          f"decode {res['decode_tok_s']:.1f} tok/s ({BATCH} lanes, "
          f"{GEN - 1} steps), peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches "
          f"{launches} (reckoned {want})")
    kernel_routes(f"phase 6 {arch} static bf16", "tensor_core")
    return launches


def layer0_qkv(params, cfg, tokens, positions):
    """Layer 0's normed input of `tokens` (its embeddings, as the stack
    starts) through the port's gqa_project_qkv and apply_rope: q, k, v of
    (B, S, H, hd)."""
    from repro_torch.models.attention import gqa_project_qkv
    from repro_torch.models.layers import apply_rope, embed, rms_norm

    x = rms_norm(embed(tokens, params["embed"]),
                 params["blocks"]["norm1"][0], cfg.norm_eps)
    p0 = {n: w[0] for n, w in params["blocks"]["attn"].items()}
    q, k, v = gqa_project_qkv(x, p0, cfg)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def heads_flat(x):
    """(B, S, H, hd) -> (B * H, S, hd), the attention kernels' layout."""
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()


def attention_pair() -> dict:
    """Phase 7: the attention pair at llama2-7b's full width (32 heads of
    128), through the reference's entry points ops.flash_attention and
    ops.flash_decode, held against their plain versions and the port's own
    static attention, once in float32 and once in bfloat16 on seeded random
    weights, depth cut to LLAMA_LAYERS. (a) Layer 0's q, k, v of a 1 x 4096
    prompt: causal against chunked_attention (what the static prefill
    runs), then non-causal with the last LLAMA_RAGGED keys dropped; and a
    causal call at the static main path's shape (4 x 32 tokens,
    qwen1.5-0.5b's 16 heads of 64, seeded random). (b) Model.prefill of 4 x
    1024 tokens into a contiguous cache of 1100, one Model.decode_step at
    position 1024, then layer 0's cache as that step leaves it against the
    step's post-RoPE layer-0 query (recomputed by the same functions; its k
    is checked bitwise against the cache's new row), against
    decode_attention. Launch counts are zeroed just before and read just
    after. Returns them."""
    import numpy as np
    import torch

    from repro_torch.config import override
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (ROUTE_LAUNCHES,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_decode import flash_decode_plain
    from repro_torch.models import build_model
    from repro_torch.models.attention import (chunked_attention,
                                              decode_attention)

    dev = torch.device("cuda")
    base = get_config(LLAMA_ARCH)
    print(f"[cut] {LLAMA_ARCH}: depth {base.num_layers} -> {LLAMA_LAYERS} "
          f"layers (phase 7 reads only layer 0's attention); every width "
          f"as published (d_model {base.d_model}, {base.num_heads} heads "
          f"of {base.resolved_head_dim}, d_ff {base.d_ff}, vocab "
          f"{base.vocab_size})")
    free_device("phase 7")
    rng = np.random.default_rng(7)
    nb, npr, max_len = LLAMA_DECODE.values()
    torch.cuda.synchronize()
    ops.reset_launches()
    ROUTE_LAUNCHES.clear()
    for dt in ("float32", "bfloat16"):
        cfg = override(base, dtype=dt, num_layers=LLAMA_LAYERS)
        model = build_model(cfg, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = model.init(gen)
        tdt = getattr(torch, dt)

        def held(what, got, plain, own):
            e1 = check(f"phase 7 {what} vs plain", got, plain, tdt)
            e2 = check(f"phase 7 {what} vs the port's own attention", got,
                       own, tdt)
            return e1, e2

        with torch.no_grad():
            # (a) prefill attention at 1 x 4096
            toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                (1, LLAMA_PREFILL)),
                                   dtype=torch.long, device=dev)
            q, k, v = layer0_qkv(params, cfg, toks,
                                 torch.arange(LLAMA_PREFILL, device=dev))
            qf, kf, vf = (heads_flat(a) for a in (q, k, v))
            got = ops.flash_attention(qf, kf, vf, causal=True)
            e = held(f"{dt} flash_attention causal {tuple(qf.shape)}", got,
                     flash_attention_plain(qf, kf, vf, True),
                     heads_flat(chunked_attention(q, k, v, causal=True)))
            t_r = LLAMA_PREFILL - LLAMA_RAGGED
            got = ops.flash_attention(qf, kf[:, :t_r], vf[:, :t_r],
                                      causal=False)
            held(f"{dt} flash_attention non-causal T={t_r}", got,
                 flash_attention_plain(qf, kf[:, :t_r], vf[:, :t_r], False),
                 heads_flat(chunked_attention(q, k[:, :t_r], v[:, :t_r],
                                              causal=False)))
            del q, k, v, qf, kf, vf, got
            qs = [(torch.randn((BATCH, PROMPT, 16, 64), generator=gen,
                               device=dev)).to(tdt) for _ in range(3)]
            got = ops.flash_attention(*(heads_flat(a) for a in qs))
            held(f"{dt} flash_attention static main path shape "
                 f"{BATCH}x{PROMPT}, 16 heads of 64", got,
                 flash_attention_plain(*(heads_flat(a) for a in qs)),
                 heads_flat(chunked_attention(*qs, causal=True)))

            # (b) one decode step against a contiguous cache
            prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                   (nb, npr)),
                                      dtype=torch.long, device=dev)
            logits, cache = model.prefill(params, {"tokens": prompts},
                                          max_len=max_len)
            tok = torch.argmax(logits, -1)[:, None]
            logits, cache = model.decode_step(params, tok, cache, npr)
            if logits.shape != (nb, cfg.vocab_size) or \
                    not torch.isfinite(logits).all():
                raise AssertionError(f"phase 7 {dt}: bad decode logits "
                                     f"{tuple(logits.shape)}")
            kc, vc = cache[0][0], cache[1][0]       # layer 0: (B, T, KH, hd)
            qd, kd, _ = layer0_qkv(params, cfg, tok,
                                   torch.arange(npr, npr + 1, device=dev))
            if not torch.equal(kc[:, npr], kd[:, 0].to(kc.dtype)):
                raise AssertionError(f"phase 7 {dt}: the recomputed layer-0 "
                                     f"k differs from the step's cache row")
            qdf, kcf, vcf = heads_flat(qd), heads_flat(kc), heads_flat(vc)
            got = ops.flash_decode(qdf, kcf, vcf, npr)
            d_err = held(f"{dt} flash_decode {tuple(kcf.shape)} pos={npr}",
                         got, flash_decode_plain(qdf, kcf, vcf, npr),
                         heads_flat(decode_attention(qd, kc, vc, pos=npr)))
        print(f"[phase 7 {dt}] {LLAMA_ARCH} prefill attention BH "
              f"{base.num_heads} x {LLAMA_PREFILL}: max|err| vs plain "
              f"{e[0]:.3e}, vs chunked_attention {e[1]:.3e}; decode BH "
              f"{nb * base.num_heads} x T {max_len} pos {npr}: vs plain "
              f"{d_err[0]:.3e}, vs decode_attention {d_err[1]:.3e}")
        del model, params, cache, logits
        free_device(f"phase 7 after {dt}")
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    want = {"flash_attention": 6, "flash_decode": 2}
    got = {n: launches[n] for n in want}
    if got != want:
        raise AssertionError(f"phase 7 launches {got}, want {want}")
    routes = dict(ROUTE_LAUNCHES)
    if routes != {"simt": 3, "tensor_core": 3}:
        raise AssertionError(f"phase 7 flash_attention routes {routes}: "
                             f"want the 3 float32 calls on the SIMT kernel "
                             f"and the 3 bfloat16 ones on the tensor cores")
    fd_routes = dict(ops.ROUTES["flash_decode"])
    if fd_routes != {"split": 2}:
        raise AssertionError(f"phase 7 flash_decode routes {fd_routes}: "
                             f"want both calls (D 128) on the split-KV core")
    n_ffn = launches["swiglu_ffn"]
    ffn = dict(ops.ROUTES["swiglu_ffn"])
    if ffn != {"simt": n_ffn // 2, "tensor_core": n_ffn // 2}:
        raise AssertionError(f"phase 7 swiglu_ffn routes {ffn} for {n_ffn} "
                             f"launches: want half (float32) on the SIMT "
                             f"kernel and half (bfloat16) on the tensor cores")
    print(f"[phase 7] launches {launches}; flash_attention routes {routes}; "
          f"flash_decode routes {fd_routes}; swiglu_ffn routes {ffn}")
    return launches


def whisper_batch(cfg, batch: int, prompt: int, seed: int, dev) -> dict:
    """Tokens (batch, prompt) and num_frames frame embeddings N(0, 1) of
    d_model, drawn with numpy from `seed` (the conv frontend is a stub)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, prompt))
    frames = rng.standard_normal(
        (batch, cfg.encoder.num_frames, cfg.d_model)).astype(np.float32)
    return {"tokens": torch.as_tensor(tokens, dtype=torch.long, device=dev),
            "frames": torch.as_tensor(frames, device=dev)}


def no_launches(tag: str) -> dict:
    """The launch counts since the last reset, which must all be 0: the
    enc-dec path runs no kernel (GELU FFN, plain attention), as the
    reference's runs no Pallas kernel."""
    from repro_torch.kernels import ops
    launches = dict(ops.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"{tag}: a kernel ran on whisper's path, "
                             f"which has none: {launches}")
    return launches


def whisper_f32_agreement() -> dict:
    """Phase 9a: whisper-small at full width, WHISPER_F32_LAYERS encoder and
    decoder layers, float32: one set of weights on the card and through the
    port on the CPU, a prefill of WHISPER_F32_PROMPT over num_frames frames
    then WHISPER_F32_STEPS greedy steps; logits within 1e-3 of max|logit|
    and equal tokens at every step. Returns the launch counts (all 0)."""
    import dataclasses

    import torch

    from repro_torch.config import override
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_map

    base = get_config(WHISPER)
    cfg = override(base, dtype="float32", num_layers=WHISPER_F32_LAYERS,
                   encoder=dataclasses.replace(
                       base.encoder, num_layers=WHISPER_F32_LAYERS))
    dev = torch.device("cuda")
    ops.reset_launches()
    gpu = build_model(cfg, device=dev)
    cpu = build_model(cfg, device="cpu")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = gpu.init(gen)
    p_cpu = tree_map(lambda a: a.cpu(), params)
    b, s, steps = WHISPER_F32_BATCH, WHISPER_F32_PROMPT, WHISPER_F32_STEPS
    batch = whisper_batch(cfg, b, s, 1, dev)
    lg, cg = gpu.prefill(params, batch, max_len=s + steps)
    lc, cc = cpu.prefill(p_cpu, {k: v.cpu() for k, v in batch.items()},
                         max_len=s + steps)
    worst = 0.0
    for i in range(steps + 1):
        scale = lc.abs().max().item()
        err = (lg.cpu() - lc).abs().max().item()
        worst = max(worst, err / scale)
        tg, tc = lg.argmax(-1), lc.argmax(-1)
        if not (err <= 1e-3 * scale and tg.cpu().tolist() == tc.tolist()):
            raise AssertionError(f"whisper f32 step {i}: card against CPU "
                                 f"max|err| {err:.3e} of max|logit| "
                                 f"{scale:.3e}, tokens {tg.tolist()} / "
                                 f"{tc.tolist()}")
        if i == steps:
            break
        lg, cg = gpu.decode_step(params, tg[:, None], cg, s + i)
        lc, cc = cpu.decode_step(p_cpu, tc[:, None], cc, s + i)
    launches = no_launches("phase 9a whisper f32")
    print(f"[phase 9a whisper f32] {WHISPER_F32_LAYERS} encoder and "
          f"{WHISPER_F32_LAYERS} decoder layers at full width, card against "
          f"the port on the CPU: prefill {b}x{s} over "
          f"{cfg.encoder.num_frames} frames and {steps} greedy steps, "
          f"max|err| / max|logit| {worst:.3e} (tol 1e-3), tokens equal, "
          f"launches {launches}")
    torch.cuda.synchronize()
    return launches


def trace_line(what: str, fn, host_ms: float) -> float:
    """Print the device ms a call of `fn` by CUDA kernel (kernel_ms) against
    its `host_ms` on the host's clock, the idle share, and the kernels that
    take most of it. Returns the device ms a call."""
    per = kernel_ms(fn, [[]], calls=3)
    busy = sum(per.values())
    top = ", ".join(f"{name.strip()} {ms:.3f}" for name, ms in
                    sorted(per.items(), key=lambda kv: -kv[1])[:6])
    print(f"[trace] {what}: {busy:.2f} ms of device time a call against "
          f"{host_ms:.2f} ms on the host's clock (idle share "
          f"{max(0.0, 1 - busy / host_ms):.2f}); most: {top}")
    return busy


def whisper_serve(model, params, batch: dict, tag: str) -> dict:
    """The static path through the model's entry points (the CLI has no
    audio path, as the reference's): a warm-up prefill, WHISPER_REPEATS
    timed ones (median), then GEN - 1 timed greedy decode steps after a
    warm one, and a trace of one decode step by kernel. Returns the prefill
    logits, the tokens, prefill_ms and decode_tok_s."""
    import statistics

    import torch
    seq = batch["tokens"].shape[1]

    def prefill():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.prefill(params, batch, max_len=seq + GEN)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    prefill()
    times = []
    for _ in range(WHISPER_REPEATS):
        (logits, cache), dt = prefill()
        times.append(dt)
    prefill_ms = 1e3 * statistics.median(times)
    toks = [logits.argmax(-1)[:, None]]
    model.decode_step(params, toks[0], cache, seq)     # warm, idempotent
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(GEN - 1):
        lg, cache = model.decode_step(params, toks[-1], cache, seq + i)
        toks.append(lg.argmax(-1)[:, None])
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    tokens = torch.cat(toks, dim=1)
    vocab = model.cfg.vocab_size
    if tokens.shape != (BATCH, GEN) or tokens.min() < 0 or \
            tokens.max() >= vocab or not torch.isfinite(logits).all():
        raise AssertionError(f"bad {tag} output: tokens "
                             f"{tuple(tokens.shape)}")
    tok_s = BATCH * (GEN - 1) / decode_s
    print(f"[e2e {tag}] prefill {prefill_ms:.2f} ms ({BATCH}x{seq} tokens "
          f"over {batch['frames'].shape[1]} frames, median of "
          f"{WHISPER_REPEATS} warm), decode {tok_s:.1f} tok/s ({BATCH} "
          f"lanes, {GEN - 1} steps)")
    trace_line(f"{tag} decode", lambda: model.decode_step(
        params, toks[-1], cache, seq + GEN - 1), 1e3 * BATCH / tok_s)
    del cache
    return {"logits": logits.float().cpu(), "tokens": tokens.cpu(),
            "prefill_ms": prefill_ms, "decode_tok_s": tok_s}


def whisper_phase(records: dict) -> dict:
    """Phase 9: whisper-small (the enc-dec family) at its published widths
    and depth through the model's entry points, which is how the reference
    runs it too (its CLI's batches carry no frames). (a) the float32 check
    of whisper_f32_agreement; (b) bfloat16, 12 + 12 layers: the peak after
    init, the encoder alone and the prefill (encoder included), each the
    median of WHISPER_REPEATS warm runs, decode tok/s, and the encoder and
    a decode step by kernel (whisper_serve); (c) the S3A3E8 conversion of the decoder's FFNs
    on the CLI's 4 x 128 calibration tokens plus num_frames frames: profile
    and cluster seconds, the peak (held to the calibration forward's own
    peak plus one layer's FFN and the taps: the in-place write adds no
    copy), enc_blocks bitwise unchanged, the backend per phase, the
    converted static path, and the conversion's weights with every routed
    expert active against the unconverted prefill logits. Launch counts are
    zeroed before each run and read after: 0 on every kernel. Returns the
    counts by run."""
    import dataclasses
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.convert import convert_dense_model
    from repro_torch.core.experts import microbatch_backend
    from repro_torch.data import make_calibration_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import parse_sxayez
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_leaves, tree_map

    cfg = get_config(WHISPER)
    dev = torch.device("cuda")
    print(f"[cut] {WHISPER}: none, all {cfg.encoder.num_layers} encoder and "
          f"{cfg.num_layers} decoder layers (phase 9, bfloat16; "
          f"{WHISPER_F32_LAYERS} + {WHISPER_F32_LAYERS} in float32); d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff} {cfg.activation}, "
          f"{cfg.encoder.num_frames} frames, vocab {cfg.vocab_size}")
    free_device("phase 9 whisper")
    launches = {"f32": whisper_f32_agreement()}
    free_device("phase 9 whisper bf16")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    ops.reset_launches()
    model = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen)
    torch.cuda.synchronize()
    init_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(t.numel() for t in tree_leaves(params))
    batch = whisper_batch(cfg, BATCH, PROMPT, 0, dev)
    enc_ms = []
    for i in range(WHISPER_REPEATS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model._encode(params, batch["frames"])
        torch.cuda.synchronize()
        if i:
            enc_ms.append(1e3 * (time.perf_counter() - t0))
    print(f"[e2e whisper bf16] {n_params / 1e6:.2f} M parameters, peak "
          f"{init_gb:.3f} GB after init ({held_gb:.3f} GB of it held before "
          f"init: earlier phases' and the libraries' allocations); encoder "
          f"alone "
          f"{statistics.median(enc_ms):.2f} ms ({BATCH}x"
          f"{cfg.encoder.num_frames} frames, median of {WHISPER_REPEATS} "
          f"warm)")
    trace_line("whisper bf16 encoder", lambda: model._encode(
        params, batch["frames"]), statistics.median(enc_ms))
    ref = whisper_serve(model, params, batch, "whisper bf16")
    launches["dense_static"] = no_launches("phase 9b whisper bf16")
    serve_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[e2e whisper bf16] peak {serve_gb:.3f} GB after serving, "
          f"launches {launches['dense_static']}")

    # (c) the conversion, in place over the decoder's FFN storage
    cm = parse_sxayez(WHISPER_CMOE)
    calib = make_calibration_batch(cfg.vocab_size, 4, 128, seed=0)
    calib = {"tokens": torch.as_tensor(calib["tokens"], dtype=torch.long,
                                       device=dev),     # frames of seed 2
             "frames": whisper_batch(cfg, 4, 1, 2, dev)["frames"]}
    enc_before = tree_map(torch.clone, params["enc_blocks"])
    ffn_bytes = sum(w[0].numel() * w.element_size()
                    for w in params["blocks"]["ffn"].values())
    torch.cuda.synchronize()
    free_device("phase 9 whisper's conversion")
    torch.cuda.reset_peak_memory_stats()
    taps = model.ffn_inputs(params, calib)
    taps_bytes = taps.numel() * taps.element_size()
    del taps
    torch.cuda.synchronize()
    fwd_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    model, params, report = convert_dense_model(model, params, calib, cm)
    torch.cuda.synchronize()
    conv_gb = torch.cuda.max_memory_allocated() / 1e9
    allowed = fwd_gb + 2 * (ffn_bytes + taps_bytes) / 1e9
    if conv_gb > allowed:
        raise AssertionError(f"whisper conversion peak {conv_gb:.3f} GB over "
                             f"its calibration forward's {fwd_gb:.3f} GB plus "
                             f"two layers' FFN and the taps ({allowed:.3f})")
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(params["enc_blocks"]), tree_leaves(enc_before)))
    if not same or "cmoe" in params["enc_blocks"]:
        raise AssertionError("the conversion changed whisper's encoder")
    del enc_before
    backends = {
        "prefill": microbatch_backend(model.cfg, BATCH * PROMPT, "prefill",
                                      use_kernel=True),
        "decode": microbatch_backend(model.cfg, BATCH, "decode",
                                     use_kernel=True)}
    if backends != {"prefill": "grouped_plain", "decode": "gather"}:
        raise AssertionError(f"whisper cmoe backends per phase: {backends}")
    print(f"[e2e whisper cmoe] converted {report.num_layers} decoder layers "
          f"({cm.tag()}) on {report.calib_tokens} calibration tokens over "
          f"{cfg.encoder.num_frames} frames: profile "
          f"{report.seconds_profile:.2f} s, cluster "
          f"{report.seconds_cluster:.2f} s; peak {conv_gb:.3f} GB (init "
          f"{init_gb:.3f}, the calibration forward alone {fwd_gb:.3f}); "
          f"enc_blocks bitwise unchanged; backends {backends}")
    res = whisper_serve(model, params, batch, "whisper cmoe")
    launches["static"] = no_launches("phase 9c whisper cmoe")
    ops.reset_launches()
    agree = int((res["tokens"][:, 0] == ref["tokens"][:, 0]).sum())
    print(f"[e2e whisper cmoe] first greedy token as unconverted "
          f"{agree}/{BATCH}, launches {launches['static']}")

    # every routed expert active: the dense FFN's neurons, regrouped
    m_all = build_model(model.cfg.with_cmoe(dataclasses.replace(
        model.cfg.cmoe, top_k=model.cfg.cmoe.num_routed)), device=dev)
    logits = m_all.prefill(params, batch)[0].float().cpu()
    err = (logits - ref["logits"]).abs().max().item()
    scale = ref["logits"].abs().max().item()
    if not (torch.isfinite(logits).all() and
            err <= DS_HIER_ALL_ACTIVE_TOL * scale):
        raise AssertionError(f"whisper all-active conversion: max|err| "
                             f"{err:.3e} > {DS_HIER_ALL_ACTIVE_TOL} x "
                             f"max|logit| {scale:.3e}")
    print(f"[e2e whisper cmoe] all {model.cfg.cmoe.num_routed} routed experts "
          f"active vs the unconverted model, prefill logits {BATCH}x{PROMPT}:"
          f" max|err| / max|logit| {err / scale:.3e} (tol "
          f"{DS_HIER_ALL_ACTIVE_TOL}), greedy tokens agree "
          f"{int((logits.argmax(-1) == ref['logits'].argmax(-1)).sum())}/"
          f"{BATCH}")
    launches["all_active"] = no_launches("phase 9c whisper all-active")
    del m_all, model, params, res, ref
    free_device("the phases after 9")
    return launches


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_gb(dev) -> float:
    import torch
    return torch.cuda.max_memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else float("nan")


def _reset_peak(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _paths(tree, prefix=""):
    """(path, leaf) pairs of a nested dict, None leaves included."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def train_steps(step_fn, params, opt, loader, n: int, dev,
                gamma: float = 0.0):
    """n steps of step_fn on the loader's batches, the balance update after
    each where the model reports moe_load. Returns (params, opt, rows),
    rows [(loss, grad_norm, ms, bias moves or None)] with ms host-timed
    around the step (the loss's read syncs)."""
    import torch
    from repro_torch.optim import apply_balance_update
    rows = []
    for _ in range(n):
        t0 = time.perf_counter()
        batch = {"tokens": torch.as_tensor(next(loader)["tokens"],
                                           dtype=torch.long, device=dev)}
        params, opt, met = step_fn(params, opt, batch)
        moved = None
        if gamma > 0 and "moe_load" in met:
            old = params["blocks"]["cmoe"]["bias"]
            params = apply_balance_update(params, met["moe_load"],
                                          gamma=gamma)
            moved = (params["blocks"]["cmoe"]["bias"] - old, met["moe_load"])
        loss = float(met["loss"])
        rows.append((loss, float(met["grad_norm"]),
                     (time.perf_counter() - t0) * 1e3, moved))
    return params, opt, rows


def train_resume(cfg, dev) -> None:
    """Phase 10a: one Model.loss gradient (every leaf reached), then
    TRAIN_STRAIGHT steps straight and the same steps as a half, an async
    checkpoint round trip (new manager, new loader) and the other half, in
    deterministic mode: params and both moments bitwise equal. Then steps
    with the deterministic mode off, for its cost, and one traced."""
    import statistics
    import tempfile

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import ShardedLoader
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_leaves, tree_map
    from repro_torch.optim import adamw_init, global_norm

    _reset_peak(dev)
    model = build_model(cfg, use_kernel=False, device=dev)

    def init():
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        return model.init(g)

    def loader():
        return ShardedLoader(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)

    params = init()
    _sync(dev)
    peak_init = _peak_gb(dev)
    first = {"tokens": torch.as_tensor(loader()._batch_at(0),
                                       dtype=torch.long, device=dev)}
    (loss, _), grads = value_and_grad(lambda p: model.loss(p, first),
                                      params, fill=False)
    missing = [path for path, g in _paths(grads) if g is None]
    gnorm = float(global_norm(grads))
    n_leaves = len(tree_leaves(grads))
    del grads
    if missing or not math.isfinite(gnorm) or gnorm <= 0 or \
            not math.isfinite(float(loss)):
        raise AssertionError(f"phase 10a: loss {float(loss)}, grad norm "
                             f"{gnorm}, leaves without a gradient {missing}")
    print(f"[phase 10a gradient] loss {float(loss):.6f}, grad norm "
          f"{gnorm:.6f}, all {n_leaves} parameter leaves have a gradient")

    step = make_train_step(model, **TRAIN_SCHEDULE)
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        _reset_peak(dev)
        want_p, want_o, rows = train_steps(
            step, params, adamw_init(params), loader(), TRAIN_STRAIGHT, dev)
        _sync(dev)
        peak_train = _peak_gb(dev)
        half = TRAIN_STRAIGHT // 2
        ld = loader()
        p, o, _ = train_steps(step, init(), adamw_init(params), ld, half,
                              dev)
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            saver = CheckpointManager(d)
            saver.save(half, {"params": p, "opt": o},
                       {"loader": ld.state_dict(), "step": half})
            t_save_call = time.perf_counter() - t0
            target = tree_map(torch.empty_like, {"params": p, "opt": o})
            del p, o
            saver.wait()
            t_save = time.perf_counter() - t0
            t1 = time.perf_counter()
            state, extra = CheckpointManager(d).restore(target)
            _sync(dev)
            t_restore = time.perf_counter() - t1
            size = sum(os.path.getsize(os.path.join(r, f))
                       for r, _, fs in os.walk(d) for f in fs)
        ld2 = loader()
        ld2.load_state_dict(extra["loader"])
        got_p, got_o, rows_c = train_steps(step, state["params"],
                                           state["opt"], ld2,
                                           TRAIN_STRAIGHT - half, dev)
        del state, target
        bad = [i for i, (a, b) in enumerate(zip(
            tree_leaves((want_p, want_o)), tree_leaves((got_p, got_o))))
            if a.dtype != b.dtype or not torch.equal(a, b)]
        losses_equal = [r[0] for r in rows[half:]] == [r[0] for r in rows_c]
        print(f"[phase 10a resume] {TRAIN_STRAIGHT} straight steps against "
              f"{half} + checkpoint ({size / 1e9:.3f} GB; save call "
              f"{t_save_call:.2f} s, written {t_save:.2f} s, restore "
              f"{t_restore:.2f} s) + "
              f"{TRAIN_STRAIGHT - half}: {len(bad)} of "
              f"{len(tree_leaves((want_p, want_o)))} leaves differ "
              f"(params, m, v, step); resumed losses bitwise the straight "
              f"run's: {losses_equal}")
        if bad or not losses_equal or extra["step"] != half:
            raise AssertionError(f"phase 10a: the resumed run is not the "
                                 f"straight one (leaves {bad[:8]})")
        del want_p, want_o
        torch.use_deterministic_algorithms(False)
        got_p, got_o, rows_off = train_steps(step, got_p, got_o, ld2, 3, dev)
        if dev.type == "cuda":
            train_trace(step, got_p, got_o, ld2, dev)
    finally:
        torch.use_deterministic_algorithms(det)
    losses = [r[0] for r in rows]
    if not all(math.isfinite(x) for x in losses) or \
            not all(math.isfinite(r[1]) and r[1] > 0 for r in rows):
        raise AssertionError(f"phase 10a: losses {losses}")
    warm = statistics.median(r[2] for r in rows[1:])
    off = statistics.median(r[2] for r in rows_off[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[phase 10a train] {cfg.name} {cfg.dtype}, {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, remat: loss {losses[0]:.6f} -> {losses[-1]:.6f} "
          f"over {TRAIN_STRAIGHT} steps, grad norm "
          f"{', '.join(f'{r[1]:.4f}' for r in rows)}; step ms "
          f"{', '.join(f'{r[2]:.1f}' for r in rows)} (deterministic; "
          f"median warm {warm:.2f}, {tokens / (warm / 1e3):.1f} tokens/s); "
          f"deterministic off {', '.join(f'{r[2]:.1f}' for r in rows_off)}"
          f" (median warm {off:.2f}, cost of the mode "
          f"{(warm - off) / off:+.1%})")
    print(f"[memory] phase 10a peak {peak_init:.3f} GB after init, "
          f"{peak_train:.3f} GB during training")


def train_trace(step_fn, params, opt, loader, dev) -> None:
    """One warm train step under torch.profiler (CUDA activity): its device
    ms by kernel against its host-timed ms, the idle share, the number of
    kernel launches, and the kernels that take most of the time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    batch = {"tokens": torch.as_tensor(next(loader)["tokens"],
                                       dtype=torch.long, device=dev)}
    _sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(params, opt, batch)
        _sync(dev)
        host_ms = (time.perf_counter() - t0) * 1e3
    per, launches = {}, 0
    for e in prof.key_averages():
        t_us = getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
        if t_us > 0:
            per[e.key[:60]] = per.get(e.key[:60], 0.0) + t_us / 1e3
            launches += e.count
    busy = sum(per.values())
    top = ", ".join(f"{name.strip()} {ms:.1f}" for name, ms in
                    sorted(per.items(), key=lambda kv: -kv[1])[:8])
    print(f"[trace] train step: {busy:.1f} ms of device time in {launches} "
          f"kernel launches against {host_ms:.1f} ms on the host's clock "
          f"(profiled; idle share {max(0.0, 1 - busy / host_ms):.2f}); "
          f"most: {top}")


class _Tee:
    """stdout that is also kept, so a CLI's printed lines can be read."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()

    def text(self) -> str:
        return "".join(self.parts)


def run_cli(main, argv: list) -> str:
    """main(argv), which must return 0; returns what it printed."""
    import contextlib
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = main(argv)
    if rc != 0:
        raise AssertionError(f"{main.__module__} {argv}: exit {rc}")
    return tee.text()


def cli_phase(cfg, dev, extra_args: list):
    """Phase 10b: train.main for 2 steps, then --steps 4 --resume auto
    (step 2 and the loader restored, steps 2-3 with finite losses, step 4
    saved); convert.main --cmoe CMOE, restored leaf for leaf bitwise the
    in-memory conversion of the same seed, which is returned (model,
    params) for 10c."""
    import tempfile

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.convert import convert_dense_model
    from repro_torch.data import make_calibration_batch
    from repro_torch.launch import convert as convert_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_leaves, tree_map

    with tempfile.TemporaryDirectory() as d:
        base = extra_args + TRAIN_CLI_ARGS + ["--ckpt-dir", d]
        t0 = time.perf_counter()
        run_cli(train_cli.main, base + ["--steps", "2"])
        t1 = time.perf_counter()
        text = run_cli(train_cli.main, base + ["--steps", "4"])
        t2 = time.perf_counter()
        steps = [ln.split() for ln in text.splitlines()
                 if ln.startswith("step ")]
        mgr = CheckpointManager(d)
        with open(os.path.join(d, "ckpt_00000004", "manifest.json")) as f:
            extra = json.load(f)["extra_state"]
        ok = "[resume] restored step 2" in text and \
            [int(x[1]) for x in steps] == [2, 3] and \
            all(math.isfinite(float(x[3])) for x in steps) and \
            mgr.all_steps() == [2, 4] and \
            extra == {"loader": {"step": 4}, "step": 4}
        print(f"[phase 10b train CLI] 2 steps {t1 - t0:.2f} s, resumed to 4 "
              f"{t2 - t1:.2f} s (both with model init and the final save); "
              f"steps {[int(x[1]) for x in steps]} losses "
              f"{[float(x[3]) for x in steps]}, checkpoints "
              f"{mgr.all_steps()}, step 4's extra state {extra}")
        if not ok:
            raise AssertionError("phase 10b: the train CLI's resume")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        run_cli(convert_cli.main, extra_args + ["--cmoe", CMOE, "--out", d])
        t1 = time.perf_counter()
        model = build_model(cfg, use_kernel=False, device=dev)
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        params = model.init(g)
        args = convert_cli.parser().parse_args(extra_args + ["--cmoe", CMOE])
        cm = convert_cli.conversion_config(cfg, args)
        calib = make_calibration_batch(cfg.vocab_size, args.calib_samples,
                                       args.calib_seq, seed=1234)
        with torch.no_grad():
            m2, p2, rep = convert_dense_model(
                model, params, {"tokens": torch.as_tensor(
                    calib["tokens"], dtype=torch.long, device=dev)}, cm)
        del model, params
        state, extra = CheckpointManager(d).restore(
            {"params": tree_map(torch.empty_like, p2)})
        bad = [path for (path, a), b in zip(
            _paths(p2), tree_leaves(state["params"]))
            if a.dtype != b.dtype or not torch.equal(a, b)]
        print(f"[phase 10b convert CLI] {cm.tag()} in {t1 - t0:.2f} s "
              f"(the in-memory conversion {rep.seconds_total:.2f} s: "
              f"profile {rep.seconds_profile:.2f}, cluster "
              f"{rep.seconds_cluster:.2f}); extra state {extra}; "
              f"{len(bad)} of {len(tree_leaves(p2))} restored leaves differ "
              f"from the in-memory conversion")
        if bad or extra != {"arch": args.arch, "cmoe": cm.tag(),
                            "smoke": args.smoke}:
            raise AssertionError(f"phase 10b: convert CLI leaves {bad[:8]}")
    return m2, p2


def converted_finetune(m2, p2, dev) -> None:
    """Phase 10c: the converted model's gradient (u non-zero in every
    layer; the balance bias the only leaf without one), moe_load's shape,
    TRAIN_CONVERTED_STEPS steps with the balance update (each bias moves
    by 0 or +-BALANCE_GAMMA), and LoRA: B = 0 merges to the base loss bit
    for bit, and one AdamW step on the adapters lowers the loss."""
    import statistics

    import torch

    from repro_torch.data import ShardedLoader
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.optim import (adamw_init, adamw_update, init_lora,
                                   merge_lora)

    cfg = m2.cfg
    n_r = cfg.cmoe.num_routed
    ld = ShardedLoader(cfg.vocab_size, *TRAIN_CONVERTED_BATCH, seed=1)
    batch = {"tokens": torch.as_tensor(ld._batch_at(0), dtype=torch.long,
                                       device=dev)}
    t0 = time.perf_counter()
    (loss, met), grads = value_and_grad(lambda p: m2.loss(p, batch), p2,
                                        fill=False)
    _sync(dev)
    t_grad = time.perf_counter() - t0
    u = grads["blocks"]["cmoe"]["u"]
    layers_u = int((u != 0).any(-1).sum())
    missing = [path for path, g in _paths(grads) if g is None]
    load_shape = tuple(met["moe_load"].shape)
    del grads
    print(f"[phase 10c gradient] {cfg.name} {cfg.cmoe.tag()}, "
          f"{TRAIN_CONVERTED_BATCH[0]} x {TRAIN_CONVERTED_BATCH[1]}: loss "
          f"{float(loss):.6f} ({t_grad:.2f} s with the backward); cmoe.u's "
          f"gradient non-zero in {layers_u} of {cfg.num_layers} layers "
          f"(max |g| {float(u.abs().max()):.3e}); leaves without a "
          f"gradient {missing}; moe_load {load_shape}")
    if layers_u != cfg.num_layers or missing != ["/blocks/cmoe/bias"] or \
            load_shape != (cfg.num_layers, n_r):
        raise AssertionError("phase 10c: the converted model's gradient")
    step = make_train_step(m2, lr=3e-4, warmup=1,
                           total=TRAIN_CONVERTED_STEPS)
    p3, _, rows = train_steps(step, p2, adamw_init(p2), ld,
                              TRAIN_CONVERTED_STEPS, dev,
                              gamma=BALANCE_GAMMA)
    del p3
    moves = []
    for _, _, _, (delta, load) in rows:
        off = (delta.abs() - BALANCE_GAMMA).abs()
        ok = bool(((delta == 0) | (off <= 1e-9)).all()) and \
            bool((delta != 0).any())
        moves.append((int((delta > 0).sum()), int((delta < 0).sum()), ok))
    print(f"[phase 10c train] {TRAIN_CONVERTED_STEPS} steps: losses "
          f"{[round(r[0], 6) for r in rows]}, ms "
          f"{[round(r[2], 1) for r in rows]} (median "
          f"{statistics.median(r[2] for r in rows):.1f}); balance update "
          f"(bias entries up, down, all moves 0 or +-{BALANCE_GAMMA}): "
          f"{moves}")
    if not all(m[2] for m in moves) or \
            not all(math.isfinite(r[0]) for r in rows):
        raise AssertionError("phase 10c: the balance update")

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    lora = init_lora(p2, g, rank=LORA_RANK)
    with torch.no_grad():
        base = m2.loss(p2, batch)[0]
        merged = m2.loss(merge_lora(p2, lora, alpha=LORA_ALPHA,
                                    rank=LORA_RANK), batch)[0]
    (l0, _), lg = value_and_grad(
        lambda lo: m2.loss(merge_lora(p2, lo, alpha=LORA_ALPHA,
                                      rank=LORA_RANK), batch), lora)
    lora2, _, om = adamw_update(lg, adamw_init(lora), lora,
                                lr=torch.tensor(LORA_LR, device=dev))
    del lg
    with torch.no_grad():
        l1 = m2.loss(merge_lora(p2, lora2, alpha=LORA_ALPHA,
                                rank=LORA_RANK), batch)[0]
    print(f"[phase 10c lora] rank {LORA_RANK}, alpha {LORA_ALPHA}: loss "
          f"with B = 0 {float(merged):.6f}, base {float(base):.6f} "
          f"(bitwise {bool(torch.equal(merged, base))}); one AdamW step "
          f"(lr {LORA_LR}) on the adapters alone: {float(l0):.6f} -> "
          f"{float(l1):.6f} (adapter grad norm {float(om['grad_norm']):.4e})")
    if not torch.equal(merged, base) or not float(l1) < float(l0):
        raise AssertionError("phase 10c: LoRA")


def train_f32_agreement(cfg, dev) -> None:
    """Phase 10d: float32, TRAIN_F32_LAYERS layers, TF32 off: the loss and
    every gradient leaf on the card against the port on the CPU, one set
    of weights."""
    import numpy as np
    import torch

    from repro_torch.config import override
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_map

    cfg = override(cfg, dtype="float32", num_layers=TRAIN_F32_LAYERS)
    cpu = build_model(cfg, use_kernel=False, device="cpu")
    card = build_model(cfg, use_kernel=False, device=dev)
    params = cpu.init(torch.Generator().manual_seed(0))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_F32_TOKENS[0], TRAIN_F32_TOKENS[1] + 1)))
    t0 = time.perf_counter()
    (lc, _), gc_ = value_and_grad(lambda p: cpu.loss(p, {"tokens": tokens}),
                                  params, fill=False)
    t1 = time.perf_counter()
    (lg, _), gg = value_and_grad(
        lambda p: card.loss(p, {"tokens": tokens.to(dev)}),
        tree_map(lambda a: a.to(dev), params), fill=False)
    _sync(dev)
    rel = abs(float(lg) - float(lc)) / abs(float(lc))
    worst, where = 0.0, None
    for (path, a), (_, b) in zip(_paths(gc_), _paths(gg)):
        r = float((b.cpu() - a).abs().max() / a.abs().max())
        if r > worst:
            worst, where = r, path
    print(f"[phase 10d f32] {cfg.name} at {TRAIN_F32_LAYERS} layers, "
          f"{TRAIN_F32_TOKENS[0]} x {TRAIN_F32_TOKENS[1]} tokens, TF32 off: "
          f"loss card {float(lg):.8f} CPU {float(lc):.8f} (|d| / loss "
          f"{rel:.3e}, tol {TRAIN_LOSS_TOL}); worst leaf max|dg| / max|g| "
          f"{worst:.3e} at {where} (tol {TRAIN_GRAD_TOL}); CPU side "
          f"{t1 - t0:.2f} s")
    if rel > TRAIN_LOSS_TOL or worst > TRAIN_GRAD_TOL:
        raise AssertionError("phase 10d: card and CPU disagree")


def training_phase(cfg, dev, cli_args: list, took=None) -> dict:
    """Phase 10 (see the module docstring): 10a-10d in order, launch
    counts zeroed before and read after; every count must be 0. Returns
    the counts."""
    import torch

    from repro_torch.kernels import ops

    def mark(tag):
        if took is not None:
            took(tag)

    def free(what):
        if dev.type == "cuda":
            free_device(what)

    free("phase 10 training")
    _sync(dev)
    ops.reset_launches()
    print(f"[cut] {cfg.name}: none in 10a-10c, all {cfg.num_layers} layers "
          f"(d_model {cfg.d_model}, {cfg.num_heads} heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}); 10d at {TRAIN_F32_LAYERS} "
          f"layers in float32")
    train_resume(cfg, dev)
    mark("10a")
    free("phase 10b")
    m2, p2 = cli_phase(cfg, dev, cli_args)
    mark("10b")
    converted_finetune(m2, p2, dev)
    del m2, p2
    mark("10c")
    free("phase 10d")
    train_f32_agreement(cfg, dev)
    mark("10d")
    _sync(dev)
    launches = dict(ops.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"phase 10: a kernel ran on the training "
                             f"path, which has none: {launches}")
    print(f"[phase 10 launches] {launches}")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (build, check and time); the "
                         "kernels line then has launches null")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the GPU only",
              file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve

    start = last = time.perf_counter()

    def took(phase: str) -> None:
        nonlocal last
        now = time.perf_counter()
        print(f"[seconds] phase {phase}: {now - last:.1f} s ({now - start:.1f}"
              f" s since the start)")
        last = now

    # phase 1: device and build
    smi = nvidia_smi()
    print(f"[device] {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    seconds = build.build_all()
    print(f"[build] {len(seconds)} sources built in "
          f"{time.perf_counter() - t0:.2f} s (parallel nvcc)")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")
    tensor_core_report()
    took("1")

    # phase 2: kernels against their plain versions, then timed
    records = kernel_phase()
    took("2")
    if args.kernels_only:
        print(smi)
        print(json.dumps({"kernels": list(records.values())}))
        return 0

    # phase 3a: f32 kernel path vs plain path at full width
    model, cparams, calib = f32_agreement()
    # path B: the CMoE router's fused scoring on that converted model
    launches = router_path(model, cparams, calib)
    records["router_score"]["launches"] = launches["router_score"]
    del model, cparams, calib

    # phase 3b: the main path, bf16, through the serving CLI's entry point
    torch.cuda.synchronize()
    ops.reset_launches()
    res = serve.run(["--arch", ARCH, "--cmoe", CMOE, "--batch", str(BATCH),
                     "--prompt-len", str(PROMPT), "--gen", str(GEN),
                     "--seed", "0"])
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    toks = torch.as_tensor(res["tokens"])
    from repro_torch.configs import get_config
    vocab = get_config(ARCH).vocab_size
    if toks.shape != (BATCH, GEN) or toks.min() < 0 or toks.max() >= vocab \
            or not torch.isfinite(res["prefill_logits"]).all():
        raise AssertionError(f"bad serve output: tokens {tuple(toks.shape)}")
    if res["backends"] != {"prefill": "grouped_kernel", "decode": "gather"}:
        raise AssertionError(f"backends per phase: {res['backends']}")
    print(f"[e2e bf16] convert {res['convert_s']:.2f} s, prefill "
          f"{res['prefill_ms']:.2f} ms ({BATCH}x{PROMPT}, median of "
          f"{serve.PREFILL_REPEATS} warm), decode "
          f"{res['decode_tok_s']:.1f} tok/s ({BATCH} lanes, {GEN - 1} "
          f"steps), launches {launches}")
    kernel_routes("phase 3b static qwen bf16", "tensor_core")
    for name in ("swiglu_ffn", "moe_gmm_ragged", "moe_gather"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"static path")
        records[name]["launches_static"] = launches[name]
    del res                       # it holds the converted model and params
    took("3")

    # phase 4: the continuous-batching engine, paged, overlapped
    width_invariance()
    launches = engine_phase()
    for name in ("swiglu_ffn", "moe_gmm_ragged", "moe_gather",
                 "paged_attn_decode"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"engine's path")
        records[name]["launches"] = launches[name]
    took("4")

    # phase 5: deepseek-v2 at full width, cut in depth, with path A (the
    # bounded-buffer expert path) on the f32 and the bf16 model
    path_a = deepseek_f32_agreement()
    records["moe_gmm"]["launches_f32"] = path_a["moe_gmm"]
    launches, path_a = deepseek_serving()
    records["moe_gmm"]["launches"] = path_a["moe_gmm"]
    records["mla_paged_decode"]["launches"] = launches["mla_paged_decode"]
    for name in ("moe_gmm_ragged", "moe_gather"):
        records[name]["launches_deepseek_engine"] = launches[name]
    del path_a, launches
    static, engine = deepseek_hierarchical(records)
    for name in ("moe_gmm_ragged", "moe_gather"):
        records[name]["launches_hierarchical_static"] = static[name]
    for name in ("moe_gmm_ragged", "moe_gather", "mla_paged_decode"):
        records[name]["launches_hierarchical"] = engine[name]
    # phase 5e: llama4 at full width, one period, unconverted and converted
    for run, counts in llama4_phase(records).items():
        for name in ("swiglu_ffn", "moe_gmm_ragged", "moe_gather",
                     "paged_attn_decode"):
            records[name][f"launches_llama4_{run}"] = counts[name]
    took("5")

    # phase 6: mamba2-370m and zamba2-1.2b at full width and depth
    for arch in SSM_ARCHS:
        ssm_f32_agreement(arch)
    launches = ssm_serving("mamba2-370m")
    records["ssd_scan"]["launches"] = launches["ssd_scan"]
    launches = ssm_serving("zamba2-1.2b")
    records["ssd_scan"]["launches_zamba2"] = launches["ssd_scan"]
    records["swiglu_ffn"]["launches_zamba2"] = launches["swiglu_ffn"]
    took("6")

    # phase 7: the attention pair at llama2-7b's full width
    launches = attention_pair()
    for name in ("flash_attention", "flash_decode"):
        records[name]["launches"] = launches[name]
    took("7")

    # phase 8: the last decoder-only archs at full width, unconverted and
    # converted, static and by the engine
    for arch, key, layers in DENSE_ARCHS:
        for run, counts in dense_arch_phase(arch, key, layers,
                                            records).items():
            for name in ("swiglu_ffn", "moe_gmm_ragged", "moe_gather",
                         "paged_attn_decode"):
                records[name][f"launches_{key}_{run}"] = counts[name]
        took(f"8 {key}")

    # phase 9: whisper-small's encoder-decoder at full width and depth,
    # unconverted and converted, through the model's entry points
    for run, counts in whisper_phase(records).items():
        for name, n in counts.items():
            records[name][f"launches_whisper_{run}"] = n
    took("9")

    # phase 10: training qwen1.5-0.5b at full width and depth, the train
    # and convert CLIs, the converted fine-tune, f32 card against CPU
    from repro_torch.configs import get_config
    counts = training_phase(get_config(ARCH), torch.device("cuda"), [],
                            took=took)
    for name, n in counts.items():
        records[name]["launches_train"] = n

    print(smi)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
