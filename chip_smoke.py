#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printed as it runs:

1. environment: torch/CUDA versions, the card, the kernels' build time
   (every ``csrc/*.cu`` is compiled by nvcc at first use), and the
   attention kernels' registers and spills from ptxas (the bf16 forward
   must not spill, nor the bf16 backward at head_dim 256);
2. each CUDA kernel against its plain PyTorch version on the card, on
   seeded edge-shape inputs (ragged sizes, duplicate join keys, invalid
   rows; the join's hash table at its worst: every build key equal, no
   probe key present, keys at INT32_MIN/INT32_MAX, k0 equal with k1
   different and swapped, NB = 2^20 + 3, NB = 1 and NB = 0, bit-equal;
   segment ids outside [0, S), masked NaNs, C = 0, S >= 4096,
   cap == N, tie-heavy keys, N over several sorted chunks (the top-k
   merge), all rows invalid; attention causal and not, windows 4096,
   100, 16 and 8, softcap 50 and 30, GQA g in {1, 2, 4, 5, 6, 8}, ragged
   Sq/Sk and Sq < Sk,
   head_dim 64/80/128/256 at several tiles, bf16 and float32, the same bits
   from launch to launch; decode in bf16 and float32 with kv_len in
   {0, 1, ragged, Smax}, an Smax that is no multiple of a tile, one
   split, more heads than resident CTAs, and two calls in a row (the
   fused combine's counters); both aggregate kernels also on
   station-major sorted runs (97 equal ids in a row, across tiles), one
   hot segment, 0.4 % valid rows in clusters, S = 1, N no multiple of
   the flag vector or of a warp, and no row valid; sums the same bits
   on a second launch; the flash forward's row log-sum-exp L against
   the plain L and its output the same bits with L stored and not, then
   the flash backward, handed that L, on every flash edge shape (rows
   with no live key included) in bf16 and float32, the same bits on a
   second launch);
3. the query path: the NOAA-GHCN-shaped weather collections of the
   paper's §5 at 2000 stations x 50 years x 8 days (4,000,000 /sensors
   readings, P = 4 partitions), Q1–Q12 through ``compile_query`` ->
   ``Executor(db).run`` with statistics-presized caps, once on the
   kernel route and once on the plain route (kernel knobs pinned
   False); the two raw-output dicts must agree, and every result must
   agree with a numpy computation straight from the generated records;
4. each executor kernel again, on the largest input the query path
   gave it, timed beside its plain version, a PyTorch library call
   where one computes the same function, and its bound
   (``segmented_aggregate`` also on the input with the most valid rows,
   its bound counting the flags and the valid rows only;
   ``segmented_sum_count``, which no path launches, on the value
   column of the largest group-by input);
5. the LM serving path: qwen3-1.7b at its full published size (28
   layers, d_model 2048, 16/8 heads, vocab 151936; seeded random
   weights on the card) through ``launch.serve.serve_batch`` with 8
   requests of up to 2048 prompt tokens and 32 generated tokens, twice
   on the kernel route (cold, warm: 28 flash-kernel launches and
   28 x 32 decode-kernel launches each), then once on the plain route
   (dense attention in prefill and decode) teacher-forced with the
   kernel route's tokens; prefill logits and every decode step's logits
   must agree within LOGIT_ATOL. Then the two attention kernels, as in
   phase 4, on the inputs the serve gave them.

6. the service path, on phase 3's database once phase 3's executor is
   freed: Q1–Q12 through ``QueryService(db).execute`` cold and warm,
   against the numpy reference and against a service whose base config
   pins the plain routes; the 64 constant-variants of
   ``workload.make_workload`` through ``execute`` (one compile per
   template, each variant equal to an executor run of its baked plan)
   and through ``execute_batch`` (one batch per template, equal to the
   per-request results); Q8, Q10 and Q11 regrown from caps of 1;
   64 requests of multi-tenant traffic through ``submit``/``drain``,
   each equal to a direct ``execute``; ``explain(Q8, profile=True)``
   with the same operator rows on both routes; a restart: Q1–Q12
   through a service on a persistent plan cache, then through a second
   service on the same directory with no compile, 12 disk loads and the
   same raw dicts. The three query kernels must launch on this path and
   the attention kernels not.
7. spmd: the same ``SPEC`` built with P = 1, Q1–Q12 through
   ``Executor.run(mode="spmd")`` over an in-process NCCL process group
   of one rank (``launch.mesh.make_data_mesh``), presized caps, kernel
   route cold and warm, plain route, both join strategies for Q5–Q8,
   then through ``QueryService(mode="spmd")`` cold and warm; every
   result against the numpy reference, the routes against each other,
   then each raw dict against sim mode's on the same database. The
   three query kernels must launch on this path. No fallback: a group
   that does not start fails the phase.
8. the MRQL-like baseline (``core/baselines/mrql_like.py``) on phase
   3's database: Q1–Q12, rows against the numpy reference, its ms and
   MapReduce jobs beside the service's warm ms (phase 6).
9. the LM training path, after phase 5's params are freed: qwen3-1.7b
   at full width (1,720,574,976 params, seeded), first
   ``steps.value_and_grad`` of batch 0 on the kernel route and on the
   plain route (dense attention), loss, grad norm and every leaf's
   gradient within the TRAIN_* constants and none zero; then
   ``launch.train.train`` for 4 steps of 8 x 2048 tokens (the config's
   2 microbatches, remat and 8 CE chunks, nothing cut), each step with
   112 flash forward and 56 flash backward launches (2 x 28 layers x 2
   microbatches under remat, 28 x 2), its ms, tokens/s, MFU and peak
   MiB; the backward kernel timed at the training shape on one layer's
   q, k, v, O and L from that run (phase 4's kind of record, beside the
   autograd backward of ``scaled_dot_product_attention``; it names the
   kernel templates that ran, the tensor-core pair in bf16, with their
   registers and spills), the forward there with L stored and not; and a
   checkpoint resume at the
   smoke config (head_dim 64): 8 steps against a run that fails at
   step 6 and resumes from step 4, the params within RESUME_ATOL.
10. the MoE path: granite-moe-1b-a400m at its full published size (24
   layers, d_model 1024, 16/8 heads of 64, 32 experts top-8, vocab
   49155; seeded): ``serve_batch`` as in phase 5 (24 flash and 24 x 32
   decode launches a serve), the plain route's bf16 difference and
   share of differing routing decisions printed, the gate in float32
   (MOE_F32_LOGIT_ATOL); one MoE layer on 4096 rows in float64 on the
   card against the CPU (routing, ranks and kept rows equal, ties to
   the lower expert, output within MOE_F64_RTOL); the float32 training
   routes (MOE_TRAIN_TOL) and 4 steps of ``launch.train.train`` (96
   flash forward, 48 backward launches a step); then the attention
   kernels at head_dim 64 on the inputs this path gave them.
11. the Mamba-2 path: mamba2-370m at full size (48 layers, 32 SSD heads
   of 64, state 128, chunk 256): ``serve_batch`` with no attention
   launch; a forward over 2304 tokens against a prefill of 2048 and 32
   decode steps in float32 (SSM_CHAIN_ATOL; bf16 printed); 4 training
   steps, then 4 steps on one fixed batch whose loss must fall.
12. the vlm and audio front ends at full width, one model on the card at
   a time: qwen2-vl-2b (28 layers, d_model 1536, 12/2 heads of 128,
   M-RoPE, 8 x 2048 positions of 512 patch embeddings and 1536 tokens
   from ``data.pipeline.batch_at``) prefilled through
   ``steps.make_prefill_step`` and 32 tokens through
   ``steps.greedy_decode`` into 2080 slots, cold and warm (28 flash and
   28 x 32 decode launches a serve); kernel route against plain route
   teacher-forced, the gate in float32 (VLM_F32_LOGIT_ATOL), bf16
   printed; the float32 training routes (FRONTEND_TRAIN_TOL) and 4
   steps of ``launch.train.train`` (2 microbatches: 112 flash forward,
   56 backward a step). Then hubert-xlarge (48 layers, 16 heads of 80,
   not causal, 8 x 2048 frames of 512): ``model.forward`` and
   ``logits_from_hidden`` cold and warm (48 flash launches), the routes
   in float32 (AUDIO_F32_LOGIT_ATOL) and bf16, the training routes and 4
   steps (4 microbatches: 384 flash forward, 192 backward a step). Then
   the attention kernels on the inputs these paths gave them: GQA g = 6
   at head_dim 128, and head_dim 80 not causal.
13. the port's tooling and remat "dots": ``core.analysis.verify`` on
   the card (an ``ok`` line for each of Q1–Q12), the linter over the
   port and this script (no finding), the one-card dry run
   (``launch/dryrun.py``) over every supported (arch x shape) cell and
   over phase 9's cell under remat "full" and "dots" (its argument
   bytes against what the card allocates for that run's params, AdamW
   state and batch, DRYRUN_ARG_RTOL; its estimated peaks printed beside
   the measured ones); then qwen3-1.7b under ``remat_policy="dots"``:
   its float32 gradients against "full"'s (DOTS_TRAIN_TOL) and 4 steps
   of ``launch.train.train`` as phase 9's (112 flash forward and 56
   backward launches a step), printed beside phase 9's.
14. the LM mesh over an in-process NCCL group of one rank and its (1, 1)
   ``("data", "model")`` mesh (``launch.mesh.make_host_mesh``):
   qwen3-1.7b trained at full width through ``launch.train.train(...,
   mesh=)`` (4 steps of 8 x 2048, 2 microbatches, remat "full": each
   layer gathered from its blocks inside the checkpointed function,
   ``launch/fsdp.py``; 112 flash forward and 56 backward launches a
   step), printed beside phase 9's; its float32 gradients at 4 x 2048
   against the one-process ``value_and_grad`` (loss, global norm and all
   310 leaves bit for bit, else within FSDP_ROUTE_RTOL); a sharded save
   and restore at the smoke config, bit for bit; granite-moe-1b-a400m
   trained the same way (14e: 4 steps of 8 x 2048, the MoE layers
   through ``fsdp.MoeExchange`` with all 32 experts on the one ``model``
   rank; 96 flash forward and 48 backward launches a step), printed
   beside phase 10's, and its float32 gradients at 4 x 2048 against the
   one-process ones (loss, global norm, ``moe_aux`` and every leaf, as
   qwen3's); then the dry run of the 33 cells on the pod meshes 16 x 16
   and 2 x 16 x 16 (per-device argument bytes from the specs, host
   only).
15. the dense archs no other phase serves, at their published width
   and depth, one on the card at a time, their seeded weights drawn in
   bf16 layer by layer (``model.init_compute_params``): llama3-8b (32
   layers, d_model 4096, 32/8 heads of 128: GQA g = 4, vocab 128256,
   untied head) and gemma3-12b (48 layers, d_model 3840, 16/8 heads of
   256, window 1024 in a 5:1 local/global pattern, qk-norm, vocab
   262144) with phase 5's traffic, gemma2-9b (42 layers, d_model 3584,
   16/8 heads of 256, window 4096 on alternate layers, attention softcap
   50, final softcap 30) with 4 prompts of 3072-6144 tokens, so that its
   window cuts keys in prefill and decode; each through ``serve_batch``
   cold and warm on the kernel route (32, 42, 48 flash launches and 32
   x 32, 42 x 32, 48 x 32 decode launches a serve), the plain route
   teacher-forced in bf16 (printed), then the gate in float32 at full
   width and 8, 8 and 12 layers (DENSE_F32_LOGIT_ATOL); then the
   attention kernels on the inputs of each model's last local and last
   global layer, each row with the launches of its window that the
   wrappers counted in the warm serve; the library column
   ``flex_attention`` (compiled; the window as its block mask, the
   softcap as its score_mod) where a window or a softcap is on, else
   ``scaled_dot_product_attention``, each held to the plain version.
16. the MoE archs no other phase serves, at their published width with
   the depth cut to fit one card, one at a time, weights drawn as phase
   15's: llama4-scout-17b-a16e (12 of 48 layers; d_model 5120, 40/8
   heads of 128: GQA g = 5, 16 experts of 8192 top-1 and a shared one,
   vocab 202048) and jamba-v0.1-52b (16 of 32 layers, two periods of
   seven Mamba-2 layers (128 heads of 64, state 16) and one attention
   layer without RoPE (32/8 heads of 128), 16 experts of 14336 top-2 at
   the odd positions; vocab 65536), with phase 5's traffic; each through
   ``serve_batch`` cold and warm on the kernel route (12 and 2 flash
   launches, 12 x 32 and 2 x 32 decode launches a serve; the expert ids
   of both serves equal), the plain route teacher-forced in bf16
   (printed, with the share of routing decisions that differ), the gate
   in float32 at 4 and 8 layers with the plain route routed as the
   kernel route (MOE_WIDE_F32_LOGIT_ATOL), one MoE layer of that model
   in float64 on the card against the CPU, and the attention kernels on
   the inputs of each serve, beside ``scaled_dot_product_attention``.
   Phases 5, 15 and 16 run through one driver, ``serve_phase``.
17. the tensor-parallel split of one layer over 4 ``model`` ranks
   (``launch/fsdp.py``), each rank's share computed in turn on the one
   card with its partials summed in float32 where NCCL's all-reduce
   would sum them (``fsdp.split_in_turn``; the collectives themselves
   need four cards): llama3-8b's first layer (d_model 4096, 32/8 heads
   of 128, d_ff 14336: 8/2 heads and 3584 columns a rank),
   gemma3-12b's first, local one (d_model 3840, 16/8 heads of 256,
   window 1024, qk-norm, post-norms, d_ff 15360: 4/2 heads and 3840
   columns a rank), jamba-v0.1-52b's first (a Mamba-2 mixer, d_inner
   8192, 128 heads of 64, state 16: 32 heads a rank, and a dense MLP of
   14336) and mamba2-370m's (a mixer alone, d_inner 2048, 32 heads of
   64, state 128: 8 a rank), seeded weights and 8 x 2048 tokens, in
   float32 and bf16: the output, the input gradient and every weight
   gradient against the unsplit layer (TP_TOL); the flash forward and
   backward launched once a rank on its heads, counted (none on a mixer
   layer); one rank's share, forward and backward, timed beside the
   whole layer, under the card's name and power limit; then the flash
   kernels at that per-rank shape beside their plain versions. Then the
   flash backward at gemma2-9b's training shape (one 4 x 2048
   microbatch of 16/8 heads of 256, causal, softcap 50) on seeded
   inputs, beside its plain version and compiled ``flex_attention``'s
   autograd; logged only (no path trains gemma2-9b on the card, so it
   has no launches of its own and stays out of the kernels line).
18. the serve over a (1, 4) ``("data", "model")`` mesh
   (``launch/fsdp.ServeLayout``), every ``model`` rank's share computed
   in turn on the one card (``fsdp.decode_in_turn``): one decode step of
   the first layer of llama3-8b (phase 5's traffic, 2080 slots in four
   slices of 520), gemma2-9b (its local layer, window 4096 and softcap 50
   over 4 prompts of 3072-6144 tokens: four slices of 1544 slots, the
   window spanning three) and llama4-scout-17b-a16e (its MoE layer: 4 of
   the 16 experts a rank, the shared expert whole, the routes replayed)
   at published width, seeded weights and caches, in float32 and bf16:
   the heads' q, k, v gathered, the new token written by the rank whose
   slice holds its slot, the decode kernel's partial mode on each slice
   (4 launches; the whole step launches the decode kernel once), the
   rows' partials combined, each rank's rows of wo, against the whole
   layer's step (SERVE_SPLIT_TOL; cache slots not written equal bit for
   bit); then each layer's prefill split by heads, its caches relaid to
   each rank's slots (the all-to-all's pieces) bit for bit, and the greedy
   argmax over the vocabulary split four ways against ``torch.argmax``;
   and the partial mode at llama3-8b's and gemma2-9b's slice shapes beside
   its plain version and compiled ``flex_attention(..., return_lse=True)``.

Phase 3's ``query`` lines also give each query's peak device memory and
the join kernel's hash-table scratch (``join_table_mib``); phase 6's
``service`` lines give cold and warm ms, caps, retries, compiles, peak
memory and the bytes copied to the host; phase 7's ``spmd`` lines the
same for spmd mode plus the bytes all-gathered; phase 8's ``mrql``
lines the baseline's ms and jobs; phase 9's ``train`` lines the steps,
the routes' agreement and the resume; phases 10 and 11 the ``moe`` and
``ssm`` lines, phase 12 the ``vlm`` and ``audio`` lines, phase 13 the
``verify``, ``lint``, dry-run (``OK``) and ``train dots`` lines, phase
14 the ``fsdp`` lines and the pod-mesh dry-run (``OK ... x 16x16``)
lines, phase 15 the ``dense`` lines (params, seconds to initialise,
prefill ms, decode ms/token, tok/s, peak MiB and launches a serve; the
routes' differences), phase 16 the ``moe-wide`` lines (the same, the
peak after init, and the ``moe float64`` lines), phase 17 the ``tp
layer`` lines (each tensor's largest difference over its largest
|value|, the launches, ms), phase 18 the ``serve split`` lines. Phases
run in the order 1–4, 6, 7, 8, 5, 9, 10, 11, 12, 13, 14, 15, 16, 17,
18: one database's tables, or one model, on the card at a time.

Which templates the flash backward (and the forward with L) ran at each
training shape is read last, by ``torch.profiler`` in a process of its
own for each shape (``python3 chip_smoke.py --templates <inputs.pt>``,
on the layer inputs the training run gave the kernels, the libraries
already built): in bf16 they must be the tensor-core pair, at every
head_dim.

Then one JSON line with the seven kernels' numbers (the six ports of
the Pallas kernels and the flash backward) and the rows of the same
kernels at the other shapes the paths gave them (each record's
``where``), the decode kernel's partial mode among them, the card's name and power limit, and the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero without
that line, as does a machine without CUDA or a directory without the
port's sources.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SPEC = {"num_stations": 2000, "years": tuple(range(1955, 2005)),
        "days_per_year": 8}
PARTITIONS = 4
SEED = 0
SUM_RTOL = 1e-5      # float sums (another order, or another association)
REF_RTOL = 1e-5      # float32 results vs the float64 numpy reference
# H100 SXM HBM3 memory rate and dense tensor-core peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# attention kernel vs plain version: float32 another summation order,
# bf16 outputs rounded to bf16 (one ulp below 4 is at most 1.6e-2)
ATT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the forward kernel's row log-sum-exp L vs the plain one (atol and rtol):
# float32 another summation order; bf16 the same bf16 inputs, scores from
# tensor-core products and ex2.approx instead of float32 einsum and exp
LSE_TOL = {"float32": 1e-4, "bfloat16": 2e-3}
# the LM path (phase 5)
LM_ARCH = "qwen3-1.7b"
LM_REQUESTS, LM_PROMPT, LM_GEN = 8, 2048, 32
# kernel route vs plain route, teacher-forced: largest absolute
# difference of any prefill or decode-step logit. Both routes compute in
# bf16; the attention outputs differ in the last bf16 bit here and there,
# and 28 layers carry that into logits of standard deviation ~1.
LOGIT_ATOL = 0.25
# the LM training path (phase 9): launch.train.train at full width
TRAIN_ARCH = "qwen3-1.7b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 8, 2048
# kernel route vs plain route (dense attention): value_and_grad of the
# same params and batch 0 in bf16 compute, loss and global grad norm
# relative, each leaf's largest difference over its own largest |g|.
# Measured on the H100: 4.0e-6, 2.3e-4 and 0.049 (the attention outputs
# differ in the last bf16 bit here and there, and 28 layers of bf16
# matmuls carry that into the gradients); the limits leave 2x or more.
TRAIN_LOSS_RTOL = 1e-3
TRAIN_NORM_RTOL = 1e-2
TRAIN_GRAD_TOL = 0.1
# the backward kernel at the training shape against its plain version,
# each output held to its own size (its gradients are far below ATT_TOL's
# order-1 scale): largest |err| over largest |g|, and RMS of err over
# RMS of g, which shows an error in the bulk of the rows. In bf16 the
# outputs round to bf16 (2^-9 relative) and P and dS enter the tensor-
# core products in bf16; float32 runs the FP32-core kernels on the same
# inputs cast to float32, another summation order only. Measured on the
# H100 (largest |g| 3.5-8.1, RMS 0.08-0.13): bf16 at most 2.2e-3 and
# 7.8e-5, float32 3.5e-6 and 1.6e-6.
TRAIN_BWD_TOL = {"bfloat16": {"max": 2e-2, "rms": 1e-2},
                 "float32": {"max": 1e-4, "rms": 1e-4}}
# resume at the smoke config (head_dim 64, the flash kernels' smallest):
# the resumed run's params against the uninterrupted run's
RESUME_ATOL = 1e-6
RESUME = dict(steps=8, ckpt_every=4, fail_at=6, batch=2, seq=64)
# phase 10: the MoE model (granite-moe-1b-a400m) at full width
MOE_ARCH = "granite-moe-1b-a400m"
# float32 compute, kernel route (the FP32-core flash and decode kernels)
# vs plain route, teacher-forced: largest |logit| difference. Measured
# on the H100 (NVIDIA H100 80GB HBM3, 700 W): 1.24e-4, with 3.8e-5 of the
# routing decisions differing even in float32; the limit leaves 4x
MOE_F32_LOGIT_ATOL = 5e-4
# training routes in float32 (route_grads): loss and grad norm relative,
# each leaf's largest difference over its largest |g|. Measured on the
# H100 (700 W): 0 (the same float32 loss), 8.0e-6 and 8.2e-3; the limits
# leave 2.4x or more (the loss: float32's resolution)
MOE_TRAIN_TOL = {"loss": 1e-6, "norm": 2e-5, "leaf": 2e-2}
# one MoE layer in float64 on the card vs the CPU: routing equal, the
# output over its largest |value|. The reference computes the router's
# logits, softmax and gates in float32 and sums a top-k > 1 combine in
# float32, so float64 inputs give outputs rounded at float32 (its GEMM in
# another order on the card); a row put in a wrong slot would move the
# output by O(1). Measured on the H100 (700 W): 7.0e-7; the limit leaves
# 2.9x
MOE_F64_TOKENS = 4096
MOE_F64_RTOL = 2e-6
# phase 11: the Mamba-2 model (mamba2-370m) at full width
SSM_ARCH = "mamba2-370m"
# float32: a forward over 2304 tokens vs a prefill of 2048 and 32 decode
# steps, largest |logit| difference at positions 2048-2079. Measured on
# the H100 (NVIDIA H100 80GB HBM3, 700 W): 3.41e-5; the limit leaves 2.9x
SSM_CHAIN_ATOL = 1e-4
# the fixed-batch check of phase 11 (the reference's own recipe for "a
# train step learns", tests/test_archs_smoke.py:70-84, at train()'s
# default peak lr): steps on batch 0 again and again
SSM_FIT_STEPS = 4
# phase 12: the vlm and audio front ends at full width, 8 x 2048
# positions (qwen2-vl: 512 patches and 1536 tokens, as the pipeline
# splits them; hubert: frames)
VLM_ARCH = "qwen2-vl-2b"
AUDIO_ARCH = "hubert-xlarge"
# float32 compute, kernel route (the FP32-core flash and decode kernels)
# vs plain route (dense attention): the largest |logit| difference,
# teacher-forced prefill and decode steps (qwen2-vl) or every frame's
# logits (hubert). Measured on the H100 (NVIDIA H100 80GB HBM3, 700 W):
# 3.03e-5 and 3.23e-5; the limit leaves 6x
VLM_F32_LOGIT_ATOL = 2e-4
AUDIO_F32_LOGIT_ATOL = 2e-4
# the float32 training routes of both models (route_grads): loss and
# grad norm relative, each leaf's largest difference over its largest |g|.
# Measured on the H100 (700 W): qwen2-vl 0, 6.3e-8, 1.72e-5; hubert 0, 0,
# 1.28e-5; the limits leave 5x or more
FRONTEND_TRAIN_TOL = {"loss": 1e-6, "norm": 1e-6, "leaf": 1e-4}
# phase 13: the dry run's argument bytes of phase 9's cell against what
# the card's allocator holds more once that run's params, AdamW state and
# batch are built (each block rounds up to 512 bytes)
DRYRUN_ARG_RTOL = 1e-3
DRYRUN_JOBS = 8            # cells sized at once, one process each
# remat "dots" vs "full" (route_grads), float32 on the kernel route, at
# a batch whose saved products fit beside float32 params and gradients:
# one computation, the 2-D products saved or recomputed
DOTS_ROUTE_BATCH = 4
DOTS_TRAIN_TOL = {"loss": 1e-6, "norm": 1e-6, "leaf": 1e-4}
# phase 14 (qwen3-1.7b and, 14e, granite-moe-1b-a400m): the sharded path
# against the one-process one in float32 at one rank, where no
# collective runs: the same computation, expected bit for bit; where
# not, each difference within this relative bound
FSDP_ROUTE_BATCH = 4
FSDP_ROUTE_RTOL = 1e-6
FSDP_SAVE = dict(steps=2, ckpt_every=2, batch=2, seq=64)
# phase 15: the dense archs no other phase runs, served at their
# published width and depth, one on the card at a time
DENSE_ARCHS = ("llama3-8b", "gemma2-9b", "gemma3-12b")
# (requests, prompt_len): prompts of prompt_len / 2 to prompt_len tokens,
# all padded to prompt_len, then LM_GEN greedy tokens. gemma2's prompts
# of 3072-6144 tokens are the only traffic at which its window of 4096
# cuts keys (and at seed 0 three of the four are longer than 4096)
DENSE_TRAFFIC = {"llama3-8b": (LM_REQUESTS, LM_PROMPT),
                 "gemma2-9b": (4, 6144), "gemma3-12b": (LM_REQUESTS,
                                                         LM_PROMPT)}
# the gate runs in float32 at full width with the depth cut to whole
# pattern periods (gemma3: two 5:1 periods), whose float32 weights,
# caches and the plain route's dense scores fit the card together
DENSE_F32_LAYERS = {"llama3-8b": 8, "gemma2-9b": 8, "gemma3-12b": 12}
# float32 compute, kernel route (the FP32-core flash and decode kernels)
# vs plain route (dense attention), teacher-forced: the largest |logit|
# difference of any prefill or decode-step logit, at DENSE_F32_LAYERS.
# Measured on the H100 (NVIDIA H100 80GB HBM3, 700.00 W): llama3-8b
# 2.02e-5, gemma2-9b 1.85e-5, gemma3-12b 1.76e-5; the limits leave 4.9x
# or more
DENSE_F32_LOGIT_ATOL = {"llama3-8b": 1e-4, "gemma2-9b": 1e-4,
                        "gemma3-12b": 1e-4}
# phase 16: the MoE archs no other phase serves, at their published
# width with the depth cut so that the bf16 weights, one layer drawn in
# float32 beside them (``model.init_compute_params``) and the serve fit
# one card: llama4-scout 12 of 48 layers, 28,494,197,760 params, 53.07 GiB
# in bf16 (a layer drawn in float32 adds ~8.2 GiB, and the stack of its 16
# experts in ``moe.moe_init`` up to 2.7 GiB more for a moment); jamba 16 of
# 32 layers, two whole 8-layer periods (attention at 4 and 12, MoE at the
# odd positions), 25,730,002,368 params, 47.93 GiB (its MoE layer in
# float32 ~10.5 GiB, the stack up to 3.5 GiB). The phase does not shrink
# itself: a cut that does not fit fails it.
MOE_WIDE_ARCHS = ("llama4-scout-17b-a16e", "jamba-v0.1-52b")
MOE_WIDE_LAYERS = {"llama4-scout-17b-a16e": 12, "jamba-v0.1-52b": 16}
# the float32 gate's depth, float32 weights, caches and the plain route's
# dense scores together on the card: llama4-scout 4 layers
# (10,877,383,680 params, 40.52 GiB), jamba one period (12,999,220,960,
# 48.43 GiB)
MOE_WIDE_F32_LAYERS = {"llama4-scout-17b-a16e": 4, "jamba-v0.1-52b": 8}
# float32 compute, kernel route vs plain route teacher-forced, the plain
# route's routing replayed from the kernel route's expert ids
# (``RouteReplay``: at top-1 one flipped decision swaps a token's whole
# routed output): the largest |logit| difference at MOE_WIDE_F32_LAYERS.
# Measured on the H100 (NVIDIA H100 80GB HBM3, 700.00 W): llama4-scout
# 2.37e-5, jamba 1.79e-5, the routes' own routers agreeing on every
# decision; the limits leave 4.2x or more
MOE_WIDE_F32_LOGIT_ATOL = {"llama4-scout-17b-a16e": 1e-4,
                           "jamba-v0.1-52b": 1e-4}
# moe_f64_check at these widths, cut from phase 10's 4096 tokens: the
# layer's experts (16 of 5120 x 8192 or 4096 x 14336) copied to the host
# and run there in float64 take 12.9 and 16.5 s at 512 tokens (H100
# machine, 700.00 W), capacities of 40 (top-1) and 80 (top-2) rows an
# expert
MOE_WIDE_F64_TOKENS = 512
# phase 17: the tensor-parallel split of one layer at full width, every
# one of TP_RANKS ``model`` ranks' share computed in turn on the card
# (``fsdp.split_in_turn``), held against the unsplit layer on TP_TOKENS
# tokens: llama3-8b's layer, gemma3-12b's local layer (window 1024,
# qk-norm, post-norms), jamba's first (a Mamba-2 mixer of 128 heads of
# 64, state 16, and a dense MLP) and mamba2-370m's (a mixer of 32 heads
# of 64, state 128, alone)
TP_ARCHS = ("llama3-8b", "gemma3-12b", "jamba-v0.1-52b", "mamba2-370m")
TP_RANKS = 4
TP_TOKENS = (8, 2048)
# the split's output, input gradient and every weight gradient against
# the unsplit layer's, each difference over the tensor's largest |value|:
# float32 re-associates the split products' sums (float32 roundings);
# bfloat16 also lets such a sum round to the other side of a bf16
# boundary now and then, and what follows rounds its own way
TP_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# phase 17's vocabulary lines: the token lookup and the chunked loss of
# llama3-8b (its own lm_head) and gemma2-9b (the tied embed, final
# softcap 30) at published width, V split over TP_RANKS ranks in turn
# (``fsdp.vocab_in_turn``) against whole on TP_TOKENS tokens, one in
# TP_VOCAB_UNLABELED of the labels -1; the loss, its input gradient,
# the table's gradient and the lookup's table gradient held to TP_TOL,
# the lookup's rows equal bit for bit
TP_VOCAB_ARCHS = ("llama3-8b", "gemma2-9b")
# the flash backward at gemma2-9b's training shape, on seeded inputs: one
# 4 x 2048 microbatch of its 16/8 heads of 256, causal (its window of
# 4096 cuts nothing at 2048), softcap 50, scale 256^-1/2: (B, Hq, S, D),
# g, softcap
GEMMA2_BWD = ((4, 16, 2048, 256), 2, 50.0)
TP_VOCAB_UNLABELED = 8
# result positions (DistributeResult order) that are sums, averages or
# divisions: compared to SUM_RTOL between routes, all else exactly
# phase 18: the serve over a (1, 4) mesh, one layer's decode step with
# every ``model`` rank's share computed in turn (``fsdp.decode_in_turn``):
# (arch, requests, prompt length) of the cache, llama3-8b and llama4-scout
# with phase 5's traffic, gemma2-9b's local layer (window 4096) with 4
# prompts of 3072-6144 tokens, so that the window over four slices of 1544
# slots spans three ranks
SERVE_SPLIT_RANKS = 4
SERVE_SPLIT_CASES = (("llama3-8b", LM_REQUESTS, LM_PROMPT),
                     ("gemma2-9b", 4, 6144),
                     ("llama4-scout-17b-a16e", LM_REQUESTS, LM_PROMPT))
# the split step's output against the whole layer's, largest difference
# over the largest |value|: the heads' products and the row product's
# float32 partials re-associate sums, and the combine weighs four slices'
# partials where the whole kernel merges its own splits; in bf16 each
# path rounds its attention output and row product once, in other places.
# Measured on the H100 (NVIDIA H100 80GB HBM3, 700.00 W): float32 5.71e-7,
# 8.07e-7, 4.94e-7, bf16 5.95e-3, 8.20e-3, 5.15e-3 (llama3-8b, gemma2-9b,
# llama4-scout); the limits are 12x and 3.7x the worst, the bf16 one
# TP_TOL's
SERVE_SPLIT_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
TOLERANT = {"Q3": {0}, "Q4": {0}, "Q7": {0}, "Q8": {0}, "Q9": {2},
            "Q10": {1}, "Q11": {2}, "Q12": {2}}


class SmokeError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def cuda_ms(fn, budget_s: float = 0.25, max_iters: int = 50) -> float:
    """Mean device time of ``fn`` in ms over a run of launches, timed
    with CUDA events after two warm-up calls."""
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    iters = int(max(3, min(max_iters, budget_s * 1e3 / once)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def release(dev) -> None:
    """Free what dropped objects held on the card: a collection first (a
    service and its admission runtime refer to each other, so a deleted
    service's device tables live on until the cyclic collector runs),
    then the caching allocator's free blocks."""
    import gc
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions on seeded edge shapes
# ---------------------------------------------------------------------------

def _gen(seed: int, dev):
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def join_inputs(p, nb, np_, nkeys, seed, dev):
    """Duplicate build keys, probe keys that mostly hit, ~15 % invalid."""
    import torch
    g = _gen(seed, dev)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    bk = [ints(0, nb // 2 + 1, (p, nb))]
    pk = [ints(0, nb // 2 + 20, (p, np_))]
    if nkeys == 2:
        bk.append(ints(-3, 3, (p, nb)))
        pk.append(ints(-3, 3, (p, np_)))
    bv = torch.rand((p, nb), generator=g, device=dev) > 0.15
    pv = torch.rand((p, np_), generator=g, device=dev) > 0.15
    return tuple(bk), bv, tuple(pk), pv


I32_MIN, I32_MAX = -2**31, 2**31 - 1


def join_edge_inputs(kind, p, nb, np_, nkeys, seed, dev):
    """The hash table's worst cases, ~15 % invalid rows on both sides:
    ``equal`` every build key equal; ``miss`` no probe key present;
    ``extreme`` keys at INT32_MIN/INT32_MAX and negative, duplicated;
    ``k0`` k0 equal everywhere, k1 different, and probes that swap
    (k0, k1); ``random`` ``join_inputs``."""
    import torch
    if kind == "random":
        return join_inputs(p, nb, np_, nkeys, seed, dev)
    g = _gen(seed, dev)

    def ints(lo, hi, n):
        return torch.randint(lo, hi + 1, (p, n), generator=g, device=dev,
                             dtype=torch.int64).to(torch.int32)

    def share(n, x):
        return torch.rand((p, n), generator=g, device=dev) < x

    if kind == "equal":
        bk = [torch.full((p, nb), 7, dtype=torch.int32, device=dev),
              torch.full((p, nb), -2, dtype=torch.int32, device=dev)]
        hit = share(np_, 0.5)
        pk = [torch.where(hit, 7, ints(-9, 9, np_)).int(),
              torch.where(hit, -2, ints(-3, 3, np_)).int()]
    elif kind == "miss":
        bk = [ints(0, nb, nb), ints(-5, 5, nb)]
        pk = [ints(nb + 1, 3 * nb + 1, np_), ints(-5, 5, np_)]
    elif kind == "extreme":
        pool = torch.tensor([I32_MIN, I32_MIN + 1, -2, -1, 0, 1,
                             I32_MAX - 1, I32_MAX], dtype=torch.int32,
                            device=dev)
        bk = [pool[ints(0, 7, nb).long()], pool[ints(0, 7, nb).long()]]
        pk = [pool[ints(0, 7, np_).long()], pool[ints(0, 7, np_).long()]]
        bk[0] = torch.where(share(nb, 0.3), ints(I32_MIN, -1, nb), bk[0])
        pk[0] = torch.where(share(np_, 0.3),
                            bk[0][:, ints(0, nb - 1, np_)[0].long()], pk[0])
    elif kind == "k0":
        bk = [torch.full((p, nb), 3, dtype=torch.int32, device=dev),
              ints(0, nb, nb)]
        pk = [torch.full((p, np_), 3, dtype=torch.int32, device=dev),
              ints(0, 2 * nb, np_)]
        swap = share(np_, 0.3)
        pk = [torch.where(swap, pk[1], pk[0]), torch.where(swap, pk[0], pk[1])]
    else:
        raise ValueError(kind)
    return (tuple(bk[:nkeys]), ~share(nb, 0.15), tuple(pk[:nkeys]),
            ~share(np_, 0.15))


# the join's edge inputs: kind, P, NB, NP, keys
JOIN_EDGES = [
    ("random", 4, 1000, 777, 1), ("random", 4, 2049, 3000, 2),
    ("random", 1, 5, 1, 2), ("random", 2, 1, 300, 1),
    ("equal", 4, 200000, 50000, 2), ("equal", 2, 64, 100, 1),
    ("miss", 4, 100000, 100000, 2), ("extreme", 4, 50000, 40000, 2),
    ("extreme", 2, 257, 129, 1), ("k0", 4, 30000, 40000, 2),
    ("random", 2, 2**20 + 3, 100000, 2),   # 2^22 table slots
    ("random", 2, 1, 50, 2), ("random", 2, 0, 300, 2),
]


def seg_layout(g, p, n, s, kind, dev):
    """Segment ids and valid flags [P, N] of the aggregate edge cases:
    ``runs`` station-major runs of 97 rows of one id (a run crosses the
    kernels' 4096-row tiles), ids cycling over [-1, S], 20 % valid;
    ``hot`` every valid row in segment 0 but a few ids outside [0, S);
    ``sparse`` the runs with 0.4 % of rows valid, in clusters of two
    (Q12's selection); ``none`` the runs with no row valid."""
    import torch
    rows = torch.arange(n, device=dev)[None, :]
    part = torch.arange(p, device=dev)[:, None]
    segs = ((rows // 97 + 13 * part) % (s + 2) - 1).to(torch.int32)
    valid = torch.rand((p, n), generator=g, device=dev) < 0.2
    if kind == "hot":
        far = torch.rand((p, n), generator=g, device=dev) < 0.02
        segs = torch.where(far, s, 0).to(torch.int32)
        valid = torch.rand((p, n), generator=g, device=dev) < 0.9
    elif kind == "sparse":
        valid = (rows + 7 * part) % 500 < 2
    elif kind == "none":
        valid = torch.zeros((p, n), dtype=torch.bool, device=dev)
    elif kind != "runs":
        raise ValueError(kind)
    return segs, valid


def agg_inputs(p, n, s, nc, seed, dev, kind="random"):
    """Tenths-valued columns, NaNs masked through ``ok``; ``random``:
    invalid rows, segment ids outside [0, S); else ``seg_layout``."""
    import torch
    g = _gen(seed, dev)
    vals = torch.randint(-400, 400, (p, n, nc), generator=g,
                         device=dev).float() / 10
    vals[torch.rand((p, n, nc), generator=g, device=dev) < 0.05] = float("nan")
    ok = (torch.rand((p, n, nc), generator=g, device=dev) > 0.1) \
        & ~torch.isnan(vals)
    if kind != "random":
        return (vals, ok) + seg_layout(g, p, n, s, kind, dev) + (s,)
    segs = torch.randint(-1, s + 2, (p, n), generator=g, device=dev,
                         dtype=torch.int32)
    valid = torch.rand((p, n), generator=g, device=dev) > 0.2
    return vals, ok, segs, valid, s


def topk_inputs(p, n, seed, dev, float_key=True):
    """Flag, a tie-heavy float key holding both zeros, an int key."""
    import torch
    g = _gen(seed, dev)
    valid = torch.rand((p, n), generator=g, device=dev) > 0.3
    f = torch.randint(-3, 4, (p, n), generator=g, device=dev).float()
    negz = (f == 0) & (torch.rand((p, n), generator=g, device=dev) < 0.5)
    f = torch.where(negz, torch.full_like(f, -0.0), f)
    i = torch.randint(0, 5, (p, n), generator=g, device=dev,
                      dtype=torch.int32)
    return ((~valid).to(torch.int32), f if float_key else f.to(torch.int32), i)


def check_join(args) -> float:
    """Bit-equal to the plain version, twice (the table is rebuilt)."""
    import torch
    from repro_torch.kernels import hash_join, ref
    pos, matched = hash_join.block_join_probe(*args)
    want, wm = ref.block_join_probe(*args)
    torch.cuda.synchronize()
    shape = tuple(args[3].shape) + (args[1].shape[1], len(args[0]))
    require(torch.equal(pos, want) and torch.equal(matched, wm),
            f"block_join_probe disagrees with its plain version at "
            f"(P, NP, NB, keys) = {shape}")
    require(torch.equal(hash_join.block_join_probe(*args)[0], pos),
            "block_join_probe differs from run to run")
    return 0.0


def check_agg(args) -> float:
    """Counts, mins and maxs exact; each sum within SUM_RTOL of the sum
    of its values' magnitudes (the float-sum error bound). Returns the
    largest absolute difference of the sums."""
    import torch
    from repro_torch.kernels import ref, seg_aggregate
    vals, ok, segs, valid, s = args
    got = seg_aggregate.segmented_aggregate(vals, ok, segs, valid, s)
    want = ref.segmented_aggregate(vals, ok, segs, valid, s)
    mag = ref.segmented_aggregate(vals.abs(), ok, segs, valid, s)[1]
    torch.cuda.synchronize()
    require(torch.equal(got[0], want[0]), "segmented_aggregate counts")
    require(torch.equal(got[2], want[2]) and torch.equal(got[3], want[3]),
            "segmented_aggregate mins/maxs")
    err = (got[1] - want[1]).abs()
    worst = float(err.max()) if err.numel() else 0.0
    require(bool((err <= SUM_RTOL * mag + 1e-30).all()),
            f"segmented_aggregate sums off by up to {worst}")
    again = seg_aggregate.segmented_aggregate(vals, ok, segs, valid, s)
    require(torch.equal(again[1], got[1]),
            "segmented_aggregate sums differ from run to run")
    return worst


def check_topk(keys, cap) -> float:
    import torch
    from repro_torch.kernels import ref, seg_topk
    got = seg_topk.segment_topk(keys, cap)
    want = ref.segment_topk(keys, cap)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "segment_topk disagrees with its plain "
            "version")
    return 0.0


def attn_err(got, want, dtype_name: str, what: str) -> float:
    """Largest |got - want|; fails past ATT_TOL[dtype] (atol and rtol)."""
    import torch
    torch.cuda.synchronize()
    tol = ATT_TOL[dtype_name]
    g, w = got.float(), want.float()
    require(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    err = (g - w).abs()
    worst = float(err.max())
    require(bool((err <= tol + tol * w.abs()).all()),
            f"{what} disagrees with its plain version by up to {worst}")
    return worst


def normal(shape, seed, dev, dtype):
    import torch
    return torch.randn(shape, generator=_gen(seed, dev), device=dev).to(dtype)


FLASH_EDGES = [
    # causal, window, softcap, g, sq, sk, d, dtype
    (True, None, None, 2, 256, 256, 128, "bfloat16"),
    (False, None, None, 1, 100, 77, 64, "float32"),
    (True, 4096, None, 2, 300, 300, 128, "bfloat16"),
    (True, 16, None, 8, 130, 200, 64, "float32"),
    (False, 16, None, 1, 200, 100, 64, "bfloat16"),   # rows with no live key
    (True, None, 50.0, 2, 129, 129, 256, "bfloat16"),
    (True, 16, 50.0, 1, 65, 65, 256, "float32"),
    # the bf16 tensor-core tiling: 128 query rows, 128 keys (64 at D = 256)
    (True, None, None, 2, 1000, 1000, 128, "bfloat16"),   # no tile multiple
    (True, None, None, 2, 100, 300, 128, "bfloat16"),     # Sq < Sk
    (True, 100, None, 2, 700, 700, 128, "bfloat16"),      # window across tiles
    (True, None, None, 1, 640, 640, 64, "bfloat16"),
    (True, None, None, 2, 600, 600, 256, "bfloat16"),
    # head_dim 80 (hubert-xlarge): the 128-wide tiling, zero-padded
    (False, None, None, 1, 256, 256, 80, "bfloat16"),
    (False, None, None, 1, 256, 256, 80, "float32"),
    (True, 100, 50.0, 2, 700, 700, 80, "bfloat16"),
    (True, 100, 50.0, 2, 300, 300, 80, "float32"),
    (False, None, None, 2, 100, 77, 80, "bfloat16"),     # ragged Sq, Sk
    (True, None, None, 1, 100, 300, 80, "float32"),      # Sq < Sk
    # the backward's tensor-core tiling (128 query rows / 64 keys for dQ,
    # 128 keys / 64 query rows for dK, dV) at g = 4
    (True, None, None, 4, 1000, 1000, 128, "bfloat16"),
    # rows with no live key
    (False, 8, 30.0, 4, 333, 200, 80, "bfloat16"),
    # qwen2-vl-2b's group (12 query heads over 2): dK, dV of a kv head
    # sum over 6 query heads; Sq no tile multiple, and Sq < Sk
    (True, None, None, 6, 1000, 1000, 128, "bfloat16"),
    (True, None, None, 6, 333, 333, 128, "float32"),
    (True, None, None, 6, 200, 700, 128, "bfloat16"),
    # llama4-scout's group (40 query heads over 8): g = 5, more than one
    # 128-row tile of the tensor-core tiling, and the FP32-core kernel
    (True, None, None, 5, 300, 300, 128, "bfloat16"),
    (True, None, None, 5, 200, 200, 128, "float32"),
    # the backward's tensor-core tiling at head_dim 256 (gemma2-9b,
    # gemma3-12b): 32-key tiles for dQ, 64 keys a CTA for dK, dV, the
    # warpgroups splitting the columns. Sq, Sk no multiple of 32, softcap
    # 50 on the masked diagonal tiles; Sq < Sk with g = 1; a window across
    # key tiles; rows with no live key
    (True, None, 50.0, 2, 1000, 1000, 256, "bfloat16"),
    (True, None, None, 1, 100, 300, 256, "bfloat16"),
    (True, 100, None, 2, 700, 700, 256, "bfloat16"),
    (False, 8, 30.0, 2, 333, 200, 256, "bfloat16"),
]
DECODE_EDGES = [
    # heads, g, smax, d, window, softcap; each in bf16 and float32. Six
    # heads with kv_len 1, 2, ragged, Smax - 1, Smax and 0 (no live slot):
    # the short heads use one split, the long ones many
    (6, 2, 2080, 128, None, None),
    (6, 1, 1000, 64, None, None),
    (6, 8, 333, 256, None, 50.0),
    (6, 4, 2080, 128, 16, None),
    (6, 2, 65, 128, 4096, 30.0),
    (6, 2, 20, 128, None, None),     # one split per head (Smax < a tile)
    (6, 4, 700, 64, 100, 20.0),
    (400, 2, 300, 128, None, None),  # more heads than resident CTAs
    (6, 2, 100, 16, None, None),     # bf16 off the tensor-core kernel
    (6, 4, 257, 32, 50, None),
    (16, 6, 2080, 128, None, None),  # qwen2-vl-2b: g = 6, two pad rows a
                                     # block of 8
    (16, 5, 2080, 128, None, None),  # llama4-scout: g = 5, three pad rows
]
# the decode kernel's partial mode over one rank's slice of a cache split
# by sequence (heads, g, slice slots, d, window, softcap), each in bf16 and
# float32, on the shifted lengths of PARTIAL_LENS
DECODE_PARTIAL_EDGES = [
    (8, 2, 520, 128, None, None),     # qwen3-1.7b's and llama3's slices
    (8, 4, 520, 128, None, None),
    (8, 5, 520, 128, None, None),     # llama4-scout: g = 5
    (8, 2, 1544, 256, 4096, 50.0),    # gemma2-9b's local layer
    (8, 2, 1544, 256, None, 50.0),
    (8, 4, 300, 64, 100, None),       # granite's D = 64, a short window
    (8, 2, 20, 128, None, None),      # one split per head
    (400, 2, 300, 128, None, None),   # more heads than resident CTAs
]


def partial_lens(smax: int, window) -> list:
    """Shifted lengths, one a head, that the partial mode meets on a
    slice of ``smax`` slots: no live slot (0 and below: the slice lies
    past the live slots), 1, ragged, Smax, past Smax (the live slots run
    on past the slice, every slot live, or with a window only its
    tail), and where a window is on, windows that start in the slice
    before (the slice holds their last slots) or end in the one after."""
    out = [0, -37, 1, smax // 2 + 3, smax, smax + 7, 3 * smax]
    if window:
        out += [min(window, smax) // 2, smax + window // 2,
                smax + window - 1, smax + window + 5]
    return out


AGG_EDGES = [
    # P, N, S, C, kind: uniform ids (some outside [0, S)); station-major
    # runs with N no multiple of 16 (the flag vectors) and runs across
    # tiles; one hot segment; Q12-like 0.4 % valid; S = 1; N below a warp;
    # no row valid; runs at a large S (the global accumulator); C = 5 (the
    # runtime column count)
    (4, 5000, 37, 2, "random"), (4, 3001, 4500, 3, "random"),
    (2, 700, 9000, 4, "random"), (3, 999, 16, 0, "random"),
    (4, 300000, 2000, 1, "random"),
    (4, 100003, 2000, 3, "runs"), (2, 50000, 64, 2, "hot"),
    (4, 200000, 2000, 3, "sparse"), (2, 9000, 1, 1, "runs"),
    (3, 33, 5, 4, "runs"), (3, 5000, 37, 2, "none"),
    (2, 300000, 9000, 4, "runs"), (2, 3000, 50, 5, "random")]
# P, N, S, valid share (``random`` ids) or a ``seg_layout`` kind
SUM_COUNT_EDGES = [(4, 5000, 37, 0.8), (2, 3001, 9000, 0.8),
                   (3, 999, 4096, 0.0), (4, 300000, 2000, 0.8),
                   (4, 100003, 2000, "runs"), (2, 50000, 64, "hot"),
                   (4, 200000, 2000, "sparse"), (2, 9000, 1, "runs"),
                   (3, 33, 5, "runs"), (3, 5000, 37, "none")]


def check_flash(q, k, v, kw) -> float:
    import torch
    from repro_torch.kernels import flash_attention, ref
    got = flash_attention.flash_attention_bhsd(q, k, v, **kw)
    want = ref.flash_attention(q, k, v, **kw)
    err = attn_err(got, want, str(q.dtype).split(".")[1], "flash_attention")
    again = flash_attention.flash_attention_bhsd(q, k, v, **kw)
    require(torch.equal(again, got),
            "flash_attention differs from run to run")
    return err


def check_decode(q, k, v, kv_len, kw) -> float:
    import torch
    from repro_torch.kernels import decode_attention, ref
    got = decode_attention.decode_attention_bhgd(q, k, v, kv_len, **kw)
    want = ref.decode_attention(q, k, v, kv_len, **kw)
    err = attn_err(got, want, str(q.dtype).split(".")[1], "decode_attention")
    # a second call right after: an arrival counter of the fused combine
    # left non-zero would combine early and differ
    again = decode_attention.decode_attention_bhgd(q, k, v, kv_len, **kw)
    require(torch.equal(again, got),
            "decode_attention differs from run to run")
    return err


def check_decode_partial(q, k, v, kv_len, kw) -> float:
    """The partial mode's (o, lse) against its plain version: o within
    ATT_TOL of the inputs' dtype, lse within LSE_TOL where it is finite
    and -inf (with o = 0) exactly where no slot is live; the same bits
    on a second launch."""
    import torch
    from repro_torch.kernels import decode_attention, ref
    dt = str(q.dtype).split(".")[1]
    o, lse = decode_attention.decode_attention_partial_bhgd(q, k, v, kv_len,
                                                            **kw)
    wo, wl = ref.decode_attention_partial(q, k, v, kv_len, **kw)
    torch.cuda.synchronize()
    require(o.dtype == torch.float32 and o.shape == q.shape
            and lse.shape == q.shape[:-1],
            f"decode_attention_partial: o {o.dtype} {tuple(o.shape)}, lse "
            f"{tuple(lse.shape)}")
    dead = torch.isinf(wl)
    require(bool((torch.isinf(lse) == dead).all())
            and bool((lse[dead] < 0).all())
            and not bool(o[dead].any()),
            "decode_attention_partial: a slice with no live slot did not "
            "give o = 0, lse = -inf")
    err = attn_err(o, wo, dt, "decode_attention_partial")
    live = ~dead
    if bool(live.any()):
        check_lse(lse[live], wl[live], dt, "decode_attention_partial")
    o2, lse2 = decode_attention.decode_attention_partial_bhgd(q, k, v,
                                                              kv_len, **kw)
    require(torch.equal(o2, o) and torch.equal(lse2, lse),
            "decode_attention_partial differs from run to run")
    return err


def check_sum_count(vals, segs, valid, s) -> float:
    """Counts exact, sums within SUM_RTOL of the summed magnitudes, the
    same bits from launch to launch; returns the largest sum error."""
    import torch
    from repro_torch.kernels import ref, seg_aggregate
    sums, counts = seg_aggregate.segmented_sum_count(vals, segs, valid, s)
    wsums, wcounts = ref.segmented_sum_count(vals, segs, valid, s)
    mag, _ = ref.segmented_sum_count(vals.abs(), segs, valid, s)
    torch.cuda.synchronize()
    require(torch.equal(counts, wcounts), "segmented_sum_count counts")
    err = (sums - wsums).abs()
    worst = float(err.max()) if err.numel() else 0.0
    require(bool((err <= SUM_RTOL * mag + 1e-30).all()),
            f"segmented_sum_count sums off by up to {worst}")
    again, _ = seg_aggregate.segmented_sum_count(vals, segs, valid, s)
    require(torch.equal(again, sums),
            "segmented_sum_count sums differ from run to run")
    return worst


def check_lse(got, want, dtype_name: str, what: str) -> float:
    """Largest |got - want| of two row log-sum-exps; fails past
    LSE_TOL[dtype] (atol and rtol)."""
    import torch
    torch.cuda.synchronize()
    tol = LSE_TOL[dtype_name]
    require(got.dtype == torch.float32 and got.shape == want.shape,
            f"{what}: L {got.dtype} {tuple(got.shape)}")
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite L")
    err = (got - want).abs()
    worst = float(err.max())
    require(bool((err <= tol + tol * want.abs()).all()),
            f"{what}: L disagrees with the plain L by up to {worst}")
    return worst


def check_flash_bwd(q, k, v, do, kw) -> tuple[float, float]:
    """The forward kernel's L against the plain L, and O the same bits
    with L stored and not; then dQ, dK, dV of the backward kernel, handed
    that L, against the plain backward on the forward kernel's output (L
    recomputed); the same bits on a second launch. Returns the largest
    gradient error and the largest L error."""
    import torch
    from repro_torch.kernels import flash_attention, ref
    dt = str(q.dtype).split(".")[1]
    o, lse = flash_attention.flash_attention_bhsd(q, k, v, return_lse=True,
                                                  **kw)
    require(torch.equal(o, flash_attention.flash_attention_bhsd(q, k, v,
                                                                **kw)),
            "flash_attention: O differs with L stored and not")
    lse_err = check_lse(lse, ref.flash_attention(q, k, v, return_lse=True,
                                                 **kw)[1],
                        dt, "flash_attention")
    got = flash_attention.flash_attention_bwd_bhsd(q, k, v, o, do, lse, **kw)
    want = ref.flash_attention_bwd(q, k, v, o, do, **kw)
    err = max(attn_err(a, b, dt, f"flash_attention_bwd d{name}")
              for a, b, name in zip(got, want, "qkv"))
    again = flash_attention.flash_attention_bwd_bhsd(q, k, v, o, do, lse,
                                                     **kw)
    require(all(torch.equal(a, b) for a, b in zip(again, got)),
            "flash_attention_bwd differs from run to run")
    return err, lse_err


def attention_edge_checks(dev, errs: dict) -> None:
    import torch
    for i, (causal, window, cap, g, sq, sk, d, dt) in enumerate(FLASH_EDGES):
        dtype = getattr(torch, dt)
        q = normal((2 * g, sq, d), SEED + 30 + i, dev, dtype)
        k = normal((2, sk, d), SEED + 40 + i, dev, dtype)
        v = normal((2, sk, d), SEED + 50 + i, dev, dtype)
        kw = dict(g=g, causal=causal, window=window, softcap=cap)
        e = check_flash(q, k, v, kw)
        errs["flash_attention"] = max(errs["flash_attention"], e)
        # L and the backward on the same edges, in both dtypes
        for dtype in (torch.bfloat16, torch.float32):
            qq, kk, vv = (x.to(dtype) for x in (q, k, v))
            do = normal((2 * g, sq, d), SEED + 130 + i, dev, dtype)
            e, le = check_flash_bwd(qq, kk, vv, do, kw)
            errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], e)
            errs["flash_attention_lse"] = max(errs["flash_attention_lse"],
                                              le)
    for i, (bh, g, smax, d, window, cap) in enumerate(DECODE_EDGES):
        for dtype in (torch.bfloat16, torch.float32):
            q = normal((bh, g, d), SEED + 60 + i, dev, dtype)
            k = normal((bh, smax, d), SEED + 70 + i, dev, dtype)
            v = normal((bh, smax, d), SEED + 80 + i, dev, dtype)
            kv_len = torch.tensor([1, 2, smax // 2 + 3, smax - 1, smax, 0],
                                  dtype=torch.int32, device=dev)
            kv_len = kv_len.repeat(-(-bh // 6))[:bh].contiguous()
            e = check_decode(q, k, v, kv_len, dict(window=window,
                                                   softcap=cap))
            errs["decode_attention"] = max(errs["decode_attention"], e)
    for i, (bh, g, smax, d, window, cap) in enumerate(DECODE_PARTIAL_EDGES):
        lens = partial_lens(smax, window)
        for dtype in (torch.bfloat16, torch.float32):
            q = normal((bh, g, d), SEED + 160 + i, dev, dtype)
            k = normal((bh, smax, d), SEED + 170 + i, dev, dtype)
            v = normal((bh, smax, d), SEED + 180 + i, dev, dtype)
            kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
            kv_len = kv_len.repeat(-(-bh // len(lens)))[:bh].contiguous()
            e = check_decode_partial(q, k, v, kv_len, dict(window=window,
                                                           softcap=cap))
            errs["decode_attention_partial"] = max(
                errs["decode_attention_partial"], e)
    for i, (p, n, s, share) in enumerate(SUM_COUNT_EDGES):
        g = _gen(SEED + 90 + i, dev)
        vals = torch.randint(-400, 400, (p, n), generator=g,
                             device=dev).float() / 10
        if isinstance(share, str):
            segs, valid = seg_layout(g, p, n, s, share, dev)
        else:
            segs = torch.randint(-3, s + 3, (p, n), generator=g, device=dev,
                                 dtype=torch.int32)
            valid = torch.rand((p, n), generator=g, device=dev) < share
        e = check_sum_count(vals, segs, valid, s)
        errs["segmented_sum_count"] = max(errs["segmented_sum_count"], e)


def edge_checks(dev) -> dict[str, float]:
    import torch
    errs = {"block_join_probe": 0.0, "segmented_aggregate": 0.0,
            "segment_topk": 0.0, "segmented_sum_count": 0.0,
            "flash_attention": 0.0, "flash_attention_bwd": 0.0,
            "flash_attention_lse": 0.0, "decode_attention": 0.0,
            "decode_attention_partial": 0.0}
    for i, (kind, p, nb, np_, nk) in enumerate(JOIN_EDGES):
        e = check_join(join_edge_inputs(kind, p, nb, np_, nk, SEED + i, dev))
        errs["block_join_probe"] = max(errs["block_join_probe"], e)
    for i, (p, n, s, nc, kind) in enumerate(AGG_EDGES):
        e = check_agg(agg_inputs(p, n, s, nc, SEED + 10 + i, dev, kind))
        errs["segmented_aggregate"] = max(errs["segmented_aggregate"], e)
    # the last three span several sorted chunks (the merge runs)
    for i, (p, n, cap, fk, none_valid) in enumerate([
            (4, 2000, 16, True, False), (2, 1500, 1500, True, False),
            (3, 33, 5, False, False), (1, 1, 1, True, False),
            (2, 50000, 64, True, False), (2, 12000, 12000, True, False),
            (3, 20000, 100, True, True)]):
        keys = topk_inputs(p, n, SEED + 20 + i, dev, fk)
        if none_valid:
            keys = (torch.ones_like(keys[0]),) + keys[1:]
        e = check_topk(keys, cap)
        errs["segment_topk"] = max(errs["segment_topk"], e)
    attention_edge_checks(dev, errs)
    return errs


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def reference_results(spec) -> dict:
    """Q1–Q12 computed with numpy straight from the generated records
    (no XML, no plans, no tensors): row counts for the row queries,
    values for the scalar and grouped ones (station id order; Q11 in
    ranking order)."""
    import numpy as np
    from repro_torch.data.weather import _make_records
    rec = _make_records(spec)
    ns, nd, nt = spec.num_stations, len(spec.dates()), len(spec.datatypes)
    st, di = rec["station"], rec["date"]
    val = rec["value"].astype(np.float64)
    tname = np.asarray(spec.datatypes)[rec["dtype"]]
    year = np.asarray([d[0] for d in spec.dates()])[di]
    mday = np.asarray([d[1] * 100 + d[2] for d in spec.dates()])[di]
    sid = np.asarray([spec.station_id(i) for i in range(ns)])
    wash = np.asarray([spec.station_state(i) == "WASHINGTON"
                       for i in range(ns)])
    us = np.asarray([spec.station_is_us(i) for i in range(ns)])
    v3 = val.reshape(ns, nd, nt)
    tmax, tmin = (spec.datatypes.index(t) for t in ("TMAX", "TMIN"))

    def per_station(mask):
        cnt = np.bincount(st[mask], minlength=ns).astype(np.float64)
        tot = np.bincount(st[mask], weights=val[mask], minlength=ns)
        lo = np.full(ns, np.inf)
        hi = np.full(ns, -np.inf)
        np.minimum.at(lo, st[mask], val[mask])
        np.maximum.at(hi, st[mask], val[mask])
        return cnt, tot, lo, hi

    out = {
        "Q1": int(np.sum((st == 0) & (year >= 2003) & (mday == 1225))),
        "Q2": int(np.sum((tname == "AWND") & (val > 491.744))),
        "Q3": val[(st == 1) & (tname == "PRCP") & (year == 1999)].sum() / 10,
        "Q4": val[tname == "TMAX"].max() / 10,
        "Q5": int(np.sum(wash[st] & (year == 1976) & (mday == 704))),
        "Q6": int(np.sum((tname == "TMAX") & (year == 2000))),
        "Q7": val[us[st] & (tname == "TMIN") & (year == 2001)].min() / 10,
        "Q8": (v3[:, :, tmax] - v3[:, :, tmin]).mean() / 10,
    }
    cnt, tot, _, _ = per_station(tname == "TMAX")
    order = np.argsort(sid)
    out["Q9"] = [(sid[i], cnt[i], tot[i] / cnt[i]) for i in order if cnt[i]]
    rank = sorted(range(ns), key=lambda i: (-tot[i], sid[i]))[:3]
    out["Q11"] = [(sid[i], cnt[i], tot[i]) for i in rank]
    cnt, tot, _, hi = per_station(tname == "PRCP")
    out["Q10"] = [(sid[i], tot[i], hi[i]) for i in order
                  if cnt[i] and tot[i] >= 100]
    cnt, tot, lo, hi = per_station((tname == "PRCP") & (year == 2000))
    out["Q12"] = [(sid[i], cnt[i], tot[i], lo[i], hi[i]) for i in order
                  if cnt[i]]
    return out


def check_reference(name: str, rows: list, want) -> None:
    import numpy as np
    if isinstance(want, int):
        require(len(rows) == want, f"{name}: {len(rows)} rows, want {want}")
        return
    if not isinstance(want, list):
        require(len(rows) == 1 and np.isclose(rows[0][0], want,
                                              rtol=REF_RTOL, atol=0),
                f"{name}: {rows} vs {want}")
        return
    got = rows if name == "Q11" else sorted(rows, key=lambda r: r[0])
    require(len(got) == len(want), f"{name}: {len(got)} groups, want "
            f"{len(want)}")
    for g, w in zip(got, want):
        require(g[0] == w[0] and np.allclose(g[1:], w[1:], rtol=REF_RTOL,
                                             atol=0),
                f"{name}: {g} vs {w}")


def raw_agree(name: str, plan, a: dict, b: dict) -> None:
    """Kernel route vs plain route: valid, the flags and integer columns
    exact; floats from sums/avgs/divisions to SUM_RTOL, others exact."""
    import numpy as np
    require(set(a) == set(b), f"{name}: raw keys differ")
    valid = a["valid"]
    require(np.array_equal(valid, b["valid"]), f"{name}: valid differs")
    for k in a:
        if k.startswith("overflow"):
            require(np.array_equal(a[k], b[k]), f"{name}: {k} differs")
    for pos, v in enumerate(plan.vars):
        ga, gb = a[f"var{v}"], b[f"var{v}"]
        for x, y in (zip(ga, gb) if isinstance(ga, tuple) else [(ga, gb)]):
            x, y = x[valid], y[valid]
            if x.dtype == np.float32 and pos in TOLERANT.get(name, ()):
                ok = np.allclose(x, y, rtol=SUM_RTOL, atol=0, equal_nan=True)
            else:
                ok = np.array_equal(x, y, equal_nan=x.dtype.kind == "f")
            require(ok, f"{name}: var{v} differs between routes")


class Capture:
    """Wraps the executor-facing kernel entry points during the
    kernel-route runs and keeps, per kernel, the arguments of the call
    with the most work — the main path's own inputs for phase 4."""

    def __init__(self, ops):
        self.ops = ops
        self.saved = {}
        self.best: dict[str, tuple] = {}
        self.join_builds: list[tuple] = []   # (P, NB) of each join call
        self.agg_calls: list[tuple] = []     # every aggregate call's args

    def _wrap(self, attr, kernel, work):
        fn = getattr(self.ops, attr)
        self.saved[attr] = fn

        def wrapped(*args, **kw):
            w = work(*args)
            if kernel not in self.best or w > self.best[kernel][0]:
                self.best[kernel] = (w, args)
            if kernel == "block_join_probe":
                self.join_builds.append(tuple(args[1].shape))
            if kernel == "segmented_aggregate":
                self.agg_calls.append(args)
            return fn(*args, **kw)

        setattr(self.ops, attr, wrapped)

    def __enter__(self):
        self._wrap("hash_join_probe", "block_join_probe",
                   lambda bk, bv, pk, pv: bv.numel() * pv.shape[1])
        self._wrap("segmented_aggregate", "segmented_aggregate",
                   lambda v, ok, s, vl, ns: s.numel() * ns * (1 + v.shape[2]))
        self._wrap("segment_topk", "segment_topk",
                   lambda keys, cap: keys[0].numel() * len(keys) * cap)
        return self

    def __exit__(self, *exc):
        for attr, fn in self.saved.items():
            setattr(self.ops, attr, fn)


def run_query(ex, plan, cfg, mode: str = "sim", mesh=None) -> tuple:
    """(numpy raw dict, ResultSet, ms) of one ``Executor.run_compiled``:
    the device run and the copy of its raw outputs to the host (rows
    are decoded from them afterwards, outside the time)."""
    import torch
    cp = ex.compile(plan, mode=mode, mesh=mesh, config=cfg)
    if ex.device.type == "cuda":
        torch.cuda.synchronize(ex.device)
    t0 = time.perf_counter()
    rs = ex.run_compiled(cp)
    return rs.raw, rs, (time.perf_counter() - t0) * 1e3


def main_path(ex, spec, capture=None) -> list[dict]:
    """Q1–Q12 on the kernel route (cold and warm) and on the plain route,
    checked against each other and against ``reference_results``."""
    import torch
    from repro_torch.core import compile_query
    from repro_torch.core.presize import presized_config
    from repro_torch.core.queries import ALL
    from repro_torch.kernels.hash_join import table_slots
    want = reference_results(spec)
    on_cuda = ex.device.type == "cuda"
    records = []
    for name, text in ALL.items():
        plan = compile_query(text)
        cfg = presized_config(ex.db, plan)
        plain = dataclasses.replace(cfg, use_kernel_join=False,
                                    use_kernel_segments=False)
        if on_cuda:
            torch.cuda.reset_peak_memory_stats(ex.device)
        _, _, cold_ms = run_query(ex, plan, cfg)
        if capture is not None:
            capture.join_builds.clear()
        with capture if capture is not None else contextlib.nullcontext():
            raw, rs, warm_ms = run_query(ex, plan, cfg)
        peak = torch.cuda.max_memory_allocated(ex.device) if on_cuda else 0
        praw, _, plain_ms = run_query(ex, plan, plain)
        require(not rs.overflow, f"{name}: overflow at presized caps {cfg}")
        raw_agree(name, plan, raw, praw)
        rows = rs.rows()
        check_reference(name, rows, want[name])
        rec = {"query": name, "rows": len(rows), "cold_ms": cold_ms,
               "warm_ms": warm_ms, "plain_warm_ms": plain_ms,
               "peak_mib": peak / 2**20,
               # the join kernel's hash-table scratch, the largest call's
               "join_table_mib": max(
                   [p * table_slots(nb) * 4 / 2**20 for p, nb in
                    (capture.join_builds if capture is not None else [])],
                   default=0.0),
               "caps": {k: getattr(cfg, k) for k in
                        ("scan_cap", "join_cap", "group_cap", "topk_cap")}}
        log("query " + json.dumps(rec))
        records.append(rec)
    return records


# ---------------------------------------------------------------------------
# phase 6: the service path
# ---------------------------------------------------------------------------

# caps of 1 (2 groups) regrow by x4 a rung: the scan cap needs nine rungs
# to pass a million rows per partition, and a join or group cap may start
# growing only once the scan feeds it, so the default of 8 retries (sized
# for presized first caps) is too few from here
TINY_CAPS = dict(scan_cap=1, join_bucket=1, join_cap=1, group_cap=2)
TINY_RETRIES = 24


def host_bytes(raw: dict) -> int:
    """Bytes of a raw-output dict copied to the host."""
    return sum(a.nbytes for v in raw.values()
               for a in (v if isinstance(v, tuple) else (v,)))


def raw_identical(a: dict, b: dict) -> bool:
    """Two raw-output dicts of one plan at one config, bit for bit (the
    arrays are compared whole: decoding 4M slots into rows on the host
    would take seconds a result)."""
    import numpy as np

    def parts(v):
        return v if isinstance(v, tuple) else (v,)

    return set(a) == set(b) and all(
        len(parts(a[k])) == len(parts(b[k])) and all(
            x.shape == y.shape and np.array_equal(
                x, y, equal_nan=x.dtype.kind == "f")
            for x, y in zip(parts(a[k]), parts(b[k])))
        for k in a)


def rows_agree(name: str, got: list, want: list, what: str) -> None:
    """Row for row: strings and ints exact, floats within SUM_RTOL."""
    import numpy as np
    require(len(got) == len(want),
            f"{name}: {len(got)} rows vs {len(want)} ({what})")
    for g, w in zip(got, want):
        ok = len(g) == len(w) and all(
            np.isclose(x, y, rtol=SUM_RTOL, atol=0)
            if isinstance(x, float) and isinstance(y, float) else x == y
            for x, y in zip(g, w))
        require(ok, f"{name}: {g} vs {w} ({what})")


def profile_rows(prof) -> list:
    return [(o.index, o.label, o.rows, o.rows_peak) for o in prof.ops]


def service_path(db, spec, dev, exec_ms: dict | None = None,
                 total: int = 64, counters: dict | None = None) -> dict:
    """Phase 6: the serving tier on ``db``. One service holds the tables
    at a time: the plain-route service runs first and is freed, then
    the kernel-route service, the workload service and the regrowth
    service in turn. ``exec_ms``: phase 3's warm ms per query, printed
    beside the service's; ``counters``: the query kernels' wrappers,
    whose launches during each query's cold and warm runs go into its
    ``service`` line."""
    import torch
    from repro_torch.core import ExecConfig, QueryService, compile_query
    from repro_torch.core.queries import ALL
    from repro_torch.core.workload import (DEFAULT_TENANTS,
                                           make_tenant_traffic, make_workload)
    want = reference_results(spec)
    on_cuda = dev.type == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize(dev)

    # the plain routes: raw dicts and Q8's operator rows
    plain_cfg = ExecConfig(use_kernel_join=False, use_kernel_segments=False)
    svc = QueryService(db, plain_cfg, device=dev)
    plain = {name: svc.execute(text).raw for name, text in ALL.items()}
    plain_prof = profile_rows(svc.explain(ALL["Q8"], profile=True))
    del svc
    release(dev)

    # the kernel routes: Q1-Q12 cold and warm
    svc = QueryService(db, device=dev)
    records, results = [], {}
    for name, text in ALL.items():
        if on_cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        before = svc.stats.snapshot()
        launched = {k: w.launches for k, w in (counters or {}).items()}
        sync()
        t0 = time.perf_counter()
        svc.execute(text)
        cold_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        rs = svc.execute(text)
        warm_ms = (time.perf_counter() - t0) * 1e3
        d = svc.stats.diff(before)
        pq = svc.prepare(text)
        require(not rs.overflow, f"{name}: the service returned an overflow")
        raw_agree(name, pq.plan, rs.raw, plain[name])
        rows = rs.rows()
        check_reference(name, rows, want[name])
        results[name] = rows
        cfg = svc._good_cfg[pq.signature]
        rec = {"query": name, "rows": len(rows), "cold_ms": cold_ms,
               "warm_ms": warm_ms, "retries": d.retries,
               "compiles": d.compiles,
               "peak_mib": (torch.cuda.max_memory_allocated(dev) / 2**20
                            if on_cuda else 0.0),
               "host_bytes": host_bytes(rs.raw),
               "caps": {k: getattr(cfg, k) for k in
                        ("scan_cap", "join_cap", "group_cap", "topk_cap")},
               "launches": {k: w.launches - launched[k]
                            for k, w in (counters or {}).items()}}
        if exec_ms is not None:
            rec["executor_warm_ms"] = exec_ms[name]
        log("service " + json.dumps(rec))
        records.append(rec)
    if exec_ms is not None:
        q6 = next(r for r in records if r["query"] == "Q6")
        log(f"service Q6 warm {q6['warm_ms']:.3f} ms through the service, "
            f"{exec_ms['Q6']:.3f} ms through the bare executor (phase 3); "
            f"{q6['host_bytes']} bytes to the host")
    kernel_prof = profile_rows(svc.explain(ALL["Q8"], profile=True))
    require(kernel_prof == plain_prof and any(r[2] for r in kernel_prof),
            f"Q8 operator rows differ between routes: {kernel_prof} vs "
            f"{plain_prof}")
    log(f"service explain Q8 profile: {len(kernel_prof)} operators, the "
        "same rows on both routes")

    # the admission runtime: multi-tenant traffic, each ticket equal to
    # a direct execute
    stations = [spec.station_id(i) for i in range(spec.num_stations)]
    years = sorted({y for y, _, _ in spec.dates()})
    traffic = make_tenant_traffic(DEFAULT_TENANTS, stations, years,
                                  total=total, seed=SEED)
    before = svc.stats.snapshot()
    t0 = time.perf_counter()
    for at, tenant, template, text in traffic:
        svc.submit(text, tenant=tenant, at=at, template=template)
    tickets = svc.drain()
    drain_s = time.perf_counter() - t0
    d = svc.stats.diff(before)
    require(len(tickets) == len(traffic), "the runtime lost tickets")
    for t, (_, _, template, text) in zip(tickets, traffic):
        require(t.error is None, f"runtime {template}: {t.error!r}")
        require(raw_identical(t.result.raw, svc.execute(text).raw),
                f"runtime {template}: the ticket differs from execute")
    log("service runtime " + json.dumps(
        {"requests": len(traffic), "drain_s": drain_s,
         "batches": d.batches, "batched_requests": d.batched_requests,
         "compiles": d.compiles, "tenants": sorted({t.tenant
                                                    for t in tickets})}))
    del svc, tickets
    release(dev)

    # prepared constant-variants: one compile per template, each equal to
    # the executor's run of its baked plan; then the same requests batched
    wl = make_workload(stations, years, total=total)
    texts = [text for _, text in wl]
    templates = {t for t, _ in wl}
    svc = QueryService(db, device=dev)
    t0 = time.perf_counter()
    singles = [svc.execute(text) for text in texts]
    exec_s = time.perf_counter() - t0
    compiles = svc.stats.compiles
    require(compiles == len(templates),
            f"{compiles} compiles for {len(templates)} templates")
    for (template, text), rs in zip(wl, singles):
        pq = svc.prepare(text)
        require(not rs.overflow, f"{template}: overflow")
        raw_agree(template, pq.plan, rs.raw, svc.executor.run(
            compile_query(text), config=svc._good_cfg[pq.signature]).raw)
    before = svc.stats.snapshot()
    t0 = time.perf_counter()
    batched = svc.execute_batch(texts)
    batch_s = time.perf_counter() - t0
    d = svc.stats.diff(before)
    require(d.batches == len(templates),
            f"{d.batches} batches for {len(templates)} templates")
    for (template, _), a, b in zip(wl, singles, batched):
        require(raw_identical(a.raw, b.raw),
                f"{template}: execute_batch differs from execute")
    workload = {"requests": len(wl), "templates": len(templates),
                "compiles": compiles, "execute_s": exec_s,
                "batch_s": batch_s, "batches": d.batches,
                "batch_compiles": d.compiles}
    log("service workload " + json.dumps(workload))
    del svc, singles, batched
    release(dev)

    # regrowth from caps of 1
    svc = QueryService(db, ExecConfig(**TINY_CAPS), presize=False,
                       max_retries=TINY_RETRIES, device=dev)
    regrowth = {}
    for name in ("Q8", "Q10", "Q11"):
        before = svc.stats.snapshot()
        rs = svc.execute(ALL[name])
        require(not rs.overflow, f"{name}: overflow after regrowth")
        rows_agree(name, rs.rows(), results[name], "regrown vs presized")
        cfg = svc._good_cfg[svc.prepare(ALL[name]).signature]
        regrowth[name] = {"retries": svc.stats.diff(before).retries,
                          "caps": {k: getattr(cfg, k) for k in (
                              "scan_cap", "join_cap", "group_cap",
                              "topk_cap", "join_bucket")}}
    log("service regrowth " + json.dumps(regrowth))
    del svc
    release(dev)
    restart = restart_path(db, dev)
    return {"queries": records, "workload": workload, "regrowth": regrowth,
            "restart": restart}


def restart_path(db, dev) -> dict:
    """Phase 6's restart: a service on a persistent plan cache runs
    Q1–Q12 (each compile stores an entry); a second service on the same
    directory runs them again with no compile, twelve disk loads, and
    the same raw dicts bit for bit."""
    import tempfile
    from repro_torch.core import QueryService
    from repro_torch.core.queries import ALL
    with tempfile.TemporaryDirectory(prefix="plan-cache-") as d:
        # the build (its table upload) and the queries timed apart
        t0 = time.perf_counter()
        svc = QueryService(db, persist_dir=d, device=dev)
        t1 = time.perf_counter()
        first = {name: svc.execute(text).raw for name, text in ALL.items()}
        first_build_s, first_s = t1 - t0, time.perf_counter() - t1
        stores = svc.stats.persist_stores
        del svc
        release(dev)
        t0 = time.perf_counter()
        svc = QueryService(db, persist_dir=d, device=dev)
        t1 = time.perf_counter()
        again = {name: svc.execute(text).raw for name, text in ALL.items()}
        restart_build_s, restart_s = t1 - t0, time.perf_counter() - t1
        st = svc.stats
        require(stores == len(ALL), f"{stores} entries stored for "
                f"{len(ALL)} queries")
        require((st.compiles, svc.executor.compile_count, st.persist_hits,
                 st.persist_invalidations) == (0, 0, len(ALL), 0),
                f"restart: {st.compiles} compiles, "
                f"{svc.executor.compile_count} executor compiles, "
                f"{st.persist_hits} persist hits, "
                f"{st.persist_invalidations} invalidations")
        for name in ALL:
            require(raw_identical(again[name], first[name]),
                    f"{name}: the restarted service's result differs")
        info = svc.persist_info()
        out = {"queries": len(ALL), "stores": stores, "compiles":
               st.compiles, "persist_hits": st.persist_hits,
               "entries": info.entries, "bytes": info.bytes,
               "first_build_s": first_build_s, "first_queries_s": first_s,
               "restart_build_s": restart_build_s,
               "restart_queries_s": restart_s}
        del svc, first, again
        release(dev)
    log("service restart " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 7: spmd over a process group
# ---------------------------------------------------------------------------

def free_port() -> int:
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spmd_path(spec, dev, backend: str, counters: dict | None = None,
              exec_ms: dict | None = None, capture=None) -> dict:
    """Phase 7: the database at ``spec`` with P = 1, Q1–Q12 in spmd mode
    over an in-process process group of one rank (``backend``: NCCL on
    the card, gloo in the CPU rehearsal) through
    ``Executor.run(mode="spmd")`` with presized caps, on the kernel route
    (cold, warm) and the plain route, both join strategies for Q5–Q8,
    then through ``QueryService(mode="spmd")`` cold and warm. Every
    result must agree with ``reference_results``, the routes with each
    other, and afterwards each raw dict with sim mode's on the same
    database. ``counters``: the query kernels' wrappers, set to 0 before
    the spmd runs and read after them (the sim comparison comes later);
    ``exec_ms``: phase 3's warm ms per query, printed beside;
    ``capture``: a ``Capture`` that sees the kernel route's warm spmd
    runs (the kernels' P = 1 inputs)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import (ExecConfig, Executor, QueryService,
                                  compile_query)
    from repro_torch.core.presize import presized_config
    from repro_torch.core.queries import ALL, JOINS
    from repro_torch.data.weather import build_database
    from repro_torch.launch.mesh import make_data_mesh
    on_cuda = dev.type == "cuda"
    want = reference_results(spec)

    def sync():
        if on_cuda:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    db = build_database(spec, 1)
    log(f"spmd data P=1: ingest {time.perf_counter() - t0:.1f} s")
    for w in (counters or {}).values():
        w.launches = 0
    dist.init_process_group(backend, init_method="tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_data_mesh(dev)
        ex = Executor(db, device=dev)
        t0 = time.perf_counter()
        ex.partition_tables(0)
        sync()
        log(f"spmd rank 0 of {mesh.size()} ({dist.get_backend()}): upload "
            f"{time.perf_counter() - t0:.1f} s, "
            f"{(torch.cuda.memory_allocated(dev) / 2**30) if on_cuda else 0:.3f}"
            " GiB on the card")
        records, kept = {}, {}
        for strategy in ("broadcast", "repartition"):
            for name, text in ALL.items():
                if strategy == "repartition" and name not in JOINS:
                    continue
                plan = compile_query(text)
                cfg = presized_config(db, plan,
                                      ExecConfig(join_strategy=strategy))
                plain = dataclasses.replace(cfg, use_kernel_join=False,
                                            use_kernel_segments=False)
                if on_cuda:
                    torch.cuda.reset_peak_memory_stats(dev)
                _, _, cold_ms = run_query(ex, plan, cfg, "spmd", mesh)
                g0 = ex.gathered_bytes
                with capture if capture is not None \
                        else contextlib.nullcontext():
                    raw, rs, warm_ms = run_query(ex, plan, cfg, "spmd", mesh)
                gathered = ex.gathered_bytes - g0
                peak = (torch.cuda.max_memory_allocated(dev) / 2**20
                        if on_cuda else 0.0)
                praw, _, plain_ms = run_query(ex, plan, plain, "spmd", mesh)
                require(not rs.overflow,
                        f"spmd {name}: overflow at presized caps {cfg}")
                raw_agree(f"spmd {name} {strategy}", plan, raw, praw)
                rows = rs.rows()
                check_reference(name, rows, want[name])
                kept[strategy, name] = (plan, cfg, raw)
                if strategy == "repartition":
                    records[name]["repartition_warm_ms"] = warm_ms
                    continue
                records[name] = {
                    "query": name, "rows": len(rows), "cold_ms": cold_ms,
                    "warm_ms": warm_ms, "plain_warm_ms": plain_ms,
                    "peak_mib": peak, "host_bytes": host_bytes(raw),
                    "gathered_bytes": gathered}
        del ex
        release(dev)
        svc = QueryService(db, mode="spmd", mesh=mesh, device=dev)
        served = {}
        for name, text in ALL.items():
            sync()
            t0 = time.perf_counter()
            svc.execute(text)
            cold_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            rs = svc.execute(text)
            warm_ms = (time.perf_counter() - t0) * 1e3
            require(not rs.overflow, f"spmd service {name}: overflow")
            check_reference(name, rs.rows(), want[name])
            # held against sim mode at the service's own config below
            served[name] = (compile_query(text),
                            svc._good_cfg[svc.prepare(text).signature],
                            rs.raw)
            records[name].update(service_cold_ms=cold_ms,
                                 service_warm_ms=warm_ms)
        compiles = svc.stats.compiles
        del svc
        release(dev)
        launches = {k: w.launches for k, w in (counters or {}).items()}
        # afterwards, not counted: sim mode on the same database
        ex = Executor(db, device=dev)
        for (strategy, name), (plan, cfg, raw) in kept.items():
            sraw, _, _ = run_query(ex, plan, cfg)
            raw_agree(f"{name} {strategy} spmd vs sim", plan, raw, sraw)
        for name, (plan, cfg, raw) in served.items():
            sraw, _, _ = run_query(ex, plan, cfg)
            raw_agree(f"{name} spmd service vs sim", plan, raw, sraw)
        del ex
        release(dev)
    finally:
        dist.destroy_process_group()
    for name, rec in records.items():
        if exec_ms is not None:
            rec["phase3_warm_ms"] = exec_ms[name]
        log("spmd " + json.dumps(rec))
    out = {"queries": list(records.values()), "launches": launches,
           "service_compiles": compiles}
    log("spmd path " + json.dumps({"launches": launches,
                                   "service_compiles": compiles}))
    return out


# ---------------------------------------------------------------------------
# phase 8: the MRQL-like baseline
# ---------------------------------------------------------------------------

def mrql_path(db, spec, dev, service_ms: dict | None = None) -> list:
    """Phase 8: Q1–Q12 through ``MrqlLike`` (map tasks one partition at a
    time on ``dev``, every job boundary on the host, joins and grouping
    in host reducers) on ``db``; rows must agree with
    ``reference_results``. ``service_ms``: the service's warm ms per
    query (phase 6), printed beside: the paper's §5.3.2 comparison on
    one card, with no claim."""
    import torch
    from repro_torch.core import compile_query
    from repro_torch.core.baselines import MrqlLike
    from repro_torch.core.queries import ALL
    want = reference_results(spec)
    mr = MrqlLike(db, device=dev)
    t0 = time.perf_counter()
    for part in range(mr.ex.num_partitions):     # outside the query times
        mr.ex.partition_tables(part)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    log(f"mrql tables of {mr.ex.num_partitions} partitions uploaded in "
        f"{time.perf_counter() - t0:.1f} s")
    records = []
    for name, text in ALL.items():
        plan = compile_query(text)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = mr.run(plan)
        ms = (time.perf_counter() - t0) * 1e3
        require(not res.overflow, f"mrql {name}: overflow")
        check_reference(name, res.rows(), want[name])
        rec = {"query": name, "rows": len(res.rows()), "ms": ms,
               "jobs": res.jobs}
        if service_ms is not None:
            rec["service_warm_ms"] = service_ms[name]
            rec["mrql_over_service"] = ms / service_ms[name]
        log("mrql " + json.dumps(rec))
        records.append(rec)
    del mr
    release(dev)
    return records


# ---------------------------------------------------------------------------
# phase 4: the kernels at the main path's shapes
# ---------------------------------------------------------------------------

def _ordered_u32(k):
    """Order-preserving unsigned bits of an int32/float32 key, int64."""
    import torch
    if k.dtype == torch.float32:
        b = (k + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        return torch.where(b >= 2**31, b ^ 0xFFFFFFFF, b | 2**31)
    return (k.to(torch.int64) + 2**31)


def topk_library(keys, cap):
    """One stable torch.sort over the keys packed into an int64 — the
    same selection when this run's key ranges fit in 63 bits, else
    None."""
    import torch
    parts = []
    for k in keys:
        u = _ordered_u32(k)
        lo, hi = int(u.min()), int(u.max())
        parts.append((u - lo, max(1, (hi - lo).bit_length())))
    if sum(b for _, b in parts) > 63:
        return None
    packed = torch.zeros_like(parts[0][0])
    for u, bits in parts:
        packed = (packed << bits) | u

    def fn():
        return torch.sort(packed, dim=1, stable=True)[1][:, :cap]

    return fn


def agg_library(vals, ok, segs, valid, s):
    """scatter_reduce over the flat [P * S + 1] slots: one sum over
    [count | values], one amin, one amax."""
    import torch
    p, n, nc = vals.shape
    keep = valid & (segs >= 0) & (segs < s)
    slot = torch.where(keep, torch.arange(p, device=vals.device)[:, None] * s
                       + segs, torch.full_like(segs, p * s)).long()
    okm = ok & keep[:, :, None]
    src = torch.cat([keep[:, :, None].float(),
                     torch.where(okm, vals, 0.0)], 2).reshape(p * n, nc + 1)
    lo = torch.where(okm, vals, float("inf")).reshape(p * n, nc)
    hi = torch.where(okm, vals, float("-inf")).reshape(p * n, nc)
    idx1 = slot.reshape(-1, 1).expand(-1, nc + 1)
    idx = slot.reshape(-1, 1).expand(-1, nc)

    def fn():
        a = torch.zeros(p * s + 1, nc + 1, device=vals.device)
        a.scatter_reduce_(0, idx1, src, "sum")
        b = torch.full((p * s + 1, nc), float("inf"), device=vals.device)
        b.scatter_reduce_(0, idx, lo, "amin")
        c = torch.full((p * s + 1, nc), float("-inf"), device=vals.device)
        c.scatter_reduce_(0, idx, hi, "amax")
        return a, b, c

    return fn


def kernel_record(name: str, launches: dict, err: float, run, plain, lib,
                  nbytes: float, flops: float, dtype: str, shape: dict,
                  where: str = "main-path shape",
                  library: str | None = None,
                  kernel: str | None = None) -> dict:
    """Time one kernel beside its plain version and library call; the
    bound is the larger of bytes over the memory rate and operations
    over the peak rate of the input type. ``library``: the name of the
    library call, where the record states it; ``kernel``: the registry
    entry whose mode ``name`` is (its source and Pallas kernel)."""
    from repro_torch.kernels.registry import KERNELS
    entry = KERNELS[kernel or name]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    rec = {"name": name, "route": "cuda", "source": entry["source"],
           "replaces": entry["replaces"], "launches": launches[name],
           "max_abs_err": err, "ms": cuda_ms(run), "plain_ms": cuda_ms(plain),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "operations" if t_ops > t_bytes else "bytes",
           "library_ms": cuda_ms(lib) if lib is not None else None,
           "where": where}
    if library is not None:
        rec["library"] = library
    log(f"kernel {name} at {where} {json.dumps(shape)}: " + json.dumps(rec))
    return rec


def sum_count_library(vals, segs, valid, s):
    """One index_add_ of [value, 1] rows into the flat [P * S + 1]
    slots (the last collects dropped rows)."""
    import torch
    p, n = vals.shape
    keep = valid & (segs >= 0) & (segs < s)
    slot = torch.where(keep, torch.arange(p, device=vals.device)[:, None] * s
                       + segs, torch.full_like(segs, p * s)).long().reshape(-1)
    src = torch.stack([torch.where(keep, vals, 0.0), keep.float()],
                      2).reshape(p * n, 2)

    def fn():
        return torch.zeros(p * s + 1, 2, device=vals.device).index_add_(
            0, slot, src)

    return fn


def agg_record(args, launches: dict, edge_errs: dict,
               where: str = "main-path shape") -> dict:
    """``segmented_aggregate`` on one main-path input. The bound counts
    the bytes the work needs: every valid flag, the valid rows' segment
    ids, values and ok flags, and the outputs; the shape record keeps
    the earlier bound (every input read once) as ``bound_all_inputs_ms``
    and the share of valid rows."""
    from repro_torch.kernels import ref, seg_aggregate
    vals, ok, segs, valid, s = args
    err = check_agg(args)
    p, n, nc = vals.shape
    nvalid = int(valid.sum())
    out_bytes = p * s * 4 * (1 + 3 * nc)
    nbytes = valid.numel() + nvalid * (4 + 5 * nc) + out_bytes
    every = vals.numel() * 4 + ok.numel() + segs.numel() * 4 \
        + valid.numel() + out_bytes
    shape = {"P": p, "N": n, "S": s, "C": nc,
             "valid_share": nvalid / max(valid.numel(), 1),
             "bound_all_inputs_ms": every / HBM_BYTES_PER_S * 1e3}
    return kernel_record(
        "segmented_aggregate", launches,
        max(err, edge_errs["segmented_aggregate"]),
        lambda: seg_aggregate.segmented_aggregate(*args),
        lambda: ref.segmented_aggregate(*args), agg_library(*args), nbytes,
        0.0, "float32", shape, where)


def main_shape_timings(best: dict, agg_calls: list, launches: dict,
                       edge_errs: dict, where: str = "main-path shape"
                       ) -> list:
    """Phase 4: each executor kernel on the largest input the query path
    gave it (``segmented_sum_count``: the first value column of the
    largest aggregate input, rows not ``ok`` invalid): parity with the
    plain version, device times, and the bound. ``segmented_aggregate``
    also on the input with the most valid rows (logged; the returned
    record is the largest input's)."""
    from repro_torch.kernels import hash_join, ref, seg_aggregate, seg_topk
    require(agg_calls, "the query path never reached segmented_aggregate")
    dense = max(agg_calls, key=lambda a: (int(a[3].sum()), a[0].shape[2]))
    out = []
    for name in ("block_join_probe", "segmented_aggregate", "segment_topk",
                 "segmented_sum_count"):
        src = "segmented_aggregate" if name == "segmented_sum_count" else name
        require(src in best, f"the query path never reached {src}")
        args = best[src][1]
        lib = None
        if name == "segmented_aggregate":
            log(f"kernel segmented_aggregate at the densest input ({where}):")
            agg_record(dense, launches, edge_errs, where)
            log(f"kernel segmented_aggregate at the largest input ({where}):")
            out.append(agg_record(args, launches, edge_errs, where))
            continue
        if name == "block_join_probe":
            bk, bv, pk, pv = args
            err = check_join((tuple(bk), bv, tuple(pk), pv))

            def run():
                return hash_join.block_join_probe(tuple(bk), bv, tuple(pk),
                                                  pv)

            def plain():
                return ref.block_join_probe(tuple(bk), bv, tuple(pk), pv)

            # each key read once, positions and flags written once
            nbytes = sum(k.numel() * 4 for k in bk + pk) + bv.numel() \
                + pv.numel() + pv.numel() * 5
            shape = {"P": pv.shape[0], "NP": pv.shape[1], "NB": bv.shape[1],
                     "keys": len(bk)}
        elif name == "segment_topk":
            keys, cap = args
            err = check_topk(keys, cap)

            def run():
                return seg_topk.segment_topk(keys, cap)

            def plain():
                return ref.segment_topk(keys, cap)

            lib = topk_library(keys, cap)
            nbytes = sum(k.numel() * 4 for k in keys) \
                + keys[0].shape[0] * cap * 4
            shape = {"P": keys[0].shape[0], "N": keys[0].shape[1],
                     "keys": len(keys), "cap": cap}
        else:
            vals3, ok, segs, valid, s = args
            sc = (vals3[:, :, 0].contiguous(), segs,
                  (valid & ok[:, :, 0]).contiguous(), s)
            err = check_sum_count(*sc)

            def run():
                return seg_aggregate.segmented_sum_count(*sc)

            def plain():
                return ref.segmented_sum_count(*sc)

            lib = sum_count_library(*sc)
            p, n = sc[0].shape
            nvalid = int(sc[2].sum())
            # the flags, the valid rows' ids and values, the outputs
            nbytes = p * n + nvalid * 8 + p * s * 8
            shape = {"P": p, "N": n, "S": s,
                     "valid_share": nvalid / max(p * n, 1),
                     "bound_all_inputs_ms":
                         (p * n * 9 + p * s * 8) / HBM_BYTES_PER_S * 1e3}
        out.append(kernel_record(name, launches, max(err, edge_errs[name]),
                                 run, plain, lib, nbytes, 0.0, "float32",
                                 shape, where))
    return out


# ---------------------------------------------------------------------------
# phase 5: the LM serving path
# ---------------------------------------------------------------------------

class LastCall:
    """Wraps the attention entry points of ``kernels.ops`` and keeps, in
    ``by_window`` keyed (name, window), the arguments of each one's last
    call with each ``window``: the inputs of the last layer of the
    prefill and of the last (longest) decode step, and where a model's
    last layer is global (gemma2, gemma3) its last windowed layer's too."""

    NAMES = ("flash_attention", "decode_attention")

    def __init__(self, ops):
        self.ops = ops
        self.saved = {}
        self.by_window: dict[tuple, tuple] = {}

    def __enter__(self):
        for name in self.NAMES:
            fn = getattr(self.ops, name)
            self.saved[name] = fn

            def wrapped(*args, _fn=fn, _name=name, **kw):
                self.by_window[_name, kw.get("window")] = (args, kw)
                return _fn(*args, **kw)

            setattr(self.ops, name, wrapped)
        return self

    def __exit__(self, *exc):
        for attr, fn in self.saved.items():
            setattr(self.ops, attr, fn)


def serve_kernel_runs(arch: str, cfg, dev, kw: dict, counters: dict | None,
                      capture, tag: str = "lm", info: dict | None = None
                      ) -> dict:
    """``serve_batch`` of ``arch`` cold and warm on the kernel route:
    {"cold"/"warm": (record, output, launches by window), "routes": the
    warm serve's ``RouteLog`` ids of a MoE model, else None}; the tokens
    of both serves, and a MoE model's expert ids, must be equal.
    ``counters``: the kernel wrappers
    by name; the flash and decode ones are set to 0 before each serve and
    read after it (flash once
    per attention layer, decode once per attention layer per generated
    token; none on a model without attention); ``capture``: a context
    that sees the cold serve's kernel calls; ``info``: fields put first
    in each serve's record."""
    import torch
    from repro_torch.launch.serve import serve_batch
    n_attn = sum(cfg.layer_spec(i).mixer.startswith("attn")
                 for i in range(cfg.num_layers))
    gen_len = kw["gen_len"]
    if counters:
        counters = {k: counters[k] for k in ("flash_attention",
                                             "decode_attention")}
    runs = {}
    moe = cfg.num_experts > 0
    routes = RouteLog() if moe else contextlib.nullcontext()
    for label in ("cold", "warm"):
        for w in (counters or {}).values():
            w.launches = 0
            w.by_window.clear()
        reset_peak(dev)
        with routes, capture if capture is not None and label == "cold" \
                else contextlib.nullcontext():
            out = serve_batch(arch, **kw)
        rec = {"arch": arch, **(info or {}), "route": "kernel", "run": label,
               "prefill_ms": out["prefill_s"] * 1e3,
               "decode_ms_per_token": out["decode_s"] * 1e3 / gen_len,
               "tok_per_s": out["tok_per_s"], "peak_mib": peak_mib(dev)}
        if counters:
            rec["launches"] = {k: w.launches for k, w in counters.items()}
            want = {"flash_attention": n_attn,
                    "decode_attention": n_attn * gen_len}
            require(rec["launches"] == want, f"{tag} {label} serve launched "
                    f"{rec['launches']}, want {want}")
            by = {k: dict(w.by_window) for k, w in counters.items()}
            want = window_launches(cfg, gen_len)
            require(by == want, f"{tag} {label} serve launched by window "
                    f"{by}, want {want}")
            rec["launches_by_window"] = {
                k: {str(w): n for w, n in v.items()} for k, v in by.items()}
            runs[label] = (rec, out, by)
        else:
            runs[label] = (rec, out, None)
        log(f"{tag} serve " + json.dumps(rec))
    require(bool((runs["cold"][1]["generated"]
                  == runs["warm"][1]["generated"]).all()),
            f"{tag}: the cold and warm serves generated otherwise")
    runs["routes"] = None
    if moe:
        half = len(routes.ids) // 2
        require(half > 0 and all(torch.equal(a, b) for a, b in zip(
            routes.ids[:half], routes.ids[half:])),
            f"{tag}: the cold and warm serves routed differently")
        runs["routes"] = routes.ids[half:]
    return runs


def window_launches(cfg, gen_len: int) -> dict:
    """{kernel: {window: launches}} a serve of ``cfg`` makes: the flash
    kernel once per attention layer of that window (``None``: global),
    the decode kernel once per such layer per generated token."""
    flash: dict = {}
    for i in range(cfg.num_layers):
        mixer = cfg.layer_spec(i).mixer
        if mixer.startswith("attn"):
            w = cfg.window if mixer == "attn_local" else None
            flash[w] = flash.get(w, 0) + 1
    return {"flash_attention": flash,
            "decode_attention": {w: n * gen_len for w, n in flash.items()}}


class RouteLog:
    """Records the expert ids of every ``models.moe.route`` call (one a
    MoE layer per prefill or decode step), by standing in for it."""

    def __init__(self):
        from repro_torch.models import moe
        self.mod = moe
        self.ids: list = []

    def __enter__(self):
        self.saved = self.mod.route

        def logged(*a, **k):
            r = self.saved(*a, **k)
            self.ids.append(r["expert_ids"].detach().clone())
            return r

        self.mod.route = logged
        return self

    def __exit__(self, *exc):
        self.mod.route = self.saved


def route_share(a: list, b: list) -> float:
    """The share of (token, MoE layer) routing decisions whose expert
    sets differ between two runs of the same tokens."""
    import torch
    require(len(a) == len(b) and all(x.shape == y.shape
                                     for x, y in zip(a, b)),
            "the two runs routed different numbers of tokens")
    diff = sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
               for x, y in zip(a, b))
    return diff / max(sum(x.shape[0] for x in a), 1)


class _TorchWith:
    """The ``torch`` module with some of its names replaced
    (``RouteReplay``)."""

    def __init__(self, **names):
        self.names = names

    def __getattr__(self, name):
        import torch
        return self.names[name] if name in self.names else getattr(torch,
                                                                   name)


class RouteReplay:
    """Stands in for ``models.moe.route`` on the plain route of a float32
    gate: its n-th call routes to the expert ids of the n-th call that a
    ``RouteLog`` of the kernel route recorded, with its own router
    probabilities at those ids as the gates; the capacity, each
    assignment's rank within its expert, the dispatch and the aux loss
    stay the package's. ``moe.route`` reads its top k from a descending
    sort of the probabilities: for the call, the module's ``torch.sort``
    is one that puts the given ids first, in their order, and the other
    experts after them by probability. ``own``: the ids the call's own
    router chose, for the share of decisions that differ."""

    def __init__(self, ids: list):
        from repro_torch.models import moe
        self.mod, self.ids, self.own = moe, ids, []

    def __enter__(self):
        import torch
        self.saved = self.mod.route

        def replayed(*a, **k):
            require(len(self.own) < len(self.ids), "the plain route called "
                    "the router more often than the kernel route")
            top = self.ids[len(self.own)]

            def sort(probs, dim=-1, descending=False, stable=False):
                require(dim == -1 and descending
                        and probs.shape[0] == top.shape[0],
                        f"route replay: sort of {tuple(probs.shape)} "
                        f"along {dim}, want {top.shape[0]} rows descending")
                k = top.shape[1]
                own = torch.sort(probs, dim=-1, descending=True, stable=True)
                self.own.append(own.indices[:, :k])
                # keys above every probability (<= 1) at the given ids,
                # falling in their order
                key = probs.scatter(-1, top, torch.arange(
                    k + 1, 1, -1, dtype=probs.dtype,
                    device=probs.device).expand(top.shape))
                idx = torch.sort(key, dim=-1, descending=True,
                                 stable=True).indices
                return torch.return_types.sort((probs.gather(-1, idx), idx))

            self.mod.torch = _TorchWith(sort=sort)
            try:
                return self.saved(*a, **k)
            finally:
                self.mod.torch = torch

        self.mod.route = replayed
        return self

    def __exit__(self, *exc):
        self.mod.route = self.saved


def plain_route_check(arch: str, cfg, dev, kw: dict, kernel: dict,
                      logit_atol: float | None, tag: str = "lm",
                      routes: list | None = None,
                      replay: bool = False) -> dict:
    """``serve_batch`` on the plain route (dense attention), teacher-
    forced with the kernel route's tokens: each prefill and decode-step
    logit against the kernel route's ``kernel`` output, within
    ``logit_atol`` (printed only where it is None). ``routes``: the
    kernel run's ``RouteLog`` ids; the plain run's are logged too and
    the share of routing decisions that differ is reported. ``replay``:
    the plain run routes as the kernel run did (``RouteReplay``), and
    the share is of the decisions its own router would have made
    otherwise."""
    import torch
    from repro_torch.launch.serve import serve_batch
    requests, gen_len = kw["num_requests"], kw["gen_len"]
    reset_peak(dev)
    overrides = {**(kw.get("overrides") or {}), "attn_impl": "dense"}
    ctx = contextlib.nullcontext() if routes is None else \
        RouteReplay(routes) if replay else RouteLog()
    with ctx as plain_routes:
        plain = serve_batch(arch, **{**kw, "overrides": overrides},
                            force_tokens=kernel["generated"])
    prec = {"arch": arch, "route": "plain", "run": "teacher-forced",
            "prefill_ms": plain["prefill_s"] * 1e3,
            "decode_ms_per_token": plain["decode_s"] * 1e3 / gen_len,
            "tok_per_s": plain["tok_per_s"], "peak_mib": peak_mib(dev)}
    log(f"{tag} serve " + json.dumps(prec))
    errs = logit_errs(kernel, plain,
                      {"prefill_logits": (requests, 1, cfg.vocab_size),
                       "step_logits": (requests, gen_len, cfg.vocab_size)},
                      tag)
    if logit_atol is not None:
        require(max(errs.values()) <= logit_atol, f"{tag} kernel and plain "
                f"routes disagree: {errs} > {logit_atol}")
    same = float((torch.from_numpy(plain["generated"])
                  == torch.from_numpy(kernel["generated"])).float().mean())
    rec = {"logit_max_abs_err": errs, "logit_atol": logit_atol,
           "plain_argmax_agrees": same, "plain": prec}
    if replay:
        require(len(plain_routes.own) == len(routes), f"{tag}: the plain "
                f"route called the router {len(plain_routes.own)} times, "
                f"the kernel route {len(routes)}")
        rec["routes_replayed"] = True
    if routes is not None:
        rec["routing_decisions_differ"] = route_share(
            routes, plain_routes.own if replay else plain_routes.ids)
    return rec


@dataclasses.dataclass(frozen=True)
class Gate:
    """How a serve phase holds its kernel route to its plain route,
    teacher-forced: in bf16 at the serve's depth within ``atol``
    (``f32_layers`` None: phase 5), or in bf16 printed and in float32 at
    ``f32_layers`` layers of the same width within ``atol`` (phases 15
    and 16)."""
    atol: float
    f32_layers: int | None = None


def serve_phase(dev, arch: str, traffic: tuple, gate: Gate, *, tag: str,
                smoke: bool = False, overrides: dict | None = None,
                f64_tokens: int = MOE_WIDE_F64_TOKENS,
                counters: dict | None = None, capture=None) -> dict:
    """Phases 5, 15 and 16: ``arch`` (its config with ``overrides``, the
    depth among them) served with ``traffic`` (requests, prompt_len,
    gen_len): seeded weights drawn in the compute dtype layer by layer
    (``model.init_compute_params``: the float32 model is never whole on
    the card), the peak after init printed; ``serve_batch`` cold and
    warm on the kernel route (``serve_kernel_runs``: ``counters`` the
    flash and decode wrappers, counted by window; ``capture`` sees the
    cold serve), the tokens of both equal, and of a MoE model the expert
    ids of every routing decision (``RouteLog``); the plain route (dense
    attention) teacher-forced in bf16, gated by ``gate`` or printed with
    the share of argmax tokens and of routing decisions it agrees on;
    then, where ``gate`` asks, the gate in float32 at its depth, the
    plain route of a MoE model routed as the kernel route
    (``RouteReplay``); and of a MoE model one MoE layer of that float32
    model in float64 on the card against the CPU (``moe_f64_check``,
    ``f64_tokens`` rows)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import model
    requests, prompt_len, gen_len = traffic
    over = {**(overrides or {}), "attn_impl": kernel_impl(dev)}
    cfg = dataclasses.replace(
        get_smoke_config(arch) if smoke else get_config(arch), **over)
    moe = cfg.num_experts > 0
    for n in (cfg.num_layers, gate.f32_layers or cfg.period):
        require(n % cfg.period == 0, f"{arch}: {n} layers are no whole "
                f"periods of {cfg.period}")
    reset_peak(dev)
    t0 = time.perf_counter()
    params = model.init_compute_params(cfg, SEED, dev)
    device_sync(dev)
    init_s = time.perf_counter() - t0
    log_model(tag, arch, cfg, params, dev, t0)
    info = {"params": sum(t.numel() for t in model._leaves(params)),
            "layers": cfg.num_layers, "init_s": init_s,
            "init_peak_mib": peak_mib(dev), "requests": requests,
            "prompt_len": prompt_len}
    kw = dict(smoke=smoke, num_requests=requests, prompt_len=prompt_len,
              gen_len=gen_len, seed=SEED, device=dev, params=params,
              overrides=over)
    runs = serve_kernel_runs(arch, cfg, dev, kw, counters, capture,
                             tag=tag, info=info)
    kernel = runs["warm"][1]
    bf16 = plain_route_check(arch, cfg, dev, kw, kernel,
                             None if gate.f32_layers else gate.atol,
                             tag=f"{tag} bf16" if gate.f32_layers else tag,
                             routes=runs["routes"])
    out = {"arch": arch, "cfg": cfg, **info, "warm": runs["warm"][0],
           "cold": runs["cold"][0], "by_window": runs["warm"][2],
           "cold_warm_tokens_equal": True,
           "generated_shape": list(kernel["generated"].shape),
           "bfloat16": bf16, "float32": None, "float64": None}
    del params, kw, runs, kernel
    release(dev)
    keys = ("logit_max_abs_err", "logit_atol", "plain_argmax_agrees",
            "routing_decisions_differ")
    check = {k: out[k] for k in ("cold_warm_tokens_equal",
                                 "generated_shape")}
    check["bfloat16"] = {k: bf16[k] for k in keys if k in bf16}
    if gate.f32_layers:
        o32 = {**over, "num_layers": gate.f32_layers,
               "compute_dtype": "float32"}
        c32 = dataclasses.replace(cfg, **o32)
        kw32 = dict(smoke=smoke, num_requests=requests,
                    prompt_len=prompt_len, gen_len=gen_len, seed=SEED,
                    device=dev,
                    params=model.init_compute_params(c32, SEED, dev),
                    overrides=o32)
        reset_peak(dev)
        with RouteLog() if moe else contextlib.nullcontext() as r32:
            k32 = serve_batch(arch, **kw32)
        f32 = plain_route_check(arch, c32, dev, kw32, k32, gate.atol,
                                tag=f"{tag} f32",
                                routes=r32.ids if moe else None,
                                replay=moe)
        out["float32"] = f32
        check["float32"] = {"layers": gate.f32_layers,
                            **{k: f32[k] for k in keys if k in f32}}
        if moe:
            # one MoE layer's float32 weights kept, the rest freed first
            first = next(i for i in range(c32.num_layers)
                         if c32.layer_spec(i).mlp == "moe")
            layer = kw32["params"]["layers"][first]["moe"]
        del kw32, k32, r32
        release(dev)
        if moe:
            out["float64"] = moe_f64_check(c32, layer, dev, f64_tokens,
                                           layer=first)
            del layer
            release(dev)
    log(f"{tag} check " + json.dumps(check))
    return out


def lm_path(dev, *, smoke: bool = False, requests: int = LM_REQUESTS,
            prompt_len: int = LM_PROMPT, gen_len: int = LM_GEN,
            counters: dict | None = None, capture=None) -> dict:
    """Phase 5: LM_ARCH through ``serve_phase``, the gate in bf16 at full
    depth within LOGIT_ATOL; the bf16 check's keys also at the top."""
    out = serve_phase(dev, LM_ARCH, (requests, prompt_len, gen_len),
                      Gate(LOGIT_ATOL), tag="lm", smoke=smoke,
                      counters=counters, capture=capture)
    return {**out["bfloat16"], **out}


def log_model(tag: str, arch: str, cfg, params, dev, t0: float) -> None:
    from repro_torch.models import model
    n_params = sum(t.numel() for t in model._leaves(params))
    log(f"{tag} {arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"heads {cfg.num_heads}/{cfg.num_kv_heads}, head_dim {cfg.head_dim}, "
        f"experts {cfg.num_experts} top-{cfg.top_k}, ssm state "
        f"{cfg.ssm_state}, vocab {cfg.vocab_size}: {n_params} params "
        f"initialised on {dev} in {time.perf_counter() - t0:.1f} s")


def init_model(tag: str, arch: str, dev, smoke: bool):
    """(config, seeded params on ``dev``), logged."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import model
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    t0 = time.perf_counter()
    params = model.init_params(cfg, SEED, dev)
    device_sync(dev)
    log_model(tag, arch, cfg, params, dev, t0)
    return cfg, params


def peak_mib(dev) -> float:
    import torch
    return (torch.cuda.max_memory_allocated(dev) / 2**20
            if dev.type == "cuda" else 0.0)


def reset_peak(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def device_sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def kernel_impl(dev) -> str:
    """The kernel route's ``attn_impl``: "auto" is the kernel on CUDA; on
    the CPU (the rehearsal) name it."""
    return "auto" if dev.type == "cuda" else "kernel"


def logit_errs(a: dict, b: dict, shapes: dict, tag: str) -> dict:
    """Largest |a - b| of each logits key, after shape and finiteness
    checks."""
    import torch
    errs = {}
    for key, shape in shapes.items():
        x, y = a[key], b[key]
        require(tuple(x.shape) == shape and tuple(y.shape) == shape,
                f"{tag} {key}: shapes {tuple(x.shape)}, {tuple(y.shape)}, "
                f"want {shape}")
        require(bool(torch.isfinite(x).all() & torch.isfinite(y).all()),
                f"{tag} {key}: non-finite logits")
        errs[key] = float((x - y).abs().max())
    return errs


def live_mask(sq: int, sk: int, causal: bool, window, device=None):
    """(Sq, Sk) bool: the (query, key) pairs a causal/windowed mask
    keeps."""
    import torch
    qp = torch.arange(sq, device=device)[:, None]
    kp = torch.arange(sk, device=device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    return ok


def live_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs a causal/windowed mask keeps."""
    return int(live_mask(sq, sk, causal, window).sum())


def lm_kernel_timings(last: LastCall, launches: dict, edge_errs: dict,
                      where: str = "main-path shape") -> list:
    """The attention kernels on the inputs a serve with no window gave
    them (``last.by_window``: the last prefill layer's q/k/v; the last
    decode step's q and caches)."""
    names = LastCall.NAMES
    require(set(last.by_window) == {(n, None) for n in names},
            f"the LM path called the attention kernels as "
            f"{sorted(last.by_window, key=str)}")
    return [flash_serve_record(last.by_window[names[0], None], launches,
                               edge_errs, where),
            decode_record(last.by_window[names[1], None], launches,
                          edge_errs, where)]


_FLEX: list = []


def flex_call(q, k, v, mask_mod, batch, softcap, scale,
              return_lse: bool = False):
    """One ``flex_attention`` call on (B, H, S, D) q, k, v: the block
    mask of ``mask_mod(b, h, q_idx, kv_idx)`` (made here, outside the
    call, as SDPA's boolean mask is), GQA by ``enable_gqa``, and where a
    softcap is on the score_mod cap * tanh(s / cap) on the scaled score.
    On the card the call is compiled, as flex_attention's own docs ask
    (eager, it runs a math reference that materialises the scores);
    on the CPU it runs eager."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    bm = create_block_mask(mask_mod, batch, None, q.shape[2], k.shape[2],
                           device=q.device)
    cap = softcap

    def capped(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    fa = flex_attention
    if q.is_cuda:
        if not _FLEX:
            # each shape and mask of the script compiles once: more than
            # dynamo's default limit of 8, past which flex runs eager
            torch._dynamo.config.recompile_limit = 64
            _FLEX.append(torch.compile(flex_attention, dynamic=False))
        fa = _FLEX[0]

    def lib():
        return fa(q, k, v, score_mod=capped if cap else None,
                  block_mask=bm, scale=scale, enable_gqa=True,
                  return_lse=return_lse)
    return lib


def attention_library(q, k, v, causal: bool, window, softcap,
                      scale) -> tuple:
    """(one PyTorch call that computes what the flash kernel computes on
    (B, H, S, D) q, k, v; its name): ``scaled_dot_product_attention``
    where neither a window nor a softcap is on, else ``flex_call`` with
    the causal window as its block mask."""
    import torch.nn.functional as F
    if window is None and softcap is None:
        def lib():
            return F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True, scale=scale)
        return lib, "scaled_dot_product_attention"

    def live(b, h, qi, ki):
        ok = qi >= ki if causal else qi >= 0
        return ok & (ki > qi - window) if window is not None else ok
    return flex_call(q, k, v, live, None, softcap, scale), "flex_attention"


def flash_library(call) -> tuple:
    """``attention_library`` on one ``ops.flash_attention`` call's
    (B, S, H, D) q, k, v, as (B, H, S, D) views."""
    (q, k, v), kw = call
    return attention_library(
        *(x.transpose(1, 2) for x in (q, k, v)), kw.get("causal", True),
        kw.get("window"), kw.get("logit_softcap"), kw.get("scale"))


def decode_library(call) -> tuple:
    """(one PyTorch call that computes what the decode kernel computes on
    one ``ops.decode_attention`` call's q over its (B, Smax, Hkv, D)
    caches; its name): each row's live slots, and of those the last
    ``window`` where a window is on, as ``scaled_dot_product_attention``'s
    boolean mask where neither a window nor a softcap is on, else as
    ``flex_call``'s block mask."""
    import torch
    import torch.nn.functional as F
    (q, kc, vc, kv_len), kw = call
    window, softcap = kw.get("window"), kw.get("logit_softcap")
    lo = (kv_len - window).clamp(min=0) if window \
        else torch.zeros_like(kv_len)
    q4, k4, v4 = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    if window is None and softcap is None:
        slot = torch.arange(kc.shape[1], device=q.device)[None, :]
        live = ((slot < kv_len[:, None])
                & (slot >= lo[:, None]))[:, None, None, :]

        def lib():
            return F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=live, enable_gqa=True,
                scale=kw.get("scale"))
        return lib, "scaled_dot_product_attention"

    def slots(b, h, qi, ki):
        return (ki < kv_len[b]) & (ki >= lo[b])
    return (flex_call(q4, k4, v4, slots, q.shape[0], softcap,
                      kw.get("scale")), "flex_attention")


def flash_serve_record(call, launches: dict, edge_errs: dict,
                       where: str) -> dict:
    """The flash kernel (L not stored) on one ``ops.flash_attention``
    call's (B, S, H, D) q, k, v, beside its plain version and
    ``flash_library``'s call."""
    from repro_torch.kernels import flash_attention, ref
    (q, k, v), kw = call
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    g = hq // hkv
    fkw = dict(g=g, causal=kw.get("causal", True), window=kw.get("window"),
               softcap=kw.get("logit_softcap"), scale=kw.get("scale"))
    qv, kv, vv = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    qb = qv.reshape(b * hq, sq, d)
    kb, vb = kv.reshape(b * hkv, sk, d), vv.reshape(b * hkv, sk, d)
    dt = str(q.dtype).split(".")[1]
    got = flash_attention.flash_attention_bhsd(qv, kv, vv, **fkw)
    want = ref.flash_attention(qb, kb, vb, **fkw)
    err = attn_err(got.reshape(b * hq, sq, d), want, dt,
                   f"flash_attention ({where})")
    lib, lib_name = flash_library(call)
    attn_err(lib().reshape(b * hq, sq, d), want, dt,
             f"{lib_name} ({where}), the library column's call")
    del want
    flops = 4.0 * d * b * hq * live_pairs(sq, sk, fkw["causal"],
                                          fkw["window"])
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return kernel_record(
        "flash_attention", launches, max(err, edge_errs["flash_attention"]),
        lambda: flash_attention.flash_attention_bhsd(qv, kv, vv, **fkw),
        lambda: ref.flash_attention(qb, kb, vb, **fkw), lib, nbytes, flops,
        dt, {"B*Hq": b * hq, "Sq": sq, "Sk": sk, "D": d, "g": g,
             "causal": fkw["causal"], "window": fkw["window"],
             "softcap": fkw["softcap"], "dtype": dt}, where=where,
        library=lib_name)


def decode_record(call, launches: dict, edge_errs: dict, where: str) -> dict:
    """The decode kernel on one ``ops.decode_attention`` call's q and
    caches, beside its plain version and ``decode_library``'s call."""
    import torch
    from repro_torch.kernels import decode_attention, ref
    (q, kc, vc, kv_len), kw = call
    dt = str(q.dtype).split(".")[1]
    b, _, hq, d = q.shape
    _, smax, hkv, _ = kc.shape
    g = hq // hkv
    dkw = dict(window=kw.get("window"), softcap=kw.get("logit_softcap"),
               scale=kw.get("scale"))
    q4 = q.reshape(b, hkv, g, d)
    k4, v4 = kc.transpose(1, 2), vc.transpose(1, 2)
    kl = kv_len[:, None].expand(b, hkv)
    qb = q.reshape(b * hkv, g, d)
    kb, vb = k4.reshape(b * hkv, smax, d), v4.reshape(b * hkv, smax, d)
    klb = torch.repeat_interleave(kv_len, hkv)
    got = decode_attention.decode_attention_bhgd(q4, k4, v4, kl, **dkw)
    want = ref.decode_attention(qb, kb, vb, klb, **dkw)
    err = attn_err(got.reshape(b * hkv, g, d), want, dt,
                   f"decode_attention ({where})")
    lo = (kv_len - dkw["window"]).clamp(min=0) if dkw["window"] \
        else torch.zeros_like(kv_len)
    lib, lib_name = decode_library(call)
    attn_err(lib().reshape(b * hkv, g, d), want, dt,
             f"{lib_name} ({where}), the library column's call")
    slots = int((kv_len.clamp(max=smax) - lo).clamp(min=0).sum()) * hkv
    nbytes = (2 * slots * d + 2 * q.numel()) * q.element_size()
    flops = 4.0 * g * d * slots
    return kernel_record(
        "decode_attention", launches,
        max(err, edge_errs["decode_attention"]),
        lambda: decode_attention.decode_attention_bhgd(q4, k4, v4, kl, **dkw),
        lambda: ref.decode_attention(qb, kb, vb, klb, **dkw), lib, nbytes,
        flops, dt, {"B*Hkv": b * hkv, "G": g, "Smax": smax, "D": d,
                    "kv_len": [int(x) for x in kv_len],
                    "window": dkw["window"], "softcap": dkw["softcap"],
                    "dtype": dt}, where=where, library=lib_name)


# ---------------------------------------------------------------------------
# phase 9: the LM training path
# ---------------------------------------------------------------------------

class LastFlash:
    """Wraps the forward kernel's wrapper and keeps its last call that
    stored L (the training run's: ``FlashAttention.forward`` asks for L
    wherever a gradient follows): q, k, v (the model's transposed (B, H,
    S, D) views), the output O, L and the options of one layer, for the
    backward kernel's timing at the training shape. The stand-in passes
    its ``launches`` and ``by_window`` through to the wrapper's own
    counts, which the wrapper increments through the module's name."""

    def __init__(self):
        from repro_torch.kernels import flash_attention
        self.mod = flash_attention
        self.call = None

    def __enter__(self):
        self.saved = self.mod.flash_attention_bhsd
        self.mod.flash_attention_bhsd = _Spy(self.saved, self)
        return self

    def __exit__(self, *exc):
        self.mod.flash_attention_bhsd = self.saved


class _Spy:
    """``LastFlash``'s stand-in for the forward kernel's wrapper."""

    def __init__(self, fn, owner: LastFlash):
        self.fn = fn
        self.owner = owner

    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.fn.launches = n

    @property
    def by_window(self) -> dict:
        return self.fn.by_window

    def __call__(self, q, k, v, *, return_lse=False, **kw):
        res = self.fn(q, k, v, return_lse=return_lse, **kw)
        if return_lse:
            self.owner.call = (q.detach(), k.detach(), v.detach(),
                               res[0].detach(), res[1], kw)
        return res


def route_grads(cfg, dev, batch: int, seq: int, kernel_impl: str,
                tol: dict | None = None, routes: tuple | None = None
                ) -> dict:
    """``steps.value_and_grad`` of the same seeded params and batch 0 on
    two routes, each a name and its config overrides (default: the
    kernel route and the plain route, dense attention): loss,
    global grad norm and each leaf's gradient must agree within ``tol``
    (``{"loss", "norm", "leaf"}``; default the TRAIN_* constants), and
    every leaf's gradient must be nonzero on both routes (the
    attention's weights get theirs only through the backward), but for
    the token table of a ``frames`` model (hubert), which its forward
    never reads: its gradient must be 0 on both, as the reference's is.
    A MoE model's aux loss must be finite and above 0 on both."""
    import torch
    from repro_torch.data.pipeline import batch_at
    from repro_torch.models import model, steps
    from repro_torch.optim.adamw import global_norm
    tol = tol or {"loss": TRAIN_LOSS_RTOL, "norm": TRAIN_NORM_RTOL,
                  "leaf": TRAIN_GRAD_TOL}
    params = model.init_params(cfg, SEED, dev)
    bt = batch_at(cfg, 0, batch=batch, seq=seq, seed=SEED, device=dev)
    got, aux = {}, {}
    for route, over in routes or (("kernel", {"attn_impl": kernel_impl}),
                                  ("plain", {"attn_impl": "dense"})):
        t0 = time.perf_counter()
        loss, parts, grads = steps.value_and_grad(
            dataclasses.replace(cfg, **over), params, bt)
        norm = float(global_norm(grads))
        aux[route] = float(parts["moe_aux"])
        got[route] = (float(loss), norm, grads, time.perf_counter() - t0)
    del params
    (ra, (kl, kn, kg, ks)), (rb, (pl, pn, pg, ps)) = got.items()
    require(all(math.isfinite(x) for x in (kl, kn, pl, pn)),
            f"train routes: non-finite loss or norm {kl} {kn} {pl} {pn}")
    unused = {"embed"} if cfg.frontend == "frames" else set()
    worst, zero = 0.0, []
    for path, a, b in zip(model_paths(kg), model._leaves(kg),
                          model._leaves(pg)):
        scale = float(b.abs().max())
        if path in unused:
            require(float(a.abs().max()) == 0.0 and scale == 0.0,
                    f"train routes: {path}, which the model does not read, "
                    "has a gradient")
            continue
        if float(a.abs().max()) == 0.0 or scale == 0.0:
            zero.append(path)
            continue
        worst = max(worst, float((a - b).abs().max()) / scale)
    rec = {"loss": {ra: kl, rb: pl},
           "grad_norm": {ra: kn, rb: pn},
           "loss_rel_err": abs(kl - pl) / abs(pl),
           "norm_rel_err": abs(kn - pn) / pn,
           "grad_leaf_rel_err": worst, "leaves": len(list(model._leaves(kg))),
           "zero_grad_leaves": zero, "unused_leaves": sorted(unused),
           "moe_aux": aux,
           "compute_dtype": cfg.compute_dtype, "tolerances": tol,
           f"{ra}_s": ks, f"{rb}_s": ps}
    log("train routes " + json.dumps(rec))
    require(not zero, f"train routes: leaves with no gradient: {zero}")
    if cfg.num_experts:
        require(all(math.isfinite(a) and a > 0 for a in aux.values()),
                f"train routes: moe_aux {aux}")
    require(rec["loss_rel_err"] <= tol["loss"]
            and rec["norm_rel_err"] <= tol["norm"] and worst <= tol["leaf"],
            f"train {ra} and {rb} routes disagree: {rec}")
    return rec


def model_paths(tree, prefix: str = "") -> list[str]:
    """The leaves' paths, in ``model._leaves`` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in model_paths(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in model_paths(v, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def train_path(dev, *, arch: str = TRAIN_ARCH, smoke: bool = False,
               steps: int = TRAIN_STEPS, batch: int = TRAIN_BATCH,
               seq: int = TRAIN_SEQ, counters: dict | None = None,
               capture=None, route_check: bool = True,
               route_overrides: dict | None = None,
               route_tol: dict | None = None,
               overrides: dict | None = None,
               tag: str = "train", mesh=None) -> dict:
    """Phase 9 (and 10, 11): kernel-route vs plain-route gradients
    (``route_grads`` under the config ``route_overrides``, within
    ``route_tol``; skipped without ``route_check``), then
    ``launch.train.train`` of ``arch`` for ``steps`` steps at full width
    (the config's own remat, microbatches and CE chunks). Prints each
    step's ms,
    tokens/s, MFU (``models.flops`` over the bf16 peak), peak MiB, loss,
    grad norm and, with ``counters`` (the flash wrappers, set to 0 before
    each step), its flash forward and backward launches: 2 x attention
    layers x microbatches forward (remat runs each layer's forward again
    in the backward) and attention layers x microbatches backward.
    ``capture``: a context around the training run (``LastFlash``);
    ``overrides``: config fields of the whole path (``remat_policy``);
    ``mesh``: train sharded over it (phase 14)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.train import train
    from repro_torch.models import flops
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    cfg = dataclasses.replace(cfg, **(overrides or {}))
    route_rec = None
    if route_check:
        route_rec = route_grads(
            dataclasses.replace(cfg, **(route_overrides or {})), dev, batch,
            seq, kernel_impl(dev), route_tol)
        release(dev)

    micro = cfg.train_microbatches
    mult = 2 if cfg.remat else 1
    n_attn = sum(cfg.layer_spec(i).mixer.startswith("attn")
                 for i in range(cfg.num_layers))
    want = {"flash_attention": mult * n_attn * micro,
            "flash_attention_bwd": n_attn * micro}
    model_flops = flops.model_flops(cfg, "train", batch, seq)["total"]
    recs = []

    def on_step(step, metrics, seconds):
        rec = {"step": step, "ms": seconds * 1e3,
               "tokens_per_s": batch * seq / seconds,
               "mfu": model_flops / seconds / PEAK_FLOPS["bfloat16"],
               "peak_mib": peak_mib(dev),
               "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"])}
        if counters:
            rec["launches"] = {k: w.launches for k, w in counters.items()}
            for w in counters.values():
                w.launches = 0
        reset_peak(dev)
        log(f"{tag} step " + json.dumps(rec))
        recs.append(rec)

    for w in (counters or {}).values():
        w.launches = 0
    reset_peak(dev)
    with capture if capture is not None else contextlib.nullcontext():
        out = train(arch, smoke=smoke, steps=steps, batch=batch, seq=seq,
                    seed=SEED, device=dev, num_microbatches=micro,
                    log_every=steps,
                    overrides={**(overrides or {}),
                               "attn_impl": kernel_impl(dev)},
                    on_step=on_step, mesh=mesh)
    del out
    release(dev)
    require(len(recs) == steps, f"train ran {len(recs)} of {steps} steps")
    require(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                for r in recs), "train: non-finite loss or grad norm")
    if counters:
        for r in recs:
            require(r["launches"] == {**{k: 0 for k in counters}, **want},
                    f"train step {r['step']} launched {r['launches']}, "
                    f"want {want}")
    total = ({k: sum(r["launches"][k] for r in recs) for k in counters}
             if counters else None)
    warm = recs[1:] or recs
    warm_s = sum(r["ms"] for r in warm) / len(warm) / 1e3
    summary = {"arch": arch, "params": cfg.num_params(),
               "batch": batch, "seq": seq, "microbatches": micro,
               "remat": cfg.remat, "remat_policy": cfg.remat_policy,
               "ce_chunks": cfg.ce_chunks,
               "warm_ms": warm_s * 1e3,
               "tokens_per_s": batch * seq / warm_s,
               "mfu": model_flops / warm_s / PEAK_FLOPS["bfloat16"],
               "model_flops": model_flops,
               "peak_mib": max(r["peak_mib"] for r in recs),
               "losses": [r["loss"] for r in recs],
               "launches_per_step": want if counters else None,
               "launches": total, "routes": route_rec}
    log(f"{tag} summary " + json.dumps({k: v for k, v in summary.items()
                                        if k != "routes"}))
    return summary


def resume_check(dev, *, smoke_overrides: dict | None = None) -> dict:
    """Phase 9's resume: at the smoke config, 8 steps with a checkpoint
    every 4 against a run that fails at step 6 and is resumed from its
    step-4 checkpoint (tests/test_checkpoint.py:57-75 on the card): the
    final params must agree within RESUME_ATOL."""
    import tempfile
    from repro_torch.checkpoint import latest_step
    from repro_torch.launch.train import train
    from repro_torch.models import model
    kw = dict(smoke=True, steps=RESUME["steps"], batch=RESUME["batch"],
              seq=RESUME["seq"], ckpt_every=RESUME["ckpt_every"],
              seed=SEED, device=dev, log_every=100,
              overrides=smoke_overrides)
    with tempfile.TemporaryDirectory() as tmp:
        full = train(TRAIN_ARCH, ckpt_dir=f"{tmp}/a", **kw)
        try:
            train(TRAIN_ARCH, ckpt_dir=f"{tmp}/b", fail_at=RESUME["fail_at"],
                  **kw)
        except RuntimeError as e:
            require("injected failure" in str(e), f"resume: {e}")
        else:
            raise SmokeError("resume: the injected failure did not raise")
        require(latest_step(f"{tmp}/b") == RESUME["ckpt_every"],
                f"resume: latest step {latest_step(f'{tmp}/b')}")
        resumed = train(TRAIN_ARCH, ckpt_dir=f"{tmp}/b", **kw)
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(
        model._leaves(full["params"]), model._leaves(resumed["params"])))
    rec = {"steps": RESUME["steps"], "failed_at": RESUME["fail_at"],
           "resumed_from": RESUME["ckpt_every"], "max_abs_err": err,
           "atol": RESUME_ATOL, "losses": full["losses"],
           "resumed_losses": resumed["losses"]}
    log("train resume " + json.dumps(rec))
    require(err <= RESUME_ATOL, f"resumed run differs: {err}")
    return rec


def train_bwd_check(q, k, v, o, lse, do, kw) -> tuple[float, dict]:
    """The backward kernel, handed the forward kernel's L, against its
    plain version (L recomputed) on (B, H, S, D) inputs: ``attn_err``'s
    check, then each of dQ, dK, dV held to its own size
    (``TRAIN_BWD_TOL``). Returns the largest |err| and, for the record,
    each output's largest |g| and relative errors."""
    import torch
    from repro_torch.kernels import flash_attention, ref
    d = q.shape[3]
    dt = str(q.dtype).split(".")[1]
    tol = TRAIN_BWD_TOL[dt]
    got = flash_attention.flash_attention_bwd_bhsd(q, k, v, o, do, lse,
                                                   **kw)
    want = ref.flash_attention_bwd(
        *(x.reshape(-1, x.shape[2], d) for x in (q, k, v, o, do)), **kw)
    err, sizes = 0.0, {}
    for a, w, n in zip(got, want, "qkv"):
        what = f"flash_attention_bwd d{n} ({dt}, training shape)"
        err = max(err, attn_err(a.reshape(w.shape), w, dt, what))
        a, w = a.reshape(w.shape).float(), w.float()
        diff = a - w
        rel_max = float(diff.abs().max() / w.abs().max())
        rel_rms = float(diff.pow(2).mean().sqrt() / w.pow(2).mean().sqrt())
        sizes[f"d{n}"] = {"max_abs_g": float(w.abs().max()),
                          "rms_g": float(w.pow(2).mean().sqrt()),
                          "err_over_max_g": rel_max,
                          "rms_err_over_rms_g": rel_rms}
        require(rel_max <= tol["max"] and rel_rms <= tol["rms"],
                f"{what}: error {rel_max} of its largest |g|, RMS error "
                f"{rel_rms} of its RMS, limits {tol}")
    del got, want
    torch.cuda.empty_cache()
    return err, sizes


def ptxas_report(lib: str) -> dict:
    """Registers and spill bytes (stores, loads) of every kernel in the
    ``-Xptxas=-v`` log of one built library, by mangled name."""
    import re
    from repro_torch.kernels import _build
    out, name, spill = {}, None, (0, 0)
    for line in _build.library_path(lib).with_suffix(".log").read_text() \
            .splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = {"registers": int(m.group(1)), "spill_bytes": spill}
    return out


def template_report(names, lib: str) -> dict:
    """For each demangled kernel name a profiler gave (``...::bwd_dq_tc<
    128, 128>(...)``), its template and the ptxas registers and spills
    of that instantiation."""
    import re
    rep = ptxas_report(lib)
    out = {}
    for full in sorted(names):
        m = re.search(r"::(\w+)<([^>]*)>\(", full)
        if not m:
            continue
        base, args = m.group(1), [a.strip() for a in m.group(2).split(",")]
        hits = []
        if all(a.isdigit() for a in args):    # an integer template's key
            key = (f"{len(base)}{base}I" + "".join(f"Li{a}E" for a in args)
                   + "E")
            hits = [v for n, v in rep.items() if key in n]
        out[f"{base}<{', '.join(args)}>"] = hits[0] if hits else None
    return out


def short_name(mangled: str) -> str:
    """``bwd_dq_tc<128,128>`` for the mangled name of a flash kernel."""
    import re
    m = re.search(r"(flash_fwd_tc|flash_fwd_f32|bwd_dkdv_tc|bwd_dq_tc|"
                  r"bwd_dkdv|bwd_dq)I(.+?)EEv", mangled)
    if not m:
        return mangled
    args = [n or ("bf16" if b else "float") for n, b, _ in
            re.findall(r"Li(\d+)E|(13__nv_bfloat16)|(f)", m.group(2))]
    return f"{m.group(1)}<{','.join(args)}>"


def kernels_run(fn) -> set:
    """The CUDA kernels one call of ``fn`` launches, by the profiler's
    (demangled) names."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def train_kernel_timing(call, launches: dict, edge_errs: dict,
                        templates: "TemplateCheck",
                        where: str = "training shape") -> tuple[dict, dict]:
    """The backward kernel on what one layer of the training run gave the
    flash forward kernel (``LastFlash``: q, k, v, its output O and L) and
    a seeded dO, timed beside its plain version and the autograd
    backward of ``scaled_dot_product_attention`` on the same inputs. The
    inputs go to ``templates``, which reads later which kernel templates
    the backward and the forward ran. The forward kernel at the same
    inputs, with L stored (training) and not (serve), is timed and logged
    beside it, and with L stored recorded beside its plain version and
    ``scaled_dot_product_attention``. Returns the (backward, forward)
    records."""
    import torch
    from repro_torch.kernels import flash_attention, ref
    require(call is not None, "the training path never reached the "
            "flash forward kernel with L")
    q, k, v, o, lse, kw = call
    do = normal(tuple(q.shape), SEED + 140, q.device, q.dtype)
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = kw["g"]
    flat = [x.reshape(-1, x.shape[2], d) for x in (q, k, v, o, do)]
    dt = str(q.dtype).split(".")[1]
    # the training run's L against the plain L of the same inputs
    lse_err = check_lse(lse.reshape(b * hq, sq), ref.flash_attention(
        *flat[:3], return_lse=True, **kw)[1], dt,
        "flash_attention (training shape)")
    err, sizes = train_bwd_check(q, k, v, o, lse, do, kw)
    # the same inputs in float32, through both float32 kernels
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    o32, lse32 = flash_attention.flash_attention_bhsd(q32, k32, v32,
                                                      return_lse=True, **kw)
    _, sizes["float32"] = train_bwd_check(q32, k32, v32, o32, lse32, do32,
                                          kw)
    del q32, k32, v32, do32, o32, lse32
    fwd = {"serve_ms": cuda_ms(lambda: flash_attention.flash_attention_bhsd(
               q, k, v, **kw)),
           "train_ms": cuda_ms(lambda: flash_attention.flash_attention_bhsd(
               q, k, v, return_lse=True, **kw))}
    log(f"kernel flash_attention at {where}, L off (serve) and on "
        "(training): " + json.dumps(fwd))
    qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
    fwd_lib, lib_name = attention_library(qq, kk, vv, kw["causal"],
                                          kw["window"], kw["softcap"],
                                          kw["scale"])
    out = fwd_lib()

    def lib():
        return torch.autograd.grad(out, (qq, kk, vv), do, retain_graph=True)
    pairs = live_pairs(sq, sk, kw["causal"], kw["window"])
    # five products (S, dP, dV, dQ, dK) of 2 D FLOP a live pair
    flops = 10.0 * d * b * hq * pairs
    nbytes = (2 * (q.numel() + k.numel() + v.numel())
              + o.numel() + do.numel()) * q.element_size() + lse.numel() * 4
    shape = {"B*Hq": b * hq, "Sq": sq, "Sk": sk, "D": d, "g": g,
             "causal": kw["causal"], "dtype": dt}
    bwd = kernel_record(
        "flash_attention_bwd", launches,
        max(err, edge_errs["flash_attention_bwd"]),
        lambda: flash_attention.flash_attention_bwd_bhsd(q, k, v, o, do, lse,
                                                         **kw),
        lambda: ref.flash_attention_bwd(*flat, **kw),
        lib, nbytes, flops, dt,
        {**shape, "lse_max_abs_err": lse_err, **sizes}, where=where,
        library=f"autograd of {lib_name}")
    del out, qq, kk, vv
    # the forward with L stored, as training runs it
    fwd_err = attn_err(o.reshape(flat[0].shape),
                       ref.flash_attention(*flat[:3], **kw), dt,
                       f"flash_attention ({where})")
    lib, _ = attention_library(q, k, v, kw["causal"], kw["window"],
                               kw["softcap"], kw["scale"])
    fwd_rec = kernel_record(
        "flash_attention", launches,
        max(fwd_err, edge_errs["flash_attention"]),
        lambda: flash_attention.flash_attention_bhsd(q, k, v, return_lse=True,
                                                     **kw),
        lambda: ref.flash_attention(*flat[:3], return_lse=True, **kw), lib,
        (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        + lse.numel() * 4, 4.0 * d * b * hq * pairs, dt,
        {**shape, "lse": True}, where=where + ", L stored",
        library=lib_name)
    templates.add(where, bwd, fwd_rec, (q, k, v, o, lse, do), kw)
    return bwd, fwd_rec


def gemma2_bwd_row(dev, edge_errs: dict,
                   templates: "TemplateCheck") -> dict:
    """The flash backward (and the forward with L) at ``GEMMA2_BWD``
    through ``train_kernel_timing``, on seeded q, k, v and the forward
    kernel's O and L. No path trains gemma2-9b on one card: the record
    has 0 launches and is logged, not put in the kernels line. Returns
    the backward record."""
    import torch
    from repro_torch.kernels import flash_attention
    (b, hq, s, d), g, cap = GEMMA2_BWD
    q = normal((b, hq, s, d), SEED + 160, dev, torch.bfloat16)
    k, v = (normal((b, hq // g, s, d), SEED + 161 + i, dev, torch.bfloat16)
            for i in range(2))
    kw = dict(g=g, causal=True, window=None, softcap=cap, scale=d ** -0.5)
    o, lse = flash_attention.flash_attention_bhsd(q, k, v, return_lse=True,
                                                  **kw)
    bwd, _ = train_kernel_timing(
        (q, k, v, o, lse, kw), {"flash_attention": 0,
                                "flash_attention_bwd": 0},
        edge_errs, templates, where="gemma2-9b training shape, seeded")
    return bwd


class TemplateCheck:
    """Which kernel templates the flash backward and the forward with L
    ran at each training shape, read by ``torch.profiler`` in a process
    of its own for each shape (``template_probe``; a third profiler
    session in one process returned no CUDA event on the H100 machine),
    all started together at the end, on the layer inputs the training
    run gave the kernels. Each backward record gets the templates it ran
    with their ptxas registers and spills; in bf16 they must be the
    tensor-core pair (``bwd_kernels``)."""

    def __init__(self):
        self.tmp = tempfile.TemporaryDirectory()
        self.jobs: list = []

    def add(self, where: str, bwd: dict, fwd: dict, tensors: tuple,
            kw: dict) -> None:
        import torch
        path = Path(self.tmp.name) / f"{len(self.jobs)}.pt"
        torch.save({"tensors": [t.detach() for t in tensors], "kw": kw},
                   path)
        self.jobs.append((where, bwd, fwd, tensors[0].dtype,
                          tensors[0].shape[3], path))

    def run(self) -> None:
        from repro_torch.kernels import flash_attention
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--templates",
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for *_, path in self.jobs]
        try:
            outs = [p.communicate(timeout=300) for p in procs]
            for (where, bwd, fwd, dtype, d, _), p, (out, err) in zip(
                    self.jobs, procs, outs):
                require(p.returncode == 0, f"template probe at {where} "
                        f"failed ({p.returncode}): {err[-2000:]}")
                names = json.loads(out.strip().splitlines()[-1])
                bwd["templates"] = template_report(names["bwd"],
                                                   "flash_attention_bwd")
                fwd["templates"] = template_report(names["fwd"],
                                                   "flash_attention")
                log(f"kernel templates at {where}: " + json.dumps(
                    {"bwd": bwd["templates"], "fwd": fwd["templates"]}))
                want = flash_attention.bwd_kernels(dtype, d)
                ran = {t.split("<")[0] for t in bwd["templates"]}
                require(ran == set(want), f"the backward at {where} ran "
                        f"{sorted(bwd['templates'])}, not {want}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            self.tmp.cleanup()


def template_probe(path: Path) -> int:
    """``--templates``: the flash backward, then the forward with L, on
    the inputs ``TemplateCheck.add`` saved, each under its own profiler
    session; prints the CUDA kernels each launched as one JSON line."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import flash_attention
    saved = torch.load(path, map_location="cuda")
    q, k, v, o, lse, do = saved["tensors"]
    kw = saved["kw"]
    names = {
        "bwd": sorted(kernels_run(
            lambda: flash_attention.flash_attention_bwd_bhsd(
                q, k, v, o, do, lse, **kw))),
        "fwd": sorted(kernels_run(
            lambda: flash_attention.flash_attention_bhsd(
                q, k, v, return_lse=True, **kw)))}
    print(json.dumps(names))
    return 0


# ---------------------------------------------------------------------------
# phases 10 and 11: the MoE and Mamba-2 models, served and trained
# ---------------------------------------------------------------------------

def moe_f64_check(cfg, moe_params, dev, tokens: int = MOE_F64_TOKENS,
                  layer: int = 0) -> dict:
    """One MoE layer (``moe_params``, layer ``layer``'s weights) at full
    width on ``tokens`` seeded rows in float64, on ``dev`` and through
    the port on the CPU: the expert ids, the sorted order, the ranks and
    the rows kept must be equal, the output and the aux loss within
    MOE_F64_RTOL of the CPU's (over the largest |value|). On the card
    this holds CUDA's sort, ``bincount`` and ``index_put`` to the
    reference's dispatch. Each side casts its own copy of the weights
    (the CPU's is copied over in their own dtype)."""
    import torch
    from repro_torch.models import model, moe
    x = normal((tokens, cfg.d_model), SEED + 150, dev, torch.float64)
    kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
    got = {}
    t0 = time.perf_counter()
    for where, d in (("device", dev), ("cpu", torch.device("cpu"))):
        pd = model.tree_map(lambda t, d=d: t.detach().to(d).to(
            torch.float64), moe_params)
        xd = x.to(d)
        r = moe.route(pd, xd, **kw)
        y, aux = moe.moe_apply(pd, xd, act=cfg.act, **kw)
        got[where] = ({k: r[k].cpu() for k in ("expert_ids", "order", "pos",
                                              "dest")}, y.cpu(), aux.cpu())
        del pd, xd, r, y, aux
    seconds = time.perf_counter() - t0
    (rd, yd, ad), (rc, yc, ac) = got["device"], got["cpu"]
    same = {k: bool(torch.equal(rd[k], rc[k])) for k in rd}
    # rows on which every expert ties: the router must pick the lower
    # experts first, as lax.top_k does (torch.topk's order is printed)
    router = {"router": moe_params["router"].detach().to(dev).to(
        torch.float64)}
    ties = torch.zeros((4, cfg.d_model), dtype=torch.float64, device=dev)
    first = torch.arange(cfg.top_k).expand(4, -1)
    same["ties_lower_expert_first"] = bool(torch.equal(
        moe.route(router, ties, **kw)["expert_ids"].cpu(), first))
    topk_ties = bool(torch.equal(torch.topk(
        torch.full((4, cfg.num_experts), 1.0, device=dev),
        cfg.top_k).indices.cpu(), first))
    rows = cfg.num_experts * moe.expert_capacity(tokens, cfg.num_experts,
                                                 cfg.top_k,
                                                 cfg.capacity_factor)
    rec = {"tokens": tokens, "cap": rows // cfg.num_experts,
           "kept": int((rc["dest"] < rows).sum()),
           "assignments": tokens * cfg.top_k, "equal": same,
           "out_rel_err": float((yd - yc).abs().max() / yc.abs().max()),
           "aux_rel_err": float((ad - ac).abs() / ac.abs()),
           "rtol": MOE_F64_RTOL, "torch_topk_ties_lower_first": topk_ties,
           "layer": layer, "d_model": cfg.d_model,
           "d_ff_expert": cfg.d_ff_expert, "experts": cfg.num_experts,
           "top_k": cfg.top_k, "seconds": seconds}
    log("moe float64 " + json.dumps(rec))
    require(all(same.values()), f"moe float64: the device routes otherwise "
            f"than the CPU: {same}")
    require(rec["out_rel_err"] <= MOE_F64_RTOL
            and rec["aux_rel_err"] <= MOE_F64_RTOL,
            f"moe float64: device and CPU disagree: {rec}")
    return rec


def moe_path(dev, *, smoke: bool = False, requests: int = LM_REQUESTS,
             prompt_len: int = LM_PROMPT, gen_len: int = LM_GEN,
             steps: int = TRAIN_STEPS, batch: int = TRAIN_BATCH,
             seq: int = TRAIN_SEQ, f64_tokens: int = MOE_F64_TOKENS,
             counters: dict | None = None, capture=None,
             train_capture=None) -> dict:
    """Phase 10: MOE_ARCH at full width. ``serve_batch`` cold and warm on
    the kernel route in bf16 (``counters``: the flash and decode
    wrappers, once per layer and per layer per token; ``capture`` sees
    the cold serve), then teacher-forced on the plain route: the bf16
    logit difference and the share of (token, layer) routing decisions
    that differ are printed, not gated (one bf16 ulp in an attention
    output can move a token's 8th expert). The gate runs in float32:
    kernel route (the FP32-core kernels) against plain route within
    MOE_F32_LOGIT_ATOL. Then one MoE layer in float64 on the card
    against the CPU (``moe_f64_check``), the training routes in float32
    within MOE_TRAIN_TOL and ``launch.train.train`` (``train_path``,
    ``counters`` holding the flash pair too; ``train_capture`` around
    the run)."""
    from repro_torch.launch.serve import serve_batch
    cfg, params = init_model("moe", MOE_ARCH, dev, smoke)
    kw = dict(smoke=smoke, num_requests=requests, prompt_len=prompt_len,
              gen_len=gen_len, seed=SEED, device=dev, params=params)
    runs = serve_kernel_runs(MOE_ARCH, cfg, dev, kw, counters, capture,
                             tag="moe")
    bf16 = plain_route_check(MOE_ARCH, cfg, dev, kw, runs["warm"][1], None,
                             tag="moe bf16", routes=runs["routes"])
    kw32 = {**kw, "overrides": {"compute_dtype": "float32"}}
    with RouteLog() as routes32:
        k32 = serve_batch(MOE_ARCH, **kw32)
    f32 = plain_route_check(MOE_ARCH, cfg, dev, kw32, k32,
                            MOE_F32_LOGIT_ATOL, tag="moe f32",
                            routes=routes32.ids)
    del k32, routes32
    log("moe check " + json.dumps({"bfloat16": {k: bf16[k] for k in (
        "logit_max_abs_err", "plain_argmax_agrees",
        "routing_decisions_differ")}, "float32": {k: f32[k] for k in (
            "logit_max_abs_err", "logit_atol", "plain_argmax_agrees",
            "routing_decisions_differ")}}))
    f64 = moe_f64_check(cfg, params["layers"][0]["moe"], dev, f64_tokens)
    del params
    release(dev)
    trained = train_path(dev, arch=MOE_ARCH, smoke=smoke, steps=steps,
                         batch=batch, seq=seq, counters=counters,
                         capture=train_capture,
                         route_overrides={"compute_dtype": "float32"},
                         route_tol=MOE_TRAIN_TOL, tag="moe train")
    return {"warm": runs["warm"][0], "cold": runs["cold"][0],
            "bfloat16": bf16, "float32": f32, "float64": f64,
            "train": trained}


def ssm_chain_gate(cfg, params, dev, dtype: str, batch: int, prefix: int,
                   extra: int) -> dict:
    """The logits of one forward over ``prefix`` + ``extra`` rounded up
    to the chunk (2048 + 256 at full size) seeded tokens, at positions
    prefix .. prefix + extra - 1, against a prefill over the first
    ``prefix`` followed by ``extra`` decode steps fed the next tokens,
    in ``dtype`` compute: the chunked dual form against the
    recurrence."""
    import torch
    from repro_torch.models import model
    c = dataclasses.replace(cfg, compute_dtype=dtype)
    cp = model.compute_params(c, params)
    total = prefix + -(-extra // c.ssm_chunk) * c.ssm_chunk
    gen = torch.Generator().manual_seed(SEED + 160)
    toks = torch.randint(1, c.vocab_size, (batch, total), generator=gen,
                         dtype=torch.int32).to(dev)
    with torch.no_grad():
        h, _ = model.forward(c, cp, {"tokens": toks})
        want = model.logits_from_hidden(c, cp, h[:, prefix:prefix + extra])
        del h
        _, caches = model.prefill(c, cp, {"tokens": toks[:, :prefix]})
        kv_len = torch.full((batch,), prefix, dtype=torch.int32, device=dev)
        got = []
        for t in range(prefix, prefix + extra):
            kv_len = kv_len + 1
            hd, caches = model.decode_step_hidden(c, cp, caches,
                                                  toks[:, t:t + 1], kv_len)
            got.append(model.logits_from_hidden(c, cp, hd))
        got = torch.cat(got, 1)
    require(tuple(got.shape) == (batch, extra, c.vocab_size)
            and tuple(want.shape) == tuple(got.shape),
            f"ssm chain: shapes {tuple(got.shape)}, {tuple(want.shape)}")
    require(bool(torch.isfinite(got).all() & torch.isfinite(want).all()),
            "ssm chain: non-finite logits")
    return {"dtype": dtype, "batch": batch, "forward": total,
            "prefix": prefix, "extra": extra,
            "max_abs_err": float((got - want).abs().max()),
            "logit_abs_max": float(want.abs().max())}


def ssm_path(dev, *, smoke: bool = False, requests: int = LM_REQUESTS,
             prompt_len: int = LM_PROMPT, gen_len: int = LM_GEN,
             steps: int = TRAIN_STEPS, batch: int = TRAIN_BATCH,
             seq: int = TRAIN_SEQ, counters: dict | None = None) -> dict:
    """Phase 11: SSM_ARCH at full width. ``serve_batch`` cold and warm
    (``counters``: the attention wrappers, which must not launch); the
    gate in float32, a forward over prompt_len + gen_len tokens against
    a prefill of prompt_len and gen_len decode steps within
    SSM_CHAIN_ATOL (the same pair in bf16 printed); then
    ``launch.train.train``: finite losses and no attention launch; then
    ``fixed_batch_fit``: the last loss below the first. (``train``'s
    batches are fresh uniform random tokens each step, with nothing to
    learn but the logits' scale: their losses need not fall in 4
    steps.)"""
    cfg, params = init_model("ssm", SSM_ARCH, dev, smoke)
    kw = dict(smoke=smoke, num_requests=requests, prompt_len=prompt_len,
              gen_len=gen_len, seed=SEED, device=dev, params=params)
    runs = serve_kernel_runs(SSM_ARCH, cfg, dev, kw, counters, None,
                             tag="ssm")
    gates = {}
    for dt in ("float32", "bfloat16"):
        gates[dt] = ssm_chain_gate(cfg, params, dev, dt, requests,
                                   prompt_len, gen_len)
        release(dev)
    gates["atol"] = SSM_CHAIN_ATOL
    log("ssm chain " + json.dumps(gates))
    require(gates["float32"]["max_abs_err"] <= SSM_CHAIN_ATOL,
            f"ssm: the prefill and the decode chain disagree: {gates}")
    del params, runs
    release(dev)
    trained = train_path(dev, arch=SSM_ARCH, smoke=smoke, steps=steps,
                         batch=batch, seq=seq, counters=counters,
                         route_check=False, tag="ssm train")
    release(dev)
    fit = fixed_batch_fit(cfg, dev, batch, seq)
    log("ssm fit " + json.dumps({"batch": batch, "seq": seq,
                                 "losses": fit}))
    require(all(math.isfinite(x) for x in fit) and fit[-1] < fit[0],
            f"ssm: the loss on a fixed batch did not fall: {fit}")
    return {"chain": gates, "train": trained, "fit": fit}


def fixed_batch_fit(cfg, dev, batch: int, seq: int) -> list[float]:
    """SSM_FIT_STEPS train steps (2 microbatches, warmup 1, peak lr 3e-4)
    from the seeded params, each on batch 0: the losses, which fall as
    the model fits that batch."""
    from repro_torch.data.pipeline import batch_at
    from repro_torch.models import model, steps as steps_lib
    from repro_torch.optim import adamw_init
    params = model.init_params(cfg, SEED, dev)
    opt = adamw_init(params)
    step = steps_lib.make_train_step(cfg, num_microbatches=2, peak_lr=3e-4,
                                     warmup_steps=1, total_steps=100)
    bt = batch_at(cfg, 0, batch=batch, seq=seq, seed=SEED, device=dev)
    losses = []
    for _ in range(SSM_FIT_STEPS):
        params, opt, metrics = step(params, opt, bt)
        losses.append(float(metrics["loss"]))
    del params, opt
    release(dev)
    return losses


# ---------------------------------------------------------------------------
# phase 12: the vlm and audio front ends
# ---------------------------------------------------------------------------

def vlm_serve(cfg, cparams, batch: dict, gen_len: int, dev,
              feed=None) -> dict:
    """``steps.make_prefill_step`` over ``batch`` (patches, tokens, M-RoPE
    positions), its attention caches grown by ``gen_len`` slots, then
    ``gen_len`` tokens through ``steps.greedy_decode``, the first fed the
    prefill's argmax at position S. With ``feed`` (B, gen_len) the
    decode steps go through ``steps.make_decode_step`` fed those tokens
    instead (teacher forcing) and their logits are kept. Returns
    ``serve_batch``'s keys."""
    import torch
    from repro_torch.models import model, steps
    device_sync(dev)
    t0 = time.perf_counter()
    logits, pre = steps.make_prefill_step(cfg)(cparams, batch)
    b, s = pre[0]["k"].shape[:2]
    caches = model.init_cache(cfg, b, s + gen_len, dev)
    for dst, src in zip(caches, pre):
        dst["k"][:, :s] = src["k"]
        dst["v"][:, :s] = src["v"]
    del pre
    device_sync(dev)
    t_prefill = time.perf_counter() - t0
    first = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    kv_len = torch.full((b,), s + 1, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    step_logits = None
    if feed is None:
        toks, caches, _ = steps.greedy_decode(cfg, cparams, caches, first,
                                              kv_len, gen_len)
    else:
        decode = steps.make_decode_step(cfg)
        tok, outs = first, []
        for t in range(gen_len):
            lg, caches = decode(cparams, caches, tok, kv_len + t)
            outs.append(lg[:, -1])
            tok = feed[:, t:t + 1]
        step_logits = torch.stack(outs, 1)
        toks = torch.argmax(step_logits, -1)
    device_sync(dev)
    t_decode = time.perf_counter() - t0
    return {"generated": toks.cpu().numpy(), "prefill_s": t_prefill,
            "decode_s": t_decode,
            "tok_per_s": b * gen_len / max(t_decode, 1e-9),
            "prefill_logits": logits, "step_logits": step_logits}


def vlm_routes(cfg, params, batch: dict, gen_len: int, dev, dtype: str,
               tokens, atol: float | None, ref: dict | None = None
               ) -> tuple[dict, dict]:
    """Kernel route against plain route (dense attention) in ``dtype``,
    both teacher-forced with ``tokens``: prefill and step logits within
    ``atol`` (printed only where it is None). ``ref``: the float32 plain
    route's outputs, against which each route's distance is printed too.
    Returns (the record, each route's outputs)."""
    import torch
    from repro_torch.models import model
    feed = torch.as_tensor(tokens, dtype=torch.int32, device=dev)
    out, ms = {}, {}
    for route, impl in (("kernel", kernel_impl(dev)), ("plain", "dense")):
        c = dataclasses.replace(cfg, compute_dtype=dtype, attn_impl=impl)
        cp = model.compute_params(c, params)
        out[route] = vlm_serve(c, cp, batch, gen_len, dev, feed=feed)
        ms[route] = {"prefill_ms": out[route]["prefill_s"] * 1e3,
                     "decode_ms_per_token":
                         out[route]["decode_s"] * 1e3 / gen_len}
        del cp
        release(dev)
    b = tokens.shape[0]
    shapes = {"prefill_logits": (b, 1, cfg.vocab_size),
              "step_logits": (b, gen_len, cfg.vocab_size)}
    errs = logit_errs(out["kernel"], out["plain"], shapes, f"vlm {dtype}")
    rec = {"dtype": dtype, "logit_max_abs_err": errs, "logit_atol": atol,
           "logit_abs_max": {k: float(out["plain"][k].abs().max())
                             for k in shapes},
           "kernel_argmax_is_fed": float(
               (out["kernel"]["generated"] == tokens).mean()),
           "plain_argmax_agrees": float(
               (out["plain"]["generated"] == tokens).mean()), "ms": ms}
    if ref is not None:
        rec["from_float32_plain"] = {
            route: logit_errs(out[route], ref, shapes, f"vlm {dtype}")
            for route in out}
    log("vlm routes " + json.dumps(rec))
    if atol is not None:
        require(max(errs.values()) <= atol, f"vlm kernel and plain routes "
                f"disagree in {dtype}: {errs} > {atol}")
    return rec, out


def vlm_path(dev, *, smoke: bool = False, batch: int = TRAIN_BATCH,
             seq: int = TRAIN_SEQ, gen_len: int = LM_GEN,
             steps: int = TRAIN_STEPS, counters: dict | None = None,
             capture=None, train_capture=None) -> dict:
    """Phase 12, VLM_ARCH at full width: batch 0 of ``data.pipeline``
    (``batch`` x ``seq`` positions, a quarter of them patches) prefilled
    and ``gen_len`` tokens decoded greedily, cold and warm (``counters``:
    the flash and decode wrappers, once per layer and once per layer per
    token; ``capture`` sees the cold serve's calls), the cold and warm
    tokens equal; then the kernel route against the plain route, teacher-
    forced with the warm serve's tokens: in float32 within
    VLM_F32_LOGIT_ATOL, in bf16 printed, with each bf16 route's distance
    from the float32 plain route (the kernel route fed its own tokens
    must give them back); then the float32 training routes and
    ``launch.train.train`` (``train_path``)."""
    from repro_torch.data.pipeline import batch_at
    from repro_torch.models import model
    cfg, params = init_model("vlm", VLM_ARCH, dev, smoke)
    bt = batch_at(cfg, 0, batch=batch, seq=seq, seed=SEED, device=dev)
    bt.pop("labels")
    want = {**{k: 0 for k in counters or {}},
            "flash_attention": cfg.num_layers,
            "decode_attention": cfg.num_layers * gen_len}
    cparams = model.compute_params(cfg, params)
    runs = {}
    for label in ("cold", "warm"):
        for w in (counters or {}).values():
            w.launches = 0
        reset_peak(dev)
        with capture if capture is not None and label == "cold" \
                else contextlib.nullcontext():
            out = vlm_serve(cfg, cparams, bt, gen_len, dev)
        rec = {"arch": VLM_ARCH, "route": "kernel", "run": label,
               "batch": batch, "patches": int(bt["patches"].shape[1]),
               "tokens": int(bt["tokens"].shape[1]),
               "prefill_ms": out["prefill_s"] * 1e3,
               "decode_ms_per_token": out["decode_s"] * 1e3 / gen_len,
               "tok_per_s": out["tok_per_s"], "peak_mib": peak_mib(dev)}
        if counters:
            rec["launches"] = {k: w.launches for k, w in counters.items()}
            require(rec["launches"] == want, f"vlm {label} serve launched "
                    f"{rec['launches']}, want {want}")
        log("vlm serve " + json.dumps(rec))
        runs[label] = (rec, out)
    tokens = runs["warm"][1]["generated"]
    require(tokens.shape == (batch, gen_len)
            and bool((runs["cold"][1]["generated"] == tokens).all()),
            "vlm: the cold and warm serves generated otherwise")
    del cparams, runs["cold"], out
    release(dev)
    f32, f32_out = vlm_routes(cfg, params, bt, gen_len, dev, "float32",
                              tokens, VLM_F32_LOGIT_ATOL)
    bf16, _ = vlm_routes(cfg, params, bt, gen_len, dev, "bfloat16", tokens,
                         None, ref=f32_out["plain"])
    require(bf16["kernel_argmax_is_fed"] == 1.0, "vlm: the kernel route "
            "fed its own greedy tokens did not give them back")
    del params, bt, f32_out
    release(dev)
    trained = train_path(dev, arch=VLM_ARCH, smoke=smoke, steps=steps,
                         batch=batch, seq=seq, counters=counters,
                         capture=train_capture,
                         route_overrides={"compute_dtype": "float32"},
                         route_tol=FRONTEND_TRAIN_TOL, tag="vlm train")
    return {"warm": runs["warm"][0], "bfloat16": bf16, "float32": f32,
            "train": trained}


def audio_forward(cfg, cparams, frames, dev) -> tuple:
    """``model.forward`` over ``frames`` and ``logits_from_hidden`` at
    every frame, no grad: (logits (B, S, V) float32, seconds)."""
    import torch
    from repro_torch.models import model
    device_sync(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        h, _ = model.forward(cfg, cparams, {"frames": frames})
        logits = model.logits_from_hidden(cfg, cparams, h)
    device_sync(dev)
    return logits, time.perf_counter() - t0


def audio_path(dev, *, smoke: bool = False, batch: int = TRAIN_BATCH,
               seq: int = TRAIN_SEQ, steps: int = TRAIN_STEPS,
               counters: dict | None = None, capture=None,
               train_capture=None) -> dict:
    """Phase 12, AUDIO_ARCH at full width: the frames of batch 0 of
    ``data.pipeline`` through ``model.forward`` and ``logits_from_hidden``,
    cold and warm (``counters``: the flash wrapper, once per layer, no
    decode; ``capture`` sees the cold run's calls); the kernel route
    against the plain route in float32 (within AUDIO_F32_LOGIT_ATOL) and
    bf16 (printed, with each bf16 route's distance from the float32
    plain route); then the float32 training routes and
    ``launch.train.train`` (``train_path``)."""
    import torch
    from repro_torch.data.pipeline import batch_at
    from repro_torch.models import model
    cfg, params = init_model("audio", AUDIO_ARCH, dev, smoke)
    frames = batch_at(cfg, 0, batch=batch, seq=seq, seed=SEED,
                      device=dev)["frames"]
    want = {**{k: 0 for k in counters or {}},
            "flash_attention": cfg.num_layers}
    cparams = model.compute_params(cfg, params)
    runs = {}
    for label in ("cold", "warm"):
        for w in (counters or {}).values():
            w.launches = 0
        reset_peak(dev)
        with capture if capture is not None and label == "cold" \
                else contextlib.nullcontext():
            logits, sec = audio_forward(cfg, cparams, frames, dev)
        rec = {"arch": AUDIO_ARCH, "route": "kernel", "run": label,
               "batch": batch, "frames": seq, "ms": sec * 1e3,
               "frames_per_s": batch * seq / sec, "peak_mib": peak_mib(dev)}
        if counters:
            rec["launches"] = {k: w.launches for k, w in counters.items()}
            require(rec["launches"] == want, f"audio {label} forward "
                    f"launched {rec['launches']}, want {want}")
        log("audio forward " + json.dumps(rec))
        runs[label] = (rec, logits)
    require(bool(torch.equal(runs["cold"][1], runs["warm"][1])),
            "audio: the cold and warm forwards differ")
    del cparams, runs["cold"], logits
    release(dev)
    checks, shapes = {}, {"logits": (batch, seq, cfg.vocab_size)}
    for dtype, atol in (("float32", AUDIO_F32_LOGIT_ATOL),
                        ("bfloat16", None)):
        out = {}
        for route, impl in (("kernel", kernel_impl(dev)),
                            ("plain", "dense")):
            c = dataclasses.replace(cfg, compute_dtype=dtype,
                                    attn_impl=impl)
            cp = model.compute_params(c, params)
            out[route] = {"logits": audio_forward(c, cp, frames, dev)[0]}
            del cp
            release(dev)
        errs = logit_errs(out["kernel"], out["plain"], shapes,
                          f"audio {dtype}")
        checks[dtype] = {"logit_max_abs_err": errs["logits"],
                         "logit_atol": atol, "logit_abs_max": float(
                             out["plain"]["logits"].abs().max())}
        if dtype == "float32":
            ref = out["plain"]
        else:
            checks[dtype]["from_float32_plain"] = {
                route: logit_errs(out[route], ref, shapes,
                                  f"audio {dtype}")["logits"]
                for route in out}
        del out
        release(dev)
    log("audio routes " + json.dumps(checks))
    require(checks["float32"]["logit_max_abs_err"] <= AUDIO_F32_LOGIT_ATOL,
            f"audio kernel and plain routes disagree in float32: {checks}")
    del params, frames, ref
    release(dev)
    trained = train_path(dev, arch=AUDIO_ARCH, smoke=smoke, steps=steps,
                         batch=batch, seq=seq, counters=counters,
                         capture=train_capture,
                         route_overrides={"compute_dtype": "float32"},
                         route_tol=FRONTEND_TRAIN_TOL, tag="audio train")
    return {"warm": runs["warm"][0], "routes": checks, "train": trained}


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 13: the plan verifier, the linter, the dry run and remat "dots"
# ---------------------------------------------------------------------------

def captured(fn, *args) -> tuple[int, list[str]]:
    """(``fn(*args)``'s return code, the lines it printed)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue().splitlines()


def built_bytes(cfg, dev, batch: int, seq: int) -> int:
    """What the card's allocator holds more once a training run's seeded
    params, AdamW state and batch 0 are built (what ``train`` builds
    first); on the CPU (the rehearsal), their storages' bytes."""
    import torch
    from repro_torch.data.pipeline import batch_at
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.models import model
    from repro_torch.optim import adamw_init
    release(dev)
    before = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    params = model.init_params(cfg, SEED, dev)
    state = (params, adamw_init(params),
             batch_at(cfg, 0, batch=batch, seq=seq, seed=SEED, device=dev))
    grown = (torch.cuda.memory_allocated(dev) - before if dev.type == "cuda"
             else tree_bytes(state))
    del params, state
    release(dev)
    return grown


def tooling_path(dev, *, smoke: bool = False, counters: dict | None = None,
                 full: dict | None = None, cells: list | None = None,
                 budget: int | None = None, jobs: int = DRYRUN_JOBS,
                 steps: int = TRAIN_STEPS, batch: int = TRAIN_BATCH,
                 seq: int = TRAIN_SEQ, route_batch: int = DOTS_ROUTE_BATCH,
                 overrides: dict | None = None) -> dict:
    """Phase 13. (a) ``core.analysis.verify`` on ``dev``: exit 0 and an
    ``ok`` line for each of Q1–Q12; (b) the linter over the port and this
    script: no finding; (c) the dry run (``launch/dryrun.py``) over
    ``cells`` (default every supported cell) and over phase 9's own cell
    (``TRAIN_ARCH``, ``batch`` x ``seq``, its microbatches) under remat
    "full" and "dots", in ``jobs`` processes; that cell's argument bytes
    must equal what building its params, AdamW state and batch adds on
    the card within DRYRUN_ARG_RTOL, and its estimated peaks are printed
    beside the measured peaks of (d) and of phase 9 (``full``, that
    phase's summary); (d) ``remat_policy="dots"`` held against "full"
    in float32 on the kernel route (``route_grads``, DOTS_TRAIN_TOL) at
    ``route_batch``, then ``steps`` training steps through
    ``train_path`` under "dots", beside phase 9's. ``overrides``: config
    fields of every model here (the rehearsal's head_dim and remat)."""
    from repro_torch.configs import (ARCHS, SHAPES, get_config,
                                     get_smoke_config, supported)
    from repro_torch.core.analysis import lint, verify
    from repro_torch.launch import dryrun
    over = overrides or {}
    t0 = time.perf_counter()
    rc, lines = captured(verify.run, ["--device", dev.type])
    for line in lines:
        log(f"verify {line}")
    oks = sum(line.startswith("ok ") for line in lines)
    require(rc == 0 and oks == 12, f"verify: exit {rc}, {oks} ok lines")
    release(dev)
    rc, lines = captured(lint.main, [str(ROOT / "src" / "repro_torch"),
                                     str(ROOT / "chip_smoke.py")])
    for line in lines:
        log(f"lint {line}")
    require(rc == 0, f"lint: exit {rc}")
    log(f"tooling verify and lint ok ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    cfg = dataclasses.replace(
        get_smoke_config(TRAIN_ARCH) if smoke else get_config(TRAIN_ARCH),
        **over)
    budget = budget or dryrun.device_bytes()
    if cells is None:
        cells = [(a, s) for a in ARCHS for s in SHAPES if supported(a, s)]
    own = {"batch": batch, "seq": seq,
           "microbatches": cfg.train_microbatches}
    policies = ("full", "dots")
    recs = dryrun.run_cells(
        list(cells) + [(TRAIN_ARCH, "train_4k",
                        {**own, "overrides": {**over, "remat_policy": p}})
                       for p in policies],
        jobs=jobs, budget=budget, smoke=smoke, overrides=over or None)
    require(all(r is not None for r in recs),
            f"dry run: {sum(r is None for r in recs)} of {len(recs)} cells "
            "failed")
    cell = dict(zip(policies, recs[-2:]))
    args = cell["full"]["memory"]["argument_bytes"]
    grown = built_bytes(cfg, dev, batch, seq)
    arg_rec = {"arch": TRAIN_ARCH, "batch": batch, "seq": seq,
               "argument_bytes": args,
               "by_part": cell["full"]["memory"]["argument_bytes_by_part"],
               "allocated_bytes": grown,
               "rel_err": abs(grown - args) / args,
               "rtol": DRYRUN_ARG_RTOL}
    log("dryrun arguments " + json.dumps(arg_rec))
    require(cell["dots"]["memory"]["argument_bytes"] == args,
            "dry run: the policies' argument bytes differ")
    require(arg_rec["rel_err"] <= DRYRUN_ARG_RTOL,
            f"dry run: argument bytes {args} against {grown} allocated")
    log(f"dryrun ok: {len(recs)} cells ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    impl = kernel_impl(dev)
    route = route_grads(
        dataclasses.replace(cfg, compute_dtype="float32"), dev, route_batch,
        seq, impl, DOTS_TRAIN_TOL,
        routes=(("dots", {"attn_impl": impl, "remat_policy": "dots"}),
                ("full", {"attn_impl": impl, "remat_policy": "full"})))
    release(dev)
    dots = train_path(dev, smoke=smoke, steps=steps, batch=batch, seq=seq,
                      counters=counters, route_check=False,
                      overrides={**over, "remat_policy": "dots"},
                      tag="train dots")
    peaks = {p: {"estimated_mib":
                 cell[p]["memory"]["estimated_peak_bytes"] / 2**20}
             for p in policies}
    for p, run in (("full", full), ("dots", dots)):
        if run is not None and run["peak_mib"]:
            peaks[p]["measured_mib"] = run["peak_mib"]
            peaks[p]["measured_over_estimated"] = (
                run["peak_mib"] / peaks[p]["estimated_mib"])
    keys = ("warm_ms", "tokens_per_s", "mfu", "peak_mib",
            "launches_per_step")
    compare = {"dots": {k: dots[k] for k in keys},
               "full": {k: full[k] for k in keys} if full else None,
               "peaks": peaks}
    log("train dots vs full " + json.dumps(compare))
    log(f"train dots ok ({time.perf_counter() - t0:.1f} s)")
    return {"dryrun": recs, "arguments": arg_rec, "routes": route,
            "dots": dots, "compare": compare}


# ---------------------------------------------------------------------------
# phase 14: the LM mesh (FSDP over a one-rank group), the pod-mesh dry run
# ---------------------------------------------------------------------------

def fsdp_route_check(cfg, dev, mesh, batch: int, seq: int) -> dict:
    """``steps.value_and_grad`` of the same seeded params and batch 0 in
    one process and through the sharded path (``launch/fsdp.Layout`` on
    ``mesh``, the gradients gathered whole): the loss, the global norm
    (summed over shards), a MoE model's ``moe_aux`` and every leaf, bit
    for bit, else each within FSDP_ROUTE_RTOL of its own largest
    |value|. The record's ``holds`` says which."""
    import torch
    from repro_torch.data.pipeline import batch_at
    from repro_torch.launch import fsdp
    from repro_torch.models import model, steps
    from repro_torch.optim.adamw import global_norm
    params = model.init_params(cfg, SEED, dev)
    bt = batch_at(cfg, 0, batch=batch, seq=seq, seed=SEED, device=dev)
    t0 = time.perf_counter()
    loss0, parts0, g0 = steps.value_and_grad(cfg, params, bt)
    n0 = global_norm(g0)
    t1 = time.perf_counter()
    layout = fsdp.Layout(cfg, mesh)
    loss1, parts1, g1 = steps.value_and_grad(cfg, layout.shard(params), bt,
                                             layout=layout)
    n1 = global_norm(g1, layout.norm_groups(g1))
    g1 = layout.full(g1)
    t2 = time.perf_counter()
    del params
    pairs = list(zip(model_paths(g0), model._leaves(g0),
                     model._leaves(g1)))
    unequal = [p for p, a, b in pairs if not torch.equal(a, b)]
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                 1e-30)
                for _, a, b in pairs)
    scalars = {"loss": (loss0, loss1), "grad_norm": (n0, n1)}
    if cfg.num_experts:
        scalars["moe_aux"] = (parts0["moe_aux"], parts1["moe_aux"])
    equal = {k: bool(torch.equal(a, b)) for k, (a, b) in scalars.items()}
    rel = max(abs(float(b) - float(a)) / abs(float(a))
              for a, b in scalars.values())
    rec = {"arch": cfg.name, "compute_dtype": cfg.compute_dtype,
           "batch": batch, "seq": seq, "leaves": len(pairs),
           **{k: {"one": float(a), "mesh": float(b)}
              for k, (a, b) in scalars.items()},
           "loss_equal": equal["loss"], "norm_equal": equal["grad_norm"],
           **({"aux_equal": equal["moe_aux"]} if "moe_aux" in equal
              else {}),
           "unequal_leaves": unequal, "grad_leaf_rel_err": worst,
           "scalar_rel_err": rel,
           "holds": ("bit for bit" if all(equal.values()) and not unequal
                     else "within rtol"),
           "rtol": FSDP_ROUTE_RTOL, "one_s": t1 - t0, "mesh_s": t2 - t1}
    log("fsdp routes " + json.dumps(rec))
    del g0, g1
    require(rel <= FSDP_ROUTE_RTOL and worst <= FSDP_ROUTE_RTOL,
            f"fsdp routes disagree: {rec}")
    return rec


def fsdp_save_check(dev, mesh, overrides: dict | None = None) -> dict:
    """``launch.train.train`` of TRAIN_ARCH's smoke config on ``mesh``
    with a sharded checkpoint at its last step, then that checkpoint
    restored onto the mesh's blocks (``restore_latest`` with
    ``shardings``): params and AdamW state equal bit for bit."""
    import tempfile
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import fsdp
    from repro_torch.launch.mesh import named, opt_specs
    from repro_torch.launch.train import train
    from repro_torch.models import model
    from repro_torch.optim import adamw_init
    cfg = dataclasses.replace(get_smoke_config(TRAIN_ARCH),
                              **(overrides or {}))
    with tempfile.TemporaryDirectory() as tmp:
        out = train(TRAIN_ARCH, smoke=True, steps=FSDP_SAVE["steps"],
                    batch=FSDP_SAVE["batch"], seq=FSDP_SAVE["seq"],
                    ckpt_dir=tmp, ckpt_every=FSDP_SAVE["ckpt_every"],
                    seed=SEED, device=dev, log_every=100,
                    overrides=overrides, mesh=mesh)
        layout = fsdp.Layout(cfg, mesh)
        like = layout.shard(model.abstract_params(cfg))
        shardings = named(mesh, {"params": layout.specs,
                                 "opt": opt_specs(layout.specs)})
        step, state = CheckpointManager(tmp).restore_latest(
            {"params": like, "opt": adamw_init(like)}, dev, shardings)
    saved = {"params": out["params"], "opt": out["opt"]}
    pairs = list(zip(model._leaves(saved), model._leaves(state)))
    unequal = sum(not torch.equal(a, b) for a, b in pairs)
    rec = {"arch": TRAIN_ARCH, "smoke": True, "step": step,
           "leaves": len(pairs), "unequal_leaves": unequal,
           "stored_numel": fsdp.numel(saved), "losses": out["losses"]}
    log("fsdp save " + json.dumps(rec))
    require(step == FSDP_SAVE["steps"] and unequal == 0,
            f"fsdp save and restore differ: {rec}")
    return rec


def fsdp_moe_path(dev, mesh, *, smoke: bool, counters: dict | None,
                  full: dict | None, steps: int, batch: int, seq: int,
                  route_batch: int) -> dict:
    """Phase 14e on ``mesh``: MOE_ARCH trained through
    ``launch.train.train(..., mesh=)`` as phase 10 trains it
    (``train_path``), printed beside phase 10's (``full``); then its
    float32 gradients at ``route_batch`` x ``seq`` against the
    one-process ones (``fsdp_route_check``: loss, norm, ``moe_aux`` and
    every leaf)."""
    from repro_torch.configs import get_config, get_smoke_config
    t0 = time.perf_counter()
    trained = train_path(dev, arch=MOE_ARCH, smoke=smoke, steps=steps,
                         batch=batch, seq=seq, counters=counters,
                         route_check=False, tag="fsdp moe train", mesh=mesh)
    keys = ("warm_ms", "tokens_per_s", "mfu", "peak_mib",
            "launches_per_step")
    log("fsdp moe train vs phase 10 " + json.dumps(
        {"fsdp": {k: trained[k] for k in keys},
         "phase10": {k: full[k] for k in keys} if full else None}))
    cfg = get_smoke_config(MOE_ARCH) if smoke else get_config(MOE_ARCH)
    route = fsdp_route_check(
        dataclasses.replace(cfg, compute_dtype="float32",
                            attn_impl=kernel_impl(dev)),
        dev, mesh, route_batch, seq)
    release(dev)
    log(f"fsdp moe ok: gradients {route['holds']}, largest leaf difference "
        f"{route['grad_leaf_rel_err']} ({time.perf_counter() - t0:.1f} s)")
    return {"train": trained, "routes": route}


def fsdp_path(dev, backend: str, *, smoke: bool = False,
              counters: dict | None = None, full: dict | None = None,
              moe_full: dict | None = None,
              steps: int = TRAIN_STEPS, batch: int = TRAIN_BATCH,
              seq: int = TRAIN_SEQ, route_batch: int = FSDP_ROUTE_BATCH,
              overrides: dict | None = None, smoke_overrides: dict | None
              = None, cells: list | None = None) -> dict:
    """Phase 14, over an in-process process group of one rank
    (``backend``: NCCL on the card, gloo in the CPU rehearsal) and its
    (1, 1) ``("data", "model")`` mesh (``launch.mesh.make_host_mesh``):
    (a) TRAIN_ARCH trained through ``launch.train.train(..., mesh=)``
    as phase 9 trains it (``train_path``: steps, ms, MFU, peak, flash
    launches a step), printed beside phase 9's (``full``); (b) the
    sharded gradients against the one-process ones in float32 at
    ``route_batch`` x ``seq`` (``fsdp_route_check``); (c) a sharded save
    and restore at the smoke config (``fsdp_save_check``;
    ``smoke_overrides``, e.g. the card's head_dim); (e) MOE_ARCH trained
    and checked the same way (``fsdp_moe_path``, beside phase 10's
    ``moe_full``); then, after the group is gone, (d) the dry run of
    ``cells`` (default every supported cell) on the pod meshes 16 x 16
    and 2 x 16 x 16 (host only). Nothing is caught: a failure fails the
    phase. ``overrides``: config fields of (a) and (b)."""
    import torch.distributed as dist
    from repro_torch.configs import (ARCHS, SHAPES, get_config,
                                     get_smoke_config, supported)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    over = overrides or {}
    cfg = dataclasses.replace(
        get_smoke_config(TRAIN_ARCH) if smoke else get_config(TRAIN_ARCH),
        **over)
    dist.init_process_group(backend, init_method="tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_host_mesh(device=dev)
        require(tuple(mesh.shape) == (1, 1)
                and mesh.mesh_dim_names == ("data", "model"),
                f"fsdp mesh {mesh}")
        log(f"fsdp mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} "
            f"({dist.get_backend()})")
        t0 = time.perf_counter()
        trained = train_path(dev, smoke=smoke, steps=steps, batch=batch,
                             seq=seq, counters=counters, route_check=False,
                             overrides=over, tag="fsdp train", mesh=mesh)
        keys = ("warm_ms", "tokens_per_s", "mfu", "peak_mib",
                "launches_per_step")
        log("fsdp train vs phase 9 " + json.dumps(
            {"fsdp": {k: trained[k] for k in keys},
             "phase9": {k: full[k] for k in keys} if full else None}))
        log(f"fsdp train ok ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        route = fsdp_route_check(
            dataclasses.replace(cfg, compute_dtype="float32",
                                attn_impl=kernel_impl(dev)),
            dev, mesh, route_batch, seq)
        release(dev)
        saved = fsdp_save_check(dev, mesh, smoke_overrides)
        release(dev)
        log(f"fsdp routes and save ok ({time.perf_counter() - t0:.1f} s)")
        moe = fsdp_moe_path(dev, mesh, smoke=smoke, counters=counters,
                            full=moe_full, steps=steps, batch=batch,
                            seq=seq, route_batch=route_batch)
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    if cells is None:
        cells = [(a, s) for a in ARCHS for s in SHAPES if supported(a, s)]
    recs = dryrun.run_mesh_cells(cells, [False, True])
    require(all(r is not None for r in recs),
            f"pod-mesh dry run: {sum(r is None for r in recs)} of "
            f"{len(recs)} cells failed")
    log(f"fsdp dryrun ok: {len(recs)} cells on 16x16 and 2x16x16 "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"train": trained, "routes": route, "save": saved, "moe": moe,
            "dryrun": recs}


# ---------------------------------------------------------------------------
# phase 15: the dense archs served at full width
# ---------------------------------------------------------------------------

def dense_path(dev, arch: str, *, smoke: bool = False,
               requests: int | None = None, prompt_len: int | None = None,
               gen_len: int = LM_GEN, f32_layers: int | None = None,
               counters: dict | None = None, capture=None) -> dict:
    """Phase 15, one of DENSE_ARCHS at its published width and depth
    through ``serve_phase`` with DENSE_TRAFFIC's requests: the bf16
    plain route printed (bf16 noise through 32-48 layers is bounded by
    nothing that would show a fault), the gate in float32 at
    DENSE_F32_LAYERS within DENSE_F32_LOGIT_ATOL."""
    req, plen = DENSE_TRAFFIC[arch]
    return serve_phase(
        dev, arch, (requests or req, prompt_len or plen, gen_len),
        Gate(DENSE_F32_LOGIT_ATOL[arch],
             f32_layers or DENSE_F32_LAYERS[arch]),
        tag=f"dense {arch}", smoke=smoke, counters=counters, capture=capture)


# ---------------------------------------------------------------------------
# phase 16: llama4-scout and jamba served at full width, cut depth
# ---------------------------------------------------------------------------

def moe_wide_path(dev, arch: str, *, smoke: bool = False,
                  requests: int = LM_REQUESTS, prompt_len: int = LM_PROMPT,
                  gen_len: int = LM_GEN, overrides: dict | None = None,
                  f32_layers: int | None = None,
                  f64_tokens: int = MOE_WIDE_F64_TOKENS,
                  counters: dict | None = None, capture=None) -> dict:
    """Phase 16, one of MOE_WIDE_ARCHS at its published width and
    MOE_WIDE_LAYERS layers (the smoke config's own depth with ``smoke``;
    ``overrides``: more config fields) through ``serve_phase`` with
    phase 5's traffic: cold and warm tokens and expert ids equal, the
    bf16 plain route printed with its share of differing routing
    decisions, the gate in float32 at MOE_WIDE_F32_LAYERS with the plain
    route routed as the kernel route (MOE_WIDE_F32_LOGIT_ATOL), and
    ``moe_f64_check`` on the first MoE layer of that float32 model."""
    over = {} if smoke else {"num_layers": MOE_WIDE_LAYERS[arch]}
    return serve_phase(
        dev, arch, (requests, prompt_len, gen_len),
        Gate(MOE_WIDE_F32_LOGIT_ATOL[arch],
             f32_layers or MOE_WIDE_F32_LAYERS[arch]),
        tag=f"moe-wide {arch}", smoke=smoke,
        overrides={**over, **(overrides or {})}, f64_tokens=f64_tokens,
        counters=counters, capture=capture)


# ---------------------------------------------------------------------------
# phase 17: the tensor-parallel split of one layer, every rank in turn
# ---------------------------------------------------------------------------

def tp_layer_path(dev, arch: str, *, smoke: bool = False,
                  overrides: dict | None = None, batch: int = TP_TOKENS[0],
                  seq: int = TP_TOKENS[1], counters: dict | None = None,
                  capture=None, card: str | None = None) -> dict:
    """Phase 17, one of TP_ARCHS: its first layer (gemma3's is local;
    jamba's and mamba2-370m's a Mamba-2 mixer, whose heads split, its
    gated norm's statistic summed over the ranks) at published width
    (the smoke config with ``smoke``; ``overrides``: more fields),
    seeded weights (norm scales, and a Mamba-2 mixer's dt_bias, D and
    conv_b, drawn too) and ``batch`` x
    ``seq`` seeded inputs and output gradient, run whole
    (``model._apply_block``) and split over TP_RANKS ``model`` ranks as
    ``fsdp.Layout`` splits it on a mesh, each rank's share computed in
    turn with the partials summed in float32 where the collectives would
    sum them (``fsdp.split_in_turn``), in float32 and in bfloat16: the
    output, the input gradient and each weight gradient against the
    whole layer's (TP_TOL). The attention runs the kernel on the card
    (the plain route on the CPU): the split launches the flash forward
    and backward once a rank, on its H/m heads (``counters``: the
    wrappers, their ``launches`` reset here; ``capture``: ``LastFlash``,
    whose last call must have H/m heads); a mixer layer launches no
    kernel. Then one rank's share of the layer, forward and backward,
    timed beside the whole layer (``card``: the nvidia-smi name and
    power limit)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import ssm as ssm_lib
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    cfg = dataclasses.replace(
        cfg, attn_impl="auto" if dev.type == "cuda" else "dense",
        **(overrides or {}))
    spec, layer32 = tp_layer_weights(cfg, dev)
    shape = (batch, seq, cfg.d_model)
    counters = counters or {}
    rec = {"arch": cfg.name, "ranks": TP_RANKS, "tokens": [batch, seq],
           "d_model": cfg.d_model, "heads": [cfg.num_heads,
                                             cfg.num_kv_heads],
           "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
           "mixer": spec.mixer, "window": cfg.window or None,
           "qk_norm": cfg.qk_norm}
    if spec.mixer == "mamba":
        d_inner, nheads = ssm_lib.ssm_dims(cfg.d_model, cfg.ssm_expand,
                                           cfg.ssm_head_dim)
        rec.update({"heads": None, "head_dim": None, "d_inner": d_inner,
                    "ssm_heads": nheads, "ssm_head_dim": cfg.ssm_head_dim,
                    "ssm_state": cfg.ssm_state, "ssm_chunk": cfg.ssm_chunk})
    if spec.mlp != "dense":
        rec["d_ff"] = None
    t0 = time.perf_counter()
    with capture if capture is not None else contextlib.nullcontext():
        for dtype in ("float32", "bfloat16"):
            rec[dtype] = _tp_layer_check(dev, cfg, dtype, spec, layer32,
                                         shape, counters, capture, rec)
    if dev.type == "cuda":
        rec["card"] = card
    rec["seconds"] = time.perf_counter() - t0
    log(f"tp layer {arch} " + json.dumps(rec))
    return rec


def tp_layer_weights(cfg, dev) -> tuple:
    """(spec, float32 weights) of phase 17's layer, ``cfg``'s first,
    drawn from SEED: as ``model._init_block`` draws them, with the norm
    scales and a Mamba-2 mixer's dt_bias, D and conv_b drawn too."""
    from repro_torch.models import model
    spec = cfg.layer_spec(0)
    g = _gen(SEED, dev)
    layer32 = model._init_block(cfg, spec, g, dev)
    for path, t in zip(model_paths(layer32), model._leaves(layer32)):
        if path.endswith(("scale", "dt_bias", "/D", "conv_b")):
            t.normal_(1.0 if path.endswith("/D") else 0.0, 0.1,
                      generator=g)
    return spec, layer32


def tp_layer_inputs(cfg, dev, shape, dtype) -> tuple:
    """(x, dy, positions) of phase 17's layer: ``shape`` = (batch, seq,
    d_model) seeded inputs and output gradient in ``dtype``, x requiring
    its gradient."""
    import torch
    x = normal(shape, SEED + 1, dev, dtype).requires_grad_()
    dy = normal(shape, SEED + 2, dev, dtype)
    positions = torch.arange(shape[1], device=dev).expand(shape[:2])
    return x, dy, positions


def tp_sublayers(spec) -> tuple:
    """The sublayers of a layer of ``spec`` that phase 17 splits."""
    mixer = "attn" if spec.mixer.startswith("attn") else "mamba"
    return (mixer,) + (("mlp",) if spec.mlp == "dense" else ())


def _tp_layer_check(dev, cfg, dtype: str, spec, layer32, shape,
                    counters: dict, capture, rec: dict) -> dict:
    """``tp_layer_path`` in one compute dtype: the record of the whole
    and the split layer's agreement and launches; in bfloat16 on the
    card also ``rec["ms"]``."""
    import torch
    from repro_torch.launch import fsdp
    from repro_torch.models import model
    arch, batch = cfg.name, shape[0]
    c = dataclasses.replace(cfg, compute_dtype=dtype)
    layer = model.tree_map(
        lambda t: t.detach().to(c.cdtype).requires_grad_(), layer32)
    leaves = list(model._leaves(layer))
    x, dy, positions = tp_layer_inputs(c, dev, shape, c.cdtype)
    tree, split = fsdp.split_in_turn(c, 0, layer, TP_RANKS)
    require(split.sublayers == tp_sublayers(spec),
            f"{arch}: the layer splits {split.sublayers} over {TP_RANKS}")

    def run(p, sp):
        y, _ = model._apply_block(c, spec, p, x, positions, None, sp)
        return y, torch.autograd.grad(y, [x] + leaves, dy)

    def counts():
        return {k: w.launches for k, w in counters.items()}

    for w in counters.values():
        w.launches = 0
    y0, g0 = run(layer, None)
    whole = counts()
    for w in counters.values():
        w.launches = 0
    y1, g1 = run(tree, split)
    launches = counts()
    errs = {"out": _rel(y1, y0), "x": _rel(g1[0], g0[0])}
    errs.update({p: _rel(a, b) for p, a, b in zip(
        model_paths(layer), g1[1:], g0[1:])})
    finite = all(bool(torch.isfinite(t).all()) for t in (y1, *g1))
    flash = ("flash_attention", "flash_attention_bwd")
    want = {k: TP_RANKS * (k in flash and dev.type == "cuda"
                           and "attn" in split.sublayers)
            for k in launches}
    require(whole == {k: v // TP_RANKS for k, v in want.items()},
            f"{arch} whole layer in {dtype}: the kernels launched "
            f"{whole}")
    heads = None
    if capture is not None and capture.call is not None:
        heads = tuple(capture.call[0].shape[:2])
    out = {"max_rel_err": errs, "worst": max(errs.values()),
           "finite": finite, "launches_split": launches,
           "launches_whole": whole, "flash_q_batch_heads": heads}
    del y0, y1, g0, g1
    require(finite and out["worst"] <= TP_TOL[dtype],
            f"{arch} split layer in {dtype} disagrees with the whole "
            f"one: {out}")
    require(launches == want, f"{arch} split layer in {dtype}: the "
            f"kernels launched {launches}, want {want}")
    require(heads is None or heads == (batch, cfg.num_heads // TP_RANKS),
            f"{arch}: the flash kernel ran on (B, H) {heads}, not on "
            f"each rank's {cfg.num_heads // TP_RANKS} heads")
    if dev.type == "cuda" and dtype == "bfloat16":
        one = {**tree, **{k: tree[k][:1] for k in split.sublayers}}
        rec["ms"] = {"whole": cuda_ms(lambda: run(layer, None)),
                     "one_rank": cuda_ms(lambda: run(one, split))}
        rec["ms"]["one_rank_x_ranks_over_whole"] = (
            rec["ms"]["one_rank"] * TP_RANKS / rec["ms"]["whole"])
    del layer, leaves, tree, x, dy
    release(dev)
    return out


def tp_vocab_path(dev, arch: str, *, smoke: bool = False,
                  batch: int = TP_TOKENS[0], seq: int = TP_TOKENS[1],
                  card: str | None = None) -> dict:
    """Phase 17's vocabulary split, one of TP_VOCAB_ARCHS at published
    width (the smoke config with ``smoke``): seeded tables as
    ``model.init_params`` draws them (``embed``, and ``lm_head`` where
    untied), ``batch`` x ``seq`` seeded tokens, labels and hidden
    states, every rank's share computed in turn (``fsdp.vocab_in_turn``)
    against the whole table, in float32 and in bfloat16: the lookup's
    rows (``model._embed_tokens``) bit for bit, its table gradient, the
    loss (``layers.chunked_cross_entropy_sums`` with the config's chunks
    and softcap), its input gradient and its table gradient within
    TP_TOL. Then on the card, in bfloat16, one rank's share of the loss,
    forward and backward, timed beside the whole loss, with the peak
    memory of each (``card``: the nvidia-smi name and power limit)."""
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import fsdp
    from repro_torch.models import layers
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    v, d = cfg.vocab_size, cfg.d_model
    g = _gen(SEED + 3, dev)
    tables = {"embed": layers.embed_init(g, v, d, torch.float32, dev)}
    if not cfg.tie_embeddings:
        tables["lm_head"] = layers.dense_init(g, d, v, torch.float32, dev)
    n = v // TP_RANKS
    edges = torch.tensor([e for r in range(TP_RANKS)
                          for e in (r * n, r * n + n - 1)], device=dev)
    tokens = torch.randint(0, v, (batch, seq), generator=g, device=dev)
    tokens.view(-1)[:edges.numel()] = edges
    labels = torch.randint(0, v, (batch * seq,), generator=g, device=dev)
    labels[::TP_VOCAB_UNLABELED] = -1
    labels[edges.numel():2 * edges.numel()] = edges
    cap = cfg.final_logit_softcap or None
    rec = {"arch": cfg.name, "ranks": TP_RANKS, "tokens": [batch, seq],
           "vocab": v, "d_model": d, "tied": cfg.tie_embeddings,
           "final_softcap": cap, "chunks": cfg.ce_chunks,
           "labeled": int((labels >= 0).sum())}
    t0 = time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        rec[dtype] = _tp_vocab_check(dev, c, dtype, tables, tokens, labels,
                                     cap, rec)
    if dev.type == "cuda":
        rec["card"] = card
    rec["seconds"] = time.perf_counter() - t0
    log(f"tp vocab {arch} " + json.dumps(rec))
    return rec


def _tp_vocab_check(dev, c, dtype: str, tables: dict, tokens, labels, cap,
                    rec: dict) -> dict:
    """``tp_vocab_path`` in one compute dtype: the record of the split's
    agreement with the whole; in bfloat16 on the card also
    ``rec["ms"]`` and ``rec["peak_mib"]``."""
    import torch
    from repro_torch.launch import fsdp
    from repro_torch.models import layers, model
    head32 = tables.get("lm_head")
    head32 = tables["embed"] if head32 is None else head32.T
    x = normal((tokens.numel(), c.d_model), SEED + 4, dev, c.cdtype)
    dy = normal(tuple(tokens.shape) + (c.d_model,), SEED + 5, dev, c.cdtype)

    def lookup(split: bool):
        t = tables["embed"].detach().requires_grad_()
        blocks, vocab = (fsdp.vocab_in_turn(c, t, TP_RANKS) if split
                          else (t, None))
        rows = model._embed_tokens(c, {"embed": blocks}, tokens, vocab)
        return rows, torch.autograd.grad(rows, t, dy)[0]

    def loss(head, xs, vocab):
        tot, cnt = layers.chunked_cross_entropy_sums(
            xs, head, labels, c.ce_chunks, cap, vocab=vocab)
        return tot / cnt

    def run(split: bool):
        t = head32.detach().requires_grad_()
        xs = x.detach().requires_grad_()
        head, vocab = t.to(c.cdtype), None
        if split:
            head, vocab = fsdp.vocab_in_turn(c, head, TP_RANKS)
        out = loss(head, xs, vocab)
        return (out.detach(),) + torch.autograd.grad(out, [xs, t])

    rows0, gl0 = lookup(False)
    rows1, gl1 = lookup(True)
    errs = {"lookup_table": _rel(gl1, gl0)}
    out = {"lookup_equal": bool(torch.equal(rows1, rows0)),
           "lookup_table_grad_equal": bool(torch.equal(gl1, gl0))}
    del rows0, gl0, rows1, gl1
    w = run(False)
    s = run(True)
    errs.update({k: _rel(a, b) for k, a, b in zip(("loss", "x", "table"),
                                                  s, w)})
    out.update({"max_rel_err": errs, "worst": max(errs.values()),
                "finite": all(bool(torch.isfinite(t).all()) for t in s),
                "loss": float(s[0])})
    del w, s
    release(dev)
    require(out["finite"] and out["lookup_equal"]
            and out["worst"] <= TP_TOL[dtype],
            f"{c.name} split vocabulary in {dtype} disagrees with the whole "
            f"one: {out}")
    if dev.type == "cuda" and dtype == "bfloat16":
        # one rank's share holds its block alone, as a rank of the mesh
        whole = head32.detach().to(c.cdtype).requires_grad_()
        n = whole.shape[0] // TP_RANKS
        block = whole.detach()[:n].clone().requires_grad_()
        runs = {"whole": (whole, whole, None),
                "one_rank": ([block], block,
                             fsdp.VocabSplit(None, [(0, n)]))}
        xs = x.detach().requires_grad_()
        rec["ms"], rec["peak_mib"] = {}, {}
        for k, (head, leaf, vocab) in runs.items():
            def step(head=head, leaf=leaf, vocab=vocab):
                return torch.autograd.grad(loss(head, xs, vocab), [xs, leaf])

            device_sync(dev)
            resident = torch.cuda.memory_allocated(dev) / 2**20
            reset_peak(dev)
            step()
            device_sync(dev)
            rec["peak_mib"][k] = {"peak": peak_mib(dev),
                                  "resident": resident}
            rec["ms"][k] = cuda_ms(step)
        rec["ms"]["one_rank_x_ranks_over_whole"] = (
            rec["ms"]["one_rank"] * TP_RANKS / rec["ms"]["whole"])
        del runs, whole, block, xs
        release(dev)
    del x, dy
    return out


# ---------------------------------------------------------------------------
# phase 18: the serve over a mesh, every rank in turn
# ---------------------------------------------------------------------------

class PartialCalls:
    """Keeps the arguments of every ``ops.decode_attention_partial`` call
    (each rank's slice, in turn) by standing in for it."""

    def __init__(self, ops):
        self.ops, self.calls = ops, []

    def __enter__(self):
        self.saved = self.ops.decode_attention_partial

        def kept(*a, **k):
            self.calls.append((a, k))
            return self.saved(*a, **k)

        self.ops.decode_attention_partial = kept
        return self

    def __exit__(self, *exc):
        self.ops.decode_attention_partial = self.saved


def serve_split_path(dev, arch: str, *, smoke: bool = False,
                     overrides: dict | None = None,
                     requests: int = LM_REQUESTS, prompt_len: int = LM_PROMPT,
                     gen_len: int = LM_GEN, counters: dict | None = None,
                     capture=None) -> dict:
    """Phase 18, one of SERVE_SPLIT_CASES: the first layer of ``arch`` at
    published width (the smoke config with ``smoke``; ``overrides``: more
    fields), seeded weights, a seeded cache of ``requests`` x
    (``prompt_len`` + ``gen_len``) slots and the lengths of a serve's
    first decode step (prompts of ``prompt_len`` // 2 to ``prompt_len``
    tokens, drawn as ``serve_batch`` draws them), one decode step whole
    (``model._attn_decode_block`` and the MLP) and split over
    SERVE_SPLIT_RANKS ``model`` ranks as a serve over a (1, 4) mesh
    splits it, each rank's share in turn (``fsdp.decode_in_turn``,
    ``model.decode_block``: the heads' q, k, v gathered, the new token
    written by the rank whose slice holds its slot, the decode kernel's
    partial mode on each rank's slice, the partials combined, each rank's
    rows of wo, the experts of a MoE layer by rank), in float32 and
    bf16: the output and the caches against the whole layer's
    (SERVE_SPLIT_TOL; slots not written equal bit for bit), the routes
    of a MoE layer replayed (``RouteReplay``). On the card the whole step
    launches the decode kernel once and the split one its partial mode
    once a rank (``counters``: the wrappers by name, their ``launches``
    reset here). Then, in bf16, the layer's prefill split by heads in
    turn, its caches relaid to each rank's slots
    (``fsdp.relayout_in_turn``, the all-to-all's pieces) against the
    split prefill's whole cache bit for bit and against the whole
    prefill's within SERVE_SPLIT_TOL; and the greedy argmax over the
    vocabulary split four ways, with planted ties, against
    ``torch.argmax``. ``capture``: a ``PartialCalls`` that keeps the
    partial mode's calls of the bf16 step."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import fsdp
    from repro_torch.models import model
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    cfg = dataclasses.replace(
        cfg, attn_impl="auto" if dev.type == "cuda" else "dense",
        **(overrides or {}))
    m = SERVE_SPLIT_RANKS
    spec, layer32 = tp_layer_weights(cfg, dev)
    lens = np.random.default_rng(SEED).integers(prompt_len // 2,
                                                prompt_len + 1, requests)
    kv_len = torch.as_tensor(lens + 1, dtype=torch.int32, device=dev)
    smax = prompt_len + gen_len
    counters = counters or {}
    rec = {"arch": cfg.name, "ranks": m, "requests": requests,
           "smax": smax, "kv_len": [int(x) for x in kv_len],
           "heads": [cfg.num_heads, cfg.num_kv_heads],
           "head_dim": cfg.head_dim, "window": cfg.window or None,
           "mlp": spec.mlp}
    t0 = time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        layer = model.tree_map(lambda t: t.detach().to(c.cdtype), layer32)
        cache = {k: normal((requests, smax, c.num_kv_heads, c.head_dim),
                           SEED + 3 + i, dev, c.cdtype)
                 for i, k in enumerate(("k", "v"))}
        h = normal((requests, 1, c.d_model), SEED + 5, dev, c.cdtype)
        whole_cache = {k: v.clone() for k, v in cache.items()}
        routes = RouteLog()
        for w in counters.values():
            w.launches = 0
        with torch.no_grad(), routes:
            x = model.rmsnorm(layer["ln_mixer"], h, c.norm_eps)
            out, _ = model._attn_decode_block(c, spec, layer["attn"],
                                              whole_cache, x, kv_len)
            if c.use_post_norm:
                out = model.rmsnorm(layer["post_ln_mixer"], out, c.norm_eps)
            y0 = model._mlp_part(c, spec, layer, h + out)[0]
        whole = {k: w.launches for k, w in counters.items()}
        tree, split, caches, seq, exchange = fsdp.decode_in_turn(
            c, 0, layer, cache, m)
        for w in counters.values():
            w.launches = 0
        keep = capture if capture is not None and dtype == "bfloat16" \
            else contextlib.nullcontext()
        with torch.no_grad(), RouteReplay(routes.ids) if routes.ids \
                else contextlib.nullcontext(), keep:
            y1 = model.decode_block(c, spec, tree, caches, h, kv_len, split,
                                    seq, exchange)
        launches = {k: w.launches for k, w in counters.items()}
        got = {k: torch.cat([cc[k] for cc in caches], 1) for k in cache}
        slot = torch.zeros(requests, smax, dtype=torch.bool, device=dev)
        slot[torch.arange(requests, device=dev), (kv_len - 1).long()] = True
        errs = {"out": _rel(y1, y0)}
        for k in cache:
            errs[f"cache {k}, new slot"] = _rel(got[k][slot],
                                                whole_cache[k][slot])
            require(torch.equal(got[k][~slot], whole_cache[k][~slot]),
                    f"{arch} split decode in {dtype}: the {k} cache changed "
                    "outside the new token's slot")
        card = dev.type == "cuda"
        want = {k: int(card and k == "decode_attention") for k in counters}
        want_split = {k: m * (card and k == "decode_attention_partial")
                      for k in counters}
        out = {"max_rel_err": errs, "worst": max(errs.values()),
               "finite": bool(torch.isfinite(y1).all()),
               "launches_whole": whole, "launches_split": launches,
               "slices": [list(r) for r in seq.ranges]}
        require(out["finite"] and out["worst"] <= SERVE_SPLIT_TOL[dtype],
                f"{arch} split decode in {dtype} disagrees with the whole "
                f"layer's: {out}")
        require(whole == want and launches == want_split,
                f"{arch} decode in {dtype}: the kernels launched {whole} "
                f"whole and {launches} split, want {want} and {want_split}")
        rec[dtype] = out
        del layer, cache, whole_cache, tree, caches, got, y0, y1
        release(dev)
    rec["relayout"] = _relayout_check(dev, cfg, spec, layer32, prompt_len,
                                      smax, m)
    rec["argmax"] = _split_argmax_check(dev, cfg.vocab_size, m)
    rec["seconds"] = time.perf_counter() - t0
    log(f"serve split {arch} " + json.dumps(rec))
    del layer32
    release(dev)
    return rec


def _relayout_check(dev, cfg, spec, layer32, prompt_len: int, smax: int,
                    m: int) -> dict:
    """``serve_split_path``'s prefill check in bf16: 2 prompts of
    ``prompt_len`` tokens through the layer split by heads over ``m``
    ranks in turn, each rank's caches relaid to every rank's slots of a
    cache of ``smax`` (``fsdp.relayout_in_turn``) against the split
    prefill's cache (bit for bit) and against the whole layer's
    (SERVE_SPLIT_TOL)."""
    import torch
    from repro_torch.launch import fsdp
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model
    from repro_torch.sharding import MeshShape
    c = dataclasses.replace(cfg, compute_dtype="bfloat16")
    layer = model.tree_map(lambda t: t.detach().to(c.cdtype), layer32)
    x = normal((2, prompt_len, c.d_model), SEED + 7, dev, c.cdtype)
    positions = torch.arange(prompt_len, device=dev).expand(2, prompt_len)
    tree, split = fsdp.split_in_turn(c, 0, layer, m)
    exchange = None
    if "moe" in tree:
        tree["moe"], exchange = fsdp.moe_in_turn(tree["moe"], m)
    log_ids = RouteLog()
    with torch.no_grad(), log_ids:
        _, _, whole = model._apply_block_with_cache(c, spec, layer, x,
                                                    positions)
    with torch.no_grad(), RouteReplay(log_ids.ids):
        _, _, mine = model._apply_block_with_cache(
            c, spec, tree, x, positions, exchange, split, split_cache=True)
    kv = torch.stack([mine["k"], mine["v"]])
    mesh = MeshShape((1, m), (mesh_lib.FSDP, mesh_lib.TP))
    kv_spec = mesh_lib.cache_specs(c, mesh, model.init_cache(
        c, 2, smax, "meta"))[0]["k"]
    ranges = [mesh_lib.seq_range(kv_spec, mesh, (0, r), smax)
              for r in range(m)]
    got = fsdp.relayout_in_turn(list(kv.chunk(m, 3)), ranges, prompt_len)
    for (lo, _), g in zip(ranges, got):
        require(torch.equal(g, kv[:, :, lo:lo + g.shape[2]]),
                f"{cfg.name}: the relaid slots {lo}.. differ from the split "
                "prefill's cache")
    require(sum(g.shape[2] for g in got) == prompt_len,
            f"{cfg.name}: the relayout kept {[g.shape for g in got]}")
    errs = {k: _rel(mine[k], whole[k]) for k in ("k", "v")}
    require(max(errs.values()) <= SERVE_SPLIT_TOL["bfloat16"],
            f"{cfg.name}: the split prefill's caches differ from the "
            f"whole's: {errs}")
    return {"slices": [list(r) for r in ranges],
            "prompt_slots": [g.shape[2] for g in got],
            "bit_for_bit": True, "split_vs_whole": errs}


def _split_argmax_check(dev, vocab: int, m: int) -> dict:
    """``layers.split_argmax`` over ``m`` vocabulary blocks against
    ``torch.argmax`` of the whole, on seeded float32 logits of 8 rows
    whose maxima are planted in one block, in two blocks (a tie across
    ranks), twice in one block and at a block's edges."""
    import torch
    from repro_torch.launch import fsdp
    from repro_torch.models import layers
    x = normal((8, vocab), SEED + 9, dev, torch.float32)
    n = vocab // m
    top = float(x.max()) + 1.0
    planted = [[3], [n - 1, n], [2 * n + 5, 2 * n + 9], [vocab - 1],
               [0, vocab - 1], [n, 3 * n], [5, n + 5, 2 * n + 5, 3 * n + 5],
               [n + 1]]
    for row, cols in enumerate(planted):
        x[row, cols] = top
    ranges = [(r * n, (r + 1) * n) for r in range(m)]
    got = layers.split_argmax([x[:, lo:hi] for lo, hi in ranges],
                              fsdp.VocabSplit(None, ranges))
    want = torch.argmax(x, dim=-1)
    require(torch.equal(got.long(), want.long()),
            f"split argmax {got.tolist()} against argmax {want.tolist()}")
    return {"vocab": vocab, "blocks": m, "tokens": want.tolist()}


def partial_record(calls: list, launches: dict, edge_errs: dict,
                   where: str) -> dict:
    """The decode kernel's partial mode on the rank's slice with the most
    live slots among ``calls`` (``PartialCalls``'), beside its plain
    version and ``flex_attention(..., return_lse=True)`` compiled with the
    slice's live slots as its block mask; the bound counts those slots."""
    import torch
    from repro_torch.kernels import decode_attention, ref

    def live(call):
        (q, kc, vc, kl), kw = call
        w = kw.get("window")
        lo = (kl - w).clamp(min=0) if w else torch.zeros_like(kl)
        return int((kl.clamp(max=kc.shape[1]) - lo).clamp(min=0).sum())

    call = max(calls, key=live)
    (q, kc, vc, kl), kw = call
    dt = str(q.dtype).split(".")[1]
    b, _, hq, d = q.shape
    _, smax, hkv, _ = kc.shape
    g = hq // hkv
    dkw = dict(window=kw.get("window"), softcap=kw.get("logit_softcap"),
               scale=kw.get("scale"))
    q4 = q.reshape(b, hkv, g, d)
    k4, v4 = kc.transpose(1, 2), vc.transpose(1, 2)
    kl4 = kl[:, None].expand(b, hkv)
    qb = q.reshape(b * hkv, g, d)
    kb, vb = k4.reshape(b * hkv, smax, d), v4.reshape(b * hkv, smax, d)
    klb = torch.repeat_interleave(kl, hkv)
    got, _ = decode_attention.decode_attention_partial_bhgd(q4, k4, v4, kl4,
                                                            **dkw)
    want, _ = ref.decode_attention_partial(qb, kb, vb, klb, **dkw)
    err = attn_err(got.reshape(b * hkv, g, d), want, dt,
                   f"decode_attention_partial ({where})")
    w = dkw["window"]
    lo = (kl - w).clamp(min=0) if w else torch.zeros_like(kl)

    def slots(bb, h, qi, ki):
        return (ki < kl[bb]) & (ki >= lo[bb])
    lib = flex_call(q.transpose(1, 2), k4, v4, slots, b, dkw["softcap"],
                    dkw["scale"], return_lse=True)
    attn_err(lib()[0].reshape(b * hkv, g, d), want, dt,
             f"flex_attention ({where}), the library column's call")
    n_live = live(call) * hkv
    nbytes = 2 * n_live * d * q.element_size() + q.numel() * (
        q.element_size() + 4) + b * hq * 4 + kl.numel() * 4
    return kernel_record(
        "decode_attention_partial", launches,
        max(err, edge_errs["decode_attention_partial"]),
        lambda: decode_attention.decode_attention_partial_bhgd(
            q4, k4, v4, kl4, **dkw),
        lambda: ref.decode_attention_partial(qb, kb, vb, klb, **dkw), lib,
        nbytes, 4.0 * g * d * n_live, dt,
        {"B*Hkv": b * hkv, "G": g, "Smax_local": smax, "D": d,
         "kv_len_local": [int(x) for x in kl], "window": dkw["window"],
         "softcap": dkw["softcap"], "dtype": dt}, where=where,
        library="flex_attention", kernel="decode_attention")


def _rel(a, b) -> float:
    """Largest |a - b| over the largest |b|."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def dense_calls(arch: str, cfg, last: LastCall) -> list:
    """[(where, flash call, decode call)]: of each window the cold
    serve's last prefill layer's q/k/v and last decode step's q and
    caches (``LastCall.by_window``): gemma's local layers, where the
    window must have cut keys in prefill and in decode, and its global
    ones; llama3's layers, all global."""
    want = {None, cfg.window} if cfg.window else {None}
    got = {w for _, w in last.by_window}
    require(got == want and len(last.by_window) == 2 * len(want),
            f"{arch}: the serve called the kernels with windows "
            f"{sorted(last.by_window, key=str)}, want {want}")
    out = []
    for w in sorted(want, key=lambda x: x is None):
        fcall = last.by_window["flash_attention", w]
        dcall = last.by_window["decode_attention", w]
        where = f"{arch} serve"
        if cfg.window:
            where += f", local (window {w})" if w else ", global"
        if w:
            sq, longest = fcall[0][0].shape[1], int(dcall[0][3].max())
            require(sq > w and longest > w, f"{arch}: the window {w} cut "
                    f"no key (prefill {sq}, longest decode {longest})")
        out.append((where, fcall, dcall))
    return out


def dense_kernel_timings(arch: str, cfg, last: LastCall, by_window: dict,
                         edge_errs: dict) -> list:
    """Phase 15's flash and decode rows on ``dense_calls``' inputs, each
    with the launches of its window in the warm serve (``by_window``,
    {kernel: {window: launches}} as the wrappers counted them)."""
    rows = []
    for where, fcall, dcall in dense_calls(arch, cfg, last):
        w = fcall[1].get("window")
        launches = {k: v[w] for k, v in by_window.items()}
        rows += [flash_serve_record(fcall, launches, edge_errs, where),
                 decode_record(dcall, launches, edge_errs, where)]
    return rows


def serve_rows(dev, phases, attn: dict, edge_errs: dict) -> list:
    """Phases 15 and 16, each (tag, archs, run) one arch on the card at a
    time: ``run(dev, arch, counters=attn, capture=LastCall)`` with the
    flash backward never launched, then the attention kernels' rows on
    the inputs of each arch's serve (``dense_kernel_timings`` at the
    config it served)."""
    from repro_torch.kernels import ops
    rows = []
    for tag, archs, run in phases:
        t0 = time.perf_counter()
        for arch in archs:
            ta = time.perf_counter()
            last = LastCall(ops)
            attn["flash_attention_bwd"].launches = 0
            out = run(dev, arch, counters=attn, capture=last)
            require(attn["flash_attention_bwd"].launches == 0,
                    f"the {arch} serve launched the flash backward kernel")
            rows += dense_kernel_timings(arch, out["cfg"], last,
                                         out["by_window"], edge_errs)
            del last, out
            release(dev)
            log(f"{tag} {arch} ok ({time.perf_counter() - ta:.1f} s)")
        log(f"{tag} path ok ({time.perf_counter() - t0:.1f} s)")
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port "
              "on a GPU only", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch under {ROOT}; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--templates"]:
        return template_probe(Path(sys.argv[2]))
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import Executor
    from repro_torch.core.queries import GROUPED
    from repro_torch.data.weather import WeatherSpec, build_database
    from repro_torch.kernels import _build, decode_attention, flash_attention
    from repro_torch.kernels import hash_join, ops, seg_aggregate, seg_topk
    from repro_torch.kernels.registry import KERNELS
    dev = torch.device("cuda")
    t_all = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"env python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()} | {smi}")
    build_s = _build.build_all()
    log(f"env kernels built in {build_s:.3f} s into {_build.BUILD_DIR}")
    # the attention kernels' registers and spills (nvcc -Xptxas=-v)
    ptx = {short_name(n): v for lib in ("flash_attention",
                                        "flash_attention_bwd")
           for n, v in ptxas_report(lib).items()}
    log("env ptxas " + json.dumps(ptx))
    spills = {n: v for n, v in ptx.items()
              if n.startswith("flash_fwd_tc") and any(v["spill_bytes"])}
    require(not spills, f"the bf16 forward kernel spills: {spills}")
    # phase 15's gemma layers run the head_dim 256 template
    require("flash_fwd_tc<256,256>" in ptx,
            f"no bf16 head_dim 256 forward in the ptxas report: {list(ptx)}")
    # and their training the head_dim 256 tensor-core backward, unspilled
    bwd256 = {n: ptx.get(n) for n in ("bwd_dq_tc<256,256>",
                                      "bwd_dkdv_tc<256,256>")}
    require(all(v is not None and not any(v["spill_bytes"])
                for v in bwd256.values()),
            f"the bf16 head_dim 256 backward is missing or spills: {bwd256}")

    wrappers = {"block_join_probe": hash_join.block_join_probe,
                "segmented_aggregate": seg_aggregate.segmented_aggregate,
                "segment_topk": seg_topk.segment_topk,
                "segmented_sum_count": seg_aggregate.segmented_sum_count,
                "flash_attention": flash_attention.flash_attention_bhsd,
                "flash_attention_bwd":
                    flash_attention.flash_attention_bwd_bhsd,
                "decode_attention": decode_attention.decode_attention_bhgd}
    query_kernels = ("block_join_probe", "segmented_aggregate",
                     "segment_topk")
    lm_kernels = ("flash_attention", "decode_attention")
    attn_kernels = lm_kernels + ("flash_attention_bwd",)
    attn = {k: wrappers[k] for k in attn_kernels}

    t0 = time.perf_counter()
    edge_errs = edge_checks(dev)
    log(f"kernels edge-shape parity ok {json.dumps(edge_errs)} "
        f"({time.perf_counter() - t0:.1f} s)")
    # phase 2's comparisons are no path: from here the partial mode's
    # count is the launches of the paths, none before phase 18's
    decode_attention.decode_attention_partial_bhgd.launches = 0

    spec = WeatherSpec(**SPEC)
    t0 = time.perf_counter()
    db = build_database(spec, PARTITIONS)
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ex = Executor(db, device=dev)
    nodes = sum(t["kind"].numel() for k, t in ex.tables.items()
                if k != "__derived__")            # the upload
    torch.cuda.synchronize()
    log(f"data {json.dumps(SPEC)} P={PARTITIONS}: {nodes} padded nodes, "
        f"{len(db.strings)} strings, ingest {ingest_s:.1f} s, upload "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB on the card")

    for w in wrappers.values():
        w.launches = 0
    capture = Capture(ops)
    query_records = main_path(ex, spec, capture)
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"query path launches {json.dumps(launches)}")
    require(all(launches[k] > 0 for k in query_kernels),
            f"a kernel of the query path never launched: {launches}")
    # one launch per group-by query run: cold and warm on the kernel route
    require(launches["segmented_aggregate"] == 2 * len(GROUPED),
            f"segmented_aggregate launched {launches['segmented_aggregate']}"
            f" times, not once per run of {GROUPED}")
    require(all(launches[k] == 0 for k in attn_kernels),
            f"the query path launched an attention kernel: {launches}")
    records = {r["name"]: r for r in
               main_shape_timings(capture.best, capture.agg_calls,
                                  launches, edge_errs)}
    del ex, capture
    release(dev)

    t0 = time.perf_counter()
    for w in wrappers.values():
        w.launches = 0
    served = service_path(db, spec, dev, {r["query"]: r["warm_ms"]
                                          for r in query_records},
                          counters={k: wrappers[k] for k in query_kernels})
    service_launches = {k: w.launches for k, w in wrappers.items()}
    log(f"service path launches {json.dumps(service_launches)} "
        f"({time.perf_counter() - t0:.1f} s)")
    require(all(service_launches[k] > 0 for k in query_kernels),
            f"a query kernel never launched on the service path: "
            f"{service_launches}")
    require(all(service_launches[k] == 0 for k in attn_kernels),
            f"the service path launched an attention kernel: "
            f"{service_launches}")

    t0 = time.perf_counter()
    capture = Capture(ops)
    spmd = spmd_path(spec, dev, "nccl", {k: wrappers[k] for k in wrappers},
                     {r["query"]: r["warm_ms"] for r in query_records},
                     capture)
    require(all(spmd["launches"][k] > 0 for k in query_kernels),
            f"a query kernel never launched on the spmd path: "
            f"{spmd['launches']}")
    require(all(spmd["launches"][k] == 0 for k in attn_kernels),
            f"the spmd path launched an attention kernel: "
            f"{spmd['launches']}")
    # the three query kernels at the P = 1 shapes spmd gave them (logged;
    # the JSON line keeps phase 4's records)
    main_shape_timings(capture.best, capture.agg_calls, spmd["launches"],
                       edge_errs, where="spmd P=1 shape")
    del capture
    release(dev)
    log(f"spmd path ok ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    mrql_path(db, spec, dev, {r["query"]: r["warm_ms"]
                              for r in served["queries"]})
    log(f"mrql path ok ({time.perf_counter() - t0:.1f} s)")
    del db
    release(dev)

    t0 = time.perf_counter()
    last = LastCall(ops)
    wrappers["flash_attention_bwd"].launches = 0
    lm = lm_path(dev, counters={k: wrappers[k] for k in lm_kernels},
                 capture=last)
    launches.update(lm["warm"]["launches"])
    require(wrappers["flash_attention_bwd"].launches == 0,
            "the serve path launched the flash backward kernel")
    log(f"lm path ok ({time.perf_counter() - t0:.1f} s)")
    for r in lm_kernel_timings(last, launches, edge_errs):
        records[r["name"]] = r
    del last
    release(dev)

    t0 = time.perf_counter()
    templates = TemplateCheck()
    last_flash = LastFlash()
    trained = train_path(dev, counters=wrappers, capture=last_flash)
    launches["flash_attention_bwd"] = trained["launches"][
        "flash_attention_bwd"]
    log(f"train path ok ({time.perf_counter() - t0:.1f} s)")
    # the rows beside the seven: the same kernels at the other shapes
    # their paths gave them
    extra_records = []
    records["flash_attention_bwd"], fwd_train = train_kernel_timing(
        last_flash.call, trained["launches"], edge_errs, templates)
    extra_records.append(fwd_train)
    del last_flash
    release(dev)
    t0 = time.perf_counter()
    resume_check(dev, smoke_overrides={"head_dim": 64})
    log(f"train resume ok ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    last, last_flash = LastCall(ops), LastFlash()
    moe = moe_path(dev, counters=attn, capture=last,
                   train_capture=last_flash)
    log(f"moe path ok ({time.perf_counter() - t0:.1f} s)")
    extra_records += lm_kernel_timings(last, moe["warm"]["launches"],
                                       edge_errs, where=f"{MOE_ARCH} serve")
    bwd, fwd_train = train_kernel_timing(
        last_flash.call, moe["train"]["launches"], edge_errs, templates,
        where=f"{MOE_ARCH} training")
    extra_records += [fwd_train, bwd]
    moe_trained = moe["train"]
    del last, last_flash, moe
    release(dev)

    t0 = time.perf_counter()
    ssm_path(dev, counters=attn)
    log(f"ssm path ok ({time.perf_counter() - t0:.1f} s)")
    release(dev)

    t0 = time.perf_counter()
    last, last_flash = LastCall(ops), LastFlash()
    vlm = vlm_path(dev, counters=attn, capture=last,
                   train_capture=last_flash)
    log(f"vlm path ok ({time.perf_counter() - t0:.1f} s)")
    extra_records += lm_kernel_timings(last, vlm["warm"]["launches"],
                                       edge_errs, where=f"{VLM_ARCH} serve")
    extra_records += train_kernel_timing(
        last_flash.call, vlm["train"]["launches"], edge_errs, templates,
        where=f"{VLM_ARCH} training")[::-1]
    del last, last_flash, vlm
    release(dev)
    t0 = time.perf_counter()
    last, last_flash = LastCall(ops), LastFlash()
    audio = audio_path(dev, counters=attn, capture=last,
                       train_capture=last_flash)
    log(f"audio path ok ({time.perf_counter() - t0:.1f} s)")
    require(set(last.by_window) == {("flash_attention", None)},
            f"the audio forward called {set(last.by_window)}")
    extra_records.append(flash_serve_record(
        last.by_window["flash_attention", None], audio["warm"]["launches"],
        edge_errs, where=f"{AUDIO_ARCH} forward"))
    extra_records += train_kernel_timing(
        last_flash.call, audio["train"]["launches"], edge_errs, templates,
        where=f"{AUDIO_ARCH} training")[::-1]
    del last, last_flash, audio
    release(dev)

    t0 = time.perf_counter()
    tooling_path(dev, counters=attn, full=trained)
    log(f"tooling path ok ({time.perf_counter() - t0:.1f} s)")
    release(dev)

    t0 = time.perf_counter()
    fsdp_path(dev, "nccl", counters=attn, full=trained,
              moe_full=moe_trained, smoke_overrides={"head_dim": 64})
    log(f"fsdp path ok ({time.perf_counter() - t0:.1f} s)")
    release(dev)

    extra_records += serve_rows(
        dev, [("dense", DENSE_ARCHS, dense_path),
              ("moe-wide", MOE_WIDE_ARCHS, moe_wide_path)], attn, edge_errs)

    t0 = time.perf_counter()
    for arch in TP_ARCHS:
        last_flash = LastFlash()
        tp = tp_layer_path(dev, arch, counters=attn, capture=last_flash,
                           card=smi)
        if last_flash.call is not None:
            # the flash kernels at the shape one rank gives them
            extra_records += train_kernel_timing(
                last_flash.call, tp["bfloat16"]["launches_split"],
                edge_errs, templates, where=f"{arch} split layer, one of "
                f"{TP_RANKS} ranks' heads")[::-1]
        del last_flash, tp
        release(dev)
    for arch in TP_VOCAB_ARCHS:
        tp_vocab_path(dev, arch, card=smi)
        release(dev)
    log(f"tp path ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    gemma2_bwd_row(dev, edge_errs, templates)
    release(dev)
    log(f"gemma2 backward row ok ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    partial = decode_attention.decode_attention_partial_bhgd
    require(partial.launches == 0, f"a path before phase 18 launched the "
            f"decode kernel's partial mode {partial.launches} times")
    split_counters = {"decode_attention": wrappers["decode_attention"],
                      "decode_attention_partial": partial}
    for arch, requests, prompt in SERVE_SPLIT_CASES:
        calls = PartialCalls(ops)
        rec = serve_split_path(dev, arch, requests=requests,
                               prompt_len=prompt, counters=split_counters,
                               capture=calls)
        if arch != "llama4-scout-17b-a16e":
            extra_records.append(partial_record(
                calls.calls, rec["bfloat16"]["launches_split"], edge_errs,
                where=f"{arch} split decode, the slice of one of "
                f"{SERVE_SPLIT_RANKS} ranks with the most live slots"))
        del calls, rec
        release(dev)
    log(f"serve split path ok ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    templates.run()
    log(f"kernel templates read ({time.perf_counter() - t0:.1f} s)")
    kernels = [records[name] for name in KERNELS] + extra_records
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
