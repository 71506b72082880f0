#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA H100: RankSVM training
through the counting kernels, under each of its three losses, along a
regularization path, incrementally retrained and resumed from
checkpoints, split over a mesh of ranks, and RankSVM serving; RWKV-6
serving through the WKV forward kernel, dense GQA attention serving
(qwen2.5-3b), MLA and MoE serving (deepseek-v2-lite-16b,
moonshot-v1-16b-a3b), RWKV-6 training through both WKV kernels, dense
GQA attention training, and MLA and MoE training (no kernel of the port
lies on the attention, MLA and MoE paths).

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout on a machine with a CUDA card; it needs
`nvcc` (on PATH or under /usr/local/cuda) to build the kernels of
`src/repro_torch/kernels/csrc` into `.kernel_build/` at first use. It
imports neither JAX nor the JAX package. Phases, each printing one JSON
line; any failure ends the run with a non-zero exit code:

1. build   build every kernel (one nvcc per source, in parallel).
2. parity  each kernel against its plain torch version on the card,
           bit for bit: the pairwise kernel at m = 1, 127, 4096, 8193 with
           heavy ties; the rank-counts kernels at m = 65536 against their
           plain version (c, d and every scratch table) and at m = 2^20
           against the merge-sort tree.
3. wkv_parity  the WKV forward kernel against its plain torch version
           on the card, o, final state and chunk-boundary states: at the
           prefill shape N = 320 (B = 8 x H = 40), T = 4096, K = 64 with
           bf16 r/k/v, and in float32 at K = 8, 16, 32, 64 with T not a
           multiple of 64 (chunk < 64). Bars: o within 1e-4 of its scale
           plus one bf16 ulp, states within 1e-5 of their scale.
4. wkv_bwd_parity  the WKV backward kernel against its plain torch
           version on the card, all six outputs (dr, dk, dv, dw, du, ds0)
           from the forward kernel's boundaries: at the training shape
           N = 160 (B = 4 x H = 40), T = 4096, K = 64 with bf16 r/k/v/do,
           and in float32 at K = 8, 16, 32, 64 with T not a multiple of 64.
           Bars: each output within 1e-4 of its scale plus one bf16 ulp
           for bf16 outputs; ds0 bit-equal.
5. main    the main path at MSLR-WEB10K width (136 dense features),
           m = 2^20 examples, five relevance grades, synthetic from
           --seed: `RankSVM(method='tree', engine='pallas').fit`, then
           engine='tree' on the same data. The rank-counts kernel must
           have been launched in the first fit, its oracle must hold the
           caller's tensor (no copy of X), and the two objectives must
           agree within eps. Prints the phase's peak memory above its
           start.
6. path    the regularization path on the main data: `RankSVM.path`
           over lambda = 1e-1, 1e-2, 1e-3 (eps 1e-3, max_iter 300,
           engine='pallas') in mode 'vmap' (every lambda at once over a
           batched bundle state), 'sequential' and 'hybrid'. Every lambda
           must converge; each vmap and hybrid J within eps of the
           sequential one, and the lambda = 1e-3 J within eps of the main
           fit's; the batched sweeps must launch the rank-counts kernel at
           least L times per batched step; the vmap sweep's peak above its
           start must stay within `path_state_gib(3, 136, m=2^20)`.
           Prints each mode's seconds, iterations and ms per batched step,
           and a profiled batched step beside a single-lambda one.
7. serve   RankSVM serving at the main fit's w: a `Scorer` on the card,
           warmed for 8 .. 4096 candidates, k = 10 and batches of 32,
           then 2000 requests of 8 .. 4096 rows (log-uniform) of the main
           data through `scores` and `top_k` (scores within 1e-5 of max
           |s| of the float64 product; top-k equal to the stable argsort
           of its own scores, bit for bit), 64 `rank_grouped` calls of 32
           queries of 128 rows (equal to lexsort of (index, -s, g)), no
           program added after warm; then a micro-batched
           `RankingService` under 8 client threads of 250 requests with
           one `swap_weights` halfway: every response equal to the direct
           scorer's at the version it reports (scores within the same
           bar, top-k equal but for ties within it). Prints p50/p99 ms of
           each entry point and the batcher's requests/s and mean batch,
           beside the card's name and power limit.
8. auto    `RankSVM(method='auto', engine='auto').fit` on `cadata_like`
           at m = 4096 (8 features, real-valued utilities): the pairwise
           kernel must have been launched, and the objective must agree
           with the tree engine's within eps.
9. guard   engine='pallas' on real-valued utilities at m = 2^20: more
           distinct utilities than histogram levels, so the wrapper must
           count with the tree (no kernel launch) and equal it.
10. sweep   the counting tiers on the card, for KERNEL_MAX_M and
           DEFAULT_LEVELS: the pairwise kernel, the rank-counts call and
           the tree at m = 2^10 .. 2^16, and the rank-counts call against
           the tree at m = 2^20 with 64, 256 and 1024 distinct utilities;
           all agree bit for bit at every point.
11. sparse  the paper's Reuters experiment at reuters_1m: `reuters_like`
           from --seed (m = 2^20 CSR rows of 49152 tf-idf columns, 50
           nonzeros a row, similarity utilities with r ~= m), features
           resident on the card. `RankSVM(method='tree').fit` counts
           with the tree (DEFAULT_LEVELS routes r ~= m there; no kernel
           may launch); its counts at the fitted w equal the CPU tree's,
           two oracle calls are bit-identical, and the device
           transpose-matvec agrees with the host one (scipy's CSR loops)
           within 1e-5. With a budget just above the features'
           projected residency (plus the O(m) vectors and the counting
           pass's peak, which the projection leaves out), method='auto'
           keeps the fused oracle and allocates within that budget.
           Then five grades cut at quantiles of the utilities, fitted
           for SPARSE_CHECK_ITER iterations (a depth cut: the engines
           count bit-equally, so their iterates agree at any depth):
           engine='pallas' must launch the rank-counts kernel every
           iteration and reach the tree engine's objective within eps;
           and `method='auto'` on a 4096-row Reuters sample, as deep,
           must launch the pairwise kernel every iteration, its counts
           at the fitted w equal to the CPU tree's.
12. stream the same data streamed under memory_budget = 0.1953125 GiB
           (half the features' 0.39 GiB on the card): method='auto' must
           pick the streaming oracle; the bytes allocated on the card
           above the phase's start (peak reset before each measured
           call) stay within the budget at prefetch 0 and 1 for an
           oracle call, and for the whole streamed fit (prefetch 1); the
           two depths give bit-identical (loss, a) at one block size; the
           streamed fit's objective is within eps of the resident one;
           and five grades through the stream count with the
           rank-counts kernel, inside the budget.
13. losses the loss axis: the main data (m = 2^20, 136 features, five
           grades) in 8192 queries of 128 consecutive rows (about
           MSLR-WEB10K's documents per query). For 'toppush' and
           'poshinge': one grouped oracle call on the card, bit-identical
           twice, and its counting pass on the CPU on the same scores
           (TopPush's coefficients bit-equal, the weighted d bit-equal
           and c~ within 1e-6 of sum(v), the loss within 1e-6); then a
           device-driver fit to eps = 1e-3 (max_iter 300), and
           `top1_error` and `position_weighted_error` at its w on the
           card and the CPU within 1e-6. engine='pallas' with
           'poshinge' counts with the weighted tree (no counting kernel
           launches) and equals engine='tree' bit for bit. reuters_1m
           (the sparse phase's data, r ~= m) under 'poshinge': one
           resident call and one streamed at memory_budget = 0.1953125
           GiB, prefetch 1, inside the budget. The r-level baseline
           (`core.joachims.counts_rlevel`) against the tree at m = 65536,
           r = 2 .. 2048 (`benchmarks/fig6_rlevels.py --full`): counts
           bit-equal, both times, and where they cross.
14. refit  incremental retraining on the main data in 8192 queries of
           QUERY_ROWS rows: `RankSVM(lam=1e-3, eps=1e-3, method='tree',
           engine='pallas', max_iter=300).fit`, then a block of 2^17 new
           rows (1024 queries, ids 8192-9215) from the same generator
           with every feature's mean shifted by 0.5 standard deviations,
           graded at the base's edges (`mslr_drift`). First the grouped
           'pallas' counter every solve here counts through (offset
           scores into the rank-counts kernel, cross-query pairs
           subtracted) against the grouped tree at the merged shape and
           at the block's, at the main fit's w and at w_true: (c, d)
           bit-equal, one launch a call. `refit(..., mode='ledger')`: the
           rank-counts kernel launched at least once per revalidated
           plane and once per iteration of the warm solve, converged, J
           within eps of a cold fit of the merged data; the same append
           under mode='w-only' on a second copy of the base, within eps
           too. The hot swap: on two more copies, the ledger refit
           (`weight_store=service`) and the w-only refit at eps SWAP_EPS,
           below J(base w) - J(cold fit), so both must beat the base w:
           the service's version up by one, top-k equal to the stable
           argsort of the new scores, the scores changed and equal to a
           fresh `Scorer`'s of the new w. On a fifth copy the block is
           appended and retired again: the ledger's planes before the
           warm solve equal the base ledger's bit for bit, mode 'ledger'.
           `refit_chunk_step` over the merged oracle through
           `runtime.run` (8 chunks of 4 steps, checkpoints every 2,
           preempted at 5, resumed from 4): every field of the final
           `BundleState` equal to the uninterrupted run's on the card;
           the checkpoint's bytes, save and restore ms. The reduced
           rwkv6-3b train step (WKV kernels) through `runtime.run` (6
           steps, checkpoints every 2, preempted at 3): parameters
           (bf16), master weights, AdamW moments and counts bit-identical.
           Prints each fit's iterations, seconds and ms per iteration,
           `revalidate_seconds`, `n_planes`, the kernel's launches in
           revalidation and in the solves, and the phase's peak memory
           above its start.
15. sharded the sharded oracle (`method='sharded'`, `core/distributed.py`)
           on a one-rank NCCL group at the main cell's size: every
           variant ('base', 'opt') and engine ('tree', 'pallas'),
           ungrouped and in 8192 queries of 128 rows, one call's counts
           bit-equal to the tree's on the same bf16 scores, the
           rank-counts kernel once a call under 'pallas', loss and
           subgradient within the reference's bf16 bars of the fused
           tree oracle (loss 2e-2, cosine > 0.99); `RankSVM(method=
           'sharded', engine='pallas').fit` converged with J within 2e-2
           (relative, the reference's bar for a sharded fit against the
           tree) of the main fit's; engine='auto' at m = 4096 through the
           pairwise kernel; reuters_1m through the CSR slot layout and
           the tree (one call's parts, two calls bit-equal, a fit within
           2e-2 of the resident fit's J); `compressed_mean` on the card
           bit-equal to the CPU. Then four gloo ranks sharing the card
           (mesh data 2 x model 2, each a spawned process drawing the main
           data from --seed): counts bit-equal to the one-rank run, loss
           and a within 1e-6, every rank's w the same after 20 bundle
           steps (three chunks of 8: 24); each rank's peak memory.
16. lm      RWKV-6 serving at the full rwkv6-3b width and depth (32
           layers, d = 2560, 40 heads of 64, d_ff = 8960, vocab 65536),
           seeded random weights made on the card, wkv_impl='kernel':
           prefill of B = 8 prompts of T = 4096 tokens (a cut of the
           prefill_32k shape, 32 x 32768), then 32 greedy decode steps
           (the loop of examples/serve.py). The WKV kernel must launch 32
           times per prefill and never in decode; logits must be finite;
           at B = 2, T = 256 prefill(T-1) + decode(1) must match the full
           forward's last-position logits, and the kernel route the scan
           route: within the reference's bars on the first two layers,
           and within a fault bar over all 32 (LM_BARS below). Prints
           prefill tokens/s, decode ms per token, the kernel's ms per
           call, and profiler windows over a prefill and decode steps.
           It releases its model before the next phase.
17. dense  dense GQA attention serving at the full qwen2.5-3b width and
           depth (36 layers, d = 2048, 16 heads over 2 KV heads of 128,
           d_ff = 11008, vocab 151936 padded to 152064, tied, QKV bias;
           3.086e9 parameters), seeded weights made on the card with the
           QKV biases drawn: prefill of B = 8 prompts of T = 4096 (a cut of
           prefill_32k), the cache grown to decode_32k's 32768 positions
           (`convert.pad_cache`, 9.66 GB), then 32 greedy decode steps,
           each writing the cache in place (its storage must not change).
           Logits finite; no kernel of the port launches. At B = 2, T =
           256 prefill(T-1) + decode(1) against the full forward within
           0.05 on the first two layers and within DENSE_FAULT_BAR over
           all 36; the first two layers on the card against a CPU copy
           within the CPU tests' bars. For the record, off the path:
           `scaled_dot_product_attention` against the port's attention at
           the prefill shape. Then internvl2-26b (256 image embeddings),
           musicgen-medium (audio frames, in decode too) and
           nemotron-4-340b (sq_relu, head_dim 192, untied head) at full
           width and 2 layers, each through the same consistency check.
           Prints prefill tokens/s, decode ms per token, peak memory,
           profiler windows over a prefill and decode steps, beside the
           card's name and power limit; releases each model.
18. moe    MLA and MoE serving: deepseek-v2-lite-16b at full width and
           depth (27 layers, d = 2048, 16 heads of 128 + rope 64, MLA
           kv_lora 512, 64 routed experts top-6 and 2 shared of width
           1408, layer 0 dense at 10944, vocab 102400; 15.7e9
           parameters), seeded weights drawn on the card: prefill of
           B = 8 x T = 4096, the latent cache grown to 32768 positions
           (`convert.pad_cache`, 8.15 GB), 32 greedy decode steps, each
           writing the cache in place. Logits finite; no kernel of the
           port launches. The prefill's dropped share of expert choices;
           at B = 2, T = 256 prefill(T-1) + decode(1) against the full
           forward with nothing dropped (capacity factor E/k: with
           drops the two fill the experts' queues differently) within
           0.05 on the first two layers and DENSE_FAULT_BAR over all 27;
           the first two layers block by block on the card against a CPU
           copy from the same inputs, within the CPU tests' bars, expert
           choices equal but at near ties (MOE_TIE_MARGIN). Then
           moonshot-v1-16b-a3b (GQA, vocab 163840, layer 0 dense at
           11264) at full width and 3 layers through the same serve and
           checks. Prints prefill tokens/s, decode ms per token, peak
           memory, profiler windows over a prefill and decode steps, and
           the attention's and MoE's estimated shares of the prefill's
           device time; releases each model.
19. train  RWKV-6 training at the full rwkv6-3b width and depth, seeded
           weights as in lm, wkv_impl='kernel', remat='layer', AdamW
           (f32 master, m, v): first the gradients at B = 1, T = 256, the
           kernel route against the scan route on the same weights, every
           leaf within GRAD_BARS on the first two layers, and the median
           leaf within a fault bar over all 32; then `make_train_step` at
           B = 4 x T = 4096 (a cut of train_4k, 256 x 4096) for three steps of
           objective='lm' on `TokenPipeline` batches and two of
           'rank_hinge' on `RewardPipeline` batches, from --seed. Loss,
           gnorm and lr must be finite, parameters and master weights must
           move, and each step must launch the WKV forward kernel 64 times
           (forward and remat recompute) and the backward kernel 32
           times. Prints train tokens/s, seconds per step, peak device
           memory, a profiler window over the last lm step (with the WKV
           kernels' share of its device time), and both WKV kernels' times
           at the training shape (N = 160; the forward writing
           boundaries).
20. dense_train  dense GQA attention training at the full qwen2.5-3b
           width and depth, seeded weights with the QKV biases drawn, as
           in dense: first the first two layers at B = 1, T = 256 on the
           card against a CPU copy, the bf16 lm loss within 2e-3 and
           every leaf's float32 gradient (TF32 off) within
           DENSE_GRAD_BARS (the embedding's within EMBED_GRAD_BARS); then
           `make_train_step` (remat='layer', AdamW, lr 3e-4, one warmup
           step) at B = 4 x T = 4096 for three lm steps and two
           rank_hinge steps from --seed, as in train. Loss, gnorm and lr
           finite, tracked weights and masters moved, the peak device
           memory under the card's. Prints train tokens/s, seconds per
           step, peak memory, a profiler window over the last lm step,
           and the attention's and RoPE's share of its device time
           (their forward and forward-plus-backward timed alone at the
           step's shape, times the layers). Then one lm step each of
           internvl2-26b (256 image embeddings before 512 tokens) and
           musicgen-medium (512 audio frames) at full width and 2
           layers, loss and gnorm finite. No kernel of the port lies on
           this path. Releases each model.
21. moe_train  MLA and MoE training: deepseek-v2-lite-16b at full width
           and MOE_TRAIN_LAYERS = 5 layers (the dense layer 0 and four MoE
           layers, 2.84e9 parameters: its 27 layers' train state, 234 GiB,
           does not fit the card), seeded weights with the stacked
           matrices at std 1/sqrt(fan-in). First the first two layers
           (layer 0, one MoE layer) at B = 1, T = 256 on the card against
           a CPU copy: every MoE call (forward and recompute) routes every
           token alike on both devices (the count routed apart printed,
           and it must be 0), then the bf16 lm loss within 2e-3 and every
           leaf's float32 gradient within DENSE_GRAD_BARS (the
           embedding's within EMBED_GRAD_BARS). Then `make_train_step`
           (remat='layer', AdamW, lr 3e-4, one warmup step) at B = 4 x
           T = 4096 for three lm and two rank_hinge steps from --seed:
           loss, gnorm and lr finite; the router, the expert of the first
           MoE layer that took most tokens, a shared expert, w_uk, w_uv,
           layer 0's MLP and the score head moved in weights and masters;
           the peak under the card's memory; no kernel of the port
           launched. Prints tokens/s, seconds a step, the peak, step 1's
           dropped share and busiest expert, a profiler window over the
           last lm step with MLA's and the MoE's estimated shares of its
           device time (each block's forward and forward-plus-backward
           timed alone at the step's shape, times its layers), and the
           peak of `loss_and_grads` with layer 0 checkpointed (the port)
           and outside the checkpoint (the reference). Then one lm step
           of moonshot-v1-16b-a3b at full width and 3 layers at the same
           batch, loss and gnorm finite. Releases each model.
22. time   where an iteration's time goes at the main shapes (CUDA
           events): score matvec, both counting paths, transpose matvec,
           one bundle QP (the profiler window over device-driver bundle
           steps is the path phase's `bundle_step_single`). Each
           kernel's row (below) must take at least its bound_ms.

Then the card's name and power limit (nvidia-smi), one line
{"kernels": [...]} with each kernel's time (for the two counting kernels
their device time from the profiler, beside `events_ms`, their launches
back to back by CUDA events), its plain version's time, its bound (the
larger of its bytes at 3.35 TB/s and its operations at 67 TFLOP/s) and
its launches on its main path (the WKV and pairwise rows also with their
launch geometry as the kernels report it: C blocks per sequence, R
threads per column or row, steps per stage, and the backward's steps
between checkpoints; the pairwise kernel's candidate splits), and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))

N_FEATURES = 136                  # MSLR-WEB10K feature count
M = 1 << 20                       # examples of the main and guard phases
# Five relevance grades, skewed like web-search judgments: most documents
# are irrelevant, few are perfect.
GRADE_SHARES = (0.52, 0.32, 0.13, 0.02, 0.01)
LAM = 1e-3
EPS = 1e-3
MAX_ITER = 300                    # depth cut of the main fits
# Profiler windows tried before a phase fails for want of device events.
PROFILE_TRIES = 3
# The rank-counts call's three kernels after the sort.
RC_KERNELS = ('rc_gather', 'rc_scan', 'rc_count')
# The paper's Reuters experiment at the reuters_1m shape (m = 2^20 as the
# main cell, 49152 tf-idf columns, 50 nonzeros a row): the regularization
# and the memory budget of the streamed cell (half the 0.39 GiB that the
# features take resident), and the sparse 'auto' run's size.
REUTERS_N, REUTERS_NNZ, REUTERS_TEST = 49152, 50, 4096
SPARSE_LAM = 1e-5
STREAM_BUDGET_GIB = 0.1953125
AUTO_M = 4096
# Iterations of the sparse phase's graded engine pair and 'auto' run (a
# depth cut: converged, they took 69 and 83, some 40 s of the phase).
SPARSE_CHECK_ITER = 8
# The loss axis (losses phase): rows per query of the main data, and the
# r-level sweep of benchmarks/fig6_rlevels.py --full.
QUERY_ROWS = 128
RLEVEL_M, RLEVELS = 65536, (2, 8, 32, 128, 512, 2048)
# The regularization path (path phase): the lambdas of the sweep.
PATH_LAMS = (1e-1, 1e-2, 1e-3)
# Incremental retraining (refit phase): rows of the appended block (1024
# new queries of QUERY_ROWS), the drift of its features in standard
# deviations, and the chunk loop's length, checkpoint period, steps per
# chunk and preemption.
DELTA_ROWS, DRIFT_SHIFT = 1 << 17, 0.5
# The hot swap's refits (ledger, and w-only beside it) stop at SWAP_EPS,
# below J(base w) - J(cold fit) on the merged data (3.17e-5 at seed 0),
# so a converged solve must return a w better than the base's: the swap
# then has to change what is served. Not below the f32 floor (1e-5).
SWAP_EPS = 2e-5
CHUNKS, CKPT_EVERY, CHUNK_STEPS, FAIL_AT = 8, 2, 4, 5
# The reduced rwkv6-3b train step through the runtime loop: steps,
# checkpoint period, preemption, batch and length.
RESUME_STEPS, RESUME_CKPT, RESUME_FAIL, RESUME_BATCH, RESUME_LEN = (
    6, 2, 3, 2, 64)
# RankSVM serving (serve phase): requests of 8 .. 4096 candidates drawn
# log-uniform (MSLR-WEB10K queries hold about 120), the top k, the
# micro-batcher's clients and their requests, its launch cap, and the
# grouped calls (queries of QUERY_ROWS rows, as many as fill the largest
# warmed bucket).
SERVE_REQUESTS, SERVE_MIN_ROWS, SERVE_MAX_ROWS, SERVE_K = 2000, 8, 4096, 10
SERVE_CLIENTS, SERVE_CLIENT_REQUESTS, SERVE_MAX_BATCH = 8, 250, 32
GROUPED_CALLS = 64
# RWKV-6 serving (lm phase): prefill batch and length (prefill_32k is
# 32 x 32768), greedy decode steps, and the consistency checks' shape.
LM_BATCH, LM_PROMPT, LM_DECODE = 8, 4096, 32
CHECK_BATCH, CHECK_LEN = 2, 256
# Dense-attention serving (dense phase): qwen2.5-3b at full width and
# depth with the lm phase's prefill batch, length and decode steps, into
# a cache of decode_32k's length; the other widths at 2 layers. Bars of
# the CPU tests (tests/test_torch_dense_lm.py): prefill + decode against
# the full forward within 0.05 (tests/test_models.py), logits card
# against CPU within 3% in relative norm and 5% of the largest value,
# layer 0's cache within 1% and 2% (the whole cache within the first).
DENSE_ARCH, DENSE_CAPACITY = 'qwen2.5-3b', 32768
DENSE_WIDTHS = ('internvl2-26b', 'musicgen-medium', 'nemotron-4-340b')
DENSE_PD_BAR = 0.05
DENSE_MODEL_BARS = dict(rel=0.03, peak=0.05)
DENSE_CACHE_BARS = dict(rel=0.01, peak=0.02)
DENSE_FAULT_BAR = 0.25
# MoE serving (moe phase): deepseek-v2-lite-16b at full width and depth
# with the lm phase's prefill batch, length and decode steps into a cache
# of decode_32k's length; moonshot-v1-16b-a3b at full width and
# MOE_WIDTH_LAYERS layers (its 48 layers' 56.8 GB of weights and a cache
# do not fit one card). Bars as in the dense phase. Card against CPU,
# each block from the same input: a token's experts may differ only at a
# near tie, its k-th and (k+1)-th router probabilities on the CPU within
# MOE_TIE_MARGIN of the k-th (float32 sums in another order move a
# probability by some 1e-7 of itself).
MOE_ARCH, MOE_CAPACITY = 'deepseek-v2-lite-16b', 32768
MOE_WIDTH_ARCH, MOE_WIDTH_LAYERS = 'moonshot-v1-16b-a3b', 3
MOE_TIE_MARGIN = 1e-4
# RWKV-6 training (train phase): batch and length (train_4k is 256 x
# 4096), steps of each objective, and the gradient checks' shape.
TRAIN_BATCH, TRAIN_LEN = 4, 4096
TRAIN_LM_STEPS, TRAIN_RANK_STEPS = 3, 2
GRAD_BATCH, GRAD_LEN = 1, 256
# The sharded oracle (sharded phase): the four-rank mesh that shares the
# card ('data' 2 x 'model' 2, gloo), its short fit, the bars of the
# reference's bf16 oracle against the tree (tests/test_sharded_solver.py:
# loss rel and abs 2e-2, cosine > 0.99; a sharded fit's J rel 2e-2), and
# the rows of the 'auto' cut that reaches the pairwise kernel.
SHARDED_MESH, SHARDED_FIT_ITER = (2, 2), 20
SHARDED_LOSS_BAR, SHARDED_COS_BAR, SHARDED_J_REL = 2e-2, 0.99, 2e-2
SHARDED_AUTO_M = 4096
# Loss and a of the four ranks against the one-rank run: their float64
# sums round once to float32, so they agree unless a sum lands within
# 2^-53 of a float32 rounding boundary; this bar allows a few ulps.
SHARDED_RANK_REL = 1e-6
HBM_BYTES_PER_S = 3.35e12         # H100 SXM device memory
F32_OPS_PER_S = 67e12             # H100 SXM float32 outside tensor cores


class PhaseFailed(RuntimeError):
    pass


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, name_part: str, reps: int,
              per_call: int = 1) -> float:
    """Mean milliseconds per fn() of the CUDA kernels whose name holds
    `name_part` (`per_call` of them a call), from their device durations
    in a profiler window: the kernels' own time, without the host's
    launch cost that a short kernel's back-to-back CUDA-event time is
    bound by. The profiler drops kernels at a window's edge (it
    recorded 148 of 150 rank-counts launches and 48 of 50 pairwise ones
    in every window on the H100), so the window runs two calls more and
    the mean is taken over the last reps * per_call launches it
    recorded: consecutive launches of identical calls, each kernel of a
    call reps times among them. A window that recorded fewer is taken
    again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    need, seen = reps * per_call, []
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps + 2):
                fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and name_part in e.name)
        seen.append(len(spans))
        if len(spans) >= need:
            return sum(b - a for a, b in spans[-need:]) / 1e3 / reps
    check(False, f'{PROFILE_TRIES} profiler windows recorded {seen} '
          f'{name_part} launches, fewer than {need}')


def _mslr_draw(torch, m: int, seed: int, dev):
    """Dense MSLR-WEB10K-width data made on the card from `seed`: 136
    standardized features and five relevance grades cut from a noisy
    linear utility at the GRADE_SHARES quantiles. Returns (X, y, w_true,
    edges): the utility weights and the grade edges too, for the drifted
    block of the refit phase."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    X = torch.randn(m, N_FEATURES, generator=g, device=dev)
    w_true = torch.randn(N_FEATURES, generator=g, device=dev)
    w_true /= w_true.norm()
    raw = X @ w_true + 0.5 * torch.randn(m, generator=g, device=dev)
    cum = torch.tensor([sum(GRADE_SHARES[:k + 1]) for k in range(4)],
                       device=dev)
    edges = torch.sort(raw).values[(cum * (m - 1)).long()]
    y = torch.bucketize(raw, edges, right=True).to(torch.float32)
    return X, y, w_true, edges


def mslr_drift(torch, w_true, edges, m_delta: int, seed: int, dev):
    """A block of `m_delta` new rows for the main data: drawn as
    `_mslr_draw` draws its rows, from a generator of its own, with every
    feature's mean shifted by DRIFT_SHIFT standard deviations (as
    `cadata_drift` shifts Cadata's); utilities from the base's w_true,
    graded at the BASE's edges, so that the drift changes the block's
    grade mix."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed * 1000003 + 0xD41F)
    X = torch.randn(m_delta, N_FEATURES, generator=g, device=dev)
    X += DRIFT_SHIFT
    raw = X @ w_true + 0.5 * torch.randn(m_delta, generator=g, device=dev)
    y = torch.bucketize(raw, edges, right=True).to(torch.float32)
    return X, y


def phase_build(ctx):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build()
    secs = time.perf_counter() - t0
    regs = {}
    for src in _build.SOURCES:
        regs[src] = [line.split('ptxas info    :')[-1].strip()
                     for line in _build.build_log(src).splitlines()
                     if 'registers' in line or 'spill' in line]
    return dict(seconds=secs, libraries=[p.name for p in paths.values()],
                ptxas=regs)


def phase_parity(ctx):
    torch, dev = ctx['torch'], ctx['dev']
    from repro_torch.core import counts as TC
    from repro_torch.kernels.pairwise_rank import ops as PR
    from repro_torch.kernels.pairwise_rank.ref import pairwise_counts_plain
    from repro_torch.kernels.rank_counts import ops as RC
    from repro_torch.kernels.rank_counts.ref import rank_counts_plain
    g = torch.Generator(device=dev)
    g.manual_seed(ctx['seed'] + 1)
    out = {}
    for m in (1, 127, 4096, 8193):
        # scores on a 0.5 grid: many p_j == p_i +- 1 boundary ties
        p = torch.randint(-4, 5, (m,), generator=g, device=dev) * 0.5
        y = torch.randint(0, 3, (m,), generator=g, device=dev).float()
        c, d = PR.pairwise_counts(p.float(), y)
        cp, dp = pairwise_counts_plain(p.float(), y)
        torch.cuda.synchronize()
        check(torch.equal(c, cp) and torch.equal(d, dp),
              f'pairwise kernel != plain at m={m}')
        out[f'pairwise_m{m}'] = 'equal'
    m = 65536
    p = (torch.randint(-40, 41, (m,), generator=g, device=dev) * 0.25).float()
    y = torch.randint(0, 5, (m,), generator=g, device=dev).float()
    ranks = RC._compact_ranks(y)
    n_ranks = int(ranks.max()) + 1
    args = (*torch.sort(p, stable=True), ranks, n_ranks)
    got = RC.counts_from_sort(*args)
    want = rank_counts_plain(*args, RC.pick_tj(n_ranks))
    torch.cuda.synchronize()
    check(_counts_equal(torch, got, want),
          'rank-counts kernels != plain at m=65536')
    out['rank_counts_m65536'] = 'equal'
    p = (torch.randint(-400, 401, (M,), generator=g, device=dev)
         * 0.25).float()
    y = torch.randint(0, 5, (M,), generator=g, device=dev).float()
    c, d = RC.rank_counts(p, y)
    cf, df = TC.counts_fused(p, y)
    torch.cuda.synchronize()
    check(torch.equal(c, cf) and torch.equal(d, df),
          f'rank-counts kernel != tree at m={M}')
    out[f'rank_counts_m{M}_vs_tree'] = 'equal'
    return out


def _counts_equal(torch, got, want):
    """The rank-counts kernels' (c, d, (yr, planes, table)) against the
    plain version's: every tensor bit-equal."""
    (c, d, prep), (cp, dp, prepp) = got, want
    return all(torch.equal(a, b) for a, b in zip((c, d, *prep),
                                                 (cp, dp, *prepp)))


def _wkv_inputs(torch, n, t, kk, dtype, dev, g):
    r, k, v = (torch.randn(n, t, kk, generator=g, device=dev).to(dtype)
               for _ in range(3))
    w = 0.5 + 0.499 * torch.rand(n, t, kk, generator=g, device=dev)
    u = torch.randn(n, kk, generator=g, device=dev)
    s0 = 0.1 * torch.randn(n, kk, kk, generator=g, device=dev)
    return r, k, v, w, u, s0


def _wkv_compare(torch, got, want):
    """Errors of the kernel's (o, sT, boundaries) against the plain
    version's, and whether they are inside the bars: o within 1e-4 of
    its scale plus one ulp of bf16 where o is bf16 (a float32 sum in
    another order can flip one rounding), states within 1e-5 of their
    scale (tests/test_wkv_kernel.py's tolerances)."""
    (o, sT, bnd), (op, sTp, bndp) = got, want
    of, opf = o.float(), op.float()
    scale = float(opf.abs().max())
    tol = 1e-4 * scale
    if o.dtype == torch.bfloat16:
        tol = tol + torch.exp2(torch.floor(torch.log2(
            opf.abs().clamp_min(1e-30))) - 7)
    o_err = float((of - opf).abs().max())
    out = dict(o_max_abs_err=o_err, o_scale=scale,
               o_inside=bool(((of - opf).abs() <= tol).all()),
               sT_rel_err=float((sT - sTp).abs().max() / sTp.abs().max()),
               states_bit_equal=bool(torch.equal(sT, sTp)))
    if bnd is not None:
        out['boundaries_rel_err'] = float((bnd - bndp).abs().max()
                                          / bndp.abs().max())
        out['states_bit_equal'] &= bool(torch.equal(bnd, bndp))
    return out


def phase_wkv_parity(ctx):
    torch, dev = ctx['torch'], ctx['dev']
    from repro_torch.kernels.wkv import ops as W
    from repro_torch.kernels.wkv.ref import wkv_forward_plain
    g = torch.Generator(device=dev)
    g.manual_seed(ctx['seed'] + 5)
    cases = ((320, 4096, 64, torch.bfloat16), (6, 100, 8, torch.float32),
             (6, 200, 16, torch.float32), (6, 96, 32, torch.float32),
             (6, 130, 64, torch.float32))
    out = {}
    for n, t, kk, dtype in cases:
        args = _wkv_inputs(torch, n, t, kk, dtype, dev, g)
        chunk = W._pick_chunk(t)
        got = W.wkv_forward(*args, chunk=chunk)
        want = wkv_forward_plain(*args, chunk=chunk)
        torch.cuda.synchronize()
        errs = _wkv_compare(torch, got, want)
        name = f'N{n}_T{t}_K{kk}_{str(dtype).split(".")[-1]}_chunk{chunk}'
        check(errs['o_inside'] and errs['sT_rel_err'] <= 1e-5
              and errs['boundaries_rel_err'] <= 1e-5,
              f'WKV kernel != plain at {name}: {errs}')
        out[name] = errs
    return out


WKV_GRADS = ('dr', 'dk', 'dv', 'dw', 'du', 'ds0')


def _wkv_bwd_inputs(torch, n, t, kk, dtype, dev, g):
    """Backward-kernel inputs: the forward's inputs, its boundaries from
    the forward kernel, a cotangent do in r's dtype and dsT float32."""
    from repro_torch.kernels.wkv import ops as W
    r, k, v, w, u, s0 = _wkv_inputs(torch, n, t, kk, dtype, dev, g)
    chunk = W._pick_chunk(t)
    _, _, bnd = W.wkv_forward(r, k, v, w, u, s0, chunk=chunk)
    do = torch.randn(n, t, kk, generator=g, device=dev).to(dtype)
    dsT = torch.randn(n, kk, kk, generator=g, device=dev)
    return (r, k, v, w, u, bnd, do, dsT), chunk


def _wkv_bwd_compare(torch, got, want):
    """Errors of the backward kernel's six outputs against the plain
    version's, and whether each is inside its bar: 1e-4 of the output's
    scale, plus one bf16 ulp of each value where the output is bf16 (dr,
    dk, dv on the model path). ds0, whose dS updates are rounded in the
    plain version's order, must be bit-equal."""
    out = {}
    for name, a, b in zip(WKV_GRADS, got, want):
        af, bf = a.float(), b.float()
        scale = float(bf.abs().max())
        tol = 1e-4 * scale
        if a.dtype == torch.bfloat16:
            tol = tol + torch.exp2(torch.floor(torch.log2(
                bf.abs().clamp_min(1e-30))) - 7)
        out[name] = dict(max_abs_err=float((af - bf).abs().max()),
                         scale=scale,
                         inside=bool(((af - bf).abs() <= tol).all()))
    out['ds0_bit_equal'] = bool(torch.equal(got[5], want[5]))
    out['all_inside'] = (out['ds0_bit_equal']
                         and all(out[k]['inside'] for k in WKV_GRADS))
    return out


def phase_wkv_bwd_parity(ctx):
    torch, dev = ctx['torch'], ctx['dev']
    from repro_torch.kernels.wkv import ops as W
    from repro_torch.kernels.wkv.ref import wkv_backward_plain
    g = torch.Generator(device=dev)
    g.manual_seed(ctx['seed'] + 7)
    cases = ((TRAIN_BATCH * 40, TRAIN_LEN, 64, torch.bfloat16),
             (6, 100, 8, torch.float32), (6, 200, 16, torch.float32),
             (6, 96, 32, torch.float32), (6, 130, 64, torch.float32))
    out = {}
    for n, t, kk, dtype in cases:
        args, chunk = _wkv_bwd_inputs(torch, n, t, kk, dtype, dev, g)
        got = W.wkv_backward(*args, chunk=chunk)
        want = wkv_backward_plain(*args, chunk=chunk)
        torch.cuda.synchronize()
        errs = _wkv_bwd_compare(torch, got, want)
        name = f'N{n}_T{t}_K{kk}_{str(dtype).split(".")[-1]}_chunk{chunk}'
        check(errs['all_inside'], f'WKV backward kernel != plain at {name}: '
              f'{errs}')
        out[name] = errs
    return out


def _fit(ctx, X, y, groups=None, **kw):
    from repro_torch.core.ranksvm import RankSVM
    torch = ctx['torch']
    torch.cuda.synchronize()
    svm = RankSVM(device=ctx['dev'], **kw).fit(X, y, groups)
    torch.cuda.synchronize()
    rep = svm.report_
    check(rep.iterations > 0 and math.isfinite(rep.objective),
          f'fit {kw} did not produce a finite objective')
    return svm, rep


def _kernels():
    from repro_torch.kernels.pairwise_rank import ops as PR
    from repro_torch.kernels.rank_counts import ops as RC
    from repro_torch.kernels.wkv import ops as W
    return dict(pairwise=PR.PAIRWISE, rank_counts=RC.RANK_COUNTS,
                wkv_fwd=W.WKV_FWD, wkv_bwd=W.WKV_BWD)


def _reset_counts():
    for kernel in _kernels().values():
        kernel.launches = 0


def _counts():
    return {name: k.launches for name, k in _kernels().items()}


def phase_main(ctx):
    torch = ctx['torch']
    X, y, ctx['w_true'], ctx['edges'] = _mslr_draw(torch, M, ctx['seed'],
                                                   ctx['dev'])
    ctx['X'], ctx['y'] = X, y
    kw = dict(lam=LAM, eps=EPS, method='tree', max_iter=MAX_ITER)
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    svm_k, rep_k = _fit(ctx, X, y, engine='pallas', **kw)
    launches = _counts()
    # the fit's store and oracle hold the caller's tensor, not a copy
    check(svm_k.oracle_._feats.X.data_ptr() == X.data_ptr()
          and svm_k.incremental_.store.materialize() is X,
          'the main fit copied its features')
    check(launches['rank_counts'] >= rep_k.iterations,
          f'rank-counts kernel launched {launches["rank_counts"]} times in '
          f'{rep_k.iterations} iterations of the main path')
    ctx['launches']['rank_counts'] = launches['rank_counts']
    ctx['main_iterations'] = rep_k.iterations
    ctx['w_main'] = svm_k.w_
    _reset_counts()
    svm_t, rep_t = _fit(ctx, X, y, engine='tree', **kw)
    check(_counts()['rank_counts'] == 0, 'the tree engine launched a kernel')
    j_k = svm_k.objective(X, y)
    j_t = svm_t.objective(X, y)
    check(abs(j_k - j_t) <= EPS,
          f'objectives differ: pallas {j_k} vs tree {j_t}')
    ctx['objective_main'] = j_k
    res = dict(m=M, n=N_FEATURES, grades=len(GRADE_SHARES),
               launches=launches, objective_pallas=j_k, objective_tree=j_t,
               features_copied=False,
               peak_memory_above_start=(torch.cuda.max_memory_allocated()
                                        - start))
    for name, rep in (('pallas', rep_k), ('tree', rep_t)):
        res[name] = dict(iterations=rep.iterations, converged=rep.converged,
                         gap=rep.gap, solver=rep.solver, seconds=rep.seconds,
                         ms_per_iteration=1e3 * rep.seconds / rep.iterations)
    return res


def _objective(ctx, w, lam):
    """J(w) = R_emp(w) + lam ||w||^2 on the main data, as the main phase
    evaluates its fits (`RankSVM.objective`)."""
    from repro_torch.core.ranksvm import RankSVM
    svm = RankSVM(lam=lam, device=ctx['dev'])
    svm.w_ = w
    return svm.objective(ctx['X'], ctx['y'])


def phase_path(ctx):
    """The regularization path on the main data: `RankSVM.path` over
    PATH_LAMS in each mode through the rank-counts kernel; the batched
    sweep's memory against `path_state_gib`, its launches, and one
    profiled batched step beside a single-lambda one."""
    torch, dev = ctx['torch'], ctx['dev']
    from repro_torch.core.bmrm import path_state_gib
    from repro_torch.core.ranksvm import RankSVM
    X, y = ctx['X'], ctx['y']
    n_lams = len(PATH_LAMS)
    budget = path_state_gib(n_lams, N_FEATURES, m=M) * 2**30
    res = dict(m=M, n=N_FEATURES, lams=list(PATH_LAMS), eps=EPS,
               max_iter=MAX_ITER, state_budget_bytes=budget)
    objectives, launches_all = {}, 0
    for mode in ('vmap', 'sequential', 'hybrid'):   # vmap from a clean start
        svm = RankSVM(eps=EPS, method='tree', engine='pallas',
                      max_iter=MAX_ITER, device=dev)
        _reset_counts()
        pts, peak, ms = _peak_above(
            torch, None, lambda: svm.path(X, y, PATH_LAMS, mode=mode))
        launches = _counts()['rank_counts']
        launches_all += launches
        iters = [p.report.iterations for p in pts]
        solvers = [p.report.solver for p in pts]
        check(all(p.report.converged for p in pts),
              f'{mode} path: a lambda did not converge ({iters})')
        objectives[mode] = [_objective(ctx, p.w, p.lam) for p in pts]
        row = dict(seconds=ms / 1e3, iterations=iters,
                   iterations_total=sum(iters), solvers=solvers,
                   objectives=objectives[mode],
                   rank_counts_launches=launches, peak_bytes_above_start=peak)
        batched = [p for p, sv in zip(pts, solvers) if sv == 'vmap']
        check((mode == 'sequential') == (not batched),
              f'{mode} path ran solvers {solvers}')
        if batched:
            steps = max(p.report.iterations for p in batched)
            secs = sum(p.report.seconds for p in batched)
            check(launches >= len(batched) * steps,
                  f'{mode} path: {launches} rank-counts launches for '
                  f'{len(batched)} lambdas x {steps} batched steps')
            row.update(batched_steps=steps, batched_seconds=secs,
                       ms_per_batched_step=1e3 * secs / steps)
        res[mode] = row
        del svm, pts
    check(res['vmap']['peak_bytes_above_start'] <= budget,
          f'the batched sweep took {res["vmap"]["peak_bytes_above_start"]} '
          f'bytes above its start, over path_state_gib\'s {budget}')
    for mode in ('vmap', 'hybrid'):
        for lam, a, b in zip(PATH_LAMS, objectives[mode],
                             objectives['sequential']):
            check(abs(a - b) <= EPS, f'{mode} J = {a} vs sequential {b} at '
                  f'lambda {lam}')
    for mode, objs in objectives.items():
        check(abs(objs[-1] - ctx['objective_main']) <= EPS,
              f'{mode} J = {objs[-1]} at lambda {PATH_LAMS[-1]} vs the main '
              f'fit\'s {ctx["objective_main"]}')
    ctx['launches']['rank_counts_path'] = launches_all
    res['bundle_step_single'] = _profile_bundle_step(ctx)
    res['bundle_step_batched'] = _profile_bundle_step(ctx, lams=PATH_LAMS)
    return res


def _pcts(ms):
    import numpy as np
    return dict(p50_ms=float(np.percentile(ms, 50)),
                p99_ms=float(np.percentile(ms, 99)), calls=len(ms))


def phase_serve(ctx):
    """RankSVM serving on the card at the main fit's w: the bucketed
    scorer's entry points, grouped ranking, and the micro-batched service
    under eight client threads with one hot swap."""
    import threading
    import numpy as np
    torch, dev = ctx['torch'], ctx['dev']
    from repro_torch.serve import RankingService, Scorer
    rng = np.random.default_rng(ctx['seed'] + 7)
    Xh = ctx['X'].cpu().numpy()
    w0 = np.asarray(ctx['w_main'], np.float32)
    w1 = (2.0 * w0 + 0.25 * rng.standard_normal(w0.shape)).astype(
        np.float32)
    weights = {0: w0, 1: w1}

    def draw(g, count):
        n = np.exp(g.uniform(np.log(SERVE_MIN_ROWS), np.log(SERVE_MAX_ROWS),
                             count)).astype(np.int64)
        n = np.clip(n, SERVE_MIN_ROWS, SERVE_MAX_ROWS)
        return [(int(s0), int(k)) for s0, k in
                zip(g.integers(0, M - n + 1), n)]

    sc = Scorer(w0, device=dev)
    t0 = time.perf_counter()
    n_warm = sc.warm(SERVE_MAX_ROWS, ks=(SERVE_K,),
                     max_batch=SERVE_MAX_BATCH, grouped=True)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    sizes = sc.program_cache_sizes()
    lat = dict(scores=[], top_k=[], rank_grouped=[])
    worst = 0.0
    reqs = draw(rng, SERVE_REQUESTS)
    for s0, n in reqs:
        X = Xh[s0:s0 + n]
        t0 = time.perf_counter()
        s = sc.scores(X)
        lat['scores'].append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        v, i = sc.top_k(X, SERVE_K)
        lat['top_k'].append(1e3 * (time.perf_counter() - t0))
        ref = X.astype(np.float64) @ w0.astype(np.float64)
        err = float(np.abs(s - ref).max() / max(np.abs(ref).max(), 1e-30))
        worst = max(worst, err)
        check(err <= 1e-5, f'scores of {n} candidates off the float64 '
              f'product by {err} of max |s|')
        own = np.argsort(-s, kind='stable')[:SERVE_K]
        check(np.array_equal(i, own) and np.array_equal(v, s[own]),
              f'top_k of {n} candidates differs from the stable argsort of '
              'its own scores')
    q_rows = QUERY_ROWS
    per_call = SERVE_MAX_ROWS // q_rows
    for _ in range(GROUPED_CALLS):
        qs = rng.choice(M // q_rows, per_call, replace=False)
        rows = (qs[:, None] * q_rows + np.arange(q_rows)).ravel()
        perm = rng.permutation(rows.size)
        X, g = Xh[rows[perm]], (rows[perm] // q_rows).astype(np.int32)
        t0 = time.perf_counter()
        order = sc.rank_grouped(X, g)
        lat['rank_grouped'].append(1e3 * (time.perf_counter() - t0))
        s = sc.scores(X)
        check(np.array_equal(order, np.lexsort(
            (np.arange(rows.size), -s.astype(np.float64), g))),
            'rank_grouped differs from lexsort of (index, -s, g)')
    check(sc.n_programs == n_warm and sc.program_cache_sizes() == sizes,
          f'traffic added programs after warm: {sc.n_programs} vs {n_warm}')

    # The micro-batched service: SERVE_CLIENTS threads, one swap halfway.
    svc = RankingService(w0, device=dev, max_batch=SERVE_MAX_BATCH)
    svc.warmup(SERVE_MAX_ROWS, ks=(SERVE_K,))
    n_svc = svc.scorer.n_programs
    total = SERVE_CLIENTS * SERVE_CLIENT_REQUESTS
    lock, half = threading.Lock(), threading.Event()
    served, errors, done = {}, [], [0]

    def client(c):
        got = []
        try:
            for s0, n in draw(np.random.default_rng(
                    [ctx['seed'], c]), SERVE_CLIENT_REQUESTS):
                t0 = time.perf_counter()
                r = svc.submit(Xh[s0:s0 + n], SERVE_K).result(120.0)
                got.append((s0, n, r, 1e3 * (time.perf_counter() - t0)))
                with lock:
                    done[0] += 1
                    if done[0] == total // 2:
                        half.set()
        except Exception as e:             # reported below, fails the phase
            errors.append(f'{type(e).__name__}: {e}')
            half.set()
        served[c] = got

    def swapper():
        half.wait(600.0)
        svc.swap_weights(w1)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVE_CLIENTS)] + [
        threading.Thread(target=swapper)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(600.0)
    wall = time.perf_counter() - t0
    stats = svc.stats()
    svc.close()
    check(not errors and not any(th.is_alive() for th in threads),
          f'micro-batched clients failed: {errors[:3]}')
    got = [x for c in range(SERVE_CLIENTS) for x in served[c]]
    check(len(got) == total, f'{len(got)} of {total} requests served')
    versions = sorted({r.version for _, _, r, _ in got})
    check(versions == [0, 1], f'the traffic saw versions {versions}')
    check(svc.scorer.n_programs == n_svc, 'batched traffic added programs')
    direct = {v: Scorer(w, device=dev) for v, w in weights.items()}
    exact = 0
    for s0, n, r, _ in got:
        X = Xh[s0:s0 + n]
        ds = direct[r.version].scores(X)
        dv, di = direct[r.version].top_k(X, SERVE_K)
        bar = 1e-5 * max(float(np.abs(ds).max()), 1e-30)
        check(float(np.abs(r.scores - ds).max()) <= bar,
              f'a batched response differs from the direct scorer at '
              f'version {r.version}')
        own = np.argsort(-r.scores, kind='stable')[:SERVE_K]
        check(np.array_equal(r.indices, own)
              and np.array_equal(r.values, r.scores[own]),
              'a batched top-k differs from its own scores\' stable argsort')
        if np.array_equal(r.indices, di):
            exact += 1
        else:
            # the batched product may round differently: only candidates
            # tied with the direct top-k within the bar may trade places
            check(np.allclose(ds[r.indices], dv, rtol=0.0, atol=bar),
                  f'a batched top-k differs from the direct one at version '
                  f'{r.version} beyond a tie')
    return dict(card=_card(), requests=SERVE_REQUESTS, k=SERVE_K,
                rows=[SERVE_MIN_ROWS, SERVE_MAX_ROWS], programs=n_warm,
                warm_seconds=warm_s, scores_max_rel_err=worst,
                scores=_pcts(lat['scores']), top_k=_pcts(lat['top_k']),
                rank_grouped=dict(_pcts(lat['rank_grouped']),
                                  queries_per_call=per_call,
                                  query_rows=q_rows),
                batcher=dict(clients=SERVE_CLIENTS, requests=total,
                             seconds=wall, requests_per_s=total / wall,
                             mean_batch=stats['mean_batch'],
                             launches=stats['n_batches'], versions=versions,
                             top_k_equal_direct=exact,
                             **_pcts([x[3] for x in got])))


def phase_auto(ctx):
    torch, dev = ctx['torch'], ctx['dev']
    from repro_torch.data import cadata_like
    data = cadata_like(m=4096, m_test=1024, seed=ctx['seed'])
    kw = dict(lam=LAM, eps=EPS)
    _reset_counts()
    svm_a, rep_a = _fit(ctx, data.X, data.y, method='auto', engine='auto',
                        **kw)
    launches = _counts()
    check(launches['pairwise'] >= rep_a.iterations,
          f'pairwise kernel launched {launches["pairwise"]} times in '
          f'{rep_a.iterations} iterations')
    ctx['launches']['pairwise'] = launches['pairwise']
    ctx['auto_iterations'] = rep_a.iterations
    svm_t, _ = _fit(ctx, data.X, data.y, method='tree', engine='tree', **kw)
    j_a = svm_a.objective(data.X, data.y)
    j_t = svm_t.objective(data.X, data.y)
    check(abs(j_a - j_t) <= EPS, f'objectives differ: auto {j_a} vs '
          f'tree {j_t}')
    ctx['auto_data'] = (torch.as_tensor(data.X, dtype=torch.float32,
                                        device=dev),
                        torch.as_tensor(data.y, dtype=torch.float32,
                                        device=dev), svm_a.w_)
    return dict(m=4096, n=8, launches=launches, iterations=rep_a.iterations,
                converged=rep_a.converged, objective_auto=j_a,
                objective_tree=j_t,
                ranking_error_test=svm_a.ranking_error(data.X_test,
                                                       data.y_test),
                ms_per_iteration=1e3 * rep_a.seconds / rep_a.iterations)


def phase_guard(ctx):
    torch, dev = ctx['torch'], ctx['dev']
    from repro_torch.core import counts as TC
    g = torch.Generator(device=dev)
    g.manual_seed(ctx['seed'] + 2)
    X = ctx['X']
    w = torch.as_tensor(ctx['w_main'], dtype=torch.float32, device=dev)
    p = X @ w
    y = torch.randn(X.shape[0], generator=g, device=dev)
    _reset_counts()
    c, d = TC.counts_dispatch(p, y, None, engine='pallas')
    check(_counts()['rank_counts'] == 0,
          'real-valued utilities reached the rank-counts kernel')
    cf, df = TC.counts_fused(p, y)
    torch.cuda.synchronize()
    check(torch.equal(c, cf) and torch.equal(d, df),
          'guarded counts differ from the tree')
    return dict(m=X.shape[0], distinct_utilities=int(torch.unique(y).numel()),
                rank_counts_launches=0, equal_to_tree=True)


def phase_sweep(ctx):
    """The counting tiers on this card, for KERNEL_MAX_M and
    DEFAULT_LEVELS: the pairwise kernel, the rank-counts call and the
    tree at m = 2^10 .. 2^16 (normal scores, five grades), and the
    rank-counts call against the tree at m = 2^20 (the main scores) with
    64, 256 and 1024 distinct utilities. All three agree bit for bit at
    every point."""
    torch, dev = ctx['torch'], ctx['dev']
    from repro_torch.core import counts as TC
    from repro_torch.kernels.pairwise_rank import ops as PR
    from repro_torch.kernels.rank_counts import ops as RC
    g = torch.Generator(device=dev)
    g.manual_seed(ctx['seed'] + 11)

    def same(a, b):
        return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    tiers = []
    for e in range(10, 17):
        m = 1 << e
        p = 2 * torch.randn(m, generator=g, device=dev)
        y = torch.randint(0, 5, (m,), generator=g, device=dev).float()
        count = RC.rank_counter(y)
        tree = TC.counts_fused(p, y)
        check(same(PR.pairwise_counts(p, y), tree) and same(count(p), tree),
              f'the counting tiers disagree at m={m}')
        tiers.append(dict(
            m=m,
            pairwise_ms=time_ms(torch, lambda: PR.pairwise_counts(p, y),
                                reps=20),
            rank_counts_ms=time_ms(torch, lambda: count(p), reps=20),
            tree_ms=time_ms(torch, lambda: TC.counts_fused(p, y), reps=5)))
    faster = [t['m'] for t in tiers if t['pairwise_ms'] <= t['rank_counts_ms']]
    p = ctx['X'] @ torch.as_tensor(ctx['w_main'], dtype=torch.float32,
                                   device=dev)
    levels = []
    for k in (64, 256, 1024):
        y = torch.randint(0, k, (M,), generator=g, device=dev).float()
        count = RC.rank_counter(y, levels=k)
        check(same(count(p), TC.counts_fused(p, y)),
              f'rank counts != tree at {k} distinct utilities')
        row = dict(distinct=k, tj=RC.pick_tj(k),
                   rank_counts_ms=time_ms(torch, lambda: count(p), reps=10),
                   tree_ms=time_ms(torch, lambda: TC.counts_fused(p, y),
                                   reps=3))
        row['call_beats_tree'] = row['rank_counts_ms'] < row['tree_ms']
        levels.append(row)
    return dict(tiers=tiers, pairwise_not_slower_up_to=max(faster, default=0),
                kernel_max_m=PR.KERNEL_MAX_M, levels_m=M, levels=levels,
                default_levels=RC.DEFAULT_LEVELS)


def _graded(np, y):
    """Five relevance grades cut from real-valued utilities at the
    GRADE_SHARES quantiles (most documents least similar)."""
    cum = np.cumsum(GRADE_SHARES)[:-1]
    return np.digitize(y, np.quantile(y, cum)).astype(np.float32)


def _iteration_split(ctx, oracle, w):
    """CUDA-event times of one fused CSR step's three parts at w."""
    torch = ctx['torch']
    from repro_torch.kernels.platform import full_f32
    feats, count = oracle._feats, oracle._counter()
    with full_f32():
        p = feats.matvec(w)
        c, d = count(p)
        v = (c - d).float() * oracle._inv_n_dev
        return dict(matvec_ms=time_ms(torch, lambda: feats.matvec(w), 10),
                    counting_ms=time_ms(torch, lambda: count(p), 5),
                    rmatvec_ms=time_ms(torch, lambda: feats.rmatvec(v), 10))


def phase_sparse(ctx):
    """The paper's Reuters experiment at reuters_1m: CSR features resident
    on the card, real-valued utilities through the tree, five grades
    through the rank-counts kernel, and the 'auto' method's pairwise
    kernel at m = 4096."""
    torch, dev = ctx['torch'], ctx['dev']
    import numpy as np
    from repro_torch.core import counts as TC
    from repro_torch.core.oracle import TreeOracle
    from repro_torch.data import reuters_like
    t0 = time.perf_counter()
    data = reuters_like(m=M, m_test=REUTERS_TEST, n=REUTERS_N,
                        nnz_per_row=REUTERS_NNZ, seed=ctx['seed'])
    gen_s = time.perf_counter() - t0
    ctx['reuters'] = data
    X, y = data.X, data.y
    kw = dict(lam=SPARSE_LAM, eps=EPS, max_iter=MAX_ITER)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    svm, rep = _fit(ctx, X, y, method='tree', **kw)
    launches = _counts()
    oracle = svm.oracle_
    check(oracle._feats.kind == 'csr' and oracle._feats._uniform,
          'the resident fit did not keep uniform CSR features')
    res = dict(m=M, n=REUTERS_N, nnz=int(X.nnz), lam=SPARSE_LAM,
               generate_seconds=gen_s,
               distinct_utilities=int(np.unique(y.astype(np.float32)).size),
               feature_bytes_on_device=sum(
                   t.numel() * t.element_size() for t in (
                       oracle._feats.data, oracle._feats.slot)),
               max_memory_allocated_above_start=(
                   torch.cuda.max_memory_allocated() - before),
               launches=launches, iterations=rep.iterations,
               converged=rep.converged, gap=rep.gap, solver=rep.solver,
               objective=svm.objective(X, y), seconds=rep.seconds,
               ms_per_iteration=1e3 * rep.seconds / rep.iterations)
    ctx['sparse_objective'] = res['objective']
    ctx['w_sparse'] = svm.w_
    check(launches['rank_counts'] == 0 and launches['pairwise'] == 0,
          'real-valued utilities at m = 2^20 reached a counting kernel; '
          'DEFAULT_LEVELS routes them to the tree')
    w = torch.as_tensor(svm.w_, dtype=torch.float32, device=dev)
    res['iteration_split'] = _iteration_split(ctx, oracle, w)
    # Counts on the card equal the CPU tree's at the fitted w.
    from repro_torch.kernels.platform import full_f32
    with full_f32():
        p = oracle._feats.matvec(w)
    c, d = TC.counts_fused(p, oracle._y)
    t0 = time.perf_counter()
    c_cpu, d_cpu = TC.counts_fused(p.cpu(), oracle._y.cpu())
    res['cpu_tree_seconds'] = time.perf_counter() - t0
    check(torch.equal(c.cpu(), c_cpu) and torch.equal(d.cpu(), d_cpu),
          'tree counts on the card differ from the CPU tree')
    res['counts_equal_cpu_tree'] = True
    # The device transpose-matvec against the host one (scipy's CSR
    # loops), and run to run bit-identity of the device one (exact
    # fixed-point sums).
    l1, a1 = oracle.loss_and_subgrad(w)
    l2, a2 = oracle.loss_and_subgrad(w)
    a1, a2 = (np.asarray(a.cpu() if torch.is_tensor(a) else a, np.float64)
              for a in (a1, a2))
    check(torch.equal(l1, l2) and np.array_equal(a1, a2),
          'two calls of the resident CSR oracle differ')
    host = TreeOracle(X, y, csr_rmatvec='host', device=dev)
    lh, ah = host.loss_and_subgrad(w)
    res['deterministic'] = True
    res['loss_rel_err_vs_host_rmatvec'] = abs(float(l1) - float(lh)) / abs(
        float(lh))
    res['subgrad_rel_err_vs_host_rmatvec'] = float(
        np.abs(a1 - ah).max() / np.abs(ah).max())
    check(res['subgrad_rel_err_vs_host_rmatvec'] <= 1e-5,
          'the device transpose-matvec differs from the host one')
    del svm, oracle, host, p, c, d
    res['fused_auto_memory'] = _fused_auto_memory(ctx, X, y, w)
    # Five grades: the rank-counts kernel against the tree engine.
    y5 = _graded(np, y)
    ctx['reuters_graded'] = y5
    kw = dict(kw, max_iter=SPARSE_CHECK_ITER)
    _reset_counts()
    svm_k, rep_k = _fit(ctx, X, y5, method='tree', engine='pallas', **kw)
    launches_k = _counts()
    check(launches_k['rank_counts'] >= rep_k.iterations,
          f'rank-counts kernel launched {launches_k["rank_counts"]} times '
          f'in {rep_k.iterations} iterations of the graded run')
    _reset_counts()
    svm_t, rep_t = _fit(ctx, X, y5, method='tree', engine='tree', **kw)
    check(_counts()['rank_counts'] == 0, 'the tree engine launched a kernel')
    j_k, j_t = svm_k.objective(X, y5), svm_t.objective(X, y5)
    check(abs(j_k - j_t) <= EPS,
          f'graded objectives differ: pallas {j_k} vs tree {j_t}')
    res['graded'] = dict(
        grades=len(GRADE_SHARES), launches=launches_k, objective_pallas=j_k,
        objective_tree=j_t, objectives_equal=j_k == j_t)
    for name, r in (('pallas', rep_k), ('tree', rep_t)):
        res['graded'][name] = dict(
            iterations=r.iterations, converged=r.converged, gap=r.gap,
            ms_per_iteration=1e3 * r.seconds / r.iterations)
    del svm_k, svm_t
    # The 'auto' method at m = 4096: the pairwise kernel.
    small = reuters_like(m=AUTO_M, m_test=1024, n=REUTERS_N,
                         nnz_per_row=REUTERS_NNZ, seed=ctx['seed'] + 1)
    _reset_counts()
    svm_a, rep_a = _fit(ctx, small.X, small.y, method='auto', **kw)
    launches_a = _counts()
    check(launches_a['pairwise'] >= rep_a.iterations,
          f'pairwise kernel launched {launches_a["pairwise"]} times in '
          f'{rep_a.iterations} iterations of the sparse auto run')
    # Its counts at the fitted w (one more launch, after the reading)
    # equal the CPU tree's.
    o_a = svm_a.oracle_
    with full_f32():
        p_a = o_a._feats.matvec(torch.as_tensor(svm_a.w_, dtype=torch.float32,
                                                device=dev))
    c_a, d_a = o_a._counter()(p_a)
    c_t, d_t = TC.counts_fused(p_a.cpu(), o_a._y.cpu())
    check(torch.equal(c_a.cpu().long(), c_t.long())
          and torch.equal(d_a.cpu().long(), d_t.long()),
          'the sparse auto run\'s pairwise counts differ from the CPU tree')
    res['auto'] = dict(m=AUTO_M, launches=launches_a,
                       iterations=rep_a.iterations,
                       converged=rep_a.converged,
                       objective_auto=svm_a.objective(small.X, small.y),
                       counts_equal_cpu_tree=True,
                       ms_per_iteration=1e3 * rep_a.seconds
                       / rep_a.iterations)
    return res


def _fused_auto_memory(ctx, X, y, w):
    """The memory model of method='auto' on the card: with a budget just
    above what `projected_resident_gib` charges the features, plus what it
    charges to both paths and so omits (the O(m) vectors, 24 m bytes as
    the streaming rule reserves them, and the counting pass's own peak,
    measured alone here), 'auto' keeps the fused oracle, and building it
    and one call allocate within the budget."""
    torch, dev = ctx['torch'], ctx['dev']
    from repro_torch.core import counts as TC
    from repro_torch.core.oracle import PairwiseOracle, make_oracle
    from repro_torch.data import projected_resident_gib
    m = X.shape[0]
    g = torch.Generator(device=dev)
    g.manual_seed(ctx['seed'])
    yd = torch.as_tensor(y, dtype=torch.float32, device=dev)
    pd = torch.randn(m, generator=g, device=dev)
    _, count_peak, _ = _peak_above(
        torch, None, lambda: TC.make_counter(yd, None, engine='auto')(pd))
    del yd, pd
    proj = projected_resident_gib(X)
    budget = int(proj * 2**30) + 24 * m + count_peak

    def fused():
        o = make_oracle(X, y, method='auto', memory_budget=budget / 2**30,
                        device=dev)
        check(isinstance(o, PairwiseOracle),
              f'method=auto at the projection built {o.name}')
        return o.loss_and_subgrad(w)

    _, peak, _ = _peak_above(torch, None, fused)
    check(peak <= budget, f'the fused CSR oracle allocated {peak} bytes, '
          f'over the {budget}-byte budget at its projection')
    return dict(projected_bytes=int(proj * 2**30), count_peak_bytes=count_peak,
                budget_bytes=budget, max_memory_allocated_above_start=peak)


def _peak_above(torch, base, fn):
    """fn()'s result, the peak bytes allocated on the card during it above
    `base` (the bytes allocated at the phase's start; None: at fn's
    start), and fn's wall milliseconds."""
    torch.cuda.synchronize()
    if base is None:
        base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, torch.cuda.max_memory_allocated() - base,
            1e3 * (time.perf_counter() - t0))


def _stream_call_split(ctx, oracle, w):
    """Where a streamed oracle call goes: its two host passes (numpy, by
    the host's clock) and its counting pass on the card (CUDA events)."""
    torch = ctx['torch']
    import numpy as np
    src, B, depth = oracle._src, oracle.block_rows, oracle.prefetch
    t0 = time.perf_counter()
    p = np.empty(oracle.m, np.float32)
    for lo, hi, payload in src.iter_payloads(B, prefetch=depth):
        p[lo:hi] = src._payload_matvec(payload, w)
    t1 = time.perf_counter()
    v = np.random.default_rng(ctx['seed']).normal(size=oracle.m) * 1e-9
    for lo, hi, payload in src.iter_payloads(B, prefetch=depth):
        src._payload_rmatvec(payload, v[lo:hi])
    t2 = time.perf_counter()
    count, pt = oracle._counter(), torch.as_tensor(p, device=ctx['dev'])
    return dict(host_matvec_pass_ms=1e3 * (t1 - t0),
                host_rmatvec_pass_ms=1e3 * (t2 - t1),
                counting_ms=time_ms(torch, lambda: count(pt), 3))


def phase_stream(ctx):
    """Streamed CSR at reuters_1m under a memory budget of half the
    features' fused residency: method='auto' must stream, the card's
    allocations must stay inside the budget at prefetch 0 and 1, both
    depths must give bit-identical (loss, a) at one block size, and the
    streamed fit must reach the resident fit's objective within eps.
    Five grades through the stream count with the rank-counts kernel."""
    torch, dev = ctx['torch'], ctx['dev']
    import numpy as np
    from repro_torch.core.oracle import StreamingOracle, make_oracle
    from repro_torch.data import projected_resident_gib
    data = ctx['reuters']
    X, y = data.X, data.y
    budget_bytes = int(STREAM_BUDGET_GIB * 2**30)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    w_np = ctx['w_sparse']
    res = dict(m=M, n=REUTERS_N, memory_budget_gib=STREAM_BUDGET_GIB,
               memory_budget_bytes=budget_bytes,
               projected_resident_gib=projected_resident_gib(X),
               allocated_at_start=base)
    peaks = {}
    calls = {}
    for depth in (0, 1):
        o = make_oracle(X, y, method='auto', memory_budget=STREAM_BUDGET_GIB,
                        prefetch=depth, device=dev)
        check(isinstance(o, StreamingOracle) and o.name == 'stream/csr',
              f'method=auto over budget built {o.name}')
        out, peak, call_ms = _peak_above(torch, base,
                                         lambda: o.loss_and_subgrad(w_np))
        peaks[depth] = peak
        calls[depth] = out
        res[f'prefetch{depth}'] = dict(
            block_rows=o.block_rows, n_blocks=o._nblk,
            block_resident_bytes=o.block_resident_bytes(),
            max_memory_allocated_above_start=peak, call_ms=call_ms)
        check(peak <= budget_bytes,
              f'prefetch {depth}: {peak} bytes on the card above the '
              f'phase start, over the {budget_bytes}-byte budget')
        if depth == 1:
            b1 = o.block_rows
            res['call_split'] = _stream_call_split(ctx, o, w_np)
        del o
    # Bit-identity across depths at one block size (the auto rule halves
    # the block under double buffering, and a different partition sums a
    # in another order).
    o0 = StreamingOracle(X, y, block_rows=b1, prefetch=0, device=dev)
    l0, a0 = o0.loss_and_subgrad(w_np)
    l1, a1 = calls[1]
    check(torch.equal(l0, l1) and np.array_equal(a0, a1),
          'prefetch 0 and 1 differ at one block size')
    res['prefetch_identical'] = True
    del o0, calls
    # The streamed fit, prefetch 1: the host driver over the host passes.
    _reset_counts()
    kw = dict(lam=SPARSE_LAM, eps=EPS, max_iter=MAX_ITER)
    (svm, rep), peak, _ = _peak_above(torch, base, lambda: _fit(
        ctx, X, y, method='stream', memory_budget=STREAM_BUDGET_GIB,
        prefetch=1, **kw))
    check(peak <= budget_bytes,
          f'the streamed fit held {peak} bytes above the phase start')
    j = svm.objective(X, y)
    check(abs(j - ctx['sparse_objective']) <= EPS,
          f'streamed objective {j} vs resident {ctx["sparse_objective"]}')
    res['fit'] = dict(oracle=svm.oracle_.name, prefetch=1,
                      block_rows=svm.oracle_.block_rows,
                      max_memory_allocated_above_start=peak,
                      launches=_counts(), iterations=rep.iterations,
                      converged=rep.converged, gap=rep.gap,
                      solver=rep.solver, seconds=rep.seconds,
                      ms_per_iteration=1e3 * rep.seconds / rep.iterations,
                      objective=j, objective_resident=ctx['sparse_objective'])
    del svm
    # Five grades through the stream: the rank-counts kernel counts.
    y5 = ctx['reuters_graded']
    _reset_counts()
    o5 = StreamingOracle(X, y5, memory_budget=STREAM_BUDGET_GIB,
                         prefetch=1, device=dev)
    (l5, _), peak5, _ = _peak_above(torch, base,
                                 lambda: o5.loss_and_subgrad(w_np))
    launches5 = _counts()
    check(launches5['rank_counts'] >= 1,
          'the graded stream did not count with the rank-counts kernel')
    check(peak5 <= budget_bytes,
          f'the graded stream held {peak5} bytes above the phase start')
    res['graded'] = dict(launches=launches5, loss=float(l5),
                         max_memory_allocated_above_start=peak5)
    return res


def phase_losses(ctx):
    """The loss axis on the card: 'toppush' and 'poshinge' at the main
    shape in queries, the weighted tree's fallback for engine='pallas',
    'poshinge' at reuters_1m resident and streamed, and the r-level
    baseline against the tree."""
    torch, dev = ctx['torch'], ctx['dev']
    import numpy as np
    from repro_torch.core import counts as TC
    from repro_torch.core import oracle as TO
    from repro_torch.core.rank_loss import position_weighted_error, top1_error
    from repro_torch.kernels.platform import full_f32
    X, y = ctx['X'], ctx['y']
    g = torch.arange(M, device=dev) // QUERY_ROWS
    w = torch.as_tensor(ctx['w_main'], dtype=torch.float32, device=dev)
    with full_f32():
        p = X @ w
    pc, yc = p.cpu(), y.cpu()
    res = dict(m=M, n=N_FEATURES, queries=M // QUERY_ROWS,
               query_rows=QUERY_ROWS)
    oracles = {}
    for loss in ('toppush', 'poshinge'):
        o = TO.make_oracle(X, y, groups=g, loss=loss, device=dev)
        oracles[loss] = o
        (l1, a1), call_peak, call_ms = _peak_above(
            torch, None, lambda: o.loss_and_subgrad(w))
        l2, a2 = o.loss_and_subgrad(w)
        check(torch.equal(l1, l2) and torch.equal(a1, a2),
              f'two {loss} calls on the card differ')
        # its counting pass on the CPU, on the card's scores
        count, inv_n, pw = o._counter(), o._inv_n_dev, o._pw
        pwc = None if pw is None else pw.cpu()
        count_c = TO._loss_counter(yc, o._g.cpu(), 'tree', 0, loss, pwc)
        with full_f32():
            (ld, cdd), pass_peak, _ = _peak_above(
                torch, None, lambda: TO._loss_and_coeffs(p, count, inv_n,
                                                         pw, loss))
            pass_ms = time_ms(torch, lambda: TO._loss_and_coeffs(
                p, count, inv_n, pw, loss), reps=3)
        t0 = time.perf_counter()
        lc, cdc = TO._loss_and_coeffs(pc, count_c, inv_n.cpu(), pwc, loss)
        cpu_s = time.perf_counter() - t0
        rel = abs(float(ld) - float(lc)) / abs(float(lc))
        check(rel <= 1e-6, f'{loss} loss on the card vs the CPU: {rel}')
        row = dict(norm=o.norm, loss=float(l1), loss_rel_err_vs_cpu=rel,
                   call_ms=call_ms, call_peak_bytes=call_peak,
                   pass_ms=pass_ms, pass_peak_bytes=pass_peak,
                   cpu_pass_seconds=cpu_s, deterministic=True)
        if loss == 'toppush':
            check(torch.equal(cdd.cpu(), cdc),
                  'TopPush coefficients differ card to CPU')
            row['coefficients_equal_cpu'] = True
        else:
            (cw, d), (cwc, dc) = count(p), count_c(pc)
            check(torch.equal(d.cpu(), dc), 'weighted d differs card to CPU')
            err = float((cw.cpu() - cwc).abs().max())
            check(err <= 1e-6 * float(pw.sum()),
                  f'weighted c~ differs card to CPU by {err}')
            row.update(d_equal_cpu=True, c_weighted_max_abs_err=err,
                       sum_v=float(pw.sum()))
        res[loss] = row
    # engine='pallas' under 'poshinge': the weighted tree, no kernel
    o = oracles['poshinge']
    _reset_counts()
    op = TO.make_oracle(X, y, groups=g, loss='poshinge', engine='pallas',
                        device=dev)
    lp, ap = op.loss_and_subgrad(w)
    cwp, dp = TC.counts_dispatch(p, y, g, engine='pallas', v=o._pw)
    launched = _counts()
    check(launched['rank_counts'] == 0 and launched['pairwise'] == 0,
          f'poshinge with engine=pallas launched {launched}')
    lt, at = o.loss_and_subgrad(w)
    cwt, dt = TC.counts_dispatch(p, y, g, engine='tree', v=o._pw)
    check(torch.equal(lp, lt) and torch.equal(ap, at)
          and torch.equal(cwp, cwt) and torch.equal(dp, dt),
          'engine=pallas under poshinge differs from the weighted tree')
    res['pallas_fallback'] = dict(launches=launched, equal_to_tree=True)
    del op, oracles, o
    # device-driver fits to eps, and the metrics at their w
    for loss in ('toppush', 'poshinge'):
        svm, rep = _fit(ctx, X, y, groups=g, lam=LAM, eps=EPS, method='tree',
                        max_iter=MAX_ITER, loss=loss, solver='device')
        wf = torch.as_tensor(svm.w_, dtype=torch.float32, device=dev)
        with full_f32():
            pf = X @ wf
        metrics = {}
        for name, fn in (('top1_error', top1_error),
                         ('position_weighted_error', position_weighted_error)):
            on_card = float(fn(pf, y, g))
            on_cpu = float(fn(pf.cpu(), yc, g.cpu()))
            check(abs(on_card - on_cpu) <= 1e-6,
                  f'{name} at the {loss} fit: card {on_card}, CPU {on_cpu}')
            metrics[name] = on_card
        res[loss]['fit'] = dict(
            iterations=rep.iterations, converged=rep.converged, gap=rep.gap,
            solver=rep.solver, seconds=rep.seconds,
            ms_per_iteration=1e3 * rep.seconds / rep.iterations,
            objective=svm.objective(X, y, groups=g), **metrics)
        del svm
    del p, pc
    res['reuters_poshinge'] = _reuters_poshinge(ctx)
    res['rlevel'] = _rlevel_sweep(ctx)
    return res


def _fit_row(rep, seconds=None):
    secs = rep.seconds if seconds is None else seconds
    return dict(iterations=rep.iterations, converged=rep.converged,
                objective=rep.objective, gap=rep.gap, solver=rep.solver,
                seconds=secs, ms_per_iteration=1e3 * secs / rep.iterations)


def _objective_on(ctx, w, X, y, g):
    """J(w) on (X, y, g) at lambda LAM, as `RankSVM.objective` takes it."""
    from repro_torch.core.ranksvm import RankSVM
    svm = RankSVM(lam=LAM, device=ctx['dev'])
    svm.w_ = w
    return svm.objective(X, y, g)


def _twin(svm):
    """A second copy of a fitted estimator for another refit: a store of
    its own over the same training tensors (no copy) and the same fitted
    bundle state, which no solve updates in place."""
    import copy
    from repro_torch.core.incremental import IncrementalFit
    from repro_torch.data import BlockStore
    inc = svm.incremental_
    twin = copy.copy(svm)
    store = BlockStore()
    for bid in inc.store.block_ids:
        mem = inc.store.member(bid)
        store.append(mem.source.tensor, mem.y, mem.groups)
    twin.incremental_ = IncrementalFit(store, inc.state,
                                       svm._ledger_norm(svm.oracle_),
                                       partials_fn=twin._partials_fn())
    return twin


def _count_revalidation(inc, tally):
    """Wrap an `IncrementalFit`'s revalidation hook so that the
    rank-counts launches it makes add to tally['revalidate']."""
    from repro_torch.kernels.rank_counts import ops as RC
    inner = inc._partials_fn

    def counted(*args):
        before = RC.RANK_COUNTS.launches
        out = inner(*args)
        tally['revalidate'] += RC.RANK_COUNTS.launches - before
        return out

    inc._partials_fn = counted


def _chunk_resume(ctx, oracle, root):
    """`refit_chunk_step` over `oracle` through `runtime.run`: CHUNKS
    chunks uninterrupted, then preempted at FAIL_AT and resumed from the
    checkpoint of chunk CKPT_EVERY * (FAIL_AT // CKPT_EVERY); the two
    final `BundleState`s must be equal bit for bit on the card."""
    torch, dev = ctx['torch'], ctx['dev']
    from repro_torch.checkpoint import restore, save
    from repro_torch.core.bmrm import BundleState, init_bundle_state
    from repro_torch.core.incremental import refit_chunk_step
    from repro_torch.runtime import LoopConfig, SimulatedPreemption, run
    step = refit_chunk_step(oracle, lam=LAM, eps=EPS,
                            sync_every=CHUNK_STEPS)

    def init_fn(device):
        return init_bundle_state(oracle.n, 64, device=device)

    def loop(name, **kw):
        lc = LoopConfig(total_steps=CHUNKS,
                        ckpt_dir=os.path.join(root, name),
                        ckpt_every=CKPT_EVERY, async_ckpt=True)
        return run(step, init_fn, lambda s: None, lc, device=dev, **kw)

    t0 = time.perf_counter()
    state_a, rep_a = loop('a')
    torch.cuda.synchronize()
    secs_a = time.perf_counter() - t0
    try:
        loop('b', fail_at=FAIL_AT)
        check(False, 'the injected preemption did not fire')
    except SimulatedPreemption:
        pass
    state_b, rep_b = loop('b')
    check(rep_b.resumed_from == CKPT_EVERY * (FAIL_AT // CKPT_EVERY),
          f'resumed from {rep_b.resumed_from}')
    differ = [f for f in BundleState._fields
              if not (getattr(state_a, f).is_cuda
                      and torch.equal(getattr(state_a, f),
                                      getattr(state_b, f)))]
    check(not differ, f'the resumed chunk loop differs in {differ}')
    # the checkpoint itself: bytes, and save and restore times
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = save(os.path.join(root, 'timed'), 1, state_a)
    save_ms = 1e3 * (time.perf_counter() - t0)
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    t0 = time.perf_counter()
    back, _ = restore(os.path.join(root, 'timed'),
                      like=init_fn(torch.device('meta')), device=dev)
    torch.cuda.synchronize()
    restore_ms = 1e3 * (time.perf_counter() - t0)
    check(all(torch.equal(a, b) for a, b in zip(state_a, back)),
          'the restored BundleState differs')
    return dict(chunks=CHUNKS, steps_per_chunk=CHUNK_STEPS,
                ckpt_every=CKPT_EVERY, fail_at=FAIL_AT,
                resumed_from=rep_b.resumed_from, bit_identical=True,
                j_best=float(state_a.j_best), gap=float(state_a.gap),
                uninterrupted_seconds=secs_a, ckpt_bytes=nbytes,
                save_ms=save_ms, restore_ms=restore_ms)


def _train_resume(ctx, root):
    """The reduced rwkv6-3b train step (WKV kernels) through `runtime.run`
    on the card: RESUME_STEPS steps uninterrupted, then preempted at
    RESUME_FAIL and resumed; parameters (bf16), master weights, AdamW
    moments and counts must be equal bit for bit."""
    torch, dev = ctx['torch'], ctx['dev']
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.reduced import reduced
    from repro_torch.data import TokenPipeline, TokenPipelineConfig
    from repro_torch.runtime import LoopConfig, SimulatedPreemption, run
    from repro_torch.train.trainer import init_state, make_train_step
    cfg = dataclasses.replace(reduced('rwkv6-3b'), wkv_impl='kernel')
    step_fn = make_train_step(cfg, TrainConfig(
        remat='layer', warmup_steps=1, decay_steps=RESUME_STEPS))
    pipe = TokenPipeline(TokenPipelineConfig(cfg.vocab, RESUME_LEN,
                                             RESUME_BATCH, seed=ctx['seed']))

    def init_fn(device):
        return init_state(cfg, ctx['seed'], device=device)

    def loop(name, **kw):
        lc = LoopConfig(total_steps=RESUME_STEPS,
                        ckpt_dir=os.path.join(root, name),
                        ckpt_every=RESUME_CKPT, async_ckpt=True)
        return run(step_fn, init_fn, pipe.batch, lc, device=dev, **kw)

    _reset_counts()
    state_a, rep_a = loop('a')
    launches = _counts()
    try:
        loop('b', fail_at=RESUME_FAIL)
        check(False, 'the injected preemption did not fire')
    except SimulatedPreemption:
        pass
    state_b, rep_b = loop('b')
    pa = dict(state_a['params'].named_parameters())
    pb = dict(state_b['params'].named_parameters())
    differ = [k for k in pa
              if pb[k].dtype != pa[k].dtype or not pb[k].is_cuda
              or not torch.equal(pa[k].view(torch.int16),
                                 pb[k].view(torch.int16))
              or not all(torch.equal(state_a['opt']['mu'][k][f],
                                     state_b['opt']['mu'][k][f])
                         for f in ('master', 'm', 'v'))]
    check(not differ and torch.equal(state_a['opt']['count'],
                                     state_b['opt']['count'])
          and torch.equal(state_a['step'], state_b['step']),
          f'the resumed train state differs in {differ[:5]}')
    check(launches['wkv_fwd'] > 0 and launches['wkv_bwd'] > 0,
          f'the reduced train steps launched {launches}')
    check(rep_b.losses == rep_a.losses[rep_b.resumed_from:],
          'the resumed losses differ from the uninterrupted tail')
    return dict(steps=RESUME_STEPS, ckpt_every=RESUME_CKPT,
                fail_at=RESUME_FAIL, resumed_from=rep_b.resumed_from,
                leaves=len(pa), bf16_leaves=sum(
                    p.dtype == torch.bfloat16 for p in pa.values()),
                bit_identical=True, wkv_launches=launches,
                losses=rep_a.losses)


def _grouped_counts_check(ctx, parts):
    """The grouped 'pallas' counter (`core.counts._grouped_rank_counter`:
    offset scores through the rank-counts kernel, cross-query pairs
    subtracted) against the grouped tree on the same scores, at the
    refit phase's shapes and at real weights (the main fit's w and the
    generator's w_true): (c, d) bit-equal, one kernel launch a call.
    `parts` maps a shape's name to its (X, y, g) pieces, concatenated."""
    torch, dev = ctx['torch'], ctx['dev']
    from repro_torch.core.counts import make_counter
    from repro_torch.kernels.rank_counts import ops as RC
    ws = dict(w_main=torch.as_tensor(ctx['w_main'], dtype=torch.float32,
                                     device=dev),
              w_true=ctx['w_true'])
    out = {}
    for name, pieces in parts.items():
        y = torch.cat([p[1] for p in pieces])
        g = torch.cat([p[2] for p in pieces])
        kernel = make_counter(y, g, engine='pallas')
        tree = make_counter(y, g, engine='tree')
        for wname, w in ws.items():
            p = torch.cat([X @ w for X, _, _ in pieces])
            before = RC.RANK_COUNTS.launches
            c, d = kernel(p)
            launched = RC.RANK_COUNTS.launches - before
            ct, dt = tree(p)
            check(launched == 1, f'the grouped pallas counter at {name} '
                  f'launched the rank-counts kernel {launched} times')
            check(torch.equal(c, ct) and torch.equal(d, dt),
                  f'grouped pallas counts differ from the tree at {name}, '
                  f'{wname}: c {int((c != ct).sum())} and d '
                  f'{int((d != dt).sum())} of {len(y)} rows')
            out[f'{name}_{wname}'] = dict(
                m=len(y), queries=int(g.unique().numel()), launches=launched,
                bit_equal=True, c_sum=int(c.sum()), d_sum=int(d.sum()))
    return out


def phase_refit(ctx):
    """Incremental retraining on the main data in 8192 queries: the grouped
    kernel counts held to the tree's; fit, append a drifted block of 1024
    new queries, refit through the ledger and from w alone, against a
    cold fit of the merged data; both again at SWAP_EPS, the ledger one
    hot-swapped into a service; retire the block (an exact subtraction);
    the chunk loop and the reduced train step checkpointed, preempted and
    resumed."""
    torch, dev = ctx['torch'], ctx['dev']
    import tempfile
    import numpy as np
    from repro_torch.core.ranksvm import RankSVM
    from repro_torch.kernels.rank_counts import ops as RC
    from repro_torch.serve import RankingService, Scorer
    X, y = ctx['X'], ctx['y']
    g = torch.arange(M, device=dev) // QUERY_ROWS
    Xn, yn = mslr_drift(torch, ctx['w_true'], ctx['edges'], DELTA_ROWS,
                        ctx['seed'], dev)
    gn = M // QUERY_ROWS + torch.arange(DELTA_ROWS, device=dev) // QUERY_ROWS
    kw = dict(lam=LAM, eps=EPS, method='tree', engine='pallas',
              max_iter=MAX_ITER)
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = dict(m=M, n=N_FEATURES, queries=M // QUERY_ROWS,
               delta_rows=DELTA_ROWS, delta_queries=DELTA_ROWS // QUERY_ROWS,
               drift_shift=DRIFT_SHIFT,
               grade_shares_base=[float((y == k).float().mean())
                                  for k in range(len(GRADE_SHARES))],
               grade_shares_delta=[float((yn == k).float().mean())
                                   for k in range(len(GRADE_SHARES))])
    # the grouped kernel route that every solve below counts through
    res['grouped_counts'] = _grouped_counts_check(
        ctx, dict(merged=((X, y, g), (Xn, yn, gn)), block=((Xn, yn, gn),)))
    _reset_counts()
    svm, rep = _fit(ctx, X, y, g, **kw)
    res['base'] = _fit_row(rep)
    res['base']['launches'] = RC.RANK_COUNTS.launches
    check(rep.converged and RC.RANK_COUNTS.launches >= rep.iterations,
          f'the grouped base fit: {res["base"]}')
    A0, b0 = svm.incremental_.ledger.planes()
    twin_w, twin_r, twin_s, twin_sw = (_twin(svm) for _ in range(4))
    w_base = svm.w_.copy()
    svc = RankingService(svm, micro_batch=False, device=dev)

    tally = dict(revalidate=0)
    _count_revalidation(svm.incremental_, tally)
    before = RC.RANK_COUNTS.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    led = svm.refit(Xn, yn, gn, mode='ledger')
    torch.cuda.synchronize()
    led_secs = time.perf_counter() - t0
    solve_launches = RC.RANK_COUNTS.launches - before - tally['revalidate']
    res['ledger'] = dict(
        _fit_row(led.fit), wall_seconds=led_secs, mode=led.mode,
        n_planes=led.n_planes, revalidate_seconds=led.revalidate_seconds,
        revalidate_launches=tally['revalidate'],
        solve_launches=solve_launches)
    check(led.mode == 'ledger' and led.fit.converged,
          f'the ledger refit: {res["ledger"]}')
    check(tally['revalidate'] >= led.n_planes > 0,
          f'{tally["revalidate"]} rank-counts launches revalidated '
          f'{led.n_planes} planes')
    check(solve_launches >= led.fit.iterations,
          f'{solve_launches} launches in {led.fit.iterations} iterations '
          'of the warm solve')

    Xm, ym, gm = torch.cat([X, Xn]), torch.cat([y, yn]), torch.cat([g, gn])
    cold_svm, cold = _fit(ctx, Xm, ym, gm, **kw)
    res['cold'] = _fit_row(cold)
    del cold_svm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    won = twin_w.refit(Xn, yn, gn, mode='w-only')
    torch.cuda.synchronize()
    res['w_only'] = dict(_fit_row(won.fit),
                         wall_seconds=time.perf_counter() - t0,
                         mode=won.mode)
    for name, r in (('ledger', led), ('w-only', won)):
        check(r.fit.converged and abs(r.fit.objective - cold.objective)
              <= EPS, f'{name} refit J {r.fit.objective} against the cold '
              f'fit {cold.objective}')
    j_base = _objective_on(ctx, w_base, Xm, ym, gm)
    res['base_w_on_merged'] = j_base
    res['w_only']['w_moved'] = not np.array_equal(twin_w.w_, w_base)
    res['ledger']['w_moved'] = not np.array_equal(svm.w_, w_base)
    res['ledger_over_cold'] = dict(
        iterations=led.fit.iterations / cold.iterations,
        seconds=led_secs / cold.seconds)

    # the hot swap: a ledger refit at SWAP_EPS, below what the base w
    # misses the merged optimum by, so its w must move; the w-only refit
    # at the same eps beside it
    check(j_base - cold.objective > SWAP_EPS,
          f'the base w is within SWAP_EPS {SWAP_EPS} of the cold fit '
          f'({j_base} against {cold.objective}): the swap refit need not '
          'move w')
    Xq = Xn[:QUERY_ROWS].cpu().numpy()
    s_old = svc.scores(Xq)
    v0 = svc.version
    swap = {}
    for name, twin, mode in (('ledger', twin_s, 'ledger'),
                             ('w_only', twin_sw, 'w-only')):
        twin.eps = SWAP_EPS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = twin.refit(Xn, yn, gn, mode=mode,
                       weight_store=svc if name == 'ledger' else None)
        torch.cuda.synchronize()
        swap[name] = dict(_fit_row(r.fit),
                          wall_seconds=time.perf_counter() - t0,
                          mode=r.mode, n_planes=r.n_planes,
                          revalidate_seconds=r.revalidate_seconds)
        check(r.mode == mode and r.fit.converged
              and r.fit.objective < j_base
              and r.fit.objective <= cold.objective + SWAP_EPS,
              f'the {name} refit at eps {SWAP_EPS}: {swap[name]} against '
              f'the base w {j_base} and the cold fit {cold.objective}')
    check(abs(twin_s.report_.objective - twin_sw.report_.objective)
          <= SWAP_EPS, 'the ledger and w-only refits at SWAP_EPS differ by '
          'more than it')
    s_new = svc.scores(Xq)
    vals, idx = svc.top_k(Xq, SERVE_K)
    want = np.argsort(-s_new, kind='stable')[:SERVE_K]
    check(svc.version == v0 + 1, f'service version {svc.version} after '
          f'one swap from {v0}')
    check(np.array_equal(idx, want) and np.array_equal(vals, s_new[want]),
          f'top_k {idx.tolist()} {vals.tolist()} differs from the stable '
          f'argsort of the new scores {want.tolist()} '
          f'{s_new[want].tolist()}')
    direct = Scorer(twin_s.w_, device=dev).scores(Xq)
    check(not np.array_equal(twin_s.w_, w_base)
          and np.array_equal(s_new, direct)
          and not np.array_equal(s_old, s_new),
          'the service does not serve the refit weights after the swap '
          f'(largest score move {np.abs(s_new - s_old).max()})')
    svc.close()
    res['hot_swap'] = dict(
        swap, eps=SWAP_EPS, version=svc.version, k=SERVE_K, rows=QUERY_ROWS,
        max_w_move=float(np.abs(twin_s.w_ - w_base).max()),
        max_score_move=float(np.abs(s_new - s_old).max()),
        ledger_over_w_only=dict(
            iterations=swap['ledger']['iterations']
            / swap['w_only']['iterations'],
            seconds=swap['ledger']['wall_seconds']
            / swap['w_only']['wall_seconds']))

    # retire the appended block: an exact subtraction
    inc = twin_r.incremental_
    bid = inc.append(Xn, yn, gn)
    seen = []
    warm = inc.warm_state

    def recording(*args, **kwargs):
        seen.append(inc.ledger.planes())
        return warm(*args, **kwargs)

    inc.warm_state = recording
    ret = twin_r.refit(retire=[bid], mode='ledger')
    check(ret.mode == 'ledger' and ret.retired == (bid,) and seen
          and np.array_equal(seen[0][0], A0)
          and np.array_equal(seen[0][1], b0),
          'the retired ledger is not the base ledger bit for bit')
    check(ret.fit.converged and abs(ret.fit.objective - rep.objective)
          <= EPS, f'the retire refit J {ret.fit.objective} against the '
          f'base fit {rep.objective}')
    res['retire'] = dict(_fit_row(ret.fit), mode=ret.mode,
                         planes_bit_equal=True)

    with tempfile.TemporaryDirectory() as root:
        res['chunk_loop'] = _chunk_resume(ctx, svm.oracle_,
                                          os.path.join(root, 'chunks'))
        ctx['launches']['rank_counts_refit'] = RC.RANK_COUNTS.launches
        res['launches'] = _counts()
        res['train_resume'] = _train_resume(ctx, os.path.join(root, 'train'))
    res['peak_memory_above_start'] = (torch.cuda.max_memory_allocated()
                                      - start)
    del svm, twin_w, twin_r, twin_s, twin_sw, Xm, ym, gm
    torch.cuda.empty_cache()
    return res


def _reuters_poshinge(ctx):
    """'poshinge' at reuters_1m (r ~= m, the weighted tree's case): one
    resident call, and one streamed at STREAM_BUDGET_GIB, prefetch 1."""
    torch, dev = ctx['torch'], ctx['dev']
    import numpy as np
    from repro_torch.core.oracle import (StreamingOracle, TreeOracle,
                                         make_oracle)
    data = ctx['reuters']
    X, y, w = data.X, data.y, ctx['w_sparse']
    budget_bytes = int(STREAM_BUDGET_GIB * 2**30)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    resident = TreeOracle(X, y, loss='poshinge', device=dev)
    (lr, _), peak_r, ms_r = _peak_above(
        torch, None, lambda: resident.loss_and_subgrad(w))
    held = torch.cuda.memory_allocated() - base
    del resident
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    so = make_oracle(X, y, method='auto', memory_budget=STREAM_BUDGET_GIB,
                     loss='poshinge', prefetch=1, device=dev)
    check(isinstance(so, StreamingOracle)
          and so.name == 'stream/csr/poshinge',
          f'method=auto over budget built {so.name}')
    (ls, _), peak_s, ms_s = _peak_above(torch, base,
                                       lambda: so.loss_and_subgrad(w))
    check(peak_s <= budget_bytes,
          f'the streamed poshinge call held {peak_s} bytes above its '
          f'start, over the {budget_bytes}-byte budget')
    rel = abs(float(ls) - float(lr)) / abs(float(lr))
    check(rel <= 1e-5, f'streamed poshinge loss vs resident: {rel}')
    return dict(m=M, distinct_utilities=int(np.unique(y).size),
                resident=dict(loss=float(lr), call_ms=ms_r,
                              oracle_bytes=held,
                              call_peak_bytes_above_oracle=peak_r),
                stream=dict(loss=float(ls), call_ms=ms_s,
                            block_rows=so.block_rows, n_blocks=so._nblk,
                            max_memory_allocated_above_start=peak_s,
                            budget_bytes=budget_bytes),
                loss_rel_err_stream_vs_resident=rel)


def _rlevel_sweep(ctx):
    """counts_rlevel against the tree at m = RLEVEL_M (CUDA events): bit
    for bit at every r, and the first r at which the tree is faster."""
    torch, dev = ctx['torch'], ctx['dev']
    from repro_torch.core import counts as TC
    from repro_torch.core.joachims import counts_rlevel
    g = torch.Generator(device=dev)
    g.manual_seed(ctx['seed'] + 21)
    p = torch.randn(RLEVEL_M, generator=g, device=dev)
    rows = []
    for r in RLEVELS:
        yl = torch.randint(0, r, (RLEVEL_M,), generator=g, device=dev,
                           dtype=torch.int32)
        yf = yl.float()
        c, d = counts_rlevel(p, yl, r)
        cf, df = TC.counts_fused(p, yf)
        check(torch.equal(c, cf) and torch.equal(d, df),
              f'r-level counts differ from the tree at r = {r}')
        _, peak, _ = _peak_above(torch, None,
                                 lambda: counts_rlevel(p, yl, r))
        rows.append(dict(
            r=r, rlevel_ms=time_ms(torch, lambda: counts_rlevel(p, yl, r),
                                   reps=5),
            tree_ms=time_ms(torch, lambda: TC.counts_fused(p, yf), reps=5),
            rlevel_peak_bytes=peak))
    slower = [row['r'] for row in rows if row['rlevel_ms'] > row['tree_ms']]
    return dict(m=RLEVEL_M, rows=rows, counts_equal_tree=True,
                tree_faster_from_r=min(slower, default=None))


def _rank_counts_row(ctx):
    """The rank-counts call at the main shapes: `ms` the device time of the
    kernels after the sort (one launcher call: gather, scan, count),
    `events_ms` the same launches back to back by CUDA events (host
    launch cost included), `wrapper_ms` the whole call p -> (c, d), with
    its device launches and busy share from the profiler."""
    torch, dev = ctx['torch'], ctx['dev']
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.rank_counts import ops as RC
    from repro_torch.kernels.rank_counts.ref import rank_counts_plain
    X, y = ctx['X'], ctx['y']
    p = X @ torch.as_tensor(ctx['w_main'], dtype=torch.float32, device=dev)
    ranks = RC._compact_ranks(y)
    n_ranks = int(ranks.max()) + 1
    tj = RC.pick_tj(n_ranks)
    args = (*torch.sort(p, stable=True), ranks, n_ranks)
    ms = device_ms(torch, lambda: RC._launch(*args, RC.TI, tj), 'rc_', 50,
                   per_call=len(RC_KERNELS))
    events_ms = time_ms(torch, lambda: RC._launch(*args, RC.TI, tj), reps=50)
    got = RC._launch(*args, RC.TI, tj)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = rank_counts_plain(*args, tj)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = max(int((got[0] - want[0]).abs().max()),
              int((got[1] - want[1]).abs().max()))
    check(err == 0 and _counts_equal(torch, got, want),
          'rank-counts kernels != plain at the main shapes')
    count = RC.rank_counter(y)
    wrapper_ms = time_ms(torch, lambda: count(p), reps=20)
    calls = 10
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                count(p)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        busy, n_ops, _ = _device_busy(prof)
        seen = {e.name for e in prof.events()
                if e.device_type == DeviceType.CUDA}
        if all(any(k in name for name in seen) for k in RC_KERNELS):
            break
    else:
        check(False, f'{PROFILE_TRIES} profiler windows over the '
              f'rank-counts call missed one of {RC_KERNELS}')
    # The least the card could take is the function's own bytes: p and
    # the ranks read once, c and d written once (16 m). The tables are
    # the design's scratch, not the function's, so they do not enter the
    # bound (they are printed as `table_bytes`).
    m = p.shape[0]
    yr, planes, table = got[2]
    main, path, refit = (ctx['launches']['rank_counts'],
                         ctx['launches']['rank_counts_path'],
                         ctx['launches']['rank_counts_refit'])
    return _row('rank_counts', 'src/repro_torch/kernels/csrc/rank_counts.cu',
                'src/repro/kernels/rank_counts/kernel.py:59',
                main + path + refit, err, ms, plain_ms, 16 * m,
                None, launches_main=main, launches_path=path,
                launches_refit=refit,
                m=m, n_ranks=n_ranks, tj=tj, events_ms=events_ms,
                band_compares=0,
                table_bytes=4 * (planes.numel() + table.numel()),
                wrapper_ms=wrapper_ms,
                device_launches_per_call=n_ops / calls,
                call_device_busy_share=busy / wall_us,
                call_device_busy_ms=busy / 1e3 / calls,
                top_kernels=_top_kernels(prof, k=8),
                launches_per_iteration=ctx['launches']['rank_counts']
                / ctx['main_iterations'])


def _pairwise_row(ctx):
    """The pairwise kernel at the auto cell's shape: `ms` its device time,
    `events_ms` its launches back to back by CUDA events (host launch
    cost included)."""
    torch = ctx['torch']
    from repro_torch.kernels.pairwise_rank import ops as PR
    from repro_torch.kernels.pairwise_rank.ref import pairwise_counts_plain
    X, y, w = ctx['auto_data']
    p = X @ torch.as_tensor(w, dtype=torch.float32, device=X.device)
    ms = device_ms(torch, lambda: PR._launch(p, y), 'pairwise_counts', 50)
    events_ms = time_ms(torch, lambda: PR._launch(p, y), reps=50)
    c, d = PR._launch(p, y)
    plain_ms = time_ms(torch, lambda: pairwise_counts_plain(p, y), reps=5)
    cp, dp = pairwise_counts_plain(p, y)
    err = max(int((c - cp).abs().max()), int((d - dp).abs().max()))
    check(err == 0, 'pairwise kernel != plain at the main shapes')
    m = p.shape[0]
    return _row('pairwise_rank', 'src/repro_torch/kernels/csrc/'
                'pairwise_rank.cu',
                'src/repro/kernels/pairwise_rank/kernel.py:30',
                ctx['launches']['pairwise'], err, ms, plain_ms, 16 * m,
                4 * m * m, m=m, events_ms=events_ms, geometry=PR.geometry(m),
                launches_per_iteration=ctx['launches']['pairwise']
                / ctx['auto_iterations'])


def _row(name, source, replaces, launches, err, ms, plain_ms, nbytes, ops,
         **extra):
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 0.0 if ops is None else 1e3 * ops / F32_OPS_PER_S
    return dict(name=name, route='cuda', source=source, replaces=replaces,
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by='bytes' if t_bytes >= t_ops else 'operations',
                library_ms=None, bytes=nbytes, operations=ops, **extra)


def _randomize_mixing(torch, model, g):
    """The init leaves mu_*, w0 and u at zero, which would bypass the
    token-shift lerp, the decay offset and the bonus; give them seeded
    values, as the port's parity tests do."""
    with torch.no_grad():
        for lay in model.layers:
            for blk in (lay.tm, lay.cm):
                for name, p in blk.named_parameters():
                    if name.startswith('mu_'):
                        p.copy_(torch.rand(p.shape, generator=g,
                                           device=p.device))
            w0, u = lay.tm.w0, lay.tm.u
            w0.copy_(3 * torch.rand(w0.shape, generator=g,
                                    device=w0.device) - 2)
            u.copy_(0.5 * torch.randn(u.shape, generator=g,
                                      device=u.device))


def _cut(cfg, model, depth):
    """The model cut to its first `depth` layers (the same weights, no
    copy), with its config; a layer 0 declared apart counts as one."""
    from repro_torch.models import lm as LM
    if depth >= cfg.n_layers:
        return cfg, model
    stacked = depth - (1 if cfg.dense_d_ff_first else 0)
    cfg = dataclasses.replace(cfg, n_layers=depth)
    return cfg, LM.from_state_dict(cfg, {
        k: v for k, v in model.state_dict().items()
        if not k.startswith('layers.') or int(k.split('.')[1]) < stacked})


def _lm_consistency(ctx, model, cfg, g, depth):
    """Last-position logits (float32) of the model cut to its first
    `depth` layers (the same weights, no copy), at B = CHECK_BATCH,
    T = CHECK_LEN: prefill(T-1) + decode(1) against the full forward on
    each WKV route ('pd_<route>'), and the kernel route's full forward
    against the scan route's. Largest absolute differences, the logits'
    scale, and the differences' norms relative to the logits' norm."""
    torch = ctx['torch']
    from repro_torch.kernels.platform import full_f32
    from repro_torch.models import lm as LM
    cfg, model = _cut(cfg, model, depth)
    toks = torch.randint(0, cfg.vocab, (CHECK_BATCH, CHECK_LEN),
                         generator=g, device=ctx['dev'], dtype=torch.int32)
    logits, out = {}, dict(depth=depth)

    def diff(name, a, b):
        out[f'{name}_max_abs_err'] = float((a - b).abs().max())
        out[f'{name}_rel_norm'] = float((a - b).norm() / b.norm())

    for impl in ('kernel', 'scan'):
        c = dataclasses.replace(cfg, wkv_impl=impl)
        with torch.no_grad(), full_f32():
            hid = LM.forward_train(model, c, {'tokens': toks})
            full = hid[:, -1].float() @ LM.lm_head_weight(model, c).float()
        cache, _ = LM.forward_prefill(model, c, {'tokens': toks[:, :-1]})
        _, dec = LM.forward_decode(model, c, cache,
                                   {'tokens': toks[:, -1:]}, CHECK_LEN - 1)
        check(bool(torch.isfinite(full).all() and torch.isfinite(dec).all()),
              f'non-finite logits on the {impl} route')
        logits[impl] = full
        diff(f'pd_{impl}', dec, full)
    diff('kernel_vs_scan', logits['kernel'], logits['scan'])
    out['logit_scale'] = float(logits['scan'].abs().max())
    return out


def phase_lm(ctx):
    torch, dev = ctx['torch'], ctx['dev']
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get
    from repro_torch.kernels.wkv import ops as W
    from repro_torch.kernels.wkv.ref import wkv_forward_plain
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import lm as LM
    cfg = dataclasses.replace(get('rwkv6-3b'), wkv_impl='kernel')
    t0 = time.perf_counter()
    model = LM.init_model(cfg, seed=ctx['seed'], device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(ctx['seed'] + 6)
    _randomize_mixing(torch, model, g)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=g,
                            device=dev, dtype=torch.int32)

    def serve(tokens, steps):
        """Prefill `tokens`, then `steps` greedy decode steps; returns the
        generated ids, the prefill and decode seconds, and the kernel's
        launches in each."""
        _reset_counts()
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        cache, logits = prefill(model, {'tokens': tokens})
        torch.cuda.synchronize()
        t_b = time.perf_counter()
        n_pre = _counts()['wkv_fwd']
        ok = bool(torch.isfinite(logits).all())
        out = [logits.argmax(-1)]
        _reset_counts()
        t_c = time.perf_counter()
        for i in range(steps):
            cache, logits = decode(model, cache, {'tokens': out[-1][:, None]
                                                  .to(torch.int32)},
                                   tokens.shape[1] + i)
            ok &= bool(torch.isfinite(logits).all())
            out.append(logits.argmax(-1))
        torch.cuda.synchronize()
        t_d = time.perf_counter()
        return (torch.stack(out, 1), t_b - t_a, t_d - t_c, n_pre,
                _counts()['wkv_fwd'], ok)

    serve(prompts[:, :64], 2)                     # warm: libraries, cuBLAS
    torch.cuda.reset_peak_memory_stats()
    gen, pre_s, dec_s, n_pre, n_dec, finite = serve(prompts, LM_DECODE)
    check(n_pre == cfg.n_layers, f'the WKV kernel launched {n_pre} times in '
          f'a prefill of {cfg.n_layers} layers')
    check(n_dec == 0, f'the WKV kernel launched {n_dec} times in decode')
    check(finite, 'non-finite logits in prefill or decode')
    ctx['launches']['wkv_fwd'] = n_pre
    res = dict(n_params=sum(p.numel() for p in model.parameters()),
               layers=cfg.n_layers, d_model=cfg.d_model, heads=cfg.n_heads,
               batch=LM_BATCH, prompt=LM_PROMPT, decode_steps=LM_DECODE,
               init_seconds=init_s, prefill_seconds=pre_s,
               prefill_tokens_per_s=LM_BATCH * LM_PROMPT / pre_s,
               decode_ms_per_token=1e3 * dec_s / LM_DECODE,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               wkv_launches_prefill=n_pre, wkv_launches_decode=n_dec,
               generated_ids_first_row=gen[0, :8].tolist())

    # one prefill and a few decode steps under the profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_a = time.perf_counter()
        cache, logits = prefill(model, {'tokens': prompts})
        torch.cuda.synchronize()
        wall_pre = 1e6 * (time.perf_counter() - t_a)
    busy, n_ops, wkv_us = _device_busy(prof, 'wkv_fwd_kernel')
    res['profile_prefill'] = dict(
        wall_ms=wall_pre / 1e3, device_busy_ms=busy / 1e3,
        idle_share=1.0 - busy / wall_pre if n_ops else None,
        device_ops=n_ops, wkv_kernel_ms=wkv_us / 1e3,
        wkv_share_of_device_time=wkv_us / busy if busy else None,
        top_kernels=_top_kernels(prof))
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_a = time.perf_counter()
        for i in range(4):
            cache, logits = decode(model, cache, {'tokens': tok},
                                   LM_PROMPT + i)
            tok = logits.argmax(-1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        wall_dec = 1e6 * (time.perf_counter() - t_a)
    busy, n_ops, _ = _device_busy(prof)
    res['profile_decode'] = dict(
        ms_per_step=wall_dec / 4e3, device_busy_ms_per_step=busy / 4e3,
        idle_share=1.0 - busy / wall_dec if n_ops else None,
        device_ops_per_step=n_ops / 4, top_kernels=_top_kernels(prof))
    del cache, logits

    # LM_BARS: the reference's own bars hold the first two layers of the
    # full-width weights, the depth they were set at (its reduced
    # configs): prefill + decode on the scan route within 0.05
    # (tests/test_models.py), and the kernel route within 0.05 of the
    # logits' scale of the scan route (tests/test_wkv_kernel.py), for the
    # full forward and for prefill + decode (whose last token runs the
    # scan). Over all 32 layers bf16 rounding differences accumulate (the
    # JAX package's own route difference there exceeds those bars:
    # tools/rwkv_depth_drift.py), so the full depth is held to a bar
    # that only a fault can cross: differences under 0.25 of the logits'
    # norm, where a wrong state, layout or hand-off gives about 1.
    short = _lm_consistency(ctx, model, cfg, g, 2)
    full_depth = _lm_consistency(ctx, model, cfg, g, cfg.n_layers)
    res['consistency'] = [short, full_depth]
    bar = 0.05 * short['logit_scale']
    check(short['pd_scan_max_abs_err'] <= 0.05
          and short['pd_kernel_max_abs_err'] <= bar
          and short['kernel_vs_scan_max_abs_err'] <= bar,
          f'logits outside the bars at depth 2: {short}')
    check(all(full_depth[f'{k}_rel_norm'] <= 0.25
              for k in ('pd_scan', 'pd_kernel', 'kernel_vs_scan')),
          f'logits differ by a fault at full depth: {full_depth}')
    del model
    torch.cuda.empty_cache()

    # the kernel at the prefill shape (N = B*H, T, K), as the path calls it
    n, kk = LM_BATCH * cfg.n_heads, cfg.rwkv_head_dim
    args = _wkv_inputs(torch, n, LM_PROMPT, kk, torch.bfloat16, dev, g)
    chunk = W._pick_chunk(LM_PROMPT)
    ms = time_ms(torch, lambda: W._launch(*args, chunk, False), reps=10)
    ms_bnd = time_ms(torch, lambda: W._launch(*args, chunk, True), reps=10)
    got = W._launch(*args, chunk, False)
    torch.cuda.synchronize()
    t_a = time.perf_counter()
    want = wkv_forward_plain(*args, chunk=chunk, boundaries=False)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t_a)
    errs = _wkv_compare(torch, got, want)
    check(errs['o_inside'] and errs['sT_rel_err'] <= 1e-5,
          f'WKV kernel != plain at the prefill shape: {errs}')
    # bytes: r, k, v, o bf16 and w float32 (N*T*K each), u, s0 and sT
    # float32, each read or written once; operations: 5 K*K per (n, t):
    # 2 for o's products and sums, 3 for the state's decay, product and
    # sum (the bonus is O(K) per step, through sum_k r u k)
    nt = n * LM_PROMPT
    nbytes = nt * kk * (2 * 4 + 4) + 4 * n * kk + 2 * 4 * n * kk * kk
    ops = 5 * kk * kk * nt
    ctx['wkv_row'] = _row(
        'wkv_fwd', 'src/repro_torch/kernels/csrc/wkv_fwd.cu',
        'src/repro/kernels/wkv/kernel.py:49', ctx['launches']['wkv_fwd'],
        errs['o_max_abs_err'], ms, plain_ms, nbytes, ops,
        shape=[n, LM_PROMPT, kk], geometry=W.fwd_geometry(kk),
        ms_with_boundaries=ms_bnd,
        launches_per_prefill=ctx['launches']['wkv_fwd'],
        share_of_prefill_layer=ms / (1e3 * pre_s / cfg.n_layers))
    res['wkv_kernel_ms'] = ms
    del args, got, want
    torch.cuda.empty_cache()
    return res


def _draw_biases(torch, model, g):
    """The QKV biases initialize to zero, which would leave the bias add
    unexercised; give them seeded values, as the CPU tests do."""
    with torch.no_grad():
        for lay in model.layers:
            for name in ('bq', 'bk', 'bv'):
                if hasattr(lay.attn, name):
                    b = getattr(lay.attn, name)
                    b.copy_(0.5 * torch.randn(b.shape, generator=g,
                                              device=b.device))


def _dense_batch(torch, cfg, b, n_tok, g, dev):
    """(full batch, its first positions but the last, the last position's
    decode batch, positions in all) of `n_tok` seeded tokens, with the
    config's frontend inputs as the train CLI makes them
    (`repro_torch.data.frontend_inputs`): the tokens, image embeddings
    before them, or audio frames in their place."""
    from repro_torch.data import frontend_inputs
    toks = torch.randint(0, cfg.vocab, (b, n_tok), generator=g, device=dev,
                         dtype=torch.int32)
    full = {k: torch.as_tensor(v, device=dev) for k, v in frontend_inputs(
        cfg, b, g.initial_seed())(0, toks.cpu().numpy()).items()}
    pre = {k: v if k == 'image_embeds' else v[:, :-1]
           for k, v in full.items()}
    last = {k: v[:, -1:] for k, v in full.items() if k != 'image_embeds'}
    front = cfg.frontend_tokens if cfg.frontend == 'vision' else 0
    return full, pre, last, front + n_tok


def _dense_consistency(ctx, model, cfg, g, depth):
    """Last-position logits (float32) of the model cut to its first
    `depth` layers, at B = CHECK_BATCH and CHECK_LEN tokens (plus the
    image embeddings of a vision model): prefill of all positions but
    the last, the cache grown by one slot, and one decode step, against
    the full forward. Largest absolute difference, the logits' scale,
    and the difference's norm relative to the logits' norm."""
    torch = ctx['torch']
    from repro_torch.convert import pad_cache
    from repro_torch.models import lm as LM
    cfg, model = _cut(cfg, model, depth)
    full, pre, last, s = _dense_batch(torch, cfg, CHECK_BATCH, CHECK_LEN, g,
                                      ctx['dev'])
    with torch.no_grad():
        want = LM._last_logits(model, cfg, LM.forward_train(model, cfg, full))
    cache, _ = LM.forward_prefill(model, cfg, pre)
    _, dec = LM.forward_decode(model, cfg, pad_cache(cache, s), last, s - 1)
    check(bool(torch.isfinite(want).all() and torch.isfinite(dec).all()),
          f'non-finite logits at depth {depth}')
    return dict(depth=depth, positions=s,
                pd_max_abs_err=float((dec - want).abs().max()),
                pd_rel_norm=float((dec - want).norm() / want.norm()),
                logit_scale=float(want.abs().max()))


def _held(torch, got, want, rel, peak):
    """(relative norm, largest difference over the largest value) of got
    against want, both float32 on the CPU, and whether both are inside
    the bars."""
    got, want = got.float().cpu(), want.float()
    r = float((got - want).norm() / want.norm())
    p = float((got - want).abs().max() / want.abs().max())
    return r, p, bool(torch.isfinite(got).all()) and r < rel and p <= peak


def _dense_card_vs_cpu(ctx, model, cfg, g):
    """The model's first two layers (full width) on the card and, copied,
    on the CPU: prefill logits and cache at B = CHECK_BATCH, T =
    CHECK_LEN within the CPU tests' bars. The cache bars were measured
    one layer's projections deep (tests/test_torch_dense_lm.py), which
    is layer 0's cache here; layer 1's keys and values lie a whole
    full-width layer deeper and are held, with the logits, to the model
    bars."""
    torch = ctx['torch']
    from repro_torch.models import lm as LM
    cfg, model = _cut(cfg, model, 2)
    cpu = LM.from_state_dict(cfg, {k: v.cpu()
                                   for k, v in model.state_dict().items()})
    full, _, _, _ = _dense_batch(torch, cfg, CHECK_BATCH, CHECK_LEN, g,
                                 ctx['dev'])
    cache, lg = LM.forward_prefill(model, cfg, full)
    t_a = time.perf_counter()
    cache_c, lg_c = LM.forward_prefill(cpu, cfg, {k: v.cpu()
                                                 for k, v in full.items()})
    out = dict(cpu_prefill_seconds=time.perf_counter() - t_a)
    ok = True
    for name, got, want, bars in (
            ('logits', lg, lg_c, DENSE_MODEL_BARS),
            ('k0', cache['k'][0], cache_c['k'][0], DENSE_CACHE_BARS),
            ('v0', cache['v'][0], cache_c['v'][0], DENSE_CACHE_BARS),
            ('k', cache['k'], cache_c['k'], DENSE_MODEL_BARS),
            ('v', cache['v'], cache_c['v'], DENSE_MODEL_BARS)):
        r, p, inside = _held(torch, got, want, **bars)
        out[f'{name}_rel_norm'], out[f'{name}_max_over_scale'] = r, p
        ok &= inside
    check(ok, f'card != CPU beyond the CPU tests\' bars: {out}')
    return out


def _sdpa_record(ctx, q, k, v):
    """Off the path, for the record: torch's causal
    `scaled_dot_product_attention` (GQA enabled) beside the port's
    `blockwise_attention` on the same bf16 inputs, with their largest
    difference as a share of the output's scale. Nothing checks it."""
    torch = ctx['torch']
    import torch.nn.functional as F
    from repro_torch.models.layers import blockwise_attention

    def port():
        return blockwise_attention(q, k, v, causal=True, block_kv=1024)

    def sdpa():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)

    a, b = port().float(), sdpa().float()
    return dict(shape=list(q.shape), kv_heads=k.shape[2],
                port_ms=time_ms(torch, port, reps=3),
                sdpa_ms=time_ms(torch, sdpa, reps=10),
                max_abs_diff_over_scale=float((a - b).abs().max()
                                              / a.abs().max()),
                rel_norm_diff=float((a - b).norm() / a.norm()))


def _serve_lm(ctx, model, cfg, prompts, capacity, steps):
    """Prefill `prompts` into a cache of `capacity` positions, then
    `steps` greedy decode steps: the cache, the generated ids, prefill
    and decode seconds, and whether every logit was finite (read once,
    after the last step). Decode must write the caller's cache
    tensors."""
    torch = ctx['torch']
    from repro_torch.convert import pad_cache
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    torch.cuda.synchronize()
    t_a = time.perf_counter()
    cache, logits = prefill(model, {'tokens': prompts})
    cache = pad_cache(cache, capacity)
    torch.cuda.synchronize()
    t_b = time.perf_counter()
    finite = torch.isfinite(logits).all()
    out = [logits.argmax(-1)]
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    for i in range(steps):
        cache, logits = decode(model, cache, {'tokens': out[-1][:, None]
                                              .to(torch.int32)},
                               prompts.shape[1] + i)
        finite &= torch.isfinite(logits).all()
        out.append(logits.argmax(-1))
    torch.cuda.synchronize()
    t_c = time.perf_counter()
    check({k: v.data_ptr() for k, v in cache.items()} == ptrs,
          'decode replaced the cache tensors')
    return cache, torch.stack(out, 1), t_b - t_a, t_c - t_b, bool(finite)


def _profile_serving(ctx, model, cfg, prompts, capacity):
    """Profiler windows over a prefill of `prompts` and four decode steps
    after it, its cache grown to `capacity`: device busy, idle share,
    operations and top kernels."""
    torch = ctx['torch']
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.convert import pad_cache
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    out = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_a = time.perf_counter()
        cache, logits = prefill(model, {'tokens': prompts})
        torch.cuda.synchronize()
        wall_pre = 1e6 * (time.perf_counter() - t_a)
    busy, n_ops, _ = _device_busy(prof)
    out['profile_prefill'] = dict(
        wall_ms=wall_pre / 1e3, device_busy_ms=busy / 1e3,
        idle_share=1.0 - busy / wall_pre if n_ops else None,
        device_ops=n_ops, top_kernels=_top_kernels(prof))
    cache = pad_cache(cache, capacity)
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_a = time.perf_counter()
        for i in range(4):
            cache, logits = decode(model, cache, {'tokens': tok},
                                   prompts.shape[1] + i)
            tok = logits.argmax(-1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        wall_dec = 1e6 * (time.perf_counter() - t_a)
    busy, n_ops, _ = _device_busy(prof)
    out['profile_decode'] = dict(
        ms_per_step=wall_dec / 4e3, device_busy_ms_per_step=busy / 4e3,
        idle_share=1.0 - busy / wall_dec if n_ops else None,
        device_ops_per_step=n_ops / 4, top_kernels=_top_kernels(prof))
    return out


def phase_dense(ctx):
    torch, dev = ctx['torch'], ctx['dev']
    from repro_torch.configs.registry import get
    from repro_torch.models import lm as LM
    from repro_torch.models.layers import rope
    cfg = get(DENSE_ARCH)
    t0 = time.perf_counter()
    model = LM.init_model(cfg, seed=ctx['seed'], device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(ctx['seed'] + 7)
    _draw_biases(torch, model, g)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=g,
                            device=dev, dtype=torch.int32)
    _serve_lm(ctx, model, cfg, prompts[:, :64], 128, 2)   # warm: cuBLAS
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    cache, gen, pre_s, dec_s, finite = _serve_lm(ctx, model, cfg, prompts,
                                                 DENSE_CAPACITY, LM_DECODE)
    check(finite, 'non-finite logits in prefill or decode')
    launches = _counts()
    check(not any(launches.values()),
          f'a kernel of the port launched on the dense path: {launches}')
    res = dict(arch=DENSE_ARCH, card=_card(),
               n_params=sum(p.numel() for p in model.parameters()),
               layers=cfg.n_layers, d_model=cfg.d_model, heads=cfg.n_heads,
               kv_heads=cfg.n_kv_heads, batch=LM_BATCH, prompt=LM_PROMPT,
               decode_steps=LM_DECODE, capacity=DENSE_CAPACITY,
               cache_bytes=sum(c.numel() * c.element_size()
                               for c in cache.values()),
               init_seconds=init_s, prefill_seconds=pre_s,
               prefill_tokens_per_s=LM_BATCH * LM_PROMPT / pre_s,
               decode_ms_per_token=1e3 * dec_s / LM_DECODE,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               generated_ids_first_row=gen[0, :8].tolist())
    del cache
    res.update(_profile_serving(ctx, model, cfg, prompts, DENSE_CAPACITY))

    # DENSE_FAULT_BAR: the first two layers are held to the CPU tests'
    # bar; over all 36 bf16 rounding differences accumulate (the
    # reference's init gives each layer matrix std 1/6): on the H100 the
    # gap grew from 0.0036 of the logits' norm at 2 layers to 0.058 at 36
    # (this phase's own measurement, PERF.md section 6). So the full depth
    # is held to 0.25, some four times that drift, which a fault (a wrong
    # cache slot, position or hand-off decorrelates the logits: about 1)
    # crosses.
    short = _dense_consistency(ctx, model, cfg, g, 2)
    full_depth = _dense_consistency(ctx, model, cfg, g, cfg.n_layers)
    res['consistency'] = [short, full_depth]
    check(short['pd_max_abs_err'] <= DENSE_PD_BAR,
          f'prefill + decode off the full forward at depth 2: {short}')
    check(full_depth['pd_rel_norm'] <= DENSE_FAULT_BAR,
          f'prefill + decode differ by a fault at full depth: {full_depth}')
    res['card_vs_cpu'] = _dense_card_vs_cpu(ctx, model, cfg, g)

    # for the record: torch's attention at the prefill shape, on unit
    # normal queries, keys and values turned by RoPE
    positions = torch.arange(LM_PROMPT, device=dev).expand(LM_BATCH,
                                                           LM_PROMPT)

    def draw(heads):
        x = torch.randn((LM_BATCH, LM_PROMPT, heads, cfg.head_dim),
                        generator=g, device=dev, dtype=torch.bfloat16)
        return rope(x, positions, cfg.rope_theta)
    res['sdpa_record'] = _sdpa_record(ctx, draw(cfg.n_heads),
                                      draw(cfg.n_kv_heads),
                                      draw(cfg.n_kv_heads))
    del model
    torch.cuda.empty_cache()

    # the other widths at 2 layers (a depth cut), seeded weights
    res['widths'] = []
    for arch in DENSE_WIDTHS:
        wcfg = dataclasses.replace(get(arch), n_layers=2)
        torch.cuda.reset_peak_memory_stats()
        t_a = time.perf_counter()
        wmodel = LM.init_model(wcfg, seed=ctx['seed'], device=dev)
        _draw_biases(torch, wmodel, g)
        row = dict(arch=arch, layers=2, d_model=wcfg.d_model,
                   head_dim=wcfg.head_dim, act=wcfg.act,
                   frontend=wcfg.frontend,
                   n_params=sum(p.numel() for p in wmodel.parameters()),
                   **_dense_consistency(ctx, wmodel, wcfg, g, 2))
        torch.cuda.synchronize()
        row['seconds'] = time.perf_counter() - t_a
        row['peak_memory_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30
        res['widths'].append(row)
        check(row['pd_max_abs_err'] <= DENSE_PD_BAR,
              f'{arch}: prefill + decode off the full forward: {row}')
        del wmodel
        torch.cuda.empty_cache()
    return res


def _no_drop(cfg):
    """cfg with the capacity factor raised to E / k: every expert has a
    slot for every token, so a full forward and a prefill with its decode
    steps drop nothing and route alike."""
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))


def _moe_choices(model, run):
    """(dropped expert choices, all choices) over the MoE layers while
    run() runs: each MoE layer's input routed again by `moe_route` under
    the config the forward passes it."""
    from repro_torch.models.layers import MoE, moe_route
    tally = [0, 0]

    def hook(mod, args):
        x, cfg = args[0], args[1] if len(args) > 1 else mod.cfg
        keep = moe_route(mod, cfg, x.reshape(-1, x.shape[-1]))[2]
        tally[0] += int((~keep).sum())
        tally[1] += keep.numel()
    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, MoE)]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return tally


def _float32(cfg, model):
    """A float32 copy of `model` on its device."""
    from repro_torch.models import lm as LM
    return LM.from_state_dict(cfg, {k: v.float()
                                    for k, v in model.state_dict().items()})


def _moe_consistency(ctx, model, cfg, g, depth, float32=False):
    """`_dense_consistency` with nothing dropped (`_no_drop`): with drops,
    a prefill of T-1 positions and a full forward of T fill the experts'
    queues differently. The dropped choices are counted (none). With
    `float32`, on a float32 copy of the cut (TF32 off, as every forward
    runs)."""
    cfg, model = _cut(_no_drop(cfg), model, depth)
    if float32:
        model = _float32(cfg, model)
    out = dict(dtype='float32' if float32 else 'bfloat16')

    def run():
        out.update(_dense_consistency(ctx, model, cfg, g, depth))
    dropped, total = _moe_choices(model, run)
    check(total > 0 and dropped == 0,
          f'{dropped} of {total} choices dropped under capacity E/k')
    return out


def _moe_card_vs_cpu(ctx, model, cfg, g):
    """The first two layers (layer 0 with its dense MLP, layer 1 with
    the MoE) at full width, cast to float32, on the card and, copied, on
    the CPU (TF32 off), at B = CHECK_BATCH, T = CHECK_LEN. Each block
    runs on both devices from the card's input to it, so that a
    difference is the block's own: each attention's output and cache
    (one projection deep) within the CPU tests' model and cache bars,
    each FFN's output within the model bars, and the logits from the
    card's last hidden state. Expert choices may differ only at near
    ties (MOE_TIE_MARGIN); such tokens are counted and left out of the
    MoE output's comparison. Float32, because in bf16 MLA's softmax is
    saturated under the stacked fan-in init (scores of some 350 at full
    depth's std 1/sqrt(26)), so one rounding of q or c_kv apart moves a
    token's attention by some 10% (PERF.md section 6)."""
    torch = ctx['torch']
    from repro_torch.kernels.platform import full_f32
    from repro_torch.models import lm as LM
    from repro_torch.models.layers import (MoE, _router_probs, _top_k,
                                           gqa_attention, mla_attention,
                                           rmsnorm)
    cfg, model = _cut(cfg, model, 2)
    model = _float32(cfg, model)
    cpu = LM.from_state_dict(cfg, {k: v.cpu()
                                   for k, v in model.state_dict().items()})
    toks = torch.randint(0, cfg.vocab, (CHECK_BATCH, CHECK_LEN), generator=g,
                         device=ctx['dev'], dtype=torch.int32)
    attend = mla_attention if cfg.attn == 'mla' else gqa_attention
    names = tuple(LM.cache_struct(cfg, 0, 0))
    out, ok = {}, True

    def held(name, got, want, bars):
        nonlocal ok
        r, p, inside = _held(torch, got, want, **bars)
        out[f'{name}_rel_norm'], out[f'{name}_max_over_scale'] = r, p
        ok &= inside

    t_a = time.perf_counter()
    with torch.no_grad(), full_f32():
        x = LM._embed_tokens(model, cfg, toks).to(torch.bfloat16)
        pos = LM._positions(x)
        for l, (lc, lp) in enumerate(zip(LM.all_layers(model),
                                         LM.all_layers(cpu))):
            h = rmsnorm(lc.ln1, x)
            a, pair = attend(lc.attn, cfg, h, pos)
            a_c, pair_c = attend(lp.attn, cfg, h.cpu(), pos.cpu())
            held(f'attn{l}', a, a_c, DENSE_MODEL_BARS)
            for name, got, want in zip(names, pair, pair_c):
                held(f'{name}{l}', got, want, DENSE_CACHE_BARS)
            x = x + a
            f_in = rmsnorm(lc.ln2, x)
            y, y_c = lc.ffn(f_in, cfg), lp.ffn(f_in.cpu(), cfg)
            if isinstance(lc.ffn, MoE):
                k = cfg.moe.top_k
                xf = f_in.reshape(-1, cfg.d_model)
                idx = _top_k(_router_probs(lc.ffn, xf), k)[1].sort(-1)[0]
                probs = _router_probs(lp.ffn, xf.cpu())
                top, idx_c = _top_k(probs, k + 1)
                apart = (idx.cpu() != idx_c[:, :k].sort(-1)[0]).any(-1)
                margin = (top[:, k - 1] - top[:, k]) / top[:, k - 1]
                out['tokens_routed_apart'] = int(apart.sum())
                out['largest_margin_apart'] = float(
                    margin[apart].max()) if apart.any() else None
                ok &= not bool((margin[apart] >= MOE_TIE_MARGIN).any())
                same = ~apart.view(y.shape[:2])
                held(f'ffn{l}', y[same.to(y.device)], y_c[same],
                     DENSE_MODEL_BARS)
            else:
                held(f'ffn{l}', y, y_c, DENSE_MODEL_BARS)
            x = x + y
        hid = rmsnorm(model.ln_f, x)
        held('logits', LM._last_logits(model, cfg, hid),
             LM._last_logits(cpu, cfg, hid.cpu()), DENSE_MODEL_BARS)
    out['seconds'] = time.perf_counter() - t_a
    check(ok, f'card != CPU beyond the CPU tests\' bars: {out}')
    return out


def _moe_shares(ctx, model, cfg, prompts, prefill_busy_ms):
    """CUDA-event ms of one MLA (or GQA) attention and one MoE block at
    the prefill's shape, on the hidden state of the prompts' embeddings
    through layer 0, and, times their layer counts, their estimated share
    of a profiled prefill's device time."""
    torch = ctx['torch']
    from repro_torch.kernels.platform import full_f32
    from repro_torch.models import lm as LM
    from repro_torch.models.layers import (gqa_attention, mla_attention,
                                           rmsnorm)
    lay = model.layers[0]
    attend = mla_attention if cfg.attn == 'mla' else gqa_attention
    with torch.no_grad(), full_f32():
        x = LM._embed_tokens(model, cfg, prompts).to(torch.bfloat16)
        pos = LM._positions(x)
        x, _ = LM._attn_layer(model.layer0, cfg, x, pos)
        h = rmsnorm(lay.ln1, x)
        f_in = rmsnorm(lay.ln2, x + attend(lay.attn, cfg, h, pos)[0])
        attn_ms = time_ms(torch, lambda: attend(lay.attn, cfg, h, pos),
                          reps=3)
        moe_ms = time_ms(torch, lambda: lay.ffn(f_in, cfg), reps=3)
    n_moe = cfg.n_layers - 1
    busy = prefill_busy_ms or None
    return dict(attn_ms=attn_ms, moe_ms=moe_ms,
                attn_share=busy and cfg.n_layers * attn_ms / busy,
                moe_share=busy and n_moe * moe_ms / busy)


def _fan_in_scaled(torch, model):
    """Scale the stacked layers' matrices of `model` in place from the
    init's std 1/sqrt(L) (the reference's rule reads the fan-in from the
    stacked layer axis, ROADMAP Queue 3) to 1/sqrt(in), one layer's
    fan-in; the router keeps its own 0.02 and the norms their ones."""
    stacked = len(model.layers)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if (name.startswith('layers.') and p.ndim >= 2
                    and not name.endswith('.router')):
                p.mul_(math.sqrt(stacked / p.shape[-2]))


def _moe_model_row(ctx, arch, g, layers=None, profiled=False):
    """The phase's record of one MoE model at full width and `layers`
    layers (default: its depth), seeded weights drawn on the card: init,
    serve at the lm phase's shapes into MOE_CAPACITY, the prefill's
    dropped share, profiler windows (`profiled`), card against CPU at
    2 layers, and the consistency checks: the reference's bar at 2
    layers in float32, the fault bar at the model's depth in bf16."""
    torch, dev = ctx['torch'], ctx['dev']
    from repro_torch.configs.registry import get
    from repro_torch.models import lm as LM
    cfg = get(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LM.init_model(cfg, seed=ctx['seed'], device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=g,
                            device=dev, dtype=torch.int32)
    _serve_lm(ctx, model, cfg, prompts[:, :64], 128, 2)   # warm
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    cache, gen, pre_s, dec_s, finite = _serve_lm(ctx, model, cfg, prompts,
                                                 MOE_CAPACITY, LM_DECODE)
    check(finite, f'{arch}: non-finite logits in prefill or decode')
    launches = _counts()
    check(not any(launches.values()),
          f'a kernel of the port launched on the MoE path: {launches}')
    row = dict(arch=arch, layers=cfg.n_layers, d_model=cfg.d_model,
               attn=cfg.attn, experts=cfg.moe.num_experts,
               top_k=cfg.moe.top_k, shared=cfg.moe.shared_experts,
               n_params=sum(p.numel() for p in model.parameters()),
               init_seconds=init_s, init_peak_memory_gib=init_peak,
               batch=LM_BATCH, prompt=LM_PROMPT, decode_steps=LM_DECODE,
               capacity=MOE_CAPACITY,
               cache_bytes=sum(c.numel() * c.element_size()
                               for c in cache.values()),
               prefill_seconds=pre_s,
               prefill_tokens_per_s=LM_BATCH * LM_PROMPT / pre_s,
               decode_ms_per_token=1e3 * dec_s / LM_DECODE,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               generated_ids_first_row=gen[0, :8].tolist())
    del cache
    dropped, total = _moe_choices(
        model, lambda: LM.forward_prefill(model, cfg, {'tokens': prompts}))
    row['prefill_dropped_share'] = dropped / total
    row['prefill_choices'] = total
    if profiled:
        row.update(_profile_serving(ctx, model, cfg, prompts, MOE_CAPACITY))
        row['prefill_shares'] = _moe_shares(
            ctx, model, cfg, prompts,
            row['profile_prefill']['device_busy_ms'])
    row['card_vs_cpu'] = _moe_card_vs_cpu(ctx, model, cfg, g)
    # Consistency. At the init's std 1/sqrt(L) MLA's softmax saturates
    # (scores of some 350), so prefill + decode and the full forward,
    # whose matrix products differ in shape and round apart by an ulp
    # here and there, move apart at once in bf16 and decorrelate with
    # depth (PERF.md section 6); the bf16 gaps at this init are
    # recorded. The gates: the reference's bar (DENSE_PD_BAR) on the
    # first two layers in float32 (the same tokens as the bf16 record),
    # and the fault bar (DENSE_FAULT_BAR: a wrong cache slot, position or
    # hand-off decorrelates the logits) at the model's depth in bf16 with
    # the stacked matrices at one layer's fan-in (`_fan_in_scaled`).
    state = g.get_state()
    short = _moe_consistency(ctx, model, cfg, g, 2, float32=True)
    g.set_state(state)
    records = [_moe_consistency(ctx, model, cfg, g, 2),
               _moe_consistency(ctx, model, cfg, g, cfg.n_layers)]
    _fan_in_scaled(torch, model)
    deep = _moe_consistency(ctx, model, cfg, g, cfg.n_layers)
    deep['init'] = 'fan_in'
    row['consistency'] = [short, *records, deep]
    check(short['pd_max_abs_err'] <= DENSE_PD_BAR,
          f'{arch}: prefill + decode off the full forward at depth 2: '
          f'{short}')
    check(deep['pd_rel_norm'] <= DENSE_FAULT_BAR,
          f'{arch}: prefill + decode differ by a fault at depth '
          f'{cfg.n_layers}: {deep}')
    del model
    torch.cuda.empty_cache()
    return row


def phase_moe(ctx):
    g = ctx['torch'].Generator(device=ctx['dev'])
    g.manual_seed(ctx['seed'] + 11)
    return dict(card=_card(),
                deepseek=_moe_model_row(ctx, MOE_ARCH, g, profiled=True),
                moonshot=_moe_model_row(ctx, MOE_WIDTH_ARCH, g,
                                        MOE_WIDTH_LAYERS))


# GRAD_BARS: the JAX package's own kernel-vs-scan gradient gap on the
# first two layers (tools/rwkv_grad_gap.py, CPU, d = 256, seeds 0-2: per
# leaf at most 0.0557 in relative norm and 0.108 in largest difference
# over the leaf's scale) doubled. Over all 32 layers bf16 differences
# accumulate until single leaves decorrelate: the same tool at 32 layers
# finds the JAX package's routes 1.0 apart in relative norm on its worst
# leaf (a u), with the median leaf at 0.36. So the full depth is held to
# a fault bar on the median leaf's relative norm, GRAD_FAULT_BAR, which a
# fault that reaches every layer (a wrong layout, state or hand-off in the
# WKV op, which puts a leaf at 1 or more) crosses and drift does not.
GRAD_BARS = dict(rel_norm=0.12, max_abs_over_scale=0.22)
GRAD_FAULT_BAR = 0.75


def _leaf_gaps(got, want):
    """Per leaf (relative norm of the difference, largest difference over
    the leaf's scale) of two {name: gradient}, the worst of each with its
    leaf, and the median leaf's relative norm."""
    out = dict(rel_norm=[0.0, None], max_abs_over_scale=[0.0, None])
    rels = []
    for name, b in want.items():
        b = b.float()
        a = got[name].float().to(b.device)
        norm, scale = float(b.norm()), float(b.abs().max())
        if norm == 0.0:
            continue
        rels.append(float((a - b).norm()) / norm)
        for key, val in (('rel_norm', rels[-1]),
                         ('max_abs_over_scale',
                          float((a - b).abs().max()) / scale)):
            if val > out[key][0]:
                out[key] = [val, name]
    out['median_rel_norm'] = sorted(rels)[len(rels) // 2]
    return out


def _route_grads(torch, model, cfg, batch, impl):
    """(loss, {name: gradient}) of the lm loss through the `impl` route,
    remat='layer'."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train.trainer import loss_and_grads
    from repro_torch.kernels.platform import full_f32
    with full_f32():
        loss, grads = loss_and_grads(
            model, dataclasses.replace(cfg, wkv_impl=impl),
            TrainConfig(remat='layer'), batch)
    check(bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(v).all()) for v in grads.values()),
        f'non-finite loss or gradients on the {impl} route')
    return loss, grads


def _grad_gap(ctx, model, cfg, g, depth):
    """Kernel route against scan route on the model cut to its first
    `depth` layers (the same weights, no copy), at B = GRAD_BATCH,
    T = GRAD_LEN: the largest per-leaf relative norm of the gradients'
    difference and largest difference over the leaf's scale, with the
    leaves that attain them, the median leaf's relative norm, and the WKV
    launches of the kernel route."""
    torch = ctx['torch']
    from repro_torch.models import lm as LM
    if depth < cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=depth)
        model = LM.from_state_dict(cfg, {
            k: v for k, v in model.state_dict().items()
            if not k.startswith('layers.') or int(k.split('.')[1]) < depth})
    seq = torch.randint(0, cfg.vocab, (GRAD_BATCH, GRAD_LEN + 1),
                        generator=g, device=ctx['dev'], dtype=torch.int32)
    batch = {'tokens': seq[:, :-1], 'targets': seq[:, 1:]}
    _reset_counts()
    loss_k, gk = _route_grads(torch, model, cfg, batch, 'kernel')
    launches = _counts()
    loss_s, gs = _route_grads(torch, model, cfg, batch, 'scan')
    out = dict(depth=depth, loss_kernel=float(loss_k), loss_scan=float(loss_s),
               wkv_fwd_launches=launches['wkv_fwd'],
               wkv_bwd_launches=launches['wkv_bwd'],
               **_leaf_gaps(gk, gs))
    check(launches['wkv_fwd'] == 2 * depth and launches['wkv_bwd'] == depth,
          f'gradient check at depth {depth} launched {launches}')
    return out


def phase_train(ctx):
    torch, dev = ctx['torch'], ctx['dev']
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get
    from repro_torch.data import (RewardPipeline, TokenPipeline,
                                  TokenPipelineConfig)
    from repro_torch.models import lm as LM
    from repro_torch.train.trainer import make_train_step, state_for
    cfg = dataclasses.replace(get('rwkv6-3b'), wkv_impl='kernel')
    g = torch.Generator(device=dev)
    g.manual_seed(ctx['seed'] + 8)
    model = LM.init_model(cfg, seed=ctx['seed'], device=dev)
    _randomize_mixing(torch, model, g)

    short = _grad_gap(ctx, model, cfg, g, 2)
    full_depth = _grad_gap(ctx, model, cfg, g, cfg.n_layers)
    check(short['rel_norm'][0] <= GRAD_BARS['rel_norm']
          and short['max_abs_over_scale'][0]
          <= GRAD_BARS['max_abs_over_scale'],
          f'gradients outside the bars at depth 2: {short}')
    check(full_depth['median_rel_norm'] <= GRAD_FAULT_BAR,
          f'gradients differ by a fault at full depth: {full_depth}')
    torch.cuda.empty_cache()

    n_steps = TRAIN_LM_STEPS + TRAIN_RANK_STEPS
    tcfg = TrainConfig(objective='lm', remat='layer', microbatches=1,
                       warmup_steps=1, decay_steps=n_steps)
    steps = {'lm': make_train_step(cfg, tcfg),
             'rank_hinge': make_train_step(cfg, dataclasses.replace(
                 tcfg, objective='rank_hinge'))}
    tokens = TokenPipeline(TokenPipelineConfig(cfg.vocab, TRAIN_LEN,
                                               TRAIN_BATCH, seed=ctx['seed']))
    rewards = RewardPipeline(cfg.vocab, TRAIN_LEN, TRAIN_BATCH,
                             seed=ctx['seed'])
    state = state_for(model)
    tracked = ('layers.0.tm.wr', 'layers.31.cm.wv', 'layers.7.tm.u',
               'score_head')
    params = dict(model.named_parameters())
    before = {k: (params[k].detach().clone(),
                  state['opt']['mu'][k]['master'].clone()) for k in tracked}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    records, total = [], {'wkv_fwd': 0, 'wkv_bwd': 0}
    prof = None
    for i in range(n_steps):
        objective = 'lm' if i < TRAIN_LM_STEPS else 'rank_hinge'
        raw = (tokens.batch(i) if objective == 'lm' else
               {k: v for k, v in rewards.batch(i).items()
                if k in ('tokens', 'utilities')})
        batch = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
        profiled = i == TRAIN_LM_STEPS - 1      # the last lm step
        if profiled:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = steps[objective](state, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if profiled:
            prof.__exit__(None, None, None)
        launches = _counts()
        for k in total:
            total[k] += launches[k]
        rec = dict(step=i + 1, objective=objective, seconds=secs,
                   profiled=profiled,
                   **{k: float(v) for k, v in metrics.items()},
                   wkv_fwd_launches=launches['wkv_fwd'],
                   wkv_bwd_launches=launches['wkv_bwd'])
        records.append(rec)
        check(all(math.isfinite(rec[k]) for k in ('loss', 'gnorm', 'lr')),
              f'non-finite metrics at step {i + 1}: {rec}')
        check(launches['wkv_fwd'] == 2 * cfg.n_layers
              and launches['wkv_bwd'] == cfg.n_layers,
              f'step {i + 1} launched {launches}; expected '
              f'{2 * cfg.n_layers} forward and {cfg.n_layers} backward')
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = {k: dict(param=bool((params[k] != p0).any()),
                     master=bool((state['opt']['mu'][k]['master']
                                  != m0).any()))
             for k, (p0, m0) in before.items()}
    check(all(m['master'] for m in moved.values())
          and all(moved[k]['param'] for k in tracked[:2]),
          f'the weights did not move: {moved}')
    lm_secs = sorted(r['seconds'] for r in records if r['objective'] == 'lm')
    median = lm_secs[len(lm_secs) // 2]
    busy, n_ops, bwd_us = _device_busy(prof, 'wkv_bwd_kernel')
    _, _, fwd_us = _device_busy(prof, 'wkv_fwd_kernel')
    wall_us = 1e6 * records[TRAIN_LM_STEPS - 1]['seconds']
    res = dict(batch=TRAIN_BATCH, seq=TRAIN_LEN, layers=cfg.n_layers,
               grad_check=[short, full_depth], grad_bars=GRAD_BARS,
               grad_fault_bar=GRAD_FAULT_BAR, steps=records,
               median_lm_step_seconds=median,
               train_tokens_per_s=TRAIN_BATCH * TRAIN_LEN / median,
               peak_memory_gib=peak, moved=moved,
               profile_step=dict(
                   objective='lm', step=TRAIN_LM_STEPS,
                   wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                   idle_share=1.0 - busy / wall_us if n_ops else None,
                   device_ops=n_ops, wkv_bwd_ms=bwd_us / 1e3,
                   wkv_fwd_ms=fwd_us / 1e3,
                   wkv_bwd_share_of_device_time=bwd_us / busy if busy
                   else None,
                   wkv_share_of_device_time=(bwd_us + fwd_us) / busy
                   if busy else None,
                   top_kernels=_top_kernels(prof, k=8)))
    ctx['launches']['wkv_bwd'] = total['wkv_bwd']
    ctx['wkv_row']['launches_per_train_step'] = 2 * cfg.n_layers
    del state, model, params, before, steps, prof
    torch.cuda.empty_cache()
    ctx['wkv_bwd_row'] = _wkv_bwd_row(ctx, median, cfg.n_layers)
    ctx['wkv_row']['at_train_shape'] = _wkv_fwd_train_shape(ctx)
    res['wkv_bwd_kernel_ms'] = ctx['wkv_bwd_row']['ms']
    res['wkv_fwd_kernel_ms_train_shape'] = ctx['wkv_row'][
        'at_train_shape']['ms']
    return res


def _wkv_fwd_train_shape(ctx):
    """The forward kernel at the training shape (N = B*H = 160, T, K),
    writing boundaries, as the train step calls it (twice per layer):
    its time, its plain version's, its bound and its geometry. Goes into
    the forward kernel's row as `at_train_shape`."""
    torch, dev = ctx['torch'], ctx['dev']
    from repro_torch.kernels.wkv import ops as W
    from repro_torch.kernels.wkv.ref import wkv_forward_plain
    g = torch.Generator(device=dev)
    g.manual_seed(ctx['seed'] + 10)
    n, t, kk = TRAIN_BATCH * 40, TRAIN_LEN, 64
    args = _wkv_inputs(torch, n, t, kk, torch.bfloat16, dev, g)
    chunk = W._pick_chunk(t)
    ms = time_ms(torch, lambda: W._launch(*args, chunk, True), reps=10)
    got = W._launch(*args, chunk, True)
    torch.cuda.synchronize()
    t_a = time.perf_counter()
    want = wkv_forward_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t_a)
    errs = _wkv_compare(torch, got, want)
    check(errs['o_inside'] and errs['states_bit_equal'],
          f'WKV kernel != plain at the training shape: {errs}')
    # bytes: as at the prefill shape, plus the boundaries (N*T/chunk*K*K
    # float32) written once; operations: 5 K*K per (n, t), as there
    nt = n * t
    nbytes = (nt * kk * (2 * 4 + 4) + 4 * n * kk + 2 * 4 * n * kk * kk
              + 4 * n * (t // chunk) * kk * kk)
    ops = 5 * kk * kk * nt
    row = _row('wkv_fwd', '', '', 0, errs['o_max_abs_err'], ms, plain_ms,
               nbytes, ops)
    return dict(shape=[n, t, kk], boundaries=True,
                geometry=W.fwd_geometry(kk),
                **{k: row[k] for k in ('ms', 'plain_ms', 'bound_ms',
                                       'bound_by', 'max_abs_err', 'bytes',
                                       'operations')},
                states_bit_equal=errs['states_bit_equal'])


def _wkv_bwd_row(ctx, step_seconds, n_layers):
    """The backward kernel at the training shape (N = B*H, T, K), as the
    path calls it (once per layer of a train step): its time, its plain
    version's, their difference and its bound."""
    torch, dev = ctx['torch'], ctx['dev']
    from repro_torch.kernels.wkv import ops as W
    from repro_torch.kernels.wkv.ref import wkv_backward_plain
    g = torch.Generator(device=dev)
    g.manual_seed(ctx['seed'] + 9)
    n, t, kk = TRAIN_BATCH * 40, TRAIN_LEN, 64
    args, chunk = _wkv_bwd_inputs(torch, n, t, kk, torch.bfloat16, dev, g)
    ms = time_ms(torch, lambda: W._launch_bwd(*args, chunk), reps=5)
    got = W._launch_bwd(*args, chunk)
    torch.cuda.synchronize()
    t_a = time.perf_counter()
    want = wkv_backward_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t_a)
    errs = _wkv_bwd_compare(torch, got, want)
    check(errs['all_inside'], f'WKV backward kernel != plain at the '
          f'training shape: {errs}')
    # bytes: r, k, v, do and dr, dk, dv bf16, w and dw float32 (N*T*K
    # each), the boundaries (N*T/chunk*K*K), u, du, dsT and ds0 float32,
    # each read or written once; operations: 14 K*K per (n, t): 3 for
    # one recompute of the state from the boundaries (decay, product,
    # sum), 2 each for the products and sums of dr, dk, dv and dw, and 3
    # for the dS update (the u terms are O(K) per step)
    nt = n * t
    nbytes = (nt * kk * (7 * 2 + 2 * 4) + 4 * n * (t // chunk) * kk * kk
              + 2 * 4 * n * kk + 2 * 4 * n * kk * kk)
    ops = 14 * kk * kk * nt
    err = max(errs[k]['max_abs_err'] for k in WKV_GRADS)
    return _row('wkv_bwd', 'src/repro_torch/kernels/csrc/wkv_bwd.cu',
                'src/repro/kernels/wkv/kernel.py:123',
                ctx['launches']['wkv_bwd'], err, ms, plain_ms, nbytes, ops,
                shape=[n, t, kk], geometry=W.bwd_geometry(kk), errors=errs,
                launches_per_train_step=n_layers,
                share_of_train_step_layer=ms * n_layers / (1e3 * step_seconds))


# DENSE_GRAD_BARS: the first two layers' float32 gradients on the card
# against the port's CPU path from the same weights, TF32 off, per leaf
# (relative norm of the difference, largest difference over the leaf's
# scale): the same float32 products summed in another order. Measured
# on the card (NVIDIA H100 80GB HBM3, 700.00 W), every leaf but the
# embedding at most 2.1e-4 in relative norm (layers.1.attn.bq) and
# 3.1e-4 of scale (layers.1.attn.wq). The tied embedding's gradient
# through the model's input passes the forward's bf16 cast of it, where
# a float32 sum that lands on the other side of a bf16 rounding moves an
# element by one bf16 ulp (up to 2^-7 of it): EMBED_GRAD_BARS, measured
# 8.5e-4 in relative norm and 5.2e-3 of scale.
DENSE_GRAD_BARS = dict(rel_norm=1e-3, max_abs_over_scale=1e-3)
EMBED_GRAD_BARS = dict(rel_norm=2.5e-3, max_abs_over_scale=2.0 ** -7)
# Dense training (dense_train phase): qwen2.5-3b at full width and depth
# with the train phase's batch, length and steps; internvl2-26b and
# musicgen-medium at full width and 2 layers, one lm step each at
# FRONTEND_BATCH x FRONTEND_LEN text positions.
DENSE_TRAIN_WIDTHS = ('internvl2-26b', 'musicgen-medium')
FRONTEND_BATCH, FRONTEND_LEN = 1, 512


def _dense_grad_check(ctx, model, cfg, g):
    """The model cut to its first two layers (full width) at
    B = GRAD_BATCH, T = GRAD_LEN, on the card and on a CPU copy of the
    same weights: the lm loss in bf16 within the bf16 loss bar (2e-3),
    and every leaf's gradient of the weights in float32 (remat='layer',
    TF32 off) within DENSE_GRAD_BARS, the embedding's within
    EMBED_GRAD_BARS. For a MoE config the float32 passes' MoE calls
    (forward and recompute) are recorded on both devices and each
    routed by its device's own input and router: before any gradient is
    compared, no token may go to other experts on the card than on the
    CPU (`_routing_apart`)."""
    torch = ctx['torch']
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels.platform import full_f32
    from repro_torch.models import lm as LM
    from repro_torch.train.trainer import loss_and_grads, loss_fn
    cfg, model = _cut(cfg, model, 2)
    seq = torch.randint(0, cfg.vocab, (GRAD_BATCH, GRAD_LEN + 1),
                        generator=g, device=ctx['dev'], dtype=torch.int32)
    batch = {'tokens': seq[:, :-1], 'targets': seq[:, 1:]}
    tcfg = TrainConfig(remat='layer')
    out = dict(depth=2, batch=GRAD_BATCH, seq=GRAD_LEN)
    t_a = time.perf_counter()
    grads, calls = {}, {}
    for where, dev in (('card', ctx['dev']), ('cpu', 'cpu')):
        state = {k: v.detach().to(dev) for k, v in model.state_dict().items()}
        on = {k: v.to(dev) for k, v in batch.items()}
        with torch.no_grad():
            out[f'loss_{where}'] = float(loss_fn(
                LM.from_state_dict(cfg, state), cfg, tcfg, on))
        f32 = LM.from_state_dict(cfg, {k: v.float() for k, v in
                                       state.items()})
        with full_f32(), _moe_inputs(f32) as calls[where]:
            _, grads[where] = loss_and_grads(f32, cfg, tcfg, on)
    out['seconds'] = time.perf_counter() - t_a
    if cfg.is_moe:
        out['routing'] = _routing_apart(ctx, cfg, calls['card'],
                                        calls['cpu'])
        check(out['routing']['tokens_routed_apart'] == 0,
              f'card and CPU route apart: {out["routing"]}')
    card, cpu = grads['card'], grads['cpu']
    out.update(_leaf_gaps({k: v for k, v in card.items() if k != 'embed'},
                          {k: v for k, v in cpu.items() if k != 'embed'}))
    out['embed'] = _leaf_gaps({'embed': card['embed']},
                              {'embed': cpu['embed']})
    check(all(bool(torch.isfinite(v).all()) for v in card.values()),
          'non-finite gradients on the card')
    check(abs(out['loss_card'] - out['loss_cpu'])
          <= 2e-3 * abs(out['loss_cpu'])
          and all(gaps[key][0] <= bars[key]
                  for gaps, bars in ((out, DENSE_GRAD_BARS),
                                     (out['embed'], EMBED_GRAD_BARS))
                  for key in bars),
          f'card gradients outside the bars at depth 2: {out}')
    return out


@contextlib.contextmanager
def _moe_inputs(model):
    """Records (input, router) of every MoE call of `model` made inside,
    into the yielded list, in call order."""
    from repro_torch.models.layers import MoE
    calls = []

    def hook(mod, args):
        calls.append((args[0].detach().reshape(-1, args[0].shape[-1]),
                      mod.router.detach()))
    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, MoE)]
    try:
        yield calls
    finally:
        for h in hooks:
            h.remove()


def _routing_apart(ctx, cfg, card, cpu):
    """Call by call, the card's choices from the card's MoE inputs against
    the CPU's from the CPU's: the tokens routed apart, and the least
    relative margin between a token's k-th and (k+1)-th probability on
    the CPU."""
    torch = ctx['torch']
    from repro_torch.models.layers import _router_probs, _top_k
    k = cfg.moe.top_k
    check(len(card) == len(cpu) > 0, f'{len(card)} MoE calls on the card, '
          f'{len(cpu)} on the CPU')
    apart, least = 0, math.inf
    for (x, r), (x_c, r_c) in zip(card, cpu):
        idx = _top_k(_router_probs(SimpleNamespace(router=r), x),
                     k)[1].sort(-1)[0]
        top, idx_c = _top_k(_router_probs(SimpleNamespace(router=r_c), x_c),
                            k + 1)
        apart += int((idx.cpu() != idx_c[:, :k].sort(-1)[0]).any(-1).sum())
        least = min(least, float(((top[:, k - 1] - top[:, k])
                                  / top[:, k - 1]).min()))
    return dict(calls=len(card), tokens=sum(x.shape[0] for x, _ in card),
                tokens_routed_apart=apart, least_margin_cpu=least)


def _attention_ms(ctx, cfg):
    """CUDA-event ms of the pieces that a checkpointed layer of the
    train step runs on the step's (B, T): `blockwise_attention` once
    without autograd (the forward) and once with it plus its backward
    (the recompute and the backward); RoPE of q and k the same way.
    Times `L` layers give an estimate of their device time in a step."""
    torch, dev = ctx['torch'], ctx['dev']
    from repro_torch.kernels.platform import full_f32
    from repro_torch.models.layers import blockwise_attention, rope
    b, t = TRAIN_BATCH, TRAIN_LEN
    g = torch.Generator(device=dev)
    g.manual_seed(ctx['seed'] + 9)

    def draw(heads):
        return torch.randn((b, t, heads, cfg.head_dim), generator=g,
                           device=dev, dtype=torch.bfloat16)
    q, k, v = draw(cfg.n_heads), draw(cfg.n_kv_heads), draw(cfg.n_kv_heads)
    do = draw(cfg.n_heads)
    pos = torch.arange(t, device=dev).expand(b, t)

    def attn(grad):
        if not grad:
            with torch.no_grad():
                return blockwise_attention(q, k, v, causal=True)
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = blockwise_attention(*leaves, causal=True)
        return torch.autograd.grad(out, leaves, do)

    def ropes(grad):
        if not grad:
            with torch.no_grad():
                return rope(q, pos, cfg.rope_theta), rope(k, pos,
                                                          cfg.rope_theta)
        leaves = [x.detach().requires_grad_(True) for x in (q, k)]
        outs = [rope(x, pos, cfg.rope_theta) for x in leaves]
        return torch.autograd.grad(outs, leaves, [do, k])

    with full_f32():
        out = {name: time_ms(torch, lambda f=f, gr=gr: f(gr), reps=3)
               for name, f, gr in (('attn_fwd_ms', attn, False),
                                   ('attn_fwd_bwd_ms', attn, True),
                                   ('rope_fwd_ms', ropes, False),
                                   ('rope_fwd_bwd_ms', ropes, True))}
    out['attn_ms_per_step'] = cfg.n_layers * (out['attn_fwd_ms']
                                              + out['attn_fwd_bwd_ms'])
    out['rope_ms_per_step'] = cfg.n_layers * (out['rope_fwd_ms']
                                              + out['rope_fwd_bwd_ms'])
    return out


def _frontend_step(ctx, arch, g):
    """One lm train step of `arch` at full width and 2 layers (seeded
    weights, biases drawn), its frontend's inputs on the card: finite
    loss and gnorm."""
    torch, dev = ctx['torch'], ctx['dev']
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get
    from repro_torch.data import frontend_inputs
    from repro_torch.models import lm as LM
    from repro_torch.train.trainer import make_train_step, state_for
    cfg = dataclasses.replace(get(arch), n_layers=2)
    torch.cuda.reset_peak_memory_stats()
    t_a = time.perf_counter()
    model = LM.init_model(cfg, seed=ctx['seed'], device=dev)
    _draw_biases(torch, model, g)
    seq = torch.randint(0, cfg.vocab, (FRONTEND_BATCH, FRONTEND_LEN + 1),
                        generator=g, device=dev, dtype=torch.int32)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in frontend_inputs(
        cfg, FRONTEND_BATCH, ctx['seed'])(0, seq[:, :-1].cpu().numpy()
                                          ).items()}
    positions = FRONTEND_LEN + (cfg.frontend_tokens
                                if cfg.frontend == 'vision' else 0)
    step = make_train_step(cfg, TrainConfig(remat='layer', warmup_steps=0,
                                            decay_steps=1))
    _, metrics = step(state_for(model), dict(batch, targets=seq[:, 1:]))
    torch.cuda.synchronize()
    row = dict(arch=arch, layers=2, d_model=cfg.d_model,
               frontend=cfg.frontend, positions=positions,
               n_params=sum(p.numel() for p in model.parameters()),
               seconds=time.perf_counter() - t_a,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               **{k: float(v) for k, v in metrics.items()})
    check(math.isfinite(row['loss']) and math.isfinite(row['gnorm']),
          f'{arch}: non-finite train step: {row}')
    return row


def phase_dense_train(ctx):
    torch, dev = ctx['torch'], ctx['dev']
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get
    from repro_torch.data import (RewardPipeline, TokenPipeline,
                                  TokenPipelineConfig)
    from repro_torch.models import lm as LM
    from repro_torch.train.trainer import make_train_step, state_for
    cfg = get(DENSE_ARCH)
    g = torch.Generator(device=dev)
    g.manual_seed(ctx['seed'] + 10)
    model = LM.init_model(cfg, seed=ctx['seed'], device=dev)
    _draw_biases(torch, model, g)
    grad_check = _dense_grad_check(ctx, model, cfg, g)
    torch.cuda.empty_cache()

    n_steps = TRAIN_LM_STEPS + TRAIN_RANK_STEPS
    tcfg = TrainConfig(objective='lm', remat='layer', microbatches=1,
                       warmup_steps=1, decay_steps=n_steps)
    steps = {'lm': make_train_step(cfg, tcfg),
             'rank_hinge': make_train_step(cfg, dataclasses.replace(
                 tcfg, objective='rank_hinge'))}
    tokens = TokenPipeline(TokenPipelineConfig(cfg.vocab, TRAIN_LEN,
                                               TRAIN_BATCH, seed=ctx['seed']))
    rewards = RewardPipeline(cfg.vocab, TRAIN_LEN, TRAIN_BATCH,
                             seed=ctx['seed'])
    state = state_for(model)
    last = cfg.n_layers - 1
    tracked = ('layers.0.attn.wq', f'layers.{last}.ffn.w1',
               f'layers.{last}.ffn.w2', 'layers.0.attn.bq', 'score_head')
    params = dict(model.named_parameters())
    before = {k: (params[k].detach().clone(),
                  state['opt']['mu'][k]['master'].clone()) for k in tracked}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    records, prof = [], None
    _reset_counts()
    for i in range(n_steps):
        objective = 'lm' if i < TRAIN_LM_STEPS else 'rank_hinge'
        raw = (tokens.batch(i) if objective == 'lm' else
               {k: v for k, v in rewards.batch(i).items()
                if k in ('tokens', 'utilities')})
        batch = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
        profiled = i == TRAIN_LM_STEPS - 1      # the last lm step
        if profiled:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = steps[objective](state, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if profiled:
            prof.__exit__(None, None, None)
        rec = dict(step=i + 1, objective=objective, seconds=secs,
                   profiled=profiled,
                   **{k: float(v) for k, v in metrics.items()})
        records.append(rec)
        check(all(math.isfinite(rec[k]) for k in ('loss', 'gnorm', 'lr')),
              f'non-finite metrics at step {i + 1}: {rec}')
    peak = torch.cuda.max_memory_allocated()
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    launches = _counts()
    check(not any(launches.values()),
          f'a kernel of the port launched on the dense train path: '
          f'{launches}')
    moved = {k: dict(param=bool((params[k] != p0).any()),
                     master=bool((state['opt']['mu'][k]['master']
                                  != m0).any()))
             for k, (p0, m0) in before.items()}
    # a bias of 0.5 moves less than its bf16 ulp in five steps: its master
    check(all(m['master'] for m in moved.values())
          and all(moved[k]['param'] for k in tracked[:3]),
          f'the weights did not move: {moved}')
    check(peak < card_bytes, f'peak {peak} bytes above the card\'s '
          f'{card_bytes}')
    lm_secs = sorted(r['seconds'] for r in records if r['objective'] == 'lm')
    median = lm_secs[len(lm_secs) // 2]
    busy, n_ops, _ = _device_busy(prof)
    wall_us = 1e6 * records[TRAIN_LM_STEPS - 1]['seconds']
    res = dict(arch=DENSE_ARCH, card=_card(), batch=TRAIN_BATCH,
               seq=TRAIN_LEN, layers=cfg.n_layers,
               n_params=sum(p.numel() for p in model.parameters()),
               grad_check=grad_check, grad_bars=DENSE_GRAD_BARS,
               embed_grad_bars=EMBED_GRAD_BARS,
               steps=records, median_lm_step_seconds=median,
               train_tokens_per_s=TRAIN_BATCH * TRAIN_LEN / median,
               peak_memory_gib=peak / 2 ** 30,
               card_memory_gib=card_bytes / 2 ** 30, moved=moved)
    del state, model, params, before, steps, metrics
    torch.cuda.empty_cache()
    parts = _attention_ms(ctx, cfg)
    res['profile_step'] = dict(
        objective='lm', step=TRAIN_LM_STEPS, wall_ms=wall_us / 1e3,
        device_busy_ms=busy / 1e3,
        idle_share=1.0 - busy / wall_us if n_ops else None,
        device_ops=n_ops, top_kernels=_top_kernels(prof, k=8),
        attention_share_of_device_time=parts['attn_ms_per_step'] * 1e3 / busy
        if busy else None,
        rope_share_of_device_time=parts['rope_ms_per_step'] * 1e3 / busy
        if busy else None, **parts)
    del prof
    res['widths'] = []
    for arch in DENSE_TRAIN_WIDTHS:
        res['widths'].append(_frontend_step(ctx, arch, g))
        torch.cuda.empty_cache()
    return res


# MLA and MoE training (moe_train phase): deepseek-v2-lite-16b at full
# width and MOE_TRAIN_LAYERS layers (the dense layer 0 and four MoE
# layers: 2.84e9 parameters, 42.3 GiB of train state at 16 bytes a
# parameter; its 27 layers would need 234 GiB), with the train phase's
# batch, length and steps; moonshot-v1-16b-a3b at full width and
# MOE_WIDTH_LAYERS layers, one lm step at that batch and length.
MOE_TRAIN_LAYERS = 5


def _fan_in_init(ctx, arch, layers):
    """`arch` at full width and `layers` layers, seeded weights drawn on
    the card (`init_model`), its stacked matrices then brought from the
    init's std 1/sqrt(L), L the stacked layers, to 1/sqrt(in)
    (`_fan_in_scaled`, the CPU tests' rule): at the init's std, 0.5 for
    four stacked layers, MLA's softmax saturates and a bf16 step is
    decided by rounding (PERF.md section 6, PRs 27-28)."""
    from repro_torch.configs.registry import get
    from repro_torch.models import lm as LM
    cfg = dataclasses.replace(get(arch), n_layers=layers)
    model = LM.init_model(cfg, seed=ctx['seed'], device=ctx['dev'])
    _fan_in_scaled(ctx['torch'], model)
    return cfg, model


def _expert_tokens(torch, model, run):
    """(kept choices per expert of the first MoE layer, dropped choices,
    all choices over the MoE layers) while run() runs; under remat
    'layer' each call is counted in the forward and in the recompute."""
    from repro_torch.models.layers import moe_route
    first = model.layers[0].ffn
    per_expert = torch.zeros(first.cfg.moe.num_experts, dtype=torch.long,
                             device=first.router.device)

    def hook(mod, args):
        x, cfg = args[0].detach(), args[1] if len(args) > 1 else mod.cfg
        _, idx, keep, _, _ = moe_route(mod, cfg, x.reshape(-1, x.shape[-1]))
        per_expert.add_(torch.bincount(idx.reshape(-1)[keep],
                                       minlength=per_expert.numel()))
    h = first.register_forward_pre_hook(hook)
    try:
        dropped, total = _moe_choices(model, run)
    finally:
        h.remove()
    return per_expert, dropped, total


def _moe_train_shares(ctx, model, cfg, busy_us):
    """CUDA-event ms of one MLA attention and one MoE block of `model` at
    the train step's (B, T) on seeded hidden states: once without
    autograd (a checkpointed layer's forward) and once with it plus its
    backward (its recompute and backward); times their layer counts,
    their estimated shares of a profiled step's device time."""
    torch, dev = ctx['torch'], ctx['dev']
    from repro_torch.kernels.platform import full_f32
    from repro_torch.models.layers import mla_attention
    lay = model.layers[0]
    g = torch.Generator(device=dev)
    g.manual_seed(ctx['seed'] + 13)
    shape = (TRAIN_BATCH, TRAIN_LEN, cfg.d_model)
    x = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    dy = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    pos = torch.arange(TRAIN_LEN, device=dev).expand(TRAIN_BATCH, TRAIN_LEN)
    blocks = {'attn': lambda h: mla_attention(lay.attn, cfg, h, pos)[0],
              'moe': lambda h: lay.ffn(h, cfg)}

    def run(fn, grad):
        if not grad:
            with torch.no_grad():
                return fn(x)
        leaf = x.detach().requires_grad_(True)
        params = [p for p in lay.parameters() if p.requires_grad]
        return torch.autograd.grad(fn(leaf), [leaf] + params, dy,
                                   allow_unused=True)

    out = {}
    with full_f32():
        for name, fn in blocks.items():
            out[f'{name}_fwd_ms'] = time_ms(torch, lambda: run(fn, False),
                                            reps=2)
            out[f'{name}_fwd_bwd_ms'] = time_ms(torch, lambda: run(fn, True),
                                                reps=2)
    counts = {'attn': cfg.n_layers, 'moe': cfg.n_layers - 1}
    for name, n in counts.items():
        per_step = n * (out[f'{name}_fwd_ms'] + out[f'{name}_fwd_bwd_ms'])
        out[f'{name}_ms_per_step'] = per_step
        out[f'{name}_share_of_device_time'] = (per_step * 1e3 / busy_us
                                               if busy_us else None)
    return out


def _layer0_remat_peaks(ctx, model, cfg, batch):
    """Peak GiB of one lm `loss_and_grads` at the step's batch with every
    layer checkpointed (the port's forward_train) and with layer 0 run
    outside the checkpoint (the reference's `forward_train`): what
    keeping layer 0's activations costs on the card. The two losses must
    be equal, bit for bit."""
    torch = ctx['torch']
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels.platform import full_f32
    from repro_torch.models import lm as LM
    from repro_torch.train.trainer import loss_and_grads
    inner = LM.checkpoint

    def outside(fn, lp, *args, **kw):
        return fn(lp, *args) if lp is model.layer0 else inner(fn, lp, *args,
                                                              **kw)
    out = {}
    for name, ckpt in (('checkpointed', inner), ('outside', outside)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        LM.checkpoint = ckpt
        try:
            with full_f32():
                loss, grads = loss_and_grads(
                    model, cfg, TrainConfig(remat='layer'), batch)
        finally:
            LM.checkpoint = inner
        torch.cuda.synchronize()
        out[f'{name}_peak_above_start_gib'] = (
            (torch.cuda.max_memory_allocated() - base) / 2 ** 30)
        out[f'{name}_loss'] = float(loss)
        del loss, grads
    check(out['checkpointed_loss'] == out['outside_loss'],
          f'layer 0 inside and outside the checkpoint differ: {out}')
    return out


def phase_moe_train(ctx):
    torch, dev = ctx['torch'], ctx['dev']
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import (RewardPipeline, TokenPipeline,
                                  TokenPipelineConfig)
    from repro_torch.train.trainer import make_train_step, state_for
    g = torch.Generator(device=dev)
    g.manual_seed(ctx['seed'] + 12)
    t_a = time.perf_counter()
    cfg, model = _fan_in_init(ctx, MOE_ARCH, MOE_TRAIN_LAYERS)
    init_s = time.perf_counter() - t_a
    grad_check = _dense_grad_check(ctx, model, cfg, g)
    torch.cuda.empty_cache()

    n_steps = TRAIN_LM_STEPS + TRAIN_RANK_STEPS
    tcfg = TrainConfig(objective='lm', remat='layer', microbatches=1,
                       warmup_steps=1, decay_steps=n_steps)
    steps = {'lm': make_train_step(cfg, tcfg),
             'rank_hinge': make_train_step(cfg, dataclasses.replace(
                 tcfg, objective='rank_hinge'))}
    tokens = TokenPipeline(TokenPipelineConfig(cfg.vocab, TRAIN_LEN,
                                               TRAIN_BATCH, seed=ctx['seed']))
    rewards = RewardPipeline(cfg.vocab, TRAIN_LEN, TRAIN_BATCH,
                             seed=ctx['seed'])
    state = state_for(model)
    last = len(model.layers) - 1
    tracked = ('layers.0.ffn.router', 'layers.0.ffn.w1',
               f'layers.{last}.ffn.shared.w2', 'layers.0.attn.w_uk',
               f'layers.{last}.attn.w_uv', 'layer0.ffn.w1', 'score_head')
    params = dict(model.named_parameters())
    before = {k: (params[k].detach().clone(),
                  state['opt']['mu'][k]['master'].clone()) for k in tracked}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    records, prof = [], None
    _reset_counts()
    for i in range(n_steps):
        objective = 'lm' if i < TRAIN_LM_STEPS else 'rank_hinge'
        raw = (tokens.batch(i) if objective == 'lm' else
               {k: v for k, v in rewards.batch(i).items()
                if k in ('tokens', 'utilities')})
        batch = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
        if i == 0:
            lm_batch = batch
        profiled = i == TRAIN_LM_STEPS - 1      # the last lm step
        if profiled:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:   # which experts the first step fed, what it dropped
            ran = []
            per_expert, dropped, total = _expert_tokens(
                torch, model,
                lambda: ran.append(steps[objective](state, batch)))
            state, metrics = ran.pop()
        else:
            state, metrics = steps[objective](state, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if profiled:
            prof.__exit__(None, None, None)
        rec = dict(step=i + 1, objective=objective, seconds=secs,
                   profiled=profiled,
                   **{k: float(v) for k, v in metrics.items()})
        records.append(rec)
        check(all(math.isfinite(rec[k]) for k in ('loss', 'gnorm', 'lr')),
              f'non-finite metrics at step {i + 1}: {rec}')
    peak = torch.cuda.max_memory_allocated()
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    launches = _counts()
    check(not any(launches.values()),
          f'a kernel of the port launched on the MoE train path: '
          f'{launches}')
    busiest = int(per_expert.argmax())
    moved = {}
    for k, (p0, m0) in before.items():
        p1, m1 = params[k].detach(), state['opt']['mu'][k]['master']
        if k == 'layers.0.ffn.w1':     # the expert that took most tokens
            p0, m0, p1, m1 = p0[busiest], m0[busiest], p1[busiest], m1[busiest]
        moved[k] = dict(param=bool((p1 != p0).any()),
                        master=bool((m1 != m0).any()))
    check(all(m['param'] and m['master'] for m in moved.values()),
          f'the weights did not move: {moved}')
    check(peak < card_bytes, f'peak {peak} bytes above the card\'s '
          f'{card_bytes}')
    lm_secs = sorted(r['seconds'] for r in records if r['objective'] == 'lm')
    median = lm_secs[len(lm_secs) // 2]
    busy, n_ops, _ = _device_busy(prof)
    wall_us = 1e6 * records[TRAIN_LM_STEPS - 1]['seconds']
    res = dict(arch=MOE_ARCH, card=_card(), batch=TRAIN_BATCH,
               seq=TRAIN_LEN, layers=cfg.n_layers, init='fan_in',
               n_params=sum(p.numel() for p in model.parameters()),
               init_seconds=init_s, grad_check=grad_check,
               grad_bars=DENSE_GRAD_BARS, embed_grad_bars=EMBED_GRAD_BARS,
               steps=records, median_lm_step_seconds=median,
               train_tokens_per_s=TRAIN_BATCH * TRAIN_LEN / median,
               peak_memory_gib=peak / 2 ** 30,
               card_memory_gib=card_bytes / 2 ** 30,
               step1_dropped_share=dropped / total, step1_choices=total,
               step1_busiest_expert=[busiest, float(
                   per_expert[busiest] / per_expert.sum())],
               step1_experts_fed=int((per_expert > 0).sum()), moved=moved)
    del state, params, before, steps, metrics
    torch.cuda.empty_cache()
    res['layer0_remat'] = _layer0_remat_peaks(ctx, model, cfg, lm_batch)
    res['profile_step'] = dict(
        objective='lm', step=TRAIN_LM_STEPS, wall_ms=wall_us / 1e3,
        device_busy_ms=busy / 1e3,
        idle_share=1.0 - busy / wall_us if n_ops else None,
        device_ops=n_ops, top_kernels=_top_kernels(prof, k=8),
        **_moe_train_shares(ctx, model, cfg, busy))
    del prof, model, lm_batch
    torch.cuda.empty_cache()
    res['moonshot'] = _moe_width_step(ctx, g)
    return res


def _moe_width_step(ctx, g):
    """One lm train step of moonshot-v1-16b-a3b at full width and
    MOE_WIDTH_LAYERS layers (fan-in-scaled seeded weights) at the train
    phase's batch and length: finite loss and gnorm."""
    torch, dev = ctx['torch'], ctx['dev']
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train.trainer import make_train_step, state_for
    torch.cuda.reset_peak_memory_stats()
    t_a = time.perf_counter()
    cfg, model = _fan_in_init(ctx, MOE_WIDTH_ARCH, MOE_WIDTH_LAYERS)
    seq = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_LEN + 1),
                        generator=g, device=dev, dtype=torch.int32)
    step = make_train_step(cfg, TrainConfig(remat='layer', warmup_steps=0,
                                            decay_steps=1))
    _, metrics = step(state_for(model), {'tokens': seq[:, :-1],
                                         'targets': seq[:, 1:]})
    torch.cuda.synchronize()
    row = dict(arch=MOE_WIDTH_ARCH, layers=cfg.n_layers,
               d_model=cfg.d_model, attn=cfg.attn, init='fan_in',
               batch=TRAIN_BATCH, seq=TRAIN_LEN,
               n_params=sum(p.numel() for p in model.parameters()),
               seconds=time.perf_counter() - t_a,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               **{k: float(v) for k, v in metrics.items()})
    check(math.isfinite(row['loss']) and math.isfinite(row['gnorm']),
          f'{MOE_WIDTH_ARCH}: non-finite train step: {row}')
    del model, metrics
    torch.cuda.empty_cache()
    return row


def _bf16_bars(torch, loss_s, a_s, loss_r, a_r):
    """The reference's bf16 bars of a sharded call against the tree's."""
    loss_s, loss_r = float(loss_s), float(loss_r)
    a_s, a_r = a_s.double(), a_r.double()
    cos = float(a_s @ a_r / (a_s.norm() * a_r.norm() + 1e-12))
    ok = (abs(loss_s - loss_r) <= SHARDED_LOSS_BAR * (1 + abs(loss_r))
          and cos > SHARDED_COS_BAR)
    return ok, dict(loss=loss_s, loss_tree=loss_r, cosine=cos)


def _sharded_calls(ctx, mesh, X, y, g, w):
    """Every variant and engine on the main data, ungrouped and in queries
    of QUERY_ROWS rows, on the one-rank NCCL mesh: one call's counts
    against the tree's on the same bf16 scores, the launches, the bf16
    bars against the fused tree oracle, ms per call."""
    torch = ctx['torch']
    from repro_torch.core import counts as TC
    from repro_torch.core.oracle import GroupedOracle, TreeOracle, make_oracle
    out = {}
    for groups in (None, g):
        fused = (TreeOracle(X, y, device=ctx['dev']) if groups is None
                 else GroupedOracle(X, y, groups, device=ctx['dev']))
        loss_r, a_r = fused.loss_and_subgrad(w)
        del fused
        for variant in ('base', 'opt'):
            for engine in ('tree', 'pallas'):
                o = make_oracle(X, y, groups, method='sharded', mesh=mesh,
                                variant=variant, engine=engine)
                _reset_counts()
                c, d = o.rank_counts(w)
                torch.cuda.synchronize()
                launches = _counts()['rank_counts']
                p = o._scores(*o._args, w)
                want = (TC.counts_fused(p, y) if groups is None
                        else TC.counts_grouped_fused(p, y, groups))
                key = (f'{"grouped" if groups is not None else "pool"}/'
                       f'{variant}/{engine}')
                check(torch.equal(c, want[0]) and torch.equal(d, want[1]),
                      f'sharded {key}: counts differ from the tree on the '
                      'same bf16 scores')
                check(launches == (1 if engine == 'pallas' else 0),
                      f'sharded {key}: {launches} rank-counts launches in '
                      'one call')
                ok, bars = _bf16_bars(torch, *o.loss_and_subgrad(w), loss_r,
                                      a_r)
                check(ok, f'sharded {key} outside the bf16 bars: {bars}')
                out[key] = dict(counts_equal_tree=True, launches=launches,
                                call_ms=time_ms(
                                    torch, lambda: o.loss_and_subgrad(w), 3),
                                **bars)
                del o, c, d, p, want
    return out


def _sharded_split(ctx, o, w):
    """CUDA-event ms of one sharded call and of its three parts."""
    torch = ctx['torch']
    p = o._scores(*o._args, w)
    c, d = o._count(p)
    v = (c - d).float() / o._np
    return dict(
        call_ms=time_ms(torch, lambda: o.loss_and_subgrad(w), 3),
        matvec_ms=time_ms(torch, lambda: o._scores(*o._args, w), 5),
        counting_ms=time_ms(torch, lambda: o._count(p), 3),
        transpose_ms=time_ms(torch, lambda: o._transpose(*o._args, v), 5))


def _sharded_rank(rank, world, tmp, seed, m, device):
    """One of the ranks that share the card: the main data (m rows) drawn
    on `device` from `seed` (bit-equal to the main phase's), a 'data' 2 x
    'model' 2 mesh over gloo, the one-rank run's calls and a short fit;
    its results are saved under `tmp`."""
    import datetime
    import torch
    import torch.distributed as dist
    dev = torch.device(device)
    on_card = dev.type == 'cuda'
    if on_card:
        dev = torch.device('cuda', dev.index or 0)
        torch.cuda.set_device(dev)
    dist.init_process_group('gloo', init_method=f'file://{tmp}/store',
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        from repro_torch.core.bmrm import bmrm
        from repro_torch.core.oracle import make_oracle
        from repro_torch.launch.mesh import make_mesh
        X, y, _, _ = _mslr_draw(torch, m, seed, dev)
        w = torch.load(os.path.join(tmp, 'w.pt')).to(dev)
        mesh = make_mesh(SHARDED_MESH, ('data', 'model'), device=dev)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        out = dict(coords=mesh.coords)
        for key, groups, variant, engine in (
                ('pool/opt/tree', None, 'opt', 'tree'),
                ('grouped/base/pallas',
                 torch.arange(m, device=dev) // QUERY_ROWS, 'base',
                 'pallas')):
            o = make_oracle(X, y, groups, method='sharded', mesh=mesh,
                            variant=variant, engine=engine)
            c, d = o.rank_counts(w)
            loss, a = o.loss_and_subgrad(w)
            out[key] = dict(rows=o.block.rows, c=c.cpu(), d=d.cpu(),
                            loss=float(loss), a=a.cpu())
            del o
        o = make_oracle(X, y, method='sharded', mesh=mesh, engine='pallas')
        del X
        t0 = time.perf_counter()
        res = bmrm(o, lam=LAM, eps=EPS, max_iter=SHARDED_FIT_ITER,
                   solver='device')
        out['fit'] = dict(w=res.w, iterations=res.stats.iterations,
                          seconds=time.perf_counter() - t0)
        out['peak_memory'] = (torch.cuda.max_memory_allocated() if on_card
                              else None)
        torch.save(out, os.path.join(tmp, f'rank{rank}.pt'))
    finally:
        dist.destroy_process_group()


def _sharded_four_ranks(ctx, ones, w_fit):
    """SHARDED_MESH's ranks on the card, each a process of its own, held
    to the one-rank run: counts bit for bit, loss and a within
    SHARDED_RANK_REL; after SHARDED_FIT_ITER bundle steps every rank's w
    the same bit for bit."""
    import multiprocessing
    import tempfile
    torch = ctx['torch']
    world = SHARDED_MESH[0] * SHARDED_MESH[1]
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(ctx['sharded_w'].cpu(), os.path.join(tmp, 'w.pt'))
        mp = multiprocessing.get_context('spawn')
        procs = [mp.Process(target=_sharded_rank,
                            args=(r, world, tmp, ctx['seed'], M,
                                  str(ctx['dev'])))
                 for r in range(world)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(600)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        wall = time.perf_counter() - t0
        check(all(p.exitcode == 0 for p in procs),
              f'rank exit codes {[p.exitcode for p in procs]}')
        ranks = [torch.load(os.path.join(tmp, f'rank{r}.pt'),
                            weights_only=False) for r in range(world)]
    out = dict(mesh=dict(zip(('data', 'model'), SHARDED_MESH)),
               backend='gloo', tensors_on=str(ctx['dev']), host_staged=False,
               seconds=wall, peak_memory=[r['peak_memory'] for r in ranks])
    for key, (c1, d1, loss1, a1) in ones.items():
        worst = 0.0
        for r in ranks:
            got = r[key]
            r0, r1 = got['rows']
            check(torch.equal(got['c'], c1[r0:r1].cpu())
                  and torch.equal(got['d'], d1[r0:r1].cpu()),
                  f'four ranks, {key}: counts of rank {r["coords"]} differ '
                  'from the one-rank run')
            scale = float(a1.abs().max())
            err = max(abs(got['loss'] - float(loss1)) / abs(float(loss1)),
                      float((got['a'] - a1.cpu()).abs().max()) / scale)
            worst = max(worst, err)
        check(worst <= SHARDED_RANK_REL,
              f'four ranks, {key}: loss or a {worst:.3g} off the one-rank '
              'run')
        out[key] = dict(counts_equal_one_rank=True, worst_rel_err=worst,
                        loss_bits_equal=all(
                            r[key]['loss'] == float(loss1) for r in ranks),
                        a_bits_equal=all(torch.equal(r[key]['a'], a1.cpu())
                                         for r in ranks))
    ws = [r['fit']['w'] for r in ranks]
    check(all((w == ws[0]).all() for w in ws),
          'four ranks ended the short fit with different w')
    out['fit'] = dict(iterations=ranks[0]['fit']['iterations'],
                      seconds=[r['fit']['seconds'] for r in ranks],
                      w_equal_on_every_rank=True,
                      w_equal_one_rank=bool((ws[0] == w_fit).all()))
    return out


def phase_sharded(ctx):
    """The sharded oracle on the card: one rank of a real NCCL group at
    the main cell's size (every variant and engine, a fit) and at the
    reuters_1m shape (CSR, a fit), the 'auto' engine's pairwise kernel,
    the compressed mean, and four gloo ranks sharing the card."""
    torch, dev = ctx['torch'], ctx['dev']
    import tempfile
    import torch.distributed as dist
    from repro_torch.core import counts as TC
    from repro_torch.core.bmrm import bmrm
    from repro_torch.core.oracle import make_oracle
    from repro_torch.core.ranksvm import RankSVM
    from repro_torch.distributed import compressed_mean
    from repro_torch.launch.mesh import Mesh, make_mesh
    X, y = ctx['X'], ctx['y']
    g = torch.arange(M, device=dev) // QUERY_ROWS
    w = torch.as_tensor(ctx['w_main'], dtype=torch.float32, device=dev)
    ctx['sharded_w'] = w
    res = dict(card=_card(), m=M, n=N_FEATURES, queries=M // QUERY_ROWS)
    tmp = tempfile.mkdtemp()
    dist.init_process_group('nccl', init_method=f'file://{tmp}/store',
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ('data', 'model'), device=dev)
        res['one_rank'] = dict(backend=mesh.backend, world=1)
        res['calls'] = _sharded_calls(ctx, mesh, X, y, g, w)
        ones = {}
        for key, groups, variant, engine in (
                ('pool/opt/tree', None, 'opt', 'tree'),
                ('grouped/base/pallas', g, 'base', 'pallas')):
            o = make_oracle(X, y, groups, method='sharded', mesh=mesh,
                            variant=variant, engine=engine)
            ones[key] = (*o.rank_counts(w), *o.loss_and_subgrad(w))
        o = make_oracle(X, y, method='sharded', mesh=mesh, engine='pallas')
        w_fit = bmrm(o, lam=LAM, eps=EPS, max_iter=SHARDED_FIT_ITER,
                     solver='device').w
        res['split'] = _sharded_split(ctx, o, w)
        del o
        # the fit through the estimator, against the main fit's J
        torch.cuda.synchronize()
        _reset_counts()
        svm = RankSVM(lam=LAM, eps=EPS, method='sharded', engine='pallas',
                      max_iter=MAX_ITER, mesh=mesh).fit(X, y)
        torch.cuda.synchronize()
        rep, launches = svm.report_, _counts()['rank_counts']
        j = svm.objective(X, y)
        check(rep.converged and abs(j - ctx['objective_main'])
              <= SHARDED_J_REL * abs(ctx['objective_main']),
              f'sharded fit J {j} (converged {rep.converged}) against the '
              f'main fit\'s {ctx["objective_main"]}')
        check(launches >= rep.iterations,
              f'{launches} rank-counts launches in {rep.iterations} '
              'iterations of the sharded fit')
        res['fit'] = dict(_fit_row(rep), objective_at_w=j,
                          objective_main=ctx['objective_main'],
                          launches=launches)
        del svm
        # the 'auto' engine at a gathered m the pairwise kernel takes
        Xa, ya = X[:SHARDED_AUTO_M], y[:SHARDED_AUTO_M]
        o = make_oracle(Xa, ya, method='sharded', mesh=mesh, engine='auto')
        _reset_counts()
        c, d = o.rank_counts(w)
        torch.cuda.synchronize()
        pw = _counts()['pairwise']
        want = TC.counts_fused(o._scores(*o._args, w), ya)
        check(pw == 1 and torch.equal(c, want[0])
              and torch.equal(d, want[1]),
              f"engine='auto' at m = {SHARDED_AUTO_M}: {pw} pairwise "
              'launches, or counts not the tree\'s')
        res['auto'] = dict(m=SHARDED_AUTO_M, pairwise_launches=pw,
                           counts_equal_tree=True)
        del o
        res['reuters'] = _sharded_reuters(ctx, mesh)
        # the compressed mean on the card against the CPU, bit for bit
        gen = torch.Generator().manual_seed(ctx['seed'])
        cpu_mesh = Mesh({'data': 1, 'model': 1}, {'data': 0, 'model': 0},
                        {}, 'cpu')
        err_c = err_d = None
        for _ in range(3):
            tree = {'w': torch.randn(32, 16, generator=gen),
                    'b': torch.randn(7, generator=gen)}
            mean_c, err_c = compressed_mean(tree, cpu_mesh, 'data', err_c)
            mean_d, err_d = compressed_mean(
                {k: v.to(dev) for k, v in tree.items()}, mesh, 'data', err_d)
            for k in tree:
                check(torch.equal(mean_d[k].cpu(), mean_c[k])
                      and torch.equal(err_d[k].cpu(), err_c[k]),
                      f'compressed_mean on the card != the CPU ({k})')
        res['compressed_mean'] = dict(steps=3, bits_equal_cpu=True)
    finally:
        dist.destroy_process_group()
    res['four_ranks'] = _sharded_four_ranks(ctx, ones, w_fit)
    return res


def _sharded_reuters(ctx, mesh):
    """reuters_1m (the sparse phase's data) through the CSR sharded oracle
    with the tree: one call's parts, and a fit against the resident tree
    fit's J."""
    torch = ctx['torch']
    from repro_torch.core.oracle import make_oracle
    from repro_torch.core.ranksvm import RankSVM
    data = ctx['reuters']
    X, y = data.X, data.y
    t0 = time.perf_counter()
    o = make_oracle(X, y, method='sharded', mesh=mesh)
    torch.cuda.synchronize()
    build = time.perf_counter() - t0
    check(o.name == 'sharded/csr', f'reuters_1m built {o.name}')
    w = torch.as_tensor(ctx['w_sparse'], dtype=torch.float32,
                        device=ctx['dev'])
    a1 = o.loss_and_subgrad(w)[1]
    check(torch.equal(a1, o.loss_and_subgrad(w)[1]),
          'two sharded CSR calls differ')
    out = dict(build_seconds=build, slot_bytes=sum(
        t.numel() * t.element_size() for t in o._args),
        **_sharded_split(ctx, o, w))
    del o
    torch.cuda.synchronize()
    _reset_counts()
    svm = RankSVM(lam=SPARSE_LAM, eps=EPS, method='sharded',
                  max_iter=MAX_ITER, mesh=mesh).fit(X, y)
    rep = svm.report_
    j = svm.objective(X, y)
    check(rep.converged and abs(j - ctx['sparse_objective'])
          <= SHARDED_J_REL * abs(ctx['sparse_objective']),
          f'sharded reuters_1m fit J {j} (converged {rep.converged}) '
          f'against the resident tree fit\'s {ctx["sparse_objective"]}')
    check(_counts()['rank_counts'] == 0,
          'reuters_1m (r ~= m) reached the rank-counts kernel')
    out['fit'] = dict(_fit_row(rep), objective_at_w=j,
                      objective_resident=ctx['sparse_objective'])
    return out


def phase_time(ctx):
    """Per-iteration breakdown at the main shapes, by CUDA events."""
    torch, dev = ctx['torch'], ctx['dev']
    from repro_torch.core import counts as TC
    from repro_torch.core.bmrm import DEFAULT_MAX_PLANES
    from repro_torch.core.qp import solve_bundle_dual_torch
    from repro_torch.kernels.platform import full_f32
    from repro_torch.kernels.rank_counts import ops as RC
    X, y = ctx['X'], ctx['y']
    w = torch.as_tensor(ctx['w_main'], dtype=torch.float32, device=dev)
    count = RC.rank_counter(y)
    with full_f32():
        p = X @ w
        out = dict(
            matvec_ms=time_ms(torch, lambda: X @ w, reps=20),
            rmatvec_ms=time_ms(torch, lambda: X.T @ p, reps=20),
            rank_counts_wrapper_ms=time_ms(torch, lambda: count(p), reps=5),
            tree_counts_ms=time_ms(torch, lambda: TC.counts_fused(p, y),
                                   reps=3))
        K = DEFAULT_MAX_PLANES
        g = torch.Generator(device=dev)
        g.manual_seed(ctx['seed'] + 3)
        A = torch.randn(K, X.shape[1], generator=g, device=dev)
        G, b = A @ A.T, torch.rand(K, generator=g, device=dev)
        mask = torch.arange(K, device=dev) < 40
        out['bundle_qp_ms'] = time_ms(
            torch, lambda: solve_bundle_dual_torch(G, b, LAM, mask,
                                                   n_iter=128), reps=3)
    ctx['rows'] = [_rank_counts_row(ctx), _pairwise_row(ctx),
                   ctx['wkv_row'], ctx['wkv_bwd_row']]
    for row in ctx['rows']:
        check(row['ms'] >= row['bound_ms'],
              f'{row["name"]}: {row["ms"]} ms is below its bound of '
              f'{row["bound_ms"]} ms: a misreading')
    return out


def _profile_bundle_step(ctx, steps: int = 3, lams=None):
    """Device busy share and kernel launches of device-driver bundle
    steps at the main shapes (engine='pallas'), from torch.profiler: the
    union of the CUDA kernels' intervals against the window's wall time.
    With `lams`, batched steps of the path sweep, one row per lambda."""
    torch, dev = ctx['torch'], ctx['dev']
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.bmrm import (DEFAULT_MAX_PLANES, _bundle_step,
                                       init_bundle_state, init_path_state)
    from repro_torch.core.oracle import make_oracle
    from repro_torch.kernels.platform import full_f32
    oracle = make_oracle(ctx['X'], ctx['y'], engine='pallas', device=dev)
    if lams is None:
        state = init_bundle_state(oracle.n, DEFAULT_MAX_PLANES, device=dev)
        lam = torch.tensor(LAM, device=dev)
    else:
        state = init_path_state(oracle.n, DEFAULT_MAX_PLANES, len(lams),
                                device=dev)
        lam = torch.tensor(lams, device=dev)
    eps = torch.tensor(EPS, device=dev)
    step = oracle.step_fn()
    with full_f32():
        for _ in range(2):                       # warm, and a few planes
            state, _ = _bundle_step(state, step, lam, eps, 128)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                state, _ = _bundle_step(state, step, lam, eps, 128)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
    busy, n_ops, _ = _device_busy(prof)
    if not n_ops:
        return dict(ms_per_step=wall_us / 1e3 / steps, idle_share=None,
                    note='the profiler saw no device activity')
    return dict(ms_per_step=wall_us / 1e3 / steps,
                device_busy_ms_per_step=busy / 1e3 / steps,
                idle_share=1.0 - busy / wall_us,
                device_ops_per_step=n_ops / steps)


def _device_busy(prof, name_part=None):
    """(microseconds in which some CUDA kernel ran, number of kernels,
    summed microseconds of the kernels whose name holds `name_part`)
    over a profiler window: the union of the kernels' intervals."""
    from torch.autograd import DeviceType
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s_, e_ in spans:
        if cur_e is None or s_ > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    if cur_e is not None:
        busy += cur_e - cur_s
    named = sum(e.time_range.end - e.time_range.start for e in events
                if name_part and name_part in e.name)
    return busy, len(spans), named


def _top_kernels(prof, k=6):
    """The k CUDA kernels with the most device time in a profiler
    window: [name (cut to 60 characters), ms, launches]."""
    from torch.autograd import DeviceType
    total = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, count = total.get(e.name, (0.0, 0))
            total[e.name] = (ms + (e.time_range.end - e.time_range.start)
                             / 1e3, count + 1)
    top = sorted(total.items(), key=lambda kv: -kv[1][0])[:k]
    return [[name[:60], ms, count] for name, (ms, count) in top]


PHASES = (('build', phase_build), ('parity', phase_parity),
          ('wkv_parity', phase_wkv_parity),
          ('wkv_bwd_parity', phase_wkv_bwd_parity), ('main', phase_main),
          ('path', phase_path), ('serve', phase_serve), ('auto', phase_auto), ('guard', phase_guard),
          ('sweep', phase_sweep), ('sparse', phase_sparse),
          ('stream', phase_stream), ('losses', phase_losses),
          ('refit', phase_refit), ('sharded', phase_sharded),
          ('lm', phase_lm), ('dense', phase_dense), ('moe', phase_moe),
          ('train', phase_train), ('dense_train', phase_dense_train),
          ('moe_train', phase_moe_train), ('time', phase_time))


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    return (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else f'nvidia-smi failed: {smi.stderr.strip()}')


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available; this script runs '
              'the port on the card only', file=sys.stderr)
        return 2
    src = os.path.join(ROOT, 'src')
    if not os.path.isdir(os.path.join(src, 'repro_torch')):
        print(f'chip_smoke: {src}/repro_torch not found; run from a '
              'checkout of the repository', file=sys.stderr)
        return 2
    sys.path.insert(0, src)

    ctx = dict(torch=torch, dev=torch.device('cuda'), seed=args.seed,
               launches={})
    t_all = time.perf_counter()
    for name, fn in PHASES:
        t0 = time.perf_counter()
        try:
            res = fn(ctx)
        except Exception as e:   # report which phase failed, then stop
            emit(phase=name, ok=False, error=f'{type(e).__name__}: {e}')
            return 1
        emit(phase=name, ok=True, wall_seconds=time.perf_counter() - t0,
             **res)
    print(_card())
    emit(kernels=ctx['rows'], total_seconds=time.perf_counter() - t_all)
    emit(ok=True, device=dict(platform='gpu',
                              kind=torch.cuda.get_device_name(0),
                              count=torch.cuda.device_count()))
    return 0


if __name__ == '__main__':
    sys.exit(main())
