#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA H100: RankSVM training
through the counting kernels, RWKV-6 serving through the WKV forward
kernel, and RWKV-6 training through both WKV kernels.

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
           have been launched in the first fit, and the two objectives
           must agree within eps.
6. auto    `RankSVM(method='auto', engine='auto').fit` on `cadata_like`
           at m = 4096 (8 features, real-valued utilities): the pairwise
           kernel must have been launched, and the objective must agree
           with the tree engine's within eps.
7. guard   engine='pallas' on real-valued utilities at m = 2^20: more
           distinct utilities than histogram levels, so the wrapper must
           count with the tree (no kernel launch) and equal it.
8. sweep   the counting tiers on the card, for KERNEL_MAX_M and
           DEFAULT_LEVELS: the pairwise kernel, the rank-counts call and
           the tree at m = 2^10 .. 2^16, and the rank-counts call against
           the tree at m = 2^20 with 64, 256 and 1024 distinct utilities;
           all agree bit for bit at every point.
9. sparse  the paper's Reuters experiment at reuters_1m: `reuters_like`
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
           Then five grades cut at quantiles of the utilities:
           engine='pallas' must launch the rank-counts kernel every
           iteration and reach the tree engine's objective within eps;
           and `method='auto'` on a 4096-row Reuters sample must launch
           the pairwise kernel every iteration, its counts at the fitted
           w equal to the CPU tree's.
10. stream the same data streamed under memory_budget = 0.1953125 GiB
           (half the features' 0.39 GiB on the card): method='auto' must
           pick the streaming oracle; the bytes allocated on the card
           above the phase's start (peak reset before each measured
           call) stay within the budget at prefetch 0 and 1 for an
           oracle call, and for the whole streamed fit (prefetch 1); the
           two depths give bit-identical (loss, a) at one block size; the
           streamed fit's objective is within eps of the resident one;
           and five grades through the stream count with the
           rank-counts kernel, inside the budget.
11. lm      RWKV-6 serving at the full rwkv6-3b width and depth (32
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
12. train  RWKV-6 training at the full rwkv6-3b width and depth, seeded
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
13. time   where an iteration's time goes at the main shapes (CUDA
           events): score matvec, both counting paths, transpose matvec,
           one bundle QP; and a torch.profiler window over device-driver
           bundle steps (device busy share, device operations per step).

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
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

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
# RWKV-6 serving (lm phase): prefill batch and length (prefill_32k is
# 32 x 32768), greedy decode steps, and the consistency checks' shape.
LM_BATCH, LM_PROMPT, LM_DECODE = 8, 4096, 32
CHECK_BATCH, CHECK_LEN = 2, 256
# RWKV-6 training (train phase): batch and length (train_4k is 256 x
# 4096), steps of each objective, and the gradient checks' shape.
TRAIN_BATCH, TRAIN_LEN = 4, 4096
TRAIN_LM_STEPS, TRAIN_RANK_STEPS = 3, 2
GRAD_BATCH, GRAD_LEN = 1, 256
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


def device_ms(torch, fn, name_part: str, reps: int) -> float:
    """Mean milliseconds per fn() of the CUDA kernels whose name holds
    `name_part`, from their device durations in a profiler window: the
    kernels' own time, without the host's launch cost that a short
    kernel's back-to-back CUDA-event time is bound by."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        named = _device_busy(prof, name_part)[2]
        if named > 0:
            return named / 1e3 / reps
    check(False, f'{PROFILE_TRIES} profiler windows saw no {name_part} '
          'kernel')


def mslr_like(torch, m: int, seed: int, dev):
    """Dense MSLR-WEB10K-width data made on the card from `seed`: 136
    standardized features and five relevance grades cut from a noisy
    linear utility at the GRADE_SHARES quantiles."""
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


def _fit(ctx, X, y, **kw):
    from repro_torch.core.ranksvm import RankSVM
    torch = ctx['torch']
    torch.cuda.synchronize()
    svm = RankSVM(device=ctx['dev'], **kw).fit(X, y)
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
    X, y = mslr_like(torch, M, ctx['seed'], ctx['dev'])
    ctx['X'], ctx['y'] = X, y
    kw = dict(lam=LAM, eps=EPS, method='tree', max_iter=MAX_ITER)
    _reset_counts()
    svm_k, rep_k = _fit(ctx, X, y, engine='pallas', **kw)
    launches = _counts()
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
    res = dict(m=M, n=N_FEATURES, grades=len(GRADE_SHARES),
               launches=launches, objective_pallas=j_k, objective_tree=j_t)
    for name, rep in (('pallas', rep_k), ('tree', rep_t)):
        res[name] = dict(iterations=rep.iterations, converged=rep.converged,
                         gap=rep.gap, solver=rep.solver, seconds=rep.seconds,
                         ms_per_iteration=1e3 * rep.seconds / rep.iterations)
    return res


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
    ms = device_ms(torch, lambda: RC._launch(*args, RC.TI, tj), 'rc_', 50)
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
    return _row('rank_counts', 'src/repro_torch/kernels/csrc/rank_counts.cu',
                'src/repro/kernels/rank_counts/kernel.py:59',
                ctx['launches']['rank_counts'], err, ms, plain_ms, 16 * m,
                None, m=m, n_ranks=n_ranks, tj=tj, events_ms=events_ms,
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
    if depth < cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=depth)
        model = LM.from_state_dict(cfg, {
            k: v for k, v in model.state_dict().items()
            if not k.startswith('layers.') or int(k.split('.')[1]) < depth})
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
               rel_norm=[0.0, None], max_abs_over_scale=[0.0, None])
    rels = []
    for name, b in gs.items():
        a, b = gk[name].float(), b.float()
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
    out['bundle_step'] = _profile_bundle_step(ctx)
    ctx['rows'] = [_rank_counts_row(ctx), _pairwise_row(ctx),
                   ctx['wkv_row'], ctx['wkv_bwd_row']]
    return out


def _profile_bundle_step(ctx, steps: int = 3):
    """Device busy share and kernel launches of device-driver bundle
    steps at the main shapes (engine='pallas'), from torch.profiler: the
    union of the CUDA kernels' intervals against the window's wall time."""
    torch, dev = ctx['torch'], ctx['dev']
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.bmrm import (DEFAULT_MAX_PLANES, _bundle_step,
                                       init_bundle_state)
    from repro_torch.core.oracle import make_oracle
    from repro_torch.kernels.platform import full_f32
    oracle = make_oracle(ctx['X'], ctx['y'], engine='pallas', device=dev)
    state = init_bundle_state(oracle.n, DEFAULT_MAX_PLANES, device=dev)
    lam = torch.tensor(LAM, device=dev)
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
          ('auto', phase_auto), ('guard', phase_guard),
          ('sweep', phase_sweep), ('sparse', phase_sparse),
          ('stream', phase_stream), ('lm', phase_lm),
          ('train', phase_train), ('time', phase_time))


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
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f'nvidia-smi failed: {smi.stderr.strip()}')
    emit(kernels=ctx['rows'], total_seconds=time.perf_counter() - t_all)
    emit(ok=True, device=dict(platform='gpu',
                              kind=torch.cuda.get_device_name(0),
                              count=torch.cuda.device_count()))
    return 0


if __name__ == '__main__':
    sys.exit(main())
