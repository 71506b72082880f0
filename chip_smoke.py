#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the RankSVM trainer once on one NVIDIA H100.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout on a machine with a CUDA card; it needs
`nvcc` (on PATH or under /usr/local/cuda) to build the kernels of
`src/repro_torch/kernels/csrc` into `.kernel_build/` at first use. It
imports neither JAX nor the JAX package. Phases, each printing one JSON
line; any failure ends the run with a non-zero exit code:

1. build   build every kernel (one nvcc per source, in parallel).
2. parity  each kernel against its plain torch version on the card,
           bit for bit: the pairwise kernel at m = 1, 127, 4096 with heavy
           ties; the rank-counts kernel at m = 65536 against its plain
           version and at m = 2^20 against the merge-sort tree.
3. main    the main path at MSLR-WEB10K width (136 dense features),
           m = 2^20 examples, five relevance grades, synthetic from
           --seed: `RankSVM(method='tree', engine='pallas').fit`, then
           engine='tree' on the same data. The rank-counts kernel must
           have been launched in the first fit, and the two objectives
           must agree within eps.
4. auto    `RankSVM(method='auto', engine='auto').fit` on `cadata_like`
           at m = 4096 (8 features, real-valued utilities): the pairwise
           kernel must have been launched, and the objective must agree
           with the tree engine's within eps.
5. guard   engine='pallas' on real-valued utilities at m = 2^20: more
           distinct utilities than histogram levels, so the wrapper must
           count with the tree (no kernel launch) and equal it.
6. time    where an iteration's time goes at the main shapes (CUDA
           events): score matvec, both counting paths, transpose matvec,
           one bundle QP; and a torch.profiler window over device-driver
           bundle steps (device busy share, device operations per step).

Then the card's name and power limit (nvidia-smi), one line
{"kernels": [...]} with each kernel's time, its plain version's time,
its bound (the larger of its bytes at 3.35 TB/s and its operations at
67 TFLOP/s) and its launches on the main path, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
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
        for line in _build.build_log(src).splitlines():
            if 'registers' in line:
                regs[src] = line.split('ptxas info    :')[-1].strip()
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
    for m in (1, 127, 4096):
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
    prep = RC._prepare(p, RC._compact_ranks(y), RC.TI, RC.TJ,
                       RC.DEFAULT_LEVELS)[1:]
    c, d = RC.sorted_counts(*prep)
    cp, dp = rank_counts_plain(*prep, RC.TI, RC.TJ)
    torch.cuda.synchronize()
    check(torch.equal(c, cp) and torch.equal(d, dp),
          'rank-counts kernel != plain at m=65536')
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


def _reset_counts():
    from repro_torch.kernels.pairwise_rank import ops as PR
    from repro_torch.kernels.rank_counts import ops as RC
    PR.PAIRWISE.launches = 0
    RC.RANK_COUNTS.launches = 0


def _counts():
    from repro_torch.kernels.pairwise_rank import ops as PR
    from repro_torch.kernels.rank_counts import ops as RC
    return dict(pairwise=PR.PAIRWISE.launches,
                rank_counts=RC.RANK_COUNTS.launches)


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


def _rank_counts_row(ctx):
    torch, dev = ctx['torch'], ctx['dev']
    from repro_torch.kernels.rank_counts import ops as RC
    from repro_torch.kernels.rank_counts.ref import rank_counts_plain
    X, y = ctx['X'], ctx['y']
    p = X @ torch.as_tensor(ctx['w_main'], dtype=torch.float32, device=dev)
    _, band, ps, yr, gt, lt = RC._prepare(
        p, RC._compact_ranks(y), RC.TI, RC.TJ, RC.DEFAULT_LEVELS)
    args = (band, ps, yr, gt, lt)
    ms = time_ms(torch, lambda: RC._launch(*args, RC.TI, RC.TJ), reps=20)
    c, d = RC._launch(*args, RC.TI, RC.TJ)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cp, dp = rank_counts_plain(*args, RC.TI, RC.TJ)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = max(int((c - cp).abs().max()), int((d - dp).abs().max()))
    check(err == 0, 'rank-counts kernel != plain at the main shapes')
    count = RC.rank_counter(y)
    wrapper_ms = time_ms(torch, lambda: count(p), reps=5)
    # The least the card could take is the bytes of the kernel's inputs,
    # each read once, and of c and d, each written once. The compares
    # over the partial bands are not the function's work (their number
    # follows the candidate tile TJ), so they are printed beside the
    # bound as `band_compares` and do not enter it.
    m = ps.shape[0]
    nbytes = 4 * (band.numel() + 2 * m + gt.numel() + lt.numel() + 2 * m)
    q = torch.clamp(m - torch.arange(band.shape[0], device=dev) * RC.TI,
                    max=RC.TI)
    b = band.long()

    def width(lo, hi):          # candidates in tiles [lo, hi)
        return torch.clamp(torch.clamp(hi * RC.TJ, max=m) - lo * RC.TJ,
                           min=0)

    pairs = int((q * (width(b[:, 0], b[:, 1])
                      + width(b[:, 2], b[:, 3]))).sum())
    return _row('rank_counts', 'src/repro_torch/kernels/csrc/rank_counts.cu',
                'src/repro/kernels/rank_counts/kernel.py:59',
                ctx['launches']['rank_counts'], err, ms, plain_ms, nbytes,
                None, m=m, band_compares=2 * pairs, wrapper_ms=wrapper_ms,
                launches_per_iteration=ctx['launches']['rank_counts']
                / ctx['main_iterations'])


def _pairwise_row(ctx):
    torch = ctx['torch']
    from repro_torch.kernels.pairwise_rank import ops as PR
    from repro_torch.kernels.pairwise_rank.ref import pairwise_counts_plain
    X, y, w = ctx['auto_data']
    p = X @ torch.as_tensor(w, dtype=torch.float32, device=X.device)
    ms = time_ms(torch, lambda: PR._launch(p, y), reps=50)
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
                4 * m * m, m=m, launches_per_iteration=ctx['launches'][
                    'pairwise'] / ctx['auto_iterations'])


def _row(name, source, replaces, launches, err, ms, plain_ms, nbytes, ops,
         **extra):
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 0.0 if ops is None else 1e3 * ops / F32_OPS_PER_S
    return dict(name=name, route='cuda', source=source, replaces=replaces,
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by='bytes' if t_bytes >= t_ops else 'operations',
                library_ms=None, bytes=nbytes, operations=ops, **extra)


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
    rows = [_rank_counts_row(ctx), _pairwise_row(ctx)]
    ctx['rows'] = rows
    return out


def _profile_bundle_step(ctx, steps: int = 3):
    """Device busy share and kernel launches of device-driver bundle
    steps at the main shapes (engine='pallas'), from torch.profiler: the
    union of the CUDA kernels' intervals against the window's wall time."""
    torch, dev = ctx['torch'], ctx['dev']
    from torch.autograd import DeviceType
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
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s_, e_ in spans:
        if cur_e is None or s_ > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    if cur_e is not None:
        busy += cur_e - cur_s
    if not spans:
        return dict(ms_per_step=wall_us / 1e3 / steps, idle_share=None,
                    note='the profiler saw no device activity')
    return dict(ms_per_step=wall_us / 1e3 / steps,
                device_busy_ms_per_step=busy / 1e3 / steps,
                idle_share=1.0 - busy / wall_us,
                device_ops_per_step=len(spans) / steps)


PHASES = (('build', phase_build), ('parity', phase_parity),
          ('main', phase_main), ('auto', phase_auto), ('guard', phase_guard),
          ('time', phase_time))


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
