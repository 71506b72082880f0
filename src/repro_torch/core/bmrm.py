"""Bundle Method for Regularized Risk Minimization: Algorithm 1 of the paper.

Minimizes J(w) = R_emp(w) + lam ||w||^2 by cutting planes (Teo et al.,
2010) with the best-iterate rule of Franc & Sonnenburg (2009): w_b tracks
the best J seen, and the gap J(w_b) - J_t(w_t) ends the run. The
counterpart of `repro.core.bmrm`, with the same two drivers behind
`bmrm(..., solver=)`:

* **host driver** (`solver='host'`): the float64 reference. One oracle
  call per loop turn; the plane matrix A stays on the oracle's device,
  while the Gram matrix, the dual QP (`qp.solve_bundle_dual`) and every
  scalar decision live on the host.
* **device driver** (`solver='device'`): the whole iteration on the
  device over a fixed-capacity `BundleState` (plane insert, Gram
  update, masked FISTA dual `qp.solve_bundle_dual_torch`, w update and
  gap), as an eager loop that reads one set of scalars back every
  `sync_every` steps; `sync_every='auto'` retunes that chunk length
  from the observed gap decay. Steps after convergence inside a chunk
  are computed and discarded (the state keeps its converged value), as
  the reference's skipped scan steps leave it.

The reference keeps a cache of compiled chunks shared across oracles
(`_SHARED_CHUNKS`) because each new oracle would otherwise be traced and
compiled again. Eager torch compiles nothing, so there is nothing to
cache. Capturing a chunk in a CUDA graph is later work.

`solver='auto'` picks the device driver when the oracle supports it and
eps is at or above the float32 noise floor.
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Callable, NamedTuple, Union

import numpy as np
import torch

from ..kernels.platform import full_f32
from .qp import solve_bundle_dual, solve_bundle_dual_torch

f32 = torch.float32

# Below this eps the float32 device bundle state's ~1e-6-relative noise
# floor can stall the gap; 'auto' then takes the float64 host driver.
F32_EPS_FLOOR = 1e-5

# sync_every='auto' schedule: start small for fast gap feedback, then
# size the next chunk from the observed gap-decay rate.
AUTO_SYNC_INIT = 4
AUTO_SYNC_MAX = 32

# Default plane capacity of the device driver's fixed buffers.
DEFAULT_MAX_PLANES = 64

SOLVERS = ('host', 'device', 'auto')


@dataclasses.dataclass
class BMRMStats:
    iterations: int
    converged: bool
    obj_best: float
    gap: float
    loss_history: list
    gap_history: list
    oracle_seconds: list  # host: per-iteration oracle wall time; device:
    # the chunk's wall time split evenly over its steps
    qp_seconds: list      # host driver only
    solver: str = 'host'


@dataclasses.dataclass
class BMRMResult:
    w: np.ndarray
    stats: BMRMStats
    state: 'BundleState | None' = None   # device driver: warm-startable


def bmrm(loss_and_subgrad: Union[Callable, object],
         dim: int | None = None,
         lam: float = 1e-3,
         eps: float = 1e-3,
         max_iter: int = 1000,
         w0: np.ndarray | None = None,
         max_planes: int | None = None,
         callback: Callable | None = None,
         solver: str = 'auto',
         sync_every: 'int | str' = 8,
         qp_iters: int = 128,
         state: 'BundleState | None' = None) -> BMRMResult:
    """Minimize R_emp(w) + lam ||w||^2 by cutting planes.

    The arguments are the reference's (`repro.core.bmrm.bmrm`):
    `loss_and_subgrad` is a RankOracle (anything with `.loss_and_subgrad`
    and `.n`) or a bare `w -> (R_emp, a)` callable over numpy arrays;
    `max_planes` is the host driver's optional cap or the device
    driver's buffer capacity; `sync_every` (int or 'auto') and `qp_iters`
    steer the device driver; `state` warm-starts it from an earlier
    result's `BundleState`."""
    if solver not in SOLVERS:
        raise ValueError(f'unknown solver {solver!r}; expected one of '
                         f'{SOLVERS}')
    if isinstance(sync_every, str) and sync_every != 'auto':
        raise ValueError(f"unknown sync_every {sync_every!r}; expected an "
                         "int or 'auto'")
    oracle = (loss_and_subgrad
              if hasattr(loss_and_subgrad, 'loss_and_subgrad') else None)
    fn = oracle.loss_and_subgrad if oracle is not None else loss_and_subgrad
    if dim is None:
        if oracle is None:
            raise ValueError('dim is required for bare-callable oracles')
        dim = int(oracle.n)
    device_capable = bool(oracle is not None
                          and getattr(oracle, 'supports_device_solver',
                                      False))
    if solver == 'device':
        if not device_capable:
            raise ValueError(
                "solver='device' needs an oracle with a step_fn "
                f'(core.oracle fused oracles); got '
                f'{type(loss_and_subgrad).__name__}')
        use_device = True
    else:
        use_device = (solver == 'auto' and device_capable
                      and eps >= F32_EPS_FLOOR)
    if use_device and eps < F32_EPS_FLOOR:
        warnings.warn(f'eps={eps:g} is below the f32 noise floor of the '
                      'device bundle state; the gap may stall above it',
                      RuntimeWarning, stacklevel=2)
    with full_f32():
        if use_device:
            return _bmrm_device(oracle, dim=dim, lam=lam, eps=eps,
                                max_iter=max_iter, w0=w0,
                                max_planes=max_planes, callback=callback,
                                sync_every=sync_every, qp_iters=qp_iters,
                                state=state)
        if state is not None:
            raise ValueError('bundle-state warm starts require the device '
                             "driver; pass solver='device' or w0=")
        device = (oracle.device if oracle is not None
                  and getattr(oracle, 'device_resident', False) else None)
        return _bmrm_host(fn, dim=dim, device=device, lam=lam, eps=eps,
                          max_iter=max_iter, w0=w0, max_planes=max_planes,
                          callback=callback)


# ------------------------------------------------------------- host driver


def _bmrm_host(fn, dim, device, lam, eps, max_iter, w0, max_planes,
               callback) -> BMRMResult:
    """Float64 reference driver: one oracle call per loop turn.

    `device` is the torch device of a device-resident oracle (the plane
    matrix then stays there in float32), or None for a bare callable
    over numpy float64 arrays."""
    on_dev = device is not None
    if on_dev and eps < F32_EPS_FLOOR:
        warnings.warn(f'eps={eps:g} is below the f32 noise floor of '
                      'device-resident oracles; the gap may stall above it',
                      RuntimeWarning, stacklevel=3)
    if on_dev:
        w_prev = (torch.zeros(dim, dtype=f32, device=device) if w0 is None
                  else torch.as_tensor(np.asarray(w0), dtype=f32,
                                       device=device))
        A = torch.zeros((0, dim), dtype=f32, device=device)
    else:
        w_prev = np.zeros(dim) if w0 is None else np.asarray(w0, np.float64)
        A = np.zeros((0, dim))

    bvec = np.zeros((0,))         # offsets b_i            (host, tiny)
    G = np.zeros((0, 0))          # Gram matrix A A'       (host, t x t)
    alpha = None
    w_best = w_prev if on_dev else w_prev.copy()
    j_best = np.inf
    stats = BMRMStats(0, False, np.inf, np.inf, [], [], [], [],
                      solver='host')

    for t in range(1, max_iter + 1):
        t0 = time.perf_counter()
        r_emp, a_t = fn(w_prev)
        r_emp = float(r_emp)      # waits for the device step
        stats.oracle_seconds.append(time.perf_counter() - t0)

        if on_dev:
            a_t = torch.as_tensor(a_t, dtype=f32, device=device)
        else:
            a_t = np.asarray(a_t, np.float64)
        wa = float(w_prev @ a_t)
        ww = float(w_prev @ w_prev)
        a_sq = float(a_t @ a_t)
        if len(A):
            cross = A @ a_t
            cross = (cross.double().cpu().numpy() if on_dev
                     else np.asarray(cross, np.float64))
        else:
            cross = np.zeros((0,))
        A = (torch.cat([A, a_t[None, :]], dim=0) if on_dev
             else np.vstack([A, a_t[None, :]]))

        j_prev = r_emp + lam * ww
        if j_prev < j_best:
            j_best, w_best = j_prev, (w_prev if on_dev else w_prev.copy())

        bvec = np.append(bvec, r_emp - wa)
        Gn = np.empty((len(bvec), len(bvec)))
        Gn[:-1, :-1] = G
        Gn[-1, :-1] = cross
        Gn[:-1, -1] = cross
        Gn[-1, -1] = a_sq
        G = Gn

        if max_planes is not None and len(bvec) > max_planes:
            # Drop the plane with the smallest dual weight of the previous
            # solve (the plane appended above is never the candidate).
            drop = int(np.argmin(alpha)) if alpha is not None else 0
            keep = np.ones(len(bvec), bool)
            keep[drop] = False
            if alpha is not None:
                alpha = alpha[keep[:-1]]
                s = alpha.sum()
                alpha = alpha / s if s > 0 else None
            bvec, G = bvec[keep], G[np.ix_(keep, keep)]
            if on_dev:
                A = A[torch.as_tensor(np.where(keep)[0], device=device)]
            else:
                A = A[keep]

        t1 = time.perf_counter()
        warm = None
        if alpha is not None and len(alpha) == len(bvec) - 1:
            warm = np.append(alpha * (1.0 - 1e-3), 1e-3)
        alpha, dual_val = solve_bundle_dual(G, bvec, lam, alpha0=warm)
        stats.qp_seconds.append(time.perf_counter() - t1)

        if on_dev:
            w_t = -(A.T @ torch.as_tensor(alpha, dtype=f32,
                                          device=device)) / (2.0 * lam)
        else:
            w_t = -(A.T @ alpha) / (2.0 * lam)
        wt_sq = float(w_t @ w_t)
        # J_t(w_t) = max_i (a_i . w_t + b_i) + lam ||w_t||^2, all via G.
        aw = -(G @ alpha) / (2.0 * lam)
        jt = float(np.max(aw + bvec) + lam * wt_sq)

        gap = j_best - jt
        stats.loss_history.append(r_emp)
        stats.gap_history.append(gap)
        stats.iterations = t
        if callback is not None:
            callback(t, w_t, j_best, gap)
        w_prev = w_t
        if gap < eps:
            stats.converged = True
            break

    stats.obj_best = float(j_best)
    stats.gap = float(stats.gap_history[-1]) if stats.gap_history else np.inf
    w_best = (w_best.double().cpu().numpy() if on_dev
              else np.asarray(w_best, np.float64))
    return BMRMResult(w=w_best, stats=stats)


# ----------------------------------------------------------- device driver


class BundleState(NamedTuple):
    """Fixed-capacity cutting-plane state, all on the oracle's device.

    K = max_planes is the buffer capacity; `n_active` counts the planes
    inserted so far (slots [0, n_active); past capacity the smallest-alpha
    slot is overwritten in place). `S` records the iterate each plane was
    cut at. Field for field the reference's `BundleState`, so a state can
    cross between the packages (`repro_torch.convert`)."""

    w: torch.Tensor         # (n,)   current iterate w_t
    w_best: torch.Tensor    # (n,)   best-J iterate
    j_best: torch.Tensor    # ()     J(w_best)
    A: torch.Tensor         # (K, n) plane gradients a_i
    b: torch.Tensor         # (K,)   plane offsets b_i
    G: torch.Tensor         # (K, K) Gram A A^T
    alpha: torch.Tensor     # (K,)   bundle dual (zero outside active set)
    n_active: torch.Tensor  # ()     int32 planes in buffer
    gap: torch.Tensor       # ()     J(w_best) - D(alpha)
    done: torch.Tensor      # ()     bool, gap < eps reached
    S: torch.Tensor         # (K, n) support iterate of each plane


def init_bundle_state(dim: int, max_planes: int, w0=None,
                      device='cuda') -> BundleState:
    dev = torch.device(device)
    w = (torch.zeros(dim, dtype=f32, device=dev) if w0 is None
         else torch.as_tensor(np.asarray(w0), dtype=f32, device=dev))
    K = int(max_planes)
    return BundleState(
        w=w, w_best=w.clone(),
        j_best=torch.tensor(np.inf, dtype=f32, device=dev),
        A=torch.zeros((K, dim), dtype=f32, device=dev),
        b=torch.zeros((K,), dtype=f32, device=dev),
        G=torch.zeros((K, K), dtype=f32, device=dev),
        alpha=torch.zeros((K,), dtype=f32, device=dev),
        n_active=torch.tensor(0, dtype=torch.int32, device=dev),
        gap=torch.tensor(np.inf, dtype=f32, device=dev),
        done=torch.tensor(False, device=dev),
        S=torch.zeros((K, dim), dtype=f32, device=dev))


def _bundle_step(s: BundleState, step_fn, lam, eps, qp_iters: int):
    """ONE BMRM iteration over the fixed-capacity state, with no read
    back to the host: the slot of the new plane is selected by a one-hot
    mask instead of an index. Returns (new state, R_emp)."""
    K = s.b.shape[0]
    r_emp, a = step_fn(s.w)
    r_emp = r_emp.to(f32)
    a = a.to(f32)

    wa = s.w @ a
    j_prev = r_emp + lam * (s.w @ s.w)
    better = j_prev < s.j_best
    j_best = torch.where(better, j_prev, s.j_best)
    w_best = torch.where(better, s.w, s.w_best)

    # Insert slot: next free, or (buffer full) the least-active plane.
    idx = torch.arange(K, dtype=torch.int32, device=a.device)
    full = s.n_active >= K
    masked_alpha = torch.where(idx < s.n_active, s.alpha,
                               torch.full_like(s.alpha, float('inf')))
    slot = torch.where(full, torch.argmin(masked_alpha).to(torch.int32),
                       s.n_active)
    hot = idx == slot
    A = torch.where(hot[:, None], a[None, :], s.A)
    # The slot's support iterate: the new plane is R_emp's tangent at s.w.
    S = torch.where(hot[:, None], s.w[None, :], s.S)
    cross = A @ a
    G = torch.where(hot[:, None], cross[None, :], s.G)
    G = torch.where(hot[None, :], cross[:, None], G)
    b = torch.where(hot, r_emp - wa, s.b)
    n_active = torch.clamp(s.n_active + 1, max=K)
    mask = idx < n_active

    # Warm-started masked QP; the new plane enters with a small weight.
    alpha0 = torch.where(hot, torch.full_like(s.alpha, 1e-3), s.alpha)
    alpha, dual = solve_bundle_dual_torch(G, b, lam, mask, alpha0=alpha0,
                                          n_iter=qp_iters)
    w = -(A.T @ alpha) / (2.0 * lam)

    # Gap against the DUAL value: an under-converged QP can only inflate
    # it, never fake convergence.
    gap = j_best - dual
    done = s.done | (gap < eps)
    return BundleState(w=w, w_best=w_best, j_best=j_best, A=A, b=b, G=G,
                       alpha=alpha, n_active=n_active, gap=gap,
                       done=done, S=S), r_emp


def _keep_if_done(s: BundleState, new: BundleState) -> BundleState:
    """The state after a step: unchanged where `s` had converged."""
    return BundleState(*(torch.where(s.done, old, nw)
                         for old, nw in zip(s, new)))


def _next_sync_every(gaps: np.ndarray, eps: float, cur: int) -> int:
    """Pick the next chunk length from the observed gap decay.

    Fits a geometric decay rate to the last chunk's gaps, predicts the
    steps left to eps and sizes the next chunk at about half of them, so
    the overshoot past convergence stays bounded by the useful work left.
    Chunk lengths are powers of two in [1, AUTO_SYNC_MAX]."""
    gaps = np.asarray([g for g in gaps if np.isfinite(g) and g > 0.0])
    if len(gaps) and gaps[-1] <= eps:
        return max(1, min(cur, AUTO_SYNC_MAX))   # about to converge
    if len(gaps) < 2:
        # No decay signal (also the only escape from cur == 1, whose
        # chunks yield a single gap sample): grow to amortize the sync.
        return max(1, min(2 * cur, AUTO_SYNC_MAX))
    rate = (gaps[-1] / gaps[0]) ** (1.0 / (len(gaps) - 1))
    if not (0.0 < rate < 1.0):
        return min(2 * cur, AUTO_SYNC_MAX)
    n_rem = math.log(gaps[-1] / eps) / math.log(1.0 / rate)
    target = max(1.0, n_rem / 2.0)
    return int(min(1 << int(math.floor(math.log2(target))), AUTO_SYNC_MAX))


def _bmrm_device(oracle, dim, lam, eps, max_iter, w0, max_planes, callback,
                 sync_every, qp_iters, state) -> BMRMResult:
    """Device driver: `sync_every` bundle steps per read-back."""
    dev = oracle.device
    K = int(max_planes) if max_planes is not None else DEFAULT_MAX_PLANES
    auto_sync = sync_every == 'auto'
    cur_sync = AUTO_SYNC_INIT if auto_sync else max(1, int(sync_every))

    if state is None:
        state = init_bundle_state(dim, K, w0, device=dev)
    else:
        if tuple(state.A.shape) != (K, dim):
            raise ValueError(f'warm-start state has buffer '
                             f'{tuple(state.A.shape)}, expected {(K, dim)}')
        # Planes stay (they under-estimate R_emp for ANY lam); the scalar
        # statistics depend on lam and reset.
        state = BundleState(*(t.to(dev) for t in state))
        w = (state.w if w0 is None
             else torch.as_tensor(np.asarray(w0), dtype=f32, device=dev))
        state = state._replace(
            w=w, w_best=w,
            j_best=torch.tensor(np.inf, dtype=f32, device=dev),
            gap=torch.tensor(np.inf, dtype=f32, device=dev),
            done=torch.tensor(False, device=dev))

    step_fn = oracle.step_fn()
    lam_d = torch.tensor(lam, dtype=f32, device=dev)
    eps_d = torch.tensor(eps, dtype=f32, device=dev)
    nan = torch.tensor(float('nan'), dtype=f32, device=dev)
    stats = BMRMStats(0, False, np.inf, np.inf, [], [], [], [],
                      solver='device')
    while True:                       # always >= 1 chunk
        t0 = time.perf_counter()
        losses, gaps, valids = [], [], []
        for _ in range(cur_sync):
            new, r = _bundle_step(state, step_fn, lam_d, eps_d, qp_iters)
            valid = ~state.done
            state = _keep_if_done(state, new)
            losses.append(torch.where(valid, r, nan))
            gaps.append(state.gap)
            valids.append(valid)
        # The one read-back per chunk.
        out = torch.stack([torch.stack(losses), torch.stack(gaps),
                           torch.stack(valids).to(f32)]).cpu().numpy()
        dt = time.perf_counter() - t0
        v = out[2] > 0.5
        steps = int(v.sum())
        chunk_gaps = out[1].astype(np.float64)[v]
        if steps:
            stats.loss_history.extend(out[0].astype(np.float64)[v])
            stats.gap_history.extend(chunk_gaps)
            stats.oracle_seconds.extend([dt / steps] * steps)
            stats.iterations += steps
        if callback is not None:
            callback(stats.iterations, state.w, float(state.j_best),
                     float(state.gap))
        if bool(state.done) or stats.iterations >= max_iter:
            break
        if auto_sync:
            cur_sync = _next_sync_every(chunk_gaps, eps, cur_sync)

    stats.converged = bool(state.done)
    stats.obj_best = float(state.j_best)
    stats.gap = float(state.gap)
    return BMRMResult(w=state.w_best.double().cpu().numpy(), stats=stats,
                      state=state)
