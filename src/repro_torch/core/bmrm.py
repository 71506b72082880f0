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
prefers it (`prefer_device_solver`: not for a CSR oracle whose
transpose-matvec runs on the host, nor for a streamed CSR source), and
eps is at or above the float32 noise floor.

**Regularization path** (`bmrm_path`, DESIGN.md §7): 'sequential' fits
one lambda after another, each warm-started from the last one's planes;
'vmap' steps every lambda at once over a bundle state with a leading
lambda axis (`init_path_state`), the counterpart of the reference's
vmapped program: `_bundle_step` carries the axis through every tensor
operation, the oracle takes a batch of iterates (`supports_path_vmap`),
and a converged lambda's slice is frozen by its done flag; 'hybrid'
runs a sequential prefix and broadcasts its planes to a batched tail.
'auto' batches on the card and stays sequential on the CPU (where the
reference measured the batched sweep 2-8x slower).

**On a mesh of ranks** (`core.oracle.ShardedOracle`) every rank runs
the same driver over a bundle state replicated on every rank: the
oracle returns all of a, the same bits on every rank, so every rank
solves the same QP and reads back the same gaps, and the ranks leave the
loop at the same step with the same w. The reference instead splits the
columns of the plane and iterate buffers (A, S) over 'model'
(`repro.core.bmrm.bundle_state_shardings`), which saves memory only at
pod-scale n (64 planes of 49152 features take 12.6 MB); that layout is
not ported (ROADMAP.md Queue 1 item 12).
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
from .qp import _dot, _mv, solve_bundle_dual, solve_bundle_dual_torch

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
    seconds: float = float('nan')  # the fit's wall time, filled by
    # `bmrm_path`; in mode='vmap' each lambda's share of the joint sweep
    # (a batched step's wall split evenly over the lambdas active in it,
    # so seconds == sum(oracle_seconds))


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
                      and getattr(oracle, 'prefer_device_solver', True)
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


def bundle_state_from_planes(A, b, S, dim: int, max_planes: int,
                             w0=None, alpha=None,
                             device='cuda') -> BundleState:
    """A warm-startable `BundleState` from bare planes, on `device`.

    The inverse of reading (A, b, S) off a fitted state: `core.incremental`
    revalidates retained planes against changed data and re-enters the
    device driver through here. The P <= max_planes planes land in slots
    [0, P); `alpha` (default uniform over the P planes) is normalised and
    seeds the first masked QP; the scalar statistics start reset, as for
    a lambda warm start. The Gram block A A^T is the reference's float32
    numpy product on the host, so that G equals the reference's bit for
    bit (a product on the card would have to keep TF32 off to match it),
    and is then moved to the device with the rest."""
    A = np.asarray(A, np.float32)
    b = np.asarray(b, np.float32).ravel()
    S = np.asarray(S, np.float32)
    K, n = int(max_planes), int(dim)
    P = len(b)
    if A.shape != (P, n) or S.shape != (P, n):
        raise ValueError(f'planes A{A.shape}/S{S.shape} do not match '
                         f'({P}, {n})')
    if P > K:
        raise ValueError(f'{P} planes exceed the max_planes={K} buffer; '
                         'trim to the highest-dual-weight planes first')
    st = init_bundle_state(n, K, w0, device=device)
    if P == 0:
        return st
    if alpha is None:
        al = np.full(P, 1.0 / P, np.float32)
    else:
        al = np.asarray(alpha, np.float32).ravel()
        if al.shape != (P,):
            raise ValueError(f'alpha has shape {al.shape}, expected ({P},)')
        tot = float(al.sum())
        al = al / tot if tot > 0 else np.full(P, 1.0 / P, np.float32)
    bufs = {}
    for name, val, shape in (('A', A, (K, n)), ('S', S, (K, n)),
                             ('b', b, (K,)), ('alpha', al, (K,))):
        buf = np.zeros(shape, np.float32)
        buf[:P] = val
        bufs[name] = buf
    G = np.zeros((K, K), np.float32)
    G[:P, :P] = A @ A.T
    dev = st.w.device
    return st._replace(
        **{k: torch.from_numpy(v).to(dev) for k, v in bufs.items()},
        G=torch.from_numpy(G).to(dev),
        n_active=torch.tensor(P, dtype=torch.int32, device=dev))


def _bundle_step(s: BundleState, step_fn, lam, eps, qp_iters: int):
    """ONE BMRM iteration over the fixed-capacity state, with no read
    back to the host: the slot of the new plane is selected by a one-hot
    mask instead of an index. Returns (new state, R_emp).

    The same code steps a batched state, every field with a leading
    lambda axis (`init_path_state`), when `step_fn` takes (L, n) iterates
    and `lam` is (L,): every operation below then carries the lambda
    axis, so a batched step issues the launches of one step (the
    oracle's per-row counting aside) where the reference vmaps it."""
    K = s.b.shape[-1]
    r_emp, a = step_fn(s.w)
    r_emp = r_emp.to(f32)
    a = a.to(f32)

    wa = _dot(s.w, a)
    j_prev = r_emp + lam * _dot(s.w, s.w)
    better = j_prev < s.j_best
    j_best = torch.where(better, j_prev, s.j_best)
    w_best = torch.where(better[..., None], s.w, s.w_best)

    # Insert slot: next free, or (buffer full) the least-active plane.
    idx = torch.arange(K, dtype=torch.int32, device=a.device)
    full = s.n_active >= K
    masked_alpha = torch.where(idx < s.n_active[..., None], s.alpha,
                               torch.full_like(s.alpha, float('inf')))
    slot = torch.where(full, torch.argmin(masked_alpha, dim=-1).to(
        torch.int32), s.n_active)
    hot = idx == slot[..., None]
    A = torch.where(hot[..., None], a[..., None, :], s.A)
    # The slot's support iterate: the new plane is R_emp's tangent at s.w.
    S = torch.where(hot[..., None], s.w[..., None, :], s.S)
    cross = _mv(A, a)
    G = torch.where(hot[..., None], cross[..., None, :], s.G)
    G = torch.where(hot[..., None, :], cross[..., :, None], G)
    b = torch.where(hot, (r_emp - wa)[..., None], s.b)
    n_active = torch.clamp(s.n_active + 1, max=K)
    mask = idx < n_active[..., None]

    # Warm-started masked QP; the new plane enters with a small weight.
    alpha0 = torch.where(hot, torch.full_like(s.alpha, 1e-3), s.alpha)
    alpha, dual = solve_bundle_dual_torch(G, b, lam, mask, alpha0=alpha0,
                                          n_iter=qp_iters)
    lam_v = torch.as_tensor(lam, dtype=f32, device=a.device)[..., None]
    w = -_mv(A.mT, alpha) / (2.0 * lam_v)

    # Gap against the DUAL value: an under-converged QP can only inflate
    # it, never fake convergence.
    gap = j_best - dual
    done = s.done | (gap < eps)
    return BundleState(w=w, w_best=w_best, j_best=j_best, A=A, b=b, G=G,
                       alpha=alpha, n_active=n_active, gap=gap,
                       done=done, S=S), r_emp


def _keep_if_done(s: BundleState, new: BundleState) -> BundleState:
    """The state after a step: unchanged where `s` had converged (per
    lambda for a batched state)."""
    def keep(old, nw):
        done = s.done.view(s.done.shape + (1,) * (old.dim() - s.done.dim()))
        return torch.where(done, old, nw)
    return BundleState(*(keep(old, nw) for old, nw in zip(s, new)))


def _run_chunk(state: BundleState, step_fn, lam, eps, qp_iters: int,
               steps: int):
    """`steps` bundle steps with converged states frozen, then the one
    read-back: (state, host array (3, steps[, L]) of the losses (NaN
    where frozen), the gaps and the active flags)."""
    nan = torch.tensor(float('nan'), dtype=f32, device=state.w.device)
    losses, gaps, valids = [], [], []
    for _ in range(steps):
        new, r = _bundle_step(state, step_fn, lam, eps, qp_iters)
        valid = ~state.done
        state = _keep_if_done(state, new)
        losses.append(torch.where(valid, r, nan))
        gaps.append(state.gap)
        valids.append(valid)
    out = torch.stack([torch.stack(losses), torch.stack(gaps),
                       torch.stack(valids).to(f32)]).cpu().numpy()
    return state, out


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
        state = _reset_stats(BundleState(*(t.to(dev) for t in state)), w0)

    step_fn = oracle.step_fn()
    lam_d = torch.tensor(lam, dtype=f32, device=dev)
    eps_d = torch.tensor(eps, dtype=f32, device=dev)
    stats = BMRMStats(0, False, np.inf, np.inf, [], [], [], [],
                      solver='device')
    while True:                       # always >= 1 chunk
        t0 = time.perf_counter()
        state, out = _run_chunk(state, step_fn, lam_d, eps_d, qp_iters,
                                cur_sync)
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


# ------------------------------------------------------ batched path sweep


PATH_MODES = ('vmap', 'sequential', 'hybrid', 'auto')

# Sequential-warm prefix of mode='hybrid': the first fit does the heavy
# lifting, the second starts warm, and the rest batch.
DEFAULT_HYBRID_PREFIX = 2


def _validate_path_mode(mode: str) -> str:
    """The one mode check of `bmrm_path` and `RankSVM.path`; the
    estimator runs it before it builds its oracle."""
    if mode not in PATH_MODES:
        raise ValueError(f'unknown path mode {mode!r}; expected one of '
                         f'{PATH_MODES}')
    return mode


def _validate_lams(lams) -> list:
    """Regularization-path lambdas as a validated list of floats.

    Any order, duplicates included, is accepted; every value must be a
    finite positive float whose float32 cast is a normal number, since
    lambda divides the master-problem update w = -A'alpha / (2 lam) on
    the device in float32."""
    try:
        lams = [float(lam) for lam in np.asarray(lams).ravel()]
    except (TypeError, ValueError) as e:
        raise ValueError(f'path lambdas must be real numbers; got {lams!r}'
                         ) from e
    if not lams:
        raise ValueError('a regularization path needs at least one lambda')
    tiny = float(np.finfo(np.float32).tiny)      # smallest NORMAL f32
    bad = [lam for lam in lams if not math.isfinite(lam) or lam <= 0.0
           or not tiny <= float(np.float32(lam)) < math.inf]
    if bad:
        raise ValueError(
            f'path lambdas must be finite, > 0, and a normal float32 (in '
            f'[{tiny:.3g}, ~3.4e38]) — the device drivers compute in f32 '
            f'— got {bad}: lambda scales 1/(2 lam) in the master problem, '
            'so a value that is zero/non-finite, overflows the f32 cast, '
            'or lands subnormal poisons every iterate')
    return lams


def path_state_gib(n_lams: int, dim: int, max_planes: int | None = None,
                   m: int = 0) -> float:
    """Projected GiB that the batched (vmap) sweep adds on the device.

    The reference's model, kept: each of the `n_lams` lambdas holds its
    own float32 `BundleState` (the (max_planes, dim) plane and support
    buffers dominate) plus the step's per-example working set, about 8
    float32 values an example. The port's batched step holds, per lambda
    and example, the scores and the counts (12 bytes) through the
    counting pass, whose sort (values and int64 order) and scratch go
    row by row, and then the scores, the coefficients and the loss's
    temporaries (20 bytes): inside the 32 of the model
    (`chip_smoke.py`'s path phase measures the peak against it). The
    features, shared by every mode, are not counted."""
    planes = int(max_planes) if max_planes is not None else DEFAULT_MAX_PLANES
    per_lam = 4.0 * (2 * planes * dim     # plane buffer A + iterate buffer S
                     + 2 * dim            # w, w_best
                     + planes * planes    # Gram
                     + 3 * planes + 8     # b, alpha, masks, scalars
                     + 8 * m)             # oracle-step per-example work set
    return int(n_lams) * per_lam / 2**30


def _reset_stats(state: BundleState, w0=None) -> BundleState:
    """A warm start's state: planes kept (they under-estimate R_emp for
    any lambda), the lambda-dependent statistics reset."""
    dev = state.w.device
    lead = state.j_best.shape
    w = (state.w if w0 is None else torch.as_tensor(
        np.asarray(w0), dtype=f32, device=dev).expand_as(state.w).clone())
    return state._replace(
        w=w, w_best=w, j_best=torch.full(lead, np.inf, dtype=f32, device=dev),
        gap=torch.full(lead, np.inf, dtype=f32, device=dev),
        done=torch.zeros(lead, dtype=torch.bool, device=dev))


def init_path_state(dim: int, max_planes: int, n_lams: int, w0=None,
                    state: 'BundleState | None' = None,
                    device='cuda') -> BundleState:
    """A (n_lams, ...)-leading `BundleState`: slice k of every field is
    lambda k's bundle state.

    Without `state` every lambda starts cold from the shared w0. With a
    scalar `state` (the last fit of a sequential prefix, in the hybrid
    sweep) every slice starts from its planes with the statistics reset,
    as `bmrm(..., state=)` does. A state that already has the leading
    lambda axis (a batched state carried across, `repro_torch.convert`)
    is taken slice for slice, statistics reset the same way."""
    K, n, L = int(max_planes), int(dim), int(n_lams)
    if state is None:
        s = init_bundle_state(n, K, w0, device=device)
    else:
        shape = tuple(state.A.shape)
        if shape == (L, K, n):
            return _reset_stats(BundleState(*(t.to(device) for t in state)),
                                w0)
        if shape != (K, n):
            raise ValueError(f'seed state has buffer {shape}, expected '
                             f'{(K, n)} or {(L, K, n)}')
        s = _reset_stats(BundleState(*(t.to(device) for t in state)), w0)
    return BundleState(*(t[None].expand((L,) + t.shape).clone() for t in s))


def _path_on_cpu(oracle) -> bool:
    """Whether the oracle computes on the CPU, where 'auto' keeps the
    sequential sweep (the reference's measured rule for its serial CPU
    backend); the card batches."""
    return torch.device(oracle.device).type == 'cpu'


def _bmrm_path_vmap(oracle, lams, dim, eps, max_iter, w0, max_planes,
                    sync_every, qp_iters, callback,
                    init_state: 'BundleState | None' = None
                    ) -> 'list[BMRMResult]':
    """The batched path driver: one (L, ...)-leading state steps every
    lambda at once, `sync_every` steps per read-back; converged slices
    are frozen by their done flags, and the loop ends when every lambda
    is done (or the shared step count reaches max_iter: lambdas advance
    in lockstep)."""
    dev = oracle.device
    K = int(max_planes) if max_planes is not None else DEFAULT_MAX_PLANES
    n_lams = len(lams)
    auto_sync = sync_every == 'auto'
    cur_sync = AUTO_SYNC_INIT if auto_sync else max(1, int(sync_every))

    state = init_path_state(dim, K, n_lams, w0, state=init_state,
                            device=dev)
    step_fn = oracle.step_fn()
    lams_d = torch.tensor(lams, dtype=f32, device=dev)
    eps_d = torch.tensor(eps, dtype=f32, device=dev)

    iters = np.zeros(n_lams, np.int64)
    loss_hist = [[] for _ in range(n_lams)]
    gap_hist = [[] for _ in range(n_lams)]
    secs = [[] for _ in range(n_lams)]
    steps_total = 0
    with full_f32():
        while True:
            t0 = time.perf_counter()
            state, out = _run_chunk(state, step_fn, lams_d, eps_d, qp_iters,
                                    cur_sync)
            dt = time.perf_counter() - t0
            losses = out[0].astype(np.float64)       # (sync, L)
            gaps_np = out[1].astype(np.float64)
            acts = out[2] > 0.5
            ran = acts.any(axis=1)                   # batched steps that ran
            steps = int(ran.sum())
            steps_total += steps
            # Each batched step's wall splits evenly over the lambdas
            # active in it, so the shares sum to the sweep's wall.
            n_active = acts.sum(axis=1)
            step_wall = dt / max(steps, 1)
            for k in range(n_lams):
                on = acts[:, k]
                nk = int(on.sum())
                if nk:
                    iters[k] += nk
                    loss_hist[k].extend(losses[on, k])
                    gap_hist[k].extend(gaps_np[on, k])
                    secs[k].extend(step_wall / n_active[on])
            if callback is not None:
                callback(steps_total, state.w, state.j_best.cpu().numpy(),
                         state.gap.cpu().numpy())
            if bool(state.done.all()) or steps_total >= max_iter:
                break
            if auto_sync:
                # Tune on the slowest lambda: all-done ends the loop.
                act_gaps = np.where(acts[ran], gaps_np[ran], -np.inf)
                cur_sync = _next_sync_every(act_gaps.max(axis=1), eps,
                                            cur_sync)

    done = state.done.cpu().numpy()
    j_best = state.j_best.double().cpu().numpy()
    gap = state.gap.double().cpu().numpy()
    w_best = state.w_best.double().cpu().numpy()
    results = []
    for k in range(n_lams):
        stats = BMRMStats(
            iterations=int(iters[k]), converged=bool(done[k]),
            obj_best=float(j_best[k]), gap=float(gap[k]),
            loss_history=loss_hist[k], gap_history=gap_hist[k],
            oracle_seconds=secs[k], qp_seconds=[], solver='vmap',
            seconds=float(np.sum(secs[k])))
        results.append(BMRMResult(
            w=w_best[k], stats=stats,
            state=BundleState(*(t[k] for t in state))))
    return results


def bmrm_path(oracle, lams, *, mode: str = 'auto', eps: float = 1e-3,
              max_iter: int = 1000, w0: np.ndarray | None = None,
              max_planes: int | None = None, solver: str = 'auto',
              sync_every: 'int | str' = 8, qp_iters: int = 128,
              memory_budget: float | None = None,
              hybrid_prefix: int = DEFAULT_HYBRID_PREFIX,
              callback: Callable | None = None) -> 'list[BMRMResult]':
    """Sweep a regularization path over `lams`; one BMRMResult per lambda,
    in `lams` order. The arguments are the reference's
    (`repro.core.bmrm.bmrm_path`):

      mode: 'vmap' (every lambda at once over a batched state; needs
        `supports_path_vmap` and the device driver), 'sequential' (one
        fit per lambda, each warm-started from the last: bundle state on
        the device driver, w0 on the host driver), 'hybrid' (the first
        `hybrid_prefix` lambdas sequentially, then the last prefix fit's
        planes broadcast to a batched tail) or 'auto': vmap when the
        oracle batches, the solver allows the device driver, eps is at or
        above the float32 floor, the oracle is on the card (the CPU keeps
        the sequential sweep) and the batched state fits `memory_budget`;
        else sequential.
      memory_budget: GiB the batched sweep may add (`path_state_gib`);
        over it the sweep falls back to sequential with a RuntimeWarning,
        under an explicit mode='vmap' too.
      callback: forwarded to each sequential fit; the batched driver calls
        it per read-back with (steps, W, J (L,), gaps (L,)).

    The other arguments are `bmrm`'s, per lambda."""
    _validate_path_mode(mode)
    if solver not in SOLVERS:
        # The vmap branch never reaches bmrm()'s own check.
        raise ValueError(f'unknown solver {solver!r}; expected one of '
                         f'{SOLVERS}')
    if not hasattr(oracle, 'loss_and_subgrad'):
        raise ValueError('bmrm_path needs a RankOracle (make_oracle); for '
                         'bare callables run bmrm once per lambda')
    lams = _validate_lams(lams)
    dim = int(oracle.n)
    batchable = bool(getattr(oracle, 'supports_path_vmap', False))

    if mode in ('vmap', 'hybrid'):
        if not batchable:
            raise ValueError(
                f"mode={mode!r} needs an oracle whose step batches over "
                f'lambda (supports_path_vmap); {type(oracle).__name__} '
                'does not: the streaming oracle passes over its row blocks '
                "with one iterate. Use mode='sequential' (or 'auto')")
        if solver == 'host':
            raise ValueError(f"mode={mode!r} runs the device driver; it "
                             "cannot run under solver='host': pass "
                             "solver='auto'/'device' or mode='sequential'")
        if eps < F32_EPS_FLOOR:
            warnings.warn(
                f'eps={eps:g} is below the f32 noise floor of the batched '
                'bundle state; per-lambda gaps may stall above it and the '
                'lockstep sweep would then spin to max_iter: use '
                f"mode='sequential' for eps < {F32_EPS_FLOOR:g}",
                RuntimeWarning, stacklevel=2)
    if mode == 'hybrid':
        if not (isinstance(hybrid_prefix, (int, np.integer))
                and not isinstance(hybrid_prefix, bool)
                and int(hybrid_prefix) >= 1):
            raise ValueError('hybrid_prefix must be a positive int; got '
                             f'{hybrid_prefix!r}')

    def _over_budget(n_batched: int) -> bool:
        if memory_budget is None:
            return False
        projected = path_state_gib(n_batched, dim, max_planes,
                                   m=int(getattr(oracle, 'm', 0)))
        if projected > float(memory_budget):
            warnings.warn(
                f'batched path sweep over {n_batched} lambdas projects '
                f'~{projected:.3g} GiB of per-lambda bundle state + oracle '
                f'working set (path_state_gib), over the '
                f'{float(memory_budget):g} GiB memory_budget; falling '
                'back to the sequential warm-started sweep. Raise the '
                'budget, lower max_planes, or split the lambda grid to '
                'batch it.', RuntimeWarning, stacklevel=3)
            return True
        return False

    def _sequential(seq_lams, state=None, w_prev=None):
        results = []
        for lam in seq_lams:
            t0 = time.perf_counter()
            res = bmrm(oracle, lam=lam, eps=eps, max_iter=max_iter,
                       w0=w_prev, max_planes=max_planes, callback=callback,
                       solver=solver, sync_every=sync_every,
                       qp_iters=qp_iters, state=state)
            res.stats.seconds = time.perf_counter() - t0
            state = res.state        # None on the host driver
            w_prev = res.w
            results.append(res)
        return results

    def _vmap(vlams, w_start, seed):
        return _bmrm_path_vmap(oracle, vlams, dim=dim, eps=eps,
                               max_iter=max_iter, w0=w_start,
                               max_planes=max_planes,
                               sync_every=sync_every, qp_iters=qp_iters,
                               callback=callback, init_state=seed)

    if mode == 'hybrid':
        prefix = min(int(hybrid_prefix), len(lams))
        head = _sequential(lams[:prefix], w_prev=w0)
        tail_lams = lams[prefix:]
        if not tail_lams:
            return head
        seed = head[-1].state
        if seed is None or _over_budget(len(tail_lams)):
            # No bundle state when the prefix ran on the host driver:
            # finish sequentially-warm.
            if seed is None:
                warnings.warn(
                    "mode='hybrid': the sequential prefix ran on the host "
                    'driver (no bundle state to broadcast); finishing '
                    'the sweep sequentially', RuntimeWarning, stacklevel=2)
            return head + _sequential(tail_lams, state=seed,
                                      w_prev=head[-1].w)
        return head + _vmap(tail_lams, None, seed)

    use_vmap = mode == 'vmap' or (
        mode == 'auto' and batchable and solver != 'host'
        and getattr(oracle, 'prefer_device_solver', True)
        and eps >= F32_EPS_FLOOR and not _path_on_cpu(oracle))
    if use_vmap and _over_budget(len(lams)):
        use_vmap = False
    if use_vmap:
        return _vmap(lams, w0, None)
    return _sequential(lams, w_prev=w0)
