"""RankSVM estimator: TreeRSVM (the paper's method) and PairRSVM (baseline).

The counterpart of `repro.core.ranksvm.RankSVM`: dense and CSR
features, streamed features, the losses 'hinge' (the paper's), 'toppush'
and 'poshinge' (DESIGN.md §12), methods 'tree', 'pairs', 'auto',
'stream' and 'sharded', both BMRM drivers.
`method=` picks the oracle (`core.oracle.make_oracle`), `engine=` its
counting engine and `solver=` the BMRM driver (`core.bmrm`); the
estimator itself touches no counting internals. The model trains on
`device` (default 'cuda'); without a card that raises unless
device='cpu' is given. `path` sweeps a regularization path
(`core.bmrm.bmrm_path`), and `scorer`/`scores`/`top_k` serve the fitted
weights through `repro_torch.serve`.

Both `fit` and `path` leave an `incremental_` handle
(`core.incremental.IncrementalFit`) over a `data.rowblocks.BlockStore`
of the training data; `refit` appends or retires row blocks and solves
warm from the revalidated planes ('ledger') or from w alone ('w-only'),
and can hot-swap the new weights into a serving `WeightStore` or
`RankingService` (DESIGN.md §11). The store holds the fit's features as
given: a tensor on the card is neither copied nor moved.

method='sharded' splits the features over a mesh of ranks
(`core.oracle.ShardedOracle`, `launch.mesh`): every rank of the process
group builds the estimator and calls `fit` or `path` with the same
arguments, and every rank ends with the same w. It trains the hinge
only; another loss raises in `fit` before X is touched.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from ..kernels.platform import full_f32, resolve_device
from . import rank_loss as _rank_loss
from .bmrm import (DEFAULT_HYBRID_PREFIX, DEFAULT_MAX_PLANES,
                   F32_EPS_FLOOR, SOLVERS, _validate_lams,
                   _validate_path_mode, bmrm, bmrm_path)
from ..data import rowblocks as _rowblocks
from ..data.rowblocks import BlockStore, _validate_prefetch
from .counts import _validate_block_rows, _validate_engine
from .incremental import (LEDGER_LOSSES, IncrementalFit, RefitReport,
                          block_partials)
from .oracle import (METHODS, _as_numpy, _validate_loss, empirical_risk,
                     make_oracle)

REFIT_MODES = ('ledger', 'w-only', 'auto')


@dataclasses.dataclass
class FitReport:
    iterations: int
    converged: bool
    objective: float
    gap: float
    seconds: float
    oracle_seconds_mean: float
    loss_history: list
    solver: str = 'host'


@dataclasses.dataclass
class PathPoint:
    """One lambda of a regularization-path sweep (`RankSVM.path`)."""
    lam: float
    w: np.ndarray
    report: FitReport


class RankSVM:
    """Linear RankSVM trained with BMRM.

    Args (as in the reference unless noted):
      lam: regularization weight of J(w) = R_emp(w) + lam ||w||^2.
      eps: BMRM termination gap. Below `core.bmrm.F32_EPS_FLOOR` the
        solver='auto' choice is the float64 host driver.
      method: 'tree' | 'pairs' | 'auto' | 'stream' | 'sharded'. 'auto'
        streams when `memory_budget` is set and the projected fused
        residency exceeds it, and always for an np.memmap or a row-block
        source; 'sharded' splits X over `mesh` and trains the hinge only.
      loss: 'hinge' (the paper's pairwise hinge), 'toppush' (each
        anchored example against the best-scoring lower one) or
        'poshinge' (pairs weighted by the higher side's utility rank);
        `objective` evaluates the same loss.
      engine: counting-engine override, None | 'tree' | 'blocked' |
        'pallas' (the rank-counts kernel) | 'auto' (the pairwise kernel up
        to KERNEL_MAX_M examples, the rank-counts kernel above).
      solver: 'host' | 'device' | 'auto'.
      max_iter, max_planes, sync_every, qp_iters, pair_block: BMRM and
        blocked-engine knobs.
      memory_budget: GiB (float) for method='auto''s fused-versus-
        streaming choice and the streaming oracle's block size; None
        disables both.
      stream_block: rows per block of the streaming oracle (default:
        budget-derived, core.oracle._auto_stream_block).
      prefetch: the streaming oracle's read-ahead depth (None/'auto' |
        int >= 0; 'auto' double-buffers memmap sources); results are
        bit-identical at any depth. Validated here, ignored by the fused
        oracles.
      mesh: the `launch.mesh.Mesh` of method='sharded'; None takes
        `launch.mesh.default_mesh` (every rank of the process group on
        'data', or one rank). Its device is the model's when `device` is
        not given.
      device: where the model trains, default 'cuda' (port only).
    """

    def __init__(self, lam: float = 1e-3, eps: float = 1e-3,
                 method: str = 'tree', max_iter: int = 1000,
                 pair_block: int = 2048, verbose: bool = False,
                 solver: str = 'auto', max_planes: int | None = None,
                 sync_every: 'int | str' = 8, qp_iters: int = 128,
                 memory_budget: float | None = None,
                 stream_block: int | None = None,
                 engine: str | None = None, prefetch=None,
                 loss: str = 'hinge', device=None, mesh=None):
        if method not in METHODS:
            raise ValueError(f'unknown method {method!r}; '
                             f'expected one of {METHODS}')
        _validate_loss(loss)
        self.loss = loss
        if engine is not None:
            _validate_engine(engine)
        self.engine = engine
        if solver not in SOLVERS:
            raise ValueError(f'unknown solver {solver!r}; '
                             f'expected one of {SOLVERS}')
        self.lam = float(lam)
        self.eps = float(eps)
        self.method = method
        self.solver = solver
        self.max_iter = int(max_iter)
        self.max_planes = max_planes
        if isinstance(sync_every, str) and sync_every != 'auto':
            raise ValueError(f"unknown sync_every {sync_every!r}; expected "
                             "an int or 'auto'")
        self.sync_every = (sync_every if sync_every == 'auto'
                           else int(sync_every))
        self.qp_iters = int(qp_iters)
        self.pair_block = _validate_block_rows(pair_block, 'pair_block')
        self.memory_budget = (None if memory_budget is None
                              else float(memory_budget))
        self.stream_block = (None if stream_block is None
                             else _validate_block_rows(stream_block,
                                                       'stream_block'))
        _validate_prefetch(prefetch)    # fail at construction, not fit
        self.prefetch = prefetch
        self.verbose = verbose
        self.mesh = mesh
        self.device = (mesh.device if mesh is not None and device is None
                       else resolve_device(device))
        self.w_: np.ndarray | None = None
        self.report_: FitReport | None = None
        self.oracle_ = None
        self.incremental_: IncrementalFit | None = None
        self.refit_report_: RefitReport | None = None

    # -- public API --------------------------------------------------------

    def fit(self, X, y=None, groups=None):
        """Learn w from features X (m, n) and utility scores y.

        X is dense (numpy, or torch: a float32 X already on the device is
        used in place), CSR (`data.sparse.CSRMatrix`, scipy, a torch
        sparse tensor), an np.memmap or a `data.rowblocks` row-block
        source; y is numpy or torch. X may also be a `BlockStore` (y and
        groups omitted: the store carries them). Either way the fit leaves
        an `incremental_` handle, so that `refit()` can later append or
        retire row blocks and warm-start from this solution."""
        store, y, groups = self._as_store(X, y, groups)
        oracle = self._make_oracle(store if isinstance(X, BlockStore)
                                   else X, y, groups)
        self.oracle_ = oracle
        t0 = time.perf_counter()
        res = self._solve(oracle)
        dt = time.perf_counter() - t0
        self.w_ = res.w
        self.report_ = self._report(res, dt)
        self.incremental_ = IncrementalFit(store, res.state,
                                           self._ledger_norm(oracle),
                                           partials_fn=self._partials_fn())
        return self

    def path(self, X, y, lams, groups=None, mode: str = 'auto',
             hybrid_prefix: int | None = None) -> list[PathPoint]:
        """Fit a regularization path over `lams`; one PathPoint per lambda.

        `lams` in any order, duplicates allowed, each finite and > 0.
        `mode` is 'vmap' (every lambda at once over a batched bundle
        state, trading K plane buffers of max_planes x n floats,
        `core.bmrm.path_state_gib`, for one batched step per iteration),
        'sequential' (one warm-started fit per lambda), 'hybrid'
        (`hybrid_prefix` sequential fits, default
        `core.bmrm.DEFAULT_HYBRID_PREFIX` = 2, then a batched tail from the
        last one's planes) or 'auto' (vmap on the card for the fused
        oracles within `memory_budget`, sequential on the CPU and for
        the streaming oracle): `core.bmrm.bmrm_path`.

        The mode and the lambdas are checked before the oracle is built.
        Leaves the estimator fitted at the LAST lambda of `lams`. In vmap
        mode each report's `seconds` is the lambda's share of the joint
        sweep. `incremental_` is left from the last lambda's state, as
        `fit` leaves it."""
        _validate_path_mode(mode)
        lams = _validate_lams(lams)
        store, y, groups = self._as_store(X, y, groups)
        oracle = self._make_oracle(store if isinstance(X, BlockStore)
                                   else X, y, groups)
        self.oracle_ = oracle
        results = bmrm_path(
            oracle, lams, mode=mode, eps=self.eps, max_iter=self.max_iter,
            max_planes=self.max_planes, solver=self.solver,
            sync_every=self.sync_every, qp_iters=self.qp_iters,
            memory_budget=self.memory_budget,
            hybrid_prefix=(DEFAULT_HYBRID_PREFIX if hybrid_prefix is None
                           else int(hybrid_prefix)),
            callback=(lambda t, w, j, g:
                      print(f'  bmrm it={t} J_best={np.asarray(j)} '
                            f'gap={np.asarray(g)}'))
            if self.verbose else None)
        points = [PathPoint(lam=lam, w=res.w,
                            report=self._report(res, res.stats.seconds))
                  for lam, res in zip(lams, results)]
        last = points[-1]
        self.w_, self.report_, self.lam = last.w, last.report, last.lam
        self.incremental_ = IncrementalFit(store, results[-1].state,
                                           self._ledger_norm(oracle),
                                           partials_fn=self._partials_fn())
        return points

    def refit(self, X=None, y=None, groups=None, *, retire=(),
              mode: str = 'auto', weight_store=None) -> RefitReport:
        """Retrain incrementally after a data change (DESIGN.md §11).

        Appends one row block (X, y[, groups]) and/or retires blocks by
        id, then solves warm instead of cold:

          mode='ledger'  revalidate every retained plane against the
                         changed rows only (`core.incremental.PlaneLedger`)
                         and re-enter the device driver with the plane
                         buffer and the previous dual. Needs a
                         device-driver fit (the host driver keeps no
                         bundle state); a retired base block makes the
                         ledger rebuild over the survivors.
          mode='w-only'  drop the planes; warm-start from w alone.
          mode='auto'    'ledger' when there is a ledger, the merged
                         oracle runs the device driver and no retired
                         block belongs to the base component; 'w-only'
                         otherwise (always for loss='poshinge').

        Returns a `RefitReport`, also kept as `refit_report_`, and
        refreshes `w_` and `report_`; with `weight_store` (a
        `serve.WeightStore` or a `serve.RankingService`) the new weights
        are hot-swapped into it."""
        if self.incremental_ is None:
            raise RuntimeError('fit() first — refit() continues a fitted '
                               'model')
        if mode not in REFIT_MODES:
            raise ValueError(f'unknown refit mode {mode!r}; expected one '
                             f'of {REFIT_MODES}')
        if mode == 'ledger' and self.loss not in LEDGER_LOSSES:
            raise ValueError(
                f"mode='ledger' is unavailable for loss={self.loss!r}: "
                'its position weights depend on merged within-group '
                'utility ranks, so retained planes are not per-block '
                'revalidatable (core.incremental.LEDGER_LOSSES); refit '
                "with mode='w-only' (mode='auto' does so automatically)")
        inc = self.incremental_
        retire = ((int(retire),) if isinstance(retire, (int, np.integer))
                  else tuple(int(b) for b in retire))
        if X is None and not retire:
            raise ValueError('refit() needs a block to append (X, y) '
                             'and/or block ids to retire')
        if (X is None) != (y is None):
            raise ValueError('append needs both X and y')

        resolved = mode
        if resolved != 'w-only' and inc.ledger is None:
            if resolved == 'ledger':
                raise ValueError(
                    "mode='ledger' needs a device-driver fitted bundle "
                    'state (the host driver keeps none); refit with '
                    "mode='w-only' or fit with solver='device'")
            resolved = 'w-only'
        if resolved == 'auto':
            # Base-component planes are not per-block subtractable: a
            # ledger refit would rebuild partials over every survivor.
            resolved = ('w-only' if any(b in inc.ledger.base_bids
                                        for b in retire) else 'ledger')
        if resolved == 'w-only':
            inc.ledger = None

        inc.revalidate_seconds = 0.0
        for bid in retire:
            inc.retire(bid)
        appended, delta_rows = (), 0
        if X is not None:
            bid = inc.append(X, y, groups)
            appended = (bid,)
            delta_rows = inc.store.member(bid).source.m
        if not inc.store.block_ids:
            raise ValueError('refit retired every block; nothing left to '
                             'train on')

        store = inc.store
        oracle = self._make_oracle(store, store.y, store.groups)
        self.oracle_ = oracle
        if resolved == 'ledger' and not self._device_solvable(oracle):
            if mode == 'ledger':
                raise ValueError(
                    "mode='ledger' needs the device driver, but the "
                    f'merged {type(oracle).__name__} cannot run it under '
                    f"solver={self.solver!r} (eps={self.eps:g}); use "
                    "mode='w-only'")
            resolved = 'w-only'
            inc.ledger = None

        K = (int(self.max_planes) if self.max_planes is not None
             else DEFAULT_MAX_PLANES)
        t0 = time.perf_counter()
        state = None
        if resolved == 'ledger':
            state = inc.warm_state(int(oracle.n), K, w0=self.w_,
                                   device=oracle.device)
            if state is None:           # e.g. the ledger lost all pairs
                resolved = 'w-only'
        if resolved == 'ledger':
            n_planes = int(state.n_active)
            res = self._solve(oracle, state=state)
        else:
            n_planes = 0
            res = self._solve(oracle, w0=self.w_)
        dt = time.perf_counter() - t0

        inc.commit(res.state, self._ledger_norm(oracle))
        self.w_ = res.w
        self.report_ = self._report(res, dt)
        self.refit_report_ = RefitReport(
            mode=resolved, appended=appended, retired=retire,
            n_planes=n_planes, delta_rows=delta_rows,
            revalidate_seconds=inc.revalidate_seconds, fit=self.report_)
        if weight_store is not None:
            if hasattr(weight_store, 'swap_weights'):   # RankingService
                weight_store.swap_weights(self)
            else:                                       # WeightStore
                weight_store.swap(self)
        return self.refit_report_

    def decision_function(self, X) -> np.ndarray:
        """Scores X @ w in float64, as the reference's host matvec."""
        if self.w_ is None:
            raise RuntimeError('fit() first')
        if hasattr(X, 'matvec'):            # data.sparse.CSRMatrix
            return X.matvec(self.w_)
        if torch.is_tensor(X):
            w = torch.as_tensor(self.w_, dtype=torch.float64,
                                device=X.device)
            with full_f32():
                return (X.to(torch.float64) @ w).cpu().numpy()
        if not hasattr(X, '__matmul__'):
            X = np.asarray(X)
        return np.asarray(X @ self.w_).ravel()    # numpy, scipy CSR

    def predict(self, X) -> np.ndarray:
        return self.decision_function(X)

    def scorer(self, **kwargs):
        """A `repro_torch.serve.Scorer` over the fitted weights on this
        estimator's device. Kwargs pass to its constructor (`min_bucket`,
        `donate`). Cached per fitted weight vector when called without
        kwargs; a new fit makes a new one."""
        if self.w_ is None:
            raise RuntimeError('fit() first')
        from ..serve import Scorer
        if kwargs:
            return Scorer(self.w_, device=self.device, **kwargs)
        cached = getattr(self, '_scorer_cache', None)
        if cached is None or cached[0] is not self.w_:
            self._scorer_cache = (self.w_, Scorer(self.w_,
                                                  device=self.device))
        return self._scorer_cache[1]

    def scores(self, X) -> np.ndarray:
        """Candidate scores X @ w in float32 through the serving scorer;
        CSR inputs score through `decision_function` (the serving path
        is dense)."""
        if self.w_ is None:
            raise RuntimeError('fit() first')
        if _rowblocks.is_sparse_input(X) or hasattr(X, 'matvec'):
            return self.decision_function(X)
        return self.scorer().scores(_as_numpy(X, np.float32))

    def top_k(self, X, k: int):
        """The best k candidates by score: `(values, indices)`, ties
        broken lowest index first, as ranking `self.scores(X)` by a stable
        full argsort would; k past the candidate count returns all of
        them, ranked (`repro_torch.serve.Scorer.top_k`)."""
        if self.w_ is None:
            raise RuntimeError('fit() first')
        return self.scorer().top_k(_as_numpy(X, np.float32), k)

    def ranking_error(self, X, y, groups=None) -> float:
        """Pairwise ranking error (paper eq. 1) on held-out data."""
        dev = self.device
        p = torch.as_tensor(self.decision_function(X), dtype=torch.float32,
                            device=dev)
        yt = (y.detach().to(device=dev, dtype=torch.float32)
              if torch.is_tensor(y)
              else torch.as_tensor(np.asarray(y, np.float32), device=dev))
        g = None if groups is None else torch.as_tensor(
            _as_numpy(groups, np.int32), device=dev)
        return float(_rank_loss.ranking_error(p, yt, g))

    def objective(self, X, y, groups=None) -> float:
        """J(w) = R_emp(w) + lam ||w||^2 (`core.oracle.empirical_risk`)."""
        p = self.decision_function(X)
        g = None if groups is None else _as_numpy(groups, np.int32)
        return (empirical_risk(p, y, g, loss=self.loss, device=self.device)
                + self.lam * float(self.w_ @ self.w_))

    # -- internals ---------------------------------------------------------

    def _as_store(self, X, y, groups):
        """(BlockStore, y, groups) of a fit's input. A raw X becomes
        block 0 of a fresh store (wrapped, not copied); a BlockStore
        passes through and carries its own y and groups."""
        if isinstance(X, BlockStore):
            if y is not None or groups is not None:
                raise ValueError('a BlockStore carries its own y/groups; '
                                 'do not pass them separately')
            if not X.block_ids:
                raise ValueError('cannot fit an empty BlockStore')
            return X, X.y, X.groups
        if y is None:
            raise ValueError('y is required (omit it only when X is a '
                             'BlockStore)')
        store = BlockStore()
        store.append(X, y, groups)
        return store, y, groups

    def _partials_fn(self):
        """The `IncrementalFit` revalidation hook: `block_partials` with
        this estimator's engine, loss and device. It holds those values,
        not the estimator: a bound method would close a reference cycle
        (estimator -> handle -> estimator) that keeps a dropped
        estimator's oracle, and its tensors on the card, until the cycle
        collector runs."""
        return functools.partial(block_partials, engine=self.engine,
                                 pair_block=self.pair_block, loss=self.loss,
                                 device=self.device)

    def _ledger_norm(self, oracle) -> int:
        """The normalizer the plane ledger is keyed on: the oracle's
        loss norm (N or N+), or 0 for a loss with no per-block plane
        decomposition, which keeps no ledger (LEDGER_LOSSES)."""
        if self.loss not in LEDGER_LOSSES:
            return 0
        return int(oracle.norm)

    def _device_solvable(self, oracle) -> bool:
        """Would `_solve` run this oracle on the device driver? Mirrors
        `core.bmrm.bmrm`'s dispatch: ledger warm starts are bundle-state
        warm starts, which only the device driver takes."""
        capable = bool(getattr(oracle, 'supports_device_solver', False))
        if self.solver == 'device':
            return capable
        return (self.solver == 'auto' and capable
                and getattr(oracle, 'prefer_device_solver', True)
                and self.eps >= F32_EPS_FLOOR)

    def _make_oracle(self, X, y, groups):
        if isinstance(X, BlockStore):
            # The fused methods need one materialized X; method='auto'
            # keeps a store streaming only when it is disk-backed or
            # projects over the budget, as make_oracle's own rule does.
            if self.method in ('tree', 'pairs') or (
                    self.method == 'auto' and not X.disk_backed and (
                        self.memory_budget is None
                        or _rowblocks.projected_resident_gib(X)
                        <= self.memory_budget)):
                X = X.materialize()
        return make_oracle(X, y, groups=groups, method=self.method,
                           loss=self.loss, engine=self.engine,
                           pair_block=self.pair_block,
                           memory_budget=self.memory_budget,
                           stream_block=self.stream_block,
                           prefetch=self.prefetch, device=self.device,
                           mesh=self.mesh)

    def _solve(self, oracle, state=None, w0=None):
        return bmrm(oracle, lam=self.lam, eps=self.eps,
                    max_iter=self.max_iter, solver=self.solver,
                    max_planes=self.max_planes, sync_every=self.sync_every,
                    qp_iters=self.qp_iters, state=state, w0=w0,
                    callback=(lambda t, w, j, g:
                              print(f'  bmrm it={t} J_best={j:.6f} '
                                    f'gap={g:.2e}'))
                    if self.verbose else None)

    @staticmethod
    def _report(res, seconds) -> FitReport:
        st = res.stats
        return FitReport(
            iterations=st.iterations, converged=st.converged,
            objective=st.obj_best, gap=st.gap, seconds=seconds,
            oracle_seconds_mean=float(np.mean(st.oracle_seconds))
            if st.oracle_seconds else float('nan'),
            loss_history=st.loss_history, solver=st.solver)
