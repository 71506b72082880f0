"""RankSVM estimator: TreeRSVM (the paper's method) and PairRSVM (baseline).

The counterpart of `repro.core.ranksvm.RankSVM` for the slice that is
ported: dense and CSR features, streamed features, the paper's hinge,
methods 'tree', 'pairs', 'auto' and 'stream', both BMRM drivers.
`method=` picks the oracle (`core.oracle.make_oracle`), `engine=` its
counting engine and `solver=` the BMRM driver (`core.bmrm`); the
estimator itself touches no counting internals. The model trains on
`device` (default 'cuda'); without a card that raises unless
device='cpu' is given.

method='sharded', the regularization path and incremental refits are
not ported yet and raise NotImplementedError naming their ROADMAP.md
item. `incremental_` stays None.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..kernels.platform import full_f32, resolve_device
from . import rank_loss as _rank_loss
from .bmrm import SOLVERS, bmrm
from ..data.rowblocks import _validate_prefetch
from .counts import _validate_block_rows, _validate_engine
from .oracle import METHODS, _validate_loss, empirical_risk, make_oracle


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


class RankSVM:
    """Linear RankSVM trained with BMRM.

    Args (as in the reference unless noted):
      lam: regularization weight of J(w) = R_emp(w) + lam ||w||^2.
      eps: BMRM termination gap. Below `core.bmrm.F32_EPS_FLOOR` the
        solver='auto' choice is the float64 host driver.
      method: 'tree' | 'pairs' | 'auto' | 'stream' ('sharded' raises
        NotImplementedError). 'auto' streams when `memory_budget` is set
        and the projected fused residency exceeds it, and always for an
        np.memmap or a row-block source.
      loss: 'hinge' (the other losses raise NotImplementedError).
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
                 loss: str = 'hinge', device=None):
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
        self.device = resolve_device(device)
        self.w_: np.ndarray | None = None
        self.report_: FitReport | None = None
        self.oracle_ = None
        self.incremental_ = None

    # -- public API --------------------------------------------------------

    def fit(self, X, y, groups=None):
        """Learn w from features X (m, n) and utility scores y.

        X is dense (numpy, or torch: a float32 X already on the device is
        used in place), CSR (`data.sparse.CSRMatrix`, scipy, a torch
        sparse tensor), an np.memmap or a `data.rowblocks` row-block
        source; y is numpy or torch."""
        oracle = make_oracle(X, y, groups=groups, method=self.method,
                             loss=self.loss, engine=self.engine,
                             pair_block=self.pair_block,
                             memory_budget=self.memory_budget,
                             stream_block=self.stream_block,
                             prefetch=self.prefetch, device=self.device)
        self.oracle_ = oracle
        t0 = time.perf_counter()
        res = self._solve(oracle)
        dt = time.perf_counter() - t0
        self.w_ = res.w
        self.report_ = self._report(res, dt)
        return self

    def path(self, *args, **kwargs):
        raise NotImplementedError('the regularization path is not ported '
                                  'yet: ROADMAP.md Queue 1 item 8')

    def refit(self, *args, **kwargs):
        raise NotImplementedError('incremental refits are not ported yet: '
                                  'ROADMAP.md Queue 1 item 11')

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

    def ranking_error(self, X, y, groups=None) -> float:
        """Pairwise ranking error (paper eq. 1) on held-out data."""
        dev = self.device
        p = torch.as_tensor(self.decision_function(X), dtype=torch.float32,
                            device=dev)
        yt = (y.detach().to(device=dev, dtype=torch.float32)
              if torch.is_tensor(y)
              else torch.as_tensor(np.asarray(y, np.float32), device=dev))
        g = None if groups is None else torch.as_tensor(
            np.asarray(groups, np.int32), device=dev)
        return float(_rank_loss.ranking_error(p, yt, g))

    def objective(self, X, y, groups=None) -> float:
        """J(w) = R_emp(w) + lam ||w||^2 (`core.oracle.empirical_risk`)."""
        p = self.decision_function(X)
        g = None if groups is None else np.asarray(groups, np.int32)
        return (empirical_risk(p, y, g, loss=self.loss, device=self.device)
                + self.lam * float(self.w_ @ self.w_))

    # -- internals ---------------------------------------------------------

    def _solve(self, oracle):
        return bmrm(oracle, lam=self.lam, eps=self.eps,
                    max_iter=self.max_iter, solver=self.solver,
                    max_planes=self.max_planes, sync_every=self.sync_every,
                    qp_iters=self.qp_iters,
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
