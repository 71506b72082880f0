"""The BMRM oracle layer: one (loss, subgradient) abstraction on the device.

The counterpart of the fused single-device part of `repro.core.oracle`.
Every training path is a `RankOracle`, an object that evaluates

    loss_and_subgrad(w) -> (R_emp(w), a)      a = X^T (c - d) / N   (Lemma 2)

plus what BMRM needs (m, n, the exact pair count N, the device). The
fused oracles keep X, y and every per-iteration vector on their device:
the matvec p = Xw, the counting pass, the loss and the transpose-matvec
run there, and only w goes in and (loss, a) comes out.

This slice ports the dense features, the paper's hinge and the methods
'tree', 'pairs' and 'auto' (with per-query groups). The other methods,
losses and layouts raise NotImplementedError naming their item in
ROADMAP.md.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..kernels.platform import full_f32, resolve_device
from . import counts as _counts

f32 = torch.float32

LOSSES = ('hinge', 'toppush', 'poshinge')
METHODS = ('tree', 'pairs', 'auto', 'sharded', 'stream')

_NOT_PORTED_LOSS = 'ROADMAP.md Queue 1 item 7 (the loss axis)'
_NOT_PORTED_METHOD = {
    'sharded': 'ROADMAP.md Queue 1 item 12 (multi-device)',
    'stream': 'ROADMAP.md Queue 1 item 9 (sparse and out-of-core features)',
}


def _validate_loss(loss: str) -> None:
    """Reject an unknown loss name; a known loss this slice does not
    carry raises NotImplementedError."""
    if loss not in LOSSES:
        raise ValueError(f'unknown loss {loss!r}; expected one of {LOSSES}')
    if loss != 'hinge':
        raise NotImplementedError(
            f'loss={loss!r} is not ported yet: {_NOT_PORTED_LOSS}')


class RankOracle:
    """Interface: per-iteration (loss, subgradient) for BMRM.

    Attributes:
      m, n: examples and features.
      n_pairs: exact number of preference pairs N (host int).
      norm: the loss normalizer (N for the hinge).
      device: the torch device the oracle computes on.
      device_resident: True when `loss_and_subgrad` returns tensors on
        `device`; BMRM then keeps its planes there.
      supports_device_solver: True when `step_fn` gives a step the device
        driver can run.
    """

    name = 'abstract'
    device_resident = False
    supports_device_solver = False
    loss = 'hinge'
    m: int
    n: int
    n_pairs: int
    norm: float
    device: torch.device

    def loss_and_subgrad(self, w):
        raise NotImplementedError

    def step_fn(self):
        raise NotImplementedError(
            f'{type(self).__name__} has no step_fn; use the host driver')


def _exact_pairs(y: np.ndarray, groups) -> int:
    if groups is None:
        return _counts.num_pairs_host(y)
    groups = np.asarray(groups)
    return int(sum(_counts.num_pairs_host(y[groups == u])
                   for u in np.unique(groups)))


def _validate_groups(groups, m: int) -> np.ndarray:
    """Validate group ids; returns them relabelled onto [0, n_groups) as
    int32. NaN or fractional ids would corrupt the key-offset keys with
    no error downstream, and sparse id values would inflate them."""
    g = np.asarray(groups)
    if g.ndim != 1:
        raise ValueError(f'groups must be 1-D (one id per example); got '
                         f'shape {g.shape}')
    if g.shape[0] != m:
        raise ValueError(f'groups has {g.shape[0]} entries but y has {m} '
                         'examples; they must align one-to-one')
    if g.dtype == np.bool_:
        g = g.astype(np.int32)
    if (g.dtype == object or np.issubdtype(g.dtype, np.complexfloating)
            or not np.issubdtype(g.dtype, np.number)):
        raise ValueError(f'groups must be integer ids; got dtype {g.dtype}')
    if np.issubdtype(g.dtype, np.floating):
        if np.isnan(g).any():
            raise ValueError('groups contains NaN; every example needs a '
                             'valid integer group id')
        if np.isinf(g).any():
            raise ValueError('groups contains infinite values; group ids '
                             'must be finite integers')
        if not np.all(g == np.floor(g)):
            raise ValueError('groups contains non-integer values; group '
                             'ids must be (castable to) integers')
    gi = g.astype(np.int64)
    if g.size and not np.array_equal(gi.astype(g.dtype), g):
        raise ValueError('group ids overflow int64; relabel them first '
                         '(e.g. np.unique(groups, return_inverse=True))')
    return np.unique(gi, return_inverse=True)[1].astype(np.int32)


def _warn_group_key_scale(groups: np.ndarray, y: np.ndarray, tol: float,
                          stacklevel: int = 4) -> None:
    """Warn when the float32 key offsets of grouped counting may round by
    more than `tol` margin units."""
    if not groups.size:
        return
    n_groups = int(groups.max()) + 1
    key_scale = n_groups * (float(y.max() - y.min()) + 3.5)
    ulp = key_scale * 2.0 ** -23
    if ulp > tol:
        warnings.warn(
            f'{n_groups} groups with y-range {float(y.max() - y.min()):.3g}'
            ' push the f32 key-offset keys of grouped counting to a scale '
            f'where one ulp (~{ulp:.1e} margin units) exceeds this '
            f'oracle\'s ~{tol:g} tolerance; counts and subgradients will be '
            'quietly inaccurate. Shrink the y range or split the fit into '
            'fewer-query shards (core.counts._group_offsets).',
            RuntimeWarning, stacklevel=stacklevel)


def _is_sparse(X) -> bool:
    if hasattr(X, 'data') and hasattr(X, 'indices') and hasattr(X, 'indptr'):
        return True
    return torch.is_tensor(X) and X.layout != torch.strided


def _as_numpy(a, dtype) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


class _DenseFeatures:
    """Row-major dense X in float32 on the device; both matvecs are gemv."""

    def __init__(self, X, device: torch.device):
        if _is_sparse(X):
            raise NotImplementedError(
                'sparse (CSR) features are not ported yet: ROADMAP.md '
                'Queue 1 item 9 (sparse and out-of-core features)')
        if torch.is_tensor(X):
            Xt = X.detach().to(device=device, dtype=f32)
        else:
            Xt = torch.as_tensor(np.asarray(X, np.float32), device=device)
        if Xt.dim() != 2:
            raise ValueError(f'X must be 2-D; got shape {tuple(Xt.shape)}')
        self.X = Xt.contiguous()
        self.m, self.n = map(int, self.X.shape)


def _loss_and_coeffs(p, count, inv_n):
    """Scores -> (R_emp, subgradient coefficients c - d) for the hinge:
    one counting pass (`count`, a `counts.make_counter` counter) and the
    Lemma 1/2 formula."""
    c, d = count(p)
    cd = (c - d).to(f32)
    return (cd * p + c.to(f32)).sum() * inv_n, cd


def _fused_step_impl(w, X, count, inv_n):
    """The fused step: matvec -> counts -> loss -> subgradient."""
    p = X @ w
    loss_val, cd = _loss_and_coeffs(p, count, inv_n)
    return loss_val, X.T @ (cd * inv_n)


class _FusedOracle(RankOracle):
    """Shared machinery of the fused oracles. Subclasses pick the counting
    engine ('tree' | 'blocked' | 'pallas' | 'auto') through `_engine`; an
    explicit `engine=` overrides it."""

    device_resident = True
    supports_device_solver = True
    _engine = 'tree'
    _block = 0          # only the blocked engine reads it
    _count = None       # the counter, made at the first step_fn

    def __init__(self, X, y, groups=None, engine: str | None = None,
                 engine_block: int = 2048, loss: str = 'hinge',
                 device=None):
        _validate_loss(loss)
        self.loss = loss
        self.device = resolve_device(device)
        if engine is not None:
            _counts._validate_engine(engine)
            self._engine = engine
            self.name = f'{self.name}[{engine}]'
        y = _as_numpy(y, np.float32)
        self._feats = _DenseFeatures(X, self.device)
        self.m, self.n = self._feats.m, self._feats.n
        if y.shape[0] != self.m:
            raise ValueError(f'X has {self.m} rows but y has {y.shape[0]}')
        if groups is not None:
            groups = _validate_groups(_as_numpy(groups, None), self.m)
            _warn_group_key_scale(groups, y, tol=1e-3, stacklevel=4)
        self.n_pairs = _exact_pairs(y, groups)
        if self.n_pairs == 0:
            raise ValueError('training data induces no preference pairs')
        self._y = torch.as_tensor(y, device=self.device)
        self._g = (None if groups is None
                   else torch.as_tensor(groups, device=self.device))
        self.norm = float(self.n_pairs)
        self._inv_n = 1.0 / self.norm
        self._inv_n_dev = torch.tensor(self._inv_n, dtype=f32,
                                       device=self.device)
        if engine is not None:
            self._block = (min(_counts._validate_block_rows(
                engine_block, 'engine block'), self.m)
                if engine == 'blocked' else 0)

    def loss_and_subgrad(self, w):
        """(R_emp(w), a) as tensors on the oracle's device."""
        w = torch.as_tensor(w if torch.is_tensor(w) else np.asarray(w),
                            dtype=f32, device=self.device)
        with full_f32():
            return self.step_fn()(w)

    def step_fn(self):
        """`w -> (loss, a)` on the device, for the BMRM drivers. The
        counter is made once per oracle: y is fixed, so its rank
        compression and level guard are not redone per step."""
        if self._count is None:
            self._count = _counts.make_counter(self._y, self._g,
                                               engine=self._engine,
                                               block=self._block)
        X, count, inv_n = self._feats.X, self._count, self._inv_n_dev

        def fn(w):
            return _fused_step_impl(w, X, count, inv_n)

        return fn


class TreeOracle(_FusedOracle):
    """The paper's method: merge-sort-tree counts, O(ms + m log^2 m)/iter."""

    name = 'tree'
    _engine = 'tree'


class PairwiseOracle(_FusedOracle):
    """O(m^2) counting: the blocked pass (PairRSVM baseline) or, with
    dispatch='auto', `kernels.pairwise_rank.counts_auto`."""

    def __init__(self, X, y, groups=None, block: int = 2048,
                 dispatch: str = 'blocked', engine: str | None = None,
                 loss: str = 'hinge', device=None):
        if dispatch not in ('blocked', 'auto'):
            raise ValueError(f'unknown dispatch {dispatch!r}')
        block = _counts._validate_block_rows(block, 'PairwiseOracle block')
        self._engine = 'blocked' if dispatch == 'blocked' else 'auto'
        self.name = 'pairs' if dispatch == 'blocked' else 'auto'
        super().__init__(X, y, groups=groups, engine=engine,
                         engine_block=block, loss=loss, device=device)
        if engine is None:
            self._block = min(block, self.m) if dispatch == 'blocked' else 0


class GroupedOracle(_FusedOracle):
    """Per-query LTR: within-group pairs only, still one pass through the
    key-offset trick. `inner` picks the counting engine."""

    name = 'grouped'

    def __init__(self, X, y, groups, inner: str = 'tree', block: int = 2048,
                 engine: str | None = None, loss: str = 'hinge',
                 device=None):
        if groups is None:
            raise ValueError('GroupedOracle requires group ids')
        if inner not in ('tree', 'pairs', 'auto'):
            raise ValueError(f'unknown inner oracle {inner!r}')
        block = _counts._validate_block_rows(block, 'GroupedOracle block')
        self._engine = {'tree': 'tree', 'pairs': 'blocked',
                        'auto': 'auto'}[inner]
        self.name = f'grouped/{inner}'
        super().__init__(X, y, groups=groups, engine=engine,
                         engine_block=block, loss=loss, device=device)
        if engine is None:
            self._block = min(block, self.m) if inner == 'pairs' else 0


def make_oracle(X, y, groups=None, method: str = 'tree', *,
                loss: str = 'hinge', engine: str | None = None,
                pair_block: int = 2048, device=None) -> RankOracle:
    """Build the RankOracle for (X, y[, groups]) selected by `method`.

      method   oracle           counting engine (overridable by engine=)
      'tree'   TreeOracle       merge-sort tree
      'pairs'  PairwiseOracle   blocked O(m^2)
      'auto'   PairwiseOracle   counts_auto: on the card the pairwise
                                kernel to KERNEL_MAX_M examples,
                                rank-counts above; the tree elsewhere

    `groups=` routes all three through GroupedOracle with the same
    engine. `engine=` is one of `counts.ENGINES`; 'pallas' is the
    rank-counts kernel. `device` defaults to 'cuda'."""
    if method not in METHODS:
        raise ValueError(f'unknown oracle method {method!r}; '
                         f'expected one of {METHODS}')
    _validate_loss(loss)
    if method in _NOT_PORTED_METHOD:
        raise NotImplementedError(f'method={method!r} is not ported yet: '
                                  f'{_NOT_PORTED_METHOD[method]}')
    if engine is not None:
        _counts._validate_engine(engine)
    if groups is not None:
        return GroupedOracle(X, y, groups, inner=method, block=pair_block,
                             engine=engine, loss=loss, device=device)
    if method == 'tree':
        return TreeOracle(X, y, engine=engine, engine_block=pair_block,
                          loss=loss, device=device)
    return PairwiseOracle(
        X, y, block=pair_block,
        dispatch='auto' if method == 'auto' else 'blocked',
        engine=engine, loss=loss, device=device)


def empirical_risk(scores, utilities, groups=None, loss: str = 'hinge',
                   device=None) -> float:
    """R_emp for precomputed scores: the mean pairwise hinge over the N
    preference pairs, through the tree. Returns a host float; 0.0 when
    the data induces no preference pairs."""
    _validate_loss(loss)
    dev = resolve_device(device)
    y = _as_numpy(utilities, np.float32)
    if groups is not None:
        groups = _validate_groups(_as_numpy(groups, None), y.shape[0])
    norm = _exact_pairs(y, groups)
    if norm == 0:
        return 0.0
    p = (scores.detach().to(device=dev, dtype=f32) if torch.is_tensor(scores)
         else torch.as_tensor(np.asarray(scores, np.float32), device=dev))
    g = None if groups is None else torch.as_tensor(groups, device=dev)
    count = _counts.make_counter(torch.as_tensor(y, device=dev), g)
    val, _ = _loss_and_coeffs(p, count, torch.tensor(1.0 / float(norm),
                                                     dtype=f32, device=dev))
    return float(val)
