"""The BMRM oracle layer: one (loss, subgradient) abstraction on the device.

The counterpart of the single-device part of `repro.core.oracle`. Every
training path is a `RankOracle`, an object that evaluates

    loss_and_subgrad(w) -> (R_emp(w), a)      a = X^T (c - d) / N   (Lemma 2)

plus what BMRM needs (m, n, the exact pair count N, the device). The
fused oracles keep X, y and every per-iteration vector on their device:
the matvec p = Xw, the counting pass, the loss and the transpose-matvec
run there, and only w goes in and (loss, a) comes out. X is dense
(`_DenseFeatures`) or CSR (`_CSRFeatures`: a gather matvec, and a
transpose-matvec on the device or, with csr_rmatvec='host', through
scipy's CSR loops on the host).

`StreamingOracle` (method='stream', or 'auto' over a memory budget)
keeps only O(m) vectors on the device and streams the features through
two chunked passes over a row-block source (`data.rowblocks`, DESIGN.md
§6); the counting pass between them runs on the device.

The paper's hinge is ported; the other losses raise NotImplementedError
naming their ROADMAP.md item, as does method='sharded'.
"""

from __future__ import annotations

import functools
import warnings

import numpy as np
import torch

from ..data import rowblocks as _rowblocks
from ..data.rowblocks import (_validate_block_rows, _validate_prefetch,
                              resolve_prefetch)
from ..kernels.platform import full_f32, resolve_device
from . import counts as _counts

f32 = torch.float32

LOSSES = ('hinge', 'toppush', 'poshinge')
METHODS = ('tree', 'pairs', 'auto', 'sharded', 'stream')

_NOT_PORTED_LOSS = 'ROADMAP.md Queue 1 item 7 (the loss axis)'
_NOT_PORTED_METHOD = {
    'sharded': 'ROADMAP.md Queue 1 item 12 (multi-device)',
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
      prefer_device_solver: the bmrm solver='auto' hint, True when the
        device driver suits this oracle's layout. False for CSR features
        whose transpose-matvec runs on the host (the device driver would
        force it onto the device) and for streamed CSR sources (its step
        densifies a slab per block, the host passes stay sparse).
    """

    name = 'abstract'
    device_resident = False
    supports_device_solver = False
    prefer_device_solver = False
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


def _as_numpy(a, dtype) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


# Replicas of the transpose-matvec's accumulator: row r adds into replica
# r % R, so a column that many rows share (tf-idf's common terms) takes R
# times fewer atomic adds on one address.
RMATVEC_REPLICAS = 64
# Nonzeros per chunk of the CSR products. A chunk's temporaries (about 24
# bytes a nonzero in the transpose-matvec) stay near 50 MB at any size, so
# a fused CSR oracle holds its features, 8 bytes a nonzero (12 with ragged
# rows) as `data.rowblocks.projected_resident_gib` charges, plus O(m + n).
CSR_CHUNK_NNZ = 2**21


class _ExactSum:
    """out[j] = the sum of the values added at index j (mod `size`),
    bit-reproducible on any device and in any order of summation.

    A CUDA `index_add_` adds floats through atomics, whose order, and so
    whose rounding, varies from run to run. Here a value added at j is
    rounded once to a multiple of 2^(e_j - 51), where bound[j] < 2^e_j
    bounds the sum of |values| added at j, and the multiples are added as
    float64 integers: every partial sum is an integer below 2^51 + nnz/2
    < 2^53, so each addition, the final sum over the `replicas` copies of
    the output included, is exact and the result does not depend on the
    order. Each value moves by at most 2^-52 of 2 * bound[j], its own
    output's bound, so a small output keeps its own precision. `bound` is
    a (size,) float64 tensor on the device (no read-back); an index
    addresses replica index // size."""

    def __init__(self, bound, replicas: int = 1):
        _, e = torch.frexp(bound)
        # 2^(51 - e), built from its float64 bits: exact for any e.
        self.scale = ((1074 - e.to(torch.int64)) << 52).view(torch.float64)
        self.size, self.replicas = bound.numel(), replicas
        self.acc = torch.zeros(replicas * self.size, dtype=torch.float64,
                               device=bound.device)

    def add(self, vals, index) -> None:
        q = (vals * self.scale[index % self.size]).round_()
        self.acc.index_add_(0, index, q)

    def result(self):
        """The sums as float32."""
        return self.acc.view(self.replicas, self.size).sum(dim=0).div_(
            self.scale).to(f32)


class _DenseFeatures:
    """Row-major dense X in float32 on the device; both matvecs are gemv."""

    kind = 'dense'
    device_rmatvec = True

    def __init__(self, X, device: torch.device):
        if torch.is_tensor(X):
            Xt = X.detach().to(device=device, dtype=f32)
        else:
            Xt = torch.as_tensor(np.asarray(X, np.float32), device=device)
        if Xt.dim() != 2:
            raise ValueError(f'X must be 2-D; got shape {tuple(Xt.shape)}')
        self.X = Xt.contiguous()
        self.m, self.n = map(int, self.X.shape)

    def matvec(self, w):
        return self.X @ w

    def rmatvec(self, v):
        return self.X.T @ v


class _CSRFeatures:
    """CSR X on the device: float32 values and int32 accumulator slots,
    8 bytes a nonzero, plus int32 row ids when rows are ragged; column j
    of row r sits in slot (r % R) * n + j (R = `RMATVEC_REPLICAS`), and
    j = slot % n. Both products run over row chunks of about
    `CSR_CHUNK_NNZ` nonzeros. The forward matvec gathers: a dense (rows,
    s) gather and row sum when every row has the same nnz s (the tf-idf
    layout), else an exact segment sum over the row ids. The
    transpose-matvec runs on the device, float32 products summed in
    exact fixed point per column (`_ExactSum`, bit-reproducible where a
    float scatter-add is not), or, with csr_rmatvec='host', through
    scipy's CSR loops over the host copy. 'auto' takes the host on a CPU
    device, as the reference takes it on its CPU backend, and the device
    elsewhere."""

    kind = 'csr'

    def __init__(self, X, device: torch.device, csr_rmatvec: str = 'auto'):
        if csr_rmatvec == 'auto':
            csr_rmatvec = 'host' if device.type == 'cpu' else 'device'
        if csr_rmatvec not in ('host', 'device'):
            raise ValueError(f'unknown csr_rmatvec {csr_rmatvec!r}')
        self.device_rmatvec = csr_rmatvec == 'device'
        X = _rowblocks.as_csr_matrix(X)
        self._host = X
        self.m, self.n = map(int, X.shape)
        data = np.asarray(X.data, np.float32)
        indices = np.asarray(X.indices, np.int32)
        indptr = np.asarray(X.indptr, np.int64)
        lens = np.diff(indptr)
        self._uniform = bool(self.m > 0 and np.all(lens == lens[0])
                             and lens[0] > 0)
        self._replicas = max(1, min(RMATVEC_REPLICAS, self.m,
                                    (2**31 - 1) // max(self.n, 1)))
        slot = (indices + (X._rows % self._replicas) * self.n).astype(
            np.int32)
        if self._uniform:
            s = int(lens[0])
            self.data = torch.as_tensor(data.reshape(self.m, s),
                                        device=device)
            self.slot = torch.as_tensor(slot.reshape(self.m, s),
                                        device=device)
            self.rows = None
            step = max(1, CSR_CHUNK_NNZ // s)
            self._chunks = [(r0, min(r0 + step, self.m))
                            for r0 in range(0, self.m, step)]
        else:
            self.data = torch.as_tensor(data, device=device)
            self.slot = torch.as_tensor(slot, device=device)
            self.rows = torch.as_tensor(X._rows.astype(np.int32),
                                        device=device)
            # Nonzero ranges of whole rows, at most CSR_CHUNK_NNZ each (a
            # longer row alone).
            self._chunks, r0 = [], 0
            while r0 < self.m:
                r1 = int(np.searchsorted(indptr, indptr[r0] + CSR_CHUNK_NNZ,
                                         side='right')) - 1
                r1 = min(max(r1, r0 + 1), self.m)
                self._chunks.append((int(indptr[r0]), int(indptr[r1])))
                r0 = r1
        # Bounds of the exact sums: the row and column sums of |X| (of the
        # float32 values the device holds).
        absd = np.abs(data.astype(np.float64))
        self._row_abs = (None if self._uniform else torch.as_tensor(
            np.bincount(X._rows, absd, minlength=self.m), device=device))
        self._col_abs = torch.as_tensor(
            np.bincount(indices, absd, minlength=self.n), device=device)

    def matvec(self, w):
        n = self.n
        if self._uniform:
            out = torch.empty(self.m, dtype=f32, device=w.device)
            for r0, r1 in self._chunks:
                out[r0:r1] = (self.data[r0:r1]
                              * w[self.slot[r0:r1] % n]).sum(dim=1)
            return out
        acc = _ExactSum(self._row_abs * w.abs().max())
        for k0, k1 in self._chunks:
            acc.add(self.data[k0:k1] * w[self.slot[k0:k1] % n],
                    self.rows[k0:k1])
        return acc.result()

    def rmatvec(self, v):
        acc = _ExactSum(self._col_abs * v.abs().max(), self._replicas)
        if self._uniform:
            for r0, r1 in self._chunks:
                acc.add((self.data[r0:r1] * v[r0:r1, None]).view(-1),
                        self.slot[r0:r1].view(-1))
        else:
            for k0, k1 in self._chunks:
                acc.add(self.data[k0:k1] * v[self.rows[k0:k1]],
                        self.slot[k0:k1])
        return acc.result()

    def rmatvec_host(self, v: np.ndarray) -> np.ndarray:
        return self._host.rmatvec(v)


def _features(X, device: torch.device, csr_rmatvec: str = 'auto'):
    if _rowblocks.is_sparse_input(X):
        return _CSRFeatures(X, device, csr_rmatvec=csr_rmatvec)
    return _DenseFeatures(X, device)


def _loss_and_coeffs(p, count, inv_n):
    """Scores -> (R_emp, subgradient coefficients c - d) for the hinge:
    one counting pass (`count`, a `counts.make_counter` counter) and the
    Lemma 1/2 formula."""
    c, d = count(p)
    cd = (c - d).to(f32)
    return (cd * p + c.to(f32)).sum() * inv_n, cd


def _fused_step_impl(w, feats, count, inv_n):
    """The fused step: matvec -> counts -> loss -> subgradient."""
    p = feats.matvec(w)
    loss_val, cd = _loss_and_coeffs(p, count, inv_n)
    del p
    return loss_val, feats.rmatvec(cd * inv_n)


class _FusedOracle(RankOracle):
    """Shared machinery of the fused oracles. Subclasses pick the counting
    engine ('tree' | 'blocked' | 'pallas' | 'auto') through `_engine`; an
    explicit `engine=` overrides it."""

    device_resident = True
    supports_device_solver = True
    _engine = 'tree'
    _block = 0          # only the blocked engine reads it
    _count = None       # the counter, made at the first step_fn

    def __init__(self, X, y, groups=None, csr_rmatvec: str = 'auto',
                 engine: str | None = None, engine_block: int = 2048,
                 loss: str = 'hinge', device=None):
        _validate_loss(loss)
        self.loss = loss
        self.device = resolve_device(device)
        if engine is not None:
            _counts._validate_engine(engine)
            self._engine = engine
            self.name = f'{self.name}[{engine}]'
        y = _as_numpy(y, np.float32)
        self._feats = _features(X, self.device, csr_rmatvec=csr_rmatvec)
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
        # A host transpose-matvec (csr_rmatvec='host') would be forced
        # onto the device by the device driver; solver='auto' then keeps
        # the host driver.
        self.prefer_device_solver = bool(self._feats.device_rmatvec)

    def _counter(self):
        """The counter, made once per oracle: y is fixed, so its rank
        compression and level guard are not redone per step."""
        if self._count is None:
            self._count = _counts.make_counter(self._y, self._g,
                                               engine=self._engine,
                                               block=self._block)
        return self._count

    def loss_and_subgrad(self, w):
        """(R_emp(w), a): tensors on the oracle's device, or, with a host
        transpose-matvec, the loss on the device and a as float64 numpy."""
        w = torch.as_tensor(w if torch.is_tensor(w) else np.asarray(w),
                            dtype=f32, device=self.device)
        feats = self._feats
        with full_f32():
            if feats.device_rmatvec:
                return self.step_fn()(w)
            loss, cd = _loss_and_coeffs(feats.matvec(w), self._counter(),
                                        self._inv_n_dev)
        return loss, feats.rmatvec_host(
            cd.cpu().numpy().astype(np.float64) * self._inv_n)

    def step_fn(self):
        """`w -> (loss, a)` on the device, for the BMRM drivers. It always
        finishes the transpose-matvec on the device: the device driver has
        no host to hand c - d to."""
        feats, count, inv_n = self._feats, self._counter(), self._inv_n_dev

        def fn(w):
            return _fused_step_impl(w, feats, count, inv_n)

        return fn


class TreeOracle(_FusedOracle):
    """The paper's method: merge-sort-tree counts, O(ms + m log^2 m)/iter."""

    name = 'tree'
    _engine = 'tree'


class PairwiseOracle(_FusedOracle):
    """O(m^2) counting: the blocked pass (PairRSVM baseline) or, with
    dispatch='auto', `kernels.pairwise_rank.counts_auto`."""

    def __init__(self, X, y, groups=None, block: int = 2048,
                 dispatch: str = 'blocked', csr_rmatvec: str = 'auto',
                 engine: str | None = None, loss: str = 'hinge',
                 device=None):
        if dispatch not in ('blocked', 'auto'):
            raise ValueError(f'unknown dispatch {dispatch!r}')
        block = _counts._validate_block_rows(block, 'PairwiseOracle block')
        self._engine = 'blocked' if dispatch == 'blocked' else 'auto'
        self.name = 'pairs' if dispatch == 'blocked' else 'auto'
        super().__init__(X, y, groups=groups, csr_rmatvec=csr_rmatvec,
                         engine=engine, engine_block=block, loss=loss,
                         device=device)
        if engine is None:
            self._block = min(block, self.m) if dispatch == 'blocked' else 0


class GroupedOracle(_FusedOracle):
    """Per-query LTR: within-group pairs only, still one pass through the
    key-offset trick. `inner` picks the counting engine."""

    name = 'grouped'

    def __init__(self, X, y, groups, inner: str = 'tree', block: int = 2048,
                 csr_rmatvec: str = 'auto', engine: str | None = None,
                 loss: str = 'hinge', device=None):
        if groups is None:
            raise ValueError('GroupedOracle requires group ids')
        if inner not in ('tree', 'pairs', 'auto'):
            raise ValueError(f'unknown inner oracle {inner!r}')
        block = _counts._validate_block_rows(block, 'GroupedOracle block')
        self._engine = {'tree': 'tree', 'pairs': 'blocked',
                        'auto': 'auto'}[inner]
        self.name = f'grouped/{inner}'
        super().__init__(X, y, groups=groups, csr_rmatvec=csr_rmatvec,
                         engine=engine, engine_block=block, loss=loss,
                         device=device)
        if engine is None:
            self._block = min(block, self.m) if inner == 'pairs' else 0


# ------------------------------------------------------- streaming oracle


DEFAULT_STREAM_BLOCK = 8192


def _fetch_padded(src, B: int, m: int, n: int, i) -> np.ndarray:
    """Block i of `src` as a dense f32 (B, n) slab, zero-row padded at the
    ragged tail (pad rows score 0 and receive v = 0, so they never
    contribute; the score slice drops them before counting). Module
    level, so that `StreamingOracle.step_fn` closes over (src, B, m, n)
    and not over the oracle."""
    i = int(i)
    lo = i * B
    hi = min(lo + B, m)
    blk = np.asarray(src.block(lo, hi), np.float32)
    if hi - lo < B:
        blk = np.concatenate([blk, np.zeros((B - (hi - lo), n),
                                            np.float32)])
    return blk


def _auto_stream_block(m: int, row_bytes: int, memory_budget) -> int:
    """Rows per block from a GiB budget: reserve the O(m) per-example
    vectors (~6 f32 scalars each: p, y, c, d, c-d, v), spend at most half
    the remainder on the resident blocks; the other half stays headroom
    for the counting pass's temporaries. `row_bytes` is the source's
    layout-native per-row cost (`RowBlockSource.row_bytes`), times the
    blocks in flight."""
    if memory_budget is None:
        return max(1, min(DEFAULT_STREAM_BLOCK, max(m, 1)))
    budget = float(memory_budget) * 2**30
    overhead = 6 * 4 * m
    if budget <= overhead:
        warnings.warn(
            f'memory_budget={memory_budget:g} GiB cannot even hold the '
            f'mandatory O(m) score/coefficient vectors '
            f'(~{overhead / 2**30:.3g} GiB at m={m}); streaming will run '
            'with 1-row blocks, which is almost certainly not what you '
            'want: raise the budget or pass stream_block explicitly.',
            RuntimeWarning, stacklevel=3)
        return 1
    b = int((budget - overhead) * 0.5 // max(row_bytes, 1))
    return max(1, min(b, max(m, 1)))


class StreamingOracle(RankOracle):
    """Out-of-core oracle: two chunked passes over a `RowBlockSource`.

    The subgradient needs only O(m) scalars resident, the score vector
    and the pair-count coefficients, so the features never have to be.
    Each call is:

      pass 1  p = X w, block by block
      counts  one global counting pass on the device over the full score
              vector (`_loss_and_coeffs` with the oracle's engine; the
              default 'auto' tiers as the fused oracles do)
      pass 2  a = sum over blocks of X_block^T v_block, v = (c - d) / N

    Features can live in RAM, in CSR or in an `np.memmap` on disk
    (`data.rowblocks`). `prefetch=` (blocks of read-ahead; None/'auto'
    double-buffers memmap sources and stays synchronous otherwise)
    overlaps the next block's fetch with the current block's product on
    both surfaces; results are bit-identical at any depth for a given
    block size.

    Two surfaces, same math:
      * `loss_and_subgrad`: host passes (float64 numpy per-block
        products, sparse for CSR), counting on the device; what holds on
        the device is O(m) vectors and the counting pass's temporaries.
      * `step_fn`: the device driver's step, the same two passes as a
        Python loop that copies one padded dense slab at a time to the
        device and multiplies it there; each slab is dropped before the
        next is fetched and before the counting pass.

    `memory_budget` (GiB) sizes the blocks (`_auto_stream_block`), with
    the read-ahead's in-flight blocks counted against it.
    """

    name = 'stream'
    device_resident = False
    supports_device_solver = True
    prefer_device_solver = True

    def __init__(self, X, y, groups=None, block_rows: int | None = None,
                 memory_budget: float | None = None, engine: str = 'auto',
                 prefetch=None, loss: str = 'hinge', device=None):
        _validate_loss(loss)
        self.loss = loss
        _counts._validate_engine(engine)
        self._engine = engine
        self._cblock = 2048 if engine == 'blocked' else 0
        self.device = resolve_device(device)
        y = _as_numpy(y, np.float32)
        self._src = _rowblocks.as_row_block_source(X)
        self._prefetch = resolve_prefetch(self._src, prefetch)
        self.m, self.n = self._src.m, self._src.n
        if y.shape[0] != self.m:
            raise ValueError(f'X has {self.m} rows but y has {y.shape[0]}')
        if groups is not None:
            groups = _validate_groups(_as_numpy(groups, None), self.m)
            _warn_group_key_scale(groups, y, tol=1e-3, stacklevel=3)
        self.n_pairs = _exact_pairs(y, groups)
        if self.n_pairs == 0:
            raise ValueError('training data induces no preference pairs')
        if block_rows is None:
            # In-flight read-ahead blocks count against the budget: depth
            # pending + 1 being consumed.
            block_rows = _auto_stream_block(
                self.m, self._src.row_bytes() * (1 + self._prefetch),
                memory_budget)
        block_rows = _validate_block_rows(block_rows,
                                          'StreamingOracle block_rows')
        self._B = min(block_rows, self.m)
        self._nblk = self._src.n_blocks(self._B)
        self._y = torch.as_tensor(y, device=self.device)
        self._g = (None if groups is None
                   else torch.as_tensor(groups, device=self.device))
        self.norm = float(self.n_pairs)
        self._inv_n = 1.0 / self.norm
        self._inv_n_dev = torch.tensor(self._inv_n, dtype=f32,
                                       device=self.device)
        self._count = None
        self.name = f'stream/{self._src.kind}'
        # The device step densifies one (block, n) slab per fetch; for
        # CSR sources the host passes stay sparse, so solver='auto' keeps
        # them on the host driver.
        self.prefer_device_solver = self._src.kind != 'csr'

    @property
    def block_rows(self) -> int:
        return self._B

    @property
    def prefetch(self) -> int:
        """Resolved read-ahead depth (0 = synchronous fetches)."""
        return self._prefetch

    def block_resident_bytes(self) -> int:
        """Peak feature bytes resident at any point of a pass, at the
        source's layout-native per-row cost (dense f32 slab; O(nnz_row)
        for CSR), counting the read-ahead's in-flight blocks (`prefetch`
        pending + 1 consumed); the O(m) vectors come on top. Forcing
        solver='device' on a CSR source densifies each slab to
        block_rows * n * 4 bytes instead."""
        return (1 + self._prefetch) * self._B * self._src.row_bytes()

    def _counter(self):
        if self._count is None:
            self._count = _counts.make_counter(self._y, self._g,
                                               engine=self._engine,
                                               block=self._cblock)
        return self._count

    def loss_and_subgrad(self, w):
        """(R_emp(w), a): the loss as a device scalar, a as float64
        numpy."""
        src, B, depth = self._src, self._B, self._prefetch
        w64 = _as_numpy(w, np.float64)
        p = np.empty(self.m, np.float32)
        for lo, hi, payload in src.iter_payloads(B, prefetch=depth):
            p[lo:hi] = src._payload_matvec(payload, w64)
        with full_f32():
            loss, cd = _loss_and_coeffs(
                torch.as_tensor(p, device=self.device), self._counter(),
                self._inv_n_dev)
        v = cd.cpu().numpy().astype(np.float64) * self._inv_n
        del cd
        a = np.zeros(self.n, np.float64)
        for lo, hi, payload in src.iter_payloads(B, prefetch=depth):
            a += src._payload_rmatvec(payload, v[lo:hi])
        return loss, a

    def step_fn(self):
        """`w -> (loss, a)` on the device, for the device driver: each
        pass fetches the padded dense slabs (through a wraparound
        `_ReadAhead` when prefetching: the last block of the score pass
        warms block 0 of the gradient pass) and copies them to the device
        one at a time. The closure holds locals only, never the oracle."""
        B, n, m, nblk = self._B, self.n, self.m, self._nblk
        dev, count, inv_n = self.device, self._counter(), self._inv_n_dev
        fetch = functools.partial(_fetch_padded, self._src, B, m, n)
        if self._prefetch and nblk > 1:
            # get(i) is exact for any access order (a miss fetches
            # synchronously), so correctness never leans on the order.
            fetch = _rowblocks._ReadAhead(fetch, nblk, self._prefetch,
                                          wrap=True).get

        def fn(w):
            w = w.to(device=dev, dtype=f32)
            p = torch.empty(nblk * B, dtype=f32, device=dev)
            for i in range(nblk):
                blk = torch.from_numpy(fetch(i)).to(dev)
                p[i * B:(i + 1) * B] = blk @ w
                del blk
            loss, cd = _loss_and_coeffs(p[:m], count, inv_n)
            v = torch.zeros(nblk * B, dtype=f32, device=dev)
            v[:m] = cd * inv_n
            del p, cd
            a = torch.zeros(n, dtype=f32, device=dev)
            for i in range(nblk):
                blk = torch.from_numpy(fetch(i)).to(dev)
                a += blk.T @ v[i * B:(i + 1) * B]
                del blk
            return loss, a

        return fn


def make_oracle(X, y, groups=None, method: str = 'tree', *,
                loss: str = 'hinge', engine: str | None = None,
                pair_block: int = 2048, csr_rmatvec: str = 'auto',
                memory_budget: float | None = None,
                stream_block: int | None = None, prefetch=None,
                device=None) -> RankOracle:
    """Build the RankOracle for (X, y[, groups]) selected by `method`.

      method    oracle            features resident    counting engine
                                                       (engine= overrides)
      'tree'    TreeOracle        all of X             merge-sort tree
      'pairs'   PairwiseOracle    all of X             blocked O(m^2)
      'auto'    PairwiseOracle    all of X             counts_auto: on the
                or StreamingOracle (budget rule)       card the pairwise
                                                       kernel to
                                                       KERNEL_MAX_M
                                                       examples,
                                                       rank-counts above;
                                                       the tree elsewhere
      'stream'  StreamingOracle   one block + O(m)     'auto'

    X is dense (numpy, torch), CSR (`data.sparse.CSRMatrix`, scipy, a
    torch sparse tensor), an `np.memmap` or a `data.rowblocks`
    `RowBlockSource`. `groups=` routes the first three through
    GroupedOracle with the same engine, and works natively on 'stream'.
    `engine=` is one of `counts.ENGINES`; 'pallas' is the rank-counts
    kernel. `csr_rmatvec` ('auto' | 'host' | 'device') places a fused
    CSR oracle's transpose-matvec. `device` defaults to 'cuda'.

    method='auto' streams when the projected fused residency
    (`data.rowblocks.projected_resident_gib`) exceeds `memory_budget`
    GiB, and always for an `np.memmap` or a `RowBlockSource`; otherwise
    it keeps the fused counts_auto oracle. `stream_block` (rows) defaults
    to the budget-derived size (`_auto_stream_block`); `prefetch`
    (None/'auto' | int >= 0) is the streaming oracle's read-ahead depth
    and is ignored by the fused oracles."""
    if method not in METHODS:
        raise ValueError(f'unknown oracle method {method!r}; '
                         f'expected one of {METHODS}')
    _validate_loss(loss)
    if method in _NOT_PORTED_METHOD:
        raise NotImplementedError(f'method={method!r} is not ported yet: '
                                  f'{_NOT_PORTED_METHOD[method]}')
    if engine is not None:
        _counts._validate_engine(engine)
    _validate_prefetch(prefetch)
    stream_only = isinstance(X, (_rowblocks.RowBlockSource, np.memmap))
    if method == 'auto' and not stream_only and memory_budget is not None:
        if _rowblocks.projected_resident_gib(X) > float(memory_budget):
            method = 'stream'
    if method == 'stream' or (method == 'auto' and stream_only):
        return StreamingOracle(X, y, groups=groups, block_rows=stream_block,
                               memory_budget=memory_budget,
                               engine=engine if engine is not None
                               else 'auto', prefetch=prefetch, loss=loss,
                               device=device)
    if isinstance(X, _rowblocks.RowBlockSource):
        raise ValueError(
            f"method={method!r} needs materialized features, but X is a "
            f'{type(X).__name__} row-block source; train it with '
            "method='stream' (or 'auto', which streams such sources)")
    if groups is not None:
        return GroupedOracle(X, y, groups, inner=method, block=pair_block,
                             csr_rmatvec=csr_rmatvec, engine=engine,
                             loss=loss, device=device)
    if method == 'tree':
        return TreeOracle(X, y, csr_rmatvec=csr_rmatvec, engine=engine,
                          engine_block=pair_block, loss=loss, device=device)
    return PairwiseOracle(
        X, y, block=pair_block,
        dispatch='auto' if method == 'auto' else 'blocked',
        csr_rmatvec=csr_rmatvec, engine=engine, loss=loss, device=device)


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
