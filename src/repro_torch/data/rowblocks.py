"""Row-block feature sources: out-of-core access to the (m, n) data matrix.

The port's own copy of `repro.data.rowblocks`. The paper's
O(m*s + m*log m) subgradient needs only O(m) scalars resident (the score
vector and the pair-count coefficients), yet a fused oracle pins the
whole feature matrix on the device. `RowBlockSource` breaks that
coupling: fixed-size row blocks of X are produced on demand, and the
streaming oracle (`core.oracle.StreamingOracle`) consumes them in two
chunked passes with peak memory O(block*n + m) whatever m is.

Three implementations cover the storage layouts the oracles accept:

  `DenseBlockSource`   in-RAM row-major ndarray (blocks are views)
  `CSRBlockSource`     `data.sparse.CSRMatrix`, any CSR-like object or
                       scipy CSR (per-block products stay sparse,
                       O(nnz_block))
  `MemmapBlockSource`  `np.memmap` over a file on disk, the genuinely
                       out-of-core case: only the touched blocks are paged
                       in, so m is bounded by disk, not RAM

The reference's fourth source, `BlockStore` (append/retire blocks for
incremental retraining), comes with its only user, ROADMAP.md Queue 1
item 11.

`as_row_block_source` dispatches on the input type;
`projected_resident_gib` is the memory model behind `make_oracle`'s
fused-versus-streaming budget rule (what would a fused oracle pin on the
device for this X?).

Read-ahead (DESIGN.md §9): `iter_blocks`/`iter_payloads` take a
`prefetch=` depth. One background thread (`_ReadAhead`) fetches up to
that many upcoming blocks while the consumer computes on the current
one. `resolve_prefetch` is the layout-aware auto rule (double-buffer
memmaps, stay synchronous for in-RAM sources); every slab is copied out
of its short-lived memmap window before the lookahead opens the next, so
prefetched iteration is bit-identical to synchronous iteration.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import scipy.sparse as _scipy_sparse

from .sparse import CSRMatrix


def _validate_block_rows(block_rows, what: str = 'block_rows') -> int:
    """Reject non-positive, fractional or boolean block sizes loudly: a
    silent int() cast would turn block=0 into an endless block loop and
    block=2.5 into an off-by-some partition."""
    ok = isinstance(block_rows, (int, np.integer)) and not isinstance(
        block_rows, bool)
    if not ok and isinstance(block_rows, (float, np.floating)):
        if not float(block_rows).is_integer():
            raise ValueError(f'{what} must be a whole number of rows; got '
                             f'the fractional value {block_rows!r}')
        ok = True
    if not ok:
        raise ValueError(f'{what} must be a positive integer; got '
                         f'{block_rows!r} of type '
                         f'{type(block_rows).__name__}')
    block_rows = int(block_rows)
    if block_rows <= 0:
        raise ValueError(f'{what} must be a positive integer; got '
                         f'{block_rows}')
    return block_rows


def _validate_prefetch(prefetch, what: str = 'prefetch'):
    """Validate a read-ahead depth: None/'auto' pass through as None (the
    caller resolves them per source layout, `resolve_prefetch`); anything
    else must be a non-negative whole number of blocks. 0 means
    synchronous fetches (no background thread); k >= 1 keeps up to k
    blocks in flight ahead of the consumer."""
    if prefetch is None or (isinstance(prefetch, str)
                            and prefetch == 'auto'):
        return None
    ok = isinstance(prefetch, (int, np.integer)) and not isinstance(
        prefetch, bool)
    if not ok and isinstance(prefetch, (float, np.floating)):
        if not float(prefetch).is_integer():
            raise ValueError(f'{what} must be a whole number of blocks; '
                             f'got the fractional value {prefetch!r}')
        ok = True
    if not ok:
        raise ValueError(f"{what} must be a non-negative integer, None or "
                         f"'auto'; got {prefetch!r} of type "
                         f'{type(prefetch).__name__}')
    prefetch = int(prefetch)
    if prefetch < 0:
        raise ValueError(f'{what} must be a non-negative integer; got '
                         f'{prefetch}')
    return prefetch


def resolve_prefetch(source: 'RowBlockSource', prefetch) -> int:
    """Effective read-ahead depth for `source`: explicit integers pass
    through (validated); None/'auto' resolve by layout, 1 (double
    buffering) for a disk-backed source, whose per-window file reads are
    the latency worth hiding, and 0 (synchronous) for the in-RAM dense
    and CSR sources, where a fetch is a view or an O(nnz_block) slice."""
    depth = _validate_prefetch(prefetch)
    if depth is None:
        depth = 1 if source.disk_backed else 0
    return depth


class _ReadAhead:
    """Depth-bounded background read-ahead over an indexed block fetch.

    One worker thread (a single-worker `ThreadPoolExecutor`) runs
    `fetch(i)` for up to `depth` indices past the one being consumed;
    `get(i)` returns block i, blocking only if its fetch has not finished.
    Correctness never depends on the predicted order: a `get` miss is
    fetched on the worker and waited for, so any access pattern yields
    exactly `fetch(i)`. Worker exceptions re-raise in the consumer at the
    corresponding `get`.

    `wrap=True` predicts `(i + 1) % n`, the access pattern of the
    streaming oracle's repeated two-pass sweeps: the lookahead of the last
    block warms block 0 of the next pass.

    Every payload must own its memory or reference stable in-RAM storage
    (memmap windows are copied out), so the worker never aliases a buffer
    the consumer still holds. Peak resident payloads: `depth` pending +
    the one being consumed.

    `close()` drops pending work and shuts the pool down without blocking
    on in-flight fetches. An abandoned instance is also safe: when it is
    garbage-collected the executor wakes its worker, which exits.
    """

    def __init__(self, fetch, n: int, depth: int, *, wrap: bool = False):
        self._fetch = fetch
        self._n = int(n)
        self._depth = int(depth)
        self._wrap = bool(wrap)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending = {}

    def get(self, i):
        i = int(i)
        fut = self._pending.pop(i, None)
        if fut is None:
            fut = self._pool.submit(self._fetch, i)
        for k in range(1, self._depth + 1):
            j = i + k
            if self._wrap:
                j %= self._n
            if j == i or not 0 <= j < self._n:
                continue
            if j not in self._pending and len(self._pending) < self._depth:
                self._pending[j] = self._pool.submit(self._fetch, j)
        return fut.result()

    def close(self):
        self._pending.clear()
        self._pool.shutdown(wait=False, cancel_futures=True)


class RowBlock(NamedTuple):
    """One fixed-size slab of rows plus the aligned per-row slices."""

    lo: int
    hi: int
    X: np.ndarray          # (hi - lo, n) dense float32
    aligned: tuple         # slices of the aligned arrays, same row range


class RowBlockSource:
    """Interface: fixed-size row-block access to an (m, n) feature matrix.

    Subclasses implement `block(lo, hi)` (a dense float32 slab) and may
    override the per-block matvecs with layout-native kernels; the
    defaults go through the dense slab. `ranges` partitions [0, m) into
    `block_rows`-sized spans (the final block ragged), and `iter_blocks`
    yields the slabs with the matching slices of any row-aligned arrays.
    """

    kind = 'abstract'
    m: int
    n: int

    def block(self, lo: int, hi: int) -> np.ndarray:
        """Dense float32 rows [lo, hi) of X, shape (hi - lo, n)."""
        raise NotImplementedError

    def matvec_block(self, lo: int, hi: int, w) -> np.ndarray:
        """X[lo:hi] @ w in float64, shape (hi - lo,)."""
        return self.block(lo, hi).astype(np.float64) @ np.asarray(
            w, np.float64)

    def rmatvec_block(self, lo: int, hi: int, v) -> np.ndarray:
        """X[lo:hi].T @ v in float64, shape (n,)."""
        return self.block(lo, hi).astype(np.float64).T @ np.asarray(
            v, np.float64)

    def _payload(self, lo: int, hi: int):
        """Layout-native slab for rows [lo, hi), the unit a background
        read-ahead fetches: it owns its memory or references stable
        in-RAM storage. Consumed by `_payload_matvec`/`_payload_rmatvec`,
        which run the same kernels on the same bytes as `matvec_block`/
        `rmatvec_block`, so prefetched passes are bit-identical to
        synchronous ones. Default: the dense f32 block."""
        return self.block(lo, hi)

    def _payload_matvec(self, payload, w) -> np.ndarray:
        return payload.astype(np.float64) @ np.asarray(w, np.float64)

    def _payload_rmatvec(self, payload, v) -> np.ndarray:
        return payload.astype(np.float64).T @ np.asarray(v, np.float64)

    def iter_payloads(self, block_rows: int, prefetch=0):
        """Yield `(lo, hi, payload)` over `ranges(block_rows)`, the
        payloads optionally fetched `prefetch` blocks ahead by a
        background thread (`_ReadAhead`; None/'auto' resolves per layout).
        The streaming oracle's host passes consume this."""
        spans = list(self.ranges(block_rows))
        depth = resolve_prefetch(self, prefetch)
        if depth == 0 or len(spans) <= 1:
            for lo, hi in spans:
                yield lo, hi, self._payload(lo, hi)
            return
        ra = _ReadAhead(lambda i: self._payload(*spans[i]), len(spans),
                        depth)
        try:
            for i, (lo, hi) in enumerate(spans):
                yield lo, hi, ra.get(i)
        finally:
            ra.close()

    def _check_range(self, lo: int, hi: int) -> tuple[int, int]:
        lo, hi = int(lo), int(hi)
        if not 0 <= lo <= hi <= self.m:
            raise ValueError(f'row block [{lo}, {hi}) out of range for '
                             f'{self.m} rows')
        return lo, hi

    def ranges(self, block_rows: int):
        """(lo, hi) spans of `block_rows` rows covering [0, m); the final
        span is ragged when block_rows does not divide m."""
        block_rows = _validate_block_rows(block_rows)
        for lo in range(0, self.m, block_rows):
            yield lo, min(lo + block_rows, self.m)

    def iter_blocks(self, block_rows: int, *aligned, prefetch=0):
        """Yield `RowBlock`s: dense row slabs plus the matching slices of
        each row-aligned array (y, groups, ...), optionally fetched
        `prefetch` blocks ahead on a background thread; bit-identical to
        synchronous iteration."""
        arrays = []
        for a in aligned:
            a = np.asarray(a)
            if a.shape[:1] != (self.m,):
                raise ValueError(
                    f'aligned array has leading dim {a.shape[:1]} but the '
                    f'source has {self.m} rows; they must align one-to-one')
            arrays.append(a)
        spans = list(self.ranges(block_rows))
        depth = resolve_prefetch(self, prefetch)
        if depth == 0 or len(spans) <= 1:
            for lo, hi in spans:
                yield RowBlock(lo, hi, self.block(lo, hi),
                               tuple(a[lo:hi] for a in arrays))
            return
        ra = _ReadAhead(lambda i: self.block(*spans[i]), len(spans), depth)
        try:
            for i, (lo, hi) in enumerate(spans):
                yield RowBlock(lo, hi, ra.get(i),
                               tuple(a[lo:hi] for a in arrays))
        finally:
            ra.close()

    def n_blocks(self, block_rows: int) -> int:
        block_rows = _validate_block_rows(block_rows)
        return -(-self.m // block_rows)

    def row_bytes(self) -> int:
        """Estimated resident bytes per row during a block pass, the input
        to budget-derived block sizing. Default: the dense f32 slab
        (4*n); sparse sources override with their layout-native cost."""
        return 4 * self.n

    @property
    def disk_backed(self) -> bool:
        """True when block fetches touch disk (drives `resolve_prefetch`'s
        auto double-buffering): the memmap layout."""
        return self.kind == 'memmap'


class DenseBlockSource(RowBlockSource):
    """Row-major in-RAM ndarray; blocks are cheap row views."""

    kind = 'dense'

    def __init__(self, X):
        X = np.asarray(X)
        if X.ndim != 2:
            raise ValueError(f'dense feature matrix must be 2-D; got shape '
                             f'{X.shape}')
        self._X = X
        self.m, self.n = map(int, X.shape)

    def block(self, lo: int, hi: int) -> np.ndarray:
        lo, hi = self._check_range(lo, hi)
        return np.asarray(self._X[lo:hi], np.float32)

    def matvec_block(self, lo: int, hi: int, w) -> np.ndarray:
        lo, hi = self._check_range(lo, hi)
        return np.asarray(
            self._X[lo:hi] @ np.asarray(w, np.float64)).ravel()

    def rmatvec_block(self, lo: int, hi: int, v) -> np.ndarray:
        lo, hi = self._check_range(lo, hi)
        return np.asarray(
            self._X[lo:hi].T @ np.asarray(v, np.float64)).ravel()

    def _payload(self, lo: int, hi: int):
        return self._X[lo:hi]        # zero-copy view of stable RAM

    def _payload_matvec(self, payload, w) -> np.ndarray:
        return np.asarray(payload @ np.asarray(w, np.float64)).ravel()

    def _payload_rmatvec(self, payload, v) -> np.ndarray:
        return np.asarray(payload.T @ np.asarray(v, np.float64)).ravel()


class MemmapBlockSource(RowBlockSource):
    """np.memmap-backed rows, the genuinely out-of-core layout.

    Accepts an existing `np.memmap` (row-major, 2-D) or opens one from
    `path` + `shape` + `dtype`. Each block access maps only its own file
    window, copies the rows out and drops the mapping: a long-lived map
    would accumulate every touched page in the process's resident set
    over a pass, the O(m*n) residency this source exists to avoid.
    """

    kind = 'memmap'

    def __init__(self, X=None, *, path=None, shape=None,
                 dtype=np.float32, offset: int = 0):
        if X is None:
            if path is None or shape is None:
                raise ValueError('MemmapBlockSource needs an np.memmap or '
                                 'path= and shape=')
        else:
            if not isinstance(X, np.memmap):
                raise ValueError('MemmapBlockSource needs an np.memmap; '
                                 f'got {type(X).__name__} (use '
                                 'DenseBlockSource for in-RAM arrays)')
            if X.ndim != 2:
                raise ValueError(f'memmap features must be 2-D; got shape '
                                 f'{X.shape}')
            if not X.flags['C_CONTIGUOUS']:
                raise ValueError('memmap features must be row-major '
                                 '(C-contiguous) for row-block windows')
            # A sliced view (mm[lo:hi]) inherits the base map's `.offset`,
            # so the true file offset of row 0 adds the view's byte
            # displacement from the top array.
            base = X
            while isinstance(base.base, np.ndarray):
                base = base.base
            delta = X.ctypes.data - base.ctypes.data
            path, shape = base.filename, X.shape
            dtype, offset = X.dtype, int(base.offset) + delta
        self._path = path
        self._dtype = np.dtype(dtype)
        self._offset = int(offset)
        self.m, self.n = map(int, shape)
        # Anonymous maps cannot be reopened per window; hold and slice.
        self._held = X if path is None else None

    def _window(self, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) copied out of a window-sized mapping."""
        if hi == lo:
            return np.zeros((0, self.n), self._dtype)
        if self._held is not None:
            return np.array(self._held[lo:hi])
        off = self._offset + lo * self.n * self._dtype.itemsize
        mm = np.memmap(self._path, mode='r', dtype=self._dtype,
                       shape=(hi - lo, self.n), offset=off)
        out = np.array(mm)           # copy; the mapping dies with mm
        del mm
        return out

    def block(self, lo: int, hi: int) -> np.ndarray:
        lo, hi = self._check_range(lo, hi)
        return np.asarray(self._window(lo, hi), np.float32)

    def matvec_block(self, lo: int, hi: int, w) -> np.ndarray:
        lo, hi = self._check_range(lo, hi)
        return self._window(lo, hi).astype(np.float64) @ np.asarray(
            w, np.float64)

    def rmatvec_block(self, lo: int, hi: int, v) -> np.ndarray:
        lo, hi = self._check_range(lo, hi)
        return self._window(lo, hi).astype(np.float64).T @ np.asarray(
            v, np.float64)

    def _payload(self, lo: int, hi: int):
        # The raw-dtype window, copied out; the base payload matvecs run
        # the same astype(f64) products as the *_block kernels above.
        return self._window(lo, hi)


def _is_csr_like(X) -> bool:
    return (hasattr(X, 'data') and hasattr(X, 'indices')
            and hasattr(X, 'indptr'))


def as_csr_matrix(X) -> CSRMatrix:
    """X as this package's `CSRMatrix`: passed through, or rebuilt from
    scipy sparse, a torch sparse tensor or any object with CSR arrays
    (data, indices, indptr, shape)."""
    if isinstance(X, CSRMatrix):
        return X
    if _scipy_sparse.issparse(X):
        X = X.tocsr()
    elif hasattr(X, 'to_sparse'):              # a torch sparse tensor
        coo = X.detach().cpu().to_sparse().coalesce()   # row-major order
        rows, cols = coo.indices().numpy()
        m = int(coo.shape[0])
        indptr = np.concatenate(
            [[0], np.cumsum(np.bincount(rows, minlength=m))])
        return CSRMatrix(coo.values().numpy(), cols, indptr,
                         tuple(coo.shape))
    if not _is_csr_like(X):
        raise ValueError('expected a CSRMatrix, a scipy sparse matrix, a '
                         'torch sparse tensor or an object with CSR arrays; '
                         f'got {type(X).__name__}')
    return CSRMatrix(np.asarray(X.data), np.asarray(X.indices),
                     np.asarray(X.indptr), tuple(X.shape))


class CSRBlockSource(RowBlockSource):
    """CSR-backed blocks: per-block products run on the sparse slice in
    O(nnz_block); only `block()` (the dense slab of the device driver's
    pass) materializes O(block*n)."""

    kind = 'csr'

    def __init__(self, X):
        self._X = as_csr_matrix(X)
        self.m, self.n = map(int, self._X.shape)

    def block(self, lo: int, hi: int) -> np.ndarray:
        lo, hi = self._check_range(lo, hi)
        return self._X.row_slice(lo, hi).to_dense().astype(np.float32)

    def matvec_block(self, lo: int, hi: int, w) -> np.ndarray:
        lo, hi = self._check_range(lo, hi)
        return self._X.row_slice(lo, hi).matvec(np.asarray(w, np.float64))

    def rmatvec_block(self, lo: int, hi: int, v) -> np.ndarray:
        lo, hi = self._check_range(lo, hi)
        return self._X.row_slice(lo, hi).rmatvec(np.asarray(v, np.float64))

    def _payload(self, lo: int, hi: int):
        return self._X.row_slice(lo, hi)     # sparse, O(nnz_block)

    def _payload_matvec(self, payload, w) -> np.ndarray:
        return payload.matvec(np.asarray(w, np.float64))

    def _payload_rmatvec(self, payload, v) -> np.ndarray:
        return payload.rmatvec(np.asarray(v, np.float64))

    def row_bytes(self) -> int:
        """O(nnz_row) for the sparse per-block products (f64 data + int32
        indices per nonzero), the cost of the host passes, which is where
        solver='auto' runs CSR streaming. Forcing solver='device' instead
        densifies a (block, n) slab per fetch, beyond this estimate."""
        avg_nnz = self._X.nnz / max(1, self.m)
        return max(1, int(12 * avg_nnz))


def is_sparse_input(X) -> bool:
    """True for every CSR layout `as_csr_matrix` accepts."""
    if isinstance(X, CSRMatrix) or _is_csr_like(X):
        return True
    if _scipy_sparse.issparse(X):
        return True
    layout = getattr(X, 'layout', None)          # torch tensors
    return layout is not None and str(layout) != 'torch.strided'


def as_row_block_source(X) -> RowBlockSource:
    """Wrap X in the RowBlockSource matching its storage layout."""
    if isinstance(X, RowBlockSource):
        return X
    if isinstance(X, np.memmap):
        return MemmapBlockSource(X)
    if is_sparse_input(X):
        return CSRBlockSource(X)
    if hasattr(X, 'detach'):                    # a dense torch tensor
        X = X.detach().cpu().numpy()
    return DenseBlockSource(X)


def projected_resident_gib(X) -> float:
    """GiB a fused oracle would pin on the device for this X.

    The memory model behind `make_oracle`'s fused-versus-streaming
    dispatch: dense (and memmap, which a fused oracle would materialize)
    costs m*n f32; CSR costs its data+indices (+ the row vector when
    ragged). The O(m) score/label vectors are charged to both paths and
    omitted."""
    if isinstance(X, CSRBlockSource):
        X = X._X
    elif isinstance(X, RowBlockSource):
        return X.m * X.n * 4 / 2**30
    if is_sparse_input(X):
        X = as_csr_matrix(X)
        indptr = np.asarray(X.indptr)
        nnz = int(indptr[-1])
        lens = np.diff(indptr)
        uniform = bool(lens.size and np.all(lens == lens[0]) and lens[0] > 0)
        per_nnz = 8 if uniform else 12   # data+idx (+row ids when ragged)
        return nnz * per_nnz / 2**30
    m, n = map(int, np.shape(X)[:2])
    return m * n * 4 / 2**30
