"""Minimal CSR sparse matrix, the port's own copy of `repro.data.sparse`.

The paper's Theorem 2 charges O(ms) for the X^T w / X v matvecs over a
sparse data matrix with s nonzeros per row on average. This CSR does
exactly those two products in O(nnz), plus the row slicing that the
row-block sources and the growing-m experiments need. The products run
through scipy.sparse's compiled CSR kernels, which add the same float64
products in the same order as the reference's numpy bincount kernels
(row by row, each row's nonzeros in storage order), so they give the
same sums. The oracles move the arrays to the device themselves
(`core.oracle._CSRFeatures`).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as _scipy_sparse


class CSRMatrix:
    """Compressed sparse row matrix for the RankSVM access pattern.

    Attributes:
      data:    (nnz,) float64 nonzero values.
      indices: (nnz,) int32 column index per nonzero.
      indptr:  (m+1,) int64 row start offsets into data/indices.
      shape:   (m, n).
    """

    def __init__(self, data, indices, indptr, shape):
        self.data = np.asarray(data, np.float64)
        self.indices = np.asarray(indices, np.int32)
        self.indptr = np.asarray(indptr, np.int64)
        self.shape = tuple(shape)
        if self.indptr.shape[0] != self.shape[0] + 1:
            raise ValueError(f'indptr has {self.indptr.shape[0]} entries; a '
                             f'{self.shape[0]}-row matrix needs '
                             f'{self.shape[0] + 1}')
        if self.indptr[-1] != len(self.data):
            raise ValueError(f'indptr ends at {int(self.indptr[-1])} but '
                             f'there are {len(self.data)} nonzeros')
        self._row_ids = None
        self._sp = None

    @property
    def _rows(self) -> np.ndarray:
        """Row id per nonzero (int64), made at first use: a row slice that
        only multiplies never pays for it."""
        if self._row_ids is None:
            self._row_ids = np.repeat(
                np.arange(self.shape[0], dtype=np.int64),
                np.diff(self.indptr))
        return self._row_ids

    # ------------------------------------------------------------- products

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def _scipy(self):
        """The same arrays as a scipy CSR matrix (no copy of the data)."""
        if self._sp is None:
            self._sp = _scipy_sparse.csr_matrix(
                (self.data, self.indices, self.indptr), shape=self.shape)
        return self._sp

    def matvec(self, w: np.ndarray) -> np.ndarray:
        """X @ w in O(nnz)."""
        return self._scipy() @ np.asarray(w, np.float64)

    def rmatvec(self, v: np.ndarray) -> np.ndarray:
        """X.T @ v in O(nnz)."""
        return self._scipy().T @ np.asarray(v, np.float64)

    def __matmul__(self, w):
        return self.matvec(w)

    # ------------------------------------------------------------- slicing

    def rows(self, m: int) -> 'CSRMatrix':
        """The first m rows, as a copy."""
        m = int(m)
        if not 0 <= m <= self.shape[0]:
            raise ValueError(f'rows({m}) out of range for a matrix with '
                             f'{self.shape[0]} rows')
        end = int(self.indptr[m])
        return CSRMatrix(self.data[:end], self.indices[:end],
                         self.indptr[:m + 1], (m, self.shape[1]))

    def row_slice(self, lo: int, hi: int) -> 'CSRMatrix':
        """Rows [lo, hi) as a new CSRMatrix; [lo, lo) is a valid empty
        slice. Out-of-range bounds raise, so a slice's indptr always
        agrees with its shape (the row-block source's ragged final block
        relies on it)."""
        lo, hi = int(lo), int(hi)
        if not 0 <= lo <= hi <= self.shape[0]:
            raise ValueError(f'row_slice({lo}, {hi}) out of range for a '
                             f'matrix with {self.shape[0]} rows')
        s, e = int(self.indptr[lo]), int(self.indptr[hi])
        return CSRMatrix(self.data[s:e], self.indices[s:e],
                         self.indptr[lo:hi + 1] - self.indptr[lo],
                         (hi - lo, self.shape[1]))

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape)
        np.add.at(out, (self._rows, self.indices), self.data)  # dups sum
        return out

    # ---------------------------------------------------------- construction

    @staticmethod
    def from_dense(X: np.ndarray) -> 'CSRMatrix':
        X = np.asarray(X)
        m, n = X.shape
        mask = X != 0
        counts = mask.sum(axis=1)
        indptr = np.concatenate([[0], np.cumsum(counts)])
        rows, cols = np.nonzero(mask)
        return CSRMatrix(X[rows, cols], cols, indptr, (m, n))


def random_tfidf(m: int, n: int, nnz_per_row: int, seed: int = 0,
                 dtype=np.float64) -> CSRMatrix:
    """Reuters-like sparse tf-idf matrix: Zipf-like column popularity,
    positive log-normal values, exactly nnz_per_row nonzeros per row (the
    paper's 's'), rows L2-normalized. The same draws as the reference's
    generator, so one seed gives the same matrix in both packages."""
    rng = np.random.default_rng(seed)
    # Zipf-distributed column choice (a heavy head, like term
    # frequencies). Sampling with replacement keeps one vectorized draw;
    # duplicate (row, col) entries sum in every product.
    ranks = np.arange(1, n + 1, dtype=np.float64)
    pcol = (1.0 / ranks) / np.sum(1.0 / ranks)
    indices = rng.choice(n, size=(m, nnz_per_row), replace=True,
                         p=pcol).astype(np.int32)
    data = rng.lognormal(mean=0.0, sigma=0.5,
                         size=(m, nnz_per_row)).astype(dtype)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    indptr = np.arange(0, (m + 1) * nnz_per_row, nnz_per_row, dtype=np.int64)
    return CSRMatrix(data.reshape(-1), indices.reshape(-1), indptr, (m, n))
