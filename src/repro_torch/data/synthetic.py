"""Synthetic ranking datasets: the port's own copies of the generators
of `repro.data.synthetic` that the port trains on.

  * `cadata_like`  the paper's Cadata stand-in: 8 dense features,
    real-valued utilities (every score distinct);
  * `reuters_like` the paper's Reuters RCV1 stand-in: sparse tf-idf rows
    (`data.sparse.random_tfidf`) with utilities the similarity to one
    removed target document, so r ~= m;
  * `ordinal_like` r-level ordinal utilities (graded relevance), the
    tie-heavy regime.

Deterministic in `seed` and drawn with numpy, so for equal arguments
they return the same arrays as the JAX package's generators.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .sparse import random_tfidf


@dataclasses.dataclass
class RankingData:
    X: object                    # (m, n) ndarray or CSRMatrix
    y: np.ndarray                # (m,) real-valued utilities
    X_test: object
    y_test: np.ndarray
    name: str

    @property
    def m(self) -> int:
        return self.X.shape[0]

    @property
    def n(self) -> int:
        return self.X.shape[1]


def cadata_like(m: int = 16000, m_test: int = 4000, seed: int = 0,
                noise: float = 0.1) -> RankingData:
    """Low-dimensional dense utilities: 8 features like the housing data,
    and a smooth nonlinear utility, so a linear model keeps an
    irreducible ranking error."""
    rng = np.random.default_rng(seed)
    total = m + m_test
    X = rng.normal(size=(total, 8))
    w = rng.normal(size=8)
    y = (X @ w
         + 0.5 * np.sin(2.0 * X[:, 0]) * X[:, 1]
         + 0.3 * X[:, 2] ** 2
         + noise * rng.normal(size=total))
    return RankingData(X[:m], y[:m], X[m:], y[m:], 'cadata-like')


def reuters_like(m: int = 64000, m_test: int = 20000, n: int = 49152,
                 nnz_per_row: int = 50, seed: int = 0) -> RankingData:
    """Sparse tf-idf features and similarity-to-target utilities: real
    valued, with r ~= m distinct values, the regime where O(rm) methods
    degrade to O(m^2) while the tree stays linearithmic."""
    X = random_tfidf(m + m_test + 1, n, nnz_per_row, seed=seed)
    target = X.row_slice(m + m_test, m + m_test + 1)   # the removed doc
    tvec = np.zeros(n)
    tvec[target.indices] = target.data
    y = X.matvec(tvec)                                  # similarity scores
    Xtr = X.rows(m)
    Xte = X.row_slice(m, m + m_test)
    return RankingData(Xtr, y[:m], Xte, y[m:m + m_test], 'reuters-like')


def ordinal_like(m: int = 8000, m_test: int = 2000, n: int = 32,
                 levels: int = 5, seed: int = 0) -> RankingData:
    """r-level ordinal data (the movie-ratings setting): massive
    y-duplication, `levels` equally populated utility values."""
    rng = np.random.default_rng(seed)
    total = m + m_test
    X = rng.normal(size=(total, n))
    w = rng.normal(size=n)
    raw = X @ w + 0.5 * rng.normal(size=total)
    edges = np.quantile(raw, np.linspace(0, 1, levels + 1)[1:-1])
    y = np.digitize(raw, edges).astype(np.float64)
    return RankingData(X[:m], y[:m], X[m:], y[m:], f'ordinal-{levels}')
