"""Port parity of the sparse (CSR) features: the port's `data.sparse`,
`reuters_like` and the CSR branches of the fused oracles against the JAX
package and the float64 brute force.

* `CSRMatrix`, `random_tfidf` and `reuters_like` are numpy in both
  packages and must give equal arrays for equal arguments.
* Loss and subgradient on `differential_fit_cases()` (features on a 0.5
  grid, weights on a 0.25 grid, so float32 and float64 scores agree
  exactly): relative 1e-6 with an absolute floor of 1e-7, as in
  `test_torch_oracle.py`, for both CSR layouts (uniform nnz per row, and
  ragged rows from the zeros of the grid) and both transpose-matvecs.
* On unquantized tf-idf data the CSR gather sums each score in another
  order than the reference's, so scores differ in the last float32 ulp:
  relative 1e-5 against the JAX package, and against the port's own
  dense oracle.
* Counts stay bit-equal: the tree now builds one level at a time."""

import weakref

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from oracle_ref import (differential_fit_cases,  # noqa: E402
                        pairwise_loss_ref, quantized_weights)
from repro.core import oracle as JO  # noqa: E402
from repro.core.ranksvm import RankSVM as JaxRankSVM  # noqa: E402
from repro.data import sparse as jax_sparse  # noqa: E402
from repro.data import synthetic as jax_synthetic  # noqa: E402
from repro_torch.core import counts as TC  # noqa: E402
from repro_torch.core import oracle as TO  # noqa: E402
from repro_torch.core import ref as TR  # noqa: E402
from repro_torch.core.bmrm import bmrm  # noqa: E402
from repro_torch.core.ranksvm import RankSVM  # noqa: E402
from repro_torch.data import CSRMatrix, random_tfidf, reuters_like  # noqa: E402
from torch_parity import n, t, torch_one_thread  # noqa: E402,F401

CASES = list(differential_fit_cases())
CASE_IDS = [c[0] for c in CASES]
TOL = dict(rtol=1e-6, atol=1e-7)


def _layout(X, layout):
    """CSR of a grid case: its zeros make rows ragged; replacing them by
    0.5 gives every row n nonzeros (the uniform layout)."""
    X = np.asarray(X, np.float64)
    if layout == 'uniform':
        X = np.where(X == 0.0, 0.5, X)
    return X, CSRMatrix.from_dense(X)


def _ref_at(X, y, g, w):
    val, sub = pairwise_loss_ref(X @ w, y, g)
    return val, X.T @ sub


def _weights(name, X, k=2):
    rng = np.random.default_rng(sum(map(ord, name)))
    return quantized_weights(rng, X.shape[1], k=k)


def _tfidf_case(m=200, n=64, s=8, seed=5):
    rng = np.random.default_rng(seed + 1)
    return (random_tfidf(m=m, n=n, nnz_per_row=s, seed=seed),
            jax_sparse.random_tfidf(m=m, n=n, nnz_per_row=s, seed=seed),
            rng.normal(size=m), rng.normal(size=n))


# ----------------------------------------------------------------- data


def test_csr_matrix_matches_the_reference_and_dense():
    """scipy's compiled CSR loops give the reference's bincount bits."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(20, 15))
    X[rng.random(X.shape) < 0.7] = 0.0
    X[3] = 0.0                                    # an empty row
    csr, ref = CSRMatrix.from_dense(X), jax_sparse.CSRMatrix.from_dense(X)
    for a, b in ((csr.data, ref.data), (csr.indices, ref.indices),
                 (csr.indptr, ref.indptr)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    w, v = rng.normal(size=15), rng.normal(size=20)
    assert np.array_equal(csr.matvec(w), ref.matvec(w))
    assert np.array_equal(csr.rmatvec(v), ref.rmatvec(v))
    big = random_tfidf(m=3000, n=700, nnz_per_row=30, seed=1)
    big_ref = jax_sparse.random_tfidf(m=3000, n=700, nnz_per_row=30, seed=1)
    wb, vb = rng.normal(size=700), rng.normal(size=3000)
    assert np.array_equal(big.matvec(wb), big_ref.matvec(wb))
    assert np.array_equal(big.row_slice(100, 2900).rmatvec(vb[100:2900]),
                          big_ref.row_slice(100, 2900).rmatvec(vb[100:2900]))
    np.testing.assert_allclose(csr.matvec(w), X @ w, atol=1e-12)
    np.testing.assert_allclose(csr @ w, X @ w, atol=1e-12)
    np.testing.assert_allclose(csr.rmatvec(v), X.T @ v, atol=1e-12)
    np.testing.assert_allclose(csr.to_dense(), X, atol=0)
    np.testing.assert_allclose(csr.rows(4).to_dense(), X[:4])
    np.testing.assert_allclose(csr.row_slice(3, 11).to_dense(), X[3:11])
    assert csr.row_slice(5, 5).shape == (0, 15) and csr.nnz == ref.nnz
    with pytest.raises(ValueError, match='out of range'):
        csr.row_slice(4, 21)
    with pytest.raises(ValueError, match='out of range'):
        csr.rows(-1)
    with pytest.raises(ValueError, match='indptr'):
        CSRMatrix([1.0], [0], [0, 1, 1], (1, 2))


def test_csr_duplicate_entries_sum():
    csr = CSRMatrix([1.0, 2.0, 4.0], [0, 0, 1], [0, 2, 3], (2, 2))
    np.testing.assert_allclose(csr.to_dense(), [[3.0, 0.0], [0.0, 4.0]])
    np.testing.assert_allclose(csr.matvec(np.asarray([1.0, 1.0])),
                               [3.0, 4.0])


@pytest.mark.parametrize('m,n,s,seed', [(1, 5, 1, 0), (64, 300, 7, 3),
                                        (500, 49152, 50, 11)])
def test_random_tfidf_equals_the_reference(m, n, s, seed):
    got = random_tfidf(m=m, n=n, nnz_per_row=s, seed=seed)
    want = jax_sparse.random_tfidf(m=m, n=n, nnz_per_row=s, seed=seed)
    assert got.shape == want.shape
    for a, b in ((got.data, want.data), (got.indices, want.indices),
                 (got.indptr, want.indptr)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize('kw', [dict(m=300, m_test=50, n=128, seed=2),
                                dict(m=1000, m_test=10, n=49152,
                                     nnz_per_row=50, seed=7)])
def test_reuters_like_equals_the_reference(kw):
    got = reuters_like(**kw)
    want = jax_synthetic.reuters_like(**kw)
    assert got.name == want.name and (got.m, got.n) == (want.m, want.n)
    assert np.array_equal(got.y, want.y)
    assert np.array_equal(got.y_test, want.y_test)
    for a, b in ((got.X, want.X), (got.X_test, want.X_test)):
        assert np.array_equal(a.data, b.data)
        assert np.array_equal(a.indices, b.indices)
        assert np.array_equal(a.indptr, b.indptr)
    # similarity utilities: r ~= m, every score (nearly) distinct
    assert np.unique(got.y).size > 0.9 * got.m


# --------------------------------------------------------- CSR oracles


@pytest.mark.parametrize('case', CASES, ids=CASE_IDS)
@pytest.mark.parametrize('rmatvec', ['host', 'device'])
@pytest.mark.parametrize('layout', ['uniform', 'ragged'])
def test_csr_oracles_match_bruteforce(layout, rmatvec, case):
    """tree, pairs and auto (grouped where the case has groups) on CSR
    features, against the float64 brute force."""
    name, X, y, g = case
    X, csr = _layout(X, layout)
    for method in ('tree', 'pairs', 'auto'):
        oracle = TO.make_oracle(csr, y, groups=g, method=method,
                                csr_rmatvec=rmatvec, device='cpu')
        assert oracle._feats.kind == 'csr'
        assert oracle._feats._uniform == (layout == 'uniform')
        assert oracle.prefer_device_solver == (rmatvec == 'device')
        for w in _weights(name, X):
            got_l, got_a = oracle.loss_and_subgrad(w)
            ref_l, ref_a = _ref_at(X, y, g, w)
            np.testing.assert_allclose(float(got_l), ref_l, **TOL)
            np.testing.assert_allclose(n(got_a), ref_a, **TOL)


@pytest.mark.parametrize('rmatvec', ['host', 'device'])
@pytest.mark.parametrize('layout', ['uniform', 'ragged'])
def test_csr_tree_oracle_matches_jax_package(layout, rmatvec):
    if layout == 'uniform':
        X, Xj, y, w = _tfidf_case()
    else:
        rng = np.random.default_rng(7)
        dense = rng.normal(size=(90, 16)) * (rng.random((90, 16)) < 0.3)
        dense[0] = 0.0
        X = CSRMatrix.from_dense(dense)
        Xj = jax_sparse.CSRMatrix.from_dense(dense)
        y, w = rng.normal(size=90), rng.normal(size=16)
    jo = JO.TreeOracle(Xj, y, csr_rmatvec=rmatvec)
    to = TO.TreeOracle(X, y, csr_rmatvec=rmatvec, device='cpu')
    assert to._feats._uniform == jo._feats._uniform
    assert (to.m, to.n, to.n_pairs) == (jo.m, jo.n, jo.n_pairs)
    assert to.prefer_device_solver == jo.prefer_device_solver
    jl, ja = jo.loss_and_subgrad(w)
    tl, ta = to.loss_and_subgrad(w)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(n(ta), n(ja), rtol=1e-5,
                               atol=1e-6 * np.abs(n(ja)).max())
    # and the port's dense oracle on the same matrix
    dl, da = TO.TreeOracle(X.to_dense(), y, device='cpu').loss_and_subgrad(w)
    np.testing.assert_allclose(float(tl), float(dl), rtol=1e-5)
    np.testing.assert_allclose(n(ta), n(da), rtol=1e-5,
                               atol=1e-6 * np.abs(n(da)).max())


def test_csr_inputs_in_every_layout_agree():
    """The port's CSRMatrix, the reference's (any object with CSR
    arrays), scipy CSR and a torch sparse tensor build the same oracle."""
    import scipy.sparse as scipy_sparse
    X, Xj, y, w = _tfidf_case(m=80, n=40, s=5, seed=9)
    dense = X.to_dense()
    inputs = (X, Xj, scipy_sparse.csr_matrix(dense),
              torch.as_tensor(dense).to_sparse())
    outs = [TO.TreeOracle(Xi, y, csr_rmatvec='device',
                          device='cpu').loss_and_subgrad(w)
            for Xi in inputs]
    for lo, ao in outs[1:]:
        np.testing.assert_allclose(float(lo), float(outs[0][0]), rtol=1e-6)
        np.testing.assert_allclose(n(ao), n(outs[0][1]), rtol=1e-5,
                                   atol=1e-7)
    with pytest.raises(ValueError, match='unknown csr_rmatvec'):
        TO.TreeOracle(X, y, csr_rmatvec='gpu', device='cpu')


def _exact_sum(vals, index, bound, replicas=1):
    acc = TO._ExactSum(bound, replicas)
    acc.add(vals, index)
    return acc.result()


def test_exact_index_sum_does_not_depend_on_the_order():
    """The device transpose-matvec's fixed-point sum: any permutation of
    the terms, any split of them over several adds, and any spread of
    them over accumulator replicas give the same bits, and float64
    bincount's sum to float32 (relative 1e-6, and 1e-12 of the bound
    where a sum cancels)."""
    rng = np.random.default_rng(3)
    k, size = 5000, 37
    vals = rng.normal(size=k) * np.exp(rng.normal(size=k) * 3)
    idx = rng.integers(0, size, size=k)
    bound = torch.tensor(np.bincount(idx, np.abs(vals), minlength=size))
    first = _exact_sum(torch.tensor(vals), torch.tensor(idx), bound)
    for _ in range(3):
        perm = rng.permutation(k)
        again = _exact_sum(torch.tensor(vals[perm]), torch.tensor(idx[perm]),
                           bound)
        assert torch.equal(first, again)
    spread = idx + size * (np.arange(k) % 4)        # over 4 replicas
    acc = TO._ExactSum(bound, 4)
    for part in np.array_split(rng.permutation(k), 7):
        acc.add(torch.tensor(vals[part]), torch.tensor(spread[part]))
    assert torch.equal(first, acc.result())
    want = np.bincount(idx, vals, minlength=size)
    np.testing.assert_allclose(n(first), want.astype(np.float32),
                               rtol=1e-6, atol=1e-12 * float(bound.max()))
    zero = _exact_sum(torch.zeros(4, dtype=torch.float64),
                      torch.tensor([0, 1, 1, 2]),
                      torch.zeros(3, dtype=torch.float64))
    assert torch.equal(zero, torch.zeros(3))


@pytest.mark.parametrize('ragged', [False, True])
def test_device_products_keep_each_output_own_precision(ragged):
    """Each column of the device transpose-matvec (and each row of the
    ragged matvec) is rounded on its own bound's grid: a rare column
    whose bound is some 2^-49 of a hot column's still agrees with float64
    to 1e-6 of its own |X|^T |v| (the float32 products' rounding), and
    so does every other column and row."""
    rng = np.random.default_rng(8)
    m, n_cols, rare = 3000, 12, 7
    cols = rng.integers(1, n_cols - 1, size=(m, 3))
    cols[:, 0] = 0                                  # the hot column
    vals = rng.uniform(0.5, 1.5, size=(m, 3))
    vals[:, 0] *= 1e3
    cols[rare, 2], vals[rare, 2] = n_cols - 1, 3e-9  # the rare column
    keep = np.ones((m, 3), bool)
    if ragged:
        keep[rng.random(m) < 0.4, 2] = False        # rows of 2 or 3
        keep[rare, 2] = True
    X = CSRMatrix(vals[keep], cols[keep],
                  np.concatenate([[0], np.cumsum(keep.sum(axis=1))]),
                  (m, n_cols))
    rows = np.repeat(np.arange(m), keep.sum(axis=1))
    d32 = np.zeros((m, n_cols))
    np.add.at(d32, (rows, cols[keep]),
              vals[keep].astype(np.float32).astype(np.float64))
    v = rng.normal(size=m).astype(np.float32)
    w = rng.normal(size=n_cols).astype(np.float32)
    feats = TO._CSRFeatures(X, torch.device('cpu'), csr_rmatvec='device')
    assert feats._uniform != ragged
    got = n(feats.rmatvec(torch.tensor(v))).astype(np.float64)
    want = d32.T @ v.astype(np.float64)
    scale = np.abs(d32).T @ np.abs(v.astype(np.float64))
    assert scale[-1] < 2.0**-48 * scale[0]
    assert np.all(np.abs(got - want) <= 1e-6 * scale)
    got_p = n(feats.matvec(torch.tensor(w))).astype(np.float64)
    want_p = d32 @ w.astype(np.float64)
    scale_p = np.abs(d32) @ np.abs(w.astype(np.float64))
    assert np.all(np.abs(got_p - want_p) <= 1e-6 * scale_p)


def test_solver_auto_follows_the_rmatvec():
    """solver='auto' runs the device driver for a device transpose-matvec
    and the host driver for the host one, as the reference decides."""
    X, _, y, _ = _tfidf_case(m=120, n=30, s=4, seed=4)
    for rmatvec, solver in (('device', 'device'), ('host', 'host')):
        oracle = TO.TreeOracle(X, y, csr_rmatvec=rmatvec, device='cpu')
        res = bmrm(oracle, lam=1e-2, eps=1e-3, max_iter=60)
        assert res.stats.solver == solver and res.stats.converged


def test_csr_fit_matches_jax_package_and_dense():
    """RankSVM on CSR features: the port (host bincount, the CPU default)
    against the JAX package, and against the port's dense fit; all stop
    within eps of the optimum."""
    data = reuters_like(m=400, m_test=100, n=256, nnz_per_row=8, seed=1)
    jdata = jax_synthetic.reuters_like(m=400, m_test=100, n=256,
                                       nnz_per_row=8, seed=1)
    eps = 1e-4
    kw = dict(lam=1e-3, eps=eps, method='tree')
    port = RankSVM(device='cpu', **kw).fit(data.X, data.y)
    assert isinstance(port.oracle_._feats, TO._CSRFeatures)
    ref = JaxRankSVM(**kw).fit(jdata.X, jdata.y)
    dense = RankSVM(device='cpu', **kw).fit(data.X.to_dense(), data.y)
    j_port = port.objective(data.X, data.y)
    assert abs(j_port - ref.objective(jdata.X, jdata.y)) <= eps
    assert abs(j_port - dense.objective(data.X, data.y)) <= eps
    assert abs(port.ranking_error(data.X_test, data.y_test)
               - ref.ranking_error(jdata.X_test, jdata.y_test)) <= 1e-2


# ------------------------------------------------------------ the tree


def test_tree_builds_one_level_at_a_time(monkeypatch):
    """counts_fused keeps one merge-sort-tree level alive at a time (its
    memory is O(m), not O(m log m)) and its counts equal counts_ref."""
    alive = []
    real = TC._tree_level

    def level(y_pad, b):
        out = real(y_pad, b)
        if b:
            assert all(r() is None for r in alive), 'an older level lives'
            alive.append(weakref.ref(out))
        return out

    monkeypatch.setattr(TC, '_tree_level', level)
    rng = np.random.default_rng(8)
    for m in (5, 64, 1000):
        p = t(rng.integers(-6, 7, size=m) * 0.5, torch.float32)
        y = t(rng.integers(0, 4, size=m), torch.float32)
        alive.clear()
        got = TC.counts_fused(p, y)
        want = TR.counts_ref(p, y)
        assert len(alive) == (m - 1).bit_length()
        assert all(torch.equal(a.to(torch.int64), b.to(torch.int64))
                   for a, b in zip(got, want))


# ------------------------------------------- the accumulator's budget


def test_fused_csr_replicas_fit_the_budget(monkeypatch):
    """A fused CSR oracle sizes its transpose-matvec's float64 replicas
    (8 n bytes each) to what a memory budget leaves after its features,
    the O(m) vectors, the per-column state and a chunk's temporaries: at
    m = 4096, n = 2^20 and 50 nonzeros a row the projection is 0.0015
    GiB, and 64 replicas (512 MiB) would overrun a 0.25 GiB budget that
    method='auto' accepts. Too small a budget for one replica streams;
    the projection itself stays the reference's."""
    from repro.data import rowblocks as JRB
    from repro_torch.data import projected_resident_gib
    m, nn, s = 4096, 2**20, 50
    X = random_tfidf(m=m, n=nn, nnz_per_row=s, seed=4)
    y = np.random.default_rng(5).normal(size=m)
    nnz = m * s
    assert TO._csr_layout(X) == (m, nn, nnz, 8, nnz)
    assert projected_resident_gib(X) == JRB.projected_resident_gib(
        jax_sparse.CSRMatrix(X.data, X.indices, X.indptr, X.shape))
    budget = 0.25
    left = (budget * 2**30 - 8 * nnz - TO.VECTOR_BYTES * m
            - TO.RMATVEC_COLUMN_BYTES * nn - 24 * nnz)
    want = int(left // (8 * nn))
    assert 1 <= want < TO.RMATVEC_REPLICAS
    o = TO.make_oracle(X, y, method='auto', memory_budget=budget,
                       csr_rmatvec='device', device='cpu')
    assert isinstance(o, TO.PairwiseOracle) and o._feats._replicas == want
    sizes = []
    init = TO._ExactSum.__init__

    def spy(self, bound, replicas=1):
        init(self, bound, replicas)
        sizes.append(self.acc.numel() * self.acc.element_size())

    monkeypatch.setattr(TO._ExactSum, '__init__', spy)
    w = np.random.default_rng(6).normal(size=nn) * 0.01
    _, a = o.loss_and_subgrad(w)
    assert sizes == [8 * want * nn] and sizes[0] <= left
    host = TO.make_oracle(X, y, method='auto', memory_budget=budget,
                          csr_rmatvec='host', device='cpu')
    _, ah = host.loss_and_subgrad(w)
    np.testing.assert_allclose(a.double().numpy(), ah, rtol=1e-5,
                               atol=1e-5 * np.abs(ah).max())
    # no budget: the full count, as before
    assert TO.make_oracle(X, y, method='auto', device='cpu')._feats \
        ._replicas == TO.RMATVEC_REPLICAS
    # one replica short: 'auto' streams
    tight = (8 * nnz + TO.VECTOR_BYTES * m + TO.RMATVEC_COLUMN_BYTES * nn
             + 24 * nnz + 8 * nn - 1) / 2**30
    assert projected_resident_gib(X) < tight
    assert TO.csr_replicas(m, nn, nnz, 8, nnz, tight) == 0
    assert isinstance(TO.make_oracle(X, y, method='auto', memory_budget=tight,
                                     device='cpu'), TO.StreamingOracle)
    assert TO.csr_replicas(m, nn, nnz, 8, nnz, tight + 2 / 2**30) == 1
