"""Port parity of the out-of-core layer: the port's `data.rowblocks`
sources, `StreamingOracle` and the memory-budgeted `make_oracle`
dispatch, against the JAX package and the port's fused oracles, the
cases of `tests/test_streaming.py`.

Tolerances: the streaming host passes are float64 products in both
packages, and the counting is bit-equal, so loss and subgradient agree
with the JAX package's streaming oracle to 1e-6 (the loss sums in
another order on each side); against the fused float32 oracles 1e-6 as
the reference holds its own; the device step (float32 slabs) against the
host passes 1e-5. Results at prefetch 0, 1 and 2 are bit-identical.
Fits stop within eps of the optimum, so objectives agree to eps."""

import gc
import warnings
import weakref

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from repro.core import oracle as JO  # noqa: E402
from repro.core.ranksvm import RankSVM as JaxRankSVM  # noqa: E402
from repro.data import rowblocks as JRB  # noqa: E402
from repro.data import sparse as jax_sparse  # noqa: E402
from repro_torch.core import counts as TC  # noqa: E402
from repro_torch.core import oracle as TO  # noqa: E402
from repro_torch.core.bmrm import bmrm  # noqa: E402
from repro_torch.core.ranksvm import RankSVM  # noqa: E402
from repro_torch.data import (CSRBlockSource, CSRMatrix,  # noqa: E402
                              DenseBlockSource, MemmapBlockSource,
                              as_row_block_source, projected_resident_gib,
                              random_tfidf)
from repro_torch.data.rowblocks import (_ReadAhead,  # noqa: E402
                                        _validate_block_rows,
                                        _validate_prefetch,
                                        resolve_prefetch)
from torch_parity import n, torch_one_thread  # noqa: E402,F401


def _case(m=230, n=12, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(m, n)), rng.normal(size=m), rng.normal(size=n)


def _memmap_of(X, tmp_path, name='X.f32', dtype=np.float32):
    path = tmp_path / name
    mm = np.memmap(path, mode='w+', dtype=dtype, shape=X.shape)
    mm[:] = X
    mm.flush()
    return np.memmap(path, mode='r', dtype=dtype, shape=X.shape)


def _close(a, b, tol=1e-6):
    np.testing.assert_allclose(n(a).astype(np.float64),
                               n(b).astype(np.float64), rtol=tol, atol=tol)


def _stream(X, y, **kw):
    return TO.StreamingOracle(X, y, device='cpu', **kw)


# ------------------------------------------------------ row-block sources


def test_source_dispatch_on_layout(tmp_path):
    X, _, _ = _case()
    assert isinstance(as_row_block_source(X), DenseBlockSource)
    assert isinstance(as_row_block_source(torch.as_tensor(X)),
                      DenseBlockSource)
    for sparse in (CSRMatrix.from_dense(X), jax_sparse.CSRMatrix.from_dense(X),
                   torch.as_tensor(X).to_sparse()):
        assert isinstance(as_row_block_source(sparse), CSRBlockSource)
    assert isinstance(as_row_block_source(_memmap_of(X, tmp_path)),
                      MemmapBlockSource)
    src = DenseBlockSource(X)
    assert as_row_block_source(src) is src


@pytest.mark.parametrize('kind', ['dense', 'csr', 'memmap'])
def test_sources_reassemble_matrix(kind, tmp_path):
    """Blocks (the final one ragged) concatenate back to X, and the
    per-block products match the reference's sources bit for bit."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(53, 7))          # 53 = 3*16 + ragged 5
    if kind == 'csr':
        X[rng.random(X.shape) < 0.5] = 0.0
        src = CSRBlockSource(CSRMatrix.from_dense(X))
        ref = JRB.CSRBlockSource(jax_sparse.CSRMatrix.from_dense(X))
    elif kind == 'memmap':
        src = MemmapBlockSource(_memmap_of(X, tmp_path))
        ref = JRB.MemmapBlockSource(_memmap_of(X, tmp_path, 'r.f32'))
    else:
        src, ref = DenseBlockSource(X), JRB.DenseBlockSource(X)
    assert (src.m, src.n, src.kind) == (53, 7, ref.kind)
    assert src.n_blocks(16) == 4 and src.row_bytes() == ref.row_bytes()
    blocks = [src.block(lo, hi) for lo, hi in src.ranges(16)]
    assert [b.shape[0] for b in blocks] == [16, 16, 16, 5]
    np.testing.assert_allclose(np.concatenate(blocks), X, atol=1e-6)
    w, v = rng.normal(size=7), rng.normal(size=16)
    assert np.array_equal(src.matvec_block(16, 32, w),
                          ref.matvec_block(16, 32, w))
    assert np.array_equal(src.rmatvec_block(0, 16, v),
                          ref.rmatvec_block(0, 16, v))
    np.testing.assert_allclose(src.matvec_block(16, 32, w), X[16:32] @ w,
                               atol=1e-5)
    np.testing.assert_allclose(src.rmatvec_block(0, 16, v), X[:16].T @ v,
                               atol=1e-5)


def test_memmap_sliced_view_reads_correct_rows(tmp_path):
    """A row-sliced memmap view inherits the base map's byte offset, so
    window reconstruction must add the view's displacement."""
    rng = np.random.default_rng(20)
    X = rng.normal(size=(10, 2)).astype(np.float32)
    mm = _memmap_of(X, tmp_path)
    src = MemmapBlockSource(mm[4:])
    assert src.m == 6
    np.testing.assert_allclose(src.block(0, 3), X[4:7], atol=1e-7)
    np.testing.assert_allclose(src.block(2, 6), X[6:10], atol=1e-7)
    src2 = MemmapBlockSource(mm[2:][3:])
    np.testing.assert_allclose(src2.block(0, 2), X[5:7], atol=1e-7)
    off = np.memmap(tmp_path / 'X.f32', mode='r', dtype=np.float32,
                    shape=(8, 2), offset=2 * 2 * 4)
    np.testing.assert_allclose(MemmapBlockSource(off[1:]).block(0, 5),
                               X[3:8], atol=1e-7)
    with pytest.raises(ValueError, match='np.memmap'):
        MemmapBlockSource(X)


def test_iter_blocks_aligned_slices_and_range_checks():
    X, y, _ = _case(m=50, n=4)
    g = np.arange(50, dtype=np.int32)
    out = list(DenseBlockSource(X).iter_blocks(20, y, g))
    assert [(b.lo, b.hi) for b in out] == [(0, 20), (20, 40), (40, 50)]
    for b in out:
        np.testing.assert_allclose(b.X, X[b.lo:b.hi], atol=1e-6)
        np.testing.assert_array_equal(b.aligned[0], y[b.lo:b.hi])
        np.testing.assert_array_equal(b.aligned[1], g[b.lo:b.hi])
    with pytest.raises(ValueError, match='align'):
        list(DenseBlockSource(X).iter_blocks(20, y[:-1]))
    src = DenseBlockSource(X)
    assert src.block(10, 10).shape == (0, 4)
    for lo, hi in ((0, 51), (-1, 5)):
        with pytest.raises(ValueError, match='out of range'):
            src.block(lo, hi)


def test_projected_resident_gib_equals_the_reference(tmp_path):
    X = np.zeros((1024, 256))
    mm = _memmap_of(X, tmp_path)
    uniform = random_tfidf(m=256, n=512, nnz_per_row=8, seed=0)
    rng = np.random.default_rng(2)
    ragged = rng.normal(size=(40, 30)) * (rng.random((40, 30)) < 0.3)
    for got, want in (
            (X, X), (mm, mm), (DenseBlockSource(X), JRB.DenseBlockSource(X)),
            (uniform, jax_sparse.random_tfidf(m=256, n=512, nnz_per_row=8,
                                              seed=0)),
            (CSRMatrix.from_dense(ragged),
             jax_sparse.CSRMatrix.from_dense(ragged))):
        assert projected_resident_gib(got) == JRB.projected_resident_gib(
            want)
    assert projected_resident_gib(uniform) == uniform.nnz * 8 / 2**30
    assert projected_resident_gib(
        torch.as_tensor(ragged).to_sparse()) == JRB.projected_resident_gib(
            jax_sparse.CSRMatrix.from_dense(ragged))


@pytest.mark.parametrize('m', [1, 200, 2**20])
@pytest.mark.parametrize('row_bytes', [1, 48, 600, 1200, 4 * 49152])
@pytest.mark.parametrize('budget', [None, 1e-9, 1e-4, 0.1953125, 8.0])
def test_auto_stream_block_equals_the_reference(budget, row_bytes, m):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        assert TO._auto_stream_block(m, row_bytes, budget) == \
            JO._auto_stream_block(m, row_bytes, budget)


# --------------------------------------------- streaming oracle parity


@pytest.mark.parametrize('block_rows', [64, 230, 1000])
def test_streaming_matches_tree_dense(block_rows):
    """Dense input: the streaming oracle against the port's TreeOracle
    and the JAX package's streaming oracle, for dividing, exact and
    oversized block sizes."""
    X, y, w = _case()
    lt, at = TO.TreeOracle(X, y, device='cpu').loss_and_subgrad(w)
    so = _stream(X, y, block_rows=block_rows)
    assert so.name == 'stream/dense'
    ls, as_ = so.loss_and_subgrad(w)
    np.testing.assert_allclose(float(ls), float(lt), rtol=1e-6, atol=1e-6)
    _close(as_, at)
    lj, aj = JO.StreamingOracle(X, y, block_rows=block_rows
                                ).loss_and_subgrad(w)
    np.testing.assert_allclose(float(ls), float(lj), rtol=1e-6)
    _close(as_, aj)


def test_streaming_matches_tree_csr():
    X = random_tfidf(m=180, n=48, nnz_per_row=8, seed=3)
    Xj = jax_sparse.random_tfidf(m=180, n=48, nnz_per_row=8, seed=3)
    rng = np.random.default_rng(4)
    y, w = rng.normal(size=180), rng.normal(size=48)
    lt, at = TO.TreeOracle(X, y, device='cpu').loss_and_subgrad(w)
    so = _stream(X, y, block_rows=33)
    assert so.name == 'stream/csr'
    ls, as_ = so.loss_and_subgrad(w)
    np.testing.assert_allclose(float(ls), float(lt), rtol=1e-6, atol=1e-6)
    _close(as_, at)
    lj, aj = JO.StreamingOracle(Xj, y, block_rows=33).loss_and_subgrad(w)
    np.testing.assert_allclose(float(ls), float(lj), rtol=1e-6)
    # the same float64 host kernels over the same (bit-equal) counts
    assert np.array_equal(as_, np.asarray(aj, np.float64))


def test_streaming_matches_grouped():
    X, y, w = _case(m=150, seed=5)
    g = np.random.default_rng(6).integers(0, 8, size=150).astype(np.int32)
    go = TO.GroupedOracle(X, y, g, device='cpu')
    lg, ag = go.loss_and_subgrad(w)
    so = _stream(X, y, groups=g, block_rows=41)
    ls, as_ = so.loss_and_subgrad(w)
    assert so.n_pairs == go.n_pairs == JO.GroupedOracle(X, y, g).n_pairs
    np.testing.assert_allclose(float(ls), float(lg), rtol=1e-6, atol=1e-6)
    _close(as_, ag)


def test_streaming_matches_tree_memmap(tmp_path):
    X, y, w = _case(m=140, n=9, seed=7)
    src = MemmapBlockSource(_memmap_of(X.astype(np.float32), tmp_path))
    lt, at = TO.TreeOracle(X.astype(np.float32), y,
                           device='cpu').loss_and_subgrad(w)
    so = _stream(src, y, block_rows=32)
    assert so.name == 'stream/memmap' and so.prefetch == 1
    ls, as_ = so.loss_and_subgrad(w)
    np.testing.assert_allclose(float(ls), float(lt), rtol=1e-6, atol=1e-6)
    _close(as_, at)


@pytest.mark.parametrize('kind', ['dense', 'csr'])
def test_streaming_step_fn_matches_host_eval(kind):
    """The device step (dense f32 slabs moved to the device one at a
    time) computes the host passes' (loss, a)."""
    X, y, w = _case(m=100, n=6, seed=8)
    if kind == 'csr':
        X[np.abs(X) < 0.7] = 0.0
        X = CSRMatrix.from_dense(X)
    so = _stream(X, y, block_rows=17)               # ragged: 6 blocks
    lh, ah = so.loss_and_subgrad(w)
    ld, ad = so.step_fn()(torch.as_tensor(w, dtype=torch.float32))
    np.testing.assert_allclose(float(ld), float(lh), rtol=1e-5, atol=1e-6)
    _close(ad, ah, tol=1e-5)


def test_streaming_metadata_and_pairs():
    X, y, _ = _case(m=60, n=5, seed=9)
    so = _stream(X, y, block_rows=16)
    assert (so.m, so.n) == (60, 5)
    assert so.supports_device_solver and so.prefer_device_solver
    assert not so.device_resident
    sc = _stream(random_tfidf(m=60, n=30, nnz_per_row=4, seed=1),
                 np.random.default_rng(2).normal(size=60))
    assert sc.supports_device_solver and not sc.prefer_device_solver
    assert so.block_resident_bytes() == 16 * 5 * 4
    assert so.n_pairs == TC.num_pairs_host(y)


# --------------------------------------------- device-driver composition


def test_streaming_device_solver_parity():
    """bmrm(solver='device') over the streaming step reaches the host
    driver's objective, as the JAX package's does."""
    X, y, _ = _case(m=120, n=8, seed=10)
    so = _stream(X, y, block_rows=32)
    rd = bmrm(so, lam=1e-2, eps=1e-3, solver='device', max_iter=150)
    rh = bmrm(so, lam=1e-2, eps=1e-3, solver='host', max_iter=150)
    assert rd.stats.converged and rh.stats.converged
    assert rd.stats.solver == 'device' and rh.stats.solver == 'host'
    assert rd.stats.obj_best == pytest.approx(rh.stats.obj_best, rel=1e-3)


def test_streaming_oracle_is_collectable_after_device_fit():
    """The device step closes over locals, never the oracle."""
    X, y, _ = _case(m=60, n=5, seed=14)
    so = _stream(X, y, block_rows=16, prefetch=1)
    bmrm(so, lam=1e-2, eps=1e-2, solver='device', max_iter=30)
    ref = weakref.ref(so)
    del so
    gc.collect()
    assert ref() is None


# ------------------------------------------------- dispatch heuristic


def test_make_oracle_dispatch_follows_the_reference(tmp_path):
    X, y, _ = _case()
    for budget, want in ((1e-9, 'StreamingOracle'), (10.0, 'PairwiseOracle'),
                         (None, 'PairwiseOracle')):
        with warnings.catch_warnings():
            warnings.simplefilter('ignore', RuntimeWarning)
            got = TO.make_oracle(X, y, method='auto', memory_budget=budget,
                                 device='cpu')
            ref = JO.make_oracle(X, y, method='auto', memory_budget=budget)
        assert type(got).__name__ == type(ref).__name__ == want
    mm = _memmap_of(X, tmp_path)
    src = as_row_block_source(X)
    for Xi in (mm, src):
        assert isinstance(TO.make_oracle(Xi, y, method='auto', device='cpu'),
                          TO.StreamingOracle)
    assert isinstance(TO.make_oracle(X, y, method='stream', device='cpu'),
                      TO.StreamingOracle)
    for method in ('tree', 'pairs'):
        with pytest.raises(ValueError, match='row-block source'):
            TO.make_oracle(src, y, method=method, device='cpu')
    with pytest.raises(ValueError, match='prefetch'):
        TO.make_oracle(X, y, method='stream', prefetch=-1, device='cpu')
    for Xi in (mm, src):
        sharded = TO.make_oracle(Xi, y, method='sharded', device='cpu')
        assert isinstance(sharded, TO.ShardedOracle)
        assert sharded.name == 'sharded/stream'
    g = np.zeros(X.shape[0], np.int32)
    g[::2] = 1
    assert TO.make_oracle(X, y, groups=g, method='stream',
                          device='cpu').n_pairs == JO.make_oracle(
        X, y, groups=g, method='stream').n_pairs


def test_budget_derives_block_rows_as_the_reference():
    X, y, _ = _case(m=200, n=10)
    for kw in (dict(memory_budget=1e-5), dict(), dict(stream_block=64),
               dict(memory_budget=1e-5, prefetch=2)):
        got = TO.make_oracle(X, y, method='stream', device='cpu', **kw)
        ref = JO.make_oracle(X, y, method='stream', **kw)
        assert got.block_rows == ref.block_rows
        assert got.block_resident_bytes() == ref.block_resident_bytes()
    assert TO.make_oracle(X, y, method='stream',
                          device='cpu').block_rows == 200


def test_budget_sizing_is_layout_native():
    """CSR sources size blocks by O(nnz_row), not the dense slab."""
    m, nn = 200, 4096
    Xc = random_tfidf(m=m, n=nn, nnz_per_row=8, seed=21)
    y = np.random.default_rng(22).normal(size=m)
    oc = _stream(Xc, y, memory_budget=1e-4)
    od = _stream(Xc.to_dense(), y, memory_budget=1e-4)
    assert od.block_rows < oc.block_rows
    assert as_row_block_source(Xc).row_bytes() == 12 * 8
    assert as_row_block_source(Xc.to_dense()).row_bytes() == 4 * nn


def test_degenerate_budget_warns():
    X, y, _ = _case(m=200, n=10)
    with pytest.warns(RuntimeWarning, match='mandatory O\\(m\\)'):
        o = _stream(X, y, memory_budget=1e-9)
    assert o.block_rows == 1
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        o2 = _stream(X, y, block_rows=64, memory_budget=1e-9)
    assert o2.block_rows == 64


def test_ranksvm_memory_capped_fit_matches_jax_package():
    """A budget below the fused residency (above the O(m) vectors) makes
    RankSVM(method='auto') stream, with prefetch 1 counted against it;
    the fit converges on the device driver and reaches the JAX package's
    objective within eps."""
    rng = np.random.default_rng(12)
    m, nn = 2000, 16
    X = rng.normal(size=(m, nn))
    y = X @ rng.normal(size=nn) + 0.1 * rng.normal(size=m)
    budget = 6e-5
    assert 6 * 4 * m / 2**30 < budget < projected_resident_gib(X)
    kw = dict(method='auto', memory_budget=budget, lam=1e-2, eps=1e-2,
              max_iter=100, prefetch=1)
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        svm = RankSVM(device='cpu', **kw).fit(X, y)
    assert isinstance(svm.oracle_, TO.StreamingOracle)
    assert svm.oracle_.prefetch == 1 and svm.report_.solver == 'device'
    assert 1 < svm.oracle_.block_rows < m
    assert svm.report_.converged
    assert svm.oracle_.block_resident_bytes() < budget * 2**30
    ref = JaxRankSVM(**kw).fit(X, y)
    assert svm.oracle_.block_rows == ref.oracle_.block_rows
    assert abs(svm.objective(X, y) - ref.objective(X, y)) <= 1e-2
    assert svm.ranking_error(X, y) < 0.1


@pytest.mark.parametrize('method', ['stream', 'auto'])
def test_ranksvm_stream_csr_matches_jax_package(method):
    """RankSVM on CSR through the streaming oracle (host driver, as
    solver='auto' keeps streamed CSR) against the JAX package's, and
    against the port's resident fit: objectives within eps."""
    data_kw = dict(m=300, n=512, nnz_per_row=40, seed=4)
    X = random_tfidf(**data_kw)
    Xj = jax_sparse.random_tfidf(**data_kw)
    y = X.matvec(np.random.default_rng(5).normal(size=512))
    eps = 1e-3
    kw = dict(method=method, memory_budget=projected_resident_gib(X) / 2,
              lam=1e-3, eps=eps, max_iter=200)
    with warnings.catch_warnings():
        warnings.simplefilter('error')       # a budget above the O(m) part
        svm = RankSVM(device='cpu', **kw).fit(X, y)
    assert svm.oracle_.name == 'stream/csr' and svm.report_.solver == 'host'
    assert 1 < svm.oracle_.block_rows < 300
    ref = JaxRankSVM(**kw).fit(Xj, y)
    assert ref.oracle_.name == 'stream/csr'
    assert svm.oracle_.block_rows == ref.oracle_.block_rows
    resident = RankSVM(device='cpu', lam=1e-3, eps=eps).fit(X, y)
    j = svm.objective(X, y)
    assert abs(j - ref.objective(Xj, y)) <= eps
    assert abs(j - resident.objective(X, y)) <= eps


# ------------------------------------------------- validation


@pytest.mark.parametrize('bad', [0, -3, 2.5, True, 'x', None])
def test_validate_block_rows_rejects(bad):
    with pytest.raises(ValueError, match='block'):
        _validate_block_rows(bad, 'block')


def test_oracle_block_params_validated():
    X, y, _ = _case(m=40, n=4)
    with pytest.raises(ValueError, match='positive'):
        _stream(X, y, block_rows=0)
    with pytest.raises(ValueError, match='fractional'):
        RankSVM(stream_block=3.5, device='cpu')
    assert _stream(X, y, block_rows=np.int64(8)).block_rows == 8


@pytest.mark.parametrize('bad', [-1, 2.5, True, 'x', 'AUTO'])
def test_validate_prefetch_rejects(bad):
    with pytest.raises(ValueError, match='prefetch'):
        _validate_prefetch(bad)
    with pytest.raises(ValueError, match='prefetch'):
        RankSVM(prefetch=bad, device='cpu')


def test_validate_prefetch_accepts():
    assert _validate_prefetch(None) is None
    assert _validate_prefetch('auto') is None
    assert _validate_prefetch(0) == 0
    assert _validate_prefetch(np.int64(2)) == 2
    assert _validate_prefetch(1.0) == 1


# --------------------------------------------- prefetch read-ahead (§9)


def test_prefetched_iter_blocks_bit_identical_memmap(tmp_path):
    rng = np.random.default_rng(30)
    X = rng.normal(size=(500, 6))
    mm = _memmap_of(X, tmp_path, 'x.f64', np.float64)
    y = rng.normal(size=500).astype(np.float32)
    for xv, yv in ((mm, y), (mm[50:450], y[50:450]),
                   (mm[20:][30:470], y[50:490])):
        src = MemmapBlockSource(xv)
        sync = list(src.iter_blocks(48, yv))
        pre = list(src.iter_blocks(48, yv, prefetch=2))
        assert len(sync) == len(pre) == src.n_blocks(48)
        for bs, bp in zip(sync, pre):
            assert (bs.lo, bs.hi) == (bp.lo, bp.hi)
            np.testing.assert_array_equal(bs.X, bp.X)
            np.testing.assert_array_equal(bs.aligned[0], bp.aligned[0])


@pytest.mark.parametrize('kind', ['memmap', 'csr', 'dense'])
def test_prefetch_depths_bit_identical(kind, tmp_path):
    """Both surfaces give the same bits at prefetch 0, 1 and 2."""
    rng = np.random.default_rng(31)
    X = rng.normal(size=(300, 8))
    y, w = rng.normal(size=300), rng.normal(size=8)
    feats = {'memmap': lambda: _memmap_of(X, tmp_path, 'x.f64', np.float64),
             'csr': lambda: random_tfidf(m=300, n=8, nnz_per_row=3,
                                         seed=32),
             'dense': lambda: X}[kind]()
    wt = torch.as_tensor(w, dtype=torch.float32)
    host, dev = [], []
    for depth in (0, 1, 2):
        o = _stream(feats, y, block_rows=64, prefetch=depth)
        host.append(o.loss_and_subgrad(w))
        dev.append(o.step_fn()(wt))
    for (l0, a0), (l1, a1) in zip(host[1:], dev[1:]):
        assert float(l0) == float(host[0][0])
        np.testing.assert_array_equal(a0, host[0][1])
        assert torch.equal(l1, dev[0][0]) and torch.equal(a1, dev[0][1])


def test_prefetch_auto_resolution(tmp_path):
    X, y, _ = _case(m=64, n=4)
    mm_src = as_row_block_source(_memmap_of(X, tmp_path))
    assert resolve_prefetch(mm_src, None) == 1
    assert resolve_prefetch(mm_src, 'auto') == 1
    assert resolve_prefetch(as_row_block_source(X), None) == 0
    csr = as_row_block_source(random_tfidf(m=64, n=8, nnz_per_row=2,
                                           seed=33))
    assert resolve_prefetch(csr, None) == 0
    assert resolve_prefetch(as_row_block_source(X), 3) == 3
    assert resolve_prefetch(mm_src, 0) == 0
    assert _stream(_memmap_of(X, tmp_path), y, block_rows=16).prefetch == 1
    assert _stream(X, y, block_rows=16).prefetch == 0


def test_prefetch_counts_against_block_residency(tmp_path):
    X, y, _ = _case(m=256, n=8)
    mm = _memmap_of(X, tmp_path)
    assert _stream(mm, y, block_rows=32,
                   prefetch=0).block_resident_bytes() == 32 * 8 * 4
    assert _stream(mm, y, block_rows=32,
                   prefetch=1).block_resident_bytes() == 2 * 32 * 8 * 4
    b0 = _stream(mm, y, memory_budget=1e-4, prefetch=0)
    b1 = _stream(mm, y, memory_budget=1e-4, prefetch=1)
    assert b1.block_rows <= b0.block_rows
    assert b1.block_resident_bytes() <= 1e-4 * 2**30


def test_readahead_propagates_fetch_errors():
    def fetch(i):
        if i == 2:
            raise RuntimeError('boom at 2')
        return i * 10

    ra = _ReadAhead(fetch, 4, 2)
    try:
        assert ra.get(0) == 0          # schedules 1 and the failing 2
        assert ra.get(1) == 10
        with pytest.raises(RuntimeError, match='boom at 2'):
            ra.get(2)
        assert ra.get(3) == 30         # the pool survives the error
    finally:
        ra.close()


def test_readahead_out_of_order_access_is_exact():
    ra = _ReadAhead(lambda i: i, 6, 2, wrap=True)
    try:
        for i in [3, 0, 5, 5, 1, 4, 2]:
            assert ra.get(i) == i
    finally:
        ra.close()


def test_prefetched_device_solver_matches_sync(tmp_path):
    """The wraparound read-ahead inside the device step gives the same
    fit as the synchronous stream."""
    X, y, _ = _case(m=240, n=8, seed=34)
    mm = _memmap_of(X, tmp_path)
    r0 = bmrm(_stream(mm, y, block_rows=64, prefetch=0), lam=1e-2,
              eps=1e-3, solver='device', max_iter=150)
    r1 = bmrm(_stream(mm, y, block_rows=64, prefetch=2), lam=1e-2,
              eps=1e-3, solver='device', max_iter=150)
    assert r0.stats.converged and r1.stats.converged
    assert r1.stats.obj_best == r0.stats.obj_best
    np.testing.assert_array_equal(r1.w, r0.w)
