"""Port parity of `RankSVM.refit`'s mode resolution against the JAX
package's, scenario by scenario as tests/test_incremental.py runs them:
ledger and w-only appends, retiring an appended block, a base retire
under mode='auto' (w-only) and mode='ledger' (rebuild), a host-driver
fit and loss='poshinge' (no ledger; 'ledger' raises, 'auto' goes
w-only), and the error paths; and that a dropped estimator is freed
without the cycle collector.

Bars: the same resolved mode, planes carried or not alike, the same
appended and retired ids and delta rows, both refits converged, and the
objectives within eps of each other (each solve stops within eps of the
same optimum). Both packages run with max_planes=32 and qp_iters=64,
which keeps the port's eager bundle QP on the CPU and the reference's
compilations short."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from repro.core.ranksvm import RankSVM as JaxRankSVM  # noqa: E402
from repro.data import BlockStore as JBlockStore  # noqa: E402
from repro_torch.core.ranksvm import RankSVM  # noqa: E402
from repro_torch.data import BlockStore, cadata_drift  # noqa: E402
from torch_parity import torch_one_thread  # noqa: E402,F401

EPS = 1e-3
HOST_EPS = 1e-2


def _split_store(cls, X, y):
    store = cls()
    half = len(y) // 2
    store.append(np.asarray(X)[:half], y[:half])
    store.append(np.asarray(X)[half:], y[half:])
    return store


def _scenario(name, pkg, base, Xd, yd):
    """Run one refit scenario of tests/test_incremental.py in one
    package; returns (reports, estimator)."""
    port = pkg == 'port'
    Svm = RankSVM if port else JaxRankSVM
    kw = dict(method='tree', eps=EPS, max_iter=400, max_planes=32,
              qp_iters=64)
    if port:
        kw['device'] = 'cpu'
    if name == 'ledger-append':
        svm = Svm(**kw).fit(base.X, base.y)
        return [svm.refit(Xd, yd, mode='ledger')], svm
    if name == 'w-only-append':
        svm = Svm(**kw).fit(base.X, base.y)
        return [svm.refit(Xd, yd, mode='w-only')], svm
    if name == 'retire-appended':
        svm = Svm(**kw).fit(base.X, base.y)
        r1 = svm.refit(Xd, yd, mode='ledger')
        return [r1, svm.refit(retire=list(r1.appended), mode='ledger')], svm
    if name in ('auto-base-retire', 'ledger-base-retire'):
        store = _split_store(BlockStore if port else JBlockStore, base.X,
                             base.y)
        svm = Svm(**kw).fit(store)
        assert svm.incremental_.ledger.base_bids == frozenset({0, 1})
        mode = 'auto' if name == 'auto-base-retire' else 'ledger'
        return [svm.refit(Xd, yd, retire=[0], mode=mode)], svm
    if name == 'host-auto':
        # eps 1e-2 keeps the reference's host driver, which compiles anew
        # as its plane count grows, to a few iterations
        svm = Svm(solver='host', **dict(kw, eps=HOST_EPS)).fit(base.X,
                                                                base.y)
        assert svm.incremental_.ledger is None
        with pytest.raises(ValueError, match='w-only'):
            svm.refit(Xd, yd, mode='ledger')
        return [svm.refit(Xd, yd, mode='auto')], svm
    if name == 'poshinge-auto':
        svm = Svm(loss='poshinge', **kw).fit(base.X, base.y)
        assert svm.incremental_.ledger is None
        with pytest.raises(ValueError, match='LEDGER_LOSSES'):
            svm.refit(Xd, yd, mode='ledger')
        return [svm.refit(Xd, yd, mode='auto')], svm
    raise AssertionError(name)


@pytest.mark.parametrize('name', ['ledger-append', 'w-only-append',
                                  'retire-appended', 'auto-base-retire',
                                  'ledger-base-retire', 'host-auto',
                                  'poshinge-auto'])
def test_refit_modes_match_reference(name):
    base, Xd, yd = cadata_drift(m=150, m_delta=30, seed=1)
    got, svm = _scenario(name, 'port', base, Xd, yd)
    want, _ = _scenario(name, 'reference', base, Xd, yd)
    for g, w in zip(got, want):
        assert g.mode == w.mode
        assert (g.n_planes > 0) == (w.n_planes > 0)
        assert (g.appended, g.retired, g.delta_rows) == (
            w.appended, w.retired, w.delta_rows)
        assert g.fit.converged and w.fit.converged
        assert abs(g.fit.objective - w.fit.objective) <= (
            HOST_EPS if name == 'host-auto' else EPS)
    assert svm.refit_report_ is got[-1]
    if name == 'ledger-base-retire':
        assert got[0].revalidate_seconds > 0
    if name == 'retire-appended':
        assert svm.incremental_.store.m == len(base.y)


def test_refit_error_paths_match_reference():
    base, Xd, yd = cadata_drift(m=200, m_delta=20)
    with pytest.raises(RuntimeError, match='fit'):
        RankSVM(device='cpu').refit(Xd, yd)
    svm = RankSVM(method='tree', eps=EPS, device='cpu').fit(base.X, base.y)
    with pytest.raises(ValueError, match='refit mode'):
        svm.refit(Xd, yd, mode='planes')
    with pytest.raises(ValueError, match='append.*retire'):
        svm.refit()
    with pytest.raises(ValueError, match='both X and y'):
        svm.refit(Xd)
    svm.refit(Xd, yd)
    with pytest.raises(ValueError, match='retired every block'):
        svm.refit(retire=list(svm.incremental_.store.block_ids))
    with pytest.raises(ValueError, match='carries its own'):
        RankSVM(device='cpu').fit(BlockStore(), base.y)
    with pytest.raises(ValueError, match='empty'):
        RankSVM(device='cpu').fit(BlockStore())


@pytest.mark.parametrize('kind', ['fit', 'path', 'refit'])
def test_dropped_estimator_is_freed_without_the_cycle_collector(kind):
    """The `incremental_` handle holds no reference back to its
    estimator, so a dropped estimator, with its oracle's tensors (on the
    card, the features and counting scratch), is freed as soon as its
    last reference goes, not at the next run of the cycle collector."""
    import gc
    import weakref
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 5)).astype(np.float32)
    y = rng.integers(0, 3, size=300).astype(np.float32)
    gc.collect()
    gc.disable()
    try:
        svm = RankSVM(device='cpu', max_planes=32, qp_iters=64)
        if kind == 'path':
            svm.path(X, y, [1e-1, 1e-2])
        else:
            svm.fit(X, y)
        if kind == 'refit':
            svm.refit(X[:50], y[:50])
        refs = weakref.ref(svm), weakref.ref(svm.oracle_)
        del svm
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
