"""Port parity: the regularization path (`repro_torch.core.bmrm.bmrm_path`,
`RankSVM.path`, the batched bundle QP and the batched counters) against
the JAX package's `repro.core.bmrm` on the same numpy inputs.

Bars: the batched QP's dual value within 1e-6 relative of the unbatched
call on each problem; batched counts bit-equal to the single calls on
each row; each sweep's per-lambda objective J(w) = R_emp(w) + lam ||w||^2,
evaluated in float64 by `tests/oracle_ref.py`, within eps of the
reference's same mode (both drivers stop with J(w_best) within eps of the
optimum, their gap taken from the dual). No test compares two modes of
one package across the reference's own 1e-3 relative bar, which the
reference itself misses on some installations (jax 0.9)."""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from repro.core import bmrm as JB  # noqa: E402
from repro.core import oracle as JO  # noqa: E402
from repro.core import ref as JR  # noqa: E402
from repro.core.ranksvm import RankSVM as JaxRankSVM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import bmrm as TB  # noqa: E402
from repro_torch.core import oracle as TO  # noqa: E402
from repro_torch.core import qp as TQ  # noqa: E402
from repro_torch.core.ranksvm import RankSVM  # noqa: E402
from oracle_ref import differential_fit_cases, ref_fit_objective  # noqa: E402
from torch_parity import n, t, torch_one_thread  # noqa: E402,F401

LAMS = [1e-1, 1e-2, 1e-3]
EPS = 1e-3
CASES = {name: (X, y, g) for name, X, y, g in differential_fit_cases()}


def _cadata():
    rng = np.random.default_rng(5)
    X = rng.integers(-4, 5, size=(96, 6)).astype(np.float64) * 0.5
    y = rng.integers(0, 5, size=96).astype(np.float64)
    return X, y


def _port(X, y, g=None, method='tree', **kw):
    return TO.make_oracle(X, y, groups=g, method=method, device='cpu', **kw)


# ------------------------------------------------------------- validation


@pytest.mark.parametrize('bad', [[], [np.nan], [np.inf], [-np.inf],
                                 [0.0], [-1e-3], [1e-2, np.nan],
                                 [1e-40], [1e39]])
def test_lambda_validation_rejects(bad):
    for validate in (TB._validate_lams, JB._validate_lams):
        with pytest.raises(ValueError, match='lambda'):
            validate(bad)


def test_lambda_validation_accepts_unsorted_duplicates():
    for lams in ([1e-3, 1e-1, 1e-3], np.asarray([2.0])):
        assert TB._validate_lams(lams) == JB._validate_lams(lams)
    assert TB.PATH_MODES == JB.PATH_MODES
    assert TB.DEFAULT_HYBRID_PREFIX == JB.DEFAULT_HYBRID_PREFIX


def test_path_mode_and_lams_checked_before_oracle_build(monkeypatch):
    X, y = _cadata()
    svm = RankSVM(device='cpu')

    def boom(*a, **k):
        raise AssertionError('oracle was built before validation')

    monkeypatch.setattr(svm, '_make_oracle', boom)
    with pytest.raises(ValueError, match='path mode'):
        svm.path(X, y, LAMS, mode='vmpa')
    with pytest.raises(ValueError, match='lambda'):
        svm.path(X, y, [0.0], mode='auto')


REJECTIONS = {
    'stream-vmap': (dict(method='stream', stream_block=16),
                    dict(mode='vmap'), 'vmap'),
    'stream-hybrid': (dict(method='stream', stream_block=16),
                      dict(mode='hybrid'), 'hybrid'),
    'host-vmap': ({}, dict(mode='vmap', solver='host'), 'host'),
    'host-hybrid': ({}, dict(mode='hybrid', solver='host'), 'host'),
    **{f'solver-typo-{mode}': ({}, dict(mode=mode, solver='devcie'),
                               'unknown solver')
       for mode in TB.PATH_MODES},
    **{f'hybrid-prefix-{bad}': ({}, dict(mode='hybrid', hybrid_prefix=bad),
                                'hybrid_prefix')
       for bad in (0, -1, 1.5, True)},
}


@pytest.mark.parametrize('case', list(REJECTIONS))
def test_path_rejections_match_reference(case):
    """The reference's rejections (test_path_sweep.py), raised by both
    packages with the same words."""
    X, y = _cadata()
    okw, pkw, match = REJECTIONS[case]
    for make, path in ((lambda: _port(X, y, **okw), TB.bmrm_path),
                       (lambda: JO.make_oracle(X, y, **okw), JB.bmrm_path)):
        with pytest.raises(ValueError, match=match):
            path(make(), LAMS, **pkw)
    with pytest.raises(ValueError, match='RankOracle'):
        TB.bmrm_path(lambda w: (0.0, w), LAMS)


@pytest.mark.parametrize('n_lams,dim,planes,m', [
    (1, 512, 64, 10000), (8, 512, 64, 10000), (3, 136, None, 2**20),
    (5, 49152, 16, 0)])
def test_path_state_gib_matches_reference(n_lams, dim, planes, m):
    got = TB.path_state_gib(n_lams, dim, planes, m=m)
    assert got == JB.path_state_gib(n_lams, dim, planes, m=m)
    assert got == pytest.approx(n_lams * TB.path_state_gib(1, dim, planes,
                                                           m=m))


# ----------------------------------------------------------- batched parts


def test_batched_qp_matches_unbatched_calls():
    """One batched solve against L unbatched ones (and the reference's
    float64 host solve): the dual value within 1e-6 relative."""
    rng = np.random.default_rng(7)
    K = 12
    Gs, bs, lams, masks = [], [], [], []
    for t_, lam in ((1, 0.5), (3, 0.5), (8, 0.02), (5, 1.0), (12, 1e-3)):
        A = rng.normal(size=(t_, 6))
        G = np.zeros((K, K))
        G[:t_, :t_] = A @ A.T
        b = np.zeros(K)
        b[:t_] = rng.normal(size=t_)
        Gs.append(G), bs.append(b), lams.append(lam)
        masks.append(np.arange(K) < t_)
    G, b = t(np.stack(Gs), torch.float32), t(np.stack(bs), torch.float32)
    lam, mask = t(lams, torch.float32), t(np.stack(masks))
    alphas, duals = TQ.solve_bundle_dual_torch(G, b, lam, mask, n_iter=256)
    assert alphas.shape == (5, K) and duals.shape == (5,)
    for i in range(5):
        a1, d1 = TQ.solve_bundle_dual_torch(G[i], b[i], lam[i], mask[i],
                                            n_iter=256)
        assert float(duals[i]) == pytest.approx(float(d1), rel=1e-6)
        np.testing.assert_allclose(n(alphas[i]), n(a1), atol=1e-4)
        assert float(alphas[i][~mask[i]].abs().sum()) == 0.0
        assert float(alphas[i].sum()) == pytest.approx(1.0, abs=1e-5)
        t_ = int(mask[i].sum())
        _, ref = JB.solve_bundle_dual(Gs[i][:t_, :t_], bs[i][:t_], lams[i])
        assert float(duals[i]) == pytest.approx(ref, rel=1e-3, abs=1e-4)


def _tie_heavy_rows(grouped):
    rng = np.random.default_rng(11 + grouped)
    m = 203
    y = rng.integers(0, 4, size=m).astype(np.float32)
    g = (np.sort(rng.integers(0, 6, size=m)).astype(np.int32)
         if grouped else None)
    P = (rng.integers(-6, 7, size=(3, m)) * 0.5).astype(np.float32)
    P[2] = P[0]                       # a duplicated row (duplicate lambdas)
    return P, y, g


@pytest.mark.parametrize('grouped', [False, True])
@pytest.mark.parametrize('engine,loss', [
    (e, l) for l in ('hinge', 'poshinge')
    for e in ('tree', 'blocked', 'pallas', 'auto')] + [('tree', 'toppush')])
def test_batched_counter_bit_equal_to_single_calls(engine, loss, grouped):
    P, y, g = _tie_heavy_rows(grouped)
    norm, pw = TO._loss_norm_weights(y, g, loss)
    v = None if pw is None else t(pw, torch.float32)
    count = TO._loss_counter(t(y), None if g is None else t(g), engine,
                             64, loss, v)
    args = (torch.tensor(1.0 / norm),) if loss == 'toppush' else ()
    batched = count(t(P), *args)
    for i in range(P.shape[0]):
        single = count(t(P[i]), *args)
        for got, want in zip(batched, single):
            assert got.shape == (P.shape[0],) + want.shape
            assert torch.equal(got[i], want)
    if loss == 'hinge' and g is None:
        c, d = JR.counts_ref(jnp.asarray(P[1]), jnp.asarray(y))
        np.testing.assert_array_equal(n(batched[0][1]), np.asarray(c))
        np.testing.assert_array_equal(n(batched[1][1]), np.asarray(d))


def test_batched_oracle_step_rows_match_single_steps():
    """The fused oracle's step over W (L, n): each row's loss and
    subgradient equal the single step's on that row's iterate (dense:
    one product each, within float32 reassociation; CSR: exact)."""
    from repro_torch.data.sparse import CSRMatrix
    X, y = _cadata()
    rng = np.random.default_rng(3)
    W = rng.integers(-4, 5, size=(3, X.shape[1])) * 0.25
    for feats in (X, CSRMatrix.from_dense(X)):
        orc = _port(feats, y, csr_rmatvec='device')
        assert orc.supports_path_vmap
        step = orc.step_fn()
        loss, A = step(t(W, torch.float32))
        for i in range(3):
            l1, a1 = step(t(W[i], torch.float32))
            assert float(loss[i]) == pytest.approx(float(l1), rel=1e-6)
            np.testing.assert_allclose(n(A[i]), n(a1), rtol=1e-6, atol=1e-7)
    assert not _port(X, y, method='stream', stream_block=16
                     ).supports_path_vmap


# ------------------------------------------- sweeps against the reference


SWEEPS = {'tree': ('ungrouped-mixed', 'tree'),
          'pairs': ('ungrouped-tieheavy', 'pairs'),
          'grouped': ('grouped-with-pairless', 'tree')}


@pytest.mark.parametrize('mode', ['sequential', 'vmap', 'hybrid'])
@pytest.mark.parametrize('sweep', list(SWEEPS))
def test_path_matches_reference_same_mode(sweep, mode):
    """Each mode of the port against the reference's same mode on the
    quantized differential cases: every lambda converged, with J in
    float64 within eps of the reference's; the solver tags agree."""
    name, method = SWEEPS[sweep]
    X, y, g = CASES[name]
    rj = JB.bmrm_path(JO.make_oracle(X, y, groups=g, method=method), LAMS,
                      mode=mode, eps=EPS, max_iter=400)
    rt = TB.bmrm_path(_port(X, y, g, method=method), LAMS, mode=mode,
                      eps=EPS, max_iter=400)
    assert len(rt) == len(LAMS)
    for lam, a, b in zip(LAMS, rt, rj):
        assert a.stats.converged and b.stats.converged
        assert a.stats.solver == b.stats.solver
        assert a.stats.gap < EPS
        ja = ref_fit_objective(X, y, g, 'hinge', lam, a.w)
        jb = ref_fit_objective(X, y, g, 'hinge', lam, b.w)
        assert abs(ja - jb) <= EPS
        assert a.stats.obj_best == pytest.approx(ja, abs=1e-5)


def test_batched_sweep_from_one_converted_state():
    """Both packages' batched drivers start from one L-leading state (the
    reference's `init_path_state` broadcast of a sequential fit's planes,
    carried across by `convert`) and reach the same objectives."""
    X, y, g = CASES['ungrouped-mixed']
    jo = JO.make_oracle(X, y, method='tree')
    seed = JB.bmrm(jo, lam=LAMS[0], eps=EPS, solver='device',
                   max_iter=400).state
    K, dim = seed.A.shape
    batched = JB.init_path_state(dim, K, 2, state=seed)
    fields = {f: np.asarray(getattr(batched, f)) for f in batched._fields}
    state = convert.bundle_state_from_arrays(fields, device='cpu')
    assert tuple(state.A.shape) == (2, K, dim) and state.n_active.shape == (2,)
    lams = LAMS[1:]
    rj = JB._bmrm_path_vmap(jo, lams, dim=dim, eps=EPS, max_iter=400,
                            w0=None, max_planes=K, sync_every=8,
                            qp_iters=128, callback=None, init_state=seed)
    rt = TB._bmrm_path_vmap(_port(X, y), lams, dim=dim, eps=EPS,
                            max_iter=400, w0=None, max_planes=K,
                            sync_every=8, qp_iters=128, callback=None,
                            init_state=state)
    for lam, a, b in zip(lams, rt, rj):
        assert a.stats.converged and b.stats.converged
        assert abs(ref_fit_objective(X, y, None, 'hinge', lam, a.w)
                   - ref_fit_objective(X, y, None, 'hinge', lam, b.w)) <= EPS
    with pytest.raises(ValueError, match='lead'):
        convert.bundle_state_from_arrays(dict(fields, j_best=np.zeros(3)),
                                         device='cpu')
    # a reference PathPoint crosses as the port's
    svm = JaxRankSVM(eps=EPS, method='tree', max_iter=400)
    (point,) = svm.path(X, y, [1e-2], mode='sequential')
    mine = convert.path_point_from_reference(point)
    assert mine.lam == point.lam and mine.report.solver == 'device'
    np.testing.assert_array_equal(mine.w, point.w)
    assert mine.report.iterations == point.report.iterations


# ---------------------------------------------------- driver behaviours


def test_done_mask_freezes_converged_lambdas():
    X, y, _ = CASES['ungrouped-mixed']
    rv = TB.bmrm_path(_port(X, y), [1.0, 1e-3], mode='vmap', eps=EPS,
                      max_iter=400)
    easy, hard = rv
    assert easy.stats.converged and hard.stats.converged
    assert easy.stats.iterations < hard.stats.iterations
    for res in rv:
        assert len(res.stats.loss_history) == res.stats.iterations
        assert len(res.stats.gap_history) == res.stats.iterations
        assert np.all(np.isfinite(res.stats.loss_history))
        # per-lambda time shares: seconds is the sum of the step shares
        assert res.stats.seconds == pytest.approx(
            sum(res.stats.oracle_seconds), rel=1e-9)
        assert len(res.stats.oracle_seconds) == res.stats.iterations
    assert easy.stats.gap < EPS and bool(easy.state.done)
    # the frozen slice warm-starts a further fit
    again = TB.bmrm(_port(X, y), lam=1e-3, eps=EPS, solver='device',
                    max_iter=400, state=easy.state)
    assert again.stats.converged


def test_duplicate_lambdas_and_estimator_left_at_last_lambda():
    X, y, _ = CASES['ungrouped-mixed']
    svm = RankSVM(eps=EPS, method='tree', max_iter=400, device='cpu')
    pts = svm.path(X, y, [1e-2, 1e-1, 1e-2], mode='vmap')
    assert [p.lam for p in pts] == [1e-2, 1e-1, 1e-2]
    assert pts[0].report.objective == pytest.approx(pts[2].report.objective,
                                                    rel=1e-6)
    np.testing.assert_allclose(pts[0].w, pts[2].w, rtol=1e-5, atol=1e-7)
    assert svm.lam == 1e-2 and svm.report_.solver == 'vmap'
    np.testing.assert_array_equal(svm.w_, pts[-1].w)
    # the refit handle comes from the last lambda's state, as in the
    # reference
    inc = svm.incremental_
    assert inc.ledger.n_planes == int(inc.state.n_active) > 0
    assert svm.objective(X, y) == pytest.approx(
        ref_fit_objective(X, y, None, 'hinge', 1e-2, svm.w_), rel=1e-6)


def test_auto_mode_resolution(monkeypatch):
    """'auto' stays sequential on the CPU, batches when the oracle is on
    the card (the probe monkeypatched, as test_path_sweep.py does for the
    reference's backend), never batches a stream, and takes the host
    driver below the float32 floor."""
    X, y, _ = CASES['ungrouped-tieheavy']
    fused = _port(X, y)
    lams = [1e-2, 1e-3]
    assert all(r.stats.solver == 'device' for r in TB.bmrm_path(
        fused, lams, mode='auto', eps=EPS, max_iter=400))
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        assert TB.bmrm_path(fused, [1e-2], mode='auto', eps=1e-7,
                            max_iter=50)[0].stats.solver == 'host'
    monkeypatch.setattr(TB, '_path_on_cpu', lambda oracle: False)
    assert all(r.stats.solver == 'vmap' for r in TB.bmrm_path(
        fused, lams, mode='auto', eps=EPS, max_iter=400))
    assert TB.bmrm_path(fused, [1e-2], mode='auto', eps=EPS, max_iter=400,
                        memory_budget=64.0)[0].stats.solver == 'vmap'
    stream = _port(X, y, method='stream', stream_block=16)
    assert all(r.stats.solver == 'device' for r in TB.bmrm_path(
        stream, lams, mode='auto', eps=EPS, max_iter=400))


def test_explicit_vmap_below_f32_floor_warns():
    X, y, _ = CASES['ungrouped-tieheavy']
    with pytest.warns(RuntimeWarning, match='noise floor'):
        res = TB.bmrm_path(_port(X, y), [1e-2], mode='vmap', eps=1e-7,
                           max_iter=8)
    assert res[0].stats.solver == 'vmap'


@pytest.mark.parametrize('mode,prefix', [('vmap', 2), ('hybrid', 1)])
def test_over_budget_falls_back_to_sequential(mode, prefix):
    X, y, _ = CASES['ungrouped-tieheavy']
    orc = _port(X, y)
    with pytest.warns(RuntimeWarning, match='memory_budget'):
        rb = TB.bmrm_path(orc, LAMS, mode=mode, hybrid_prefix=prefix,
                          eps=EPS, max_iter=400, memory_budget=1e-9)
    rs = TB.bmrm_path(orc, LAMS, mode='sequential', eps=EPS, max_iter=400)
    for a, b in zip(rb, rs):
        assert a.stats.solver == 'device'
        assert a.stats.obj_best == pytest.approx(b.stats.obj_best, rel=1e-6)


@pytest.mark.parametrize('prefix', [2, 10])
def test_hybrid_prefix_is_the_sequential_sweep(prefix):
    """The hybrid's prefix IS the sequential sweep (same fits, same warm
    chain); a prefix covering the grid is the sequential sweep whole."""
    X, y, _ = CASES['ungrouped-tieheavy']
    orc = _port(X, y)
    rh = TB.bmrm_path(orc, LAMS, mode='hybrid', hybrid_prefix=prefix,
                      eps=EPS, max_iter=400)
    rs = TB.bmrm_path(orc, LAMS, mode='sequential', eps=EPS, max_iter=400)
    k = min(prefix, len(LAMS))
    for a, b in zip(rh[:k], rs[:k]):
        assert a.stats.iterations == b.stats.iterations
        np.testing.assert_array_equal(a.w, b.w)
    assert [r.stats.solver for r in rh[k:]] == ['vmap'] * (len(LAMS) - k)
    assert all(r.stats.converged for r in rh)
