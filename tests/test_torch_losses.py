"""Port parity of the loss axis (DESIGN.md §12): the weighted counting
pass, the 'toppush' and 'poshinge' losses through every oracle, their
metrics and the estimator, against the JAX package's `repro.core` and the
float64 brute force of `tests/oracle_ref.py`.

Tolerances:

* d, and every count, bit-equal; TopPush's coefficients bit-equal to the
  reference's, and on the quantized `differential_fit_cases()` exactly
  N+ times the brute-force subgradient in the scores;
* c~ (float32 sums in another order than the reference's) within 1e-6
  of sum(v);
* losses and subgradients at `tests/test_losses.py`'s bars (1e-5
  relative for 'toppush', 5e-5 for 'poshinge', whose 1/log2 weights
  are irrational);
* the metrics within 1e-6; fit objectives within the reference's eps
  envelope, 2 eps + 1e-5."""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oracle_ref import (LOSS_REFS, differential_fit_cases,  # noqa: E402
                        poshinge_weights_ref, quantized_weights,
                        ref_fit_objective)
from repro.core import counts as JC  # noqa: E402
from repro.core import oracle as JO  # noqa: E402
from repro.core import rank_loss as JRL  # noqa: E402
from repro.core.ranksvm import RankSVM as JaxRankSVM  # noqa: E402
from repro_torch import core as TCORE  # noqa: E402
from repro_torch.core import counts as TC  # noqa: E402
from repro_torch.core import oracle as TO  # noqa: E402
from repro_torch.core import rank_loss as TRL  # noqa: E402
from repro_torch.core.ranksvm import RankSVM  # noqa: E402
from torch_parity import n, t, torch_one_thread  # noqa: E402,F401

CASES = list(differential_fit_cases())
CASE_IDS = [c[0] for c in CASES]
TOL = {'toppush': dict(rtol=1e-5, atol=1e-6),
       'poshinge': dict(rtol=5e-5, atol=1e-5)}
NEW_LOSSES = ('toppush', 'poshinge')


def _weighted_case(kind, m, seed):
    rng = np.random.default_rng(seed)
    if kind == 'ties':
        p = (rng.integers(-4, 5, size=m) * 0.5).astype(np.float32)
        y = rng.integers(0, 4, size=m).astype(np.float32)
    else:
        p = rng.normal(size=m).astype(np.float32)
        y = rng.normal(size=m).astype(np.float32)
    v = (1.0 / np.log2(2.0 + rng.integers(0, 50, size=m))).astype(
        np.float32)
    g = rng.integers(0, 5, size=m).astype(np.int32)
    return p, y, v, g


WEIGHTED = [(kind, m) for kind in ('ties', 'distinct')
            for m in (1, 7, 64, 1025)]


@pytest.mark.parametrize('grouped', [False, True], ids=['flat', 'grouped'])
@pytest.mark.parametrize('kind,m', WEIGHTED)
def test_weighted_counts_match_the_reference(kind, m, grouped):
    """Tree and blocked engines (block 64, so several blocks): d
    bit-equal to the reference's weighted tree and to the unweighted
    counts, c~ within 1e-6 of sum(v)."""
    p, y, v, g = _weighted_case(kind, m, seed=m + 7 * grouped)
    if grouped:
        cj, dj = JC.counts_weighted_grouped_fused(
            jnp.asarray(p), jnp.asarray(y), jnp.asarray(g), jnp.asarray(v))
        _, du = TC.counts_grouped_fused(t(p), t(y), t(g))
    else:
        cj, dj = JC.counts_weighted_fused(jnp.asarray(p), jnp.asarray(y),
                                          jnp.asarray(v))
        _, du = TC.counts_fused(t(p), t(y))
    gt = t(g) if grouped else None
    for engine in ('tree', 'blocked'):
        cw, d = TC.counts_dispatch(t(p), t(y), gt, engine=engine, block=64,
                                   v=t(v))
        assert d.dtype == torch.int32 and cw.dtype == torch.float32
        np.testing.assert_array_equal(n(d), np.asarray(dj))
        np.testing.assert_array_equal(n(d), n(du))
        assert np.abs(n(cw) - np.asarray(cj)).max(initial=0.0) <= \
            1e-6 * max(float(v.sum()), 1.0)


def test_weighted_tree_counts_every_level_and_the_padding():
    """c~ against the O(m^2) definition in float64 at a size past a
    power of two, where the tree pads and uses every level."""
    p, y, v, _ = _weighted_case('ties', 1500, seed=5)
    cw, d = TC.counts_weighted_fused(t(p), t(y), t(v))
    p64, y64, v64 = (a.astype(np.float64) for a in (p, y, v))
    mask = (y[None, :] > y[:, None]) & (p[None, :] < (p + np.float32(1))
                                        [:, None])
    np.testing.assert_allclose(n(cw), (mask * v64[None, :]).sum(axis=1),
                               rtol=0, atol=1e-6 * v64.sum())
    dmask = (y64[None, :] < y64[:, None]) & (
        p[None, :] > (p - np.float32(1))[:, None])
    np.testing.assert_array_equal(n(d), dmask.sum(axis=1))


def test_weighted_tree_builds_one_level_at_a_time(monkeypatch):
    """The weighted tree sorts each level inside its blocks once and lets
    it go before the next: no two levels' sorted blocks live at once."""
    import weakref
    alive, sort = [], torch.sort

    def spy(x, *args, **kw):
        out = sort(x, *args, **kw)
        if x.dim() == 2:
            assert all(r() is None for r in alive), 'an older level lives'
            alive.append(weakref.ref(out.values))
        return out

    monkeypatch.setattr(torch, 'sort', spy)
    for m in (5, 64, 1000):
        p, y, v, _ = _weighted_case('ties', m, seed=m)
        alive.clear()
        cw, d = TC.counts_weighted_fused(t(p), t(y), t(v))
        assert len(alive) == (m - 1).bit_length()
        np.testing.assert_array_equal(n(d),
                                      n(TC.counts_fused(t(p), t(y))[1]))


# -------------------------------------------------------------- metrics


def _metric_case(m, grouped, seed):
    rng = np.random.default_rng(seed)
    p = (rng.integers(-4, 5, size=m) * 0.5).astype(np.float32)
    y = rng.integers(0, 4, size=m).astype(np.float32)
    g = (rng.integers(0, 4, size=m) * 1000 + 3).astype(np.int32) \
        if grouped else None
    return p, y, g


_jax_top1 = jax.jit(JRL.top1_error)
_jax_pwe = jax.jit(JRL.position_weighted_error)


@pytest.mark.parametrize('grouped', [False, True], ids=['flat', 'grouped'])
@pytest.mark.parametrize('m', [9, 200])
def test_metrics_match_the_reference(m, grouped):
    p, y, g = _metric_case(m, grouped, seed=m)
    gj = None if g is None else jnp.asarray(g)
    gt = None if g is None else t(g)
    for port, ref in ((TRL.top1_error, _jax_top1),
                      (TRL.position_weighted_error, _jax_pwe)):
        got = port(t(p), t(y), gt)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(ref(
            jnp.asarray(p), jnp.asarray(y), gj)), rtol=1e-6, atol=1e-7)
    v, W = TRL.poshinge_weights(t(y), gt)
    vj, Wj = JRL.poshinge_weights(y, g)
    np.testing.assert_allclose(v, vj, rtol=1e-6)
    np.testing.assert_allclose(W, Wj, rtol=1e-6)
    vr, Wr = poshinge_weights_ref(y, g)
    np.testing.assert_allclose(v, vr, rtol=1e-6)
    np.testing.assert_allclose(W, Wr, rtol=1e-6)
    # the device twin of the weights
    gi = torch.zeros(m, dtype=torch.int64) if g is None else \
        TRL._compact_ids(t(g)).long()
    vt, lower = TRL._utility_rank_weights(t(y), gi)
    np.testing.assert_allclose(n(vt), vr, rtol=1e-6)
    np.testing.assert_allclose(float((vt * lower).sum()), Wr, rtol=1e-6)


def test_metrics_at_their_ends():
    """A perfect ranking scores 0 on both metrics, a reversed one 1; equal
    weights make the position-weighted error the pairwise one."""
    y = t(np.array([0.0, 1.0, 2.0, 3.0], np.float32))
    assert float(TRL.top1_error(y, y)) == 0.0
    assert float(TRL.top1_error(-y, y)) == 1.0
    assert float(TRL.position_weighted_error(y, y)) == 0.0
    assert float(TRL.position_weighted_error(-y, y)) == pytest.approx(1.0)
    yb = t(np.array([0.0, 0.0, 1.0, 0.0], np.float32))
    p = t(np.array([0.5, 2.0, 1.0, -1.0], np.float32))
    assert float(TRL.position_weighted_error(p, yb)) == pytest.approx(
        float(TRL.ranking_error(p, yb)))
    assert float(TRL.top1_error(p, yb)) == 1.0
    assert float(TRL.position_weighted_error(p[:1], yb[:1])) == 0.0


def test_core_exports_the_loss_axis():
    for name in ('TopPushOracle', 'top1_error', 'position_weighted_error',
                 'poshinge_weights', 'LOSSES'):
        assert hasattr(TCORE, name), name
    assert TCORE.LOSSES == JO.LOSSES
    assert TCORE.joachims.counts_rlevel


# --------------------------------------------------------------- oracles


def _ref_at(loss, X, y, g, w):
    val, sub = LOSS_REFS[loss](np.asarray(X, np.float64) @ w, y, g)
    return val, np.asarray(X, np.float64).T @ sub


def _dense(a):
    return a.detach().cpu().double().numpy() if torch.is_tensor(a) else \
        np.asarray(a, np.float64)


@pytest.mark.parametrize('case', CASES, ids=CASE_IDS)
@pytest.mark.parametrize('method', ['tree', 'pairs', 'auto', 'stream'])
@pytest.mark.parametrize('loss', NEW_LOSSES)
def test_loss_subgrad_match_bruteforce(loss, method, case):
    name, X, y, g = case
    oracle = TO.make_oracle(X, y, groups=g, method=method, loss=loss,
                            stream_block=7 if method == 'stream' else None,
                            device='cpu')
    assert oracle.loss == loss
    rng = np.random.default_rng(sum(map(ord, name + method)))
    for w in quantized_weights(rng, X.shape[1], k=2):
        got_l, got_a = oracle.loss_and_subgrad(w)
        ref_l, ref_a = _ref_at(loss, X, y, g, w)
        np.testing.assert_allclose(float(got_l), ref_l, **TOL[loss])
        np.testing.assert_allclose(_dense(got_a), ref_a, **TOL[loss])


@pytest.mark.parametrize('engine', ['tree', 'blocked', 'pallas', 'auto'])
@pytest.mark.parametrize('loss', NEW_LOSSES)
def test_every_engine_reaches_the_loss(loss, engine):
    """Every engine through the fused oracle: 'toppush' ignores it,
    'poshinge' counts with the weighted tree ('pallas', 'auto') or the
    weighted pairwise pass ('blocked')."""
    name, X, y, g = CASES[3]
    oracle = TO.make_oracle(X, y, groups=g, loss=loss, engine=engine,
                            device='cpu')
    for w in quantized_weights(np.random.default_rng(7), X.shape[1], k=2):
        got_l, got_a = oracle.loss_and_subgrad(w)
        ref_l, ref_a = _ref_at(loss, X, y, g, w)
        np.testing.assert_allclose(float(got_l), ref_l, **TOL[loss])
        np.testing.assert_allclose(_dense(got_a), ref_a, **TOL[loss])


_jax_toppush = jax.jit(JO._toppush_loss_coeffs)


@pytest.mark.parametrize('case', CASES, ids=CASE_IDS)
def test_toppush_coefficients_are_exact(case):
    """The coefficients equal the reference's bit for bit, and N+ times
    the brute-force subgradient in the scores exactly: the leftmost
    attainer of each lower set's max takes the +1."""
    name, X, y, g = case
    gr = None if g is None else TO._validate_groups(g, len(y))
    norm, _ = TO._loss_norm_weights(np.asarray(y, np.float32), gr,
                                    'toppush')
    assert norm == JO._toppush_norm(np.asarray(y, np.float32), gr)
    rng = np.random.default_rng(sum(map(ord, name)))
    for w in quantized_weights(rng, X.shape[1], k=2):
        p = (np.asarray(X, np.float64) @ w).astype(np.float32)
        lt, ct = TO._toppush_loss_coeffs(
            t(p), t(y, torch.float32), None if gr is None else t(gr),
            1.0 / norm)
        lj, cj = _jax_toppush(
            jnp.asarray(p), jnp.asarray(y, jnp.float32),
            None if gr is None else jnp.asarray(gr), 1.0 / norm)
        np.testing.assert_array_equal(n(ct), np.asarray(cj))
        _, sub = LOSS_REFS['toppush'](p.astype(np.float64), y, g)
        np.testing.assert_array_equal(n(ct).astype(np.float64), sub * norm)
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)


def test_toppush_oracle_is_the_tree_oracle_by_name():
    name, X, y, g = CASES[1]
    top = TO.TopPushOracle(X, y, device='cpu')
    tree = TO.TreeOracle(X, y, loss='toppush', device='cpu')
    assert top.name == 'toppush' and tree.name == 'tree/toppush'
    assert top.loss == 'toppush' and top.norm == tree.norm
    w = quantized_weights(np.random.default_rng(3), X.shape[1])
    (l1, a1), (l2, a2) = top.loss_and_subgrad(w), tree.loss_and_subgrad(w)
    assert torch.equal(l1, l2) and torch.equal(a1, a2)
    assert TO.TopPushOracle(X, y, engine='blocked', device='cpu').name == \
        'toppush[blocked]'


@pytest.mark.parametrize('case', CASES, ids=CASE_IDS)
@pytest.mark.parametrize('loss', NEW_LOSSES)
def test_empirical_risk_matches_the_reference(loss, case):
    name, X, y, g = case
    w = quantized_weights(np.random.default_rng(11), X.shape[1])
    p = (np.asarray(X, np.float64) @ w).astype(np.float32)
    got = TO.empirical_risk(p, y, g, loss=loss, device='cpu')
    np.testing.assert_allclose(got, JO.empirical_risk(p, y, g, loss=loss),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, LOSS_REFS[loss](p, y, g)[0],
                               **TOL[loss])


def test_norms_and_weights_match_the_reference():
    for name, X, y, g in CASES:
        y32 = np.asarray(y, np.float32)
        gr = None if g is None else TO._validate_groups(g, len(y))
        for loss in ('hinge',) + NEW_LOSSES:
            norm, v = TO._loss_norm_weights(y32, gr, loss)
            nj, vj = JO._loss_norm_weights(y32, gr, loss)
            assert norm == nj, (name, loss)
            assert (v is None) == (vj is None)
            if v is not None:
                np.testing.assert_array_equal(v, vj)
        o = TO.make_oracle(X, y, groups=g, loss='poshinge', device='cpu')
        oj = JO.make_oracle(X, y, groups=g, loss='poshinge')
        assert o.norm == oj.norm and o.n_pairs == oj.n_pairs


# --------------------------------------------------------------- streams


@pytest.mark.parametrize('loss', NEW_LOSSES)
def test_streamed_calls_equal_the_resident_ones(loss):
    """Host passes and the device step of the streaming oracle against
    the fused oracle: the same counting pass on the same float32 scores,
    so the coefficients match and the sums agree to rounding."""
    name, X, y, g = CASES[3]
    fused = TO.make_oracle(X, y, groups=g, loss=loss, device='cpu')
    for prefetch in (0, 1):
        so = TO.make_oracle(X, y, groups=g, method='stream', loss=loss,
                            stream_block=5, prefetch=prefetch, device='cpu')
        assert so.name == f'stream/dense/{loss}' and so.norm == fused.norm
        step = so.step_fn()
        for w in quantized_weights(np.random.default_rng(5), X.shape[1],
                                   k=2):
            lf, af = fused.loss_and_subgrad(w)
            wt = torch.as_tensor(w, dtype=torch.float32)
            for got_l, got_a in (so.loss_and_subgrad(w), step(wt)):
                np.testing.assert_allclose(float(got_l), float(lf),
                                           rtol=1e-6, atol=1e-7)
                np.testing.assert_allclose(_dense(got_a), _dense(af),
                                           rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('loss', NEW_LOSSES)
def test_stream_charges_the_loss_counting_peak(loss):
    """Under a budget whose half-remainder is below the loss's counting
    peak, the blocks get what the peak leaves: fewer rows than the
    hinge's (the reference's rule), exactly the charged formula."""
    rng = np.random.default_rng(9)
    m, nn = 4000, 64
    X = rng.normal(size=(m, nn)).astype(np.float32)
    y = rng.integers(0, 5, size=m).astype(np.float32)
    count = TO.LOSS_COUNT_BYTES[loss] * m
    budget = (24 * m + 1.5 * count) / 2**30
    hinge = TO.make_oracle(X, y, method='stream', memory_budget=budget,
                           device='cpu')
    so = TO.make_oracle(X, y, method='stream', memory_budget=budget,
                        loss=loss, device='cpu')
    free = budget * 2**30 - 24 * m
    assert hinge.block_rows == int(free * 0.5 // (4 * nn))
    assert so.block_rows == int((free - count) // (4 * nn))
    assert so.block_rows < hinge.block_rows
    assert so.block_resident_bytes() + count <= free
    assert TO._auto_stream_block(m, 4 * nn, 1.0, count) == \
        TO._auto_stream_block(m, 4 * nn, 1.0) == \
        JO._auto_stream_block(m, 4 * nn, 1.0)
    with pytest.warns(RuntimeWarning, match='mandatory O\\(m\\)'):
        TO._auto_stream_block(m, 4 * nn, 1e-9, count)


# ------------------------------------------------------------- estimator


@pytest.mark.parametrize('loss,solver,grouped', [
    ('toppush', 'host', True), ('toppush', 'device', False),
    ('poshinge', 'host', False), ('poshinge', 'device', True)])
def test_fit_objective_within_the_reference_envelope(loss, solver, grouped):
    """The port's fit and the JAX package's each land within eps of the
    optimum: their float64 reference objectives agree to 2 eps + 1e-5,
    and `objective()` evaluates the estimator's own loss."""
    _, X, y, g = CASES[3 if grouped else 0]
    lam, eps = 0.05, 1e-4
    svm = RankSVM(lam=lam, eps=eps, solver=solver, loss=loss,
                  device='cpu').fit(X, y, groups=g)
    assert svm.report_.converged and svm.oracle_.loss == loss
    j_port = ref_fit_objective(X, y, g, loss, lam, svm.w_)
    ref = JaxRankSVM(lam=lam, eps=eps, solver=solver, loss=loss)
    ref.fit(X, y, groups=g)
    j_ref = ref_fit_objective(X, y, g, loss, lam, ref.w_)
    assert abs(j_port - j_ref) <= 2 * eps + 1e-5
    np.testing.assert_allclose(svm.objective(X, y, groups=g), j_port,
                               rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize('loss', NEW_LOSSES)
def test_streamed_fit_reaches_the_resident_objective(loss):
    _, X, y, g = CASES[0]
    kw = dict(lam=0.05, eps=1e-4, loss=loss, device='cpu')
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        resident = RankSVM(**kw).fit(X, y)
        streamed = RankSVM(method='stream', stream_block=9, **kw).fit(X, y)
    assert streamed.oracle_.name == f'stream/dense/{loss}'
    assert abs(streamed.objective(X, y) - resident.objective(X, y)) <= \
        2 * 1e-4 + 1e-5


def test_estimator_takes_torch_group_ids():
    """fit, objective and ranking_error take group ids as a torch tensor
    as well as numpy, with the same result."""
    _, X, y, g = CASES[3]
    gt = torch.as_tensor(np.asarray(g, np.int64))
    svm = RankSVM(lam=0.05, eps=1e-3, loss='poshinge', device='cpu')
    svm.fit(X, y, groups=gt)
    assert svm.objective(X, y, groups=gt) == svm.objective(X, y, groups=g)
    assert svm.ranking_error(X, y, groups=gt) == \
        svm.ranking_error(X, y, groups=g)
