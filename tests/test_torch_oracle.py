"""Port parity of the oracle layer: the port's (R_emp, subgradient) against
`tests/oracle_ref.pairwise_loss_ref` (float64 numpy brute force) and the
JAX package's `repro.core.oracle`, on `differential_fit_cases()`, hinge
only.

The cases are quantized (features on a 0.5 grid, weights on a 0.25
grid), so float32 and float64 scores agree exactly and every tie breaks
alike. What remains is float32 accumulation in the loss sum and the
transpose-matvec: relative tolerance 1e-6, with an absolute floor of
1e-7 for subgradient entries that are exactly zero in float64."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from oracle_ref import (differential_fit_cases,  # noqa: E402
                        pairwise_loss_ref, quantized_weights)
from repro.core import oracle as JO  # noqa: E402
from repro.core import rank_loss as JRL  # noqa: E402
from repro_torch.core import oracle as TO  # noqa: E402
from repro_torch.core import rank_loss as TRL  # noqa: E402
from repro_torch.kernels import platform  # noqa: E402
from torch_parity import n, t, torch_one_thread  # noqa: E402,F401

CASES = list(differential_fit_cases())
CASE_IDS = [c[0] for c in CASES]
TOL = dict(rtol=1e-6, atol=1e-7)


def _ref_at(X, y, g, w):
    val, sub = pairwise_loss_ref(np.asarray(X, np.float64) @ w, y, g)
    return val, np.asarray(X, np.float64).T @ sub


def _weights(name, X, k=4):
    rng = np.random.default_rng(sum(map(ord, name)))
    return quantized_weights(rng, X.shape[1], k=k)


@pytest.mark.parametrize('case', CASES, ids=CASE_IDS)
@pytest.mark.parametrize('method', ('tree', 'pairs', 'auto'))
def test_loss_subgrad_match_bruteforce(method, case):
    name, X, y, g = case
    oracle = TO.make_oracle(X, y, groups=g, method=method, device='cpu')
    for w in _weights(name, X):
        got_l, got_a = oracle.loss_and_subgrad(w)
        ref_l, ref_a = _ref_at(X, y, g, w)
        np.testing.assert_allclose(float(got_l), ref_l, **TOL)
        np.testing.assert_allclose(n(got_a), ref_a, **TOL)


@pytest.mark.parametrize('case', CASES, ids=CASE_IDS)
@pytest.mark.parametrize('engine', ('blocked', 'pallas', 'auto'))
def test_engines_match_bruteforce(engine, case):
    name, X, y, g = case
    oracle = TO.make_oracle(X, y, groups=g, method='tree', engine=engine,
                            device='cpu')
    for w in _weights(name, X, k=2):
        got_l, got_a = oracle.loss_and_subgrad(w)
        ref_l, ref_a = _ref_at(X, y, g, w)
        np.testing.assert_allclose(float(got_l), ref_l, **TOL)
        np.testing.assert_allclose(n(got_a), ref_a, **TOL)


@pytest.mark.parametrize('case', CASES, ids=CASE_IDS)
def test_oracle_matches_jax_package(case):
    name, X, y, g = case
    jo = JO.make_oracle(X, y, groups=g, method='tree')
    to = TO.make_oracle(X, y, groups=g, method='tree', device='cpu')
    assert (to.m, to.n, to.n_pairs, to.norm) == (jo.m, jo.n, jo.n_pairs,
                                                 jo.norm)
    for w in _weights(name, X, k=2):
        jl, ja = jo.loss_and_subgrad(w)
        tl, ta = to.loss_and_subgrad(w)
        np.testing.assert_allclose(float(tl), float(jl), **TOL)
        np.testing.assert_allclose(n(ta), n(ja), **TOL)


def _ranking_error_bruteforce(p, y, g):
    """Eq. (1) by pair enumeration: swapped pairs, score ties half."""
    p = np.asarray(p, np.float64)
    y = np.asarray(y, np.float64)
    g = np.zeros(len(y)) if g is None else np.asarray(g)
    pairs = (y[:, None] < y[None, :]) & (g[:, None] == g[None, :])
    err = (p[:, None] > p[None, :]) + 0.5 * (p[:, None] == p[None, :])
    return float((pairs * err).sum() / max(pairs.sum(), 1))


@pytest.mark.parametrize('case', CASES, ids=CASE_IDS)
def test_empirical_risk_and_ranking_error_match_bruteforce(case):
    name, X, y, g = case
    w = _weights(name, X, k=1)
    p = (np.asarray(X, np.float64) @ w).astype(np.float32)
    np.testing.assert_allclose(TO.empirical_risk(p, y, g, device='cpu'),
                               pairwise_loss_ref(p, y, g)[0], **TOL)
    gt = None if g is None else t(np.asarray(g, np.int32))
    np.testing.assert_allclose(
        float(TRL.ranking_error(t(p), t(y, torch.float32), gt)),
        _ranking_error_bruteforce(p, y, g), **TOL)


@pytest.mark.parametrize('case', [CASES[0], CASES[3]],
                         ids=[CASE_IDS[0], CASE_IDS[3]])
def test_empirical_risk_and_ranking_error_match_jax_package(case):
    name, X, y, g = case
    w = _weights(name, X, k=1)
    p = (np.asarray(X, np.float64) @ w).astype(np.float32)
    np.testing.assert_allclose(TO.empirical_risk(p, y, g, device='cpu'),
                               JO.empirical_risk(p, y, g), **TOL)
    gj = None if g is None else jnp.asarray(np.asarray(g, np.int32))
    gt = None if g is None else t(np.asarray(g, np.int32))
    np.testing.assert_allclose(
        float(TRL.ranking_error(t(p), t(y, torch.float32), gt)),
        float(JRL.ranking_error(jnp.asarray(p), jnp.asarray(y, jnp.float32),
                                gj)), **TOL)


def test_unported_arguments_name_their_roadmap_item():
    """Every method and loss builds its oracle: method='sharded' (Queue 1
    item 12) a `ShardedOracle`, streamed and sparse features (item 9)
    and the losses 'toppush' and 'poshinge' (item 7) theirs."""
    X = np.eye(3)
    y = np.arange(3.0)
    for loss in ('toppush', 'poshinge'):
        o = TO.make_oracle(X, y, loss=loss, device='cpu')
        assert isinstance(o, TO.TreeOracle) and o.loss == loss
        assert o.name == f'tree/{loss}'
    sharded = TO.make_oracle(X, y, method='sharded', device='cpu')
    assert isinstance(sharded, TO.ShardedOracle)
    assert sharded.name == 'sharded' and sharded.n_pairs == 3
    assert isinstance(TO.make_oracle(X, y, method='stream', device='cpu'),
                      TO.StreamingOracle)
    assert TO.make_oracle(torch.eye(3).to_sparse(), y,
                          device='cpu')._feats.kind == 'csr'
    with pytest.raises(ValueError, match='unknown loss'):
        TO.make_oracle(X, y, loss='hinj', device='cpu')


def test_entry_points_refuse_to_fall_back_to_the_cpu():
    """With no card, naming no device raises; device='cpu' is explicit."""
    if torch.cuda.is_available():
        assert platform.resolve_device(None).type == 'cuda'
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TO.make_oracle(np.eye(3), np.arange(3.0))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        platform.resolve_device('cuda')
    assert platform.resolve_device('cpu').type == 'cpu'
    assert platform.device_platform() == 'cpu' and not platform.on_hopper()


def test_full_f32_restores_the_process_setting():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision('medium')
    try:
        with platform.full_f32():
            assert torch.get_float32_matmul_precision() == 'highest'
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == 'medium'
    finally:
        torch.set_float32_matmul_precision(before)
    assert torch.get_float32_matmul_precision() == before


def test_groups_are_validated_and_relabelled():
    X = np.eye(4)
    y = np.array([0.0, 1.0, 0.0, 1.0])
    with pytest.raises(ValueError, match='NaN'):
        TO.make_oracle(X, y, groups=np.array([0, 0, np.nan, 1]),
                       device='cpu')
    o = TO.make_oracle(X, y, groups=np.array([10**9, 10**9, 7, 7]),
                       device='cpu')
    assert o.n_pairs == 2 and sorted(set(n(o._g).tolist())) == [0, 1]


@pytest.mark.parametrize('grouped', (False, True), ids=('flat', 'grouped'))
@pytest.mark.parametrize('engine', ('pallas', 'auto'))
def test_rank_counter_ranks_y_once_per_oracle(engine, grouped, monkeypatch):
    """y is fixed over a fit, so the rank-counts engine ranks it (and
    reads the level guard back) when the oracle first steps, not on every
    step; the steps still match the brute force."""
    from repro_torch.kernels.pairwise_rank import ops as PR
    from repro_torch.kernels.rank_counts import ops as RC
    calls = []
    real = RC._compact_ranks
    monkeypatch.setattr(RC, '_compact_ranks',
                        lambda y: calls.append(1) or real(y))
    monkeypatch.setattr(PR, 'KERNEL_MAX_M', 8)   # 'auto' takes rank-counts
    on_card = PR.auto_route                       # as it does on the card
    monkeypatch.setattr(PR, 'auto_route', lambda m, dev: on_card(m, 'cuda'))
    name, X, y, g = next(c for c in CASES if (c[3] is not None) == grouped)
    oracle = TO.make_oracle(X, y, groups=g, method='tree', engine=engine,
                            device='cpu')
    for w in _weights(name, X, k=3):
        got_l, got_a = oracle.loss_and_subgrad(w)
        ref_l, ref_a = _ref_at(X, y, g, w)
        np.testing.assert_allclose(float(got_l), ref_l, **TOL)
        np.testing.assert_allclose(n(got_a), ref_a, **TOL)
    assert len(calls) == 1
