"""Port parity: the counting references, the merge-sort tree and the plain
versions of both counting kernels (repro_torch) against the JAX package's
`repro.core.ref` and `repro.core.counts`, on the tie cases of
tests/test_counts.py. Counts must be bit-equal."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from repro.core import counts as JC  # noqa: E402
from repro.core import ref as JR  # noqa: E402
from repro_torch.core import counts as TC  # noqa: E402
from repro_torch.core import ref as TR  # noqa: E402
from repro_torch.kernels.pairwise_rank import ops as PR  # noqa: E402
from repro_torch.kernels.rank_counts import ops as RC  # noqa: E402
from torch_parity import n, t, torch_one_thread  # noqa: E402,F401


def _seeded(m, tie_heavy):
    rng = np.random.default_rng(m + 1000 * tie_heavy)
    if tie_heavy:
        p = (rng.integers(-2, 3, size=m) * 0.5).astype(np.float32)
        y = rng.integers(0, 3, size=m).astype(np.float32)
    else:
        p = rng.uniform(-100, 100, size=m).astype(np.float32)
        y = rng.uniform(-100, 100, size=m).astype(np.float32)
    return p, y


def _large_scrambled():
    rng = np.random.default_rng(7)
    m = 4097                                  # crosses a pow2 padding edge
    return (rng.normal(size=m).astype(np.float32),
            rng.integers(0, 50, size=m).astype(np.float32))


def _alphabet(k):
    """k distinct utilities over m = 1037 (no tile divides it), scores on
    a 0.25 grid."""
    rng = np.random.default_rng(20 + k)
    m = 1037
    return ((rng.integers(-12, 13, size=m) * 0.25).astype(np.float32),
            rng.permutation(np.arange(m) % k).astype(np.float32))


def _half_grid():
    """Scores on a 0.5 grid: many p_j equal p_i +- 1 exactly."""
    rng = np.random.default_rng(31)
    return ((rng.integers(-6, 7, size=999) * 0.5).astype(np.float32),
            rng.integers(0, 5, size=999).astype(np.float32))


CASES = {f'seeded-m{m}-{"ties" if th else "distinct"}': (_seeded, (m, th))
         for m in (1, 2, 3, 8, 33, 128) for th in (False, True)}
CASES.update({
    'margin-boundary': (lambda: (np.asarray([0.0, 1.0], np.float32),
                                 np.asarray([0.0, 1.0], np.float32)), ()),
    'just-inside': (lambda: (np.asarray([0.0, 1.0 - 1e-3], np.float32),
                             np.asarray([0.0, 1.0], np.float32)), ()),
    'float64-input': (lambda: (
        np.random.default_rng(6).normal(size=400) * 3,
        np.random.default_rng(6).integers(0, 5, size=400).astype(np.float64)),
        ()),
    'large-scrambled': (_large_scrambled, ()),
    'all-scores-equal': (lambda: (np.full(517, 0.75, np.float32),
                                  np.random.default_rng(2).integers(
                                      0, 5, size=517).astype(np.float32)),
                         ()),
    'half-grid': (_half_grid, ()),
})
CASES.update({f'alphabet-{k}': (_alphabet, (k,)) for k in (1, 2, 5, 256, 257)})

# Every port implementation of (p, y) -> (c, d) on CPU tensors.
IMPLS = {
    'counts_ref': TR.counts_ref,
    'counts': TC.counts,
    'counts_fused': TC.counts_fused,
    'counts_blocked_host': functools.partial(TC.counts_blocked_host,
                                             block=512),
    'pairwise_plain': PR.pairwise_counts,
    'rank_counts_plain': RC.rank_counts,
    'rank_counts_plain_small_tiles': functools.partial(RC.rank_counts,
                                                       ti=32, tj=64),
    'dispatch_auto': functools.partial(TC.counts_dispatch, g=None,
                                       engine='auto'),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    fn, args = CASES[name]
    p, y = fn(*args)
    # The JAX package runs without 64-bit floats: its inputs are float32.
    cr, dr = JR.counts_ref(jnp.asarray(p), jnp.asarray(y))
    return p, y, n(cr), n(dr)


# The O(m^2) reference mask is for small m: not run on the m = 4097 case.
PAIRS = [(case, impl) for case in CASES for impl in IMPLS
         if not (impl == 'counts_ref' and case == 'large-scrambled')]


@pytest.mark.parametrize('case,impl', PAIRS)
def test_counts_bit_equal_to_reference(case, impl):
    p, y, cr, dr = _case(case)
    c, d = IMPLS[impl](t(p), t(y))
    assert c.dtype == torch.int32 and d.dtype == torch.int32
    np.testing.assert_array_equal(n(c), cr)
    np.testing.assert_array_equal(n(d), dr)


def test_counts_exact_margin_semantics():
    """p_j == p_i + 1 does not count (strict, eq. 5); just inside does."""
    for impl in IMPLS.values():
        c, d = impl(t(np.asarray([0.0, 1.0], np.float32)),
                    t(np.asarray([0.0, 1.0], np.float32)))
        assert int(c[0]) == 0 and int(d[1]) == 0
        c, d = impl(t(np.asarray([0.0, 1.0 - 1e-3], np.float32)),
                    t(np.asarray([0.0, 1.0], np.float32)))
        assert int(c[0]) == 1 and int(d[1]) == 1


@pytest.mark.parametrize('m', [0, 1])
def test_counts_empty_and_singleton(m):
    p = torch.zeros(m)
    for impl in IMPLS.values():
        c, d = impl(p, p.clone())
        assert c.shape == (m,) and d.shape == (m,)


@pytest.mark.parametrize('engine', ['tree', 'blocked', 'pallas', 'auto'])
@pytest.mark.parametrize('m,n_groups', [(5, 2), (33, 3), (128, 5)])
def test_grouped_counts_bit_equal(m, n_groups, engine):
    rng = np.random.default_rng(11 + m)
    p = (rng.integers(-2, 3, size=m) * 0.5).astype(np.float32)
    y = rng.integers(0, 3, size=m).astype(np.float32)
    g = rng.integers(0, n_groups, size=m).astype(np.int32)
    cr, dr = JR.grouped_counts_ref(jnp.asarray(p), jnp.asarray(y),
                                   jnp.asarray(g))
    c, d = TC.counts_dispatch(t(p), t(y), t(g), engine=engine)
    np.testing.assert_array_equal(n(c), n(cr))
    np.testing.assert_array_equal(n(d), n(dr))
    c, d = TR.grouped_counts_ref(t(p), t(y), t(g))
    np.testing.assert_array_equal(n(c), n(cr))
    np.testing.assert_array_equal(n(d), n(dr))
    c, d = TC.counts_grouped_fused(t(p), t(y), t(g))
    np.testing.assert_array_equal(n(c), n(cr))
    np.testing.assert_array_equal(n(d), n(dr))


@pytest.mark.parametrize('m', [1, 2, 33, 128])
def test_num_pairs_match_reference(m):
    rng = np.random.default_rng(13 + m)
    y = rng.integers(0, 3, size=m).astype(np.float32)
    nr = int(JR.num_pairs_ref(jnp.asarray(y)))
    assert int(TR.num_pairs_ref(t(y))) == nr
    assert TC.num_pairs_host(y) == nr
    assert float(TC.num_pairs(t(y))) == float(JC.num_pairs(jnp.asarray(y)))


def test_num_pairs_grouped_match_reference():
    y = np.asarray([0, 1, 2, 0, 1, 2], np.float32)
    g = np.asarray([0, 0, 0, 1, 1, 1], np.int32)
    nj = float(JC.num_pairs_grouped(jnp.asarray(y), jnp.asarray(g)))
    assert float(TC.num_pairs_grouped(t(y), t(g))) == nj == 6.0
    assert int(TR.grouped_num_pairs_ref(t(y), t(g))) == 6


@pytest.mark.parametrize('m', [2, 33, 128])
def test_loss_from_counts_matches_reference(m):
    rng = np.random.default_rng(21 + m)
    p = (rng.integers(-4, 5, size=m) * 0.25).astype(np.float32)
    y = rng.integers(0, 4, size=m).astype(np.float32)
    X = (rng.integers(-4, 5, size=(m, 3)) * 0.5).astype(np.float32)
    pj, yj = jnp.asarray(p), jnp.asarray(y)
    lr = float(JR.loss_ref(pj, yj))
    np.testing.assert_allclose(float(TR.loss_ref(t(p), t(y))), lr,
                               rtol=1e-6)
    c, d = TC.counts_fused(t(p), t(y))
    lc = TR.loss_from_counts(t(p), c, d, TC.num_pairs_host(y))
    np.testing.assert_allclose(float(lc), lr, rtol=1e-6)
    np.testing.assert_allclose(n(TR.subgradient_ref(t(X), t(p), t(y))),
                               n(JR.subgradient_ref(jnp.asarray(X), pj, yj)),
                               rtol=1e-6, atol=1e-7)


def test_validate_engine_and_unported_weighting():
    """Engine and block are checked up front; weighted counting (v=),
    ported with the loss axis, returns the weighted tree's (c~, d) on
    every engine but 'blocked' (the counting kernels have no weighted
    variant, as in the reference): d bit-equal to the unweighted counts,
    c~ within 1e-6 of sum(v) of the reference's."""
    with pytest.raises(ValueError, match='unknown counting engine'):
        TC.counts_dispatch(torch.zeros(2), torch.zeros(2), None,
                           engine='tre')
    with pytest.raises(ValueError, match='whole number'):
        TC.counts_dispatch(torch.zeros(2), torch.zeros(2), None,
                           engine='blocked', block=2.5)
    p, y = _half_grid()
    v = np.random.default_rng(3).random(p.shape[0]).astype(np.float32)
    cj, dj = JC.counts_weighted_fused(jnp.asarray(p), jnp.asarray(y),
                                      jnp.asarray(v))
    tree = TC.counts_weighted_fused(t(p), t(y), t(v))
    for engine in ('tree', 'pallas', 'auto'):
        cw, d = TC.counts_dispatch(t(p), t(y), None, engine=engine, v=t(v))
        assert cw.dtype == torch.float32 and torch.equal(cw, tree[0])
        assert np.array_equal(n(d), n(TC.counts_fused(t(p), t(y))[1]))
        assert np.array_equal(n(d), np.asarray(dj))
        assert np.abs(n(cw) - np.asarray(cj)).max() <= 1e-6 * v.sum()
