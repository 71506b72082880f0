"""Port parity of the r-level baseline (`repro_torch.core.joachims`, the
counterpart of `repro.core.joachims`: SVM^rank's O(rm) counts): bit-equal
to the JAX package's `counts_rlevel` and to the O(m^2) `counts_ref` on
tie-heavy inputs, at every r from one level to r = m."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from repro.core import joachims as JJ  # noqa: E402
from repro.core import ref as JR  # noqa: E402
from repro_torch.core import counts as TC  # noqa: E402
from repro_torch.core import joachims as TJ  # noqa: E402
from repro_torch.core import ref as TR  # noqa: E402
from torch_parity import n, t, torch_one_thread  # noqa: E402,F401


def _case(kind, m, r, seed):
    rng = np.random.default_rng(seed)
    if kind == 'half-grid':         # many p_j = p_i +- 1 exactly
        p = (rng.integers(-6, 7, size=m) * 0.5).astype(np.float32)
    elif kind == 'all-tied':
        p = np.zeros(m, np.float32)
    else:
        p = rng.normal(size=m).astype(np.float32)
    y = rng.integers(0, r, size=m).astype(np.float32) * 0.75 - 3.0
    return p, y


CASES = [(kind, m, r) for kind in ('half-grid', 'all-tied', 'normal')
         for m, r in ((1, 1), (2, 2), (37, 3), (256, 8), (1000, 40),
                      (300, 300))]


@pytest.mark.parametrize('kind,m,r', CASES)
def test_rlevel_counts_are_bit_equal(kind, m, r):
    p, y = _case(kind, m, r, seed=m * 31 + r)
    yl, r_found = TJ.levels_of(y)
    yl_j, r_j = JJ.levels_of(y)
    np.testing.assert_array_equal(yl, yl_j)
    assert r_found == r_j and yl.dtype == np.int32
    c, d = TJ.counts_rlevel(t(p), t(yl), r_found)
    assert c.dtype == torch.int32 and d.dtype == torch.int32
    cj, dj = JJ.counts_rlevel(jnp.asarray(p), jnp.asarray(yl), r_found)
    cr, dr = JR.counts_ref(jnp.asarray(p), jnp.asarray(y))
    for got, want in ((c, cj), (d, dj), (c, cr), (d, dr)):
        np.testing.assert_array_equal(n(got), np.asarray(want))
    ct, dt = TR.counts_ref(t(p), t(y))
    assert torch.equal(c, ct) and torch.equal(d, dt)
    cf, df = TC.counts_fused(t(p), t(y))
    assert torch.equal(c, cf) and torch.equal(d, df)


def test_unused_levels_and_empty_input():
    """A level no example takes changes nothing; m = 0 gives empty int32
    counts; `levels_of` takes torch tensors too."""
    p, y = _case('half-grid', 200, 5, seed=3)
    yl, r = TJ.levels_of(t(y))
    c, d = TJ.counts_rlevel(t(p), t(yl), r)
    c9, d9 = TJ.counts_rlevel(t(p), t(yl * 2), 2 * r)
    assert torch.equal(c, c9) and torch.equal(d, d9)
    z = TJ.counts_rlevel(torch.zeros(0), torch.zeros(0, dtype=torch.int32),
                         3)
    assert all(a.shape == (0,) and a.dtype == torch.int32 for a in z)
