"""Port parity of the two counting kernels' wrappers against the JAX
package's Pallas kernels.

On the CPU the port's wrappers run the plain versions of their CUDA
kernels (`ref.py` beside each kernel) on the inputs the wrappers prepare;
the JAX kernels run through the Pallas interpreter, as their own tests
run them. Counts must be bit-equal, on the adversarial tie patterns and
the over-capacity guard of tests/test_counts_kernel.py, at m <= 2048.

The JAX rank-counts kernel reads its refs with `pl.load`, which the
installed JAX no longer has, so it cannot trace as it stands. The
`pallas_load` fixture supplies `pl.load(ref, idx)` as `ref[idx]` (what it
meant) for the duration of one test, and those tests call the kernel
path `_kernel_counts` directly, un-jitted, so no compiled program outlives
the test. The guard's other branch, the tree, and grouped counting are
held against the reference's O(m^2) `repro.core.ref`, which the JAX
kernel is specified to equal.

The CUDA kernels themselves are held against their plain versions on the
card by tests/test_torch_cuda.py."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from repro.core import ref as JR  # noqa: E402
from repro.kernels.pairwise_rank import ops as JPR  # noqa: E402
from repro.kernels.rank_counts import ops as JRC  # noqa: E402
from repro_torch.core import counts as TC  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.pairwise_rank import ops as PR  # noqa: E402
from repro_torch.kernels.pairwise_rank.ref import (  # noqa: E402
    pairwise_counts_plain)
from repro_torch.kernels.rank_counts import ops as RC  # noqa: E402
from repro_torch.kernels.rank_counts import ref as RCR  # noqa: E402
from torch_parity import n, t, torch_one_thread  # noqa: E402,F401


def _grid(m=1500):
    """Scores on an integer grid: every frontier lands on a run of
    p +- 1 ties, the worst case for the band boundaries."""
    rng = np.random.default_rng(5)
    return ((np.arange(m) % 5).astype(np.float32),
            rng.integers(0, 4, size=m).astype(np.float32))


def _dup_scores():
    rng = np.random.default_rng(3)
    return ((rng.integers(-2, 3, size=800) * 0.5).astype(np.float32),
            rng.integers(0, 3, size=800).astype(np.float32))


def _dup_utilities():
    rng = np.random.default_rng(4)
    return rng.normal(size=300).astype(np.float32), np.ones(300, np.float32)


def _float64():
    rng = np.random.default_rng(6)
    return rng.normal(size=400) * 3, rng.integers(0, 5, size=400).astype(
        np.float64)


def _shape(m):
    rng = np.random.default_rng(m)
    return (rng.normal(size=m).astype(np.float32) * 2,
            rng.integers(0, 8, size=m).astype(np.float32))


def _over_capacity():
    """~600 distinct utilities: more than the 256 histogram levels."""
    rng = np.random.default_rng(8)
    return rng.normal(size=600).astype(np.float32), rng.normal(
        size=600).astype(np.float32)


CASES = {
    'margin-grid': _grid,
    'duplicate-scores': _dup_scores,
    'duplicate-utilities': _dup_utilities,
    'float64-input': _float64,
    'over-capacity': _over_capacity,
    'shape-1': lambda: _shape(1),
    'shape-129': lambda: _shape(129),
    'shape-2048': lambda: _shape(2048),
}


@pytest.fixture
def pallas_load(monkeypatch):
    monkeypatch.setattr(pl, 'load', lambda ref, idx: ref[idx], raising=False)


def _jax_kernel_counts(p, y, ti_rows=8, tj_rows=8, levels=256):
    """The JAX package's rank-counts kernel path in interpret mode, with
    its float64 cast (`_rank_counts_impl`)."""
    pj = jnp.asarray(p, jnp.float32)
    yj = jnp.asarray(y, jnp.float32)
    return JRC._kernel_counts(pj, yj, ti_rows, tj_rows, levels, True)


@pytest.mark.parametrize('case', [c for c in CASES if c != 'over-capacity'])
def test_rank_counts_matches_pallas_interpret(case, pallas_load):
    p, y = CASES[case]()
    cj, dj = _jax_kernel_counts(p, y)
    c, d = RC.rank_counts(t(p), t(y))
    np.testing.assert_array_equal(n(c), n(cj))
    np.testing.assert_array_equal(n(d), n(dj))


def test_rank_counts_over_capacity_takes_the_tree():
    """More distinct utilities than histogram levels: the guard counts
    with the tree, as the reference's guard does, bit for bit."""
    p, y = _over_capacity()
    cj, dj = JR.counts_ref(jnp.asarray(p), jnp.asarray(y))
    before = RC.RANK_COUNTS.launches
    c, d = RC.rank_counts(t(p), t(y))
    np.testing.assert_array_equal(n(c), n(cj))
    np.testing.assert_array_equal(n(d), n(dj))
    assert RC.RANK_COUNTS.launches == before


@pytest.mark.parametrize('case', ['margin-grid', 'duplicate-scores',
                                  'float64-input', 'shape-2048'])
def test_pairwise_matches_pallas_interpret(case):
    p, y = CASES[case]()
    cj, dj = JPR.pairwise_counts(jnp.asarray(p), jnp.asarray(y),
                                 interpret=True)
    c, d = PR.pairwise_counts(t(p), t(y))
    np.testing.assert_array_equal(n(c), n(cj))
    np.testing.assert_array_equal(n(d), n(dj))


def test_pairwise_rank_loss_matches_pallas_interpret():
    p, y = _dup_scores()
    n_pairs = float(TC.num_pairs_host(y))
    lj = JPR.pairwise_rank_loss(jnp.asarray(p), jnp.asarray(y), n_pairs,
                                interpret=True)
    lt = PR.pairwise_rank_loss(t(p), t(y), n_pairs)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)


def test_rank_counts_explicit_tiny_capacity():
    """An in-capacity-looking input with levels=4: the guard sends ten
    distinct utilities to the tree, with the reference's exact counts."""
    rng = np.random.default_rng(8)
    p = rng.normal(size=600).astype(np.float32)
    y = rng.integers(0, 10, size=600).astype(np.float32)
    cj, dj = JR.counts_ref(jnp.asarray(p), jnp.asarray(y))
    c, d = RC.rank_counts(t(p), t(y), levels=4)
    np.testing.assert_array_equal(n(c), n(cj))
    np.testing.assert_array_equal(n(d), n(dj))


@functools.lru_cache(maxsize=None)
def _sweep_reference():
    rng = np.random.default_rng(7)
    p = (rng.integers(-3, 4, size=700) * 0.5).astype(np.float32)
    y = rng.integers(0, 6, size=700).astype(np.float32)
    cj, dj = _jax_kernel_counts(p, y, ti_rows=1, tj_rows=1)
    return p, y, n(cj), n(dj)


@pytest.mark.parametrize('ti,tj', [(32, 32), (64, 256), (256, 64),
                                   (256, 256), (1024, 32)])
def test_rank_counts_tile_sweep(ti, tj, pallas_load):
    """The result is the same for any tiling; the JAX kernel runs at its
    smallest tiles (one 128-lane row each way)."""
    p, y, cj, dj = _sweep_reference()
    c, d = RC.rank_counts(t(p), t(y), ti=ti, tj=tj)
    np.testing.assert_array_equal(n(c), n(cj))
    np.testing.assert_array_equal(n(d), n(dj))


@pytest.mark.parametrize('m,n_groups', [(33, 3), (700, 7), (2000, 40),
                                        (900, 90)])
def test_rank_counts_grouped_matches_reference(m, n_groups):
    """Grouped counting through the key offsets; 40 groups of four grades
    (160 ranks) take tiles of four words, 90 groups overflow the levels
    and take the tree."""
    rng = np.random.default_rng(11 + m)
    p = (rng.integers(-2, 3, size=m) * 0.5).astype(np.float32)
    y = rng.integers(0, 4, size=m).astype(np.float32)
    g = rng.integers(0, n_groups, size=m).astype(np.int32)
    cj, dj = JR.grouped_counts_ref(jnp.asarray(p), jnp.asarray(y),
                                   jnp.asarray(g))
    c, d = RC.rank_counts_grouped(t(p), t(y), t(g))
    np.testing.assert_array_equal(n(c), n(cj))
    np.testing.assert_array_equal(n(d), n(dj))


def test_compact_ranks_match_reference():
    rng = np.random.default_rng(9)
    y = rng.integers(0, 7, size=300).astype(np.float32) * 0.3
    np.testing.assert_array_equal(n(RC._compact_ranks(t(y))),
                                  n(JRC._compact_ranks(jnp.asarray(y))))


def _normal_scores(m=1500):
    rng = np.random.default_rng(12)
    return (rng.normal(size=m).astype(np.float32) * 2,
            rng.integers(0, 5, size=m).astype(np.float32))


@pytest.mark.parametrize('case', ['margin-grid', 'normal'])
def test_prepared_frontiers_and_tables_match_brute_force(case):
    """The exactness argument, checked directly: every query's frontiers
    are the counts of the reference predicates over the sorted scores,
    the table's rows are brute-force histograms of whole tiles, and the
    bit planes spell the sorted ranks."""
    p, y = _grid(1500) if case == 'margin-grid' else _normal_scores()
    p, y = t(p), t(y)
    ranks = RC._compact_ranks(y)
    n_ranks = int(ranks.max()) + 1
    ps, order = torch.sort(p, stable=True)
    tj = 64
    yr, planes, table = RCR.prepare_plain(ps, ranks, order, n_ranks, tj)
    L, R = RCR.frontiers_plain(ps)
    assert torch.equal(L, (ps[None, :] < (ps + 1.0)[:, None]).sum(1))
    assert torch.equal(R, (ps[None, :] <= (ps - 1.0)[:, None]).sum(1))
    assert torch.equal(ps, p[order]) and torch.equal(yr, ranks[order])
    m = ps.shape[0]
    for row in range(table.shape[1]):
        below = yr[:min(row * tj, m)].long()
        want = (below[:, None] <= torch.arange(n_ranks)).sum(0)
        assert torch.equal(table[:, row].long(), want)
    bits = (planes.long() & 0xFFFFFFFF)[torch.arange(m) // 32]
    spelled = ((bits >> (torch.arange(m) % 32)[:, None]) & 1) << torch.arange(
        planes.shape[1])
    assert torch.equal(spelled.sum(1), yr.long())


@pytest.mark.parametrize('distinct', [1, 2, 5, 256, 257])
def test_rank_counts_alphabet_routes(distinct, monkeypatch):
    """Up to the 256 levels the prepared path counts (its tile follows
    the alphabet), past them the tree; both bit-equal to the reference."""
    calls = []
    plain, tree = RC.rank_counts_plain, RC.counts_fused
    monkeypatch.setattr(RC, 'rank_counts_plain', lambda *a: calls.append(
        ('plain', a[-1])) or plain(*a))
    monkeypatch.setattr(RC, 'counts_fused', lambda p, y: calls.append(
        ('tree', None)) or tree(p, y))
    rng = np.random.default_rng(distinct)
    m = 1037
    p = (rng.integers(-12, 13, size=m) * 0.25).astype(np.float32)
    y = rng.permutation(np.arange(m) % distinct).astype(np.float32)
    cj, dj = JR.counts_ref(jnp.asarray(p), jnp.asarray(y))
    c, d = RC.rank_counts(t(p), t(y))
    np.testing.assert_array_equal(n(c), n(cj))
    np.testing.assert_array_equal(n(d), n(dj))
    assert calls == ([('plain', RC.pick_tj(distinct))] if distinct <= 256
                     else [('tree', None)])


def test_auto_tiering_switches_at_kernel_max_m(monkeypatch):
    """The card's tiering, through the route seam: the pairwise kernel up
    to KERNEL_MAX_M examples, the rank-counts kernel above (their plain
    versions run here, on CPU tensors); off the card, the tree."""
    calls = []
    monkeypatch.setattr(PR, 'pairwise_counts',
                        lambda p, y: calls.append('pairwise') or
                        pairwise_counts_plain(p, y))
    monkeypatch.setattr(RC, 'rank_counter',
                        lambda y: lambda p: calls.append('rank') or
                        TC.counts_fused(p, y))
    monkeypatch.setattr(PR, 'KERNEL_MAX_M', 8)
    on_card = PR.auto_route
    monkeypatch.setattr(PR, 'auto_route',
                        lambda m, device: on_card(m, 'cuda'))
    p = torch.arange(9, dtype=torch.float32)
    PR.counts_auto(p[:8], p[:8])
    PR.counts_auto(p, p)
    assert calls == ['pairwise', 'rank']
    assert [on_card(m, dev) for m, dev in ((8, 'cuda'), (9, 'cuda:0'),
                                           (8, 'cpu'), (9, 'cpu'))] == [
        'pairwise', 'rank_counts', 'tree', 'tree']


@pytest.mark.parametrize('m', [8, PR.KERNEL_MAX_M + 1],
                         ids=['below', 'above'])
def test_auto_on_cpu_tensors_counts_with_the_tree(m, monkeypatch):
    """engine='auto' on CPU tensors runs `counts_fused`, as the
    reference's auto does off the TPU, on either side of KERNEL_MAX_M:
    neither kernel is launched and neither plain version runs."""
    def refuse(*args, **kw):
        raise AssertionError('a plain kernel version ran')
    monkeypatch.setattr(PR, 'pairwise_counts_plain', refuse)
    monkeypatch.setattr(RC, 'rank_counts_plain', refuse)
    calls = []
    real = TC.counts_fused
    monkeypatch.setattr(TC, 'counts_fused',
                        lambda p, y: calls.append(1) or real(p, y))
    p, y = _grid(m)
    before = (PR.PAIRWISE.launches, RC.RANK_COUNTS.launches)
    c, d = PR.counts_auto(t(p), t(y))
    assert calls == [1]
    assert (PR.PAIRWISE.launches, RC.RANK_COUNTS.launches) == before
    cr, dr = JPR.counts_auto(jnp.asarray(p), jnp.asarray(y))
    assert np.array_equal(c.numpy(), np.asarray(cr))
    assert np.array_equal(d.numpy(), np.asarray(dr))


def test_cpu_tensors_never_launch():
    before = (PR.PAIRWISE.launches, RC.RANK_COUNTS.launches)
    p, y = _dup_scores()
    PR.pairwise_counts(t(p), t(y))
    RC.rank_counts(t(p), t(y))
    assert (PR.PAIRWISE.launches, RC.RANK_COUNTS.launches) == before


@pytest.mark.parametrize('err,launched', [(0, 1), (9, 0)])
def test_kernel_launcher_counts_and_raises(err, launched):
    """A launch that returns a CUDA error raises and is not counted (the
    C launcher is replaced by a stand-in returning `err`)."""
    k = _build.Kernel('pairwise_rank.cu', 'pairwise_counts_launch', [])
    k._fn = lambda *args: err
    if err:
        with pytest.raises(RuntimeError, match='error 9'):
            k(1, 2)
    else:
        k(1, 2)
    assert k.launches == launched


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, 'which', lambda name: None)
    monkeypatch.setattr(_build.os.path, 'exists', lambda path: False)
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build._nvcc()


def test_failed_build_raises_with_the_compiler_output(monkeypatch,
                                                      tmp_path):
    """A compiler that fails: the build raises and keeps no library."""
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(_build, '_nvcc', lambda: 'false')
    with pytest.raises(RuntimeError, match='kernel build failed'):
        _build.build(('pairwise_rank.cu',))
    assert not _build.library_path('pairwise_rank.cu').exists()


def test_library_path_names_source_and_flags():
    a = _build.library_path('pairwise_rank.cu')
    b = _build.library_path('rank_counts.cu')
    assert a.parent == _build.BUILD_DIR and a.suffix == '.so'
    assert a.name.startswith('pairwise_rank-') and a != b
    assert _build.BUILD_DIR.name == '.kernel_build'
