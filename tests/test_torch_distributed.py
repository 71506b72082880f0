"""The port's sharded RankSVM oracle, its meshes and the compressed mean
against the JAX package.

* One rank on the degenerate mesh against the reference's
  `ShardedOracle` on its 1-device mesh, on `oracle_ref`'s quantized
  cases (features on the 0.5 grid, w on the 0.25 grid: exact in bf16, so
  every product and score is exact): counts bit-equal, loss within 1e-6
  relative, subgradient within 1e-6 of max|a|, for every layout, both
  variants and every engine.
* Multi-rank `gloo` groups on the CPU (`torch_dist_worker.run_ranks`,
  one spawn per mesh, a file store under the test's temporary folder):
  meshes (2, 1), (1, 2), (2, 2) and (4, 1), with m = 63 rows, so that
  every mesh of 2 or 4 row blocks pads. Every rank's counts, loss and a equal the
  one-rank port's bit for bit (the design's float64 sums make them
  independent of the mesh), and a short device-driver fit leaves every
  rank with the one-rank fit's w.
* One subprocess against the reference on 4 forced host devices: its
  `ShardedOracle` on a (2, 2) mesh and `compressed_mean` on 4 devices,
  against the port's 4 ranks on the same inputs.
* `RankSVM(method='sharded')`, the gates, and the pieces (`make_mesh`
  without a process group, `rank_block`, the query split of
  `_half_counts`).
"""

import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402
from repro.core import counts as JC  # noqa: E402
from repro.core import oracle as JO  # noqa: E402
from repro.core.ranksvm import RankSVM as JRankSVM  # noqa: E402
from repro.data.sparse import CSRMatrix as JCSRMatrix  # noqa: E402

from repro_torch.core import counts as TC  # noqa: E402
from repro_torch.core.bmrm import bmrm  # noqa: E402
from repro_torch.core import distributed as TD  # noqa: E402
from repro_torch.core import oracle as TO  # noqa: E402
from repro_torch.core.ranksvm import RankSVM  # noqa: E402
from repro_torch.data.rowblocks import as_row_block_source  # noqa: E402
from repro_torch.data.sparse import CSRMatrix  # noqa: E402
from repro_torch.distributed import compressed_mean  # noqa: E402
from repro_torch.launch.mesh import (Mesh, default_mesh,  # noqa: E402
                                     make_mesh)

from oracle_ref import differential_fit_cases, quantized_weights  # noqa: E402
from torch_dist_worker import oracle_calls, run_ranks  # noqa: E402
from torch_parity import n, torch_one_thread  # noqa: E402,F401

CASES = {name: (X, y, g) for name, X, y, g in differential_fit_cases(0)}
LOSS_REL = 1e-6          # loss, relative
A_REL = 1e-6             # subgradient, of max|a|


def _w(name):
    rng = np.random.default_rng(sorted(CASES).index(name) + 11)
    return quantized_weights(rng, CASES[name][0].shape[1])


def _compact(g):
    return None if g is None else np.unique(g, return_inverse=True)[1]


def _jax_counts(X, y, g, w):
    """The reference's counting pass of a sharded call: bf16 products with
    float32 output, then the tree on the (group-offset) keys."""
    p = jnp.einsum('mn,n->m', jnp.asarray(X, jnp.bfloat16),
                   jnp.asarray(w, jnp.bfloat16),
                   preferred_element_type=jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    if g is None:
        return JC.counts(p, y)
    return JC.counts_grouped(p, y, jnp.asarray(_compact(g)))


_REF = {}


def _reference(name, csr=False):
    """(loss, a, c, d) of the reference's ShardedOracle on its 1-device
    mesh for case `name`, made once per case and layout."""
    key = (name, csr)
    if key not in _REF:
        X, y, g = CASES[name]
        w = _w(name)
        o = JO.ShardedOracle(JCSRMatrix.from_dense(X) if csr else X, y,
                             groups=g)
        loss, a = o.loss_and_subgrad(w)
        c, d = _jax_counts(X, y, g, w)
        _REF[key] = (float(loss), np.asarray(a, np.float64), n(c), n(d))
    return _REF[key]


def _check_call(oracle, name, csr=False):
    loss_j, a_j, c_j, d_j = _reference(name, csr)
    w = _w(name)
    c, d = oracle.rank_counts(w)
    np.testing.assert_array_equal(n(c), c_j)
    np.testing.assert_array_equal(n(d), d_j)
    loss, a = oracle.loss_and_subgrad(w)
    assert float(loss) == pytest.approx(loss_j, rel=LOSS_REL)
    np.testing.assert_allclose(n(a), a_j, rtol=0,
                               atol=A_REL * max(np.abs(a_j).max(), 1e-30))


# ---------------------------------------- one rank against the reference


@pytest.mark.parametrize('engine', TC.ENGINES)
@pytest.mark.parametrize('variant', TD.VARIANTS)
@pytest.mark.parametrize('name', sorted(CASES))
def test_one_rank_matches_the_reference(name, variant, engine):
    X, y, g = CASES[name]
    oracle = TO.make_oracle(X, y, g, method='sharded', variant=variant,
                            engine=engine, device='cpu')
    assert isinstance(oracle, TO.ShardedOracle) and oracle.name == 'sharded'
    assert oracle.n_pairs == JO.ShardedOracle(X, y, groups=g).n_pairs
    _check_call(oracle, name)


def _layout(kind, X, tmp_path):
    if kind == 'torch':
        return torch.as_tensor(X, dtype=torch.float32)
    if kind == 'scipy':
        import scipy.sparse
        return scipy.sparse.csr_matrix(X)
    if kind == 'csrmatrix':
        return CSRMatrix.from_dense(X)
    if kind == 'rowblocks':
        return as_row_block_source(np.asarray(X, np.float32))
    path = os.path.join(tmp_path, 'X.npy')
    np.save(path, np.asarray(X, np.float32))
    return np.load(path, mmap_mode='r')


@pytest.mark.parametrize('name', ['ungrouped-mixed', 'grouped-with-pairless'])
@pytest.mark.parametrize('kind,oracle_name', [
    ('torch', 'sharded'), ('scipy', 'sharded/csr'),
    ('csrmatrix', 'sharded/csr'), ('memmap', 'sharded/stream'),
    ('rowblocks', 'sharded/stream')])
def test_layouts_match_the_reference(kind, oracle_name, name, tmp_path):
    X, y, g = CASES[name]
    oracle = TO.make_oracle(_layout(kind, X, tmp_path), y, g,
                            method='sharded', stream_block=7, prefetch=1,
                            device='cpu')
    assert oracle.name == oracle_name
    _check_call(oracle, name, csr=oracle_name == 'sharded/csr')


def test_batched_step_rows_equal_single_calls():
    """The path sweep's step: a batch W (L, n) gives each row's call."""
    X, y, g = CASES['grouped-singletons']
    rng = np.random.default_rng(5)
    W = quantized_weights(rng, X.shape[1], k=3)
    for Xl in (X, CSRMatrix.from_dense(X)):
        oracle = TO.make_oracle(Xl, y, g, method='sharded', variant='opt',
                                device='cpu')
        losses, A = oracle.step_fn()(torch.as_tensor(W, dtype=torch.float32))
        for k in range(3):
            loss, a = oracle.loss_and_subgrad(W[k])
            assert torch.equal(losses[k], loss) and torch.equal(A[k], a)


# --------------------------------------------------------- multi-rank


M_RANKS, N_RANKS = 63, 4         # 63 rows: 2 or 4 row blocks pad
MESHES = [(2, 1), (1, 2), (2, 2), (4, 1)]
COMBOS = [(layout, variant, engine) for layout in ('dense', 'csr', 'stream')
          for variant in TD.VARIANTS for engine in TC.ENGINES]
FIT = dict(lam=1e-2, eps=1e-3, max_iter=8, sync_every=4, qp_iters=32)
COMPRESS_STEPS = 30


def _rank_cases():
    rng = np.random.default_rng(7)
    X = rng.integers(-4, 5, size=(M_RANKS, N_RANKS)) * 0.5
    y = rng.integers(0, 5, M_RANKS).astype(np.float64)
    g = np.sort(rng.integers(0, 6, M_RANKS))
    w = quantized_weights(rng, N_RANKS)
    return [('grouped', X, y, g, w), ('ungrouped', X, y, None, w)]


def _summands(ndev):
    """COMPRESS_STEPS dicts of stacked (ndev, ...) float32 summands, the
    reference test's shapes."""
    rng = np.random.default_rng(0)
    return [{'w': rng.normal(size=(ndev, 32, 16)).astype(np.float32),
             'b': rng.normal(size=(ndev, 7)).astype(np.float32)}
            for _ in range(COMPRESS_STEPS)]


def _features(layout, X, path):
    if layout == 'csr':
        return CSRMatrix.from_dense(X)
    if layout == 'stream':
        return np.load(path, mmap_mode='r')
    return X


_RUNS = {}


def _mesh_run(shape, tmp_path_factory):
    """Every rank's results on the mesh `shape`, one spawn per mesh."""
    if shape not in _RUNS:
        tmp = tmp_path_factory.mktemp(f'mesh{shape[0]}x{shape[1]}')
        path = str(tmp / 'X.npy')
        cases = _rank_cases()
        np.save(path, np.asarray(cases[0][1], np.float32))
        full = shape == (2, 2)
        _RUNS[shape] = run_ranks(
            oracle_calls, shape[0] * shape[1], tmp, shape, cases, COMBOS,
            path, FIT, ('dense', 'csr') if full else ('dense',),
            _summands(shape[0]) if shape == (4, 1) else None), path
    return _RUNS[shape]


_ONE = {}


def _one_rank(name, layout, variant, engine, path):
    """The one-rank port's (c, d, loss, a) of a multi-rank case."""
    key = (name, layout, variant, engine)
    if key not in _ONE:
        case = {c[0]: c for c in _rank_cases()}[name]
        _, X, y, g, w = case
        o = TO.make_oracle(_features(layout, X, path), y, g,
                           method='sharded', variant=variant, engine=engine,
                           stream_block=5, device='cpu')
        c, d = o.rank_counts(w)
        loss, a = o.loss_and_subgrad(w)
        _ONE[key] = (n(c), n(d), n(loss), n(a))
    return _ONE[key]


@pytest.fixture(scope='module', params=MESHES,
                ids=[f'{a}x{b}' for a, b in MESHES])
def mesh_run(request, tmp_path_factory):
    res, path = _mesh_run(request.param, tmp_path_factory)
    return request.param, res, path


def _calls(res, path):
    for key in res[0]['calls']:
        name, layout, variant, engine = key.split('/')
        yield key, name, _one_rank(name, layout, variant, engine, path)


# ---------------------------------------- the reference on 4 devices

_JAX_PROG = textwrap.dedent('''
    import os, sys
    os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
    import jax, jax.numpy as jnp, numpy as np
    from repro.core import oracle as O
    from repro.data.sparse import CSRMatrix
    from repro.distributed.compression import compressed_mean
    from jax.sharding import Mesh

    # Mesh() as the reference's own _default_mesh builds it: under jax
    # 0.9 jax.make_mesh defaults to explicit axes, which the reference's
    # bodies do not annotate for (ROADMAP.md Queue 3).
    inp = np.load(sys.argv[1])
    out = {}
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ('data', 'model'))
    for name in ('grouped', 'ungrouped'):
        X, y, w = (inp[f'{name}/{k}'] for k in 'Xyw')
        g = inp[f'{name}/g'] if f'{name}/g' in inp else None
        for layout in ('dense', 'csr'):
            Xl = X if layout == 'dense' else CSRMatrix.from_dense(X)
            loss, a = O.ShardedOracle(Xl, y, groups=g,
                                      mesh=mesh).loss_and_subgrad(w)
            out[f'{name}/{layout}/loss'] = np.asarray(loss)
            out[f'{name}/{layout}/a'] = np.asarray(a)
    # One program for every step (zero residuals stand for None), where
    # each direct call would trace and compile its shard_map anew.
    cmesh = Mesh(np.array(jax.devices()), ('data',))
    step = jax.jit(lambda g, e: compressed_mean(g, cmesh, 'data', e))
    err = {k: jnp.zeros((4, inp[f'c0/{k}'][0].size), jnp.float32)
           for k in ('w', 'b')}
    for s in range(int(inp['steps'])):
        g = {k: jnp.asarray(inp[f'c{s}/{k}']) for k in ('w', 'b')}
        with cmesh:
            mean, err = step(g, err)
        for k in ('w', 'b'):
            out[f'c{s}/mean/{k}'] = np.asarray(mean[k])
            out[f'c{s}/err/{k}'] = np.asarray(err[k])
    # one device, one eager call
    one = Mesh(np.array(jax.devices()[:1]), ('data',))
    g = {k: jnp.asarray(inp[f'one/{k}']) for k in ('w', 'b')}
    with one:
        mean, err = compressed_mean(g, one, 'data')
    for k in ('w', 'b'):
        out[f'one/mean/{k}'] = np.asarray(mean[k])
        out[f'one/err/{k}'] = np.asarray(err[k])
    np.savez(sys.argv[2], **out)
''')


@pytest.fixture(scope='module')
def jax_four_devices(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('jax4')
    inp = {'steps': np.asarray(COMPRESS_STEPS)}
    for name, X, y, g, w in _rank_cases():
        inp.update({f'{name}/X': X, f'{name}/y': y, f'{name}/w': w})
        if g is not None:
            inp[f'{name}/g'] = g
    for s, summ in enumerate(_summands(4)):
        inp.update({f'c{s}/{k}': v for k, v in summ.items()})
    inp.update({f'one/{k}': v for k, v in _one_device_summand().items()})
    np.savez(tmp / 'in.npz', **inp)
    src = os.path.join(os.path.dirname(__file__), '..', 'src')
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS='cpu')
    env.pop('XLA_FLAGS', None)
    with open(tmp / 'stderr.txt', 'w+') as err:
        proc = subprocess.Popen([sys.executable, '-c', _JAX_PROG,
                                 str(tmp / 'in.npz'), str(tmp / 'out.npz')],
                                stdout=subprocess.DEVNULL, stderr=err,
                                env=env)
        try:
            # the port's ranks of the same inputs run meanwhile
            for shape in ((2, 2), (4, 1)):
                _mesh_run(shape, tmp_path_factory)
            rc = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        err.seek(0)
        assert rc == 0, err.read()[-4000:]
    return dict(np.load(tmp / 'out.npz'))


@pytest.mark.parametrize('layout', ['dense', 'csr'])
@pytest.mark.parametrize('name', ['grouped', 'ungrouped'])
def test_four_ranks_match_the_reference_on_four_devices(
        name, layout, jax_four_devices, tmp_path_factory):
    res, _ = _mesh_run((2, 2), tmp_path_factory)
    loss_j = float(jax_four_devices[f'{name}/{layout}/loss'])
    a_j = jax_four_devices[f'{name}/{layout}/a'].astype(np.float64)
    for variant in TD.VARIANTS:
        for engine in TC.ENGINES:
            for r in res:
                got = r['calls'][f'{name}/{layout}/{variant}/{engine}']
                assert float(got['loss']) == pytest.approx(loss_j,
                                                           rel=LOSS_REL)
                np.testing.assert_allclose(
                    got['a'], a_j, rtol=0, atol=A_REL * np.abs(a_j).max())


def test_compressed_mean_matches_the_reference_on_four_devices(
        jax_four_devices, tmp_path_factory):
    """30 error-feedback steps of 4 ranks against the reference's 4
    devices. The reference runs as one jitted program, whose float32
    rounding differs from eager by an ulp here and there (XLA may divide
    by a reciprocal); where a value then sits at a rounding tie of the
    int8 grid it lands one quantum away, and error feedback carries that
    on. So each mean and residual is within one int8 quantum (its scale,
    max-abs / 127) of the reference's, and almost every element within
    float32 rounding of it."""
    res, _ = _mesh_run((4, 1), tmp_path_factory)
    summands = _summands(4)
    for s in range(COMPRESS_STEPS):
        for r in res:
            mean, err = r['compress'][s]
            i = r['coords']['data']
            for k in ('w', 'b'):
                want = jax_four_devices[f'c{s}/mean/{k}'][i]
                want_err = jax_four_devices[f'c{s}/err/{k}'][i]
                prev = (jax_four_devices[f'c{s - 1}/err/{k}'][i].reshape(
                    want.shape) if s else 0.0)
                local = np.abs(summands[s][k][i] + prev).max()
                for got, ref, quantum in (
                        (mean[k], want, np.abs(want).max() / 127),
                        (err[k], want_err, local / 127)):
                    diff = np.abs(got.reshape(-1) - ref.reshape(-1))
                    assert diff.max() <= 1.01 * quantum, (s, k)
                    assert np.mean(diff > 1e-5 * quantum * 127) < 0.02, (s, k)


def test_mesh_counts_equal_one_rank(mesh_run):
    shape, res, path = mesh_run
    assert sorted(tuple(r['coords'].values()) for r in res) == sorted(
        np.ndindex(*shape))
    for key, name, (c1, d1, _, _) in _calls(res, path):
        for r in res:
            r0, r1 = r['rows'][name]
            real = max(0, min(r1, M_RANKS) - r0)
            got = r['calls'][key]
            assert got['c'].shape == (r1 - r0,)
            np.testing.assert_array_equal(got['c'][:real], c1[r0:r0 + real],
                                          err_msg=key)
            np.testing.assert_array_equal(got['d'][:real], d1[r0:r0 + real],
                                          err_msg=key)
            # pad rows pair with nothing
            assert not got['c'][real:].any() and not got['d'][real:].any()


def test_mesh_loss_and_subgrad_equal_one_rank(mesh_run):
    _, res, path = mesh_run
    for key, _, (_, _, loss1, a1) in _calls(res, path):
        for r in res:
            got = r['calls'][key]
            assert got['loss'] == loss1, key
            np.testing.assert_array_equal(got['a'], a1, err_msg=key)


def test_mesh_batched_step_equals_single_calls(mesh_run):
    """The batched step of the path sweep on every mesh: row k of a batch
    (L, n) of iterates gives the one-rank port's call at that iterate."""
    _, res, path = mesh_run
    cases = {c[0]: c for c in _rank_cases()}
    for key, got in res[0]['calls'].items():
        if 'batch_loss' not in got:
            continue
        name, layout, variant, engine = key.split('/')
        _, X, y, g, w = cases[name]
        one = TO.make_oracle(_features(layout, X, path), y, g,
                             method='sharded', variant=variant,
                             engine=engine, stream_block=5, device='cpu')
        for k, wk in enumerate((w, w * 0.5)):
            loss, a = one.loss_and_subgrad(wk)
            for r in res:
                assert r['calls'][key]['batch_loss'][k] == n(loss), key
                np.testing.assert_array_equal(r['calls'][key]['batch_a'][k],
                                              n(a), err_msg=key)


def test_mesh_oracle_names(mesh_run):
    _, res, _ = mesh_run
    names = {'dense': 'sharded', 'csr': 'sharded/csr',
             'stream': 'sharded/stream'}
    for key, got in res[0]['calls'].items():
        assert got['oracle'] == names[key.split('/')[1]]


def test_mesh_fit_leaves_every_rank_the_same_w(mesh_run):
    _, res, path = mesh_run
    assert res[0]['fits']
    for key, fit in res[0]['fits'].items():
        name, layout = key.split('/')
        _, X, y, g, _ = {c[0]: c for c in _rank_cases()}[name]
        one = TO.make_oracle(_features(layout, X, path), y, g,
                             method='sharded', stream_block=5, device='cpu')
        want = bmrm(one, solver='device', **FIT)
        for r in res:
            np.testing.assert_array_equal(r['fits'][key]['w'], fit['w'],
                                          err_msg=key)
        np.testing.assert_array_equal(fit['w'], want.w, err_msg=key)
        assert fit['iterations'] == want.stats.iterations


def test_compressed_mean_meets_the_reference_bars_on_four_ranks(
        tmp_path_factory):
    """The reference's bars (tests/test_compression.py): the one-shot int8
    mean within 5% of the exact one, and with error feedback the mean of
    30 steps within 2%."""
    res, _ = _mesh_run((4, 1), tmp_path_factory)
    summands = _summands(4)
    for r in res:
        mean0 = r['compress'][0][0]
        for k, v in summands[0].items():
            exact = v.mean(axis=0)
            rel = np.abs(mean0[k] - exact).max() / np.abs(exact).max()
            assert rel < 0.05, (k, rel)
        for k in ('w', 'b'):
            got = sum(step[0][k] for step in r['compress'])
            want = sum(s[k].mean(axis=0) for s in summands)
            bias = np.abs(got - want).mean() / (np.abs(want).mean() + 1e-9)
            assert bias < 0.02, (k, bias)
        # every rank holds the same mean
        for k in ('w', 'b'):
            np.testing.assert_array_equal(r['compress'][-1][0][k],
                                          res[0]['compress'][-1][0][k])


def _one_device_summand():
    rng = np.random.default_rng(3)
    return {'w': rng.normal(size=(1, 32, 16)).astype(np.float32),
            'b': rng.normal(size=(1, 7)).astype(np.float32)}


def test_compressed_mean_one_rank_matches_the_reference(jax_four_devices):
    """One rank against the reference's eager call on one device, bit for
    bit (the call runs in the reference's subprocess, where each eager
    call compiles anew; the error-feedback steps are held to it on four
    devices above)."""
    mesh = default_mesh('cpu')
    out, err = compressed_mean(
        {k: torch.from_numpy(v[0]) for k, v in _one_device_summand().items()},
        mesh, 'data')
    for k in ('w', 'b'):
        np.testing.assert_array_equal(
            n(out[k]), jax_four_devices[f'one/mean/{k}'][0])
        np.testing.assert_array_equal(
            n(err[k]), jax_four_devices[f'one/err/{k}'][0])
    out, _ = compressed_mean(torch.ones(5, dtype=torch.bfloat16), mesh)
    assert out.dtype == torch.bfloat16 and out.shape == (5,)


# ------------------------------------------------------------ estimator


def test_ranksvm_sharded_fit_matches_the_reference_fit():
    """Both fits stop at gap < eps, so each J is within eps of J*: the
    reference's envelope for two such fits (tests/test_sharded_solver.py)
    is eps."""
    X, y, g = CASES['grouped-with-pairless']
    kw = dict(lam=1e-2, eps=1e-2, method='sharded', max_iter=200)
    port = RankSVM(device='cpu', **kw).fit(X, y, groups=g)
    ref = JRankSVM(**kw).fit(X, y, groups=g)
    assert port.report_.converged and port.report_.solver == 'device'
    assert isinstance(port.oracle_, TO.ShardedOracle)
    assert abs(port.report_.objective - ref.report_.objective) <= 1e-2
    assert abs(port.objective(X, y, g) - ref.objective(X, y, g)) <= 1e-2


def test_ranksvm_sharded_path_vmap_matches_sequential():
    """The bars of the reference's sharded path test: every lambda
    converged, J within 2e-2 relative or 2e-3 absolute."""
    X, y, g = CASES['grouped-with-pairless']
    svm = RankSVM(eps=1e-2, method='sharded', device='cpu', qp_iters=64)
    pv = svm.path(X, y, [1e-1, 1e-2], groups=g, mode='vmap')
    ps = svm.path(X, y, [1e-1, 1e-2], groups=g, mode='sequential')
    assert all(p.report.converged for p in pv + ps)
    assert all(p.report.solver == 'vmap' for p in pv)
    for a, b in zip(pv, ps):
        assert a.report.objective == pytest.approx(b.report.objective,
                                                   rel=2e-2, abs=2e-3)


def test_ranksvm_sharded_refit_streams_its_store():
    """`refit` after a sharded fit: the merged store is a row-block source,
    which the sharded oracle reads rank by rank ('sharded/stream'); the
    ledger refit's J is within eps of a cold sharded fit of the merged
    data."""
    rng = np.random.default_rng(9)
    X = rng.integers(-4, 5, size=(120, 4)) * 0.5
    y = rng.integers(0, 4, 120).astype(np.float64)
    g = np.arange(120) // 12
    kw = dict(lam=1e-2, eps=1e-2, method='sharded', device='cpu',
              qp_iters=64)
    svm = RankSVM(**kw).fit(X[:96], y[:96], g[:96])
    rep = svm.refit(X[96:], y[96:], g[96:], mode='ledger')
    assert rep.mode == 'ledger' and rep.fit.converged
    assert svm.oracle_.name == 'sharded/stream'
    cold = RankSVM(**kw).fit(X, y, g)
    assert abs(svm.objective(X, y, g) - cold.objective(X, y, g)) <= 1e-2


def test_ranksvm_takes_the_mesh_device():
    mesh = make_mesh((1, 1), ('data', 'model'), device='cpu')
    svm = RankSVM(method='sharded', mesh=mesh)
    assert svm.device == torch.device('cpu')
    X, y, g = CASES['two-groups-of-two']
    svm.fit(X, y, g)
    assert svm.oracle_.mesh is mesh


# -------------------------------------------------------------- gates


@pytest.mark.parametrize('loss', ['toppush', 'poshinge'])
def test_sharded_rejects_unsupported_loss_up_front(loss):
    """Another loss fails before X is read: X is a bare object, which any
    densify or transfer would trip over with a TypeError."""
    untouchable = object()
    y = np.arange(4.0)
    with pytest.raises(ValueError, match='sharded mesh oracle'):
        TO.make_oracle(untouchable, y, method='sharded', loss=loss,
                       device='cpu')
    with pytest.raises(ValueError, match='sharded mesh oracle'):
        TO.ShardedOracle(untouchable, y, loss=loss, device='cpu')
    X, y2, g = CASES['grouped-singletons']
    with pytest.raises(ValueError, match='sharded mesh oracle'):
        RankSVM(method='sharded', loss=loss, device='cpu').fit(X, y2, g)
    with pytest.raises(ValueError, match="method='tree'"):
        TD.validate_sharded_loss(loss)


def test_model_axis_must_divide_n():
    mesh = Mesh({'data': 1, 'model': 2}, {'data': 0, 'model': 0}, {}, 'cpu')
    X, y, _ = CASES['ungrouped-mixed']            # n = 5
    with pytest.raises(ValueError, match="'model' axis of size 2 does not "
                       'divide the feature dim n=5'):
        TO.ShardedOracle(X, y, mesh=mesh)


def test_many_groups_precision_warns():
    rng = np.random.default_rng(13)
    m, n_groups = 2048, 1024
    X = rng.normal(size=(m, 4))
    y = rng.uniform(0, 1e5, size=m)
    g = np.repeat(np.arange(n_groups), m // n_groups)
    with pytest.warns(RuntimeWarning, match='key-offset'):
        TO.ShardedOracle(X, y, groups=g, device='cpu')
    # within the envelope: no warning
    X, y, g = CASES['grouped-singletons']
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        TO.ShardedOracle(X, y, groups=g, device='cpu')


def test_sharded_oracle_validates_its_arguments():
    X, y, g = CASES['grouped-singletons']
    with pytest.raises(ValueError, match='variant'):
        TO.ShardedOracle(X, y, variant='fast', device='cpu')
    with pytest.raises(ValueError, match='engine'):
        TO.ShardedOracle(X, y, engine='trie', device='cpu')
    with pytest.raises(ValueError, match='prefetch'):
        TO.ShardedOracle(X, y, prefetch=-1, device='cpu')
    with pytest.raises(ValueError, match='rows but y has'):
        TO.ShardedOracle(X, y[:-1], device='cpu')
    with pytest.raises(ValueError, match='NaN'):
        TO.ShardedOracle(X, y, groups=np.where(g == 0, np.nan, g),
                         device='cpu')
    with pytest.raises(ValueError, match='preference pairs'):
        TO.ShardedOracle(X, np.zeros_like(y), device='cpu')
    with pytest.raises(ValueError, match='mesh is on'):
        TO.ShardedOracle(X, y, mesh=default_mesh('cpu'), device='cuda')


def test_sharded_oracle_metadata():
    X, y, g = CASES['grouped-singletons']
    o = TO.make_oracle(X, y, g, method='sharded', device='cpu')
    ref = JO.ShardedOracle(X, y, groups=g)
    assert (o.m, o.n, o.n_pairs, o.norm) == (ref.m, ref.n, ref.n_pairs,
                                             float(ref.n_pairs))
    for flag in ('device_resident', 'supports_device_solver',
                 'prefer_device_solver', 'supports_path_vmap'):
        assert getattr(o, flag) is getattr(ref, flag) is True
    assert o.device == torch.device('cpu') and o.block.rows == (0, o.m)


# ----------------------------------------------------------- the pieces


def test_mesh_without_a_process_group():
    mesh = make_mesh((1, 1), ('data', 'model'), device='cpu')
    assert mesh.groups == {} and mesh.size('rows') == 1
    t = torch.arange(6.0)
    assert mesh.all_gather(t, 'rows') is t
    assert torch.equal(mesh.sum(t, 'model'), t)
    assert mesh.all_to_all(t, 'data') is t
    with pytest.raises(ValueError, match='initialized process group'):
        make_mesh((2, 1), ('data', 'model'), device='cpu')
    with pytest.raises(ValueError, match='distinct names'):
        make_mesh((1, 1), ('data', 'rows'), device='cpu')
    with pytest.raises(ValueError, match='differ in length'):
        make_mesh((1,), ('data', 'model'), device='cpu')


def test_rank_block_splits_rows_and_columns():
    mesh = Mesh({'pod': 2, 'data': 2, 'model': 2},
                {'pod': 1, 'data': 0, 'model': 1}, {}, 'cpu')
    assert mesh.size('rows') == 4 and mesh.index('rows') == 2
    blk = TD.rank_block(mesh, 64, 10)
    assert blk.rows == (32, 48) and blk.cols == (5, 10)
    with pytest.raises(ValueError, match='does not split'):
        TD.rank_block(mesh, 63, 10)


@pytest.mark.parametrize('rows', [(0, 40), (13, 29), (39, 40), (7, 7)])
def test_half_counts_query_split_equals_the_whole(rows):
    rng = np.random.default_rng(2)
    p = torch.as_tensor(rng.integers(-3, 4, 40) * 0.5, dtype=torch.float32)
    y = torch.as_tensor(rng.integers(0, 3, 40), dtype=torch.float32)
    r0, r1 = rows
    for sign in (1.0, -1.0):
        full = TC._half_counts(sign * p, sign * y)
        part = TC._half_counts(sign * p, sign * y, rows)
        assert part.dtype == torch.int32
        assert torch.equal(part, full[r0:r1])


def test_csr_slot_arrays_match_the_reference():
    from repro.core.distributed import csr_slot_arrays as j_slots
    X = CASES['grouped-singletons'][0].copy()
    X[3] = 0.0                                      # an empty row
    csr = CSRMatrix.from_dense(X)
    got = TD.csr_slot_arrays(csr.data, csr.indices, csr.indptr, csr.shape,
                             pad_rows=3)
    want = j_slots(csr.data, csr.indices, csr.indptr, csr.shape,
                   pad_rows=3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert TD.REUTERS_1M == TD.RankSVMShapeConfig('reuters_1m', 1 << 20,
                                                  49152)
