"""End-to-end parity of the port's estimator with the JAX package.

`repro_torch.core.RankSVM.fit` on `cadata_like` (real-valued utilities)
and `ordinal_like` (five levels), m = 512, for both BMRM drivers and the
three counting engines of the slice, against one JAX-package fit per
dataset (lambda = 1e-2). Each fit stops when its duality gap is below
eps = 1e-4, so both objectives lie within eps of the optimum: they must
agree to eps (the envelope), and to 1e-3 relative, which eps is below
for these objectives (about 0.25 and 0.12). Held-out ranking errors must
agree to 1e-3.

`repro_torch.convert.from_reference` must carry the JAX package's w and
bundle state across so that both packages score alike and cut the same
next plane (1e-5)."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from repro.core import bmrm as JB  # noqa: E402
from repro.core import oracle as JO  # noqa: E402
from repro.core.ranksvm import RankSVM as JaxRankSVM  # noqa: E402
from repro.data import synthetic as jax_synthetic  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import bmrm as TB  # noqa: E402
from repro_torch.core import oracle as TO  # noqa: E402
from repro_torch.core.ranksvm import RankSVM  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from torch_parity import n, torch_one_thread  # noqa: E402,F401

LAM = 1e-2
EPS = 1e-4
DATASETS = {
    'cadata': lambda: synthetic.cadata_like(m=512, m_test=512, seed=1),
    'ordinal': lambda: synthetic.ordinal_like(m=512, m_test=512, n=16,
                                              seed=2),
}
_REF = {}


def _reference(name):
    """(data, JAX-package fit) per dataset, fitted once per module."""
    if name not in _REF:
        data = DATASETS[name]()
        ref = JaxRankSVM(lam=LAM, eps=EPS, method='tree',
                         solver='device').fit(
            data.X, data.y)
        _REF[name] = (data, ref)
    return _REF[name]


@pytest.mark.parametrize('engine', ['tree', 'pallas', 'auto'])
@pytest.mark.parametrize('solver', ['host', 'device'])
@pytest.mark.parametrize('name', list(DATASETS))
def test_fit_matches_jax_package(name, solver, engine):
    data, ref = _reference(name)
    svm = RankSVM(lam=LAM, eps=EPS, method='tree', solver=solver,
                  engine=engine, device='cpu').fit(data.X, data.y)
    rep = svm.report_
    assert rep.converged and rep.solver == solver and rep.gap < EPS
    j_ref = ref.objective(data.X, data.y)
    j = svm.objective(data.X, data.y)
    assert abs(j - j_ref) <= EPS
    assert abs(j - j_ref) <= 1e-3 * j_ref
    assert abs(svm.ranking_error(data.X_test, data.y_test)
               - ref.ranking_error(data.X_test, data.y_test)) <= 1e-3


@pytest.mark.parametrize('name', list(DATASETS))
def test_synthetic_data_is_the_reference_data(name):
    data = DATASETS[name]()
    fn = getattr(jax_synthetic,
                 'cadata_like' if name == 'cadata' else 'ordinal_like')
    kw = (dict(m=512, m_test=512, seed=1) if name == 'cadata'
          else dict(m=512, m_test=512, n=16, seed=2))
    ref = fn(**kw)
    for a, b in ((data.X, ref.X), (data.y, ref.y), (data.X_test, ref.X_test),
                 (data.y_test, ref.y_test)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('name', list(DATASETS))
def test_objective_and_ranking_error_match_at_equal_w(name):
    data, ref = _reference(name)
    svm, _ = convert.from_reference(ref.w_, device='cpu', lam=LAM)
    np.testing.assert_array_equal(svm.decision_function(data.X_test),
                                  ref.decision_function(data.X_test))
    np.testing.assert_allclose(svm.objective(data.X, data.y),
                               ref.objective(data.X, data.y), rtol=1e-6)
    np.testing.assert_allclose(
        svm.ranking_error(data.X_test, data.y_test),
        ref.ranking_error(data.X_test, data.y_test), rtol=1e-6)


def test_from_reference_takes_the_same_next_step():
    data = synthetic.cadata_like(m=256, m_test=64, seed=3)
    lam, qp_iters = 1e-3, 64
    jo = JO.make_oracle(data.X, data.y, method='tree')
    res = JB.bmrm(jo, lam=lam, eps=1e-2, solver='device', max_iter=6,
                  sync_every=3, qp_iters=qp_iters)
    fields = {f: np.asarray(getattr(res.state, f))
              for f in res.state._fields}
    svm, state = convert.from_reference(res.w, fields, device='cpu',
                                        lam=lam)
    np.testing.assert_array_equal(svm.decision_function(data.X),
                                  np.asarray(data.X) @ res.w)
    to = TO.make_oracle(data.X, data.y, method='tree', device='cpu')
    # one more step from the same state in each package
    j_next, _ = JB._bundle_step(res.state, jo.step_fn(), jnp.float32(lam),
                                jnp.float32(1e-2), qp_iters)
    t_next, _ = TB._bundle_step(state, to.step_fn(),
                                torch.tensor(lam), torch.tensor(1e-2),
                                qp_iters)
    assert int(t_next.n_active) == int(j_next.n_active)
    for f in ('A', 'b', 'S', 'G'):
        np.testing.assert_allclose(n(getattr(t_next, f)),
                                   np.asarray(getattr(j_next, f)),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(t_next.w), np.asarray(j_next.w),
                               rtol=1e-3, atol=1e-5)


def test_device_solver_warm_start_from_converted_state():
    data = synthetic.cadata_like(m=256, m_test=64, seed=4)
    first = TB.bmrm(TO.make_oracle(data.X, data.y, device='cpu'),
                    eps=1e-3, solver='device', max_iter=8, sync_every=4)
    state = {f: n(getattr(first.state, f)) for f in first.state._fields}
    _, st = convert.from_reference(first.w, state, device='cpu')
    again = TB.bmrm(TO.make_oracle(data.X, data.y, device='cpu'),
                    eps=1e-3, solver='device', state=st, sync_every='auto')
    assert again.stats.converged and again.stats.solver == 'device'


def test_sync_every_auto_and_unported_entry_points():
    data = synthetic.ordinal_like(m=256, m_test=64, n=8, seed=5)
    svm = RankSVM(eps=1e-3, sync_every='auto', solver='device',
                  device='cpu').fit(data.X, data.y)
    assert svm.report_.converged
    assert svm.incremental_ is not None and svm.incremental_.ledger
    # the regularization path is ported (tests/test_torch_path.py): a
    # one-lambda path is a fit at that lambda, and leaves a refit handle
    (point,) = svm.path(data.X, data.y, [1e-3], mode='sequential')
    assert point.lam == 1e-3 and point.report.converged
    assert svm.incremental_.ledger.n_planes > 0
    # incremental refits are ported (tests/test_torch_incremental.py)
    rep = svm.refit(data.X_test, data.y_test)
    assert rep.mode == 'ledger' and rep.fit.converged
    assert svm.incremental_.store.m == len(data.y) + len(data.y_test)
    with pytest.raises(ValueError, match='unknown solver'):
        RankSVM(solver='gpu', device='cpu')


@pytest.mark.parametrize('gaps,cur,want', [
    ([], 4, 8), ([1e-4], 4, 4), ([1.0, 0.5, 0.25, 0.125], 4, 2),
    ([1.0, 1.0], 32, 32)])
def test_next_sync_every_matches_reference(gaps, cur, want):
    got = TB._next_sync_every(np.asarray(gaps), 1e-3, cur)
    assert got == JB._next_sync_every(np.asarray(gaps), 1e-3, cur) == want


def test_port_imports_neither_jax_nor_the_reference():
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..',
                       'src')
    code = ('import sys; sys.path.insert(0, sys.argv[1]); '
            'import repro_torch, repro_torch.convert, repro_torch.data, '
            'repro_torch.core.ranksvm, repro_torch.kernels._build, '
            'repro_torch.kernels.pairwise_rank.ops, '
            'repro_torch.kernels.rank_counts.ops, '
            'repro_torch.configs.registry, repro_torch.configs.reduced, '
            'repro_torch.models.lm, repro_torch.models.rwkv6, '
            'repro_torch.models.layers, repro_torch.models.params, '
            'repro_torch.launch.steps, repro_torch.kernels.wkv.ops, '
            'repro_torch.kernels.wkv.ref, repro_torch.optim.adamw, '
            'repro_torch.optim.schedules, repro_torch.train.trainer, '
            'repro_torch.data.tokens, repro_torch.launch.train, '
            'repro_torch.core.rank_loss, repro_torch.core.oracle, '
            'repro_torch.data.sparse, repro_torch.data.rowblocks, '
            'repro_torch.data.synthetic, repro_torch.core.joachims, '
            'repro_torch.core.bmrm, repro_torch.serve, '
            'repro_torch.serve.scorer, repro_torch.serve.batching, '
            'repro_torch.core.incremental, repro_torch.checkpoint, '
            'repro_torch.checkpoint.store, repro_torch.runtime, '
            'repro_torch.runtime.loop, repro_torch.core.distributed, '
            'repro_torch.launch.mesh, repro_torch.distributed, '
            'repro_torch.distributed.compression; '
            "assert 'jax' not in sys.modules, 'the port pulled in jax'; "
            "assert 'repro' not in sys.modules, "
            "'the port pulled in the JAX package'; "
            "assert 'msgpack' not in sys.modules, "
            "'the port pulled in msgpack'")
    subprocess.run([sys.executable, '-c', code, src], check=True,
                   timeout=120)


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    """Every import in chip_smoke.py (its phases import lazily) names
    neither jax nor the JAX package; without a card it exits non-zero
    and prints no result."""
    import ast
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
    path = os.path.join(root, 'chip_smoke.py')
    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or '')
    assert 'repro_torch.train.trainer' in names
    for name in names:
        top = name.split('.')[0]
        assert top not in ('jax', 'jaxlib', 'repro'), name
    if not torch.cuda.is_available():
        proc = subprocess.run([sys.executable, path], capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode != 0 and '"ok": true' not in proc.stdout
