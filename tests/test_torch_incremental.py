"""Port parity of incremental retraining (`repro_torch.core.incremental`,
`RankSVM.refit`, `data.rowblocks.BlockStore`) against the JAX package's
`repro.core.incremental` on the same seeded numpy inputs, at the sizes of
tests/test_incremental.py (m <= 800).

Bars: `cadata_drift` arrays equal; `PlaneLedger.planes()` bit-equal to
the reference's on the same `LedgerBlock`s, through append and retire;
`block_partials` within the oracle layer's differential tolerances
(rtol 1e-6, atol 1e-7 before scaling by the block's pair count) on
`tests/oracle_ref.py`'s quantized cases, pair counts equal;
`bundle_state_from_planes` bit-equal in every field; each refit scenario
resolves to the reference's mode, and its objective is within eps of the
reference's (each solve stops within eps of the same optimum); the
checkpointed chunk-loop resume bit-identical to the uninterrupted run."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from oracle_ref import differential_fit_cases  # noqa: E402
from repro.core import bmrm as JB  # noqa: E402
from repro.core import incremental as JI  # noqa: E402
from repro.data import BlockStore as JBlockStore  # noqa: E402
from repro.data import CSRMatrix as JCSRMatrix  # noqa: E402
from repro.data import cadata_drift as jax_cadata_drift  # noqa: E402
from repro_torch.core import bmrm as TB  # noqa: E402
from repro_torch.core import counts as TC  # noqa: E402
from repro_torch.core import incremental as TI  # noqa: E402
from repro_torch.core import oracle as TO  # noqa: E402
from repro_torch.core.ranksvm import REFIT_MODES, RankSVM  # noqa: E402
from repro_torch.data import BlockStore, CSRMatrix, cadata_drift  # noqa: E402
from repro_torch.runtime import (LoopConfig, SimulatedPreemption,  # noqa: E402
                                 run)
from torch_parity import n, torch_one_thread  # noqa: E402,F401

EPS = 1e-3
TOL = dict(rtol=1e-6, atol=1e-7)
CASES = list(differential_fit_cases())


def _drift(m=300, frac=0.1, seed=0):
    return cadata_drift(m=m, m_delta=max(8, int(m * frac)), seed=seed)


# ------------------------------------------------------------------ data


@pytest.mark.parametrize('m,m_delta,shift,seed', [(300, 30, 0.5, 0),
                                                  (800, 80, 1.5, 3)])
def test_cadata_drift_is_the_reference_data(m, m_delta, shift, seed):
    got = cadata_drift(m=m, m_delta=m_delta, shift=shift, seed=seed)
    want = jax_cadata_drift(m=m, m_delta=m_delta, shift=shift, seed=seed)
    for a, b in ((got[0].X, want[0].X), (got[0].y, want[0].y),
                 (got[0].X_test, want[0].X_test), (got[1], want[1]),
                 (got[2], want[2])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --------------------------------------------------------- ledger algebra


def _toy_ledgers(P=5, nf=6, seed=0):
    rng = np.random.default_rng(seed)
    S = rng.normal(size=(P, nf))
    alpha = rng.dirichlet(np.ones(P))
    ell, g = rng.normal(size=P), rng.normal(size=(P, nf))
    return (TI.PlaneLedger(S, alpha, TI.LedgerBlock(ell, g, 40), (0, 1)),
            JI.PlaneLedger(S, alpha, JI.LedgerBlock(ell, g, 40), (0, 1)))


def _assert_planes_equal(port, ref):
    (A, b), (Aj, bj) = port.planes(), ref.planes()
    np.testing.assert_array_equal(A, Aj)
    np.testing.assert_array_equal(b, bj)


@pytest.mark.parametrize('order', [(2, 3), (3, 2), (2,)])
def test_ledger_planes_bit_equal_to_reference(order):
    """Append, retire in either order: the port's planes equal the
    reference's bit for bit at every step, and retiring every appended
    block restores the never-appended planes exactly."""
    port, ref = _toy_ledgers()
    A0, b0 = port.planes()
    _assert_planes_equal(port, ref)
    rng = np.random.default_rng(3)
    for bid, pairs in ((2, 11), (3, 7)):
        ell, g = rng.normal(size=5), rng.normal(size=(5, 6))
        port.append_block(bid, TI.LedgerBlock(ell, g, pairs))
        ref.append_block(bid, JI.LedgerBlock(ell, g, pairs))
        _assert_planes_equal(port, ref)
    assert port.n_pairs == ref.n_pairs == 58
    for bid in order:
        port.retire_block(bid)
        ref.retire_block(bid)
        _assert_planes_equal(port, ref)
    if len(order) == 2:
        A, b = port.planes()
        np.testing.assert_array_equal(A, A0)
        np.testing.assert_array_equal(b, b0)
    for led, err in ((port, TI.BaseRetireError), (ref, JI.BaseRetireError)):
        with pytest.raises(err, match='base component'):
            led.retire_block(1)
        with pytest.raises(ValueError, match='not in the ledger'):
            led.retire_block(99)
        with pytest.raises(ValueError, match='already in the ledger'):
            led.append_block(0, TI.LedgerBlock(np.zeros(5),
                                               np.zeros((5, 6)), 1))


def test_ledger_validation_matches_reference():
    for mod in (TI, JI):
        with pytest.raises(ValueError, match='do not align'):
            mod.PlaneLedger(np.zeros((3, 4)), np.zeros(2),
                            mod.LedgerBlock(np.zeros(3), np.zeros((3, 4)), 1),
                            ())
        with pytest.raises(ValueError, match='base component'):
            mod.PlaneLedger(np.zeros((3, 4)), np.zeros(3),
                            mod.LedgerBlock(np.zeros(2), np.zeros((2, 4)), 1),
                            ())
        led = mod.PlaneLedger(np.zeros((2, 3)), np.zeros(2),
                              mod.LedgerBlock(np.zeros(2), np.zeros((2, 3)),
                                              0), ())
        with pytest.raises(ValueError, match='no preference pairs'):
            led.planes()
    assert TI.LEDGER_LOSSES == JI.LEDGER_LOSSES
    assert REFIT_MODES == ('ledger', 'w-only', 'auto')


@pytest.mark.parametrize('case,loss', [(c, 'hinge') for c in CASES] + [
    (c, 'toppush') for c in CASES[:4:3]], ids=[
        f'{loss}-{c[0]}' for c, loss in [(c, 'hinge') for c in CASES]
        + [(c, 'toppush') for c in CASES[:4:3]]])
def test_block_partials_match_reference(case, loss):
    name, X, y, g = case
    rng = np.random.default_rng(sum(map(ord, name)))
    S = rng.integers(-4, 5, size=(3, X.shape[1])) * 0.25
    got = TI.block_partials(X, y, g, S, loss=loss, device='cpu')
    want = JI.block_partials(X, y, g, S, loss=loss)
    assert got.n_pairs == want.n_pairs > 0
    scale = float(want.n_pairs)
    np.testing.assert_allclose(got.ell / scale, want.ell / scale, **TOL)
    np.testing.assert_allclose(got.g / scale, want.g / scale, **TOL)


def test_block_partials_pairless_and_poshinge():
    X = np.random.default_rng(0).normal(size=(5, 4))
    blk = TI.block_partials(X, np.ones(5), None, np.zeros((2, 4)),
                            device='cpu')
    assert blk.n_pairs == 0
    np.testing.assert_array_equal(blk.ell, np.zeros(2))
    np.testing.assert_array_equal(blk.g, np.zeros((2, 4)))
    with pytest.raises(ValueError, match='per-block plane decomposition'):
        TI.block_partials(X, np.arange(5.0), None, np.zeros((2, 4)),
                          loss='poshinge', device='cpu')


# ------------------------------------------------------------ BlockStore


def _stores(parts, ys, groups=None):
    port, ref = BlockStore(), JBlockStore()
    for i, (P, yy) in enumerate(zip(parts, ys)):
        gg = None if groups is None else groups[i]
        port.append(P, yy, gg)
        ref.append(P, yy, gg)
    return port, ref


def test_blockstore_matches_reference_across_members():
    rng = np.random.default_rng(4)
    parts = [rng.normal(size=(m, 5)) for m in (7, 11, 3)]
    ys = [rng.normal(size=P.shape[0]) for P in parts]
    gs = [np.full(P.shape[0], i) for i, P in enumerate(parts)]
    port, ref = _stores(parts, ys, gs)
    assert (port.m, port.n) == (ref.m, ref.n) == (21, 5)
    w, v = rng.normal(size=5), rng.normal(size=port.m)
    np.testing.assert_array_equal(port.block(4, 16), ref.block(4, 16))
    np.testing.assert_array_equal(port.matvec_block(0, port.m, w),
                                  ref.matvec_block(0, ref.m, w))
    np.testing.assert_array_equal(port.rmatvec_block(2, 20, v[2:20]),
                                  ref.rmatvec_block(2, 20, v[2:20]))
    for (lo, hi, pp), (_, _, pr) in zip(port.iter_payloads(4),
                                        ref.iter_payloads(4)):
        np.testing.assert_array_equal(port._payload_matvec(pp, w),
                                      ref._payload_matvec(pr, w))
    np.testing.assert_array_equal(port.y, ref.y)
    np.testing.assert_array_equal(port.groups, ref.groups)
    np.testing.assert_array_equal(port.materialize(), ref.materialize())
    port.retire(0)
    ref.retire(0)
    assert port.block_ids == ref.block_ids == (1, 2)
    assert port.member_range(1) == ref.member_range(1) == (0, 11)
    np.testing.assert_array_equal(port.y, ref.y)
    with pytest.raises(ValueError, match='retained'):
        port.retire(0)


def test_blockstore_csr_materialize_matches_reference():
    rng = np.random.default_rng(8)
    dense = (rng.random(size=(12, 6)) < 0.3) * rng.normal(size=(12, 6))
    ys = [rng.normal(size=5), rng.normal(size=7)]
    port, ref = BlockStore(), JBlockStore()
    port.append(CSRMatrix.from_dense(dense[:5]), ys[0])
    port.append(CSRMatrix.from_dense(dense[5:]), ys[1])
    ref.append(JCSRMatrix.from_dense(dense[:5]), ys[0])
    ref.append(JCSRMatrix.from_dense(dense[5:]), ys[1])
    got, want = port.materialize(), ref.materialize()
    assert isinstance(got, CSRMatrix)
    np.testing.assert_array_equal(got.to_dense(), want.to_dense())
    np.testing.assert_array_equal(np.asarray(got.indptr),
                                  np.asarray(want.indptr))
    assert not port.disk_backed
    with pytest.raises(ValueError, match='empty'):
        BlockStore().materialize()


def test_blockstore_validation_and_disk_backing(tmp_path):
    store = BlockStore()
    store.append(np.zeros((3, 4)), np.arange(3.0))
    with pytest.raises(ValueError, match='features'):
        store.append(np.zeros((2, 5)), np.zeros(2))
    with pytest.raises(ValueError, match='y'):
        store.append(np.zeros((2, 4)), np.zeros(3))
    with pytest.raises(ValueError, match='group'):
        store.append(np.zeros((2, 4)), np.zeros(2), groups=np.zeros(2, int))
    with pytest.raises(ValueError, match='BlockStore'):
        store.append(BlockStore(), np.zeros(0))
    mm = np.memmap(tmp_path / 'x.bin', dtype=np.float32, mode='w+',
                   shape=(4, 4))
    mm[:] = 1.0
    store.append(mm, np.arange(4.0))
    assert store.disk_backed and store.block_ids == (0, 1)


def test_blockstore_keeps_a_tensor_in_place():
    """A store of one tensor hands the tensor itself to the fused oracle:
    the fit's features are neither copied nor moved; several tensor
    members concatenate on their device; y lands on the host."""
    X = torch.randn(64, 6, generator=torch.Generator().manual_seed(0))
    y = torch.arange(64, dtype=torch.float32) % 5
    store = BlockStore()
    store.append(X, y)
    assert store.materialize() is X
    assert store.y.dtype == np.float32 and isinstance(store.y, np.ndarray)
    svm = RankSVM(eps=EPS, device='cpu').fit(X, y)
    assert svm.oracle_._feats.X.data_ptr() == X.data_ptr()
    assert svm.incremental_.store.member(0).source.tensor is X
    store.append(X[:10], y[:10])
    both = store.materialize()
    assert torch.equal(both, torch.cat([X, X[:10]]))
    np.testing.assert_array_equal(store.block(60, 66), n(both[60:66]))


def test_grouped_pallas_counts_through_the_kernel_route():
    """Grouped counting under engine='pallas' offsets the scores only and
    subtracts the cross-group pairs: (c, d) equal the offset-utility
    tree's bit for bit, batched rows too."""
    rng = np.random.default_rng(2)
    for m, n_groups in ((60, 3), (700, 40), (900, 300)):
        p = torch.tensor((rng.integers(-4, 5, size=m) * 0.5)
                         .astype(np.float32))
        y = torch.tensor(rng.integers(0, 5, size=m).astype(np.float32))
        g = torch.tensor(rng.integers(0, n_groups, size=m))
        P = torch.stack([p, 2 * p, -p])
        for q in (p, P):
            c, d = TC.make_counter(y, g, engine='pallas')(q)
            ct, dt = TC.make_counter(y, g, engine='tree')(q)
            assert torch.equal(c, ct) and torch.equal(d, dt)


# ------------------------------------------------ bundle_state_from_planes


@pytest.mark.parametrize('P,alpha', [(0, None), (3, None), (4, 'given'),
                                     (4, 'zero')])
def test_bundle_state_from_planes_bit_equal(P, alpha):
    rng = np.random.default_rng(P)
    nf, K = 7, 6
    A, b, S = (rng.normal(size=(P, nf)), rng.normal(size=P),
               rng.normal(size=(P, nf)))
    al = {None: None, 'given': rng.random(P), 'zero': np.zeros(P)}[alpha]
    w0 = rng.normal(size=nf)
    got = TB.bundle_state_from_planes(A, b, S, nf, K, w0=w0, alpha=al,
                                      device='cpu')
    want = JB.bundle_state_from_planes(A, b, S, nf, K, w0=w0, alpha=al)
    for f in TB.BundleState._fields:
        gf, wf = n(getattr(got, f)), np.asarray(getattr(want, f))
        assert gf.dtype == wf.dtype, f
        np.testing.assert_array_equal(gf, wf, err_msg=f)
    with pytest.raises(ValueError, match='exceed'):
        TB.bundle_state_from_planes(np.zeros((K + 1, nf)), np.zeros(K + 1),
                                    np.zeros((K + 1, nf)), nf, K,
                                    device='cpu')


# ----------------------------------------------------------- refit


def test_refit_ledger_warm_start_beats_cold():
    """The reference's acceptance bar on its 10% drift case: the ledger
    refit reaches eps in at most half the cold fit's iterations, at an
    objective within the eps envelope."""
    base, Xd, yd = _drift(m=800, frac=0.1)
    svm = RankSVM(method='tree', eps=EPS, max_iter=400,
                  device='cpu').fit(base.X, base.y)
    rep = svm.refit(Xd, yd, mode='ledger')
    cold = RankSVM(method='tree', eps=EPS, max_iter=400, device='cpu').fit(
        np.concatenate([base.X, Xd]), np.concatenate([base.y, yd]))
    assert rep.mode == 'ledger' and rep.n_planes > 0 and rep.fit.converged
    assert rep.delta_rows == len(yd)
    assert rep.fit.iterations <= 0.5 * cold.report_.iterations
    assert abs(rep.fit.objective - cold.report_.objective) <= 2 * EPS


def test_refit_revalidated_planes_lower_bound_merged_risk():
    """After an append, every merged plane is a lower bound of the merged
    risk at arbitrary w. Queries of ten rows, none spanning the blocks,
    make the ledger exact: its pair count is the merged one. (Without
    groups the ledger's count leaves out the cross-block pairs, and its
    planes need not bound the merged risk.)"""
    base, Xd, yd = _drift(m=300, seed=5)
    gb, gd = np.arange(300) // 10, 100 + np.arange(len(yd)) // 10
    svm = RankSVM(method='tree', eps=EPS, device='cpu').fit(base.X, base.y,
                                                            gb)
    inc = svm.incremental_
    inc.append(Xd, yd, gd)
    A, b = inc.ledger.planes()
    merged = TO.make_oracle(np.concatenate([base.X, Xd]),
                            np.concatenate([base.y, yd]),
                            np.concatenate([gb, gd]), device='cpu')
    assert inc.ledger.n_pairs == merged.n_pairs
    rng = np.random.default_rng(5)
    for w in [np.zeros(A.shape[1]), svm.w_,
              *(rng.normal(size=A.shape[1]) for _ in range(4))]:
        risk = float(merged.loss_and_subgrad(w)[0])
        assert (A @ w + b).max() <= risk + 1e-4 * max(1.0, abs(risk))


# ------------------------------------------- checkpointed resume mid-refit


def test_refit_chunk_step_checkpoint_resume_bit_identical(tmp_path):
    base, _, _ = _drift(m=250, seed=9)
    orc = TO.make_oracle(base.X, base.y, method='tree', device='cpu')
    step = TI.refit_chunk_step(orc, lam=1e-3, eps=1e-4, sync_every=4)

    def init_fn(device):
        return TB.init_bundle_state(int(orc.n), TB.DEFAULT_MAX_PLANES,
                                    device=device)

    def loop(name, **kw):
        lc = LoopConfig(total_steps=8, ckpt_dir=str(tmp_path / name),
                        ckpt_every=2, async_ckpt=False)
        return run(step, init_fn, lambda s: None, lc, device='cpu', **kw)

    state_a, rep_a = loop('a')
    with pytest.raises(SimulatedPreemption):
        loop('b', fail_at=5)
    state_b, rep_b = loop('b')
    assert rep_a.resumed_from is None and rep_b.resumed_from == 4
    assert isinstance(state_b, TB.BundleState)
    for f in TB.BundleState._fields:
        a, b = getattr(state_a, f), getattr(state_b, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    ref = TB.bmrm(orc, lam=1e-3, eps=1e-4, solver='device', max_iter=200)
    assert float(state_a.j_best) <= ref.stats.obj_best * 1.5


# --------------------------------------------- train -> refit -> serve


def test_refit_hot_swaps_into_ranking_service():
    from repro_torch.serve import RankingService, WeightStore
    base, Xd, yd = _drift(m=300, seed=7)
    svm = RankSVM(method='auto', eps=EPS, max_iter=400, memory_budget=1.0,
                  device='cpu').fit(base.X, base.y)
    with RankingService(svm, micro_batch=False, device='cpu') as svc:
        v0 = svc.version
        Xq = np.asarray(base.X_test[:64], np.float32)
        s_old = svc.scores(Xq)
        rep = svm.refit(Xd, yd, weight_store=svc)
        assert rep.fit.converged
        assert svc.version == v0 + 1
        s_new = svc.scores(Xq)
        vals, idx = svc.top_k(Xq, 5)
        ref = np.argsort(-s_new, kind='stable')[:5]
        np.testing.assert_array_equal(idx, ref)
        np.testing.assert_array_equal(vals, s_new[ref])
        assert not np.allclose(s_old, s_new)
    ws = WeightStore(svm, device='cpu')
    svm.refit(Xd[:20], yd[:20], weight_store=ws)
    assert ws.version == 1
    np.testing.assert_array_equal(n(ws.get()[1]),
                                  svm.w_.astype(np.float32))
