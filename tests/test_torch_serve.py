"""Port parity: the serving layer (`repro_torch.serve`: bucketed `Scorer`,
`WeightStore`, `MicroBatcher`, `RankingService`) and `RankSVM.scores` /
`top_k`, against the JAX package's `repro.serve` on the same numpy inputs.

Candidates and weights are quantized (features on a 0.5 grid, weights on
a 0.25 grid), so every float32 product and sum is exact in both packages:
scores are then equal bit for bit, and top-k indices and grouped
rankings must be equal, ties included. No test here depends on wall-clock
time or on how threads are scheduled: the micro-batcher's coalescing and
hot-swap checks hold the worker inside a launch with events, and the
adaptive window runs on a fake clock."""

import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from repro import serve as JS  # noqa: E402
from repro_torch.core.ranksvm import RankSVM  # noqa: E402
from repro_torch.serve import (MicroBatcher, RankingService,  # noqa: E402
                               Scorer, WeightStore, batching, bucket_for)
from torch_parity import torch_one_thread  # noqa: E402,F401

D = 8
TIMEOUT = 60.0          # a bound on a hung worker, not a timing assumption


def _problem(n, d=D, seed=0):
    """Quantized candidates and weights: exact float32 scores."""
    rng = np.random.default_rng(seed)
    X = (rng.integers(-4, 5, size=(n, d)) * 0.5).astype(np.float32)
    w = (rng.integers(-8, 9, size=d) * 0.25).astype(np.float32)
    return X, w


def _scorer(w, **kw):
    return Scorer(w, device='cpu', **kw)


# -- bucketing and the entry points ------------------------------------------


@pytest.mark.parametrize('n,min_bucket', [(1, 64), (63, 64), (64, 64),
                                          (65, 64), (128, 64), (129, 64),
                                          (3, 2), (4097, 64)])
def test_bucket_for_boundaries(n, min_bucket):
    assert bucket_for(n, min_bucket) == JS.bucket_for(n, min_bucket)
    with pytest.raises(ValueError, match='n >= 1'):
        bucket_for(0)


@pytest.mark.parametrize('n', [1, 2, 63, 64, 65, 127, 128, 129, 257])
def test_scores_equal_reference_across_boundaries(n):
    X, w = _problem(n, seed=n)
    s = _scorer(w).scores(X)
    assert s.dtype == np.float32 and s.shape == (n,)
    np.testing.assert_array_equal(s, JS.Scorer(w).scores(X))
    np.testing.assert_array_equal(s, X @ w)


@pytest.mark.parametrize('n,k', [(1, 1), (5, 3), (64, 64), (65, 1),
                                 (65, 64), (129, 100), (200, 7), (10, 99)])
def test_top_k_equals_reference_and_stable_argsort(n, k):
    X, w = _problem(n, seed=n + 100)
    sc = _scorer(w)
    s = sc.scores(X)
    vals, idx = sc.top_k(X, k)
    ref = np.argsort(-s, kind='stable')[:k]
    np.testing.assert_array_equal(idx, ref)
    np.testing.assert_array_equal(vals, s[ref])
    jv, ji = JS.Scorer(w).top_k(X, k)
    np.testing.assert_array_equal(idx, ji)
    np.testing.assert_array_equal(vals, jv)


def test_top_k_adversarial_ties():
    """Every score five times, then all scores equal: ties go lowest
    index first, as the stable argsort and the reference order them."""
    X, w = _problem(4, seed=3)
    Xt = np.repeat(X, 5, axis=0)
    sc = _scorer(w)
    s = sc.scores(Xt)
    vals, idx = sc.top_k(Xt, 12)
    np.testing.assert_array_equal(idx, np.argsort(-s, kind='stable')[:12])
    np.testing.assert_array_equal(idx, JS.Scorer(w).top_k(Xt, 12)[1])
    _, idx = sc.top_k(np.repeat(X[:1], 9, axis=0), 6)
    np.testing.assert_array_equal(idx, np.arange(6))
    zero = np.zeros((70, D), np.float32)            # all scores 0.0
    vals, idx = sc.top_k(zero, 70)
    np.testing.assert_array_equal(idx, np.arange(70))
    assert np.all(vals == 0.0)


@pytest.mark.parametrize('groups', ['random', 'noncontiguous'])
def test_rank_grouped_equals_reference_and_lexsort(groups):
    if groups == 'random':
        X, w = _problem(50, seed=11)
        X = np.concatenate([X, X[:10]])             # in-group score ties
        g = np.random.default_rng(7).integers(0, 5, size=60).astype(np.int32)
    else:
        X, w = _problem(7, seed=2)
        g = np.array([3, 0, 3, 2, 0, 1, 3], np.int32)
    sc = _scorer(w)
    s = sc.scores(X)
    order = sc.rank_grouped(X, g)
    np.testing.assert_array_equal(
        order, np.lexsort((np.arange(len(s)), -s.astype(np.float64), g)))
    np.testing.assert_array_equal(order, JS.Scorer(w).rank_grouped(X, g))
    with pytest.raises(ValueError, match='align'):
        sc.rank_grouped(X, g[:-1])


def test_score_batch_equals_reference():
    _, w = _problem(1, seed=4)
    rng = np.random.default_rng(9)
    reqs = []
    for n, k in ((3, 2), (70, 5), (20, 1), (1, 1), (66, 9)):
        X = (rng.integers(-4, 5, size=(n, D)) * 0.5).astype(np.float32)
        reqs.append((X, n, k))
    version, s, v, i = _scorer(w).score_batch(reqs)
    jver, js, jv, ji = JS.Scorer(w).score_batch(reqs)
    assert version == jver == 0
    assert s.shape == js.shape and v.shape == jv.shape
    for r, (X, n, k) in enumerate(reqs):
        np.testing.assert_array_equal(s[r, :n], js[r, :n])
        np.testing.assert_array_equal(i[r, :k], ji[r, :k])
        np.testing.assert_array_equal(v[r, :k], jv[r, :k])
        np.testing.assert_array_equal(
            i[r, :k], np.argsort(-s[r, :n], kind='stable')[:k])
    with pytest.raises(ValueError, match='at least one'):
        _scorer(w).score_batch([])


def test_request_validation_errors():
    _, w = _problem(4)
    sc = _scorer(w)
    with pytest.raises(ValueError, match='empty candidate set'):
        sc.scores(np.zeros((0, D), np.float32))
    with pytest.raises(ValueError, match='2-D'):
        sc.scores(np.zeros(D, np.float32))
    with pytest.raises(ValueError, match='width'):
        sc.scores(np.zeros((3, D + 1), np.float32))
    for bad_k in (0, -1, 2.5, True):
        with pytest.raises(ValueError, match='positive integer'):
            sc.top_k(np.zeros((3, D), np.float32), bad_k)
    with pytest.raises(ValueError, match='min_bucket'):
        _scorer(w, min_bucket=0)


def test_no_new_program_after_warm():
    """After `warm` over the traffic's range no request adds a program,
    and every program keeps the one input signature of its bucket."""
    _, w = _problem(1)
    sc = _scorer(w)
    n_warm = sc.warm(200, ks=(1, 5, 16), max_batch=4, grouped=True)
    assert n_warm == sc.n_programs
    sizes = sc.program_cache_sizes()
    assert set(sizes.values()) == {1}
    rng = np.random.default_rng(5)
    for n in [1, 2, 3, 4, 5, 9, 15, 16, 17] + list(rng.integers(1, 201, 30)):
        X = rng.normal(size=(int(n), D)).astype(np.float32)
        sc.scores(X)
        for k in (1, 5, 16):        # k past n clamps to n: a smaller k bucket
            sc.top_k(X, k)
        sc.rank_grouped(X, rng.integers(0, 4, size=int(n)))
    for ns in ((3, 150, 77), (2,), (4, 1), (9, 12, 200)):
        sc.score_batch([(rng.normal(size=(m, D)).astype(np.float32), m,
                         min(16, m)) for m in ns])
    assert sc.n_programs == n_warm
    assert sc.program_cache_sizes() == sizes


# -- weight store --------------------------------------------------------------


def test_weight_store_versions_and_validation():
    _, w = _problem(1)
    store = WeightStore(w, device='cpu')
    assert store.version == 0 and store.n_features == D
    assert store.swap(w * 2) == 1
    assert store.swap(torch.as_tensor(w * 3)) == 2
    v, wd = store.get()
    assert v == 2 and wd.dtype == torch.float32
    np.testing.assert_array_equal(wd.numpy(), w * 3)
    with pytest.raises(ValueError, match='does not match'):
        store.swap(np.zeros(D + 1, np.float32))
    with pytest.raises(ValueError, match='non-finite'):
        store.swap(np.full(D, np.nan, np.float32))
    with pytest.raises(ValueError, match='1-D'):
        WeightStore(np.zeros((2, 2), np.float32), device='cpu')
    assert store.version == 2                   # rejected swaps change nothing


def test_weight_store_accepts_estimator_and_pathpoint():
    X, w = _problem(40, seed=9)
    y = np.round(X @ w)
    est = RankSVM(max_iter=50, device='cpu').fit(X, y)
    store = WeightStore(est, device='cpu')
    np.testing.assert_array_equal(store.get()[1].numpy(),
                                  est.w_.astype(np.float32))
    pts = est.path(X, y, [1e-2, 1e-3], mode='sequential')
    assert store.swap(pts[0]) == 1
    np.testing.assert_array_equal(store.get()[1].numpy(),
                                  pts[0].w.astype(np.float32))
    with pytest.raises(ValueError, match='None'):
        WeightStore(RankSVM(device='cpu'), device='cpu')


# -- micro-batcher -------------------------------------------------------------


class _GatedScorer(Scorer):
    """A scorer whose first `score_batch` calls wait at a gate: the test
    knows what the worker holds when it opens it."""

    def __init__(self, *a, holds=1, **kw):
        super().__init__(*a, **kw)
        self.entered = threading.Event()
        self.gate = threading.Event()
        self._holds = holds

    def score_batch(self, requests):
        if self._holds:
            self._holds -= 1
            self.entered.set()
            assert self.gate.wait(TIMEOUT)
        return super().score_batch(requests)


def test_microbatcher_parity_and_coalescing():
    """The worker is held in its first launch (one request) while eleven
    more queue; opening the gate flushes those eleven as one launch.
    Every response equals the reference scorer's, scores and top-k."""
    _, w = _problem(1)
    sc = _GatedScorer(w, device='cpu')
    rng = np.random.default_rng(13)
    reqs = []
    for i in range(12):
        n = int(rng.integers(1, 90))
        X = (rng.integers(-4, 5, size=(n, D)) * 0.5).astype(np.float32)
        reqs.append((X, None if i % 3 == 0 else int(rng.integers(1, n + 1))))
    ref = JS.Scorer(w)
    with MicroBatcher(sc, max_batch=11, max_delay_ms=0.0) as mb:
        futures = [mb.submit(*reqs[0])]
        assert sc.entered.wait(TIMEOUT)
        futures += [mb.submit(X, k) for X, k in reqs[1:]]
        sc.gate.set()
        responses = [f.result(TIMEOUT) for f in futures]
        assert mb.n_requests == 12 and mb.n_batches == 2
        assert mb.mean_batch == 6.0
    for (X, k), r in zip(reqs, responses):
        assert r.version == 0
        np.testing.assert_array_equal(r.scores, ref.scores(X))
        if k is None:
            assert r.values.size == 0 and r.indices.size == 0
        else:
            jv, ji = ref.top_k(X, k)
            np.testing.assert_array_equal(r.indices, ji)
            np.testing.assert_array_equal(r.values, jv)


def test_microbatcher_validation_in_caller_thread():
    X, w = _problem(5)
    with MicroBatcher(_scorer(w), max_delay_ms=1.0) as mb:
        with pytest.raises(ValueError, match='width'):
            mb.submit(np.zeros((3, D + 1), np.float32))
        with pytest.raises(ValueError, match='empty candidate set'):
            mb.submit(np.zeros((0, D), np.float32))
        np.testing.assert_array_equal(mb.scores(X, TIMEOUT), X @ w)
    for kw in (dict(max_batch=0), dict(max_delay_ms=-1.0),
               dict(max_batch=8, max_queue=4)):
        with pytest.raises(ValueError):
            MicroBatcher(_scorer(w), **kw)


def test_microbatcher_worker_error_propagates_and_recovers():
    X, w = _problem(4)
    sc = _scorer(w)
    armed = [True]
    orig = sc.score_batch

    def flaky(requests):
        if armed.pop() if armed else False:
            raise RuntimeError('injected device failure')
        return orig(requests)

    sc.score_batch = flaky
    with MicroBatcher(sc, max_delay_ms=1.0) as mb:
        with pytest.raises(RuntimeError, match='injected'):
            mb.submit(X).result(TIMEOUT)
        np.testing.assert_array_equal(mb.scores(X, TIMEOUT), X @ w)


def test_microbatcher_close_flushes_then_rejects():
    X, w = _problem(6)
    mb = MicroBatcher(_scorer(w), max_batch=64, max_delay_ms=500.0)
    futures = [mb.submit(X) for _ in range(5)]
    mb.close()                                  # flushes the queued five
    assert not mb._worker.is_alive()
    for f in futures:
        assert f.done()
        np.testing.assert_array_equal(f.result(TIMEOUT).scores, X @ w)
    with pytest.raises(RuntimeError, match='closed'):
        mb.submit(X)


def test_microbatcher_bounded_queue_under_flood():
    """Four producers against a queue of two: submitters block instead
    of growing the queue, and every request completes."""
    X, w = _problem(3)
    results, errors = [], []
    with MicroBatcher(_scorer(w), max_batch=2, max_delay_ms=0.0,
                      max_queue=2) as mb:
        def produce():
            try:
                for _ in range(10):
                    results.append(mb.submit(X).result(TIMEOUT))
            except Exception as e:          # pragma: no cover - fails test
                errors.append(e)

        threads = [threading.Thread(target=produce) for _ in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(TIMEOUT)
            assert not th.is_alive()
        assert not errors and len(results) == 40
    for r in results:
        np.testing.assert_array_equal(r.scores, X @ w)


class _HeldStore(WeightStore):
    """A weight store whose first snapshot is handed out only when the
    test opens the gate: a launch is then in flight with that snapshot."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.entered = threading.Event()
        self.gate = threading.Event()
        self._holds = 1

    def get(self):
        slot = super().get()
        if self._holds:
            self._holds -= 1
            self.entered.set()
            assert self.gate.wait(TIMEOUT)
        return slot


def test_hot_swap_lands_between_launches():
    """A swap made while a launch is in flight (its snapshot taken) does
    not reach it: the held launch answers with version 0 and w0's scores;
    the next launch answers with version 1 and w1's."""
    X, w0 = _problem(30, seed=21)
    w1 = (w0 * 4 - 1).astype(np.float32)
    store = _HeldStore(w0, device='cpu')
    with MicroBatcher(Scorer(store), max_batch=8, max_delay_ms=0.0) as mb:
        held = mb.submit(X, 3)
        assert store.entered.wait(TIMEOUT)
        assert store.swap(w1) == 1              # while the launch is held
        store.gate.set()
        r0 = held.result(TIMEOUT)
        r1 = mb.submit(X, 3).result(TIMEOUT)
    for r, v, w in ((r0, 0, w0), (r1, 1, w1)):
        assert r.version == v
        np.testing.assert_array_equal(r.scores, X @ w)
        np.testing.assert_array_equal(
            r.indices, np.argsort(-(X @ w), kind='stable')[:3])


def _fake_clock(monkeypatch):
    """batching's clock, advanced by the test alone."""
    now = [1000.0]
    monkeypatch.setattr(batching, 'time',
                        types.SimpleNamespace(monotonic=lambda: now[0]))
    return now


@pytest.mark.parametrize('adaptive,gaps,want', [
    (False, [0.08] * 4, 20.0),              # the fixed window never moves
    (True, [0.08] * 4, 0.0),                # sparse arrivals: no window
    (True, [0.0] * 30, 20.0),               # a dense burst keeps it all
    (True, [0.5] + [0.0] * 12, None),       # an idle spell, then a burst
])
def test_adaptive_window_on_a_fake_clock(monkeypatch, adaptive, gaps, want):
    """The adaptive window's EWMA of arrival gaps (samples clamped to 4x
    the window), driven by a clock the test moves: no sleep, and close()
    flushes whatever is queued whatever the window."""
    now = _fake_clock(monkeypatch)
    X, w = _problem(3)
    mb = MicroBatcher(_scorer(w), max_batch=64, max_delay_ms=20.0,
                      adaptive_delay=adaptive)
    assert mb.effective_delay_ms == 20.0        # no sample yet
    futures = [mb.submit(X)]
    for gap in gaps:
        now[0] += gap
        futures.append(mb.submit(X))
    eff = mb.effective_delay_ms
    mb.close()
    for f in futures:
        np.testing.assert_array_equal(f.result(TIMEOUT).scores, X @ w)
    if want is None:
        # the clamp: one 0.5 s gap counts as 0.08 s, and twelve dense
        # arrivals reopen the window past half of it
        assert eff > 0.5 * 20.0
    else:
        assert eff == pytest.approx(want, abs=0.2)


# -- service and estimator wrappers --------------------------------------------


def test_ranking_service_modes_and_stats():
    X, w = _problem(20, seed=4)
    with RankingService(w, max_delay_ms=1.0, device='cpu') as svc:
        np.testing.assert_array_equal(svc.scores(X), X @ w)
        vals, idx = svc.top_k(X, 4)
        np.testing.assert_array_equal(idx,
                                      np.argsort(-(X @ w), kind='stable')[:4])
        st = svc.stats()
        assert st['n_requests'] == 2 and st['version'] == 0
        assert svc.swap_weights(w * 2) == 1 and svc.version == 1
        np.testing.assert_array_equal(svc.scores(X), 2 * (X @ w))
        assert svc.submit(X, 2).result(TIMEOUT).version == 1
    direct = RankingService(w, micro_batch=False, device='cpu')
    np.testing.assert_array_equal(direct.scores(X), X @ w)
    with pytest.raises(RuntimeError, match='micro_batch=True'):
        direct.submit(X)
    g = np.zeros(20, np.int32)
    s = direct.scores(X)
    np.testing.assert_array_equal(
        direct.rank_grouped(X, g),
        np.lexsort((np.arange(20), -s.astype(np.float64), g)))
    assert 'n_requests' not in direct.stats()
    direct.close()                              # no batcher: a no-op


def test_warmup_covers_batched_traffic():
    """After `warmup` over the traffic's range, any flush size, candidate
    count and k inside it adds no program, however the queue coalesces."""
    _, w = _problem(1)
    rng = np.random.default_rng(31)
    with RankingService(w, max_batch=8, max_delay_ms=0.0,
                        device='cpu') as svc:
        n_warm = svc.warmup(200, ks=(5,), grouped=True)
        sizes = svc.scorer.program_cache_sizes()
        for _ in range(4):
            futs = [svc.submit(rng.normal(size=(int(rng.integers(1, 201)),
                                                D)).astype(np.float32), 5)
                    for _ in range(int(rng.integers(1, 9)))]
            for f in futs:
                f.result(TIMEOUT)
        svc.rank_grouped(rng.normal(size=(37, D)).astype(np.float32),
                         np.zeros(37, np.int32))
        assert svc.scorer.n_programs == n_warm
        assert svc.scorer.program_cache_sizes() == sizes


def test_ranksvm_scores_top_k_wrappers():
    from repro_torch.data.sparse import CSRMatrix
    X, w = _problem(60, seed=17)
    y = np.round(X @ w)
    est = RankSVM(max_iter=80, device='cpu').fit(X, y)
    s = est.scores(X)
    np.testing.assert_allclose(s, est.decision_function(X), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s, JS.Scorer(est.w_).scores(X), rtol=1e-6,
                               atol=1e-6)
    vals, idx = est.top_k(X, 5)
    np.testing.assert_array_equal(idx, np.argsort(-s, kind='stable')[:5])
    np.testing.assert_array_equal(est.top_k(torch.as_tensor(X), 5)[1], idx)
    assert est.scorer() is est.scorer()
    first = est.scorer()
    assert est.scorer(min_bucket=8) is not first
    est.fit(X, y)
    assert est.scorer() is not first
    Xs = CSRMatrix.from_dense(X)                # sparse: decision_function
    np.testing.assert_array_equal(est.scores(Xs), est.decision_function(Xs))
    un = RankSVM(device='cpu')
    for call in (lambda: un.scores(X), lambda: un.top_k(X, 2),
                 lambda: un.scorer()):
        with pytest.raises(RuntimeError, match='fit'):
            call()


def test_scorer_thread_safety_direct():
    """Four threads call one scorer at once: every answer is right."""
    _, w = _problem(1)
    sc = _scorer(w)
    errors = []

    def hammer(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(25):
                n = int(rng.integers(1, 70))
                X = (rng.integers(-4, 5, size=(n, D)) * 0.5).astype(
                    np.float32)
                np.testing.assert_array_equal(sc.scores(X), X @ w)
                _, idx = sc.top_k(X, 3)
                np.testing.assert_array_equal(
                    idx, np.argsort(-(X @ w), kind='stable')[:3])
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(s,)) for s in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(TIMEOUT)
        assert not th.is_alive()
    assert not errors
