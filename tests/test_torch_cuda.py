"""The port on the card: each CUDA kernel against its plain torch version
(the counting kernels bit for bit; the WKV forward kernel's states and
the backward kernel's ds0 bit for bit, their other outputs within the
tolerances below), a fit on the card against the same fit on the CPU,
the sparse and streamed oracles on the card (the tree's memory, the
device transpose-matvec, the streaming budget and its determinism), the
loss axis (the weighted tree's memory, TopPush's coefficients, the
r-level counts, the accumulator's budget), the reduced RWKV-6 prefill
and train step on the card against the CPU, the sharded oracle on a
one-rank NCCL group against the CPU, the reduced dense attention model's
prefill, decode and train step (its frontends too) and the attention's
float32 gradients against the CPU, the MoE block and MLA prefill and
decode against the CPU, and the reduced MLA and MoE models' train step
against the CPU, routing asserted alike first.

Every test here needs a CUDA device (Hopper, for the sm_90a kernels) and
is marked `cuda`; without one it skips. This module imports neither JAX
nor the JAX package, so it runs on a machine that has only torch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from repro_torch.core import counts as TC  # noqa: E402
from repro_torch.core.ranksvm import RankSVM  # noqa: E402
from repro_torch.data import cadata_like, ordinal_like  # noqa: E402
from repro_torch.kernels.pairwise_rank import ops as PR  # noqa: E402
from repro_torch.kernels.pairwise_rank.ref import (  # noqa: E402
    pairwise_counts_plain)
from repro_torch.kernels.rank_counts import ops as RC  # noqa: E402
from repro_torch.kernels.rank_counts.ref import (  # noqa: E402
    rank_counts_plain)
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.kernels.wkv import ops as W  # noqa: E402
from repro_torch.kernels.wkv.ref import (  # noqa: E402
    wkv_backward_plain, wkv_forward_plain)
from repro_torch.models import lm as LM  # noqa: E402
from torch_parity import cuda_device, torch_one_thread  # noqa: E402,F401

pytestmark = pytest.mark.cuda


def _case(kind, m, seed=0):
    rng = np.random.default_rng(seed + m)
    if kind == 'grid':          # every frontier on a run of p +- 1 ties
        p = (np.arange(m) % 5).astype(np.float32)
        y = rng.integers(0, 4, size=m).astype(np.float32)
    elif kind == 'halves':
        p = (rng.integers(-4, 5, size=m) * 0.5).astype(np.float32)
        y = rng.integers(0, 3, size=m).astype(np.float32)
    else:
        p = rng.normal(size=m).astype(np.float32) * 3
        y = rng.integers(0, 8, size=m).astype(np.float32)
    return p, y


@pytest.mark.parametrize('m', [1, 127, 1025, 4096, 8193, 20000])
@pytest.mark.parametrize('kind', ['grid', 'halves', 'normal'])
def test_pairwise_kernel_equals_plain(kind, m, cuda_device):
    """m = 8193 and 20000 take several candidate splits, the first of
    them ragged."""
    p, y = (torch.as_tensor(a, device=cuda_device) for a in _case(kind, m))
    before = PR.PAIRWISE.launches
    c, d = PR.pairwise_counts(p, y)
    cp, dp = pairwise_counts_plain(p, y)
    torch.cuda.synchronize()
    assert PR.PAIRWISE.launches == before + 1
    assert torch.equal(c, cp) and torch.equal(d, dp)


def _by_order(p, y):
    ranks = RC._compact_ranks(y)
    return (*torch.sort(p, stable=True), ranks, int(ranks.max()) + 1)


def _equal_to_plain(args, ti, tj):
    """The kernels' c, d and scratch (yr, planes, table) against the
    plain version's on the same inputs, every tensor bit-equal."""
    before = RC.RANK_COUNTS.launches
    c, d, prep = RC.counts_from_sort(*args, ti, tj)
    cp, dp, prepp = rank_counts_plain(*args, RC.pick_tj(args[3])
                                      if tj is None else tj)
    torch.cuda.synchronize()
    assert RC.RANK_COUNTS.launches == before + 1
    for a, b in zip((c, d, *prep), (cp, dp, *prepp)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize('ti,tj', [(256, 256), (64, 1024), (1024, 32)])
@pytest.mark.parametrize('m', [1, 300, 5000, 70000])
@pytest.mark.parametrize('kind', ['grid', 'halves', 'normal'])
def test_rank_counts_kernel_equals_plain(kind, m, ti, tj, cuda_device):
    p, y = (torch.as_tensor(a, device=cuda_device) for a in _case(kind, m))
    _equal_to_plain(_by_order(p, y), ti, tj)
    c, d = RC.rank_counts(p, y, ti=ti, tj=tj)
    cf, df = TC.counts_fused(p, y)
    assert torch.equal(c, cf) and torch.equal(d, df)


@pytest.mark.parametrize('distinct', [1, 2, 5, 256, 257])
def test_rank_counts_alphabets(distinct, cuda_device):
    """The tables follow the alphabet (tj from `pick_tj`); 257 distinct
    utilities pass the 256 levels and take the tree, with no launch."""
    rng = np.random.default_rng(distinct)
    m = 20011
    p = torch.as_tensor((rng.integers(-40, 41, size=m) * 0.25).astype(
        np.float32), device=cuda_device)
    y = torch.as_tensor(rng.permutation(np.arange(m) % distinct).astype(
        np.float32), device=cuda_device)
    if distinct <= RC.DEFAULT_LEVELS:
        _equal_to_plain(_by_order(p, y), RC.TI, None)
    before = RC.RANK_COUNTS.launches
    c, d = RC.rank_counts(p, y)
    assert RC.RANK_COUNTS.launches == before + (distinct
                                                <= RC.DEFAULT_LEVELS)
    cf, df = TC.counts_fused(p, y)
    assert torch.equal(c, cf) and torch.equal(d, df)


@pytest.mark.parametrize('n_groups', [3, 40])
def test_rank_counts_grouped_equals_tree(n_groups, cuda_device):
    """Grouped counting through the key offsets: 3 groups of 4 grades
    (one word a tile), 40 groups (160 ranks, tiles of four words)."""
    rng = np.random.default_rng(n_groups)
    m = 30000
    p, y, g = (torch.as_tensor(a, device=cuda_device) for a in (
        (rng.integers(-8, 9, size=m) * 0.5).astype(np.float32),
        rng.integers(0, 4, size=m).astype(np.float32),
        rng.integers(0, n_groups, size=m).astype(np.int32)))
    before = RC.RANK_COUNTS.launches
    c, d = RC.rank_counts_grouped(p, y, g)
    assert RC.RANK_COUNTS.launches == before + 1
    cf, df = TC.counts_grouped_fused(p, y, g)
    assert torch.equal(c, cf) and torch.equal(d, df)


def test_rank_counts_at_the_main_size(cuda_device):
    """m = 2^20 with five grades and scores on a 0.25 grid (many ties at
    p +- 1), against the tree."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(3)
    m = 1 << 20
    p = torch.randint(-400, 401, (m,), generator=g, device=cuda_device) * 0.25
    y = torch.randint(0, 5, (m,), generator=g, device=cuda_device).float()
    _equal_to_plain(_by_order(p, y), RC.TI, None)
    c, d = RC.rank_counts(p, y)
    cf, df = TC.counts_fused(p, y)
    assert torch.equal(c, cf) and torch.equal(d, df)


def test_rank_counter_makes_no_host_read_back(cuda_device):
    """The call p -> (c, d) after the counter is built neither
    synchronizes nor reads back (what a CUDA graph capture needs)."""
    rng = np.random.default_rng(5)
    p, y = (torch.as_tensor(a, device=cuda_device) for a in (
        rng.normal(size=50000).astype(np.float32),
        rng.integers(0, 5, size=50000).astype(np.float32)))
    count = RC.rank_counter(y)
    count(p)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        c, d = count(p)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    cf, df = TC.counts_fused(p, y)
    assert torch.equal(c, cf) and torch.equal(d, df)


def test_counting_kernels_are_deterministic(cuda_device):
    """Each counting kernel twice on the same input gives the same bits."""
    p, y = (torch.as_tensor(a, device=cuda_device)
            for a in _case('halves', 20000))
    first, second = PR.pairwise_counts(p, y), PR.pairwise_counts(p, y)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    args = _by_order(p, y)
    first, second = RC.counts_from_sort(*args), RC.counts_from_sort(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(
        (first[0], first[1], *first[2]), (second[0], second[1], *second[2])))


@pytest.mark.parametrize('engine', ['tree', 'pallas', 'auto'])
@pytest.mark.parametrize('data', ['cadata', 'ordinal'])
def test_fit_on_the_card_matches_the_cpu(data, engine, cuda_device):
    ds = (cadata_like(m=2048, m_test=256, seed=1) if data == 'cadata'
          else ordinal_like(m=2048, m_test=256, n=16, seed=2))
    kw = dict(lam=1e-2, eps=1e-4, engine=engine, solver='host')
    on_card = RankSVM(device=cuda_device, **kw).fit(ds.X, ds.y)
    on_cpu = RankSVM(device='cpu', **kw).fit(ds.X, ds.y)
    j_card = on_card.objective(ds.X, ds.y)
    j_cpu = on_cpu.objective(ds.X, ds.y)
    assert abs(j_card - j_cpu) <= 1e-4


# ------------------------------------------- sparse and streamed features


def _peak_above_start(fn):
    """fn()'s result and the peak bytes the card allocated during it above
    what was allocated when it started."""
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - start


def test_tree_counts_hold_one_level_at_a_time(cuda_device):
    """At m = 2^20 the tree's counting pass allocates at most half of
    what the streaming rule leaves after the O(m) vectors at the
    reuters_1m budget, (0.1953125 GiB - 24 m) / 2 = 92,274,688 bytes (all
    log2(m) levels at once took 197 MB); the counts stay the plain
    version's."""
    rng = np.random.default_rng(11)
    m = 1 << 20
    p = torch.as_tensor(rng.normal(size=m).astype(np.float32),
                        device=cuda_device)
    y = torch.as_tensor(rng.normal(size=m).astype(np.float32),
                        device=cuda_device)
    (c, d), peak = _peak_above_start(lambda: TC.counts_fused(p, y))
    assert peak <= (int(0.1953125 * 2**30) - 24 * m) // 2
    cc, dc = TC.counts_fused(p.cpu(), y.cpu())
    assert torch.equal(c.cpu(), cc) and torch.equal(d.cpu(), dc)


def _reuters(m, n=4096, seed=0):
    from repro_torch.data import reuters_like
    return reuters_like(m=m, m_test=16, n=n, nnz_per_row=50, seed=seed)


def test_csr_oracle_on_the_card_matches_the_cpu(cuda_device):
    """The device transpose-matvec (exact fixed-point sums) is
    bit-identical run to run and agrees with the host one (scipy's CSR
    loops); the ragged layout too."""
    from repro_torch.core.oracle import TreeOracle
    from repro_torch.data import CSRMatrix
    data = _reuters(20000)
    rng = np.random.default_rng(12)
    w = rng.normal(size=data.n) * 0.1
    card = TreeOracle(data.X, data.y, device=cuda_device)
    assert card.prefer_device_solver and card._feats.device_rmatvec
    (l1, a1), (l2, a2) = card.loss_and_subgrad(w), card.loss_and_subgrad(w)
    assert torch.equal(l1, l2) and torch.equal(a1, a2)
    host = TreeOracle(data.X, data.y, csr_rmatvec='host', device='cpu')
    lh, ah = host.loss_and_subgrad(w)
    assert abs(float(l1) - float(lh)) <= 1e-6 * abs(float(lh))
    np.testing.assert_allclose(a1.double().cpu().numpy(), ah,
                               rtol=1e-5, atol=1e-5 * np.abs(ah).max())
    dense = rng.normal(size=(3000, 64)) * (rng.random((3000, 64)) < 0.2)
    dense[0] = 0.0                                 # ragged rows
    yr = rng.normal(size=3000)
    wr = rng.normal(size=64)
    ragged = TreeOracle(CSRMatrix.from_dense(dense), yr, device=cuda_device)
    assert not ragged._feats._uniform
    (l1, a1), (l2, a2) = (ragged.loss_and_subgrad(wr),
                          ragged.loss_and_subgrad(wr))
    assert torch.equal(l1, l2) and torch.equal(a1, a2)
    lc, ac = TreeOracle(dense, yr, device='cpu').loss_and_subgrad(wr)
    np.testing.assert_allclose(float(l1), float(lc), rtol=1e-5)
    np.testing.assert_allclose(a1.cpu().numpy(), ac.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_fused_csr_oracle_holds_the_projection(cuda_device):
    """reuters_1m's shape (2^20 rows of 49152 columns, 50 nonzeros a
    row): with a budget just above what `projected_resident_gib` charges
    the features (8 bytes a nonzero), method='auto' keeps the fused
    oracle, and building it and two calls allocate within that budget on
    the card. "Just above" adds what the reference's model charges to
    both paths and so omits: the O(m) vectors, 24 m bytes as the
    streaming rule reserves them, and the counting pass, whose peak at
    these utilities is measured alone first."""
    from repro_torch.core.oracle import PairwiseOracle, make_oracle
    from repro_torch.data import projected_resident_gib, random_tfidf
    m = 1 << 20
    X = random_tfidf(m=m, n=49152, nnz_per_row=50, seed=16)
    rng = np.random.default_rng(16)
    y = rng.normal(size=m).astype(np.float32)
    yd = torch.as_tensor(y, device=cuda_device)
    p = torch.as_tensor(rng.normal(size=m).astype(np.float32),
                        device=cuda_device)
    _, count_peak = _peak_above_start(
        lambda: TC.make_counter(yd, None, engine='auto')(p))
    del yd, p
    proj = projected_resident_gib(X)
    assert proj * 2**30 == 8 * X.nnz
    budget = proj + (24 * m + count_peak) / 2**30
    w = rng.normal(size=X.shape[1]) * 0.1

    def build_and_call():
        oracle = make_oracle(X, y, method='auto', memory_budget=budget,
                             device=cuda_device)
        assert isinstance(oracle, PairwiseOracle)
        feats = oracle._feats
        assert sum(t.numel() * t.element_size()
                   for t in (feats.data, feats.slot)) == 8 * X.nnz
        return [oracle.loss_and_subgrad(w) for _ in range(2)]

    ((l1, a1), (l2, a2)), peak = _peak_above_start(build_and_call)
    assert torch.equal(l1, l2) and torch.equal(a1, a2)
    assert peak <= budget * 2**30, (peak, budget * 2**30, count_peak)


@pytest.mark.parametrize('layout', ['csr', 'dense'])
def test_stream_holds_its_budget_on_the_card(layout, cuda_device):
    """Half the features' fused residency as the budget: method='auto'
    streams, and an oracle call allocates no more than the budget on the
    card at prefetch 0 and 1: the host passes for CSR (counting on the
    card), the device step's slabs for dense."""
    from repro_torch.core.oracle import StreamingOracle, make_oracle
    from repro_torch.data import projected_resident_gib
    m = 1 << 17
    if layout == 'csr':
        data = _reuters(m, n=2048)
        X, y = data.X, data.y
    else:
        rng = np.random.default_rng(13)
        X = rng.normal(size=(m, 256)).astype(np.float32)
        y = X @ rng.normal(size=256) + rng.normal(size=m)
    budget = projected_resident_gib(X) / 2
    w = np.random.default_rng(14).normal(size=X.shape[1]) * 0.1
    for depth in (0, 1):
        o = make_oracle(X, y, method='auto', memory_budget=budget,
                        prefetch=depth, device=cuda_device)
        assert isinstance(o, StreamingOracle)
        assert o.block_resident_bytes() <= budget * 2**30
        if layout == 'csr':
            _, peak = _peak_above_start(lambda: o.loss_and_subgrad(w))
        else:
            step = o.step_fn()
            wt = torch.as_tensor(w, dtype=torch.float32, device=cuda_device)
            _, peak = _peak_above_start(lambda: step(wt))
        assert peak <= budget * 2**30, (depth, peak)


@pytest.mark.parametrize('layout', ['csr', 'dense'])
def test_stream_is_deterministic_at_both_depths(layout, cuda_device):
    """Both surfaces give the same bits twice at each depth, and the same
    bits at prefetch 0 and 1 for one block size."""
    from repro_torch.core.oracle import StreamingOracle
    rng = np.random.default_rng(15)
    if layout == 'csr':
        data = _reuters(30000, n=1024)
        X, y = data.X, data.y
    else:
        X = rng.normal(size=(30000, 32)).astype(np.float32)
        y = rng.normal(size=30000)
    w = rng.normal(size=X.shape[1]) * 0.1
    wt = torch.as_tensor(w, dtype=torch.float32, device=cuda_device)
    host, dev = [], []
    for depth in (0, 1):
        o = StreamingOracle(X, y, block_rows=4096, prefetch=depth,
                            device=cuda_device)
        step = o.step_fn()
        for _ in range(2):
            host.append(o.loss_and_subgrad(w))
            dev.append(step(wt))
    for (l0, a0) in host[1:]:
        assert torch.equal(l0, host[0][0]) and np.array_equal(a0, host[0][1])
    for (l0, a0) in dev[1:]:
        assert torch.equal(l0, dev[0][0]) and torch.equal(a0, dev[0][1])


# ------------------------------------------------------------ loss axis


def _graded_queries(m, seed):
    """Normal scores, five grades and query ids of 128 consecutive rows,
    made on the host."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=m).astype(np.float32) * 2
    y = rng.integers(0, 5, size=m).astype(np.float32)
    g = (np.arange(m) // 128).astype(np.int32)
    return p, y, g


def test_weighted_tree_holds_one_level_at_a_time(cuda_device):
    """At m = 2^20 the weighted tree's counting pass stays under the
    unweighted tree's bar (92,274,688 bytes) plus 16 m bytes (the weights
    in score order, and a level's prefix sums and sort indices), and
    under the charge the streaming rule makes for it; d equals the CPU's
    and the unweighted tree's bit for bit, c~ the CPU's within 1e-6 of
    sum(v)."""
    from repro_torch.core.oracle import LOSS_COUNT_BYTES
    rng = np.random.default_rng(21)
    m = 1 << 20
    p = torch.as_tensor(rng.normal(size=m).astype(np.float32),
                        device=cuda_device)
    y = torch.as_tensor(rng.normal(size=m).astype(np.float32),
                        device=cuda_device)
    v = torch.as_tensor((1.0 / np.log2(2.0 + np.arange(m)))[
        rng.permutation(m)].astype(np.float32), device=cuda_device)
    (cw, d), peak = _peak_above_start(
        lambda: TC.counts_weighted_fused(p, y, v))
    assert peak <= (int(0.1953125 * 2**30) - 24 * m) // 2 + 16 * m, peak
    assert peak <= LOSS_COUNT_BYTES['poshinge'] * m
    cc, dc = TC.counts_weighted_fused(p.cpu(), y.cpu(), v.cpu())
    assert torch.equal(d.cpu(), dc)
    assert torch.equal(d, TC.counts_fused(p, y)[1])
    assert float((cw.cpu() - cc).abs().max()) <= 1e-6 * float(v.sum())


def test_loss_counting_peaks_hold_their_charge(cuda_device):
    """Each loss's counting pass at m = 2^20 with 8192 queries of 128
    rows allocates at most `LOSS_COUNT_BYTES[loss] * m` above its
    inputs, the charge `StreamingOracle` makes for it."""
    from repro_torch.core.oracle import (LOSS_COUNT_BYTES, _loss_counter,
                                         _poshinge_weights_norm)
    m = 1 << 20
    p, y, g = _graded_queries(m, seed=22)
    v = _poshinge_weights_norm(y, g)[0]
    dev = cuda_device
    pd, yd, gd = (torch.as_tensor(a, device=dev) for a in (p, y, g))
    vd = torch.as_tensor(v, dtype=torch.float32, device=dev)
    for loss in ('poshinge', 'toppush'):
        count = _loss_counter(yd, gd, 'tree', 0, loss, vd)
        args = (pd, 1.0) if loss == 'toppush' else (pd,)
        _, peak = _peak_above_start(lambda: count(*args))
        assert peak <= LOSS_COUNT_BYTES[loss] * m, (loss, peak)


def test_toppush_coefficients_on_the_card_equal_the_cpu(cuda_device):
    """TopPush's loss pass on the card against the CPU on the same scores,
    ungrouped and with 8192 queries, heavy score ties included: the
    coefficients bit for bit, the loss within 1e-6; two calls on the
    card bit-identical."""
    from repro_torch.core.oracle import _toppush_loss_coeffs
    m = 1 << 20
    p, y, g = _graded_queries(m, seed=23)
    for scores in (p, np.round(p * 4) / 4):
        for groups in (None, g):
            args = [torch.as_tensor(a) for a in (scores, y)] + [
                None if groups is None else torch.as_tensor(groups)]
            lc, cc = _toppush_loss_coeffs(*args, 1e-6)
            card = [None if a is None else a.to(cuda_device) for a in args]
            l1, c1 = _toppush_loss_coeffs(*card, 1e-6)
            l2, c2 = _toppush_loss_coeffs(*card, 1e-6)
            assert torch.equal(c1.cpu(), cc)
            assert torch.equal(l1, l2) and torch.equal(c1, c2)
            assert abs(float(l1) - float(lc)) <= 1e-6 * abs(float(lc))


def test_poshinge_oracle_on_the_card_matches_the_cpu(cuda_device):
    """The grouped poshinge oracle through every engine on the card
    against the CPU tree: 'pallas' and 'auto' count with the weighted
    tree and launch no counting kernel."""
    from repro_torch.core.oracle import make_oracle
    from repro_torch.kernels.rank_counts import ops as RC
    rng = np.random.default_rng(24)
    m, nn = 20000, 16
    X = rng.normal(size=(m, nn)).astype(np.float32)
    y = rng.integers(0, 5, size=m).astype(np.float32)
    g = (np.arange(m) // 100).astype(np.int32)
    w = rng.normal(size=nn) * 0.3
    lc, ac = make_oracle(X, y, groups=g, loss='poshinge',
                         device='cpu').loss_and_subgrad(w)
    for engine in ('tree', 'pallas', 'auto', 'blocked'):
        before = (RC.RANK_COUNTS.launches, PR.PAIRWISE.launches)
        o = make_oracle(X, y, groups=g, loss='poshinge', engine=engine,
                        device=cuda_device)
        l1, a1 = o.loss_and_subgrad(w)
        assert (RC.RANK_COUNTS.launches, PR.PAIRWISE.launches) == before
        assert abs(float(l1) - float(lc)) <= 1e-5 * abs(float(lc)), engine
        np.testing.assert_allclose(a1.cpu().numpy(), ac.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(ac.abs().max()))


@pytest.mark.parametrize('r', [2, 32, 512, 2048])
def test_rlevel_counts_on_the_card_equal_the_tree(r, cuda_device):
    from repro_torch.core.joachims import counts_rlevel
    rng = np.random.default_rng(25 + r)
    m = 65536
    p = torch.as_tensor(rng.normal(size=m).astype(np.float32),
                        device=cuda_device)
    yl = torch.as_tensor(rng.integers(0, r, size=m).astype(np.int32),
                         device=cuda_device)
    c, d = counts_rlevel(p, yl, r)
    cf, df = TC.counts_fused(p, yl.float())
    assert torch.equal(c, cf) and torch.equal(d, df)


def test_fused_csr_replicas_hold_the_budget(cuda_device):
    """At m = 4096, n = 2^20 and 50 nonzeros a row, method='auto' under
    a 0.25 GiB budget keeps the fused oracle (its projection is 0.0015
    GiB), sizes its transpose-matvec's replicas to the budget, and
    building it and a call allocate within the budget on the card (64
    replicas alone would take 512 MiB)."""
    from repro_torch.core.oracle import (RMATVEC_REPLICAS, PairwiseOracle,
                                         make_oracle)
    from repro_torch.data import random_tfidf
    m, nn = 4096, 2**20
    X = random_tfidf(m=m, n=nn, nnz_per_row=50, seed=26)
    y = np.random.default_rng(26).normal(size=m).astype(np.float32)
    w = np.random.default_rng(27).normal(size=nn) * 0.01
    budget = 0.25

    def build_and_call():
        oracle = make_oracle(X, y, method='auto', memory_budget=budget,
                             device=cuda_device)
        assert isinstance(oracle, PairwiseOracle)
        assert 1 <= oracle._feats._replicas < RMATVEC_REPLICAS
        return oracle.loss_and_subgrad(w)

    (loss, a), peak = _peak_above_start(build_and_call)
    assert peak <= budget * 2**30, peak
    assert torch.isfinite(loss) and bool(torch.isfinite(
        torch.as_tensor(a)).all())


@pytest.mark.parametrize('loss', ['poshinge', 'toppush'])
def test_streamed_loss_holds_its_budget_on_the_card(loss, cuda_device):
    """A streamed 'poshinge' or 'toppush' call stays inside the budget as
    the hinge's does, and equals the resident oracle's loss."""
    from repro_torch.core.oracle import StreamingOracle, make_oracle
    from repro_torch.data import projected_resident_gib
    data = _reuters(1 << 17, n=2048)
    X, y = data.X, data.y
    budget = projected_resident_gib(X) / 2
    w = np.random.default_rng(28).normal(size=X.shape[1]) * 0.1
    o = make_oracle(X, y, method='auto', memory_budget=budget, loss=loss,
                    prefetch=1, device=cuda_device)
    assert isinstance(o, StreamingOracle)
    (ls, _), peak = _peak_above_start(lambda: o.loss_and_subgrad(w))
    assert peak <= budget * 2**30, peak
    lr, _ = make_oracle(X, y, loss=loss, device=cuda_device
                        ).loss_and_subgrad(w)
    assert abs(float(ls) - float(lr)) <= 1e-5 * abs(float(lr))


def _wkv_case(nn, tt, kk, dtype, dev, seed=0):
    rng = np.random.default_rng(seed + 97 * kk + tt)
    r, k, v = (torch.as_tensor(rng.normal(size=(nn, tt, kk)).astype(
        np.float32), device=dev).to(dtype) for _ in range(3))
    w = torch.as_tensor(rng.uniform(0.5, 0.999, size=(nn, tt, kk)).astype(
        np.float32), device=dev)
    u = torch.as_tensor(rng.normal(size=(nn, kk)).astype(np.float32),
                        device=dev)
    s0 = torch.as_tensor((0.1 * rng.normal(size=(nn, kk, kk))).astype(
        np.float32), device=dev)
    return r, k, v, w, u, s0


@pytest.mark.parametrize('tt', [128, 100])
@pytest.mark.parametrize('kk', [8, 16, 32, 64])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_wkv_kernel_matches_plain(dtype, kk, tt, cuda_device):
    """The kernel rounds each product and sum of the state update as the
    plain version does, so states and boundaries are bit-equal; o differs
    in the order of its K-term sum: 1e-4 of its scale, plus one ulp of
    the output dtype where o is rounded to bf16. T = 100 gives chunk 4."""
    args = _wkv_case(6, tt, kk, dtype, cuda_device)
    chunk = W._pick_chunk(tt)
    before = W.WKV_FWD.launches
    o, sT, bnd = W.wkv_forward(*args, chunk=chunk)
    op, sTp, bndp = wkv_forward_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert W.WKV_FWD.launches == before + 1
    assert o.dtype == dtype and bnd.shape == (6, tt // chunk, kk, kk)
    assert torch.equal(sT, sTp) and torch.equal(bnd, bndp)
    of, opf = o.float(), op.float()
    tol = 1e-4 * float(opf.abs().max())
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** (torch.floor(torch.log2(
            opf.abs().clamp_min(1e-30))) - 7)
    assert bool(((of - opf).abs() <= tol).all())


def _within(got, want, rel=1e-4):
    """got within `rel` of want's scale, plus one ulp of each value where
    got is bf16 (a float32 sum in another order can flip one rounding)."""
    g, wf = got.float(), want.float()
    tol = rel * float(wf.abs().max())
    if got.dtype == torch.bfloat16:
        tol = tol + 2.0 ** (torch.floor(torch.log2(
            wf.abs().clamp_min(1e-30))) - 7)
    return bool(((g - wf).abs() <= tol).all())


@pytest.mark.parametrize('tt', [128, 100])
@pytest.mark.parametrize('kk', [8, 16, 32, 64])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_wkv_backward_kernel_matches_plain(dtype, kk, tt, cuda_device):
    """The backward kernel rounds each product and sum of the state and dS
    updates as the plain version does, so ds0 is bit-equal; dr, dk, dv,
    dw and du differ in the order of their K-term sums: 1e-4 of each
    output's scale, plus one ulp where the output is bf16. T = 100 gives
    chunk 4 (one sub-chunk per chunk); T = 128 chunk 64."""
    r, k, v, w, u, s0 = _wkv_case(6, tt, kk, dtype, cuda_device, seed=1)
    chunk = W._pick_chunk(tt)
    _, _, bnd = W.wkv_forward(r, k, v, w, u, s0, chunk=chunk)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(kk + tt)
    do = torch.randn(r.shape, generator=g, device=cuda_device).to(dtype)
    dsT = torch.randn(s0.shape, generator=g, device=cuda_device)
    before = W.WKV_BWD.launches
    got = W.wkv_backward(r, k, v, w, u, bnd, do, dsT, chunk=chunk)
    want = wkv_backward_plain(r, k, v, w, u, bnd, do, dsT, chunk=chunk)
    torch.cuda.synchronize()
    assert W.WKV_BWD.launches == before + 1
    for name, a, b in zip(('dr', 'dk', 'dv', 'dw', 'du', 'ds0'), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _within(a, b), name
    assert torch.equal(got[5], want[5])


def _wkv_fwd_matches(got, want):
    """The forward bars: states and boundaries bit-equal, o within 1e-4 of
    its scale plus one ulp where o is bf16."""
    (o, sT, bnd), (op, sTp, bndp) = got, want
    assert o.dtype == op.dtype and torch.equal(sT, sTp)
    assert (bnd is None) == (bndp is None)
    assert bnd is None or torch.equal(bnd, bndp)
    assert _within(o, op)


def _wkv_bwd_matches(got, want):
    for name, a, b in zip(('dr', 'dk', 'dv', 'dw', 'du', 'ds0'), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _within(a, b), name
    assert torch.equal(got[5], want[5])


# N = 1, and N not a multiple of the block split or cluster size, with
# N = 300 at K = 64 for a grid wider than one wave of blocks.
GEOMETRY_CASES = [(1, 8), (7, 8), (1, 16), (7, 16), (1, 32), (5, 32),
                  (1, 64), (7, 64), (300, 64)]


@pytest.mark.parametrize('nn,kk', GEOMETRY_CASES)
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_wkv_kernels_match_plain_at_every_geometry(dtype, nn, kk,
                                                   cuda_device):
    """Both kernels against their plain versions at odd sequence counts,
    T = 100 (chunk 4, shorter than a sub-chunk) and T = 128 (chunk 64),
    with the bars of the two tests above."""
    for tt in (100, 128):
        args = _wkv_case(nn, tt, kk, dtype, cuda_device, seed=3)
        chunk = W._pick_chunk(tt)
        got = W.wkv_forward(*args, chunk=chunk)
        _wkv_fwd_matches(got, wkv_forward_plain(*args, chunk=chunk))
        r, k, v, w, u, s0 = args
        g = torch.Generator(device=cuda_device)
        g.manual_seed(nn + kk + tt)
        do = torch.randn(r.shape, generator=g, device=cuda_device).to(dtype)
        dsT = torch.randn(s0.shape, generator=g, device=cuda_device)
        bwd_args = (r, k, v, w, u, got[2], do, dsT)
        _wkv_bwd_matches(W.wkv_backward(*bwd_args, chunk=chunk),
                         wkv_backward_plain(*bwd_args, chunk=chunk))
    torch.cuda.synchronize()


@pytest.mark.parametrize('nn', [7, 160, 320])
def test_wkv_kernels_are_deterministic(nn, cuda_device):
    """No atomics: two launches on the same inputs give the same bits in
    every output of both kernels (N = 160 and 320 are the training and
    prefill sequence counts, each on its own block split)."""
    args = _wkv_case(nn, 256, 64, torch.bfloat16, cuda_device, seed=4)
    first = W.wkv_forward(*args, chunk=64)
    second = W.wkv_forward(*args, chunk=64)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    r, k, v, w, u, s0 = args
    g = torch.Generator(device=cuda_device)
    g.manual_seed(nn)
    do = torch.randn(r.shape, generator=g, device=cuda_device).to(r.dtype)
    dsT = torch.randn(s0.shape, generator=g, device=cuda_device)
    bwd_args = (r, k, v, w, u, first[2], do, dsT)
    first = W.wkv_backward(*bwd_args, chunk=64)
    second = W.wkv_backward(*bwd_args, chunk=64)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_wkv_geometry_as_the_kernels_report_it(cuda_device):
    """The backward's stage and checkpoint interval are the wrapper's,
    which sizes the scratch, and its cluster splits the rows evenly; the
    forward gives the prefill and training shapes (N = 320, 160) at least
    two blocks on every SM."""
    bwd = W.bwd_geometry(64)
    assert bwd['kSub'] == W.WKV_BWD_SUB and bwd['kSeg'] == W.WKV_BWD_SEG
    assert 64 % (bwd['C'] * 4) == 0 and bwd['C'] * bwd['R'] > 1
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for nn in (160, 320):
        assert W.fwd_geometry(64)['C'] * nn >= 2 * sms


def test_wkv_kernels_past_2_31_elements(cuda_device):
    """N * T * K = 8200 * 4096 * 64 = 2.15e9 > 2^31 (about 58 GB in all):
    both kernels run, and sequences 8190-8199 (from 8192 on wholly past
    element 2^31, 8191 ending at it) match the plain versions run on
    those ten sequences alone."""
    nn, tt, kk, dt = 8200, 4096, 64, torch.bfloat16
    assert nn * tt * kk > 2 ** 31 and 8192 * tt * kk == 2 ** 31
    dev = cuda_device
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    r, k, v = (torch.randn(nn, tt, kk, generator=g, device=dev, dtype=dt)
               for _ in range(3))
    w = torch.rand(nn, tt, kk, generator=g, device=dev).mul_(0.499).add_(0.5)
    u = torch.randn(nn, kk, generator=g, device=dev)
    s0 = 0.1 * torch.randn(nn, kk, kk, generator=g, device=dev)
    tail = slice(8190, 8200)
    o, sT, bnd = W.wkv_forward(r, k, v, w, u, s0, chunk=64)
    part = [a[tail] for a in (r, k, v, w, u, s0)]
    _wkv_fwd_matches((o[tail], sT[tail], bnd[tail]),
                     wkv_forward_plain(*part, chunk=64))
    del o, sT
    do = torch.randn(nn, tt, kk, generator=g, device=dev, dtype=dt)
    dsT = torch.randn(nn, kk, kk, generator=g, device=dev)
    got = W.wkv_backward(r, k, v, w, u, bnd, do, dsT, chunk=64)
    want = wkv_backward_plain(*part[:5], bnd[tail], do[tail], dsT[tail],
                              chunk=64)
    torch.cuda.synchronize()
    _wkv_bwd_matches([a[tail] for a in got], want)


def test_wkv_apply_backward_on_the_card_matches_the_cpu(cuda_device):
    """Gradients of sum(o^2) through the autograd function: one forward
    launch with boundaries and one backward launch, and the same
    gradients as the plain versions give on the CPU, within the bars
    above."""
    args = _wkv_case(4, 64, 64, torch.float32, cuda_device, seed=2)
    fwd, bwd = W.WKV_FWD.launches, W.WKV_BWD.launches
    leaves = [a.clone().requires_grad_(True) for a in args]
    o, _ = W.wkv_apply(*leaves)
    got = torch.autograd.grad((o * o).sum(), leaves)
    torch.cuda.synchronize()
    assert (W.WKV_FWD.launches, W.WKV_BWD.launches) == (fwd + 1, bwd + 1)
    leaves = [a.cpu().clone().requires_grad_(True) for a in args]
    o, _ = W.wkv_apply(*leaves)
    want = torch.autograd.grad((o * o).sum(), leaves)
    for a, b in zip(got, want):
        assert _within(a.cpu(), b)


def test_wkv_apply_on_the_card_writes_no_boundaries(cuda_device):
    args = _wkv_case(4, 64, 64, torch.bfloat16, cuda_device)
    before = W.WKV_FWD.launches
    o, sT = W.wkv_apply(*args)
    op, sTp, _ = wkv_forward_plain(*args, chunk=64, boundaries=False)
    torch.cuda.synchronize()
    assert W.WKV_FWD.launches == before + 1
    assert torch.equal(sT, sTp)


@pytest.mark.parametrize('impl', ['kernel', 'scan'])
def test_rwkv_prefill_on_the_card_matches_the_cpu(impl, cuda_device):
    """Reduced RWKV-6 with the same weights on both devices: the kernel
    route launches the WKV kernel once per layer, and the logits and
    states agree to 5% of their scale (bf16 activations, rounded in
    another order by the card's matmuls)."""
    import dataclasses
    cfg = dataclasses.replace(reduced('rwkv6-3b'), wkv_impl=impl)
    cpu = LM.init_model(cfg, seed=0, device='cpu')
    card = LM.from_state_dict(cfg, {k: v.to(cuda_device)
                                    for k, v in cpu.state_dict().items()})
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, 64)), dtype=torch.int32)
    before = W.WKV_FWD.launches
    cache, lg = LM.forward_prefill(card, cfg, {'tokens': toks.to(
        cuda_device)})
    torch.cuda.synchronize()
    want = cfg.n_layers if impl == 'kernel' else 0
    assert W.WKV_FWD.launches == before + want
    cache_c, lg_c = LM.forward_prefill(cpu, cfg, {'tokens': toks})
    for a, b in ((lg, lg_c), (cache['s'], cache_c['s'])):
        assert float((a.cpu() - b).abs().max()) <= 0.05 * float(
            b.abs().max())


@pytest.mark.parametrize('arch', ['rwkv6-3b', 'qwen2.5-3b', 'internvl2-26b',
                                  'musicgen-medium'])
@pytest.mark.parametrize('objective', ['lm', 'rank_hinge'])
def test_train_step_on_the_card_matches_the_cpu(objective, arch,
                                                cuda_device):
    """One train step of a reduced config (remat='layer') from the same
    state on both devices: RWKV-6 on the kernel route, each layer
    launching the forward kernel twice (forward and recompute) and the
    backward kernel once; the dense configs with their QKV biases drawn
    and their frontends' inputs. Loss within 2e-3 and gnorm within 2e-2
    relative (bf16 activations, rounded in another order by the card's
    matmuls)."""
    import dataclasses
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import RewardPipeline, TokenPipeline
    from repro_torch.data import TokenPipelineConfig, frontend_inputs
    from repro_torch.train.trainer import make_train_step, state_for
    cfg = reduced(arch)
    if arch == 'rwkv6-3b':
        cfg = dataclasses.replace(cfg, wkv_impl='kernel')
    tcfg = TrainConfig(objective=objective, warmup_steps=0)
    if objective == 'lm':
        raw = TokenPipeline(TokenPipelineConfig(cfg.vocab, 64, 16)).batch(0)
    else:
        raw = RewardPipeline(cfg.vocab, 64, 16).batch(0)
        raw.pop('groups', None)
    raw.update(frontend_inputs(cfg, 16, 0)(0, raw.pop('tokens')))
    metrics = {}
    for dev in ('cpu', cuda_device):
        model = LM.init_model(cfg, seed=0, device='cpu')
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for lay in model.layers:
                for name in ('bq', 'bk', 'bv'):
                    if hasattr(getattr(lay, 'attn', None), name):
                        b = getattr(lay.attn, name)
                        b.copy_(0.5 * torch.randn(b.shape, generator=g))
        model = LM.from_state_dict(cfg, {k: v.to(dev) for k, v in
                                         model.state_dict().items()})
        state = state_for(model)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
        fwd, bwd = W.WKV_FWD.launches, W.WKV_BWD.launches
        _, m = make_train_step(cfg, tcfg)(state, batch)
        metrics[str(dev)] = {k: float(v) for k, v in m.items()}
        if dev != 'cpu' and arch == 'rwkv6-3b':
            torch.cuda.synchronize()
            assert W.WKV_FWD.launches - fwd == 2 * cfg.n_layers
            assert W.WKV_BWD.launches - bwd == cfg.n_layers
    cpu, card = metrics['cpu'], metrics[str(cuda_device)]
    assert abs(card['loss'] - cpu['loss']) <= 2e-3 * abs(cpu['loss'])
    assert abs(card['gnorm'] - cpu['gnorm']) <= 2e-2 * cpu['gnorm']


# -- the regularization path and serving (slice 8) ----------------------------


def _path_problem(dev, m=20000, n=16, seed=9):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(m, n)).astype(np.float32)
    y = np.clip(np.round(X @ rng.normal(size=n) / 3 + 1.5), 0, 4)
    return (torch.as_tensor(X, device=dev),
            torch.as_tensor(y.astype(np.float32), device=dev))


@pytest.mark.parametrize('engine,loss', [
    ('pallas', 'hinge'), ('auto', 'hinge'), ('tree', 'hinge'),
    ('pallas', 'poshinge'), ('tree', 'toppush')])
@pytest.mark.parametrize('m', [3000, 20000])
def test_batched_counter_on_the_card_equals_single_calls(engine, loss, m,
                                                         cuda_device):
    """Scores (L, m) through the batched counter on the card: every row
    bit-equal to the single call (m = 3000 takes the pairwise kernel
    under 'auto', m = 20000 the rank-counts kernel)."""
    from repro_torch.core import oracle as TO
    rng = np.random.default_rng(m)
    y = rng.integers(0, 5, size=m).astype(np.float32)
    P = (rng.integers(-40, 41, size=(3, m)) * 0.25).astype(np.float32)
    P[2] = P[0]
    norm, pw = TO._loss_norm_weights(y, None, loss)
    v = None if pw is None else torch.as_tensor(pw, dtype=torch.float32,
                                                device=cuda_device)
    count = TO._loss_counter(torch.as_tensor(y, device=cuda_device), None,
                             engine, 2048, loss, v)
    args = ((torch.tensor(1.0 / norm, device=cuda_device),)
            if loss == 'toppush' else ())
    Pd = torch.as_tensor(P, device=cuda_device)
    batched = count(Pd, *args)
    for i in range(3):
        single = count(Pd[i], *args)
        assert all(torch.equal(b[i], s) for b, s in zip(batched, single))
    if loss == 'hinge':
        cf, df = TC.counts_fused(Pd[1], torch.as_tensor(y, device=cuda_device))
        assert torch.equal(batched[0][1], cf) and torch.equal(batched[1][1],
                                                              df)


def test_batched_kernel_step_makes_no_host_read_back(cuda_device):
    """One batched bundle step of the path sweep through the rank-counts
    kernel (three lambdas) neither synchronizes nor reads back."""
    from repro_torch.core import bmrm as TB
    from repro_torch.core.oracle import make_oracle
    from repro_torch.kernels.platform import full_f32
    X, y = _path_problem(cuda_device)
    orc = make_oracle(X, y, engine='pallas', device=cuda_device)
    state = TB.init_path_state(orc.n, 16, 3, device=cuda_device)
    lams = torch.tensor([1e-1, 1e-2, 1e-3], device=cuda_device)
    eps = torch.tensor(1e-3, device=cuda_device)
    step = orc.step_fn()
    RC.RANK_COUNTS.launches = 0
    with full_f32():
        state, _ = TB._bundle_step(state, step, lams, eps, 32)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode('error')
        try:
            state, r = TB._bundle_step(state, step, lams, eps, 32)
        finally:
            torch.cuda.set_sync_debug_mode('default')
    assert RC.RANK_COUNTS.launches == 6
    assert r.shape == (3,) and bool(torch.isfinite(r).all())
    assert state.n_active.tolist() == [2, 2, 2]


def test_path_vmap_matches_sequential_on_the_card(cuda_device):
    """The batched sweep on the card through the rank-counts kernel: every
    lambda converged, J within eps of the sequential sweep's."""
    X, y = _path_problem(cuda_device)
    lams = [1e-1, 1e-2, 1e-3]
    svm = RankSVM(eps=1e-3, engine='pallas', max_iter=300,
                  device=cuda_device)
    RC.RANK_COUNTS.launches = 0
    pv = svm.path(X, y, lams, mode='vmap')
    assert RC.RANK_COUNTS.launches >= 3 * max(p.report.iterations
                                              for p in pv)
    ps = svm.path(X, y, lams, mode='sequential')
    ph = svm.path(X, y, lams, mode='hybrid')
    for a, b, c in zip(pv, ps, ph):
        assert a.report.converged and b.report.converged
        assert c.report.converged
        assert [a.report.solver, b.report.solver] == ['vmap', 'device']
        ja, jb, jc = (RankSVM(lam=p.lam, device=cuda_device)
                      for p in (a, b, c))
        for est, p in ((ja, a), (jb, b), (jc, c)):
            est.w_ = p.w
        jb_ = jb.objective(X, y)
        assert abs(ja.objective(X, y) - jb_) <= 1e-3
        assert abs(jc.objective(X, y) - jb_) <= 1e-3


def test_top_k_tie_rule_on_the_card(cuda_device):
    """Ties go lowest index first on the card: repeated rows, all-equal
    scores, and padded buckets, against the stable argsort of the card's
    own scores, bit for bit; the batched launch agrees."""
    from repro_torch.serve import Scorer
    rng = np.random.default_rng(3)
    w = (rng.integers(-8, 9, size=8) * 0.25).astype(np.float32)
    sc = Scorer(w, device=cuda_device)
    for X in (np.repeat((rng.integers(-4, 5, size=(40, 8)) * 0.5).astype(
                  np.float32), 25, axis=0),                  # 1000 rows
              np.ones((300, 8), np.float32),
              (rng.integers(-1, 2, size=(4000, 8))).astype(np.float32)):
        s = sc.scores(X)
        for k in (1, 10, 100, len(X)):
            v, i = sc.top_k(X, k)
            ref = np.argsort(-s, kind='stable')[:k]
            np.testing.assert_array_equal(i, ref)
            np.testing.assert_array_equal(v, s[ref])
        _, bs, bv, bi = sc.score_batch([(X, len(X), 10), (X[:7], 7, 3)])
        np.testing.assert_array_equal(bi[0, :10],
                                      np.argsort(-bs[0, :len(X)],
                                                 kind='stable')[:10])
        np.testing.assert_array_equal(bs[0, :len(X)], s)


# ------------------------------------------------ incremental retraining


def _ordinal_queries(m, n_feat, seed, q_rows=16, q0=0):
    """Five grades in queries of q_rows consecutive rows, ids from q0."""
    ds = ordinal_like(m=m, m_test=16, n=n_feat, seed=seed)
    return ds.X, ds.y, q0 + np.arange(m) // q_rows


def test_refit_on_the_card_matches_the_cpu(cuda_device):
    """fit then a ledger refit with engine='pallas' on the card (grouped
    queries, so the counts go through the rank-counts kernel) reaches
    the CPU's objective within eps."""
    X, y, g = _ordinal_queries(2048, 16, 3)
    Xd, yd, gd = _ordinal_queries(256, 16, 4, q0=1000)
    out = {}
    for dev in (cuda_device, 'cpu'):
        svm = RankSVM(eps=1e-3, engine='pallas', device=dev).fit(X, y, g)
        RC.RANK_COUNTS.launches = 0
        rep = svm.refit(Xd, yd, gd, mode='ledger')
        assert rep.mode == 'ledger' and rep.fit.converged
        if dev != 'cpu':
            assert RC.RANK_COUNTS.launches >= rep.n_planes + 1
        out[str(dev)] = rep.fit.objective
    assert abs(out[str(cuda_device)] - out['cpu']) <= 1e-3


@pytest.mark.parametrize('queries,rows,layout', [
    (2048, 128, 'runs'), (4096, 64, 'shuffled'), (3000, 37, 'runs')])
def test_grouped_rank_counter_on_the_card_equals_the_tree(
        queries, rows, layout, cuda_device):
    """The grouped 'pallas' counter on the card (offset scores through
    the rank-counts kernel, cross-query pairs subtracted,
    `core.counts._grouped_rank_counter`) against the grouped tree on the
    same scores, at thousands of queries: wide scores and scores with
    ties on the margin, a batch of both too; (c, d) bit-equal, one
    kernel launch a row."""
    m = queries * rows
    rng = np.random.default_rng(queries)
    y = rng.integers(0, 5, size=m).astype(np.float32)
    g = np.arange(m) // rows
    if layout == 'shuffled':
        g = rng.permutation(g)
    p = (rng.normal(size=m) * 30).astype(np.float32)
    q = (rng.integers(-8, 9, size=m) * 0.5).astype(np.float32)
    yd, gd = (torch.as_tensor(a, device=cuda_device) for a in (y, g))
    kernel = TC.make_counter(yd, gd, engine='pallas')
    tree = TC.make_counter(yd, gd, engine='tree')
    for s in (p, q, np.stack([p, q])):
        sd = torch.as_tensor(s, device=cuda_device)
        before = RC.RANK_COUNTS.launches
        c, d = kernel(sd)
        assert RC.RANK_COUNTS.launches - before == (
            1 if sd.dim() == 1 else sd.shape[0])
        ct, dt = tree(sd)
        assert torch.equal(c, ct) and torch.equal(d, dt)


def test_bundle_state_checkpoint_restores_on_the_card(cuda_device,
                                                     tmp_path):
    from repro_torch.checkpoint import restore, save
    from repro_torch.core import bmrm as TB
    st = TB.init_bundle_state(136, 64, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    st = st._replace(A=torch.randn(64, 136, generator=g,
                                   device=cuda_device),
                     n_active=torch.tensor(7, dtype=torch.int32,
                                           device=cuda_device))
    save(str(tmp_path), 1, st)
    out, _ = restore(str(tmp_path), like=TB.init_bundle_state(
        136, 64, device='meta'), device=cuda_device)
    for f in TB.BundleState._fields:
        a, b = getattr(st, f), getattr(out, f)
        assert b.is_cuda and a.dtype == b.dtype and torch.equal(a, b), f


def test_resumed_chunk_loop_is_bit_identical_on_the_card(cuda_device,
                                                         tmp_path):
    from repro_torch.core import bmrm as TB
    from repro_torch.core import oracle as TO
    from repro_torch.core.incremental import refit_chunk_step
    from repro_torch.runtime import LoopConfig, SimulatedPreemption, run
    X, y, g = _ordinal_queries(4096, 16, 5)
    orc = TO.make_oracle(X, y, g, engine='pallas', device=cuda_device)
    step = refit_chunk_step(orc, lam=1e-3, eps=1e-4, sync_every=4)

    def init_fn(device):
        return TB.init_bundle_state(16, 64, device=device)

    def loop(name, **kw):
        lc = LoopConfig(total_steps=8, ckpt_dir=str(tmp_path / name),
                        ckpt_every=2, async_ckpt=False)
        return run(step, init_fn, lambda s: None, lc, device=cuda_device,
                   **kw)

    state_a, _ = loop('a')
    with pytest.raises(SimulatedPreemption):
        loop('b', fail_at=5)
    state_b, rep_b = loop('b')
    assert rep_b.resumed_from == 4
    for f in TB.BundleState._fields:
        assert torch.equal(getattr(state_a, f), getattr(state_b, f)), f


# ------------------------------------------------------- sharded oracle


def _sharded_data(layout, m=20000):
    """Dense MSLR-width rows with five grades, or tf-idf CSR rows with
    real-valued utilities, from a seed."""
    from repro_torch.data import random_tfidf
    rng = np.random.default_rng(m)
    if layout == 'csr':
        X = random_tfidf(m, 4096, 20, seed=1)
        y = rng.normal(size=m).astype(np.float32)
        w = rng.normal(size=4096).astype(np.float32)
    else:
        X = rng.normal(size=(m, 136)).astype(np.float32)
        y = rng.integers(0, 5, size=m).astype(np.float32)
        w = rng.normal(size=136).astype(np.float32) * 0.1
    return X, y, w


@pytest.fixture
def nccl_mesh(cuda_device, tmp_path):
    """A one-rank NCCL process group on the card and its 1 x 1 mesh."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group('nccl', init_method=f'file://{tmp_path}/store',
                            rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ('data', 'model'), device=cuda_device)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize('layout', ['dense', 'csr'])
def test_sharded_nccl_one_rank_equals_the_cpu(layout, nccl_mesh):
    """The sharded oracle on a one-rank NCCL group on the card against the
    same oracle on the CPU: counts bit-equal, loss and a within 1e-6 (the
    float64 sums run in another order on the card)."""
    from repro_torch.core.oracle import make_oracle
    from repro_torch.launch.mesh import Mesh
    X, y, w = _sharded_data(layout)
    cpu_mesh = Mesh({'data': 1, 'model': 1}, {'data': 0, 'model': 0}, {},
                    'cpu')
    outs = []
    for mesh in (nccl_mesh, cpu_mesh):
        o = make_oracle(X, y, method='sharded', mesh=mesh, variant='opt')
        assert o.device.type == mesh.device.type
        outs.append([t.cpu() for t in (*o.rank_counts(w),
                                       *o.loss_and_subgrad(w))])
    (c, d, loss, a), (c1, d1, loss1, a1) = outs
    assert torch.equal(c, c1) and torch.equal(d, d1)
    assert abs(float(loss) - float(loss1)) <= 1e-6 * abs(float(loss1))
    assert float((a - a1).abs().max()) <= 1e-6 * float(a1.abs().max())


def test_sharded_grouped_pallas_launches_the_kernel_once_a_call(
        cuda_device):
    """Graded queries under engine='pallas' reach the rank-counts kernel
    through the grouped counter (score offsets, cross-query pairs
    subtracted): one launch a call, counts equal the tree engine's."""
    from repro_torch.core.oracle import make_oracle
    X, y, w = _sharded_data('dense')
    g = np.arange(X.shape[0]) // 128
    kern = make_oracle(X, y, g, method='sharded', engine='pallas')
    tree = make_oracle(X, y, g, method='sharded', engine='tree')
    for _ in range(3):
        before = RC.RANK_COUNTS.launches
        kern.loss_and_subgrad(w)
        assert RC.RANK_COUNTS.launches - before == 1
    before = RC.RANK_COUNTS.launches
    c, d = kern.rank_counts(w)
    assert RC.RANK_COUNTS.launches - before == 1
    ct, dt = tree.rank_counts(w)
    assert torch.equal(c, ct) and torch.equal(d, dt)


def test_sharded_csr_transpose_is_deterministic_on_the_card(cuda_device):
    """The CSR transpose sums in exact fixed point: two calls on the card
    give the same bits, and the same bits as the CPU."""
    from repro_torch.core.oracle import make_oracle
    X, y, w = _sharded_data('csr')
    card = make_oracle(X, y, method='sharded')
    a1 = card.loss_and_subgrad(w)[1]
    a2 = card.loss_and_subgrad(w)[1]
    assert torch.equal(a1, a2)
    # Twenty exact bf16 products a row add exactly in float64: the scores,
    # and so the counts, are the CPU's, and the fixed-point sums are the
    # same in any order.
    cpu = make_oracle(X, y, method='sharded', device='cpu')
    c, d = card.rank_counts(w)
    c1, d1 = cpu.rank_counts(w)
    assert torch.equal(c.cpu(), c1) and torch.equal(d.cpu(), d1)
    assert torch.equal(a1.cpu(), cpu.loss_and_subgrad(w)[1])


def test_compressed_mean_on_the_card_equals_the_cpu(cuda_device):
    """Three error-feedback steps of the one-rank compressed mean on the
    card and on the CPU, bit for bit (true division on both)."""
    from repro_torch.distributed import compressed_mean
    from repro_torch.launch.mesh import Mesh
    gen = torch.Generator().manual_seed(0)
    meshes = [Mesh({'data': 1}, {'data': 0}, {}, dev)
              for dev in (cuda_device, 'cpu')]
    errs = [None, None]
    for _ in range(3):
        tree = {'w': torch.randn(32, 16, generator=gen),
                'b': torch.randn(7, generator=gen)}
        outs = []
        for i, mesh in enumerate(meshes):
            out, errs[i] = compressed_mean(
                {k: v.to(mesh.device) for k, v in tree.items()}, mesh,
                'data', errs[i])
            outs.append(out)
        for k in tree:
            assert torch.equal(outs[0][k].cpu(), outs[1][k])
            assert torch.equal(errs[0][k].cpu(), errs[1][k])


# -- dense GQA attention serving (slice 11) -----------------------------------


def _dense_pair(dev):
    """Reduced qwen2.5-3b (4 query heads over 1 KV head, QKV bias) with
    drawn biases, on the CPU and copied to `dev`."""
    cfg = reduced('qwen2.5-3b')
    cpu = LM.init_model(cfg, seed=0, device='cpu')
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for lay in cpu.layers:
            for name in ('bq', 'bk', 'bv'):
                b = getattr(lay.attn, name)
                b.copy_(0.5 * torch.randn(b.shape, generator=g))
    card = LM.from_state_dict(cfg, {k: v.to(dev)
                                    for k, v in cpu.state_dict().items()})
    return cfg, cpu, card


def _inside_bars(got, want, rel, peak):
    got, want = got.float().cpu(), want.float()
    assert bool(torch.isfinite(got).all())
    assert float((got - want).norm() / want.norm()) < rel
    assert float((got - want).abs().max()) <= peak * float(want.abs().max())


def test_dense_prefill_and_decode_on_the_card_match_the_cpu(cuda_device):
    """Reduced qwen2.5-3b with the same weights on both devices: prefill
    logits and cache, then three decode steps into a padded cache, within
    the CPU tests' bars (tests/test_torch_dense_lm.py: logits 3% in
    relative norm and 5% of the largest value, the cache 1% and 2%)."""
    from repro_torch.convert import pad_cache
    cfg, cpu, card = _dense_pair(cuda_device)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, 48)), dtype=torch.int32)
    out = {}
    for dev, model in (('cpu', cpu), ('cuda', card)):
        t = toks.to(dev)
        cache, lg = LM.forward_prefill(model, cfg, {'tokens': t[:, :40]})
        out[dev] = [lg, cache['k'], cache['v']]
        cache = pad_cache(cache, 64)
        for pos in range(40, 43):
            cache, lg = LM.forward_decode(model, cfg, cache,
                                          {'tokens': t[:, pos:pos + 1]}, pos)
            out[dev].append(lg)
        out[dev] += [cache['k'], cache['v']]
    for i, (got, want) in enumerate(zip(out['cuda'], out['cpu'])):
        bars = (0.01, 0.02) if i in (1, 2, 6, 7) else (0.03, 0.05)
        _inside_bars(got, want, *bars)


def test_blockwise_attention_on_the_card_matches_the_cpu(cuda_device):
    """Causal attention at the prefill cell's length (T = 4096, blocks of
    1024), qwen2.5-3b's 16 query heads over 2 KV heads of 128, bf16: the
    card's output within 2^-7 of the CPU's scale (one bf16 ulp: the two
    devices sum the same exact products in another order)."""
    from repro_torch.models.layers import blockwise_attention
    g = torch.Generator().manual_seed(2)
    q = torch.randn((1, 4096, 16, 128), generator=g).to(torch.bfloat16)
    k = torch.randn((1, 4096, 2, 128), generator=g).to(torch.bfloat16)
    v = torch.randn((1, 4096, 2, 128), generator=g).to(torch.bfloat16)
    want = blockwise_attention(q, k, v, causal=True).float()
    got = blockwise_attention(q.to(cuda_device), k.to(cuda_device),
                              v.to(cuda_device), causal=True)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    err = float((got.float().cpu() - want).abs().max())
    assert err <= 2.0 ** -7 * float(want.abs().max())


def test_dense_decode_makes_no_copy_of_the_cache(cuda_device):
    """Decode writes into the caller's cache tensors: the same dict and
    the same storage after every step, and nothing of a cache's size
    allocated by a step."""
    from repro_torch.convert import pad_cache
    cfg, _, card = _dense_pair(cuda_device)
    toks = torch.randint(0, cfg.vocab, (2, 17), dtype=torch.int32,
                         device=cuda_device)
    cache, _ = LM.forward_prefill(card, cfg, {'tokens': toks[:, :16]})
    cache = pad_cache(cache, 32768)
    ptrs = (cache['k'].data_ptr(), cache['v'].data_ptr())
    nbytes = cache['k'].numel() * cache['k'].element_size()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    for pos in range(16, 20):
        new, _ = LM.forward_decode(card, cfg, cache,
                                   {'tokens': toks[:, -1:]}, pos)
        assert new is cache
        assert (cache['k'].data_ptr(), cache['v'].data_ptr()) == ptrs
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before < nbytes


def test_blockwise_attention_f32_grads_on_the_card_match_the_cpu(
        cuda_device):
    """Float32 causal attention over T = 1536 in blocks of 1024 (a short
    last block; rows of the second block past the diagonal masked
    whole), qwen2.5-3b's 16 query heads over 2 KV heads of 128: the
    gradients of q, k and v on the card, TF32 off (`full_f32`), within
    1e-5 of the CPU's scale (the same float32 products summed in another
    order)."""
    from repro_torch.kernels.platform import full_f32
    from repro_torch.models.layers import blockwise_attention
    g = torch.Generator().manual_seed(3)
    shapes = ((1, 1536, 16, 128), (1, 1536, 2, 128), (1, 1536, 2, 128))
    q, k, v = (torch.randn(s, generator=g) for s in shapes)
    do = torch.randn(shapes[0], generator=g)
    grads = {}
    for dev in ('cpu', cuda_device):
        leaves = [x.to(dev).requires_grad_(True) for x in (q, k, v)]
        with full_f32():
            out = blockwise_attention(*leaves, causal=True)
            grads[str(dev)] = torch.autograd.grad(out, leaves, do.to(dev))
    for got, want in zip(grads[str(cuda_device)], grads['cpu']):
        assert bool(torch.isfinite(got).all())
        err = float((got.cpu() - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max())


# -- MLA and MoE serving (slice 13) -------------------------------------------


def _moe_block(dev, cf):
    """The reduced deepseek-v2-lite-16b MoE block (4 experts top-2, one
    shared) at capacity factor `cf`, its seeded init on the CPU and
    copied to `dev`."""
    import dataclasses
    from repro_torch.models.layers import MoE, moe_defs
    from repro_torch.models.params import init_params
    cfg = reduced('deepseek-v2-lite-16b')
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    sd = LM.state_dict_from_tree(init_params(
        moe_defs(cfg), torch.Generator().manual_seed(3)))
    blocks = []
    for d in ('cpu', dev):
        mod = MoE(cfg, device='meta')
        mod.load_state_dict({k: v.to(d) for k, v in sd.items()}, assign=True)
        blocks.append(mod)
    return cfg, blocks


@pytest.mark.parametrize('cf', [2.0, 0.5])
def test_moe_block_on_the_card_matches_the_cpu(cf, cuda_device):
    """The MoE block on the same bf16 input on both devices, without and
    with dropped choices (capacity factor 0.5): experts, keep mask and
    dispatch table equal (every token's k-th and (k+1)-th router
    probabilities 1e-4 apart, relative, checked on the CPU; float32 sums
    in another order move them by some 1e-7), the output within the CPU
    tests' model bars (3% in relative norm, 5% of the largest value)."""
    from repro_torch.models.layers import _router_probs, moe_ffn, moe_route
    cfg, (cpu, card) = _moe_block(cuda_device, cf)
    g = torch.Generator().manual_seed(4)
    x = torch.randn((4, 64, cfg.d_model), generator=g).to(torch.bfloat16)
    k = cfg.moe.top_k
    with torch.no_grad():
        probs = _router_probs(cpu, x.reshape(-1, cfg.d_model))
        top = probs.sort(-1, descending=True)[0]
        margin = (top[:, k - 1] - top[:, k]) / top[:, k - 1]
        assert float(margin.min()) >= 1e-4
        want = moe_route(cpu, cfg, x.reshape(-1, cfg.d_model))
        got = moe_route(card, cfg, x.reshape(-1, cfg.d_model).to(
            cuda_device))
        for name, a, b in zip(('gate', 'idx', 'keep', 'slot', 'table'),
                              got, want):
            if name == 'gate':
                assert float((a.cpu() - b).abs().max()) <= 1e-6
            else:
                assert torch.equal(a.cpu(), b), name
        assert bool(want[2].all()) == (cf == 2.0)
        y = moe_ffn(card, cfg, x.to(cuda_device))
        y_cpu = moe_ffn(cpu, cfg, x)
    assert y.dtype == torch.bfloat16
    _inside_bars(y, y_cpu, 0.03, 0.05)


def test_mla_prefill_and_decode_on_the_card_match_the_cpu(cuda_device):
    """The reduced deepseek-v2-lite-16b MLA block on the same bf16 inputs
    on both devices: a causal prefill of 40 positions (output within the
    model bars, c_kv and k_rope within the cache bars, 1% and 2%), then
    three decode steps into a cache of 4500 positions (three blocks of
    2048, the visited ones projected), each written in place."""
    from repro_torch.models.layers import MLA, mla_defs
    from repro_torch.models.params import init_params
    cfg = reduced('deepseek-v2-lite-16b')
    tree = init_params(mla_defs(cfg), torch.Generator().manual_seed(5))
    mods = {}
    for dev in ('cpu', cuda_device):
        mods[dev] = MLA(cfg, device='meta')
        mods[dev].load_state_dict({k: v.to(dev) for k, v in tree.items()},
                                  assign=True)
    g = torch.Generator().manual_seed(6)
    x = torch.randn((2, 43, cfg.d_model), generator=g).to(torch.bfloat16)
    pos = torch.arange(43).expand(2, 43)
    out = {}
    with torch.no_grad():
        for dev, mod in mods.items():
            xd, pd = x.to(dev), pos.to(dev)
            y, (ckv, kr) = mod(xd[:, :40], pd[:, :40])
            cache = [t.new_zeros((2, 4500, t.shape[-1])) for t in (ckv, kr)]
            cache[0][:, :40], cache[1][:, :40] = ckv, kr
            out[str(dev)] = [y, ckv, kr]
            for p in range(40, 43):
                y, pair = mod(xd[:, p:p + 1], pd[:, p:p + 1], tuple(cache),
                              p, True)
                assert pair[0] is cache[0] and pair[1] is cache[1]
                out[str(dev)].append(y)
            out[str(dev)] += cache
    for i, (got, want) in enumerate(zip(out[str(cuda_device)],
                                        out['cpu'])):
        bars = (0.01, 0.02) if i in (1, 2, 6, 7) else (0.03, 0.05)
        _inside_bars(got, want, *bars)


# -- MLA and MoE training (slice 14) ------------------------------------------

# (arch, objective): the first seed whose every MoE call leaves, on the
# CPU, a relative margin of at least 1.5e-3 (the test's 1e-3 and room)
# between each token's k-th and (k+1)-th router probability ('lm' at
# 2 x 32, 'rank_hinge' at 16 x 4, the CPU tests' sizes)
MOE_TRAIN_SEEDS = {('deepseek-v2-lite-16b', 'lm'): 3,
                   ('deepseek-v2-lite-16b', 'rank_hinge'): 4,
                   ('moonshot-v1-16b-a3b', 'lm'): 0,
                   ('moonshot-v1-16b-a3b', 'rank_hinge'): 3}


def _moe_train_step(arch, objective, seed, dev):
    """One train step (remat='layer') of reduced `arch` on `dev` from the
    port's seeded init with the stacked layers' matrices at std
    1/sqrt(fan-in) (the CPU tests' rule; the router at its own 0.02):
    (metrics, [(MoE input, router)] of every MoE call, forward and
    recompute)."""
    import math
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import RewardPipeline, TokenPipeline
    from repro_torch.data import TokenPipelineConfig
    from repro_torch.models.layers import MoE
    from repro_torch.train.trainer import make_train_step, state_for
    cfg = reduced(arch)
    model = LM.init_model(cfg, seed=seed, device='cpu')
    with torch.no_grad():
        for name, p in model.named_parameters():
            if (name.startswith('layers.') and p.ndim >= 2
                    and not name.endswith('.router')):
                p.mul_(math.sqrt(len(model.layers) / p.shape[-2]))
    model = LM.from_state_dict(cfg, {k: v.to(dev) for k, v in
                                     model.state_dict().items()})
    if objective == 'lm':
        raw = TokenPipeline(TokenPipelineConfig(cfg.vocab, 32, 2,
                                                seed=seed)).batch(0)
    else:
        raw = RewardPipeline(cfg.vocab, 4, 16, seed=seed).batch(0)
        raw.pop('groups', None)
    calls = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: calls.append(
        (args[0].detach().reshape(-1, cfg.d_model), mod.router.detach())))
        for m in model.modules() if isinstance(m, MoE)]
    batch = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
    _, m = make_train_step(cfg, TrainConfig(objective=objective,
                                            warmup_steps=0))(
        state_for(model), batch)
    for h in hooks:
        h.remove()
    return {k: float(v) for k, v in m.items()}, calls


def _moe_choices_and_margin(calls, k):
    """Per call the sorted top-k experts, and the least relative margin
    between a token's k-th and (k+1)-th router probability."""
    from types import SimpleNamespace
    from repro_torch.models.layers import _router_probs, _top_k
    choices, least = [], float('inf')
    with torch.no_grad():
        for x, r in calls:
            top, idx = _top_k(_router_probs(SimpleNamespace(router=r), x),
                              k + 1)
            choices.append(idx[:, :k].sort(-1)[0].cpu())
            least = min(least, float(((top[:, k - 1] - top[:, k])
                                      / top[:, k - 1]).min()))
    return choices, least


@pytest.mark.parametrize('arch', ['deepseek-v2-lite-16b',
                                  'moonshot-v1-16b-a3b'])
@pytest.mark.parametrize('objective', ['lm', 'rank_hinge'])
def test_moe_train_step_on_the_card_matches_the_cpu(objective, arch,
                                                    cuda_device):
    """One train step of reduced deepseek-v2-lite-16b (MLA) or
    moonshot-v1-16b-a3b (GQA), each a dense layer 0 and two MoE layers,
    from the same state on both devices: first every MoE call (forward
    and recompute) routes every token alike on both, the CPU's margin at
    least 1e-3; then the loss within 2e-3 and gnorm within 2e-2 relative,
    as for the dense configs above."""
    seed = MOE_TRAIN_SEEDS[arch, objective]
    k = reduced(arch).moe.top_k
    cpu, calls_c = _moe_train_step(arch, objective, seed, 'cpu')
    card, calls = _moe_train_step(arch, objective, seed, cuda_device)
    want, least = _moe_choices_and_margin(calls_c, k)
    got, _ = _moe_choices_and_margin(calls, k)
    assert least >= 1e-3 and len(got) == len(want) == 4
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert abs(card['loss'] - cpu['loss']) <= 2e-3 * abs(cpu['loss'])
    assert abs(card['gnorm'] - cpu['gnorm']) <= 2e-2 * cpu['gnorm']
