"""The port on the card: each CUDA kernel against its plain torch version
(the counting kernels bit for bit; the WKV forward kernel's states and
the backward kernel's ds0 bit for bit, their other outputs within the
tolerances below), a fit on the card against the same fit on the CPU,
the sparse and streamed oracles on the card (the tree's memory, the
device transpose-matvec, the streaming budget and its determinism), and
the reduced RWKV-6 prefill and train step on the card against the CPU.

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


@pytest.mark.parametrize('objective', ['lm', 'rank_hinge'])
def test_train_step_on_the_card_matches_the_cpu(objective, cuda_device):
    """One train step of reduced RWKV-6 (kernel route, remat='layer') from
    the same state on both devices: each layer launches the forward
    kernel twice (forward and recompute) and the backward kernel once;
    loss within 2e-3 and gnorm within 2e-2 relative (bf16 activations,
    rounded in another order by the card's matmuls)."""
    import dataclasses
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import RewardPipeline, TokenPipeline
    from repro_torch.data import TokenPipelineConfig
    from repro_torch.train.trainer import make_train_step, state_for
    cfg = dataclasses.replace(reduced('rwkv6-3b'), wkv_impl='kernel')
    tcfg = TrainConfig(objective=objective, warmup_steps=0)
    if objective == 'lm':
        raw = TokenPipeline(TokenPipelineConfig(cfg.vocab, 64, 16)).batch(0)
    else:
        raw = RewardPipeline(cfg.vocab, 64, 16).batch(0)
        raw.pop('groups', None)
    metrics = {}
    for dev in ('cpu', cuda_device):
        model = LM.init_model(cfg, seed=0, device='cpu')
        model = LM.from_state_dict(cfg, {k: v.to(dev) for k, v in
                                         model.state_dict().items()})
        state = state_for(model)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
        fwd, bwd = W.WKV_FWD.launches, W.WKV_BWD.launches
        _, m = make_train_step(cfg, tcfg)(state, batch)
        metrics[str(dev)] = {k: float(v) for k, v in m.items()}
        if dev != 'cpu':
            torch.cuda.synchronize()
            assert W.WKV_FWD.launches - fwd == 2 * cfg.n_layers
            assert W.WKV_BWD.launches - bwd == cfg.n_layers
    cpu, card = metrics['cpu'], metrics[str(cuda_device)]
    assert abs(card['loss'] - cpu['loss']) <= 2e-3 * abs(cpu['loss'])
    assert abs(card['gnorm'] - cpu['gnorm']) <= 2e-2 * cpu['gnorm']
