"""Linearithmic RankSVM frequency counts: the merge-sort tree in torch.

The counterpart of `repro.core.counts`. The paper sweeps the examples in
sorted-p order while keeping a red-black order-statistics tree over the
y values inside the moving margin frontier (Algorithm 3). The schedule of
that sweep is known after one sort: elements enter in sorted-p order and
query i fires when the frontier holds L_i = |{k : p_k < p_i + 1}|
elements. So the dynamic tree becomes a static merge-sort tree (level b
holds y, in p order, sorted inside aligned blocks of 2^b) queried with
batched branchless binary searches: O(m log^2 m) work, O(log m) depth.

Tie semantics are the reference's, bit for bit:

* every sort that orders examples is stable (`stable=True`), as
  `jnp.argsort` is;
* `torch.searchsorted(..., right=False)` is jnp's `side='left'` and
  `right=True` is `side='right'`;
* the margin thresholds p +- 1 are rounded once to float32, exactly as
  the O(m^2) reference rounds them;
* d comes from the same tree as c through the complement query
  d_i = |{k : y_k < y_i}| - |{k : y_k < y_i and p_k <= p_i - 1}|, where
  `p_k <= p_i - 1` is the exact float complement of `p_k > p_i - 1`.

float64 scores and utilities are cast to float32 first, which is what
the JAX package's inputs undergo (it runs without 64-bit floats).
Distinct float64 utilities can tie after the cast; the counts then tie
the same way in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

ENGINES = ('tree', 'blocked', 'pallas', 'auto')

_I64 = torch.int64


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32) if t.dtype == torch.float64 else t


def _next_pow2(m: int) -> int:
    return 1 if m <= 1 else 1 << (m - 1).bit_length()


def _pad(t: torch.Tensor, n: int, value: float) -> torch.Tensor:
    if n == 0:
        return t
    return torch.cat([t, torch.full((n,), value, dtype=t.dtype,
                                    device=t.device)])


def _index_dtype(mpad: int) -> torch.dtype:
    """int32 positions while every padded position fits, else int64: the
    searches and the totals then take half the memory."""
    return torch.int32 if mpad < 2 ** 31 else _I64


def _count_cmp_in_block(flat, base, t, block: int, strict: bool):
    """Branchless binary search: for each query q, the number of elements
    < t[q] (strict) or <= t[q] inside the sorted block
    flat[base[q] : base[q] + block]. `block` is a power of two. The
    steps update their positions in place, so a search holds four
    position-sized vectors beside its inputs."""
    cmp = torch.lt if strict else torch.le
    mmax = flat.shape[0] - 1
    i = torch.zeros_like(base)
    idx = torch.empty_like(base)
    step = block // 2
    while step >= 1:
        torch.add(base, i, out=idx)
        idx.add_(step - 1).clamp_(max=mmax)
        i.add_(cmp(flat[idx], t), alpha=step)
        step //= 2
    torch.add(base, i, out=idx)
    idx.clamp_(max=mmax)
    return i.add_(cmp(flat[idx], t))


def _tree_level(y_pad: torch.Tensor, b: int) -> torch.Tensor:
    """Level b of the merge-sort tree: y_pad sorted inside aligned blocks
    of 2^b, flattened. Level 0 is y_pad itself."""
    if b == 0:
        return y_pad
    block = 1 << b
    return torch.sort(y_pad.view(-1, block), dim=1).values.view(-1)


def _prefix_queries(y_pad, queries):
    """Answer several prefix queries over one merge-sort tree, building
    one level at a time: level b is sorted, every query takes its block
    count there, and the level is freed before the next is built, so
    one level (m floats) is alive instead of all log2(m) of them.

    `queries` is a sequence of (prefix_len, thresholds, mode):
        mode 'gt': |{k < prefix_len[i] : y_seq[k] > thresholds[i]}|
        mode 'lt': |{k < prefix_len[i] : y_seq[k] < thresholds[i]}|
    prefix_len is an integer tensor (int32 where the positions fit);
    each answer has its dtype. A prefix decomposes into one aligned
    block per set bit of its length, and each block answers with one
    binary search."""
    mpad = y_pad.shape[0]
    nlev = mpad.bit_length() - 1
    totals = [torch.zeros_like(q[0]) for q in queries]
    for b in range(nlev + 1):
        block = 1 << b
        level = _tree_level(y_pad, b)
        for total, (prefix_len, thresholds, mode) in zip(totals, queries):
            bit = ((prefix_len >> b) & 1).bool()
            base = prefix_len >> (b + 1)
            base <<= b + 1                              # bits <= b cleared
            if block == 1:
                v = level[base.clamp_(max=mpad - 1)]
                cnt = (v > thresholds) if mode == 'gt' else (v < thresholds)
            elif mode == 'gt':
                cnt = _count_cmp_in_block(level, base, thresholds, block,
                                          strict=False).neg_().add_(block)
            else:
                cnt = _count_cmp_in_block(level, base, thresholds, block,
                                          strict=True)
            del base
            total += cnt.mul_(bit)
        del level
    return totals


def _prefix_count_greater(y_seq, prefix_len, thresholds):
    """For each query i: |{k < prefix_len[i] : y_seq[k] > thresholds[i]}|."""
    m = y_seq.shape[0]
    if m == 0:
        return torch.zeros((0,), dtype=prefix_len.dtype,
                           device=y_seq.device)
    mpad = _next_pow2(m)
    # The pad value is irrelevant: prefix_len <= m, and every aligned
    # block of the decomposition lies inside [0, prefix_len).
    y_pad = _pad(y_seq, mpad - m, float('inf'))
    return _prefix_queries(y_pad, [(prefix_len, thresholds, 'gt')])[0]


def _scatter_back(order, sorted_vals, m):
    out = torch.empty((m,), dtype=torch.int32, device=order.device)
    out[order] = sorted_vals.to(torch.int32)
    return out


def _half_counts(p, y):
    """c_i = |{j : y_j > y_i  and  p_j < p_i + 1}| in O(m log^2 m)."""
    m = p.shape[0]
    ps, order = torch.sort(p, stable=True)
    ys = y[order]
    frontier = torch.searchsorted(
        ps, ps + 1.0, right=False,
        out_int32=_index_dtype(_next_pow2(m)) == torch.int32)
    c_sorted = _prefix_count_greater(ys, frontier, ys)
    return _scatter_back(order, c_sorted, m)


def counts(p: torch.Tensor, y: torch.Tensor):
    """(c, d) by two sweeps: d through the reflection d(p, y) = c(-p, -y),
    which is exact in floating point. Bit-identical to `ref.counts_ref`."""
    p, y = _f32(p), _f32(y)
    return _half_counts(p, y), _half_counts(-p, -y)


def counts_fused(p: torch.Tensor, y: torch.Tensor):
    """(c, d) from ONE sort and ONE merge-sort tree, the oracle layer's
    tree engine; bit-identical to `counts` and `ref.counts_ref`.

    c counts y_k > y_i inside the frontier p_k < p_i + 1. d is the global
    strict y-rank of y_i minus the y_k < y_i inside the prefix
    p_k <= p_i - 1, answered from the same tree.

    Memory: 24 m bytes of vectors live through the tree queries (the
    order, sorted utilities, both prefix lengths and both totals, all
    32-bit below 2^31 positions), plus one tree level and the searches
    or the sort that builds it; keeping every level alive at once would
    add 4 m log2(m) bytes."""
    p, y = _f32(p), _f32(y)
    m = p.shape[0]
    if m == 0:
        z = torch.zeros((0,), dtype=torch.int32, device=p.device)
        return z, z.clone()
    mpad = _next_pow2(m)
    i32 = _index_dtype(mpad) == torch.int32
    ps, order = torch.sort(p, stable=True)
    ys = y[order]
    if i32:
        order = order.to(torch.int32)
    frontier = torch.searchsorted(ps, ps + 1.0, right=False, out_int32=i32)
    inner = torch.searchsorted(ps, ps - 1.0, right=True, out_int32=i32)
    del ps
    y_pad = _pad(ys, mpad - m, float('inf'))
    c_sorted, d_sorted = _prefix_queries(
        y_pad, [(frontier, ys, 'gt'), (inner, ys, 'lt')])
    del frontier, inner, y_pad
    # d = the global strict y-rank minus the lower y inside the prefix
    d_sorted.neg_().add_(torch.searchsorted(torch.sort(y).values, ys,
                                            right=False, out_int32=i32))
    return _scatter_back(order, c_sorted, m), _scatter_back(order, d_sorted,
                                                            m)


def _group_offsets(p, y, g):
    """Per-group key offsets that make ONE global pass count within-group
    pairs only.

    With dp > range(p) + 2 and dy > range(y), p~ = p + g dp and
    y~ = y + g dy: a cross-group pair fails the margin test one way and
    the preference test the other, while within-group comparisons are
    unchanged (the offsets cancel). p is float32, as every caller casts
    it."""
    return _offset_scores(p, g), _offset_utilities(y, g)


def _offset_scores(p, g):
    """The score half of `_group_offsets`, made on every counting call."""
    return p + g.to(p.dtype) * ((p.max() - p.min()) + 2.5)


def _offset_utilities(y, g):
    """The utility half of `_group_offsets`, in float32; it depends on y
    and g only, so a counter makes it once."""
    y = _f32(y)
    return y + g.to(y.dtype) * ((y.max() - y.min()) + 1.0)


def counts_grouped_fused(p, y, g):
    """Grouped (c, d) through the single-tree pass. Keep
    |groups| * (range(p) + range(y)) below about 1e4 so one float32 ulp at
    the largest offset key stays well under the margin."""
    p, y = _f32(p), _f32(y)
    pg, yg = _group_offsets(p, y, g)
    return counts_fused(pg, yg)


def counts_grouped(p, y, g):
    """(c, d) restricted to within-group pairs: `counts` on the group
    offset keys, the reference's `counts_grouped`. The same precision
    note as `counts_grouped_fused` holds."""
    p, y = _f32(p), _f32(y)
    pg, yg = _group_offsets(p, y, g)
    return counts(pg, yg)


def counts_blocked_host(p, y, block: int = 2048):
    """O(m^2) pairwise counts with O(m * block) memory (the PairRSVM
    baseline): candidates in blocks of `block`, every query at once."""
    p, y = _f32(p), _f32(y)
    m = p.shape[0]
    c = torch.zeros((m,), dtype=_I64, device=p.device)
    d = torch.zeros((m,), dtype=_I64, device=p.device)
    hi = (p + 1.0)[:, None]
    lo = (p - 1.0)[:, None]
    yi = y[:, None]
    for j0 in range(0, m, block):
        pj = p[None, j0:j0 + block]
        yj = y[None, j0:j0 + block]
        c += ((yj > yi) & (pj < hi)).sum(dim=1)
        d += ((yj < yi) & (pj > lo)).sum(dim=1)
    return c.to(torch.int32), d.to(torch.int32)


def num_pairs(y: torch.Tensor) -> torch.Tensor:
    """N = |{(i, j) : y_i < y_j}| in O(m log m), as float32 like the
    reference (whose int32 would overflow at m^2). `num_pairs_host` is
    exact."""
    y = _f32(y)
    m = y.shape[0]
    ys = torch.sort(y).values
    eq = (torch.searchsorted(ys, y, right=True)
          - torch.searchsorted(ys, y, right=False)).to(torch.float32)
    mm = torch.tensor(float(m) * float(m), dtype=torch.float32,
                      device=y.device)
    return (mm - eq.sum()) * 0.5


def num_pairs_host(y) -> int:
    """Exact N on the host (Python ints)."""
    y = np.asarray(y)
    m = int(y.shape[0])
    _, cnts = np.unique(y, return_counts=True)
    ties = int(np.sum(cnts.astype(np.int64) ** 2))
    return (m * m - ties) // 2


def num_pairs_grouped(y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """N restricted to within-group pairs, as float32 (see num_pairs)."""
    m = y.shape[0]
    yf = y.to(torch.float32)
    dy = (yf.max() - yf.min()) + 1.0
    yg = yf + g.to(torch.float32) * dy
    # Pairs under offset keys = within-group pairs plus ALL cross-group
    # pairs (the offsets order the groups strictly).
    n_off = num_pairs(yg)
    gf = g.to(torch.float32)
    gs = torch.sort(gf).values
    eq = (torch.searchsorted(gs, gf, right=True)
          - torch.searchsorted(gs, gf, right=False)).to(torch.float32)
    cross = (float(m) * float(m) - eq.sum()) * 0.5
    return n_off - cross


def _validate_block_rows(block_rows, what: str = 'block_rows') -> int:
    """Reject non-positive, fractional or boolean block sizes loudly."""
    ok = isinstance(block_rows, (int, np.integer)) and not isinstance(
        block_rows, bool)
    if not ok and isinstance(block_rows, (float, np.floating)):
        if not float(block_rows).is_integer():
            raise ValueError(f'{what} must be a whole number of rows; got '
                             f'the fractional value {block_rows!r}')
        ok = True
    if not ok:
        raise ValueError(f'{what} must be a positive integer; got '
                         f'{block_rows!r} of type '
                         f'{type(block_rows).__name__}')
    block_rows = int(block_rows)
    if block_rows <= 0:
        raise ValueError(f'{what} must be a positive integer; got '
                         f'{block_rows}')
    return block_rows


def _validate_engine(engine: str) -> None:
    """Reject a typo'd engine name before any work happens."""
    if engine not in ENGINES:
        raise ValueError(f'unknown counting engine {engine!r}; '
                         f'expected one of {ENGINES}')


def make_counter(y, g, engine: str = 'tree', block: int = 2048):
    """`p -> (c, d)` for fixed utilities y (and group ids g, or None): the
    counting core every oracle shares, with the engine picked by `engine`.

      'tree'     merge-sort tree, one fused pass (`counts_fused`)
      'blocked'  O(m^2) pairwise, O(m * block) memory
      'pallas'   the hand-written rank-counts kernel
                 (`kernels.rank_counts.rank_counter`); the name is the
                 reference's, so both packages take the same call
      'auto'     `kernels.pairwise_rank.auto_counter`: on the card the
                 pairwise kernel up to KERNEL_MAX_M examples, the
                 rank-counts kernel above; off the card the tree

    Grouped counting applies the key-offset trick (`_group_offsets`): the
    utility keys are made here, the score keys on each call. What depends
    on y alone (the kernels' rank compression and level guard, with its
    read-back) is done here once, so an oracle that keeps its counter
    pays it once per fit."""
    _validate_engine(engine)
    if engine == 'blocked':
        block = _validate_block_rows(block, 'counts_dispatch block')
    if engine == 'tree':
        if g is None:
            return lambda p: counts_fused(p, y)
        return lambda p: counts_grouped_fused(p, y, g)
    yk = _f32(y) if g is None else _offset_utilities(y, g)
    if engine == 'auto':
        from ..kernels.pairwise_rank import ops as _pr_ops
        count = _pr_ops.auto_counter(yk)
    elif engine == 'pallas':
        from ..kernels.rank_counts import ops as _rc_ops
        count = _rc_ops.rank_counter(yk)
    else:
        def count(p):
            return counts_blocked_host(p, yk, block=block)
    if g is None:
        return count
    return lambda p: count(_offset_scores(_f32(p), g))


def counts_dispatch(p, y, g, engine: str = 'tree', block: int = 2048,
                    v=None):
    """(c, d) by `engine` in one call: `make_counter(y, g, engine,
    block)(p)`. g is None for ungrouped counting.

    Weighted counting (`v=`) belongs to the loss axis, not ported yet."""
    _validate_engine(engine)
    if v is not None:
        raise NotImplementedError(
            'weighted counting (v=) is not ported yet: ROADMAP.md Queue 1 '
            'item 7 (the loss axis)')
    return make_counter(y, g, engine=engine, block=block)(p)
