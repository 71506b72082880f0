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

The weighted tree of the position-weighted hinge (`counts_weighted_
fused`, `make_counter(v=)`) carries one float32 prefix sum of the
weights per level beside the sorted utilities, so its d is the tree's,
bit for bit, and its c~ a float32 sum.

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


def _prefix_queries(y_pad, queries, v_pad=None):
    """Answer several prefix queries over one merge-sort tree, building
    one level at a time: level b is sorted, every query takes its block
    count there, and the level is freed before the next is built, so
    one level (m floats) is alive instead of all log2(m) of them.

    `queries` is a sequence of (prefix_len, thresholds, mode):
        mode 'gt':  |{k < prefix_len[i] : y_seq[k] > thresholds[i]}|
        mode 'lt':  |{k < prefix_len[i] : y_seq[k] < thresholds[i]}|
        mode 'wgt': sum of v_seq[k] over {k < prefix_len[i] :
                    y_seq[k] > thresholds[i]}, in float32
    prefix_len is an integer tensor (int32 where the positions fit);
    each count has its dtype. A prefix decomposes into one aligned
    block per set bit of its length, and each block answers with one
    binary search. A 'wgt' query needs the weights `v_pad`: each level
    then also sorts them with y (one stable sort inside the blocks,
    and a gather of v by its indices) and takes one float32 cumsum per
    block, so that a block answers with its total weight minus the
    prefix sum at the search position; the indices are dropped before
    the queries run, and the sums go with the level."""
    mpad = y_pad.shape[0]
    nlev = mpad.bit_length() - 1
    weighted = any(mode == 'wgt' for _, _, mode in queries)
    totals = [torch.zeros(q[0].shape, dtype=torch.float32, device=q[0].device)
              if q[2] == 'wgt' else torch.zeros_like(q[0]) for q in queries]
    for b in range(nlev + 1):
        block = 1 << b
        wsum = None
        if b == 0:
            level, wsum = y_pad, v_pad
        elif weighted:
            level, idx = torch.sort(y_pad.view(-1, block), dim=1,
                                    stable=True)
            wsum = v_pad.view(-1, block).gather(1, idx)
            del idx
            wsum = wsum.cumsum_(dim=1).view(-1)
            level = level.view(-1)
        else:
            level = _tree_level(y_pad, b)
        for total, (prefix_len, thresholds, mode) in zip(totals, queries):
            bit = ((prefix_len >> b) & 1).bool()
            base = prefix_len >> (b + 1)
            base <<= b + 1                              # bits <= b cleared
            if block == 1:
                base.clamp_(max=mpad - 1)
                v = level[base]
                if mode == 'wgt':
                    cnt = torch.where(v > thresholds, wsum[base], 0.0)
                else:
                    cnt = (v > thresholds) if mode == 'gt' else (
                        v < thresholds)
            elif mode == 'wgt':
                pos = _count_cmp_in_block(level, base, thresholds, block,
                                          strict=False)
                # total weight of the block minus the weight of its
                # pos elements <= the threshold
                cnt = wsum[(base + (block - 1)).clamp_(max=mpad - 1)]
                lo = wsum[(base + pos - 1).clamp_(0, mpad - 1)]
                cnt -= lo.mul_(pos > 0)
                del pos, lo
            elif mode == 'gt':
                cnt = _count_cmp_in_block(level, base, thresholds, block,
                                          strict=False).neg_().add_(block)
            else:
                cnt = _count_cmp_in_block(level, base, thresholds, block,
                                          strict=True)
            del base
            total += cnt.mul_(bit)
        del level, wsum
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


def _prefix_weighted_greater(y_seq, v_seq, prefix_lens, thresholds):
    """For each prefix length vector L in `prefix_lens` and each query i:
    the float32 sum of v_seq[k] over {k < L[i] : y_seq[k] > thresholds[i]},
    all from one weighted tree (the weighted analogue of
    `_prefix_count_greater`, for `rank_loss.position_weighted_error`)."""
    m = y_seq.shape[0]
    if m == 0:
        return [torch.zeros((0,), dtype=torch.float32, device=y_seq.device)
                for _ in prefix_lens]
    mpad = _next_pow2(m)
    y_pad = _pad(y_seq, mpad - m, float('inf'))
    v_pad = _pad(v_seq.to(torch.float32), mpad - m, 0.0)
    return _prefix_queries(y_pad, [(L, thresholds, 'wgt')
                                   for L in prefix_lens], v_pad)


def _scatter_back(order, sorted_vals, m, dtype=torch.int32):
    out = torch.empty((m,), dtype=dtype, device=order.device)
    out[order] = sorted_vals.to(dtype)
    return out


def _half_counts(p, y, rows=None):
    """c_i = |{j : y_j > y_i  and  p_j < p_i + 1}| in O(m log^2 m).

    `rows` = (r0, r1) answers only the queries of examples r0 .. r1-1, in
    their order, against the tree of all m examples: the query split of
    the sharded oracle's variant='opt' (`core.distributed`), where each
    rank builds the whole tree from the gathered scores and answers its
    own rows. Example i's query is its frontier (the sorted scores below
    p_i + 1) and its threshold y_i, so the rows' counts need no
    permutation back."""
    m = p.shape[0]
    i32 = _index_dtype(_next_pow2(m)) == torch.int32
    ps, order = torch.sort(p, stable=True)
    ys = y[order]
    if rows is not None:
        r0, r1 = rows
        frontier = torch.searchsorted(ps, p[r0:r1] + 1.0, right=False,
                                      out_int32=i32)
        del ps, order
        return _prefix_count_greater(ys, frontier, y[r0:r1]).to(torch.int32)
    frontier = torch.searchsorted(ps, ps + 1.0, right=False, out_int32=i32)
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


def lexsort(y, g):
    """The stable order by g, then y (`jnp.lexsort((y, g))`): two stable
    sorts, so equal keys keep their order."""
    o1 = torch.sort(y, stable=True).indices
    return o1[torch.sort(g[o1], stable=True).indices]


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
    """The score half of `_group_offsets`, made on every counting call;
    each row of a batch of scores (L, m) gets the offsets of its own
    range, as a call on that row alone would."""
    span = p.amax(dim=-1, keepdim=True) - p.amin(dim=-1, keepdim=True)
    return p + g.to(p.dtype) * (span + 2.5)


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


def counts_weighted_fused(p: torch.Tensor, y: torch.Tensor,
                          v: torch.Tensor):
    """(c~, d) for the position-weighted hinge from ONE sort and ONE
    weighted tree:

        c~_i = sum of v_j over {j : y_j > y_i and p_j < p_i + 1}  (float32)
        d_i  = |{j : y_j < y_i and p_j > p_i - 1}|                (int32)

    A weighted pair carries the weight of its higher-utility side, so
    only the c-side query is weighted; the caller scales d by each
    example's own weight. d is `counts_fused`'s, bit for bit (the levels
    hold the same sorted blocks). c~ is a float32 sum in another order
    than the reference's: it agrees to about 1e-6 of sum(v).

    Memory: `counts_fused`'s, plus the weights in p order (4 m bytes),
    and while a level is built its float32 prefix sums and the sort's
    int64 indices (12 m bytes); the levels go one at a time."""
    p, y = _f32(p), _f32(y)
    m = p.shape[0]
    if m == 0:
        return (torch.zeros((0,), dtype=torch.float32, device=p.device),
                torch.zeros((0,), dtype=torch.int32, device=p.device))
    mpad = _next_pow2(m)
    i32 = _index_dtype(mpad) == torch.int32
    ps, order = torch.sort(p, stable=True)
    ys = y[order]
    vs = v.to(torch.float32)[order]
    if i32:
        order = order.to(torch.int32)
    frontier = torch.searchsorted(ps, ps + 1.0, right=False, out_int32=i32)
    inner = torch.searchsorted(ps, ps - 1.0, right=True, out_int32=i32)
    del ps
    y_pad = _pad(ys, mpad - m, float('inf'))
    v_pad = _pad(vs, mpad - m, 0.0)
    del vs
    cw_sorted, d_sorted = _prefix_queries(
        y_pad, [(frontier, ys, 'wgt'), (inner, ys, 'lt')], v_pad)
    del frontier, inner, y_pad, v_pad
    d_sorted.neg_().add_(torch.searchsorted(torch.sort(y).values, ys,
                                            right=False, out_int32=i32))
    return (_scatter_back(order, cw_sorted, m, torch.float32),
            _scatter_back(order, d_sorted, m))


def counts_weighted_grouped_fused(p, y, g, v):
    """Grouped (c~, d) through the key offsets: a cross-group element
    fails the margin or the preference test, so its weight enters no
    c~ sum; the weights ride along unchanged."""
    p, y = _f32(p), _f32(y)
    pg, yg = _group_offsets(p, y, g)
    return counts_weighted_fused(pg, yg, v)


def counts_blocked_weighted(p, y, v, block: int = 2048):
    """O(m^2) weighted (c~, d) with O(m * block) memory: the blocked
    engine's counterpart of `counts_weighted_fused`."""
    p, y = _f32(p), _f32(y)
    v = v.to(torch.float32)
    m = p.shape[0]
    cw = torch.zeros((m,), dtype=torch.float32, device=p.device)
    d = torch.zeros((m,), dtype=_I64, device=p.device)
    hi = (p + 1.0)[:, None]
    lo = (p - 1.0)[:, None]
    yi = y[:, None]
    for j0 in range(0, m, block):
        pj = p[None, j0:j0 + block]
        yj = y[None, j0:j0 + block]
        cw += torch.where((yj > yi) & (pj < hi), v[None, j0:j0 + block],
                          0.0).sum(dim=1)
        d += ((yj < yi) & (pj > lo)).sum(dim=1)
    return cw, d.to(torch.int32)


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


def by_row(count, p):
    """count(p) for one score vector; for a batch of scores (L, m) the
    per-row results stacked along a leading axis, row i bit-equal to
    count(p[i]). The outputs are allocated once and filled row by row,
    so one row's temporaries are alive at a time. The counterpart of the
    reference's `sequential_vmap`: one call per lambda."""
    if p.dim() == 1:
        return count(p)
    first = count(p[0])
    single = torch.is_tensor(first)
    first = (first,) if single else tuple(first)
    out = tuple(torch.empty((p.shape[0],) + t.shape, dtype=t.dtype,
                            device=t.device) for t in first)
    for o, t in zip(out, first):
        o[0] = t
    del first
    for i in range(1, p.shape[0]):
        row = count(p[i])
        for o, t in zip(out, (row,) if single else row):
            o[i] = t
        del row
    return out[0] if single else out


def make_counter(y, g, engine: str = 'tree', block: int = 2048, v=None):
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

    The counter also takes a batch of scores (L, m), one row per lambda
    of a regularization path, and returns (L, m) counts, each row
    bit-equal to the call on that row (`by_row`).

    Grouped counting applies the key-offset trick (`_group_offsets`): the
    utility keys are made here, the score keys on each call. Under
    'pallas' a grouped counter whose utilities fit the kernel's levels
    offsets the scores only and subtracts the cross-group pairs, which do
    not depend on p (`_grouped_rank_counter`), so graded queries reach
    the kernel instead of the tree. What depends
    on y alone (the kernels' rank compression and level guard, with its
    read-back) is done here once, so an oracle that keeps its counter
    pays it once per fit, for every row of a batch.

    v (per-example float weights, or None) makes the counter weighted,
    for the position-weighted hinge: `p -> (c~, d)` with c~ the float32
    weighted sums of `counts_weighted_fused`. 'blocked' runs the weighted
    pairwise pass; the counting kernels have no weighted variant, so
    'pallas' and 'auto' fall back to the weighted tree, as the reference
    does (an unweighted kernel would compute another objective)."""
    _validate_engine(engine)
    if engine == 'blocked':
        block = _validate_block_rows(block, 'counts_dispatch block')
    if engine == 'pallas' and v is None and g is not None:
        grouped = _grouped_rank_counter(y, g)
        if grouped is not None:
            return grouped
    yk = _f32(y) if g is None else _offset_utilities(y, g)
    if engine == 'auto' and v is None:
        from ..kernels.pairwise_rank import ops as _pr_ops
        count = _pr_ops.auto_counter(yk)
    elif engine == 'pallas' and v is None:
        from ..kernels.rank_counts import ops as _rc_ops
        count = _rc_ops.rank_counter(yk)
    else:
        if engine == 'blocked' and v is None:
            def one(p):
                return counts_blocked_host(p, yk, block=block)
        elif engine == 'blocked':
            def one(p):
                return counts_blocked_weighted(p, yk, v, block=block)
        elif v is None:
            def one(p):
                return counts_fused(p, yk)
        else:           # the weighted tree, also for 'pallas' and 'auto'
            def one(p):
                return counts_weighted_fused(p, yk, v)

        def count(p):
            return by_row(one, p)
    if g is None:
        return count
    return lambda p: count(_offset_scores(_f32(p), g))


# Largest (groups x utility levels) table `_grouped_rank_counter` builds.
CROSS_GROUP_TABLE = 1 << 24


def _cross_group_counts(y, g):
    """(C, D) int32, what score-only key offsets add to (c, d) for fixed
    y and g: C_i = |{j : g_j < g_i, y_j > y_i}| and
    D_i = |{j : g_j > g_i, y_j < y_i}|.

    Under offsets p + g (range(p) + 2.5) a lower group's scores lie more
    than the margin below every score of a higher group, so a pair from
    two groups passes the c test (p_j < p_i + 1) exactly when j's group
    is lower and the d test (p_j > p_i - 1) exactly when it is higher,
    whatever p is. Counted from a (groups, levels) histogram; None when
    that table would pass CROSS_GROUP_TABLE entries."""
    yr = torch.unique(_f32(y), return_inverse=True)[1]
    gr = torch.unique(g, return_inverse=True)[1]
    n_r, n_g = int(yr.max()) + 1, int(gr.max()) + 1
    if n_r * n_g > CROSS_GROUP_TABLE:
        return None
    hist = torch.bincount(gr * n_r + yr, minlength=n_g * n_r).view(n_g, n_r)
    upto = torch.cumsum(hist, 0)
    lower = upto - hist                      # rows in groups below
    higher = upto[-1:] - upto                # rows in groups above
    above = torch.flip(torch.cumsum(torch.flip(lower, (1,)), 1), (1,))
    C = (above - lower)[gr, yr]              # lower groups, y above
    D = (torch.cumsum(higher, 1) - higher)[gr, yr]   # higher groups, y below
    return C.to(torch.int32), D.to(torch.int32)


def _grouped_rank_counter(y, g):
    """The grouped 'pallas' counter through the kernel: the rank-counts
    counter of y itself over the offset scores, less the cross-group
    pairs (`_cross_group_counts`). Its within-group comparisons are the
    tree route's on the same offset scores, so (c, d) are the same. None
    (take the offset-utility route) when y has more levels than the
    kernel counts or the cross-group table would be too large."""
    from ..kernels.rank_counts import ops as _rc_ops
    m = int(y.shape[0])
    if m == 0 or int(torch.unique(_f32(y)).numel()) > min(
            _rc_ops.DEFAULT_LEVELS, _rc_ops.MAX_RANKS):
        return None
    cross = _cross_group_counts(y, g)
    if cross is None:
        return None
    C, D = cross
    count = _rc_ops.rank_counter(_f32(y))

    def grouped(p):
        c, d = count(_offset_scores(_f32(p), g))
        return c - C, d - D

    return grouped


def counts_dispatch(p, y, g, engine: str = 'tree', block: int = 2048,
                    v=None):
    """(c, d), or (c~, d) with weights `v`, by `engine` in one call:
    `make_counter(y, g, engine, block, v)(p)`. g is None for ungrouped
    counting."""
    return make_counter(y, g, engine=engine, block=block, v=v)(p)
