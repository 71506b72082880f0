"""Wrappers around the rank-counting kernel (`csrc/rank_counts.cu`).

`rank_counter(y)` is the `counts_dispatch(engine='pallas')` engine. What
depends on y alone is done once, when the counter is built: the cast,
the compact y-rank compression and the level guard (one sort of y and
one read-back). Each call `counter(p)` then does only the p-dependent
preparation, with no read-back: the sort by score, the per-tile rank
histogram and its sums over levels, and the four searchsorteds that
bound each query tile's partial bands. CUDA tensors launch the kernel,
CPU tensors run the plain version (`ref.rank_counts_plain`) on the same
prepared inputs. `rank_counts(p, y)` is the one-shot form.

The guard is the reference's exactness rule: the histogram has
`levels` columns, so an input with more distinct utilities than that
(continuous targets, or grouped counting, whose key offsets multiply the
alphabet by the group count) is counted by the merge-sort tree instead.
The branch is taken on the host when the counter is built; the kernel's
launch count shows which way it went.
"""

from __future__ import annotations

import torch

from ...core.counts import _f32, _group_offsets, counts_fused
from .. import _build
from .ref import rank_counts_plain

# Launcher of the CUDA kernel; `RANK_COUNTS.launches` counts its launches.
RANK_COUNTS = _build.Kernel(
    'rank_counts.cu', 'rank_counts_launch',
    [_build.PTR, _build.PTR, _build.PTR, _build.PTR, _build.PTR,
     _build.INT, _build.INT, _build.INT, _build.INT, _build.PTR,
     _build.PTR, _build.PTR])

# Capacity of the rank histogram. Graded relevance has a handful of
# levels (the paper's data at most 5), so 256 covers real inputs. The
# value is the JAX package's TPU choice and has not been sized on the
# H100 yet.
DEFAULT_LEVELS = 256
# Query tile (one thread block, one thread per query) and candidate tile
# (histogram granularity), in elements.
TI = 256
TJ = 256


def _compact_ranks(y: torch.Tensor) -> torch.Tensor:
    """Dense 0-based ranks of y, ties sharing a rank, as int32.

    Order-isomorphic to y, so every preference comparison on ranks is
    exact whatever y's dtype or spacing."""
    ys = torch.sort(y).values
    new = torch.ones_like(ys, dtype=torch.int64)
    new[1:] = (ys[1:] != ys[:-1]).to(torch.int64)
    rank_of_sorted = torch.cumsum(new, 0) - 1
    first = torch.searchsorted(ys, y, right=False)
    return rank_of_sorted[first].to(torch.int32)


def _ceil_div(a: torch.Tensor, b: int) -> torch.Tensor:
    return -((-a) // b)


def _prepare(p, ranks, ti: int, tj: int, levels: int):
    """Sorted scores and ranks, the per-query-tile bands and the two
    histogram tables (see the kernel source for their meaning)."""
    m = p.shape[0]
    dev = p.device
    order = torch.argsort(p, stable=True)
    ps = p[order].contiguous()
    yr = ranks[order].contiguous()
    n_i = -(-m // ti)
    n_j = -(-m // tj)

    # Rank histogram per candidate tile, cumulated over tiles: row t of
    # `pref` counts each rank among tiles [0, t).
    key = (torch.arange(m, device=dev) // tj) * levels + yr.long()
    hist = torch.zeros((n_j * levels,), dtype=torch.int64, device=dev)
    hist.index_add_(0, key, torch.ones_like(key))
    pref = torch.zeros((n_j + 1, levels), dtype=torch.int64, device=dev)
    pref[1:] = torch.cumsum(hist.view(n_j, levels), 0)
    incl = torch.cumsum(pref, 1)
    gt = (incl[:, -1:] - incl).to(torch.int32).contiguous()   # ranks > r
    lt = (incl - pref).to(torch.int32).contiguous()           # ranks < r

    # Bands from each query tile's first and last query (monotone f32
    # rounding keeps every query's frontier between theirs).
    starts = torch.arange(n_i, device=dev) * ti
    ends = torch.clamp(starts + ti, max=m) - 1
    q0, q1 = ps[starts], ps[ends]
    l_min = torch.searchsorted(ps, q0 + 1.0, right=False)
    l_max = torch.searchsorted(ps, q1 + 1.0, right=False)
    r_min = torch.searchsorted(ps, q0 - 1.0, right=True)
    r_max = torch.searchsorted(ps, q1 - 1.0, right=True)
    band = torch.stack([l_min // tj, _ceil_div(l_max, tj),
                        r_min // tj, _ceil_div(r_max, tj)],
                       dim=1).to(torch.int32).contiguous()
    return order, band, ps, yr, gt, lt


def _launch(band, ps, yr, gt, lt, ti: int, tj: int):
    m = ps.shape[0]
    if not (32 <= ti <= 1024 and ti % 32 == 0):
        raise ValueError(f'ti = {ti}: one thread per query needs a block '
                         'of 32 to 1024 threads, a multiple of 32')
    if not 1 <= tj <= 6144:
        raise ValueError(f'tj = {tj} does not fit the 48 KB of static '
                         'shared memory (8 bytes per candidate)')
    for name, t, dt in (('band', band, torch.int32), ('ps', ps, torch.float32),
                        ('yr', yr, torch.int32), ('gt', gt, torch.int32),
                        ('lt', lt, torch.int32)):
        if t.device != ps.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f'{name} must be a contiguous {dt} tensor on '
                             f'{ps.device}')
    c = torch.empty((m,), dtype=torch.int32, device=ps.device)
    d = torch.empty((m,), dtype=torch.int32, device=ps.device)
    if m:
        stream = torch.cuda.current_stream(ps.device).cuda_stream
        with torch.cuda.device(ps.device):
            RANK_COUNTS(band.data_ptr(), ps.data_ptr(), yr.data_ptr(),
                        gt.data_ptr(), lt.data_ptr(), m, ti, tj,
                        gt.shape[1], c.data_ptr(), d.data_ptr(), stream)
    return c, d


def sorted_counts(band, ps, yr, gt, lt, ti: int = TI, tj: int = TJ):
    """(c, d) in sorted order from prepared inputs: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if ps.is_cuda:
        return _launch(band, ps, yr, gt, lt, ti, tj)
    if ps.device.type != 'cpu':
        raise ValueError(f'unsupported device {ps.device}')
    return rank_counts_plain(band, ps, yr, gt, lt, ti, tj)


def rank_counter(y: torch.Tensor, ti: int = TI, tj: int = TJ,
                 levels: int = DEFAULT_LEVELS):
    """`p -> (c, d)` for the fixed utilities y, bit-identical to
    `ref.counts_ref(p, y)`.

    y is cast to float32 as in the reference, ranked and checked against
    `levels` here, once; an oracle builds its counter when it is made,
    so a fit pays that sort and read-back once, not per iteration. With
    more than `levels` distinct utilities the counter is the tree
    (`core.counts.counts_fused`), so exactness never depends on the
    histogram's capacity."""
    if y.dim() != 1:
        raise ValueError(f'y must be 1-D; got shape {tuple(y.shape)}')
    y = _f32(y).contiguous()
    m = y.shape[0]
    ranks = _compact_ranks(y) if m else None
    guarded = m > 0 and int(ranks.max()) + 1 > levels

    def count(p: torch.Tensor):
        if p.shape != y.shape:
            raise ValueError(f'p and y must be 1-D of one length; got '
                             f'{tuple(p.shape)} and {tuple(y.shape)}')
        p = _f32(p).contiguous()
        if m == 0:
            z = torch.zeros((0,), dtype=torch.int32, device=p.device)
            return z, z.clone()
        if guarded:
            return counts_fused(p, y)
        order, band, ps, yr, gt, lt = _prepare(p, ranks, ti, tj, levels)
        c_s, d_s = sorted_counts(band, ps, yr, gt, lt, ti, tj)
        c = torch.empty_like(c_s)
        d = torch.empty_like(d_s)
        c[order] = c_s
        d[order] = d_s
        return c, d

    return count


def rank_counts(p: torch.Tensor, y: torch.Tensor, ti: int = TI,
                tj: int = TJ, levels: int = DEFAULT_LEVELS):
    """Fused (c, d) counts as int32 in one call: `rank_counter(y)(p)`."""
    if p.shape != y.shape or p.dim() != 1:
        raise ValueError(f'p and y must be 1-D of one length; got '
                         f'{tuple(p.shape)} and {tuple(y.shape)}')
    return rank_counter(y, ti=ti, tj=tj, levels=levels)(p)


def rank_counts_grouped(p, y, g, ti: int = TI, tj: int = TJ,
                        levels: int = DEFAULT_LEVELS):
    """Grouped (c, d) through the key-offset trick over `rank_counts`.

    The offsets give each group its own band of ranks, so the alphabet is
    about n_groups times the per-group one; past `levels` the guard sends
    the input to the tree."""
    pg, yg = _group_offsets(_f32(p), _f32(y), g)
    return rank_counts(pg, yg, ti=ti, tj=tj, levels=levels)
