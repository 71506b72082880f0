"""Wrappers around the rank-counting kernels (`csrc/rank_counts.cu`).

`rank_counter(y)` is the `counts_dispatch(engine='pallas')` engine. What
depends on y alone is done once, when the counter is built: the cast,
the compact y-rank compression, the level guard and the size of the
tables (one sort of y and one read-back of its rank count). Each call
`counter(p)` then sorts p (`torch.sort`, stable: the sorted scores and
their order) and makes one call of the kernels' launcher, which gathers
the sorted ranks, builds the tile table and counts c and d straight into
example order: no read-back and no allocation whose size depends on p's
values, so the call can be captured in a CUDA graph. CUDA tensors launch
the kernels, CPU tensors run the plain version (`ref.rank_counts_plain`)
on the same inputs. `rank_counts(p, y)` is the one-shot form.

The guard is the reference's exactness rule: an input with more distinct
utilities than `levels` (continuous targets, or grouped counting, whose
key offsets multiply the alphabet by the group count) is counted by the
merge-sort tree instead, as is one past the kernels' own capacity,
`MAX_RANKS`. The branch is taken on the host when the counter is built;
the launch count shows which way it went.
"""

from __future__ import annotations

import torch

from ...core.counts import _f32, _group_offsets, counts_fused
from .. import _build
from .ref import rank_bits, rank_counts_plain

# Launcher of the three CUDA kernels (gather, scan, count) of one call;
# `RANK_COUNTS.launches` counts its calls.
RANK_COUNTS = _build.Kernel(
    'rank_counts.cu', 'rank_counts_launch',
    [_build.PTR, _build.PTR, _build.PTR, _build.INT, _build.INT, _build.INT,
     _build.INT, _build.PTR, _build.PTR, _build.PTR, _build.PTR, _build.PTR,
     _build.PTR])

# The guard's capacity and the public default, as in the reference.
# Graded relevance has a handful of levels (the paper's data at most 5).
DEFAULT_LEVELS = 256
# The gather kernel keeps one rank histogram per warp (4 warps a block)
# in the 48 KB of a block's shared memory: 3072 int32 each.
MAX_RANKS = 3072
# Sorted queries a block of the count kernel holds (one a thread).
TI = 512


def pick_tj(n_ranks: int) -> int:
    """Candidate tile for an alphabet of n_ranks: 32 positions (one word
    of bit planes) up to 64 ranks, doubled until the table, n_ranks
    int32 per tile, takes at most 8 bytes per position, half the 16 m
    bytes of the function's own inputs and outputs."""
    words = 1
    while 64 * words < n_ranks:
        words *= 2
    return 32 * words


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


def _check_tiles(m: int, ti: int, tj: int) -> None:
    if not (32 <= ti <= 1024 and ti % 32 == 0):
        raise ValueError(f'ti = {ti}: one thread per query needs a block '
                         'of 32 to 1024 threads, a multiple of 32')
    if tj < 32 or tj % 32:
        raise ValueError(f'tj = {tj}: a candidate tile is a whole number '
                         'of 32-position words')
    if m + tj >= 2 ** 31:
        raise ValueError(f'm = {m} exceeds the int32 range of the kernels')


def _launch(ps, order, ranks, n_ranks: int, ti: int, tj: int):
    m = ps.shape[0]
    for name, t, dt in (('ps', ps, torch.float32),
                        ('order', order, torch.int64),
                        ('ranks', ranks, torch.int32)):
        if (t.device != ps.device or t.dtype != dt or not t.is_contiguous()
                or t.shape != (m,)):
            raise ValueError(f'{name} must be a contiguous ({m},) {dt} '
                             f'tensor on {ps.device}')
    if not 1 <= n_ranks <= MAX_RANKS:
        raise ValueError(f'n_ranks = {n_ranks} is outside 1 .. {MAX_RANKS}')
    _check_tiles(m, ti, tj)
    dev = ps.device
    yr = torch.empty((m,), dtype=torch.int32, device=dev)
    planes = torch.empty((-(-m // 32), rank_bits(n_ranks)),
                         dtype=torch.int32, device=dev)
    table = torch.empty((n_ranks, -(-m // tj) + 1), dtype=torch.int32,
                        device=dev)
    # (L, R) of each count block's first query, and of the last query
    edges = torch.empty((-(-m // ti) + 1, 2), dtype=torch.int32, device=dev)
    cd = torch.empty((m, 2), dtype=torch.int32, device=dev)
    if m:
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            RANK_COUNTS(ps.data_ptr(), order.data_ptr(), ranks.data_ptr(), m,
                        n_ranks, ti, tj, yr.data_ptr(), planes.data_ptr(),
                        table.data_ptr(), edges.data_ptr(), cd.data_ptr(),
                        stream)
    return cd[:, 0], cd[:, 1], (yr, planes, table)


def counts_from_sort(ps, order, ranks, n_ranks: int, ti: int = TI,
                     tj: int | None = None):
    """(c, d, (yr, planes, table)) from the stable sort of p (values ps
    and indices order) and the compact ranks in example order: the
    kernels for CUDA tensors, the plain version for CPU tensors. c and d
    are int32 in example order, the two columns of one (m, 2) tensor (the
    count kernel stores a query's pair at once); the rest is what the
    gather and scan kernels wrote (`ref.prepare_plain` says what)."""
    tj = pick_tj(n_ranks) if tj is None else tj
    if ps.is_cuda:
        return _launch(ps, order, ranks, n_ranks, ti, tj)
    if ps.device.type != 'cpu':
        raise ValueError(f'unsupported device {ps.device}')
    _check_tiles(ps.shape[0], ti, tj)
    return rank_counts_plain(ps, order, ranks, n_ranks, tj)


def rank_counter(y: torch.Tensor, ti: int = TI, tj: int | None = None,
                 levels: int = DEFAULT_LEVELS):
    """`p -> (c, d)` for the fixed utilities y, bit-identical to
    `ref.counts_ref(p, y)`.

    y is cast to float32 as in the reference, ranked and checked against
    `levels` here, once; an oracle builds its counter when it is made,
    so a fit pays that sort and read-back once, not per iteration. With
    more than min(levels, MAX_RANKS) distinct utilities the counter is
    the tree (`core.counts.counts_fused`), so exactness never depends on
    the kernels' capacity. tj, the candidate tile, defaults to
    `pick_tj` of the alphabet."""
    if y.dim() != 1:
        raise ValueError(f'y must be 1-D; got shape {tuple(y.shape)}')
    y = _f32(y).contiguous()
    m = y.shape[0]
    ranks = _compact_ranks(y) if m else None
    n_ranks = int(ranks.max()) + 1 if m else 0
    guarded = n_ranks > min(levels, MAX_RANKS)
    if guarded:
        ranks = None        # the tree counts; hold no O(m) ranks for it
    tj = pick_tj(n_ranks) if tj is None else tj
    _check_tiles(m, ti, tj)

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
        ps, order = torch.sort(p, stable=True)
        c, d, _ = counts_from_sort(ps, order, ranks, n_ranks, ti, tj)
        return c, d

    return count


def rank_counts(p: torch.Tensor, y: torch.Tensor, ti: int = TI,
                tj: int | None = None, levels: int = DEFAULT_LEVELS):
    """Fused (c, d) counts as int32 in one call: `rank_counter(y)(p)`."""
    if p.shape != y.shape or p.dim() != 1:
        raise ValueError(f'p and y must be 1-D of one length; got '
                         f'{tuple(p.shape)} and {tuple(y.shape)}')
    return rank_counter(y, ti=ti, tj=tj, levels=levels)(p)


def rank_counts_grouped(p, y, g, ti: int = TI, tj: int | None = None,
                        levels: int = DEFAULT_LEVELS):
    """Grouped (c, d) through the key-offset trick over `rank_counts`.

    The offsets give each group its own band of ranks, so the alphabet is
    about n_groups times the per-group one; past `levels` the guard sends
    the input to the tree."""
    pg, yg = _group_offsets(_f32(p), _f32(y), g)
    return rank_counts(pg, yg, ti=ti, tj=tj, levels=levels)
