"""The sharded RankSVM oracle: the paper's Algorithm 3 over a mesh of ranks.

The counterpart of `repro.core.distributed` on torch.distributed
(DESIGN.md §5). The heavy object is X (m x n) and its two products; the
score vectors are small (4 MB at m = 2^20). One rank's block
(`RankBlock`, made by `rank_block`):

  * X: rows split over the row group (pod x data), columns over 'model';
  * y and g: split over the rows;
  * w and a: split over 'model'.

One call (`make_oracle_body`, its counter made once by
`make_rank_counter`):

  * p = X w: each rank multiplies its block by its slice of w, and the
    partial scores are summed over 'model', leaving the rank's rows;
  * the scores are all-gathered over the row group, the group offsets
    folded in (`counts._offset_scores`), and the counting engine runs on
    the gathered keys. Under variant='opt' with the tree engine each rank
    answers only its own rows' rank queries against the whole tree, which
    it builds from the gathered scores (`counts._half_counts(rows=)`):
    O((m / ranks) log^2 m) query work a rank, the paper's bound split.
    variant='base', and every other engine, counts every query on every
    rank and keeps the rank's rows; the two variants give the same counts;
  * the loss: each rank's rows' Lemma 1 sum, summed over the row group;
  * a = X^T (c - d) / N: each rank's columns from its rows, summed over
    the row group, then all-gathered over 'model', so that every rank
    holds all of a (the bundle state is replicated, `core.bmrm`).

Sparse features stay sparse (DESIGN.md §9): `make_csr_oracle_body` runs
the same core over a padded CSR slot layout (`csr_slot_arrays`, rows split
over the row group and whole on each 'model' rank), at O(nnz) a product.
Streamed features (`assemble_row_sharded`) are read by each rank from its
own row range and put on its device as the dense body's block.

Differences from the reference, all of layout:

  * y and g never change, so every rank holds them whole, and the counter
    is made once from them (`counts.make_counter`; the rank-counts and
    pairwise kernels' rank compression and level guard run once a fit).
    The bodies close over it: `(X, w, n_pairs) -> (loss, a)`.
  * a comes back whole on every rank; the reference leaves it
    column-sharded, as its bundle state's plane buffer is.

Precision follows the reference's casts: X in bf16 (round to nearest
even), w cast to bf16 for the score product, products of bf16 values with
a float output (a bf16 `torch.matmul` would return bf16 and round every
score to 8 bits, moving the counts), (c - d) / N cast to bf16 for the
dense transpose, float32 products for the CSR one. The products run in
float64 on bf16 values upcast one row chunk at a time: a product of two
bf16 values is exact there, and so is a sum of the 136 of a row unless
their exponents span more than 37 bits. Every sum that a split over ranks
would reorder is taken in float64 and rounded to float32 once: the
scores over the columns, the loss, and the dense transpose over the rows;
the CSR transpose sums in exact fixed point (`oracle._ExactSum`). So the
results do not depend on the mesh: a 4-rank run counts bit-equal to a
1-rank run. The reference accumulates in float32; on inputs whose sums
are exact in float32 (the tests' quantized data) both give the same bits.

`input_specs` and `sharded_dryrun_cell` serve the dry-run only and are
not ported (ROADMAP.md Queue 1 item 13(c)).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data import rowblocks as _rowblocks
from ..launch.mesh import ROWS
from . import counts as _counts

f32 = torch.float32
f64 = torch.float64
bf16 = torch.bfloat16

# The mesh bodies implement only the uniform pairwise hinge: the split
# counting path has no weighted-prefix or running-max form, and computing
# another objective quietly at scale is the worst failure. ShardedOracle
# and make_oracle both call `validate_sharded_loss` before any transfer.
SHARDED_LOSSES = ('hinge',)
VARIANTS = ('base', 'opt')
# Elements of X upcast to float64 at a time by the dense products (128 MB).
CHUNK_ELEMS = 1 << 24


def validate_sharded_loss(loss: str) -> None:
    """Reject losses the sharded mesh bodies do not implement, up front."""
    if loss not in SHARDED_LOSSES:
        raise ValueError(
            f'the sharded mesh oracle supports only loss in '
            f'{SHARDED_LOSSES}, got {loss!r}; train this loss with '
            "method='tree'/'pairs'/'auto'/'stream' instead (the fused and "
            'streaming oracles implement every loss in oracle.LOSSES)')


@dataclasses.dataclass(frozen=True)
class RankSVMShapeConfig:
    name: str
    m: int                      # training examples (rows)
    n: int                      # features (columns)
    kind: str = 'oracle'


@dataclasses.dataclass(frozen=True)
class RankBlock:
    """One rank's block of the sharded layout: X[rows[0]:rows[1],
    cols[0]:cols[1]] of the row-padded (m, n) problem; y and g are split
    by `rows`, w and a by `cols`."""

    m: int                      # rows after padding to the row group
    n: int
    rows: tuple
    cols: tuple


def rank_block(mesh, m: int, n: int) -> RankBlock:
    """This rank's block of an (m, n) problem on `mesh`; m must be a
    multiple of the row group's size and n of the 'model' axis's."""
    R, K = mesh.size(ROWS), mesh.size('model')
    if m % R or n % K:
        raise ValueError(f'({m}, {n}) does not split over {R} row blocks '
                         f'and {K} column blocks')
    i, k = mesh.index(ROWS), mesh.index('model')
    mr, nr = m // R, n // K
    return RankBlock(m, n, (i * mr, (i + 1) * mr), (k * nr, (k + 1) * nr))


def _scores(X, w):
    """X w for the bf16 block X (rows, cols) and w (cols,) or W (L, cols):
    float64 products of the bf16 values, one row chunk upcast at a time."""
    wb = w.to(bf16).to(f64)
    rows = X.shape[0]
    out = torch.empty(wb.shape[:-1] + (rows,), dtype=f64, device=X.device)
    step = max(1, CHUNK_ELEMS // max(X.shape[1], 1))
    for r0 in range(0, rows, step):
        blk = X[r0:r0 + step].to(f64)
        out[..., r0:r0 + step] = blk @ wb if wb.dim() == 1 else wb @ blk.T
    return out


def _transpose(X, v):
    """X^T v in float64 for the bf16 block X and bf16 coefficients v
    (rows,) or V (L, rows)."""
    vb = v.to(f64)
    out = torch.zeros(vb.shape[:-1] + (X.shape[1],), dtype=f64,
                      device=X.device)
    step = max(1, CHUNK_ELEMS // max(X.shape[1], 1))
    for r0 in range(0, X.shape[0], step):
        blk = X[r0:r0 + step].to(f64)
        out += (blk.T @ vb[r0:r0 + step] if vb.dim() == 1
                else vb[:, r0:r0 + step] @ blk)
    return out


def make_rank_counter(block: RankBlock, y, g, variant: str = 'base',
                      engine: str = 'tree'):
    """`p -> (c, d)` of the rank's rows, for the scores p (m,) of every
    row (gathered over the row group), or a batch (L, m), one row per
    lambda of a path. y and g (or None) are the whole, row-padded
    utilities and group ids on the rank's device; what depends on them
    alone is made here, once.

    Under variant='opt' with the tree engine each rank answers only its
    own rows' queries against the whole tree (`counts._half_counts(rows=)`,
    on the group-offset keys); variant='base', and every other engine,
    counts every query with `counts.make_counter` and keeps the rank's
    rows. The counts are exact either way, so the variants agree bit for
    bit, and with the reference's."""
    _counts._validate_engine(engine)
    if variant not in VARIANTS:
        raise ValueError(f'unknown variant {variant!r}; expected one of '
                         f'{VARIANTS}')
    rows = block.rows
    if variant == 'opt' and engine == 'tree':
        yk = _counts._f32(y) if g is None else _counts._offset_utilities(y,
                                                                           g)

        def one(pk):
            return (_counts._half_counts(pk, yk, rows),
                    _counts._half_counts(-pk, -yk, rows))

        def count(p):
            pk = p if g is None else _counts._offset_scores(p, g)
            return _counts.by_row(one, pk)

        return count
    full = _counts.make_counter(y, g, engine=engine)

    def count(p):
        c, d = full(p)
        return c[..., rows[0]:rows[1]], d[..., rows[0]:rows[1]]

    return count


def _scores_to_coeffs(mesh, count):
    """The layout-independent middle of every sharded body: the rank's
    scores -> (loss, the rank's rows of c - d). Gathers the scores over
    the row group, counts (`make_rank_counter`) and sums the Lemma 1 loss
    over the row group, so every rank gets the same loss. Scores (L, rows)
    give (L,) losses and (L, rows) coefficients."""

    def core(p, n_pairs):
        c, d = count(mesh.all_gather(p, ROWS, dim=-1))
        cd = (c - d).to(f32)
        del d
        part = (cd * p + c.to(f32)).sum(dim=-1, dtype=f64)
        return mesh.sum(part, ROWS).to(f32) / n_pairs, cd

    return core


def dense_scores(mesh, block: RankBlock, X, w):
    """The rank's rows of X w (float32), for its bf16 block X and the
    whole w (n,) or W (L, n): its columns' partial scores summed over
    'model'."""
    c0, c1 = block.cols
    return mesh.sum(_scores(X, w[..., c0:c1]), 'model').to(f32)


def dense_transpose(mesh, X, v):
    """All of a = X^T v (float32) on every rank, for the rank's bf16 block
    X and its rows' coefficients v (rows,) or V (L, rows), cast to bf16
    as the reference casts (c - d) / N: its columns' partial sums added
    over the row group, then all-gathered over 'model'."""
    a = mesh.sum(_transpose(X, v.to(bf16)), ROWS).to(f32)
    return mesh.all_gather(a, 'model', dim=-1)


def make_oracle_body(mesh, block: RankBlock, count):
    """`(X, w, n_pairs) -> (loss, a)`: the paper's Algorithm 3 split over
    `mesh`, for the rank's bf16 block X of `block`, the whole w (n,) or a
    batch W (L, n), and the float32 pair count N; `count` is the rank's
    counter (`make_rank_counter`: any engine, 'pallas' and 'auto' launch
    the rank-counts and pairwise kernels on the card). The products are
    `dense_scores` and `dense_transpose`."""
    core = _scores_to_coeffs(mesh, count)

    def oracle(X, w, n_pairs):
        loss, cd = core(dense_scores(mesh, block, X, w), n_pairs)
        return loss, dense_transpose(mesh, X, cd / n_pairs)

    return oracle


def _csr_chunks(data2):
    from .oracle import CSR_CHUNK_NNZ
    step = max(1, CSR_CHUNK_NNZ // max(data2.shape[1], 1))
    return [(r0, r0 + step) for r0 in range(0, data2.shape[0], step)]


def csr_scores(data2, slot, w, n: int):
    """The rank's rows of X w (float32) in the CSR slot layout: w cast to
    bf16 and gathered per slot, each row summed in float64. The rows are
    whole on each 'model' rank, so no sum over 'model' is needed."""
    if w.dim() == 2:
        return torch.stack([csr_scores(data2, slot, row, n) for row in w])
    wb = w.to(bf16).to(f64)
    out = torch.empty(data2.shape[0], dtype=f64, device=w.device)
    for r0, r1 in _csr_chunks(data2):
        out[r0:r1] = (data2[r0:r1].to(f64) * wb[slot[r0:r1] % n]).sum(dim=1)
    return out.to(f32)


def csr_transpose(mesh, data2, slot, v, bound, replicas: int):
    """All of a = X^T v (float32) on every rank in the CSR slot layout,
    for the rank's rows' coefficients v (rows,) or V (L, rows): float32
    products, as the reference's `data2.astype(f32) * cd/N`, summed per
    column in exact fixed point (`oracle._ExactSum` with the (n,) float64
    `bound` of the sums of |values| and `replicas` accumulator copies).
    The ranks' fixed-point sums add exactly over the row group, so a is
    bit-equal on any mesh and reproducible on the card, where a float
    scatter-add is not."""
    from .oracle import _ExactSum
    if v.dim() == 2:
        return torch.stack([csr_transpose(mesh, data2, slot, row, bound,
                                          replicas) for row in v])
    acc = _ExactSum(bound, replicas)
    for r0, r1 in _csr_chunks(data2):
        acc.add((data2[r0:r1].to(f32) * v[r0:r1, None]).view(-1),
                slot[r0:r1].reshape(-1))
    return acc.result(mesh.sum(acc.sums(), ROWS))


def make_csr_oracle_body(mesh, block: RankBlock, count, bound,
                         replicas: int):
    """`(data2, slot, w, n_pairs) -> (loss, a)`: the sharded oracle on CSR
    features at O(nnz) a product, no densification.

    `data2` (rows, s) bf16 holds the rank's rows' values and `slot`
    (rows, s) int32 their columns plus (row % replicas) * n, the
    accumulator slot of the transpose (as `oracle._CSRFeatures` lays its
    slots out); pad slots carry (0, the row's replica base) and add 0 to
    both products. `bound` (n,) float64 bounds each column's sum of
    |data| |c - d| / N over every row. The products are `csr_scores` and
    `csr_transpose`."""
    core = _scores_to_coeffs(mesh, count)
    n = block.n

    def oracle(data2, slot, w, n_pairs):
        loss, cd = core(csr_scores(data2, slot, w, n), n_pairs)
        return loss, csr_transpose(mesh, data2, slot, cd / n_pairs, bound,
                                   replicas)

    return oracle


def make_oracle_step(mesh, block: RankBlock, y, variant: str = 'base'):
    """The ungrouped tree-engine `(X, w, n_pairs)` body for utilities y:
    the counterpart of the reference's 4-argument step."""
    return make_oracle_body(mesh, block, make_rank_counter(
        block, y, None, variant=variant))


def csr_slot_arrays(data, indices, indptr, shape, *, pad_rows: int = 0):
    """Host-side packing of CSR (data, indices, indptr) into the padded
    per-row slot arrays of `make_csr_oracle_body`.

    Returns `(data2, idx2)`: (m + pad_rows, s) float32/int32 with
    s = max(1, max nnz/row); pad slots and the `pad_rows` trailing
    zero-feature rows (the row-group padding) carry (0.0, 0). The caller
    casts data2 to bf16 on its way to the device."""
    m, _ = map(int, shape)
    data = np.asarray(data, np.float32)
    indices = np.asarray(indices, np.int64)
    indptr = np.asarray(indptr, np.int64)
    lens = np.diff(indptr)
    s = max(1, int(lens.max())) if m else 1
    data2 = np.zeros((m + pad_rows, s), np.float32)
    idx2 = np.zeros((m + pad_rows, s), np.int32)
    if m and data.size:
        rows = np.repeat(np.arange(m, dtype=np.int64), lens)
        slots = np.arange(data.size, dtype=np.int64) - np.repeat(
            indptr[:-1], lens)
        data2[rows, slots] = data
        idx2[rows, slots] = indices
    return data2, idx2


def assemble_row_sharded(source, block: RankBlock, device, *,
                         block_rows: int, prefetch=0):
    """The rank's bf16 block of a `RowBlockSource`, read from the rank's
    own row range only: the streamed input path of `ShardedOracle`
    (DESIGN.md §9).

    The rows are read `block_rows` at a time, `prefetch` blocks ahead on a
    `data.rowblocks._ReadAhead` thread; each block's column slice is cast
    to bf16 (round to nearest even, as the reference's cast) and written
    into the block on `device`, so the host holds only the blocks in
    flight, never X. Rows at or past `source.m` (the row-group padding)
    stay zero, as the dense path's pad rows."""
    r0, r1 = block.rows
    c0, c1 = block.cols
    block_rows = _rowblocks._validate_block_rows(block_rows)
    depth = _rowblocks.resolve_prefetch(source, prefetch)
    out = torch.zeros((r1 - r0, c1 - c0), dtype=bf16, device=device)
    hi_real = min(r1, source.m)
    spans = [(lo, min(lo + block_rows, hi_real))
             for lo in range(r0, hi_real, block_rows)]
    ra = (_rowblocks._ReadAhead(lambda i: source.block(*spans[i]),
                                len(spans), depth)
          if depth and len(spans) > 1 else None)
    try:
        for i, (lo, hi) in enumerate(spans):
            blk = ra.get(i) if ra is not None else source.block(lo, hi)
            cols = np.ascontiguousarray(np.asarray(blk)[:, c0:c1],
                                        np.float32)
            out[lo - r0:hi - r0] = torch.from_numpy(cols).to(device).to(bf16)
    finally:
        if ra is not None:
            ra.close()
    return out


# The paper's Reuters shape at twice its largest run, Reuters-like width.
REUTERS_1M = RankSVMShapeConfig('reuters_1m', m=1 << 20, n=49152)
