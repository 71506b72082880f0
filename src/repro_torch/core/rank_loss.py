"""Pairwise ranking error and the differentiable pairwise hinge at
linearithmic cost.

The counterpart of `repro.core.rank_loss`: `ranking_error` (the paper's
eq. 1), the metrics of the other two losses (`top1_error` for 'toppush',
`position_weighted_error` and its weights `poshinge_weights` for
'poshinge'), `_compact_ids`, and `pairwise_hinge_loss`, eq. (4) by
Lemma 1 with Lemma 2's subgradient as its gradient (a
`torch.autograd.Function`, the counterpart of the reference's
`jax.custom_vjp`):

    forward :  loss = (1/N) sum_i ((c_i - d_i) p_i + c_i)
    backward:  d loss / d p_i = (c_i - d_i) / N

so a neural scorer (the RWKV-6 score head of `objective='rank_hinge'`)
trains against the exact RankSVM objective over the whole batch in
O(m log^2 m). `loss_and_subgradient` returns both without autograd.
"""

from __future__ import annotations

import torch

from . import counts as _counts


def _compact_ids(g: torch.Tensor) -> torch.Tensor:
    """Relabel group ids onto [0, n_groups) as int32.

    The key-offset tricks scale their float32 keys with the id VALUES, so
    hashed or sparse ids would push one ulp of the keys past the hinge
    margin; after this only the number of groups matters."""
    return torch.unique(g, return_inverse=True)[1].reshape(g.shape).to(
        torch.int32)


def ranking_error(scores: torch.Tensor, utilities: torch.Tensor,
                  group_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Pairwise ranking error, eq. (1): the fraction of swapped pairs.

    Pairs with y_i < y_j count as errors when f(x_i) > f(x_j); ties in
    the predicted scores count as half an error."""
    p = scores.to(torch.float32)
    y = utilities.to(torch.float32)
    if group_ids is not None:
        group_ids = _compact_ids(group_ids)
        p, y = _counts._group_offsets(p, y, group_ids)
        n = torch.clamp(_counts.num_pairs_grouped(utilities, group_ids),
                        min=1.0)
    else:
        n = torch.clamp(_counts.num_pairs(utilities), min=1.0)
    # A swap for a pair y_i < y_j is p_j < p_i: sweep sorted p with the
    # strictly-smaller set as the frontier.
    order = torch.argsort(p, stable=True)
    ps = p[order]
    ys = y[order]
    lt = torch.searchsorted(ps, ps, right=False)     # p_k <  p_i
    le = torch.searchsorted(ps, ps, right=True)      # p_k <= p_i
    swaps_lt = _counts._prefix_count_greater(ys, lt, ys)
    swaps = swaps_lt.to(torch.float32)
    # Ties in p: pairs with p_k == p_i and y_k > y_i are half an error.
    ties_gt = (_counts._prefix_count_greater(ys, le, ys)
               - swaps_lt).to(torch.float32)
    total = swaps.sum() + 0.5 * ties_gt.sum()
    return total / n


def poshinge_weights(utilities, group_ids=None):
    """(v, W): the position-decay pair weights of the 'poshinge' loss, as
    float64 numpy and a float.

    v_i = 1 / log2(1 + rank_i), rank_i = |{k in group : y_k > y_i}| + 1,
    the decay of example i's UTILITY rank (static in w, which keeps the
    loss convex); W = the sum over preference pairs (i, j), y_i < y_j, of
    the higher side's weight v_j, the normalizer that replaces N. Exact on
    the host, O(m log m); `_utility_rank_weights` is its twin on the
    device."""
    from .oracle import _as_numpy, _poshinge_weights_norm
    return _poshinge_weights_norm(
        _as_numpy(utilities, None),
        None if group_ids is None else _as_numpy(group_ids, None))


def _group_vector(group_ids, m, device):
    if group_ids is None:
        return torch.zeros((m,), dtype=torch.int64, device=device)
    return _compact_ids(group_ids).to(torch.int64)


def top1_error(scores: torch.Tensor, utilities: torch.Tensor,
               group_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Top-1 error: the fraction of groups whose best-scoring example is
    not a maximum-utility one, the metric 'toppush' trains a surrogate
    of. A group with tied top scores counts the fraction of its top
    scorers below the group's best utility. Groups weigh alike;
    `group_ids=None` is one group."""
    p = scores.to(torch.float32)
    y = utilities.to(torch.float32)
    m = p.shape[0]
    g = _group_vector(group_ids, m, p.device)
    ninf = torch.full((m,), float('-inf'), device=p.device)
    pmax = ninf.scatter_reduce(0, g, p, 'amax')
    ymax = ninf.scatter_reduce(0, g, y, 'amax')
    top = p == pmax[g]
    bad = top & (y < ymax[g])
    zeros = torch.zeros((m,), dtype=torch.float32, device=p.device)
    n_top = zeros.index_add(0, g, top.to(torch.float32))
    n_bad = zeros.index_add(0, g, bad.to(torch.float32))
    size = zeros.index_add(0, g, torch.ones_like(p))
    err = torch.where(size > 0, n_bad / n_top.clamp(min=1.0), 0.0)
    return err.sum() / (size > 0).sum().to(torch.float32).clamp(min=1.0)


def _run_bounds(keys):
    """For sorted rows of `keys` (tensors of one length, compared
    lexicographically): per position, the index of the first and one past
    the last element of its run of equal keys."""
    m = keys[0].shape[0]
    dev = keys[0].device
    idx = torch.arange(m, device=dev)
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    change = torch.zeros((m - 1,), dtype=torch.bool, device=dev)
    for k in keys:
        change |= k[1:] != k[:-1]
    first = torch.cat([one, change])
    last = torch.cat([change, one])
    start = torch.cummax(torch.where(first, idx, -1), 0).values
    end = 1 + torch.cummin(torch.where(last, idx, m).flip(0), 0).values.flip(0)
    return start, end


def _utility_rank_weights(y, g):
    """(v, lower) on the device: each example's 1/log2(1 + utility rank)
    weight and its count of strictly lower utilities in its group, from
    one stable (g, y) sort and running maxima and minima over the
    change points (`torch.cummax`, and `cummin` on the flipped order).
    The twin of `poshinge_weights`."""
    m = y.shape[0]
    if m == 0:
        return torch.zeros_like(y), torch.zeros_like(y)
    order = _counts.lexsort(y, g)
    gs, ys = g[order], y[order]
    seg_start, seg_end = _run_bounds([gs])
    run_start, run_end = _run_bounds([gs, ys])
    rank = (seg_end - run_end + 1).to(torch.float32)
    vs = 1.0 / torch.log2(1.0 + rank)
    lower = (run_start - seg_start).to(torch.float32)
    v = torch.empty_like(vs)
    v[order] = vs
    low = torch.empty_like(lower)
    low[order] = lower
    return v, low


def position_weighted_error(scores: torch.Tensor, utilities: torch.Tensor,
                            group_ids: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Position-weighted pairwise ranking error, the metric of the
    'poshinge' loss: each swapped preference pair (y_i < y_j, p_i > p_j)
    costs the higher side's weight v_j (`poshinge_weights`), a score tie
    half of it, over the total pair weight W; 0 when there is no pair.
    Equal to `ranking_error` when all weights are equal."""
    p = scores.to(torch.float32)
    y = utilities.to(torch.float32)
    g = _group_vector(group_ids, p.shape[0], p.device)
    v, lower = _utility_rank_weights(y, g)
    W = (v * lower).sum()
    if group_ids is not None:
        p, y = _counts._group_offsets(p, y, g)
    order = torch.argsort(p, stable=True)
    ps, ys, vs = p[order], y[order], v[order]
    lt = torch.searchsorted(ps, ps, right=False)      # p_k <  p_i
    le = torch.searchsorted(ps, ps, right=True)       # p_k <= p_i
    # the weight of {k : p_k < p_i, y_k > y_i}, and of the p-ties
    # [lt, le) at half cost (k = i adds nothing: y_i > y_i is false)
    wsw, wle = _counts._prefix_weighted_greater(ys, vs, [lt, le], ys)
    total = wsw.sum() + 0.5 * (wle - wsw).sum()
    return torch.where(W > 0, total / torch.where(W > 0, W, 1.0), 0.0)


def _loss_from_counts(p, c, d, n):
    cf, df = c.to(torch.float32), d.to(torch.float32)
    return ((cf - df) * p.to(torch.float32) + cf).sum() / n


def _forward(scores, utilities, group_ids):
    """(loss, (c, d, N)) by Lemma 1: the tree counts of float32 scores,
    within groups when `group_ids` is given."""
    p = scores.to(torch.float32)
    if group_ids is None:
        c, d = _counts.counts(p, utilities)
        n = torch.clamp(_counts.num_pairs(utilities), min=1.0)
    else:
        group_ids = _compact_ids(group_ids)
        c, d = _counts.counts_grouped(p, utilities, group_ids)
        n = torch.clamp(_counts.num_pairs_grouped(utilities, group_ids),
                        min=1.0)
    return _loss_from_counts(p, c, d, n), (c, d, n)


class _RankHinge(torch.autograd.Function):
    """Lemma 2 as the gradient: g (c - d) / N for the scores, zeros for
    the utilities, none for the group ids."""

    @staticmethod
    def forward(ctx, scores, utilities, group_ids):
        loss, (c, d, n) = _forward(scores, utilities, group_ids)
        ctx.save_for_backward((c.to(scores.dtype) - d.to(scores.dtype))
                              / n.to(scores.dtype))
        return loss

    @staticmethod
    def backward(ctx, g):
        sub, = ctx.saved_tensors
        return g * sub, torch.zeros_like(sub), None


def pairwise_hinge_loss(scores: torch.Tensor, utilities: torch.Tensor,
                        group_ids: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Average pairwise hinge loss (RankSVM R_emp) with the linearithmic
    subgradient as its gradient.

    scores: (m,) predicted utilities (any float dtype); utilities: (m,)
    ground truth; group_ids: optional (m,) labels, only within-group pairs
    count. Returns the float32 scalar
    (1/N) sum_{y_i < y_j, same group} max(0, 1 + p_i - p_j)."""
    return _RankHinge.apply(scores, utilities, group_ids)


def loss_and_subgradient(scores, utilities, group_ids=None):
    """(loss, d loss / d scores) without autograd, both float32."""
    loss, (c, d, n) = _forward(scores, utilities, group_ids)
    return loss, (c.to(torch.float32) - d.to(torch.float32)) / n
