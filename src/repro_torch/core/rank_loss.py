"""Pairwise ranking error and the differentiable pairwise hinge at
linearithmic cost.

The counterpart of the part of `repro.core.rank_loss` the port needs:
`ranking_error` (the paper's eq. 1), `_compact_ids`, and
`pairwise_hinge_loss`, eq. (4) by Lemma 1 with Lemma 2's subgradient as
its gradient (a `torch.autograd.Function`, the counterpart of the
reference's `jax.custom_vjp`):

    forward :  loss = (1/N) sum_i ((c_i - d_i) p_i + c_i)
    backward:  d loss / d p_i = (c_i - d_i) / N

so a neural scorer (the RWKV-6 score head of `objective='rank_hinge'`)
trains against the exact RankSVM objective over the whole batch in
O(m log^2 m). `loss_and_subgradient` returns both without autograd. The
other losses and metrics wait for the loss axis (ROADMAP.md Queue 1 item
6).
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
