"""Pairwise ranking error at linearithmic cost.

The counterpart of the part of `repro.core.rank_loss` this slice needs:
`ranking_error` (the paper's eq. 1) and `_compact_ids`. The
differentiable hinge and the other losses and metrics wait for the loss
axis (ROADMAP.md Queue 1 item 6).
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
