"""O(m^2) torch references for the RankSVM pairwise hinge loss.

The ground truth under the linearithmic counting engines, as in
`repro.core.ref`. Notation follows the paper (Airola et al., 2011):

    p_i = w^T x_i                       (predicted utility scores)
    c_i = |{j : y_i < y_j  and  p_i > p_j - 1}|        (eq. 5)
    d_i = |{j : y_i > y_j  and  p_i < p_j + 1}|        (eq. 6)
    N   = |{(i, j) : y_i < y_j}|        (ordered pairs)

    R_emp = (1/N) sum_{y_i < y_j} max(0, 1 + p_i - p_j)             (eq. 4)
          = (1/N) sum_i ((c_i - d_i) * p_i + c_i)                   (Lemma 1)
    a     = (1/N) X (c - d)   is a subgradient of R_emp             (Lemma 2)

Every function builds the full (m, m) comparison, so it is for small m.
"""

from __future__ import annotations

import torch


def counts_ref(p: torch.Tensor, y: torch.Tensor):
    """O(m^2) frequency vectors (c, d) per eqs. (5) and (6), as int32."""
    y_j_gt_y_i = y[None, :] > y[:, None]
    p_j_in_margin_c = p[None, :] < p[:, None] + 1.0   # p_i > p_j - 1
    c = (y_j_gt_y_i & p_j_in_margin_c).sum(dim=1).to(torch.int32)
    y_j_lt_y_i = y[None, :] < y[:, None]
    p_j_in_margin_d = p[None, :] > p[:, None] - 1.0   # p_i < p_j + 1
    d = (y_j_lt_y_i & p_j_in_margin_d).sum(dim=1).to(torch.int32)
    return c, d


def num_pairs_ref(y: torch.Tensor) -> torch.Tensor:
    """N = number of ordered pairs (i, j) with y_i < y_j. O(m^2)."""
    return (y[:, None] < y[None, :]).sum().to(torch.int32)


def loss_ref(p: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Direct O(m^2) evaluation of the average pairwise hinge (eq. 4)."""
    diff = 1.0 + p[:, None] - p[None, :]
    mask = y[:, None] < y[None, :]
    n = torch.clamp(num_pairs_ref(y), min=1)
    return torch.where(mask, torch.clamp(diff, min=0.0),
                       torch.zeros_like(diff)).sum() / n


def loss_from_counts(p: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                     n_pairs) -> torch.Tensor:
    """Lemma 1: R_emp = (1/N) sum_i ((c_i - d_i) p_i + c_i)."""
    n = max(n_pairs, 1) if not torch.is_tensor(n_pairs) else torch.clamp(
        n_pairs, min=1)
    cf = c.to(p.dtype)
    df = d.to(p.dtype)
    return ((cf - df) * p + cf).sum() / n


def subgradient_ref(X: torch.Tensor, p: torch.Tensor, y: torch.Tensor):
    """Lemma 2 subgradient via the O(m^2) counts. X is (m, n) row-major."""
    c, d = counts_ref(p, y)
    n = torch.clamp(num_pairs_ref(y), min=1).to(X.dtype)
    return X.T @ (c - d).to(X.dtype) / n


def grouped_counts_ref(p: torch.Tensor, y: torch.Tensor, g: torch.Tensor):
    """O(m^2) counts restricted to within-group pairs (g_i == g_j)."""
    same = g[None, :] == g[:, None]
    y_j_gt_y_i = (y[None, :] > y[:, None]) & same
    p_j_in_margin_c = p[None, :] < p[:, None] + 1.0
    c = (y_j_gt_y_i & p_j_in_margin_c).sum(dim=1).to(torch.int32)
    y_j_lt_y_i = (y[None, :] < y[:, None]) & same
    p_j_in_margin_d = p[None, :] > p[:, None] - 1.0
    d = (y_j_lt_y_i & p_j_in_margin_d).sum(dim=1).to(torch.int32)
    return c, d


def grouped_num_pairs_ref(y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    same = g[None, :] == g[:, None]
    return ((y[:, None] < y[None, :]) & same).sum().to(torch.int32)
