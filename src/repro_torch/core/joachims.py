"""Joachims (2006) O(ms + m log m + rm) counts: the paper's r-level
baseline.

The counterpart of `repro.core.joachims`. SVM^rank assumes r discrete
utility levels: after sorting the examples by score it makes one pass
per level with two running counters, O(rm) on top of the sort. That is
cheap for few levels and quadratic when r ~= m, the regime the paper's
tree removes.

Vectorized over the levels, the r passes become one (m + 1, r) table of
per-level prefix counts over the sorted scores:

    c_i = sum over levels s > y_i of  #{k < frontier_i : y_k = s}
    d_i = sum over levels s < y_i of  #{k >= inner_i : y_k = s}

with the margin frontier frontier_i = |{k : p_k < p_i + 1}| and
inner_i = |{k : p_k <= p_i - 1}|. The reference sums each row against a
0/1 level mask with an integer einsum; here each sum is a cumulative sum
over the level axis of the table (reversed for c) gathered at y_i, in
int32, so the counts are exact and equal `ref.counts_ref` bit for bit.
O(rm) work and memory, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .counts import _f32, _scatter_back


def counts_rlevel(p: torch.Tensor, y_idx: torch.Tensor, r: int):
    """(c, d) as int32 for r-level utilities; y_idx holds each example's
    level in [0, r) (`levels_of`). Same strict tie semantics as the
    paper's eqs. 5-6."""
    p = _f32(p)
    m = p.shape[0]
    dev = p.device
    if m == 0:
        z = torch.zeros((0,), dtype=torch.int32, device=dev)
        return z, z.clone()
    ps, order = torch.sort(p, stable=True)
    ys = y_idx.to(device=dev, dtype=torch.int64)[order]
    fc = torch.searchsorted(ps, ps + 1.0, right=False)
    fd = torch.searchsorted(ps, ps - 1.0, right=True)
    del ps
    # prefix[k, s]: examples among the first k in score order at level s
    prefix = torch.zeros((m + 1, r), dtype=torch.int32, device=dev)
    prefix[torch.arange(1, m + 1, device=dev), ys] = 1
    prefix.cumsum_(dim=0)
    # above[k, s]: those at level s or higher; column r is zero
    above = torch.zeros((m + 1, r + 1), dtype=torch.int32, device=dev)
    above[:, :r] = prefix.flip(1).cumsum(1, dtype=torch.int32).flip(1)
    c_sorted = above[fc, ys + 1]
    del above
    # below[k, s]: those at a level under s
    below = prefix.cumsum(1, dtype=torch.int32).sub_(prefix)
    del prefix
    d_sorted = below[m, ys] - below[fd, ys]
    del below
    return _scatter_back(order, c_sorted, m), _scatter_back(order, d_sorted, m)


def levels_of(y) -> tuple:
    """Map real-valued y to (level indices as int32 numpy, r): what
    SVM^rank needs up front, and what the paper's tree does not."""
    if torch.is_tensor(y):
        y = y.detach().cpu().numpy()
    uniq, idx = np.unique(np.asarray(y), return_inverse=True)
    return idx.astype(np.int32).reshape(-1), int(len(uniq))
