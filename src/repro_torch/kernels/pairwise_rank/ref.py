"""Plain torch version of the pairwise counting kernel.

The same function as `csrc/pairwise_rank.cu` (the paper's eqs. 5 and 6
by brute force), written with tensor operations. The wrapper
(`ops.pairwise_counts`) runs it for tensors on the CPU; on the card only
the tests and `chip_smoke.py` call it, to hold the kernel against it.
"""

from __future__ import annotations

import torch


def pairwise_counts_plain(p: torch.Tensor, y: torch.Tensor,
                          block: int = 1024):
    """(c, d) as int32 for float32 p, y, comparing every pair.

    Queries go in blocks of `block` rows, so memory stays O(m * block)."""
    m = p.shape[0]
    c = torch.empty((m,), dtype=torch.int32, device=p.device)
    d = torch.empty((m,), dtype=torch.int32, device=p.device)
    pj = p[None, :]
    yj = y[None, :]
    for i0 in range(0, m, block):
        pi = p[i0:i0 + block, None]
        yi = y[i0:i0 + block, None]
        c[i0:i0 + block] = ((yj > yi) & (pj < pi + 1.0)).sum(dim=1)
        d[i0:i0 + block] = ((yj < yi) & (pj > pi - 1.0)).sum(dim=1)
    return c, d
