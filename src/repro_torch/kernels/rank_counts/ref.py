"""Plain torch version of the rank-counting kernel.

The same function as `csrc/rank_counts.cu` on the same prepared inputs
(`ops._prepare`): for each sorted query, the histogram lookups for the
candidate tiles wholly inside its margins plus dense comparisons over the
partial bands. The wrapper (`ops.rank_counts`) runs it for tensors on the
CPU; on the card only the tests and `chip_smoke.py` call it, to hold the
kernel against it.
"""

from __future__ import annotations

import torch


def rank_counts_plain(band, ps, yr, gt, lt, ti: int, tj: int):
    """(c, d) in sorted order, as int32.

    band (nI, 4) int32 [c_lo, c_hi, d_lo, d_hi] per query tile of `ti`
    sorted queries, in candidate tiles of `tj`; ps (m,) float32 sorted
    scores; yr (m,) int32 compact y-ranks; gt/lt (nJ + 1, levels) int32
    tables of candidates with rank > r / < r in tiles [0, t)."""
    m = ps.shape[0]
    n_tiles_j = gt.shape[0] - 1
    r = yr.long()
    tile_band = band.long()[torch.arange(m, device=ps.device) // ti]
    c = gt[tile_band[:, 0], r].long()
    d = (lt[n_tiles_j, r] - lt[tile_band[:, 3], r]).long()
    for t, (c_lo, c_hi, d_lo, d_hi) in enumerate(band.tolist()):
        q = slice(t * ti, min((t + 1) * ti, m))
        pq = ps[q, None]
        rq = yr[q, None]
        if c_hi > c_lo:
            j = slice(c_lo * tj, min(c_hi * tj, m))
            c[q] += ((yr[None, j] > rq) & (ps[None, j] < pq + 1.0)).sum(1)
        if d_hi > d_lo:
            j = slice(d_lo * tj, min(d_hi * tj, m))
            d[q] += ((yr[None, j] < rq) & (ps[None, j] > pq - 1.0)).sum(1)
    return c.to(torch.int32), d.to(torch.int32)
