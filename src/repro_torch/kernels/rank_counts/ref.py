"""Plain torch version of the rank-counting kernels.

The same function as `csrc/rank_counts.cu` on the same inputs (the
stable sort of p, values and order, and the compact ranks in example
order), step for step: `prepare_plain` builds what the gather and scan
kernels build (the sorted ranks, their bit planes and the tile table),
`count_plain` what the count kernel computes from them. The wrapper
(`ops.rank_counter`) runs it for tensors on the CPU; on the card only
the tests and `chip_smoke.py` call it, to hold the kernels against it.
"""

from __future__ import annotations

import torch


def rank_bits(n_ranks: int) -> int:
    """Bit planes per 32 positions: enough for ranks 0 .. n_ranks - 1
    (at least one)."""
    return max(1, (n_ranks - 1).bit_length())


def _to_int32(bits: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit patterns held in int64 -> the same bits as int32."""
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit pattern held in int64."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def frontiers_plain(ps: torch.Tensor):
    """(L, R) as int64 for sorted float32 scores ps: L_i the count of
    ps_k < fl32(ps_i + 1), R_i the count of ps_k <= fl32(ps_i - 1)."""
    return (torch.searchsorted(ps, ps + 1.0, right=False),
            torch.searchsorted(ps, ps - 1.0, right=True))


def prepare_plain(ps, ranks, order, n_ranks: int, tj: int):
    """(yr, planes, table), what the gather and scan kernels write.

    yr (m,) int32: the ranks in sorted order; planes (ceil(m / 32), bits)
    int32: bit l of planes[w, b] is bit b of yr[32 w + l] (0 past m);
    table (n_ranks, ceil(m / tj) + 1) int32, one column per rank:
    table[r, t] counts the positions k < t tj (all of them in the last
    row) with yr_k <= r."""
    m = ps.shape[0]
    dev = ps.device
    yr = ranks[order]
    bits = rank_bits(n_ranks)
    n_words = -(-m // 32)
    padded = torch.zeros(n_words * 32, dtype=torch.int64, device=dev)
    padded[:m] = yr
    lane = torch.arange(32, device=dev)
    planes = torch.stack(
        [(((padded.view(n_words, 32) >> b) & 1) << lane).sum(1)
         for b in range(bits)], dim=1)
    n_tiles = -(-m // tj)
    key = torch.arange(m, device=dev) // tj * n_ranks + yr.long()
    hist = torch.bincount(key, minlength=n_tiles * n_ranks)
    table = torch.zeros((n_ranks, n_tiles + 1), dtype=torch.int64,
                        device=dev)
    table[:, 1:] = torch.cumsum(torch.cumsum(hist.view(n_tiles, n_ranks), 1),
                                0).T
    return (yr, _to_int32(planes).contiguous(),
            table.to(torch.int32).contiguous())


def _rank_mask(planes, w, r, bits: int, greater: bool):
    """Bits of word w (per query) whose rank is > r (greater) or < r."""
    out = torch.zeros_like(r)
    eq = torch.full_like(r, 0xFFFFFFFF)
    for b in range(bits - 1, -1, -1):
        plane = planes[w, b]
        rb = torch.where((r >> b) & 1 == 1, 0xFFFFFFFF, 0)
        out |= eq & (plane & ~rb if greater else ~plane & rb) & 0xFFFFFFFF
        eq &= ~(plane ^ rb) & 0xFFFFFFFF
    return out


def _count_words(planes, w0, end, r, bits: int, greater: bool, words: int):
    """Positions in [32 w0, end) whose rank is > r (greater) or < r; end
    lies before the end of the tile of `words` words that starts at w0."""
    n = torch.zeros_like(r)
    w_end = end >> 5
    last = planes.shape[0] - 1
    tail = torch.bitwise_left_shift(torch.ones_like(end), end & 31) - 1
    for k in range(words):
        w = w0 + k
        mask = _rank_mask(planes, torch.clamp(w, max=last), r, bits, greater)
        keep = torch.where(w < w_end, 0xFFFFFFFF,
                           torch.where(w == w_end, tail, 0))
        n += _popcount(mask & keep)
    return n


def count_plain(ps, yr, planes, table, order, tj: int):
    """(c, d) as int32 in example order from the prepared inputs, by the
    count kernel's arithmetic: the frontiers, the table's whole tiles and
    the bit planes' partial tile. As the kernel writes them, c and d are
    the two columns of one (m, 2) tensor."""
    m = ps.shape[0]
    n_tiles = table.shape[1] - 1
    bits = planes.shape[1]
    words = tj // 32
    pl = planes.long() & 0xFFFFFFFF
    tab = table.long().T
    L, R = frontiers_plain(ps)
    r = yr.long()
    tl = L // tj
    c = tl * tj - tab[tl, r] + _count_words(pl, tl * words, L, r, bits,
                                            True, words)
    rm = torch.clamp(r - 1, min=0)
    tr = R // tj
    d = tab[n_tiles, rm] - tab[tr, rm] - _count_words(pl, tr * words, R, r,
                                                      bits, False, words)
    d = torch.where(r > 0, d, 0)
    cd = torch.empty((m, 2), dtype=torch.int32, device=ps.device)
    cd[order] = torch.stack([c, d], dim=1).to(torch.int32)
    return cd[:, 0], cd[:, 1]


def rank_counts_plain(ps, order, ranks, n_ranks: int, tj: int):
    """(c, d, (yr, planes, table)): the whole call after the sort, as the
    kernels return it."""
    prep = prepare_plain(ps, ranks, order, n_ranks, tj)
    return (*count_plain(ps, *prep, order, tj), prep)
