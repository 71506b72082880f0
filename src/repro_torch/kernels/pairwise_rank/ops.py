"""Wrappers around the pairwise counting kernel (`csrc/pairwise_rank.cu`).

`pairwise_counts` launches the CUDA kernel for tensors on the card and
runs the plain version (`ref.pairwise_counts_plain`) for tensors on the
CPU; it never falls back from the one to the other. `auto_counter` is
the dispatch behind `counts_dispatch(engine='auto')`: the tiering of the
two kernels on the card, the merge-sort tree elsewhere.
"""

from __future__ import annotations

import torch

from .. import _build
from ..rank_counts import ops as _rc_ops
from .ref import pairwise_counts_plain

# Launcher of the CUDA kernel; `PAIRWISE.launches` counts its launches.
PAIRWISE = _build.Kernel('pairwise_rank.cu', 'pairwise_counts_launch',
                         [_build.PTR, _build.PTR, _build.INT, _build.PTR,
                          _build.PTR, _build.PTR])

# Largest m sent to the O(m^2) kernel by `counts_auto`; above it the
# rank-counts call runs. Measured on the H100 (chip_smoke.py's sweep
# phase, PERF.md): per call, the pairwise kernel is the faster of the two
# up to m = 8192 in every run; at m = 16384 the two trade places between
# runs (the rank-counts call's time there is mostly host launch cost).
KERNEL_MAX_M = 8192


def _launch(p: torch.Tensor, y: torch.Tensor):
    m = p.shape[0]
    if m >= 2 ** 31:
        raise ValueError(f'm = {m} exceeds the int32 range of the kernel')
    c = torch.empty((m,), dtype=torch.int32, device=p.device)
    d = torch.empty((m,), dtype=torch.int32, device=p.device)
    if m:
        stream = torch.cuda.current_stream(p.device).cuda_stream
        with torch.cuda.device(p.device):
            PAIRWISE(p.data_ptr(), y.data_ptr(), m, c.data_ptr(),
                     d.data_ptr(), stream)
    return c, d


def geometry(m: int) -> dict:
    """The kernel's launch geometry for m examples, as its launcher picks
    it on the current device: candidate splits (blocks of one cluster),
    queries a block and a thread hold, and blocks in all. Not a launch."""
    splits, tile, per_thread = PAIRWISE.query('pairwise_counts_geometry',
                                              m)[:3]
    return dict(splits=splits, queries_per_block=tile,
                queries_per_thread=per_thread,
                blocks=-(-m // tile) * splits)


def pairwise_counts(p: torch.Tensor, y: torch.Tensor):
    """O(m^2) (c, d) counts as int32, both cast to float32 first as the
    reference does. CUDA tensors run the kernel, CPU tensors the plain
    version."""
    if p.shape != y.shape or p.dim() != 1:
        raise ValueError(f'p and y must be 1-D of one length; got '
                         f'{tuple(p.shape)} and {tuple(y.shape)}')
    if p.device != y.device:
        raise ValueError(f'p is on {p.device} but y on {y.device}')
    p = p.to(torch.float32).contiguous()
    y = y.to(torch.float32).contiguous()
    if p.is_cuda:
        return _launch(p, y)
    if p.device.type != 'cpu':
        raise ValueError(f'unsupported device {p.device}')
    return pairwise_counts_plain(p, y)


def pairwise_rank_loss(p: torch.Tensor, y: torch.Tensor, n_pairs):
    """RankSVM R_emp from the kernel's counts and Lemma 1."""
    c, d = pairwise_counts(p, y)
    cf, df = c.to(torch.float32), d.to(torch.float32)
    return ((cf - df) * p.to(torch.float32) + cf).sum() / n_pairs


def auto_route(m: int, device) -> str:
    """The engine `engine='auto'` takes for m examples on `device`.

    On the card: 'pairwise' (the O(m^2) kernel) up to KERNEL_MAX_M
    examples, 'rank_counts' (the rank-counts kernel, with its exactness
    guard) above. Elsewhere: 'tree', the merge-sort pass `counts_fused`,
    as the reference's `counts_auto` does off the TPU (its kernels run
    there only through the Pallas interpreter, which does not pay)."""
    if torch.device(device).type != 'cuda':
        return 'tree'
    return 'pairwise' if m <= KERNEL_MAX_M else 'rank_counts'


def auto_counter(y: torch.Tensor):
    """`p -> (c, d)` for the fixed utilities y, by the engine that
    `auto_route` picks for y's length and device, chosen once. A batch of
    scores (L, m) gives (L, m) counts, row by row."""
    from ...core import counts as _tree
    route = auto_route(y.shape[0], y.device)
    if route == 'tree':
        return lambda p: _tree.by_row(lambda q: _tree.counts_fused(q, y), p)
    if route == 'pairwise':
        return lambda p: _tree.by_row(lambda q: pairwise_counts(q, y), p)
    return _rc_ops.rank_counter(y)


def counts_auto(p: torch.Tensor, y: torch.Tensor):
    """One-shot form of `auto_counter(y)(p)`."""
    return auto_counter(y)(p)
