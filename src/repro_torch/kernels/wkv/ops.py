"""Wrappers around the WKV forward kernel (`csrc/wkv_fwd.cu`).

`wkv_forward` launches the CUDA kernel for tensors on the card and runs
the plain version (`ref.wkv_forward_plain`) for tensors on the CPU; it
never falls back from the one to the other. `wkv_apply` is the op the
RWKV-6 time mix calls.

Not ported from the reference's `ops.py`: the TPU's `bn` tile of
sequences per grid step (a block here owns one sequence), and the mesh,
`shard_map` and `pure_callback` stub of multi-device runs (ROADMAP Queue
1 item 12). The backward kernel and the autograd function around both
are the training slice (ROADMAP Queue 1 item 13(b)); until then the op
is forward-only and refuses inputs that require a gradient.
"""

from __future__ import annotations

import torch

from .. import _build
from .ref import wkv_forward_plain

f32 = torch.float32

# Launcher of the CUDA kernel; `WKV_FWD.launches` counts its launches.
WKV_FWD = _build.Kernel(
    'wkv_fwd.cu', 'wkv_fwd_launch',
    [_build.PTR] * 9 + [_build.INT] * 5 + [_build.PTR])

# Head sizes the kernel is instantiated for (threads per block).
KERNEL_K = (8, 16, 32, 64)
IO_DTYPES = (torch.bfloat16, torch.float32)


def _pick_chunk(t: int) -> int:
    """The reference's chunk rule (`_pick_geometry`): 64, halved until it
    divides T. It sets the interval of the boundary states."""
    chunk = 64
    while t % chunk:
        chunk //= 2
    return chunk


def _check(r, k, v, w, u, s0, chunk):
    n, t, kk = r.shape
    for name, a, shape in (('k', k, r.shape), ('v', v, r.shape),
                           ('w', w, r.shape), ('u', u, (n, kk)),
                           ('s0', s0, (n, kk, kk))):
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f'{name} has shape {tuple(a.shape)}; expected '
                             f'{tuple(shape)}')
        if a.device != r.device:
            raise ValueError(f'{name} is on {a.device} but r on {r.device}')
    if r.dtype not in IO_DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f'r, k, v must share one dtype of {IO_DTYPES}; got '
                        f'{r.dtype}, {k.dtype}, {v.dtype}')
    for name, a in (('w', w), ('u', u), ('s0', s0)):
        if a.dtype != f32:
            raise TypeError(f'{name} must be float32; got {a.dtype}')
    if chunk <= 0 or t % chunk:
        raise ValueError(f'chunk {chunk} does not divide T = {t}')
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (r, k, v, w, u, s0)):
        raise NotImplementedError(
            'the WKV op is forward-only: its backward kernel and autograd '
            'function are the training slice (ROADMAP Queue 1 item 13(b)); '
            'run under torch.no_grad() or use wkv_impl="scan"')


def _launch(r, k, v, w, u, s0, chunk, boundaries):
    n, t, kk = r.shape
    if kk not in KERNEL_K:
        raise ValueError(f'the WKV kernel takes K in {KERNEL_K}; got {kk}')
    if n * t * kk >= 2 ** 31 or t >= 2 ** 31:
        raise ValueError('N*T*K exceeds the int32 range of the launcher')
    o = torch.empty_like(r)
    sT = torch.empty((n, kk, kk), dtype=f32, device=r.device)
    bnd = (torch.empty((n, t // chunk, kk, kk), dtype=f32, device=r.device)
           if boundaries else None)
    if n:
        stream = torch.cuda.current_stream(r.device).cuda_stream
        with torch.cuda.device(r.device):
            WKV_FWD(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                    u.data_ptr(), s0.data_ptr(), o.data_ptr(), sT.data_ptr(),
                    None if bnd is None else bnd.data_ptr(), n, t, kk,
                    chunk, int(r.dtype == torch.bfloat16), stream)
    return o, sT, bnd


def wkv_forward(r, k, v, w, u, s0, *, chunk: int, boundaries: bool = True):
    """r, k, v: (N, T, K) bf16 or float32; w: (N, T, K), u: (N, K),
    s0: (N, K, K) float32, S indexed [k, v].

    Returns (o (N, T, K) in r's dtype, sT (N, K, K) float32, boundaries
    (N, T/chunk, K, K) float32: the state before each chunk, or None when
    `boundaries` is False). CUDA tensors run the kernel, CPU tensors the
    plain version."""
    _check(r, k, v, w, u, s0, chunk)
    r, k, v, w, u, s0 = (a.contiguous() for a in (r, k, v, w, u, s0))
    if r.is_cuda:
        return _launch(r, k, v, w, u, s0, chunk, boundaries)
    if r.device.type != 'cpu':
        raise ValueError(f'unsupported device {r.device}')
    return wkv_forward_plain(r, k, v, w, u, s0, chunk=chunk,
                             boundaries=boundaries)


def wkv_apply(r, k, v, w, u, s0):
    """WKV over (N, T, K) inputs -> (o in r's dtype, sT float32), with the
    reference's chunk rule. Nothing reads the boundary states in a
    forward-only run, so none are written."""
    o, sT, _ = wkv_forward(r, k, v, w, u, s0, chunk=_pick_chunk(r.shape[1]),
                           boundaries=False)
    return o, sT
