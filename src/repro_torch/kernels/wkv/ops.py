"""Wrappers around the WKV kernels (`csrc/wkv_fwd.cu`, `csrc/wkv_bwd.cu`).

`wkv_forward` and `wkv_backward` launch the CUDA kernels for tensors on
the card and run the plain versions (`ref.wkv_forward_plain`,
`ref.wkv_backward_plain`) for tensors on the CPU; they never fall back
from the one to the other. `wkv_apply` is the op the RWKV-6 time mix
calls: with gradients needed it runs `WKV`, a `torch.autograd.Function`
(the counterpart of the reference's `jax.custom_vjp` in `_make_wkv`)
whose forward writes the chunk boundary states and whose backward runs
the backward kernel from them; without, it writes no boundaries.

Not ported from the reference's `ops.py`: the TPU's `bn` tile of
sequences per grid step (here each sequence is split over blocks
instead: `fwd_geometry`, `bwd_geometry`), and the mesh,
`shard_map` and `pure_callback` stub that only the dry-run's sharding
rules reach (ROADMAP Queue 1 item 13(c)).
"""

from __future__ import annotations

import torch

from .. import _build
from .ref import wkv_backward_plain, wkv_forward_plain

f32 = torch.float32

# Launchers of the CUDA kernels; `.launches` counts each one's launches.
WKV_FWD = _build.Kernel(
    'wkv_fwd.cu', 'wkv_fwd_launch',
    [_build.PTR] * 9 + [_build.INT] * 5 + [_build.PTR])
WKV_BWD = _build.Kernel(
    'wkv_bwd.cu', 'wkv_bwd_launch',
    [_build.PTR] * 15 + [_build.INT] * 5 + [_build.PTR])

# Head sizes the kernels are instantiated for.
KERNEL_K = (8, 16, 32, 64)
# Time steps per stage of the backward kernel and between its
# checkpoints (`kSub`, `kSeg` in wkv_bwd.cu; kSeg sizes its checkpoint
# scratch), and the longest chunk it takes.
WKV_BWD_SUB = 16
WKV_BWD_SEG = 8
WKV_BWD_MAX_CHUNK = 64
IO_DTYPES = (torch.bfloat16, torch.float32)


def _pick_chunk(t: int) -> int:
    """The reference's chunk rule (`_pick_geometry`): 64, halved until it
    divides T. It sets the interval of the boundary states."""
    chunk = 64
    while t % chunk:
        chunk //= 2
    return chunk


def _check(r, k, v, w, u, chunk, extra=()):
    """Raise on inputs the kernels do not take. `extra` holds (name,
    tensor, shape, dtype) of the further inputs: s0 for the forward; the
    boundaries, do and dsT for the backward."""
    n, t, kk = r.shape
    if r.dtype not in IO_DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f'r, k, v must share one dtype of {IO_DTYPES}; got '
                        f'{r.dtype}, {k.dtype}, {v.dtype}')
    if chunk <= 0 or t % chunk:
        raise ValueError(f'chunk {chunk} does not divide T = {t}')
    for name, a, shape, dtype in (('k', k, r.shape, r.dtype),
                                  ('v', v, r.shape, r.dtype),
                                  ('w', w, r.shape, f32),
                                  ('u', u, (n, kk), f32), *extra):
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f'{name} has shape {tuple(a.shape)}; expected '
                             f'{tuple(shape)}')
        if a.device != r.device:
            raise ValueError(f'{name} is on {a.device} but r on {r.device}')
        if a.dtype != dtype:
            raise TypeError(f'{name} must be {dtype}; got {a.dtype}')


def _check_launch(r, chunk=None):
    """Raise on shapes the kernels do not take: K outside KERNEL_K, or
    (for the backward, `chunk` given) a chunk above WKV_BWD_MAX_CHUNK.
    N*T*K has no limit: the kernels index in 64 bits."""
    kk = r.shape[-1]
    if kk not in KERNEL_K:
        raise ValueError(f'the WKV kernels take K in {KERNEL_K}; got {kk}')
    if chunk is not None and chunk > WKV_BWD_MAX_CHUNK:
        raise ValueError(f'the backward kernel takes chunks of at most '
                         f'{WKV_BWD_MAX_CHUNK} steps; got {chunk}')


def _aligned(*tensors):
    """The kernels copy with 16-byte loads: a contiguous view that starts
    off a 16-byte boundary is copied to one that does not."""
    return [a if a is None or a.data_ptr() % 16 == 0 else a.clone()
            for a in tensors]


def fwd_geometry(kk: int) -> dict:
    """The forward kernel's launch geometry for head size kk, as the
    kernel reports it: C blocks per sequence, R threads per value column,
    time steps per stage."""
    c, r_, steps = WKV_FWD.query('wkv_fwd_geometry', kk)[:3]
    return dict(C=c, R=r_, steps=steps)


def bwd_geometry(kk: int) -> dict:
    """The backward kernel's launch geometry for head size kk, as the
    kernel reports it: C blocks per sequence (one cluster), R threads per
    row of S, kSub time steps per stage, kSeg between checkpoints."""
    c, r_, sub, seg = WKV_BWD.query('wkv_bwd_geometry', kk)[:4]
    return dict(C=c, R=r_, kSub=sub, kSeg=seg)


def _launch(r, k, v, w, u, s0, chunk, boundaries):
    n, t, kk = r.shape
    _check_launch(r)
    r, k, v, w, u, s0 = _aligned(r, k, v, w, u, s0)
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
    n, t, kk = r.shape
    _check(r, k, v, w, u, chunk, [('s0', s0, (n, kk, kk), f32)])
    r, k, v, w, u, s0 = (a.contiguous() for a in (r, k, v, w, u, s0))
    if r.is_cuda:
        return _launch(r, k, v, w, u, s0, chunk, boundaries)
    if r.device.type != 'cpu':
        raise ValueError(f'unsupported device {r.device}')
    return wkv_forward_plain(r, k, v, w, u, s0, chunk=chunk,
                             boundaries=boundaries)


def _launch_bwd(r, k, v, w, u, bnd, do, dsT, chunk):
    n, t, kk = r.shape
    _check_launch(r, chunk)
    r, k, v, w, u, bnd, do, dsT = _aligned(r, k, v, w, u, bnd, do, dsT)
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty((n, t, kk), dtype=f32, device=r.device)
    du = torch.empty((n, kk), dtype=f32, device=r.device)
    ds0 = torch.empty((n, kk, kk), dtype=f32, device=r.device)
    # the state every kSeg steps of the chunk being walked (the kernel's
    # scratch, as the kernel sizes it)
    seg = bwd_geometry(kk)['kSeg'] if n else WKV_BWD_SEG
    ckpt = torch.empty((n, -(-chunk // seg), kk, kk), dtype=f32,
                       device=r.device)
    if n:
        stream = torch.cuda.current_stream(r.device).cuda_stream
        with torch.cuda.device(r.device):
            WKV_BWD(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                    u.data_ptr(), bnd.data_ptr(), do.data_ptr(),
                    None if dsT is None else dsT.data_ptr(), dr.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                    du.data_ptr(), ds0.data_ptr(), ckpt.data_ptr(), n, t, kk,
                    chunk, int(r.dtype == torch.bfloat16), stream)
    return dr, dk, dv, dw, du, ds0


def wkv_backward(r, k, v, w, u, boundaries, do, dsT=None, *, chunk: int):
    """Gradients of (o, sT) = wkv_forward(r, k, v, w, u, s0) against the
    cotangents do ((N, T, K) in r's dtype) and dsT ((N, K, K) float32, or
    None for zero), from the chunk `boundaries` (N, T/chunk, K, K) float32
    that `wkv_forward` wrote.

    Returns (dr, dk, dv in r's dtype, dw (N, T, K), du (N, K), ds0
    (N, K, K) float32). CUDA tensors run the kernel, CPU tensors the plain
    version."""
    n, t, kk = r.shape
    extra = [('boundaries', boundaries, (n, t // max(chunk, 1), kk, kk), f32),
             ('do', do, r.shape, r.dtype)]
    if dsT is not None:
        extra.append(('dsT', dsT, (n, kk, kk), f32))
    _check(r, k, v, w, u, chunk, extra)
    r, k, v, w, u, boundaries, do = (a.contiguous() for a in (
        r, k, v, w, u, boundaries, do))
    dsT = None if dsT is None else dsT.contiguous()
    if r.is_cuda:
        return _launch_bwd(r, k, v, w, u, boundaries, do, dsT, chunk)
    if r.device.type != 'cpu':
        raise ValueError(f'unsupported device {r.device}')
    return wkv_backward_plain(r, k, v, w, u, boundaries, do, dsT,
                              chunk=chunk)


class WKV(torch.autograd.Function):
    """(o, sT) = WKV(r, k, v, w, u, s0, chunk) with the backward kernel as
    its gradient. The forward writes the chunk boundaries for the
    backward. The backward rounds do to r's dtype, as the reference does,
    and takes an unused output's cotangent as zero."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, chunk):
        o, sT, bnd = wkv_forward(r, k, v, w, u, s0, chunk=chunk)
        ctx.save_for_backward(r, k, v, w, u, bnd)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return o, sT

    @staticmethod
    def backward(ctx, do, dsT):
        r, k, v, w, u, bnd = ctx.saved_tensors
        do = (torch.zeros_like(r) if do is None else do.to(r.dtype))
        dsT = None if dsT is None else dsT.to(f32)
        grads = wkv_backward(r, k, v, w, u, bnd, do, dsT, chunk=ctx.chunk)
        return (*grads, None)


def wkv_apply(r, k, v, w, u, s0):
    """WKV over (N, T, K) inputs -> (o in r's dtype, sT float32), with the
    reference's chunk rule. When autograd is on and some input needs a
    gradient it runs through `WKV` (boundaries written, differentiable
    through the backward kernel); otherwise it writes no boundaries."""
    chunk = _pick_chunk(r.shape[1])
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (r, k, v, w, u, s0)):
        return WKV.apply(r, k, v, w, u, s0, chunk)
    o, sT, _ = wkv_forward(r, k, v, w, u, s0, chunk=chunk, boundaries=False)
    return o, sT
