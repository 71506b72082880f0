"""Plain torch versions of the WKV-6 recurrence (the RWKV-6 time-mix core).

    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

Shapes (flattened batch*heads = N): r, k, v, w: (N, T, K); u: (N, K);
s0: (N, K, K) indexed S[k, v].

`wkv_ref` is the port's copy of the reference oracle (a loop over T in
float32). `wkv_forward_plain` is the plain version of the CUDA kernel
(`csrc/wkv_fwd.cu`) with the kernel's contract: inputs upcast to
float32, o rounded to r's dtype, and the state at each chunk start
written to `boundaries`. `wkv_backward_plain` is the plain version of
the backward kernel (`csrc/wkv_bwd.cu`) with its contract: it recomputes
each chunk forward from its boundary state and walks it in reverse,
accumulating dS, as the reference's `_wkv_bwd_kernel` does. The wrappers
(`ops.wkv_forward`, `ops.wkv_backward`) run them for tensors on the
CPU; on the card only the tests and `chip_smoke.py` call them, to hold
the kernels against them. Each product and sum of a state or dS update
is rounded once, in the kernels' order, so the states, boundaries, dS
and ds0 equal the kernels' bit for bit; the outputs that sum K terms (o,
dr, dk, dv, dw, du) differ only in the order of those sums.

`wkv_ref_vjp` is the oracle of the backward: autograd through `wkv_ref`
(the counterpart of the reference's `jax.vjp` over its scan).
"""

from __future__ import annotations

import torch

f32 = torch.float32


def _loop(r, k, v, w, u, s0, chunk=None):
    n, t, kk = r.shape
    r, k, v, w, u = (a.to(f32) for a in (r, k, v, w, u))
    s = s0.to(f32).clone()
    o = torch.empty((n, t, kk), dtype=f32, device=r.device)
    bnd = (None if chunk is None else
           torch.empty((n, t // chunk, kk, kk), dtype=f32, device=r.device))
    uu = u[:, :, None]
    for i in range(t):
        if bnd is not None and i % chunk == 0:
            bnd[:, i // chunk] = s
        kv = k[:, i, :, None] * v[:, i, None, :]            # (N, K, V)
        o[:, i] = ((s + uu * kv) * r[:, i, :, None]).sum(1)
        s = w[:, i, :, None] * s + kv
    return o, s, bnd


def wkv_ref(r, k, v, w, u, s0):
    """(o (N, T, K) float32, sT (N, K, K) float32)."""
    o, sT, _ = _loop(r, k, v, w, u, s0)
    return o, sT


def wkv_forward_plain(r, k, v, w, u, s0, *, chunk: int,
                      boundaries: bool = True):
    """(o in r's dtype, sT float32, boundaries (N, T/chunk, K, K) float32
    or None): the kernel's function."""
    o, sT, bnd = _loop(r, k, v, w, u, s0, chunk if boundaries else None)
    return o.to(r.dtype), sT, bnd


def wkv_backward_plain(r, k, v, w, u, boundaries, do, dsT, *, chunk: int):
    """(dr, dk, dv in r's dtype; dw, du (N, K), ds0 (N, K, K) float32):
    the backward kernel's function. `boundaries` (N, T/chunk, K, K) are
    the states before each chunk, as `wkv_forward_plain` writes them; do
    is in r's dtype; dsT float32 or None (zero)."""
    n, t, kk = r.shape
    io = r.dtype
    r, k, v, w, u, do = (a.to(f32) for a in (r, k, v, w, u, do))
    ds = (torch.zeros((n, kk, kk), dtype=f32, device=r.device)
          if dsT is None else dsT.to(f32).clone())
    du = torch.zeros((n, kk), dtype=f32, device=r.device)
    dr, dk, dv, dw = (torch.empty((n, t, kk), dtype=f32, device=r.device)
                      for _ in range(4))
    uu = u[:, :, None]
    for c in reversed(range(t // chunk)):
        s = boundaries[:, c].to(f32)
        hist = []                                 # S_{t-1} of each step
        for i in range(c * chunk, (c + 1) * chunk):
            hist.append(s)
            s = w[:, i, :, None] * s + k[:, i, :, None] * v[:, i, None, :]
        for i in reversed(range(c * chunk, (c + 1) * chunk)):
            s_prev = hist[i - c * chunk]
            rt, kt, vt, wt, dot = r[:, i], k[:, i], v[:, i], w[:, i], do[:, i]
            kv = kt[:, :, None] * vt[:, None, :]
            dr[:, i] = ((s_prev + uu * kv) * dot[:, None, :]).sum(2)
            vdo = (vt * dot).sum(1)
            dk[:, i] = (u * rt) * vdo[:, None] + (ds * vt[:, None, :]).sum(2)
            dv[:, i] = ((u * rt * kt).sum(1)[:, None] * dot
                        + (ds * kt[:, :, None]).sum(1))
            dw[:, i] = (ds * s_prev).sum(2)
            du = du + (kt * vdo[:, None]) * rt
            ds = wt[:, :, None] * ds + rt[:, :, None] * dot[:, None, :]
    return dr.to(io), dk.to(io), dv.to(io), dw, du, ds


def wkv_ref_vjp(r, k, v, w, u, s0, do, dsT):
    """Gradients of (o, sT) = wkv_ref(r, k, v, w, u, s0) against the
    cotangents (do, dsT), by autograd through the loop; each gradient is
    in its input's dtype."""
    args = [a.detach().requires_grad_(True) for a in (r, k, v, w, u, s0)]
    with torch.enable_grad():
        o, sT = wkv_ref(*args)
        return torch.autograd.grad((o, sT), args, (do.to(o.dtype),
                                                   dsT.to(sT.dtype)))
