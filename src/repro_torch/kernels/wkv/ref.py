"""Plain torch versions of the WKV-6 recurrence (the RWKV-6 time-mix core).

    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

Shapes (flattened batch*heads = N): r, k, v, w: (N, T, K); u: (N, K);
s0: (N, K, K) indexed S[k, v].

`wkv_ref` is the port's copy of the reference oracle (a loop over T in
float32). `wkv_forward_plain` is the plain version of the CUDA kernel
(`csrc/wkv_fwd.cu`) with the kernel's contract: inputs upcast to
float32, o rounded to r's dtype, and the state at each chunk start
written to `boundaries`. The wrapper (`ops.wkv_forward`) runs it for
tensors on the CPU; on the card only the tests and `chip_smoke.py` call
it, to hold the kernel against it. Each product and sum of a state
update is rounded once, in the kernel's order, so the states and
boundaries it returns equal the kernel's bit for bit; o differs only in
the order of its K-term sum.
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
