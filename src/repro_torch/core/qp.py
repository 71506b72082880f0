"""Simplex-constrained dual QP solver for the BMRM master problem.

At BMRM iteration t the master problem (eq. 3) is

    w_t = argmin_w  max_i (<w, a_i> + b_i) + lam * ||w||^2 .

Its dual over the t cutting planes is

    max_{alpha in simplex}  D(alpha) = -(1/(4 lam)) alpha' G alpha + b' alpha,
    with  G = A A',  w = -A' alpha / (2 lam).

It is solved by accelerated projected gradient (FISTA) with the exact
Euclidean projection onto the simplex (Duchi et al., 2008). Two versions,
as in `repro.core.qp`:

* `solve_bundle_dual`       numpy float64 with adaptive stopping, for the
  host BMRM driver (a verbatim copy of the reference's);
* `solve_bundle_dual_torch` float32 tensors on the oracle's device, a
  fixed number of iterations and a mask over a fixed-capacity plane
  buffer, for the device driver. It runs eagerly: each iteration is a
  handful of small kernels, and no value comes back to the host.
"""

from __future__ import annotations

import numpy as np
import torch


def project_simplex(v: np.ndarray) -> np.ndarray:
    """Euclidean projection of v onto {x >= 0, sum x = 1} (Duchi et al.)."""
    u = np.sort(v)[::-1]
    css = np.cumsum(u) - 1.0
    rho_idx = np.nonzero(u * np.arange(1, len(v) + 1) > css)[0]
    rho = rho_idx[-1]
    theta = css[rho] / (rho + 1.0)
    return np.maximum(v - theta, 0.0)


def solve_bundle_dual(G: np.ndarray, b: np.ndarray, lam: float,
                      alpha0: np.ndarray | None = None,
                      tol: float = 1e-10, max_iter: int = 5000):
    """Maximize D(alpha) over the simplex; returns (alpha, dual_value).

    f(alpha) = (1/(4 lam)) a'Ga - b'a is minimized with FISTA; the
    Lipschitz constant of grad f is lmax(G)/(2 lam), computed exactly."""
    t = G.shape[0]
    if t == 1:
        return np.ones(1), float(-G[0, 0] / (4.0 * lam) + b[0])
    alpha = (np.ones(t) / t if alpha0 is None
             else project_simplex(np.asarray(alpha0, np.float64)))
    evs = np.linalg.eigvalsh(G)
    L = max(float(evs[-1]) / (2.0 * lam), 1e-12)

    def grad(a):
        return (G @ a) / (2.0 * lam) - b

    def fval(a):
        return float(a @ G @ a / (4.0 * lam) - b @ a)

    z = alpha.copy()
    tk = 1.0
    f_best = fval(alpha)
    a_best = alpha.copy()
    stall = 0
    for it in range(max_iter):
        alpha_new = project_simplex(z - grad(z) / L)
        tk_new = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * tk * tk))
        z = alpha_new + ((tk - 1.0) / tk_new) * (alpha_new - alpha)
        alpha, tk = alpha_new, tk_new
        if it % 10 == 9:  # FISTA is non-monotone: track the best iterate.
            f_cur = fval(alpha)
            if f_cur < f_best - tol * max(1.0, abs(f_best)):
                f_best, a_best, stall = f_cur, alpha.copy(), 0
            else:
                stall += 1
                if stall >= 5:
                    break
    return a_best, -f_best


def _mv(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """M @ x over the last two axes of M: a matrix-vector product for one
    problem, a batched one for a leading lambda axis."""
    return M @ x if M.dim() == 2 else (M @ x.unsqueeze(-1)).squeeze(-1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The dot product over the last axis, per problem."""
    return a @ b if a.dim() == 1 else (a * b).sum(dim=-1)


def project_simplex_masked(v: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Projection onto {x >= 0, sum x = 1, x[~mask] = 0} over a
    fixed-capacity vector, or over the last axis of a batch of them:
    inactive slots go to -inf before the sort. Requires at least one True
    in every mask. No host synchronisation."""
    k = v.shape[-1]
    vm = torch.where(mask, v, torch.full_like(v, float('-inf')))
    u = torch.sort(vm, dim=-1, descending=True).values
    fin = torch.isfinite(u)
    css = torch.cumsum(torch.where(fin, u, torch.zeros_like(u)), -1) - 1.0
    j = torch.arange(1, k + 1, device=v.device)
    cond = fin & (u * j.to(v.dtype) > css)
    rho = torch.where(cond, j, torch.ones_like(j)).amax(dim=-1, keepdim=True)
    # gather, not css[rho - 1]: a 0-d index would be read back to the host.
    theta = css.gather(-1, rho - 1) / rho.to(v.dtype)
    return torch.where(mask, torch.clamp(v - theta, min=0.0),
                       torch.zeros_like(v))


def solve_bundle_dual_torch(G: torch.Tensor, b: torch.Tensor, lam,
                            mask: torch.Tensor,
                            alpha0: torch.Tensor | None = None,
                            n_iter: int = 256):
    """Masked fixed-iteration FISTA for the bundle dual, on the device.

    G is the (K, K) Gram buffer and b the (K,) offsets of the device
    driver's plane buffer; `mask` selects the active planes. Runs exactly
    `n_iter` steps and returns (alpha, dual_value) as tensors, alpha zero
    outside `mask`. The Lipschitz constant comes from 12 power iterations
    padded by 10% and clamped to the Gershgorin bound; FISTA being
    non-monotone, the best iterate is returned. The counterpart of
    `repro.core.qp.solve_bundle_dual_jax`.

    Batched: G (L, K, K), b, mask and alpha0 (L, K) and lam (L,) solve L
    independent problems with one set of launches, the counterpart of
    the reference's `jax.vmap` of the masked FISTA in its path sweep
    (each tensor operation below takes the lambda axis along, so no
    launch is repeated per lambda). Each problem's result equals its
    unbatched solve up to float32 reassociation in the products; the
    dual value comes back as (L,)."""
    dt = G.dtype
    lam = torch.as_tensor(lam, dtype=dt, device=G.device)
    lam_v = lam[..., None]          # broadcasts against the plane axis
    mask_f = mask.to(dt)
    Gm = G * mask_f[..., :, None] * mask_f[..., None, :]
    bm = torch.where(mask, b, torch.zeros_like(b)).to(dt)
    gersh = Gm.abs().sum(dim=-1).amax(dim=-1)
    v = mask_f / torch.clamp(torch.linalg.vector_norm(
        mask_f, dim=-1, keepdim=True), min=1e-30)
    for _ in range(12):
        u = _mv(Gm, v)
        v = u / torch.clamp(torch.linalg.vector_norm(u, dim=-1,
                                                     keepdim=True),
                            min=1e-30)
    lmax = torch.minimum(1.1 * _dot(v, _mv(Gm, v)), gersh)
    L = torch.clamp(lmax / (2.0 * lam), min=1e-12)[..., None]

    def grad(a):
        return _mv(Gm, a) / (2.0 * lam_v) - bm

    def fval(a):
        return _dot(a, _mv(Gm, a)) / (4.0 * lam) - _dot(bm, a)

    alpha = project_simplex_masked(
        torch.zeros_like(bm) if alpha0 is None else alpha0, mask)
    z = alpha
    a_best, f_best = alpha, fval(alpha)
    # The momentum schedule does not depend on the data: kept on the host
    # in float32, as the reference keeps it in a float32 scalar, and the
    # same for every problem of a batch.
    tk = np.float32(1.0)
    for _ in range(n_iter):
        alpha_new = project_simplex_masked(z - grad(z) / L, mask)
        tk_new = np.float32(0.5) * (np.float32(1.0) + np.sqrt(
            np.float32(1.0) + np.float32(4.0) * tk * tk))
        z = alpha_new + float((tk - np.float32(1.0)) / tk_new) * (
            alpha_new - alpha)
        alpha, tk = alpha_new, tk_new
        f_new = fval(alpha_new)
        better = f_new < f_best
        a_best = torch.where(better[..., None], alpha_new, a_best)
        f_best = torch.where(better, f_new, f_best)
    return a_best, -f_best
