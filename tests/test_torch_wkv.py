"""Port parity of the WKV-6 op, forward and backward, against the JAX
package.

On the CPU the port's `wkv_forward` and `wkv_backward` run the plain
versions of their CUDA kernels (`repro_torch/kernels/wkv/ref.py`); the
JAX kernels run through the Pallas interpreter, as
tests/test_wkv_kernel.py runs them. The same seeded numpy inputs go to
both, over the shapes of that file's sweeps, with its tolerances: 1e-4
on o, 1e-5 on the final and boundary states, and 1e-5 of each output's
scale on the six gradients (the bar of
`test_wkv_backward_matches_autodiff`).

The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.wkv import kernel as JK  # noqa: E402
from repro.kernels.wkv import ref as JR  # noqa: E402
from repro.kernels.wkv.ops import _pick_geometry  # noqa: E402
from repro.kernels.wkv.ops import wkv_apply as j_wkv_apply  # noqa: E402
from repro_torch.kernels.wkv import ops as W  # noqa: E402
from repro_torch.kernels.wkv.ref import wkv_ref, wkv_ref_vjp  # noqa: E402
from torch_parity import n, t, torch_one_thread  # noqa: E402,F401

BF16_ULP = 2.0 ** -7            # spacing of bf16 values in [1, 2)


def _case(nn, tt, kk, seed=0, dtype=np.float32):
    """The inputs of tests/test_wkv_kernel.py::_case, as numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = [rng.normal(size=(nn, tt, kk)).astype(dtype) for _ in range(3)]
    w = rng.uniform(0.5, 0.999, size=(nn, tt, kk)).astype(np.float32)
    u = rng.normal(size=(nn, kk)).astype(np.float32)
    s0 = (0.1 * rng.normal(size=(nn, kk, kk))).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize('nn,tt,kk,bn,chunk', [
    (2, 32, 16, 1, 16),
    (4, 64, 32, 2, 32),
    (8, 128, 64, 8, 64),
    (8, 128, 64, 4, 16),     # chunk smaller than K
    (6, 96, 8, 2, 32),       # small head dim, non-pow2 n
])
def test_wkv_forward_shape_sweep(nn, tt, kk, bn, chunk):
    args = _case(nn, tt, kk, seed=nn + tt)
    o_j, sT_j, bnd_j = JK.wkv_forward(*map(jnp.asarray, args), bn=bn,
                                      chunk=chunk, interpret=True)
    o_r, sT_r = JR.wkv_ref(*map(jnp.asarray, args))
    o, sT, bnd = W.wkv_forward(*map(t, args), chunk=chunk)
    assert o.dtype == torch.float32 and bnd.shape == (nn, tt // chunk, kk,
                                                      kk)
    for ref_o, ref_s in ((o_j, sT_j), (o_r, sT_r)):
        np.testing.assert_allclose(n(o), n(ref_o), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(n(sT), n(ref_s), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(bnd), n(bnd_j), rtol=1e-5, atol=1e-5)
    # the port's own copy of the oracle
    o_p, sT_p = wkv_ref(*map(t, args))
    np.testing.assert_allclose(n(o_p), n(o_r), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(n(sT_p), n(sT_r), rtol=1e-5, atol=1e-5)


def test_wkv_bf16_io_matches_reference():
    """bf16 r/k/v (the model path): o comes back in bf16 and agrees with
    the JAX op to 1e-4 of its scale plus one bf16 ulp of each value (one
    rounding of a float32 sum that differs in its last bits can flip);
    against the float32 oracle on the same quantized values, within the
    reference's own bar of 1% of the scale."""
    rng = np.random.default_rng(3)
    nn, tt, kk = 4, 128, 64
    r, k, v = [rng.normal(size=(nn, tt, kk)).astype(np.float32)
               for _ in range(3)]
    w = rng.uniform(0.6, 0.99, size=(nn, tt, kk)).astype(np.float32)
    u = rng.normal(size=(nn, kk)).astype(np.float32)
    s0 = np.zeros((nn, kk, kk), np.float32)
    bf = jnp.bfloat16
    o_j, sT_j = j_wkv_apply(*(jnp.asarray(a, bf) for a in (r, k, v)),
                            jnp.asarray(w), jnp.asarray(u), jnp.asarray(s0))
    o, sT = W.wkv_apply(*(t(a, torch.bfloat16) for a in (r, k, v)),
                        t(w), t(u), t(s0))
    assert o.dtype == torch.bfloat16
    oj = n(o_j.astype(jnp.float32))
    of = n(o.float())
    scale = float(np.abs(oj).max())
    ulp = BF16_ULP * np.exp2(np.floor(np.log2(np.maximum(np.abs(oj),
                                                         1e-30))))
    assert np.all(np.abs(of - oj) <= 1e-4 * scale + ulp)
    np.testing.assert_allclose(n(sT), n(sT_j), rtol=1e-5, atol=1e-5)
    q = [n(t(a, torch.bfloat16).float()) for a in (r, k, v)]
    o_r, sT_r = JR.wkv_ref(*map(jnp.asarray, (*q, w, u, s0)))
    assert float(np.abs(of - n(o_r)).max()) < 0.01 * scale
    np.testing.assert_allclose(n(sT), n(sT_r), rtol=1e-5, atol=1e-5)


def test_wkv_state_chaining_matches_full_run():
    """Two half-sequences with chained state == one full run (the
    prefill/decode contract)."""
    r, k, v, w, u, s0 = map(t, _case(2, 64, 16, seed=5))
    o_full, sT_full = JR.wkv_ref(*map(jnp.asarray, map(n, (r, k, v, w, u,
                                                           s0))))
    h = 32
    o1, s_mid = W.wkv_apply(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u, s0)
    o2, sT = W.wkv_apply(r[:, h:], k[:, h:], v[:, h:], w[:, h:], u, s_mid)
    np.testing.assert_allclose(n(torch.cat([o1, o2], 1)), n(o_full),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(n(sT), n(sT_full), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('tt', [1, 7, 24, 64, 96, 100, 128, 4096, 4100])
def test_chunk_rule_matches_reference(tt):
    assert W._pick_chunk(tt) == _pick_geometry(8, tt)[0]


def test_wkv_apply_writes_boundaries_only_for_gradients(monkeypatch):
    """Inputs that need a gradient make the forward write the chunk
    boundaries (the backward reads them); under no_grad, or with no input
    needing one, none are written and nothing is saved."""
    r, k, v, w, u, s0 = map(t, _case(2, 16, 8, seed=1))
    seen = []
    real = W.wkv_forward

    def spy(*args, **kw):
        seen.append(kw.get('boundaries', True))
        return real(*args, **kw)
    monkeypatch.setattr(W, 'wkv_forward', spy)
    r.requires_grad_(True)
    o, _ = W.wkv_apply(r, k, v, w, u, s0)
    assert o.requires_grad
    with torch.no_grad():
        o, _ = W.wkv_apply(r, k, v, w, u, s0)
    assert not o.requires_grad
    o, _ = W.wkv_apply(r.detach(), k, v, w, u, s0)
    assert not o.requires_grad
    assert seen == [True, False, False]


def _bwd_case(nn, tt, kk, seed=0):
    """The forward inputs of `_case` plus cotangents do and dsT."""
    args = _case(nn, tt, kk, seed=seed)
    rng = np.random.default_rng(seed + 1000)
    do = rng.normal(size=(nn, tt, kk)).astype(np.float32)
    dsT = rng.normal(size=(nn, kk, kk)).astype(np.float32)
    return args, do, dsT


GRADS = ('dr', 'dk', 'dv', 'dw', 'du', 'ds0')


def _close_to_scale(got, want, rel, what):
    got, want = n(got).astype(np.float32), n(want).astype(np.float32)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


@pytest.mark.parametrize('nn,tt,kk,chunk', [
    (2, 64, 32, 32),
    (4, 128, 64, 64),
    (4, 128, 64, 32),
    (2, 100, 8, 4),          # T not a multiple of 64: chunk 4, one sub-chunk
    (3, 96, 16, 32),
])
def test_wkv_backward_matches_reference(nn, tt, kk, chunk):
    """The plain backward, from the plain forward's boundaries, against
    the JAX backward kernel (interpret mode, from its own forward's
    boundaries) and against `wkv_ref_vjp` in both packages: all six
    gradients within 1e-5 of each output's scale."""
    args, do, dsT = _bwd_case(nn, tt, kk, seed=nn + tt + kk)
    ja = [jnp.asarray(a) for a in args]
    _, _, bnd_j = JK.wkv_forward(*ja, bn=1, chunk=chunk, interpret=True)
    want_k = JK.wkv_backward(*ja[:5], bnd_j, jnp.asarray(do),
                             jnp.asarray(dsT), bn=1, chunk=chunk,
                             interpret=True)
    want_v = JR.wkv_ref_vjp(*ja, jnp.asarray(do), jnp.asarray(dsT))
    ta = [t(a) for a in args]
    _, _, bnd = W.wkv_forward(*ta, chunk=chunk)
    got = W.wkv_backward(*ta[:5], bnd, t(do), t(dsT), chunk=chunk)
    own = wkv_ref_vjp(*ta, t(do), t(dsT))
    for name, g, wk, wv, o in zip(GRADS, got, want_k, want_v, own):
        assert g.dtype == torch.float32, name
        _close_to_scale(g, wk, 1e-5, name)
        _close_to_scale(g, wv, 1e-5, name)
        _close_to_scale(o, wv, 1e-5, name)


def test_wkv_apply_grads_match_autograd_through_the_loop():
    """Gradients of sum(o^2) + sum(sT^3) through the autograd function
    against autograd through the port's `wkv_ref` loop, within 1e-4 (the
    bar of tests/test_wkv_kernel.py::test_wkv_custom_vjp_grad_flow)."""
    args = [t(a) for a in _case(3, 64, 16, seed=4)]

    def grads(fn):
        leaves = [a.clone().requires_grad_(True) for a in args]
        o, sT = fn(*leaves)
        return torch.autograd.grad((o * o).sum() + (sT ** 3).sum(), leaves)
    for name, a, b in zip(GRADS, grads(W.wkv_apply), grads(wkv_ref)):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_wkv_apply_bf16_grads_match_jax():
    """bf16 r/k/v: the port's gradients of sum(o * c) (o upcast) against
    jax.grad through the JAX package's wkv_apply on the same bf16 values.
    dr, dk, dv come back in bf16: within 1e-4 of the scale plus one bf16
    ulp of each value (one rounding of a float32 sum that differs in its
    last bits can flip); dw, du, ds0 in float32 within 1e-4 of scale."""
    rng = np.random.default_rng(6)
    nn, tt, kk = 2, 64, 32
    r, k, v = [rng.normal(size=(nn, tt, kk)).astype(np.float32)
               for _ in range(3)]
    w = rng.uniform(0.6, 0.99, size=(nn, tt, kk)).astype(np.float32)
    u = rng.normal(size=(nn, kk)).astype(np.float32)
    s0 = (0.1 * rng.normal(size=(nn, kk, kk))).astype(np.float32)
    c = rng.normal(size=(nn, tt, kk)).astype(np.float32)
    bf = jnp.bfloat16

    def j_loss(r, k, v, w, u, s0):
        o, sT = j_wkv_apply(r, k, v, w, u, s0)
        return jnp.sum(o.astype(jnp.float32) * c) + jnp.sum(sT)
    want = jax.grad(j_loss, argnums=tuple(range(6)))(
        *(jnp.asarray(a, bf) for a in (r, k, v)), *map(jnp.asarray,
                                                        (w, u, s0)))
    leaves = [t(a, torch.bfloat16).requires_grad_(True) for a in (r, k, v)]
    leaves += [t(a).requires_grad_(True) for a in (w, u, s0)]
    o, sT = W.wkv_apply(*leaves)
    got = torch.autograd.grad((o.float() * t(c)).sum() + sT.sum(), leaves)
    for name, g, wj in zip(GRADS, got, want):
        wf = n(wj.astype(jnp.float32))
        gf = n(g.float())
        tol = 1e-4 * float(np.abs(wf).max())
        if g.dtype == torch.bfloat16:
            assert wj.dtype == bf, name
            tol = tol + BF16_ULP * np.exp2(np.floor(np.log2(
                np.maximum(np.abs(wf), 1e-30))))
        assert np.all(np.abs(gf - wf) <= tol), name


def test_wkv_apply_gradients_reach_u_and_s0():
    """du and ds0 flow to u and s0 (through a broadcast u, as the time mix
    passes it, summing over the sequences of a head); with sT unused its
    cotangent is None and counts as zero."""
    args = [t(a) for a in _case(4, 32, 8, seed=7)]
    u_head = args[4][:2].clone().requires_grad_(True)          # (H=2, K)
    u_flat = u_head[None].expand(2, 2, 8).reshape(4, 8)
    s0 = args[5].clone().requires_grad_(True)
    o, _ = W.wkv_apply(*args[:4], u_flat, s0)
    gu, gs0 = torch.autograd.grad(o.sum(), (u_head, s0))
    ref = [a.clone().requires_grad_(True) for a in (*args[:4], u_flat
                                                     .detach(), args[5])]
    o_r, _ = wkv_ref(*ref)
    want = torch.autograd.grad(o_r.sum(), ref)
    np.testing.assert_allclose(n(gu), n(want[4].reshape(2, 2, 8).sum(0)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(n(gs0), n(want[5]), rtol=1e-4, atol=1e-4)
    bnd = W.wkv_forward(*args, chunk=32)[2]
    no_dsT = W.wkv_backward(*args[:5], bnd, torch.ones(4, 32, 8), None,
                            chunk=32)
    zero_dsT = W.wkv_backward(*args[:5], bnd, torch.ones(4, 32, 8),
                              torch.zeros(4, 8, 8), chunk=32)
    for a, b in zip(no_dsT, zero_dsT):
        assert torch.equal(a, b)


def test_wkv_apply_rounds_do_to_r_dtype():
    """A float32 cotangent for a bf16 o is rounded to bf16 before the
    backward, as the reference rounds it: the gradients equal those of
    the rounded cotangent."""
    args = _case(2, 32, 16, seed=8)
    do = np.random.default_rng(9).normal(size=(2, 32, 16)).astype(np.float32)

    def grads(cot):
        leaves = [t(a, torch.bfloat16).requires_grad_(True) for a in args[:3]]
        leaves += [t(a).requires_grad_(True) for a in args[3:]]
        o, _ = W.wkv_apply(*leaves)
        return torch.autograd.grad(o, leaves, grad_outputs=cot)
    for a, b in zip(grads(t(do)), grads(t(do, torch.bfloat16))):
        assert torch.equal(a, b)


@pytest.mark.parametrize('bad', ['do_dtype', 'bnd_shape', 'dsT_dtype'])
def test_wkv_backward_checks_its_inputs(bad):
    r, k, v, w, u, s0 = map(t, _case(2, 16, 8, seed=3))
    bnd = W.wkv_forward(r, k, v, w, u, s0, chunk=8)[2]
    do, dsT, err = torch.ones_like(r), None, TypeError
    if bad == 'do_dtype':
        do = do.to(torch.bfloat16)
    elif bad == 'bnd_shape':
        bnd, err = bnd[:, :1], ValueError
    else:
        dsT = torch.zeros(2, 8, 8, dtype=torch.float64)
    with pytest.raises(err):
        W.wkv_backward(r, k, v, w, u, bnd, do, dsT, chunk=8)


@pytest.mark.parametrize('bad', ['dtype', 'w_dtype', 'shape', 'chunk'])
def test_wkv_forward_checks_its_inputs(bad):
    r, k, v, w, u, s0 = map(t, _case(2, 16, 8, seed=2))
    chunk = 8
    err = TypeError
    if bad == 'dtype':
        k = k.to(torch.bfloat16)
    elif bad == 'w_dtype':
        w = w.double()
    elif bad == 'shape':
        u, err = u[:, :4], ValueError
    else:
        chunk, err = 5, ValueError
    with pytest.raises(err):
        W.wkv_forward(r, k, v, w, u, s0, chunk=chunk)


def test_kernels_take_shapes_past_2_31_elements():
    """The launch check has no N*T*K limit: the prefill_32k cell at its
    global batch (N = 32 x 40 heads, T = 32768, K = 64: 2.7e9 elements)
    and the card test's 8200 x 4096 x 64 pass it (shapes only, on the
    meta device)."""
    for shape in ((1280, 32768, 64), (8200, 4096, 64)):
        r = torch.empty(shape, dtype=torch.bfloat16, device='meta')
        assert r.numel() >= 2 ** 31
        W._check_launch(r)
        W._check_launch(r, chunk=64)


@pytest.mark.parametrize('kk,chunk,ok', [(64, 64, True), (48, None, False),
                                         (64, 128, False)])
def test_launch_check_refuses_what_the_kernels_do_not_take(kk, chunk, ok):
    """K outside KERNEL_K, and chunks longer than the backward kernel's
    partial-sum buffer, raise before any launch."""
    r = torch.empty((2, 128, kk), dtype=torch.bfloat16, device='meta')
    if ok:
        W._check_launch(r, chunk)
    else:
        with pytest.raises(ValueError):
            W._check_launch(r, chunk)
