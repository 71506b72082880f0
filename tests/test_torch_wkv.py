"""Port parity of the WKV-6 forward op against the JAX package.

On the CPU the port's `wkv_forward` runs the plain version of its CUDA
kernel (`repro_torch/kernels/wkv/ref.py`); the JAX kernel runs through
the Pallas interpreter, as tests/test_wkv_kernel.py runs it. The same
seeded numpy inputs go to both, over the shapes of that file's sweep,
with its tolerances: 1e-4 on o, 1e-5 on the final and boundary states.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from repro.kernels.wkv import kernel as JK  # noqa: E402
from repro.kernels.wkv import ref as JR  # noqa: E402
from repro.kernels.wkv.ops import _pick_geometry  # noqa: E402
from repro.kernels.wkv.ops import wkv_apply as j_wkv_apply  # noqa: E402
from repro_torch.kernels.wkv import ops as W  # noqa: E402
from repro_torch.kernels.wkv.ref import wkv_ref  # noqa: E402
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


def test_wkv_forward_only_refuses_grad_inputs():
    r, k, v, w, u, s0 = map(t, _case(2, 16, 8, seed=1))
    r.requires_grad_(True)
    with pytest.raises(NotImplementedError, match='13\\(b\\)'):
        W.wkv_apply(r, k, v, w, u, s0)
    with torch.no_grad():
        o, _ = W.wkv_apply(r, k, v, w, u, s0)
    assert not o.requires_grad


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
