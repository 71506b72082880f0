"""Port parity of the attention building blocks against the JAX package.

`rope`, `blockwise_attention`, `gqa_attention` (prefill and decode, with
and without the QKV bias, one and several query heads per KV head) and
`mlp` (both activations) of `repro_torch.models.layers` against
`repro.models.layers` on the same numpy inputs, in float32 and in bf16.
The reference takes its keys and values repeated to the query heads
(`_repeat_kv`); the port takes them grouped, as its model does.

Bars. In float32 the two packages sum the same exact products in
another order: outputs within 1e-5 of their scale (the largest absolute
value of the reference's output). In bf16 the outputs are rounded to
bf16 after float32 sums that differ in their last bits, and the
projections round once more: a rounding boundary between the two sums
moves an element by one bf16 ulp (2^-8 relative, 2^-7 at the bottom of a
binade), which the bf16 bars allow, as 2^-7 of the output's scale for a
single rounding and 2^-5 after the projections and RoPE stack three.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.reduced import reduced as j_reduced  # noqa: E402
from repro.distributed.sharding import NoSharding  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from torch_parity import n, t, torch_one_thread  # noqa: E402,F401

SHD = NoSharding()
F32_BAR = 1e-5
BF16_BAR = 2.0 ** -7
BF16_STACK_BAR = 2.0 ** -5
DTYPES = {'float32': (torch.float32, jnp.float32),
          'bfloat16': (torch.bfloat16, jnp.bfloat16)}


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(a, dtype):
    """(jax array, torch tensor) holding the same values in `dtype`:
    rounded to it once, on the JAX side, so both start equal."""
    tdt, jdt = DTYPES[dtype]
    j = jnp.asarray(np.asarray(a, np.float32), jdt)
    return j, t(_f32(j), tdt)


def _assert_close(got, want, bar):
    got = n(got.float() if torch.is_tensor(got) else got).astype(np.float32)
    want = _f32(want)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= bar * scale, (err, scale, err / scale)


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('theta,d', [(10000.0, 16), (1e6, 128),
                                     (75000.0, 192)])
def test_rope_matches_reference(theta, d, dtype):
    """Positions up to 32767, the decode cell's capacity."""
    rng = _rng(0)
    xj, xt = _pair(rng.normal(size=(2, 9, 3, d)), dtype)
    pos = np.stack([np.arange(9), 32767 - np.arange(9)]).astype(np.int32)
    want = JL.rope(xj, jnp.asarray(pos), theta)
    got = TL.rope(xt, t(pos), theta)
    assert got.dtype == xt.dtype
    _assert_close(got, want, F32_BAR if dtype == 'float32' else BF16_BAR)


# (B, T, S, H, G, D, block, causal, q_offset, kv_len): S not a multiple of
# the block, causal from 0 and from an offset (T < S), a decode step
# masked at kv_len with blocks wholly past it, and D = 128, whose scale
# 128^-0.5 is not a bf16 number.
ATTN_CASES = [
    (2, 40, 40, 4, 4, 16, 16, True, 0, None),
    (2, 40, 40, 4, 1, 16, 16, True, 0, None),
    (2, 8, 40, 8, 2, 16, 16, True, 32, None),
    (2, 1, 64, 4, 1, 16, 16, False, 0, 37),
    (2, 1, 64, 8, 2, 128, 16, False, 0, 17),
    (1, 24, 24, 2, 2, 128, 1024, True, 0, None),
]


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('case', ATTN_CASES)
def test_blockwise_attention_matches_reference(case, dtype):
    b, tt, s, h, g, d, blk, causal, q_off, kv_len = case
    rng = _rng(1)
    qj, qt = _pair(rng.normal(size=(b, tt, h, d)) * 2, dtype)
    kj, kt = _pair(rng.normal(size=(b, s, g, d)) * 2, dtype)
    vj, vt = _pair(rng.normal(size=(b, s, g, d)), dtype)
    rep = h // g
    want = JL.blockwise_attention(
        qj, JL._repeat_kv(kj, rep), JL._repeat_kv(vj, rep), causal=causal,
        q_offset=q_off, block_kv=blk, kv_len=kv_len)
    got = TL.blockwise_attention(qt, kt, vt, causal=causal, q_offset=q_off,
                                 block_kv=blk, kv_len=kv_len)
    assert got.dtype == qt.dtype and got.shape == (b, tt, h, d)
    _assert_close(got, want, F32_BAR if dtype == 'float32' else BF16_BAR)


@pytest.mark.parametrize('dtype', DTYPES)
def test_skipping_blocks_past_kv_len_is_bit_identical(dtype):
    """kv_len as an int stops the scan at the last block below it; as a
    tensor every block is visited and masked. The results are equal bit
    for bit, so skipping changes nothing but the work."""
    rng = _rng(2)
    tdt, _ = DTYPES[dtype]
    q = t(rng.normal(size=(2, 1, 8, 32)), tdt)
    k = t(rng.normal(size=(2, 256, 2, 32)), tdt)
    v = t(rng.normal(size=(2, 256, 2, 32)), tdt)
    for kv_len in (1, 63, 64, 65, 200, 256):
        skip = TL.blockwise_attention(q, k, v, causal=False, block_kv=64,
                                      kv_len=kv_len)
        full = TL.blockwise_attention(q, k, v, causal=False, block_kv=64,
                                      kv_len=torch.tensor(kv_len))
        assert torch.equal(skip, full), kv_len


def test_grouped_heads_equal_repeated_heads():
    """The port's grouping of query heads over KV heads is the
    reference's `_repeat_kv` layout: attending over the repeated keys
    (G = H) gives the grouped result (the same sums, batched another
    way: within float32 noise)."""
    rng = _rng(3)
    q = t(rng.normal(size=(2, 12, 8, 16)), torch.float32)
    k = t(rng.normal(size=(2, 12, 2, 16)), torch.float32)
    v = t(rng.normal(size=(2, 12, 2, 16)), torch.float32)
    np.testing.assert_array_equal(
        n(TL._repeat_kv(k, 4)), np.asarray(JL._repeat_kv(jnp.asarray(n(k)),
                                                         4)))
    grouped = TL.blockwise_attention(q, k, v, causal=True, block_kv=5)
    repeated = TL.blockwise_attention(q, TL._repeat_kv(k, 4),
                                      TL._repeat_kv(v, 4), causal=True,
                                      block_kv=5)
    torch.testing.assert_close(grouped, repeated, rtol=0, atol=1e-6)


def _attn_cfgs(arch, bias):
    """(reference cfg, port cfg) of a reduced arch with qkv_bias set."""
    return (dataclasses.replace(j_reduced(arch), qkv_bias=bias),
            dataclasses.replace(reduced(arch), qkv_bias=bias))


def _attn_params(cfg, dtype, seed):
    """(reference dict, port module) on the same random values; the
    biases are drawn too (their init is zeros)."""
    rng = _rng(seed)
    jd, mod = {}, TL.Attention(cfg, device='cpu')
    for name, d in TL.attention_defs(cfg).items():
        scale = 0.5 if name.startswith('b') else d.shape[0] ** -0.5
        jd[name], val = _pair(rng.normal(size=d.shape) * scale, dtype)
        getattr(mod, name).data = val
    return jd, mod


# qwen2.5-3b reduced, with its QKV bias: 4 query heads over 1 KV head;
# musicgen-medium, no bias: 4 over 4.
GQA_CASES = [('qwen2.5-3b', True), ('musicgen-medium', False)]


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('arch,bias', GQA_CASES)
def test_gqa_attention_prefill_matches_reference(arch, bias, dtype):
    cj, c = _attn_cfgs(arch, bias)
    jp, mod = _attn_params(c, dtype, 4)
    xj, xt = _pair(_rng(5).normal(size=(2, 20, c.d_model)), dtype)
    pos = np.broadcast_to(np.arange(20), (2, 20)).astype(np.int32)
    out_j, (k_j, v_j) = JL.gqa_attention(jp, cj, xj, jnp.asarray(pos), SHD)
    with torch.no_grad():
        out, (k, v) = TL.gqa_attention(mod, c, xt, t(pos))
    bar = F32_BAR if dtype == 'float32' else BF16_STACK_BAR
    for got, want in ((out, out_j), (k, k_j), (v, v_j)):
        assert got.dtype == xt.dtype
        _assert_close(got, want, bar)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('arch,bias', GQA_CASES)
def test_gqa_attention_decode_matches_reference(arch, bias, dtype):
    """One decode step at position 13 of a 32-slot cache whose first 13
    positions hold keys and values: the output, and the whole cache after
    the step (the reference's functional update, the port's in place)."""
    cj, c = _attn_cfgs(arch, bias)
    jp, mod = _attn_params(c, dtype, 6)
    rng = _rng(7)
    g, hd, pos = c.n_kv_heads, c.head_dim, 13
    ck = np.zeros((2, 32, g, hd), np.float32)
    cv = np.zeros((2, 32, g, hd), np.float32)
    ck[:, :pos] = rng.normal(size=(2, pos, g, hd))
    cv[:, :pos] = rng.normal(size=(2, pos, g, hd))
    ckj, ckt = _pair(ck, dtype)
    cvj, cvt = _pair(cv, dtype)
    xj, xt = _pair(rng.normal(size=(2, 1, c.d_model)), dtype)
    positions = np.full((2, 1), pos, np.int32)
    out_j, (nk_j, nv_j) = JL.gqa_attention(
        jp, cj, xj, jnp.asarray(positions), SHD, cache_kv=(ckj, cvj),
        cache_len=jnp.asarray(pos, jnp.int32), decode=True)
    with torch.no_grad():
        out, (nk, nv) = TL.gqa_attention(mod, c, xt, t(positions),
                                         cache_kv=(ckt, cvt), cache_len=pos,
                                         decode=True)
    assert nk is ckt and nv is cvt
    bar = F32_BAR if dtype == 'float32' else BF16_STACK_BAR
    _assert_close(out, out_j, bar)
    for got, want in ((nk, nk_j), (nv, nv_j)):
        _assert_close(got, want, bar)
        np.testing.assert_array_equal(n(got[:, :pos].float()),
                                      _f32(want)[:, :pos])
        assert not n(got[:, pos + 1:].float()).any()


@pytest.mark.parametrize('dtype', DTYPES)
def test_cache_write_in_place_equals_the_functional_update(dtype):
    """The decode step's in-place write leaves the cache equal, bit for
    bit, to the reference's `dynamic_update_slice` of the old cache with
    the step's key and value (those of a prefill call on the same token
    at the same position), and allocates no new cache."""
    _, c = _attn_cfgs('qwen2.5-3b', True)
    _, mod = _attn_params(c, dtype, 8)
    rng = _rng(9)
    tdt, jdt = DTYPES[dtype]
    g, hd, pos = c.n_kv_heads, c.head_dim, 21
    ck = t(rng.normal(size=(2, 40, g, hd)), tdt)
    cv = t(rng.normal(size=(2, 40, g, hd)), tdt)
    old_k, old_v = ck.clone(), cv.clone()
    ptrs = (ck.data_ptr(), cv.data_ptr())
    x = t(rng.normal(size=(2, 1, c.d_model)), tdt)
    positions = torch.full((2, 1), pos)
    with torch.no_grad():
        _, (k_new, v_new) = TL.gqa_attention(mod, c, x, positions)
        _, (nk, nv) = TL.gqa_attention(mod, c, x, positions,
                                       cache_kv=(ck, cv), cache_len=pos,
                                       decode=True)
    assert (nk.data_ptr(), nv.data_ptr()) == ptrs
    for got, old, new in ((nk, old_k, k_new), (nv, old_v, v_new)):
        want = jax.lax.dynamic_update_slice(
            jnp.asarray(n(old.float()), jdt), jnp.asarray(n(new.float()), jdt),
            (0, pos, 0, 0))
        np.testing.assert_array_equal(n(got.float()), _f32(want))


def test_decode_past_the_capacity_raises():
    _, c = _attn_cfgs('qwen2.5-3b', False)
    _, mod = _attn_params(c, 'float32', 10)
    ck = torch.zeros((1, 8, c.n_kv_heads, c.head_dim))
    with pytest.raises(ValueError, match='capacity'):
        TL.gqa_attention(mod, c, torch.zeros((1, 1, c.d_model)),
                         torch.full((1, 1), 8), cache_kv=(ck, ck.clone()),
                         cache_len=8, decode=True)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('act', ['swiglu', 'sq_relu'])
def test_mlp_matches_reference(act, dtype):
    cj = dataclasses.replace(j_reduced('qwen2.5-3b'), act=act)
    c = dataclasses.replace(reduced('qwen2.5-3b'), act=act)
    rng = _rng(11)
    jp, mod = {}, TL.MLP(c, device='cpu')
    for name, d in TL.mlp_defs(c).items():
        jp[name], val = _pair(rng.normal(size=d.shape) * d.shape[0] ** -0.5,
                              dtype)
        getattr(mod, name).data = val
    assert sorted(jp) == sorted(JL.mlp_defs(cj))
    xj, xt = _pair(rng.normal(size=(2, 10, c.d_model)), dtype)
    want = JL.mlp(jp, cj, xj, SHD)
    with torch.no_grad():
        got = mod(xt)
    assert got.dtype == xt.dtype
    _assert_close(got, want,
                  F32_BAR if dtype == 'float32' else BF16_STACK_BAR)


def test_defs_match_reference():
    """Same leaves, shapes, axes and fill rules as the reference's
    declarations, with and without the bias and for both activations."""
    for arch in ('qwen2.5-3b', 'musicgen-medium', 'nemotron-4-340b'):
        cj, c = j_reduced(arch), reduced(arch)
        for tdefs, jdefs in ((TL.attention_defs(c), JL.attention_defs(cj)),
                             (TL.mlp_defs(c), JL.mlp_defs(cj))):
            assert sorted(tdefs) == sorted(jdefs)
            for name, d in tdefs.items():
                jd = jdefs[name]
                assert (d.shape, d.axes, d.init, d.scale) == (
                    jd.shape, jd.axes, jd.init, jd.scale), (arch, name)


def test_module_forwards_are_the_functions():
    _, c = _attn_cfgs('qwen2.5-3b', True)
    _, mod = _attn_params(c, 'bfloat16', 12)
    x = t(_rng(13).normal(size=(2, 6, c.d_model)), torch.bfloat16)
    positions = torch.arange(6).expand(2, 6)
    with torch.no_grad():
        got, (k, v) = mod(x, positions)
        want, (k2, v2) = TL.gqa_attention(mod, c, x, positions)
    assert torch.equal(got, want) and torch.equal(k, k2)
    assert torch.equal(v, v2)
