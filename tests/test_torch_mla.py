"""Port parity of multi-head latent attention (MLA) against the JAX
package.

`mla_attention` of `repro_torch.models.layers` against
`repro.models.layers.mla_attention` at the reduced deepseek-v2-lite-16b
width (d = 64, 4 heads of 16, kv_lora 32, rope 8), on the same numpy
inputs and the reference's initial parameters, in float32 and bf16:
prefill (causal, the cache at S = T) and decode (one position written
into a cache of fixed capacity, the step attending over it).

Two departures are held within the port, bit for bit:

* decode up-projects only the cached positions that its scan visits
  (the blocks of 2048 below the length), where the reference projects
  the whole capacity every step. The same step over the whole capacity,
  projected and masked in every block, must give the same bits;
* the values are not zero-padded to the keys' width (the reference pads
  them so that one attention call takes both): P.V's first head_dim
  columns must come out as the padded call's.

Bars, as in tests/test_torch_dense_lm.py and tests/test_torch_attention.py:
in bf16 outputs at 3% in relative norm and 5% of the largest value, the
cache entries (one projection deep) at 1% and 2%; in float32 within 1e-5
of their scale.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.reduced import reduced as j_reduced  # noqa: E402
from repro.distributed.sharding import NoSharding  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.params import init_params as j_init  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from torch_parity import n, t, torch_one_thread  # noqa: E402,F401

ARCH = 'deepseek-v2-lite-16b'
SHD = NoSharding()
MODEL_BARS = dict(rel=0.03, peak=0.05)
CACHE_BARS = dict(rel=0.01, peak=0.02)
F32_BAR = 1e-5
DTYPES = {'float32': (torch.float32, jnp.float32),
          'bfloat16': (torch.bfloat16, jnp.bfloat16)}
B = 2


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype, bars):
    got = n(got.float()).astype(np.float32)
    want = _f32(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    if dtype == 'float32':
        assert err <= F32_BAR * scale, (err, scale)
        return
    r = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert r < bars['rel'], r
    assert err <= bars['peak'] * scale, (err, scale)


def _setup(dtype, seed=0):
    """(reference params, port MLA module, port config, reference config)
    on the same values in `dtype`."""
    tdt, jdt = DTYPES[dtype]
    cfg, jcfg = reduced(ARCH), j_reduced(ARCH)
    jp = jax.tree.map(lambda a: jnp.asarray(_f32(a), jdt),
                      j_init(JL.mla_defs(jcfg), jax.random.PRNGKey(seed)))
    mod = TL.MLA(cfg, device='meta')
    mod.load_state_dict(convert.lm_params_from_reference(
        jax.tree.map(_f32, jp), device='cpu', dtype=tdt), assign=True)
    return jp, mod, cfg, jcfg


def _draw(dtype, shape, seed):
    """(jax array, torch tensor) of the same normal values in `dtype`."""
    tdt, jdt = DTYPES[dtype]
    j = jnp.asarray(np.random.default_rng(seed).normal(size=shape), jdt)
    return j, t(_f32(j), tdt)


@pytest.mark.parametrize('dtype', DTYPES)
def test_mla_prefill_matches_reference(dtype):
    """Causal prefill over T = 40: the output and this call's cache
    (the latent c_kv and the rope key)."""
    jp, mod, cfg, jcfg = _setup(dtype)
    tt = 40
    xj, xt = _draw(dtype, (B, tt, cfg.d_model), 1)
    pos = np.broadcast_to(np.arange(tt), (B, tt)).astype(np.int32)
    want, (ckv_j, kr_j) = JL.mla_attention(jp, jcfg, xj, jnp.asarray(pos),
                                           SHD)
    with torch.no_grad():
        got, (ckv, kr) = mod(xt, t(pos))
    assert got.dtype == xt.dtype and ckv.shape == (B, tt, cfg.mla_kv_lora)
    assert kr.shape == (B, tt, cfg.mla_rope_dim)
    _close(got, want, dtype, MODEL_BARS)
    _close(ckv, ckv_j, dtype, CACHE_BARS)
    _close(kr, kr_j, dtype, CACHE_BARS)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('capacity,pos', [(40, 39), (4500, 2100),
                                          (4500, 4499)])
def test_mla_decode_matches_reference(capacity, pos, dtype):
    """One decode step at `pos` of a cache of `capacity` positions holding
    seeded values: the output, and the cache with the new position
    written (the other positions unchanged). At 4500 the reference
    projects all three blocks of 2048; the port the two below pos = 2100,
    and all three at pos = 4499."""
    jp, mod, cfg, jcfg = _setup(dtype, seed=2)
    xj, xt = _draw(dtype, (B, 1, cfg.d_model), 3)
    cj, ct = _draw(dtype, (B, capacity, cfg.mla_kv_lora), 4)
    rj, rt = _draw(dtype, (B, capacity, cfg.mla_rope_dim), 5)
    positions = np.full((B, 1), pos, np.int32)
    want, (ckv_j, kr_j) = JL.mla_attention(
        jp, jcfg, xj, jnp.asarray(positions), SHD, cache=(cj, rj),
        cache_len=jnp.asarray(pos, jnp.int32), decode=True)
    with torch.no_grad():
        got, (ckv, kr) = mod(xt, t(positions), (ct, rt), pos, True)
    _close(got, want, dtype, MODEL_BARS)
    _close(ckv, ckv_j, dtype, CACHE_BARS)
    _close(kr, kr_j, dtype, CACHE_BARS)
    _close(ckv[:, pos], ckv_j[:, pos], dtype, CACHE_BARS)


def test_decode_writes_the_cache_in_place():
    """The step returns the caller's cache tensors with this position's
    latent and rope key (the projection's own) written at `pos`, nothing
    else changed; a position past the capacity raises."""
    _, mod, cfg, _ = _setup('bfloat16')
    _, xt = _draw('bfloat16', (B, 1, cfg.d_model), 6)
    _, ct = _draw('bfloat16', (B, 50, cfg.mla_kv_lora), 7)
    _, rt = _draw('bfloat16', (B, 50, cfg.mla_rope_dim), 8)
    before = (ct.clone(), rt.clone())
    positions = torch.full((B, 1), 17)
    with torch.no_grad():
        _, (ckv, kr) = mod(xt, positions, (ct, rt), 17, True)
        _, ckv_new, kr_new = TL.mla_project(mod, cfg, xt, positions)
    assert ckv is ct and kr is rt
    assert torch.equal(ct[:, 17], ckv_new[:, 0])
    assert torch.equal(rt[:, 17], kr_new[:, 0])
    for got, old in zip((ct, rt), before):
        keep = torch.ones(50, dtype=torch.bool)
        keep[17] = False
        assert torch.equal(got[:, keep], old[:, keep])
    with pytest.raises(ValueError, match='capacity'):
        mod(xt, positions, (ct, rt), 50, True)


@pytest.mark.parametrize('pos', [0, 2046, 2047, 2100, 4095, 5000])
def test_visited_blocks_equal_the_whole_capacity(pos):
    """Decode at `pos` in a cache of 5001 positions (three blocks of
    2048, the last short): the port's step, which projects the blocks
    below pos + 1, against the whole capacity projected and attended with
    the length masked in every block (a tensor `kv_len`, so no block is
    skipped). Bit for bit, in bf16."""
    _, mod, cfg, _ = _setup('bfloat16', seed=4)
    _, xt = _draw('bfloat16', (B, 1, cfg.d_model), 9)
    _, ct = _draw('bfloat16', (B, 5001, cfg.mla_kv_lora), 10)
    _, rt = _draw('bfloat16', (B, 5001, cfg.mla_rope_dim), 11)
    positions = torch.full((B, 1), pos)
    with torch.no_grad():
        got, _ = mod(xt, positions, (ct, rt), pos, True)
        q, _, _ = TL.mla_project(mod, cfg, xt, positions)
        k, v = TL.mla_keys_values(mod, cfg, ct, rt)
        out = TL.blockwise_attention(q, k, v, causal=False,
                                     kv_len=torch.tensor(pos + 1),
                                     block_kv=TL.DECODE_BLOCK)
        want = TL.mm(out.reshape(B, 1, -1), mod.wo)
    assert torch.equal(got, want)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('causal', [True, False])
def test_values_need_no_padding(causal, dtype):
    """blockwise_attention with values of head_dim columns gives the
    first head_dim columns of the call with values zero-padded to the
    keys' head_dim + rope width (the reference's `vpad`), bit for bit."""
    hd, rdim, h, s = 16, 8, 4, 300
    tt = s if causal else 1
    tdt = DTYPES[dtype][0]
    g = torch.Generator().manual_seed(12)
    q = torch.randn((B, tt, h, hd + rdim), generator=g).to(tdt)
    k = torch.randn((B, s, h, hd + rdim), generator=g).to(tdt)
    v = torch.randn((B, s, h, hd), generator=g).to(tdt)
    vpad = torch.nn.functional.pad(v, (0, rdim))
    kw = dict(causal=causal, block_kv=128,
              kv_len=None if causal else s - 7)
    got = TL.blockwise_attention(q, k, v, **kw)
    want = TL.blockwise_attention(q, k, vpad, **kw)
    assert got.shape == (B, tt, h, hd)
    assert torch.equal(got, want[..., :hd])
