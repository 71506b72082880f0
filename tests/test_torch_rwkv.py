"""Port parity of the RWKV-6 serving path against the JAX package.

On `reduced('rwkv6-3b')` (2 layers, d = 64, 4 heads of 16), the JAX
package's initial parameters, with the zero-initialized `mu_*`, `w0` and
`u` overwritten by seeded random values (so the token-shift lerp, the
decay offset and the bonus are exercised), go to both packages: to the
port through `convert.lm_params_from_reference`. The port's
forward_train, forward_prefill and forward_decode are held against the
reference's on the same tokens, for both WKV routes.

Tolerances. Both packages stream activations in bf16, but they round at
different places: XLA keeps float32 across fused elementwise ops where
eager torch rounds after each op. Fed the same input, one block's output
differs by about one bf16 ulp of its scale (under 1% of the largest
value), and its float32 state by float32 noise (1e-5 of scale). Through
the whole model at these widths (the reference's init gives its layer
matrices std 1/sqrt(L), large gains) those differences grow to about
1.5% in relative norm, which is the size of the JAX package's own
difference between its two WKV routes on the same weights. So the model
outputs are held to 3% in relative norm and 5% of the largest value
elementwise (the reference's bar between its routes,
tests/test_wkv_kernel.py::test_rwkv_model_kernel_impl_matches_scan_impl).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import rwkv6_3b as j_rwkv6_3b  # noqa: E402
from repro.configs.base import (DECODE_32K, PREFILL_32K,  # noqa: E402
                                TRAIN_4K)
from repro.configs.reduced import reduced as j_reduced  # noqa: E402
from repro.distributed.sharding import NoSharding  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.models import rwkv6 as JR6  # noqa: E402
from repro.models.params import count_params as j_count  # noqa: E402
from repro.models.params import init_params as j_init  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models import rwkv6 as R6  # noqa: E402
from repro_torch.models.params import count_params  # noqa: E402
from torch_parity import n, t, torch_one_thread  # noqa: E402,F401

SHD = NoSharding()
IMPLS = ('scan', 'kernel')
B, S = 2, 32


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _close(a, b, rel=0.03, peak=0.05):
    a, b = n(a).astype(np.float32), n(b).astype(np.float32)
    assert a.shape == b.shape
    assert np.all(np.isfinite(a))
    assert _rel(a, b) < rel, _rel(a, b)
    err = float(np.abs(a - b).max())
    assert err <= peak * float(np.abs(b).max()), err


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope='module')
def pair():
    """(JAX params, port model, numpy float32 tree) on the same values."""
    cfg = j_reduced('rwkv6-3b')
    tree = jax.tree.map(_f32, j_init(JLM.model_defs(cfg),
                                     jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    lay = tree['layers']
    for blk in ('tm', 'cm'):
        for name in [k for k in lay[blk] if k.startswith('mu_')]:
            lay[blk][name] = rng.uniform(0, 1, lay[blk][name].shape)
    lay['tm']['w0'] = rng.uniform(-2, 1, lay['tm']['w0'].shape)
    lay['tm']['u'] = rng.normal(0, 0.5, lay['tm']['u'].shape)
    # round every leaf to bf16 once, so both packages hold equal values
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    tree = jax.tree.map(_f32, jparams)
    model = LM.from_state_dict(reduced('rwkv6-3b'),
                               convert.lm_params_from_reference(
                                   tree, device='cpu'))
    return jparams, model, tree


def _cfgs(impl):
    return (dataclasses.replace(j_reduced('rwkv6-3b'), wkv_impl=impl),
            dataclasses.replace(reduced('rwkv6-3b'), wkv_impl=impl))


def _tokens(seed, s=S):
    return np.random.default_rng(seed).integers(
        0, 512, size=(B, s)).astype(np.int32)


def test_configs_are_the_reference_copies():
    assert (dataclasses.asdict(reduced('rwkv6-3b'))
            == dataclasses.asdict(j_reduced('rwkv6-3b')))
    assert (dataclasses.asdict(registry.get('rwkv6-3b'))
            == dataclasses.asdict(j_rwkv6_3b.config()))
    assert TB.shapes_for(registry.get('rwkv6-3b'))[-1].name == 'long_500k'
    with pytest.raises(NotImplementedError, match='item 13\\(c\\)'):
        registry.get('jamba-1.5-large-398b')
    with pytest.raises(KeyError):
        registry.get('no-such-arch')


def test_count_params_matches_reference_at_full_width():
    full = registry.get('rwkv6-3b')
    assert (count_params(LM.model_defs(full))
            == j_count(JLM.model_defs(j_rwkv6_3b.config())) == 3073315840)


def test_init_follows_the_reference_rule():
    """Same leaves, shapes and fill rule as the reference's init_params,
    the stacked fan-in quirk included (std 1/sqrt(L) for a stacked
    matrix); the draws themselves differ (torch.Generator vs jax.random)."""
    cfg = reduced('rwkv6-3b')
    ref = jax.tree.map(_f32, j_init(JLM.model_defs(j_reduced('rwkv6-3b')),
                                    jax.random.PRNGKey(0)))
    ref_sd = convert.lm_params_from_reference(ref, device='cpu')
    sd = LM.init_model(cfg, seed=3, device='cpu').state_dict()
    assert sorted(sd) == sorted(ref_sd)
    for key, val in sd.items():
        want = ref_sd[key]
        assert val.shape == want.shape and val.dtype == torch.bfloat16
        if key.endswith(('mu_r', 'mu_k', 'mu_v', 'mu_w', 'mu_g', 'w0', '.u',
                         'scale')):
            assert torch.equal(val, want), key
    wr = torch.stack([sd[f'layers.{l}.tm.wr'] for l in range(2)]).float()
    assert abs(float(wr.std()) - 2 ** -0.5) < 0.05   # 1/sqrt(L), L = 2


@pytest.mark.parametrize('impl', IMPLS)
def test_blocks_match_reference(pair, impl):
    """One layer's blocks on the same bf16 input: outputs within 1% of
    their scale (about one bf16 ulp), the float32 state within 1e-5."""
    jparams, model, _ = pair
    cj, c = _cfgs(impl)
    lpj = jax.tree.map(lambda a: a[0], jparams['layers'])
    lp = model.layers[0]
    x = np.random.default_rng(1).normal(size=(B, S, 64)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    nj = JL.rmsnorm(lpj['ln1'], xj)
    with torch.no_grad():
        nt = TL.rmsnorm(lp.ln1, t(x, torch.bfloat16))
        np.testing.assert_array_equal(n(nt.float()), _f32(nj))
        oj, sj, lj = JR6.rwkv_time_mix(lpj['tm'], cj, nj, SHD)
        ot, st, lt = R6.rwkv_time_mix(lp.tm, c, nt)
        cmj, _ = JR6.rwkv_channel_mix(lpj['cm'], cj, nj)
        cmt, _ = lp.cm(nt)
    for a, b in ((ot, oj), (cmt, cmj)):
        a, b = n(a.float()), _f32(b)
        assert np.abs(a - b).max() <= 0.01 * np.abs(b).max()
    np.testing.assert_allclose(n(st), n(sj), rtol=1e-5,
                               atol=1e-5 * float(np.abs(n(sj)).max()))
    np.testing.assert_array_equal(n(lt.float()), _f32(lj))


@pytest.mark.parametrize('impl', IMPLS)
def test_forward_train_matches_reference(pair, impl):
    jparams, model, _ = pair
    cj, c = _cfgs(impl)
    toks = _tokens(10)
    hj = JLM.forward_train(jparams, cj, {'tokens': jnp.asarray(toks)}, SHD,
                           remat='none')
    with torch.no_grad():
        h = LM.forward_train(model, c, {'tokens': t(toks)})
    assert h.dtype == torch.bfloat16 and h.shape == (B, S, 64)
    _close(h.float(), _f32(hj))


@pytest.mark.parametrize('impl', IMPLS)
def test_forward_prefill_matches_reference(pair, impl):
    jparams, model, _ = pair
    cj, c = _cfgs(impl)
    toks = _tokens(11)
    cache_j, lg_j = JLM.forward_prefill(jparams, cj,
                                        {'tokens': jnp.asarray(toks)}, SHD)
    cache, lg = TS.make_prefill_step(c)(model, {'tokens': t(toks)})
    assert lg.dtype == torch.float32 and lg.shape == (B, 512)
    assert cache['s'].dtype == torch.float32
    assert cache['tm_last'].dtype == cache['cm_last'].dtype == torch.bfloat16
    for key in ('s', 'tm_last', 'cm_last'):
        _close(cache[key].float(), _f32(cache_j[key]))
    _close(lg, _f32(lg_j))


@pytest.mark.parametrize('impl', IMPLS)
def test_forward_decode_matches_reference(pair, impl):
    """One decode step of both packages from the reference's prefill
    cache, carried over by `convert.lm_cache_from_reference`."""
    jparams, model, _ = pair
    cj, c = _cfgs(impl)
    toks = _tokens(12)
    cache_j, _ = JLM.forward_prefill(
        jparams, cj, {'tokens': jnp.asarray(toks[:, :-1])}, SHD)
    pos = S - 1
    new_j, lg_j = JLM.forward_decode(
        jparams, cj, cache_j, {'tokens': jnp.asarray(toks[:, -1:])},
        jnp.asarray(pos, jnp.int32), SHD)
    cache = convert.lm_cache_from_reference(
        {k: _f32(v) for k, v in cache_j.items()}, device='cpu')
    new, lg = TS.make_decode_step(c)(model, cache, {'tokens': t(toks[:, -1:])},
                                     pos)
    for key in ('s', 'tm_last', 'cm_last'):
        _close(new[key].float(), _f32(new_j[key]))
    _close(lg, _f32(lg_j))


@pytest.mark.parametrize('impl', IMPLS)
def test_prefill_decode_matches_full_forward(pair, impl):
    """Within the port: prefill(s-1) + decode(1) logits equal the full
    forward's last-position logits (the bar of
    tests/test_models.py::test_prefill_decode_matches_full_forward)."""
    _, model, _ = pair
    _, c = _cfgs(impl)
    toks = t(_tokens(13))
    with torch.no_grad():
        hid = LM.forward_train(model, c, {'tokens': toks})
        full = hid[:, -1].float() @ LM.lm_head_weight(model, c).float()
    cache, _ = LM.forward_prefill(model, c, {'tokens': toks[:, :-1]})
    _, lg = LM.forward_decode(model, c, cache, {'tokens': toks[:, -1:]},
                              S - 1)
    assert float((lg - full).abs().max()) < 0.05


def test_module_forwards_are_the_functions(pair):
    _, model, _ = pair
    toks = t(_tokens(14))
    lay = model.layers[0]
    x = t(np.random.default_rng(2).normal(size=(B, S, 64)), torch.bfloat16)
    with torch.no_grad():
        assert torch.equal(model(toks),
                           LM.forward_train(model, model.cfg,
                                            {'tokens': toks}))
        for got, want in zip(lay(x), LM._rwkv_layer(lay, model.cfg, x)):
            assert torch.equal(got, want)
        nx = lay.ln1(x)
        assert torch.equal(nx, TL.rmsnorm(lay.ln1, x))
        for got, want in zip(lay.tm(nx),
                             R6.rwkv_time_mix(lay.tm, model.cfg, nx)):
            assert torch.equal(got, want)


def test_kernel_route_trains_like_the_scan_route(pair):
    """With autograd on, the kernel route runs through the WKV autograd
    function, with and without remat, and its gradients of the hidden
    states' sum agree with the scan route's as the JAX package's routes
    agree at this width (tools/rwkv_grad_gap.py: under 6% in relative
    norm per leaf at 2 layers, d = 256): within 15% per leaf."""
    _, model, _ = pair
    toks = t(_tokens(15, s=16))
    params = dict(model.named_parameters())
    grads = {}
    for impl, remat in (('kernel', 'layer'), ('kernel', 'none'),
                        ('scan', 'layer')):
        _, c = _cfgs(impl)
        hid = LM.forward_train(model, c, {'tokens': toks}, remat=remat)
        assert hid.requires_grad
        grads[impl, remat] = torch.autograd.grad(
            hid.float().sum(), list(params.values()), allow_unused=True,
            materialize_grads=True)
    for a, b in zip(grads['kernel', 'layer'], grads['kernel', 'none']):
        assert torch.equal(a, b)
    for name, a, b in zip(params, grads['kernel', 'layer'],
                          grads['scan', 'layer']):
        a, b = a.float(), b.float()
        if b.norm() > 0:
            assert float((a - b).norm() / b.norm()) < 0.15, name


def test_input_specs_match_reference():
    cfg, jcfg = registry.get('rwkv6-3b'), j_rwkv6_3b.config()
    for shape in (TRAIN_4K, PREFILL_32K, DECODE_32K):
        j_specs = JS.input_specs(jcfg, shape)
        specs = TS.input_specs(cfg, shape)
        j_flat = {'/'.join(str(getattr(k, 'key', k)) for k in path):
                  (tuple(v.shape), str(v.dtype))
                  for path, v in jax.tree_util.tree_flatten_with_path(
                      j_specs)[0]}
        flat = {}

        def walk(node, prefix):
            for key, val in node.items():
                if isinstance(val, dict):
                    walk(val, prefix + key + '/')
                else:
                    flat[prefix + key] = (tuple(val.shape),
                                          str(val.dtype).split('.')[-1])
        walk(specs, '')
        assert flat == j_flat


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    cfg = reduced('rwkv6-3b')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        LM.init_model(cfg)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        LM.init_cache(cfg, 2, 16)
    assert LM.init_cache(cfg, 2, 16, device='cpu')['s'].shape == (
        2, 2, 4, 16, 16)
