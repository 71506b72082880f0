"""Port parity of the MoE LM family against the JAX package.

For `deepseek-v2-lite-16b` (MLA attention) and `moonshot-v1-16b-a3b`
(GQA attention), each with routed and shared experts and a dense layer
0, reduced as `configs/reduced.py` reduces them (3 layers: the dense
layer 0 of width 64 and two MoE layers of 4 experts top-2 with one
shared expert; d = 64, 4 heads of 16; MLA kv_lora 32, rope 8), the JAX
package's initial parameters go to both packages, to the port through
`convert.lm_params_from_reference` ('layer0' keys as they are). The
port's forward_train, forward_prefill and forward_decode are held to
the reference's on the same tokens, the decode from the reference's own
prefill cache carried over by `convert.lm_cache_from_reference` and
grown by `convert.pad_cache`.

Bars: those of tests/test_torch_dense_lm.py (model outputs 3% in
relative norm and 5% of the largest value, caches 1% and 2%), and
prefill(S-1) + decode(1) against the full forward within the reference's
own 0.05 (tests/test_models.py). The reduced configs drop no expert
choice (capacity factor 2.0 over 4 experts top-2), so prefill + decode
and the full forward route the same tokens to the same slots.

Two things decide whether the packages can be held to those bars:

* Init. The reference's fan-in rule reads a stacked matrix's leading
  axis, the layer count, so it draws the stacked layers' matrices (and
  the experts') at std 1/sqrt(2) here: the attention's softmax saturates
  and its bf16 rounding differences grow from 0.4% to 18% of the hidden
  states over the three layers (measured). As in
  tests/torch_train_parity.py, the layer matrices are scaled to std
  1/sqrt(fan-in) of one layer (the router keeps its own 0.02).
* Routing. Top-k is discrete: where a token's second and third router
  probabilities nearly tie, the packages' bf16 rounding differences in
  its input (0.6-1.1% in relative norm, measured) can swap its expert,
  which moves that token's output by a whole expert's. Each test records
  both packages' MoE inputs (the port's by forward pre-hooks, the
  reference's by `jax.debug.callback`), computes each package's choices
  with its own operations and asserts them equal in every MoE layer,
  with the reference's probabilities leaving a relative margin of at
  least LM_MARGIN = 1e-3 between each token's k-th and (k+1)-th. Over
  token seeds 0-11 (PRNGKey(0) weights) 5 of 12 route alike in each
  config, each of those inside the bars (forward_train's hidden states
  at most 1.3% in relative norm and 1.9% of the largest value); the
  seeds below are such seeds.
"""

import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.configs.reduced import reduced as j_reduced  # noqa: E402
from repro.distributed.sharding import NoSharding  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.models.params import count_params as j_count  # noqa: E402
from repro.models.params import init_params as j_init  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models.params import _items  # noqa: E402
from repro_torch.models.params import count_params  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from torch_parity import n, t, torch_one_thread  # noqa: E402,F401

SHD = NoSharding()
ARCHS = ('deepseek-v2-lite-16b', 'moonshot-v1-16b-a3b')
CACHE_KEYS = {'deepseek-v2-lite-16b': ('ckv', 'krope'),
              'moonshot-v1-16b-a3b': ('k', 'v')}
B, S = 2, 32
MODEL_BARS = dict(rel=0.03, peak=0.05)
CACHE_BARS = dict(rel=0.01, peak=0.02)
LM_MARGIN = 1e-3
# token seeds whose routing agrees in both packages (module docstring)
SEEDS = {'deepseek-v2-lite-16b': 1, 'moonshot-v1-16b-a3b': 5}


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(a, b, rel, peak):
    a, b = n(a).astype(np.float32), n(b).astype(np.float32)
    assert a.shape == b.shape
    assert np.all(np.isfinite(a))
    r = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    assert r < rel, r
    err = float(np.abs(a - b).max())
    assert err <= peak * float(np.abs(b).max()), err


def _cfgs(arch, impl='gather'):
    return (dataclasses.replace(reduced(arch), moe_impl=impl),
            dataclasses.replace(j_reduced(arch), moe_impl=impl))


_PAIRS = {}


def _fan_in(path, a):
    """A stacked layer matrix (L, ..., in, out) drawn at std 1/sqrt(L)
    scaled to std 1/sqrt(in); the router and the norms as they are."""
    if path[-1].key == 'router' or a.ndim < 3:
        return a
    return a * np.sqrt(a.shape[0] / a.shape[-2])


def _pair(arch):
    """(JAX params, port model) on the same bf16 values, made once per
    module run: the reference's init, its stacked layer matrices at a
    layer's fan-in."""
    if arch not in _PAIRS:
        tree = jax.tree.map(_f32, j_init(JLM.model_defs(j_reduced(arch)),
                                         jax.random.PRNGKey(0)))
        tree['layers'] = jax.tree_util.tree_map_with_path(_fan_in,
                                                          tree['layers'])
        jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
        model = LM.from_state_dict(reduced(arch),
                                   convert.lm_params_from_reference(
                                       jax.tree.map(_f32, jparams),
                                       device='cpu'))
        _PAIRS[arch] = (jparams, model)
    return _PAIRS[arch]


def _tokens(seed, s=S):
    toks = np.random.default_rng(seed).integers(0, 512, size=(B, s))
    return toks.astype(np.int32)


@contextlib.contextmanager
def _same_routing(monkeypatch, arch):
    """Records both packages' MoE-layer inputs for the calls made inside,
    then asserts that each layer routes every token to the same experts
    in both, the reference's margin at least LM_MARGIN."""
    jparams, model = _pair(arch)
    ref, port = [], []
    inner = JL.moe_ffn

    def record(p, cfg, x, shd):
        jax.debug.callback(lambda v: ref.append(np.asarray(v)),
                           x.astype(jnp.float32), ordered=True)
        return inner(p, cfg, x, shd)

    monkeypatch.setattr(JL, 'moe_ffn', record)
    hooks = [lp.ffn.register_forward_pre_hook(
        lambda mod, args: port.append((mod, args[0]))) for lp in model.layers]
    try:
        yield
        jax.effects_barrier()
    finally:
        for h in hooks:
            h.remove()
    k = model.cfg.moe.top_k
    assert len(ref) == len(port) > 0
    for i, (xr, (mod, xt)) in enumerate(zip(ref, port)):
        router = jparams['layers']['ffn']['router'][i % len(model.layers)]
        xr = jnp.asarray(xr, jnp.bfloat16).reshape(-1, xr.shape[-1])
        probs = jax.nn.softmax(jnp.einsum(
            'nd,de->ne', xr, router, preferred_element_type=jnp.float32))
        top = -np.sort(-np.asarray(probs), axis=-1)
        assert float(((top[:, k - 1] - top[:, k]) / top[:, k - 1]).min()) \
            >= LM_MARGIN
        with torch.no_grad():
            _, idx, _, _, _ = TL.moe_route(mod, mod.cfg,
                                           xt.reshape(-1, xt.shape[-1]))
        want = np.sort(np.asarray(jax.lax.top_k(probs, k)[1]), axis=1)
        assert np.array_equal(np.sort(n(idx), axis=1), want), i


def _pad(a, extra):
    """A reference cache entry (L, B, T, ...) grown by `extra` zero
    positions."""
    widths = [(0, 0)] * a.ndim
    widths[2] = (0, extra)
    return jnp.pad(a, widths)


def test_configs_are_the_reference_copies():
    for arch in ARCHS:
        assert (dataclasses.asdict(registry.get(arch))
                == dataclasses.asdict(j_registry.get(arch)))
        assert (dataclasses.asdict(reduced(arch))
                == dataclasses.asdict(j_reduced(arch)))


@pytest.mark.parametrize('arch,size', [('deepseek-v2-lite-16b', 15.706e9),
                                       ('moonshot-v1-16b-a3b', 28.387e9)])
def test_count_params_matches_reference_at_full_width(arch, size):
    got = count_params(LM.model_defs(registry.get(arch)))
    assert got == j_count(JLM.model_defs(j_registry.get(arch)))
    assert abs(got - size) < 5e5


@pytest.mark.parametrize('arch', ARCHS)
def test_layer0_is_declared_apart(arch):
    """A dense layer 0 (MLP of width `dense_d_ff_first`) before the L-1
    stacked MoE layers, in the declarations, the module and its keys,
    as in the reference; the forwards run it first."""
    cfg = reduced(arch)
    defs = LM.model_defs(cfg)
    assert sorted(defs) == sorted(JLM.model_defs(j_reduced(arch)))
    assert defs['layer0']['ffn']['w1'].shape == (64, 64)
    assert defs['layers']['ffn']['w1'].shape == (2, 4, 64, 32)
    _, model = _pair(arch)
    assert isinstance(model.layer0.ffn, TL.MLP) and len(model.layers) == 2
    assert all(isinstance(lp.ffn, TL.MoE) for lp in model.layers)
    assert isinstance(model.layer0.attn,
                      TL.MLA if cfg.attn == 'mla' else TL.Attention)
    assert LM.all_layers(model) == [model.layer0, *model.layers]
    assert 'layer0.ffn.w1' in model.state_dict()
    assert 'layers.1.ffn.shared.w3' in model.state_dict()


@pytest.mark.parametrize('arch', ARCHS)
def test_forward_train_matches_reference(arch, monkeypatch):
    jparams, model = _pair(arch)
    cfg, jcfg = _cfgs(arch)
    toks = _tokens(SEEDS[arch])
    with _same_routing(monkeypatch, arch), torch.no_grad():
        hj = JLM.forward_train(jparams, jcfg, {'tokens': jnp.asarray(toks)},
                               SHD, remat='none')
        h = LM.forward_train(model, cfg, {'tokens': t(toks)})
    assert h.dtype == torch.bfloat16 and h.shape == (B, S, cfg.d_model)
    _close(h.float(), _f32(hj), **MODEL_BARS)


@pytest.mark.parametrize('arch', ARCHS)
def test_forward_prefill_matches_reference(arch, monkeypatch):
    """Logits and the cache: (L, B, S, lora) and (L, B, S, r) for MLA,
    (L, B, S, G, hd) keys and values for GQA, layer 0's first."""
    jparams, model = _pair(arch)
    cfg, jcfg = _cfgs(arch)
    toks = _tokens(SEEDS[arch])
    with _same_routing(monkeypatch, arch):
        cache_j, lg_j = JLM.forward_prefill(
            jparams, jcfg, {'tokens': jnp.asarray(toks)}, SHD)
        cache, lg = TS.make_prefill_step(cfg)(model, {'tokens': t(toks)})
    assert lg.dtype == torch.float32 and lg.shape == (B, 512)
    assert sorted(cache) == sorted(CACHE_KEYS[arch])
    specs = LM.cache_struct(cfg, B, S)
    for key in CACHE_KEYS[arch]:
        assert cache[key].dtype == torch.bfloat16
        assert tuple(cache[key].shape) == specs[key].shape
        _close(cache[key].float(), _f32(cache_j[key]), **CACHE_BARS)
    _close(lg, _f32(lg_j), **MODEL_BARS)


@pytest.mark.parametrize('arch', ARCHS)
def test_forward_decode_matches_reference(arch, monkeypatch):
    """One decode step of both packages at position S-1 of an S-slot
    cache, from the reference's prefill of the first S-1 positions
    (carried over and padded by `convert`), written in place."""
    jparams, model = _pair(arch)
    cfg, jcfg = _cfgs(arch)
    toks = _tokens(SEEDS[arch])
    cache_j, _ = JLM.forward_prefill(
        jparams, jcfg, {'tokens': jnp.asarray(toks[:, :-1])}, SHD)
    cache = convert.pad_cache(convert.lm_cache_from_reference(
        {k: _f32(v) for k, v in cache_j.items()}, device='cpu'), S)
    cache_j = {k: _pad(v, 1) for k, v in cache_j.items()}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    with _same_routing(monkeypatch, arch):
        new_j, lg_j = JLM.forward_decode(
            jparams, jcfg, cache_j, {'tokens': jnp.asarray(toks[:, -1:])},
            jnp.asarray(S - 1, jnp.int32), SHD)
        new, lg = TS.make_decode_step(cfg)(model, cache, {'tokens': t(
            toks[:, -1:])}, S - 1)
    assert new is cache
    assert {k: v.data_ptr() for k, v in new.items()} == ptrs
    for key in CACHE_KEYS[arch]:
        _close(new[key].float(), _f32(new_j[key]), **CACHE_BARS)
    _close(lg, _f32(lg_j), **MODEL_BARS)


@pytest.mark.parametrize('arch', ARCHS)
def test_prefill_decode_matches_full_forward(arch):
    """Within the port: prefill(S-1) + decode(1) logits equal the full
    forward's last-position logits within 0.05, and two more decode
    steps leave the positions before them untouched."""
    _, model = _pair(arch)
    cfg = reduced(arch)
    toks = t(_tokens(13))
    with torch.no_grad():
        want = LM._last_logits(model, cfg, LM.forward_train(
            model, cfg, {'tokens': toks}))
    cache, _ = LM.forward_prefill(model, cfg, {'tokens': toks[:, :-1]})
    cache = convert.pad_cache(cache, S + 2)
    first = CACHE_KEYS[arch][0]
    kept = cache[first][:, :, :S - 1].clone()
    _, lg = LM.forward_decode(model, cfg, cache, {'tokens': toks[:, -1:]},
                              S - 1)
    assert float((lg - want).abs().max()) < 0.05
    for pos in (S, S + 1):
        cache, lg = LM.forward_decode(model, cfg, cache,
                                      {'tokens': toks[:, -1:]}, pos)
        assert bool(torch.isfinite(lg).all())
    assert torch.equal(cache[first][:, :, :S - 1], kept)


def test_expert_parallel_impl_serves_without_a_mesh(monkeypatch):
    """moe_impl='ep' runs `moe_ffn` in both packages without a mesh (the
    reference's `moe_ffn_ep` falls back to it): prefill logits within the
    bars, and the port's equal to its 'gather' model's bit for bit."""
    arch = 'deepseek-v2-lite-16b'
    jparams, model = _pair(arch)
    cfg, jcfg = _cfgs(arch, impl='ep')
    toks = _tokens(SEEDS[arch])
    with _same_routing(monkeypatch, arch):
        _, lg_j = JLM.forward_prefill(jparams, jcfg,
                                      {'tokens': jnp.asarray(toks)}, SHD)
        _, lg = LM.forward_prefill(model, cfg, {'tokens': t(toks)})
    _, lg_gather = LM.forward_prefill(model, reduced(arch),
                                      {'tokens': t(toks)})
    assert torch.equal(lg, lg_gather)
    _close(lg, _f32(lg_j), **MODEL_BARS)


def test_pad_cache_on_an_mla_cache():
    cfg = reduced('deepseek-v2-lite-16b')
    cache = LM.init_cache(cfg, 2, 5, device='cpu')
    assert sorted(cache) == ['ckv', 'krope']
    cache['ckv'].normal_()
    cache['krope'].normal_()
    grown = convert.pad_cache(cache, 9)
    assert grown['ckv'].shape == (3, 2, 9, 32)
    assert grown['krope'].shape == (3, 2, 9, 8)
    for key in ('ckv', 'krope'):
        assert torch.equal(grown[key][:, :, :5], cache[key])
        assert not grown[key][:, :, 5:].any()
    with pytest.raises(ValueError, match='capacity'):
        convert.pad_cache(cache, 4)


def test_init_scales_in_place_bit_for_bit():
    """`init_params` scales each normal leaf in place (one float32
    transient a leaf); the values are bit for bit the out-of-place
    rule's, leaf by leaf in sorted-key order from one generator."""
    defs = LM.model_defs(reduced('deepseek-v2-lite-16b'))
    got = init_params(defs, torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    for path, d in _items(defs):
        leaf = got
        for key in path:
            leaf = leaf[key]
        if d.init != 'normal':
            continue
        fan_in = d.shape[0] if len(d.shape) >= 2 else max(d.shape[-1], 1)
        scale = d.scale if d.scale is not None else 1.0 / np.sqrt(fan_in)
        want = (torch.randn(d.shape, generator=gen, dtype=torch.float32)
                * scale).to(torch.bfloat16)
        assert torch.equal(leaf, want), path
