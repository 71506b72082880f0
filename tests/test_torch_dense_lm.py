"""Port parity of the dense-attention LM family against the JAX package.

For each of the six dense configs (`qwen2.5-3b`, `minicpm-2b`,
`command-r-plus-104b`, `nemotron-4-340b`, the vision `internvl2-26b` and
the audio `musicgen-medium`), reduced as `configs/reduced.py` reduces
them (2 layers, d = 64, 4 heads of 16; 1 or 4 KV heads), the JAX
package's initial parameters, with the zero-initialized QKV biases drawn
at random where the config has them, go to both packages: to the port
through `convert.lm_params_from_reference`. The port's forward_train,
forward_prefill and forward_decode are held against the reference's on
the same inputs (tokens, image embeddings or audio frames), the decode
from the reference's own prefill cache carried over by
`convert.lm_cache_from_reference` and grown by `convert.pad_cache`.

Tolerances, as in tests/test_torch_rwkv.py: both packages stream bf16
activations but round at different places (XLA keeps float32 across
fused elementwise ops, eager torch rounds after each op), and the
reference's init gives its layer matrices std 1/sqrt(L). Model outputs
(hidden states, logits) are held to 3% in relative norm and 5% of the
largest value elementwise; measured here, at most 1.6% and 3.1%. The
cache (keys after RoPE and values, one layer's projections deep) is held
to 1% and 2% (measured at most 0.5% and 0.9%). Within the port,
prefill(S-1) + decode(1) must give the full forward's last logits within
the reference's own bar (tests/test_models.py, 0.05 absolute).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.configs.base import (DECODE_32K, PREFILL_32K,  # noqa: E402
                                TRAIN_4K)
from repro.configs.reduced import reduced as j_reduced  # noqa: E402
from repro.distributed.sharding import NoSharding  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.models.params import count_params as j_count  # noqa: E402
from repro.models.params import init_params as j_init  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import MoEConfig, TrainConfig  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models.params import count_params  # noqa: E402
from repro_torch.train.trainer import make_train_step  # noqa: E402
from torch_parity import n, t, torch_one_thread  # noqa: E402,F401

SHD = NoSharding()
ARCHS = ('qwen2.5-3b', 'minicpm-2b', 'command-r-plus-104b',
         'nemotron-4-340b', 'internvl2-26b', 'musicgen-medium')
MOE_ARCHS = ('deepseek-v2-lite-16b', 'moonshot-v1-16b-a3b')
UNPORTED = ('jamba-1.5-large-398b', 'ranksvm-linear')
B, S = 2, 32
MODEL_BARS = dict(rel=0.03, peak=0.05)
CACHE_BARS = dict(rel=0.01, peak=0.02)


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


_PAIRS = {}


def _pair(arch):
    """(JAX params, port model, port config) on the same bf16 values,
    made once per module run."""
    if arch not in _PAIRS:
        tree = jax.tree.map(_f32, j_init(JLM.model_defs(j_reduced(arch)),
                                         jax.random.PRNGKey(0)))
        rng = np.random.default_rng(0)
        attn = tree['layers']['attn']
        for name in ('bq', 'bk', 'bv'):
            if name in attn:
                attn[name] = rng.normal(0, 0.5, attn[name].shape)
        jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
        cfg = reduced(arch)
        model = LM.from_state_dict(cfg, convert.lm_params_from_reference(
            jax.tree.map(_f32, jparams), device='cpu'))
        _PAIRS[arch] = (jparams, model, cfg)
    return _PAIRS[arch]


def _inputs(cfg, seed, s=S):
    """(full batch, prefix batch of s-1 positions, last position's decode
    batch), numpy, for the config's frontend."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == 'audio':
        fe = rng.normal(size=(B, s, cfg.d_model)).astype(np.float32)
        return ({'frame_embeds': fe}, {'frame_embeds': fe[:, :-1]},
                {'frame_embeds': fe[:, -1:]})
    if cfg.frontend == 'vision':
        f = cfg.frontend_tokens
        toks = rng.integers(0, cfg.vocab, size=(B, s - f)).astype(np.int32)
        img = rng.normal(size=(B, f, cfg.d_model)).astype(np.float32)
        return ({'tokens': toks, 'image_embeds': img},
                {'tokens': toks[:, :-1], 'image_embeds': img},
                {'tokens': toks[:, -1:]})
    toks = rng.integers(0, cfg.vocab, size=(B, s)).astype(np.int32)
    return {'tokens': toks}, {'tokens': toks[:, :-1]}, {'tokens': toks[:, -1:]}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: t(v) for k, v in batch.items()}


def test_configs_are_the_reference_copies():
    for arch in ARCHS:
        assert (dataclasses.asdict(registry.get(arch))
                == dataclasses.asdict(j_registry.get(arch)))
        assert (dataclasses.asdict(reduced(arch))
                == dataclasses.asdict(j_reduced(arch)))
    assert set(registry.ARCHS) == (set(ARCHS) | set(MOE_ARCHS)
                                   | {'rwkv6-3b'})
    assert set(registry.ARCHS) | registry.UNPORTED == (
        set(j_registry.ARCHS) | set(j_registry.EXTRA_ARCHS))
    for arch in UNPORTED:
        with pytest.raises(NotImplementedError, match='item 13\\(c\\)'):
            registry.get(arch)


@pytest.mark.parametrize('arch', ARCHS)
def test_count_params_matches_reference_at_full_width(arch):
    assert (count_params(LM.model_defs(registry.get(arch)))
            == j_count(JLM.model_defs(j_registry.get(arch))))


def test_qwen_full_width_size():
    """qwen2.5-3b: 3.086e9 parameters (vocab padded to 152064, tied)."""
    cfg = registry.get('qwen2.5-3b')
    assert LM.padded_vocab(cfg) == 152064
    assert count_params(LM.model_defs(cfg)) == 3086202880


@pytest.mark.parametrize('arch', ARCHS)
def test_forward_train_matches_reference(arch):
    jparams, model, cfg = _pair(arch)
    full, _, _ = _inputs(cfg, 10)
    hj = JLM.forward_train(jparams, j_reduced(arch), _j(full), SHD,
                           remat='none')
    with torch.no_grad():
        h = LM.forward_train(model, cfg, _t(full))
    assert h.dtype == torch.bfloat16 and h.shape == (B, S, cfg.d_model)
    _close(h.float(), _f32(hj), **MODEL_BARS)


@pytest.mark.parametrize('arch', ARCHS)
def test_forward_prefill_matches_reference(arch):
    jparams, model, cfg = _pair(arch)
    full, _, _ = _inputs(cfg, 11)
    cache_j, lg_j = JLM.forward_prefill(jparams, j_reduced(arch), _j(full),
                                        SHD)
    cache, lg = TS.make_prefill_step(cfg)(model, _t(full))
    assert lg.dtype == torch.float32 and lg.shape == (B, 512)
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    assert sorted(cache) == ['k', 'v']
    for key in ('k', 'v'):
        assert cache[key].dtype == torch.bfloat16
        assert tuple(cache[key].shape) == shape
        _close(cache[key].float(), _f32(cache_j[key]), **CACHE_BARS)
    _close(lg, _f32(lg_j), **MODEL_BARS)


@pytest.mark.parametrize('arch', ARCHS)
def test_forward_decode_matches_reference(arch):
    """One decode step of both packages at position S-1 of an S-slot
    cache, from the reference's prefill of the first S-1 positions
    (carried over and padded by `convert`)."""
    jparams, model, cfg = _pair(arch)
    cj = j_reduced(arch)
    _, pre, dec = _inputs(cfg, 12)
    cache_j, _ = JLM.forward_prefill(jparams, cj, _j(pre), SHD)
    cache = convert.pad_cache(convert.lm_cache_from_reference(
        {k: _f32(v) for k, v in cache_j.items()}, device='cpu'), S)
    cache_j = {k: jnp.pad(v, ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0)))
               for k, v in cache_j.items()}
    new_j, lg_j = JLM.forward_decode(jparams, cj, cache_j, _j(dec),
                                     jnp.asarray(S - 1, jnp.int32), SHD)
    new, lg = TS.make_decode_step(cfg)(model, cache, _t(dec), S - 1)
    assert new is cache
    for key in ('k', 'v'):
        _close(new[key].float(), _f32(new_j[key]), **CACHE_BARS)
    _close(lg, _f32(lg_j), **MODEL_BARS)


@pytest.mark.parametrize('arch', ARCHS)
def test_prefill_decode_matches_full_forward(arch):
    """Within the port: prefill(S-1) + decode(1) logits equal the full
    forward's last-position logits (the bar of
    tests/test_models.py::test_prefill_decode_matches_full_forward), and
    two more decode steps leave the positions before them untouched."""
    _, model, cfg = _pair(arch)
    full, pre, dec = _inputs(cfg, 13)
    with torch.no_grad():
        hid = LM.forward_train(model, cfg, _t(full))
        want = hid[:, -1].float() @ LM.lm_head_weight(model, cfg).float()
    cache, _ = LM.forward_prefill(model, cfg, _t(pre))
    cache = convert.pad_cache(cache, S + 2)
    kept = cache['k'][:, :, :S - 1].clone()
    _, lg = LM.forward_decode(model, cfg, cache, _t(dec), S - 1)
    assert float((lg - want).abs().max()) < 0.05
    for pos in (S, S + 1):
        cache, lg = LM.forward_decode(model, cfg, cache, _t(dec), pos)
        assert bool(torch.isfinite(lg).all())
    assert torch.equal(cache['k'][:, :, :S - 1], kept)


@pytest.mark.parametrize('arch', ARCHS)
def test_input_specs_match_reference(arch):
    cfg, jcfg = registry.get(arch), j_registry.get(arch)
    for shape in (TRAIN_4K, PREFILL_32K, DECODE_32K):
        j_flat = {'/'.join(str(getattr(k, 'key', k)) for k in path):
                  (tuple(v.shape), str(v.dtype))
                  for path, v in jax.tree_util.tree_flatten_with_path(
                      JS.input_specs(jcfg, shape))[0]}
        flat = {}

        def walk(node, prefix):
            for key, val in node.items():
                if isinstance(val, dict):
                    walk(val, prefix + key + '/')
                else:
                    flat[prefix + key] = (tuple(val.shape),
                                          str(val.dtype).split('.')[-1])
        walk(TS.input_specs(cfg, shape), '')
        assert flat == j_flat


def test_init_follows_the_reference_rule():
    """Same leaves and shapes as the reference's init, biases zero and
    norm scales one, and the stacked fan-in quirk (std 1/sqrt(L))."""
    cfg = reduced('qwen2.5-3b')
    ref = jax.tree.map(_f32, j_init(JLM.model_defs(j_reduced('qwen2.5-3b')),
                                    jax.random.PRNGKey(0)))
    ref_sd = convert.lm_params_from_reference(ref, device='cpu')
    sd = LM.init_model(cfg, seed=3, device='cpu').state_dict()
    assert sorted(sd) == sorted(ref_sd)
    for key, val in sd.items():
        assert val.shape == ref_sd[key].shape and val.dtype == torch.bfloat16
        if key.endswith(('.bq', '.bk', '.bv', 'scale')):
            assert torch.equal(val, ref_sd[key]), key
    wq = torch.stack([sd[f'layers.{l}.attn.wq'] for l in range(2)]).float()
    assert abs(float(wq.std()) - 2 ** -0.5) < 0.05


def test_training_the_unported_families_raises():
    """Only the Mamba hybrid, the one family left unported, raises in
    `make_train_step`, naming its ROADMAP item 13(c)(iii). The MLA, MoE
    and dense-layer-0 variants of reduced qwen2.5-3b build a train step
    (their training is held to the reference's in
    tests/test_torch_moe_train*.py), as the dense config does."""
    base = reduced('qwen2.5-3b')
    moe = MoEConfig(num_experts=4, top_k=2, moe_d_ff=32)
    for cfg in (base,
                dataclasses.replace(base, attn='mla', mla_kv_lora=32),
                dataclasses.replace(base, moe=moe),
                dataclasses.replace(base, dense_d_ff_first=64)):
        assert callable(make_train_step(cfg, TrainConfig()))
    with pytest.raises(NotImplementedError, match='13\\(c\\)\\(iii\\)'):
        make_train_step(dataclasses.replace(base, hybrid_period=8),
                        TrainConfig())


def test_unported_families_raise_in_the_model():
    """MLA, MoE and a dense layer 0 build (declarations, module, cache);
    only the Mamba hybrid raises, naming 13(c)(iii)."""
    base = reduced('qwen2.5-3b')
    moe = MoEConfig(num_experts=4, top_k=2, moe_d_ff=32)
    for cfg, cache in (
            (dataclasses.replace(base, attn='mla', mla_kv_lora=32),
             ['ckv', 'krope']),
            (dataclasses.replace(base, moe=moe), ['k', 'v']),
            (dataclasses.replace(base, dense_d_ff_first=64), ['k', 'v'])):
        defs = LM.model_defs(cfg)
        model = LM.LM(cfg, device='meta')
        assert len(LM.all_layers(model)) == cfg.n_layers
        assert ('layer0' in defs) == bool(cfg.dense_d_ff_first)
        assert sorted(LM.cache_struct(cfg, 1, 8)) == cache
    hybrid = dataclasses.replace(base, hybrid_period=8)
    for build in (LM.model_defs, lambda c: LM.LM(c, device='meta')):
        with pytest.raises(NotImplementedError, match='13\\(c\\)\\(iii\\)'):
            build(hybrid)


def test_pad_cache():
    cfg = reduced('qwen2.5-3b')
    cache = LM.init_cache(cfg, 2, 5, device='cpu')
    cache['k'].normal_()
    grown = convert.pad_cache(cache, 9)
    assert grown['k'].shape == (2, 2, 9, 1, 16)
    assert torch.equal(grown['k'][:, :, :5], cache['k'])
    assert not grown['k'][:, :, 5:].any() and not grown['v'].any()
    state = LM.init_cache(reduced('rwkv6-3b'), 2, 5, device='cpu')
    assert convert.pad_cache(state, 9)['s'] is state['s']
    with pytest.raises(ValueError, match='capacity'):
        convert.pad_cache(cache, 4)


def test_module_forwards_are_the_functions():
    _, model, cfg = _pair('qwen2.5-3b')
    lay = model.layers[0]
    x = t(np.random.default_rng(2).normal(size=(B, S, 64)), torch.bfloat16)
    positions = torch.arange(S).expand(B, S)
    toks = t(np.random.default_rng(3).integers(0, 512, size=(B, S)))
    with torch.no_grad():
        assert torch.equal(model(toks), LM.forward_train(
            model, cfg, {'tokens': toks}))
        got, (k, v) = lay(x, positions)
        want, (k2, v2) = LM._attn_layer(lay, cfg, x, positions)
        assert torch.equal(got, want) and torch.equal(k, k2)
        assert torch.equal(v, v2)
        assert torch.equal(lay.ffn(x), TL.mlp(lay.ffn, cfg, x))
