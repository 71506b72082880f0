"""Port parity of the dense-attention training pieces against the JAX
package.

The same seeded numpy inputs go to the JAX function and its port:

* the float32 gradients of `gqa_attention` (with and without the QKV
  bias, one and four KV heads), of `blockwise_attention` at T = 40 in
  blocks of 16 (a short last block, and rows of every block past the
  diagonal fully masked by the causal mask) and of `mlp` ('swiglu' and
  'sq_relu'), with respect to the input and every weight, against
  `jax.grad` of the reference's blocks: per leaf within F32_GRAD_BAR of
  the leaf's scale (its largest absolute value). The two packages sum
  the same float32 products in another order; measured here, at most
  6.2e-7 of scale (wk). One whole layer (norms, attention, MLP,
  residuals) of the reference's init in float32 is held to
  LAYER_GRAD_BAR: that init (matrices of std 1/sqrt(L), the stacked
  fan-in rule) saturates the softmax and puts the key bias's gradient
  at 1.8e3, where float32 sums in another order differ more; measured
  here, at most 2.1e-5 of scale (bk);
* the LM loss of reduced `internvl2-26b`, whose hidden states hold the
  image positions before the text: both packages take the loss on the
  text positions only;
* a dense train step built by `launch/steps.make_step` for a train shape.

The whole model's float32 gradients of each dense config against the
reference's are in tests/test_torch_dense_train_grads.py, and its bf16
train steps in tests/test_torch_dense_train_step.py and
tests/test_torch_dense_train_rank.py.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs.reduced import reduced as j_reduced  # noqa: E402
from repro.distributed.sharding import NoSharding  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.train import trainer as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.train import trainer as TT  # noqa: E402
from torch_parity import n, t, torch_one_thread  # noqa: E402,F401
from torch_train_parity import _f32, _raw_batch  # noqa: E402
from torch_train_parity import _reference_state  # noqa: E402

SHD = NoSharding()
F32_GRAD_BAR = 1e-5
LAYER_GRAD_BAR = 1e-4


def _grads_close(got, want, names, bar=F32_GRAD_BAR):
    for name, a, b in zip(names, got, want):
        a, b = n(a), np.asarray(b)
        assert a.shape == b.shape, name
        assert np.all(np.isfinite(a)), name
        scale = float(np.abs(b).max())
        assert scale > 0, name
        err = float(np.abs(a - b).max())
        assert err <= bar * scale, (name, err / scale)


def _weights(defs, rng, mod):
    """Seeded float32 values for the leaves of `defs`, set on `mod`:
    {name: numpy}. Biases are drawn at 0.5 (their init is zeros)."""
    out = {}
    for name, d in defs.items():
        scale = 0.5 if name.startswith('b') else d.shape[0] ** -0.5
        out[name] = (rng.normal(size=d.shape) * scale).astype(np.float32)
        getattr(mod, name).data = t(out[name])
    return out


def _torch_grads(mod, names, x, c, fn):
    xt = t(x).requires_grad_(True)
    out = fn(xt)
    return torch.autograd.grad((out * t(c)).sum(),
                               [getattr(mod, k) for k in names] + [xt])


@pytest.mark.parametrize('kv', [1, 4])
@pytest.mark.parametrize('bias', [True, False])
def test_gqa_attention_f32_grads_match_reference(bias, kv):
    """Causal self-attention over T = 24 (4 query heads of 16 over `kv`
    KV heads): gradients of sum(out * c) with respect to wq, wk, wv, wo,
    the biases and x."""
    cj = dataclasses.replace(j_reduced('qwen2.5-3b'), qkv_bias=bias,
                             n_kv_heads=kv)
    c = dataclasses.replace(reduced('qwen2.5-3b'), qkv_bias=bias,
                            n_kv_heads=kv)
    rng = np.random.default_rng(20 + kv)
    mod = TL.Attention(c, device='cpu')
    w = _weights(TL.attention_defs(c), rng, mod)
    x = rng.normal(size=(2, 24, c.d_model)).astype(np.float32)
    cot = rng.normal(size=(2, 24, c.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24), (2, 24)).astype(np.int32)
    names = sorted(w)

    def j_loss(p, x_):
        out, _ = JL.gqa_attention(p, cj, x_, jnp.asarray(pos), SHD)
        return jnp.sum(out * cot)
    jg, jx = jax.grad(j_loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x))
    got = _torch_grads(mod, names, x, cot,
                       lambda x_: TL.gqa_attention(mod, c, x_, t(pos))[0])
    _grads_close(got, [jg[k] for k in names] + [jx], names + ['x'])


@pytest.mark.parametrize('kv', [1, 4])
def test_blockwise_attention_f32_grads_match_reference(kv):
    """T = S = 40 in blocks of 16: the last block holds 8 keys, and in
    blocks 1 and 2 the first 16 and 32 query rows are masked whole. The
    gradients of q, k and v are finite and the reference's (its keys and
    values repeated to the 4 query heads, the port's grouped)."""
    rng = np.random.default_rng(30 + kv)
    q = (2 * rng.normal(size=(2, 40, 4, 16))).astype(np.float32)
    k = (2 * rng.normal(size=(2, 40, kv, 16))).astype(np.float32)
    v = rng.normal(size=(2, 40, kv, 16)).astype(np.float32)
    cot = rng.normal(size=(2, 40, 4, 16)).astype(np.float32)
    rep = 4 // kv

    def j_loss(q_, k_, v_):
        out = JL.blockwise_attention(q_, JL._repeat_kv(k_, rep),
                                     JL._repeat_kv(v_, rep), causal=True,
                                     block_kv=16)
        return jnp.sum(out * cot)
    want = jax.grad(j_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [t(a).requires_grad_(True) for a in (q, k, v)]
    out = TL.blockwise_attention(*leaves, causal=True, block_kv=16)
    got = torch.autograd.grad((out * t(cot)).sum(), leaves)
    _grads_close(got, want, ['q', 'k', 'v'])


@pytest.mark.parametrize('act', ['swiglu', 'sq_relu'])
def test_mlp_f32_grads_match_reference(act):
    cj = dataclasses.replace(j_reduced('qwen2.5-3b'), act=act)
    c = dataclasses.replace(reduced('qwen2.5-3b'), act=act)
    rng = np.random.default_rng(40)
    mod = TL.MLP(c, device='cpu')
    w = _weights(TL.mlp_defs(c), rng, mod)
    x = rng.normal(size=(2, 10, c.d_model)).astype(np.float32)
    cot = rng.normal(size=(2, 10, c.d_model)).astype(np.float32)
    names = sorted(w)
    jg, jx = jax.grad(lambda p, x_: jnp.sum(JL.mlp(p, cj, x_, SHD) * cot),
                      argnums=(0, 1))({k: jnp.asarray(v) for k, v in
                                       w.items()}, jnp.asarray(x))
    got = _torch_grads(mod, names, x, cot, lambda x_: TL.mlp(mod, c, x_))
    _grads_close(got, [jg[k] for k in names] + [jx], names + ['x'])


@pytest.mark.parametrize('arch', ['qwen2.5-3b', 'nemotron-4-340b'])
def test_attention_layer_f32_grads_match_reference(arch):
    """One whole layer (ln1, attention, residual, ln2, MLP, residual) of
    the reference's init in float32, the QKV biases drawn: gradients of
    every leaf and of the input. These are the pieces of the whole
    model's gradient that the bf16 train steps compose."""
    jcfg, cfg = j_reduced(arch), reduced(arch)
    state = _reference_state(jcfg, 7, fan_in=False)
    tree = jax.tree.map(lambda a: _f32(a)[0], state['params']['layers'])
    lay = LM.from_state_dict(cfg, convert.lm_params_from_reference(
        jax.tree.map(_f32, state['params']), device='cpu',
        dtype=torch.float32)).layers[0]
    rng = np.random.default_rng(60)
    x = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    cot = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24), (2, 24)).astype(np.int32)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    names = ['.'.join(k.key for k in path) for path, _ in flat]

    def j_loss(p, x_):
        out, _ = JLM._attn_layer(p, jcfg, x_, jnp.asarray(pos), SHD, False)
        return jnp.sum(out * cot)
    jg, jx = jax.grad(j_loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    jflat = [leaf for _, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]]
    xt = t(x).requires_grad_(True)
    out, _ = LM._attn_layer(lay, cfg, xt, t(pos))
    params = dict(lay.named_parameters())
    got = torch.autograd.grad((out * t(cot)).sum(),
                              [params[k] for k in names] + [xt])
    _grads_close(got, jflat + [jx], names + ['x'], bar=LAYER_GRAD_BAR)


def test_vision_lm_loss_is_taken_on_the_text_positions():
    """Reduced internvl2-26b: 4 image embeddings before 32 tokens. The
    port's loss_fn equals the reference's on the same converted bf16
    parameters and batch (within the bf16 models' 2e-3), which needs the
    hidden states cut to the text positions before the LM head."""
    jcfg, cfg = j_reduced('internvl2-26b'), reduced('internvl2-26b')
    raw = _raw_batch(cfg, 'lm', 2, 32, 0, 3)
    assert raw['image_embeds'].shape == (2, 4, 64)
    state = _reference_state(jcfg, 3, fan_in=False)
    want = float(JT.loss_fn(state['params'], jcfg,
                            JTrainConfig(remat='none'),
                            {k: jnp.asarray(v) for k, v in raw.items()},
                            SHD))
    model = LM.from_state_dict(cfg, convert.lm_params_from_reference(
        jax.tree.map(_f32, state['params']), device='cpu'))
    with torch.no_grad():
        got = float(TT.loss_fn(model, cfg, TrainConfig(remat='none'),
                               {k: torch.as_tensor(v)
                                for k, v in raw.items()}))
    assert abs(got - want) <= 2e-3 * abs(want), (got, want)


def test_make_step_trains_a_dense_config():
    """`launch/steps.make_step` at a train shape returns the train step
    of reduced minicpm-2b (its WSD schedule) and the batch's specs; a
    step on a batch of those specs moves the weights."""
    cfg = reduced('minicpm-2b')
    shape = ShapeConfig('train_tiny', 24, 2, 'train')
    step, specs = TS.make_step(cfg, shape, TrainConfig(warmup_steps=1,
                                                       decay_steps=4))
    assert {k: tuple(v.shape) for k, v in specs.items()} == {
        'tokens': (2, 24), 'targets': (2, 24)}
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab, v.shape, generator=g,
                              dtype=v.dtype) for k, v in specs.items()}
    state = TT.init_state(cfg, seed=1, device='cpu')
    before = state['params'].layers[0].attn.wq.detach().clone()
    for _ in range(2):       # the first step's lr is the warmup's 0
        state, metrics = step(state, batch)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert int(state['step']) == 2 and float(metrics['lr']) > 0
    assert not torch.equal(state['params'].layers[0].attn.wq, before)
