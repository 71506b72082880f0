"""Shared helpers of the port's train-step parity tests
(tests/test_torch_train_step.py, tests/test_torch_train_rank.py,
tests/test_torch_dense_train*.py).

`step_pair` builds a reduced config with the JAX package's init (bf16
weights; RWKV-6's `mu_*`, `w0` and `u` given seeded values, as
tests/test_torch_rwkv.py does; the attention configs' zero-initialized
QKV biases drawn, as tests/test_torch_dense_lm.py does, and their layer
matrices brought to std 1/sqrt(fan-in), see `_reference_state`),
carries the reference's whole train state into the port with
`convert.train_state_from_reference`, and lets both packages take two
train steps on the same batch from it. The batch is the model's inputs
(tokens; image embeddings before them for a vision model, codebook
frames in their place for an audio one, by the train CLI's
`repro_torch.data.frontend_inputs`) with targets or utilities.
`check_pair` holds the results to the bf16 bars:

* loss within 2e-3 relative and gnorm within 2e-2 relative, at both
  steps; the learning rates equal;
* master weights after step 1 within 2 lr elementwise, plus one float32
  rounding of the master: Adam's first step moves each weight by at most
  lr, so a gradient whose sign differs between the packages (a gradient
  near zero, where bf16 rounding decides it) moves the two masters 2 lr
  apart.

`f32_grad_pair` gives both packages' gradients of the whole model in
float32 from the same state and batch.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.reduced import reduced as j_reduced
from repro.data import RewardPipeline, TokenPipeline, TokenPipelineConfig
from repro.distributed.sharding import NoSharding
from repro.models import lm as JLM
from repro.models.params import init_params as j_init
from repro.optim import adamw as JA
from repro.train import trainer as JT
from repro_torch import convert
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.reduced import reduced
from repro_torch.data import frontend_inputs
from repro_torch.kernels.platform import full_f32
from repro_torch.models import lm as LM
from repro_torch.models.lm import state_dict_from_tree
from repro_torch.train import trainer as TT

LR = 3e-4


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _reference_state(cfg, seed, fan_in=True):
    """The reference's train state at step 0 of its init, with seeded
    values where the init has constants. The reference's fan-in rule
    reads a stacked layer matrix's leading axis, the layer count, so it
    draws every layer matrix at std 1/sqrt(L): at the reduced sizes that
    saturates the attention's softmax, and a bf16 step there is decided
    by rounding (the reference's own compiled and op-by-op steps then
    differ in gnorm by up to 98% at step 2). With `fan_in` the attention
    configs' layer matrices (L, in, out) are scaled to std 1/sqrt(in),
    the rule applied to one layer."""
    tree = jax.tree.map(_f32, j_init(JLM.model_defs(cfg),
                                     jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    lay = tree['layers']
    if cfg.attn == 'rwkv6':
        for blk in ('tm', 'cm'):
            for name in [k for k in lay[blk] if k.startswith('mu_')]:
                lay[blk][name] = rng.uniform(0, 1, lay[blk][name].shape)
        lay['tm']['w0'] = rng.uniform(-2, 1, lay['tm']['w0'].shape)
        lay['tm']['u'] = rng.normal(0, 0.5, lay['tm']['u'].shape)
    else:
        for name in ('bq', 'bk', 'bv'):
            if name in lay['attn']:
                lay['attn'][name] = rng.normal(0, 0.5,
                                               lay['attn'][name].shape)
        if fan_in:
            tree['layers'] = jax.tree.map(
                lambda a: (a * np.sqrt(a.shape[0] / a.shape[1])
                           if a.ndim == 3 else a), lay)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    return {'params': params, 'opt': JA.init(params),
            'step': jnp.zeros((), jnp.int32)}


def _raw_batch(cfg, objective, batch, seq, groups, seed):
    """numpy batch of the config's inputs and the objective's labels."""
    if objective == 'lm':
        raw = TokenPipeline(TokenPipelineConfig(cfg.vocab, seq, batch,
                                                seed=seed)).batch(0)
    else:
        raw = RewardPipeline(cfg.vocab, seq, batch, seed=seed,
                             n_groups=groups).batch(0)
    tokens = raw.pop('tokens')
    return {**raw, **frontend_inputs(cfg, batch, seed)(0, tokens)}


def _masters(mu):
    """{port name: float32 master} of a reference `mu` tree."""
    return state_dict_from_tree(jax.tree.map(
        lambda d: torch.as_tensor(np.array(d['master'])), mu,
        is_leaf=lambda d: isinstance(d, dict) and 'master' in d))


def step_pair(arch, objective, *, batch, impl=None, remat='layer',
              microbatches=1, groups=0, seed=0, seq=32, fan_in=True):
    """Two train steps of each package from one state on one batch of
    `batch` sequences of `seq` positions of reduced `arch` (RWKV-6 on the
    WKV route `impl`): {'jax'|'port': {'metrics': [step 1, step 2],
    'master': {name: master after step 1}}, 'count', 'step'}. `fan_in`
    as in `_reference_state`."""
    jcfg, cfg = j_reduced(arch), reduced(arch)
    if impl is not None:
        jcfg = dataclasses.replace(jcfg, wkv_impl=impl)
        cfg = dataclasses.replace(cfg, wkv_impl=impl)
    kw = dict(objective=objective, remat=remat, microbatches=microbatches,
              learning_rate=LR, warmup_steps=0, decay_steps=10)
    raw = _raw_batch(cfg, objective, batch, seq, groups, seed)
    state = _reference_state(jcfg, seed, fan_in)
    np_state = {'params': jax.tree.map(_f32, state['params']),
                'opt': {'mu': jax.tree.map(np.asarray, state['opt']['mu']),
                        'count': np.asarray(state['opt']['count'])},
                'step': np.asarray(state['step'])}

    jstep = jax.jit(JT.make_train_step(jcfg, JTrainConfig(**kw),
                                       NoSharding()))
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    s1, m1 = jstep(state, jb)
    s2, m2 = jstep(s1, jb)
    out = {'jax': {'metrics': [{k: float(v) for k, v in m.items()}
                               for m in (m1, m2)],
                   'master': _masters(s1['opt']['mu'])}}

    tstate = convert.train_state_from_reference(np_state, cfg, device='cpu')
    tstep = TT.make_train_step(cfg, TrainConfig(**kw))
    tb = {k: torch.as_tensor(v) for k, v in raw.items()}
    tstate, t1 = tstep(tstate, tb)
    master = {k: v['master'].clone() for k, v in tstate['opt']['mu'].items()}
    tstate, t2 = tstep(tstate, tb)
    out['port'] = {'metrics': [{k: float(v) for k, v in m.items()}
                               for m in (t1, t2)], 'master': master}
    out['count'] = (int(tstate['opt']['count']), int(s2['opt']['count']))
    out['step'] = (int(tstate['step']), int(s2['step']))
    return out


def check_pair(res):
    assert res['count'] == (2, 2) and res['step'] == (2, 2)
    for mj, mt in zip(res['jax']['metrics'], res['port']['metrics']):
        assert all(np.isfinite(v) for v in mt.values()), mt
        assert abs(mt['loss'] - mj['loss']) <= 2e-3 * abs(mj['loss']), (
            mt, mj)
        assert abs(mt['gnorm'] - mj['gnorm']) <= 2e-2 * mj['gnorm'], (mt, mj)
        assert mt['lr'] == mj['lr']
    lr = res['jax']['metrics'][0]['lr']
    assert lr > 0
    for name, want in res['jax']['master'].items():
        got = res['port']['master'][name]
        bar = 2 * lr + 2.0 ** -23 * want.abs()
        assert bool(((got - want).abs() <= bar).all()), name


class _Float32Numpy:
    """jax.numpy with `bfloat16` read as float32."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def float32_inputs():
    """Both packages' LM forwards cast the model's inputs to bf16
    (`repro.models.lm.forward_train`, `repro_torch.models.lm.
    forward_train`), so a model with float32 weights still rounds the
    gradient that reaches the embedding, and the reference's layer scan
    refuses a float32 layer output after a bf16 input. Within this
    context both make that cast a float32 one: every operation of the
    model is then float32."""
    saved = JLM.jnp, LM.bf16
    JLM.jnp, LM.bf16 = _Float32Numpy(), torch.float32
    try:
        yield
    finally:
        JLM.jnp, LM.bf16 = saved


def f32_grad_pair(arch, objective, *, batch, microbatches=1, seed=0,
                  seq=32, fan_in=True):
    """({name: reference gradient}, {name: port gradient}), float32
    numpy, of the loss of reduced `arch` under `objective` in float32
    (`float32_inputs`), from `_reference_state`'s weights and
    `_raw_batch`'s batch: `jax.grad` of the reference's `loss_fn`
    against the port's `loss_and_grads` (remat='layer'). With
    microbatches, the reference's gradients of each microbatch are
    averaged as its train step accumulates them."""
    jcfg, cfg = j_reduced(arch), reduced(arch)
    raw = _raw_batch(cfg, objective, batch, seq, 0, seed)
    tree = jax.tree.map(_f32,
                        _reference_state(jcfg, seed, fan_in)['params'])
    kw = dict(objective=objective, remat='layer')
    jt, rows = JTrainConfig(**kw), batch // microbatches
    with float32_inputs():
        grads = [jax.jit(jax.grad(lambda p, b: JT.loss_fn(
            p, jcfg, jt, b, NoSharding())))(
                jax.tree.map(jnp.asarray, tree),
                {k: jnp.asarray(v[i * rows:(i + 1) * rows])
                 for k, v in raw.items()})
            for i in range(microbatches)]
        model = LM.from_state_dict(cfg, convert.lm_params_from_reference(
            tree, device='cpu', dtype=torch.float32))
        with full_f32():
            _, got = TT.loss_and_grads(
                model, cfg, TrainConfig(microbatches=microbatches, **kw),
                {k: torch.as_tensor(v) for k, v in raw.items()})
    want = state_dict_from_tree(jax.tree.map(
        lambda *g: torch.as_tensor(sum(map(_f32, g)) / microbatches),
        *grads))
    return ({k: v.numpy() for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})
