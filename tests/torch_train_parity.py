"""Shared helpers of the port's train-step parity tests
(tests/test_torch_train_step.py, tests/test_torch_train_rank.py).

`step_pair` builds reduced rwkv6-3b with the JAX package's init (bf16
weights, with `mu_*`, `w0` and `u` given seeded values, as
tests/test_torch_rwkv.py does), carries the reference's whole train
state into the port with `convert.train_state_from_reference`, and lets
both packages take two train steps on the same batch from it.
`check_pair` holds the results to the bf16 bars:

* loss within 2e-3 relative and gnorm within 2e-2 relative, at both
  steps; the learning rates equal;
* master weights after step 1 within 2 lr elementwise, plus one float32
  rounding of the master: Adam's first step moves each weight by at most
  lr, so a gradient whose sign differs between the packages (a gradient
  near zero, where bf16 rounding decides it) moves the two masters 2 lr
  apart.
"""

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
from repro_torch.models.lm import state_dict_from_tree
from repro_torch.train import trainer as TT

LR = 3e-4


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _reference_state(cfg, seed):
    tree = jax.tree.map(_f32, j_init(JLM.model_defs(cfg),
                                     jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    lay = tree['layers']
    for blk in ('tm', 'cm'):
        for name in [k for k in lay[blk] if k.startswith('mu_')]:
            lay[blk][name] = rng.uniform(0, 1, lay[blk][name].shape)
    lay['tm']['w0'] = rng.uniform(-2, 1, lay['tm']['w0'].shape)
    lay['tm']['u'] = rng.normal(0, 0.5, lay['tm']['u'].shape)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    return {'params': params, 'opt': JA.init(params),
            'step': jnp.zeros((), jnp.int32)}


def _masters(mu):
    """{port name: float32 master} of a reference `mu` tree."""
    return state_dict_from_tree(jax.tree.map(
        lambda d: torch.as_tensor(np.array(d['master'])), mu,
        is_leaf=lambda d: isinstance(d, dict) and 'master' in d))


def step_pair(impl, objective, *, batch, remat='layer', microbatches=1,
              groups=0, seed=0):
    """Two train steps of each package from one state on one batch of
    `batch` sequences of 32 tokens: {'jax'|'port': {'metrics': [step 1,
    step 2], 'master': {name: master after step 1}}, 'count', 'step'}."""
    jcfg = dataclasses.replace(j_reduced('rwkv6-3b'), wkv_impl=impl)
    cfg = dataclasses.replace(reduced('rwkv6-3b'), wkv_impl=impl)
    kw = dict(objective=objective, remat=remat, microbatches=microbatches,
              learning_rate=LR, warmup_steps=0, decay_steps=10)
    if objective == 'lm':
        raw = TokenPipeline(TokenPipelineConfig(512, 32, batch,
                                                seed=seed)).batch(0)
    else:
        raw = RewardPipeline(512, 32, batch, seed=seed,
                             n_groups=groups).batch(0)
    state = _reference_state(jcfg, seed)
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
