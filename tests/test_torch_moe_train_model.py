"""The MoE family's whole layers, train state, `make_step` and train
CLI in the port, against the JAX package where it has them.

* one whole MoE-family layer of each config (the dense layer 0, and a
  MoE layer: norms, MLA or GQA, the MLP or the MoE, residuals) at the
  reference's own init in float32 against `jax.grad` of the
  reference's `_attn_layer`, the MoE layer's routing asserted alike
  first (`torch_train_parity.routing_gap`, margin 1e-4): every leaf and
  the input within LAYER_GRAD_BAR = 1e-4 of its scale, the dense
  family's bar for a saturated layer (tests/test_torch_dense_train.py);
  measured, at most 1.9e-5 of scale (deepseek's MoE layer, w_uk) and
  6.3e-7 in layer 0;
* `convert.train_state_from_reference` carries the reference's train
  state of reduced deepseek-v2-lite-16b (its master, m and v drawn) into
  the port's names, bit for bit: layer 0's leaves, declared apart, and
  each stacked layer's slab (E, in, out) of the 4-D expert leaves (L, E,
  in, out);
* `launch/steps.make_step` at a train shape builds reduced
  moonshot-v1-16b-a3b's train step, whose two steps move the router, the
  experts, the shared expert and layer 0's MLP;
* the train CLI takes two `--reduced` steps of deepseek-v2-lite-16b on
  the CPU under each objective.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.reduced import reduced as j_reduced  # noqa: E402
from repro.distributed.sharding import NoSharding  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.train import trainer as TT  # noqa: E402
from test_torch_moe_train import _flat, _grads_close  # noqa: E402
from torch_parity import t, torch_one_thread  # noqa: E402,F401
from torch_train_parity import (F32_MARGIN, _f32,  # noqa: E402
                                _reference_state, assert_same_routing,
                                record_routing, routing_gap)

SHD = NoSharding()
ARCHS = ('deepseek-v2-lite-16b', 'moonshot-v1-16b-a3b')
LAYER_GRAD_BAR = 1e-4
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..', 'src')


@pytest.mark.parametrize('arch', ARCHS)
@pytest.mark.parametrize('which', ['layer0', 'moe'])
def test_moe_family_layer_f32_grads_match_reference(arch, which):
    """One whole layer at the reference's own init in float32: the dense
    layer 0 (its own fan-in) or the first stacked MoE layer (std
    1/sqrt(L), the router at 0.02): gradients of every leaf and of the
    input, the MoE layer's routing asserted alike."""
    jcfg, cfg = j_reduced(arch), reduced(arch)
    state = _reference_state(jcfg, 7, fan_in=False)
    params = jax.tree.map(_f32, state['params'])
    model = LM.from_state_dict(cfg, convert.lm_params_from_reference(
        params, device='cpu', dtype=torch.float32))
    if which == 'layer0':
        tree, lay, moe = params['layer0'], model.layer0, False
    else:
        tree = jax.tree.map(lambda a: a[0], params['layers'])
        lay, moe = model.layers[0], True
    rng = np.random.default_rng(61)
    x = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    cot = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24), (2, 24)).astype(np.int32)
    names, _ = _flat(tree)

    def j_loss(p, x_):
        out, _ = JLM._attn_layer(p, jcfg, x_, jnp.asarray(pos), SHD, moe)
        return jnp.sum(out * cot)
    with record_routing(lay) as rec:
        jg, jx = jax.grad(j_loss, argnums=(0, 1))(
            jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
        xt = t(x).requires_grad_(True)
        out, _ = LM._attn_layer(lay, cfg, xt, t(pos))
        if moe:
            assert_same_routing(routing_gap(rec, cfg), F32_MARGIN)
        else:
            assert rec == {'ref': [], 'port': []}
    lp = dict(lay.named_parameters())
    got = torch.autograd.grad((out * t(cot)).sum(),
                              [lp[k] for k in names] + [xt])
    _grads_close(got, _flat(jg)[1] + [jx], names + ['x'],
                 bar=LAYER_GRAD_BAR)


def test_train_state_from_reference_carries_layer0_and_experts():
    """The reference's train state of reduced deepseek-v2-lite-16b, its
    master, m and v drawn: the port's state holds every leaf under the
    port's name, layer 0's apart and each stacked layer's expert slab
    (E, in, out) of the reference's (L, E, in, out), bit for bit."""
    arch = 'deepseek-v2-lite-16b'
    cfg = reduced(arch)
    state = _reference_state(j_reduced(arch), 2)
    rng = np.random.default_rng(9)
    mu = jax.tree.map(
        lambda d: {part: rng.normal(size=d[part].shape).astype(np.float32)
                   for part in ('master', 'm', 'v')}, state['opt']['mu'],
        is_leaf=lambda d: isinstance(d, dict) and 'master' in d)
    ref = {'params': jax.tree.map(_f32, state['params']),
           'opt': {'mu': mu, 'count': np.int32(3)}, 'step': np.int32(3)}
    got = convert.train_state_from_reference(ref, cfg, device='cpu')
    names = dict(got['params'].named_parameters())
    assert sorted(got['opt']['mu']) == sorted(names)
    assert names['layers.1.ffn.w1'].shape == (4, cfg.d_model, 32)
    assert names['layer0.ffn.w1'].shape == (cfg.d_model,
                                            cfg.dense_d_ff_first)
    for part in ('master', 'm', 'v'):
        for name, val in (
                ('layer0.ffn.w1', mu['layer0']['ffn']['w1'][part]),
                ('layer0.attn.w_uk', mu['layer0']['attn']['w_uk'][part]),
                ('layers.1.ffn.w2', mu['layers']['ffn']['w2'][part][1]),
                ('layers.0.ffn.router',
                 mu['layers']['ffn']['router'][part][0]),
                ('layers.1.ffn.shared.w3',
                 mu['layers']['ffn']['shared']['w3'][part][1])):
            assert torch.equal(got['opt']['mu'][name][part], t(val)), name
    assert torch.equal(names['layers.1.ffn.w3'].float(),
                       t(ref['params']['layers']['ffn']['w3'][1]))
    assert int(got['opt']['count']) == int(got['step']) == 3


def test_make_step_trains_a_moe_config():
    """`launch/steps.make_step` at a train shape returns reduced
    moonshot-v1-16b-a3b's train step and its batch specs; two steps move
    the router, the experts, the shared expert and layer 0's MLP."""
    cfg = reduced('moonshot-v1-16b-a3b')
    shape = ShapeConfig('train_tiny', 16, 2, 'train')
    step, specs = TS.make_step(cfg, shape, TrainConfig(warmup_steps=1,
                                                       decay_steps=4))
    assert {k: tuple(v.shape) for k, v in specs.items()} == {
        'tokens': (2, 16), 'targets': (2, 16)}
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab, v.shape, generator=g,
                              dtype=v.dtype) for k, v in specs.items()}
    state = TT.init_state(cfg, seed=1, device='cpu')
    names = ('layers.0.ffn.router', 'layers.0.ffn.w1', 'layers.1.ffn.w2',
             'layers.0.ffn.shared.w1', 'layer0.ffn.w1')
    params = dict(state['params'].named_parameters())
    before = {k: params[k].detach().clone() for k in names}
    for _ in range(2):       # the first step's lr is the warmup's 0
        state, metrics = step(state, batch)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert int(state['step']) == 2 and float(metrics['lr']) > 0
    for k in names:
        assert not torch.equal(params[k], before[k]), k


@pytest.mark.parametrize('objective', ['lm', 'rank_hinge'])
def test_train_cli_trains_reduced_deepseek(objective):
    """Two steps of reduced deepseek-v2-lite-16b on the CPU, the step and
    done lines printed, the losses finite."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, '-m', 'repro_torch.launch.train', '--arch',
         'deepseek-v2-lite-16b', '--reduced', '--steps', '2', '--batch',
         '4', '--seq', '32', '--device', 'cpu', '--objective', objective],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    steps = [ln for ln in lines if ln.startswith('step ')]
    assert len(steps) == 2
    losses = [float(ln.split('loss')[1].split()[0]) for ln in steps]
    assert all(np.isfinite(x) and 0 < x < 100 for x in losses)
    assert lines[-1].startswith('done: 2 steps in ')
