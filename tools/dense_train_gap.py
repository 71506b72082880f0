#!/usr/bin/env python3
"""How far the dense attention configs' train steps and gradients differ
between the port and the JAX package, beside how far the JAX package's
own bf16 step differs when it runs op by op instead of compiled.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/dense_train_gap.py \
        [--archs qwen2.5-3b,...] [--objectives lm,rank_hinge] \
        [--init fan_in|reference]

For each reduced dense config and objective, from the state and on the
batch of tests/torch_train_parity.py (the JAX package's init with the
QKV biases drawn; `--init fan_in`, the default, scales the layer
matrices to std 1/sqrt(fan-in) as the tests do, `--init reference`
keeps the init's std 1/sqrt(L); 4 sequences of 32 positions for 'lm',
16 for 'rank_hinge'), it prints one JSON line with:

* 'port' and 'op_by_op': loss and gnorm at steps 1 and 2 of two bf16
  train steps, relative to the JAX package's compiled step (`jax.jit`,
  as the tests run it), for the port and for the same reference step
  run op by op (`jax.disable_jit()`: every primitive rounds its output
  to its dtype, as eager torch does, where XLA keeps float32 across
  fused elementwise operations); and the largest difference of the
  port's master weights after step 1 in units of check_pair's bar;
* 'f32_grad': the largest per-leaf difference of the whole model's
  float32 gradients (`f32_grad_pair`) over the leaf's scale, with its
  leaf.

tests/test_torch_dense_train_step.py, tests/test_torch_dense_train_rank.py
and tests/test_torch_dense_train_grads.py hold these within their bars.
Some 2 minutes on one CPU core, with `--init reference` some 3.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, '..', 'src'))
sys.path.insert(0, os.path.join(HERE, '..', 'tests'))

ARCHS = ('qwen2.5-3b', 'minicpm-2b', 'command-r-plus-104b',
         'nemotron-4-340b', 'internvl2-26b', 'musicgen-medium')


def measure(arch, objective, fan_in):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch_train_parity as P
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.configs.reduced import reduced as j_reduced
    from repro.distributed.sharding import NoSharding
    from repro.train import trainer as JT
    from repro_torch.configs.reduced import reduced

    batch = 4 if objective == 'lm' else 16
    res = P.step_pair(arch, objective, batch=batch, fan_in=fan_in)
    want, got = P.f32_grad_pair(arch, objective, batch=batch,
                                fan_in=fan_in)
    jcfg = j_reduced(arch)
    raw = P._raw_batch(reduced(arch), objective, batch, 32, 0, 0)
    jstep = JT.make_train_step(jcfg, JTrainConfig(
        objective=objective, remat='layer', learning_rate=P.LR,
        warmup_steps=0, decay_steps=10), NoSharding())
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    with jax.disable_jit():
        s1, m1 = jstep(P._reference_state(jcfg, 0, fan_in), jb)
        _, m2 = jstep(s1, jb)
    runs = {'port': res['port']['metrics'],
            'op_by_op': [{k: float(v) for k, v in m.items()}
                         for m in (m1, m2)]}
    ref = res['jax']['metrics']
    out = {'arch': arch, 'objective': objective, 'batch': batch,
           'init': 'fan_in' if fan_in else 'reference'}
    for name, metrics in runs.items():
        out[name] = {f'{key}_step{i + 1}': (metrics[i][key] - ref[i][key])
                     / abs(ref[i][key])
                     for i in range(2) for key in ('loss', 'gnorm')}
    lr = ref[0]['lr']
    out['port']['master_over_bar'] = max(
        float(((res['port']['master'][k] - w).abs()
               / (2 * lr + 2.0 ** -23 * w.abs())).max())
        for k, w in res['jax']['master'].items())
    worst = [0.0, None]
    for name, b in want.items():
        scale = float(np.abs(b).max())
        if scale:
            gap = float(np.abs(got[name] - b).max()) / scale
            worst = max(worst, [gap, name], key=lambda w: w[0])
    out['f32_grad'] = {'max_abs_over_scale': worst}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--archs', default=','.join(ARCHS))
    ap.add_argument('--objectives', default='lm,rank_hinge')
    ap.add_argument('--init', choices=('fan_in', 'reference'),
                    default='fan_in')
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(1)
    for objective in args.objectives.split(','):
        for arch in args.archs.split(','):
            print(json.dumps(measure(arch, objective,
                                     args.init == 'fan_in')), flush=True)


if __name__ == '__main__':
    main()
