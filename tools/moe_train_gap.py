#!/usr/bin/env python3
"""How the MoE configs' train steps and gradients differ between the
port and the JAX package, and which seeds route alike in both.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/moe_train_gap.py \
        [--archs deepseek-v2-lite-16b,moonshot-v1-16b-a3b] \
        [--objectives lm,rank_hinge] [--seeds 0:40]

For each reduced MoE config and objective, at the sizes of
tests/test_torch_moe_train_step.py (2 sequences of 32 positions for
'lm', 16 of 4 for 'rank_hinge'), it sweeps the seeds in two passes:

* the reference alone takes two bf16 train steps from
  tests/torch_train_parity.py's state and batch of each seed, and the
  least relative margin between a token's k-th and (k+1)-th router
  probability over both steps' MoE calls is read; seeds under 1.2e-3
  (LM_MARGIN and some room for the port's ulps) are dropped;
* each remaining seed runs `step_pair`, and its line gives the tokens
  the port routes apart at each step (`routing_gap`), the loss and
  gnorm gaps at both steps relative to the reference, and whether
  `check_pair` passes.

A final line per config and objective lists the seeds that route alike
at both steps and those of them that fail `check_pair`: a seed is
chosen for the tests only from the first list, and the second must be
empty (a gap that shows with routing equal is a finding, never a seed
to skip). Then the whole model's float32 gradient gaps of
`f32_grad_pair` (seed 0; 4 sequences for 'lm', 16 for 'rank_hinge',
and 'lm' in 2 microbatches), the largest per-leaf difference over the
leaf's scale. Some 2 minutes a config and objective on one CPU core
for 40 seeds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, '..', 'src'))
sys.path.insert(0, os.path.join(HERE, '..', 'tests'))

ARCHS = ('deepseek-v2-lite-16b', 'moonshot-v1-16b-a3b')
SIZES = {'lm': (2, 32), 'rank_hinge': (16, 4)}
SWEEP_MARGIN = 1.2e-3


def reference_margins(arch, objective, seeds):
    """{seed: the reference's least router margin over two steps}."""
    import jax
    import jax.numpy as jnp
    import torch_train_parity as P
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.configs.reduced import reduced as j_reduced
    from repro.distributed.sharding import NoSharding
    from repro.models import layers as JL
    from repro.train import trainer as JT
    from repro_torch.configs.reduced import reduced

    jcfg = j_reduced(arch)
    k = jcfg.moe.top_k
    seen = []
    inner = JL.moe_ffn

    def wrapped(p, cfg, x, shd):
        probs = jax.nn.softmax(jnp.einsum(
            'nd,de->ne', x.reshape(-1, x.shape[-1]), p['router'],
            preferred_element_type=jnp.float32))
        top = -jnp.sort(-probs, axis=-1)
        jax.debug.callback(lambda v: seen.append(float(v)), jnp.min(
            (top[:, k - 1] - top[:, k]) / top[:, k - 1]))
        return inner(p, cfg, x, shd)

    batch, seq = SIZES[objective]
    out = {}
    JL.moe_ffn = wrapped
    try:
        step = jax.jit(JT.make_train_step(jcfg, JTrainConfig(
            objective=objective, remat='layer', learning_rate=P.LR,
            warmup_steps=0, decay_steps=10), NoSharding()))
        for seed in seeds:
            raw = P._raw_batch(reduced(arch), objective, batch, seq, 0, seed)
            jb = {key: jnp.asarray(v) for key, v in raw.items()}
            seen.clear()
            s1, _ = step(P._reference_state(jcfg, seed), jb)
            step(s1, jb)
            jax.effects_barrier()
            out[seed] = min(seen)
    finally:
        JL.moe_ffn = inner
    return out


def sweep(arch, objective, seeds):
    import torch_train_parity as P
    batch, seq = SIZES[objective]
    alike, failing = [], []
    for seed, margin in reference_margins(arch, objective, seeds).items():
        if margin < SWEEP_MARGIN:
            continue
        res = P.step_pair(arch, objective, batch=batch, seq=seq, seed=seed)
        ref, port = res['jax']['metrics'], res['port']['metrics']
        line = {'arch': arch, 'objective': objective, 'seed': seed,
                'reference_margin': margin,
                'routed_apart': [gap[0] for gap in res['routing']],
                'gaps': {f'{key}_step{i + 1}':
                         (port[i][key] - ref[i][key]) / abs(ref[i][key])
                         for i in range(2) for key in ('loss', 'gnorm')}}
        if not any(line['routed_apart']):
            alike.append(seed)
            try:
                P.check_pair(res)
                line['check_pair'] = 'pass'
            except AssertionError as err:
                line['check_pair'] = f'fail: {err}'
                failing.append(seed)
        print(json.dumps(line), flush=True)
    print(json.dumps({'arch': arch, 'objective': objective,
                      'seeds': f'{seeds.start}:{seeds.stop}',
                      'routed_alike': alike,
                      'alike_but_failing_check_pair': failing}), flush=True)


def f32_gaps(arch, objective, microbatches):
    import numpy as np
    import torch_train_parity as P
    batch = 4 if objective == 'lm' else 16
    want, got = P.f32_grad_pair(arch, objective, batch=batch,
                                microbatches=microbatches)
    worst = [0.0, None]
    for name, b in want.items():
        scale = float(np.abs(b).max())
        if scale:
            gap = float(np.abs(got[name] - b).max()) / scale
            worst = max(worst, [gap, name], key=lambda w: w[0])
    return {'arch': arch, 'objective': objective,
            'microbatches': microbatches,
            'f32_grad_max_abs_over_scale': worst}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--archs', default=','.join(ARCHS))
    ap.add_argument('--objectives', default='lm,rank_hinge')
    ap.add_argument('--seeds', default='0:40',
                    help='first:stop of the seeds swept')
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(1)
    lo, hi = map(int, args.seeds.split(':'))
    archs, objectives = args.archs.split(','), args.objectives.split(',')
    for arch in archs:
        for objective in objectives:
            sweep(arch, objective, range(lo, hi))
    for arch in archs:
        for objective in objectives:
            print(json.dumps(f32_gaps(arch, objective, 1)), flush=True)
        if 'lm' in objectives:
            print(json.dumps(f32_gaps(arch, 'lm', 2)), flush=True)


if __name__ == '__main__':
    main()
