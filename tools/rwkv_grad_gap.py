#!/usr/bin/env python3
"""How far the two WKV routes' gradients differ, in both packages.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/rwkv_grad_gap.py \
        [--d 256] [--layers 2] [--len 256] [--seed 0]

Builds rwkv6-3b with a narrow width (d = --d, heads of 64, d_ff = 3.5 d,
vocab 2048) and --layers layers so that it runs on a CPU, initializes it
with the JAX package's `init_params`, gives `mu_*`, `w0` and `u` seeded
values (bf16 weights), and carries the same weights into the port. For
each package it takes the gradient of the LM loss (`loss_fn` with
`objective='lm'`, remat='layer') on one sequence of --len random tokens
through the kernel route and through the scan route, and prints, over
the parameter leaves, the largest of

* rel_norm: ||g_kernel - g_scan|| / ||g_scan||, and
* max_abs_over_scale: max |g_kernel - g_scan| / max |g_scan|,

with the leaf that attains each; the median over the leaves of rel_norm;
the same relative norm over all leaves at once ('total'); and over each
parameter's leaves of all layers taken together ('by_name', the largest
of them). These are the quantities chip_smoke.py's train phase holds to
its bars at full width on the card (B = 1, T = 256).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'src'))


def gap(kernel, scan):
    """The gaps listed above between two {name: float32 array} gradient
    maps; names follow the port's state_dict ('layers.<l>.tm.u')."""
    import numpy as np
    out = {'rel_norm': [0.0, None], 'max_abs_over_scale': [0.0, None]}
    rels, diff2, norm2, by_name = [], 0.0, 0.0, {}
    for name, gs in scan.items():
        gk = kernel[name]
        d2, n2 = float(np.sum((gk - gs) ** 2)), float(np.sum(gs ** 2))
        diff2, norm2 = diff2 + d2, norm2 + n2
        key = '.'.join(p for p in name.split('.') if not p.isdigit())
        acc = by_name.setdefault(key, [0.0, 0.0])
        acc[0] += d2
        acc[1] += n2
        if n2 == 0.0:
            continue
        rels.append((d2 / n2) ** 0.5)
        for key, val in (('rel_norm', rels[-1]),
                         ('max_abs_over_scale',
                          float(np.abs(gk - gs).max())
                          / float(np.abs(gs).max()))):
            if val > out[key][0]:
                out[key] = [val, name]
    out['median_rel_norm'] = float(np.median(rels))
    out['total'] = (diff2 / norm2) ** 0.5
    out['by_name'] = max([(d / n) ** 0.5, k] for k, (d, n) in by_name.items()
                         if n > 0)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--d', type=int, default=256)
    ap.add_argument('--layers', type=int, default=2)
    ap.add_argument('--len', type=int, default=256)
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.configs.registry import get as j_get
    from repro.distributed.sharding import NoSharding
    from repro.models import lm as JLM
    from repro.models.params import init_params
    from repro.train import trainer as JT
    from repro_torch import convert
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get
    from repro_torch.models import lm as LM
    from repro_torch.train import trainer as TT

    def narrow(cfg):
        return dataclasses.replace(
            cfg, n_layers=args.layers, d_model=args.d, n_heads=args.d // 64,
            n_kv_heads=args.d // 64, d_ff=int(3.5 * args.d), vocab=2048)

    jcfg, cfg = narrow(j_get('rwkv6-3b')), narrow(get('rwkv6-3b'))
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                        init_params(JLM.model_defs(jcfg),
                                    jax.random.PRNGKey(args.seed)))
    rng = np.random.default_rng(args.seed)
    lay = tree['layers']
    for blk in ('tm', 'cm'):
        for name in [k for k in lay[blk] if k.startswith('mu_')]:
            lay[blk][name] = rng.uniform(0, 1, lay[blk][name].shape)
    lay['tm']['w0'] = rng.uniform(-2, 1, lay['tm']['w0'].shape)
    lay['tm']['u'] = rng.normal(0, 0.5, lay['tm']['u'].shape)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jparams)
    model = LM.from_state_dict(cfg, convert.lm_params_from_reference(
        tree, device='cpu'))
    seq = rng.integers(0, cfg.vocab, size=(1, args.len + 1)).astype(np.int32)
    batch = {'tokens': seq[:, :-1], 'targets': seq[:, 1:]}
    shd = NoSharding()

    def jax_grads(impl):
        c = dataclasses.replace(jcfg, wkv_impl=impl)
        tc = JTrainConfig(remat='layer')
        g = jax.jit(jax.grad(lambda p: JT.loss_fn(
            p, c, tc, {k: jnp.asarray(v) for k, v in batch.items()},
            shd)))(jparams)
        flat = jax.tree.map(lambda a: torch.as_tensor(
            np.asarray(a.astype(jnp.float32))), g)
        return {k: v.numpy() for k, v in LM.state_dict_from_tree(
            flat).items()}

    def port_grads(impl):
        c = dataclasses.replace(cfg, wkv_impl=impl)
        tc = TrainConfig(remat='layer')
        _, g = TT.loss_and_grads(model, c, tc, {
            k: torch.as_tensor(v) for k, v in batch.items()})
        return {k: v.float().numpy() for k, v in g.items()}

    out = dict(d=args.d, layers=args.layers, len=args.len, seed=args.seed)
    for pkg, grads in (('jax', jax_grads), ('port', port_grads)):
        out[pkg] = gap(grads('kernel'), grads('scan'))
    print(json.dumps(out))


if __name__ == '__main__':
    main()
