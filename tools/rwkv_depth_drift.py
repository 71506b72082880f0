#!/usr/bin/env python3
"""How far bf16 rounding moves RWKV-6 logits at full depth, in both packages.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/rwkv_depth_drift.py \
        [--d 256] [--layers 32] [--len 64] [--seed 0]

Builds rwkv6-3b at its full depth with a narrow width (d = --d, heads of
64, d_ff = 3.5 d, vocab 2048) so that it runs on a CPU, initializes it
with the JAX package's `init_params` (whose stacked fan-in rule gives
every layer matrix std 1/sqrt(L)), gives `mu_*`, `w0` and `u` seeded
values, and carries the same weights into the port. For each package it
prints, on B = 2 sequences of --len tokens, the largest absolute
difference of last-position logits (float32):

* pd_<route>: prefill(T-1) + decode(1) against the full forward, with the
  WKV route 'scan' or 'kernel' (decode always runs the scan);
* kernel_vs_scan: the two routes' full forwards;

and the logits' largest magnitude (scale). These are the quantities
chip_smoke.py's lm phase holds to its bars at full width on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'src'))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--d', type=int, default=256)
    ap.add_argument('--layers', type=int, default=32)
    ap.add_argument('--len', type=int, default=64)
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.configs.registry import get as j_get
    from repro.distributed.sharding import NoSharding
    from repro.models import lm as JLM
    from repro.models.params import init_params
    from repro_torch import convert
    from repro_torch.configs.registry import get
    from repro_torch.models import lm as LM

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
    toks = rng.integers(0, cfg.vocab, size=(2, args.len)).astype(np.int32)
    shd = NoSharding()
    t_len = args.len

    def jax_route(impl):
        c = dataclasses.replace(jcfg, wkv_impl=impl)
        hid = JLM.forward_train(jparams, c, {'tokens': jnp.asarray(toks)},
                                shd, remat='none')
        full = jnp.einsum('bd,dv->bv', hid[:, -1], jparams['lm_head'],
                          preferred_element_type=jnp.float32)
        cache, _ = JLM.forward_prefill(
            jparams, c, {'tokens': jnp.asarray(toks[:, :-1])}, shd)
        _, dec = JLM.forward_decode(
            jparams, c, cache, {'tokens': jnp.asarray(toks[:, -1:])},
            jnp.asarray(t_len - 1, jnp.int32), shd)
        return np.asarray(full), np.asarray(dec)

    def port_route(impl):
        c = dataclasses.replace(cfg, wkv_impl=impl)
        tk = torch.as_tensor(toks)
        with torch.no_grad():
            hid = LM.forward_train(model, c, {'tokens': tk})
            full = hid[:, -1].float() @ model.lm_head.float()
        cache, _ = LM.forward_prefill(model, c, {'tokens': tk[:, :-1]})
        _, dec = LM.forward_decode(model, c, cache, {'tokens': tk[:, -1:]},
                                   t_len - 1)
        return full.numpy(), dec.numpy()

    out = dict(d=args.d, layers=args.layers, len=t_len, seed=args.seed)
    for pkg, route in (('jax', jax_route), ('port', port_route)):
        res = {impl: route(impl) for impl in ('scan', 'kernel')}
        out[pkg] = {
            'pd_scan': float(np.abs(res['scan'][1] - res['scan'][0]).max()),
            'pd_kernel': float(np.abs(res['kernel'][1]
                                      - res['kernel'][0]).max()),
            'kernel_vs_scan': float(np.abs(res['kernel'][0]
                                           - res['scan'][0]).max()),
            'scale': float(np.abs(res['scan'][0]).max())}
    print(json.dumps(out))


if __name__ == '__main__':
    main()
