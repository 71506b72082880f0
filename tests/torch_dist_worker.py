"""Multi-rank runs of the port's sharded oracle for the CPU tests.

`run_ranks(fn, world, tmp, *args)` starts `world` processes (spawned,
never forked), each in one `gloo` process group whose store is a file
under `tmp`, so that parallel test workers never share a port. Rank r
calls `fn(r, world, *args)`, the arguments read from a file under `tmp`; its result is saved under `tmp` and
`run_ranks` returns the results in rank order, or raises with the
failing rank's traceback. The functions here import the port only
(torch, numpy), never JAX.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import traceback

import numpy as np
import torch

RANK_TIMEOUT = 150       # seconds for the slowest rank of one run
# A rank that fails leaves its peers waiting in a collective for this
# long before they fail too.
COLLECTIVE_TIMEOUT = 60


def _entry(fn, rank, world, init, out, args_path):
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        with open(args_path, 'rb') as f:
            args = pickle.load(f)
        dist.init_process_group(
            'gloo', init_method=f'file://{init}', rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
        try:
            res = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save({'ok': res}, out)
    except BaseException:
        torch.save({'error': traceback.format_exc()}, out)
        raise


def run_ranks(fn, world: int, tmp, *args):
    ctx = multiprocessing.get_context('spawn')
    tmp = str(tmp)
    init = os.path.join(tmp, 'pg_store')
    outs = [os.path.join(tmp, f'rank{r}.pt') for r in range(world)]
    # The arguments go through a file: passed to a spawned process
    # directly, numpy arrays slowed its start by seconds.
    args_path = os.path.join(tmp, 'args.pkl')
    with open(args_path, 'wb') as f:
        pickle.dump(args, f)
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, init, outs[r], args_path))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(RANK_TIMEOUT)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    results = []
    for r, out in enumerate(outs):
        if not os.path.exists(out):
            killed = ', killed at the timeout' if procs[r] in alive else ''
            raise RuntimeError(f'rank {r} of {world} left no result (exit '
                               f'code {procs[r].exitcode}{killed})')
        res = torch.load(out, weights_only=False)
        if 'error' in res:
            raise RuntimeError(f'rank {r} of {world} failed:\n'
                               f'{res["error"]}')
        results.append(res['ok'])
    return results


def _n(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _features(layout, X, memmap_path):
    from repro_torch.data.sparse import CSRMatrix
    if layout == 'csr':
        return CSRMatrix.from_dense(X)
    if layout == 'stream':
        return np.load(memmap_path, mmap_mode='r')
    return X


def oracle_calls(rank, world, shape, cases, combos, memmap_path, fit,
                 fit_layouts, compress):
    """On the mesh `shape` over ('data', 'model'): for each case
    (name, X, y, g, w), X also saved at `memmap_path`, and each (layout, variant, engine) of `combos`,
    the rank's block rows, counts, loss and a at w; with `fit` (`bmrm`
    keywords), a short device-driver fit per layout of `fit_layouts`;
    with `compress` (a dict of stacked (ndev, ...) summands per step),
    `compressed_mean` of this rank's rows over 'data'. Everything as
    numpy, keyed by strings."""
    from repro_torch.core import bmrm as TB
    from repro_torch.core import oracle as TO
    from repro_torch.distributed import compressed_mean
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(shape, ('data', 'model'), device='cpu')
    out = {'coords': mesh.coords, 'rows': {}, 'calls': {}, 'fits': {}}
    for name, X, y, g, w in cases:
        for layout, variant, engine in combos:
            o = TO.make_oracle(_features(layout, X, memmap_path), y,
                               g, method='sharded', mesh=mesh,
                               variant=variant, engine=engine,
                               stream_block=5)
            c, d = o.rank_counts(w)
            loss, a = o.loss_and_subgrad(w)
            key = f'{name}/{layout}/{variant}/{engine}'
            out['rows'][name] = o.block.rows
            out['calls'][key] = dict(c=_n(c), d=_n(d), loss=_n(loss),
                                     a=_n(a), oracle=o.name)
            if (variant, engine) == ('opt', 'tree'):
                # the path sweep's batched step: (L, rows) through the
                # collectives, the counter row by row
                W = torch.stack([torch.as_tensor(w, dtype=torch.float32),
                                 torch.as_tensor(w, dtype=torch.float32)
                                 * 0.5])
                losses, A = o.step_fn()(W)
                out['calls'][key].update(batch_loss=_n(losses), batch_a=_n(A))
        if fit:
            for layout in fit_layouts:
                o = TO.make_oracle(_features(layout, X, memmap_path),
                                   y, g, method='sharded', mesh=mesh,
                                   stream_block=5)
                res = TB.bmrm(o, solver='device', **fit)
                out['fits'][f'{name}/{layout}'] = dict(
                    w=res.w, iterations=res.stats.iterations,
                    obj=res.stats.obj_best)
    if compress is not None:
        steps = []
        err = None
        for summands in compress:
            mine = {k: torch.from_numpy(v[mesh.coords['data']])
                    for k, v in summands.items()}
            mean, err = compressed_mean(mine, mesh, 'data', err)
            steps.append(({k: _n(v) for k, v in mean.items()},
                          {k: _n(v) for k, v in err.items()}))
        out['compress'] = steps
    return out
