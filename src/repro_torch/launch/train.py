"""Training launcher CLI of the port.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch rwkv6-3b --reduced --steps 20 --batch 4 --seq 64 \
        --objective lm --device cpu

Trains the chosen architecture from a seeded init on the port's token
pipelines: the full config by default, `--reduced` for the small
same-family config. `--objective rank_hinge` trains the scalar score head
with the paper's linearithmic pairwise hinge; `lm` is next-token
cross-entropy. It prints the reference's step and done lines. It runs on
the CUDA device unless given `--device cpu`.

The reference runs its fault-tolerant loop (checkpoints, auto-resume);
that loop is ROADMAP Queue 1 item 11, so `--ckpt-dir` and `--ckpt-every`
raise here.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.base import TrainConfig
from ..configs.reduced import reduce_config
from ..configs.registry import ARCHS, get
from ..data import RewardPipeline, TokenPipeline, TokenPipelineConfig
from ..kernels.platform import resolve_device
from ..train.trainer import init_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch', required=True, choices=sorted(ARCHS))
    ap.add_argument('--reduced', action='store_true',
                    help='reduced same-family config (CPU-runnable)')
    ap.add_argument('--objective', default='lm',
                    choices=['lm', 'rank_hinge'])
    ap.add_argument('--steps', type=int, default=100)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--seq', type=int, default=128)
    ap.add_argument('--lr', type=float, default=3e-4)
    ap.add_argument('--microbatches', type=int, default=1)
    ap.add_argument('--remat', default='none', choices=['none', 'layer'])
    ap.add_argument('--ckpt-dir', default=None)
    ap.add_argument('--ckpt-every', type=int, default=None)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default=None,
                    help="'cpu' to run the plain versions of the kernels "
                         'on the CPU; default the CUDA device')
    args = ap.parse_args(argv)
    if args.ckpt_dir is not None or args.ckpt_every is not None:
        raise NotImplementedError(
            'checkpoints and resume are the fault-tolerant loop, ROADMAP '
            'Queue 1 item 11; the port trains without them')

    dev = resolve_device(args.device)
    cfg = get(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    tcfg = TrainConfig(objective=args.objective, learning_rate=args.lr,
                       warmup_steps=max(args.steps // 10, 1),
                       decay_steps=args.steps, remat=args.remat,
                       microbatches=args.microbatches)
    step_fn = make_train_step(cfg, tcfg)

    if args.objective == 'rank_hinge':
        pipe = RewardPipeline(cfg.vocab, args.seq, args.batch,
                              seed=args.seed)

        def batch_fn(step):
            b = pipe.batch(step)
            return {'tokens': b['tokens'], 'utilities': b['utilities']}
    else:
        batch_fn = TokenPipeline(TokenPipelineConfig(
            cfg.vocab, args.seq, args.batch, seed=args.seed)).batch

    t0 = time.perf_counter()
    state = init_state(cfg, args.seed, device=dev)
    losses = []
    for step in range(args.steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in batch_fn(step).items()}
        state, metrics = step_fn(state, batch)
        loss = float(metrics['loss'])
        if not np.isfinite(loss):
            raise FloatingPointError(f'non-finite loss at {step}')
        losses.append(loss)
        done = step + 1
        if done % max(args.steps // 10, 1) == 0:
            print(f'step {done:5d}  loss {loss:.4f}  '
                  f'lr {float(metrics["lr"]):.2e}', flush=True)
    curve = (f'loss {losses[0]:.4f} -> {losses[-1]:.4f}' if losses
             else 'no steps')
    print(f'done: {args.steps} steps in {time.perf_counter() - t0:.1f}s; '
          f'{curve}; no checkpoints (ROADMAP Queue 1 item 11)')


if __name__ == '__main__':
    main()
