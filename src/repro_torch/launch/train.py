"""Training launcher CLI of the port.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch qwen2.5-3b --reduced --steps 20 --batch 4 --seq 64 \
        --objective lm --device cpu --ckpt-dir /path/to/run1

Trains the chosen architecture from a seeded init on the port's token
pipelines through the fault-tolerant loop (`runtime.run`): the full
config by default, `--reduced` for the small same-family config.
`--objective rank_hinge` trains the scalar score head with the paper's
linearithmic pairwise hinge; `lm` is next-token cross-entropy. A vision
model (`internvl2-26b`) gets seeded image embeddings before the tokens
and an audio model (`musicgen-medium`) frames from a fixed seeded
codebook in place of them, as in the reference, under either objective.
The MLA and MoE configs (`deepseek-v2-lite-16b`, `moonshot-v1-16b-a3b`)
train the same way. It prints the reference's step and done lines. It
runs on the CUDA device unless given `--device cpu`.

With `--ckpt-dir` it checkpoints every `--ckpt-every` steps (default 50)
and at the end, with a metrics.jsonl beside them, and a second run with
the same directory resumes from the last committed step, as the
reference does. Without it, it trains with no checkpoints (the reference
defaults to a fixed directory under /tmp instead).
"""

from __future__ import annotations

import argparse
import os

from ..configs.base import TrainConfig
from ..configs.reduced import reduce_config
from ..configs.registry import ARCHS, get
from ..data import (RewardPipeline, TokenPipeline, TokenPipelineConfig,
                    frontend_inputs)
from ..kernels.platform import resolve_device
from ..runtime import LoopConfig, run
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
    ap.add_argument('--ckpt-every', type=int, default=50)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default=None,
                    help="'cpu' to run the plain versions of the kernels "
                         'on the CPU; default the CUDA device')
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    if cfg.frontend != 'none' and args.objective == 'lm':
        print(f'note: {args.arch} has a {cfg.frontend} frontend stub; '
              f'training the token backbone')
    tcfg = TrainConfig(objective=args.objective, learning_rate=args.lr,
                       warmup_steps=max(args.steps // 10, 1),
                       decay_steps=args.steps, remat=args.remat,
                       microbatches=args.microbatches)
    step_fn = make_train_step(cfg, tcfg)

    if args.objective == 'rank_hinge':
        pipe = RewardPipeline(cfg.vocab, args.seq, args.batch,
                              seed=args.seed)
        label = 'utilities'
    else:
        pipe = TokenPipeline(TokenPipelineConfig(
            cfg.vocab, args.seq, args.batch, seed=args.seed))
        label = 'targets'
    frontend = frontend_inputs(cfg, args.batch, args.seed)

    def batch_fn(step):
        b = pipe.batch(step)
        return {**frontend(step, b['tokens']), label: b[label]}

    ckpt_dir = args.ckpt_dir
    if ckpt_dir is not None:
        os.makedirs(ckpt_dir, exist_ok=True)
    lc = LoopConfig(total_steps=args.steps, ckpt_dir=ckpt_dir,
                    ckpt_every=args.ckpt_every, async_ckpt=True,
                    log_path=(os.path.join(ckpt_dir, 'metrics.jsonl')
                              if ckpt_dir else None))

    def on_step(step, state, metrics):
        if step % max(args.steps // 10, 1) == 0:
            print(f'step {step:5d}  loss {float(metrics["loss"]):.4f}  '
                  f'lr {float(metrics["lr"]):.2e}', flush=True)

    state, rep = run(step_fn,
                     lambda device: init_state(cfg, args.seed, device=device),
                     batch_fn, lc, device=dev, on_step=on_step)
    if rep.resumed_from is not None:
        print(f'(resumed from step {rep.resumed_from})')
    curve = (f'loss {rep.losses[0]:.4f} -> {rep.losses[-1]:.4f}'
             if rep.losses else 'already complete')
    where = (f'checkpoints in {ckpt_dir}' if ckpt_dir
             else 'no checkpoints (no --ckpt-dir)')
    print(f'done: {rep.final_step} steps in {rep.seconds:.1f}s; '
          f'{curve}; {where}')


if __name__ == '__main__':
    main()
