"""Fault-tolerant training loop: checkpoint/restart, failure injection,
straggler detection, NaN guards, JSONL metrics. The port of
`repro.runtime.loop`.

Restart contract (tests/test_torch_runtime.py): the data pipeline is
stateless (batch = f(seed, step)) and a checkpoint stores the state
exactly, so `run(steps=N)` -> preemption at k -> `run(steps=N)` resumes
from the last committed step and ends on the state of an uninterrupted
run, bit for bit (asynchronous checkpoints trail by at most
`ckpt_every` steps).

A restore never builds a fresh state first: at the rwkv6-3b width the
train state takes about 49 GB, so a fresh one on the card plus the
checkpoint loaded over it would not fit in 80 GB. The loop calls
`init_state_fn` on the meta device, which allocates nothing, for the
state's structure, and `checkpoint.restore` places each stored leaf on
the target device once.

Stragglers: per-step wall times feed an EWMA; a step slower than
`straggler_factor` times it fires `on_straggler` (counted and logged
here).

NaN policy 'skip' drops the step's returned state and loss. A step that
updates its state in place must therefore make no update when its loss
is not finite: the port's train step (`train.trainer`), whose AdamW
state leaves no room for a second copy at full width, checks the loss
and the gradient norm before it updates.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..checkpoint import AsyncCheckpointer, latest_step, restore
from ..kernels.platform import resolve_device


class SimulatedPreemption(RuntimeError):
    """Raised by failure injection to model a node loss or SIGTERM."""


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: Optional[str]           # None: no checkpoints, no resume
    ckpt_every: int = 50
    ckpt_keep: int = 3
    async_ckpt: bool = True
    log_path: Optional[str] = None
    nan_policy: str = 'halt'          # halt | skip
    max_skipped: int = 10
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.1


@dataclasses.dataclass
class LoopReport:
    final_step: int
    losses: list
    resumed_from: Optional[int]
    skipped_steps: int
    straggler_steps: int
    seconds: float


def _to_device(batch, device):
    """A batch's arrays and tensors on `device` (containers kept)."""
    if batch is None:
        return None
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_to_device(v, device) for v in batch)
    if torch.is_tensor(batch):
        return batch.to(device)
    return torch.as_tensor(np.asarray(batch), device=device)


def run(step_fn: Callable, init_state_fn: Callable, batch_fn: Callable,
        cfg: LoopConfig, *, device=None,
        fail_at: Optional[int] = None,
        on_straggler: Optional[Callable[[int, float], None]] = None,
        on_step: Optional[Callable] = None) -> tuple:
    """Run (or resume) training to cfg.total_steps.

    step_fn: (state, batch) -> (state, metrics), metrics['loss'] a
      scalar.
    init_state_fn: device -> a fresh state on that device. The loop
      calls it with `device` for a fresh start and with the meta device
      for the structure of a restore.
    batch_fn: step -> batch (stateless pipeline); its arrays go to
      `device`.
    device: where the state and batches live (default: the CUDA device).
    fail_at: failure injection, SimulatedPreemption raised before step
      `fail_at` runs (a mid-run node loss).
    Returns (state, LoopReport)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    resumed_from = None
    start = 0
    ls = latest_step(cfg.ckpt_dir) if cfg.ckpt_dir else None
    if ls is not None:
        state, _ = restore(cfg.ckpt_dir, ls,
                           like=init_state_fn(torch.device('meta')),
                           device=dev)
        start = resumed_from = ls
    else:
        state = init_state_fn(dev)

    ckpt = (AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.ckpt_keep)
            if cfg.ckpt_dir else None)
    logf = open(cfg.log_path, 'a') if cfg.log_path else None
    losses, skipped, stragglers = [], 0, 0
    ewma = None

    try:
        for step in range(start, cfg.total_steps):
            if fail_at is not None and step == fail_at:
                raise SimulatedPreemption(f'injected failure at step {step}')
            ts = time.perf_counter()
            new_state, metrics = step_fn(state, _to_device(batch_fn(step),
                                                           dev))
            loss = float(metrics['loss'])
            dt = time.perf_counter() - ts

            if not np.isfinite(loss):
                if cfg.nan_policy == 'halt':
                    raise FloatingPointError(f'non-finite loss at {step}')
                skipped += 1
                if skipped > cfg.max_skipped:
                    raise FloatingPointError(
                        f'>{cfg.max_skipped} skipped steps')
                continue                     # drop the returned state
            state = new_state
            losses.append(loss)

            if ewma is not None and dt > cfg.straggler_factor * ewma:
                stragglers += 1
                if on_straggler:
                    on_straggler(step, dt / ewma)
            ewma = dt if ewma is None else (
                cfg.ewma_alpha * dt + (1 - cfg.ewma_alpha) * ewma)

            if logf:
                rec = {'step': step + 1, 'loss': loss, 'sec': round(dt, 4)}
                rec.update({k: float(v) for k, v in metrics.items()
                            if k != 'loss'})
                logf.write(json.dumps(rec) + '\n')
                logf.flush()
            if on_step:
                on_step(step + 1, state, metrics)

            done = step + 1
            if ckpt is not None and (done % cfg.ckpt_every == 0
                                     or done == cfg.total_steps):
                ckpt.save(done, state)
                if not cfg.async_ckpt:
                    ckpt.wait()
        if ckpt is not None:
            ckpt.wait()
    finally:
        if ckpt is not None:
            try:
                ckpt.wait()
            except Exception:
                pass
        if logf:
            logf.close()

    return state, LoopReport(
        final_step=cfg.total_steps, losses=losses, resumed_from=resumed_from,
        skipped_steps=skipped, straggler_steps=stragglers,
        seconds=time.perf_counter() - t0)
