"""Learning-rate schedules: cosine and WSD (warmup-stable-decay, MiniCPM
arXiv:2404.06395), the counterpart of `repro.optim.schedules`. Each maps
a step (an int32 tensor or an int) to a float32 scalar tensor."""

from __future__ import annotations

import math

import torch

f32 = torch.float32


def _step(step):
    return torch.as_tensor(step).to(f32)


def cosine(step, *, base_lr, warmup_steps, decay_steps, min_ratio=0.1):
    s = _step(step)
    warm = s / max(warmup_steps, 1)
    prog = torch.clamp((s - warmup_steps) / max(decay_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * torch.where(s < warmup_steps, warm, cos)


def wsd(step, *, base_lr, warmup_steps, stable_steps, decay_steps,
        min_ratio=0.01):
    """Warmup -> constant ("stable") -> short exponential decay tail."""
    s = _step(step)
    warm = s / max(warmup_steps, 1)
    in_decay = s > warmup_steps + stable_steps
    prog = torch.clamp((s - warmup_steps - stable_steps)
                       / max(decay_steps, 1), 0.0, 1.0)
    decay = min_ratio ** prog      # exponential decay to min_ratio
    mult = torch.where(s < warmup_steps, warm,
                       torch.where(in_decay, decay, torch.ones_like(s)))
    return base_lr * mult


def make_schedule(cfg_model, tcfg):
    if cfg_model.schedule == 'wsd':
        stable = tcfg.stable_steps or int(0.8 * tcfg.decay_steps)
        return lambda step: wsd(step, base_lr=tcfg.learning_rate,
                                warmup_steps=tcfg.warmup_steps,
                                stable_steps=stable,
                                decay_steps=max(tcfg.decay_steps - stable, 1))
    return lambda step: cosine(step, base_lr=tcfg.learning_rate,
                               warmup_steps=tcfg.warmup_steps,
                               decay_steps=tcfg.decay_steps)
