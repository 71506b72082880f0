"""Step builders and input specs for the LM cells: train, prefill and
decode.

The port of the reference's `launch/steps.py`, for the token frontend
and the vision and audio stubs. `make_step(cfg, shape, tcfg)` returns the
step of the cell's kind (the train step of `train.trainer`, or a serving
step) with its input specs. Specs are `TensorSpec`s (shape, dtype), the
counterpart of the reference's ShapeDtypeStructs.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig, ShapeConfig, TrainConfig
from ..models import lm as LM
from ..train.trainer import make_train_step

i32 = torch.int32
bf16 = torch.bfloat16


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig):
    b, s = shape.global_batch, shape.seq_len
    if cfg.frontend == 'vision':
        f = cfg.frontend_tokens
        return {'tokens': LM.TensorSpec((b, s - f), i32),
                'image_embeds': LM.TensorSpec((b, f, cfg.d_model), bf16),
                'targets': LM.TensorSpec((b, s - f), i32)}
    if cfg.frontend == 'audio':
        return {'frame_embeds': LM.TensorSpec((b, s, cfg.d_model), bf16),
                'targets': LM.TensorSpec((b, s), i32)}
    return {'tokens': LM.TensorSpec((b, s), i32),
            'targets': LM.TensorSpec((b, s), i32)}


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig):
    specs = train_batch_specs(cfg, shape)
    specs.pop('targets')
    return specs


def decode_batch_specs(cfg: ModelConfig, shape: ShapeConfig):
    b = shape.global_batch
    if cfg.frontend == 'audio':
        batch = {'frame_embeds': LM.TensorSpec((b, 1, cfg.d_model), bf16)}
    else:
        batch = {'tokens': LM.TensorSpec((b, 1), i32)}
    return {'batch': batch, 'cache': LM.cache_struct(cfg, b, shape.seq_len),
            'pos': LM.TensorSpec((), i32)}


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return LM.forward_prefill(params, cfg, batch)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, cache, batch, pos):
        return LM.forward_decode(params, cfg, cache, batch, pos)
    return decode_step


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    if shape.kind == 'train':
        return train_batch_specs(cfg, shape)
    if shape.kind == 'prefill':
        return prefill_batch_specs(cfg, shape)
    return decode_batch_specs(cfg, shape)


def make_step(cfg: ModelConfig, shape: ShapeConfig,
              tcfg: TrainConfig | None = None):
    """(step_fn, example-argument specs) for the cell; the arguments
    exclude the parameters or the train state."""
    if shape.kind == 'train':
        return make_train_step(cfg, tcfg or TrainConfig()), input_specs(
            cfg, shape)
    if shape.kind == 'prefill':
        return make_prefill_step(cfg), input_specs(cfg, shape)
    return make_decode_step(cfg), input_specs(cfg, shape)
