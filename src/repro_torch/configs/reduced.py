"""Reduced same-family configs for CPU smoke tests (assignment requirement:
small layers/width/experts/vocab, one forward/train step, assert shapes+finite)."""

from __future__ import annotations

import dataclasses

from .base import ModelConfig, MoEConfig
from .registry import get


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Shrink every dimension while preserving the family's structure
    (GQA ratio, MLA, MoE routing, hybrid interleave, frontends)."""
    heads = 4
    head_dim = 16
    kv = max(1, min(cfg.n_kv_heads * heads // max(cfg.n_heads, 1), heads))
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(num_experts=4,
                        top_k=min(cfg.moe.top_k, 2),
                        shared_experts=min(cfg.moe.shared_experts, 1),
                        every=cfg.moe.every,
                        capacity_factor=2.0,
                        moe_d_ff=32)
    if cfg.hybrid_period > 0:
        n_layers = cfg.hybrid_period  # one full jamba block
    elif cfg.dense_d_ff_first:
        n_layers = 3
    else:
        n_layers = 2
    return dataclasses.replace(
        cfg,
        name=cfg.name + '-smoke',
        n_layers=n_layers,
        d_model=heads * head_dim,
        n_heads=heads, n_kv_heads=kv, head_dim=head_dim,
        d_ff=96,
        vocab=512,
        moe=moe,
        mla_kv_lora=32 if cfg.attn == 'mla' else 0,
        mla_rope_dim=8 if cfg.attn == 'mla' else cfg.mla_rope_dim,
        dense_d_ff_first=64 if cfg.dense_d_ff_first else 0,
        rwkv_head_dim=head_dim,
        frontend_tokens=4 if cfg.frontend == 'vision' else 0,
        mamba_d_state=8,
    )


def reduced(arch: str) -> ModelConfig:
    return reduce_config(get(arch))
