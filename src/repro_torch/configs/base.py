"""Config dataclasses for models, input shapes, and training."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    shared_experts: int = 0
    every: int = 1              # MoE on layers with (l % every == every - 1)
    capacity_factor: float = 1.25
    moe_d_ff: int = 0           # per-expert FFN width


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = 'swiglu'         # swiglu | sq_relu
    attn: str = 'gqa'           # gqa | mla | rwkv6 | (per-layer for hybrids)
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    # MLA (DeepSeek-V2) dimensions
    mla_kv_lora: int = 0
    mla_rope_dim: int = 64
    # MoE
    moe: Optional[MoEConfig] = None
    moe_impl: str = 'gather'    # gather (baseline) | ep (shard_map, §Perf B)
    dense_d_ff_first: int = 0   # e.g. DeepSeek-V2: layer 0 uses a dense FFN
    # Hybrid (Jamba): layer l is attention iff l % hybrid_period == hybrid_attn_at
    hybrid_period: int = 0
    hybrid_attn_at: int = 0
    # Mamba
    mamba_d_state: int = 16
    mamba_conv: int = 4
    mamba_expand: int = 2
    # RWKV-6
    rwkv_head_dim: int = 64
    wkv_impl: str = 'scan'      # scan (baseline) | kernel (Pallas, §Perf A)
    # Modality frontend stub: 'none' | 'vision' | 'audio'
    frontend: str = 'none'
    frontend_tokens: int = 0    # e.g. 256 image-patch embeddings per sample
    # numerics
    dtype: str = 'bfloat16'
    # training schedule hint (minicpm uses WSD)
    schedule: str = 'cosine'    # cosine | wsd

    @property
    def sub_quadratic(self) -> bool:
        """True if decode state does not grow quadratically with context —
        i.e. long_500k is runnable (SSM / hybrid families)."""
        return self.attn == 'rwkv6' or self.hybrid_period > 0

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    def layer_kind(self, l: int) -> str:
        """'attn' | 'mamba' | 'rwkv6' for layer l."""
        if self.attn == 'rwkv6':
            return 'rwkv6'
        if self.hybrid_period > 0:
            return ('attn' if l % self.hybrid_period == self.hybrid_attn_at
                    else 'mamba')
        return 'attn'

    def layer_is_moe(self, l: int) -> bool:
        if self.moe is None:
            return False
        if self.dense_d_ff_first and l == 0:
            return False
        return l % self.moe.every == self.moe.every - 1


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


# The assigned LM-family shape set (identical across the 10 archs).
TRAIN_4K = ShapeConfig('train_4k', 4096, 256, 'train')
PREFILL_32K = ShapeConfig('prefill_32k', 32768, 32, 'prefill')
DECODE_32K = ShapeConfig('decode_32k', 32768, 128, 'decode')
LONG_500K = ShapeConfig('long_500k', 524288, 1, 'decode')
LM_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ModelConfig):
    """The runnable shape cells for an architecture.

    long_500k requires sub-quadratic attention (assignment rule): run for
    SSM/hybrid archs, skip for pure full-attention archs (recorded in
    DESIGN.md §Arch-applicability).
    """
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.sub_quadratic:
        out.append(LONG_500K)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 100
    decay_steps: int = 10000
    stable_steps: int = 0        # WSD: warmup -> stable -> decay
    grad_clip: float = 1.0
    microbatches: int = 1        # gradient-accumulation splits of the batch
    remat: str = 'layer'         # none | layer (checkpoint each scanned layer)
    objective: str = 'lm'        # lm | rank_hinge (reward-model ranking head)
