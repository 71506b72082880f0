"""moonshot-v1-16b-a3b [moe] — kimi/moonlight: 64 routed top-6 + 2 shared.
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from .base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='moonshot-v1-16b-a3b', family='moe',
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1408, vocab=163840, act='swiglu',
        moe=MoEConfig(num_experts=64, top_k=6, shared_experts=2, every=1,
                      moe_d_ff=1408),
        dense_d_ff_first=11264)
