"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 64 routed top-6 + 2 shared
experts (expert d_ff=1408); layer 0 dense FFN. [arXiv:2405.04434; hf]"""
from .base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='deepseek-v2-lite-16b', family='moe',
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1408, vocab=102400, act='swiglu',
        attn='mla', mla_kv_lora=512, mla_rope_dim=64,
        moe=MoEConfig(num_experts=64, top_k=6, shared_experts=2, every=1,
                      moe_d_ff=1408),
        dense_d_ff_first=10944)
