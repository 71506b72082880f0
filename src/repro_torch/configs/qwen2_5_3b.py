"""qwen2.5-3b [dense] — GQA kv=2, QKV bias, tied embeddings.
[hf:Qwen/Qwen2.5-3B; hf]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='qwen2.5-3b', family='dense',
        n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, head_dim=128,
        d_ff=11008, vocab=151936, act='swiglu', qkv_bias=True,
        tie_embeddings=True, rope_theta=1000000.0)
