"""command-r-plus-104b [dense] — GQA, no-bias, tied embeddings.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='command-r-plus-104b', family='dense',
        n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
        d_ff=33792, vocab=256000, act='swiglu', qkv_bias=False,
        tie_embeddings=True, rope_theta=75000.0)
