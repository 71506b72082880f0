"""minicpm-2b [dense] — llama-like, WSD schedule, tied embeddings.
[arXiv:2404.06395; hf]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='minicpm-2b', family='dense',
        n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, head_dim=64,
        d_ff=5760, vocab=122753, act='swiglu', tie_embeddings=True,
        schedule='wsd')
