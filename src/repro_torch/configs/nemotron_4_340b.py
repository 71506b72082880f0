"""nemotron-4-340b [dense] — GQA kv=8, squared-ReLU (non-gated) FFN.
[arXiv:2402.16819; unverified]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='nemotron-4-340b', family='dense',
        n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, head_dim=192,
        d_ff=73728, vocab=256000, act='sq_relu', tie_embeddings=False)
