"""internvl2-26b [vlm] — InternViT (stub frontend) + InternLM2-20B backbone.
[arXiv:2404.16821; hf]  input_specs() provides precomputed patch embeddings."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='internvl2-26b', family='vlm',
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab=92553, act='swiglu',
        frontend='vision', frontend_tokens=256)
