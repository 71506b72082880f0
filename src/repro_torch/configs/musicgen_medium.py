"""musicgen-medium [audio] — decoder-only over EnCodec tokens; the EnCodec
frontend is a stub: input_specs() provides precomputed frame embeddings.
[arXiv:2306.05284; hf]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='musicgen-medium', family='audio',
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
        d_ff=6144, vocab=2048, act='swiglu',
        frontend='audio', frontend_tokens=0)
