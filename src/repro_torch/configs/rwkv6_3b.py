"""rwkv6-3b [ssm] — Finch: attention-free, data-dependent decay.
[arXiv:2404.05892; hf]"""
from .base import ModelConfig


def config() -> ModelConfig:
    # 2560 / 64 = 40 heads of size 64 (RWKV-6 convention).
    return ModelConfig(
        name='rwkv6-3b', family='ssm',
        n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
        d_ff=8960, vocab=65536, attn='rwkv6', rwkv_head_dim=64)
