"""qwen2-1.5b — dense GQA decoder with QKV bias.

[arXiv:2407.10671] 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936,
qkv_bias=True. For long_500k decode we serve a sliding-window variant
(long_context_window=4096), per DESIGN.md §4.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    long_context_window=4096,
    rope_theta=1_000_000.0,
    citation="arXiv:2407.10671",
)
