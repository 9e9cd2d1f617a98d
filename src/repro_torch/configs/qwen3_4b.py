"""qwen3-4b — dense GQA decoder with QK-norm.

[hf:Qwen/Qwen3-8B] (family spec) 36L d_model=2560 32H (GQA kv=8)
d_ff=9728 vocab=151936, qk_norm=True, head_dim=128 (Qwen3 uses explicit
head_dim 128 independent of d_model/n_heads).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    citation="hf:Qwen/Qwen3-8B",
)
