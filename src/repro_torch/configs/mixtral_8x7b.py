"""mixtral-8x7b — sparse MoE decoder with sliding-window attention.

[arXiv:2401.04088] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
8 experts top-2, SWA window 4096 (rolling-buffer KV cache at decode).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    top_k=2,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    citation="arXiv:2401.04088",
)
