"""kimi-k2-1t-a32b — trillion-parameter MoE (paper-table cloud-scale executor).

[arXiv:2501.kimi2] 61L d_model=7168 64H (GQA kv=8) d_ff=2048 (per expert)
vocab=163840, MoE 384 experts top-8 (+1 shared expert). head_dim is set to
128 (hardware-aligned MXU tile; 7168/64=112 would misalign the systolic
array — noted in DESIGN.md as a TPU adaptation).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab_size=163840,
    n_experts=384,
    top_k=8,
    n_shared_experts=1,
    rope_theta=1_000_000.0,
    citation="arXiv:2501.kimi2",
)
