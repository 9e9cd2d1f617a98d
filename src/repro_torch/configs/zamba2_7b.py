"""zamba2-7b — hybrid Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242] 81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000,
ssm_state=64. Mamba2 layers with ONE shared-parameter attention+MLP block
applied every ``attn_every`` layers (Zamba2's shared transformer block);
the shared block's weights live outside the scanned Mamba stack.
long_500k runs: SSM state is O(1) in sequence length and the shared
attention uses a rolling window at decode.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    attn_every=6,
    long_context_window=4096,
    rope_theta=10_000.0,
    citation="arXiv:2411.15242",
)
