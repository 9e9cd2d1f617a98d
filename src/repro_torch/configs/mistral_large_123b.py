"""mistral-large-123b — dense decoder.

[hf:mistralai/Mistral-Large-Instruct-2407] 88L d_model=12288 96H (GQA kv=8)
d_ff=28672 vocab=32768. Full attention; for the long_500k decode shape we
serve an explicit sliding-window variant (long_context_window=4096 rolling
KV buffer), a beyond-paper serving adaptation noted in DESIGN.md.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    rope_theta=1_000_000.0,
    long_context_window=4096,
    citation="hf:mistralai/Mistral-Large-Instruct-2407",
)
