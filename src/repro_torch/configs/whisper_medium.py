"""whisper-medium — encoder-decoder audio model (conv frontend stubbed).

[arXiv:2212.04356] 24L (decoder; +24L encoder) d_model=1024 16H (kv=16, MHA)
d_ff=4096 vocab=51865. The mel-spectrogram + 2x conv1d frontend is a STUB:
``input_specs()`` provides precomputed frame embeddings (B, 1500, d_model).
GELU MLP as in the paper. vocab 51865 is padded to 51968 for clean
model-axis sharding (see DESIGN.md §5).

Decode shapes: decode_32k runs (self-attn KV cache over generated tokens +
cross-attn to the fixed 1500-frame encoder memory). long_500k is skipped —
full attention and transcript-bounded decode length (DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    is_encoder_decoder=True,
    n_encoder_layers=24,
    encoder_seq=1500,
    activation="gelu",
    rope_theta=10_000.0,
    citation="arXiv:2212.04356",
)
