"""xlstm-350m — recurrent xLSTM (sLSTM + mLSTM blocks, attention-free).

[arXiv:2405.04517] 24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304.
Blocks alternate mLSTM (matrix memory, chunked-parallel gated linear
recurrence) and sLSTM (scalar memory, sequential lax.scan) at the
configured ratio. No attention => O(1) decode state; long_500k runs.
Deviation from the paper's exponential-gate stabilizer: we use
sigmoid input gates (bounded, no m-state) — recorded in DESIGN.md.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    ssm_expand=2,
    ssm_head_dim=256,  # d_inner=2048 over 8 effective heads... per-block heads=4
    mlstm_per_slstm=3,
    citation="arXiv:2405.04517",
)
