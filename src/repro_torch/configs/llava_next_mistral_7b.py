"""llava-next-mistral-7b — VLM: Mistral-7B language backbone + anyres vision stub.

[hf:llava-hf/llava-v1.6-mistral-7b-hf] 32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=32000. The vision tower (CLIP ViT-L/336 + anyres tiling +
2-layer MLP projector) is a STUB per the assignment: ``input_specs()``
provides precomputed patch embeddings of shape (B, n_patches, d_model).
LLaVA-NeXT anyres uses up to 5 tiles x 576 patches; we provision the base
576-patch grid as the prepended multimodal prefix.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1_000_000.0,
    n_image_patches=576,
    citation="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
