"""Dense-decoder model stack in PyTorch: layers, KV cache, transformer
and the family dispatch of ``model``."""
