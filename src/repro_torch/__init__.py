"""PyTorch/CUDA port of the HybridFlow serving system.

Mirrors ``repro`` module by module: the framework-free layers (configs,
data, core, traffic) are kept as copies, the dense-decoder model stack,
KV cache, serving engine and router are rewritten in PyTorch, and the
attention kernels of the serving path are hand-written CUDA C++ for
Hopper (``repro_torch.kernels``). The package imports neither JAX nor
``repro``. Entry points take ``device=`` and default to ``"cuda"``.
"""
