"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Ported from the Pallas TPU kernels of ``repro.kernels``:

* ``ragged_prefill_attention`` — batched ragged chunked-prefill attention
  (every prefill chunk of the serving engine);
* ``batched_decode_attention`` — one decode token per slot over the
  slot-pooled cache (every decode tick);
* ``flash_attention`` — full-sequence attention with a static query
  offset (every layer of the engine's batch-1 legacy prefill).

Contract of every kernel module: the public wrapper launches the CUDA
kernel for CUDA tensors and raises if it cannot (build failure, bad
shape, launch error) — there is no fallback on the card; for CPU tensors
it calls the module's ``*_plain`` PyTorch version, which is also the
reference the kernel is held against on the card. The wrapper counts its
launches in ``<wrapper>.launches`` and the plain version its calls in
``<plain>.calls``. Sources live in ``csrc/`` and are compiled by
``_build`` at first use (``nvcc -gencode arch=compute_90a,code=sm_90a``,
loaded with ctypes).
"""
