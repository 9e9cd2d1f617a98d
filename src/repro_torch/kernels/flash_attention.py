"""Full-sequence (flash) attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``_flash_kernel`` / ``flash_attention_bhsd``
(``src/repro/kernels/flash_attention.py``), reached there through
``ops.flash_attention``. It runs on every layer of the batch-1 prefill
that the serving engine gives the families outside
``CHUNKED_PREFILL_FAMILIES`` (moe first), and later on training and
cross-attention.

Query position ``i`` sits at absolute position ``i + q_offset`` (a
Python int) and attends key ``j`` of the same batch row when ``j < Sk``,
``j <= i + q_offset`` under ``causal``, and ``j > i + q_offset - window``
with a ``window``; query head ``h`` reads KV head ``h // (H // KV)``. A
row that admits no key comes out as exact zeros.

On the H100 the ideal kernel at the serving shapes is bound by the bytes
it reads and writes. This kernel (``csrc/flash_attention.cu``) gives one
block to each (q tile, KV head, batch row), so the query rows of a whole
GQA group share each K/V tile it stages in shared memory, and turns the
causal and window bounds into the range of K tiles it walks. In bf16
(the serving path) its products run on the tensor cores (``mma.sync``);
in float32 as fp32 FMAs on the CUDA cores. Its K/V loads are not
pipelined, so load latency and the serial walk of the last q tiles bound
it, not the bytes. See the source for the layout.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build

NAME = "flash_attention"


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0):
    """q [B,Sq,H,hd]; k/v [B,Sk,KV,hd] -> [B,Sq,H,hd].

    A CUDA tensor launches the kernel (the call raises if it cannot); a
    CPU tensor takes :func:`flash_attention_plain`."""
    B, Sq, H, hd = _check(q, k, v, window, q_offset)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    Sk, KV = k.shape[1], k.shape[2]
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q/k/v must start on a 16-byte boundary")
    out = torch.empty_like(q)
    lib = _build.load(NAME)
    err = lib.flash_attention(
        _build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), B, Sq, Sk, H, KV, hd, int(causal),
        window or 0, q_offset, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(NAME, lib, err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _check(q, k, v, window, q_offset):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,Sq,H,hd] and k/v [B,Sk,KV,hd], got "
                         f"{tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % KV:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if hd % 16 or hd > 128:
        raise ValueError(f"head dim {hd} must be a multiple of 16, <= 128")
    if H // KV > 64:
        raise ValueError(f"GQA group of {H // KV} heads exceeds 64")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype} {k.dtype} {v.dtype}")
    for t in (q, k, v):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("all inputs must be contiguous and on "
                             f"{q.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if not isinstance(q_offset, int):
        raise TypeError(f"q_offset must be a Python int, got "
                        f"{type(q_offset).__name__}")
    return B, Sq, H, hd


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None, q_offset: int = 0):
    """The kernel's function in plain PyTorch (fp32 softmax), same layout."""
    flash_attention_plain.calls += 1
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(H // KV, dim=2)
    vf = v.float().repeat_interleave(H // KV, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset   # [Sq,1]
    kpos = torch.arange(Sk, device=q.device)[None, :]              # [1,Sk]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask.any(-1, keepdim=True), probs, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)


flash_attention_plain.calls = 0
