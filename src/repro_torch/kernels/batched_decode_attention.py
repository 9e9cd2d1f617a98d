"""Batched decode attention: the CUDA kernel's wrapper and its plain PyTorch
version.

Replaces the Pallas TPU kernel ``_batched_decode_kernel`` /
``batched_decode_attention_bhmd`` (``src/repro/kernels/batched_decode_attention.py``),
reached there through ``ops.decode_attention``. It runs on every decode
tick of every layer of the serving engine.

One query token per slot attends the slot-pooled cache, masked to the
slot's ``kv_len[b]`` valid lines and, with ``window``, to the last
``window`` of them (``kv_len - window <= key < kv_len``); ``kv_len == 0``
gives exact zeros.

On the H100 the ideal kernel is bound by the bytes of the cache it reads
(one token does 4 flops per cache element). This kernel
(``csrc/batched_decode_attention.cu``) gives one block to each (slot, KV
head), so the heads of a GQA group share every line, splits the valid
lines across the block's warps to shorten each warp's serial walk, and
never reads a line past ``kv_len`` or below the window. See the source
for the layout.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build

NAME = "batched_decode_attention"


def batched_decode_attention(q, k, v, kv_len, *,
                             window: Optional[int] = None):
    """q [B,1,H,hd]; k/v [B,M,KV,hd]; kv_len int32 [B] -> [B,1,H,hd].

    A CUDA tensor launches the kernel (the call raises if it cannot); a
    CPU tensor takes :func:`batched_decode_attention_plain`."""
    B, H, hd = _check(q, k, v, kv_len, window)
    if not q.is_cuda:
        return batched_decode_attention_plain(q, k, v, kv_len, window=window)
    M, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = _build.load(NAME)
    err = lib.batched_decode_attention(
        _build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), kv_len.data_ptr(), out.data_ptr(), B, H, KV, M, hd,
        window or 0, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(NAME, lib, err)
    batched_decode_attention.launches += 1
    return out


batched_decode_attention.launches = 0


def _check(q, k, v, kv_len, window):
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,1,H,hd] and k/v [B,M,KV,hd], got "
                         f"{tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    B, _, H, hd = q.shape
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
    if kv_len.dtype != torch.int32 or kv_len.shape != (B,):
        raise ValueError(f"kv_len must be int32 [{B}], got {kv_len.dtype} "
                         f"{tuple(kv_len.shape)}")
    for t in (q, k, v, kv_len):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("all inputs must be contiguous and on "
                             f"{q.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    return B, H, hd


def batched_decode_attention_plain(q, k, v, kv_len, *,
                                   window: Optional[int] = None):
    """The kernel's function in plain PyTorch (fp32 softmax), same layout."""
    batched_decode_attention_plain.calls += 1
    B, _, H, hd = q.shape
    M, KV = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(H // KV, dim=2)
    vf = v.float().repeat_interleave(H // KV, dim=2)
    scores = torch.einsum("bhd,bmhd->bhm", q[:, 0].float(), kf) / math.sqrt(hd)
    kpos = torch.arange(M, device=q.device)[None, :]
    n = kv_len.long()[:, None]
    mask = kpos < n
    if window is not None:
        mask &= kpos >= n - window
    scores = scores.masked_fill(~mask[:, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask[:, None].any(-1, keepdim=True), probs, 0.0)
    return torch.einsum("bhm,bmhd->bhd", probs, vf)[:, None].to(q.dtype)


batched_decode_attention_plain.calls = 0
