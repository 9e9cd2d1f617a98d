"""Ragged chunked-prefill attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``_ragged_prefill_kernel`` /
``ragged_prefill_attention_bhsd`` (``src/repro/kernels/ragged_prefill_attention.py``),
reached there through ``ops.ragged_prefill_attention``. It runs on every
prefill chunk of every layer of the serving engine.

Row ``g`` of a chunk batch holds ``take[g]`` valid query tokens whose
absolute positions start at ``pos0[g]``, attending its first W pooled
cache lines under a causal mask and an optional sliding window at those
per-row positions; query rows past ``take[g]`` come out as zeros.

On the H100 the kernel (``csrc/ragged_prefill_attention.cu``) is bound by
its per-line warp reductions on the CUDA cores, not by the bytes it
reads: it gives each warp one query position and up to four heads of a
GQA group, which share every K/V line it loads, and it turns the TPU
kernel's dead-block skip into loop bounds, so a row reads only the lines
its mask admits. See the source for the layout.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build

NAME = "ragged_prefill_attention"


def ragged_prefill_attention(q, k, v, pos0, take, *,
                             window: Optional[int] = None):
    """q [G,S,H,hd]; k/v [G,W,KV,hd]; pos0/take int32 [G] -> [G,S,H,hd].

    A CUDA tensor launches the kernel (the call raises if it cannot); a
    CPU tensor takes :func:`ragged_prefill_attention_plain`."""
    G, S, H, hd = _check(q, k, v, pos0, take, window)
    if not q.is_cuda:
        return ragged_prefill_attention_plain(q, k, v, pos0, take,
                                              window=window)
    W, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = _build.load(NAME)
    err = lib.ragged_prefill_attention(
        _build.DTYPE_CODES[q.dtype],
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos0.data_ptr(),
        take.data_ptr(), out.data_ptr(), G, S, H, KV, W, hd,
        window or 0, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(NAME, lib, err)
    ragged_prefill_attention.launches += 1
    return out


ragged_prefill_attention.launches = 0


def _check(q, k, v, pos0, take, window):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [G,S,H,hd] and k/v [G,W,KV,hd], got "
                         f"{tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    G, S, H, hd = q.shape
    if k.shape[0] != G or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if hd % 16 or hd > 128:
        raise ValueError(f"head dim {hd} must be a multiple of 16, <= 128")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype} {k.dtype} {v.dtype}")
    for name, t in (("pos0", pos0), ("take", take)):
        if t.dtype != torch.int32 or t.shape != (G,):
            raise ValueError(f"{name} must be int32 [{G}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (q, k, v, pos0, take):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("all inputs must be contiguous and on "
                             f"{q.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    return G, S, H, hd


def ragged_prefill_attention_plain(q, k, v, pos0, take, *,
                                   window: Optional[int] = None):
    """The kernel's function in plain PyTorch (fp32 softmax), same layout."""
    ragged_prefill_attention_plain.calls += 1
    G, S, H, hd = q.shape
    W, KV = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(H // KV, dim=2)
    vf = v.float().repeat_interleave(H // KV, dim=2)
    scores = torch.einsum("gshd,gwhd->ghsw", q.float(), kf) / math.sqrt(hd)
    row = torch.arange(S, device=q.device)
    qpos = pos0.long()[:, None] + row[None, :]                 # [G,S]
    kpos = torch.arange(W, device=q.device)[None, None, :]     # [1,1,W]
    mask = (kpos <= qpos[..., None]) & (row[None, :, None] <
                                       take.long()[:, None, None])
    if window is not None:
        mask &= kpos > qpos[..., None] - window
    scores = scores.masked_fill(~mask[:, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask[:, None].any(-1, keepdim=True), probs, 0.0)
    return torch.einsum("ghsw,gwhd->gshd", probs, vf).to(q.dtype)


ragged_prefill_attention_plain.calls = 0
