"""Slot-pooled KV cache for serving (counterpart of ``repro.models.kvcache``).

The cache is ``{"k", "v"}`` of shape ``[L, B, M, KV, hd]``: L layers, B
serving slots, M lines per slot. Keys are stored post-RoPE. Every write
here updates the cache tensors in place, where the reference returns new
arrays; the reference drops padded columns with an out-of-bounds
``mode="drop"`` scatter, which PyTorch lacks, so these functions index
only valid lines (without a device-to-host sync: padded columns are
redirected onto the row's last valid line with that line's own value).
"""
from __future__ import annotations

import zlib
from typing import List, Optional

import numpy as np
import torch

# Token-block granularity for cross-request KV prefix reuse: prefixes are
# hashed (and shared) in units of this many tokens, so a borrower can only
# skip prefill for whole blocks it matches exactly.
PREFIX_BLOCK = 16


def cache_len(cfg, shape_seq: int) -> int:
    """Cache lines for a ``shape_seq``-token context: the decode window
    (a rolling buffer) when the config has one, else the context plus a
    margin of 8 lines."""
    w = cfg.decode_window()
    if w is not None:
        return w
    return shape_seq + 8


def stored_kv_heads(cfg) -> int:
    return cfg.kv_cache_expand_heads or cfg.n_kv_heads


def expand_kv_for_cache(cfg, k):
    """[B,S,KV,hd] -> [B,S,stored,hd] by repeating each kv head."""
    tgt = stored_kv_heads(cfg)
    kv = k.shape[2]
    if tgt == kv:
        return k
    return k.repeat_interleave(tgt // kv, dim=2)


def init_attn_cache(cfg, batch: int, max_len: int, n_layers: int,
                    dtype=torch.bfloat16, device: str = "cuda"):
    hd = cfg.resolved_head_dim
    shape = (n_layers, batch, max_len, stored_kv_heads(cfg), hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def write_prefill(cache_k, cache_v, k, v, window: Optional[int]):
    """Single-layer prefill write, in place. cache [B,M,KV,hd]; k/v
    [B,S,KV,hd] land on lines [0, S).

    A rolling buffer stores position p at line p % M: a windowed prompt
    longer than the buffer keeps its last M tokens, rolled by
    ``(S - M) % M`` into those lines, so later decode writes evict the
    oldest entry."""
    M = cache_k.shape[1]
    S = k.shape[1]
    if window is not None and S > M:
        k, v = k[:, -M:], v[:, -M:]
        shift = (S - M) % M
        if shift:
            k = torch.roll(k, shift, dims=1)
            v = torch.roll(v, shift, dims=1)
        S = M
    if S > M:
        raise ValueError(f"prompt of {S} tokens exceeds cache lines {M}")
    cache_k[:, :S] = k
    cache_v[:, :S] = v
    return cache_k, cache_v


def write_chunk(cache_k, cache_v, k, v, slot_idx, pos0, take):
    """Batched ragged chunk write into one layer of the slot pool, in place.

    cache [B, M, KV, hd]; k/v [G, S, KV, hd] right-padded chunks. Row ``g``
    writes its first ``take[g]`` lines (1 <= take <= S) at positions
    [pos0[g], pos0[g] + take[g]) of pool row ``slot_idx[g]``; lines it
    does not own are left untouched."""
    M = cache_k.shape[1]
    G, S = k.shape[:2]
    if S > M:
        raise ValueError(f"chunk width {S} exceeds cache lines {M}")
    s = torch.arange(S, device=k.device)[None, :]
    s_eff = torch.minimum(s, take.long()[:, None] - 1)       # [G, S]
    cols = pos0.long()[:, None] + s_eff
    rows = slot_idx.long()[:, None].expand(G, S)
    g = torch.arange(G, device=k.device)[:, None].expand(G, S)
    cache_k[rows, cols] = k[g, s_eff]
    cache_v[rows, cols] = v[g, s_eff]
    return cache_k, cache_v


def prefix_block_hashes(ids, block: int = PREFIX_BLOCK) -> List[int]:
    """Chained crc32 per full token block: ``hashes[b]`` covers tokens
    [0, (b+1)*block), so two prompts sharing hash ``b`` share (modulo
    collisions, which the index resolves by exact token comparison) their
    whole first ``(b+1)*block`` tokens — a single int per boundary gives
    longest-prefix lookup without storing every sub-prefix."""
    n = (len(ids) // block) * block
    if n == 0:
        return []
    arr = np.asarray(ids[:n], np.int32)
    out, h = [], 0
    for i in range(0, n, block):
        h = zlib.crc32(arr[i:i + block].tobytes(), h)
        out.append(h)
    return out


def copy_prefix(cache_k, cache_v, src_idx, dst_idx, length, width: int):
    """Batched cross-slot prefix copy on a stacked [L, B, M, KV, hd] pool,
    in place.

    Row ``g`` copies lines [0, length[g]) (1 <= length <= width) of slot
    ``src_idx[g]`` into slot ``dst_idx[g]`` across every layer. All
    sources are gathered before any destination is written, so a
    destination may be another row's source."""
    M = cache_k.shape[2]
    if width > M:
        raise ValueError(f"copy width {width} exceeds cache lines {M}")
    G = src_idx.shape[0]
    j = torch.arange(width, device=cache_k.device)[None, :]
    j_eff = torch.minimum(j, length.long()[:, None] - 1)      # [G, W]
    src = src_idx.long()[:, None].expand(G, width)
    dst = dst_idx.long()[:, None].expand(G, width)
    src_k = cache_k[:, src, j_eff]                            # [L,G,W,KV,hd]
    src_v = cache_v[:, src, j_eff]
    cache_k[:, dst, j_eff] = src_k
    cache_v[:, dst, j_eff] = src_v
    return cache_k, cache_v


def write_decode(cache_k, cache_v, k, v, pos, window: Optional[int]):
    """Write one token per slot at absolute position ``pos`` [B], in place."""
    M = cache_k.shape[1]
    b = torch.arange(cache_k.shape[0], device=cache_k.device)
    pos = pos.long()
    slot = pos % M if window is not None else torch.clamp(pos, max=M - 1)
    cache_k[b, slot] = k[:, 0]
    cache_v[b, slot] = v[:, 0]
    return cache_k, cache_v


def valid_len(pos, max_len: int, window: Optional[int]):
    """Number of valid cache slots after writing token at ``pos`` [B]."""
    return torch.clamp(pos + 1, max=max_len)
