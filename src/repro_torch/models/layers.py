"""Dense-decoder primitives in PyTorch (counterpart of ``repro.models.layers``).

Parameters are nested dicts of tensors with the reference layout
(``dense`` computes ``x @ w`` with ``w`` as ``[d_in, d_out]``). Attention on
the serving path goes through :func:`_dispatch_attention`, which hands
the ragged-prefill, batched-decode and full-sequence shapes to the
kernel wrappers of ``repro_torch.kernels``: a CUDA tensor launches the
hand-written kernel, a CPU tensor runs its plain version.
:func:`attention` and :func:`ragged_prefill_attention` are the plain
twins of the reference's jnp path, kept as references for the tests.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.batched_decode_attention import (
    batched_decode_attention)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ragged_prefill_attention import (
    ragged_prefill_attention as ragged_prefill_kernel)


def dense(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rms_norm(p, x, eps: float = 1e-5):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# rotary position embedding
# --------------------------------------------------------------------------

def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions [..., S] -> cos/sin [..., S, head_dim//2] (float32)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x [..., S, H, hd]; cos/sin [..., S, hd//2] (broadcast over heads)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# attention: plain twins of the reference path
# --------------------------------------------------------------------------

def attention(q, k, v, *, causal: bool, window: Optional[int] = None,
              q_offset=0, kv_len=None):
    """Scaled dot-product attention with GQA, causal and sliding-window
    masks. q [B,Sq,H,hd]; k/v [B,Sk,KV,hd] -> [B,Sq,H,hd].

    ``q_offset`` is the absolute position of q[0] relative to k[0]: an
    int, or a per-row [B] tensor (ragged chunked prefill). ``kv_len``
    masks cache positions >= kv_len [B]. Fully masked rows are zeros."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(hd)
    dev = q.device
    if torch.is_tensor(q_offset):
        off = q_offset.long()[:, None, None]                     # [B,1,1]
    else:
        off = torch.full((1, 1, 1), int(q_offset), device=dev)
    qpos = torch.arange(sq, device=dev)[None, :, None] + off      # [.,Sq,1]
    kpos = torch.arange(sk, device=dev)[None, None, :]            # [1,1,Sk]
    mask = torch.ones((1, sq, sk), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    if kv_len is not None:
        mask = mask & (kpos < kv_len.long()[:, None, None])
    mask = mask[:, None]                                          # [.,1,Sq,Sk]
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask.any(-1, keepdim=True), probs, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out


def ragged_prefill_attention(q, k, v, *, pos0, take=None,
                             window: Optional[int] = None):
    """Plain twin of the ragged kernel: q [G,Sq,H,hd]; k/v [G,W,KV,hd];
    pos0/take [G]. Padding query rows (>= take) are zeros."""
    out = attention(q, k, v, causal=True, window=window, q_offset=pos0)
    if take is None:
        return out
    s = q.shape[1]
    valid = torch.arange(s, device=q.device)[None, :] < take[:, None]
    return torch.where(valid[:, :, None, None], out, torch.zeros_like(out))


def attn_qkv(p, cfg, x, *, positions=None):
    """Project to q/k/v heads; apply qk-norm and rope."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = dense(p["wq"], x).reshape(b, s, cfg.n_heads, hd)
    k = dense(p["wk"], x).reshape(b, s, cfg.n_kv_heads, hd)
    v = dense(p["wv"], x).reshape(b, s, cfg.n_kv_heads, hd)
    if "q_norm" in p:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    qpos = positions if positions is not None else \
        torch.arange(s, device=x.device)
    cos, sin = rope_cos_sin(qpos, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def full_attention(q, k, v, cfg, *, causal, window):
    """Training/prefill attention over the whole sequence (the reference's
    ``full_attention`` without its TPU knobs, which no config sets)."""
    if cfg.attention_block_q is not None or cfg.shard_attn_seq:
        raise NotImplementedError(
            "attention_block_q / shard_attn_seq are not ported: ROADMAP "
            "Queue A, item 10 (distributed and dry-run)")
    return _dispatch_attention(q, k, v, causal=causal, window=window)


def _dispatch_attention(q, k, v, *, causal, window, q_offset=0, kv_len=None,
                        take=None):
    """Route each attention shape to its kernel.

    Per-row ``q_offset`` [G] with a causal mask is ragged chunked prefill;
    one query token with ``kv_len`` is batched decode; a scalar
    ``q_offset`` without ``kv_len`` is full-sequence attention, for every
    query length (the reference gives one-token queries to its jnp
    attention; the flash kernel computes the same function). The device
    of the tensors decides inside each wrapper: the CUDA kernel on the
    card, its plain version on the CPU."""
    if torch.is_tensor(q_offset) and causal and kv_len is None:
        tk = take if take is not None else torch.full(
            (q.shape[0],), q.shape[1], dtype=torch.int32, device=q.device)
        return ragged_prefill_kernel(q, k, v, q_offset.int(), tk.int(),
                                     window=window)
    if q.shape[1] == 1 and kv_len is not None:
        return batched_decode_attention(q, k, v, kv_len.int(), window=window)
    if not torch.is_tensor(q_offset) and kv_len is None:
        return flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=int(q_offset))
    raise NotImplementedError(
        f"attention with q {tuple(q.shape)}, kv_len and a "
        f"{'per-row' if torch.is_tensor(q_offset) else 'scalar'} q_offset "
        f"is on no ported path")


# --------------------------------------------------------------------------
# MLP, embedding
# --------------------------------------------------------------------------

def mlp(p, cfg, x):
    """SwiGLU MLP (the dense family's activation)."""
    if "w_gate" not in p:
        raise NotImplementedError(
            f"{cfg.activation} MLP is not ported yet: ROADMAP Queue A, "
            f"other families")
    return dense(p["w_down"],
                 F.silu(dense(p["w_gate"], x)) * dense(p["w_up"], x))


def embed(p, tokens):
    return p["w"][tokens]


def unembed(p, x):
    return x @ p["w"].T
