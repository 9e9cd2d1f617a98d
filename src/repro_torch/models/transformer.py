"""Decoder stack in PyTorch for the dense and moe families (counterpart
of that subset of ``repro.models.transformer``).

Parameters keep the reference pytree: per-layer leaves are stacked on a
leading ``L`` axis (``params["layers"]["attn"]["wq"]["w"]`` is
``[L, d_in, d_out]``), and the layer loop indexes views of them. The
per-layer KV cache ``cache["k"][l]`` is a view too, updated in place by
the kvcache writes — this takes the place of the reference's scan carry
(``carry_cache``) and its donated buffers.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import kvcache as KV
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE


def _layer(tree, i: int):
    """Views of layer ``i`` in a tree of stacked ``[L, ...]`` leaves."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def init_decoder_model(cfg, *, dtype=torch.float32, device: str = "cuda",
                       generator=None):
    """Random parameters at the reference's scales: dense weights
    N(0, 1/d_in), embeddings N(0, 0.02^2), norms one, biases zero; a moe
    layer has a float32 router and experts N(0, 1/D) (gate, up) and
    N(0, 1/F) (down). Draws from ``generator``, a ``torch.Generator`` on
    ``device``."""
    Lz, D, Vp = cfg.n_layers, cfg.d_model, cfg.padded_vocab()

    def normal(shape, scale, dt=dtype):
        w = torch.randn(shape, generator=generator, device=device, dtype=dt)
        return w.mul_(scale)

    def dense(d_in, d_out, bias=False):
        p = {"w": normal((Lz, d_in, d_out), 1.0 / math.sqrt(d_in))}
        if bias:
            p["b"] = torch.zeros((Lz, d_out), dtype=dtype, device=device)
        return p

    def ones(d):
        return {"scale": torch.ones((Lz, d), dtype=dtype, device=device)}

    attn = {"wq": dense(D, cfg.q_dim, cfg.qkv_bias),
            "wk": dense(D, cfg.kv_dim, cfg.qkv_bias),
            "wv": dense(D, cfg.kv_dim, cfg.qkv_bias),
            "wo": dense(cfg.q_dim, D)}
    if cfg.qk_norm:
        attn["q_norm"] = ones(cfg.resolved_head_dim)
        attn["k_norm"] = ones(cfg.resolved_head_dim)

    def swiglu(d_ff):
        return {"w_gate": dense(D, d_ff), "w_up": dense(D, d_ff),
                "w_down": dense(d_ff, D)}

    layers = {"ln1": ones(D), "attn": attn, "ln2": ones(D)}
    if cfg.family == "moe":
        E, Fd = cfg.n_experts, cfg.d_ff
        layers["moe"] = {
            "router": {"w": normal((Lz, D, E), 1.0 / math.sqrt(D),
                                   torch.float32)},
            "w_gate": normal((Lz, E, D, Fd), 1.0 / math.sqrt(D)),
            "w_up": normal((Lz, E, D, Fd), 1.0 / math.sqrt(D)),
            "w_down": normal((Lz, E, Fd, D), 1.0 / math.sqrt(Fd))}
        if cfg.n_shared_experts:
            layers["moe"]["shared"] = swiglu(cfg.d_ff * cfg.n_shared_experts)
    else:
        layers["mlp"] = swiglu(cfg.d_ff)
    p = {
        "embed": {"w": normal((Vp, D), 0.02)},
        "layers": layers,
        "final_norm": {"scale": torch.ones(D, dtype=dtype, device=device)},
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": normal((Vp, D), 0.02)}
    return p


def _logits(p, cfg, h):
    head = p.get("lm_head", p["embed"])
    logits = L.unembed(head, h)
    if cfg.padded_vocab() != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e9
    return logits


def _mlp(p_l, cfg, hn):
    """The layer's MLP: the MoE layer (its aux loss is dropped when
    serving) or the dense swiglu."""
    if "moe" in p_l:
        return MOE.moe_forward(p_l["moe"], cfg, hn)[0]
    return L.mlp(p_l["mlp"], cfg, hn)


def _embed_inputs(p, cfg, batch):
    """Token embeddings of ``batch["tokens"]`` (the vlm patch prefix is
    not ported: ROADMAP Queue A, item 8)."""
    return L.embed(p["embed"], batch["tokens"])


def decoder_layer_prefill(p_l, cfg, h, ck, cv, *, window=None):
    """Full-sequence layer step that also fills this layer's KV cache
    (ck/cv [B, M, KV, hd], written in place) — the batch-1 legacy
    prefill's layer, through the flash-attention kernel."""
    hn = L.rms_norm(p_l["ln1"], h, cfg.norm_eps)
    q, k, v = L.attn_qkv(p_l["attn"], cfg, hn)
    out = L.full_attention(q, k, v, cfg, causal=True, window=window)
    b, s = h.shape[:2]
    h = h + L.dense(p_l["attn"]["wo"], out.reshape(b, s, cfg.q_dim))
    KV.write_prefill(ck, cv, KV.expand_kv_for_cache(cfg, k).to(ck.dtype),
                     KV.expand_kv_for_cache(cfg, v).to(cv.dtype), window)
    hn = L.rms_norm(p_l["ln2"], h, cfg.norm_eps)
    return h + _mlp(p_l, cfg, hn)


def decoder_prefill(p, cfg, batch, cache):
    """Fill ``cache`` (in place) from a prompt ``batch["tokens"]`` [B, S];
    returns (last-token logits [B, 1, V], cache)."""
    h = _embed_inputs(p, cfg, batch)
    window = cfg.decode_window()
    for i in range(cfg.n_layers):
        h = decoder_layer_prefill(_layer(p["layers"], i), cfg, h,
                                  cache["k"][i], cache["v"][i],
                                  window=window)
    h = L.rms_norm(p["final_norm"], h, cfg.norm_eps)
    return _logits(p, cfg, h[:, -1:]), cache


def decoder_layer_prefill_chunk(p_l, cfg, h, ck, cv, slot_idx, positions,
                                pos0, take, *, window=None, kv_width=None):
    """Chunked-prefill layer step writing this layer's slot-pooled cache.

    h [G, S, D]; ck/cv [B, M, KV, hd], the whole slot pool of this layer
    (written in place). Row ``g`` occupies pool row ``slot_idx[g]`` from
    absolute offset ``pos0[g]``, with ``take[g]`` real tokens; attention
    reads the row's first ``kv_width`` lines through the ragged kernel."""
    hn = L.rms_norm(p_l["ln1"], h, cfg.norm_eps)
    q, k, v = L.attn_qkv(p_l["attn"], cfg, hn, positions=positions)
    KV.write_chunk(ck, cv, KV.expand_kv_for_cache(cfg, k).to(ck.dtype),
                   KV.expand_kv_for_cache(cfg, v).to(cv.dtype),
                   slot_idx, pos0, take)
    w = kv_width if kv_width is not None else ck.shape[1]
    ckg = ck[slot_idx.long(), :w].to(q.dtype)
    cvg = cv[slot_idx.long(), :w].to(q.dtype)
    out = L._dispatch_attention(q, ckg, cvg, causal=True, window=window,
                                q_offset=pos0, take=take)
    g_, s_ = h.shape[:2]
    h = h + L.dense(p_l["attn"]["wo"], out.reshape(g_, s_, cfg.q_dim))
    hn = L.rms_norm(p_l["ln2"], h, cfg.norm_eps)
    return h + L.mlp(p_l["mlp"], cfg, hn)


def decoder_prefill_chunk(p, cfg, tokens, cache, slot_idx, pos0, take,
                          kv_width=None):
    """Batched ragged chunked prefill for dense decoders.

    tokens [G, S] right-padded chunk ids; slot_idx/pos0/take [G] (int32,
    1 <= take <= S); ``kv_width`` >= max(pos0 + take) bounds the lines
    attention reads. KV lines land in ``cache`` in place. Returns (logits
    [G, 1, V] at each row's last valid token, cache)."""
    h = L.embed(p["embed"], tokens)
    window = cfg.decode_window()
    S = tokens.shape[1]
    positions = pos0[:, None] + torch.arange(S, device=tokens.device)[None]
    for i in range(cfg.n_layers):
        h = decoder_layer_prefill_chunk(
            _layer(p["layers"], i), cfg, h, cache["k"][i], cache["v"][i],
            slot_idx, positions, pos0, take, window=window,
            kv_width=kv_width)
    h = L.rms_norm(p["final_norm"], h, cfg.norm_eps)
    idx = (take.long() - 1)[:, None, None].expand(-1, 1, h.shape[-1])
    return _logits(p, cfg, torch.gather(h, 1, idx)), cache


def decoder_layer_decode(p_l, cfg, h, ck, cv, pos, *, window=None):
    """One-token layer step. h [B,1,D]; pos [B] absolute position."""
    hn = L.rms_norm(p_l["ln1"], h, cfg.norm_eps)
    q, k, v = L.attn_qkv(p_l["attn"], cfg, hn, positions=pos[:, None])
    KV.write_decode(ck, cv, KV.expand_kv_for_cache(cfg, k).to(ck.dtype),
                    KV.expand_kv_for_cache(cfg, v).to(cv.dtype), pos, window)
    kvl = KV.valid_len(pos, ck.shape[1], window)
    # window=None on purpose, as in the reference: its decode attends every
    # valid line of the cache, while chunked prefill applies the window
    out = L._dispatch_attention(q, ck.to(q.dtype), cv.to(q.dtype),
                                causal=False, window=None, kv_len=kvl)
    b = h.shape[0]
    h = h + L.dense(p_l["attn"]["wo"], out.reshape(b, 1, cfg.q_dim))
    hn = L.rms_norm(p_l["ln2"], h, cfg.norm_eps)
    # moe: every slot is routed, parked ones included, as in the reference
    return h + _mlp(p_l, cfg, hn)


def decoder_decode(p, cfg, token, pos, cache):
    """token [B,1]; pos [B]. Returns (logits [B,1,V], cache), the cache
    updated in place."""
    h = L.embed(p["embed"], token)
    window = cfg.decode_window()
    for i in range(cfg.n_layers):
        h = decoder_layer_decode(_layer(p["layers"], i), cfg, h,
                                 cache["k"][i], cache["v"][i], pos,
                                 window=window)
    h = L.rms_norm(p["final_norm"], h, cfg.norm_eps)
    return _logits(p, cfg, h), cache
