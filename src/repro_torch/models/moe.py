"""Mixture-of-Experts layer with capacity-based sorted dispatch
(counterpart of ``repro.models.moe``).

Tokens are routed top-k on float32 router logits, sorted by expert id
(stable), gathered into a dense ``[E, capacity, D]`` buffer, run through
the experts as batched products, and scattered back with gate weighting.
Routing follows the reference step for step, so the same tokens are
dropped when an expert overflows its capacity: greedy outputs depend on
which ones. The expert products are plain batched matrix products (the
reference leaves them to XLA, outside any Pallas kernel).

Parameters keep the reference layout: ``router`` ``{"w": [D, E]}`` in
float32 whatever the model dtype, ``w_gate``/``w_up`` ``[E, D, F]``,
``w_down`` ``[E, F, D]``, and an optional ``shared`` swiglu MLP.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


def _capacity(n_tokens: int, cfg) -> int:
    cap = int(math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor
                        / cfg.n_experts))
    return max(8, ((cap + 7) // 8) * 8)


def moe_forward(p, cfg, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,D] -> (y [B,S,D], aux_loss scalar)."""
    if cfg.moe_impl == "ep":
        raise NotImplementedError(
            "expert-parallel MoE (moe_impl='ep') is not ported: ROADMAP "
            "Queue A, item 10 (distributed and dry-run)")
    return _moe_forward_gather(p, cfg, x)


def _route(p, cfg, xt):
    """float32 router softmax and its renormalised top-k:
    (probs [T,E], gate_vals [T,K], expert_idx [T,K])."""
    logits = L.dense(p["router"], xt.float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.top_k, dim=-1,
                                       sorted=True)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    return probs, gate_vals, expert_idx


def _aux_loss(cfg, probs, expert_idx):
    """Switch-style load-balance loss: E * sum(mean prob * routed share)."""
    T, E = probs.shape
    K = expert_idx.shape[1]
    me = probs.mean(dim=0)
    ce = torch.zeros(E, dtype=torch.float32, device=probs.device)
    ce.index_add_(0, expert_idx.reshape(-1),
                  torch.full((T * K,), 1.0 / (T * K), device=probs.device))
    return cfg.router_aux_coef * E * torch.sum(me * ce)


def _moe_forward_gather(p, cfg, x) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, D)
    probs, gate_vals, expert_idx = _route(p, cfg, xt)
    aux = _aux_loss(cfg, probs, expert_idx)

    # ---- sorted capacity dispatch: (token, k) pairs flattened token-major
    C = _capacity(T, cfg)
    dev = x.device
    flat_e = expert_idx.reshape(-1)                             # [T*K]
    flat_g = gate_vals.reshape(-1)
    flat_tok = torch.arange(T, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    # slot of each routed pair within its expert group; past C -> dropped
    seg_start = torch.searchsorted(e_sorted, torch.arange(E, device=dev),
                                   side="left")
    slot = torch.arange(T * K, device=dev) - seg_start[e_sorted]
    keep = slot < C
    dst = torch.where(keep, e_sorted * C + slot,
                      torch.full_like(slot, E * C))             # overflow bin
    tok_sorted = flat_tok[order]
    buf = torch.zeros(E * C + 1, D, dtype=x.dtype, device=dev)
    buf[dst] = xt[tok_sorted]
    buf = buf[:-1].reshape(E, C, D)

    # ---- expert compute: batched products over the E axis
    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    y_e = torch.bmm(h, p["w_down"])                             # [E,C,D]

    # ---- weighted scatter back. With top_k = 2 each token gets at most
    # two contributions, added to zeros: the sum rounds once whatever the
    # order, so it matches the reference bit for bit in bf16; for larger
    # top_k the order of index_add_ would matter.
    y_flat = y_e.reshape(E * C, D)
    gathered = torch.where(keep[:, None],
                           y_flat[torch.clamp(dst, max=E * C - 1)],
                           torch.zeros((), dtype=x.dtype, device=dev))
    contrib = gathered * flat_g[order][:, None].to(x.dtype)
    y = torch.zeros(T, D, dtype=x.dtype, device=dev)
    y.index_add_(0, tok_sorted, contrib)

    if "shared" in p:
        y = y + L.mlp(p["shared"], cfg, xt)
    return y.reshape(B, S, D), aux


def moe_forward_dense(p, cfg, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference oracle: every expert on every token, masked by gates."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    probs, gate_vals, expert_idx = _route(p, cfg, xt)
    dense_gates = torch.zeros_like(probs).scatter_(1, expert_idx, gate_vals)
    h = F.silu(torch.einsum("td,edf->tef", xt, p["w_gate"])) * \
        torch.einsum("td,edf->tef", xt, p["w_up"])
    y_all = torch.einsum("tef,efd->ted", h, p["w_down"])
    y = torch.einsum("ted,te->td", y_all, dense_gates.to(x.dtype))
    if "shared" in p:
        y = y + L.mlp(p["shared"], cfg, xt)
    return y.reshape(B, S, D), _aux_loss(cfg, probs, expert_idx)
