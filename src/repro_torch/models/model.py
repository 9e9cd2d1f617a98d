"""Public model API of the port: family dispatch for serving
(counterpart of ``repro.models.model``).

The dense and moe decoder families are ported; every other family raises
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import kvcache as KV
from repro_torch.models import transformer as T

# Families whose prompts can be prefilled as padded/ragged chunked batches
# written straight into the slot-pooled cache (see the reference module:
# moe is left out because expert capacity couples the rows of a batch).
CHUNKED_PREFILL_FAMILIES = ("dense",)
# Families the port serves; the others wait for ROADMAP Queue A, item 8.
PORTED_FAMILIES = ("dense", "moe")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: ROADMAP Queue A, "
            f"item 8 (other families: vlm, ssm, hybrid, audio)")


def init_params(cfg: ModelConfig, *, seed: int = 0, dtype=None,
                device: str = "cuda"):
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (dtype defaults to ``cfg.dtype``; a moe
    router stays float32)."""
    _require_ported(cfg)
    dtype = dtype or getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    return T.init_decoder_model(cfg, dtype=dtype, device=device,
                                generator=gen)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device: str = "cuda"):
    _require_ported(cfg)
    return KV.init_attn_cache(cfg, batch, max_len, cfg.n_layers, dtype,
                              device)


def serve_prefill(params, cfg: ModelConfig, batch, cache):
    """Prefill ``cache`` from ``batch["tokens"]`` [B, S] — see
    ``transformer.decoder_prefill``; the engine's batch-1 legacy path."""
    _require_ported(cfg)
    return T.decoder_prefill(params, cfg, batch, cache)


def serve_prefill_chunk(params, cfg: ModelConfig, tokens, cache, slot_idx,
                        pos0, take, kv_width=None):
    """Batched ragged chunk prefill into the slot-pooled serving cache —
    see ``transformer.decoder_prefill_chunk``. Only families in
    ``CHUNKED_PREFILL_FAMILIES`` support this path."""
    if cfg.family not in CHUNKED_PREFILL_FAMILIES:
        raise NotImplementedError(
            f"chunked slot prefill is not supported for family "
            f"{cfg.family!r}")
    return T.decoder_prefill_chunk(params, cfg, tokens, cache, slot_idx,
                                   pos0, take, kv_width=kv_width)


def serve_decode(params, cfg: ModelConfig, token, pos, cache):
    _require_ported(cfg)
    return T.decoder_decode(params, cfg, token, pos, cache)
