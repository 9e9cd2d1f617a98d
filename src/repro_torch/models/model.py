"""Public model API of the port: family dispatch for serving
(counterpart of ``repro.models.model``).

Only the dense decoder family is ported; every other family raises
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import kvcache as KV
from repro_torch.models import transformer as T

# Families whose prompts can be prefilled as padded/ragged chunked batches
# written straight into the slot-pooled cache (see the reference module).
CHUNKED_PREFILL_FAMILIES = ("dense",)


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family not in CHUNKED_PREFILL_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: ROADMAP Queue A, "
            f"other families (moe, vlm, ssm, hybrid, audio)")


def init_params(cfg: ModelConfig, *, seed: int = 0, dtype=None,
                device: str = "cuda"):
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (dtype defaults to ``cfg.dtype``)."""
    _require_dense(cfg)
    dtype = dtype or getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    return T.init_decoder_model(cfg, dtype=dtype, device=device,
                                generator=gen)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device: str = "cuda"):
    _require_dense(cfg)
    return KV.init_attn_cache(cfg, batch, max_len, cfg.n_layers, dtype,
                              device)


def serve_prefill_chunk(params, cfg: ModelConfig, tokens, cache, slot_idx,
                        pos0, take, kv_width=None):
    """Batched ragged chunk prefill into the slot-pooled serving cache —
    see ``transformer.decoder_prefill_chunk``."""
    _require_dense(cfg)
    return T.decoder_prefill_chunk(params, cfg, tokens, cache, slot_idx,
                                   pos0, take, kv_width=kv_width)


def serve_decode(params, cfg: ModelConfig, token, pos, cache):
    _require_dense(cfg)
    return T.decoder_decode(params, cfg, token, pos, cache)
