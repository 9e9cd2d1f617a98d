"""Subtask embedding model.

Stand-in for qwen3-embedding-0.6b (unavailable offline): a deterministic
hashed n-gram featurizer followed by a small JAX projection encoder.
The contract matches the paper's: z_i = embedding(t_i) ∈ R^dim, consumed
by the router MLP. Swap in any real encoder via the same ``embed_texts``
signature.
"""
from __future__ import annotations

import hashlib
import math
import re
from functools import lru_cache
from typing import List, Sequence

import numpy as np

DIM = 64
_N_HASH = 4096


def _hash(tokenish: str) -> int:
    return int.from_bytes(hashlib.md5(tokenish.encode()).digest()[:4], "little")


def _tokens(text: str) -> List[str]:
    return re.findall(r"[a-zA-Z][a-zA-Z\-]+|\d+", text.lower())


@lru_cache(maxsize=1)
def _projection(dim: int = DIM, seed: int = 13) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1.0 / math.sqrt(dim), size=(_N_HASH, dim)).astype(np.float32)


def featurize(text: str) -> np.ndarray:
    """Sparse hashed unigram+bigram counts -> [_N_HASH] (l2-normalized)."""
    toks = _tokens(text)
    feats = toks + [f"{a}_{b}" for a, b in zip(toks, toks[1:])]
    v = np.zeros(_N_HASH, np.float32)
    for f in feats:
        h = _hash(f)
        v[h % _N_HASH] += 1.0 if (h >> 16) % 2 else -1.0  # signed hashing
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def embed_texts(texts: Sequence[str], dim: int = DIM) -> np.ndarray:
    """[n, dim] float32 embeddings."""
    P = _projection(dim)
    out = np.stack([featurize(t) @ P for t in texts]) if texts else \
        np.zeros((0, dim), np.float32)
    # append cheap scalar stats (length features carry token-count signal)
    extra = np.array([[len(t) / 200.0, len(_tokens(t)) / 40.0] for t in texts],
                     np.float32) if texts else np.zeros((0, 2), np.float32)
    out = np.concatenate([out, extra], axis=1)
    return out.astype(np.float32)


def embedding_dim(dim: int = DIM) -> int:
    return dim + 2
