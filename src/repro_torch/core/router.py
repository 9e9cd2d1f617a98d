"""Utility router f_θ: 2-hidden-layer MLP on (z_i, C_used) (paper Eq. 8).

PyTorch counterpart of ``repro/core/router.py``: the same MLP and
parameter layout (``{"l1": {"w": [in, h], "b": [h]}, ...}``, ``w`` as
``[d_in, d_out]``), trained offline with ``torch.optim.AdamW`` + MSE
against profiled utility targets (Eq. 9 / Eq. 26) at the reference's
hyperparameters: betas (0.9, 0.95), eps 1e-8, weight decay on the
matrices only, constant learning rate, gradients clipped to a global
norm of 1.0.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import embeddings as E


@dataclass(frozen=True)
class RouterConfig:
    in_dim: int = E.embedding_dim() + 1   # z_i ++ C_used(t)
    hidden: int = 128
    lr: float = 1e-4                      # paper: AdamW 1e-4
    weight_decay: float = 0.01
    epochs: int = 200
    batch: int = 256
    seed: int = 0


def init_router(cfg: RouterConfig, *, device: str = "cuda"):
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    h = cfg.hidden

    def lin(i, o):
        w = torch.randn(i, o, generator=gen, device=device) / np.sqrt(i)
        return {"w": w, "b": torch.zeros(o, device=device)}

    return {"l1": lin(cfg.in_dim, h), "l2": lin(h, h), "l3": lin(h, 1)}


def router_apply(params, x):
    """x [n, in_dim] -> û ∈ (0,1) [n]  (Eq. 8: sigmoid(f_θ))."""
    h = torch.relu(x @ params["l1"]["w"] + params["l1"]["b"])
    h = torch.relu(h @ params["l2"]["w"] + params["l2"]["b"])
    out = h @ params["l3"]["w"] + params["l3"]["b"]
    return torch.sigmoid(out[..., 0])


def make_features(z: np.ndarray, c_used: np.ndarray) -> np.ndarray:
    """Concatenate embeddings with the budget-state feature."""
    return np.concatenate([z, np.asarray(c_used, np.float32)[:, None]], axis=1)


def train_router(cfg: RouterConfig, feats: np.ndarray, targets: np.ndarray,
                 *, log_every: int = 0, device: str = "cuda"
                 ) -> Tuple[Dict, list]:
    """Offline warm-start (Eq. 9): MSE regression to profiled utilities."""
    params = init_router(cfg, device=device)
    weights = [params[n]["w"].requires_grad_() for n in ("l1", "l2", "l3")]
    biases = [params[n]["b"].requires_grad_() for n in ("l1", "l2", "l3")]
    opt = torch.optim.AdamW(
        [{"params": weights, "weight_decay": cfg.weight_decay},
         {"params": biases, "weight_decay": 0.0}],
        lr=cfg.lr, betas=(0.9, 0.95), eps=1e-8)
    x = torch.as_tensor(feats, dtype=torch.float32, device=device)
    y = torch.as_tensor(targets, dtype=torch.float32, device=device)
    n = x.shape[0]
    rng = np.random.default_rng(cfg.seed)
    history = []
    for ep in range(cfg.epochs):
        perm = rng.permutation(n)
        tot = 0.0
        for i in range(0, n, cfg.batch):
            idx = torch.as_tensor(perm[i:i + cfg.batch], device=device)
            loss = torch.mean((router_apply(params, x[idx]) - y[idx]) ** 2)
            opt.zero_grad()
            loss.backward()
            torch.nn.utils.clip_grad_norm_(weights + biases, 1.0)
            opt.step()
            tot += loss.item() * len(idx)
        history.append(tot / n)
        if log_every and ep % log_every == 0:
            print(f"router epoch {ep}: mse {history[-1]:.5f}")
    params = {k: {n: t.detach() for n, t in v.items()}
              for k, v in params.items()}
    return params, history


class Router:
    """Inference-side wrapper: embeds subtask descriptions and predicts û."""

    def __init__(self, params, cfg: Optional[RouterConfig] = None, *,
                 device: str = "cuda"):
        self.device = device
        self.params = {k: {n: t.to(device) for n, t in v.items()}
                       for k, v in params.items()}
        self.cfg = cfg or RouterConfig()

    @torch.no_grad()
    def predict(self, descs: Sequence[str], c_used: float) -> np.ndarray:
        if not descs:
            return np.zeros(0, np.float32)
        z = E.embed_texts(list(descs))
        x = make_features(z, np.full(len(descs), c_used, np.float32))
        xt = torch.as_tensor(x, device=self.device)
        return router_apply(self.params, xt).cpu().numpy()

    def predict_one(self, desc: str, c_used: float) -> float:
        return float(self.predict([desc], c_used)[0])
