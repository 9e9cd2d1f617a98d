"""Convert the reference's parameter pytrees into the port's parameters.

The JAX package keeps model parameters as nested dicts of arrays, layer
leaves stacked on a leading ``L`` axis and dense weights as
``[d_in, d_out]`` (``layers.dense`` computes ``x @ w``); the router MLP
uses the same ``{"w", "b"}`` layout. The port keeps both layouts, so
conversion maps every leaf (a numpy array, e.g. from
``jax.tree.map(np.asarray, params)``) to a tensor of the same shape.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def to_tensor(a, *, dtype: Optional[torch.dtype] = None,
              device: str = "cuda") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes: not a numpy kind
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))     # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)


# subtrees the reference keeps in float32 whatever the model dtype (the
# moe router: ``repro.models.moe.init_moe``)
FLOAT32_KEYS = ("router",)


def convert_params(tree, *, dtype: Optional[torch.dtype] = None,
                   device: str = "cuda"):
    """Nested dict of arrays -> the same nested dict of tensors on
    ``device``, cast to ``dtype`` when given, except the subtrees named in
    :data:`FLOAT32_KEYS`, which stay float32. Serves model and router
    parameters alike."""
    if isinstance(tree, dict):
        return {k: convert_params(
                    v, dtype=torch.float32 if k in FLOAT32_KEYS and dtype
                    else dtype, device=device)
                for k, v in tree.items()}
    return to_tensor(tree, dtype=dtype, device=device)
