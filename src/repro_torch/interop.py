"""Parameters carried across from the JAX package.

The JAX package's parameter trees are nested dicts of arrays; as numpy
arrays (``np.asarray`` of each leaf) they need no framework to read.
:func:`params_from_numpy` turns such a tree into the port's: the same
nesting and keys, each leaf a tensor of the same dtype on ``device``. Both
layouts pass unchanged: dense (``{"conv1": {"w": f32 [27, 32]}, ...}``)
and packed (``{"conv1": {"w_packed": uint8 [Pw, K/8, N], "w_scale": f32
[1, 1]}, ...}``), whose bytes are the shared packing layout.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cpu"):
    """Nested dict of numpy arrays (or tensors) -> nested dict of tensors
    on ``device``, dtypes kept."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)
