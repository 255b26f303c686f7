"""Parameters carried across from the JAX package.

The JAX package's parameter trees are nested dicts of arrays; as numpy
arrays (``np.asarray`` of each leaf) they need no framework to read.
:func:`params_from_numpy` turns such a tree into the port's: the same
nesting and keys, each leaf a tensor of the same dtype on ``device``. Both
layouts pass unchanged: dense (``{"conv1": {"w": f32 [27, 32]}, ...}``)
and packed (``{"conv1": {"w_packed": uint8 [Pw, K/8, N], "w_scale": f32
[1, 1]}, ...}``), whose bytes are the shared packing layout. So does the
LM's stacked tree (``params["blocks"]["p0"]``, each leaf with a leading
``[n_groups]`` axis), and bf16 leaves: numpy holds them as the
``ml_dtypes`` type ``bfloat16``, which torch cannot read, so their bits
cross as uint16 and are viewed as ``torch.bfloat16``.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(a) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree, device="cpu"):
    """Nested dict of numpy arrays (or tensors) -> nested dict of tensors
    on ``device``, dtypes kept."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return _leaf(tree).to(device)
