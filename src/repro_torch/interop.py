"""Parameters carried across from the JAX package, and the tree conventions
the two packages share.

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

Checkpoints and weight fingerprints name a leaf by its path, as
``jax.tree_util.tree_flatten_with_path`` does: dict keys visited in sorted
order, joined with ``/`` (``blocks/p0/mix/wq/w_packed``).
:func:`flatten_with_paths` gives the same keys in the same order for the
port's trees, and :func:`host_array` the bytes the reference hashes and
stores: a leaf on the host as numpy, with bf16 and float8 leaves as raw
integers of the same width (numpy has no such dtypes without
``ml_dtypes``).
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

# Dtypes numpy cannot hold without ml_dtypes -> the same-width integer
# their bits are stored as (the reference's checkpoint convention).
EXT_STORAGE = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8,
               "float8_e5m2": np.uint8}
_EXT_VIEW = {"bfloat16": torch.int16, "float8_e4m3fn": torch.uint8,
             "float8_e5m2": torch.uint8}


def _leaf(a) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree, device="cpu", specs=None, mesh=None):
    """Nested dict of numpy arrays (or tensors) -> nested dict of tensors
    on ``device``, dtypes kept. With a logical ``specs`` tree and a
    ``mesh`` (``repro_torch.dist``), only this rank's shard of each leaf
    crosses (``dist.sharding.shard_tree``)."""
    if specs is not None:
        from repro_torch.dist import sharding
        return sharding.map_specs(
            lambda a, s: params_from_numpy(
                a[sharding.local_slices(a.shape, s, mesh)], device),
            tree, specs)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return _leaf(tree).to(device)


def train_state_from_numpy(tree, device="cpu") -> dict:
    """The reference's train state ``{"params", "opt": {"mu", "nu",
    "step"}}`` (plus ``"err"`` with gradient compression), as numpy arrays
    or tensors, e.g. a reference checkpoint's leaves -> the port's, on
    ``device``: every leaf's dtype kept, ``opt/step`` an int32 0-d
    tensor."""
    if not {"params", "opt"} <= set(tree) or \
            set(tree["opt"]) != {"mu", "nu", "step"}:
        raise ValueError(f"not a train state: keys {sorted(tree)}, opt "
                         f"{sorted(tree.get('opt', {}))}")
    state = params_from_numpy(tree, device)
    state["opt"]["step"] = state["opt"]["step"].to(torch.int32).reshape(())
    return state


# -- tree paths ---------------------------------------------------------------

def _walk(tree, path: tuple):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    else:
        yield "/".join(path), tree


def flatten_with_paths(tree) -> dict:
    """``{"a/b/c": leaf}`` of a nested dict, in ``jax.tree_util``'s order
    (dict keys sorted)."""
    return dict(_walk(tree, ()))


def tree_map(fn, *trees):
    """A new nested dict of the first tree's keys whose leaves are ``fn``
    of the trees' leaves at the same key."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def map_with_paths(fn, tree, path: tuple = ()):
    """A new nested dict of the same keys whose leaves are
    ``fn(key, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn("/".join(path), tree)


# -- leaf bytes on the host -----------------------------------------------------

def dtype_name(dtype) -> str:
    """numpy's name of a torch or numpy dtype (``"bfloat16"``,
    ``"float32"``, ``"uint8"``, ...): the reference's ``str(arr.dtype)``."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a torch dtype, a numpy dtype or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else dtype_name(dtype)
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"no torch dtype for {name!r}")
    return out


def host_tensor(leaf) -> torch.Tensor:
    """A leaf (tensor or array) as a contiguous CPU tensor of its dtype."""
    if not isinstance(leaf, torch.Tensor):
        leaf = _leaf(leaf)
    return leaf.detach().contiguous().cpu()


def host_array(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's bytes as numpy: its own dtype, or the same-width
    integer of :data:`EXT_STORAGE` for bf16 and float8."""
    name = dtype_name(t.dtype)
    if name in EXT_STORAGE:
        return t.view(_EXT_VIEW[name]).numpy().view(EXT_STORAGE[name])
    return t.numpy()


def crc32(arr: np.ndarray) -> int:
    """``zlib.crc32(arr.tobytes())`` without the copy."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def from_host_array(arr: np.ndarray, stored: str) -> torch.Tensor:
    """Inverse of :func:`host_array`: a writable numpy array holding
    ``stored`` values (bf16/float8 as their raw integers) -> a CPU tensor
    sharing its memory. A 0-d leaf (a train state's step counter) stays
    0-d (``np.ascontiguousarray`` alone makes it [1])."""
    arr = np.ascontiguousarray(arr).reshape(arr.shape)
    if stored in EXT_STORAGE:
        raw = arr.view(np.int16 if stored == "bfloat16" else np.uint8)
        return torch.from_numpy(raw).view(torch_dtype(stored))
    return torch.from_numpy(arr)
