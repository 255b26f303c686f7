"""Device meshes of the port. Functions, not module constants: importing
this module touches no process group.

PyTorch-port counterpart of ``repro/launch/mesh.py``. A mesh is a
``torch.distributed`` ``DeviceMesh`` over the ranks of an initialized
process group (:func:`repro_torch.dist.init_process`), one rank per
process.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call repro_torch.dist."
                           "init_process(rank, world_size, port) in every "
                           "rank first")
    return dist.get_world_size()


def make_host_mesh(n_devices: int | None = None, model: int = 1,
                   device="cuda"):
    """A ("data", "model") mesh of ``n_devices`` ranks (default: the whole
    world), ``model`` of them along "model". On the card unless the caller
    passes ``device="cpu``."""
    n = n_devices or _world()
    if n % model:
        raise ValueError(f"{n} ranks do not split into model={model}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh(device='cuda'): no CUDA device is "
                           "available; pass device='cpu'")
    return init_device_mesh(device.type, (n // model, model),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: 16 x 16 = 256 cards ("data", "model"). Multi-pod: 2 pods
    of 256 = 512 cards ("pod", "data", "model"), the pod axis pure data
    parallelism. Raises unless the world has exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    world = _world()
    if world != n:
        raise RuntimeError(f"the production mesh {shape} needs {n} ranks; "
                           f"the world has {world}")
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)
