"""Serving and training on a device mesh: logical specs, sharding rules,
and the tensor-, data- and expert-parallel execution of the Loom
linears, with collectives that carry a gradient for training
(``launch.train.jit_train_step``).

PyTorch-port counterpart of ``repro/dist/``. The reference is
single-controller: one process drives every device and GSPMD places the
arrays from the logical specs. The port is SPMD under
``torch.distributed``: one process per rank, each holding its own shard
of every parameter, and explicit collectives where the reference lets
the compiler insert them.

* Ranks on separate cards talk over NCCL; a caller starts them with
  ``torchrun`` or ``torch.multiprocessing.spawn`` and each calls
  :func:`init_process`.
* World size 1 on a card runs on NCCL as well. Ranks that share one card
  (NCCL refuses two ranks on one device) or run on the CPU talk over
  gloo. Compute stays on the rank's device whatever the transport: gloo
  takes every collective the port runs on CUDA tensors and moves them
  through host memory itself.
* The mesh is a ``DeviceMesh`` ("data", "model")
  (:func:`repro_torch.launch.mesh.make_host_mesh`): batch rows and the
  "fsdp" weight dims over "data", heads, FFN columns and experts over
  "model".

Modules: :mod:`~repro_torch.dist.sharding` (specs, rules, resolution,
``shard_tree`` / ``gather_tree``) and :mod:`~repro_torch.dist.parallel`
(the collectives and the sharded linear, exact by construction on the
integer routes).
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist


def transport(device, world_size: int) -> str:
    """The process-group backend for ``world_size`` ranks on ``device``:
    NCCL when every rank has a card of its own, else gloo (the CPU, or
    ranks sharing a card)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if world_size <= torch.cuda.device_count() else "gloo"


def init_process(rank: int, world_size: int, port: int, device="cuda",
                 timeout_s: float | None = None) -> str:
    """Join rank ``rank`` of ``world_size`` to the process group at
    ``tcp://localhost:port`` (every rank of one host passes the same
    port), on ``device``: rank r takes card ``r % device_count``, over
    :func:`transport`'s backend. ``timeout_s`` bounds every collective
    (PyTorch's default when None). Returns the backend."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_process(device='cuda'): no CUDA device "
                               "is available; pass device='cpu'")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    backend = transport(device, world_size)
    kw = {} if timeout_s is None else {
        "timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world_size, **kw)
    return backend
