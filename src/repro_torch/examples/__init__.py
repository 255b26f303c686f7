"""The reference's examples on the PyTorch port, one module each::

    python -m repro_torch.examples.quickstart            # on the card
    python -m repro_torch.examples.precision_profiles --device cpu
    python -m repro_torch.examples.serve_quantized
    python -m repro_torch.examples.train_lm --small --steps 60 --device cpu
    python -m repro_torch.examples.fault_tolerance --device cpu
    torchrun --nproc-per-node 2 -m repro_torch.examples.fault_tolerance \
        --device cpu                                    # a mesh of 2 ranks

The two training examples train on a ("data", "model") mesh of the world
that ``torch.distributed``'s environment names (``RANK``, ``WORLD_SIZE``,
``MASTER_PORT``, as ``torchrun`` sets them), or of one rank.

Each module's ``main(device="cuda")`` keeps the reference example's
steps, sizes (the smoke configs), seeds, printed quantities and asserts;
the weights are drawn by torch from the same seeds, so the numbers are
the port's own. ``device="cuda"`` without a card raises.
"""
from __future__ import annotations

import argparse
import os
import socket

import torch
import torch.distributed as dist


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda': no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return device


def run(main, doc: str) -> None:
    """Command line of an example: ``--device`` (default ``cuda``)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)


def join_world(device) -> tuple[int, int, bool]:
    """(rank, world size, whether this call started the process group):
    the group of ``torch.distributed``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_PORT`` on this host), joined on
    ``device``'s transport, or a group of one on a free local port; an
    initialized group as it is."""
    from repro_torch.dist import init_process
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), False
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world > 1:
        port = int(os.environ["MASTER_PORT"])
    else:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
    init_process(rank, world, port, device)
    return rank, world, True
