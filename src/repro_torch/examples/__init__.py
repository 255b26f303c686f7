"""The reference's examples on the PyTorch port, one module each::

    python -m repro_torch.examples.quickstart            # on the card
    python -m repro_torch.examples.precision_profiles --device cpu
    python -m repro_torch.examples.serve_quantized

Each module's ``main(device="cuda")`` keeps the reference example's
steps, sizes (the smoke configs), seeds, printed quantities and asserts;
the weights are drawn by torch from the same seeds, so the numbers are
the port's own. ``device="cuda"`` without a card raises.
"""
from __future__ import annotations

import argparse

import torch


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
