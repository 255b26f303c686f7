"""Architecture registry of the PyTorch port.

Each module exposes ``config()`` (the published configuration) and
``smoke_config()`` (a reduced same-family configuration for CPU tests).
Ported: the paper CNN and qwen3-1.7b (dense); the other LM families come
with ROADMAP A.11.
"""
from __future__ import annotations

from repro_torch.configs import paper_cnn, qwen3_1_7b

_ARCHS = {"paper_cnn": paper_cnn, "qwen3_1_7b": qwen3_1_7b}
ARCHS = tuple(_ARCHS)


def get(name: str, smoke: bool = False):
    mod_name = name.replace("-", "_").replace(".", "_")
    try:
        mod = _ARCHS[mod_name]
    except KeyError:
        raise KeyError(f"architecture {name!r} is not ported yet; ported: "
                       f"{sorted(_ARCHS)}") from None
    return mod.smoke_config() if smoke else mod.config()
