"""Precision policies: per-layer Pa/Pw configuration.

PyTorch-port counterpart of ``repro/core/policy.py`` (the dataclasses
only; the paper's Table 1/3 constants come with the cycle-model slice).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LayerPrecision:
    a_bits: int = 16
    w_bits: int = 16


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Per-layer precision assignment for a model.

    ``default`` applies to layers not explicitly listed. ``per_layer`` maps a
    layer name to its precision. ``dynamic_a`` enables the runtime per-group
    activation trimming; ``group_size`` is the paper's 256. ``w_group`` is
    the static per-filter-group weight-plane trimming granularity (the
    paper's Sec 4.6 groups of 16 filters; 0 disables recording pack-time
    counts onto the plan).
    """

    default: LayerPrecision = LayerPrecision()
    per_layer: dict = dataclasses.field(default_factory=dict)
    dynamic_a: bool = False
    group_size: int = 256
    w_group: int = 16
    a_plane_bits: int = 8
    w_plane_bits: int = 8

    def lookup(self, name: str) -> LayerPrecision:
        return self.per_layer.get(name, self.default)


def uniform_policy(a_bits: int, w_bits: int, *, plane_bits: int = 8,
                   dynamic_a: bool = False,
                   w_group: int = 16) -> PrecisionPolicy:
    return PrecisionPolicy(default=LayerPrecision(a_bits, w_bits),
                           dynamic_a=dynamic_a, w_group=w_group,
                           a_plane_bits=plane_bits, w_plane_bits=plane_bits)
