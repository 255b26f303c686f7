"""Precision policies: per-layer Pa/Pw configuration + the paper's tables.

PyTorch-port counterpart of ``repro/core/policy.py``. Table 1
(profile-derived per-layer activation precisions and per-network weight
precisions, 100% and 99% relative top-1 accuracy) and Table 3 (average
effective per-group weight precisions) are transcribed verbatim, with the
paper's published speedups and its layout-measured power and area: they
are the inputs and the yardsticks of the cycle model
(``core/cyclemodel.py``) that reproduces Tables 2/4 and Figs 4/5.
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


# ---------------------------------------------------------------------------
# Paper Table 1: per-layer activation precisions (CVLs) + per-network weight
# precision (CVLs), and per-layer weight precisions (FCLs).
# ---------------------------------------------------------------------------

TABLE1_CVL_ACT_100 = {
    "nin":       [8, 8, 8, 9, 7, 8, 8, 9, 9, 8, 8, 8],
    "alexnet":   [9, 8, 5, 5, 7],
    "googlenet": [10, 8, 10, 9, 8, 10, 9, 8, 9, 10, 7],
    "vggs":      [7, 8, 9, 7, 9],
    "vggm":      [7, 7, 7, 8, 7],
    "vgg19":     [12, 12, 12, 11, 12, 10, 11, 11, 13, 12, 13, 13, 13, 13, 13, 13],
}

TABLE1_CVL_W_100 = {
    "nin": 11, "alexnet": 11, "googlenet": 11, "vggs": 12, "vggm": 12, "vgg19": 12,
}

TABLE1_CVL_ACT_99 = {
    "nin":       [8, 8, 7, 9, 7, 8, 8, 9, 9, 8, 7, 8],
    "alexnet":   [9, 7, 4, 5, 7],
    "googlenet": [10, 8, 9, 8, 8, 9, 10, 8, 9, 10, 8],
    "vggs":      [7, 8, 9, 7, 9],
    "vggm":      [6, 8, 7, 7, 7],
    "vgg19":     [9, 9, 9, 8, 12, 10, 10, 12, 13, 11, 12, 13, 13, 13, 13, 13],
}

TABLE1_CVL_W_99 = {
    "nin": 10, "alexnet": 11, "googlenet": 11, "vggs": 11, "vggm": 12, "vgg19": 12,
}

TABLE1_FCL_W_100 = {
    "nin": None,
    "alexnet":   [10, 9, 9],
    "googlenet": [7],
    "vggs":      [10, 9, 9],
    "vggm":      [10, 8, 8],
    "vgg19":     [10, 9, 9],
}

TABLE1_FCL_W_99 = {
    "nin": None,
    "alexnet":   [9, 8, 8],
    "googlenet": [7],
    "vggs":      [9, 9, 8],
    "vggm":      [9, 8, 8],
    "vgg19":     [10, 9, 8],
}

# Table 3: average effective per-layer weight precisions (groups of 16).
TABLE3_EFFECTIVE_W = {
    "nin":       [8.85, 10.29, 10.21, 7.65, 9.13, 9.04, 7.63, 8.65, 8.62, 7.79, 7.96, 8.18],
    "alexnet":   [8.36, 7.62, 7.62, 7.44, 7.55],
    "googlenet": [6.19, 5.75, 6.80, 6.28, 5.34, 6.70, 6.31, 5.02, 5.49, 7.89, 4.83],
    "vggs":      [9.94, 6.96, 8.53, 8.13, 8.10],
    "vggm":      [9.87, 7.55, 8.52, 8.16, 8.14],
    "vgg19":     [10.98, 9.81, 9.31, 9.09, 8.58, 8.04, 7.89, 7.86,
                  7.51, 7.20, 7.36, 7.47, 7.61, 7.66, 7.66, 7.63],
}

# Paper-published results we validate against (geomeans vs DPNN).
PAPER_GEOMEANS = {
    # (profile, layer_kind, design) -> (perf, eff)
    ("100", "fcl", "stripes"): (1.00, 0.88),
    ("100", "fcl", "lm1b"): (1.74, 1.41),
    ("100", "fcl", "lm2b"): (1.75, 1.65),
    ("100", "fcl", "lm4b"): (1.75, 1.84),
    ("100", "cvl", "stripes"): (1.84, 1.61),
    ("100", "cvl", "lm1b"): (3.25, 2.63),
    ("100", "cvl", "lm2b"): (3.10, 2.92),
    ("100", "cvl", "lm4b"): (2.78, 2.92),
    ("99", "fcl", "stripes"): (1.00, 0.88),
    ("99", "fcl", "lm1b"): (1.85, 1.49),
    ("99", "fcl", "lm2b"): (1.85, 1.75),
    ("99", "fcl", "lm4b"): (1.86, 1.95),
    ("99", "cvl", "stripes"): (1.99, 1.74),
    ("99", "cvl", "lm1b"): (3.63, 2.93),
    ("99", "cvl", "lm2b"): (3.45, 3.25),
    ("99", "cvl", "lm4b"): (3.11, 3.26),
    # Table 4 (all layers, Table 3 effective weight precisions)
    ("t3", "all", "lm1b"): (4.38, 3.54),
    ("t3", "all", "lm2b"): (4.20, 3.95),
    ("t3", "all", "lm4b"): (3.76, 3.94),
}

PAPER_PER_NETWORK = {
    # network -> {(profile, layer_kind, design): perf}
    "alexnet": {("100", "cvl", "stripes"): 2.34, ("100", "cvl", "lm1b"): 4.25,
                ("100", "fcl", "lm1b"): 1.65, ("t3", "all", "lm1b"): 5.66},
    "nin":     {("100", "cvl", "stripes"): 1.76, ("100", "cvl", "lm1b"): 2.97,
                ("t3", "all", "lm1b"): 3.38},
    "googlenet": {("100", "cvl", "stripes"): 1.76, ("100", "cvl", "lm1b"): 2.63,
                  ("100", "fcl", "lm1b"): 2.25, ("t3", "all", "lm1b"): 3.19},
    "vggs":    {("100", "cvl", "stripes"): 1.89, ("100", "cvl", "lm1b"): 3.98,
                ("100", "fcl", "lm1b"): 1.63, ("t3", "all", "lm1b"): 5.72},
    "vggm":    {("100", "cvl", "stripes"): 2.12, ("100", "cvl", "lm1b"): 4.12,
                ("100", "fcl", "lm1b"): 1.63, ("t3", "all", "lm1b"): 6.03},
    "vgg19":   {("100", "cvl", "stripes"): 1.34, ("100", "cvl", "lm1b"): 2.17,
                ("100", "fcl", "lm1b"): 1.62, ("t3", "all", "lm1b"): 3.38},
}

# Relative power vs DPNN, derived from the paper's post-layout results
# (efficiency = speedup / relative_power; Table 2 geomeans give the ratios).
# We cannot re-run 65nm synthesis here; these are the paper's layout-measured
# constants and are used only to convert modeled speedups into efficiency.
RELATIVE_POWER = {"stripes": 1.143, "lm1b": 1.236, "lm2b": 1.062, "lm4b": 0.952}

# Post-layout area overhead vs DPNN (paper Sec 4.4).
RELATIVE_AREA = {"lm1b": 1.34, "lm2b": 1.25, "lm4b": 1.16}
