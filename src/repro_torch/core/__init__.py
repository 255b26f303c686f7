"""Numerics core of the PyTorch port: Loom's precision-scaled execution.

Public API:
    quantize      fixed-point quantization + 2's-complement bit planes
    bitpack       bit-interleaved packed storage (memory = P/16)
    engine        plane-serial matmul (LM_1b..LM_8b), split-K cascading
    dynamic       runtime per-group precision reduction
    weightgroups  pack-time per-filter-group weight precision
    policy        per-layer precision policies + paper Tables 1/3 data
    profiler      Judd-style per-layer precision search
    cyclemodel    DPNN/Stripes/Loom cycle model (paper Tables 2/4, Figs 4/5)
    integrity     CRC32 fingerprints of serving weights
"""
from repro_torch.core import (bitpack, cyclemodel, dynamic, engine, policy,
                              profiler, quantize, weightgroups)
from repro_torch.core.engine import LoomConfig, loom_matmul, plane_matmul
from repro_torch.core.policy import (LayerPrecision, PrecisionPolicy,
                                     uniform_policy)
from repro_torch.core.quantize import dequantize, fake_quant

__all__ = [
    "bitpack", "cyclemodel", "dynamic", "engine", "policy", "profiler",
    "quantize", "weightgroups", "LoomConfig", "loom_matmul", "plane_matmul",
    "LayerPrecision", "PrecisionPolicy", "uniform_policy",
    "dequantize", "fake_quant",
]
