"""Cycle model of DPNN / Stripes / Loom — the paper's evaluation vehicle.

PyTorch-port counterpart of ``repro/core/cyclemodel.py``: plain Python
float arithmetic in the reference's operation order, so every number
equals the reference's. The numbers are MODELED cycles of the paper's
65 nm accelerators, not measurements of any device this package runs on.

The paper's results (Tables 2/4, Figs 4/5) come from a custom cycle-accurate
simulator over six ImageNet CNNs, driven by the Table 1/3 precision
profiles. This module reimplements that model:

  * DPNN (DaDianNao-like): N=16 activations x k=8 filters = 128 MACs/cycle.
    cycles = ceil-utilized MACs / 128.
  * Stripes: activations bit-serial, weights bit-parallel, CVLs only.
    CVL cycles scale with Pa/16; FCLs run at DPNN rate.
  * Loom LM_{1,2,4}b: both-serial for CVLs (cycles ~ ceil(Pa/b)*b*Pw/256 of
    DPNN), weight-serial for FCLs (cycles ~ Pw/16), with: SIP-array
    utilization (128 filters x 16 windows for CVLs; 2048 outputs for FCLs,
    SIP cascading halving utilization loss for 1K-output FCLs), the
    16-cycle FCL column initiation interval, and dynamic activation
    precision trimming (Lascorz et al.) for CVL activations.

Dynamic trimming: the paper runs real ImageNet activations through OR-tree
leading-one detection per group of 256. We model the per-layer dynamic
effective activation precision as ``dyn_ratio * Pa_static`` with
dyn_ratio = 0.80 (the average trim measured by Lascorz et al. and
consistent with this paper's LM-vs-Stripes gap); the profiler
(repro_torch.core.profiler) can also measure it live on the paper_cnn example.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core import policy as P
from repro_torch.core.weightgroups import mean_group_bits

N_LANES = 16           # activations per cycle (DPNN N)
K_FILTERS = 8          # filters (DPNN k) -> 128 MACs/cycle
BASE_BITS = 16
SIP_ROWS = 128         # LM: filters processed concurrently
SIP_COLS = 16          # LM: windows (CVL) / staggered weight columns (FCL)
DYN_RATIO = 0.80       # mean dynamic activation precision trim (see docstring)


@dataclasses.dataclass(frozen=True)
class Layer:
    name: str
    kind: str            # "cvl" | "fcl"
    macs: float          # multiply-accumulates
    n_outputs: int       # output channels (filters) for cvl, outputs for fcl
    n_windows: int = 1   # output spatial positions (cvl)


@dataclasses.dataclass(frozen=True)
class Network:
    name: str
    layers: tuple


def _alexnet() -> Network:
    return Network("alexnet", (
        Layer("conv1", "cvl", 96 * 363 * 55 * 55, 96, 55 * 55),
        Layer("conv2", "cvl", 256 * 1200 * 27 * 27, 256, 27 * 27),
        Layer("conv3", "cvl", 384 * 2304 * 13 * 13, 384, 13 * 13),
        Layer("conv4", "cvl", 384 * 1728 * 13 * 13, 384, 13 * 13),
        Layer("conv5", "cvl", 256 * 1728 * 13 * 13, 256, 13 * 13),
        Layer("fc6", "fcl", 4096 * 9216, 4096),
        Layer("fc7", "fcl", 4096 * 4096, 4096),
        Layer("fc8", "fcl", 1000 * 4096, 1000),
    ))


def _vgg19() -> Network:
    convs = []
    dims = [  # (out_ch, in_ch, spatial)
        (64, 3, 224), (64, 64, 224),
        (128, 64, 112), (128, 128, 112),
        (256, 128, 56), (256, 256, 56), (256, 256, 56), (256, 256, 56),
        (512, 256, 28), (512, 512, 28), (512, 512, 28), (512, 512, 28),
        (512, 512, 14), (512, 512, 14), (512, 512, 14), (512, 512, 14),
    ]
    for i, (oc, ic, sp) in enumerate(dims):
        convs.append(Layer(f"conv{i}", "cvl", oc * ic * 9 * sp * sp, oc, sp * sp))
    fcs = (Layer("fc6", "fcl", 4096 * 25088, 4096),
           Layer("fc7", "fcl", 4096 * 4096, 4096),
           Layer("fc8", "fcl", 1000 * 4096, 1000))
    return Network("vgg19", tuple(convs) + fcs)


def _vggs() -> Network:
    return Network("vggs", (
        Layer("conv1", "cvl", 96 * 147 * 109 * 109, 96, 109 * 109),
        Layer("conv2", "cvl", 256 * 2400 * 32 * 32, 256, 32 * 32),
        Layer("conv3", "cvl", 512 * 2304 * 16 * 16, 512, 16 * 16),
        Layer("conv4", "cvl", 512 * 4608 * 16 * 16, 512, 16 * 16),
        Layer("conv5", "cvl", 512 * 4608 * 16 * 16, 512, 16 * 16),
        Layer("fc6", "fcl", 4096 * 12800, 4096),
        Layer("fc7", "fcl", 4096 * 4096, 4096),
        Layer("fc8", "fcl", 1000 * 4096, 1000),
    ))


def _vggm() -> Network:
    return Network("vggm", (
        Layer("conv1", "cvl", 96 * 147 * 109 * 109, 96, 109 * 109),
        Layer("conv2", "cvl", 256 * 2400 * 26 * 26, 256, 26 * 26),
        Layer("conv3", "cvl", 512 * 2304 * 13 * 13, 512, 13 * 13),
        Layer("conv4", "cvl", 512 * 4608 * 13 * 13, 512, 13 * 13),
        Layer("conv5", "cvl", 512 * 4608 * 13 * 13, 512, 13 * 13),
        Layer("fc6", "fcl", 4096 * 18432, 4096),
        Layer("fc7", "fcl", 4096 * 4096, 4096),
        Layer("fc8", "fcl", 1000 * 4096, 1000),
    ))


def _nin() -> Network:
    dims = [  # (out_ch, macs_per_out, spatial)
        (96, 363, 54), (96, 96, 54), (96, 96, 54),
        (256, 2400, 27), (256, 256, 27), (256, 256, 27),
        (384, 2304, 13), (384, 384, 13), (384, 384, 13),
        (1024, 3456, 6), (1024, 1024, 6), (1000, 1024, 6),
    ]
    layers = [Layer(f"conv{i}", "cvl", oc * mpo * sp * sp, oc, sp * sp)
              for i, (oc, mpo, sp) in enumerate(dims)]
    return Network("nin", tuple(layers))


def _googlenet() -> Network:
    # 11 layer groups matching the paper's 11 precision entries: conv1,
    # conv2(+reduce), inception 3a,3b,4a,4b,4c,4d,4e,5a,5b. MACs from the
    # standard GoogLeNet v1 module dimensions.
    groups = [  # (name, macs, representative out_ch, windows)
        ("conv1", 64 * 147 * 112 * 112, 64, 112 * 112),
        ("conv2", (64 * 64 + 192 * 576) * 56 * 56, 192, 56 * 56),
        ("inc3a", 128.0e6, 256, 28 * 28), ("inc3b", 283.0e6, 480, 28 * 28),
        ("inc4a", 155.0e6, 512, 14 * 14), ("inc4b", 137.0e6, 512, 14 * 14),
        ("inc4c", 163.0e6, 512, 14 * 14), ("inc4d", 187.0e6, 528, 14 * 14),
        ("inc4e", 237.0e6, 832, 14 * 14), ("inc5a", 76.0e6, 832, 7 * 7),
        ("inc5b", 104.0e6, 1024, 7 * 7),
    ]
    layers = [Layer(n, "cvl", m, oc, w) for (n, m, oc, w) in groups]
    layers.append(Layer("fc", "fcl", 1000 * 1024, 1000))
    return Network("googlenet", tuple(layers))


NETWORKS = {n.name: n for n in
            (_alexnet(), _vgg19(), _vggs(), _vggm(), _nin(), _googlenet())}


# ---------------------------------------------------------------------------
# Cycle counts
# ---------------------------------------------------------------------------

def dpnn_cycles(layer: Layer) -> float:
    """DaDianNao-like: 128 MACs/cycle with filter-lane ceil utilization."""
    if layer.kind == "cvl":
        filt_steps = math.ceil(layer.n_outputs / K_FILTERS)
        macs_per_filter = layer.macs / layer.n_outputs
        return filt_steps * macs_per_filter / N_LANES
    return math.ceil(layer.n_outputs / K_FILTERS) * (layer.macs / layer.n_outputs) / N_LANES


def stripes_cycles(layer: Layer, pa: int) -> float:
    """Stripes: CVL activations bit-serial (16 windows in parallel recover
    throughput); FCLs at DPNN rate (no weight-precision exploitation)."""
    if layer.kind == "fcl":
        return dpnn_cycles(layer)
    return dpnn_cycles(layer) * pa / BASE_BITS


def lm_cycles(layer: Layer, pa: float, pw: float, a_plane_bits: int = 1,
              dynamic_a: bool = True, pw_groups: Sequence[float] | None = None
              ) -> float:
    """Loom cycles for one layer.

    ``pw_groups``: per-filter-group effective weight precisions (the
    paper's Sec 4.6 groups of 16 filters; Table 3 reports their layer
    means). When given they override ``pw`` with the group mean — the
    serial weight-plane pass count of a SIP row/column is its own
    group's count, groups are time-multiplexed over the array, so
    expected cycles scale with E[count] over the groups (this is
    exactly how the t3 profile of :func:`network_speedup` models
    Table 4, now available at per-group resolution from
    ``profiler.measure_weight_group_precision`` / pack-time counts).

    CVL: both operands serial. An LM_b design has 128 rows x 16/b columns
    of SIPs (paper Sec 3.2: LM_2b/4b need 8/4 SIP columns), each consuming
    16 activations x b bits against 1 weight bit per cycle. One output in
    one window therefore costs (macs/16) * ceil(Pa/b) * Pw cycles; columns
    parallelize windows, rows parallelize filters. Dynamic activation
    trimming (per group of 256) multiplies Pa by DYN_RATIO; its interaction
    with the b-bit grid is the expectation E[b*ceil(pa_g/b)] ~ pa_eff +
    (b-1)/2 over the group distribution.

    FCL: weights serial, activations consumed bit-serially over 16 cycles
    per weight bit (that is what makes the staggered column loading work).
    One output on one SIP costs macs_per_out * Pw cycles; 2048 outputs run
    concurrently. Layers with fewer outputs use SIP cascading: the
    reduction is sliced across floor(2048/outputs) chained SIPs (split-K),
    plus Sn cycles to reduce the partials, plus the column-stagger fill.
    """
    # `is not None` + len, not truthiness: counts arrive as tensors or
    # numpy arrays from weight_group_counts / measure_weight_group_precision,
    # whose bool() raises for more than one element.
    if pw_groups is not None and len(pw_groups):
        pw = mean_group_bits(pw_groups)
    if layer.kind == "cvl":
        if dynamic_a:
            exec_bits = pa * DYN_RATIO + (a_plane_bits - 1) / 2.0
        else:
            exec_bits = a_plane_bits * math.ceil(pa / a_plane_bits)
        exec_bits = max(float(a_plane_bits), min(exec_bits, float(BASE_BITS)))
        a_passes = exec_bits / a_plane_bits
        n_cols = max(1, SIP_COLS // a_plane_bits)
        filt_steps = math.ceil(layer.n_outputs / SIP_ROWS)
        win_steps = math.ceil(layer.n_windows / n_cols)
        macs_per_out = layer.macs / (layer.n_outputs * layer.n_windows)
        return filt_steps * win_steps * (macs_per_out / N_LANES) * a_passes * pw
    # FCL. An LM_b SIP consumes b activation bits per cycle, so one output
    # costs macs_per_out * Pw / b cycles on one SIP; the 16/b columns give
    # 2048/b concurrent outputs — total FCL throughput is b-independent
    # (paper: LM_1b/2b/4b FCL perf identical in steady state), but the
    # column-stagger fill (initiation interval) shrinks with b.
    b = a_plane_bits
    total_outputs = layer.n_outputs
    n_cols = max(1, SIP_COLS // b)
    sip_outputs = SIP_ROWS * n_cols
    macs_per_out = layer.macs / total_outputs
    per_out = macs_per_out * pw / b
    if total_outputs >= sip_outputs:
        cycles = math.ceil(total_outputs / sip_outputs) * per_out
    else:
        sn = min(n_cols, max(1, sip_outputs // total_outputs))  # cascade depth
        cycles = per_out / sn + sn
    cycles += n_cols  # column-stagger fill (initiation interval)
    return cycles


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    name: str                 # "stripes" | "lm1b" | "lm2b" | "lm4b"
    a_plane_bits: int = 1
    dynamic_a: bool = True


DESIGNS = {
    "stripes": DesignPoint("stripes"),
    "lm1b": DesignPoint("lm1b", a_plane_bits=1),
    "lm2b": DesignPoint("lm2b", a_plane_bits=2),
    "lm4b": DesignPoint("lm4b", a_plane_bits=4),
}


def network_speedup(net_name: str, design: str, profile: str = "100",
                    layer_kind: str = "all") -> float:
    """Speedup of ``design`` over DPNN for one network.

    profile: "100" | "99" (Table 1) | "t3" (Table 3 effective weight
    precisions, CVL Pa from Table 1-100%, FCL weights trimmed by the same
    per-group machinery — modeled with the network's Table 3 mean ratio).
    """
    net = NETWORKS[net_name]
    if profile == "99":
        acts = P.TABLE1_CVL_ACT_99[net_name]
        w_cvl = float(P.TABLE1_CVL_W_99[net_name])
        w_fcl = P.TABLE1_FCL_W_99[net_name]
    else:
        acts = P.TABLE1_CVL_ACT_100[net_name]
        w_cvl = float(P.TABLE1_CVL_W_100[net_name])
        w_fcl = P.TABLE1_FCL_W_100[net_name]

    cvl_w_per_layer = [w_cvl] * len(acts)
    if profile == "t3":
        cvl_w_per_layer = list(P.TABLE3_EFFECTIVE_W[net_name])
        # FCL per-group trimming: apply the network's mean CVL trim ratio to
        # the FCL static weight precisions (the paper gives no FCL Table 3).
        ratio = (sum(cvl_w_per_layer) / len(cvl_w_per_layer)) / w_cvl
        if w_fcl is not None:
            w_fcl = [max(1.0, p * ratio) for p in w_fcl]

    d = DESIGNS[design]
    base = 0.0
    ours = 0.0
    cvl_i = 0
    fcl_i = 0
    for layer in net.layers:
        if layer.kind == "cvl":
            pa = acts[min(cvl_i, len(acts) - 1)]
            pw = cvl_w_per_layer[min(cvl_i, len(cvl_w_per_layer) - 1)]
            cvl_i += 1
            if layer_kind == "fcl":
                continue
            base += dpnn_cycles(layer)
            if design == "stripes":
                ours += stripes_cycles(layer, pa)
            else:
                ours += lm_cycles(layer, pa, pw, d.a_plane_bits, d.dynamic_a)
        else:
            if w_fcl is None:
                continue
            pw = float(w_fcl[min(fcl_i, len(w_fcl) - 1)])
            fcl_i += 1
            if layer_kind == "cvl":
                continue
            base += dpnn_cycles(layer)
            if design == "stripes":
                ours += stripes_cycles(layer, 16)
            else:
                ours += lm_cycles(layer, 16, pw, d.a_plane_bits, d.dynamic_a)
    if ours == 0.0:
        return float("nan")
    return base / ours


def geomean_speedup(design: str, profile: str = "100", layer_kind: str = "all") -> float:
    vals = []
    for name in NETWORKS:
        s = network_speedup(name, design, profile, layer_kind)
        if s == s:  # not NaN
            vals.append(s)
    return math.exp(sum(math.log(v) for v in vals) / len(vals))


def efficiency(design: str, speedup: float) -> float:
    """Energy efficiency vs DPNN = speedup / relative power (paper layouts)."""
    return speedup / P.RELATIVE_POWER[design]


def scaling_curve(design: str = "lm1b", profile: str = "100") -> dict:
    """Fig 5 analogue: relative performance as the equivalent peak compute
    bandwidth scales (32..512 MACs/cycle). LM parallelism grows as
    rows x cols; under-utilization grows for small layers. Patches this
    module's array dimensions for each point and restores them after."""
    global N_LANES, K_FILTERS, SIP_ROWS, SIP_COLS
    out = {}
    saved = (N_LANES, K_FILTERS, SIP_ROWS, SIP_COLS)
    for equiv_macs in (32, 64, 128, 256, 512):
        scale = equiv_macs / 128
        try:
            K_FILTERS = max(1, int(8 * scale))
            SIP_ROWS = max(16, int(128 * scale))
            vals = []
            for name in NETWORKS:
                s = network_speedup(name, design, profile, "all")
                if s == s:
                    vals.append(s)
            out[equiv_macs] = math.exp(sum(math.log(v) for v in vals) / len(vals))
        finally:
            (N_LANES, K_FILTERS, SIP_ROWS, SIP_COLS) = saved
    return out
