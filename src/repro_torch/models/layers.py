"""The Loom linear and conv layers, dispatched through execution plans.

PyTorch-port counterpart of ``repro/models/layers.py``: RMSNorm, RoPE,
activations, embeddings, and the dense, fake-quant, int8 and packed
routes of the Loom linear and conv. Every linear and conv asks the
model's :class:`~repro_torch.api.plan.ExecutionPlan` for its resolved
:class:`~repro_torch.api.plan.LayerPlan` and jumps to that route's
handler. The ``fake_quant`` route (training, QAT) fake-quantizes the
activations at Pa and the weights, in float32, at Pw, each under one
per-tensor scale, then takes the float product; its gradient passes
straight through both. Activations stay NHWC, as in the reference;
weights keep the 2-D [k*k*Cin, Cout] matrix layout with rows in (di, dj,
c) order, so packing is shared between convs and FC layers.

The serving routes need :func:`convert_linear_for_serving` run once over
the dense params (the paper's offline weight packing step): ``serve_int8``
stores ``{"wq": int8 [K, N], "w_scale"}`` and takes one exact int8
product (``torch._int_mm``, the reference's ``dot_general``; the LM_8b
baseline), ``serve_packed`` stores the bit-packed planes.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.api import plan as planlib
from repro_torch.core import bitpack, quantize as q
from repro_torch.dist.sharding import Spec
from repro_torch.kernels import ops


# PyTorch's CUDA reduction lays its threads out by the number of rows it
# reduces until there are 16 (from 16 on, one warp sums each row in a
# fixed order), so a row of a batch of fewer rows is summed in another
# order than the same row alone. Row-wise means take at least this many.
_MIN_REDUCE_ROWS = 16


def rowwise(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` (a reduction over the last dim) of the rows of x [rows, n],
    run over at least ``_MIN_REDUCE_ROWS`` rows (zero rows pad a smaller
    x and are dropped from the result)."""
    rows = x.shape[0]
    if rows < _MIN_REDUCE_ROWS:
        x = F.pad(x, (0, 0, 0, _MIN_REDUCE_ROWS - rows))
    return fn(x)[:rows]


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32 with a zero-centred gain (``1 + gamma``), cast
    back to x's dtype. The mean of squares is taken over at least
    ``_MIN_REDUCE_ROWS`` rows (zero rows pad a smaller batch), so a decode
    row's result does not depend on the batch it rides in: shown on an
    H100 at batch 4 against 1 (PERF.md, ROADMAP queue C)."""
    dt = x.dtype
    x = x.to(torch.float32)
    ms = rowwise(lambda t: torch.mean(t, dim=-1, keepdim=True),
                 (x * x).reshape(-1, x.shape[-1]))
    x = x * torch.rsqrt(ms.reshape(*x.shape[:-1], 1) + eps)
    return (x * (1.0 + gamma.to(torch.float32))).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding (rotate-half). x: [..., S, H, D]; positions:
    [..., S]."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs   # [..., S, half]
    cos = torch.cos(angles)[..., None, :]                     # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _silu(x: torch.Tensor) -> torch.Tensor:
    # x * (1 / (1 + exp(-x))), each op rounded in x's dtype, as the
    # reference's silu runs in bf16 (F.silu would round once).
    return x * (1.0 / (1.0 + torch.exp(-x)))


@functools.cache
def _as_dtype(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, as the reference's weakly typed
    constants are, so a product with it rounds once, on any device.
    Rounded by a host tensor outside every dispatch mode (a fake-tensor
    trace, the op analyzer), once per constant."""
    with _disable_current_modes():
        return torch.tensor(v, dtype=dtype).item()


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # The reference's ``jax.nn.gelu`` with its default ``approximate=True``
    # (the tanh form, not the erf form), constants and each op in x's
    # dtype.
    k0 = _as_dtype(math.sqrt(2 / math.pi), x.dtype)
    k1 = _as_dtype(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(k0 * (x + k1 * (x * x * x)))))


def _relu2(x: torch.Tensor) -> torch.Tensor:
    # Squared ReLU (nemotron).
    return torch.square(torch.relu(x))


_ACTIVATIONS = {"silu": _silu, "gelu": _gelu, "relu2": _relu2}


def activation_fn(name: str):
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(name) from None


def linear_init(d_in: int, d_out: int, generator: torch.Generator,
                dtype=torch.float32) -> dict:
    """{"w": [d_in, d_out]} drawn from N(0, 1/d_in) in float32 with
    ``generator``, on its device, then cast to ``dtype``."""
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return {"w": w.mul_(d_in ** -0.5).to(dtype)}


def embed_init(vocab: int, d_model: int, generator: torch.Generator,
               dtype=torch.bfloat16) -> dict:
    w = torch.randn((vocab, d_model), generator=generator,
                    dtype=torch.float32, device=generator.device)
    return {"emb": w.mul_(0.02).to(dtype)}


def linear_specs(in_axis=None, out_axis=None) -> dict:
    """The logical spec of a dense linear ``{"w": [d_in, d_out]}``."""
    return {"w": Spec(in_axis, out_axis)}


def embed_specs() -> dict:
    """The embedding table [V, d]: vocab over "tp" (vocab-parallel), d
    over "fsdp"."""
    return {"emb": Spec("tp", "fsdp")}


def norm_specs() -> dict:
    return {"g": Spec(None)}


def embed_apply(p: dict, tokens: torch.Tensor, shard=None) -> torch.Tensor:
    """Rows of the table for ``tokens``. On a mesh the table is
    vocab-parallel: each rank looks up the tokens in its own rows (zeros
    elsewhere), its "fsdp" split of d gathered, and the pieces are summed
    over "model" bit for bit (one nonzero term each); in the backward each
    rank's rows take the gradients of their own tokens."""
    if shard is None:
        return p["emb"][tokens]
    emb = shard.gather_weight(p["emb"], 1)
    v = emb.shape[0]
    lo = shard.rank("tp") * v
    local = (tokens >= lo) & (tokens < lo + v)
    rows = emb[torch.where(local, tokens - lo, 0)]
    rows = torch.where(local[..., None], rows, torch.zeros_like(rows))
    return shard.sum_one_hot(rows)


def norm_init(d: int, dtype=torch.bfloat16, device="cpu") -> dict:
    return {"g": torch.zeros((d,), dtype=dtype, device=device)}


def _linear_dense(p, x, lp, be):
    return x @ p["w"].to(x.dtype)


def fake_quant_operands(p, x, lp, x_max=None, w_max=None):
    """x fake-quantized at Pa and the weight at Pw (in float32, then cast
    to x's dtype), as the reference's fake-quant routes take them. On a
    mesh ``x_max`` / ``w_max`` map a shard's absmax to the whole
    tensor's (``core.quantize.fake_quant``'s ``reduce_max``)."""
    xq = q.fake_quant(x, lp.a_bits, x_max)
    wq = q.fake_quant(p["w"].to(torch.float32), lp.w_bits,
                      w_max).to(x.dtype)
    return xq, wq


def _linear_fake_quant(p, x, lp, be):
    xq, wq = fake_quant_operands(p, x, lp)
    return xq @ wq


def _token_quant_axis(x) -> int | None:
    """Activation-quant axis of the serving linears: token-shaped inputs
    ([B, D] / [B, S, D]) get one scale per row, so a row's grid never
    depends on what it is batched with; conv-as-im2col patch tensors
    ([B, Ho, Wo, k*k*C]) keep one scale for the whole tensor."""
    return -1 if x.ndim <= 3 else None


def _linear_int8(p, x, lp, be):
    # LM_8b: one exact int8 product against the pre-quantized weights,
    # activations on the packed route's grid (per row on token-shaped
    # input, per tensor on im2col patches).
    xq, x_scale = q.quantize(x.to(torch.float32), min(lp.a_bits, 8),
                             axis=_token_quant_axis(x))
    y = ops.int8_matmul(xq.to(torch.int8), p["wq"])
    return (y.to(torch.float32) * (x_scale * p["w_scale"])).to(x.dtype)


def _linear_packed(p, x, lp, be):
    # The weight precision is the packed tensor's plane count; the plan
    # sets the activation precision. ``dynamic_a`` trims activation planes
    # per group of rows at run time; pack-time weight-group counts trim
    # weight planes on both routes.
    if lp.dynamic_a:
        return ops.loom_linear_serve_dynamic(
            x, p["w_packed"], p["w_scale"], a_bits=lp.a_bits,
            w_bits=p["w_packed"].shape[0], group_size=lp.group_size,
            backend=be, w_counts=lp.w_group_counts, w_group=lp.w_group,
            a_axis=_token_quant_axis(x))
    return ops.loom_linear_serve(
        x, p["w_packed"], p["w_scale"], a_bits=lp.a_bits,
        w_bits=p["w_packed"].shape[0], backend=be,
        w_counts=lp.w_group_counts, w_group=lp.w_group,
        a_axis=_token_quant_axis(x))


_LINEAR_ROUTES = {
    planlib.DENSE: _linear_dense,
    planlib.FAKE_QUANT: _linear_fake_quant,
    planlib.INT8: _linear_int8,
    planlib.PACKED: _linear_packed,
}


def linear_apply(p: dict, x: torch.Tensor, plan: planlib.ExecutionPlan,
                 layer_name: str = "", shard=None) -> torch.Tensor:
    """Dispatch a linear through its resolved LayerPlan; on a mesh through
    its :class:`~repro_torch.dist.parallel.LinearShard` (``shard``)."""
    lp = plan.layer(layer_name, kind="linear")
    if shard is not None:
        return shard.apply(_LINEAR_ROUTES[lp.route], p, x, lp, plan.backend)
    return _LINEAR_ROUTES[lp.route](p, x, lp, plan.backend)


def _conv_dense(p, x, kernel, stride, lp, plan):
    # "same" padding (pad = k//2, Ho = ceil(H/stride)) on the NHWC map.
    w4 = p["w"].to(x.dtype).reshape(kernel, kernel, x.shape[-1], -1)
    y = F.conv2d(x.permute(0, 3, 1, 2), w4.permute(3, 2, 0, 1),
                 stride=stride, padding=kernel // 2)
    return y.permute(0, 2, 3, 1)


def _conv_fake_quant(p, x, kernel, stride, lp, plan):
    xq, wq = fake_quant_operands(p, x, lp)
    return _conv_dense({"w": wq}, xq, kernel, stride, lp, plan)


def _conv_int8(p, x, kernel, stride, lp, plan):
    # The integer conv in float32 where every partial sum fits its
    # mantissa (all three convs of the paper CNN at Pa <= 8).
    c_in = x.shape[-1]
    a_bits = min(lp.a_bits, 8)
    xq, x_scale = q.quantize(x.to(torch.float32), a_bits)
    y = ops.int_conv_same(
        xq, p["wq"].reshape(kernel, kernel, c_in, -1), stride,
        exact_f32=ops.conv_accum_fits_f32(kernel * kernel * c_in, a_bits, 8))
    return (y * (x_scale * p["w_scale"]).to(torch.float32)).to(x.dtype)


def _conv_packed(p, x, kernel, stride, lp, plan):
    # ``dynamic_a`` trims activation planes per group of output windows;
    # its kernel bands the map as the static one does, with the same band.
    tile = plan.conv_tile(lp, x.shape[1], x.shape[2], x.shape[3])
    if lp.dynamic_a:
        return ops.loom_conv_serve_dynamic(
            x, p["w_packed"], p["w_scale"], kernel=kernel, stride=stride,
            a_bits=lp.a_bits, group_size=lp.group_size, backend=plan.backend,
            conv_tile=tile, w_counts=lp.w_group_counts, w_group=lp.w_group)
    return ops.loom_conv_serve(
        x, p["w_packed"], p["w_scale"], kernel=kernel, stride=stride,
        a_bits=lp.a_bits, backend=plan.backend, conv_tile=tile,
        w_counts=lp.w_group_counts, w_group=lp.w_group)


_CONV_ROUTES = {
    planlib.DENSE: _conv_dense,
    planlib.FAKE_QUANT: _conv_fake_quant,
    planlib.INT8: _conv_int8,
    planlib.PACKED: _conv_packed,
}


def conv_apply(p: dict, x: torch.Tensor, kernel: int, stride: int,
               plan: planlib.ExecutionPlan,
               layer_name: str = "") -> torch.Tensor:
    """Dispatch a "same"-padded NHWC convolution through its LayerPlan."""
    lp = plan.layer(layer_name, kind="conv", kernel=kernel, stride=stride)
    return _CONV_ROUTES[lp.route](p, x, kernel, stride, lp, plan)


def quantize_by_columns(w: torch.Tensor, bits: int, convert,
                        reduce_max=None):
    """``convert(quantize(w.float(), bits)[0])`` of a weight [K, N] under
    one absmax scale, taken over blocks of its columns (concatenated on
    the last dim, bit for bit the whole tensor's), so that an LM head of
    billions of weights converts without its float32 copy (18.9 GB for
    nemotron-4-340b's). ``reduce_max`` (a shard of a leaf on a mesh) maps
    the local absmax to the whole leaf's. Returns (converted, scale
    float32 [1, 1])."""
    per_column = 20 * w.shape[0]      # float32 copy and quantize's passes
    absmax = bitpack.by_columns(lambda b: b.abs().amax().reshape(1), w,
                                per_column).amax().to(torch.float32)
    if reduce_max is not None:
        absmax = reduce_max(absmax.reshape(1))
    scale = q.compute_scale(absmax.reshape(1, 1), bits)
    return bitpack.by_columns(
        lambda b: convert(q.quantize(b.to(torch.float32), bits,
                                     scale=scale)[0]),
        w, per_column), scale


def _convert_linear_int8(p, prec, reduce_max=None):
    wq, scale = quantize_by_columns(p["w"], 8, lambda b: b.to(torch.int8),
                                    reduce_max)
    return {"wq": wq, "w_scale": scale}


def _convert_linear_packed(p, prec, reduce_max=None):
    bits = prec.w_bits
    wp, scale = quantize_by_columns(
        p["w"], bits, lambda b: bitpack.pack_weights(b, bits), reduce_max)
    return {"w_packed": wp, "w_scale": scale}


_LINEAR_CONVERTERS = {"serve_int8": _convert_linear_int8,
                      "serve_packed": _convert_linear_packed}

# The serving layouts' logical specs, from the dense weight's (in, out):
# the packed K/8 axis takes the input's split and N the output's, the
# planes and the scale replicated.
_LINEAR_SPEC_CONVERTERS = {
    "serve_int8": lambda in_ax, out_ax: {"wq": Spec(in_ax, out_ax),
                                         "w_scale": Spec(None, None)},
    "serve_packed": lambda in_ax, out_ax: {
        "w_packed": Spec(None, in_ax, out_ax), "w_scale": Spec(None, None)},
}


def convert_linear_for_serving(p: dict, prec, mode: str,
                               reduce_max=None) -> dict:
    """Offline weight conversion for one linear or conv, per-tensor scale:
    int8 weights ``{"wq", "w_scale"}`` (``serve_int8``, always 8 bits) or
    planes packed at ``prec.w_bits`` (``serve_packed``). ``reduce_max``:
    see :func:`quantize_by_columns` (a rank's shard packs to the slice of
    the whole leaf's bytes when its K-slice is whole packed rows)."""
    try:
        converter = _LINEAR_CONVERTERS[mode]
    except KeyError:
        raise ValueError(f"no serving conversion for mode {mode!r}; "
                         f"expected one of {sorted(_LINEAR_CONVERTERS)}"
                         ) from None
    return converter(p, prec, reduce_max)


def convert_linear_specs(spec: dict, mode: str) -> dict:
    """Spec-only counterpart of :func:`convert_linear_for_serving`."""
    try:
        converter = _LINEAR_SPEC_CONVERTERS[mode]
    except KeyError:
        raise ValueError(f"no serving conversion for mode {mode!r}") from None
    return converter(spec["w"][0], spec["w"][1])
