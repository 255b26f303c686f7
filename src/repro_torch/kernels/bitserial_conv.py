"""K2, K4 and K5: fused bit-serial "same" convolutions, as Hopper kernels.

Ports of ``repro/kernels/bitserial_conv.py``: ``bitserial_conv`` (K2,
packed weight planes), ``bitserial_conv_wgroup`` (K4, a weight plane count
per filter group) and ``bitserial_conv_dynamic`` (K5, dense int8 weights
and an activation plane count per window group). All three launch one
kernel on the int8 tensor cores, ``tcconv::conv_tc_kernel`` in
``csrc/bitserial_conv.cu``, whose template parameter names the weight
operand: packed planes (K2, K4) or dense int8 (K5). Their plain PyTorch
versions are the oracles :func:`repro_torch.kernels.ref.bitserial_conv_ref`,
:func:`~repro_torch.kernels.ref.bitserial_conv_wgroup_ref` and
:func:`~repro_torch.kernels.ref.conv_dynamic_dense_ref`.

Each block stages one band of input rows (the halo included) in shared
memory and gathers its patches from there, so no patch tensor reaches
device memory. :func:`conv_tc_layout` mirrors the block's shared memory;
:func:`conv_smem_bytes`, its smallest footprint at a band size, is the
counterpart of the TPU kernel's ``conv_vmem_bytes``: the plan sizes
``rows_per_band`` so that it fits :data:`SMEM_BUDGET`. The wrappers then
take as much of the reduction per chunk as the rest of the budget holds
(:func:`conv_tc_chunk`) and two images a block where a band is one tile
(:func:`conv_tc_images_per_block`). K5 bands like K2 (the reference's K5
aligns its bands to the window groups; here each pixel looks its group
up, so any band is exact).

``bitserial_conv.launches``, ``bitserial_conv_wgroup.launches`` and
``bitserial_conv_dynamic.launches`` count each wrapper's launches (the
plain route on CPU tensors does not count).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import bitserial_conv_ref as bitserial_conv_plain
from repro_torch.kernels.ref import (
    bitserial_conv_wgroup_ref as bitserial_conv_wgroup_plain)
from repro_torch.kernels.ref import (
    conv_dynamic_dense_ref as bitserial_conv_dynamic_plain)

# Shared memory one H100 thread block can use (bytes, static + dynamic).
SMEM_BUDGET = 232_448

# The kernel's tile (csrc/bitserial_conv.cu, tcconv): BM pixels x BN
# filters, an output row staged in OUT_LD bytes.
TC_BM, TC_BN = 64, 64
_TC_OUT_LD = 4 * TC_BN + 32


def band_geometry(ho: int, wo: int, rows_per_band: int | None, kernel: int,
                  stride: int) -> tuple[int, int, int]:
    """(rows_per_band, n_bands, band_input_rows) of the banded grid.

    ``rows_per_band=None`` means one band covering the whole map; values
    are clamped to [1, Ho]."""
    rpb = ho if rows_per_band is None else max(1, min(rows_per_band, ho))
    return rpb, -(-ho // rpb), (rpb - 1) * stride + kernel


def _round16(v: int) -> int:
    return -(-v // 16) * 16


def conv_tc_layout(w: int, c: int, *, kernel: int, stride: int, rpb: int,
                   kc: int, wide: bool) -> dict:
    """The kernel's shared-memory layout (``tcconv::Layout``): the band's
    row stride and the left pad that puts each row's W*C interior bytes on
    a 16-byte boundary; ``vec``, the bytes a patch run is copied in (the
    largest of 16, 8, 4, 2, 1 dividing C); ``lds``, the byte stride of a
    gathered patch and of a filter's B operand (kc plus 0 or 32, so that it
    is 32 or 96 mod 128); the byte offsets of the B operand (``b_off``;
    two slices of BN filters where ``wide``), the patch tile (``a_off``),
    the slot offsets (``koff_off``), the filter counts (``cnt_off``), the
    pixel offsets (``pix_off``) and K5's pixel counts (``pcnt_off``); and
    ``bytes``, the block's total."""
    pad = kernel // 2
    lpad = (16 - pad * c % 16) % 16
    row_ld = _round16(lpad + (w + 2 * pad) * c)
    band_rows = (rpb - 1) * stride + kernel
    vec = next(v for v in (16, 8, 4, 2, 1) if c % v == 0)
    lds = kc + (32 if kc // 32 % 2 == 0 else 0)
    b_off = _round16(band_rows * row_ld)
    a_off = b_off + (2 if wide else 1) * TC_BN * lds
    koff_off = a_off + _round16(TC_BM * max(lds, _TC_OUT_LD))
    cnt_off = koff_off + _round16(4 * (kc // vec))
    pix_off = cnt_off + _round16(4 * (TC_BN + 1))
    pcnt_off = pix_off + 4 * TC_BM
    return dict(pad=pad, lpad=lpad, row_ld=row_ld, band_rows=band_rows,
                vec=vec, lds=lds, b_off=b_off, a_off=a_off, koff_off=koff_off,
                cnt_off=cnt_off, pix_off=pix_off, pcnt_off=pcnt_off,
                bytes=pcnt_off + 4 * TC_BM)


def conv_tc_chunk(h: int, w: int, c: int, *, kernel: int, stride: int,
                  rpb: int, wide: bool) -> int:
    """The kernel's reduction rows per chunk: the whole K8 rounded up to 32
    where the block's shared memory allows it (the B operand is then made
    once per block), else the fewest equal chunks of a multiple of 32 that
    fit :data:`SMEM_BUDGET`."""
    kp = -(-kernel * kernel * c // 32) * 32
    for nchunks in range(1, kp // 32 + 1):
        kc = -(-kp // nchunks // 32) * 32
        if conv_tc_layout(w, c, kernel=kernel, stride=stride, rpb=rpb, kc=kc,
                          wide=wide)["bytes"] <= SMEM_BUDGET:
            return kc
    raise ValueError(f"a band of {rpb} output rows of a {h}x{w}x{c} map "
                     f"leaves no room for a 32-row chunk")


def conv_tc_images_per_block(band_pixels: int) -> int:
    """Images one block runs, making its filters' B operand once: two
    where a band is a single tile of pixels (the fold then costs about as
    much as the tile's products, as at the paper CNN's conv3), else one (a
    band of several tiles already shares its B operand). It never changes
    a bit of the result."""
    return 2 if band_pixels <= TC_BM else 1


def conv_smem_bytes(h: int, w: int, c: int, *, kernel: int, stride: int = 1,
                    rows_per_band: int | None = None) -> int:
    """Shared memory (bytes) one block needs at a band size: the int8
    input band with 16-byte aligned rows, ((rpb-1)*stride + k) of them,
    beside the smallest tile (one 32-row chunk of the reduction, two
    slices of B as at Pw > 8). The output channels, Pw and the plane
    counts do not change it."""
    ho, wo = -(-h // stride), -(-w // stride)
    rpb, _, _ = band_geometry(ho, wo, rows_per_band, kernel, stride)
    return conv_tc_layout(w, c, kernel=kernel, stride=stride, rpb=rpb, kc=32,
                          wide=True)["bytes"]


def conv_tc_layout_bytes(w: int, c: int, *, kernel: int, stride: int,
                         rpb: int, kc: int, wide: bool) -> int:
    """The built kernel's own ``tcconv::Layout`` total (bytes), computed on
    the host from the library, to hold :func:`conv_tc_layout` equal to it.
    Builds the library at first use (needs ``nvcc``, not a card)."""
    fn = _build.load("bitserial_conv").conv_tc_layout_bytes
    fn.argtypes = [ctypes.c_int] * 7
    fn.restype = ctypes.c_int
    return fn(w, c, kernel, stride, rpb, kc, int(wide))


@functools.cache
def _launcher(entry: str, n_pointers: int, n_ints: int):
    fn = getattr(_build.load("bitserial_conv"), entry)
    fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, kernel: int, stride: int) -> None:
    if x.dtype != torch.int8 or x.ndim != 4:
        raise TypeError(f"x must be int8 NHWC [B, H, W, C], got {x.dtype} "
                        f"{tuple(x.shape)}")
    if kernel % 2 != 1 or stride < 1:
        raise ValueError(f"odd kernels and stride >= 1 only, got k={kernel}, "
                         f"stride={stride}")


def _check_packed(x: torch.Tensor, w_packed: torch.Tensor, kernel: int,
                  stride: int, w_bits: int) -> None:
    _check(x, kernel, stride)
    if w_packed.dtype != torch.uint8 or w_packed.ndim != 3:
        raise TypeError(f"w_packed must be uint8 [Pw, ceil(k*k*C/8), N], got "
                        f"{w_packed.dtype} {tuple(w_packed.shape)}")
    pw, k8, _ = w_packed.shape
    kkc = kernel * kernel * x.shape[3]
    if pw != w_bits or not 1 <= w_bits <= 16 or k8 != -(-kkc // 8):
        raise ValueError(f"x {tuple(x.shape)} and w_packed "
                         f"{tuple(w_packed.shape)} at k={kernel}, "
                         f"w_bits={w_bits} do not match")
    if x.device != w_packed.device:
        raise ValueError(f"x on {x.device}, w_packed on {w_packed.device}")


def _check_counts(counts: torch.Tensor, shape: tuple, x: torch.Tensor) -> None:
    if counts.dtype != torch.int32 or tuple(counts.shape) != shape:
        raise ValueError(f"counts must be int32 {list(shape)}, got "
                         f"{counts.dtype} {tuple(counts.shape)}")
    if counts.device != x.device:
        raise ValueError(f"x on {x.device}, counts on {counts.device}")


def _launch(entry: str, kernel_fn, x: torch.Tensor, pointers: tuple, n: int,
            ints: tuple, *, kernel: int, stride: int,
            rows_per_band: int | None, wide: bool) -> torch.Tensor:
    """Check the CUDA operands, allocate the output and launch ``entry`` on
    the current stream. ``ints`` is (head, tail) of the C signature
    (x, *pointers, out, B, H, W, C, N, k, stride, *head, rows_per_band,
    *tail, kc, ipb, stream); ``wide``: two slices of B (Pw > 8)."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not all(t.is_contiguous() for t in (x, *pointers)):
        raise ValueError(f"{kernel_fn.__name__} needs contiguous operands")
    b, h, w, c = x.shape
    ho, wo = -(-h // stride), -(-w // stride)
    rpb, nb, _ = band_geometry(ho, wo, rows_per_band, kernel, stride)
    smem = conv_smem_bytes(h, w, c, kernel=kernel, stride=stride,
                           rows_per_band=rpb)
    if smem > SMEM_BUDGET:
        raise ValueError(f"a band of {rpb} output rows needs {smem} bytes of "
                         f"shared memory > {SMEM_BUDGET}")
    if nb > 65535 or b > 65535:
        raise ValueError(f"{nb} bands x {b} images exceed the kernel's grid")
    out = torch.empty((b, ho, wo, n), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    kc = conv_tc_chunk(h, w, c, kernel=kernel, stride=stride, rpb=rpb,
                       wide=wide)
    head, tail = ints
    tail = (*tail, kc, conv_tc_images_per_block(rpb * wo))
    with torch.cuda.device(x.device):
        err = _launcher(entry, 2 + len(pointers), 8 + len(head) + len(tail))(
            x.data_ptr(), *(t.data_ptr() for t in pointers), out.data_ptr(),
            b, h, w, c, n, kernel, stride, *head, rpb, *tail,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{kernel_fn.__name__} launch failed: CUDA error "
                           f"{err}")
    kernel_fn.launches += 1
    return out


def bitserial_conv(x: torch.Tensor, w_packed: torch.Tensor, *, kernel: int,
                   stride: int = 1, w_bits: int,
                   rows_per_band: int | None = None) -> torch.Tensor:
    """x: int8 [B, H, W, C]; w_packed: uint8 [Pw, ceil(k*k*C/8), N] ->
    int32 [B, ceil(H/stride), ceil(W/stride), N], integer-exact.

    ``rows_per_band`` (None = the whole map) cuts the output rows into
    bands, one block row per band; it never changes the result. A CUDA
    tensor launches the kernel on the current stream (no
    synchronisation); a CPU tensor takes the plain version.
    """
    _check_packed(x, w_packed, kernel, stride, w_bits)
    if x.device.type == "cpu":
        return bitserial_conv_plain(x, w_packed, kernel=kernel, stride=stride,
                                    w_bits=w_bits)
    return _launch("bitserial_conv_launch", bitserial_conv, x, (w_packed,),
                   w_packed.shape[2], ((w_bits,), ()), kernel=kernel,
                   stride=stride, rows_per_band=rows_per_band,
                   wide=w_bits > 8)


def bitserial_conv_wgroup(x: torch.Tensor, w_packed: torch.Tensor,
                          counts: torch.Tensor, *, kernel: int,
                          stride: int = 1, w_bits: int, w_group: int = 16,
                          rows_per_band: int | None = None) -> torch.Tensor:
    """:func:`bitserial_conv` with static weight-group trimming: filter
    group g (output channels [g*w_group, (g+1)*w_group), the last one may
    be ragged) uses only its first counts[g] weight planes, plane
    counts[g]-1 negated. counts: int32 [ceil(N/w_group)], each in [1, Pw]
    (the pack-time OR-tree counts keep the result equal to the untrimmed
    conv). Same devices and banding as :func:`bitserial_conv`.
    """
    _check_packed(x, w_packed, kernel, stride, w_bits)
    n = w_packed.shape[2]
    if w_group < 1:
        raise ValueError(f"w_group must be >= 1, got {w_group}")
    _check_counts(counts, (-(-n // w_group),), x)
    if x.device.type == "cpu":
        return bitserial_conv_wgroup_plain(x, w_packed, counts, kernel=kernel,
                                           stride=stride, w_bits=w_bits,
                                           w_group=w_group)
    return _launch("bitserial_conv_wgroup_launch", bitserial_conv_wgroup, x,
                   (w_packed, counts), n, ((w_bits,), (w_group,)),
                   kernel=kernel, stride=stride, rows_per_band=rows_per_band,
                   wide=w_bits > 8)


def bitserial_conv_dynamic(x: torch.Tensor, wq: torch.Tensor,
                           counts: torch.Tensor, *, kernel: int,
                           stride: int = 1, group_size: int = 256,
                           rows_per_band: int | None = None) -> torch.Tensor:
    """"Same" conv with runtime activation-plane trimming.

    x: int8 [B, H, W, C]; wq: int8 [K8, N], the dense weights (or one int8
    subplane of them) zero-padded to K8 = ceil(k*k*C/8)*8 rows; counts:
    int32 [B, ceil(Ho*Wo/group_size)], each in [1, 8]. Window p (row-major
    over Ho x Wo) of image b uses only the first counts[b, p // group_size]
    activation planes, plane count-1 negated. Returns int32 [B, Ho, Wo, N].
    Same devices and banding as :func:`bitserial_conv`.
    """
    _check(x, kernel, stride)
    kkc = kernel * kernel * x.shape[3]
    if wq.dtype != torch.int8 or wq.ndim != 2 or \
            wq.shape[0] != -(-kkc // 8) * 8:
        raise TypeError(f"wq must be int8 [{-(-kkc // 8) * 8}, N] at "
                        f"k={kernel}, C={x.shape[3]}, got {wq.dtype} "
                        f"{tuple(wq.shape)}")
    if x.device != wq.device:
        raise ValueError(f"x on {x.device}, wq on {wq.device}")
    b, h, w, _ = x.shape
    nwin = -(-h // stride) * -(-w // stride)
    if group_size < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
    ngroups = -(-nwin // group_size)
    _check_counts(counts, (b, ngroups), x)
    if x.device.type == "cpu":
        return bitserial_conv_dynamic_plain(x, wq, counts, kernel=kernel,
                                            stride=stride,
                                            group_size=group_size)
    return _launch("bitserial_conv_dynamic_launch", bitserial_conv_dynamic, x,
                   (wq, counts), wq.shape[1], ((), (group_size, ngroups)),
                   kernel=kernel, stride=stride, rows_per_band=rows_per_band,
                   wide=False)


bitserial_conv.launches = 0
bitserial_conv_wgroup.launches = 0
bitserial_conv_dynamic.launches = 0
