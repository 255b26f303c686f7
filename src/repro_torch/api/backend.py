"""Backend registry: one object per kernel substrate, one uniform op surface.

PyTorch-port counterpart of ``repro/api/backend.py``. Model code asks its
:class:`~repro_torch.api.plan.LayerPlan` for the backend and calls one of
six ops:

    matmul_planes          static bit-serial matmul over packed planes
    matmul_planes_dynamic  plane-count-gated variant (runtime trimming)
    conv_planes            fused bit-serial convolution
    conv_planes_dynamic    conv with runtime activation-plane trimming
    dynamic_quant          per-group activation quantization
    attention              full-sequence attention

Built-ins:

    torch_ref   the plain PyTorch oracles, on any device
    cuda        the hand-written Hopper kernels (K1, K2); on CPU tensors
                their wrappers take the plain versions

This slice ports the two static ops. The other four raise
NotImplementedError naming the ROADMAP item that brings them, and so does
static weight-group trimming (plane counts below Pw), which needs K3/K4.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.bitserial_conv import bitserial_conv
from repro_torch.kernels.bitserial_matmul import bitserial_matmul


def _untrimmed(w_counts, w_bits: int, op: str) -> None:
    """The all-full-counts guard: counts that trim nothing keep the static
    path; any count below Pw needs the weight-group kernels."""
    if w_counts is not None and any(c < w_bits for c in w_counts):
        raise NotImplementedError(
            f"{op}: weight-group plane trimming (counts {tuple(w_counts)} "
            f"below Pw={w_bits}) is not ported yet (ROADMAP A.8, kernels "
            f"K3/K4); build the policy with w_group=0 to serve untrimmed")


class Backend:
    """The ``torch_ref`` backend: plain PyTorch, any device. Also the base
    class of the kernel backends."""

    name = "torch_ref"

    def matmul_planes(self, xq, w_packed, *, w_bits: int, w_counts=None,
                      w_group: int = 16):
        """int8 [M, K] @ packed uint8 [Pw, K//8, N] -> exact int32 [M, N]."""
        _untrimmed(w_counts, w_bits, "matmul_planes")
        return ref.bitserial_matmul_ref(xq, w_packed, w_bits)

    def conv_planes(self, xq, w_packed, *, kernel: int, stride: int,
                    w_bits: int, conv_tile: int | None = None,
                    w_counts=None, w_group: int = 16):
        """Fused bit-serial "same" conv: int8 [B,H,W,C] x packed planes ->
        exact int32 [B, Ho, Wo, N]. ``conv_tile`` (rows per band) only
        matters to the kernel."""
        _untrimmed(w_counts, w_bits, "conv_planes")
        return ref.bitserial_conv_ref(xq, w_packed, kernel=kernel,
                                      stride=stride, w_bits=w_bits)

    def matmul_planes_dynamic(self, *args, **kwargs):
        raise NotImplementedError("matmul_planes_dynamic: not ported yet "
                                  "(ROADMAP A.8, kernel K3)")

    def conv_planes_dynamic(self, *args, **kwargs):
        raise NotImplementedError("conv_planes_dynamic: not ported yet "
                                  "(ROADMAP A.8, kernel K5)")

    def dynamic_quant(self, *args, **kwargs):
        raise NotImplementedError("dynamic_quant: not ported yet "
                                  "(ROADMAP A.8, kernel K6)")

    def attention(self, *args, **kwargs):
        raise NotImplementedError("attention: not ported yet "
                                  "(ROADMAP queue B, kernel K7)")


class CudaBackend(Backend):
    """The hand-written Hopper kernels: K1 ``bitserial_matmul`` and K2
    ``bitserial_conv``."""

    name = "cuda"

    def matmul_planes(self, xq, w_packed, *, w_bits, w_counts=None,
                      w_group=16):
        _untrimmed(w_counts, w_bits, "matmul_planes")
        return bitserial_matmul(xq, w_packed, w_bits=w_bits)

    def conv_planes(self, xq, w_packed, *, kernel, stride, w_bits,
                    conv_tile=None, w_counts=None, w_group=16):
        _untrimmed(w_counts, w_bits, "conv_planes")
        return bitserial_conv(xq, w_packed, kernel=kernel, stride=stride,
                              w_bits=w_bits, rows_per_band=conv_tile)


_REGISTRY: dict[str, Backend] = {}


def register_backend(name: str, backend: Backend) -> Backend:
    """Register (or replace) a backend under ``name``."""
    _REGISTRY[name] = backend
    return backend


def resolve_backend(backend=None) -> Backend:
    """A Backend object from a Backend, a registered name, or None (the
    ``torch_ref`` built-in)."""
    if isinstance(backend, Backend):
        return backend
    if backend is None:
        backend = "torch_ref"
    if not isinstance(backend, str):
        raise TypeError(f"backend must be a Backend or name, got {backend!r}")
    try:
        return _REGISTRY[backend]
    except KeyError:
        raise KeyError(f"unknown backend {backend!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


register_backend("torch_ref", Backend())
register_backend("cuda", CudaBackend())
