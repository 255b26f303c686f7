"""Roofline-grade analysis of the program PyTorch runs: the counterpart of
the reference's ``hloanalysis``, which parses compiled HLO.

The port compiles nothing, so :class:`OpAnalysis` reads the step itself:
one ``TorchDispatchMode`` sees every aten op of the step (on real tensors
on the card, or on fake tensors in a dry run) and derives the three
roofline inputs, per rank:

    flops             the products' operations: 2*M*N*K by
                      ``torch.utils.flop_counter``'s formulas (mm, bmm,
                      convolution, attention), plus every broadcast
                      elementwise multiply whose result a sum reduces
                      (``decode_attend``'s products, written so for batch
                      invariance: 2 per term), plus the Loom kernels' work
    hbm_bytes         each op's operand and output bytes. Views, metadata
                      ops and allocations count zero (the reference's
                      ``_PLUMBING``); an operand broadcast by ``expand``
                      counts its distinct elements; an in-place write
                      counts what it writes (an indexed write its values,
                      not the whole buffer: the reference's alias rule for
                      dynamic update slices), a gather what it gathers (an
                      embedding lookup its rows, not the table)
    collective_bytes  the bytes this rank hands to collectives, read from
                      the mesh's ``Comm`` counters, by kind and by link

Eager PyTorch does not fuse: every op reads and writes its tensors, so
the port keeps one byte count where the reference keeps two ("raw", and
"fused" by an oracle of what TPU fusion would elide).

**The Loom kernels count as one kernel each, by their work.** Every op of
the backend surface (``api.backend``: ``matmul_planes`` is K1, or K3 with
pack-time counts below Pw; ``matmul_planes_dynamic`` K3; ``conv_planes``
K2, or K4 with counts; ``conv_planes_dynamic`` K5 once per 7-bit subplane
of its weights; ``dynamic_quant`` K6; ``attention`` K7) reaches
:meth:`OpAnalysis.kernel_call`, which counts the kernel with the bytes and
operations of ``kernels.work`` and records none of the aten ops inside
it. The card's kernels launch through ctypes, which no dispatch mode
sees; the plain versions' aten ops would be counted otherwise. So a trace
on ``torch_ref`` and the card's step on ``cuda`` read the same work.

Peak memory: ``torch.distributed._tools.mem_tracker.MemTracker`` over the
step (it works on fake tensors), the step's arguments registered as
external.

:func:`roofline_terms` turns the totals into seconds on the H100 SXM's
datasheet constants (``kernels.work``): bf16 989 TFLOP/s, int8 1979 TOP/s,
float32 67 TFLOP/s, HBM3 3.35 TB/s, NVLink 450 GB/s per direction within
a node of 8, 50 GB/s per card (400 Gb/s InfiniBand) for a group that
spans nodes. They are modeled times, not measured ones.
"""
from __future__ import annotations

import collections
import functools
import dataclasses
import sys
import weakref

import torch
from torch.distributed._tools.mem_tracker import MemTracker
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.api import backend as backendlib
from repro_torch.kernels import work as W

_aten = torch.ops.aten
# Allocations: their memory is written by the op that fills it.
_ALLOCATIONS = {_aten.empty.memory_format, _aten.empty_strided.default,
                _aten.empty_like.default, _aten.new_empty.default,
                _aten.new_empty_strided.default}
# In-place writes through an index: they write their values, not the
# buffer they index.
_INDEXED_WRITES = {"index_put_", "index_copy_", "scatter_", "scatter_add_",
                   "index_add_", "masked_scatter_", "_index_put_impl_"}
# Gathers read the elements they gather, not their whole source (an
# embedding lookup reads its rows, not the table).
_GATHERS = {"index", "index_select", "gather", "embedding"}
_SUMS = {_aten.sum.dim_IntList, _aten.sum.default}
_COMPOSITE = torch._C.DispatchKey.CompositeImplicitAutograd


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements (a dim broadcast by stride 0
    counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _peak_name(dtype) -> str:
    return {torch.bfloat16: "bf16", torch.float16: "bf16",
            torch.int8: "int8"}.get(dtype, "f32")


_PEAKS = {"bf16": W.BF16_FLOPS, "int8": W.INT8_OPS_PER_S,
          "f32": W.F32_FLOPS}
_PEAK_NAMES = {v: k for k, v in _PEAKS.items()}


@dataclasses.dataclass
class Totals:
    """One rank's totals over a recorded run."""
    flops: float = 0.0                 # every operation, of any type
    flops_by_type: dict = dataclasses.field(default_factory=dict)
    hbm_bytes: float = 0.0
    kernels: dict = dataclasses.field(default_factory=dict)   # K1.. -> n
    kernel_bytes: float = 0.0
    kernel_ops: float = 0.0
    kernel_bound_s: dict = dataclasses.field(default_factory=dict)
    collective_bytes: float = 0.0
    collective_by_kind: dict = dataclasses.field(default_factory=dict)
    n_collectives: dict = dataclasses.field(default_factory=dict)
    link_bytes: dict = dataclasses.field(default_factory=dict)
    n_ops: int = 0                     # aten ops recorded
    peak_bytes: float = 0.0            # MemTracker's peak
    argument_bytes: float = 0.0
    output_bytes: float = 0.0          # results in storages of their own

    def counts(self) -> dict:
        """What the card check holds equal between two runs."""
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "kernels": dict(sorted(self.kernels.items()))}


def _kernel_calls(op: str, args: tuple, kw: dict) -> list:
    """[(kernel name, its wrapper's args, kw)] of one backend op."""
    if op == "matmul_planes":
        xq, wp = args[:2]
        counts, bits = kw.get("w_counts"), kw["w_bits"]
        if backendlib._trims(counts, bits):
            return [("bitserial_matmul_dynamic", (xq, wp, tuple(counts)),
                     {"bn": kw.get("w_group", 16)})]
        return [("bitserial_matmul", (xq, wp), {})]
    if op == "matmul_planes_dynamic":
        return [("bitserial_matmul_dynamic", args[:3], {"bn": kw["bn"]})]
    if op == "conv_planes":
        xq, wp = args[:2]
        counts, bits = kw.get("w_counts"), kw["w_bits"]
        geo = {"kernel": kw["kernel"], "stride": kw["stride"]}
        if backendlib._trims(counts, bits):
            return [("bitserial_conv_wgroup", (xq, wp, tuple(counts)),
                     dict(geo, w_group=kw.get("w_group", 16)))]
        return [("bitserial_conv", (xq, wp), geo)]
    if op == "conv_planes_dynamic":
        xq, wp, counts = args[:3]
        bits = kw["w_bits"]
        dense = torch.Size((wp.shape[1] * 8, wp.shape[2]))    # int8 [K8, N]
        n = 1 if bits <= 8 else -(-bits // 7)
        return [("bitserial_conv_dynamic", (xq, dense, counts),
                 {"kernel": kw["kernel"], "stride": kw["stride"]})] * n
    if op == "dynamic_quant":
        return [("dynamic_quant", args[:1], kw)]
    if op == "attention":
        return [("flash_attention", args[:3], kw)]
    raise KeyError(op)


def _caller() -> str:
    """The innermost ``repro_torch`` function on the stack (outside this
    module, the backend and the collectives)."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if "repro_torch" in name and not name.endswith(
                ("opanalysis.py", "backend.py", "parallel.py")):
            mod = name.rsplit("repro_torch", 1)[1].strip("/\\")[:-3]
            return f"{mod.replace('/', '.')}.{f.f_code.co_name}"
        f = f.f_back
    return "?"


class _Recorder(TorchDispatchMode):
    """The dispatch mode of an :class:`OpAnalysis` (a mode of its own, so
    a composite op can re-enter it to record its parts)."""

    def __init__(self, analysis):
        super().__init__()
        self.analysis = analysis

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "aten" and \
                func.has_kernel_for_dispatch_key(_COMPOSITE):
            # Composite ops reach a dispatch mode whole under
            # ``inference_mode`` and decomposed otherwise: record their
            # parts either way, so two runs of one step read alike.
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self.analysis.record(func, args, kwargs, out)
        return out


class OpAnalysis:
    """Records one rank's step: ``with OpAnalysis(comm) as a: step()``,
    then :meth:`totals`. ``comm``: the mesh's ``Comm`` (its counters are
    read before and after); ``profile``: label every op by its innermost
    ``repro_torch`` function for :meth:`attribute`; ``memory``: track the
    peak (``MemTracker``), with ``arguments`` (tensors or trees of them)
    registered as the step's inputs."""

    def __init__(self, comm=None, profile: bool = False, memory: bool = True,
                 arguments=()):
        self._recorder = _Recorder(self)
        self.comm = comm
        self.profile = profile
        self._memory = memory
        self._arguments = [t for a in arguments for t in _leaves(a)]
        self.t = Totals()
        self._paused = 0
        self._products = {}
        self._mem_by = collections.Counter()
        self._coll_by = collections.Counter()
        self._tracker = None

    # -- recording ------------------------------------------------------

    def __enter__(self):
        self._comm0 = self._comm_state()
        # The analysis and its recorder refer to each other, so only the
        # cyclic collector frees them: hold no argument past this call
        # (a served step's weights would stay on the card until then).
        arguments, self._arguments = self._arguments, []
        if self._memory:
            self._tracker = MemTracker()
            seen = {}
            for t in arguments:
                seen.setdefault(id(t), t)
            if seen:
                self._tracker.track_external(*seen.values())
            self.t.argument_bytes = float(storage_bytes(arguments))
            self._tracker.__enter__()
        self._hooked = self._hook_backends()
        self._recorder.__enter__()
        return self

    def __exit__(self, *exc):
        out = self._recorder.__exit__(*exc)
        for cls, op, fn in reversed(self._hooked):
            setattr(cls, op, fn)
        if self._tracker is not None:
            self._tracker.__exit__(*exc)
            snap = self._tracker.get_tracker_snapshot("peak")
            self.t.peak_bytes = float(max(
                (v.get("Total", 0) for v in snap.values()), default=0))
            self._tracker = None
        calls, nbytes, links = self._comm_state()
        c0, b0, l0 = self._comm0
        for kind in calls:
            name = "-".join(str(k) for k in kind if k is not None)
            n = calls[kind] - c0.get(kind, 0)
            if n:
                self.t.n_collectives[name] = n
                self.t.collective_by_kind[name] = float(
                    nbytes[kind] - b0.get(kind, 0))
        self.t.collective_bytes = float(sum(
            self.t.collective_by_kind.values()))
        self.t.link_bytes = {k: float(links[k] - l0.get(k, 0))
                             for k in links if links[k] - l0.get(k, 0)}
        return out

    def _hook_backends(self) -> list:
        """Route every op of the backend surface, on each backend class,
        through :meth:`kernel_call` while this analysis records. Returns
        (class, op, original) to restore."""
        def observed(op, fn):
            @functools.wraps(fn)
            def wrapper(backend, *args, **kwargs):
                return self.kernel_call(
                    op, lambda: fn(backend, *args, **kwargs), args, kwargs)
            return wrapper
        hooked = []
        for cls in (backendlib.Backend, backendlib.CudaBackend,
                    backendlib.GuardedBackend):
            for op in backendlib.BACKEND_OPS:
                fn = cls.__dict__.get(op)
                if fn is not None:
                    hooked.append((cls, op, fn))
                    setattr(cls, op, observed(op, fn))
        return hooked

    def _comm_state(self):
        if self.comm is None:
            return {}, {}, {}
        return (dict(self.comm.calls), dict(self.comm.bytes),
                dict(self.comm.link_bytes))

    def kernel_call(self, op: str, run, args: tuple, kw: dict):
        """One op of the backend surface: run it unrecorded, count its
        kernels by ``kernels.work``."""
        if self._paused:
            return run()
        self._paused += 1
        try:
            out = run()
            first = out[0] if isinstance(out, tuple) else out
            works = [(name, W.work(name, kargs, kkw, out if name ==
                                   "dynamic_quant" else first))
                     for name, kargs, kkw in _kernel_calls(op, args, kw)]
        finally:
            self._paused -= 1
        for name, (nbytes, ops, peak) in works:
            kname = W.KERNEL_NAMES[name]
            self.t.kernels[kname] = self.t.kernels.get(kname, 0) + 1
            self.t.kernel_bound_s[kname] = self.t.kernel_bound_s.get(
                kname, 0.0) + W.bound_s(nbytes, ops, peak)[0]
            self.t.kernel_bytes += nbytes
            self.t.kernel_ops += ops
            self.t.hbm_bytes += nbytes
            self._add_flops(ops, _PEAK_NAMES[peak])
            if self.profile:
                self._mem_by[f"{_caller()}:{kname}"] += nbytes
        return out

    def _add_flops(self, n: float, kind: str) -> None:
        self.t.flops += n
        self.t.flops_by_type[kind] = self.t.flops_by_type.get(kind, 0) + n

    def _is_product(self, t) -> bool:
        r = self._products.get(id(t))
        return r is not None and r() is t

    def record(self, func, args, kwargs, out) -> None:
        """One aten op that ran (outside every backend op)."""
        if self._paused:
            return
        ns = func.namespace
        if ns != "aten":
            if self.profile and ns in ("c10d", "_c10d_functional"):
                n = sum(tensor_bytes(t) for t in _tensors(args))
                self._coll_by[f"{_caller()}:{func.__name__}"] += n
            return
        self.t.n_ops += 1
        if func.is_view or func in _ALLOCATIONS:
            return
        outs = _tensors(out)
        if not outs:
            return                        # metadata: sizes, devices, items
        packet = func.overloadpacket
        if packet in flop_registry:
            ins = _tensors(args)
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            self._add_flops(n, _peak_name(ins[0].dtype if ins else None))
        elif packet is _aten.mul and len(outs) == 1:
            if len(_tensors(args)) == 2:
                o = outs[0]
                self._products[id(o)] = weakref.ref(
                    o, lambda _, k=id(o): self._products.pop(k, None))
        elif func in _SUMS and self._is_product(args[0]):
            # a multiply and an add per term of the product
            self._add_flops(2 * args[0].numel(), _peak_name(args[0].dtype))
        nbytes = self._op_bytes(func, args, kwargs, outs)
        self.t.hbm_bytes += nbytes
        if self.profile and nbytes:
            self._mem_by[f"{_caller()}:{packet.__name__}"] += nbytes

    @staticmethod
    def _op_bytes(func, args, kwargs, outs) -> int:
        schema = func._schema
        first = schema.arguments[0].alias_info if schema.arguments else None
        ins = _tensors(args) + _tensors(list(kwargs.values()))
        if func.overloadpacket.__name__ in _GATHERS:
            return (sum(tensor_bytes(t) for t in ins[1:])
                    + 2 * sum(tensor_bytes(t) for t in outs))
        if first is not None and first.is_write:       # in place
            self_, rest = ins[0], ins[1:]
            name = func.overloadpacket.__name__
            if name in _INDEXED_WRITES:
                vals = rest[-1] if rest else self_
                return sum(tensor_bytes(t) for t in rest) + tensor_bytes(vals)
            if name == "copy_":
                return sum(tensor_bytes(t) for t in rest) + tensor_bytes(self_)
            return sum(tensor_bytes(t) for t in ins) + tensor_bytes(self_)
        return (sum(tensor_bytes(t) for t in ins)
                + sum(tensor_bytes(t) for t in outs))

    # -- results --------------------------------------------------------

    def totals(self) -> Totals:
        return self.t

    def attribute(self, top_k: int = 12) -> dict:
        """The top ``top_k`` labels ("module.function:op") by HBM bytes
        and by collective bytes (``profile=True`` runs only)."""
        def top(d):
            return sorted(d.items(), key=lambda kv: -kv[1])[:top_k]
        return {"memory": top(self._mem_by), "collective": top(self._coll_by)}


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree`` (a stacked tree's
    views share one)."""
    seen = {}
    for t in _leaves(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _leaves(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def roofline_terms(totals: Totals,
                   model_flops_per_device: float = 0.0) -> dict:
    """Three roofline terms in seconds, per rank, on the H100 SXM's
    datasheet constants (modeled, not measured): compute = each type's
    operations over its peak, memory = HBM bytes over HBM3's rate,
    collective = the bytes of groups within a node over NVLink and of
    groups across nodes over InfiniBand. The dominant term is the bound;
    with ``model_flops_per_device`` also the useful share of the
    operations and its time at the bf16 peak over the bound."""
    t_compute = sum(n / _PEAKS[k] for k, n in totals.flops_by_type.items())
    t_memory = totals.hbm_bytes / W.HBM_BYTES_PER_S
    links = totals.link_bytes
    t_coll = (links.get("node", 0.0) / W.NVLINK_BYTES_PER_S
              + links.get("network", 0.0) / W.IB_BYTES_PER_S)
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    out = {
        "flops": totals.flops,
        "flops_by_type": dict(totals.flops_by_type),
        "hbm_bytes": totals.hbm_bytes,
        "kernels": dict(sorted(totals.kernels.items())),
        "collective_bytes": totals.collective_bytes,
        "collective_by_kind": dict(totals.collective_by_kind),
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "bound_s": max(t_compute, t_memory, t_coll),
    }
    if model_flops_per_device:
        out["model_flops_per_device"] = model_flops_per_device
        out["useful_flop_ratio"] = model_flops_per_device / max(
            totals.flops, 1)
    return out

