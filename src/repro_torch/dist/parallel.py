"""The collectives of a mesh, and the sharded Loom linear, exact by
construction on the integer routes.

A :class:`ShardCtx` is what a meshed session passes down the model: the
mesh, the groups of its logical axes (by default "dp" and "fsdp" over
"data", "tp" and "sp" over "model"; below, "model" is the "tp" group and
"data" the "dp" or "fsdp" one), this rank's place in them, and a
:class:`Comm` that runs every collective. :meth:`ShardCtx.lin` gives the
:class:`LinearShard` of one projection from the logical axes of its dense
weight, the same (in, out) pair its spec carries:

* out on "tp" (**column-parallel**): the rank's N/tp columns, no
  collective; K1 / K3 run at the column-shard shape.
* in on "tp" (**row-parallel**): the rank's K/tp rows. The activations
  take the whole row's scale (a row absmax, all-reduced with MAX where the
  input arrives already split), each rank quantizes its K-slice, the
  integer product runs on the local rows, and the int32 partial products
  are summed over "model" before the dequantizing cast: all-reduced, or
  reduce-scattered where the rank keeps only its own columns (K and V,
  whose cache is placed by heads). Integer sums
  associate, wrap-around included, so the result is the unsharded one bit
  for bit. ``dynamic_a`` counts each slice's activation planes (never
  more than the whole row's; trimming drops only all-zero planes), so it
  stays exact too. ``dense`` sums float partial products and is held by
  tolerance only.
* "fsdp" dims (over "data") are stored split and all-gathered at every
  use, as GSPMD does for the reference.

Training runs the same placements through autograd: each
collective of a float route is a ``torch.autograd.Function`` whose
backward is the collective's transpose. An activation that every "model"
rank holds whole and that enters rank-local work (a column-parallel or
K-sliced linear, the expert slots, the SSM's local heads) passes
:meth:`~ShardCtx.copy_to` (identity; its gradient, partial on each rank, SUM-reduced
over "model"); a row-parallel output is :meth:`~ShardCtx.reduce_from`
(SUM; identity backward) or :meth:`~ShardCtx.scatter_from`
(reduce-scatter; all-gather backward); an "fsdp" weight
:meth:`~ShardCtx.gather_weight` (all-gather; its gradient reduce-scattered
over "data"); an activation gathered whole for replicated work
:meth:`~ShardCtx.gather` (all-gather; the rank's slice of the gradient).
The ``fake_quant`` route takes the whole tensor's absmax: MAX over "data"
(the rows) and over "model" where the input or the weight is split there.

Collectives call ``torch.distributed`` directly on the rank's tensors,
on NCCL and gloo alike: gloo takes every kind used here on CUDA tensors
(it moves them through host memory itself), and a kind it ever refused
would raise.
"""
from __future__ import annotations

import collections
import dataclasses

import torch
import torch.distributed as dist
from torch.distributed import ReduceOp

from repro_torch.api import plan as planlib
from repro_torch.core import quantize as q
from repro_torch.dist import sharding
from repro_torch.kernels import ops
from repro_torch.kernels.work import NODE_CARDS
from repro_torch.models.layers import fake_quant_operands

_OPS = {"sum": ReduceOp.SUM, "max": ReduceOp.MAX}


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


class Comm:
    """Collectives over a mesh's groups. ``calls``: how many of each kind
    (op, dtype, reduction) ran; ``bytes``: the bytes each kind's calls
    handed in (this rank's tensors); ``link_bytes``: the same bytes by
    the link their group spans, ``"node"`` (ranks of one node of
    ``NODE_CARDS``, numbered node by node) or ``"network"``."""

    def __init__(self):
        self.calls = collections.Counter()
        self.bytes = collections.Counter()
        self.link_bytes = collections.Counter()
        self._links = {}

    def _link(self, group) -> str:
        key = id(group)
        if key not in self._links:
            nodes = {r // NODE_CARDS
                     for r in dist.get_process_group_ranks(group)}
            self._links[key] = "node" if len(nodes) == 1 else "network"
        return self._links[key]

    def _count(self, kind: tuple, t: torch.Tensor, group) -> None:
        n = t.numel() * t.element_size()
        self.calls[kind] += 1
        self.bytes[kind] += n
        self.link_bytes[self._link(group)] += n

    def all_reduce(self, t: torch.Tensor, red: str, group) -> torch.Tensor:
        """``t`` reduced (``"sum"`` or ``"max"``) over ``group``."""
        if _size(group) == 1:
            return t
        self._count(("all_reduce", t.dtype, red), t, group)
        t = t.contiguous()
        dist.all_reduce(t, op=_OPS[red], group=group)
        return t

    def reduce_scatter(self, t: torch.Tensor, group,
                       dim: int = -1) -> torch.Tensor:
        """The SUM over ``group`` of ``t``, of which this rank gets its
        group rank's 1/size of dim ``dim`` (the last: columns)."""
        n = _size(group)
        if n == 1:
            return t
        if t.shape[dim] % n:
            raise ValueError(f"{t.shape[dim]} columns do not split over {n} "
                             f"ranks")
        self._count(("reduce_scatter", t.dtype, "sum"), t, group)
        parts = [c.contiguous() for c in t.chunk(n, dim=dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, op=ReduceOp.SUM, group=group)
        return out

    def all_gather(self, t: torch.Tensor, dim: int, group) -> torch.Tensor:
        """Every rank's ``t`` of ``group``, concatenated along ``dim`` in
        group-rank order (moved as bytes, so any dtype)."""
        n = _size(group)
        if n == 1:
            return t
        b = t.contiguous().reshape(-1).view(torch.uint8)
        self._count(("all_gather", torch.uint8, None), b, group)
        parts = [torch.empty_like(b) for _ in range(n)]
        dist.all_gather(parts, b, group=group)
        return torch.cat([p.view(t.dtype).reshape(t.shape) for p in parts],
                         dim=dim)

    def sum_one_hot(self, t: torch.Tensor, group) -> torch.Tensor:
        """The sum over ``group`` of tensors that are nonzero on at most one
        rank per element, bit for bit (the bits ride an int32 SUM, so even
        a -0.0 survives)."""
        if _size(group) == 1:
            return t
        width = {2: torch.int16, 4: torch.int32}[t.element_size()]
        bits = t.contiguous().view(width).to(torch.int32)
        bits = self.all_reduce(bits, "sum", group)
        return bits.to(width).view(t.dtype)


# ---------------------------------------------------------------------------
# Collectives that carry a gradient (training on a mesh). Each is the
# identity on a group of one rank, so a (1, 1) mesh runs the unsharded
# arithmetic.
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm, group):
        ctx.comm, ctx.group = comm, group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g.clone(), "sum", ctx.group), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm, group):
        return comm.all_reduce(t.clone(), "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ScatterFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm, group):
        ctx.comm, ctx.group = comm, group
        return comm.reduce_scatter(t, group)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather(g, -1, ctx.group), None, None


class _GatherActs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, comm, group):
        ctx.dim, ctx.n = dim, t.shape[dim]
        ctx.rank = dist.get_rank(group)
        return comm.all_gather(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None


class _GatherWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, comm, group):
        ctx.dim, ctx.comm, ctx.group = dim, comm, group
        return comm.all_gather(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return (ctx.comm.reduce_scatter(g, ctx.group, ctx.dim), None, None,
                None)


class _SumOneHot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm, group):
        return comm.sum_one_hot(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class ShardCtx:
    """One rank's view of a mesh for serving and training: the groups of
    the logical axes, this rank's place in them, and its :class:`Comm`.

    Each logical axis ("dp" the batch rows, "fsdp" the split weight dims,
    "tp" the heads, columns and experts, "sp" the KV cache's sequence)
    resolves through the mesh's rules and :func:`sharding.set_rule_overrides`
    to a group: one mesh axis, the flattened product of several (in mesh
    order, the first outermost), or none. The ("data", "model") mesh takes
    dp/fsdp on "data" and tp/sp on "model"; the ("pod", "data", "model")
    mesh dp/fsdp on ("pod", "data"). A mesh axis that "tp" or "sp" claims
    does not split the rows ("dp"): the rows are whole within every group
    that sums or combines them (``serve_2d_tp``'s tp = ("data", "model")
    serves every row on every rank). Every method that takes an axis takes
    a logical name or a mesh axis name."""

    ROLES = ("dp", "fsdp", "tp", "sp")

    def __init__(self, mesh):
        names = sharding.axis_names(mesh)
        self.mesh = mesh
        self.comm = Comm()
        if mesh.device_type != "cuda":
            self.device = torch.device("cpu")
        elif torch.cuda.is_available():
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:                       # a fake world traced on the host
            self.device = torch.device("cuda")
        self._names = names
        self._mesh_size = {a: mesh.size(i) for i, a in enumerate(names)}
        self._mesh_rank = {a: mesh.get_local_rank(a) for a in names}
        axes = {r: sharding._axes(sharding.resolve(sharding.Spec(r), mesh)[0])
                for r in self.ROLES}
        claimed = set(axes["tp"]) | set(axes["sp"])
        axes["dp"] = tuple(a for a in axes["dp"] if a not in claimed)
        if set(axes["fsdp"]) & set(axes["tp"]):
            raise NotImplementedError(
                f"'fsdp' on {axes['fsdp']} and 'tp' on {axes['tp']} share a "
                f"mesh axis")
        self._role_axes = axes
        self._groups = {}
        for r in self.ROLES:         # made in one order on every rank
            self.group(r)

    def axes(self, name) -> tuple:
        """The mesh axes of a logical axis (after the rules, overrides and
        the rows' rule above), or of a mesh axis name itself."""
        if name in self._role_axes:
            return self._role_axes[name]
        if name not in self._mesh_size:
            raise KeyError(f"{name!r} is neither a logical axis nor an axis "
                           f"of the mesh {self._names}")
        return (name,)

    def _ordered(self, names) -> tuple:
        want = {a for n in names for a in self.axes(n)}
        return tuple(a for a in self._names if a in want)

    def rank(self, axis: str = "tp") -> int:
        """This rank's index in ``axis``'s group (row-major over its mesh
        axes)."""
        idx = 0
        for a in self.axes(axis):
            idx = idx * self._mesh_size[a] + self._mesh_rank[a]
        return idx

    def size(self, axis: str = "tp") -> int:
        n = 1
        for a in self.axes(axis):
            n *= self._mesh_size[a]
        return n

    def group(self, axis: str = "tp"):
        """The group of ``axis``: None for no mesh axis."""
        return self.group_over(self.axes(axis))

    def group_over(self, axes) -> object:
        """The group of the ranks that differ only along ``axes`` (names of
        logical or mesh axes): None for none, the world for every mesh
        axis, a flattened sub-mesh's group for several (made once, on
        first use: every rank reaches it at the same point of the SPMD
        program)."""
        key = self._ordered(axes)
        if not key:
            return None
        if key not in self._groups:
            if key == self._names:
                self._groups[key] = dist.group.WORLD
            elif len(key) == 1:
                self._groups[key] = self.mesh.get_group(key[0])
            else:
                sub = self.mesh[key]._flatten("_".join(key))
                self._groups[key] = sub.get_group()
        return self._groups[key]

    def local(self, n: int, axis: str = "tp") -> int:
        """n / the axis size; raises where it does not divide."""
        size = self.size(axis)
        if n % size:
            raise ValueError(f"{n} does not split over {size} {axis!r} "
                             f"ranks")
        return n // size

    def take(self, t: torch.Tensor, dim: int,
             axis: str = "tp") -> torch.Tensor:
        """This rank's piece of a whole (replicated) ``t`` along ``dim``."""
        n = self.local(t.shape[dim], axis)
        return t.narrow(dim, self.rank(axis) * n, n)

    # The collectives that carry a gradient (module docstring); each is
    # the identity over a group of one rank.

    def _apply(self, fn, t: torch.Tensor, axis: str, *args) -> torch.Tensor:
        group = self.group(axis)
        return t if _size(group) == 1 else fn.apply(t, *args, self.comm,
                                                    group)

    def gather(self, t: torch.Tensor, dim: int,
               axis: str = "tp") -> torch.Tensor:
        """Every rank's ``t`` of ``axis`` concatenated along ``dim``, for
        work that every rank then does alike; the gradient (the same on
        every rank) gives each rank its own slice."""
        return self._apply(_GatherActs, t, axis, dim)

    def gather_weight(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """An "fsdp" weight all-gathered along ``dim`` for one use; its
        gradient, from each rank's own rows, is SUM-reduced and each rank
        keeps its slice (reduce-scatter)."""
        return self._apply(_GatherWeight, t, "fsdp", dim)

    def copy_to(self, t: torch.Tensor) -> torch.Tensor:
        """A tensor every "tp" rank holds whole, entering work local to
        each rank (e.g. qwen3's ``qk_norm`` gains on this rank's heads):
        the identity, its gradient, partial on each rank, SUM-reduced."""
        return self._apply(_CopyTo, t, "tp")

    def reduce_from(self, t: torch.Tensor,
                    axis: str = "tp") -> torch.Tensor:
        """The SUM over ``axis`` of the ranks' partial ``t``; the gradient
        passes to each rank unchanged."""
        return self._apply(_ReduceFrom, t, axis)

    def scatter_from(self, t: torch.Tensor) -> torch.Tensor:
        """:meth:`Comm.reduce_scatter` over "tp" along the last dim;
        the gradient is all-gathered."""
        return self._apply(_ScatterFrom, t, "tp")

    def sum_one_hot(self, t: torch.Tensor) -> torch.Tensor:
        """:meth:`Comm.sum_one_hot` over "tp"; the gradient passes
        unchanged."""
        return self._apply(_SumOneHot, t, "tp")

    def mean_over_data(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over "dp" of a statistic of this rank's rows (equal
        row counts): a SUM of ``t / size``, the gradient unchanged, so
        each rank's backward carries its 1/size share of the global
        mean's gradient."""
        n = self.size("dp")
        return t if n == 1 else self.reduce_from(t / n, "dp")

    def max_over(self, axes):
        """MAX over the ranks that differ along ``axes`` (float32), or
        None where that is no rank but this one."""
        axes = {a for a in self._ordered(axes) if self._mesh_size[a] > 1}
        if not axes:
            return None
        group = self.group_over(axes)
        return lambda m: self.comm.all_reduce(
            m.to(torch.float32).contiguous(), "max", group)

    def lin(self, in_axis, out_axis, x_local: bool = False,
            scatter: bool = False) -> "LinearShard":
        """The shard of a projection whose dense weight has the logical
        axes (``in_axis``, ``out_axis``). ``x_local``: a row-parallel
        input arrives split over "tp" already (else it is whole, and the
        rank takes its K-slice). ``scatter``: a row-parallel output is
        reduce-scattered, each rank getting its N/tp columns (else
        all-reduced whole)."""
        k_ax, n_ax = sharding.resolve(sharding.Spec(in_axis, out_axis),
                                      self.mesh)
        return LinearShard(self, self.role_of(k_ax), self.role_of(n_ax),
                           x_local, scatter)

    def role_of(self, entry) -> str | None:
        """The role of a resolved spec entry: "tp" (parallel), "fsdp"
        (split, gathered at use) or None (replicated)."""
        axes = sharding._axes(entry)
        if not axes:
            return None
        for role in ("tp", "fsdp"):
            if axes == self.axes(role):
                return role
        raise NotImplementedError(
            f"a weight dim on {axes}: sharded execution takes 'tp' on "
            f"{self.axes('tp')} and 'fsdp' on {self.axes('fsdp')}")

    def place(self, specs):
        """A spec tree with every "dp" entry replaced by the rows' mesh
        axes of this context (see the class docstring), for
        ``sharding.shard_tree``; other entries resolve as they are."""
        if sharding.is_spec(specs):
            dp = self.axes("dp")
            return sharding.Spec(*((dp if len(dp) > 1 else (dp[0] if dp
                                                             else None))
                                   if e == "dp" else e for e in specs))
        return {k: self.place(v) for k, v in specs.items()}

    def absmax_reducer(self, spec, dims):
        """MAX over the ranks holding pieces of the same block of a leaf
        placed by ``spec``, where the absmax was taken over ``dims``."""
        resolved = sharding.resolve(spec, self.mesh)
        return self.max_over(a for d in dims for a in sharding._axes(
            resolved[d]))


# Weight leaves of a linear by layout; each keeps K at dim -2, N at -1.
_WEIGHT_KEYS = ("w", "wq", "w_packed")


@dataclasses.dataclass(frozen=True)
class LinearShard:
    ctx: ShardCtx
    k_axis: str | None       # role splitting K (in): "tp", "fsdp", None
    n_axis: str | None       # role splitting N (out)
    x_local: bool = False
    scatter: bool = False

    @property
    def row(self) -> bool:
        return self.k_axis == "tp"

    @property
    def local(self) -> bool:
        """The rank's product differs from the other "tp" ranks'."""
        return "tp" in (self.k_axis, self.n_axis)

    def weights(self, p: dict) -> dict:
        """``p`` with its "fsdp"-split dims all-gathered."""
        out = dict(p)
        for key in _WEIGHT_KEYS:
            if key in out:
                if self.k_axis == "fsdp":
                    out[key] = self.ctx.gather_weight(out[key], -2)
                if self.n_axis == "fsdp":
                    out[key] = self.ctx.gather_weight(out[key], -1)
        return out

    def apply(self, route_fn, p: dict, x: torch.Tensor, lp, backend):
        """The linear of this shard: ``route_fn`` (the unsharded route) on
        the local columns, or the row-parallel product; ``fake_quant``
        under the whole tensors' scales (:meth:`fake_quant`)."""
        p = self.weights(p)
        if self.local and not self.x_local:
            x = self.ctx.copy_to(x)
        if lp.route == planlib.FAKE_QUANT:
            return self.fake_quant(p, x, lp)
        if not self.row:
            return route_fn(p, x, lp, backend)
        if x.ndim > 3:
            raise NotImplementedError("row-parallel linears take token-"
                                      "shaped input ([B, D] or [B, S, D])")
        absmax = x.abs().amax(-1, keepdim=True).to(torch.float32)
        if self.x_local:
            absmax = self.ctx.comm.all_reduce(absmax, "max",
                                              self.ctx.group("tp"))
        else:
            x = self.ctx.take(x, -1)
        return _ROW_ROUTES[lp.route](self, p, x, absmax, lp, backend)

    def fake_quant(self, p: dict, x: torch.Tensor, lp) -> torch.Tensor:
        """The ``fake_quant`` route (QAT) on this shard: x and the weight
        fake-quantized under the whole tensors' absmax, as the unsharded
        route takes them (MAX over "data", the rows, and over "model"
        where x arrives K-sliced or the weight is split), then the float
        product: the local columns, or the K-slice's partial product
        summed over "model" in float32."""
        ctx = self.ctx
        xq, wq = fake_quant_operands(
            p, x, lp,
            ctx.max_over(("dp", "tp") if self.x_local else ("dp",)),
            ctx.max_over(("tp",) if self.local else ()))
        if not self.row:
            return xq @ wq
        if not self.x_local:
            xq = ctx.take(xq, -1)
        return self.sum((xq @ wq).to(torch.float32)).to(x.dtype)

    def sum(self, y: torch.Tensor) -> torch.Tensor:
        """The SUM over "model" of the ranks' partial products: the rank's
        columns with ``scatter``, else the whole. A float sum carries its
        gradient (:func:`reduce_from` / :func:`scatter_from`)."""
        comm, group = self.ctx.comm, self.ctx.group("tp")
        if y.is_floating_point():
            return self.ctx.scatter_from(y) if self.scatter \
                else self.ctx.reduce_from(y)
        if self.scatter:
            return comm.reduce_scatter(y, group)
        return comm.all_reduce(y, "sum", group)


def _row_packed(ls, p, x, absmax, lp, be):
    wp = p["w_packed"]
    if x.shape[-1] != wp.shape[1] * 8:
        raise ValueError(f"a row-parallel packed shard needs K/tp a "
                         f"multiple of 8 (one packed byte row); the rank "
                         f"holds {wp.shape[1]} byte rows for {x.shape[-1]} "
                         f"inputs")
    scale = q.scale_from_absmax(absmax, min(lp.a_bits, 8)).reshape(-1, 1)
    kw = dict(a_bits=lp.a_bits, w_bits=wp.shape[0], backend=be,
              w_counts=lp.w_group_counts, w_group=lp.w_group, a_axis=-1,
              x_scale=scale, int_sum=ls.sum)
    if lp.dynamic_a:
        return ops.loom_linear_serve_dynamic(x, wp, p["w_scale"],
                                             group_size=lp.group_size, **kw)
    return ops.loom_linear_serve(x, wp, p["w_scale"], **kw)


def _row_int8(ls, p, x, absmax, lp, be):
    bits = min(lp.a_bits, 8)
    xq, x_scale = q.quantize(x.to(torch.float32), bits,
                             scale=q.scale_from_absmax(absmax, bits))
    y = ls.sum(ops.int8_matmul(xq.to(torch.int8), p["wq"]))
    return (y.to(torch.float32) * (x_scale * p["w_scale"])).to(x.dtype)


def _row_dense(ls, p, x, absmax, lp, be):
    return ls.sum((x @ p["w"].to(x.dtype)).to(torch.float32)).to(x.dtype)


# The row-parallel routes (``fake_quant``: LinearShard.fake_quant).
_ROW_ROUTES = {planlib.PACKED: _row_packed, planlib.INT8: _row_int8,
               planlib.DENSE: _row_dense}


def lin(shard: ShardCtx | None, in_axis, out_axis, x_local: bool = False,
        scatter: bool = False) -> LinearShard | None:
    """:meth:`ShardCtx.lin`, or None without a mesh."""
    return None if shard is None else shard.lin(in_axis, out_axis, x_local,
                                                scatter)
