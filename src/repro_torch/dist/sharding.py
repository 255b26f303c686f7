"""Logical-axis sharding: model-side specs resolved to mesh axes, and the
local shards of a tree.

PyTorch-port counterpart of ``repro/dist/sharding.py``. Model code
annotates every parameter and cache leaf with a :class:`Spec` of LOGICAL
axis names ("dp", "fsdp", "tp", "sp"), one entry per tensor dim; this
module resolves them against a mesh's PHYSICAL axes ("pod", "data",
"model") through a rules dict, with a process-global override table for
launch-time experiments. Resolution runs the reference's chain
(:func:`resolve_spec`, :func:`_dedup_axes`, :func:`_drop_missing`) and is
idempotent: physical names and ``None`` pass through.

A mesh here is anything with ``mesh_dim_names`` (a ``DeviceMesh``) or
``axis_names``; :func:`shard_tree` also reads its ``shape`` and, unless a
coordinate is given, ``get_coordinate()``. A tensor dim over several mesh
axes is split into their product of equal pieces, the first axis
outermost (the reference's layout); a dim the pieces do not divide
raises. The reference's ``constraint`` (a GSPMD hint inside traced code)
has no counterpart: the port's explicit collectives
(:mod:`repro_torch.dist.parallel`) place every activation themselves.
"""
from __future__ import annotations

from typing import Any, NamedTuple

from torch.distributed.tensor import Replicate, Shard

_OVERRIDES: dict = {}


class Spec(tuple):
    """A logical spec: one entry per tensor dim, each a logical or
    physical axis name, ``None`` (replicated), or a tuple of names.
    ``Spec("fsdp", "tp")`` is the reference's ``PartitionSpec("fsdp",
    "tp")``, and equal to it as a tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def is_spec(x) -> bool:
    return isinstance(x, Spec)


class NamedSharding(NamedTuple):
    """A leaf's placement: its logical spec on a mesh (the reference's
    ``jax.sharding.NamedSharding``; ``ckpt`` restores and saves by it)."""
    mesh: Any
    spec: Spec


def named_tree(specs, mesh):
    """A spec tree -> the matching tree of :class:`NamedSharding`."""
    if is_spec(specs):
        return NamedSharding(mesh, specs)
    return {k: named_tree(v, mesh) for k, v in specs.items()}


def set_rule_overrides(overrides: dict) -> None:
    """Install launch-time overrides: logical name -> physical axis spec.
    ``()`` drops the axis (resolves to None); a str or tuple of physical
    axes aliases it. Pass ``{}`` to clear."""
    _OVERRIDES.clear()
    _OVERRIDES.update(overrides)


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def rules_for_mesh(mesh) -> dict:
    """Default logical->physical rules for a mesh's axis names: dp/fsdp
    to the data axes (("pod", "data") on a multi-pod mesh), tp/sp to
    "model"."""
    names = axis_names(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    data = data_axes if len(data_axes) > 1 else (data_axes[0] if data_axes
                                                 else None)
    model = "model" if "model" in names else None
    rules = {}
    for ax in ("dp", "fsdp"):
        if data is not None:
            rules[ax] = data
    for ax in ("tp", "sp"):
        if model is not None:
            rules[ax] = model
    return rules


def _resolve_entry(entry, rules):
    if entry is None:
        return None
    if isinstance(entry, str) and entry in _OVERRIDES:
        o = _OVERRIDES[entry]
        if o == () or o is None:
            return None
        return tuple(o) if isinstance(o, (tuple, list)) else o
    if isinstance(entry, str) and entry in rules:
        r = rules[entry]
        return tuple(r) if isinstance(r, (tuple, list)) else r
    return tuple(entry) if isinstance(entry, (tuple, list)) else entry


def resolve_spec(spec, rules: dict) -> Spec:
    """Map every logical entry of ``spec`` through overrides then rules."""
    return Spec(*(_resolve_entry(e, rules) for e in spec))


def _dedup_axes(spec) -> Spec:
    """Drop mesh axes already claimed by an earlier entry (each mesh axis
    shards at most one dim)."""
    used: set = set()
    out = []
    for e in spec:
        if e is None:
            out.append(None)
        elif isinstance(e, tuple):
            kept = tuple(a for a in e if a not in used)
            used.update(kept)
            out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        else:
            out.append(None if e in used else e)
            used.add(e)
    return Spec(*out)


def _drop_missing(spec, mesh) -> Spec:
    names = set(axis_names(mesh))
    out = []
    for e in spec:
        if isinstance(e, tuple):
            kept = tuple(a for a in e if a in names)
            out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        else:
            out.append(e if e in names else None)
    return Spec(*out)


def resolve(spec, mesh) -> Spec:
    """``spec``'s physical entries on ``mesh``: rules and overrides, then
    each mesh axis once, then axes the mesh lacks dropped."""
    return _drop_missing(_dedup_axes(resolve_spec(spec, rules_for_mesh(mesh))),
                         mesh)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def sharded_axes(spec, mesh) -> frozenset:
    """The mesh axes that split some dim of a leaf placed by ``spec``."""
    return frozenset(a for e in resolve(spec, mesh) for a in _axes(e))


def placements(spec, mesh) -> tuple:
    """The resolved ``spec`` as ``torch.distributed.tensor`` placements,
    one per mesh dim: ``Shard(d)`` where the mesh axis splits tensor dim
    d, else ``Replicate()``."""
    resolved = resolve(spec, mesh)
    out = [Replicate()] * len(axis_names(mesh))
    for d, e in enumerate(resolved):
        for a in _axes(e):
            out[axis_names(mesh).index(a)] = Shard(d)
    return tuple(out)


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its parallel spec tree."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def resolve_tree(specs, mesh):
    """Every logical spec of a tree -> its :func:`placements` on
    ``mesh``."""
    if is_spec(specs):
        return placements(specs, mesh)
    return {k: resolve_tree(v, mesh) for k, v in specs.items()}


def _mesh_shape(mesh) -> tuple:
    return tuple(int(n) for n in mesh.shape)


def local_slices(shape, spec, mesh, coord=None) -> tuple:
    """The index of this rank's shard of a tensor of ``shape`` placed by
    ``spec``: one slice per dim. ``coord``: the rank's mesh coordinate
    (``mesh.get_coordinate()`` when None)."""
    names, sizes = axis_names(mesh), _mesh_shape(mesh)
    if coord is None:
        coord = mesh.get_coordinate()
    out = []
    resolved = resolve(spec, mesh)
    if len(resolved) != len(shape):
        raise ValueError(f"spec {tuple(spec)} has {len(resolved)} entries "
                         f"for a tensor of shape {tuple(shape)}")
    for d, e in enumerate(resolved):
        idx, count = 0, 1
        for a in _axes(e):
            i = names.index(a)
            idx, count = idx * sizes[i] + coord[i], count * sizes[i]
        if shape[d] % count:
            raise ValueError(f"dim {d} of shape {tuple(shape)} does not "
                             f"split into {count} equal shards ({e})")
        n = shape[d] // count
        out.append(slice(idx * n, (idx + 1) * n))
    return tuple(out)


def shard_leaf(t, spec, mesh, coord=None):
    """This rank's shard of ``t`` (a contiguous copy; ``t`` itself where
    the spec replicates it on ``mesh``)."""
    sl = local_slices(t.shape, spec, mesh, coord)
    if all(s.start == 0 and s.stop == n for s, n in zip(sl, t.shape)):
        return t
    return t[sl].contiguous()


def shard_tree(tree, specs, mesh, coord=None):
    """This rank's shard of every leaf of ``tree`` by its logical spec."""
    return map_specs(lambda t, s: shard_leaf(t, s, mesh, coord), tree, specs)


def gather_leaf(t, spec, mesh):
    """The whole tensor of which ``t`` is this rank's shard: all-gathers
    over each axis that splits a dim, innermost axis first."""
    from repro_torch.dist.parallel import Comm
    comm = Comm()
    for d, e in enumerate(resolve(spec, mesh)):
        for a in reversed(_axes(e)):
            t = comm.all_gather(t, d, mesh.get_group(a))
    return t


def gather_tree(tree, specs, mesh):
    """Whole leaves from every rank's shards (for checks and saves); every
    rank of the mesh takes part and gets the whole tree."""
    return map_specs(lambda t, s: gather_leaf(t, s, mesh), tree, specs)
