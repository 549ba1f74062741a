"""Sharding context: a thin registry the model layers consult.

Layers never import mesh machinery directly; the code that builds a
step installs a :class:`ShardCtx` and layers call :func:`constrain` with
logical names.  Without a context everything is a no-op, as in ``repro``,
so the same model code runs on one device and on a mesh.

A port of ``repro.distributed.context`` over ``torch.distributed.tensor``.
A mesh is a ``DeviceMesh`` with named dimensions (``launch.mesh``); a spec
is this module's :class:`PartitionSpec`, ``jax.sharding.PartitionSpec``'s
counterpart, and :class:`NamedSharding` turns one into DTensor placements
on a mesh.  Under a context the model's tensors are ``DTensor``s:
:func:`constrain` redistributes one to the named spec's placements (JAX's
``with_sharding_constraint``), and :func:`shard_map` runs a function on
each rank's local shards.  DTensor chooses the collectives of a
redistribution itself; they need not be the ones XLA's partitioner picks,
but the values are the same up to the order of float sums.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.analysis import locks

_STATE = threading.local()

# DTensor's implicit replication is one process-wide flag, and its context
# manager clears it on exit on some torch releases (2.11) rather than
# restoring it: the outermost installed context turns it on, the last one
# out turns it off, whichever thread (autograd's backward thread
# recomputes remat blocks under the forward's context).
_replication_lock = locks.make_lock("shard-context")
_replication = {"depth": 0, "cm": None}


class PartitionSpec(tuple):
    """Per tensor dim: a mesh axis name, a tuple of names (the first the
    major one), or ``None`` (replicated).  A one-name tuple reads as the
    name, as ``jax.sharding.PartitionSpec`` normalises it; trailing dims
    left out are replicated."""

    def __new__(cls, *parts):
        norm = []
        for p in parts:
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                if len(p) == 1:
                    p = p[0]
                elif not p:
                    p = None
            norm.append(p)
        return super().__new__(cls, norm)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"

    def axes(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes that shard tensor dim ``dim`` (none past the
        spec's end)."""
        if dim >= len(self) or self[dim] is None:
            return ()
        p = self[dim]
        return p if isinstance(p, tuple) else (p,)


P = PartitionSpec


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a plain mapping of
    axis name to size (what the spec functions read of a mesh, so that
    they run at the production sizes without a world of that size)."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh's dimensions have no names")
    return dict(zip(names, (int(s) for s in mesh.mesh.shape)))


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(axis_sizes(mesh))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh``: ``jax.sharding.NamedSharding``'s
    counterpart.  :meth:`placements` gives the DTensor placements, one a
    mesh dimension."""

    mesh: Any
    spec: PartitionSpec

    def placements(self, ndim: Optional[int] = None):
        return placements(self.spec, self.mesh, ndim)

    def distribute(self, tensor: torch.Tensor):
        """``tensor`` (the full value, on every rank) as a ``DTensor`` laid
        out by the spec (``jax.device_put``)."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(tensor, self.mesh,
                                 self.placements(tensor.ndim))


def placements(spec: PartitionSpec, mesh, ndim: Optional[int] = None):
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that shards tensor dim ``d``, else ``Replicate()``.  The
    names of one tensor dim must follow the mesh's order (major first),
    as DTensor shards a dim over mesh dims left to right."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    if ndim is not None and len(spec) > ndim:
        raise ValueError(f"{spec!r} has {len(spec)} entries for a "
                         f"{ndim}-d tensor")
    out = [Replicate()] * len(names)
    for d in range(len(spec)):
        axes = spec.axes(d)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec!r}: the axes of dim {d} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec!r} uses axis {names[i]!r} twice")
            out[i] = Shard(d)
    return tuple(out)


def spec_of(pl: Sequence, mesh, ndim: int) -> PartitionSpec:
    """The spec whose :func:`placements` on ``mesh`` are ``pl``
    (``Shard`` and ``Replicate`` only): a ``DTensor``'s layout as a
    spec."""
    names = axis_names(mesh)
    dims = [[] for _ in range(ndim)]
    for name, p in zip(names, pl):
        if p.is_shard():
            dims[p.dim].append(name)
        elif not p.is_replicate():
            raise ValueError(f"no spec for placement {p}")
    return PartitionSpec(*(tuple(d) if d else None for d in dims))


@dataclasses.dataclass
class ShardCtx:
    mesh: Any
    rules: Dict[str, PartitionSpec]
    # axis names used by the expert-parallel MoE path
    token_axes: tuple = ("pod", "data")
    expert_axis: str = "model"

    def spec(self, name: str) -> Optional[PartitionSpec]:
        return self.rules.get(name)


def current() -> Optional[ShardCtx]:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def use(ctx: Optional[ShardCtx]):
    """Install ``ctx`` for the block.  With a mesh installed, a plain
    tensor that meets a ``DTensor`` reads as replicated (DTensor's
    ``implicit_replication``): the positions, masks and constants the
    layers make are the same on every rank."""
    prev = current()
    _STATE.ctx = ctx
    try:
        if ctx is None:
            yield
        else:
            with _implicitly_replicated():
                yield
    finally:
        _STATE.ctx = prev


@contextlib.contextmanager
def _implicitly_replicated():
    from torch.distributed.tensor.experimental import implicit_replication
    with _replication_lock:
        if _replication["depth"] == 0:
            _replication["cm"] = implicit_replication()
            _replication["cm"].__enter__()
        _replication["depth"] += 1
    try:
        yield
    finally:
        with _replication_lock:
            _replication["depth"] -= 1
            if _replication["depth"] == 0:
                cm, _replication["cm"] = _replication["cm"], None
                cm.__exit__(None, None, None)


def as_dtensor(x: torch.Tensor, mesh):
    """``x`` as a ``DTensor`` on ``mesh``: itself if it is one, else the
    full value replicated (every rank holds it)."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def elementwise(fn, x):
    """``fn`` (elementwise) applied to ``x``; on a ``DTensor``, to each
    rank's local shard, the placements kept (a ``Partial`` one reduced
    first).  For the ops DTensor has no sharding rule for, forward or
    backward (``F.logsigmoid``'s backward)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(x, DTensor):
        return fn(x)
    pl = tuple(Replicate() if isinstance(p, Partial) else p
               for p in x.placements)
    x = x.redistribute(x.device_mesh, pl)
    y = fn(x.to_local())
    return DTensor.from_local(y, x.device_mesh, pl, run_check=False,
                              shape=x.shape, stride=x.stride())


def on_local(fn, x):
    """``fn`` applied to each rank's local shard of ``x``, the placements
    kept (a ``Partial`` one reduced first); for an ``fn`` that changes
    only dims no mesh axis cuts, such as a pad at the end of an unsharded
    dim (torch 2.11's DTensor fails to plan ``F.pad``'s redistribution on
    a mesh of two dims or more).  ``x`` need not be a ``DTensor``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(x, DTensor):
        return fn(x)
    pl = tuple(Replicate() if isinstance(p, Partial) else p
               for p in x.placements)
    x = x.redistribute(x.device_mesh, pl)
    y = fn(x.to_local())
    shape, stride = _global_shape(y, pl, x.device_mesh)
    return DTensor.from_local(y, x.device_mesh, pl, run_check=False,
                              shape=shape, stride=stride)


def replicated(x):
    """A replicated ``DTensor``'s value as a plain tensor (every rank
    holds it whole, so no collective runs); any other tensor as it is.
    Raises on a sharded or partial one."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    if not all(p.is_replicate() for p in x.placements):
        raise ValueError(f"not replicated: {x.placements}")
    return x.to_local()


def shard_map(f, *, mesh, in_specs, out_specs):
    """``jax.shard_map``: ``f`` runs on each rank's local shards of its
    arguments, laid out by ``in_specs``, and its local results are
    reassembled as ``DTensor``s by ``out_specs`` (a spec, or one per
    result).  Collectives inside ``f`` are the caller's, over the mesh's
    subgroups (``mesh.get_group(axis)``).

    Differentiable with JAX's transpose: a result's cotangent is divided
    by the size of each axis its spec does not name (every rank of that
    axis holds the whole result), and the gradient of an argument
    replicated over an axis its spec does not name is summed over that
    axis (each rank's local gradient is a partial).  JAX's replication
    check (``check_vma``) has no counterpart: a result is taken to be
    what its spec says."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    single_in = isinstance(in_specs, PartitionSpec)

    def fx(*args):
        specs = ((in_specs,) * len(args) if single_in else tuple(in_specs))
        if len(specs) != len(args):
            raise ValueError(f"{len(specs)} in_specs for {len(args)} "
                             f"arguments")
        local = []
        for a, spec in zip(args, specs):
            pl = placements(spec, mesh, a.ndim)
            d = as_dtensor(a, mesh).redistribute(mesh, pl)
            grad_pl = [Partial() if p == Replicate() else p for p in pl]
            local.append(d.to_local(grad_placements=grad_pl))
        out = f(*local)
        single_out = not isinstance(out, (tuple, list))
        outs = (out,) if single_out else tuple(out)
        ospecs = ((out_specs,) * len(outs)
                  if isinstance(out_specs, PartitionSpec)
                  else tuple(out_specs))
        res = []
        for o, spec in zip(outs, ospecs):
            pl = placements(spec, mesh, o.ndim)
            copies = 1
            for i, p in enumerate(pl):
                if p == Replicate():
                    copies *= mesh.size(i)
            if copies > 1 and o.requires_grad:
                o = _ScaleGrad.apply(o, 1.0 / copies)
            shape, stride = _global_shape(o, pl, mesh)
            res.append(DTensor.from_local(o, mesh, pl, run_check=False,
                                          shape=shape, stride=stride))
        return res[0] if single_out else tuple(res)

    return fx


class _ScaleGrad(torch.autograd.Function):
    """The identity, its gradient scaled by ``factor``."""

    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def _global_shape(local: torch.Tensor, pl: Sequence, mesh):
    """The global shape and contiguous stride of a result whose local
    shards are even (``shard_map`` splits every dim evenly)."""
    from torch.distributed.tensor import Shard
    shape = list(local.shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            shape[p.dim] *= mesh.size(i)
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return torch.Size(shape), tuple(stride)


# ---------------------------------------------------------------------------
# collectives over one mesh axis, for the body of a shard_map
# ---------------------------------------------------------------------------
#
# ``jax.lax``'s ``all_gather(tiled=True)``, ``all_to_all(tiled=True)``,
# ``psum`` and ``axis_index`` over a named axis of the installed context's
# mesh, on the subgroup ``mesh.get_group(axis)``.  Each is differentiable
# with JAX's transpose: all_gather's is the sum of the cotangents' slices
# (an all-reduce, then this rank's slice: gloo has no reduce-scatter),
# all_to_all's the reverse all_to_all, and psum's a psum (with
# ``shard_map`` dividing a replicated result's cotangent, the sum gives
# each partial the whole cotangent).

def _axis(axis_name: str):
    ctx = current()
    if ctx is None:
        raise RuntimeError(f"a collective over {axis_name!r} needs a mesh "
                           "context (dctx.use)")
    mesh = ctx.mesh
    return (mesh.get_group(axis_name), mesh.size(
        axis_names(mesh).index(axis_name)), mesh.get_local_rank(axis_name))


def axis_index(axis_name: str) -> int:
    """This rank's coordinate on ``axis_name`` (``jax.lax.axis_index``)."""
    return _axis(axis_name)[2]


def axis_size(axis_name: str) -> int:
    """The number of ranks on ``axis_name`` (``jax.lax.axis_size``)."""
    return _axis(axis_name)[1]


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, rank, dim):
        ctx.group, ctx.n, ctx.rank, ctx.dim = group, n, rank, dim
        parts = [torch.empty_like(x) for _ in range(n)]
        torch.distributed.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()     # all_reduce writes in place
        torch.distributed.all_reduce(g, group=ctx.group)
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.rank], None, None, None, None


def all_gather(x: torch.Tensor, axis_names_: Tuple[str, ...], axis: int):
    """``jax.lax.all_gather(x, axes, axis=axis, tiled=True)``: the shards
    of ``axes`` (at most one name; none is the identity) concatenated on
    ``axis`` in rank order."""
    if not axis_names_:
        return x
    if len(axis_names_) > 1:
        raise ValueError(f"all_gather over {axis_names_}: one axis at most")
    group, n, rank = _axis(axis_names_[0])
    if n == 1:
        return x
    return _AllGather.apply(x, group, n, rank, axis % x.ndim)


def _a2a(x: torch.Tensor, group, n: int, split: int, concat: int):
    """The tiled all-to-all: ``x`` cut in ``n`` on ``split``, piece j sent
    to rank j, the received pieces concatenated on ``concat`` in source
    rank order."""
    shape = list(x.shape)
    pieces = torch.stack(x.chunk(n, dim=split), dim=0).contiguous()
    out = torch.empty_like(pieces)
    torch.distributed.all_to_all_single(out, pieces, group=group)
    out = torch.unbind(out, dim=0)
    res = torch.cat(out, dim=concat)
    shape[split] //= n
    shape[concat] = shape[concat] * n if split != concat else shape[concat]
    return res.reshape(shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split, concat):
        ctx.group, ctx.n, ctx.split, ctx.concat = group, n, split, concat
        return _a2a(x, group, n, split, concat)

    @staticmethod
    def backward(ctx, g):
        return (_a2a(g, ctx.group, ctx.n, ctx.concat, ctx.split),
                None, None, None, None)


def all_to_all(x: torch.Tensor, axis_name: str, split_axis: int,
               concat_axis: int):
    """``jax.lax.all_to_all(x, axis_name, split_axis, concat_axis,
    tiled=True)``."""
    group, n, _ = _axis(axis_name)
    if n == 1:
        return x
    return _AllToAll.apply(x, group, n, split_axis % x.ndim,
                           concat_axis % x.ndim)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        torch.distributed.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        torch.distributed.all_reduce(g, group=ctx.group)
        return g, None


def psum(x: torch.Tensor, axis_name: str):
    """``jax.lax.psum(x, axis_name)``: the sum over the axis, on every rank
    of it."""
    group, n, _ = _axis(axis_name)
    if n == 1:
        return x
    return _PSum.apply(x, group)


def pmax(x: torch.Tensor, axis_name: str):
    """``jax.lax.pmax(x, axis_name)`` of a value that carries no gradient
    (a softmax's shift, which cancels): the maximum over the axis, on
    every rank of it."""
    group, n, _ = _axis(axis_name)
    y = x.detach()
    if n == 1:
        return y
    y = y.clone()
    torch.distributed.all_reduce(y, op=torch.distributed.ReduceOp.MAX,
                                 group=group)
    return y


def constrain(x, name: str):
    """Apply a named sharding constraint if a context is installed: ``x``
    redistributed to the placements of the context's spec for ``name``
    (a plain tensor is read as replicated first), or ``x`` unchanged
    where the context has no such rule."""
    ctx = current()
    if ctx is None:
        return x
    spec = ctx.spec(name)
    if spec is None:
        return x
    return constrain_spec(x, spec)


def constrain_spec(x, spec: PartitionSpec):
    """``x`` redistributed to ``spec`` on the installed context's mesh."""
    mesh = current().mesh
    return as_dtensor(x, mesh).redistribute(mesh,
                                            placements(spec, mesh, x.ndim))


# Default logical-activation rules for the production mesh.  Batch is
# data-parallel over (pod, data); heads / ffn / vocab are tensor-parallel
# over model; decode KV cache is sequence-sharded over model (DESIGN §5).
def default_rules(multi_pod: bool) -> Dict[str, PartitionSpec]:
    batch = ("pod", "data") if multi_pod else ("data",)
    return {
        "tokens": P(batch, None),
        "act_btd": P(batch, None, None),
        "act_btf": P(batch, None, "model"),
        "act_heads": P(batch, None, "model", None),
        "logits": P(batch, None, "model"),
        "kv_cache": P(None, batch, None, "model", None),
        "ssm_state": P(None, batch, "model", None),
    }
