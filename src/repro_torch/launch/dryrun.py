"""Multi-pod dry run: every (architecture x input shape) cell's step on
the production meshes, over a fake world, with its memory, cost and
collective data (a port of ``repro.launch.dryrun``).

``repro`` lowers and compiles each cell for 256 (512) XLA host devices
and reads XLA's analyses.  The port has no compiler to ask, so it runs
the step itself, once, at full size, in one process:

* the world is torch's ``fake`` process-group backend with 256 (512)
  ranks, this process rank 0; its collectives communicate nothing;
* every tensor is a ``FakeTensor`` (``FakeTensorMode``): shapes, dtypes
  and devices, no memory and no arithmetic;
* the parameters, optimizer state, batch and cache are ``DTensor``s laid
  out by ``distributed.sharding``'s specs, and the step runs under
  ``make_ctx``, as a step on the real mesh would;
* one dispatch mode below ``DTensor`` sees rank 0's local ops: it counts
  their FLOPs (``torch.utils.flop_counter``'s formulas), the bytes they
  read and write, the live bytes they allocate, and every collective,
  DTensor's functional ones and the ``c10d`` ops of the port's own
  ``shard_map``s alike.

A sharding mismatch, an unsupported op or a host read of a tensor (which
a fake tensor cannot answer) fails the cell, and a cell's failure is
data, as in ``repro``.  The fake world is made and torn down around each
cell and refuses to start where a process group exists already, so it
never meets a real one.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape train_4k [--multi-pod] [--both-meshes] [--all] \\
      [--out results.json] [--device cpu] [--layers N]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import re
import sys
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS, get_config
from repro_torch.device import resolve_device
from repro_torch.distributed import context as dctx
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs as SP
from repro_torch.launch.hlo_parse import analyze_collectives  # noqa: F401
from repro_torch.launch.mesh import FAKE_BACKEND, make_production_mesh
from repro_torch.launch.roofline import analyze_cell
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.train import optimizer as opt
from repro_torch.train.step import loss_and_grads
from repro_torch.tree import map_tree

_COLLECTIVE_RE = re.compile(
    r"\b(all-reduce|all-gather|reduce-scatter|all-to-all|"
    r"collective-permute)(?:-start)?\b")
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
    "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1,
    "f8e4m3fn": 1, "f8e5m2": 1,
}


def collective_bytes_from_hlo(hlo: str) -> Dict[str, int]:
    """Per-device bytes moved by every collective op in the post-SPMD HLO
    module, keyed by op kind.

    Post-optimization HLO does not inline operand shapes, so we charge
    each op its *result* type (the standard per-device wire proxy:
    all-gather result = the gathered buffer a device receives; all-reduce
    / all-to-all / collective-permute results equal their inputs).
    ``-done`` halves of async pairs are skipped.
    """
    out: Dict[str, int] = {}
    for line in hlo.splitlines():
        line = line.strip()
        if "=" not in line or "-done" in line.split("(", 1)[0]:
            continue
        rhs = line.split("=", 1)[1]
        head = rhs.split("(", 1)[0]
        m = _COLLECTIVE_RE.search(head)
        if not m:
            # async start form: result is a tuple before the op name
            m2 = _COLLECTIVE_RE.search(rhs.split("),", 1)[0]) \
                if rhs.lstrip().startswith("(") else None
            if not m2:
                continue
            m = m2
            head = rhs.split(m.group(0), 1)[0]
        kind = m.group(1)
        nbytes = 0
        for dt, dims in _SHAPE_RE.findall(head):
            if dt not in _DTYPE_BYTES:
                continue
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            nbytes += n * _DTYPE_BYTES[dt]
        out[kind] = out.get(kind, 0) + nbytes
    return out


@dataclasses.dataclass
class CellReport:
    """One cell's dry run.  Where ``repro`` reads XLA's analyses of the
    compiled module, the port counts rank 0's local ops of one eager step:

    * ``flops``: their FLOPs, by ``torch.utils.flop_counter``'s formulas
      (matrix products, convolutions, attention; elementwise ops count
      none), not XLA's ``cost_analysis``;
    * ``hlo_bytes``: the bytes they read and write, every tensor operand
      and result of every op that is not a view, unfused;
    * ``collective_bytes`` / ``collective_counts``: each collective by
      ``repro``'s kind names, charged its per-device result bytes, as
      ``repro`` charges them;
    * ``arg_bytes_per_device`` / ``output_bytes_per_device``: the bytes
      of rank 0's local shards of the step's inputs and outputs (XLA's
      output size adds an 8-byte tuple entry a leaf);
    * ``temp_bytes_per_device``: the peak of the bytes live on rank 0
      during the step beyond the arguments' own, an eager peak, not
      XLA's buffer assignment;
    * ``compile_seconds``: the dry run's own seconds for the cell.
    """

    arch: str
    shape: str
    mesh: str
    status: str                       # ok | skipped | failed
    reason: str = ""
    flops: float = 0.0
    hlo_bytes: float = 0.0
    collective_bytes: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    arg_bytes_per_device: int = 0
    temp_bytes_per_device: int = 0
    output_bytes_per_device: int = 0
    compile_seconds: float = 0.0
    collective_counts: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    roofline: Optional[Dict[str, Any]] = None

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world: int):
    """A default process group of ``world`` ranks of the ``fake`` backend,
    this process rank 0, destroyed on exit.  Raises where a group exists
    already: the fake world never stands in for a real one."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run's fake world needs a process with "
                           f"no process group; one of "
                           f"{dist.get_world_size()} ranks exists")
    dist.init_process_group(FAKE_BACKEND, store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    # the models' small constants (RoPE frequencies) are real tensors
    return FakeTensorMode(allow_non_fake_inputs=True)


# ---------------------------------------------------------------------------
# the counting mode
# ---------------------------------------------------------------------------

def _collective_kinds() -> Dict[Any, str]:
    """The collective ops of DTensor's functional layer and of ``c10d``,
    each with ``repro``'s kind name."""
    fc, c10d = torch.ops._c10d_functional, torch.ops.c10d
    kinds = {
        fc.all_gather_into_tensor: "all-gather",
        fc.all_gather_into_tensor_coalesced: "all-gather",
        fc.all_reduce: "all-reduce",
        fc.all_reduce_coalesced: "all-reduce",
        fc.reduce_scatter_tensor: "reduce-scatter",
        fc.reduce_scatter_tensor_coalesced: "reduce-scatter",
        fc.all_to_all_single: "all-to-all",
        fc.broadcast: "broadcast",
        c10d._allgather_base_: "all-gather",
        c10d.allgather_: "all-gather",
        c10d.allgather_coalesced_: "all-gather",
        c10d.allgather_into_tensor_coalesced_: "all-gather",
        c10d.allreduce_: "all-reduce",
        c10d.allreduce_coalesced_: "all-reduce",
        c10d._reduce_scatter_base_: "reduce-scatter",
        c10d.reduce_scatter_: "reduce-scatter",
        c10d.reduce_scatter_tensor_coalesced_: "reduce-scatter",
        c10d.alltoall_: "all-to-all",
        c10d.alltoall_base_: "all-to-all",
        c10d.broadcast_: "broadcast",
        c10d.scatter_: "scatter",
        c10d.gather_: "gather",
        c10d.reduce_: "reduce",
    }
    if hasattr(torch.ops, "_c10d_functional_autograd"):
        kinds[torch.ops._c10d_functional_autograd.all_to_all_single] = (
            "all-to-all")
    if hasattr(torch.ops, "_dtensor"):
        kinds[torch.ops._dtensor.shard_dim_alltoall] = "all-to-all"
    return kinds


def _tensors(tree, out=None):
    """The tensors of ``tree`` (nested tuples, lists and dicts), in
    order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _einsum_flops(equation: str, operands) -> int:
    """A two-operand ``einsum``'s FLOPs: a multiply and an add for every
    point of its index space (``einsum`` reaches the mode whole under
    inference mode; the formulas cover its products, not it)."""
    terms = equation.replace(" ", "").split("->")[0].split(",")
    sizes: Dict[str, int] = {}
    for term, t in zip(terms, operands):
        sizes.update(zip(term, t.shape))
    n = 1
    for v in sizes.values():
        n *= int(v)
    return 2 * n if len(terms) == 2 else 0


class _Counter(TorchDispatchMode):
    """Rank 0's local ops of one step: FLOPs, bytes read and written,
    collectives by kind (result bytes, count) and the peak of the live
    bytes beyond the arguments'.  It lets ``DTensor`` run first (a
    ``DTensor`` op returns ``NotImplemented`` here) and so sees the local
    ops DTensor desugars an op into."""

    def __init__(self, args, axes: Optional[Dict[str, str]] = None):
        super().__init__()
        self.axes = axes or {}
        self.by_axis: Dict[str, int] = {}
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.kinds = _collective_kinds()
        self.flops = 0
        self.bytes = 0
        self.coll_bytes: Dict[str, int] = {}
        self.coll_counts: Dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self.paused = 0
        self.repeated = 0           # iterations counted, not dispatched
        self._seen = weakref.WeakKeyDictionary()
        for t in _tensors(args):
            self._track(t, count=False)

    def _track(self, t: torch.Tensor, count: bool = True) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes() if count else 0
        self._seen[st] = n
        if n:
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    # a recurrence counted by one of its iterations (``models.ssm.scan``)

    def iteration(self, fn):
        """``fn()`` and what it counted: FLOPs, bytes, collectives by
        kind and axis, the live bytes it left and the rise of the live
        bytes above their start within it."""
        before = (self.flops, self.bytes, dict(self.coll_bytes),
                  dict(self.coll_counts), dict(self.by_axis), self.live)
        peak, self.peak = self.peak, self.live
        try:
            out = fn()
        finally:
            rise = self.peak - before[5]
            self.peak = max(peak, self.peak)

        def grown(now, then):
            return tuple(sorted((k, v - then.get(k, 0))
                                for k, v in now.items()
                                if v != then.get(k, 0)))

        return out, (self.flops - before[0], self.bytes - before[1],
                     grown(self.coll_bytes, before[2]),
                     grown(self.coll_counts, before[3]),
                     grown(self.by_axis, before[4]),
                     self.live - before[5], rise)

    def repeat(self, delta, times: int) -> None:
        """Count ``times`` more iterations like the one that counted
        ``delta`` (:meth:`iteration`): its counts ``times`` over, the
        live bytes it left ``times`` over, and the peak the last of them
        (or, where they shrink the live bytes, the first) reaches."""
        if not times:
            return
        self.repeated += times
        flops, nbytes, coll_bytes, coll_counts, by_axis, left, rise = delta
        self.flops += times * flops
        self.bytes += times * nbytes
        for total, grown in ((self.coll_bytes, coll_bytes),
                             (self.coll_counts, coll_counts),
                             (self.by_axis, by_axis)):
            for k, v in grown:
                total[k] = total.get(k, 0) + times * v
        self.peak = max(self.peak, self.live + rise
                        + max(0, (times - 1) * left))
        self.live += times * left

    def release(self, y, times: int) -> None:
        """Free the storage of ``times`` copies of ``y`` (a repeated
        iteration's output, which :meth:`repeat` left live)."""
        from torch.distributed.tensor import DTensor
        if times:
            t = y._local_tensor if isinstance(y, DTensor) else y
            self.live -= times * t.untyped_storage().nbytes()

    def _axis(self, args) -> str:
        """The mesh axis of a collective's group: a functional op names
        its group, a ``c10d`` op passes the group itself."""
        for a in args:
            if isinstance(a, str) and a in self.axes:
                return self.axes[a]
            if isinstance(a, torch.ScriptObject):
                try:
                    name = dist.ProcessGroup.unbox(a).group_name
                except RuntimeError:      # another script object (ReduceOp)
                    continue
                return self.axes.get(name, "?")
        return "?"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if func is torch.ops.prim.device.default:    # a tensor's device
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        packet = func._overloadpacket
        kind = self.kinds.get(packet)
        if self.paused:
            return func(*args, **kwargs)
        if packet is torch.ops.aten.matmul:
            # composite under inference mode: counted by the products it
            # decomposes into
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        results = _tensors(out)
        if kind is not None:
            # c10d ops write the tensors of their first argument in
            # place; the functional ones return their result
            inplace = packet._qualified_op_name.startswith("c10d::")
            res = _tensors(args[0]) if inplace else results
            self.coll_bytes[kind] = (self.coll_bytes.get(kind, 0)
                                     + sum(_nbytes(t) for t in res))
            self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
            key = f"{kind}@{self._axis(args)}"
            self.by_axis[key] = self.by_axis.get(key, 0) + 1
        elif func.namespace == "aten" and not func.is_view:
            self.bytes += sum(_nbytes(t) for t in
                              _tensors((args, kwargs)) + results)
            if packet is torch.ops.aten.einsum:
                self.flops += _einsum_flops(*args)
            else:
                count = self.flop_registry.get(packet)
                if count is not None:
                    self.flops += count(*args, **kwargs, out_val=out)
        for t in results:
            self._track(t)
        return out


#: ``ShardingPropagator``'s methods that derive an op's output layout and
#: shape, on fake tensors of the global shape (directly, or through the
#: op's decomposition)
_PROPAGATION = ("propagate_op_sharding_non_cached",
                "_propagate_tensor_meta_non_cached")


@contextlib.contextmanager
def _propagation_unseen(counter: _Counter):
    """``counter`` paused while DTensor derives an op's output layout: it
    runs the op, or its decomposition, on fake tensors of the global
    shape, which no rank computes."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    origs = {n: getattr(ShardingPropagator, n) for n in _PROPAGATION}

    def unseen(orig):
        def run(self, *args, **kwargs):
            counter.paused += 1
            try:
                return orig(self, *args, **kwargs)
            except NotImplementedError as e:
                # an op with no strategy (an einsum under inference mode,
                # which DTensor's dispatch then decomposes) raises this
                # from the decomposition's failure, which the raising
                # frame keeps in a local: frame, exception, traceback,
                # frame again.  The cycle holds every caller's frame, and
                # its tensors, until the collector runs; clearing the
                # raising frame breaks it, so they are freed as the plain
                # loop frees them
                traceback.clear_frames(e.__traceback__)
                raise
            finally:
                counter.paused -= 1
        return run

    for n, orig in origs.items():
        setattr(ShardingPropagator, n, unseen(orig))
    try:
        yield
    finally:
        for n, orig in origs.items():
            setattr(ShardingPropagator, n, orig)


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

def _local_bytes(tree) -> int:
    """The bytes of rank 0's local shards of every tensor of ``tree``."""
    from torch.distributed.tensor import DTensor
    total = 0
    for t in _tensors(tree):
        total += _nbytes(t.to_local() if isinstance(t, DTensor) else t)
    return total


def local_bytes_by_leaf(tree, prefix: str = "") -> Dict[str, int]:
    """Rank 0's local-shard bytes of every tensor of ``tree`` by path
    (``/``-joined dict keys and tuple indices), the entries of a list (a
    per-layer stack) summed under the list's path, as ``repro`` stacks
    them on a leading axis: the leaves of ``repro``'s argument trees."""
    from torch.distributed.tensor import DTensor
    out: Dict[str, int] = {}
    if isinstance(tree, dict):
        items = [(f"{prefix}{k}/", v) for k, v in tree.items()]
    elif isinstance(tree, tuple):
        items = [(f"{prefix}{i}/", v) for i, v in enumerate(tree)]
    elif isinstance(tree, list):
        items = [(prefix, v) for v in tree]
    else:
        if isinstance(tree, torch.Tensor):
            t = tree.to_local() if isinstance(tree, DTensor) else tree
            out[prefix[:-1]] = _nbytes(t)
        return out
    for p, v in items:
        for k, n in local_bytes_by_leaf(v, p).items():
            out[k] = out.get(k, 0) + n
    return out


def _placed(specs, shardings, dev):
    """A ``DTensor`` for every stand-in of ``specs`` (shape and dtype), a
    fake tensor of the full shape on ``dev`` cut by its sharding with no
    communication."""
    from torch.distributed.tensor import distribute_tensor

    def one(x, s):
        full = torch.empty(tuple(x.shape), dtype=x.dtype, device=dev)
        return distribute_tensor(full, s.mesh, s.placements(full.ndim),
                                 src_data_rank=None)
    return map_tree(one, specs, shardings)


def _build_fn_and_args(cfg, shape_name, mesh, multi_pod, device):
    """Returns ``(fn, args)``: the cell's step and its arguments, placed
    on ``mesh`` (under the fake mode: fake local shards)."""
    ss = SP.SHAPE_SPECS[shape_name]
    dev = torch.device(device)
    inputs = SP.input_specs(cfg, shape_name)

    if ss.kind == "train":
        hp = opt.AdamWConfig()
        p_specs = SP.params_specs(cfg)
        o_specs = opt.init(p_specs)
        params = _placed(p_specs, shd.tree_shardings(p_specs, mesh,
                                                     multi_pod), dev)
        state = _placed(o_specs, shd.tree_shardings(o_specs, mesh,
                                                    multi_pod), dev)
        batch = _placed(inputs, shd.batch_shardings(inputs, mesh,
                                                    multi_pod), dev)

        def step(params, opt_state, batch):
            loss, grads = loss_and_grads(params, batch, cfg, device=dev)
            new_p, new_o = opt.update(grads, opt_state, params, hp)
            return loss, new_p, new_o

        return step, (params, state, batch)

    if ss.kind == "prefill":
        p_specs = SP.params_specs(cfg)
        params = _placed(p_specs, shd.tree_shardings(p_specs, mesh,
                                                     multi_pod), dev)
        batch = _placed(inputs, shd.batch_shardings(inputs, mesh,
                                                    multi_pod), dev)

        def run_prefill(params, batch):
            extra = {k: v for k, v in batch.items() if k != "tokens"}
            return M.prefill(params, batch["tokens"], cfg, extra=extra,
                             device=dev)

        return run_prefill, (params, batch)

    # decode: serving layout — bf16 TP-resident weights, no FSDP gathers
    p_specs = map_tree(lambda s: s.to(torch.bfloat16)
                       if s.is_floating_point() else s, SP.params_specs(cfg))
    params = _placed(p_specs, shd.tree_shardings(p_specs, mesh, multi_pod,
                                                 serve=True), dev)
    cache = _placed(inputs["cache"], shd.cache_shardings(
        inputs["cache"], mesh, multi_pod, cfg), dev)
    tokens = _placed({"tokens": inputs["tokens"]}, shd.batch_shardings(
        {"tokens": inputs["tokens"]}, mesh, multi_pod), dev)["tokens"]

    def serve_step(params, cache, tokens):
        return M.decode_step(params, cache, tokens, cfg, device=dev)

    return serve_step, (params, cache, tokens)


def measure(cfg, shape_name: str, mesh, multi_pod: bool, device,
            detail: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The cell's step on ``mesh`` (a mesh over a fake world), run once on
    fake tensors under ``make_ctx``: the :class:`CellReport` fields it
    measures.  ``detail``, where given, gets the collectives' counts by
    kind and mesh axis (``"all-gather@data"``) and the step's arguments
    and outputs (fake), and the number of recurrence iterations counted
    without being dispatched (``models.ssm.scan``)."""
    axes = {mesh.get_group(n).group_name: n for n in mesh.mesh_dim_names}
    try:
        return _measure(cfg, shape_name, mesh, multi_pod, device, detail,
                        axes)
    finally:
        # a constant cached under the fake mode (the RoPE frequencies
        # copied to the card) must not outlive it
        L._freqs_on.cache_clear()


def _measure(cfg, shape_name, mesh, multi_pod, device, detail, axes):
    with _fake_mode():
        fn, args = _build_fn_and_args(cfg, shape_name, mesh, multi_pod,
                                      device)
        arg_bytes = _local_bytes(args)
        counter = _Counter(args, axes)
        with dctx.use(shd.make_ctx(cfg, mesh, multi_pod)), \
                _propagation_unseen(counter), dctx.counted_by(counter), \
                counter:
            out = fn(*args)
        if detail is not None:
            detail.update(by_axis=dict(counter.by_axis), args=args, out=out,
                          repeated=counter.repeated)
        return {"flops": float(counter.flops),
                "hlo_bytes": float(counter.bytes),
                "collective_bytes": dict(counter.coll_bytes),
                "collective_counts": dict(counter.coll_counts),
                "arg_bytes_per_device": arg_bytes,
                "temp_bytes_per_device": int(counter.peak),
                "output_bytes_per_device": _local_bytes(out)}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True, device=None, cfg=None) -> CellReport:
    """One cell on the production mesh over a fake world of 256 (512)
    ranks; ``cfg`` replaces ``get_config(arch)`` (a cut depth)."""
    mesh_name = "2x16x16" if multi_pod else "16x16"
    dev = resolve_device(device)
    cfg = get_config(arch) if cfg is None else cfg
    ok, reason = SP.shape_supported(cfg, shape_name)
    if not ok:
        return CellReport(arch, shape_name, mesh_name, "skipped", reason)
    t0 = time.time()
    try:
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
            got = measure(cfg, shape_name, mesh, multi_pod, dev)
        rep = CellReport(arch, shape_name, mesh_name, "ok", **got,
                         compile_seconds=time.time() - t0)
        chips = 512 if multi_pod else 256
        row = analyze_cell(cfg, shape_name, mesh_name, chips,
                           sum(rep.collective_bytes.values()),
                           pod_collective_frac=0.1 if multi_pod else 0.0,
                           device=dev)
        rep.roofline = row.to_json()
        if verbose:
            print(f"[ok] {arch} x {shape_name} x {mesh_name}: "
                  f"flops={rep.flops:.3e} bytes={rep.hlo_bytes:.3e} "
                  f"coll={sum(rep.collective_bytes.values()):.3e} "
                  f"mem(arg={rep.arg_bytes_per_device/2**30:.2f}GiB, "
                  f"temp={rep.temp_bytes_per_device/2**30:.2f}GiB) "
                  f"[{rep.compile_seconds:.0f}s]", flush=True)
        return rep
    except Exception as e:  # noqa: BLE001 — cell failure is data
        if verbose:
            print(f"[FAIL] {arch} x {shape_name} x {mesh_name}: "
                  f"{type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
        return CellReport(arch, shape_name, mesh_name, "failed",
                          reason=f"{type(e).__name__}: {e}",
                          compile_seconds=time.time() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=SP.SHAPES)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="cpu for fake tensors and a mesh on the host "
                         "(default: the card)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers, the widths "
                         "kept as published")
    args = ap.parse_args(argv)

    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = SP.SHAPES if (args.all or not args.shape) else [args.shape]
    meshes = ([False, True] if args.both_meshes
              else [bool(args.multi_pod)])

    reports = []
    for arch in archs:
        cfg = get_config(arch)
        if args.layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=args.layers)
        for shape in shapes:
            for mp in meshes:
                reports.append(run_cell(arch, shape, mp,
                                        device=args.device, cfg=cfg))
    if args.out:
        with open(args.out, "w") as f:
            json.dump([r.to_json() for r in reports], f, indent=1)
    n_fail = sum(r.status == "failed" for r in reports)
    print(f"\n{len(reports)} cells: "
          f"{sum(r.status == 'ok' for r in reports)} ok, "
          f"{sum(r.status == 'skipped' for r in reports)} skipped, "
          f"{n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
