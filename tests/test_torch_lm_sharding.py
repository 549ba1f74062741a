"""The LM half of ``repro_torch.distributed.sharding`` and the rules of
``repro_torch.distributed.context`` against ``repro``'s, entry by entry,
on the CPU.

Each spec function reads only a mesh's axis sizes, so both packages run
at the production sizes without a world of that size: ``repro``'s on a
``jax.sharding.AbstractMesh``, the port's on a plain mapping of axis name
to size.  Axis sizes ``{data:16, model:16}``, ``{pod:2, data:16,
model:16}`` (multi-pod), ``{data:4, model:2}`` and ``{data:1, model:1}``;
the ten architectures' published parameter trees (``jax.eval_shape`` on
``repro``'s side, ``meta`` tensors on the port's: nothing is allocated),
for training and for serving, their decode caches at ``decode_32k`` and
their batches at every supported shape.  ``repro`` stacks a layer
stack's parameters on leading axes; each of the port's layers must have
``repro``'s stacked spec without those axes, which ``repro`` leaves
unsharded.
"""

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs import get_config as j_config
from repro.distributed import context as JX
from repro.distributed import sharding as JSH
from repro.launch import specs as JS
from repro.models import model as JM

from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed import context as TX
from repro_torch.distributed import sharding as TSH
from repro_torch.distributed.context import PartitionSpec as P
from repro_torch.launch import specs as TS
from repro_torch.tree import STACKED

SIZES = {"16x16": {"data": 16, "model": 16},
         "2x16x16": {"pod": 2, "data": 16, "model": 16},
         "4x2": {"data": 4, "model": 2},
         "1x1": {"data": 1, "model": 1}}
CACHE_STACKED = {"layers": 1, "m": 2, "s": 1}


def abstract(sizes):
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def multi_pod(sizes):
    return "pod" in sizes


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


def port_specs(tree, stacked):
    """The port's tree of ``NamedSharding``s keyed as ``repro``'s stacked
    one: ``{path: spec}``, each per-layer list's specs checked equal from
    layer to layer."""
    def stack(items, axes):
        if axes == 0:
            return {"/".join(p): tuple(s.spec) for p, s in _leaves(items)}
        parts = [stack(x, axes - 1) for x in items]
        assert all(p == parts[0] for p in parts), "layers differ"
        return {k: ("stacked",) + v for k, v in parts[0].items()}

    out = {}
    for k, v in tree.items():
        if k in stacked and isinstance(v, list):
            out.update({f"{k}/{p}": s for p, s in
                        stack(v, stacked[k]).items()})
        else:
            out.update({"/".join((k,) + p): tuple(s.spec)
                        for p, s in _leaves(v)})
    return out


def repro_specs(tree, stacked):
    """``repro``'s tree of ``NamedSharding``s as ``{path: spec}``, the
    stacked leading entries (asserted unsharded) marked as the port's
    are."""
    out = {}
    for path, s in jax.tree_util.tree_leaves_with_path(tree):
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        spec = tuple(s.spec)
        n = stacked.get(keys[0], 0)
        assert all(e is None for e in spec[:n]), (keys, spec)
        out["/".join(keys)] = ("stacked",) * (n > 0) + spec[n:]
    return out


def _norm(specs):
    # ("stacked",) * axes collapse to one marker on both sides
    out = {}
    for k, v in specs.items():
        while v[:2] == ("stacked", "stacked"):
            v = v[1:]
        out[k] = v
    return out


@pytest.mark.parametrize("serve", [False, True], ids=["train", "serve"])
@pytest.mark.parametrize("mesh", list(SIZES))
@pytest.mark.parametrize("arch", ARCHS)
def test_tree_shardings_equal_repro(arch, mesh, serve):
    sizes = SIZES[mesh]
    jcfg = j_config(arch)
    jshape = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    want = repro_specs(JSH.tree_shardings(jshape, abstract(sizes),
                                          multi_pod(sizes), serve=serve),
                       STACKED)
    got = port_specs(TSH.tree_shardings(TS.params_specs(get_config(arch)),
                                        sizes, multi_pod(sizes),
                                        serve=serve), STACKED)
    assert _norm(got) == _norm(want)
    if sizes["model"] > 1:
        assert any("model" in str(v) for v in got.values())


@pytest.mark.parametrize("mesh", list(SIZES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_one_by_one_equal_repro(arch, mesh):
    """``param_spec`` and ``serve_param_spec`` called leaf by leaf on the
    stacked shapes (``repro``'s own calls) give ``repro``'s specs: the
    rules count dims from the end, so a stacked shape is a valid input."""
    sizes = SIZES[mesh]
    jcfg = j_config(arch)
    jshape = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    for path, x in jax.tree_util.tree_leaves_with_path(jshape):
        keys = tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
        shape = tuple(x.shape)
        assert tuple(TSH.param_spec(keys, shape, sizes, multi_pod(sizes))) \
            == tuple(JSH.param_spec(keys, shape, abstract(sizes),
                                    multi_pod(sizes))), keys
        assert tuple(TSH.serve_param_spec(keys, shape, sizes)) == tuple(
            JSH.serve_param_spec(keys, shape, abstract(sizes))), keys


def _decode_cache_cells():
    return [a for a in ARCHS
            if TS.shape_supported(get_config(a), "decode_32k")[0]]


@pytest.mark.parametrize("mesh", list(SIZES))
@pytest.mark.parametrize("arch", _decode_cache_cells())
def test_cache_shardings_equal_repro(arch, mesh):
    sizes = SIZES[mesh]
    ss = TS.SHAPE_SPECS["decode_32k"]
    jcfg = j_config(arch)
    jcache = jax.eval_shape(lambda: JM.init_decode_cache(
        jcfg, ss.global_batch, ss.seq_len))
    want = repro_specs(JSH.cache_shardings(jcache, abstract(sizes),
                                           multi_pod(sizes), jcfg),
                       CACHE_STACKED)
    cache = TS.input_specs(get_config(arch), "decode_32k")["cache"]
    got = port_specs(TSH.cache_shardings(cache, sizes, multi_pod(sizes),
                                         get_config(arch)), CACHE_STACKED)
    assert _norm(got) == _norm(want)


@pytest.mark.parametrize("mesh", list(SIZES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_shardings_equal_repro(arch, mesh):
    sizes = SIZES[mesh]
    for shape in TS.SHAPES:
        if not TS.shape_supported(get_config(arch), shape)[0]:
            continue
        got = TS.input_specs(get_config(arch), shape)
        want = JS.input_specs(j_config(arch), shape)
        got.pop("cache", None)
        want.pop("cache", None)
        g = TSH.batch_shardings(got, sizes, multi_pod(sizes))
        w = JSH.batch_shardings(want, abstract(sizes), multi_pod(sizes))
        assert {k: tuple(v.spec) for k, v in g.items()} == {
            k: tuple(v.spec) for k, v in w.items()}, shape


@pytest.mark.parametrize("mesh", list(SIZES))
@pytest.mark.parametrize("arch", ARCHS)
def test_activation_rules_and_ctx_equal_repro(arch, mesh):
    sizes = SIZES[mesh]
    got = TSH.activation_rules(get_config(arch), sizes, multi_pod(sizes))
    want = JSH.activation_rules(j_config(arch), abstract(sizes),
                                multi_pod(sizes))
    assert {k: tuple(v) for k, v in got.items()} == {
        k: tuple(v) for k, v in want.items()}
    ctx = TSH.make_ctx(get_config(arch), sizes, multi_pod(sizes))
    jctx = JSH.make_ctx(j_config(arch), abstract(sizes), multi_pod(sizes))
    assert (ctx.token_axes, ctx.expert_axis) == (jctx.token_axes,
                                                 jctx.expert_axis)
    assert ctx.spec("act_heads") == tuple(jctx.spec("act_heads"))


@pytest.mark.parametrize("multi", [False, True])
def test_default_rules_equal_repro(multi):
    got = TX.default_rules(multi)
    want = JX.default_rules(multi)
    assert {k: tuple(v) for k, v in got.items()} == {
        k: tuple(v) for k, v in want.items()}


def test_partition_spec_reads_as_jax_s():
    from jax.sharding import PartitionSpec as JP
    for parts in [(("data",), None), (("pod", "data"), None, "model"), (),
                  (None, "model"), ([],)]:
        assert tuple(P(*parts)) == tuple(JP(*parts)), parts
    assert P(("pod", "data")).axes(0) == ("pod", "data")
    assert P("model").axes(3) == ()


def test_placements_of_a_spec():
    """A spec on a mesh's axes as DTensor placements: Shard(d) on each
    mesh dim that shards tensor dim d (a tuple of names shards one dim
    over several mesh dims, major first), else Replicate."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = {"pod": 2, "data": 16, "model": 16}
    assert TX.placements(P(("pod", "data"), None, "model"), sizes) == (
        Shard(0), Shard(0), Shard(2))
    assert TX.placements(P(), sizes) == (Replicate(),) * 3
    assert TX.placements(P(None, "data"), {"data": 4, "model": 2}) == (
        Shard(1), Replicate())
    with pytest.raises(ValueError, match="order"):
        TX.placements(P(("data", "pod")), sizes)
    with pytest.raises(ValueError, match="twice"):
        TX.placements(P("data", "data"), sizes)
    with pytest.raises(ValueError, match="entries"):
        TX.placements(P(None, None, "model"), sizes, ndim=2)


def test_constrain_is_the_identity_without_a_context_or_a_rule():
    import torch
    x = torch.ones(2, 3)
    assert TX.constrain(x, "act_btd") is x
    with TX.use(TX.ShardCtx(mesh={"data": 1, "model": 1}, rules={})):
        assert TX.current() is not None
        assert TX.constrain(x, "act_btd") is x
    assert TX.current() is None


def test_production_mesh_refuses_another_world_size():
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(ValueError, match="256 ranks, the world has 1"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512 ranks, the world has 1"):
        make_production_mesh(multi_pod=True, device="cpu")


def test_host_mesh_of_one_rank():
    """With no group, ``make_host_mesh`` makes a one-rank gloo group on the
    CPU and a ``(1, 1)`` mesh (``model`` clipped to the world)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    assert not dist.is_initialized()
    try:
        mesh = make_host_mesh(2, device="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert TX.axis_sizes(mesh) == {"data": 1, "model": 1}
        assert str(dist.get_backend()) == "gloo"
    finally:
        dist.destroy_process_group()
