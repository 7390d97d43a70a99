"""The port's meshes, partition rules and shape stand-ins against the
reference's, on the CPU, with nothing allocated.

For every architecture at full size, the port's model on ``meta``
(``specs.params_shape``) and the reference's ``jax.eval_shape`` of its init
go through each package's ``params_specs``, ``opt_specs``, ``batch_specs``
and ``cache_specs`` on the meshes ``(data, model)`` in {(1,1), (2,2), (1,4),
(4,2), (16,16)} and the 2x16x16 pod mesh.  The reference's rules read only
``axis_names`` and a ``shape`` dict, so it takes a stand-in.  A port spec of
a name in a layer stack is the reference's spec of the stacked leaf.
"""

import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import mesh as jmesh
from repro.launch import partition as jpartition
from repro.launch import specs as jspecs
from repro.optim import adamw as jadamw
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import partition, specs
from repro_torch.launch.mesh import DeviceMesh, make_test_mesh
from repro_torch.models.config import LM_SHAPES
from repro_torch.optim import adamw_init

MESHES = [(1, 1), (2, 2), (1, 4), (4, 2), (16, 16), "pod"]


def meshes():
    for m in MESHES:
        if m == "pod":
            yield tmesh.make_production_mesh(multi_pod=True)
        else:
            yield make_test_mesh(*m)


def stand_in(mesh):
    return types.SimpleNamespace(axis_names=mesh.axis_names,
                                 shape=dict(mesh.shape))


def ref_leaf(tree, name):
    """The reference tree's leaf behind a ``state_dict`` name (the layer
    index dropped)."""
    node = tree
    parts = name.split(".")
    i = 0
    while i < len(parts):
        node = node[parts[i]]
        if parts[i] in partition.STACKS and i == 0:
            i += 1
        i += 1
    return node


def check_named(port, ref, what):
    """Every name's spec equals the reference's leaf, and every reference
    leaf is some name's."""
    seen = set()
    for name, spec in port.items():
        leaf = ref_leaf(ref, name)
        assert spec == tuple(leaf), (what, name, spec, leaf)
        seen.add(id(leaf))
    assert len(seen) == len(jax.tree.leaves(
        ref, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))


def check_tree(port, ref, what):
    if port is None:
        assert ref is None, what
        return
    if isinstance(port, dict):
        assert set(port) == set(ref), what
        for k in port:
            check_tree(port[k], ref[k], f"{what}.{k}")
        return
    assert port == tuple(ref), (what, port, ref)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    jmod = __import__("repro.models." + ("encdec" if cfg.family == "encdec"
                                         else "lm"), fromlist=["init"])
    jp = jax.eval_shape(lambda k: jmod.init(k, jcfg), jax.random.PRNGKey(0))
    jo = jax.eval_shape(jadamw.adamw_init, jp)
    tp = specs.params_shape(cfg)
    assert all(p.is_meta for p in tp.parameters())
    to = adamw_init(tp)
    shape = LM_SHAPES["train_4k"]
    jb, tb = jspecs.train_inputs(jcfg, shape), specs.train_inputs(cfg, shape)
    jc = jspecs.decode_inputs(jcfg, LM_SHAPES["decode_32k"])[0]
    tc = specs.decode_inputs(cfg, LM_SHAPES["decode_32k"])[0]
    for mesh in meshes():
        ref_mesh = stand_in(mesh)
        jps = jpartition.params_specs(ref_mesh, jp)
        tps = partition.params_specs(mesh, tp)
        check_named(tps, jps, f"{arch} {mesh} params")
        jos = jpartition.opt_specs(ref_mesh, jo, jps)
        tos = partition.opt_specs(mesh, to, tps)
        assert tos["step"] == tuple(jos["step"])
        for key in ("master", "mu", "nu"):
            check_named(tos[key], jos[key], f"{arch} {mesh} opt {key}")
        check_tree(partition.batch_specs(mesh, tb),
                   jpartition.batch_specs(ref_mesh, jb), f"{arch} batch")
        check_tree(partition.cache_specs(mesh, cfg, tc),
                   jpartition.cache_specs(ref_mesh, jcfg, jc),
                   f"{arch} {mesh} caches")


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-1.3b",
                                  "seamless-m4t-medium", "internvl2-26b"])
def test_shape_stand_ins_equal_reference(arch):
    """Parameter count and every input stand-in's shape and dtype."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    jmod = __import__("repro.models." + ("encdec" if cfg.family == "encdec"
                                         else "lm"), fromlist=["init"])
    jp = jax.eval_shape(lambda k: jmod.init(k, jcfg), jax.random.PRNGKey(0))
    assert sum(p.numel() for p in specs.params_shape(cfg).parameters()) == \
        sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jp))
    for name in ("train_4k", "prefill_32k"):
        shape = LM_SHAPES[name]
        for fn in ("train_inputs", "prefill_inputs"):
            t, j = getattr(specs, fn)(cfg, shape), getattr(jspecs, fn)(jcfg,
                                                                       shape)
            assert set(t) == set(j)
            for k in t:
                assert tuple(t[k].shape) == j[k].shape and t[k].is_meta
                assert str(t[k].dtype).split(".")[1] == str(j[k].dtype)
    tc, tt = specs.decode_inputs(cfg, LM_SHAPES["decode_32k"])
    jc, jt = jspecs.decode_inputs(jcfg, LM_SHAPES["decode_32k"])
    assert tuple(tt["tokens"].shape) == jt["tokens"].shape

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return None if tree is None else tuple(tree.shape)

    assert shapes(tc) == jax.tree.map(lambda x: tuple(x.shape), jc)


def test_mesh_helpers_equal_reference():
    for mesh in meshes():
        ref = stand_in(mesh)
        assert tmesh.dp_axes(mesh) == jmesh.dp_axes(ref)
        assert tmesh.dp_size(mesh) == jmesh.dp_size(ref)
        assert tmesh.tp_size(mesh) == jmesh.tp_size(ref)
    pod = tmesh.make_production_mesh(multi_pod=True)
    assert pod.shape == {"pod": 2, "data": 16, "model": 16} and pod.size == 512
    assert tmesh.make_production_mesh().shape == {"data": 16, "model": 16}
    assert not pod.bound
    with pytest.raises(ValueError, match="not bound"):
        make_test_mesh(2, 2).coord("model")
    assert make_test_mesh(1, 1).coord("data") == 0


def fake_rank(shape, coords):
    """A mesh bound to no group, at ``coords``: enough for the slices."""
    return DeviceMesh(("data", "model"), shape, coords=coords, groups={})


def test_local_shard_takes_contiguous_slices():
    x = torch.arange(4 * 6).reshape(4, 6)
    for d in range(2):
        for m in range(2):
            mesh = fake_rank((2, 2), (d, m))
            got = partition.local_shard(x, ("data", "model"), mesh)
            assert torch.equal(got, x[2 * d:2 * d + 2, 3 * m:3 * m + 3])
            assert torch.equal(partition.local_shard(x, (None, "model"), mesh),
                               x[:, 3 * m:3 * m + 3])
            assert partition.local_shape((4, 6), ("data", None), mesh) == (2, 6)
    # a dim over two axes: the major axis first
    pod = DeviceMesh(("pod", "data", "model"), (2, 2, 1), coords=(1, 0, 0),
                     groups={})
    y = torch.arange(8)
    assert torch.equal(partition.local_shard(y, (("pod", "data"),), pod),
                       y[4:6])


def test_zero_over_the_layer_axis_owns_whole_layers():
    """The reference stacks 2 layers, so ``data = 2`` splits the optimizer
    state by layers: each data rank owns one layer's master, whole over
    ``data`` and split over ``model`` where the parameter is."""
    from repro_torch.configs import reduced

    cfg = reduced(get_config("codeqwen1.5-7b"))
    model = specs.params_shape(cfg, dtype=torch.float32)
    mesh = make_test_mesh(2, 2)
    ps = partition.params_specs(mesh, model)
    os_ = partition.opt_specs(mesh, adamw_init(model), ps)
    assert ps["layers.1.attn.wq"] == (None, None, "model")
    assert os_["master"]["layers.1.attn.wq"] == ("data", None, "model")
    assert os_["master"]["embed"] == ("model", "data") \
        and ps["embed"] == ("model", None)
    gen = torch.Generator().manual_seed(0)
    full = {n: torch.randn(p.shape, generator=gen)
            for n, p in model.named_parameters()}
    for d in range(2):
        for m in range(2):
            rank = fake_rank((2, 2), (d, m))
            local = partition.shard_named(full, os_["master"], rank)
            layers = {partition.layer_of(n)[1] for n in local
                      if partition.layer_of(n)}
            assert layers == {d}
            assert torch.equal(local["layers.%d.attn.wq" % d],
                               full["layers.%d.attn.wq" % d][:, 32 * m:
                                                             32 * m + 32])
            assert torch.equal(local["embed"],
                               full["embed"][128 * m:128 * m + 128,
                                             32 * d:32 * d + 32])
