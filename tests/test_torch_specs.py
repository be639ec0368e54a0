"""The placement arithmetic and the input specs of the port against the
JAX package's, on every architecture x input shape x mesh stub.

* ``launch/specs.py::build_rules`` equals JAX's rule dict on mesh stubs
  of shape 1x1, 16x16 and 2x16x16 (``_FakeMesh``: JAX's rule code reads
  only ``mesh.shape``, as in ``tests/test_rules.py``).
* ``sharding.resolve_spec`` (through ``placement_tree``) equals JAX's
  ``PartitionSpec`` on every leaf of the params, cache, state and batch
  trees under those rules.
* The logical-axes trees (``param_axes_tree``, ``cache_axes``,
  ``round.state_axes``) equal JAX's leaf for leaf.
* The meta specs' shapes and dtypes equal JAX's ``jax.eval_shape``
  results: the serving params keep the leaves the port reads in fp32 in
  fp32 (JAX's spec casts every leaf to bf16), and the decode ``pos`` is a
  position a row.
* Meta builds equal CPU builds in shape and dtype at reduced size.
"""

import dataclasses
import functools

import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro import sharding as jsh
from repro.config import (INPUT_SHAPES, TrainConfig as JTrain,
                          WSSLConfig as JWssl, get_arch as jget_arch)
from repro.core.round import abstract_state as j_abstract_state
from repro.launch import specs as jsp
from repro.models import transformer as jtf
from repro_torch import sharding
from repro_torch.config import (MeshConfig, TrainConfig, WSSLConfig,
                                get_arch, list_archs, reduced)
from repro_torch.core import round as rnd
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import specs as sp
from repro_torch.models import transformer as tf

ARCHS = list_archs()
CLIENTS = 16
MESHES = {"1x1": {"data": 1, "model": 1},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
# serving leaves the port stores in fp32 (its init's norm scales, the SSD
# block's and the RG-LRU gates'), where JAX's serving spec has bf16
FP32_LEAVES = {"scale", "A_log", "D", "dt_bias", "norm_scale", "w_r", "w_i",
               "b_r", "b_i", "lambda"}


class _FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _children(tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _flat(tree, path=()):
    """(path, leaf) of every array / tensor leaf."""
    kids = _children(tree)
    if kids is None:
        if hasattr(tree, "shape") and hasattr(tree, "dtype"):
            yield path, tree
        return
    for k, v in kids:
        yield from _flat(v, path + (k,))


def _get(tree, path):
    for k in path:
        tree = dict(_children(tree))[k]
    return tree


def _dt(x) -> str:
    return str(x.dtype).replace("torch.", "")


@functools.lru_cache(maxsize=None)
def _jax_trees(arch, clients):
    cfg = jget_arch(arch)
    params, paxes = jsp.serve_param_specs(cfg)
    state, saxes = j_abstract_state(cfg, JWssl(num_clients=clients), JTrain())
    return cfg, params, paxes, state, saxes


@functools.lru_cache(maxsize=None)
def _port_trees(arch, clients):
    cfg = get_arch(arch)
    params, paxes = sp.serve_param_specs(cfg)
    state, saxes = rnd.abstract_state(cfg, WSSLConfig(num_clients=clients),
                                      TrainConfig())
    return cfg, params, paxes, state, saxes


def _pairs(mesh, arch, shape_name):
    """(rules both ways, [(what, JAX axes/shape tree, port tree)])."""
    shape = INPUT_SHAPES[shape_name]
    # 16 clients on every mesh: on 2x16x16 the client axis then takes the
    # dividing prefix of ("pod", "data")
    n = CLIENTS
    jcfg, jparams, jpaxes, jstate, jsaxes = _jax_trees(arch, n)
    cfg, params, paxes, state, saxes = _port_trees(arch, n)
    fm = _FakeMesh(mesh)
    jrules = jsp.build_rules(fm, jcfg, shape.kind, shape.global_batch)
    rules = sp.build_rules(mesh, cfg, shape.kind, shape.global_batch)
    trees = []
    if shape.kind == "train":
        jb, jbax = jsp.batch_specs(jcfg, shape, JWssl(num_clients=n))
        b, bax = sp.batch_specs(cfg, shape, WSSLConfig(num_clients=n))
        trees += [("state", (jstate, jsaxes), (state, saxes)),
                  ("batch", (jb, jbax), (b, bax))]
    else:
        jb, jbax = jsp.batch_specs(jcfg, shape)
        b, bax = sp.batch_specs(cfg, shape)
        trees += [("params", (jparams, jpaxes), (params, paxes)),
                  ("batch", (jb, jbax), (b, bax))]
        if shape.kind == "decode":
            trees.append(("cache",) + _cache_specs(arch, shape_name))
    return fm, jrules, rules, trees


@functools.lru_cache(maxsize=None)
def _cache_specs(arch, shape_name):
    shape = INPUT_SHAPES[shape_name]
    return (jsp.cache_specs(jget_arch(arch), shape),
            sp.cache_specs(get_arch(arch), shape))


def test_mesh_shapes_match_jax():
    from repro.launch import mesh as jmesh
    assert pmesh.production_mesh_shape() == MESHES["16x16"]
    assert pmesh.production_mesh_shape(True) == MESHES["2x16x16"]
    for name, m in MESHES.items():
        fm = _FakeMesh(m)
        assert pmesh.data_axis_size(m) == jmesh.data_axis_size(fm)
        assert pmesh.model_axis_size(m) == jmesh.model_axis_size(fm)
        assert pmesh.mesh_info(fm) == m
    assert pmesh.mesh_name(MESHES["1x1"]) == "1"
    assert pmesh.mesh_name(MESHES["2x16x16"]) == "2x16x16"
    cfg = MeshConfig(shape=(2, 16, 16), axes=("pod", "data", "model"))
    assert cfg.num_devices == 512 and cfg.data_axes == ("pod", "data")


def test_default_and_auto_rules_match_jax():
    for multi in (False, True):
        for fsdp in (False, True):
            assert sharding.default_rules(multi, fsdp=fsdp) == \
                jsh.default_rules(multi, fsdp=fsdp)
    assert sharding.default_rules(seq_shard_kv=True) == \
        jsh.default_rules(seq_shard_kv=True)
    for m in MESHES.values():
        assert sharding.auto_rules(m) == jsh.auto_rules(_FakeMesh(m))
        assert sharding.data_axes_of(m) == jsh.data_axes_of(_FakeMesh(m))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_and_placements_match_jax(arch, mesh_name):
    """build_rules equal, then every leaf's placement equal to JAX's
    resolve_spec, for every input shape."""
    mesh = MESHES[mesh_name]
    checked = 0
    for shape_name in INPUT_SHAPES:
        fm, jrules, rules, trees = _pairs(mesh, arch, shape_name)
        assert rules == jrules, (shape_name, rules, jrules)
        for what, (jt, jax_axes), (pt, port_axes) in trees:
            placed = sharding.placement_tree(mesh, rules, port_axes, pt)
            for path, leaf in _flat(pt):
                axes = _get(jax_axes, path)
                if what == "batch" and path == ("pos",):
                    axes = ("batch",)   # the port's (B,) decode positions
                want = tuple(jsh.resolve_spec(fm, jrules, axes,
                                              tuple(leaf.shape)))
                got = _get(placed, path)
                assert got == want, (shape_name, what, path, got, want)
                checked += 1
    assert checked > 100


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_trees_match_jax(arch):
    jcfg, _, jpaxes, _, jsaxes = _jax_trees(arch, 16)
    cfg, _, paxes, _, saxes = _port_trees(arch, 16)
    assert tf.param_axes_tree(cfg) == paxes
    assert paxes == jtf.param_axes_tree(jcfg)
    assert tf.cache_axes(cfg) == jtf.cache_axes(jcfg)
    jleaves = dict(_flat_axes(jsaxes))
    got = dict(_flat_axes(saxes))
    assert got.keys() == jleaves.keys()
    for path, ax in jleaves.items():
        assert got[path] == ax, path


def _flat_axes(tree, path=()):
    if sharding.is_axes_leaf(tree):
        yield path, tree
        return
    for k, v in _children(tree):
        yield from _flat_axes(v, path + (k,))


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax_eval_shape(arch):
    """Every meta spec's shape and dtype equals JAX's eval_shape result."""
    for shape_name in INPUT_SHAPES:
        _, _, _, trees = _pairs(MESHES["16x16"], arch, shape_name)
        for what, (jt, _), (pt, _) in trees:
            jflat = dict(_flat(jt))
            pflat = dict(_flat(pt))
            # the port's selection generator is a host object, not a leaf
            jflat.pop(("rng",), None)
            assert pflat.keys() == jflat.keys(), (shape_name, what)
            for path, leaf in pflat.items():
                # host scalars (the round index, the optimizer steps) stay
                # on the host, as on the card
                assert leaf.is_meta or leaf.dim() == 0, path
                j = jflat[path]
                if what == "batch" and path == ("pos",):
                    # a position a row (the port's decode_step)
                    assert j.shape == () and tuple(leaf.shape) == (
                        INPUT_SHAPES[shape_name].global_batch,)
                    continue
                assert tuple(leaf.shape) == tuple(j.shape), (what, path)
                want = str(j.dtype)
                if what == "params" and path[-1] in FP32_LEAVES:
                    want = "float32"
                assert _dt(leaf) == want, (shape_name, what, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_builds_equal_cpu_builds(arch):
    cfg = reduced(get_arch(arch))
    gen = torch.Generator().manual_seed(0)
    for dtype in (None, torch.bfloat16):
        cpu = tf.init_params(cfg, gen, device="cpu", dtype=dtype)
        meta, _ = tf.abstract_params(cfg, dtype=dtype)
        _same_layout(meta, cpu)
    wssl_cfg = WSSLConfig(num_clients=3)
    cpu = rnd.init_state(gen, cfg, wssl_cfg, TrainConfig(), device="cpu")
    meta, _ = rnd.abstract_state(cfg, wssl_cfg, TrainConfig())
    _same_layout(meta, cpu)
    cpu = tf.init_cache(cfg, 2, 48, device="cpu")
    meta = tf.init_cache(cfg, 2, 48, device="meta")
    _same_layout(meta, cpu)


def _same_layout(meta, cpu):
    m, c = dict(_flat(meta)), dict(_flat(cpu))
    assert m.keys() == c.keys()
    for path, t in m.items():
        want = c[path]
        assert tuple(t.shape) == tuple(want.shape), path
        assert t.dtype == want.dtype, path
        # host scalars (the round index, the optimizer steps) stay on the
        # host, as on the card
        assert t.is_meta or (t.dim() == 0 and want.device == t.device), path


def test_local_shape_and_device_bytes():
    mesh = MESHES["2x16x16"]
    rules = sharding.default_rules(True)
    p = sharding.resolve_spec(mesh, rules, ("batch", "heads", None),
                              (64, 48, 7))
    assert p == (("pod", "data"), "model", None)
    assert sharding.local_shape(p, (64, 48, 7), mesh) == (2, 3, 7)
    # a tuple axis that does not divide: its longest dividing prefix
    p = sharding.resolve_spec(mesh, rules, ("batch", None), (2, 5))
    assert p == ("pod", None)
    # one mesh axis never serves two dims
    assert sharding.resolve_spec(mesh, rules, ("heads", "ff"),
                                 (16, 16)) == ("model", None)
    tree = {"a": torch.empty((64, 48, 7), device="meta"),
            "b": [torch.empty((3,), dtype=torch.bfloat16, device="meta")]}
    axes = {"a": ("batch", "heads", None), "b": [(None,)]}
    assert sharding.device_bytes(mesh, rules, axes, tree) == 2 * 3 * 7 * 4 + 6
    assert sharding.device_bytes(MESHES["1x1"], sharding.default_rules(),
                                 axes, tree) == 64 * 48 * 7 * 4 + 6


def test_wssl_state_placement_shards_the_client_axis():
    cfg = reduced(get_arch("gemma-2b"))
    state, axes = rnd.abstract_state(cfg, WSSLConfig(num_clients=32),
                                     TrainConfig())
    mesh = MESHES["2x16x16"]
    placed = sharding.wssl_state_shardings(mesh, axes, state)
    for path, leaf in _flat(state):
        p = _get(placed, path)
        if path[0] in ("client_stack",) or path[:2] in (
                ("opt_client", "m"), ("opt_client", "v")):
            assert p[0] == ("pod", "data"), path
        else:
            # shared stages: replicated over the client axis (fsdp may
            # still bind 'data' to a weight's d_model dim)
            assert "pod" not in str(p) and p[:1] != (("pod", "data"),), path
