"""The port's LM sharding (``repro_torch.sharding``, ``launch/mesh.py``'s
production mesh, ``launch/steps.make_shardings``) against the JAX
package, on the CPU.

The reference's side is filled as its own tests fill it
(``tests/test_sharding.py``): a duck-typed mesh with ``axis_names`` and
``devices.shape``, the reference's ``abstract_params`` /
``input_specs`` (``jax.eval_shape``, no allocation), its
``make_shardings`` with ``NamedSharding`` left out (the specs are what is
compared).  Each side runs under its own ``apply_variant``.  Contracts:
* the parameter and optimizer specs equal the reference's leaf by leaf
  (the reference's tree flattened to the port's dotted keys, each
  ``PartitionSpec`` as a tuple) for all 10 archs on pod1 and pod2, under
  the baseline and the four rule-changing variants;
* the batch and cache specs likewise for every (arch, shape), with
  long_500k's sequence sharding and the ring cache (the port's host-int
  cache ``len`` has no spec);
* every spec shards only dims that divide (the port's own trees);
* ``ShardCtx.resolve`` and ``act_spec`` equal the reference's ``resolve``
  of the names its ``shard_act`` keeps, on random shapes (hypothesis).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.configs.registry import get_config as j_get_config
from repro.launch import mesh as jmesh
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro.launch import variants as jvariants
from repro.sharding import ctx as jctx

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.launch import specs, steps
from repro_torch.launch.mesh import (ProductionMesh, axis_map_for,
                                     make_host_mesh, make_production_mesh,
                                     make_shard_ctx)
from repro_torch.launch.variants import apply_variant
from repro_torch.sharding import ctx as tctx
from repro_torch.sharding import rules

ARCHS = list_archs()
MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}
RULE_VARIANTS = ("baseline", "tp_only_weights", "legacy_tp",
                 "fsdp_over_pod", "padded_heads")


def _duck_mesh(name):
    shape, names = MESHES[name]
    return SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _flat(tree, prefix=""):
    """The reference's nested spec tree -> {dotted key: tuple}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = tuple(v) if isinstance(v, P) else v
    return out


@pytest.fixture(scope="module")
def ref_params():
    """The reference's abstract params per config (cached; eval_shape)."""
    cache = {}

    def get(cfg):
        if cfg not in cache:
            cache[cfg] = jspecs.abstract_params(cfg)
        return cache[cfg]
    return get


@pytest.fixture(scope="module")
def port_params():
    cache = {}

    def get(cfg):
        if cfg not in cache:
            cache[cfg] = specs.abstract_params(cfg)
        return cache[cfg]
    return get


@pytest.fixture(autouse=True)
def named_is_the_spec(monkeypatch):
    """The reference's make_shardings wraps its specs in NamedSharding,
    which needs a real mesh: keep the spec trees."""
    monkeypatch.setattr(jsteps, "_named", lambda mesh, tree: tree)


def _both_shardings(arch, shape_name, mesh_name, variant, ref_params,
                    port_params, *, inputs: bool):
    shape, jshape = INPUT_SHAPES[shape_name], J_SHAPES[shape_name]
    with jvariants.apply_variant(variant):
        jcfg = jspecs.variant_for_shape(j_get_config(arch), jshape)
        jctx_ = jmesh.make_shard_ctx(_duck_mesh(mesh_name))
        jin = jspecs.input_specs(jcfg, jshape) if inputs else {}
        want = jsteps.make_shardings(
            jcfg, jshape, jctx_, ref_params(jcfg),
            batch_abs=jin.get("batch"), cache_abs=jin.get("cache"))
    with apply_variant(variant):
        cfg = specs.variant_for_shape(get_config(arch), shape)
        ctx = make_shard_ctx(make_production_mesh(
            multi_pod=mesh_name == "pod2"))
        tin = specs.input_specs(cfg, shape) if inputs else {}
        got = steps.make_shardings(
            cfg, shape, ctx, port_params(cfg),
            batch_abs=tin.get("batch"), cache_abs=tin.get("cache"))
    return got, want


@pytest.mark.parametrize("variant", RULE_VARIANTS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_equal_reference(arch, mesh_name, variant,
                                             ref_params, port_params):
    got, want = _both_shardings(arch, "train_4k", mesh_name, variant,
                                ref_params, port_params, inputs=False)
    assert got["params"] == _flat(want["params"])
    assert got["opt"]["m"] == got["opt"]["v"] == got["params"]
    assert got["opt"]["t"] == tuple(want["opt"]["t"]) == ()


@pytest.mark.parametrize("variant", ("baseline", "ring_cache"))
@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_reference(arch, shape_name, variant,
                                               ref_params, port_params):
    for mesh_name in MESHES:
        got, want = _both_shardings(arch, shape_name, mesh_name, variant,
                                    ref_params, port_params, inputs=True)
        for part in ("batch", "cache"):
            assert (part in got) == (part in want)
            if part not in got:
                continue
            w = _flat(want[part])
            g = dict(got[part])
            if part == "cache":
                assert g.pop("len") is None and w.pop("len") == ()
            assert g == w, (mesh_name, part)
        if shape_name == "long_500k" and variant == "baseline" and \
                "k" in got.get("cache", {}):
            # batch 1: the cache's sequence dim over dp, not its batch
            dp = "data" if mesh_name == "pod1" else ("pod", "data")
            assert got["cache"]["k"][1:3] == (None, dp)


def _divisible(tree, spec_tree, sizes):
    for key, x in tree.items():
        if isinstance(x, dict):
            _divisible(x, spec_tree[key], sizes)
            continue
        if not hasattr(x, "shape"):
            continue
        spec = spec_tree[key]
        for dim, axes in enumerate(spec):
            if axes is None:
                continue
            axes = (axes,) if isinstance(axes, str) else axes
            total = int(np.prod([sizes[a] for a in axes]))
            assert x.shape[dim] % total == 0, (key, x.shape, spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_specs_always_divisible(arch, port_params):
    """tests/test_sharding.py's property on the port's own trees, params,
    batch and cache, on both meshes."""
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        sizes = dict(zip(mesh.axis_names, mesh.shape))
        ctx = make_shard_ctx(mesh)
        for shape_name, shape in INPUT_SHAPES.items():
            cfg = specs.variant_for_shape(get_config(arch), shape)
            inp = specs.input_specs(cfg, shape)
            params = port_params(cfg)
            sh = steps.make_shardings(cfg, shape, ctx, params,
                                      batch_abs=inp.get("batch"),
                                      cache_abs=inp.get("cache"))
            _divisible(params, sh["params"], sizes)
            for part in ("batch", "cache"):
                if part in sh:
                    _divisible(inp[part], sh[part], sizes)
                    for key, spec in sh[part].items():
                        if spec is not None:
                            assert rules.local_shape(
                                inp[part][key].shape, spec, mesh)


def test_production_mesh_and_ctx_equal_reference():
    for name, multi_pod in (("pod1", False), ("pod2", True)):
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert isinstance(mesh, ProductionMesh)
        assert (mesh.shape, mesh.axis_names) == MESHES[name]
        for over_pod in (False, True):
            jmesh.FSDP_OVER_POD = over_pod
            from repro_torch.launch import mesh as tmesh
            tmesh.FSDP_OVER_POD = over_pod
            try:
                assert axis_map_for(mesh) == jmesh.axis_map_for(
                    _duck_mesh(name))
                c, jc = make_shard_ctx(mesh), jmesh.make_shard_ctx(
                    _duck_mesh(name))
                assert (c.axis_map, c.tp_size, c.dp_size) == \
                    (jc.axis_map, jc.tp_size, jc.dp_size)
                # a duck-typed mesh, as the reference's tests use
                d = make_shard_ctx(_duck_mesh(name))
                assert (d.axis_map, d.tp_size, d.dp_size) == \
                    (jc.axis_map, jc.tp_size, jc.dp_size)
            finally:
                jmesh.FSDP_OVER_POD = False
                tmesh.FSDP_OVER_POD = False
    host = make_shard_ctx(make_host_mesh("cpu"))
    assert host.axis_map == {"dp": ("data",), "fsdp": ("data",),
                             "sp": ("data",)} and host.dp_size == 1


def test_local_shape_and_sharding_package():
    mesh = make_production_mesh(multi_pod=True)
    assert rules.local_shape((30, 576, 1536), (None, ("pod", "data"),
                                               "model"), mesh) == \
        (30, 18, 96)
    assert rules.local_shape((7,), (), mesh) == (7,)
    with pytest.raises(ValueError, match="divide"):
        rules.local_shape((10,), ("model",), mesh)
    import repro_torch.sharding as pkg
    assert {"ShardCtx", "use_sharding", "shard_act", "current_ctx",
            "param_specs", "batch_specs", "cache_specs"} <= set(dir(pkg))
    assert tctx.current_ctx() is None
    ctx = make_shard_ctx(mesh)
    with tctx.use_sharding(ctx) as c:
        assert tctx.current_ctx() is c is ctx
    assert tctx.current_ctx() is None


# ---------------------------------------------------- resolve and act_spec
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

_NAMES = st.sampled_from([None, "dp", "tp", "fsdp", "sp", "nope"])


def _ref_hint(jc, shape, logical):
    """The spec the reference's shard_act hands with_sharding_constraint
    (NamedSharding and the constraint replaced by recorders)."""
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.sharding, "NamedSharding",
                   lambda mesh, spec: spec)
        mp.setattr(jax.lax, "with_sharding_constraint",
                   lambda x, spec: seen.setdefault("spec", spec))
        jctx.shard_act(jax.ShapeDtypeStruct(shape, np.float32), *logical)
    return tuple(seen["spec"])


@settings(max_examples=60, deadline=None)
@given(st.sampled_from(list(MESHES)),
       st.lists(st.sampled_from([1, 2, 3, 8, 16, 24, 32, 48, 64, 96]),
                min_size=1, max_size=4),
       st.data())
def test_resolve_and_act_spec_equal_reference(mesh_name, shape, data):
    logical = data.draw(st.lists(_NAMES, min_size=len(shape),
                                 max_size=len(shape)))
    jc = jmesh.make_shard_ctx(_duck_mesh(mesh_name))
    c = make_shard_ctx(make_production_mesh(multi_pod=mesh_name == "pod2"))
    assert c.resolve(*logical) == tuple(jc.resolve(*logical))
    shape = tuple(shape)
    with jctx.use_sharding(jc):
        want = _ref_hint(jc, shape, logical)
    assert tctx.act_spec(shape, *logical, ctx=c) == want
    with tctx.use_sharding(c):
        assert tctx.act_spec(shape, *logical) == want
        x = torch.zeros(shape)
        assert tctx.shard_act(x, *logical) is x
    assert tctx.act_spec(shape, *logical) is None
