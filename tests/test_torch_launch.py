"""The port's dry-run stack (``launch/specs.py``, ``launch/variants.py``,
``launch/dryrun.py``, B9's meta route) against the JAX package, on the
CPU.

The reference's ``repro.launch.dryrun`` sets XLA_FLAGS for 512 host
devices when imported, so it is never imported here: its record keys and
its ``_model_flops`` formula are restated below.  Contracts:
* ``model_flops`` equals the reference's formula on ``repro``'s configs;
  ``input_specs``' shapes and dtypes equal the reference's for all archs
  x shapes (the port's cache ``len`` is the host int 0);
  ``concrete_inputs`` is bitwise the reference's at reduced configs;
  ``variant_for_shape`` gives the reference's config;
* the 26 variants under the reference's names; inside each, every knob
  equals the reference's inside its own, and on exit every knob is
  restored;
* twins of ``tests/test_variants.py`` (ring cache, minremat,
  microbatches, remat group), each side under its own ``apply_variant``,
  at ``smollm-135m.reduced()`` with that file's tolerances; ``moe_grouped``
  under a context with dp 4 against the reference with ``MOE_GROUPS = 4``:
  the same expert choices, outputs within f32 round-off;
* ``run_one(..., device="cpu")`` for smollm-135m, 4 shapes x pod1/pod2:
  ``ok``, the reference's keys, ratios in (0, 1], and
  ``mem.argument_size_in_bytes`` equal to the sum over the reference's
  abstract leaves of their per-device shard under the reference's specs;
* B9's meta route returns the output's shape and logs its formula.
"""
import dataclasses
import json
import math
import subprocess
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.configs import base as jbase
from repro.configs.registry import get_config as j_get_config
from repro.launch import mesh as jmesh
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro.launch import variants as jvariants
from repro.models import attention as jattn
from repro.models import ffn as jffn
from repro.models import lm as jlm
from repro.optim.optimizers import sgd as jsgd
from repro.sharding import rules as jrules

from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.convert import lm_params_from_jax, params_from_jax
from repro_torch.kernels import window_attention as wa
from repro_torch.launch import dryrun, specs, steps, variants
from repro_torch.launch import mesh as tmesh
from repro_torch.models import attention as tattn
from repro_torch.models import ffn as tffn
from repro_torch.models import lm
from repro_torch.optim.optimizers import sgd
from repro_torch.sharding import rules as trules
from repro_torch.sharding.ctx import ShardCtx, use_sharding

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list_archs()
# the reference's dry-run record (src/repro/launch/dryrun.py run_one)
REF_RECORD_KEYS = (
    "arch", "shape", "mesh", "variant", "kind", "ok", "params",
    "active_params", "model_flops", "lower_s", "compile_s",
    "xla_flops_raw", "xla_bytes_raw", "mem", "flops_per_device",
    "bytes_per_device", "collectives", "collective_bytes_per_device",
    "compute_term_s", "memory_term_s", "collective_term_s", "dominant",
    "chips", "useful_flop_ratio", "total_s")
SMALL = {"train_4k": InputShape("train_4k", 24, 2, "train"),
         "prefill_32k": InputShape("prefill_32k", 24, 2, "prefill"),
         "decode_32k": InputShape("decode_32k", 24, 2, "decode"),
         "long_500k": InputShape("long_500k", 40, 1, "decode")}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's parallel workers would otherwise
    oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _j_shape(shape: InputShape):
    return jbase.InputShape(shape.name, shape.seq_len, shape.global_batch,
                            shape.kind)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield ".".join(path), tree


# ------------------------------------------------------------------ shapes
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_variant_for_shape_equal_reference(arch):
    for name, shape in INPUT_SHAPES.items():
        jshape = jbase.INPUT_SHAPES[name]
        for pad in (None, 16):
            specs.PAD_HEADS_MULTIPLE = jspecs.PAD_HEADS_MULTIPLE = pad
            try:
                cfg = specs.variant_for_shape(get_config(arch), shape)
                jcfg = jspecs.variant_for_shape(j_get_config(arch), jshape)
            finally:
                specs.PAD_HEADS_MULTIPLE = jspecs.PAD_HEADS_MULTIPLE = None
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            # the reference's _model_flops, restated
            n = jcfg.active_param_count()
            tokens = jshape.global_batch * (
                jshape.seq_len if jshape.kind != "decode" else 1)
            want = (6.0 if jshape.kind == "train" else 2.0) * n * tokens
            assert dryrun.model_flops(cfg, shape) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch):
    for ring in (False, True):
        lm.RING_CACHE = jlm.RING_CACHE = ring
        try:
            for name, shape in INPUT_SHAPES.items():
                cfg = specs.variant_for_shape(get_config(arch), shape)
                jcfg = jspecs.variant_for_shape(j_get_config(arch),
                                                jbase.INPUT_SHAPES[name])
                got = dict(_leaves(specs.input_specs(cfg, shape)))
                want = dict(_leaves(jspecs.input_specs(
                    jcfg, jbase.INPUT_SHAPES[name])))
                assert set(got) == set(want)
                for key, x in got.items():
                    w = want[key]
                    if key == "cache.len":
                        assert x == 0 and w.shape == ()
                        continue
                    assert x.device.type == "meta"
                    assert tuple(x.shape) == tuple(w.shape), key
                    assert str(x.dtype).split(".")[-1] == \
                        np.dtype(w.dtype).name, key
        finally:
            lm.RING_CACHE = jlm.RING_CACHE = False


@pytest.mark.parametrize("arch", ARCHS)
def test_concrete_inputs_bitwise_reference(arch):
    cfg = get_config(arch).reduced()
    jcfg = j_get_config(arch).reduced()
    for name, shape in SMALL.items():
        if cfg.n_image_tokens and shape.seq_len <= cfg.n_image_tokens:
            shape = dataclasses.replace(shape,
                                        seq_len=cfg.n_image_tokens + 8)
        got = dict(_leaves(specs.concrete_inputs(
            specs.variant_for_shape(cfg, shape), shape)))
        want = dict(_leaves(jspecs.concrete_inputs(
            jspecs.variant_for_shape(jcfg, _j_shape(shape)),
            _j_shape(shape))))
        assert set(got) == set(want)
        for key, x in got.items():
            if key == "cache.len":
                assert x == int(want[key])
                continue
            w = np.asarray(want[key])
            assert x.dtype in (torch.float32, torch.int32), key
            assert np.array_equal(x.numpy(), w), key


def test_abstract_params_are_init_params_shapes():
    cfg = get_config("hymba-1.5b").reduced()
    meta = specs.abstract_params(cfg)
    real = lm.init_params(cfg, device="cpu")
    assert list(meta) == list(real)
    for k, x in meta.items():
        assert x.device.type == "meta"
        assert (x.shape, x.dtype) == (real[k].shape, real[k].dtype), k


# ----------------------------------------------------------------- variants
# the port's knob -> the reference's
KNOBS = [((tattn, "DENSE_MAX"), (jattn, "DENSE_MAX")),
         ((tattn, "KV_CHUNK"), (jattn, "KV_CHUNK")),
         ((tattn, "SCORE_DTYPE"), (jattn, "SCORE_DTYPE")),
         ((lm, "LOSS_CHUNK"), (jlm, "LOSS_CHUNK")),
         ((lm, "REMAT_POLICY"), (jlm, "REMAT_POLICY")),
         ((lm, "REMAT_GROUP"), (jlm, "REMAT_GROUP")),
         ((lm, "RING_CACHE"), (jlm, "RING_CACHE")),
         ((steps, "MICROBATCHES"), (jsteps, "MICROBATCHES")),
         ((steps, "GRAD_ACC_DTYPE"), (jsteps, "GRAD_ACC_DTYPE")),
         ((trules, "FSDP_ENABLED"), (jrules, "FSDP_ENABLED")),
         ((trules, "HEAD_AWARE_TP"), (jrules, "HEAD_AWARE_TP")),
         ((tmesh, "FSDP_OVER_POD"), (jmesh, "FSDP_OVER_POD")),
         ((specs, "PAD_HEADS_MULTIPLE"), (jspecs, "PAD_HEADS_MULTIPLE")),
         ((tffn, "MOE_GROUPS"), (jffn, "MOE_GROUPS"))]


def _knobs():
    return ([getattr(m, a) for (m, a), _ in KNOBS],
            [getattr(m, a) for _, (m, a) in KNOBS])


def test_variant_names_equal_reference():
    assert list(variants.VARIANTS) == list(jvariants.VARIANTS)
    assert len(variants.VARIANTS) == 26


@pytest.mark.parametrize("name", list(jvariants.VARIANTS))
def test_variant_sets_the_reference_knobs_and_restores(name):
    before, jbefore = _knobs()
    assert before == jbefore
    loss, jloss = lm.train_loss, jlm.train_loss
    with variants.apply_variant(name), jvariants.apply_variant(name):
        inside, jinside = _knobs()
        assert inside == jinside, name
        assert (lm.train_loss is loss) == (jlm.train_loss is jloss)
        touched = {a for _, a in variants.knobs_touched(name)}
        for ((_, attr), _), old, new in zip(KNOBS, before, inside):
            assert (old != new) <= (attr in touched), attr
    assert _knobs() == (before, jbefore)
    assert lm.train_loss is loss
    with pytest.raises(RuntimeError):      # restored on an error too
        with variants.apply_variant(name):
            raise RuntimeError
    assert _knobs() == (before, jbefore) and lm.train_loss is loss


@pytest.fixture(scope="module")
def smol():
    """smollm-135m reduced (f32): the reference's weights and the port's
    bit-for-bit copy."""
    jcfg = j_get_config("smollm-135m").reduced()
    cfg = get_config("smollm-135m").reduced()
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return cfg, jcfg, tp, jp


def _tokens(seed, shape, hi=100):
    return np.random.default_rng(seed).integers(0, hi, shape)


def test_ring_cache_twin(smol):
    """tests/test_variants.py::test_ring_cache_matches_full_cache on the
    port, each side under its own ring_cache variant."""
    cfg0, jcfg0, tp, jp = smol
    cfg = dataclasses.replace(cfg0, attention="sliding_window", window=8)
    jcfg = dataclasses.replace(jcfg0, attention="sliding_window", window=8)
    T = 20
    toks = _tokens(1, (2, T), cfg.vocab_size)

    def rollout(ring: bool):
        with variants.apply_variant("ring_cache" if ring else "baseline"):
            c = lm.init_decode_cache(cfg, 2, cfg.window if ring else T,
                                     device="cpu")
            return [_np(lm.decode_step(tp, cfg, torch.as_tensor(
                toks[:, t]), c)[0]) for t in range(T)]

    with jvariants.apply_variant("ring_cache"):
        c = jlm.init_decode_cache(jcfg, 2, jcfg.window)
        step = jax.jit(lambda p, tk, cc: jlm.decode_step(p, jcfg, tk, cc))
        want = []
        for t in range(T):
            lg, c = step(jp, jnp.asarray(toks[:, t], jnp.int32), c)
            want.append(np.asarray(lg, np.float32))
    full, ring = rollout(False), rollout(True)
    for a, b, w in zip(full, ring, want):
        np.testing.assert_allclose(a, b, atol=2e-3, rtol=1e-3)
        np.testing.assert_allclose(b, w, atol=2e-3, rtol=1e-3)


def _loss_and_grads(tp, cfg, batch):
    return steps.value_and_grad(lambda p, b: lm.train_loss(p, cfg, b),
                                tp, batch)


def test_minremat_twin(smol):
    cfg, jcfg, tp, jp = smol
    toks = _tokens(2, (2, 16))
    labels = _tokens(3, (2, 16))
    batch = {"tokens": torch.as_tensor(toks),
             "labels": torch.as_tensor(labels)}
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32),
              "labels": jnp.asarray(labels, jnp.int32)}
    l0, g0 = _loss_and_grads(tp, cfg, batch)
    with variants.apply_variant("minremat"):
        l1, g1 = _loss_and_grads(tp, cfg, batch)
    with jvariants.apply_variant("minremat"):
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p: jlm.train_loss(p, jcfg, jbatch, remat=True)))(jp)
    jg = params_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    for loss in (float(l1), float(jl)):
        assert float(l0) == pytest.approx(loss, rel=1e-5)
    for k in g0:
        np.testing.assert_allclose(_np(g0[k]), _np(g1[k]), atol=1e-4)
        np.testing.assert_allclose(_np(g1[k]), _np(jg[k]), atol=1e-4)


def test_microbatch_twin(smol):
    """micro8 on a batch of 8: the port's against its own full batch and
    against the reference's micro8 step (sgd), at 3e-3."""
    cfg, jcfg, tp, jp = smol
    toks, labels = _tokens(4, (8, 16)), _tokens(5, (8, 16))
    batch = {"tokens": torch.as_tensor(toks),
             "labels": torch.as_tensor(labels)}
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32),
              "labels": jnp.asarray(labels, jnp.int32)}
    opt, jopt = sgd(), jsgd()
    step1, _ = steps.make_train_step(cfg, opt)
    p1, _, l1 = step1(tp, opt.init(tp), batch, 0.1)
    with variants.apply_variant("micro8"):
        step8, _ = steps.make_train_step(cfg, opt)
        p8, _, l8 = step8(tp, opt.init(tp), batch, 0.1)
    with jvariants.apply_variant("micro8"):
        jstep, _ = jsteps.make_train_step(jcfg, jopt)
        jp8, _, jl8 = jax.jit(jstep)(jp, jopt.init(jp), jbatch,
                                     jnp.float32(0.1))
    jp8 = params_from_jax(jax.tree_util.tree_map(np.asarray, jp8))
    assert float(l1) == pytest.approx(float(l8), rel=1e-4)
    assert float(l8) == pytest.approx(float(jl8), rel=1e-4)
    for k in p1:
        np.testing.assert_allclose(_np(p1[k]), _np(p8[k]), atol=3e-3)
        np.testing.assert_allclose(_np(p8[k]), _np(jp8[k]), atol=3e-3)


def test_remat_group_twin():
    """remat2_micro8's groups of 8 layers on an 8-layer reduced smollm:
    the loss of the grouped remat equals the ungrouped one and the
    reference's grouped one (rel 1e-6, tests/test_variants.py), grads
    finite."""
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                              n_layers=8)
    jcfg = dataclasses.replace(j_get_config("smollm-135m").reduced(),
                               n_layers=8)
    jp = jlm.init_params(jax.random.PRNGKey(1), jcfg)
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    toks, labels = _tokens(6, (2, 16)), _tokens(7, (2, 16))
    batch = {"tokens": torch.as_tensor(toks),
             "labels": torch.as_tensor(labels)}
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32),
              "labels": jnp.asarray(labels, jnp.int32)}
    l0, _ = _loss_and_grads(tp, cfg, batch)
    with variants.apply_variant("remat2_micro8"):
        assert lm.REMAT_GROUP == 8
        l1, g1 = _loss_and_grads(tp, cfg, batch)
    with jvariants.apply_variant("remat2_micro8"):
        jl = jax.jit(lambda p: jlm.train_loss(p, jcfg, jbatch,
                                              remat=True))(jp)
    assert float(l0) == pytest.approx(float(l1), rel=1e-6)
    assert float(l1) == pytest.approx(float(jl), rel=1e-6)
    assert all(torch.isfinite(g).all() for g in g1.values())


def test_moe_grouped_twin(monkeypatch):
    """moe_grouped under a context with dp 4 is four dispatch groups: the
    reference with MOE_GROUPS = 4 on the same input."""
    cfg = get_config("granite-moe-1b-a400m").reduced()
    jp = jlm.init_params(jax.random.PRNGKey(2), j_get_config(
        "granite-moe-1b-a400m").reduced())
    pm = {k: v for k, v in jp["blocks"]["moe"].items() if k != "norm"}
    pm = jax.tree_util.tree_map(lambda a: a[0], pm)
    tpm = params_from_jax(jax.tree_util.tree_map(np.asarray, pm))
    x = np.random.default_rng(8).normal(size=(2, 64, cfg.d_model)).astype(
        np.float32)
    kw = dict(top_k=cfg.moe.top_k, capacity_factor=cfg.moe.capacity_factor,
              kind=cfg.ffn_kind)
    monkeypatch.setattr(jffn, "MOE_GROUPS", 4)
    jo, ja = jffn.apply_moe(pm, jnp.asarray(x), **kw)
    logits = jnp.asarray(x).reshape(4, 32, -1) @ pm["router"]
    jchoice = np.asarray(jax.lax.top_k(jax.nn.softmax(logits, -1),
                                       cfg.moe.top_k)[1])
    seen = []
    real = tffn._top_k

    def recorded(probs, k):
        out = real(probs, k)
        seen.append(out[1])
        return out
    monkeypatch.setattr(tffn, "_top_k", recorded)
    with use_sharding(ShardCtx(dp_size=4)), \
            variants.apply_variant("moe_grouped"):
        assert tffn.MOE_GROUPS == -1
        to, ta = tffn.apply_moe(tpm, torch.as_tensor(x), **kw)
    assert np.array_equal(seen[0].numpy(), jchoice)
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-5, rtol=0)
    assert abs(float(ta) - float(ja)) <= 1e-6
    # outside a context -1 is one group
    with variants.apply_variant("moe_grouped"):
        tffn.apply_moe(tpm, torch.as_tensor(x), **kw)
    assert seen[-1].shape[0] == 1


# ------------------------------------------------------------------ dry-run
def _duck_mesh(multi_pod):
    shape, names = ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
        else ((16, 16), ("data", "model"))
    return SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _ref_argument_bytes(shape_name: str, multi_pod: bool, monkeypatch):
    """Σ over the reference's abstract leaves of their per-device shard
    under the reference's specs (the tokens of decode replicated; its
    int32 ``len`` left out: the port's is a host int)."""
    monkeypatch.setattr(jsteps, "_named", lambda mesh, tree: tree)
    mesh = _duck_mesh(multi_pod)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    shape = jbase.INPUT_SHAPES[shape_name]
    cfg = jspecs.variant_for_shape(j_get_config("smollm-135m"), shape)
    ctx = jmesh.make_shard_ctx(mesh)
    params = jspecs.abstract_params(cfg)
    ins = jspecs.input_specs(cfg, shape)
    if shape.kind == "train":
        _, opt = jsteps.make_train_step(cfg)
        sh = jsteps.make_shardings(cfg, shape, ctx, params,
                                   batch_abs=ins["batch"])
        pairs = [(params, sh["params"]),
                 (jax.eval_shape(opt.init, params), sh["opt"]),
                 (ins["batch"], sh["batch"])]
    elif shape.kind == "prefill":
        sh = jsteps.make_shardings(cfg, shape, ctx, params,
                                   batch_abs=ins["batch"])
        pairs = [(params, sh["params"]), (ins["batch"], sh["batch"])]
    else:
        sh = jsteps.make_shardings(cfg, shape, ctx, params,
                                   cache_abs=ins["cache"])
        cache = {k: v for k, v in ins["cache"].items() if k != "len"}
        pairs = [(params, sh["params"]), ({"t": ins["tokens"]}, {"t": P()}),
                 (cache, {k: sh["cache"][k] for k in cache})]
    total = 0
    for tree, spec_tree in pairs:
        xs = jax.tree_util.tree_leaves(tree)
        ss = jax.tree_util.tree_leaves(spec_tree,
                                       is_leaf=lambda s: isinstance(s, P))
        assert len(xs) == len(ss)
        for x, spec in zip(xs, ss):
            n = 1
            for dim, size in enumerate(x.shape):
                axes = spec[dim] if dim < len(spec) else None
                axes = (axes,) if isinstance(axes, str) else (axes or ())
                n *= size // math.prod(sizes[a] for a in axes)
            total += n * np.dtype(x.dtype).itemsize
    return total


@pytest.fixture(scope="module")
def smol_records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    return {(s, mp): dryrun.run_one("smollm-135m", s, multi_pod=mp,
                                    device="cpu", force=True,
                                    results_dir=out)
            for mp in (False, True) for s in INPUT_SHAPES}


@pytest.mark.parametrize("multi_pod", (False, True))
@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
def test_run_one_record(smol_records, shape_name, multi_pod, monkeypatch):
    rec = smol_records[(shape_name, multi_pod)]
    assert rec["ok"], rec.get("traceback")
    assert set(REF_RECORD_KEYS) <= set(rec)
    assert rec["mesh"] == ("pod2" if multi_pod else "pod1")
    assert rec["chips"] == (512 if multi_pod else 256)
    assert 0 < rec["useful_flop_ratio"] <= 1
    assert rec["dominant"] in ("compute", "memory")
    assert rec["fits_one_h100"] == "not measured (CPU)"
    assert isinstance(rec["collective_term_s"], str)
    assert rec["mem"]["argument_size_in_bytes"] == _ref_argument_bytes(
        shape_name, multi_pod, monkeypatch)
    if shape_name == "prefill_32k":          # B9 on meta, once a layer
        cfg = get_config("smollm-135m")
        assert rec["b9_meta_calls"] == cfg.n_layers
        assert rec["kernel_flops"] == cfg.n_layers * wa.attention_ops(
            32, 32768, cfg.n_heads, cfg.head_dim, 32768)
    else:
        assert rec["b9_meta_calls"] == 0
    other = smol_records[(shape_name, not multi_pod)]
    assert other["torch_flops"] == rec["torch_flops"]   # one shared trace


def test_window_attention_meta_route():
    q = torch.empty((2, 100, 4, 32), device="meta")
    k = torch.empty((2, 100, 2, 32), device="meta")
    wa.META_CALLS.clear()
    o = wa.window_attention(q, k, k, window=16)
    assert o.device.type == "meta" and o.shape == q.shape
    assert wa.META_CALLS == [(2, 100, 4, 2, 32, 16)]
    assert wa.attention_ops(2, 100, 4, 32, 16) == \
        4 * 2 * 4 * 32 * (16 * 17 // 2 + 84 * 16)
    launches = wa.KERNEL.launches
    wa.window_attention(q, k, k, window=16)
    assert wa.KERNEL.launches == launches       # meta launches nothing
    wa.META_CALLS.clear()


def test_dryrun_cli_and_no_item13(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    assert dryrun.main(["--arch", "smollm-135m", "--shape", "long_500k",
                        "--multi-pod", "--variant", "ring_cache",
                        "--device", "cpu"]) == 0
    rec = json.loads(
        (tmp_path / "smollm-135m__long_500k__pod2__ring_cache.json")
        .read_text())
    assert rec["ok"] and rec["variant"] == "ring_cache"
    hits = subprocess.run(["grep", "-rn", "item 13",
                           str(ROOT / "src" / "repro_torch")],
                          capture_output=True, text=True).stdout
    assert hits == ""
