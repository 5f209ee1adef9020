"""Federated LM training on the port against the JAX package, on the CPU.

Inputs are made with numpy from a seed; the reference's weights cross to
the port bit for bit (``convert.lm_params_from_jax``) and its batch draws
are injected through ``train.main``'s ``batch_indices`` seam.  Contracts:
* ``data/lm_stream``, ``optim/schedules``, ``client_unigrams``: bitwise
  copies; ``utils/tree``: the same counts and paths, sums within f32
  round-off;
* ``softmax_cross_entropy`` and the three training attention routes
  (dense, chunked, windowed), forward and gradients, f32: within 1e-5 of
  the reference's (gradients relative to each one's largest);
* ``train_loss`` of the reduced smollm, f32 (full attention, a sliding
  window through the windowed route, the chunked route with a chunked
  loss): loss and gradients within 1e-6 and 1e-5 relative of
  ``jax.value_and_grad``'s; remat on and off (every policy, groups)
  bitwise;
* one ``adamw`` / ``sgd`` update from the initial state and the same
  grads: bitwise; two more within f32 round-off;
* ``make_train_step`` with MICROBATCHES 1 and 2 (SGD, so the update is
  linear in the gradient): loss within 1e-6, params within 1e-5;
* ``train.main`` against ``repro.launch.train.main`` (reduced smollm, 4
  clients, 3 rounds, FedGS under LN): sets and counts bitwise; val_loss
  within 1e-4 round by round from the reference's state (a resumed run
  from the reference's checkpoint).  Free-running, Adam's first step
  (``lr·g/(|g| + eps)``) turns the f32 round-off of gradients near 1e-9
  into parameter gaps near 1e-4 and the val_loss gap grows to ~5e-4 by
  round 2 (ROADMAP Queue C): it is printed, not held;
* a ``--ckpt`` resume equals the unbroken run, bitwise.
"""
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.ckpt import save_checkpoint as jax_save_checkpoint
from repro.configs.registry import REGISTRY as JAX_REGISTRY
from repro.data import lm_stream as jstream
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.utils import tree as jtree

from repro_torch.configs.registry import get_config
from repro_torch.convert import lm_params_from_jax, params_from_jax
from repro_torch.data import lm_stream as tstream
from repro_torch.kernels import ops
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import lm
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.utils import tree as ttree

ARCH = "smollm-135m"
MAIN_ARGV = ["--arch", ARCH, "--reduced", "--clients", "4", "--rounds", "3",
             "--mode", "LN", "--sampler", "fedgs", "--seed", "0"]
E, B, S = 4, 4, 64                  # train.py's defaults
N_SEQ = B * (S + 1) * 8 // (S + 1) - 1
VAL_BOUND = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's parallel workers would otherwise
    oversubscribe the cores (the reduced model's ops gain nothing from
    more)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _rel_close(got: dict, want: dict, rtol: float, what: str = ""):
    for k in want:
        g, w = _np(got[k]), _np(want[k])
        scale = float(np.abs(w).max()) + 1e-30
        err = float(np.abs(g - w).max())
        assert err <= rtol * scale, f"{what} {k}: {err} of {scale}"


def _tree_np(tree) -> dict:
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


# ------------------------------------------------------------ numpy copies
def test_lm_stream_copy_is_bitwise():
    for seed in (0, 3):
        np.testing.assert_array_equal(
            tstream.token_batches(512, 4, B * (S + 1) * 8, S, seed=seed),
            jstream.token_batches(512, 4, B * (S + 1) * 8, S, seed=seed))
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        pa, pb = (tstream.client_transition(97, 3, a),
                  jstream.client_transition(97, 3, b))
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(tstream.sample_stream(pa, 500, a),
                                      jstream.sample_stream(pb, 500, b))
    pools = tstream.token_batches(64, 3, 200, 9, seed=1)
    np.testing.assert_array_equal(ttrain.client_unigrams(pools, 64),
                                  jtrain.client_unigrams(pools, 64))


def test_schedules_are_the_reference_copy():
    for t in (0, 1, 7, 50, 200):
        assert tsched.constant(0.1)(t) == jsched.constant(0.1)(t)
        assert tsched.round_decay(0.1)(t) == jsched.round_decay(0.1)(t)
        assert tsched.cosine_warmup(0.1, 10, 100, 0.01)(t) == \
            jsched.cosine_warmup(0.1, 10, 100, 0.01)(t)


def test_tree_utils_match_reference():
    jcfg = JAX_REGISTRY[ARCH].reduced()
    pj = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    pj = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16)
                                if x.ndim > 1 else x, pj)
    pt = _tree_np(pj)
    assert ttree.param_count(pt) == jtree.param_count(pj)
    assert ttree.tree_bytes(pt) == jtree.tree_bytes(pj)
    jpaths = []
    jtree.map_with_path(lambda p, x: jpaths.append(p), pj)
    tpaths = []
    ttree.map_with_path(lambda p, x: tpaths.append(p), pt)
    assert sorted(tpaths) == sorted(jpaths)
    assert abs(float(ttree.global_norm(pt)) - float(jtree.global_norm(pj))) \
        <= 1e-5 * float(jtree.global_norm(pj))
    f32 = {k: v.float() for k, v in pt.items()}
    two = ttree.tree_add(f32, ttree.tree_scale(f32, 0.5), scale_b=2.0)
    assert all(torch.equal(two[k], f32[k] + 2.0 * (f32[k] * 0.5))
               for k in f32)
    zeros = ttree.tree_zeros_like(pt)
    assert all(z.dtype == pt[k].dtype and not z.any()
               for k, z in zeros.items())


# ------------------------------------------------------------------ layers
def test_softmax_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (3, 7))
    mask = rng.random((3, 7)) < 0.7
    want, jg = jax.value_and_grad(jlayers.softmax_cross_entropy)(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
    lt = torch.as_tensor(logits).requires_grad_(True)
    got = tlayers.softmax_cross_entropy(lt, torch.as_tensor(labels),
                                        torch.as_tensor(mask))
    (tg,) = torch.autograd.grad(got, [lt])
    assert abs(float(got) - float(want)) <= 1e-6
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-7, rtol=0)


ROUTES = [  # (route, seq, window, knobs)
    ("dense", 40, None, {}), ("dense", 40, 9, {}),
    ("chunked", 64, None, {"DENSE_MAX": 32, "KV_CHUNK": 16}),
    ("windowed", 64, 8, {"Q_CHUNK": 16})]


@pytest.mark.parametrize("route,s,window,knobs", ROUTES,
                         ids=[f"{r[0]}-w{r[2]}" for r in ROUTES])
def test_training_attention_routes_match_reference(route, s, window, knobs,
                                                   monkeypatch):
    """multihead_attention dispatches as the reference does and each
    route's output and gradients (q, k, v) match it in f32."""
    for name, value in knobs.items():
        monkeypatch.setattr(jattn, name, value)
        monkeypatch.setattr(tattn, name, value)
    called = []
    for fn in ("attend_dense", "attend_chunked_full", "attend_windowed"):
        orig = getattr(tattn, fn)
        monkeypatch.setattr(tattn, fn, lambda *a, _f=orig, _n=fn, **k: (
            called.append(_n), _f(*a, **k))[1])
    rng = np.random.default_rng(s)
    b, hq, hkv, d = 2, 4, 2, 32
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32)
               for h in (hq, hkv, hkv))
    w = rng.normal(size=(b, s, hq, d)).astype(np.float32)

    def jfn(q, k, v):
        o = jattn.multihead_attention(q, jattn._repeat_kv(k, 2),
                                      jattn._repeat_kv(v, 2), causal=True,
                                      window=window)
        return jnp.sum(o * w), o

    (_, jo), jg = jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.as_tensor(x).requires_grad_(True) for x in (q, k, v))
    to = tattn.multihead_attention(tq, tk, tv, causal=True, window=window)
    tg = torch.autograd.grad(torch.sum(to * torch.as_tensor(w)),
                             [tq, tk, tv])
    assert called == [{"dense": "attend_dense",
                       "chunked": "attend_chunked_full",
                       "windowed": "attend_windowed"}[route]]
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-5, rtol=0)
    _rel_close(dict(zip("qkv", tg)), dict(zip("qkv", jg)), 1e-5, route)


def test_prefill_route_refuses_gradients_on_the_cpu_too():
    q = torch.zeros(1, 8, 2, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.window_attention(q, q, q, window=4)
    with torch.no_grad():
        assert ops.window_attention(q, q, q, window=4).shape == q.shape


# ------------------------------------------------------------- train_loss
@pytest.fixture(scope="module")
def weights():
    jcfg = JAX_REGISTRY[ARCH].reduced()
    pj = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, get_config(ARCH).reduced(), pj, lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, pj))


def _batch(cfg, seed, b=2, s=64):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (b, s + 1))
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1                          # masked labels
    labels[1, 5] = -7
    return ({"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)},
            {"tokens": torch.as_tensor(toks[:, :-1]),
             "labels": torch.as_tensor(labels)})


VARIANTS = [("full", {}, {}),
            ("window", {"attention": "sliding_window", "window": 16},
             {"Q_CHUNK": 16}),
            ("chunked-loss", {}, {"DENSE_MAX": 32, "KV_CHUNK": 16,
                                  "LOSS_CHUNK": 32})]


@pytest.mark.parametrize("name,over,knobs", VARIANTS,
                         ids=[v[0] for v in VARIANTS])
def test_train_loss_and_grads_match_reference(weights, name, over, knobs,
                                              monkeypatch):
    import dataclasses
    jcfg, cfg, pj, pt = weights
    jcfg = dataclasses.replace(jcfg, **over)
    cfg = dataclasses.replace(cfg, **over)
    for key, value in knobs.items():
        mods = (jlm, lm) if key == "LOSS_CHUNK" else (jattn, tattn)
        for mod in mods:
            monkeypatch.setattr(mod, key, value)
    jb, tb = _batch(cfg, 1)
    lj, gj = jax.value_and_grad(
        lambda p: jlm.train_loss(p, jcfg, jb, remat=False))(pj)
    lt, gt = tsteps.value_and_grad(
        lambda p, b: lm.train_loss(p, cfg, b, remat=False), pt, tb)
    assert abs(float(lt) - float(lj)) <= 1e-6 * abs(float(lj))
    _rel_close(gt, _tree_np(gj), 1e-5, name)


@pytest.mark.parametrize("policy,group", [("dots", 1), ("nothing", 1),
                                          ("dots", 2)])
def test_remat_changes_no_bit(weights, policy, group, monkeypatch):
    _, cfg, _, pt = weights
    monkeypatch.setattr(lm, "REMAT_POLICY", policy)
    monkeypatch.setattr(lm, "REMAT_GROUP", group)
    _, tb = _batch(cfg, 2)
    a = tsteps.value_and_grad(
        lambda p, b: lm.train_loss(p, cfg, b, remat=False), pt, tb)
    b = tsteps.value_and_grad(
        lambda p, b: lm.train_loss(p, cfg, b, remat=True), pt, tb)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(a[1][k], b[1][k]) for k in pt)


# -------------------------------------------------------------- optimizers
def _opt_inputs(seed):
    rng = np.random.default_rng(seed)
    p = {"w": jnp.asarray(rng.normal(size=(6, 5)), jnp.bfloat16),
         "n": jnp.asarray(rng.normal(size=(5,)), jnp.float32),
         "u": jnp.asarray(rng.normal(size=(3, 4)), jnp.float32)}
    g = [{k: jnp.asarray(rng.normal(size=v.shape) * 10.0 ** rng.integers(
        -9, 1, v.shape), v.dtype) for k, v in p.items()} for _ in range(3)]
    return p, g


@pytest.mark.parametrize("make", [
    lambda m: m.adamw(), lambda m: m.adamw(weight_decay=0.1),
    lambda m: m.adamw(state_dtype=getattr(
        jnp if m is jopt else torch, "bfloat16")),
    lambda m: m.sgd(), lambda m: m.sgd(momentum=0.9)],
    ids=["adamw", "adamw-wd", "adamw-bf16-state", "sgd", "sgd-momentum"])
def test_optimizer_updates_are_bitwise(make):
    """One update from the initial state and the same grads (some entries
    near 1e-9, where Adam's normalisation is steepest) gives the
    reference's params and state bit for bit; two more stay within f32
    round-off (XLA contracts ``b·m + (1 − b)·g`` into one FMA once m is
    nonzero; eager PyTorch rounds the product).  SGD takes the f32 leaves
    only: its arithmetic runs in the params' dtype, and for a bf16 leaf
    XLA keeps ``lr·g`` (and ``beta·m``) in f32 inside the sum (its excess
    precision), where eager PyTorch rounds each to bf16 first; AdamW
    computes in f32 and casts once, so it takes the bf16 leaf too."""
    p, gs = _opt_inputs(0)
    jo, to = make(jopt), make(topt)
    if not isinstance(jo.init(p), dict) or "t" not in jo.init(p):
        p = {k: v for k, v in p.items() if v.dtype == jnp.float32}
        gs = [{k: g[k] for k in p} for g in gs]
    js, tp = jo.init(p), _tree_np(p)
    ts = to.init(tp)
    upd = jax.jit(jo.update)

    def state_leaves(j, t):
        if isinstance(j, dict) and "t" in j:
            assert int(t["t"]) == int(j["t"])
            return [(t[part], _tree_np(j[part])) for part in ("m", "v")]
        return [(t, _tree_np(j))] if j != () else []

    for i, g in enumerate(gs):
        p, js = upd(g, js, p, 3e-3)
        with torch.no_grad():
            tp, ts = to.update(_tree_np(g), ts, tp, 3e-3)
        pairs = [(tp, _tree_np(p))] + state_leaves(js, ts)
        for got, want in pairs:
            for k, v in want.items():
                assert got[k].dtype == v.dtype
                if i == 0:
                    assert torch.equal(got[k], v), k
                else:
                    np.testing.assert_allclose(_np(got[k]), _np(v),
                                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("micro", [1, 2])
def test_make_train_step_microbatches(weights, micro, monkeypatch):
    jcfg, cfg, pj, pt = weights
    monkeypatch.setattr(jsteps, "MICROBATCHES", micro)
    monkeypatch.setattr(tsteps, "MICROBATCHES", micro)
    jb, tb = _batch(cfg, 3, b=4, s=32)
    jstep, jo = jsteps.make_train_step(jcfg, jopt.sgd())
    tstep, to = tsteps.make_train_step(cfg, topt.sgd())
    jp, _, jl = jax.jit(jstep)(pj, jo.init(pj), jb, jnp.float32(0.5))
    tp, _, tl = tstep(pt, to.init(pt), tb, 0.5)
    assert abs(float(tl) - float(jl)) <= 1e-6
    _rel_close(tp, _tree_np(jp), 1e-5, f"micro={micro}")
    # the default optimizer: AdamW with bf16 moments
    step, opt = tsteps.make_train_step(cfg)
    new, state, loss = step(pt, opt.init(pt), tb, 1e-3)
    assert abs(float(loss) - float(tl)) <= 1e-6
    assert state["m"]["embed"].dtype == torch.bfloat16
    assert all(new[k].dtype == pt[k].dtype for k in pt)


def test_prefill_and_serve_steps_are_the_lm_entry_points(weights):
    _, cfg, _, pt = weights
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 8)))
    logits, cache = tsteps.make_prefill_step(cfg)(pt, {"tokens": toks})
    want, _ = lm.prefill(pt, cfg, {"tokens": toks})
    assert torch.equal(logits, want)
    cache = lm.init_decode_cache(cfg, 2, 9, device="cpu")
    _, full = lm.prefill(pt, cfg, {"tokens": toks}, max_len=9)
    out, _ = tsteps.make_serve_step(cfg)(pt, toks[:, -1], full)
    assert out.shape == (2, cfg.padded_vocab)


# -------------------------------------------------------------- train.main
def _jax_draws(round_sizes):
    """The reference's batch rows: key = PRNGKey(seed) (init_params uses it
    unsplit), then per selected client ``key, sub = split(key)`` and one
    randint per ``split(sub, E)`` key."""
    key, table = jax.random.PRNGKey(0), {}
    for t, m in enumerate(round_sizes):
        for j in range(m):
            key, sub = jax.random.split(key)
            table[t, j] = np.stack([np.asarray(jax.random.randint(
                kk, (B,), 0, N_SEQ)) for kk in jax.random.split(sub, E)])
    return table


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if '"round"' in line]


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory, monkeypatch_module):
    """repro.launch.train.main over 3 rounds: its per-round metrics, and
    (through a recording subclass of its ServerAggregator) each round's
    set and the params each round ends with, so the next starts from
    them."""
    d = tmp_path_factory.mktemp("ref")
    ends = []

    class Recording(jtrain.ServerAggregator):
        def apply(self, stacked, weights, sel, avail, t):
            out = super().apply(stacked, weights, sel, avail, t)
            ends.append((np.asarray(sel).tolist(), out))
            return out
    monkeypatch_module.setattr(jtrain, "ServerAggregator", Recording)
    with contextlib.redirect_stdout(io.StringIO()):
        _, counts = jtrain.main(MAIN_ARGV + ["--metrics-jsonl",
                                             str(d / "m.jsonl")])
    rec = _jsonl(d / "m.jsonl")
    return {"rounds": rec, "counts": counts, "ends": ends,
            "init": jlm.init_params(jax.random.PRNGKey(0),
                                    JAX_REGISTRY[ARCH].reduced()),
            "draws": _jax_draws([r["n_selected"] for r in rec])}


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_train_main_matches_reference(reference_runs, tmp_path):
    ref = reference_runs
    draws = ref["draws"]
    p0 = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, ref["init"]))
    free = []
    with contextlib.redirect_stdout(io.StringIO()):
        _, counts = ttrain.main(
            MAIN_ARGV + ["--device", "cpu"], init_params=p0,
            batch_indices=lambda t, j, k: draws[t, j],
            on_round=lambda i: free.append(i))
    assert [list(map(int, i["sel"])) for i in free] == \
        [sel for sel, _ in ref["ends"]]
    np.testing.assert_array_equal(counts, ref["counts"])
    gaps = [abs(i["val_loss"] - r["val_loss"])
            for i, r in zip(free, ref["rounds"])]
    print("free-running val_loss gaps per round:", gaps)
    assert gaps[0] <= VAL_BOUND
    # round by round from the reference's state: its params after round
    # t - 1 and the counts so far, written by its checkpoint writer,
    # resumed here
    for t in (1, 2):
        c = np.zeros(4)
        for sel, _ in ref["ends"][:t]:
            c[sel] += 1
        path = str(tmp_path / f"from{t}")
        jax_save_checkpoint(path, {"params": ref["ends"][t - 1][1],
                                   "counts": c,
                                   "round": np.asarray(t - 1, np.int64)})
        got = []
        with contextlib.redirect_stdout(io.StringIO()):
            ttrain.main([a if a != "3" else str(t + 1) for a in MAIN_ARGV] +
                        ["--device", "cpu", "--ckpt", path],
                        init_params=p0,
                        batch_indices=lambda tt, j, k: draws[tt, j],
                        on_round=lambda i: got.append(i))
        assert [i["t"] for i in got] == [t]
        assert list(map(int, got[0]["sel"])) == ref["ends"][t][0]
        assert abs(got[0]["val_loss"] - ref["rounds"][t]["val_loss"]) <= \
            VAL_BOUND, (t, got[0]["val_loss"], ref["rounds"][t]["val_loss"])


@pytest.mark.parametrize("sampler", ["fedgs", "uniform"])
def test_ckpt_resume_equals_the_unbroken_run(tmp_path, sampler,
                                             monkeypatch):
    """A checkpoint every 2 rounds (the launcher's 10, cut for time)."""
    monkeypatch.setattr(ttrain, "CKPT_EVERY", 2)
    argv = ["--arch", ARCH, "--reduced", "--clients", "4", "--local-steps",
            "1", "--batch", "2", "--seq", "16", "--sampler", sampler,
            "--device", "cpu"]
    runs = {}
    for name, parts in (("unbroken", (4,)), ("resumed", (2, 4))):
        sets = []
        path = str(tmp_path / name)
        with contextlib.redirect_stdout(io.StringIO()) as out:
            for rounds in parts:
                params, counts = ttrain.main(
                    argv + ["--rounds", str(rounds), "--ckpt", path],
                    on_round=lambda i: sets.append(list(map(int, i["sel"]))))
        runs[name] = (params, counts, sets, out.getvalue())
    (pa, ca, sa, _), (pb, cb, sb, text) = runs["unbroken"], runs["resumed"]
    assert "at round 2" in text
    assert sa == sb and np.array_equal(ca, cb)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert os.path.exists(tmp_path / "unbroken.npz")


def test_default_batch_indices_are_keyed_by_round_and_slot():
    a = ttrain.default_batch_indices(0, 3, 1, 31, E, B, "cpu")
    assert a.shape == (E, B) and a.dtype == torch.int64
    assert int(a.min()) >= 0 and int(a.max()) < 31
    assert torch.equal(a, ttrain.default_batch_indices(0, 3, 1, 31, E, B,
                                                       "cpu"))
    assert not torch.equal(a, ttrain.default_batch_indices(0, 3, 2, 31, E,
                                                           B, "cpu"))
    p = {"embed": torch.ones(2), "blocks.attn.wq": torch.zeros(1)}
    assert ttrain.nested(p) == {"embed": p["embed"], "blocks": {"attn": {
        "wq": p["blocks.attn.wq"]}}}
    assert ttrain.flattened(ttrain.nested(p)) == p
