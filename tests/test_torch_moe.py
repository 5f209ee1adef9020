"""The port's MoE family against the JAX package, on the CPU.

Inputs are made with numpy from a seed; the reference's weights cross to
the port bit for bit (``convert``).  Contracts:
* ``moe_capacity``: equal; the top-k choice takes the lowest index among
  equal probabilities, as ``jax.lax.top_k``;
* ``apply_moe`` against ``tests/test_models.py``'s per-token reference
  (no drops): atol 1e-4, rtol 1e-3 (that test's bound);
* ``apply_moe`` against ``repro.models.ffn.apply_moe`` in f32, with ample
  capacity and with capacity drops, with one and with two dispatch
  groups: output within 1e-5 (a dropped entry the reference keeps, or
  the other way, would move a token's output by a whole contribution),
  aux within 1e-6, gradients within 1e-5 of each leaf's largest;
* ``lm.train_loss`` of granite-moe and olmoe (reduced, f32) against the
  reference's ``jax.value_and_grad``: loss within 1e-6, gradients within
  1e-5 relative; ``prefill`` and ``decode_step`` within 1e-4;
* the ordered combine: each token's K contributions added from zero in
  ascending expert id, and its gradient the exact adjoint gather.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import REGISTRY as JAX_REGISTRY
from repro.models import ffn as jffn
from repro.models import lm as jlm

from repro_torch.configs.registry import get_config
from repro_torch.convert import lm_params_from_jax, params_from_jax
from repro_torch.launch import serve, steps
from repro_torch.models import ffn as tffn
from repro_torch.models import lm

from test_models import _naive_moe

ARCHS = ("granite-moe-1b-a400m", "olmoe-1b-7b")


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


def _moe_pair(seed: int, d: int, dff: int, e: int, kind: str):
    p = jffn.init_moe(jax.random.PRNGKey(seed), d, dff, e, kind, jnp.float32)
    return p, params_from_jax(jax.tree_util.tree_map(np.asarray, p))


def _rel_close(got: dict, want: dict, rtol: float, what: str):
    for k in want:
        g, w = _np(got[k]), _np(want[k])
        scale = float(np.abs(w).max()) + 1e-30
        err = float(np.abs(g - w).max())
        assert err <= rtol * scale, f"{what} {k}: {err} of {scale}"


# -------------------------------------------------------------- the pieces
def test_capacity_matches_reference():
    for t in (1, 2, 7, 64, 256, 4096):
        for e, k, f in ((4, 2, 1.25), (32, 8, 1.25), (64, 8, 1.0),
                        (4, 2, 0.25)):
            assert tffn.moe_capacity(t, e, k, f) == \
                jffn.moe_capacity(t, e, k, f)


def test_top_k_takes_the_lowest_index_among_ties():
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 3, (200, 16)).astype(np.float32) / 4
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 5)
    tv, ti = tffn._top_k(torch.as_tensor(probs), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_combine_sums_in_ascending_expert_order_and_is_its_gathers_adjoint():
    """_SumRows adds a token's rows from zero in the table's order (a
    reordered sum differs in the last bits on these values); the gather's
    backward is the sum and the sum's backward is the gather."""
    t, k, d = 5, 3, 4
    rng = np.random.default_rng(1)
    rows = torch.as_tensor(rng.permutation(np.repeat(np.arange(t), k)))
    table = torch.stack([torch.nonzero(rows == i).squeeze(1)
                         for i in range(t)])
    c = torch.as_tensor(rng.normal(size=(t * k, d)) * 10.0 ** rng.integers(
        -6, 6, (t * k, 1)), dtype=torch.float32)
    out = tffn._SumRows.apply(c, table, rows)
    want = torch.zeros(t, d)
    for j in range(k):
        want = want + c[table[:, j]]
    assert torch.equal(out, want)
    cd = c.double().requires_grad_(True)
    xd = torch.as_tensor(rng.normal(size=(t, d))).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a: tffn._SumRows.apply(a, table, rows), (cd,))
    assert torch.autograd.gradcheck(
        lambda a: tffn._GatherRows.apply(a, rows, table), (xd,))
    assert torch.equal(tffn._GatherRows.apply(xd, rows, table), xd[rows])


@pytest.mark.parametrize("kind", ["swiglu", "squared_relu"])
def test_moe_matches_the_per_token_reference(kind):
    d, dff, e, k = 8, 16, 4, 2
    p, tp = _moe_pair(1, d, dff, e, kind)
    x = np.random.default_rng(0).normal(size=(1, 12, d)).astype(np.float32)
    out, aux = tffn.apply_moe(tp, torch.as_tensor(x), top_k=k,
                              capacity_factor=8.0, kind=kind)
    ref = _naive_moe(p, x[0].astype(np.float64), k, kind)
    np.testing.assert_allclose(_np(out[0]), ref, atol=1e-4, rtol=1e-3)
    assert float(aux) > 0


def _dropped(p, x, top_k, factor):
    """The reference's kept mask in its sorted order (global dispatch)."""
    t = x.shape[0] * x.shape[1]
    e = p["w_in"].shape[0]
    cap = jffn.moe_capacity(t, e, top_k, factor)
    logits = x.reshape(t, -1).astype(np.float32) @ np.asarray(p["router"])
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    _, choice = jax.lax.top_k(probs, top_k)
    se = np.sort(np.asarray(choice).reshape(-1), kind="stable")
    starts = np.searchsorted(se, np.arange(e))
    return (np.arange(t * top_k) - starts[se]) < cap


@pytest.mark.parametrize("factor,groups", [(8.0, 1), (0.25, 1), (0.5, 2),
                                           (8.0, 2)])
def test_apply_moe_matches_reference_with_gradients(factor, groups,
                                                    monkeypatch):
    """Forward, aux and gradients (w.r.t. x and every weight) against
    ``repro.models.ffn.apply_moe``, ample capacity and capacity drops
    (``test_moe_capacity_drops_dont_nan``'s case), one and two groups."""
    d, dff, e, k = 8, 16, 4, 2
    p, tp = _moe_pair(2, d, dff, e, "swiglu")
    x = np.random.default_rng(0).normal(size=(2, 64, d)).astype(np.float32)
    monkeypatch.setattr(jffn, "MOE_GROUPS", groups)
    monkeypatch.setattr(tffn, "MOE_GROUPS", groups)
    if groups == 1:
        kept = _dropped(p, x, k, factor)
        assert kept.all() == (factor == 8.0)

    def jloss(q, xx):
        o, a = jffn.apply_moe(q, xx, top_k=k, capacity_factor=factor,
                              kind="swiglu")
        return jnp.sum(o * o) + a, (o, a)

    (_, (jo, ja)), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))
    tq = {kk: v.clone().requires_grad_(True) for kk, v in tp.items()}
    tx = torch.as_tensor(x).requires_grad_(True)
    to, ta = tffn.apply_moe(tq, tx, top_k=k, capacity_factor=factor,
                            kind="swiglu")
    grads = torch.autograd.grad(torch.sum(to * to) + ta,
                                [*tq.values(), tx])
    assert np.all(np.isfinite(_np(to)))
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-5, rtol=0)
    assert abs(float(ta.detach()) - float(ja)) <= 1e-6
    _rel_close(dict(zip(tq, grads[:-1])), params_from_jax(
        jax.tree_util.tree_map(np.asarray, jg)), 1e-5, f"grad {factor}")
    _rel_close({"x": grads[-1]}, {"x": np.asarray(jgx)}, 1e-5, "grad")


# ---------------------------------------------------------------- the LM
@pytest.fixture(scope="module", params=ARCHS)
def moe_weights(request):
    jcfg = JAX_REGISTRY[request.param].reduced()
    cfg = get_config(request.param).reduced()
    assert cfg.family == "moe" and cfg.moe.num_experts == 4
    pj = jlm.init_params(jax.random.PRNGKey(4), jcfg)
    return jcfg, cfg, pj, lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, pj))


def test_moe_init_layout_matches_reference(moe_weights):
    jcfg, cfg, pj, pt = moe_weights
    want = {k: (tuple(v.shape), v.dtype) for k, v in pt.items()}
    got = {k: (tuple(v.shape), v.dtype) for k, v in
           lm.init_params(cfg, seed=0, device="cpu").items()}
    assert got == want
    assert "blocks.moe.router" in got and "blocks.ffn.w_in" not in got


def test_moe_train_loss_matches_reference(moe_weights):
    jcfg, cfg, pj, pt = moe_weights
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 33))
    toks[0, 5] = -1                               # a masked label
    jb = {"tokens": jnp.asarray(np.maximum(toks[:, :-1], 0), jnp.int32),
          "labels": jnp.asarray(toks[:, 1:], jnp.int32)}
    tb = {"tokens": torch.as_tensor(np.maximum(toks[:, :-1], 0)),
          "labels": torch.as_tensor(toks[:, 1:])}
    lj, gj = jax.value_and_grad(
        lambda p: jlm.train_loss(p, jcfg, jb))(pj)
    lt, gt = steps.value_and_grad(
        lambda p, b: lm.train_loss(p, cfg, b), pt, tb)
    assert abs(float(lt) - float(lj)) <= 1e-6 * max(1.0, abs(float(lj)))
    _rel_close(gt, params_from_jax(jax.tree_util.tree_map(np.asarray, gj)),
               1e-5, "grad")


def test_moe_prefill_and_decode_match_reference(moe_weights):
    jcfg, cfg, pj, pt = moe_weights
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 16))
    jl, jc = jlm.prefill(pj, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = lm.prefill(pt, cfg, {"tokens": torch.as_tensor(toks)},
                        max_len=18)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=1e-4, rtol=0)
    jc = {k: (jnp.pad(v, [(0, 0), (0, 0), (0, 2), (0, 0), (0, 0)])
              if k in ("k", "v") else v) for k, v in jc.items()}
    nxt = np.asarray(jnp.argmax(jl, -1))
    for _ in range(2):
        jl, jc = jlm.decode_step(pj, jcfg, jnp.asarray(nxt, jnp.int32), jc)
        tl, tc = lm.decode_step(pt, cfg, torch.as_tensor(nxt.copy()), tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        nxt = np.asarray(jnp.argmax(jl, -1))


def test_moe_train_step_repeats_and_serve_runs():
    """make_train_step on the reduced granite-moe twice from the same
    state: bitwise; serve.main serves the MoE on the CPU."""
    cfg = get_config("granite-moe-1b-a400m").reduced()
    params = lm.init_params(cfg, seed=1, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (4, 17)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step, opt = steps.make_train_step(cfg)
    a = step(params, opt.init(params), batch, 1e-3)
    b = step(params, opt.init(params), batch, 1e-3)
    assert torch.equal(a[2], b[2]) and np.isfinite(float(a[2]))
    assert all(torch.equal(a[0][k], b[0][k]) for k in params)
    assert a[1]["m"]["blocks.moe.w_in"].dtype == torch.bfloat16
    gen = serve.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3",
                      "--device", "cpu"])
    assert gen.shape == (2, 3) and gen.max() < cfg.padded_vocab


def test_bf16_moe_forward_is_finite():
    """The reduced config in bf16 (the full configs' dtype): the train
    loss and its gradients are finite."""
    cfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(),
                              dtype="bfloat16")
    params = lm.init_params(cfg, seed=2, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 17)))
    loss, grads = steps.value_and_grad(
        lambda p, b: lm.train_loss(p, cfg, b), params,
        {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert np.isfinite(float(loss))
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads.values())
    assert grads["blocks.moe.w_in"].dtype == torch.bfloat16
