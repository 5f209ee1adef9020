"""The port's LM serving path against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
reference's weights cross to the port through ``convert.lm_params_from_jax``
bit for bit.  Where the reference reaches the Pallas sliding-window kernel
it runs in interpret mode, as ``tests/test_kernels.py`` runs it.

Contracts:
* configs: every copied ``ArchConfig`` (and its ``reduced()`` and
  ``pad_heads`` variants) equals the original field by field;
* ``rms_norm`` and ``rope_angles``: f32 within 1e-6; ``apply_rope`` f32
  within 1e-5 (cos/sin's round-off times |x| up to 4); bf16 within one
  bf16 ulp (both round once, at the same points);
* the attention kernel's plain version against the Pallas kernel: f32
  within 1e-5; bf16 within one bf16 ulp (2⁻⁷·|o| + 1e-6): both keep the
  probabilities and V in f32 and round the output once; the port's
  ``window_attention_ref`` against the reference's: f32 within 1e-5, bf16
  within 3e-2 (``tests/test_kernels.py``'s bf16 bound: both round p);
* ``multihead_attention`` (causal, and the encoder's bidirectional
  ``causal=False``) against ``attend_dense``: f32 within 1e-5; ``decode_attend`` against the reference's: f32 within 1e-5, bf16
  within 2e-2 (both round p to bf16 before the product with V, and a
  one-ulp flip of p moves the output by up to 2⁻⁸·|v|);
* ``prefill`` and four ``decode_step``s against ``repro.models.lm`` with the
  same weights: f32 within 1e-4; bf16 within atol 5e-2, rtol 2e-2, because
  the port keeps the probabilities in f32 in prefill (the kernel's order)
  where the reference's ``attend_dense`` rounds them to bf16 first — the
  bound the JAX package allows for that same difference;
* greedy serving with the reference's weights picks the reference's tokens,
  for the dense family and (``test_other_families_raise``) for the ssm,
  hybrid, vlm and audio families on the reference's request; a family
  outside the six raises;
* the tensor-core body's precision argument: p split into three bf16
  terms keeps the output within one bf16 ulp of the f32-p plain version;
  two terms miss it on a row whose output cancels.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.configs.registry import REGISTRY as JAX_REGISTRY
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import lm as jlm

from repro_torch.configs import base as tbase
from repro_torch.configs.registry import REGISTRY, get_config
from repro_torch.convert import lm_params_from_jax, params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import window_attention as twa
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import lm

BF16_ULP = 2.0 ** -7
CPU = "cpu"


def _np(x) -> np.ndarray:
    """A JAX or torch array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, np.float32)


def _pair(a: np.ndarray, dtype: str):
    """The same numpy array as a JAX and a torch array of ``dtype``."""
    j = jnp.asarray(a, jnp.dtype(dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        lm.torch_dtype(dtype))
    return j, t


def _assert_ulp(got, want, *, floor=1e-6):
    got, want = _np(got), _np(want)
    bound = BF16_ULP * np.abs(want) + floor
    assert np.all(np.abs(got - want) <= bound), \
        float(np.max(np.abs(got - want) - bound))


def _cfg(dtype="float32", **kw):
    cfg = get_config("smollm-135m").reduced()
    cfg = dataclasses.replace(cfg, dtype=dtype, **kw)
    jcfg = dataclasses.replace(JAX_REGISTRY["smollm-135m"].reduced(),
                               dtype=dtype, **kw)
    return cfg, jcfg


@pytest.fixture(scope="module")
def weights():
    """The reference's reduced smollm weights (f32 and bf16), as numpy."""
    out = {}

    def get(jcfg):
        key = (jcfg.dtype, jcfg.attention)
        if key not in out:
            p = jlm.init_params(jax.random.PRNGKey(0), jcfg)
            out[key] = (p, jax.tree_util.tree_map(np.asarray, p))
        return out[key]
    return get


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", sorted(JAX_REGISTRY))
def test_config_copy_equals_reference(arch):
    want, got = JAX_REGISTRY[arch], REGISTRY[arch]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == \
        dataclasses.asdict(want.reduced())
    assert dataclasses.asdict(tbase.pad_heads(got)) == \
        dataclasses.asdict(jbase.pad_heads(want))
    assert (got.padded_vocab, got.param_count(), got.active_param_count()) \
        == (want.padded_vocab, want.param_count(), want.active_param_count())


def test_reduced_config_is_the_cpu_test_size():
    cfg = get_config("smollm-135m").reduced()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.vocab_size, cfg.dtype, cfg.window) == \
        (2, 256, 4, 2, 32, 512, "float32", 64)
    assert {k: dataclasses.asdict(v) for k, v in
            tbase.INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.INPUT_SHAPES.items()}
    for v in (1, 127, 49152, 151936, 256000):
        assert tbase.pad_vocab(v) == jbase.pad_vocab(v)


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.normal(0, 3, (2, 5, 64)), dtype)
    w = rng.normal(1, 0.1, 64).astype(np.float32)
    want = jlayers.rms_norm(xj, jnp.asarray(w), 1e-5)
    got = tlayers.rms_norm(xt, torch.from_numpy(w), 1e-5)
    assert got.dtype == lm.torch_dtype(dtype)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)
    else:
        _assert_ulp(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(dtype):
    rng = np.random.default_rng(2)
    s, hd = 48, 32
    cj, sj = jlayers.rope_angles(jnp.arange(s), hd, 10000.0)
    ct, st = tlayers.rope_angles(torch.arange(s), hd, 10000.0)
    np.testing.assert_allclose(_np(ct), _np(cj), atol=1e-6)
    np.testing.assert_allclose(_np(st), _np(sj), atol=1e-6)
    xj, xt = _pair(rng.normal(size=(2, s, 3, hd)), dtype)
    got = tlayers.apply_rope(xt, ct, st)
    want = jlayers.apply_rope(xj, cj, sj)
    # decode's (B, 1) positions broadcast the other way
    pos = np.array([[5], [17]])
    cdj, sdj = jlayers.rope_angles(jnp.asarray(pos), hd, 10000.0)
    cdt, sdt = tlayers.rope_angles(torch.from_numpy(pos), hd, 10000.0)
    got_d = tlayers.apply_rope(xt[:, :1], cdt, sdt)
    want_d = jlayers.apply_rope(xj[:, :1], cdj, sdj)
    for g, w in ((got, want), (got_d, want_d)):
        assert g.dtype == lm.torch_dtype(dtype)
        if dtype == "float32":
            np.testing.assert_allclose(_np(g), _np(w), atol=1e-5, rtol=1e-6)
        else:
            _assert_ulp(g, w)


def test_initializers_draw_the_reference_distributions():
    gen = torch.Generator().manual_seed(0)
    w = tlayers.dense_init(gen, 400, 300, torch.float32)
    z = w.numpy() * math.sqrt(400)
    assert w.shape == (400, 300) and np.abs(z).max() <= 3.0
    # the standard normal truncated at ±3 has std 0.98654
    assert abs(z.std() - 0.98654) < 0.01 and abs(z.mean()) < 0.01
    e = tlayers.embed_init(gen, 512, 256, torch.bfloat16)
    assert e.dtype == torch.bfloat16
    assert abs(e.float().std().item() - 0.02) < 0.001
    assert not torch.equal(tlayers.dense_init(gen, 400, 300, torch.float32), w)


# -------------------------------------------------------- window attention
def _qkv(seed, b, s, hq, hkv, d, dtype):
    rng = np.random.default_rng(seed)
    return [_pair(rng.normal(size=(b, s, h, d)), dtype)
            for h in (hq, hkv, hkv)]


# test_kernels.py's shapes, an S that is not a multiple of 128, GQA
@pytest.mark.parametrize("s,w,dtype,hq,hkv", [
    (128, 32, "float32", 3, 3),
    (256, 64, "float32", 3, 3),
    (256, 100, "float32", 3, 3),
    (384, 128, "bfloat16", 3, 3),
    (200, 50, "float32", 3, 3),
    (256, 64, "float32", 4, 2),
    (200, 200, "bfloat16", 6, 2),
])
def test_window_attention_plain_vs_pallas(s, w, dtype, hq, hkv):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(s + w, 2, s, hq, hkv, 32, dtype)
    rep = hq // hkv
    want = jops.window_attention(qj, jnp.repeat(kj, rep, axis=2),
                                 jnp.repeat(vj, rep, axis=2), window=w)
    got = ops.window_attention(qt, kt, vt, window=w)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)
    else:
        _assert_ulp(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_attention_ref_matches_reference(dtype):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(3, 2, 96, 2, 2, 32, dtype)
    want = jref.window_attention_ref(qj, kj, vj, window=40)
    got = tref.window_attention_ref(qt, kt, vt, window=40)
    assert got.dtype == qt.dtype
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)
    else:
        # both round p to bf16 before the product: a one-ulp flip of p
        # moves the output by up to 2⁻⁸·|v|
        np.testing.assert_allclose(_np(got), _np(want), atol=3e-2, rtol=0)


def _split_p(q, k, v, *, window: int, terms: int) -> torch.Tensor:
    """The plain version with the tensor-core body's P·V: the unnormalized
    p = exp(s − m) in f32 split into ``terms`` bf16 terms (bf16(p), then
    bf16 of what is left, in turn), each multiplied with V and summed in
    f32, divided by the f32 row sum at the end."""
    b, s, hq, d = q.shape
    rep = hq // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(rep, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(rep, 2).transpose(1, 2)
    scores = (qf @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    pos = torch.arange(s)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    scores = torch.where(mask, scores, -1e30)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    acc, rest = torch.zeros_like(qf), p
    for _ in range(terms):
        part = rest.to(torch.bfloat16).float()
        acc = acc + part @ vf
        rest = rest - part
    return (acc / p.sum(-1, keepdim=True)).transpose(1, 2).to(q.dtype)


def _cancelling_qkv():
    """bf16 (1, 3, 1, 16): the last row sees three keys, the largest score
    with v = 0 and two scores 2⁻¹²·1.0625 apart with v = ±100, so its
    output is the small difference of two large terms, and the bits of p
    past the 16th show in it."""
    q, k, v = (torch.zeros(1, 3, 1, 16) for _ in range(3))
    q[0, 2, 0, 0], q[0, 2, 0, 1] = 1.0, 2.0 ** -10
    k[0, 2, 0, 0], k[0, 1, 0, 1] = 2.34375, 1.0625
    v[0, 0], v[0, 1] = 100.0, -100.0
    return tuple(t.to(torch.bfloat16) for t in (q, k, v))


# the tensor-core body's precision argument, on the CPU
@pytest.mark.parametrize("b,s,hq,hkv,d,w", [(1, 130, 2, 2, 48, 63),
                                            (2, 200, 4, 2, 32, 200)])
def test_three_bf16_terms_of_p_stay_within_one_ulp(b, s, hq, hkv, d, w):
    (_, q), (_, k), (_, v) = _qkv(s + d, b, s, hq, hkv, d, "bfloat16")
    _assert_ulp(_split_p(q, k, v, window=w, terms=3),
                twa.window_attention_plain(q, k, v, window=w))


def test_two_bf16_terms_of_p_miss_the_ulp_gate_where_three_hold():
    q, k, v = _cancelling_qkv()
    want = twa.window_attention_plain(q, k, v, window=3)
    _assert_ulp(_split_p(q, k, v, window=3, terms=3), want)
    two, want = _np(_split_p(q, k, v, window=3, terms=2)), _np(want)
    assert np.any(np.abs(two - want) > BF16_ULP * np.abs(want) + 1e-6)


def test_window_attention_is_causal():
    """Changing future keys must not change past outputs."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.normal(size=(1, 128, 2, 16)),
                               dtype=torch.float32) for _ in range(3))
    out1 = ops.window_attention(q, k, v, window=32)
    k2, v2 = k.clone(), v.clone()
    k2[:, 100:] = 99.0
    v2[:, 100:] = -99.0
    out2 = ops.window_attention(q, k2, v2, window=32)
    np.testing.assert_allclose(out1[:, :100], out2[:, :100], atol=1e-5)


def test_window_attention_respects_window():
    """Keys older than the window must not influence the output."""
    rng = np.random.default_rng(0)
    s, w = 256, 64
    q, k, v = (torch.as_tensor(rng.normal(size=(1, s, 1, 16)),
                               dtype=torch.float32) for _ in range(3))
    out1 = ops.window_attention(q, k, v, window=w)
    k2, v2 = k.clone(), v.clone()
    k2[:, :s - w - 64] = 7.0
    v2[:, :s - w - 64] = -7.0
    out2 = ops.window_attention(q, k2, v2, window=w)
    np.testing.assert_allclose(out1[:, -1], out2[:, -1], atol=1e-5)


def test_flash_attention_is_the_full_window():
    (_, q), (_, k), (_, v) = _qkv(4, 1, 70, 4, 1, 16, "float32")
    assert torch.equal(ops.flash_attention(q, k, v),
                       twa.window_attention_plain(q, k, v, window=70))


def test_window_attention_rejects_bad_shapes():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="Hkv must divide Hq"):
        ops.window_attention(q, torch.zeros(1, 8, 3, 16),
                             torch.zeros(1, 8, 3, 16), window=4)
    with pytest.raises(ValueError, match="window must be"):
        ops.window_attention(q, q, q, window=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        twa.window_attention_cuda(q, q, q, window=4)


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("window", [None, 24])
def test_multihead_attention_matches_attend_dense(window):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(5, 2, 80, 4, 2, 32, "float32")
    want = jattn.attend_dense(qj, jnp.repeat(kj, 2, axis=2),
                              jnp.repeat(vj, 2, axis=2), causal=True,
                              window=window)
    got = tattn.multihead_attention(qt, kt, vt, causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)
    # the encoder's bidirectional route
    want = jattn.attend_dense(qj, jnp.repeat(kj, 2, axis=2),
                              jnp.repeat(vj, 2, axis=2), causal=False,
                              window=window)
    got = tattn.multihead_attention(qt, kt, vt, causal=False, window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 16])
def test_decode_attend_matches_reference(window, dtype):
    rng = np.random.default_rng(6)
    b, smax, hq, hkv, d, n = 2, 40, 4, 2, 32, 29
    qj, qt = _pair(rng.normal(size=(b, 1, hq, d)), dtype)
    kj, kt = _pair(rng.normal(size=(b, smax, hkv, d)), dtype)
    vj, vt = _pair(rng.normal(size=(b, smax, hkv, d)), dtype)
    want = jattn.decode_attend(qj, jnp.repeat(kj, 2, axis=2),
                               jnp.repeat(vj, 2, axis=2), jnp.int32(n),
                               window=window)
    got = tattn.decode_attend(qt, kt, vt, n, window=window)
    assert got.shape == (b, 1, hq, d) and got.dtype == qt.dtype
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)
    else:
        # p is rounded to bf16 in both before the product (reference
        # order); the sums of the products round once more
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=0)


# ---------------------------------------------------------------------- LM
def _compare_lm(cfg, jcfg, weights, *, s=20, steps=4, atol, rtol):
    p_jax, p_np = weights(jcfg)
    params = lm_params_from_jax(p_np)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (2, s + steps))
    lj, cj = jlm.prefill(p_jax, jcfg, {"tokens": jnp.asarray(toks[:, :s],
                                                             jnp.int32)})
    lt, ct = lm.prefill(params, cfg, {"tokens": torch.as_tensor(toks[:, :s])},
                        max_len=s + steps)
    np.testing.assert_allclose(_np(lt), _np(lj), atol=atol, rtol=rtol)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(ct[name][:, :, :s]), _np(cj[name]),
                                   atol=atol, rtol=rtol)
    cj = {k: (jnp.pad(v, [(0, 0), (0, 0), (0, steps), (0, 0), (0, 0)])
              if k in ("k", "v") else v) for k, v in cj.items()}
    for t in range(steps):
        tok = toks[:, s + t]
        lj, cj = jlm.decode_step(p_jax, jcfg, jnp.asarray(tok, jnp.int32), cj)
        lt, ct = lm.decode_step(params, cfg, torch.as_tensor(tok), ct)
        np.testing.assert_allclose(_np(lt), _np(lj), atol=atol, rtol=rtol)
    assert ct["len"] == int(cj["len"]) == s + steps
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(ct[name]), _np(cj[name]), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("attention", ["full", "sliding_window"])
def test_prefill_and_decode_match_reference_f32(weights, attention):
    # the sliding variant's 64-token window (reduced) is passed in decode
    cfg, jcfg = _cfg("float32", attention=attention)
    s = 70 if attention == "sliding_window" else 20
    _compare_lm(cfg, jcfg, weights, s=s, atol=1e-4, rtol=1e-4)


def test_prefill_and_decode_match_reference_bf16(weights):
    cfg, jcfg = _cfg("bfloat16")
    _compare_lm(cfg, jcfg, weights, atol=5e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype,attention", [
    ("float32", "full"), ("float32", "sliding_window"), ("bfloat16", "full")])
def test_prefill_then_decode_matches_forward(dtype, attention):
    """Teacher-forced consistency (``tests/test_arch_smoke.py``'s property
    on the port): prefill(t tokens) then decode(token t) gives prefill(t+1
    tokens)' last logits.  The window (64) is shorter than t = 80."""
    cfg, _ = _cfg(dtype, attention=attention)
    params = lm.init_params(cfg, seed=3, device=CPU)
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 81)))
    full, _ = lm.prefill(params, cfg, {"tokens": toks})
    _, cache = lm.prefill(params, cfg, {"tokens": toks[:, :-1]}, max_len=81)
    step, _ = lm.decode_step(params, cfg, toks[:, -1], cache)
    np.testing.assert_allclose(
        _np(full), _np(step), atol=5e-2 if dtype == "bfloat16" else 2e-3,
        rtol=2e-2)


def test_greedy_serving_matches_reference(weights):
    """The slice end to end: the reference's weights and prompts, prefill
    plus seven greedy decode steps in both packages: the same tokens."""
    cfg, jcfg = _cfg("float32")
    p_jax, p_np = weights(jcfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 24))
    gen = 8
    got, _ = serve.generate(lm_params_from_jax(p_np), cfg,
                            torch.as_tensor(toks), gen=gen)
    logits, cache = jax.jit(lambda p, b: jlm.prefill(p, jcfg, b))(
        p_jax, {"tokens": jnp.asarray(toks, jnp.int32)})
    cache = {k: (jnp.pad(v, [(0, 0), (0, 0), (0, gen), (0, 0), (0, 0)])
                 if k in ("k", "v") else v) for k, v in cache.items()}
    step = jax.jit(lambda p, t, c: jlm.decode_step(p, jcfg, t, c))
    want = [jnp.argmax(logits, -1)]
    for _ in range(gen - 1):
        logits, cache = step(p_jax, want[-1].astype(jnp.int32), cache)
        want.append(jnp.argmax(logits, -1))
    np.testing.assert_array_equal(got.numpy(), np.stack(want, 1))


def test_init_params_layout_matches_reference():
    for arch in ("smollm-135m", "nemotron-4-15b", "deepseek-coder-33b"):
        cfg = get_config(arch).reduced()
        jshapes = jax.eval_shape(
            lambda k: jlm.init_params(k, JAX_REGISTRY[arch].reduced()),
            jax.random.PRNGKey(0))
        want = {k: (tuple(v.shape), v.dtype) for k, v in
                params_from_jax(jax.tree_util.tree_map(
                    lambda a: np.zeros(a.shape, a.dtype), jshapes)).items()}
        got = {k: (tuple(v.shape), v.dtype)
               for k, v in lm.init_params(cfg, seed=0, device=CPU).items()}
        assert got == want, arch
    a = lm.init_params(cfg, seed=1, device=CPU)
    b = lm.init_params(cfg, seed=1, device=CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_serve_main_on_cpu(capsys):
    gen = serve.main(["--arch", "smollm-135m", "--reduced", "--batch", "3",
                      "--prompt-len", "16", "--gen", "5", "--device", "cpu"])
    cfg = get_config("smollm-135m").reduced()
    assert gen.shape == (3, 5) and gen.dtype == np.int64
    assert gen.min() >= 0 and gen.max() < cfg.padded_vocab
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=smollm-135m batch=3 prompt=16 gen=5"
    assert out[1].startswith("prefill: ") and "tok/s" in out[1]
    assert out[2] == f"first sequence: {gen[0].tolist()}"
    sampled = serve.main(["--reduced", "--batch", "3", "--prompt-len", "16",
                          "--gen", "5", "--temperature", "0.8", "--device",
                          "cpu"])
    assert sampled.shape == (3, 5) and sampled.max() < cfg.padded_vocab


@pytest.mark.parametrize("arch,family", [
    ("mamba2-780m", "ssm"), ("hymba-1.5b", "hybrid"),
    ("llava-next-mistral-7b", "vlm"), ("seamless-m4t-large-v2", "audio")])
def test_other_families_raise(arch, family):
    """The four families beyond dense and MoE serve: ``serve.generate`` on
    the reference's reduced weights and request (``serve.prompt_inputs``,
    its draws) picks the reference's greedy tokens; a family outside the
    six raises."""
    cfg, jcfg = get_config(arch).reduced(), JAX_REGISTRY[arch].reduced()
    assert cfg.family == family
    p_jax = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    params = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, p_jax))
    toks, inputs = serve.prompt_inputs(cfg, 2, 12, 0, CPU)
    gen = 5
    got, _ = serve.generate(params, cfg, toks, gen=gen, inputs=inputs)
    batch = {"tokens": jnp.asarray(toks.numpy(), jnp.int32),
             **{k: jnp.asarray(v.numpy()) for k, v in inputs.items()}}
    logits, cache = jax.jit(lambda p, b: jlm.prefill(p, jcfg, b))(p_jax,
                                                                   batch)
    cache = {k: (jnp.pad(v, [(0, 0), (0, 0), (0, gen), (0, 0), (0, 0)])
                 if k in ("k", "v") else v) for k, v in cache.items()}
    step = jax.jit(lambda p, t, c: jlm.decode_step(p, jcfg, t, c))
    want = [jnp.argmax(logits, -1)]
    for _ in range(gen - 1):
        logits, cache = step(p_jax, want[-1].astype(jnp.int32), cache)
        want.append(jnp.argmax(logits, -1))
    np.testing.assert_array_equal(got.numpy(), np.stack(want, 1))
    with pytest.raises(NotImplementedError, match="'other'"):
        lm.init_params(dataclasses.replace(cfg, family="other"), device=CPU)


def test_fedsim_and_cpu_default_raise(monkeypatch):
    # --fedsim runs (tests/test_torch_runtime.py); its compile cache has no
    # torch meaning and raises away from the default
    with pytest.raises(NotImplementedError, match="no torch meaning"):
        serve.main(["--fedsim", "--device", "cpu", "--compile-cache-dir",
                    "x"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--fedsim"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(get_config("smollm-135m").reduced())


def test_decode_on_a_full_cache_raises():
    cfg, _ = _cfg()
    params = lm.init_params(cfg, device=CPU)
    _, cache = lm.prefill(params, cfg, {"tokens": torch.zeros(1, 4,
                                                              dtype=torch.int64)})
    with pytest.raises(ValueError, match="cache is full"):
        lm.decode_step(params, cfg, torch.zeros(1, dtype=torch.int64), cache)


# ------------------------------------------------------------------ convert
def test_params_from_jax_carries_bf16_bit_for_bit():
    rng = np.random.default_rng(9)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -3e38,
                        1.0 + 2 ** -7], np.float32)
    tree = {"a": jnp.asarray(np.concatenate([special, rng.normal(size=56)]),
                             jnp.bfloat16).reshape(8, 8),
            "b": {"c": jnp.asarray(np.concatenate([special, rng.normal(
                size=12)]).astype(np.float32)),
                  "d": jnp.asarray(rng.normal(size=(3, 5)), jnp.bfloat16)[:, 1:]}}
    tree_np = jax.tree_util.tree_map(np.asarray, tree)
    out = params_from_jax(tree_np)
    assert set(out) == {"a", "b.c", "b.d"}
    for key, leaf in (("a", tree_np["a"]), ("b.d", tree_np["b"]["d"])):
        assert out[key].dtype == torch.bfloat16
        assert out[key].shape == leaf.shape
        np.testing.assert_array_equal(out[key].view(torch.int16).numpy()
                                      .view(np.uint16), leaf.view(np.uint16))
    assert out["b.c"].dtype == torch.float32
    np.testing.assert_array_equal(out["b.c"].numpy().view(np.uint32),
                                  tree_np["b"]["c"].view(np.uint32))


@pytest.mark.parametrize("arch,dtype", [("smollm-135m", "float32"),
                                        ("smollm-135m", "bfloat16"),
                                        ("nemotron-4-15b", "bfloat16")])
def test_lm_params_from_jax_covers_every_leaf(arch, dtype):
    jcfg = dataclasses.replace(JAX_REGISTRY[arch].reduced(), dtype=dtype)
    p_np = jax.tree_util.tree_map(
        np.asarray, jlm.init_params(jax.random.PRNGKey(1), jcfg))
    leaves = jax.tree_util.tree_flatten_with_path(p_np)[0]
    got = lm_params_from_jax(p_np)
    assert len(got) == len(leaves)
    for path, leaf in leaves:
        key = ".".join(k.key for k in path)
        t = got[key]
        assert tuple(t.shape) == leaf.shape
        bits = np.uint16 if leaf.dtype.itemsize == 2 else np.uint32
        tb = t.view(torch.int16 if bits is np.uint16 else torch.int32)
        np.testing.assert_array_equal(tb.numpy().view(bits), leaf.view(bits))
    with pytest.raises(KeyError, match="not an LM's parameters"):
        lm_params_from_jax({"embed": p_np["embed"]})
