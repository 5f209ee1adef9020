"""The port's Mamba-2 / SSD mixer (``repro_torch.models.ssd``) against
``repro.models.ssd``, on the CPU.

Inputs are made with numpy from a seed; parameters cross from the
reference bit for bit (``convert.params_from_jax``).  Contracts:
* the port's ``F.silu`` and ``F.softplus`` and ``_causal_conv``: in bf16
  each entry within 2 bf16 ulps of the reference's (XLA:CPU rounds each
  op of ``jax.nn.silu``'s graph to bf16, torch rounds the fused op once;
  the conv's sum is the same bf16 chain on both), the conv state bitwise
  (a copy); in f32 within 1e-6 (``exp`` / ``log1p`` of two libraries);
  ``_segsum`` f32 within 1e-6 (its cumsum is a sum of f32 terms);
* ``ssd_chunked`` at chunks 4, 8 and 32, from a zero and from a given
  state: y and the final state within 2e-5 of the reference relative to
  each one's largest entry (the reference's multi-operand einsums contract
  in another order than the port's batched products), and both within the
  reference's own 2e-4 of a naive per-step scan;
* ``apply_ssd`` (a padded length, a length below the chunk) and
  ``ssd_decode_step``: y, the SSD state and the conv state (the last
  inputs' projections) f32 within 2e-5 relative to each one's largest
  entry; bf16 within 2 bf16 ulps of it;
* decode continues prefill: apply_ssd over s steps equals apply_ssd over
  s − 1 then one decode step within 2e-5 relative (the reference's test's
  property, on the port);
* ``init_ssd``: the reference's leaves, shapes and dtypes; dt_bias, A_log
  and D from the reference's formulas.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from repro.configs.base import SSMConfig as JSSMConfig
from repro.models import ssd as jssd

from repro_torch.configs.base import SSMConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import ssd as tssd

REL = 2e-5
BF16_ULP = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _pair(a, dtype="float32"):
    j = jnp.asarray(a, jnp.dtype(dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype])
    return j, t


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy().view(np.int32)
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


def _rel(got, want, rtol=REL):
    got, want = _np(got), _np(want)
    scale = float(np.abs(want).max()) + 1e-30
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def _naive_ssm(x, dt, alog, B, C, D, st=None):
    """The reference test's per-step recurrence (float64)."""
    b, s, h, p = x.shape
    a = -np.exp(alog)
    st = np.zeros((b, h, p, B.shape[-1])) if st is None else st
    ys = np.zeros_like(x, dtype=np.float64)
    for t in range(s):
        decay = np.exp(dt[:, t] * a[None])
        st = st * decay[..., None, None] + np.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], x[:, t], B[:, t])
        ys[:, t] = np.einsum("bhpn,bn->bhp", st, C[:, t]) + \
            x[:, t] * D[None, :, None]
    return ys, st


# ------------------------------------------------------------------- pieces
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_softplus_conv_match_reference(dtype):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.normal(size=4000) * 4, dtype)
    uj, ut = _pair(rng.normal(size=(2, 37, 24)), dtype)
    wj, wt = _pair(rng.normal(size=(4, 24)) * 0.1, dtype)
    sj, st = _pair(rng.normal(size=(2, 3, 24)), dtype)
    pairs = [(F.silu(xt), jax.nn.silu(xj)),
             (F.softplus(xt), jax.nn.softplus(xj))]
    for state in ((None, None), (sj, st)):
        yj, cj = jssd._causal_conv(uj, wj, state[0])
        yt, ct = tssd._causal_conv(ut, wt, state[1])
        pairs += [(yt, yj), (ct, cj)]
        assert _bits(ct).tolist() == _bits(cj).tolist()   # a copy
    for got, want in pairs:
        assert got.dtype == {"float32": torch.float32,
                             "bfloat16": torch.bfloat16}[dtype]
        if dtype == "bfloat16":
            # 2 ulps of a bf16 entry w are at most 2·2⁻⁷·|w|
            err = np.abs(_np(got) - _np(want))
            assert (err <= 2 * BF16_ULP * np.abs(_np(want))).all(), \
                float(err.max())
        else:
            np.testing.assert_allclose(_np(got), _np(want), atol=1e-6,
                                       rtol=1e-6)


def test_segsum_matches_reference():
    a = np.random.default_rng(1).uniform(-0.5, 0, (2, 3, 16)).astype(
        np.float32)
    got, want = tssd._segsum(torch.as_tensor(a)), jssd._segsum(
        jnp.asarray(a))
    want = np.asarray(want)
    assert np.array_equal(np.isneginf(_np(got)), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(_np(got)[fin], want[fin], atol=1e-6)


def _ssd_inputs(seed, b=2, s=32, h=3, p=8, n=4):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(b, s, h, p)).astype(np.float32),
        dt=rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32),
        alog=rng.uniform(-1, 1, h).astype(np.float32),
        B=rng.normal(size=(b, s, n)).astype(np.float32),
        C=rng.normal(size=(b, s, n)).astype(np.float32),
        D=rng.normal(size=h).astype(np.float32),
        st=rng.normal(size=(b, h, p, n)).astype(np.float32))


@pytest.mark.parametrize("chunk", [4, 8, 32])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(chunk, with_state):
    a = _ssd_inputs(chunk)
    st = a["st"] if with_state else None
    j = [jnp.asarray(a[k]) for k in ("x", "dt")] + \
        [-jnp.exp(jnp.asarray(a["alog"]))] + \
        [jnp.asarray(a[k]) for k in ("B", "C", "D")]
    t = [torch.as_tensor(a[k]) for k in ("x", "dt")] + \
        [-torch.exp(torch.as_tensor(a["alog"]))] + \
        [torch.as_tensor(a[k]) for k in ("B", "C", "D")]
    yj, sj = jax.jit(jssd.ssd_chunked, static_argnames="chunk")(
        *j, chunk=chunk,
        init_state=None if st is None else jnp.asarray(st))
    yt, stt = tssd.ssd_chunked(*t, chunk=chunk,
                               init_state=None if st is None else
                               torch.as_tensor(st))
    assert yt.dtype == torch.float32 and stt.dtype == torch.float32
    _rel(yt, yj)
    _rel(stt, sj)
    y0, s0 = _naive_ssm(a["x"], a["dt"], a["alog"], a["B"], a["C"], a["D"],
                        None if st is None else st.astype(np.float64))
    np.testing.assert_allclose(_np(yt), y0, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(stt), s0, atol=2e-4, rtol=2e-4)
    with pytest.raises(ValueError, match="no multiple"):
        tssd.ssd_chunked(*t, chunk=5)


# ------------------------------------------------------------------- mixer
CFG = dict(d_state=4, head_dim=8, expand=2, chunk=8, d_conv=4)
D_MODEL = 16


@pytest.fixture(scope="module")
def mixer():
    """The reference's init_ssd params (f32 and bf16) and the port's copy."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        pj = jssd.init_ssd(jax.random.PRNGKey(0), D_MODEL, JSSMConfig(**CFG),
                           jnp.dtype(dtype))
        out[dtype] = (pj, params_from_jax(jax.tree_util.tree_map(
            np.asarray, pj)))
    return out


def test_init_ssd_layout_matches_reference(mixer):
    pj, pt = mixer["bfloat16"]
    gen = torch.Generator().manual_seed(0)
    mine = tssd.init_ssd(gen, D_MODEL, SSMConfig(**CFG), torch.bfloat16)
    assert set(mine) == set(pt)
    for k in pt:
        assert mine[k].shape == pt[k].shape and mine[k].dtype == pt[k].dtype
    for k in ("A_log", "D"):
        np.testing.assert_array_equal(_np(mine[k]), _np(pt[k]))
    # dt_bias = softplus⁻¹(dt), dt log-uniform in [1e-3, 1e-1]
    dt = np.log1p(np.exp(_np(mine["dt_bias"])))
    assert 1e-3 * (1 - 1e-5) <= dt.min() and dt.max() <= 1e-1 * (1 + 1e-5)


@pytest.mark.parametrize("s", [5, 8, 19, 37])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_ssd_and_decode_match_reference(mixer, s, dtype):
    """s = 5 runs one chunk of 5; 19 and 37 pad to chunk multiples."""
    pj, pt = mixer[dtype]
    cfg, jcfg = SSMConfig(**CFG), JSSMConfig(**CFG)
    rng = np.random.default_rng(s)
    xj, xt = _pair(rng.normal(size=(2, s + 1, D_MODEL)), dtype)
    yj, (sj, cj) = jax.jit(jssd.apply_ssd, static_argnums=2)(
        pj, xj[:, :s], jcfg)
    yt, (st, ct) = tssd.apply_ssd(pt, xt[:, :s], cfg)
    ydj, (sdj, cdj) = jax.jit(jssd.ssd_decode_step, static_argnums=2)(
        pj, xj[:, s:], jcfg, sj, cj)
    ydt, (sdt, cdt) = tssd.ssd_decode_step(pt, xt[:, s:], cfg, st, ct)
    rel = REL if dtype == "float32" else 2 * BF16_ULP
    for got, want in ((yt, yj), (st, sj), (ct, cj), (ydt, ydj), (sdt, sdj),
                      (cdt, cdj)):
        assert got.dtype == (torch.float32 if want.dtype == jnp.float32
                             else torch.bfloat16)
        _rel(got, want, rel)
    if dtype == "float32":
        # decode continues prefill (the reference's own property)
        yf, (sf, _) = tssd.apply_ssd(pt, xt, cfg)
        _rel(ydt, yf[:, -1:])
        _rel(sdt, sf)


def test_apply_ssd_from_a_state_matches_reference(mixer):
    pj, pt = mixer["float32"]
    cfg = SSMConfig(**CFG)
    rng = np.random.default_rng(3)
    xj, xt = _pair(rng.normal(size=(2, 12, D_MODEL)))
    st0 = rng.normal(size=(2, 4, 8, 4)).astype(np.float32)
    cv0 = rng.normal(size=(2, 3, 2 * D_MODEL + 8)).astype(np.float32)
    yj, (sj, _) = jax.jit(jssd.apply_ssd, static_argnums=2)(
        pj, xj, JSSMConfig(**CFG), state=jnp.asarray(st0),
        conv_state=jnp.asarray(cv0))
    yt, (st, _) = tssd.apply_ssd(pt, xt, dataclasses.replace(cfg),
                                 state=torch.as_tensor(st0),
                                 conv_state=torch.as_tensor(cv0))
    _rel(yt, yj)
    _rel(st, sj)
