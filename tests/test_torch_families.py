"""The SSM, hybrid, VLM and audio families of the port's LM against
``repro.models.lm``, on the CPU, at the reduced configs (f32, 2 layers).

Inputs are made with numpy from a seed; the reference's weights cross to
the port bit for bit (``convert.lm_params_from_jax``).  The reference runs
under ``jax.jit``, one compile per (family, shape), shared through a module
fixture.  Contracts (f32 unless said):
* ``init_params``: the reference's leaves, shapes and dtypes for every
  family (blocks' ``ssm`` / ``cross``, ``enc_blocks``, ``enc_norm``);
  ``lm_params_from_jax`` carries every leaf bit for bit and raises on a
  missing or an unknown key;
* ``train_loss`` and its gradient (the VLM with its image prefix, the
  audio family with its frames): loss within 1e-6 relative, each
  gradient leaf within 1e-4 of its largest entry (the SSD's exp chains
  and the einsum orders differ at round-off, amplified by the backward);
* ``prefill`` logits and every cache leaf (``k``, ``v``, ``ssm``,
  ``conv``, ``enc_k``, ``enc_v``), then 4 ``decode_step``s' logits and the
  final cache: within 1e-4 (the dense family's bound,
  ``tests/test_torch_lm.py``);
* prefill then decode equals the longer prefill's last logits (the
  property of ``tests/test_arch_smoke.py``, on the port): atol 2e-3,
  rtol 2e-2, the reference's own bound;
* ``decode_attend_ring`` over a wrap (W = 16, 40 steps) against the
  reference's and against ``decode_attend`` over the grown cache: within
  1e-6 (the same keys, summed in ring order); the whole model with
  ``RING_CACHE`` (the VLM's window, a prefill of exactly one window, 6
  steps past it): logits and the ring within 1e-4 of the reference's
  ``RING_CACHE`` decode;
* ``embed_params_padded``: bitwise the reference's on
  ``tests/test_head_padding.py``'s cases and hymba's heads (25 / 5 ->
  48 / 6); the padded model's loss and logits within 1e-5 of the
  unpadded one's;
* ``launch.train.main`` on mamba2's reduced config, 2 rounds, against
  ``repro.launch.train.main`` with its weights and batch draws: sets and
  counts bitwise, val_loss within 1e-4 a round; the audio family raises
  naming ``audio_frames``; ``serve.main``'s request is the reference's
  draws, bit for bit (tokens, then the image embeddings or the frames).
"""
import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.configs.registry import REGISTRY as JAX_REGISTRY
from repro.launch import train as jtrain
from repro.models import attention as jattn
from repro.models import lm as jlm

from repro_torch.configs import base as tbase
from repro_torch.configs.registry import get_config
from repro_torch.convert import lm_params_from_jax, params_from_jax
from repro_torch.launch import serve, steps, train
from repro_torch.models import attention as tattn
from repro_torch.models import lm

ARCHS = ["mamba2-780m", "hymba-1.5b", "llava-next-mistral-7b",
         "seamless-m4t-large-v2"]
CPU = "cpu"
S, STEPS = 20, 4


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


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol,
                               err_msg=what)


def _inputs(cfg, s, seed, b=2):
    """tokens (b, s) and the family's prefill inputs, as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s + 1))}
    if cfg.family == "vlm":
        out["image_emb"] = rng.normal(0, 0.02, (b, cfg.n_image_tokens,
                                                cfg.d_model))
    if cfg.enc_dec:
        out["audio_frames"] = rng.normal(0, 0.02, (b, cfg.n_audio_frames,
                                                   cfg.d_model))
    return out


def _jb(a: dict, s: int) -> dict:
    out = {k: jnp.asarray(v, jnp.float32) for k, v in a.items()
           if k != "tokens"}
    out["tokens"] = jnp.asarray(a["tokens"][:, :s], jnp.int32)
    return out


def _tb(a: dict, s: int) -> dict:
    out = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in a.items()
           if k != "tokens"}
    out["tokens"] = torch.as_tensor(a["tokens"][:, :s])
    return out


class Family:
    """One family's reduced config, the reference's weights and its runs."""

    def __init__(self, arch):
        self.cfg = get_config(arch).reduced()
        self.jcfg = JAX_REGISTRY[arch].reduced()
        self.pj = jax.jit(jlm.init_params, static_argnums=1)(
            jax.random.PRNGKey(0), self.jcfg)
        self.pt = lm_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            self.pj))
        jcfg = self.jcfg
        self.prefill = jax.jit(lambda p, b: jlm.prefill(p, jcfg, b))
        self.decode = jax.jit(lambda p, t, c: jlm.decode_step(p, jcfg, t, c))


@pytest.fixture(scope="module")
def fam():
    made = {}

    def get(arch):
        if arch not in made:
            made[arch] = Family(arch)
        return made[arch]
    return get


# ----------------------------------------------------------- params layout
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_and_convert_cover_every_leaf(fam, arch):
    f = fam(arch)
    p_np = jax.tree_util.tree_map(np.asarray, f.pj)
    want = {k: (tuple(v.shape), v.dtype) for k, v in
            params_from_jax(p_np).items()}
    got = {k: (tuple(v.shape), v.dtype) for k, v in
           lm.init_params(f.cfg, seed=0, device=CPU).items()}
    assert got == want
    leaves = jax.tree_util.tree_flatten_with_path(p_np)[0]
    assert len(f.pt) == len(leaves)
    for path, leaf in leaves:
        t = f.pt[".".join(k.key for k in path)]
        np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                      leaf.view(np.uint32))
    drop = next(k for k in f.pt if k.startswith("blocks."))
    with pytest.raises(KeyError, match="missing"):
        lm_params_from_jax({**p_np, "blocks": {
            part: {n: w for n, w in sub.items()
                   if f"blocks.{part}.{n}" != drop}
            for part, sub in p_np["blocks"].items()}})
    with pytest.raises(KeyError, match="unknown"):
        lm_params_from_jax({**p_np, "blocks": {**p_np["blocks"],
                                               "extra": {"w": np.ones(2)}}})


# ------------------------------------------------------------------ train
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(fam, arch):
    f = fam(arch)
    a = _inputs(f.cfg, 16, 5)
    jb, tb = _jb(a, 16), _tb(a, 16)
    jb["labels"] = jnp.asarray(a["tokens"][:, 1:], jnp.int32)
    tb["labels"] = torch.as_tensor(a["tokens"][:, 1:])
    jcfg = f.jcfg
    lj, gj = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.train_loss(p, jcfg, b, remat=False)))(f.pj, jb)
    lt, gt = steps.value_and_grad(
        lambda p, b: lm.train_loss(p, f.cfg, b, remat=True), f.pt, tb)
    assert abs(float(lt) - float(lj)) <= 1e-6 * abs(float(lj))
    gj = params_from_jax(jax.tree_util.tree_map(np.asarray, gj))
    assert set(gt) == set(gj)
    for k in gj:
        scale = float(np.abs(_np(gj[k])).max()) + 1e-30
        err = float(np.abs(_np(gt[k]) - _np(gj[k])).max())
        assert err <= 1e-4 * scale, (k, err, scale)


# --------------------------------------------------------- prefill/decode
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(fam, arch):
    f = fam(arch)
    a = _inputs(f.cfg, S + STEPS, 7)
    lj, cj = f.prefill(f.pj, _jb(a, S))
    total = S + (f.cfg.n_image_tokens if f.cfg.family == "vlm" else 0)
    with torch.no_grad():
        lt, ct = lm.prefill(f.pt, f.cfg, _tb(a, S), max_len=total + STEPS)
    _close(lt, lj, 1e-4, "prefill logits")
    assert set(ct) == set(cj)
    for name in ct:
        if name == "len":
            assert ct["len"] == int(cj["len"]) == total
        elif name in ("k", "v"):
            _close(ct[name][:, :, :total], cj[name], 1e-4, name)
        else:
            _close(ct[name], cj[name], 1e-4, name)
    cj = {k: (jnp.pad(v, [(0, 0), (0, 0), (0, STEPS), (0, 0), (0, 0)])
              if k in ("k", "v") else v) for k, v in cj.items()}
    for t in range(STEPS):
        tok = a["tokens"][:, S + t]
        lj, cj = f.decode(f.pj, jnp.asarray(tok, jnp.int32), cj)
        with torch.no_grad():
            lt, ct = lm.decode_step(f.pt, f.cfg, torch.as_tensor(tok), ct)
        _close(lt, lj, 1e-4, f"decode step {t}")
    assert ct["len"] == int(cj["len"])
    for name in ct:
        if name != "len":
            _close(ct[name], cj[name], 1e-4, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_forward(fam, arch):
    f = fam(arch)
    a = _inputs(f.cfg, 16, 8)
    with torch.no_grad():
        full, _ = lm.prefill(f.pt, f.cfg, _tb(a, 17))
        part = _tb(a, 16)
        n = part["tokens"].shape[1] + (f.cfg.n_image_tokens
                                       if f.cfg.family == "vlm" else 0)
        _, cache = lm.prefill(f.pt, f.cfg, part, max_len=n + 1)
        step, _ = lm.decode_step(f.pt, f.cfg,
                                 torch.as_tensor(a["tokens"][:, 16]), cache)
    np.testing.assert_allclose(_np(step), _np(full), atol=2e-3, rtol=2e-2)


# -------------------------------------------------------------- ring cache
def test_decode_attend_ring_over_a_wrap():
    rng = np.random.default_rng(9)
    w, steps_, b, hq, hkv, d = 16, 40, 2, 4, 2, 8
    qs, ks, vs = (rng.normal(size=(steps_, b, 1, h, d)).astype(np.float32)
                  for h in (hq, hkv, hkv))
    ring_k, ring_v = np.zeros((2, b, w, hkv, d), np.float32)
    grown_k, grown_v = np.zeros((2, b, steps_, hkv, d), np.float32)
    for n in range(steps_):
        ring_k[:, n % w], ring_v[:, n % w] = ks[n, :, 0], vs[n, :, 0]
        grown_k[:, n], grown_v[:, n] = ks[n, :, 0], vs[n, :, 0]
        q = torch.as_tensor(qs[n])
        got = tattn.decode_attend_ring(q, torch.as_tensor(ring_k),
                                       torch.as_tensor(ring_v), n, window=w)
        want = jattn.decode_attend_ring(
            jnp.asarray(qs[n]), jnp.repeat(ring_k, 2, axis=2),
            jnp.repeat(ring_v, 2, axis=2), jnp.int32(n), window=w)
        grown = tattn.decode_attend(q, torch.as_tensor(grown_k),
                                    torch.as_tensor(grown_v), n + 1, window=w)
        _close(got, want, 1e-6, f"step {n}")
        _close(got, grown, 1e-6, f"step {n} vs the grown cache")
    with pytest.raises(ValueError, match="slots"):
        tattn.decode_attend_ring(q, torch.as_tensor(ring_k),
                                 torch.as_tensor(ring_v), 3, window=w + 1)


def test_ring_cache_decode_matches_reference(fam, monkeypatch):
    """The VLM (a 64-token window reduced) prefilled with exactly one
    window, then 6 ring steps, in both packages."""
    f = fam("llava-next-mistral-7b")
    w = f.cfg.window
    n_txt = w - f.cfg.n_image_tokens
    a = _inputs(f.cfg, n_txt + 6, 10)
    lj, cj = f.prefill(f.pj, _jb(a, n_txt))
    with torch.no_grad():
        lt, ct = lm.prefill(f.pt, f.cfg, _tb(a, n_txt))
    assert ct["k"].shape[2] == w
    monkeypatch.setattr(jlm, "RING_CACHE", True)
    monkeypatch.setattr(lm, "RING_CACHE", True)
    decode = jax.jit(lambda p, t, c: jlm.decode_step(p, f.jcfg, t, c))
    for t in range(6):
        tok = a["tokens"][:, n_txt + t]
        lj, cj = decode(f.pj, jnp.asarray(tok, jnp.int32), cj)
        with torch.no_grad():
            lt, ct = lm.decode_step(f.pt, f.cfg, torch.as_tensor(tok), ct)
        _close(lt, lj, 1e-4, f"ring step {t}")
    assert ct["len"] == w + 6 and ct["k"].shape[2] == w
    for name in ("k", "v"):
        _close(ct[name], cj[name], 1e-4, name)


# ------------------------------------------------------------ head padding
def _pad_cases():
    dense = [jbase.ArchConfig(
        name="t", family="dense", source="test", n_layers=2, d_model=64,
        n_heads=hq, n_kv_heads=hkv, head_dim=16, d_ff=96, vocab_size=128,
        dtype="float32") for hq, hkv in ((3, 1), (9, 3), (5, 5), (25, 5))]
    hymba = dataclasses.replace(JAX_REGISTRY["hymba-1.5b"].reduced(),
                                n_heads=25, n_kv_heads=5)
    return list(zip(dense + [hymba], (4, 16, 8, 16, 16)))


@pytest.mark.parametrize("case", range(5))
def test_embed_params_padded_is_the_reference_copy(case):
    jcfg, mult = _pad_cases()[case]
    jcfg_p = jbase.pad_heads(jcfg, mult)
    cfg = tbase.ArchConfig(**dataclasses.asdict(jcfg) | {
        "ssm": None if jcfg.ssm is None else
        tbase.SSMConfig(**dataclasses.asdict(jcfg.ssm))})
    cfg_p = tbase.pad_heads(cfg, mult)
    assert (cfg_p.n_heads, cfg_p.n_kv_heads) == (jcfg_p.n_heads,
                                                 jcfg_p.n_kv_heads)
    if jcfg.family == "hybrid":
        assert (cfg_p.n_heads, cfg_p.n_kv_heads) == (48, 6)
    pj = jax.jit(jlm.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                    jcfg)
    want = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jlm.embed_params_padded(pj, jcfg, jcfg_p)))
    pt = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    got = lm.embed_params_padded(pt, cfg, cfg_p)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k].numpy().view(np.uint32),
                                      want[k].numpy().view(np.uint32), k)
    toks = torch.as_tensor(np.random.default_rng(case).integers(
        0, cfg.vocab_size, (2, 13)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with torch.no_grad():
        l0 = lm.train_loss(pt, cfg, batch, remat=False)
        l1 = lm.train_loss(got, cfg_p, batch, remat=False)
        g0, _ = lm.prefill(pt, cfg, {"tokens": batch["tokens"]})
        g1, _ = lm.prefill(got, cfg_p, {"tokens": batch["tokens"]})
    assert abs(float(l0) - float(l1)) <= 1e-5 * abs(float(l0))
    _close(g1, g0, 1e-5)


# ------------------------------------------------------------- launchers
MAMBA_ARGV = ["--arch", "mamba2-780m", "--reduced", "--clients", "4",
              "--rounds", "2", "--mode", "LN", "--sampler", "fedgs",
              "--seed", "0"]
E, B, SEQ = 4, 4, 64
N_SEQ = B * (SEQ + 1) * 8 // (SEQ + 1) - 1


def test_train_main_runs_mamba2_as_the_reference(fam, tmp_path,
                                                 monkeypatch):
    """Round 0 free-running; round 1 from the reference's state (its
    params after round 0, written by its checkpoint writer and resumed)."""
    from repro.checkpoint.ckpt import save_checkpoint
    ends = []

    class Recording(jtrain.ServerAggregator):
        def apply(self, stacked, weights, sel, avail, t):
            out = super().apply(stacked, weights, sel, avail, t)
            ends.append((np.asarray(sel).tolist(), out))
            return out
    monkeypatch.setattr(jtrain, "ServerAggregator", Recording)
    with contextlib.redirect_stdout(io.StringIO()):
        _, counts = jtrain.main(MAMBA_ARGV + ["--metrics-jsonl",
                                              str(tmp_path / "m.jsonl")])
    with open(tmp_path / "m.jsonl") as fh:
        rec = [json.loads(x) for x in fh if '"round"' in x]
    vals = [r["val_loss"] for r in rec]
    key, draws = jax.random.PRNGKey(0), {}
    for t, r in enumerate(rec):
        for j in range(r["n_selected"]):
            key, sub = jax.random.split(key)
            draws[t, j] = np.stack([np.asarray(jax.random.randint(
                kk, (B,), 0, N_SEQ)) for kk in jax.random.split(sub, E)])
    # train.main draws its weights with PRNGKey(seed), the fixture's key
    p0 = {k: v.clone() for k, v in fam("mamba2-780m").pt.items()}
    got = []
    with contextlib.redirect_stdout(io.StringIO()):
        _, tcounts = train.main(MAMBA_ARGV + ["--device", "cpu"],
                                init_params=p0,
                                batch_indices=lambda t, j, k: draws[t, j],
                                on_round=got.append)
    assert [list(map(int, i["sel"])) for i in got] == [s for s, _ in ends]
    np.testing.assert_array_equal(tcounts, counts)
    assert abs(got[0]["val_loss"] - vals[0]) <= 1e-4
    c = np.zeros(4)
    c[ends[0][0]] += 1
    path = str(tmp_path / "from1")
    save_checkpoint(path, {"params": ends[0][1], "counts": c,
                           "round": np.asarray(0, np.int64)})
    one = []
    with contextlib.redirect_stdout(io.StringIO()):
        train.main(MAMBA_ARGV + ["--device", "cpu", "--ckpt", path],
                   init_params=p0, batch_indices=lambda t, j, k: draws[t, j],
                   on_round=one.append)
    assert [i["t"] for i in one] == [1]
    assert list(map(int, one[0]["sel"])) == ends[1][0]
    assert abs(one[0]["val_loss"] - vals[1]) <= 1e-4
    print("free-running val_loss gaps:",
          [abs(i["val_loss"] - v) for i, v in zip(got, vals)])


def test_train_main_refuses_the_audio_family():
    with pytest.raises(ValueError, match="audio_frames"):
        train.main(["--arch", "seamless-m4t-large-v2", "--reduced",
                    "--rounds", "1", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b",
                                  "seamless-m4t-large-v2"])
def test_serve_main_draws_the_reference_request(arch):
    """``repro.launch.serve.main``'s draws (its lines 286-296): tokens,
    then the image embeddings or frames from the same generator, cast from
    float64 to the config's dtype."""
    with contextlib.redirect_stdout(io.StringIO()):
        gen = serve.main(["--arch", arch, "--reduced", "--batch", "2",
                          "--prompt-len", "8", "--gen", "4", "--device",
                          "cpu"])
    cfg = get_config(arch).reduced()
    assert gen.shape == (2, 4) and gen.max() < cfg.padded_vocab
    toks, inputs = serve.prompt_inputs(cfg, 2, 8, 0, CPU)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(toks.numpy(),
                                  rng.integers(0, cfg.vocab_size, (2, 8)))
    name = "image_emb" if cfg.family == "vlm" else "audio_frames"
    n = cfg.n_image_tokens if cfg.family == "vlm" else cfg.n_audio_frames
    np.testing.assert_array_equal(
        inputs[name].numpy(),
        np.asarray(jnp.asarray(rng.normal(0, 0.02, (2, n, cfg.d_model)),
                               jnp.float32)))
    logits, _ = steps.make_prefill_step(cfg)(
        lm.init_params(cfg, seed=0, device=CPU), {"tokens": toks, **inputs})
    assert logits.shape == (2, cfg.padded_vocab)
