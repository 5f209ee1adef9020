"""The port's eight aggregator families against the JAX package on the CPU.

Same seeded numpy inputs through ``repro.fed.aggregator_device`` and
``repro_torch.fed.aggregator_device``.  Contracts:
* the flat layout is JAX's ``ravel_pytree`` order (keys sorted): bitwise;
* median params, the Krum selection, the memory panel and ``tau``: bitwise;
* every other output (the moment slots, means, the memory reduction):
  f32 round-off, rtol 1e-5 / atol 1e-6 (XLA and torch sum and contract
  in other orders);
* ``memory_scatter_reduce_ref``: panel bitwise, reduction atol = rtol =
  1e-5 (the reference's own bound, tests/test_aggregator_device.py);
* ``ServerAggregator.apply`` reorders an unsorted ``sel`` with its updates
  and weights, as the reference does.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import flatten_util

from repro.fed import aggregator_device as jad
from repro.fed.server import ServerAggregator as JaxServerAggregator

from repro_torch.fed import aggregator_device as tad
from repro_torch.fed.server import ServerAggregator
from repro_torch.kernels import aggregate as tag

N, M, DIM, CLS = 9, 4, 4, 3          # P = 4·3 + 3 = 15
RTOL, ATOL = 1e-5, 1e-6

# (factory name, knobs): all eight families, Krum also as multi-Krum
PROCESSES = [("fedavg", {}), ("fedavgm", {"server_lr": 0.7, "beta": 0.8}),
             ("fedadam", {"server_lr": 0.05}), ("fedprox_w", {"mu": 0.3}),
             ("memory", {"gamma": 0.9}), ("median", {}),
             ("trimmed_mean", {"beta_trim": 0.25}),
             ("krum", {"krum_f": 1}),
             ("multikrum", {"krum_f": 1, "krum_multi": 2})]


def _params(rng, lead=()):
    return {"w": rng.normal(size=(*lead, DIM, CLS)).astype(np.float32),
            "b": rng.normal(size=(*lead, CLS)).astype(np.float32)}


def _t(tree):
    return {k: torch.as_tensor(np.array(v, copy=True)) for k, v in tree.items()}


def _close(got, want, *, exact=False, what=""):
    got, want = np.asarray(got), np.asarray(want)
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=what)


# ------------------------------------------------------------- flat layout
def test_flat_layout_is_ravel_pytree_order(rng):
    p = _params(rng)
    ravel, unravel, size = tad._flat_template(_t(p))
    want = np.asarray(flatten_util.ravel_pytree(p)[0])
    got = ravel(_t(p)).numpy()
    assert size == want.shape[0] == DIM * CLS + CLS
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:CLS], p["b"])          # b before w
    back = unravel(torch.as_tensor(got))
    assert list(back) == ["w", "b"]                           # caller's order
    assert all(np.array_equal(back[k].numpy(), p[k]) for k in p)
    st = _params(rng, (M,))
    flat = ravel(_t(st))                                      # stacked
    jflat = jax.vmap(lambda q: flatten_util.ravel_pytree(q)[0])(st)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    again = unravel(flat)
    assert all(np.array_equal(again[k].numpy(), st[k]) for k in st)


# --------------------------------------------------- eight families, 3 rounds
@pytest.mark.parametrize("name,kw", PROCESSES, ids=[p[0] for p in PROCESSES])
def test_family_matches_reference_over_three_rounds(rng, name, kw):
    jproc = jad.make_aggregator_process(name, **kw)
    tproc = tad.make_aggregator_process(name, **kw)
    assert tproc.family == jproc.family and tproc.name == jproc.name
    np.testing.assert_array_equal(tproc.params()["theta"],
                                  np.asarray(jproc.params()["theta"]))
    sizes = rng.integers(5, 60, N).astype(np.float32)
    p0 = _params(rng)
    jstate = jad.init_agg_state(p0, N)
    tstate = tad.init_agg_state(_t(p0), N)
    jstep = jax.jit(jad.make_aggregator_step(N, M, p0, data_sizes=sizes,
                                             family=jproc.family))
    tstep = tad.make_aggregator_step(N, M, _t(p0), family=tproc.family,
                                     data_sizes=sizes)
    for t in range(3):
        upd = _params(rng, (M,))
        w = rng.integers(1, 50, M).astype(np.float32)
        sel = np.sort(rng.choice(N, M, replace=False))
        s = np.zeros(N, bool)
        s[sel] = True
        avail = s | (rng.random(N) < 0.5)
        jp, jstate = jstep(jproc.params(), jstate, jax.random.PRNGKey(t), upd,
                           jnp.asarray(w), jnp.asarray(s), jnp.asarray(avail),
                           t, jnp.asarray(sel, jnp.int32), jnp.ones(M, bool))
        tp, tstate = tstep(tproc.params(), tstate, None, _t(upd),
                           torch.as_tensor(w), torch.as_tensor(s),
                           torch.as_tensor(avail), t,
                           torch.as_tensor(sel, dtype=torch.int64),
                           torch.ones(M, dtype=torch.bool))
        exact = name == "median"
        for k in p0:
            _close(tp[k], jp[k], exact=exact, what=f"round {t} params {k}")
            _close(tstate["prev"][k], jstate["prev"][k], exact=exact)
            _close(tstate["m1"][k], jstate["m1"][k], what=f"round {t} m1 {k}")
            _close(tstate["m2"][k], jstate["m2"][k], what=f"round {t} m2 {k}")
        _close(tstate["mem"], jstate["mem"], exact=True, what=f"round {t} mem")
        _close(tstate["tau"], jstate["tau"], exact=True, what=f"round {t} tau")
        if jproc.family == "krum":
            jflat = jax.vmap(lambda q: flatten_util.ravel_pytree(q)[0])(upd)
            want, _ = jad.krum_select(jflat, jnp.ones(M, bool), kw["krum_f"],
                                      jproc.multi)
            np.testing.assert_array_equal(tstate["chosen"].numpy(),
                                          np.asarray(want))


def test_zero_weight_round_keeps_prev(rng):
    p0 = _params(rng)
    step = tad.make_aggregator_step(N, M, _t(p0), family="fedavg")
    state = tad.init_agg_state(_t(p0), N, memory_rows=0)
    sel = torch.arange(M)
    s = torch.zeros(N, dtype=torch.bool)
    s[:M] = True
    params, _ = step(tad.FedAvgProcess().params(), state, None,
                     _t(_params(rng, (M,))), torch.zeros(M), s, s, 0, sel,
                     torch.ones(M, dtype=torch.bool))
    assert all(np.array_equal(params[k].numpy(), p0[k]) for k in p0)
    assert state["mem"].shape == (0, DIM * CLS + CLS)


# ------------------------------------------------------ the reorder repair
def test_server_apply_reorders_unsorted_sel(rng):
    """Update k must land in client sel[k]'s memory row: the port's server
    against the reference's on an unsorted sel, and against its own run on
    the sorted permutation."""
    p0 = _params(rng)
    sizes = rng.integers(5, 60, N)
    upd = _params(rng, (M,))
    w = rng.integers(1, 50, M).astype(np.float32)
    sel = np.array([7, 2, 5, 0])
    avail = np.ones(N, bool)
    proc = tad.MemoryProcess(gamma=0.8)
    jsrv = JaxServerAggregator(jad.MemoryProcess(gamma=0.8), n_clients=N,
                               data_sizes=sizes)
    jsrv.init(p0)
    jp = jsrv.apply(upd, w, sel, avail, 1)
    tsrv = ServerAggregator(proc, n_clients=N, data_sizes=sizes)
    tsrv.init(_t(p0))
    tp = tsrv.apply(_t(upd), w, sel, avail, 1)
    np.testing.assert_array_equal(tsrv.state["mem"].numpy(),
                                  np.asarray(jsrv.state["mem"]))
    ravel, _, _ = tad._flat_template(_t(p0))
    for k, row in enumerate(sel):
        np.testing.assert_array_equal(
            tsrv.state["mem"][row].numpy(),
            ravel({q: torch.as_tensor(upd[q][k]) for q in upd}).numpy())
    for k in p0:
        _close(tp[k], jp[k])
    order = np.argsort(sel)
    ssrv = ServerAggregator(tad.MemoryProcess(gamma=0.8), n_clients=N,
                            data_sizes=sizes)
    ssrv.init(_t(p0))
    sp = ssrv.apply(_t({q: upd[q][order] for q in upd}), w[order], sel[order],
                    avail, 1)
    assert torch.equal(ssrv.state["mem"], tsrv.state["mem"])
    assert all(torch.equal(sp[k], tp[k]) for k in p0)


def test_server_apply_reorder_decides_krum_ties():
    """Where the order is observable: two rows tie on their Krum score and
    the tie breaks by row index, so only the reorder by client index makes
    the port choose what the reference chooses (client 2's row, not the
    first row given, client 7's)."""
    p0 = {"w": np.zeros((DIM, CLS), np.float32),
          "b": np.zeros(CLS, np.float32)}
    sel = np.array([7, 2, 5, 0])
    vals = np.array([-1.0, 1.0, -3.0, 3.0], np.float32)   # clients 7, 2, 5, 0
    upd = {k: np.broadcast_to(vals.reshape(-1, *[1] * v.ndim),
                              (M, *v.shape)).copy() for k, v in p0.items()}
    w = np.ones(M, np.float32)
    jsrv = JaxServerAggregator(jad.KrumProcess(f=0, multi=1), n_clients=N)
    jsrv.init(p0)
    jp = jsrv.apply(upd, w, sel, np.ones(N, bool), 0)
    tsrv = ServerAggregator(tad.KrumProcess(f=0, multi=1), n_clients=N)
    tsrv.init(_t(p0))
    tp = tsrv.apply(_t(upd), w, sel, np.ones(N, bool), 0)
    for k in p0:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
        assert (tp[k].numpy() == 1.0).all()
    assert tsrv.last_chosen.tolist() == [False, True, False, False]


def test_server_init_allocates_panel_only_for_memory(rng):
    p0 = _t(_params(rng))
    for proc, rows in ((tad.MedianProcess(), 0), (tad.MemoryProcess(), N)):
        srv = ServerAggregator(proc, n_clients=N)
        assert srv.init(p0)["mem"].shape == (rows, DIM * CLS + CLS)
        assert srv.last_chosen is None


# ----------------------------------------------- memory scatter + reduce
@pytest.mark.parametrize("n,p,m", [(7, 5, 3), (30, 610, 6), (100, 130, 11),
                                   (300, 2100, 30), (2000, 300, 700)])
def test_memory_scatter_reduce_ref_vs_reference(rng, n, p, m):
    mem = rng.normal(size=(n, p)).astype(np.float32)
    upd = rng.normal(size=(m, p)).astype(np.float32)
    sel = np.sort(rng.choice(n, size=m, replace=False))
    valid = rng.random(m) < 0.8
    w = rng.random(n).astype(np.float32)
    w = w / w.sum()
    jm, jr = jad.memory_scatter_reduce_ref(
        jnp.asarray(mem), jnp.asarray(upd), jnp.asarray(sel, jnp.int32),
        jnp.asarray(valid), jnp.asarray(w))
    tmem = torch.as_tensor(mem.copy())
    tm, tr = tad.memory_scatter_reduce_ref(
        tmem, torch.as_tensor(upd), torch.as_tensor(sel),
        torch.as_tensor(valid), torch.as_tensor(w))
    assert tm is tmem                                     # in place
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5,
                               rtol=1e-5)


def test_memory_nan_containment_and_empty_selection(rng):
    """A NaN or inf update entry lands in its own row and nowhere else; an
    empty or all-invalid selection leaves the panel as it was and reduces
    the plain weighted row sum."""
    from repro_torch.kernels import ops
    n, p = 20, 33
    mem = torch.as_tensor(rng.normal(size=(n, p)).astype(np.float32))
    upd = torch.as_tensor(rng.normal(size=(5, p)).astype(np.float32))
    upd[0, 2] = float("nan")
    upd[3, 7] = float("inf")
    sel = torch.tensor([3, 5, 9, 11, 17])
    w = torch.full((n,), 1.0 / n)
    nm, red = ops.memory_aggregate(mem.clone(), upd, sel,
                                   torch.ones(5, dtype=torch.bool), w)
    assert torch.isnan(nm[3, 2]) and torch.isinf(nm[11, 7])
    bad = torch.zeros(n, p, dtype=torch.bool)
    bad[3, 2] = bad[11, 7] = True
    assert bool(torch.isfinite(nm[~bad]).all())
    assert torch.equal(nm[5], upd[1])
    assert bool(torch.isfinite(red[[c for c in range(p) if c not in (2, 7)]]).all())
    for m in (0, 3):
        upd = torch.as_tensor(rng.normal(size=(m, p)).astype(np.float32))
        nm, red = ops.memory_aggregate(mem.clone(), upd, torch.arange(m),
                                       torch.zeros(m, dtype=torch.bool), w)
        assert torch.equal(nm, mem)
        np.testing.assert_allclose(red.numpy(), (w @ mem).numpy(), atol=1e-6)


# ------------------------------------------- memagg's plans, pure functions
def _memagg_model(mem, upd, sel, valid, w, plan):
    """The CUDA kernel's algorithm in numpy: the inverse map row -> slot of
    the valid in-range slots, each row read once (from upd where it takes
    an update), then the kernel's order of the sum — per slab, row group y
    adds rows y, y + 8, ... ascending by fmaf from 0 (modelled in float64
    then rounded), the 8 groups added from group 0; on the cluster plan
    the slabs' sums added in ascending order from slab 0's.  A slab longer
    than one row map (MAP_ROWS rows) is taken in windows of that many rows,
    which leaves this order as it is.  Returns (panel, red)."""
    n, p = mem.shape
    slab = tag.memagg_slab(n, p, plan)
    slabs = -(-n // slab) if n > slab else 1
    slot = np.full(n, -1)
    for k in range(len(sel)):
        if valid[k] and 0 <= sel[k] < n:
            slot[sel[k]] = k
    x = np.where(slot[:, None] >= 0, upd[np.maximum(slot, 0)], mem) \
        if len(sel) else mem.copy()
    rows = np.minimum(slab, n - slab * np.arange(slabs))
    acc = np.zeros((slabs, 8, p), np.float32)
    y = np.arange(8)[None, :]
    for k in range(-(-slab // 8)):
        ok = y + 8 * k < rows[:, None]
        r = np.where(ok, slab * np.arange(slabs)[:, None] + y + 8 * k, 0)
        new = (w[r][..., None].astype(np.float64) * x[r] + acc) \
            .astype(np.float32)
        acc = np.where(ok[..., None], new, acc)
    part = acc[:, 0]
    for g in range(1, 8):
        part = part + acc[:, g]
    red = part[0]
    for j in range(1, slabs):
        red = red + part[j]
    return x, red


# the chip's memagg shapes (chip_smoke.py MEMAGG_SHAPES), the plans'
# crossover ± 1 row, and slabs past one row map on both plans
MEMAGG_SHAPES = [(30, 610, 6), (1024, 610, 102), (2000, 300, 700),
                 (4096, 2048, 410), (tag.SMALL_ROWS, 610, 6),
                 (tag.SMALL_ROWS + 1, 610, 7), (140000, 64, 100),
                 (300000, 2048, 30)]


@pytest.mark.parametrize("n,p,m", MEMAGG_SHAPES)
def test_memagg_plan_and_grid(n, p, m):
    """The plan is a pure function of the shape: the small plan (one
    launch) up to SMALL_ROWS rows, the cluster plan beyond, both taking
    any N.  The cluster plan cuts the rows into 2 to 16 slabs, as many as
    give each thread one batch of rows in flight where 16 allow."""
    assert tag.memagg_plan(n, p, m) == ("small" if n <= tag.SMALL_ROWS
                                        else "cluster")
    assert tag.memagg_plans(n, p, m) == ["small", "cluster"]
    assert tag.memagg_slab(n, p, "small") == n
    batch = tag.ROW_GROUPS * tag.ROWS_IN_FLIGHT
    slab = tag.memagg_slab(n, p, "cluster")
    assert 2 <= -(-n // slab) <= tag.CLUSTER_MOST
    assert slab <= batch or -(-n // slab) == tag.CLUSTER_MOST


def test_memagg_plans_at_their_limits():
    assert tag.memagg_plans(0, 5, 0) == ["small"]
    assert tag.memagg_plans(1, 5, 1) == ["small"]
    assert tag.memagg_plans(2, 5, 2) == ["small", "cluster"]
    assert tag.memagg_plan(tag.SMALL_ROWS, 5, 1) == "small"
    assert tag.memagg_plan(tag.SMALL_ROWS + 1, 5, 1) == "cluster"
    assert tag.memagg_slab(1 << 30, 2048, "cluster") == 1 << 26
    assert tag.MAP_ROWS % (tag.ROW_GROUPS * tag.ROWS_IN_FLIGHT) == 0


@pytest.mark.parametrize("plan", tag.PLANS)
@pytest.mark.parametrize("n,p,m", MEMAGG_SHAPES[:4] + [(140000, 3, 100)])
def test_memagg_kernel_order_model_vs_plain(rng, n, p, m, plan):
    """The kernel's algorithm, modelled in numpy on each plan: the panel
    bitwise the plain scatter's, red within the 1e-5 the card is held to
    (atol = rtol), with slots that are invalid or point outside the panel
    skipped."""
    mem = rng.normal(size=(n, p)).astype(np.float32)
    upd = rng.normal(size=(m, p)).astype(np.float32)
    sel = np.sort(rng.choice(n, size=m, replace=False))
    valid = rng.random(m) < 0.8
    w = rng.random(n).astype(np.float32)
    w = w / w.sum()
    out = sel.copy()
    out[:2] = (n, -1)                        # valid, outside the panel
    keep = valid.copy()
    keep[:2] = False
    pm, pr = tad.memory_scatter_reduce_ref(
        torch.as_tensor(mem.copy()), torch.as_tensor(upd),
        torch.as_tensor(sel), torch.as_tensor(keep), torch.as_tensor(w))
    vm = valid.copy()
    vm[:2] = True
    km, kr = _memagg_model(mem, upd, out, vm, w, plan)
    np.testing.assert_array_equal(km, pm.numpy())
    np.testing.assert_allclose(kr, pr.numpy(), atol=1e-5, rtol=1e-5)


# ----------------------------------------------------- robust combine rules
@pytest.mark.parametrize("mask", ["all", "some"])
def test_median_and_trimmed_mean_vs_reference(rng, mask):
    x = rng.normal(size=(7, 24)).astype(np.float32)
    x[2, 5] = np.nan
    valid = np.ones(7, bool) if mask == "all" else rng.random(7) < 0.7
    valid[0] = True
    jmed, jv = jad.coordinate_median(jnp.asarray(x), jnp.asarray(valid))
    tmed, tv = tad.coordinate_median(torch.as_tensor(x), torch.as_tensor(valid))
    np.testing.assert_array_equal(tmed.numpy(), np.asarray(jmed))
    assert int(tv) == int(jv)
    emed, ev = tad.coordinate_median(torch.zeros(0, 24),
                                     torch.zeros(0, dtype=torch.bool))
    assert int(ev) == 0 and torch.equal(emed, torch.zeros(24))
    for beta in (0.0, 0.2, 0.34):
        jtm, _ = jad.trimmed_mean_combine(jnp.asarray(x), jnp.asarray(valid),
                                          jnp.float32(beta))
        ttm, _ = tad.trimmed_mean_combine(torch.as_tensor(x),
                                          torch.as_tensor(valid),
                                          float(np.float32(beta)))
        _close(ttm, jtm, what=f"beta {beta}")


@pytest.mark.parametrize("m,p,poison", [
    pytest.param(5, 7, None, id="5-7"), pytest.param(16, 64, None, id="16-64"),
    pytest.param(33, 130, None, id="33-130"),
    pytest.param(64, 256, None, id="64-256"),
    pytest.param(1, 7, None, id="1-7"), pytest.param(2, 7, None, id="2-7"),
    pytest.param(6, 1, None, id="6-1"), pytest.param(9, 31, "nan", id="9-31-nan"),
    pytest.param(9, 31, "inf", id="9-31-inf")])
def test_krum_selection_vs_reference(rng, m, p, poison):
    """The shapes of tests/test_robust_aggregators.py's ref-vs-pallas
    test: the port's plain panel within f32 round-off of the reference's
    (atol 1e-2, rtol 1e-4, that test's bound), the selection bitwise.  Then
    the edges the CUDA kernel is held to: one and two rows, one column, and
    a row of NaN or a row holding inf (krum_select's clamps: NaN -> inf, at
    least 0)."""
    x = (rng.normal(size=(m, p)) * 3).astype(np.float32)
    valid = rng.random(m) < 0.9
    valid[0] = True
    if poison == "nan":
        x[4] = np.nan
    elif poison == "inf":
        x[4, 3] = np.inf
    if poison is not None:
        valid[4] = True
    np.testing.assert_allclose(
        np.maximum(tad.krum_pairwise_ref(torch.as_tensor(x)).numpy(), 0),
        np.maximum(np.asarray(jad.krum_pairwise_ref(jnp.asarray(x))), 0),
        atol=1e-2, rtol=1e-4)
    f = max(1, m // 5)
    want, wscores = jax.jit(jad.krum_select, static_argnums=(2, 3))(
        jnp.asarray(x), jnp.asarray(valid), f, 3)
    got, scores = tad.krum_select(torch.as_tensor(x), torch.as_tensor(valid),
                                  f, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fin = np.isfinite(np.asarray(wscores))
    np.testing.assert_array_equal(np.isfinite(scores.numpy()), fin)
    np.testing.assert_allclose(scores.numpy()[fin], np.asarray(wscores)[fin],
                               rtol=1e-4)


def test_krum_ties_break_by_row_index_and_poison_is_contained(rng):
    row = rng.normal(size=24).astype(np.float32)
    x = torch.as_tensor(np.stack([row] * 5 + [row + 100]))
    chosen, _ = tad.krum_select(x, torch.ones(6, dtype=torch.bool), 1, 2)
    assert chosen.tolist() == [True, True, False, False, False, False]
    chosen, scores = tad.krum_select(torch.full((5, 24), float("nan")),
                                     torch.ones(5, dtype=torch.bool), 1, 2)
    assert bool(torch.isinf(scores).all())
    assert chosen.tolist() == [True, True, False, False, False]
    x = rng.normal(size=(7, 24)).astype(np.float32)
    x[1] = x[4] = np.nan
    xt, valid = torch.as_tensor(x), torch.ones(7, dtype=torch.bool)
    honest = np.delete(x, [1, 4], axis=0)
    out, chosen, _ = tad.krum_combine(xt, valid, 2, 3)
    for got in (tad.coordinate_median(xt, valid)[0],
                tad.trimmed_mean_combine(xt, valid, 0.3)[0], out):
        got = got.numpy()
        assert np.isfinite(got).all()
        assert (got >= honest.min(0) - 1e-5).all()
        assert (got <= honest.max(0) + 1e-5).all()
    assert not bool(chosen[1]) and not bool(chosen[4])


def test_process_protocol_and_factory():
    assert tad.FAMILIES == jad.FAMILIES
    for name in jad.FAMILIES + ("multikrum", "fedproxw", "trimmedmean"):
        tp, jp = tad.make_aggregator_process(name), \
            jad.make_aggregator_process(name)
        assert (tp.name, tp.family) == (jp.name, jp.family)
        assert tp.params()["family"] == int(jp.params()["family"])
        np.testing.assert_array_equal(tp.params()["theta"],
                                      np.asarray(jp.params()["theta"]))
    with pytest.raises(ValueError):
        tad.make_aggregator_process("nope")
    with pytest.raises(ValueError):
        tad.make_aggregator_step(4, 2, {"w": torch.zeros(3)}, family="nope")
