"""The port's fedsim launcher (``repro_torch.launch.fedsim``), the scan
engine's ``carry_shapes`` on the CPU.

Contracts: the round program against the reference's ``round_step`` on
the same inputs, the RNG seam filled with the reference's randint indices
(the aggregate within f32 round-off); the server pipeline's H within rtol
1e-4 of the reference's and its FedGS set bitwise the reference's given
the same H; the aggregator program within f32 round-off of the
reference's; ``carry_shapes`` equal to a real ``init_carry``'s shapes in
every flag combination, and the N = 10^5 psum panel at (12,500, P).
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.core.availability import make_mode
from repro_torch.core.availability_device import make_process
from repro_torch.core.sampler_device import fedgs_select, make_sampler_process
from repro_torch.data.synthetic import make_synthetic
from repro_torch.fed.aggregator_device import make_aggregator_process
from repro_torch.fed.faults_device import make_fault_process
from repro_torch.fed.models import logistic_regression
from repro_torch.fed.scan_engine import LeafShape, ScanConfig, ScanEngine
from repro_torch.launch import fedsim as tfs

TINY = float(np.finfo(np.float32).tiny)
N, M_SEL, N_MAX, E, B = 64, 6, 16, 3, 4


@pytest.fixture(scope="module")
def jfs():
    """The reference's fedsim module.  Importing it sets XLA_FLAGS for a
    512-device host; the backend is brought up first (so this process
    keeps its devices) and the variable is restored after."""
    import jax
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import fedsim
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return fedsim


def _jnp(tree):
    import jax.numpy as jnp
    if isinstance(tree, torch.Tensor):
        return jnp.asarray(tree.cpu().numpy())
    return {k: _jnp(v) for k, v in tree.items()}


# --------------------------------------------------------- the programs
def test_round_step_vs_reference(jfs):
    import jax
    import jax.numpy as jnp
    gp, xs, ys, sizes, lr, _ = tfs.round_inputs(M_SEL, N_MAX, E, B,
                                                device="cpu", seed=3)
    keys = jax.random.split(jax.random.PRNGKey(7), M_SEL)
    # the reference's in-program draws, handed in through the seam
    idx = np.stack([np.stack([np.asarray(jax.random.randint(
        sk, (B,), 0, max(int(sizes[c]), 1)))
        for sk in jax.random.split(keys[c], E)]) for c in range(M_SEL)])
    got = tfs.round_step_factory(E, B)(gp, xs, ys, sizes, lr,
                                       torch.as_tensor(idx, dtype=torch.int64))
    want = jfs.round_step_factory(E, B)(
        _jnp(gp), _jnp(xs), jnp.asarray(ys.numpy(), jnp.int32),
        jnp.asarray(sizes.numpy(), jnp.int32), jnp.float32(lr), keys)
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-6, rtol=1e-5)


def test_graph_pipeline_vs_reference(jfs):
    import jax.numpy as jnp
    from repro.core.graph_device import GraphConfig, build_h

    from repro_torch.core.graph_device import GraphConfig as TConfig
    from repro_torch.core.graph_device import build_h as tbuild_h
    feats, counts, avail = tfs.pipeline_inputs(N, device="cpu", seed=5)
    args = (jnp.asarray(feats.numpy()), jnp.asarray(counts.numpy()),
            jnp.asarray(avail.numpy()))
    h_ref = np.asarray(build_h(args[0], GraphConfig(eps=0.1, sigma2=0.01)))
    h = tbuild_h(feats, TConfig(eps=0.1, sigma2=0.01)).numpy()
    np.testing.assert_allclose(h, h_ref, rtol=1e-4, atol=TINY)
    want = np.asarray(jfs.graph_pipeline(*args, 1.0, M_SEL, 32))
    # the solve given the reference's H: the same set, bitwise
    same_h = fedgs_select(torch.as_tensor(h_ref.copy()), counts, avail, 1.0,
                          m=M_SEL, max_sweeps=32)
    assert np.array_equal(same_h.numpy(), want)
    got = tfs.graph_pipeline(feats, counts, avail, 1.0, M_SEL, 32)
    assert np.array_equal(got.numpy(), want) and int(got.sum()) == M_SEL


@pytest.mark.parametrize("family", ["fedavg", "memory", "fedadam"])
def test_aggregator_program_vs_reference(jfs, family):
    import jax.numpy as jnp
    apply, (state, upd, wts, s, avail, t) = tfs.aggregator_program(
        family, N, M_SEL, device="cpu", seed=2)
    japply, _ = jfs.aggregator_program(family, N, M_SEL)
    jstate = {k: _jnp(v) for k, v in state.items()}
    want, _ = japply(jstate, _jnp(upd), _jnp(wts), _jnp(s), _jnp(avail),
                     jnp.int32(t))
    got, new_state = apply(state, upd, wts, s, avail, t)
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, rtol=1e-5)
    if family == "memory":
        # the selected clients' rows hold their flat updates (b, then w)
        rows = torch.nonzero(s).flatten()
        flat = torch.cat([upd["b"], upd["w"].reshape(M_SEL, -1)], 1)
        assert torch.equal(new_state["mem"][rows], flat)


def test_run_record_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(tfs, "RESULTS_DIR", tmp_path)
    rec = tfs.run(N, device="cpu", aggregator="memory", n_max=N_MAX,
                  local_steps=E, batch=B, force=True)
    assert rec["ok"], rec.get("traceback")
    # the cohort padded to pod1's dp width, 16 (the reference's)
    m = tfs.cohort_size(N, 0.1, 16)
    assert m == 16 and rec["dp"] == 16
    assert rec["round"]["m_sampled"] == m
    assert rec["server_pipeline"]["n_selected"] == m
    assert rec["round"]["device_ms"] == "not measured (CPU)"
    assert rec["round"]["flops"] > 0 and rec["dominant"] in (
        "compute", "memory", "collective")
    saved = json.loads((tmp_path / "fedsim__c64__pod1__memory.json")
                       .read_text())
    assert saved["server_pipeline"]["selected"] == \
        rec["server_pipeline"]["selected"]
    # the set is the one fedgs_select gives on the same H, outside the twin
    from repro_torch.core.graph_device import GraphConfig, build_h
    feats, counts, avail = tfs.pipeline_inputs(N, device="cpu")
    s = fedgs_select(build_h(feats, GraphConfig()), counts, avail, 1.0,
                     m=m, max_sweeps=32)
    assert torch.nonzero(s).flatten().tolist() == \
        rec["server_pipeline"]["selected"]
    # two pods: dp 32, the record under pod2
    pod2 = tfs.run(N, multi_pod=True, device="cpu", force=True,
                   n_max=N_MAX, local_steps=E, batch=B)
    assert pod2["ok"], pod2.get("traceback")
    assert pod2["mesh"] == "pod2" and pod2["dp"] == 32
    assert pod2["round"]["m_sampled"] == 32
    assert (tmp_path / "fedsim__c64__pod2.json").exists()
    assert tfs.main(["--clients", "64", "--multi-pod", "--device", "cpu",
                     "--force"]) == 0


@pytest.mark.parametrize("multi_pod", (False, True))
@pytest.mark.parametrize("n_clients", (30, 100, 4096))
def test_cohort_is_the_reference_formula(n_clients, multi_pod):
    """The reference's cohort (src/repro/launch/fedsim.py:228-233):

        m_sel = max(dp_total, int(round(sample_frac * n_clients)))
        m_sel = ((m_sel + dp_total - 1) // dp_total) * dp_total

    with dp_total the product of the dp axes of its production mesh (the
    reference's ``run`` needs 512 host devices, so the formula runs here
    on its axis map over a duck-typed mesh).  N = 30 and 100 have
    round(0.1·N) below dp."""
    from types import SimpleNamespace

    from repro.launch import mesh as jmesh
    shape, names = ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
        else ((16, 16), ("data", "model"))
    jm = SimpleNamespace(axis_names=names, devices=np.empty(shape))
    dp_total = jmesh.make_shard_ctx(jm).dp_size
    sample_frac = 0.1
    m_sel = max(dp_total, int(round(sample_frac * n_clients)))
    m_sel = ((m_sel + dp_total - 1) // dp_total) * dp_total
    dp = tfs.dp_width(multi_pod=multi_pod)
    assert dp == dp_total == (32 if multi_pod else 16)
    assert tfs.cohort_size(n_clients, sample_frac, dp) == m_sel
    if n_clients == 4096:
        assert m_sel == 416
    else:
        assert round(sample_frac * n_clients) < dp and m_sel == dp


def test_kernel_work_formulas():
    w = tfs.kernel_work(4096, 410, 10, 610)
    assert w["floyd_warshall"] == (2 * 4096 ** 3, 8 * 4096 ** 2)
    assert w["greedy_argmax"] == (4 * 4096, 9 * 4096)
    assert w["swap_best_fused"][0] == 10 * 410 * 4096
    assert w["memagg"][0] == 2 * 4096 * 610


# ------------------------------------------------------------ carry_shapes
def _shapes(tree):
    if isinstance(tree, torch.Tensor):
        return LeafShape(tuple(tree.shape), tree.dtype)
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tree


FLAGS = [("fedavg", "none", 0, False), ("memory", "none", 0, False),
         ("memory", "sign_flip", 0, True), ("krum", "straggler_stale", 0,
                                            False),
         ("memory", "straggler_stale", 3, True), ("fedadam", "none", 3,
                                                  False)]


@pytest.mark.parametrize("agg,fault,refresh,telemetry", FLAGS)
def test_carry_shapes_equal_init_carry(agg, fault, refresh, telemetry):
    ds = make_synthetic(n_clients=16, alpha=0.5, beta=0.5, seed=0)
    cfg = ScanConfig(rounds=3, m=3, local_steps=2, batch_size=4,
                     graph_refresh_every=refresh, telemetry=telemetry)
    eng = ScanEngine(ds, logistic_regression(), cfg, device="cpu")
    cells = [eng.cell(
        seed=s, process=make_process(("GE", "CLUSTER")[s], n_clients=16,
                                     data_sizes=ds.sizes, rounds=3),
        sampler_process=make_sampler_process("uniform"),
        aggregator_process=make_aggregator_process(
            agg if s == 0 else "fedavg"),
        fault_process=make_fault_process(fault, 16, frac=0.25))
        for s in range(2)]
    assert eng.carry_shapes(cells) == _shapes(eng.init_carry(cells).tree)


def test_carry_shapes_on_a_mesh_and_masks():
    """Mesh shapes read only cfg.mesh: the first cells-row's block of the
    padded batch, the psum panel's N/silo rows, tau global."""
    ds = make_synthetic(n_clients=16, alpha=0.5, beta=0.5, seed=0)
    cfg = ScanConfig(rounds=3, m=3, local_steps=2, batch_size=4,
                     sampler="uniform", aggregator="memory", mesh=(2, 4),
                     silo_reduce="psum")
    eng = ScanEngine(ds, logistic_regression(), cfg, device="cpu")
    cells = [eng.cell(seed=s, mode=make_mode("IDL", n_clients=16))
             for s in range(3)]
    shapes = eng.carry_shapes(cells)
    assert shapes["counts"].shape == (2, 16)        # 3 cells padded to 4
    assert shapes["agg"][0]["mem"].shape == (4, 610)
    assert shapes["agg"][0]["tau"].shape == (16,)
    gather = ScanEngine(ds, logistic_regression(), ScanConfig(
        rounds=3, m=3, sampler="uniform", aggregator="memory", mesh=(2, 4),
        cell_sharding=False), device="cpu")
    shapes = gather.carry_shapes(cells)
    assert shapes["counts"].shape == (3, 16)
    assert shapes["agg"][0]["mem"].shape == (16, 610)
    odd = ScanEngine(make_synthetic(n_clients=15, alpha=0.5, beta=0.5,
                                    seed=0), logistic_regression(), cfg,
                     device="cpu")
    with pytest.raises(ValueError, match="divide"):
        odd.carry_shapes([odd.cell(seed=0, mode=make_mode(
            "IDL", n_clients=15))])


def test_datacenter_cell_dryrun_panel_rows():
    lowered, shapes = tfs.datacenter_cell_dryrun(device="cpu")
    assert lowered is None
    p = 8 * 4 + 4
    assert shapes["agg"][0]["mem"] == LeafShape((12_500, p), torch.float32)
    assert shapes["counts"].shape == (1, 100_000)
    with pytest.raises(ValueError, match="divide"):
        tfs.datacenter_cell_dryrun(n_clients=1001, mesh=(1, 8),
                                   device="cpu")
