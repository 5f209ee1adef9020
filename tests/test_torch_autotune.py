"""The port's plan table (``repro_torch.kernels.autotune``) against the
reference's tile table (``repro.kernels.autotune``) on the CPU: the same
tiers, keys and tie-break; a deterministic, byte-identical table from a
stub timer (``tests/test_kernels.py``'s autotune tests, for the port's
plans); ``resolve`` taking a winner only where it takes the call's shape;
the committed ``tuned_plans.json`` holding card entries only; and the
default-plan functions reading the table."""
import json

import numpy as np
import pytest

from repro.kernels import autotune as jat

from repro_torch.kernels import aggregate as tag
from repro_torch.kernels import autotune as tat
from repro_torch.kernels import floyd_warshall as tfw
from repro_torch.kernels import krum as tkr
from repro_torch.kernels import solver as tsv


def test_tier_key_and_pick_best_equal_the_reference():
    rng = np.random.default_rng(0)
    for _ in range(300):
        names = rng.choice(["n", "m", "p", "d"], size=rng.integers(1, 4),
                           replace=False)
        dims = {str(k): int(v) for k, v in
                zip(names, rng.integers(1, 70000, size=len(names)))}
        assert tat.shape_tier(**dims) == jat.shape_tier(**dims)
        tier = tat.shape_tier(**dims)
        assert tat.table_key("swap_gain", tier, "cuda") == \
            jat.table_key("swap_gain", tier, "cuda")
        timed = [({"plan": str(i)}, float(v)) for i, v in
                 enumerate(rng.integers(0, 4, size=rng.integers(1, 6)))]
        assert tat.pick_best(timed) == jat.pick_best(timed)
    assert tat.shape_tier(n=1500) == "n2048"
    assert tat.shape_tier(n=100, p=640) == "n128,p1024"


def test_default_specs_are_the_reference_tiers():
    """The same six kernel keys and, at the reference's max_n, the same
    (kernel, tier) pairs."""
    for max_n in (1024, 4096):
        ours = {(k, tat.shape_tier(**d)) for k, d in
                tat.default_specs(max_n)}
        ref = {(k, jat.shape_tier(**d)) for k, d in jat.default_specs(max_n)}
        assert ours == ref
    assert set(tat.KERNELS) == set(jat.KERNELS)


def test_candidates_are_the_plans_that_take_the_shape():
    assert tat.candidates("floyd_warshall", n=256) == [
        {"plan": q} for q in tfw.PLANS]
    assert tat.candidates("floyd_warshall", n=257) == [
        {"plan": "blocked32"}, {"plan": "blocked64"}]
    assert tat.candidates("swap_gain", m=64, n=1024) == [{"plan": "grid"}]
    assert tat.candidates("swap_gain", m=8, n=1024) == [
        {"plan": "small"}, {"plan": "grid"}]
    assert tat.candidates("greedy_argmax", n=128) == [
        {"plan": "warp"}, {"plan": "block"}]
    assert tat.candidates("greedy_argmax", n=1024) == [{"plan": "block"}]
    assert tat.candidates("memory_aggregate", n=256, p=1024) == [
        {"plan": q} for q in tag.PLANS]
    assert tat.candidates("krum_pairwise", m=128, p=1024) == [
        {"plan": q} for q in tkr.PLANS]


def test_tune_determinism(tmp_path):
    """Same timing table in -> byte-identical table out (a stub timer: no
    kernel runs here)."""
    def stub_timer(fn):
        stub_timer.calls += 1
        return float(10 + stub_timer.calls % 7)
    specs = [("floyd_warshall", {"n": 256}), ("swap_gain", {"m": 64,
                                                             "n": 2048}),
             ("memory_aggregate", {"n": 256, "p": 1024}),
             ("krum_pairwise", {"m": 128, "p": 1024})]
    texts = []
    for rep in range(2):
        stub_timer.calls = 0
        table = tat.tune(specs, timer=stub_timer, device="cpu",
                         base_table={}, verbose=False)
        p = tmp_path / f"t{rep}.json"
        tat.save_table(table, p)
        texts.append(p.read_text())
    assert texts[0] == texts[1]
    stub_timer.calls = 0
    table = tat.tune(specs, timer=stub_timer, device="cpu", base_table={},
                     verbose=False)
    assert set(table) == {"floyd_warshall|n256|cuda",
                          "swap_gain|m64,n2048|cuda",
                          "memory_aggregate|n256,p1024|cuda",
                          "krum_pairwise|m128,p1024|cuda"}
    for entry in table.values():
        assert entry["mode"] == "compiled"
        assert entry["tiles"] in [c[0] for c in entry["candidates"]]
        assert entry["ms"] == min(c[1] for c in entry["candidates"])
    # the first of equal times wins: calls 1, 2, 3 -> 11, 12, 13 ms
    assert table["floyd_warshall|n256|cuda"]["tiles"] == {"plan": "single"}


def test_pick_best_tie_break():
    timed = [({"plan": "a"}, 2.0), ({"plan": "b"}, 1.0),
             ({"plan": "c"}, 1.0)]
    assert tat.pick_best(timed) == ({"plan": "b"}, 1.0)


def _table(tmp_path, entries):
    path = tmp_path / "plans.json"
    tat.save_table({tat.table_key(k, tier): {"tiles": tiles, "ms": 1.0,
                                             "mode": "compiled",
                                             "candidates": []}
                    for (k, tier), tiles in entries.items()}, path)
    return path


def test_resolve_and_fallback(tmp_path):
    path = _table(tmp_path, {
        ("floyd_warshall", "n256"): {"plan": "single", "rogue": 9},
        ("floyd_warshall", "n512"): {"plan": "single"},
        ("greedy_argmax", "n256"): {"plan": "warp"},
        ("memory_aggregate", "n1024,p1024"): {"plan": "small"}})

    def fw(n, heur):
        return tat.resolve("floyd_warshall", {"plan": heur}, path=path,
                           takes=lambda q: tat.fw_takes(q, n), n=n)
    assert fw(200, "blocked32") == {"plan": "single"}     # rogue filtered
    assert fw(2000, "blocked32") == {"plan": "blocked32"}  # no n2048 entry
    # a winner that does not take the call's shape: the heuristic
    assert fw(300, "blocked32") == {"plan": "blocked32"}   # single <= 256
    assert tat.resolve("greedy_argmax", {"plan": "block"}, path=path,
                       takes=lambda q: tat.argmax_takes(q, 200),
                       n=200) == {"plan": "block"}         # warp <= 128
    assert tat.resolve("memory_aggregate", {"plan": "cluster"}, path=path,
                       takes=lambda q: tat.memagg_takes(q, 1000, 610),
                       n=1000, p=610) == {"plan": "small"}
    assert tat.resolve("memory_aggregate", {"plan": "cluster"}, path=path,
                       n=1000, p=2000) == {"plan": "cluster"}


def test_memagg_plan_reads_the_table(tmp_path, monkeypatch):
    """memagg_plan is pure Python: it takes the table's winner for its
    tier, and the heuristic outside the covered tiers."""
    path = _table(tmp_path, {("memory_aggregate", "n1024,p1024"):
                             {"plan": "small"}})
    monkeypatch.setattr(tat, "TABLE_PATH", path)
    assert tag.memagg_plan(1000, 610, 100) == "small"
    assert tag.memagg_plan(2000, 610, 100) == "cluster"
    assert tag.memagg_plan(30, 610, 6) == "small"


def test_argmax_warp_limit_is_the_c_constant():
    src = (tat.Path(tsv.__file__).parent / "csrc" / "solver.cu").read_text()
    assert f"constexpr int kArgmaxWarpMost = {tsv.ARGMAX_WARP_MOST};" in src


def test_committed_table_holds_card_entries_only():
    """tuned_plans.json: written by a card run — `|cuda` keys only, each
    naming the card and its power limit, every winner among its
    candidates and taking its spec's shape, the reference's tiers."""
    table = json.loads(tat.TABLE_PATH.read_text())
    assert table, "the committed plan table is empty"
    tiers = {tat.table_key(k, tat.shape_tier(**d)): (k, d)
             for k, d in tat.default_specs(4096)}
    for key, entry in table.items():
        assert key.endswith("|cuda") and key in tiers, key
        assert "H100" in entry["device"] and entry["power_limit"], key
        assert entry["mode"] == "compiled"
        assert entry["tiles"] in [c[0] for c in entry["candidates"]], key
        kernel, dims = tiers[key]
        assert entry["spec"] == dims
        if kernel != "fused_3dg":          # its takes asks the C library
            assert entry["tiles"] in tat.candidates(kernel, **dims), key


def test_resolved_plans_take_every_size_of_their_tier():
    """Wherever the committed table's winner does not take a size of its
    tier, resolve returns the heuristic (sizes at the tier's edges)."""
    table = tat.load_table()
    for key, entry in table.items():
        kernel, tier, _ = key.split("|")
        plan = entry["tiles"]["plan"]
        if kernel not in ("floyd_warshall", "greedy_argmax", "swap_gain"):
            continue
        dims = {k[0]: int(k[1:]) for k in tier.split(",")}
        takes = {"floyd_warshall": tat.fw_takes,
                 "greedy_argmax": tat.argmax_takes,
                 "swap_gain": tat.swap_gain_takes}[kernel]
        for pick in (0, 1):
            shape = {k: tat.tier_range(v)[pick] for k, v in dims.items()}
            got = tat.resolve(kernel, {"plan": "HEUR"},
                              takes=lambda q: takes(q, **shape), **shape)
            want = plan if takes(plan, **shape) else "HEUR"
            assert got == {"plan": want}, (key, shape)


@pytest.mark.parametrize("n,lo,hi", [(1, 1, 1), (2, 2, 2), (4096, 2049,
                                                            4096)])
def test_tier_range(n, lo, hi):
    assert tat.tier_range(n) == (lo, hi)
    assert tat.shape_tier(n=lo) == tat.shape_tier(n=hi) == f"n{n}"
