"""The frozen copies in the benchmark equal the program's originals at
small sizes, and the roofline formulas reproduce the kernel table's
bounds (PERF.md)."""
import numpy as np
import pytest

import roofline
from traffic import availability
from traffic.synthetic import make_synthetic


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_equals_the_program(seed):
    from repro_torch.data.synthetic import make_synthetic as orig
    ds = orig(n_clients=12, seed=seed)
    got = make_synthetic(n_clients=12, seed=seed)
    for k in ("x", "y", "sizes", "x_val", "y_val", "label_dist",
              "opt_params"):
        np.testing.assert_array_equal(got[k], getattr(ds, k), err_msg=k)
    assert got["label_sets"] == ds.label_sets()


@pytest.mark.parametrize("mode", availability.MODES)
def test_mode_tables_equal_the_program(mode):
    from repro_torch.core.availability import make_mode
    data = make_synthetic(n_clients=20, seed=3)
    want = make_mode(mode, n_clients=20, data_sizes=data["sizes"],
                     label_sets=data["label_sets"], num_labels=10,
                     seed=99).probs_table()
    got = availability.probs_table(mode, sizes=data["sizes"],
                                   label_sets=data["label_sets"],
                                   num_labels=10, seed=99, period=20)
    np.testing.assert_array_equal(got, want)


def test_masks_follow_the_table_and_are_never_empty():
    table = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.5]])
    masks = availability.draw_masks(table, 400, np.random.default_rng(1))
    assert masks.shape == (400, 3) and masks.any(1).all()
    assert masks[1::2, 0].all() and not masks[1::2, 1].any()
    assert (masks[::2].sum(1) == 1).all()


@pytest.mark.parametrize("fn, args, ms", [
    (roofline.similarity, (30, 610), 2.29e-5),
    (roofline.swap_best_fused, (6, 30), 5.02e-7),
    (roofline.floyd_warshall, (4096,), 2.051),
    (roofline.memagg, (30, 610, 6), 2.70e-5),
    (roofline.greedy_argmax, (30,), 9.31e-8),
])
def test_roofline_reproduces_the_kernel_table(fn, args, ms):
    """Bound ms as PERF.md's kernel table states them (three figures); the
    greedy argmax with A_t and S both read (chip_smoke's ``b_taken``)."""
    assert fn(*args) * 1e3 == pytest.approx(ms, rel=5e-3)


def test_share_reads_nothing_without_the_kernel():
    ctx = {"trace": {"device": [("void other_kernel", 0.0, 2.0)]}}
    assert roofline.share(ctx, "masked_argmax", 1e-9) is None
    ctx["trace"]["device"].append(("void masked_argmax_kernel<1>", 0.0, 4.0))
    assert roofline.share(ctx, "masked_argmax", 1e-6) == pytest.approx(25.0)
