"""Planner, partitioner, and two-level reorder tests (SURVEY.md §4: permutation
round-trip + invariants as real unit tests)."""
import numpy as np
import pytest

from ehyb_spmv.config import EhybConfig, WINDOW_ALIGN
from ehyb_spmv.core.coo import deterministic_x, oracle_spmv
from ehyb_spmv.core.planner import make_plan
from ehyb_spmv.core.reorder import (identity_reordering,
                                            two_level_reorder,
                                            in_window_counts)
from ehyb_spmv.io import generate
from ehyb_spmv.partition import (edge_cut, partition_blocks,
                                         partition_rows)


def test_plan_small_fits_one_window():
    cfg = EhybConfig()
    plan = make_plan(4000, cfg)
    assert plan.n_parts == 1
    assert plan.window_rows >= 4000
    assert plan.window_rows % WINDOW_ALIGN == 0


def test_plan_budget_forces_parts():
    cfg = EhybConfig(window_budget_bytes=64 * 1024)  # 16k f32 rows
    plan = make_plan(100_000, cfg)
    assert plan.n_parts >= 7
    assert plan.window_rows * 4 <= 2 * cfg.window_budget_bytes
    # window covers one balanced partition with slack
    assert plan.window_rows >= -(-100_000 // plan.n_parts)


def test_plan_explicit_window():
    cfg = EhybConfig(window_rows=2048)
    plan = make_plan(10_000, cfg)
    assert plan.window_rows == 2048
    assert plan.n_parts == 5


def test_partition_blocks_balanced():
    labels = partition_blocks(1000, 7)
    sizes = np.bincount(labels, minlength=7)
    assert sizes.max() - sizes.min() <= 1
    assert labels.max() == 6


def test_reorder_roundtrip(poisson_mid):
    m = poisson_mid
    cfg = EhybConfig(window_rows=1024)
    plan = make_plan(m.dimension, cfg)
    labels = partition_rows(m, plan.n_parts, "blocks")
    r = two_level_reorder(m, labels, plan, sort_rows=True)

    # permutation validity
    assert np.array_equal(np.sort(r.new_to_old), np.arange(m.dimension))
    assert np.array_equal(r.old_to_new[r.new_to_old], np.arange(m.dimension))

    # vector round trip (vectorReorder → vectorRecover == identity)
    x = deterministic_x(m.dimension)
    np.testing.assert_array_equal(r.vector_recover(r.vector_reorder(x)), x)

    # SpMV commutes with symmetric permutation:
    # recover(A_r · reorder(x)) == A · x
    m_r = r.apply_to_matrix(m)
    y_r = oracle_spmv(m_r, r.vector_reorder(x))
    np.testing.assert_allclose(r.vector_recover(y_r), oracle_spmv(m, x),
                               rtol=1e-13)


def test_reorder_boundaries_aligned(poisson_mid):
    m = poisson_mid
    cfg = EhybConfig(window_rows=1024)
    plan = make_plan(m.dimension, cfg)
    labels = partition_rows(m, plan.n_parts, "blocks")
    r = two_level_reorder(m, labels, plan)
    assert r.boundaries[0] == 0 and r.boundaries[-1] == m.dimension
    assert np.all(np.diff(r.boundaries) >= 0)
    interior = r.boundaries[1:-1]
    assert np.all(interior % plan.part_align == 0)


def test_density_sort_descending_within_partition(powerlaw_small):
    m = powerlaw_small
    cfg = EhybConfig(window_rows=1024)
    plan = make_plan(m.dimension, cfg)
    labels = partition_rows(m, plan.n_parts, "blocks")
    r = two_level_reorder(m, labels, plan, sort_rows=True)
    m_r = r.apply_to_matrix(m)
    counts = in_window_counts(m_r.row, m_r.col, r.boundaries, plan.window_rows,
                              m.dimension)
    # within each partition, in-window counts are non-increasing
    for p in range(r.n_parts):
        lo, hi = r.boundaries[p], r.boundaries[p + 1]
        seg = counts[lo:hi]
        assert np.all(np.diff(seg) <= 0), f"partition {p} not density-sorted"


def test_identity_reordering():
    r = identity_reordering(10, np.array([0, 10]))
    x = np.arange(10.0)
    np.testing.assert_array_equal(r.vector_reorder(x), x)
    assert r.n_parts == 1


def test_edge_cut_blocks_vs_scrambled(scrambled):
    # A banded matrix partitioned in blocks has a small cut; scrambling the
    # rows makes the block cut terrible (this is why the partitioner exists).
    m_banded = generate.poisson2d(48)
    labels = partition_blocks(m_banded.dimension, 8)
    cut_banded = edge_cut(m_banded, labels)
    cut_scrambled = edge_cut(scrambled, partition_blocks(scrambled.dimension, 8))
    assert cut_banded < cut_scrambled / 5


# --- ordering strategies (core/ordering.py) --------------------------------

def test_rcm_reduces_bandwidth(scrambled):
    from ehyb_spmv.core.ordering import rcm_order, reordering_from_order

    m = scrambled
    order = rcm_order(m)
    assert np.array_equal(np.sort(order), np.arange(m.dimension))
    r = reordering_from_order(order, m.dimension)
    m_r = r.apply_to_matrix(m)
    bw_before = np.abs(m.row - m.col).max()
    bw_after = np.abs(m_r.row - m_r.col).max()
    assert bw_after < bw_before / 4


def test_native_rcm_equivalence(scrambled, powerlaw_small, monkeypatch):
    """native/rcm.cpp must be bit-identical to the NumPy level-set RCM —
    cached artifacts are keyed on the ordering's OUTPUT staying stable, so a
    divergence would silently mix stale and fresh layouts."""
    from ehyb_spmv.core.ordering import rcm_order

    for m in (scrambled, powerlaw_small):
        monkeypatch.setenv("EHYB_NATIVE_RCM", "0")
        ref = rcm_order(m)
        monkeypatch.setenv("EHYB_NATIVE_RCM", "1")
        got = rcm_order(m)
        np.testing.assert_array_equal(got, ref)


def test_native_adjacency_equivalence(scrambled, powerlaw_small, monkeypatch):
    """native ehyb_adjacency must match partition.py's NumPy formulation
    exactly: per-row ascending dedup'd neighbors, diagonal dropped."""
    from ehyb_spmv.partition import adjacency_csr

    for m in (scrambled, powerlaw_small):
        monkeypatch.setenv("EHYB_NATIVE_ADJ", "0")
        xr, ar = adjacency_csr(m)
        monkeypatch.setenv("EHYB_NATIVE_ADJ", "1")
        xn, an = adjacency_csr(m)
        np.testing.assert_array_equal(xn, xr)
        np.testing.assert_array_equal(an, ar)


def test_native_rcm_disconnected_and_empty():
    """Multi-component + isolated-vertex graph: every component gets its own
    min-degree seed, isolated vertices order as singleton levels."""
    from ehyb_spmv.core.coo import MatrixCOO
    from ehyb_spmv.core.ordering import rcm_order

    # two 3-cliques + 2 isolated vertices (diagonal-only rows)
    row = np.array([0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 7])
    col = np.array([1, 2, 0, 2, 0, 1, 4, 5, 3, 5, 3, 4, 6, 7])
    m = MatrixCOO(8, 8, row, col, np.ones(row.size))
    import os
    old = os.environ.get("EHYB_NATIVE_RCM")
    try:
        os.environ["EHYB_NATIVE_RCM"] = "0"
        ref = rcm_order(m)
        os.environ["EHYB_NATIVE_RCM"] = "1"
        got = rcm_order(m)
    finally:
        if old is None:
            os.environ.pop("EHYB_NATIVE_RCM", None)
        else:
            os.environ["EHYB_NATIVE_RCM"] = old
    np.testing.assert_array_equal(got, ref)
    assert np.array_equal(np.sort(got), np.arange(8))


def test_rcm_roundtrip(scrambled):
    from ehyb_spmv.core.ordering import rcm_order, reordering_from_order
    from ehyb_spmv.core.coo import deterministic_x, oracle_spmv

    r = reordering_from_order(rcm_order(scrambled), scrambled.dimension)
    x = deterministic_x(scrambled.dimension)
    y_r = oracle_spmv(r.apply_to_matrix(scrambled), r.vector_reorder(x))
    np.testing.assert_allclose(r.vector_recover(y_r),
                               oracle_spmv(scrambled, x), rtol=1e-12)


def test_estimator_prefers_banded(scrambled):
    from ehyb_spmv.core.ordering import (estimate_mw_steps, rcm_order,
                                                 reordering_from_order)

    m = scrambled
    cost_scrambled = estimate_mw_steps(m.row, m.col, m.dimension)
    r = reordering_from_order(rcm_order(m), m.dimension)
    m_r = r.apply_to_matrix(m)
    cost_rcm = estimate_mw_steps(m_r.row, m_r.col, m.dimension)
    assert cost_rcm < cost_scrambled


def test_pick_ordering_auto(scrambled):
    from ehyb_spmv.core.ordering import pick_ordering
    from ehyb_spmv.config import EhybConfig
    from ehyb_spmv.core.planner import make_plan

    cfg = EhybConfig(window_rows=1024, body_layout="sell_mw")
    plan = make_plan(scrambled.dimension, cfg)
    r = pick_ordering(scrambled, plan, cfg, "auto")
    assert np.array_equal(np.sort(r.new_to_old), np.arange(scrambled.dimension))


def test_native_partitioner_beats_blocks_on_scrambled(scrambled):
    """VERDICT r1 #9: the native multilevel k-way partitioner must earn its
    keep — materially lower edge cut than contiguous blocks on a matrix
    whose structure is hidden by a random permutation (a silent quality
    regression in native/partition.cpp would otherwise pass the suite).
    The quality metric is the one mt-metis itself reports (r_edgecut,
    reordering.c:136)."""
    from ehyb_spmv.partition import edge_cut, partition_rows

    m = scrambled
    n_parts = 8
    lab_blocks = partition_rows(m, n_parts, "blocks")
    lab_native = partition_rows(m, n_parts, "native")
    cut_blocks = edge_cut(m, lab_blocks)
    cut_native = edge_cut(m, lab_native)
    # scrambled 5-point Laplacian: contiguous blocks cut ~everything, a real
    # partitioner recovers locality — demand a decisive margin
    assert cut_native < 0.7 * cut_blocks, (cut_native, cut_blocks)
    # balance sanity: largest part within 2x of ideal
    counts = np.bincount(lab_native, minlength=n_parts)
    assert counts.max() <= 2.0 * (m.dimension / n_parts), counts


def test_ordering_sampled_estimates(poisson_mid, monkeypatch):
    """The >20M-nnz sampled-estimate path must pick the same ordering as the
    full estimate (exercised by shrinking the cap)."""
    import ehyb_spmv.core.ordering as od
    from ehyb_spmv.config import EhybConfig, WINDOW_ALIGN
    from ehyb_spmv.core.planner import make_plan

    m = poisson_mid
    cfg = EhybConfig(window_rows=WINDOW_ALIGN, body_layout="sell_mw")
    plan = make_plan(m.dimension, cfg)
    r_full = od.pick_ordering(m, plan, cfg, "auto")
    monkeypatch.setattr(od, "SAMPLE_CAP", 2000)
    r_sampled = od.pick_ordering(m, plan, cfg, "auto")
    # a structured matrix must keep its natural/banded ordering either way
    np.testing.assert_array_equal(r_full.new_to_old, r_sampled.new_to_old)


def test_partition_futility_skip(monkeypatch):
    """A gather-wall matrix (best RCM candidate >> the nnz floor) must not
    pay the partitioner build — the most expensive candidate shaves ~1% there
    (261 s on the powerlaw_1m split body); EHYB_ORDER_PART_SKIP=0 forces it."""
    import ehyb_spmv.core.ordering as od
    import ehyb_spmv.partition as pt

    m = generate.random_general(1 << 16, 8, seed=7)
    cfg = EhybConfig(window_rows=1024)
    plan = make_plan(m.dimension, cfg)
    calls = []
    real = pt.partition_rows
    monkeypatch.setattr(pt, "partition_rows",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    r = od.pick_ordering(m, plan, cfg, "auto")
    assert calls == [], "partition candidates should be skipped"
    assert np.array_equal(np.sort(r.new_to_old), np.arange(m.dimension))
    monkeypatch.setenv("EHYB_ORDER_PART_SKIP", "0")
    od.pick_ordering(m, plan, cfg, "auto")
    assert calls, "EHYB_ORDER_PART_SKIP=0 must force the partition build"


def test_partition_futility_gate_spares_recoverable_structure(monkeypatch):
    """The futility gate must NOT fire when RCM materially beat the natural
    ordering: a large scrambled stencil can sit far above the nnz floor
    under RCM (permuted_poisson_1024: 82x) while RCM is still ~46x better
    than natural — structure IS recoverable and the partition candidates
    are worth their build (measured 31 -> ~40 GFLOP/s there).  The gate's
    gather-wall signature is BOTH far-above-floor AND rcm ~ natural."""
    import ehyb_spmv.core.ordering as od
    import ehyb_spmv.partition as pt

    m = generate.permuted(generate.poisson2d(256), seed=5)
    cfg = EhybConfig(window_rows=1024)
    plan = make_plan(m.dimension, cfg)
    calls = []
    real = pt.partition_rows
    monkeypatch.setattr(pt, "partition_rows",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    # tiny skip_k makes the floor condition always true — only the
    # rcm-vs-natural discriminator can keep the partitioner in play
    monkeypatch.setenv("EHYB_ORDER_PART_SKIP", "0.001")
    od.pick_ordering(m, plan, cfg, "auto")
    assert calls, ("partition candidates must be evaluated when RCM "
                   "recovered real structure (rcm << natural)")
