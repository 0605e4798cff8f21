"""COO→EHYB conversion invariants (SURVEY.md §4: nnz conservation, width
bounds, padding accounting, exact reconstruction)."""
import numpy as np
import pytest

from ehyb_spmv.config import EhybConfig
from ehyb_spmv.core.convert import coo_to_ehyb, verify_conversion
from ehyb_spmv.core.coo import deterministic_x, oracle_spmv
from ehyb_spmv.core.ehyb import EhybMatrix
from ehyb_spmv.core.planner import make_plan
from ehyb_spmv.core.reorder import two_level_reorder
from ehyb_spmv.io import generate
from ehyb_spmv.partition import partition_rows


def build(m, cfg=None, sort_rows=True):
    cfg = cfg or EhybConfig(window_rows=1024, dtype="float64")
    plan = make_plan(m.dimension, cfg)
    labels = partition_rows(m, plan.n_parts, "blocks")
    r = two_level_reorder(m, labels, plan, sort_rows=sort_rows)
    m_r = r.apply_to_matrix(m)
    e = coo_to_ehyb(m_r, r, plan, cfg)
    return e, m_r, r, plan


def test_nnz_conservation(poisson_mid):
    e, m_r, _, _ = build(poisson_mid)
    s = e.stats
    assert (s["nnz_dia"] + s["nnz_ell"] + s["nnz_er"] + s["nnz_long"]
            == poisson_mid.nnz)


def test_exact_reconstruction_poisson(poisson_mid):
    e, m_r, _, _ = build(poisson_mid)
    verify_conversion(m_r, e)


def test_exact_reconstruction_powerlaw(powerlaw_small):
    e, m_r, _, _ = build(powerlaw_small)
    verify_conversion(m_r, e)
    assert e.stats["nnz_er"] > 0  # random matrix must exercise the ER tail


def test_exact_reconstruction_scrambled(scrambled):
    e, m_r, _, _ = build(scrambled)
    verify_conversion(m_r, e)


def test_long_rows_extracted():
    m = generate.with_dense_rows(
        generate.random_general(2000, 6, seed=2), 2, density=0.8, seed=3)
    cfg = EhybConfig(window_rows=1024, dtype="float64", long_row_threshold=128)
    e, m_r, _, _ = build(m, cfg)
    assert e.n_long >= 1
    assert e.stats["nnz_long"] > 1000
    verify_conversion(m_r, e)


def test_slice_widths_bound_row_counts(poisson_mid):
    e, m_r, r, plan = build(poisson_mid)
    # per-slice width >= in-window nnz of each member row
    from ehyb_spmv.core.reorder import in_window_counts

    counts = in_window_counts(m_r.row, m_r.col, r.boundaries, plan.window_rows,
                              m_r.dimension)
    C = e.ell_col.shape[1]
    widths = np.diff(e.slice_offset)
    for s in range(e.n_slices):
        rows = np.arange(s * C, min((s + 1) * C, m_r.dimension))
        if rows.size:
            assert widths[s] >= counts[rows].max()


def test_local_cols_in_window(poisson_mid):
    e, _, _, plan = build(poisson_mid)
    assert e.ell_col.min(initial=0) >= 0
    assert e.ell_col.max(initial=0) < plan.window_rows


def test_padding_accounted(poisson_mid):
    e, _, _, _ = build(poisson_mid)
    total_cells = e.ell_col.shape[0] * e.ell_col.shape[1]
    assert total_cells == e.stats["nnz_ell"] + e.stats["waste_ell"]


def test_density_sort_reduces_waste(powerlaw_small):
    cfg = EhybConfig(window_rows=1024, dtype="float64")
    e_sorted, _, _, _ = build(powerlaw_small, cfg, sort_rows=True)
    e_unsorted, _, _, _ = build(powerlaw_small, cfg, sort_rows=False)
    assert e_sorted.stats["waste_ell"] <= e_unsorted.stats["waste_ell"]


def test_npz_roundtrip(tmp_path, poisson_small):
    e, m_r, _, _ = build(poisson_small)
    p = str(tmp_path / "m.ehyb.npz")
    e.save_npz(p)
    e2 = EhybMatrix.load_npz(p)
    verify_conversion(m_r, e2)
    assert e2.window_rows == e.window_rows


def test_er_rows_padding_points_at_dump(powerlaw_small):
    e, _, _, _ = build(powerlaw_small)
    n_er = e.stats["n_er_rows"]
    if e.er_rows.shape[0] > n_er:
        assert np.all(e.er_rows[n_er:] == e.dim)
    assert np.all(e.er_rows[:n_er] < e.dim)
