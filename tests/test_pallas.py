"""SELL layouts and the Pallas (Triton) slice kernel.

Converter invariants of the chunk-synchronized, multi-window and relaxed
layouts, and the flagship's GPU path run on the CPU with the kernel in
interpret mode (the compiled kernel runs under ``tests/test_gpu.py``)."""
import numpy as np
import pytest

import ehyb_spmv as ehyb
from ehyb_spmv.config import EhybConfig, WINDOW_ALIGN
from ehyb_spmv.core.convert import coo_to_ehyb
from ehyb_spmv.core.coo import deterministic_x, oracle_spmv
from ehyb_spmv.core.planner import make_plan
from ehyb_spmv.core.reorder import two_level_reorder
from ehyb_spmv.io import generate
from ehyb_spmv.partition import partition_rows
from ehyb_spmv.utils.validate import rel_error

from tests.kernel_helpers import gpu_flagship, interpret_matvec


def build_cs(m, sort_rows=True):
    cfg = EhybConfig(window_rows=WINDOW_ALIGN, body_layout="sell_cs",
                     dtype="float64")
    plan = make_plan(m.dimension, cfg)
    labels = partition_rows(m, plan.n_parts, "blocks")
    r = two_level_reorder(m, labels, plan, sort_rows=sort_rows)
    m_r = r.apply_to_matrix(m)
    return coo_to_ehyb(m_r, r, plan, cfg), m_r, r, plan


def test_chunk_sync_invariant(poisson_mid):
    """Every width-step's nonpadding AND padding cells share one chunk."""
    e, m_r, _, _ = build_cs(poisson_mid)
    hi = np.asarray(e.ell_col) >> 7
    assert np.all(hi == hi[:, :1]), "hi varies within a width-step"


def test_chunk_sync_reconstruction(poisson_mid):
    from ehyb_spmv.core.convert import verify_conversion

    e, m_r, _, _ = build_cs(poisson_mid)
    verify_conversion(m_r, e)


def test_chunk_sync_reconstruction_powerlaw(powerlaw_small):
    from ehyb_spmv.core.convert import verify_conversion

    e, m_r, _, _ = build_cs(powerlaw_small)
    verify_conversion(m_r, e)
    hi = np.asarray(e.ell_col) >> 7
    assert np.all(hi == hi[:, :1])


def test_chunk_sync_waste_accounted(scrambled):
    e, m_r, _, _ = build_cs(scrambled)
    cells = e.ell_col.shape[0] * e.ell_col.shape[1]
    assert cells == e.stats["nnz_ell"] + e.stats["waste_ell"]


def test_no_empty_slices(poisson_mid):
    e, _, _, _ = build_cs(poisson_mid)
    assert np.all(np.diff(e.slice_offset) > 0)


def build_mw(m, min_nnz=4, width_align=8):
    cfg = EhybConfig(window_rows=WINDOW_ALIGN, body_layout="sell_mw",
                     dtype="float64", min_window_group_nnz=min_nnz,
                     width_align=width_align)
    plan = make_plan(m.dimension, cfg)
    labels = partition_rows(m, plan.n_parts, "blocks")
    r = two_level_reorder(m, labels, plan)
    m_r = r.apply_to_matrix(m)
    return coo_to_ehyb(m_r, r, plan, cfg), m_r


@pytest.mark.parametrize("fixture", ["poisson_mid", "powerlaw_small",
                                     "scrambled", "fem_small"])
def test_mw_reconstruction(fixture, request):
    from ehyb_spmv.core.convert import verify_conversion

    m = request.getfixturevalue(fixture)
    e, m_r = build_mw(m)
    verify_conversion(m_r, e)


def test_mw_reduces_er_vs_windowed(fem_small):
    # the whole point: multi-window body should capture entries the
    # partition-window format sends to ER
    e_mw, _ = build_mw(fem_small)
    cfg = EhybConfig(window_rows=WINDOW_ALIGN, body_layout="sell_cs",
                     dtype="float64")
    plan = make_plan(fem_small.dimension, cfg)
    labels = partition_rows(fem_small, plan.n_parts, "blocks")
    r = two_level_reorder(fem_small, labels, plan)
    e_cs = coo_to_ehyb(r.apply_to_matrix(fem_small), r, plan, cfg)
    assert e_mw.stats["nnz_er"] <= e_cs.stats["nnz_er"]


def test_mw_min_nnz_1_empties_er(poisson_mid):
    e, _ = build_mw(poisson_mid, min_nnz=1)
    assert e.stats["nnz_er"] == 0


def build_rx(m, min_nnz=2):
    cfg = EhybConfig(window_rows=WINDOW_ALIGN, body_layout="sell_rx",
                     dtype="float64", min_window_group_nnz=min_nnz)
    plan = make_plan(m.dimension, cfg)
    labels = partition_rows(m, plan.n_parts, "blocks")
    r = two_level_reorder(m, labels, plan)
    m_r = r.apply_to_matrix(m)
    return coo_to_ehyb(m_r, r, plan, cfg), m_r


@pytest.mark.parametrize("fixture", ["poisson_mid", "powerlaw_small",
                                     "scrambled", "fem_small"])
def test_rx_reconstruction(fixture, request):
    from ehyb_spmv.core.convert import verify_conversion

    m = request.getfixturevalue(fixture)
    e, m_r = build_rx(m)
    verify_conversion(m_r, e)
    assert e.step_win_b.shape == e.step_win.shape


def test_rx_slot_consistency(scrambled):
    """Per step, every used lo-slot carries a single (sel, hi): the
    feasibility condition of the two-stage dynamic_gather."""
    e, _ = build_rx(scrambled)
    idx = np.asarray(e.ell_col).astype(np.int64)
    val = np.asarray(e.ell_val)
    lo = idx & 127
    # real entries only
    for k in zip(*np.nonzero(val)):
        s, lane = k
        attr = idx[s, lo[s, lane]]
        # the gathered column must reconstruct to the entry's column: checked
        # exhaustively by verify_conversion; here check window pairing bounds
        assert 0 <= (attr >> 7) & 7 < 8


def test_rx_native_packer_at_least_as_tight(scrambled, powerlaw_small,
                                            monkeypatch):
    """The native greedy packer (relaxpack.cpp::ehyb_pack_relaxed) must
    produce a VALID layout (verify_conversion reconstructs exactly) that is
    no looser than the round election it replaced — steps = streamed bytes,
    the body's whole cost model."""
    from ehyb_spmv.core.convert import verify_conversion

    for m in (scrambled, powerlaw_small):
        monkeypatch.setenv("EHYB_NATIVE_PACK", "1")
        e_nat, m_r = build_rx(m)
        verify_conversion(m_r, e_nat)
        monkeypatch.setenv("EHYB_NATIVE_PACK", "0")
        e_ele, m_r2 = build_rx(m)
        verify_conversion(m_r2, e_ele)
        assert e_nat.stats["ell_steps"] <= e_ele.stats["ell_steps"], \
            (e_nat.stats["ell_steps"], e_ele.stats["ell_steps"])


def test_rx_never_more_steps_than_mw(scrambled):
    e_rx, m_r = build_rx(scrambled)
    cfg = EhybConfig(window_rows=WINDOW_ALIGN, body_layout="sell_mw",
                     dtype="float64", min_window_group_nnz=2)
    plan = make_plan(scrambled.dimension, cfg)
    labels = partition_rows(scrambled, plan.n_parts, "blocks")
    r = two_level_reorder(scrambled, labels, plan)
    e_mw = coo_to_ehyb(r.apply_to_matrix(scrambled), r, plan, cfg)
    assert e_rx.stats["ell_steps"] <= e_mw.stats["ell_steps"]


def build_rx4(m, min_nnz=2):
    cfg = EhybConfig(window_rows=WINDOW_ALIGN, body_layout="sell_rx",
                     dtype="float64", min_window_group_nnz=min_nnz,
                     windows_per_subtile=4)
    plan = make_plan(m.dimension, cfg)
    labels = partition_rows(m, plan.n_parts, "blocks")
    r = two_level_reorder(m, labels, plan)
    m_r = r.apply_to_matrix(m)
    return coo_to_ehyb(m_r, r, plan, cfg), m_r


@pytest.mark.parametrize("fixture", ["poisson_mid", "powerlaw_small",
                                     "scrambled", "fem_small"])
def test_rx4_reconstruction(fixture, request):
    from ehyb_spmv.core.convert import verify_conversion

    m = request.getfixturevalue(fixture)
    e, m_r = build_rx4(m)
    verify_conversion(m_r, e)
    if e.stats["nnz_ell"]:
        assert e.step_win_c.shape == e.step_win.shape
        assert e.step_win_d.shape == e.step_win.shape


def test_rx4_fewer_steps_on_scattered(scrambled):
    """The whole point of quads: scattered matrices pack into fewer steps
    (group merging tightens the lane bound + amortizes ceil-to-8 padding)."""
    e2, _ = build_rx(scrambled)
    e4, _ = build_rx4(scrambled)
    assert e4.stats["ell_steps"] < e2.stats["ell_steps"]


def test_rx4_xla_model_vs_oracle(scrambled):
    """Pure-XLA apply decodes the 2-bit sel (CPU path)."""
    cfg = EhybConfig(body_layout="sell_rx", windows_per_subtile=4,
                     relax_body="never", artifact_cache=False)
    model = ehyb.EhybXlaSpmv(cfg).setup(scrambled)
    x = deterministic_x(scrambled.dimension)
    assert rel_error(model.matvec(x), oracle_spmv(scrambled, x)) < 5e-6


def test_mw_group_width_is_busiest_row(fem_small):
    """Multi-window groups are as wide as their busiest row: no step of a
    slice is entirely padding unless the slice itself is empty."""
    e, _ = build_mw(fem_small, width_align=1)
    val = np.asarray(e.ell_val)
    widths = np.diff(e.slice_offset)
    for s in np.flatnonzero(widths > 1)[:50]:
        rows = val[e.slice_offset[s]:e.slice_offset[s + 1]]
        assert np.all(np.any(rows != 0, axis=1))


def test_mw_window_local_columns(fem_small):
    """Every body column is window-local: int16 holds it, and
    step_win + col is the entry's reordered column."""
    e, _ = build_mw(fem_small)
    col = np.asarray(e.ell_col)
    assert col.min() >= 0 and col.max() < WINDOW_ALIGN
    assert np.all(e.step_win % 128 == 0)


@pytest.mark.parametrize("fixture", ["poisson_mid", "powerlaw_small",
                                     "scrambled"])
def test_pallas_interpret_vs_oracle(fixture, request):
    m = request.getfixturevalue(fixture)
    model = gpu_flagship(m)
    x = deterministic_x(m.dimension)
    assert rel_error(interpret_matvec(model, x), oracle_spmv(m, x)) < 5e-6


def test_pallas_interpret_long_rows():
    m = generate.with_dense_rows(
        generate.random_general(3000, 8, seed=21), 2, density=0.6, seed=22)
    # sell_cs (partition windows): dense rows overflow to ER and trip the
    # long-row extraction; under sell_mw their entries form large window
    # groups and stay in the body, so the long path would not trigger.
    model = gpu_flagship(m, EhybConfig(long_row_threshold=128,
                                       body_layout="sell_cs"))
    assert model.ehyb.n_long >= 1
    x = deterministic_x(m.dimension)
    assert rel_error(interpret_matvec(model, x), oracle_spmv(m, x)) < 1e-5


@pytest.mark.parametrize("fixture", ["poisson_mid", "fem_small", "scrambled"])
def test_mw_pallas_interpret_vs_oracle(fixture, request):
    m = request.getfixturevalue(fixture)
    model = gpu_flagship(m)
    assert model.config.body_layout == "sell_mw"
    assert model.config.index_dtype == "int16"
    x = deterministic_x(m.dimension)
    assert rel_error(interpret_matvec(model, x), oracle_spmv(m, x)) < 5e-6


def test_rx4_auto_upgrade():
    """relax_body='auto' should reach quads on a random matrix that spreads
    over many windows (the small `scrambled` fixture spans only ~3 windows,
    where the arbiter correctly declines the upgrade)."""
    m = generate.random_general(8192, 24, seed=3)
    model = ehyb.EhybXlaSpmv(EhybConfig(body_layout="sell_mw",
                                        window_rows=WINDOW_ALIGN)).setup(m)
    assert model.config.body_layout == "sell_rx"
    assert model.config.windows_per_subtile == 4
    assert model.ehyb.step_win_c.size > 0
    x = deterministic_x(m.dimension)
    assert rel_error(model.matvec(x), oracle_spmv(m, x)) < 5e-6
