"""Property tests: random matrices × config space → exact reconstruction and
oracle-parity (the property-test layer SURVEY.md §4 says the reference lacks).

Every sampled (matrix, config) pair must satisfy:
  * nnz conservation across DIA/SELL/ER/long (convert.c:140 analog);
  * exact dense reconstruction from the EHYB instance;
  * XLA apply matches the exact-f64 oracle at f64 precision.
"""
import dataclasses

import numpy as np
import pytest

import ehyb_spmv as ehyb
from ehyb_spmv.config import EhybConfig, Features
from ehyb_spmv.core.convert import verify_conversion
from ehyb_spmv.core.coo import MatrixCOO, coalesce, deterministic_x, \
    oracle_spmv
from ehyb_spmv.utils.validate import rel_error

from tests.kernel_helpers import gpu_flagship, interpret_matvec


def random_matrix(rng, dim, style):
    if style == "uniform":
        nnz = int(rng.integers(dim, dim * 8))
        row = rng.integers(0, dim, nnz)
        col = rng.integers(0, dim, nnz)
    elif style == "banded":
        nnz = int(rng.integers(dim, dim * 6))
        row = rng.integers(0, dim, nnz)
        col = np.clip(row + rng.integers(-40, 41, nnz), 0, dim - 1)
    elif style == "diag_plus_noise":
        i = np.arange(dim)
        row = np.concatenate([i, rng.integers(0, dim, dim // 2)])
        col = np.concatenate([i, rng.integers(0, dim, dim // 2)])
    elif style == "dense_row":
        nnz = dim * 2
        row = rng.integers(0, dim, nnz)
        col = rng.integers(0, dim, nnz)
        row = np.concatenate([row, np.full(dim, int(rng.integers(0, dim)))])
        col = np.concatenate([col, rng.permutation(dim)])
    val = rng.standard_normal(row.shape[0])
    return coalesce(MatrixCOO(dim, dim, row.astype(np.int64),
                              col.astype(np.int64), val))


CONFIGS = [
    {},
    {"features": Features(dia=False)},
    {"min_window_group_nnz": 1},
    {"min_window_group_nnz": 64},
    {"sliding_windows": True, "body_layout": "sell_mw"},
    {"long_row_threshold": 16},
    {"dia_threshold": 0.05, "max_diagonals": 8},
]


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_convert_and_apply(seed):
    rng = np.random.default_rng(seed)
    style = ["uniform", "banded", "diag_plus_noise", "dense_row"][seed % 4]
    dim = int(rng.integers(100, 1500))
    m = random_matrix(rng, dim, style)
    overrides = CONFIGS[seed % len(CONFIGS)]
    cfg = dataclasses.replace(
        EhybConfig(dtype="float64", window_rows=1024), **overrides)

    model = ehyb.MODELS["ehyb_xla"](cfg).setup(m)
    s = model.ehyb.stats
    assert (s["nnz_dia"] + s["nnz_ell"] + s["nnz_er"] + s["nnz_long"]
            == m.nnz), (style, s)
    # dense reconstruction (reordered space)
    m_r = model.reordering.apply_to_matrix(m)
    verify_conversion(m_r, model.ehyb)
    # oracle parity
    x = deterministic_x(m.dimension)
    err = rel_error(model.matvec(x), oracle_spmv(m, x))
    # x64 is disabled in the suite: device compute is f32
    assert err < 5e-6, (style, overrides, err)


@pytest.mark.parametrize("seed", [10, 11, 12])
def test_fuzz_pallas_interpret(seed):
    """Same fuzz through the flagship's GPU path (Triton kernel in interpret
    mode, f32)."""
    rng = np.random.default_rng(seed)
    m = random_matrix(rng, int(rng.integers(300, 1200)),
                      ["uniform", "banded", "diag_plus_noise"][seed % 3])
    model = gpu_flagship(m)
    x = deterministic_x(m.dimension)
    err = rel_error(interpret_matvec(model, x), oracle_spmv(m, x))
    assert err < 1e-4, err


RX_CONFIGS = [
    {"body_layout": "sell_rx"},
    {"body_layout": "sell_rx", "row_split_threshold": 8},
    {"body_layout": "sell_rx", "min_window_group_nnz": 1},
    {"body_layout": "sell_rx", "windows_per_subtile": 4},
    {"body_layout": "sell_rx", "row_split_threshold": 4,
     "min_window_group_nnz": 1},
    {"body_layout": "sell_rx", "features": Features(dia=False)},
]


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_rx_convert_and_apply(seed):
    """Fuzz the relaxed layout (+ row splitting / quad-window combos)
    through conversion invariants, dense reconstruction, and oracle parity
    on the XLA path."""
    rng = np.random.default_rng(100 + seed)
    style = ["uniform", "banded", "diag_plus_noise", "dense_row"][seed % 4]
    dim = int(rng.integers(100, 1500))
    m = random_matrix(rng, dim, style)
    cfg = dataclasses.replace(
        EhybConfig(dtype="float64", window_rows=1024), **RX_CONFIGS[seed])

    model = ehyb.MODELS["ehyb_xla"](cfg).setup(m)
    s = model.ehyb.stats
    assert (s["nnz_dia"] + s["nnz_ell"] + s["nnz_er"] + s["nnz_long"]
            == m.nnz), (style, s)
    m_r = model.reordering.apply_to_matrix(m)
    verify_conversion(m_r, model.ehyb)
    x = deterministic_x(m.dimension)
    err = rel_error(model.matvec(x), oracle_spmv(m, x))
    assert err < 5e-6, (style, RX_CONFIGS[seed], err)


@pytest.mark.parametrize("seed", [20, 21, 22, 23])
def test_fuzz_sell_kernel_interpret(seed):
    """Fuzz the flagship's GPU path (multi-window body + ER tail + long rows
    through the Triton kernel in interpret mode) against the oracle."""
    rng = np.random.default_rng(seed)
    m = random_matrix(rng, int(rng.integers(300, 1200)),
                      ["uniform", "banded", "dense_row", "diag_plus_noise"]
                      [seed % 4])
    cfg = EhybConfig(long_row_threshold=64) if seed % 2 else EhybConfig()
    model = gpu_flagship(m, cfg)
    x = deterministic_x(m.dimension)
    err = rel_error(interpret_matvec(model, x), oracle_spmv(m, x))
    assert err < 1e-4, err
