"""DIA body tests: extraction invariants, reconstruction, apply correctness.

The DIA body is an extension with no reference analog: dense high-fill
diagonals are peeled off before SELL packing and applied as statically-shifted
slices of x (a streaming FMA, no gather).  See core/ehyb.py and ops/xla_ops.py.
"""
import dataclasses

import numpy as np
import pytest

import ehyb_spmv as ehyb
from ehyb_spmv.config import EhybConfig, Features
from ehyb_spmv.core.convert import (convert_core, extract_diagonals,
                                            verify_conversion)
from ehyb_spmv.core.coo import deterministic_x, oracle_spmv
from ehyb_spmv.io import generate
from ehyb_spmv.utils.validate import rel_error

from tests.kernel_helpers import gpu_flagship, interpret_matvec
from tests.test_convert import build


def test_extract_diagonals_basic():
    # 3 full diagonals on a 256-dim matrix + scattered off-diagonal noise.
    dim = 256
    rows, cols, vals = [], [], []
    for d in (-3, 0, 5):
        i = np.arange(max(0, -d), min(dim, dim - d), dtype=np.int64)
        rows.append(i)
        cols.append(i + d)
        vals.append(np.full(i.size, float(d) + 0.5))
    rng = np.random.default_rng(0)
    rows.append(rng.integers(0, dim, 40))
    cols.append((rows[-1] + 100) % dim)  # a sparse "diagonal" (wraps → not one)
    vals.append(np.ones(40))
    row = np.concatenate(rows)
    col = np.concatenate(cols)
    val = np.concatenate(vals)

    offs, dia_val, keep = extract_diagonals(row, col, val, dim,
                                            threshold=0.5, max_k=16,
                                            val_dtype=np.float64)
    assert list(offs) == [-3, 0, 5]
    assert keep.sum() == sum(dim - abs(d) for d in (-3, 0, 5))
    # Values land at dia_val[k, row].
    assert dia_val[1, 7] == 0.5
    assert dia_val[0, 3] == -2.5
    # Non-kept entries untouched.
    assert not keep[-40:].any()


@pytest.mark.parametrize("band", [(None, None), (-8, 8)])
def test_extract_native_matches_numpy(monkeypatch, band):
    """diaextract.cpp two-pass path ≡ the NumPy formulation, incl. duplicate
    COO entries (scatter-ADD semantics) and band restriction."""
    rng = np.random.default_rng(5)
    dim = 300
    row = rng.integers(0, dim, 4000)
    col = rng.integers(0, dim, 4000)
    i = np.arange(dim - 2, dtype=np.int64)
    row = np.concatenate([row, i, i, i])   # duplicated diag + a +2 diagonal
    col = np.concatenate([col, i, i, i + 2])
    val = rng.standard_normal(row.size)
    args = (row.astype(np.int64), col.astype(np.int64), val, dim, 0.5, 16,
            np.float64)
    kw = dict(off_lo=band[0], off_hi=band[1])
    o1, d1, k1 = extract_diagonals(*args, **kw)   # native (default on)
    monkeypatch.setenv("EHYB_NATIVE_DIA", "0")
    o0, d0, k0 = extract_diagonals(*args, **kw)
    np.testing.assert_array_equal(o1, o0)
    np.testing.assert_allclose(d1, d0, rtol=1e-15)
    np.testing.assert_array_equal(k1, k0)
    assert k1.dtype == np.bool_ and d1.shape == d0.shape


def test_extract_respects_threshold_and_cap():
    dim = 128
    i = np.arange(dim, dtype=np.int64)
    # main diagonal full; +1 diagonal only 10 entries (below 0.5 threshold)
    row = np.concatenate([i, i[:10]])
    col = np.concatenate([i, i[:10] + 1])
    val = np.ones(row.size)
    offs, _, keep = extract_diagonals(row, col, val, dim, 0.5, 16, np.float64)
    assert list(offs) == [0] and keep.sum() == dim
    # cap: two full diagonals but max_k = 1 → keeps the denser (tie → first)
    row = np.concatenate([i, i[: dim - 1]])
    col = np.concatenate([i, i[: dim - 1] + 1])
    val = np.ones(row.size)
    offs, _, _ = extract_diagonals(row, col, val, dim, 0.5, 1, np.float64)
    assert offs.shape[0] == 1 and offs[0] == 0


def test_extract_offset_range_restriction():
    dim = 128
    i = np.arange(dim - 64, dtype=np.int64)
    row, col, val = i, i + 64, np.ones(i.size)  # offset +64 only
    offs, _, keep = extract_diagonals(row, col, val, dim, 0.2, 16, np.float64,
                                      off_lo=-8, off_hi=8)
    assert offs.shape[0] == 0 and not keep.any()


def test_dia_reconstruction_stencil():
    m = generate.stencil3d(12, 7)
    e, m_r, _, _ = build(m)
    assert e.stats["nnz_dia"] > 0 and e.stats["n_diagonals"] == 7
    verify_conversion(m_r, e)


def test_dia_disabled_flag():
    m = generate.stencil3d(8, 7)
    cfg = EhybConfig(window_rows=1024, dtype="float64",
                     features=Features(dia=False))
    e, m_r, _, _ = build(m, cfg=cfg)
    assert e.stats["nnz_dia"] == 0 and e.stats["n_diagonals"] == 0
    verify_conversion(m_r, e)


@pytest.mark.parametrize("name", ["poisson2d_64", "stencil27_24", "fem3d_16"])
def test_dia_apply_matches_oracle(name):
    m = generate.CORPUS[name]()
    x = deterministic_x(m.dimension)
    want = oracle_spmv(m, x)
    mod = ehyb.MODELS["ehyb_xla"](EhybConfig()).setup(m)
    assert mod.ehyb.stats["nnz_dia"] > 0.9 * m.nnz  # stencils are pure DIA
    assert rel_error(mod.matvec(x), want) < 2e-6


def test_dia_apply_mixed_body():
    # Stencil + random noise: DIA takes the diagonals, SELL/ER take the rest.
    m0 = generate.stencil3d(10, 7)
    noise = generate.random_general(m0.dimension, 4, seed=9)
    m = generate.coalesce_concat(m0, noise) if hasattr(generate, "coalesce_concat") \
        else _concat(m0, noise)
    x = deterministic_x(m.dimension)
    want = oracle_spmv(m, x)
    mod = ehyb.MODELS["ehyb_xla"](EhybConfig()).setup(m)
    st = mod.ehyb.stats
    assert st["nnz_dia"] > 0 and st["nnz_dia"] < m.nnz
    assert rel_error(mod.matvec(x), want) < 2e-6


def _concat(a, b):
    from ehyb_spmv.core.coo import MatrixCOO, coalesce
    return coalesce(MatrixCOO(
        a.n_rows, a.n_cols,
        np.concatenate([a.row, b.row]), np.concatenate([a.col, b.col]),
        np.concatenate([a.val, b.val])))


def test_dia_pallas_interpret_matches_oracle():
    # The flagship's GPU path with DIA on (kernel in interpret mode); mixed
    # body.
    m = _concat(generate.stencil3d(10, 7),
                generate.random_general(1000, 3, seed=2))
    x = deterministic_x(m.dimension)
    mod = gpu_flagship(m)
    assert mod.ehyb.stats["nnz_dia"] > 0
    assert rel_error(interpret_matvec(mod, x), oracle_spmv(m, x)) < 1e-4


def test_dia_empty_body_fast_path():
    # Pure stencil: body nnz = 0 → the GPU apply skips the body kernel.
    m = generate.stencil3d(10, 7)
    x = deterministic_x(m.dimension)
    mod = gpu_flagship(m)
    assert mod.ehyb.stats["nnz_ell"] == 0
    assert rel_error(interpret_matvec(mod, x), oracle_spmv(m, x)) < 1e-4


def test_dia_serialization_roundtrip(tmp_path):
    m = generate.stencil3d(8, 7)
    e, m_r, _, _ = build(m)
    p = str(tmp_path / "m.ehyb.npz")
    e.save_npz(p)
    from ehyb_spmv.core.ehyb import EhybMatrix

    e2 = EhybMatrix.load_npz(p)
    np.testing.assert_array_equal(e.dia_offsets, e2.dia_offsets)
    np.testing.assert_array_equal(e.dia_val, e2.dia_val)
    assert e2.stats.get("nnz_dia") == e.stats["nnz_dia"]
    verify_conversion(m_r, e2)
