"""Unit tests: containers, deterministic x, oracle, mtx I/O, generators."""
import io

import numpy as np
import pytest

from ehyb_spmv.core.coo import (MatrixCOO, coalesce, deterministic_x,
                                        oracle_spmv)
from ehyb_spmv.io import generate
from ehyb_spmv.io.mtx import MtxError, read_header, read_mtx, write_mtx


def test_deterministic_x_reproducible():
    a = deterministic_x(1000)
    b = deterministic_x(1000)
    assert np.array_equal(a, b)
    assert a.min() >= -0.1 and a.max() <= 0.099
    assert np.unique(a).size > 100  # actually pseudo-random
    # prefix stability: x for a larger dim starts with x for a smaller dim
    assert np.array_equal(deterministic_x(2000)[:1000], a)


def test_oracle_matches_dense(poisson_small):
    m = poisson_small
    x = deterministic_x(m.dimension)
    dense = np.zeros((m.n_rows, m.n_cols))
    np.add.at(dense, (m.row, m.col), m.val)
    np.testing.assert_allclose(oracle_spmv(m, x), dense @ x, rtol=1e-13)


def test_row_structure(poisson_small):
    m = poisson_small
    ptr = m.row_ptr()
    assert ptr[-1] == m.nnz
    assert m.max_col() == 5
    csr = m.to_csr()
    back = csr.to_coo()
    assert back.nnz == m.nnz
    np.testing.assert_allclose(oracle_spmv(back, deterministic_x(m.dimension)),
                               oracle_spmv(m, deterministic_x(m.dimension)))


def test_coalesce_sums_duplicates():
    m = MatrixCOO(3, 3, np.array([0, 0, 1]), np.array([1, 1, 2]),
                  np.array([2.0, 3.0, 4.0]))
    c = coalesce(m)
    assert c.nnz == 2
    assert c.val[0] == 5.0


# --- mtx I/O ---------------------------------------------------------------

MTX_GENERAL = """%%MatrixMarket matrix coordinate real general
% comment line
3 3 4
1 1 2.0
1 3 -1.5
2 2 4.0
3 1 1.0
"""

MTX_SYM = """%%MatrixMarket matrix coordinate real symmetric
3 3 4
1 1 2.0
2 1 -1.0
2 2 2.0
3 3 5.0
"""

MTX_PATTERN = """%%MatrixMarket matrix coordinate pattern general
2 2 2
1 1
2 1
"""


def test_read_general():
    m = read_mtx(io.StringIO(MTX_GENERAL))
    assert (m.n_rows, m.n_cols, m.nnz) == (3, 3, 4)
    assert m.val[1] == -1.5
    assert m.row[3] == 2 and m.col[3] == 0  # 0-based


def test_read_symmetric_expansion():
    # mirrors solver_test.c:235-260: off-diagonals mirrored, diagonal not.
    m = read_mtx(io.StringIO(MTX_SYM))
    assert m.nnz == 5
    dense = np.zeros((3, 3))
    np.add.at(dense, (m.row, m.col), m.val)
    np.testing.assert_array_equal(dense, dense.T)
    assert dense[0, 1] == -1.0 and dense[1, 0] == -1.0


def test_read_pattern():
    m = read_mtx(io.StringIO(MTX_PATTERN))
    assert m.nnz == 2
    assert np.all(m.val == 1.0)


def test_bad_banner():
    with pytest.raises(MtxError):
        read_mtx(io.StringIO("garbage\n1 1 0\n"))
    with pytest.raises(MtxError):
        read_mtx(io.StringIO("%%MatrixMarket matrix array real general\n"))


def test_header_fields():
    h = read_header(io.StringIO(MTX_SYM))
    assert h.is_symmetric and not h.is_skew
    assert h.n_entries == 4


def test_write_read_roundtrip(tmp_path, poisson_small):
    p = str(tmp_path / "m.mtx")
    write_mtx(p, poisson_small)
    m2 = read_mtx(p)
    x = deterministic_x(poisson_small.dimension)
    np.testing.assert_allclose(oracle_spmv(m2, x), oracle_spmv(poisson_small, x),
                               rtol=1e-12)


def test_write_symmetric_roundtrip(tmp_path, poisson_small):
    p = str(tmp_path / "sym.mtx")
    write_mtx(p, poisson_small, symmetry="symmetric")
    m2 = read_mtx(p)
    x = deterministic_x(poisson_small.dimension)
    np.testing.assert_allclose(oracle_spmv(m2, x), oracle_spmv(poisson_small, x),
                               rtol=1e-12)


# --- generators ------------------------------------------------------------

def test_generators_shapes():
    m = generate.poisson2d(10)
    assert m.dimension == 100 and m.nnz == 100 + 4 * 90
    m3 = generate.stencil3d(6, 7)
    assert m3.dimension == 216
    f = generate.fem3d(4, dofs=3)
    assert f.dimension == 192
    assert f.max_col() <= 27 * 3


def test_permuted_preserves_spectrum_action():
    m = generate.poisson2d(12)
    p = generate.permuted(m, seed=3)
    assert p.nnz == m.nnz
    # Row count multiset is preserved under symmetric permutation.
    assert sorted(m.row_counts()) == sorted(p.row_counts())


def test_dense_row_injection():
    m = generate.random_general(500, 8, seed=1)
    md = generate.with_dense_rows(m, 3, density=0.9, seed=2)
    assert md.max_col() > 400


def test_mtx_pattern_native_no_overflow(tmp_path):
    """Regression: the native parser wrote val[n] for pattern files whose
    Python-side val buffer was length 1 — heap overflow (code review)."""
    import numpy as np
    from ehyb_spmv.io import read_mtx

    rng = np.random.default_rng(0)
    n = 30000
    p = tmp_path / "pat.mtx"
    with open(p, "w") as f:
        f.write("%%MatrixMarket matrix coordinate pattern general\n")
        f.write(f"40000 40000 {n}\n")
        for i, j in zip(rng.integers(1, 40001, n), rng.integers(1, 40001, n)):
            f.write(f"{i} {j}\n")
    m = read_mtx(str(p))
    assert m.nnz == n and (m.val == 1.0).all()


def test_mtx_float_indices_fallback(tmp_path):
    """Files with float-formatted indices parse via the NumPy fallback after
    the strict native scanner rejects them (code review)."""
    from ehyb_spmv.io import read_mtx

    p = tmp_path / "fl.mtx"
    p.write_text("%%MatrixMarket matrix coordinate real general\n"
                 "3 3 2\n1.0 2.0 5.5\n3.0 1.0 -2.0\n")
    m = read_mtx(str(p))
    assert m.nnz == 2 and m.val[0] == 5.5 and m.row[1] == 2
