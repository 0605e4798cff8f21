"""Double-word (f32x2) precision mode: the reference's f64 value contract
(spmv.h:46) realized in f32 arithmetic (ops/dword.py; VERDICT r2
missing #6 stretch)."""
import numpy as np
import pytest

import ehyb_spmv as ehyb
from ehyb_spmv.config import EhybConfig
from ehyb_spmv.core.coo import MatrixCOO, deterministic_x, oracle_spmv
from ehyb_spmv.io import generate
from ehyb_spmv.utils.validate import rel_error


def _f64_stress_matrix(dim=2048, seed=3):
    """Values that need every f64 bit: magnitudes spanning 1e-8..1e8 with
    cancellation pairs and low-order perturbations at the 1e-13 level —
    f32 storage alone already loses them."""
    rng = np.random.default_rng(seed)
    base = generate.random_general(dim, 8, seed=seed)
    val = base.val.copy()
    val *= 1.0 + rng.standard_normal(val.shape[0]) * 1e-13
    # cancellation rows: pairs (big, -big + eps)
    n_pairs = 64
    rows = rng.choice(dim, size=n_pairs, replace=False).astype(np.int64)
    cols_a = rng.integers(0, dim, size=n_pairs)
    cols_b = (cols_a + 1 + rng.integers(0, dim - 2, size=n_pairs)) % dim
    big = 10.0 ** rng.uniform(6, 8, size=n_pairs)
    eps = rng.standard_normal(n_pairs) * 1e-5
    from ehyb_spmv.core.coo import coalesce

    return coalesce(MatrixCOO(
        dim, dim,
        np.concatenate([base.row, rows, rows]),
        np.concatenate([base.col, cols_a, cols_b]),
        np.concatenate([val, big, -big + eps])))


@pytest.fixture(scope="module")
def stress():
    return _f64_stress_matrix()


def test_dword_beats_f32(stress):
    x = deterministic_x(stress.dimension)
    want = oracle_spmv(stress, x)
    plain = ehyb.EhybXlaSpmv(EhybConfig(artifact_cache=False)).setup(stress)
    dword = ehyb.EhybXlaSpmv(EhybConfig(dword_values=True,
                                        artifact_cache=False)).setup(stress)
    err_dword = rel_error(dword.matvec(x), want)
    assert err_dword <= 1e-12, err_dword
    # teeth: the f32 pipeline must actually lose precision on this input
    # (per-element: the norm metric dilutes the cancellation rows)
    denom = np.maximum(np.abs(want), 1.0)
    per_elem_plain = np.max(np.abs(plain.matvec(x) - want) / denom)
    per_elem_dword = np.max(np.abs(dword.matvec(x) - want) / denom)
    assert per_elem_plain > 1e-5, per_elem_plain
    # per-element accuracy on a condition-1e8 cancellation row is bounded by
    # kappa * 2^-48 ~ 4e-7 absolute; measured ~6e-10 — orders better than
    # the f32 pipeline's kappa * 2^-24
    assert per_elem_dword <= 1e-8, per_elem_dword
    assert per_elem_dword < per_elem_plain * 1e-3


def test_dword_flagship_degrades_to_xla(stress):
    """The flagship honors the flag by running the dword XLA path, on the
    GPU too (the kernel choice is made before any conversion)."""
    from unittest import mock

    import jax

    with mock.patch.object(jax, "default_backend", lambda: "gpu"):
        model = ehyb.EhybSpmv(EhybConfig(dword_values=True,
                                         artifact_cache=False)).setup(stress)
    assert model._kernel == "xla"
    x = deterministic_x(stress.dimension)
    want = oracle_spmv(stress, x)
    assert rel_error(model.matvec(x), want) <= 1e-12


def test_dword_poisson_exact():
    """A structured (DIA-heavy) matrix through the dword DIA phase."""
    m = generate.poisson2d(64)
    x = deterministic_x(m.dimension)
    want = oracle_spmv(m, x)
    model = ehyb.EhybXlaSpmv(EhybConfig(dword_values=True,
                                        artifact_cache=False)).setup(m)
    assert rel_error(model.matvec(x), want) <= 1e-12


def test_dword_split_roundtrip():
    from ehyb_spmv.ops.dword import split_f64

    rng = np.random.default_rng(0)
    a = rng.standard_normal(1000) * 10.0 ** rng.uniform(-8, 8, 1000)
    hi, lo = split_f64(a)
    np.testing.assert_allclose(hi.astype(np.float64) + lo, a, rtol=1e-14)


def test_dword_long_rows():
    """Pathological dense rows through the dword lane-chain reduction
    (pack_long_dword + _lane_tree_sum) — the f64 contract extends to the
    long-row phase (kernel.cu:43-67 at spmv.h:46 precision; VERDICT r4
    next #4)."""
    dim = 4096
    rng = np.random.default_rng(11)
    base = generate.random_general(dim, 6, seed=11)
    # two dense rows whose OUT-OF-WINDOW entry counts exceed the threshold
    # (the sell layout's long-row trigger, convert.py), cancellation-scale
    # magnitudes so an f32 reduction visibly loses bits
    dense_rows, extra_r, extra_c, extra_v = [5, 2700], [], [], []
    for r in dense_rows:
        cols = rng.permutation(dim)[:3000]
        vals = rng.standard_normal(3000) * 10.0 ** rng.uniform(-6, 6, 3000)
        extra_r.append(np.full(3000, r)); extra_c.append(cols); extra_v.append(vals)
    from ehyb_spmv.core.coo import coalesce

    m = coalesce(MatrixCOO(
        dim, dim,
        np.concatenate([base.row] + extra_r),
        np.concatenate([base.col] + extra_c),
        np.concatenate([base.val] + extra_v)))
    cfg = EhybConfig(dword_values=True, artifact_cache=False,
                     window_budget_bytes=4096, long_row_threshold=256)
    model = ehyb.EhybXlaSpmv(cfg).setup(m)
    assert model.ehyb.long_rows.size >= 2, model.ehyb.stats
    x = deterministic_x(dim)
    want = oracle_spmv(m, x)
    assert rel_error(model.matvec(x), want) <= 1e-12


def test_pack_long_dword_layout():
    """Lane-chain packing invariants: per-row step ranges, entry j at
    (step j//128, lane j%128), padding exact zeros."""
    from ehyb_spmv.ops.dword import pack_long_dword

    rng = np.random.default_rng(0)
    counts = [300, 1, 129, 128]
    seg = np.repeat(np.arange(4), counts)
    col = rng.integers(0, 5000, seg.shape[0])
    val = rng.standard_normal(seg.shape[0]) * 1e6
    col2, vh2, vl2, seg2 = pack_long_dword(col, val, seg, 4)
    steps = [3, 1, 2, 1]
    assert col2.shape == (sum(steps), 128)
    np.testing.assert_array_equal(seg2, np.repeat(np.arange(4), steps))
    # row 0, entry 130 → step 1, lane 2 of row 0's range
    assert col2[1, 2] == col[130]
    # padding: row 1 has 1 entry; lanes 1.. are zero
    assert vh2[3, 1:].sum() == 0 and vl2[3, 1:].sum() == 0
    # value round-trip at f64 precision
    np.testing.assert_allclose(
        vh2[0, 0].astype(np.float64) + vl2[0, 0], val[0], rtol=1e-15)


def test_dword_iterate_chain():
    """The bench iterate chain (y fed back as x + eps*y) must handle the
    dword (2, n) (hi, lo) stacks whose padded y length differs from the
    padded x length — regression for the (2, ny) vs (2, nx) broadcast
    failure the first hardware dword bench hit (models/base._resize_like
    resized axis 0 only)."""
    import jax

    m = generate.permuted(generate.poisson2d(64), seed=7)
    model = ehyb.EhybSpmv(EhybConfig(window_rows=1024, dword_values=True,
                                     artifact_cache=False)).setup(m)
    x = deterministic_x(m.dimension)
    x_dev = model.prepare_x(x)
    y = jax.block_until_ready(model.iterate(x_dev, 3))
    # eps=0: the chained result equals a single A.x bit-for-bit
    want = oracle_spmv(m, x)
    got = model.recover_y(y)
    assert rel_error(got, want) <= 1e-12
