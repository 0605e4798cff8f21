"""End-to-end model tests: every SpMV strategy vs the exact-f64 oracle.

This is the golden-model pattern of the reference (host oracle built during
parsing, 1% tolerance compare at ``solver_test.c:389``) promoted to real unit
tests, at f64/f32-appropriate tolerances.
"""
import numpy as np
import pytest

import ehyb_spmv as ehyb
from ehyb_spmv.config import EhybConfig
from ehyb_spmv.core.coo import deterministic_x, oracle_spmv
from ehyb_spmv.io import generate
from ehyb_spmv.utils.validate import compare, rel_error

MODELS = ["csr", "bcoo", "ehyb_xla", "ehyb", "hyb"]


def run_model(name, m, cfg=None):
    cfg = cfg or EhybConfig(window_rows=1024, dtype="float32")
    model = ehyb.MODELS[name](cfg).setup(m)
    x = deterministic_x(m.dimension)
    y = model.matvec(x)
    want = oracle_spmv(m, x)
    return y, want, model


@pytest.mark.parametrize("name", MODELS)
def test_model_vs_oracle_poisson(name, poisson_mid):
    y, want, _ = run_model(name, poisson_mid)
    # f32 compute: 1e-6-class relative error (BASELINE.md parity metric)
    assert rel_error(y, want) < 5e-6
    # reference-protocol elementwise 1% compare (solver_test.c:389), with an
    # f32-roundoff absolute floor for exactly-cancelling rows
    atol = 1e-6 * float(np.max(np.abs(want)))
    assert compare(y, want, tol=0.01, atol=atol).ok


@pytest.mark.parametrize("name", MODELS)
def test_model_vs_oracle_powerlaw(name, powerlaw_small):
    y, want, _ = run_model(name, powerlaw_small)
    assert rel_error(y, want) < 5e-6


@pytest.mark.parametrize("name", ["ehyb_xla", "hyb"])
def test_model_vs_oracle_scrambled(name, scrambled):
    y, want, _ = run_model(name, scrambled)
    assert rel_error(y, want) < 5e-6


def test_ehyb_f64_exact(poisson_mid):
    # f64 on CPU: near-machine-precision parity.
    import jax

    if jax.config.read("jax_enable_x64"):
        pytest.skip("x64 mode globally toggled")
    with jax.enable_x64(True):
        cfg = EhybConfig(window_rows=1024, dtype="float64")
        y, want, _ = run_model("ehyb_xla", poisson_mid, cfg)
        assert rel_error(y, want) < 1e-14


def test_ehyb_with_dense_rows_long_path():
    m = generate.with_dense_rows(
        generate.random_general(2000, 6, seed=2), 2, density=0.8, seed=3)
    cfg = EhybConfig(window_rows=1024, dtype="float32", long_row_threshold=128)
    model = ehyb.MODELS["ehyb_xla"](cfg).setup(m)
    assert model.ehyb.n_long >= 1
    x = deterministic_x(m.dimension)
    assert rel_error(model.matvec(x), oracle_spmv(m, x)) < 1e-5


def test_iterate_matches_single_apply(poisson_small):
    cfg = EhybConfig(window_rows=1024)
    model = ehyb.MODELS["ehyb_xla"](cfg).setup(poisson_small)
    x = model.prepare_x(deterministic_x(poisson_small.dimension))
    y1 = model.apply_jit(x)
    y5 = model.iterate(x, 5, eps=0.0)
    np.testing.assert_array_equal(np.asarray(y1), np.asarray(y5))


def test_ehyb_partitioned_matches_unpartitioned(poisson_mid):
    x = deterministic_x(poisson_mid.dimension)
    want = oracle_spmv(poisson_mid, x)
    for window in (1024, 2048):
        cfg = EhybConfig(window_rows=window)
        model = ehyb.MODELS["ehyb_xla"](cfg).setup(poisson_mid)
        assert rel_error(model.matvec(x), want) < 5e-6, f"window={window}"


def test_er_dominated_matrix():
    # tiny windows → most entries out-of-window → ER path carries the load
    m = generate.random_general(4000, 12, seed=9)
    cfg = EhybConfig(window_rows=1024)
    model = ehyb.MODELS["ehyb_xla"](cfg).setup(m)
    assert model.ehyb.stats["nnz_er"] > model.ehyb.stats["nnz_ell"] / 4
    x = deterministic_x(m.dimension)
    assert rel_error(model.matvec(x), oracle_spmv(m, x)) < 1e-5
