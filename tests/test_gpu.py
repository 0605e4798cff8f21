"""Card-only tests: the compiled Triton slice kernel against its XLA
reference and the oracle.  They skip without a GPU; ``chip_smoke.py`` runs
them on the card (``pytest -m gpu``)."""
import jax
import numpy as np
import pytest

import ehyb_spmv as ehyb
from ehyb_spmv.config import EhybConfig
from ehyb_spmv.core.coo import deterministic_x, oracle_spmv
from ehyb_spmv.io import generate
from ehyb_spmv.ops import sell_triton, xla_ops
from ehyb_spmv.utils.validate import rel_error

pytestmark = pytest.mark.gpu

FIXTURES = ["poisson_mid", "fem_small", "scrambled", "powerlaw_small"]


@pytest.mark.parametrize("fixture", FIXTURES)
def test_flagship_compiled_vs_oracle(gpu, fixture, request):
    m = request.getfixturevalue(fixture)
    model = ehyb.EhybSpmv(EhybConfig()).setup(m)
    assert model._kernel == "triton"
    x = deterministic_x(m.dimension)
    assert rel_error(model.matvec(x), oracle_spmv(m, x)) < 5e-6


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("fixture", FIXTURES)
def test_compiled_phases_vs_xla(gpu, fixture, dtype, request):
    m = request.getfixturevalue(fixture)
    with jax.enable_x64(dtype == "float64"):
        model = ehyb.EhybSpmv(EhybConfig(dtype=dtype)).setup(m)
        x_dev = model.prepare_x(deterministic_x(m.dimension))
        assert x_dev.dtype == np.dtype(dtype)
        tol = 1e-6 if dtype == "float32" else 1e-13
        for kern, ref in ((sell_triton.ehyb_body_triton, xla_ops.ehyb_body_xla),
                          (sell_triton.ehyb_er_triton, xla_ops.ehyb_er_xla),
                          (sell_triton.ehyb_apply_triton,
                           xla_ops.ehyb_apply_xla)):
            a = np.asarray(jax.jit(kern)(model.dev, x_dev))
            b = np.asarray(jax.jit(ref)(model.dev, x_dev))
            assert a.shape == b.shape
            assert rel_error(a, b) <= tol


def test_long_rows_compiled(gpu):
    m = generate.with_dense_rows(
        generate.random_general(3000, 8, seed=21), 2, density=0.6, seed=22)
    model = ehyb.EhybSpmv(EhybConfig(long_row_threshold=128,
                                     body_layout="sell_cs")).setup(m)
    assert model.ehyb.n_long >= 1
    x = deterministic_x(m.dimension)
    assert rel_error(model.matvec(x), oracle_spmv(m, x)) < 1e-5
