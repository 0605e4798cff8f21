"""CG solver + power iteration tests (the live analog of the reference's dead
PRECOND/CG machinery, SURVEY.md §2)."""
import numpy as np
import pytest

import ehyb_spmv as ehyb
from ehyb_spmv.config import EhybConfig
from ehyb_spmv.core.coo import deterministic_x, oracle_spmv
from ehyb_spmv.io import generate
from ehyb_spmv.models.solver import CgSolver, PowerIteration


@pytest.fixture(scope="module")
def spd_system():
    m = generate.poisson2d(32)  # SPD Laplacian, dim 1024
    x_true = deterministic_x(m.dimension)
    b = oracle_spmv(m, x_true)
    return m, x_true, b


@pytest.mark.parametrize("model_name", ["csr", "ehyb_xla"])
def test_cg_converges(spd_system, model_name):
    m, x_true, b = spd_system
    model = ehyb.MODELS[model_name](EhybConfig(window_rows=1024)).setup(m)
    res = CgSolver(model).solve(b, tol=1e-5, max_iters=3000)
    assert res.converged, res
    assert np.linalg.norm(res.x - x_true) / np.linalg.norm(x_true) < 1e-3


def test_cg_jacobi_preconditioning(spd_system):
    m, x_true, b = spd_system
    model = ehyb.MODELS["csr"](EhybConfig()).setup(m)
    plain = CgSolver(model, precondition="none").solve(b, tol=1e-5,
                                                       max_iters=3000)
    jacobi = CgSolver(model, precondition="jacobi").solve(b, tol=1e-5,
                                                          max_iters=3000)
    assert jacobi.converged
    # For the uniform Laplacian Jacobi is a constant scaling — iteration count
    # should be in the same ballpark, and the solution accurate.
    assert np.linalg.norm(jacobi.x - x_true) / np.linalg.norm(x_true) < 1e-3


def test_cg_bad_preconditioner_name(spd_system):
    m, _, _ = spd_system
    model = ehyb.MODELS["csr"](EhybConfig()).setup(m)
    with pytest.raises(ValueError):
        CgSolver(model, precondition="ilu")


def test_power_iteration_dominant_eig():
    m = generate.diag_matrix(512, 2.0)
    # make one eigenvalue dominant
    import numpy as np
    from ehyb_spmv.core.coo import MatrixCOO

    row = np.concatenate([m.row, [7]])
    col = np.concatenate([m.col, [7]])
    val = np.concatenate([m.val, [3.0]])  # A[7,7] = 5
    m2 = MatrixCOO(512, 512, row, col, val)
    model = ehyb.MODELS["csr"](EhybConfig()).setup(m2)
    v, lam = PowerIteration(model).run(iters=100)
    assert abs(lam - 5.0) < 1e-3
    assert abs(abs(v[7]) - 1.0) < 1e-2


def test_cg_checkpoint_resume(tmp_path):
    """Checkpoint/resume: interrupting after the first segment and re-solving
    from the checkpoint reaches the same solution (SURVEY.md §5 gap)."""
    import numpy as np
    import ehyb_spmv as ehyb
    from ehyb_spmv.config import EhybConfig
    from ehyb_spmv.io import generate
    from ehyb_spmv.models.solver import CgSolver

    m = generate.poisson2d(24)
    rng = np.random.default_rng(3)
    b = rng.standard_normal(m.dimension)
    model = ehyb.MODELS["ehyb_xla"](EhybConfig(dtype="float64")).setup(m)
    ckpt = str(tmp_path / "cg.npz")

    # Segment 1: cap at 5 iterations total — writes a checkpoint, not converged.
    r1 = CgSolver(model).solve(b, tol=1e-8, max_iters=5,
                               checkpoint_every=5, checkpoint_path=ckpt)
    assert not r1.converged
    z = np.load(ckpt)
    assert int(z["iterations"]) == 5

    # Resume: picks up from the checkpoint and converges.
    r2 = CgSolver(model).solve(b, tol=1e-8, max_iters=2000,
                               checkpoint_every=50, checkpoint_path=ckpt)
    assert r2.converged and r2.iterations > 5
    want = np.zeros(m.dimension)
    dense = np.zeros((m.dimension, m.dimension))
    np.add.at(dense, (m.row, m.col), m.val)
    # f32 compute (x64 disabled in the suite): modest tolerance
    np.testing.assert_allclose(dense @ r2.x, b, rtol=0, atol=5e-4)


def test_cg_checkpoint_fingerprint_and_cleanup(tmp_path):
    """Advisor r1: a checkpoint from a DIFFERENT problem must be ignored,
    and a converged solve must remove its checkpoint."""
    import numpy as np
    import ehyb_spmv as ehyb
    from ehyb_spmv.config import EhybConfig
    from ehyb_spmv.io import generate
    from ehyb_spmv.models.solver import CgSolver

    m = generate.poisson2d(16)
    rng = np.random.default_rng(4)
    b1 = rng.standard_normal(m.dimension)
    b2 = rng.standard_normal(m.dimension)
    model = ehyb.MODELS["ehyb_xla"](EhybConfig(dtype="float64")).setup(m)
    ckpt = str(tmp_path / "cg.npz")

    r1 = CgSolver(model).solve(b1, tol=1e-8, max_iters=5,
                               checkpoint_every=5, checkpoint_path=ckpt)
    assert not r1.converged
    import os
    assert os.path.exists(ckpt)

    # different rhs: the stale checkpoint must NOT warm-start this solve
    r2 = CgSolver(model).solve(b2, tol=1e-8, max_iters=2000,
                               checkpoint_every=100, checkpoint_path=ckpt)
    assert r2.converged
    dense = np.zeros((m.dimension, m.dimension))
    np.add.at(dense, (m.row, m.col), m.val)
    np.testing.assert_allclose(dense @ r2.x, b2, rtol=0, atol=5e-4)
    # converged: checkpoint removed
    assert not os.path.exists(ckpt)


def test_cg_single_compile_across_segments(tmp_path):
    """VERDICT r1 #10: the per-segment iteration budget is a traced scalar —
    different checkpoint cadences reuse ONE compiled loop."""
    import jax
    import numpy as np
    import ehyb_spmv as ehyb
    from ehyb_spmv.config import EhybConfig
    from ehyb_spmv.io import generate
    from ehyb_spmv.models.solver import CgSolver

    m = generate.poisson2d(16)
    b = np.ones(m.dimension)
    model = ehyb.MODELS["ehyb_xla"](EhybConfig(dtype="float64")).setup(m)
    solver = CgSolver(model)
    n0 = solver._solve_jit._cache_size()
    solver.solve(b, tol=1e-10, max_iters=7,
                 checkpoint_every=3, checkpoint_path=str(tmp_path / "a.npz"))
    solver.solve(b, tol=1e-10, max_iters=11,
                 checkpoint_every=4, checkpoint_path=str(tmp_path / "b.npz"))
    # one trace for all (budget, cadence) combinations
    assert solver._solve_jit._cache_size() - n0 <= 1
