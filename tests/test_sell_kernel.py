"""The Triton slice kernel in interpret mode, the kernel choice, and the
device-facing helpers (peak table, compile cache, native build keys, the
refusal to run without a GPU).  All of it runs on the CPU."""
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ehyb_spmv as ehyb
from ehyb_spmv.config import EhybConfig
from ehyb_spmv.core.coo import MatrixCOO, deterministic_x, oracle_spmv
from ehyb_spmv.io import generate
from ehyb_spmv.models.ehyb import GPU_MIN_GROUP_NNZ, body_kernel
from ehyb_spmv.ops import sell_triton, xla_ops
from ehyb_spmv.utils.validate import rel_error

from tests.kernel_helpers import gpu_flagship, interpret_matvec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gather_wall():
    # no column locality: nearly every entry lands in the ER tail
    return generate.random_general(32768, 4, seed=31)


def _dense_rows():
    return generate.with_dense_rows(
        generate.permuted(generate.poisson2d(48), seed=2), 3, density=0.4,
        seed=9)


MATRICES = {
    "poisson_mid": None, "fem_small": None, "scrambled": None,
    "powerlaw_small": None, "gather_wall": _gather_wall,
    "dense_rows": _dense_rows,
}
PHASES = {
    "body": (sell_triton.ehyb_body_triton, xla_ops.ehyb_body_xla),
    "er": (sell_triton.ehyb_er_triton, xla_ops.ehyb_er_xla),
    "full": (sell_triton.ehyb_apply_triton, xla_ops.ehyb_apply_xla),
}


def _matrix(name, request):
    make = MATRICES[name]
    return make() if make else request.getfixturevalue(name)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("phase", sorted(PHASES))
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_kernel_interpret_vs_xla(name, phase, dtype, request):
    """Each phase of the GPU path (interpret mode) against its XLA
    reference on the same device arrays; the full apply also against the
    exact-f64 oracle."""
    m = _matrix(name, request)
    kern, ref = PHASES[phase]
    with jax.enable_x64(dtype == "float64"):
        model = gpu_flagship(m, EhybConfig(dtype=dtype))
        x = deterministic_x(m.dimension)
        x_dev = model.prepare_x(x)
        assert x_dev.dtype == np.dtype(dtype)
        a = np.asarray(kern(model.dev, x_dev, interpret=True))
        b = np.asarray(ref(model.dev, x_dev))
        assert a.shape == b.shape and a.dtype == b.dtype
        tol = 1e-6 if dtype == "float32" else 1e-13
        assert rel_error(a, b) <= tol
        if phase == "full":
            y = model.recover_y(jnp.asarray(a))
            otol = 5e-6 if dtype == "float32" else 1e-12
            assert rel_error(y, oracle_spmv(m, x)) <= otol


def test_gather_wall_goes_to_er():
    """On the GPU layout a matrix with no locality keeps little in
    the body: groups below GPU_MIN_GROUP_NNZ entries go to the ER tail
    (at 1M rows, random_1m keeps 0.2% in the body)."""
    model = gpu_flagship(_gather_wall())
    st = model.ehyb.stats
    assert st["nnz_er"] > 0.5 * st["nnz_total"]


def test_dense_rows_leave_the_body():
    """Rows longer than long_row_threshold go to the long-row stream, so no
    slice of the body walks a dense row alone."""
    m = _dense_rows()
    model = gpu_flagship(m)
    assert model.ehyb.n_long == 3
    widths = np.diff(model.ehyb.slice_offset)
    assert widths.max() <= model.config.long_row_threshold


def test_long_rows_ordered_without_their_edges():
    """The ordering ignores long rows, so the stencil beneath them recovers
    its band and stays in the body."""
    model = gpu_flagship(_dense_rows())
    st = model.ehyb.stats
    assert st["nnz_er"] < 0.05 * st["nnz_total"]


# --- sell_slices on hand-made slices ---------------------------------------

def _numpy_slices(off, win, col, val, x):
    n_slices, C = off.shape[0] - 1, col.shape[1]
    y = np.zeros((n_slices, C))
    for s in range(n_slices):
        for k in range(off[s], off[s + 1]):
            base = win[k] if win is not None else 0
            y[s] += val[k] * x[base + col[k].astype(np.int64)]
    return y.reshape(-1)


@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("widths", [[1], [3, 0, 2], [0, 0, 4], [5, 1, 1, 7],
                                    [2, 2, 2, 2, 2, 2], [0]])
def test_sell_slices_vs_numpy(widths, windowed):
    rng = np.random.default_rng(len(widths) * 7 + windowed)
    C, nx = 128, 4096
    off = np.concatenate([[0], np.cumsum(widths)]).astype(np.int32)
    steps = int(off[-1])
    if windowed:
        win = rng.integers(0, nx - 1024, steps).astype(np.int32)
        col = rng.integers(0, 1024, (steps, C)).astype(np.int16)
    else:
        win = None
        col = rng.integers(0, nx, (steps, C)).astype(np.int32)
    val = rng.standard_normal((steps, C)).astype(np.float32)
    x = rng.standard_normal(nx).astype(np.float32)
    y = sell_triton.sell_slices(
        jnp.asarray(off), None if win is None else jnp.asarray(win),
        jnp.asarray(col), jnp.asarray(val), jnp.asarray(x), interpret=True)
    want = _numpy_slices(off, win, col, val, x)
    assert y.shape == (len(widths) * C,)
    np.testing.assert_allclose(np.asarray(y), want, rtol=1e-5, atol=1e-5)


def test_sell_slices_int16_equals_int32_columns():
    rng = np.random.default_rng(4)
    off = jnp.asarray([0, 3, 5], dtype=jnp.int32)
    win = jnp.asarray(rng.integers(0, 2048, 5), dtype=jnp.int32)
    col = rng.integers(0, 1024, (5, 128))
    val = jnp.asarray(rng.standard_normal((5, 128)), dtype=jnp.float32)
    x = jnp.asarray(rng.standard_normal(4096), dtype=jnp.float32)
    y16 = sell_triton.sell_slices(off, win, jnp.asarray(col, jnp.int16), val,
                                  x, interpret=True)
    y32 = sell_triton.sell_slices(off, win, jnp.asarray(col, jnp.int32), val,
                                  x, interpret=True)
    np.testing.assert_array_equal(np.asarray(y16), np.asarray(y32))


def test_sell_slices_no_steps_gives_zero_rows():
    off = jnp.zeros(4, jnp.int32)
    y = sell_triton.sell_slices(off, None, jnp.zeros((0, 128), jnp.int32),
                                jnp.zeros((0, 128)), jnp.ones(64),
                                interpret=True)
    assert y.shape == (3 * 128,) and not np.any(np.asarray(y))


def test_sell_slices_no_slices():
    y = sell_triton.sell_slices(jnp.zeros(1, jnp.int32), None,
                                jnp.zeros((0, 128), jnp.int32),
                                jnp.zeros((0, 128)), jnp.ones(64),
                                interpret=True)
    assert y.shape == (0,)


def test_sell_slices_rejects_non_power_of_two_width():
    with pytest.raises(ValueError, match="power of two"):
        sell_triton.sell_slices(jnp.asarray([0, 1], jnp.int32), None,
                                jnp.zeros((1, 96), jnp.int32),
                                jnp.zeros((1, 96)), jnp.ones(64),
                                interpret=True)


def test_relaxed_layout_rejected_by_kernel(scrambled):
    model = ehyb.EhybXlaSpmv(EhybConfig(window_rows=1024,
                                        body_layout="sell_rx")).setup(scrambled)
    assert model.dev.rx_body
    with pytest.raises(ValueError, match="sell_rx"):
        sell_triton.ehyb_body_triton(model.dev, model.prepare_x(
            deterministic_x(scrambled.dimension)), interpret=True)


@pytest.mark.parametrize("dim", [1, 2, 127, 129, 1000])
def test_gpu_path_odd_dimensions(dim):
    """1x1 matrices and dimensions that are not a multiple of 128."""
    rng = np.random.default_rng(dim)
    n = max(dim * 3, 1)
    row = np.concatenate([np.arange(dim), rng.integers(0, dim, n)])
    col = np.concatenate([np.arange(dim), rng.integers(0, dim, n)])
    key = np.unique(row * dim + col)
    m = MatrixCOO(dim, dim, key // dim, key % dim,
                  rng.standard_normal(key.size))
    model = gpu_flagship(m)
    x = deterministic_x(dim)
    y = interpret_matvec(model, x)
    assert y.shape == (dim,)
    assert rel_error(y, oracle_spmv(m, x)) < 5e-6


def test_gpu_path_all_dia_skips_body_and_er():
    m = generate.CORPUS["diag4k"]()
    model = gpu_flagship(m)
    st = model.ehyb.stats
    assert st["nnz_ell"] == 0 and st["nnz_er"] == 0
    x = deterministic_x(m.dimension)
    assert rel_error(interpret_matvec(model, x), oracle_spmv(m, x)) < 1e-6


# --- kernel choice -----------------------------------------------------------

@pytest.mark.parametrize("backend,dword,want", [
    ("gpu", False, "triton"), ("cpu", False, "xla"),
    ("gpu", True, "xla")])
def test_body_kernel_choice(backend, dword, want):
    assert body_kernel(EhybConfig(dword_values=dword), backend) == want


def test_flagship_on_gpu_pins_kernel_layout(poisson_mid):
    model = gpu_flagship(poisson_mid)
    cfg = model.config
    assert (cfg.body_layout, cfg.index_dtype, cfg.relax_body) == \
        ("sell_mw", "int16", "never")
    assert cfg.width_align == 1 and cfg.sliding_windows is True
    assert cfg.min_window_group_nnz == GPU_MIN_GROUP_NNZ
    assert model.dev.ell_col.dtype == jnp.int16


def test_flagship_on_gpu_keeps_chunk_sync_request(poisson_mid):
    model = gpu_flagship(poisson_mid, EhybConfig(body_layout="sell_cs"))
    assert model.config.body_layout == "sell_cs"


def test_flagship_on_cpu_runs_xla_with_config_layout(poisson_mid):
    model = ehyb.EhybSpmv(EhybConfig(window_rows=1024)).setup(poisson_mid)
    assert model._kernel == "xla"
    assert model.config.body_layout == "sell"


# --- device truth: peak table, timing record --------------------------------

def _fake_device(platform, kind):
    return SimpleNamespace(platform=platform, device_kind=kind)


def test_peak_table_h100():
    from ehyb_spmv.utils.timing import peak_mem_bw

    assert peak_mem_bw(_fake_device("gpu", "NVIDIA H100 80GB HBM3")) \
        == 3.35e12


def test_peak_table_unknown_device_is_an_error():
    from ehyb_spmv.utils.timing import peak_mem_bw

    with pytest.raises(KeyError, match="no peak bandwidth"):
        peak_mem_bw(_fake_device("gpu", "Some Future Card"))


def test_peak_on_cpu_is_not_measured():
    from ehyb_spmv.utils.timing import peak_mem_bw

    assert peak_mem_bw() is None


def test_bench_on_cpu_reports_no_roofline(poisson_small):
    from ehyb_spmv.utils.timing import bench_apply

    model = ehyb.EhybXlaSpmv(EhybConfig()).setup(poisson_small)
    x_dev = model.prepare_x(deterministic_x(poisson_small.dimension))
    res = bench_apply("t", lambda n: model.iterate(x_dev, n),
                      nnz=poisson_small.nnz, iters=20, warmup=1)
    assert res.roofline_frac is None and "not measured" in str(res)
    assert res.gflops > 0


# --- compile cache -------------------------------------------------------------

def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from ehyb_spmv.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.compile_cache_dir() == str(tmp_path)


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    from ehyb_spmv.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = compile_cache.compile_cache_dir()
    assert d == os.path.join(REPO, ".jax_cache")
    assert d == compile_cache.compile_cache_dir()  # no pid, time or temp name
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    from ehyb_spmv.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(compile_cache, "DEFAULT_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


# --- native build keys -------------------------------------------------------

def test_native_library_path_is_keyed_by_source(monkeypatch, tmp_path):
    from ehyb_spmv import native

    src = tmp_path / "k.cpp"
    src.write_text("int f() { return 1; }\n")
    monkeypatch.setattr(native, "_HERE", str(tmp_path))
    monkeypatch.setattr(native, "_host_key", b"host-a")
    p1 = native.library_path("k.cpp")
    assert p1 == native.library_path("k.cpp")
    src.write_text("int f() { return 2; }\n")
    assert native.library_path("k.cpp") != p1


def test_native_library_path_is_keyed_by_host(monkeypatch):
    from ehyb_spmv import native

    monkeypatch.setattr(native, "_host_key", b"host-a")
    pa = native.library_path("rcm.cpp")
    monkeypatch.setattr(native, "_host_key", b"host-b")
    assert native.library_path("rcm.cpp") != pa
    assert os.path.dirname(pa) == os.path.join(REPO, "ehyb_spmv", "native",
                                               "build")


def test_native_build_outside_source_tree():
    from ehyb_spmv import native

    lib = native.build_native()
    assert os.path.exists(lib) and "/build/" in lib


# --- no GPU, no result ----------------------------------------------------

def _run(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    p = _run(["chip_smoke.py"])
    assert p.returncode != 0
    assert "no GPU" in p.stderr
    assert '"ok"' not in p.stdout


def test_bench_refuses_cpu():
    p = _run(["bench.py"])
    assert p.returncode != 0
    assert "needs a GPU" in p.stderr
    assert "metric" not in p.stdout


def test_cli_gpu_platform_without_gpu():
    p = _run(["-m", "ehyb_spmv", "-g", "poisson2d_64", "--platform", "gpu"])
    assert p.returncode == 2
    assert "platform 'gpu' unavailable" in p.stderr
