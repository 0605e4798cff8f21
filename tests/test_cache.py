"""Artifact-cache + corpus-cache tests.

The disk cache is the framework's answer to the reference rebuilding its
format from ``.mtx`` on every run (``spmv.cu:73``; SURVEY.md §5).  These
tests pin the two r2-advisor/VERDICT findings: the cache key must be the
PRE-auto-switch config fingerprint (or every rx-switched run misses
forever), and the fingerprint must be cheap (sampled) yet still sensitive
to real matrix edits.
"""
import dataclasses

import numpy as np
import pytest

from ehyb_spmv.config import EhybConfig
from ehyb_spmv.core.cache import matrix_fingerprint
from ehyb_spmv.core.coo import MatrixCOO, deterministic_x, oracle_spmv
from ehyb_spmv.io import generate
from ehyb_spmv.models.ehyb import EhybXlaSpmv
from ehyb_spmv.utils.validate import rel_error


def test_cache_roundtrip_same_result(poisson_small, tmp_path):
    cfg = EhybConfig(window_rows=1024, artifact_cache=True,
                     cache_dir=str(tmp_path))
    x = deterministic_x(poisson_small.dimension)
    want = oracle_spmv(poisson_small, x)

    m1 = EhybXlaSpmv(cfg).setup(poisson_small)
    assert "convert" in m1.setup_seconds          # cold: converted
    y1 = m1.matvec(x)

    m2 = EhybXlaSpmv(dataclasses.replace(cfg)).setup(poisson_small)
    assert "cache_load" in m2.setup_seconds       # warm: loaded
    y2 = m2.matvec(x)
    np.testing.assert_array_equal(y1, y2)
    assert rel_error(y2, want) < 5e-6


def test_cache_hit_after_rx_auto_switch(scrambled, tmp_path):
    """Regression (advisor r2): when the relax auto-switch fires, artifacts
    must be saved under the PRE-switch fingerprint — the one the next run's
    load computes — or the cache misses on every run."""
    cfg = EhybConfig(window_rows=1024, body_layout="sell_mw",
                     artifact_cache=True, cache_dir=str(tmp_path))
    m1 = EhybXlaSpmv(cfg).setup(scrambled)
    assert m1.config.body_layout == "sell_rx"     # the switch fired
    assert "convert" in m1.setup_seconds

    m2 = EhybXlaSpmv(EhybConfig(window_rows=1024, body_layout="sell_mw",
                                artifact_cache=True,
                                cache_dir=str(tmp_path))).setup(scrambled)
    assert "cache_load" in m2.setup_seconds, "rx-switched artifact missed"
    # the loaded artifact is rx; the config must mirror that
    assert m2.config.body_layout == "sell_rx"
    assert m2.ehyb.step_win_b.size
    x = deterministic_x(scrambled.dimension)
    assert rel_error(m2.matvec(x), oracle_spmv(scrambled, x)) < 5e-6


def test_fingerprint_sensitivity(poisson_small):
    fp0 = matrix_fingerprint(poisson_small)
    # same content → same fingerprint
    clone = MatrixCOO(poisson_small.n_rows, poisson_small.n_cols,
                      poisson_small.row.copy(), poisson_small.col.copy(),
                      poisson_small.val.copy())
    assert matrix_fingerprint(clone) == fp0
    # a changed value at a sampled position (head block is always sampled)
    v = poisson_small.val.copy()
    v[0] += 1.0
    m2 = MatrixCOO(poisson_small.n_rows, poisson_small.n_cols,
                   poisson_small.row, poisson_small.col, v)
    assert matrix_fingerprint(m2) != fp0
    # a changed tail entry (tail block is always sampled)
    v2 = poisson_small.val.copy()
    v2[-1] += 1.0
    m3 = MatrixCOO(poisson_small.n_rows, poisson_small.n_cols,
                   poisson_small.row, poisson_small.col, v2)
    assert matrix_fingerprint(m3) != fp0
    # different nnz
    m4 = MatrixCOO(poisson_small.n_rows, poisson_small.n_cols,
                   poisson_small.row[:-1], poisson_small.col[:-1],
                   poisson_small.val[:-1])
    assert matrix_fingerprint(m4) != fp0


def test_fingerprint_is_fast_on_large_input():
    """The sampled fingerprint must not scale with nnz (full-array SHA-256
    cost ~10 s of every audikw-class cached setup, VERDICT r2 #6)."""
    import time

    n = 20_000_000
    m = MatrixCOO(n, n, np.arange(n, dtype=np.int64),
                  np.arange(n, dtype=np.int64), np.ones(n))
    t0 = time.perf_counter()
    matrix_fingerprint(m)
    assert time.perf_counter() - t0 < 0.5


def test_load_corpus_disk_cache(tmp_path):
    m1 = generate.load_corpus("poisson2d_64", cache_dir=str(tmp_path))
    assert (tmp_path / "poisson2d_64.ok").exists()
    assert (tmp_path / "poisson2d_64.row.npy").exists()
    m2 = generate.load_corpus("poisson2d_64", cache_dir=str(tmp_path))
    np.testing.assert_array_equal(m1.row, m2.row)
    np.testing.assert_array_equal(m1.col, m2.col)
    np.testing.assert_array_equal(m1.val, m2.val)
    assert matrix_fingerprint(m1) == matrix_fingerprint(m2)


def test_load_corpus_legacy_npz_upgrade(tmp_path):
    # A pre-round-4 .npz cache entry is read once, rewritten as raw .npy,
    # and removed.
    m0 = generate.CORPUS["poisson2d_64"]()
    np.savez(tmp_path / "poisson2d_64.npz", n_rows=m0.n_rows, n_cols=m0.n_cols,
             row=m0.row.astype(np.int32), col=m0.col.astype(np.int32),
             val=m0.val)
    m1 = generate.load_corpus("poisson2d_64", cache_dir=str(tmp_path))
    assert not (tmp_path / "poisson2d_64.npz").exists()
    assert (tmp_path / "poisson2d_64.ok").exists()
    m2 = generate.load_corpus("poisson2d_64", cache_dir=str(tmp_path))
    np.testing.assert_array_equal(m1.row, m2.row)
    np.testing.assert_array_equal(m1.val, m2.val)
    assert matrix_fingerprint(m0) == matrix_fingerprint(m2)
