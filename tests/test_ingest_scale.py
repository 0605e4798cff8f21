"""CI-size regression for the at-scale file-ingest flow (VERDICT r4 next #9).

`scripts/mtx_scale.py` proves the reference's canonical flow at audikw_1
scale (1.32 GB lower-triangle symmetric `.mtx` → CLI → validated SpMV,
`README.md:8-13`, `solver_test.c:284`); this test runs the SAME pipeline —
symmetrized FEM generate → chunked lower-triangle writer → `read_mtx`
(symmetric expansion) → exact round trip → canonical CLI run — at a size the
suite can afford, so the ingest path cannot silently rot between the rare
at-scale runs.
"""
import importlib.util
import json
import os
import sys

import numpy as np

_SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")


def _load_mtx_scale():
    spec = importlib.util.spec_from_file_location(
        "mtx_scale", os.path.join(_SCRIPTS, "mtx_scale.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ingest_roundtrip_and_cli(tmp_path, capsys):
    ms = _load_mtx_scale()
    from ehyb_spmv.cli import main
    from ehyb_spmv.io import mtx

    m = ms.symmetrized_fem3d(8)           # dim 1536, nnz ~109k
    path = str(tmp_path / "fem3d_8_sym.mtx")
    ms.write_lower_triangle(path, m)

    # header says symmetric + stored lines = lower triangle only
    with open(path, "rb") as f:
        hdr = mtx.read_header(f)
    assert hdr.symmetry == "symmetric"
    n_stored = int(np.count_nonzero(m.row >= m.col))
    assert hdr.n_entries == n_stored

    # read back: symmetric expansion must reproduce the full matrix exactly
    m2 = mtx.read_mtx(path)
    assert m2.nnz == m.nnz
    key = lambda mm: np.lexsort((mm.col, mm.row))  # noqa: E731
    k1, k2 = key(m), key(m2)
    np.testing.assert_array_equal(m.row[k1], m2.row[k2])
    np.testing.assert_array_equal(m.col[k1], m2.col[k2])
    assert np.max(np.abs(m.val[k1] - m2.val[k2])) < 1e-12

    # canonical CLI flow on the file (the reference's ./spmv.out -m ... -i N)
    rc = main(["-m", path, "-i", "3", "--platform", "cpu", "--json"])
    out = capsys.readouterr().out
    assert rc == 0
    res = json.loads([l for l in out.splitlines() if l.startswith("{")][-1])
    assert res["valid"]
    assert res["gflops"] > 0
