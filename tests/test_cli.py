"""CLI tests — the reference's only executable is its benchmark binary
(``solver_test.c:267-408``); this drives ours the same way end-to-end."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from ehyb_spmv.cli import main
from ehyb_spmv.io import generate, write_mtx


def run_cli(args, capsys):
    rc = main(args)
    out = capsys.readouterr().out
    return rc, out


def test_cli_generated_matrix(capsys):
    rc, out = run_cli(["-g", "poisson2d_64", "-i", "5", "--platform", "cpu",
                       "--json"], capsys)
    assert rc == 0
    line = [l for l in out.splitlines() if l.startswith("{")][-1]
    res = json.loads(line)
    assert res["valid"]
    assert res["gflops"] > 0


def test_cli_mtx_file(tmp_path, capsys):
    m = generate.permuted(generate.poisson2d(24), seed=1)
    write_mtx(str(tmp_path / "demo.mtx"), m, symmetry="symmetric")
    rc, out = run_cli(["-m", "demo", "--read-dir", str(tmp_path), "-i", "3",
                       "--platform", "cpu"], capsys)
    assert rc == 0
    assert "PASS" in out


def test_cli_no_dia_flag(capsys):
    rc, out = run_cli(["-g", "poisson2d_64", "-i", "2", "--platform", "cpu",
                       "--no-dia", "--model", "ehyb_xla"], capsys)
    assert rc == 0
    assert "PASS" in out


def test_cli_missing_file(capsys):
    rc, _ = run_cli(["-m", "nope", "--read-dir", "/nonexistent"], capsys)
    assert rc == 2


def test_cli_unknown_corpus(capsys):
    rc, _ = run_cli(["-g", "not_a_matrix"], capsys)
    assert rc == 2


def test_cli_list_corpus(capsys):
    rc, out = run_cli(["--list-corpus", "-g", "x"], capsys)
    assert rc == 0
    assert "fem3d_32" in out


def test_module_entry_subprocess():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "ehyb_spmv", "-g", "diag4k", "-i", "2",
         "--platform", "cpu", "--model", "ehyb_xla"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "PASS" in proc.stdout
