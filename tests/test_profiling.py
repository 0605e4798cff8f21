"""Profiling/observability subsystem tests (SURVEY.md §5 gap the framework
fills: roofline audit, per-phase breakdown, jax.profiler trace capture)."""
import math
import os

import numpy as np
import pytest

import ehyb_spmv as ehyb
from ehyb_spmv.config import EhybConfig
from ehyb_spmv.core.coo import deterministic_x
from ehyb_spmv.io import generate
from ehyb_spmv.utils.profiling import (phase_breakdown,
                                               roofline_report, trace)


@pytest.fixture(scope="module")
def model_and_x():
    m = generate.CORPUS["poisson2d_64"]()
    mod = ehyb.MODELS["ehyb_xla"](EhybConfig()).setup(m)
    x_dev = mod.prepare_x(deterministic_x(m.dimension))
    return mod, x_dev


def test_roofline_report(model_and_x):
    mod, _ = model_and_x
    rep = roofline_report(mod.ehyb.stats)
    assert "roofline audit" in rep and "total bytes/iter" in rep
    assert "dia" in rep  # poisson is DIA-dominated


def test_phase_breakdown(model_and_x):
    mod, x_dev = model_and_x
    t = phase_breakdown(mod, x_dev, iters=20)
    assert "full_apply" in t and "dia" in t
    assert t["full_apply"] >= 0.0 and not math.isnan(t["full_apply"])


def test_trace_capture(model_and_x, tmp_path):
    mod, x_dev = model_and_x
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        import jax

        jax.block_until_ready(mod.iterate(x_dev, 3))
    # a plugins/profile/<ts>/ directory with at least one file must exist
    found = [os.path.join(r, f) for r, _, fs in os.walk(logdir) for f in fs]
    assert found, "no trace files written"


def test_cli_profile_flag(capsys):
    from ehyb_spmv.cli import main

    rc = main(["-g", "poisson2d_64", "-i", "2", "--platform", "cpu",
               "--model", "ehyb_xla", "--profile"])
    out = capsys.readouterr().out
    assert rc == 0 and "roofline audit" in out
