"""Helpers for testing the GPU slice kernel on the CPU (interpret mode)."""
from unittest import mock

import jax

import ehyb_spmv as ehyb
from ehyb_spmv.config import EhybConfig
from ehyb_spmv.ops.sell_triton import ehyb_apply_triton


def gpu_flagship(m, config=None):
    """The flagship set up exactly as on the GPU (layout pinned for the
    Triton kernel), built on the CPU."""
    with mock.patch.object(jax, "default_backend", lambda: "gpu"):
        model = ehyb.EhybSpmv(config or EhybConfig()).setup(m)
    assert model._kernel == "triton"
    return model


def interpret_matvec(model, x):
    """y = A·x through the Triton kernel in interpret mode (host in/out)."""
    y = ehyb_apply_triton(model.dev, model.prepare_x(x), interpret=True)
    return model.recover_y(y)
