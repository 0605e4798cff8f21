"""SpMV model base: the prepare → apply → recover pipeline contract.

A "model" is one complete SpMV strategy (format + kernels), mirroring the
reference's solver entry points (``spmvGPuEHYB`` ``spmv.cu:62``, the cuSPARSE
baselines ``spmv.cu:135,282``).  The lifecycle mirrors the reference pipeline
(SURVEY.md §0): ``setup`` does the one-time host preprocessing (plan → partition
→ reorder → convert → device upload); ``prepare_x``/``recover_y`` are the
outside-the-timed-region vector permutations (``vectorReorder``/``vectorRecover``,
``solver_test.c:376,383``); ``apply`` is the jitted device SpMV — the only thing
inside the benchmark loop, like the kernel launches at ``spmv.cu:110-116``.
"""
from __future__ import annotations

import abc
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EhybConfig
from ..core.coo import MatrixCOO


class SpmvModel(abc.ABC):
    """Base class for SpMV strategies."""

    name: str = "base"

    def __init__(self, config: Optional[EhybConfig] = None):
        self.config = config or EhybConfig()
        self.m: Optional[MatrixCOO] = None
        self._apply_jit = None

    # -- one-time host preprocessing ---------------------------------------
    @abc.abstractmethod
    def setup(self, m: MatrixCOO) -> "SpmvModel":
        """Plan/partition/reorder/convert + device upload.  Returns self."""

    # -- vector in/out ------------------------------------------------------
    def prepare_x(self, x: np.ndarray) -> jax.Array:
        """Host x (original ordering) → device array in the model's layout."""
        return jnp.asarray(x, dtype=self.config.dtype)

    def recover_y(self, y: jax.Array) -> np.ndarray:
        """Device y (model layout) → host f64 vector in the original ordering."""
        return np.asarray(y, dtype=np.float64)[: self.m.n_rows]

    # -- the timed device op ------------------------------------------------
    @abc.abstractmethod
    def apply(self, x_dev: jax.Array) -> jax.Array:
        """One SpMV in the model's layout (jit-compatible)."""

    # -- operand passing mode ------------------------------------------------
    # Models pass their matrix arrays to the jitted apply as ARGUMENTS
    # (``device_operands``), not as closure constants: constants are embedded
    # in the compiled program, which inflates compile time and memory with
    # the matrix size.
    def device_operands(self):
        """Pytree of device arrays passed to the jitted apply as arguments."""
        return None

    def apply_operands(self, operands, x_dev: jax.Array) -> jax.Array:
        """Apply with explicit operands; the default (no operands) ignores
        them."""
        return self.apply(x_dev)

    # -- conveniences -------------------------------------------------------
    def matvec(self, x: np.ndarray) -> np.ndarray:
        """End-to-end y = A·x (original ordering, host in/out)."""
        return self.recover_y(self.apply_jit(self.prepare_x(x)))

    @property
    def apply_jit(self):
        if self._apply_jit is None:
            jf = jax.jit(partial(type(self).apply_operands, self))
            self._apply_jit = lambda x: jf(self.device_operands(), x)
        return self._apply_jit

    def iterate(self, x_dev: jax.Array, n_iters: int,
                eps: float = 0.0) -> jax.Array:
        """``n_iters`` chained SpMVs for benchmarking: y_{k} = A·(x + eps·y_{k-1}).

        With eps = 0 the result equals a single A·x bit-for-bit, but because eps
        is a *traced* scalar XLA cannot hoist the loop-invariant SpMV out of the
        loop — the equivalent of the reference's honest kernel-launch loop
        (``spmv.cu:110-116``, which relaunches the same y = A·x every iteration).
        """
        return self._iterate_jit(self.device_operands(), x_dev,
                                 jnp.asarray(eps, dtype=x_dev.dtype),
                                 jnp.asarray(n_iters, dtype=jnp.int32))

    @partial(jax.jit, static_argnums=(0,))
    def _iterate_jit(self, operands, x_dev, eps, n_iters):
        # n_iters is a *traced* scalar: one compile serves every iteration
        # count (fori_loop lowers to a while loop).
        y0 = self.apply_operands(operands, x_dev)

        def body(_, y):
            return self.apply_operands(
                operands, x_dev + eps * _resize_like(y, x_dev))

        return jax.lax.fori_loop(0, n_iters - 1, body, y0)

    # -- metadata -----------------------------------------------------------
    @property
    def nnz(self) -> int:
        return self.m.nnz if self.m is not None else 0


def _resize_like(y: jax.Array, x: jax.Array) -> jax.Array:
    """Pad/trim y's LAST axis to x's (models may emit padded y; the dword
    pipeline carries (2, n) (hi, lo) stacks where n varies between the
    padded x and the slice-padded y — resizing axis 0 there silently kept
    the mismatch and broke the iterate chain's x + eps*y)."""
    if y.shape == x.shape:
        return y
    n, m = x.shape[-1], y.shape[-1]
    if m > n:
        return y[..., :n]
    return jnp.concatenate(
        [y, jnp.zeros(y.shape[:-1] + (n - m,), y.dtype)], axis=-1)
