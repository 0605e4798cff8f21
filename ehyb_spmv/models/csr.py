"""Baseline SpMV models: CSR/segment-sum and BCOO (vendor-library analog).

These play the role of the reference's cuSPARSE comparison paths
(``spmvGeneric`` ``spmv.cu:135-281``, ``solverGPuUnprecondCUSPARSE``
``spmv.cu:282-437``): simple formats, no reordering, no windows — the numbers
EHYB has to beat.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.coo import MatrixCOO
from ..ops.xla_ops import coo_spmv
from .base import SpmvModel


class CsrSpmv(SpmvModel):
    """Row-sorted COO/CSR SpMV via gather + segment-sum (pure XLA)."""

    name = "csr"

    def setup(self, m: MatrixCOO) -> "CsrSpmv":
        self.m = m
        ms = m.sorted_by_row()
        self._row = jnp.asarray(ms.row, dtype=jnp.int32)
        self._col = jnp.asarray(ms.col, dtype=jnp.int32)
        self._val = jnp.asarray(ms.val, dtype=self.config.dtype)
        self._n_rows = m.n_rows
        return self

    def apply(self, x_dev: jax.Array) -> jax.Array:
        return coo_spmv(self._row, self._col, self._val, x_dev, self._n_rows)

    def device_operands(self):
        return self._row, self._col, self._val

    def apply_operands(self, operands, x_dev):
        if operands is None:
            return self.apply(x_dev)
        row, col, val = operands
        return coo_spmv(row, col, val, x_dev, self._n_rows)


class BcooSpmv(SpmvModel):
    """``jax.experimental.sparse`` BCOO matvec — the vendor baseline."""

    name = "bcoo"

    def setup(self, m: MatrixCOO) -> "BcooSpmv":
        from jax.experimental import sparse as jsparse

        self.m = m
        ms = m.sorted_by_row()
        indices = jnp.stack([jnp.asarray(ms.row, dtype=jnp.int32),
                             jnp.asarray(ms.col, dtype=jnp.int32)], axis=1)
        self._mat = jsparse.BCOO(
            (jnp.asarray(ms.val, dtype=self.config.dtype), indices),
            shape=(m.n_rows, m.n_cols), indices_sorted=True, unique_indices=True)
        return self

    def apply(self, x_dev: jax.Array) -> jax.Array:
        return self._mat @ x_dev

    def device_operands(self):
        return self._mat.data, self._mat.indices

    def apply_operands(self, operands, x_dev):
        if operands is None:
            return self.apply(x_dev)
        from jax.experimental import sparse as jsparse

        data, indices = operands
        mat = jsparse.BCOO((data, indices), shape=(self.m.n_rows, self.m.n_cols),
                           indices_sorted=True, unique_indices=True)
        return mat @ x_dev
