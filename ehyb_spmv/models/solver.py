"""Iterative solvers on top of the SpMV models.

The reference carries the skeleton of a preconditioned conjugate-gradient
solver as dead code — axpy/init kernels (``kernelMyxpy`` ``kernel.cu:288-296``,
``kernelInitialize*`` ``kernel.cu:13-41``), the ``PRECOND``/``FACT`` feature
flags (``spmv.h:8,13``), and CLI options that gate nothing
(``solver_test.c:295-304``; SURVEY.md §2 "CG-solver vestiges").  This module is
the live realization: a jitted conjugate-gradient (optionally
Jacobi-preconditioned) whose matrix-vector product is any :class:`SpmvModel`
apply, with all vector work (the axpy analogs) left to XLA fusion.

The whole solve runs on-device under one ``lax.while_loop`` — no host round
trips per iteration — with optional periodic state checkpointing to host
(checkpoint/resume being one of the auxiliary subsystems the reference lacks,
SURVEY.md §5).
"""
from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.coo import MatrixCOO
from ..utils.log import get_logger
from .base import SpmvModel, _resize_like

log = get_logger(__name__)


@dataclasses.dataclass
class CgResult:
    x: np.ndarray
    iterations: int
    residual_norm: float
    converged: bool


class CgSolver:
    """Conjugate gradient for SPD systems A·x = b using a SpMV model.

    ``precondition='jacobi'`` enables diagonal (Jacobi) preconditioning — the
    working analog of the reference's vestigial PRECOND flag (``spmv.h:8``).
    """

    def __init__(self, model: SpmvModel, precondition: str = "none"):
        if precondition not in ("none", "jacobi"):
            raise ValueError(f"unknown preconditioner {precondition!r}")
        self.model = model
        self.precondition = precondition
        self._minv = None

    def _prepare(self, m: MatrixCOO):
        if self.precondition == "jacobi":
            diag = np.zeros(m.n_rows)
            on_diag = m.row == m.col
            np.add.at(diag, m.row[on_diag], m.val[on_diag])
            diag[diag == 0.0] = 1.0
            # move the inverse diagonal through the model's vector layout
            self._minv = self.model.prepare_x(1.0 / diag)

    def solve(self, b: np.ndarray, tol: float = 1e-6, max_iters: int = 1000,
              x0: Optional[np.ndarray] = None,
              checkpoint_every: Optional[int] = None,
              checkpoint_path: Optional[str] = None) -> CgResult:
        """Solve A·x = b.

        With ``checkpoint_every``/``checkpoint_path``, the device loop runs in
        segments of that many iterations and the solver state (x, iteration
        count) is written to ``<checkpoint_path>`` after each segment — the
        checkpoint/resume facility the reference lacks entirely (SURVEY.md §5).
        If the file already exists, the solve RESUMES from it (restart-CG:
        r/p are rebuilt from the checkpointed x, which is mathematically a
        fresh CG warm-started at x — residual-monotone, slightly slower in
        iterations than uninterrupted CG, robust to any interruption).
        """
        m = self.model.m
        self._prepare(m)
        b_dev = self.model.prepare_x(b)
        it_base = 0
        # Checkpoints are keyed to the (matrix, b, tol) problem: a stale file
        # from a DIFFERENT problem must not silently warm-start this one
        # (advisor finding, round 1).
        fp = _problem_fingerprint(m, b, tol)
        if checkpoint_path and os.path.exists(checkpoint_path):
            z = np.load(checkpoint_path)
            if "fingerprint" in z and str(z["fingerprint"]) == fp:
                x0 = z["x"]
                it_base = int(z["iterations"])
                log.info("CG: resuming from %s (iteration %d)",
                         checkpoint_path, it_base)
            else:
                log.warning("CG: checkpoint %s belongs to a different "
                            "problem (or predates fingerprints); ignoring",
                            checkpoint_path)
        x_dev = (self.model.prepare_x(x0) if x0 is not None
                 else jnp.zeros_like(b_dev))
        minv = self._minv if self._minv is not None else jnp.ones_like(b_dev)
        n = m.n_rows
        acc_dt = jnp.promote_types(jnp.dtype(self.model.config.dtype),
                                   jnp.float32)
        tol2 = jnp.asarray(tol * tol * _norm2_host(b), dtype=acc_dt)
        operands = self.model.device_operands()

        seg = checkpoint_every or max_iters
        it_total = it_base
        res2 = jnp.asarray(0.0, acc_dt)
        ran = False
        while it_total < max_iters:
            ran = True
            budget = min(seg, max_iters - it_total)
            # budget is a TRACED scalar: one compile serves every segment
            # length and checkpoint cadence (the reference never recompiles
            # its loop either, spmv.cu:100-116).
            x_dev, it_seg, res2 = self._solve_jit(
                operands, x_dev, b_dev, minv, tol2, jnp.int32(budget), n)
            it_total += int(it_seg)
            if checkpoint_path:
                tmp = checkpoint_path + ".tmp"
                with open(tmp, "wb") as fh:   # write-then-rename: atomic
                    np.savez(fh, x=self.model.recover_y(x_dev),
                             iterations=it_total, fingerprint=fp)
                os.replace(tmp, checkpoint_path)
            if int(it_seg) < budget:
                break
        if not ran:
            # resume already at/over budget (loop body never entered): report
            # the true residual of the checkpointed x instead of a fabricated
            # zero.  When the loop DID run, res2 from the final segment is
            # already the true residual — recomputing it would pay an extra
            # matvec for nothing (advisor finding r2).
            _, _, res2 = self._solve_jit(operands, x_dev, b_dev, minv, tol2,
                                         jnp.int32(0), n)

        x_host = self.model.recover_y(x_dev)
        res = float(np.sqrt(res2))
        converged = res <= tol * max(np.linalg.norm(b), 1e-300)
        if converged and checkpoint_path and os.path.exists(checkpoint_path):
            os.remove(checkpoint_path)  # done: nothing to resume
        log.info("CG: %d iterations, residual %.3e (%s)", it_total, res,
                 "converged" if converged else "NOT converged")
        return CgResult(x=x_host, iterations=it_total, residual_norm=res,
                        converged=converged)

    @partial(jax.jit, static_argnums=(0, 7))
    def _solve_jit(self, operands, x, b, minv, tol2, max_iters, n):
        def matvec(v):
            return _resize_like(self.model.apply_operands(operands, v), v)

        # Reductions in the widest dtype the config provides (hard-casting to
        # f32 would cap f64 solves at ~1e-7 residuals).
        acc_dt = jnp.promote_types(x.dtype, jnp.float32)

        def dot(u, v):
            # padded tails are zero by construction
            return jnp.sum(u[:n].astype(acc_dt) * v[:n].astype(acc_dt))

        r = b - matvec(x)
        z = minv * r
        p = z
        rz = dot(r, z)

        def cond(state):
            _, r, _, _, rz, k = state
            return jnp.logical_and(k < max_iters, dot(r, r) > tol2)

        def body(state):
            x, r, z, p, rz, k = state
            ap = matvec(p)
            alpha = rz / jnp.maximum(dot(p, ap), 1e-30)
            x = x + alpha * p                      # axpy (kernelMyxpy analog)
            r = r - alpha * ap
            z = minv * r
            rz_new = dot(r, z)
            beta = rz_new / jnp.maximum(rz, 1e-30)
            p = z + beta * p
            return x, r, z, p, rz_new, k + 1

        x, r, z, p, rz, k = jax.lax.while_loop(
            cond, body, (x, r, z, p, rz, jnp.int32(0)))
        return x, k, dot(r, r)


def _problem_fingerprint(m: MatrixCOO, b: np.ndarray, tol: float) -> str:
    """Stable id of the (matrix, rhs, tolerance) problem a checkpoint solves."""
    import hashlib

    h = hashlib.sha1()
    h.update(np.int64([m.n_rows, m.n_cols, m.nnz, len(b)]).tobytes())
    h.update(np.ascontiguousarray(m.row[:4096], dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(m.val[:4096], dtype=np.float64).tobytes())
    h.update(np.ascontiguousarray(b[:4096], dtype=np.float64).tobytes())
    h.update(np.float64(tol).tobytes())
    return h.hexdigest()[:16]


def _norm2_host(b: np.ndarray) -> float:
    v = float(np.linalg.norm(np.asarray(b, dtype=np.float64)))
    return v * v


class PowerIteration:
    """Dominant-eigenvalue power iteration — a second end-to-end consumer of
    the SpMV apply (and the long-horizon numerical-stability test the single
    SpMV cannot provide)."""

    def __init__(self, model: SpmvModel):
        self.model = model

    def run(self, iters: int = 50, seed: int = 0):
        m = self.model.m
        rng = np.random.default_rng(seed)
        v = rng.standard_normal(m.n_rows)
        v /= np.linalg.norm(v)
        v_dev = self.model.prepare_x(v)
        v_fin, lam = self._run_jit(self.model.device_operands(), v_dev, iters,
                                   m.n_rows)
        return self.model.recover_y(v_fin), float(lam)

    @partial(jax.jit, static_argnums=(0, 3, 4))
    def _run_jit(self, operands, v, iters, n):
        def body(_, state):
            v, _ = state
            w = _resize_like(self.model.apply_operands(operands, v), v)
            nrm = jnp.sqrt(jnp.sum(w[:n] * w[:n]))
            w = w / jnp.maximum(nrm, 1e-30)
            return w, nrm

        return jax.lax.fori_loop(0, iters, body,
                                 (v, jnp.asarray(0.0, v.dtype)))
