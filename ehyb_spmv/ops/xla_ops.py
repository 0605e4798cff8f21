"""Pure-XLA SpMV ops: CSR/COO segment-sum, BCOO baseline, and the EHYB apply.

These are the framework's always-available compute paths:
  * they run on every backend (the CPU path of every model, tests, oracle
    cross-checks);
  * the EHYB XLA path is the semantic reference for the GPU slice kernel
    (``ops/sell_triton.py``) — both consume the same :class:`EhybDevice`;
  * the BCOO path is the in-repo "vendor baseline", playing the role of the
    reference's cuSPARSE comparison paths (``spmvGeneric`` ``spmv.cu:135-281``).

All functions are jit-friendly: static shapes only, scatter/gather via
``segment_sum`` and ``.at[].add``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import LANES
from ..core.ehyb import EhybDevice


# ---------------------------------------------------------------------------
# COO / CSR
# ---------------------------------------------------------------------------

def coo_spmv(row: jax.Array, col: jax.Array, val: jax.Array, x: jax.Array,
             n_rows: int) -> jax.Array:
    """y = A·x from COO triples via segment-sum (rows must be sorted for best
    performance; correctness does not require it)."""
    contrib = val * jnp.take(x, col, axis=0)
    return jax.ops.segment_sum(contrib, row, num_segments=n_rows,
                               indices_are_sorted=True)


def bcoo_spmv_baseline(m_coo, x: jax.Array):
    """``jax.experimental.sparse`` BCOO matvec — the vendor-library baseline
    (role of the cuSPARSE CSR paths, ``spmv.cu:135-281``)."""
    from jax.experimental import sparse as jsparse

    indices = jnp.stack([jnp.asarray(m_coo.row), jnp.asarray(m_coo.col)], axis=1)
    mat = jsparse.BCOO((jnp.asarray(m_coo.val, dtype=x.dtype), indices),
                       shape=(m_coo.n_rows, m_coo.n_cols))
    return mat @ x


# ---------------------------------------------------------------------------
# EHYB apply (XLA path)
# ---------------------------------------------------------------------------

def _step_slice_ids(slice_offset: jax.Array, n_steps: int) -> jax.Array:
    """Map each width-step k to its slice id via the offset prefix sums."""
    steps = jnp.arange(n_steps, dtype=slice_offset.dtype)
    return jnp.searchsorted(slice_offset[1:], steps, side="right")


def ehyb_dia_xla(e: EhybDevice, x_pad: jax.Array,
                 x_base: int = 0) -> jax.Array:
    """DIA body: y[i] = Σ_k dia_val[k, i] · x[i + d_k].

    The diagonal offsets are *static* (pytree aux), so each term is a
    statically-shifted slice of x — a multiply-add with no gather, which XLA
    fuses into one pass over ``dia_val``.  No reference analog (see
    core/ehyb.py).

    ``x_base``: index of logical row 0 inside ``x_pad`` (the sharded body
    passes W for its [halo | local | halo] extended vector).  Returns y of
    length dia_val.shape[1] (= round_up(dim, LANES)), or length 0 when no
    diagonals were extracted.
    """
    offs = e.dia_offsets
    if not offs:
        return jnp.zeros(0, dtype=x_pad.dtype)
    dim_r = e.dia_val.shape[1]
    lo = min(min(offs) + x_base, 0)          # most negative slice start
    hi = max(max(offs) + x_base + dim_r, x_pad.shape[0])
    x_ext = x_pad
    if lo < 0 or hi > x_pad.shape[0]:
        x_ext = jnp.pad(x_pad, (-lo, hi - x_pad.shape[0]))
    y = jnp.zeros(dim_r, dtype=x_pad.dtype)
    for k, d in enumerate(offs):
        start = x_base + d - lo
        y = y + e.dia_val[k].astype(x_pad.dtype) \
            * jax.lax.slice(x_ext, (start,), (start + dim_r,))
    return y


def body_gather_index(e: EhybDevice) -> jax.Array:
    """Global x index per SELL-body cell (decodes plain window-local and
    relaxed lo-slot layouts) — shared by the XLA body and the double-word
    precision path."""
    if e.rx_body:
        # Relaxed lo-slot layout (sell_rx): ell_col packs
        # (sel << 10) | (hi << 7) | lo; (sel, hi) at lane j describe LO-SLOT j,
        # lo is the entry's own low column bits.  The gathered element of the
        # entry at lane l is  win_{sel(lo_l)}[hi(lo_l)*128 + lo_l]  — exactly
        # what a two-stage (slot, then lane) gather computes.
        idx = e.ell_col.astype(jnp.int32)
        lo = idx & 127
        slot_attr = jnp.take_along_axis(idx, lo, axis=1)
        sel = slot_attr >> 10            # 1 bit (dual) or 2 bits (quad)
        hi = (slot_attr >> 7) & 7
        base = jnp.where(sel == 1, e.step_win_b[:, None],
                         e.step_win[:, None])
        if e.step_win_c.shape[0]:        # windows_per_subtile = 4
            base = jnp.where(sel == 2, e.step_win_c[:, None], base)
            base = jnp.where(sel == 3, e.step_win_d[:, None], base)
        gidx = base.astype(jnp.int32) + (hi << 7) + lo
    else:
        gidx = e.step_win[:, None].astype(jnp.int32) \
            + e.ell_col.astype(jnp.int32)
    return gidx


def ehyb_body_xla(e: EhybDevice, x_pad: jax.Array) -> jax.Array:
    """SELL body: y[s*128+lane] = Σ_k ell_val[k,lane]·x[win(s)+ell_col[k,lane]].

    Semantic reference for phase 1 of the slice kernel
    (``kernelCachedBlockedELL`` ``kernel.cu:150-168``)."""
    n_steps, C = e.ell_val.shape
    n_slices = e.slice_win_start.shape[0]
    if n_steps == 0 or e.body_nnz == 0:
        return jnp.zeros(n_slices * C, dtype=x_pad.dtype)
    step_slice = _step_slice_ids(e.slice_offset, n_steps)
    gidx = body_gather_index(e)
    contrib = e.ell_val.astype(x_pad.dtype) * jnp.take(x_pad, gidx, axis=0)
    y2 = jax.ops.segment_sum(contrib, step_slice, num_segments=n_slices,
                             indices_are_sorted=True)
    return y2.reshape(-1)  # (n_slices * C,)


def ehyb_er_xla(e: EhybDevice, x_pad: jax.Array) -> jax.Array:
    """ER tail: packed yER (density-sorted row order, global columns) — phase 2
    of the slice kernel (``kernel.cu:169-194``)."""
    n_steps, C = e.er_val.shape
    n_slices = max(e.er_slice_offset.shape[0] - 1, 0)
    if n_steps == 0 or n_slices == 0:
        return jnp.zeros(0, dtype=x_pad.dtype)
    step_slice = _step_slice_ids(e.er_slice_offset, n_steps)
    contrib = e.er_val.astype(x_pad.dtype) * jnp.take(x_pad, e.er_col, axis=0)
    y2 = jax.ops.segment_sum(contrib, step_slice, num_segments=n_slices,
                             indices_are_sorted=True)
    return y2.reshape(-1)  # (n_er_slices * C,)


def ehyb_long_xla(e: EhybDevice, x_pad: jax.Array) -> jax.Array:
    """Long-row partial sums (one scalar per long row) — role of
    ``longRowKernel`` (``kernel.cu:43-67``) without atomics: a segment
    reduction over the (col, val) stream."""
    n_long = e.long_rows.shape[0]
    if n_long == 0 or e.long_col.shape[0] == 0:
        return jnp.zeros(0, dtype=x_pad.dtype)
    contrib = e.long_val.astype(x_pad.dtype) * jnp.take(x_pad, e.long_col, axis=0)
    return jax.ops.segment_sum(contrib, e.long_seg, num_segments=n_long,
                               indices_are_sorted=True)


def combine_ehyb(e: EhybDevice, y_body: jax.Array, y_er: jax.Array,
                 y_long: jax.Array, y_dia: jax.Array = None) -> jax.Array:
    """Assemble the final (reordered, padded) y from the three phases.

    Scatter-back of the packed ER result is the role of ``vecReorderER``
    (``kernel.cu:69-77``); long-row adds are the ``atomicAdd`` aggregation at
    ``kernel.cu:64-66``.  Unlike the reference — which relies on phase 1 zeroing
    rows beyond the cache window (``kernel.cu:139-140``, see SURVEY.md quirks) —
    y is built explicitly from zeros, so the += semantics are always sound.
    """
    ny = y_body.shape[0] + LANES  # slack so the dump row `dim` is in range
    y = jnp.zeros(ny, dtype=y_body.dtype)
    y = y.at[: y_body.shape[0]].set(y_body)
    if e.split_src.shape[0]:
        # hub-row splitting (sell_rx): overflow rows fold into their true
        # rows, then are zeroed so the padded tail stays clean
        y = y.at[e.split_dst].add(y_body[e.split_src])
        y = y.at[e.split_src].set(0.0)
    if y_dia is not None and y_dia.shape[0]:
        n = min(y_dia.shape[0], ny)
        y = y.at[:n].add(y_dia[:n])
    if y_er.shape[0]:
        y = y.at[e.er_rows].add(y_er, indices_are_sorted=False,
                                unique_indices=False)
    if y_long.shape[0]:
        y = y.at[e.long_rows].add(y_long)
    return y


def ehyb_apply_xla(e: EhybDevice, x_pad: jax.Array) -> jax.Array:
    """Full EHYB SpMV (XLA path): returns padded reordered y; caller slices
    ``[:dim]``.  Role of ``matrixVectorEHYB`` (``kernel.cu:490-518``)."""
    y_body = ehyb_body_xla(e, x_pad)
    y_er = ehyb_er_xla(e, x_pad)
    y_long = ehyb_long_xla(e, x_pad)
    y_dia = ehyb_dia_xla(e, x_pad)
    return combine_ehyb(e, y_body, y_er, y_long, y_dia)
