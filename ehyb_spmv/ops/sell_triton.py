"""SELL slice kernel for the GPU: Pallas through Triton.

One kernel serves both gather phases of the EHYB apply, following the
reference's ``kernelCachedBlockedELL`` (``kernel.cu:150-194``):

  * the SELL body (phase 1): ``ell_col`` holds int16 window-local columns and
    ``step_win`` the x-window start of every width-step, so an entry reads
    ``x[step_win[k] + ell_col[k, lane]]``;
  * the ER tail (phase 2): int32 global columns and window base 0.

One program per 128-row slice walks the slice's width-steps
``slice_offset[s] .. slice_offset[s+1]``: it loads one coalesced row of
columns and values per step, gathers x through the hardware (L1/L2), keeps
the 128 row sums in registers and stores each row once.  No nnz-sized
intermediate and no scatter; the ER scatter-back to true rows stays an XLA
``.at[er_rows].add`` in :func:`~.xla_ops.combine_ehyb` (``vecReorderER``,
``kernel.cu:69-77``).

The XLA formulation in :mod:`.xla_ops` is the reference the tests hold this
kernel to; ``interpret=True`` runs it on the CPU.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core.ehyb import EhybDevice
from .xla_ops import combine_ehyb, ehyb_dia_xla, ehyb_long_xla


def _slice_kernel(*refs, windowed: bool):
    if windowed:
        off_ref, win_ref, col_ref, val_ref, x_ref, y_ref = refs
    else:
        off_ref, col_ref, val_ref, x_ref, y_ref = refs
    s = pl.program_id(0)

    def step(k, acc):
        idx = col_ref[k, :].astype(jnp.int32)
        if windowed:
            idx = idx + win_ref[k]
        return acc + val_ref[k, :].astype(acc.dtype) * x_ref[idx]

    acc = jnp.zeros(y_ref.shape, y_ref.dtype)
    y_ref[...] = jax.lax.fori_loop(off_ref[s], off_ref[s + 1], step, acc)


def sell_slices(slice_offset: jax.Array, step_win, col: jax.Array,
                val: jax.Array, x: jax.Array, *,
                interpret: bool = False) -> jax.Array:
    """Per-slice SELL products: returns ``(n_slices * C,)`` sums in x's dtype.

    ``col``/``val`` are ``(steps, C)`` with C a power of two; ``step_win`` is
    ``(steps,)`` window starts, or None for global columns.  Slice ``s`` owns
    steps ``slice_offset[s] .. slice_offset[s+1]`` (may be empty).
    """
    n_slices = slice_offset.shape[0] - 1
    steps, C = col.shape
    if C & (C - 1):
        raise ValueError(f"slice width {C} is not a power of two")
    if n_slices <= 0:
        return jnp.zeros(0, x.dtype)
    if steps == 0:
        return jnp.zeros(n_slices * C, x.dtype)
    windowed = step_win is not None
    operands = (slice_offset,) + ((step_win,) if windowed else ()) \
        + (col, val, x)
    kernel = lambda *refs: _slice_kernel(*refs, windowed=windowed)  # noqa: E731
    y = pl.pallas_call(
        kernel,
        grid=(n_slices,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * len(operands),
        out_specs=pl.BlockSpec((None, C), lambda s: (s, 0)),
        out_shape=jax.ShapeDtypeStruct((n_slices, C), x.dtype),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="ehyb_sell_slices",
    )(*operands)
    return y.reshape(-1)


def ehyb_body_triton(e: EhybDevice, x_pad: jax.Array, *,
                     interpret: bool = False) -> jax.Array:
    """SELL body (phase 1) — same contract as :func:`.xla_ops.ehyb_body_xla`
    for the ``step_win + ell_col`` layouts (not the relaxed lo-slot one)."""
    if e.rx_body:
        raise ValueError("the GPU kernel decodes step_win + ell_col; the "
                         "relaxed lo-slot layout (sell_rx) is XLA-only")
    n_slices = e.slice_win_start.shape[0]
    C = e.ell_val.shape[1]
    if e.ell_val.shape[0] == 0 or e.body_nnz == 0:
        return jnp.zeros(n_slices * C, dtype=x_pad.dtype)
    return sell_slices(e.slice_offset, e.step_win, e.ell_col, e.ell_val,
                       x_pad, interpret=interpret)


def ehyb_er_triton(e: EhybDevice, x_pad: jax.Array, *,
                   interpret: bool = False) -> jax.Array:
    """ER tail (phase 2) — same contract as :func:`.xla_ops.ehyb_er_xla`."""
    return sell_slices(e.er_slice_offset, None, e.er_col, e.er_val, x_pad,
                       interpret=interpret)


def ehyb_apply_triton(e: EhybDevice, x_pad: jax.Array, *,
                      interpret: bool = False) -> jax.Array:
    """Full EHYB SpMV with the body and ER tail on this kernel; DIA, long
    rows and the combine are XLA.  Same contract as
    :func:`.xla_ops.ehyb_apply_xla`."""
    y_body = ehyb_body_triton(e, x_pad, interpret=interpret)
    y_er = ehyb_er_triton(e, x_pad, interpret=interpret)
    return combine_ehyb(e, y_body, y_er, ehyb_long_xla(e, x_pad),
                        ehyb_dia_xla(e, x_pad))
