"""Profiling + roofline audit — the observability subsystem.

The reference's tracing is two ``gettimeofday`` pairs and printfs
(``reordering.c:276-298``, ``spmv.cu:94-122``; SURVEY.md §5 flags the gap and
asks for ``jax.profiler`` traces and a bytes-moved roofline audit as
first-class outputs).  This module provides:

  * :func:`trace` — context manager capturing a ``jax.profiler`` trace
    (viewable in TensorBoard / Perfetto) around a region;
  * :func:`roofline_report` — per-phase bytes/flops model for an
    :class:`~..core.ehyb.EhybMatrix` plus the achieved fraction from a
    measured :class:`~.timing.BenchResult`;
  * :func:`phase_breakdown` — times each EHYB phase (DIA / SELL body / ER /
    long / combine) separately on device, the analog of nvprof per-kernel
    times the reference never had.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

from .log import get_logger
from .timing import BenchResult, peak_mem_bw

log = get_logger(__name__)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace of the enclosed region into ``logdir``."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        log.info("profiler trace written to %s", logdir)


@dataclasses.dataclass
class PhaseModel:
    name: str
    flops: int
    bytes: int

    @property
    def intensity(self) -> float:
        return self.flops / max(self.bytes, 1)


def roofline_report(stats: Dict, value_bytes: int = 4,
                    index_bytes: int = 2,
                    result: Optional[BenchResult] = None,
                    dim: int = 0) -> str:
    """Per-phase bytes/flops roofline model from converter stats.

    DIA streams values only; the SELL body streams values + window-local
    columns (padding included — zeros move bytes too); ER/long stream values +
    int32 global columns; ``dim`` adds the x read + y write vector traffic
    (same byte model as :func:`~.timing.spmv_bytes_model`).
    """
    phases = [
        PhaseModel("x/y vectors", 0, 2 * dim * value_bytes),
        PhaseModel("dia", 2 * stats.get("nnz_dia", 0),
                   (stats.get("nnz_dia", 0) + stats.get("waste_dia", 0))
                   * value_bytes),
        PhaseModel("sell_body", 2 * stats.get("nnz_ell", 0),
                   (stats.get("nnz_ell", 0) + stats.get("waste_ell", 0))
                   * (value_bytes + index_bytes)),
        PhaseModel("er", 2 * stats.get("nnz_er", 0),
                   (stats.get("nnz_er", 0) + stats.get("waste_er", 0))
                   * (value_bytes + 4)),
        PhaseModel("long", 2 * stats.get("nnz_long", 0),
                   stats.get("nnz_long", 0) * (value_bytes + 4)),
    ]
    bw = peak_mem_bw()
    lines = ["roofline audit (" + ("device peak not measured" if bw is None
                                   else f"peak {bw/1e12:.2f} TB/s") + "):"]
    total_b = sum(p.bytes for p in phases)
    for p in phases:
        if p.flops == 0 and p.bytes == 0:
            continue
        floor = "" if bw is None else \
            f" → ≥{p.bytes / bw * 1e6:8.1f} us/iter memory-bound"
        lines.append(
            f"  {p.name:10s} {p.flops/1e6:9.1f} Mflop {p.bytes/1e6:9.1f} MB "
            f"(AI {p.intensity:.2f}){floor}")
    lines.append(f"  total bytes/iter: {total_b/1e6:.1f} MB" + (
        "" if bw is None else f" → floor {total_b/bw*1e6:.1f} us/iter"))
    if result is not None and result.roofline_frac is not None:
        lines.append(f"  measured: {result.seconds/result.iters*1e6:.1f} us/iter "
                     f"→ {100*result.roofline_frac:.1f}% of the roofline")
    return "\n".join(lines)


def phase_breakdown(model, x_dev, iters: int = 100) -> Dict[str, float]:
    """Per-phase device seconds for one EHYB model apply.

    Times each phase in isolation through a device-side loop (dispatch cost
    subtracted), like the reference would have needed nvprof for.
    Returns {phase: seconds_per_iter}.
    """
    import jax
    import jax.numpy as jnp
    from ..ops import xla_ops

    dev = model.dev
    phases = {
        "dia": lambda x: xla_ops.ehyb_dia_xla(dev, x),
        "er": lambda x: xla_ops.ehyb_er_xla(dev, x),
        "long": lambda x: xla_ops.ehyb_long_xla(dev, x),
        "full_apply": lambda x: model.apply_operands(
            model.device_operands(), x),
    }
    out = {}
    for name, fn in phases.items():
        @jax.jit
        def run(n, x):
            eps = jnp.asarray(0.0, x.dtype)

            def step(_, c):
                y = fn(x + eps * c)
                return jnp.sum(y) if y.shape[0] else c
            return jax.lax.fori_loop(0, n, step, jnp.asarray(0.0, x.dtype))

        try:
            from .timing import measure_loop

            out[name] = measure_loop(
                lambda n: run(jnp.asarray(n, jnp.int32), x_dev), iters)
        except Exception as exc:  # pragma: no cover
            log.warning("phase %s failed: %s", name, exc)
            out[name] = float("nan")
    return out
