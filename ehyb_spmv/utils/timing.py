"""Benchmark timing + throughput math.

Reproduces the reference's measurement protocol (``spmv.cu:94-122``): warm-up
iterations, then a timed loop of SpMVs, reporting
``GFLOP/s = 1e-9 · (2·nnz) · iter / seconds`` — the exact formula at
``spmv.cu:121-122`` — plus a bytes-moved model and the roofline fraction
against the device's published peak.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import jax

from .log import get_logger

log = get_logger(__name__)

#: Published peak device-memory bandwidth (bytes/s) keyed by
#: ``jax.Device.device_kind``.  Source: NVIDIA H100 Tensor Core GPU data sheet
#: (SXM: 3.35 TB/s HBM3; PCIe: 2.0 TB/s HBM2e).  Rates assume the card's full
#: power limit; report the limit beside any roofline share.
PEAK_MEM_BW = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
}


def peak_mem_bw(device=None) -> Optional[float]:
    """Peak memory bandwidth of ``device`` (default: the first JAX device).

    None on the CPU, whose rate this repository never reports as a device
    roofline ("not measured").  An accelerator missing from
    :data:`PEAK_MEM_BW` is an error, not a default.
    """
    device = device or jax.devices()[0]
    if device.platform == "cpu":
        return None
    try:
        return PEAK_MEM_BW[device.device_kind]
    except KeyError:
        raise KeyError(f"no peak bandwidth on record for device kind "
                       f"{device.device_kind!r}; add it to PEAK_MEM_BW with "
                       f"its source") from None


@dataclasses.dataclass
class BenchResult:
    name: str
    nnz: int
    iters: int
    seconds: float
    gflops: float          # reference formula (spmv.cu:121)
    nnz_per_sec: float
    bytes_model: int       # modeled bytes moved per iteration
    #: None where the device has no peak on record (the CPU): not measured.
    roofline_gflops: Optional[float]
    roofline_frac: Optional[float]

    def __str__(self) -> str:
        roof = ("roofline not measured" if self.roofline_frac is None else
                f"roofline {self.roofline_gflops:.0f} GFLOP/s "
                f"→ {100*self.roofline_frac:.1f}%")
        return (f"[{self.name}] {self.iters} iters in {self.seconds*1e3:.2f} ms → "
                f"{self.gflops:.2f} GFLOP/s ({self.nnz_per_sec/1e9:.2f} Gnnz/s), "
                + roof)


def spmv_bytes_model(stats: dict, value_bytes: int = 4,
                     ell_index_bytes: int = 4, dim: int = 0) -> int:
    """Modeled memory bytes per SpMV iteration: stream values + indices
    (including padding waste), plus one x read and one y write (x re-reads
    through the caches ignored)."""
    ell = (stats.get("nnz_ell", 0) + stats.get("waste_ell", 0))
    er = (stats.get("nnz_er", 0) + stats.get("waste_er", 0))
    lng = stats.get("nnz_long", 0)
    dia = (stats.get("nnz_dia", 0) + stats.get("waste_dia", 0))
    n_bytes = ell * (value_bytes + ell_index_bytes)
    n_bytes += er * (value_bytes + 4)
    n_bytes += lng * (value_bytes + 4)
    n_bytes += dia * value_bytes          # diagonals carry no indices
    n_bytes += 2 * dim * value_bytes
    return int(n_bytes)


def _timed_difference(apply_iters: Callable[[int], "jax.Array"],
                      iters: int) -> float:
    """Seconds of ``iters`` extra device-side iterations: ``half`` and
    ``half + iters`` iterations, each the best of two calls ended by
    ``block_until_ready``, differenced to remove the fixed dispatch and
    launch cost.  Can be ≤ 0 when the region is below the clock's noise."""
    half = max(iters // 2, 1)

    def timed(n: int) -> float:
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            jax.block_until_ready(apply_iters(n))
            best = min(best, time.perf_counter() - t0)
        return best

    return timed(half + iters) - timed(half)


def _measure(apply_iters: Callable[[int], "jax.Array"], iters: int,
             warmup: int) -> tuple:
    """(iterations, seconds) of the timed region: the iteration count grows
    until the region lasts at least 0.2 s, then the best of three is kept."""
    jax.block_until_ready(apply_iters(max(warmup, 1)))
    target = 0.2
    dt = _timed_difference(apply_iters, iters)
    while dt < target and iters < 4_000_000:
        grow = 8 if dt <= 0 else min(64, max(2, int(1.5 * target / dt) + 1))
        iters = min(iters * grow, 4_000_000)
        dt = _timed_difference(apply_iters, iters)
    dt = min(dt, *(_timed_difference(apply_iters, iters) for _ in range(2)))
    if dt <= 0:
        raise RuntimeError(f"timed region of {iters} iterations is below the "
                           "clock's noise")
    return iters, dt


def measure_loop(apply_iters: Callable[[int], "jax.Array"], iters: int,
                 warmup: int = 5) -> float:
    """Seconds per device-side iteration of ``apply_iters(n)``, which runs n
    chained SpMVs in one device ``fori_loop``."""
    n, dt = _measure(apply_iters, iters, warmup)
    return dt / n


def bench_apply(name: str, apply_iters: Callable[[int], jax.Array], nnz: int,
                iters: int = 2000, warmup: int = 10,
                bytes_model: Optional[int] = None) -> BenchResult:
    """Time ``apply_iters(n)`` (a function running n chained SpMVs in a
    device-side loop and returning a device array).

    Protocol mirrors ``spmv.cu:100-119`` (warm-up, then a timed region bounded
    by ``block_until_ready``); the fixed dispatch cost is removed by a
    two-length difference (:func:`_measure`).
    """
    iters, dt = _measure(apply_iters, iters, warmup)
    gflops = 1e-9 * (2.0 * nnz) * iters / dt
    nnz_rate = nnz * iters / dt
    bw = peak_mem_bw()
    bm = bytes_model if bytes_model is not None else nnz * 8
    roofline = frac = None
    if bw is not None and bm:
        roofline = 1e-9 * (2.0 * nnz) * bw / bm
        frac = gflops / roofline
    res = BenchResult(
        name=name, nnz=nnz, iters=iters, seconds=dt, gflops=gflops,
        nnz_per_sec=nnz_rate, bytes_model=bm, roofline_gflops=roofline,
        roofline_frac=frac)
    log.info("%s", res)
    return res
