#!/usr/bin/env python
"""Headline benchmark on one GPU.

Protocol mirrors the reference's canonical run (``./spmv.out -i 2000 -m
audikw_1``, ``README.md:8-13``; timing loop ``spmv.cu:100-122``): warm-up, then
timed SpMV iterations through a device-side loop, GFLOP/s = 2·nnz·iter/time.
The corpus matrix is a generated audikw_1-class FEM matrix (no SuiteSparse
download in this environment — see ``io/generate.py``).

Each model runs in its own subprocess, one after another, so that a device
fault in one model (a CUDA sticky error) cannot poison the others and only
one JAX process holds the card at a time; the parent never imports JAX.  A
child that finds no GPU exits with :data:`NO_GPU_EXIT` and the parent fails
naming it: a CPU rate is never reported under the benchmark's metric.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "GFLOP/s", "vs_baseline": N,
   "device": {...}}
where vs_baseline is the speedup over the in-repo vendor baseline
(jax.experimental.sparse BCOO — the cuSPARSE analog, ``spmv.cu:135-281``).
Everything else goes to stderr.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys


def log(*a):
    print(*a, file=sys.stderr, flush=True)


RESULT_TAG = "BENCH_RESULT "
#: Exit code of a child whose JAX has no GPU.
NO_GPU_EXIT = 3


def card_record() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    name, limit = (t.strip() for t in out.strip().splitlines()[0].split(","))
    return {"name": name, "power_limit": limit}


def cached_oracle(m, x):
    """f64 oracle y, disk-cached by matrix fingerprint.

    The exact-f64 oracle on an 84M-nnz matrix costs 1-4 min of scipy-free
    segment sums; every sweep child was re-paying it (the sweep's dominant
    cost at scale).  The matrix is already fingerprint-keyed for artifact
    caching — the oracle rides the same key.  x is the deterministic LCG
    vector, part of the protocol, so it needs no key of its own.
    """
    import numpy as np

    from ehyb_spmv.core.cache import DEFAULT_CACHE_DIR, \
        matrix_fingerprint
    from ehyb_spmv.core.coo import oracle_spmv

    path = os.path.join(DEFAULT_CACHE_DIR,
                        f"{matrix_fingerprint(m)}-oracle.npy")
    if os.path.exists(path):
        y = np.load(path)
        if y.shape[0] == m.n_rows:
            log(f"oracle cache hit: {path}")
            return y
    y = oracle_spmv(m, x)
    try:
        os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        tmp = path + f".tmp{os.getpid()}.npy"
        np.save(tmp, y)
        os.replace(tmp, path)
    except OSError as exc:
        log(f"oracle cache write failed: {exc}")
    return y


def run_model(model_name: str, matrix_name: str, iters: int) -> int:
    """Child mode: benchmark one model, print RESULT_TAG + json to stdout."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"[{model_name}] no GPU: JAX's first device is {dev.platform!r}")
        return NO_GPU_EXIT

    import ehyb_spmv as ehyb
    from ehyb_spmv.config import EhybConfig
    from ehyb_spmv.core.coo import deterministic_x
    from ehyb_spmv.io import generate
    from ehyb_spmv.utils.compile_cache import enable_compile_cache
    from ehyb_spmv.utils.timing import bench_apply, spmv_bytes_model
    from ehyb_spmv.utils.validate import rel_error

    enable_compile_cache()
    log(f"[{model_name}] {dev.device_kind} matrix={matrix_name}")
    m = generate.load_corpus(matrix_name)
    x = deterministic_x(m.dimension)
    want = cached_oracle(m, x)

    # EHYB_BENCH_DWORD=1: bench the f64-contract pipeline (spmv.h:46 analog,
    # ops/dword.py) to measure the f32x2 cost ratio on the card.
    dword = os.environ.get("EHYB_BENCH_DWORD", "") not in ("", "0")
    cfg = EhybConfig(artifact_cache=True, dword_values=dword)
    model = ehyb.MODELS[model_name](cfg).setup(m)
    err = rel_error(model.matvec(x), want)
    log(f"[{model_name}] rel_error={err:.3e}{' (dword)' if dword else ''}")
    if err > 1e-4:
        raise RuntimeError(f"{model_name} validation failed: {err}")
    x_dev = model.prepare_x(x)
    e = getattr(model, "ehyb", None)
    if e is not None:
        import numpy as np

        # model.config is authoritative (EhybSpmv swaps in int16 columns).
        vb = np.dtype(model.config.dtype).itemsize
        if dword:
            vb *= 2  # (hi, lo) f32 pair per value stream
        ib = np.dtype(model.config.index_dtype).itemsize
        bm = spmv_bytes_model(e.stats, value_bytes=vb, ell_index_bytes=ib,
                              dim=m.dimension)
    else:
        # COO/BCOO baselines stream 2 int32 indices + an f32 value per nnz.
        bm = m.nnz * 12 + 2 * m.dimension * 4
    res = bench_apply(model_name, lambda n: model.iterate(x_dev, n),
                      nnz=m.nnz, iters=iters, warmup=10, bytes_model=bm)
    setup_s = {k: round(v, 3)
               for k, v in getattr(model, "setup_seconds", {}).items()}
    stats = dict(e.stats) if e is not None else {}
    # The canonical run must exercise the FULL format (the reference's
    # audikw_1 run hits every phase, spmv.cu:62-133): report the phase split
    # so the record shows which kernels the headline actually validated.
    phase_split = {k: stats.get(k, 0) for k in
                   ("ell_steps", "nnz_ell", "nnz_dia", "nnz_er", "nnz_long")}
    phase_split["engine"] = type(model).__name__
    phase_split["kernel"] = getattr(model, "_kernel", "xla")
    log(f"[{model_name}] phase split: {phase_split}")
    print(RESULT_TAG + json.dumps({
        "model": model_name, "gflops": res.gflops, "seconds": res.seconds,
        "rel_error": err, "roofline_gflops": res.roofline_gflops,
        "roofline_frac": res.roofline_frac, "bytes_model": res.bytes_model,
        "nnz": m.nnz, "dword": dword, "setup_seconds": setup_s,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        **phase_split}), flush=True)
    return 0


class NoGpu(RuntimeError):
    pass


def run_child(model_name: str, matrix: str, iters: int, timeout: int = 1500):
    """Parent side: run one model benchmark in a subprocess; None on failure.
    Raises :class:`NoGpu` when the child found no GPU."""
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--run", model_name,
             matrix, str(iters)],
            stdout=subprocess.PIPE, stderr=sys.stderr, timeout=timeout)
    except subprocess.TimeoutExpired:
        log(f"[{model_name}] TIMED OUT after {timeout}s")
        return None
    if proc.returncode == NO_GPU_EXIT:
        raise NoGpu(f"{model_name}: JAX found no GPU")
    out = proc.stdout.decode(errors="replace")
    for line in out.splitlines():
        if line.startswith(RESULT_TAG):
            return json.loads(line[len(RESULT_TAG):])
    log(f"[{model_name}] no result (exit={proc.returncode}); stdout:\n{out[-2000:]}")
    return None


def main() -> int:
    os.environ.setdefault("EHYB_LOG", "INFO")
    if len(sys.argv) > 1 and sys.argv[1] == "--run":
        return run_model(sys.argv[2], sys.argv[3], int(sys.argv[4]))

    # Headline matrix: permuted_poisson_512 exercises the FULL EHYB format —
    # a real SELL gather body (nonzero ell_steps) plus DIA and the ER
    # tail — the way the reference's canonical audikw_1 run hits every phase
    # (spmv.cu:62-133).  fem3d_32 (the round-1/2 headline) converts 100% to
    # DIA, so it validated only the DIA path; it is kept as a logged
    # secondary for cross-round continuity (VERDICT r2 weak #1 / next #4).
    matrix = os.environ.get("EHYB_BENCH_MATRIX", "permuted_poisson_512")
    secondary = os.environ.get("EHYB_BENCH_SECONDARY", "fem3d_32")
    iters = int(os.environ.get("EHYB_BENCH_ITERS", "500"))

    try:
        # The flagship alone decides the metric: no fallback to another
        # engine is ever reported under its name.
        flagship = run_child("ehyb", matrix, iters)
        if not flagship:
            log("flagship failed")
            return 1
        # Vendor baseline (jax BCOO = the cuSPARSE analog).
        baseline = run_child("bcoo", matrix, min(iters, 100))
        second = run_child("ehyb", secondary, iters) if secondary else None
        # Gather-wall tertiary: scattered columns, where the ER tail's
        # hardware gathers carry the work (kernel.cu:169-194).
        gw_matrix = os.environ.get("EHYB_BENCH_GATHER", "random_1m")
        gather = (run_child("ehyb", gw_matrix, min(iters, 100))
                  if gw_matrix else None)
    except NoGpu as exc:
        log(f"bench.py needs a GPU: {exc}")
        return NO_GPU_EXIT

    vs = flagship["gflops"] / baseline["gflops"] if baseline else 0.0
    log(f"flagship[{flagship['model']}@{matrix}] {flagship['gflops']:.2f} "
        f"GFLOP/s (roofline {100*flagship['roofline_frac']:.1f}%"
        f", ell_steps={flagship.get('ell_steps', 0)}, "
        f"nnz_er={flagship.get('nnz_er', 0)}) "
        f"| baseline[{baseline['model'] if baseline else '-'}] "
        f"{baseline['gflops'] if baseline else float('nan'):.2f} → {vs:.2f}x")
    if second:
        log(f"secondary[ehyb@{secondary}] {second['gflops']:.2f} GFLOP/s "
            f"(roofline {100*second['roofline_frac']:.1f}%)")
    tail = {
        "metric": f"spmv_gflops_{matrix}_gpu",
        "value": round(flagship["gflops"], 3),
        "unit": "GFLOP/s",
        "vs_baseline": round(vs, 3),
        "device": {**flagship["device"], **card_record()},
    }
    if gather:
        log(f"gather-wall[ehyb@{gw_matrix}] {gather['gflops']:.2f} GFLOP/s "
            f"nnz_ell={gather.get('nnz_ell', 0)} "
            f"nnz_er={gather.get('nnz_er', 0)}")
        tail["gather_wall"] = {
            "matrix": gw_matrix, "model": "ehyb",
            "gflops": round(gather["gflops"], 3),
            "nnz_ell": gather.get("nnz_ell", 0),
            "nnz_er": gather.get("nnz_er", 0),
        }
    print(json.dumps(tail))
    return 0


if __name__ == "__main__":
    sys.exit(main())
