#!/usr/bin/env python
"""Smoke test of the EHYB SpMV pipeline on one GPU, in one process.

    python chip_smoke.py           # phases 1-4 on one card
    python chip_smoke.py --four    # phase 5 only: the 4-card sharded path

Phases (each prints its wall time; any failure exits non-zero):

1. device check: the first JAX device must be a GPU; prints the card's name
   and power limit (``nvidia-smi``);
2. the flagship (``EhybSpmv``) at real size on four matrices, each checked
   in f32 against the exact-f64 oracle (rel ≤ 1e-5: f32 accumulation in
   another order than the oracle's), with its phase split, setup seconds
   (compile included) and a short-loop GFLOP/s;
3. each kept kernel (the Triton body and ER tail) against its plain XLA
   reference on the same device arrays (rel ≤ 1e-6), with the compiled
   apply's memory analysis;
4. the card-only tests (``pytest -m gpu``) in this process.

The last line of standard output is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

FLAGSHIP_TOL = 1e-5
KERNEL_TOL = 1e-6


def log(*a):
    print(*a, flush=True)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        log(f"== phase {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        log(f"== phase {self.name}: {time.perf_counter() - self.t0:.1f} s"
            + (" FAILED" if exc[0] else ""))
        return False


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAIL: {what}")


def smoke_matrices():
    from ehyb_spmv.io import generate

    return {
        "permuted_poisson_1024": lambda: generate.load_corpus(
            "permuted_poisson_1024"),
        "fem3d_68_audikw_class": lambda: generate.load_corpus(
            "fem3d_68_audikw_class"),
        "random_1m": lambda: generate.load_corpus("random_1m"),
        # 1M-row stencil with 8 dense rows of 100k entries: the long rows
        "dense_rows_1m": lambda: generate.with_dense_rows(
            generate.permuted(generate.poisson2d(1024), seed=5), 8,
            density=0.1, seed=3),
    }


def run_flagship(name, make, card):
    import jax
    import numpy as np

    import ehyb_spmv as ehyb
    from ehyb_spmv.core.coo import deterministic_x, oracle_spmv
    from ehyb_spmv.ops import sell_triton, xla_ops
    from ehyb_spmv.utils.timing import bench_apply, spmv_bytes_model
    from ehyb_spmv.utils.validate import rel_error

    t0 = time.perf_counter()
    m = make()
    log(f"[{name}] {m.n_rows} rows, {m.nnz} nnz, generated in "
        f"{time.perf_counter() - t0:.1f} s")
    x = deterministic_x(m.dimension)
    want = oracle_spmv(m, x)

    t0 = time.perf_counter()
    model = ehyb.EhybSpmv(ehyb.EhybConfig()).setup(m)
    x_dev = model.prepare_x(x)
    y = model.recover_y(jax.block_until_ready(model.apply_jit(x_dev)))
    setup_s = time.perf_counter() - t0
    check(model._kernel == "triton", f"{name}: flagship kernel is "
          f"{model._kernel!r}, not the compiled GPU kernel")
    err = rel_error(y, want)
    st = model.ehyb.stats
    split = {k: st[k] for k in ("nnz_dia", "nnz_ell", "nnz_er", "nnz_long")}
    log(f"[{name}] phase split {split}, ell_steps {st['ell_steps']}, "
        f"waste_ell {st['waste_ell']}")
    log(f"[{name}] setup {setup_s:.1f} s (compile included; "
        f"{ {k: round(v, 1) for k, v in model.setup_seconds.items()} })")
    log(f"[{name}] f32 rel_error vs f64 oracle {err:.3e} (limit "
        f"{FLAGSHIP_TOL:g})")
    check(np.all(np.isfinite(y)) and y.shape == (m.n_rows,),
          f"{name}: output not finite or of the wrong shape")
    check(err <= FLAGSHIP_TOL, f"{name}: rel_error {err:.3e}")
    # iterate() with eps=0 must equal one apply
    y_it = model.recover_y(model.iterate(x_dev, 3))
    check(rel_error(y_it, y) <= KERNEL_TOL, f"{name}: iterate disagrees")

    bm = spmv_bytes_model(st, value_bytes=4, ell_index_bytes=2,
                          dim=m.dimension)
    res = bench_apply(name, lambda n: model.iterate(x_dev, n), nnz=m.nnz,
                      iters=50, warmup=2, bytes_model=bm)
    log(f"[{name}] {res.gflops:.2f} GFLOP/s ({res.seconds / res.iters * 1e6:.1f}"
        f" us/iter, {100 * res.roofline_frac:.1f}% of the {bm / 1e6:.1f} MB "
        f"roofline) on {card}")

    # phase 3 material: each kernel vs its XLA reference, same device arrays
    dev = model.dev
    for label, kern, ref in (
            ("body", sell_triton.ehyb_body_triton, xla_ops.ehyb_body_xla),
            ("er", sell_triton.ehyb_er_triton, xla_ops.ehyb_er_xla)):
        a = np.asarray(jax.jit(kern)(dev, x_dev), dtype=np.float64)
        b = np.asarray(jax.jit(ref)(dev, x_dev), dtype=np.float64)
        n = min(a.shape[0], b.shape[0])
        check(not np.any(a[n:]) and not np.any(b[n:]),
              f"{name}: {label} padding rows nonzero")
        r = rel_error(a[:n], b[:n])
        log(f"[{name}] kernel {label} vs XLA reference rel {r:.3e} "
            f"({n} rows, limit {KERNEL_TOL:g})")
        check(r <= KERNEL_TOL, f"{name}: {label} kernel rel {r:.3e}")
    mem = jax.jit(model.apply_operands).lower(dev, x_dev).compile() \
        .memory_analysis()
    log(f"[{name}] apply memory_analysis: {mem}")
    return y


def run_four(card):
    import jax
    import numpy as np

    import ehyb_spmv as ehyb
    from ehyb_spmv.core.coo import deterministic_x, oracle_spmv
    from ehyb_spmv.io import generate
    from ehyb_spmv.parallel.spmv import AXIS, ShardedEhybSpmv
    from ehyb_spmv.utils.timing import bench_apply
    from ehyb_spmv.utils.validate import rel_error

    devs = jax.devices()
    check(len(devs) == 4, f"--four needs 4 GPUs, found {len(devs)}")
    m = generate.load_corpus("permuted_poisson_1024")
    x = deterministic_x(m.dimension)
    want = oracle_spmv(m, x)
    with Phase("sharded 4-card"):
        # one flat axis: the cards are joined all to all
        mesh = jax.sharding.Mesh(np.array(devs), (AXIS,))
        t0 = time.perf_counter()
        sharded = ShardedEhybSpmv(ehyb.EhybConfig(), mesh=mesh).setup(m)
        y4 = sharded.matvec(x)
        log(f"[sharded] setup+first apply {time.perf_counter() - t0:.1f} s, "
            f"kernel {sharded._kernel}")
        err4 = rel_error(y4, want)
        log(f"[sharded] f32 rel_error vs f64 oracle {err4:.3e}")
        check(err4 <= FLAGSHIP_TOL, f"sharded rel_error {err4:.3e}")
        res = bench_apply("sharded", lambda n: sharded.iterate(
            sharded.prepare_x(x), n), nnz=m.nnz, iters=50, warmup=2)
        log(f"[sharded] {res.gflops:.2f} GFLOP/s on 4x {card}")
    with Phase("one-card flagship for comparison"):
        y1 = ehyb.EhybSpmv(ehyb.EhybConfig()).setup(m).matvec(x)
        d = rel_error(y4, y1)
        log(f"[sharded] vs one-card flagship rel {d:.3e}")
        check(d <= FLAGSHIP_TOL, f"sharded vs flagship rel {d:.3e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card sharded path")
    args = ap.parse_args(argv)

    with Phase("1 device check"):
        import jax

        dev = jax.devices()[0]
        if dev.platform != "gpu":
            print(f"FAIL: no GPU: JAX's first device is {dev.platform!r}",
                  file=sys.stderr)
            return 2
        card = card_line()
        log(f"card: {card}")
        log(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}")
        from ehyb_spmv.utils.compile_cache import enable_compile_cache

        log(f"compile cache: {enable_compile_cache()}")

    if args.four:
        run_four(card)
    else:
        with Phase("2+3 flagship and kernels at real size"):
            for name, make in smoke_matrices().items():
                t0 = time.perf_counter()
                run_flagship(name, make, card)
                log(f"[{name}] done in {time.perf_counter() - t0:.1f} s")
        with Phase("4 card-only tests"):
            import pytest

            rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                              "tests/"])
            check(rc == 0, f"card-only tests exit code {rc}")
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
