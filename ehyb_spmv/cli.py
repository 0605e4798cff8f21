"""Command-line driver — the analog of the reference's ``main``
(``solver_test.c:267-408``) and its getopt flags (``solver_test.c:280-317``).

Reference CLI:  ``./spmvAlg1.out -m audikw_1 -i 2000``  (reads ``./read/<m>.mtx``)
This CLI:       ``python -m ehyb_spmv -m audikw_1 -i 2000 [--read-dir ./read]``
plus matrix generators (``-g fem3d_32``), model selection, window size, dtype,
partitioner backend, and platform pinning.  Flags the reference parses but
ignores (``-t`` threads, ``-p``/``-f`` precond/fact vestiges, SURVEY.md §2 "CLI")
are intentionally not reproduced.

Run flow mirrors the reference end-to-end pipeline (SURVEY.md §3.1):
read/generate → setup (plan/partition/reorder/convert/upload) → warm-up →
timed iterations → validate vs exact-f64 host oracle → report GFLOP/s.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ehyb_spmv",
        description="EHYB SpMV benchmark/driver")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("-m", "--matrix", metavar="NAME",
                     help="matrix name: reads <read-dir>/<NAME>.mtx "
                          "(reference -m flag, solver_test.c:284)")
    src.add_argument("-g", "--generate", metavar="CORPUS",
                     help="generate a synthetic matrix from the named corpus "
                          "entry (see io/generate.py CORPUS)")
    p.add_argument("--read-dir", default="./read",
                   help="directory with .mtx files (default ./read)")
    p.add_argument("-i", "--iters", type=int, default=2000,
                   help="timed SpMV iterations (reference -i, default 2000)")
    p.add_argument("--warmup", type=int, default=10,
                   help="warm-up iterations (reference hardcodes 10, spmv.cu:100)")
    p.add_argument("--model", default="ehyb",
                   help="SpMV model: ehyb | ehyb_xla | hyb | csr | bcoo")
    p.add_argument("--window", type=int, default=None,
                   help="x-window rows (multiple of 1024); default planner-chosen")
    p.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    p.add_argument("--partitioner", default="auto",
                   choices=["auto", "native", "blocks"])
    p.add_argument("--no-reorder", action="store_true",
                   help="disable partition+reorder (RODR=off)")
    p.add_argument("--no-sort", action="store_true",
                   help="disable in-partition density sort")
    p.add_argument("--no-dia", action="store_true",
                   help="disable the gather-free DIA diagonal body")
    p.add_argument("--layout", default=None,
                   choices=["sell", "sell_cs", "sell_mw", "sell_rx"],
                   help="force a SELL body layout (default: model-chosen, "
                        "with relax_body auto-switching mw→rx)")
    p.add_argument("--no-relax", action="store_true",
                   help="disable the relaxed-layout (sell_rx) auto-switch")
    p.add_argument("--windows-per-subtile", type=int, default=None,
                   choices=[2, 4],
                   help="relaxed-layout windows per 8-step sub-tile (2 dual, "
                        "4 quad; default: auto-arbitrated)")
    p.add_argument("--dword", action="store_true",
                   help="double-word (f32x2) value precision — the f64 "
                        "contract in f32 arithmetic (ops/dword.py)")
    p.add_argument("--tol", type=float, default=0.01,
                   help="validation relative tolerance (reference: 1%%)")
    p.add_argument("--cache", action="store_true",
                   help="cache converted EHYB artifacts to disk")
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                   help="pin the JAX platform (gpu fails without a GPU)")
    p.add_argument("--json", action="store_true",
                   help="emit a single JSON result line")
    p.add_argument("--profile", action="store_true",
                   help="print the per-phase roofline audit; with --trace-dir "
                        "also capture a jax.profiler trace")
    p.add_argument("--trace-dir", default=None,
                   help="directory for the jax.profiler trace (Perfetto/"
                        "TensorBoard)")
    p.add_argument("--list-corpus", action="store_true",
                   help="list generator corpus names and exit")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
        try:
            platform = jax.devices()[0].platform
        except RuntimeError as exc:
            platform = f"none ({exc})"
        if platform != args.platform:
            print(f"error: platform {args.platform!r} unavailable: JAX "
                  f"runs on {platform}", file=sys.stderr)
            return 2
    if args.platform == "gpu" or not args.platform:
        from ehyb_spmv.utils.compile_cache import enable_compile_cache

        enable_compile_cache()

    import ehyb_spmv as ehyb
    from ehyb_spmv.config import EhybConfig, Features
    from ehyb_spmv.core.coo import deterministic_x, oracle_spmv
    from ehyb_spmv.io import generate, read_mtx
    from ehyb_spmv.utils.timing import bench_apply, spmv_bytes_model
    from ehyb_spmv.utils.validate import compare, rel_error

    if args.list_corpus:
        for name in generate.CORPUS:
            print(name)
        return 0

    # --- load or generate the matrix (role of matrixRead_*, solver_test.c) ---
    if args.matrix:
        if os.path.isfile(args.matrix):      # explicit path accepted too
            path = args.matrix
        else:
            path = os.path.join(args.read_dir, f"{args.matrix}.mtx")
            if not os.path.exists(path) and os.path.exists(path + ".gz"):
                path += ".gz"
        if not os.path.exists(path):
            print(f"error: {path} not found", file=sys.stderr)
            return 2
        m = read_mtx(path)
        name = args.matrix
    else:
        if args.generate not in generate.CORPUS:
            print(f"error: unknown corpus entry {args.generate!r} "
                  f"(use --list-corpus)", file=sys.stderr)
            return 2
        m = generate.load_corpus(args.generate)
        name = args.generate
    print(f"matrix {name}: {m.n_rows}x{m.n_cols}, nnz={m.nnz}, "
          f"maxCol={m.max_col()}")

    cfg = EhybConfig(
        dtype=args.dtype,
        window_rows=args.window,
        partitioner=args.partitioner,
        artifact_cache=args.cache,
        relax_body="never" if args.no_relax else "auto",
        dword_values=bool(args.dword),
        features=Features(reorder=not args.no_reorder,
                          sort_rows=not args.no_sort,
                          dia=not args.no_dia),
    )
    if args.layout:
        import dataclasses as _dc

        cfg = _dc.replace(cfg, body_layout=args.layout)
    if args.windows_per_subtile:
        import dataclasses as _dc

        cfg = _dc.replace(cfg, windows_per_subtile=args.windows_per_subtile)
    if args.model not in ehyb.MODELS:
        print(f"error: unknown model {args.model!r}", file=sys.stderr)
        return 2
    model = ehyb.MODELS[args.model](cfg).setup(m)

    # --- validate vs exact-f64 oracle (solver_test.c:389) ---
    x = deterministic_x(m.dimension)
    want = oracle_spmv(m, x)
    got = model.matvec(x)
    err = rel_error(got, want)
    cmp_res = compare(got, want, tol=args.tol,
                      atol=1e-6 * float(np.max(np.abs(want), initial=0.0)))
    print(f"validation: rel_error={err:.3e}, "
          f"{cmp_res.n_violations}/{cmp_res.n} violations at "
          f"{100*args.tol:.1f}% tol → {'PASS' if cmp_res.ok else 'FAIL'}")

    # --- timed loop (spmv.cu:100-122 protocol) ---
    x_dev = model.prepare_x(x)
    stats = getattr(model, "ehyb", None)
    # model.config is authoritative (the flagship swaps in int16 columns).
    mcfg = model.config
    if stats is not None:
        bm = spmv_bytes_model(
            stats.stats, dim=m.dimension,
            value_bytes=np.dtype(mcfg.dtype).itemsize,
            ell_index_bytes=np.dtype(mcfg.index_dtype).itemsize)
    else:
        bm = m.nnz * 8 + 2 * m.dimension * 4
    res = bench_apply(f"{args.model}:{name}",
                      lambda n: model.iterate(x_dev, n),
                      nnz=m.nnz, iters=args.iters, warmup=args.warmup,
                      bytes_model=bm)
    print(res)

    if args.profile:
        from ehyb_spmv.utils.profiling import roofline_report, trace

        if stats is not None:
            vb = np.dtype(mcfg.dtype).itemsize
            ib = np.dtype(mcfg.index_dtype).itemsize
            print(roofline_report(stats.stats, value_bytes=vb, index_bytes=ib,
                                  result=res, dim=m.dimension))
        if args.trace_dir:
            import jax

            with trace(args.trace_dir):
                jax.block_until_ready(model.iterate(x_dev, 20))

    if args.json:
        print(json.dumps({
            "matrix": name, "model": args.model, "nnz": m.nnz,
            "dim": m.dimension, "iters": res.iters,
            "seconds": res.seconds, "gflops": res.gflops,
            "gnnz_per_sec": res.nnz_per_sec / 1e9,
            "roofline_frac": res.roofline_frac,
            "device": _device_record(),
            "rel_error": err, "valid": cmp_res.ok,
        }))
    return 0 if cmp_res.ok else 1


def _device_record() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


if __name__ == "__main__":
    sys.exit(main())
