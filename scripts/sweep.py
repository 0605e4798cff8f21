#!/usr/bin/env python
"""Corpus sweep on one GPU: bench the flagship + baselines per matrix and
write BENCH_SWEEP.md (the framework's analog of the paper's results table —
the reference benches one matrix per run, README.md:8-13).

Each (model, matrix) runs in its own subprocess via ``bench.py --run``, one
after another (one JAX process on the card at a time).
Usage: python scripts/sweep.py [matrix ...]
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from bench import card_record, run_child  # noqa: E402

DEFAULT = ["poisson2d_512", "stencil27_24", "fem3d_32",
           "fem3d_68_audikw_class", "random_16k", "powerlaw_16k",
           "permuted_poisson_512", "permuted_poisson_1024",
           "permuted_poisson_4096", "random_1m", "random_4m",
           "powerlaw_1m"]
MODELS = ["ehyb", "csr", "bcoo"]


def _fmt(r):
    return f"{r['gflops']:.2f}" if r else "FAIL"


def main():
    matrices = sys.argv[1:] or DEFAULT
    iters = int(os.environ.get("EHYB_BENCH_ITERS", "300"))
    rows = []
    for mat in matrices:
        row = {"matrix": mat}
        for model in MODELS:
            # baselines run far slower than the EHYB engine; a short region
            # prices them fine (their column is a magnitude)
            it = iters if model.startswith("ehyb") else min(iters, 12)
            r = run_child(model, mat, it, timeout=2400)
            row[model] = r
            print(f"{mat} {model}: "
                  f"{r['gflops']:.2f} GFLOP/s" if r else f"{mat} {model}: FAIL",
                  flush=True)
        rows.append(row)
        _write(rows, iters)   # incremental: a cut-off sweep still leaves a
        # valid table of the rows measured so far


def _write(rows, iters):
    dev = next((r["ehyb"]["device"] for r in rows if r.get("ehyb")), {})
    card = card_record()
    lines = [
        f"# Benchmark sweep ({dev.get('kind', '?')}, "
        f"{card['power_limit']} power limit, {dev.get('count', 1)} card)",
        "",
        f"Generated by scripts/sweep.py on {time.strftime('%Y-%m-%d %H:%M')}; "
        f"{iters} timed iterations, device-side loop, dispatch cost "
        "subtracted (protocol: spmv.cu:100-122 + utils/timing.py).",
        "",
        "| matrix | nnz | EHYB GFLOP/s | roofline % | CSR (XLA) | "
        "BCOO (vendor) | speedup vs BCOO | setup s |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for row in rows:
        e, c, b = row.get("ehyb"), row.get("csr"), row.get("bcoo")
        if not e:
            lines.append(f"| {row['matrix']} | - | FAIL | | | | | |")
            continue
        vs = f"{e['gflops']/b['gflops']:.0f}x" if b else "-"
        setup = sum(e.get("setup_seconds", {}).values())
        lines.append(
            f"| {row['matrix']} | {e['nnz']:,} | {_fmt(e)} | "
            f"{100*e['roofline_frac']:.0f}% | {_fmt(c)} | {_fmt(b)} | {vs} | "
            f"{setup:.1f} |")
    lines += ["",
              "setup s = artifact-build wall time for the EHYB run in this "
              "sweep (cached when the fingerprinted artifact exists)."]
    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "BENCH_SWEEP.md")
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
