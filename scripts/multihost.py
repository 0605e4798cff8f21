#!/usr/bin/env python
"""Multi-process (multi-host) validation of the distributed EHYB SpMV.

SURVEY §4 prescribes multi-process CPU simulation via ``jax.distributed``:
this script spawns N processes, each initializing against a local
coordinator with ``--xla_force_host_platform_device_count`` virtual CPU
devices, builds one global mesh spanning all processes, and drives
``ShardedEhybSpmv`` end-to-end (partition → reorder → shard-convert →
compressed halo exchange → SPMD apply) with oracle validation.  This is the
protocol a real multi-host GPU cluster run uses — only the backend string and
coordinator address change.

Usage:
  python scripts/multihost.py                 # parent: spawn 2x4 and verify
  python scripts/multihost.py --procs 2 --devs-per-proc 4
  (internal) python scripts/multihost.py --child <i> ...
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(args) -> None:
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={args.devs_per_proc}")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=args.coordinator,
                               num_processes=args.procs,
                               process_id=args.child)
    import numpy as np

    sys.path.insert(0, REPO)
    from ehyb_spmv.config import EhybConfig
    from ehyb_spmv.core.coo import deterministic_x, oracle_spmv
    from ehyb_spmv.io import generate
    from ehyb_spmv.parallel.spmv import AXIS, ShardedEhybSpmv
    from ehyb_spmv.utils.validate import rel_error

    devs = np.array(jax.devices())  # global: procs * devs_per_proc
    assert devs.size == args.procs * args.devs_per_proc, devs
    mesh = jax.sharding.Mesh(devs, (AXIS,))

    m = generate.permuted(generate.poisson2d(64), seed=11)  # scrambled → ER
    model = ShardedEhybSpmv(EhybConfig(window_rows=1024), mesh=mesh).setup(m)
    x = deterministic_x(m.dimension)

    t0 = time.time()
    y = model.matvec(x)
    t1 = time.time()
    err = rel_error(y, oracle_spmv(m, x))
    assert err < 5e-6, f"process {args.child}: rel_error={err}"
    if args.child == 0:
        print(f"MULTIHOST OK: {args.procs} processes x "
              f"{args.devs_per_proc} devices, dim={m.dimension} "
              f"nnz={m.nnz} rel_error={err:.2e} "
              f"first-step {t1 - t0:.1f}s (includes compile)", flush=True)
    jax.distributed.shutdown()


def parent(args) -> int:
    port = 12765 + (os.getpid() % 1000)
    coordinator = f"127.0.0.1:{port}"
    procs = []
    for i in range(args.procs):
        cmd = [sys.executable, os.path.abspath(__file__),
               "--child", str(i), "--procs", str(args.procs),
               "--devs-per-proc", str(args.devs_per_proc),
               "--coordinator", coordinator]
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    rc = 0
    for i, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=args.timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out = f"process {i} TIMED OUT"
            rc = 1
        if p.returncode not in (0, None):
            rc = p.returncode
        tail = "\n".join(out.strip().splitlines()[-4:])
        print(f"--- process {i} (rc={p.returncode}):\n{tail}")
    return rc


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--devs-per-proc", type=int, default=4)
    ap.add_argument("--child", type=int, default=None)
    ap.add_argument("--coordinator", type=str, default="")
    ap.add_argument("--timeout", type=int, default=420)
    args = ap.parse_args()
    if args.child is not None:
        child(args)
        return 0
    return parent(args)


if __name__ == "__main__":
    sys.exit(main())
