#!/usr/bin/env python
"""Multi-device scaling sanity on the virtual CPU mesh.

Validates the DISTRIBUTED MECHANISM — row sharding, ring ppermute halos,
compressed all_to_all ER tail, sharded DIA — and reports per-device-count
timings on an N-virtual-device CPU mesh.  CPU-mesh timings do NOT model
interconnect performance; they show that the SPMD program compiles,
validates, and that per-shard work shrinks with D.  Times on the cards come
from ``chip_smoke.py --four``.

Usage: python scripts/scaling.py [dim_per_dev] [max_devs]
"""
from __future__ import annotations

import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import ehyb_spmv as ehyb
    from ehyb_spmv.config import EhybConfig
    from ehyb_spmv.core.coo import deterministic_x, oracle_spmv
    from ehyb_spmv.io import generate
    from ehyb_spmv.parallel.spmv import AXIS, ShardedEhybSpmv
    from ehyb_spmv.utils.timing import measure_loop
    from ehyb_spmv.utils.validate import rel_error

    rows_per_dev = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    max_devs = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    devs_avail = len(jax.devices())
    print(f"virtual devices: {devs_avail}")

    print(f"{'D':>3} {'dim':>9} {'nnz':>10} {'us/iter':>9} {'rel_err':>9} "
          f"{'weak-eff':>8}")
    t1 = None
    for d in (1, 2, 4, 8):
        if d > min(max_devs, devs_avail):
            break
        # Weak scaling: problem grows with D (same rows/device).
        n = int(np.sqrt(rows_per_dev * d))
        m = generate.permuted(generate.poisson2d(n), seed=5)
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:d]), (AXIS,))
        model = ShardedEhybSpmv(EhybConfig(window_rows=1024),
                                mesh=mesh).setup(m)
        x = deterministic_x(m.dimension)
        err = rel_error(model.matvec(x), oracle_spmv(m, x))
        x_dev = model.prepare_x(x)
        dt = measure_loop(lambda k: model.iterate(x_dev, int(k)), 50)
        if t1 is None:
            t1 = dt
        # Weak-scaling efficiency: per-iter time should stay flat as D and
        # problem size grow together.
        eff = t1 / dt
        print(f"{d:>3} {m.dimension:>9} {m.nnz:>10} {dt*1e6:>9.1f} "
              f"{err:>9.2e} {100*eff:>7.1f}%")
        assert err < 5e-6, f"validation failed at D={d}"
    print("scaling mechanism OK (CPU mesh; not a device measurement)")


if __name__ == "__main__":
    main()
