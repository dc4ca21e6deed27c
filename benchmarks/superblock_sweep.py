"""Sweep the band solver's superblock size at large N.

The block-tridiagonal factorization + solves run as sequential lax.scans
over K = ceil(N/s) superblocks, so the damped solve scales with scan
DEPTH, not FLOPs — each step's 3s x 3s Cholesky is tiny.  Larger s
trades more parallel work per step for fewer sequential steps.  This
times solve_damped_banded at several s, for the scan and cyclic-reduction
backends (decides band.CR_MIN_NODES).

Run on the GPU: python benchmarks/superblock_sweep.py [--nodes 5000]
(reuses the problem cache of benchmarks/_common.py)
"""
import argparse
import time

import _common

import numpy as np
import jax
import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--beams", type=int, default=360)
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[16, 32, 64, 128])
    ap.add_argument("--methods", nargs="+", default=["scan", "cr"],
                    choices=["scan", "cr"],
                    help="factorization backends to A/B (sequential "
                         "lax.scan vs block cyclic reduction)")
    args = ap.parse_args()

    from nautilus_tpu.solve.solver import Solver
    from nautilus_tpu.solve.factors import assemble_banded_system
    from nautilus_tpu.solve.band import solve_damped_banded

    cfg = _common.default_config()
    state = _common.building_problem(args.nodes, args.beams)

    solver = Solver(state, cfg)
    w = cfg.get_int("lidar_constraint_amount_max")
    x = solver._current_x()
    fixed = solver._fixed_mask()
    graph = solver.build_graph(x, w, "feature", exclude_long_range=True)
    sys_, _ = jax.jit(
        lambda xx: assemble_banded_system(xx, graph, solver._layout))(x)
    jax.block_until_ready(sys_)
    radius = jnp.asarray(1e4, x.dtype)

    ref = None
    for s in args.sizes:
        for method in args.methods:
            slv = jax.jit(lambda q, s=s, m=method: solve_damped_banded(
                q, fixed, radius, solver.lm_params, superblock=s, method=m))
            out = jax.block_until_ready(slv(sys_))
            best = float("inf")
            for _ in range(5):
                t0 = time.perf_counter()
                jax.block_until_ready(slv(sys_))
                best = min(best, time.perf_counter() - t0)
            dx = np.asarray(out[0])
            if ref is None:
                ref = dx
                err = 0.0
            else:
                err = float(np.max(np.abs(dx - ref)))
            print(f"s={s:4d} {method:>4s}: {best*1e3:7.1f} ms  "
                  f"max|dx - dx_ref| = {err:.2e}")


if __name__ == "__main__":
    main()
