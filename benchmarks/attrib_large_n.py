"""Attribute the large-N per-iteration cost: assembly vs damped band solve.

A whole-sweep trace aggregates everything into nested while ops, so this
times the two halves of one LM iteration directly at the max window:

  A  assemble_banded_system(x, graph, layout)   (linearize + band accumulate)
  B  solve_damped_banded(sys, fixed, radius)    (gauge + factor + solves)

Run on the GPU: python benchmarks/attrib_large_n.py [--nodes 5000]
"""
import argparse
import sys
import time

import _common

import numpy as np
import jax
import jax.numpy as jnp


def timeit(fn, reps=5):
    fn()  # warm/compile
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--beams", type=int, default=360)
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
    layout = solver._layout
    graph = solver.build_graph(x, w, "feature", exclude_long_range=True)

    asm = jax.jit(lambda xx: assemble_banded_system(xx, graph, layout))
    t0 = time.perf_counter()
    sys_, _cost = jax.block_until_ready(asm(x))
    print(f"assembly compile+run: {time.perf_counter()-t0:.1f}s")
    t_asm = timeit(lambda: asm(x))

    # Moment-form assembly (factors._MOMENTS): same algebra, J never
    # materialized — the HBM-traffic fix for the number above.
    asm_m = jax.jit(lambda xx: assemble_banded_system(
        xx, graph, layout, "moments"))
    t0 = time.perf_counter()
    sys_m, cost_m = jax.block_until_ready(asm_m(x))
    print(f"moments assembly compile+run: {time.perf_counter()-t0:.1f}s")
    t_asm_m = timeit(lambda: asm_m(x))
    import numpy as _np
    drift = float(jnp.max(jnp.abs(sys_m.diag - sys_.diag))
                  / (jnp.max(jnp.abs(sys_.diag)) + 1e-30))
    print(f"assembly: J-form {t_asm*1e3:.1f} ms  moments {t_asm_m*1e3:.1f} ms"
          f"  ({t_asm/t_asm_m:.2f}x)  diag drift {drift:.2e}")

    radius = jnp.asarray(1e4, x.dtype)
    slv = jax.jit(lambda s: solve_damped_banded(s, fixed, radius,
                                                solver.lm_params))
    t0 = time.perf_counter()
    jax.block_until_ready(slv(sys_))
    print(f"damped-solve compile+run: {time.perf_counter()-t0:.1f}s")
    t_slv = timeit(lambda: slv(sys_))

    print(f"N={args.nodes} w={w}: assembly {t_asm*1e3:.1f} ms  "
          f"damped band solve {t_slv*1e3:.1f} ms  "
          f"(iteration ~ assembly + solve; accept path re-assembles)")


if __name__ == "__main__":
    main()
