"""A/B: block-Jacobi vs band-preconditioned CG (solve/cg.py) on device.

The CG path only matters when the band solver is ineligible — more
long-range loop closures than the Woodbury cap — so the fixture applies
LR_FACTOR_CAP+ solution-consistent closures.  Reports wall per LM solve
and iterations for both preconditioners, plus final-cost agreement.

Run: python benchmarks/cg_band_precond_bench.py [--nodes 4000] [--lr 400]
"""

import argparse
import time

import _common  # noqa: E402,F401

import numpy as np
import jax


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=4000)
    ap.add_argument("--beams", type=int, default=360)
    ap.add_argument("--lr", type=int, default=400,
                    help="long-range closures (> LR_FACTOR_CAP forces CG)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (for a small rehearsal; "
                         "times from it are not device times)")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from nautilus_tpu.solve.cg import lm_solve_cg
    from nautilus_tpu.solve.solver import Solver

    cfg = _common.default_config()
    state = _common.building_problem(args.nodes, args.beams)
    state.lc_factors.clear()
    rng = np.random.default_rng(0)
    n = state.num_nodes
    for _ in range(args.lr):
        s = int(rng.integers(1, n - 200))
        t = int(s + rng.integers(100, n - s - 1))
        rel = state.solution[t] - state.solution[s]
        state.lc_factors.append((s, t, rel[:2].copy(), float(rel[2]),
                                 2.0, 2.0))

    solver = Solver(state, cfg, linear_solver="cg")
    assert not solver._band_eligible()   # the LC load must force CG/dense
    w = cfg.get_int("lidar_constraint_amount_max")
    x = solver._current_x()
    fixed = solver._fixed_mask()
    graph = solver.build_graph(x, w)
    bg = solver.build_graph(x, w, exclude_long_range=True)

    def bench(name, **kw):
        run = lambda: lm_solve_cg(x, graph, fixed, params=solver.lm_params,
                                  **kw)
        t0 = time.perf_counter()
        res = jax.block_until_ready(run())
        cold = time.perf_counter() - t0
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            res = jax.block_until_ready(run())
            best = min(best, time.perf_counter() - t0)
        print(f"{name:>10s}: warm {best:7.2f} s (cold {cold:7.1f}) "
              f"iters {int(res.iterations)} cost {float(res.cost):.4f}")
        return res

    r_j = bench("jacobi")
    r_b = bench("band", band_graph=bg, layout=solver._layout)
    dc = abs(float(r_b.cost) - float(r_j.cost)) / max(float(r_j.cost), 1e-9)
    print(f"final-cost delta: {dc * 100:.3f}%")


if __name__ == "__main__":
    main()
