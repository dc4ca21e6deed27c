"""A/B the staged fused sweep against the single full-width program.

The staged plan (solver._staged_sweep_plan) runs the early windows
(w_min..w_mid) in a half-width banded program over the delta-major pair
PREFIX, then the late windows (w_mid+1..w_max) in the full-width program.
Assembly cost is ~proportional to the pair count, so the early stage does
~half the linearization work per iteration — at the cost of one extra
program dispatch and (first run only) one extra compile.  Decides
solver.STAGED_FUSED_MIN_N.

Run on the GPU:  python benchmarks/staged_fused_bench.py [--nodes 5000]
Reuses the problem cache of benchmarks/_common.py.
"""
import argparse
import time

import _common


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--beams", type=int, default=360)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--host-loop", action="store_true",
                    help="A/B the HOST window loop (the N>6000 path) "
                         "instead of the fused sweep")
    args = ap.parse_args()

    from nautilus_tpu.solve.solver import Solver

    cfg = _common.default_config()
    state = _common.building_problem(args.nodes, args.beams)

    x0 = state.solution.copy()

    def run(staged, label):
        best = float("inf")
        costs = None
        for rep in range(args.reps + 1):          # rep 0 = warm/compile
            state.solution = x0.copy()
            s = Solver(state, cfg, fused_sweep=not args.host_loop,
                       staged_fused=staged)
            t0 = time.perf_counter()
            st = s.solve_slam()
            wall = time.perf_counter() - t0
            if rep == 0:
                print(f"{label}: cold (compile) {wall:.1f}s")
                plan = s._staged_sweep_plan(
                    cfg.get_int("lidar_constraint_amount_min"),
                    cfg.get_int("lidar_constraint_amount_max"),
                    use_band=True)
                print(f"{label}: plan stages = "
                      f"{[(a, b, lay.w) for a, b, _, _, lay in plan]}")
            else:
                best = min(best, wall)
            costs = [(w.window, w.final_cost) for w in st.windows]
        print(f"{label}: warm best of {args.reps} = {best:.2f}s")
        return best, costs

    t_full, c_full = run(False, "unstaged")
    t_staged, c_staged = run(True, "staged  ")

    drift = max(abs(a[1] - b[1]) / max(abs(a[1]), 1e-9)
                for a, b in zip(c_full, c_staged))
    print(f"\nN={args.nodes}: unstaged {t_full:.2f}s  staged {t_staged:.2f}s  "
          f"({t_full / t_staged:.2f}x)  max per-window final-cost drift "
          f"{drift:.2e}")


if __name__ == "__main__":
    main()
