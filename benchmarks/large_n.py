#!/usr/bin/env python
"""Large-N regime: dense-vs-CG agreement + crossover measurement.

This script runs the full growing-window solve at N in {2000, 3000,
5000} with the dense and CG linear solvers on the device, asserts
final-cost agreement, and records walls so the auto crossover constant
(solver._resolve_solver's dense wall) is data-driven rather than
guessed.

Usage: python benchmarks/large_n.py [--nodes 2000 3000 5000] [--beams 720]
Writes build/LARGE_N.md (gitignored), naming the device.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np


def run_one(nodes, beams, solver_kind, cfg, make_problem, Solver):
    state, _ = make_problem(num_nodes=nodes, world_kind="building",
                            num_beams=beams, seed=1,
                            odom_noise_trans=0.02, odom_noise_rot=0.008)
    x0 = state.solution.copy()
    # Host window loop for BOTH solvers: comparable dispatch structure,
    # and one small compiled program instead of a whole-sweep graph.
    solver = Solver(state, cfg, linear_solver=solver_kind, fused_sweep=False)
    t0 = time.perf_counter()
    solver.solve_slam()                   # compile warm-up
    cold = time.perf_counter() - t0
    state.solution = x0.copy()
    t0 = time.perf_counter()
    stats = solver.solve_slam()
    warm = time.perf_counter() - t0
    return warm, cold, stats.final_cost


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, nargs="+",
                    default=[2000, 3000, 5000])
    ap.add_argument("--beams", type=int, default=720)
    args = ap.parse_args()

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from nautilus_tpu.core.luaconf import load_config
    from nautilus_tpu.ingest.synthetic import make_problem
    from nautilus_tpu.solve.solver import Solver

    cfg = load_config(Path(__file__).resolve().parent.parent
                      / "config/default_config.lua")
    rows = []
    for nodes in args.nodes:
        res = {}
        for kind in ("dense", "cg"):
            try:
                warm, cold, cost = run_one(nodes, args.beams, kind, cfg,
                                           make_problem, Solver)
                res[kind] = (warm, cold, cost)
                print(f"n={nodes:5d} {kind:5s} warm={warm:7.2f}s "
                      f"cold={cold:7.2f}s cost={cost:.2f}", flush=True)
            except Exception as e:  # record OOM/compile failures as data
                res[kind] = None
                print(f"n={nodes:5d} {kind:5s} FAILED: {e}", flush=True)
        d, c = res.get("dense"), res.get("cg")
        agree = (f"{abs(d[2] - c[2]) / max(d[2], 1e-9) * 100:.3f}%"
                 if d and c else "—")
        rows.append((nodes,
                     f"{d[0]:.2f}" if d else "fail",
                     f"{c[0]:.2f}" if c else "fail",
                     f"{d[2]:.2f}" if d else "—",
                     f"{c[2]:.2f}" if c else "—",
                     agree))

    import jax
    out = Path(__file__).resolve().parent.parent / "build" / "LARGE_N.md"
    out.parent.mkdir(exist_ok=True)
    lines = ["# Large-N regime: dense Cholesky vs matrix-free PCG",
             "",
             "Full growing-window solve (windows 1-10, default config, "
             f"{args.beams}-beam scans), {jax.devices()[0].device_kind}, "
             "steady-state walls "
             "(cold/compile excluded; both solvers fully warmed first).",
             "",
             "| poses | dense s | cg s | dense cost | cg cost | delta |",
             "|---|---|---|---|---|---|"]
    for r in rows:
        lines.append("| " + " | ".join(str(v) for v in r) + " |")
    out.write_text("\n".join(lines) + "\n")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
