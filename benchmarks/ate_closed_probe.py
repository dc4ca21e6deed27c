#!/usr/bin/env python
"""Probe: does the full system (solve -> auto-LC apply -> re-solve) beat raw
odometry in ATE on the bench workload?

Usage: python benchmarks/ate_closed_probe.py [--nodes N] [--cpu] [--noise T R]
"""
import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=400)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--noise", type=float, nargs=2, default=[0.02, 0.008])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--gate", action="store_true",
                    help="use the descriptor pre-gate")
    args = ap.parse_args()
    if args.cpu:
        # Force the CPU backend via the config as well as the env var, in
        # case jax was imported first; ATE needs no device.
        import jax
        jax.config.update("jax_platforms", "cpu")

    from nautilus_tpu.core.luaconf import load_config
    from nautilus_tpu.ingest.synthetic import make_problem
    from nautilus_tpu.solve.solver import Solver
    from nautilus_tpu.utils.metrics import ate
    from nautilus_tpu.loop_closure.auto_lc import solve_auto_lc

    cfg = load_config("config/default_config.lua")
    state, gt = make_problem(num_nodes=args.nodes, world_kind="building",
                             num_beams=720, seed=args.seed,
                             odom_noise_trans=args.noise[0],
                             odom_noise_rot=args.noise[1])
    x0 = state.solution.copy()
    print("ate odom:", ate(np.asarray(x0), gt)["trans_rmse"])

    solver = Solver(state, cfg)
    t0 = time.perf_counter()
    solver.solve_slam()
    print(f"solve: {time.perf_counter() - t0:.1f}s  "
          f"ate solved: {ate(np.asarray(state.solution), gt)['trans_rmse']}")

    t0 = time.perf_counter()
    report = solve_auto_lc(solver, apply=True, verbose=True,
                           use_descriptor_gate=args.gate)
    print(f"auto-LC: {time.perf_counter() - t0:.1f}s  "
          f"accepted={len(report.accepted)} applied={report.applied}")
    print("ate closed:", ate(np.asarray(state.solution), gt)["trans_rmse"])


if __name__ == "__main__":
    main()
