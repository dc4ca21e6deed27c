#!/usr/bin/env python
"""Benchmark: full growing-window SLAM solve, device engine vs CPU reference.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

The workload is the GDC-2020-scale synthetic building problem (1000 poses,
720-beam scans, window 1..10 — BASELINE.md ladder top).  The baseline is this
repo's Ceres-parity CPU reference engine (nautilus_tpu/baseline) in float64
with scipy KD-trees and sparse normal equations, since the reference repo
publishes no numbers (BASELINE.md).  value = vs_baseline = CPU wall / device
wall for the identical solve; cost parity between the two engines is checked
and reported (<=1% delta).

Needs a GPU: without one it exits non-zero and prints no record.  An
exception anywhere propagates.  The record names the device (JAX platform,
device kind, count) and the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))


def _provenance(args):
    """Run provenance (ADVICE r4): CPU baselines swing with host load and
    engine changes, so cross-snapshot speedups are only comparable when the
    record says what produced them."""
    prov = {"timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "cpu_csm_pairs": args.cpu_csm_pairs}
    try:
        import platform
        prov["host_cpu"] = platform.processor() or platform.machine()
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    prov["host_cpu"] = line.split(":", 1)[1].strip()
                    break
    except Exception:
        pass
    try:
        prov["loadavg_1m"] = round(os.getloadavg()[0], 1)
    except Exception:
        pass
    try:
        head = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                              cwd=_HERE, capture_output=True, text=True,
                              timeout=10)
        if head.returncode == 0:
            prov["commit"] = head.stdout.strip()
    except Exception:
        pass
    return prov


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=1000)
    ap.add_argument("--beams", type=int, default=720)
    ap.add_argument("--quick", action="store_true",
                    help="150-node variant for smoke testing")
    ap.add_argument("--skip-cpu", action="store_true")
    ap.add_argument("--skip-cpu-hitl", action="store_true",
                    help="skip the (slow) CPU-twin HITL double solve")
    ap.add_argument("--cpu-csm-pairs", type=int, default=4,
                    help="pairs for the CPU scan-match baseline (slow: "
                         "~seconds per pair at reference params)")
    args = ap.parse_args()
    if args.quick:
        args.nodes = 150
    from nautilus_tpu.utils.device import require_gpu
    device = require_gpu()

    from nautilus_tpu.core.luaconf import load_config
    from nautilus_tpu.ingest.synthetic import make_problem
    from nautilus_tpu.solve.solver import Solver
    from nautilus_tpu.baseline import cpu_reference as cpu

    cfg = load_config("config/default_config.lua")
    state, gt = make_problem(num_nodes=args.nodes, world_kind="building",
                             num_beams=args.beams, seed=1,
                             odom_noise_trans=0.02, odom_noise_rot=0.008)
    x0 = state.solution.copy()
    prob_cpu = cpu.CpuProblem.from_device_problem(state.problem)

    # --- Device engine: warm up (compile), then measure steady-state solve.
    # The cold wall includes compile; the warm number is the steady-state
    # operator experience the C++ reference (no per-shape compile) is
    # compared against.  Both are reported.
    solver = Solver(state, cfg)
    t0 = time.perf_counter()
    solver.solve_slam()                      # warm-up; also caches compiles
    device_cold_wall = time.perf_counter() - t0
    state.solution = x0.copy()
    t0 = time.perf_counter()
    solver.solve_slam()
    device_wall = time.perf_counter() - t0
    x_dev = state.solution.copy()

    # --- Scan-match throughput (BASELINE.md tracked metric: pairs/sec).
    # Primary config = the reference matcher's ctor params (solver.cc:56:
    # range 30, trans 2, low_res 0.3, high_res 0.01 — the CSMParams
    # defaults); the 12 m-range config is kept as a secondary number for
    # continuity with round 1.
    from nautilus_tpu.kernels.csm import CSMParams, csm_match_pairs
    pts = state.problem.points
    msk = state.problem.points_mask
    n_pairs = min(64, args.nodes - 1)
    ss = np.arange(n_pairs)
    tt = ss + 1

    def time_csm(params, engine="stage"):
        # Times the PRODUCTION entry point (csm_match_pairs: pair gathers
        # + padding + readback all inside/around one device program — the
        # path auto-LC takes).  Best of 3 warm batches.
        csm_match_pairs(pts, msk, ss, tt, params, engine=engine)  # warm
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            csm_match_pairs(pts, msk, ss, tt, params, engine=engine)
            best = min(best, time.perf_counter() - t0)
        return n_pairs / best

    # Primary metric = the production engine (stage-major gathered, the
    # auto-LC default); the pair-major engine is kept as a secondary
    # number.
    scan_match_pairs_per_s = time_csm(CSMParams())          # reference cfg
    scan_match_pairs_per_s_pm = time_csm(CSMParams(), engine="pair")
    scan_match_pairs_per_s_12m = time_csm(CSMParams(scan_range=12.0))

    # --- CPU scan-match baseline (same algorithm, numpy/BLAS — parity
    # tested in tests/test_cpu_csm.py) on a few pairs, extrapolated.
    if args.skip_cpu or args.cpu_csm_pairs <= 0:
        cpu_pairs_per_s = float("nan")
    else:
        from nautilus_tpu.baseline.cpu_csm import csm_match_batch_cpu
        nb = min(args.cpu_csm_pairs, n_pairs)
        pts_np = np.asarray(pts)
        msk_np = np.asarray(msk)
        t0 = time.perf_counter()
        csm_match_batch_cpu(pts_np[ss[:nb]], msk_np[ss[:nb]],
                            pts_np[tt[:nb]], msk_np[tt[:nb]], CSMParams())
        cpu_pairs_per_s = nb / (time.perf_counter() - t0)

    # --- HITL curation step (the headline gdc workload): one scripted
    # colinearity constraint -> selection + densified odometry + 2 solves.
    from nautilus_tpu.io.checkpoint import save_state  # noqa: F401 (API smoke)
    from nautilus_tpu.solve.hitl import (HitlSlamInputMsg, hitl_callback,
                                         prewarm_hitl)
    hitl_cfg = cfg.replace(hitl_line_width=0.3)
    solver.config = hitl_cfg
    msg = HitlSlamInputMsg.from_points((-19, -15), (19, -15),
                                       (-19, -14.5), (19, -14.5))

    def _restore():
        state.solution = x_dev.copy()
        state.hitl_constraints.clear()
        state.line_poses = state.line_poses[:0]

    # Prewarm compiles the HITL-shaped programs on a throwaway state copy
    # — the product does this in a background thread while waiting for
    # operator input (cli.py), so the operator-visible cold number is the
    # first callback AFTER prewarm.  Uses the DEFAULT prewarm message (not
    # the scripted one) so the measurement covers the real mechanism: the
    # padded factor buckets, not an exact-shape replay.
    hitl_prewarm_wall = prewarm_hitl(solver)
    t0 = time.perf_counter()
    hitl_callback(solver, msg, verbose=False)
    hitl_cold_wall = time.perf_counter() - t0
    _restore()
    t0 = time.perf_counter()
    hitl_callback(solver, msg, verbose=False)
    hitl_wall = time.perf_counter() - t0
    # Restore pre-HITL state for the CPU comparison below.
    _restore()
    solver.config = cfg

    # --- Bag ingest throughput at GDC scale (reference main.cc:46-129 is
    # a rosbag replay; this times the full native-reader -> builder path
    # on a generated 1000-pose, 720-beam, lz4-chunked bag).
    import tempfile
    from nautilus_tpu.ingest import rosbag as _rb
    from nautilus_tpu.ingest.builder import process_bag_file
    from nautilus_tpu.ingest.synthetic import write_synthetic_bag
    with tempfile.TemporaryDirectory() as td:
        bag = os.path.join(td, "gdc_scale.bag")
        n_bag = 1000 if not args.quick else 100
        write_synthetic_bag(bag, num_nodes=n_bag, world_kind="building",
                            num_beams=720, seed=1, substeps=2,
                            odom_noise_trans=0.02, odom_noise_rot=0.008)
        msgs = [(m.topic, m.time, m.msg) for m in _rb.read_bag(bag)]
        _rb.write_bag(bag, msgs, compression="lz4")
        mb = os.path.getsize(bag) / 1e6
        ingest_cfg = cfg.replace(lidar_topic="/scan", odom_topic="/odom",
                                 pose_number=float(n_bag))
        # Best of 2: the first call pays one-time costs (native .so
        # self-build, cold page cache) that are not ingest throughput.
        dt = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            raw = process_bag_file(bag, ingest_cfg, verbose=False)
            dt = min(dt, time.perf_counter() - t0)
        ingest_mb_s = mb / dt
        ingest_msgs_s = len(msgs) / dt
        ingest_nodes = int(raw.points.shape[0])

    # --- CPU reference engine.
    if args.skip_cpu:
        cpu_wall = float("nan")
        x_cpu = x0
    else:
        t0 = time.perf_counter()
        x_cpu, _ = cpu.solve_slam(prob_cpu, x0, cfg)
        cpu_wall = time.perf_counter() - t0

    # --- CPU-twin HITL curation step (same densified-odometry double solve)
    # from the same pre-HITL solution the device engine curated from.
    if args.skip_cpu or args.skip_cpu_hitl:
        cpu_hitl_wall = float("nan")
    else:
        t0 = time.perf_counter()
        cpu.hitl_callback(prob_cpu, x_dev.copy(), hitl_cfg,
                          (msg.line_a_start, msg.line_a_end),
                          (msg.line_b_start, msg.line_b_end))
        cpu_hitl_wall = time.perf_counter() - t0

    # --- Cost parity: evaluate both solutions under the CPU f64 cost at the
    # final window's correspondences.
    w = cfg.get_int("lidar_constraint_amount_max")
    tw, rw = cfg.translation_weight, cfg.rotation_weight

    def f64_cost(x):
        planar, edge = cpu.associate(prob_cpu, x, w, cfg.outlier_threshold)
        return cpu.total_cost(prob_cpu, x, planar, edge, tw, rw)

    cost_dev = f64_cost(x_dev)
    cost_cpu = f64_cost(x_cpu) if not args.skip_cpu else float("nan")
    parity_pct = (abs(cost_dev - cost_cpu) / cost_cpu * 100.0
                  if not args.skip_cpu else float("nan"))

    # --- Map accuracy vs the synthetic world's ground truth (ATE after
    # SE(2) alignment; utils/metrics.py).  Reported alongside speed so a
    # perf win can never hide a quality regression.
    from nautilus_tpu.utils.metrics import ate
    ate_before = ate(np.asarray(x0), gt)["trans_rmse"]
    ate_after = ate(np.asarray(x_dev), gt)["trans_rmse"]
    # The CPU twin's ATE proves any solve-vs-odometry ATE regression is
    # algorithm-inherited (windowed scan alignment tightens local
    # consistency, not global drift), not engine-introduced.
    ate_cpu = (ate(np.asarray(x_cpu), gt)["trans_rmse"]
               if not args.skip_cpu else float("nan"))

    # --- Closed-loop leg: the system's actual map-improvement mechanism
    # (reference SolveAutoLC, solver.cc:676-700, with the stubbed apply
    # path completed): solve -> auto-LC candidate/gate/CSM -> apply
    # accepted relative-pose factors -> re-solve at max window.  The
    # deliverable metric is ate_m_closed < ate_m_odometry.
    from nautilus_tpu.loop_closure.auto_lc import solve_auto_lc
    state.solution = x_dev.copy()
    t0 = time.perf_counter()
    lc_report = solve_auto_lc(solver, apply=True, verbose=False)
    auto_lc_wall = time.perf_counter() - t0
    ate_closed = ate(np.asarray(state.solution), gt)["trans_rmse"]

    speedup = cpu_wall / device_wall if not args.skip_cpu else float("nan")
    record = {
        "metric": "gdc_scale_synth_solve_speedup_vs_cpu_ref",
        "value": round(speedup, 2),
        "unit": "x",
        "vs_baseline": round(speedup, 2),
        "nodes": args.nodes,
        "device": device,
        "device_wall_s": round(device_wall, 4),
        "cpu_wall_s": round(cpu_wall, 2),
        "final_cost_device": round(cost_dev, 4),
        "final_cost_cpu": round(cost_cpu, 4) if cost_cpu == cost_cpu else None,
        "cost_parity_pct": round(parity_pct, 3) if parity_pct == parity_pct else None,
        "ate_m_odometry": round(ate_before, 4),
        "ate_m_solved": round(ate_after, 4),
        "ate_m_solved_cpu": (round(ate_cpu, 4)
                             if ate_cpu == ate_cpu else None),
        "ate_m_closed": round(ate_closed, 4),
        "auto_lc_s": round(auto_lc_wall, 2),
        # Per-stage attribution (candidates / gate / csm / resolve and
        # resolve_wait = residual block on the prewarmed re-solve compile
        # that auto_lc overlaps with the CSM stage).
        "auto_lc_stages": {k: round(v, 2)
                           for k, v in lc_report.stage_walls.items()},
        "lc_candidates": len(lc_report.candidates),
        "lc_gated_pairs": len(lc_report.gated_pairs),
        "lc_accepted": len(lc_report.accepted),
        "scan_match_pairs_per_s": round(scan_match_pairs_per_s, 1),
        "scan_match_pairs_per_s_12m": round(scan_match_pairs_per_s_12m, 1),
        "scan_match_pairs_per_s_pair_major": round(scan_match_pairs_per_s_pm,
                                                   1),
        "scan_match_cpu_pairs_per_s": (round(cpu_pairs_per_s, 2)
                                       if cpu_pairs_per_s == cpu_pairs_per_s
                                       else None),
        "scan_match_speedup_vs_cpu": (
            round(scan_match_pairs_per_s / cpu_pairs_per_s, 1)
            if cpu_pairs_per_s == cpu_pairs_per_s else None),
        "hitl_callback_s": round(hitl_wall, 2),
        "hitl_cold_s": round(hitl_cold_wall, 2),
        "hitl_prewarm_s": round(hitl_prewarm_wall, 2),
        "device_cold_wall_s": round(device_cold_wall, 2),
        "cpu_hitl_s": (round(cpu_hitl_wall, 2)
                       if cpu_hitl_wall == cpu_hitl_wall else None),
        "hitl_speedup_vs_cpu": (round(cpu_hitl_wall / hitl_wall, 2)
                                if cpu_hitl_wall == cpu_hitl_wall else None),
        "ingest_mb_s": round(ingest_mb_s, 1),
        "ingest_msgs_s": round(ingest_msgs_s, 0),
        "ingest_nodes": ingest_nodes,
        "provenance": _provenance(args),
    }
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
