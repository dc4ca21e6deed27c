#!/usr/bin/env python
"""Smoke run of the curation pipeline on one NVIDIA GPU.

    python chip_smoke.py              # one card, every phase below
    python chip_smoke.py --devices 4  # four cards: the sharded solve only

Phases, in one process (a JAX process reserves most of the card's memory,
so nothing here starts a second one):

- ``device``: require a GPU; print its kind, count, the JAX versions,
  XLA_FLAGS, the compile cache directory and the card's name and power
  limit.  Any other backend exits non-zero before any work.
- ``main_path``: a synthetic building-world bag (1000 poses, 720 beams,
  seed 1, lz4) through ``nautilus_tpu.cli.main`` with auto-LC, two HITL
  colinearity edits, ``--write`` and ``--vectorize``.  Checks the pose and
  map files, at least one accepted closure, and ATE(closed) <
  ATE(odometry) against the synthetic ground truth.
- ``parity``: the same problem through ``Solver.solve_slam`` on the card and
  the f64 CPU twin; final costs under the f64 cost within 1%.
- ``csm``: ``csm_match_pairs`` (both engines, bf16 and f32 coarse operands)
  over 64 consecutive pairs, checked against the CPU twin on 8 of them, plus
  the time of the coarse rotation sweep alone.
- ``device_tests``: the ``device``-marked tests, run in this process.

With ``--devices 4`` only the N=1000 CLI solve runs, sharded over four
cards and on one of them, and the two final costs must agree.

Every phase prints its wall time.  Any failure exits non-zero; on success
the last line is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "build", "chip_smoke")

NODES = 1000
BEAMS = 720
SEED = 1
# Bag writer settings shared with bench.py's ingest workload.
BAG_SUBSTEPS = 2
ODOM_NOISE = dict(odom_noise_trans=0.02, odom_noise_rot=0.008)
# Colinearity edits (ax ay ax2 ay2 bx by bx2 by2) in the building world's
# frame: bench.py's pair on the south wall (the wall and a line 0.5 m inside
# it), and the same form on the east wall.  The map frame starts at the
# first captured node, so edits_in_map_frame moves them there.
HITL_EDITS_WORLD = ((-19, -15, 19, -15, -19, -14.5, 19, -14.5),
                    (20, -14, 20, 14, 19.5, -14, 19.5, 14))
CSM_PAIRS = 64
CSM_CPU_PAIRS = 8
# tests/test_cpu_csm.py tolerances.  They assume the coarse stage may round
# operands to bf16 (the default) and that every f32 product of the fine
# stages runs at Precision.HIGHEST; the fine stages set the transform.
CSM_TRANSFORM_ATOL = 2e-2
CSM_SCORE_ATOL = 2e-3
# Final-cost parity with the f64 CPU twin (the project's north-star bound).
# The device solve is f32 with every pose-arithmetic product pinned to
# Precision.HIGHEST; no global precision override is set.
PARITY_RTOL = 0.01
SHARDED_RTOL = 1e-3
PREWARM_WARNING = "auto-LC re-solve prewarm failed"


class PhaseFailed(RuntimeError):
    pass


def finding(phase, key, value):
    print(f"  {phase}.{key} = {value}", flush=True)


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


@contextlib.contextmanager
def phase(name):
    print(f"[{name}] start", flush=True)
    t0 = time.perf_counter()
    try:
        yield
    except BaseException as exc:
        print(f"[{name}] FAILED after {time.perf_counter() - t0:.2f} s: "
              f"{type(exc).__name__}: {exc}", flush=True)
        raise
    print(f"[{name}] ok in {time.perf_counter() - t0:.2f} s", flush=True)


class _Tee(io.TextIOBase):
    """Writes to a stream and keeps a copy (threads included)."""

    def __init__(self, stream):
        self.stream = stream
        self.buf = io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()


@contextlib.contextmanager
def captured_output():
    out, err = _Tee(sys.stdout), _Tee(sys.stderr)
    old = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = out, err
    try:
        yield out.buf, err.buf
    finally:
        sys.stdout, sys.stderr = old


def phase_device():
    """The device record; raises NoGPUError on any other backend."""
    import jax
    import jaxlib
    from nautilus_tpu.utils.device import require_gpu
    dev = require_gpu()
    for key in ("platform", "kind", "count"):
        finding("device", key, dev[key])
    finding("device", "jax", jax.__version__)
    finding("device", "jaxlib", jaxlib.__version__)
    finding("device", "XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    finding("device", "compile_cache_dir",
            jax.config.jax_compilation_cache_dir)
    print("\n".join(dev["nvidia_smi"]), flush=True)
    return dev


# --------------------------------------------------------------------------
# main_path
# --------------------------------------------------------------------------

def write_bag(path, nodes):
    from nautilus_tpu.ingest import rosbag
    from nautilus_tpu.ingest.synthetic import write_synthetic_bag
    write_synthetic_bag(path, num_nodes=nodes, world_kind="building",
                        num_beams=BEAMS, seed=SEED, substeps=BAG_SUBSTEPS,
                        **ODOM_NOISE)
    msgs = [(m.topic, m.time, m.msg) for m in rosbag.read_bag(path)]
    rosbag.write_bag(path, msgs, compression="lz4")


def bag_ground_truth(timestamps, nodes):
    """Ground-truth poses of captured nodes, looked up by scan stamp.

    write_synthetic_bag stamps the scan of trajectory sample k at
    1e9 + 0.05 (k + 1) + 0.01."""
    import numpy as np
    from nautilus_tpu.ingest.synthetic import make_trajectory
    fine = make_trajectory(nodes * BAG_SUBSTEPS, "building",
                           step=0.25 / BAG_SUBSTEPS)
    k = np.rint((np.asarray(timestamps) - 1e9 - 0.01) / 0.05).astype(int) - 1
    return fine[k]


def edits_in_map_frame(first_pose):
    """HITL_EDITS_WORLD as replay lines in the frame of ``first_pose``."""
    import numpy as np
    c, s = np.cos(first_pose[2]), np.sin(first_pose[2])
    lines = []
    for edit in HITL_EDITS_WORLD:
        d = np.asarray(edit, np.float64).reshape(4, 2) - first_pose[:2]
        local = np.stack([c * d[:, 0] + s * d[:, 1],
                          -s * d[:, 0] + c * d[:, 1]], axis=1)
        lines.append(" ".join(f"{v:.4f}" for v in local.reshape(-1)))
    return lines


def write_config(work, bag, nodes, tag=""):
    cfg = os.path.join(work, f"smoke{tag}.lua")
    with open(cfg, "w") as f:
        f.write(f'dofile("{os.path.join(HERE, "config", "default_config.lua")}")\n'
                f'bag_path="{bag}"\n'
                'lidar_topic="/scan"\n'
                'odom_topic="/odom"\n'
                f"pose_number={nodes}\n"
                "auto_lc=true\n"
                "hitl_line_width=0.3\n"
                f'pose_output_file="{os.path.join(work, f"poses{tag}.txt")}"\n'
                f'map_output_file="{os.path.join(work, f"map{tag}.txt")}"\n')
    return cfg


def run_cli(argv):
    """cli.main in this process; returns its captured stdout+stderr."""
    from nautilus_tpu import cli
    with captured_output() as (out, err):
        rc = cli.main(argv)
    text = out.getvalue() + err.getvalue()
    check(rc == 0, f"cli.main returned {rc}")
    check(PREWARM_WARNING not in text, "the auto-LC prewarm failed")
    return text


def cli_findings(text):
    def ints(pattern):
        return [int(m) for m in re.findall(pattern, text)]
    cost = re.findall(r"final cost ([0-9.eE+-]+)\.", text)
    accepted = ints(r"Auto-LC: (\d+) matches above CSM score threshold")
    return {"final_cost": float(cost[0]) if cost else None,
            "candidates": ints(r"Auto-LC: (\d+) candidate scans"),
            "gated": ints(r"Auto-LC: (\d+) pairs pass the chi-square gate"),
            "accepted": accepted[0] if accepted else 0,
            "hitl_poses": ints(r"Found (\d+) poses for the")}


def phase_main_path(work, nodes=NODES):
    import numpy as np
    from nautilus_tpu.core.luaconf import load_config
    from nautilus_tpu.ingest.cache import load_or_ingest
    from nautilus_tpu.io.poses import read_pose_file, _fixed
    from nautilus_tpu.utils.metrics import ate

    bag = os.path.join(work, "building.bag")
    t0 = time.perf_counter()
    write_bag(bag, nodes)
    finding("main_path", "bag_mb", round(os.path.getsize(bag) / 1e6, 2))
    finding("main_path", "bag_write_s", round(time.perf_counter() - t0, 2))
    cfg_path = write_config(work, bag, nodes)
    # Ingest once here (the CLI then hits the ingest cache) to place the
    # edits in the map frame.
    t0 = time.perf_counter()
    raw = load_or_ingest(bag, load_config(cfg_path), verbose=False)
    finding("main_path", "ingest_s", round(time.perf_counter() - t0, 2))
    gt = bag_ground_truth(raw.timestamps, nodes)
    hitl = os.path.join(work, "hitl_edits.txt")
    with open(hitl, "w") as f:
        f.write("\n".join(edits_in_map_frame(gt[0])) + "\n")
    pose_file = os.path.join(work, "poses.txt")
    map_file = os.path.join(work, "map.txt")
    for p in (pose_file, map_file):
        if os.path.exists(p):
            os.remove(p)

    t0 = time.perf_counter()
    text = run_cli(["--config_file", cfg_path, "--hitl_replay", hitl,
                    "--write", "--vectorize"])
    finding("main_path", "cli_wall_s", round(time.perf_counter() - t0, 2))
    got = cli_findings(text)
    for key, value in got.items():
        finding("main_path", key, value)

    n = len(raw.timestamps)
    poses = read_pose_file(pose_file)
    finding("main_path", "captured_nodes", n)
    finding("main_path", "pose_lines", len(poses))
    check(len(poses) == n and set(poses) == {_fixed(t) for t in
                                             raw.timestamps},
          f"pose file has {len(poses)} lines for {n} nodes")
    check(os.path.getsize(map_file) > 0, "map file is empty")
    with open(map_file) as f:
        finding("main_path", "map_lines", sum(1 for ln in f if ln.strip()))
    found = got["hitl_poses"]
    check(len(found) == 2 * len(HITL_EDITS_WORLD),
          f"expected {len(HITL_EDITS_WORLD)} HITL callbacks")
    check(all(found[i] + found[i + 1] > 0 for i in range(0, len(found), 2)),
          f"a HITL edit selected no poses ({found})")
    check(got["accepted"] >= 1, "auto-LC accepted no closure")

    closed = np.stack([poses[_fixed(t)] for t in raw.timestamps])
    ate_odom = ate(raw.initial_poses[:n], gt)["trans_rmse"]
    ate_closed = ate(closed, gt)["trans_rmse"]
    finding("main_path", "ate_m_odometry", round(ate_odom, 4))
    finding("main_path", "ate_m_closed", round(ate_closed, 4))
    check(ate_closed < ate_odom,
          f"ATE(closed) {ate_closed:.4f} >= ATE(odometry) {ate_odom:.4f}")


# --------------------------------------------------------------------------
# parity and csm
# --------------------------------------------------------------------------

def phase_parity(nodes=NODES):
    """bench.py's problem (building world, 720 beams, seed 1) on the device
    and on the f64 CPU twin.  Returns its state, reused by the csm phase."""
    import numpy as np
    from nautilus_tpu.baseline import cpu_reference as cpu
    from nautilus_tpu.core.luaconf import load_config
    from nautilus_tpu.ingest.synthetic import make_problem
    from nautilus_tpu.solve.solver import Solver

    cfg = load_config(os.path.join(HERE, "config", "default_config.lua"))
    state, _ = make_problem(num_nodes=nodes, world_kind="building",
                            num_beams=BEAMS, seed=SEED, **ODOM_NOISE)
    x0 = state.solution.copy()
    t0 = time.perf_counter()
    Solver(state, cfg).solve_slam()
    finding("parity", "device_solve_s", round(time.perf_counter() - t0, 2))
    x_dev = state.solution.copy()
    state.solution = x0.copy()

    prob = cpu.CpuProblem.from_device_problem(state.problem)
    t0 = time.perf_counter()
    x_cpu, _ = cpu.solve_slam(prob, x0, cfg)
    finding("parity", "cpu_twin_solve_s", round(time.perf_counter() - t0, 2))

    w = cfg.get_int("lidar_constraint_amount_max")
    tw, rw = cfg.translation_weight, cfg.rotation_weight

    def f64_cost(x):
        planar, edge = cpu.associate(prob, x, w, cfg.outlier_threshold)
        return cpu.total_cost(prob, x, planar, edge, tw, rw)

    c_dev, c_cpu = f64_cost(x_dev), f64_cost(x_cpu)
    delta = abs(c_dev - c_cpu) / c_cpu
    finding("parity", "final_cost_device_f64", round(c_dev, 6))
    finding("parity", "final_cost_cpu_f64", round(c_cpu, 6))
    finding("parity", "delta_pct", round(100 * delta, 4))
    finding("parity", "tolerance_pct", 100 * PARITY_RTOL)
    finding("parity", "precision",
            "device f32, f32 products at Precision.HIGHEST, no global "
            "override; CPU twin f64; both costs evaluated in f64")
    check(np.all(np.isfinite(x_dev)), "device solution is not finite")
    check(delta <= PARITY_RTOL, f"final-cost delta {delta:.4%} > 1%")
    return state


def time_coarse_sweep(points, masks, pairs=4, rot_chunk=32, reps=5):
    """Best wall of the XLA coarse rotation sweep alone, in seconds.

    Shapes of the stage engine at CSMParams(): ``pairs`` pairs, the full
    rotation sweep (320 padded rotations), 200-cell rasters, 15 x 15
    offsets, bf16 operands."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from nautilus_tpu.kernels.csm import (CSMParams, _im2col,
                                          _raster_rot_batch, build_tables)
    params = CSMParams()
    res = params.low_res
    cells = params.kernel_cells(res)
    n_rot = int(np.ceil(2 * params.rotation_restriction
                        / (res / params.scan_range)))
    n_rot_pad = -(-n_rot // rot_chunk) * rot_chunk
    thetas = jnp.asarray(np.broadcast_to(
        -params.rotation_restriction + (np.arange(n_rot_pad) + 0.5)
        * (2 * params.rotation_restriction / n_rot),
        (pairs, n_rot_pad)), jnp.float32)
    a, ma = points[:pairs], masks[:pairs]
    b, mb = points[pairs:2 * pairs], masks[pairs:2 * pairs]
    tables = jax.vmap(lambda p, m: build_tables(p, m, params)[0])(b, mb)
    patches = jax.vmap(lambda t: _im2col(t, cells, cells))(
        tables).astype(jnp.bfloat16)

    @jax.jit
    def sweep(a, ma, thetas, patches):
        def body(best, th_chunk):
            rasters = _raster_rot_batch(a, ma, th_chunk.T,
                                        params.scan_range, res, cells)
            scores = jnp.einsum(
                "brk,bok->bro",
                rasters.reshape(pairs, rot_chunk, -1).astype(jnp.bfloat16),
                patches, preferred_element_type=jnp.float32)
            return jnp.maximum(best, scores.reshape(pairs, -1).max(1)), None
        chunks = thetas.reshape(pairs, -1, rot_chunk).transpose(1, 2, 0)
        best, _ = jax.lax.scan(body, jnp.full((pairs,), -jnp.inf), chunks)
        return best

    jax.block_until_ready(sweep(a, ma, thetas, patches))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(sweep(a, ma, thetas, patches))
        best = min(best, time.perf_counter() - t0)
    return best, (pairs, n_rot_pad, cells, patches.shape[1])


def phase_csm(state, n_pairs=CSM_PAIRS, n_cpu=CSM_CPU_PAIRS, params=None):
    import numpy as np
    from nautilus_tpu.baseline.cpu_csm import csm_match_batch_cpu
    from nautilus_tpu.kernels.csm import CSMParams, csm_match_pairs

    params = params or CSMParams()
    pts = state.problem.points
    msk = state.problem.points_mask
    ss = np.arange(n_pairs)
    tt = ss + 1
    finding("csm", "matmul_precision",
            "coarse bf16 operands / f32 accumulation (default); "
            "coarse_f32: f32 operands at Precision.HIGHEST; "
            "fine stages f32 at Precision.HIGHEST")
    pts_np, msk_np = np.asarray(pts), np.asarray(msk)
    t0 = time.perf_counter()
    s_cpu, tr_cpu = csm_match_batch_cpu(
        pts_np[ss[:n_cpu]], msk_np[ss[:n_cpu]], pts_np[tt[:n_cpu]],
        msk_np[tt[:n_cpu]], params)
    finding("csm", "cpu_twin_s", round(time.perf_counter() - t0, 2))
    results = {}
    for coarse_f32 in (False, True):
        p = params._replace(coarse_f32=coarse_f32)
        for engine in ("stage", "pair"):
            tag = f"{engine}_{'f32' if coarse_f32 else 'bf16'}"
            t0 = time.perf_counter()
            s, tr = csm_match_pairs(pts, msk, ss, tt, p, engine=engine)
            cold = time.perf_counter() - t0
            t0 = time.perf_counter()
            s, tr = csm_match_pairs(pts, msk, ss, tt, p, engine=engine)
            warm = time.perf_counter() - t0
            s, tr = np.asarray(s), np.asarray(tr)
            d_s = float(np.abs(s[:n_cpu] - s_cpu).max())
            d_t = float(np.abs(tr[:n_cpu] - tr_cpu).max())
            finding("csm", f"{tag}.cold_s", round(cold, 3))
            finding("csm", f"{tag}.warm_s", round(warm, 4))
            finding("csm", f"{tag}.pairs_per_s_warm", round(n_pairs / warm, 1))
            finding("csm", f"{tag}.max_score_delta_vs_cpu", f"{d_s:.2e}")
            finding("csm", f"{tag}.max_transform_delta_vs_cpu", f"{d_t:.2e}")
            check(s.shape == (n_pairs,) and tr.shape == (n_pairs, 3),
                  f"{tag}: shapes {s.shape} {tr.shape}")
            check(np.all(np.isfinite(s)) and np.all(np.isfinite(tr)),
                  f"{tag}: non-finite output")
            check(d_s <= CSM_SCORE_ATOL,
                  f"{tag}: score delta {d_s:.2e} > {CSM_SCORE_ATOL}")
            check(d_t <= CSM_TRANSFORM_ATOL,
                  f"{tag}: transform delta {d_t:.2e} > {CSM_TRANSFORM_ATOL}")
            results[tag] = (s, tr)
    finding("csm", "tolerances",
            f"score atol {CSM_SCORE_ATOL}, transform atol "
            f"{CSM_TRANSFORM_ATOL} (tests/test_cpu_csm.py)")
    t, shape = time_coarse_sweep(pts, msk)
    finding("csm", "coarse_sweep_shape(pairs,rotations,cells,offsets)",
            shape)
    finding("csm", "coarse_sweep_ms_best_of_5", round(t * 1e3, 3))


# --------------------------------------------------------------------------
# device_tests
# --------------------------------------------------------------------------

class _Outcomes:
    def __init__(self):
        self.passed, self.failed, self.skipped = [], [], []

    def pytest_runtest_logreport(self, report):
        if report.skipped:
            self.skipped.append(report.nodeid)
        elif report.failed:
            self.failed.append(report.nodeid)
        elif report.when == "call" and report.passed:
            self.passed.append(report.nodeid)


def phase_device_tests():
    import pytest
    os.environ["NAUTILUS_DEVICE_TESTS"] = "1"
    outcomes = _Outcomes()
    rc = pytest.main(["-q", "-m", "device", "-p", "no:cacheprovider",
                      "-p", "no:randomly", "--rootdir", HERE,
                      os.path.join(HERE, "tests", "test_device_parity.py")],
                     plugins=[outcomes])
    finding("device_tests", "passed", len(outcomes.passed))
    finding("device_tests", "failed", outcomes.failed)
    finding("device_tests", "skipped", outcomes.skipped)
    check(int(rc) == 0 and not outcomes.failed,
          f"device tests failed (pytest rc={int(rc)})")
    check(outcomes.passed and not outcomes.skipped,
          "device tests skipped or none ran")


# --------------------------------------------------------------------------
# --devices 4
# --------------------------------------------------------------------------

def phase_sharded(work, n_devices, nodes=NODES):
    import jax
    devs = jax.devices()
    check(len(devs) >= n_devices,
          f"--devices {n_devices} but JAX sees {len(devs)} device(s)")
    finding("sharded", "device_ids", [d.id for d in devs[:n_devices]])
    bag = os.path.join(work, "building.bag")
    write_bag(bag, nodes)
    runs = {}
    for tag, extra in (("sharded", ["--devices", str(n_devices)]),
                       ("one_card", [])):
        cfg = write_config(work, bag, nodes, tag=f"_{tag}")
        t0 = time.perf_counter()
        text = run_cli(["--config_file", cfg, "--write"] + extra)
        got = cli_findings(text)
        finding("sharded", f"{tag}.cli_wall_s",
                round(time.perf_counter() - t0, 2))
        finding("sharded", f"{tag}.final_cost", got["final_cost"])
        finding("sharded", f"{tag}.accepted", got["accepted"])
        check(got["final_cost"] is not None, f"{tag}: no final cost printed")
        runs[tag] = got["final_cost"]
    rel = abs(runs["sharded"] - runs["one_card"]) / abs(runs["one_card"])
    finding("sharded", "final_cost_rel_delta", f"{rel:.3e}")
    check(rel <= SHARDED_RTOL, f"sharded vs one-card cost delta {rel:.3e} "
          f"> {SHARDED_RTOL}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="with N > 1: run only the N-card sharded solve "
                         "and its one-card comparison")
    args = ap.parse_args(argv)

    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    with phase("device"):
        dev = phase_device()
    os.makedirs(WORK, exist_ok=True)
    if args.devices > 1:
        with phase("sharded"):
            phase_sharded(WORK, args.devices)
    else:
        with phase("main_path"):
            phase_main_path(WORK)
        with phase("parity"):
            state = phase_parity()
        with phase("csm"):
            phase_csm(state)
        with phase("device_tests"):
            phase_device_tests()
    print(json.dumps({"ok": True,
                      "device": {key: dev[key] for key in
                                 ("platform", "kind", "count")}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        sys.exit(1)
