"""Human-in-the-loop colinearity constraints.

Mirrors the reference's HITL pipeline (src/optimization/solver.cc:463-559):

- ``HitlSlamInputMsg``: two user-drawn line segments (msg/HitlSlamInputMsg.msg),
  here a plain dataclass fed by the CLI/bridge instead of a ROS topic.
- ``select_poses``: GetRelevantPosesForHITL (solver.cc:479-513) — for every
  node, transform its full cloud by the current solution and test each point
  against both segments.  Reference quirks preserved exactly: the else-if
  point assignment (a point near both lines counts only for line A,
  solver.cc:495-500) and the else-if pose assignment (a pose qualifying for
  both joins only line A's set, solver.cc:503-510).  The per-point test is
  one batched device computation over all nodes x points.
- ``build_hitl_factors``: AddHITLResiduals (solver.cc:515-532) — each
  selected pose contributes point-to-segment residuals against the *line A*
  segment transformed by the constraint's free SE(2) line pose; the
  reference passes line_a for both pose sets (solver.cc:521,528), which is
  what makes the constraint a colinearity merge.  Preserved.
- ``solved_odom_factors``: GetSolvedOdomFactors (solver.cc:406-427) — the
  densified every-pair-within-window odometry re-extraction used before a
  HITL solve.  The reference's raw (unwrapped) rotation difference is kept.
- ``hitl_callback``: HitlCallback (solver.cc:534-559) — swap in solved
  odometry, add the constraint, solve, restore the initial odometry
  factors, solve again.  KNOWN FIX (SURVEY.md §2d): the reference restores
  ``initial_odometry_factors`` which it never populates (solver.h:121), so
  its second solve runs without odometry; we restore the actual ingest-time
  factors instead.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from nautilus_tpu.core import geometry as geo
from nautilus_tpu.core.problem import SLAMState
from nautilus_tpu.solve.factors import HitlFactors


@dataclasses.dataclass
class HitlSlamInputMsg:
    """Two line segments drawn by the curator (msg/HitlSlamInputMsg.msg)."""

    line_a_start: np.ndarray
    line_a_end: np.ndarray
    line_b_start: np.ndarray
    line_b_end: np.ndarray

    @classmethod
    def from_points(cls, a0, a1, b0, b1):
        return cls(*[np.asarray(p, np.float64) for p in (a0, a1, b0, b1)])


@dataclasses.dataclass
class HitlConstraint:
    """Host-side constraint record (reference HitlLCConstraint,
    data_structures.h:41-51)."""

    line_a: Tuple[np.ndarray, np.ndarray]
    line_b: Tuple[np.ndarray, np.ndarray]
    # [(node_idx, points [k, 2] in the node frame), ...]
    line_a_poses: List[Tuple[int, np.ndarray]]
    line_b_poses: List[Tuple[int, np.ndarray]]
    line_pose_index: int   # row into state.line_poses


@jax.jit
def _hitl_point_test(points, points_mask, x, la0, la1, lb0, lb1, width):
    """Batched point-on-segment tests. Returns (on_a, on_b) [N, P] bools."""
    world = geo.pose_transform_points(x[:, None, :], points)
    d_a = geo.distance_to_line_segment(world, la0, la1)
    d_b = geo.distance_to_line_segment(world, lb0, lb1)
    on_a = points_mask & (d_a <= width)
    # else-if: points on A never count for B (solver.cc:495-500).
    on_b = points_mask & jnp.logical_not(on_a) & (d_b <= width)
    return on_a, on_b


def select_poses(state: SLAMState, msg: HitlSlamInputMsg, config) -> HitlConstraint:
    """GetRelevantPosesForHITL — batched over all nodes and points."""
    problem = state.problem
    dtype = problem.points.dtype
    x = jnp.asarray(state.solution, dtype)
    on_a, on_b = _hitl_point_test(
        problem.points, problem.points_mask, x,
        jnp.asarray(msg.line_a_start, dtype), jnp.asarray(msg.line_a_end, dtype),
        jnp.asarray(msg.line_b_start, dtype), jnp.asarray(msg.line_b_end, dtype),
        jnp.asarray(config.hitl_line_width, dtype))
    # Fetch per-node counts first ([N] ints), then gather ONLY the
    # qualifying nodes' masks/points on device: full [N, P] mask + [N, P, 2]
    # cloud readbacks are the largest transfers of the curation step.
    count_a, count_b = jax.device_get((jnp.sum(on_a, axis=1),
                                       jnp.sum(on_b, axis=1)))
    threshold = config.get_int("hitl_pose_point_threshold")
    a_nodes = np.nonzero(count_a >= threshold)[0]
    # else-if: a pose qualifying for both joins only A (solver.cc:503-510).
    b_nodes = np.nonzero((count_b >= threshold) & (count_a < threshold))[0]
    a_poses, b_poses = [], []
    for nodes, on, out in ((a_nodes, on_a, a_poses),
                           (b_nodes, on_b, b_poses)):
        if not len(nodes):
            continue
        # Bucketed gather length with the same scale-aware floor as the
        # HitlFactors row bucket (pow2 >= N/2), so the prewarm message and
        # the operator's message reuse ONE compiled gather instead of
        # compiling one per selection size.
        b = 8
        while b < state.num_nodes // 2:
            b *= 2
        while b < len(nodes):
            b *= 2
        padded = np.concatenate([nodes, np.zeros(b - len(nodes), np.int64)])
        idx = jnp.asarray(padded, jnp.int32)
        masks, pts_sel = jax.device_get((on[idx], problem.points[idx]))
        for k, node in enumerate(nodes):
            out.append((int(node),
                        pts_sel[k][masks[k]].astype(np.float64)))
    constraint = HitlConstraint(
        line_a=(np.asarray(msg.line_a_start, np.float64),
                np.asarray(msg.line_a_end, np.float64)),
        line_b=(np.asarray(msg.line_b_start, np.float64),
                np.asarray(msg.line_b_end, np.float64)),
        line_a_poses=a_poses, line_b_poses=b_poses,
        line_pose_index=len(state.line_poses))
    return constraint


def build_hitl_factors(state: SLAMState, dtype=jnp.float32) -> HitlFactors:
    """Flatten all constraints into padded HitlFactors arrays."""
    rows = []
    for c in state.hitl_constraints:
        line_dof = state.num_nodes + c.line_pose_index
        # Reference passes line_a for BOTH sets (solver.cc:521,528).
        seg = c.line_a
        for node, pts in c.line_a_poses + c.line_b_poses:
            rows.append((node, line_dof, pts, seg))
    if not rows:
        from nautilus_tpu.solve.factors import empty_hitl
        return empty_hitl(dtype)
    # Power-of-two bucketed padding with generous floors: typical curation
    # sessions stay inside ONE compiled shape; growth beyond the floor
    # costs O(log) recompiles.  Masked padding is near-free at solve time.
    def bucket(n, lo):
        b = lo
        while b < n:
            b *= 2
        return b

    # Row floor scales with the graph (pow2 >= N/2): a wall-length
    # operator line at GDC scale selects hundreds of poses, and the
    # prewarm (prewarm_hitl) can only pre-compile the first callback's
    # shape if any plausible first message lands in the SAME bucket —
    # with a fixed floor of 32 the prewarm message and the operator's
    # message routinely straddled a pow2 boundary, and the "prewarmed"
    # first callback recompiled anyway (measured 20 s at N=1000).
    row_floor = 32
    while row_floor < state.num_nodes // 2:
        row_floor *= 2
    kmax = bucket(max(max(len(p) for _, _, p, _ in rows), 1), 512)
    r = bucket(len(rows), row_floor)
    n_real_rows = len(rows)
    node = np.zeros(r, np.int32)
    line = np.zeros(r, np.int32)
    points = np.zeros((r, kmax, 2), np.float64)
    mask = np.zeros((r, kmax), bool)
    seg_start = np.zeros((r, 2), np.float64)
    seg_end = np.zeros((r, 2), np.float64)
    for q, (n_idx, l_idx, pts, seg) in enumerate(rows):
        node[q] = n_idx
        line[q] = l_idx
        points[q, :len(pts)] = pts
        mask[q, :len(pts)] = True
        seg_start[q] = seg[0]
        seg_end[q] = seg[1]
    return HitlFactors(
        node=jnp.asarray(node), line=jnp.asarray(line),
        points=jnp.asarray(points, dtype), mask=jnp.asarray(mask),
        seg_start=jnp.asarray(seg_start, dtype),
        seg_end=jnp.asarray(seg_end, dtype))


def solved_odom_factors(state: SLAMState, max_window: int):
    """GetSolvedOdomFactors (solver.cc:406-427): every pair within
    max_window gets a factor carrying the *current solution's* relative
    pose (raw world-frame deltas, unwrapped rotation difference)."""
    sol = state.solution
    n = len(sol)
    # Vectorized pair enumeration: for each j in [1, n), i in [j-w, j).
    jj = np.repeat(np.arange(1, n), np.minimum(np.arange(1, n), max_window))
    offsets = np.concatenate(
        [np.arange(min(j, max_window), 0, -1) for j in range(1, n)])
    ii = jj - offsets
    trans = sol[jj, :2] - sol[ii, :2]
    rot = sol[jj, 2] - sol[ii, 2]
    return ii, jj, trans, rot


def solved_odom_factors_between(state: SLAMState, a: int, b: int):
    """GetSolvedOdomFactorsBetweenNodes (solver.cc:429-448): consecutive
    factors a..b from the current solution, with *wrapped* rotation
    difference (the reference uses AngleDiff here, unlike the densified
    variant)."""
    assert b > a
    sol = state.solution
    ii = np.arange(a, b)
    jj = ii + 1
    trans = sol[jj, :2] - sol[ii, :2]
    rot = geo_angle_diff(sol[jj, 2], sol[ii, 2])
    return ii, jj, trans, rot


def geo_angle_diff(a, b):
    d = a - b
    return d - 2.0 * np.pi * np.round(d / (2.0 * np.pi))


def total_odom_change(trans: np.ndarray, rot: np.ndarray):
    """GetTotalOdomChange (solver.cc:450-461): summed translation and
    wrapped-summed rotation over a factor list."""
    total_trans = trans.sum(axis=0) if len(trans) else np.zeros(2)
    total_rot = 0.0
    for r in rot:
        total_rot = float(geo_angle_diff(total_rot + r, 0.0))
    return total_trans, total_rot


def default_prewarm_msg(state: SLAMState) -> HitlSlamInputMsg:
    """A plausible curation message for shape prewarming: two parallel
    strips across the solution bbox midline (selects a realistic pose
    count, so the padded factor buckets match typical operator input)."""
    sol = np.asarray(state.solution[:, :2], np.float64)
    lo, hi = sol.min(axis=0), sol.max(axis=0)
    ymid = 0.5 * (lo[1] + hi[1])
    return HitlSlamInputMsg.from_points(
        (lo[0] - 1.0, ymid), (hi[0] + 1.0, ymid),
        (lo[0] - 1.0, ymid + 0.5), (hi[0] + 1.0, ymid + 0.5))


def prewarm_hitl(solver, msg: HitlSlamInputMsg = None) -> float:
    """Compile the HITL-shaped programs before the first human interaction.

    Runs the full hitl_callback flow on a throwaway copy of the solver's
    state (the real state is never touched), so the densified-odometry
    fused sweep, the 8-slot line-pose dof vector, and the padded
    HitlFactors buckets are all compiled (and in the persistent cache)
    when the operator's first message arrives.  The copy shares the
    (immutable, device-resident) SLAMProblem arrays.

    The CLI calls this in a background daemon thread while waiting for
    operator input (cli.py); bench.py times it as hitl_prewarm_s.
    Returns the wall seconds spent.

    The reference has no analog: its Ceres solve has no per-shape compile
    cost — this closes the cold-start gap the XLA compile introduces.
    Whether it pays on the H100 is not measured yet (ROADMAP.md
    section 3, compile-hiding machinery).
    """
    import time as _time
    from nautilus_tpu.solve.solver import Solver
    t0 = _time.perf_counter()
    state = solver.state
    twin = SLAMState(
        problem=state.problem,
        solution=state.solution.copy(),
        timestamps=state.timestamps,
        hitl_constraints=list(state.hitl_constraints),
        line_poses=state.line_poses.copy(),
        odometry_factors=state.odometry_factors,
        initial_odometry_factors=state.initial_odometry_factors,
        lc_factors=list(state.lc_factors))
    shadow = Solver(twin, solver.config,
                    lm_params=solver.lm_params,
                    linear_solver=solver.linear_solver,
                    use_normal_gate=solver.use_normal_gate,
                    fused_sweep=solver.fused_sweep,
                    staged_fused=solver.staged_fused,
                    assembly=solver.assembly,
                    mesh=solver.mesh)
    # Seed the shadow's odometry padding bucket from the live solver so
    # both progress to the same high-water mark (identical compiled
    # shapes for the real callback).
    shadow._odom_bucket = getattr(solver, "_odom_bucket", 0)
    hitl_callback(shadow, msg or default_prewarm_msg(state), verbose=False)
    # Propagate the densified high-water mark back: the real callback's
    # second (sparse) solve then reuses the densified-shape program.
    solver._odom_bucket = max(getattr(solver, "_odom_bucket", 0),
                              shadow._odom_bucket)
    return _time.perf_counter() - t0


def hitl_callback(solver, msg: HitlSlamInputMsg, verbose: bool = True):
    """Full HitlCallback flow (solver.cc:534-559) on a Solver instance."""
    state: SLAMState = solver.state
    cfg = solver.config
    state.odometry_factors = solved_odom_factors(
        state, cfg.get_int("lidar_constraint_amount_max"))
    constraint = select_poses(state, msg, cfg)
    if verbose:
        print(f"Found {len(constraint.line_a_poses)} poses for the first line.")
        print(f"Found {len(constraint.line_b_poses)} poses for the second line.")
    state.hitl_constraints.append(constraint)
    state.line_poses = np.concatenate(
        [state.line_poses, np.zeros((1, 3), np.float64)], axis=0)
    if verbose:
        print("Solving problem with HITL constraints...")
    stats1 = solver.solve_slam()
    # KNOWN FIX vs reference: restore the REAL ingest-time odometry factors
    # (the reference restores a never-populated list, SURVEY.md §2d).
    state.odometry_factors = state.initial_odometry_factors
    if verbose:
        print("Solving problem with initial odometry constraints...")
    stats2 = solver.solve_slam()
    return stats1, stats2
