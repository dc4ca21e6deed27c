"""HITL colinearity path: pose selection quirks, constraint effect, pose IO."""

import numpy as np
import jax.numpy as jnp
import pytest

from nautilus_tpu.core.luaconf import load_config_text
from nautilus_tpu.core.problem import (RawNodes, SLAMState, build_problem,
                                       pad_clouds)
from nautilus_tpu.core.preprocess import preprocess
from nautilus_tpu.ingest.synthetic import make_problem
from nautilus_tpu.io.poses import load_solution, write_poses
from nautilus_tpu.solve.hitl import (HitlSlamInputMsg, hitl_callback,
                                     select_poses, solved_odom_factors)
from nautilus_tpu.solve.solver import Solver

CFG = """
translation_weight=1
rotation_weight=1
lidar_constraint_amount_min=1
lidar_constraint_amount_max=2
outlier_threshold=0.25
hitl_line_width=0.1
hitl_pose_point_threshold=10
"""


def _wall_state(shift=0.4):
    """Two nodes each seeing the same wall (y=0 in their own frames);
    node 1's pose is shifted +shift in y, so its wall lands displaced in
    the world: the canonical HITL colinearity scenario."""
    xs = np.linspace(0.0, 4.0, 80)
    wall = np.stack([xs, np.zeros_like(xs)], -1).astype(np.float32)
    points, mask = pad_clouds([wall, wall.copy()])
    n = 2
    raw = RawNodes(
        points=points, points_mask=mask,
        initial_poses=np.array([[0, 0, 0], [0.0, shift, 0]], np.float64),
        timestamps=np.array([1.0, 2.0]),
        odom_i=np.array([0]), odom_j=np.array([1]),
        odom_trans=np.array([[0.0, shift]]), odom_rot=np.array([0.0]))
    normals, pi, pm, ei, em, _ = preprocess(raw.points, raw.points_mask)
    problem = build_problem(raw, normals, pi, pm, ei, em)
    return SLAMState.from_problem(problem, raw.timestamps)


class TestSelectPoses:
    def test_selection_and_else_if_quirks(self):
        state = _wall_state(shift=0.4)
        cfg = load_config_text(CFG)
        msg = HitlSlamInputMsg.from_points(
            (-0.5, 0.0), (4.5, 0.0),      # line A on node 0's wall
            (-0.5, 0.4), (4.5, 0.4))      # line B on node 1's displaced wall
        c = select_poses(state, msg, cfg)
        assert [n for n, _ in c.line_a_poses] == [0]
        assert [n for n, _ in c.line_b_poses] == [1]
        assert len(c.line_a_poses[0][1]) >= 10

    def test_pose_near_both_lines_joins_only_a(self):
        state = _wall_state(shift=0.05)   # both walls within line width of A
        cfg = load_config_text(CFG)
        msg = HitlSlamInputMsg.from_points(
            (-0.5, 0.0), (4.5, 0.0), (-0.5, 0.05), (4.5, 0.05))
        c = select_poses(state, msg, cfg)
        # Both nodes' points are within 0.1 of line A -> both poses go to A.
        assert [n for n, _ in c.line_a_poses] == [0, 1]
        assert c.line_b_poses == []

    def test_below_threshold_not_selected(self):
        state = _wall_state(shift=5.0)    # node 1's wall far from both lines
        cfg = load_config_text(CFG)
        msg = HitlSlamInputMsg.from_points(
            (-0.5, 0.0), (4.5, 0.0), (-0.5, 0.4), (4.5, 0.4))
        c = select_poses(state, msg, cfg)
        assert [n for n, _ in c.line_a_poses] == [0]
        assert c.line_b_poses == []


class TestSolvedOdom:
    def test_pair_densification(self):
        state, _ = make_problem(num_nodes=5, world_kind="room", num_beams=180)
        ii, jj, trans, rot = solved_odom_factors(state, 3)
        # every pair within window 3: (0,1) (0,2),(1,2) (0,3),(1,3),(2,3), ...
        expected = sum(min(i, 3) for i in range(1, 5))
        assert len(ii) == expected
        assert np.all(jj > ii)
        k = np.where((ii == 1) & (jj == 3))[0][0]
        np.testing.assert_allclose(
            trans[k], state.solution[3, :2] - state.solution[1, :2])


class TestHitlSolve:
    def test_colinearity_pulls_walls_together(self):
        state = _wall_state(shift=0.4)
        # Weak odometry so the colinearity constraint can win.
        cfg = load_config_text(CFG).replace(translation_weight=0.05,
                                            rotation_weight=0.05)
        solver = Solver(state, cfg)
        msg = HitlSlamInputMsg.from_points(
            (-0.5, 0.0), (4.5, 0.0), (-0.5, 0.4), (4.5, 0.4))
        before_gap = abs(state.solution[1, 1] - state.solution[0, 1])
        hitl_callback(solver, msg, verbose=False)
        after_gap = abs(state.solution[1, 1] - state.solution[0, 1])
        assert after_gap < before_gap * 0.5, (before_gap, after_gap)

    def test_line_pose_dof_added(self):
        state = _wall_state()
        cfg = load_config_text(CFG).replace(translation_weight=0.05)
        solver = Solver(state, cfg)
        msg = HitlSlamInputMsg.from_points(
            (-0.5, 0.0), (4.5, 0.0), (-0.5, 0.4), (4.5, 0.4))
        hitl_callback(solver, msg, verbose=False)
        assert state.line_poses.shape == (1, 3)
        assert len(state.hitl_constraints) == 1


class TestPoseIO:
    def test_roundtrip(self, tmp_path):
        state, _ = make_problem(num_nodes=6, world_kind="room", num_beams=180)
        state.solution += 0.123456789
        f = tmp_path / "poses.txt"
        write_poses(state, f)
        text = f.read_text()
        assert len(text.splitlines()) == 6
        # fixed 6-decimal format
        assert all(len(tok.split(".")[1]) == 6
                   for tok in text.splitlines()[0].split())
        mutated = state.solution.copy()
        state.solution = np.zeros_like(state.solution)
        n = load_solution(state, f, verbose=False)
        assert n == 6
        np.testing.assert_allclose(state.solution, mutated, atol=1e-6)

    def test_partial_match(self, tmp_path):
        state, _ = make_problem(num_nodes=4, world_kind="room", num_beams=180)
        f = tmp_path / "poses.txt"
        write_poses(state, f)
        state.timestamps = state.timestamps.copy()
        state.timestamps[2] += 99.0   # no longer matches
        state.solution = np.zeros_like(state.solution)
        n = load_solution(state, f, verbose=False)
        assert n == 3


class TestPrewarm:
    def test_prewarm_leaves_state_untouched_and_matches_shapes(self):
        """prewarm_hitl compiles on a throwaway copy: the real state is
        unchanged, and the real callback afterwards produces the same
        result as without prewarm."""
        from nautilus_tpu.solve.hitl import (HitlSlamInputMsg,
                                             hitl_callback, prewarm_hitl)
        from nautilus_tpu.solve.solver import Solver

        state, _ = make_problem(num_nodes=8, world_kind="room",
                                num_beams=360, seed=3)
        cfg = load_config_text(CFG).replace(hitl_line_width=0.3,
                                            hitl_pose_point_threshold=10)
        solver = Solver(state, cfg)
        solver.solve_slam()
        sol_before = state.solution.copy()
        n_constraints = len(state.hitl_constraints)
        wall = prewarm_hitl(solver)
        assert wall > 0.0
        # Prewarm must not mutate the real session.
        np.testing.assert_array_equal(state.solution, sol_before)
        assert len(state.hitl_constraints) == n_constraints
        assert len(state.line_poses) == 0
        assert state.odometry_factors is state.initial_odometry_factors
        # The real callback still works after prewarm.
        msg = HitlSlamInputMsg.from_points((-4.5, -5.0), (4.5, -5.0),
                                           (-4.5, -4.7), (4.5, -4.7))
        hitl_callback(solver, msg, verbose=False)
        assert len(state.hitl_constraints) == n_constraints + 1
        assert np.all(np.isfinite(state.solution))


class TestPrewarmBucketAlignment:
    def test_prewarm_and_operator_msgs_share_row_bucket(self):
        """build_hitl_factors' row floor scales with the graph (pow2 >=
        N/2), so the prewarm message and any plausible operator first
        message compile the SAME factor shape — with a fixed floor of 32
        they routinely straddled a pow2 boundary and the 'prewarmed'
        first callback recompiled anyway (20 s at N=1000)."""
        from nautilus_tpu.solve.hitl import HitlConstraint, build_hitl_factors
        state, _ = make_problem(num_nodes=120, world_kind="office",
                                num_beams=180, seed=4)

        def constraint(n_rows):
            seg = (np.zeros(2), np.array([4.0, 0.0]))
            rows = [(i, np.random.RandomState(i).randn(12, 2))
                    for i in range(n_rows)]
            return HitlConstraint(line_a=seg, line_b=seg,
                                  line_a_poses=rows, line_b_poses=[],
                                  line_pose_index=0)

        shapes = []
        for n_rows in (5, 40):   # straddles the old fixed floor of 32
            state.hitl_constraints.append(constraint(n_rows))
            shapes.append(build_hitl_factors(state).points.shape)
            state.hitl_constraints.clear()
        assert shapes[0] == shapes[1], shapes
        assert shapes[0][0] == 64  # floor = pow2 >= N/2 = 64, not 32
