"""Loop closure: CSM matching, candidate filter, chi-square gating, auto-LC."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nautilus_tpu.core.luaconf import load_config_text
from nautilus_tpu.ingest.synthetic import (make_problem, make_world, raycast,
                                           scan_to_points)
from nautilus_tpu.kernels.csm import CSMParams, csm_match
from nautilus_tpu.loop_closure.auto_lc import (relative_pose_factor,
                                               solve_auto_lc)
from nautilus_tpu.loop_closure.candidate import get_lc_candidates
from nautilus_tpu.loop_closure.matcher import LCMatcher
from nautilus_tpu.solve.solver import Solver

CFG = """
translation_weight=1
rotation_weight=1
lc_translation_weight=3
lc_rotation_weight=3
lidar_constraint_amount_min=1
lidar_constraint_amount_max=3
outlier_threshold=0.25
max_lidar_range=10
csm_score_threshold=-5.0
"""


def _pad(c, p=1024):
    out = np.zeros((p, 2), np.float32)
    m = np.zeros(p, bool)
    out[:len(c)] = c
    m[:len(c)] = True
    return jnp.asarray(out), jnp.asarray(m)


def _offset_pose(pose_b, delta):
    """Pose a such that the a->b frame transform equals delta=[tx,ty,th]."""
    c, s = np.cos(pose_b[2]), np.sin(pose_b[2])
    Rb = np.array([[c, -s], [s, c]])
    ta = pose_b[:2] + Rb @ delta[:2]
    return np.array([ta[0], ta[1], pose_b[2] + delta[2]])


class TestCSM:
    @pytest.mark.parametrize("true_t", [
        np.array([0.8, -0.5, 0.25]),
        np.array([-0.4, 1.1, -0.6]),
        np.array([0.0, 0.0, 0.0]),
    ])
    def test_recovers_transform(self, true_t):
        world = make_world("office")
        pose_b = np.array([1.0, 2.0, 0.3])
        pose_a = _offset_pose(pose_b, true_t)
        cl_b = scan_to_points(raycast(world, pose_b, 720, max_range=10),
                              max_range=10)
        cl_a = scan_to_points(raycast(world, pose_a, 720, max_range=10),
                              max_range=10)
        a, ma = _pad(cl_a)
        b, mb = _pad(cl_b)
        params = CSMParams(scan_range=10.0)
        score, tr = csm_match(a, ma, b, mb, params)
        tr = np.asarray(tr)
        assert np.linalg.norm(tr[:2] - true_t[:2]) < 0.12, tr
        assert abs(tr[2] - true_t[2]) < 0.05, tr
        # Identity pair should score at least as well as any candidate.
        assert np.isfinite(float(score))

    @pytest.mark.parametrize("true_th", [np.pi * 0.97, -np.pi * 0.9, 2.0])
    def test_rotation_center_seeds_search(self, true_th):
        """A relative rotation outside the default +-90 deg window is
        recovered when the search is seeded with the solution-implied
        heading (the reference's GetTransformation angle_a/angle_b
        contract, solver.cc:634-638) — the reverse-traversal case."""
        world = make_world("office")
        true_t = np.array([0.4, -0.3, true_th])
        pose_b = np.array([1.0, 2.0, 0.3])
        pose_a = _offset_pose(pose_b, true_t)
        cl_b = scan_to_points(raycast(world, pose_b, 720, max_range=10),
                              max_range=10)
        cl_a = scan_to_points(raycast(world, pose_a, 720, max_range=10),
                              max_range=10)
        a, ma = _pad(cl_a)
        b, mb = _pad(cl_b)
        params = CSMParams(scan_range=10.0)
        # Seed near (not exactly at) the true rotation, as the noisy
        # solution would.
        center = jnp.asarray(true_th + 0.15, jnp.float32)
        score, tr = csm_match(a, ma, b, mb, params, rotation_center=center)
        tr = np.asarray(tr)
        assert np.linalg.norm(tr[:2] - true_t[:2]) < 0.12, tr
        d_th = np.arctan2(np.sin(tr[2] - true_th), np.cos(tr[2] - true_th))
        assert abs(d_th) < 0.05, tr
        # Unseeded search (center 0) cannot represent a ~pi rotation: the
        # seeded score must strictly dominate.
        s0, tr0 = csm_match(a, ma, b, mb, params)
        if abs(true_th) > params.rotation_restriction + 0.1:
            assert float(score) > float(s0)

    def test_score_ranking(self):
        """A matching pair scores higher than an unrelated pair."""
        world = make_world("office")
        p1 = np.array([1.0, 2.0, 0.3])
        p2 = np.array([1.3, 2.2, 0.4])     # overlapping view
        p3 = np.array([-6.0, -6.0, 2.0])   # different room
        clouds = [scan_to_points(raycast(world, p, 720, max_range=10),
                                 max_range=10) for p in (p1, p2, p3)]
        (a, ma), (b, mb), (c, mc) = (_pad(x) for x in clouds)
        params = CSMParams(scan_range=10.0)
        s_match, _ = csm_match(a, ma, b, mb, params)
        s_mismatch, _ = csm_match(a, ma, c, mc, params)
        assert float(s_match) > float(s_mismatch)


class TestRefineDirect:
    def test_matches_bruteforce_occupancy(self):
        """Fine-stage scores equal the exact all-points Gaussian occupancy.

        Guards the two approximations in _refine_direct: K-nearest neighbor
        truncation and the separable-exponential einsum.
        """
        from nautilus_tpu.kernels.csm import _refine_direct, _nearest_targets
        rng = np.random.default_rng(11)
        src = rng.uniform(-3, 3, (40, 2)).astype(np.float32)
        tgt = (src + rng.normal(0, 0.05, src.shape)).astype(np.float32)
        mask = np.ones(40, bool)
        mask[35:] = False
        sigma, res, offs = 0.06, 0.02, 3
        thetas = jnp.asarray([-0.01, 0.0, 0.01], jnp.float32)
        nbr = _nearest_targets(jnp.asarray(src),
                               jnp.where(mask[:, None], tgt, 1e3), k=40)
        scores, (ty, tx) = _refine_direct(
            jnp.asarray(src), jnp.asarray(mask), nbr, thetas, res, offs,
            jnp.asarray(0.0), jnp.asarray(0.0), sigma)
        # Brute force over ALL valid target points.
        expected = np.zeros((3, 2 * offs + 1, 2 * offs + 1))
        for r, th in enumerate(np.asarray(thetas)):
            c, s = np.cos(th), np.sin(th)
            rot = src @ np.array([[c, s], [-s, c]])
            for iy, tyv in enumerate(np.asarray(ty)):
                for ix, txv in enumerate(np.asarray(tx)):
                    moved = rot + [txv, tyv]
                    d2 = ((moved[:, None, :] - tgt[None, mask])**2).sum(-1)
                    occ = np.clip(np.exp(-d2 / (2*sigma**2)).sum(1), 0, 1)
                    expected[r, iy, ix] = (np.log(occ + 1e-6) * mask).sum()
        np.testing.assert_allclose(np.asarray(scores), expected,
                                   rtol=2e-4, atol=2e-4)


def _walk_eqns(jaxpr):
    """Every equation of a jaxpr, sub-jaxprs (jit, scan, map) included."""
    for eqn in jaxpr.eqns:
        yield eqn
        for param in eqn.params.values():
            for sub in (param if isinstance(param, (tuple, list))
                        else (param,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _walk_eqns(inner)


def _stage_engine(params, a, ma, b, mb):
    from nautilus_tpu.kernels.csm import csm_match_batch_sm
    return csm_match_batch_sm(a[None], ma[None], b[None], mb[None], params,
                              pair_chunk=1)


def _pair_engine(params, a, ma, b, mb):
    from nautilus_tpu.kernels.csm import csm_match
    return csm_match(a, ma, b, mb, params)


class TestCorrelatePaths:
    def test_pallas_matmul_conv_agree(self):
        """The im2col matmul and the conv correlation agree.

        Inputs are pre-quantized to bf16 values (held in f32) because the
        production matmul path stores its operands in bf16 (memory-traffic
        halving, kernels/csm.py); on identical operand values both
        reductions accumulate in f32 and must agree."""
        from nautilus_tpu.kernels.csm import _correlate, _correlate_matmul
        rng = np.random.default_rng(3)
        table = jnp.asarray(rng.normal(size=(46, 46)), jnp.float32)
        kernels = jnp.asarray(rng.normal(size=(5, 32, 32)), jnp.float32)
        table = table.astype(jnp.bfloat16).astype(jnp.float32)
        kernels = kernels.astype(jnp.bfloat16).astype(jnp.float32)
        a = np.asarray(_correlate_matmul(table, kernels))
        b = np.asarray(_correlate(table, kernels))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)

    def test_f32_matmul_matches_conv_at_production_widths(self):
        """coarse_f32's contraction == the conv reference at CSMParams()'s
        coarse widths (200-cell kernel, 15 x 15 offsets), on operands that
        are not bf16-representable."""
        from nautilus_tpu.kernels.csm import (CSMParams, _correlate,
                                              _correlate_matmul)
        p = CSMParams()
        cells = p.kernel_cells(p.low_res)
        table_cells = p.table_cells(p.low_res)
        assert (cells, table_cells - cells + 1) == (200, 15)
        rng = np.random.default_rng(4)
        table = jnp.asarray(rng.normal(size=(table_cells, table_cells)),
                            jnp.float32)
        kernels = jnp.asarray(rng.normal(size=(3, cells, cells)),
                              jnp.float32)
        a = np.asarray(_correlate_matmul(table, kernels, jnp.float32))
        b = np.asarray(_correlate(table, kernels))
        assert a.shape == (3, 15, 15)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-3)

    @pytest.mark.parametrize("engine", [_pair_engine, _stage_engine],
                             ids=["pair", "stage"])
    def test_coarse_f32_contraction_pins_highest(self, engine):
        """With coarse_f32 the coarse contraction has f32 operands at
        Precision.HIGHEST (no TF32 rounding on a GPU), and so does every
        other f32 product of the engine."""
        from nautilus_tpu.kernels.csm import CSMParams
        params = CSMParams(coarse_f32=True)
        k = params.kernel_cells(params.low_res) ** 2
        pts = jnp.zeros((64, 2), jnp.float32)
        msk = jnp.ones((64,), bool)
        jaxpr = jax.make_jaxpr(functools.partial(engine, params))(
            pts, msk, pts, msk).jaxpr
        products = [e for e in _walk_eqns(jaxpr) if e.primitive.name in
                    ("dot_general", "conv_general_dilated")]
        coarse = [e for e in products
                  if e.primitive.name == "dot_general"
                  and any(e.invars[0].aval.shape[d] == k
                          for d in e.params["dimension_numbers"][0][0])]
        assert coarse, "coarse contraction not found"
        highest = jax.lax.Precision.HIGHEST
        for e in products:
            if any(v.aval.dtype == jnp.float32 for v in e.invars):
                prec = e.params["precision"]
                assert prec is not None and all(
                    p == highest for p in prec), (e.primitive.name, prec)
        for e in coarse:
            assert all(v.aval.dtype == jnp.float32 for v in e.invars)


class TestCandidateFilter:
    def test_spacing_and_spread(self):
        state, _ = make_problem(num_nodes=40, world_kind="building",
                                num_beams=360, seed=6)
        cands = get_lc_candidates(state, min_distance=2.0,
                                  score_threshold=0.3)
        assert len(cands) >= 2
        # Spacing respected.
        locs = state.solution[cands, :2]
        for k in range(1, len(locs)):
            assert np.linalg.norm(locs[k] - locs[k - 1]) >= 2.0 - 1e-9

    def test_corridor_scans_rejected(self):
        # A pure corridor scan has low scatter score -> excluded at 0.70.
        state, _ = make_problem(num_nodes=8, world_kind="room",
                                num_beams=360, seed=0)
        # room world has spread ~ all axes; use high threshold to reject all
        cands = get_lc_candidates(state, min_distance=0.1,
                                  score_threshold=0.999)
        assert cands == []


class TestMatcher:
    def test_uncertainty_grows_with_distance(self):
        state, _ = make_problem(num_nodes=12, world_kind="room",
                                num_beams=360, seed=4)
        cfg = load_config_text(CFG)
        solver = Solver(state, cfg)
        solver.solve_slam()
        x = solver._current_x()
        graph = solver.build_graph(x, 3)
        matcher = LCMatcher(state, graph)
        cov_near, s_near = matcher.chi_square_score(2, 3)
        cov_far, s_far = matcher.chi_square_score(2, 11)
        # Covariance between distant nodes is larger (less certain).
        assert np.trace(cov_far) > np.trace(cov_near) * 0.5
        assert np.all(np.isfinite(cov_near))

    def test_get_possible_matches_threshold(self):
        state, _ = make_problem(num_nodes=10, world_kind="room",
                                num_beams=360, seed=4)
        cfg = load_config_text(CFG)
        solver = Solver(state, cfg)
        x = solver._current_x()
        graph = solver.build_graph(x, 3)
        matcher = LCMatcher(state, graph)
        matches = matcher.get_possible_matches(2, [4, 6, 8],
                                               threshold=float("inf"))
        assert matches == [4, 6, 8]
        none = matcher.get_possible_matches(2, [4, 6, 8], threshold=0.0)
        assert none == []


class TestMatcherBandCovariance:
    def _solved(self, n=14, with_lc=True, with_hitl=False):
        state, _ = make_problem(num_nodes=n, world_kind="room",
                                num_beams=360, seed=4,
                                odom_noise_trans=0.02, odom_noise_rot=0.008)
        cfg = load_config_text(CFG)
        if with_hitl:
            from nautilus_tpu.solve.hitl import HitlConstraint
            pts = np.asarray(state.problem.points, np.float64)
            state.hitl_constraints.append(HitlConstraint(
                line_a=(np.array([0.0, -0.5]), np.array([3.0, -0.5])),
                line_b=(np.array([0.0, -0.45]), np.array([3.0, -0.45])),
                line_a_poses=[(1, pts[1][:12]), (4, pts[4][:9])],
                line_b_poses=[(6, pts[6][:7])],
                line_pose_index=0))
            state.line_poses = np.zeros((1, 3))
        solver = Solver(state, cfg)
        solver.solve_slam()
        if with_lc:
            rel = state.solution[n - 2] - state.solution[1]
            state.lc_factors.append((1, n - 2, rel[:2].copy(),
                                     float(rel[2]), 2.0, 2.0))
        return solver, state

    @pytest.mark.parametrize("with_hitl", [False, True])
    def test_band_covariance_matches_dense(self, with_hitl):
        """The O(N w) band covariance engine equals the dense Cholesky
        path — including an applied long-range closure (Woodbury term)
        and an HITL border (Schur block inverse)."""
        solver, state = self._solved(with_hitl=with_hitl)
        m_band = LCMatcher.from_solver(solver)
        assert m_band._sys is not None, "expected the band engine"
        x = solver._current_x()
        graph_dense = solver.build_graph(x, 3, exclude_long_range=False)
        m_dense = LCMatcher(state, graph_dense)
        for (s, t) in [(2, 5), (3, 11), (6, 12), (2, 12)]:
            cov_b, sc_b = m_band.chi_square_score(s, t)
            cov_d, sc_d = m_dense.chi_square_score(s, t)
            np.testing.assert_allclose(cov_b, cov_d, rtol=2e-3,
                                       atol=1e-7, err_msg=f"pair {(s, t)}")
            if np.isfinite(sc_d) and sc_d > 1e-6:
                assert abs(sc_b - sc_d) / sc_d < 5e-2, (s, t, sc_b, sc_d)
        # Gating decisions agree.
        cands = [2, 5, 11, 12]
        assert (m_band.get_possible_matches(3, cands)
                == m_dense.get_possible_matches(3, cands))


class TestAutoLC:
    def test_relative_pose_factor_consistency(self):
        state, _ = make_problem(num_nodes=6, world_kind="room", num_beams=360)
        # If CSM says identity transform between scans at the same pose,
        # the factor delta equals the current solution delta.
        state.solution[4] = state.solution[2].copy()
        f = relative_pose_factor(state, 4, 2, np.zeros(3), 1.0, 1.0)
        i, j, trans, rot, wt, wr = f
        assert (i, j) == (2, 4)
        np.testing.assert_allclose(trans, 0.0, atol=1e-12)
        assert rot == pytest.approx(0.0)

    def test_auto_lc_pipeline_runs(self):
        state, _ = make_problem(num_nodes=25, world_kind="building",
                                num_beams=360, seed=8,
                                odom_noise_trans=0.02, odom_noise_rot=0.01)
        cfg = load_config_text(CFG)
        solver = Solver(state, cfg)
        solver.solve_slam()
        report = solve_auto_lc(solver, apply=True, verbose=False,
                               csm_params=CSMParams(scan_range=10.0,
                                                    low_res=0.3,
                                                    high_res=0.05))
        assert isinstance(report.candidates, list)
        # Pipeline consistency: accepted <= gated <= all pairs.
        assert len(report.accepted) <= len(report.gated_pairs)
        if report.accepted:
            assert report.applied
            assert len(state.lc_factors) == len(report.accepted)


def _reverse_traversal_state(seed=3):
    """Shared scenario (moved to the library: ingest.synthetic.reverse_traversal_problem)."""
    from nautilus_tpu.ingest.synthetic import reverse_traversal_problem
    return reverse_traversal_problem(seed)


class TestReverseTraversalLC:
    def test_reverse_traversal_closes(self):
        """Full solve_auto_lc path on an opposite-direction re-traversal:
        the gated pairs include a relative heading ~ pi, the angle-seeded
        CSM accepts it, and the applied factor pulls the return pass back
        onto the corridor (the case a zero-centered rotation window
        cannot reach)."""
        state, gt = _reverse_traversal_state()
        cfg = load_config_text(CFG).replace(csm_score_threshold=-3.5)
        solver = Solver(state, cfg)
        solver.solve_slam()
        report = solve_auto_lc(solver, apply=True, verbose=False,
                               csm_params=CSMParams(scan_range=10.0,
                                                    high_res=0.05))
        # At least one accepted pair spans the two passes: forward nodes
        # are 6..18 (heading 0), return nodes 19..31 (heading pi).
        cross = [(s, t) for s, t in report.accepted
                 if (s <= 18) != (t <= 18)]
        assert cross, (report.gated_pairs, report.csm_results)
        for s, t, score, tr in report.csm_results:
            if (s, t) in cross or (t, s) in cross:
                # The accepted transform carries the ~pi relative rotation
                # — unreachable for a zero-centered +-pi/2 window.
                assert abs(abs(float(tr[2])) - np.pi) < 0.35, (s, t, tr)
                # Overlapping reverse pair scores FAR above disjoint pairs.
                assert score > -3.5
        assert report.applied
        # The re-solved map stays tight (the closure must not corrupt it).
        err = np.abs(state.solution[:, :2] - gt[:, :2]).mean()
        assert err < 0.3, err


class TestBestScanMatch:
    def test_best_match_is_overlapping_scan(self):
        from nautilus_tpu.loop_closure.auto_lc import best_scan_match
        state, gt = make_problem(num_nodes=30, world_kind="office",
                                 num_beams=360, seed=9)
        # Candidates: a neighbor (overlapping view) and a far node.
        score, best, tr = best_scan_match(
            state, 5, [6, 25], CSMParams(scan_range=10.0, high_res=0.05))
        assert best == 6
        assert np.isfinite(score)

    def test_empty_candidates(self):
        from nautilus_tpu.loop_closure.auto_lc import best_scan_match
        state, _ = make_problem(num_nodes=4, world_kind="room", num_beams=180)
        score, best, tr = best_scan_match(state, 1, [1])
        assert best == -1


class TestDescriptorGate:
    def test_gate_keeps_similar_pairs(self):
        from nautilus_tpu.loop_closure.auto_lc import descriptor_gate
        state, _ = make_problem(num_nodes=30, world_kind="office",
                                num_beams=360, seed=9)
        kept = descriptor_gate(state, [(5, 6), (5, 25)], threshold=0.8)
        assert (5, 6) in kept  # neighbors see nearly the same scene
        loose = descriptor_gate(state, [(5, 6), (5, 25)], threshold=0.0)
        assert len(loose) == 2


class TestScoreThresholdMargin:
    def test_office_classes_separate(self):
        """aligned/overlapping vs disjoint pair scores separate at the
        measured -3.5 operating point in the office world (full study:
        benchmarks/csm_threshold_sweep.py -> CSM_THRESHOLD.md)."""
        import sys
        from pathlib import Path
        bench_dir = Path(__file__).resolve().parent.parent / "benchmarks"
        sys.path.insert(0, str(bench_dir))
        try:
            from csm_threshold_sweep import sample_pairs, score_class
        finally:
            sys.path.pop(0)
        classes, max_range = sample_pairs("office", seed=0, per_class=3)
        true_scores = np.concatenate([
            score_class(classes["aligned"], max_range),
            score_class(classes["overlapping"], max_range)])
        disjoint = score_class(classes["disjoint"], max_range)
        assert true_scores.min() > -3.5, true_scores
        assert disjoint.max() < -3.5, disjoint


class TestStageMajorCSM:
    def test_matches_pair_major(self):
        """The stage-major batch engine returns identical results to the
        pair-major lax.map engine."""
        from nautilus_tpu.kernels.csm import (csm_match_batch,
                                              csm_match_batch_sm)
        state, _ = make_problem(num_nodes=12, world_kind="office",
                                num_beams=360, seed=9)
        pts = state.problem.points
        msk = state.problem.points_mask
        src = np.array([1, 2, 3, 5, 6, 8, 9, 10])
        tgt = np.array([0, 0, 1, 4, 4, 7, 7, 8])
        centers = jnp.asarray(
            state.solution[src, 2] - state.solution[tgt, 2], jnp.float32)
        params = CSMParams(scan_range=10.0, high_res=0.05)
        s1, t1 = csm_match_batch(pts[src], msk[src], pts[tgt], msk[tgt],
                                 params, rotation_centers=centers)
        s2, t2 = csm_match_batch_sm(pts[src], msk[src], pts[tgt], msk[tgt],
                                    params, rotation_centers=centers)
        np.testing.assert_allclose(np.asarray(s2), np.asarray(s1),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(t2), np.asarray(t1),
                                   atol=1e-5)


class TestMatchPairsEngines:
    def test_stage_gathered_matches_pair_engine(self):
        """csm_match_pairs' production path (stage engine with in-jit
        gathers + packed [G,4] readback, kernels/csm.py
        _match_pairs_sm_gathered) returns the pair-major engine's
        results through the same public entry point — including the
        power-of-two padding/unpad logic (q=5 pads to 8)."""
        from nautilus_tpu.kernels.csm import csm_match_pairs
        state, _ = make_problem(num_nodes=12, world_kind="office",
                                num_beams=360, seed=9)
        pts = state.problem.points
        msk = state.problem.points_mask
        src = np.array([1, 2, 3, 5, 9])
        tgt = np.array([0, 0, 1, 4, 8])
        centers = np.asarray(
            state.solution[src, 2] - state.solution[tgt, 2], np.float32)
        params = CSMParams(scan_range=10.0, high_res=0.05)
        s1, t1 = csm_match_pairs(pts, msk, src, tgt, params,
                                 rotation_centers=centers, engine="pair")
        s2, t2 = csm_match_pairs(pts, msk, src, tgt, params,
                                 rotation_centers=centers, engine="stage")
        assert s2.shape == (5,) and t2.shape == (5, 3)
        np.testing.assert_allclose(s2, s1, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(t2, t1, atol=1e-5)


class TestGroupedCSM:
    def test_grouped_matches_batch(self):
        from nautilus_tpu.kernels.csm import csm_match_batch, csm_match_grouped
        state, _ = make_problem(num_nodes=12, world_kind="office",
                                num_beams=360, seed=9)
        pts = state.problem.points
        msk = state.problem.points_mask
        src = np.array([1, 2, 3, 5, 6])
        tgt = np.array([0, 0, 0, 4, 4])   # grouped targets
        params = CSMParams(scan_range=10.0, high_res=0.05)
        s_g, t_g = csm_match_grouped(pts, msk, src, tgt, params)
        s_b, t_b = csm_match_batch(pts[src], msk[src], pts[tgt], msk[tgt],
                                   params)
        np.testing.assert_allclose(s_g, np.asarray(s_b), rtol=1e-5)
        np.testing.assert_allclose(t_g, np.asarray(t_b), atol=1e-5)


class TestDefaultThreshold:
    """The shipped csm_score_threshold default (-3.5,
    default_config.lua) must sit at the measured operating point: accept
    physically overlapping pairs, reject non-overlapping ones (true
    offset beyond the +-2 m search window) under the engine's
    mean-log-occupancy score scale (benchmarks/CSM_THRESHOLD.md,
    DEVIATIONS.md section 3)."""

    def test_default_separates_measured_distributions(self):
        from nautilus_tpu.core.luaconf import load_config
        cfg = load_config("config/default_config.lua")
        thresh = float(cfg.csm_score_threshold)
        assert thresh == -3.5

        # Pairs built the study's way (benchmarks/csm_threshold_sweep.py):
        # in-world office poses with scan spread, rotation search seeded
        # by the solution-implied relative heading.
        world = make_world("office")
        params = CSMParams(scan_range=10.0)
        pose_b = np.array([1.0, 2.0, 0.3])
        b, mb = _pad(scan_to_points(raycast(world, pose_b, 720, max_range=10),
                                    max_range=10).astype(np.float32))
        cases = [
            # (pose_a, rotation_center, accept)
            (np.array([2.2, 1.4, 1.1]), 0.8, True),     # overlapping
            (np.array([-6.0, -6.0, 1.9]), 1.6, False),  # different room
            (np.array([6.5, -6.5, -2.0]), -2.3, False),  # far corner
        ]
        for pose_a, center, accept in cases:
            a, ma = _pad(scan_to_points(
                raycast(world, pose_a, 720, max_range=10),
                max_range=10).astype(np.float32))
            score, _ = csm_match(a, ma, b, mb, params,
                                 rotation_center=center)
            if accept:
                assert float(score) >= thresh, float(score)
            else:
                assert float(score) < thresh, float(score)


class TestScorerSelfCheck:
    """Per-map scorer adjudication: the gate must
    fall back to the hand descriptor when the embedding separates known
    near/far pairs worse on THIS map."""

    def _state(self, n=20):
        state, _ = make_problem(num_nodes=n, world_kind="office",
                                num_beams=360, seed=6)
        return state

    def test_good_scorer_scores_high(self):
        from nautilus_tpu.loop_closure.auto_lc import scorer_self_check
        from nautilus_tpu.loop_closure.learned import match_score
        state = self._state()
        pts = state.problem.points
        msk = state.problem.points_mask
        auc = scorer_self_check(
            state, lambda s, t: match_score(pts[s], msk[s], pts[t], msk[t]))
        assert auc is not None and auc >= 0.7, auc

    def test_broken_scorer_scores_low(self):
        from nautilus_tpu.loop_closure.auto_lc import scorer_self_check
        state = self._state()
        # Anti-correlated scorer: far pairs look MORE similar.
        sol = np.asarray(state.solution[:, :2])
        auc = scorer_self_check(
            state, lambda s, t: float(np.linalg.norm(sol[s] - sol[t])))
        assert auc is not None and auc <= 0.3, auc

    def test_tiny_map_returns_none(self):
        from nautilus_tpu.loop_closure.auto_lc import scorer_self_check
        state = self._state(n=4)
        assert scorer_self_check(state, lambda s, t: 0.0) is None

    def test_gate_falls_back_when_embedding_degraded(self, monkeypatch):
        from nautilus_tpu.loop_closure import auto_lc, embedding
        from nautilus_tpu.loop_closure.learned import match_score
        if embedding.load_params() is None:
            pytest.skip("no shipped weights")
        state = self._state()
        pairs = [(0, 10), (2, 15), (1, 18), (3, 12)]
        pts = state.problem.points
        msk = state.problem.points_mask
        hand_gated = auto_lc.descriptor_gate(state, pairs, 0.5,
                                             use_learned_embedding=False)
        # Sabotage the embedding scorer: constant similarity separates
        # nothing, so its self-check AUC collapses below the hand
        # descriptor's and auto must pick the hand scorer.
        monkeypatch.setattr(embedding, "embedding_match_score",
                            lambda params, pa, ma, pb, mb: 0.0)
        auto_gated = auto_lc.descriptor_gate(state, pairs, 0.5,
                                             use_learned_embedding=None)
        assert auto_gated == hand_gated


class TestLCRangePolicy:
    """lc_base_max_range / lc_max_range_scaling (declared but unread in
    the reference, default_config.lua:121-126) gate candidate pairs by
    solution distance before the chi-square gate."""

    def _solver(self):
        from nautilus_tpu.ingest.synthetic import reverse_traversal_problem
        state, _ = reverse_traversal_problem()
        return state

    def _run(self, extra):
        state = self._solver()
        cfg = load_config_text(CFG + extra)
        solver = Solver(state, cfg)
        solver.solve_slam()
        return solve_auto_lc(solver, apply=False, verbose=False,
                             csm_params=CSMParams(scan_range=10.0,
                                                  low_res=0.3,
                                                  high_res=0.05))

    def test_tiny_range_excludes_all_pairs(self):
        report = self._run("lc_base_max_range=0.001\n"
                           "lc_max_range_scaling=0.0\n")
        assert report.gated_pairs == []

    def test_default_range_keeps_colocated_pairs(self):
        # The reverse-traversal cross-pass pair is ~0.4 m apart: inside
        # the reference default 3.5 m + 0.01/node.
        report = self._run("")
        assert len(report.gated_pairs) >= 1


class TestMatchWindow:
    """lc_match_window_size expands each gated pair's target to its +-w
    trajectory neighbors and keeps the best-scoring member (the declared
    'window around a keyframe' policy, default_config.lua:139)."""

    def _run(self, extra):
        from nautilus_tpu.ingest.synthetic import reverse_traversal_problem
        state, _ = reverse_traversal_problem()
        cfg = load_config_text(CFG + extra)
        solver = Solver(state, cfg)
        solver.solve_slam()
        return solve_auto_lc(solver, apply=False, verbose=False,
                             csm_params=CSMParams(scan_range=10.0,
                                                  low_res=0.3,
                                                  high_res=0.05))

    def test_window_never_scores_worse(self):
        r0 = self._run("lc_match_window_size=0\n")
        r1 = self._run("lc_match_window_size=1\n")
        assert len(r0.csm_results) == len(r1.csm_results) >= 1
        for (s0, t0, sc0, _), (s1, t1, sc1, _) in zip(r0.csm_results,
                                                      r1.csm_results):
            assert s0 == s1
            assert abs(t1 - t0) <= 1
            assert sc1 >= sc0 - 1e-6
        assert len(r1.accepted) >= len(r0.accepted)


class TestMatcherBucketedGroups:
    def test_grouped_scores_match_individual(self):
        """_scores pads each re-gauge group to a pow2 pair bucket (one
        compiled shape for all group sizes); padded rows must not shift
        or contaminate the real pairs' covariances."""
        state, _ = make_problem(num_nodes=14, world_kind="room",
                                num_beams=360, seed=4,
                                odom_noise_trans=0.02, odom_noise_rot=0.008)
        cfg = load_config_text(CFG)
        solver = Solver(state, cfg)
        solver.solve_slam()
        x = solver._current_x()
        graph = solver.build_graph(x, 3)
        # Group sizes 5, 2, 1 (keyed by min(s,t)-1): 5 pads to 8, 2 to 4.
        pairs = [(2, 5), (2, 7), (2, 9), (2, 11), (2, 13),
                 (3, 6), (3, 12), (4, 8)]
        batch = LCMatcher(state, graph)._scores(pairs)
        for (s, t), (cov, sc) in zip(pairs, batch):
            cov1, sc1 = LCMatcher(state, graph).chi_square_score(s, t)
            np.testing.assert_allclose(cov, cov1, rtol=1e-6, atol=1e-12,
                                       err_msg=f"pair {(s, t)}")
            assert sc == pytest.approx(sc1, rel=1e-6, abs=1e-9)


class TestLongRangeBucketHint:
    def test_sticky_hinted_bucket(self):
        """_long_range_factors pads to a high-water-mark pow2 bucket so
        the auto-LC prewarm can pin the re-solve's program shape before
        the accepted count is known."""
        state, _ = make_problem(num_nodes=20, world_kind="room",
                                num_beams=360, seed=4)
        cfg = load_config_text(CFG)
        solver = Solver(state, cfg)
        rel = state.solution[17] - state.solution[1]
        state.lc_factors.append((1, 17, rel[:2].copy(), float(rel[2]),
                                 2.0, 2.0))
        lr = solver._long_range_factors()
        assert lr.mask.shape[0] == 4 and int(lr.mask.sum()) == 1
        solver._lr_bucket = 16           # prewarm hint
        lr = solver._long_range_factors()
        assert lr.mask.shape[0] == 16 and int(lr.mask.sum()) == 1
        for k in range(16):              # HWM never shrinks, grows past 16
            state.lc_factors.append((1 + k % 3, 17, rel[:2].copy(),
                                     float(rel[2]), 2.0, 2.0))
        lr = solver._long_range_factors()
        assert lr.mask.shape[0] == 32 and int(lr.mask.sum()) == 17
        assert solver._lr_bucket == 32


class TestAutoLCPrewarm:
    def test_prewarm_parity_and_stage_walls(self):
        """The overlapped re-solve prewarm (auto_lc_prewarm) must not
        change the final map, and the stage walls must attribute the
        pass."""
        sols = {}
        for pre in ("false", "true"):
            state, gt = _reverse_traversal_state()
            cfg = load_config_text(CFG + f"\nauto_lc_prewarm={pre}")
            cfg = cfg.replace(csm_score_threshold=-3.5)
            solver = Solver(state, cfg)
            solver.solve_slam()
            report = solve_auto_lc(solver, apply=True, verbose=False,
                                   csm_params=CSMParams(scan_range=10.0,
                                                        high_res=0.05))
            assert report.applied
            for key in ("candidates", "gate", "csm", "resolve"):
                assert key in report.stage_walls, report.stage_walls
            if pre == "true":
                assert "resolve_wait" in report.stage_walls
            sols[pre] = state.solution.copy()
        np.testing.assert_allclose(sols["true"], sols["false"],
                                   rtol=1e-6, atol=1e-8)
