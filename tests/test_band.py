"""Block-band Cholesky solver (solve/band.py) vs dense normal equations.

The band path must be algebraically identical to the dense path
(reference Ceres solves the same normal equations via SPARSE_SCHUR,
solver.cc:269); these tests pin matvec, damped solve, full LM, and the
HITL bordered system against the dense implementations.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from nautilus_tpu.core.luaconf import load_config_text
from nautilus_tpu.ingest.synthetic import make_problem
from nautilus_tpu.solve.band import (band_factor, band_apply_inverse,
                                     band_matvec, solve_damped_banded)
from nautilus_tpu.solve.factors import (assemble_banded_system,
                                        assemble_normal_equations)
from nautilus_tpu.solve.lm import (LMParams, _solve_damped, lm_solve,
                                   lm_solve_banded)
from nautilus_tpu.solve.solver import Solver

DEFAULTS = """
translation_weight=1
rotation_weight=1
lidar_constraint_amount_min=1
lidar_constraint_amount_max=3
outlier_threshold=0.25
"""


def _setup(n=9, with_hitl=False, seed=3):
    state, _ = make_problem(num_nodes=n, world_kind="room", num_beams=240,
                            seed=seed, odom_noise_trans=0.03,
                            odom_noise_rot=0.01)
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
    cfg = load_config_text(DEFAULTS)
    solver = Solver(state, cfg)
    x = solver._current_x()
    graph = solver.build_graph(x, window=3)
    return solver, x, graph


@pytest.mark.parametrize("with_hitl", [False, True])
def test_band_system_matches_dense(with_hitl):
    solver, x, graph = _setup(with_hitl=with_hitl)
    layout = solver._layout
    H, g, c = assemble_normal_equations(x, graph, layout)
    sysb, cb = assemble_banded_system(x, graph, layout)
    np.testing.assert_allclose(float(cb), float(c), rtol=1e-6)
    n = layout.n
    L = sysb.num_lines
    rng = np.random.RandomState(0)
    v = jnp.asarray(rng.randn(n, 3), x.dtype)
    vl = jnp.asarray(rng.randn(L, 3), x.dtype) if L else None
    Hv, Hvl = band_matvec(sysb, v, vl)
    vfull = np.concatenate([np.asarray(v).reshape(-1),
                            np.asarray(vl).reshape(-1) if L else np.zeros(0)])
    dense = (np.asarray(H, np.float64) @ vfull)
    np.testing.assert_allclose(np.asarray(Hv).reshape(-1), dense[:3 * n],
                               rtol=1e-4, atol=1e-4)
    if L:
        np.testing.assert_allclose(np.asarray(Hvl).reshape(-1),
                                   dense[3 * n:], rtol=1e-4, atol=1e-4)
    gfull = np.concatenate([np.asarray(sysb.g).reshape(-1),
                            np.asarray(sysb.gl).reshape(-1) if L
                            else np.zeros(0)])
    np.testing.assert_allclose(gfull, np.asarray(g), rtol=1e-5, atol=1e-5)


def test_band_factor_inverse():
    """band_factor/apply_inverse solves H x = r (no damping, gauged)."""
    solver, x, graph = _setup()
    layout = solver._layout
    sysb, _ = assemble_banded_system(x, graph, layout)
    from nautilus_tpu.solve.band import _apply_gauge_band
    sysg = _apply_gauge_band(sysb, solver._fixed_mask())
    # Regularize lightly so both solves are well-posed.
    eye = jnp.eye(3, dtype=x.dtype) * 1e-3
    sysg = sysg._replace(diag=sysg.diag + eye[None])
    fac = band_factor(sysg, s=4)
    r = jnp.asarray(np.random.RandomState(1).randn(layout.n, 3), x.dtype)
    sol = band_apply_inverse(fac, r)
    back, _ = band_matvec(sysg, sol)
    np.testing.assert_allclose(np.asarray(back), np.asarray(r),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("with_hitl", [False, True])
@pytest.mark.parametrize("radius", [1e4, 1e2])
def test_damped_band_solve_matches_dense(with_hitl, radius):
    solver, x, graph = _setup(with_hitl=with_hitl)
    layout = solver._layout
    fixed = solver._fixed_mask()
    params = LMParams()
    H, g, _ = assemble_normal_equations(x, graph, layout)
    sysb, _ = assemble_banded_system(x, graph, layout)
    r = jnp.asarray(radius, x.dtype)
    dx_dense, _, _ = _solve_damped(H, g, fixed, r, params)
    dx, dxl, _ = solve_damped_banded(sysb, fixed, r, params, superblock=4)
    flat = np.asarray(dx).reshape(-1)
    if dxl is not None:
        flat = np.concatenate([flat, np.asarray(dxl).reshape(-1)])
    np.testing.assert_allclose(flat, np.asarray(dx_dense),
                               rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("with_hitl", [False, True])
def test_lm_band_matches_dense(with_hitl):
    solver, x, graph = _setup(with_hitl=with_hitl)
    layout = solver._layout
    fixed = solver._fixed_mask()
    params = LMParams()
    r0 = lm_solve(x, graph, fixed, params=params, layout=layout)
    r1 = lm_solve_banded(x, graph, fixed, params=params, layout=layout,
                         superblock=4)
    np.testing.assert_allclose(float(r1.cost), float(r0.cost), rtol=1e-3)
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r0.x),
                               rtol=5e-3, atol=5e-4)


def test_full_solve_band_vs_dense():
    """End-to-end growing-window sweep: band and dense solvers land on
    the same map."""
    state, _ = make_problem(num_nodes=12, world_kind="room", num_beams=240,
                            seed=7, odom_noise_trans=0.03,
                            odom_noise_rot=0.01)
    cfg = load_config_text(DEFAULTS)
    x0 = state.solution.copy()
    s_dense = Solver(state, cfg, linear_solver="dense")
    st_dense = s_dense.solve_slam()
    sol_dense = state.solution.copy()
    state.solution = x0.copy()
    s_band = Solver(state, cfg, linear_solver="band")
    st_band = s_band.solve_slam()
    np.testing.assert_allclose(st_band.final_cost, st_dense.final_cost,
                               rtol=1e-3)
    np.testing.assert_allclose(state.solution, sol_dense, rtol=5e-3,
                               atol=1e-3)


def test_auto_stays_band_with_lc_woodbury():
    state, _ = make_problem(num_nodes=8, world_kind="room", num_beams=180,
                            seed=9)
    cfg = load_config_text(DEFAULTS)
    solver = Solver(state, cfg)
    assert solver._resolve_solver() == "band"
    # Applied loop-closure factors ride the band solver as a Woodbury
    # low-rank term — auto stays band.
    state.lc_factors.append((0, 7, np.zeros(2), 0.0, 1.0, 1.0))
    assert solver._resolve_solver() == "band"
    assert solver._long_range_factors() is not None
    # ...until the low-rank cap, where dense takes over.
    solver2 = Solver(state, cfg)
    state.lc_factors.extend([(0, 7, np.zeros(2), 0.0, 1.0, 1.0)]
                            * solver2.LR_FACTOR_CAP)
    assert solver2._resolve_solver() == "dense"


def test_explicit_band_refuses_beyond_lr_cap():
    """linear_solver='band' beyond the Woodbury low-rank cap must
    hard-error instead of silently degrading."""
    state, _ = make_problem(num_nodes=8, world_kind="room", num_beams=180,
                            seed=9)
    cfg = load_config_text(DEFAULTS)
    solver = Solver(state, cfg, linear_solver="band")
    state.lc_factors.extend([(0, 7, np.zeros(2), 0.0, 1.0, 1.0)]
                            * (solver.LR_FACTOR_CAP + 1))
    with pytest.raises(ValueError, match="band"):
        solver._resolve_solver()


def test_band_woodbury_matches_dense_with_lc():
    """A graph with applied long-range loop closures: the band+Woodbury
    solve equals the dense solve."""
    state, _ = make_problem(num_nodes=12, world_kind="room", num_beams=240,
                            seed=7, odom_noise_trans=0.03,
                            odom_noise_rot=0.01)
    cfg = load_config_text(DEFAULTS)
    # Two long-range closures tying the ends together (delta > w_max=3).
    for (a, b) in ((0, 10), (1, 11)):
        rel = state.solution[b] - state.solution[a]
        state.lc_factors.append((a, b, rel[:2].copy(), float(rel[2]),
                                 3.0, 2.0))
    x0 = state.solution.copy()
    s_dense = Solver(state, cfg, linear_solver="dense")
    assert s_dense._resolve_solver() == "dense"
    st_dense = s_dense.solve_slam()
    sol_dense = state.solution.copy()
    state.solution = x0.copy()
    s_band = Solver(state, cfg, linear_solver="band")
    assert s_band._resolve_solver() == "band"
    st_band = s_band.solve_slam()
    np.testing.assert_allclose(st_band.final_cost, st_dense.final_cost,
                               rtol=1e-3)
    np.testing.assert_allclose(state.solution, sol_dense, rtol=5e-3,
                               atol=1e-3)
    # Also via the host window loop (fused_sweep=False).
    state.solution = x0.copy()
    s_host = Solver(state, cfg, linear_solver="band", fused_sweep=False)
    st_host = s_host.solve_slam()
    np.testing.assert_allclose(st_host.final_cost, st_dense.final_cost,
                               rtol=1e-3)


def test_band_hitl_plus_woodbury_matches_dense():
    """HITL Schur border AND Woodbury low-rank term simultaneously: the
    node_inverse-with-correction path inside the bordered solve (the
    default band path once a session has both a human constraint and an
    applied loop closure) must equal the dense solve."""
    solver, x, graph = _setup(n=12, with_hitl=True)
    state = solver.state
    # One long-range closure (delta > w_max=3) -> Woodbury U columns.
    rel = state.solution[10] - state.solution[1]
    state.lc_factors.append((1, 10, rel[:2].copy(), float(rel[2]), 3.0, 2.0))
    fixed = solver._fixed_mask()
    params = LMParams()
    # Dense: LC factor folded into the odometry batch.
    graph_dense = solver.build_graph(x, window=3, exclude_long_range=False)
    # Band: LC factor via the low-rank term.
    graph_band = solver.build_graph(x, window=3, exclude_long_range=True)
    lr = solver._long_range_factors()
    assert lr is not None and solver.state.hitl_constraints
    layout = solver._layout
    H, g, c_dense = assemble_normal_equations(x, graph_dense, layout)
    sysb, c_band = assemble_banded_system(x, graph_band, layout, True, lr)
    np.testing.assert_allclose(float(c_band), float(c_dense), rtol=1e-6)
    for radius in (1e4, 1.0):
        r = jnp.asarray(radius, x.dtype)
        dx_dense, _, _ = _solve_damped(H, g, fixed, r, params)
        dx, dxl, _ = solve_damped_banded(sysb, fixed, r, params,
                                         superblock=4)
        assert dxl is not None
        flat = np.concatenate([np.asarray(dx).reshape(-1),
                               np.asarray(dxl).reshape(-1)])
        # rtol 2e-3: dense-fold vs Woodbury is a cross-algorithm f32
        # comparison; summation-order changes in the analytic Jacobians
        # move the lightly-damped (radius=1) step by ~1.4e-3 relative.
        np.testing.assert_allclose(flat, np.asarray(dx_dense),
                                   rtol=2e-3, atol=1e-5)
    # Full LM parity on the combined system.
    r_dense = lm_solve(x, graph_dense, fixed, params=params, layout=layout)
    r_band = lm_solve_banded(x, graph_band, fixed, params=params,
                             layout=layout, superblock=4, lr=lr)
    np.testing.assert_allclose(float(r_band.cost), float(r_dense.cost),
                               rtol=1e-3)


def test_sharded_band_refuses_out_of_band_pairs():
    """Caller-supplied correspondence pairs beyond the band must be
    rejected (assemble_banded_scatter would silently drop them)."""
    from nautilus_tpu.parallel.sharded import sharded_sweep, default_mesh
    from nautilus_tpu.solve.factors import empty_hitl
    state, _ = make_problem(num_nodes=8, world_kind="room", num_beams=180,
                            seed=9)
    cfg = load_config_text(DEFAULTS)
    solver = Solver(state, cfg)
    x = solver._current_x()
    odom = solver._odom_factors()
    bad_src = jnp.concatenate([solver._pair_src, jnp.asarray([7])])
    bad_tgt = jnp.concatenate([solver._pair_tgt, jnp.asarray([0])])
    with pytest.raises(ValueError, match="pairs"):
        sharded_sweep(x, state.problem, bad_src, bad_tgt,
                      odom, empty_hitl(x.dtype), solver._fixed_mask(),
                      jnp.asarray(0.25, x.dtype), 1, 3,
                      default_mesh(1), use_band=True)


def test_odom_cache_keyed_on_lc_contents():
    """Replacing an LC factor in place (same count) must refresh the
    cached device factors."""
    state, _ = make_problem(num_nodes=8, world_kind="room", num_beams=180,
                            seed=9)
    cfg = load_config_text(DEFAULTS)
    solver = Solver(state, cfg)
    state.lc_factors.append((0, 2, np.array([1.0, 0.0]), 0.1, 2.0, 2.0))
    od1 = solver._odom_factors()
    state.lc_factors[0] = (0, 2, np.array([-1.0, 0.5]), -0.1, 2.0, 2.0)
    od2 = solver._odom_factors()
    assert not np.allclose(np.asarray(od1.trans), np.asarray(od2.trans))


def test_sharded_band_refuses_out_of_band_factors():
    from nautilus_tpu.solve.factors import make_odom_factors
    # Factor (7, 0) has delta 7 > w_band=3 -> must be rejected.
    odom = make_odom_factors([0, 7], [1, 0], np.zeros((2, 2)), [0.0, 0.0])
    from nautilus_tpu.parallel.sharded import sharded_sweep, default_mesh
    from nautilus_tpu.solve.factors import empty_hitl
    state, _ = make_problem(num_nodes=8, world_kind="room", num_beams=180,
                            seed=9)
    cfg = load_config_text(DEFAULTS)
    solver = Solver(state, cfg)
    x = solver._current_x()
    with pytest.raises(ValueError, match="use_band"):
        sharded_sweep(x, state.problem, solver._pair_src, solver._pair_tgt,
                      odom, empty_hitl(x.dtype), solver._fixed_mask(),
                      jnp.asarray(0.25, x.dtype), 1, 3,
                      default_mesh(1), use_band=True)


def test_cr_tridiag_matches_scan():
    """Block cyclic reduction == the sequential scan factorization on
    random SPD block-tridiagonal systems."""
    import jax.numpy as jnp
    from nautilus_tpu.solve.band import (cr_factor_tridiag,
                                         cr_solve_tridiag,
                                         _tridiag_cholesky, _tridiag_solve)
    rng = np.random.RandomState(0)
    for K0, S, m in [(1, 6, 2), (5, 9, 3), (16, 12, 4), (63, 6, 2)]:
        A = np.zeros((K0, S, S), np.float32)
        B = np.zeros((K0, S, S), np.float32)
        for k in range(K0):
            M = rng.randn(S, S)
            A[k] = M @ M.T + S * np.eye(S)
            if k:
                B[k] = 0.3 * rng.randn(S, S)
        r = rng.randn(K0, S, m).astype(np.float32)
        Aj, Bj, rj = jnp.asarray(A), jnp.asarray(B), jnp.asarray(r)
        Ls, Cs = _tridiag_cholesky(Aj, Bj)
        x_scan = np.asarray(_tridiag_solve(Ls, Cs, rj))
        x_cr = np.asarray(cr_solve_tridiag(cr_factor_tridiag(Aj, Bj), rj))
        np.testing.assert_allclose(x_cr, x_scan, rtol=2e-4, atol=2e-5)


def test_lm_band_cr_matches_scan():
    """The full band LM with the cyclic-reduction backend lands on the
    same map as the scan backend."""
    solver, x, graph = _setup(n=12, seed=5)
    layout = solver._layout
    fixed = solver._fixed_mask()
    params = LMParams()
    r_scan = lm_solve_banded(x, graph, fixed, params=params, layout=layout,
                             superblock=4, method="scan")
    r_cr = lm_solve_banded(x, graph, fixed, params=params, layout=layout,
                           superblock=4, method="cr")
    np.testing.assert_allclose(float(r_cr.cost), float(r_scan.cost),
                               rtol=1e-3)
    np.testing.assert_allclose(np.asarray(r_cr.x), np.asarray(r_scan.x),
                               rtol=5e-3, atol=5e-4)


def test_inverse_node_columns_cr_matches_scan():
    """H^-1 node columns (the LC covariance path, matcher.py) through the
    cyclic-reduction backend match the scan backend, including the HITL
    Schur border — band_inverse_node_columns defaults to method='auto',
    which is CR at large N."""
    from nautilus_tpu.solve.band import band_inverse_node_columns

    solver, x, graph = _setup(with_hitl=True)
    layout = solver._layout
    sysb, _ = assemble_banded_system(x, graph, layout)
    n = layout.n
    L = sysb.num_lines
    fixed = jnp.repeat(jnp.arange(n + L) == 0, 3)
    cols = jnp.asarray([3 * 2, 3 * 2 + 1, 3 * 2 + 2,
                        3 * (n - 2), 3 * (n - 2) + 1], jnp.int32)
    X_scan = band_inverse_node_columns(sysb, fixed, cols,
                                       superblock=4, method="scan")
    X_cr = band_inverse_node_columns(sysb, fixed, cols,
                                     superblock=4, method="cr")
    np.testing.assert_allclose(np.asarray(X_cr), np.asarray(X_scan),
                               rtol=2e-3, atol=2e-4)


def test_band_plan_auto_resolution():
    """method='auto' picks the scan below CR_MIN_NODES and block cyclic
    reduction above (benchmarks/superblock_sweep.py runs the device A/B);
    superblock=None picks the per-backend measured best; explicit values
    pass through untouched."""
    from nautilus_tpu.solve.band import CR_MIN_NODES, resolve_band_plan
    assert resolve_band_plan(100, 3) == (16, "scan")
    assert resolve_band_plan(CR_MIN_NODES, 3) == (8, "cr")
    assert resolve_band_plan(CR_MIN_NODES, 12) == (12, "cr")  # >= bandwidth
    assert resolve_band_plan(50000, 3, superblock=32,
                             method="scan") == (32, "scan")
    assert resolve_band_plan(10, 3, method="cr") == (8, "cr")


def test_damped_band_solve_auto_is_cr_at_scale():
    """solve_damped_banded(method='auto') at N >= CR_MIN_NODES routes
    through cyclic reduction and matches the explicit scan backend on a
    synthetic SPD band (full-problem CR parity at small N is covered by
    test_lm_band_cr_matches_scan)."""
    import jax.numpy as jnp
    from nautilus_tpu.solve.band import (BandedSystem, CR_MIN_NODES,
                                         solve_damped_banded)
    n, w = CR_MIN_NODES, 2
    rng = np.random.RandomState(7)
    diag = np.tile(8.0 * np.eye(3, dtype=np.float32), (n, 1, 1))
    sym = 0.1 * rng.randn(n, 3, 3).astype(np.float32)
    diag += 0.5 * (sym + sym.transpose(0, 2, 1))
    band = 0.2 * rng.randn(w, n, 3, 3).astype(np.float32)
    for d in range(1, w + 1):
        band[d - 1, :d] = 0.0  # block (i, i-d) undefined for i < d
    g = rng.randn(n, 3).astype(np.float32)
    sys = BandedSystem(diag=jnp.asarray(diag), band=jnp.asarray(band),
                       g=jnp.asarray(g), C=None, E=None, gl=None)
    fixed = jnp.zeros(3 * n, bool).at[:3].set(True)
    radius = jnp.asarray(1e4, jnp.float32)
    dx_auto, _, _ = solve_damped_banded(sys, fixed, radius, LMParams())
    dx_scan, _, _ = solve_damped_banded(sys, fixed, radius, LMParams(),
                                        superblock=16, method="scan")
    np.testing.assert_allclose(np.asarray(dx_auto), np.asarray(dx_scan),
                               rtol=2e-3, atol=2e-4)


def test_staged_fused_sweep_matches_unstaged():
    """The staged fused sweep (early windows in a half-width program over
    the delta-major pair PREFIX, solver._staged_sweep_plan) must produce
    the same per-window costs and solution as the single full-width
    program: the dropped pairs were masked anyway, so the factor sets per
    window are identical."""
    from nautilus_tpu.core.luaconf import load_config_text
    state, _ = make_problem(num_nodes=24, world_kind="office",
                            num_beams=180, seed=5,
                            odom_noise_trans=0.03, odom_noise_rot=0.01)
    cfg = load_config_text(
        "translation_weight=1\nrotation_weight=1\n"
        "lidar_constraint_amount_min=1\nlidar_constraint_amount_max=4\n"
        "outlier_threshold=0.25")
    x0 = state.solution.copy()
    s_full = Solver(state, cfg, fused_sweep=True, staged_fused=False)
    st_full = s_full.solve_slam()
    sol_full = state.solution.copy()

    state.solution = x0.copy()
    s_staged = Solver(state, cfg, fused_sweep=True, staged_fused=True)
    plan = s_staged._staged_sweep_plan(1, 4, use_band=True)
    assert len(plan) == 2, "staging should be forced at this config"
    assert plan[0][4].w == 2 and plan[1][4].w == 4
    # Stage-1 pair prefix = all pairs with delta <= 2.
    assert plan[0][2].shape[0] == (24 - 1) + (24 - 2)
    st_staged = s_staged.solve_slam()

    assert len(st_staged.windows) == len(st_full.windows) == 4
    # Costs come from two different-shape compiled programs (half-width
    # prefix vs full-width), so XLA may fuse/FMA/tree-reduce the f32 cost
    # sum differently; the per-pair matches themselves are pinned bitwise
    # by test_pair_minor_layout_matches_oracle.  5e-5 ~ a few dozen ulps.
    for wf, ws in zip(st_full.windows, st_staged.windows):
        assert wf.window == ws.window
        np.testing.assert_allclose(ws.initial_cost, wf.initial_cost,
                                   rtol=5e-5)
        np.testing.assert_allclose(ws.final_cost, wf.final_cost, rtol=5e-5)
    np.testing.assert_allclose(state.solution, sol_full, rtol=1e-4,
                               atol=1e-5)


def test_staged_host_loop_matches_unstaged():
    """The HOST window loop honors the same staged plan (early windows
    associate over the half-width pair prefix with the narrow layout) and
    must match the unstaged host loop window for window."""
    from nautilus_tpu.core.luaconf import load_config_text
    state, _ = make_problem(num_nodes=24, world_kind="office",
                            num_beams=180, seed=5,
                            odom_noise_trans=0.03, odom_noise_rot=0.01)
    cfg = load_config_text(
        "translation_weight=1\nrotation_weight=1\n"
        "lidar_constraint_amount_min=1\nlidar_constraint_amount_max=4\n"
        "outlier_threshold=0.25")
    x0 = state.solution.copy()
    s_full = Solver(state, cfg, fused_sweep=False, staged_fused=False)
    st_full = s_full.solve_slam()
    sol_full = state.solution.copy()

    state.solution = x0.copy()
    s_staged = Solver(state, cfg, fused_sweep=False, staged_fused=True)
    st_staged = s_staged.solve_slam()
    assert len(st_staged.windows) == len(st_full.windows) == 4
    for wf, ws in zip(st_full.windows, st_staged.windows):
        assert wf.window == ws.window
        np.testing.assert_allclose(ws.final_cost, wf.final_cost, rtol=1e-5)
    np.testing.assert_allclose(state.solution, sol_full, rtol=1e-4,
                               atol=1e-5)


def test_staged_fused_declined_for_wide_odom_factors():
    """Densified odometry (deltas up to w_max, the post-HITL state) must
    disable staging: stage 1's narrower band cannot represent those
    factors."""
    from nautilus_tpu.core.luaconf import load_config_text
    state, _ = make_problem(num_nodes=20, world_kind="office",
                            num_beams=180, seed=5)
    cfg = load_config_text(
        "translation_weight=1\nrotation_weight=1\n"
        "lidar_constraint_amount_min=1\nlidar_constraint_amount_max=4\n"
        "outlier_threshold=0.25")
    i, j, trans, rot = state.odometry_factors
    i = np.concatenate([np.asarray(i), [0]])
    j = np.concatenate([np.asarray(j), [4]])
    trans = np.concatenate([np.asarray(trans),
                            [state.solution[4, :2] - state.solution[0, :2]]])
    rot = np.concatenate([np.asarray(rot),
                          [state.solution[4, 2] - state.solution[0, 2]]])
    state.odometry_factors = (i, j, trans, rot)
    s = Solver(state, cfg, staged_fused=True)
    plan = s._staged_sweep_plan(1, 4, use_band=True)
    assert len(plan) == 1, "delta-4 odometry factor must refuse w_mid=2"


def test_staged_fused_lc_width_rules():
    """In-band LC factors wider than w_mid decline staging (stage 1's band
    cannot hold them); LONG-RANGE LC factors (delta > w_max) do not — they
    ride the width-exempt Woodbury columns in both stages."""
    from nautilus_tpu.core.luaconf import load_config_text
    state, _ = make_problem(num_nodes=20, world_kind="office",
                            num_beams=180, seed=5)
    cfg = load_config_text(
        "translation_weight=1\nrotation_weight=1\n"
        "lidar_constraint_amount_min=1\nlidar_constraint_amount_max=4\n"
        "outlier_threshold=0.25")
    # delta-3 LC factor: in-band for w_max=4, too wide for w_mid=2.
    state.lc_factors.append((2, 5, np.zeros(2), 0.0, 1.0, 1.0))
    s = Solver(state, cfg, staged_fused=True)
    assert len(s._staged_sweep_plan(1, 4, use_band=True)) == 1

    state.lc_factors[:] = [(0, 15, np.zeros(2), 0.0, 1.0, 1.0)]
    s2 = Solver(state, cfg, staged_fused=True)
    assert len(s2._staged_sweep_plan(1, 4, use_band=True)) == 2


def test_lr_factor_cap_config_override():
    """The engine-extension key lr_factor_cap raises the Woodbury cap:
    a closure count above the default 341 stays on the exact band path
    when the key allows it, and lands on the same map as the dense
    solver."""
    from nautilus_tpu.core.luaconf import load_config_text
    from nautilus_tpu.ingest.synthetic import make_problem
    from nautilus_tpu.solve.solver import Solver

    base = ("translation_weight=1\nrotation_weight=1\n"
            "lidar_constraint_amount_min=1\nlidar_constraint_amount_max=2\n"
            "outlier_threshold=0.25\n")
    state, _ = make_problem(num_nodes=30, world_kind="building",
                            num_beams=240, seed=4,
                            odom_noise_trans=0.02, odom_noise_rot=0.008)
    rng = np.random.default_rng(1)
    for _ in range(360):   # > default cap 341
        s = int(rng.integers(1, 20))
        t = int(s + rng.integers(5, 29 - s))
        rel = state.solution[t] - state.solution[s]
        state.lc_factors.append((s, t, rel[:2].copy(), float(rel[2]),
                                 1.0, 1.0))
    x0 = state.solution.copy()

    s_default = Solver(state, load_config_text(base))
    assert s_default._resolve_solver() != "band"   # over the default cap
    s_raised = Solver(state, load_config_text(base + "lr_factor_cap=400\n"))
    assert s_raised._resolve_solver() == "band"
    st_band = s_raised.solve_slam()
    sol_band = state.solution.copy()

    state.solution = x0.copy()
    st_dense = Solver(state, load_config_text(base),
                      linear_solver="dense").solve_slam()
    np.testing.assert_allclose(st_band.final_cost, st_dense.final_cost,
                               rtol=1e-3)
    np.testing.assert_allclose(sol_band, state.solution, rtol=1e-3,
                               atol=1e-3)
