"""Matrix-free PCG LM: agreement with the dense Cholesky path."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nautilus_tpu.core.luaconf import load_config_text
from nautilus_tpu.ingest.synthetic import make_problem
from nautilus_tpu.solve.cg import CGParams, _hvp, _linearize, lm_solve_cg
from nautilus_tpu.solve.factors import assemble_normal_equations
from nautilus_tpu.solve.lm import fixed_pose_mask, lm_solve
from nautilus_tpu.solve.solver import Solver

CFG = """
translation_weight=1
rotation_weight=1
lidar_constraint_amount_min=1
lidar_constraint_amount_max=3
outlier_threshold=0.25
"""


@pytest.fixture(scope="module")
def setup():
    state, _ = make_problem(num_nodes=10, world_kind="room", num_beams=360,
                            seed=4, odom_noise_trans=0.02,
                            odom_noise_rot=0.01)
    cfg = load_config_text(CFG)
    solver = Solver(state, cfg)
    x = solver._current_x()
    graph = solver.build_graph(x, 3)
    return x, graph


def test_hvp_matches_dense(setup, rng):
    x, graph = setup
    H, g, cost = assemble_normal_equations(x, graph)
    terms, g2, diag, cost2 = _linearize(x, graph)
    np.testing.assert_allclose(np.asarray(g2), np.asarray(g), rtol=1e-4,
                               atol=1e-5)
    assert float(cost2) == pytest.approx(float(cost), rel=1e-5)
    v = jnp.asarray(rng.normal(size=g.shape), x.dtype)
    hv_dense = np.asarray(H @ v)
    hv_free = np.asarray(_hvp(terms, v, v.shape[0]))
    np.testing.assert_allclose(hv_free, hv_dense, rtol=1e-3, atol=1e-4)
    # Diagonal blocks match dense H.
    Hd = np.asarray(H)
    for p in range(x.shape[0]):
        np.testing.assert_allclose(np.asarray(diag)[p],
                                   Hd[3 * p:3 * p + 3, 3 * p:3 * p + 3],
                                   rtol=1e-4, atol=1e-5)


def test_cg_lm_matches_cholesky_lm(setup):
    x, graph = setup
    fixed = fixed_pose_mask(3 * x.shape[0])
    res_dense = lm_solve(x, graph, fixed)
    res_cg = lm_solve_cg(x, graph, fixed)
    assert float(res_cg.cost) == pytest.approx(float(res_dense.cost),
                                               rel=2e-3)
    np.testing.assert_allclose(np.asarray(res_cg.x), np.asarray(res_dense.x),
                               atol=1e-2)


def test_gauge_respected(setup):
    x, graph = setup
    fixed = fixed_pose_mask(3 * x.shape[0])
    res = lm_solve_cg(x, graph, fixed)
    np.testing.assert_allclose(np.asarray(res.x)[0], np.asarray(x)[0],
                               atol=1e-7)


def test_full_sweep_dense_vs_cg_agreement():
    """Whole growing-window solve through the Solver with each linear
    solver; final costs must agree (the suite-scale anchor;
    benchmarks/large_n.py runs N=2000-5000 on the device)."""
    cfg = load_config_text(CFG)
    final = {}
    for kind in ("dense", "cg"):
        state, _ = make_problem(num_nodes=64, world_kind="building",
                                num_beams=240, seed=6,
                                odom_noise_trans=0.02, odom_noise_rot=0.008)
        solver = Solver(state, cfg, linear_solver=kind)
        stats = solver.solve_slam()
        final[kind] = stats.final_cost
    assert final["cg"] == pytest.approx(final["dense"], rel=5e-3)


class TestBandPreconditioner:
    """Band-preconditioned CG: the inner preconditioner is the damped
    block-band Cholesky of the band-eligible factor subset, so with
    H = Hband + low-rank the preconditioned spectrum clusters at 1."""

    def _solver_with_lc(self, n_lr=8):
        state, _ = make_problem(num_nodes=40, world_kind="building",
                                num_beams=240, seed=4,
                                odom_noise_trans=0.02, odom_noise_rot=0.008)
        # Long-range loop closures at solution-consistent relative poses.
        for k in range(n_lr):
            s, t = 2 + k, 30 + k
            rel = state.solution[t] - state.solution[s]
            state.lc_factors.append((s, t, rel[:2].copy(), float(rel[2]),
                                     2.0, 2.0))
        return Solver(state, load_config_text(CFG), linear_solver="cg")

    def test_matches_jacobi_cg_and_collapses_iterations(self):
        from nautilus_tpu.solve.cg import _cg
        solver = self._solver_with_lc()
        x = solver._current_x()
        fixed = solver._fixed_mask()
        w = 3
        graph = solver.build_graph(x, w)
        bg = solver.build_graph(x, w, exclude_long_range=True)
        assert solver._odom_within_band()

        res_j = lm_solve_cg(x, graph, fixed)
        res_b = lm_solve_cg(x, graph, fixed, band_graph=bg,
                            layout=solver._layout)
        assert float(res_b.cost) == pytest.approx(float(res_j.cost),
                                                  rel=1e-3)
        np.testing.assert_allclose(np.asarray(res_b.x),
                                   np.asarray(res_j.x), rtol=1e-3,
                                   atol=1e-3)

        # Inner-iteration collapse on one damped system: count matvecs.
        from nautilus_tpu.solve.cg import _linearize
        import jax.numpy as jnp
        import jax
        terms, g, diag, _ = _linearize(x, graph)
        n_dof = 3 * x.shape[0]

        def count_iters(precond_kind):
            calls = [0]

            def matvec(v):
                calls[0] += 1
                from nautilus_tpu.solve.cg import _hvp
                return _hvp(terms, v, n_dof) + 1e-4 * v

            if precond_kind == "jacobi":
                from nautilus_tpu.solve.cg import _inv3x3
                inv = _inv3x3(diag + 1e-4 * jnp.eye(3, dtype=x.dtype))
                precond = lambda v: jnp.einsum(
                    "mij,mj->mi", inv,
                    v.reshape(-1, 3)).reshape(-1)
            else:
                from nautilus_tpu.solve.band import (_apply_gauge_band,
                                                     band_apply_inverse,
                                                     band_factor)
                from nautilus_tpu.solve.factors import \
                    assemble_banded_system
                sysb, _ = assemble_banded_system(x, bg, solver._layout)
                sysg = _apply_gauge_band(sysb, fixed)
                n_nodes = solver._layout.n
                dsys = sysg._replace(diag=sysg.diag + 1e-4 * jnp.eye(
                    3, dtype=x.dtype)[None])
                fac = band_factor(dsys, max(16, solver._layout.w))

                def precond(v):
                    zn = band_apply_inverse(
                        fac, v[:3 * n_nodes].reshape(n_nodes, 3))
                    return jnp.concatenate(
                        [zn.reshape(-1), v[3 * n_nodes:]])
            b = -np.asarray(g)
            b[:3] = 0.0
            # Run eagerly (no jit) so the python counter ticks per iter.
            from nautilus_tpu.solve import cg as cg_mod
            x_sol = None
            with jax.disable_jit():
                x_sol = cg_mod._cg(matvec, precond, jnp.asarray(b, x.dtype),
                                   200, 1e-6)
            return calls[0]

        it_jacobi = count_iters("jacobi")
        it_band = count_iters("band")
        # Measured ~2x fewer inner iterations (59 vs 117 on this
        # fixture); each remaining iteration also halves the dominant
        # matvec work.  Whether the added band-solve latency pays for
        # itself ON DEVICE is benchmarks/cg_band_precond_bench.py's
        # question.
        assert it_band < 0.7 * it_jacobi, (it_band, it_jacobi)

    def test_solver_auto_uses_band_precond_when_eligible(self):
        solver = self._solver_with_lc()
        stats = solver.solve_slam()
        assert np.isfinite(stats.final_cost)
        for ws in stats.windows:
            assert ws.final_cost <= ws.initial_cost + 1e-6


class TestCGStepTolerance:
    """lm_solve_cg honors LMParams.step_tolerance (the
    accuracy_change_stop_threshold stop the dense/band bodies implement
    — same contract, lm.mean_step_metric)."""

    def test_large_threshold_collapses_iterations(self, setup):
        from nautilus_tpu.solve.lm import LMParams
        x, graph = setup
        fixed = fixed_pose_mask(3 * x.shape[0])
        free = lm_solve_cg(x, graph, fixed)
        stop = lm_solve_cg(x, graph, fixed,
                           params=LMParams(step_tolerance=1e9))
        # Huge tolerance: converged on the first accepted step.
        assert int(stop.iterations) < int(free.iterations)
        assert bool(stop.converged)
        assert float(stop.cost) < float(stop.initial_cost)


def test_mean_step_metric_ignores_padded_slots():
    """step_dof restricts the mean to node dof: padded HITL line-pose
    slots (structurally zero) must not dilute the criterion (parity with
    the CPU twin's nodes-only np.mean, cpu_reference.py lm_solve)."""
    from nautilus_tpu.solve.lm import LMParams, mean_step_metric
    dx = jnp.concatenate([jnp.full((30,), 2.0), jnp.zeros((24,))])
    diluted = mean_step_metric(dx, LMParams())
    nodes_only = mean_step_metric(dx, LMParams(step_dof=30))
    assert float(nodes_only) == pytest.approx(2.0)
    assert float(diluted) == pytest.approx(2.0 * 30 / 54)
