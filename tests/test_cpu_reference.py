"""CPU reference engine: analytic Jacobians vs JAX autodiff, and the
<=1% final-cost parity bar between the two engines (BASELINE.md target)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nautilus_tpu.baseline import cpu_reference as cpu
from nautilus_tpu.core.luaconf import load_config_text
from nautilus_tpu.ingest.synthetic import make_problem
from nautilus_tpu.solve.factors import normal_residual, point_residual
from nautilus_tpu.solve.solver import Solver

CFG = """
translation_weight=1
rotation_weight=1
lidar_constraint_amount_min=1
lidar_constraint_amount_max=3
outlier_threshold=0.25
"""


def test_analytic_jacobians_match_autodiff(rng):
    """CPU engine's hand-derived Jacobians == JAX jacfwd of the residuals."""
    xs = rng.normal(size=3)
    xt = rng.normal(size=3)
    pts = rng.normal(size=(4, 2))
    tgt = rng.normal(size=(4, 2))
    ns = rng.normal(size=(4, 2))
    nt_ = rng.normal(size=(4, 2))
    x = np.stack([xs, xt])
    c = dict(s=0, t=1, src_pts=pts, tgt_pts=tgt, src_nrm=ns, tgt_nrm=nt_)

    for kind, fn in (("point", point_residual), ("normal", normal_residual)):
        r_cpu, Js_cpu, Jt_cpu = cpu._corr_residual_jac(x, c, kind)
        mask = jnp.ones(4, bool)
        if kind == "point":
            f = lambda a, b: point_residual(a, b, jnp.asarray(pts),
                                            jnp.asarray(tgt), mask).ravel()
        else:
            f = lambda a, b: normal_residual(
                a, b, jnp.asarray(pts), jnp.asarray(tgt), jnp.asarray(ns),
                jnp.asarray(nt_), mask)[:, ::-1].ravel()
            # JAX orders [r_tgt, r_src] per slot; CPU orders [r1=tgt, r2=src]
            # interleaved the same way -> compare after matching order.
        r_jax = np.asarray(f(jnp.asarray(xs), jnp.asarray(xt)), np.float64)
        Js_jax = np.asarray(jax.jacfwd(f, 0)(jnp.asarray(xs), jnp.asarray(xt)))
        Jt_jax = np.asarray(jax.jacfwd(f, 1)(jnp.asarray(xs), jnp.asarray(xt)))
        if kind == "normal":
            # CPU stacks [r1, r2] per point; JAX [:, ::-1] gives [r_src, r_tgt]
            # -> reorder CPU to the same interleave for comparison.
            order = np.arange(len(r_cpu)).reshape(-1, 2)[:, ::-1].ravel()
            r_cpu, Js_cpu, Jt_cpu = r_cpu[order], Js_cpu[order], Jt_cpu[order]
        np.testing.assert_allclose(r_cpu, r_jax, atol=1e-5)
        np.testing.assert_allclose(Js_cpu, Js_jax, atol=1e-5)
        np.testing.assert_allclose(Jt_cpu, Jt_jax, atol=1e-5)


def test_engines_cost_parity():
    """Device engine and CPU f64 engine agree on final cost <=1%."""
    state, _ = make_problem(num_nodes=10, world_kind="room", num_beams=360,
                            seed=11, odom_noise_trans=0.02,
                            odom_noise_rot=0.01)
    cfg = load_config_text(CFG)
    x0 = state.solution.copy()

    # JAX engine.
    solver = Solver(state, cfg)
    jax_stats = solver.solve_slam()

    # CPU engine from the same initial state.
    prob = cpu.CpuProblem.from_device_problem(state.problem)
    x_cpu, cpu_stats = cpu.solve_slam(prob, x0, cfg)

    # Evaluate BOTH solutions under the CPU engine's f64 cost at the final
    # window's correspondences to compare like with like.
    w = cfg.get_int("lidar_constraint_amount_max")
    planar, edge = cpu.associate(prob, x_cpu, w, cfg.outlier_threshold)
    cost_cpu = cpu.total_cost(prob, x_cpu, planar, edge, 1.0, 1.0)
    planar_j, edge_j = cpu.associate(prob, state.solution, w,
                                     cfg.outlier_threshold)
    cost_jax = cpu.total_cost(prob, state.solution, planar_j, edge_j, 1.0, 1.0)
    assert cost_jax == pytest.approx(cost_cpu, rel=0.01), (
        f"jax={cost_jax} cpu={cost_cpu}")


def test_cpu_solver_reduces_cost():
    state, gt = make_problem(num_nodes=8, world_kind="room", num_beams=360,
                             seed=2, odom_noise_trans=0.03,
                             odom_noise_rot=0.01)
    cfg = load_config_text(CFG)
    prob = cpu.CpuProblem.from_device_problem(state.problem)
    x0 = state.solution.copy()
    planar, edge = cpu.associate(prob, x0, 2, 0.25)
    c0 = cpu.total_cost(prob, x0, planar, edge, 1.0, 1.0)
    x, stats = cpu.solve_slam(prob, x0, cfg)
    planar, edge = cpu.associate(prob, x, 3, 0.25)
    c1 = cpu.total_cost(prob, x, planar, edge, 1.0, 1.0)
    assert stats.final_cost < c0 or c1 < c0
