"""float64 device-solve escape hatch (SURVEY.md §7 hard part (b)).

Ceres optimizes in doubles; the device engine defaults to f32 (+HIGHEST
matmuls) and holds <=1% parity.  ``solver_dtype="float64"`` runs the whole
device program in f64 (slower on the device) for any dataset that ever
breaks f32 parity.  These tests pin the plumbing and the parity claim.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nautilus_tpu.core.luaconf import load_config_text
from nautilus_tpu.core.problem import resolve_solver_dtype
from nautilus_tpu.solve.solver import Solver

CFG = """
translation_weight=1
rotation_weight=1
lidar_constraint_amount_min=1
lidar_constraint_amount_max=3
outlier_threshold=0.25
"""


@pytest.fixture
def x64():
    """Enable jax x64 for a test, restoring the suite default after."""
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def test_resolve_dtype_names():
    assert resolve_solver_dtype("float32") == jnp.float32
    with pytest.raises(ValueError):
        resolve_solver_dtype("bfloat16")


def test_resolve_float64_enables_x64():
    try:
        dt = resolve_solver_dtype("float64")
        assert dt == jnp.float64
        assert jax.config.jax_enable_x64
        assert jnp.zeros(1, jnp.float64).dtype == jnp.float64
    finally:
        jax.config.update("jax_enable_x64", False)


def _solve(dtype):
    from nautilus_tpu.ingest.synthetic import make_problem
    state, _ = make_problem(num_nodes=14, world_kind="building",
                            num_beams=240, seed=3, dtype=dtype,
                            odom_noise_trans=0.02, odom_noise_rot=0.008,
                            pad_multiple=128)
    cfg = load_config_text(CFG)
    solver = Solver(state, cfg)
    solver.solve_slam()
    return state


def test_f64_device_solve_parity(x64):
    """An f64 device solve matches the f64 CPU twin's final cost closely
    (same arithmetic precision as Ceres), and stays within the 1% bar."""
    from nautilus_tpu.baseline import cpu_reference as cpu

    state64 = _solve(jnp.float64)
    assert np.asarray(state64.problem.points).dtype == np.float64

    prob_cpu = cpu.CpuProblem.from_device_problem(state64.problem)
    x0 = np.asarray(state64.problem.initial_poses, np.float64)
    cfg = load_config_text(CFG)
    x_cpu, _ = cpu.solve_slam(prob_cpu, x0, cfg)

    def f64_cost(x):
        planar, edge = cpu.associate(prob_cpu, x, 3, 0.25)
        return cpu.total_cost(prob_cpu, x, planar, edge, 1.0, 1.0)

    c_dev = f64_cost(state64.solution)
    c_cpu = f64_cost(x_cpu)
    assert abs(c_dev - c_cpu) / c_cpu < 0.01
