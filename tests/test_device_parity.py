"""On-device parity lane: the device-specific checks the CPU suite can't make.

Run on a machine with a GPU:

    NAUTILUS_DEVICE_TESTS=1 python -m pytest tests -m device -q

(or `make test-device`; `chip_smoke.py` runs the same lane in its own
process).  Every test here is marked ``device`` and skips, with a reason,
unless the switch is set and JAX's default backend is an accelerator, so
the default CPU suite skips them.  Whether a device exists is decided in a
fixture, at run time: never while the module is imported, so every
pytest-xdist worker collects the same tests.  The lane exists because
device-specific faults (a kernel fault in a fused program, precision that
differs from the CPU's) are invisible to the CPU-forced suite.

Each test uses small fixed shapes so first-run compiles stay short.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from nautilus_tpu.core.luaconf import load_config_text
from nautilus_tpu.ingest.synthetic import make_problem
from nautilus_tpu.solve.solver import Solver

pytestmark = pytest.mark.device

DEFAULTS = """
translation_weight=1
rotation_weight=1
lidar_constraint_amount_min=1
lidar_constraint_amount_max=3
outlier_threshold=0.25
"""


@pytest.fixture(autouse=True)
def _require_device():
    if os.environ.get("NAUTILUS_DEVICE_TESTS") != "1":
        pytest.skip("on-device lane: set NAUTILUS_DEVICE_TESTS=1 on a "
                    "machine with a GPU")
    platform = jax.devices()[0].platform
    if platform == "cpu":
        pytest.skip("on-device lane: JAX found no accelerator")


@pytest.fixture(scope="module")
def solved_setup():
    state, _ = make_problem(num_nodes=10, world_kind="room", num_beams=240,
                            seed=3, odom_noise_trans=0.03,
                            odom_noise_rot=0.01)
    cfg = load_config_text(DEFAULTS)
    solver = Solver(state, cfg)
    x = solver._current_x()
    graph = solver.build_graph(x, window=3)
    return solver, x, graph


def test_band_vs_dense_on_device(solved_setup):
    """Damped band solve == dense solve on the device (guards against
    device-specific lowering differences in the scan factorization)."""
    from nautilus_tpu.solve.band import solve_damped_banded
    from nautilus_tpu.solve.factors import (assemble_banded_system,
                                            assemble_normal_equations)
    from nautilus_tpu.solve.lm import LMParams, _solve_damped
    solver, x, graph = solved_setup
    layout = solver._layout
    fixed = solver._fixed_mask()
    H, g, c_dense = assemble_normal_equations(x, graph, layout)
    sysb, c_band = assemble_banded_system(x, graph, layout)
    np.testing.assert_allclose(float(c_band), float(c_dense), rtol=1e-5)
    r = jnp.asarray(1e4, x.dtype)
    dx_dense, _, _ = _solve_damped(H, g, fixed, r, LMParams())
    dx, dxl, _ = solve_damped_banded(sysb, fixed, r, LMParams(),
                                     superblock=4)
    np.testing.assert_allclose(np.asarray(dx).reshape(-1),
                               np.asarray(dx_dense), rtol=1e-2, atol=1e-4)


def test_fused_vs_host_loop_on_device():
    """The fused whole-sweep program and the host window loop land on the
    same map on device."""
    state, _ = make_problem(num_nodes=10, world_kind="room", num_beams=240,
                            seed=5, odom_noise_trans=0.03,
                            odom_noise_rot=0.01)
    cfg = load_config_text(DEFAULTS)
    x0 = state.solution.copy()
    s_fused = Solver(state, cfg, fused_sweep=True)
    st_fused = s_fused.solve_slam()
    sol_fused = state.solution.copy()
    state.solution = x0.copy()
    s_host = Solver(state, cfg, fused_sweep=False)
    st_host = s_host.solve_slam()
    np.testing.assert_allclose(st_host.final_cost, st_fused.final_cost,
                               rtol=1e-3)
    np.testing.assert_allclose(state.solution, sol_fused, rtol=5e-3,
                               atol=1e-3)


def test_analytic_vs_jacfwd_on_device(solved_setup):
    """Closed-form Jacobians == jacfwd on the device."""
    from nautilus_tpu.solve.factors import (graph_factor_specs,
                                            linearize_two_pose,
                                            linearize_two_pose_jacfwd)
    solver, x, graph = solved_setup
    for (a, b, fn, data) in graph_factor_specs(graph):
        t_an = linearize_two_pose(x, a, b, fn, data, analytic=True)
        t_fw = linearize_two_pose_jacfwd(x, a, b, fn, data)
        if t_an is None:
            assert t_fw is None
            continue
        np.testing.assert_allclose(np.asarray(t_an[0]), np.asarray(t_fw[0]),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(t_an[1]), np.asarray(t_fw[1]),
                                   rtol=1e-3, atol=1e-3)


def test_f64_escape_hatch_on_device():
    """solver_dtype=float64 runs the f64 device path end to end.

    Kept to ONE tiny jitted LM solve (not a full sweep) to bound the
    compile; it still exercises assembly, Cholesky and the trust region in
    f64."""
    from nautilus_tpu.solve.lm import lm_solve
    jax.config.update("jax_enable_x64", True)
    try:
        state, _ = make_problem(num_nodes=5, world_kind="room",
                                num_beams=90, seed=2, dtype=jnp.float64,
                                pad_multiple=64)
        cfg = load_config_text(DEFAULTS)
        solver = Solver(state, cfg)
        assert solver._dtype() == jnp.float64
        x = solver._current_x()
        assert x.dtype == jnp.float64
        graph = solver.build_graph(x, window=2)
        res = lm_solve(x, graph, solver._fixed_mask(),
                       params=solver.lm_params, layout=solver._layout)
        assert res.x.dtype == jnp.float64
        assert float(res.cost) <= float(res.initial_cost) + 1e-12
        assert np.all(np.isfinite(np.asarray(res.x)))
    finally:
        jax.config.update("jax_enable_x64", False)


def test_csm_rotation_center_on_device():
    """Angle-seeded CSM recovers a ~pi relative rotation on the device."""
    from nautilus_tpu.ingest.synthetic import (make_world, raycast,
                                               scan_to_points)
    from nautilus_tpu.kernels.csm import CSMParams, csm_match
    world = make_world("office")
    true_t = np.array([0.4, -0.3, np.pi * 0.97])
    pose_b = np.array([1.0, 2.0, 0.3])
    c, s = np.cos(pose_b[2]), np.sin(pose_b[2])
    ta = pose_b[:2] + np.array([[c, -s], [s, c]]) @ true_t[:2]
    pose_a = np.array([ta[0], ta[1], pose_b[2] + true_t[2]])
    cl_b = scan_to_points(raycast(world, pose_b, 720, max_range=10),
                          max_range=10)
    cl_a = scan_to_points(raycast(world, pose_a, 720, max_range=10),
                          max_range=10)

    def pad(cl):
        out = np.zeros((1024, 2), np.float32)
        m = np.zeros(1024, bool)
        out[:len(cl)] = cl
        m[:len(cl)] = True
        return jnp.asarray(out), jnp.asarray(m)

    a, ma = pad(cl_a)
    b, mb = pad(cl_b)
    score, tr = csm_match(a, ma, b, mb, CSMParams(scan_range=10.0),
                          rotation_center=jnp.asarray(true_t[2] + 0.15,
                                                      jnp.float32))
    tr = np.asarray(tr)
    d_th = np.arctan2(np.sin(tr[2] - true_t[2]), np.cos(tr[2] - true_t[2]))
    assert abs(d_th) < 0.05
    assert np.linalg.norm(tr[:2] - true_t[:2]) < 0.12


def test_analytic_fused_at_scale():
    """Closed-form Jacobians inside the fused whole-sweep graph at N=2000.

    An earlier einsum formulation of factors._linearize_normal_analytic
    faulted on an accelerator at this size; the elementwise formulation
    replaced it, so the fused path runs analytic at every scale.  This
    runs that configuration on the device and must complete with finite
    output.
    """
    state, _ = make_problem(num_nodes=2000, world_kind="building",
                            num_beams=360, seed=1)
    cfg = load_config_text(DEFAULTS)
    solver = Solver(state, cfg, fused_sweep=True)
    from nautilus_tpu.solve import solver as solver_mod
    from nautilus_tpu.solve.lm import LMParams
    out = solver_mod._fused_sweep(
        solver._current_x(), state.problem, solver._pair_src,
        solver._pair_tgt, solver._odom_factors(exclude_long_range=True),
        solver._hitl_factors(), solver._fixed_mask(),
        jnp.asarray(0.25, solver._dtype()), 1, 3, LMParams(),
        False, solver._layout, True, True, None)
    jax.block_until_ready(out)
    finite = bool(np.asarray(out[-1]))
    assert finite
