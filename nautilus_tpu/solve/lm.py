"""Levenberg-Marquardt trust-region solver on dense normal equations.

The device replacement for ceres::Solve with SPARSE_SCHUR
(reference src/optimization/solver.cc:266-275, 354).  The update strategy
mirrors Ceres' LevenbergMarquardtStrategy and default Solver::Options so a
CPU Ceres-parity implementation converges to the same cost:

- solve (H + diag(clip(diag(H))) / radius) dx = -g   (LM-scaled damping)
- step quality rho = actual_decrease / model_decrease
- accept when rho > min_relative_decrease (1e-3); radius grows by
  1 / max(1/3, 1 - (2 rho - 1)^3), shrink-divisor resets to 2
- reject: radius /= divisor, divisor *= 2
- terminate on max iterations (50), function tolerance
  |dcost| <= 1e-6 * cost on accepted steps, or radius underflow.

Gauge freedom is removed by a per-dof ``fixed`` mask (pose 0 by default,
as in reference AddOdomFactors solver.cc:384-386): fixed rows/cols of H are
zeroed with a unit diagonal and the corresponding g entries cleared —
algebraically identical to Ceres' SetParameterBlockConstant.

The whole loop is one jitted lax.while_loop; a failed Cholesky surfaces as
non-finite dx and is handled as a rejected step (radius shrinks until the
damped system is positive definite).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from nautilus_tpu.solve.factors import FactorGraph, assemble_normal_equations, total_cost


class LMParams(NamedTuple):
    """Defaults mirror ceres::Solver::Options (Ceres 1.14)."""

    max_iterations: int = 50
    function_tolerance: float = 1e-6
    # Mean |dx| per accepted step below this -> converged (the config key
    # accuracy_change_stop_threshold: "scans change by, on average, less
    # than this during an entire minimization iteration" — declared but
    # unread in the reference; here it ends a window's LM loop early,
    # which saves per-iteration device time).
    # 0 disables.
    step_tolerance: float = 0.0
    # Number of leading dof entries the mean-step criterion averages over
    # (Solver passes 3 * num_nodes so padded HITL line-pose slots — which
    # are structurally zero — cannot dilute the mean; the CPU twin's
    # criterion is nodes-only, baseline/cpu_reference.py lm_solve).
    # 0 = average over the full dof vector.
    step_dof: int = 0
    min_relative_decrease: float = 1e-3
    initial_radius: float = 1e4
    max_radius: float = 1e16
    min_radius: float = 1e-32
    min_diagonal: float = 1e-6
    max_diagonal: float = 1e32


class LMResult(NamedTuple):
    x: jnp.ndarray            # [M, 3] solved poses
    cost: jnp.ndarray         # final cost
    initial_cost: jnp.ndarray
    iterations: jnp.ndarray   # accepted + rejected LM steps taken
    converged: jnp.ndarray    # bool: hit function tolerance


def _apply_gauge(H, g, fixed_dof):
    """Zero fixed rows/cols with unit diagonal; clear fixed gradient."""
    free = ~fixed_dof
    outer = free[:, None] & free[None, :]
    H = jnp.where(outer, H, 0.0)
    H = H + jnp.diag(fixed_dof.astype(H.dtype))
    g = jnp.where(fixed_dof, 0.0, g)
    return H, g


def _solve_damped(H, g, fixed_dof, radius, params: LMParams):
    """Solve (H + D/radius) dx = -g with Cholesky; NaNs signal failure."""
    Hg, gg = _apply_gauge(H, g, fixed_dof)
    d = jnp.clip(jnp.diag(Hg), params.min_diagonal, params.max_diagonal)
    # Keep the unit diagonal of fixed dofs undamped so dx stays 0 there.
    d = jnp.where(fixed_dof, 0.0, d)
    A = Hg + jnp.diag(d / radius)
    c, low = jsl.cho_factor(A)
    dx = jsl.cho_solve((c, low), -gg)
    return dx, Hg, gg


def mean_step_metric(dx, params: LMParams):
    """Mean |dx| for the step_tolerance stop, over the leading
    params.step_dof dof entries (node dof only when set by Solver —
    excludes padded line-pose slots); the one copy shared by the dense,
    banded, and CG LM bodies (parity with the CPU twin's np.mean)."""
    flat = dx.reshape(-1)
    k = params.step_dof if params.step_dof > 0 else flat.shape[0]
    return jnp.sum(jnp.abs(flat[:k])) / k


def _lm_cond(state, params: LMParams):
    (x, H, g, cost, radius, divisor, it, done) = state
    return (~done) & (it < params.max_iterations) & (radius > params.min_radius)


def _trust_region_update(cost, new_cost, model_decrease, step_finite,
                         radius, divisor, params: LMParams, dtype,
                         mean_step=None):
    """The Ceres LevenbergMarquardtStrategy accept/radius schedule — the
    ONE copy shared by the dense and band LM bodies (parity-critical).

    mean_step: mean |dx| of the trial step; with params.step_tolerance > 0
    an accepted step below it also counts as converged.

    Returns (accept, radius_new, divisor_new, converged)."""
    actual_decrease = cost - new_cost
    rho = actual_decrease / jnp.maximum(
        model_decrease, 1e-300 if dtype == jnp.float64 else 1e-30)
    accept = step_finite & (model_decrease > 0) \
        & (rho > params.min_relative_decrease)
    grow = 1.0 / jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
    radius_new = jnp.where(
        accept, jnp.minimum(radius * grow, params.max_radius),
        radius / divisor)
    divisor_new = jnp.where(accept, 2.0, divisor * 2.0)
    converged = accept & (jnp.abs(actual_decrease)
                          <= params.function_tolerance * cost)
    if params.step_tolerance > 0 and mean_step is not None:
        converged = converged | (accept & (mean_step
                                           <= params.step_tolerance))
    return accept, radius_new, divisor_new, converged


def _lm_body(state, assemble_fn, cost_fn, fixed_dof, params: LMParams):
    """One LM trust-region step (pure; shared by the fused while_loop and
    the host-stepped per-iteration-visualization mode)."""
    (x, H, g, cost, radius, divisor, it, done) = state
    m = x.shape[0]
    dx, Hg, gg = _solve_damped(H, g, fixed_dof, radius, params)
    x_new = x + dx.reshape(m, 3)
    new_cost = cost_fn(x_new)
    # Model decrease of 0.5|r + J dx|^2: -(g.dx + 0.5 dx.H.dx).
    model_decrease = -(jnp.dot(gg, dx, precision=jax.lax.Precision.HIGHEST)
                       + 0.5 * jnp.dot(dx, jnp.matmul(
                           Hg, dx, precision=jax.lax.Precision.HIGHEST)))
    finite = jnp.all(jnp.isfinite(dx)) & jnp.isfinite(new_cost)
    accept, radius_new, divisor_new, converged = _trust_region_update(
        cost, new_cost, model_decrease, finite, radius, divisor, params,
        x.dtype, mean_step=mean_step_metric(dx, params))

    # Re-assemble only on accepted steps.
    H2, g2, cost2 = jax.lax.cond(
        accept, assemble_fn, lambda _: (H, g, cost), x_new)
    x2 = jnp.where(accept, x_new, x)
    return (x2, H2, g2, cost2, radius_new, divisor_new, it + 1, converged)


def _lm_init(x0, assemble_fn, params: LMParams):
    dtype = x0.dtype
    H0, g0, cost0 = assemble_fn(x0)
    return (x0, H0, g0, cost0,
            jnp.asarray(params.initial_radius, dtype),
            jnp.asarray(2.0, dtype), jnp.asarray(0, jnp.int32),
            jnp.asarray(False))


def lm_loop(x0, assemble_fn, cost_fn, fixed_dof,
            params: LMParams = LMParams()) -> LMResult:
    """LM loop over pluggable assembly/cost functions (for sharded variants).

    assemble_fn(x) -> (H, g, cost); cost_fn(x) -> cost.  Both must be pure
    and jit-traceable; the caller jits the whole loop.
    """
    init = _lm_init(x0, assemble_fn, params)
    cost0 = init[3]
    (x, H, g, cost, radius, divisor, it, done) = jax.lax.while_loop(
        lambda s: _lm_cond(s, params),
        lambda s: _lm_body(s, assemble_fn, cost_fn, fixed_dof, params),
        init)
    return LMResult(x=x, cost=cost, initial_cost=cost0, iterations=it,
                    converged=done)


@functools.partial(jax.jit, static_argnames=("params", "layout"))
def lm_solve(x0, graph: FactorGraph, fixed_dof,
             params: LMParams = LMParams(), layout=None) -> LMResult:
    """Run LM to convergence from x0 [M, 3] (single-device assembly).

    fixed_dof: [3M] bool — gauge-fixed degrees of freedom.  Factor weights
    live inside the graph (OdomFactors.wt/wr).  layout: optional static
    factors.BandLayout enabling scatter-free banded assembly (requires
    delta-major correspondence order).
    """
    return lm_loop(
        x0,
        assemble_fn=lambda x: assemble_normal_equations(x, graph, layout),
        cost_fn=lambda x: total_cost(x, graph),
        fixed_dof=fixed_dof, params=params)


@functools.partial(jax.jit, static_argnames=("params", "layout"))
def _lm_init_jit(x0, graph: FactorGraph, params: LMParams, layout=None):
    return _lm_init(x0, lambda x: assemble_normal_equations(x, graph, layout),
                    params)


@functools.partial(jax.jit, static_argnames=("params", "layout"))
def _lm_step_jit(state, graph: FactorGraph, fixed_dof, params: LMParams,
                 layout=None):
    return _lm_body(state,
                    lambda x: assemble_normal_equations(x, graph, layout),
                    lambda x: total_cost(x, graph), fixed_dof, params)


def _lm_body_banded(state, assemble_fn, fixed_dof, params: LMParams,
                    superblock=None, method: str = "auto"):
    """One LM step on a block-banded system (solve/band.py): identical
    trust-region schedule to _lm_body, but the damped solve is a block
    tridiagonal Cholesky and H is never dense."""
    from nautilus_tpu.solve.band import band_matvec, solve_damped_banded

    (x, sys, cost, radius, divisor, it, done) = state
    dx, dxl, sysg = solve_damped_banded(sys, fixed_dof, radius, params,
                                        superblock, method)
    step = dx if dxl is None else jnp.concatenate([dx, dxl], axis=0)
    x_new = x + step
    # Assemble at the trial point UNCONDITIONALLY and use ITS cost for the
    # accept decision: the linearization residuals are the same quantity
    # total_cost evaluates, so the separate cost-only pass of the dense
    # body is redundant work here.  On rejection the new system is simply
    # discarded (a select over the small band carry) — cheaper than the
    # dense body's evaluate-then-conditionally-assemble whenever the
    # accept rate exceeds ~50%, which a converging LM run always does.
    sys_new, new_cost = assemble_fn(x_new)
    Hdx, Hdxl = band_matvec(sysg, dx, dxl)
    gdx = jnp.sum(sysg.g * dx)
    dHd = jnp.sum(dx * Hdx)
    if dxl is not None:
        gdx = gdx + jnp.sum(sysg.gl * dxl)
        dHd = dHd + jnp.sum(dxl * Hdxl)
    model_decrease = -(gdx + 0.5 * dHd)
    finite = jnp.all(jnp.isfinite(step)) & jnp.isfinite(new_cost)
    accept, radius_new, divisor_new, converged = _trust_region_update(
        cost, new_cost, model_decrease, finite, radius, divisor, params,
        x.dtype, mean_step=mean_step_metric(step, params))

    sys2 = jax.tree.map(
        lambda a, b: jnp.where(accept, a, b), sys_new, sys)
    cost2 = jnp.where(accept, new_cost, cost)
    x2 = jnp.where(accept, x_new, x)
    return (x2, sys2, cost2, radius_new, divisor_new, it + 1, converged)


def lm_loop_banded(x0, assemble_fn, fixed_dof,
                   params: LMParams = LMParams(),
                   superblock=None, method: str = "auto") -> LMResult:
    """LM loop where assemble_fn(x) -> (BandedSystem, cost).  The loop
    carry holds the O(N w) band instead of the O(N^2) dense H — both
    faster (no dense materialization/copies per iteration) and the key
    to solving pose graphs far beyond the dense memory wall.

    No cost_fn: the accept decision reuses the cost returned by
    assembling at the trial point (see _lm_body_banded), so a separate
    cost-only evaluation would be dead work."""
    sys0, cost0 = assemble_fn(x0)
    state = (x0, sys0, cost0,
             jnp.asarray(params.initial_radius, x0.dtype),
             jnp.asarray(2.0, x0.dtype), jnp.asarray(0, jnp.int32),
             jnp.asarray(False))

    def cond(s):
        (x, sys, cost, radius, divisor, it, done) = s
        return (~done) & (it < params.max_iterations) \
            & (radius > params.min_radius)

    state = jax.lax.while_loop(
        cond,
        lambda s: _lm_body_banded(s, assemble_fn, fixed_dof,
                                  params, superblock, method),
        state)
    (x, sys, cost, radius, divisor, it, done) = state
    return LMResult(x=x, cost=cost, initial_cost=cost0, iterations=it,
                    converged=done)


@functools.partial(jax.jit, static_argnames=("params", "layout",
                                             "superblock", "analytic",
                                             "method"))
def lm_solve_banded(x0, graph: FactorGraph, fixed_dof,
                    params: LMParams = LMParams(), layout=None,
                    superblock=None, analytic: bool = True,
                    lr=None, method: str = "auto") -> LMResult:
    """Run LM to convergence with the block-band linear solver.

    Requires the delta-major correspondence layout and every in-graph
    odometry factor within the band (|i - j| <= layout.w); HITL line
    poses are handled as a dense border, and long-range loop-closure
    factors go in via ``lr`` (an OdomFactors batch) as a low-rank
    Woodbury term — NOT via graph.odom.  analytic=False falls back to
    jacfwd linearization (see Solver.solve_slam for where that matters).
    """
    from nautilus_tpu.solve.factors import assemble_banded_system
    return lm_loop_banded(
        x0,
        assemble_fn=lambda x: assemble_banded_system(x, graph, layout,
                                                     analytic, lr),
        fixed_dof=fixed_dof, params=params, superblock=superblock,
        method=method)


def lm_solve_stepped(x0, graph: FactorGraph, fixed_dof,
                     params: LMParams = LMParams(),
                     iteration_callback=None, layout=None) -> LMResult:
    """LM driven one jitted step at a time from the host, invoking
    iteration_callback(x, cost, iteration) after every step.

    The opt-in equivalent of the reference's per-iteration redraw
    (ceres::IterationCallback, solver_vis.h:18-22).  Identical update
    schedule to lm_solve — same _lm_body — but pays one dispatch per LM
    iteration, so it is a debugging mode, not the production path.  Host
    stepping (rather than jax.debug.callback inside the fused loop) was
    chosen for an earlier runtime without host callbacks; a callback
    version is to be re-tested on the GPU (ROADMAP.md section 3,
    accelerator fault workarounds).
    """
    state = _lm_init_jit(x0, graph, params, layout)
    cost0 = state[3]
    while bool(_lm_cond(state, params)):
        state = _lm_step_jit(state, graph, fixed_dof, params, layout)
        if iteration_callback is not None:
            (x, _, _, cost, _, _, it, _) = state
            iteration_callback(x, cost, int(it))
    (x, H, g, cost, radius, divisor, it, done) = state
    return LMResult(x=x, cost=cost, initial_cost=cost0, iterations=it,
                    converged=done)


def fixed_pose_mask(num_dofs_poses: int, fixed_pose: int = 0) -> jnp.ndarray:
    """[3M] mask fixing one pose's 3 dofs (gauge)."""
    mask = jnp.zeros((num_dofs_poses,), bool)
    return mask.at[3 * fixed_pose: 3 * fixed_pose + 3].set(True)
