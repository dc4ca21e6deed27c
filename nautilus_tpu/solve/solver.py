"""High-level solver: the growing-window sweep over jitted LM solves.

Mirrors the reference Solver's solve lifecycle (src/optimization/solver.cc):

- SolveSLAM (solver.cc:358-368): draw, then OptimizeOverGrowingWindow with
  OptimizationType::FEATURE.
- OptimizeOverGrowingWindow (solver.cc:335-356): for window_size in
  [lidar_constraint_amount_min, lidar_constraint_amount_max], rebuild the
  problem (odometry factors + per-window lidar correspondences + HITL
  residuals) and solve.  Correspondences are recomputed once per window
  size, not per LM iteration — the reference's iterative-closest-line
  behavior (SURVEY.md §3.2 note) — which here means one `associate` call
  and one `lm_solve` call per window, all device-resident.
- The FEATURE branch of AddLidarResiduals (solver.cc:297-318): planar
  matches feed normal residuals, edge matches feed point residuals, both
  found by plain nearest-neighbor matching.

Deviation (documented): the reference redraws visualization every LM
iteration via a ceres::IterationCallback (solver_vis.h:18-22); that would
serialize the device loop, so visualization callbacks fire per window
sweep instead.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from nautilus_tpu.core.problem import SLAMState
from nautilus_tpu.solve import correspond
from nautilus_tpu.solve.factors import (FactorGraph, HitlFactors,
                                        OdomFactors, empty_hitl,
                                        make_odom_factors)
from nautilus_tpu.solve.lm import LMParams, LMResult, lm_solve


@dataclasses.dataclass
class WindowStats:
    window: int
    initial_cost: float
    final_cost: float
    iterations: int
    wall_s: float


@dataclasses.dataclass
class SolveStats:
    windows: List[WindowStats] = dataclasses.field(default_factory=list)

    @property
    def final_cost(self) -> float:
        return self.windows[-1].final_cost if self.windows else float("nan")

    @property
    def total_wall_s(self) -> float:
        return sum(w.wall_s for w in self.windows)


def odom_factors_from_state(state: SLAMState, dtype, tw, rw,
                            pad_to: int = 256,
                            lc_factors=None) -> OdomFactors:
    """Active odometry factors + any loop-closure factors, with weights.

    The factor count is padded to a multiple of ``pad_to`` with masked
    entries so that HITL's solved-odometry densification (which changes the
    count) does not force an XLA recompile of the LM program.
    """
    i, j, trans, rot = state.odometry_factors
    parts = [make_odom_factors(i, j, trans, rot, tw, rw, dtype)]
    lc = state.lc_factors if lc_factors is None else lc_factors
    for (li, lj, ltrans, lrot, lwt, lwr) in lc:
        parts.append(make_odom_factors([li], [lj], [ltrans], [lrot],
                                       lwt, lwr, dtype))
    od = parts[0] if len(parts) == 1 else OdomFactors(
        *[jnp.concatenate(cols, axis=0) for cols in zip(*parts)])
    count = od.i.shape[0]
    target = ((count + pad_to - 1) // pad_to) * pad_to
    if target == count:
        return od
    pad = target - count
    return OdomFactors(
        i=jnp.pad(od.i, (0, pad)), j=jnp.pad(od.j, (0, pad)),
        trans=jnp.pad(od.trans, ((0, pad), (0, 0))),
        rot=jnp.pad(od.rot, (0, pad)),
        mask=jnp.pad(od.mask, (0, pad)),  # False padding
        wt=jnp.pad(od.wt, (0, pad)), wr=jnp.pad(od.wr, (0, pad)))


class Solver:
    """Owns the optimization lifecycle for one SLAMState.

    The reference equivalent also owns ROS clients and visualization
    (solver.h:71-130); here IO/visualization are optional callbacks and the
    compute path is pure JAX.
    """

    def __init__(self, state: SLAMState, config, visualizer=None,
                 lm_params: Optional[LMParams] = None,
                 linear_solver: str = "auto",
                 use_normal_gate: bool = False,
                 per_iteration_viz: bool = False,
                 fused_sweep: Optional[bool] = None,
                 staged_fused: Optional[bool] = None,
                 assembly: Optional[str] = None,
                 mesh=None):
        """linear_solver: 'band' (block-band Cholesky, solve/band.py —
        the default: fastest at every scale, O(N w) memory; HITL line
        poses solve as a Schur border and long-range loop closures as a
        Woodbury low-rank term), 'dense' (dense Cholesky normal
        equations — only needed beyond the low-rank cap), 'cg'
        (matrix-free PCG, solve/cg.py), or 'auto' (band when eligible,
        else dense below the dense-H memory wall, else cg).

        use_normal_gate enables normal-similarity gating in correspondence
        search (the reference's GetPointToNormalMatching,
        solver.cc:177-260 — defined but unused in its hot path, so off by
        default for parity).

        per_iteration_viz: opt-in debugging mode redrawing the visualizer
        after EVERY LM iteration (the reference's ceres::IterationCallback
        behavior, solver_vis.h:18-22) instead of once per window.  Routes
        the solve through the host-loop path and ships poses to the host
        each step — for parity debugging, not production.

        mesh: a jax.sharding.Mesh with one 'factors' axis (e.g.
        parallel.sharded.default_mesh(n)).  When set, solve_slam /
        solve_max_window run the factor-sharded multi-chip sweep
        (parallel/sharded.py: per-shard association + assembly, one psum
        per LM step) and auto-LC's CSM batch shards over the pair dim.
        Product surface: config key ``mesh_devices`` or the CLI
        ``--devices`` flag (cli.py)."""
        self.state = state
        self.config = config
        self.visualizer = visualizer
        self.mesh = mesh
        # accuracy_change_stop_threshold -> LM mean-step stop (the key's
        # documented "scans change by, on average, less than this"
        # criterion; lm.LMParams.step_tolerance).
        self.lm_params = lm_params or LMParams(
            step_tolerance=float(
                config.get("accuracy_change_stop_threshold", 0.0)),
            # Mean-step averages node dof only (padded HITL line-pose
            # slots are structurally zero and would dilute it).
            step_dof=3 * state.num_nodes)
        self.use_normal_gate = use_normal_gate
        self.per_iteration_viz = per_iteration_viz and visualizer is not None
        self._viz_window = None
        # staged_fused: None = auto (split the fused sweep into a
        # half-width early-window program at device-bound scales, see
        # _staged_sweep_plan); False disables the split.
        self.staged_fused = staged_fused
        # assembly: None = auto, 'moments' = moment-form banded assembly
        # (J^T J / J^T r from per-point scalar reductions, J never
        # materialized — factors._MOMENTS), 'jacobian' = closed-form J +
        # einsum.  Auto resolves to 'moments' wherever the band layout
        # exists (see _analytic_mode).
        self.assembly = assembly
        # fused_sweep: None = auto (fused when eligible); False forces the
        # host window loop (one SMALL compiled program reused across
        # windows — the whole-sweep fused graph compiles slowly at large
        # N); True asserts eligibility.
        self.fused_sweep = fused_sweep
        n = state.num_nodes
        self.linear_solver = linear_solver
        w_max = config.get_int("lidar_constraint_amount_max")
        self.pairs = correspond.make_pairs(n, w_max)
        self._pair_src = jnp.asarray(self.pairs.src)
        self._pair_tgt = jnp.asarray(self.pairs.tgt)
        # Static band layout of the delta-major pair list: enables
        # scatter-free normal-equation assembly (factors.BandLayout).
        from nautilus_tpu.solve.factors import BandLayout
        w_eff = min(w_max, n - 1)
        self._layout = BandLayout(n, w_eff) if w_eff >= 1 else None

    # -- graph construction -------------------------------------------------

    # Long-range LC factors ride the band solver as a Woodbury low-rank
    # term; each contributes 3 columns, and the (R x R) Woodbury core is
    # solved dense, so cap the count (dense path takes over beyond it).
    # Default cap; per-instance override via the engine-extension config
    # key ``lr_factor_cap`` (each closure adds 3 Woodbury columns: the
    # (R x R) core solves dense and T = Hb^-1 U is [3N, 3R], so memory
    # grows linearly in N * cap — at N=20000 the default keeps T under
    # ~250 MB.  Raising it keeps the exact band path on closure-heavy
    # maps at the cost of that memory.)
    LR_FACTOR_CAP = 341   # 3 * 341 = 1023 columns

    def _split_lc(self):
        """state.lc_factors split into (in-band, long-range) by delta."""
        w = self._layout.w if self._layout is not None else 0
        in_b, lr = [], []
        for f in self.state.lc_factors:
            (in_b if abs(int(f[0]) - int(f[1])) <= w else lr).append(f)
        return in_b, lr

    def _odom_within_band(self) -> bool:
        """Every raw odometry factor couples nodes within |i-j| <= w."""
        if self._layout is None:
            return False
        i, j, _, _ = self.state.odometry_factors
        max_d = int(np.max(np.abs(np.asarray(i) - np.asarray(j)))) \
            if len(i) else 0
        return max_d <= self._layout.w

    def _band_eligible(self) -> bool:
        """Band solver applies when every ODOMETRY factor couples nodes
        within the correspondence band |i - j| <= layout.w.  HITL line
        poses solve as a dense border, and long-range loop-closure
        factors as a Woodbury low-rank term (up to LR_FACTOR_CAP)."""
        if not self._odom_within_band():
            return False
        _, lr = self._split_lc()
        cap = int(self.config.get("lr_factor_cap", self.LR_FACTOR_CAP))
        return len(lr) <= cap

    def _resolve_solver(self) -> str:
        """Per-solve linear-solver choice ('auto' depends on the current
        factor set, which LC events mutate).

        Block-band Cholesky where it applies (O(N w) memory — no
        ceiling); dense Cholesky for arbitrary factor topology up to the
        dense-H memory wall (~3 live (3N)^2 f32 copies, ~10 GB at
        N=10000); matrix-free PCG beyond that.  The N <= 8000 dense wall
        was set for an earlier accelerator's 16 GB and has not been
        re-derived for the H100's 80 GB yet (ROADMAP.md section 2,
        closure-heavy maps).
        """
        if self.linear_solver != "auto":
            if self.linear_solver == "band" and not self._band_eligible():
                # Out-of-band factor blocks cannot be represented: XLA
                # would silently DROP the out-of-bounds coupling scatter
                # while keeping gradient/cost — a wrong converged map, not
                # an error.  Refuse instead.
                raise ValueError(
                    "linear_solver='band' requires >= 2 nodes, every "
                    "odometry factor within |i - j| <= window max, and at "
                    "most LR_FACTOR_CAP long-range loop-closure factors "
                    "(they solve as a Woodbury low-rank term) — use "
                    "'dense' or 'auto'.")
            return self.linear_solver
        if self._band_eligible():
            return "band"
        return "dense" if self.state.num_nodes <= 8000 else "cg"

    def _dtype(self):
        return self.state.problem.points.dtype

    def _num_line_slots(self) -> int:
        """Line-pose slots padded to a bucket of 8: adding a HITL constraint
        then does NOT change the dof-vector length, so the compiled LM
        programs survive constraint accumulation.  Unused slots are
        gauge-fixed (no residual touches them either)."""
        L = len(self.state.line_poses)
        if L == 0:
            return 0
        b = 8
        while b < L:
            b *= 2
        return b

    def _current_x(self) -> jnp.ndarray:
        """[N + L_pad, 3] dof vector: node poses + HITL line poses."""
        slots = self._num_line_slots()
        L = len(self.state.line_poses)
        pad = np.zeros((slots - L, 3), np.float64)
        x = np.concatenate([self.state.solution, self.state.line_poses, pad],
                           axis=0)
        return jnp.asarray(x, self._dtype())

    def _fixed_mask(self) -> jnp.ndarray:
        n = self.state.num_nodes
        slots = self._num_line_slots()
        L = len(self.state.line_poses)
        mask = np.zeros((3 * (n + slots),), bool)
        mask[0:3] = True  # gauge: pose 0 constant (solver.cc:384-386)
        mask[3 * (n + L):] = True  # unused line-pose slots
        return jnp.asarray(mask)

    def _odom_factors(self, exclude_long_range: bool = False) -> OdomFactors:
        """Device odometry factors, cached across the window sweep (the
        factor list only changes on HITL/LC events).  With
        exclude_long_range, LC factors beyond the band go to
        _long_range_factors() instead (band-solver path).

        Padded to the session's high-water-mark bucket so that e.g. the
        HITL flow's second solve (back to sparse odometry) reuses the
        program compiled for the densified first solve — masked padding
        costs ~nothing next to the lidar residuals.
        """
        # Hold the factor tuple itself in the cache entry: identity compare
        # is then safe (the held reference prevents id reuse after gc).
        # LC factors are keyed by CONTENT (they are few and small): an
        # in-place replacement that keeps the count would otherwise serve
        # stale device factors.
        lc_key = tuple(
            (int(f[0]), int(f[1]), float(f[2][0]), float(f[2][1]),
             float(f[3]), float(f[4]), float(f[5]))
            for f in self.state.lc_factors)
        cached = getattr(self, "_odom_cache", None)
        if (cached is not None
                and cached[0] is self.state.odometry_factors
                and cached[1] == lc_key):
            hit = cached[2].get(exclude_long_range)
            if hit is not None:
                return hit
        else:
            cached = None
        cfg = self.config
        lc = self._split_lc()[0] if exclude_long_range else None
        odom = odom_factors_from_state(self.state, self._dtype(),
                                       cfg.translation_weight,
                                       cfg.rotation_weight,
                                       lc_factors=lc)
        hwm = max(getattr(self, "_odom_bucket", 0), odom.i.shape[0])
        self._odom_bucket = hwm
        if odom.i.shape[0] < hwm:
            pad = hwm - odom.i.shape[0]
            odom = OdomFactors(
                i=jnp.pad(odom.i, (0, pad)), j=jnp.pad(odom.j, (0, pad)),
                trans=jnp.pad(odom.trans, ((0, pad), (0, 0))),
                rot=jnp.pad(odom.rot, (0, pad)),
                mask=jnp.pad(odom.mask, (0, pad)),
                wt=jnp.pad(odom.wt, (0, pad)),
                wr=jnp.pad(odom.wr, (0, pad)))
        if cached is None:
            cached = (self.state.odometry_factors, lc_key, {})
            self._odom_cache = cached
        # Both exclude_long_range variants live in the entry: the CG path
        # requests them alternately every window (full graph + band
        # preconditioner subset) and must not thrash.
        cached[2][exclude_long_range] = odom
        return odom

    def _long_range_factors(self):
        """Long-range loop-closure factors as an OdomFactors batch for the
        band solver's Woodbury term (None when there are none).  Padded to
        a power-of-two bucket with masked rows so applying more closures
        rarely recompiles."""
        _, lr = self._split_lc()
        if not lr:
            return None
        cfg = self.config
        dtype = self._dtype()
        i = [int(f[0]) for f in lr]
        j = [int(f[1]) for f in lr]
        trans = np.asarray([f[2] for f in lr], np.float64)
        rot = np.asarray([f[3] for f in lr], np.float64)
        wt = np.asarray([f[4] for f in lr], np.float64)
        wr = np.asarray([f[5] for f in lr], np.float64)
        k = len(lr)
        # High-water-mark bucket (like _odom_bucket): auto-LC prewarms the
        # post-closure re-solve by hinting this to cover all gated pairs
        # BEFORE CSM decides the accepted count, so the prewarmed program
        # is the one the real re-solve uses regardless of how many pairs
        # clear the score threshold (auto_lc._start_resolve_prewarm).
        b = 4
        while b < max(k, int(getattr(self, "_lr_bucket", 0))):
            b *= 2
        self._lr_bucket = b
        pad = b - k
        return OdomFactors(
            i=jnp.asarray(np.pad(i, (0, pad)), jnp.int32),
            j=jnp.asarray(np.pad(j, (0, pad)), jnp.int32),
            trans=jnp.asarray(np.pad(trans, ((0, pad), (0, 0))), dtype),
            rot=jnp.asarray(np.pad(rot, (0, pad)), dtype),
            mask=jnp.asarray(np.arange(b) < k),
            wt=jnp.asarray(np.pad(wt, (0, pad)), dtype),
            wr=jnp.asarray(np.pad(wr, (0, pad)), dtype))

    def _hitl_factors(self) -> HitlFactors:
        if not self.state.hitl_constraints:
            return empty_hitl(self._dtype())
        from nautilus_tpu.solve.hitl import build_hitl_factors
        return build_hitl_factors(self.state, dtype=self._dtype())

    def build_graph(self, x, window,
                    optimization_type: str = "feature",
                    exclude_long_range: bool = False,
                    pairs=None) -> FactorGraph:
        """Factor graph at solution x for one window size.

        pairs: optional (pair_src, pair_tgt) override — a staged sweep
        passes the delta-major PREFIX that covers this window so early
        windows associate/linearize over fewer candidate pairs
        (_staged_sweep_plan).  Ignored by the 'all' branch.

        optimization_type mirrors the reference enum (solver.h:69):
        'feature' — planar matches -> normal residuals, edge matches ->
        point residuals (AddLidarResiduals FEATURE branch,
        solver.cc:297-309); 'all' — full clouds matched by NN -> point
        residuals (the ALL branch, solver.cc:310-317), chunked to bound the
        [pairs, P, P] distance-matrix working set.
        """
        cfg = self.config
        problem = self.state.problem
        outlier = cfg.outlier_threshold
        n = problem.num_nodes
        odom = self._odom_factors(exclude_long_range)
        if optimization_type == "all":
            full = correspond.associate_chunked(
                problem, x[:n], self.pairs, window, outlier, feature="all",
                chunk=64)
            empty = jax.tree.map(lambda a: a[:0], full)
            return FactorGraph(odom=odom, planar=empty, edge=full,
                               hitl=self._hitl_factors())
        ps = self._pair_src if pairs is None else pairs[0]
        pt = self._pair_tgt if pairs is None else pairs[1]
        planar = correspond.associate(
            problem, x[:n], ps, pt,
            window, outlier, feature="planar",
            use_normal_gate=self.use_normal_gate)
        edge = correspond.associate(
            problem, x[:n], ps, pt,
            window, outlier, feature="edge",
            use_normal_gate=self.use_normal_gate)
        return FactorGraph(odom=odom, planar=planar, edge=edge,
                           hitl=self._hitl_factors())

    # -- solving ------------------------------------------------------------

    def solve_slam(self, optimization_type: str = "feature") -> SolveStats:
        """Full growing-window solve; updates state.solution in place.

        The reference's SolveSLAM always optimizes FEATURE (solver.cc:363);
        'all' is exposed for the OptimizationType::ALL path.

        When no visualizer is attached and the dense solver + FEATURE path
        are in play, the whole sweep runs as ONE fused device program
        (association + LM for every window inside a lax.fori_loop) — zero
        host round-trips between windows.
        """
        solver_kind = self._resolve_solver()
        if self.mesh is not None:
            if optimization_type == "feature" and not self.per_iteration_viz:
                return self._solve_slam_sharded(solver_kind)
            import warnings
            warnings.warn("mesh set but the requested mode needs the "
                          "single-device path (ALL-type or per-iteration "
                          "viz); running single-device", stacklevel=2)
        eligible = (self.visualizer is None
                    and optimization_type == "feature"
                    and solver_kind in ("dense", "band")
                    and not self.per_iteration_viz)
        if self.fused_sweep:
            assert eligible, ("fused_sweep=True requires no visualizer, "
                              "feature mode, and the dense/band solver")
        # Auto-fused gates on scale: beyond the cap the host loop
        # compiles one small program and reuses it across windows instead
        # of one whole-sweep program; fused_sweep=True overrides.  The
        # caps (band 6000, dense 1500) bound compile times measured on an
        # earlier accelerator and have not been measured on the H100 yet
        # (ROADMAP.md section 2, large maps).
        fused_cap = 6000 if solver_kind == "band" else 1500
        auto_fused = eligible and self.state.num_nodes <= fused_cap
        if self.fused_sweep or (auto_fused and self.fused_sweep is not False):
            return self._solve_slam_fused(solver_kind)
        return self._solve_slam_host_loop(optimization_type, solver_kind)

    # Below this node count a staged split (one EXTRA program dispatch) is
    # expected to cost more than the compute it saves.  The value was
    # chosen on an earlier accelerator and has not been measured on the
    # H100 yet (ROADMAP.md section 1, core solve layers).
    STAGED_FUSED_MIN_N = 1500

    def _analytic_mode(self):
        """Linearization form for banded assembly: 'moments' (J^T J and
        J^T r from per-point scalar reductions, J never materialized),
        True (closed-form J + einsum), or jacfwd via False.  Auto
        resolves to the moment form wherever the banded layout exists —
        exactness-pinned against the J-form einsums in
        tests/test_solver.py; its speed on the H100 is not measured yet.  Non-band consumers
        (dense fused branch, per-factor linearize) resolve 'moments' to
        the identical closed-form J themselves (factors.py)."""
        if self.assembly == "moments":
            if self._layout is None:
                # Moment-form accumulation is defined on the banded layout;
                # without one, every consumer resolves to the closed-form
                # Jacobian.  Say so instead of degrading silently
                # (ADVICE r3: a CLI user selecting 'moments' on a
                # non-band-eligible problem must not be misled).
                import warnings
                warnings.warn(
                    "assembly='moments' requires the delta-major band "
                    "layout, which this problem lacks (window < 1); "
                    "falling back to closed-form Jacobian assembly",
                    stacklevel=2)
                return True
            return "moments"
        if self.assembly == "jacobian":
            return True
        return "moments" if self._layout is not None else True

    def _staged_sweep_plan(self, w_min: int, w_max: int, use_band: bool):
        """Window-range plan for the fused sweep:
        [(w_lo, w_hi, pair_src, pair_tgt, layout), ...].

        The delta-major pair order (correspond.make_pairs) makes the pair
        set of windows <= w_mid a PREFIX of the full list, so the early
        windows can run in a half-width program instead of computing the
        full w_max-shaped association + linearization and masking most of
        it away.  Assembly cost is ~proportional to the pair count, and
        the factor sets per window are IDENTICAL — the dropped pairs were
        masked — so the staged sweep computes the same solve.

        Staging requires every band-resident factor (odometry + in-band
        LC; long-range factors are width-exempt Woodbury columns) to fit
        |i - j| <= w_mid, and only pays off where the sweep is
        device-bound (N >= STAGED_FUSED_MIN_N).
        """
        full = [(w_min, w_max, self._pair_src, self._pair_tgt,
                 self._layout)]
        w_mid = (w_min + w_max) // 2
        small = self.state.num_nodes < self.STAGED_FUSED_MIN_N
        if (self.staged_fused is False
                or (small and self.staged_fused is not True)
                or not use_band
                or not (w_min <= w_mid < w_max)):
            return full
        oi, oj, _, _ = self.state.odometry_factors
        max_d = (int(np.max(np.abs(np.asarray(oi) - np.asarray(oj))))
                 if len(oi) else 0)
        for f in self._split_lc()[0]:
            max_d = max(max_d, abs(int(f[0]) - int(f[1])))
        if max_d > w_mid:
            return full
        from nautilus_tpu.solve.factors import BandLayout
        lay = BandLayout(self.state.num_nodes,
                         min(w_mid, self.state.num_nodes - 1))
        cnt = lay.offsets()[-1]
        return [(w_min, w_mid, self._pair_src[:cnt], self._pair_tgt[:cnt],
                 lay),
                (w_mid + 1, w_max, self._pair_src, self._pair_tgt,
                 self._layout)]

    def _solve_slam_fused(self, solver_kind: str = "band") -> SolveStats:
        cfg = self.config
        w_min = cfg.get_int("lidar_constraint_amount_min")
        w_max = cfg.get_int("lidar_constraint_amount_max")
        x = self._current_x()
        fixed = self._fixed_mask()
        problem = self.state.problem
        use_band = solver_kind == "band"
        odom = self._odom_factors(exclude_long_range=use_band)
        lr = self._long_range_factors() if use_band else None
        hitl = self._hitl_factors()
        dtype = self._dtype()
        outlier = jnp.asarray(cfg.outlier_threshold, dtype)
        # Closed-form Jacobians everywhere.  (History: on an earlier
        # accelerator the fused graph faulted at N >= 2000 when the
        # normal-residual closed form used an einsum over its size-2
        # contraction dim; the elementwise formulation in
        # factors._linearize_normal_analytic replaced it —
        # tests/test_device_parity.py::test_analytic_fused_at_scale.)
        analytic = self._analytic_mode()
        stats = SolveStats()
        outs = []
        for (a, b, ps, pt, lay) in self._staged_sweep_plan(w_min, w_max,
                                                           use_band):
            t0 = time.perf_counter()
            out = _fused_sweep(
                x, problem, ps, pt, odom, hitl, fixed, outlier, a, b,
                self.lm_params, self.use_normal_gate, lay, use_band,
                analytic, lr)
            x = out[0]          # stays device-resident across stages
            jax.block_until_ready(x)
            outs.append((a, b, out, time.perf_counter() - t0))
        # One batched host fetch per stage's stats (the finite flag is
        # computed on device so the NaN guard does not cost an extra
        # transfer); x transfers once, at writeback.
        for a, b, out, wall in outs:
            _, init_costs, final_costs, iters, finite = jax.device_get(out)
            if not bool(finite):
                raise FloatingPointError(
                    "Non-finite poses after solve; "
                    "check odometry/scan inputs.")
            per = wall / (b - a + 1)
            for k in range(b - a + 1):
                stats.windows.append(WindowStats(
                    window=a + k,
                    initial_cost=float(init_costs[k]),
                    final_cost=float(final_costs[k]),
                    iterations=int(iters[k]), wall_s=per))
        self._writeback(x)
        return stats

    def _solve_slam_sharded(self, solver_kind: str,
                            w_min: int = None,
                            w_max: int = None) -> SolveStats:
        """Multi-chip growing-window sweep over self.mesh
        (parallel.sharded.sharded_sweep: factor-sharded association +
        assembly, one psum per LM step).  Band form with Woodbury
        long-range columns when band-eligible, dense otherwise (the
        'cg' kind has no sharded engine yet and falls back to dense)."""
        from nautilus_tpu.parallel.sharded import sharded_sweep
        cfg = self.config
        if w_min is None:
            w_min = cfg.get_int("lidar_constraint_amount_min")
        if w_max is None:
            w_max = cfg.get_int("lidar_constraint_amount_max")
        use_band = solver_kind == "band"
        x = self._current_x()
        fixed = self._fixed_mask()
        odom = self._odom_factors(exclude_long_range=use_band)
        lr = self._long_range_factors() if use_band else None
        hitl = self._hitl_factors()
        outlier = jnp.asarray(cfg.outlier_threshold, self._dtype())
        t0 = time.perf_counter()
        out = sharded_sweep(
            x, self.state.problem, self._pair_src, self._pair_tgt, odom,
            hitl, fixed, outlier, w_min, w_max, self.mesh, self.lm_params,
            self.use_normal_gate, use_band, lr)
        x_out, init_costs, final_costs, iters = jax.device_get(out)
        wall = time.perf_counter() - t0
        if not np.all(np.isfinite(x_out)):
            raise FloatingPointError(
                "Non-finite poses after sharded solve; "
                "check odometry/scan inputs.")
        stats = SolveStats()
        per = wall / (w_max - w_min + 1)
        for k in range(w_max - w_min + 1):
            stats.windows.append(WindowStats(
                window=w_min + k, initial_cost=float(init_costs[k]),
                final_cost=float(final_costs[k]),
                iterations=int(iters[k]), wall_s=per))
        self._writeback(jnp.asarray(x_out))
        if self.visualizer is not None:
            self.visualizer.draw_solution(self.state, window=w_max)
        return stats

    def solve_max_window(self, optimization_type: str = "feature") -> SolveStats:
        """One solve at the max window size (reference
        ResolveWithConstraints / OptimizeOverMaxWindow, solver.cc:662-674):
        used after loop-closure constraints are injected, where the growing
        sweep's small windows add nothing."""
        cfg = self.config
        w = cfg.get_int("lidar_constraint_amount_max")
        solver_kind = self._resolve_solver()
        if self.mesh is not None and optimization_type == "feature":
            return self._solve_slam_sharded(solver_kind, w_min=w, w_max=w)
        stats = SolveStats()
        x = self._current_x()
        fixed = self._fixed_mask()
        t0 = time.perf_counter()
        graph = self.build_graph(x, w, optimization_type,
                                 exclude_long_range=solver_kind == "band")
        if solver_kind == "cg":
            from nautilus_tpu.solve.cg import lm_solve_cg
            # The band-preconditioner graph differs from `graph` only in
            # the odom factor batch (long-range factors excluded) — reuse
            # the association work instead of a second build_graph.
            bg = (graph._replace(odom=self._odom_factors(True))
                  if self._odom_within_band() else None)
            res = lm_solve_cg(x, graph, fixed, params=self.lm_params,
                              band_graph=bg,
                              layout=self._layout if bg is not None
                              else None)
        elif solver_kind == "band":
            from nautilus_tpu.solve.lm import lm_solve_banded
            res = lm_solve_banded(x, graph, fixed, params=self.lm_params,
                                  layout=self._layout,
                                  analytic=self._analytic_mode(),
                                  lr=self._long_range_factors())
        else:
            res = lm_solve(x, graph, fixed, params=self.lm_params,
                           layout=self._layout)
        res.x.block_until_ready()
        stats.windows.append(WindowStats(
            window=w, initial_cost=float(res.initial_cost),
            final_cost=float(res.cost), iterations=int(res.iterations),
            wall_s=time.perf_counter() - t0))
        self._writeback(res.x)
        if self.visualizer is not None:
            self.visualizer.draw_solution(self.state, window=w)
        return stats

    def _solve_slam_host_loop(self, optimization_type: str,
                              solver_kind: str = None) -> SolveStats:
        cfg = self.config
        stats = SolveStats()
        x = self._current_x()
        fixed = self._fixed_mask()
        solver_kind = solver_kind or self._resolve_solver()
        if self.visualizer is not None:
            self.visualizer.draw_solution(self.state)
        w_min = cfg.get_int("lidar_constraint_amount_min")
        w_max = cfg.get_int("lidar_constraint_amount_max")
        use_band_sweep = (solver_kind == "band"
                          and not self.per_iteration_viz
                          and optimization_type == "feature")
        # Same staged split as the fused path: early windows associate +
        # linearize over the half-width pair PREFIX (one extra compiled
        # shape, reused across those windows).  plan length 1 = unstaged.
        plan = self._staged_sweep_plan(w_min, w_max, use_band_sweep)
        stage_of = {w: (ps, pt, lay)
                    for (a, b, ps, pt, lay) in plan
                    for w in range(a, b + 1)}
        for window in range(w_min, w_max + 1):
            t0 = time.perf_counter()
            use_band = solver_kind == "band" and not self.per_iteration_viz
            ps, pt, lay = stage_of[window]
            graph = self.build_graph(x, window, optimization_type,
                                     exclude_long_range=use_band,
                                     pairs=(ps, pt))
            if solver_kind == "cg":
                from nautilus_tpu.solve.cg import lm_solve_cg
                # Same association, band-subset odom batch (see
                # solve_max_window).
                bg = (graph._replace(odom=self._odom_factors(True))
                      if self._odom_within_band() else None)
                res: LMResult = lm_solve_cg(
                    x, graph, fixed, params=self.lm_params,
                    band_graph=bg,
                    layout=lay if bg is not None else None)
            elif use_band:
                from nautilus_tpu.solve.lm import lm_solve_banded
                res = lm_solve_banded(x, graph, fixed,
                                      params=self.lm_params,
                                      layout=lay,
                                      analytic=self._analytic_mode(),
                                      lr=self._long_range_factors())
            elif self.per_iteration_viz:
                from nautilus_tpu.solve.lm import lm_solve_stepped
                self._viz_window = window
                res = lm_solve_stepped(x, graph, fixed,
                                       params=self.lm_params,
                                       iteration_callback=self._iteration_viz,
                                       layout=self._layout)
            else:
                res = lm_solve(x, graph, fixed, params=self.lm_params,
                               layout=self._layout)
            x = res.x
            x.block_until_ready()
            # NaN guard (replaces the reference's ceres::IsFinite CHECKs,
            # data_structures.h:26-29): a diverged window is a hard error.
            if not bool(jnp.all(jnp.isfinite(x))):
                raise FloatingPointError(
                    f"Non-finite poses after window {window}; "
                    f"check odometry/scan inputs.")
            wall = time.perf_counter() - t0
            stats.windows.append(WindowStats(
                window=window,
                initial_cost=float(res.initial_cost),
                final_cost=float(res.cost),
                iterations=int(res.iterations),
                wall_s=wall))
            if self.visualizer is not None:
                self._writeback(x)
                self.visualizer.draw_solution(self.state, window=window)
                # Reference draws correspondences per pair as it builds the
                # problem (solver.cc:304,309); here once per window.
                self.visualizer.draw_correspondence(graph.planar)
                self.visualizer.draw_correspondence(graph.edge)
        self._writeback(x)
        return stats

    def _writeback(self, x):
        n = self.state.num_nodes
        L = len(self.state.line_poses)
        host = np.asarray(x, np.float64)
        self.state.solution = host[:n]
        if L:
            self.state.line_poses = host[n:n + L]

    def _iteration_viz(self, x, cost, iteration):
        """lm_solve_stepped callback: redraw after one LM step."""
        del cost, iteration
        self._writeback(np.asarray(x))
        self.visualizer.draw_solution(self.state, window=self._viz_window)


@functools.partial(jax.jit,
                   static_argnames=("w_min", "w_max", "lm_params",
                                    "use_normal_gate", "layout", "use_band",
                                    "analytic"))
def _fused_sweep(x, problem, pair_src, pair_tgt, odom, hitl, fixed, outlier,
                 w_min: int, w_max: int, lm_params,
                 use_normal_gate: bool = False, layout=None,
                 use_band: bool = False, analytic: bool = True, lr=None):
    """OptimizeOverGrowingWindow as one device program.

    The window size is a runtime value inside the fori_loop (it only enters
    association as a pair mask), so the loop body compiles once and runs
    w_max - w_min + 1 times entirely on device.  use_band selects the
    block-band linear solver (solve/band.py) over dense Cholesky.
    """
    from nautilus_tpu.solve.factors import (FactorGraph,
                                            assemble_banded_system,
                                            assemble_normal_equations,
                                            total_cost)
    from nautilus_tpu.solve.lm import lm_loop, lm_loop_banded

    n = problem.num_nodes
    n_windows = w_max - w_min + 1

    def window_body(k, carry):
        x, init_costs, final_costs, iters = carry
        w = w_min + k
        planar = correspond.associate(problem, x[:n], pair_src, pair_tgt,
                                      w, outlier, feature="planar",
                                      use_normal_gate=use_normal_gate)
        edge = correspond.associate(problem, x[:n], pair_src, pair_tgt,
                                    w, outlier, feature="edge",
                                    use_normal_gate=use_normal_gate)
        graph = FactorGraph(odom=odom, planar=planar, edge=edge, hitl=hitl)
        if use_band:
            res = lm_loop_banded(
                x,
                assemble_fn=lambda xx: assemble_banded_system(xx, graph,
                                                              layout,
                                                              analytic, lr),
                fixed_dof=fixed, params=lm_params)
        else:
            # analytic threads into the dense branch too, so both
            # assemblies use the same linearization form.
            res = lm_loop(
                x,
                assemble_fn=lambda xx: assemble_normal_equations(
                    xx, graph, layout, analytic),
                cost_fn=lambda xx: total_cost(xx, graph),
                fixed_dof=fixed, params=lm_params)
        return (res.x,
                init_costs.at[k].set(res.initial_cost),
                final_costs.at[k].set(res.cost),
                iters.at[k].set(res.iterations))

    init = (x, jnp.zeros(n_windows, x.dtype), jnp.zeros(n_windows, x.dtype),
            jnp.zeros(n_windows, jnp.int32))
    x, ic, fc, it = jax.lax.fori_loop(0, n_windows, window_body, init)
    return x, ic, fc, it, jnp.all(jnp.isfinite(x))
