"""Loop-closure pair gating by solution uncertainty (chi-square score).

Mirrors reference LCMatcher (src/loop_closure/lc_matcher.cc):

- GetCovarianceMatrix (lc_matcher.cc:28-46): the covariance between two
  pose blocks under a temporary re-gauge — pose 0 freed, pose
  min(source, target) - 1 fixed — extracting the top-left 2x2 of the 3x3
  cross block.  Ceres' Covariance::Compute becomes a solve against the
  gauged Gauss-Newton Hessian: the (s, t) cross-covariance is rows s of
  H^-1 columns t, i.e. three linear solves.
- ChiSquareScore (lc_matcher.cc:50-57): Mahalanobis distance
  (t - s)^T Sigma^-1 (t - s) of the current translations.
- GetPossibleMatches (lc_matcher.cc:59-74): accept score < 5000.0 (the
  reference's hardcoded threshold).

Covariance engine: when the factor graph is band-eligible (all two-node
factors within |i - j| <= layout.w; applied long-range loop closures as a
Woodbury low-rank term) the columns of H^-1 come from the block-band
Cholesky (solve/band.py) — O(N w) memory, so gating runs at pose counts
where a dense [3N, 3N] H cannot even be materialized (~14 GB at
N=20000).  The dense path remains as fallback and parity oracle.

All candidate pairs share one assembled system and one factorization per
gauge pose; solves for all requested basis columns are batched.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from nautilus_tpu.solve.factors import (FactorGraph,
                                        assemble_banded_system,
                                        assemble_normal_equations)

CHI_SQUARE_THRESHOLD = 5000.0  # reference lc_matcher.cc:69


def _gauged_cholesky(H, fixed_pose: int):
    n_dof = H.shape[0]
    fixed = (jnp.arange(n_dof) // 3) == fixed_pose
    free = ~fixed
    Hg = jnp.where(free[:, None] & free[None, :], H, 0.0)
    Hg = Hg + jnp.diag(fixed.astype(H.dtype))
    # Tiny Tikhonov term guards rank deficiency of unsolved/disconnected
    # graphs; negligible against typical H scales.
    Hg = Hg + 1e-8 * jnp.eye(n_dof, dtype=H.dtype)
    return jsl.cho_factor(Hg)


@jax.jit
def _cross_cov_blocks(H, fixed_pose, sources, targets):
    """[(2x2)] cross-covariance blocks for pairs (sources[k], targets[k]).

    One factorization; one batched solve for all distinct target columns.
    """
    c = _gauged_cholesky(H, fixed_pose)
    n_dof = H.shape[0]
    cols = (3 * targets[:, None] + jnp.arange(3)[None, :]).reshape(-1)
    rhs = jnp.zeros((n_dof, cols.shape[0]), H.dtype).at[
        cols, jnp.arange(cols.shape[0])].set(1.0)
    X = jsl.cho_solve(c, rhs)                       # [n_dof, 3K]
    return _extract_blocks(X, sources)


def _extract_blocks(X, sources):
    """Top-left 2x2 of each pair's 3x3 cross block from solved columns."""
    X = X.reshape(X.shape[0], -1, 3)                # [n_dof, K, 3]

    def block(k):
        rows = 3 * sources[k] + jnp.arange(3)
        return X[rows, k, :]                        # [3, 3]

    blocks = jax.vmap(block)(jnp.arange(sources.shape[0]))
    return blocks[:, :2, :2]                        # top-left 2x2


@jax.jit
def _cross_cov_blocks_band(sys, fixed_pose, sources, targets):
    """Band-form twin of _cross_cov_blocks: H^-1 columns via the block-band
    Cholesky (+ HITL border / Woodbury low-rank handled inside
    band_inverse_node_columns)."""
    from nautilus_tpu.solve.band import band_inverse_node_columns

    n = sys.n
    L = sys.num_lines
    fixed = jnp.repeat((jnp.arange(n + L) == fixed_pose), 3)
    cols = (3 * targets[:, None] + jnp.arange(3)[None, :]).reshape(-1)
    X = band_inverse_node_columns(sys, fixed, cols)   # [3n, 3K]
    return _extract_blocks(X, sources)


class LCMatcher:
    """Uncertainty gate over candidate pairs, sharing one Hessian.

    layout/lr: optional factors.BandLayout + long-range LC OdomFactors —
    when given, ``graph`` must exclude long-range factors from its odom
    batch (Solver.build_graph(..., exclude_long_range=True)) and the
    covariance solves run on the O(N w) band representation instead of a
    dense [3N, 3N] H.  Use LCMatcher.from_solver to pick automatically.
    """

    def __init__(self, state, graph: FactorGraph, layout=None, lr=None):
        self.state = state
        x = jnp.asarray(
            np.concatenate([state.solution, state.line_poses], axis=0),
            state.problem.points.dtype)
        if layout is not None:
            self._sys, _ = assemble_banded_system(x, graph, layout,
                                                  True, lr)
            self.H = None
        else:
            self.H, _, _ = assemble_normal_equations(x, graph)
            self._sys = None
        self._pair_cache = {}

    @classmethod
    def from_solver(cls, solver, window: int = None) -> "LCMatcher":
        """Build from a Solver, choosing the band covariance engine when
        the solver's factor set is band-eligible."""
        x = solver._current_x()
        w = window if window is not None else \
            solver.config.get_int("lidar_constraint_amount_max")
        use_band = solver._band_eligible()
        graph = solver.build_graph(x, w, exclude_long_range=use_band)
        if use_band:
            return cls(solver.state, graph, layout=solver._layout,
                       lr=solver._long_range_factors())
        return cls(solver.state, graph)

    def chi_square_score(self, source: int, target: int) -> Tuple[np.ndarray, float]:
        cov, score = self._scores([(source, target)])[0]
        return cov, score

    def _scores(self, pairs: List[Tuple[int, int]]):
        if not pairs:
            return []
        # Group by the re-gauge pose (min(s,t) - 1, reference lc_matcher.cc:38)
        # so each group shares one factorization; pairs already scored (e.g.
        # during gating) come from the cache.
        groups: Dict[int, List[Tuple[int, int]]] = {}
        for s, t in pairs:
            if (s, t) in self._pair_cache:
                continue
            groups.setdefault(max(min(s, t) - 1, 0), []).append((s, t))
        results = self._pair_cache
        for fixed_pose, group in groups.items():
            # Pow2-bucketed pair count (repeat-pad with the first pair;
            # every pair's cross-covariance is independent, so padding
            # rows are simply dropped below).  Unbucketed, each distinct
            # group size would be a fresh XLA compile.
            b = 4
            while b < len(group):
                b *= 2
            padded = group + [group[0]] * (b - len(group))
            ss = jnp.asarray([g[0] for g in padded], jnp.int32)
            tt = jnp.asarray([g[1] for g in padded], jnp.int32)
            if self._sys is not None:
                blocks = _cross_cov_blocks_band(self._sys, fixed_pose,
                                                ss, tt)
            else:
                blocks = _cross_cov_blocks(self.H, fixed_pose, ss, tt)
            blocks = np.asarray(blocks, np.float64)
            for k, (s, t) in enumerate(group):
                cov = blocks[k]
                delta = self.state.solution[t, :2] - self.state.solution[s, :2]
                try:
                    score = float(delta @ np.linalg.inv(cov) @ delta)
                except np.linalg.LinAlgError:
                    score = float("inf")
                results[(s, t)] = (cov, score)
        return [results[(s, t)] for s, t in pairs]

    def get_possible_matches(self, source: int, candidates: List[int],
                             threshold: float = CHI_SQUARE_THRESHOLD) -> List[int]:
        pairs = [(source, t) for t in candidates if t != source]
        scored = self._scores(pairs)
        return [t for (s, t), (_, score) in zip(pairs, scored)
                if score < threshold]
