"""Flat-array problem schema — the device-side replacement for slam_types.

The reference keeps per-node C++ objects with per-scan KD-trees and point
vectors (reference src/util/slam_types.h:41-190).  Here the whole pose graph
is a pytree of fixed-shape padded arrays so that one jitted program serves
every node, window size, and dataset:

- ``SLAMProblem``: immutable observation data (clouds, normals, feature
  indices, odometry factors, initial poses).
- ``SLAMState``: problem + mutable solution poses (reference
  src/util/slam_types.h:180-190) plus HITL constraint state.

Feature points are stored as *indices into the full cloud* rather than
coordinate copies; this preserves the reference's invariant that normals are
always looked up from the full-cloud tree at the exact feature point
(reference src/optimization/solver.cc:150-155, 67-77) while turning the
lookup into a gather.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class SLAMProblem(NamedTuple):
    """Device-resident observation data for an N-node pose graph.

    Shapes:  N nodes, P padded points per cloud, PL planar cap, ED edge cap,
    F odometry factors.  All padding is indicated by the *_mask arrays;
    index arrays use 0 for padded slots (always masked).
    """

    points: jnp.ndarray        # [N, P, 2] cloud in each node's sensor frame
    points_mask: jnp.ndarray   # [N, P] bool
    normals: jnp.ndarray       # [N, P, 2] unit normal per cloud point
    planar_idx: jnp.ndarray    # [N, PL] int32 indices into points
    planar_mask: jnp.ndarray   # [N, PL] bool
    edge_idx: jnp.ndarray      # [N, ED] int32
    edge_mask: jnp.ndarray     # [N, ED] bool
    initial_poses: jnp.ndarray  # [N, 3]
    odom_i: jnp.ndarray        # [F] int32 first pose id per odometry factor
    odom_j: jnp.ndarray        # [F] int32 second pose id
    odom_trans: jnp.ndarray    # [F, 2] world-frame translation i -> j
    odom_rot: jnp.ndarray      # [F] rotation i -> j

    @property
    def num_nodes(self) -> int:
        return self.points.shape[0]

    @property
    def planar_points(self) -> jnp.ndarray:
        """[N, PL, 2] gathered planar feature points."""
        return jnp.take_along_axis(self.points, self.planar_idx[..., None], axis=1)

    @property
    def planar_normals(self) -> jnp.ndarray:
        return jnp.take_along_axis(self.normals, self.planar_idx[..., None], axis=1)

    @property
    def edge_points(self) -> jnp.ndarray:
        return jnp.take_along_axis(self.points, self.edge_idx[..., None], axis=1)

    @property
    def edge_normals(self) -> jnp.ndarray:
        return jnp.take_along_axis(self.normals, self.edge_idx[..., None], axis=1)


@dataclasses.dataclass
class SLAMState:
    """Problem + mutable solution, the unit shared by solver/HITL/LC/viz.

    Mirrors reference SLAMState2D (src/util/slam_types.h:180-190): the
    solution starts at the odometry-derived initial poses and is updated in
    place by each solve.  ``timestamps`` stay host-side for pose-file IO
    (reference src/optimization/solver.cc:565-579).
    """

    problem: SLAMProblem
    solution: np.ndarray              # [N, 3] float64 host copy (authoritative)
    timestamps: np.ndarray            # [N] float64
    hitl_constraints: list = dataclasses.field(default_factory=list)
    # Line poses for HITL constraints (one SE(2) free pose per constraint,
    # reference src/optimization/data_structures.h:46).
    line_poses: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3), dtype=np.float64))
    # Active odometry factors (i, j, trans, rot) — replaced by solved-odometry
    # factors during HITL (reference solver.cc:535, 406-427).
    odometry_factors: tuple = ()
    # The ingest-time factors, kept for the reference's restore step
    # (solver.cc:554; note §2d: the reference restores an *empty* list).
    initial_odometry_factors: tuple = ()
    # Accepted auto-loop-closure factors: (i, j, trans, rot, wt, wr) tuples
    # solved together with odometry (the reference's AddLCConstraints stub
    # completed, solver.cc:651-660).
    lc_factors: list = dataclasses.field(default_factory=list)

    @classmethod
    def from_problem(cls, problem: SLAMProblem,
                     timestamps: Optional[np.ndarray] = None) -> "SLAMState":
        init = np.asarray(problem.initial_poses, dtype=np.float64)
        if timestamps is None:
            timestamps = np.zeros(init.shape[0], dtype=np.float64)
        factors = (np.asarray(problem.odom_i), np.asarray(problem.odom_j),
                   np.asarray(problem.odom_trans, np.float64),
                   np.asarray(problem.odom_rot, np.float64))
        return cls(problem=problem, solution=init.copy(),
                   timestamps=np.asarray(timestamps, dtype=np.float64),
                   odometry_factors=factors,
                   initial_odometry_factors=factors)

    @property
    def num_nodes(self) -> int:
        return self.solution.shape[0]


class RawNodes(NamedTuple):
    """Host-side ingest output: one padded cloud per captured node."""

    points: np.ndarray       # [N, P, 2] float32
    points_mask: np.ndarray  # [N, P] bool
    initial_poses: np.ndarray  # [N, 3] float64
    timestamps: np.ndarray   # [N] float64
    odom_i: np.ndarray       # [F] int64
    odom_j: np.ndarray       # [F] int64
    odom_trans: np.ndarray   # [F, 2] float64
    odom_rot: np.ndarray     # [F] float64


def pad_clouds(clouds, pad_multiple: int = 128):
    """Stack variable-length clouds [ni, 2] into [N, P, 2] + mask.

    P is the max cloud size rounded up to ``pad_multiple`` so a handful of
    padded shapes serve every problem.  The default of 128 was chosen for
    an earlier accelerator's tiling and has not been measured on the H100
    yet (ROADMAP.md section 1, core solve layers).
    """
    n = len(clouds)
    max_pts = max((c.shape[0] for c in clouds), default=0)
    p = max(round_up(max(max_pts, 1), pad_multiple), pad_multiple)
    points = np.zeros((n, p, 2), dtype=np.float32)
    mask = np.zeros((n, p), dtype=bool)
    for i, c in enumerate(clouds):
        k = c.shape[0]
        points[i, :k] = c
        mask[i, :k] = True
    return points, mask


def resolve_solver_dtype(name) -> jnp.dtype:
    """Map the ``solver_dtype`` config key to a device dtype.

    float32 (default) is the device engine precision, verified against
    the f64 CPU twin at <=1% final-cost parity with precision=HIGHEST
    matmuls.  float64 is the escape hatch matching Ceres' native doubles
    (SURVEY.md §7 hard part (b)): slower on the device but exact, so a
    dataset that ever broke f32 parity can still be solved on device.
    Requesting float64 enables jax's x64 mode process-wide (must happen
    before the arrays are created; jax.config.update handles it live).
    """
    name = str(name).lower()
    if name in ("float32", "f32"):
        return jnp.float32
    if name in ("float64", "f64", "double"):
        import jax
        jax.config.update("jax_enable_x64", True)
        return jnp.float64
    raise ValueError(f"solver_dtype must be float32 or float64, got {name!r}")


def build_problem(raw: RawNodes, normals: np.ndarray,
                  planar_idx: np.ndarray, planar_mask: np.ndarray,
                  edge_idx: np.ndarray, edge_mask: np.ndarray,
                  dtype=jnp.float32) -> SLAMProblem:
    """Assemble the device problem from ingest + preprocessing outputs."""
    return SLAMProblem(
        points=jnp.asarray(raw.points, dtype=dtype),
        points_mask=jnp.asarray(raw.points_mask),
        normals=jnp.asarray(normals, dtype=dtype),
        planar_idx=jnp.asarray(planar_idx, dtype=jnp.int32),
        planar_mask=jnp.asarray(planar_mask),
        edge_idx=jnp.asarray(edge_idx, dtype=jnp.int32),
        edge_mask=jnp.asarray(edge_mask),
        initial_poses=jnp.asarray(raw.initial_poses, dtype=dtype),
        odom_i=jnp.asarray(raw.odom_i, dtype=jnp.int32),
        odom_j=jnp.asarray(raw.odom_j, dtype=jnp.int32),
        odom_trans=jnp.asarray(raw.odom_trans, dtype=dtype),
        odom_rot=jnp.asarray(raw.odom_rot, dtype=dtype),
    )
